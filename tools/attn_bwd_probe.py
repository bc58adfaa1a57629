#!/usr/bin/env python3
"""Where the attention backward's wgmma route spends its time on a CUDA
card: the kernels as built, and copies of ``csrc/flash_attention_bwd.cu``
with one part taken out.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/attn_bwd_probe.py [--reps 10] [--seed 0]

Libraries built from the checkout's ``csrc/flash_attention_bwd.cu`` with
the flags of ``kernels/_build.py`` into ``build/attn_bwd_probe/``, all at
once:

* ``as_built``: the source unchanged;
* ``no_pair_math``: ``pair_p`` returns at once, so no scale, softcap,
  mask or exp runs (p and dS are whatever the registers hold);
* ``no_ss``: ``product_ss`` returns at once: no S, S^T, dP or dP^T
  products;
* ``no_rs``: ``product_rs`` returns at once: no dV, dK or dQ products;
* ``no_products``: neither;
* ``rings_3_4``: rings of three stages in the dK/dV kernel and four in
  the dQ kernel (two each as built);
* ``exp2``: p as ``exp2f`` of the logit less lse scaled by log2(e), in
  place of ``expf`` (what the accurate exponential costs).

Only ``as_built`` computes the gradient; the others exist to be timed.  At
the (1, 32, 4096, 4096, 128) causal problem in bfloat16, and at gemma2-27b's
global layer (32 query heads over 16 kv heads, softcap 50), ``as_built`` is
first held to the wrapper's own ``flash_attention_bwd`` bits, then each
library's delta, dK/dV and dQ kernels are timed in one ``torch.profiler``
window of ``--reps`` calls (the mean a call).  The last line is one JSON
object: the card's name and power limit as ``nvidia-smi`` prints them and
the means in ms.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "attn_bwd_probe"

S, D, BLK = 4096, 128, 128
CASES = {"problem": dict(hq=32, hkv=32, softcap=0.0),
         "gemma2_global": dict(hq=32, hkv=16, softcap=50.0)}


def without(src: str, marker: str) -> str:
    """``src`` with ``return;`` first in the body that follows ``marker``
    (a function's signature)."""
    start = src.index(marker)
    brace = src.index("{", start)
    return src[:brace + 1] + "\n  return;\n" + src[brace + 1:]


def sources(src: str) -> dict:
    ss, rs = "void product_ss(", "void product_rs("
    rings = src
    for struct, stages in (("struct BwdKv {", 3), ("struct BwdQ {", 4)):
        at = rings.index("static constexpr int NS = 2;", rings.index(struct))
        rings = rings[:at] + f"static constexpr int NS = {stages};" + \
            rings[at + len("static constexpr int NS = 2;"):]
    exp = "  p = keep ? expf(x - lse) : 0.0f;\n  pfac ="
    assert src.count(exp) == 1
    return {"as_built": src,
            "no_pair_math": without(src, "void pair_p("),
            "no_ss": without(src, ss), "no_rs": without(src, rs),
            "no_products": without(without(src, ss), rs),
            "rings_3_4": rings,
            "exp2": src.replace(exp, "  p = keep ? exp2f((x - lse) * "
                                "1.4426950408889634f) : 0.0f;\n  pfac =")}


def build(srcs: dict) -> dict:
    """Each source compiled into a shared library, all nvcc at once."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        so = OUT / f"{name}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(str(so))
        fn = lib.repro_flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 +
                       [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("attn_bwd_probe: no CUDA device")
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
    libs = build(sources((CSRC / "flash_attention_bwd.cu").read_text()))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    res = {}
    for case, c in CASES.items():
        q, k, v, do = (torch.randn(1, h, S, D, generator=gen, device="cuda",
                                   dtype=torch.bfloat16)
                       for h in (c["hq"], c["hkv"], c["hkv"], c["hq"]))
        kw = dict(causal=True, window=0, softcap=c["softcap"])
        o, lse = flash_attention_fwd(q, k, v, **kw)
        want = flash_attention_bwd(q, k, v, o, lse, do, blk=BLK, **kw)
        delta = torch.empty_like(lse)
        outs = [torch.empty_like(t) for t in (q, k, v)]
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, delta,
                                              *outs)),
                     1, c["hq"], c["hkv"], S, D, BLK, 1.0 / D ** 0.5, 1, 0,
                     c["softcap"], 1, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        call(libs["as_built"])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs, want)):
            raise AssertionError(f"{case}: as_built differs from the "
                                 f"wrapper's bits")
        res[case] = {}
        for name, fn in libs.items():
            call(fn)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    call(fn)
                torch.cuda.synchronize()
            means = {}
            for ev in prof.key_averages():
                m = re.search(r"attn_bwd_(\w+?)_kernel", ev.key)
                if m and ev.count:
                    means[m.group(1)] = ev.device_time_total / args.reps / 1e3
            res[case][name] = means
            print(f"{case} {name}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in means.items()), flush=True)
        del q, k, v, do, o, lse, delta, outs, want
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "ms": res}))


if __name__ == "__main__":
    main()
