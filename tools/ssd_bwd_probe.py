#!/usr/bin/env python3
"""Where the SSD backward's wgmma route spends its time on a CUDA card:
the kernels as built, and copies of ``csrc/ssd_bwd.cu`` with one part
taken out.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/ssd_bwd_probe.py [--reps 10] [--seed 0]

Libraries built from the checkout's ``csrc/ssd_bwd.cu`` with the flags of
``kernels/_build.py`` into ``build/ssd_bwd_probe/``, all at once:

* ``as_built``: the source unchanged;
* ``no_copies``: the producer hands over each ring stage and own buffer
  without copying into it (the consumers compute on whatever shared
  memory holds);
* ``no_ss``: ``ss_unit`` and ``ss_unit2`` return at once: no pair tiles,
  state products or C B^T;
* ``no_rs``: ``rs_unit`` returns at once: no M B_k, G^T dY_k, M^T C_k or
  D_c products;
* ``no_products``: neither;
* ``bare``: no copies and no products: what is left is the pair math, the
  fragments, the row sums and the synchronisation.

Only ``as_built`` computes the gradient; the others exist to be timed.  At
mamba2-2.7b's (1, 4096, 80, 64, 1, 128) and jamba-v0.1-52b's (1, 4096,
128, 64, 1, 16) widths, chunk 256, ``as_built`` is first held to the
wrapper's own bits, then each library's kernels are timed in one
``torch.profiler`` window of ``--reps`` calls of ``ssd_bwd`` (each
kernel's total over the calls).  The last line is one JSON object: the
card's name and power limit as ``nvidia-smi`` prints them and the times in
ms.
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
OUT = ROOT / "build" / "ssd_bwd_probe"
CHUNK = 256
CASES = {"mamba2-2.7b": (1, 4096, 80, 64, 1, 128),
         "jamba-v0.1-52b": (1, 4096, 128, 64, 1, 16)}


def without(src: str, marker: str) -> str:
    """``src`` with ``return;`` first in the body that follows ``marker``
    (a function's signature)."""
    start = src.index(marker)
    brace = src.index("{", start)
    return src[:brace + 1] + "\n  return;\n" + src[brace + 1:]


def no_copies(src: str) -> str:
    """The producer's stages and own buffers handed over uncopied."""
    put = """    mbar_expect_tx(full + st, bytes + (v0 ? 256u : 0u) + (v1 ? 256u : 0u));
    bulk_load(base + st * kUnitBytes, src, bytes, full + st);
    if (v0) bulk_load(vec + 128 * st, v0, 256, full + st);
    if (v1) bulk_load(vec + 128 * st + 64, v1, 256, full + st);
"""
    own = """  mbar_expect_tx(bar, bytes);
  bulk_load(dst, src, bytes, bar);
"""
    assert src.count(put) == 1 and src.count(own) == 1
    return src.replace(put, "    mbar_arrive(full + st);\n").replace(
        own, "  mbar_arrive(bar);\n")


def sources(src: str) -> dict:
    ss = lambda t: without(without(t, "void ss_unit("),  # noqa: E731
                           "void ss_unit2(")
    rs = lambda t: without(t, "void rs_unit(")  # noqa: E731
    return {"as_built": src, "no_copies": no_copies(src), "no_ss": ss(src),
            "no_rs": rs(src), "no_products": rs(ss(src)),
            "bare": rs(ss(no_copies(src)))}


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
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_probe: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import _kernel_parts, ssd_bwd
    _build.build_all(["ssd"])
    libs = build(sources((CSRC / "ssd_bwd.cu").read_text()))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    res = {}
    for case, (b, l, h, p, g, n) in CASES.items():
        def randn(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device="cuda") * scale
        x, dy = randn(b, l, h, p), randn(b, l, h, p)
        dt = torch.rand(b, l, h, generator=gen, device="cuda") * 0.1 + 1e-3
        a_log = randn(h, scale=0.5)
        bb, cc = randn(b, l, g, n, scale=n ** -0.5), \
            randn(b, l, g, n, scale=n ** -0.5)
        _, _, s, h_in = _kernel_parts(x, dt, a_log, bb, cc, CHUNK, None,
                                      want_state=False)
        call = (x, dt, a_log, bb, cc, s, h_in, dy, None)
        want = ssd_bwd(*call, chunk=CHUNK)
        res[case] = {}
        for name, lib in libs.items():
            # the wrapper launches through the loaded library: this one
            _build._LOADED["ssd_bwd"] = lib
            got = ssd_bwd(*call, chunk=CHUNK)
            torch.cuda.synchronize()
            if name == "as_built" and not all(
                    torch.equal(a, w) for a, w in zip(got, want)):
                raise AssertionError(f"{case}: as_built differs from the "
                                     f"wrapper's bits")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    ssd_bwd(*call, chunk=CHUNK)
                torch.cuda.synchronize()
            ms = {}
            for ev in prof.key_averages():
                m = re.search(r"ssd_bwd_(\w+?)_kernel", ev.key)
                if m and ev.count:
                    ms[m.group(1)] = ms.get(m.group(1), 0.0) + \
                        ev.device_time_total / args.reps / 1e3
            res[case][name] = ms
            print(f"{case} {name}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
        _build._LOADED.pop("ssd_bwd", None)
        del x, dy, dt, bb, cc, s, h_in, want
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    print(json.dumps({"card": card, "chunk": CHUNK, "ms": res}))


if __name__ == "__main__":
    main()
