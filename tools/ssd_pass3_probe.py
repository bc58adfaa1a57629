#!/usr/bin/env python3
"""Where the SSD forward's chunk scan (pass 3) spends its time on a CUDA
card: the pass as built, and copies of ``csrc/ssd.cu`` with one part taken
out.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/ssd_pass3_probe.py [--reps 20] [--seed 0]

Five libraries are built from the checkout's ``csrc/ssd.cu`` with the
flags of ``kernels/_build.py`` into ``build/ssd_pass3_probe/``, all at
once:

* ``as_built``: the source unchanged;
* ``no_products``: the state term, C B^T and G X return at once, so the
  pass only stages its operands and passes its barriers;
* ``no_copies``: the step buffers are never filled, so the products run on
  whatever shared memory holds;
* ``no_gx`` and ``no_state``: G X, or the state term C h_in^T, alone taken
  out.

Only ``as_built`` computes the scan; the others exist to be timed.  At
mamba2-2.7b's (1, 4096, 80, 64, 1, 128) with the reference test's operands
and at chunks 64 and 256, ``as_built`` is first held to the wrapper's own
``ssd`` output bits, then every library's pass 3 is timed as the median of
``--reps`` calls between CUDA events, at the head count the wrapper picks.
The last line is one JSON object: the card's name and power limit as
``nvidia-smi`` prints them and the medians in ms.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_pass3_probe"

PROBLEM = (1, 4096, 80, 64, 1, 128)
CHUNKS = (64, 256)


def without(src: str, marker: str) -> str:
    """``src`` with ``return;`` first in the body that follows ``marker``
    (a function's signature or a lambda's head)."""
    start = src.index(marker)
    brace = src.index("{", start)
    return src[:brace + 1] + "\n    return;\n" + src[brace + 1:]


def sources(src: str) -> dict:
    products = ("void state_term(", "void form_cb(", "void slab_term(")
    no_products = src
    for marker in products:
        no_products = without(no_products, marker)
    return {"as_built": src, "no_products": no_products,
            "no_copies": without(src, "auto stage = [&](int n, float* st)"),
            "no_gx": without(src, "void slab_term("),
            "no_state": without(src, "void state_term(")}


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
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"ssd_pass3_probe: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms over ``reps`` calls, each call
    between CUDA events, after one call to warm up."""
    import torch
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_pass3_probe: no CUDA device")
    from repro_torch.kernels.ssd import (_launch_chunk_state,
                                         _launch_state_pass, ssd,
                                         ssd_scan_heads, ssd_scratch)
    libs = build(sources((CSRC / "ssd.cu").read_text()))
    b, l, h, p, g, n = PROBLEM
    rng = np.random.default_rng(args.seed)
    x, dt, a_log, bb, cc = (torch.from_numpy(a.astype(np.float32)).cuda()
                            for a in (rng.standard_normal((b, l, h, p)),
                                      np.abs(rng.standard_normal((b, l, h)))
                                      * 0.1,
                                      rng.standard_normal((h,)) * 0.5,
                                      rng.standard_normal((b, l, g, n)),
                                      rng.standard_normal((b, l, g, n))))
    heads = ssd_scan_heads(h, g)
    out = {}
    for chunk in CHUNKS:
        want = ssd(x, dt, a_log, bb, cc, chunk=chunk)
        s, states = ssd_scratch(x, bb, chunk)
        _launch_chunk_state(x, dt, a_log, bb, s, states, chunk)
        _launch_state_pass(s, states, chunk)
        times = {}
        for name, lib in libs.items():
            fn = lib.repro_ssd_chunk_scan
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            y = torch.empty_like(x)

            def run():
                err = fn(*(t.data_ptr() for t in (x, dt, bb, cc, s, states,
                                                  y)),
                         b, l, h, g, p, n, chunk, heads,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"ssd_pass3_probe: {name} launch failed: {err}")
            run()
            torch.cuda.synchronize()
            if name == "as_built" and not torch.equal(y, want):
                sys.exit("ssd_pass3_probe: the built pass 3 is not the "
                         "wrapper's bits")
            times[name] = median_ms(run, args.reps)
        out[chunk] = times
        print(f"chunk {chunk}, {heads} heads a block: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in times.items()), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "problem": list(PROBLEM),
                      "pass3_ms": out}))


if __name__ == "__main__":
    main()
