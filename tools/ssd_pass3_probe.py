#!/usr/bin/env python3
"""Where the SSD forward's wgmma route spends its time on a CUDA card: its
chunk state (pass 1) and chunk scan (pass 3, with its C B^T pre-pass) as
built, and copies of ``csrc/ssd.cu`` with one part taken out.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/ssd_pass3_probe.py [--reps 20] [--seed 0]

Libraries are built from the checkout's ``csrc/ssd.cu`` with the flags
of ``kernels/_build.py`` into ``build/ssd_pass3_probe/``, all at once:

* ``as_built``: the source unchanged;
* ``no_products``: every wgmma chain (``ss_chain``, ``rs_chain``) returns
  at once, so the passes only copy, split and pass their barriers;
* ``no_copies``: no TMA or bulk copy is issued; each ring stage's barrier
  is arrived on at once, so the passes run on whatever shared memory
  holds;
* ``no_split``: the splits into K-major hi / lo tiles (``split_rows``,
  ``split_xt``, ``split_bt``) return at once;
* ``no_gmath``: G X takes C B^T as its A operand (``g_off`` and
  ``g_diag`` return it), without the decay, dt and the diagonal's mask.

Only ``as_built`` computes the scan; the others exist to be timed.  The
compiler's notes on the wgmma kernels (registers, spills, and any line
that names wgmma, such as a serialisation warning) are printed first.  At
mamba2-2.7b's (1, 4096, 80, 64, 1, 128) and jamba-v0.1-52b's (1, 4096,
128, 64, 1, 16), with the reference test's operands, at chunks 64 and
256, ``as_built`` is held to the wrapper's own ``ssd`` output bits, then
every library's pass 1 and pass 3 are timed as the median of ``--reps``
calls between CUDA events, at the head counts the wrapper picks.  The
last line is one JSON object: the card's name and power limit as
``nvidia-smi`` prints them and the medians in ms.
"""
import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ssd_pass3_probe"

PROBLEMS = {"mamba2-2.7b": (1, 4096, 80, 64, 1, 128),
            "jamba-v0.1-52b": (1, 4096, 128, 64, 1, 16)}
CHUNKS = (64, 256)


def with_body(src: str, marker: str, stmt: str = "return;") -> str:
    """``src`` with ``stmt`` first in the body of the function whose
    signature holds ``marker``."""
    start = src.index(marker)
    brace = src.index("{", start)
    return src[:brace + 1] + f"\n  {stmt}\n" + src[brace + 1:]


def sources(src: str) -> dict:
    no_products = src
    for marker in ("void ss_chain(", "void rs_chain("):
        no_products = with_body(no_products, marker)
    no_copies = with_body(src, "void arm(", "mbar_arrive(full + st); return;")
    for marker in ("void copy_3d(", "void copy_1d("):
        no_copies = with_body(no_copies, marker)
    no_split = src
    for marker in ("void split_rows(", "void split_xt(", "void split_bt("):
        no_split = with_body(no_split, marker)
    return {"as_built": src, "no_products": no_products,
            "no_copies": no_copies, "no_split": no_split,
            "no_gmath": with_body(with_body(src, "float g_off(", "return cbv;"),
                                  "float g_diag(", "return cbv;")}


def build(srcs: dict) -> dict:
    """Each source compiled into a shared library, all nvcc at once; the
    compiler's log of each beside it."""
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
        (OUT / f"{name}.log").write_text(log)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def wgmma_notes(log: str) -> list:
    """The compiler's lines on the wgmma kernels: registers and spills,
    and every line that names wgmma."""
    notes, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "wgmma" in m.group(1) else None
            continue
        if "wgmma" in line.lower() and "Compiling" not in line:
            notes.append(line.strip())
        elif name and re.search(r"Used \d+ registers|spill", line):
            kern = re.search(r"\d+(ssd_[a-z_]+_kernel)(?:I(.*?)EE)?", name)
            notes.append(f"{kern.group(1)}<{kern.group(2)}>: {line.strip()}"
                         if kern else line.strip())
    return notes


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
                                         ssd_cb_floats, ssd_scan_heads,
                                         ssd_scratch, ssd_state_heads)
    libs = build(sources((CSRC / "ssd.cu").read_text()))
    for line in wgmma_notes((OUT / "as_built.log").read_text()):
        print(f"ptxas: {line}", flush=True)
    out = {}
    for label, (b, l, h, p, g, n) in PROBLEMS.items():
        rng = np.random.default_rng(args.seed)
        x, dt, a_log, bb, cc = (
            torch.from_numpy(a.astype(np.float32)).cuda()
            for a in (rng.standard_normal((b, l, h, p)),
                      np.abs(rng.standard_normal((b, l, h))) * 0.1,
                      rng.standard_normal((h,)) * 0.5,
                      rng.standard_normal((b, l, g, n)),
                      rng.standard_normal((b, l, g, n))))
        scan_heads, state_heads = ssd_scan_heads(h, g), ssd_state_heads(h, g)
        for chunk in CHUNKS:
            want = ssd(x, dt, a_log, bb, cc, chunk=chunk)
            s, states = ssd_scratch(x, bb, chunk)
            _launch_chunk_state(x, dt, a_log, bb, s, states, chunk)
            _launch_state_pass(s, states, chunk)
            cb = torch.empty((ssd_cb_floats(b, l, g, p, n, chunk),),
                             dtype=torch.float32, device="cuda")
            s1, states1 = ssd_scratch(x, bb, chunk)
            times = {}
            for name, lib in libs.items():
                scan = lib.repro_ssd_chunk_scan
                scan.argtypes = [ctypes.c_void_p] * 8 + \
                    [ctypes.c_int] * 8 + [ctypes.c_void_p]
                state = lib.repro_ssd_chunk_state
                state.argtypes = [ctypes.c_void_p] * 6 + \
                    [ctypes.c_int] * 8 + [ctypes.c_void_p]
                y = torch.empty_like(x)
                stream = torch.cuda.current_stream().cuda_stream

                def run_scan():
                    err = scan(*(t.data_ptr() for t in (
                        x, dt, bb, cc, s, states, cb, y)),
                        b, l, h, g, p, n, chunk, scan_heads, stream)
                    if err:
                        sys.exit(f"ssd_pass3_probe: {name} pass 3 launch "
                                 f"failed: {err}")

                def run_state():
                    err = state(*(t.data_ptr() for t in (
                        x, dt, a_log, bb, s1, states1)),
                        b, l, h, g, p, n, chunk, state_heads, stream)
                    if err:
                        sys.exit(f"ssd_pass3_probe: {name} pass 1 launch "
                                 f"failed: {err}")
                run_scan()
                torch.cuda.synchronize()
                if name == "as_built" and not torch.equal(y, want):
                    sys.exit("ssd_pass3_probe: the built pass 3 is not the "
                             "wrapper's bits")
                times[name] = {"chunk_state": median_ms(run_state, args.reps),
                               "chunk_scan": median_ms(run_scan, args.reps)}
            out[f"{label}/{chunk}"] = times
            print(f"{label} chunk {chunk}: " + "; ".join(
                f"{k} state {v['chunk_state']:.4f} scan "
                f"{v['chunk_scan']:.4f} ms" for k, v in times.items()),
                flush=True)
            del s, states, s1, states1, cb
        del x, dt, a_log, bb, cc
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(json.dumps({"card": card, "ms": out}))


if __name__ == "__main__":
    main()
