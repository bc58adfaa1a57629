#!/usr/bin/env python3
"""Check and time the SSD forward's passes by route on a CUDA card.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/ssd_forward_times.py [--rounds 3] [--reps 20] [--seed 0]
        [--report-only] [--check-only] [--checkout DIR]

First the compiler's report for the forward's kernels (registers and
spills, ``-Xptxas -v``), then the checks, each the kernels' y (and the
final state where asked for) against ``ssd_plain`` in float64 on the same
operands, within chip_smoke's float32 gates (|diff| <= 2e-4 + 2e-4 |plain|
elementwise, 1e-5 normwise), two calls the same bits, each call on the
route ``ssd_route`` gives (its launch count):

* the library's route table, staging and C B^T scratch against
  ``ssd_route``, ``ssd_smem_bytes`` and ``ssd_cb_floats`` (chip_smoke's
  ``check_ssd_routes``, imported from this script's checkout);
* small cases (batch 2, L 512) at each wgmma (P, N) and chunks 64 and
  256, with h0 and the final state, at 1, 2 and 4 heads a group, and on
  the mma.sync route at chunks 16 and 32 and at (32, 64) chunk 64;
* mamba2-2.7b's (1, 4096, 80, 64, 1, 128) and jamba-v0.1-52b's (1, 4096,
  128, 64, 1, 16), with the reference test's operands (dt = |N(0, 1)|
  0.1, a_log = N(0, 1) 0.5, x, b, c standard normal), at chunks 32
  (mma.sync), 64 and 256.

Then, at those six wide cases, the forward whole and each of its three
passes alone (``_launch_chunk_state``, ``_launch_state_pass``,
``_launch_chunk_scan`` at the head counts the wrapper picks), as
``--rounds`` medians of ``--reps`` calls, each call between CUDA events.

The last line of the output is one JSON object: the card's name and power
limit as ``nvidia-smi`` prints them, the checkout's path, the checks and
the times.  The kernels build from the checkout's ``csrc/`` into its
``build/`` at first use.  ``--checkout DIR`` runs another checkout's
kernels (its ``src/``; one without the route table is checked and timed
without the route checks): to compare two checkouts, run the script for
each on one card in one command, the other first, and compare the times
only within that command.
"""
import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ELEMWISE, NORMWISE = 2e-4, 1e-5
#: (batch, L, H, P, G, N)
WIDE = {"mamba2-2.7b": (1, 4096, 80, 64, 1, 128),
        "jamba-v0.1-52b": (1, 4096, 128, 64, 1, 16)}
WIDE_CHUNKS = (32, 64, 256)
#: small cases: (batch, L, H, P, G, N, chunk, with h0 and the final state)
SMALL_CASES = ((2, 512, 8, 64, 2, 128, 64, True),
               (2, 512, 8, 64, 1, 128, 256, False),
               (2, 512, 2, 64, 2, 128, 128, True),
               (2, 512, 8, 64, 2, 16, 64, False),
               (2, 512, 6, 64, 2, 16, 256, True),
               (2, 512, 8, 64, 2, 128, 16, True),
               (2, 512, 8, 64, 2, 16, 32, False),
               (2, 512, 8, 32, 2, 64, 64, True))


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


def ptxas_report(lib_name: str = "ssd") -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of each of
    a library's kernels, from its ``-Xptxas -v`` log."""
    from repro_torch.kernels import _build
    text = _build.library_path(lib_name).with_suffix(".log").read_text()
    rows, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            kern = re.search(r"\d+(ssd_[a-z_]+_kernel)(?:I(.*?)EE)?v", name)
            label = (f"{kern.group(1)}<{kern.group(2) or ''}>" if kern
                     else name)
            rows.append((label, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def operands(gen, b, l, h, p, g, n, with_h0):
    """The reference test's operands on the card, h0 standard normal."""
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x = randn(b, l, h, p)
    dt = randn(b, l, h).abs() * 0.1
    a_log = randn(h) * 0.5
    bb, cc = randn(b, l, g, n), randn(b, l, g, n)
    h0 = randn(b, h, p, n) if with_h0 else None
    return x, dt, a_log, bb, cc, h0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report-only", action="store_true",
                    help="build, print the compiler's report and stop")
    ap.add_argument("--check-only", action="store_true",
                    help="stop after the checks")
    ap.add_argument("--checkout", type=Path,
                    default=Path(__file__).resolve().parent.parent,
                    help="the checkout whose kernels run")
    args = ap.parse_args()
    root = args.checkout.resolve()
    sys.path.insert(0, str(root / "src"))
    # chip_smoke's route-table check, from this script's own checkout
    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_forward_times: no CUDA device")
    import importlib
    from repro_torch.kernels import _build
    mod = importlib.import_module("repro_torch.kernels.ssd")
    ssd, ssd_plain = mod.ssd, mod.ssd_plain
    _build.build_all(["ssd"])
    for row in ptxas_report():
        print("ptxas: %s %d registers, spills %d B stored / %d B loaded"
              % row, flush=True)
    if args.report_only:
        return
    route_of = getattr(mod, "ssd_route", None)
    routes = chip_smoke.check_ssd_routes() if route_of else None
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def check(label, ops, chunk):
        x, dt, a_log, bb, cc, h0 = ops
        routes = getattr(ssd, "route_launches", {})
        before = dict(routes)
        got = ssd(x, dt, a_log, bb, cc, chunk=chunk, h0=h0,
                  return_state=True)
        torch.cuda.synchronize()           # a fault surfaces here
        again = ssd(x, dt, a_log, bb, cc, chunk=chunk, h0=h0,
                    return_state=True)
        torch.cuda.synchronize()
        took = sorted(r for r, k in routes.items() if k != before[r])
        want = ssd_plain(*(t.double() for t in (x, dt, a_log, bb, cc)),
                         chunk=chunk, return_state=True,
                         h0=None if h0 is None else h0.double())
        errs = {}
        for what, g_, w_ in zip(("y", "h_final"), got, want):
            d = (g_.double() - w_).abs()
            errs[what] = {
                "elementwise": float((d / (ELEMWISE + ELEMWISE *
                                           w_.abs())).max()) * ELEMWISE,
                "normwise": float(d.norm() / w_.norm())}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        p, n = x.shape[3], bb.shape[3]
        route = route_of(p, n, chunk) if route_of else None
        ok = same and all(e["elementwise"] <= ELEMWISE and
                          e["normwise"] <= NORMWISE for e in errs.values()) \
            and (route_of is None or took == [route])
        print(f"{label} (P {p}, N {n}, chunk {chunk}, {route}): "
              + "; ".join(f"{k} elementwise {e['elementwise']:.3e}, "
                          f"normwise {e['normwise']:.3e}"
                          for k, e in errs.items())
              + f"; two calls {'the same bits' if same else 'DIFFER'}"
              + ("" if ok else f"  FAILED (took {took})"), flush=True)
        if not ok:
            raise AssertionError(f"{label}: the forward disagrees with the "
                                 f"float64 plain version: {errs}, same bits "
                                 f"{same}, routes {took}")
        return {"label": label, "p": p, "n": n, "chunk": chunk,
                "route": route, "errors": errs, "same_bits": same}

    checks = [check(f"small {case[:6]}", operands(gen, *case[:6], case[7]),
                    case[6]) for case in SMALL_CASES]
    times = {}
    for name, shape in WIDE.items():
        ops = operands(gen, *shape, False)
        x, dt, a_log, bb, cc, _ = ops
        b, l, h, p, g, n = shape
        for chunk in WIDE_CHUNKS:
            checks.append(check(name, ops, chunk))
            if args.check_only:
                continue
            s, states = mod.ssd_scratch(x, bb, chunk)
            y = torch.empty_like(x)
            reps = args.reps

            def rounds(fn):
                return [median_ms(fn, reps) for _ in range(args.rounds)]
            row = {"route": route_of(p, n, chunk) if route_of else None,
                   "forward_ms": rounds(lambda: ssd(*ops[:5], chunk=chunk)),
                   "chunk_state_ms": rounds(lambda: mod._launch_chunk_state(
                       x, dt, a_log, bb, s, states, chunk)),
                   "state_pass_ms": rounds(lambda: mod._launch_state_pass(
                       s, states, chunk)),
                   "chunk_scan_ms": rounds(lambda: mod._launch_chunk_scan(
                       x, dt, bb, cc, s, states, y, chunk))}
            times[f"{name}/{chunk}"] = row
            print(f"{name} chunk {chunk} ({row['route']}): " + "; ".join(
                f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                for k, v in row.items() if k != "route"), flush=True)
            del s, states, y
        del ops, x, dt, a_log, bb, cc
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    print(json.dumps({"card": card, "checkout": str(root),
                      "ptxas": ptxas_report(), "route_table": routes,
                      "checks": checks, "times": times}))


if __name__ == "__main__":
    main()
