#!/usr/bin/env python3
"""Check and time the SSD backward's passes by route on a CUDA card.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/ssd_bwd_times.py [--rounds 3] [--reps 10] [--seed 0]
        [--report-only] [--small-only] [--checkout DIR]

First the compiler's report for the backward's kernels (registers and
spills, ``-Xptxas -v``), then the checks, each the kernels' six gradients
against ``ssd_bwd_plain`` in float64 on the kernel forward's own ``s`` and
``h_in``, within chip_smoke's 1e-5 normwise, two calls the same bits:

* the library's route table (``repro_ssd_bwd_route``) against
  ``ssd_bwd_route`` at every (P, N, chunk), and its split scratch's size
  against ``ssd_bwd_split_floats``;
* small cases (batch 2, L 512, 4 heads over 2 groups) at each wgmma (P, N)
  and chunks 64 and 256, with h0 and a final-state gradient, and on the
  mma.sync route at chunks 16 and 32 and at (32, 64) chunk 64;
* mamba2-2.7b's (1, 4096, 80, 64, 1, 128) and jamba-v0.1-52b's (1, 4096,
  128, 64, 1, 16) at chunks 64 and 256.

Then, at those four wide cases, the backward's time as ``--rounds``
medians of ``--reps`` calls, each call between CUDA events, and each
kernel's device time in one ``torch.profiler`` window of ``--reps`` calls
(the mean over the window's events of that kernel).  ``--small-only``
stops after the small checks.

The last line of the output is one JSON object: the card's name and power
limit as ``nvidia-smi`` prints them, the checkout's path, the routes, the
checks and the times.  The kernels build from the checkout's ``csrc/``
into its ``build/`` at first use.  ``--checkout DIR`` runs another
checkout's kernels (its ``src/``; a checkout without the route table is
timed without the route checks): to compare two checkouts, run the script
for each on one card in one command, alternating (A, B, B, A), and
compare the times only within that command.
"""
import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

GATE = 1e-5
NAMES = ("dx", "ddt", "da_log", "db", "dc", "dh0")
#: (batch, L, H, P, G, N)
WIDE = {"mamba2-2.7b": (1, 4096, 80, 64, 1, 128),
        "jamba-v0.1-52b": (1, 4096, 128, 64, 1, 16)}
SMALL = (2, 512, 4, 2)   # (batch, L, H, G)
#: small cases: (P, N, chunk, h0 and dh_final given)
SMALL_CASES = ((64, 128, 64, True), (64, 128, 256, False),
               (64, 16, 64, False), (64, 16, 256, True),
               (64, 128, 16, True), (64, 16, 32, False), (32, 64, 64, True))
CHUNKS = (64, 256)


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


def kernel_means(fn, reps: int) -> dict:
    """{kernel: device ms a call} of the backward's kernels over one
    ``torch.profiler`` window of ``reps`` calls of ``fn`` (after one to
    warm up): each kernel's total over the window, over the calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"ssd_bwd_(\w+?)_kernel", ev.key)
        if m and ev.count:
            out[m.group(1)] = out.get(m.group(1), 0.0) + \
                ev.device_time_total / reps / 1e3
    return out


def normwise(got, want) -> float:
    import torch
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def ptxas_report() -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of each of
    the backward library's kernels, from its ``-Xptxas -v`` log."""
    from repro_torch.kernels import _build
    text = _build.library_path("ssd_bwd").with_suffix(".log").read_text()
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
            kern = re.search(r"\d+(ssd_bwd_[a-z_]+_kernel)(?:I(.*?)EE)?v",
                             name)
            label = (f"{kern.group(1)}<{kern.group(2) or ''}>" if kern
                     else name)
            rows.append((label, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report-only", action="store_true",
                    help="build, print the compiler's report and stop")
    ap.add_argument("--small-only", action="store_true",
                    help="stop after the small checks")
    ap.add_argument("--checkout", type=Path,
                    default=Path(__file__).resolve().parent.parent,
                    help="the checkout whose kernels run")
    args = ap.parse_args()
    root = args.checkout.resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("ssd_bwd_times: no CUDA device")
    import importlib
    from repro_torch.kernels import _build
    ssd_mod = importlib.import_module("repro_torch.kernels.ssd")
    from repro_torch.kernels.ssd import (KERNEL_HEAD_DIMS, KERNEL_STATES,
                                         _kernel_parts, ssd_bwd,
                                         ssd_bwd_plain)
    _build.build_all(["ssd", "ssd_bwd"])
    for row in ptxas_report():
        print("ptxas: %s %d registers, spills %d B stored / %d B loaded"
              % row, flush=True)
    if args.report_only:
        return
    route_of = getattr(ssd_mod, "ssd_bwd_route", None)

    if route_of is not None:
        lib = _build.load("ssd_bwd")
        lib.repro_ssd_bwd_route.argtypes = [ctypes.c_int] * 3
        lib.repro_ssd_bwd_split_floats.argtypes = [ctypes.c_int] * 7
        lib.repro_ssd_bwd_split_floats.restype = ctypes.c_longlong
        names = {0: None, 1: "wgmma", 2: "mma_sync"}
        differ = [(p, n, chunk) for p in KERNEL_HEAD_DIMS + (128,)
                  for n in KERNEL_STATES + (256,)
                  for chunk in (8, 16, 32, 48, 64, 96, 128, 256, 512)
                  if names[lib.repro_ssd_bwd_route(p, n, chunk)]
                  != route_of(p, n, chunk)]
        if differ:
            raise AssertionError(f"the library's route table differs from "
                                 f"ssd_bwd_route at {differ}")
        sizes = [(name, chunk, lib.repro_ssd_bwd_split_floats(
                      *shape[:3], shape[4], shape[3], shape[5], chunk),
                  ssd_mod.ssd_bwd_split_floats(*shape[:3], shape[4],
                                               shape[3], shape[5], chunk))
                 for name, shape in WIDE.items() for chunk in CHUNKS]
        if any(a != b for _, _, a, b in sizes):
            raise AssertionError(f"split scratch sizes differ: {sizes}")
        print("route table and split scratch sizes: the library's equal "
              "ssd_bwd_route's and ssd_bwd_split_floats'", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def inputs(b, l, h, p, g, n, with_state):
        def randn(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device="cuda") * scale
        x = randn(b, l, h, p)
        dt = torch.rand(b, l, h, generator=gen, device="cuda") * 0.1 + 1e-3
        a_log = randn(h, scale=0.5)
        bb, cc = randn(b, l, g, n, scale=n ** -0.5), \
            randn(b, l, g, n, scale=n ** -0.5)
        h0 = randn(b, h, p, n) if with_state else None
        dy = randn(b, l, h, p)
        dh = randn(b, h, p, n) if with_state else None
        return x, dt, a_log, bb, cc, h0, dy, dh

    def check(label, ops, chunk):
        x, dt, a_log, bb, cc, h0, dy, dh = ops
        _, _, s, h_in = _kernel_parts(x, dt, a_log, bb, cc, chunk, h0,
                                      want_state=False)
        call = (x, dt, a_log, bb, cc, s, h_in, dy, dh)
        routes = getattr(ssd_bwd, "route_launches", {})
        before = dict(routes)
        got = ssd_bwd(*call, chunk=chunk)
        torch.cuda.synchronize()           # a fault surfaces here
        again = ssd_bwd(*call, chunk=chunk)
        torch.cuda.synchronize()
        took = sorted(r for r, n in routes.items() if n != before[r])
        want = ssd_bwd_plain(*(None if t is None else t.double()
                               for t in call), chunk=chunk)
        errs = {k: normwise(g_, w_) for k, g_, w_ in zip(NAMES, got, want)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        p, n = x.shape[3], bb.shape[3]
        route = route_of(p, n, chunk) if route_of else None
        ok = same and max(errs.values()) <= GATE and \
            (route_of is None or took == [route])
        print(f"{label} (P {p}, N {n}, chunk {chunk}, {route}): normwise "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f"; two calls {'the same bits' if same else 'DIFFER'}"
              + ("" if ok else f"  FAILED (took {took})"), flush=True)
        if not ok:
            raise AssertionError(f"{label}: the backward disagrees with the "
                                 f"float64 plain backward: {errs}, same "
                                 f"bits {same}, routes {took}")
        return call, {"label": label, "p": p, "n": n, "chunk": chunk,
                      "route": route, "normwise": errs, "same_bits": same}

    checks = []
    b, l, h, g = SMALL
    for p, n, chunk, with_state in SMALL_CASES:
        _, res = check(f"small {SMALL}", inputs(b, l, h, p, g, n,
                                                 with_state), chunk)
        checks.append(res)
    times = {}
    if not args.small_only:
        for name, shape in WIDE.items():
            for chunk in CHUNKS:
                call, res = check(name, inputs(*shape, False), chunk)
                checks.append(res)
                fn = lambda: ssd_bwd(*call, chunk=chunk)  # noqa: E731
                medians = [median_ms(fn, args.reps)
                           for _ in range(args.rounds)]
                kernels = kernel_means(fn, args.reps)
                times[f"{name}/{chunk}"] = {"route": res["route"],
                                            "median_ms": medians,
                                            "kernel_ms": kernels}
                print(f"{name} chunk {chunk} ({res['route']}): medians (ms) "
                      + ", ".join(f"{m:.4f}" for m in medians)
                      + "; per kernel (ms) " + ", ".join(
                          f"{k} {v:.4f}" for k, v in kernels.items()),
                      flush=True)
                del call
                torch.cuda.empty_cache()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    print(json.dumps({"card": card, "checkout": str(root),
                      "ptxas": ptxas_report(), "checks": checks,
                      "times": times}))


if __name__ == "__main__":
    main()
