#!/usr/bin/env python3
"""Check and time the attention backward's routes on a CUDA card.

Usage, from the root of a checkout on a machine with a card::

    python3 tools/attn_backward_times.py [--rounds 3] [--reps 10] [--seed 0]
        [--report-only]

First the checks, each against ``flash_attention_bwd_plain`` on the kernel
forward's output and row log-sum-exp (normwise within chip_smoke's gates:
2^-12 in bfloat16, 1e-5 in float32):

* the library's route table (``repro_flash_attention_bwd_route``) against
  ``attn_bwd_route`` at every block and head dim, refusals included;
* every wgmma instantiation (blocks 64 and 128, head dims 64 and 128) on
  (2, 4, 2, 4 x block, d) under three masks: causal with a window of 1.5
  blocks and softcap 50, no mask, and a window alone;
* gemma2-27b's two layer kinds at 4096 tokens (32 query heads over 16 kv
  heads, D 128, softcap 50, window 4096 and none) at each wgmma block, two
  calls the same bits.

Then the times, as ``--rounds`` medians of ``--reps`` calls, each call
between CUDA events: the (1, 32, 4096, 4096, 128) causal problem in
bfloat16 at each wgmma block and on the mma.sync route at block 32, in
float32 on mma.sync at block 64, and gemma2's two layers at each wgmma
block; SDPA's backward (``torch.autograd.grad`` of
``scaled_dot_product_attention``, is_causal) on the bfloat16 problem
beside them; and each kernel's device time in one ``torch.profiler``
window of ``--reps`` calls of the bfloat16 problem at the first wgmma
block (the mean over the window's events of that kernel).  The compiler's
report for the backward's kernels (registers and spills, ``-Xptxas -v``)
is printed first.

The last line of the output is one JSON object: the card's name and power
limit as ``nvidia-smi`` prints them, the checkout's path, the checks and
the medians.  The kernels build from the checkout's ``csrc/`` into its
``build/`` at first use.  To compare two checkouts, run the script from
each on one card in one session, alternating (A, B, B, A), and compare
the times only within that session.
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

GATES = {"float32": 1e-5, "bfloat16": 2.0 ** -12}
S = 4096
D = 128
GEMMA = dict(hq=32, hkv=16, softcap=50.0, windows=(4096, 0))


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
    """{kernel: mean device ms} of the backward's kernels over one
    ``torch.profiler`` window of ``reps`` calls of ``fn`` (after one to
    warm up); the names shortened to their template."""
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
        m = re.search(r"(attn_bwd_\w+_kernel)(<[^(]*>)?", ev.key)
        if m and ev.count:
            name = m.group(1) + (m.group(2) or "")
            out[name] = ev.device_time_total / ev.count / 1e3
    return out


def normwise(got, want) -> float:
    import torch
    got, want = got.float(), want.float()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def ptxas_report() -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of each of
    the backward library's kernels, from its ``-Xptxas -v`` log."""
    from repro_torch.kernels import _build
    text = _build.library_path("flash_attention_bwd").with_suffix(
        ".log").read_text()
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
            kern = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEEv", name)
            label = (f"{kern.group(1)}<{kern.group(2)}>" if kern else name)
            rows.append((label, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def serialized() -> list:
    """ptxas's notes (C7510-C7520) that a kernel's wgmma products run one
    after another, and why, from the backward library's log."""
    from repro_torch.kernels import _build
    text = _build.library_path("flash_attention_bwd").with_suffix(
        ".log").read_text()
    out = []
    for line in text.splitlines():
        m = re.search(r"(Potential Performance Loss: .*?) for the function "
                      r"'\S*?\d+([a-z_]+_kernel)I(.*?)EEEv", line)
        if m:
            out.append(f"{m.group(2)}<{m.group(3)}>: {m.group(1)}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report-only", action="store_true",
                    help="build, print the compiler's report and stop")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("attn_backward_times: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        BWD_BLOCKS, BWD_WGMMA_BLOCKS, KERNEL_HEAD_DIMS, WGMMA_HEAD_DIMS,
        attn_bwd_route, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd)
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    for row in ptxas_report():
        print("ptxas: %s %d registers, spills %d B stored / %d B loaded"
              % row, flush=True)
    for line in serialized():
        print(f"ptxas: {line}", flush=True)
    if args.report_only:
        return

    lib_route = _build.load("flash_attention_bwd") \
        .repro_flash_attention_bwd_route
    lib_route.argtypes = [ctypes.c_int] * 3
    names = {0: None, 1: "wgmma", 2: "mma_sync"}
    dtypes = (torch.float32, torch.bfloat16)
    differ = [(str(dt)[6:], blk, d) for code, dt in enumerate(dtypes)
              for blk in (16, 32, 64, 128, 256)
              for d in KERNEL_HEAD_DIMS + (256,)
              if names[lib_route(code, blk, d)] != attn_bwd_route(dt, blk, d)]
    if differ:
        raise AssertionError(f"the library's route table differs from "
                             f"attn_bwd_route at {differ}")
    print("route table: the library's equals attn_bwd_route", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def operands(b, hq, hkv, s, d, dtype):
        return [torch.randn(b, h, s, d, generator=gen, device="cuda",
                            dtype=dtype) for h in (hq, hkv, hkv, hq)]

    def check(label, q, k, v, do, blk, kw):
        name = str(q.dtype)[6:]
        route = attn_bwd_route(q.dtype, blk, q.shape[3])
        before = dict(flash_attention_bwd.route_launches)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, blk=blk, **kw)
        torch.cuda.synchronize()           # a fault surfaces here
        took = [r for r, n in flash_attention_bwd.route_launches.items()
                if n != before[r]]
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, bq=blk, **kw)
        errs = {n: normwise(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                     got, want)}
        ok = took == [route] and max(errs.values()) <= GATES[name]
        print(f"{label} ({name}, block {blk}, {route}): normwise "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + ("" if ok else f"  FAILED (took {took})"), flush=True)
        if not ok:
            raise AssertionError(f"{label}: the {route} route disagrees "
                                 f"with the plain backward: {errs}")
        return {"label": label, "dtype": name, "blk": blk, "route": route,
                "normwise": errs}, (o, lse, got)

    checks = []
    for blk in BWD_WGMMA_BLOCKS:
        for d in WGMMA_HEAD_DIMS:
            for kw in (dict(causal=True, window=blk + blk // 2,
                            softcap=50.0),
                       dict(causal=False, window=0, softcap=0.0),
                       dict(causal=False, window=blk // 2 + 8)):
                ops = operands(2, 4, 2, 4 * blk, d, torch.bfloat16)
                res, _ = check(f"(2, 4, 2, {4 * blk}, {d}) {kw}", *ops, blk,
                               kw)
                checks.append(res)

    times = {}
    gemma_ops = operands(1, GEMMA["hq"], GEMMA["hkv"], S, D, torch.bfloat16)
    for window in GEMMA["windows"]:
        layer = "local" if window else "global"
        kw = dict(causal=True, window=window, softcap=GEMMA["softcap"])
        for blk in BWD_WGMMA_BLOCKS:
            res, (o, lse, first) = check(f"gemma2-27b {layer} layer",
                                         *gemma_ops, blk, kw)
            again = flash_attention_bwd(*gemma_ops[:3], o, lse, gemma_ops[3],
                                        blk=blk, **kw)
            same = all(torch.equal(a, b) for a, b in zip(first, again))
            if not same:
                raise AssertionError(f"two calls at gemma2's {layer} layer, "
                                     f"block {blk}, differ")
            res["same_bits"] = same
            checks.append(res)
            del first, again
            medians = [median_ms(lambda: flash_attention_bwd(
                *gemma_ops[:3], o, lse, gemma_ops[3], blk=blk, **kw),
                args.reps) for _ in range(args.rounds)]
            times[f"gemma2_{layer}/wgmma/{blk}"] = medians
            print(f"gemma2-27b {layer} layer, block {blk}: medians (ms) "
                  + ", ".join(f"{m:.4f}" for m in medians), flush=True)
    del gemma_ops

    for dtype, blocks in ((torch.bfloat16, BWD_WGMMA_BLOCKS + (32,)),
                          (torch.float32, (max(BWD_BLOCKS),))):
        name = str(dtype)[6:]
        q, k, v, do = operands(1, 32, 32, S, D, dtype)
        o, lse = flash_attention_fwd(q, k, v)
        for blk in blocks:
            route = attn_bwd_route(dtype, blk, D)
            check(f"(1, 32, {S}, {S}, {D}) causal", q, k, v, do, blk, {})
            medians = [median_ms(lambda: flash_attention_bwd(
                q, k, v, o, lse, do, blk=blk), args.reps)
                for _ in range(args.rounds)]
            times[f"problem_{name}/{route}/{blk}"] = medians
            print(f"problem {name}, block {blk} ({route}): medians (ms) "
                  + ", ".join(f"{m:.4f}" for m in medians), flush=True)
        if dtype == torch.bfloat16:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, is_causal=True)
            medians = [median_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), args.reps)
                for _ in range(args.rounds)]
            times["problem_bfloat16/sdpa_backward"] = medians
            print("problem bfloat16, SDPA's backward: medians (ms) "
                  + ", ".join(f"{m:.4f}" for m in medians), flush=True)
            del leaves, out
            blk = BWD_WGMMA_BLOCKS[0]
            times["problem_bfloat16/kernels"] = kernel_means(
                lambda: flash_attention_bwd(q, k, v, o, lse, do, blk=blk),
                args.reps)
            print(f"problem bfloat16, block {blk}, per kernel (ms): "
                  + ", ".join(f"{n} {m:.4f}" for n, m in
                              times["problem_bfloat16/kernels"].items()),
                  flush=True)
        del q, k, v, do, o, lse

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    print(json.dumps({"card": card, "checkout": str(ROOT),
                      "ptxas": ptxas_report(), "serialized": serialized(),
                      "checks": checks,
                      "median_ms": times}))


if __name__ == "__main__":
    main()
