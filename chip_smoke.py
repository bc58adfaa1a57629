#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` (one nvcc per source, all at once, into
``build/repro_torch_kernels/``), holds each against its plain PyTorch
version, and drives every path of the port on the card:

1. card and kernel build;
2. kernel check: the CUDA matmul against its plain version on the test
   shapes and on a shape for each of its (bm, bn, bk) instantiations that
   the card can stage (float32 and bfloat16); a test shape whose tiles
   the kernel does not take must be refused;
3. the paper's path at n = 4096, b from 64 to 1024: generate
   potf2/trsm/syrk/gemm models on the card over the domains the Cholesky
   tracers call, rank the three potrf variants and the block size without
   executing them, then execute them through ``ExecEngine`` and compare
   predicted with measured times; the performance yield is read on the
   whole grid and, on the same measurements, on the grid through 512;
4. the matmul tile path: sweep every legal tile of the CUDA matmul on its
   proxy problem, fit the transfer models and select the tile for 4096^3;
   then run every legal tile at 4096^3, check each result against the
   plain version and compare predicted with measured order;
5. the matmul at 4096^3 beside its plain version and ``torch.matmul``;
6. kernel check: flash attention and the SSD scan against their plain
   versions on the reference tests' cases, then at gemma2-27b's attention
   width (local and global layers, float32 and bfloat16) and at
   mamba2-2.7b's SSD width, each timed beside its bound;
7. the attention tile path: sweep the legal (bq, bkv, 128) blocks on their
   proxies and rank them for gemma2-27b's query heads at 4096 tokens; then
   run every legal block there, check and time it, and compare orders;
8. the SSD chunk path: the same for the (chunk, 64, 128) configs and
   mamba2-2.7b's 80 heads at 4096 tokens, then the selected chunk's three
   passes (chunk state, state pass, chunk scan) timed one by one;
9. the contraction path (Ch. 6) through one ``backend="torch"`` session
   whose warm/cold classes are decided against the card's L2: the skewed
   ``abc=ai,ibc`` at a = b = c = 512, i = 8; the batched ``bij,bjk->bik``
   at b = 64, i = j = k = 1024; the chain ``aij,ijb,bkl,klc->ac`` at
   a = b = c = 16, i = j = k = l = 2048 under an 8 GiB intermediate
   limit.  For each: candidates, requests and distinct micro-benchmarks,
   the suite's cost, ranking times on torch and numpy and whether they
   agree, agreement with the oracles; then every candidate predicted
   under 1 s (the top three and the predicted worst such always, the rest
   until a budget) executed on the card, predicted against measured,
   the performance yield, Kendall tau and the suite cost fraction; the
   executed winner is held against the whole einsum (2e-4 normwise);
10. the torch prediction engine on phase 3's potrf model set and its
   (variant, b) grid against the numpy engine (relative 1e-12), with
   milliseconds per batch of both;
11. the store path: phases 4, 7 and 8's session (the three kernel
   families' measurements and models, the transfer models, and phase 3's
   potrf model set) and phase 9's session saved to two stores under the
   card's fingerprint; sessions warm-started from them, in this process
   and in a second one under the strict fingerprint check, must take no
   fresh micro-benchmark and no sweep and rank everything phases 4 and
   7-10 ranked bit for bit; the kernels run at the stores' choices, which
   must be phases 4, 7 and 8's, each held against its plain version; four
   altered copies must be refused; a drift probe against the phase-9
   store and a tournament on the reference's frozen workloads are
   reported;
12. the models path: gemma2-27b at full width and depth (46 layers) in
   bfloat16 prefills an 8192-token prompt, then decodes 16 greedy tokens
   from the prefill's caches; mamba2-2.7b (64 layers, float32) the same at
   batch 2 and 4096 tokens; parameters random from a seeded card
   generator, through the port's ``init_params``, ``prefill`` and
   ``decode_step``.  Every attention layer's prompt runs through the
   flash-attention kernel and every Mamba layer's through the SSD kernel;
   each kernel's share of the prefill is read with CUDA events around its
   calls, and one more prefill runs under ``torch.profiler`` for the
   device's busy share.  The checks (12c) cut both to 2 periods: the
   kernel route against the plain route on the same parameters and
   prompt, and prefill logits against a 256-token decode replay in
   float32;
13. the serve path: gemma2-27b (bfloat16) and mamba2-2.7b (float32) at
   full width and depth served through the port's ``ServeEngine`` (4
   slots, 4096-token context) under FIFO over an open-loop smoke trace of
   101 requests (prompts of 16-256 tokens, 4 new tokens each, Poisson
   arrivals 0.25 s apart on average).  Each blocking admission runs its
   prompt's longest kernel-legal head in batched passes over every slot
   (the attention or SSD kernel in every layer) and replays the tail
   through ``decode_step``; every admission and decode tick is timed.
   Three prompts of 300-2000 tokens are then admitted one at a time, and
   the head of the longest runs under ``torch.profiler`` for the
   kernel's share.  13c builds gemma2-27b's step-cost model through a
   session measuring on the card and sets its predicted tick beside the
   measured one; 13d runs FIFO and the model-guided scheduler over one
   short trace (8 requests, prompts of 16-64 tokens, 16 new, gaps of 0.2
   s).  The checks at 2 periods, on 256-slot rings and at the timed
   path's shape: two admissions' caches against a hand-driven decode
   replay (float32), the kernel route against the plain route, and the
   same tokens from both routes on a FIFO trace;
14. the train path: (14a) the flash-attention backward kernels (delta,
   dK/dV, dQ) against their plain version on the kernel forward's output
   and row log-sum-exp, at every instantiated (block, head dim) in both
   dtypes and two masks, and at gemma2-27b's widths over 4096 tokens, then
   timed at (1, 32, 4096, 4096, 128) causal float32 beside the plain
   backward, its bound and the backward of PyTorch's SDPA; (14b) every
   parameter's gradient of ``loss_fn`` at gemma2-27b's full width cut to
   one period (batch 1 x 512), kernel route against plain route, in both
   dtypes; (14c) gemma2-27b at full width cut to 2 periods (4 layers,
   3.44 B parameters, bfloat16, float32 AdamW moments) trained for 8 steps
   on batch 1 x 4096 tokens through the port's ``train`` (per-period
   remat, chunked cross entropy), then one step under ``torch.profiler``
   (attention forward and backward, products, AdamW, idle); (14d) a small
   config trained on the card, checkpointed asynchronously and resumed in
   a fresh ``train``, its losses equal to an uninterrupted run's bit for
   bit;

and prints a ``kernels`` JSON line (launches on each path of the main run,
error, times and bound per kernel).  The count of every kernel is set to 0
just before each of the paths 3, 4, 7, 8, 9, 10, 11, 12, 13 and 14c and
read just after (the paths 9 and 10 launch none of the kernels); the
checks and timings of phases 2, 5, 6, 14a, 14b and 14d, and those after
each path, are not counted.

The card's name and power limit print on the line before the last; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises, so the
script exits nonzero and prints no result.  Long outputs (the compilers'
reports, the fitted models, per-config times) go to
``chiprun_out/chip_smoke/`` (phases 9, 10, 11, 12, 13 and 14 under
``contractions``, ``torch_engine``, ``store``, ``models``, ``serve`` and
``train`` in ``result.json``; the stores as
``store_*.json``, the scoreboard as ``TOURNAMENT.json``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

N = 4096                                   # the paper path's problem size
BLOCK_SIZES = (64, 96, 128, 192, 256, 384, 512, 768, 1024)
#: the grid through PR 15, whose largest point was the measured optimum;
#: its yield is read on the same measurements as a subset
OLD_BLOCK_SIZES = BLOCK_SIZES[:7]
#: benchmarks/common.py BENCH_GEN_CONFIG, the reference's generator setup
GEN_CONFIG = dict(overfit=0, oversampling=2, repetitions=5,
                  error_bound=0.04, min_width=64, max_pieces=6)
EXEC_REPS = 3                              # executions per measured point
TILE_PASSES = 5                            # sweep passes per tile config
TIME_REPS = 10                             # launches per kernel timing
TEST_SHAPES = [(128, 128, 128, 64, 64, 64), (256, 128, 192, 128, 64, 64),
               (64, 64, 64, 64, 64, 64), (256, 256, 256, 128, 128, 128),
               (384, 128, 256, 128, 128, 64)]
#: relative normwise bound of the 4096^3 float32 check: float32 rounding
#: grows like sqrt(k) * eps over a k = 4096 sum, in both versions
BIG_TOL = 1e-5
#: test_kernels_pallas.py's flash-attention cases: (hq, hkv, s, d, kwargs)
ATTN_CASES = [(4, 4, 64, 32, dict(causal=True)),
              (4, 2, 128, 32, dict(causal=True)),
              (4, 1, 64, 16, dict(causal=False)),
              (4, 2, 128, 32, dict(causal=True, window=32)),
              (4, 2, 64, 32, dict(causal=True, softcap=20.0))]
#: test_kernels_pallas.py's SSD cases: (l, h, p, g, n, chunk)
SSD_CASES = [(64, 4, 16, 2, 8, 16), (128, 4, 16, 1, 16, 32),
             (64, 8, 8, 4, 8, 64)]
#: gemma2-27b (src/repro/configs/gemma2_27b.py): 32 query heads, 16 kv
#: heads, head dim 128, attention softcap 50, sliding window 4096 on local
#: layers, none on global ones
GEMMA = dict(hq=32, hkv=16, d=128, softcap=50.0, windows=(4096, 0))
GEMMA_S = 8192                           # the check's sequence length
#: the attention tile path's problem: gemma2-27b's query heads at its
#: train_4k length, with the family's causal, equal-head operands
ATTN_PROBLEM = (1, 32, 4096, 4096, 128)
ATTN_BLOCKS = (16, 32, 64, 128)
#: mamba2-2.7b (src/repro/configs/mamba2_2_7b.py): 80 heads of dim 64, one
#: group, state 128, chunk 256; the SSD path's problem at 4096 tokens
SSD_PROBLEM = (1, 4096, 80, 64, 1, 128)
SSD_MODEL_CHUNK = 256
SSD_CHUNKS = (32, 64, 128, 256)
#: relative normwise bounds of the wide checks (||kernel - plain|| /
#: ||plain||).  float32: both versions sum up to 8192 products (attention)
#: or 256-long chunk products (SSD) in different orders, an error that
#: grows like sqrt(terms) * eps ~ 1e-5 at worst.  bfloat16 attention: both
#: versions round p to bfloat16 before p v and round the output once, so
#: they differ only where their float32 logits differ in the last bits and
#: flip one of those roundings (about 7e-5 normwise at gemma2 width).  A
#: version that leaves p unrounded is off by the rounding of every p, about
#: 2^-8 / sqrt(3) ~ 1e-3 normwise.  2^-12 lies between the two, and phase 6
#: measures that fault on the same inputs and fails if the bound would
#: pass it.
WIDE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -12}
#: phase 9's contraction cases: (label, spec, sizes, source).  The
#: reference benchmark's skewed example and batched spec, at sizes that
#: fill the card: C of the skewed one is 512 MiB, ten times the L2
CONTRACTION_CASES = [
    ("skewed", "abc=ai,ibc", dict(a=512, b=512, c=512, i=8),
     "benchmarks/bench_contractions.py:48"),
    ("batched", "bij,bjk->bik", dict(b=64, i=1024, j=1024, k=1024),
     "benchmarks/bench_contractions.py:50"),
]
#: phase 9's chain: the reference's smoke chain at a = b = c = 16, with a
#: limit that drops the ijb,bkl pairing (a 64 TiB intermediate) unrun
CHAIN_CASE = ("chain", "aij,ijb,bkl,klc->ac",
              dict(a=16, b=16, c=16, i=2048, j=2048, k=2048, l=2048),
              "benchmarks/bench_einsum_paths.py:49")
CHAIN_LIMIT = 8 * 2 ** 30
EXEC_UNDER_S = 1.0           # execute every candidate predicted below this
EXEC_BUDGET_S = 35.0         # per case: executions beyond it are cut
CONTRACTION_TOL = 2e-4       # normwise, the executed winner vs the einsum
ENGINE_TOL = 1e-12           # relative, torch engine vs numpy engine
#: phase 12's models at full width and depth, random parameters from a
#: seeded card generator: (arch, dtype, batch, prompt tokens).  gemma2-27b
#: (src/repro/configs/gemma2_27b.py) in bfloat16: at 8192 tokens the 4096
#: window masks in every local layer; mamba2-2.7b
#: (src/repro/configs/mamba2_2_7b.py) in float32, the SSD kernel's type, at
#: its chunk 256
MODEL_RUNS = (("gemma2-27b", "bfloat16", 1, 8192),
              ("mamba2-2.7b", "float32", 2, 4096))
DECODE_STEPS = 16            # greedy decode steps after each prefill
CHECK_PERIODS = 2            # depth of phase 12c's checks, in periods
REPLAY_LEN = 256             # prompt of the prefill-vs-replay check
#: phase 12c's normwise bounds, kernel route vs plain route on the same
#: parameters and prompt.  float32: the two sum the same products in other
#: orders (1e-5 a call, phase 6), over a few layers.  bfloat16: both round
#: p and every activation to bfloat16, and a float32 logit that differs in
#: its last bits flips one of those roundings (2^-9 relative) here and
#: there; four layers of residual stream carry them to the logits.
ROUTE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: prefill vs decode replay, elementwise as the reference's test
#: (tests/test_cache_and_moe.py): chunked scans vs one-step recurrences
REPLAY_TOL = 2e-3
#: phase 13's served models at full width and depth, random parameters
#: from a seeded card generator: (arch, dtype), the same two as phase 12.
#: 4 slots at a 4096-token context, gemma2-27b's local window, so its
#: local and global rings are both 4096 long
SERVE_RUNS = (("gemma2-27b", "bfloat16"), ("mamba2-2.7b", "float32"))
SERVE_SLOTS, SERVE_CTX = 4, 4096
#: 13a/b's served trace, (requests, shortest and longest prompt, new
#: tokens, mean Poisson gap in s).  A smoke mix: the repo holds no
#: published serving workload, and nothing is concluded from its mix.  101
#: requests, so that p99 (numpy's linear percentile) is the second slowest
#: request and not the slowest; prompts drawn uniformly and not rounded, so
#: most admissions have a tail; arrivals faster than either model serves,
#: so the run measures capacity and its latencies include the backlog.
#: 13d's trace is short, one trace for both policies
SERVE_TRACE = (101, 16, 256, 4, 0.25)
GUIDED_TRACE = (8, 16, 64, 16, 0.2)
#: 13a/b's admission sample: (prompts, shortest, longest), admitted one at
#: a time after the trace, each timed by head passes and tail; the head of
#: the longest is admitted once more and profiled
ADMIT_SAMPLE = (3, 300, 2000)
#: 13 check, at CHECK_PERIODS periods: an admission of a second prompt
#: while the first is live, twice: on rings of SERVE_CHECK_CTX (shorter
#: than the second prompt, so its head's write rolls; a head of 304, so
#: attention at (16, 16) blocks and a second SSD pass at chunk 16), and at
#: the timed path's shape (SERVE_CTX, the admission sample's longest
#: prompt); and a FIFO trace on both routes in float32
SERVE_CHECK_PROMPTS = (100, 304)
SERVE_CHECK_CTX = 256
SERVE_CHECK_TRACE = (4, 100, 300, 8, 0.0)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"{time.perf_counter() - _T0:7.1f}s {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms, each launch between events."""
    import torch
    fn()                                   # warm up
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def pass_ms(calls, reps: int) -> list:
    """Median device time in ms of each of ``calls``, run in sequence with
    an event between each two."""
    import torch
    for fn in calls:                       # warm up
        fn()
    runs = []
    for _ in range(reps):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(calls) + 1)]
        events[0].record()
        for fn, event in zip(calls, events[1:]):
            fn()
            event.record()
        runs.append(events)
    torch.cuda.synchronize()
    return [sorted(r[i].elapsed_time(r[i + 1]) for r in runs)[reps // 2]
            for i in range(len(calls))]


def order_agreement(pred_order, meas: dict) -> tuple:
    """(agreeing pairs, pairs, Kendall tau) of the predicted order against
    the measured times (a pair agrees when the one predicted faster
    measured no slower)."""
    n_pairs = agree = 0
    for i in range(len(pred_order)):
        for j in range(i + 1, len(pred_order)):
            n_pairs += 1
            agree += meas[pred_order[i]] <= meas[pred_order[j]]
    return agree, n_pairs, 2 * agree / n_pairs - 1 if n_pairs else 1.0


def kendall_tau(pred_order, meas: dict) -> float:
    """:func:`order_agreement`'s tau, logged."""
    agree, n_pairs, tau = order_agreement(pred_order, meas)
    log(f"  predicted vs measured order: {agree}/{n_pairs} pairs agree "
        f"(Kendall tau {tau:.3f})")
    return tau


def rel_err(out, ref) -> float:
    """Relative normwise error ||out - ref|| / ||ref|| in float32."""
    import torch
    out, ref = out.float(), ref.float()
    return float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))


def ptxas_table(log_text: str) -> dict:
    """Registers and spill bytes per instantiation, from ``-Xptxas -v``:
    {(kernel, dtype, template ints): (registers, spill stores, spill
    loads)}, the kernel name and arguments read from the mangled name (no
    template ints for a kernel that is not a template)."""
    import re
    table, key, spills = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kern = re.search(r"\d+([a-z_]+_kernel)[IE]", name)
            dtype = "bfloat16" if "__nv_bfloat16" in name else "float32"
            key = (kern.group(1) if kern else name, dtype,
                   tuple(int(a) for a in re.findall(r"Li(\d+)E", name)))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and key is not None:
            table[key] = (int(m.group(1)), *spills)
            key, spills = None, (0, 0)
    return table


def selected_ptxas_keys(matmul_cfg, attn_cfg, ssd_cfg) -> dict:
    """The ptxas_table keys of each kernel's instantiations at its selected
    config: {kernel: [(what, key), ...]}.  The matmul's (bm, bn, bk) is
    instantiated as (bm / 64, bn / 64, bk), attention's (bq, bkv, d) as
    (bq, bkv, d) / 16, and the SSD's (chunk, p, n) as its three passes:
    chunk state (p, n), the state pass (no template) and chunk scan (p, n,
    min(chunk, 64))."""
    bm, bn, bk = matmul_cfg
    chunk, p, n = ssd_cfg
    return {
        "matmul": [("matmul", ("matmul_kernel", "float32",
                               (bm // 64, bn // 64, bk)))],
        "flash_attention": [("attention", (
            "attn_kernel", "float32", tuple(c // 16 for c in attn_cfg)))],
        "ssd": [("chunk_state", ("ssd_chunk_state_kernel", "float32",
                                 (p, n))),
                ("state_pass", ("ssd_state_pass_kernel", "float32", ())),
                ("chunk_scan", ("ssd_chunk_scan_kernel", "float32",
                                (p, n, min(chunk, 64))))]}


def bound(flops: float, nbytes: float, peak_flops: float, card) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory rate."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / card.hbm_bytes_per_s * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes}


def attn_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs a mask keeps over one s x s head: row i keeps
    keys max(0, i - window + 1) .. (i if causal else s - 1)."""
    return sum((i if causal else s - 1) -
               (max(0, i - window + 1) if window > 0 else 0) + 1
               for i in range(s))


def attn_work(b, hq, hkv, s, d, causal, window, itemsize):
    """(flops, bytes) attention needs: 4 d flops per kept pair (q k^T and
    p v), q, k, v read once and o written once."""
    flops = 4.0 * b * hq * d * attn_pairs(s, causal, window)
    nbytes = float(itemsize) * b * s * d * (2 * hq + 2 * hkv)
    return flops, nbytes


def ssd_work(b, l, h, p, g, n, chunk):
    """(flops, bytes) the SSD scan needs, per head and chunk: C B^T and
    G X over the Q (Q + 1) / 2 pairs i >= j that causality keeps (2 N and
    2 P flops a pair; the upper triangle is zero, so, as in attn_work,
    only kept pairs count), C h^T and X^T (B w) (2 Q P N each); x, dt,
    a_log, b, c read once and y written once."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2.0 * pairs * (n + p) + 4.0 * chunk * p * n
    flops = per_chunk * b * h * (l // chunk)
    nbytes = 4.0 * (2 * b * l * h * p + b * l * h + h + 2 * b * l * g * n)
    return flops, nbytes


# ------------------------------------------------------------ phase 2 --
def check_kernel_shapes() -> None:
    """The test shapes, then one shape per (bm, bn, bk) instantiation of
    the kernel that the card can stage (a 2 x 3 grid of blocks, k = 4 bk
    up to the test shapes' 256, where the 2e-5 bound holds two float32
    summation orders; phase 4 runs every legal tile at k = 4096), each in
    both dtypes.  A test shape whose tiles the kernel does not take must
    be refused by the wrapper."""
    import numpy as np
    import torch
    from repro_torch.kernels.matmul import (KERNEL_BKS, KERNEL_TILES,
                                            matmul, matmul_plain, tile_legal)

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    shapes = list(TEST_SHAPES) + [
        (2 * bm, 3 * bn, min(4 * bk, 256), bm, bn, bk)
        for bm, bn in KERNEL_TILES for bk in KERNEL_BKS
        if tile_legal(2 * bm, 3 * bn, 4 * bk, bm, bn, bk, limit)]
    rng = np.random.default_rng(7)
    for m, n, k, bm, bn, bk in shapes:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(
                np.float32)).to("cuda", dtype)
            y = torch.from_numpy(rng.standard_normal((k, n)).astype(
                np.float32)).to("cuda", dtype)
            if not tile_legal(m, n, k, bm, bn, bk, limit):
                try:
                    matmul(x, y, bm=bm, bn=bn, bk=bk)
                except ValueError as exc:
                    log(f"  matmul {m}x{n}x{k} tiles ({bm},{bn},{bk}) "
                        f"{str(dtype)[6:]}: not legal for the kernel, "
                        f"refused ({str(exc)[:60]}...)")
                    continue
                raise AssertionError(f"matmul took illegal tiles "
                                     f"{(bm, bn, bk)}")
            out = matmul(x, y, bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()       # a fault surfaces here
            ref = matmul_plain(x, y, bm=bm, bn=bn, bk=bk)
            diff = (out.float() - ref.float()).abs()
            ratio = float((diff / (tol + tol * ref.float().abs())).max())
            log(f"  matmul {m}x{n}x{k} tiles ({bm},{bn},{bk}) "
                f"{str(dtype)[6:]}: max_abs_err {float(diff.max()):.3e}, "
                f"max |diff| / ({tol} + {tol} |plain|) {ratio:.3f} "
                f"(bound 1)")
            if not ratio <= 1.0:
                raise AssertionError(f"matmul disagrees with its plain "
                                     f"version at {(m, n, k)} {dtype}")


# ------------------------------------------------------------ phase 3 --
def paper_path(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import (GeneratorConfig, KernelBenchmark, ModelSet,
                                  generate_model,
                                  optimize_algorithm_and_block_size,
                                  optimize_block_size, performance_yield,
                                  rank_algorithms)
    from repro_torch.core.grids import Domain
    from repro_torch.dla import ExecEngine, blocked
    from repro_torch.dla.engine import Matrix
    from repro_torch.dla.kernels import KERNELS
    from repro_torch.dla.tracers import CHOLESKY_TRACERS

    boxes = {}
    for tracer in CHOLESKY_TRACERS.values():
        for b in BLOCK_SIZES:
            for call in tracer(N, b):
                if min(call.sizes) <= 0:
                    continue
                key = (call.kernel, call.case)
                lo, hi = boxes.get(key, (call.sizes, call.sizes))
                boxes[key] = (tuple(map(min, lo, call.sizes)),
                              tuple(map(max, hi, call.sizes)))
    cfg = GeneratorConfig(**GEN_CONFIG)
    models = ModelSet()
    gen_s = 0.0
    for kernel in sorted({k for k, _ in boxes}):
        cases = [c for k, c in boxes if k == kernel]
        kd = KERNELS[kernel]
        bench = KernelBenchmark(
            name=kernel, cases=cases,
            case_domains={c: Domain(*boxes[(kernel, c)]) for c in cases},
            cost_exponents=kd.cost_exponents,
            make_call=lambda c, p, _kd=kd: _kd.make_call(c, p, device=dev))
        model, report = generate_model(bench, cfg)
        models.add(model)
        gen_s += report.seconds
        log(f"  modelgen {kernel} {cases}: domain {boxes[(kernel, cases[0])]}"
            f", {report.measured_points} points, "
            f"{sum(report.pieces_per_case.values())} pieces, "
            f"{report.seconds:.1f} s")
    models.save(str(OUT / "models_n4096.json"))

    best_name, b_pred, t_best = optimize_algorithm_and_block_size(
        CHOLESKY_TRACERS, models, N, list(BLOCK_SIZES))
    old_name, old_b_pred, _ = optimize_algorithm_and_block_size(
        CHOLESKY_TRACERS, models, N, list(OLD_BLOCK_SIZES))
    profiles = {name: optimize_block_size(tr, models, N,
                                          list(BLOCK_SIZES))[1]
                for name, tr in CHOLESKY_TRACERS.items()}
    log(f"  predicted optimum: {best_name} at b={b_pred} "
        f"({t_best * 1e3:.2f} ms)")
    ranked = rank_algorithms(CHOLESKY_TRACERS, models, N, b_pred)
    log(f"  predicted ranking at b={b_pred}: " + ", ".join(
        f"{r.name} {r.runtime.med * 1e3:.2f} ms" for r in ranked))

    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((N, N), generator=g, device=dev, dtype=torch.float64)
    spd = a @ a.T + N * torch.eye(N, device=dev, dtype=torch.float64)
    L64 = torch.linalg.cholesky(spd)
    A0 = spd.cpu().numpy()

    def execute(name, b):
        """Median wall time of one potrf through ExecEngine (each kernel
        call ends in its blocking D2H, so the host clock is valid)."""
        times, factor = [], None
        for _ in range(EXEC_REPS):
            eng = ExecEngine(device=dev)
            eng.bind("A", A0)
            t0 = time.perf_counter()
            blocked.potrf(eng, Matrix("A", N, N), N, b,
                          variant=int(name[-1]))
            times.append(time.perf_counter() - t0)
            factor = eng.mats["A"]
        return sorted(times)[len(times) // 2], factor

    measured = {}
    rows = [(name, b_pred) for name in CHOLESKY_TRACERS] + \
        [(best_name, b) for b in BLOCK_SIZES if b != b_pred]
    rows += [(old_name, b) for b in OLD_BLOCK_SIZES
             if (old_name, b) not in rows]
    factor = None
    for name, b in rows:
        t, f = execute(name, b)
        measured[(name, b)] = t
        if name == best_name and b == b_pred:
            factor = f
        log(f"  potrf {name} b={b}: predicted "
            f"{profiles[name][b] * 1e3:.2f} ms, measured {t * 1e3:.2f} ms")
    at_b = {name: measured[(name, b_pred)] for name in CHOLESKY_TRACERS}
    winner = min(at_b, key=at_b.get)
    b_opt, yld = performance_yield(
        {b: measured[(best_name, b)] for b in BLOCK_SIZES}, b_pred)
    log(f"  measured winner at b={b_pred}: {winner} "
        f"(predicted {best_name}); {best_name} measured optimum b={b_opt}, "
        f"performance yield {yld:.4f} on b in {BLOCK_SIZES}")
    old_b_opt, old_yld = performance_yield(
        {b: measured[(old_name, b)] for b in OLD_BLOCK_SIZES}, old_b_pred)
    log(f"  on the old grid b in {OLD_BLOCK_SIZES} (the same "
        f"measurements): predicted {old_name} at b={old_b_pred}, measured "
        f"optimum b={old_b_opt}, performance yield {old_yld:.4f}")
    # the joint (variant, b) pick against the fastest measured row of the
    # grid: the yield above is the paper's, per variant
    joint = {}
    for label, grid, pick in (("grid", BLOCK_SIZES, (best_name, b_pred)),
                              ("old grid", OLD_BLOCK_SIZES,
                               (old_name, old_b_pred))):
        fastest = min((r for r in measured if r[1] in grid),
                      key=measured.get)
        joint[label] = {"fastest_measured": list(fastest),
                        "ratio": measured[fastest] / measured[pick]}
        log(f"  joint pick on the {label}: {pick[0]} b={pick[1]} measured "
            f"{measured[pick] * 1e3:.2f} ms; fastest measured row "
            f"{fastest[0]} b={fastest[1]} {measured[fastest] * 1e3:.2f} ms "
            f"(ratio {joint[label]['ratio']:.4f})")
    L = torch.tril(torch.from_numpy(factor).to(dev, torch.float64))
    rel = float(torch.linalg.norm(L - L64) / torch.linalg.norm(L64))
    log(f"  factor vs float64 cholesky: normwise rel err {rel:.3e} "
        f"(bound 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError(f"potrf factor error {rel} above 1e-4")
    return {"models": models, "n": N, "gen_s": gen_s,
            "predicted_best": best_name,
            "b_pred": b_pred, "measured_winner": winner, "b_opt": b_opt,
            "yield": yld, "grid": list(BLOCK_SIZES),
            "old_grid": {"grid": list(OLD_BLOCK_SIZES),
                         "predicted_best": old_name, "b_pred": old_b_pred,
                         "b_opt": old_b_opt, "yield": old_yld},
            "joint": joint,
            "rows": [{"variant": nm, "b": b,
                      "pred_ms": profiles[nm][b] * 1e3,
                      "meas_ms": measured[(nm, b)] * 1e3}
                     for nm, b in rows]}


# ------------------------------------------------------------ phase 4 --
def tune_tiles(dev) -> dict:
    """The port's tile path: sweep, fit the transfer models, select."""
    from repro_torch.perf.tile_tuner import (KERNEL, legal_candidates,
                                             rank_tiles, select_tiles)
    from repro_torch.tc import PredictorSession

    session = PredictorSession(repetitions=TILE_PASSES)
    ds = session.device_suite(device=dev)
    legal = legal_candidates(N, N, N, smem_limit=ds.smem_limit)
    t0 = time.perf_counter()
    ds.measure_grid(KERNEL, legal)
    h2d, d2h = ds.transfer_models()
    sweep_s = time.perf_counter() - t0
    log(f"  swept {len(legal)} legal tiles on their proxy problems in "
        f"{sweep_s:.2f} s; H2D {h2d.bytes_per_s / 1e9:.2f} GB/s + "
        f"{h2d.overhead_s * 1e6:.1f} us, D2H {d2h.bytes_per_s / 1e9:.2f} "
        f"GB/s + {d2h.overhead_s * 1e6:.1f} us (pageable)")
    choice = select_tiles(N, N, N, session=session,
                          smem_limit=ds.smem_limit)
    ranked = session.rank_device_tiles(KERNEL, (N, N, N), legal)
    analytic = rank_tiles(N, N, N, session=session, analytic=True,
                          smem_limit=ds.smem_limit)[0]
    return {"session": session, "kernel": KERNEL, "legal": legal,
            "ranked": ranked,
            "transfer": (h2d, d2h),
            "choice": (choice.bm, choice.bn, choice.bk),
            "t_compute": choice.t_compute,
            "analytic": (analytic.bm, analytic.bn, analytic.bk)}


def check_tiles(dev, tuned: dict) -> dict:
    """Run every legal tile at 4096^3 through :func:`check_family`, each
    held against the plain result for its bk within BIG_TOL x max |plain|
    (max abs error), and add where the analytic oracle's tile ranks."""
    import numpy as np
    import torch
    from repro_torch.kernels.matmul import matmul, matmul_plain

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((N, N)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal((N, N)).astype(
        np.float32)).to(dev)

    def run(cfg, plain=False):
        bm, bn, bk = cfg
        if plain:
            return matmul_plain(x, y, bm=N, bn=N, bk=bk)
        return matmul(x, y, bm=bm, bn=bn, bk=bk)

    def within(out, ref):
        return (float((out - ref).abs().max()),
                BIG_TOL * float(ref.abs().max()))

    res, meas, plains = check_family(
        "cuda_matmul", tuned, run, lambda cfg: cfg[2], "4096^3", within,
        f"max_abs_err <= {BIG_TOL} x max |plain|", chosen=tuned["choice"])
    analytic = tuned["analytic"]
    log(f"  analytic oracle picks {analytic} ({meas[analytic]:.2f} ms "
        f"measured)")
    (OUT / "tiles_4096.json").write_text(json.dumps(res["rows"], indent=1))
    res.update(x=x, y=y, plain=plains[res["choice"][2]], analytic=analytic)
    return res


def transfer_shares(models, h2d, d2h) -> dict:
    """Share of the H2D + D2H copies in each path kernel's modelled call
    time at the diagonal-block sizes (b x b tiles, gemm b x b x b)."""
    import numpy as np
    from repro_torch.dla.kernels import KERNELS

    shares = {}
    for kernel, model in sorted(models.models.items()):
        case = next(iter(model.cases))
        row = {}
        for b in BLOCK_SIZES:
            sizes = (b,) * len(model.cases[case].pieces[0].domain.lo)
            ops = KERNELS[kernel].make_operands(case, sizes,
                                                np.random.default_rng(0))
            t_copy = h2d.time(sum(o.nbytes for o in ops)) + \
                d2h.time(ops[-1].nbytes)
            t_call = model.estimate(case, sizes)["med"]
            row[b] = t_copy / t_call
        shares[kernel] = row
        log(f"  {kernel}: H2D+D2H share of the modelled call at b = " +
            ", ".join(f"{b}: {100 * v:.0f}%" for b, v in row.items()))
    return shares


# ------------------------------------------------------------ phase 6 --
def check_attention(card) -> dict:
    """Flash attention against its plain version: the reference tests'
    cases, then gemma2-27b's local and global layers at 8192 tokens in
    both dtypes, each timed beside its bound."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (attn_grid_steps,
                                                     flash_attention,
                                                     flash_attention_plain)
    from repro_torch.perf.roofline import peak_flops

    rng = np.random.default_rng(7)

    def operands(shapes, dtype):
        return [torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to("cuda", dtype) for sh in shapes]

    for hq, hkv, sl, d, kw in ATTN_CASES:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
            q, k, v = operands(((2, hq, sl, d), (2, hkv, sl, d),
                                (2, hkv, sl, d)), dtype)
            out = flash_attention(q, k, v, bq=32, bkv=32, **kw)
            torch.cuda.synchronize()       # a fault surfaces here
            ref = flash_attention_plain(q, k, v, bkv=32, **kw).float()
            diff = (out.float() - ref).abs()
            ratio = float((diff / (tol + tol * ref.abs())).max())
            log(f"  attention hq={hq} hkv={hkv} s={sl} d={d} {kw} "
                f"{str(dtype)[6:]}: max_abs_err {float(diff.max()):.3e}, "
                f"max |diff| / ({tol} + {tol} |plain|) {ratio:.3f} (bound 1)")
            if not ratio <= 1.0:
                raise AssertionError(f"flash_attention disagrees with its "
                                     f"plain version at {hq, hkv, sl, d, kw}"
                                     f" {dtype}")
    rows = []
    hq, hkv, d, cap = GEMMA["hq"], GEMMA["hkv"], GEMMA["d"], GEMMA["softcap"]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = operands(((1, hq, GEMMA_S, d), (1, hkv, GEMMA_S, d),
                            (1, hkv, GEMMA_S, d)), dtype)
        name = str(dtype)[6:]
        for window in GEMMA["windows"]:
            kw = dict(causal=True, window=window, softcap=cap)
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = flash_attention_plain(q, k, v, bkv=128, **kw)
            err = rel_err(out, ref)
            max_abs = float((out.float() - ref.float()).abs().max())
            layer = "local" if window else "global"
            if not err <= WIDE_TOL[name]:
                raise AssertionError(
                    f"flash_attention disagrees with its plain version on "
                    f"gemma2-27b's {layer} layer ({name}): normwise "
                    f"{err:.3e} above {WIDE_TOL[name]:.3e}")
            fault = None
            if dtype == torch.bfloat16:
                # the plain loop on the same values in float32 leaves p
                # unrounded; only the output is rounded to bfloat16
                fault = rel_err(flash_attention_plain(
                    q.float(), k.float(), v.float(), bkv=128,
                    **kw).to(dtype), ref)
                log(f"  gemma2-27b {layer} layer, bfloat16: a version that "
                    f"leaves p unrounded reads {fault:.3e} normwise (bound "
                    f"{WIDE_TOL[name]:.3e} must reject it)")
                if not fault > WIDE_TOL[name]:
                    raise AssertionError(
                        f"the bfloat16 bound {WIDE_TOL[name]:.3e} would "
                        f"pass a version that leaves p unrounded "
                        f"({fault:.3e})")
            del out, ref
            ms = event_ms(lambda: flash_attention(q, k, v, **kw), 3)
            plain_ms = event_ms(lambda: flash_attention_plain(
                q, k, v, bkv=128, **kw), 3)
            flops, nbytes = attn_work(1, hq, hkv, GEMMA_S, d, True, window,
                                      q.element_size())
            bd = bound(flops, nbytes, peak_flops(card, dtype), card)
            visits = attn_grid_steps(1, hq, GEMMA_S, GEMMA_S, 128, 128,
                                     causal=True, window=window)
            log(f"  gemma2-27b {layer} layer (window {window}), s={GEMMA_S},"
                f" {name}, blocks (128, 128), visits {visits} of "
                f"{hq * (GEMMA_S // 128) ** 2} kv blocks: normwise {err:.3e} "
                f"(bound {WIDE_TOL[name]:.3e}), max_abs_err {max_abs:.3e}; "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}, "
                f"{flops / 1e9:.1f} GFLOP at "
                f"{peak_flops(card, dtype) / 1e12:.0f} TFLOP/s)")
            rows.append({"layer": layer, "window": window, "dtype": name,
                         "s": GEMMA_S, "visited_blocks": visits,
                         "normwise": err, "max_abs_err": max_abs,
                         "unrounded_p_normwise": fault, "kernel_ms": ms,
                         "plain_ms": plain_ms, **bd})
        del q, k, v
    return {"gemma2_27b": rows}


def ssd_inputs(problem, rng, model_like: bool):
    """SSD operands on the card: the reference test's (dt = |N(0,1)| 0.1,
    a_log = N(0,1) 0.5) when ``model_like``, else the device family's
    (dt = 1e-3, a_log = 0); x, b, c standard normal."""
    import numpy as np
    import torch
    b, l, h, p, g, n = problem
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    if model_like:
        dt = (np.abs(rng.standard_normal((b, l, h))) * 0.1).astype(
            np.float32)
        a_log = (rng.standard_normal((h,)) * 0.5).astype(np.float32)
    else:
        dt = np.full((b, l, h), 1e-3, dtype=np.float32)
        a_log = np.zeros((h,), dtype=np.float32)
    bb = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return [torch.from_numpy(a).to("cuda") for a in (x, dt, a_log, bb, cc)]


def check_ssd(card) -> dict:
    """The SSD kernel against its plain version and the sequential oracle
    on the reference test's cases, then against its plain version at
    mamba2-2.7b's width, timed beside its bound."""
    import numpy as np
    import torch
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd import ssd, ssd_plain

    rng = np.random.default_rng(7)
    tol = 2e-4
    for l, h, p, g, n, chunk in SSD_CASES:
        ops = ssd_inputs((2, l, h, p, g, n), rng, model_like=True)
        out = ssd(*ops, chunk=chunk)
        torch.cuda.synchronize()           # a fault surfaces here
        for what, ref in (("plain", ssd_plain(*ops, chunk=chunk)),
                          ("ssd_ref", ssd_ref(*ops))):
            diff = (out - ref).abs()
            ratio = float((diff / (tol + tol * ref.abs())).max())
            log(f"  ssd l={l} h={h} p={p} g={g} n={n} chunk={chunk} vs "
                f"{what}: max_abs_err {float(diff.max()):.3e}, max |diff| / "
                f"({tol} + {tol} |{what}|) {ratio:.3f} (bound 1)")
            if not ratio <= 1.0:
                raise AssertionError(f"ssd disagrees with {what} at "
                                     f"{(l, h, p, g, n, chunk)}")
    ops = ssd_inputs(SSD_PROBLEM, rng, model_like=True)
    chunk = SSD_MODEL_CHUNK
    out = ssd(*ops, chunk=chunk)
    torch.cuda.synchronize()
    ref = ssd_plain(*ops, chunk=chunk)
    err, max_abs = rel_err(out, ref), float((out - ref).abs().max())
    if not err <= WIDE_TOL["float32"]:
        raise AssertionError(f"ssd disagrees with its plain version at "
                             f"mamba2-2.7b width: normwise {err:.3e}")
    # the state in and out that the models use: h0 as the initial carry,
    # h_final after the last chunk; without h0, y is the same bits
    b, _, h, p, _, n = SSD_PROBLEM
    h0 = torch.from_numpy((rng.standard_normal((b, h, p, n)) * 0.5).astype(
        np.float32)).to("cuda")
    y_s, h_fin = ssd(*ops, chunk=chunk, return_state=True)
    y_h, h_fin_h = ssd(*ops, chunk=chunk, h0=h0, return_state=True)
    torch.cuda.synchronize()
    same_bits = bool(torch.equal(y_s, out))
    _, ref_fin = ssd_plain(*ops, chunk=chunk, return_state=True)
    ref_y_h, ref_fin_h = ssd_plain(*ops, chunk=chunk, h0=h0,
                                   return_state=True)
    state_errs = {"h_final": rel_err(h_fin, ref_fin),
                  "y_from_h0": rel_err(y_h, ref_y_h),
                  "h_final_from_h0": rel_err(h_fin_h, ref_fin_h)}
    log(f"  mamba2-2.7b SSD state in and out vs plain, normwise: " +
        ", ".join(f"{k} {v:.3e}" for k, v in state_errs.items()) +
        f" (bound {WIDE_TOL['float32']:.0e}); y without h0 the same bits "
        f"with return_state: {same_bits}")
    if not same_bits or not max(state_errs.values()) <= WIDE_TOL["float32"]:
        raise AssertionError(f"ssd's state arguments disagree: bit-equal "
                             f"{same_bits}, {state_errs}")
    ms = event_ms(lambda: ssd(*ops, chunk=chunk), 3)
    plain_ms = event_ms(lambda: ssd_plain(*ops, chunk=chunk), 3)
    flops, nbytes = ssd_work(*SSD_PROBLEM, chunk)
    bd = bound(flops, nbytes, card.fp32_flops, card)
    log(f"  mamba2-2.7b SSD {SSD_PROBLEM}, chunk {chunk}, model-like dt and "
        f"a_log: normwise {err:.3e} (bound {WIDE_TOL['float32']:.0e}), "
        f"max_abs_err {max_abs:.3e} (max |plain| "
        f"{float(ref.abs().max()):.1f}); kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']}, {flops / 1e9:.1f} GFLOP)")
    return {"mamba2_2_7b": {"chunk": chunk, "normwise": err,
                            "state_normwise": state_errs,
                            "max_abs_err": max_abs, "kernel_ms": ms,
                            "plain_ms": plain_ms, **bd}}


# -------------------------------------------------------- phases 7, 8 --
def tune_family(session, kernel: str, problem, legal) -> dict:
    """A device family's path: sweep its legal configs on their proxies
    (deduplicated in the session's suite), then rank them for the
    problem."""
    ds = session.device_suite()
    t0 = time.perf_counter()
    ds.measure_grid(kernel, legal)
    sweep_s = time.perf_counter() - t0
    ranked = session.rank_device_tiles(kernel, problem, legal)
    log(f"  swept {len(legal)} legal configs of {kernel} on their proxy "
        f"problems in {sweep_s:.2f} s; selected {ranked[0].config} for "
        f"{problem} (predicted compute {ranked[0].t_compute * 1e3:.3f} ms)")
    return {"kernel": kernel, "legal": legal, "ranked": ranked,
            "sweep_s": sweep_s}


def normwise_within(out, ref):
    """The wide checks' reading and bound: normwise error against the
    float32 WIDE_TOL."""
    return rel_err(out, ref), WIDE_TOL["float32"]


def check_family(kernel: str, tuned: dict, run, plain_for, label: str,
                 within=normwise_within, rule: str = "normwise <= "
                 f"{WIDE_TOL['float32']:.0e}", chosen=None) -> dict:
    """Run every legal config at the full problem: hold each against the
    plain version (``within(out, plain)`` gives the reading and its
    bound), time it, and compare the measured order with the predicted
    one.  ``chosen`` is the path's selection (the top of the ranking by
    default).  Not part of the port's path: its launches are not
    counted.  Returns the summary, the measured ms per config and the
    plain results by ``plain_for`` key."""
    import torch
    legal, ranked = tuned["legal"], tuned["ranked"]
    meas, errs, reading = {}, {}, {}
    plains = {}
    for cfg in legal:
        key = plain_for(cfg)
        if key not in plains:
            plains[key] = run(cfg, plain=True)
        out = run(cfg)
        torch.cuda.synchronize()           # a fault surfaces here
        ref = plains[key]
        errs[cfg] = float((out.float() - ref.float()).abs().max())
        reading[cfg], limit = within(out, ref)
        if not reading[cfg] <= limit:
            raise AssertionError(
                f"{kernel} at {cfg} disagrees with its plain version at "
                f"{label}: {reading[cfg]:.3e} above {limit:.3e} ({rule})")
        del out
        meas[cfg] = event_ms(lambda: run(cfg), 3)
    worst = max(reading, key=reading.get)
    log(f"  all {len(legal)} configs agree with the plain version at "
        f"{label} ({rule}): worst reading {reading[worst]:.3e} at {worst}, "
        f"worst max_abs_err {max(errs.values()):.3e}")
    order = sorted(legal, key=lambda c: (meas[c], c))
    pos = {c: i for i, c in enumerate(order)}
    chosen = ranked[0].config if chosen is None else chosen
    pred = {r.config: r for r in ranked}
    log(f"  selected {chosen} (predicted compute "
        f"{pred[chosen].t_compute * 1e3:.3f} ms); measured "
        f"{meas[chosen]:.3f} ms, rank {pos[chosen] + 1} of {len(legal)}; "
        f"measured best {order[0]} {meas[order[0]]:.3f} ms")
    log("  predicted / measured ms, in predicted order (first 16): " +
        ", ".join(f"{r.config} {r.t_compute * 1e3:.3f}/{meas[r.config]:.3f}"
                  for r in ranked[:16]))
    tau = kendall_tau([r.config for r in ranked], meas)
    rows = [{"config": list(r.config), "pred_compute_ms": r.t_compute * 1e3,
             "pred_total_ms": r.t_total * 1e3, "meas_ms": meas[r.config],
             "max_abs_err": errs[r.config], "reading": reading[r.config]}
            for r in ranked]
    return {"choice": chosen, "meas_ms": meas[chosen], "err": errs[chosen],
            "worst_err": max(errs.values()), "best": order[0],
            "best_ms": meas[order[0]], "rank_of_choice": pos[chosen] + 1,
            "tau": tau, "n_legal": len(legal), "rows": rows}, meas, plains


def attention_legal(smem_limit: int) -> list:
    """The attention tile path's legal (bq, bkv, 128) blocks."""
    from repro_torch.kernels.flash_attention import attn_tile_legal
    d = ATTN_PROBLEM[4]
    return [(bq, bkv, d) for bq in ATTN_BLOCKS for bkv in ATTN_BLOCKS
            if attn_tile_legal(ATTN_PROBLEM[2], ATTN_PROBLEM[3], bq, bkv, d,
                               smem_limit)]


def ssd_legal(smem_limit: int) -> list:
    """The SSD chunk path's legal (chunk, 64, 128) configs."""
    from repro_torch.kernels.ssd import ssd_tile_legal
    _, l, _, p, _, n = SSD_PROBLEM
    return [(c, p, n) for c in SSD_CHUNKS
            if ssd_tile_legal(l, c, p, n, smem_limit)]


def tile_paths(smem_limit: int) -> list:
    """(kernel, problem, legal configs) of the three tile paths."""
    from repro_torch.perf.tile_tuner import KERNEL, legal_candidates
    return [(KERNEL, (N, N, N), legal_candidates(N, N, N,
                                                 smem_limit=smem_limit)),
            ("cuda_flash_attention", ATTN_PROBLEM,
             attention_legal(smem_limit)),
            ("cuda_ssd", SSD_PROBLEM, ssd_legal(smem_limit))]


def attention_path(session) -> dict:
    legal = attention_legal(session.device_suite().smem_limit)
    return tune_family(session, "cuda_flash_attention", ATTN_PROBLEM, legal)


def ssd_path(session) -> dict:
    legal = ssd_legal(session.device_suite().smem_limit)
    _, _, _, p, _, n = SSD_PROBLEM
    if (SSD_MODEL_CHUNK, p, n) not in legal:
        raise AssertionError(f"mamba2-2.7b's chunk {SSD_MODEL_CHUNK} is not "
                             f"legal for the SSD kernel: {legal}")
    return tune_family(session, "cuda_ssd", SSD_PROBLEM, legal)


def finish_attention(tuned: dict, card) -> dict:
    """Phase 7's checks and the attention row of the kernels line: every
    legal block at (1, 32, 4096, 4096, 128) causal float32, then the
    selected one beside its plain version and PyTorch's SDPA (TF32 off)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (attn_grid_steps,
                                                     flash_attention,
                                                     flash_attention_plain)
    b, h, sq, skv, d = ATTN_PROBLEM
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to("cuda") for sh in ((b, h, sq, d), (b, h, skv, d),
                                          (b, h, skv, d)))

    def run(cfg, plain=False):
        if plain:
            return flash_attention_plain(q, k, v, bkv=cfg[1])
        return flash_attention(q, k, v, bq=cfg[0], bkv=cfg[1])

    res = check_family("cuda_flash_attention", tuned, run,
                       lambda cfg: cfg[1], f"{ATTN_PROBLEM} causal f32")[0]
    bq, bkv, _ = res["choice"]
    kernel_ms = event_ms(lambda: flash_attention(q, k, v, bq=bq, bkv=bkv),
                         TIME_REPS)
    # the plain version's loop over the kv blocks the kernel visits
    skip_err = rel_err(flash_attention(q, k, v, bq=bq, bkv=bkv),
                       flash_attention_plain(q, k, v, bq=bq, bkv=bkv))
    if not skip_err <= WIDE_TOL["float32"]:
        raise AssertionError(f"flash_attention at ({bq}, {bkv}) disagrees "
                             f"with the plain loop over its visited blocks: "
                             f"normwise {skip_err:.3e}")
    plain_ms = event_ms(lambda: flash_attention_plain(q, k, v, bq=bq,
                                                      bkv=bkv), TIME_REPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = event_ms(lambda: sdpa(q, k, v, is_causal=True), TIME_REPS)
    lib_err = rel_err(sdpa(q, k, v, is_causal=True),
                      flash_attention_plain(q, k, v, bkv=bkv))
    flops, nbytes = attn_work(b, h, h, sq, d, True, 0, 4)
    bd = bound(flops, nbytes, card.fp32_flops, card)
    steps = attn_grid_steps(b, h, sq, skv, bq, bkv)
    grid = b * h * (sq // bq) * (skv // bkv)
    log(f"  attention {ATTN_PROBLEM} causal f32 at the selected "
        f"({bq}, {bkv}), visiting {steps} of {grid} kv blocks (normwise "
        f"{skip_err:.1e} from the plain loop over them): kernel_ms "
        f"{kernel_ms:.3f}, plain_ms {plain_ms:.3f}, "
        f"library_ms {library_ms:.3f} (SDPA, normwise {lib_err:.1e} from "
        f"the plain version), bound_ms {bd['bound_ms']:.3f} "
        f"({bd['bound_by']}); {flops / kernel_ms / 1e9:.1f} TFLOP/s on the "
        f"kept pairs")
    res.update(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               library_normwise=lib_err, visited_blocks=steps,
               skip_normwise=skip_err, **bd)
    return res


def finish_ssd(tuned: dict, card) -> dict:
    """Phase 8's checks and the SSD row of the kernels line: every legal
    chunk at mamba2-2.7b's (1, 4096, 80, 64, 1, 128) with the family's
    operands, then the selected one beside its plain version, each of its
    three passes timed, and the state scratch's bytes."""
    import numpy as np
    import torch
    from repro_torch.kernels.ssd import (_launch_chunk_scan,
                                         _launch_chunk_state,
                                         _launch_state_pass, ssd,
                                         ssd_grid_steps, ssd_plain,
                                         ssd_scan_blocks, ssd_scratch,
                                         ssd_scratch_bytes)
    ops = ssd_inputs(SSD_PROBLEM, np.random.default_rng(17),
                     model_like=False)

    def run(cfg, plain=False):
        return (ssd_plain if plain else ssd)(*ops, chunk=cfg[0])

    res = check_family("cuda_ssd", tuned, run, lambda cfg: cfg[0],
                       f"{SSD_PROBLEM}")[0]
    chunk = res["choice"][0]
    kernel_ms = event_ms(lambda: ssd(*ops, chunk=chunk), TIME_REPS)
    plain_ms = event_ms(lambda: ssd_plain(*ops, chunk=chunk), TIME_REPS)
    flops, nbytes = ssd_work(*SSD_PROBLEM, chunk)
    bd = bound(flops, nbytes, card.fp32_flops, card)
    x, dt, a_log, bb, cc = ops
    s, states = ssd_scratch(x, bb, chunk)
    y = torch.empty_like(x)
    passes = dict(zip(("chunk_state", "state_pass", "chunk_scan"), pass_ms(
        [lambda: _launch_chunk_state(x, dt, a_log, bb, s, states, chunk),
         lambda: _launch_state_pass(s, states, chunk),
         lambda: _launch_chunk_scan(x, dt, bb, cc, s, states, y, chunk)],
        TIME_REPS)))
    b, l, h, p, _, n = SSD_PROBLEM
    scratch = ssd_scratch_bytes(b, l, h, p, n, chunk)
    # pass 1 writes the scratch, pass 2 reads and writes it, pass 3 reads it
    scratch_ms = 4 * scratch / card.hbm_bytes_per_s * 1e3
    log(f"  ssd {SSD_PROBLEM} at the selected chunk {chunk}: kernel "
        f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, no library call, "
        f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}, "
        f"{flops / 1e9:.1f} GFLOP)")
    log(f"  ssd passes at chunk {chunk}, in sequence: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in passes.items()) +
        f" (sum {sum(passes.values()):.3f}); blocks of pass 1 "
        f"{ssd_grid_steps(b, l, h, chunk)}, of pass 3 "
        f"{ssd_scan_blocks(b, l, h, chunk)}; state scratch "
        f"{scratch / 1e6:.1f} MB, its four passes over HBM "
        f"{scratch_ms:.3f} ms at {card.hbm_bytes_per_s / 1e12:.2f} TB/s")
    res.update(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
               passes_ms=passes, scratch_bytes=scratch,
               scratch_hbm_ms=scratch_ms, **bd)
    return res


# ------------------------------------------------------- phases 9, 10 --
def rank_timings(rank) -> dict:
    """ms of the first and of a repeated ``rank(backend)`` on each
    backend, and whether the two backends' orders agree."""
    out, orders = {}, {}
    for backend in ("torch", "numpy"):
        t0 = time.perf_counter()
        rank(backend)
        first = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ranked = rank(backend)
        out[backend] = {"first_ms": first,
                        "repeat_ms": (time.perf_counter() - t0) * 1e3}
        orders[backend] = [r.name for r in ranked]
    out["orders_agree"] = orders["torch"] == orders["numpy"]
    return out


def execute_set(ranked, run) -> tuple:
    """Execute the top three, the predicted worst of those predicted
    under EXEC_UNDER_S, then the rest of those in predicted order until
    EXEC_BUDGET_S; returns ({name: measured s}, names cut by the
    budget)."""
    under = [r for r in ranked if r.runtime.med < EXEC_UNDER_S]
    must = list(ranked[:3])
    if under and under[-1] not in must:
        must.append(under[-1])
    rest = [r for r in under if r not in must]
    measured, cut = {}, []
    t0 = time.perf_counter()
    for r in must + rest:
        if r not in must and time.perf_counter() - t0 > EXEC_BUDGET_S:
            cut.append(r.name)
            continue
        measured[r.name] = run(r)
    return measured, cut


def score_case(label, ranked, measured, cut, suite_s, winner_err) -> dict:
    """Predicted against measured over the executed set: the winner, the
    performance yield, Kendall tau and the suite's cost fraction."""
    executed = [r for r in ranked if r.name in measured]
    pred_best = executed[0].name
    meas_best = min(measured, key=measured.get)
    yld = measured[meas_best] / measured[pred_best]
    for r in executed:
        log(f"    {r.name}: predicted {r.runtime.med * 1e3:.3f} ms, "
            f"measured {measured[r.name] * 1e3:.3f} ms")
    tau = kendall_tau([r.name for r in executed], measured)
    frac = suite_s / measured[meas_best]
    log(f"  {label}: executed {len(executed)} (cut by the "
        f"{EXEC_BUDGET_S:.0f} s budget: {len(cut)}); predicted best "
        f"{pred_best}, measured best {meas_best} "
        f"({'same' if pred_best == meas_best else 'DIFFERENT'}); "
        f"performance yield {yld:.4f}; suite cost fraction {frac:.3f} of "
        f"the measured winner (target < 0.25, not gated); winner vs "
        f"whole einsum normwise {winner_err:.3e} (bound "
        f"{CONTRACTION_TOL:.0e})")
    if not winner_err <= CONTRACTION_TOL:
        raise AssertionError(f"{label}: executed winner {meas_best} "
                             f"disagrees with the einsum: {winner_err}")
    return {"executed": [{"name": r.name,
                          "pred_ms": r.runtime.med * 1e3,
                          "meas_ms": measured[r.name] * 1e3,
                          **({"classes": list(r.benchmark.classes),
                              "n_iterations": r.n_iterations}
                             if hasattr(r, "benchmark") else
                             {"steps": [[s.name, list(s.benchmark.classes)]
                                        for s in r.steps]})}
                         for r in executed],
            "cut": cut, "predicted_best": pred_best,
            "measured_best": meas_best, "same_best": pred_best == meas_best,
            "yield": yld, "tau": tau, "suite_cost_fraction": frac,
            "winner_err": winner_err}


def suite_report(label, session, before, suite_s) -> dict:
    after = session.counters()
    d = {k: after[k] - before[k] for k in ("requests", "n_benchmarks",
                                           "measured")}
    classes = {}
    for key in list(session.suite.results)[before["n_benchmarks"]:]:
        classes[key.classes] = classes.get(key.classes, 0) + 1
    log(f"  {label}: {d['requests']} requests, {d['n_benchmarks']} "
        f"distinct micro-benchmarks, suite cost {suite_s:.2f} s; key "
        f"classes (A, B): " + ", ".join(
            f"{'/'.join(c)} {n}" for c, n in sorted(classes.items())))
    return {**d, "suite_s": suite_s,
            "classes": {"/".join(c): n for c, n in classes.items()}}


def contraction_case(session, dev, label, expr, sizes, source) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.contractions import (execute, execute_reference,
                                               measure_contraction)
    from repro_torch.tc import is_batched_kernel

    log(f"  [{label}] {expr} at {sizes} ({source}), float32")
    pred = session.contraction_predictor(expr, sizes)
    n_batched = sum(is_batched_kernel(a.kernel) for a in pred.algorithms)
    before = session.counters()
    t0 = time.perf_counter()
    pred.prepare()
    suite_s = time.perf_counter() - t0
    rep = suite_report(label, session, before, suite_s)
    timing = rank_timings(lambda b: pred.rank(
        backend=b, device=dev if b == "torch" else None))
    ranked = session.rank_contraction_algorithms(expr, sizes)
    same_oracle = [r.name for r in pred.rank_oracle(fresh=False)] == \
        [r.name for r in ranked]
    t0 = time.perf_counter()
    fresh = pred.rank_oracle(fresh=True)
    fresh_s = time.perf_counter() - t0
    fresh_tau = order_agreement([r.name for r in ranked],
                                {r.name: r.runtime.med for r in fresh})[2]
    log(f"  {label}: {len(pred.algorithms)} candidates ({n_batched} "
        f"batched); rank on torch {timing['torch']['first_ms']:.2f} ms "
        f"first / {timing['torch']['repeat_ms']:.2f} ms repeated, numpy "
        f"{timing['numpy']['first_ms']:.2f} / "
        f"{timing['numpy']['repeat_ms']:.2f} ms; orders agree "
        f"{timing['orders_agree']}; rank_oracle on the shared "
        f"measurements identical {same_oracle}; fresh rank_oracle "
        f"({fresh_s:.2f} s) winner {fresh[0].name} "
        f"({'same' if fresh[0].name == ranked[0].name else 'different'}), "
        f"tau against the ranking {fresh_tau:.3f}")
    rng = np.random.default_rng(17)
    spec = pred.spec
    A = torch.from_numpy(rng.standard_normal(
        [sizes[i] for i in spec.a_idx]).astype(np.float32)).to(dev)
    B = torch.from_numpy(rng.standard_normal(
        [sizes[i] for i in spec.b_idx]).astype(np.float32)).to(dev)
    measured, cut = execute_set(ranked, lambda r: measure_contraction(
        r.algorithm, A, B, sizes, repetitions=3, device=dev).med)
    best = min(measured, key=measured.get)
    alg = next(r.algorithm for r in ranked if r.name == best)
    err = rel_err(execute(alg, A, B, sizes, device=dev),
                  execute_reference(spec, A.double(), B.double(),
                                    device=dev))
    res = score_case(label, ranked, measured, cut, suite_s, err)
    return {"spec": expr, "sizes": sizes, "source": source,
            "n_candidates": len(pred.algorithms), "n_batched": n_batched,
            **rep, "rank": timing, "oracle_identical": same_oracle,
            "fresh_oracle_winner": fresh[0].name,
            "fresh_oracle_tau": fresh_tau, **res}


def chain_case(session, dev, label, expr, sizes, source) -> dict:
    import numpy as np
    import torch
    from repro_torch.tc import ChainSpec, execute_chain
    from repro_torch.tc.chains import execute_chain_reference

    log(f"  [{label}] {expr} at {sizes} ({source}), float32, memory "
        f"limit {CHAIN_LIMIT / 2 ** 30:.0f} GiB")
    chain = ChainSpec.parse(expr)
    pred = session.chain_predictor(expr, sizes,
                                   memory_limit_bytes=CHAIN_LIMIT)
    n_all = len(chain.paths())
    for p in pred.paths:
        if any({s.spec.a_idx, s.spec.b_idx} == {"ijb", "bkl"}
               for s in p.steps):
            raise AssertionError(f"path {p.name} through ijb,bkl survived "
                                 f"the memory limit")
    before = session.counters()
    t0 = time.perf_counter()
    pred.prepare()
    suite_s = time.perf_counter() - t0
    rep = suite_report(label, session, before, suite_s)
    steps = {id(pred.step_predictor(s)): pred.step_predictor(s)
             for p in pred.paths for s in p.steps}
    n_cands = sum(len(sp.algorithms) for sp in steps.values())
    timing = rank_timings(lambda b: pred.rank_paths(
        backend=b, device=dev if b == "torch" else None))
    ranked = session.rank_einsum_paths(expr, sizes,
                                       memory_limit_bytes=CHAIN_LIMIT)
    same_oracle = [r.name for r in pred.rank_paths_oracle(fresh=False)] \
        == [r.name for r in ranked]
    fresh = pred.rank_paths_oracle(fresh=True)
    log(f"  {label}: {len(pred.paths)} of {n_all} paths within the limit "
        f"(none through ijb,bkl), {len(steps)} distinct steps with "
        f"{n_cands} candidates; rank on torch "
        f"{timing['torch']['first_ms']:.2f} ms first / "
        f"{timing['torch']['repeat_ms']:.2f} ms repeated, numpy "
        f"{timing['numpy']['first_ms']:.2f} / "
        f"{timing['numpy']['repeat_ms']:.2f} ms; orders agree "
        f"{timing['orders_agree']}; rank_paths_oracle on the shared "
        f"measurements identical {same_oracle}; fresh oracle winner "
        f"{fresh[0].name} "
        f"({'same' if fresh[0].name == ranked[0].name else 'different'})")
    rng = np.random.default_rng(19)
    ops = [torch.from_numpy(rng.standard_normal(
        [sizes[i] for i in idx]).astype(np.float32)).to(dev)
        for idx in chain.operands]

    def run(r):
        execute_chain(chain, r, ops, sizes, device=dev)   # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            execute_chain(chain, r, ops, sizes, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1]

    measured, cut = execute_set(ranked, run)
    best = next(r for r in ranked
                if r.name == min(measured, key=measured.get))
    err = rel_err(execute_chain(chain, best, ops, sizes, device=dev),
                  execute_chain_reference(chain, [o.double() for o in ops],
                                          device=dev))
    res = score_case(label, ranked, measured, cut, suite_s, err)
    return {"spec": expr, "sizes": sizes, "source": source,
            "limit_bytes": CHAIN_LIMIT, "n_paths": len(pred.paths),
            "n_paths_all": n_all, "n_steps": len(steps),
            "n_candidates": n_cands, **rep,
            "rank": timing, "oracle_identical": same_oracle,
            "fresh_oracle_winner": fresh[0].name, **res}


def contraction_path(dev) -> dict:
    """Phase 9: the Ch. 6 predictor on the card through one torch-backend
    session, for the three cases."""
    from repro_torch.core.contractions import l2_cache_bytes
    from repro_torch.tc import PredictorSession

    session = PredictorSession(backend="torch", device=dev)
    log(f"  cache capacity for the warm/cold classes: the card's L2, "
        f"{l2_cache_bytes(dev) / 2 ** 20:.1f} MiB (read from the device)")
    out = {"l2_bytes": l2_cache_bytes(dev)}
    for label, expr, sizes, source in CONTRACTION_CASES:
        out[label] = contraction_case(session, dev, label, expr, sizes,
                                      source)
    out[CHAIN_CASE[0]] = chain_case(session, dev, *CHAIN_CASE)
    firsts = sorted(mb.first for mb in session.suite.results.values())
    log(f"  first-call overheads over {len(firsts)} keys: max "
        f"{firsts[-1] * 1e3:.3f} ms, median "
        f"{firsts[len(firsts) // 2] * 1e3:.4f} ms")
    out["first_call_s"] = {"max": firsts[-1],
                           "median": firsts[len(firsts) // 2]}
    out["session"] = session
    return out


def potrf_compiled():
    """The potrf (variant, b) grid at n = N, traced and compiled."""
    from repro_torch.core.predict import compile_calls
    from repro_torch.dla.tracers import CHOLESKY_TRACERS
    return compile_calls([tracer(N, b)
                          for tracer in CHOLESKY_TRACERS.values()
                          for b in BLOCK_SIZES])


def torch_engine_path(dev, models) -> dict:
    """Phase 10: phase 3's potrf model set over its compiled (variant, b)
    grid, on the torch engine on the card and on the numpy engine."""
    import numpy as np
    from repro_torch.core import PredictionEngine

    compiled = potrf_compiled()
    out = {"n_configs": compiled.n_configs, "n_calls": compiled.n_calls}
    results = {}
    for backend in ("torch", "numpy"):
        eng = PredictionEngine(models, backend=backend,
                               device=dev if backend == "torch" else None)
        t0 = time.perf_counter()
        results[backend] = eng.predict_compiled(compiled)
        first = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            eng.predict_compiled(compiled)
            times.append((time.perf_counter() - t0) * 1e3)
        out[backend] = {"first_ms": first,
                        "repeat_ms": sorted(times)[len(times) // 2]}
    t, n = results["torch"], results["numpy"]
    rel = float(np.max(np.abs(t - n) / np.maximum(np.abs(n), 1e-300)))
    out["max_rel_diff"] = rel
    log(f"  {compiled.n_configs} (variant, b) configs, {compiled.n_calls} "
        f"calls: torch engine {out['torch']['first_ms']:.2f} ms first / "
        f"{out['torch']['repeat_ms']:.3f} ms repeated, numpy "
        f"{out['numpy']['first_ms']:.2f} / {out['numpy']['repeat_ms']:.3f} "
        f"ms; max relative difference {rel:.3e} (bound {ENGINE_TOL:.0e})")
    if not rel <= ENGINE_TOL:
        raise AssertionError(f"torch engine disagrees with numpy: {rel}")
    out["predictions"] = {b: results[b].tolist() for b in results}
    return out


# ----------------------------------------------------------- phase 11 --
#: the name phase 3's potrf model set is stored under
POTRF_MODELS = "potrf_n4096"
#: the second process: it loads the two stores under the strict
#: fingerprint check and prints what :func:`warm_rankings` ranks as JSON.
#: It imports this script's helpers and the port, nothing else.
WARM_CHILD = ("import json, sys; sys.path[:0] = [sys.argv[1], "
              "sys.argv[1] + '/src']; import chip_smoke; "
              "from repro_torch import resolve_device; "
              "print(json.dumps(chip_smoke.warm_rankings("
              "resolve_device('cuda'), sys.argv[2], sys.argv[3])))")


def ranking_rows(ranked) -> list:
    """A contraction or chain ranking: [name, [min, med, max, mean, std]]
    per candidate, in ranked order."""
    return [[r.name, [r.runtime.min, r.runtime.med, r.runtime.max,
                      r.runtime.mean, r.runtime.std]] for r in ranked]


def tile_rows(ranked) -> list:
    """A device tile ranking, every field of every entry, in order."""
    return [[list(r.config), r.t_total, r.t_h2d, r.t_compute, r.t_d2h,
             r.per_step_s, r.source] for r in ranked]


def canonical(x):
    """``x`` as JSON reads it back: tuples become lists, floats stay
    exact (``repr`` round-trips), so == is bit-identity."""
    return json.loads(json.dumps(x))


def refuse_measurement(*args):
    raise AssertionError("a warm-started session swept a tile config or "
                         "probed the memcpy rates")


def contraction_rankings(session) -> dict:
    """Phase 9's three cases ranked through ``session``."""
    out = {label: ranking_rows(session.rank_contraction_algorithms(
        expr, sizes)) for label, expr, sizes, _ in CONTRACTION_CASES}
    label, expr, sizes, _ = CHAIN_CASE
    out[label] = ranking_rows(session.rank_einsum_paths(
        expr, sizes, memory_limit_bytes=CHAIN_LIMIT))
    return out


def potrf_grid(models, dev) -> dict:
    """``models``' predictions over the potrf (variant, b) grid on both
    engines."""
    from repro_torch.core import PredictionEngine
    compiled = potrf_compiled()
    return {b: PredictionEngine(models, backend=b,
                                device=dev if b == "torch" else None
                                ).predict_compiled(compiled).tolist()
            for b in ("torch", "numpy")}


def warm_rankings(dev, tile_path, contraction_path) -> dict:
    """Load the two stores under the strict fingerprint check, warm-start
    sessions from them and rank what phases 4 and 7-10 ranked: the three
    contraction cases on both backends, the three tile paths (no sweep,
    no memcpy probe: both refuse), and the stored potrf models' grid on
    both engines.  ``measured`` counts fresh micro-benchmarks per
    session."""
    from repro_torch.store import ModelStore
    from repro_torch.tc import PredictorSession

    t0 = time.perf_counter()
    tile_store = ModelStore.load(tile_path, device=dev)
    contraction_store = ModelStore.load(contraction_path, device=dev)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = {"contractions": {}, "measured": {}}
    for backend in ("torch", "numpy"):
        warm = PredictorSession(store=contraction_store, backend=backend,
                                device=dev)
        out["contractions"][backend] = contraction_rankings(warm)
        out["measured"][f"contractions_{backend}"] = \
            warm.counters()["measured"]
    tiles = PredictorSession(store=tile_store, device=dev)
    ds = tiles.device_suite(device=dev, sweep_fn=refuse_measurement,
                            transfer_measure_fn=refuse_measurement)
    out["tiles"] = {kernel: tile_rows(tiles.rank_device_tiles(
        kernel, problem, legal))
        for kernel, problem, legal in tile_paths(ds.smem_limit)}
    out["measured"]["tiles"] = tiles.counters()["measured"]
    out["potrf"] = potrf_grid(tile_store.model_set(POTRF_MODELS), dev)
    out["ms"] = {"load": load_ms,
                 "warm_rank": (time.perf_counter() - t0) * 1e3}
    return out


def compare_rankings(label: str, got: dict, want: dict) -> None:
    """Fail unless ``got`` holds ``want``'s rankings bit for bit and its
    sessions measured nothing."""
    for part in ("contractions", "tiles", "potrf"):
        if canonical(got[part]) != canonical(want[part]):
            raise AssertionError(f"{label}: the warm-started {part} "
                                 f"differ from the in-memory session's")
    if any(got["measured"].values()):
        raise AssertionError(f"{label}: a warm-started session measured "
                             f"{got['measured']}")


def expect_refusal(label: str, path, dev, **kw) -> str:
    from repro_torch.store import ModelStore, StoreMismatchError
    try:
        ModelStore.load(path, device=dev, **kw)
    except StoreMismatchError as exc:
        log(f"  refused, {label}: {str(exc)[:150]}...")
        return str(exc)
    raise AssertionError(f"a store with {label} was loaded")


def run_choices(dev, choices: dict) -> dict:
    """Launch each kernel once at the config the warm-started session
    chose, at its path's problem, and hold it against its plain version
    at the tolerance of phases 4, 7 and 8."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.matmul import matmul, matmul_plain
    from repro_torch.kernels.ssd import ssd, ssd_plain

    rng = np.random.default_rng(23)
    out = {}
    bm, bn, bk = choices["cuda_matmul"]
    x, y = (torch.from_numpy(rng.standard_normal((N, N)).astype(
        np.float32)).to(dev) for _ in range(2))
    got = matmul(x, y, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    ref = matmul_plain(x, y, bm=N, bn=N, bk=bk)
    err, limit = float((got - ref).abs().max()), \
        BIG_TOL * float(ref.abs().max())
    out["cuda_matmul"] = {"config": [bm, bn, bk], "max_abs_err": err,
                          "bound": limit}
    if not err <= limit:
        raise AssertionError(f"matmul at the stored choice {(bm, bn, bk)}: "
                             f"max_abs_err {err:.3e} above {limit:.3e}")
    del x, y, got, ref
    bq, bkv, _ = choices["cuda_flash_attention"]
    b, h, sq, skv, d = ATTN_PROBLEM
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(dev) for sh in ((b, h, sq, d), (b, h, skv, d),
                                        (b, h, skv, d)))
    got = flash_attention(q, k, v, bq=bq, bkv=bkv)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, bkv=bkv)
    out["cuda_flash_attention"] = {
        "config": [bq, bkv, d], "normwise": rel_err(got, ref),
        "max_abs_err": float((got - ref).abs().max()),
        "bound": WIDE_TOL["float32"]}
    del q, k, v, got, ref
    chunk = choices["cuda_ssd"][0]
    ops = ssd_inputs(SSD_PROBLEM, rng, model_like=False)
    got = ssd(*ops, chunk=chunk)
    torch.cuda.synchronize()
    ref = ssd_plain(*ops, chunk=chunk)
    out["cuda_ssd"] = {"config": list(choices["cuda_ssd"]),
                       "normwise": rel_err(got, ref),
                       "max_abs_err": float((got - ref).abs().max()),
                       "bound": WIDE_TOL["float32"]}
    for kernel in ("cuda_flash_attention", "cuda_ssd"):
        if not out[kernel]["normwise"] <= WIDE_TOL["float32"]:
            raise AssertionError(f"{kernel} at the stored choice disagrees "
                                 f"with its plain version: {out[kernel]}")
    for kernel, r in out.items():
        log(f"  {kernel} at the stored choice {tuple(r['config'])}: "
            + (f"normwise {r['normwise']:.3e}, " if "normwise" in r else "")
            + f"max_abs_err {r['max_abs_err']:.3e} (bound "
            + (f"{BIG_TOL} x max |plain| = {r['bound']:.3e}"
               if kernel == "cuda_matmul" else
               f"{r['bound']:.0e} normwise") + ")")
    return out


def store_path(dev, tile_session, contraction_session, paper_models,
               in_memory: dict, phase_choices: dict) -> dict:
    """Phase 11: save the tile and contraction sessions to two stores,
    warm-start from them in this process and in a second one, run the
    kernels at what the stores chose, check the refusals, probe for drift
    and score a tournament."""
    import numpy as np
    from repro_torch.store import (DEVICE_MODEL_SET, SCHEMA_VERSION,
                                   DriftProbe, Snapshot, current_fingerprint,
                                   frozen_workloads, run_tournament)
    from repro_torch.tc import PredictorSession

    fp = current_fingerprint(device=dev)
    log(f"  fingerprint: {fp.as_dict()}")
    paths = {"tiles": OUT / "store_tiles.json",
             "contractions": OUT / "store_contractions.json"}
    t0 = time.perf_counter()
    tile_store = tile_session.save_store()
    tile_store.add_model_set(POTRF_MODELS, paper_models)
    tile_store.save(paths["tiles"])
    contraction_store = contraction_session.save_store(
        paths["contractions"])
    save_ms = (time.perf_counter() - t0) * 1e3
    families = sorted(tile_store.device_model_set().models)
    if not {"cuda_matmul", "cuda_flash_attention", "cuda_ssd", "memcpy_h2d",
            "memcpy_d2h"} <= set(families):
        raise AssertionError(f"the tile store's {DEVICE_MODEL_SET} models "
                             f"lack a family: {families}")
    sizes = {k: p.stat().st_size for k, p in paths.items()}
    log(f"  saved in {save_ms:.1f} ms: tiles store {tile_store.n_keys} "
        f"keys, model sets {sorted(tile_store.model_sets)} "
        f"({sizes['tiles']} bytes); contractions store "
        f"{contraction_store.n_keys} keys, "
        f"{len(contraction_store.model_sets)} model sets "
        f"({sizes['contractions']} bytes); cache_bytes "
        f"{tile_store.suite_meta['cache_bytes']} / "
        f"{contraction_store.suite_meta['cache_bytes']}")

    inproc = warm_rankings(dev, paths["tiles"], paths["contractions"])
    compare_rankings("in this process", inproc, in_memory)
    log(f"  warm start in this process: load {inproc['ms']['load']:.1f} ms,"
        f" warm rank {inproc['ms']['warm_rank']:.1f} ms; fresh "
        f"micro-benchmarks {inproc['measured']}, no sweep, no memcpy "
        f"probe; rankings of the three contraction cases (torch and "
        f"numpy), the three tile paths and the potrf grid (both engines) "
        f"bit-identical to the in-memory sessions'")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", WARM_CHILD, str(ROOT), str(paths["tiles"]),
         str(paths["contractions"])], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"the second process failed: "
                             f"{child.stderr[-2000:]}")
    second = json.loads(child.stdout.strip().splitlines()[-1])
    compare_rankings("in a second process", second, in_memory)
    log(f"  warm start in a second process ({child_s:.1f} s in all; load "
        f"{second['ms']['load']:.1f} ms, warm rank "
        f"{second['ms']['warm_rank']:.1f} ms): strict fingerprint check "
        f"passed, fresh micro-benchmarks {second['measured']}, rankings "
        f"bit-identical")

    choices = {kernel: tuple(rows[0][0])
               for kernel, rows in inproc["tiles"].items()}
    if choices != phase_choices:
        raise AssertionError(f"the stores chose {choices}, phases 4, 7 and "
                             f"8 chose {phase_choices}")
    log(f"  the stores' choices equal phases 4, 7 and 8's: {choices}")
    runs = run_choices(dev, choices)

    payload = json.loads(paths["contractions"].read_text())
    fps = payload["fingerprint"]
    copies = {
        "device_kind changed": ({**payload, "fingerprint": {
            **fps, "device_kind": fps["device_kind"] + " (another card)"}},
            {}),
        "cache_bytes changed": ({**payload, "suite": {
            **payload["suite"],
            "cache_bytes": payload["suite"]["cache_bytes"] // 2}}, {}),
        "schema_version + 1, allow_mismatch=True": ({
            **payload, "schema_version": SCHEMA_VERSION + 1},
            {"allow_mismatch": True}),
        "the reference's fingerprint fields": ({**payload, "fingerprint": {
            "cpu": fps["cpu"], "cores": fps["cores"], "backend": "tpu",
            "device_kind": "TPU v5 lite",
            "libraries": f"numpy={np.__version__},jax=0.4.35",
            "dtype": fps["dtype"], "repro_version": fps["repro_version"]}},
            {}),
    }
    refusals = {}
    for i, (label, (copy, kw)) in enumerate(copies.items()):
        path = OUT / f"store_refused_{i}.json"
        path.write_text(json.dumps(copy))
        refusals[label] = expect_refusal(label, path, dev, **kw)

    drift_session = PredictorSession(store=paths["contractions"],
                                     device=dev)
    # what check_drift runs, kept so its summary and threshold are the
    # probe's own
    probe = DriftProbe(drift_session.suite)
    readings = probe.probe()
    drift = dict(probe.report(), threshold=probe.threshold,
                 readings=[{"equation": r.key.equation,
                            "a_shape": list(r.key.a_shape),
                            "b_shape": list(r.key.b_shape),
                            "classes": list(r.key.classes),
                            "stored_med": r.stored_med,
                            "probed_med": r.probed_med, "ratio": r.ratio}
                           for r in readings])
    for r in readings:
        log(f"    drift {r.key.equation} {r.key.a_shape}x{r.key.b_shape} "
            f"{'/'.join(r.key.classes)}: stored {r.stored_med * 1e6:.1f} "
            f"us, probed {r.probed_med * 1e6:.1f} us, ratio {r.ratio:.3f}")
    log(f"  drift against the phase-9 store, back to back: probed "
        f"{drift['probed']:.0f}, stale {drift['stale']:.0f} (threshold "
        f"{probe.threshold}, reported, not gated), max ratio "
        f"{drift['max_ratio']:.3f}, probe "
        f"{drift['probe_cost_seconds']:.2f} s")

    loads = frozen_workloads()
    snaps = []
    for name, reps in (("rep5", 5), ("rep1", 1)):
        sess = PredictorSession(repetitions=reps, device=dev)
        for load in loads:
            load.rank(sess)
        path = OUT / f"store_{name}.json"
        sess.save_store(path)
        snaps.append(Snapshot(name, path))
    tourney = run_tournament(snaps, loads,
                             oracle_session=PredictorSession(device=dev),
                             device=dev)
    tourney.save(OUT / "TOURNAMENT.json")
    for line in tourney.describe().splitlines():
        log(f"  {line}")
    log(f"  oracle cost {tourney.oracle_cost_seconds:.2f} s")
    fresh = next(s for s in tourney.scores if s.name == "rep5")
    if fresh.new_benchmarks != 0:
        raise AssertionError(f"the fresh snapshot needed "
                             f"{fresh.new_benchmarks} new benchmarks")
    return {"fingerprint": fp.as_dict(), "bytes": sizes,
            "keys": {"tiles": tile_store.n_keys,
                     "contractions": contraction_store.n_keys},
            "model_sets": {"tiles": sorted(tile_store.model_sets),
                           "contractions": sorted(
                               contraction_store.model_sets)},
            "save_ms": save_ms, "in_process": {
                "ms": inproc["ms"], "measured": inproc["measured"]},
            "second_process": {"ms": second["ms"],
                               "measured": second["measured"],
                               "seconds": child_s},
            "choices": {k: list(v) for k, v in choices.items()},
            "runs": runs, "refusals": refusals, "drift": drift,
            "tournament": tourney.to_payload()}


# ----------------------------------------------------------- phase 12 --
def model_inputs(cfg, batch: int, s: int, gen):
    """A prompt of ``s`` tokens per row, drawn on the card from ``gen``."""
    import torch
    return torch.randint(0, cfg.vocab, (batch, s), generator=gen,
                         device=gen.device)


def kernel_class(name: str) -> str:
    """The class of a device kernel by its name, for phase 12's breakdown."""
    low = name.lower()
    if "attn_bwd" in low:
        return "flash_attention_bwd"
    if "attn_kernel" in low:
        return "flash_attention"
    if "ssd_" in low:
        return "ssd"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                              "matmul")):
        return "library matmul"
    return "other"


def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time by kernel
    class and by name (the six longest), and the device's busy share of
    the call's wall time (kernels on one stream do not overlap, so their
    sum is the busy time).  Returns ``{"measured": False}`` when the trace
    holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name, n = {}, {}, 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = (evt.time_range.end - evt.time_range.start) / 1e3
        cls = kernel_class(evt.name)
        by_class[cls] = by_class.get(cls, 0.0) + dur
        by_name[evt.name[:80]] = by_name.get(evt.name[:80], 0.0) + dur
        n += 1
    busy = sum(by_class.values())
    if not busy:
        return {"measured": False, "wall_ms": wall_ms}
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return {"measured": True, "wall_ms": wall_ms, "device_events": n,
            "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "by_class_ms": by_class, "top_kernels_ms": top}


def log_profile(what: str, prof: dict) -> None:
    if not prof["measured"]:
        log(f"  {what} under torch.profiler: the trace holds no device "
            f"time; busy share and kernel time by name not measured")
        return
    log(f"  {what} under torch.profiler: wall {prof['wall_ms']:.1f} ms, "
        f"device busy {prof['busy_ms']:.1f} ms ({prof['device_events']} "
        f"device events), idle share {100 * prof['idle_share']:.1f} %; by "
        f"kernel class: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in sorted(
                prof["by_class_ms"].items(), key=lambda kv: -kv[1])))
    log(f"    longest kernels: " + "; ".join(
        f"{k} {v:.2f} ms" for k, v in prof["top_kernels_ms"].items()))


def drive_model(dev, card, arch, dtype_name, batch, s, seed) -> dict:
    """Phase 12a/b, one model: random parameters from a card generator at
    full width and depth, a prompt of ``s`` tokens prefilled three times
    (first, timed, profiled), then ``DECODE_STEPS`` greedy decode steps
    from the timed prefill's caches and one more under the profiler.  The
    kernel's time is its device time by name in the profiled prefill, its
    share that over the timed prefill's wall time."""
    import gc
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config(arch)
    dtype = getattr(torch, dtype_name)
    kernel = "flash_attention" if cfg.family != "ssm" else "ssd"
    wrapper = getattr(kernels, kernel)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dtype, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    toks = model_inputs(cfg, batch, s, gen)

    def run():
        return prefill(cfg, params, toks)

    t0 = time.perf_counter()
    logits, caches = run()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    del logits, caches
    calls = wrapper.launches
    t0 = time.perf_counter()
    logits, caches = run()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    calls = wrapper.launches - calls
    if not torch.isfinite(logits.float()).all() or \
            tuple(logits.shape) != (batch, 1, cfg.vocab):
        raise AssertionError(f"{arch} prefill logits {tuple(logits.shape)} "
                             f"are not finite (batch, 1, vocab)")
    token = logits.argmax(-1)
    step_ms = []
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        logits_d, caches = decode_step(cfg, params, caches, token, s + i)
        token = logits_d.argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(logits_d.float()).all():
        raise AssertionError(f"{arch} decode logits are not finite")
    decode_prof = profile_call(lambda: decode_step(
        cfg, params, caches, token, s + DECODE_STEPS))
    del logits, caches, logits_d
    peak = torch.cuda.max_memory_allocated(dev)
    prof = profile_call(run)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    decode_ms = sorted(step_ms)[len(step_ms) // 2]
    kernel_ms = prof["by_class_ms"].get(kernel, 0.0) if prof["measured"] \
        else None
    share = None if kernel_ms is None else kernel_ms / prefill_ms
    out = {"arch": arch, "dtype": dtype_name, "batch": batch, "prompt": s,
           "layers": cfg.n_layers, "params": n_params,
           "weight_bytes": weight_bytes, "init_s": init_s,
           "prefill_first_ms": first_ms, "prefill_ms": prefill_ms,
           "kernel": kernel, "kernel_calls": calls,
           "kernel_ms": kernel_ms, "kernel_share": share,
           "decode_steps_ms": step_ms, "decode_ms": decode_ms,
           "decode_tokens_per_s": batch * 1e3 / decode_ms,
           "decode_weight_bound_ms":
               weight_bytes / card.hbm_bytes_per_s * 1e3,
           "peak_bytes": peak, "profile": prof,
           "decode_profile": decode_prof}
    log(f"  {arch} {dtype_name}, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.2f} B parameters ({weight_bytes / 1e9:.1f} GB, "
        f"init {init_s:.1f} s), batch {batch} x {s} tokens: prefill "
        f"{prefill_ms:.1f} ms (first call {first_ms:.1f}); {kernel} kernel "
        f"in {calls} calls: " + (
            "device time not measured (the trace holds none)"
            if kernel_ms is None else
            f"{kernel_ms:.1f} ms of device time in the profiled prefill = "
            f"{100 * share:.1f} % of the timed one"))
    log(f"  {arch} decode: {DECODE_STEPS} greedy steps from the prefill's "
        f"caches, median {decode_ms:.2f} ms a step (min "
        f"{min(step_ms):.2f}, first {step_ms[0]:.2f}), "
        f"{batch * 1e3 / decode_ms:.1f} tokens/s; weights over HBM "
        f"{out['decode_weight_bound_ms']:.2f} ms a step; peak memory "
        f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
    log_profile(f"{arch} prefill", prof)
    log_profile(f"{arch} decode step {s + DECODE_STEPS}", decode_prof)
    return out


def models_path(dev, card) -> dict:
    """Phase 12a/b: gemma2-27b and mamba2-2.7b through the port's entry
    points (``init_params``, ``prefill``, ``decode_step``)."""
    import torch
    log(f"  memory held by earlier phases: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    return {arch: drive_model(dev, card, arch, dtype, batch, s, seed)
            for seed, (arch, dtype, batch, s) in enumerate(MODEL_RUNS)}


def caches_err(got: list, want: list) -> float:
    """The largest normwise error over the layers' prefill caches."""
    return max(rel_err(a, b) for g, w in zip(got, want)
               for a, b in (zip(g, w) if isinstance(g, tuple) else
                            ((g, w),)))


def check_models(dev) -> dict:
    """Phase 12c, at full width cut to ``CHECK_PERIODS`` periods: the
    kernel route against the plain route (``use_kernel=False``) on the
    same parameters and prompt as 12a/b, and prefill logits against a
    token-by-token decode replay of a ``REPLAY_LEN``-token prompt in
    float32.  Any miss raises."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_decode_state,
                                    init_params, prefill)
    res = {}
    for seed, (arch, dtype_name, batch, s) in enumerate(MODEL_RUNS):
        base = get_config(arch)
        cfg = dataclasses.replace(
            base, n_layers=CHECK_PERIODS * len(base.block_pattern))
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        params = init_params(cfg, gen, dtype, dev)
        toks = model_inputs(cfg, batch, s, gen)
        got, got_c = prefill(cfg, params, toks)
        want, want_c = prefill(cfg, params, toks, use_kernel=False)
        torch.cuda.synchronize()
        # every layer's cache (an attention layer's (k, v), an SSM layer's
        # state): past the first layer each depends on every query row of
        # the attention before it, not only the last token's
        errs = {"logits": rel_err(got, want),
                "caches": caches_err(got_c, want_c)}
        tol = ROUTE_TOL[dtype_name]
        log(f"  {arch} {dtype_name} at {cfg.n_layers} layers, batch {batch} "
            f"x {s}: kernel route vs plain route, normwise " +
            ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) +
            f" (bound {tol:.0e})")
        if not max(errs.values()) <= tol:
            raise AssertionError(f"{arch}: the kernel route disagrees with "
                                 f"the plain route: {errs}")
        witness = {}
        if dtype != torch.float32:
            # a float32 witness: the plain route in float32 on the same
            # parameters; if rounding alone parts the two bfloat16 routes,
            # each lies about as far from it as they lie from each other
            ref, ref_c = prefill(cfg, params.float(), toks,
                                 use_kernel=False)
            witness = {route: {"logits": rel_err(lg, ref),
                               "caches": caches_err(cs_, ref_c)}
                       for route, lg, cs_ in (("kernel", got, got_c),
                                              ("plain", want, want_c))}
            log(f"  {arch} float32 witness (plain route in float32, same "
                f"parameters and prompt), normwise: " + "; ".join(
                    f"{dtype_name} {route} route logits {w['logits']:.3e}, "
                    f"caches {w['caches']:.3e}"
                    for route, w in witness.items()) + " (not gated)")
            del ref, ref_c
        del params, got, got_c, want, want_c
        gc.collect()
        torch.cuda.empty_cache()
        # prefill against the token-by-token replay, in float32
        gen = torch.Generator(device=dev).manual_seed(200 + seed)
        params = init_params(cfg, gen, torch.float32, dev)
        toks = model_inputs(cfg, 1, REPLAY_LEN, gen)
        logits, _ = prefill(cfg, params, toks)
        caches = init_decode_state(cfg, 1, REPLAY_LEN, torch.float32, dev)
        for i in range(REPLAY_LEN):
            last, caches = decode_step(cfg, params, caches,
                                       toks[:, i:i + 1], i)
        diff = (logits.float() - last.float()).abs()
        ratio = float((diff / (REPLAY_TOL + REPLAY_TOL *
                               last.float().abs())).max())
        log(f"  {arch} float32 at {cfg.n_layers} layers: prefill of "
            f"{REPLAY_LEN} tokens vs decode replay, max_abs_err "
            f"{float(diff.max()):.3e}, max |diff| / ({REPLAY_TOL} + "
            f"{REPLAY_TOL} |replay|) {ratio:.3f} (bound 1)")
        if not ratio <= 1.0:
            raise AssertionError(f"{arch}: prefill disagrees with its decode "
                                 f"replay ({ratio:.3f})")
        res[arch] = {"layers": cfg.n_layers, "route_normwise": errs,
                     "route_tol": tol, "float32_witness": witness,
                     "replay_max_abs_err": float(diff.max()),
                     "replay_ratio": ratio}
        del params, caches, logits, last
        gc.collect()
        torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------- phase 13 --
def serve_trace(cfg, seed: int, n: int, lo: int, hi: int, new: int,
                gap_s: float) -> list:
    """An open-loop trace from ``seed``: ``n`` prompts of ``lo``..``hi``
    tokens (uniform), ``new`` tokens each, Poisson arrivals ``gap_s``
    apart on average, the first at 0 (as ``benchmarks/bench_serving.py``
    makes its trace)."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    gaps = rng.exponential(gap_s, n) if gap_s else np.zeros(n)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(lens[i])
                                               ).astype(np.int32),
                    max_new_tokens=new, arrival_s=float(arrivals[i]))
            for i in range(n)]


def instrument(engine) -> dict:
    """Record each blocking admission (its ms as ``stats.prefill_s`` bills
    it, its head H and tail, its head passes' own ms between two syncs)
    and each decode tick's ms, by wrapping the engine's hooks."""
    import torch
    rec = {"admissions": [], "ticks_ms": []}
    add, one_pass, advance = (engine.add_request, engine._admission_pass,
                              engine.advance)
    stats = engine.stats

    def pass_timed(tokens, slot, chunk):
        torch.cuda.synchronize(engine.device)
        t0 = time.perf_counter()
        one_pass(tokens, slot, chunk)
        torch.cuda.synchronize(engine.device)
        row = rec["admissions"][-1]
        row["head_ms"] += (time.perf_counter() - t0) * 1e3
        row["passes"].append([len(tokens), chunk])

    def add_timed(req):
        before = (stats.prefill_s, stats.tail_tokens)
        rec["admissions"].append({"uid": req.uid, "prompt": len(req.prompt),
                                  "head_ms": 0.0, "passes": []})
        if not add(req):
            rec["admissions"].pop()
            return False
        row = rec["admissions"][-1]
        row["tail"] = stats.tail_tokens - before[1]
        row["head"] = row["prompt"] - row["tail"]
        row["ms"] = (stats.prefill_s - before[0]) * 1e3
        return True

    def advance_timed():
        before = (stats.decode_steps, stats.decode_s)
        out = advance()
        if stats.decode_steps > before[0]:
            rec["ticks_ms"].append((stats.decode_s - before[1]) * 1e3)
        return out

    engine._admission_pass = pass_timed
    engine.add_request = add_timed
    engine.advance = advance_timed
    return rec


def serve_summary(stats, reqs, wall_s: float) -> dict:
    """A run's end-to-end figures from its stats."""
    tokens = sum(len(r.out_tokens) for r in reqs)
    return {"requests": len(reqs), "wall_s": wall_s, "tokens_out": tokens,
            "goodput_tok_s": tokens / wall_s,
            "decode_tokens_per_s": stats.tokens_per_s,
            "p50_ms": stats.latency_ms(50), "p99_ms": stats.latency_ms(99),
            "max_ms": 1e3 * max(stats.latencies_s),
            "ticks": stats.ticks, "decode_steps": stats.decode_steps,
            "tick_overhead_ms": stats.tick_overhead_ms,
            "prefill_s": stats.prefill_s, "decode_s": stats.decode_s,
            "kernel_admissions": stats.kernel_admissions,
            "tail_tokens": stats.tail_tokens}


def check_served(cfg, engine, reqs) -> None:
    """What a serving run gives out: every request done with its tokens,
    each a vocabulary index, and every cache finite."""
    import torch
    for r in reqs:
        if not (r.done and len(r.out_tokens) == r.max_new_tokens and
                all(0 <= t < cfg.vocab for t in r.out_tokens)):
            raise AssertionError(f"{cfg.name}: request {r.uid} came out "
                                 f"wrong: {r.out_tokens}")
    for c in engine.caches:
        for t in (c if isinstance(c, tuple) else (c,)):
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"{cfg.name}: a cache is not finite")


def admission_lengths(seed: int) -> list:
    """The admission sample's prompt lengths for ``seed``."""
    import numpy as np
    n, lo, hi = ADMIT_SAMPLE
    return [int(x) for x in np.random.default_rng(900 + seed).integers(
        lo, hi + 1, n)]


def log_admission(arch: str, row: dict) -> None:
    log(f"  {arch} admission of {row['prompt']} tokens = head "
        f"{row['head']} (passes {row['passes']}) + tail {row['tail']}: "
        f"{row['ms']:.1f} ms (head passes {row['head_ms']:.1f} ms)")


def serve_model(dev, arch, dtype_name, seed, keep=False) -> tuple:
    """Phase 13a/b, one model: ``SERVE_TRACE`` under FIFO through the
    port's ``ServeEngine``, every admission and decode tick timed; then
    the prompts of ``ADMIT_SAMPLE`` admitted one at a time, timed, and the
    head of the longest once more timed and once under ``torch.profiler``
    for the kernel's device time and share.  Returns (figures, the
    parameters when ``keep``)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import FifoScheduler, Request, ServeEngine
    from repro_torch.serve.engine import admission_head
    cfg = get_config(arch)
    dtype = getattr(torch, dtype_name)
    kernel = "flash_attention" if cfg.family != "ssm" else "ssd"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(400 + seed)
    params = init_params(cfg, gen, dtype, dev)
    engine = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS,
                         ctx_len=SERVE_CTX, dtype=dtype, device=dev)
    rec = instrument(engine)
    reqs = serve_trace(cfg, 500 + seed, *SERVE_TRACE)
    t0 = time.perf_counter()
    stats = engine.run(reqs, scheduler=FifoScheduler())
    wall = time.perf_counter() - t0
    check_served(cfg, engine, reqs)
    out = {"arch": arch, "dtype": dtype_name, "layers": cfg.n_layers,
           "slots": SERVE_SLOTS, "ctx": SERVE_CTX,
           "trace": dict(zip(("requests", "prompt_lo", "prompt_hi", "new",
                              "gap_s"), SERVE_TRACE)),
           **serve_summary(stats, reqs, wall)}
    ticks = sorted(rec["ticks_ms"])
    out["tick_ms_median"] = ticks[len(ticks) // 2]
    out["tick_ms_min"] = ticks[0]
    adm = out["admissions"] = list(rec["admissions"])
    ms = sorted(r["ms"] for r in adm)
    head_ms = sum(r["head_ms"] for r in adm)
    out["admission_ms_median"] = ms[len(ms) // 2]
    out["head_passes_ms"] = head_ms
    out["tail_ms"] = 1e3 * stats.prefill_s - head_ms
    log(f"  {arch} {dtype_name}, {cfg.n_layers} layers, {SERVE_SLOTS} "
        f"slots x {SERVE_CTX}: {len(reqs)} requests served in "
        f"{wall:.2f} s; {len(adm)} admissions ({out['kernel_admissions']} "
        f"through the kernels) took {stats.prefill_s:.2f} s, median "
        f"{out['admission_ms_median']:.1f} ms: head passes "
        f"{head_ms / 1e3:.2f} s, {out['tail_tokens']} tail tokens replayed "
        f"{out['tail_ms'] / 1e3:.2f} s; decode {stats.decode_s:.2f} s over "
        f"{stats.decode_steps} ticks, median {out['tick_ms_median']:.2f} ms "
        f"(min {ticks[0]:.2f}), {stats.tokens_per_s:.1f} tokens/s over "
        f"decode, goodput {out['goodput_tok_s']:.1f} tokens/s; latency "
        f"p50 {out['p50_ms']:.0f} ms, p99 {out['p99_ms']:.0f} ms (slowest "
        f"{out['max_ms']:.0f})")
    # the admission sample: long prompts, one at a time
    lens = admission_lengths(seed)
    rng = np.random.default_rng(910 + seed)
    sample = [Request(uid=-1 - i, prompt=rng.integers(0, cfg.vocab, n
                                                      ).astype(np.int32),
                      max_new_tokens=1) for i, n in enumerate(lens)]
    n_before = len(rec["admissions"])
    for req in sample:
        engine.add_request(req)
        engine.active.clear()
    out["admission_sample"] = rec["admissions"][n_before:]
    for row in out["admission_sample"]:
        log_admission(arch, row)
    # the longest prompt's head once more (no tail, so the trace holds
    # batched passes and no replay ticks): timed, then profiled
    longest = max(sample, key=lambda r: len(r.prompt))
    head = admission_head(cfg, len(longest.prompt))
    again = Request(uid=-9, prompt=longest.prompt[:head], max_new_tokens=1)
    n_before = len(rec["admissions"])
    engine.add_request(again)
    engine.active.clear()
    timed = rec["admissions"][n_before]
    prof = profile_call(lambda: engine.add_request(again))
    engine.active.clear()
    kernel_ms = prof["by_class_ms"].get(kernel, 0.0) \
        if prof["measured"] else None
    out["profiled_admission"] = {
        **timed, "kernel": kernel, "kernel_ms": kernel_ms,
        "kernel_share": None if kernel_ms is None else
        kernel_ms / timed["ms"], "profile": prof}
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"  {arch} peak memory {out['peak_bytes'] / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")
    log(f"  {arch} head of {timed['prompt']} tokens (passes "
        f"{timed['passes']}, tail {timed['tail']}): {timed['ms']:.1f} ms, "
        f"head passes {timed['head_ms']:.1f} ms; {kernel}: " + (
            "device time not measured (the trace holds none)"
            if kernel_ms is None else
            f"{kernel_ms:.1f} ms of device time in the profiled admission "
            f"= {100 * kernel_ms / timed['ms']:.1f} % of the timed one, "
            f"{100 * kernel_ms / timed['head_ms']:.1f} % of its head passes"))
    log_profile(f"{arch} admission", prof)
    del engine
    if not keep:
        del params
        params = None
    gc.collect()
    torch.cuda.empty_cache()
    return out, params


def step_cost(dev, cfg, measured_tick_ms: float) -> tuple:
    """Phase 13c: the step-cost model of ``cfg`` at ``SERVE_SLOTS`` slots,
    built through a session measuring on the card, beside the measured
    median decode tick."""
    from repro_torch.tc import PredictorSession
    from repro_torch.tc.suite import COLD, WARM
    session = PredictorSession(device=dev)
    model = session.step_cost_model(cfg, slots=SERVE_SLOTS)
    warm = model.tick_cost(SERVE_SLOTS, WARM) * 1e3
    cold = model.tick_cost(SERVE_SLOTS, COLD) * 1e3
    out = {"build_s": model.build_seconds, "n_benchmarks": model.n_benchmarks,
           "predicted_tick_ms": warm, "predicted_cold_tick_ms": cold,
           "measured_tick_ms": measured_tick_ms,
           "measured_over_predicted": measured_tick_ms / warm}
    log(f"  step-cost model of {cfg.name} at {SERVE_SLOTS} slots: built in "
        f"{model.build_seconds:.2f} s from {model.n_benchmarks} "
        f"micro-benchmarks; predicted tick {warm:.2f} ms (cold "
        f"{cold:.2f}) against the measured median {measured_tick_ms:.2f} "
        f"ms: measured / predicted {out['measured_over_predicted']:.2f}")
    return out, model


def fifo_vs_guided(dev, cfg, params, model, seed) -> dict:
    """Phase 13d: one identical ``GUIDED_TRACE`` under FIFO and under the
    model-guided scheduler on 13c's model, each on a fresh engine."""
    import gc
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd
    from repro_torch.serve import (FifoScheduler, ModelGuidedScheduler,
                                   ServeEngine)
    out = {"trace": dict(zip(("requests", "prompt_lo", "prompt_hi", "new",
                              "gap_s"), GUIDED_TRACE))}
    for name, sched in (("fifo", FifoScheduler()),
                        ("guided", ModelGuidedScheduler(model))):
        engine = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS,
                             ctx_len=SERVE_CTX, dtype=params.embed.dtype,
                             device=dev)
        reqs = serve_trace(cfg, 600 + seed, *GUIDED_TRACE)
        before = flash_attention.launches + ssd.launches
        t0 = time.perf_counter()
        stats = engine.run(reqs, scheduler=sched)
        wall = time.perf_counter() - t0
        check_served(cfg, engine, reqs)
        res = out[name] = {**serve_summary(stats, reqs, wall),
                           "kernel_launches":
                           flash_attention.launches + ssd.launches - before}
        log(f"  {cfg.name} {name}: {len(reqs)} requests in {wall:.2f} s, "
            f"p50 {res['p50_ms']:.0f} ms, p99 {res['p99_ms']:.0f} ms, "
            f"goodput {res['goodput_tok_s']:.1f} tokens/s, "
            f"{res['ticks']} ticks, tick_overhead_ms "
            f"{res['tick_overhead_ms']:.3f}, {res['kernel_admissions']} "
            f"kernel admissions, {res['kernel_launches']} kernel launches")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if out["guided"]["kernel_launches"]:
        raise AssertionError("the guided scheduler admits interleaved lanes "
                             "only, yet its run launched a kernel")
    return out


def serve_path(dev) -> dict:
    """Phase 13a-d: gemma2-27b and mamba2-2.7b served through the port's
    ``ServeEngine``; gemma2's step-cost model and the two policies."""
    import gc
    import torch
    from repro_torch.configs import get_config
    log(f"  memory held by earlier phases: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    res = {}
    (arch, dtype), other = SERVE_RUNS[0], SERVE_RUNS[1:]
    log(f"[13a] {arch} served")
    res[arch], params = serve_model(dev, arch, dtype, 0, keep=True)
    cfg = get_config(arch)
    log(f"[13c] step-cost model of {arch}")
    res["step_cost"], model = step_cost(dev, cfg,
                                        res[arch]["tick_ms_median"])
    log(f"[13d] {arch}: FIFO against guided")
    res["fifo_vs_guided"] = fifo_vs_guided(dev, cfg, params, model, 0)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for seed, (arch, dtype) in enumerate(other, 1):
        log(f"[13b] {arch} served")
        res[arch], _ = serve_model(dev, arch, dtype, seed)
    return res


def check_serve(dev) -> dict:
    """Phase 13 check, at full width cut to ``CHECK_PERIODS`` periods, in
    two cases: rings of ``SERVE_CHECK_CTX`` with ``SERVE_CHECK_PROMPTS``
    (the head's write rolls), and the timed path's shape (``SERVE_CTX``,
    a first prompt then the admission sample's longest).  In each, the
    second admission's caches against a replay through ``decode_step``
    driven by hand, as the reference's ``add_request`` loops (float32,
    normwise ``REPLAY_TOL``), and the kernel route against
    ``use_kernel=False`` on the same admissions in the model's dtype
    (``ROUTE_TOL``).  Then the same tokens from both routes on a FIFO trace
    in float32.  Any miss raises."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params
    from repro_torch.serve import FifoScheduler, Request, ServeEngine
    res = {}

    def admit_two(cfg, params, dtype, use_kernel, ctx, prompts):
        engine = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS,
                             ctx_len=ctx, dtype=dtype,
                             use_kernel=use_kernel, device=dev)
        engine.add_request(Request(uid=0, prompt=prompts[0]))
        live = [tuple(t.clone() for t in c) if isinstance(c, tuple)
                else c.clone() for c in engine.caches]
        engine.add_request(Request(uid=1, prompt=prompts[1]))
        return engine, live

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for seed, (arch, dtype_name) in enumerate(SERVE_RUNS):
        base = get_config(arch)
        cfg = dataclasses.replace(
            base, n_layers=CHECK_PERIODS * len(base.block_pattern))
        dtype, tol = getattr(torch, dtype_name), ROUTE_TOL[dtype_name]
        gen = torch.Generator(device=dev).manual_seed(700 + seed)
        cases = {"ring": (SERVE_CHECK_CTX, SERVE_CHECK_PROMPTS),
                 "timed": (SERVE_CTX, (SERVE_CHECK_PROMPTS[0],
                                       max(admission_lengths(seed))))}
        prompts = {case: [torch.randint(0, cfg.vocab, (n,), generator=gen,
                                        device=dev).cpu().numpy()
                          for n in lens]
                   for case, (_, lens) in cases.items()}
        res[arch] = {"layers": cfg.n_layers, "replay_tol": REPLAY_TOL,
                     "route_tol": tol}
        # each admission against the reference's replay, in float32
        params = init_params(cfg, gen, torch.float32, dev)
        for case, (ctx, lens) in cases.items():
            engine, caches = admit_two(cfg, params, torch.float32, True, ctx,
                                       prompts[case])
            heads = engine.stats.kernel_admissions
            token = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int64,
                                device=dev)
            for i, tok in enumerate(prompts[case][1]):
                token[1, 0] = int(tok)
                _, caches = decode_step(cfg, params, caches, token, i)
            res[arch][case] = {
                "ctx": ctx, "prompts": list(lens), "kernel_admissions": heads,
                "tail_tokens": engine.stats.tail_tokens,
                "replay_normwise": caches_err(engine.caches, caches)}
            del engine, caches
            free()
        # the same tokens from both routes on a FIFO trace
        tokens = {}
        for use_kernel in (True, False):
            engine = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS,
                                 ctx_len=SERVE_CHECK_CTX,
                                 dtype=torch.float32, use_kernel=use_kernel,
                                 device=dev)
            reqs = serve_trace(cfg, 800 + seed, *SERVE_CHECK_TRACE)
            engine.run(reqs, scheduler=FifoScheduler())
            tokens[use_kernel] = [r.out_tokens for r in reqs]
            del engine
        res[arch]["trace_tokens"] = tokens[True]
        del params
        free()
        # the kernel route against the plain route, in the model's dtype
        params = init_params(cfg, gen, dtype, dev)
        for case, (ctx, _) in cases.items():
            got, _ = admit_two(cfg, params, dtype, True, ctx, prompts[case])
            want, _ = admit_two(cfg, params, dtype, False, ctx,
                                prompts[case])
            res[arch][case]["route_normwise"] = caches_err(got.caches,
                                                           want.caches)
            del got, want
            free()
        del params
        free()
        for case, r in ((c, res[arch][c]) for c in cases):
            log(f"  {arch} at {cfg.n_layers} layers, {case}: rings of "
                f"{r['ctx']}, admissions of {r['prompts'][0]} then "
                f"{r['prompts'][1]} tokens ({r['kernel_admissions']} through "
                f"the kernels, {r['tail_tokens']} tail tokens): caches vs a "
                f"hand-driven decode replay (float32) normwise "
                f"{r['replay_normwise']:.3e} (bound {REPLAY_TOL}); kernel "
                f"route vs plain route ({dtype_name}) "
                f"{r['route_normwise']:.3e} (bound {tol:.0e})")
        log(f"  {arch}: FIFO trace of {SERVE_CHECK_TRACE[0]} requests "
            f"(float32): tokens of both routes "
            f"{'equal' if tokens[True] == tokens[False] else 'DIFFER'}")
        bad = [c for c in cases if res[arch][c]["kernel_admissions"] != 2 or
               not res[arch][c]["replay_normwise"] <= REPLAY_TOL or
               not res[arch][c]["route_normwise"] <= tol]
        if bad or tokens[True] != tokens[False]:
            raise AssertionError(f"{arch}: the serve check failed in "
                                 f"{bad or 'the trace'}: {res[arch]}, "
                                 f"tokens {tokens}")
    return res


# ----------------------------------------------------------- phase 14 --
#: phase 14's training run: gemma2-27b at full width cut to TRAIN_PERIODS
#: periods (one local, one global layer each), train_4k's sequence at batch
#: 1, bfloat16 parameters and gradients, float32 AdamW moments,
#: TRAIN_STEPS steps with per-period remat and chunked cross entropy
TRAIN_ARCH = "gemma2-27b"
TRAIN_PERIODS = 2
TRAIN_SEQ = 4096
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
#: 14b: one period at full width, batch 1 x GRAD_SEQ tokens; normwise bound
#: per gradient leaf, kernel route against plain route.  float32: the
#: kernels' sums in other orders (1e-5 a call, phase 6) through a layer's
#: forward and backward; bfloat16: both routes round every product and
#: activation, the kernels p at another place (ROUTE_TOL's reasoning)
GRAD_SEQ = 512
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: 14d: a small config trained on the card, saved at step RESUME_AT
RESUME_AT = 2
RESUME_STEPS = 4


def attn_bwd_work(b, hq, hkv, s, d, causal, window, itemsize):
    """(flops, bytes) the attention backward needs: five products of 2 d
    flops a kept pair (s, dP, dV, dK, dQ: 2.5 times attn_work's), q, k, v,
    o, dO and lse read once and dq, dk, dv written once."""
    flops = 2.5 * attn_work(b, hq, hkv, s, d, causal, window, itemsize)[0]
    nbytes = float(itemsize) * b * s * d * (4 * hq + 4 * hkv) + \
        4.0 * b * hq * s
    return flops, nbytes


def bwd_bound(flops, nbytes, dtype, card) -> dict:
    """The backward's bound on the route it takes: bfloat16 products at the
    tensor cores' bfloat16 rate; float32 ones as three TF32 products each
    at the TF32 rate, with the FFMA bound (the FP32 rate outside the
    tensor cores) beside it as ``bound_ms_ffma``."""
    import torch
    if dtype == torch.bfloat16:
        bd = bound(flops, nbytes, card.bf16_tensor_flops, card)
        bd["route"] = (f"{flops / 1e9:.1f} GFLOP at "
                       f"{card.bf16_tensor_flops / 1e12:.0f} TFLOP/s")
        return bd
    bd = bound(3 * flops, nbytes, card.tf32_tensor_flops, card)
    bd["bound_ms_ffma"] = bound(flops, nbytes, card.fp32_flops,
                                card)["bound_ms"]
    bd["route"] = (f"3xTF32 {3 * flops / 1e9:.1f} GFLOP at "
                   f"{card.tf32_tensor_flops / 1e12:.0f} TFLOP/s; FFMA bound "
                   f"{bd['bound_ms_ffma']:.3f}")
    return bd


def grads_err(got, want) -> dict:
    """Normwise error of each gradient, by the pair's index."""
    return {i: rel_err(g, w) for i, (g, w) in enumerate(zip(got, want))}


def start_sass(lib):
    """``cuobjdump -sass`` of a built library, started in the background
    (it takes seconds); read it with :func:`hmma_counts`."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.Popen([str(cuobjdump), "-sass", str(lib)],
                            stdout=subprocess.PIPE, text=True)


def hmma_counts(proc) -> dict:
    """Tensor-core instructions (HMMA) in each kernel of the library whose
    SASS ``proc`` (:func:`start_sass`) prints: {mangled name: count}."""
    import re
    sass, _ = proc.communicate(timeout=300)
    if proc.returncode:
        raise AssertionError(f"cuobjdump -sass exited {proc.returncode}")
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return counts


#: the backward's instantiations gemma2-27b's layers run: (warps of 16
#: rows, D) = (4, 128), block 64
BWD_MAIN_KEY = (4, 128)


def check_bwd_sass(proc) -> dict:
    """The SASS gate: the backward's dK/dV and dQ kernels at BWD_MAIN_KEY
    hold tensor-core instructions in both dtypes (``proc`` from
    :func:`start_sass` on the backward's library)."""
    counts = hmma_counts(proc)
    w, d = BWD_MAIN_KEY
    found = {}
    for kern in ("attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel"):
        for dtype, tag in (("float32", "If"), ("bfloat16", "I13__nv_bfloat16")):
            names = [n for n in counts
                     if kern in n and f"{tag}Li{w}ELi{d}E" in n]
            if len(names) != 1:
                raise AssertionError(f"no single SASS function for {kern} "
                                     f"{dtype} at {BWD_MAIN_KEY}: {names}")
            found[f"{kern}/{dtype}"] = counts[names[0]]
    if not all(found.values()):
        raise AssertionError(f"the backward's SASS at {BWD_MAIN_KEY} lacks "
                             f"tensor-core instructions: {found}")
    log(f"  backward SASS at (warps, D) = {BWD_MAIN_KEY}: HMMA per kernel "
        f"{found} (cuobjdump -sass)")
    return found


def check_attention_bwd(card) -> dict:
    """Phase 14a: the backward kernels against the plain backward on the
    same forward output and row statistics (the kernel forward's, whose
    lse is held against the plain forward's first): at every instantiated
    (block, D), two masks, both dtypes, on a small shape; at gemma2-27b's
    widths over train_4k's 4096 tokens (local and global layer, softcap
    50, both dtypes), each called twice and held to the same bits; then
    timed at ATTN_PROBLEM causal in float32 and bfloat16 beside its plain
    version, its bounds (float32: the 3xTF32 route it takes, and FFMA)
    and SDPA's backward; the forward's bfloat16 time there beside SDPA's;
    and the SASS gate (check_bwd_sass)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (
        BWD_BLOCKS, KERNEL_HEAD_DIMS, attn_bwd_blocks, flash_attention,
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain)
    from repro_torch.kernels import _build

    sass_proc = start_sass(_build.build("flash_attention_bwd"))
    rng = np.random.default_rng(19)

    def operands(b, hq, hkv, s, d, dtype):
        return [torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to("cuda", dtype)
            for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                       (b, hq, s, d))]

    def check(label, q, k, v, do, blk, kw):
        name = str(q.dtype)[6:]
        o, lse = flash_attention_fwd(q, k, v, bq=blk, bkv=blk, **kw)
        torch.cuda.synchronize()
        _, plain_lse = flash_attention_plain(q, k, v, bkv=blk, bq=blk,
                                             return_lse=True, **kw)
        lse_ratio = float(((lse - plain_lse).abs() /
                           (1e-5 + 1e-5 * plain_lse.abs())).max())
        got = flash_attention_bwd(q, k, v, o, lse, do, blk=blk, **kw)
        torch.cuda.synchronize()           # a fault surfaces here
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, bq=blk, **kw)
        errs = dict(zip(("dq", "dk", "dv"), grads_err(got, want).values()))
        max_abs = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
        if not (lse_ratio <= 1.0 and max(errs.values()) <= WIDE_TOL[name]):
            raise AssertionError(
                f"flash_attention_bwd disagrees with its plain version at "
                f"{label}: lse ratio {lse_ratio:.3f} (bound 1), normwise "
                f"{errs} (bound {WIDE_TOL[name]:.3e})")
        return errs, max_abs, lse_ratio

    small = []
    for blk in BWD_BLOCKS:
        for d in KERNEL_HEAD_DIMS:
            for dtype in (torch.float32, torch.bfloat16):
                for kw in (dict(causal=True, window=blk + blk // 2,
                                softcap=50.0),
                           dict(causal=False, window=0, softcap=0.0)):
                    ops = operands(2, 4, 2, 4 * blk, d, dtype)
                    errs, max_abs, lse_ratio = check(
                        f"block {blk}, d {d}", *ops, blk, kw)
                    small.append({"blk": blk, "d": d,
                                  "dtype": str(dtype)[6:], **kw,
                                  "normwise": errs, "max_abs_err": max_abs,
                                  "lse_ratio": lse_ratio})
    worst = max(small, key=lambda r: max(r["normwise"].values()))
    log(f"  backward kernels at all {len(small)} (block, d, dtype, mask) "
        f"cases of (2, 4, 2, 4 x block, d): within WIDE_TOL normwise "
        f"(float32 {WIDE_TOL['float32']:.0e}, bfloat16 "
        f"{WIDE_TOL['bfloat16']:.3e}) and lse within 1e-5 (1 + |plain|); "
        f"worst {max(worst['normwise'].values()):.3e} at block "
        f"{worst['blk']}, d {worst['d']}, {worst['dtype']}")

    wide = []
    hq, hkv, d, cap = GEMMA["hq"], GEMMA["hkv"], GEMMA["d"], GEMMA["softcap"]
    blk = attn_bwd_blocks(TRAIN_SEQ)
    for dtype in (torch.float32, torch.bfloat16):
        ops = operands(1, hq, hkv, TRAIN_SEQ, d, dtype)
        name = str(dtype)[6:]
        for window in GEMMA["windows"]:
            kw = dict(causal=True, window=window, softcap=cap)
            layer = "local" if window else "global"
            errs, max_abs, lse_ratio = check(
                f"gemma2-27b's {layer} layer ({name})", *ops, blk, kw)
            q, k, v, do = ops
            o, lse = flash_attention_fwd(q, k, v, **kw)
            first = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"two backward calls at gemma2-27b's "
                                     f"{layer} layer ({name}) differ")
            del first, again
            ms = event_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                      **kw), 3)
            flops, nbytes = attn_bwd_work(1, hq, hkv, TRAIN_SEQ, d, True,
                                          window, q.element_size())
            bd = bwd_bound(flops, nbytes, dtype, card)
            log(f"  gemma2-27b {layer} layer backward, s={TRAIN_SEQ}, {name}"
                f", block {blk}, two calls bit for bit: normwise dq "
                f"{errs['dq']:.3e}, dk "
                f"{errs['dk']:.3e}, dv {errs['dv']:.3e} (bound "
                f"{WIDE_TOL[name]:.3e}), lse ratio {lse_ratio:.3f}; kernel "
                f"{ms:.3f} ms (three launches), bound {bd['bound_ms']:.3f} ms"
                f" ({bd['bound_by']}, {bd['route']})")
            wide.append({"layer": layer, "window": window, "dtype": name,
                         "s": TRAIN_SEQ, "blk": blk, "deterministic": True,
                         "normwise": errs,
                         "max_abs_err": max_abs, "lse_ratio": lse_ratio,
                         "kernel_ms": ms, **bd})
            del o, lse
        del ops, q, k, v, do

    b, h, s, _, d = ATTN_PROBLEM
    blk = attn_bwd_blocks(s)
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q, k, v, do = operands(b, h, h, s, d, dtype)
        o, lse = flash_attention_fwd(q, k, v)
        errs, max_abs, _ = check(f"{ATTN_PROBLEM} causal {name}", q, k, v,
                                 do, blk, {})
        kernel_ms = event_ms(lambda: flash_attention_bwd(q, k, v, o, lse,
                                                         do), TIME_REPS)
        plain_ms = event_ms(lambda: flash_attention_bwd_plain(
            q, k, v, o, lse, do, bq=blk), 3)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True)
        library_ms = event_ms(lambda: torch.autograd.grad(
            sdpa_out, leaves, do, retain_graph=True), TIME_REPS)
        lib_err = max(grads_err(torch.autograd.grad(sdpa_out, leaves, do),
                                flash_attention_bwd_plain(q, k, v, o, lse,
                                                          do)).values())
        flops, nbytes = attn_bwd_work(b, h, h, s, d, True, 0,
                                      q.element_size())
        bd = bwd_bound(flops, nbytes, dtype, card)
        log(f"  attention backward {ATTN_PROBLEM} causal {name}, block "
            f"{blk}: normwise {max(errs.values()):.3e}; kernel_ms "
            f"{kernel_ms:.3f} (delta, dK/dV and dQ together), plain_ms "
            f"{plain_ms:.3f}, library_ms {library_ms:.3f} (the backward of "
            f"scaled_dot_product_attention, is_causal=True, TF32 off; "
            f"normwise {lib_err:.1e} from the plain backward), bound_ms "
            f"{bd['bound_ms']:.3f} ({bd['bound_by']}, {bd['route']}); "
            f"{flops / kernel_ms / 1e9:.1f} TFLOP/s on the kept pairs' five "
            f"products")
        timed[name] = {"err": max_abs, "normwise": errs,
                       "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "library_normwise": lib_err,
                       "blk": blk, **bd}
        if dtype == torch.bfloat16:
            fwd_ms = event_ms(lambda: flash_attention(q, k, v), TIME_REPS)
            sdpa_fwd_ms = event_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True), TIME_REPS)
            timed["forward_bfloat16"] = {"kernel_ms": fwd_ms,
                                         "library_ms": sdpa_fwd_ms,
                                         "blocks": [128, 128]}
            log(f"  attention forward {ATTN_PROBLEM} causal bfloat16, blocks"
                f" (128, 128): kernel_ms {fwd_ms:.3f}, library_ms "
                f"{sdpa_fwd_ms:.3f} (scaled_dot_product_attention, "
                f"is_causal=True)")
        del q, k, v, do, o, lse, leaves, sdpa_out
    sass = check_bwd_sass(sass_proc)
    return {"small": small, "gemma2_27b": wide, **timed["float32"],
            "bfloat16": timed["bfloat16"],
            "forward_bfloat16": timed["forward_bfloat16"],
            "sass_hmma": sass}


def check_train_grads(dev) -> dict:
    """Phase 14b: every parameter's gradient of ``loss_fn`` through the
    kernels (forward with lse and the backward kernels) against the plain
    route (``use_kernel=False``, autograd through the plain attention), at
    gemma2-27b's full width cut to one period, batch 1 x GRAD_SEQ tokens,
    in float32 and bfloat16.  Also shows what the kernel's bare launch
    gives a gradient: a tensor with no ``grad_fn`` (the path the wrapper
    took before the backward existed)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (_forward,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train.data import DataConfig, batch_at, to_device
    base = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(base, n_layers=len(base.block_pattern))
    res = {}
    for seed, dtype_name in enumerate(("float32", "bfloat16")):
        dtype = getattr(torch, dtype_name)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            300 + seed), dtype, dev)
        for p in params.parameters():
            p.requires_grad_(True)
        names = [n for n, _ in params.named_parameters()]
        leaves = list(params.parameters())
        batch = to_device(batch_at(DataConfig(
            vocab=cfg.vocab, seq_len=GRAD_SEQ, global_batch=1,
            seed=300 + seed), 0), dev)
        fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
        loss_k = loss_fn(cfg, params, batch["inputs"], batch["labels"])
        got = torch.autograd.grad(loss_k, leaves)
        torch.cuda.synchronize()
        fwd, bwd = flash_attention.launches - fwd, \
            flash_attention_bwd.launches - bwd
        loss_p = loss_fn(cfg, params, batch["inputs"], batch["labels"],
                         use_kernel=False)
        want = torch.autograd.grad(loss_p, leaves)
        errs = {names[i]: e for i, e in grads_err(got, want).items()}
        tol = GRAD_TOL[dtype_name]
        worst = max(errs, key=errs.get)
        log(f"  {TRAIN_ARCH} {dtype_name} at {cfg.n_layers} layers, batch 1 x"
            f" {GRAD_SEQ}: loss kernel route {float(loss_k.detach()):.6f}, "
            f"plain {float(loss_p.detach()):.6f}; {len(errs)} gradient "
            f"leaves, kernel route vs plain route normwise worst "
            f"{errs[worst]:.3e} ({worst}), "
            f"wq " + ", ".join(f"{errs[n]:.3e}" for n in names
                               if n.endswith("attn.wq")) +
            f" (bound {tol:.0e}); {fwd} forward and {bwd} backward attention"
            f" launches (remat runs each layer's forward twice)")
        if not (max(errs.values()) <= tol and bwd == cfg.n_layers and
                fwd == 2 * cfg.n_layers):
            raise AssertionError(f"{TRAIN_ARCH} {dtype_name}: the kernel "
                                 f"route's gradients disagree or the "
                                 f"kernels were not launched: {errs}, "
                                 f"{fwd} / {bwd} launches")
        res[dtype_name] = {"layers": cfg.n_layers, "tokens": GRAD_SEQ,
                           "loss_kernel": float(loss_k.detach()),
                           "loss_plain": float(loss_p.detach()), "tol": tol,
                           "normwise": errs, "forward_launches": fwd,
                           "backward_launches": bwd}
        del got, want, loss_k, loss_p
        if dtype == torch.float32:
            # the bare launch, as the wrapper ran before FlashAttentionFn:
            # its output records no gradient, so wq got none through it
            blk = params.blocks[0]
            x = params.embed[batch["inputs"]]
            q = (x @ blk.attn.wq).reshape(1, GRAD_SEQ, cfg.n_heads, -1) \
                .transpose(1, 2).contiguous()
            kv = (x @ blk.attn.wk).reshape(1, GRAD_SEQ, cfg.n_kv_heads, -1) \
                .transpose(1, 2).contiguous()
            # _forward without the Function: the launch into a fresh
            # torch.empty output that flash_attention made before
            bare, _ = _forward(q, kv, kv, 128, 128, True, 0, 50.0, False)
            res["bare_launch_requires_grad"] = bare.requires_grad
            log(f"  the kernel's bare launch on a q that requires grad "
                f"(q.requires_grad={q.requires_grad}) returns "
                f"requires_grad={bare.requires_grad}, grad_fn="
                f"{bare.grad_fn}: before the backward existed, wq, wk, wv "
                f"and the layers before them got no attention gradient")
            if bare.requires_grad:
                raise AssertionError("the bare launch recorded a gradient")
            del x, q, kv, bare
        del params, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return res


def train_flops(cfg, tokens: int) -> float:
    """The products of one training step with per-period remat and
    chunked cross entropy: each layer's projections and the head run
    forward twice (remat, the cross entropy's checkpoint) and backward
    once (two products each): 8 tokens (layer weights + vocab x d)."""
    d, hd = cfg.d_model, cfg.head_dim_
    per_layer = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) + \
        3 * d * cfg.d_ff
    return 8.0 * tokens * (cfg.n_layers * per_layer + cfg.vocab * d)


def profile_train_step(fn) -> dict:
    """One train step under ``torch.profiler``: device time by class,
    with AdamW's kernels told apart by time (the step reads the loss on
    the host before the update, so every kernel that starts after the
    update's ``record_function`` range opens is the optimizer's), and the
    device's idle share of the step's wall time.  The range's own event on
    the device timeline (a span over the optimizer's kernels, not a
    kernel) is left out of the sums."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    marks = [e.time_range.start for e in events if e.name == "adamw"]
    t_opt = min(marks) if marks else None
    by_class, spans = {}, 0
    for evt in events:
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.name == "adamw":
            spans += 1
            continue
        cls = kernel_class(evt.name)
        if t_opt is not None and evt.time_range.start >= t_opt:
            cls = "adamw"
        dur = (evt.time_range.end - evt.time_range.start) / 1e3
        by_class[cls] = by_class.get(cls, 0.0) + dur
    busy = sum(by_class.values())
    if not busy:
        return {"measured": False, "wall_ms": wall_ms}
    return {"measured": True, "wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "by_class_ms": by_class,
            "shares": {k: v / wall_ms for k, v in by_class.items()},
            "optimizer_marked": t_opt is not None,
            "device_spans_left_out": spans}


def train_path(dev, card) -> dict:
    """Phase 14c: gemma2-27b at full width, TRAIN_PERIODS periods, trained
    for TRAIN_STEPS AdamW steps on train_4k's sequence at batch 1 through
    the port's ``train`` (random bfloat16 parameters from a seeded card
    generator, float32 moments, per-period remat, chunked cross entropy),
    then one more step under the profiler."""
    import dataclasses
    import gc
    import math
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.data import DataConfig, batch_at, to_device
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_loop import TrainConfig, train

    class MarkedAdamW(AdamW):
        """AdamW whose update opens a ``record_function`` range, so the
        profile can tell the optimizer's kernels apart."""
        __slots__ = ()

        def update(self, *args, **kwargs):
            with torch.profiler.record_function("adamw"):
                return super().update(*args, **kwargs)

    base = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(
        base, n_layers=TRAIN_PERIODS * len(base.block_pattern))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=1, seed=0)
    log(f"  memory held by earlier phases: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    opt = MarkedAdamW(lr=TRAIN_LR)
    t0 = time.perf_counter()
    params, opt_state, report = train(
        cfg, data_cfg, TrainConfig(steps=TRAIN_STEPS), opt=opt,
        dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in params.parameters())
    losses = report.losses
    ln_v = math.log(cfg.vocab)
    if len(losses) != TRAIN_STEPS or report.skipped_nan_steps or \
            not all(math.isfinite(x) for x in losses) or \
            not abs(losses[0] - ln_v) <= 2.0:
        raise AssertionError(f"{TRAIN_ARCH} training went wrong: losses "
                             f"{losses}, skipped {report.skipped_nan_steps}"
                             f" (the first should be near ln V = "
                             f"{ln_v:.3f})")
    steps_ms = [t * 1e3 for t in report.step_times]
    later = steps_ms[1:]
    step_ms = statistics.median(later)
    flops = train_flops(cfg, TRAIN_SEQ)
    step_fn = make_train_step(cfg, opt)
    batch = to_device(batch_at(data_cfg, TRAIN_STEPS), dev)
    prof = profile_train_step(lambda: step_fn(params, opt_state, batch))
    del params, opt_state, batch
    gc.collect()
    torch.cuda.empty_cache()
    res = {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "params": n_params,
           "tokens": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses,
           "steps_ms": steps_ms, "step_ms_median": step_ms,
           "step_ms_min": min(later), "first_step_ms": steps_ms[0],
           "tokens_per_s": TRAIN_SEQ * 1e3 / step_ms, "peak_bytes": peak,
           "wall_s": wall_s, "products_tflop": flops / 1e12,
           "stragglers": report.straggler_steps, "profile": prof}
    log(f"  {TRAIN_ARCH} at full width, {cfg.n_layers} layers "
        f"({n_params / 1e9:.2f} B parameters, bfloat16; AdamW float32), "
        f"batch 1 x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps in {wall_s:.1f}"
        f" s: losses " + ", ".join(f"{x:.4f}" for x in losses) +
        f" (ln V = {ln_v:.4f})")
    log(f"  step ms after the first: median {step_ms:.1f}, min "
        f"{min(later):.1f} (first {steps_ms[0]:.1f}); "
        f"{res['tokens_per_s']:.0f} tokens/s; products "
        f"{flops / 1e12:.1f} TFLOP a step; peak memory {peak / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")
    if prof["measured"]:
        log(f"  one profiled step: wall {prof['wall_ms']:.1f} ms, device busy"
            f" {prof['busy_ms']:.1f} ms, idle share "
            f"{100 * prof['idle_share']:.1f} %; by class: " + ", ".join(
                f"{k} {v:.1f} ms ({100 * prof['shares'][k]:.1f} %)"
                for k, v in sorted(prof["by_class_ms"].items(),
                                   key=lambda kv: -kv[1])) +
            ("" if prof["optimizer_marked"] else
             " (the optimizer's range was not found: adamw not split out)") +
            f"; {prof['device_spans_left_out']} device-side span of the "
            f"range left out")
        mm = prof["by_class_ms"].get("library matmul")
        if mm:
            log(f"  bf16 products {flops / mm / 1e9:.0f} TFLOP/s over their "
                f"device time")
    else:
        log("  the profiled step's trace holds no device time: shares not "
            "measured")
    return res


def check_resume(dev) -> dict:
    """Phase 14d: a small config trained on the card, saved asynchronously
    after step RESUME_AT and restored in a fresh ``train``: the resumed
    steps' losses must equal an uninterrupted run's bit for bit."""
    import shutil
    from repro_torch.configs import get_config, reduced
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.data import DataConfig
    from repro_torch.train.train_loop import TrainConfig, train
    cfg = reduced(get_config(TRAIN_ARCH), n_layers=2, d_model=128, d_ff=256,
                  vocab=512)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=5)
    _, _, whole = train(cfg, dc, TrainConfig(steps=RESUME_STEPS), device=dev)
    ckpt = OUT / "resume_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        _, _, first = train(cfg, dc, TrainConfig(
            steps=RESUME_AT, ckpt_dir=str(ckpt), ckpt_every=RESUME_AT),
            device=dev)
        saved = ck.latest_step(str(ckpt))
        _, _, rest = train(cfg, dc, TrainConfig(steps=RESUME_STEPS,
                                                ckpt_dir=str(ckpt)),
                           device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    ok = (saved == RESUME_AT - 1 and rest.resumed_from == RESUME_AT - 1 and
          first.losses == whole.losses[:RESUME_AT] and
          rest.losses == whole.losses[RESUME_AT:])
    log(f"  {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, head "
        f"dim {cfg.head_dim_}), batch 2 x 64 on the card: saved "
        f"asynchronously after step {RESUME_AT}, resumed from step index "
        f"{rest.resumed_from}; resumed losses " +
        ", ".join(repr(x) for x in rest.losses) + " vs uninterrupted " +
        ", ".join(repr(x) for x in whole.losses[RESUME_AT:]) +
        f": {'equal bit for bit' if ok else 'DIFFER'}")
    if not ok:
        raise AssertionError(f"resume: saved {saved}, resumed from "
                             f"{rest.resumed_from}, losses {first.losses} + "
                             f"{rest.losses} against {whole.losses}")
    return {"arch": cfg.name, "losses": whole.losses,
            "resumed_losses": rest.losses, "saved_step": saved}


# ---------------------------------------------------------------- main --


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.matmul import matmul, matmul_plain
    from repro_torch.kernels.ssd import ssd
    from repro_torch.perf.roofline import card_of

    OUT.mkdir(parents=True, exist_ok=True)
    dev = resolve_device("cuda")
    line = card_line()
    log(f"[1] card: {line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.build_all(["matmul", "flash_attention",
                             "flash_attention_bwd", "ssd"])
    log(f"    kernel build (four nvcc at once) "
        f"{time.perf_counter() - t0:.1f} s -> " +
        ", ".join(str(p.relative_to(ROOT)) for p in libs.values()))
    ptxas = {}
    for name, lib in libs.items():
        text = lib.with_suffix(".log").read_text()
        (OUT / f"ptxas_{name}.log").write_text(text)
        ptxas.update(ptxas_table(text))
        rows = [v for k, v in ptxas_table(text).items()]
        if not rows:
            raise AssertionError(f"no ptxas report for {name}")
        log(f"    ptxas {name}: {len(rows)} instantiations, registers "
            f"{min(r[0] for r in rows)}-{max(r[0] for r in rows)}, "
            f"{sum(1 for r in rows if r[1])} spill")
    the_card = card_of(dev)
    phase_s = {}

    def phase(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[label] = time.perf_counter() - t
        log(f"    phase {label} took {phase_s[label]:.1f} s")
        return out

    log("[2] kernel check (CUDA matmul vs its plain version)")
    phase("2", check_kernel_shapes)

    # the main path: each of its paths runs with every kernel's count set
    # to 0 just before it and read just after
    wrappers = {"matmul": matmul, "flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd, "ssd": ssd}
    launches = {name: {} for name in wrappers}

    def counted(path, label, fn, *args):
        for w in wrappers.values():
            w.launches = 0
        out = phase(label, fn, *args)
        for name, w in wrappers.items():
            launches[name][path] = w.launches
        return out

    log(f"[3] paper path: potrf at n={N}, b in {BLOCK_SIZES}")
    paper = counted("paper", "3", paper_path, dev)
    log("[4] tile path: CUDA matmul tiles for 4096^3")
    tuned = counted("tiles", "4", tune_tiles, dev)
    paper_models = paper.pop("models")
    paper["copy_share"] = transfer_shares(paper_models, *tuned["transfer"])
    tiles = phase("4 check", check_tiles, dev, tuned)

    bm, bn, bk = tiles["choice"]
    x, y = tiles.pop("x"), tiles.pop("y")
    err = tiles["err"]
    log(f"[5] 4096^3 float32 at the selected {tiles['choice']}: max_abs_err "
        f"{err:.3e}, max |plain| {float(tiles.pop('plain').abs().max()):.1f}"
        f" (bound {BIG_TOL} x max |plain|)")
    kernel_ms = event_ms(lambda: matmul(x, y, bm=bm, bn=bn, bk=bk),
                         TIME_REPS)
    plain_ms = event_ms(lambda: matmul_plain(x, y, bm=bm, bn=bn, bk=bk),
                        TIME_REPS)
    library_ms = event_ms(lambda: torch.matmul(x, y), TIME_REPS)
    mm_bound = bound(2.0 * N ** 3, 4.0 * 3 * N * N, the_card.fp32_flops,
                     the_card)
    del x, y
    log(f"    matmul 4096^3 f32: kernel_ms {kernel_ms:.3f}, plain_ms "
        f"{plain_ms:.3f}, library_ms {library_ms:.3f} (torch.matmul), "
        f"bound_ms {mm_bound['bound_ms']:.3f} ({mm_bound['bound_by']}); "
        f"{2.0 * N ** 3 / kernel_ms / 1e9:.1f} TFLOP/s")

    log("[6] kernel check (CUDA flash attention and SSD vs their plain "
        "versions)")
    wide = phase("6 attention", check_attention, the_card)
    wide.update(phase("6 ssd", check_ssd, the_card))

    session = tuned["session"]
    log(f"[7] attention tile path: (bq, bkv, 128) blocks for "
        f"{ATTN_PROBLEM} (gemma2-27b query heads, train_4k)")
    attn_tuned = counted("attn_tiles", "7", attention_path, session)
    attn = phase("7 check", finish_attention, attn_tuned, the_card)
    log(f"[8] SSD chunk path: (chunk, 64, 128) configs for {SSD_PROBLEM} "
        f"(mamba2-2.7b, 4096 tokens)")
    ssd_tuned = counted("ssd_chunks", "8", ssd_path, session)
    ssd_res = phase("8 check", finish_ssd, ssd_tuned, the_card)
    session.device_suite().to_model_set().save(
        str(OUT / "device_models.json"))
    log("[9] contraction path (Ch. 6): one torch-backend session, three "
        "cases")
    contraction = counted("contractions", "9", contraction_path, dev)
    log(f"[10] torch prediction engine on the paper path: potrf n={N}, "
        f"(variant, b) grid")
    engine = counted("torch_engine", "10", torch_engine_path, dev,
                     paper_models)

    log("[11] store path: save the tile and contraction sessions, warm "
        "start in this process and in a second one, run the stored "
        "choices, refusals, drift, tournament")
    from repro_torch.tc import PredictorSession
    contraction_session = contraction.pop("session")
    in_memory = {
        "contractions": {
            "torch": contraction_rankings(contraction_session),
            "numpy": contraction_rankings(PredictorSession(
                suite=contraction_session.suite,
                cache=contraction_session.cache))},
        "tiles": {t["kernel"]: tile_rows(t["ranked"])
                  for t in (tuned, attn_tuned, ssd_tuned)},
        "potrf": engine.pop("predictions")}
    phase_choices = {"cuda_matmul": tuple(tiles["choice"]),
                     "cuda_flash_attention": tuple(attn["choice"]),
                     "cuda_ssd": tuple(ssd_res["choice"])}
    store = counted("store", "11", store_path, dev, session,
                    contraction_session, paper_models, in_memory,
                    phase_choices)

    runs = ", ".join(f"{a} ({d}, {b} x {n} tokens)"
                     for a, d, b, n in MODEL_RUNS)
    log(f"[12] models path: {runs}, prefill and {DECODE_STEPS} greedy "
        f"decode steps through the port's entry points, then the checks at "
        f"{CHECK_PERIODS} periods")
    model_runs = counted("models", "12", models_path, dev, the_card)
    model_checks = phase("12 check", check_models, dev)

    log(f"[13] serve path: {', '.join(a for a, _ in SERVE_RUNS)} served "
        f"through the port's ServeEngine ({SERVE_SLOTS} slots x "
        f"{SERVE_CTX}), the step-cost model, FIFO against guided, then the "
        f"checks at {CHECK_PERIODS} periods")
    serving = counted("serve", "13", serve_path, dev)
    serve_checks = phase("13 check", check_serve, dev)

    log(f"[14] train path: the attention backward kernels, {TRAIN_ARCH}'s "
        f"gradients at full width, {TRAIN_STEPS} AdamW steps at full width "
        f"({TRAIN_PERIODS} periods, 1 x {TRAIN_SEQ} tokens, bfloat16), "
        f"resume")
    log("[14a] attention backward kernels vs their plain version")
    attn_bwd = phase("14a", check_attention_bwd, the_card)
    log(f"[14b] {TRAIN_ARCH} gradients at full width: kernel route vs plain "
        f"route")
    train_grads = phase("14b", check_train_grads, dev)
    log(f"[14c] {TRAIN_ARCH} trained at full width through train()")
    training = counted("train", "14c", train_path, dev, the_card)
    log("[14d] resume after an asynchronous checkpoint, on the card")
    resume = phase("14d", check_resume, dev)

    regs = {}
    for name, keys in selected_ptxas_keys(
            (bm, bn, bk), attn["choice"], ssd_res["choice"]).items():
        regs[name] = {}
        for what, key in keys:
            if key not in ptxas:
                raise AssertionError(f"no ptxas report for {name}'s "
                                     f"selected instantiation {key}")
            r = regs[name][what] = dict(zip(
                ("registers", "spill_store_bytes", "spill_load_bytes"),
                ptxas[key]))
            log(f"  {name} at its selected config: {key[0]}<{key[2]}> uses "
                f"{r['registers']} registers, spills "
                f"{r['spill_store_bytes']} B stored / "
                f"{r['spill_load_bytes']} B loaded (ptxas)")
    log(f"  launches on the main path, per kernel and path: {launches}")
    for name, path in (("matmul", "tiles"), ("flash_attention", "attn_tiles"),
                       ("ssd", "ssd_chunks"), ("matmul", "store"),
                       ("flash_attention", "store"), ("ssd", "store"),
                       ("flash_attention", "models"), ("ssd", "models"),
                       ("flash_attention", "serve"), ("ssd", "serve"),
                       ("flash_attention", "train"),
                       ("flash_attention_bwd", "train")):
        if launches[name][path] <= 0:
            raise AssertionError(f"the main path never launched {name} on "
                                 f"its path {path}: {launches[name]}")

    def entry(name, source, replaces, res, registers, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches[name].values()),
                "launches_by_path": launches[name],
                "max_abs_err": res["err"], "ms": res["kernel_ms"],
                "kernel_ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                "library_ms": res["library_ms"], **registers, **extra}

    csrc = "src/repro_torch/kernels/csrc"

    def in_prefill(kernel):
        run = next(r for r in model_runs.values() if r["kernel"] == kernel)
        return {"models_prefill": {k: run[k] for k in (
            "arch", "dtype", "batch", "prompt", "prefill_ms", "kernel_ms",
            "kernel_calls", "kernel_share")}}
    def in_admission(kernel):
        run = next(r for r in serving.values()
                   if r.get("profiled_admission", {}).get("kernel") == kernel)
        adm = run["profiled_admission"]
        return {"serve_admission": {
            "arch": run["arch"], "dtype": run["dtype"],
            "slots": run["slots"], "prompt": adm["prompt"],
            "head": adm["head"], "admission_ms": adm["ms"],
            "head_ms": adm["head_ms"], "kernel_ms": adm["kernel_ms"],
            "kernel_share": adm["kernel_share"]}}
    bwd_regs = {}
    for what, key in (
            ("dkdv", ("attn_bwd_dkdv_kernel", "float32", BWD_MAIN_KEY)),
            ("dq", ("attn_bwd_dq_kernel", "float32", BWD_MAIN_KEY)),
            ("dkdv_bf16", ("attn_bwd_dkdv_kernel", "bfloat16",
                           BWD_MAIN_KEY)),
            ("dq_bf16", ("attn_bwd_dq_kernel", "bfloat16", BWD_MAIN_KEY)),
            ("delta", ("attn_bwd_delta_kernel", "float32", ()))):
        if key not in ptxas:
            raise AssertionError(f"no ptxas report for the backward's {key}")
        bwd_regs[what] = dict(zip(("registers", "spill_store_bytes",
                                   "spill_load_bytes"), ptxas[key]))
        log(f"  flash_attention_bwd at block 64, d 128: {key[0]} "
            f"({key[1]}) uses {bwd_regs[what]['registers']} registers, "
            f"spills {bwd_regs[what]['spill_store_bytes']} B stored / "
            f"{bwd_regs[what]['spill_load_bytes']} B loaded (ptxas)")

    def in_train_step(kernel):
        prof = training["profile"]
        if not prof["measured"]:
            return {"train_step": {"measured": False}}
        ms = prof["by_class_ms"].get(kernel, 0.0)
        return {"train_step": {
            "arch": training["arch"], "layers": training["layers"],
            "tokens": training["tokens"], "dtype": "bfloat16",
            "step_wall_ms": prof["wall_ms"], "kernel_ms": ms,
            "kernel_share": ms / prof["wall_ms"]}}
    kernels = {"kernels": [
        entry("matmul", f"{csrc}/matmul.cu",
              "src/repro/kernels/matmul.py:27 (_matmul_kernel)",
              {"err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, **mm_bound}, regs["matmul"]["matmul"],
              library="torch.matmul", shape=[N, N, N], dtype="float32",
              config=[bm, bn, bk]),
        entry("flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:37 (_attn_kernel)",
              attn, regs["flash_attention"]["attention"],
              library="torch.nn.functional.scaled_dot_product_attention"
              " (is_causal=True, float32, TF32 off)",
              shape=list(ATTN_PROBLEM), dtype="float32",
              config=list(attn["choice"]),
              bfloat16=attn_bwd["forward_bfloat16"],
              **in_prefill("flash_attention"),
              **in_admission("flash_attention"),
              **in_train_step("flash_attention")),
        entry("flash_attention_bwd", f"{csrc}/flash_attention_bwd.cu",
              "none: no Pallas body. The backward of "
              "src/repro/kernels/flash_attention.py:37 (_attn_kernel), which "
              "the reference differentiates in XLA through "
              "src/repro/models/attention.py:24 (chunked_attention)",
              attn_bwd, bwd_regs["dkdv"],
              library="the backward of torch.nn.functional."
              "scaled_dot_product_attention (is_causal=True, float32, TF32 "
              "off)", shape=list(ATTN_PROBLEM), dtype="float32",
              route_detail="mma.sync: float32 as 3xTF32, bfloat16 with dS "
              "as hi + lo", bound_ms_ffma=attn_bwd["bound_ms_ffma"],
              bfloat16=attn_bwd["bfloat16"], sass_hmma=attn_bwd["sass_hmma"],
              config=[attn_bwd["blk"], attn_bwd["blk"], ATTN_PROBLEM[4]],
              passes_registers=bwd_regs, **in_train_step(
                  "flash_attention_bwd")),
        entry("ssd", f"{csrc}/ssd.cu",
              "src/repro/kernels/ssd.py:30 (_ssd_kernel)", ssd_res,
              regs["ssd"]["chunk_scan"], library="none",
              shape=list(SSD_PROBLEM), dtype="float32",
              config=list(ssd_res["choice"]),
              passes_ms=ssd_res["passes_ms"], passes_registers=regs["ssd"],
              **in_prefill("ssd"), **in_admission("ssd")),
    ]}
    tuned.pop("session")
    for t in (attn_tuned, ssd_tuned):
        t["ranked"] = [r.__dict__ for r in t["ranked"]]
    (OUT / "result.json").write_text(json.dumps(
        {"paper": paper, "tiles": tiles, "wide_checks": wide,
         "attn_tiles": {**attn_tuned, **attn}, "ssd_chunks":
         {**ssd_tuned, **ssd_res}, "contractions": contraction,
         "torch_engine": engine, "store": store,
         "models": {"runs": model_runs, "checks": model_checks},
         "serve": {"runs": serving, "checks": serve_checks},
         "train": {"attention_bwd": attn_bwd, "grads": train_grads,
                   "run": training, "resume": resume},
         "phase_s": phase_s,
         **kernels},
        indent=1, default=str))
    log(f"  phase host times (s): "
        + ", ".join(f"{k}: {v:.1f}" for k, v in phase_s.items()))
    print(json.dumps(kernels))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
