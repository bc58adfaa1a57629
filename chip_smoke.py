#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` (one nvcc per source, all at once, into
``build/repro_torch_kernels/``), holds each against its plain PyTorch
version, and drives every path of the port on the card:

1. card and kernel build (each source's nvcc seconds; registers and
   spills of every instantiation, the matmul's ten wgmma kernels each,
   the SSD forward's six wgmma kernels each, AdamW's eleven entry
   functions each, the mixer's 21 and the norm's 17, none of them
   spilling);
2. kernel check: the CUDA matmul's route table (the library's against
   ``matmul_route``, with its staging and split scratch), then the matmul
   against its plain version on the test shapes and on a shape for each
   of its (bm, bn, bk) instantiations that the card can stage, on both
   routes (wgmma, ffma) and in both dtypes, each call on its route; a
   test shape whose tiles the kernel does not take must be refused; then
   AdamW's kernels: the update kernel against its plain version on the
   card bit for bit (m, v, u, and p when it writes p) over three
   (parameter, gradient) dtype pairs, weight decay on and off, no clip
   and the clip active, 1, 7 and 2^20 + 3 elements, a view one element
   into its buffers and gemma2-27b's embedding, ``AdamW.update_apply``
   against ``update`` and ``apply_updates`` (and the plain route), the
   norm kernel within 1e-6 of a float64 sum and the same bits twice, and
   both timed at the embedding beside their byte bounds, their plain
   versions and one PyTorch call each; then the Mamba mixer's four kernels
   (phase "2 mamba"); then the block RMSNorm's forward and backward
   kernels (phase "2 rmsnorm") against their plain versions at d_model
   2560, 4096, 4608 and 8192 and an unaligned 2550, at 4096, 1 and 4095
   rows, in bfloat16 and float32 (y and dx within 4e-3 / 1e-5 normwise,
   rstd and scale's gradient within 1e-5, the latter also of a float64
   sum, the same bits twice), timed at 4096 rows (and bfloat16 at one
   row) beside their plain versions, ``torch.nn.functional.rms_norm``
   and their byte bounds; every norm of the models, serve and train paths takes the
   kernel route (on 17a the local one), and every train path's launches
   of the two are exact (a block norm twice forward a step under remat,
   the final norm once, each backward once);
3. the paper's path at n = 4096, b from 64 to 1024: generate
   potf2/trsm/syrk/gemm models on the card over the domains the Cholesky
   tracers call, rank the three potrf variants and the block size without
   executing them, then execute them through ``ExecEngine`` and compare
   predicted with measured times; the performance yield is read on the
   whole grid and, on the same measurements, on the grid through 512;
4. the matmul tile path: sweep every legal float32 tile of the CUDA
   matmul, the union of its two routes' tiles, on its proxy problem (each
   route's measurements a model of their own), fit the transfer models
   and select the tile for 4096^3; then run every legal tile at 4096^3,
   check each result against the plain version and compare predicted with
   measured order: the selected tile's route, its rank against the
   measured best, tau;
5. the matmul at 4096^3 in float32 at the selected tile and in bfloat16
   at the fastest of its wgmma tiles (a short sweep), each twice for the
   same bits, beside its plain version, ``torch.matmul`` and its route's
   bound; the matmul's SASS gate (HGMMA in every wgmma kernel, no
   tensor-core instruction in any ffma kernel);
6. kernel check: flash attention and the SSD scan against their plain
   versions on the reference tests' cases, then at gemma2-27b's attention
   width (local and global layers, float32 and bfloat16), at the head dims
   the wrapper zero-pads to 128 (hubert-xlarge's 80, non-causal, and
   phi3-mini-3.8b's 96, causal, at 4096 tokens, both dtypes and both
   masks, each architecture's own mask timed beside SDPA at the same head
   dim and the bound at the true one) and at mamba2-2.7b's SSD width, each
   timed beside its bound; the SSD forward also on small cases at the
   models' (P, N) on each route (the call's route read from its launch
   count) and at jamba-v0.1-52b's width, its route table against
   ``ssd_route``, and its SASS gate (HGMMA in the wgmma route's chunk-state,
   C B^T and chunk-scan kernels, HMMA in the mma.sync route's);
7. the attention tile path: sweep the legal (bq, bkv, 128) blocks on their
   proxies and rank them for gemma2-27b's query heads at 4096 tokens; then
   run every legal block there, check and time it, and compare orders;
8. the SSD chunk path: the same for the (chunk, 64, 128) configs over both
   routes (chunk 32 on mma.sync, 64 to 256 on wgmma; each route's
   measurements a model of their own) and mamba2-2.7b's 80 heads at 4096
   tokens, the pick's route and the fastest on each route, then the three
   passes (chunk state, state pass, chunk scan) timed one by one on their
   route at the selected chunk and at the model's 256;
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
   device's busy share; each prefill's model FLOPs (``perf.analytic``),
   model TFLOP/s and their share of the bfloat16 tensor peak (mfu) are
   printed.  The checks (12c) cut both to 2 periods: the kernel route
   against the plain route on the same parameters and prompt, and prefill
   logits against a 256-token decode replay in float32; and hubert-xlarge
   and phi3-mini-3.8b at full width cut to 2 layers, kernel route against
   plain route in both dtypes (attention at head dims 80 and 96);
13. the serve path: gemma2-27b (bfloat16) and mamba2-2.7b (float32) at
   full width and depth served through the port's ``ServeEngine`` (4
   slots, 4096-token context) under FIFO over an open-loop smoke trace of
   41 requests (prompts of 16-256 tokens, 4 new tokens each, Poisson
   arrivals 0.25 s apart on average).  Each blocking admission runs its
   prompt's longest kernel-legal head in batched passes over every slot
   (the attention or SSD kernel in every layer) and replays the tail
   through ``decode_step``; every admission and decode tick is timed.
   Two prompts of 300-2000 tokens are then admitted one at a time, and
   the head of the longest runs under ``torch.profiler`` for the
   kernel's share.  13c builds gemma2-27b's step-cost model through a
   session measuring on the card and sets its predicted tick beside the
   measured one; 13d runs FIFO and the model-guided scheduler over one
   short trace (8 requests, prompts of 16-64 tokens, 8 new, gaps of 0.2
   s).  The checks at 2 periods, on 256-slot rings and at the timed
   path's shape: two admissions' caches against a hand-driven decode
   replay (float32), the kernel route against the plain route, and the
   same tokens from both routes on a FIFO trace; 13e runs ``python -m
   repro_torch.launch.serve --arch gemma2-27b`` in a child process and
   prints its line;
14. the train path: (14a) the flash-attention backward kernels (delta,
   dK/dV, dQ) against their plain version on the kernel forward's output
   and row log-sum-exp, at every instantiated (block, head dim) in both
   dtypes and two masks, and at gemma2-27b's widths over 4096 tokens, then
   timed at (1, 32, 4096, 4096, 128) causal float32 beside the plain
   backward, its bound and the backward of PyTorch's SDPA, and at head dim
   96 (phi3-mini-3.8b's, padded to 128) in both dtypes; (14b) every
   parameter's gradient of ``loss_fn`` at gemma2-27b's full width cut to
   one period (batch 1 x 512), kernel route against plain route, in both
   dtypes; (14c) gemma2-27b at full width cut to 2 periods (4 layers,
   3.44 B parameters, bfloat16, float32 AdamW moments) trained for 8 steps
   on batch 1 x 4096 tokens through the port's ``train`` (per-period
   remat, chunked cross entropy), then one step under ``torch.profiler``
   (attention forward and backward, products, AdamW, idle); (14d) a small
   config trained on the card, checkpointed asynchronously and resumed in
   a fresh ``train``, its losses equal to an uninterrupted run's bit for
   bit; 14c's model FLOPs, TFLOP/s and mfu;
15. the Mamba train path: (15a) the SSD backward kernels (each chunk's
   D_c, the reverse state pass, the chunk backward, the fixed-order
   finish) against the plain backward in float64 on the kernel forward's
   own s and h_in, at every instantiated (P, N) and chunks 16, 32, 64 and
   256, with and without h0 and a final-state gradient, and at
   mamba2-2.7b's width at chunks 64 and 256, each called twice and held to
   the same bits, the latter timed beside the float32 plain backward and
   the bound; (15b) every parameter's gradient of ``loss_fn`` at
   mamba2-2.7b's full width cut to 2 layers (batch 1 x 512), kernel route
   against plain route in both dtypes; (15c) mamba2-2.7b at full width
   and depth (64 layers, 2.70 B parameters, bfloat16, float32 AdamW
   moments) trained for 8 steps on batch 1 x 4096 tokens through
   ``train``, then one step under ``torch.profiler`` (SSD forward and
   backward, products, AdamW, idle), with the step's model FLOPs, TFLOP/s
   and mfu;
16. the MoE train path, cell train-4096-jamba-l3-4: jamba-v0.1-52b at
   full width cut to layers 3 and 4 of its 8-layer period (a Mamba mixer
   with the 16-expert top-2 einsum MoE at capacity factor 1.25, then GQA
   attention with a dense SwiGLU; 3.41 B parameters): (16a) the SSD
   forward and backward kernels at jamba's (1, 4096, 128, 64, 1, 16),
   chunk 256, against ``ssd_plain`` and the float64 plain backward (1e-5),
   each called twice for the same bits and timed beside its plain version
   and bound; (16b) every parameter's gradient of ``loss_fn`` at the
   cell's full width (batch 1 x 512), kernel route against plain route in
   both dtypes, each kernel launched exactly 2 forward / 1 backward, and
   how many tokens' expert sets differ between the routes; (16c) 8 AdamW
   steps of 1 x 4096 tokens through ``train`` (bfloat16, float32
   moments), one more under ``torch.profiler``, the step's model FLOPs
   and mfu; (16d) ``remat_policy="dots"`` against "full" on 16c's
   parameters: one step's gradients, the products each backward runs
   counted at the dispatcher against the backward without remat (no
   product with no batch dimension recomputed under "dots"), then 3 steps
   under each policy (ms, peak memory, mfu, launches);
17. the distributed path: (17a) 16c's cell through the sharded step: an
   NCCL process group of world 1, a (1, 1) ``make_local_mesh``, the
   parameters and AdamW moments placed by ``param_specs``, the batch by
   ``data_specs``, ``act_spec`` as ``launch.dryrun.lower_cell`` builds it;
   the first step held to 16c's unsharded step on the same seed (loss and
   every parameter within the bf16 train gate, the bits compared), then 7
   steps timed and one profiled (idle share: ``DTensor`` dispatch is host
   work), exact launches; (17b) its parameters checkpointed and
   ``resume_on_mesh``'d onto a fresh (1, 1) mesh, bit for bit; (17c) the
   dry run of jamba-v0.1-52b's train_4k, prefill_32k and decode_32k at
   full depth on the 16 x 16 and 2 x 16 x 16 production meshes, two
   ``python -m repro_torch.launch.dryrun`` children started with the
   build (per cell: strategy, FLOPs per device analytic and counted,
   collective bytes by kind, argument and peak bytes, roofline terms on
   the H100's rates);

and prints a ``kernels`` JSON line (launches on each path of the main run,
the matmul's, the attention forward's and backward's and the SSD
forward's and backward's also per route, AdamW's per kernel; error,
times and bound per kernel).  Every train path's launches of AdamW's two
kernels are exact: one of each a parameter tensor a step.  The count of
every kernel is set to 0 just before each of the paths 3, 4, 7, 8, 9, 10, 11, 12, 13, 14c, 15c, 16c
and 17a and read just after (the paths 9 and 10 launch none of the
kernels; 14c and 15c add to one path, ``train``; 16c is ``train_moe``, 17a
``train_sharded``); the checks and timings of phases 2, 5, 6, 14a, 14b,
14d, 15a, 15b, 16a, 16b, 16d, 17a's unsharded step, 17b and 17c, and
those after each path, are not counted.

The card's name and power limit print on the line before the last; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises, so the
script exits nonzero and prints no result.  Long outputs (the compilers'
reports, the fitted models, per-config times) go to
``chiprun_out/chip_smoke/`` (phases 9 to 17 under ``contractions``,
``torch_engine``, ``store``, ``models``, ``serve``, ``train``,
``train_mamba``, ``train_moe`` and ``distributed`` in ``result.json``; the
stores as ``store_*.json``, the scoreboard as ``TOURNAMENT.json``; the dry
run's artifacts under ``dryrun_torch/``).
"""

from __future__ import annotations

import atexit
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
#: small SSD cases at the models' (P, N), each checked as SSD_CASES are and
#: on the route its launch count says: (l, h, p, g, n, chunk, route)
SSD_ROUTE_CASES = [(512, 8, 64, 2, 128, 256, "wgmma"),
                   (256, 6, 64, 2, 16, 64, "wgmma"),
                   (256, 4, 64, 1, 128, 32, "mma_sync")]
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
#: published serving workload, and nothing is concluded from its mix.  41
#: requests, so that p99 (numpy's linear percentile) lies between the two
#: slowest requests, 0.6 of the way to the slowest; prompts drawn uniformly
#: and not rounded, so most admissions have a tail; arrivals faster than
#: either model serves, so the run measures capacity and its latencies
#: include the backlog.
#: 13d's trace is short, one trace for both policies
SERVE_TRACE = (41, 16, 256, 4, 0.25)
GUIDED_TRACE = (8, 16, 64, 8, 0.2)
#: 13a/b's admission sample: (prompts, shortest, longest), admitted one at
#: a time after the trace, each timed by head passes and tail; the head of
#: the longest is admitted once more and profiled
ADMIT_SAMPLE = (2, 300, 2000)
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


#: cycles the card spins (``torch.cuda._sleep``) before each launch that
#: :func:`queued_ms` times: about 2 ms at the H100's clock, longer than
#: any timed call's host work, so the call's kernels are queued when the
#: start event runs
QUEUE_CYCLES = 4_000_000


def queued_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms with its host work hidden: the
    card spins QUEUE_CYCLES before each start event, while the host
    enqueues the call, so the events bracket the kernels alone (a short
    kernel behind a Python wrapper would otherwise be timed with its
    launch)."""
    import torch
    fn()                                   # warm up
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
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


def ptxas_entries(log_text: str) -> dict:
    """Registers and spill bytes of every entry function in a ``-Xptxas
    -v`` report, by its mangled name: {name: (registers, spill stores,
    spill loads)}."""
    import re
    table, name, spills = {}, None, (0, 0)
    for line in log_text.splitlines():
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
            table[name] = (int(m.group(1)), *spills)
            name, spills = None, (0, 0)
    return table


def ptxas_table(log_text: str) -> dict:
    """:func:`ptxas_entries` keyed by instantiation: {(kernel, dtype,
    template ints): (registers, spill stores, spill loads)}, the kernel
    name and arguments read from the mangled name (no template ints for a
    kernel that is not a template)."""
    import re
    table = {}
    for name, row in ptxas_entries(log_text).items():
        kern = re.search(r"\d+([a-z_]+_kernel)[IE]", name)
        dtype = "bfloat16" if "__nv_bfloat16" in name else "float32"
        table[(kern.group(1) if kern else name, dtype,
               tuple(int(a) for a in re.findall(r"Li(\d+)E", name)))] = row
    return table


def selected_ptxas_keys(matmul_cfg, attn_cfg, ssd_cfg) -> dict:
    """The ptxas_table keys of each kernel's instantiations at its selected
    config: {kernel: [(what, key), ...]}.  The matmul's float32 (bm, bn,
    bk) is instantiated on its route: the wgmma kernel at (bm, bn), the
    ffma kernel at (bm / 64, bn / 64, bk); attention's two routes are
    reported, the mma.sync route at the float32 family's selected (bq,
    bkv, d) and the wgmma route at the models' bfloat16 WGMMA_MAIN_KEY;
    the SSD's (chunk, p, n) as its passes on its route (``ssd_route``):
    on wgmma the chunk state and chunk scan at (p, n) and the C B^T
    pre-pass at (n,), on mma.sync the chunk state at (p, n) and the chunk
    scan at (p, n, min(chunk, 64)), and the state pass (no template); the
    attention backward's dK/dV and dQ kernels on both routes, the
    mma.sync route's float32 ones at BWD_MAIN_KEY and the wgmma route's at
    BWD_WGMMA_KEYS."""
    import torch
    from repro_torch.kernels.matmul import matmul_route
    from repro_torch.kernels.ssd import ssd_route
    bm, bn, bk = matmul_cfg
    chunk, p, n = ssd_cfg
    if ssd_route(p, n, chunk) == "wgmma":
        ssd_keys = [("chunk_state", ("ssd_chunk_state_wgmma_kernel",
                                     "float32", (p, n))),
                    ("cb", ("ssd_cb_wgmma_kernel", "float32", (n,))),
                    ("chunk_scan", ("ssd_chunk_scan_wgmma_kernel",
                                    "float32", (p, n)))]
    else:
        ssd_keys = [("chunk_state", ("ssd_chunk_state_kernel", "float32",
                                     (p, n))),
                    ("chunk_scan", ("ssd_chunk_scan_kernel", "float32",
                                    (p, n, min(chunk, 64))))]
    mm_key = (("matmul_wgmma_kernel", "float32", (bm, bn))
              if matmul_route(torch.float32, bm, bn, bk) == "wgmma" else
              ("matmul_kernel", "float32", (bm // 64, bn // 64, bk)))
    return {
        "matmul": [("matmul", mm_key)],
        "flash_attention": [
            ("mma_sync", ("attn_sync_kernel", "float32", tuple(attn_cfg))),
            ("wgmma", ("attn_wgmma_kernel", "bfloat16", WGMMA_MAIN_KEY))],
        "flash_attention_bwd": [
            ("dkdv", ("attn_bwd_dkdv_kernel", "float32", BWD_MAIN_KEY)),
            ("dq", ("attn_bwd_dq_kernel", "float32", BWD_MAIN_KEY)),
            *((f"{kern.split('_')[3]}_wgmma", (kern, "bfloat16", key))
              for kern, key in BWD_WGMMA_KEYS.items())],
        "ssd": ssd_keys + [("state_pass", ("ssd_state_pass_kernel",
                                           "float32", ()))]}


#: results the special-function unit (MUFU: ex2, rcp, ...) issues a clock
#: on one SM of the H100: 16, four a sub-partition
MUFU_PER_CLOCK_SM = 16
_MUFU_RATE = []


def mufu_per_s(card) -> float:
    """The card's MUFU rate, results a second, at its maximum SM clock as
    ``nvidia-smi`` reads it."""
    if not _MUFU_RATE:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0])
        _MUFU_RATE.append(MUFU_PER_CLOCK_SM * card.sms * mhz * 1e6)
    return _MUFU_RATE[0]


def bound(flops: float, nbytes: float, peak_flops: float, card,
          mufu_ops: float = 0.0) -> dict:
    """The least time the card could take: the largest of the operations
    over the peak rate, the special-function results (``mufu_ops``) over
    the MUFU rate, and the bytes over the memory rate.  ``bound_by`` names
    the term that binds: "products", "MUFU" or "bytes" (the kernels line
    writes the first two as "operations")."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / card.hbm_bytes_per_s * 1e3
    t_mufu = mufu_ops / mufu_per_s(card) * 1e3 if mufu_ops else 0.0
    terms = {"products": t_ops, "MUFU": t_mufu, "bytes": t_bytes}
    by = max(terms, key=terms.get)
    out = {"bound_ms": terms[by], "bound_by": by, "ops_ms": t_ops,
           "bytes_ms": t_bytes}
    if mufu_ops:
        out.update(mufu_ms=t_mufu, mufu_ops=mufu_ops)
    return out


def attn_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs a mask keeps over one s x s head: row i keeps
    keys max(0, i - window + 1) .. (i if causal else s - 1)."""
    return sum((i if causal else s - 1) -
               (max(0, i - window + 1) if window > 0 else 0) + 1
               for i in range(s))


#: MUFU results the function needs a kept pair: the ex2 of p's expf, and
#: with a softcap tanhf's ex2 and rcp.  The division by the cap needs none:
#: the cap is the same for every pair, so one reciprocal and an FMA
#: correction give the rounded quotient.  Phase 6 logs the wgmma kernel's
#: own static count beside it (check_fwd_sass), which spends more
FWD_MUFU = {False: 1, True: 3}


def attn_work(b, hq, hkv, s, d, causal, window, itemsize, softcap=0.0):
    """(flops, bytes, MUFU results) attention needs: 4 d flops per kept
    pair (q k^T and p v), q, k, v read once and o written once, and
    FWD_MUFU special-function results a pair."""
    pairs = b * hq * attn_pairs(s, causal, window)
    flops = 4.0 * d * pairs
    nbytes = float(itemsize) * b * s * d * (2 * hq + 2 * hkv)
    return flops, nbytes, float(pairs * FWD_MUFU[softcap > 0])


def attn_fwd_bound(b, hq, hkv, s, d, causal, window, dtype, card,
                   softcap=0.0) -> dict:
    """The forward's bound on the route it takes: bfloat16 products at the
    tensor cores' bfloat16 rate, float32 ones as three TF32 products (the
    FFMA bound beside it as ``bound_ms_ffma``); with the MUFU term."""
    import torch
    flops, nbytes, mufu = attn_work(b, hq, hkv, s, d, causal, window,
                                    dtype.itemsize, softcap)
    if dtype == torch.bfloat16:
        bd = bound(flops, nbytes, card.bf16_tensor_flops, card, mufu)
        bd["bound_terms"] = (f"{flops / 1e9:.1f} GFLOP at "
                             f"{card.bf16_tensor_flops / 1e12:.0f} TFLOP/s")
    else:
        bd = bound(3 * flops, nbytes, card.tf32_tensor_flops, card, mufu)
        bd["bound_ms_ffma"] = bound(flops, nbytes, card.fp32_flops,
                                    card)["bound_ms"]
        bd["bound_terms"] = (f"3xTF32 {3 * flops / 1e9:.1f} GFLOP at "
                             f"{card.tf32_tensor_flops / 1e12:.0f} TFLOP/s;"
                             f" FFMA bound {bd['bound_ms_ffma']:.3f}")
    bd["bound_terms"] += (f"; MUFU {mufu / 1e9:.2f} G results at "
                          f"{mufu_per_s(card) / 1e12:.2f} T/s "
                          f"{bd['mufu_ms']:.3f} ms; bound by {bd['bound_by']}")
    bd["flops"] = flops
    return bd


def ssd_work(b, l, h, p, g, n, chunk):
    """(flops, bytes) the SSD scan needs: per head and chunk G X over the Q
    (Q + 1) / 2 pairs i >= j that causality keeps (2 P flops a pair; the
    upper triangle is zero, so, as in attn_work, only kept pairs count), C
    h^T and X^T (B w) (2 Q P N each); and C B^T over the kept pairs (2 N a
    pair) once a (batch, group, chunk), since C and B belong to the group;
    x, dt, a_log, b, c read once and y written once."""
    nc = l // chunk
    pairs = chunk * (chunk + 1) // 2
    per_head = 2.0 * pairs * p + 4.0 * chunk * p * n
    flops = b * nc * (h * per_head + g * 2.0 * pairs * n)
    nbytes = 4.0 * (2 * b * l * h * p + b * l * h + h + 2 * b * l * g * n)
    return flops, nbytes


# ------------------------------------------------------------ phase 2 --
def check_matmul_tables() -> dict:
    """The library's route table (``repro_matmul_route``) against
    ``matmul_route`` at every (dtype, bm, bn, bk) the tuner may try, its
    wgmma staging against ``smem_bytes`` and its split scratch against
    ``split_scratch_floats``."""
    import ctypes
    import torch
    from repro_torch.kernels.matmul import (_lib, matmul_route, smem_bytes,
                                            split_scratch_floats)
    lib = _lib()
    lib.repro_matmul_route.argtypes = [ctypes.c_int] * 4
    lib.repro_matmul_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.repro_matmul_smem_bytes.restype = ctypes.c_longlong
    lib.repro_matmul_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.repro_matmul_scratch_floats.restype = ctypes.c_longlong
    names = {0: None, 1: "wgmma", 2: "ffma"}
    sizes = (8, 16, 32, 64, 128, 256)
    differ, routes = [], {"wgmma": 0, "ffma": 0}
    for code, dt in enumerate((torch.float32, torch.bfloat16)):
        for bm in sizes:
            for bn in sizes:
                for bk in sizes:
                    route = matmul_route(dt, bm, bn, bk)
                    if route:
                        routes[route] += 1
                    if names[lib.repro_matmul_route(code, bm, bn, bk)] != \
                            route:
                        differ.append(("route", code, bm, bn, bk))
                    if route == "wgmma" and lib.repro_matmul_smem_bytes(
                            code, bm, bn, bk) != smem_bytes(bm, bn, bk, dt):
                        differ.append(("smem", code, bm, bn, bk))
                    if lib.repro_matmul_scratch_floats(
                            code, 512, 256, 128, bm, bn, bk) != \
                            split_scratch_floats(512, 256, 128, bm, bn, bk,
                                                 dt):
                        differ.append(("scratch", code, bm, bn, bk))
    if differ:
        raise AssertionError(f"the matmul library's tables differ from "
                             f"matmul.py's at {differ[:10]}")
    log(f"  matmul route table: the library's equals matmul_route at "
        f"{2 * len(sizes) ** 3} (dtype, bm, bn, bk), {routes}; wgmma "
        f"staging and split scratch equal too")
    return routes


def check_kernel_shapes() -> dict:
    """The test shapes, then one shape per (bm, bn, bk) instantiation of
    both routes that the card can stage (a 2 x 3 grid of blocks, k = 4 bk
    up to the test shapes' 256, where the 2e-5 bound holds two float32
    summation orders; phase 4 runs every legal float32 tile at k = 4096),
    each in both dtypes and on its route (``matmul_route``; the wgmma route
    takes bfloat16 at bk 64 and float32 at bk 32, ffma the rest).  A test
    shape whose tiles the kernel does not take must be refused by the
    wrapper."""
    import numpy as np
    import torch
    from repro_torch.kernels.matmul import (KERNEL_BKS, KERNEL_TILES,
                                            matmul, matmul_plain,
                                            matmul_route, tile_legal)

    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    dtypes = ((torch.float32, 2e-5), (torch.bfloat16, 2e-2))
    cases = [(shape, dtype, tol) for shape in TEST_SHAPES
             for dtype, tol in dtypes] + [
        ((2 * bm, 3 * bn, min(4 * bk, 256), bm, bn, bk), dtype, tol)
        for bm, bn in KERNEL_TILES + ((128, 256),) for bk in KERNEL_BKS
        for dtype, tol in dtypes
        if tile_legal(2 * bm, 3 * bn, min(4 * bk, 256), bm, bn, bk, limit,
                      dtype)]
    rng = np.random.default_rng(7)
    worst = {}
    for (m, n, k, bm, bn, bk), dtype, tol in cases:
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to("cuda", dtype)
        y = torch.from_numpy(rng.standard_normal((k, n)).astype(
            np.float32)).to("cuda", dtype)
        name = str(dtype)[6:]
        if not tile_legal(m, n, k, bm, bn, bk, limit, dtype):
            try:
                matmul(x, y, bm=bm, bn=bn, bk=bk)
            except ValueError as exc:
                log(f"  matmul {m}x{n}x{k} tiles ({bm},{bn},{bk}) {name}: "
                    f"not legal for the kernel, refused "
                    f"({str(exc)[:60]}...)")
                continue
            raise AssertionError(f"matmul took illegal tiles "
                                 f"{(bm, bn, bk)}")
        route = matmul_route(dtype, bm, bn, bk)
        before = dict(matmul.launches_by_route)
        out = matmul(x, y, bm=bm, bn=bn, bk=bk)
        torch.cuda.synchronize()           # a fault surfaces here
        took = [r for r, c in matmul.launches_by_route.items()
                if c != before[r]]
        ref = matmul_plain(x, y, bm=bm, bn=bn, bk=bk)
        diff = (out.float() - ref.float()).abs()
        ratio = float((diff / (tol + tol * ref.float().abs())).max())
        log(f"  matmul {m}x{n}x{k} tiles ({bm},{bn},{bk}) {name} on "
            f"{route}: max_abs_err {float(diff.max()):.3e}, max |diff| / "
            f"({tol} + {tol} |plain|) {ratio:.3f} (bound 1)")
        if took != [route]:
            raise AssertionError(f"matmul at {(bm, bn, bk)} {name} took "
                                 f"{took}, not its route {route}")
        if not ratio <= 1.0:
            raise AssertionError(f"matmul disagrees with its plain "
                                 f"version at {(m, n, k)} {dtype}")
        key = (route, name)
        if ratio > worst.get(key, (-1.0,))[0]:
            worst[key] = (ratio, [bm, bn, bk])
    log("  worst reading by route and dtype: " + ", ".join(
        f"{r} {d} {v[0]:.3f} at {tuple(v[1])}"
        for (r, d), v in sorted(worst.items())))
    return {f"{r}_{d}": {"ratio": v[0], "tile": v[1]}
            for (r, d), v in worst.items()}


def check_matmul_sass(sass_run) -> dict:
    """The matmul's SASS gate (``sass_run`` from :func:`start_sass` on its
    library): every wgmma kernel (``matmul_wgmma_kernel``) holds HGMMA, and
    no ffma kernel (``matmul_kernel``) holds a tensor-core instruction
    (HMMA or HGMMA)."""
    hgmma = hmma_counts(sass_run, "HGMMA")
    hmma = hmma_counts(sass_run)
    wg = {k: hgmma[k] for k in hgmma if "matmul_wgmma_kernel" in k}
    ff = {k: hgmma[k] + hmma[k] for k in hgmma if "matmul_kernel" in k}
    if len(wg) != 10 or not ff:
        raise AssertionError(f"the matmul library's SASS holds {len(wg)} "
                             f"wgmma and {len(ff)} ffma kernels; 10 wgmma "
                             f"expected")
    log(f"  matmul SASS: HGMMA in the {len(wg)} wgmma kernels "
        f"{min(wg.values())}-{max(wg.values())}; HMMA + HGMMA in the "
        f"{len(ff)} ffma kernels {max(ff.values())} at most (cuobjdump "
        f"-sass)")
    if min(wg.values()) <= 0 or max(ff.values()) != 0:
        raise AssertionError(f"the matmul's SASS fails its gate: wgmma "
                             f"{wg}, ffma {ff}")
    return {"wgmma_hgmma": sorted(wg.values()), "ffma_tensor_core":
            max(ff.values()), "wgmma_kernels": len(wg),
            "ffma_kernels": len(ff)}


# ------------------------------------------------------- phase 2, adamw --
#: phase 2's AdamW check: (parameter, gradient) dtypes -- bfloat16 with
#: bfloat16 gradients (every train step), float32 with float32, bfloat16
#: with float32 gradients (the micro-batch accumulation's sums)
ADAMW_DTYPES = (("bfloat16", "bfloat16"), ("float32", "float32"),
                ("bfloat16", "float32"))
#: flat sizes: one element, fewer than a vector, and a million and three
#: (a head of vectors, then a tail); the last also as a view one element
#: into its buffers (every pointer off its 16-byte boundary)
ADAMW_SIZES = (1, 7, (1 << 20) + 3)
#: gemma2-27b's embedding (vocab x d_model), the largest tensor a train
#: path updates: 1.18e9 elements, 4.7 GB in each moment
ADAMW_EMBED = (256000, 4608)
#: the step whose bias corrections the checks use
ADAMW_STEP = 3
#: entry functions of csrc/adamw.cu: the norm's partial pass (float32,
#: bfloat16) and finish, the update at four (g, p) dtype pairs in two modes
ADAMW_INSTANTIATIONS = 11
#: the norm kernel against a float64 sum, relative: it sums in float64 and
#: rounds once (2^-24), against float32 sums whose error grows with n
ADAMW_NORM_TOL = 1e-6
#: the AdamW-level check's parameters: 1-D (not decayed) and 2-D (decayed)
ADAMW_PARAMS = ((7,), (1,), (257, 4099), (64, 3))


def adamw_tensors(gen, shape, p_dtype, g_dtype, offset: int = 0) -> dict:
    """A parameter, its gradient and mid-training moments of ``shape`` on
    the card, each a view ``offset`` elements into a buffer of its own:
    p ~ N(0, 1), g ~ 4 N(0, 1), m ~ 0.1 N(0, 1), v ~ 0.01 U(0, 1)."""
    import math
    import torch
    n = math.prod(shape)

    def draw(dtype, scale, uniform=False):
        fn = torch.rand if uniform else torch.randn
        buf = (fn(n + offset, generator=gen, device="cuda") * scale).to(
            dtype)
        return buf[offset:].view(shape)

    return {"p": draw(p_dtype, 1.0), "g": draw(g_dtype, 4.0),
            "m": draw(torch.float32, 0.1),
            "v": draw(torch.float32, 0.01, uniform=True)}


def adamw_constants(dev, opt) -> dict:
    """The bias corrections at ADAMW_STEP as ``AdamW`` forms them (0-d
    float32 tensors on the card) and the hyperparameters."""
    import torch
    stepf = torch.tensor(ADAMW_STEP, dtype=torch.int32, device=dev).float()
    return {"bc1": 1 - torch.tensor(opt.b1, device=dev) ** stepf,
            "bc2": 1 - torch.tensor(opt.b2, device=dev) ** stepf,
            "lr": opt.lr, "b1": opt.b1, "b2": opt.b2, "eps": opt.eps,
            "weight_decay": opt.weight_decay}


def like_at(x):
    """A copy of ``x`` in a buffer of its own at ``x``'s storage offset
    modulo 8 elements, so its pointer sits as far off a 16-byte boundary
    as ``x``'s."""
    import torch
    off = x.storage_offset() % 8
    out = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)[
        off:].view(x.shape)
    return out.copy_(x)


def adamw_case(t: dict, scale, decay: bool, consts: dict) -> dict:
    """One tensor through the update kernel in both modes against the
    plain version on the card, on copies of the same inputs: m, v and u
    (``adamw_update``, u written) and m, v and p (``u`` None, p written;
    against the plain u added to p, as ``apply_updates`` adds).  The
    kernel's copies keep the inputs' alignment, so a view off its 16-byte
    boundary runs the vector loop with a head when p is written, and the
    scalar loop when u is (u is fresh, at another offset than the rest).
    Returns which tensors came out the same bits and the largest
    |difference|."""
    import torch
    from repro_torch.kernels.adamw import adamw_update, adamw_update_plain
    kw = dict(scale=scale, decay=[decay], **consts)
    g, p = t["g"], t["p"]
    want_m, want_v = t["m"].clone(), t["v"].clone()
    want_u = torch.empty_like(p)
    adamw_update_plain([g], [want_m], [want_v], [p], [want_u], **kw)
    want_p = p.clone().add_(want_u)
    got_m, got_v = like_at(t["m"]), like_at(t["v"])
    got_u = torch.empty_like(p)
    adamw_update([g], [got_m], [got_v], [p], [got_u], **kw)
    torch.cuda.synchronize()                # a fault surfaces here
    same = {"m": torch.equal(got_m, want_m), "v": torch.equal(got_v, want_v),
            "u": torch.equal(got_u, want_u)}
    err = float((got_u.float() - want_u.float()).abs().max())
    got_m.copy_(t["m"])
    got_v.copy_(t["v"])
    got_p = like_at(p)
    del got_u
    adamw_update([g], [got_m], [got_v], [got_p], None, **kw)
    torch.cuda.synchronize()
    same.update(m_apply=torch.equal(got_m, want_m),
                v_apply=torch.equal(got_v, want_v),
                p_apply=torch.equal(got_p, want_p))
    err = max(err, float((got_p.float() - want_p.float()).abs().max()))
    return {"same": same, "err": err}


def check_adamw(card) -> dict:
    """Phase 2's AdamW check, the optimizer's two kernels on the card.

    The update kernel against its plain version, bit for bit
    (:func:`adamw_case`): every ADAMW_DTYPES pair, weight decay on and
    off, no clip and the clip active (the scale from the global norm of
    the pair's gradients, by the norm kernel), each ADAMW_SIZES tensor and
    the largest as a view one element into its buffers; then gemma2-27b's
    embedding (bfloat16, decayed, clipped).  ``AdamW.update_apply``
    against ``update`` followed by ``apply_updates`` for three steps of
    ADAMW_PARAMS in each dtype pair (p, m and v the same bits), at
    ``grad_clip`` 1 through the kernels, and at 0 also against the plain
    route (``use_kernel=False``).  The norm kernel within ADAMW_NORM_TOL
    of a float64 sum, two calls the same bits, a second tensor's sum
    added on the card as torch adds the two.  Then at the embedding: the
    update kernel (p written), its plain version and
    ``torch._fused_adamw_`` timed, beside the byte bound; the norm kernel,
    ``torch.sum(torch.square(g.float()))`` and ``torch.linalg.vector_norm``
    likewise."""
    import gc
    import math
    import torch
    from repro_torch.kernels.adamw import (adamw_sqnorm, adamw_sqnorm_plain,
                                           adamw_update, adamw_update_bytes,
                                           adamw_update_plain)
    from repro_torch.train.optimizer import AdamW, apply_updates
    dev = torch.device("cuda")
    opt = AdamW(lr=TRAIN_LR)
    consts = adamw_constants(dev, opt)
    gen = torch.Generator(device="cuda").manual_seed(21)
    cases, failed, worst_err = 0, [], 0.0
    norms = []

    first = torch.full((3,), 0.5, device=dev)

    def check_norm(what, g):
        got = adamw_sqnorm([g])
        again = adamw_sqnorm([g])
        want = sum(float(torch.sum(torch.square(c.double())))
                   for c in g.reshape(-1).split(1 << 26))
        rel = abs(float(got) - want) / want if want else abs(float(got))
        # a second tensor's sum added on the card as torch adds the two
        chained = adamw_sqnorm([first, g])
        ok = (torch.equal(got, again) and rel <= ADAMW_NORM_TOL and
              torch.equal(chained, adamw_sqnorm([first]) + got))
        norms.append({"case": what, "rel_err": rel, "ok": ok})
        if not ok:
            failed.append(("norm", what, rel))
        return got

    for p_name, g_name in ADAMW_DTYPES:
        p_dt, g_dt = getattr(torch, p_name), getattr(torch, g_name)
        tensors = [(f"n={n}", adamw_tensors(gen, (n,), p_dt, g_dt))
                   for n in ADAMW_SIZES]
        n = ADAMW_SIZES[-1]
        tensors.append((f"n={n} at offset 1",
                        adamw_tensors(gen, (n,), p_dt, g_dt, offset=1)))
        for what, t in tensors:
            check_norm(f"{g_name} {what}", t["g"])
        total = adamw_sqnorm([t["g"] for _, t in tensors])
        scale = torch.clamp(opt.grad_clip / (torch.sqrt(total) + 1e-9),
                            max=1.0)
        if not float(scale) < 1.0:
            raise AssertionError(f"the clip is not active: scale "
                                 f"{float(scale)}")
        for what, t in tensors:
            for decay in (True, False):
                for clipped in (False, True):
                    res = adamw_case(t, scale if clipped else None, decay,
                                     consts)
                    cases += 1
                    worst_err = max(worst_err, res["err"])
                    if not all(res["same"].values()):
                        failed.append((p_name, g_name, what, decay, clipped,
                                       res["same"]))
        del tensors
    log(f"  adamw_update against its plain version on the card, bit for "
        f"bit: {cases} cases ({len(ADAMW_DTYPES)} dtype pairs x "
        f"{len(ADAMW_SIZES) + 1} tensors x decay on/off x clip off/active),"
        f" each in both modes (u written; p written); max |diff| "
        f"{worst_err:.3e}; failed {failed}")
    # gemma2-27b's embedding
    t = adamw_tensors(gen, ADAMW_EMBED, torch.bfloat16, torch.bfloat16)
    g_sq = check_norm("bfloat16 gemma2-27b embedding", t["g"])
    scale = torch.clamp(opt.grad_clip / (torch.sqrt(g_sq) + 1e-9), max=1.0)
    res = adamw_case(t, scale, True, consts)
    cases += 1
    worst_err = max(worst_err, res["err"])
    if not all(res["same"].values()):
        failed.append(("embedding", res["same"]))
    log(f"  adamw_update at gemma2-27b's embedding {ADAMW_EMBED} (bfloat16 "
        f"p and g, decayed, clipped): {res['same']}")
    # AdamW: update_apply against update + apply_updates, and the plain
    # route without a clip
    steps = {}
    for p_name, g_name in ADAMW_DTYPES:
        p_dt, g_dt = getattr(torch, p_name), getattr(torch, g_name)
        params = [torch.randn(s, generator=gen, device=dev).to(p_dt)
                  for s in ADAMW_PARAMS]
        for clip in (1.0, 0.0):
            a = AdamW(lr=TRAIN_LR, grad_clip=clip)
            runs = {"update_apply": [p.clone() for p in params],
                    "update": [p.clone() for p in params]}
            if clip == 0.0:
                runs["plain"] = [p.clone() for p in params]
            states = {k: a.init(v) for k, v in runs.items()}
            for _ in range(3):
                grads = [(4 * torch.randn(s, generator=gen, device=dev)).to(
                    g_dt) for s in ADAMW_PARAMS]
                states["update_apply"] = a.update_apply(
                    grads, states["update_apply"], runs["update_apply"])
                upd, states["update"] = a.update(grads, states["update"],
                                                 runs["update"])
                apply_updates(runs["update"], upd)
                if "plain" in runs:
                    upd, states["plain"] = a.update(
                        grads, states["plain"], runs["plain"],
                        use_kernel=False)
                    apply_updates(runs["plain"], upd)
            torch.cuda.synchronize()
            for k in runs:
                if k == "update_apply":
                    continue
                same = all(torch.equal(x, y) for x, y in zip(
                    runs["update_apply"] + states["update_apply"].mu +
                    states["update_apply"].nu,
                    runs[k] + states[k].mu + states[k].nu))
                steps[f"{p_name}/{g_name} clip {clip} vs {k}"] = same
                if not same:
                    failed.append(("AdamW", p_name, g_name, clip, k))
        del params, runs, states
    log(f"  AdamW.update_apply, 3 steps of {len(ADAMW_PARAMS)} tensors "
        f"{ADAMW_PARAMS}: p, m and v the same bits as update followed by "
        f"apply_updates (clip 1 and 0) and as the plain route (clip 0): "
        f"{steps}")
    worst_norm = max(r["rel_err"] for r in norms)
    log(f"  adamw_sqnorm: {len(norms)} gradients within "
        f"{ADAMW_NORM_TOL:.0e} of the float64 sum (worst {worst_norm:.3e}),"
        f" two calls the same bits, a second tensor's sum added as torch "
        f"adds: "
        f"{all(r['ok'] for r in norms)}")
    if failed:
        raise AssertionError(f"the AdamW kernels disagree with their plain "
                             f"versions: {failed}")
    # times at the embedding: p written (the train step's mode)
    n = math.prod(ADAMW_EMBED)
    kw = dict(scale=scale, decay=[True], **consts)
    g, m, v, p = [t["g"]], [t["m"]], [t["v"]], [t["p"]]
    gc.collect()
    torch.cuda.empty_cache()
    kernel_ms = event_ms(lambda: adamw_update(g, m, v, p, None, **kw),
                         TIME_REPS)
    u = [torch.empty_like(p[0])]
    u_ms = event_ms(lambda: adamw_update(g, m, v, p, u, **kw), TIME_REPS)
    del u
    plain_ms = event_ms(lambda: adamw_update_plain(g, m, v, p, None, **kw),
                        3)
    nbytes = adamw_update_bytes(n, torch.bfloat16, torch.bfloat16)
    bd = bound(18.0 * n, nbytes, card.fp32_flops, card)
    step_t = torch.full((), float(ADAMW_STEP), device=dev)
    fused = dict(lr=opt.lr, beta1=opt.b1, beta2=opt.b2,
                 weight_decay=opt.weight_decay, eps=opt.eps, amsgrad=False,
                 maximize=False)
    try:
        library_ms = event_ms(lambda: torch._fused_adamw_(
            p, g, m, v, [], [step_t], **fused), TIME_REPS)
        library_on = "the same tensors (bfloat16 p and g, float32 m and v)"
    except (RuntimeError, TypeError) as exc:
        p32, g32 = [p[0].float()], [g[0].float()]
        library_ms = event_ms(lambda: torch._fused_adamw_(
            p32, g32, m, v, [], [step_t], **fused), TIME_REPS)
        library_on = (f"float32 copies of p and g with the same m and v "
                      f"(it refused the mixed dtypes: {str(exc)[:80]})")
        del p32, g32
    share = bd["bound_ms"] / kernel_ms
    log(f"  adamw_update at the embedding ({n} elements, bfloat16 p and g, "
        f"p written): kernel {kernel_ms:.3f} ms ({100 * share:.1f} % of the "
        f"bound), u written {u_ms:.3f} ms; plain "
        f"route {plain_ms:.3f} ms; bound {bd['bound_ms']:.3f} ms "
        f"({nbytes / 1e9:.2f} GB at {card.hbm_bytes_per_s / 1e12:.2f} TB/s, "
        f"{bd['bound_by']}); torch._fused_adamw_ {library_ms:.3f} ms on "
        f"{library_on} (a time only: it rounds in another order and "
        f"decays every tensor)")
    sq_ms = event_ms(lambda: adamw_sqnorm(g), TIME_REPS)
    sq_plain_ms = event_ms(lambda: adamw_sqnorm_plain(g), TIME_REPS)
    sq_lib_ms = event_ms(lambda: torch.linalg.vector_norm(
        g[0], dtype=torch.float32), TIME_REPS)
    sq_bd = bound(2.0 * n, 2.0 * n, card.fp32_flops, card)
    sq_share = sq_bd["bound_ms"] / sq_ms
    log(f"  adamw_sqnorm at the embedding: kernel {sq_ms:.3f} ms ("
        f"{100 * sq_share:.1f} % of the bound), plain "
        f"{sq_plain_ms:.3f} ms, torch.linalg.vector_norm {sq_lib_ms:.3f} "
        f"ms, bound {sq_bd['bound_ms']:.3f} ms ({2 * n / 1e9:.2f} GB)")
    del t, g, m, v, p
    gc.collect()
    torch.cuda.empty_cache()
    return {"cases": cases, "err": worst_err, "adamw_level": steps,
            "norms": norms, "shape": list(ADAMW_EMBED), "dtype": "bfloat16",
            "kernel_ms": kernel_ms, "bound_share": share,
            "u_written_ms": u_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_on": library_on, "bytes": nbytes, **bd,
            "sqnorm": {"kernel_ms": sq_ms, "plain_ms": sq_plain_ms,
                       "library_ms": sq_lib_ms, "bound_share": sq_share,
                       "library": "torch.linalg.vector_norm(g, dtype="
                       "torch.float32)", "bytes": 2 * n, **sq_bd,
                       "worst_rel_err": worst_norm}}


# ------------------------------------------------------------ phase 3 --
# ------------------------------------------------------- phase 2, mamba --
#: phase "2 mamba": the Mamba-2 mixer's glue kernels (csrc/mamba_mixer.cu)
#: at each model's width, (batch, length, heads, P, groups, N):
#: mamba2-2.7b (d_inner 5120, W 10576) and jamba-v0.1-52b (8192, 16544);
#: mamba2's width at 3 x 1365 = 4095 rows, which leaves the backwards'
#: last row group short; and one unaligned row (W 109: the kernels'
#: scalar path)
MAMBA_WIDTHS = (("mamba2-2.7b", (1, 4096, 80, 64, 1, 128)),
                ("jamba-v0.1-52b", (1, 4096, 128, 64, 1, 16)),
                ("ragged", (3, 1365, 80, 64, 1, 128)),
                ("unaligned", (2, 48, 5, 8, 1, 12)))
#: the widths phase "2 mamba" times (the others it checks)
MAMBA_TIMED = ("mamba2-2.7b", "jamba-v0.1-52b")
#: normwise, kernel against plain: float32 the same operations in another
#: order; bfloat16 one rounding of the model's dtype apart
MAMBA_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
#: normwise, the parameter gradients (sums over the tokens) against the
#: plain version in float64 (with the model dtype's roundings)
MAMBA_PARAM_TOL = 1e-5
MAMBA_KERNELS = ("mamba_in", "mamba_out", "mamba_out_bwd", "mamba_in_bwd")
#: entry functions of csrc/mamba_mixer.cu: mamba_in's vector and scalar
#: kernels and mamba_out on both paths, each for float32 and bfloat16
#: (8); the backwards' scalar kernels and mamba_in_bwd's vector kernel,
#: each for both (6); mamba_out_bwd's vector kernel at launch bounds of
#: 640 and 1024 threads for both, and without y in its ring for float32
#: at 1024 (5); the two finishes
MAMBA_INSTANTIATIONS = 21
#: each wrapper's entry functions, as their mangled names hold them
MAMBA_ENTRIES = {"mamba_in": ("mamba_in_kernel", "mamba_in_vec_kernel"),
                 "mamba_out": ("mamba_out_kernel",),
                 "mamba_out_bwd": ("mamba_out_bwd_kernel",
                                   "mamba_out_bwd_vec_kernel",
                                   "mamba_out_bwd_finish_kernel"),
                 "mamba_in_bwd": ("mamba_in_bwd_kernel",
                                  "mamba_in_bwd_vec_kernel",
                                  "mamba_in_bwd_finish_kernel")}
MAMBA_DETAIL = {
    "mamba_in": "zxbcdt's x, b, c and dt columns read in place through its "
    "strides, x, b, c as float32 and dt = softplus(dt + dt_bias) written "
    "(the SSD's operands); the (row, 8-column chunk) pairs laid out flat, "
    "four 16-byte loads a thread before its stores",
    "mamba_out": "the D skip, the round to the model's dtype and the gated "
    "RMSNorm: a block a token row, a chunk of 8 columns a thread held in "
    "registers across the row's fixed-order sum; r saved",
    "mamba_out_bwd": "y's gradient (float32, for the SSD backward) and z's "
    "(into the z columns of zxbcdt's gradient buffer): a block a fixed row "
    "group, a chunk of 8 columns a thread, each thread's chunks of the rows "
    "ahead copied by cp.async into its own slots of a 2-4 stage ring in "
    "shared memory, so the next rows' bytes are in flight across the row's "
    "fixed-order sum (one barrier a row); norm_g's column sums and d_skip's "
    "chunk sums in registers, a fixed-order finish (no atomics)",
    "mamba_in_bwd": "the x (with the D skip's term), b, c and dt columns of "
    "the gradient buffer from the SSD backward's dx, db, dc, ddt: the x, b "
    "and c (row, 8-column chunk) pairs flat, four a thread with their loads "
    "before their stores, a chunk's head by a multiply; the dt columns the "
    "launch's first blocks, a fixed row group each (dt_bias's partials), a "
    "fixed-order finish"}
#: flops an element of the mixer's width (exp, divisions and the norm's
#: products counted as one each): bytes bind every one of them
MAMBA_FLOPS = {"mamba_in": 1, "mamba_out": 14, "mamba_out_bwd": 34,
               "mamba_in_bwd": 3}


def mamba_inputs(gen, shape, dtype) -> dict:
    """One case's operands on the card, from ``gen``: zxbcdt and the
    per-head / per-channel vectors near the model's initial values, the
    SSD's y and each gradient the kernels take."""
    import torch
    b, s, h, p, g, n = shape
    di, dev = h * p, gen.device

    def rand(*sh, scale=1.0):
        return torch.randn(sh, generator=gen, device=dev) * scale

    return dict(zx=rand(b, s, 2 * di + 2 * g * n + h).to(dtype),
                dt_bias=rand(h, scale=0.5) - 1.0, d_skip=1.0 + rand(
                    h, scale=0.3), norm_g=rand(di, scale=0.2).to(dtype),
                y=rand(b, s, h, p), d_out=rand(b, s, di).to(dtype),
                dx=rand(b, s, h, p), db=rand(b, s, g, n),
                dc=rand(b, s, g, n), ddt=rand(b, s, h),
                dims=dict(heads=h, groups=g, state=n))


def mamba_case(t: dict, dtype_name: str) -> dict:
    """Each of the four kernels against its plain version on ``t``'s
    operands (the same inputs: the backwards take the kernel's r and dy),
    twice for the same bits; the parameter gradients against the plain
    version in float64.  Returns each kernel's normwise error, its share
    of elements that differ from the plain version, and whether two calls
    gave the same bits."""
    import torch
    from repro_torch.kernels import mamba_mixer as mm
    zx, dims = t["zx"], t["dims"]
    di = dims["heads"] * t["y"].shape[-1]
    f64 = torch.float64
    res = {}

    def compare(name, got, again, want, tol):
        # the share of elements that differ: of the first output, the one
        # in the model's dtype (or, for mamba_in, x)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        share = float((got[0] != want[0]).float().mean())
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        res[name] = {"err": max(errs), "errs": errs, "diff_share": share,
                     "same_bits": same, "tol": tol}

    tol = MAMBA_TOL[dtype_name]
    args = (zx, t["dt_bias"])
    compare("mamba_in", mm.mamba_in(*args, **dims), mm.mamba_in(*args, **dims),
            mm.mamba_in(*args, use_kernel=False, **dims), tol)
    args = (t["y"], zx, t["d_skip"], t["norm_g"])
    out, r = mm.mamba_out(*args)
    compare("mamba_out", (out, r), mm.mamba_out(*args),
            mm.mamba_out(*args, use_kernel=False), tol)

    def out_bwd(use_kernel):
        grad = torch.full_like(zx, float("nan"))
        got = mm.mamba_out_bwd(t["d_out"], t["y"], zx, r, t["d_skip"],
                               t["norm_g"], grad, use_kernel=use_kernel)
        return (grad[..., :di], *got)

    k1, k2, plain = out_bwd(True), out_bwd(True), out_bwd(False)
    compare("mamba_out_bwd", k1[:2], k2[:2], plain[:2], tol)
    dy = k1[1]

    def in_bwd(use_kernel, acc=None):
        grad = torch.full_like(zx, float("nan"))
        if acc is None:
            d_b = mm.mamba_in_bwd(t["dx"], t["db"], t["dc"], t["ddt"], dy,
                                  zx, t["dt_bias"], t["d_skip"], grad,
                                  use_kernel=use_kernel)
        else:
            d_b = mm.mamba_in_bwd_plain(t["dx"], t["db"], t["dc"], t["ddt"],
                                        dy, zx, t["dt_bias"], t["d_skip"],
                                        grad, acc=acc)
        return grad[..., di:], d_b

    j1, j2, jp = in_bwd(True), in_bwd(True), in_bwd(False)
    compare("mamba_in_bwd", j1[:1], j2[:1], jp[:1], tol)
    if torch.isnan(k1[0]).any() or torch.isnan(j1[0]).any():
        raise AssertionError("the mixer's backwards left gradient columns "
                             "unwritten")
    # the parameter gradients against float64 (the model dtype's roundings
    # kept) and the same bits twice
    _, r64 = mm.mamba_out_plain(t["y"], zx, t["d_skip"], t["norm_g"], acc=f64)
    grad = torch.empty_like(zx)
    _, g64, _ = mm.mamba_out_bwd_plain(t["d_out"], t["y"], zx, r64,
                                       t["d_skip"], t["norm_g"], grad,
                                       acc=f64)
    # d_skip's: the float64 sum of the kernel's own dy (already rounded to
    # the model's dtype, where a float64 oracle could round an element the
    # other way) times x
    x = zx[..., di:2 * di].reshape(dy.shape)
    s64 = (dy.to(f64) * x.to(f64)).sum((0, 1, 3))
    _, b64 = in_bwd(None, acc=f64)
    params = {"d_norm_g": (k1[2], k2[2], g64), "d_skip": (k1[3], k2[3], s64),
              "d_dt_bias": (j1[1], j2[1], b64)}
    res["params"] = {k: {"err": rel_err(a.double(), w), "same_bits":
                         torch.equal(a, b)} for k, (a, b, w) in params.items()}
    res["mamba_out_bwd"]["same_bits"] &= all(
        res["params"][k]["same_bits"] for k in ("d_norm_g", "d_skip"))
    res["mamba_in_bwd"]["same_bits"] &= res["params"]["d_dt_bias"]["same_bits"]
    return res


def mamba_times(t: dict, shape, dtype, card) -> dict:
    """Each kernel's device time (:func:`queued_ms`) beside its plain
    version's and its byte bound, on ``t``'s operands."""
    import torch
    from repro_torch.kernels import mamba_mixer as mm
    b, s, h, p, g, n = shape
    zx, dims = t["zx"], t["dims"]
    out, r = mm.mamba_out(t["y"], zx, t["d_skip"], t["norm_g"])
    grad = torch.empty_like(zx)
    dy = mm.mamba_out_bwd(t["d_out"], t["y"], zx, r, t["d_skip"],
                          t["norm_g"], grad)[0]
    calls = {
        "mamba_in": lambda k: mm.mamba_in(zx, t["dt_bias"], use_kernel=k,
                                          **dims),
        "mamba_out": lambda k: mm.mamba_out(t["y"], zx, t["d_skip"],
                                            t["norm_g"], use_kernel=k),
        "mamba_out_bwd": lambda k: mm.mamba_out_bwd(
            t["d_out"], t["y"], zx, r, t["d_skip"], t["norm_g"], grad,
            use_kernel=k),
        "mamba_in_bwd": lambda k: mm.mamba_in_bwd(
            t["dx"], t["db"], t["dc"], t["ddt"], dy, zx, t["dt_bias"],
            t["d_skip"], grad, use_kernel=k)}
    rows = {}
    for name, call in calls.items():
        nbytes = mm.mixer_bytes(name, b * s, h, p, g * n, dtype.itemsize)
        flops = MAMBA_FLOPS[name] * b * s * h * p
        rows[name] = {"kernel_ms": queued_ms(lambda: call(True), TIME_REPS),
                      "plain_ms": queued_ms(lambda: call(False), 3),
                      "bytes": nbytes, "library_ms": None,
                      **bound(flops, nbytes, card.fp32_flops, card)}
        if name in ("mamba_out_bwd", "mamba_in_bwd"):
            rows[name]["launch"] = mm.bwd_occupancy(name, dtype, h * p)
    return rows


def check_mamba(card) -> dict:
    """Phase "2 mamba": the four mixer kernels against their plain
    versions at mamba2-2.7b's and jamba-v0.1-52b's widths, mamba2's at a
    ragged row count and an unaligned row, in bfloat16 and float32
    (MAMBA_TOL normwise, the parameter gradients MAMBA_PARAM_TOL of
    float64, two calls the same bits), then each timed at the models'
    widths beside its plain version and its byte bound (the backwards
    with their blocks per SM).  Returns the rows; the kernels line reads
    mamba2-2.7b's bfloat16 row (the train cell's)."""
    import gc
    import torch
    gen = torch.Generator(device="cuda").manual_seed(32)
    cases, failed, timed = {}, [], {}
    worst = {k: 0.0 for k in MAMBA_KERNELS}
    for width, shape in MAMBA_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            t = mamba_inputs(gen, shape, dtype)
            res = mamba_case(t, dn)
            key = f"{width} {dn}"
            cases[key] = res
            for k in MAMBA_KERNELS:
                row = res[k]
                worst[k] = max(worst[k], row["err"])
                if row["err"] > row["tol"] or not row["same_bits"]:
                    failed.append((key, k, row))
            for k, row in res["params"].items():
                if row["err"] > MAMBA_PARAM_TOL or not row["same_bits"]:
                    failed.append((key, k, row))
            log(f"  {key} {shape}: " + "; ".join(
                f"{k} err {res[k]['err']:.2e} (differ "
                f"{100 * res[k]['diff_share']:.3f} %)" for k in MAMBA_KERNELS)
                + "; params " + ", ".join(
                    f"{k} {v['err']:.2e}" for k, v in res["params"].items())
                + "; same bits twice: " + str(all(
                    res[k]["same_bits"] for k in MAMBA_KERNELS)))
            if width in MAMBA_TIMED:
                timed[key] = mamba_times(t, shape, dtype, card)
                log(f"    times: " + "; ".join(
                    f"{k} {v['kernel_ms']:.3f} ms (plain {v['plain_ms']:.3f},"
                    f" bound {v['bound_ms']:.3f}, {v['bytes'] / 1e9:.3f} GB, "
                    f"{100 * v['bound_ms'] / v['kernel_ms']:.1f} % of the "
                    f"bound" + (f", {v['launch']['blocks_per_sm']} blocks of "
                                f"{v['launch']['threads']} an SM"
                                if "launch" in v else "") + ")"
                    for k, v in timed[key].items()))
            del t
            gc.collect()
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the mixer's kernels disagree with their plain "
                             f"versions: {failed}")
    main = timed["mamba2-2.7b bfloat16"]
    return {"cases": cases, "timed": timed,
            "kernels": {k: {**main[k], "err": worst[k]}
                        for k in MAMBA_KERNELS}}


# ----------------------------------------------------- phase "2 rmsnorm" --
#: the widths phase "2 rmsnorm" checks: mamba2-2.7b's d_model, jamba's and
#: deepseek's, gemma2-27b's, chameleon's (the widest), and one that is not
#: a multiple of 8 (the kernels' scalar path)
RMSNORM_WIDTHS = (2560, 4096, 4608, 8192, 2550)
#: its row counts: train_4k's tokens, a decode step's one, and a ragged
#: count (the backward's last row group short)
RMSNORM_ROWS = (4096, 1, 4095)
#: the cases it times: every width at 4096 rows, and a decode step's row
#: in bfloat16
RMSNORM_TIMED = {(4096, "bfloat16"), (4096, "float32"), (1, "bfloat16")}
#: the row the kernels line reads: mamba2-2.7b's width (the train cell
#: 15c's), 4096 rows, bfloat16
RMSNORM_MAIN = "2560 x 4096 bfloat16"
#: normwise, y and dx against the plain version (MAMBA_TOL's reasons);
#: rstd and scale's gradient (float32 in both) within RMSNORM_F32_TOL,
#: scale's also of a float64 sum of the kernel's own products
RMSNORM_TOL = MAMBA_TOL
RMSNORM_F32_TOL = 1e-5
RMSNORM_KERNELS = ("rmsnorm_fwd", "rmsnorm_bwd")
#: entry functions of csrc/rmsnorm.cu: the forward and the backward each at
#: 1-4 chunks a thread in bfloat16, 1-2 in float32 and on the scalar path
#: in both (8 each), and the backward's finish
RMSNORM_INSTANTIATIONS = 17
#: each wrapper's entry functions, as their mangled names hold them
RMSNORM_ENTRIES = {"rmsnorm_fwd": ("rmsnorm_fwd_kernel",),
                   "rmsnorm_bwd": ("rmsnorm_bwd_kernel",
                                   "rmsnorm_bwd_finish_kernel")}
RMSNORM_DETAIL = {
    "rmsnorm_fwd": "a row a team of warps (each thread up to 4 chunks of 8 "
    "elements in bfloat16, 2 in float32, in registers across the row's "
    "sum: a warp butterfly, one barrier, the warps' sums added in order), "
    "8 / warps teams a block taking rows in turn over a grid the card holds "
    "at once, each thread's next row loaded before the current row's sum; "
    "rstd saved",
    "rmsnorm_bwd": "a block a fixed group of rows (at most 264: two blocks "
    "an SM), 8 / warps teams taking the rows in turn, each thread's next "
    "row (x, dy, rstd) in registers before the current row's sum; scale's "
    "column sums in registers, the teams' added in order in shared memory "
    "into the block's partial row; a finish adding the partials in block "
    "order over 32 slices (no atomics)"}
#: flops an element (the products, sums and 1 + scale; rsqrt and the
#: division once a row): bytes bind both
RMSNORM_FLOPS = {"rmsnorm_fwd": 5, "rmsnorm_bwd": 11}


def rmsnorm_registers(ptxas: dict, kernel: str, dtype: str,
                      launch: dict, vector: bool) -> int:
    """The registers ptxas gave the instantiation ``launch`` (``launch_of``)
    runs: (chunks, 8) on the vector path, (16, 1) on the scalar one."""
    key = (f"{kernel}_kernel", dtype,
           (launch["chunks"], 8) if vector else (launch["chunks"], 1))
    return ptxas[key][0]


def rmsnorm_case(gen, rows: int, d: int, dtype) -> tuple:
    """One case of phase "2 rmsnorm": both kernels against their plain
    versions on the same inputs (the backward on the kernel forward's
    rstd), twice for the same bits, and scale's gradient against a float64
    sum of the kernel's own float32 products (x_hat = x rstd, dy x_hat, as
    the kernel rounds them).  Returns (the errors and bits, the
    operands)."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    dev = gen.device
    x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    scale = (0.1 * torch.randn((d,), generator=gen, device=dev)).to(dtype)
    dy = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    y, r = rn.rmsnorm_fwd(x, scale)
    y2, r2 = rn.rmsnorm_fwd(x, scale)
    yp, rp = rn.rmsnorm_fwd(x, scale, use_kernel=False)
    dx, ds = rn.rmsnorm_bwd(dy, x, scale, r)
    dx2, ds2 = rn.rmsnorm_bwd(dy, x, scale, r)
    dxp, dsp = rn.rmsnorm_bwd(dy, x, scale, r, use_kernel=False)
    ds64 = (dy.float() * (x.float() * r[:, None])).double().sum(0)
    tol = RMSNORM_TOL[str(dtype).split(".")[-1]]
    res = {"errs": {"y": rel_err(y, yp), "rstd": rel_err(r, rp),
                    "dx": rel_err(dx, dxp), "dscale": rel_err(ds, dsp),
                    "dscale_f64": rel_err(ds.double(), ds64)},
           "y_diff_share": float((y != yp).float().mean()),
           "dx_diff_share": float((dx != dxp).float().mean()),
           "same_bits": {"rmsnorm_fwd": torch.equal(y, y2) and
                         torch.equal(r, r2),
                         "rmsnorm_bwd": torch.equal(dx, dx2) and
                         torch.equal(ds, ds2)},
           "tol": tol}
    res["ok"] = (res["errs"]["y"] <= tol and res["errs"]["dx"] <= tol and
                 all(res["errs"][k] <= RMSNORM_F32_TOL
                     for k in ("rstd", "dscale", "dscale_f64")) and
                 all(res["same_bits"].values()))
    return res, (x, scale, dy, r)


def rmsnorm_times(ops, card) -> dict:
    """Each kernel's device time (:func:`queued_ms`) beside its plain
    version's, ``torch.nn.functional.rms_norm``'s (weight ``1 + scale``
    in the model's dtype; its backward through autograd, x's and the
    weight's gradients) and its byte bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    x, scale, dy, r = ops
    rows, d = x.shape
    w = (1.0 + scale.float()).to(x.dtype)
    xg, wg = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    yl = F.rms_norm(xg, (d,), wg, rn.EPS)
    calls = {
        "rmsnorm_fwd": (lambda k: rn.rmsnorm_fwd(x, scale, use_kernel=k),
                        lambda: F.rms_norm(x, (d,), w, rn.EPS)),
        "rmsnorm_bwd": (lambda k: rn.rmsnorm_bwd(dy, x, scale, r,
                                                 use_kernel=k),
                        lambda: torch.autograd.grad(yl, (xg, wg), dy,
                                                    retain_graph=True))}
    rows_out = {}
    for name, (call, lib) in calls.items():
        nbytes = rn.rmsnorm_bytes(rows, d, x.dtype, name)
        flops = RMSNORM_FLOPS[name] * rows * d
        vector = d % 8 == 0
        launch = rn.launch_of(name, x.dtype, d, rows, vector)
        launch["waves"] = launch["blocks"] / (launch["blocks_per_sm"] *
                                              card.sms)
        rows_out[name] = {"kernel_ms": queued_ms(lambda: call(True),
                                                 TIME_REPS),
                          "plain_ms": queued_ms(lambda: call(False), 3),
                          "library_ms": queued_ms(lib, TIME_REPS),
                          "bytes": nbytes, "launch": launch,
                          "vector": vector,
                          **bound(flops, nbytes, card.fp32_flops, card)}
    return rows_out


def check_rmsnorm(card, ptxas: dict) -> dict:
    """Phase "2 rmsnorm": the block norm's two kernels against their plain
    versions at RMSNORM_WIDTHS x RMSNORM_ROWS in bfloat16 and float32 (y
    and dx within RMSNORM_TOL normwise; rstd, scale's gradient and its
    float64 sum within RMSNORM_F32_TOL; two calls the same bits), each
    case of RMSNORM_TIMED timed beside its plain version,
    ``F.rms_norm`` and its byte bound, with its launch (threads, blocks,
    blocks an SM, waves) and registers.  Returns the rows; the kernels
    line reads RMSNORM_MAIN."""
    import gc
    import torch
    gen = torch.Generator(device="cuda").manual_seed(34)
    cases, failed, timed = {}, [], {}
    worst = {"rmsnorm_fwd": 0.0, "rmsnorm_bwd": 0.0}
    for d in RMSNORM_WIDTHS:
        for rows in RMSNORM_ROWS:
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[-1]
                key = f"{d} x {rows} {dn}"
                res, ops = rmsnorm_case(gen, rows, d, dtype)
                cases[key] = res
                e = res["errs"]
                worst["rmsnorm_fwd"] = max(worst["rmsnorm_fwd"], e["y"])
                worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"], e["dx"])
                if not res["ok"]:
                    failed.append((key, res))
                log(f"  {key}: y {e['y']:.2e} (differ "
                    f"{100 * res['y_diff_share']:.3f} %), rstd "
                    f"{e['rstd']:.2e}, dx {e['dx']:.2e} (differ "
                    f"{100 * res['dx_diff_share']:.3f} %), dscale "
                    f"{e['dscale']:.2e}, of float64 {e['dscale_f64']:.2e}; "
                    f"same bits twice: {all(res['same_bits'].values())}")
                if (rows, dn) in RMSNORM_TIMED:
                    t = timed[key] = rmsnorm_times(ops, card)
                    for k, v in t.items():
                        v["registers"] = rmsnorm_registers(
                            ptxas, k, dn, v["launch"], v["vector"])
                    log("    times: " + "; ".join(
                        f"{k} {v['kernel_ms']:.4f} ms (plain "
                        f"{v['plain_ms']:.4f}, F.rms_norm "
                        f"{v['library_ms']:.4f}, bound {v['bound_ms']:.4f}, "
                        f"{100 * v['bound_ms'] / v['kernel_ms']:.1f} % of the"
                        f" bound; {v['launch']['threads']} threads x "
                        f"{v['launch']['blocks']} blocks, "
                        f"{v['launch']['blocks_per_sm']} an SM, "
                        f"{v['launch']['waves']:.2f} waves, "
                        f"{v['registers']} registers)"
                        for k, v in t.items()))
                del ops
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the norm's kernels disagree with their plain "
                             f"versions: {failed}")
    main = timed[RMSNORM_MAIN]
    return {"cases": cases, "timed": timed,
            "kernels": {k: {**main[k], "err": worst[k]}
                        for k in RMSNORM_KERNELS}}


def norm_launches() -> dict:
    """The block norm's two kernel wrappers' launch counts, by name."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_fwd
    return {"rmsnorm_fwd": rmsnorm_fwd.launches,
            "rmsnorm_bwd": rmsnorm_bwd.launches}


def norm_want(cfg, steps: int) -> dict:
    """What ``steps`` train steps of ``cfg`` launch: under per-period remat
    each block norm (every block's ln1, and its ln2 before an FFN) runs
    twice forward and once backward a step, the final norm once each."""
    n = sum(1 + (spec.ffn != "none") for spec in cfg.layer_specs())
    return {"rmsnorm_fwd": steps * (2 * n + 1),
            "rmsnorm_bwd": steps * (n + 1)}


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

    import torch
    from repro_torch.kernels.matmul import matmul_route

    session = PredictorSession(repetitions=TILE_PASSES)
    ds = session.device_suite(device=dev)
    legal = legal_candidates(N, N, N, smem_limit=ds.smem_limit)
    per_route = {r: [c for c in legal
                     if matmul_route(torch.float32, *c) == r]
                 for r in ("wgmma", "ffma")}
    log(f"  {len(legal)} legal float32 tiles, the union of both routes: " +
        "; ".join(f"{r} {len(c)}: {c}" for r, c in per_route.items()))
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
            "legal_by_route": per_route, "ranked": ranked,
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
    from repro_torch.kernels.matmul import matmul, matmul_plain, matmul_route

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
    res["route"] = matmul_route(torch.float32, *res["choice"])
    res["best_route"] = matmul_route(torch.float32, *res["best"])
    res["within_best"] = res["meas_ms"] / res["best_ms"] - 1.0
    log(f"  the selected tile {res['choice']} runs on the {res['route']} "
        f"route, rank {res['rank_of_choice']} of {res['n_legal']}, "
        f"{100 * res['within_best']:.1f} % above the measured best "
        f"{res['best']} ({res['best_route']}), tau {res['tau']:.3f}")
    by_route = {r: min((c for c in meas if matmul_route(torch.float32, *c)
                        == r), key=lambda c: (meas[c], c))
                for r in ("wgmma", "ffma")}
    res["fastest_by_route"] = {r: {"config": list(c), "ms": meas[c]}
                               for r, c in by_route.items()}
    log("  fastest a route: " + ", ".join(
        f"{r} {c} {meas[c]:.3f} ms" for r, c in by_route.items()))
    log(f"  analytic oracle picks {analytic} "
        f"({matmul_route(torch.float32, *analytic)}, {meas[analytic]:.2f} "
        f"ms measured)")
    (OUT / "tiles_4096.json").write_text(json.dumps(res["rows"], indent=1))
    res.update(x=x, y=y, plain=plains[res["choice"][2]], analytic=analytic)
    return res


def matmul_rows(tiles: dict, card) -> dict:
    """Phase 5: the matmul at 4096^3 in float32 at phase 4's selected tile
    and in bfloat16 at the fastest of a short sweep of its wgmma tiles,
    each called twice for the same bits and timed beside its plain
    version, ``torch.matmul`` (TF32 off; bfloat16) and its route's bound
    (float32 on wgmma: three TF32 products at the TF32 rate, the FFMA
    bound beside it; on ffma the FP32 rate; bfloat16 the bf16 rate)."""
    import torch
    from repro_torch.kernels.matmul import (WGMMA_TILES, matmul,
                                            matmul_plain, matmul_route)

    x, y = tiles.pop("x"), tiles.pop("y")
    plain = tiles.pop("plain")
    rows = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        a, b = x.to(dtype), y.to(dtype)
        sweep = {}
        if name == "float32":
            cfg = tuple(tiles["choice"])
            ref = plain
        else:
            for c in WGMMA_TILES[dtype]:
                sweep[c] = event_ms(lambda: matmul(a, b, bm=c[0], bn=c[1],
                                                   bk=c[2]), 3)
            cfg = min(sweep, key=lambda c: (sweep[c], c))
            ref = matmul_plain(a, b, bm=N, bn=N, bk=cfg[2]).float()
        bm, bn, bk = cfg
        route = matmul_route(dtype, *cfg)
        out = matmul(a, b, bm=bm, bn=bn, bk=bk)
        again = matmul(a, b, bm=bm, bn=bn, bk=bk)
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        if name == "float32":
            reading, limit = err, BIG_TOL * float(ref.abs().max())
            rule = f"max_abs_err <= {BIG_TOL} x max |plain|"
        else:
            reading = float((diff / (2e-2 + 2e-2 * ref.abs())).max())
            limit, rule = 1.0, "max |diff| / (2e-2 + 2e-2 |plain|) <= 1"
        del out, again, ref
        if not (same and reading <= limit):
            raise AssertionError(f"matmul 4096^3 {name} at {cfg}: reading "
                                 f"{reading:.3e} (limit {limit:.3e}, "
                                 f"{rule}), same bits {same}")
        kernel_ms = event_ms(lambda: matmul(a, b, bm=bm, bn=bn, bk=bk),
                             TIME_REPS)
        plain_ms = event_ms(lambda: matmul_plain(a, b, bm=bm, bn=bn, bk=bk),
                            TIME_REPS)
        library_ms = event_ms(lambda: torch.matmul(a, b), TIME_REPS)
        flops, nbytes = 2.0 * N ** 3, a.element_size() * 3.0 * N * N
        ffma = bound(flops, nbytes, card.fp32_flops, card)
        if route == "ffma":
            bd = ffma
        elif name == "float32":
            bd = bound(3 * flops, nbytes, card.tf32_tensor_flops, card)
        else:
            bd = bound(flops, nbytes, card.bf16_tensor_flops, card)
        rows[name] = {"config": list(cfg), "route": route, "err": err,
                      "reading": reading, "same_bits": same,
                      "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms,
                      "tflops": flops / kernel_ms / 1e9,
                      "bound_ms_ffma": ffma["bound_ms"], **bd,
                      "sweep_ms": {f"{c[0]}x{c[1]}x{c[2]}": t
                                   for c, t in sweep.items()}}
        if sweep:
            log(f"  bfloat16 wgmma tiles at 4096^3: " + ", ".join(
                f"{c} {t:.3f}" for c, t in sweep.items()) +
                f" ms; fastest {cfg}")
        log(f"    matmul 4096^3 {name} at {cfg} on {route}: kernel_ms "
            f"{kernel_ms:.3f}, plain_ms {plain_ms:.3f}, library_ms "
            f"{library_ms:.3f} (torch.matmul), bound_ms "
            f"{bd['bound_ms']:.3f} ({bd['bound_by']}; FFMA "
            f"{ffma['bound_ms']:.3f}); {rows[name]['tflops']:.1f} TFLOP/s;"
            f" {rule}: {reading:.3e}; two calls the same bits")
        del a, b
    return rows


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
def check_attention(card, sass_run) -> dict:
    """Flash attention against its plain version: the reference tests'
    cases; every instantiated (bq, bkv, d) in both dtypes on a small shape,
    so both routes in both of their dtypes; a config no route takes
    refused; then gemma2-27b's local and global layers at 8192 tokens in
    both dtypes on the routes the models take (bfloat16 also on the
    mma.sync route), each timed beside its bound; and the SASS gate of the
    forward's routes (check_fwd_sass)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (
        ATTN_ROUTES, KERNEL_BLOCKS, KERNEL_HEAD_DIMS, attn_grid_steps,
        attn_route, flash_attention, flash_attention_fwd,
        flash_attention_plain)

    rng = np.random.default_rng(7)
    gates = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

    def operands(shapes, dtype):
        return [torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to("cuda", dtype) for sh in shapes]

    for hq, hkv, sl, d, kw in ATTN_CASES:
        for dtype, tol in gates.items():
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
    # every instantiation: both routes, both dtypes, every head dim, two
    # masks, against the plain version at the same kv block (output at the
    # cases' elementwise gate, lse within 1e-5 (1 + |plain|)); the plain
    # loop over every query row at once, which the blocks the kernel skips
    # leave exact
    counts = flash_attention.route_launches
    worst = {}
    for dtype, tol in gates.items():
        for d in KERNEL_HEAD_DIMS:
            q, k, v = operands(((2, 4, 256, d), (2, 2, 256, d),
                                (2, 2, 256, d)), dtype)
            for bkv in KERNEL_BLOCKS:
                for kw in (dict(causal=True, window=96, softcap=20.0),
                           dict(causal=False)):
                    ref, ref_lse = flash_attention_plain(
                        q, k, v, bkv=bkv, return_lse=True, **kw)
                    for bq in KERNEL_BLOCKS:
                        route = attn_route(dtype, bq, bkv, d)
                        before = dict(counts)
                        out, lse = flash_attention_fwd(q, k, v, bq=bq,
                                                       bkv=bkv, **kw)
                        torch.cuda.synchronize()
                        took = [r for r in ATTN_ROUTES
                                if counts[r] != before[r]]
                        ratio = float(((out.float() - ref.float()).abs() /
                                       (tol + tol * ref.float().abs())).max())
                        lse_ratio = float(((lse - ref_lse).abs() / (
                            1e-5 + 1e-5 * ref_lse.abs())).max())
                        if took != [route] or not (ratio <= 1.0 and
                                                   lse_ratio <= 1.0):
                            raise AssertionError(
                                f"flash_attention at ({bq}, {bkv}), d {d}, "
                                f"{dtype}, {kw}: route {took} (table "
                                f"{route}), ratio {ratio:.3f}, lse ratio "
                                f"{lse_ratio:.3f} (bounds 1)")
                        key = f"{route}/{str(dtype)[6:]}"
                        worst[key] = max(worst.get(key, 0.0), ratio)
    log(f"  every (bq, bkv, d) in {KERNEL_BLOCKS}^2 x {KERNEL_HEAD_DIMS} in "
        f"both dtypes, (2, 4, 2, 256, d), causal with window 96 and softcap "
        f"20 and unmasked: each on its route, within the cases' gates; "
        f"worst max |diff| / (tol + tol |plain|) by route: " +
        ", ".join(f"{k} {v:.3f}" for k, v in sorted(worst.items())))
    if sorted(worst) != ["mma_sync/bfloat16", "mma_sync/float32",
                         "wgmma/bfloat16"]:
        raise AssertionError(f"the routes checked are {sorted(worst)}")
    # the library's route table (route_of, at the padded head dim the
    # wrapper passes) is attn_route's, also where neither routes
    import ctypes
    from repro_torch.kernels import _build
    lib_route = _build.load("flash_attention").repro_flash_attention_route
    lib_route.argtypes = [ctypes.c_int] * 4
    names = {0: None, 1: "wgmma", 2: "mma_sync"}
    blocks = (8,) + KERNEL_BLOCKS + (256,)
    differ = [(str(dtype)[6:], bq, bkv, d)
              for code, dtype in enumerate(gates) for bq in blocks
              for bkv in blocks for d in KERNEL_HEAD_DIMS + (256,)
              if names[lib_route(code, bq, bkv, d)] !=
              attn_route(dtype, bq, bkv, d)]
    if differ:
        raise AssertionError(f"the library's route table differs from "
                             f"attn_route at {differ}")
    q, k, v = operands(((1, 2, 512, 128),) * 3, torch.bfloat16)
    try:
        flash_attention(q, k, v, bq=256, bkv=128)
    except ValueError as e:
        if "route table" not in str(e):
            raise
        log(f"  blocks (256, 128) refused: {str(e)[:90]}...")
    else:
        raise AssertionError("a config no route takes was launched")

    rows = []
    hq, hkv, d, cap = GEMMA["hq"], GEMMA["hkv"], GEMMA["d"], GEMMA["softcap"]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = operands(((1, hq, GEMMA_S, d), (1, hkv, GEMMA_S, d),
                            (1, hkv, GEMMA_S, d)), dtype)
        name = str(dtype)[6:]
        # the models' blocks, and in bfloat16 also the mma.sync route at
        # the same kv block (so the same rounding of p)
        blocks = [(128, 128)] + ([(32, 128)] if dtype == torch.bfloat16
                                 else [])
        for window in GEMMA["windows"]:
            kw = dict(causal=True, window=window, softcap=cap)
            layer = "local" if window else "global"
            ref = flash_attention_plain(q, k, v, bkv=128, **kw)
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
            plain_ms = event_ms(lambda: flash_attention_plain(
                q, k, v, bkv=128, **kw), 3)
            bd = attn_fwd_bound(1, hq, hkv, GEMMA_S, d, True, window, dtype,
                                card, softcap=cap)
            for bq, bkv in blocks:
                route = attn_route(dtype, bq, bkv, d)
                out = flash_attention(q, k, v, bq=bq, bkv=bkv, **kw)
                torch.cuda.synchronize()
                err = rel_err(out, ref)
                max_abs = float((out.float() - ref.float()).abs().max())
                if not err <= WIDE_TOL[name]:
                    raise AssertionError(
                        f"flash_attention ({route}) disagrees with its "
                        f"plain version on gemma2-27b's {layer} layer "
                        f"({name}): normwise {err:.3e} above "
                        f"{WIDE_TOL[name]:.3e}")
                del out
                ms = event_ms(lambda: flash_attention(q, k, v, bq=bq,
                                                      bkv=bkv, **kw), 3)
                visits = attn_grid_steps(1, hq, GEMMA_S, GEMMA_S, bq, bkv,
                                         causal=True, window=window)
                log(f"  gemma2-27b {layer} layer (window {window}), "
                    f"s={GEMMA_S}, {name}, blocks ({bq}, {bkv}) on the "
                    f"{route} route, visits {visits} kv blocks: normwise "
                    f"{err:.3e} (bound {WIDE_TOL[name]:.3e}), max_abs_err "
                    f"{max_abs:.3e}; kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms "
                    f"({bd['bound_terms']})")
                rows.append({"layer": layer, "window": window, "dtype": name,
                             "s": GEMMA_S, "blocks": [bq, bkv],
                             "route": route, "visited_blocks": visits,
                             "normwise": err, "max_abs_err": max_abs,
                             "unrounded_p_normwise": fault, "kernel_ms": ms,
                             "plain_ms": plain_ms, **bd})
            del ref
        del q, k, v
    return {"gemma2_27b": rows, "routes_worst_ratio": worst,
            "fwd_sass": check_fwd_sass(sass_run)}


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


#: the SSD forward's instantiations its SASS gate reads: the wgmma route's
#: at mamba2-2.7b's (P, N) (its C B^T pre-pass at N), the mma.sync route's
#: at that (P, N) and chunk 32 (R = 32; route 1 takes R = 64 there, and
#: mma.sync's R = 64 kernel is not built at it)
SSD_MAIN_KEY = (64, 128)
SSD_SYNC_KEY = (64, 128, 32)


def check_ssd_sass(sass_run) -> dict:
    """The SASS gate of the SSD forward (``sass_run`` from
    :func:`start_sass` on its library).  The wgmma route's chunk-state,
    C B^T and chunk-scan kernels at SSD_MAIN_KEY hold HGMMA and fewer than
    64 FFMA an HGMMA: an m64n64k8 HGMMA is 32,768 multiply-adds, 256 FFMA
    in each of the four warps that issue it, three a 3xTF32 product, so an
    FFMA product loop cannot pass.  The mma.sync route's chunk state at
    SSD_MAIN_KEY and chunk scan at SSD_SYNC_KEY hold HMMA and fewer than
    two FFMA an HMMA (the same products on FFMA would take about 11 an
    HMMA: an m16n8k8 is 1,024 multiply-adds, 32 FFMA a warp); the FFMA
    left are the exps' range reductions.  mma.sync's chunk scan at
    (64, 128, 64) is not built."""
    hgmma, hmma = hmma_counts(sass_run, "HGMMA"), hmma_counts(sass_run)
    ffma = hmma_counts(sass_run, "FFMA")

    def one(kern, key):
        tag = "I" + "".join(f"Li{c}E" for c in key) + "E"
        names = [k for k in hmma if kern in k and tag in k]
        if len(names) != 1:
            raise AssertionError(f"no single SASS function for {kern} at "
                                 f"{key}: {names}")
        return names[0]

    p, n = SSD_MAIN_KEY
    found, ok = {}, True
    for kern, key in (("ssd_chunk_state_wgmma_kernel", (p, n)),
                      ("ssd_cb_wgmma_kernel", (n,)),
                      ("ssd_chunk_scan_wgmma_kernel", (p, n))):
        name = one(kern, key)
        found[f"{kern}<{','.join(map(str, key))}>"] = v = {
            "HGMMA": hgmma[name], "FFMA": ffma[name]}
        ok &= 0 < v["HGMMA"] and v["FFMA"] < 64 * v["HGMMA"]
    for kern, key in (("ssd_chunk_state_kernel", (p, n)),
                      ("ssd_chunk_scan_kernel", SSD_SYNC_KEY)):
        name = one(kern, key)
        found[f"{kern}<{','.join(map(str, key))}>"] = v = {
            "HMMA": hmma[name], "FFMA": ffma[name]}
        ok &= 0 < v["HMMA"] and v["FFMA"] < 2 * v["HMMA"]
    gone = [k for k in hmma if "ssd_chunk_scan_kernel" in k
            and f"ILi{p}ELi{n}ELi64EE" in k]
    log(f"  SSD forward SASS: wgmma route at (P, N) = {SSD_MAIN_KEY}, "
        f"mma.sync at {SSD_MAIN_KEY} / {SSD_SYNC_KEY}: {found}; mma.sync's "
        f"chunk scan at (64, 128, 64) built: {bool(gone)} (cuobjdump -sass)")
    if not ok or gone:
        raise AssertionError(f"the SSD forward's SASS lacks its tensor-core "
                             f"products, or holds mma.sync's (64, 128, 64) "
                             f"scan: {found}, {gone}")
    return found


def check_ssd_routes() -> dict:
    """The forward library's route table (``repro_ssd_route``), staging
    (``repro_ssd_smem_bytes``) and C B^T scratch (``repro_ssd_cb_floats``)
    against ``ssd_route``, ``ssd_smem_bytes`` and ``ssd_cb_floats`` at
    every instantiated (P, N) and more, chunks 8 to 4096."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import (KERNEL_HEAD_DIMS, KERNEL_STATES,
                                         ssd_cb_floats, ssd_route,
                                         ssd_smem_bytes)
    lib = _build.load("ssd")
    lib.repro_ssd_route.argtypes = [ctypes.c_int] * 3
    lib.repro_ssd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.repro_ssd_smem_bytes.restype = ctypes.c_longlong
    lib.repro_ssd_cb_floats.argtypes = [ctypes.c_int] * 6
    lib.repro_ssd_cb_floats.restype = ctypes.c_longlong
    names = {0: None, 1: "wgmma", 2: "mma_sync"}
    grid = [(p, n, chunk) for p in KERNEL_HEAD_DIMS + (128,)
            for n in KERNEL_STATES + (256,)
            for chunk in (8, 16, 32, 48, 64, 96, 128, 256, 512, 4096)]
    table = {k: names[lib.repro_ssd_route(*k)] for k in grid}
    differ = [k for k in grid if table[k] != ssd_route(*k)]
    differ += [k for k in grid if table[k] and (
        lib.repro_ssd_smem_bytes(*k) != ssd_smem_bytes(k[2], k[0], k[1]) or
        lib.repro_ssd_cb_floats(2, 8192, 3, *k) !=
        ssd_cb_floats(2, 8192, 3, *k))]
    if differ:
        raise AssertionError(f"the SSD forward library's route table, "
                             f"staging or scratch differ from ssd_route / "
                             f"ssd_smem_bytes / ssd_cb_floats at {differ}")
    counts = {r: sum(v == r for v in table.values())
              for r in ("wgmma", "mma_sync", None)}
    log(f"  SSD forward route table: the library's equals ssd_route at "
        f"{len(grid)} (P, N, chunk), and its staging and C B^T scratch "
        f"ssd_smem_bytes' and ssd_cb_floats': {counts}")
    return {"configs": len(grid), "routes": counts}


def check_ssd(card, sass_run) -> dict:
    """The SSD kernel against its plain version and the sequential oracle
    on the reference test's cases and on SSD_ROUTE_CASES (each on its
    route), then against its plain version at mamba2-2.7b's width, timed
    beside its bound, and at jamba-v0.1-52b's; then its route table
    (:func:`check_ssd_routes`) and SASS gate (:func:`check_ssd_sass`)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd import ssd, ssd_plain, ssd_route

    rng = np.random.default_rng(7)
    tol = 2e-4
    routes = {}
    for case in SSD_CASES + SSD_ROUTE_CASES:
        l, h, p, g, n, chunk = case[:6]
        ops = ssd_inputs((2, l, h, p, g, n), rng, model_like=True)
        before = dict(ssd.route_launches)
        out = ssd(*ops, chunk=chunk)
        torch.cuda.synchronize()           # a fault surfaces here
        took = [r for r, k in ssd.route_launches.items() if k != before[r]]
        want = case[6] if len(case) > 6 else ssd_route(p, n, chunk)
        routes[str(case[:6])] = took
        if took != [want]:
            raise AssertionError(f"ssd at {case[:6]} took {took}, not "
                                 f"{want}")
        for what, ref in (("plain", ssd_plain(*ops, chunk=chunk)),
                          ("ssd_ref", ssd_ref(*ops))):
            diff = (out - ref).abs()
            ratio = float((diff / (tol + tol * ref.abs())).max())
            log(f"  ssd l={l} h={h} p={p} g={g} n={n} chunk={chunk} "
                f"({want}) vs {what}: max_abs_err {float(diff.max()):.3e}, "
                f"max |diff| / ({tol} + {tol} |{what}|) {ratio:.3f} "
                f"(bound 1)")
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
    bd = bwd_bound(flops, nbytes, torch.float32, card)
    log(f"  mamba2-2.7b SSD {SSD_PROBLEM}, chunk {chunk} "
        f"({ssd_route(SSD_PROBLEM[3], SSD_PROBLEM[5], chunk)}), model-like "
        f"dt and a_log: normwise {err:.3e} (bound "
        f"{WIDE_TOL['float32']:.0e}), max_abs_err {max_abs:.3e} (max |plain|"
        f" {float(ref.abs().max()):.1f}); kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']}, {bd['bound_terms']})")
    del ops, out, ref, y_s, y_h, ref_y_h
    # jamba-v0.1-52b's width at its chunk, on the wgmma route
    ops = ssd_inputs(MOE_SSD_PROBLEM, rng, model_like=True)
    before = ssd.route_launches["wgmma"]
    out = ssd(*ops, chunk=SSD_MODEL_CHUNK)
    torch.cuda.synchronize()
    ref = ssd_plain(*ops, chunk=SSD_MODEL_CHUNK)
    jamba = {"chunk": SSD_MODEL_CHUNK, "normwise": rel_err(out, ref),
             "max_abs_err": float((out - ref).abs().max()),
             "route": "wgmma" if ssd.route_launches["wgmma"] > before
             else "mma_sync"}
    log(f"  jamba-v0.1-52b SSD {MOE_SSD_PROBLEM}, chunk {SSD_MODEL_CHUNK} "
        f"({jamba['route']}): normwise {jamba['normwise']:.3e} (bound "
        f"{WIDE_TOL['float32']:.0e}), max_abs_err {jamba['max_abs_err']:.3e}")
    if not (jamba["normwise"] <= WIDE_TOL["float32"] and
            jamba["route"] == "wgmma"):
        raise AssertionError(f"ssd at jamba-v0.1-52b's width: {jamba}")
    del ops, out, ref
    return {"mamba2_2_7b": {"chunk": chunk, "normwise": err,
                            "state_normwise": state_errs,
                            "max_abs_err": max_abs, "kernel_ms": ms,
                            "plain_ms": plain_ms, **bd},
            "jamba_v0_1_52b": jamba, "case_routes": routes,
            "ssd_routes": check_ssd_routes(),
            "ssd_sass": check_ssd_sass(sass_run)}


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
    selected one beside its plain version and PyTorch's SDPA (TF32 off);
    then every legal block in bfloat16 (:func:`bf16_blocks`)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (attn_grid_steps,
                                                     attn_route,
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
    bd = attn_fwd_bound(b, h, h, sq, d, True, 0, torch.float32, card)
    steps = attn_grid_steps(b, h, sq, skv, bq, bkv)
    grid = b * h * (sq // bq) * (skv // bkv)
    log(f"  attention {ATTN_PROBLEM} causal f32 at the selected "
        f"({bq}, {bkv}) on the {attn_route(torch.float32, bq, bkv, d)} "
        f"route, visiting {steps} of {grid} kv blocks (normwise "
        f"{skip_err:.1e} from the plain loop over them): kernel_ms "
        f"{kernel_ms:.3f}, plain_ms {plain_ms:.3f}, "
        f"library_ms {library_ms:.3f} (SDPA, normwise {lib_err:.1e} from "
        f"the plain version), bound_ms {bd['bound_ms']:.3f} "
        f"({bd['bound_terms']}); {bd['flops'] / kernel_ms / 1e9:.1f} "
        f"TFLOP/s on the kept pairs")
    res.update(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               library_normwise=lib_err, visited_blocks=steps,
               skip_normwise=skip_err,
               route=attn_route(torch.float32, bq, bkv, d), **bd)
    res["bfloat16_blocks"] = bf16_blocks(q, k, v, card)
    return res


def bf16_blocks(q, k, v, card) -> dict:
    """Phase 7 in bfloat16: every legal (bq, bkv) at ATTN_PROBLEM causal,
    held against the plain version at its bkv (WIDE_TOL normwise), then
    timed three times each and ranked by the median; the block attn_blocks
    picks, its rank, and whether another is faster by more than the run's
    spread (the largest max - min over the blocks)."""
    import torch
    from repro_torch.kernels.flash_attention import (attn_route,
                                                     attn_tile_legal,
                                                     flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models.attention import attn_blocks
    b, h, sq, skv, d = ATTN_PROBLEM
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    times, errs = {}, {}
    for bkv in ATTN_BLOCKS:
        ref = flash_attention_plain(qb, kb, vb, bkv=bkv)
        for bq in ATTN_BLOCKS:
            if attn_tile_legal(sq, skv, bq, bkv, d, limit, torch.bfloat16):
                errs[(bq, bkv)] = rel_err(flash_attention(
                    qb, kb, vb, bq=bq, bkv=bkv), ref)
        del ref
    bad = {c: e for c, e in errs.items() if not e <= WIDE_TOL["bfloat16"]}
    if bad:
        raise AssertionError(f"bfloat16 attention at {ATTN_PROBLEM} causal "
                             f"disagrees with its plain version at blocks "
                             f"{bad} (normwise, bound "
                             f"{WIDE_TOL['bfloat16']:.3e})")
    for bq, bkv in errs:
        times[(bq, bkv)] = [event_ms(lambda: flash_attention(
            qb, kb, vb, bq=bq, bkv=bkv), 5) for _ in range(3)]
    med = {c: sorted(t)[1] for c, t in times.items()}
    order = sorted(med, key=med.get)
    spread = max(max(t) - min(t) for t in times.values())
    pick = (attn_blocks(sq), attn_blocks(skv))
    rank = order.index(pick) + 1
    beaten = med[pick] - med[order[0]] > spread
    bd = attn_fwd_bound(b, h, h, sq, d, True, 0, torch.bfloat16, card)
    log(f"  attention {ATTN_PROBLEM} causal bfloat16, every legal block "
        f"within {WIDE_TOL['bfloat16']:.3e} of the plain version (worst "
        f"{max(errs.values()):.3e} at {max(errs, key=errs.get)}), median of "
        f"three (ms): " + ", ".join(
            f"{c} {attn_route(torch.bfloat16, *c, d)} {med[c]:.3f}"
            for c in order))
    log(f"  attn_blocks picks {pick} ({med[pick]:.3f} ms): rank {rank} of "
        f"{len(order)}; fastest {order[0]} ({med[order[0]]:.3f} ms); spread "
        f"{spread:.3f} ms; another block faster by more than the spread: "
        f"{beaten}; bound {bd['bound_ms']:.3f} ms ({bd['bound_terms']})")
    return {"times_ms": {f"{c[0]}x{c[1]}": t for c, t in times.items()},
            "median_ms": {f"{c[0]}x{c[1]}": m for c, m in med.items()},
            "normwise": {f"{c[0]}x{c[1]}": e for c, e in errs.items()},
            "pick": list(pick), "pick_rank": rank, "fastest": list(order[0]),
            "spread_ms": spread, "pick_beaten": beaten, **bd}


def finish_ssd(tuned: dict, card) -> dict:
    """Phase 8's checks and the SSD row of the kernels line: every legal
    chunk at mamba2-2.7b's (1, 4096, 80, 64, 1, 128) with the family's
    operands, then the selected one beside its plain version and its
    3xTF32 bound (the FFMA bound beside), each of its three passes timed at
    the selected chunk and at the model's, and the state scratch's
    bytes."""
    import numpy as np
    import torch
    from repro_torch.kernels.ssd import (_launch_chunk_scan,
                                         _launch_chunk_state,
                                         _launch_state_pass, ssd,
                                         ssd_grid_steps, ssd_plain,
                                         ssd_route, ssd_scan_blocks,
                                         ssd_scan_heads, ssd_scratch,
                                         ssd_scratch_bytes, ssd_state_heads)
    ops = ssd_inputs(SSD_PROBLEM, np.random.default_rng(17),
                     model_like=False)

    def run(cfg, plain=False):
        return (ssd_plain if plain else ssd)(*ops, chunk=cfg[0])

    res, meas, _ = check_family("cuda_ssd", tuned, run, lambda cfg: cfg[0],
                                f"{SSD_PROBLEM}")
    chunk = res["choice"][0]
    routes = {cfg: ssd_route(cfg[1], cfg[2], cfg[0]) for cfg in meas}
    fastest = {}
    for cfg, r in routes.items():
        if r not in fastest or meas[cfg] < meas[fastest[r]]:
            fastest[r] = cfg
    res.update(route=routes[res["choice"]],
               routes={str(list(c)): r for c, r in routes.items()},
               fastest_by_route={r: {"config": list(c), "ms": meas[c],
                                     "plain_ms": event_ms(
                                         lambda: run(c, plain=True), 3),
                                     "bound_ms": bwd_bound(*ssd_work(
                                         *SSD_PROBLEM, c[0]), torch.float32,
                                         card)["bound_ms"]}
                                 for r, c in fastest.items()})
    log(f"  the SSD chunk path ranked {len(meas)} chunks over both routes "
        f"({', '.join(f'{c[0]}: {r}' for c, r in sorted(routes.items()))});"
        f" its pick, chunk {chunk}, runs on {res['route']}; the fastest on "
        f"each route (beside the plain version at its chunk): " + ", ".join(
            f"{r} chunk {v['config'][0]} {v['ms']:.3f} ms (plain "
            f"{v['plain_ms']:.3f}, bound {v['bound_ms']:.3f})" for r, v in
            res["fastest_by_route"].items()))
    kernel_ms = event_ms(lambda: ssd(*ops, chunk=chunk), TIME_REPS)
    plain_ms = event_ms(lambda: ssd_plain(*ops, chunk=chunk), TIME_REPS)
    flops, nbytes = ssd_work(*SSD_PROBLEM, chunk)
    bd = bwd_bound(flops, nbytes, torch.float32, card)
    x, dt, a_log, bb, cc = ops
    b, l, h, p, g, n = SSD_PROBLEM
    heads = {"chunk_state": ssd_state_heads(h, g),
             "chunk_scan": ssd_scan_heads(h, g)}

    def passes_at(c):
        s, states = ssd_scratch(x, bb, c)
        y = torch.empty_like(x)
        return dict(zip(("chunk_state", "state_pass", "chunk_scan"), pass_ms(
            [lambda: _launch_chunk_state(x, dt, a_log, bb, s, states, c),
             lambda: _launch_state_pass(s, states, c),
             lambda: _launch_chunk_scan(x, dt, bb, cc, s, states, y, c)],
            TIME_REPS)))

    passes = {c: passes_at(c) for c in sorted({chunk, SSD_MODEL_CHUNK})}
    scratch = ssd_scratch_bytes(b, l, h, p, n, chunk)
    # pass 1 writes the scratch, pass 2 reads and writes it, pass 3 reads it
    scratch_ms = 4 * scratch / card.hbm_bytes_per_s * 1e3
    log(f"  ssd {SSD_PROBLEM} at the selected chunk {chunk}: kernel "
        f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, no library call, "
        f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}, {bd['bound_terms']})")
    for c, ms in passes.items():
        log(f"  ssd passes at chunk {c} ({ssd_route(p, n, c)}), in "
            f"sequence: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ms.items()) +
            f" (sum {sum(ms.values()):.3f}; the chunk scan's with its C B^T "
            f"pre-pass on wgmma); blocks of pass 1 "
            f"{ssd_grid_steps(b, l, h // heads['chunk_state'], c)} "
            f"({heads['chunk_state']} heads a block), of pass 3 "
            f"{ssd_scan_blocks(b, l, h, c, heads['chunk_scan'])} "
            f"({heads['chunk_scan']} heads a block)")
    log(f"  ssd state scratch at chunk {chunk}: {scratch / 1e6:.1f} MB, its "
        f"four passes over HBM {scratch_ms:.3f} ms at "
        f"{card.hbm_bytes_per_s / 1e12:.2f} TB/s")
    res.update(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
               passes_ms=passes[chunk],
               passes_ms_model_chunk=passes[SSD_MODEL_CHUNK], heads=heads,
               scratch_bytes=scratch, scratch_hbm_ms=scratch_ms, **bd)
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
    if "rmsnorm" in low:
        return "rmsnorm"
    if "attn_bwd" in low:
        return "flash_attention_bwd"
    if "attn_sync_kernel" in low or "attn_wgmma_kernel" in low:
        return "flash_attention"
    if "mamba_" in low:
        return "mamba_mixer"
    if "ssd_bwd" in low:
        return "ssd_bwd"
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
    mf = model_flops(cfg, "prefill", batch, s, prefill_ms, card)
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
           "decode_profile": decode_prof, **mf}
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
    log_model_flops(f"{arch} prefill of {batch} x {s}", mf)
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


def attn_bwd_work(b, hq, hkv, s, d, causal, window, itemsize,
                  softcap=0.0):
    """(flops, bytes, MUFU results) the attention backward needs: five
    products of 2 d flops a kept pair (s, dP, dV, dK, dQ: 2.5 times
    attn_work's), q, k, v, o, dO and lse read once and dq, dk, dv written
    once, and FWD_MUFU special-function results a pair (p once: the dQ
    kernel forms it again, a cost of the kernels' design, which
    check_bwd_sass counts beside it)."""
    flops, _, mufu = attn_work(b, hq, hkv, s, d, causal, window, itemsize,
                               softcap)
    nbytes = float(itemsize) * b * s * d * (4 * hq + 4 * hkv) + \
        4.0 * b * hq * s
    return 2.5 * flops, nbytes, mufu


def bwd_bound(flops, nbytes, dtype, card, mufu=0.0) -> dict:
    """A tensor-core kernel's bound on the route it takes (the backwards
    and the SSD forward): bfloat16 products at the tensor
    cores' bfloat16 rate; float32 ones as three TF32 products each at the
    TF32 rate, with the FFMA bound (the FP32 rate outside the tensor cores)
    beside it as ``bound_ms_ffma``; with a MUFU term where ``mufu``
    special-function results are given (the attention backward)."""
    import torch
    if dtype == torch.bfloat16:
        bd = bound(flops, nbytes, card.bf16_tensor_flops, card, mufu)
        bd["bound_terms"] = (f"{flops / 1e9:.1f} GFLOP at "
                             f"{card.bf16_tensor_flops / 1e12:.0f} TFLOP/s")
    else:
        bd = bound(3 * flops, nbytes, card.tf32_tensor_flops, card, mufu)
        bd["bound_ms_ffma"] = bound(flops, nbytes, card.fp32_flops,
                                    card)["bound_ms"]
        bd["bound_terms"] = (f"3xTF32 {3 * flops / 1e9:.1f} GFLOP at "
                             f"{card.tf32_tensor_flops / 1e12:.0f} TFLOP/s;"
                             f" FFMA bound {bd['bound_ms_ffma']:.3f}")
    if mufu:
        bd["bound_terms"] += (f"; MUFU {mufu / 1e9:.2f} G results at "
                              f"{mufu_per_s(card) / 1e12:.2f} T/s "
                              f"{bd['mufu_ms']:.3f} ms; bound by "
                              f"{bd['bound_by']}")
    return bd


def grads_err(got, want) -> dict:
    """Normwise error of each gradient, by the pair's index."""
    return {i: rel_err(g, w) for i, (g, w) in enumerate(zip(got, want))}


def start_sass(lib) -> tuple:
    """``cuobjdump -sass`` of a built library, started in the background
    (it takes tens of seconds, so main starts it after the build) into a
    file under build/; read it with :func:`hmma_counts`."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = ROOT / "build" / "sass" / f"{Path(lib).stem}.sass"
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        proc = subprocess.Popen([str(cuobjdump), "-sass", str(lib)],
                                stdout=f, text=True)
    return proc, out


_SASS = {}


def sass_functions(sass_run) -> dict:
    """{mangled name: SASS text} of each kernel in the library whose SASS
    ``sass_run`` (:func:`start_sass`) writes, read and split once."""
    import re
    proc, out = sass_run
    if out not in _SASS:
        if proc.wait(timeout=300):
            raise AssertionError(f"cuobjdump -sass exited {proc.returncode}")
        parts = re.split(r"Function : (\S+)", out.read_text())
        _SASS[out] = dict(zip(parts[1::2], parts[2::2]))
    return _SASS[out]


def hmma_counts(sass_run, op: str = "HMMA") -> dict:
    """Instructions whose opcode starts with ``op`` (tensor-core HMMA by
    default) in each kernel of the library whose SASS ``sass_run``
    (:func:`start_sass`) writes: {mangled name: count}."""
    import re
    pattern = re.compile(r"\b" + re.escape(op))
    return {name: len(pattern.findall(body))
            for name, body in sass_functions(sass_run).items()}


def sass_registers(sass_run, kernel: str) -> dict:
    """One more than the highest general register (``R<n>``) that the SASS
    of each kernel whose mangled name holds ``kernel`` names, in the
    library whose SASS ``sass_run`` (:func:`start_sass`) writes:
    {mangled name: registers}.  A kernel names registers past its launch
    allocation only after ``setmaxnreg.inc``."""
    import re
    return {name: 1 + max(map(int, re.findall(r"\bR(\d+)\b", body)),
                          default=-1)
            for name, body in sass_functions(sass_run).items()
            if kernel in name}


#: the forward's instantiations the SASS gate reads: the wgmma route's at
#: the models' (bq, bkv, D), bfloat16; the mma.sync route's at float32's
#: (128, 128, 128) and at the serving heads' smallest bfloat16 blocks
WGMMA_MAIN_KEY = (128, 128, 128)
SYNC_MAIN_KEYS = {"float32": (128, 128, 128), "bfloat16": (16, 16, 128)}


def check_fwd_sass(sass_run) -> dict:
    """The forward's SASS gate: HGMMA in the wgmma route's instantiation
    at WGMMA_MAIN_KEY, HMMA in the mma.sync route's at SYNC_MAIN_KEYS in
    both dtypes (``sass_run`` from :func:`start_sass` on the forward's
    library); and the special-function (MUFU) instructions of the wgmma
    kernel, per logit a consumer thread computes in a kv block."""
    def one(counts, kernel, tag, key):
        mangled = "".join(f"Li{c}E" for c in key)
        names = [n for n in counts if kernel in n and f"{tag}{mangled}" in n]
        if len(names) != 1:
            raise AssertionError(f"no single SASS function for {kernel} "
                                 f"{tag} {key}: {names}")
        return counts[names[0]]

    hgmma, hmma = hmma_counts(sass_run, "HGMMA"), hmma_counts(sass_run)
    found = {"wgmma/bfloat16": one(hgmma, "attn_wgmma_kernel", "I",
                                   WGMMA_MAIN_KEY)}
    for dtype, tag in (("float32", "If"),
                       ("bfloat16", "I13__nv_bfloat16")):
        found[f"mma_sync/{dtype}"] = one(hmma, "attn_sync_kernel", tag,
                                         SYNC_MAIN_KEYS[dtype])
    if not all(found.values()):
        raise AssertionError(f"the forward's SASS lacks tensor-core "
                             f"instructions: {found}")
    mufu = {op: one(hmma_counts(sass_run, op), "attn_wgmma_kernel", "I",
                    WGMMA_MAIN_KEY)
            for op in ("MUFU.EX2", "MUFU.RCP", "MUFU.TANH", "MUFU.LG2",
                       "MUFU")}
    logits = WGMMA_MAIN_KEY[1] * 64 // 128   # a consumer thread, a kv block
    per_logit = mufu["MUFU"] / logits
    regs = one(sass_registers(sass_run, "attn_wgmma_kernel"),
               "attn_wgmma_kernel", "I", WGMMA_MAIN_KEY)
    log(f"  forward SASS: HGMMA in the wgmma route at {WGMMA_MAIN_KEY} "
        f"{found['wgmma/bfloat16']}, HMMA in the mma.sync route at "
        f"{SYNC_MAIN_KEYS}: float32 {found['mma_sync/float32']}, bfloat16 "
        f"{found['mma_sync/bfloat16']} (cuobjdump -sass); MUFU in the wgmma "
        f"kernel {mufu}, {per_logit:.2f} per logit of a kv block "
        f"({logits} a consumer thread; the softcap path's ex2 and rcp "
        f"included, FWD_MUFU counts {FWD_MUFU}); its SASS names registers "
        f"R0-R{regs - 1} (past the launch's allocation only after "
        f"setmaxnreg.inc)")
    return {**found, "mufu": mufu, "mufu_per_logit": per_logit,
            "wgmma_sass_registers": regs}


#: the backward's instantiations the SASS gate reads: the mma.sync
#: route's float32 kernels at (warps of 16 rows, D) = (4, 128), block 64;
#: the wgmma route's at the models' bfloat16 config, the dK/dV kernel at D
#: = 128 and the dQ kernel at (block, D) = (128, 128)
BWD_MAIN_KEY = (4, 128)
BWD_WGMMA_KEYS = {"attn_bwd_wgmma_dkdv_kernel": (128,),
                  "attn_bwd_wgmma_dq_kernel": (128, 128)}


def check_bwd_sass(sass_run) -> dict:
    """The backward's SASS gate (``sass_run`` from :func:`start_sass` on
    its library): HGMMA in both wgmma-route kernels at BWD_WGMMA_KEYS,
    HMMA in the float32 mma.sync dK/dV and dQ kernels at BWD_MAIN_KEY;
    and the MUFU instructions of each wgmma kernel per logit a consumer
    thread forms in a 64 x 64 tile (32; the softcap's and the masked
    copies of the pair math included)."""
    def one(counts, kern, tag, key):
        mangled = "".join(f"Li{c}E" for c in key)
        names = [n for n in counts if kern in n and f"{tag}{mangled}" in n]
        if len(names) != 1:
            raise AssertionError(f"no single SASS function for {kern} at "
                                 f"{key}: {names}")
        return counts[names[0]]

    hgmma, hmma = hmma_counts(sass_run, "HGMMA"), hmma_counts(sass_run)
    ops = ("MUFU.EX2", "MUFU.RCP", "MUFU")
    counts = {op: hmma_counts(sass_run, op) for op in ops}
    found, mufu = {}, {}
    for kern, key in BWD_WGMMA_KEYS.items():
        found[f"{kern}/bfloat16"] = one(hgmma, kern, "I", key)
        mufu[kern] = {op: one(counts[op], kern, "I", key) / 32
                      for op in ops}
    for kern in ("attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel"):
        found[f"{kern}/float32"] = one(hmma, kern, "If", BWD_MAIN_KEY)
    if not all(found.values()):
        raise AssertionError(f"the backward's SASS lacks tensor-core "
                             f"instructions: {found}")
    log(f"  backward SASS: HGMMA in the wgmma route's kernels at "
        f"{BWD_WGMMA_KEYS}, HMMA in the mma.sync route's float32 kernels at "
        f"(warps, D) = {BWD_MAIN_KEY}: {found} (cuobjdump -sass); MUFU per "
        f"logit of a 64 x 64 tile, over the four compiled copies of the "
        f"pair math (softcap or not, masked or not): " + "; ".join(
            f"{k} " + ", ".join(f"{op} {v:.2f}" for op, v in c.items())
            for k, c in mufu.items()) +
        f" (FWD_MUFU counts {FWD_MUFU} a kept pair; the dQ kernel forms p "
        f"again)")
    return {**found, "mufu_per_logit": mufu}


def check_attention_bwd(card, sass_run) -> dict:
    """Phase 14a: the backward kernels against the plain backward on the
    same forward output and row statistics (the kernel forward's, whose
    lse is held against the plain forward's first): at every instantiated
    (block, D) of both routes (attn_bwd_route), two masks, both dtypes, on
    a small shape, each call on its route; the library's route table
    against attn_bwd_route, and a config no route takes refused; at
    gemma2-27b's widths over train_4k's 4096 tokens (local and global
    layer, softcap 50, both dtypes, each on its route), each called twice
    and held to the same bits; then timed at ATTN_PROBLEM causal in
    float32 and bfloat16 beside its plain version, its bounds (the route
    it takes, with the MUFU term; float32's FFMA bound beside) and SDPA's
    backward; the forward's bfloat16 time there beside SDPA's; and the
    SASS gate (check_bwd_sass)."""
    import ctypes
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (
        BWD_BLOCKS, BWD_ROUTES, BWD_WGMMA_BLOCKS, KERNEL_HEAD_DIMS,
        attn_bwd_blocks, attn_bwd_route, attn_route, flash_attention,
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_plain)

    rng = np.random.default_rng(19)
    routes = flash_attention_bwd.route_launches

    def operands(b, hq, hkv, s, d, dtype):
        return [torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to("cuda", dtype)
            for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d),
                       (b, hq, s, d))]

    def check(label, q, k, v, do, blk, kw):
        name = str(q.dtype)[6:]
        route = attn_bwd_route(q.dtype, blk, q.shape[3])
        o, lse = flash_attention_fwd(q, k, v, bq=blk, bkv=blk, **kw)
        torch.cuda.synchronize()
        _, plain_lse = flash_attention_plain(q, k, v, bkv=blk, bq=blk,
                                             return_lse=True, **kw)
        lse_ratio = float(((lse - plain_lse).abs() /
                           (1e-5 + 1e-5 * plain_lse.abs())).max())
        before = dict(routes)
        got = flash_attention_bwd(q, k, v, o, lse, do, blk=blk, **kw)
        torch.cuda.synchronize()           # a fault surfaces here
        took = [r for r in BWD_ROUTES if routes[r] != before[r]]
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, bq=blk, **kw)
        errs = dict(zip(("dq", "dk", "dv"), grads_err(got, want).values()))
        max_abs = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
        if not (took == [route] and lse_ratio <= 1.0 and
                max(errs.values()) <= WIDE_TOL[name]):
            raise AssertionError(
                f"flash_attention_bwd disagrees with its plain version at "
                f"{label}: route {took} (table {route}), lse ratio "
                f"{lse_ratio:.3f} (bound 1), normwise {errs} (bound "
                f"{WIDE_TOL[name]:.3e})")
        return errs, max_abs, lse_ratio, route

    small = []
    for dtype in (torch.float32, torch.bfloat16):
        for blk in sorted(set(BWD_BLOCKS + BWD_WGMMA_BLOCKS)):
            for d in KERNEL_HEAD_DIMS:
                if attn_bwd_route(dtype, blk, d) is None:
                    continue
                for kw in (dict(causal=True, window=blk + blk // 2,
                                softcap=50.0),
                           dict(causal=False, window=0, softcap=0.0)):
                    ops = operands(2, 4, 2, 4 * blk, d, dtype)
                    errs, max_abs, lse_ratio, route = check(
                        f"block {blk}, d {d}", *ops, blk, kw)
                    small.append({"blk": blk, "d": d, "route": route,
                                  "dtype": str(dtype)[6:], **kw,
                                  "normwise": errs, "max_abs_err": max_abs,
                                  "lse_ratio": lse_ratio})
    worst = {}
    for r in small:
        key = f"{r['route']}/{r['dtype']}"
        worst[key] = max(worst.get(key, 0.0), max(r["normwise"].values()))
    log(f"  backward kernels at all {len(small)} (block, d, dtype, mask) "
        f"cases of (2, 4, 2, 4 x block, d), each on its route: within "
        f"WIDE_TOL normwise (float32 {WIDE_TOL['float32']:.0e}, bfloat16 "
        f"{WIDE_TOL['bfloat16']:.3e}) and lse within 1e-5 (1 + |plain|); "
        f"worst by route: " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in sorted(worst.items())))
    if sorted(worst) != ["mma_sync/bfloat16", "mma_sync/float32",
                         "wgmma/bfloat16"]:
        raise AssertionError(f"the backward's routes checked are "
                             f"{sorted(worst)}")
    # the library's route table (route_of, at the padded head dim the
    # wrapper passes) is attn_bwd_route's, also where neither routes
    lib_route = _build.load("flash_attention_bwd") \
        .repro_flash_attention_bwd_route
    lib_route.argtypes = [ctypes.c_int] * 3
    names = {0: None, 1: "wgmma", 2: "mma_sync"}
    differ = [(str(dt)[6:], blk, d)
              for code, dt in enumerate((torch.float32, torch.bfloat16))
              for blk in (16, 32, 64, 128, 256)
              for d in KERNEL_HEAD_DIMS + (256,)
              if names[lib_route(code, blk, d)] != attn_bwd_route(dt, blk, d)]
    if differ:
        raise AssertionError(f"the library's backward route table differs "
                             f"from attn_bwd_route at {differ}")
    q, k, v, do = operands(1, 2, 2, 256, 128, torch.float32)
    o, lse = flash_attention_fwd(q, k, v)
    try:
        flash_attention_bwd(q, k, v, o, lse, do, blk=128)
    except ValueError as e:
        if "route table" not in str(e):
            raise
        log(f"  float32 backward at block 128 refused: {str(e)[:100]}...")
    else:
        raise AssertionError("a backward config no route takes was launched")
    del q, k, v, do, o, lse

    wide = []
    hq, hkv, d, cap = GEMMA["hq"], GEMMA["hkv"], GEMMA["d"], GEMMA["softcap"]
    for dtype in (torch.float32, torch.bfloat16):
        ops = operands(1, hq, hkv, TRAIN_SEQ, d, dtype)
        name = str(dtype)[6:]
        blk = attn_bwd_blocks(TRAIN_SEQ, dtype, d)
        for window in GEMMA["windows"]:
            kw = dict(causal=True, window=window, softcap=cap)
            layer = "local" if window else "global"
            errs, max_abs, lse_ratio, route = check(
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
            flops, nbytes, mufu = attn_bwd_work(
                1, hq, hkv, TRAIN_SEQ, d, True, window, q.element_size(),
                cap)
            bd = bwd_bound(flops, nbytes, dtype, card, mufu)
            log(f"  gemma2-27b {layer} layer backward, s={TRAIN_SEQ}, {name}"
                f", block {blk} on the {route} route, two calls bit for bit:"
                f" normwise dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, dv "
                f"{errs['dv']:.3e} (bound {WIDE_TOL[name]:.3e}), lse ratio "
                f"{lse_ratio:.3f}; kernel {ms:.3f} ms (three launches), "
                f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}, "
                f"{bd['bound_terms']})")
            wide.append({"layer": layer, "window": window, "dtype": name,
                         "s": TRAIN_SEQ, "blk": blk, "route": route,
                         "deterministic": True, "normwise": errs,
                         "max_abs_err": max_abs, "lse_ratio": lse_ratio,
                         "kernel_ms": ms, **bd})
            del o, lse
        del ops, q, k, v, do

    # phi3-mini-3.8b's head dim 96, zero-padded to 128 in the wrappers
    padded = {}
    b, h, s = 1, 32, TRAIN_SEQ
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        blk = attn_bwd_blocks(s, dtype, 96)
        q, k, v, do = operands(b, h, h, s, 96, dtype)
        errs, max_abs, lse_ratio, route = check(f"head dim 96 ({name})", q,
                                                k, v, do, blk, {})
        o, lse = flash_attention_fwd(q, k, v)
        ms = event_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do), 3)
        flops, nbytes, mufu = attn_bwd_work(b, h, h, s, 96, True, 0,
                                            q.element_size())
        bd = bwd_bound(flops, nbytes, dtype, card, mufu)
        log(f"  attention backward (1, 32, {s}, {s}, 96) causal {name} "
            f"(phi3-mini-3.8b's head dim, padded to 128), block {blk} on the "
            f"{route} route: normwise dq {errs['dq']:.3e}, dk "
            f"{errs['dk']:.3e}, dv {errs['dv']:.3e} (bound "
            f"{WIDE_TOL[name]:.3e}), lse ratio {lse_ratio:.3f}; kernel "
            f"{ms:.3f} ms, bound at the true D {bd['bound_ms']:.3f} ms "
            f"({bd['bound_terms']})")
        padded[name] = {"d": 96, "s": s, "blk": blk, "route": route,
                        "normwise": errs, "max_abs_err": max_abs,
                        "lse_ratio": lse_ratio, "kernel_ms": ms, **bd}
        del q, k, v, do, o, lse

    b, h, s, _, d = ATTN_PROBLEM
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        blk = attn_bwd_blocks(s, dtype, d)
        q, k, v, do = operands(b, h, h, s, d, dtype)
        o, lse = flash_attention_fwd(q, k, v)
        errs, max_abs, _, route = check(f"{ATTN_PROBLEM} causal {name}", q,
                                        k, v, do, blk, {})
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
        flops, nbytes, mufu = attn_bwd_work(b, h, h, s, d, True, 0,
                                            q.element_size())
        bd = bwd_bound(flops, nbytes, dtype, card, mufu)
        log(f"  attention backward {ATTN_PROBLEM} causal {name}, block "
            f"{blk} on the {route} route: normwise {max(errs.values()):.3e};"
            f" kernel_ms {kernel_ms:.3f} (delta, dK/dV and dQ together), "
            f"plain_ms {plain_ms:.3f}, library_ms {library_ms:.3f} (the "
            f"backward of scaled_dot_product_attention, is_causal=True, TF32 "
            f"off; normwise {lib_err:.1e} from the plain backward), bound_ms "
            f"{bd['bound_ms']:.3f} ({bd['bound_by']}, {bd['bound_terms']}); "
            f"{flops / kernel_ms / 1e9:.1f} TFLOP/s on the kept pairs' five "
            f"products")
        timed[name] = {"err": max_abs, "normwise": errs,
                       "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "library_normwise": lib_err,
                       "blk": blk, "route": route, **bd}
        if dtype == torch.bfloat16:
            # the forward on the wgmma route, the models' blocks
            route = attn_route(dtype, 128, 128, d)
            fwd_out = flash_attention(q, k, v)
            fwd_ref = flash_attention_plain(q, k, v, bkv=128)
            fwd_err = float((fwd_out.float() - fwd_ref.float()).abs().max())
            fwd_normwise = rel_err(fwd_out, fwd_ref)
            del fwd_out, fwd_ref
            if not fwd_normwise <= WIDE_TOL[name]:
                raise AssertionError(
                    f"the bfloat16 forward at {ATTN_PROBLEM} causal, blocks "
                    f"(128, 128), disagrees with its plain version: "
                    f"normwise {fwd_normwise:.3e} (bound "
                    f"{WIDE_TOL[name]:.3e})")
            fwd_ms = event_ms(lambda: flash_attention(q, k, v), TIME_REPS)
            fwd_plain_ms = event_ms(lambda: flash_attention_plain(
                q, k, v, bq=128, bkv=128), 3)
            sdpa_fwd_ms = event_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True), TIME_REPS)
            fbd = attn_fwd_bound(b, h, h, s, d, True, 0, dtype, card)
            timed["forward_bfloat16"] = {
                "kernel_ms": fwd_ms, "plain_ms": fwd_plain_ms,
                "library_ms": sdpa_fwd_ms, "err": fwd_err,
                "normwise": fwd_normwise,
                "blocks": [128, 128], "route": route, **fbd}
            log(f"  attention forward {ATTN_PROBLEM} causal bfloat16, blocks"
                f" (128, 128) on the {route} route: normwise "
                f"{fwd_normwise:.3e} (bound {WIDE_TOL[name]:.3e}), max_abs_err "
                f"{fwd_err:.3e}; kernel_ms {fwd_ms:.3f}, plain_ms "
                f"{fwd_plain_ms:.3f}, library_ms "
                f"{sdpa_fwd_ms:.3f} (scaled_dot_product_attention, "
                f"is_causal=True), bound_ms {fbd['bound_ms']:.3f} "
                f"({fbd['bound_terms']}); {fbd['flops'] / fwd_ms / 1e9:.1f} "
                f"TFLOP/s on the kept pairs")
        del q, k, v, do, o, lse, leaves, sdpa_out
    sass = check_bwd_sass(sass_run)
    return {"small": small, "gemma2_27b": wide, **timed["float32"],
            "bfloat16": timed["bfloat16"], "head_dim_96": padded,
            "forward_bfloat16": timed["forward_bfloat16"],
            "sass": sass}


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
    update's ``record_function`` range opens is the optimizer's), the six
    longest kernels by name (``top_kernels_ms``, as :func:`profile_call`),
    the range's host time (``adamw_host_ms``: the step reads the loss
    before the update, so the update's host work is on the step's path),
    and the device's idle share of the step's wall time.  The range's own
    event on the device timeline (a span over the optimizer's kernels, not
    a kernel) is left out of the sums."""
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
    opt_host_ms = sum(
        (e.time_range.end - e.time_range.start) / 1e3 for e in events
        if e.name == "adamw" and
        e.device_type == torch.autograd.DeviceType.CPU)
    by_class, by_name, spans = {}, {}, 0
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
        by_name[evt.name[:80]] = by_name.get(evt.name[:80], 0.0) + dur
    busy = sum(by_class.values())
    if not busy:
        return {"measured": False, "wall_ms": wall_ms}
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return {"measured": True, "wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "by_class_ms": by_class,
            "top_kernels_ms": top, "adamw_host_ms": opt_host_ms,
            "shares": {k: v / wall_ms for k, v in by_class.items()},
            "optimizer_marked": t_opt is not None,
            "device_spans_left_out": spans}


def train_path(dev, card) -> dict:
    """Phase 14c: gemma2-27b at full width, TRAIN_PERIODS periods, trained
    through :func:`train_cell`, with the step's products (train_flops),
    model FLOPs and mfu."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    base = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(
        base, n_layers=TRAIN_PERIODS * len(base.block_pattern))
    log(f"  memory held by earlier phases: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    res, state = train_cell(dev, cfg, TRAIN_ARCH)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    steps = TRAIN_STEPS + 1
    exact_launches(f"{steps} steps of {cfg.n_layers} layers' "
                   f"{res['tensors']} tensors",
                   {**adamw_launches(), **norm_launches()},
                   {**adamw_want(steps, res["tensors"]),
                    **norm_want(cfg, steps)})
    flops = train_flops(cfg, TRAIN_SEQ)
    mf = model_flops(cfg, "train", 1, TRAIN_SEQ, res["step_ms_median"], card)
    log(f"  products {flops / 1e12:.1f} TFLOP a step (train_flops)")
    log_model_flops(f"{TRAIN_ARCH} train step", mf)
    mm = res["profile"].get("by_class_ms", {}).get("library matmul")
    if mm:
        log(f"  bf16 products {flops / mm / 1e9:.0f} TFLOP/s over their "
            f"device time")
    return {**res, "products_tflop": flops / 1e12, **mf}


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


# ----------------------------------------------------------- phase 15 --
#: 15c: mamba2-2.7b (src/repro/configs/mamba2_2_7b.py) at full width and
#: depth trained for TRAIN_STEPS AdamW steps on train_4k's sequence at
#: batch 1, bfloat16 parameters, float32 moments
SSD_TRAIN_ARCH = "mamba2-2.7b"
SSD_TRAIN_LAYERS = 64
#: 15a: the small cases' (batch, L, H, G); each instantiated (P, N) at each
#: chunk, h0 given at chunks 16 and 64, dh_final at 16 and 32
SSD_BWD_SMALL = (2, 512, 4, 2)
SSD_BWD_CHUNKS = (16, 32, 64, 256)
#: the wgmma route's (P, N): mamba2-2.7b's and jamba-v0.1-52b's widths
SSD_BWD_WGMMA_KEYS = ((64, 128), (64, 16))
#: the mma.sync route's chunk pass the SASS gate reads: mamba2's (P, N) at
#: R = 32 (chunk 32; at chunks of 64 and more that (P, N) takes wgmma)
SSD_BWD_SYNC_KEY = (64, 128, 32)
SSD_BWD_MAIN_KEY = (64, 128)       # the wgmma route at mamba2's (P, N)


def ssd_bwd_work(b, l, h, p, g, n, chunk):
    """(flops, bytes) the SSD's gradient needs: per head and chunk, over
    the Q (Q + 1) / 2 kept pairs dY X^T, G^T dY, M B and M^T C (2 P, 2 P, 2
    N and 2 N flops a pair), and D_c, dY h_in, X dS and B dS^T (2 Q P N
    each); and C B^T over the kept pairs (2 N a pair) once a (batch, group,
    chunk), since C and B belong to the group; x, dy, dt, a_log, b, c, the
    forward's s and h_in read once, dx, ddt, da_log, db, dc and dh0
    written once.  (The wgmma route's split scratch is the route's own, not
    the function's: :func:`ssd_bwd_route_bytes` counts it.)"""
    nc = l // chunk
    pairs = chunk * (chunk + 1) // 2
    per_head = 2.0 * pairs * (2 * n + 2 * p) + 8.0 * chunk * p * n
    flops = b * nc * (h * per_head + g * 2.0 * pairs * n)
    reads = 2 * b * l * h * p + b * l * h + h + 2 * b * l * g * n + \
        b * h * l + b * h * nc * p * n
    writes = b * l * h * p + b * l * h + h + 2 * b * l * g * n + b * h * p * n
    return flops, 4.0 * (reads + writes)


def ssd_bwd_route_bytes(b, l, h, p, g, n, chunk) -> float:
    """The bytes the wgmma route moves beyond the function's own
    (:func:`ssd_bwd_work`): its split scratch
    (``ssd_bwd_split_floats``) written once and read once; 0 on the
    mma.sync route."""
    from repro_torch.kernels.ssd import ssd_bwd_split_floats
    return 2 * 4.0 * ssd_bwd_split_floats(b, l, h, g, p, n, chunk)


#: host seconds on each side of a short profiler window: the profiler keeps
#: only the device events its host-clock window holds, and 750 s into this
#: script on the H100 a window of five calls (18 ms) held none, and one of
#: twenty calls padded by half a second held 13 of each kernel's 20 events
PROFILE_PAD_S = 0.5


def ssd_bwd_kernel_ms(fn, calls: int = 20) -> dict:
    """Each SSD backward kernel's device time in ms: the mean over its
    events (a launch) in one ``torch.profiler`` window of ``calls`` calls
    of ``fn`` (after one unprofiled call), padded by PROFILE_PAD_S of host
    time on each side, with the events the window held under ``events``,
    and under ``a_call`` the mean times the kernel's launches a call (its
    events over the chunk pass's, which launches once a call; the wgmma
    route's split kernel launches twice); ``{"measured": False}`` when the
    window holds none."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    total, events = {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"ssd_bwd_(\w+?)_kernel", evt.name)
        if m:
            dur = (evt.time_range.end - evt.time_range.start) / 1e3
            total[m.group(1)] = total.get(m.group(1), 0.0) + dur
            events[m.group(1)] = events.get(m.group(1), 0) + 1
    if not total:
        return {"measured": False}
    mean = {k: v / events[k] for k, v in total.items()}
    once = next((events[k] for k in ("chunk_wgmma", "chunk") if k in events),
                None)
    a_call = {k: m * max(1, round(events[k] / once)) if once else m
              for k, m in mean.items()}
    return {"measured": True, "events": events, "of_calls": calls, **mean,
            "a_call": a_call}


def check_ssd_bwd_sass(sass_run) -> dict:
    """The SASS gate of the SSD backward's library (``sass_run`` from
    :func:`start_sass`): HGMMA in the wgmma route's chunk pass, D_c and
    C B^T kernels at every (P, N) of SSD_BWD_WGMMA_KEYS; HMMA in the
    mma.sync route's chunk pass at SSD_BWD_SYNC_KEY and its D_c at that
    (P, N)."""
    hgmma, hmma = hmma_counts(sass_run, "HGMMA"), hmma_counts(sass_run)

    def one(counts, kern, key):
        tag = "I" + "".join(f"Li{c}E" for c in key) + "E"
        names = [k for k in counts if kern in k and tag in k]
        if len(names) != 1:
            raise AssertionError(f"no single SASS function for {kern} at "
                                 f"{key}: {names}")
        return counts[names[0]]

    found = {}
    for key in SSD_BWD_WGMMA_KEYS:
        for kern in ("ssd_bwd_chunk_wgmma_kernel",
                     "ssd_bwd_dstate_wgmma_kernel", "ssd_bwd_cb_kernel"):
            found[f"{kern}<{key[0]},{key[1]}>/HGMMA"] = one(hgmma, kern, key)
    found[f"ssd_bwd_chunk_kernel<{','.join(map(str, SSD_BWD_SYNC_KEY))}>"
          f"/HMMA"] = one(hmma, "ssd_bwd_chunk_kernel", SSD_BWD_SYNC_KEY)
    found[f"ssd_bwd_dstate_kernel<{SSD_BWD_SYNC_KEY[0]},"
          f"{SSD_BWD_SYNC_KEY[1]}>/HMMA"] = one(
              hmma, "ssd_bwd_dstate_kernel", SSD_BWD_SYNC_KEY[:2])
    if not all(found.values()):
        raise AssertionError(f"the SSD backward's SASS lacks tensor-core "
                             f"instructions: {found}")
    log(f"  SSD backward SASS: HGMMA in the wgmma route's kernels at (P, N) "
        f"in {SSD_BWD_WGMMA_KEYS}, HMMA in the mma.sync route's at "
        f"{SSD_BWD_SYNC_KEY}: {found} (cuobjdump -sass)")
    return found


#: the SSD backward's gradients, in ``ssd_bwd``'s order
SSD_BWD_NAMES = ("dx", "ddt", "da_log", "db", "dc", "dh0")


def ssd_bwd_inputs(gen, b, l, h, p, g, n, with_h0, with_dh):
    """SSD operands and upstream gradients on the card from the card
    generator ``gen``: x, dy (and h0, dh_final when asked for) standard
    normal, dt in [1e-3, 0.101), a_log N(0, 0.25), b and c N(0, 1 / N)."""
    import torch

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x = randn(b, l, h, p)
    dt = torch.rand(b, l, h, generator=gen, device="cuda") * 0.1 + 1e-3
    a_log = randn(h, scale=0.5)
    bb, cc = randn(b, l, g, n, scale=n ** -0.5), \
        randn(b, l, g, n, scale=n ** -0.5)
    h0 = randn(b, h, p, n) if with_h0 else None
    dy = randn(b, l, h, p)
    dh = randn(b, h, p, n) if with_dh else None
    return x, dt, a_log, bb, cc, h0, dy, dh


def check_ssd_bwd_case(label, ops, chunk):
    """The SSD backward kernels on ``ops`` (:func:`ssd_bwd_inputs`) at
    ``chunk`` against the plain backward in float64 on the kernel
    forward's own s and h_in: two calls the same bits, every gradient
    within 1e-5 normwise, both calls on the route ``ssd_bwd_route`` gives.
    Returns (args, got, want, errs)."""
    import torch
    from repro_torch.kernels.ssd import (_kernel_parts, ssd_bwd,
                                         ssd_bwd_plain, ssd_bwd_route)
    tol = WIDE_TOL["float32"]
    x, dt, a_log, bb, cc, h0, dy, dh = ops
    route = ssd_bwd_route(x.shape[3], bb.shape[3], chunk)
    _, _, s, h_in = _kernel_parts(x, dt, a_log, bb, cc, chunk, h0,
                                  want_state=False)
    args = (x, dt, a_log, bb, cc, s, h_in, dy, dh)
    before = ssd_bwd.route_launches[route]
    got = ssd_bwd(*args, chunk=chunk)
    again = ssd_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()           # a fault surfaces here
    on_route = ssd_bwd.route_launches[route] - before == 2
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = ssd_bwd_plain(*(None if t is None else t.double() for t in args),
                         chunk=chunk)
    errs = dict(zip(SSD_BWD_NAMES, grads_err(got, want).values()))
    if not (same and on_route and max(errs.values()) <= tol):
        raise AssertionError(f"ssd_bwd disagrees with its plain version "
                             f"at {label}: two calls equal {same}, on its "
                             f"route {route} {on_route}, normwise {errs} "
                             f"(bound {tol:.0e})")
    return args, got, want, errs


def ssd_bwd_timed(label, args, got, want, errs, chunk, card) -> dict:
    """The SSD backward at ``args`` (a checked case) timed beside the
    float32 plain backward and the bound of the route taken (3xTF32, the
    FFMA bound beside it), each kernel's own time from one profiler
    window; logged as ``label``."""
    import torch
    from repro_torch.kernels.ssd import (ssd_bwd, ssd_bwd_heads,
                                         ssd_bwd_plain, ssd_bwd_route)
    problem = tuple(args[0].shape) + tuple(args[3].shape[2:])
    b, l, h, p, g, n = problem
    max_abs = max(float((a.double() - w).abs().max())
                  for a, w in zip(got, want))
    plain32 = dict(zip(SSD_BWD_NAMES, grads_err(
        ssd_bwd_plain(*args, chunk=chunk), want).values()))
    kernel_ms = event_ms(lambda: ssd_bwd(*args, chunk=chunk), TIME_REPS)
    plain_ms = event_ms(lambda: ssd_bwd_plain(*args, chunk=chunk), 3)
    passes_ms = ssd_bwd_kernel_ms(lambda: ssd_bwd(*args, chunk=chunk))
    flops, nbytes = ssd_bwd_work(*problem, chunk)
    bd = bwd_bound(flops, nbytes, torch.float32, card)
    route = ssd_bwd_route(p, n, chunk)
    scratch = ssd_bwd_route_bytes(*problem, chunk)
    route_bd = bwd_bound(flops, nbytes + scratch, torch.float32, card)
    heads = ssd_bwd_heads(h, g)
    log(f"  {label} SSD backward {problem}, chunk {chunk}, route {route}, "
        f"two calls bit for bit: normwise vs float64 " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()) + " (the float32 "
        f"plain backward: " + ", ".join(
            f"{k} {v:.2e}" for k, v in plain32.items()) + f"); kernel "
        f"{kernel_ms:.3f} ms ({heads} heads a chunk-pass block), plain "
        f"{plain_ms:.3f} ms (float32), bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']}, {bd['bound_terms']}); with the route's split "
        f"scratch written and read once ({scratch / 1e9:.3f} GB) "
        f"{route_bd['bound_ms']:.3f} ms ({route_bd['bound_by']}); "
        f"{flops / kernel_ms / 1e9:.1f} TFLOP/s of {flops / 1e9:.1f} GFLOP")
    if passes_ms["measured"]:
        log("    each kernel (torch.profiler, ms a call): " + ", ".join(
            f"{k} {v:.3f}" for k, v in passes_ms["a_call"].items()) +
            f"; events held {passes_ms['events']} of "
            f"{passes_ms['of_calls']} calls")
    else:
        log("    the profiler window holds no device time: each kernel's "
            "time not measured")
    return {"shape": list(problem), "chunk": chunk, "route": route,
            "normwise": errs, "plain32_normwise": plain32, "err": max_abs,
            "deterministic": True, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": None, "heads": heads,
            "passes_ms": passes_ms, "scratch_bytes": scratch,
            "route_bound_ms": route_bd["bound_ms"],
            "route_bound_by": route_bd["bound_by"], **bd}


def check_ssd_bwd_routes() -> dict:
    """The backward library's route table (``repro_ssd_bwd_route``)
    against ``ssd_bwd_route`` at every instantiated (P, N) and more, chunks
    legal and not; its split scratch's size
    (``repro_ssd_bwd_split_floats``) against ``ssd_bwd_split_floats`` at
    the models' widths."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import (KERNEL_HEAD_DIMS, KERNEL_STATES,
                                         ssd_bwd_route, ssd_bwd_split_floats)
    lib = _build.load("ssd_bwd")
    lib.repro_ssd_bwd_route.argtypes = [ctypes.c_int] * 3
    lib.repro_ssd_bwd_split_floats.argtypes = [ctypes.c_int] * 7
    lib.repro_ssd_bwd_split_floats.restype = ctypes.c_longlong
    names = {0: None, 1: "wgmma", 2: "mma_sync"}
    table = {(p, n, chunk): names[lib.repro_ssd_bwd_route(p, n, chunk)]
             for p in KERNEL_HEAD_DIMS + (128,)
             for n in KERNEL_STATES + (256,)
             for chunk in (8, 16, 32, 48, 64, 96, 128, 256, 512)}
    differ = [k for k, r in table.items() if r != ssd_bwd_route(*k)]
    sizes = {f"{b},{l},{h},{p},{g},{n}/{chunk}": (
        lib.repro_ssd_bwd_split_floats(b, l, h, g, p, n, chunk),
        ssd_bwd_split_floats(b, l, h, g, p, n, chunk))
        for b, l, h, p, g, n in (SSD_PROBLEM, MOE_SSD_PROBLEM)
        for chunk in (32, 64, SSD_MODEL_CHUNK)}
    if differ or any(a != w for a, w in sizes.values()):
        raise AssertionError(f"the SSD backward library's route table or "
                             f"scratch sizes differ from ssd_bwd_route / "
                             f"ssd_bwd_split_floats: {differ}, {sizes}")
    counts = {r: sum(v == r for v in table.values())
              for r in ("wgmma", "mma_sync", None)}
    log(f"  SSD backward route table: the library's equals ssd_bwd_route at "
        f"{len(table)} (P, N, chunk) ({counts}); split scratch floats equal "
        f"at {sorted(sizes)}")
    return {"routes": counts, "split_floats": sizes}


def check_ssd_bwd(card, sass_run) -> dict:
    """Phase 15a: the SSD backward kernels against the plain backward in
    float64 on the kernel forward's own s and h_in: every instantiated
    (P, N) at each chunk of SSD_BWD_CHUNKS on a small shape, with and
    without h0 and a final-state gradient, each on its route
    (``ssd_bwd_route``); then mamba2-2.7b's and jamba-v0.1-52b's widths at
    chunks 64 and 256 (the wgmma route).  Every gradient within 1e-5
    normwise, two calls the same bits (:func:`check_ssd_bwd_case`); the
    wide shapes timed (:func:`ssd_bwd_timed`); the library's route table
    (:func:`check_ssd_bwd_routes`); and the SASS gate
    (check_ssd_bwd_sass)."""
    import torch
    from repro_torch.kernels.ssd import (KERNEL_HEAD_DIMS, KERNEL_STATES,
                                         ssd_bwd_route)
    tol = WIDE_TOL["float32"]
    gen = torch.Generator(device="cuda").manual_seed(15)
    routes = check_ssd_bwd_routes()

    small = []
    b, l, h, g = SSD_BWD_SMALL
    for p in KERNEL_HEAD_DIMS:
        for n in KERNEL_STATES:
            for chunk in SSD_BWD_CHUNKS:
                with_h0, with_dh = chunk in (16, 64), chunk in (16, 32)
                _, _, _, errs = check_ssd_bwd_case(
                    f"P {p}, N {n}, chunk {chunk}",
                    ssd_bwd_inputs(gen, b, l, h, p, g, n, with_h0, with_dh),
                    chunk)
                small.append({"p": p, "n": n, "chunk": chunk,
                              "route": ssd_bwd_route(p, n, chunk),
                              "h0": with_h0, "dh_final": with_dh,
                              "normwise": errs})
    by_route = {}
    for r in small:
        by_route.setdefault(r["route"], []).append(r)
    log(f"  SSD backward kernels at all {len(small)} (P, N, chunk) cases of "
        f"{SSD_BWD_SMALL} (batch, L, H, G), each on its route, two calls bit"
        f" for bit, every gradient within {tol:.0e} normwise of the float64 "
        f"plain backward; " + "; ".join(
            f"{route}: {len(rs)} cases, worst "
            f"{max(max(r['normwise'].values()) for r in rs):.3e}"
            for route, rs in sorted(by_route.items())))
    wide = {}
    for name, problem in (("mamba2-2.7b", SSD_PROBLEM),
                          ("jamba-v0.1-52b", MOE_SSD_PROBLEM)):
        wide[name] = {}
        for chunk in (64, SSD_MODEL_CHUNK):
            ops = ssd_bwd_inputs(gen, *problem, False, False)
            args, got, want, errs = check_ssd_bwd_case(
                f"{name}, chunk {chunk}", ops, chunk)
            wide[name][chunk] = ssd_bwd_timed(name, args, got, want, errs,
                                              chunk, card)
            del ops, args, got, want
            torch.cuda.empty_cache()
    sass = check_ssd_bwd_sass(sass_run)
    return {"small": small, "mamba2_2_7b": wide["mamba2-2.7b"],
            "jamba_v0_1_52b": wide["jamba-v0.1-52b"], "route_table": routes,
            "sass": sass, **wide["mamba2-2.7b"][SSD_MODEL_CHUNK]}


def check_ssd_train_grads(dev) -> dict:
    """Phase 15b: every parameter's gradient of ``loss_fn`` through the SSD
    kernels (forward and backward) against the plain route (autograd
    through ``ssd_plain``) at mamba2-2.7b's full width cut to
    CHECK_PERIODS periods (2 layers), batch 1 x GRAD_SEQ tokens, in
    float32 and bfloat16."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd, ssd_bwd
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train.data import DataConfig, batch_at, to_device
    cfg = dataclasses.replace(get_config(SSD_TRAIN_ARCH),
                              n_layers=CHECK_PERIODS)
    res = {}
    for seed, dtype_name in enumerate(("float32", "bfloat16")):
        dtype = getattr(torch, dtype_name)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            500 + seed), dtype, dev)
        for p in params.parameters():
            p.requires_grad_(True)
        names = [n for n, _ in params.named_parameters()]
        leaves = list(params.parameters())
        batch = to_device(batch_at(DataConfig(
            vocab=cfg.vocab, seq_len=GRAD_SEQ, global_batch=1,
            seed=500 + seed), 0), dev)
        fwd, bwd = ssd.launches, ssd_bwd.launches
        loss_k = loss_fn(cfg, params, batch["inputs"], batch["labels"])
        got = torch.autograd.grad(loss_k, leaves)
        torch.cuda.synchronize()
        fwd, bwd = ssd.launches - fwd, ssd_bwd.launches - bwd
        loss_p = loss_fn(cfg, params, batch["inputs"], batch["labels"],
                         use_kernel=False)
        want = torch.autograd.grad(loss_p, leaves)
        errs = {names[i]: e for i, e in grads_err(got, want).items()}
        tol = GRAD_TOL[dtype_name]
        worst = max(errs, key=errs.get)
        log(f"  {SSD_TRAIN_ARCH} {dtype_name} at {cfg.n_layers} layers, batch"
            f" 1 x {GRAD_SEQ}: loss kernel route {float(loss_k.detach()):.6f}"
            f", plain {float(loss_p.detach()):.6f}; {len(errs)} gradient "
            f"leaves, kernel route vs plain route normwise worst "
            f"{errs[worst]:.3e} ({worst}), a_log " + ", ".join(
                f"{errs[n]:.3e}" for n in names if n.endswith("a_log")) +
            f" (bound {tol:.0e}); {fwd} forward and {bwd} backward SSD "
            f"launches (remat runs each layer's forward twice)")
        if not (max(errs.values()) <= tol and bwd == cfg.n_layers and
                fwd == 2 * cfg.n_layers):
            raise AssertionError(f"{SSD_TRAIN_ARCH} {dtype_name}: the kernel "
                                 f"route's gradients disagree or the kernels"
                                 f" were not launched: {errs}, {fwd} / {bwd}"
                                 f" launches")
        res[dtype_name] = {"layers": cfg.n_layers, "tokens": GRAD_SEQ,
                           "loss_kernel": float(loss_k.detach()),
                           "loss_plain": float(loss_p.detach()), "tol": tol,
                           "normwise": errs, "forward_launches": fwd,
                           "backward_launches": bwd}
        del got, want, loss_k, loss_p, params, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return res


def model_flops(cfg, kind: str, batch: int, seq: int, ms: float,
                card, remat_policy=None) -> dict:
    """The model FLOPs of one step by ``repro_torch.perf.analytic``
    (``cell_cost``: the forward's products and scores, training as 4
    forwards with per-period remat, 3.2 under ``remat_policy="dots"``),
    the achieved model TFLOP/s over ``ms`` and their share of the card's
    bfloat16 tensor peak (``mfu``)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.perf.analytic import cell_cost
    flops = cell_cost(cfg, ShapeSpec(kind, seq, batch, kind),
                      remat_policy=remat_policy).flops
    rate = flops / ms / 1e9
    return {"model_flops": flops, "model_tflops_per_s": rate,
            "mfu": rate * 1e12 / card.bf16_tensor_flops,
            "peak_tflops_per_s": card.bf16_tensor_flops / 1e12}


def log_model_flops(what: str, mf: dict) -> None:
    log(f"  {what}: {mf['model_flops'] / 1e12:.2f} model TFLOP a step "
        f"(perf.analytic.cell_cost), {mf['model_tflops_per_s']:.1f} TFLOP/s,"
        f" mfu {100 * mf['mfu']:.2f} % of {mf['peak_tflops_per_s']:.0f} "
        f"TFLOP/s bf16")


def marked_adamw(lr: float):
    """AdamW whose update (``update``, and ``update_apply``, which the train
    step calls) opens a ``record_function`` range named "adamw", so a
    profile can tell the optimizer's kernels apart."""
    import torch
    from repro_torch.train.optimizer import AdamW

    class MarkedAdamW(AdamW):
        __slots__ = ()

        def update(self, *args, **kwargs):
            with torch.profiler.record_function("adamw"):
                return super().update(*args, **kwargs)

        def update_apply(self, *args, **kwargs):
            with torch.profiler.record_function("adamw"):
                return super().update_apply(*args, **kwargs)

    return MarkedAdamW(lr=lr)


def train_cell(dev, cfg, arch: str) -> tuple:
    """``cfg`` trained for TRAIN_STEPS AdamW steps on train_4k's sequence
    at batch 1 through the port's ``train`` (random bfloat16 parameters
    from a seeded card generator, float32 moments, per-period remat,
    chunked cross entropy), then one more step under the profiler (phases
    15c and 16c).  Every loss finite, the first within 2 of ln V.  Returns
    (the run's numbers, (params, opt_state, opt, batch)): the trained
    state and the profiled step's batch."""
    import gc
    import math
    import statistics
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.data import DataConfig, batch_at, to_device
    from repro_torch.train.train_loop import TrainConfig, train
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=1, seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    opt = marked_adamw(TRAIN_LR)
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
        raise AssertionError(f"{arch} training went wrong: losses "
                             f"{losses}, skipped {report.skipped_nan_steps}"
                             f" (the first should be near ln V = "
                             f"{ln_v:.3f})")
    steps_ms = [t * 1e3 for t in report.step_times]
    later = steps_ms[1:]
    step_ms = statistics.median(later)
    step_fn = make_train_step(cfg, opt)
    batch = to_device(batch_at(data_cfg, TRAIN_STEPS), dev)
    prof = profile_train_step(lambda: step_fn(params, opt_state, batch))
    res = {"arch": arch, "layers": cfg.n_layers, "params": n_params,
           "tensors": len(list(params.parameters())), "tokens": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses,
           "steps_ms": steps_ms, "step_ms_median": step_ms,
           "step_ms_min": min(later), "first_step_ms": steps_ms[0],
           "tokens_per_s": TRAIN_SEQ * 1e3 / step_ms, "peak_bytes": peak,
           "wall_s": wall_s, "stragglers": report.straggler_steps,
           "profile": prof}
    log(f"  {arch} at full width, {cfg.n_layers} layers "
        f"({n_params / 1e9:.2f} B parameters, bfloat16; AdamW float32), "
        f"batch 1 x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps in {wall_s:.1f}"
        f" s: losses " + ", ".join(f"{x:.4f}" for x in losses) +
        f" (ln V = {ln_v:.4f})")
    log(f"  step ms after the first: median {step_ms:.1f}, min "
        f"{min(later):.1f} (first {steps_ms[0]:.1f}); "
        f"{res['tokens_per_s']:.0f} tokens/s; peak memory "
        f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
    if prof["measured"]:
        log(f"  one profiled step: wall {prof['wall_ms']:.1f} ms, device busy"
            f" {prof['busy_ms']:.1f} ms, idle share "
            f"{100 * prof['idle_share']:.1f} %; by class: " + ", ".join(
                f"{k} {v:.1f} ms ({100 * prof['shares'][k]:.1f} %)"
                for k, v in sorted(prof["by_class_ms"].items(),
                                   key=lambda kv: -kv[1])) +
            ("" if prof["optimizer_marked"] else
             " (the optimizer's range was not found: adamw not split out)") +
            f"; the optimizer's host time {prof['adamw_host_ms']:.1f} ms" +
            f"; {prof['device_spans_left_out']} device-side span of the "
            f"range left out")
        log(f"    longest kernels: " + "; ".join(
            f"{k} {v:.2f} ms" for k, v in prof["top_kernels_ms"].items()))
    else:
        log("  the profiled step's trace holds no device time: shares not "
            "measured")
    return res, (params, opt_state, opt, batch)


def adamw_launches() -> dict:
    """The optimizer's two kernel wrappers' launch counts, by name."""
    from repro_torch.kernels.adamw import adamw_sqnorm, adamw_update
    return {"adamw_update": adamw_update.launches,
            "adamw_sqnorm": adamw_sqnorm.launches}


def adamw_want(steps: int, tensors: int) -> dict:
    """What ``steps`` AdamW steps over ``tensors`` parameters launch: one
    update and one norm a tensor a step (every train path clips)."""
    return {"adamw_update": steps * tensors,
            "adamw_sqnorm": steps * tensors}


def mixer_launches() -> dict:
    """The Mamba mixer's four kernel wrappers' launch counts, by name."""
    from repro_torch.kernels import mamba_mixer as mm
    return {k: getattr(mm, k).launches for k in MAMBA_KERNELS}


def mixer_want(forward: int, backward: int) -> dict:
    """What ``forward`` mixer forwards (mamba_in and mamba_out once each)
    and ``backward`` mixer backwards launch."""
    return {"mamba_in": forward, "mamba_out": forward,
            "mamba_out_bwd": backward, "mamba_in_bwd": backward}


def exact_launches(what: str, got: dict, want: dict) -> None:
    """Each kernel wrapper's launches ``got`` (by name) must equal
    ``want``'s."""
    log(f"  {what}: launches " + ", ".join(
        f"{k} {got[k]}" for k in want) + " (exactly " + ", ".join(
        f"{k} {v}" for k, v in want.items()) + " expected)")
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"{what}: launches {got}, not {want}")


def ssd_train_path(dev, card) -> dict:
    """Phase 15c: mamba2-2.7b at full width and SSD_TRAIN_LAYERS layers
    trained through :func:`train_cell`: every Mamba layer's scan through
    the SSD kernels (twice a step with remat) and its gradient through the
    SSD backward kernels, with the step's model FLOPs and mfu."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd, ssd_bwd
    cfg = dataclasses.replace(get_config(SSD_TRAIN_ARCH),
                              n_layers=SSD_TRAIN_LAYERS)
    res, state = train_cell(dev, cfg, SSD_TRAIN_ARCH)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    steps = TRAIN_STEPS + 1
    exact_launches(f"{steps} steps of {cfg.n_layers} Mamba layers",
                   {"ssd": ssd.launches, "ssd_bwd": ssd_bwd.launches,
                    **mixer_launches(), **norm_launches(),
                    **adamw_launches()},
                   {"ssd": 2 * steps * cfg.n_layers,
                    "ssd_bwd": steps * cfg.n_layers,
                    **mixer_want(2 * steps * cfg.n_layers,
                                 steps * cfg.n_layers),
                    **norm_want(cfg, steps),
                    **adamw_want(steps, res["tensors"])})
    mf = model_flops(cfg, "train", 1, TRAIN_SEQ, res["step_ms_median"], card)
    log_model_flops(f"{SSD_TRAIN_ARCH} train step", mf)
    return {**res, "ssd_launches": ssd.launches,
            "ssd_bwd_launches": ssd_bwd.launches, **mf}


# ----------------------------------------------------------- phase 16 --
#: phase 16's cell, train-4096-jamba-l3-4: jamba-v0.1-52b (Lieber et al.,
#: arXiv:2403.19887; the reference's src/repro/configs/jamba_v0_1_52b.py)
#: at full width, cut to layers 3 and 4 of its 8-layer period: a Mamba
#: mixer with the 16-expert top-2 einsum MoE, then attention with a dense
#: SwiGLU.  A whole period (13.00 B parameters) would need about 190 GB to
#: train; these two layers hold 3.41 B.
MOE_TRAIN_ARCH = "jamba-v0.1-52b"
MOE_TRAIN_LAYERS = slice(3, 5)
#: 16a: the SSD at jamba's widths, (batch, L, H, P, G, N), at its chunk 256
MOE_SSD_PROBLEM = (1, 4096, 128, 64, 1, 16)
#: 16d: AdamW steps under each remat policy
DOTS_STEPS = 3


def moe_cell_config():
    """The cell's config: jamba-v0.1-52b with its block pattern cut to
    MOE_TRAIN_LAYERS (by ``dataclasses.replace``, nothing in the
    package)."""
    import dataclasses
    from repro_torch.configs import get_config
    base = get_config(MOE_TRAIN_ARCH)
    pattern = base.block_pattern[MOE_TRAIN_LAYERS]
    return dataclasses.replace(base, n_layers=len(pattern),
                               block_pattern=pattern)


def check_jamba_ssd(card) -> dict:
    """Phase 16a: the SSD forward and backward kernels at jamba-v0.1-52b's
    widths (MOE_SSD_PROBLEM, its chunk 256): the forward within 1e-5
    normwise of ``ssd_plain``, the backward within 1e-5 of the float64
    plain backward (:func:`check_ssd_bwd_case`), two calls of each the
    same bits; each timed beside its plain version and the bound of its
    route."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd, ssd_plain
    chunk = get_config(MOE_TRAIN_ARCH).ssm_chunk
    tol = WIDE_TOL["float32"]
    gen = torch.Generator(device="cuda").manual_seed(16)
    ops = ssd_bwd_inputs(gen, *MOE_SSD_PROBLEM, False, False)
    fwd_ops = ops[:5]
    out = ssd(*fwd_ops, chunk=chunk)
    again = ssd(*fwd_ops, chunk=chunk)
    torch.cuda.synchronize()               # a fault surfaces here
    same = bool(torch.equal(out, again))
    ref = ssd_plain(*fwd_ops, chunk=chunk)
    err, max_abs = rel_err(out, ref), float((out - ref).abs().max())
    if not (same and err <= tol):
        raise AssertionError(f"ssd at jamba's widths: two calls equal {same},"
                             f" normwise {err:.3e} from its plain version "
                             f"(bound {tol:.0e})")
    del out, again, ref
    ms = event_ms(lambda: ssd(*fwd_ops, chunk=chunk), TIME_REPS)
    plain_ms = event_ms(lambda: ssd_plain(*fwd_ops, chunk=chunk), 3)
    flops, nbytes = ssd_work(*MOE_SSD_PROBLEM, chunk)
    bd = bwd_bound(flops, nbytes, torch.float32, card)
    log(f"  jamba-v0.1-52b SSD forward {MOE_SSD_PROBLEM}, chunk {chunk}, two "
        f"calls bit for bit: normwise {err:.3e} from ssd_plain (bound "
        f"{tol:.0e}), max_abs_err {max_abs:.3e}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bd['bound_ms']:.3f} ms ({bd['bound_by']},"
        f" {bd['bound_terms']})")
    fwd = {"shape": list(MOE_SSD_PROBLEM), "chunk": chunk, "normwise": err,
           "err": max_abs, "deterministic": True, "kernel_ms": ms,
           "plain_ms": plain_ms, "library_ms": None, **bd}
    args, got, want, errs = check_ssd_bwd_case(
        f"jamba-v0.1-52b, chunk {chunk}", ops, chunk)
    bwd = ssd_bwd_timed("jamba-v0.1-52b", args, got, want, errs, chunk, card)
    return {"forward": fwd, "backward": bwd}


def route_flips(cfg, h_a, h_b, router) -> dict:
    """How two inputs of one MoE layer (the kernel and the plain route's)
    route: the tokens whose top-k expert sets differ and each one's
    dropped choices, through the port's ``moe._route`` at the capacity
    ``moe_forward_einsum`` gives a call of their tokens."""
    import math
    from repro_torch.models.moe import _route
    t = h_a.shape[0] * h_a.shape[1]
    cap = max(1, int(math.ceil(cfg.moe_capacity_factor * cfg.top_k * t /
                               cfg.n_experts)))
    sets, dropped = [], []
    for h in (h_a, h_b):
        _, experts, _, keep = _route(h.reshape(1, t, -1) @ router,
                                     cfg.top_k, cfg.n_experts, cap)
        sets.append(experts.sort(-1).values)
        dropped.append(int((~keep).sum()))
    return {"tokens": t, "capacity": cap,
            "expert_sets_differ": int((sets[0] != sets[1]).any(-1).sum()),
            "dropped_kernel_route": dropped[0],
            "dropped_plain_route": dropped[1]}


def check_moe_train_grads(dev) -> dict:
    """Phase 16b: every parameter's gradient of ``loss_fn`` at the cell's
    full width (its two layers), batch 1 x GRAD_SEQ tokens, the kernel
    route (attention and the SSD, forward and backward kernels) against
    the plain route, in float32 and bfloat16, with each kernel's launches
    exactly 2 forward (remat) and 1 backward; and how many tokens' expert
    sets differ between the routes (the MoE's top-2 sits after the SSD
    mixer, so the routes' last-bit differences can flip a near-tied
    choice), from ``moe._route`` on each route's MoE input."""
    import gc
    import torch
    from repro_torch.kernels.adamw import adamw_sqnorm, adamw_update
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels import mamba_mixer as mm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ssd import ssd, ssd_bwd
    from repro_torch.models import init_params, loss_fn, transformer
    from repro_torch.train.data import DataConfig, batch_at, to_device
    cfg = moe_cell_config()
    wrappers = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd, "ssd": ssd,
                "ssd_bwd": ssd_bwd, "adamw_update": adamw_update,
                "adamw_sqnorm": adamw_sqnorm,
                **{k: getattr(mm, k) for k in MAMBA_KERNELS},
                **{k: getattr(rn, k) for k in RMSNORM_KERNELS}}
    seen = []
    inner = transformer.moe_forward

    def recording(cfg_, p, h, *args, **kwargs):
        seen.append(h.detach())
        return inner(cfg_, p, h, *args, **kwargs)

    res = {}
    transformer.moe_forward = recording
    try:
        for seed, dtype_name in enumerate(("float32", "bfloat16")):
            dtype = getattr(torch, dtype_name)
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(
                600 + seed), dtype, dev)
            for p in params.parameters():
                p.requires_grad_(True)
            names = [n for n, _ in params.named_parameters()]
            leaves = list(params.parameters())
            batch = to_device(batch_at(DataConfig(
                vocab=cfg.vocab, seq_len=GRAD_SEQ, global_batch=1,
                seed=600 + seed), 0), dev)
            before = {k: w.launches for k, w in wrappers.items()}
            seen.clear()
            loss_k = loss_fn(cfg, params, batch["inputs"], batch["labels"])
            got = torch.autograd.grad(loss_k, leaves)
            torch.cuda.synchronize()
            launched = {k: w.launches - before[k]
                        for k, w in wrappers.items()}
            h_kernel = seen[0]         # the forward's (then the recompute's)
            seen.clear()
            loss_p = loss_fn(cfg, params, batch["inputs"], batch["labels"],
                             use_kernel=False)
            want = torch.autograd.grad(loss_p, leaves)
            flips = route_flips(cfg, h_kernel, seen[0],
                                next(b.moe for b in params.blocks
                                     if b.moe is not None).router)
            errs = {names[i]: e for i, e in grads_err(got, want).items()}
            tol = GRAD_TOL[dtype_name]
            worst = max(errs, key=errs.get)
            log(f"  {MOE_TRAIN_ARCH} layers 3-4 {dtype_name}, batch 1 x "
                f"{GRAD_SEQ}: loss kernel route {float(loss_k.detach()):.6f},"
                f" plain {float(loss_p.detach()):.6f}; {len(errs)} gradient "
                f"leaves, kernel route vs plain route normwise worst "
                f"{errs[worst]:.3e} ({worst}), the MoE's router "
                f"{errs['blocks.0.moe.router']:.3e} (bound {tol:.0e}); "
                f"expert sets that differ between the routes: "
                f"{flips['expert_sets_differ']} of {flips['tokens']} tokens;"
                f" dropped choices at capacity {flips['capacity']}: "
                f"{flips['dropped_kernel_route']} (kernel route), "
                f"{flips['dropped_plain_route']} (plain)")
            exact_launches(f"{dtype_name} gradients", launched,
                           {"flash_attention": 2, "flash_attention_bwd": 1,
                            "ssd": 2, "ssd_bwd": 1, **mixer_want(2, 1),
                            **norm_want(cfg, 1), **adamw_want(0, 0)})
            if not max(errs.values()) <= tol:
                raise AssertionError(f"{MOE_TRAIN_ARCH} layers 3-4 "
                                     f"{dtype_name}: the kernel route's "
                                     f"gradients disagree: {errs}; route "
                                     f"flips {flips}")
            res[dtype_name] = {"layers": cfg.n_layers, "tokens": GRAD_SEQ,
                               "loss_kernel": float(loss_k.detach()),
                               "loss_plain": float(loss_p.detach()),
                               "tol": tol, "normwise": errs,
                               "launches": launched, "routes": flips}
            del got, want, loss_k, loss_p, params, leaves, h_kernel
            seen.clear()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        transformer.moe_forward = inner
    return res


def moe_train_path(dev, card) -> dict:
    """Phase 16c: the cell trained through :func:`train_cell`, with the
    attention and SSD kernels' launches exactly 2 forward and 1 backward a
    step, the step's model FLOPs and mfu; the trained state and the
    profiled step's batch stay under ``state`` for 16d."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ssd import ssd, ssd_bwd
    cfg = moe_cell_config()
    res, state = train_cell(dev, cfg, MOE_TRAIN_ARCH)
    steps = TRAIN_STEPS + 1
    launched = {"flash_attention": flash_attention.launches,
                "flash_attention_bwd": flash_attention_bwd.launches,
                "ssd": ssd.launches, "ssd_bwd": ssd_bwd.launches,
                **mixer_launches(), **norm_launches(), **adamw_launches()}
    exact_launches(f"{steps} steps of layers 3-4", launched,
                   {"flash_attention": 2 * steps, "flash_attention_bwd":
                    steps, "ssd": 2 * steps, "ssd_bwd": steps,
                    **mixer_want(2 * steps, steps), **norm_want(cfg, steps),
                    **adamw_want(steps, res["tensors"])})
    mf = model_flops(cfg, "train", 1, TRAIN_SEQ, res["step_ms_median"], card)
    log_model_flops(f"{MOE_TRAIN_ARCH} layers 3-4 train step", mf)
    return {**res, "cell": "train-4096-jamba-l3-4", "launches": launched,
            **mf, "state": state}


def products_counter():
    """A ``TorchDispatchMode`` that counts the products reaching the
    dispatcher: ``no_batch`` (``mm``, ``addmm``, a ``bmm`` over a batch of
    one: what ``remat_policy="dots"`` keeps) and ``batched`` (the other
    ``bmm``)."""
    import collections
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.counts["no_batch"] += 1
            elif func is torch.ops.aten.bmm.default:
                self.counts["no_batch" if args[0].shape[0] == 1
                            else "batched"] += 1
            return func(*args, **(kwargs or {}))

    return Products()


def check_dots(dev, card, run: dict) -> dict:
    """Phase 16d: ``remat_policy="dots"`` on the card, on 16c's trained
    parameters and its profiled step's batch: one step's gradients under
    "dots" against "full" (GRAD_TOL; expected the same bits), the products
    each backward runs counted at the dispatcher against the backward
    without remat (under "dots" none of the forward's no-batch-dims
    products runs again, under "full" they do; the batched ones run again
    under both), then DOTS_STEPS AdamW steps under each policy: step ms,
    peak memory, mfu by ``cell_cost(..., remat_policy=)``, and the
    kernels' launches, 2 forward and 1 backward a step under both.  Takes
    the state out of 16c's ``run`` and frees it."""
    import gc
    import math
    import statistics
    import torch
    from repro_torch.kernels.adamw import adamw_sqnorm, adamw_update
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels import mamba_mixer as mm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ssd import ssd, ssd_bwd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import (chunked_cross_entropy, forward_hidden,
                                    loss_fn, n_periods)
    cfg = moe_cell_config()
    params, opt_state, opt, batch = run.pop("state")
    inputs, labels = batch["inputs"], batch["labels"]
    names = [n for n, _ in params.named_parameters()]
    leaves = list(params.parameters())
    wrappers = {"flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd, "ssd": ssd,
                "ssd_bwd": ssd_bwd, "adamw_update": adamw_update,
                "adamw_sqnorm": adamw_sqnorm,
                **{k: getattr(mm, k) for k in MAMBA_KERNELS},
                **{k: getattr(rn, k) for k in RMSNORM_KERNELS}}

    def loss_under(policy):
        if policy == "none":
            return chunked_cross_entropy(
                cfg, params, forward_hidden(cfg, params, inputs), labels)
        return loss_fn(cfg, params, inputs, labels, remat_policy=policy)

    with torch.no_grad(), products_counter() as mode:
        forward_hidden(cfg, params, inputs)
    fwd = dict(mode.counts)
    counts, grads = {}, {}
    for policy in ("none", "full", "dots"):
        loss = loss_under(policy)
        with products_counter() as mode:
            g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        counts[policy] = dict(mode.counts)
        if policy != "none":
            grads[policy] = g
        del loss, g
    errs = {names[i]: e for i, e in grads_err(grads["dots"],
                                               grads["full"]).items()}
    same = sum(torch.equal(a, b) for a, b in zip(grads["dots"],
                                                  grads["full"]))
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    tol = GRAD_TOL["bfloat16"]
    worst = max(errs, key=errs.get)
    log(f"  one step's gradients, \"dots\" against \"full\": {same} of "
        f"{len(errs)} leaves the same bits, normwise worst {errs[worst]:.3e}"
        f" ({worst}; bound {tol:.0e})")
    nb = {k: counts[k].get("no_batch", 0) for k in counts}
    bt = {k: counts[k].get("batched", 0) for k in counts}
    log(f"  products in the forward: {fwd.get('no_batch', 0)} with no "
        f"batch dimension, {fwd.get('batched', 0)} batched; in the backward"
        f" (no remat / \"full\" / \"dots\"): no batch dimension {nb['none']}"
        f" / {nb['full']} / {nb['dots']}, batched {bt['none']} / "
        f"{bt['full']} / {bt['dots']}: \"dots\" runs "
        f"{nb['dots'] - nb['none']} of the forward's no-batch-dims products "
        f"again, \"full\" {nb['full'] - nb['none']}")
    if not (max(errs.values()) <= tol and nb["dots"] == nb["none"] and
            nb["full"] - nb["none"] >= fwd.get("no_batch", 0) -
            n_periods(cfg) and bt["dots"] == bt["full"] > bt["none"]):
        raise AssertionError(f"remat_policy=\"dots\": gradients {errs}, "
                             f"products forward {fwd}, backward {counts}")
    runs = {}
    for policy in ("full", "dots"):
        step_fn = make_train_step(cfg, opt, remat_policy=policy)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = {k: w.launches for k, w in wrappers.items()}
        times, losses = [], []
        for _ in range(DOTS_STEPS):
            t0 = time.perf_counter()
            params, opt_state, loss = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated(dev)
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        exact_launches(f"{DOTS_STEPS} steps under \"{policy}\"", launched,
                       {"flash_attention": 2 * DOTS_STEPS,
                        "flash_attention_bwd": DOTS_STEPS,
                        "ssd": 2 * DOTS_STEPS, "ssd_bwd": DOTS_STEPS,
                        **mixer_want(2 * DOTS_STEPS, DOTS_STEPS),
                        **norm_want(cfg, DOTS_STEPS),
                        **adamw_want(DOTS_STEPS, len(leaves))})
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"\"{policy}\" steps: losses {losses}")
        ms = statistics.median(times)
        mf = model_flops(cfg, "train", 1, TRAIN_SEQ, ms, card,
                         remat_policy=policy)
        runs[policy] = {"steps_ms": times, "step_ms_median": ms,
                        "losses": losses, "peak_bytes": peak,
                        "launches": launched, **mf}
        log(f"  {DOTS_STEPS} steps under \"{policy}\": ms " + ", ".join(
            f"{t:.1f}" for t in times) + f" (median {ms:.1f}); losses " +
            ", ".join(f"{x:.4f}" for x in losses) + f"; peak memory "
            f"{peak / 1e9:.2f} GB")
        log_model_flops(f"the step under \"{policy}\"", mf)
    del params, opt_state, batch, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return {"normwise": errs, "same_bits_leaves": same,
            "leaves": len(errs), "products_forward": fwd,
            "products_backward": counts, "runs": runs}


# ----------------------------------------------------------- phase 17 --
#: 17a: AdamW steps of the sharded step after the first (timed: 2..8)
SHARDED_STEPS = 8
#: 17c: the dry run's cells (jamba-v0.1-52b at full depth, both meshes)
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_TIMEOUT_S = 900


def _moe_cell_start(dev):
    """16c's starting point: the cell's parameters drawn as ``train``
    draws them (a card generator seeded with the data seed, bfloat16,
    trainable), its AdamW (lr TRAIN_LR, the "adamw" range marked) and
    train_4k's batches at batch 1."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.train.data import DataConfig
    cfg = moe_cell_config()
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=1,
                          seed=0)
    gen = torch.Generator(device=dev).manual_seed(data_cfg.seed)
    params = init_params(cfg, gen, torch.bfloat16, dev)
    for p in params.parameters():
        p.requires_grad_(True)
    return cfg, data_cfg, params, marked_adamw(TRAIN_LR)


def unsharded_reference_step(dev) -> dict:
    """17a's yardstick: 16c's unsharded step (``make_train_step``) from
    16c's starting point on its first batch; the loss and the updated
    parameters, on the host."""
    import gc
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.data import batch_at, to_device
    gc.collect()
    torch.cuda.empty_cache()
    cfg, data_cfg, params, opt = _moe_cell_start(dev)
    state = opt.init(list(params.parameters()))
    batch = to_device(batch_at(data_cfg, 0), dev)
    params, state, loss = make_train_step(cfg, opt)(params, state, batch)
    out = {"loss": float(loss),
           "params": [p.detach().cpu() for p in params.parameters()]}
    del params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def start_card_group():
    """An NCCL process group of world 1 (a FileStore in a temporary
    directory) and a (1, 1) local mesh on the card."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    torch.cuda.set_device(0)
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", init_method=f"file://{store}/s",
                            world_size=1, rank=0)
    return make_local_mesh(1, 1)


def sharded_train_path(dev, card, ref: dict, unsharded: dict) -> dict:
    """Phase 17a: train-4096-jamba-l3-4 through the sharded step: 16c's
    starting point placed on a (1, 1) mesh by ``param_specs`` (DTensor
    parameters, AdamW moments with their placements, the batch by
    ``data_specs``, ``act_spec`` as ``lower_cell`` builds it), one step
    held to 16c's unsharded step (``ref``: loss and every parameter within
    the train gate, the bits compared), then SHARDED_STEPS - 1 more
    steps timed (median of steps 2..8) and one under the profiler (idle
    share; DTensor's dispatch is host work).  ``unsharded`` is 16c's run
    in this process, printed beside it."""
    import gc
    import statistics
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.distributed.sharding import (NamedSharding, Spec,
                                                  data_specs, placements,
                                                  simple_batch_spec)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.data import batch_at, to_device
    mesh = start_card_group()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg, data_cfg, params, opt = _moe_cell_start(dev)
    params = reshard_tree(params, mesh)
    state = opt.init(list(params.parameters()))
    specs = data_specs(mesh, 1)
    bspec = simple_batch_spec(mesh, 1)
    act = NamedSharding(mesh, Spec(bspec[0] if len(bspec) else None, None,
                                   None))
    step = make_train_step(cfg, opt, act_spec=act)

    def placed(i):
        return {k: distribute_tensor(v, mesh, placements(specs[k], mesh),
                                     src_data_rank=None)
                for k, v in to_device(batch_at(data_cfg, i), dev).items()}

    params, state, loss = step(params, state, placed(0))
    torch.cuda.synchronize()
    errs, same = {}, 0
    names = [n for n, _ in params.named_parameters()]
    for name, p, want in zip(names, params.parameters(), ref["params"]):
        got = p.to_local().detach()
        w = want.to(dev)
        same += bool(torch.equal(got, w))
        errs[name] = float((got.float() - w.float()).norm() /
                           w.float().norm().clamp_min(1e-30))
        del w
    loss0 = float(loss)
    tol = GRAD_TOL["bfloat16"]
    worst = max(errs, key=errs.get)
    log(f"  first step against 16c's unsharded step on the same seed: loss "
        f"{loss0!r} vs {ref['loss']!r} ("
        f"{'the same bits' if loss0 == ref['loss'] else 'different bits'}); "
        f"parameters: {same} of {len(errs)} the same bits, normwise worst "
        f"{errs[worst]:.3e} ({worst}; gate {tol:.0e})")
    if not (abs(loss0 - ref["loss"]) <= tol * abs(ref["loss"]) and
            errs[worst] <= tol):
        raise AssertionError(f"the sharded step differs from the unsharded "
                             f"one: loss {loss0} vs {ref['loss']}, {errs}")
    times, losses = [], [loss0]
    for i in range(1, SHARDED_STEPS):
        batch = placed(i)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    batch = placed(SHARDED_STEPS)
    prof = profile_train_step(lambda: step(params, state, batch))
    peak = torch.cuda.max_memory_allocated(dev)
    ms = statistics.median(times)
    if not all(x == x and abs(x) < 1e9 for x in losses):
        raise AssertionError(f"sharded losses {losses}")
    log(f"  {SHARDED_STEPS} sharded steps: losses " + ", ".join(
        f"{x:.4f}" for x in losses) + f"; step ms after the first: median "
        f"{ms:.1f}, min {min(times):.1f} (16c unsharded in this run: median "
        f"{unsharded['step_ms_median']:.1f}; PR 23's 359.8); peak memory "
        f"{peak / 1e9:.2f} GB")
    if prof["measured"]:
        log(f"  one profiled sharded step: wall {prof['wall_ms']:.1f} ms, "
            f"device busy {prof['busy_ms']:.1f} ms, idle share "
            f"{100 * prof['idle_share']:.1f} % (16c's: "
            f"{100 * unsharded['profile'].get('idle_share', float('nan')):.1f}"
            f" %); by class: " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in sorted(
                    prof["by_class_ms"].items(), key=lambda kv: -kv[1])))
    mf = model_flops(cfg, "train", 1, TRAIN_SEQ, ms, card)
    log_model_flops("the sharded step", mf)
    return {"cell": "train-4096-jamba-l3-4", "mesh": [1, 1],
            "first_step": {"loss": loss0, "ref_loss": ref["loss"],
                           "same_bits_leaves": same, "leaves": len(errs),
                           "normwise": errs},
            "losses": losses, "steps_ms": times, "step_ms_median": ms,
            "step_ms_min": min(times),
            "unsharded_step_ms_median": unsharded["step_ms_median"],
            "peak_bytes": peak, "profile": prof, **mf,
            "state": (mesh, params)}


def check_elastic(dev, run: dict) -> dict:
    """Phase 17b: 17a's parameters checkpointed, then
    ``resume_on_mesh`` onto a fresh (1, 1) mesh (the tree given as fake
    tensors, so nothing is allocated twice): every parameter bit for bit,
    the step as saved.  The moments' placement is the parameters' (held
    on the CPU, ``tests/test_torch_distributed.py``); they are not
    written, to keep 27 GB of float32 off the disk.  Ends the process
    group."""
    import gc
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.elastic import resume_on_mesh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import abstract_params
    from repro_torch.train import checkpoint as ck
    _, params = run.pop("state")
    cfg = moe_cell_config()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        ck.save(ckpt, SHARDED_STEPS, params)
        t_save = time.perf_counter() - t0
        mesh = make_local_mesh(1, 1, device=dev)
        dtype = next(params.parameters()).dtype
        t0 = time.perf_counter()
        back, step = resume_on_mesh(ckpt, abstract_params(cfg, dtype, dev),
                                    mesh, step=SHARDED_STEPS)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same = sum(torch.equal(a.to_local(), b.to_local())
                   for a, b in zip(params.parameters(), back.parameters()))
        n = len(list(params.parameters()))
        placed = all(p.device_mesh == mesh for p in back.parameters())
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        dist.destroy_process_group()
    log(f"  17a's {n} parameters saved in {t_save:.1f} s, resumed onto a "
        f"fresh (1, 1) mesh in {t_restore:.1f} s at step {step}: {same} of "
        f"{n} the same bits, all on the new mesh: {placed}")
    if step != SHARDED_STEPS or same != n or not placed:
        raise AssertionError(f"elastic resume: step {step}, {same} of {n} "
                             f"equal, placed {placed}")
    del back
    gc.collect()
    torch.cuda.empty_cache()
    return {"leaves": n, "same_bits": same, "save_s": t_save,
            "restore_s": t_restore}


def start_dryrun() -> dict:
    """Phase 17c's children, started with the kernels' build (the dry run
    needs neither a card nor a kernel, and the build leaves the CPU's
    cores to spare; every timed phase runs after both are done): ``python
    -m repro_torch.launch.dryrun`` once a production mesh, jamba-v0.1-52b
    at full depth, DRYRUN_SHAPES, fake CUDA tensors, each child its own
    process (this process's NCCL group, 17a's, cannot become a fake one
    of 256 or 512 ranks)."""
    import os
    out_dir = OUT / "dryrun_torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            MOE_TRAIN_ARCH, "--shape", ",".join(DRYRUN_SHAPES), "--out",
            str(out_dir)]
    procs = {mesh: subprocess.Popen(base + flag, cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for mesh, flag in (("16x16", []),
                                ("2x16x16", ["--multi-pod"]))}

    def stop():        # a phase that fails before 17c leaves none behind
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()

    atexit.register(stop)
    return {"t0": time.perf_counter(), "out_dir": out_dir, "procs": procs}


def dryrun_path(run: dict) -> dict:
    """Phase 17c: the dry run's children (:func:`start_dryrun`) waited
    for; each cell's artifact read back and summed up.  A non-zero exit
    fails the phase."""
    outs, codes = {}, {}
    for mesh, proc in run["procs"].items():
        try:
            outs[mesh] = proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        codes[mesh] = proc.returncode
    wall_s = time.perf_counter() - run["t0"]
    out_dir = run["out_dir"]
    for mesh, text in outs.items():
        (OUT / f"dryrun_torch_{mesh}.log").write_text(text)
        tail = [ln for ln in text.splitlines()
                if ln.startswith("dry-run complete")]
        log(f"  python -m repro_torch.launch.dryrun --arch {MOE_TRAIN_ARCH} "
            f"--shape {','.join(DRYRUN_SHAPES)}"
            f"{' --multi-pod' if mesh != '16x16' else ''}: exit "
            f"{codes[mesh]}; {tail[-1] if tail else 'no summary line'}")
    log(f"  both meshes' children done {wall_s:.1f} s after they started "
        f"(with the kernels' build, two processes at once)")
    if any(codes.values()):
        raise AssertionError(f"the dry run failed: {codes}\n" + "\n".join(
            text[-3000:] for text in outs.values()))
    cells = {}
    for mesh in ("16x16", "2x16x16"):
        for shape in DRYRUN_SHAPES:
            meta = json.loads((out_dir / f"{MOE_TRAIN_ARCH}__{shape}__{mesh}"
                               f".json").read_text())
            cells[f"{shape}__{mesh}"] = meta
            ratio = meta["counted_flops"] / meta["flops"]
            log(f"  {shape} x {mesh} ({meta['strategy']}; traced in "
                f"{meta['trace_s']:.1f} s): flops per device analytic "
                f"{meta['flops']:.4e}, counted {meta['counted_flops']:.4e} "
                f"(ratio {ratio:.3f}); collective bytes " + ", ".join(
                    f"{k} {v:.3e}" for k, v in meta["coll_bytes"].items()
                    if v) + f"; bytes per device (traced) arguments "
                f"{meta['memory']['argument_bytes']:.3e}, peak "
                f"{meta['memory']['peak_bytes']:.3e}; roofline on H100 "
                f"rates: compute {meta['compute_s'] * 1e3:.2f} ms, memory "
                f"{meta['memory_s'] * 1e3:.2f} ms, collective "
                f"{meta['collective_s'] * 1e3:.2f} ms ({meta['dominant']})")
    return {"wall_s": wall_s, "cells": cells}


# --------------------------------------------- head dims that pad (6, 12c) --
#: attention at the head dims the kernels pad: (arch, hq, hkv, D, causal)
#: of hubert-xlarge (encoder, 1280 / 16) and phi3-mini-3.8b (3072 / 32) at
#: PAD_S tokens
PAD_ATTN = (("hubert-xlarge", 16, 16, 80, False),
            ("phi3-mini-3.8b", 32, 32, 96, True))
PAD_S = 4096


def check_padded_attention(card) -> dict:
    """Phase 6, head dims 80 and 96: the forward (zero-padded to 128 in
    the wrapper) against its plain version at the true D, in both dtypes
    and both masks, at hubert-xlarge's and phi3-mini-3.8b's attention
    widths over PAD_S tokens; each architecture's own mask timed beside
    SDPA at the same D and the bound at the true D."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     padded_head_dim)
    rng = np.random.default_rng(21)
    rows = []
    for arch, hq, hkv, d, own_causal in PAD_ATTN:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (1, hh, PAD_S, d)).astype(np.float32)).to("cuda", dtype)
                for hh in (hq, hkv, hkv))
            for causal in (own_causal, not own_causal):
                out = flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()       # a fault surfaces here
                ref = flash_attention_plain(q, k, v, bkv=128, causal=causal)
                err = rel_err(out, ref)
                if not err <= WIDE_TOL[name]:
                    raise AssertionError(
                        f"flash_attention disagrees with its plain version "
                        f"at {arch}'s head dim {d} ({name}, causal "
                        f"{causal}): normwise {err:.3e}")
                row = {"arch": arch, "d": d, "padded_to": padded_head_dim(d),
                       "dtype": name, "causal": causal, "s": PAD_S,
                       "normwise": err,
                       "max_abs_err": float((out.float() - ref.float())
                                            .abs().max())}
                del out, ref
                if causal == own_causal:
                    row["kernel_ms"] = event_ms(lambda: flash_attention(
                        q, k, v, causal=causal), TIME_REPS)
                    row["plain_ms"] = event_ms(lambda: flash_attention_plain(
                        q, k, v, bkv=128, causal=causal), 3)
                    qs, ks, vs = q, k.repeat_interleave(hq // hkv, 1), \
                        v.repeat_interleave(hq // hkv, 1)
                    row["library_ms"] = event_ms(
                        lambda: torch.nn.functional
                        .scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=causal),
                        TIME_REPS)
                    row.update(attn_fwd_bound(1, hq, hkv, PAD_S, d, causal,
                                              0, dtype, card))
                    row["padded_work"] = padded_head_dim(d) / d
                    log(f"  {arch} attention (1, {hq}, {PAD_S}, {PAD_S}, {d})"
                        f" {'causal' if causal else 'non-causal'} {name}, "
                        f"padded to {padded_head_dim(d)}: normwise "
                        f"{err:.3e} (bound {WIDE_TOL[name]:.3e}); kernel "
                        f"{row['kernel_ms']:.3f} ms, plain "
                        f"{row['plain_ms']:.3f} ms, SDPA at D {d} "
                        f"{row['library_ms']:.3f} ms, bound at the true D "
                        f"{row['bound_ms']:.3f} ms "
                        f"({row['bound_terms']}); the padded route does "
                        f"{row['padded_work']:.2f}x the needed work")
                else:
                    log(f"  {arch} attention at D {d}, "
                        f"{'causal' if causal else 'non-causal'} {name}: "
                        f"normwise {err:.3e} (bound {WIDE_TOL[name]:.3e})")
                rows.append(row)
            del q, k, v
    return {"padded_head_dims": rows}


def check_padded_models(dev) -> dict:
    """Phase 12c, head dims that pad: hubert-xlarge (D 80, non-causal, the
    audio frontend's frame embeddings) and phi3-mini-3.8b (D 96) at full
    width cut to CHECK_PERIODS layers, the kernel route's logits against
    the plain route's on the same parameters and inputs, both dtypes."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import forward, init_params
    res = {}
    for seed, (arch, *_rest) in enumerate(PAD_ATTN):
        cfg = dataclasses.replace(get_config(arch), n_layers=CHECK_PERIODS)
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            gen = torch.Generator(device=dev).manual_seed(600 + seed)
            params = init_params(cfg, gen, dtype, dev)
            if cfg.frontend == "none":
                inputs = model_inputs(cfg, 1, PAD_S, gen)
            else:
                inputs = torch.randn((1, PAD_S, cfg.frontend_dim),
                                     generator=gen, device=dev)
            calls = flash_attention.launches
            got = forward(cfg, params, inputs)
            torch.cuda.synchronize()
            calls = flash_attention.launches - calls
            want = forward(cfg, params, inputs, use_kernel=False)
            err = rel_err(got, want)
            tol = ROUTE_TOL[dtype_name]
            log(f"  {arch} {dtype_name} at {cfg.n_layers} layers (head dim "
                f"{cfg.head_dim_}), 1 x {PAD_S}: kernel route vs plain route"
                f" logits normwise {err:.3e} (bound {tol:.0e}); {calls} "
                f"attention kernel launches")
            if not (err <= tol and calls == cfg.n_layers and
                    torch.isfinite(got.float()).all()):
                raise AssertionError(f"{arch} {dtype_name}: the kernel route "
                                     f"disagrees ({err:.3e}) or launched "
                                     f"{calls} times")
            res[f"{arch}/{dtype_name}"] = {"layers": cfg.n_layers,
                                           "head_dim": cfg.head_dim_,
                                           "normwise": err, "tol": tol,
                                           "launches": calls}
            del params, inputs, got, want
            gc.collect()
            torch.cuda.empty_cache()
    return res


def serve_launcher() -> dict:
    """Phase 13e: ``python -m repro_torch.launch.serve --arch gemma2-27b``
    in a child process on the card, at the launcher's reduced defaults;
    its line must be the reference's."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--arch", "gemma2-27b"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    wall_s = time.perf_counter() - t0
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
        else ""
    log(f"  python -m repro_torch.launch.serve --arch gemma2-27b: exit "
        f"{proc.returncode} in {wall_s:.1f} s: {line}")
    if proc.returncode or not line.startswith("arch=gemma2-27b-smoke "
                                              "requests=6 decode_steps="):
        raise AssertionError(f"the serve launcher failed: {proc.returncode}"
                             f"\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return {"line": line, "wall_s": wall_s}


# ---------------------------------------------------------------- main --


def main() -> int:
    import re
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba_mixer as mm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.adamw import adamw_sqnorm, adamw_update
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.matmul import matmul, matmul_plain
    from repro_torch.kernels.ssd import ssd, ssd_bwd
    from repro_torch.models.layers import rmsnorm as norm_layer
    from repro_torch.models.mamba import mamba_forward
    from repro_torch.perf.roofline import card_of

    OUT.mkdir(parents=True, exist_ok=True)
    dev = resolve_device("cuda")
    line = card_line()
    log(f"[1] card: {line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    dry_run = start_dryrun()
    t0 = time.perf_counter()
    libs = _build.build_all(["matmul", "flash_attention",
                             "flash_attention_bwd", "ssd", "ssd_bwd",
                             "adamw", "mamba_mixer", "rmsnorm"])
    log(f"    kernel build (eight nvcc at once) "
        f"{time.perf_counter() - t0:.1f} s -> " +
        ", ".join(str(p.relative_to(ROOT)) for p in libs.values()))
    log("    nvcc seconds per source: " + ", ".join(
        f"{name} {_build.BUILD_SECONDS[name]:.1f}"
        if name in _build.BUILD_SECONDS else f"{name} already built"
        for name in libs))
    ptxas = {}
    for name, lib in libs.items():
        text = lib.with_suffix(".log").read_text()
        (OUT / f"ptxas_{name}.log").write_text(text)
        ptxas.update(ptxas_table(text))
        rows = list(ptxas_entries(text).values())
        if not rows:
            raise AssertionError(f"no ptxas report for {name}")
        log(f"    ptxas {name}: {len(rows)} instantiations, registers "
            f"{min(r[0] for r in rows)}-{max(r[0] for r in rows)}, "
            f"{sum(1 for r in rows if r[1])} spill")
    mm_wgmma_regs = {}
    for key, (nreg, st, ld) in sorted(ptxas.items()):
        if key[0] == "matmul_wgmma_kernel":
            mm_wgmma_regs[f"{key[1]} {key[2]}"] = {
                "registers": nreg, "spill_store_bytes": st,
                "spill_load_bytes": ld}
            log(f"    ptxas matmul_wgmma_kernel<{key[1]}, {key[2]}>: {nreg} "
                f"registers, spills {st} B stored / {ld} B loaded")
    if len(mm_wgmma_regs) != 10:
        raise AssertionError(f"ptxas reports {len(mm_wgmma_regs)} wgmma "
                             f"matmul kernels, not 10")
    # the SSD forward's wgmma route: chunk state, C B^T, chunk scan at each
    # of its two (P, N), none spilling
    ssd_wgmma_regs = {}
    for key, (nreg, st, ld) in sorted(ptxas.items()):
        if key[0] in ("ssd_chunk_state_wgmma_kernel", "ssd_cb_wgmma_kernel",
                      "ssd_chunk_scan_wgmma_kernel"):
            ssd_wgmma_regs[f"{key[0]}<{','.join(map(str, key[2]))}>"] = {
                "registers": nreg, "spill_store_bytes": st,
                "spill_load_bytes": ld}
            log(f"    ptxas {key[0]}<{key[2]}>: {nreg} registers, spills "
                f"{st} B stored / {ld} B loaded")
    spilled = [k for k, v in ssd_wgmma_regs.items()
               if v["spill_store_bytes"] or v["spill_load_bytes"]]
    if len(ssd_wgmma_regs) != 6 or spilled:
        raise AssertionError(f"ptxas reports {len(ssd_wgmma_regs)} wgmma SSD "
                             f"forward kernels, not 6, or spills in "
                             f"{spilled}")
    # the optimizer's kernels: each instantiation by its mangled name (the
    # update's (g, p) dtype pairs share ptxas_table's keys), none spilling
    adamw_regs = ptxas_entries(libs["adamw"].with_suffix(".log").read_text())
    for name, (nreg, st, ld) in sorted(adamw_regs.items()):
        short = re.search(r"\d+(adamw_[a-z_]+_kernel(?:I.*?E(?=Ev))?)", name)
        log(f"    ptxas {short.group(1) if short else name}: {nreg} "
            f"registers, spills {st} B stored / {ld} B loaded")
    spilled = [k for k, v in adamw_regs.items() if v[1] or v[2]]
    if len(adamw_regs) != ADAMW_INSTANTIATIONS or spilled:
        raise AssertionError(f"ptxas reports {len(adamw_regs)} adamw "
                             f"kernels, not {ADAMW_INSTANTIATIONS}, or "
                             f"spills in {spilled}")
    # the Mamba mixer's glue kernels, each instantiation by its mangled
    # name, none spilling
    mamba_regs = ptxas_entries(
        libs["mamba_mixer"].with_suffix(".log").read_text())
    for name, (nreg, st, ld) in sorted(mamba_regs.items()):
        short = re.search(r"\d+(mamba_[a-z_]+_kernel(?:I.*?E(?=Ev))?)", name)
        log(f"    ptxas {short.group(1) if short else name}: {nreg} "
            f"registers, spills {st} B stored / {ld} B loaded")
    spilled = [k for k, v in mamba_regs.items() if v[1] or v[2]]
    if len(mamba_regs) != MAMBA_INSTANTIATIONS or spilled:
        raise AssertionError(f"ptxas reports {len(mamba_regs)} mamba_mixer "
                             f"kernels, not {MAMBA_INSTANTIATIONS}, or spills "
                             f"in {spilled}")
    # the block norm's kernels, each instantiation by its mangled name,
    # none spilling
    norm_regs = ptxas_entries(libs["rmsnorm"].with_suffix(".log").read_text())
    for name, (nreg, st, ld) in sorted(norm_regs.items()):
        short = re.search(r"\d+(rmsnorm_[a-z_]+_kernel(?:I.*?E(?=Ev))?)", name)
        log(f"    ptxas {short.group(1) if short else name}: {nreg} "
            f"registers, spills {st} B stored / {ld} B loaded")
    spilled = [k for k, v in norm_regs.items() if v[1] or v[2]]
    if len(norm_regs) != RMSNORM_INSTANTIATIONS or spilled:
        raise AssertionError(f"ptxas reports {len(norm_regs)} rmsnorm "
                             f"kernels, not {RMSNORM_INSTANTIATIONS}, or "
                             f"spills in {spilled}")
    # the matmul's SASS for phase 5, the attention libraries' for phases 6
    # and 14a, the SSD forward's for 6 and its backward's for 15a, dumped
    # meanwhile
    sass_runs = {name: start_sass(libs[name])
                 for name in ("matmul", "flash_attention",
                              "flash_attention_bwd", "ssd", "ssd_bwd")}
    the_card = card_of(dev)
    phase_s = {}

    def phase(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[label] = time.perf_counter() - t
        log(f"    phase {label} took {phase_s[label]:.1f} s")
        return out

    log("[2] kernel check (CUDA matmul vs its plain version, both "
        "routes)")
    mm_table = check_matmul_tables()
    mm_phase2 = phase("2", check_kernel_shapes)
    log("    AdamW's kernels (adamw_update, adamw_sqnorm) vs their plain "
        "versions on the card")
    adamw_res = phase("2 adamw", check_adamw, the_card)
    log("    the Mamba mixer's kernels (mamba_in, mamba_out, mamba_out_bwd, "
        "mamba_in_bwd) vs their plain versions on the card")
    mamba_res = phase("2 mamba", check_mamba, the_card)
    log("    the block RMSNorm's kernels (rmsnorm_fwd, rmsnorm_bwd) vs their "
        "plain versions on the card")
    norm_res = phase("2 rmsnorm", check_rmsnorm, the_card, ptxas)

    # the main path: each of its paths runs with every kernel's count set
    # to 0 just before it and read just after
    wrappers = {"matmul": matmul, "flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd, "ssd": ssd,
                "ssd_bwd": ssd_bwd, "adamw_update": adamw_update,
                "adamw_sqnorm": adamw_sqnorm,
                **{k: getattr(mm, k) for k in MAMBA_KERNELS},
                **{k: getattr(rn, k) for k in RMSNORM_KERNELS}}
    launches = {name: {} for name in wrappers}
    # the attention forward's and backward's launches per route and path
    routed = {"matmul": matmul.launches_by_route,
              "flash_attention": flash_attention.route_launches,
              "flash_attention_bwd": flash_attention_bwd.route_launches,
              "ssd": ssd.route_launches,
              "ssd_bwd": ssd_bwd.route_launches,
              "mamba_mixer": mamba_forward.route_calls,
              "rmsnorm": norm_layer.route_calls}
    by_route = {name: {} for name in routed}
    route_launches = by_route["flash_attention"]

    def counted(path, label, fn, *args):
        """Run ``fn`` as phase ``label`` with every count set to 0 just
        before it, and add the counts read just after to ``path``'s (the
        train path is 14c and 15c)."""
        for w in wrappers.values():
            w.launches = 0
        for routes in routed.values():
            for r in routes:
                routes[r] = 0
        out = phase(label, fn, *args)
        for name, w in wrappers.items():
            launches[name][path] = launches[name].get(path, 0) + w.launches
        for name, routes in routed.items():
            into = by_route[name].setdefault(path, dict.fromkeys(routes, 0))
            for r, n in routes.items():
                into[r] += n
        return out

    log(f"[3] paper path: potrf at n={N}, b in {BLOCK_SIZES}")
    paper = counted("paper", "3", paper_path, dev)
    log("[4] tile path: CUDA matmul tiles for 4096^3")
    tuned = counted("tiles", "4", tune_tiles, dev)
    paper_models = paper.pop("models")
    paper["copy_share"] = transfer_shares(paper_models, *tuned["transfer"])
    tiles = phase("4 check", check_tiles, dev, tuned)

    bm, bn, bk = tiles["choice"]
    log(f"[5] 4096^3 float32 at the selected {tiles['choice']} "
        f"({tiles['route']}) and bfloat16 at its fastest wgmma tile")
    mm_rows = phase("5", matmul_rows, tiles, the_card)
    tiles["phase5"] = mm_rows
    mm_sass = check_matmul_sass(sass_runs["matmul"])

    log("[6] kernel check (CUDA flash attention and SSD vs their plain "
        "versions)")
    wide = phase("6 attention", check_attention, the_card,
                 sass_runs["flash_attention"])
    wide.update(phase("6 padded", check_padded_attention, the_card))
    wide.update(phase("6 ssd", check_ssd, the_card, sass_runs["ssd"]))

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
    model_checks["padded_head_dims"] = phase("12c padded",
                                             check_padded_models, dev)

    log(f"[13] serve path: {', '.join(a for a, _ in SERVE_RUNS)} served "
        f"through the port's ServeEngine ({SERVE_SLOTS} slots x "
        f"{SERVE_CTX}), the step-cost model, FIFO against guided, then the "
        f"checks at {CHECK_PERIODS} periods")
    serving = counted("serve", "13", serve_path, dev)
    serve_checks = phase("13 check", check_serve, dev)
    log("[13e] the serve launcher, in a child process")
    serve_checks["launcher"] = phase("13e", serve_launcher)

    log(f"[14] train path: the attention backward kernels, {TRAIN_ARCH}'s "
        f"gradients at full width, {TRAIN_STEPS} AdamW steps at full width "
        f"({TRAIN_PERIODS} periods, 1 x {TRAIN_SEQ} tokens, bfloat16), "
        f"resume")
    log("[14a] attention backward kernels vs their plain version")
    attn_bwd = phase("14a", check_attention_bwd, the_card,
                     sass_runs["flash_attention_bwd"])
    log(f"[14b] {TRAIN_ARCH} gradients at full width: kernel route vs plain "
        f"route")
    train_grads = phase("14b", check_train_grads, dev)
    log(f"[14c] {TRAIN_ARCH} trained at full width through train()")
    training = counted("train", "14c", train_path, dev, the_card)
    log("[14d] resume after an asynchronous checkpoint, on the card")
    resume = phase("14d", check_resume, dev)

    log(f"[15] Mamba train path: the SSD backward kernels, "
        f"{SSD_TRAIN_ARCH}'s gradients at full width, {TRAIN_STEPS} AdamW "
        f"steps at full width ({SSD_TRAIN_LAYERS} layers, 1 x {TRAIN_SEQ} "
        f"tokens, bfloat16)")
    log("[15a] SSD backward kernels vs their plain version")
    ssd_bwd_res = phase("15a", check_ssd_bwd, the_card,
                        sass_runs["ssd_bwd"])
    log(f"[15b] {SSD_TRAIN_ARCH} gradients at full width: kernel route vs "
        f"plain route")
    ssd_grads = phase("15b", check_ssd_train_grads, dev)
    log(f"[15c] {SSD_TRAIN_ARCH} trained at full width through train()")
    ssd_training = counted("train", "15c", ssd_train_path, dev, the_card)

    log(f"[16] MoE train path, cell train-4096-jamba-l3-4: {MOE_TRAIN_ARCH} "
        f"at full width cut to layers 3 and 4 of its period (Mamba + "
        f"16-expert MoE, attention + dense FFN); the SSD kernels at its "
        f"widths, its gradients kernel vs plain route, {TRAIN_STEPS} AdamW "
        f"steps (1 x {TRAIN_SEQ} tokens, bfloat16), remat_policy=\"dots\"")
    log(f"[16a] the SSD kernels at {MOE_TRAIN_ARCH}'s widths "
        f"{MOE_SSD_PROBLEM}")
    jamba_ssd = phase("16a", check_jamba_ssd, the_card)
    log(f"[16b] {MOE_TRAIN_ARCH} layers 3-4 gradients at full width: kernel "
        f"route vs plain route")
    moe_grads = phase("16b", check_moe_train_grads, dev)
    log(f"[16c] {MOE_TRAIN_ARCH} layers 3-4 trained at full width through "
        f"train()")
    moe_training = counted("train_moe", "16c", moe_train_path, dev,
                           the_card)
    log("[16d] remat_policy=\"dots\" against \"full\" on 16c's parameters")
    dots = phase("16d", check_dots, dev, the_card, moe_training)

    log(f"[17] distributed path: the sharded train step of "
        f"train-4096-jamba-l3-4 on a (1, 1) mesh (NCCL, world 1), elastic "
        f"resume, the dry run of {MOE_TRAIN_ARCH} on the production meshes")
    log("[17a] 16c's unsharded step, then the sharded step (DTensor "
        "parameters by param_specs, act_spec)")
    ref17 = phase("17a check", unsharded_reference_step, dev)
    sharded = counted("train_sharded", "17a", sharded_train_path, dev,
                      the_card, ref17, moe_training)
    del ref17
    log("[17b] elastic: 17a's parameters resumed onto a fresh (1, 1) mesh")
    elastic = phase("17b", check_elastic, dev, sharded)
    log(f"[17c] dry run: {MOE_TRAIN_ARCH} x {DRYRUN_SHAPES} x (16x16, "
        f"2x16x16), full depth, in two child processes started with the "
        f"build")
    dry = phase("17c", dryrun_path, dry_run)
    exact_launches(f"{SHARDED_STEPS + 1} sharded steps",
                   {k: launches[k]["train_sharded"] for k in (
                       "flash_attention", "flash_attention_bwd", "ssd",
                       "ssd_bwd", "adamw_update", "adamw_sqnorm",
                       *MAMBA_KERNELS, *RMSNORM_KERNELS)},
                   {"flash_attention": 2 * (SHARDED_STEPS + 1),
                    "flash_attention_bwd": SHARDED_STEPS + 1,
                    "ssd": 2 * (SHARDED_STEPS + 1),
                    "ssd_bwd": SHARDED_STEPS + 1,
                    **mixer_want(2 * (SHARDED_STEPS + 1), SHARDED_STEPS + 1),
                    **norm_want(moe_cell_config(), SHARDED_STEPS + 1),
                    **adamw_want(SHARDED_STEPS + 1,
                                 moe_training["tensors"])})

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
            log(f"  {name} ({what}) at its selected config: "
                f"{key[0]}<{key[2]}> ({key[1]}) uses "
                f"{r['registers']} registers, spills "
                f"{r['spill_store_bytes']} B stored / "
                f"{r['spill_load_bytes']} B loaded (ptxas)")
    log(f"  launches on the main path, per kernel and path: {launches}")
    log(f"  the matmul's, the attention forward's and backward's and the "
        f"SSD forward's and backward's launches per route and path, and the "
        f"Mamba mixer's and the block norm's calls per route and path: "
        f"{by_route}")
    # every Mamba layer of the models, serve and train paths goes through
    # the mixer's kernels: its composite route (torch ops around the SSD
    # kernel, for meshes that split the heads) and the plain one never run,
    # the sharded step's layers on local shards, prefill and train on the
    # kernel span, decode steps on the decode route
    for path, want in (("models", ("mixer", "decode")),
                       ("serve", ("mixer", "decode")),
                       ("train", ("mixer",)), ("train_moe", ("mixer",)),
                       ("train_sharded", ("mixer_local",))):
        got = by_route["mamba_mixer"][path]
        if got["composite"] or got["reference"] or \
                any(got[r] <= 0 for r in want):
            raise AssertionError(f"the Mamba mixer on path {path} did not "
                                 f"take its kernel routes {want}: {got}")
    # every block and final norm of the models, serve and train paths takes
    # the norm's kernels, the sharded step's on local shards; the plain
    # route (real CPU tensors) and the reference route (use_kernel=False)
    # never run there
    for path, want in (("models", "kernel"), ("serve", "kernel"),
                       ("train", "kernel"), ("train_moe", "kernel"),
                       ("train_sharded", "local")):
        got = by_route["rmsnorm"][path]
        if got[want] <= 0 or any(n for r, n in got.items() if r != want):
            raise AssertionError(f"the block norm on path {path} did not all "
                                 f"take its route {want}: {got}")
    # the tile path and the store launch the matmul on the selected tile's
    # route; the tile path's sweep launches both routes
    for path in ("tiles", "store"):
        got = by_route["matmul"][path]
        if got[tiles["route"]] <= 0:
            raise AssertionError(f"matmul on path {path} never took the "
                                 f"selected tile's route: {got}")
    if min(by_route["matmul"]["tiles"].values()) <= 0:
        raise AssertionError(f"the tile path's sweep did not launch both "
                             f"matmul routes: {by_route['matmul']}")
    # every attention call of gemma2-27b's prefill (12) and of the train
    # steps (14c, 16c, 17a), forward and backward, and every SSD forward
    # and backward of the train steps (15c, 16c, 17a) takes the wgmma route
    for name, paths in (("flash_attention", ("models", "train", "train_moe",
                                             "train_sharded")),
                        ("flash_attention_bwd", ("train", "train_moe",
                                                 "train_sharded")),
                        ("ssd", ("train", "train_moe", "train_sharded")),
                        ("ssd_bwd", ("train", "train_moe",
                                     "train_sharded"))):
        for path in paths:
            got = by_route[name][path]
            if got["mma_sync"] or got["wgmma"] != launches[name][path]:
                raise AssertionError(f"{name} on path {path} did not all "
                                     f"take the wgmma route: {got}")
    for name, path in (("matmul", "tiles"), ("flash_attention", "attn_tiles"),
                       ("ssd", "ssd_chunks"), ("matmul", "store"),
                       ("flash_attention", "store"), ("ssd", "store"),
                       ("flash_attention", "models"), ("ssd", "models"),
                       ("flash_attention", "serve"), ("ssd", "serve"),
                       ("flash_attention", "train"),
                       ("flash_attention_bwd", "train"), ("ssd", "train"),
                       ("ssd_bwd", "train"), ("flash_attention", "train_moe"),
                       ("flash_attention_bwd", "train_moe"),
                       ("ssd", "train_moe"), ("ssd_bwd", "train_moe"),
                       ("flash_attention", "train_sharded"),
                       ("flash_attention_bwd", "train_sharded"),
                       ("ssd", "train_sharded"),
                       ("ssd_bwd", "train_sharded"),
                       ("adamw_update", "train"), ("adamw_sqnorm", "train"),
                       ("adamw_update", "train_moe"),
                       ("adamw_sqnorm", "train_moe"),
                       ("adamw_update", "train_sharded"),
                       ("adamw_sqnorm", "train_sharded"),
                       *((k, path) for path in ("models", "serve")
                         for k in ("mamba_in", "mamba_out", "rmsnorm_fwd")),
                       *((k, path) for path in ("train", "train_moe",
                                                "train_sharded")
                         for k in RMSNORM_KERNELS),
                       *((k, path) for path in ("train", "train_moe",
                                                "train_sharded")
                         for k in MAMBA_KERNELS)):
        if launches[name][path] <= 0:
            raise AssertionError(f"the main path never launched {name} on "
                                 f"its path {path}: {launches[name]}")

    launches["adamw"] = {
        path: launches["adamw_update"][path] + launches["adamw_sqnorm"][path]
        for path in launches["adamw_update"]}

    def entry(name, source, replaces, res, registers, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches[name].values()),
                "launches_by_path": launches[name],
                "max_abs_err": res["err"], "ms": res["kernel_ms"],
                "kernel_ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"],
                "bound_by": "bytes" if res["bound_by"] == "bytes"
                else "operations",
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
    bwd_regs = dict(regs["flash_attention_bwd"])
    key = ("attn_bwd_delta_kernel", "float32", ())
    if key not in ptxas:
        raise AssertionError(f"no ptxas report for the backward's {key}")
    bwd_regs["delta"] = dict(zip(("registers", "spill_store_bytes",
                                  "spill_load_bytes"), ptxas[key]))

    def in_train_step(kernel, run=training, key="train_step"):
        prof = run["profile"]
        if not prof["measured"]:
            return {key: {"measured": False}}
        ms = prof["by_class_ms"].get(kernel, 0.0)
        return {key: {
            "arch": run["arch"], "layers": run["layers"],
            "tokens": run["tokens"], "dtype": "bfloat16",
            "step_wall_ms": prof["wall_ms"], "kernel_ms": ms,
            "kernel_share": ms / prof["wall_ms"]}}
    ssd_bwd_regs = {}
    wg_key, sync_key = SSD_BWD_MAIN_KEY, SSD_BWD_SYNC_KEY
    jamba_key = SSD_BWD_WGMMA_KEYS[1]
    for what, key in (
            ("chunk", ("ssd_bwd_chunk_wgmma_kernel", "float32", wg_key)),
            ("dstate", ("ssd_bwd_dstate_wgmma_kernel", "float32", wg_key)),
            ("cb", ("ssd_bwd_cb_kernel", "float32", wg_key)),
            ("chunk_jamba", ("ssd_bwd_chunk_wgmma_kernel", "float32",
                             jamba_key)),
            ("dstate_jamba", ("ssd_bwd_dstate_wgmma_kernel", "float32",
                              jamba_key)),
            ("split", ("ssd_bwd_split_kernel", "float32", ())),
            ("dt", ("ssd_bwd_dt_kernel", "float32", ())),
            ("state_pass", ("ssd_bwd_state_pass_kernel", "float32", ())),
            ("finish", ("ssd_bwd_finish_kernel", "float32", ())),
            ("chunk_mma_sync", ("ssd_bwd_chunk_kernel", "float32",
                                sync_key)),
            ("dstate_mma_sync", ("ssd_bwd_dstate_kernel", "float32",
                                 sync_key[:2]))):
        if key not in ptxas:
            raise AssertionError(f"no ptxas report for the SSD backward's "
                                 f"{key}")
        ssd_bwd_regs[what] = dict(zip(("registers", "spill_store_bytes",
                                       "spill_load_bytes"), ptxas[key]))
        log(f"  ssd_bwd's {what} pass {key[0]}<{key[2]}> uses "
            f"{ssd_bwd_regs[what]['registers']} registers, spills "
            f"{ssd_bwd_regs[what]['spill_store_bytes']} B stored / "
            f"{ssd_bwd_regs[what]['spill_load_bytes']} B loaded (ptxas)")
    kernels = {"kernels": [
        entry("matmul", f"{csrc}/matmul.cu",
              "src/repro/kernels/matmul.py:27 (_matmul_kernel)",
              mm_rows["float32"], regs["matmul"]["matmul"],
              library="torch.matmul (TF32 off)", shape=[N, N, N],
              dtype="float32", config=[bm, bn, bk],
              route_detail="two routes by an explicit table "
              "(matmul_route): wgmma (bfloat16 at bm in {64, 128}, bn in "
              "{64, 128, 256}, bk 64 from the caller's tensors; float32 at "
              "bm, bn in {64, 128}, bk 32 as 3xTF32 on x and y^T split once "
              "into a scratch; a producer warp's TMA ring, bm / 64 consumer "
              "warpgroups) and ffma (every other legal tile, FP32 FFMA); "
              "this row is float32 at the tile path's selection, "
              "'bfloat16' the wgmma route's fastest tile",
              route=mm_rows["float32"]["route"],
              launches_by_route=by_route["matmul"],
              bound_ms_ffma=mm_rows["float32"]["bound_ms_ffma"],
              bfloat16=mm_rows["bfloat16"],
              routes={r: {"dtype": "float32",
                          **tiles["fastest_by_route"][r]}
                      for r in ("wgmma", "ffma")},
              tile_path={k: tiles[k] for k in (
                  "rank_of_choice", "n_legal", "tau", "best", "best_ms",
                  "best_route", "within_best")},
              wgmma_registers=mm_wgmma_regs, sass=mm_sass,
              phase2=mm_phase2, route_table=mm_table,
              nvcc_s=_build.BUILD_SECONDS.get("matmul")),
        entry("flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:37 (_attn_kernel)",
              attn, regs["flash_attention"]["mma_sync"],
              library="torch.nn.functional.scaled_dot_product_attention"
              " (is_causal=True, float32, TF32 off)",
              shape=list(ATTN_PROBLEM), dtype="float32",
              config=list(attn["choice"]),
              route_detail="two routes by an explicit table: wgmma "
              "(bfloat16 at bq, bkv in {64, 128}, D in {64, 128}; TMA from a "
              "producer warp, m64nNk16, O in the tensor core) and mma.sync "
              "(the rest; bfloat16 m16n8k16, float32 3xTF32, short chains); "
              "this row is float32 on mma.sync, 'bfloat16' the wgmma route",
              routes={"mma_sync": {
                  "dtype": "float32", "config": list(attn["choice"]),
                  "kernel_ms": attn["kernel_ms"],
                  "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
                  "registers": regs["flash_attention"]["mma_sync"]},
                  "wgmma": {
                      "dtype": "bfloat16", "config": list(WGMMA_MAIN_KEY),
                      "kernel_ms": attn_bwd["forward_bfloat16"]["kernel_ms"],
                      "bound_ms": attn_bwd["forward_bfloat16"]["bound_ms"],
                      "bound_by": attn_bwd["forward_bfloat16"]["bound_by"],
                      "registers": regs["flash_attention"]["wgmma"]}},
              launches_by_route=route_launches,
              bound_ms_ffma=attn["bound_ms_ffma"],
              bound_terms=attn["bound_terms"],
              fwd_sass=wide["fwd_sass"],
              bfloat16=attn_bwd["forward_bfloat16"],
              bfloat16_blocks=attn["bfloat16_blocks"],
              head_dim_96=[r for r in wide["padded_head_dims"]
                           if r["d"] == 96 and "kernel_ms" in r],
              **in_prefill("flash_attention"),
              **in_admission("flash_attention"),
              **in_train_step("flash_attention"),
              **in_train_step("flash_attention", moe_training,
                              "train_moe_step")),
        entry("flash_attention_bwd", f"{csrc}/flash_attention_bwd.cu",
              "none: no Pallas body. The backward of "
              "src/repro/kernels/flash_attention.py:37 (_attn_kernel), which "
              "the reference differentiates in XLA through "
              "src/repro/models/attention.py:24 (chunked_attention)",
              attn_bwd, bwd_regs["dkdv"],
              library="the backward of torch.nn.functional."
              "scaled_dot_product_attention (is_causal=True, float32, TF32 "
              "off)", shape=list(ATTN_PROBLEM), dtype="float32",
              route_detail="two routes by an explicit table: wgmma "
              "(bfloat16 at blocks 64 / 128, D in {64, 128}; TMA from a "
              "producer warp, dK/dV over 64 kv rows a block with chains "
              "flushed to float32 sums, dQ by two consumer warpgroups, dS "
              "as hi + lo) and mma.sync (float32 as 3xTF32, bfloat16's "
              "other configs); this row is float32 on mma.sync, 'bfloat16' "
              "the wgmma route",
              routes={"mma_sync": {
                  "dtype": "float32",
                  "config": [attn_bwd["blk"], attn_bwd["blk"],
                             ATTN_PROBLEM[4]],
                  "kernel_ms": attn_bwd["kernel_ms"],
                  "bound_ms": attn_bwd["bound_ms"],
                  "bound_by": attn_bwd["bound_by"],
                  "registers": {k: bwd_regs[k] for k in ("dkdv", "dq")}},
                  "wgmma": {
                      "dtype": "bfloat16",
                      "config": [attn_bwd["bfloat16"]["blk"],
                                 attn_bwd["bfloat16"]["blk"],
                                 ATTN_PROBLEM[4]],
                      "kernel_ms": attn_bwd["bfloat16"]["kernel_ms"],
                      "bound_ms": attn_bwd["bfloat16"]["bound_ms"],
                      "bound_by": attn_bwd["bfloat16"]["bound_by"],
                      "registers": {k: bwd_regs[k] for k in (
                          "dkdv_wgmma", "dq_wgmma")}}},
              launches_by_route=by_route["flash_attention_bwd"],
              bound_ms_ffma=attn_bwd["bound_ms_ffma"],
              bfloat16=attn_bwd["bfloat16"], sass=attn_bwd["sass"],
              config=[attn_bwd["blk"], attn_bwd["blk"], ATTN_PROBLEM[4]],
              passes_registers=bwd_regs, **in_train_step(
                  "flash_attention_bwd"), **in_train_step(
                  "flash_attention_bwd", moe_training, "train_moe_step")),
        entry("ssd", f"{csrc}/ssd.cu",
              "src/repro/kernels/ssd.py:30 (_ssd_kernel)", ssd_res,
              regs["ssd"]["chunk_scan"], library="none",
              shape=list(SSD_PROBLEM), dtype="float32",
              config=list(ssd_res["choice"]),
              route_detail="two routes by an explicit table (ssd_route): "
              "wgmma at (P, N) in {(64, 128), (64, 16)} and a chunk that is "
              "a multiple of 64 (float32 as 3xTF32: the chunk state and "
              "chunk scan on wgmma, raw tiles by TMA split into K-major hi / "
              "lo tiles in the kernels, C B^T formed once a group by a "
              "pre-pass), mma_sync for every other (P, N) and chunks 16 and "
              f"32; {ssd_res['heads']['chunk_state']} heads a chunk-state "
              f"block, {ssd_res['heads']['chunk_scan']} a chunk-scan block; "
              "the state pass elementwise",
              route=ssd_res["route"], launches_by_route=by_route["ssd"],
              routes_ranked=ssd_res["routes"],
              fastest_by_route=ssd_res["fastest_by_route"],
              route_table=wide["ssd_routes"],
              wgmma_registers=ssd_wgmma_regs,
              bound_ms_ffma=ssd_res["bound_ms_ffma"],
              sass_counts=wide["ssd_sass"],
              passes_ms=ssd_res["passes_ms"],
              passes_ms_model_chunk=ssd_res["passes_ms_model_chunk"],
              passes_registers=regs["ssd"],
              **in_prefill("ssd"), **in_admission("ssd"),
              **in_train_step("ssd", ssd_training),
              **in_train_step("ssd", moe_training, "train_moe_step"),
              jamba_width=jamba_ssd["forward"],
              jamba_check=wide["jamba_v0_1_52b"]),
        entry("ssd_bwd", f"{csrc}/ssd_bwd.cu",
              "none: no Pallas body. The backward of "
              "src/repro/kernels/ssd.py:30 (_ssd_kernel), which the "
              "reference differentiates in XLA through "
              "src/repro/models/mamba.py:55 (_ssd_chunked)", ssd_bwd_res,
              ssd_bwd_regs["chunk"], library="none",
              shape=list(SSD_PROBLEM), dtype="float32",
              config=[SSD_MODEL_CHUNK, SSD_PROBLEM[3], SSD_PROBLEM[5]],
              route_detail="two routes by an explicit table "
              "(ssd_bwd_route): wgmma at (P, N) in {(64, 128), (64, 16)} and a"
              " chunk that is a multiple of 64 (float32 as 3xTF32 from split "
              "K-major tiles of a scratch, a producer warp streaming them by "
              "bulk copies, C B^T formed once a group; this row), mma_sync "
              "for every other (P, N) and chunks 16 and 32; a chunk-pass "
              f"block sums db and dc over {ssd_bwd_res['heads']} heads",
              route=ssd_bwd_res["route"],
              launches_by_route=by_route["ssd_bwd"],
              route_bound_ms=ssd_bwd_res["route_bound_ms"],
              route_bound_by=ssd_bwd_res["route_bound_by"],
              scratch_bytes=ssd_bwd_res["scratch_bytes"],
              bound_ms_ffma=ssd_bwd_res["bound_ms_ffma"],
              sass=ssd_bwd_res["sass"],
              route_table=ssd_bwd_res["route_table"],
              passes_ms=ssd_bwd_res["passes_ms"],
              passes_registers=ssd_bwd_regs,
              chunk_64=ssd_bwd_res["mamba2_2_7b"][64],
              jamba_widths=ssd_bwd_res["jamba_v0_1_52b"],
              **in_train_step("ssd_bwd", ssd_training),
              **in_train_step("ssd_bwd", moe_training, "train_moe_step"),
              jamba_width=jamba_ssd["backward"]),
        entry("adamw", f"{csrc}/adamw.cu",
              "none: the reference's update is fused by XLA under jit, "
              "src/repro/train/optimizer.py:50-58", adamw_res,
              {"registers": max(v[0] for v in adamw_regs.values()),
               "spill_store_bytes": sum(v[1] for v in adamw_regs.values()),
               "spill_load_bytes": sum(v[2] for v in adamw_regs.values())},
              library=f"torch._fused_adamw_ on {adamw_res['library_on']}: "
              "a time only, it rounds in another order and decays every "
              "tensor", shape=list(ADAMW_EMBED), dtype="bfloat16",
              route_detail="two kernels: adamw_update (one pass over g, m, "
              "v and p a tensor, p written in place on the train step; this "
              "row, at gemma2-27b's embedding) and adamw_sqnorm (each "
              "gradient's float64-summed squares, a fixed-order finish; "
              "'sqnorm'); every operation rounded as the plain version's "
              "torch kernels, the same bits",
              launches_by_kernel={k: launches[k] for k in (
                  "adamw_update", "adamw_sqnorm")},
              sqnorm=adamw_res["sqnorm"], cases=adamw_res["cases"],
              adamw_level=adamw_res["adamw_level"],
              u_written_ms=adamw_res["u_written_ms"],
              registers_by_kernel=adamw_regs,
              **in_train_step("adamw"),
              **in_train_step("adamw", ssd_training, "train_mamba_step"),
              **in_train_step("adamw", moe_training, "train_moe_step")),
        *(entry(k, f"{csrc}/mamba_mixer.cu",
                "none: the Mamba-2 mixer's glue, XLA-fused in the "
                "reference (src/repro/models/mamba.py:110,126-131)",
                mamba_res["kernels"][k],
                {"registers": max(v[0] for n, v in mamba_regs.items()
                                  if any(e in n for e in MAMBA_ENTRIES[k])),
                 "spill_store_bytes": 0, "spill_load_bytes": 0},
                library="none: no single PyTorch call computes the glue",
                shape=list(MAMBA_WIDTHS[0][1]), dtype="bfloat16",
                route_detail=MAMBA_DETAIL[k],
                rows={key: rows[k] for key, rows in
                      mamba_res["timed"].items()},
                checks={key: res[k] for key, res in
                        mamba_res["cases"].items()},
                params={key: res["params"] for key, res in
                        mamba_res["cases"].items()},
                launches_by_route=by_route["mamba_mixer"],
                **in_train_step("mamba_mixer", ssd_training,
                                "train_mamba_step"),
                **in_train_step("mamba_mixer", moe_training,
                                "train_moe_step"))
          for k in MAMBA_KERNELS),
        *(entry(k, f"{csrc}/rmsnorm.cu",
                "none: the block RMSNorm, XLA-fused in the reference "
                "(src/repro/models/layers.py:11-16)",
                norm_res["kernels"][k],
                {"registers": max(v[0] for n, v in norm_regs.items()
                                  if any(e in n for e in RMSNORM_ENTRIES[k])),
                 "spill_store_bytes": 0, "spill_load_bytes": 0},
                library="torch.nn.functional.rms_norm, weight 1 + scale in "
                "the model's dtype (its backward through autograd)",
                shape=[TRAIN_SEQ, RMSNORM_WIDTHS[0]], dtype="bfloat16",
                route_detail=RMSNORM_DETAIL[k],
                rows={key: rows[k] for key, rows in
                      norm_res["timed"].items()},
                checks=norm_res["cases"],
                launches_by_route=by_route["rmsnorm"],
                **in_train_step("rmsnorm"),
                **in_train_step("rmsnorm", ssd_training,
                                "train_mamba_step"),
                **in_train_step("rmsnorm", moe_training, "train_moe_step"))
          for k in RMSNORM_KERNELS),
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
         "train_mamba": {"ssd_bwd": ssd_bwd_res, "grads": ssd_grads,
                         "run": ssd_training},
         "train_moe": {"ssd_jamba": jamba_ssd, "grads": moe_grads,
                       "run": moe_training, "dots": dots},
         "distributed": {"sharded_step": sharded, "elastic": elastic,
                         "dryrun": dry},
         "adamw": adamw_res, "mamba_mixer": mamba_res, "rmsnorm": norm_res,
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
