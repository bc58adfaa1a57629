#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

It builds the hand-written CUDA matmul from ``src/repro_torch/kernels/
csrc`` (into ``build/repro_torch_kernels/``), holds it against its plain
PyTorch version, and runs the paper's pipeline end to end on the card:

1. card and kernel build;
2. kernel check: the CUDA matmul against its plain version on the test
   shapes and on a shape for each of its (bm, bn) instantiations (float32
   and bfloat16);
3. the paper's path at n = 4096: generate potf2/trsm/syrk/gemm models on
   the card over the domains the Cholesky tracers call, rank the three
   potrf variants and the block size without executing them, then execute
   them through ``ExecEngine`` and compare predicted with measured times;
4. the tile path: sweep every legal tile of the CUDA matmul on its proxy
   problem, fit the transfer models and select the tile for 4096^3; then
   run every legal tile at 4096^3, check each result against the plain
   version and compare predicted with measured order;
5. a ``kernels`` JSON line per ported kernel (launches on each path of the
   main run, error, times and bound).

The card's name and power limit print on the line before the last; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises, so the
script exits nonzero and prints no result.  Long outputs (the compiler's
report, the fitted models, per-tile times) go to ``chiprun_out/chip_smoke/``.
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
BLOCK_SIZES = (64, 96, 128, 192, 256, 384, 512)
#: benchmarks/common.py BENCH_GEN_CONFIG, the reference's generator setup
GEN_CONFIG = dict(overfit=0, oversampling=2, repetitions=5,
                  error_bound=0.04, min_width=64, max_pieces=6)
EXEC_REPS = 3                              # executions per measured point
TILE_PASSES = 5                            # sweep passes per tile config
TIME_REPS = 10                             # launches per kernel timing
TEST_SHAPES = [(128, 128, 128, 64, 64, 64), (256, 128, 192, 128, 64, 64),
               (64, 64, 64, 64, 64, 64), (256, 256, 256, 128, 128, 128),
               (384, 128, 256, 128, 128, 64)]
#: slab depths the kernel is built for, cycled over the instantiation shapes
KERNEL_BKS = (8, 16, 32, 64)
#: relative normwise bound of the 4096^3 float32 check: float32 rounding
#: grows like sqrt(k) * eps over a k = 4096 sum, in both versions
BIG_TOL = 1e-5


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


# ------------------------------------------------------------ phase 2 --
def check_kernel_shapes() -> None:
    """The test shapes, then one shape per (bm, bn) instantiation of the
    kernel (a 2 x 3 grid of blocks, 4 k-slabs), each in both dtypes."""
    import numpy as np
    import torch
    from repro_torch.kernels.matmul import KERNEL_TILES, matmul, matmul_plain

    shapes = list(TEST_SHAPES) + [
        (2 * bm, 3 * bn, 4 * bk, bm, bn, bk)
        for (bm, bn), bk in zip(KERNEL_TILES,
                                KERNEL_BKS * len(KERNEL_TILES))]
    rng = np.random.default_rng(7)
    for m, n, k, bm, bn, bk in shapes:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(
                np.float32)).to("cuda", dtype)
            y = torch.from_numpy(rng.standard_normal((k, n)).astype(
                np.float32)).to("cuda", dtype)
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
        f"performance yield {yld:.4f}")
    L = torch.tril(torch.from_numpy(factor).to(dev, torch.float64))
    rel = float(torch.linalg.norm(L - L64) / torch.linalg.norm(L64))
    log(f"  factor vs float64 cholesky: normwise rel err {rel:.3e} "
        f"(bound 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError(f"potrf factor error {rel} above 1e-4")
    return {"models": models, "n": N, "gen_s": gen_s,
            "predicted_best": best_name,
            "b_pred": b_pred, "measured_winner": winner, "b_opt": b_opt,
            "yield": yld,
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
    return {"legal": legal, "ranked": ranked, "transfer": (h2d, d2h),
            "choice": (choice.bm, choice.bn, choice.bk),
            "t_compute": choice.t_compute,
            "analytic": (analytic.bm, analytic.bn, analytic.bk)}


def check_tiles(dev, tuned: dict) -> dict:
    """Run every legal tile at 4096^3: hold each result against the plain
    version (which depends only on bk) and time it, then compare the
    measured order with the predicted one.  Not part of the port's path:
    its launches are not counted."""
    import numpy as np
    import torch
    from repro_torch.kernels.matmul import matmul, matmul_plain

    legal, ranked = tuned["legal"], tuned["ranked"]
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((N, N)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal((N, N)).astype(
        np.float32)).to(dev)
    plain = {bk: matmul_plain(x, y, bm=N, bn=N, bk=bk)
             for bk in sorted({c[2] for c in legal})}
    meas, errs = {}, {}
    for cfg in legal:
        bm, bn, bk = cfg
        out = matmul(x, y, bm=bm, bn=bn, bk=bk)
        torch.cuda.synchronize()           # a fault surfaces here
        errs[cfg] = float((out - plain[bk]).abs().max())
        scale = float(plain[bk].abs().max())
        if not errs[cfg] <= BIG_TOL * scale:
            raise AssertionError(
                f"matmul at tiles {cfg} disagrees with its plain version "
                f"at 4096^3: max_abs_err {errs[cfg]} above {BIG_TOL} x "
                f"{scale}")
        del out
        meas[cfg] = event_ms(lambda: matmul(x, y, bm=bm, bn=bn, bk=bk), 3)
    worst = max(errs, key=errs.get)
    log(f"  all {len(legal)} tiles at 4096^3 agree with the plain version: "
        f"worst max_abs_err {errs[worst]:.3e} at {worst} (bound {BIG_TOL} "
        f"x max |plain|, max |plain| "
        f"{max(float(p.abs().max()) for p in plain.values()):.1f})")
    order = sorted(legal, key=lambda c: (meas[c], c))
    pos = {c: i for i, c in enumerate(order)}
    pred_order = [r.config for r in ranked]
    chosen, analytic = tuned["choice"], tuned["analytic"]
    log(f"  selected tile {chosen} (predicted compute "
        f"{tuned['t_compute'] * 1e3:.2f} ms); measured {meas[chosen]:.2f} "
        f"ms, rank {pos[chosen] + 1} of {len(legal)}; measured best "
        f"{order[0]} {meas[order[0]]:.2f} ms; analytic oracle picks "
        f"{analytic} ({meas[analytic]:.2f} ms measured)")
    log("  predicted top 5: " + ", ".join(
        f"{c} {r.t_compute * 1e3:.2f}/{meas[c]:.2f} ms"
        for c, r in zip(pred_order[:5], ranked[:5])) +
        "  (predicted compute / measured)")
    n_pairs = agree = 0
    for i in range(len(legal)):
        for j in range(i + 1, len(legal)):
            a, b = pred_order[i], pred_order[j]
            n_pairs += 1
            agree += meas[a] <= meas[b]
    log(f"  predicted vs measured order: {agree}/{n_pairs} pairs agree "
        f"(Kendall tau {2 * agree / n_pairs - 1:.3f})")
    (OUT / "tiles_4096.json").write_text(json.dumps(
        [{"tile": list(r.config), "pred_compute_ms": r.t_compute * 1e3,
          "pred_total_ms": r.t_total * 1e3, "meas_ms": meas[r.config],
          "max_abs_err": errs[r.config]}
         for r in ranked], indent=1))
    return {"choice": chosen, "x": x, "y": y, "meas_ms": meas[chosen],
            "err": errs[chosen], "plain": plain[chosen[2]],
            "worst_err": errs[worst], "analytic": analytic,
            "best": order[0], "best_ms": meas[order[0]],
            "tau": 2 * agree / n_pairs - 1, "n_legal": len(legal)}


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
    from repro_torch.kernels.matmul import matmul, matmul_plain
    from repro_torch.perf.roofline import card_of

    OUT.mkdir(parents=True, exist_ok=True)
    dev = resolve_device("cuda")
    line = card_line()
    log(f"[1] card: {line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build("matmul")
    log(f"    kernel build {time.perf_counter() - t0:.1f} s -> "
        f"{lib.relative_to(ROOT)}")
    (OUT / "ptxas.log").write_text(lib.with_suffix(".log").read_text())

    log("[2] kernel check (CUDA matmul vs its plain version)")
    check_kernel_shapes()

    # the main path: each of its two paths runs with the count set to 0
    # just before it and read just after
    matmul.launches = 0
    log(f"[3] paper path: potrf at n={N}, b in {BLOCK_SIZES}")
    paper = paper_path(dev)
    by_path = {"paper": matmul.launches}
    matmul.launches = 0
    log("[4] tile path: CUDA matmul tiles for 4096^3")
    tuned = tune_tiles(dev)
    by_path["tiles"] = matmul.launches
    launches = sum(by_path.values())
    log(f"  matmul launches on the main path: {by_path}")
    if launches <= 0:
        raise AssertionError("the main path never launched the matmul")
    paper["copy_share"] = transfer_shares(paper.pop("models"),
                                          *tuned["transfer"])
    tiles = check_tiles(dev, tuned)

    bm, bn, bk = tiles["choice"]
    x, y = tiles.pop("x"), tiles.pop("y")
    err = tiles["err"]
    log(f"  4096^3 float32 at the selected {tiles['choice']}: max_abs_err "
        f"{err:.3e}, max |plain| {float(tiles.pop('plain').abs().max()):.1f}"
        f" (bound {BIG_TOL} x max |plain|)")

    kernel_ms = event_ms(lambda: matmul(x, y, bm=bm, bn=bn, bk=bk),
                         TIME_REPS)
    plain_ms = event_ms(lambda: matmul_plain(x, y, bm=bm, bn=bn, bk=bk),
                        TIME_REPS)
    library_ms = event_ms(lambda: torch.matmul(x, y), TIME_REPS)
    the_card = card_of(dev)
    flops = 2.0 * N ** 3
    nbytes = 4.0 * 3 * N * N
    t_ops = flops / the_card.fp32_flops * 1e3
    t_bytes = nbytes / the_card.hbm_bytes_per_s * 1e3
    kernels = {"kernels": [{
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:27 (_matmul_kernel)",
        "launches": launches, "launches_by_path": by_path,
        "max_abs_err": err, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms, "shape": [N, N, N], "dtype": "float32",
        "tile": [bm, bn, bk]}]}
    (OUT / "result.json").write_text(json.dumps(
        {"paper": paper, "tiles": tiles, **kernels}, indent=1, default=str))
    log(f"[5] matmul 4096^3 f32: kernel {kernel_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, torch.matmul {library_ms:.3f} ms, bound "
        f"{max(t_ops, t_bytes):.3f} ms; {launches} launches on the main "
        f"path {by_path}")
    print(json.dumps(kernels))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
