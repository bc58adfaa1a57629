"""Model-based prediction of blocked algorithms (paper §4.1, Eq. 4.1–4.6).

A blocked algorithm's execution is a deterministic sequence of kernel calls;
its predicted runtime is the sum of the per-call model estimates.  Summary
statistics propagate: min/med/max/mean add, standard deviations add in
quadrature (uncorrelated-estimate assumption, Eq. 4.3).  Performance and
efficiency predictions follow Eq. 4.4–4.6 including the second/first-order
Taylor corrections for the mean/std of the reciprocal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .model import ModelSet
from .sampler import STATS, Stats

_STD = STATS.index("std")


@dataclass(frozen=True)
class KernelCall:
    """One kernel invocation inside an algorithm's call sequence."""

    kernel: str          # e.g. "gemm"
    case: Tuple          # flag/layout case, e.g. ("N", "T")
    sizes: Tuple[int, ...]

    def __repr__(self) -> str:  # compact trace printing
        c = ",".join(map(str, self.case))
        s = "x".join(map(str, self.sizes))
        return f"{self.kernel}[{c}]({s})"


def predict_runtime(calls: Iterable[KernelCall], models: ModelSet) -> Stats:
    """t_pred^s = sum over calls of t_est^s  (Eq. 4.2/4.3)."""
    acc = {s: 0.0 for s in STATS}
    var = 0.0
    for call in calls:
        est = models.estimate(call.kernel, call.case, call.sizes)
        for s in ("min", "med", "max", "mean"):
            acc[s] += est[s]
        var += est["std"] ** 2
    acc["std"] = var ** 0.5
    return Stats(**{"min": acc["min"], "med": acc["med"], "max": acc["max"],
                    "mean": acc["mean"], "std": acc["std"]})


# ----------------------------------------------------------------- batched --

@dataclass(frozen=True)
class CallGroup:
    """All calls to one (kernel, case) across a batch of call sequences."""

    kernel: str
    case: Tuple
    sizes: np.ndarray    # (K, d) float64 size arguments, one row per call
    config: np.ndarray   # (K,) intp — index of the originating call sequence


@dataclass(frozen=True)
class CompiledCalls:
    """A batch of call sequences compiled to per-(kernel, case) matrices.

    This is the "compiled" form of §4.1's deterministic call sequences: the
    per-call Python structure is gone, and prediction reduces to one
    polynomial evaluation per group plus a scatter-add back onto configs.
    ``flat_config`` holds the config index of every call, concatenated in
    group order: the precomputed scatter indices the engine accumulates
    all groups with in one ``np.add.at``.
    """

    n_configs: int
    groups: Tuple[CallGroup, ...]
    flat_config: np.ndarray

    @property
    def n_calls(self) -> int:
        return sum(g.sizes.shape[0] for g in self.groups)


def compile_calls(calls_per_config: Sequence[Iterable[KernelCall]],
                  ) -> CompiledCalls:
    """Group a batch of call sequences into per-(kernel, case) size
    matrices (one :class:`CallGroup` per distinct kernel and case)."""
    seqs = list(calls_per_config)
    buckets: Dict[Tuple[str, Tuple], Tuple[list, list]] = {}
    for i, calls in enumerate(seqs):
        for call in calls:
            szs, cfg = buckets.setdefault((call.kernel, call.case), ([], []))
            szs.append(call.sizes)
            cfg.append(i)
    groups = tuple(
        CallGroup(kernel=kernel, case=case,
                  sizes=np.asarray(szs, dtype=np.float64),
                  config=np.asarray(cfg, dtype=np.intp))
        for (kernel, case), (szs, cfg) in buckets.items()
    )
    flat = (np.concatenate([g.config for g in groups]) if groups
            else np.zeros(0, dtype=np.intp))
    return CompiledCalls(n_configs=len(seqs), groups=groups,
                         flat_config=flat)


Tracer = Callable[[int, int], List[KernelCall]]


class TraceCache:
    """Memoizes tracer call sequences and compiled batches across sweeps.

    Tracing a blocked algorithm is a pure function of ``(n, b)`` — the call
    sequence is fully determined by the problem and block size (§4.1) — yet
    it is the one remaining Python loop on the prediction hot path.  The
    cache is keyed on ``(tracer identity, n, b)`` (the tracer object itself,
    which also keeps it alive, so ids are never recycled into stale hits)
    and additionally memoizes whole compiled sweep/grid batches, so repeated
    sweeps over the same candidate set reuse one :class:`CompiledCalls`
    instead of re-tracing and re-grouping every point.

    Entries are never evicted: hold ON to the tracer objects you sweep with
    (rebuilding a tracer closure per request defeats the cache and grows it
    unboundedly in a long-lived shared engine); call :meth:`clear` to reset.
    """

    def __init__(self):
        self._calls: Dict[Tuple, Tuple[KernelCall, ...]] = {}
        self._compiled: Dict[Tuple, CompiledCalls] = {}
        self.hits = 0
        self.misses = 0

    def calls(self, tracer: Tracer, n: int, b: int) -> Tuple[KernelCall, ...]:
        """The (cached) call sequence of one traced configuration."""
        key = (tracer, n, b)
        out = self._calls.get(key)
        if out is None:
            self.misses += 1
            out = tuple(tracer(n, b))
            self._calls[key] = out
        else:
            self.hits += 1
        return out

    def compiled_sweep(self, tracer: Tracer, n: int,
                       candidates: Sequence[int]) -> CompiledCalls:
        """One reusable compiled batch for a whole block-size sweep."""
        key = ("sweep", tracer, n, tuple(candidates))
        out = self._compiled.get(key)
        if out is None:
            out = compile_calls([self.calls(tracer, n, b)
                                 for b in candidates])
            self._compiled[key] = out
        else:
            self.hits += 1   # whole-batch reuse: calls() is never consulted
        return out

    def compiled_grid(self, tracer: Tracer, ns: Sequence[int],
                      bs: Sequence[int]) -> CompiledCalls:
        """One reusable compiled batch for a full (n, b) grid."""
        key = ("grid", tracer, tuple(ns), tuple(bs))
        out = self._compiled.get(key)
        if out is None:
            out = compile_calls([self.calls(tracer, n, b)
                                 for n in ns for b in bs])
            self._compiled[key] = out
        else:
            self.hits += 1   # whole-batch reuse: calls() is never consulted
        return out

    def clear(self) -> None:
        self._calls.clear()
        self._compiled.clear()
        self.hits = self.misses = 0


#: evaluation backends a PredictionEngine can run its stacked polynomial
#: models on (the float64 torch program is a later part of the port)
BACKENDS = ("numpy",)


class PredictionEngine:
    """Vectorized batched prediction over configuration sweeps (§4.5/§4.6).

    Where :func:`predict_runtime` walks one call sequence through per-call
    dict lookups and per-stat polynomial evaluations, this engine compiles a
    whole batch of call sequences (one per candidate configuration) into
    per-(kernel, case) size matrices and predicts every configuration with a
    handful of stacked matrix products.  Statistics propagate exactly as in
    Eq. 4.2/4.3: min/med/max/mean sum per config, std adds in quadrature.
    The scalar path remains the reference oracle; both agree to ~1e-10.

    ``backend`` selects how the stacked polynomials are evaluated; the
    port has the ``"numpy"`` path (per-group evaluation, all groups
    accumulated with one precomputed scatter).  The per-group path
    survives as :meth:`predict_compiled_grouped`, the equivalence oracle.

    Every engine owns a :class:`TraceCache` (pass ``cache=`` to share one
    across engines): ``sweep``/``grid`` compile their whole candidate set
    once into a reusable :class:`CompiledCalls` artifact — also available
    directly via :meth:`compile_sweep`/:meth:`compile_grid` — so repeated
    sweeps skip both the Python tracing loop and the re-grouping, and
    ``predict_compiled`` consumes the artifact directly.
    """

    def __init__(self, models: ModelSet, *, backend: str = "numpy",
                 cache: Optional[TraceCache] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"choose from {BACKENDS}")
        self.models = models
        self.backend = backend
        self.cache = cache if cache is not None else TraceCache()

    def predict_compiled(self, compiled: CompiledCalls) -> np.ndarray:
        """(n_configs, len(STATS)) runtime statistics for a compiled batch.

        Groups are evaluated batch-wise and accumulated with a single
        ``np.add.at`` over the precomputed ``flat_config`` scatter
        indices: there is no per-group Python accumulation loop.
        """
        if not compiled.groups:
            return np.zeros((compiled.n_configs, len(STATS)),
                            dtype=np.float64)
        est = np.concatenate(
            [np.asarray(self.models[g.kernel].estimate_batch(g.case,
                                                             g.sizes))
             for g in compiled.groups], axis=0)
        est[:, _STD] **= 2
        acc = np.zeros((compiled.n_configs, len(STATS)), dtype=np.float64)
        np.add.at(acc, compiled.flat_config, est)
        acc[:, _STD] = np.sqrt(acc[:, _STD])
        return acc

    def predict_compiled_grouped(self, compiled: CompiledCalls) -> np.ndarray:
        """The per-group reference path, kept as :meth:`predict_compiled`'s
        equivalence oracle.

        One ``estimate_batch`` evaluation per (kernel, case) group,
        accumulated host-side with per-stat ``np.bincount``; agrees with
        :meth:`predict_compiled` to rounding (the two paths associate the
        per-config additions differently).
        """
        acc = np.zeros((compiled.n_configs, len(STATS)), dtype=np.float64)
        for g in compiled.groups:
            est = np.asarray(self.models[g.kernel].estimate_batch(
                g.case, g.sizes))
            for j in range(len(STATS)):
                w = est[:, j] ** 2 if j == _STD else est[:, j]
                acc[:, j] += np.bincount(g.config, weights=w,
                                         minlength=compiled.n_configs)
        acc[:, _STD] = np.sqrt(acc[:, _STD])
        return acc

    def predict_batch(self,
                      calls_per_config: Sequence[Iterable[KernelCall]],
                      ) -> np.ndarray:
        """Predict runtime stats for many call sequences at once: (N, 5)."""
        return self.predict_compiled(compile_calls(calls_per_config))

    def predict_stats(self,
                      calls_per_config: Sequence[Iterable[KernelCall]],
                      ) -> List[Stats]:
        return [Stats(*map(float, row))
                for row in self.predict_batch(calls_per_config)]

    # ------------------------------------------------- cached sweep/grid --
    def compile_sweep(self, tracer: Tracer, n: int,
                      candidates: Sequence[int]) -> CompiledCalls:
        """Trace + compile a block-size sweep once; cached across calls."""
        return self.cache.compiled_sweep(tracer, n, candidates)

    def compile_grid(self, tracer: Tracer, ns: Sequence[int],
                     bs: Sequence[int]) -> CompiledCalls:
        """Trace + compile a full (n, b) grid once; cached across calls."""
        return self.cache.compiled_grid(tracer, ns, bs)

    def sweep(self, tracer: Tracer, n: int,
              candidates: Sequence[int]) -> np.ndarray:
        """Predict one algorithm over a block-size grid: (len(candidates), 5)."""
        return self.predict_compiled(self.compile_sweep(tracer, n,
                                                        candidates))

    def grid(self, tracer: Tracer,
             ns: Sequence[int], bs: Sequence[int]) -> np.ndarray:
        """Predict a full (n, b) grid in one shot: (len(ns), len(bs), 5)."""
        flat = self.predict_compiled(self.compile_grid(tracer, ns, bs))
        return flat.reshape(len(ns), len(bs), len(STATS))


def resolve_engine(models: ModelSet, backend: Optional[str],
                   engine: Optional[PredictionEngine]) -> PredictionEngine:
    """Resolve the ``backend=``/``engine=`` pair a selection entry point got.

    An explicit ``backend`` (or the ``models`` argument itself) must not be
    silently overridden by a supplied engine — conflicting requests raise
    instead of handing back results from the wrong evaluation path or the
    wrong model set.
    """
    if engine is not None:
        if backend is not None and backend != engine.backend:
            raise ValueError(
                f"backend={backend!r} conflicts with the supplied engine's "
                f"backend={engine.backend!r}; pass one or the other")
        if engine.models is not models:
            raise ValueError(
                "the supplied engine was built on a different ModelSet than "
                "the models argument; predictions would silently come from "
                "the engine's set")
        return engine
    return PredictionEngine(models, backend=backend or "numpy")


def predict_performance(runtime: Stats, cost_flops: float) -> Dict[str, float]:
    """FLOP-rate prediction from a runtime prediction (Eq. 4.4/4.5)."""
    mu, sigma = runtime.mean, runtime.std
    out = {
        "min": cost_flops / runtime.max if runtime.max > 0 else float("inf"),
        "med": cost_flops / runtime.med if runtime.med > 0 else float("inf"),
        "max": cost_flops / runtime.min if runtime.min > 0 else float("inf"),
    }
    if mu > 0:
        out["mean"] = cost_flops / mu * (1.0 + sigma ** 2 / mu ** 2)
        out["std"] = cost_flops * sigma / mu ** 2
    else:
        out["mean"], out["std"] = float("inf"), 0.0
    return out


def predict_efficiency(performance: Dict[str, float],
                       peak_flops: float) -> Dict[str, float]:
    """Eq. 4.6: efficiency = performance / peak."""
    return {s: v / peak_flops for s, v in performance.items()}


# ------------------------------------------------------------------ errors --

def relative_error(pred: float, meas: float) -> float:
    """x_RE = (pred - meas) / meas  (§4.2).

    A zero measurement has no defined relative error; return ``nan`` so
    error sweeps over empty/degenerate measurements don't crash.
    """
    if meas == 0:
        return float("nan")
    return (pred - meas) / meas


def absolute_relative_error(pred: float, meas: float) -> float:
    """``|pred - meas| / meas`` — the magnitude of :func:`relative_error`
    (nan when the measurement is zero)."""
    return abs(relative_error(pred, meas))
