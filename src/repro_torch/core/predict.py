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
import torch

from .._device import DeviceLike, resolve_device
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
class FusedBatch:
    """Padded size tensors + scatter indices for one-program prediction.

    The per-(kernel, case) groups of a :class:`CompiledCalls` batch, padded
    to one rectangular ``(group, rows, dims)`` tensor so the whole batch
    evaluates as a single torch program with no host round trips:

    * ``sizes`` — ``(G, R, d_max)`` float64 size points.  Rows beyond a
      group's true call count are all-zero (the engine's degenerate-call
      mask turns them into exact-zero estimates), and dimensions beyond a
      group's true size rank are a benign ``1.0`` (every monomial carries
      exponent 0 there, so they contribute an exact factor of one);
    * ``segments`` — ``(G * R,)`` int32 config index per padded row, in
      row-major ``(group, row)`` order.  Padding rows map to the extra
      segment ``n_configs``, which the segment sum drops — so padding can
      never leak into a real config's total;
    * ``flat_config`` — ``(n_calls,)`` intp config index per *real* call,
      concatenated in group order: the precomputed scatter indices the
      numpy backend accumulates all groups with in one ``np.add.at``;
    * ``dims`` / ``rows`` — each group's true size rank and call count
      (what the padding padded *from*).
    """

    sizes: np.ndarray
    segments: np.ndarray
    flat_config: np.ndarray
    dims: Tuple[int, ...]
    rows: Tuple[int, ...]


def _fuse_batch(groups: Tuple[CallGroup, ...], n_configs: int,
                pad_rows_to: Optional[int] = None) -> FusedBatch:
    """Pad per-group size matrices into one rectangular batch tensor."""
    if not groups:
        return FusedBatch(sizes=np.zeros((0, 0, 0), dtype=np.float64),
                          segments=np.zeros(0, dtype=np.int32),
                          flat_config=np.zeros(0, dtype=np.intp),
                          dims=(), rows=())
    rows = tuple(g.sizes.shape[0] for g in groups)
    dims = tuple(g.sizes.shape[1] for g in groups)
    n_rows = max(max(rows), pad_rows_to or 0)
    d_max = max(dims)
    sizes = np.zeros((len(groups), n_rows, d_max), dtype=np.float64)
    segments = np.full((len(groups), n_rows), n_configs, dtype=np.int32)
    for gi, g in enumerate(groups):
        k, d = g.sizes.shape
        sizes[gi, :k, :d] = g.sizes
        sizes[gi, :k, d:] = 1.0
        segments[gi, :k] = g.config
    return FusedBatch(sizes=sizes, segments=segments.reshape(-1),
                      flat_config=np.concatenate([g.config for g in groups]),
                      dims=dims, rows=rows)


@dataclass(frozen=True)
class CompiledCalls:
    """A batch of call sequences compiled to per-(kernel, case) matrices.

    This is the "compiled" form of §4.1's deterministic call sequences: the
    per-call Python structure is gone, and prediction reduces to one
    polynomial evaluation plus a scatter-add back onto configs.  Besides
    the per-group matrices (kept for the per-group reference path and
    introspection), the batch carries a :class:`FusedBatch` — the padded
    ``(group, rows, dims)`` size tensor and the segment/config scatter
    indices — emitted once by :func:`compile_calls` so no predict call
    ever re-derives them.
    """

    n_configs: int
    groups: Tuple[CallGroup, ...]
    fused: Optional[FusedBatch] = None

    @property
    def n_calls(self) -> int:
        return sum(g.sizes.shape[0] for g in self.groups)

    def fused_batch(self) -> FusedBatch:
        """The padded tensors + scatter indices (:class:`FusedBatch`).

        :func:`compile_calls` emits them eagerly; hand-built instances
        (``fused=None``) derive and memoize them on first use."""
        if self.fused is None:
            object.__setattr__(self, "fused",
                               _fuse_batch(self.groups, self.n_configs))
        return self.fused


def compile_calls(calls_per_config: Sequence[Iterable[KernelCall]], *,
                  pad_rows_to: Optional[int] = None) -> CompiledCalls:
    """Group a batch of call sequences into per-(kernel, case) size matrices.

    The returned :class:`CompiledCalls` also carries the padded
    :class:`FusedBatch` tensors the fused prediction path consumes.
    ``pad_rows_to`` forces the row axis to at least that width — results
    are bit-identical under any padding (padding rows scatter into a
    dropped segment).
    """
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
    return CompiledCalls(n_configs=len(seqs), groups=groups,
                         fused=_fuse_batch(groups, len(seqs), pad_rows_to))


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
#: models on
BACKENDS = ("numpy", "torch")


# ------------------------------------------------------- fused evaluation --

def _zero_case_tensors(d: int):
    """An always-inside single piece evaluating to exactly zero — the
    stand-in for a (kernel, case) whose every call is degenerate and which
    therefore needs no model (Example 4.1 semantics)."""
    return (np.zeros((1, d)), np.full((1, d), np.inf),
            np.zeros((1, 1, d)), np.ones((1, 1, d)),
            np.zeros((1, 1, len(STATS))))


def _pad_model_tensors(per_case, fused: FusedBatch):
    """Pad per-case piece tensors to one (G, P, M, ·) batch.

    Padding *pieces* get ``lo=+inf, hi=-inf``: never inside, and at
    infinite clamp distance, so the piece lookup can never select them.
    Padding *monomials* are exact no-op rows (exponent 0, scale 1,
    coefficient 0), and padding *dims* of real pieces are always-inside
    (``lo=0, hi=+inf``) with exponent 0 — every pad contributes exactly
    nothing.
    """
    d_max = fused.sizes.shape[2]
    tensors = [t if t is not None else _zero_case_tensors(d)
               for t, d in zip(per_case, fused.dims)]
    p_max = max(t[0].shape[0] for t in tensors)
    m_max = max(t[2].shape[1] for t in tensors)
    g = len(tensors)
    lo = np.full((g, p_max, d_max), np.inf)
    hi = np.full((g, p_max, d_max), -np.inf)
    exps = np.zeros((g, p_max, m_max, d_max))
    scl = np.ones((g, p_max, m_max, d_max))
    cof = np.zeros((g, p_max, m_max, len(STATS)))
    for gi, ((tlo, thi, te, ts, tc), d) in enumerate(zip(tensors,
                                                         fused.dims)):
        p, m = te.shape[0], te.shape[1]
        lo[gi, :p, :d] = tlo
        lo[gi, :p, d:] = 0.0
        hi[gi, :p, :d] = thi
        hi[gi, :p, d:] = np.inf
        exps[gi, :p, :m, :d] = te
        scl[gi, :p, :m, :d] = ts
        cof[gi, :p, :m, :] = tc
    return lo, hi, exps, scl, cof


def _segment_members(segments: np.ndarray, n_configs: int) -> np.ndarray:
    """``(n_configs, K)`` flat row indices of each config's calls, in
    row-major ``(group, row)`` order, padded with the index one past the
    last row (an appended zero row).

    The deterministic form of the config-wise segment sum: a gather and a
    sum along one axis.  ``index_add_`` on a CUDA float64 tensor sums with
    atomics, whose order — and so the last bits of every total — varies
    from run to run; a gather-sum gives the same bits on every run.
    """
    n_rows = segments.shape[0]
    order = np.argsort(segments, kind="stable")
    seg_sorted = segments[order]
    keep = seg_sorted < n_configs
    rows, cfg = order[keep], seg_sorted[keep].astype(np.intp)
    counts = np.bincount(cfg, minlength=n_configs)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.intp)
    members = np.full((n_configs, max(int(counts.max(initial=0)), 1)),
                      n_rows, dtype=np.int64)
    members[cfg, np.arange(rows.size) - starts[cfg]] = rows
    return members


def _fused_predict_torch(pts, lo, hi, exps, scl, cof, members, *,
                         std_col: int):
    """The whole compiled batch as ONE float64 torch program.

    ``pts (G, R, d)`` padded size points; ``lo/hi (G, P, d)`` piece
    domains; ``exps/scl (G, P, M, d)`` and ``cof (G, P, M, S)`` padded
    piece polynomials; ``members (C, K)`` each config's rows (see
    :func:`_segment_members`).  Degenerate masking, the piece lookup, the
    monomial design matrices, the ``nm,nms->ns`` contraction and the
    config segment sum (std in quadrature) in one program on the tensors'
    device; mirrors the per-group numpy path: first containing piece
    wins, out-of-domain rows clamp to the smallest squared distance (first
    on ties), estimates clip at 0, degenerate rows are exact zeros.
    """
    live = (pts > 0).all(dim=-1)                                # (G, R)
    safe = torch.where(live[..., None], pts, torch.ones_like(pts))
    x = safe[:, :, None, :]                                     # (G,R,1,d)
    inside = ((x >= lo[:, None]) & (x <= hi[:, None])).all(dim=-1)
    below = (lo[:, None] - x).clamp_min(0.0)
    above = (x - hi[:, None]).clamp_min(0.0)
    dist = (below ** 2).sum(dim=-1) + (above ** 2).sum(dim=-1)  # (G,R,P)
    # argmax/argmin return the first extremum, as numpy's do
    pidx = torch.where(inside.any(dim=-1),
                       inside.to(torch.int8).argmax(dim=-1),
                       dist.argmin(dim=-1))                     # (G, R)
    g = torch.arange(pts.shape[0], device=pts.device)[:, None]
    e, s, c = exps[g, pidx], scl[g, pidx], cof[g, pidx]         # (G,R,M,*)
    xm = ((x / s) ** e).prod(dim=-1)                            # (G, R, M)
    # multiply and sum, not a matmul: no fused multiply-adds, so each
    # term rounds as in the numpy path's products
    out = (xm[..., None] * c).sum(dim=-2).clamp_min(0.0)        # (G, R, S)
    out = torch.where(live[..., None], out, torch.zeros_like(out))
    w = out.reshape(-1, out.shape[-1])
    w = torch.cat([w[:, :std_col], w[:, std_col:std_col + 1] ** 2,
                   w[:, std_col + 1:]], dim=1)
    w = torch.cat([w, w.new_zeros(1, w.shape[1])])              # pad row
    tot = w[members].sum(dim=1)                                 # (C, S)
    return torch.cat([tot[:, :std_col], tot[:, std_col:std_col + 1].sqrt(),
                      tot[:, std_col + 1:]], dim=1)


class PredictionEngine:
    """Vectorized batched prediction over configuration sweeps (§4.5/§4.6).

    Where :func:`predict_runtime` walks one call sequence through per-call
    dict lookups and per-stat polynomial evaluations, this engine compiles a
    whole batch of call sequences (one per candidate configuration) into
    per-(kernel, case) size matrices and predicts every configuration with a
    handful of stacked matrix products.  Statistics propagate exactly as in
    Eq. 4.2/4.3: min/med/max/mean sum per config, std adds in quadrature.
    The scalar path remains the reference oracle; both agree to ~1e-10.

    ``backend`` selects how the stacked polynomials are evaluated:
    ``"numpy"`` (per-group evaluation, all groups accumulated with one
    precomputed scatter) or ``"torch"`` — piece lookup, design matrices,
    every group's products AND the config-wise segment sum in ONE float64
    torch program over the batch's padded ``(group, rows, ...)`` tensors
    on ``device`` (the CUDA card unless ``device="cpu"``; no card and no
    CPU request raises).  The padded inputs are uploaded once per compiled
    batch and kept on the device, so a repeated sweep re-uploads nothing.
    ``device`` applies to the torch backend only.  The per-group path
    survives as :meth:`predict_compiled_grouped`, the equivalence oracle.

    Every engine owns a :class:`TraceCache` (pass ``cache=`` to share one
    across engines): ``sweep``/``grid`` compile their whole candidate set
    once into a reusable :class:`CompiledCalls` artifact — also available
    directly via :meth:`compile_sweep`/:meth:`compile_grid` — so repeated
    sweeps skip both the Python tracing loop and the re-grouping, and
    ``predict_compiled`` consumes the artifact directly.
    """

    def __init__(self, models: ModelSet, *, backend: str = "numpy",
                 cache: Optional[TraceCache] = None,
                 device: DeviceLike = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"choose from {BACKENDS}")
        if backend != "torch" and device is not None:
            raise ValueError(f"device= applies to the torch backend, not "
                             f"backend={backend!r}")
        self.models = models
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" else None
        self.cache = cache if cache is not None else TraceCache()

    def predict_compiled(self, compiled: CompiledCalls) -> np.ndarray:
        """(n_configs, len(STATS)) runtime statistics for a compiled batch.

        On ``backend="torch"`` the whole batch — every group's piece
        lookup, design matrices and products plus the config segment sum
        — runs as one torch program over the batch's :class:`FusedBatch`
        tensors on the engine's device; on ``"numpy"`` groups are
        evaluated batch-wise and accumulated with a single ``np.add.at``
        over the precomputed ``flat_config`` scatter indices.  Either way
        there is no per-group Python accumulation loop.
        """
        if not compiled.groups:
            return np.zeros((compiled.n_configs, len(STATS)),
                            dtype=np.float64)
        fused = compiled.fused_batch()
        if self.backend == "torch":
            out = _fused_predict_torch(*self._fused_device_inputs(compiled),
                                       std_col=_STD)
            return out.cpu().numpy()
        est = np.concatenate(
            [np.asarray(self.models[g.kernel].estimate_batch(g.case,
                                                             g.sizes))
             for g in compiled.groups], axis=0)
        est[:, _STD] **= 2
        acc = np.zeros((compiled.n_configs, len(STATS)), dtype=np.float64)
        np.add.at(acc, fused.flat_config, est)
        acc[:, _STD] = np.sqrt(acc[:, _STD])
        return acc

    def predict_compiled_grouped(self, compiled: CompiledCalls) -> np.ndarray:
        """The per-group reference path, kept as :meth:`predict_compiled`'s
        equivalence oracle.

        One numpy ``estimate_batch`` evaluation per (kernel, case) group,
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

    def _fused_model_tensors(self, compiled: CompiledCalls):
        """Padded (G, P, M, ·) model tensors for a compiled batch.

        Built from each case's :meth:`~repro_torch.core.model.CaseModel.
        padded_tensors` and memoized ON the batch (a single entry,
        replaced whenever the model set or any per-case tensor identity
        changes — so a mutated model never serves stale tensors).  A case
        that is missing but whose every call is degenerate gets an
        exact-zero stand-in — the same no-model-needed semantics as the
        scalar path; a live call to a missing case raises ``KeyError``.
        """
        per_case = []
        for g in compiled.groups:
            model = self.models[g.kernel]
            cm = model.cases.get(tuple(g.case))
            if cm is not None and cm.pieces:
                per_case.append(cm.padded_tensors())
                continue
            if np.any(np.all(g.sizes > 0, axis=1)):
                if cm is not None:
                    raise KeyError("empty case model")
                raise KeyError(f"{g.kernel}: no model for case {g.case!r} "
                               f"(have {list(model.cases)})")
            per_case.append(None)
        hit = compiled.__dict__.get("_fused_model_cache")
        if hit is not None and hit[0] is self.models \
                and len(hit[1]) == len(per_case) \
                and all(a is b for a, b in zip(hit[1], per_case)):
            return hit[2]
        tensors = _pad_model_tensors(per_case, compiled.fused_batch())
        object.__setattr__(compiled, "_fused_model_cache",
                           (self.models, tuple(per_case), tensors))
        return tensors

    def _fused_device_inputs(self, compiled: CompiledCalls):
        """Device-resident float64 inputs of the fused torch program.

        The padded size/model tensors are immutable once built, so their
        device copies are memoized on the batch (a single entry keyed by
        the model tensors' identity, which :meth:`_fused_model_tensors`
        revalidates against mutation, and by the device) — a repeated
        sweep is one program with zero host-to-device transfers.
        """
        tensors = self._fused_model_tensors(compiled)
        hit = compiled.__dict__.get("_fused_device_cache")
        if hit is not None and hit[0] is tensors and hit[1] == self.device:
            return hit[2]
        fused = compiled.fused_batch()
        members = _segment_members(fused.segments, compiled.n_configs)
        inputs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                           self.device)
                       for a in (fused.sizes, *tensors, members))
        object.__setattr__(compiled, "_fused_device_cache",
                           (tensors, self.device, inputs))
        return inputs

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
