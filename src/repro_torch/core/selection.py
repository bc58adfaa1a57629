"""Algorithm selection and block-size optimization (paper §4.5 / §4.6).

Given a set of mathematically-equivalent blocked-algorithm variants — each
represented by a *tracer* producing its kernel-call sequence for a problem
size n and block size b — rank them by predicted runtime, entirely without
executing any of them.  Block-size optimization evaluates the prediction over
a candidate grid of b and returns the argmin plus the whole profile (used to
compute the paper's "performance yield" against empirical optima).

Both entry points run on the vectorized :class:`PredictionEngine` by default
(the batch of candidate configurations is predicted with a handful of array
ops); pass ``batched=False`` to fall back to the scalar per-call reference
path, which is kept as the equivalence oracle.  Passing a shared
``engine=`` lets repeated selections reuse its trace cache (traced call
sequences and compiled sweep batches) instead of re-tracing.

:func:`select_contraction_algorithm`, :func:`rank_einsum_paths` and
:func:`select_einsum_path` extend the same selection interface to tensor
contractions (paper Ch. 6) via :mod:`repro_torch.tc` — micro-benchmark
based candidate models ranked through the identical batched engine, on a
:class:`repro_torch.tc.PredictorSession`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .model import ModelSet
from .predict import (PredictionEngine, Tracer, predict_runtime,
                      resolve_engine)
from .sampler import STATS, Stats


@dataclass(frozen=True)
class RankedAlgorithm:
    """One ranked blocked-algorithm variant: its name, predicted runtime
    statistics, and the block size the prediction was made at."""

    name: str
    runtime: Stats
    block_size: int


def _check_scalar_path(batched, backend, engine):
    if not batched and (backend is not None or engine is not None):
        raise ValueError("backend=/engine= apply to the batched engine; "
                         "the scalar oracle (batched=False) has neither")


def rank_algorithms(tracers: Mapping[str, Tracer], models: ModelSet,
                    n: int, b: int, *,
                    stat: str = "med", batched: bool = True,
                    backend: Optional[str] = None,
                    engine: Optional[PredictionEngine] = None,
                    ) -> List[RankedAlgorithm]:
    """Predict every variant's runtime and sort ascending (§4.5)."""
    _check_scalar_path(batched, backend, engine)
    names = list(tracers)
    if batched:
        eng = resolve_engine(models, backend, engine)
        runtimes = eng.predict_stats([eng.cache.calls(tracers[name], n, b)
                                      for name in names])
    else:
        runtimes = [predict_runtime(tracers[name](n, b), models)
                    for name in names]
    ranked = [RankedAlgorithm(name=name, runtime=rt, block_size=b)
              for name, rt in zip(names, runtimes)]
    ranked.sort(key=lambda r: getattr(r.runtime, stat))
    return ranked


def select_algorithm(tracers: Mapping[str, Tracer], models: ModelSet,
                     n: int, b: int, *, stat: str = "med",
                     batched: bool = True, backend: Optional[str] = None,
                     engine: Optional[PredictionEngine] = None) -> str:
    """The name of the variant with the fastest predicted runtime —
    ``rank_algorithms(...)[0].name``, same keywords."""
    return rank_algorithms(tracers, models, n, b, stat=stat, batched=batched,
                           backend=backend, engine=engine)[0].name


def optimize_block_size(tracer: Tracer, models: ModelSet, n: int,
                        candidates: Sequence[int], *,
                        stat: str = "med", batched: bool = True,
                        backend: Optional[str] = None,
                        engine: Optional[PredictionEngine] = None,
                        ) -> Tuple[int, Dict[int, float]]:
    """b_pred = argmin_b t_pred(n, b) over the candidate grid (§4.6)."""
    _check_scalar_path(batched, backend, engine)
    if batched:
        eng = resolve_engine(models, backend, engine)
        col = STATS.index(stat)
        vals = eng.sweep(tracer, n, candidates)[:, col]
        profile = {b: float(v) for b, v in zip(candidates, vals)}
    else:
        profile = {
            b: getattr(predict_runtime(tracer(n, b), models), stat)
            for b in candidates
        }
    b_pred = min(profile, key=profile.get)
    return b_pred, profile


def optimize_algorithm_and_block_size(
        tracers: Mapping[str, Tracer], models: ModelSet, n: int,
        candidates: Sequence[int], *, stat: str = "med",
        batched: bool = True, backend: Optional[str] = None,
        engine: Optional[PredictionEngine] = None,
) -> Tuple[str, int, float]:
    """Joint variant + block-size selection: the paper's two goals combined."""
    _check_scalar_path(batched, backend, engine)
    if batched:
        # one compiled batch over the whole variants x candidates grid;
        # np.argmin's first-minimum tie-breaking matches the scalar loop
        eng = resolve_engine(models, backend, engine)
        names = list(tracers)
        col = STATS.index(stat)
        vals = eng.predict_batch([eng.cache.calls(tracers[name], n, b)
                                  for name in names for b in candidates])
        grid = vals[:, col].reshape(len(names), len(candidates))
        flat = int(grid.argmin())
        vi, bi = divmod(flat, len(candidates))
        return names[vi], candidates[bi], float(grid[vi, bi])
    best: Optional[Tuple[str, int, float]] = None
    for name, tracer in tracers.items():
        b, profile = optimize_block_size(tracer, models, n, candidates,
                                         stat=stat, batched=False)
        t = profile[b]
        if best is None or t < best[2]:
            best = (name, b, t)
    assert best is not None
    return best


# ------------------------------------------------- contractions (Ch. 6) --

def _session(session):
    if session is not None:
        return session
    from ..tc.session import PredictorSession  # lazy: tc builds on core
    return PredictorSession()


def select_contraction_algorithm(spec, sizes: Mapping[str, int], *,
                                 stat: str = "med", session=None) -> str:
    """Ch. 6 counterpart of :func:`select_algorithm`: the contraction
    algorithm (traversal x kernel, batched kernels included) with the
    fastest predicted total runtime.

    Runs on ``session`` (a :class:`repro_torch.tc.PredictorSession`;
    a default session when ``None``), whose suite measurements and
    compiled batches repeated calls share.
    """
    return _session(session).select_contraction_algorithm(spec, sizes,
                                                          stat=stat)


def rank_einsum_paths(chain, sizes: Mapping[str, int], *,
                      stat: str = "med", session=None):
    """Rank every pairwise contraction path of an N-operand einsum.

    The chain counterpart of :func:`rank_algorithms`: all candidate paths
    (``chain`` is a :class:`repro_torch.tc.ChainSpec` or an expression
    like ``"ij,jk,kl->il"``) are predicted through ``session``'s shared
    deduplicated suite and batched engine and returned fastest-first as
    :class:`repro_torch.tc.RankedChain` records, per-step winning
    algorithms included.  The step-by-step per-algorithm oracle is the
    chain predictor's :meth:`~repro_torch.tc.ChainPredictor.
    rank_paths_oracle`; the size-sweep form is the session's
    :meth:`~repro_torch.tc.PredictorSession.rank_einsum_sweep`.
    """
    return _session(session).rank_einsum_paths(chain, sizes, stat=stat)


def select_einsum_path(chain, sizes: Mapping[str, int], *,
                       stat: str = "med", session=None):
    """The fastest-predicted contraction path of an N-operand einsum —
    ``rank_einsum_paths(...)[0]``, same keywords."""
    return rank_einsum_paths(chain, sizes, stat=stat, session=session)[0]


def performance_yield(measured_runtime: Mapping[int, float], b_pred: int,
                      ) -> Tuple[int, float]:
    """§4.6: yield = t_meas(b_opt) / t_meas(b_pred) ∈ (0, 1].

    ``measured_runtime`` maps block size -> measured (median) runtime.
    Returns (b_opt, yield).
    """
    b_opt = min(measured_runtime, key=measured_runtime.get)
    y = measured_runtime[b_opt] / measured_runtime[b_pred]
    return b_opt, y
