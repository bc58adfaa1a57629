"""Adaptive-refinement model generation (paper §3.2.5, §3.3).

Starting from one hyper-cuboidal domain, fit one polynomial per summary
statistic to measurements on a sampling grid; if the *error measure* of the
*reference statistic*'s fit exceeds the *target error bound*, bisect the
domain along its relatively largest dimension and recurse, until either the
bound or the *minimum width* is reached.  The eight configuration parameters
of §3.3.1 are grouped in :class:`GeneratorConfig`; its defaults are the
paper's selected default configuration (Table 3.3, row 10).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .fitting import (Exponents, Polynomial, error_measure, fit_relative,
                      monomial_basis, relative_errors)
from .grids import Domain, Point, grid_points
from .model import Piece
from .sampler import STATS, Stats


@dataclass(frozen=True)
class GeneratorConfig:
    """§3.3.1 configuration parameters (defaults = Table 3.3 line 10)."""

    overfit: int = 2
    oversampling: int = 4
    grid: str = "chebyshev"          # or "cartesian"
    repetitions: int = 10
    reference_stat: str = "min"      # or "med"
    error_kind: str = "maximum"      # or "average" / "p90"
    error_bound: float = 0.01
    min_width: int = 32
    round_to: int = 8
    max_pieces: int = 128            # safety cap (not in the paper)
    #: measurement budget (not in the paper): once this many points have
    #: been *freshly* sampled, the current pieces become terminal — no
    #: further bisection.  The root grid is always sampled in full, so
    #: the total may overshoot by at most one grid.  ``None`` = unbounded.
    max_points: Optional[int] = None


SampleFn = Callable[[Sequence[Point]], Mapping[Point, Stats]]


def _points_per_dim(basis: Sequence[Exponents], ndim: int,
                    oversampling: int) -> List[int]:
    # at least degree+1 points per dim, plus `oversampling` extra (§3.3.1)
    out = []
    for d in range(ndim):
        deg = max(e[d] for e in basis)
        out.append(deg + 1 + oversampling)
    return out


class _Cache:
    """Measurement cache enabling point reuse across refinement levels.

    ``known`` pre-seeds the cache with measurements taken elsewhere (e.g.
    a suite's exact-shape results): those points are served without
    sampling and do NOT count toward :attr:`measured_points`, so a
    measurement budget (:attr:`GeneratorConfig.max_points`) bounds only
    the *fresh* work refinement causes.
    """

    def __init__(self, sample_fn: SampleFn,
                 known: Optional[Mapping[Point, Stats]] = None):
        self.sample_fn = sample_fn
        self.data: Dict[Point, Stats] = dict(known) if known else {}
        self.measured_points = 0

    def get(self, points: Sequence[Point]) -> Dict[Point, Stats]:
        missing = [p for p in points if p not in self.data]
        if missing:
            new = self.sample_fn(missing)
            self.data.update(new)
            self.measured_points += len(missing)
        return {p: self.data[p] for p in points}


def _fit_piece(domain: Domain, stats: Mapping[Point, Stats],
               basis: Sequence[Exponents],
               ref_stat: str) -> Tuple[Piece, np.ndarray]:
    points = list(stats.keys())
    pts = np.asarray(points, dtype=np.float64)
    polys: Dict[str, Polynomial] = {}
    for s in STATS:
        vals = np.asarray([getattr(stats[p], s) for p in points])
        if s == "std":
            # std can be 0 -> relative fit undefined; fit on mean-relative floor
            floor = max(1e-12, float(np.median(
                [getattr(stats[p], "mean") for p in points])) * 1e-6)
            vals = np.maximum(vals, floor)
        polys[s] = fit_relative(pts, vals, basis)
    ref_vals = np.asarray([getattr(stats[p], ref_stat) for p in points])
    errs = relative_errors(polys[ref_stat], pts, ref_vals)
    return Piece(domain=domain, polys=polys), errs


def refine(domain: Domain, sample_fn: SampleFn,
           cost_exponents: Sequence[Exponents],
           config: GeneratorConfig = GeneratorConfig(), *,
           known: Optional[Mapping[Point, Stats]] = None) -> List[Piece]:
    """Generate the piecewise-polynomial sub-model for one case (§3.2.5).

    ``known`` pre-seeds the measurement cache (see :class:`_Cache`):
    points already measured elsewhere are reused without sampling and
    without counting toward ``config.max_points``.
    """
    basis = monomial_basis(cost_exponents, overfit=config.overfit)
    cache = _Cache(sample_fn, known=known)
    pieces: List[Piece] = []
    stack = [domain]
    while stack:
        dom = stack.pop()
        ppd = _points_per_dim(basis, dom.ndim, config.oversampling)
        pts = grid_points(dom, ppd, kind=config.grid,
                          round_to=config.round_to)
        if len(pts) < len(basis):
            # rounding collapsed the grid below the basis size: densify
            pts = grid_points(dom, [p * 2 for p in ppd], kind="cartesian",
                              round_to=config.round_to)
        stats = cache.get(pts)
        piece, errs = _fit_piece(dom, stats, basis, config.reference_stat)
        err = error_measure(errs, config.error_kind)
        terminal = (
            err <= config.error_bound
            or dom.min_width() < config.min_width
            or len(pieces) + len(stack) + 2 > config.max_pieces
            or (config.max_points is not None
                and cache.measured_points >= config.max_points)
        )
        if terminal:
            pieces.append(piece)
        else:
            lo_half, hi_half, _ = dom.split(config.round_to)
            if lo_half.widths() == dom.widths() or \
               hi_half.widths() == dom.widths():
                pieces.append(piece)  # split made no progress
            else:
                stack.extend((lo_half, hi_half))
    return pieces


def stats_sample_fn(measure: Callable[[Point], Callable[[], None]],
                    repetitions: int = 10, seed: int = 0) -> SampleFn:
    """Wrap a call builder into a SampleFn using the ELAPS-style sampler."""
    from .sampler import measure_calls

    def sample(points: Sequence[Point]) -> Dict[Point, Stats]:
        calls = {p: measure(p) for p in points}
        return dict(measure_calls(calls, repetitions=repetitions, seed=seed))

    return sample
