"""Sampling-point distributions over hyper-cuboidal size domains (paper §3.2.2).

Two regular grids are supported:

* a *Cartesian* grid — evenly spaced, maximal point reuse under the
  adaptive-refinement bisection (§3.2.5);
* a *Chebyshev* grid — the boundary-including variant
  ``x_i = cos(i/(n-1) * pi)`` mapped onto each interval, which concentrates
  points near the domain boundary and minimizes polynomial-fit error.

All generated points are rounded to multiples of ``round_to`` (8 in the
paper, §3.1.5.1) to avoid small-scale vectorization artefacts.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np

Point = Tuple[int, ...]


@dataclass(frozen=True)
class Domain:
    """A hyper-cuboidal domain of size arguments: [lo_i, hi_i] per dim."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]

    def __post_init__(self):
        if len(self.lo) != len(self.hi):
            raise ValueError("lo/hi rank mismatch")
        for l, h in zip(self.lo, self.hi):
            if l > h:
                raise ValueError(f"empty domain interval [{l}, {h}]")

    @property
    def ndim(self) -> int:
        return len(self.lo)

    def widths(self) -> Tuple[int, ...]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    def contains(self, point: Sequence[int]) -> bool:
        return all(l <= p <= h for l, p, h in zip(self.lo, point, self.hi))

    def relative_widths(self) -> Tuple[float, ...]:
        """u_i / l_i — the paper splits along the relatively largest dim."""
        return tuple(h / max(l, 1) for l, h in zip(self.lo, self.hi))

    def split(self, round_to: int = 8) -> Tuple["Domain", "Domain", int]:
        """Bisect along the relatively largest dimension (§3.2.5).

        The midpoint is rounded to the nearest multiple of ``round_to``.
        Returns (lower_half, upper_half, split_dim).
        """
        rel = self.relative_widths()
        dim = int(np.argmax(rel))
        l, h = self.lo[dim], self.hi[dim]
        mid = round_to * int(np.floor((l + h + round_to) / (2 * round_to)))
        mid = min(max(mid, l), h)
        lo_a, hi_a = list(self.lo), list(self.hi)
        lo_b, hi_b = list(self.lo), list(self.hi)
        hi_a[dim] = mid
        lo_b[dim] = mid
        return (Domain(tuple(lo_a), tuple(hi_a)),
                Domain(tuple(lo_b), tuple(hi_b)), dim)

    def min_width(self) -> int:
        return min(self.widths())


def _axis_points(lo: int, hi: int, n: int, kind: str, round_to: int) -> np.ndarray:
    if n < 1:
        raise ValueError("need at least one point per axis")
    if n == 1 or lo == hi:
        pts = np.array([0.5 * (lo + hi)])
    elif kind == "cartesian":
        pts = lo + (hi - lo) * np.arange(n) / (n - 1)
    elif kind == "chebyshev":
        # boundary-including Chebyshev grid: cos(i/(n-1) * pi) on [-1, 1]
        t = np.cos(np.arange(n) / (n - 1) * np.pi)  # 1 .. -1
        pts = lo + (hi - lo) * (1.0 - t) / 2.0
    else:
        raise ValueError(f"unknown grid kind {kind!r}")
    pts = round_to * np.round(pts / round_to)
    pts = np.clip(pts, round_to * np.ceil(lo / round_to),
                  round_to * np.floor(hi / round_to))
    return np.unique(pts.astype(np.int64))


def grid_points(domain: Domain, points_per_dim: Sequence[int],
                kind: str = "chebyshev", round_to: int = 8) -> list:
    """Full tensor grid of sampling points, rounded & deduplicated."""
    if len(points_per_dim) != domain.ndim:
        raise ValueError("points_per_dim rank mismatch")
    axes = [
        _axis_points(l, h, n, kind, round_to)
        for l, h, n in zip(domain.lo, domain.hi, points_per_dim)
    ]
    return [tuple(int(v) for v in p) for p in itertools.product(*axes)]


def reused_points(old: Sequence[Point], new_domain: Domain) -> list:
    """Points from a parent grid that fall inside a refined sub-domain.

    Cartesian grids get perfect reuse under bisection (§3.2.2/Fig 3.10);
    Chebyshev grids only reuse the shared boundary points.
    """
    return [p for p in old if new_domain.contains(p)]
