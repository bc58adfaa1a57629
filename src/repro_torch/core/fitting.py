"""Relative least-squares multivariate polynomial fitting (paper §3.2.4).

The polynomial ``p(x) = sum_j beta_j m_j(x)`` is fitted by minimizing the
*relative* squared error ``sum_i ((y_i - p(x_i)) / y_i)^2``, which reduces to
an ordinary least-squares problem on the row-scaled design matrix
``X[i, j] = m_j(x_i) / y_i`` with right-hand side ``1`` (the paper's normal
equations); we solve it with the SVD-based ``numpy.linalg.lstsq`` for
numerical stability, exactly as the paper does.

The monomial basis is bounded by the kernel's asymptotic complexity — a list
of maximal exponent tuples (e.g. ``[(2, 1)]`` for trsm's m^2 n cost) — plus an
optional uniform degree increase ("overfitting", §3.3.1).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

Exponents = Tuple[int, ...]


def monomial_basis(max_exponents: Sequence[Exponents],
                   overfit: int = 0) -> Tuple[Exponents, ...]:
    """All monomials dominated by any of the given maximal exponent tuples.

    ``max_exponents=[(2, 1)]`` (cost m^2 n) yields
    1, x1, x2, x1^2, x1 x2, x1^2 x2 — Example 3.12.  ``overfit`` raises every
    maximal exponent by that amount in each dimension.
    """
    max_exponents = [tuple(e) for e in max_exponents]
    if not max_exponents:
        raise ValueError("need at least one maximal exponent tuple")
    ndim = len(max_exponents[0])
    if any(len(e) != ndim for e in max_exponents):
        raise ValueError("inconsistent exponent rank")
    caps = [tuple(x + overfit for x in e) for e in max_exponents]
    upper = tuple(max(c[d] for c in caps) for d in range(ndim))
    basis = []
    for exps in itertools.product(*[range(u + 1) for u in upper]):
        if any(all(x <= c for x, c in zip(exps, cap)) for cap in caps):
            basis.append(exps)
    basis.sort(key=lambda e: (sum(e), e))
    return tuple(basis)


def _design_matrix(points: np.ndarray, basis: Sequence[Exponents],
                   scale: np.ndarray) -> np.ndarray:
    # points: (N, d) float; scale: (d,) normalization to keep X well-conditioned
    cols = []
    normed = points / scale
    for exps in basis:
        col = np.ones(points.shape[0])
        for d, e in enumerate(exps):
            if e:
                col = col * normed[:, d] ** e
        cols.append(col)
    return np.stack(cols, axis=1)


@dataclass(frozen=True)
class Polynomial:
    """A fitted multivariate polynomial with input normalization."""

    basis: Tuple[Exponents, ...]
    coeffs: np.ndarray       # (M,)
    scale: np.ndarray        # (d,) per-dim normalization used during fitting

    def __call__(self, points) -> np.ndarray:
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        X = _design_matrix(pts, self.basis, self.scale)
        out = X @ self.coeffs
        return out if out.size > 1 else float(out[0])

    def to_dict(self) -> dict:
        return {"basis": [list(b) for b in self.basis],
                "coeffs": self.coeffs.tolist(),
                "scale": self.scale.tolist()}

    @staticmethod
    def from_dict(d: dict) -> "Polynomial":
        return Polynomial(tuple(tuple(b) for b in d["basis"]),
                          np.asarray(d["coeffs"], dtype=np.float64),
                          np.asarray(d["scale"], dtype=np.float64))


@dataclass(frozen=True)
class StackedPolynomials:
    """Several polynomials evaluated together on one batch of points.

    Polynomials sharing a (basis, scale) pair are stacked into a single
    coefficient matrix so one design matrix and one matmul produce all of
    their values — the core primitive of the batched prediction engine.
    Heterogeneous bases (e.g. a constant-only std polynomial next to full
    cost-bounded stat polynomials) fall into separate groups and still
    evaluate with one design matrix per group, not one per polynomial.

    Besides the numpy path (``__call__``), :meth:`flattened` exports the
    groups as dense per-row tensors — the form the prediction engine's
    ``backend="torch"`` path pads and gathers per (kernel, case).
    """

    #: per group: (basis, scale, coeff matrix (M, k), output column indices)
    groups: Tuple[Tuple[Tuple[Exponents, ...], np.ndarray, np.ndarray,
                        Tuple[int, ...]], ...]
    n_out: int

    def __call__(self, points: np.ndarray) -> np.ndarray:
        """Evaluate all stacked polynomials: (N, d) points -> (N, n_out)."""
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        out = np.empty((pts.shape[0], self.n_out), dtype=np.float64)
        for basis, scale, coeff_mat, cols in self.groups:
            X = _design_matrix(pts, basis, scale)
            out[:, cols] = X @ coeff_mat
        return out

    def flattened(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All groups merged into per-row dense tensors for the torch path.

        Returns ``(exps (M, d), scale (M, d), coeffs (M, n_out))`` where row
        ``m`` contributes ``coeffs[m, j] * prod_d (x_d / scale[m, d]) **
        exps[m, d]`` to output column ``j``.  Carrying the normalization per
        row keeps the evaluation equivalent in structure to the grouped
        numpy path, and zero-padded rows (exponent 0, coefficient 0)
        contribute exactly nothing — so flattened tensors of different
        stacks can be padded to a common width and batched together.
        """
        cached = self.__dict__.get("_flattened_cache")
        if cached is None:
            exps, scl, cof = [], [], []
            for basis, scale, coeff_mat, cols in self.groups:
                for r, e in enumerate(basis):
                    exps.append(e)
                    scl.append(scale)
                    row = np.zeros(self.n_out, dtype=np.float64)
                    row[list(cols)] = coeff_mat[r]
                    cof.append(row)
            cached = (np.asarray(exps, dtype=np.float64),
                      np.asarray(scl, dtype=np.float64),
                      np.stack(cof))
            object.__setattr__(self, "_flattened_cache", cached)
        return cached


def stack_polynomials(polys: Sequence[Polynomial]) -> StackedPolynomials:
    """Compile polynomials into grouped coefficient matrices for batch eval."""
    by_key: Dict[Tuple, list] = {}
    for j, p in enumerate(polys):
        by_key.setdefault((p.basis, tuple(p.scale)), []).append(j)
    groups = []
    for (basis, scale), cols in by_key.items():
        coeff_mat = np.stack([polys[j].coeffs for j in cols], axis=1)
        groups.append((basis, np.asarray(scale, dtype=np.float64),
                       coeff_mat, tuple(cols)))
    return StackedPolynomials(tuple(groups), len(polys))


def fit_relative(points: Sequence[Sequence[float]], values: Sequence[float],
                 basis: Sequence[Exponents]) -> Polynomial:
    """Fit ``p`` minimizing sum((y - p(x))/y)^2 — §3.2.4."""
    pts = np.asarray(points, dtype=np.float64)
    y = np.asarray(values, dtype=np.float64)
    if pts.ndim != 2:
        pts = pts.reshape(len(y), -1)
    if np.any(y <= 0):
        raise ValueError("relative fitting requires strictly positive values")
    scale = np.maximum(pts.max(axis=0), 1.0)
    X = _design_matrix(pts, basis, scale)
    Xs = X / y[:, None]
    rhs = np.ones_like(y)
    coeffs, *_ = np.linalg.lstsq(Xs, rhs, rcond=None)
    return Polynomial(tuple(tuple(b) for b in basis), coeffs, scale)


def relative_errors(poly: Polynomial, points, values) -> np.ndarray:
    """Point-wise |y - p(x)| / y (§3.2.5)."""
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    y = np.asarray(values, dtype=np.float64)
    pred = np.atleast_1d(poly(pts))
    return np.abs(y - pred) / y


def error_measure(errors: np.ndarray, kind: str = "maximum") -> float:
    """Aggregate point-wise errors: average / maximum / 90th percentile."""
    if kind == "average":
        return float(np.mean(errors))
    if kind == "maximum":
        return float(np.max(errors))
    if kind in ("p90", "90th"):
        return float(np.percentile(errors, 90))
    raise ValueError(f"unknown error measure {kind!r}")
