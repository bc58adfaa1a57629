"""Performance-model structure (paper §3.2.1, Fig 3.9).

A :class:`PerformanceModel` represents the runtime of ONE kernel on ONE setup
(hardware, thread count, library).  It is composed of *cases* — discrete
combinations of flag-like arguments — and, per case, a *piecewise polynomial*
over the hyper-cuboidal domain of size arguments.  Each polynomial piece
actually carries one polynomial per runtime summary statistic
(min/med/max/mean/std), so estimates are distributions, not point values.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .fitting import Polynomial, StackedPolynomials, stack_polynomials
from .grids import Domain
from .sampler import STATS

Case = Tuple  # hashable combination of flag/scalar-class/layout arguments


def _freeze(value):
    """Lists to tuples, recursively: the inverse of a JSON round trip for
    the hashable nested-tuple cases models are keyed by."""
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


@dataclass(frozen=True)
class Piece:
    """One polynomial piece: a domain plus per-statistic polynomials."""

    domain: Domain
    polys: Dict[str, Polynomial]  # stat name -> polynomial

    def estimate(self, sizes: Sequence[int]) -> Dict[str, float]:
        return {s: max(float(p(np.asarray(sizes, dtype=np.float64)[None, :])),
                       0.0)
                for s, p in self.polys.items()}

    def _stacked(self) -> StackedPolynomials:
        """Lazily compiled batch evaluator over the canonical STATS order."""
        cached = self.__dict__.get("_stacked_cache")
        if cached is None:
            cached = stack_polynomials([self.polys[s] for s in STATS])
            object.__setattr__(self, "_stacked_cache", cached)
        return cached

    def estimate_batch(self, sizes: np.ndarray) -> np.ndarray:
        """Estimates for (N, d) size points: (N, len(STATS)), clipped at 0."""
        pts = np.atleast_2d(np.asarray(sizes, dtype=np.float64))
        return np.maximum(self._stacked()(pts), 0.0)


@dataclass
class CaseModel:
    """One kernel case's piecewise model: the pieces covering its domain.

    ``estimate``/``estimate_batch`` look up the piece containing the
    requested sizes and evaluate its per-statistic polynomials.
    """

    pieces: List[Piece] = field(default_factory=list)

    def find_piece(self, sizes: Sequence[int]) -> Optional[Piece]:
        for piece in self.pieces:
            if piece.domain.contains(sizes):
                return piece
        return None

    def nearest_piece(self, sizes: Sequence[int]) -> Piece:
        """Clamp out-of-domain queries to the closest piece (extrapolation)."""
        if not self.pieces:
            raise KeyError("empty case model")
        best, best_d = None, None
        for piece in self.pieces:
            d = 0.0
            for lo, hi, x in zip(piece.domain.lo, piece.domain.hi, sizes):
                if x < lo:
                    d += (lo - x) ** 2
                elif x > hi:
                    d += (x - hi) ** 2
            if best_d is None or d < best_d:
                best, best_d = piece, d
        return best

    # ----------------------------------------------------------- batched --
    def piece_indices(self, sizes: np.ndarray,
                      *, extrapolate: bool = True) -> np.ndarray:
        """Vectorized piece lookup for (N, d) size points.

        Mirrors the scalar path exactly: the first containing piece wins;
        rows outside every domain are clamped to the piece with the smallest
        squared clamp distance (first piece on ties, like ``nearest_piece``).
        """
        if not self.pieces:
            raise KeyError("empty case model")
        pts = np.atleast_2d(np.asarray(sizes, dtype=np.float64))
        n = pts.shape[0]
        idx = np.full(n, -1, dtype=np.intp)
        for i, piece in enumerate(self.pieces):
            lo = np.asarray(piece.domain.lo, dtype=np.float64)
            hi = np.asarray(piece.domain.hi, dtype=np.float64)
            inside = np.all((pts >= lo) & (pts <= hi), axis=1)
            idx = np.where((idx < 0) & inside, i, idx)
        missing = idx < 0
        if missing.any():
            if not extrapolate:
                raise KeyError(f"{int(missing.sum())} points outside domain")
            out_pts = pts[missing]
            dist = np.empty((out_pts.shape[0], len(self.pieces)))
            for i, piece in enumerate(self.pieces):
                lo = np.asarray(piece.domain.lo, dtype=np.float64)
                hi = np.asarray(piece.domain.hi, dtype=np.float64)
                below = np.maximum(lo - out_pts, 0.0)
                above = np.maximum(out_pts - hi, 0.0)
                dist[:, i] = (below ** 2).sum(axis=1) + (above ** 2).sum(axis=1)
            idx[missing] = np.argmin(dist, axis=1)
        return idx

    def estimate_batch(self, sizes: np.ndarray,
                       *, extrapolate: bool = True) -> np.ndarray:
        """Batched estimates for (N, d) size points: (N, len(STATS))."""
        pts = np.atleast_2d(np.asarray(sizes, dtype=np.float64))
        idx = self.piece_indices(pts, extrapolate=extrapolate)
        out = np.empty((pts.shape[0], len(STATS)), dtype=np.float64)
        for i, piece in enumerate(self.pieces):
            rows = np.nonzero(idx == i)[0]
            if rows.size:
                out[rows] = piece.estimate_batch(pts[rows])
        return out

    def padded_tensors(self):
        """Per-piece flattened polynomials padded to one (P, M, ·) tensor.

        Returns ``(lo (P, d), hi (P, d), exps (P, M, d), scl (P, M, d),
        cof (P, M, S))`` — the case's whole piecewise model as dense
        tensors.  Pieces with fewer monomial rows are zero-padded
        (exponent 0, scale 1, coefficient 0 — an exact no-op row), so one
        gather + contraction serves the whole case; the prediction engine
        pads these further across (kernel, case) groups into its fused
        torch program.  Memoized, and rebuilt whenever the piece list
        changes (compared by identity: ``pieces`` is a public mutable
        list, and a replaced piece must not serve stale tensors);
        :meth:`PerformanceModel.finalize` emits them eagerly.
        """
        if not self.pieces:
            raise KeyError("empty case model")
        cached = getattr(self, "_tensor_cache", None)
        if cached is not None and len(cached[0]) == len(self.pieces) \
                and all(a is b for a, b in zip(cached[0], self.pieces)):
            return cached[1]
        flat = [p._stacked().flattened() for p in self.pieces]
        m_max = max(e.shape[0] for e, _, _ in flat)
        exps, scl, cof = [], [], []
        for e, s, c in flat:
            pad = m_max - e.shape[0]
            exps.append(np.pad(e, ((0, pad), (0, 0))))
            scl.append(np.pad(s, ((0, pad), (0, 0)), constant_values=1.0))
            cof.append(np.pad(c, ((0, pad), (0, 0))))
        tensors = (
            np.asarray([p.domain.lo for p in self.pieces], dtype=np.float64),
            np.asarray([p.domain.hi for p in self.pieces], dtype=np.float64),
            np.stack(exps), np.stack(scl), np.stack(cof),
        )
        self._tensor_cache = (tuple(self.pieces), tensors)
        return tensors


@dataclass
class PerformanceModel:
    """Piecewise-polynomial runtime model of one kernel (§3.2.1)."""

    kernel: str
    setup: str = "default"
    cases: Dict[Case, CaseModel] = field(default_factory=dict)

    def add_piece(self, case: Case, piece: Piece) -> None:
        self.cases.setdefault(tuple(case), CaseModel()).pieces.append(piece)

    def finalize(self) -> "PerformanceModel":
        """Emit every case's padded tensors eagerly (returns ``self``), so
        the first fused prediction does not pay their derivation."""
        for cm in self.cases.values():
            if cm.pieces:
                cm.padded_tensors()
        return self

    def estimate(self, case: Case, sizes: Sequence[int],
                 *, extrapolate: bool = True) -> Dict[str, float]:
        """Runtime summary-statistic estimates for one kernel invocation."""
        if any(s <= 0 for s in sizes):
            # degenerate call: zero work (Example 4.1's 0-width panels)
            return {s: 0.0 for s in STATS}
        cm = self.cases.get(tuple(case))
        if cm is None:
            raise KeyError(f"{self.kernel}: no model for case {case!r} "
                           f"(have {list(self.cases)})")
        piece = cm.find_piece(sizes)
        if piece is None:
            if not extrapolate:
                raise KeyError(f"{self.kernel}{case}: {sizes} outside domain")
            piece = cm.nearest_piece(sizes)
        return piece.estimate(sizes)

    def estimate_batch(self, case: Case, sizes: np.ndarray,
                       *, extrapolate: bool = True) -> np.ndarray:
        """Batched estimates: (N, d) size points -> (N, len(STATS)).

        Rows with any non-positive size are degenerate zero-work calls
        (Example 4.1) and estimate to all-zero statistics, exactly like the
        scalar :meth:`estimate` — including before the case lookup, so a
        case whose every call is degenerate needs no model at all.
        """
        pts = np.atleast_2d(np.asarray(sizes, dtype=np.float64))
        live = np.all(pts > 0, axis=1)
        if not live.any():
            return np.zeros((pts.shape[0], len(STATS)), dtype=np.float64)
        cm = self.cases.get(tuple(case))
        if cm is None:
            raise KeyError(f"{self.kernel}: no model for case {case!r} "
                           f"(have {list(self.cases)})")
        out = np.zeros((pts.shape[0], len(STATS)), dtype=np.float64)
        out[live] = cm.estimate_batch(pts[live], extrapolate=extrapolate)
        return out

    # ---------------------------------------------------------------- io --
    def to_dict(self) -> dict:
        return {
            "kernel": self.kernel,
            "setup": self.setup,
            "cases": [
                {
                    "case": list(case),
                    "pieces": [
                        {"lo": list(p.domain.lo), "hi": list(p.domain.hi),
                         "polys": {s: poly.to_dict()
                                   for s, poly in p.polys.items()}}
                        for p in cm.pieces
                    ],
                }
                for case, cm in self.cases.items()
            ],
        }

    @staticmethod
    def from_dict(d: dict) -> "PerformanceModel":
        m = PerformanceModel(kernel=d["kernel"], setup=d.get("setup", ""))
        for case_entry in d["cases"]:
            # deep-freeze: JSON turns the case's nested tuples (operand
            # shapes, cache classes in the tc per-signature cases) into
            # lists, which would neither hash nor compare equal to the
            # tuples lookups are keyed by
            case = _freeze(case_entry["case"])
            for p in case_entry["pieces"]:
                piece = Piece(
                    domain=Domain(tuple(p["lo"]), tuple(p["hi"])),
                    polys={s: Polynomial.from_dict(pd)
                           for s, pd in p["polys"].items()},
                )
                m.add_piece(case, piece)
        return m

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @staticmethod
    def load(path: str) -> "PerformanceModel":
        with open(path) as f:
            return PerformanceModel.from_dict(json.load(f))


class ModelSet:
    """The per-setup database of kernel models (Fig 3.9 top level)."""

    def __init__(self, models: Mapping[str, PerformanceModel] = ()):
        self.models: Dict[str, PerformanceModel] = dict(models)

    def __getitem__(self, kernel: str) -> PerformanceModel:
        return self.models[kernel]

    def __contains__(self, kernel: str) -> bool:
        return kernel in self.models

    def add(self, model: PerformanceModel) -> None:
        self.models[model.kernel] = model

    def finalize(self) -> "ModelSet":
        """:meth:`PerformanceModel.finalize` every model (returns
        ``self``): all padded case tensors emitted up front."""
        for model in self.models.values():
            model.finalize()
        return self

    def estimate(self, kernel: str, case: Case,
                 sizes: Sequence[int]) -> Dict[str, float]:
        return self.models[kernel].estimate(case, sizes)

    def estimate_batch(self, kernel: str, case: Case,
                       sizes: np.ndarray) -> np.ndarray:
        return self.models[kernel].estimate_batch(case, sizes)

    # ---------------------------------------------------------------- io --
    def to_dict(self) -> dict:
        return {"models": [self.models[k].to_dict()
                           for k in sorted(self.models)]}

    @staticmethod
    def from_dict(d: dict) -> "ModelSet":
        ms = ModelSet()
        for entry in d["models"]:
            ms.add(PerformanceModel.from_dict(entry))
        return ms

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @staticmethod
    def load(path: str) -> "ModelSet":
        with open(path) as f:
            return ModelSet.from_dict(json.load(f))
