"""Size-parametric per-signature suite models with active refinement.

The suite's per-signature models were exact-shape: every distinct
(kernel equation, operand shapes, cache classes) key needed its own
micro-benchmark, so the suite was really "generated once per *shape*".
This module makes the paper's "generated once per *platform*" promise
real for the contraction stack (§3.2.5, §3.3; cf. arXiv:1409.8602 on
adaptively-sampled cache-aware models and arXiv:1409.8608 on parametric
per-cache-class kernel timings):

* a **signature** is a (canonical kernel equation, cache classes) pair —
  the shape-free part of a :class:`~repro_torch.tc.suite.MicroBenchmarkKey`;
  its **size point** is the tuple of distinct index extents in order of
  first appearance (``ab,bc->ac`` at shapes (64, 32)x(32, 16) is the
  point ``(64, 32, 16)``);
* per signature, a piecewise polynomial over size points is fitted to
  per-call statistics with the adaptive-refinement loop of model generation
  (:func:`repro_torch.core.refinement.refine`): sample a grid, bisect where
  the reference statistic's relative fit error exceeds the bound, stop
  at the target confidence (``error_bound``) or the measurement budget
  (``budget`` -> :attr:`~repro_torch.core.refinement.GeneratorConfig.
  max_points`).  Which shapes get measured is thereby *driven by model
  uncertainty*, not by whichever grid a sweep happens to request;
* predictions inside a fitted domain synthesize a
  :class:`~repro_torch.tc.suite.MicroBenchmark` (per-call stats from the
  containing piece, first-call overhead from a constant relative fit
  over the signature's measured points, ``seconds=0.0`` — predictions
  are free) which flows through the engine exactly like a measurement.
  Out-of-domain points return ``None`` and fall back to the exact-shape
  measurement path, which remains intact as the per-shape equivalence
  oracle (``benchmark_fresh`` / ``rank_oracle``).

The fitted models serialize into one :class:`~repro_torch.core.model.
ModelSet` (cases ``(classes, "percall")`` and ``(classes, "first")`` per
kernel equation) in the dict form both packages share, so a model set
fitted by either package loads in the other (:meth:`ParametricModels.
to_model_set` / :meth:`ParametricModels.load_model_set`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.fitting import Exponents, Polynomial, fit_relative
from ..core.grids import Domain, Point
from ..core.model import CaseModel, ModelSet, PerformanceModel, Piece
from ..core.refinement import GeneratorConfig, refine
from ..core.sampler import STATS, Stats
from .suite import MicroBenchmark, MicroBenchmarkKey, MicroBenchmarkSuite

#: floor for first-call overheads entering the relative fit (a measured
#: first of exactly 0.0 — possible with injected measure_fns — would
#: make the relative least-squares system singular)
_FIRST_FLOOR = 1e-12


@dataclass(frozen=True)
class SignatureKey:
    """The shape-free identity of a suite signature.

    Two :class:`~repro_torch.tc.suite.MicroBenchmarkKey`\\ s with equal
    ``SignatureKey`` differ only in operand sizes — exactly the axis the
    parametric models interpolate over.
    """

    equation: str                  # canonical kernel einsum, "ab,bc->ac"
    classes: Tuple[str, str]       # cache class of the inputs A, B


def signature_dims(equation: str) -> Tuple[str, ...]:
    """The equation's distinct indices in order of first appearance —
    the dimension order of every size point of that signature."""
    seen: List[str] = []
    ins, out = equation.split("->")
    a, b = ins.split(",")
    for ch in a + b + out:
        if ch not in seen:
            seen.append(ch)
    return tuple(seen)


def signature_of(key: MicroBenchmarkKey) -> SignatureKey:
    """The shape-free signature of a concrete benchmark key."""
    return SignatureKey(equation=key.equation, classes=key.classes)


def size_point(key: MicroBenchmarkKey) -> Point:
    """The key's operand sizes as a point over its signature's dims.

    Inverts :meth:`~repro_torch.core.contractions.ContractionAlgorithm.
    kernel_shapes`: each equation index maps positionally onto the
    operand shapes; an index appearing in several operands must carry
    one consistent extent (keys built by ``benchmark_key`` always do).
    """
    ins, out = key.equation.split("->")
    a, b = ins.split(",")
    sizes: Dict[str, int] = {}
    for idx, shape in ((a, key.a_shape), (b, key.b_shape),
                       (out, key.out_shape)):
        if len(idx) != len(shape):
            raise ValueError(f"{key.equation}: index string {idx!r} does "
                             f"not match shape {shape}")
        for ch, n in zip(idx, shape):
            if sizes.setdefault(ch, n) != n:
                raise ValueError(f"{key.equation}: index {ch!r} has "
                                 f"inconsistent extents "
                                 f"{sizes[ch]} != {n}")
    return tuple(sizes[ch] for ch in signature_dims(key.equation))


def key_at(sig: SignatureKey, point: Sequence[int]) -> MicroBenchmarkKey:
    """The concrete benchmark key of ``sig`` at one size point — the
    inverse of :func:`size_point`, used to lower refinement sampling
    points into real (deduplicated) suite measurements."""
    dims = signature_dims(sig.equation)
    if len(point) != len(dims):
        raise ValueError(f"{sig.equation}: point {tuple(point)} has "
                         f"{len(point)} dims, signature has {len(dims)}")
    sizes = dict(zip(dims, (int(p) for p in point)))
    ins, out = sig.equation.split("->")
    a, b = ins.split(",")
    shape = lambda idx: tuple(sizes[ch] for ch in idx)  # noqa: E731
    return MicroBenchmarkKey(equation=sig.equation, a_shape=shape(a),
                             b_shape=shape(b), out_shape=shape(out),
                             classes=sig.classes)


def cost_exponents(equation: str) -> Tuple[Exponents, ...]:
    """Maximal monomial exponents bounding a kernel's cost (§3.2.4).

    One kernel call's flops are ``2 * prod(all kernel dims)`` and its
    traffic a sum of per-operand products — every term is dominated by
    the all-ones exponent tuple over the signature's dims.
    """
    return ((1,) * len(signature_dims(equation)),)


@dataclass
class ParametricModel:
    """One signature's fitted size-parametric model.

    ``case`` holds the refined per-call-statistic pieces over
    :attr:`domain`; ``first_poly`` is the constant relative fit of the
    first-call overhead over the signature's measured points (set-up
    cost varies weakly with shape — a constant extrapolates safely
    where a full polynomial would not).  Predictions outside the fitted
    domain are refused (``None``): extrapolation falls back to the
    exact-shape measurement path instead of guessing.
    """

    sig: SignatureKey
    domain: Domain
    case: CaseModel
    first_poly: Polynomial
    n_refine_measured: int = 0

    def covers(self, point: Sequence[int]) -> bool:
        """Whether ``point`` lies inside a fitted piece's domain."""
        return self.case.find_piece(tuple(point)) is not None

    def predict(self, point: Sequence[int]) -> Optional[Tuple[Stats, float]]:
        """(per-call stats, first-call overhead) at ``point``, or
        ``None`` outside the fitted domain."""
        piece = self.case.find_piece(tuple(point))
        if piece is None:
            return None
        est = piece.estimate(tuple(point))
        first = max(float(self.first_poly(
            np.asarray(point, dtype=np.float64)[None, :])), 0.0)
        return Stats(**{s: est[s] for s in STATS}), first


class ParametricModels:
    """The per-suite registry of fitted size-parametric models.

    Hooked onto a :class:`~repro_torch.tc.suite.MicroBenchmarkSuite` (its
    ``parametric`` attribute), it serves synthetic benchmarks for keys
    whose signature has a fitted model covering the key's size point;
    :meth:`ensure` fits (or refits on a widened domain) whatever a
    grid of upcoming keys needs, sampling through the suite's
    deduplicated ``measure_key`` path so refinement measurements are
    ordinary provenance-tracked suite results and pre-existing
    measurements pre-seed the refinement cache for free.

    ``error_bound`` is the target relative-confidence (maximum relative
    error of the reference statistic's fit on the sampled points) and
    ``budget`` the per-signature fresh-measurement cap — the two knobs
    :class:`~repro_torch.tc.session.PredictorSession` exposes.
    """

    def __init__(self, suite: MicroBenchmarkSuite, *,
                 error_bound: float = 0.05,
                 budget: Optional[int] = 32,
                 reference_stat: str = "med",
                 overfit: int = 0, oversampling: int = 1,
                 grid: str = "cartesian", min_width: int = 8,
                 round_to: int = 8, max_pieces: int = 16):
        self.suite = suite
        self.error_bound = error_bound
        self.budget = budget
        # cheap refinement protocol: overfit 0 keeps the basis at the
        # cost-bounded monomials and oversampling 1 keeps root grids at
        # 3 points per *varying* dim (fixed dims collapse to one point);
        # the cartesian grid maximizes point reuse under bisection
        self.config = GeneratorConfig(
            overfit=overfit, oversampling=oversampling, grid=grid,
            reference_stat=reference_stat, error_kind="maximum",
            error_bound=error_bound, min_width=min_width,
            round_to=round_to, max_pieces=max_pieces, max_points=budget)
        self.models: Dict[SignatureKey, ParametricModel] = {}
        #: fresh measurements issued by refinement fits, total
        self.measured_points = 0

    # ------------------------------------------------------------ predict --
    @property
    def n_signatures(self) -> int:
        return len(self.models)

    def covers(self, key: MicroBenchmarkKey) -> bool:
        model = self.models.get(signature_of(key))
        return model is not None and model.covers(size_point(key))

    def predict(self, key: MicroBenchmarkKey) -> Optional[MicroBenchmark]:
        """A synthetic benchmark for ``key``, or ``None`` when no fitted
        model covers its size point (the caller measures instead).

        ``seconds=0.0``: a prediction costs no measurement wall-clock —
        which is the entire point.
        """
        model = self.models.get(signature_of(key))
        if model is None:
            return None
        pred = model.predict(size_point(key))
        if pred is None:
            return None
        stats, first = pred
        return MicroBenchmark(key=key, stats=stats, first=first,
                              seconds=0.0)

    # ---------------------------------------------------------------- fit --
    def ensure(self, keys: Iterable[MicroBenchmarkKey]) -> Dict[str, int]:
        """Fit whatever models the upcoming ``keys`` need (budgeted).

        Keys are grouped by signature; a signature needs (re)fitting only
        if some of its keys are neither measured already nor covered by
        an existing model.  A refit widens the domain to the bounding box
        of the requested points plus the existing model's domain (old
        coverage is never lost), pre-seeding refinement with every
        already-measured in-domain point.  Returns a summary:
        ``signatures_fitted`` / ``signatures_covered`` (no work needed) /
        ``measured`` (fresh measurements this call issued).
        """
        by_sig: Dict[SignatureKey, List[Point]] = {}
        for key in keys:
            by_sig.setdefault(signature_of(key), []).append(size_point(key))
        fitted = covered = 0
        measured_before = self.suite.measured
        for sig in sorted(by_sig, key=lambda s: (s.equation, s.classes)):
            points = sorted(set(by_sig[sig]))
            missing = [p for p in points
                       if key_at(sig, p) not in self.suite.results]
            model = self.models.get(sig)
            if not missing or (model is not None and
                               all(model.covers(p) for p in missing)):
                covered += 1
                continue
            self.models[sig] = self._fit(sig, points, model)
            self.suite.drop_predictions(sig)
            fitted += 1
        return {"signatures_fitted": fitted,
                "signatures_covered": covered,
                "measured": self.suite.measured - measured_before}

    def _fit(self, sig: SignatureKey, points: Sequence[Point],
             previous: Optional[ParametricModel]) -> ParametricModel:
        ndim = len(signature_dims(sig.equation))
        corners = list(points)
        if previous is not None:
            corners += [previous.domain.lo, previous.domain.hi]
        lo = tuple(min(p[d] for p in corners) for d in range(ndim))
        hi = tuple(max(p[d] for p in corners) for d in range(ndim))
        domain = Domain(lo, hi)
        known = {size_point(k): mb.stats
                 for k, mb in self.suite.results.items()
                 if signature_of(k) == sig
                 and domain.contains(size_point(k))}

        def sample(pts: Sequence[Point]) -> Dict[Point, Stats]:
            return {p: self.suite.measure_key(key_at(sig, p)).stats
                    for p in pts}

        measured_before = self.suite.measured
        pieces = refine(domain, sample, cost_exponents(sig.equation),
                        self.config, known=known)
        n_measured = self.suite.measured - measured_before
        self.measured_points += n_measured
        # first-call overhead: constant relative fit over every measured
        # in-domain point of this signature (refinement samples included)
        pts, firsts = [], []
        for k, mb in self.suite.results.items():
            if signature_of(k) != sig:
                continue
            p = size_point(k)
            if domain.contains(p):
                pts.append(p)
                firsts.append(max(mb.first, _FIRST_FLOOR))
        first_poly = fit_relative(np.asarray(pts, dtype=np.float64),
                                  np.asarray(firsts), ((0,) * ndim,))
        return ParametricModel(sig=sig, domain=domain,
                               case=CaseModel(pieces),
                               first_poly=first_poly,
                               n_refine_measured=n_measured)

    # ------------------------------------------------------- persistence --
    def to_model_set(self) -> ModelSet:
        """All fitted models as one finalized :class:`ModelSet`.

        Per signature: the refined per-call pieces under case
        ``(classes, "percall")`` and the first-call constant (replicated
        across the five statistic slots) under ``(classes, "first")``
        whose single piece's domain records the model's fitted domain.
        Round-trips bit-exactly through JSON (``float.__repr__`` is
        shortest-round-trip).
        """
        ms = ModelSet()
        for sig in sorted(self.models, key=lambda s: (s.equation,
                                                      s.classes)):
            model = self.models[sig]
            if sig.equation not in ms:
                ms.add(PerformanceModel(kernel=sig.equation,
                                        setup="tc-parametric"))
            pm = ms[sig.equation]
            for piece in model.case.pieces:
                pm.add_piece((sig.classes, "percall"), piece)
            pm.add_piece((sig.classes, "first"),
                         Piece(domain=model.domain,
                               polys={s: model.first_poly for s in STATS}))
        return ms.finalize()

    def load_model_set(self, ms: ModelSet) -> int:
        """Restore fitted models from :meth:`to_model_set` output (this
        package's or the reference's); returns how many signatures were
        loaded.
        Existing in-memory models win over loaded ones (they are at
        least as fresh)."""
        loaded = 0
        for equation, pm in ms.models.items():
            percall: Dict[Tuple[str, str], List[Piece]] = {}
            first: Dict[Tuple[str, str], Piece] = {}
            for case, cm in pm.cases.items():
                classes, kind = case
                if kind == "percall":
                    percall[tuple(classes)] = cm.pieces
                elif kind == "first":
                    first[tuple(classes)] = cm.pieces[0]
            for classes, pieces in percall.items():
                sig = SignatureKey(equation=equation, classes=classes)
                if sig in self.models or classes not in first:
                    continue
                anchor = first[classes]
                self.models[sig] = ParametricModel(
                    sig=sig, domain=anchor.domain,
                    case=CaseModel(list(pieces)),
                    first_poly=anchor.polys["med"])
                loaded += 1
        return loaded
