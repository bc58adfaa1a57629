"""Contraction prediction on the batched PredictionEngine (Ch. 6 x §4.5).

The per-algorithm path (``repro_torch.core.contractions``)
micro-benchmarks every candidate independently and multiplies out the
loop count in Python.  The :class:`ContractionPredictor` instead treats a
contraction's candidate set like any other configuration sweep of the
engine:

1. every candidate maps to a deduplicated suite micro-benchmark
   (:mod:`repro_torch.tc.suite`) — one measurement per distinct
   (kernel equation, shapes, cache classes) signature;
2. each signature becomes a (kernel, case) of a synthetic
   :class:`PerformanceModel` whose polynomials over the single size
   argument ``n_iterations`` encode the §6.2 prediction exactly:
   ``t_stat(n) = first + per_call_stat * n`` for min/med/max/mean and
   ``std(n) = per_call_std * sqrt(n)`` (Eq. 4.3 quadrature over n calls),
   with the measured first-call overhead (§6.2.6) included once;
3. the whole candidate set is compiled through the engine's
   :class:`TraceCache` into one reusable :class:`CompiledCalls` batch
   (the "block size" axis generalizes to the candidate index) and
   predicted with ``backend="numpy"`` or ``"torch"`` (float64, on the
   card unless ``device="cpu"``).

``rank`` returns the traversal x kernel combinations sorted by predicted
total runtime — a stable sort of the host copy of the predictions, so
ties break by candidate index on either backend; ``rank_oracle`` is the
un-deduplicated per-algorithm equivalence oracle.  With a deterministic
``measure_fn`` injected into the suite, both paths agree bit-for-bit on
the numpy backend.

The total's ``first`` is the measured first-call overhead beyond a
steady call.  On the card there is no compile; what a process pays once
per kernel (lazy module loading, the cuBLAS handle) is kept out of it by
the protocol's untimed first call, so ``first`` is the latency of one
synchronised call beyond a pipelined one — what each warm execution pays
once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .._device import DeviceLike
from ..core.contractions import ContractionAlgorithm, ContractionSpec
from ..core.fitting import Polynomial
from ..core.grids import Domain
from ..core.model import ModelSet, PerformanceModel, Piece
from ..core.predict import KernelCall, PredictionEngine, TraceCache
from ..core.sampler import STATS, Stats
from .kernels import generate_algorithms
from .suite import (MicroBenchmark, MicroBenchmarkKey, MicroBenchmarkSuite,
                    resolve_suite)

#: domain of the synthetic per-signature models: any positive loop count
_N_DOMAIN = Domain((0,), (10 ** 18,))
_SCALE = np.ones(1)


def _signature_piece(mb: MicroBenchmark) -> Piece:
    """The §6.2 prediction as a polynomial piece over n_iterations."""
    linear = ((0,), (1,))          # t(n) = first + per_call * n
    polys = {s: Polynomial(linear,
                           np.array([mb.first, getattr(mb.stats, s)],
                                    dtype=np.float64), _SCALE)
             for s in ("min", "med", "max", "mean")}
    # std of n uncorrelated calls adds in quadrature (Eq. 4.3)
    polys["std"] = Polynomial(((0.5,),),
                              np.array([mb.stats.std], dtype=np.float64),
                              _SCALE)
    return Piece(domain=_N_DOMAIN, polys=polys)


def _total_stats(mb: MicroBenchmark, n: int) -> Stats:
    """Scalar-path total for one algorithm: what the engine must reproduce."""
    return Stats(min=mb.first + mb.stats.min * n,
                 med=mb.first + mb.stats.med * n,
                 max=mb.first + mb.stats.max * n,
                 mean=mb.first + mb.stats.mean * n,
                 std=mb.stats.std * n ** 0.5)


@dataclass(frozen=True)
class RankedContraction:
    """One ranked traversal x kernel combination.

    ``runtime`` is the predicted TOTAL (first-call overhead included
    once); ``first`` exposes that overhead separately so chain
    composition (:mod:`repro_torch.tc.chains`) can count it once per distinct
    ``benchmark`` signature instead of once per step.
    """

    algorithm: ContractionAlgorithm
    runtime: Stats                 # predicted TOTAL runtime (incl. overhead)
    n_iterations: int
    benchmark: MicroBenchmarkKey   # the suite measurement backing it
    first: float                   # measured first-call overhead (seconds)

    @property
    def name(self) -> str:
        """The backing algorithm's display name."""
        return self.algorithm.name


class ContractionPredictor:
    """Rank a contraction's candidate algorithms from shared micro-benchmarks.

    ``prepare()`` (implicit on first use) runs the deduplicated suite and
    builds the per-signature models; ``rank``/``predict`` then evaluate the
    whole candidate set through one compiled engine batch per backend —
    repeated rankings reuse the suite measurements, the shared
    :class:`TraceCache` and the :class:`CompiledCalls` artifact, so they
    cost a few array ops, not a single kernel execution.
    """

    def __init__(self, spec: Union[ContractionSpec, str],
                 sizes: Mapping[str, int], *,
                 algorithms: Optional[
                     Sequence[ContractionAlgorithm]] = None,
                 include_batched: bool = True,
                 repetitions: Optional[int] = None,
                 suite: Optional[MicroBenchmarkSuite] = None,
                 cache: Optional[TraceCache] = None,
                 arrival: Optional[Mapping[str, str]] = None):
        self.spec = spec if isinstance(spec, ContractionSpec) else \
            ContractionSpec.parse(spec)
        self.sizes = dict(sizes)
        # known operand arrival classes ("A"/"B" -> WARM/COLD), forwarded
        # into every suite key — how chain steps see their intermediates
        self.arrival = dict(arrival) if arrival else None
        self.algorithms: List[ContractionAlgorithm] = (
            list(algorithms) if algorithms is not None
            else generate_algorithms(self.spec,
                                     include_batched=include_batched))
        if not self.algorithms:
            raise ValueError(f"no candidate algorithms for "
                             f"{self.spec.einsum_expr()}")
        self.suite = resolve_suite(suite, repetitions)
        self.cache = cache if cache is not None else TraceCache()
        self._engines: Dict[Tuple, PredictionEngine] = {}
        self._models: Optional[ModelSet] = None
        self._benchmarks: List[MicroBenchmark] = []
        self._call_seqs: List[Tuple[KernelCall, ...]] = []
        self._tracer = self._trace   # stable identity for the TraceCache

    # ------------------------------------------------------------- suite --
    def benchmark_keys(self) -> List[MicroBenchmarkKey]:
        """Every candidate's suite key at this predictor's sizes —
        computed WITHOUT measuring anything (key derivation is pure
        arithmetic).  The parametric pre-pass enumerates these across a
        sweep grid to decide which signatures need fitting before any
        ranking runs (:meth:`repro_torch.tc.session.PredictorSession.
        refine_parametric`)."""
        return [self.suite.key_for(alg, self.sizes, arrival=self.arrival)
                for alg in self.algorithms]

    def prepare(self) -> None:
        """Run the (deduplicated) suite and compile the candidate models."""
        if self._models is not None:
            return
        benchmarks = [self.suite.benchmark(alg, self.sizes,
                                           arrival=self.arrival)
                      for alg in self.algorithms]
        models = ModelSet()
        seqs: List[Tuple[KernelCall, ...]] = []
        for alg, mb in zip(self.algorithms, benchmarks):
            if alg.kernel not in models:
                models.add(PerformanceModel(kernel=alg.kernel,
                                            setup="tc-microbench"))
            model = models[alg.kernel]
            case = (mb.key.equation, mb.key.a_shape, mb.key.b_shape,
                    mb.key.out_shape, mb.key.classes)
            if case not in model.cases:
                model.add_piece(case, _signature_piece(mb))
            seqs.append((KernelCall(kernel=alg.kernel, case=case,
                                    sizes=(alg.n_iterations(self.sizes),)),))
        # emit the padded case tensors now: the first torch-backend rank
        # should upload and run, not derive tensors
        self._models = models.finalize()
        self._benchmarks = benchmarks
        self._call_seqs = seqs

    @property
    def model_set(self) -> ModelSet:
        """The finalized per-signature :class:`ModelSet` (prepares on
        first access)."""
        self.prepare()
        return self._models

    def _trace(self, n: int, i: int) -> Tuple[KernelCall, ...]:
        # Tracer-protocol adapter: the engine's block-size axis generalizes
        # to the candidate index; ``n`` is unused (one fixed size mapping)
        return self._call_seqs[i]

    # ----------------------------------------------------------- predict --
    def engine(self, backend: str = "numpy",
               device: DeviceLike = None) -> PredictionEngine:
        """The (shared-cache) engine for one backend and device; models
        built lazily."""
        self.prepare()
        eng = self._engines.get((backend, device))
        if eng is None:
            eng = PredictionEngine(self._models, backend=backend,
                                   cache=self.cache, device=device)
            self._engines[(backend, device)] = eng
        return eng

    def predict(self, backend: str = "numpy",
                device: DeviceLike = None) -> np.ndarray:
        """(n_algorithms, len(STATS)) predicted total runtimes."""
        eng = self.engine(backend, device)
        compiled = eng.compile_sweep(self._tracer, 0,
                                     range(len(self.algorithms)))
        return eng.predict_compiled(compiled)

    def rank(self, *, stat: str = "med", backend: str = "numpy",
             device: DeviceLike = None) -> List[RankedContraction]:
        """All traversal x kernel combinations, fastest-predicted first."""
        arr = self.predict(backend, device)
        col = STATS.index(stat)
        order = np.argsort(arr[:, col], kind="stable")
        return [RankedContraction(
                    algorithm=self.algorithms[i],
                    runtime=Stats(*map(float, arr[i])),
                    n_iterations=self.algorithms[i].n_iterations(self.sizes),
                    benchmark=self._benchmarks[i].key,
                    first=self._benchmarks[i].first)
                for i in order]

    def rank_oracle(self, *, stat: str = "med",
                    fresh: bool = True) -> List[RankedContraction]:
        """The per-algorithm equivalence oracle: §6.2 applied in plain
        Python per candidate — no engine, no batching.

        ``fresh=True`` (default) also re-measures every candidate
        independently (no deduplication), as the original path did;
        ``fresh=False`` reuses the suite's shared measurements, isolating
        the engine-vs-scalar arithmetic so the two rankings must agree
        deterministically even with noisy real timings."""
        out = []
        for alg in self.algorithms:
            mb = self.suite.benchmark_fresh(alg, self.sizes,
                                            arrival=self.arrival) if fresh \
                else self.suite.benchmark(alg, self.sizes,
                                          arrival=self.arrival)
            n = alg.n_iterations(self.sizes)
            out.append(RankedContraction(algorithm=alg,
                                         runtime=_total_stats(mb, n),
                                         n_iterations=n, benchmark=mb.key,
                                         first=mb.first))
        out.sort(key=lambda r: getattr(r.runtime, stat))
        return out

    # -------------------------------------------------------------- cost --
    @property
    def n_benchmarks(self) -> int:
        self.prepare()
        return self.suite.n_benchmarks

    def prediction_cost_fraction(self, measured_seconds: float) -> float:
        """Suite cost over a measured contraction runtime (the paper's
        "merely a fraction of a contraction's runtime" metric)."""
        self.prepare()
        return self.suite.cost_fraction(measured_seconds)


# ------------------------------------------------------- size-sweep mode --

@dataclass(frozen=True)
class SizeSweep:
    """Shared shape of a size-sweep result (contraction or chain level).

    ``rankings[i]`` is the full fastest-first ranking at
    ``sizes_grid[i]``; every point was predicted from the ONE shared
    :attr:`suite` / :attr:`cache`, so a new size point re-predicts from
    existing measurements wherever its (equation, shapes, cache-class)
    keys are unchanged and only the genuinely new keys are measured —
    or, when the suite carries fitted size-parametric models
    (:mod:`repro_torch.tc.parametric`), predicted without measuring at all.
    """

    sizes_grid: Tuple[Dict[str, int], ...]
    rankings: Tuple[Tuple, ...]
    suite: MicroBenchmarkSuite
    cache: TraceCache

    @property
    def winners(self) -> List:
        """The fastest-predicted candidate at each size point."""
        return [ranking[0] for ranking in self.rankings]

    @property
    def n_benchmarks(self) -> int:
        """Distinct micro-benchmarks measured across ALL size points."""
        return self.suite.n_benchmarks

    @property
    def predicted_parametric(self) -> int:
        """Distinct grid keys served from size-parametric models instead
        of measurements (0 on a non-parametric suite) — how much of the
        sweep was covered without a single fresh micro-benchmark."""
        return self.suite.predicted_parametric

    def cost_fraction(self, measured_seconds: float) -> float:
        """Total suite cost over one measured execution — the whole
        sweep's prediction cost as a fraction of a single run."""
        return self.suite.cost_fraction(measured_seconds)


@dataclass(frozen=True)
class ContractionSizeSweep(SizeSweep):
    """One contraction's candidate set ranked across a grid of sizes.

    Produced by :func:`rank_contraction_sweep`; ``rankings`` holds
    :class:`RankedContraction` lists, one per size point, and the
    per-signature models are size-parametric (``t(n) = first +
    per_call * n`` over the loop count) — see :class:`SizeSweep` for the
    shared suite/cache semantics.
    """

    spec: ContractionSpec
    predictors: Tuple[ContractionPredictor, ...]


def rank_contraction_sweep(spec: Union[ContractionSpec, str],
                           sizes_grid: Sequence[Mapping[str, int]], *,
                           stat: str = "med", backend: str = "numpy",
                           device: DeviceLike = None,
                           algorithms: Optional[
                               Sequence[ContractionAlgorithm]] = None,
                           include_batched: bool = True,
                           repetitions: Optional[int] = None,
                           suite: Optional[MicroBenchmarkSuite] = None,
                           cache: Optional[TraceCache] = None,
                           arrival: Optional[Mapping[str, str]] = None,
                           ) -> ContractionSizeSweep:
    """Rank every candidate algorithm at every size point from ONE suite.

    The size-sweep autotuning mode: one :class:`ContractionPredictor`
    per size point, all sharing a single
    :class:`~repro_torch.tc.suite.MicroBenchmarkSuite` and
    :class:`~repro_torch.core.predict.TraceCache` (pass ``suite=``/``cache=``
    to also share them with prior single-size rankings).  Size points
    whose candidates map to already-measured (equation, shapes,
    cache-class) keys re-predict without any new measurement — e.g.
    sweeping a loop-only dimension leaves every loop-nest candidate's
    kernel shapes untouched — so the whole sweep's measurement cost is
    bounded by the number of *distinct* keys, not by
    ``len(sizes_grid) * len(algorithms)``.
    """
    spec = spec if isinstance(spec, ContractionSpec) else \
        ContractionSpec.parse(spec)
    grid = [dict(s) for s in sizes_grid]
    if not grid:
        raise ValueError("sizes_grid must name at least one size point")
    suite = resolve_suite(suite, repetitions)
    cache = cache if cache is not None else TraceCache()
    algs = list(algorithms) if algorithms is not None else \
        generate_algorithms(spec, include_batched=include_batched)
    predictors, rankings = [], []
    for sizes in grid:
        pred = ContractionPredictor(spec, sizes, algorithms=algs,
                                    suite=suite, cache=cache,
                                    arrival=arrival)
        rankings.append(tuple(pred.rank(stat=stat, backend=backend,
                                        device=device)))
        predictors.append(pred)
    return ContractionSizeSweep(spec=spec, sizes_grid=tuple(grid),
                                rankings=tuple(rankings),
                                predictors=tuple(predictors),
                                suite=suite, cache=cache)
