"""One entry point for the prediction stack: :class:`PredictorSession`.

The counterpart of ``repro.tc.session``.  The session owns the shared
resources —

* the :class:`~repro_torch.tc.suite.MicroBenchmarkSuite` (deduplicated
  cache-aware measurements, cost accounting),
* the :class:`~repro_torch.core.predict.TraceCache` (compiled sweep
  batches),
* the evaluation **backend** (``"numpy"`` or ``"torch"``) and, for the
  torch backend, its **device**,
* the per-(spec, sizes) predictor instances themselves (so a repeated
  ranking reuses the compiled batch, not just the measurements)

— and exposes every ranking and selection mode as a method: the
contraction predictor, the chain predictor, their rank / select / sweep
forms, the size-parametric refinement, and the device measurement facet
that the tile tuner ranks through (:meth:`rank_device_tiles`).  Two
sessions can share measurements by passing one session's ``suite`` /
``cache`` into the other's constructor (e.g. a numpy and a torch session
over one suite).

The store facets persist a session and warm-start another one from it
(``store=``, :meth:`PredictorSession.save_store`), and probe a
warm-started suite for drift (:meth:`PredictorSession.check_drift`);
see :mod:`repro_torch.store`.  The reference's serving facets are not
part of the port yet.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .._device import DeviceLike, resolve_device
from ..core.contractions import ContractionAlgorithm, ContractionSpec
from ..core.predict import BACKENDS, TraceCache
from .chains import (ChainPredictor, ChainSizeSweep, ChainSpec, RankedChain,
                     rank_einsum_sweep)
from .parametric import ParametricModels
from .predictor import (ContractionPredictor, ContractionSizeSweep,
                        RankedContraction, rank_contraction_sweep)
from .suite import MicroBenchmarkSuite


class PredictorSession:
    """Owns the shared prediction resources and every ranking entry point.

    ``backend`` fixes how compiled batches are evaluated for every method
    of this session; on ``"torch"`` the float64 program runs on
    ``device`` (the CUDA card unless ``device="cpu"``; without a card
    and without that request the constructor raises).  A suite this
    session builds measures on ``device`` too, against the card's L2 (a
    CPU caller that measures passes a ``suite=`` built with
    ``cache_bytes=``).  ``repetitions`` configures a freshly built suite
    and conflicts with passing ``suite=`` (the suite owns its measurement
    protocol).

    Predictors are memoized per (spec, sizes, candidate-set) signature:
    calling :meth:`rank_contraction_algorithms` twice with equal
    arguments reuses the first call's compiled batch outright.

    With ``parametric=True`` the session carries a
    :class:`~repro_torch.tc.parametric.ParametricModels` registry hooked
    onto its suite: sweeps pre-fit size-parametric per-signature models
    with budgeted adaptive refinement (:meth:`refine_parametric`) and
    grid points inside a fitted domain are *predicted*, not measured.  A
    suite shared from another session brings its registry along.

    ``store`` warm-starts the session from a
    :class:`repro_torch.store.ModelStore` (an object, or a path loaded
    under the fingerprint check of ``device``, which is then resolved:
    the card unless ``device="cpu"``; ``allow_mismatch=True`` accepts
    another platform's store).  The store's measurement protocol builds
    the suite and every stored measurement is pre-loaded, so rankings the
    store covers take zero new micro-benchmarks; stored parametric models
    switch ``parametric`` on, and stored device models are pre-loaded
    into :meth:`device_suite`.  ``store=`` and ``suite=`` exclude each
    other.
    """

    def __init__(self, *, backend: str = "numpy",
                 device: DeviceLike = None,
                 suite: Optional[MicroBenchmarkSuite] = None,
                 cache: Optional[TraceCache] = None,
                 repetitions: Optional[int] = None,
                 store=None, allow_mismatch: bool = False,
                 parametric: bool = False,
                 parametric_error_bound: float = 0.05,
                 parametric_budget: Optional[int] = 32):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"choose from {BACKENDS}")
        self.backend = backend
        # the torch engine's device (and a warm start's platform) is
        # resolved now, so a missing card raises here rather than at the
        # first ranking
        self.device = resolve_device(device) \
            if backend == "torch" or store is not None else device
        param_sets = None
        self._device_models = None
        if store is not None:
            if suite is not None:
                raise ValueError(
                    "pass store= or suite=, not both: a warm-started "
                    "session builds its suite from the store")
            from ..store.modelstore import ModelStore
            if not isinstance(store, ModelStore):
                store = ModelStore.load(store, allow_mismatch=allow_mismatch,
                                        device=self.device)
            self.suite = store.build_suite(repetitions=repetitions,
                                           device=self.device)
            param_sets = store.parametric_model_set()
            parametric = parametric or param_sets is not None
            self._device_models = store.device_model_set()
        elif suite is not None:
            if repetitions is not None and repetitions != suite.repetitions:
                raise ValueError(
                    f"repetitions={repetitions} conflicts with the supplied "
                    f"suite's repetitions={suite.repetitions}; pass one or "
                    f"the other")
            self.suite = suite
        else:
            self.suite = MicroBenchmarkSuite(
                repetitions=5 if repetitions is None else repetitions,
                device=self.device)
        self.cache = cache if cache is not None else TraceCache()
        if parametric and self.suite.parametric is None:
            self.suite.parametric = ParametricModels(
                self.suite, error_bound=parametric_error_bound,
                budget=parametric_budget)
        # a shared suite brings its registry along; the knobs were fixed
        # by whoever built it
        self.parametric = self.suite.parametric
        if param_sets is not None:
            self.parametric.load_model_set(param_sets)
        self._contraction: Dict[Tuple, ContractionPredictor] = {}
        self._chain: Dict[Tuple, ChainPredictor] = {}
        self._device = None

    @property
    def _engine_device(self):
        return self.device if self.backend == "torch" else None

    # -------------------------------------------------------- predictors --
    def contraction_predictor(self, spec: Union[ContractionSpec, str],
                              sizes: Mapping[str, int], *,
                              algorithms: Optional[
                                  Sequence[ContractionAlgorithm]] = None,
                              include_batched: bool = True,
                              arrival: Optional[Mapping[str, str]] = None,
                              ) -> ContractionPredictor:
        """The (memoized) per-contraction predictor on this session's
        suite/cache.  Explicit ``algorithms`` bypass the memo — a custom
        candidate set is the caller's to manage."""
        spec = spec if isinstance(spec, ContractionSpec) else \
            ContractionSpec.parse(spec)
        if algorithms is not None:
            return ContractionPredictor(spec, sizes, algorithms=algorithms,
                                        include_batched=include_batched,
                                        suite=self.suite, cache=self.cache,
                                        arrival=arrival)
        key = (spec, tuple(sorted(sizes.items())), include_batched,
               tuple(sorted(arrival.items())) if arrival else None)
        pred = self._contraction.get(key)
        if pred is None:
            pred = ContractionPredictor(spec, sizes,
                                        include_batched=include_batched,
                                        suite=self.suite, cache=self.cache,
                                        arrival=arrival)
            self._contraction[key] = pred
        return pred

    def chain_predictor(self, chain, sizes: Mapping[str, int], *,
                        include_batched: bool = True,
                        kernels: Optional[Sequence[str]] = None,
                        max_loop_perms: int = 24,
                        memory_limit_bytes: Optional[int] = None,
                        ) -> ChainPredictor:
        """The (memoized) per-einsum chain predictor on this session's
        suite/cache."""
        chain = ChainSpec.parse(chain)
        key = (chain, tuple(sorted(sizes.items())), include_batched,
               tuple(kernels) if kernels is not None else None,
               max_loop_perms, memory_limit_bytes)
        pred = self._chain.get(key)
        if pred is None:
            pred = ChainPredictor(chain, sizes, suite=self.suite,
                                  cache=self.cache,
                                  include_batched=include_batched,
                                  kernels=kernels,
                                  max_loop_perms=max_loop_perms,
                                  memory_limit_bytes=memory_limit_bytes)
            self._chain[key] = pred
        return pred

    # ---------------------------------------------------- contractions --
    def rank_contraction_algorithms(
            self, spec: Union[ContractionSpec, str],
            sizes: Mapping[str, int], *, stat: str = "med",
            algorithms: Optional[Sequence[ContractionAlgorithm]] = None,
            include_batched: bool = True,
            arrival: Optional[Mapping[str, str]] = None,
            ) -> List[RankedContraction]:
        """All candidate algorithms fastest-predicted first (Ch. 6) as
        :class:`~repro_torch.tc.predictor.RankedContraction` records."""
        pred = self.contraction_predictor(spec, sizes,
                                          algorithms=algorithms,
                                          include_batched=include_batched,
                                          arrival=arrival)
        return pred.rank(stat=stat, backend=self.backend,
                         device=self._engine_device)

    def select_contraction_algorithm(
            self, spec: Union[ContractionSpec, str],
            sizes: Mapping[str, int], *, stat: str = "med",
            include_batched: bool = True) -> str:
        """The fastest-predicted candidate's name —
        ``rank_contraction_algorithms(...)[0].name``."""
        return self.rank_contraction_algorithms(
            spec, sizes, stat=stat,
            include_batched=include_batched)[0].name

    def rank_contraction_sweep(
            self, spec: Union[ContractionSpec, str],
            sizes_grid: Sequence[Mapping[str, int]], *, stat: str = "med",
            algorithms: Optional[Sequence[ContractionAlgorithm]] = None,
            include_batched: bool = True,
            arrival: Optional[Mapping[str, str]] = None,
            ) -> ContractionSizeSweep:
        """Size-sweep autotuning on this session's shared suite: only
        genuinely new (equation, shapes, cache-class) keys are measured
        across the grid.  On a parametric session the grid's signatures
        are pre-fitted first (:meth:`refine_parametric`)."""
        if self.parametric is not None:
            self.refine_parametric(spec, sizes_grid,
                                   algorithms=algorithms,
                                   include_batched=include_batched,
                                   arrival=arrival)
        # the session IS the owner of the suite/cache/backend it forwards
        # reprolint: allow[deprecated-kwarg]
        return rank_contraction_sweep(
            spec, sizes_grid, stat=stat, backend=self.backend,
            device=self._engine_device, algorithms=algorithms,
            include_batched=include_batched, suite=self.suite,
            cache=self.cache, arrival=arrival)

    # ----------------------------------------------------------- chains --
    def rank_einsum_paths(self, chain, sizes: Mapping[str, int], *,
                          stat: str = "med",
                          include_batched: bool = True,
                          kernels: Optional[Sequence[str]] = None,
                          max_loop_perms: int = 24,
                          memory_limit_bytes: Optional[int] = None,
                          ) -> List[RankedChain]:
        """All pairwise contraction paths of an einsum, fastest-predicted
        chain total first, from this session's shared suite."""
        pred = self.chain_predictor(chain, sizes,
                                    include_batched=include_batched,
                                    kernels=kernels,
                                    max_loop_perms=max_loop_perms,
                                    memory_limit_bytes=memory_limit_bytes)
        return pred.rank_paths(stat=stat, backend=self.backend,
                               device=self._engine_device)

    def select_einsum_path(self, chain, sizes: Mapping[str, int], *,
                           stat: str = "med",
                           include_batched: bool = True) -> RankedChain:
        """The fastest-predicted path — ``rank_einsum_paths(...)[0]``."""
        return self.rank_einsum_paths(
            chain, sizes, stat=stat, include_batched=include_batched)[0]

    def rank_einsum_sweep(self, chain,
                          sizes_grid: Sequence[Mapping[str, int]], *,
                          stat: str = "med",
                          include_batched: bool = True,
                          kernels: Optional[Sequence[str]] = None,
                          max_loop_perms: int = 24,
                          memory_limit_bytes: Optional[int] = None,
                          ) -> ChainSizeSweep:
        """Chain-level size sweep from this session's shared suite.  On
        a parametric session the grid's step signatures are pre-fitted
        first (:meth:`refine_parametric`)."""
        if self.parametric is not None:
            self.refine_parametric(chain, sizes_grid,
                                   include_batched=include_batched,
                                   kernels=kernels,
                                   max_loop_perms=max_loop_perms,
                                   memory_limit_bytes=memory_limit_bytes)
        # the session IS the owner of the suite/cache/backend it forwards
        # reprolint: allow[deprecated-kwarg]
        return rank_einsum_sweep(
            chain, sizes_grid, stat=stat, backend=self.backend,
            device=self._engine_device, suite=self.suite, cache=self.cache,
            include_batched=include_batched, kernels=kernels,
            max_loop_perms=max_loop_perms,
            memory_limit_bytes=memory_limit_bytes)

    # ------------------------------------------------------- parametric --
    def refine_parametric(self, spec,
                          sizes_grid: Sequence[Mapping[str, int]], *,
                          algorithms: Optional[
                              Sequence[ContractionAlgorithm]] = None,
                          include_batched: bool = True,
                          arrival: Optional[Mapping[str, str]] = None,
                          kernels: Optional[Sequence[str]] = None,
                          max_loop_perms: int = 24,
                          memory_limit_bytes: Optional[int] = None,
                          ) -> Dict[str, int]:
        """Fit size-parametric models for everything a sweep will need.

        The pre-pass enumerates every micro-benchmark key the grid's
        candidates map to (pure key arithmetic — nothing is measured),
        groups them by (canonical kernel equation, cache classes)
        signature, and fits a budgeted adaptive-refinement model per
        signature with unmeasured keys
        (:meth:`repro_torch.tc.parametric.ParametricModels.ensure`).
        ``spec`` may be a pairwise contraction or an N-operand einsum
        chain (the chain keywords apply only then).  Returns the ensure
        summary — ``signatures_fitted`` / ``signatures_covered`` /
        ``measured``.  The exact-shape measurement path
        (``benchmark_fresh`` / ``rank_oracle``) stays the per-shape
        oracle for these fits.
        """
        if self.parametric is None:
            raise ValueError(
                "parametric models are disabled: construct the session "
                "with parametric=True")
        chain = isinstance(spec, ChainSpec) or (
            not isinstance(spec, ContractionSpec)
            and str(spec).split("->")[0].count(",") >= 2)
        keys = []
        for sizes in sizes_grid:
            if chain:
                pred = self.chain_predictor(
                    spec, sizes, include_batched=include_batched,
                    kernels=kernels, max_loop_perms=max_loop_perms,
                    memory_limit_bytes=memory_limit_bytes)
            else:
                pred = self.contraction_predictor(
                    spec, sizes, algorithms=algorithms,
                    include_batched=include_batched, arrival=arrival)
            keys.extend(pred.benchmark_keys())
        return self.parametric.ensure(keys)

    # ------------------------------------------------------------ device --
    def device_suite(self, **kwargs):
        """This session's device measurement facet — a
        :class:`repro_torch.tc.device.DeviceSuite` over the shared suite,
        created on first use; ``kwargs`` configure that first
        construction (``device=``, ``passes=``, ``sweep_fn=``,
        ``transfer_measure_fn=``, ...).  A store warm start that holds
        device models (:data:`repro_torch.store.DEVICE_MODEL_SET`)
        pre-loads them, so tile rankings take no memcpy probe, and
        configs whose measurements the store holds take no sweep."""
        if self._device is None:
            from .device import DeviceSuite
            self._device = DeviceSuite(self.suite, **kwargs)
            if self._device_models is not None:
                self._device.load_model_set(self._device_models)
        elif kwargs:
            raise ValueError(
                "the session's device suite is already built; its "
                "configuration kwargs must go to the first device_suite "
                "call")
        return self._device

    def rank_device_tiles(self, kernel: str, problem: Sequence[int],
                          configs: Sequence[Sequence[int]], *,
                          stat: str = "med", transfer: bool = True,
                          itemsize: int = 4):
        """Rank kernel tile configs for one problem from measured device
        models, fastest-predicted total first — each entry carries the
        ``T_h2d + T_compute + T_d2h`` decomposition (see
        :meth:`repro_torch.tc.device.DeviceSuite.rank`).  ``kernel`` is a
        :data:`repro_torch.tc.device.DEVICE_KERNELS` name."""
        return self.device_suite().rank(kernel, problem, configs,
                                        stat=stat, transfer=transfer,
                                        itemsize=itemsize)

    # ------------------------------------------------------------ store --
    def save_store(self, path=None, *, fingerprint=None):
        """Capture this session's measurements (and every prepared
        per-contraction :class:`~repro_torch.core.model.ModelSet`) into a
        :class:`repro_torch.store.ModelStore` for the suite's device;
        write it to ``path`` if given.

        A session in another process warm-starts from the file via
        ``PredictorSession(store=path)`` and, measurements being the only
        input to the per-signature models, produces bit-identical
        rankings with zero new micro-benchmarks.  Fitted size-parametric
        models and the device suite's kernel and transfer models ride
        along under the store's reserved names.
        """
        from ..store.modelstore import ModelStore
        store = ModelStore.from_suite(self.suite, fingerprint=fingerprint,
                                      device=self.suite.device)
        for key, pred in self._contraction.items():
            if pred._models is None:
                continue             # never ranked: nothing fitted to keep
            spec, sizes = key[0], key[1]
            name = f"{spec.einsum_expr()}|" + ",".join(
                f"{k}={v}" for k, v in sizes)
            store.add_model_set(name, pred.model_set)
        if self.parametric is not None and self.parametric.models:
            store.add_parametric_models(self.parametric)
        if self._device is not None:
            device_models = self._device.to_model_set()
            if device_models.models:
                store.add_device_models(device_models)
        if path is not None:
            store.save(path)
        return store

    def check_drift(self, *, max_keys: int = 8, threshold: float = 1.5,
                    refresh: bool = False, measure_fn=None):
        """Probe a deterministic subset of the suite's stored keys for
        platform drift (see :class:`repro_torch.store.DriftProbe`).

        Warns (:class:`UserWarning`) when any probed key drifted beyond
        ``threshold``; with ``refresh=True`` the stale keys are
        re-measured in place (the suite's ``refreshed`` counter records
        the repairs).  Returns the probe's readings.
        """
        from ..store.drift import DriftProbe
        probe = DriftProbe(self.suite, max_keys=max_keys,
                           threshold=threshold, measure_fn=measure_fn)
        readings = probe.probe()
        stale = probe.stale()
        if stale:
            worst = max(stale, key=lambda r: max(r.ratio, 1 / r.ratio))
            warnings.warn(
                f"model drift: {len(stale)}/{len(readings)} probed "
                f"micro-benchmarks moved beyond {threshold}x (worst "
                f"ratio {worst.ratio:.2f} on {worst.key.equation} "
                f"{worst.key.a_shape}x{worst.key.b_shape}); "
                + ("stale keys refreshed in place" if refresh else
                   "re-measure with refresh=True or re-generate the "
                   "store"),
                UserWarning, stacklevel=2)
            if refresh:
                probe.refresh()
        return readings

    # ------------------------------------------------------------- cost --
    def counters(self) -> Dict[str, float]:
        """The shared suite's running totals plus trace-cache hit/miss
        counts — diff two snapshots to see what one phase added."""
        out = dict(self.suite.counters())
        out["trace_hits"] = self.cache.hits
        out["trace_misses"] = self.cache.misses
        return out
