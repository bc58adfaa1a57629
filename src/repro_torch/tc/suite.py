"""Deduplicated cache-aware micro-benchmarks for contractions (§6.2).

A contraction's candidate algorithms are highly regular: many distinct
traversals call the *same* kernel on the *same* operand shapes under the
*same* cache preconditions, so their micro-benchmarks are interchangeable.
The suite exploits that: each candidate maps to a
:class:`MicroBenchmarkKey` — (kernel equation, kernel operand shapes,
cache class per operand) — and each distinct key is measured exactly once,
shared across every algorithm that maps to it.  The equation is stored
*canonically relabeled* (:func:`canonical_equation`), which is what lets
the steps of a multi-contraction chain (:mod:`repro_torch.tc.chains`)
share one suite.

Cache classes come from the §6.2.3 access distance against the suite's
cache capacity — the card's L2, read from the device unless
``cache_bytes=`` is given (a CPU caller must give it) — with two
refinements:

* **batched kernels classify per batch slice** — a batched kernel walks
  its batch dims strided, so the cache working set is one slice's
  operands, not the whole stacked call
  (:func:`~repro_torch.tc.kernels.slice_call_bytes`);
* callers may pass **arrival overrides** (``arrival={"A": COLD}``):
  an operand known to arrive cold — e.g. a chain intermediate bigger than
  the cache — is forced cold regardless of its in-loop reuse distance.

The measurement itself is the shared §6.2 protocol
(:func:`~repro_torch.core.contractions.run_kernel_benchmark` — also
backing the per-algorithm oracle): bursts of pipelined kernel calls, cold
operands cycling through a pool of distinct buffers, the first-call
overhead timed separately.  The cache classes cover the kernel's *input*
operands; the output is one contiguous buffer the calls add into.  The
suite accounts its own wall-clock cost (:attr:`~MicroBenchmarkSuite.
cost_seconds`) so a prediction can be stated as a fraction of a measured
contraction runtime — the paper's headline metric for Ch. 6.

Device kernel keys (:mod:`repro_torch.tc.device`) share the suite: their
measurements enter through :meth:`MicroBenchmarkSuite.record_measurement`
(a whole-grid sweep), never through the per-key einsum protocol.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

from .._device import DeviceLike
from ..core.contractions import (_ITEM, ContractionAlgorithm,
                                 access_distance, canonical_equation,
                                 l2_cache_bytes, run_kernel_benchmark)
from ..core.sampler import Stats
from .kernels import is_batched_kernel, slice_call_bytes

#: cache classes an operand can be benchmarked under
WARM, COLD = "warm", "cold"


@dataclass(frozen=True)
class MicroBenchmarkKey:
    """Identity of one distinct micro-benchmark.

    Two candidate algorithms with equal keys perform indistinguishable
    kernel calls under indistinguishable cache states, so one measurement
    serves both — the suite's deduplication signature.  Device kernel keys
    set ``equation`` to the kernel's registry name, ``classes`` to its
    shared-memory class and ``config`` to its tile config
    (:mod:`repro_torch.tc.device`); einsum keys leave ``config`` ``None``.
    """

    equation: str                      # CANONICAL kernel einsum, "ab,bc->ac"
    a_shape: Tuple[int, ...]
    b_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    classes: Tuple[str, str]           # cache class of the inputs A, B
    config: Optional[Tuple[int, ...]] = None

    @property
    def call_bytes(self) -> int:
        """Bytes one kernel call touches across all three operands."""
        return _ITEM * (math.prod(self.a_shape) + math.prod(self.b_shape) +
                        math.prod(self.out_shape))


def benchmark_key(alg: ContractionAlgorithm, sizes: Mapping[str, int],
                  cache_bytes: int, *,
                  arrival: Optional[Mapping[str, str]] = None,
                  ) -> MicroBenchmarkKey:
    """Map an algorithm at concrete sizes to its micro-benchmark identity.

    The equation is stored canonically relabeled; classes come from the
    §6.2.3 access distance against ``cache_bytes``.  For batched kernels
    the distance is rescaled to one *batch slice's* call bytes.
    ``arrival`` maps operand names (``"A"``/``"B"``) to a known arrival
    class: ``COLD`` forces the operand cold; ``WARM`` defers to the
    distance.
    """
    a_sh, b_sh, o_sh = alg.kernel_shapes(sizes)
    dists = dict(access_distance(alg, sizes))
    if is_batched_kernel(alg.kernel):
        call_bytes = _ITEM * (math.prod(a_sh) + math.prod(b_sh) +
                              math.prod(o_sh))
        scale = slice_call_bytes(alg, sizes) / call_bytes
        dists = {op: d * scale for op, d in dists.items()}
    arrival = arrival or {}
    classes = tuple(
        COLD if (dists[op] > cache_bytes or arrival.get(op) == COLD)
        else WARM
        for op in ("A", "B"))
    return MicroBenchmarkKey(canonical_equation(alg.kernel_equation()),
                             a_sh, b_sh, o_sh, classes)


@dataclass(frozen=True)
class MicroBenchmark:
    """One measured micro-benchmark: per-call stats + first-call overhead."""

    key: MicroBenchmarkKey
    stats: Stats         # per-call runtime statistics (seconds)
    first: float         # first-call overhead (seconds)
    seconds: float       # wall-clock cost of running this benchmark


#: a measurement backend: (key, repetitions) -> (per-call stats, first)
MeasureFn = Callable[[MicroBenchmarkKey, int], Tuple[Stats, float]]


def resolve_suite(suite: Optional["MicroBenchmarkSuite"],
                  repetitions: Optional[int]) -> "MicroBenchmarkSuite":
    """The one implementation of the suite-vs-repetitions contract.

    A supplied suite owns the measurement protocol, so a conflicting
    ``repetitions`` raises instead of being silently ignored; without a
    suite, a fresh one is built (default 5 repetitions, the card's L2).
    """
    if suite is not None:
        if repetitions is not None and repetitions != suite.repetitions:
            raise ValueError(
                f"repetitions={repetitions} conflicts with the supplied "
                f"suite's repetitions={suite.repetitions}; pass one or "
                f"the other")
        return suite
    return MicroBenchmarkSuite(
        repetitions=5 if repetitions is None else repetitions)


class MicroBenchmarkSuite:
    """Runs each distinct micro-benchmark once and shares the result.

    ``measure_fn`` defaults to the real cache-aware measurement on
    ``device`` (the CUDA card unless ``device="cpu"``); injecting a
    deterministic function of the key (as the equivalence tests do) makes
    deduplicated and per-algorithm predictions bit-comparable.
    ``cache_bytes`` is the capacity the warm/cold classes are decided
    against: the card's L2 when ``None`` (read on first use, so a suite
    that only holds device-kernel measurements never needs it), and
    required on the CPU.  The suite is reusable across predictors and
    specs — keys are self-contained — and keeps running totals:
    :attr:`cost_seconds` (wall-clock spent measuring), :attr:`requests`
    (benchmarks asked for) vs :attr:`n_benchmarks` (distinct ones held).
    """

    def __init__(self, *, repetitions: int = 5,
                 cache_bytes: Optional[int] = None, seed: int = 0,
                 measure_fn: Optional[MeasureFn] = None,
                 device: DeviceLike = None):
        self.repetitions = repetitions
        self._cache_bytes = cache_bytes
        self.device = device
        self.seed = seed
        self.measure_fn: MeasureFn = measure_fn or self._measure
        self.results: Dict[MicroBenchmarkKey, MicroBenchmark] = {}
        self.requests = 0
        self.cost_seconds = 0.0
        self.oracle_cost_seconds = 0.0
        # provenance breakdown of self.results: every key is exactly one
        # of measured-here, loaded-from-a-store, or refreshed-in-place
        self.measured = 0
        self.loaded = 0
        self.refreshed = 0
        #: wall-clock the loaded measurements cost where they were
        #: originally run — the amortized (not free!) part of a warm start
        self.loaded_cost_seconds = 0.0
        self._provenance: Dict[MicroBenchmarkKey, str] = {}
        #: optional size-parametric model registry
        #: (:class:`repro_torch.tc.parametric.ParametricModels`):
        #: consulted by :meth:`benchmark` for keys with no stored
        #: measurement before falling back to a fresh one.  Predictions
        #: are held apart from :attr:`results` (they are NOT
        #: measurements) and counted under :attr:`predicted_parametric`.
        self.parametric = None
        self._predicted: Dict[MicroBenchmarkKey, MicroBenchmark] = {}

    @property
    def cache_bytes(self) -> int:
        """The capacity the cache classes are decided against: the value
        given, else the card's L2 (read once, on first use)."""
        if self._cache_bytes is None:
            self._cache_bytes = l2_cache_bytes(self.device)
        return self._cache_bytes

    # ------------------------------------------------------------- public --
    def key_for(self, alg: ContractionAlgorithm, sizes: Mapping[str, int],
                *, arrival: Optional[Mapping[str, str]] = None,
                ) -> MicroBenchmarkKey:
        """The dedup signature of ``alg`` at ``sizes`` under this suite's
        cache capacity (see :func:`benchmark_key` for ``arrival``)."""
        return benchmark_key(alg, sizes, self.cache_bytes, arrival=arrival)

    def benchmark(self, alg: ContractionAlgorithm,
                  sizes: Mapping[str, int], *,
                  arrival: Optional[Mapping[str, str]] = None,
                  ) -> MicroBenchmark:
        """The (shared) micro-benchmark backing ``alg`` at ``sizes``.

        ``arrival`` forwards known operand arrival classes into the key
        (chain intermediates); identical keys share one measurement.
        An unmeasured key whose size point a fitted size-parametric
        model covers (:attr:`parametric`) is served as a synthetic
        prediction instead of being measured — stored measurements
        always win over predictions.
        """
        self.requests += 1
        key = self.key_for(alg, sizes, arrival=arrival)
        mb = self.results.get(key)
        if mb is not None:
            return mb
        mb = self._predicted.get(key)
        if mb is not None:
            return mb
        if self.parametric is not None:
            mb = self.parametric.predict(key)
            if mb is not None:
                self._predicted[key] = mb
                return mb
        mb = self._run(key)
        self.results[key] = mb
        self.measured += 1
        self._provenance[key] = "measured"
        return mb

    def measure_key(self, key: MicroBenchmarkKey) -> MicroBenchmark:
        """Measure a concrete key directly, with deduplication.

        The refinement sampling path: parametric fitting lowers its
        grid points to keys (:func:`repro_torch.tc.parametric.key_at`) and
        measures them here — bypassing :attr:`parametric` on purpose (a
        model must never train on its own predictions), but sharing
        :attr:`results` so refinement samples are ordinary
        provenance-tracked measurements any later request reuses.
        """
        self.requests += 1
        mb = self.results.get(key)
        if mb is None:
            mb = self._run(key)
            self.results[key] = mb
            self._predicted.pop(key, None)   # a measurement supersedes it
            self.measured += 1
            self._provenance[key] = "measured"
        return mb

    def benchmark_fresh(self, alg: ContractionAlgorithm,
                        sizes: Mapping[str, int], *,
                        arrival: Optional[Mapping[str, str]] = None,
                        ) -> MicroBenchmark:
        """An independent, un-deduplicated measurement (the oracle path).

        Accounted under :attr:`oracle_cost_seconds`, NOT
        :attr:`cost_seconds`: validating against the oracle must not
        inflate the suite's reported prediction cost.
        """
        return self._run(self.key_for(alg, sizes, arrival=arrival),
                         oracle=True)

    def load_measurement(self, mb: MicroBenchmark) -> None:
        """Insert a measurement taken elsewhere (a model-store warm start).

        Counted under :attr:`loaded` (not :attr:`measured`) and its
        original wall-clock under :attr:`loaded_cost_seconds` — so the
        cost-fraction metrics can distinguish warm-start hits from fresh
        measurements instead of silently treating loaded keys as free.
        A key this suite already holds is not overwritten (the fresher
        local measurement wins).
        """
        if mb.key in self.results:
            return
        self.results[mb.key] = mb
        self.loaded += 1
        self.loaded_cost_seconds += mb.seconds
        self._provenance[mb.key] = "loaded"

    def record_measurement(self, key: MicroBenchmarkKey, stats: Stats,
                           first: float, seconds: float) -> MicroBenchmark:
        """Insert a measurement taken by an external protocol (the
        device-resident sweep of :mod:`repro_torch.tc.device`).

        Device kernel keys are timed by a whole-grid sweep rather than
        per-key ``measure_fn`` calls, but they are accounted exactly like
        einsum keys: deduplicated (an existing result wins — the sweep
        dedups before measuring, so a collision means another sweep got
        there first), counted under :attr:`measured`, and their share of
        the sweep's wall-clock added to :attr:`cost_seconds`.
        """
        mb = self.results.get(key)
        if mb is not None:
            return mb
        mb = MicroBenchmark(key=key, stats=stats, first=first,
                            seconds=seconds)
        self.results[key] = mb
        self._predicted.pop(key, None)   # a measurement supersedes it
        self.measured += 1
        self.cost_seconds += seconds
        self._provenance[key] = "measured"
        return mb

    def refresh(self, key: MicroBenchmarkKey) -> MicroBenchmark:
        """Re-measure ``key`` in place (drift repair).

        The new measurement replaces the stored one; the key moves from
        its previous provenance bucket (loaded or measured) into
        :attr:`refreshed`, and the re-measurement's wall-clock lands in
        :attr:`cost_seconds` like any fresh benchmark.
        """
        mb = self._run(key)
        self.results[key] = mb
        self._predicted.pop(key, None)   # a measurement supersedes it
        previous = self._provenance.get(key)
        if previous == "loaded":
            self.loaded -= 1
        elif previous == "measured":
            self.measured -= 1
        if previous != "refreshed":
            self.refreshed += 1
        self._provenance[key] = "refreshed"
        return mb

    def drop_predictions(self, sig) -> int:
        """Invalidate held predictions whose signature matches ``sig``
        (an object with ``equation``/``classes``) — called when a
        signature's parametric model is refitted, so stale predictions
        from the old fit cannot be served again."""
        stale = [k for k in self._predicted
                 if k.equation == sig.equation and k.classes == sig.classes]
        for k in stale:
            del self._predicted[k]
        return len(stale)

    @property
    def predicted_parametric(self) -> int:
        """Distinct keys currently served from parametric predictions —
        the provenance bucket next to measured/loaded/refreshed, held
        OUTSIDE :attr:`results` (predictions are not measurements)."""
        return len(self._predicted)

    @property
    def predictions(self) -> Dict[MicroBenchmarkKey, MicroBenchmark]:
        """The currently-held parametric predictions (a copy — the
        provenance bookkeeping is not for callers to mutate)."""
        return dict(self._predicted)

    @property
    def n_benchmarks(self) -> int:
        """Distinct micro-benchmarks held so far (< requests under dedup;
        includes loaded warm-start keys)."""
        return len(self.results)

    def cost_fraction(self, measured_seconds: float, *,
                      include_loaded: bool = False) -> float:
        """Suite cost as a fraction of a measured contraction runtime.

        By default only wall-clock *this* suite spent measuring counts —
        the marginal cost of the predictions at hand.  With
        ``include_loaded=True`` the original cost of warm-start loaded
        measurements is added back: the amortized total, for honest
        whole-lifecycle accounting.
        """
        cost = self.cost_seconds
        if include_loaded:
            cost += self.loaded_cost_seconds
        return cost / measured_seconds

    def counters(self) -> Dict[str, float]:
        """Snapshot of the suite's running totals.

        Diff two snapshots to see what one phase genuinely added — e.g.
        how many *new* benchmarks (and how much wall-clock) the second
        size point of a sweep cost on top of the first.  The
        ``loaded``/``measured``/``refreshed`` breakdown partitions
        ``n_benchmarks`` by provenance: a warm-started session proves
        zero fresh measurements by ``measured == 0``.
        ``predicted_parametric`` counts keys served from size-parametric
        models instead — held apart from ``n_benchmarks``, since a
        prediction is not a measurement: a sweep over never-measured
        shapes proves it issued zero fresh micro-benchmarks by
        ``measured`` unchanged AND ``predicted_parametric`` grown."""
        return {"requests": self.requests,
                "n_benchmarks": self.n_benchmarks,
                "measured": self.measured,
                "loaded": self.loaded,
                "refreshed": self.refreshed,
                "predicted_parametric": self.predicted_parametric,
                "cost_seconds": self.cost_seconds,
                "loaded_cost_seconds": self.loaded_cost_seconds,
                "oracle_cost_seconds": self.oracle_cost_seconds}

    # ----------------------------------------------------------- internal --
    def _run(self, key: MicroBenchmarkKey,
             oracle: bool = False) -> MicroBenchmark:
        if key.config is not None:
            # guards every per-key path (benchmark/measure_key/refresh)
            # regardless of the injected measure_fn: device keys are only
            # measured by whole-grid sweeps (repro_torch.tc.device), never by
            # the per-key einsum protocol
            raise ValueError(
                f"device kernel key {key.equation}{key.config} cannot be "
                f"measured per-key; device keys are measured by "
                f"repro_torch.tc.device.DeviceSuite sweeps")
        t0 = time.perf_counter()
        stats, first = self.measure_fn(key, self.repetitions)
        seconds = time.perf_counter() - t0
        if oracle:
            self.oracle_cost_seconds += seconds
        else:
            self.cost_seconds += seconds
        return MicroBenchmark(key=key, stats=stats, first=first,
                              seconds=seconds)

    def _measure(self, key: MicroBenchmarkKey,
                 repetitions: int) -> Tuple[Stats, float]:
        """The shared §6.2 protocol, reconstructed purely from the key."""
        if key.config is not None:
            raise ValueError(
                f"device kernel key {key.equation}{key.config} cannot go "
                f"through the §6.2 einsum protocol; device keys are "
                f"measured by repro_torch.tc.device.DeviceSuite sweeps")
        cls_a, cls_b = key.classes
        return run_kernel_benchmark(
            key.equation, key.a_shape, key.b_shape, key.out_shape,
            cold_a=cls_a == COLD, cold_b=cls_b == COLD,
            repetitions=repetitions, cache_bytes=self.cache_bytes,
            device=self.device, seed=self.seed)
