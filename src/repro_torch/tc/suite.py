"""Deduplicated micro-benchmark store with cost accounting (§6.2).

The part of ``repro.tc.suite`` that the device kernel family
(:mod:`repro_torch.tc.device`) stands on: a :class:`MicroBenchmarkKey`
identifies one distinct measurement, each distinct key is measured once
and shared, and the suite accounts its own wall-clock cost so a
prediction can be stated as a fraction of a measured runtime.  The
einsum protocol of the reference (cache-aware contraction benchmarks) is
a later part of the port; here measurements enter through
:meth:`MicroBenchmarkSuite.record_measurement` (a device sweep) or
:meth:`MicroBenchmarkSuite.load_measurement` (a store warm start).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..core.sampler import Stats

#: cache capacity (bytes) the reference's warm/cold operand classes use;
#: kept so a suite's constructor matches the reference's
CACHE_BYTES = 32 * 2 ** 20
#: bytes per operand element of the measured kernels (float32)
_ITEM = 4


@dataclass(frozen=True)
class MicroBenchmarkKey:
    """Identity of one distinct micro-benchmark.

    Two requests with equal keys perform indistinguishable kernel calls
    under indistinguishable conditions, so one measurement serves both —
    the suite's deduplication signature.  Device kernel keys set
    ``equation`` to the kernel's registry name, ``classes`` to its
    shared-memory class and ``config`` to its tile config
    (:mod:`repro_torch.tc.device`).
    """

    equation: str
    a_shape: Tuple[int, ...]
    b_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    classes: Tuple[str, str]
    config: Optional[Tuple[int, ...]] = None

    @property
    def call_bytes(self) -> int:
        """Bytes one kernel call touches across all three operands."""
        return _ITEM * (math.prod(self.a_shape) + math.prod(self.b_shape) +
                        math.prod(self.out_shape))


@dataclass(frozen=True)
class MicroBenchmark:
    """One measured micro-benchmark: per-call stats + first-call overhead."""

    key: MicroBenchmarkKey
    stats: Stats         # per-call runtime statistics (seconds)
    first: float         # first-call overhead (seconds)
    seconds: float       # wall-clock cost of running this benchmark


class MicroBenchmarkSuite:
    """Holds each distinct micro-benchmark once and accounts its cost.

    Running totals: :attr:`cost_seconds` (wall-clock spent measuring
    here), and the provenance partition of :attr:`results` into
    :attr:`measured` and :attr:`loaded` keys (a warm start proves zero
    fresh measurements by ``measured == 0``).
    """

    def __init__(self, *, repetitions: int = 5,
                 cache_bytes: int = CACHE_BYTES, seed: int = 0):
        self.repetitions = repetitions
        self.cache_bytes = cache_bytes
        self.seed = seed
        self.results: Dict[MicroBenchmarkKey, MicroBenchmark] = {}
        self.cost_seconds = 0.0
        self.measured = 0
        self.loaded = 0
        #: wall-clock the loaded measurements cost where they were
        #: originally run — the amortized (not free!) part of a warm start
        self.loaded_cost_seconds = 0.0

    def load_measurement(self, mb: MicroBenchmark) -> None:
        """Insert a measurement taken elsewhere (a warm start), counted
        under :attr:`loaded`; a key this suite already holds is kept."""
        if mb.key in self.results:
            return
        self.results[mb.key] = mb
        self.loaded += 1
        self.loaded_cost_seconds += mb.seconds

    def record_measurement(self, key: MicroBenchmarkKey, stats: Stats,
                           first: float, seconds: float) -> MicroBenchmark:
        """Insert a measurement taken by an external protocol (the
        device sweep of :mod:`repro_torch.tc.device`): deduplicated (an
        existing result wins), counted under :attr:`measured`, and its
        share of the sweep's wall-clock added to :attr:`cost_seconds`."""
        mb = self.results.get(key)
        if mb is not None:
            return mb
        mb = MicroBenchmark(key=key, stats=stats, first=first,
                            seconds=seconds)
        self.results[key] = mb
        self.measured += 1
        self.cost_seconds += seconds
        return mb

    @property
    def n_benchmarks(self) -> int:
        """Distinct micro-benchmarks held (measured and loaded)."""
        return len(self.results)

    def cost_fraction(self, measured_seconds: float, *,
                      include_loaded: bool = False) -> float:
        """Suite cost as a fraction of a measured runtime; with
        ``include_loaded`` the original cost of loaded measurements is
        added back (the amortized whole-lifecycle total)."""
        cost = self.cost_seconds
        if include_loaded:
            cost += self.loaded_cost_seconds
        return cost / measured_seconds

    def counters(self) -> Dict[str, float]:
        """Snapshot of the suite's running totals (diff two to see what
        one phase added)."""
        return {"n_benchmarks": self.n_benchmarks,
                "measured": self.measured,
                "loaded": self.loaded,
                "cost_seconds": self.cost_seconds,
                "loaded_cost_seconds": self.loaded_cost_seconds}
