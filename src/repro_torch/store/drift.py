"""Drift detection: is a stored platform model still this platform?

The counterpart of ``repro.store.drift``, with the same policy.  A
:class:`~repro_torch.store.modelstore.ModelStore` pins measurements to a
:class:`~repro_torch.store.fingerprint.PlatformFingerprint`, but
fingerprints only catch *discrete* platform changes (new card, new
driver, new torch, new dtype).  Clocks under a power limit, thermal
state, host load and library micro-updates shift kernel timings without
touching any fingerprint field.  The :class:`DriftProbe` catches that
continuous kind of staleness: re-measure a small **deterministic** subset
of the stored keys, compare each fresh median against the stored one,
and report the per-key drift ratio.  Determinism matters — two runs on
the same store probe the same keys, so drift readings are comparable
across runs and the probe's cost is a fixed, budgetable quantity rather
than a sample of luck.

Policy: a key is *stale* when its ratio
``probed_median / stored_median`` falls outside ``[1/threshold,
threshold]`` — both speedups and slowdowns are drift; a model that has
silently become pessimistic mis-ranks just as surely as one that became
optimistic.  ``PredictorSession.check_drift`` warns on any stale key and
can repair in place via :meth:`DriftProbe.refresh`, which re-measures
exactly the stale keys through the suite's ``refresh`` (counted under
the suite's ``refreshed`` counter, never inflating ``loaded``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..tc.suite import (MeasureFn, MicroBenchmark, MicroBenchmarkKey,
                        MicroBenchmarkSuite)
from .modelstore import sort_key


@dataclass(frozen=True)
class DriftReading:
    """One probed key: stored median vs freshly measured median."""

    key: MicroBenchmarkKey
    stored_med: float       # median the store remembers (seconds)
    probed_med: float       # median measured just now (seconds)
    probe_seconds: float    # wall-clock the probe measurement cost

    @property
    def ratio(self) -> float:
        """``probed / stored`` — 1.0 means the platform has not moved."""
        if self.stored_med == 0.0:
            return float("inf") if self.probed_med else 1.0
        return self.probed_med / self.stored_med

    def stale(self, threshold: float) -> bool:
        """Outside ``[1/threshold, threshold]``: drift in either
        direction invalidates the stored measurement."""
        r = self.ratio
        return not (1.0 / threshold <= r <= threshold)


class DriftProbe:
    """Re-measures a deterministic subset of a suite's stored keys.

    ``max_keys`` keys are chosen by evenly striding the canonically
    sorted key list (:func:`~repro_torch.store.modelstore.sort_key`), so
    the subset spans small and large signatures instead of clustering at
    one end, and is identical across runs on the same store.  ``measure_fn``
    overrides the probe's measurement backend (tests inject a distorted
    one); by default the suite's own backend is used, so probe and
    stored measurements go through the same §6.2 protocol.

    The probe does **not** touch the suite's results or counters — it
    answers "has the platform moved?" without mutating the model.
    Repair is explicit: :meth:`refresh` re-measures the stale keys
    through ``suite.refresh``, replacing them in place.
    """

    def __init__(self, suite: MicroBenchmarkSuite, *, max_keys: int = 8,
                 threshold: float = 1.5,
                 measure_fn: Optional[MeasureFn] = None):
        if threshold <= 1.0:
            raise ValueError(f"threshold must exceed 1.0 (got {threshold}):"
                             f" it bounds the ratio band [1/t, t]")
        self.suite = suite
        self.max_keys = max_keys
        self.threshold = threshold
        self.measure_fn: MeasureFn = measure_fn or suite.measure_fn
        self.cost_seconds = 0.0
        self._readings: Optional[List[DriftReading]] = None

    def keys(self) -> List[MicroBenchmarkKey]:
        """The deterministic probe subset: evenly strided canonical order.

        Device kernel keys (``config`` facet set) are excluded: they are
        measured by :class:`repro_torch.tc.device.DeviceSuite` sweeps, not
        the §6.2 einsum protocol behind ``measure_fn``, so probing one
        here would compare incomparable measurements (and
        ``suite.refresh`` would refuse it)."""
        stored = sorted((k for k in self.suite.results
                         if k.config is None), key=sort_key)
        if len(stored) <= self.max_keys:
            return stored
        stride = len(stored) / self.max_keys
        return [stored[int(i * stride)] for i in range(self.max_keys)]

    def probe(self) -> List[DriftReading]:
        """Measure the probe subset once; cached on the probe instance."""
        if self._readings is not None:
            return self._readings
        readings = []
        for key in self.keys():
            t0 = time.perf_counter()
            stats, _first = self.measure_fn(key, self.suite.repetitions)
            seconds = time.perf_counter() - t0
            self.cost_seconds += seconds
            readings.append(DriftReading(
                key=key, stored_med=self.suite.results[key].stats.med,
                probed_med=stats.med, probe_seconds=seconds))
        self._readings = readings
        return readings

    def stale(self) -> List[DriftReading]:
        """The probed keys whose drift exceeds the threshold."""
        return [r for r in self.probe() if r.stale(self.threshold)]

    def max_ratio(self) -> float:
        """The worst drift seen, folded to >= 1 (1.0 = no drift)."""
        ratios = [max(r.ratio, 1.0 / r.ratio) if r.ratio > 0 else
                  float("inf") for r in self.probe()]
        return max(ratios, default=1.0)

    def refresh(self) -> List[MicroBenchmark]:
        """Re-measure every stale key in place through ``suite.refresh``.

        The suite's ``measure_fn`` is temporarily pointed at the probe's
        (they differ only when a test injected one), so the repaired
        measurement reflects the platform the probe actually saw.
        Returns the replacement measurements; the probe's cached
        readings are dropped so a subsequent :meth:`probe` re-examines
        the repaired state.
        """
        stale = self.stale()
        replaced = []
        original = self.suite.measure_fn
        self.suite.measure_fn = self.measure_fn
        try:
            for reading in stale:
                replaced.append(self.suite.refresh(reading.key))
        finally:
            self.suite.measure_fn = original
        self._readings = None
        return replaced

    def report(self) -> Dict[str, float]:
        """Summary counters for metrics emission."""
        readings = self.probe()
        return {"probed": float(len(readings)),
                "stale": float(len(self.stale())),
                "max_ratio": self.max_ratio(),
                "probe_cost_seconds": self.cost_seconds}
