"""Cache-aware kernel timings (paper Ch. 5 / §2.1.4).

The paper measures each kernel under controlled *cache preconditions*:

* **in-cache** ("warm"): repeated invocations on the same operands — the
  steady state inside a blocked algorithm with high temporal locality;
* **out-of-cache** ("cold"): every invocation uses operands at a fresh
  memory location, so each call pays the full main-memory transfer.

Ch. 5's finding — warm/cold deltas are large for bandwidth-bound kernels
and the *mixture* inside an algorithm is too complex to model
platform-independently — is reproduced here: ``cache_overhead`` quantifies
the cold-call penalty per kernel, ``combine_estimates`` implements the
paper's §5.1.3 convex mixing of in/out-of-cache estimates for a blocked
algorithm, with the mixing weight alpha fitted on ONE algorithm execution
(the paper's calibration) — the honest scope of what Ch. 5 achieves.

On the card a timed call must end when the device finishes it:
:func:`measure_cache_effects` synchronises ``device`` after every call it
times, so the host clock of :mod:`repro_torch.core.sampler` brackets the
device's work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from .._device import DeviceLike, resolve_device, synchronize
from .sampler import Stats, measure_calls


@dataclass(frozen=True)
class CacheTimings:
    warm: Stats
    cold: Stats

    @property
    def overhead(self) -> float:
        """Cold-call penalty in seconds (paper Tab 2.2's 'overhead')."""
        return self.cold.med - self.warm.med

    @property
    def overhead_rel(self) -> float:
        return self.overhead / self.warm.med if self.warm.med else 0.0


def measure_cache_effects(make_call_at: Callable[[int], Callable[[], None]],
                          repetitions: int = 10,
                          n_buffers: int = 8, *,
                          device: DeviceLike = None) -> CacheTimings:
    """Measure one kernel warm vs cold on ``device``.

    ``make_call_at(i)`` builds a call whose operands live in buffer set
    ``i``; warm timing reuses set 0 (``warm_pairs``), cold timing cycles
    through ``n_buffers`` distinct sets so operands are evicted between
    repetitions (the paper's "different memory location per repetition").
    Every timed call ends with a synchronisation of ``device`` (the CUDA
    card unless ``device="cpu"``).
    """
    dev = resolve_device(device)

    def synced(call):
        def run():
            call()
            synchronize(dev)
        return run

    warm = measure_calls({"w": synced(make_call_at(0))},
                         repetitions=repetitions, warm_pairs=True)["w"]
    calls = [synced(make_call_at(i)) for i in range(n_buffers)]
    counter = [0]

    def cold_call():
        i = counter[0]
        counter[0] += 1
        calls[i % n_buffers]()

    cold = measure_calls({"c": cold_call}, repetitions=repetitions,
                         warm_pairs=False)["c"]
    return CacheTimings(warm=warm, cold=cold)


def combine_estimates(warm_s: float, cold_s: float, alpha: float) -> float:
    """Paper §5.1.3: t ≈ alpha * t_cold + (1 - alpha) * t_warm."""
    return alpha * cold_s + (1.0 - alpha) * warm_s


def calibrate_alpha(pred_warm: float, pred_cold: float,
                    measured: float) -> float:
    """Fit the mixing weight from one measured algorithm execution."""
    denom = pred_cold - pred_warm
    if abs(denom) < 1e-18:
        return 0.0
    return float(np.clip((measured - pred_warm) / denom, 0.0, 1.0))
