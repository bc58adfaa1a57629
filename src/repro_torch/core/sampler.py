"""ELAPS-style measurement harness (paper Ch. 2), adapted to PyTorch.

The paper's SAMPLER times BLAS calls in CPU cycles; here the measured unit is
a zero-argument callable that executes one kernel invocation and **ends in a
host synchronisation** — in the port, the blocking device-to-host copy of the
result (``tensor.cpu()``).  CUDA launches return before the device finishes,
so :func:`_time_once`'s host clock measures the call only because the call
itself waits for the device; a timed callable that does not end in a sync
measures enqueue time.  The harness reproduces the paper's methodology for
stable timings:

* **initialization overhead** (§2.1.1): every callable is invoked once,
  untimed, before measurement (this also loads the CUDA libraries and kernels);
* **fluctuations / performance levels** (§2.1.2): repetitions of all calls are
  *shuffled* across the whole experiment rather than batched per call;
* **cache preconditions** (§2.1.4, §3.2.3): in ``warm_pairs`` mode each
  repetition executes the call twice back-to-back and only the second (warm)
  execution is recorded;
* **summary statistics** (§2.1.2.1): min / median / max / mean / std are kept,
  never a single sample.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Iterable, List, Mapping

#: the five summary statistics every measurement and prediction carries,
#: in the column order of all batched (N, 5) statistics arrays
STATS = ("min", "med", "max", "mean", "std")


@dataclass(frozen=True)
class Stats:
    """Summary statistics of repeated runtime measurements (seconds)."""

    min: float
    med: float
    max: float
    mean: float
    std: float

    def as_dict(self) -> Dict[str, float]:
        return {"min": self.min, "med": self.med, "max": self.max,
                "mean": self.mean, "std": self.std}

    @staticmethod
    def from_samples(samples: Iterable[float]) -> "Stats":
        xs = sorted(samples)
        n = len(xs)
        if n == 0:
            raise ValueError("no samples")
        mean = sum(xs) / n
        var = sum((x - mean) ** 2 for x in xs) / n
        med = xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
        return Stats(min=xs[0], med=med, max=xs[-1], mean=mean,
                     std=var ** 0.5)


def _time_once(call: Callable[[], None]) -> float:
    t0 = time.perf_counter()
    call()
    return time.perf_counter() - t0


def measure_calls(calls: Mapping[Hashable, Callable[[], None]],
                  repetitions: int = 10,
                  *,
                  shuffle: bool = True,
                  warm_pairs: bool = True,
                  warmup: bool = True,
                  seed: int = 0) -> Dict[Hashable, Stats]:
    """Measure a set of calls with shuffled repetitions.

    ``calls`` maps an arbitrary key (e.g. a sampling point) to a callable
    executing one kernel invocation synchronously.
    """
    keys = list(calls.keys())
    if warmup:
        for k in keys:
            calls[k]()  # compile + library init, untimed
    schedule: List[Hashable] = [k for k in keys for _ in range(repetitions)]
    if shuffle:
        random.Random(seed).shuffle(schedule)
    samples: Dict[Hashable, List[float]] = {k: [] for k in keys}
    for k in schedule:
        call = calls[k]
        if warm_pairs:
            call()  # establish warm cache precondition, untimed
        samples[k].append(_time_once(call))
    return {k: Stats.from_samples(v) for k, v in samples.items()}


def measure_single(call: Callable[[], None], repetitions: int = 10,
                   **kw) -> Stats:
    """Time one nullary ``call`` ``repetitions`` times and summarize.

    Convenience wrapper over :func:`measure_calls` for a single call;
    keyword arguments (``warm_pairs``, ``warmup``, ...) pass through.
    Returns the per-call runtime :class:`Stats` in seconds.
    """
    return measure_calls({"_": call}, repetitions, **kw)["_"]
