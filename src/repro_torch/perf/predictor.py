"""Configuration ranking on the batched prediction engine — the paper's
algorithm selection (§4.5) applied to trace-producing candidates.

The counterpart of the batched half of ``repro.perf.predictor``: each
candidate is a *tracer* that yields its kernel-call sequence, and all of
them are predicted in one batch through
:class:`~repro_torch.core.predict.PredictionEngine` — never executed,
never compiled.  The reference's other half, ``rank_configs`` over
``ConfigCandidate`` builders, ranks compiled dry-runs by their roofline
bound terms (``RooflineTerms``); it waits for the HLO half of
``perf.roofline``, which the port does not have yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Mapping, Optional

from ..core.model import ModelSet
from ..core.predict import KernelCall, PredictionEngine, resolve_engine
from ..core.sampler import Stats


@dataclass(frozen=True)
class RankedTracedConfig:
    """A candidate ranked by the batched kernel-model prediction engine."""

    name: str
    runtime: Stats
    note: str = ""
    stat: str = "med"    # the statistic the ranking sorted by

    @property
    def predicted_s(self) -> float:
        return getattr(self.runtime, self.stat)


def rank_traced_configs(tracers: Mapping[str, Callable[..., List[KernelCall]]],
                        models: ModelSet,
                        *tracer_args,
                        stat: str = "med",
                        backend: Optional[str] = None,
                        engine: Optional[PredictionEngine] = None,
                        ) -> List[RankedTracedConfig]:
    """Rank trace-producing candidates on the batched prediction engine.

    Each candidate's kernel-call trace (``tracers[name](*tracer_args)``)
    is batched through one :class:`PredictionEngine`, so sweeping
    hundreds of configurations costs a handful of array ops.
    ``backend="torch"`` evaluates the float64 program on the CUDA card;
    ``engine=`` supplies a built engine instead (a torch engine on
    ``device="cpu"``, for instance), and must not contradict ``backend``.
    """
    names = list(tracers)
    engine = resolve_engine(models, backend, engine)
    runtimes = engine.predict_stats(
        [tracers[name](*tracer_args) for name in names])
    ranked = [RankedTracedConfig(name=name, runtime=rt, stat=stat)
              for name, rt in zip(names, runtimes)]
    ranked.sort(key=lambda r: r.predicted_s)
    return ranked
