"""Configuration ranking — the paper's algorithm selection (§4.5)
applied at configuration scale.  The counterpart of
``repro.perf.predictor``.

Two halves, as in the reference.  :func:`rank_configs` sorts candidates by
the bound of their roofline terms (:class:`~repro_torch.perf.roofline.
RooflineTerms`, on a card's rates), never executing one; here a
candidate's ``build()`` returns its terms, since the reference's
``extract`` from a compiled XLA executable has no counterpart yet.
:func:`rank_traced_configs` ranks *tracers* that yield kernel-call
sequences, all predicted in one batch through
:class:`~repro_torch.core.predict.PredictionEngine` — never executed,
never compiled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Mapping, Optional

from ..core.model import ModelSet
from ..core.predict import KernelCall, PredictionEngine, resolve_engine
from ..core.sampler import Stats
from .roofline import RooflineTerms


@dataclass(frozen=True)
class ConfigCandidate:
    """One configuration: a name and a builder returning its
    :class:`RooflineTerms` (or what ``extract`` turns into them)."""

    name: str
    build: Callable[[], object]
    note: str = ""


@dataclass
class RankedConfig:
    name: str
    terms: RooflineTerms
    note: str = ""

    @property
    def predicted_s(self) -> float:
        return self.terms.bound_s


def rank_configs(candidates: List[ConfigCandidate],
                 extract: Optional[Callable[[object], RooflineTerms]] = None,
                 ) -> List[RankedConfig]:
    """Build every candidate and sort by predicted step time (the bound
    of its roofline terms).  A build that returns no
    :class:`RooflineTerms` goes through ``extract``; without one it
    raises ``TypeError``."""
    ranked = []
    for cand in candidates:
        built = cand.build()
        if isinstance(built, RooflineTerms):
            terms = built
        elif extract is not None:
            terms = extract(built)
        else:
            raise TypeError(f"candidate {cand.name!r} built "
                            f"{type(built).__name__}, not RooflineTerms, "
                            f"and no extract was given")
        ranked.append(RankedConfig(cand.name, terms, cand.note))
    ranked.sort(key=lambda r: r.predicted_s)
    return ranked


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
