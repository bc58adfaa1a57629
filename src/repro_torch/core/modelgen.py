"""End-to-end performance-model generation (paper §3.2/§3.3).

A :class:`KernelBenchmark` describes everything the generator needs for one
kernel: its discrete cases, the size-argument domain per case, the maximal
monomial exponents implied by the kernel's asymptotic FLOP count, and a
factory that builds a timed callable for a concrete (case, sizes) invocation.
``generate_model`` runs the adaptive refinement per case and assembles the
:class:`~repro_torch.core.model.PerformanceModel`; ``generate_model_set`` builds the
per-setup database.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from .grids import Domain, Point
from .model import Case, ModelSet, PerformanceModel, Piece
from .refinement import GeneratorConfig, refine, stats_sample_fn


@dataclass
class KernelBenchmark:
    """Specification of one kernel for the model generator."""

    name: str
    #: discrete cases (flag/layout combinations) to model
    cases: Sequence[Case]
    #: size-argument domain per case (falls back to ``domain`` if absent)
    domain: Domain = None
    case_domains: Dict[Case, Domain] = field(default_factory=dict)
    #: maximal monomial exponents per case, e.g. trsm side=L -> [(2, 1)]
    cost_exponents: Callable[[Case], Sequence[Tuple[int, ...]]] = None
    #: (case, sizes) -> zero-arg callable running ONE synchronous invocation
    make_call: Callable[[Case, Point], Callable[[], None]] = None

    def domain_for(self, case: Case) -> Domain:
        return self.case_domains.get(tuple(case), self.domain)


@dataclass
class GenerationReport:
    """What one model generation cost: measured points, pieces per case
    and wall-clock seconds — the §3.3 accuracy-vs-cost bookkeeping."""

    kernel: str
    seconds: float
    measured_points: int
    pieces_per_case: Dict[Case, int]


def generate_model(bench: KernelBenchmark,
                   config: GeneratorConfig = GeneratorConfig(),
                   setup: str = "default",
                   ) -> Tuple[PerformanceModel, GenerationReport]:
    """Generate one kernel's performance model by adaptive refinement (§3.3).

    For every case of ``bench``, measures the kernel over adaptively
    refined sub-domains (:func:`~repro_torch.core.refinement.refine` under
    ``config``) and fits piecewise polynomials.
    Returns the :class:`~repro_torch.core.model.PerformanceModel` plus a
    :class:`GenerationReport` with the measured-point count, pieces per
    case and wall-clock seconds.
    """
    model = PerformanceModel(kernel=bench.name, setup=setup)
    t0 = time.perf_counter()
    total_points = 0
    pieces_per_case: Dict[Case, int] = {}
    for case in bench.cases:
        case = tuple(case)
        sample_fn = stats_sample_fn(
            lambda p, _case=case: bench.make_call(_case, p),
            repetitions=config.repetitions,
        )
        counted: List[int] = [0]

        def counting_sample(points, _fn=sample_fn, _c=counted):
            _c[0] += len(points)
            return _fn(points)

        pieces = refine(bench.domain_for(case), counting_sample,
                        bench.cost_exponents(case), config)
        for piece in pieces:
            model.add_piece(case, piece)
        pieces_per_case[case] = len(pieces)
        total_points += counted[0]
    report = GenerationReport(
        kernel=bench.name,
        seconds=time.perf_counter() - t0,
        measured_points=total_points,
        pieces_per_case=pieces_per_case,
    )
    return model, report


def generate_model_set(benches: Sequence[KernelBenchmark],
                       config: GeneratorConfig = GeneratorConfig(),
                       setup: str = "default",
                       verbose: bool = False,
                       ) -> Tuple[ModelSet, List[GenerationReport]]:
    """Run :func:`generate_model` for every benchmark in ``benches``.

    Returns the combined :class:`~repro_torch.core.model.ModelSet` (one model
    per kernel) and the per-kernel generation reports, optionally
    printing a progress line per kernel when ``verbose``.
    """
    ms = ModelSet()
    reports = []
    for bench in benches:
        model, report = generate_model(bench, config, setup)
        ms.add(model)
        reports.append(report)
        if verbose:
            print(f"[modelgen] {bench.name}: {report.measured_points} points, "
                  f"{sum(report.pieces_per_case.values())} pieces, "
                  f"{report.seconds:.1f}s")
    return ms, reports
