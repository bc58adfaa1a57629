"""Predictor tournaments: quantified accuracy-vs-cost scoreboards.

The counterpart of ``repro.store.tournament``.  Every change to the
prediction stack shifts a trade-off: measurement protocol (repetitions,
cache capacity), store freshness, backend, model form.  The tournament
makes that trade-off a number: it pits named predictor *snapshots* (a
:class:`~repro_torch.store.modelstore.ModelStore` file plus session
config) against each other on **frozen workload suites** (the
reference's literals, unchanged, so scores are comparable across commits
and across the two packages) and scores each snapshot against a freshly
measured oracle session on four axes:

* **rel_err** — mean relative error of predicted medians vs the
  oracle's, matched per candidate: absolute accuracy;
* **top1_rate** — how often the snapshot's fastest-predicted candidate
  is the oracle's: what selection actually gets right;
* **rank_agreement** — mean Kendall-tau between snapshot and oracle
  orderings: rank agreement matters more than absolute error for
  selection (Peise & Bientinesi, arXiv:1409.8602);
* **suite_cost_seconds** — what the snapshot's measurements cost
  (including the amortized cost of loaded keys): accuracy per second.

The oracle and every snapshot's session measure on the card unless
``device="cpu"`` is asked for.  The scoreboard is written as
``TOURNAMENT.json``, stamped with the store ``SCHEMA_VERSION``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from .._device import DeviceLike, resolve_device
from ..tc.session import PredictorSession
from .modelstore import SCHEMA_VERSION, ModelStore


@dataclass(frozen=True)
class Workload:
    """One frozen ranking problem every snapshot must answer.

    ``kind`` selects the session entry point: ``"contraction"`` ranks
    candidate algorithms of one contraction
    (:meth:`~repro_torch.tc.session.PredictorSession.
    rank_contraction_algorithms`),
    ``"chain"`` ranks the einsum paths of a multi-contraction chain
    (:meth:`~repro_torch.tc.session.PredictorSession.rank_einsum_paths`).
    ``options`` forwards to the entry point (``kernels=``,
    ``max_loop_perms=``, ``memory_limit_bytes=``, ``include_batched=``).
    """

    name: str
    kind: str                                  # "contraction" | "chain"
    expr: str
    sizes: Tuple[Tuple[str, int], ...]
    options: Tuple[Tuple[str, object], ...] = ()

    def rank(self, session: PredictorSession) -> List[Tuple[str, float]]:
        """(candidate name, predicted median seconds), fastest first."""
        sizes = dict(self.sizes)
        opts = dict(self.options)
        if self.kind == "contraction":
            ranked = session.rank_contraction_algorithms(
                self.expr, sizes, **opts)
        elif self.kind == "chain":
            ranked = session.rank_einsum_paths(self.expr, sizes, **opts)
        else:
            raise ValueError(f"unknown workload kind {self.kind!r}")
        return [(r.name, r.runtime.med) for r in ranked]


def workload(name: str, kind: str, expr: str, sizes: Mapping[str, int],
             **options) -> Workload:
    """Hashable-workload convenience constructor (dicts to sorted tuples)."""
    return Workload(name=name, kind=kind, expr=expr,
                    sizes=tuple(sorted(sizes.items())),
                    options=tuple(sorted(options.items())))


def frozen_workloads(*, smoke: bool = False) -> List[Workload]:
    """The cross-commit workload suite.

    FROZEN literals, deliberately — scores are only comparable across
    commits if the problems never move.  They are the reference's
    (``repro.store.tournament.frozen_workloads``), which mirror the
    smoke specs of the reference benches ``bench_contractions`` /
    ``bench_einsum_paths`` / ``bench_serving``.  ``smoke=True`` keeps
    only the cheap contraction workloads (the chain workload enumerates
    einsum paths and is the expensive one).
    """
    loads = [
        # bench_contractions.SMOKE_SPEC / SMOKE_SIZES
        workload("contraction_smoke", "contraction",
                 "bij,bjk->bik", dict(b=8, i=64, j=64, k=64)),
        # one serve-step projection at bench_serving.SMOKE_ARCH
        # (d_model=64, d_ff=128) across SLOTS=3 decode slots
        workload("serving_step_proj", "contraction", "bij,jk->bik",
                 dict(b=3, i=1, j=64, k=128)),
    ]
    if not smoke:
        # bench_einsum_paths smoke constants
        loads.append(workload(
            "einsum_path_smoke", "chain", "aij,ijb,bkl,klc->ac",
            dict(a=4, b=4, c=4, i=2048, j=2048, k=2048, l=2048),
            kernels=("gemm", "gemv", "gevm"), max_loop_perms=2,
            memory_limit_bytes=96 * 2 ** 20))
    return loads


def kendall_tau(order_a: Sequence[str], order_b: Sequence[str]) -> float:
    """Kendall rank correlation between two orderings of one candidate
    set: (concordant - discordant) / total pairs, in [-1, 1].

    Candidates missing from either ordering are ignored (a snapshot that
    cannot rank a candidate simply is not scored on it); fewer than two
    shared candidates yields 1.0 (nothing to disagree about).
    """
    common = [n for n in order_a if n in set(order_b)]
    if len(common) < 2:
        return 1.0
    pos_b = {n: i for i, n in enumerate(order_b)}
    concordant = discordant = 0
    for i in range(len(common)):
        for j in range(i + 1, len(common)):
            # common is in order_a's order, so pair (i, j) is ascending
            # in a; it is concordant iff also ascending in b
            if pos_b[common[i]] < pos_b[common[j]]:
                concordant += 1
            else:
                discordant += 1
    total = concordant + discordant
    return (concordant - discordant) / total


@dataclass
class Snapshot:
    """A named contender: a store (file or object) + session config."""

    name: str
    store: Union[ModelStore, str, Path]
    backend: str = "numpy"

    def open(self, *, allow_mismatch: bool = False, fingerprint=None,
             device: DeviceLike = None) -> ModelStore:
        """The snapshot's store, loaded for ``device`` (the CUDA card
        unless ``device="cpu"``) when it is a path."""
        if isinstance(self.store, ModelStore):
            return self.store
        return ModelStore.load(self.store, allow_mismatch=allow_mismatch,
                               fingerprint=fingerprint, device=device)


@dataclass
class SnapshotScore:
    """One snapshot's scoreboard row."""

    name: str
    rel_err: float                 # mean relative error vs oracle medians
    top1_rate: float               # fraction of workloads with agreeing #1
    rank_agreement: float          # mean Kendall-tau vs oracle orderings
    suite_cost_seconds: float      # measurement cost incl. amortized loads
    new_benchmarks: int            # fresh measurements (0 = fully warm)
    per_workload: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, object]:
        return {"name": self.name, "rel_err": self.rel_err,
                "top1_rate": self.top1_rate,
                "rank_agreement": self.rank_agreement,
                "suite_cost_seconds": self.suite_cost_seconds,
                "new_benchmarks": self.new_benchmarks,
                "per_workload": self.per_workload}


@dataclass
class TournamentResult:
    """The scoreboard: snapshots best-first, plus the oracle's cost."""

    scores: List[SnapshotScore]
    workloads: List[str]
    oracle_cost_seconds: float

    @property
    def winner(self) -> SnapshotScore:
        return self.scores[0]

    def to_payload(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "workloads": list(self.workloads),
            "oracle_cost_seconds": self.oracle_cost_seconds,
            "scoreboard": [s.as_dict() for s in self.scores],
        }

    def save(self, path: Union[str, Path]) -> None:
        with open(path, "w") as f:
            json.dump(self.to_payload(), f, indent=1)

    def describe(self) -> str:
        lines = [f"tournament over {len(self.workloads)} workload(s):"]
        for rank, s in enumerate(self.scores, 1):
            lines.append(
                f"  {rank}. {s.name}: top1={s.top1_rate:.2f} "
                f"tau={s.rank_agreement:+.2f} rel_err={s.rel_err:.3f} "
                f"cost={s.suite_cost_seconds:.2f}s "
                f"new={s.new_benchmarks}")
        return "\n".join(lines)


def score_snapshot(name: str, session: PredictorSession,
                   workloads: Sequence[Workload],
                   oracle_rankings: Mapping[str, List[Tuple[str, float]]],
                   ) -> SnapshotScore:
    """Rank every workload through ``session`` and score vs the oracle."""
    before = session.counters()
    per_workload: Dict[str, Dict[str, float]] = {}
    errs: List[float] = []
    taus: List[float] = []
    top1 = 0
    for load in workloads:
        ranked = load.rank(session)
        oracle = oracle_rankings[load.name]
        oracle_med = dict(oracle)
        pair_errs = [abs(med - oracle_med[n]) / oracle_med[n]
                     for n, med in ranked
                     if n in oracle_med and oracle_med[n] > 0]
        err = sum(pair_errs) / len(pair_errs) if pair_errs else 0.0
        tau = kendall_tau([n for n, _ in ranked], [n for n, _ in oracle])
        agree = bool(ranked and oracle and ranked[0][0] == oracle[0][0])
        top1 += agree
        errs.append(err)
        taus.append(tau)
        per_workload[load.name] = {"rel_err": err, "tau": tau,
                                   "top1": float(agree)}
    after = session.counters()
    suite = session.suite
    return SnapshotScore(
        name=name,
        rel_err=sum(errs) / len(errs) if errs else 0.0,
        top1_rate=top1 / len(workloads) if workloads else 1.0,
        rank_agreement=sum(taus) / len(taus) if taus else 1.0,
        suite_cost_seconds=suite.cost_seconds + suite.loaded_cost_seconds,
        new_benchmarks=int(after["measured"] - before["measured"]),
        per_workload=per_workload)


def run_tournament(snapshots: Sequence[Snapshot],
                   workloads: Optional[Sequence[Workload]] = None, *,
                   oracle_session: Optional[PredictorSession] = None,
                   allow_mismatch: bool = False,
                   fingerprint=None,
                   measure_fn=None,
                   smoke: bool = False,
                   device: DeviceLike = None) -> TournamentResult:
    """Score every snapshot against a freshly measured oracle.

    ``oracle_session`` supplies the ground-truth measurements (tests
    inject one with a deterministic ``measure_fn``; by default a fresh
    in-memory session measures for real).  The oracle and every
    snapshot's session run on ``device``, the CUDA card unless
    ``device="cpu"``.  Each snapshot gets its own
    warm-started session over its store, so its ``new_benchmarks``
    exposes how many benchmarks the store could *not* answer —
    ``measure_fn`` backs exactly those gap measurements (tests point it
    at the oracle's backend; by default the real §6.2 protocol runs).
    The scoreboard sorts by (top-1 agreement, rank agreement, -relative
    error, -cost) — selection quality first, per arXiv:1409.8602.
    """
    if len(snapshots) < 2:
        raise ValueError("a tournament needs at least 2 snapshots "
                         f"(got {len(snapshots)})")
    dev = resolve_device(device)
    loads = list(workloads) if workloads is not None else \
        frozen_workloads(smoke=smoke)
    oracle = oracle_session or PredictorSession(device=dev)
    oracle_before = oracle.counters()["cost_seconds"]
    oracle_rankings = {load.name: load.rank(oracle) for load in loads}
    oracle_cost = oracle.counters()["cost_seconds"] - oracle_before

    scores = []
    for snap in snapshots:
        store = snap.open(allow_mismatch=allow_mismatch,
                          fingerprint=fingerprint, device=dev)
        session = PredictorSession(
            backend=snap.backend, device=dev,
            suite=store.build_suite(measure_fn=measure_fn, device=dev))
        scores.append(score_snapshot(snap.name, session, loads,
                                     oracle_rankings))
    scores.sort(key=lambda s: (-s.top1_rate, -s.rank_agreement,
                               s.rel_err, s.suite_cost_seconds))
    return TournamentResult(scores=scores,
                            workloads=[load.name for load in loads],
                            oracle_cost_seconds=oracle_cost)
