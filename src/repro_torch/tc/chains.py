"""Einsum-path prediction: compose contraction predictors into chains.

The dissertation's Ch. 6 predicts a *single* BLAS-based contraction from
cache-aware micro-benchmarks.  Real tensor workloads are chains: an
N-operand einsum is evaluated as a sequence of pairwise contractions (a
*contraction path*, as in ``np.einsum_path``), and each pairwise step's
operands arrive warm or cold depending on what the previous step just
wrote (cf. arXiv:1409.8608 on BLAS-based tensor contractions and
arXiv:1402.5897 on caching across kernel sequences).  This module ranks
whole paths without executing any of them:

1. :meth:`ChainSpec.paths` enumerates the pairwise contraction paths of
   an N-operand einsum (N <= :data:`MAX_OPERANDS`), deduplicating
   linearizations of the same contraction tree and operationally
   identical paths (same multiset of step contractions);
2. every path step lowers to an ordinary
   :class:`~repro_torch.core.contractions.ContractionSpec`, predicted by an
   ordinary :class:`~repro_torch.tc.predictor.ContractionPredictor` — all
   steps of all candidate paths share ONE
   :class:`~repro_torch.tc.suite.MicroBenchmarkSuite` and ONE
   :class:`~repro_torch.core.predict.TraceCache` (canonically-relabeled keys
   make renamed-but-identical steps the same measurement);
3. per-step estimates compose into a chain total: min/med/max/mean add,
   std adds in quadrature (Eq. 4.3), and the measured first-call
   overhead is counted once per distinct benchmark signature — NOT once
   per step, since what the first call set up stays set up.

The cache class of each step *input* follows the suite's access-distance
rule; intermediates additionally carry a **propagated arrival class**:
warm if the producing step's output fits in the cache capacity, cold
otherwise — never measured fresh.  The per-step per-algorithm scalar
path (:meth:`ChainPredictor.rank_paths_oracle`) is kept as the
equivalence oracle, mirroring the whole prediction stack's convention.

Execution runs on the device: :func:`execute_chain` moves the operands
there once and keeps every intermediate there, feeding each step's
result to the next without a host round trip.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import (Dict, List, Mapping, Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.contractions import _ITEM, ContractionSpec, _on, execute
from ..core.predict import TraceCache
from ..core.sampler import Stats
from .kernels import base_kernel, generate_algorithms
from .predictor import ContractionPredictor, RankedContraction, SizeSweep
from .suite import (COLD, WARM, MicroBenchmarkKey, MicroBenchmarkSuite,
                    resolve_suite)

#: largest supported einsum-chain operand count (path count grows as the
#: double factorial (2N-3)!!: 3, 15, 105 for N = 3, 4, 5)
MAX_OPERANDS = 5


# ------------------------------------------------------------------ chain --

@dataclass(frozen=True)
class ChainStep:
    """One pairwise contraction inside a path.

    ``inputs`` are operand *slots*: slots ``0..N-1`` are the chain's
    original operands, slot ``N + s`` is the intermediate produced by
    step ``s`` (steps are numbered in path order).  ``spec`` is the
    ordinary pairwise contraction the step lowers to; its ``a_idx`` /
    ``b_idx`` are the index strings of the two consumed slots and its
    ``out_idx`` the produced intermediate's indices.
    """

    spec: ContractionSpec
    inputs: Tuple[int, int]


@dataclass(frozen=True)
class ChainPath:
    """One full pairwise-contraction path of an N-operand einsum.

    ``n_operands`` fixes the slot numbering of the steps (see
    :class:`ChainStep`).  Step ``s`` writes slot ``n_operands + s``; the
    last step produces the chain's output.
    """

    n_operands: int
    steps: Tuple[ChainStep, ...]

    @property
    def name(self) -> str:
        """Nested-parenthesis rendering over operand positions, e.g.
        ``((0.1).(2.3))``."""
        rendered: Dict[int, str] = {i: str(i)
                                    for i in range(self.n_operands)}
        for s, step in enumerate(self.steps):
            i, j = step.inputs
            rendered[self.n_operands + s] = \
                f"({rendered[i]}.{rendered[j]})"
        return rendered[self.n_operands + len(self.steps) - 1]

    def intermediate_bytes(self, sizes: Mapping[str, int]) -> List[int]:
        """Footprint (bytes) of each step's output, in path order."""
        return [_ITEM * math.prod(sizes[i] for i in step.spec.out_idx)
                for step in self.steps]


@dataclass(frozen=True)
class ChainSpec:
    """An N-operand einsum ``op0,op1,...->out`` to be evaluated pairwise.

    Index strings follow the conventions of
    :class:`~repro_torch.core.contractions.ContractionSpec`: one letter
    per dimension, no repeats within an operand (no diagonals), and
    every index must appear in at least two places —
    an index private to a single operand and absent from the output would
    be a sum-reduction no pairwise BLAS step can express.
    """

    operands: Tuple[str, ...]
    out_idx: str

    @staticmethod
    def parse(expr: Union[str, "ChainSpec"]) -> "ChainSpec":
        """Parse ``"ij,jk,kl->il"`` (passes an existing spec through)."""
        if isinstance(expr, ChainSpec):
            return expr
        ins, out = expr.split("->")
        return ChainSpec(tuple(s.strip() for s in ins.split(",")),
                         out.strip())

    def __post_init__(self) -> None:
        # the dataclass is frozen, so validating here covers every
        # construction site, not just parse()
        n = len(self.operands)
        if not 2 <= n <= MAX_OPERANDS:
            raise ValueError(f"chain needs 2..{MAX_OPERANDS} operands, "
                             f"got {n}: {self.einsum_expr()}")
        for idx in self.operands + (self.out_idx,):
            if len(set(idx)) != len(idx):
                raise ValueError(f"repeated index within {idx!r} "
                                 f"(diagonals unsupported)")
        pool = "".join(self.operands)
        for i in self.out_idx:
            if i not in pool:
                raise ValueError(f"output index {i!r} appears in no "
                                 f"operand")
        for i in set(pool):
            if pool.count(i) == 1 and i not in self.out_idx:
                raise ValueError(
                    f"index {i!r} appears in one operand only and not in "
                    f"the output — a sum reduction no pairwise "
                    f"contraction step can express")

    @property
    def all_indices(self) -> Tuple[str, ...]:
        """Every distinct index, in order of first appearance."""
        seen: List[str] = []
        for i in "".join(self.operands) + self.out_idx:
            if i not in seen:
                seen.append(i)
        return tuple(seen)

    def einsum_expr(self) -> str:
        """The full einsum expression, e.g. ``"ij,jk,kl->il"``."""
        return ",".join(self.operands) + "->" + self.out_idx

    def flops(self, sizes: Mapping[str, int]) -> float:
        """Naive flop count of the un-factored einsum (2x the full index
        space) — an upper bound any decent path undercuts."""
        return 2.0 * math.prod(sizes[i] for i in self.all_indices)

    # --------------------------------------------------------- lowering --
    def _step_spec(self, a_idx: str, b_idx: str,
                   remaining: Sequence[str], final: bool) -> ContractionSpec:
        """Lower one pairwise step: keep every index still needed by a
        remaining operand or by the chain output, contract the rest."""
        if final:
            out = self.out_idx
        else:
            needed = set(self.out_idx).union(*map(set, remaining))
            seen = set()
            out = "".join(
                i for i in a_idx + b_idx
                if i in needed and not (i in seen or seen.add(i)))
        return ContractionSpec(a_idx, b_idx, out)

    def paths(self) -> List[ChainPath]:
        """All deduplicated pairwise contraction paths.

        Enumerates every linearization (pick any two live slots, contract,
        repeat), then deduplicates twice: linearizations of the same
        contraction *tree* are one path (the chain model is
        order-insensitive: intermediates' arrival classes depend only on
        their size), and so are paths whose sorted multiset of step
        contractions coincides (operationally identical: same
        benchmarks, same composed totals).
        """
        n = len(self.operands)
        out: List[ChainPath] = []
        seen_trees: set = set()
        seen_sigs: set = set()

        def rec(live, steps):
            # live: list of (slot, idx_str, tree-key); steps built so far
            if len(live) == 1:
                tree = live[0][2]
                if tree in seen_trees:
                    return
                seen_trees.add(tree)
                sig = tuple(sorted(
                    (s.spec.a_idx, s.spec.b_idx, s.spec.out_idx,
                     s.inputs[0] >= n, s.inputs[1] >= n) for s in steps))
                if sig in seen_sigs:
                    return
                seen_sigs.add(sig)
                out.append(ChainPath(n, tuple(steps)))
                return
            for x, y in itertools.combinations(range(len(live)), 2):
                (sa, a_idx, ta), (sb, b_idx, tb) = live[x], live[y]
                rest = [e for k, e in enumerate(live) if k not in (x, y)]
                spec = self._step_spec(a_idx, b_idx,
                                       [e[1] for e in rest],
                                       final=len(live) == 2)
                step = ChainStep(spec=spec, inputs=(sa, sb))
                slot = n + len(steps)
                rec(rest + [(slot, spec.out_idx,
                             frozenset((ta, tb)))], steps + [step])

        rec([(i, idx, i) for i, idx in enumerate(self.operands)], [])
        return out


# -------------------------------------------------------------- execution --

def _run_steps(path: ChainPath, operands, step_fn):
    slots: Dict[int, torch.Tensor] = dict(enumerate(operands))
    for s, step in enumerate(path.steps):
        i, j = step.inputs
        slots[path.n_operands + s] = step_fn(s, step, slots[i], slots[j])
    return slots[path.n_operands + len(path.steps) - 1]


def _operands_on(operands, device: DeviceLike):
    dev = resolve_device(device)
    return dev, [_on(x, dev) for x in operands]


def execute_path_reference(chain: ChainSpec, path: ChainPath,
                           operands: Sequence, *,
                           device: DeviceLike = None) -> torch.Tensor:
    """Execute one path as literal pairwise ``torch.einsum`` steps.

    The operational definition of what a path computes; dtypes are
    preserved, so integer-valued float64 operands reproduce the full
    einsum bit-for-bit under ANY path (every association order sums the
    same exact integers).
    """
    _, ops = _operands_on(operands, device)
    return _run_steps(path, ops,
                      lambda s, step, a, b:
                      torch.einsum(step.spec.einsum_expr(), a, b))


def execute_chain_reference(chain: ChainSpec, operands: Sequence, *,
                            device: DeviceLike = None) -> torch.Tensor:
    """The un-factored einsum over all operands (the chain's ground
    truth, independent of any path) on ``device``."""
    _, ops = _operands_on(operands, device)
    return torch.einsum(chain.einsum_expr(), *ops)


def execute_chain(chain: ChainSpec, ranked: "RankedChain",
                  operands: Sequence, sizes: Mapping[str, int], *,
                  device: DeviceLike = None) -> torch.Tensor:
    """Execute a ranked chain with its selected per-step algorithms.

    Each step runs through :func:`repro_torch.core.contractions.execute`
    (the real loop nest around the kernel call); the operands move to
    the device once and every intermediate stays there — what the
    prediction's cost fraction is measured against.
    """
    dev, ops = _operands_on(operands, device)
    return _run_steps(ranked.path, ops,
                      lambda s, step, a, b:
                      execute(ranked.steps[s].algorithm, a, b, sizes,
                              device=dev))


def validate_paths(chain: Union[ChainSpec, str],
                   sizes: Mapping[str, int], *,
                   paths: Optional[Sequence[ChainPath]] = None,
                   rng: Optional[np.random.Generator] = None,
                   device: DeviceLike = None) -> None:
    """Execute every path on small-integer operands against the full
    einsum on ``device``; raises ``AssertionError`` naming paths that are
    not bit-equal.

    Integer-valued float64 entries make every association order exact,
    so this checks true equality, not closeness.
    """
    chain = ChainSpec.parse(chain)
    rng = rng or np.random.default_rng(0)
    dev, ops = _operands_on(
        [rng.integers(-3, 4, size=[sizes[i] for i in idx]
                      ).astype(np.float64)
         for idx in chain.operands], device)
    ref = execute_chain_reference(chain, ops, device=dev)
    bad = [p.name for p in (paths if paths is not None else chain.paths())
           if not torch.equal(
               execute_path_reference(chain, p, ops, device=dev), ref)]
    if bad:
        raise AssertionError(
            f"{len(bad)} path(s) disagree with the einsum reference for "
            f"{chain.einsum_expr()}: {bad}")


# ------------------------------------------------------------ composition --

@dataclass(frozen=True)
class RankedChain:
    """One ranked contraction path with its selected per-step algorithms.

    ``runtime`` is the composed chain total (see
    :func:`compose_chain_runtime`); ``steps`` holds each step's winning
    :class:`~repro_torch.tc.predictor.RankedContraction` in path order.
    """

    path: ChainPath
    steps: Tuple[RankedContraction, ...]
    runtime: Stats

    @property
    def name(self) -> str:
        """The path's nested-parenthesis name, e.g. ``((0.1).2)``."""
        return self.path.name


def compose_chain_runtime(steps: Sequence[RankedContraction]) -> Stats:
    """Compose per-step predictions into a chain total.

    min/med/max/mean add across steps and std adds in quadrature
    (Eq. 4.3: steps are uncorrelated estimates).  Each step's runtime
    already includes its benchmark's first-call overhead; repeated
    signatures subtract the duplicate — what one step's first call set up
    is still set up at the next, so the overhead is paid once per
    DISTINCT signature, not once per step.
    """
    sums = {s: 0.0 for s in ("min", "med", "max", "mean")}
    var = 0.0
    dup_first = 0.0
    seen: set = set()
    for r in steps:
        for s in sums:
            sums[s] += getattr(r.runtime, s)
        var += r.runtime.std ** 2
        if r.benchmark in seen:
            dup_first += r.first
        else:
            seen.add(r.benchmark)
    return Stats(min=sums["min"] - dup_first, med=sums["med"] - dup_first,
                 max=sums["max"] - dup_first, mean=sums["mean"] - dup_first,
                 std=var ** 0.5)


# -------------------------------------------------------------- predictor --

class ChainPredictor:
    """Rank an einsum's contraction paths from shared micro-benchmarks.

    Every path step becomes an ordinary
    :class:`~repro_torch.tc.predictor.ContractionPredictor` over the step's
    candidate algorithms; all steps of all paths share this predictor's
    :class:`~repro_torch.tc.suite.MicroBenchmarkSuite` and
    :class:`~repro_torch.core.predict.TraceCache`, and steps appearing in
    several paths (or identical up to index renaming) share one
    predictor outright.  A path's prediction picks each step's fastest
    candidate and composes the totals with
    :func:`compose_chain_runtime`.  Per-step selection is greedy: with
    arrival classes fixed by the path, steps couple only through the
    shared-signature first-call discount, so a greedy winner can miss a
    jointly-cheaper assignment by at most one ``first`` per shared
    signature — negligible for realistic loop counts, and bounded by
    the overhead term, never the loop term.

    ``memory_limit_bytes`` prunes paths whose non-final intermediates
    exceed the limit (the same guard ``np.einsum_path`` applies) —
    outer-product detours can otherwise dwarf every useful candidate.
    ``kernels`` restricts every step's candidate set to the named base
    kernels (e.g. ``("gemm", "gemv")``): fewer distinct micro-benchmark
    signatures, at the price of possibly missing an exotic winner.
    """

    def __init__(self, chain: Union[ChainSpec, str],
                 sizes: Mapping[str, int], *,
                 paths: Optional[Sequence[ChainPath]] = None,
                 suite: Optional[MicroBenchmarkSuite] = None,
                 cache: Optional[TraceCache] = None,
                 repetitions: Optional[int] = None,
                 include_batched: bool = True,
                 kernels: Optional[Sequence[str]] = None,
                 max_loop_perms: int = 24,
                 memory_limit_bytes: Optional[int] = None):
        self.chain = ChainSpec.parse(chain)
        self.sizes = dict(sizes)
        self.include_batched = include_batched
        self.kernels = tuple(kernels) if kernels is not None else None
        self.max_loop_perms = max_loop_perms
        candidates = list(paths) if paths is not None else \
            self.chain.paths()
        if memory_limit_bytes is not None:
            candidates = [
                p for p in candidates
                if all(b <= memory_limit_bytes
                       for b in p.intermediate_bytes(self.sizes)[:-1])]
        if not candidates:
            raise ValueError(
                f"no candidate paths for {self.chain.einsum_expr()} "
                f"(memory_limit_bytes={memory_limit_bytes})")
        self.paths = candidates
        self.suite = resolve_suite(suite, repetitions)
        self.cache = cache if cache is not None else TraceCache()
        self._predictors: Dict[Tuple, ContractionPredictor] = {}

    # ----------------------------------------------------------- steps --
    def arrival_classes(self, step: ChainStep) -> Dict[str, str]:
        """Propagated arrival class per step input.

        Original operands get no entry (the suite's access-distance rule
        applies unmodified); an intermediate arrives WARM iff the
        producing step's output fits in the suite's cache capacity, COLD
        otherwise — its state is what the previous step left behind, so
        it is never measured fresh.
        """
        out: Dict[str, str] = {}
        for op, (slot, idx) in zip(
                ("A", "B"),
                zip(step.inputs, (step.spec.a_idx, step.spec.b_idx))):
            if slot >= len(self.chain.operands):
                bytes_ = _ITEM * math.prod(self.sizes[i] for i in idx)
                out[op] = WARM if bytes_ <= self.suite.cache_bytes else COLD
        return out

    def step_predictor(self, step: ChainStep) -> ContractionPredictor:
        """The (shared) per-step predictor; steps with equal (spec,
        arrival) reuse one predictor — and through the shared suite, even
        differently-named equal steps share measurements."""
        arrival = self.arrival_classes(step)
        key = (step.spec, tuple(sorted(arrival.items())))
        pred = self._predictors.get(key)
        if pred is None:
            algs = generate_algorithms(
                step.spec, include_batched=self.include_batched,
                max_loop_perms=self.max_loop_perms)
            if self.kernels is not None:
                algs = [a for a in algs
                        if base_kernel(a.kernel) in self.kernels]
            pred = ContractionPredictor(
                step.spec, self.sizes, algorithms=algs,
                suite=self.suite, cache=self.cache,
                arrival=arrival or None)
            self._predictors[key] = pred
        return pred

    def prepare(self) -> None:
        """Run the (deduplicated) suite for every step of every path."""
        for path in self.paths:
            for step in path.steps:
                self.step_predictor(step).prepare()

    def benchmark_keys(self) -> List[MicroBenchmarkKey]:
        """Every step candidate's suite key across ALL paths — computed
        without measuring anything (step predictors are constructed but
        never prepared).  The chain-level analogue of
        :meth:`~repro_torch.tc.predictor.ContractionPredictor.benchmark_keys`,
        feeding the session's parametric pre-pass."""
        keys = []
        for path in self.paths:
            for step in path.steps:
                keys.extend(self.step_predictor(step).benchmark_keys())
        return keys

    # ------------------------------------------------------------ rank --
    def rank_paths(self, *, stat: str = "med", backend: str = "numpy",
                   device: DeviceLike = None) -> List[RankedChain]:
        """All candidate paths, fastest-predicted chain total first.

        Per-step rankings run through the batched
        :class:`~repro_torch.core.predict.PredictionEngine` on ``backend``
        (and, for ``"torch"``, ``device``); repeated calls reuse suite
        measurements and compiled batches.
        """
        return self._rank(stat, lambda step: self.step_predictor(step).rank(
            stat=stat, backend=backend, device=device)[0])

    def rank_paths_oracle(self, *, stat: str = "med",
                          fresh: bool = True) -> List[RankedChain]:
        """The step-by-step per-algorithm equivalence oracle.

        Each step is ranked by
        :meth:`~repro_torch.tc.predictor.ContractionPredictor.rank_oracle` —
        §6.2 arithmetic in plain Python, no engine — and composed with
        the same :func:`compose_chain_runtime`.  ``fresh=False`` reuses
        the suite's shared measurements, so engine and oracle rankings
        must agree deterministically; ``fresh=True`` re-measures every
        candidate independently (the original per-algorithm protocol).
        """
        return self._rank(stat, lambda step: self.step_predictor(
            step).rank_oracle(stat=stat, fresh=fresh)[0])

    def _rank(self, stat, step_winner) -> List[RankedChain]:
        # steps shared by several paths resolve to one predictor: compute
        # (and, for the fresh oracle, re-measure) each winner once per
        # distinct predictor, not once per (path, step) occurrence
        winners: Dict[int, RankedContraction] = {}

        def winner(step):
            key = id(self.step_predictor(step))
            if key not in winners:
                winners[key] = step_winner(step)
            return winners[key]

        ranked = []
        for path in self.paths:
            chosen = tuple(winner(step) for step in path.steps)
            ranked.append(RankedChain(
                path=path, steps=chosen,
                runtime=compose_chain_runtime(chosen)))
        ranked.sort(key=lambda r: getattr(r.runtime, stat))
        return ranked

    def select_path(self, *, stat: str = "med", backend: str = "numpy",
                    device: DeviceLike = None) -> RankedChain:
        """The fastest-predicted path (``rank_paths(...)[0]``)."""
        return self.rank_paths(stat=stat, backend=backend, device=device)[0]

    # ------------------------------------------------------------ cost --
    @property
    def n_benchmarks(self) -> int:
        """Distinct micro-benchmarks run across ALL steps of ALL paths."""
        return self.suite.n_benchmarks

    def prediction_cost_fraction(self, measured_seconds: float) -> float:
        """Total suite cost over one measured chain execution — Ch. 6's
        "merely a fraction of a contraction's runtime", lifted to whole
        einsum paths."""
        return self.suite.cost_fraction(measured_seconds)


# ------------------------------------------------------- size-sweep mode --

@dataclass(frozen=True)
class ChainSizeSweep(SizeSweep):
    """An einsum's contraction paths ranked across a grid of sizes.

    Produced by :func:`rank_einsum_sweep`; ``rankings`` holds
    :class:`RankedChain` lists, one per size point — every size point's
    steps were predicted from the ONE shared suite/cache, so a new size
    point only measures the (equation, shapes, cache-class) keys no
    earlier point (or prior single-size ranking sharing the same suite)
    already covered.  Shared members (``winners``, ``n_benchmarks``,
    ``cost_fraction``) come from :class:`~repro_torch.tc.predictor.SizeSweep`.
    """

    chain: ChainSpec
    predictors: Tuple[ChainPredictor, ...]


def rank_einsum_sweep(chain: Union[ChainSpec, str],
                      sizes_grid: Sequence[Mapping[str, int]], *,
                      stat: str = "med", backend: str = "numpy",
                      device: DeviceLike = None,
                      suite: Optional[MicroBenchmarkSuite] = None,
                      cache: Optional[TraceCache] = None,
                      repetitions: Optional[int] = None,
                      include_batched: bool = True,
                      kernels: Optional[Sequence[str]] = None,
                      max_loop_perms: int = 24,
                      memory_limit_bytes: Optional[int] = None,
                      ) -> ChainSizeSweep:
    """Rank every contraction path at every size point from ONE suite.

    The chain-level size-sweep autotuning mode: one
    :class:`ChainPredictor` per size point, all sharing a single
    :class:`~repro_torch.tc.suite.MicroBenchmarkSuite` and
    :class:`~repro_torch.core.predict.TraceCache` (pass ``suite=``/``cache=``
    to extend a suite that already served single-size rankings).  Steps
    whose kernel signatures are unchanged across sizes — canonical
    relabeling included — re-predict from existing measurements; only
    the genuinely new keys are measured.  ``memory_limit_bytes`` prunes
    per size point (an intermediate may be affordable at one size and
    not another); a point where NO path survives the limit fails the
    sweep with an error naming that point — drop it from the grid (or
    raise the limit) to rank the rest.  The remaining keywords bound
    the per-step candidate sets exactly as on :class:`ChainPredictor`.
    """
    spec = ChainSpec.parse(chain)
    grid = [dict(s) for s in sizes_grid]
    if not grid:
        raise ValueError("sizes_grid must name at least one size point")
    suite = resolve_suite(suite, repetitions)
    cache = cache if cache is not None else TraceCache()
    predictors, rankings = [], []
    for sizes in grid:
        try:
            pred = ChainPredictor(spec, sizes, suite=suite, cache=cache,
                                  include_batched=include_batched,
                                  kernels=kernels,
                                  max_loop_perms=max_loop_perms,
                                  memory_limit_bytes=memory_limit_bytes)
        except ValueError as e:
            raise ValueError(f"size point {sizes}: {e}") from None
        rankings.append(tuple(pred.rank_paths(stat=stat, backend=backend,
                                              device=device)))
        predictors.append(pred)
    return ChainSizeSweep(chain=spec, sizes_grid=tuple(grid),
                          rankings=tuple(rankings),
                          predictors=tuple(predictors),
                          suite=suite, cache=cache)
