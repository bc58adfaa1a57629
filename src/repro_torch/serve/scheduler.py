"""Model-guided scheduling for the continuous-batching serve engine, the
counterpart of ``repro/serve/scheduler.py``, with the same policies.

The dissertation's claim is that measurement-based kernel models pick the
fastest configuration *without executing candidates*.  This module puts
that claim in the request hot path: every scheduling tick the engine must
choose between candidate actions — admit a waiting request or defer it,
which request to pack into a free slot, prefill in a blocking burst or
interleave it with decode — and a :class:`ModelGuidedScheduler` scores
those candidates on **predicted completion-time deltas** from a
:class:`StepCostModel` measured once through the shared
:class:`~repro_torch.tc.suite.MicroBenchmarkSuite` (via a
:class:`~repro_torch.tc.session.PredictorSession`), instead of executing
any of them.

Two schedulers implement the ``plan()`` protocol:

* :class:`FifoScheduler` — the ``policy="fifo"`` escape hatch: admit the
  head of the queue whenever a slot is free, blocking prefill, then one
  decode step.  Action-for-action the reference's loop, kept as the
  baseline and equivalence oracle.
* :class:`ModelGuidedScheduler` — per tick, rolls each candidate action
  forward on predicted per-tick costs (warm/cold arrival classes
  propagated across ticks: the first tick after an admission is predicted
  under the COLD class, steady decode under WARM) and picks the action
  with the lowest predicted sum of completion times.  Admitted requests
  prefill *interleaved* — prompt tokens ride along with decode tokens in
  the same fused step — because the model predicts a fused tick costs the
  same as a decode-only tick on this static-batch engine.  The policy is
  the reference's unchanged, although in the port a blocking admission is
  one batched pass through the kernels rather than a replay of one tick
  per prompt token; how far the policy and the tick prediction are off on
  the card is measured, not corrected, here.

The per-tick planning work is a few dict lookups plus a bounded rollout
over predicted costs (no measurement, no compilation), so scheduling
overhead stays well under a millisecond.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..tc.suite import COLD, WARM
from .engine import EngineStats, Request, ServeEngine


@dataclass(frozen=True)
class Plan:
    """One tick's scheduling decision.

    ``admit_blocking`` requests are prefilled to completion before the
    next fused step (the FIFO baseline's behavior); ``admit_interleaved``
    requests open prefill lanes that advance one prompt token per fused
    step.  An empty plan means: just advance the engine.
    """

    admit_blocking: Tuple[Request, ...] = ()
    admit_interleaved: Tuple[Request, ...] = ()


@dataclass(frozen=True)
class StepCostModel:
    """Predicted cost of ONE fused engine step, per (occupancy, class).

    ``tick_s[(occ, cls)]`` is the predicted seconds of a fused step with
    ``occ`` busy lanes whose operands arrive under cache class ``cls``
    (:data:`~repro_torch.tc.suite.WARM` for steady-state decode,
    :data:`~repro_torch.tc.suite.COLD` for the first tick after an admission,
    whose prompt streaming left the operand cache evicted).  On the
    static-batch engine the measured cost is occupancy-invariant — the
    step always runs full batch width — but the mapping keys occupancy
    explicitly so dynamic-batch engines (and scripted test models) can
    express occupancy-dependent costs; lookups clamp to the nearest
    measured occupancy.
    """

    tick_s: Mapping[Tuple[int, str], float]
    slots: int
    build_seconds: float = 0.0     # wall-clock spent building the model
    n_benchmarks: int = 0          # distinct suite measurements it took

    def tick_cost(self, occupancy: int,  # reprolint: hot-path
                  cls: str = WARM) -> float:
        """Predicted seconds of one fused step at ``occupancy`` lanes."""
        occ = min(max(int(occupancy), 1), self.slots)
        got = self.tick_s.get((occ, cls))
        if got is None:
            got = self.tick_s[(occ, WARM)]
        return got

    def service_ticks(self, req: Request) -> int:
        """Fused steps to fully serve ``req`` on an interleaved lane:
        one per prompt token plus one per output token."""
        return len(req.prompt) + req.max_new_tokens - len(req.out_tokens)


#: the contraction patterns one decode step is dominated by, as
#: (sizes-builder, calls-per-layer): the q/k/v/o projections and the two
#: FFN matmuls, each a batched (occupancy, 1, d) x (d, k) matmul —
#: exactly the shape class `repro_torch.tc.kernels` absorbs into one
#: gemm_batch call
STEP_KERNEL_EQUATION = "bij,jk->bik"


def step_kernel_sizes(cfg, batch: int) -> List[Tuple[Dict[str, int], int]]:
    """(sizes, calls-per-layer) for the step-dominating contractions of
    one fused decode step of ``cfg`` at batch width ``batch``."""
    d = cfg.d_model
    f = getattr(cfg, "d_ff", 4 * d) or 4 * d
    return [
        (dict(b=batch, i=1, j=d, k=d), 4),    # q/k/v/o projections
        (dict(b=batch, i=1, j=d, k=f), 1),    # FFN up
        (dict(b=batch, i=1, j=f, k=d), 1),    # FFN down
    ]


def _steady_seconds(session, ranked) -> float:
    """The fastest candidate's *steady-state* total: per-call median of
    its backing suite measurement times its iteration count.  The ranked
    ``runtime`` includes the one-time first-call overhead (library
    init, kernel loading) — irrelevant for an engine whose step is compiled once
    — so candidates are re-scored on the steady figure here."""
    best = None
    for r in ranked:
        mb = session.suite.results[r.benchmark]
        steady = mb.stats.med * r.n_iterations
        if best is None or steady < best:
            best = steady
    return best


def build_step_cost_model(session, cfg, *, slots: int) -> StepCostModel:
    """Measure-and-fit the per-tick cost model through a session.

    For both arrival classes, the step-dominating contractions at FULL
    batch width are ranked through the session's
    :class:`~repro_torch.tc.predictor.ContractionPredictor` — deduplicated
    cache-aware micro-benchmarks compiled through the batched
    :class:`~repro_torch.core.predict.PredictionEngine` — and the fastest
    candidate's steady-state figure (per-call median × iterations, see
    :func:`_steady_seconds`) is summed over the per-layer call counts.
    The static-batch engine runs every step at full width whatever the
    occupancy, so one measured width serves every occupancy key.  The
    candidate set is restricted to the gemm/dot-based algorithms (the
    engine's step IS one batched matmul per projection), which keeps the
    suite to a handful of distinct signatures; everything is measured
    exactly once per platform and reused by every scheduler built on the
    same session.
    """
    from ..core.contractions import ContractionSpec
    from ..tc.kernels import base_kernel, generate_algorithms

    t0 = time.perf_counter()
    before = session.suite.n_benchmarks
    spec = ContractionSpec.parse(STEP_KERNEL_EQUATION)
    algs = [a for a in generate_algorithms(spec, include_batched=True)
            if base_kernel(a.kernel) in ("gemm", "dot")]
    tick_s: Dict[Tuple[int, str], float] = {}
    for cls in (WARM, COLD):
        arrival = {"A": COLD, "B": COLD} if cls == COLD else None
        total = 0.0
        for sizes, count in step_kernel_sizes(cfg, slots):
            ranked = session.rank_contraction_algorithms(
                STEP_KERNEL_EQUATION, sizes,
                algorithms=algs or None, arrival=arrival)
            total += count * cfg.n_layers * _steady_seconds(session, ranked)
        for occ in range(1, slots + 1):
            tick_s[(occ, cls)] = total
    return StepCostModel(tick_s=tick_s, slots=slots,
                         build_seconds=time.perf_counter() - t0,
                         n_benchmarks=session.suite.n_benchmarks - before)


# -------------------------------------------------------------- schedulers --

class FifoScheduler:
    """First-come-first-served, blocking prefill: the pre-refactor loop.

    Admits as many head-of-queue requests as there are free slots, each
    with a blocking prefill, then lets the engine take one decode step —
    exactly what ``ServeEngine.run`` did before the scheduler existed.
    The model-guided policy is benchmarked against this baseline, and
    the equivalence test pins it action-for-action to a manually-driven
    legacy loop.
    """

    def plan(self, engine: ServeEngine,  # reprolint: hot-path
             waiting: List[Request]) -> Plan:
        """Admit ``waiting[:free]`` blocking, in arrival order."""
        free = len(engine.free_slots())
        return Plan(admit_blocking=tuple(waiting[:free]))


class ModelGuidedScheduler:
    """Score candidate actions on predicted completion-time deltas.

    Per tick (only when a slot is free AND requests wait — otherwise the
    plan is trivially empty and costs a dict lookup):

    1. candidate actions are *defer* (admit nothing this tick) and
       *admit r* for each of the first ``window`` waiting requests;
    2. each candidate is rolled forward on the :class:`StepCostModel`:
       simulated fused ticks advance every lane one token, completions
       free slots, remaining waiting requests are admitted
       shortest-predicted-service-first as slots free, and the tick
       after any admission is costed under the COLD class (the arrival
       state the admission leaves behind);
    3. the action with the lowest predicted **sum of completion times**
       wins.  Ties prefer admitting (earlier queue positions first).

    A request passed over ``max_defer`` times is force-admitted — the
    shortest-job preference must not starve long prompts.  Admissions
    are interleaved prefills: the model predicts a fused tick costs what
    a decode tick costs on this engine, so folding prompt tokens into
    decode steps strictly beats the FIFO baseline's blocking bursts.
    """

    def __init__(self, model: StepCostModel, *, window: int = 4,
                 max_defer: int = 32, horizon: int = 512):
        self.model = model
        self.window = window
        self.max_defer = max_defer
        self.horizon = horizon
        self._deferrals: Dict[int, int] = {}

    # ------------------------------------------------------------ rollout --
    def _rollout(self, lanes: List[List[int]],  # reprolint: hot-path
                 queue: List[Tuple[int, int]], *,
                 hold_first: bool, cold_now: bool) -> float:
        """Predicted sum of completion times of every known request.

        ``lanes`` holds ``[prefill_left, decode_left]`` per busy slot;
        ``queue`` holds ``(prefill, decode)`` service estimates of the
        still-waiting requests, admitted shortest-first whenever a slot
        frees (``hold_first`` blocks admissions until the first
        completion — the *defer* candidate's semantics).  Costs come
        from the step model; the tick after any admission is COLD.
        """
        model = self.model
        lanes = [list(lane) for lane in lanes]
        queue = sorted(queue, key=lambda s: s[0] + s[1])
        t = 0.0
        total = 0.0
        cold = cold_now
        held = hold_first
        ticks = 0
        while lanes or queue:
            if not held:
                while queue and len(lanes) < model.slots:
                    p, d = queue.pop(0)
                    lanes.append([p, d])
                    cold = True
            if not lanes:      # nothing running and admissions held
                held = False
                continue
            t += model.tick_cost(len(lanes), COLD if cold else WARM)
            cold = False
            ticks += 1
            done = []
            for lane in lanes:
                if lane[0] > 0:
                    lane[0] -= 1
                else:
                    lane[1] -= 1
                if lane[0] <= 0 and lane[1] <= 0:
                    done.append(lane)
            for lane in done:
                lanes.remove(lane)
                total += t
                held = False
            if ticks >= self.horizon:
                # truncate: close out remaining lanes/queue analytically
                # at the steady warm decode rate
                warm = model.tick_cost(len(lanes) or 1, WARM)
                for lane in lanes:
                    total += t + (lane[0] + lane[1]) * warm
                for p, d in queue:
                    total += t + (p + d) * warm
                break
        return total

    def _lanes(self, engine: ServeEngine) -> List[List[int]]:
        lanes = [[0, req.max_new_tokens - len(req.out_tokens)]
                 for req in engine.active.values()]
        lanes += [[len(req.prompt) - engine.prefill_done[slot],
                   req.max_new_tokens]
                  for slot, req in engine.prefilling.items()]
        return lanes

    # --------------------------------------------------------------- plan --
    def plan(self, engine: ServeEngine,  # reprolint: hot-path
             waiting: List[Request]) -> Plan:
        """The tick decision: admit one of the first ``window`` waiting
        requests (interleaved prefill) or defer, whichever minimizes the
        predicted sum of completion times."""
        if not waiting or not engine.free_slots():
            return Plan()
        cands = waiting[:self.window]
        for req in cands:
            if self._deferrals.get(req.uid, 0) >= self.max_defer:
                self._deferrals.pop(req.uid, None)
                return Plan(admit_interleaved=(req,))
        lanes = self._lanes(engine)
        service = {req.uid: (len(req.prompt),
                             req.max_new_tokens - len(req.out_tokens))
                   for req in waiting}
        defer = self._rollout(
            lanes, [service[r.uid] for r in waiting],
            hold_first=True, cold_now=False)
        best_req: Optional[Request] = None
        best = float("inf")
        for req in cands:
            rest = [service[r.uid] for r in waiting if r.uid != req.uid]
            p, d = service[req.uid]
            score = self._rollout(lanes + [[p, d]], rest,
                                  hold_first=False, cold_now=True)
            # ties vs defer admit; ties among candidates keep the
            # earliest queue position
            if score <= defer * (1 + 1e-9) and score < best - 1e-12:
                best, best_req = score, req
        if best_req is None:
            for req in cands:
                self._deferrals[req.uid] = \
                    self._deferrals.get(req.uid, 0) + 1
            return Plan()
        for req in cands:
            if req is not best_req:
                self._deferrals[req.uid] = \
                    self._deferrals.get(req.uid, 0) + 1
        self._deferrals.pop(best_req.uid, None)
        return Plan(admit_interleaved=(best_req,))


# --------------------------------------------------------------- the loop --

def serve_loop(engine: ServeEngine,  # reprolint: hot-path
               requests: Sequence[Request],
               scheduler) -> EngineStats:
    """Drive the engine to completion under ``scheduler``.

    The tick loop: release open-loop arrivals onto the waiting queue as
    the run clock passes their ``arrival_s``, ask the scheduler for a
    :class:`Plan` (its planning time is accounted as
    ``stats.tick_overhead_s`` — the < 1 ms budget the regression test
    pins), apply the admissions through the engine's step hooks, advance
    one fused step, and stamp finish times / latencies on completed
    requests.
    """
    stats = engine.stats
    t0 = time.perf_counter()
    pending = sorted(requests, key=lambda r: r.arrival_s)
    waiting: List[Request] = []
    while pending or waiting or engine.active or engine.prefilling:
        now = time.perf_counter() - t0
        while pending and pending[0].arrival_s <= now:
            req = pending.pop(0)
            req.submitted_s = max(now, req.arrival_s)
            waiting.append(req)
        if not waiting and not engine.active and not engine.prefilling:
            # idle: nothing to schedule until the next arrival
            time.sleep(min(5e-4, max(0.0,
                                     pending[0].arrival_s - now)))
            continue
        t_plan = time.perf_counter()
        plan = scheduler.plan(engine, waiting)
        stats.tick_overhead_s += time.perf_counter() - t_plan
        stats.ticks += 1
        for req in plan.admit_blocking:
            if not engine.add_request(req):
                break
            waiting.remove(req)
        for req in plan.admit_interleaved:
            if not engine.free_slots():
                break
            engine.begin_prefill(req)
            waiting.remove(req)
        finished = engine.advance()
        if finished:
            now = time.perf_counter() - t0
            for req in finished:
                req.finished_s = now
                stats.latencies_s.append(
                    now - (req.submitted_s or 0.0))
    return stats
