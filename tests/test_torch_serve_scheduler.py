"""The port's scheduler against the reference's: decision logic on scripted
step-cost models, and the step-cost model built through a session.

The reference's scripted-model tests (``tests/test_serve_scheduler.py``)
run on both packages.  Then, on the same duck-typed engine states and the
same scripted ``StepCostModel``, the port's ``ModelGuidedScheduler.plan``
must return the reference's admissions and deferral counts tick after
tick, and ``_rollout`` the reference's totals to 1e-12.  Last,
``build_step_cost_model`` runs on a session whose suite measures through
the reference tests' deterministic ``fake_measure`` (nothing is timed):
the port's ``tick_s`` must have the reference's keys and values, and the
session's ``guided_scheduler`` must be built on it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as ref_serve  # noqa: E402
import repro.tc.suite as ref_suite  # noqa: E402
from repro.core.sampler import Stats as RefStats  # noqa: E402
from repro.tc import MicroBenchmarkSuite as RefSuite  # noqa: E402
from repro.tc import PredictorSession as RefSession  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.core.sampler import Stats  # noqa: E402
from repro_torch.tc import MicroBenchmarkSuite, PredictorSession  # noqa: E402
from repro_torch.tc import suite as port_suite  # noqa: E402

REL = 1e-12
CACHE = 32 * 2 ** 20
#: package name -> (its serve package, its WARM, its COLD)
PKGS = {"repro": (ref_serve, ref_suite.WARM, ref_suite.COLD),
        "repro_torch": (serve, port_suite.WARM, port_suite.COLD)}


def scripted_model(pkg, slots, *, warm=1.0, cold=None, per_occ=None):
    """A StepCostModel with scripted (not measured) tick costs."""
    mod, WARM, COLD = PKGS[pkg]
    cold = warm if cold is None else cold
    tick_s = {}
    for occ in range(1, slots + 1):
        w = per_occ[occ - 1] if per_occ is not None else warm
        tick_s[(occ, WARM)] = w
        tick_s[(occ, COLD)] = cold if per_occ is None else w
    return mod.StepCostModel(tick_s=tick_s, slots=slots)


class FakeEngine:
    """Duck-typed engine state for pure decision tests (no model)."""

    def __init__(self, slots):
        self.slots = slots
        self.active = {}
        self.prefilling = {}
        self.prefill_done = {}

    def free_slots(self):
        return [s for s in range(self.slots)
                if s not in self.active and s not in self.prefilling]


def req(pkg, uid, prompt_len=4, max_new=8):
    return PKGS[pkg][0].Request(uid=uid,
                                prompt=np.ones(prompt_len, dtype=np.int32),
                                max_new_tokens=max_new)


# ------------------------------------------ the reference's scripted tests --

@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


def test_plan_trivial_cases(pkg):
    mod = PKGS[pkg][0]
    sched = mod.ModelGuidedScheduler(scripted_model(pkg, 2))
    eng = FakeEngine(2)
    assert sched.plan(eng, []) == mod.Plan()
    eng.active = {0: req(pkg, 0), 1: req(pkg, 1)}
    assert sched.plan(eng, [req(pkg, 2)]) == mod.Plan()


def test_idle_engine_admits_immediately(pkg):
    mod = PKGS[pkg][0]
    sched = mod.ModelGuidedScheduler(scripted_model(pkg, 2))
    r = req(pkg, 0)
    assert sched.plan(FakeEngine(2), [r]).admit_interleaved == (r,)


def test_shortest_job_admitted_first(pkg):
    mod = PKGS[pkg][0]
    sched = mod.ModelGuidedScheduler(scripted_model(pkg, 2))
    eng = FakeEngine(2)
    eng.active = {0: req(pkg, 9, max_new=50)}
    long_req = req(pkg, 1, prompt_len=40, max_new=16)
    short_req = req(pkg, 2, prompt_len=4, max_new=4)
    plan = sched.plan(eng, [long_req, short_req])
    assert plan.admit_interleaved == (short_req,)


def test_defer_when_occupancy_is_expensive(pkg):
    mod = PKGS[pkg][0]
    sched = mod.ModelGuidedScheduler(
        scripted_model(pkg, 2, per_occ=[1.0, 50.0]), max_defer=3)
    eng = FakeEngine(2)
    eng.active = {0: req(pkg, 9, max_new=3)}
    assert sched.plan(eng, [req(pkg, 1, prompt_len=2, max_new=2)]) == \
        mod.Plan()


def test_force_admit_bounds_starvation(pkg):
    mod = PKGS[pkg][0]
    sched = mod.ModelGuidedScheduler(
        scripted_model(pkg, 2, per_occ=[1.0, 50.0]), max_defer=3)
    eng = FakeEngine(2)
    eng.active = {0: req(pkg, 9, max_new=3)}
    r = req(pkg, 1, prompt_len=2, max_new=2)
    for _ in range(3):
        assert sched.plan(eng, [r]) == mod.Plan()
    assert sched.plan(eng, [r]).admit_interleaved == (r,)


def test_model_tick_cost_clamps_occupancy(pkg):
    _, _, COLD = PKGS[pkg]
    model = scripted_model(pkg, 2, warm=1.0, cold=3.0)
    assert model.tick_cost(0) == model.tick_cost(1)
    assert model.tick_cost(99) == model.tick_cost(2)
    assert model.tick_cost(1, COLD) == 3.0
    assert model.service_ticks(req(pkg, 0, prompt_len=5, max_new=7)) == 12


def test_fifo_admits_the_head_of_the_queue(pkg):
    mod = PKGS[pkg][0]
    eng = FakeEngine(3)
    eng.active = {1: req(pkg, 9)}
    waiting = [req(pkg, i) for i in range(4)]
    assert mod.FifoScheduler().plan(eng, waiting) == \
        mod.Plan(admit_blocking=tuple(waiting[:2]))


# ------------------------------------------------- plan-for-plan parity --

def _scenario(rng, pkg):
    """A random engine state and waiting queue, built for ``pkg``."""
    slots = int(rng.integers(2, 5))
    eng = FakeEngine(slots)
    for s in range(slots):
        kind = rng.integers(0, 3)
        if kind == 1:
            eng.active[s] = req(pkg, 100 + s,
                                max_new=int(rng.integers(1, 12)))
        elif kind == 2:
            r = req(pkg, 100 + s, prompt_len=int(rng.integers(2, 30)),
                    max_new=int(rng.integers(1, 20)))
            eng.prefilling[s] = r
            eng.prefill_done[s] = int(rng.integers(0, len(r.prompt)))
    waiting = [req(pkg, i, prompt_len=int(rng.integers(1, 60)),
                   max_new=int(rng.integers(1, 30)))
               for i in range(int(rng.integers(1, 9)))]
    # occupancy that grows dear fast makes deferring win now and then
    per_occ = list(rng.uniform(0.5, 2.0) *
                   rng.uniform(1.0, 60.0) ** np.arange(slots))
    model = scripted_model(pkg, slots, warm=float(rng.uniform(0.5, 2.0)),
                           cold=float(rng.uniform(1.0, 4.0)),
                           per_occ=per_occ if rng.integers(0, 2) else None)
    kw = dict(window=int(rng.integers(1, 5)),
              max_defer=int(rng.integers(1, 4)),
              horizon=int(rng.integers(8, 200)))
    return eng, waiting, model, kw


@pytest.mark.parametrize("seed", range(12))
def test_plans_deferrals_and_rollouts_equal_the_reference(seed):
    """The same random state in both packages: six ticks of ``plan``, with
    each tick's admission applied to the state, give the same admissions
    and deferral counts, and every candidate's ``_rollout`` total agrees
    to 1e-12."""
    built = {pkg: _scenario(np.random.default_rng(seed), pkg)
             for pkg in PKGS}
    scheds = {pkg: PKGS[pkg][0].ModelGuidedScheduler(model, **kw)
              for pkg, (_, _, model, kw) in built.items()}
    for _ in range(6):
        got = {}
        for pkg, (eng, waiting, _, _) in built.items():
            sched = scheds[pkg]
            lanes = sched._lanes(eng)
            service = [(len(r.prompt), r.max_new_tokens) for r in waiting]
            rollouts = [sched._rollout(lanes, service, hold_first=True,
                                       cold_now=False)]
            rollouts += [sched._rollout(lanes + [list(service[i])],
                                        service[:i] + service[i + 1:],
                                        hold_first=False, cold_now=True)
                         for i in range(len(service))]
            plan = sched.plan(eng, waiting)
            got[pkg] = ([r.uid for r in plan.admit_interleaved],
                        [r.uid for r in plan.admit_blocking],
                        dict(sched._deferrals), rollouts)
            for r in plan.admit_interleaved:
                slot = eng.free_slots()[0]
                eng.prefilling[slot] = r
                eng.prefill_done[slot] = 0
                waiting.remove(r)
        mine, ref = got["repro_torch"], got["repro"]
        assert mine[:3] == ref[:3]
        np.testing.assert_allclose(mine[3], ref[3], rtol=REL, atol=0)


# ----------------------------------------------- the step-cost model --

def fake_measure(key, repetitions):
    """tests/test_tc.py's deterministic synthetic timing."""
    t = 1e-9 * key.call_bytes + 2e-6 + 5e-7 * key.classes.count("cold")
    stats = Stats(min=0.95 * t, med=t, max=1.1 * t, mean=1.01 * t,
                  std=0.02 * t)
    return stats, 1e-3


def ref_fake_measure(key, repetitions):
    stats, first = fake_measure(key, repetitions)
    return RefStats(**stats.as_dict()), first


@pytest.mark.parametrize("arch,slots", [("deepseek-7b", 3),
                                        ("gemma2-27b", 4),
                                        ("mamba2-2.7b", 2)])
def test_step_cost_model_equals_the_reference_on_injected_measurements(
        arch, slots):
    import repro.configs as ref_configs
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    ref_session = RefSession(suite=RefSuite(
        repetitions=4, cache_bytes=CACHE, measure_fn=ref_fake_measure))
    session = PredictorSession(suite=MicroBenchmarkSuite(
        repetitions=4, cache_bytes=CACHE, measure_fn=fake_measure))
    want = ref_session.step_cost_model(ref_cfg, slots=slots)
    got = session.step_cost_model(cfg, slots=slots)
    assert sorted(got.tick_s) == sorted(want.tick_s)
    np.testing.assert_allclose([got.tick_s[k] for k in sorted(got.tick_s)],
                               [want.tick_s[k] for k in sorted(want.tick_s)],
                               rtol=REL, atol=0)
    assert (got.slots, got.n_benchmarks) == (want.slots, want.n_benchmarks)
    assert serve.scheduler.step_kernel_sizes(cfg, slots) == \
        ref_serve.scheduler.step_kernel_sizes(ref_cfg, slots)
    sched = session.guided_scheduler(cfg, slots=slots, window=2,
                                     max_defer=5)
    assert isinstance(sched, serve.ModelGuidedScheduler)
    assert (sched.window, sched.max_defer) == (2, 5)
    assert sched.model.tick_s == got.tick_s
    assert sched.model.n_benchmarks == 0       # every key measured above
