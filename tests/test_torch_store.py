"""The port's platform model store against the JAX package's.

``repro_torch.store`` is held against ``repro.store`` on the CPU.  Both
packages measure through the reference tests' deterministic
``fake_measure`` (``tests/test_store.py``) at a 32 MiB cache capacity, so
every equality here is exact:

* the reference's store tests, mirrored on the port (persistence, the
  schema, fingerprint and protocol gates, warm start with zero fresh
  measurements and bit-identical rankings, drift, tournament);
* across the packages: a store the reference saved is refused on its
  fingerprint, and with ``allow_mismatch`` warm-starts a port session
  that ranks bit-for-bit like the reference session (numpy) and at rtol
  1e-12 (the torch backend on the CPU); the port's payload reads back in
  the reference bit-exactly; drift readings, tournament scoreboards,
  Kendall tau and the frozen workloads agree;
* the card's gates: a fingerprint differing only in the device name,
  compute capability or L2 is refused, and so is a store whose
  ``cache_bytes`` is not the running card's L2 (a CUDA fingerprint is
  passed in, as no card is here);
* a warm-started session ranks the three CUDA kernels' tiles
  bit-identically to the in-memory session, with no sweep and no memcpy
  probe.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.common import catalog_synthetic_model_set  # noqa: E402
from repro.core.sampler import Stats as RefStats  # noqa: E402
from repro.store import ModelStore as RefModelStore  # noqa: E402
from repro.store import DriftProbe as RefDriftProbe  # noqa: E402
from repro.store import Snapshot as RefSnapshot  # noqa: E402
from repro.store import frozen_workloads as ref_frozen  # noqa: E402
from repro.store import kendall_tau as ref_kendall_tau  # noqa: E402
from repro.store import run_tournament as ref_run_tournament  # noqa: E402
from repro.tc import PredictorSession as RefSession  # noqa: E402
from repro.tc.suite import MicroBenchmarkSuite as RefSuite  # noqa: E402
from repro_torch.convert import (model_set_from_reference,  # noqa: E402
                                 store_from_reference)
from repro_torch.core import PredictionEngine, compile_calls  # noqa: E402
from repro_torch.core.fitting import fit_relative  # noqa: E402
from repro_torch.core.grids import Domain  # noqa: E402
from repro_torch.core.model import PerformanceModel, Piece  # noqa: E402
from repro_torch.core.sampler import STATS, Stats  # noqa: E402
from repro_torch.dla.tracers import ALL_TRACERS  # noqa: E402
from repro_torch.perf.tile_tuner import rank_tiles  # noqa: E402
from repro_torch.store import (DEVICE_MODEL_SET, SCHEMA_VERSION,  # noqa: E402
                               DriftProbe, ModelStore, PlatformFingerprint,
                               Snapshot, StoreMismatchError,
                               current_fingerprint, frozen_workloads,
                               kendall_tau, run_tournament, workload)
from repro_torch.tc import (DEVICE_KERNELS, MicroBenchmark,  # noqa: E402
                            MicroBenchmarkSuite, PredictorSession)

torch.set_num_threads(1)

CACHE = 32 * 2 ** 20
REL = 1e-12
CPU = "cpu"
SPEC = "bij,bjk->bik"
SIZES = dict(b=4, i=16, j=16, k=16)
CHAIN = "ab,bc,cd->ad"
CHAIN_SIZES = dict(a=8, b=8, c=8, d=8)
SWEEP_GRID = [dict(SIZES, b=b) for b in (4, 8)]


def fake_measure(key, repetitions):
    """tests/test_store.py's deterministic function of the key."""
    t = 1e-9 * key.call_bytes + 2e-6 + 5e-7 * key.classes.count("cold")
    return Stats(0.95 * t, t, 1.1 * t, 1.01 * t, 0.02 * t), 1e-3


def scaled_measure(factor, measure=fake_measure):
    """A measure_fn reading ``factor``x slower than ``measure``."""
    def fn(key, repetitions):
        s, first = measure(key, repetitions)
        return type(s)(s.min * factor, s.med * factor, s.max * factor,
                       s.mean * factor, s.std * factor), first
    return fn


def protocol_measure(key, repetitions):
    """fake_measure, off by a key-dependent factor that shrinks with the
    repetitions: a cheaper protocol reads noisier (and reorders keys)."""
    s, first = fake_measure(key, repetitions)
    f = 1.0 + 0.9 * ((key.call_bytes // 4) % 7) / 7 / repetitions
    return Stats(s.min * f, s.med * f, s.max * f, s.mean * f, s.std), first


def as_ref(measure):
    def fn(key, repetitions):
        s, first = measure(key, repetitions)
        return RefStats(**s.as_dict()), first
    return fn


def fake_suite(measure=fake_measure, **kw):
    return MicroBenchmarkSuite(cache_bytes=CACHE, measure_fn=measure,
                               device=CPU, **kw)


def fake_session(**kw):
    return PredictorSession(suite=fake_suite(), **kw)


def ref_fake_session(measure=fake_measure, **kw):
    return RefSession(suite=RefSuite(measure_fn=as_ref(measure),
                                     cache_bytes=CACHE, **kw))


def rank_everything(sess):
    """Contraction + chain + sweep rankings as (name, stats dict) pairs,
    comparable across the two packages' Stats classes."""
    def rows(ranked):
        return [(r.name, r.runtime.as_dict()) for r in ranked]
    return (rows(sess.rank_contraction_algorithms(SPEC, SIZES)),
            rows(sess.rank_einsum_paths(CHAIN, CHAIN_SIZES,
                                        max_loop_perms=2)),
            [rows(r) for r in sess.rank_contraction_sweep(
                SPEC, SWEEP_GRID).rankings])


def assert_rankings_close(mine, theirs):
    """Names in order and every statistic at rtol 1e-12."""
    for m, t in zip(mine[:2] + tuple(mine[2]), theirs[:2] + tuple(theirs[2])):
        assert [n for n, _ in m] == [n for n, _ in t]
        for s in STATS:
            np.testing.assert_allclose([d[s] for _, d in m],
                                       [d[s] for _, d in t],
                                       rtol=REL, atol=0)


def key_tuple(k):
    return (k.equation, tuple(k.a_shape), tuple(k.b_shape),
            tuple(k.out_shape), tuple(k.classes),
            None if k.config is None else tuple(k.config))


def records(measurements):
    return {key_tuple(k): (mb.stats.as_dict(), mb.first, mb.seconds)
            for k, mb in measurements.items()}


def as_json(obj):
    return json.dumps(obj, sort_keys=True)


def card_fingerprint(**changes):
    """A CUDA platform's fingerprint on this host (no card is here)."""
    return dataclasses.replace(
        current_fingerprint(device=CPU), backend="cuda",
        device_kind="NVIDIA H100 80GB HBM3", compute_capability="9.0",
        cuda_runtime="12.4", driver_version="12040",
        l2_cache_bytes=50 * 2 ** 20, **changes)


# ------------------------------------------------------------- round trip --

def test_store_round_trips_measurements_exactly(tmp_path):
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    store = sess.save_store()
    path = tmp_path / "store.json"
    store.save(path)
    loaded = ModelStore.load(path, fingerprint=store.fingerprint,
                             device=CPU)
    assert loaded.measurements == store.measurements
    assert loaded.suite_meta == store.suite_meta
    assert loaded.fingerprint == store.fingerprint
    assert loaded.suite_meta["cache_bytes"] == CACHE


def test_store_refuses_non_finite_measurements():
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    store = ModelStore.from_suite(sess.suite, device=CPU)
    key = next(iter(store.measurements))
    bad = Stats(0.0, float("nan"), 0.0, 0.0, 0.0)
    store.measurements[key] = MicroBenchmark(key=key, stats=bad,
                                             first=0.0, seconds=0.0)
    with pytest.raises(ValueError, match="non-finite"):
        store.to_payload()


def test_suite_protocol_conflict_on_merge():
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    store = ModelStore.from_suite(sess.suite, device=CPU)
    with pytest.raises(ValueError, match="measurement protocol"):
        store.add_suite(fake_suite(repetitions=3))


# ------------------------------------------------------- refusal to load --

def test_fingerprint_mismatch_refuses_and_lists_fields(tmp_path):
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    path = tmp_path / "store.json"
    sess.save_store(path)
    other = PlatformFingerprint(
        cpu="other-cpu", cores=1, backend="other", device_kind="other",
        compute_capability="other", cuda_runtime="other",
        driver_version="other", l2_cache_bytes=1, libraries="other",
        dtype="float64", repro_version="0.0.0")
    with pytest.raises(StoreMismatchError) as err:
        ModelStore.load(path, fingerprint=other, device=CPU)
    for field in ("cpu", "backend", "dtype", "compute_capability",
                  "driver_version"):
        assert field in str(err.value)
    # the escape hatch loads anyway, keeping the STORED fingerprint
    loaded = ModelStore.load(path, fingerprint=other, allow_mismatch=True,
                             device=CPU)
    assert loaded.n_keys == len(sess.suite.results)
    assert loaded.fingerprint == current_fingerprint(device=CPU)


def test_schema_bump_refuses_even_with_allow_mismatch(tmp_path):
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    path = tmp_path / "store.json"
    sess.save_store(path)
    payload = json.loads(path.read_text())
    assert payload["schema_version"] == SCHEMA_VERSION
    payload["schema_version"] = SCHEMA_VERSION + 1
    path.write_text(json.dumps(payload))
    with pytest.raises(StoreMismatchError, match="schema_version"):
        ModelStore.load(path, device=CPU)
    with pytest.raises(StoreMismatchError, match="schema_version"):
        ModelStore.load(path, allow_mismatch=True, device=CPU)


def test_session_store_and_suite_are_exclusive():
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    store = sess.save_store()
    with pytest.raises(ValueError, match="store= or suite="):
        PredictorSession(store=store, suite=fake_suite(), device=CPU)
    with pytest.raises(ValueError, match="repetitions"):
        PredictorSession(store=store, repetitions=3, device=CPU)
    PredictorSession(store=store, repetitions=5, device=CPU)


def test_store_and_session_need_a_device():
    """No card and no ``device="cpu"``: the store and a warm start raise
    rather than fingerprint the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelStore()
    with pytest.raises(RuntimeError, match="CUDA"):
        current_fingerprint()
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    store = sess.save_store()
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictorSession(store=store)
    with pytest.raises(RuntimeError, match="CUDA"):
        store.build_suite()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_tournament([Snapshot("a", store), Snapshot("b", store)])


# ---------------------------------------------------------- warm start --

def test_warm_started_rankings_bit_identical_with_zero_measurements(
        tmp_path):
    sess = fake_session()
    in_memory = rank_everything(sess)
    path = tmp_path / "store.json"
    sess.save_store(path)
    warm = PredictorSession(store=str(path), device=CPU)
    warm_rankings = rank_everything(warm)
    counters = warm.counters()
    assert counters["measured"] == 0, "warm start must not re-measure"
    assert counters["loaded"] == len(sess.suite.results)
    assert warm_rankings == in_memory
    # and on the torch backend over the same store
    warm_torch = PredictorSession(store=str(path), backend="torch",
                                  device=CPU)
    assert_rankings_close(rank_everything(warm_torch), in_memory)
    assert warm_torch.counters()["measured"] == 0


def test_warm_start_amortized_cost_accounting():
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    store = sess.save_store()
    warm = PredictorSession(store=store, device=CPU)
    warm.rank_contraction_algorithms(SPEC, SIZES)
    suite = warm.suite
    assert suite.cost_seconds == 0.0
    assert suite.loaded_cost_seconds > 0.0
    assert suite.cost_fraction(1.0) == 0.0
    assert suite.cost_fraction(1.0, include_loaded=True) == \
        pytest.approx(suite.loaded_cost_seconds)


def test_counters_partition_by_provenance():
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    store = sess.save_store()
    warm = PredictorSession(store=store, device=CPU)
    warm.suite.measure_fn = fake_measure
    c = warm.counters()
    assert c["loaded"] == len(store.measurements) and c["measured"] == 0
    warm.rank_contraction_algorithms("ij,jk->ik", dict(i=8, j=8, k=8))
    c = warm.counters()
    assert c["measured"] > 0
    key = sorted(store.measurements, key=str)[0]
    warm.suite.refresh(key)
    c = warm.counters()
    assert c["refreshed"] == 1
    assert c["loaded"] == len(store.measurements) - 1
    assert c["loaded"] + c["measured"] + c["refreshed"] == c["n_benchmarks"]
    warm.suite.refresh(key)
    assert warm.counters()["refreshed"] == 1


def test_parametric_models_ride_along_and_switch_parametric_on(tmp_path):
    sess = PredictorSession(suite=fake_suite(), parametric=True)
    grid = [dict(SIZES, b=b) for b in (4, 8, 16)]
    in_memory = [[(r.name, r.runtime) for r in ranking] for ranking in
                 sess.rank_contraction_sweep(SPEC, grid).rankings]
    assert sess.parametric.models
    path = tmp_path / "store.json"
    sess.save_store(path)
    warm = PredictorSession(store=path, device=CPU)
    assert warm.parametric is not None
    assert set(warm.parametric.models) == set(sess.parametric.models)
    warm_rank = [[(r.name, r.runtime) for r in ranking] for ranking in
                 warm.rank_contraction_sweep(SPEC, grid).rankings]
    assert warm_rank == in_memory
    assert warm.counters()["measured"] == 0


# ----------------------------------------------------------------- drift --

def test_drift_probe_ratios_and_threshold():
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    probe = DriftProbe(sess.suite, max_keys=4, threshold=1.5,
                       measure_fn=scaled_measure(2.0))
    readings = probe.probe()
    assert 0 < len(readings) <= 4
    for r in readings:
        assert r.ratio == pytest.approx(2.0)
    assert len(probe.stale()) == len(readings)
    assert probe.max_ratio() == pytest.approx(2.0)
    lax = DriftProbe(sess.suite, max_keys=4, threshold=2.5,
                     measure_fn=scaled_measure(2.0))
    assert lax.stale() == []
    fast = DriftProbe(sess.suite, max_keys=4, threshold=1.5,
                      measure_fn=scaled_measure(0.4))
    assert len(fast.stale()) == len(fast.probe())


def test_drift_probe_subset_is_deterministic():
    sess = fake_session()
    rank_everything(sess)
    assert len(sess.suite.results) > 6
    a = DriftProbe(sess.suite, max_keys=6).keys()
    b = DriftProbe(sess.suite, max_keys=6).keys()
    assert a == b and len(a) == 6
    assert len(set(a)) == 6


def test_drift_probe_does_not_touch_suite_counters():
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    before = sess.counters()
    DriftProbe(sess.suite, measure_fn=scaled_measure(3.0)).probe()
    assert sess.counters() == before


def test_drift_refresh_repairs_in_place():
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    probe = DriftProbe(sess.suite, max_keys=4, threshold=1.5,
                       measure_fn=scaled_measure(2.0))
    stale_keys = [r.key for r in probe.stale()]
    replaced = probe.refresh()
    assert [mb.key for mb in replaced] == stale_keys
    assert sess.counters()["refreshed"] == len(stale_keys)
    again = DriftProbe(sess.suite, max_keys=4, threshold=1.5,
                       measure_fn=scaled_measure(2.0))
    assert again.stale() == []
    assert sess.suite.measure_fn is fake_measure


def test_session_check_drift_warns_and_refreshes():
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        readings = sess.check_drift(measure_fn=scaled_measure(2.0),
                                    refresh=True)
    assert any("model drift" in str(w.message) for w in caught)
    assert all(r.ratio == pytest.approx(2.0) for r in readings)
    assert sess.counters()["refreshed"] == len(readings)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sess.check_drift(measure_fn=scaled_measure(2.0))
    assert not caught


def test_drift_probe_rejects_degenerate_threshold():
    with pytest.raises(ValueError, match="threshold"):
        DriftProbe(fake_suite(), threshold=1.0)


def test_drift_probe_skips_device_keys():
    sess = _device_session(sweep_fn=_device_sweep, transfer_measure_fn=_xfer)
    _rank_tiles(sess)
    sess.rank_contraction_algorithms(SPEC, SIZES)
    keys = DriftProbe(sess.suite, max_keys=64).keys()
    assert keys and all(k.config is None for k in keys)


# ------------------------------------------------------------ tournament --

def _two_snapshots(tmp_path):
    """A faithful store and a rank-scrambling distorted copy."""
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    faithful = sess.save_store(tmp_path / "faithful.json")
    distorted = ModelStore.load(tmp_path / "faithful.json",
                                fingerprint=faithful.fingerprint,
                                device=CPU)
    for i, key in enumerate(sorted(distorted.measurements, key=str)):
        mb = distorted.measurements[key]
        f = 1.0 + 0.9 * ((i * 7919) % 13) / 13
        s = mb.stats
        distorted.measurements[key] = MicroBenchmark(
            key=key, stats=Stats(s.min * f, s.med * f, s.max * f,
                                 s.mean * f, s.std), first=mb.first,
            seconds=mb.seconds)
    return faithful, distorted


def test_tournament_scores_and_orders_snapshots(tmp_path):
    faithful, distorted = _two_snapshots(tmp_path)
    loads = [workload("contraction", "contraction", SPEC, SIZES)]
    result = run_tournament(
        [Snapshot("distorted", distorted), Snapshot("faithful", faithful)],
        loads, oracle_session=fake_session(), measure_fn=fake_measure,
        device=CPU)
    assert result.scores[0].name == "faithful"
    winner = result.winner
    assert winner.rel_err == 0.0
    assert winner.top1_rate == 1.0
    assert winner.rank_agreement == 1.0
    assert winner.new_benchmarks == 0
    assert result.scores[-1].rel_err > 0.0


def test_tournament_payload_is_schema_stamped(tmp_path):
    faithful, distorted = _two_snapshots(tmp_path)
    loads = [workload("contraction", "contraction", SPEC, SIZES)]
    result = run_tournament(
        [Snapshot("a", faithful), Snapshot("b", distorted)], loads,
        oracle_session=fake_session(), measure_fn=fake_measure, device=CPU)
    path = tmp_path / "TOURNAMENT.json"
    result.save(path)
    payload = json.loads(path.read_text())
    assert payload["schema_version"] == SCHEMA_VERSION
    assert len(payload["scoreboard"]) == 2
    row = payload["scoreboard"][0]
    for field in ("name", "rel_err", "top1_rate", "rank_agreement",
                  "suite_cost_seconds", "new_benchmarks"):
        assert field in row
    assert payload["workloads"] == ["contraction"]


def test_tournament_needs_two_snapshots(tmp_path):
    faithful, _ = _two_snapshots(tmp_path)
    with pytest.raises(ValueError, match="at least 2"):
        run_tournament([Snapshot("only", faithful)], device=CPU)


def test_kendall_tau_reference_values():
    assert kendall_tau("abcd", "abcd") == 1.0
    assert kendall_tau("abcd", "dcba") == -1.0
    assert kendall_tau("abcd", "abdc") == pytest.approx(4 / 6)
    assert kendall_tau("ab", "cd") == 1.0
    assert kendall_tau("a", "a") == 1.0
    for a, b in (("abcdef", "fbdcea"), ("abcde", "xaecb"), ("abc", "cab")):
        assert kendall_tau(a, b) == ref_kendall_tau(a, b)


@pytest.mark.parametrize("smoke", [False, True])
def test_frozen_workloads_equal_the_reference(smoke):
    mine, theirs = frozen_workloads(smoke=smoke), ref_frozen(smoke=smoke)
    assert [dataclasses.astuple(w) for w in mine] == \
        [dataclasses.astuple(w) for w in theirs]
    assert {w.name for w in frozen_workloads(smoke=True)} == \
        {"contraction_smoke", "serving_step_proj"}


# --------------------------------------- model save/load round-trip (io) --

def _quadratic_model(kernel="gemm"):
    """A tiny fitted model whose case is a NESTED tuple, like the tc
    per-signature cases."""
    xs = [[float(n)] for n in range(4, 44, 4)]
    case = ("ab,bc->ac", (8, 8), (8, 8), (8, 8), ("warm", "cold"))
    basis = [(0,), (1,), (2,)]
    m = PerformanceModel(kernel=kernel, setup="test")
    polys = {}
    for j, stat in enumerate(STATS):
        ys = [(1 + 0.1 * j) * (2e-9 * x[0] ** 2 + 1e-6) for x in xs]
        polys[stat] = fit_relative(xs, ys, basis)
    m.add_piece(case, Piece(domain=Domain((4,), (40,)), polys=polys))
    return m, case


def test_performance_model_from_dict_freezes_nested_cases(tmp_path):
    m, case = _quadratic_model()
    path = tmp_path / "model.json"
    m.save(str(path))
    loaded = PerformanceModel.load(str(path))
    assert list(loaded.cases) == [case]
    assert loaded.estimate(case, (16,)) == m.estimate(case, (16,))


def test_performance_model_load_refinalizes_padded_tensors(tmp_path):
    m, case = _quadratic_model()
    m.finalize()
    path = tmp_path / "model.json"
    m.save(str(path))
    loaded = PerformanceModel.load(str(path))
    for got, ref in zip(loaded.cases[case].padded_tensors(),
                        m.cases[case].padded_tensors()):
        np.testing.assert_array_equal(got, ref)


def test_model_set_through_store_predicts_compiled_bit_equal(tmp_path):
    """The reference's catalog model set, carried across, survives the
    port's store bit-exactly: equal ``predict_compiled`` over the whole
    tracer catalog."""
    models = model_set_from_reference(
        catalog_synthetic_model_set().to_dict())
    compiled = compile_calls([tracer(264, 56)
                              for tracer in ALL_TRACERS.values()])
    before = PredictionEngine(models).predict_compiled(compiled)
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    store = sess.save_store()
    store.add_model_set("catalog", models)
    path = tmp_path / "store.json"
    store.save(path)
    loaded = ModelStore.load(path, device=CPU).model_set("catalog")
    assert set(loaded.models) == set(models.models)
    np.testing.assert_array_equal(
        PredictionEngine(loaded).predict_compiled(compiled), before)


def test_model_sets_round_trip_through_store(tmp_path):
    sess = fake_session()
    sess.rank_contraction_algorithms(SPEC, SIZES)
    path = tmp_path / "store.json"
    store = sess.save_store(path)
    assert len(store.model_sets) == 1
    loaded = ModelStore.load(path, fingerprint=store.fingerprint,
                             device=CPU)
    (name, ms), = loaded.model_sets.items()
    assert json.dumps(ms.to_dict(), sort_keys=True) == \
        json.dumps(store.model_set(name).to_dict(), sort_keys=True)


# -------------------------------------------------------- card fingerprint --

def test_cpu_fingerprint_is_stable_and_says_cpu():
    fp = current_fingerprint(device=CPU)
    assert fp == current_fingerprint(device=CPU)
    assert (fp.backend, fp.device_kind, fp.l2_cache_bytes) == \
        ("cpu", "cpu", 0)
    assert fp.libraries == (f"numpy={np.__version__},"
                            f"torch={torch.__version__}")
    assert PlatformFingerprint.from_dict(fp.as_dict()) == fp
    # the default cache capacity of a CPU store is the device's L2: none
    assert ModelStore(device=CPU).suite_meta["cache_bytes"] == 0


@pytest.mark.parametrize("field,value", [
    ("device_kind", "NVIDIA A100-SXM4-80GB"),
    ("compute_capability", "8.0"),
    ("l2_cache_bytes", 40 * 2 ** 20),
])
def test_card_fingerprint_differing_in_one_field_is_refused(tmp_path, field,
                                                            value):
    card = card_fingerprint()
    sess = PredictorSession(suite=MicroBenchmarkSuite(
        cache_bytes=card.l2_cache_bytes, measure_fn=fake_measure,
        device=CPU))
    sess.rank_contraction_algorithms(SPEC, SIZES)
    path = tmp_path / "store.json"
    sess.save_store(path, fingerprint=card)
    assert ModelStore.load(path, fingerprint=card, device=CPU).n_keys
    other = dataclasses.replace(card, **{field: value})
    with pytest.raises(StoreMismatchError) as err:
        ModelStore.load(path, fingerprint=other, device=CPU)
    assert field in str(err.value)
    assert ModelStore.load(path, fingerprint=other, allow_mismatch=True,
                           device=CPU).fingerprint == card


def test_cache_bytes_other_than_the_cards_l2_is_refused(tmp_path):
    card = card_fingerprint()
    sess = fake_session()                   # classes decided at 32 MiB
    sess.rank_contraction_algorithms(SPEC, SIZES)
    path = tmp_path / "store.json"
    sess.save_store(path, fingerprint=card)
    with pytest.raises(StoreMismatchError, match="cache_bytes"):
        ModelStore.load(path, fingerprint=card, device=CPU)
    loaded = ModelStore.load(path, fingerprint=card, allow_mismatch=True,
                             device=CPU)
    assert loaded.suite_meta["cache_bytes"] == CACHE
    # on a CPU platform there is no L2 to hold it against
    cpu_fp = current_fingerprint(device=CPU)
    sess.save_store(path, fingerprint=cpu_fp)
    assert ModelStore.load(path, fingerprint=cpu_fp, device=CPU).n_keys


# ---------------------------------------------------------- cross-package --

def _reference_store(tmp_path):
    """A store saved by repro.store from a reference session (fake
    measurements), with the reference session's rankings."""
    ref = ref_fake_session()
    rankings = rank_everything(ref)
    path = tmp_path / "ref_store.json"
    ref.save_store(path)
    return path, ref, rankings


def test_reference_store_is_refused_on_its_fingerprint(tmp_path):
    path, _, _ = _reference_store(tmp_path)
    with pytest.raises(StoreMismatchError) as err:
        ModelStore.load(path, device=CPU)
    for field in ("libraries", "compute_capability", "cuda_runtime",
                  "driver_version", "l2_cache_bytes"):
        assert field in str(err.value)
    assert "'missing'" in str(err.value)
    with pytest.raises(StoreMismatchError, match="fingerprint"):
        PredictorSession(store=path, device=CPU)
    with pytest.raises(StoreMismatchError, match="fingerprint"):
        store_from_reference(path, device=CPU)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_reference_store_warm_starts_a_port_session(tmp_path, backend):
    path, ref, rankings = _reference_store(tmp_path)
    warm = PredictorSession(store=path, allow_mismatch=True,
                            backend=backend, device=CPU)
    mine = rank_everything(warm)
    assert warm.counters()["measured"] == 0
    assert warm.counters()["loaded"] == len(ref.suite.results)
    if backend == "numpy":
        assert mine == rankings
    else:
        assert_rankings_close(mine, rankings)


def test_store_from_reference_carries_measurements_and_models(tmp_path):
    path, ref, rankings = _reference_store(tmp_path)
    payload = json.loads(path.read_text())
    store = store_from_reference(payload, allow_mismatch=True, device=CPU)
    assert records(store.measurements) == records(ref.suite.results)
    assert store.fingerprint.libraries == payload["fingerprint"]["libraries"]
    assert store.fingerprint.l2_cache_bytes == "missing"
    assert as_json({n: ms.to_dict() for n, ms in store.model_sets.items()}) \
        == as_json(payload["model_sets"])
    warm = PredictorSession(store=store, device=CPU)
    assert rank_everything(warm) == rankings
    assert warm.counters()["measured"] == 0
    # saved by the port, the reference's fingerprint still refuses
    store.save(tmp_path / "carried.json")
    with pytest.raises(StoreMismatchError, match="fingerprint"):
        ModelStore.load(tmp_path / "carried.json", device=CPU)
    bumped = dict(payload, schema_version=SCHEMA_VERSION + 1)
    with pytest.raises(StoreMismatchError, match="schema_version"):
        store_from_reference(bumped, allow_mismatch=True, device=CPU)


def test_port_payload_reads_back_in_the_reference(tmp_path):
    sess = fake_session()
    rank_everything(sess)
    path = tmp_path / "store.json"
    store = sess.save_store(path)
    theirs = RefModelStore.load(path, allow_mismatch=True)
    assert records(theirs.measurements) == records(store.measurements)
    assert theirs.suite_meta == store.suite_meta
    assert as_json({n: ms.to_dict() for n, ms in theirs.model_sets.items()}) \
        == as_json({n: ms.to_dict() for n, ms in store.model_sets.items()})


def test_drift_probes_are_identical_across_packages():
    mine, ref = fake_session(), ref_fake_session()
    rank_everything(mine)
    rank_everything(ref)
    for max_keys in (3, 6, 100):
        assert [key_tuple(k) for k in DriftProbe(
            mine.suite, max_keys=max_keys).keys()] == \
            [key_tuple(k) for k in RefDriftProbe(
                ref.suite, max_keys=max_keys).keys()]
    for factor in (2.0, 1.2, 0.4):
        probe = DriftProbe(mine.suite, max_keys=6,
                           measure_fn=scaled_measure(factor))
        theirs = RefDriftProbe(ref.suite, max_keys=6,
                               measure_fn=as_ref(scaled_measure(factor)))
        assert [(key_tuple(r.key), r.stored_med, r.probed_med, r.ratio)
                for r in probe.probe()] == \
            [(key_tuple(r.key), r.stored_med, r.probed_med, r.ratio)
             for r in theirs.probe()]
        got, want = probe.report(), theirs.report()
        for k in ("probed", "stale", "max_ratio"):
            assert got[k] == want[k]


def test_tournament_scoreboard_equals_the_reference(tmp_path):
    """The fresh store against one measured at repetitions=1, scored on
    the frozen workloads against an injected oracle, in both packages."""
    loads, ref_loads = frozen_workloads(), ref_frozen()

    def port_store(repetitions):
        sess = PredictorSession(suite=fake_suite(
            measure=protocol_measure, repetitions=repetitions))
        for load in loads:
            load.rank(sess)
        return sess.save_store()

    def ref_store(repetitions):
        sess = ref_fake_session(measure=protocol_measure,
                                repetitions=repetitions)
        for load in ref_loads:
            load.rank(sess)
        return sess.save_store()

    mine = run_tournament(
        [Snapshot("rep1", port_store(1)), Snapshot("rep5", port_store(5))],
        loads, oracle_session=fake_session(), measure_fn=fake_measure,
        device=CPU)
    theirs = ref_run_tournament(
        [RefSnapshot("rep1", ref_store(1)), RefSnapshot("rep5",
                                                        ref_store(5))],
        ref_loads, oracle_session=ref_fake_session(),
        measure_fn=as_ref(fake_measure))
    assert [s.name for s in mine.scores] == [s.name for s in theirs.scores]
    assert mine.scores[0].name == "rep5"
    for m, t in zip(mine.scores, theirs.scores):
        np.testing.assert_allclose(
            [m.rel_err, m.top1_rate, m.rank_agreement],
            [t.rel_err, t.top1_rate, t.rank_agreement], rtol=REL, atol=0)
        assert m.new_benchmarks == t.new_benchmarks == 0
        assert m.per_workload.keys() == t.per_workload.keys()
    assert mine.scores[-1].rel_err > 0.0
    assert mine.workloads == theirs.workloads


# --------------------------------------------------- device tile warm start --

def _device_sweep(kernel_name, configs):
    """A deterministic per-call cost: a pure function of the config and
    of the family's proxy step count."""
    kernel = DEVICE_KERNELS[kernel_name]
    out = {}
    for cfg in configs:
        per_step = 2e-7 + 3e-12 * float(np.prod(cfg)) + 4e-9 * sum(cfg)
        t = per_step * kernel.proxy_steps(cfg, 2)
        out[cfg] = (Stats(0.9 * t, t, 1.2 * t, 1.02 * t, 0.05 * t),
                    1e-3, 10.0 * t)
    return out


def _xfer(direction, nbytes, repetitions):
    bw = 20e9 if direction == "h2d" else 10e9
    return [5e-6 + nbytes / bw] * repetitions


def _refuse(*args):
    raise AssertionError("a warm-started session swept or probed")


#: (kernel, problem, configs) of the three tile paths at a small size; the
#: matmul's span both its routes: (64, 64, 32) and (128, 64, 32) on wgmma,
#: the bk-64 tiles on ffma
TILE_PATHS = [
    ("cuda_matmul", (256, 256, 256),
     [(64, 64, 32), (64, 64, 64), (128, 64, 32), (64, 128, 64)]),
    ("cuda_flash_attention", (2, 8, 256, 256, 32),
     [(16, 16, 32), (32, 32, 32), (32, 64, 32), (64, 64, 32)]),
    ("cuda_ssd", (1, 256, 8, 16, 1, 32),
     [(16, 16, 32), (32, 16, 32), (64, 16, 32)]),
]


def _device_session(**kw):
    session = PredictorSession(suite=fake_suite(repetitions=2))
    session.device_suite(device=CPU, steps_per_dim=2, **kw)
    return session


def _rank_tiles(session):
    return {name: session.rank_device_tiles(name, problem, configs)
            for name, problem, configs in TILE_PATHS}


def test_warm_started_tile_rankings_are_bit_identical(tmp_path):
    session = _device_session(sweep_fn=_device_sweep,
                              transfer_measure_fn=_xfer)
    in_memory = _rank_tiles(session)
    tuned = rank_tiles(256, 256, 256, session=session, candidates=(64, 128))
    path = tmp_path / "store.json"
    store = session.save_store(path)
    assert DEVICE_MODEL_SET in store.model_sets
    assert {"cuda_matmul", "cuda_flash_attention", "cuda_ssd",
            "memcpy_h2d", "memcpy_d2h"} <= \
        set(store.device_model_set().models)
    # the matmul's two routes keep a model each
    assert {classes[1] for classes, _ in
            store.device_model_set().models["cuda_matmul"].cases} == \
        {"wgmma", "ffma"}
    warm = PredictorSession(store=path, device=CPU)
    warm.device_suite(device=CPU, steps_per_dim=2, sweep_fn=_refuse,
                      transfer_measure_fn=_refuse)
    assert _rank_tiles(warm) == in_memory
    assert rank_tiles(256, 256, 256, session=warm,
                      candidates=(64, 128)) == tuned
    assert warm.counters()["measured"] == 0
    assert all(r.source == "measured" for ranked in in_memory.values()
               for r in ranked)


def test_warm_tile_rankings_from_models_alone(tmp_path):
    """With the measurements dropped, the stored device models still rank
    every family without a sweep, as the in-memory models do."""
    session = _device_session(sweep_fn=_device_sweep,
                              transfer_measure_fn=_xfer)
    _rank_tiles(session)
    session.save_store(tmp_path / "store.json")
    store = ModelStore.load(tmp_path / "store.json", device=CPU)
    store.measurements = {}
    warm = PredictorSession(store=store, device=CPU)
    warm.device_suite(device=CPU, steps_per_dim=2, sweep_fn=_refuse,
                      transfer_measure_fn=_refuse)
    fresh = PredictorSession(suite=fake_suite(repetitions=2))
    fresh.device_suite(device=CPU, steps_per_dim=2, sweep_fn=_refuse,
                       transfer_measure_fn=_refuse).load_model_set(
        session.device_suite().to_model_set())
    got, want = _rank_tiles(warm), _rank_tiles(fresh)
    assert got == want
    assert {r.source for ranked in got.values() for r in ranked} == \
        {"model"}
    assert warm.counters()["measured"] == 0


# ---------------------------------------------------------------- on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fingerprint's device fields and "
                    "the L2 gate read it (chip_smoke.py phase 11 drives the "
                    "store on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_fingerprint_and_l2_gate_on_the_card(card, tmp_path):
    fp = current_fingerprint()
    assert fp == current_fingerprint(device=card)
    assert fp.backend == "cuda"
    assert fp.device_kind == torch.cuda.get_device_name(card)
    assert fp.l2_cache_bytes == \
        torch.cuda.get_device_properties(card).L2_cache_size
    sess = PredictorSession(suite=MicroBenchmarkSuite(
        measure_fn=fake_measure))
    sess.rank_contraction_algorithms(SPEC, SIZES)
    path = tmp_path / "store.json"
    store = sess.save_store(path)
    assert store.suite_meta["cache_bytes"] == fp.l2_cache_bytes
    warm = PredictorSession(store=path)
    warm.rank_contraction_algorithms(SPEC, SIZES)
    assert warm.counters()["measured"] == 0
    payload = json.loads(path.read_text())
    payload["suite"]["cache_bytes"] = CACHE
    path.write_text(json.dumps(payload))
    with pytest.raises(StoreMismatchError, match="cache_bytes"):
        ModelStore.load(path)
