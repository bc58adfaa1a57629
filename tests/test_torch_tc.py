"""The port's ``tc`` contraction layer against the JAX package's.

Suites, predictors, size sweeps, size-parametric models and einsum chains
of ``repro_torch.tc`` are held against ``repro.tc`` on the CPU.  Both
suites measure through the reference tests' deterministic
``fake_measure`` (``tests/test_tc.py``) at a 32 MiB cache capacity on
both sides, or the port's suite is loaded from the reference's own
measurements through ``convert.suite_from_reference``.  Then the suite
keys and their cache classes, the chain paths, and every ranking — the
batched predictor on the numpy and the torch (``device="cpu"``)
backends, the per-algorithm and per-step oracles, the size sweeps and
the parametric predictions — must be identical in order, with totals at
rtol 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.contractions import ContractionSpec as RefSpec  # noqa: E402
from repro.core.sampler import Stats as RefStats  # noqa: E402
from repro.core.selection import (  # noqa: E402
    select_contraction_algorithm as ref_select_contraction)
from repro.tc import ChainPredictor as RefChainPredictor  # noqa: E402
from repro.tc import ContractionPredictor as RefPredictor  # noqa: E402
from repro.tc import MicroBenchmarkSuite as RefSuite  # noqa: E402
from repro.tc import PredictorSession as RefSession  # noqa: E402
from repro.tc import execute_chain as ref_execute_chain  # noqa: E402
from repro.tc import generate_algorithms as ref_generate  # noqa: E402
from repro_torch.convert import suite_from_reference  # noqa: E402
from repro_torch.core import (PredictionEngine, rank_einsum_paths,  # noqa: E402
                              select_contraction_algorithm,
                              select_einsum_path)
from repro_torch.core.contractions import ContractionSpec  # noqa: E402
from repro_torch.core.model import ModelSet  # noqa: E402
from repro_torch.core.sampler import STATS, Stats  # noqa: E402
from repro_torch.tc import (COLD, WARM, ChainPredictor,  # noqa: E402
                            ChainSpec, ContractionPredictor,
                            MicroBenchmarkSuite, PredictorSession,
                            benchmark_key, execute_chain,
                            execute_chain_reference, generate_algorithms,
                            rank_contraction_sweep, rank_einsum_sweep,
                            validate_algorithms, validate_paths)

torch.set_num_threads(1)

CACHE = 32 * 2 ** 20
REL = 1e-12


def fake_measure(key, repetitions):
    """tests/test_tc.py's deterministic synthetic timing."""
    t = 1e-9 * key.call_bytes + 2e-6 + 5e-7 * key.classes.count("cold")
    stats = Stats(min=0.95 * t, med=t, max=1.1 * t, mean=1.01 * t,
                  std=0.02 * t)
    return stats, 1e-3


def ref_fake_measure(key, repetitions):
    stats, first = fake_measure(key, repetitions)
    return RefStats(**stats.as_dict()), first


def fake_suite(**kw):
    return MicroBenchmarkSuite(repetitions=4, cache_bytes=CACHE,
                               measure_fn=fake_measure, **kw)


def ref_fake_suite(**kw):
    return RefSuite(repetitions=4, cache_bytes=CACHE,
                    measure_fn=ref_fake_measure, **kw)


def records_of(suite):
    """A reference suite's measurements as plain records."""
    return [{"key": {"equation": k.equation, "a_shape": list(k.a_shape),
                     "b_shape": list(k.b_shape),
                     "out_shape": list(k.out_shape),
                     "classes": list(k.classes), "config": k.config},
             "stats": mb.stats.as_dict(), "first": mb.first,
             "seconds": mb.seconds}
            for k, mb in suite.results.items()]


def _key_tuple(k):
    return (k.equation, tuple(k.a_shape), tuple(k.b_shape),
            tuple(k.out_shape), tuple(k.classes), k.config)


def assert_same_ranking(mine, theirs):
    assert [r.name for r in mine] == [r.name for r in theirs]
    for s in STATS:
        np.testing.assert_allclose(
            [getattr(r.runtime, s) for r in mine],
            [getattr(r.runtime, s) for r in theirs], rtol=REL, atol=0)


#: (spec, sizes) the reference's test_tc.py / test_contractions.py /
#: test_parametric.py rank, plus phase 9's two cases at full size (key
#: derivation is arithmetic; with fake_measure nothing runs)
RANKED = [
    ("bij,bjk->bik", dict(b=4, i=16, j=16, k=16)),
    ("bij,bjk->bik", dict(b=2, i=4, j=4, k=4)),
    ("bij,bjk->bik", dict(b=16, i=512, j=512, k=512)),
    ("abc=ai,ibc", dict(a=24, b=20, c=16, i=8)),
    ("abc=ai,ibc", dict(a=512, b=512, c=512, i=8)),
    ("bij,bjk->bik", dict(b=64, i=1024, j=1024, k=1024)),
    ("abc,cd->abd", dict(a=3, b=4, c=5, d=6)),
    ("ij,jk->ik", dict(i=8, j=8, k=8)),
]


# ------------------------------------------------------------ suite keys --

@pytest.mark.parametrize("expr,sizes", RANKED)
def test_suite_keys_and_classes_are_identical(expr, sizes):
    spec, rspec = ContractionSpec.parse(expr), RefSpec.parse(expr)
    from repro.tc import benchmark_key as ref_benchmark_key
    for alg, ralg in zip(generate_algorithms(spec), ref_generate(rspec)):
        for arrival in (None, {"A": COLD}, {"B": COLD}, {"A": WARM}):
            assert _key_tuple(benchmark_key(alg, sizes, CACHE,
                                            arrival=arrival)) == \
                _key_tuple(ref_benchmark_key(ralg, sizes, CACHE,
                                             arrival=arrival))


def test_suite_deduplicates_and_counts_like_the_reference():
    spec = "bij,bjk->bik"
    sizes = dict(b=4, i=16, j=16, k=16)
    mine, theirs = fake_suite(), ref_fake_suite()
    for alg, ralg in zip(generate_algorithms(ContractionSpec.parse(spec)),
                         ref_generate(RefSpec.parse(spec))):
        mine.benchmark(alg, sizes)
        theirs.benchmark(ralg, sizes)
    assert sorted(map(_key_tuple, mine.results)) == \
        sorted(map(_key_tuple, theirs.results))
    mc, tc = mine.counters(), theirs.counters()
    assert set(mc) == set(tc)
    for k in ("requests", "n_benchmarks", "measured", "loaded",
              "refreshed", "predicted_parametric"):
        assert mc[k] == tc[k], k


def test_device_keys_are_refused_per_key():
    suite = fake_suite()
    key = benchmark_key(generate_algorithms(
        ContractionSpec.parse("ij,jk->ik"))[0], dict(i=8, j=8, k=8), CACHE)
    device_key = key.__class__(equation="cuda_matmul", a_shape=(64, 64),
                               b_shape=(64, 64), out_shape=(64, 64),
                               classes=("resident", "resident"),
                               config=(64, 64, 64))
    for call in (suite.measure_key, suite.refresh):
        with pytest.raises(ValueError, match="device"):
            call(device_key)
    assert suite.measure_key(key).key == key


# --------------------------------------------------------------- rankings --

@pytest.mark.parametrize("expr,sizes", RANKED)
def test_predictor_rankings_and_oracle_are_identical(expr, sizes):
    mine = ContractionPredictor(expr, sizes, suite=fake_suite())
    theirs = RefPredictor(expr, sizes, suite=ref_fake_suite())
    ref_rank = theirs.rank()
    assert_same_ranking(mine.rank(), ref_rank)
    assert_same_ranking(mine.rank(backend="torch", device="cpu"), ref_rank)
    assert_same_ranking(mine.rank_oracle(), theirs.rank_oracle())
    assert_same_ranking(mine.rank_oracle(fresh=False), ref_rank)
    assert mine.suite.n_benchmarks == theirs.suite.n_benchmarks
    assert [r.benchmark.classes for r in mine.rank()] == \
        [r.benchmark.classes for r in ref_rank]


@pytest.mark.parametrize("expr,sizes", RANKED[:4])
def test_rankings_from_the_reference_measurements(expr, sizes):
    """The reference measures; the port loads its records and ranks from
    them with zero fresh measurements."""
    theirs = RefPredictor(expr, sizes, suite=ref_fake_suite())
    ref_rank = theirs.rank()

    def refuse(key, repetitions):
        raise AssertionError(f"measured {key}")

    suite = suite_from_reference(records_of(theirs.suite), repetitions=4,
                                 cache_bytes=CACHE, measure_fn=refuse)
    assert suite.loaded == theirs.suite.n_benchmarks and suite.measured == 0
    mine = ContractionPredictor(expr, sizes, suite=suite)
    assert_same_ranking(mine.rank(), ref_rank)
    assert_same_ranking(mine.rank(backend="torch", device="cpu"), ref_rank)
    assert suite.measured == 0


SWEEP_GRID = [dict(b=2, i=8, j=8, k=8), dict(b=4, i=8, j=8, k=8),
              dict(b=8, i=8, j=8, k=8)]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_size_sweep_is_identical(backend):
    sweep = rank_contraction_sweep(
        "bij,bjk->bik", SWEEP_GRID, suite=fake_suite(), backend=backend,
        device="cpu" if backend == "torch" else None)
    ref_sweep = RefSession(suite=ref_fake_suite()).rank_contraction_sweep(
        "bij,bjk->bik", SWEEP_GRID)
    for mine, theirs in zip(sweep.rankings, ref_sweep.rankings):
        assert_same_ranking(mine, theirs)
    assert sweep.n_benchmarks == ref_sweep.n_benchmarks
    for sizes, ranking in zip(SWEEP_GRID, sweep.rankings):
        oracle = ContractionPredictor("bij,bjk->bik", sizes,
                                      suite=fake_suite()).rank_oracle()
        assert_same_ranking(ranking, oracle)


def test_session_and_selection_entry_points_are_identical():
    spec, sizes = "bij,bjk->bik", dict(b=2, i=4, j=4, k=4)
    mine = PredictorSession(suite=fake_suite())
    torch_s = PredictorSession(backend="torch", device="cpu",
                               suite=mine.suite, cache=mine.cache)
    theirs = RefSession(suite=ref_fake_suite())
    ref_rank = theirs.rank_contraction_algorithms(spec, sizes)
    assert_same_ranking(mine.rank_contraction_algorithms(spec, sizes),
                        ref_rank)
    assert_same_ranking(torch_s.rank_contraction_algorithms(spec, sizes),
                        ref_rank)
    assert select_contraction_algorithm(spec, sizes, session=mine) == \
        ref_select_contraction(spec, sizes, session=theirs) == \
        torch_s.select_contraction_algorithm(spec, sizes)
    oracle = mine.contraction_predictor(spec, sizes).rank_oracle()
    assert_same_ranking(oracle, ref_rank)
    counters = mine.counters()
    assert counters["trace_misses"] > 0
    assert counters["measured"] == mine.suite.n_benchmarks


# ----------------------------------------------------------------- chains --

CHAINS = [
    ("ij,jk,kl->il", {i: 8 for i in "ijkl"}),
    ("ij,jk,kl,lm->im", {i: 8 for i in "ijklm"}),
    ("ij,ij,ij->ij", {i: 4 for i in "ij"}),
    ("bi,bj,bk->ijk", dict(b=4, i=3, j=5, k=2)),
    ("ab,bc,cd->ad", dict(a=8, b=8, c=32, d=8)),
    ("aij,ijb,bkl,klc->ac", dict(a=2, b=2, c=2, i=3, j=3, k=3, l=3)),
]
#: the chains with candidate algorithms at every step (an elementwise
#: product such as ij,ij->ij has no §6.1 kernel, in either package)
RANKED_CHAINS = [c for c in CHAINS if c[0] != "ij,ij,ij->ij"]


def _paths(pred):
    return [(p.name, [(s.spec.a_idx, s.spec.b_idx, s.spec.out_idx,
                       s.inputs) for s in p.steps]) for p in pred.paths]


@pytest.mark.parametrize("expr,sizes", CHAINS)
@pytest.mark.parametrize("limit", [None, 8 * 64, 2 ** 20])
def test_chain_paths_are_identical(expr, sizes, limit):
    def build(cls, suite):
        try:
            return cls(expr, sizes, suite=suite, memory_limit_bytes=limit)
        except ValueError as e:
            return str(e)

    mine = build(ChainPredictor, fake_suite())
    theirs = build(RefChainPredictor, ref_fake_suite())
    if isinstance(theirs, str):
        assert isinstance(mine, str)
        return
    assert _paths(mine) == _paths(theirs)
    for path, rpath in zip(mine.paths, theirs.paths):
        assert path.intermediate_bytes(sizes) == \
            rpath.intermediate_bytes(sizes)
        for step, rstep in zip(path.steps, rpath.steps):
            assert mine.arrival_classes(step) == \
                theirs.arrival_classes(rstep)


def test_memory_limit_excludes_the_huge_pairing_at_full_size():
    """Phase 9's chain at full size: the 8 GiB limit drops every path
    through ijb,bkl (a 64 TiB intermediate) without measuring a thing."""
    sizes = dict(a=16, b=16, c=16, i=2048, j=2048, k=2048, l=2048)
    expr = "aij,ijb,bkl,klc->ac"
    mine = ChainPredictor(expr, sizes, suite=fake_suite(),
                          memory_limit_bytes=8 * 2 ** 30)
    theirs = RefChainPredictor(expr, sizes, suite=ref_fake_suite(),
                               memory_limit_bytes=8 * 2 ** 30)
    assert _paths(mine) == _paths(theirs)
    assert 0 < len(mine.paths) < len(ChainSpec.parse(expr).paths())
    for path in mine.paths:
        assert all({s.spec.a_idx, s.spec.b_idx} != {"ijb", "bkl"}
                   for s in path.steps)
    assert mine.suite.n_benchmarks == 0


@pytest.mark.parametrize("expr,sizes", RANKED_CHAINS)
def test_chain_rankings_and_oracle_are_identical(expr, sizes):
    mine = ChainPredictor(expr, sizes, suite=fake_suite())
    theirs = RefChainPredictor(expr, sizes, suite=ref_fake_suite())
    ref_rank = theirs.rank_paths()
    assert_same_ranking(mine.rank_paths(), ref_rank)
    assert_same_ranking(mine.rank_paths(backend="torch", device="cpu"),
                        ref_rank)
    assert_same_ranking(mine.rank_paths_oracle(),
                        theirs.rank_paths_oracle())
    for r, rr in zip(mine.rank_paths(), ref_rank):
        assert [s.name for s in r.steps] == [s.name for s in rr.steps]


def test_chain_sweep_and_selection_are_identical():
    grid = [{i: n for i in "ijkl"} for n in (4, 6, 8)]
    mine = PredictorSession(suite=fake_suite())
    theirs = RefSession(suite=ref_fake_suite())
    sweep = mine.rank_einsum_sweep("ij,jk,kl->il", grid)
    ref_sweep = theirs.rank_einsum_sweep("ij,jk,kl->il", grid)
    for a, b in zip(sweep.rankings, ref_sweep.rankings):
        assert_same_ranking(a, b)
    torch_sweep = rank_einsum_sweep("ij,jk,kl->il", grid,
                                    suite=fake_suite(), backend="torch",
                                    device="cpu")
    for a, b in zip(torch_sweep.rankings, ref_sweep.rankings):
        assert_same_ranking(a, b)
    for sizes, ranking in zip(grid, sweep.rankings):
        oracle = mine.chain_predictor("ij,jk,kl->il",
                                      sizes).rank_paths_oracle()
        assert_same_ranking(ranking, oracle)
    assert rank_einsum_paths("ij,jk,kl->il", grid[0],
                             session=mine)[0].name == \
        select_einsum_path("ij,jk,kl->il", grid[0], session=mine).name == \
        theirs.select_einsum_path("ij,jk,kl->il", grid[0]).name


def test_execute_chain_matches_reference_and_einsum():
    sizes = {i: 6 for i in "ijklm"}
    expr = "ij,jk,kl,lm->im"
    mine = ChainPredictor(expr, sizes, suite=fake_suite())
    theirs = RefChainPredictor(expr, sizes, suite=ref_fake_suite())
    best, rbest = mine.rank_paths()[0], theirs.rank_paths()[0]
    rng = np.random.default_rng(11)
    ops = [rng.standard_normal([sizes[i] for i in idx]).astype(np.float32)
           for idx in ChainSpec.parse(expr).operands]
    got = execute_chain(mine.chain, best, ops, sizes, device="cpu").numpy()
    want = np.einsum(expr, *ops)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got, ref_execute_chain(theirs.chain, rbest, ops, sizes),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        execute_chain_reference(mine.chain, ops, device="cpu").numpy(),
        want, rtol=2e-4, atol=2e-4)
    validate_paths(expr, sizes, device="cpu")


def test_validate_algorithms_on_cpu():
    spec = ContractionSpec.parse("bij,bjk->bik")
    validate_algorithms(spec, generate_algorithms(spec),
                        dict(b=3, i=4, j=5, k=6),
                        rng=np.random.default_rng(7), device="cpu")


# ------------------------------------------------------------- parametric --

SPEC = "bij,bjk->bik"
REFINE_GRID = [dict(b=8, i=i, j=64, k=64) for i in (32, 96)]
HOLDOUTS = [dict(b=8, i=i, j=64, k=64) for i in (40, 56)]


def _refined(session_cls, suite):
    sess = session_cls(suite=suite, parametric=True)
    sess.refine_parametric(SPEC, REFINE_GRID)
    return sess


def test_parametric_holdouts_predict_identically_without_measuring():
    mine = _refined(PredictorSession, fake_suite())
    theirs = _refined(RefSession, ref_fake_suite())
    assert mine.parametric.n_signatures == theirs.parametric.n_signatures
    assert mine.suite.measured == theirs.suite.measured
    before = mine.suite.counters()
    sweep = mine.rank_contraction_sweep(SPEC, HOLDOUTS)
    ref_sweep = theirs.rank_contraction_sweep(SPEC, HOLDOUTS)
    assert mine.suite.counters()["measured"] == before["measured"]
    assert sweep.predicted_parametric == ref_sweep.predicted_parametric > 0
    for a, b in zip(sweep.rankings, ref_sweep.rankings):
        assert_same_ranking(a, b)
    # the exact-shape oracle stays apart from the predictions
    for sizes, ranking in zip(HOLDOUTS, sweep.rankings):
        oracle = mine.contraction_predictor(SPEC, sizes).rank_oracle()
        assert oracle[0].runtime.med == pytest.approx(
            ranking[0].runtime.med, rel=1e-6)
    # the fitted models carry across in the shared dict form
    ms = ModelSet.from_dict(theirs.parametric.to_model_set().to_dict())
    fresh = PredictorSession(suite=fake_suite(), parametric=True)
    assert fresh.parametric.load_model_set(ms) == \
        theirs.parametric.n_signatures
    warm = fresh.rank_contraction_sweep(SPEC, HOLDOUTS)
    assert fresh.suite.measured == 0
    for a, b in zip(warm.rankings, ref_sweep.rankings):
        assert_same_ranking(a, b)
    assert mine.parametric.to_model_set().to_dict() == \
        theirs.parametric.to_model_set().to_dict()


# --------------------------------------------------------------- dispatch --

def test_dispatch_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictorSession(backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictionEngine(ModelSet(), backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContractionPredictor("ij,jk->ik", dict(i=4, j=4, k=4),
                             suite=fake_suite()).rank(backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        MicroBenchmarkSuite().cache_bytes
    for backend in ("jax", "cuda"):
        with pytest.raises(ValueError, match="backend"):
            PredictorSession(backend=backend)
        with pytest.raises(ValueError, match="backend"):
            PredictionEngine(ModelSet(), backend=backend)
    with pytest.raises(ValueError, match="device"):
        PredictionEngine(ModelSet(), device="cpu")
    # a warm start fingerprints its platform: the card by default
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictorSession(store="store.json")
    with pytest.raises(ValueError, match="repetitions"):
        PredictorSession(suite=fake_suite(), repetitions=3)


def test_shared_memory_class_names_are_re_exported():
    """The counterparts of ``repro.tc``'s lazy ``vmem_class`` / ``RESIDENT``
    / ``TIGHT``: the same objects as ``repro_torch.tc.device``'s."""
    import repro.tc as ref_tc
    import repro_torch.tc as tc
    from repro_torch.tc import device
    for name in ("smem_class", "RESIDENT", "TIGHT"):
        assert getattr(tc, name) is getattr(device, name)
        assert name in tc.__all__
    assert (tc.RESIDENT, tc.TIGHT) != (None, None)
    for name in ("vmem_class", "RESIDENT", "TIGHT"):
        assert name in ref_tc.__all__
    limit = device.H100_SMEM_OPTIN
    assert tc.smem_class(limit // 2, limit) == tc.RESIDENT
    assert tc.smem_class(limit // 2 + 1, limit) == tc.TIGHT


# ---------------------------------------------------------------- on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the torch backend's default device "
                    "(chip_smoke.py runs it on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_torch_backend_on_the_card_ranks_like_numpy(card):
    expr, sizes = RANKED[4]
    mine = ContractionPredictor(expr, sizes, suite=fake_suite())
    ranked = mine.rank()
    on_card = mine.rank(backend="torch", device=card)
    assert [r.name for r in on_card] == [r.name for r in ranked]
    np.testing.assert_allclose(mine.predict("torch", card),
                               mine.predict("numpy"), rtol=REL, atol=0)
