"""Predictions and selections from models carried over from the reference.

The synthetic model sets of ``benchmarks.common`` are built by the JAX
package, converted through ``repro_torch.convert.model_set_from_reference``
and must predict what the reference's numpy backend predicts to rel 1e-10,
with identical rankings and argmins, over the whole tracer catalog.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.common import (catalog_synthetic_model_set,  # noqa: E402
                               synthetic_model_set)
from repro.core import ModelSet as RefModelSet  # noqa: E402
from repro.core import PredictionEngine as RefEngine  # noqa: E402
from repro.core import optimize_algorithm_and_block_size as ref_joint  # noqa: E402
from repro.core import optimize_block_size as ref_optimize  # noqa: E402
from repro.core import predict_runtime as ref_predict  # noqa: E402
from repro.core import rank_algorithms as ref_rank  # noqa: E402
from repro.dla import tracers as ref_tracers  # noqa: E402
from repro_torch.convert import model_set_from_reference  # noqa: E402
from repro_torch.core import (ModelSet, PredictionEngine,  # noqa: E402
                              optimize_algorithm_and_block_size,
                              optimize_block_size, performance_yield,
                              predict_runtime, rank_algorithms,
                              select_algorithm)
from repro_torch.core.sampler import STATS  # noqa: E402
from repro_torch.dla import tracers  # noqa: E402

torch.set_num_threads(1)

REL = 1e-10
N = 264
CANDIDATES = [8 * i for i in range(2, 17)]


@pytest.fixture(scope="module")
def catalog():
    ref = catalog_synthetic_model_set()
    return ref, model_set_from_reference(ref.to_dict())


@pytest.fixture(scope="module")
def default_set():
    ref = synthetic_model_set()
    return ref, model_set_from_reference(ref.to_dict())


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=REL, atol=0.0)


def test_conversion_round_trips_the_dict_form(catalog):
    ref, mine = catalog
    assert mine.to_dict() == json.loads(json.dumps(ref.to_dict()))
    with pytest.raises(ValueError):
        model_set_from_reference({"kernels": []})


def test_json_files_load_in_either_package(tmp_path, default_set):
    ref, mine = default_set
    ref.save(str(tmp_path / "ref.json"))
    mine.save(str(tmp_path / "port.json"))
    assert ModelSet.load(str(tmp_path / "ref.json")).to_dict() == \
        mine.to_dict()
    assert RefModelSet.load(str(tmp_path / "port.json")).to_dict() == \
        ref.to_dict()


@pytest.mark.parametrize("b", [56, 40])
def test_predict_runtime_matches_on_catalog(catalog, b):
    ref, mine = catalog
    for name, tracer in tracers.ALL_TRACERS.items():
        got = predict_runtime(tracer(N, b), mine)
        want = ref_predict(ref_tracers.ALL_TRACERS[name](N, b), ref)
        _close([getattr(got, s) for s in STATS],
               [getattr(want, s) for s in STATS])


def test_engine_sweeps_and_grids_match(catalog):
    ref, mine = catalog
    eng, ref_eng = PredictionEngine(mine), RefEngine(ref, backend="numpy")
    for name, tracer in tracers.ALL_TRACERS.items():
        ref_tracer = ref_tracers.ALL_TRACERS[name]
        _close(eng.sweep(tracer, N, CANDIDATES),
               ref_eng.sweep(ref_tracer, N, CANDIDATES))
        _close(eng.grid(tracer, [128, 200], [24, 48]),
               ref_eng.grid(ref_tracer, [128, 200], [24, 48]))
        compiled = eng.compile_sweep(tracer, N, CANDIDATES)
        _close(eng.predict_compiled(compiled),
               eng.predict_compiled_grouped(compiled))
    assert eng.cache.hits > 0          # the grouped oracle reused the batch


@pytest.mark.parametrize("catalog_name", ["CHOLESKY_TRACERS",
                                          "TRTRI_TRACERS",
                                          "SYLVESTER_TRACERS"])
def test_rankings_identical(catalog, catalog_name):
    ref, mine = catalog
    cat = getattr(tracers, catalog_name)
    ref_cat = getattr(ref_tracers, catalog_name)
    for batched in (True, False):
        got = rank_algorithms(cat, mine, N, 48, batched=batched)
        want = ref_rank(ref_cat, ref, N, 48, batched=batched)
        assert [r.name for r in got] == [r.name for r in want]
        _close([r.runtime.med for r in got], [r.runtime.med for r in want])
    assert select_algorithm(cat, mine, N, 48) == \
        select_algorithm(cat, mine, N, 48, batched=False)


@pytest.mark.parametrize("batched", [True, False])
def test_block_size_argmins_identical(default_set, batched):
    ref, mine = default_set
    for name in ("potrf1", "potrf2", "potrf3", "trtri3", "trtri5"):
        b, profile = optimize_block_size(tracers.ALL_TRACERS[name], mine,
                                         N, CANDIDATES, batched=batched)
        rb, rprofile = ref_optimize(ref_tracers.ALL_TRACERS[name], ref, N,
                                    CANDIDATES, batched=batched)
        assert b == rb
        _close([profile[c] for c in CANDIDATES],
               [rprofile[c] for c in CANDIDATES])
    got = optimize_algorithm_and_block_size(tracers.CHOLESKY_TRACERS, mine,
                                            N, CANDIDATES, batched=batched)
    want = ref_joint(ref_tracers.CHOLESKY_TRACERS, ref, N, CANDIDATES,
                     batched=batched)
    assert got[:2] == want[:2]
    _close(got[2], want[2])


def test_performance_yield():
    measured = {32: 2.0, 64: 1.0, 96: 1.25}
    assert performance_yield(measured, 96) == (64, 0.8)


# -------------------------------------------------- perf.predictor batched --

def _ref_random_model(rng, kernel):
    """tests/test_batched_predict.py's ``_random_model`` (two dims, three
    pieces, case ("C",)), built with the reference's classes."""
    from repro.core import (Domain, PerformanceModel, Piece, fit_relative,
                            monomial_basis)
    m = PerformanceModel(kernel=kernel)
    edges = np.sort(rng.integers(2, 64, size=2)) * 8
    bounds = [8] + [int(e) + 8 for e in edges] + [600]
    for i in range(3):
        dom = Domain((bounds[i], 8), (bounds[i + 1], 512))
        axes = [np.linspace(lo, hi, 5) for lo, hi in zip(dom.lo, dom.hi)]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"),
                       axis=-1).reshape(-1, 2)
        coef = rng.uniform(1e-10, 1e-8)
        const = rng.uniform(1e-7, 1e-5)
        vals = coef * np.prod(pts, axis=1) * pts[:, 0] + const
        basis = monomial_basis([(2, 1)])
        polys = {s: fit_relative(pts, vals * f, basis)
                 for s, f in (("min", 0.95), ("med", 1.0), ("max", 1.1),
                              ("mean", 1.01))}
        polys["std"] = fit_relative(pts, np.full(len(pts), const * 0.05),
                                    [(0, 0)])
        m.add_piece(("C",), Piece(domain=dom, polys=polys))
    return m


def _tracer_for(call_cls, kernel):
    """tests/test_batched_predict.py's ``_tracer_for`` on ``call_cls``."""
    def tracer(n, b):
        return [call_cls(kernel, ("C",), (b, max(n - (i + 1) * b, 0)))
                for i in range(max(1, n // b)) for _ in range(3)]
    return tracer


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_rank_traced_configs_matches_the_reference(backend):
    """tests/test_batched_predict.py:224's inputs: the port's
    ``rank_traced_configs`` against the reference's and against
    ``rank_algorithms``."""
    from repro.core import KernelCall as RefCall
    from repro.perf import rank_traced_configs as ref_rank_traced
    from repro_torch.core import KernelCall
    from repro_torch.perf import RankedTracedConfig, rank_traced_configs

    rng = np.random.default_rng(31)
    ref_ms = RefModelSet({"k": _ref_random_model(rng, "k"),
                          "k2": _ref_random_model(rng, "k2")})
    mine_ms = model_set_from_reference(ref_ms.to_dict())
    ref_tracers_ = {"a": _tracer_for(RefCall, "k"),
                    "b": _tracer_for(RefCall, "k2")}
    mine_tracers = {"a": _tracer_for(KernelCall, "k"),
                    "b": _tracer_for(KernelCall, "k2")}
    device = "cpu" if backend == "torch" else None
    eng = PredictionEngine(mine_ms, backend=backend, device=device)
    got = rank_traced_configs(mine_tracers, mine_ms, 512, 64, engine=eng)
    want = ref_rank_traced(ref_tracers_, ref_ms, 512, 64)
    assert all(isinstance(r, RankedTracedConfig) for r in got)
    assert [r.name for r in got] == [r.name for r in want]
    np.testing.assert_allclose([r.predicted_s for r in got],
                               [r.predicted_s for r in want],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose([r.runtime.std for r in got],
                               [r.runtime.std for r in want],
                               rtol=1e-12, atol=0)
    if backend == "numpy":
        # no engine: ``resolve_engine`` builds the numpy one
        assert [r.runtime for r in rank_traced_configs(
            mine_tracers, mine_ms, 512, 64)] == [r.runtime for r in got]
    ranked = rank_algorithms(mine_tracers, mine_ms, 512, 64)
    assert [r.name for r in got] == [r.name for r in ranked]
    # the engine's own backend named beside it is accepted; a
    # contradicting backend raises
    assert [r.runtime for r in rank_traced_configs(
        mine_tracers, mine_ms, 512, 64, engine=eng, backend=backend)] == \
        [r.runtime for r in got]
    with pytest.raises(ValueError, match="backend"):
        rank_traced_configs(mine_tracers, mine_ms, 512, 64, engine=eng,
                            backend="numpy" if backend == "torch"
                            else "torch")
