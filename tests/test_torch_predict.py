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
