"""The float64 torch prediction backend against the numpy engine.

``PredictionEngine(backend="torch")`` evaluates a whole compiled batch —
piece lookup, monomial design matrices, the ``nm,nms->ns`` contraction
and the config segment sum — as one torch program over the batch's
padded tensors.  On the CPU (``device="cpu"``) it must agree with the
port's numpy engine, its per-group path, the scalar ``predict_runtime``
and the reference's numpy engine at rtol 1e-12, on the cases of the
reference's ``test_fused_predict.py``: the full tracer catalog, padding
rows that must not leak, empty and all-degenerate batches, out-of-domain
clamping.  (The reference's own ``backend="jax"`` cannot serve as the
oracle: its float64 switch does not import on the installed jax.)
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.common import catalog_synthetic_model_set  # noqa: E402
from repro.core import PredictionEngine as RefEngine  # noqa: E402
from repro.core import compile_calls as ref_compile  # noqa: E402
from repro.dla import tracers as ref_tracers  # noqa: E402
from repro_torch.convert import model_set_from_reference  # noqa: E402
from repro_torch.core import (CompiledCalls, KernelCall,  # noqa: E402
                              PredictionEngine, compile_calls,
                              predict_runtime)
from repro_torch.core.sampler import STATS  # noqa: E402
from repro_torch.dla.tracers import ALL_TRACERS, CHOLESKY_TRACERS  # noqa: E402

torch.set_num_threads(1)

REL = 1e-12


@pytest.fixture(scope="module")
def models():
    ref = catalog_synthetic_model_set()
    return ref, model_set_from_reference(ref.to_dict())


@pytest.fixture(scope="module")
def catalog_seqs():
    # every kernel, degenerate tail calls included, uneven group sizes
    return [tracer(264, 56) for tracer in ALL_TRACERS.values()]


def _scalar(seqs, models):
    return np.array([[getattr(predict_runtime(seq, models), s)
                      for s in STATS] for seq in seqs])


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=REL, atol=0)


def _engine(models, backend):
    return PredictionEngine(models, backend=backend,
                            device="cpu" if backend == "torch" else None)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("n,b", [(264, 56), (264, 24), (1000, 96)])
def test_fused_matches_grouped_scalar_and_reference(models, backend, n, b):
    ref, mine = models
    seqs = [tracer(n, b) for tracer in ALL_TRACERS.values()]
    compiled = compile_calls(seqs)
    got = _engine(mine, backend).predict_compiled(compiled)
    want = RefEngine(ref).predict_compiled(ref_compile(
        [t(n, b) for t in ref_tracers.ALL_TRACERS.values()]))
    _close(got, want)
    _close(got, _scalar(seqs, mine))
    _close(got, _engine(mine, backend).predict_compiled_grouped(compiled))


def test_fused_batch_structure_matches_reference(catalog_seqs):
    mine = compile_calls(catalog_seqs).fused_batch()
    theirs = ref_compile([t(264, 56) for t in
                          ref_tracers.ALL_TRACERS.values()]).fused_batch()
    for field in ("sizes", "segments", "flat_config"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(theirs, field))
    assert mine.dims == theirs.dims and mine.rows == theirs.rows


@pytest.mark.parametrize("pad", [1, 7, 64])
def test_padding_rows_never_leak(models, catalog_seqs, pad):
    """Re-padding the row axis must not change a single bit: padding rows
    evaluate to exact zeros and sit outside every config's members."""
    _, mine = models
    eng = _engine(mine, "torch")
    base = eng.predict_compiled(compile_calls(catalog_seqs))
    rows = max(g.sizes.shape[0] for g in compile_calls(catalog_seqs).groups)
    repadded = compile_calls(catalog_seqs, pad_rows_to=rows + pad)
    np.testing.assert_array_equal(eng.predict_compiled(repadded), base)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_empty_and_all_degenerate_batches(models, backend):
    _, mine = models
    eng = _engine(mine, backend)
    out = eng.predict_batch([[], []])
    assert out.shape == (2, len(STATS)) and np.all(out == 0.0)
    degen = [KernelCall("gemm", ("MISSING",), (0, 64, 64))]
    assert np.all(eng.predict_batch([degen]) == 0.0)
    live = KernelCall("gemm", next(iter(mine["gemm"].cases)), (64, 64, 64))
    mixed = eng.predict_batch([degen, [], degen + [live]])
    _close(mixed[2], _scalar([[live]], mine)[0])
    assert np.all(mixed[:2] == 0.0)
    with pytest.raises(KeyError):
        eng.predict_batch(
            [degen + [KernelCall("gemm", ("MISSING",), (64, 64, 64))]])


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_out_of_domain_calls_clamp_like_the_scalar_path(models, backend):
    """Sizes far outside every fitted domain (n = 6000 > the synthetic
    models' ranges, and calls of size 1) take the nearest piece."""
    _, mine = models
    seqs = [tracer(6000, 512) for tracer in CHOLESKY_TRACERS.values()]
    seqs.append([KernelCall("gemm", case, (1, 1, 1))
                 for case in mine["gemm"].cases] +
                [KernelCall("trsm", case, (5000, 3))
                 for case in mine["trsm"].cases])
    got = _engine(mine, backend).predict_batch(seqs)
    _close(got, _scalar(seqs, mine))


def test_hand_built_compiled_derives_fused_lazily(models, catalog_seqs):
    _, mine = models
    eager = compile_calls(catalog_seqs)
    lazy = CompiledCalls(n_configs=eager.n_configs, groups=eager.groups)
    assert lazy.fused is None
    got = _engine(mine, "torch").predict_compiled(lazy)
    assert lazy.fused is not None
    np.testing.assert_array_equal(
        got, _engine(mine, "torch").predict_compiled(eager))


def test_inputs_stay_on_the_device_and_track_mutation(models, catalog_seqs):
    """A repeated sweep re-uploads nothing; a replaced piece rebuilds the
    tensors and their device copies."""
    _, mine = models
    ms = copy.deepcopy(mine)
    eng = _engine(ms, "torch")
    compiled = compile_calls(catalog_seqs)
    eng.predict_compiled(compiled)
    inputs = eng._fused_device_inputs(compiled)
    eng.predict_compiled(compiled)
    assert eng._fused_device_inputs(compiled) is inputs
    assert all(t.dtype in (torch.float64, torch.int64) for t in inputs)
    cm = ms["gemm"].cases[next(iter(ms["gemm"].cases))]
    piece = cm.pieces[0]
    cm.pieces[0] = copy.deepcopy(piece)
    assert eng._fused_device_inputs(compiled) is not inputs
    _close(eng.predict_compiled(compiled), _scalar(catalog_seqs, ms))


def test_potrf_grid_agrees_with_numpy_and_the_reference(models):
    """The (variant, b) grid of the paper path, as chip_smoke's phase 10
    predicts it at n = 4096 on the card, here at n = 1024."""
    ref, mine = models
    bs = [64, 96, 128, 192, 256]
    numpy_eng, torch_eng = _engine(mine, "numpy"), _engine(mine, "torch")
    for name, tracer in CHOLESKY_TRACERS.items():
        got = torch_eng.grid(tracer, [1024], bs)
        _close(got, numpy_eng.grid(tracer, [1024], bs))
        _close(got, RefEngine(ref).grid(ref_tracers.CHOLESKY_TRACERS[name],
                                        [1024], bs))


def test_repadding_property_many_shapes(models):
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    _, mine = models
    tracers = list(ALL_TRACERS.values())
    eng = _engine(mine, "torch")

    @settings(max_examples=6, deadline=None)
    @given(data=st.data())
    def run(data):
        k = data.draw(st.integers(min_value=1, max_value=4))
        picks = data.draw(st.lists(
            st.integers(min_value=0, max_value=len(tracers) - 1),
            min_size=k, max_size=k))
        b = data.draw(st.sampled_from([8, 24, 56, 120]))
        pad = data.draw(st.integers(min_value=0, max_value=50))
        seqs = [tracers[i](264, b) for i in picks]
        base = eng.predict_compiled(compile_calls(seqs))
        np.testing.assert_array_equal(
            eng.predict_compiled(compile_calls(seqs, pad_rows_to=pad)), base)
        _close(base, _scalar(seqs, mine))

    run()


# ---------------------------------------------------------------- on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the torch backend's default device "
                    "(chip_smoke.py's phase 10 runs it on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_torch_backend_on_the_card_matches_numpy(models, catalog_seqs,
                                                 card):
    _, mine = models
    compiled = compile_calls(catalog_seqs)
    got = PredictionEngine(mine, backend="torch").predict_compiled(compiled)
    _close(got, _engine(mine, "numpy").predict_compiled(compiled))
    assert PredictionEngine(mine, backend="torch").device.type == "cuda"
