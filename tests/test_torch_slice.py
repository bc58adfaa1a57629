"""The whole slice, deterministically, against the reference.

Measurement is replaced by one shared deterministic oracle built from the
kernels' flop counts (with a cliff, so refinement has to split), so both
packages see identical samples:

* ``refine`` and ``generate_model`` over the potf2/trsm/syrk/gemm cases the
  potrf tracers call give identical pieces (coefficients to rel 1e-10);
* the potrf variants and the block size ranked from those models agree;
* the device suite and tile tuner, with an injected sweep and memcpy probe,
  rank tiles in the reference's order, and the analytic path agrees with
  ``predict_tile_time``;
* one real CPU ``ExecEngine`` potrf through the port factors correctly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import modelgen as ref_modelgen  # noqa: E402
from repro.core import refinement as ref_refinement  # noqa: E402
from repro.core import sampler as ref_sampler  # noqa: E402
from repro.core import selection as ref_selection  # noqa: E402
from repro.core.grids import Domain as RefDomain  # noqa: E402
from repro.core.model import ModelSet as RefModelSet  # noqa: E402
from repro.dla import tracers as ref_tracers  # noqa: E402
from repro.dla.kernels import KERNELS as REF_KERNELS  # noqa: E402
from repro.perf import tile_tuner as ref_tuner  # noqa: E402
from repro.tc import PredictorSession as RefSession  # noqa: E402
from repro_torch.core import (GeneratorConfig, KernelBenchmark,  # noqa: E402
                              ModelSet, generate_model,
                              optimize_block_size, rank_algorithms, refine)
from repro_torch.core import sampler  # noqa: E402
from repro_torch.core.grids import Domain  # noqa: E402
from repro_torch.core.sampler import Stats  # noqa: E402
from repro_torch.dla import ExecEngine, blocked, tracers  # noqa: E402
from repro_torch.dla.kernels import KERNELS  # noqa: E402
from repro_torch.perf.roofline import (H100_SXM, card, card_of,  # noqa: E402
                                       peak_flops)
from repro_torch.perf.tile_tuner import (predict_tile_time,  # noqa: E402
                                         rank_tiles, select_tiles,
                                         tile_table)
from repro_torch.tc import PredictorSession  # noqa: E402
from repro_torch.tc.suite import MicroBenchmarkSuite  # noqa: E402

torch.set_num_threads(1)

N_TRACE = 512
BS = (32, 48, 64, 96, 128)
CONFIG = dict(overfit=0, oversampling=2, repetitions=5, error_bound=0.04,
              min_width=64, max_pieces=6)
KERNELS_OF_PATH = ("potf2", "trsm", "syrk", "gemm")


def _oracle(stats_cls, kernel, case, sizes):
    """Deterministic 'measurement': flops at a fixed rate + overhead, with
    a 30% cliff above 160 in the first size (forces refinement)."""
    flops = max(KERNELS[kernel].flops(tuple(case), tuple(sizes)), 1.0)
    t = flops / 5e10 + 2e-6
    if sizes[0] > 160:
        t *= 1.3
    return stats_cls(0.97 * t, t, 1.08 * t, 1.01 * t, 0.02 * t)


def _domains():
    """Per (kernel, case): the bounding box of its live calls over the
    potrf tracers and block sizes, read from the port's TraceEngine."""
    boxes = {}
    for tracer in tracers.CHOLESKY_TRACERS.values():
        for b in BS:
            for call in tracer(N_TRACE, b):
                if min(call.sizes) <= 0:
                    continue
                lo, hi = boxes.get((call.kernel, call.case),
                                   (call.sizes, call.sizes))
                boxes[(call.kernel, call.case)] = (
                    tuple(map(min, lo, call.sizes)),
                    tuple(map(max, hi, call.sizes)))
    return boxes


def test_refine_pieces_identical():
    boxes = _domains()
    assert {k for k, _ in boxes} == set(KERNELS_OF_PATH)
    for (kernel, case), (lo, hi) in sorted(boxes.items(), key=repr):
        cfg = GeneratorConfig(**CONFIG)
        exps = KERNELS[kernel].cost_exponents(case)

        def sample(points, _cls=Stats, _k=kernel, _c=case):
            return {p: _oracle(_cls, _k, _c, p) for p in points}

        def ref_sample(points, _k=kernel, _c=case):
            return {p: _oracle(ref_sampler.Stats, _k, _c, p)
                    for p in points}

        mine = refine(Domain(lo, hi), sample, exps, cfg)
        ref = ref_refinement.refine(
            RefDomain(lo, hi), ref_sample,
            REF_KERNELS[kernel].cost_exponents(case),
            ref_refinement.GeneratorConfig(**CONFIG))
        assert len(mine) == len(ref)
        for p, r in zip(mine, ref):
            assert (p.domain.lo, p.domain.hi) == (r.domain.lo, r.domain.hi)
            for s in sampler.STATS:
                np.testing.assert_allclose(p.polys[s].coeffs,
                                           r.polys[s].coeffs, rtol=1e-10)
        if kernel == "trsm":
            assert len(mine) > 1          # the cliff made it split


class _Call:
    """A make_call product that knows what it would run: the shared
    deterministic measurement below reads its point instead of a clock."""

    def __init__(self, kernel, case, sizes):
        self.kernel, self.case, self.sizes = kernel, case, sizes

    def __call__(self):
        raise AssertionError("the deterministic sampler never runs calls")


def _deterministic_measure_calls(stats_cls):
    def measure_calls(calls, repetitions=10, **kw):
        return {k: _oracle(stats_cls, c.kernel, c.case, c.sizes)
                for k, c in calls.items()}
    return measure_calls


@pytest.fixture
def models(monkeypatch):
    """Both packages' generate_model over the potrf path's kernels, with
    the sampler's measurement swapped for the deterministic oracle."""
    monkeypatch.setattr(sampler, "measure_calls",
                        _deterministic_measure_calls(Stats))
    monkeypatch.setattr(ref_sampler, "measure_calls",
                        _deterministic_measure_calls(ref_sampler.Stats))
    boxes = _domains()
    mine, ref = ModelSet(), RefModelSet()
    for kernel in KERNELS_OF_PATH:
        cases = [c for k, c in boxes if k == kernel]
        doms = {c: boxes[(kernel, c)] for c in cases}
        bench = KernelBenchmark(
            name=kernel, cases=cases,
            case_domains={c: Domain(*d) for c, d in doms.items()},
            cost_exponents=KERNELS[kernel].cost_exponents,
            make_call=lambda c, p, _k=kernel: _Call(_k, c, p))
        ref_bench = ref_modelgen.KernelBenchmark(
            name=kernel, cases=cases,
            case_domains={c: RefDomain(*d) for c, d in doms.items()},
            cost_exponents=REF_KERNELS[kernel].cost_exponents,
            make_call=lambda c, p, _k=kernel: _Call(_k, c, p))
        model, report = generate_model(bench, GeneratorConfig(**CONFIG))
        ref_model, ref_report = ref_modelgen.generate_model(
            ref_bench, ref_refinement.GeneratorConfig(**CONFIG))
        assert report.measured_points == ref_report.measured_points
        assert report.pieces_per_case == ref_report.pieces_per_case
        mine.add(model)
        ref.add(ref_model)
    return mine, ref


def test_generated_models_and_selections_identical(models):
    mine, ref = models
    for kernel in KERNELS_OF_PATH:
        for case, cm in mine[kernel].cases.items():
            rcm = ref[kernel].cases[case]
            for p, r in zip(cm.pieces, rcm.pieces, strict=True):
                assert (p.domain.lo, p.domain.hi) == \
                    (r.domain.lo, r.domain.hi)
                for s in sampler.STATS:
                    np.testing.assert_allclose(
                        p.polys[s].coeffs, r.polys[s].coeffs, rtol=1e-10)
    got = rank_algorithms(tracers.CHOLESKY_TRACERS, mine, N_TRACE, 64)
    want = ref_selection.rank_algorithms(ref_tracers.CHOLESKY_TRACERS, ref,
                                         N_TRACE, 64)
    assert [r.name for r in got] == [r.name for r in want]
    for name in tracers.CHOLESKY_TRACERS:
        b, profile = optimize_block_size(tracers.CHOLESKY_TRACERS[name],
                                         mine, N_TRACE, BS)
        rb, rprofile = ref_selection.optimize_block_size(
            ref_tracers.CHOLESKY_TRACERS[name], ref, N_TRACE, BS,
            batched=False)
        assert b == rb
        np.testing.assert_allclose([profile[c] for c in BS],
                                   [rprofile[c] for c in BS], rtol=1e-10)


# ----------------------------------------------------------- tile path --

def sweep(kernel_name, configs):
    """Deterministic per-config 'sweep': a pure function of the tile."""
    out = {}
    for cfg in configs:
        bm, bn, bk = cfg
        t = 1e-6 + 3e-12 * bm * bn * bk + 4e-9 * (bm + bn)
        out[cfg] = (Stats(0.9 * t, t, 1.2 * t, 1.02 * t, 0.05 * t),
                    1e-3, 10.0 * t)
    return out


def ref_sweep(kernel_name, configs):
    return {cfg: (ref_sampler.Stats(*(getattr(st, s)
                                       for s in sampler.STATS)), f, sec)
            for cfg, (st, f, sec) in sweep(kernel_name, configs).items()}


def xfer(direction, nbytes, repetitions):
    """Affine memcpy probe with known constants; D2H 2x slower."""
    bw = 20e9 if direction == "h2d" else 10e9
    return [5e-6 + nbytes / bw] * repetitions


CONFIGS = [(32, 32, 32), (32, 64, 64), (64, 64, 32), (64, 32, 64),
           (64, 64, 64)]


def _sessions():
    mine = PredictorSession(repetitions=2)
    mine.device_suite(device="cpu", sweep_fn=sweep,
                      transfer_measure_fn=xfer, steps_per_dim=2)
    ref = RefSession(repetitions=2)
    ref.device_suite(sweep_fn=ref_sweep, transfer_measure_fn=xfer,
                     steps_per_dim=2, interpret=True)
    return mine, ref


def test_device_rank_matches_reference():
    mine, ref = _sessions()
    got = mine.rank_device_tiles("cuda_matmul", (256, 256, 256), CONFIGS)
    want = ref.rank_device_tiles("pallas_matmul", (256, 256, 256), CONFIGS)
    assert [r.config for r in got] == [r.config for r in want]
    np.testing.assert_allclose([r.t_total for r in got],
                               [r.t_total for r in want], rtol=1e-12)
    assert {r.source for r in got} == {"measured"}
    ds = mine.device_suite()
    assert ds.suite.measured == len(CONFIGS)
    h2d, d2h = ds.transfer_models()
    assert h2d.bytes_per_s == pytest.approx(20e9, rel=1e-6)
    assert d2h.overhead_s == pytest.approx(5e-6, rel=1e-6)


def test_rank_tiles_order_matches_reference_and_analytic_oracle():
    mine, ref = _sessions()
    got = rank_tiles(64, 64, 64, session=mine, candidates=(32, 64))
    want = ref_tuner.rank_tiles(64, 64, 64, session=ref, candidates=(32, 64))
    # the port's legality is its kernel's (64-multiple register tiles, a
    # cp.async ring), a subset of the reference's candidates at 64^3; over
    # the tiles both take, the two rank alike with the same totals
    mine_cfgs = [(t.bm, t.bn, t.bk) for t in got]
    assert sorted(mine_cfgs) == [(64, 64, 32), (64, 64, 64)]
    want = [t for t in want if (t.bm, t.bn, t.bk) in mine_cfgs]
    assert mine_cfgs == [(t.bm, t.bn, t.bk) for t in want]
    np.testing.assert_allclose([t.predicted_s for t in got],
                               [t.predicted_s for t in want], rtol=1e-12)
    # the analytic path is predict_tile_time, ranked
    analytic = rank_tiles(4096, 4096, 4096, analytic=True)
    assert [t.predicted_s for t in analytic] == sorted(
        predict_tile_time(4096, 4096, 4096, t.bm, t.bn, t.bk)
        for t in analytic)
    best = select_tiles(4096, 4096, 4096, analytic=True)
    assert (best.bm, best.bn, best.bk) == \
        (analytic[0].bm, analytic[0].bn, analytic[0].bk)
    assert all(t.source == "analytic" for t in analytic)
    measured = select_tiles(64, 64, 64, session=mine, candidates=(32, 64))
    assert measured.source == "measured"
    # a CPU session ranks analytically on the H100 SXM's constants
    on_cpu = rank_tiles(4096, 4096, 4096, session=mine, analytic=True)
    assert [t.predicted_s for t in on_cpu] == \
        [t.predicted_s for t in analytic]


def test_tile_table_is_select_tiles_per_shape_over_shared_measurements():
    """``tile_table`` over three shapes equals ``select_tiles`` per shape,
    and one session's sweep serves the whole table: the proxy keys depend
    only on the tile config."""
    import repro_torch.perf as perf
    shapes = [(256, 256, 256), (128, 256, 512), (512, 128, 128)]
    swept = []

    def counting_sweep(kernel_name, configs):
        swept.extend(configs)
        return sweep(kernel_name, configs)

    table_session = PredictorSession(repetitions=2)
    table_session.device_suite(device="cpu", sweep_fn=counting_sweep,
                               transfer_measure_fn=xfer, steps_per_dim=2)
    table = tile_table(shapes, session=table_session, candidates=(64, 128))
    assert perf.tile_table is tile_table
    assert list(table) == shapes
    n_keys = table_session.suite.n_benchmarks
    assert n_keys == len(set(swept)) == len(swept)
    per_shape, _ = _sessions()
    for shape in shapes:
        assert table[shape] == select_tiles(*shape, session=per_shape,
                                            candidates=(64, 128))
    # the per-shape session measured the same distinct keys, once each
    assert per_shape.suite.n_benchmarks == n_keys
    # a second table over the same shapes measures nothing new
    assert tile_table(shapes, session=table_session,
                      candidates=(64, 128)) == table
    assert table_session.suite.n_benchmarks == n_keys
    assert len(swept) == n_keys
    # without a session the table is the analytic selection
    assert tile_table(shapes[:1], candidates=(64, 128))[shapes[0]] == \
        select_tiles(*shapes[0], candidates=(64, 128))


def test_card_constants_are_keyed_by_device_name():
    assert card_of(torch.device("cpu")) is H100_SXM
    assert card(H100_SXM.name) is H100_SXM
    with pytest.raises(KeyError, match="no published constants"):
        card("an unrecorded card")
    # NVIDIA's published dense rates for the SXM part at 700 W
    assert H100_SXM.fp32_flops == 67e12
    assert H100_SXM.bf16_tensor_flops == 989e12
    assert H100_SXM.tf32_tensor_flops == 495e12
    assert peak_flops(H100_SXM, torch.bfloat16) == 989e12
    assert peak_flops(H100_SXM, torch.float32) == 67e12
    with pytest.raises(ValueError, match="no peak rate"):
        peak_flops(H100_SXM, torch.float64)


def test_device_model_set_round_trips_and_loads_in_reference():
    mine, _ = _sessions()
    mine.rank_device_tiles("cuda_matmul", (256, 256, 256), CONFIGS)
    ms = mine.device_suite().to_model_set()
    ref = RefModelSet.from_dict(ms.to_dict())
    assert ref.to_dict() == ms.to_dict()
    warm = PredictorSession(suite=MicroBenchmarkSuite(repetitions=2))
    ds = warm.device_suite(device="cpu", steps_per_dim=2,
                           sweep_fn=lambda *a: pytest.fail("measured"))
    assert ds.load_model_set(ModelSet.from_dict(ms.to_dict())) == 1
    ranked = warm.rank_device_tiles("cuda_matmul", (256, 256, 256), CONFIGS)
    assert {r.source for r in ranked} == {"model"}
    assert warm.suite.measured == 0


def test_exec_potrf_factor_on_cpu():
    n, b = 96, 32
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n))
    A0 = a @ a.T + n * np.eye(n)
    eng = ExecEngine(device="cpu")
    A = eng.bind("A", A0)
    blocked.potrf(eng, A, n, b, variant=2)
    L = np.tril(eng.mats["A"]).astype(np.float64)
    assert np.linalg.norm(L @ L.T - A0) / np.linalg.norm(A0) < 1e-6
