"""The port's backend-free ``perf`` modules against the reference's, and
the serve launcher.

``analytic`` (``forward_flops``, ``cell_cost``, ``_cache_bytes``),
``hlo_scale`` (``split_computations``, ``scaled_collective_bytes``),
``roofline`` (``collective_bytes``, ``RooflineTerms``, ``model_flops_for``)
and ``predictor`` (``ConfigCandidate``, ``RankedConfig``, ``rank_configs``)
are the same arithmetic on the same inputs, so they are held bit for bit:
on ``tests/test_perf.py``'s inputs, and on every config x shape where a
function takes both.  ``RooflineTerms`` takes its rates from a card: one
that carries the reference's TPU constants gives the reference's numbers
exactly, and the default is the H100's.  The serve launcher runs on the
CPU beside the reference's.
"""

import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.perf import analytic as ref_analytic  # noqa: E402
from repro.perf import hlo_scale as ref_hlo  # noqa: E402
from repro.perf import predictor as ref_predictor  # noqa: E402
from repro.perf import roofline as ref_roofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.perf import analytic, hlo_scale, predictor  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402

#: tests/test_perf.py's module: a while loop of 10 trips around an
#: all-reduce and an all-gather, a reduce-scatter outside it
HLO = """\
HloModule test

%body.1 (p: (s32[], f32[128,256])) -> (s32[], f32[128,256]) {
  %ar = f32[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[512,256]{1,0} all-gather(%y), replica_groups=[4,4]<=[16], dimensions={0}
  ROOT %t = tuple(%i, %ar)
}

%cond.1 (p: (s32[], f32[128,256])) -> pred[] {
  %c = s32[] constant(10)
  ROOT %cmp = pred[] compare(%i, %c), direction=LT
}

ENTRY %main (a: f32[128,256]) -> f32[128,256] {
  %rs = f32[32,256]{1,0} reduce-scatter(%a), replica_groups={{0,1,2,3}}, dimensions={0}
  %w = (s32[], f32[128,256]) while(%init), condition=%cond.1, body=%body.1
  ROOT %out = f32[128,256] get-tuple-element(%w), index=1
}
"""
#: the same collectives in their async and bf16 forms, and one without a
#: replica group
HLO_ASYNC = """\
ENTRY %m (a: bf16[64,64]) -> bf16[64,64] {
  %s = bf16[64,64]{1,0} all-reduce-start(%a), replica_groups={{0,1}}
  %d = bf16[64,64]{1,0} all-reduce-done(%s)
  %p = (f32[8,8], s32[4]) collective-permute-start(%a), source_target_pairs={{0,1}}
  %x = u8[1024]{0} all-to-all(%a)
  ROOT %r = bf16[64,64] copy(%d)
}
"""
ARCHS = sorted(configs.all_configs())
SHAPE_NAMES = sorted(configs.SHAPES)
#: a card that carries the reference's three TPU v5e constants
REF_CARD = roofline.Card(
    name="reference constants", fp32_flops=0.0,
    bf16_tensor_flops=ref_roofline.PEAK_FLOPS, tf32_tensor_flops=0.0,
    hbm_bytes_per_s=ref_roofline.HBM_BW, sms=0, power_w=0.0,
    link_bytes_per_s=ref_roofline.ICI_BW)


def _pair(arch):
    return ref_configs.get_config(arch), configs.get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_flops_equal_the_reference_bit_for_bit(arch):
    ref_cfg, cfg = _pair(arch)
    for batch, seq in ((1, 4096), (4, 128), (32, 32768)):
        assert analytic.forward_flops(cfg, batch, seq) == \
            ref_analytic.forward_flops(ref_cfg, batch, seq)
    for kv in (1.0, 4096.0, 600000.0):
        assert analytic.forward_flops(cfg, 8, 1, kv_len=kv, decode=True) == \
            ref_analytic.forward_flops(ref_cfg, 8, 1, kv_len=kv,
                                       decode=True)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_cell_cost_and_model_flops_equal_the_reference(arch, shape):
    ref_cfg, cfg = _pair(arch)
    ref_shape, mine = ref_configs.SHAPES[shape], configs.SHAPES[shape]
    for policy in (None, "dots"):
        got = analytic.cell_cost(cfg, mine, remat_policy=policy)
        want = ref_analytic.cell_cost(ref_cfg, ref_shape,
                                      remat_policy=policy)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert roofline.model_flops_for(cfg, mine) == \
        ref_roofline.model_flops_for(ref_cfg, ref_shape)
    for ctx in (1, 4096, mine.seq_len):
        assert analytic._cache_bytes(cfg, 2, ctx) == \
            ref_analytic._cache_bytes(ref_cfg, 2, ctx)


def test_test_perfs_analytic_inputs():
    """tests/test_perf.py's assertions on the port's functions."""
    cfg = configs.get_config("deepseek-7b")
    n = cfg.param_count(active_only=True)
    assert roofline.model_flops_for(cfg, configs.SHAPES["train_4k"]) == \
        pytest.approx(6 * n * 256 * 4096)
    assert roofline.model_flops_for(cfg, configs.SHAPES["prefill_32k"]) == \
        pytest.approx(2 * n * 32 * 32768)
    arctic = configs.get_config("arctic-480b")
    assert roofline.model_flops_for(arctic, configs.SHAPES["train_4k"]) < \
        6 * arctic.param_count() * 256 * 4096 / 10
    for arch in ("deepseek-7b", "gemma2-27b", "phi3-mini-3.8b"):
        c = configs.get_config(arch)
        ratio = analytic.forward_flops(c, 1, 4096) / (
            2 * c.param_count(active_only=True) * 4096)
        assert 0.8 < ratio < 2.2, (arch, ratio)
    mamba = configs.get_config("mamba2-2.7b")
    tr = analytic.cell_cost(mamba, configs.SHAPES["train_4k"])
    de = analytic.cell_cost(mamba, configs.SHAPES["long_500k"])
    assert tr.flops > de.flops and de.hbm_bytes > 0


@pytest.mark.parametrize("text", [HLO, HLO_ASYNC, ""])
def test_hlo_parsing_equals_the_reference(text):
    assert roofline.collective_bytes(text) == \
        ref_roofline.collective_bytes(text)
    assert hlo_scale.split_computations(text) == \
        ref_hlo.split_computations(text)
    assert hlo_scale.scaled_collective_bytes(text) == \
        ref_hlo.scaled_collective_bytes(text)


def test_test_perfs_hlo_inputs():
    cb = roofline.collective_bytes(HLO)
    assert cb["all-reduce"] == 128 * 256 * 4
    assert cb["all-gather"] == 512 * 256 * 4 // 4
    assert cb["reduce-scatter"] == 32 * 256 * 4 * 4
    assert set(hlo_scale.split_computations(HLO)) >= {"body.1", "cond.1",
                                                     "main"}
    scaled = hlo_scale.scaled_collective_bytes(HLO)
    assert scaled["all-reduce"] == 10 * 128 * 256 * 4
    assert scaled["reduce-scatter"] == 32 * 256 * 4 * 4


TERMS = [
    dict(flops=197e12, bytes_accessed=0.0, coll_bytes={"all-reduce": 0},
         n_devices=1, model_flops=197e12),
    dict(flops=1.0, bytes_accessed=819e9, coll_bytes={"all-reduce": 0},
         n_devices=1),
    dict(flops=3.1e15, bytes_accessed=2.2e12,
         coll_bytes={"all-reduce": 7 * 10 ** 11, "all-gather": 10 ** 9},
         n_devices=256, model_flops=5.5e17, hlo_flops=1e12, hlo_bytes=3e9),
    dict(flops=0.0, bytes_accessed=0.0, coll_bytes={}, n_devices=4),
]


@pytest.mark.parametrize("kw", TERMS)
def test_roofline_terms_on_the_reference_constants_equal_the_reference(kw):
    got = roofline.RooflineTerms(**kw, card=REF_CARD)
    want = ref_roofline.RooflineTerms(**kw)
    for prop in ("coll_total", "compute_s", "memory_s", "collective_s",
                 "dominant", "bound_s", "useful_ratio", "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.as_dict() == want.as_dict()


def test_roofline_terms_default_to_the_h100():
    card = roofline.H100_SXM
    assert card.link_bytes_per_s == 450e9
    t = roofline.RooflineTerms(flops=989e12, bytes_accessed=3.35e12,
                               coll_bytes={"all-reduce": 450 * 10 ** 9},
                               n_devices=1, model_flops=989e12)
    assert t.card is card
    assert t.compute_s == t.memory_s == t.collective_s == 1.0
    assert t.roofline_fraction == 1.0
    t2 = roofline.RooflineTerms(flops=1.0, bytes_accessed=6.7e12,
                                coll_bytes={}, n_devices=1)
    assert t2.dominant == "memory" and t2.memory_s == 2.0


def test_rank_configs_orders_as_the_reference():
    names = ["tp", "fsdp", "hybrid", "dp"]

    def mine(i):
        return roofline.RooflineTerms(**TERMS[i], card=REF_CARD)

    def ref(i):
        return ref_roofline.RooflineTerms(**TERMS[i])

    got = predictor.rank_configs([predictor.ConfigCandidate(
        n, (lambda i=i: mine(i)), note=n) for i, n in enumerate(names)])
    want = ref_predictor.rank_configs([ref_predictor.ConfigCandidate(
        n, (lambda i=i: ref(i)), note=n) for i, n in enumerate(names)],
        extract=None)
    assert [r.name for r in got] == [r.name for r in want]
    assert [r.predicted_s for r in got] == [r.predicted_s for r in want]
    assert [r.note for r in got] == [r.note for r in want]
    # a build that returns something else goes through extract, or raises
    built = predictor.rank_configs(
        [predictor.ConfigCandidate("raw", lambda: 3)],
        extract=lambda n: mine(n))
    assert built[0].terms.as_dict() == mine(3).as_dict()
    with pytest.raises(TypeError, match="not RooflineTerms"):
        predictor.rank_configs([predictor.ConfigCandidate("raw",
                                                          lambda: 3)])


def _line(out):
    """The launcher's line as a dict, without the rate (wall clock)."""
    fields = dict(kv.split("=") for kv in out.strip().splitlines()[-1]
                  .split())
    fields.pop("tok/s")
    return fields


@pytest.mark.parametrize("arch", ["gemma2-27b", "mamba2-2.7b"])
def test_serve_launcher_runs_on_the_cpu_as_the_reference(arch, capsys,
                                                         monkeypatch):
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                "--max-new", "4"])
    got = _line(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--requests",
                                      "3", "--max-new", "4"])
    ref_serve.main()
    want = _line(capsys.readouterr().out)
    assert got == want == {"arch": f"{arch}-smoke", "requests": "3",
                           "decode_steps": got["decode_steps"],
                           "tokens": "12"}


def test_serve_launcher_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py phase 13 serves there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma2-27b"])
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--device", "cpu"])
