"""The port's dry run (``repro_torch.launch.dryrun``), its record of a traced
step (``perf.roofline.StepRecorder``, ``extract``) and the abstract inputs
(``launch.steps``), against the reference's where it has a counterpart.

Cells trace under a ``"fake"`` process group of 256 ranks on fake tensors
on the CPU: this PyTorch build has no CUDA, and can fake a CUDA tensor
but neither differentiate nor shard one (``dryrun.trace_device``; where
PyTorch is built with CUDA the dry run traces on fake CUDA tensors); the
kernels' operators run their fake implementations either way.  Counted forward FLOPs equal
``perf.analytic.forward_flops`` within 1 % for a dense and a Mamba config
(both count the same products; the kernels' formulas are the analytic
conventions), exactly as measured here; the MoE's one-hot dispatch and
combine are counted as the products they are (quadratic in the routing
group's tokens) where the analytic count takes them linear, so that ratio
is printed, not gated.  Every group is destroyed in a ``finally``.
"""

import contextlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.perf import analytic as ref_analytic  # noqa: E402
from repro.perf import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import SHAPES, all_configs, get_config, reduced  # noqa: E402,E501
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import TensorSpec, input_specs  # noqa: E402
from repro_torch.perf.analytic import cell_cost, forward_flops  # noqa: E402
from repro_torch.perf.roofline import (H100_SXM, StepRecord,  # noqa: E402
                                       StepRecorder, extract)

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(d_model=256, d_ff=512, vocab=4096)


@contextlib.contextmanager
def _fake_group(n=256):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_a_reduced_jamba_cell_lowers_on_the_production_mesh(shape,
                                                           monkeypatch):
    """jamba at reduced width (all its mixers, the MoE and the kernels'
    operators) traced on the 16 x 16 mesh: the record holds the kernels'
    operators and collectives, the meta dict what the artifact holds."""
    cfg = reduced(get_config("jamba-v0.1-52b"), **SMALL)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    assert dryrun.trace_device() == "cpu"       # this build has no CUDA
    record, meta = dryrun.lower_cell("jamba-v0.1-52b", shape,
                                     verbose=False)
    assert not dist.is_initialized()
    assert meta["n_devices"] == 256 and meta["mesh"] == "16x16"
    assert meta["strategy"] == ("tp" if shape == "train_4k" else "serve")
    assert meta["compute_s"] > 0 and meta["counted_flops"] > 0
    assert meta["memory"]["peak_bytes"] >= meta["memory"]["argument_bytes"]
    ops = set(record["flops_by_op"])
    kind = SHAPES[shape].kind
    if kind == "train":
        assert {"repro_torch.flash_attention_fwd", "repro_torch.ssd_fwd",
                "repro_torch.flash_attention_bwd",
                "repro_torch.ssd_bwd"} <= ops
    elif kind == "prefill":
        assert {"repro_torch.flash_attention_fwd",
                "repro_torch.ssd_fwd"} <= ops
    assert sum(meta["coll_bytes"].values()) > 0
    want = cell_cost(cfg, SHAPES[shape])
    assert meta["flops"] == pytest.approx(want.flops / 256, rel=1e-12)


def _forward_record(cfg, b=2, s=256):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.steps import abstract_params
    from repro_torch.models import forward
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    params = abstract_params(cfg, dtype=torch.float32, device="cpu",
                             mode=mode)
    with mode:
        inputs = torch.zeros((b, s), dtype=torch.int64)
    with mode, torch.no_grad(), StepRecorder() as rec:
        forward(cfg, params, inputs)
    return rec.record


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-2.7b"])
def test_counted_forward_flops_equal_the_analytic_count(arch):
    cfg = reduced(get_config(arch), **SMALL)
    record = _forward_record(cfg)
    want = forward_flops(cfg, 2, 256)
    assert record.flops == pytest.approx(want, rel=1e-2)
    kernel = "repro_torch.flash_attention_fwd" \
        if arch == "deepseek-7b" else "repro_torch.ssd_fwd"
    assert record.flops_by_op[kernel] > 0


def test_moe_forward_flops_against_the_analytic_count_are_printed():
    cfg = reduced(get_config("jamba-v0.1-52b"), **SMALL)
    record = _forward_record(cfg)
    want = forward_flops(cfg, 2, 256)
    print(f"jamba (reduced) forward: counted {record.flops:.4e}, analytic "
          f"{want:.4e}, ratio {record.flops / want:.3f}; by op "
          f"{record.flops_by_op}")
    assert record.flops > 0


class _Stub:
    """A compiled executable as the reference's ``extract`` reads it."""

    def __init__(self, flops, nbytes):
        self._ca = {"flops": flops, "bytes accessed": nbytes}

    def cost_analysis(self):
        return [self._ca]

    def as_text(self):
        return ""


@pytest.mark.parametrize("with_analytic", [False, True])
def test_extract_equals_the_reference_extract(with_analytic):
    """The terms the reference builds from a compiled executable, built
    from a step record with the same counts; the time terms take the
    H100's rates where the reference's take a TPU's."""
    arch, shape = "jamba-v0.1-52b", SHAPES["train_4k"]
    cfg, ref_cfg = get_config(arch), ref_configs.get_config(arch)
    rec = StepRecord(flops=3.25e14, bytes=7.5e11)
    ref_shape = ref_configs.SHAPES["train_4k"]
    ref = ref_roofline.extract(
        _Stub(rec.flops, rec.bytes), 256,
        model_flops=ref_roofline.model_flops_for(ref_cfg, ref_shape),
        analytic=ref_analytic.cell_cost(ref_cfg, ref_shape)
        if with_analytic else None)
    got = extract(rec, 256, model_flops=dryrun.model_flops_for(cfg, shape),
                  analytic=cell_cost(cfg, shape) if with_analytic else None)
    for key in ("flops", "bytes", "coll_bytes", "coll_total", "n_devices",
                "model_flops", "hlo_flops", "hlo_bytes", "useful_ratio"):
        assert got.as_dict()[key] == ref.as_dict()[key], key
    assert got.card is H100_SXM
    assert got.compute_s == got.flops / H100_SXM.bf16_tensor_flops
    assert got.memory_s == got.bytes_accessed / H100_SXM.hbm_bytes_per_s


def test_collective_bytes_of_a_hand_built_sharded_product():
    """On the 16 x 16 fake mesh: (64, 256) sharded on its columns over
    "model" times (256, 32) sharded on its rows is a partial sum; its
    all-reduce moves the full (64, 32) float32 result, 8192 bytes; a
    reduce-scatter onto rows moves the same (operand = result x 16); an
    all-gather of (256, 64) sharded on rows over "data" moves the local
    (16, 64), 4096 bytes (operand = result / 16).  The local product is
    2 x 64 x 16 x 32 FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.launch.mesh import make_production_mesh
    with _fake_group():
        mesh = make_production_mesh(device="cpu")
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        with mode:
            a = distribute_tensor(torch.empty(64, 256), mesh,
                                  [Replicate(), Shard(1)],
                                  src_data_rank=None)
            b = distribute_tensor(torch.empty(256, 32), mesh,
                                  [Replicate(), Shard(0)],
                                  src_data_rank=None)
            x = distribute_tensor(torch.empty(256, 64), mesh,
                                  [Shard(0), Replicate()],
                                  src_data_rank=None)
        with mode, StepRecorder() as rec:
            c = a @ b
            assert c.placements == (Replicate(), Partial())
            c.redistribute(mesh, [Replicate(), Replicate()])
            c.redistribute(mesh, [Replicate(), Shard(0)])
            x.redistribute(mesh, [Replicate(), Replicate()])
        r = rec.record
    assert r.flops == 2 * 64 * 16 * 32
    assert r.coll_bytes["all-reduce"] == 64 * 32 * 4
    assert r.coll_bytes["reduce-scatter"] == 64 * 32 * 4
    assert r.coll_bytes["all-gather"] == 16 * 64 * 4
    assert r.coll_calls == {"all-reduce": 1, "all-gather": 1,
                            "reduce-scatter": 1, "all-to-all": 0,
                            "collective-permute": 0}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


CELLS = [(arch, shape) for arch in sorted(all_configs())
         for shape in get_config(arch).shapes]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    cfg = get_config(arch)
    ref_cfg = ref_configs.get_config(arch)
    got = input_specs(cfg, SHAPES[shape])
    want = ref_steps.input_specs(ref_cfg, ref_configs.SHAPES[shape])
    assert set(got) == set(want)

    def same(g, w):
        assert isinstance(g, TensorSpec)
        assert tuple(g.shape) == tuple(w.shape)
        assert _dtype_name(g.dtype) == str(w.dtype)

    for key in got:
        if key == "caches":
            period = len(cfg.block_pattern)
            assert len(got[key]) == cfg.n_layers
            for layer, g in enumerate(got[key]):
                w = want[key][f"p{layer % period}"]
                if not isinstance(g, TensorSpec):
                    for gi, wi in zip(g, w):
                        same(gi, jax.ShapeDtypeStruct(wi.shape[1:],
                                                      wi.dtype))
                else:
                    same(g, jax.ShapeDtypeStruct(w.shape[1:], w.dtype))
        elif key == "batch":
            assert set(got[key]) == set(want[key])
            for k in got[key]:
                same(got[key][k], want[key][k])
        else:
            same(got[key], want[key])


def test_the_cli_writes_its_artifacts_beside_not_into_the_references(
        tmp_path, monkeypatch, capsys):
    """``main`` writes ``<arch>__<shape>__<mesh>.json`` into its own
    ``experiments/dryrun_torch/`` (here redirected), never into the
    reference's ``experiments/dryrun/``, whose absence keeps
    ``tests/test_perf.py``'s artifact check skipped."""
    import json
    assert dryrun.OUT_DIR == ROOT / "experiments" / "dryrun_torch"
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    with pytest.raises(SystemExit) as stop:
        dryrun.main(["--arch", "mamba2-2.7b", "--shape", "decode_32k"])
    assert stop.value.code == 0
    meta = json.loads((tmp_path / "mamba2-2.7b__decode_32k__16x16.json")
                      .read_text())
    assert meta["n_devices"] == 256 and meta["strategy"] == "serve"
    assert "dry-run complete: 0 failures" in capsys.readouterr().out
    assert not (ROOT / "experiments" / "dryrun").exists()
    assert not dist.is_initialized()


def test_abstract_trees_allocate_nothing_and_resolve_cuda_without_a_card():
    from repro_torch.launch.steps import (abstract_caches, abstract_opt_state,
                                          abstract_params)
    from repro_torch.train.optimizer import AdamW
    cfg = get_config("jamba-v0.1-52b")
    params = abstract_params(cfg)
    leaves = list(params.parameters())
    assert all(p.device.type == "cuda" for p in leaves)
    ref = ref_steps.abstract_params(ref_configs.get_config(
        "jamba-v0.1-52b"))
    assert sum(p.numel() for p in leaves) == \
        sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(ref))
    state = abstract_opt_state(AdamW(), params)
    assert all(m.dtype == torch.float32 for m in state.mu)
    caches = abstract_caches(cfg, 128, 32768)
    assert len(caches) == cfg.n_layers
    assert np.prod(caches[4][0].shape) == 128 * 8 * 4096 * 128
