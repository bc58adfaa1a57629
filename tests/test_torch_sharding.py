"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), leaf for leaf.

The reference's specs are read from its own ``param_specs`` over its
abstract parameters on the production meshes (one CPU device repeated,
as ``tests/test_distributed.py`` builds them); the port's from fake
parameters (no allocation) and the meshes' axis names and sizes.  Each
port parameter ``blocks.{l}.…`` is held against the reference's stacked
leaf ``blocks/p{l % period}/…`` with its leading periods entry dropped.
Exact equality everywhere, but for the two specs where the reference
shards the periods axis itself: grok-1-314b's router under ``dp`` on both
meshes, which the port replicates over that axis.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro_torch.configs import SHAPES, all_configs, get_config  # noqa: E402
from repro_torch.distributed.sharding import (Spec, axis_sizes,  # noqa: E402
                                              cache_specs, param_specs,
                                              placements, reference_path,
                                              simple_batch_spec)
from repro_torch.launch.steps import abstract_params  # noqa: E402

ARCHS = sorted(all_configs())
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
STRATEGIES = ("tp", "dp", "serve")
#: the reference's only specs on the periods axis (the port replicates)
PERIODS_SHARDED = {("grok-1-314b", "16x16", "dp", "blocks/p0/moe/router"),
                   ("grok-1-314b", "2x16x16", "dp", "blocks/p0/moe/router")}


def _ref_mesh(tag):
    sizes = MESHES[tag]
    n = int(np.prod(list(sizes.values())))
    devs = np.array(jax.devices() * n)[:n].reshape(tuple(sizes.values()))
    return Mesh(devs, tuple(sizes))


def _canonical(spec) -> tuple:
    """A spec's entries with a one-axis tuple written as the axis (JAX
    writes ``P(("pod",))`` so; the two mean the same)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


_REF_ABSTRACT = {}
_PORT_ABSTRACT = {}


def _ref_params(arch):
    if arch not in _REF_ABSTRACT:
        _REF_ABSTRACT[arch] = ref_steps.abstract_params(
            ref_configs.get_config(arch))
    return _REF_ABSTRACT[arch]


def _port_params(arch):
    if arch not in _PORT_ABSTRACT:
        _PORT_ABSTRACT[arch] = abstract_params(get_config(arch),
                                               device="cpu")
    return _PORT_ABSTRACT[arch]


def _ref_leaf_specs(arch, tag, strategy):
    specs = ref_sharding.param_specs(_ref_params(arch), _ref_mesh(tag),
                                     strategy)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {ref_sharding._path_str(path): tuple(sp) for path, sp in flat}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference_leaf_for_leaf(arch, tag, strategy):
    ref = _ref_leaf_specs(arch, tag, strategy)
    model = _port_params(arch)
    got = param_specs(model, MESHES[tag], strategy)
    assert list(got) == [n for n, _ in model.named_parameters()]
    covered, replicated = set(), set()
    for name, spec in got.items():
        assert isinstance(spec, Spec)
        path, stacked = reference_path(name, model.period)
        want = ref[path]
        covered.add(path)
        if stacked:
            if want[0] is not None:
                replicated.add((arch, tag, strategy, path))
            want = want[1:]
        assert _canonical(spec) == _canonical(want), (name, spec,
                                                      ref[path])
    assert covered == set(ref)
    assert replicated == {c for c in PERIODS_SHARDED
                          if c[:3] == (arch, tag, strategy)}


def test_the_comparison_covers_every_reference_leaf_spec():
    """10 configs x 2 meshes x 3 strategies: 1230 reference leaf specs, of
    which the periods axis is sharded in exactly the two named ones."""
    total, on_periods = 0, set()
    for arch in ARCHS:
        for tag in MESHES:
            for strategy in STRATEGIES:
                for path, sp in _ref_leaf_specs(arch, tag,
                                                strategy).items():
                    total += 1
                    if path.startswith("blocks/") and sp[0] is not None:
                        on_periods.add((arch, tag, strategy, path))
    assert total == 1230
    assert on_periods == PERIODS_SHARDED


def test_grok_experts_not_sharded_on_16():
    """grok has 8 experts: expert parallelism on a 16-wide model axis must
    not apply; d_ff (32768) takes it."""
    spec = param_specs(_port_params("grok-1-314b"),
                       MESHES["16x16"])["blocks.0.moe.w_gate"]
    assert spec[0] != "model"
    assert "model" in tuple(spec)


def test_arctic_experts_ep_sharded():
    spec = param_specs(_port_params("arctic-480b"),
                       MESHES["16x16"])["blocks.0.moe.w_gate"]
    assert spec[0] == "model"          # 128 experts over 16 => EP


def test_batch_spec_divisibility():
    mesh = MESHES["2x16x16"]
    assert simple_batch_spec(mesh, 256) == Spec(("pod", "data"))
    assert simple_batch_spec(mesh, 2) == Spec(("pod",))
    assert simple_batch_spec(mesh, 1) == Spec()
    assert simple_batch_spec(mesh, 512, "dp") == \
        Spec(("pod", "data", "model"))
    for batch in (1, 2, 32, 128, 256, 512):
        for strategy in STRATEGIES:
            assert _canonical(simple_batch_spec(mesh, batch, strategy)) == \
                _canonical(ref_sharding.simple_batch_spec(
                    _ref_mesh("2x16x16"), batch, strategy))


DECODE_CELLS = [(arch, shape) for arch in ARCHS
                for shape in get_config(arch).shapes
                if SHAPES[shape].kind == "decode"]


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_cache_specs_equal_the_reference(arch, shape, tag):
    """Every decode cell's cache specs, layer by layer: the reference's
    per-position spec without its periods entry."""
    cfg = get_config(arch)
    batch = SHAPES[shape].global_batch
    ref = ref_sharding.cache_specs(ref_configs.get_config(arch),
                                   _ref_mesh(tag), batch)
    got = cache_specs(cfg, MESHES[tag], batch)
    assert len(got) == cfg.n_layers
    period = len(cfg.block_pattern)
    for layer, spec in enumerate(got):
        want = ref[f"p{layer % period}"]
        if isinstance(want, tuple) and not isinstance(want, P):
            assert isinstance(spec, tuple) and not isinstance(spec, Spec)
            assert [_canonical(s) for s in spec] == \
                [_canonical(tuple(w)[1:]) for w in want]
        else:
            assert isinstance(spec, Spec)
            assert _canonical(spec) == _canonical(tuple(want)[1:])


def test_axis_sizes_and_reference_paths():
    assert axis_sizes({"data": 2, "model": 4}) == {"data": 2, "model": 4}
    assert reference_path("blocks.13.attn.wq", 8) == \
        ("blocks/p5/attn/wq", True)
    assert reference_path("embed", 8) == ("embed", False)


def test_placements_on_a_fake_production_mesh():
    """A spec's placements: Shard on every mesh dim its entries name, in
    mesh order (a dim over ("pod", "data") is pod-major)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert placements(Spec(("pod", "data"), None, "model"), mesh) == \
            [Shard(0), Shard(0), Shard(2)]
        assert placements(Spec(), mesh) == [Replicate()] * 3
        with pytest.raises(ValueError, match="order"):
            placements(Spec(("data", "pod")), mesh)
    finally:
        dist.destroy_process_group()
