"""The port's architecture configs (``repro_torch.configs``) against the
reference's (``repro.configs``): the same registry, every field of every
``ArchConfig`` equal, ``reduced`` giving equal smoke configs, and the
derived sizes (``head_dim_``, ``d_inner``, ``layer_specs``,
``param_count`` in both modes) and ``SHAPES`` equal.  The configs are data
with no backend, so everything is compared exactly."""

import dataclasses

import pytest

import repro.configs as ref_configs
import repro_torch.configs as configs

ARCHS = ref_configs.ALL_ARCHS


def test_registry_matches():
    assert configs.ALL_ARCHS == ARCHS
    assert sorted(configs.all_configs()) == sorted(ref_configs.all_configs())
    assert set(configs.__all__) == set(ref_configs.__all__)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match(arch):
    mine, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert type(mine).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kw", [{}, dict(n_layers=4, d_model=128, d_ff=256,
                                         vocab=1024)])
def test_reduced_matches(arch, kw):
    mine = configs.reduced(configs.get_config(arch), **kw)
    ref = ref_configs.reduced(ref_configs.get_config(arch), **kw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_derived_sizes_match(arch, smoke):
    mine, ref = configs.get_config(arch), ref_configs.get_config(arch)
    if smoke:
        mine, ref = configs.reduced(mine), ref_configs.reduced(ref)
    assert (mine.head_dim_, mine.d_inner) == (ref.head_dim_, ref.d_inner)
    assert [dataclasses.asdict(s) for s in mine.layer_specs()] == \
        [dataclasses.asdict(s) for s in ref.layer_specs()]
    for active_only in (False, True):
        assert mine.param_count(active_only) == ref.param_count(active_only)


def test_shapes_match():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
