"""Attention at head dims the kernels are not instantiated for: 80
(hubert-xlarge) and 96 (phi3-mini-3.8b).  The wrappers zero-pad q, k and
v (o and dO for the backward) to the next instantiated width, keep the
scale at 1/sqrt(D) of the true D and slice the results back
(``padded_forward``, ``padded_backward``).  Here the padded route runs
through the plain versions, the kernels' arithmetic on the CPU, and is
held against the unpadded plain version and the reference's
``attention_ref`` and ``chunked_attention``; the legality rules agree on
what pads.  On a card the same route runs the kernels (the ``cuda`` test
in ``test_torch_models.py`` and chip_smoke phases 6, 12c and 14a).

Inputs are made with numpy from a seed.  Tolerances: the padded route
against the unpadded one 1e-6 elementwise relative to the output's scale
in float32 (zero columns add exact zeros; only the products' blocking
differs); against the reference 2e-5 normwise forward (float32 in other
orders) and 1e-5 normwise backward, as ``test_torch_attention_grad.py``
holds the unpadded plain backward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import attention_ref  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    KERNEL_HEAD_DIMS, attn_bwd_smem_bytes, attn_bwd_tile_legal,
    attn_route, attn_smem_bytes, attn_tile_legal, flash_attention_bwd_plain,
    flash_attention_plain, pad_head_dim, padded_backward, padded_forward,
    padded_head_dim)

torch.set_num_threads(1)

#: (hq, hkv, s, d, mask)
CASES = [
    (4, 4, 64, 80, dict(causal=False)),                    # hubert: encoder
    (4, 2, 64, 80, dict(causal=True, window=16)),
    (4, 4, 64, 96, dict(causal=True)),                     # phi3-mini
    (4, 2, 32, 96, dict(causal=True, softcap=50.0)),
]


def _arrays(hq, hkv, s, d, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((2, hq, s, d), (2, hkv, s, d), (2, hkv, s, d),
                       (2, hq, s, d))]


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _plain_fwd(kw):
    def run(q, k, v, scale):
        return flash_attention_plain(q, k, v, bq=16, bkv=16, return_lse=True,
                                     scale=scale, **kw)
    return run


def _plain_bwd(lse, kw):
    def run(q, k, v, o, do, scale):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, bq=16,
                                         scale=scale, **kw)
    return run


def test_head_dims_pad_to_the_next_instantiated_width():
    assert [padded_head_dim(d) for d in (8, 16, 17, 32, 48, 64, 80, 96,
                                         128)] == \
        [16, 16, 32, 32, 64, 64, 128, 128, 128]
    assert padded_head_dim(129) is None and padded_head_dim(0) is None
    for d in range(1, 129):
        assert padded_head_dim(d) in KERNEL_HEAD_DIMS
        # legality and staging are reckoned at the padded width
        assert attn_tile_legal(4096, 4096, 64, 64, d) == \
            attn_tile_legal(4096, 4096, 64, 64, padded_head_dim(d))
        for dtype in (torch.float32, torch.bfloat16):
            assert attn_smem_bytes(64, 64, d, dtype) == \
                attn_smem_bytes(64, 64, padded_head_dim(d), dtype)
            assert attn_route(dtype, 64, 64, d) == \
                attn_route(dtype, 64, 64, padded_head_dim(d))
        assert attn_bwd_tile_legal(4096, 64, d, 2) == \
            attn_bwd_tile_legal(4096, 64, padded_head_dim(d), 2)
        assert attn_bwd_smem_bytes(64, d) == \
            attn_bwd_smem_bytes(64, padded_head_dim(d))
    assert not attn_tile_legal(4096, 4096, 64, 64, 160)
    t = torch.ones((1, 1, 2, 80))
    padded = pad_head_dim(t, 128)
    assert padded.shape == (1, 1, 2, 128) and padded.is_contiguous()
    assert float(padded[..., 80:].abs().sum()) == 0.0
    assert pad_head_dim(t, 80) is t


@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_padded_forward_equals_the_unpadded_plain_version(hq, hkv, s, d,
                                                          kw):
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(hq, hkv, s, d))
    got, got_lse = padded_forward(q, k, v, _plain_fwd(kw))
    want, want_lse = _plain_fwd(kw)(q, k, v, 1.0 / d ** 0.5)
    assert got.shape == want.shape == q.shape and got.is_contiguous()
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), rtol=1e-6)


@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_padded_backward_equals_the_unpadded_plain_version(hq, hkv, s, d,
                                                           kw):
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(hq, hkv, s, d))
    o, lse = padded_forward(q, k, v, _plain_fwd(kw))
    got = padded_backward(q, k, v, o, do, _plain_bwd(lse, kw))
    want = _plain_bwd(lse, kw)(q, k, v, o, do, 1.0 / d ** 0.5)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.is_contiguous(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * float(w.abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_padded_route_matches_the_reference(hq, hkv, s, d, kw):
    arrays = _arrays(hq, hkv, s, d, seed=8)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    o, lse = padded_forward(q, k, v, _plain_fwd(kw))
    want = attention_ref(jq, jk, jv, causal=kw.get("causal", True),
                         window=kw.get("window", 0),
                         softcap=kw.get("softcap", 0.0))
    assert _normwise(o.numpy(), np.asarray(want)) <= 2e-5

    def ref(a, b, c):
        return chunked_attention(a, b, c, causal=kw.get("causal", True),
                                 window=kw.get("window", 0),
                                 attn_softcap=kw.get("softcap", 0.0),
                                 chunk=16)

    _, vjp = jax.vjp(ref, jq, jk, jv)
    got = padded_backward(q, k, v, o, do, _plain_bwd(lse, kw))
    for name, g, w in zip("qkv", got, vjp(jdo)):
        assert _normwise(g.numpy(), np.asarray(w)) <= 1e-5, name


@pytest.mark.parametrize("arch,d", [("hubert-xlarge", 80),
                                    ("phi3-mini-3.8b", 96)])
def test_the_two_architectures_pad_on_the_card(arch, d):
    """Their full-width head dims are the ones that pad, and every block
    the models' attention picks at those head dims is legal."""
    cfg = configs.get_config(arch)
    assert cfg.head_dim_ == d and padded_head_dim(d) == 128
    for s in (512, 4096):
        assert attn_tile_legal(s, s, 128, 128, d)
        for itemsize in (4, 2):
            assert attn_bwd_tile_legal(s, 64, d, itemsize)
