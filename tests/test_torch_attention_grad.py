"""The gradient of the port's flash attention: the plain backward against
autograd and against the reference's ``chunked_attention`` under
``jax.vjp``, the autograd Function on the CPU, and on a card the
hand-written backward kernels.

Inputs are made with numpy from a seed.  Tolerances are normwise
(||got - want|| / ||want|| per gradient): float32 1e-5 (sums in other
orders; measured at most 4.4e-7); bfloat16 2^-6 = 1.6e-2, where the
operands, the output, dO and the three gradients each round to bfloat16's
8-bit mantissa and p rounds before ``p v`` at another place in each
version (the backward rounds the normalised p, the forward, which autograd
and ``jax.vjp`` differentiate, the unnormalised one): measured 2.5e-3 to
6.0e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_BLOCKS, KERNEL_HEAD_DIMS, attn_bwd_blocks, attn_bwd_smem_bytes,
    attn_bwd_tile_legal, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_plain)

torch.set_num_threads(1)

TOLS = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
#: (hq, hkv, s, d, mask): causal, window, softcap 50, GQA 4/2, D 16 and 32,
#: S 32 and 64
CASES = [
    (4, 4, 32, 16, dict(causal=True)),
    (4, 2, 64, 32, dict(causal=True)),
    (4, 2, 64, 16, dict(causal=True, window=16)),
    (4, 2, 64, 32, dict(causal=True, softcap=50.0)),
    (4, 2, 32, 32, dict(causal=False, window=8, softcap=50.0)),
    (4, 2, 64, 16, dict(causal=False)),
]


def _arrays(hq, hkv, s, d, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((2, hq, s, d), (2, hkv, s, d), (2, hkv, s, d),
                       (2, hq, s, d))]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t):
    return t.detach().float().numpy()


def _plain_grads(q, k, v, do, kw):
    o, lse = flash_attention_plain(q, k, v, bkv=16, return_lse=True, **kw)
    return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_plain_backward_matches_autograd(hq, hkv, s, d, kw, dtype):
    q, k, v, do = _torch(_arrays(hq, hkv, s, d), dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        flash_attention_plain(*leaves, bkv=16, **kw), leaves, do)
    got = _plain_grads(q, k, v, do, kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _normwise(_np(g), _np(w)) <= TOLS[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_plain_backward_matches_reference_vjp(hq, hkv, s, d, kw, dtype):
    arrays = _arrays(hq, hkv, s, d)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrays)

    def ref(a, b, c):
        return chunked_attention(a, b, c, causal=kw.get("causal", True),
                                 window=kw.get("window", 0),
                                 attn_softcap=kw.get("softcap", 0.0),
                                 chunk=16)

    _, vjp = jax.vjp(ref, jq, jk, jv)
    want = vjp(jdo)
    got = _plain_grads(*_torch(arrays, dtype), kw)
    for name, g, w in zip("qkv", got, want):
        assert _normwise(_np(g), np.asarray(w, np.float32)) <= TOLS[dtype], \
            name


@pytest.mark.parametrize("blocks", [None, 16, 32, 64])
@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_blockwise_backward_equals_all_rows_at_once(hq, hkv, s, d, kw,
                                                    blocks):
    """The plain backward over the kernels' blocks (each query block
    against only its visited kv blocks) against all rows at once; a block
    longer than the sequence is the sequence."""
    q, k, v, do = _torch(_arrays(hq, hkv, s, d), "float32")
    o, lse = flash_attention_plain(q, k, v, bkv=16, return_lse=True, **kw)
    whole = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    bq = None if blocks is None else min(blocks, s)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, bq=bq, **kw)
    for g, w in zip(got, whole):
        assert _normwise(_np(g), _np(w)) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES[:4])
def test_function_on_the_cpu_gives_the_plain_gradients(hq, hkv, s, d, kw,
                                                       dtype):
    """``flash_attention`` with grad-requiring CPU operands runs
    FlashAttentionFn: the same output as without grad, and exactly the
    plain backward's gradients."""
    q, k, v, do = _torch(_arrays(hq, hkv, s, d), dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, bq=16, bkv=16, **kw)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        plain_out = flash_attention(q, k, v, bq=16, bkv=16, **kw)
    assert torch.equal(out.detach(), plain_out)
    got = torch.autograd.grad(out, leaves, do)
    o, lse = flash_attention_fwd(q, k, v, bq=16, bkv=16, **kw)
    assert torch.equal(o, plain_out)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                     bq=attn_bwd_blocks(s), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_no_grad_path_saves_nothing():
    q, k, v, _ = _torch(_arrays(4, 2, 32, 16), "float32")
    out = flash_attention(q, k, v, bq=16, bkv=16)
    assert out.grad_fn is None
    assert torch.equal(out, flash_attention_plain(q, k, v, bq=16, bkv=16))


def test_backward_takes_equal_lengths_only():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 32, 16)).astype(
        np.float32)).requires_grad_()
    kv = torch.from_numpy(rng.standard_normal((1, 2, 64, 16)).astype(
        np.float32))
    with pytest.raises(ValueError, match="Sq = Skv"):
        flash_attention(q, kv, kv, bq=16, bkv=16)
    with pytest.raises(ValueError, match="Sq = Skv"):
        flash_attention_bwd_plain(q.detach(), kv, kv, q.detach(),
                                  torch.zeros(1, 2, 32), q.detach())


@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_lse_is_the_rows_log_sum_exp(hq, hkv, s, d, kw):
    q, k, v, _ = _torch(_arrays(hq, hkv, s, d), "float32")
    _, lse = flash_attention_plain(q, k, v, bkv=16, bq=16, return_lse=True,
                                   **kw)
    kr = k.repeat_interleave(hq // hkv, dim=1)
    x = (q @ kr.transpose(-1, -2)) / d ** 0.5
    cap = kw.get("softcap", 0.0)
    if cap:
        x = cap * torch.tanh(x / cap)
    pos = torch.arange(s)
    keep = torch.ones(s, s, dtype=torch.bool)
    if kw.get("causal", True):
        keep &= pos[:, None] >= pos[None, :]
    if kw.get("window", 0):
        keep &= (pos[:, None] - pos[None, :]) < kw["window"]
    want = torch.logsumexp(torch.where(keep, x, -torch.inf), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_backward_blocks_and_legality():
    assert BWD_BLOCKS == (32, 64)
    assert attn_bwd_blocks(4096) == 64 and attn_bwd_blocks(96) == 32
    assert attn_bwd_blocks(48) == 48          # none divides: one block
    # mma.sync: k, v and two stages of q and dO; two stages of lse and
    # delta; in bfloat16 also two column slices' float32 dK sums
    assert attn_bwd_smem_bytes(64, 128) == 197_632
    assert attn_bwd_smem_bytes(32, 128, itemsize=2) == 82_432
    assert attn_bwd_smem_bytes(64, 32, itemsize=2) == 41_984
    # wgmma (bfloat16 at blocks 64 and 128, head dims 64 and 128): the
    # dK/dV kernel's 64-row k and v, two stages of 64-row q and dO tiles
    # with their lse and delta rows and of the 64 x 64 float32 p (1 - t^2)
    # passed between its warpgroups, the float32 dK and dV sums, alignment
    # and barriers; at either block
    assert attn_bwd_smem_bytes(64, 128, itemsize=2) == 165_928
    assert attn_bwd_smem_bytes(128, 128, itemsize=2) == 165_928
    assert attn_bwd_smem_bytes(128, 64, itemsize=2) == 84_008
    assert attn_bwd_blocks(4096, torch.bfloat16, 128) == 128
    assert attn_bwd_blocks(4096, torch.bfloat16, 32) == 64
    assert attn_bwd_blocks(96, torch.bfloat16, 128) == 32
    for blk in BWD_BLOCKS:
        for d in KERNEL_HEAD_DIMS:
            for itemsize in (4, 2):
                assert attn_bwd_tile_legal(4096, blk, d, itemsize)
    assert not attn_bwd_tile_legal(48, 48, 16)       # block not built
    assert not attn_bwd_tile_legal(96, 64, 16)       # does not divide
    assert attn_bwd_tile_legal(128, 64, 96)          # padded to 128
    assert attn_bwd_smem_bytes(64, 80) == attn_bwd_smem_bytes(64, 128)
    assert not attn_bwd_tile_legal(128, 64, 160)     # head dim over 128
    assert not attn_bwd_tile_legal(128, 64, 128, smem_limit=100_000)
    assert not attn_bwd_tile_legal(128, 64, 128, 2, smem_limit=165_927)
    assert attn_bwd_tile_legal(128, 64, 128, 2, smem_limit=165_928)
    assert attn_bwd_tile_legal(4096, 128, 128, 2)    # wgmma
    assert not attn_bwd_tile_legal(4096, 128, 128)   # float32: no route


# ---------------------------------------------------------------- on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernels run only there "
                    "(chip_smoke.py phase 14 holds them against the plain "
                    "backward on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_backward_kernels_match_plain_on_the_card(card, hq, hkv, s, d, kw,
                                                  dtype):
    """Through autograd: one backward launch, gradients within the
    float32 bound of the plain backward on the same operands (both round
    the same p; bfloat16 gradients round once more, 2^-12)."""
    q, k, v, do = (t.to(card) for t in _torch(_arrays(hq, hkv, s, d),
                                              dtype))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, bq=16, bkv=16, **kw)
    before = flash_attention_bwd.launches
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    o, lse = flash_attention_plain(q, k, v, bkv=16, bq=16, return_lse=True,
                                   **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                     bq=attn_bwd_blocks(s), **kw)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -12
    for g, w in zip(got, want):
        assert _normwise(g.float().cpu().numpy(), w.float().cpu().numpy()) \
            <= tol
    # every block that divides the sequence, called directly, twice: the
    # same bits each time
    for blk in (b for b in BWD_BLOCKS if s % b == 0):
        first = flash_attention_bwd(q, k, v, o, lse, do, blk=blk, **kw)
        again = flash_attention_bwd(q, k, v, o, lse, do, blk=blk, **kw)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, bq=blk, **kw)
        for g, h, w in zip(first, again, want):
            assert torch.equal(g, h)
            assert _normwise(g.float().cpu().numpy(),
                             w.float().cpu().numpy()) <= tol


@pytest.mark.cuda
def test_backward_refuses_what_the_kernels_do_not_take(card):
    """A CUDA operand the kernels do not take raises; nothing falls back
    to the plain version."""
    q, k, v, do = (t.to(card) for t in _torch(_arrays(4, 2, 64, 32),
                                              "float32"))
    o, lse = flash_attention_fwd(q, k, v, bq=16, bkv=16)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="do not take"):
        flash_attention_bwd(q, k, v, o, lse, do, blk=16)  # block not built
    q48, k48, v48, do48 = (t.to(card) for t in _torch(
        _arrays(4, 2, 48, 32), "float32"))
    o48, lse48 = flash_attention_fwd(q48, k48, v48, bq=16, bkv=16)
    with pytest.raises(ValueError, match="do not take"):
        flash_attention_bwd(q48, k48, v48, o48, lse48, do48)  # 48: no block
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v, o, lse, do)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_bwd(q.half(), k.half(), v.half(), o.half(), lse,
                            do.half())
    assert flash_attention_bwd.launches == before


@pytest.mark.cuda
def test_ssd_refuses_a_gradient_on_the_card(card):
    """The name dates from the slices before the SSD had a backward, when
    a scan on the card refused an operand that required grad.  Now the
    gradient flows through the backward kernels (``csrc/ssd_bwd.cu``) and
    matches the plain route's, autograd through ``ssd_plain``."""
    from repro_torch.kernels import ssd
    from repro_torch.kernels.ssd import ssd_bwd, ssd_plain
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 64, 2, 16)).astype(
        np.float32)).to(card)
    dt = torch.full((1, 64, 2), 0.01, device=card)
    a_log = torch.zeros(2, device=card)
    b = torch.from_numpy(rng.standard_normal((1, 64, 1, 16)).astype(
        np.float32)).to(card)
    grads = []
    for scan in (ssd, ssd_plain):
        leaves = [t.clone().requires_grad_() for t in (x, dt, a_log, b)]
        before = ssd_bwd.launches
        y = scan(*leaves, leaves[3], chunk=32)
        grads.append(torch.autograd.grad((y * y).sum(), leaves))
        assert ssd_bwd.launches - before == (scan is ssd)
    torch.cuda.synchronize()
    for name, g, w in zip(("x", "dt", "a_log", "b"), *grads):
        assert _normwise(_np(g.cpu()), _np(w.cpu())) <= 1e-5, name
    with torch.no_grad():
        assert ssd(x, dt, a_log, b, b, chunk=32).shape == x.shape


@pytest.mark.cuda
def test_attend_on_the_card_has_a_gradient(card):
    from repro_torch.models.attention import attend
    q, k, v, _ = (t.to(card) for t in _torch(_arrays(4, 2, 64, 32),
                                             "float32"))
    wq = torch.ones((), device=card, requires_grad=True)
    out = attend(q * wq, k, v, causal=True, window=0, attn_softcap=50.0)
    assert out.grad_fn is not None
    (g,) = torch.autograd.grad(out.sum(), wq)
    assert torch.isfinite(g) and float(g) != 0.0
