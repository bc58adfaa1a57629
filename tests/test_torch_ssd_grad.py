"""The gradient of the port's SSD scan: the plain backward
(``ssd_bwd_plain``, the passes the backward kernels run) against autograd
through ``ssd_plain`` in float64 and against ``jax.vjp`` of the reference
model's ``_ssd_chunked``, its reverse state pass against brute force, the
autograd Function on the CPU, and on a card the hand-written backward
kernels of ``csrc/ssd_bwd.cu``.

Inputs are made with numpy from a seed.  Tolerances are normwise
(||got - want|| / ||want|| per gradient): 1e-5 against float64 autograd
(the same arithmetic in other orders; measured at most 1.2e-15), 1e-4
against the reference's float32 ``jax.vjp`` (float32 sums in other
orders, through exponentials of the cumulative decay; measured at most
7.2e-7), 1e-5 for the kernels on a card against the plain backward in
float64 (phase 15a's gate).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.mamba import _ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd import (KERNEL_HEAD_DIMS,  # noqa: E402
                                     KERNEL_STATES, SsdFn, _plain_parts,
                                     ssd, ssd_bwd, ssd_bwd_legal,
                                     ssd_bwd_plain, ssd_bwd_route,
                                     ssd_bwd_smem_bytes,
                                     ssd_plain,
                                     ssd_state_grads_plain, ssd_tile_legal)

torch.set_num_threads(1)

NAMES = ("x", "dt", "a_log", "b", "c", "h0")
#: (batch, L, H, P, G, N, chunk): G = 1 and G = 2 at H = 4, chunks 16, 32
#: and 64, each L several chunks long
CASES = [
    (2, 64, 4, 8, 1, 8, 16),
    (1, 96, 4, 16, 2, 8, 32),
    (2, 128, 4, 8, 2, 16, 32),
    (1, 192, 4, 8, 1, 16, 64),
    (2, 128, 4, 16, 2, 8, 64),
]


def _arrays(bsz, l, h, p, g, n, seed=0):
    """x, dt, a_log, b, c, h0, dy, dh_final as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bsz, l, h, p)),
            rng.uniform(0.01, 0.2, (bsz, l, h)),
            0.5 * rng.standard_normal(h),
            rng.standard_normal((bsz, l, g, n)) / np.sqrt(n),
            rng.standard_normal((bsz, l, g, n)) / np.sqrt(n),
            rng.standard_normal((bsz, h, p, n)),
            rng.standard_normal((bsz, l, h, p)),
            rng.standard_normal((bsz, h, p, n))]


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t):
    return t.detach().double().numpy()


def _plain_grads(ops, dy, dh, chunk):
    """ssd_bwd_plain on the plain forward's own s and h_in."""
    with torch.no_grad():
        _, _, s, h_in = _plain_parts(*ops[:5], chunk, ops[5])
        return ssd_bwd_plain(*ops[:5], s, h_in, dy, dh, chunk=chunk)


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("bsz,l,h,p,g,n,chunk", CASES)
def test_plain_backward_matches_float64_autograd(bsz, l, h, p, g, n, chunk,
                                                 with_dh):
    arrays = [torch.from_numpy(a) for a in _arrays(bsz, l, h, p, g, n)]
    ops, dy, dh = arrays[:6], arrays[6], arrays[7] if with_dh else None
    leaves = [t.clone().requires_grad_() for t in ops]
    y, h_final = ssd_plain(*leaves[:5], chunk=chunk, h0=leaves[5],
                           return_state=True)
    loss = (y * dy).sum() + ((h_final * dh).sum() if with_dh else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = _plain_grads(ops, dy, dh, chunk)
    for name, gg, w in zip(NAMES, got, want):
        assert gg.shape == w.shape, name
        assert _normwise(_np(gg), _np(w)) <= 1e-5, name


@pytest.mark.parametrize("bsz,l,h,p,g,n,chunk", CASES)
def test_plain_backward_matches_the_reference_vjp(bsz, l, h, p, g, n,
                                                  chunk):
    arrays = _arrays(bsz, l, h, p, g, n, seed=1)
    j = [jnp.asarray(a, jnp.float32) for a in arrays]

    def ref(x, dt, a_log, b, c, h0):
        return _ssd_chunked(x, dt, -jnp.exp(a_log), b, c, chunk, h0=h0)

    _, vjp = jax.vjp(ref, *j[:6])
    want = vjp((j[6], j[7]))
    ts = [torch.from_numpy(a.astype(np.float32)) for a in arrays]
    got = _plain_grads(ts[:6], ts[6], ts[7], chunk)
    for name, gg, w in zip(NAMES, got, want):
        assert _normwise(_np(gg), np.asarray(w, np.float64)) <= 1e-4, name


@pytest.mark.parametrize("bsz,l,h,p,g,n,chunk", CASES[:3])
def test_reverse_state_pass_matches_brute_force(bsz, l, h, p, g, n, chunk):
    """dS_c, the gradient of the state leaving chunk c, is the gradient of
    the loss over the chunks after c with respect to the state entering
    them; dh0 the whole loss's with respect to h0."""
    x, dt, a_log, b, c, h0, dy, dh = (torch.from_numpy(a) for a in
                                      _arrays(bsz, l, h, p, g, n, seed=2))
    _, _, s, h_in = _plain_parts(x, dt, a_log, b, c, chunk, h0)
    d_s, ds_q, dh0 = ssd_state_grads_plain(c, s, h_in, dy, dh, chunk=chunk)
    nc = l // chunk
    np.testing.assert_array_equal(_np(d_s[:, :, nc - 1]), _np(dh))
    for ci in range(nc - 1):
        t0 = (ci + 1) * chunk
        leaf = h_in[:, :, ci + 1].clone().requires_grad_()
        y, h_final = ssd_plain(x[:, t0:], dt[:, t0:], a_log, b[:, t0:],
                               c[:, t0:], chunk=chunk, h0=leaf,
                               return_state=True)
        loss = (y * dy[:, t0:]).sum() + (h_final * dh).sum()
        (want,) = torch.autograd.grad(loss, leaf)
        assert _normwise(_np(d_s[:, :, ci]), _np(want)) <= 1e-12, ci
    e_q = torch.exp(s.reshape(bsz, h, nc, chunk)[..., -1])
    np.testing.assert_allclose(
        _np(ds_q), _np(e_q * (d_s * h_in).sum((-1, -2))), rtol=1e-12)
    leaf = h0.clone().requires_grad_()
    y, h_final = ssd_plain(x, dt, a_log, b, c, chunk=chunk, h0=leaf,
                           return_state=True)
    (want,) = torch.autograd.grad((y * dy).sum() + (h_final * dh).sum(),
                                  leaf)
    assert _normwise(_np(dh0), _np(want)) <= 1e-12


def test_ssd_function_passes_gradcheck_in_float64():
    x, dt, a_log, b, c, h0, _, _ = (torch.from_numpy(a) for a in
                                    _arrays(1, 32, 2, 4, 1, 4, seed=3))
    leaves = [t.clone().requires_grad_() for t in (x, dt, a_log, b, c, h0)]
    assert torch.autograd.gradcheck(
        lambda *t: SsdFn.apply(*t, 16), leaves)
    # y alone: the final state's gradient is absent, and so is h0
    assert torch.autograd.gradcheck(
        lambda *t: SsdFn.apply(*t, None, 16)[0], leaves[:5])


def test_ssd_routes_a_gradient_through_the_function_on_the_cpu():
    arrays = [torch.from_numpy(a.astype(np.float32))
              for a in _arrays(2, 64, 4, 8, 2, 8, seed=4)]
    leaves = [t.clone().requires_grad_() for t in arrays[:6]]
    y, h_final = ssd(*leaves[:5], chunk=16, h0=leaves[5], return_state=True)
    assert type(y.grad_fn).__name__ == "SsdFnBackward"
    got = torch.autograd.grad((y * arrays[6]).sum() +
                              (h_final * arrays[7]).sum(), leaves)
    want = _plain_grads(arrays[:6], arrays[6], arrays[7], 16)
    for name, gg, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(_np(gg), _np(w), err_msg=name)
    with torch.no_grad():
        np.testing.assert_array_equal(
            _np(y), _np(ssd_plain(*arrays[:5], chunk=16, h0=arrays[5])))


def test_backward_takes_whatever_the_forward_takes():
    """Every (chunk, P, N) the forward admits, the backward admits: its
    chunk pass stages at most 221,872 bytes on the route it takes (the
    wgmma route at mamba2-2.7b's (64, 128) 220,288, the mma_sync route's
    largest 156,160), the card's opt-in is 232,448."""
    assert ssd_bwd_smem_bytes(256, 64, 128) == 220_288
    assert ssd_bwd_smem_bytes(64, 64, 128) == 220_288
    assert ssd_bwd_smem_bytes(64, 32, 128) == 156_160
    assert max(ssd_bwd_smem_bytes(chunk, p, n)
               for chunk in (16, 32, 64) for p in KERNEL_HEAD_DIMS
               for n in KERNEL_STATES) == 221_872
    assert max(ssd_bwd_smem_bytes(chunk, p, n)
               for chunk in (16, 32, 64) for p in KERNEL_HEAD_DIMS
               for n in KERNEL_STATES
               if ssd_bwd_route(p, n, chunk) == "mma_sync") == 156_160
    for chunk in (16, 32, 64, 128, 256, 512, 1024):
        for p in KERNEL_HEAD_DIMS:
            for n in KERNEL_STATES:
                assert ssd_bwd_legal(4096, chunk, p, n) == \
                    ssd_tile_legal(4096, chunk, p, n), (chunk, p, n)
    assert not ssd_bwd_legal(4096, 48, 64, 128)          # chunk 48
    assert not ssd_bwd_legal(4096, 64, 64, 128, smem_limit=220_287)


def test_backward_refuses_operands_that_disagree():
    arrays = [torch.from_numpy(a.astype(np.float32))
              for a in _arrays(1, 64, 4, 8, 1, 8, seed=5)]
    x, dt, a_log, b, c, h0, dy, dh = arrays
    _, _, s, h_in = _plain_parts(x, dt, a_log, b, c, 16, h0)
    with pytest.raises(ValueError, match="ssd_bwd needs"):
        ssd_bwd(x, dt, a_log, b, c, s, h_in[:, :, :2], dy, dh, chunk=16)
    with pytest.raises(ValueError, match="ssd_bwd needs"):
        ssd_bwd(x, dt, a_log, b, c, s, h_in, dy[:, :32], dh, chunk=16)


# ---------------------------------------------------------------- on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD backward kernels run only "
                    "there (chip_smoke.py phase 15a holds them against the "
                    "plain backward on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,l,h,p,g,n,chunk", CASES)
def test_backward_kernels_match_plain_and_repeat_bit_for_bit(
        card, bsz, l, h, p, g, n, chunk):
    arrays = [torch.from_numpy(a.astype(np.float32)).to(card)
              for a in _arrays(bsz, l, h, p, g, n, seed=6)]
    x, dt, a_log, b, c, h0, dy, dh = arrays
    leaves = [t.clone().requires_grad_() for t in (x, dt, a_log, b, c, h0)]
    before = ssd_bwd.launches
    y, h_final = ssd(*leaves[:5], chunk=chunk, h0=leaves[5],
                     return_state=True)
    loss = (y * dy).sum() + (h_final * dh).sum()
    got = torch.autograd.grad(loss, leaves, retain_graph=True)
    again = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert ssd_bwd.launches - before == 2
    want = _plain_grads([t.double().cpu() for t in arrays[:6]],
                        dy.double().cpu(), dh.double().cpu(), chunk)
    for name, gg, a2, w in zip(NAMES, got, again, want):
        assert torch.equal(gg, a2), name
        assert _normwise(_np(gg.cpu()), _np(w)) <= 1e-5, name
