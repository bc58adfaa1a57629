"""The port's Mamba-2 SSD scan against the JAX Pallas kernel, and its
device-measurement family.

The CUDA kernel runs only on the card (``python3 chip_smoke.py`` holds it
against its plain version and the sequential oracle there; the
``cuda``-marked test below does the same under pytest on a machine with a
card).  Here, on the CPU, the kernel wrapper takes its plain version — the
kernels' three passes (chunk states, the scan over chunks, the outputs) —
which is held against the Pallas kernel in interpret mode on the same numpy
inputs at the reference test's tolerance (2e-4: float32 chunked sums
against a sequential scan).  Its first two passes are held against the
recurrence written out step by step, and the slab visits that the third
pass mirrors against brute force over the causal mask.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ssd as jax_ssd  # noqa: E402
from repro.kernels.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.kernels.ssd import ssd_grid_steps as ref_grid_steps  # noqa: E402
from repro.tc.device import DEVICE_KERNELS as REF_KERNELS  # noqa: E402
from repro_torch.core.sampler import Stats  # noqa: E402
from repro_torch.kernels import ops, ssd  # noqa: E402
from repro_torch.kernels.ref import ssd_ref  # noqa: E402
from repro_torch.kernels.ssd import (ssd_chunk_states_plain,  # noqa: E402
                                     ssd_grid_steps, ssd_key_slabs,
                                     ssd_plain, ssd_proxy_problem,
                                     ssd_query_tiles, ssd_scan_blocks,
                                     ssd_scratch, ssd_scratch_bytes,
                                     ssd_smem_bytes, ssd_tile_legal)
from repro_torch.tc import DEVICE_KERNELS, PredictorSession  # noqa: E402

torch.set_num_threads(1)

H100_SMS = 132
H100_SMEM_OPTIN = 232_448
#: test_kernels_pallas.py::test_ssd_sweep's cases: (l, h, p, g, n, chunk)
CASES = [
    (64, 4, 16, 2, 8, 16),
    (128, 4, 16, 1, 16, 32),
    (64, 8, 8, 4, 8, 64),     # chunk == L
]
TOL = 2e-4
#: the on-card cases beyond the reference's: (l, h, p, g, n, chunk, b).
#: L / Q = 16 chunks, so pass 2 carries the state over many; mamba2-2.7b's
#: width at chunk 64, where pass 3 tiles a chunk and skips slabs
CARD_CASES = [(512, 4, 16, 1, 16, 32, 2), (4096, 80, 64, 1, 128, 64, 1)]


def _inputs(l, h, p, g, n, b=2, seed=7):
    """The reference test's operands: dt = |N(0,1)| 0.1, a_log =
    N(0,1) 0.5, x, b, c standard normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, l, h))) * 0.1).astype(np.float32)
    a_log = (rng.standard_normal((h,)) * 0.5).astype(np.float32)
    bb = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, a_log, bb, cc


@pytest.mark.parametrize("l,h,p,g,n,chunk", CASES)
def test_ssd_plain_matches_pallas_interpret(l, h, p, g, n, chunk):
    arrays = _inputs(l, h, p, g, n)
    ref = jax_ssd(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                  interpret=True)
    before = ssd.launches
    out = ssd(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    assert ssd.launches == before                   # the CPU launches none
    assert out.dtype == torch.float32 and out.shape == (2, l, h, p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("l,h,p,g,n,chunk", CASES)
def test_ssd_ref_matches_reference(l, h, p, g, n, chunk, skip):
    arrays = _inputs(l, h, p, g, n, seed=5)
    d_skip = np.linspace(-1, 1, h).astype(np.float32) if skip else None
    jkw = {"d_skip": jnp.asarray(d_skip)} if skip else {}
    tkw = {"d_skip": torch.from_numpy(d_skip)} if skip else {}
    ref = jax_ssd_ref(*(jnp.asarray(a) for a in arrays), **jkw)
    out = ssd_ref(*(torch.from_numpy(a) for a in arrays), **tkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)
    if not skip:
        ops_out = ops.ssd(*(torch.from_numpy(a) for a in arrays),
                          use_kernel=False)
        np.testing.assert_array_equal(ops_out.numpy(), out.numpy())
        # the chunked plain version against the sequential oracle
        np.testing.assert_allclose(
            ops.ssd(*(torch.from_numpy(a) for a in arrays),
                    chunk=chunk).numpy(), out.numpy(), rtol=TOL, atol=TOL)


def test_long_chunks_stay_finite():
    """Far above the diagonal s_i - s_j is large: exp overflows there, and
    only exponentiating on and below the diagonal keeps G finite."""
    x, dt, a_log, bb, cc = (torch.from_numpy(a) for a in
                            _inputs(256, 2, 8, 1, 8, b=1))
    dt = dt * 40.0                   # cumulative log-decay near -1e3
    out = ssd_plain(x, dt, a_log, bb, cc, chunk=256)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(),
                               ssd_ref(x, dt, a_log, bb, cc).numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("l,h,p,g,n,chunk", CASES)
def test_state_in_and_out_match_the_models_chunked_scan(l, h, p, g, n,
                                                        chunk):
    """``h0`` and ``return_state`` against the reference model's
    ``_ssd_chunked`` (``repro/models/mamba.py``), which takes ``h0`` and
    returns the final state: y and h_final from a nonzero h0, and h_final
    from zero, at the file's tolerance."""
    from repro.models.mamba import _ssd_chunked
    arrays = _inputs(l, h, p, g, n, seed=11)
    x, dt, a_log, bb, cc = arrays
    h0 = np.random.default_rng(12).standard_normal(
        (2, h, p, n)).astype(np.float32)
    a = -jnp.exp(jnp.asarray(a_log))
    ops_ = [torch.from_numpy(t) for t in arrays]
    for start in (None, h0):
        jy, jh = _ssd_chunked(jnp.asarray(x), jnp.asarray(dt), a,
                              jnp.asarray(bb), jnp.asarray(cc), chunk,
                              h0=None if start is None else jnp.asarray(start))
        y, hT = ssd(*ops_, chunk=chunk, return_state=True,
                    h0=None if start is None else torch.from_numpy(start))
        assert hT.shape == (2, h, p, n) and hT.dtype == torch.float32
        np.testing.assert_allclose(hT.numpy(), np.asarray(jh),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                   rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="h0 must be"):
        ssd(*ops_, chunk=chunk, h0=torch.from_numpy(h0[:1]))


@pytest.mark.parametrize("l,h,p,g,n,chunk", CASES)
def test_state_arguments_leave_the_output_bit_for_bit(l, h, p, g, n, chunk):
    """Without ``h0`` the output is the scan from zero whatever
    ``return_state`` says, bit for bit, through ``ssd``, ``ssd_plain`` and
    ``ops.ssd``, and equal to the scan from an explicit zero state."""
    ops_ = [torch.from_numpy(a) for a in _inputs(l, h, p, g, n, seed=13)]
    y = ssd(*ops_, chunk=chunk)
    zero = torch.zeros((2, h, p, n))
    for other in (ssd(*ops_, chunk=chunk, return_state=True)[0],
                  ssd(*ops_, chunk=chunk, h0=zero),
                  ssd_plain(*ops_, chunk=chunk),
                  ops.ssd(*ops_, chunk=chunk)):
        np.testing.assert_array_equal(other.numpy(), y.numpy())


def _recurrence_states(x, dt, a_log, bb, chunk):
    """The state entering each chunk by the recurrence h_t = h_{t-1}
    exp(a dt_t) + dt_t x_t (x) b_t, one step at a time (float64)."""
    bsz, l, h, p = x.shape
    g, n = bb.shape[2], bb.shape[3]
    a = -np.exp(a_log.astype(np.float64))
    bh = np.repeat(bb.astype(np.float64), h // g, axis=2)   # (B, L, H, N)
    state = np.zeros((bsz, h, p, n))
    entering = []
    for t in range(l):
        if t % chunk == 0:
            entering.append(state.copy())
        d = dt[:, t].astype(np.float64)                     # (B, H)
        state = state * np.exp(a * d)[..., None, None] + \
            (d[..., None] * x[:, t])[..., None] * bh[:, t, :, None, :]
    return np.stack(entering, axis=2)                       # (B,H,C,P,N)


@pytest.mark.parametrize("l,h,p,g,n,chunk",
                         CASES + [(96, 6, 8, 3, 16, 16)])
def test_chunk_entry_states_match_the_recurrence(l, h, p, g, n, chunk):
    """Passes 1 and 2 of the plain version: the state entering each chunk
    is the recurrence's state after the chunk before, and s is each
    chunk's own cumulative log-decay."""
    x, dt, a_log, bb, cc = _inputs(l, h, p, g, n, seed=3)
    s, h_in = ssd_chunk_states_plain(*(torch.from_numpy(a) for a in
                                       (x, dt, a_log, bb)), chunk=chunk)
    assert s.shape == (2, h, l) and h_in.shape == (2, h, l // chunk, p, n)
    np.testing.assert_allclose(h_in.numpy(),
                               _recurrence_states(x, dt, a_log, bb, chunk),
                               rtol=TOL, atol=TOL)
    a = -np.exp(a_log.astype(np.float64))
    ad = (dt.astype(np.float64) * a).transpose(0, 2, 1)     # (B, H, L)
    want = np.cumsum(ad.reshape(2, h, l // chunk, chunk), axis=-1)
    np.testing.assert_allclose(s.numpy(), want.reshape(2, h, l),
                               rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("chunk", [16, 32, 64, 128, 256, 512])
def test_scan_visits_each_kept_pair_once(chunk):
    """Pass 3's query tiles and key slabs against brute force over the
    causal mask: every pair i >= j of a chunk lies in exactly one visited
    (query tile, key slab); no visited slab lies wholly above the
    diagonal; the launch order is a permutation, heaviest tiles first."""
    r = min(chunk, 64)
    order = ssd_query_tiles(chunk)
    assert sorted(order) == list(range(chunk // r))
    visits = [len(ssd_key_slabs(t)) for t in order]
    assert visits == sorted(visits, reverse=True)
    hits = np.zeros((chunk, chunk), dtype=int)
    for t in order:
        for k in ssd_key_slabs(t):
            i = np.arange(t * r, (t + 1) * r)[:, None]
            j = np.arange(k * r, (k + 1) * r)[None, :]
            assert (i >= j).any()                 # not above the diagonal
            hits[t * r:(t + 1) * r, k * r:(k + 1) * r] += 1
    kept = np.tril(np.ones((chunk, chunk), dtype=bool))
    assert (hits[kept] == 1).all() and (hits <= 1).all()
    assert ssd_scan_blocks(2, 4 * chunk, 3, chunk) == \
        2 * 3 * 4 * sum(1 for _ in order)


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (2, 64, 4, 16, 2, 8, 16), (1, 4096, 80, 64, 1, 128, 32),
    (1, 4096, 80, 64, 1, 128, 256)])
def test_scratch_bytes_are_what_the_wrapper_allocates(b, l, h, p, g, n,
                                                      chunk):
    x = torch.empty((b, l, h, p), device="meta")
    bb = torch.empty((b, l, g, n), device="meta")
    s, states = ssd_scratch(x, bb, chunk)
    assert s.dtype == states.dtype == torch.float32
    assert s.shape == (b, h, l) and states.shape == (b, h, l // chunk, p, n)
    assert ssd_scratch_bytes(b, l, h, p, n, chunk) == \
        4 * (s.numel() + states.numel())
    if (l, h, chunk) == (4096, 80, 32):       # mamba2-2.7b at chunk 32
        assert 4 * states.numel() == 335_544_320


@pytest.mark.parametrize("b,l,h,chunk", [
    (1, 64, 1, 16), (2, 128, 4, 32), (1, 4096, 80, 256), (3, 8192, 16, 64),
    (1, 256, 264, 128)])
def test_ssd_grid_steps_match_reference(b, l, h, chunk):
    assert ssd_grid_steps(b, l, h, chunk) == ref_grid_steps(b, l, h, chunk)


@pytest.mark.parametrize("problem", [(1, 64, 4, 16, 2, 8),
                                     (2, 128, 8, 8, 4, 16),
                                     (1, 4096, 80, 64, 1, 128)])
def test_ssd_transfer_bytes_match_reference(problem):
    mine, ref = DEVICE_KERNELS["cuda_ssd"], REF_KERNELS["pallas_ssd"]
    for itemsize in (2, 4):
        assert mine.transfer_bytes(problem, itemsize) == \
            ref.transfer_bytes(problem, itemsize)
    assert mine.operand_shapes(problem) == ref.operand_shapes(problem)
    cfg = (16, problem[3], problem[5])
    assert mine.steps(problem, cfg) == ref.steps(problem, cfg)
    # the measured operands are the reference's: dt 1e-3, a_log 0
    rng = np.random.default_rng(0)
    x, dt, a_log, bb, cc = mine.operands(problem, rng)
    assert (dt == np.float32(1e-3)).all() and (a_log == 0).all()
    assert x.shape == tuple(problem[:4]) and bb.shape == cc.shape


@pytest.mark.parametrize("chunk", [32, 64, 128, 256])
def test_ssd_proxy_fills_the_card(chunk):
    kernel = DEVICE_KERNELS["cuda_ssd"]
    cfg = (chunk, 64, 128)
    for steps in (16, 2):
        b, l, h, p, g, n = problem = ssd_proxy_problem(*cfg,
                                                       steps_per_dim=steps)
        assert (p, g, n) == (64, 1, 128) and l == chunk * steps
        # pass 1 launches one block per (b, h, chunk)
        assert ssd_grid_steps(b, l, h, chunk) >= H100_SMS
        assert kernel.proxy_steps(cfg, steps) == \
            ssd_grid_steps(b, l, h, chunk) == kernel.steps(problem, cfg)
    # mamba2-2.7b's problem at batch 1 fills the card as well
    assert ssd_grid_steps(1, 4096, 80, chunk) >= 1280 >= H100_SMS


def test_ssd_legality_takes_the_models_chunk_and_the_smem_limit():
    # mamba2-2.7b: P 64, N 128, chunk 256 at L = 4096, on the wgmma route
    assert ssd_tile_legal(4096, 256, 64, 128)
    assert ssd_smem_bytes(256, 64, 128) == 218_192 <= H100_SMEM_OPTIN
    # pass 3 runs one block an SM, its staging the same at every chunk of
    # the path from 64 up (its query tiles and key slabs are 64 rows)
    assert all(ssd_smem_bytes(c, 64, 128) == 218_192 for c in (64, 128, 256))
    assert ssd_smem_bytes(32, 64, 128) <= H100_SMEM_OPTIN
    assert all(ssd_tile_legal(4096, c, 64, 128) for c in (32, 64, 128, 256))
    assert not ssd_tile_legal(4096, 256, 64, 128,
                              smem_limit=100_000)     # over the limit
    assert ssd_tile_legal(4096, 256, 16, 16, smem_limit=100_000)
    assert not ssd_tile_legal(4096, 48, 64, 128)      # not a row multiple
    assert not ssd_tile_legal(4096, 96, 64, 128)
    assert not ssd_tile_legal(4096, 8, 64, 128)
    assert not ssd_tile_legal(4000, 256, 64, 128)     # does not divide
    assert not ssd_tile_legal(4096, 256, 128, 128)    # P not built
    assert not ssd_tile_legal(4096, 256, 64, 256)     # N not built
    # on the mma_sync route the chunk's own staging grows with it, past the
    # limit eventually; the wgmma route's does not grow with the chunk
    assert not ssd_tile_legal(2 ** 16, 2 ** 15, 32, 128)
    assert ssd_tile_legal(2 ** 16, 2 ** 15, 64, 128)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, dt, a_log, bb, cc = (torch.from_numpy(a)
                            for a in _inputs(64, 4, 16, 2, 8, b=1))
    with pytest.raises(ValueError, match="divide"):
        ssd(x, dt, a_log, bb, cc, chunk=48)
    with pytest.raises(ValueError, match="multiple"):
        ssd(x, dt, a_log, bb[:, :, :1].expand(1, 64, 3, 8).contiguous(),
            cc[:, :, :1].expand(1, 64, 3, 8).contiguous())
    with pytest.raises(ValueError, match="disagree"):
        ssd(x, dt[:, :32], a_log, bb, cc)
    meta = [torch.empty(t.shape, device="meta") for t in
            (x, dt, a_log, bb, cc)]
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ssd(*meta, chunk=16)


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py checks the kernel")
    from repro_torch import to_torch
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.ssd(*(to_torch(a, device)
                      for a in _inputs(64, 4, 16, 2, 8, b=1)), chunk=16)


# ------------------------------------------------------- device family --

def _sweep(kernel_name, configs):
    """Deterministic per-call costs: proportional to the proxy's steps,
    with a per-step cost that is a pure function of the config."""
    kernel = DEVICE_KERNELS[kernel_name]
    out = {}
    for cfg in configs:
        chunk, p, n = cfg
        per_step = 1e-6 + 1e-10 * chunk * chunk + 2e-11 * chunk * p * n
        t = per_step * kernel.proxy_steps(cfg, 2)
        out[cfg] = (Stats(0.9 * t, t, 1.2 * t, 1.02 * t, 0.05 * t),
                    1e-3, 10.0 * t)
    return out


def _xfer(direction, nbytes, repetitions):
    bw = 20e9 if direction == "h2d" else 10e9
    return [5e-6 + nbytes / bw] * repetitions


def test_ssd_family_ranks_and_decomposes():
    session = PredictorSession(repetitions=2)
    session.device_suite(device="cpu", steps_per_dim=2, sweep_fn=_sweep,
                         transfer_measure_fn=_xfer)
    problem = (1, 4096, 80, 64, 1, 128)
    configs = [(c, 64, 128) for c in (32, 64, 128, 256)]
    ranked = session.rank_device_tiles("cuda_ssd", problem, configs)
    assert sorted(r.config for r in ranked) == sorted(configs)
    assert [r.t_total for r in ranked] == sorted(r.t_total for r in ranked)
    in_b, out_b = REF_KERNELS["pallas_ssd"].transfer_bytes(problem, 4)
    for r in ranked:
        chunk = r.config[0]
        per_step = 1e-6 + 1e-10 * chunk * chunk + 2e-11 * chunk * 64 * 128
        assert r.per_step_s == pytest.approx(per_step, rel=1e-12)
        assert r.t_compute == pytest.approx(
            per_step * ssd_grid_steps(1, 4096, 80, chunk), rel=1e-12)
        assert r.t_h2d == pytest.approx(5e-6 + in_b / 20e9, rel=1e-6)
        assert r.t_d2h == pytest.approx(5e-6 + out_b / 10e9, rel=1e-6)
    assert session.suite.measured == len(configs)
    # ranking again measures nothing new
    session.rank_device_tiles("cuda_ssd", problem, configs)
    assert session.suite.measured == len(configs)


# ------------------------------------------------------------- on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel runs only "
                    "there (chip_smoke.py checks it on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("l,h,p,g,n,chunk,b", CARD_CASES)
def test_kernel_state_in_and_out_match_plain_on_the_card(card, l, h, p, g, n,
                                                         chunk, b):
    ops_ = [torch.from_numpy(a).to(card)
            for a in _inputs(l, h, p, g, n, b=b)]
    h0 = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (b, h, p, n)).astype(np.float32)).to(card)
    y, hT = ssd(*ops_, chunk=chunk, h0=h0, return_state=True)
    torch.cuda.synchronize()
    want_y, want_h = ssd_plain(*ops_, chunk=chunk, h0=h0, return_state=True)
    for got, want in ((y, want_y), (hT, want_h)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("l,h,p,g,n,chunk,b",
                         [c + (2,) for c in CASES] + CARD_CASES)
def test_kernel_matches_plain_and_ref_on_the_card(card, l, h, p, g, n,
                                                  chunk, b):
    ops_ = [torch.from_numpy(a).to(card)
            for a in _inputs(l, h, p, g, n, b=b)]
    before = ssd.launches
    out = ssd(*ops_, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    for want in (ssd_plain(*ops_, chunk=chunk), ssd_ref(*ops_)):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   rtol=TOL, atol=TOL)
