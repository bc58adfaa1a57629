"""The arithmetic of the SSD forward on the tensor cores
(``src/repro_torch/kernels/csrc/ssd.cu``), emulated on the CPU against the
reference: the Pallas kernel ``repro.kernels.ssd`` in interpret mode and
the reference model's ``_ssd_chunked``.

Passes 1 and 3 run every product with ``mma.sync`` as three TF32 products
(hi hi + hi lo + lo hi; the helpers are test_torch_ssd_bwd_tc.py's): each
m16n8k8 step's eight products added exactly to a tensor-core accumulator
that truncates to float32, in the kernels' order and chain lengths.

* Pass 1, per head: ``s`` the cumulative sum of ``a dt`` in float32, ``w =
  dt exp(s_Q - s)``, and ``S_c = (X o w)^T B`` over slabs of 32 steps,
  each slab a chain from zero added to the float32 sum.
* Pass 2, per head: ``h_in[c] = h``, ``h = fma(exp(s_Q), h, S_c)``.
* Pass 3, per 64-row query tile: ``y = exp(s_i) (C h_in^T)`` in chains of
  64 of depth N, then for each key slab on and below the diagonal ``C
  B^T`` as a pair tile (the hi hi products in one accumulator, the small
  terms in another), formed once for the group's heads, and for each head
  ``G = (C B^T o exp(s_i - s_j)) o dt_j`` where i >= j, its ``G X`` a
  chain from zero over the slab added to y.

The shape is mamba2-2.7b's in small: P 64, N 128, one group of 4 heads,
chunk 256 over 2 chunks, inputs from a seed, with and without ``h0``.  The
gates are phase 6's: 1e-5 normwise (chip_smoke's ``WIDE_TOL["float32"]``)
and test_torch_ssd.py's 2e-4 elementwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ssd as pallas_ssd  # noqa: E402
from repro.models.mamba import _ssd_chunked  # noqa: E402
from repro_torch.kernels._card import H100_SMEM_OPTIN  # noqa: E402
from repro_torch.kernels.ssd import (KERNEL_HEAD_DIMS,  # noqa: E402
                                     KERNEL_STATES, ssd_plain,
                                     ssd_scan_blocks, ssd_scan_heads,
                                     ssd_smem_bytes, ssd_state_heads,
                                     ssd_tile_legal)
from test_torch_ssd_bwd_tc import (_chain, _chunked, _fma,  # noqa: E402
                                   _normwise, _sum, _tile, _unchunked)

torch.set_num_threads(1)

F32_GATE = 1e-5   # phase 6's normwise gate at mamba2's width
ELEM_TOL = 2e-4   # test_torch_ssd.py's elementwise tolerance
#: (batch, L, H, P, G, N, chunk)
SHAPE = (1, 512, 4, 64, 1, 128, 256)
ROWS = 64         # pass 3's tile rows and key slabs, R = min(chunk, 64)
STATE_SLAB = 32   # pass 1's slab of steps

f32, f64 = np.float32, np.float64


def kernel_fwd(x, dt, a_log, b, c, h0=None, *, chunk, mode="3xtf32",
               shared=True):
    """The forward kernels' arithmetic on float32 numpy operands: (y,
    h_final, s (B, H, L), h_in (B, H, C, P, N)) and the number of C B^T
    pair tiles formed.  ``shared`` forms each C B^T once for the heads of
    a group (as a pass-3 block does for its heads); else once a head."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2:]
    rep, nc, r = h // g, l // chunk, min(chunk, ROWS)
    nq = chunk // r
    xc = _chunked(x, chunk)                               # (B,H,C,Q,P)
    dtc = _chunked(dt[..., None], chunk)[..., 0]          # (B,H,C,Q)
    bg, cg = _chunked(b, chunk), _chunked(c, chunk)       # (B,G,C,Q,N)
    a = -np.exp(a_log)
    # pass 1: s, w, and S_c over slabs of 32 steps
    sc = np.cumsum(a[None, :, None, None] * dtc, axis=-1, dtype=f32)
    w = dtc * np.exp(sc[..., -1:] - sc)
    bh = np.repeat(bg, rep, axis=1)                       # (B,H,C,Q,N)
    rows = min(chunk, STATE_SLAB)
    s_c = np.zeros((bsz, h, nc, p, n), f32)
    for j0 in range(0, chunk, rows):
        xw = xc[..., j0:j0 + rows, :] * w[..., j0:j0 + rows, None]
        s_c = s_c + _chain(np.swapaxes(xw, -1, -2),
                           bh[..., j0:j0 + rows, :], mode)
    # pass 2: the states entering each chunk
    e_q = np.exp(sc[..., -1])
    carry = np.zeros((bsz, h, p, n), f32) if h0 is None else h0
    h_in = np.empty_like(s_c)
    for ci in range(nc):
        h_in[:, :, ci] = carry
        carry = _fma(e_q[:, :, ci, None, None], carry, s_c[:, :, ci])
    # pass 3, tile by tile
    y = np.zeros_like(xc)
    loc = np.arange(r)
    tiles = 0
    for t in range(nq):
        own = slice(t * r, (t + 1) * r)
        s_t = sc[..., own]
        c_own = cg[..., own, :] if shared else \
            np.repeat(cg[..., own, :], rep, axis=1)
        c_h = np.repeat(cg[..., own, :], rep, axis=1)
        yt = np.exp(s_t)[..., None] * _sum(c_h, np.swapaxes(h_in, -1, -2),
                                           mode)
        for k in range(t + 1):
            key = slice(k * r, (k + 1) * r)
            b_key = bg[..., key, :] if shared else \
                np.repeat(bg[..., key, :], rep, axis=1)
            cb = _tile(c_own, np.swapaxes(b_key, -1, -2), mode)
            tiles += int(np.prod(cb.shape[:3]))
            if shared:
                cb = np.repeat(cb, rep, axis=1)
            keep = (k < t) | (loc[None, :] <= loc[:, None])
            decay = np.exp(np.where(keep, s_t[..., :, None] -
                                    sc[..., None, key], f32(0)))
            gm = np.where(keep, cb * decay * dtc[..., None, key], f32(0))
            yt = yt + _chain(gm, xc[..., key, :], mode)
        y[..., own, :] = yt
    return (_unchunked(y), carry, sc.reshape(bsz, h, l), h_in), tiles


def _arrays(seed=0):
    """x, dt, a_log, b, c, h0 (float32) at SHAPE: the reference test's
    operands (dt = |N(0, 1)| 0.1, a_log = N(0, 1) 0.5, x, b, c standard
    normal), h0 standard normal."""
    bsz, l, h, p, g, n, _ = SHAPE
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bsz, l, h, p)).astype(f32),
            (np.abs(rng.standard_normal((bsz, l, h))) * 0.1).astype(f32),
            (0.5 * rng.standard_normal(h)).astype(f32),
            rng.standard_normal((bsz, l, g, n)).astype(f32),
            rng.standard_normal((bsz, l, g, n)).astype(f32),
            rng.standard_normal((bsz, h, p, n)).astype(f32)]


def _reference(arrays, with_h0):
    """The reference's y and h_final (``_ssd_chunked``; y also from the
    Pallas kernel in interpret mode where there is no h0), its s (the
    chunk-wise cumulative sum of a dt) and its h_in (the final state of
    ``_ssd_chunked`` over each prefix of whole chunks)."""
    x, dt, a_log, b, c, h0 = (jnp.asarray(t) for t in arrays)
    h0 = h0 if with_h0 else None
    chunk = SHAPE[-1]
    bsz, l, h, p, _, n, _ = SHAPE
    a = -jnp.exp(a_log)
    y, h_final = _ssd_chunked(x, dt, a, b, c, chunk, h0=h0)
    ys = [np.asarray(y)]
    if not with_h0:
        ys.append(np.asarray(pallas_ssd(x, dt, a_log, b, c, chunk=chunk,
                                        interpret=True)))
    s = jnp.cumsum((a * dt).reshape(bsz, l // chunk, chunk, h), axis=2)
    s = np.asarray(s).transpose(0, 3, 1, 2).reshape(bsz, h, l)
    h_in = [np.zeros((bsz, h, p, n), f32) if h0 is None else np.asarray(h0)]
    for ci in range(1, l // chunk):
        end = ci * chunk
        h_in.append(np.asarray(_ssd_chunked(
            x[:, :end], dt[:, :end], a, b[:, :end], c[:, :end], chunk,
            h0=h0)[1]))
    return ys, np.asarray(h_final), s, np.stack(h_in, axis=2)


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


def _emulate(arrays, with_h0, **kw):
    x, dt, a_log, b, c, h0 = arrays
    return kernel_fwd(x, dt, a_log, b, c, h0 if with_h0 else None,
                      chunk=SHAPE[-1], **kw)


def _gates(got, want):
    """Normwise error and max |got - want| / (tol + tol |want|)."""
    got, want = np.asarray(got, f64), np.asarray(want, f64)
    ratio = np.max(np.abs(got - want) / (ELEM_TOL + ELEM_TOL * np.abs(want)))
    return _normwise(got, want), float(ratio)


@pytest.mark.parametrize("with_h0", [False, True])
def test_three_tf32_products_meet_the_float32_gates(arrays, with_h0):
    (y, h_final, s, h_in), _ = _emulate(arrays, with_h0)
    ys, ref_final, ref_s, ref_h_in = _reference(arrays, with_h0)
    pairs = [("y", y, ref_y) for ref_y in ys] + [
        ("h_final", h_final, ref_final), ("s", s, ref_s),
        ("h_in", h_in, ref_h_in)]
    for name, got, want in pairs:
        err, ratio = _gates(got, want)
        assert err <= F32_GATE and ratio <= 1.0, (name, err, ratio)


def test_emulation_agrees_with_the_plain_version(arrays):
    """The port's ``ssd_plain`` (what a CPU tensor runs) and the emulated
    kernels within the same gates, with ``h0`` and ``return_state``."""
    (y, h_final, _, _), _ = _emulate(arrays, True)
    x, dt, a_log, b, c, h0 = (torch.from_numpy(t) for t in arrays)
    py, pf = ssd_plain(x, dt, a_log, b, c, chunk=SHAPE[-1], h0=h0,
                       return_state=True)
    for got, want in ((y, py.numpy()), (h_final, pf.numpy())):
        err, ratio = _gates(got, want)
        assert err <= F32_GATE and ratio <= 1.0, (err, ratio)


def test_single_tf32_products_miss_the_gate(arrays):
    """The same kernels with one TF32 product a step (operands rounded to
    the nearest TF32): y is off by about 1e-4 to 1e-3 normwise, past the
    gate -- the reason for the splits."""
    (y, _, _, h_in), _ = _emulate(arrays, True, mode="tf32")
    ys, _, _, ref_h_in = _reference(arrays, True)
    errs = {"y": _normwise(y, ys[0]), "h_in": _normwise(h_in, ref_h_in)}
    print(f"single TF32 products: {errs}")
    assert min(errs.values()) > F32_GATE, errs


def test_group_shared_cb_equals_a_per_head_product(arrays):
    """C B^T formed once for the group's heads gives every head the same
    bits as forming it for each head, at a quarter of the pair tiles here
    (four heads in the group)."""
    shared, tiles = _emulate(arrays, True)
    per_head, tiles_h = _emulate(arrays, True, shared=False)
    for got, want in zip(shared, per_head):
        np.testing.assert_array_equal(got, want)
    h, g = SHAPE[2], SHAPE[4]
    assert tiles_h == (h // g) * tiles


def test_head_choices():
    """Pass 1 takes two heads of a group a block, pass 3 up to four: the
    largest divisor of the group's heads, so no block straddles groups."""
    assert ssd_state_heads(80, 1) == 2 and ssd_scan_heads(80, 1) == 4
    assert ssd_state_heads(4, 1) == 2 and ssd_scan_heads(4, 1) == 4
    assert ssd_state_heads(6, 2) == 1 and ssd_scan_heads(6, 2) == 3
    assert ssd_scan_heads(128, 1) == 4 and ssd_scan_heads(8, 4) == 2
    # mamba2-2.7b at chunk 256: 1,280 pass-3 blocks of four heads
    assert ssd_scan_blocks(1, 4096, 80, 256, heads=4) == 1280
    assert ssd_scan_blocks(1, 4096, 80, 256) == 5120


def _smem_before(chunk, p, n):
    """The staging the FFMA kernels reckoned (their ssd_smem_bytes): pass
    3's C and B rows, h_in or an X slab and G^T, s and dt of the chunk;
    pass 1's ring of three 16-row slabs, s and w of the chunk."""
    r = min(chunk, ROWS)
    scan = 2 * r * n + max(r * (p + r), p * n) + 2 * chunk
    state = 3 * 16 * (p + n) + 2 * chunk + 4
    return 4 * max(scan, state)


def _chunks_before(p, n):
    """Every chunk the FFMA kernels took at (p, n): 16, 32 and the
    multiples of 64 whose staging fit the H100."""
    out, chunk = [16, 32], 64
    while _smem_before(chunk, p, n) <= H100_SMEM_OPTIN:
        out.append(chunk)
        chunk += 64
    return out


@pytest.mark.parametrize("p", KERNEL_HEAD_DIMS)
def test_every_config_legal_before_stays_legal(p):
    """The full grid: every (chunk, P, N) the FFMA kernels took is legal
    for the tensor-core kernels on the route that takes it, whose staging
    is reckoned anew."""
    for n in KERNEL_STATES:
        chunks = _chunks_before(p, n)
        assert len(chunks) > 100
        for chunk in chunks:
            assert ssd_tile_legal(chunk, chunk, p, n), (chunk, p, n)
            assert ssd_smem_bytes(chunk, p, n) <= H100_SMEM_OPTIN
    # mamba2-2.7b's widths at its chunk, on the wgmma route: pass 3's
    # staging, one block an SM
    assert ssd_smem_bytes(256, 64, 128) == 218_192
