"""The arithmetic of the SSD backward on the tensor cores
(``src/repro_torch/kernels/csrc/ssd_bwd.cu``), emulated on the CPU against
the float64 plain backward (``ssd_bwd_plain``).

The kernels run every product with ``mma.sync`` as three TF32 products
(hi hi + hi lo + lo hi): each float32 operand is split into hi, rounded to
the nearest TF32 (a float32 with its low 13 mantissa bits cleared, ties
away), and lo = a - hi as the tensor core reads it (low 13 bits cleared).
Products of the parts are exact, and a tensor-core accumulator truncates
rather than rounds, so the emulation adds each m16n8k8 step's eight
products exactly (in float64) to its accumulator and truncates to float32,
in the kernels' order: the lo hi, hi lo, hi hi terms of a step one after
another into one accumulator (every sum into an output, a chain of at most
64 steps of depth from zero, added by round-to-nearest float32), or, for
the pair tiles C B^T and dY X^T, the hi hi terms in one accumulator and the
small terms in another.  Everything else is float32 as the kernels compute
it: the decays, M, G and E, the row and column sums, the state pass and the
finish.

The emulation follows the kernels' structure: pass (i)'s D_c in slabs of
32 steps; pass (iii) per 64-row tile, as query rows over the key slabs on
and below it and as key columns over the query slabs on and above it, in
column chunks of 16, two column warps a row group whose sums are added at
the end; a block over ``heads`` heads of one group, summing db and dc over
them before the finish pass adds the blocks' partials.

The shape is mamba2-2.7b's in small: P 64, N 128, one group of 4 heads,
chunk 256 over 2 chunks, inputs from a seed.  The bound is phase 15a's
gate for the kernels: 1e-5 normwise per gradient.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.mamba import _ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd import (_plain_parts, ssd_bwd_heads,  # noqa: E402
                                     ssd_bwd_plain)

torch.set_num_threads(1)

F32_GATE = 1e-5
NAMES = ("dx", "ddt", "da_log", "db", "dc", "dh0")
#: (batch, L, H, P, G, N, chunk)
SHAPE = (1, 512, 4, 64, 1, 128, 256)
ROWS = 64         # the chunk pass's tile rows R = min(chunk, 64)
STATE_SLAB = 32   # pass (i)'s slab of steps
COLS = 16         # a column chunk of a pair tile
CHAIN = 64        # the longest chain of depth into an output sum

f32, f64 = np.float32, np.float64


def _tf32_hi(x):
    """The nearest TF32 (ties away from zero), as the kernel rounds hi."""
    u = np.asarray(x, f32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(f32)


def _tf32_read(x):
    """What the tensor core reads of a float32: its low 13 bits cleared."""
    return (np.asarray(x, f32).view(np.uint32) &
            np.uint32(0xFFFFE000)).view(f32)


def _rz32(x):
    """float64 to float32 rounded toward zero, as a tensor-core
    accumulator keeps its sum."""
    f = x.astype(f32)
    over = np.abs(f.astype(f64)) > np.abs(x)
    f[over] = np.nextafter(f[over], f32(0))
    return f


def _parts(a, b, mode):
    """The (A part, B part) products of one mma step, in issue order."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    if mode == "tf32":
        return [(ah, bh)]
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    return [(al, bh), (ah, bl), (ah, bh)]


def _steps(a, b):
    """The m16n8k8 steps of a @ b over the depth: (a slice, b slice)."""
    return [(a[..., k:k + 8], b[..., k:k + 8, :])
            for k in range(0, a.shape[-1], 8)]


def _chain(a, b, mode):
    """a @ b as one truncating accumulator from zero: every step's parts
    in turn."""
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], f32)
    for sa, sb in _steps(a, b):
        for pa, pb in _parts(sa, sb, mode):
            acc = _rz32(acc.astype(f64) + pa.astype(f64) @ pb.astype(f64))
    return acc


def _sum(a, b, mode):
    """a @ b into an output sum: chains of at most CHAIN steps of depth,
    each from zero, added in float32 (round to nearest)."""
    out = np.zeros(a.shape[:-1] + b.shape[-1:], f32)
    for k in range(0, a.shape[-1], CHAIN):
        out = out + _chain(a[..., k:k + CHAIN], b[..., k:k + CHAIN, :], mode)
    return out


def _tile(a, b, mode):
    """A pair tile a @ b: the hi hi products in one truncating accumulator,
    the small terms in another, read as their float32 sum."""
    big = np.zeros(a.shape[:-1] + b.shape[-1:], f32)
    small = np.zeros_like(big)
    for sa, sb in _steps(a, b):
        parts = _parts(sa, sb, mode)
        for pa, pb in parts[:-1]:
            small = _rz32(small.astype(f64) + pa.astype(f64) @ pb.astype(f64))
        pa, pb = parts[-1]
        big = _rz32(big.astype(f64) + pa.astype(f64) @ pb.astype(f64))
    return big + small


def _chunked(t, chunk):
    """(B, L, K, ...) as (B, K, L / chunk, chunk, ...)."""
    bsz, l, k = t.shape[:3]
    return np.moveaxis(t.reshape(bsz, l // chunk, chunk, k, *t.shape[3:]),
                       3, 1)


def _unchunked(t):
    """(B, K, C, Q, ...) back to (B, C Q, K, ...)."""
    bsz, k, nc, q = t.shape[:4]
    return np.moveaxis(t, 1, 3).reshape(bsz, nc * q, k, *t.shape[4:])


def _fma(a, b, c):
    """a b + c rounded once, as fmaf."""
    return (a.astype(f64) * b.astype(f64) + c.astype(f64)).astype(f32)


def _blocks(items, heads):
    """The sums a block keeps over its heads: each item (B, H, ...) added
    in turn, head by head, into one float32 accumulator per block of
    ``heads`` heads; (B, H / heads, ...)."""
    bsz, h = items[0].shape[:2]
    acc = np.zeros((bsz, h // heads) + items[0].shape[2:], f32)
    for hh in range(heads):
        for it in items:
            acc = acc + it.reshape(bsz, h // heads, heads,
                                   *it.shape[2:])[:, :, hh]
    return acc


def kernel_bwd(x, dt, a_log, b, c, s, h_in, dy, dh_final, *, chunk, heads,
               mode="3xtf32"):
    """The backward kernels' arithmetic on float32 numpy operands: (dx,
    ddt, da_log, db, dc, dh0) and, for the head-sum test, the block
    partials of db and dc."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2:]
    rep, nc, r = h // g, l // chunk, min(chunk, ROWS)
    nq, npart = chunk // r, rep // heads
    xc, yc = _chunked(x, chunk), _chunked(dy, chunk)      # (B,H,C,Q,P)
    bc = np.repeat(_chunked(b, chunk), rep, axis=1)       # (B,H,C,Q,N)
    cc = np.repeat(_chunked(c, chunk), rep, axis=1)
    dtc = _chunked(dt[..., None], chunk)[..., 0]          # (B,H,C,Q)
    sc = s.reshape(dtc.shape)
    a = -np.exp(a_log)
    es = np.exp(sc)
    # (i) D_c in slabs of 32 steps
    rows = min(chunk, STATE_SLAB)
    d_c = np.zeros((bsz, h, nc, p, n), f32)
    for i0 in range(0, chunk, rows):
        ay = es[..., i0:i0 + rows, None] * yc[..., i0:i0 + rows, :]
        d_c = d_c + _chain(np.swapaxes(ay, -1, -2),
                           cc[..., i0:i0 + rows, :], mode)
    # (ii) the reverse state pass
    e_q = np.exp(sc[..., -1])
    gs = np.zeros((bsz, h, p, n), f32) if dh_final is None else dh_final
    d_s = np.empty_like(d_c)
    dsq = np.zeros((bsz, h, nc), f32)
    for ci in reversed(range(nc)):
        d_s[:, :, ci] = gs
        dsq[:, :, ci] = e_q[:, :, ci] * (gs * h_in[:, :, ci]).sum(
            (-1, -2), dtype=f32)
        gs = _fma(e_q[:, :, ci, None, None], gs, d_c[:, :, ci])
    dh0 = gs
    # (iii) the chunk pass, tile by tile
    w = dtc * np.exp(sc[..., -1:] - sc)
    eqj = np.exp(sc[..., -1:] - sc)
    ds = np.zeros_like(sc)
    ddt_part = np.zeros_like(sc)
    dx = np.zeros_like(xc)
    db_part = np.zeros((bsz, h // heads, nc, chunk, n), f32)
    dc_part = np.zeros_like(db_part)
    ncol = np.arange(n)
    warp_n = [ncol < 8 * ((n // 8 + 1) // 2), ncol >= 8 * ((n // 8 + 1) // 2)]
    pcol = np.arange(p)
    warp_p = [pcol < 8 * ((p // 8 + 1) // 2), pcol >= 8 * ((p // 8 + 1) // 2)]
    loc = np.arange(r)
    for t in range(nq):
        own = slice(t * r, (t + 1) * r)
        ct, bt, yt, xt = cc[..., own, :], bc[..., own, :], yc[..., own, :], \
            xc[..., own, :]
        s_t, dt_t, w_t = sc[..., own], dtc[..., own], w[..., own]
        # as query rows: the state term, then the key slabs k <= t
        v = es[..., own, None] * _chain(yt, h_in, mode)
        items = [[np.where(m, v, f32(0))] for m in warp_n]
        row_q = [(np.where(m, v * ct, f32(0))).sum(-1, dtype=f32)
                 for m in warp_n]
        for k in range(t + 1):
            for j0 in range(0, r, COLS):
                cw = j0 // (r // 2)
                key = slice(k * r + j0, k * r + j0 + COLS)
                s1 = _tile(ct, np.swapaxes(bc[..., key, :], -1, -2), mode)
                s2 = _tile(yt, np.swapaxes(xc[..., key, :], -1, -2), mode)
                keep = (k < t) | ((j0 + loc[:COLS])[None, :] <= loc[:, None])
                decay = np.exp(np.where(keep, s_t[..., :, None] -
                                        sc[..., None, key], f32(0)))
                m = np.where(keep, s2 * decay * dtc[..., None, key], f32(0))
                row_q[cw] = row_q[cw] + (m * s1).sum(-1, dtype=f32)
                items[cw].append(_chain(m, bc[..., key, :], mode))
        dc_blk = [_blocks(it, heads) for it in items]
        dc_part[..., own, :] = dc_blk[0] + dc_blk[1]
        # as key columns: the state terms, then the query slabs k >= t
        vx = _chain(xt, d_s, mode)
        u = [(np.where(m, vx * bt, f32(0))).sum(-1, dtype=f32)
             for m in warp_n]
        items = [[np.where(m, w_t[..., None] * vx, f32(0))] for m in warp_n]
        px = w_t[..., None] * _sum(bt, np.swapaxes(d_s, -1, -2), mode)
        dx_w = [np.where(m, px, f32(0)) for m in warp_p]
        ds_col = [-uu * w_t for uu in u]
        ddt_col = [eqj[..., own] * uu for uu in u]
        for k in range(t, nq):
            for i0 in range(0, r, COLS):
                cw = i0 // (r // 2)
                qry = slice(k * r + i0, k * r + i0 + COLS)
                s1 = _tile(bt, np.swapaxes(cc[..., qry, :], -1, -2), mode)
                s2 = _tile(xt, np.swapaxes(yc[..., qry, :], -1, -2), mode)
                keep = (k > t) | ((i0 + loc[:COLS])[None, :] >= loc[:, None])
                decay = np.exp(np.where(keep, sc[..., None, qry] -
                                        s_t[..., :, None], f32(0)))
                lm = np.where(keep, decay, f32(0))
                cbl = s1 * lm
                gt = cbl * dt_t[..., None]
                mt = s2 * lm * dt_t[..., None]
                ddt_col[cw] = ddt_col[cw] + (s2 * cbl).sum(-1, dtype=f32)
                ds_col[cw] = ds_col[cw] - (mt * s1).sum(-1, dtype=f32)
                dx_w[cw] = dx_w[cw] + _chain(gt, yc[..., qry, :], mode)
                items[cw].append(_chain(mt, cc[..., qry, :], mode))
        db_blk = [_blocks(it, heads) for it in items]
        db_part[..., own, :] = db_blk[0] + db_blk[1]
        dx[..., own, :] = dx_w[0] + dx_w[1]
        ds[..., own] = (row_q[0] + row_q[1]) + (ds_col[0] + ds_col[1])
        ddt_part[..., own] = ddt_col[0] + ddt_col[1]
        uw = (u[0] * w_t + u[1] * w_t).sum(-1, dtype=f32)
        dsq = dsq + uw
    # (iv) the finish
    ds[..., -1] = ds[..., -1] + dsq
    rr = np.flip(np.cumsum(np.flip(ds, -1), -1, dtype=f32), -1)
    ddt = _fma(a[:, None, None], rr, ddt_part)
    da_log = a * (dtc * rr).sum((0, 2, 3), dtype=f32)

    def grouped(part):
        out = np.zeros((bsz, g, nc, chunk, n), f32)
        for k in range(npart):
            out = out + part.reshape(bsz, g, npart, nc, chunk, n)[:, :, k]
        return _unchunked(out)

    return (_unchunked(dx), _unchunked(ddt[..., None])[..., 0], da_log,
            grouped(db_part), grouped(dc_part), dh0), (db_part, dc_part)


def _normwise(got, want) -> float:
    got = np.asarray(got, f64)
    want = np.asarray(want, f64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _arrays(seed=0):
    """x, dt, a_log, b, c, h0, dy, dh_final (float32) at SHAPE."""
    bsz, l, h, p, g, n, _ = SHAPE
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bsz, l, h, p)).astype(f32),
            rng.uniform(0.01, 0.2, (bsz, l, h)).astype(f32),
            (0.5 * rng.standard_normal(h)).astype(f32),
            (rng.standard_normal((bsz, l, g, n)) / np.sqrt(n)).astype(f32),
            (rng.standard_normal((bsz, l, g, n)) / np.sqrt(n)).astype(f32),
            rng.standard_normal((bsz, h, p, n)).astype(f32),
            rng.standard_normal((bsz, l, h, p)).astype(f32),
            rng.standard_normal((bsz, h, p, n)).astype(f32)]


def _forward(arrays):
    """The forward's float32 scratches s (B, H, L) and h_in (B, H, C, P,
    N), as the kernel forward leaves them for the backward."""
    chunk = SHAPE[-1]
    with torch.no_grad():
        _, _, s, h_in = _plain_parts(*(torch.from_numpy(a)
                                       for a in arrays[:5]), chunk,
                                     torch.from_numpy(arrays[5]))
    return s.numpy(), h_in.numpy()


def _plain64(arrays, s, h_in):
    """ssd_bwd_plain in float64 on the same float32 scratches."""
    t = [torch.from_numpy(a).double() for a in arrays]
    with torch.no_grad():
        got = ssd_bwd_plain(*t[:5], torch.from_numpy(s).double(),
                            torch.from_numpy(h_in).double(), t[6], t[7],
                            chunk=SHAPE[-1])
    return [g.numpy() for g in got]


@pytest.fixture(scope="module")
def problem():
    arrays = _arrays()
    s, h_in = _forward(arrays)
    return arrays, s, h_in, _plain64(arrays, s, h_in)


def _emulate(arrays, s, h_in, mode="3xtf32", heads=2):
    x, dt, a_log, b, c, _, dy, dh = arrays
    return kernel_bwd(x, dt, a_log, b, c, s, h_in, dy, dh, chunk=SHAPE[-1],
                      heads=heads, mode=mode)


def test_three_tf32_products_meet_the_float32_gate(problem):
    arrays, s, h_in, want = problem
    got, _ = _emulate(arrays, s, h_in)
    errs = {k: _normwise(g_, w_) for k, g_, w_ in zip(NAMES, got, want)}
    assert max(errs.values()) <= F32_GATE, errs


def test_single_tf32_products_miss_the_gate(problem):
    """The same kernels with one TF32 product a step (operands rounded to
    the nearest TF32): about 1e-4 to 1e-3 normwise, past the gate -- the
    reason for the splits."""
    arrays, s, h_in, want = problem
    got, _ = _emulate(arrays, s, h_in, mode="tf32")
    errs = {k: _normwise(g_, w_) for k, g_, w_ in zip(NAMES, got, want)}
    print(f"single TF32 products: {errs}")
    assert max(errs.values()) > F32_GATE, errs


def test_emulation_matches_the_reference_vjp(problem):
    """The emulated kernels against ``jax.vjp`` of the reference model's
    ``_ssd_chunked`` in float32 at test_torch_ssd_grad.py's 1e-4."""
    arrays, s, h_in, _ = problem
    j = [jnp.asarray(a) for a in arrays]
    chunk = SHAPE[-1]

    def ref(x, dt, a_log, b, c, h0):
        return _ssd_chunked(x, dt, -jnp.exp(a_log), b, c, chunk, h0=h0)

    _, vjp = jax.vjp(ref, *j[:6])
    want = vjp((j[6], j[7]))
    got, _ = _emulate(arrays, s, h_in)
    for name, g_, w_ in zip(NAMES, got, want):
        assert _normwise(g_, np.asarray(w_, f64)) <= 1e-4, name


def test_head_summed_db_dc_equal_a_per_head_sum(problem):
    """db and dc summed over a block's heads in registers, then over the
    blocks' partials, against one block per head (the per-head scratch
    summed in head order): the same within float32 rounding; the other
    gradients do not depend on the blocking and are the same bits."""
    arrays, s, h_in, _ = problem
    bsz, l, h, p, g, n, chunk = SHAPE
    assert ssd_bwd_heads(h, g) == 4 and ssd_bwd_heads(80, 1) == 10
    blocked, (db_part, _) = _emulate(arrays, s, h_in, heads=2)
    per_head, (db_h, _) = _emulate(arrays, s, h_in, heads=1)
    assert db_part.shape[1] == 2 and db_h.shape[1] == 4
    for name in ("dx", "ddt", "da_log", "dh0"):
        i = NAMES.index(name)
        np.testing.assert_array_equal(blocked[i], per_head[i], err_msg=name)
    for name in ("db", "dc"):
        i = NAMES.index(name)
        got, want = blocked[i], per_head[i]
        assert _normwise(got, want) <= 4 * np.finfo(f32).eps, name
        assert np.max(np.abs(got - want)) <= 8 * np.finfo(f32).eps * \
            np.max(np.abs(want)), name


def _rz_chain(terms):
    """One truncating accumulator over the rows of ``terms``, 8 at a time."""
    acc = np.zeros(terms.shape[1], f32)
    for r0 in range(0, terms.shape[0], 8):
        acc = _rz32(acc.astype(f64) + terms[r0:r0 + 8].sum(0))
    return acc


def test_truncating_accumulators_need_short_chains():
    """dc's sum over mamba2-2.7b's group of 80 heads x 256 key rows, were
    it one mma of 8 products after another into one truncating
    accumulator, drifts past the float32 gate; chains of 64 rows started
    from zero and added in float32 with round-to-nearest, as the kernels
    add them, stay within a tenth of it."""
    rng = np.random.default_rng(2)
    rows = 80 * 256
    terms = rng.random((rows, 128)) * 0.05 * rng.standard_normal(
        (rows, 128)) + 0.02
    want = terms.sum(0)
    chained = np.zeros(128, f32)
    for c0 in range(0, rows, CHAIN):
        chained = chained + _rz_chain(terms[c0:c0 + CHAIN])
    assert _normwise(_rz_chain(terms), want) > F32_GATE
    assert _normwise(chained, want) <= F32_GATE / 10
