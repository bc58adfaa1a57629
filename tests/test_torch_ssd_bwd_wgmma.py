"""The SSD backward's wgmma route (``src/repro_torch/kernels/csrc/ssd_bwd.cu``,
route 1) on the CPU: its route table, its shared memory and scratch, the
layout of its split tiles, and an emulation in torch of its arithmetic
against the float64 plain backward (``ssd_bwd_plain``) and ``jax.vjp`` of
the reference model's ``_ssd_chunked``.

The route reads every float32 operand of a product from a K-major tile of
its TF32 hi and lo parts (hi the nearest TF32, ties away; lo = a - hi, of
which the tensor core reads the top 19 bits) and sums hi hi + hi lo +
lo hi.  The emulation adds each k8 step's eight products exactly (float64)
to its accumulator and truncates to float32, as a tensor-core accumulator
keeps its sum, in the kernels' order and chains:

* C B^T once a (batch, group, chunk) for every query tile and key slab on
  or below it, hi hi and the small terms in accumulators of their own;
* per tile and head, the pair tile dY X^T (or X dY^T) the same way, over
  depth P;
* M (or G^T and M^T) as register A fragments -- the accumulator's columns
  2q, 2q + 1 at depth slots q, q + 4 -- times the slab's time-transposed
  tile staged in that depth order: one chain of a slab's 64 steps from
  zero, added by round-to-nearest float32 to the sums (dc and db over the
  block's heads, dx over the head's slabs);
* the state terms: dY_t h_in and X_t dS over depth P, one chain; B_t dS^T
  over depth N in chains of 64; D_c in chains of a 64-step slab.

The shapes are mamba2-2.7b's and jamba-v0.1-52b's (P, N) in small: one
group of 4 heads, two heads a block, chunk 128 over two chunks.  The gate
is phase 15a's: 1e-5 normwise per gradient.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.models.mamba import _ssd_chunked  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels._card import H100_SMEM_OPTIN  # noqa: E402
from repro_torch.kernels.ssd import (BWD_ROUTES,  # noqa: E402
                                     BWD_WGMMA_PN, KERNEL_HEAD_DIMS,
                                     KERNEL_STATES, _plain_parts, ssd,
                                     ssd_bwd, ssd_bwd_dstate_smem_bytes,
                                     ssd_bwd_legal, ssd_bwd_plain,
                                     ssd_bwd_route, ssd_bwd_route_table,
                                     ssd_bwd_smem_bytes,
                                     ssd_bwd_split_floats, ssd_tile_legal)

torch.set_num_threads(1)

F32_GATE = 1e-5
NAMES = ("dx", "ddt", "da_log", "db", "dc", "dh0")
R = 64            # the route's tile rows and slab steps
CHAIN = 64        # the longest chain of depth into an output sum
#: (batch, L, H, P, G, N, chunk): mamba2-2.7b's and jamba-v0.1-52b's (P, N)
SHAPES = {"mamba2": (1, 256, 4, 64, 1, 128, 128),
          "jamba": (1, 256, 4, 64, 1, 16, 128)}
HEADS = 2         # heads of a chunk-pass block



# ------------------------------------------------------------ the table --

def test_the_route_table_routes_every_instantiated_config_once():
    """wgmma exactly at (64, 128) and (64, 16) with a chunk that is a
    multiple of 64; mma_sync at every other instantiated (P, N) and at
    chunks 16 and 32; nothing where no kernel is instantiated or the chunk
    is not 16, 32 or a multiple of 64."""
    for p in KERNEL_HEAD_DIMS + (128,):
        for n in KERNEL_STATES + (256,):
            for chunk in (8, 16, 32, 48, 64, 96, 128, 192, 256, 512):
                route = ssd_bwd_route(p, n, chunk)
                legal = p in KERNEL_HEAD_DIMS and n in KERNEL_STATES and \
                    (chunk in (16, 32) or chunk % 64 == 0)
                if not legal:
                    assert route is None, (p, n, chunk)
                elif (p, n) in BWD_WGMMA_PN and chunk % 64 == 0:
                    assert route == "wgmma", (p, n, chunk)
                else:
                    assert route == "mma_sync", (p, n, chunk)
                if route is not None:
                    assert route in BWD_ROUTES
                    assert ssd_tile_legal(4096, chunk, p, n) == \
                        ssd_bwd_legal(4096, chunk, p, n)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_the_models_backwards_take_the_wgmma_route(arch):
    cfg = get_config(arch)
    assert ssd_bwd_route(cfg.ssm_head_dim, cfg.ssm_state,
                         cfg.ssm_chunk) == "wgmma"
    assert ssd_bwd.route_launches.keys() == set(BWD_ROUTES)


def test_a_config_no_route_takes_raises_and_names_the_table():
    table = ssd_bwd_route_table()
    assert "wgmma" in table and "mma_sync" in table
    assert str(BWD_WGMMA_PN) in table
    with FakeTensorMode():
        x = torch.empty(1, 96, 4, 64, device="cuda")
        dt = torch.empty(1, 96, 4, device="cuda")
        a_log = torch.empty(4, device="cuda")
        b = torch.empty(1, 96, 1, 128, device="cuda")
        s = torch.empty(1, 4, 96, device="cuda")
        h_in = torch.empty(1, 4, 2, 64, 128, device="cuda")
        with pytest.raises(ValueError, match="not legal|route"):
            ssd_bwd(x, dt, a_log, b, b, s, h_in, x, chunk=48)


# ---------------------------------------------------- shared memory --

def test_the_wgmma_route_s_staging_fits_the_card_at_every_config():
    """The chunk pass's staging (Wg::kSmem) at both wgmma (P, N) and every
    chunk it takes, and D_c's, fit the H100's 232,448 bytes a block."""
    assert ssd_bwd_smem_bytes(256, 64, 128) == 220_288
    assert ssd_bwd_smem_bytes(64, 64, 16) == 221_872
    assert ssd_bwd_dstate_smem_bytes() == 68_672
    for p, n in BWD_WGMMA_PN:
        for chunk in (64, 128, 192, 256, 512, 1024):
            assert ssd_bwd_route(p, n, chunk) == "wgmma"
            assert ssd_bwd_smem_bytes(chunk, p, n) <= H100_SMEM_OPTIN
            assert ssd_bwd_smem_bytes(chunk, p, n) % 16 == 0
    assert ssd_bwd_dstate_smem_bytes() <= H100_SMEM_OPTIN
    # the mma_sync route keeps its staging (ChunkShape)
    assert ssd_bwd_smem_bytes(32, 64, 128) == 135_424
    assert ssd_bwd_smem_bytes(256, 32, 128) == 156_160


def test_the_split_scratch_counts_each_tile_of_the_route():
    """x, dy and dy^T as two-part tiles a (batch, head, slab); b, c, b^T
    and c^T a (batch, group, slab), depth N padded to 32; h_in^T, dS^T and
    dS a (batch, head, chunk); dt as (B, H, L); C B^T and its transpose for
    every tile pair on or below the diagonal a (batch, group, chunk)."""
    b, l, h, p, g, n, chunk = 1, 4096, 80, 64, 1, 128, 256
    nq, nc = chunk // R, l // chunk
    want = (3 * b * h * l * p * 2 + 4 * b * g * l * n * 2 +
            3 * b * h * nc * p * n * 2 + b * h * l +
            b * g * nc * nq * (nq + 1) // 2 * 2 * R * R)
    assert ssd_bwd_split_floats(b, l, h, g, p, n, chunk) == want
    assert 4 * want == 778_305_536        # about 778 MB at mamba2-2.7b
    # N = 16 pads the natural tiles' depth to 32
    got = ssd_bwd_split_floats(1, 4096, 128, 1, 64, 16, 256)
    assert got == (3 * 4096 * 128 * 64 * 2 + 2 * 4096 * 32 * 2 +
                   2 * 4096 * 16 * 2 + 128 * 16 * (2 * 64 * 16 * 2 +
                                                   64 * 32 * 2) +
                   128 * 4096 + 16 * 10 * 2 * R * R)
    assert ssd_bwd_split_floats(1, 4096, 80, 1, 64, 128, 32) == 0
    assert ssd_bwd_split_floats(1, 4096, 80, 1, 32, 128, 256) == 0


# ------------------------------------------------------------ layouts --

def kperm(q):
    """The step that depth slot q of a time-depth tile holds
    (``kperm`` in the .cu)."""
    q = np.asarray(q)
    r = q & 7
    return (q & ~7) | np.where(r < 4, 2 * r, 2 * r - 7)


def panel_at(r, k):
    """The float offset of (row r, depth k) in a 128-byte-row panel with
    the 128-byte swizzle (``panel_at``)."""
    r, k = np.asarray(r), np.asarray(k)
    return r * 32 + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)


def cb_at(r, col):
    r, col = np.asarray(r), np.asarray(col)
    return r * 64 + (((col >> 2) ^ (r & 7)) << 2) + (col & 3)


def split_unit(tile, perm):
    """What ssd_bwd_split_kernel writes for one unit of ``tile`` (rows x 32
    depth steps, float32): its hi panel then its lo panel, swizzled, depth
    slot q holding step kperm(q) when ``perm``."""
    rows = tile.shape[0]
    out = np.zeros(rows * 64, np.float32)
    q = np.arange(32)
    src = kperm(q) if perm else q
    for r in range(rows):
        v = tile[r, src]
        hi, lo = _split(torch.from_numpy(v))
        out[panel_at(r, q)] = hi.numpy()
        out[rows * 32 + panel_at(r, q)] = lo.numpy()
    return out


def read_unit(unit, rows, kk):
    """What a K-major wgmma descriptor at k8 step kk of a unit reads: rows
    x 8 of hi and of lo (depth slots 8 kk .. 8 kk + 7)."""
    q = 8 * kk + np.arange(8)
    at = panel_at(np.arange(rows)[:, None], q[None, :])
    return unit[at], unit[rows * 32 + at]


def test_the_split_tiles_read_back_in_the_fragments_depth_order():
    """M (64 x 64, an accumulator) times B (64 steps x N) through the
    route's layout: A fragments from M's accumulator columns in
    a_from_acc's order (slot q of k8 step kk is column 8 kk + kperm(q)),
    B's time-transposed units read by the descriptor at each k8 step:
    the hi hi + hi lo + lo hi sum equals the 3xTF32 product of M and B
    in natural order, exactly (float64 sums)."""
    rng = np.random.default_rng(0)
    m = rng.standard_normal((64, 64)).astype(np.float32)
    bk = rng.standard_normal((64, 128)).astype(np.float32)
    mh, ml = (t.double().numpy() for t in _split(torch.from_numpy(m)))
    got = np.zeros((64, 128))
    for ku in range(2):
        unit = [split_unit(bk[32 * ku:32 * ku + 32, 64 * rh:64 * rh + 64].T,
                           perm=True) for rh in range(2)]
        for kk in range(4):
            cols = 32 * ku + 8 * kk + kperm(np.arange(8))
            for rh in range(2):
                bh, bl = (t.astype(np.float64) for t in read_unit(
                    unit[rh], 64, kk))
                sl = slice(64 * rh, 64 * rh + 64)
                got[:, sl] += mh[:, cols] @ bh.T + mh[:, cols] @ bl.T + \
                    ml[:, cols] @ bh.T
    bh, bl = (t.double().numpy() for t in _split(torch.from_numpy(bk)))
    want = mh @ bh + mh @ bl + ml @ bh
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the slot order covers each step of a group once
    assert sorted(kperm(np.arange(8)).tolist()) == list(range(8))
    assert kperm(np.arange(8)).tolist() == [0, 2, 4, 6, 1, 3, 5, 7]


def test_the_swizzles_are_bijections_and_spread_a_warp_s_reads():
    """panel_at and cb_at place every element once; the eight rows a
    quad's lanes read at one column of a C B^T tile (the pair math) fall in
    eight distinct 16-byte bank groups."""
    r, k = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
    assert len(set(panel_at(r, k).ravel())) == 64 * 32
    r, c = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    assert len(set(cb_at(r, c).ravel())) == 64 * 64
    for col in range(64):
        banks = (cb_at(np.arange(8), col) // 4) % 8
        assert len(set(banks.tolist())) == 8


# --------------------------------------------------------- arithmetic --

def _u32(x):
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _f32(u):
    u = u & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(
        torch.int32).view(torch.float32)


def _tf32_hi(x):
    """The nearest TF32, ties away (split_tf32's hi)."""
    return _f32((_u32(x.float()) + 0x1000) & 0xFFFFE000)


def _tf32_read(x):
    """What the tensor core reads of a float32: its low 13 bits cleared."""
    return _f32(_u32(x.float()) & 0xFFFFE000)


def _split(x):
    """(hi, lo) as the split kernel stores them: lo = x - hi exactly."""
    hi = _tf32_hi(x)
    return hi, x.float() - hi


def _rz32(x):
    """float64 to float32 toward zero, as an accumulator keeps its sum."""
    f = x.float()
    over = f.double().abs() > x.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def _parts(a, b, mode):
    """The (A part, B part) products of one k8 step, in issue order."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    if mode == "tf32":
        return [(ah, bh)]
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    return [(al, bh), (ah, bl), (ah, bh)]


def _steps(a, b):
    """A product's k8 steps: depth slots q of step kk hold depth 8 kk +
    kperm(q) of both operands (the fragments' and the staged tiles'
    order); the eight products of a step add exactly."""
    out = []
    for k0 in range(0, a.shape[-1], 8):
        d = k0 + kperm(np.arange(min(8, a.shape[-1] - k0)))
        out.append((a[..., d], b[..., d, :]))
    return out


def _chain(a, b, mode):
    """a @ b as one truncating accumulator from zero."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for sa, sb in _steps(a, b):
        for pa, pb in _parts(sa, sb, mode):
            acc = _rz32(acc.double() + pa.double() @ pb.double())
    return acc


def _chains(a, b, mode):
    """a @ b into a sum: chains of CHAIN steps from zero, added in float32
    (round to nearest)."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k in range(0, a.shape[-1], CHAIN):
        out = out + _chain(a[..., k:k + CHAIN], b[..., k:k + CHAIN, :], mode)
    return out


def _tile(a, b, mode):
    """A pair tile: hi hi in one truncating accumulator, the small terms in
    another, read as their float32 sum."""
    big = torch.zeros(a.shape[:-1] + b.shape[-1:])
    small = torch.zeros_like(big)
    for sa, sb in _steps(a, b):
        parts = _parts(sa, sb, mode)
        for pa, pb in parts[:-1]:
            small = _rz32(small.double() + pa.double() @ pb.double())
        pa, pb = parts[-1]
        big = _rz32(big.double() + pa.double() @ pb.double())
    return big + small


def _chunked(t, chunk, rep=1):
    bsz, l, k = t.shape[:3]
    t = t.reshape(bsz, l // chunk, chunk, k, *t.shape[3:]).movedim(3, 1)
    return t.repeat_interleave(rep, 1) if rep > 1 else t


def _unchunked(t):
    bsz, k, nc, q = t.shape[:4]
    return t.movedim(1, 3).reshape(bsz, nc * q, k, *t.shape[4:])


def _heads(t, heads):
    """A per-head sum (B, H, ...) over each block of ``heads`` heads, head
    after head in float32: (B, H / heads, ...)."""
    bsz, h = t.shape[:2]
    blocks = t.reshape(bsz, h // heads, heads, *t.shape[2:])
    acc = torch.zeros_like(blocks[:, :, 0])
    for hh in range(heads):
        acc = acc + blocks[:, :, hh]
    return acc


def wgmma_bwd(x, dt, a_log, b, c, s, h_in, dy, dh_final, *, chunk, heads,
              mode="3xtf32"):
    """The wgmma route's arithmetic on float32 tensors: (dx, ddt, da_log,
    db, dc, dh0)."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2:]
    rep, nc, nq = h // g, l // chunk, chunk // R
    xc, yc = _chunked(x, chunk), _chunked(dy, chunk)      # (B,H,C,Q,P)
    bc, cc = _chunked(b, chunk, rep), _chunked(c, chunk, rep)
    dtc = _chunked(dt[..., None], chunk)[..., 0]           # (B,H,C,Q)
    sc = s.reshape(dtc.shape)
    a = -torch.exp(a_log)
    es = torch.exp(sc)
    # (i) D_c: (exp(s) dY)^T C, a chain a 64-step slab
    d_c = torch.zeros(bsz, h, nc, p, n)
    for i0 in range(0, chunk, R):
        ay = es[..., i0:i0 + R, None] * yc[..., i0:i0 + R, :]
        d_c = d_c + _chain(ay.transpose(-1, -2), cc[..., i0:i0 + R, :], mode)
    # (ii) the reverse state pass
    e_q = torch.exp(sc[..., -1])
    gs = torch.zeros(bsz, h, p, n) if dh_final is None else dh_final
    d_s = torch.empty_like(d_c)
    dsq = torch.zeros(bsz, h, nc)
    for ci in reversed(range(nc)):
        d_s[:, :, ci] = gs
        dsq[:, :, ci] = e_q[:, :, ci] * (gs * h_in[:, :, ci]).sum((-1, -2))
        gs = (e_q[:, :, ci, None, None].double() * gs.double() +
              d_c[:, :, ci].double()).float()
    dh0 = gs
    # (iii) the chunk pass: C B^T once a group, then tile by tile
    eqj = torch.exp(sc[..., -1:] - sc)
    w = dtc * eqj
    cb = {}
    for t in range(nq):
        for k in range(t + 1):
            cb[t, k] = _tile(cc[..., t * R:(t + 1) * R, :],
                             bc[..., k * R:(k + 1) * R, :].transpose(-1, -2),
                             mode)
    ds = torch.zeros_like(sc)
    ddt_part = torch.zeros_like(sc)
    dx = torch.zeros_like(xc)
    db_rows = torch.zeros(bsz, h // heads, nc, chunk, n)
    dc_rows = torch.zeros_like(db_rows)
    loc = torch.arange(R)
    for t in range(nq):
        own = slice(t * R, (t + 1) * R)
        ct, bt, yt, xt = cc[..., own, :], bc[..., own, :], yc[..., own, :], \
            xc[..., own, :]
        s_t, dt_t, w_t = sc[..., own], dtc[..., own], w[..., own]
        # as query rows: the state term, then the key slabs k <= t; dc
        # per head first (each head's slabs in turn), then over the heads
        v = es[..., own, None] * _chain(yt, h_in, mode)
        dc_h = v
        row_q = (v * ct).sum(-1)
        for k in range(t + 1):
            key = slice(k * R, (k + 1) * R)
            s2 = _tile(yt, xc[..., key, :].transpose(-1, -2), mode)
            keep = (loc[None, :] <= loc[:, None]) if k == t else \
                torch.ones(R, R, dtype=torch.bool)
            decay = torch.exp(torch.where(keep, s_t[..., :, None] -
                                          sc[..., None, key], 0.0))
            m = torch.where(keep, s2 * decay * dtc[..., None, key], 0.0)
            row_q = row_q + (m * cb[t, k]).sum(-1)
            dc_h = dc_h + _chain(m, bc[..., key, :], mode)
        dc_rows[..., own, :] = _heads(dc_h, heads)
        # as key columns: the state terms, then the query slabs k >= t
        vx = _chain(xt, d_s, mode)
        u = (vx * bt).sum(-1)
        db_h = w_t[..., None] * vx
        dx_h = w_t[..., None] * _chains(bt, d_s.transpose(-1, -2), mode)
        ds_col = -u * w_t
        ddt_col = eqj[..., own] * u
        for k in range(t, nq):
            qry = slice(k * R, (k + 1) * R)
            s2 = _tile(xt, yc[..., qry, :].transpose(-1, -2), mode)
            a1 = cb[k, t].transpose(-1, -2)
            keep = (loc[None, :] >= loc[:, None]) if k == t else \
                torch.ones(R, R, dtype=torch.bool)
            lm = torch.where(keep, torch.exp(torch.where(
                keep, sc[..., None, qry] - s_t[..., :, None], 0.0)), 0.0)
            cbl = a1 * lm
            gt = cbl * dt_t[..., None]
            mt = s2 * lm * dt_t[..., None]
            ddt_col = ddt_col + (s2 * cbl).sum(-1)
            ds_col = ds_col - (mt * a1).sum(-1)
            dx_h = dx_h + _chain(gt, yc[..., qry, :], mode)
            db_h = db_h + _chain(mt, cc[..., qry, :], mode)
        db_rows[..., own, :] = _heads(db_h, heads)
        dx[..., own, :] = dx_h
        ds[..., own] = row_q + ds_col
        ddt_part[..., own] = ddt_col
        dsq = dsq + (u * w_t).sum(-1)
    # (iv) the finish
    ds[..., -1] = ds[..., -1] + dsq
    rr = ds.flip(-1).cumsum(-1).flip(-1)
    ddt = (a[:, None, None].double() * rr.double() +
           ddt_part.double()).float()
    da_log = a * (dtc * rr).sum((0, 2, 3))

    def grouped(rows):
        out = _heads(rows, rep // heads)                   # (B, G, C, Q, N)
        return _unchunked(out)

    return (_unchunked(dx), _unchunked(ddt[..., None])[..., 0], da_log,
            grouped(db_rows), grouped(dc_rows), dh0)


def _normwise(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _arrays(shape, seed=0):
    """x, dt, a_log, b, c, h0, dy, dh_final (float32) at ``shape``."""
    bsz, l, h, p, g, n, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((bsz, l, h, p)),
            rng.uniform(0.01, 0.2, (bsz, l, h)),
            0.5 * rng.standard_normal(h),
            rng.standard_normal((bsz, l, g, n)) / np.sqrt(n),
            rng.standard_normal((bsz, l, g, n)) / np.sqrt(n),
            rng.standard_normal((bsz, h, p, n)),
            rng.standard_normal((bsz, l, h, p)),
            rng.standard_normal((bsz, h, p, n))]
    return [a.astype(np.float32) for a in arrs]


@pytest.fixture(scope="module", params=sorted(SHAPES))
def problem(request):
    shape = SHAPES[request.param]
    arrays = _arrays(shape)
    t = [torch.from_numpy(a) for a in arrays]
    chunk = shape[-1]
    with torch.no_grad():
        _, _, s, h_in = _plain_parts(*t[:5], chunk, t[5])
        want = ssd_bwd_plain(*(u.double() for u in t[:5]), s.double(),
                             h_in.double(), t[6].double(), t[7].double(),
                             chunk=chunk)
    return shape, arrays, t, s, h_in, want


def _emulate(t, s, h_in, chunk, mode="3xtf32"):
    x, dt, a_log, b, c, _, dy, dh = t
    with torch.no_grad():
        return wgmma_bwd(x, dt, a_log, b, c, s, h_in, dy, dh, chunk=chunk,
                         heads=HEADS, mode=mode)


def test_the_route_s_arithmetic_meets_the_float32_gate(problem):
    shape, _, t, s, h_in, want = problem
    got = _emulate(t, s, h_in, shape[-1])
    errs = {k: _normwise(g_, w_) for k, g_, w_ in zip(NAMES, got, want)}
    assert max(errs.values()) <= F32_GATE, errs


def test_one_tf32_product_a_pair_misses_the_gate(problem):
    """The same arithmetic with one TF32 product a step (operands rounded
    to the nearest TF32): past the gate -- the reason for the splits."""
    shape, _, t, s, h_in, want = problem
    got = _emulate(t, s, h_in, shape[-1], mode="tf32")
    errs = {k: _normwise(g_, w_) for k, g_, w_ in zip(NAMES, got, want)}
    assert max(errs.values()) > F32_GATE, errs


def test_the_route_s_arithmetic_matches_the_reference_vjp(problem):
    """Against ``jax.vjp`` of the reference model's ``_ssd_chunked`` in
    float32, at test_torch_ssd_grad.py's 1e-4."""
    shape, arrays, t, s, h_in, _ = problem
    chunk = shape[-1]
    j = [jnp.asarray(a) for a in arrays]

    def ref(x, dt, a_log, b, c, h0):
        return _ssd_chunked(x, dt, -jnp.exp(a_log), b, c, chunk, h0=h0)

    _, vjp = jax.vjp(ref, *j[:6])
    want = vjp((j[6], j[7]))
    got = _emulate(t, s, h_in, chunk)
    for name, g_, w_ in zip(NAMES, got, want):
        assert _normwise(g_, np.asarray(w_, np.float64)) <= 1e-4, name


# ------------------------------------------------------------ on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD backward's wgmma and "
                    "mma.sync kernels run only there (chip_smoke.py phase "
                    "15a holds them against the plain backward on the "
                    "H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,chunk", [(64, 128, 128), (64, 16, 128),
                                       (64, 128, 32), (32, 64, 64)])
def test_both_routes_match_plain_and_repeat_bit_for_bit(card, p, n, chunk):
    shape = (2, 256, 4, p, 2, n, chunk)
    arrays = [torch.from_numpy(a).to(card) for a in _arrays(shape, seed=3)]
    x, dt, a_log, b, c, h0, dy, dh = arrays
    route = ssd_bwd_route(p, n, chunk)
    leaves = [u.clone().requires_grad_() for u in (x, dt, a_log, b, c, h0)]
    before = dict(ssd_bwd.route_launches)
    y, h_final = ssd(*leaves[:5], chunk=chunk, h0=leaves[5],
                     return_state=True)
    loss = (y * dy).sum() + (h_final * dh).sum()
    got = torch.autograd.grad(loss, leaves, retain_graph=True)
    again = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    assert ssd_bwd.route_launches[route] - before[route] == 2
    cpu = [u.double().cpu() for u in arrays]
    leaves64 = [u.clone().requires_grad_() for u in cpu[:6]]
    y64, hf64 = ssd(*leaves64[:5], chunk=chunk, h0=leaves64[5],
                    return_state=True)
    want = torch.autograd.grad((y64 * cpu[6]).sum() + (hf64 * cpu[7]).sum(),
                               leaves64)
    for name, gg, a2, w_ in zip(NAMES, got, again, want):
        assert torch.equal(gg, a2), name
        assert _normwise(gg.cpu(), w_) <= F32_GATE, name
