"""The SSD forward's wgmma route (``src/repro_torch/kernels/csrc/ssd.cu``,
route 1) on the CPU: its route table, its shared memory and C B^T scratch,
the layouts of its split tiles, and an emulation in numpy of its
arithmetic against the Pallas kernel (``repro.kernels.ssd`` in interpret
mode) and the reference model's ``_ssd_chunked``.

The route reads every float32 operand of a product as its TF32 hi and lo
parts (hi the nearest TF32, ties away; lo = a - hi, of which the tensor
core reads the top 19 bits) and sums hi hi + hi lo + lo hi.  The
emulation adds each k8 step's eight products exactly (float64) to its
accumulator and truncates to float32, as a tensor-core accumulator keeps
its sum, in the kernels' order and chains: every chain starts from zero,
issues the small terms (lo hi, hi lo) of all its k8 steps first and the hi
hi terms last, and is added to a float32 sum by round-to-nearest.

* Pass 1, per head: ``s`` the cumulative sum of ``a dt``, ``w = dt
  exp(s_Q - s)`` and ``S_c = (X o w)^T B``, a chain a 32-step unit.
* Pass 2: ``h_in[c] = h``, ``h = fma(exp(s_Q), h, S_c)``.
* The C B^T pre-pass, once a (batch, group, chunk) for every query tile
  and key slab on or below it: chains of 64 of depth N.
* Pass 3, per 64-row query tile and head: ``y = exp(s_i) (C h_in^T)``,
  chains of 64 of depth N; then for each key slab on and below the
  diagonal G, off the diagonal as ``(C B^T exp(s_i - m)) (exp(m - s_j)
  dt_j)`` with m the slab's last s, on it as ``(C B^T exp(s_i - s_j)) dt_j``
  where j <= i, and ``G X`` one chain over the slab's 64 keys.

The shapes are mamba2-2.7b's and jamba-v0.1-52b's (P, N) in small; the
gates are phase 6's: 1e-5 normwise and 2e-4 elementwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.kernels import ssd as pallas_ssd  # noqa: E402
from repro.models.mamba import _ssd_chunked  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.sampler import Stats  # noqa: E402
from repro_torch.core.model import ModelSet  # noqa: E402
from repro_torch.kernels._card import H100_SMEM_OPTIN  # noqa: E402
from repro_torch.kernels.ssd import (KERNEL_HEAD_DIMS,  # noqa: E402
                                     KERNEL_STATES, ROUTES, WGMMA_PN, ssd,
                                     ssd_bwd_route, ssd_cb_floats, ssd_plain,
                                     ssd_route, ssd_route_table,
                                     ssd_smem_bytes, ssd_tile_legal)
from repro_torch.tc import DEVICE_KERNELS, PredictorSession  # noqa: E402
from test_torch_ssd_bwd_tc import (_chunked, _fma, _normwise,  # noqa: E402
                                   _rz32, _tf32_hi, _tf32_read, _unchunked)

torch.set_num_threads(1)

F32_GATE = 1e-5   # phase 6's normwise gate
ELEM_TOL = 2e-4   # phase 6's elementwise tolerance (SSD_CASES)
R = 64            # the route's query tiles and key slabs
UNIT = 32         # pass 1's steps a chain
CHAIN = 64        # the longest chain of depth N

f32, f64 = np.float32, np.float64

#: (batch, L, H, P, G, N, chunk): mamba2-2.7b's and jamba-v0.1-52b's (P, N)
#: in small, two chunks of 256 steps, four heads over one or two groups;
#: and a narrow, long case (two heads, eight chunks)
SHAPES = {"mamba2": (1, 512, 4, 64, 1, 128, 256),
          "jamba": (1, 512, 4, 64, 2, 16, 256),
          "long": (1, 2048, 2, 64, 1, 128, 256)}


# ------------------------------------------------------------ the table --

def test_the_route_table_routes_every_instantiated_config_once():
    """wgmma exactly at (64, 128) and (64, 16) with a chunk that is a
    multiple of 64; mma_sync at every other instantiated (P, N) and at
    chunks 16 and 32; nothing where no kernel is instantiated or the chunk
    is not 16, 32 or a multiple of 64.  The backward's table is the
    forward's."""
    assert ROUTES == ("wgmma", "mma_sync")
    for p in KERNEL_HEAD_DIMS + (128,):
        for n in KERNEL_STATES + (256,):
            for chunk in (8, 16, 32, 48, 64, 96, 128, 192, 256, 512, 4096):
                route = ssd_route(p, n, chunk)
                legal = p in KERNEL_HEAD_DIMS and n in KERNEL_STATES and \
                    (chunk in (16, 32) or chunk % 64 == 0)
                if not legal:
                    assert route is None, (p, n, chunk)
                elif (p, n) in WGMMA_PN and chunk % 64 == 0:
                    assert route == "wgmma", (p, n, chunk)
                else:
                    assert route == "mma_sync", (p, n, chunk)
                assert ssd_bwd_route(p, n, chunk) == route
                assert ssd_tile_legal(4 * chunk, chunk, p, n) == \
                    (route is not None), (p, n, chunk)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_the_models_forwards_take_the_wgmma_route(arch):
    cfg = get_config(arch)
    assert ssd_route(cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.ssm_chunk) == "wgmma"
    assert ssd.route_launches.keys() == set(ROUTES)


def test_a_config_no_route_takes_raises_and_names_the_table():
    table = ssd_route_table()
    assert "wgmma" in table and "mma_sync" in table
    assert str(WGMMA_PN) in table
    with FakeTensorMode():
        x = torch.empty(1, 96, 4, 64, device="cuda")
        dt = torch.empty(1, 96, 4, device="cuda")
        a_log = torch.empty(4, device="cuda")
        b = torch.empty(1, 96, 1, 128, device="cuda")
        with pytest.raises(ValueError, match="route must take it") as err:
            ssd(x, dt, a_log, b, b, chunk=48)
        assert table in str(err.value)


# ---------------------------------------------------- shared memory --

def test_the_staging_fits_the_card_at_every_routed_config():
    """Each route's staging fits the H100's 232,448 bytes of opt-in shared
    memory wherever it routes a config; the wgmma route's does not depend
    on the chunk (its tiles are 64 rows, its scans 256 steps at a time),
    one block an SM."""
    assert H100_SMEM_OPTIN == 232_448
    for p in KERNEL_HEAD_DIMS:
        for n in KERNEL_STATES:
            for chunk in (16, 32, 64, 128, 256, 512, 1024):
                if ssd_route(p, n, chunk) is not None:
                    assert ssd_smem_bytes(chunk, p, n) <= H100_SMEM_OPTIN
    for (p, n), want in {(64, 128): 218_192, (64, 16): 218_240}.items():
        got = {ssd_smem_bytes(c, p, n) for c in (64, 256, 4096, 2 ** 15)}
        assert got == {want}
        assert want > H100_SMEM_OPTIN // 2       # one block an SM


def test_the_cb_scratch_holds_a_tile_a_pair_on_and_below_the_diagonal():
    # mamba2-2.7b at 4096 steps, chunk 256: 16 chunks x 10 pairs of 64 x 64
    assert ssd_cb_floats(1, 4096, 1, 64, 128, 256) == 16 * 10 * 64 * 64
    assert ssd_cb_floats(2, 512, 3, 64, 16, 64) == 2 * 3 * 8 * 64 * 64
    assert ssd_cb_floats(1, 4096, 1, 64, 128, 32) == 0     # mma_sync
    assert ssd_cb_floats(1, 4096, 1, 32, 128, 256) == 0


# ------------------------------------------------------------ layouts --

def kperm(q):
    """The step that depth slot q of a time-depth tile holds (``kperm``
    in the .cu): 2q of each 8-step group at slot q, 2q + 1 at q + 4."""
    q = np.asarray(q)
    r = q & 7
    return (q & ~7) | np.where(r < 4, 2 * r, 2 * r - 7)


def panel_at(r, k):
    """The float offset of (row r, depth k) in a panel of 128-byte rows
    with the 128-byte swizzle (``panel_at``)."""
    r, k = np.asarray(r), np.asarray(k)
    return r * 32 + (((k >> 2) ^ (r & 7)) << 2) + (k & 3)


def _split(x):
    hi = _tf32_hi(x)
    return hi, np.asarray(x, f32) - hi


def split_unit(tile, perm):
    """What the kernels' splits write for one unit of ``tile`` (rows x 32
    depth steps): the hi panel then the lo panel, swizzled, depth slot q
    holding step kperm(q) when ``perm`` (split_xt) and q otherwise
    (split_rows, split_bt)."""
    rows = tile.shape[0]
    out = np.zeros(rows * 64, f32)
    q = np.arange(32)
    src = kperm(q) if perm else q
    for r in range(rows):
        hi, lo = _split(tile[r, src])
        out[panel_at(r, q)] = hi
        out[rows * 32 + panel_at(r, q)] = lo
    return out


def read_unit(unit, rows, kk):
    """What a K-major wgmma descriptor at k8 step kk of a unit reads: rows
    x 8 of hi and of lo."""
    at = panel_at(np.arange(rows)[:, None], 8 * kk + np.arange(8)[None, :])
    return unit[at].astype(f64), unit[rows * 32 + at].astype(f64)


def test_the_split_tiles_read_back_in_the_fragments_depth_order():
    """G (an accumulator, 64 rows x 64 keys) times X (64 keys x P): A
    fragments from G's columns in a_from_acc's order (slot q of k8 step kk
    is column 8 kk + kperm(q)), X^T split into two units by split_xt and
    read by the descriptor at each k8 step: the three TF32 products equal
    the 3xTF32 product of G and X in natural order, exactly.  Pass 1's
    (X o w)^T B reads B^T's units (split_bt, natural order) against A
    fragments in natural order the same way."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((64, 64)).astype(f32)
    x = rng.standard_normal((64, 64)).astype(f32)
    gh, gl = (t.astype(f64) for t in _split(g))
    units = [split_unit(x[32 * u:32 * u + 32].T, perm=True) for u in (0, 1)]
    got = np.zeros((64, 64))
    for u in (0, 1):
        for kk in range(4):
            cols = 32 * u + 8 * kk + kperm(np.arange(8))
            bh, bl = read_unit(units[u], 64, kk)
            got += gh[:, cols] @ bh.T + gh[:, cols] @ bl.T + \
                gl[:, cols] @ bh.T
    xh, xl = (t.astype(f64) for t in _split(x))
    np.testing.assert_allclose(got, gh @ xh + gh @ xl + gl @ xh, rtol=0,
                               atol=1e-12)
    # pass 1: B (32 steps x N = 128) as two units of B^T's 64 rows
    b = rng.standard_normal((32, 128)).astype(f32)
    a = rng.standard_normal((64, 32)).astype(f32)        # (X o w)^T
    ah, al = (t.astype(f64) for t in _split(a))
    got = np.zeros((64, 128))
    for nb in (0, 1):
        unit = split_unit(b[:, 64 * nb:64 * nb + 64].T, perm=False)
        for kk in range(4):
            bh, bl = read_unit(unit, 64, kk)
            cols = 8 * kk + np.arange(8)
            got[:, 64 * nb:64 * nb + 64] += ah[:, cols] @ bh.T + \
                ah[:, cols] @ bl.T + al[:, cols] @ bh.T
    bh, bl = (t.astype(f64) for t in _split(b))
    np.testing.assert_allclose(got, ah @ bh + ah @ bl + al @ bh, rtol=0,
                               atol=1e-12)
    assert kperm(np.arange(8)).tolist() == [0, 2, 4, 6, 1, 3, 5, 7]


def test_the_cb_tile_is_written_as_the_accumulator_holds_it():
    """The pre-pass writes thread (warp w, lane l)'s n-tile i of its m64n64
    accumulator as the float4 at (8 w + i) 32 + l; pass 3 reads it back at
    the same place, every element once: rows 16 w + l / 4 (+ 8), columns
    8 i + 2 (l % 4) (+ 1)."""
    seen = {}
    for w in range(4):
        for lane in range(32):
            for i in range(8):
                for e in range(4):
                    row = 16 * w + lane // 4 + 8 * (e >> 1)
                    col = 8 * i + 2 * (lane % 4) + (e & 1)
                    seen[4 * ((8 * w + i) * 32 + lane) + e] = (row, col)
    assert sorted(seen) == list(range(64 * 64))
    assert len(set(seen.values())) == 64 * 64


# --------------------------------------------------------- arithmetic --

def _chain(a, b, mode):
    """a @ b as one truncating accumulator from zero over k8 steps: the
    small terms (lo hi, hi lo) of every step first, then the hi hi terms;
    each step's eight products add exactly."""
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], f32)
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    steps = range(0, a.shape[-1], 8)

    def add(acc, x, y, k):
        return _rz32(acc.astype(f64) + x[..., k:k + 8].astype(f64) @
                     y[..., k:k + 8, :].astype(f64))
    if mode == "tf32":
        for k in steps:
            acc = add(acc, ah, bh, k)
        return acc
    for k in steps:
        acc = add(acc, al, bh, k)
        acc = add(acc, ah, bl, k)
    for k in steps:
        acc = add(acc, ah, bh, k)
    return acc


def _sum(a, b, mode, depth):
    """a @ b into a float32 sum, a chain from zero each ``depth`` of it."""
    out = np.zeros(a.shape[:-1] + b.shape[-1:], f32)
    for k in range(0, a.shape[-1], depth):
        out = out + _chain(a[..., k:k + depth], b[..., k:k + depth, :], mode)
    return out


def wgmma_fwd(x, dt, a_log, b, c, h0=None, *, chunk, mode="3xtf32"):
    """The wgmma route's arithmetic on float32 numpy operands: (y,
    h_final)."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2:]
    rep, nc, nq = h // g, l // chunk, chunk // R
    xc = _chunked(x, chunk)                               # (B,H,C,Q,P)
    dtc = _chunked(dt[..., None], chunk)[..., 0]          # (B,H,C,Q)
    bg, cg = _chunked(b, chunk), _chunked(c, chunk)       # (B,G,C,Q,N)
    a = -np.exp(a_log)
    # pass 1: s by scans of 256 steps from the carry, w, S_c a unit a chain
    sc = np.zeros_like(dtc)
    carry = np.zeros(dtc.shape[:-1], f32)
    for t1 in range(0, chunk, 256):
        seg = np.cumsum(a[None, :, None, None] * dtc[..., t1:t1 + 256],
                        axis=-1, dtype=f32)
        sc[..., t1:t1 + 256] = seg + carry[..., None]
        carry = carry + seg[..., -1]
    w = dtc * np.exp(carry[..., None] - sc)
    bh = np.repeat(bg, rep, axis=1)
    s_c = np.zeros((bsz, h, nc, p, n), f32)
    for j0 in range(0, chunk, UNIT):
        xw = xc[..., j0:j0 + UNIT, :] * w[..., j0:j0 + UNIT, None]
        s_c = s_c + _chain(np.swapaxes(xw, -1, -2), bh[..., j0:j0 + UNIT, :],
                           mode)
    # pass 2
    e_q = np.exp(carry)
    state = np.zeros((bsz, h, p, n), f32) if h0 is None else h0
    h_in = np.empty_like(s_c)
    for ci in range(nc):
        h_in[:, :, ci] = state
        state = _fma(e_q[:, :, ci, None, None], state, s_c[:, :, ci])
    # pass 3, tile by tile: C B^T once a group, then each head
    y = np.zeros_like(xc)
    loc = np.arange(R)
    lower = loc[None, :] <= loc[:, None]
    for t in range(nq):
        own = slice(t * R, (t + 1) * R)
        s_t = sc[..., own]                                 # (B,H,C,R)
        c_h = np.repeat(cg[..., own, :], rep, axis=1)
        yt = np.exp(s_t)[..., None] * _sum(c_h, np.swapaxes(h_in, -1, -2),
                                           mode, CHAIN)
        for k in range(t + 1):
            key = slice(k * R, (k + 1) * R)
            cb = np.repeat(_sum(cg[..., own, :],
                                np.swapaxes(bg[..., key, :], -1, -2), mode,
                                CHAIN), rep, axis=1)
            s_k, dt_k = sc[..., key], dtc[..., key]
            if k < t:
                m = s_k[..., -1:]
                ri = np.exp(s_t - m)[..., :, None]
                kf = (np.exp(m - s_k) * dt_k)[..., None, :]
                gm = (cb * ri) * kf
            else:
                seg = np.where(lower, s_t[..., :, None] - s_k[..., None, :],
                               f32(0))
                gm = np.where(lower, (cb * np.exp(seg)) * dt_k[..., None, :],
                              f32(0))
            yt = yt + _chain(gm.astype(f32), xc[..., key, :], mode)
        y[..., own, :] = yt
    return _unchunked(y), state


def _arrays(shape, seed=0):
    """x, dt, a_log, b, c, h0 (float32): the reference test's operands (dt
    = |N(0, 1)| 0.1, a_log = N(0, 1) 0.5, x, b, c standard normal), h0
    standard normal."""
    bsz, l, h, p, g, n, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bsz, l, h, p)).astype(f32),
            (np.abs(rng.standard_normal((bsz, l, h))) * 0.1).astype(f32),
            (0.5 * rng.standard_normal(h)).astype(f32),
            rng.standard_normal((bsz, l, g, n)).astype(f32),
            rng.standard_normal((bsz, l, g, n)).astype(f32),
            rng.standard_normal((bsz, h, p, n)).astype(f32)]


def _gates(got, want):
    """Normwise error and max |got - want| / (tol + tol |want|)."""
    got, want = np.asarray(got, f64), np.asarray(want, f64)
    ratio = np.max(np.abs(got - want) / (ELEM_TOL + ELEM_TOL * np.abs(want)))
    return _normwise(got, want), float(ratio)


_CACHE = {}


def _case(name, with_h0, mode="3xtf32"):
    """(emulated y, h_final; the reference's y list, h_final) at SHAPES[
    name]: the reference's y from ``_ssd_chunked`` and, without h0, from
    the Pallas kernel in interpret mode."""
    key = (name, with_h0, mode)
    if key not in _CACHE:
        shape = SHAPES[name]
        arrays = _arrays(shape)
        x, dt, a_log, b, c, h0 = arrays
        chunk = shape[-1]
        got = wgmma_fwd(x, dt, a_log, b, c, h0 if with_h0 else None,
                         chunk=chunk, mode=mode)
        jx, jdt, ja, jb, jc, jh0 = (jnp.asarray(t) for t in arrays)
        y, h_final = _ssd_chunked(jx, jdt, -jnp.exp(ja), jb, jc, chunk,
                                  h0=jh0 if with_h0 else None)
        ys = [np.asarray(y)]
        if not with_h0:
            ys.append(np.asarray(pallas_ssd(jx, jdt, ja, jb, jc, chunk=chunk,
                                            interpret=True)))
        _CACHE[key] = got, (ys, np.asarray(h_final))
    return _CACHE[key]


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("with_h0", [False, True])
def test_the_route_s_arithmetic_meets_the_float32_gates(name, with_h0):
    (y, h_final), (ys, ref_final) = _case(name, with_h0)
    for got, want in [(y, ref) for ref in ys] + [(h_final, ref_final)]:
        err, ratio = _gates(got, want)
        assert err <= F32_GATE and ratio <= 1.0, (name, err, ratio)


def test_the_route_s_arithmetic_agrees_with_the_plain_version():
    """The port's ``ssd_plain`` (what a CPU tensor runs, and what phase 6
    holds the kernels to on the card) and the emulated route within the
    same gates, with ``h0`` and ``return_state``."""
    (y, h_final), _ = _case("mamba2", True)
    x, dt, a_log, b, c, h0 = (torch.from_numpy(t)
                              for t in _arrays(SHAPES["mamba2"]))
    py, pf = ssd_plain(x, dt, a_log, b, c, chunk=SHAPES["mamba2"][-1],
                       h0=h0, return_state=True)
    for got, want in ((y, py.numpy()), (h_final, pf.numpy())):
        err, ratio = _gates(got, want)
        assert err <= F32_GATE and ratio <= 1.0, (err, ratio)


@pytest.mark.parametrize("name", ["mamba2", "long"])
def test_one_tf32_product_a_pair_misses_the_gate(name):
    """The same route with one TF32 product a step (operands rounded to
    the nearest TF32): y is off by about 1e-4 normwise, past the gate --
    the reason for the splits."""
    (y, _), (ys, _) = _case(name, False, mode="tf32")
    err = _normwise(y, ys[0])
    assert err > F32_GATE, err


# ------------------------------------------------------ device family --

def _sweep(kernel_name, configs):
    """Deterministic per-call costs, a pure function of the config."""
    kernel = DEVICE_KERNELS[kernel_name]
    out = {}
    for cfg in configs:
        chunk, p, n = cfg
        t = (1e-6 + 1e-10 * chunk * chunk) * kernel.proxy_steps(cfg, 2)
        out[cfg] = (Stats(0.9 * t, t, 1.2 * t, 1.02 * t, 0.05 * t), 1e-3,
                    10.0 * t)
    return out


def test_the_chunk_path_keys_each_route_apart():
    """The cuda_ssd family puts the route beside the shared-memory class:
    mamba2-2.7b's chunks 32 (mma_sync) and 64 to 256 (wgmma) fit a model a
    route, and a warm suite loads one model a class."""
    session = PredictorSession(repetitions=2)
    ds = session.device_suite(device="cpu", steps_per_dim=2,
                              sweep_fn=_sweep)
    problem = (1, 4096, 80, 64, 1, 128)
    configs = [(c, 64, 128) for c in (32, 64, 128, 256)]
    session.rank_device_tiles("cuda_ssd", problem, configs)
    classes = {ds.key("cuda_ssd", c).classes for c in configs}
    assert {r for _, r in classes} == {"wgmma", "mma_sync"}
    ms = ds.to_model_set()
    warm = PredictorSession(repetitions=2)
    wds = warm.device_suite(device="cpu", steps_per_dim=2,
                            sweep_fn=lambda *a: pytest.fail("measured"))
    assert wds.load_model_set(ModelSet.from_dict(ms.to_dict())) == \
        len(classes) == 2
    ranked = warm.rank_device_tiles("cuda_ssd", problem, configs)
    assert {r.source for r in ranked} == {"model"}


# ------------------------------------------------------------ on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wgmma kernels run only there "
                    "(chip_smoke.py phase 6 checks them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n, chunk", [(128, 256), (16, 64), (128, 32)])
def test_both_routes_match_plain_and_repeat_bit_for_bit(card, n, chunk):
    x, dt, a_log, b, c, h0 = (torch.from_numpy(t).to(card) for t in
                              _arrays((2, 512, 8, 64, 2, n, chunk)))
    before = dict(ssd.route_launches)
    got = ssd(x, dt, a_log, b, c, chunk=chunk, h0=h0, return_state=True)
    again = ssd(x, dt, a_log, b, c, chunk=chunk, h0=h0, return_state=True)
    torch.cuda.synchronize()
    route = ssd_route(64, n, chunk)
    assert ssd.route_launches[route] - before[route] == 2
    want = ssd_plain(x.double(), dt.double(), a_log.double(), b.double(),
                     c.double(), chunk=chunk, h0=h0.double(),
                     return_state=True)
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        err, ratio = _gates(g_.cpu().numpy(), w_.cpu().numpy())
        assert err <= F32_GATE and ratio <= 1.0, (err, ratio)
