"""The attention backward's wgmma route
(``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, route 1) on the
CPU: its route table, its arithmetic emulated against the float64
backward, and the division by the softcap it does with one reciprocal.

The route runs every product as a wgmma with bfloat16 operands and float32
accumulators.  The dK/dV kernel forms S^T and dP^T for a 64-row tile of
kv rows against a 64-row query tile, rounds p to bfloat16 once for dV,
forms dS = p (1 - t^2) (dP - delta) in float32 and feeds it to dK as hi =
bf16(dS) plus lo = bf16(dS - hi), two products into one accumulator; the
dQ kernel does the same for dQ.  A tensor-core accumulator keeps its sum
rounded toward zero after every k16 product (the model the emulation
uses), so the dK and dV chains run kFlush = 16 (tile, head) steps and are
then added to float32 sums with round-to-nearest.

Shapes are gemma2-27b's in small: 4 query heads over 2 kv heads, head dim
128, softcap 50, a local (window 64) and a global causal layer over 128
positions, inputs from a seed; the long chains are emulated at gemma2's
own two heads of 4096 rows.  The bound is chip_smoke's gate for the
kernels, 2^-12 normwise in bfloat16.  On the card, long unflushed chains
read about ten times the error this round-toward-zero model gives them
(dK 4.1e-4 normwise at gemma2's global layer, where the model says 4e-5),
so the route's own chains are held to a twentieth of the gate here.
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels._card import H100_SMEM_OPTIN  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BWD_BLOCKS, BWD_ROUTES, BWD_WGMMA_BLOCKS, BWD_WGMMA_TILE,
    WGMMA_HEAD_DIMS, attn_bwd_blocks, attn_bwd_route,
    attn_bwd_route_table, attn_bwd_smem_bytes, attn_bwd_tile_legal,
    attn_kv_range, flash_attention_bwd, padded_head_dim)

HQ, HKV, S, D, CAP = 4, 2, 128, 128, 50.0
LAYERS = {"local": 64, "global": 0}
BF16_GATE = 2.0 ** -12
#: (tile, head) steps a dK / dV chain runs before its flush (kFlush)
FLUSH = 16
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bf16(x):
    """float32 rounded to bfloat16 (nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _split_bf16(x):
    hi = _bf16(x)
    return hi, _bf16(np.asarray(x, np.float32) - hi)


def _rz32(x):
    """float64 to float32 rounded toward zero, as a tensor-core
    accumulator keeps its sum."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------ route table --

CONFIGS = [(dtype, blk, d) for dtype in _DTYPES
           for blk in sorted(set(BWD_BLOCKS + BWD_WGMMA_BLOCKS))
           for d in (16, 32, 64, 80, 96, 128)]


@pytest.mark.parametrize("dtype,blk,d", CONFIGS)
def test_every_config_has_at_most_one_route_and_the_table_says_which(
        dtype, blk, d):
    dt = _DTYPES[dtype]
    route = attn_bwd_route(dt, blk, d)
    width = padded_head_dim(d)
    wgmma = dtype == "bfloat16" and blk in BWD_WGMMA_BLOCKS and \
        width in WGMMA_HEAD_DIMS
    assert (route == "wgmma") == wgmma
    assert (route == "mma_sync") == (not wgmma and blk in BWD_BLOCKS)
    if route is None:
        assert not attn_bwd_tile_legal(4096, blk, d, dt.itemsize)
    else:
        assert route in BWD_ROUTES
        assert attn_bwd_smem_bytes(blk, d, dt.itemsize) <= H100_SMEM_OPTIN
        assert attn_bwd_tile_legal(4096, blk, d, dt.itemsize)


@pytest.mark.parametrize("arch", ["gemma2-27b", "jamba-v0.1-52b",
                                  "phi3-mini-3.8b", "hubert-xlarge"])
@pytest.mark.parametrize("s", [512, 4096])
def test_the_models_train_calls_take_the_wgmma_route(arch, s):
    """The block the backward picks for a model's bfloat16 train call (its
    head dim; 80 and 96 pad to 128) is on the wgmma route; float32 stays
    on mma.sync."""
    d = get_config(arch).head_dim_
    blk = attn_bwd_blocks(s, torch.bfloat16, d)
    assert blk == BWD_WGMMA_BLOCKS[0]
    assert attn_bwd_route(torch.bfloat16, blk, d) == "wgmma"
    assert attn_bwd_route(torch.float32, attn_bwd_blocks(s, torch.float32,
                                                         d), d) == "mma_sync"


def test_configs_no_route_takes_raise_and_name_the_table():
    table = attn_bwd_route_table()
    assert "wgmma" in table and "mma_sync" in table
    assert str(BWD_WGMMA_BLOCKS) in table and str(BWD_BLOCKS) in table
    assert attn_bwd_route(torch.float32, 128, 128) is None
    assert attn_bwd_route(torch.bfloat16, 128, 32) is None
    assert attn_bwd_route(torch.bfloat16, 16, 128) is None
    assert attn_bwd_route(torch.float16, 64, 64) is None
    assert attn_bwd_route(torch.bfloat16, 64, 160) is None
    with FakeTensorMode():
        q = torch.empty(1, 4, 256, 128, device="cuda")
        k = torch.empty(1, 2, 256, 128, device="cuda")
        lse = torch.empty(1, 4, 256, device="cuda")
        with pytest.raises(ValueError, match="route table: wgmma"):
            flash_attention_bwd(q, k, k, q, lse, q, blk=128)
        qb, kb = q.bfloat16(), k.bfloat16()
        grads = flash_attention_bwd(qb, kb, kb, qb, lse, qb)
        assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]


def _query_tiles(s, k0, nk, causal, window):
    """The dK/dV kernel's query_tiles: the 64-row query tiles [t0, t1)
    that keep a pair with keys [k0, k0 + nk)."""
    t0 = k0 // 64 if causal else 0
    t1 = s // 64
    if window > 0:
        t1 = min(t1, (window + k0 + nk - 2) // 64 + 1)
    return t0, t1


def _keeps(q0, nq, k0, nk, causal, window):
    q = np.arange(q0, q0 + nq)[:, None]
    k = np.arange(k0, k0 + nk)[None, :]
    keep = np.ones((nq, nk), bool)
    if causal:
        keep &= q >= k
    if window > 0:
        keep &= (q - k) < window
    return bool(keep.any())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (True, 150), (False, 0),
                                           (False, 100)])
def test_the_kernels_tile_ranges_are_the_mask_s(causal, window):
    """Both kernels visit exactly the 64-row tiles that keep a pair: the
    dK/dV kernel's query tiles of a kv block (query_tiles, the inverse of
    attn_kv_range) and the dQ kernel's kv tiles of a query block
    (key_tiles, attn_kv_range at bkv = 64), against brute force over the
    mask."""
    s = 512
    tiles = range(s // 64)
    for blk in BWD_WGMMA_BLOCKS:
        for j in range(s // BWD_WGMMA_TILE):
            k0 = BWD_WGMMA_TILE * j
            t0, t1 = _query_tiles(s, k0, BWD_WGMMA_TILE, causal, window)
            assert [t for t in tiles if _keeps(64 * t, 64, k0,
                                              BWD_WGMMA_TILE, causal,
                                              window)] == list(range(t0, t1))
        for i in range(s // blk):
            lo, hi = attn_kv_range(i, blk, 64, s, causal, window)
            assert [u for u in tiles if _keeps(blk * i, blk, 64 * u, 64,
                                              causal, window)] == \
                list(range(lo, hi))


# ------------------------------------------------------------- arithmetic --

def _keep(window):
    pos = np.arange(S)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= (pos[:, None] - pos[None, :]) < window
    return keep


def _problem(window, seed=27):
    """q, k, v, dO rounded to bfloat16 (as float32), the forward's o
    (bfloat16) and lse (float32), computed in float64."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(rng.standard_normal(sh).astype(np.float32))
                   for sh in ((HQ, S, D), (HKV, S, D), (HKV, S, D),
                              (HQ, S, D)))
    kr = np.repeat(k, HQ // HKV, axis=0).astype(np.float64)
    vr = np.repeat(v, HQ // HKV, axis=0).astype(np.float64)
    x = CAP * np.tanh(q.astype(np.float64) @ kr.transpose(0, 2, 1) /
                      np.sqrt(D) / CAP)
    x = np.where(_keep(window), x, -np.inf)
    lse = np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1)) + \
        x.max(-1)
    o = _bf16((np.exp(x - lse[..., None]) @ vr).astype(np.float32))
    return q, k, v, do, o, lse.astype(np.float32)


def _group_sum(t):
    """(HQ, S, D) per query head to (HKV, S, D) per kv head."""
    return t.reshape(HKV, HQ // HKV, S, D).sum(1)


def _reference(q, k, v, do, o, lse, window):
    """The backward's formulas in float64, p rounded to bfloat16 for dV:
    (dq, dk, dv)."""
    f = np.float64
    kr = np.repeat(k, HQ // HKV, axis=0).astype(f)
    vr = np.repeat(v, HQ // HKV, axis=0).astype(f)
    scale = 1.0 / np.sqrt(D)
    t = np.tanh(q.astype(f) @ kr.transpose(0, 2, 1) * scale / CAP)
    keep = _keep(window)
    p = np.where(keep, np.exp(CAP * t - lse.astype(f)[..., None]), 0.0)
    delta = (do.astype(f) * o.astype(f)).sum(-1, keepdims=True)
    ds = np.where(keep, p * (do.astype(f) @ vr.transpose(0, 2, 1) - delta)
                  * (1.0 - t * t), 0.0)
    dv = _group_sum(_bf16(p.astype(np.float32)).astype(f).transpose(0, 2, 1)
                    @ do.astype(f))
    dk = _group_sum(ds.transpose(0, 2, 1) @ q.astype(f)) * scale
    return ds @ kr * scale, dk, dv


def _outer(a, b):
    """The 16 exact products of a k16 step: a (16, m), b (16, n) to (16,
    m, n) in float64."""
    return a.astype(np.float64)[:, :, None] * b.astype(np.float64)[:, None, :]


def _chain(steps, flush):
    """The sum of ``steps``, each a k16 step's 16 exact products (16, ...):
    each step's sum added to a truncating accumulator, which every
    ``flush`` steps (0: never) is added to a float32 sum with
    round-to-nearest and started again from zero."""
    acc = total = None
    for n, step in enumerate(steps):
        if acc is None:
            acc = np.zeros(step.shape[1:], np.float32)
            total = np.zeros_like(acc)
        acc = _rz32(acc.astype(np.float64) + step.sum(0))
        if flush and (n + 1) % flush == 0:
            total, acc = total + acc, np.zeros_like(acc)
    return total + acc


def _route(q, k, v, do, o, lse, window):
    """The route's arithmetic: S, dP as exact bfloat16 products summed in
    float32, p and p (1 - t^2) in float32, dS = p (1 - t^2) (dP - delta);
    dV from round(p), dK and dQ from dS as hi + lo, each product step (16
    rows of the sum) into a truncating accumulator, dK and dV flushed
    every FLUSH (tile, head) steps in the dK/dV kernel's order (tiles
    outer, heads inner)."""
    f32 = np.float32
    kr = np.repeat(k, HQ // HKV, axis=0)
    vr = np.repeat(v, HQ // HKV, axis=0)
    scale = f32(1.0 / np.sqrt(D))
    s_ = (q.astype(np.float64) @ kr.transpose(0, 2, 1)).astype(f32)
    x = s_ * scale
    t = np.tanh(x / f32(CAP)).astype(f32)
    keep = _keep(window)
    p = np.where(keep, np.exp(f32(CAP) * t - lse[..., None]), f32(0))
    pfac = (p * (f32(1) - t * t)).astype(f32)
    delta = (do * o).sum(-1, keepdims=True, dtype=f32)
    dp = (do.astype(np.float64) @ vr.transpose(0, 2, 1)).astype(f32)
    ds = (pfac * (dp - delta)).astype(f32)
    hi, lo = _split_bf16(ds)
    pr = _bf16(p)
    g = HQ // HKV
    # dV and dK: per kv head, steps (tile of 64 rows, head), 4 k16 a step
    dv = np.zeros((HKV, S, D), f32)
    dk = np.zeros((HKV, S, D), f32)
    for h in range(HKV):
        heads = range(h * g, h * g + g)
        steps_v, steps_k = [], []
        for t0 in range(0, S, 64):
            for hq in heads:
                for r in range(t0, t0 + 64, 16):
                    rows = slice(r, r + 16)     # (16 rows, keys) x (16, D)
                    steps_v.append(_outer(pr[hq, rows], do[hq, rows]))
                    for part in (lo, hi):
                        steps_k.append(_outer(part[hq, rows], q[hq, rows]))
        dv[h] = _chain(steps_v, 4 * FLUSH)
        dk[h] = _chain(steps_k, 8 * FLUSH)
    # dQ: per query head, kv tiles in ascending order, unflushed
    dq = np.zeros((HQ, S, D), f32)
    for hq in range(HQ):
        steps = []
        for c in range(0, S, 16):
            for part in (lo, hi):
                steps.append(_outer(part[hq][:, c:c + 16].T,
                                    kr[hq, c:c + 16]))
        dq[hq] = _chain(steps, 0)
    return dq * scale, dk * scale, dv


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_the_route_s_arithmetic_meets_the_gate(layer):
    """round(p) for dV, dS = p (1 - t^2) (dP - delta) as hi + lo for dK
    and dQ, truncating chains flushed as the route flushes them: within
    2^-12 of the float64 backward at gemma2's widths in small."""
    window = LAYERS[layer]
    args = _problem(window)
    want = _reference(*args, window)
    got = _route(*args, window)
    errs = {n: _normwise(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                   want)}
    assert max(errs.values()) <= BF16_GATE, errs


def _long_chain_problem(seed=28, keys=64):
    """gemma2-27b's global layer at its two heads of 4096 rows, the first
    ``keys`` kv rows (whose chains are the longest): round(p) and dS (hi,
    lo) of those keys, dO and q, in bfloat16, and the float64 sums of
    their products.  p and dS are formed in float32, a head at a time: the
    sums the chains are held to are of these same operands."""
    rng = np.random.default_rng(seed)
    s, heads = 4096, 2
    q = _bf16(rng.standard_normal((heads, s, D)).astype(np.float32))
    k = _bf16(rng.standard_normal((s, D)).astype(np.float32))
    v = _bf16(rng.standard_normal((s, D)).astype(np.float32))
    do = _bf16(rng.standard_normal((heads, s, D)).astype(np.float32))
    above = ~np.tri(s, dtype=bool)
    pk = np.empty((heads, s, keys), np.float32)
    dsk = np.empty_like(pk)
    for h in range(heads):
        t = np.tanh(q[h] @ k.T / np.float32(np.sqrt(D) * CAP))
        x = np.float32(CAP) * t
        x[above] = -np.inf
        x -= x.max(-1, keepdims=True)
        p = np.exp(x, out=x)
        p /= p.sum(-1, keepdims=True)
        delta = (do[h] * (p @ v)).sum(-1, keepdims=True)
        dp = do[h] @ v.T
        dsk[h] = (p * (dp - delta) * (1 - t * t))[:, :keys]
        pk[h] = _bf16(p[:, :keys])
        del t, x, p, dp
    hi, lo = _split_bf16(dsk)
    f = np.float64
    want_dv = np.einsum("hsk,hsd->kd", pk.astype(f), do.astype(f))
    want_dk = np.einsum("hsk,hsd->kd", dsk.astype(f), q.astype(f))
    return pk, hi, lo, do, q, want_dv, want_dk


def _walk(pk, hi, lo, do, q, flush):
    """The dK/dV kernel's chains over (64-row tile, head) steps, 4 k16
    products a step for dV and 8 (lo, hi) for dK, flushed every
    ``flush`` steps (0: never)."""
    h, s = pk.shape[:2]
    rows = [(hq, slice(r, r + 16)) for t0 in range(0, s, 64)
            for hq in range(h) for r in range(t0, t0 + 64, 16)]
    dv = _chain((_outer(pk[hq, r], do[hq, r]) for hq, r in rows),
                4 * flush)
    dk = _chain((_outer(part[hq, r], q[hq, r]) for hq, r in rows
                 for part in (lo, hi)), 8 * flush)
    return dv, dk


def test_long_chains_are_flushed_within_a_twentieth_of_the_gate():
    """At gemma2's two heads of 4096 rows (128 steps on the first kv
    block): the route's chains, flushed every FLUSH steps, stay within
    gate / 20 of the float64 sums under the truncation model; carried
    unflushed (512 products for dV, 1024 for dK) they do not, the margin
    the card's reading (about ten times the model's error) asks for."""
    args = _long_chain_problem()
    want_dv, want_dk = args[5:]
    dv, dk = _walk(*args[:5], FLUSH)
    flushed = (_normwise(dv, want_dv), _normwise(dk, want_dk))
    assert max(flushed) <= BF16_GATE / 20, flushed
    dv0, dk0 = _walk(*args[:5], 0)
    unflushed = (_normwise(dv0, want_dv), _normwise(dk0, want_dk))
    assert max(unflushed) > BF16_GATE / 20, unflushed
    assert max(unflushed) < BF16_GATE, unflushed   # the model alone passes


# ------------------------------------------------------ division by the cap --

def _rn32(x: Fraction) -> np.float32:
    """The exact rational ``x`` rounded to the nearest float32 (ties to
    even), for normal float32 results."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1, -x) if x < 0 else (1, x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if x < Fraction(2) ** e:
        e -= 1
    scaled = x / Fraction(2) ** (e - 23)       # in [2^23, 2^24)
    m, rest = divmod(scaled.numerator, scaled.denominator)
    half = Fraction(rest, scaled.denominator)
    if half > Fraction(1, 2) or (half == Fraction(1, 2) and m % 2):
        m += 1
    return np.float32(sign * m * 2.0 ** (e - 23))


def _div_cap(x: np.float32, cap: np.float32, rcap: np.float32) -> np.float32:
    """div_cap: q = x rcap in float32, then fma(fma(-q, cap, x), rcap, q)
    with each FMA rounded once."""
    q = np.float32(x * rcap)
    r = _rn32(Fraction(float(x)) - Fraction(float(q)) * Fraction(float(cap)))
    return _rn32(Fraction(float(r)) * Fraction(float(rcap)) +
                 Fraction(float(q)))


def test_one_reciprocal_and_an_fma_give_the_ieee_quotient_at_cap_50():
    """x / 50 as the route forms it (the reciprocal of the cap taken once,
    then one FMA correction) equals IEEE float32 division over a sweep of
    logits: a dense run of the range the scaled logits take and random
    ones over twenty binades, both signs."""
    cap = np.float32(CAP)
    rcap = np.float32(1.0) / cap
    rng = np.random.default_rng(50)
    xs = np.concatenate([
        np.linspace(-400.0, 400.0, 4001, dtype=np.float32),
        (rng.choice([-1.0, 1.0], 4000) *
         2.0 ** rng.uniform(-16, 12, 4000)).astype(np.float32)])
    xs = xs[xs != 0]
    bad = [float(x) for x in xs if _div_cap(x, cap, rcap) != x / cap]
    assert not bad, bad[:10]
    # one multiplication by the reciprocal alone is not the quotient
    assert any(np.float32(x * rcap) != x / cap for x in xs)
