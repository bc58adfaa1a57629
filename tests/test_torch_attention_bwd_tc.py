"""The arithmetic of the attention backward on the tensor cores
(``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``), emulated on the
CPU against the float64 backward.

The kernels run every product with ``mma.sync``.  bfloat16 products take
bfloat16 operands, so the dS that a kernel forms in float32 registers
enters dK and dQ as hi = bf16(dS) plus lo = bf16(dS - hi), two products
into one accumulator; p enters dV rounded once, as round(p) is defined.
float32 products run as three TF32 products (hi hi + hi lo + lo hi), every
operand split into hi, rounded to the nearest TF32 (a float32 with its low
13 mantissa bits cleared), and lo = a - hi as the tensor core reads it (low
13 bits cleared).  The emulation keeps exactly those roundings: products
of the rounded parts are exact in float32 and numpy sums them in float32.

A tensor-core accumulator truncates rather than rounds; the kernels keep
every chain short (a chunk's products start from zero and are added to the
float32 sums with round-to-nearest), and the last test shows why.

Shapes are gemma2-27b's in small: 4 query heads over 2 kv heads, head dim
128, softcap 50, a local (window 64) and a global causal layer over 128
positions, inputs from a seed.  The reference is the backward's formulas
in float64 on the same q, k, v, dO, forward output o (in the operands'
dtype) and row log-sum-exp lse.  Bounds are chip_smoke's gates for the
kernels: 2^-12 normwise in bfloat16, 1e-5 in float32.
"""

import numpy as np
import pytest

HQ, HKV, S, D, CAP = 4, 2, 128, 128, 50.0
LAYERS = {"local": 64, "global": 0}
BF16_GATE = 2.0 ** -12
F32_GATE = 1e-5


def _bf16(x):
    """float32 rounded to bfloat16 (nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _tf32_hi(x):
    """The nearest TF32 (ties away from zero), as the kernel rounds hi."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tf32_read(x):
    """What the tensor core reads of a float32: its low 13 bits cleared."""
    return (np.asarray(x, np.float32).view(np.uint32) &
            np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x):
    x = np.asarray(x, np.float32)
    hi = _tf32_hi(x)
    return hi, _tf32_read(x - hi)


def _mm3(a, b):
    """a @ b as three TF32 products summed in float32."""
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _split_bf16(x):
    hi = _bf16(x)
    return hi, _bf16(np.asarray(x, np.float32) - hi)


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _keep(window):
    pos = np.arange(S)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= (pos[:, None] - pos[None, :]) < window
    return keep


def _problem(dtype, window, seed=20):
    """q, k, v, dO in the operands' dtype (as float32 values), the forward's
    o (rounded to the dtype) and lse (float32), computed in float64."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32)
                   for sh in ((HQ, S, D), (HKV, S, D), (HKV, S, D),
                              (HQ, S, D)))
    if dtype == "bfloat16":
        q, k, v, do = (_bf16(t) for t in (q, k, v, do))
    kr = np.repeat(k, HQ // HKV, axis=0).astype(np.float64)
    vr = np.repeat(v, HQ // HKV, axis=0).astype(np.float64)
    x = CAP * np.tanh(q.astype(np.float64) @ kr.transpose(0, 2, 1) /
                      np.sqrt(D) / CAP)
    x = np.where(_keep(window), x, -np.inf)
    lse = np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1)) + \
        x.max(-1)
    o = (np.exp(x - lse[..., None]) @ vr).astype(np.float32)
    if dtype == "bfloat16":
        o = _bf16(o)
    return q, k, v, do, o, lse.astype(np.float32)


def _group_sum(t):
    """(HQ, S, D) per query head to (HKV, S, D) per kv head."""
    return t.reshape(HKV, HQ // HKV, S, D).sum(1)


def _reference(q, k, v, do, o, lse, window, round_p):
    """The backward's formulas in float64: (dq, dk, dv)."""
    f = np.float64
    kr = np.repeat(k, HQ // HKV, axis=0).astype(f)
    vr = np.repeat(v, HQ // HKV, axis=0).astype(f)
    scale = 1.0 / np.sqrt(D)
    t = np.tanh(q.astype(f) @ kr.transpose(0, 2, 1) * scale / CAP)
    keep = _keep(window)
    p = np.where(keep, np.exp(CAP * t - lse.astype(f)[..., None]), 0.0)
    delta = (do.astype(f) * o.astype(f)).sum(-1, keepdims=True)
    dp = do.astype(f) @ vr.transpose(0, 2, 1)
    ds = np.where(keep, p * (dp - delta) * (1.0 - t * t), 0.0)
    pv = round_p(p.astype(np.float32)).astype(f) if round_p else p
    dv = _group_sum(pv.transpose(0, 2, 1) @ do.astype(f))
    dk = _group_sum(ds.transpose(0, 2, 1) @ q.astype(f)) * scale
    dq = ds @ kr * scale
    return dq, dk, dv


def _kernel(q, k, v, do, o, lse, window, product, ds_parts, round_p):
    """The kernels' arithmetic: every product through ``product``, dS as
    the sum of ``ds_parts(dS)``; float32 registers otherwise."""
    kr = np.repeat(k, HQ // HKV, axis=0)
    vr = np.repeat(v, HQ // HKV, axis=0)
    scale = np.float32(1.0 / np.sqrt(D))
    t = np.tanh(product(q, kr.transpose(0, 2, 1)) * scale / np.float32(CAP))
    keep = _keep(window)
    p = np.where(keep, np.exp(np.float32(CAP) * t - lse[..., None]),
                 np.float32(0))
    delta = (do * o).sum(-1, keepdims=True, dtype=np.float32)
    dp = product(do, vr.transpose(0, 2, 1))
    ds = np.where(keep, p * (dp - delta) * (np.float32(1) - t * t),
                  np.float32(0)).astype(np.float32)
    pv = round_p(p) if round_p else p
    dv = _group_sum(product(pv.transpose(0, 2, 1), do))
    parts = ds_parts(ds)
    dk = _group_sum(sum(product(x.transpose(0, 2, 1), q) for x in parts))
    dq = sum(product(x, kr) for x in parts)
    return dq * scale, dk * scale, dv


def _bf16_case(layer, ds_parts):
    q, k, v, do, o, lse = _problem("bfloat16", LAYERS[layer])
    want = _reference(q, k, v, do, o, lse, LAYERS[layer], _bf16)
    got = _kernel(q, k, v, do, o, lse, LAYERS[layer], np.matmul, ds_parts,
                  _bf16)
    return {n: _normwise(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                   want)}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_bf16_ds_as_hi_plus_lo_meets_the_gate(layer):
    errs = _bf16_case(layer, _split_bf16)
    assert max(errs.values()) <= BF16_GATE, errs


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_bf16_ds_rounded_once_is_reported(layer, record_property):
    """The design's alternative, one bf16 rounding of dS: reported, not
    held to a bound (about 1e-3 in dK and dQ, the reason for the lo
    term)."""
    errs = _bf16_case(layer, lambda ds: (_bf16(ds),))
    record_property("normwise", errs)
    print(f"dS rounded once to bfloat16 ({layer}): {errs}")


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_three_tf32_products_meet_the_float32_gate(layer):
    q, k, v, do, o, lse = _problem("float32", LAYERS[layer])
    want = _reference(q, k, v, do, o, lse, LAYERS[layer], None)
    got = _kernel(q, k, v, do, o, lse, LAYERS[layer], _mm3,
                  lambda ds: (ds,), None)
    errs = {n: _normwise(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                   want)}
    assert max(errs.values()) <= F32_GATE, errs


def test_splits_are_exact_where_they_should_be():
    """hi + lo rebuilds a float32 to TF32's reading of lo (2^-21), hi is
    the nearest TF32, and bf16's hi + lo keeps dS to 2^-16."""
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    hi, lo = _split_tf32(x)
    assert np.all(_tf32_read(hi) == hi) and np.all(_tf32_read(lo) == lo)
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0 ** -11)
    assert np.all(np.abs(x - (hi + lo)) <= np.abs(x) * 2.0 ** -21)
    bhi, blo = _split_bf16(x)
    assert np.all(_bf16(bhi) == bhi) and np.all(_bf16(blo) == blo)
    assert np.all(np.abs(x - (bhi + blo)) <= np.abs(x) * 2.0 ** -16)


def _rz32(x):
    """float64 to float32 rounded toward zero, as a tensor-core
    accumulator keeps its sum."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def test_truncating_accumulators_need_short_chains():
    """dV's sum over 8192 query rows (4096 positions, two heads), one mma
    of 16 products after another into one truncating accumulator, drifts
    past the float32 gate; chunks of 32 rows started from zero and added
    in float32 with round-to-nearest, as the kernels add them, stay within
    a tenth of it."""
    rng = np.random.default_rng(2)
    p = rng.random((8192, 64)) * 0.05
    do = rng.standard_normal((8192, 64))
    terms = p * do
    want = terms.sum(0)
    chain = np.zeros(64, np.float32)
    for r0 in range(0, 8192, 16):
        chain = _rz32(chain.astype(np.float64) + terms[r0:r0 + 16].sum(0))
    chunked = np.zeros(64, np.float32)
    for c0 in range(0, 8192, 32):
        part = np.zeros(64, np.float32)
        for r0 in range(c0, c0 + 32, 16):
            part = _rz32(part.astype(np.float64) + terms[r0:r0 + 16].sum(0))
        chunked = chunked + part
    assert _normwise(chain, want) > F32_GATE
    assert _normwise(chunked, want) <= F32_GATE / 10
