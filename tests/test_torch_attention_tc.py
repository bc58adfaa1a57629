"""The arithmetic of the attention forward on the tensor cores
(``src/repro_torch/kernels/csrc/flash_attention.cu``), emulated on the CPU
against float64 attention, and the route table that picks its two routes.

The wgmma route (bfloat16 at blocks of 64 and 128) computes S = Q K^T with
bfloat16 operands into a float32 accumulator, one product of 16 depth
steps after another; rounds p to bfloat16 once, against the kv block's
running max; and accumulates O in the tensor core across every kv block
(O scaled by alpha in float32 registers before each block, then one
product of 16 keys after another).  The mma.sync route takes the other
configs: bfloat16 as m16n8k16 with the same S and p, float32 as three TF32
products (hi hi + hi lo + lo hi, the small terms of S in an accumulator of
their own), each stage's P V started from zero and added to the output
accumulators in float32 with round-to-nearest; a float32 stage holds 32
keys and takes one online-softmax step, exact since float32 rounds no p.
A tensor-core accumulator truncates rather than rounds: the emulation
keeps every product exact and truncates the accumulator after each one.

Shapes are gemma2-27b's in small: 4 query heads over 2 kv heads, head dim
128, softcap 50, a local (window 64) and a global causal layer over 128
positions, inputs from a seed.  The reference is float64 attention over
the same kv blocks with p rounded to bfloat16 where the dtype rounds it
(the function both routes compute); the emulated output is compared
before its cast to the dtype.  Bounds are chip_smoke's gates for the
kernel: 2^-12 normwise in bfloat16, 1e-5 in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels._card import H100_SMEM_OPTIN  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ATTN_ROUTES, KERNEL_BLOCKS, KERNEL_HEAD_DIMS, WGMMA_BLOCKS,
    WGMMA_HEAD_DIMS, attn_route, attn_route_table, attn_smem_bytes,
    attn_tile_legal)
from repro_torch.models.attention import attn_blocks  # noqa: E402

HQ, HKV, S, D, CAP = 4, 2, 128, 128, 50.0
LAYERS = {"local": 64, "global": 0}
BF16_GATE = 2.0 ** -12
F32_GATE = 1e-5
NEG = -1e30
#: (route, dtype, bq, bkv): the configs the emulation runs, one a route
#: and dtype; attn_route must agree
ROUTE_CASES = [("wgmma", "bfloat16", 64, 64),
               ("mma_sync", "bfloat16", 32, 32),
               ("mma_sync", "float32", 64, 64)]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bf16(x):
    """float32 rounded to bfloat16 (nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _split_tf32(x):
    """x = hi + lo: hi the nearest TF32 (ties away, as the kernel rounds
    it), lo the rest as the tensor core reads it (low 13 bits cleared)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    hi = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    lo = (np.asarray(x, np.float32) - hi).view(np.uint32) & \
        np.uint32(0xFFFFE000)
    return hi, lo.view(np.float32)


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


def _inputs(dtype, seed=25):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((HQ, S, D), (HKV, S, D), (HKV, S, D)))
    if dtype == "bfloat16":
        q, k, v = (_bf16(t) for t in (q, k, v))
    g = HQ // HKV
    return q, np.repeat(k, g, axis=0), np.repeat(v, g, axis=0)


def _keep(window):
    pos = np.arange(S)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep &= (pos[:, None] - pos[None, :]) < window
    return keep


def _reference(q, k, v, window, bkv, round_p):
    """float64 attention over kv blocks of ``bkv`` with the online
    softmax, p rounded by ``round_p`` (or not) before p v: the output
    before its cast."""
    f = np.float64
    x = CAP * np.tanh(q.astype(f) @ k.astype(f).transpose(0, 2, 1) /
                      np.sqrt(D) / CAP)
    x = np.where(_keep(window), x, NEG)
    m = np.full((HQ, S, 1), NEG)
    l = np.zeros((HQ, S, 1))
    acc = np.zeros((HQ, S, D))
    for j0 in range(0, S, bkv):
        xb = x[..., j0:j0 + bkv]
        m_new = np.maximum(m, xb.max(-1, keepdims=True))
        p = np.exp(xb - m_new)
        alpha = np.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdims=True)
        pr = round_p(p.astype(np.float32)).astype(f) if round_p else p
        acc = acc * alpha + pr @ v[:, j0:j0 + bkv].astype(f)
        m = m_new
    return acc / np.maximum(l, 1e-30)


def _chain(acc, parts):
    """``parts`` (exact float64 products, one mma each) added one after
    another into the truncating float32 accumulator ``acc``."""
    for part in parts:
        acc = _rz32(acc.astype(np.float64) + part)
    return acc


def _steps(a, b, depth):
    """The exact products a[..., i:i + depth] @ b[..., i:i + depth, :] of
    each depth step i, in float64."""
    f = np.float64
    return [a[..., i:i + depth].astype(f) @ b[..., i:i + depth, :].astype(f)
            for i in range(0, a.shape[-1], depth)]


def _tf32_steps(a, b):
    """3xTF32 by m16n8k8 steps: (hi hi, lo hi, hi lo) parts of each."""
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    return list(zip(_steps(ah, bh, 8), _steps(al, bh, 8), _steps(ah, bl, 8)))


def _logits(s, window, k0, n):
    """scale, softcap and mask of the raw products s (float32) of keys
    [k0, k0 + n)."""
    x = s * np.float32(1.0 / np.sqrt(D))
    x = np.float32(CAP) * np.tanh(x / np.float32(CAP))
    return np.where(_keep(window)[:, k0:k0 + n], x,
                    np.float32(NEG)).astype(np.float32)


def _emulate(route, dtype, bkv, window):
    """The route's arithmetic at kv block ``bkv``: the output before its
    cast, float32."""
    q, k, v = _inputs(dtype)
    f32 = dtype == "float32"
    stage = min(bkv, 32) if f32 else bkv   # keys a softmax step takes
    zeros = np.zeros((HQ, S, stage), np.float32)
    m = np.full((HQ, S, 1), NEG, np.float32)
    l = np.zeros((HQ, S, 1), np.float32)
    acc = np.zeros((HQ, S, D), np.float32)
    for k0 in range(0, S, stage):
        kt = k[:, k0:k0 + stage].transpose(0, 2, 1)
        vb = v[:, k0:k0 + stage]
        if f32:
            parts = _tf32_steps(q, kt)
            c = _chain(zeros, [hh for hh, _, _ in parts])
            corr = _chain(zeros, [x for _, lh, hl in parts for x in (lh, hl)])
            s = c + corr
        else:
            s = _chain(zeros, _steps(q, kt, 16))
        x = _logits(s, window, k0, stage)
        m_new = np.maximum(m, x.max(-1, keepdims=True))
        p = np.exp(x - m_new)
        alpha = np.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdims=True, dtype=np.float32)
        m = m_new
        acc = acc * alpha
        if route == "wgmma":               # O in the tensor core throughout
            acc = _chain(acc, _steps(_bf16(p), vb, 16))
            continue
        if f32:
            steps = [x for hh, lh, hl in _tf32_steps(p, vb)
                     for x in (lh, hl, hh)]
        else:
            steps = _steps(_bf16(p), vb, 16)
        acc = acc + _chain(np.zeros_like(acc), steps)
    return acc / np.maximum(l, np.float32(1e-30))


@pytest.mark.parametrize("layer", sorted(LAYERS))
@pytest.mark.parametrize("route,dtype,bq,bkv", ROUTE_CASES)
def test_route_arithmetic_meets_the_gate(route, dtype, bq, bkv, layer):
    assert attn_route(_DTYPES[dtype], bq, bkv, D) == route
    window = LAYERS[layer]
    q, k, v = _inputs(dtype)
    want = _reference(q, k, v, window, bkv,
                      _bf16 if dtype == "bfloat16" else None)
    got = _emulate(route, dtype, bkv, window)
    gate = BF16_GATE if dtype == "bfloat16" else F32_GATE
    assert _normwise(got, want) <= gate


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_the_bf16_gate_rejects_an_unrounded_p(layer):
    """The 2^-12 gate sees the rounding of p: the float64 function with p
    left unrounded misses it, against the function with p rounded."""
    window = LAYERS[layer]
    q, k, v = _inputs("bfloat16")
    rounded = _reference(q, k, v, window, 64, _bf16)
    assert _normwise(_reference(q, k, v, window, 64, None),
                     rounded) > BF16_GATE


def test_float32_p_v_needs_short_chains():
    """One row's p v over gemma2's 8192 keys.  In float32 (3xTF32, three
    products a k8 step) one truncating accumulator carried across every kv
    block drifts past the float32 gate; a stage's products started from
    zero and added in float32, as the mma.sync route adds them, stay
    within a tenth of it.  bfloat16's one product a k16 step, carried
    across every block as the wgmma route carries O, stays inside the
    bfloat16 gate."""
    rng = np.random.default_rng(3)
    p = (rng.random((64, 8192)) * 0.05).astype(np.float32)
    v = rng.standard_normal((8192, 64)).astype(np.float32)
    want = p.astype(np.float64) @ v.astype(np.float64)
    steps = [x for hh, lh, hl in _tf32_steps(p, v) for x in (lh, hl, hh)]
    zero = np.zeros((64, 64), np.float32)
    chain = _chain(zero, steps)
    short = zero.copy()
    for s0 in range(0, len(steps), 3 * 32 // 8):    # 32 keys a stage
        short = short + _chain(zero, steps[s0:s0 + 3 * 32 // 8])
    assert _normwise(chain, want) > F32_GATE
    assert _normwise(short, want) <= F32_GATE / 10
    pb, vb = _bf16(p), _bf16(v)
    want_bf = pb.astype(np.float64) @ vb.astype(np.float64)
    assert _normwise(_chain(zero, _steps(pb, vb, 16)), want_bf) <= \
        BF16_GATE / 10


def _legal_before(bq, bkv, d):
    """The FFMA kernel's legality, which every config keeps: instantiated
    blocks, a head dim up to 128, and its staging (q, k, v and a
    probability tile of at most 64 columns, float32) within the H100."""
    width = next((w for w in KERNEL_HEAD_DIMS if w >= d), None)
    if bq not in KERNEL_BLOCKS or bkv not in KERNEL_BLOCKS or width is None:
        return False
    return 4 * ((bq + 2 * bkv) * width + bq * min(bkv, 64)) <= \
        H100_SMEM_OPTIN


CONFIGS = [(dtype, bq, bkv, d) for dtype in _DTYPES
           for bq in KERNEL_BLOCKS for bkv in KERNEL_BLOCKS
           for d in (16, 32, 64, 80, 96, 128)]


@pytest.mark.parametrize("dtype,bq,bkv,d", CONFIGS)
def test_every_legal_config_has_one_route_that_fits(dtype, bq, bkv, d):
    dt = _DTYPES[dtype]
    route = attn_route(dt, bq, bkv, d)
    assert route in ATTN_ROUTES
    width = next(w for w in KERNEL_HEAD_DIMS if w >= d)
    assert (route == "wgmma") == (dtype == "bfloat16" and
                                  bq in WGMMA_BLOCKS and
                                  bkv in WGMMA_BLOCKS and
                                  width in WGMMA_HEAD_DIMS)
    assert attn_smem_bytes(bq, bkv, d, dt) <= H100_SMEM_OPTIN
    if _legal_before(bq, bkv, d):
        assert attn_tile_legal(4096, 4096, bq, bkv, d, dtype=dt)


def test_the_models_blocks_take_the_wgmma_route():
    for s in (4096, 8192):
        blk = attn_blocks(s)
        assert attn_route(torch.bfloat16, blk, blk, 128) == "wgmma"
    assert attn_route(torch.float32, 128, 128, 128) == "mma_sync"
    assert attn_route(torch.bfloat16, 16, 16, 128) == "mma_sync"
    assert attn_route(torch.bfloat16, 64, 64, 32) == "mma_sync"


def test_configs_no_route_takes_are_named_by_the_table():
    assert attn_route(torch.bfloat16, 256, 128, 128) is None
    assert attn_route(torch.float32, 128, 8, 128) is None
    assert attn_route(torch.bfloat16, 128, 128, 160) is None
    assert attn_route(torch.float16, 64, 64, 64) is None
    assert not attn_tile_legal(4096, 4096, 256, 128, 128,
                               dtype=torch.bfloat16)
    table = attn_route_table()
    assert "wgmma" in table and "mma_sync" in table
    assert str(WGMMA_BLOCKS) in table and str(KERNEL_BLOCKS) in table
