"""The port's flash attention against the JAX Pallas kernel, and its
device-measurement family.

The CUDA kernel runs only on the card (``python3 chip_smoke.py`` holds it
against its plain version there; the ``cuda``-marked test below does the
same under pytest on a machine with a card).  Here, on the CPU, the
kernel wrapper takes its plain version — the kernel's online-softmax loop
over kv blocks — which is held against the Pallas kernel in interpret
mode on the same numpy inputs, at the reference test's tolerances (2e-5
float32; 3e-2 bfloat16, where q k^T, p and the output each round once to
bfloat16's 8-bit mantissa).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.flash_attention import \
    attn_grid_steps as ref_grid_steps  # noqa: E402
from repro.kernels.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.tc import PredictorSession as RefSession  # noqa: E402
from repro.tc.device import DEVICE_KERNELS as REF_KERNELS  # noqa: E402
from repro_torch.core.model import ModelSet  # noqa: E402
from repro_torch.core.sampler import Stats  # noqa: E402
from repro_torch.kernels import flash_attention, ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    KERNEL_BLOCKS, attn_grid_steps, attn_kv_range, attn_proxy_problem,
    attn_smem_bytes, attn_tile_legal, flash_attention_plain)
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.tc import DEVICE_KERNELS, PredictorSession  # noqa: E402
from repro_torch.tc.suite import MicroBenchmarkSuite  # noqa: E402

torch.set_num_threads(1)

H100_SMS = 132
H100_SMEM_OPTIN = 232_448
#: test_kernels_pallas.py::test_flash_attention_sweep's cases
CASES = [
    (4, 4, 64, 32, dict(causal=True)),                 # MHA causal
    (4, 2, 128, 32, dict(causal=True)),                # GQA
    (4, 1, 64, 16, dict(causal=False)),                # MQA encoder
    (4, 2, 128, 32, dict(causal=True, window=32)),     # sliding window
    (4, 2, 64, 32, dict(causal=True, softcap=20.0)),   # gemma2 softcap
]
TOLS = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(hq, hkv, s, d, b=2, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _both(arrays, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_flash_attention_plain_matches_pallas_interpret(hq, hkv, s, d, kw,
                                                        dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(hq, hkv, s, d), dtype)
    ref = jax_flash_attention(jq, jk, jv, bq=32, bkv=32, interpret=True,
                              **kw)
    before = flash_attention.launches
    out = flash_attention(q, k, v, bq=32, bkv=32, **kw)
    assert flash_attention.launches == before       # the CPU launches none
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = TOLS[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_attention_ref_matches_reference(hq, hkv, s, d, kw, dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(hq, hkv, s, d, seed=3), dtype)
    ref = jax_attention_ref(jq, jk, jv, **kw)
    out = attention_ref(q, k, v, **kw)
    assert out.dtype == q.dtype
    tol = TOLS[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        ops.attention(q, k, v, use_kernel=False, **kw).float().numpy(),
        out.float().numpy(), rtol=0, atol=0)


def test_masked_leading_blocks_stay_finite():
    """A window row whose first kv blocks are all masked accumulates
    exp(0) garbage there, which the first real block's alpha wipes: the
    finite -1e30 sentinel keeps it finite (-inf would give NaN)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 128, 16, b=1))
    out = flash_attention_plain(q, k, v, bkv=16, causal=True, window=16)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(
        out.numpy(), attention_ref(q, k, v, window=16).numpy(),
        rtol=2e-5, atol=2e-5)
    # the query block size changes nothing in the plain version
    np.testing.assert_array_equal(
        flash_attention(q, k, v, bq=16, bkv=16, window=16).numpy(),
        flash_attention(q, k, v, bq=128, bkv=16, window=16).numpy())


# ------------------------------------------------------ block skipping --

def _kept(sq, skv, causal, window):
    """The reference's mask as a (sq, skv) boolean array."""
    q_pos = np.arange(sq)[:, None]
    k_pos = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), dtype=bool)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def _brute_visits(sq, skv, bq, bkv, causal, window):
    """Per query block, the kv blocks that hold a kept pair, by brute force
    over the mask, and whether a row of the block keeps no key at all."""
    mask = _kept(sq, skv, causal, window)
    out = []
    for i in range(sq // bq):
        rows = mask[i * bq:(i + 1) * bq]
        hits = [j for j in range(skv // bkv)
                if rows[:, j * bkv:(j + 1) * bkv].any()]
        out.append((hits, bool((~rows.any(axis=1)).any())))
    return out


def _brute_steps(b, h, sq, skv, bq, bkv, causal, window):
    """What the kernel visits, counted row by row from the mask's
    definition: a kv block is visited when a row of the query block keeps
    a key in it, and every block is visited where a row keeps no key."""
    rows = np.arange(sq)
    k_lo = np.maximum(0, rows - window + 1) if window > 0 else \
        np.zeros_like(rows)
    k_hi = np.minimum(rows, skv - 1) if causal else np.full_like(rows,
                                                                 skv - 1)
    starts = np.arange(0, skv, bkv)
    total = 0
    for i in range(sq // bq):
        lo, hi = k_lo[i * bq:(i + 1) * bq], k_hi[i * bq:(i + 1) * bq]
        if (lo > hi).any():
            total += skv // bkv
            continue
        hit = (lo[:, None] <= starts[None, :] + bkv - 1) & \
            (hi[:, None] >= starts[None, :])
        total += int(hit.any(axis=0).sum())
    return b * h * total


MASKS = [(c, w) for c in (True, False) for w in (0, 1, 16, 100)]


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("sq", [256, 128, 512])
def test_attn_kv_range_matches_brute_force(sq, causal, window):
    """Every skipped block has no kept pair and every visited block has
    one, at sq = skv, skv / 2 and 2 skv; a block with a row that keeps no
    key (its window wholly past the keys) visits every block."""
    skv = 256
    for bq in (16, 32, 64):
        for bkv in (16, 32, 64):
            for i, (hits, empty) in enumerate(
                    _brute_visits(sq, skv, bq, bkv, causal, window)):
                lo, hi = attn_kv_range(i, bq, bkv, skv, causal, window)
                if empty:
                    assert (lo, hi) == (0, skv // bkv)
                else:
                    assert list(range(lo, hi)) == hits, (i, bq, bkv)
            # the two brute forces (mask, row intervals) count alike
            assert attn_grid_steps(1, 1, sq, skv, bq, bkv, causal, window) \
                == _brute_steps(1, 1, sq, skv, bq, bkv, causal, window)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (True, 16), (False, 100),
                                           (True, 4096)])
@pytest.mark.parametrize("b,h,s,bq,bkv", [
    (1, 1, 64, 32, 32), (2, 4, 128, 32, 64), (1, 32, 4096, 128, 64),
    (3, 16, 8192, 16, 128), (1, 8, 256, 256, 16)])
def test_attn_grid_steps_match_reference(b, h, s, bq, bkv, causal, window):
    """The visited (query block, kv block) pairs: the reference's full
    grid where no mask removes a block, the brute-force count otherwise."""
    steps = attn_grid_steps(b, h, s, 2 * s, bq, bkv, causal=causal,
                            window=window)
    if not causal and window == 0:
        assert steps == ref_grid_steps(b, h, s, 2 * s, bq, bkv)
    assert steps == _brute_steps(b, h, s, 2 * s, bq, bkv, causal, window)


def test_attn_grid_steps_at_the_papers_problems():
    # causal (1, 32, 4096, 4096, 128) at (128, 128): 528 of 1024 a head
    assert attn_grid_steps(1, 32, 4096, 4096, 128, 128) == 32 * 528
    assert attn_grid_steps(1, 32, 4096, 4096, 128, 128, causal=False) == \
        ref_grid_steps(1, 32, 4096, 4096, 128, 128) == 32 * 1024
    # gemma2-27b at 8192 tokens: local (window 4096) 1584, global 2080
    assert attn_grid_steps(1, 1, 8192, 8192, 128, 128, window=4096) == 1584
    assert attn_grid_steps(1, 1, 8192, 8192, 128, 128) == 2080


SKIP_CASES = [
    (2, 1, 64, 64, 16, dict(causal=True)),
    (2, 1, 128, 64, 16, dict(causal=True, window=16)),    # rows past keys
    (2, 1, 128, 64, 16, dict(causal=False, window=16)),   # rows past keys
    (2, 2, 64, 128, 16, dict(causal=True, window=24)),
    (4, 2, 128, 128, 32, dict(causal=True, window=32, softcap=20.0)),
    (2, 1, 64, 128, 16, dict(causal=False, window=40)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,sq,skv,d,kw", SKIP_CASES)
def test_skipping_plain_matches_reference_and_all_blocks(hq, hkv, sq, skv, d,
                                                         kw, dtype):
    """The plain version that visits only attn_kv_range per query block
    agrees with the Pallas kernel in interpret mode (which visits every
    block) and with the all-blocks plain version, including query blocks
    whose rows keep no key, where the reference averages all of v."""
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal(sh).astype(np.float32) for sh in
              ((2, hq, sq, d), (2, hkv, skv, d), (2, hkv, skv, d))]
    (jq, jk, jv), (q, k, v) = _both(arrays, dtype)
    tol = TOLS[dtype]
    for bq, bkv in ((16, 16), (32, 16), (16, 32)):
        ref = jax_flash_attention(jq, jk, jv, bq=bq, bkv=bkv,
                                  interpret=True, **kw)
        out = flash_attention(q, k, v, bq=bq, bkv=bkv, **kw)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)
        full = flash_attention_plain(q, k, v, bkv=bkv, **kw)
        np.testing.assert_allclose(out.float().numpy(),
                                   full.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("problem", [(1, 1, 64, 64, 32), (2, 8, 128, 256, 16),
                                     (1, 32, 4096, 4096, 128)])
def test_attn_transfer_bytes_match_reference(problem):
    mine = DEVICE_KERNELS["cuda_flash_attention"]
    ref = REF_KERNELS["flash_attention"]
    for itemsize in (2, 4):
        assert mine.transfer_bytes(problem, itemsize) == \
            ref.transfer_bytes(problem, itemsize)
    assert mine.operand_shapes(problem) == ref.operand_shapes(problem)
    # the family's call is causal: the port counts the blocks the kernel
    # visits, the reference the TPU's full grid; they agree without a mask
    b, h, sq, skv, d = problem
    cfg = (32, 32, d)
    assert mine.steps(problem, cfg) == _brute_steps(b, h, sq, skv, 32, 32,
                                                    True, 0)
    assert attn_grid_steps(b, h, sq, skv, 32, 32, causal=False) == \
        ref.steps(problem, cfg)
    assert mine.steps(problem, cfg) < ref.steps(problem, cfg)


@pytest.mark.parametrize("bq", KERNEL_BLOCKS)
@pytest.mark.parametrize("bkv", KERNEL_BLOCKS)
def test_attn_proxy_fills_the_card(bq, bkv):
    kernel = DEVICE_KERNELS["cuda_flash_attention"]
    cfg = (bq, bkv, 128)
    for steps in (16, 4):
        b, h, sq, skv, d = problem = attn_proxy_problem(*cfg,
                                                        steps_per_dim=steps)
        assert d == 128 and sq == bq * steps and skv == bkv * steps
        blocks = b * h * (sq // bq)              # the kernel's grid
        assert blocks >= H100_SMS
        assert kernel.proxy_steps(cfg, steps) == \
            attn_grid_steps(b, h, sq, skv, bq, bkv) == \
            kernel.steps(problem, cfg)


def test_attn_tile_legality_is_instantiation_and_shared_memory():
    # the q tile and two stages of k and v: on the mma.sync route a float32
    # stage holds 32 kv rows at most and a bfloat16 stage the kv block; on
    # the wgmma route (bfloat16 at the large blocks) a stage holds the kv
    # block, plus the alignment and the barriers.  Every block at every head
    # dim fits the H100 in both dtypes
    bf16 = torch.bfloat16
    assert attn_smem_bytes(128, 128, 128) == \
        4 * 128 * (128 + 4 * 32) == 131_072 <= H100_SMEM_OPTIN
    assert attn_smem_bytes(128, 128, 128, bf16) == \
        2 * 128 * (128 + 4 * 128) + 1024 + 8 * 9 == 164_936 <= \
        H100_SMEM_OPTIN
    assert attn_smem_bytes(128, 64, 128) == 4 * 128 * (128 + 4 * 32)
    assert attn_smem_bytes(64, 32, 16) == 4 * 16 * (64 + 4 * 32)
    assert attn_smem_bytes(32, 128, 128, bf16) == 2 * 128 * (32 + 4 * 128)
    assert all(attn_tile_legal(4096, 4096, bq, bkv, d, dtype=dtype)
               for bq in KERNEL_BLOCKS for bkv in KERNEL_BLOCKS
               for d in (16, 32, 64, 128)
               for dtype in (torch.float32, bf16))
    assert not attn_tile_legal(4096, 4096, 128, 128, 128,
                               smem_limit=120_000)    # over the limit
    assert not attn_tile_legal(4096, 4096, 128, 128, 128, dtype=bf16,
                               smem_limit=150_000)
    assert attn_tile_legal(4096, 4096, 64, 64, 128, smem_limit=120_000)
    assert attn_tile_legal(4096, 4096, 64, 128, 128, smem_limit=120_000)
    assert not attn_tile_legal(4096, 4096, 256, 128, 128)   # not built
    # a head dim between the instantiated ones runs padded to the next
    assert attn_tile_legal(4096, 4096, 128, 128, 96)        # at 128
    assert attn_smem_bytes(128, 128, 96) == attn_smem_bytes(128, 128, 128)
    assert not attn_tile_legal(4096, 4096, 128, 128, 160)   # d over 128
    assert not attn_tile_legal(4000, 4096, 64, 64, 128)     # not dividing
    assert not attn_tile_legal(4096, 4096, 0, 64, 128)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 3, 64, 16, b=1))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 64, 16, b=1))
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q, k, v, bq=48)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="needs q"):
        flash_attention(q[0], k, v)
    meta = torch.empty((1, 2, 64, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        flash_attention(meta, meta, meta)


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py checks the kernel")
    from repro_torch import to_torch
    q, k, v = _qkv(2, 1, 32, 16, b=1)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.attention(*(to_torch(a, device) for a in (q, k, v)))


# ------------------------------------------------------- device family --

def _per_step(cfg):
    """A deterministic per-grid-step cost: a pure function of the config."""
    bq, bkv, d = cfg
    return 2e-7 + 4e-12 * bq * bkv * d + 3e-9 * (bq + bkv)


def _sweep_for(kernels):
    def sweep(kernel_name, configs):
        out = {}
        for cfg in configs:
            t = _per_step(cfg) * kernels[kernel_name].proxy_steps(cfg, 2)
            out[cfg] = (Stats(0.9 * t, t, 1.2 * t, 1.02 * t, 0.05 * t),
                        1e-3, 10.0 * t)
        return out
    return sweep


def _xfer(direction, nbytes, repetitions):
    bw = 20e9 if direction == "h2d" else 10e9
    return [5e-6 + nbytes / bw] * repetitions


CONFIGS = [(16, 16, 32), (32, 32, 32), (32, 64, 32), (64, 32, 32),
           (64, 64, 32)]
PROBLEM = (2, 8, 256, 256, 32)


def _session():
    session = PredictorSession(repetitions=2)
    session.device_suite(device="cpu", steps_per_dim=2,
                         sweep_fn=_sweep_for(DEVICE_KERNELS),
                         transfer_measure_fn=_xfer)
    return session


def test_attention_family_ranks_like_the_reference():
    """With the same per-step costs, both packages predict the same full
    problem once each is scaled by its own step count: the reference's by
    the TPU's full grid, the port's by the blocks its kernel visits (the
    family's call is causal).  Transfer bytes agree, although the port's
    proxy differs from the reference's."""
    from repro.core.sampler import Stats as RefStats
    mine = _session()
    ref = RefSession(repetitions=2)

    def ref_sweep(kernel_name, configs):
        return {cfg: (RefStats(**st.as_dict()), f, sec)
                for cfg, (st, f, sec) in
                _sweep_for(REF_KERNELS)(kernel_name, configs).items()}
    ref.device_suite(sweep_fn=ref_sweep, transfer_measure_fn=_xfer,
                     steps_per_dim=2, interpret=True)
    got = mine.rank_device_tiles("cuda_flash_attention", PROBLEM, CONFIGS)
    want = {r.config: r for r in ref.rank_device_tiles("flash_attention",
                                                       PROBLEM, CONFIGS)}
    b, h, sq, skv, _ = PROBLEM
    visited = {cfg: attn_grid_steps(b, h, sq, skv, *cfg[:2])
               for cfg in CONFIGS}
    scaled = {cfg: want[cfg].t_h2d + want[cfg].t_d2h + want[cfg].t_compute *
              visited[cfg] / ref_grid_steps(b, h, sq, skv, *cfg[:2])
              for cfg in CONFIGS}
    assert [r.config for r in got] == sorted(CONFIGS, key=lambda c: (
        scaled[c], c))
    np.testing.assert_allclose([r.t_total for r in got],
                               [scaled[r.config] for r in got], rtol=1e-12)
    for r in got:
        assert r.t_compute == pytest.approx(
            _per_step(r.config) * visited[r.config], rel=1e-12)
        assert r.t_compute < want[r.config].t_compute    # causal skips
        assert (r.t_h2d, r.t_d2h) == pytest.approx(
            (want[r.config].t_h2d, want[r.config].t_d2h), rel=1e-12)
    assert mine.suite.measured == len(CONFIGS)


def test_three_families_round_trip_and_warm_rank_measures_nothing():
    session = _session()
    ds = session.device_suite()
    session.rank_device_tiles("cuda_flash_attention", PROBLEM, CONFIGS)
    session.rank_device_tiles("cuda_ssd", (1, 256, 8, 16, 1, 32),
                              [(32, 16, 32), (64, 16, 32)])
    session.rank_device_tiles("cuda_matmul", (256, 256, 256),
                              [(32, 32, 32), (64, 64, 32)])
    ms = ds.to_model_set()
    assert {"cuda_matmul", "cuda_flash_attention", "cuda_ssd"} <= \
        set(ms.models)
    warm = PredictorSession(suite=MicroBenchmarkSuite(repetitions=2))
    wds = warm.device_suite(device="cpu", steps_per_dim=2,
                            sweep_fn=lambda *a: pytest.fail("measured"))
    n_classes = len({(k.equation, k.classes) for k in session.suite.results})
    assert wds.load_model_set(ModelSet.from_dict(ms.to_dict())) == n_classes
    ranked = warm.rank_device_tiles("cuda_flash_attention", PROBLEM, CONFIGS)
    assert {r.source for r in ranked} == {"model"}
    assert warm.suite.measured == 0
    cold = session.rank_device_tiles("cuda_flash_attention", PROBLEM,
                                     CONFIGS)
    # the same totals, so the same order; (32, 64) and (64, 32) visit the
    # same number of causal blocks and tie, so either may come first
    cold_t = {r.config: r.t_total for r in cold}
    np.testing.assert_allclose([r.t_total for r in ranked],
                               [cold_t[r.config] for r in ranked], rtol=1e-9)
    assert [cold_t[r.config] for r in ranked] == pytest.approx(
        sorted(cold_t.values()), rel=1e-9)
    assert {r.config for r in ranked} == set(cold_t)


# ------------------------------------------------------------- on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel runs only "
                    "there (chip_smoke.py checks it on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,d,kw", CASES)
def test_kernel_matches_plain_on_the_card(card, hq, hkv, s, d, kw, dtype):
    _, ops_cpu = _both(_qkv(hq, hkv, s, d), dtype)
    q, k, v = (t.to(card) for t in ops_cpu)
    before = flash_attention.launches
    out = flash_attention(q, k, v, bq=32, bkv=32, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    plain = flash_attention_plain(q, k, v, bkv=32, **kw)
    tol = TOLS[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               plain.float().cpu().numpy(),
                               rtol=tol, atol=tol)
