"""The tiled matmul's tensor-core route (``csrc/matmul.cu``, route
``wgmma``), its arithmetic emulated on the CPU against the Pallas kernel
in interpret mode, and its route table, legality and tile model.

The float32 route runs every product as three TF32 products (x_lo y_hi,
x_hi y_lo, x_hi y_hi): a pre-pass splits each operand into hi, rounded to
the nearest TF32 (ties away), and lo = a - hi, which the tensor core reads
with its low 13 bits cleared.  Products of the parts are exact, and a
tensor-core accumulator truncates rather than rounds, so the emulation
adds each m64nNk8 step's eight products exactly (in float64) to its
accumulator and truncates to float32, in the kernel's order: each 32-deep
slab a chain from zero, the small terms of its four k8 steps first and
then the four hi hi terms, and the chain added to the output's float32
sum by round-to-nearest.  The bfloat16 route's products are exact in
float32; each k16 step's sixteen go exactly into one truncating
accumulator over all of k, cast once to bfloat16.

The gates are chip_smoke's: phase 2's 2e-5 + 2e-5 |ref| elementwise at k
<= 256 (2e-2 in bfloat16) and phase 4's 1e-5 max |ref| at a deep k.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import matmul as jax_matmul  # noqa: E402
from repro_torch.kernels import matmul  # noqa: E402
from repro_torch.kernels.matmul import (KERNEL_BKS, KERNEL_TILES,  # noqa: E402
                                        ROUTES, WGMMA_TILES, matmul_plain,
                                        matmul_route, matmul_route_table,
                                        smem_bytes, split_scratch_floats,
                                        tile_legal, wgmma_stages)
from repro_torch.perf.roofline import H100_SXM  # noqa: E402
from repro_torch.perf.tile_tuner import (legal_candidates,  # noqa: E402
                                         predict_tile_time, rank_tiles)
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from test_torch_ssd_bwd_tc import _rz32, _tf32_hi, _tf32_read  # noqa: E402

torch.set_num_threads(1)

f32, f64 = np.float32, np.float64
GATE = {"float32": 2e-5, "bfloat16": 2e-2}
BIG_TOL = 1e-5
SLAB = 32         # the float32 route's slab, a chain from zero


def _inputs(m, n, k, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(f32),
            rng.standard_normal((k, n)).astype(f32))


def _parts(x, y, mode):
    """(small terms, hi hi) of a slab: lists of (A part, B part)."""
    xh, yh = _tf32_hi(x), _tf32_hi(y)
    if mode == "tf32":
        return [], [(xh, yh)]
    xl, yl = _tf32_read(x - xh), _tf32_read(y - yh)
    return [(xl, yh), (xh, yl)], [(xh, yh)]


def _wgmma_f32(x, y, mode="3xtf32"):
    """The float32 wgmma route's arithmetic: per slab, the small terms of
    every k8 step, then the hi hi terms, into a truncating chain from zero,
    then added to the float32 sum."""
    out = np.zeros((x.shape[0], y.shape[1]), f32)
    for k0 in range(0, x.shape[1], SLAB):
        steps = [(x[:, k:k + 8], y[k:k + 8, :])
                 for k in range(k0, k0 + SLAB, 8)]
        small = [p for sx, sy in steps for p in _parts(sx, sy, mode)[0]]
        big = [p for sx, sy in steps for p in _parts(sx, sy, mode)[1]]
        chain = np.zeros_like(out)
        for a, b in small + big:
            chain = _rz32(chain.astype(f64) + a.astype(f64) @ b.astype(f64))
        out = out + chain
    return out


def _wgmma_bf16(x, y):
    """The bfloat16 route's arithmetic: one truncating chain of k16 steps
    over all of k, cast once (x and y already bfloat16 values)."""
    acc = np.zeros((x.shape[0], y.shape[1]), f32)
    for k in range(0, x.shape[1], 16):
        acc = _rz32(acc.astype(f64) +
                    x[:, k:k + 16].astype(f64) @ y[k:k + 16, :].astype(f64))
    return torch.from_numpy(acc).bfloat16().float().numpy()


def _pallas(xn, yn, bm, bn, bk, dtype=jnp.float32):
    return np.asarray(jax_matmul(jnp.asarray(xn, dtype), jnp.asarray(yn,
                                                                     dtype),
                                 bm=bm, bn=bn, bk=bk, interpret=True),
                      f32)


def _ratio(got, ref, tol):
    return float((np.abs(got - ref) / (tol + tol * np.abs(ref))).max())


# ------------------------------------------------------- the arithmetic --

#: phase 2's shape for each float32 wgmma tile: (2 bm, 3 bn, 4 bk)
PHASE2_F32 = [(2 * bm, 3 * bn, 4 * bk, bm, bn, bk)
              for bm, bn, bk in WGMMA_TILES[torch.float32]]


@pytest.mark.parametrize("m,n,k,bm,bn,bk", PHASE2_F32 + [
    (128, 128, 256, 64, 64, 32)])
def test_3xtf32_meets_phase_2s_gate_against_pallas(m, n, k, bm, bn, bk):
    xn, yn = _inputs(m, n, k)
    ref = _pallas(xn, yn, bm, bn, bk)
    got = _wgmma_f32(xn, yn)
    ratio = _ratio(got, ref, GATE["float32"])
    exact = xn.astype(f64) @ yn.astype(f64)
    print(f"3xTF32 at {(m, n, k)}: max |diff| / gate {ratio:.3f}; against "
          f"the exact product {_ratio(got, exact, GATE['float32']):.3f}, "
          f"Pallas's float32 {_ratio(ref, exact, GATE['float32']):.3f}")
    # within half the gate (room for the card's accumulators), and no
    # further from the exact product than float32 rounding takes Pallas
    assert ratio <= 0.5
    assert _ratio(got, exact, GATE["float32"]) <= \
        1.25 * _ratio(ref, exact, GATE["float32"])


def test_3xtf32_meets_phase_4s_gate_on_a_deep_narrow_product():
    """64 x 64 x 4096: 128 slabs, each a short chain, summed by FADD."""
    xn, yn = _inputs(64, 64, 4096, seed=11)
    ref = _pallas(xn, yn, 64, 64, 512)
    got = _wgmma_f32(xn, yn)
    reading = float(np.abs(got - ref).max()) / float(np.abs(ref).max())
    print(f"3xTF32 at 64 x 64 x 4096: max_abs_err / max |ref| "
          f"{reading:.3e}")
    assert reading <= BIG_TOL / 10


def test_single_tf32_products_miss_the_gates():
    """One TF32 product a step (operands rounded to the nearest TF32): off
    by about 1e-3 relatively, past both gates -- the reason for the
    splits."""
    xn, yn = _inputs(128, 192, 128)
    ratio = _ratio(_wgmma_f32(xn, yn, mode="tf32"),
                   _pallas(xn, yn, 64, 64, 32), GATE["float32"])
    print(f"single TF32 at phase 2's shape: max |diff| / gate {ratio:.3f}")
    assert ratio > 1.0
    xn, yn = _inputs(64, 64, 4096, seed=11)
    ref = _pallas(xn, yn, 64, 64, 512)
    reading = float(np.abs(_wgmma_f32(xn, yn, mode="tf32") - ref).max()) \
        / float(np.abs(ref).max())
    print(f"single TF32 at 64 x 64 x 4096: {reading:.3e}")
    assert reading > BIG_TOL


def test_small_terms_first_truncates_less_than_in_issue_order():
    """Adding a slab's small terms before its hi hi terms leaves four
    truncations at the chain's full size instead of twelve: the emulation
    in the kernel's order is closer to the reference than one that issues
    each k8 step's three products in turn."""
    xn, yn = _inputs(64, 64, 4096, seed=5)
    ref = _pallas(xn, yn, 64, 64, 512).astype(f64)

    def interleaved(x, y):
        out = np.zeros((x.shape[0], y.shape[1]), f32)
        for k0 in range(0, x.shape[1], SLAB):
            chain = np.zeros_like(out)
            for k in range(k0, k0 + SLAB, 8):
                small, big = _parts(x[:, k:k + 8], y[k:k + 8, :], "3xtf32")
                for a, b in small + big:
                    chain = _rz32(chain.astype(f64) +
                                  a.astype(f64) @ b.astype(f64))
            out = out + chain
        return out
    ours = np.abs(_wgmma_f32(xn, yn) - ref).mean()
    theirs = np.abs(interleaved(xn, yn) - ref).mean()
    print(f"mean |diff|: small terms first {ours:.3e}, in issue order "
          f"{theirs:.3e}")
    assert ours < theirs


@pytest.mark.parametrize("m,n,k", [(128, 192, 256), (64, 64, 1024)])
def test_bf16_wgmma_chain_meets_the_bf16_gate(m, n, k):
    xn, yn = _inputs(m, n, k, seed=3)
    xb = torch.from_numpy(xn).bfloat16().float().numpy()
    yb = torch.from_numpy(yn).bfloat16().float().numpy()
    ref = _pallas(xn, yn, 64, 64, 64, jnp.bfloat16)
    ratio = _ratio(_wgmma_bf16(xb, yb), ref, GATE["bfloat16"])
    print(f"bf16 chain at {(m, n, k)}: max |diff| / gate {ratio:.3f}")
    assert ratio <= 1.0


def test_the_plain_version_is_both_routes_plain_version():
    """``matmul_plain`` (what a CPU tensor runs at any tile) against the
    emulated wgmma route at phase 2's gate."""
    xn, yn = _inputs(128, 128, 128)
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    plain = matmul(x, y, bm=64, bn=128, bk=32).numpy()
    assert matmul_route(torch.float32, 64, 128, 32) == "wgmma"
    assert _ratio(_wgmma_f32(xn, yn), plain, GATE["float32"]) <= 0.5
    np.testing.assert_array_equal(
        plain, matmul_plain(x, y, bm=64, bn=128, bk=32).numpy())


# ------------------------------------------------------------ the table --

def test_the_route_table_routes_every_tile_once():
    dtypes = (torch.float32, torch.bfloat16)
    sizes = (8, 16, 32, 64, 128, 256, 512)
    for dt in dtypes:
        for bm in sizes:
            for bn in sizes:
                for bk in sizes:
                    route = matmul_route(dt, bm, bn, bk)
                    if (bm, bn, bk) in WGMMA_TILES[dt]:
                        assert route == "wgmma"
                    elif (bm, bn) in KERNEL_TILES and bk in KERNEL_BKS:
                        assert route == "ffma"
                    else:
                        assert route is None
    assert matmul_route(torch.float64, 64, 64, 32) is None
    # the wgmma tiles: 128-byte slab rows, bm / 64 consumer warpgroups
    assert WGMMA_TILES[torch.bfloat16] == (
        (64, 64, 64), (64, 128, 64), (64, 256, 64), (128, 64, 64),
        (128, 128, 64), (128, 256, 64))
    assert WGMMA_TILES[torch.float32] == (
        (64, 64, 32), (64, 128, 32), (128, 64, 32), (128, 128, 32))
    # ffma keeps its tiles in the other dtype and at other depths
    assert matmul_route(torch.float32, 128, 128, 64) == "ffma"
    assert matmul_route(torch.bfloat16, 128, 128, 32) == "ffma"
    assert matmul_route(torch.float32, 128, 256, 64) is None
    assert matmul.launches_by_route.keys() == set(ROUTES)


def test_a_tile_no_route_takes_raises_and_names_the_table():
    table = matmul_route_table()
    assert "wgmma" in table and "ffma" in table
    assert str(WGMMA_TILES[torch.float32]) in table
    with FakeTensorMode():
        x = torch.empty(256, 256, device="cuda")
        with pytest.raises(ValueError, match="no route takes"):
            matmul(x, x, bm=128, bn=256, bk=64)
        with pytest.raises(ValueError, match="no route takes"):
            matmul(x, x, bm=256, bn=256, bk=32)
        # a bfloat16-only wgmma tile, asked for in bfloat16, is routed
        xb = torch.empty(256, 256, device="cuda", dtype=torch.bfloat16)
        assert matmul_route(xb.dtype, 128, 256, 64) == "wgmma"


def test_staging_scratch_and_the_union_s_legality():
    # the ring: as many stages as 232,448 bytes hold, at most 8, each the
    # 128-byte rows of x and y (both halves in float32) and two barriers
    assert wgmma_stages(torch.float32, 128, 128) == 3
    assert smem_bytes(128, 128, 32) == 1024 + 3 * (65_536 + 16)
    assert wgmma_stages(torch.bfloat16, 128, 256) == 4
    assert smem_bytes(128, 256, 64, torch.bfloat16) == \
        1024 + 4 * (49_152 + 16)
    for dt, tiles in WGMMA_TILES.items():
        for bm, bn, bk in tiles:
            assert 3 <= wgmma_stages(dt, bm, bn) <= 8
            assert smem_bytes(bm, bn, bk, dt) <= 232_448
            assert tile_legal(4096, 4096, 4096, bm, bn, bk, dtype=dt)
            assert not tile_legal(4096, 4096, 4096, bm, bn, bk,
                                  smem_limit=100_000, dtype=dt)
    # the float32 route's scratch: x and y^T split, 2 (m + n) k floats
    assert split_scratch_floats(4096, 4096, 4096, 128, 128, 32) == \
        2 * 8192 * 4096
    assert split_scratch_floats(4096, 4096, 4096, 128, 128, 64) == 0
    assert split_scratch_floats(4096, 4096, 4096, 128, 256, 64,
                                torch.bfloat16) == 0
    # the union: float32 23 tiles (4 wgmma), bfloat16 25 (6 wgmma)
    for dt, count in ((torch.float32, 23), (torch.bfloat16, 25)):
        legal = legal_candidates(4096, 4096, 4096, dtype=dt)
        assert len(legal) == count
        assert set(WGMMA_TILES[dt]) <= set(legal)


def test_predict_tile_time_reckons_each_route_at_its_rate():
    m = n = k = 4096
    flops = 2.0 * m * n * k
    steps = (m // 128) * (n // 128) * (k // 32)
    over = steps * 5e-7 / H100_SXM.sms
    # float32 on wgmma: three TF32 products at 495 TFLOP/s against the
    # panels' traffic, then the split's 12 (m + n) k bytes
    panels = 4.0 * (2 * m * k * (n // 128) + m * n)
    want = max(3 * flops / H100_SXM.tf32_tensor_flops,
               panels / H100_SXM.hbm_bytes_per_s) + \
        12.0 * (m + n) * k / H100_SXM.hbm_bytes_per_s + over
    assert predict_tile_time(m, n, k, 128, 128, 32) == pytest.approx(
        want, rel=1e-12)
    # float32 on ffma: the FP32 rate
    steps64 = (m // 128) * (n // 128) * (k // 64)
    assert predict_tile_time(m, n, k, 128, 128, 64) == pytest.approx(
        flops / H100_SXM.fp32_flops + steps64 * 5e-7 / H100_SXM.sms,
        rel=1e-12)
    # bfloat16 on wgmma: the bf16 tensor rate against the panels' traffic
    steps256 = (m // 128) * (n // 256) * (k // 64)
    panels16 = 2.0 * (m * k * (n // 256) + k * n * (m // 128) + m * n)
    assert predict_tile_time(m, n, k, 128, 256, 64, itemsize=2) == \
        pytest.approx(max(flops / H100_SXM.bf16_tensor_flops,
                          panels16 / H100_SXM.hbm_bytes_per_s) +
                      steps256 * 5e-7 / H100_SXM.sms, rel=1e-12)
    # the analytic ranking puts a wgmma tile first in both dtypes
    for itemsize, dt in ((4, torch.float32), (2, torch.bfloat16)):
        best = rank_tiles(m, n, k, analytic=True, itemsize=itemsize)[0]
        assert matmul_route(dt, best.bm, best.bn, best.bk) == "wgmma"


def test_the_device_family_keeps_the_routes_apart():
    from repro_torch.tc.device import device_key
    assert device_key("cuda_matmul", (128, 128, 32)).classes == \
        ("smem_tight", "wgmma")
    assert device_key("cuda_matmul", (128, 128, 64)).classes == \
        ("smem_tight", "ffma")
    assert device_key("cuda_matmul", (64, 64, 16)).classes == \
        ("smem_resident", "ffma")
