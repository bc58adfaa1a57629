"""The port's matmul against the JAX Pallas kernel, and its dispatch rules.

The CUDA kernel runs only on the card (``python3 chip_smoke.py`` holds it
against its plain version there).  Here, on the CPU, the kernel wrapper
takes its plain version — a blocked emulation of the kernel's tile loop —
which is held against the Pallas kernel in interpret mode on the same
numpy inputs, at the reference test's tolerances (2e-5 float32, 2e-2
bfloat16: one bf16 rounding of the output).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import matmul as jax_matmul  # noqa: E402
from repro_torch.kernels import matmul, ops, tile_legal  # noqa: E402
from repro_torch.kernels.matmul import (KERNEL_TILES, matmul_plain,  # noqa: E402
                                        smem_bytes)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [
    (128, 128, 128, 64, 64, 64),
    (256, 128, 192, 128, 64, 64),
    (64, 64, 64, 64, 64, 64),
    (256, 256, 256, 128, 128, 128),
    (384, 128, 256, 128, 128, 64),
]


def _inputs(m, n, k, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", SHAPES)
def test_matmul_plain_matches_pallas_interpret(m, n, k, bm, bn, bk, dtype):
    xn, yn = _inputs(m, n, k)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_matmul(jnp.asarray(xn, jdt), jnp.asarray(yn, jdt),
                     bm=bm, bn=bn, bk=bk, interpret=True)
    out = matmul(torch.from_numpy(xn).to(tdt), torch.from_numpy(yn).to(tdt),
                 bm=bm, bn=bn, bk=bk)
    assert out.dtype == tdt and out.shape == (m, n)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_cpu_wrapper_is_plain_and_counts_no_launch():
    xn, yn = _inputs(128, 64, 96)
    x, y = torch.from_numpy(xn), torch.from_numpy(yn)
    before = matmul.launches
    out = matmul(x, y, bm=64, bn=64, bk=32)
    assert matmul.launches == before
    assert torch.equal(out, matmul_plain(x, y, bm=64, bn=64, bk=32))
    np.testing.assert_allclose(
        ops.matmul(x, y, bm=64, bn=64, bk=32).numpy(),
        ops.matmul(x, y, use_kernel=False).numpy(), rtol=2e-5, atol=2e-5)


def test_cuda_requests_raise_without_a_card():
    """Asking for the card without one raises; nothing silently computes
    on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py checks the kernel")
    from repro_torch import resolve_device, to_torch
    from repro_torch.tc import DeviceSuite, MicroBenchmarkSuite
    xn, yn = _inputs(64, 64, 64)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(device)
        with pytest.raises(RuntimeError, match="CUDA"):
            matmul(to_torch(xn, device), to_torch(yn, device))
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceSuite(MicroBenchmarkSuite(), device=device)
    # a tensor on neither the card nor the CPU is refused, not computed
    meta = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        matmul(meta, meta, bm=64, bn=64, bk=64)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.ones((96, 64))
    with pytest.raises(ValueError, match="divide"):
        matmul(x, torch.ones((64, 64)), bm=64, bn=64, bk=64)
    with pytest.raises(TypeError):
        matmul(x.double(), torch.ones((64, 64)).double())
    with pytest.raises(ValueError, match="@"):
        matmul(x, torch.ones((32, 64)))


def test_tile_legality_is_shared_memory_and_register_tiles():
    assert tile_legal(4096, 4096, 4096, 128, 128, 64)
    assert (128, 128) in KERNEL_TILES and (256, 256) not in KERNEL_TILES
    assert not tile_legal(4096, 4096, 4096, 256, 256, 8)    # no register tile
    assert not tile_legal(4096, 4096, 4096, 100, 128, 8)    # not instantiated
    assert not tile_legal(96, 4096, 4096, 64, 128, 8)       # does not divide
    # 128x128x256 stages 263 KB: above the H100's 232,448-byte opt-in
    assert smem_bytes(128, 128, 256) > 232_448
    assert not tile_legal(4096, 4096, 4096, 128, 128, 256)
    assert tile_legal(4096, 4096, 4096, 128, 128, 256, smem_limit=2 ** 20)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))))\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 6
    # the chip smoke script stands alone too
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from repro." not in src \
        and "import repro\n" not in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_numpy_torch_helpers_round_trip(dtype):
    from repro_torch import to_numpy, to_torch
    a = np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32)
    if dtype == torch.bfloat16:
        a = torch.from_numpy(a).bfloat16().float().numpy()  # representable
    t = to_torch(a, "cpu", dtype)
    assert t.dtype == dtype
    np.testing.assert_array_equal(to_numpy(t).astype(np.float32), a)
