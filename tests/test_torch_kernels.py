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
    # 16 x 16 threads, each on (bm/64) x (bn/64) quads of 4 x 4: at most
    # 64 accumulators, so 64-multiples with bm bn <= 128 * 128
    assert KERNEL_TILES == ((64, 64), (64, 128), (64, 256), (128, 64),
                            (128, 128), (256, 64))
    assert tile_legal(4096, 4096, 4096, 128, 128, 64)
    assert (128, 128) in KERNEL_TILES and (256, 256) not in KERNEL_TILES
    assert not tile_legal(4096, 4096, 4096, 256, 256, 8)    # no register tile
    assert not tile_legal(4096, 4096, 4096, 256, 128, 8)    # 128 accumulators
    assert not tile_legal(4096, 4096, 4096, 32, 32, 8)      # not instantiated
    assert not tile_legal(4096, 4096, 4096, 100, 128, 8)    # not instantiated
    assert not tile_legal(96, 4096, 4096, 64, 128, 8)       # does not divide
    assert not tile_legal(4096, 4096, 4096, 64, 64, 4)      # bk not built
    assert not tile_legal(4096, 4096, 4096, 64, 64, 24)
    assert not tile_legal(4096, 4096, 4096, 64, 64, 256, smem_limit=2 ** 30)
    # the ring: 3 stages of (bm + bn) x bk float32
    assert smem_bytes(128, 128, 64) == 3 * 4 * 256 * 64 == 196_608
    assert smem_bytes(128, 128, 128) > 232_448
    assert not tile_legal(4096, 4096, 4096, 128, 128, 128)
    assert tile_legal(4096, 4096, 4096, 128, 128, 128, smem_limit=2 ** 20)
    assert tile_legal(4096, 4096, 4096, 64, 64, 128)        # 196,608 B
    assert not tile_legal(4096, 4096, 4096, 256, 64, 64)    # 245,760 B
    assert tile_legal(4096, 4096, 4096, 256, 64, 32)


def test_stage_count_sets_the_ring_and_legal_set():
    from repro_torch.kernels.matmul import KERNEL_BKS, STAGES
    from repro_torch.perf.tile_tuner import legal_candidates
    assert (STAGES, KERNEL_BKS) == (3, (8, 16, 32, 64, 128))
    for bm, bn in KERNEL_TILES:
        for bk in KERNEL_BKS:
            assert smem_bytes(bm, bn, bk) == 4 * STAGES * (bm + bn) * bk
    legal = legal_candidates(4096, 4096, 4096)
    # small enough to sweep in seconds, every instantiated tile in it
    assert len(legal) == 23
    assert {(bm, bn) for bm, bn, _ in legal} == set(KERNEL_TILES)
    assert max(smem_bytes(*c) for c in legal) <= 232_448


@pytest.mark.parametrize("bm,bn", KERNEL_TILES)
def test_matmul_proxy_fills_the_card(bm, bn):
    from repro_torch.kernels.matmul import grid_steps, proxy_problem
    from repro_torch.tc import DEVICE_KERNELS
    kernel = DEVICE_KERNELS["cuda_matmul"]
    for bk in (8, 64):
        m, n, k = proxy_problem(bm, bn, bk)
        assert (m // bm) * (n // bn) >= 132          # the kernel's grid
        assert grid_steps(m, n, k, bm, bn, bk) == 16 ** 3 == \
            kernel.proxy_steps((bm, bn, bk), 16)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "walked = {m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')}\n"
        "assert {'repro_torch.configs', 'repro_torch.models', "
        "'repro_torch.models.transformer'} <= walked, walked\n"
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


def test_every_kernel_source_ships_as_package_data():
    """Each ``csrc/*.cu`` that ``_build`` compiles, and each header they
    include, is package data, so an installed port can build its kernels
    as a checkout does."""
    import fnmatch
    import tomllib
    from repro_torch.kernels import _build
    names = sorted(p.name for p in _build.CSRC.glob("*.cu*"))
    assert {"matmul.cu", "flash_attention.cu", "ssd.cu",
            "mma_tools.cuh"} <= set(names)
    with open(ROOT / "pyproject.toml", "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "repro_torch"]
    for name in names:
        rel = f"kernels/csrc/{name}"
        assert (ROOT / "src" / "repro_torch" / rel).is_file()
        assert any(fnmatch.fnmatch(rel, pat) for pat in patterns), rel


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)       # imports no torch at top level
    return module


def test_selected_ptxas_keys_are_found_in_a_ptxas_log():
    """chip_smoke reads each selected instantiation's registers from the
    compilers' ``-Xptxas -v`` reports by key: every key it builds must be
    found under the mangled names nvcc gives those instantiations (the
    attention forward's two routes, the backward's dK/dV and dQ kernels on
    its two routes and the SSD's three passes included, one of them not a
    template)."""
    smoke = _chip_smoke()
    prefix = "_ZN38_GLOBAL__N__025e8cd1_6_ssd_cu_aa245fc2"
    bwd = "_ZN55_GLOBAL__N__3b49a283_22_flash_attention_bwd_cu_f13b085c"
    names = {
        ("_ZN41_GLOBAL__N__42bcca10_9_matmul_cu_c44b2bfd13matmul_kernelIf"
         "Li2ELi2ELi64EEEvPKT_S4_PS2_iiii"): (161, 0, 0),
        ("_ZN41_GLOBAL__N__42bcca10_9_matmul_cu_c44b2bfd13matmul_kernelI13"
         "__nv_bfloat16Li2ELi2ELi64EEEvPKT_S4_PS2_iiii"): (150, 0, 0),
        ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_e37e835c16"
         "attn_sync_kernelIfLi128ELi128ELi128EEEvPKT_S3_S3_PS1_PfiiiiiNS_5"
         "LogitE"): (255, 0, 0),
        ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_e37e835c17"
         "attn_wgmma_kernelILi128ELi128ELi128EEEv14CUtensorMap_stS1_S1_P13"
         "__nv_bfloat16PfiiiiiNS_5LogitE"): (168, 12, 8),
        (prefix + "22ssd_chunk_state_kernelILi64ELi128EEEvPKfS2_S2_S2_PfS3_"
         "iiii"): (80, 4, 4),
        prefix + "21ssd_state_pass_kernelEPfPKfiiii": (48, 0, 0),
        (prefix + "21ssd_chunk_scan_kernelILi64ELi128ELi64EEEvPKfS2_S2_S2_"
         "S2_S2_Pfiiiii"): (128, 0, 0),
        (prefix + "21ssd_chunk_scan_kernelILi64ELi128ELi32EEEvPKfS2_S2_S2_"
         "S2_S2_Pfiiiii"): (128, 12, 32),
        (bwd + "20attn_bwd_dkdv_kernelIfLi4ELi128EEEvPKT_S3_S3_S3_PKfS5_PS1_"
         "S6_iiiiNS_8PairArgsE"): (255, 8, 8),
        (bwd + "18attn_bwd_dq_kernelIfLi4ELi128EEEvPKT_S3_S3_S3_PKfS5_PS1_"
         "iiiiNS_8PairArgsE"): (255, 0, 0),
        (bwd + "20attn_bwd_dkdv_kernelI13__nv_bfloat16Li2ELi128EEEvPKT_S4_"
         "S4_S4_PKfS6_PS2_S7_iiiiNS_8PairArgsE"): (168, 12, 20),
        (bwd + "26attn_bwd_wgmma_dkdv_kernelILi128EEEv14CUtensorMap_stS1_S1_"
         "S1_PKfS3_P13__nv_bfloat16S5_iiiiNS_8PairArgsE"): (246, 0, 0),
        (bwd + "24attn_bwd_wgmma_dq_kernelILi128ELi128EEEv14CUtensorMap_st"
         "S1_S1_S1_PKfS3_P13__nv_bfloat16iiiiNS_8PairArgsE"): (168, 0, 0),
    }
    lines = []
    for name, (regs, st, ld) in names.items():
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  "'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    0 bytes stack frame, {st} bytes spill stores, {ld} "
                  "bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers"]
    table = smoke.ptxas_table("\n".join(lines))
    assert len(table) == len(names)
    keys = smoke.selected_ptxas_keys((128, 128, 64), (128, 128, 128),
                                     (64, 64, 128))
    assert [what for what, _ in keys["ssd"]] == ["chunk_state",
                                                 "state_pass", "chunk_scan"]
    found = {what: table[key] for kernel in keys.values()
             for what, key in kernel}
    assert [what for what, _ in keys["flash_attention"]] == ["mma_sync",
                                                             "wgmma"]
    # the backward's bfloat16 mma.sync kernels at the models' config went
    # with the wgmma route: its float32 ones and the wgmma ones are read
    assert [what for what, _ in keys["flash_attention_bwd"]] == [
        "dkdv", "dq", "dkdv_wgmma", "dq_wgmma"]
    assert found == {"matmul": (161, 0, 0), "mma_sync": (255, 0, 0),
                     "wgmma": (168, 12, 8),
                     "chunk_state": (80, 4, 4), "state_pass": (48, 0, 0),
                     "chunk_scan": (128, 0, 0), "dkdv": (255, 8, 8),
                     "dq": (255, 0, 0), "dkdv_wgmma": (246, 0, 0),
                     "dq_wgmma": (168, 0, 0)}
    # chunk 32 selects the 32-row scan instantiation
    key = dict(smoke.selected_ptxas_keys((128, 128, 64), (128, 128, 128),
                                         (32, 64, 128))["ssd"])["chunk_scan"]
    assert table[key] == (128, 12, 32)
