"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use it is
compiled for Hopper (``-gencode arch=compute_90a,code=sm_90a``) with
``nvcc -shared -Xcompiler -fPIC`` into ``build/repro_torch_kernels/`` at the
repository root and loaded with :mod:`ctypes`.  The library's file name
carries a hash of its source and flags, so an edited source rebuilds and a
built one is reused.  Nothing here runs at import: the CPU tests import
every module of the port, and a CPU-only install has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
#: build directory: ``build/`` at the repository root (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
#: ``--split-compile=0`` spreads one source's kernels over every core (the
#: attention file alone holds 128 instantiations)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_LOADED: Dict[str, ctypes.CDLL] = {}
#: wall seconds of each source's nvcc in this process (none when its
#: library was already built)
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    """The CUDA compiler of the toolkit PyTorch finds (``CUDA_HOME``)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build from "
                           "csrc/ at first use, with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed: the source,
    the headers of ``csrc/`` and the flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return it.

    The compiler's report (registers, shared memory and spills per
    kernel, from ``-Xptxas -v``) is written beside the library as
    ``<lib>.log``.  A failed build raises with the compiler's output.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd: List[str] = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                      str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
    return out


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Build several kernels at once: one nvcc process for each source,
    all started together (each compile is one process on one core)."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
