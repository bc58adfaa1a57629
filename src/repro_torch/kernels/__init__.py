"""Hand-written CUDA kernels for Hopper, each beside its plain version.

* ``matmul`` — tiled FP32-FFMA matmul (the dgemm analogue; tunable tiles),
  replacing ``repro/kernels/matmul.py::_matmul_kernel``

``ops`` holds the public wrappers, ``ref`` the plain PyTorch oracles.  The
kernels are built from ``csrc/`` on first use (:mod:`._build`).
"""

from . import ops, ref
from .matmul import matmul, smem_bytes, tile_legal

__all__ = ["ops", "ref", "matmul", "smem_bytes", "tile_legal"]
