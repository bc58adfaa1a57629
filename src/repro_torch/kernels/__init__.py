"""Hand-written CUDA kernels for Hopper, each beside its plain version.

* ``matmul`` — tiled FP32-FFMA matmul (the dgemm analogue; tunable tiles),
  replacing ``repro/kernels/matmul.py::_matmul_kernel``
* ``flash_attention`` — online-softmax attention (GQA, causal, sliding
  window, softcap), replacing ``repro/kernels/flash_attention.py::
  _attn_kernel``
* ``ssd`` — the Mamba-2 chunked SSD scan, replacing
  ``repro/kernels/ssd.py::_ssd_kernel``

``ops`` holds the public wrappers, ``ref`` the plain PyTorch oracles.  The
kernels are built from ``csrc/`` on first use (:mod:`._build`).
"""

from . import ops, ref
from .flash_attention import flash_attention
from .matmul import matmul, smem_bytes, tile_legal
from .ssd import ssd

__all__ = ["ops", "ref", "matmul", "flash_attention", "ssd", "smem_bytes",
           "tile_legal"]
