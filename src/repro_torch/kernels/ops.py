"""Public wrappers for the hand-written kernels.

``use_kernel=False`` computes with the :mod:`ref` oracle instead of the
tiled kernel (the counterpart of the reference's ``use_pallas=False``).
With ``use_kernel=True`` the kernel wrapper decides by the operands'
device: CUDA tensors launch the kernel or raise, CPU tensors run its
plain tile-loop emulation.
"""

from __future__ import annotations

from . import ref
from .matmul import matmul as _kernel_matmul
from .matmul import smem_bytes, tile_legal


def matmul(x, y, *, bm=128, bn=128, bk=32, use_kernel=True):
    """``x @ y`` through the tiled kernel, or the oracle when
    ``use_kernel=False``."""
    if not use_kernel:
        return ref.matmul_ref(x, y)
    return _kernel_matmul(x, y, bm=bm, bn=bn, bk=bk)


__all__ = ["matmul", "smem_bytes", "tile_legal"]
