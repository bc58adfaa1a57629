"""Public wrappers for the hand-written kernels.

``use_kernel=False`` computes with the :mod:`ref` oracle instead of the
kernel (the counterpart of the reference's ``use_pallas=False``).  With
``use_kernel=True`` the kernel wrapper decides by the operands' device:
CUDA tensors launch the kernel or raise, CPU tensors run its plain
emulation.
"""

from __future__ import annotations

from . import ref
from .flash_attention import flash_attention
from .matmul import matmul as _kernel_matmul
from .matmul import smem_bytes, tile_legal
from .ssd import ssd as _kernel_ssd


def matmul(x, y, *, bm=128, bn=128, bk=32, use_kernel=True):
    """``x @ y`` through the tiled kernel, or the oracle when
    ``use_kernel=False``."""
    if not use_kernel:
        return ref.matmul_ref(x, y)
    return _kernel_matmul(x, y, bm=bm, bn=bn, bk=bk)


def attention(q, k, v, *, causal=True, window=0, softcap=0.0, bq=128,
              bkv=128, use_kernel=True):
    """Attention through the flash-attention kernel, or the dense oracle
    when ``use_kernel=False``."""
    if not use_kernel:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    return flash_attention(q, k, v, bq=bq, bkv=bkv, causal=causal,
                           window=window, softcap=softcap)


def ssd(x, dt, a_log, b, c, *, chunk=128, use_kernel=True):
    """The SSD scan through the chunked kernel, or the sequential oracle
    when ``use_kernel=False``."""
    if not use_kernel:
        return ref.ssd_ref(x, dt, a_log, b, c)
    return _kernel_ssd(x, dt, a_log, b, c, chunk=chunk)


__all__ = ["matmul", "attention", "ssd", "smem_bytes", "tile_legal"]
