"""Tiled matmul: the hand-written Hopper kernel and its plain version.

The counterpart of ``repro/kernels/matmul.py``.  The kernel itself is
``csrc/matmul.cu`` (FP32 FFMA, one thread block per ``(bm, bn)`` output
tile looping over k in ``bk``-deep shared-memory slabs; its note says what
bounds it and why it is built so).  The tile sizes ``(bm, bn, bk)`` are the
GPU counterpart of the paper's algorithmic block size b: they fix the
shared-memory staging and the register tile, and are selected by the
model-based tile tuner (:mod:`repro_torch.perf.tile_tuner`).

:func:`matmul` dispatches on where its operands lie: CUDA tensors launch
the kernel (or raise); CPU tensors take :func:`matmul_plain`, a blocked
emulation of the same tile loop — the counterpart of Pallas
``interpret=True``.  There is no fall back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

#: (bm, bn) output tiles the kernel is instantiated for: 16 x 16 threads,
#: each owning a (bm/16) x (bn/16) register tile of at most 64 accumulators
KERNEL_TILES: Tuple[Tuple[int, int], ...] = tuple(
    (16 * tm, 16 * tn)
    for tm in (2, 4, 8, 16) for tn in (2, 4, 8, 16) if tm * tn <= 64)
#: threads per block of the kernel (fixed by its design)
THREADS = 256
#: opt-in shared memory per block of the H100 (bytes): the staging limit the
#: plain version emulates when no card is asked about
H100_SMEM_OPTIN = 232_448

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Shared memory one block stages: an x slab (bm x bk, padded column
    stride bm + 1) and a y slab (bk x bn), both converted to float32."""
    return 4 * ((bm + 1) * bk + bk * bn)


def tile_legal(m: int, n: int, k: int, bm: int, bn: int, bk: int,
               smem_limit: int = H100_SMEM_OPTIN) -> bool:
    """Can the kernel run ``(m, n, k)`` at tiles ``(bm, bn, bk)``?

    The tiles must divide the problem, ``(bm, bn)`` must be one of the
    kernel's instantiated register tiles (launchable: 256 threads within
    the register file), and the staging must fit ``smem_limit`` — the
    card's opt-in shared memory per block.  This is the GPU analogue of
    the paper's cache-driven constraints on block sizes (§3.1.3).
    """
    if min(m, n, k, bm, bn, bk) <= 0 or m % bm or n % bn or k % bk:
        return False
    if (bm, bn) not in KERNEL_TILES:
        return False
    return smem_bytes(bm, bn, bk) <= smem_limit


def grid_steps(m: int, n: int, k: int, bm: int, bn: int, bk: int) -> int:
    """(block, k-slab) steps one (m, n, k) problem runs at tiles
    (bm, bn, bk)."""
    return (m // bm) * (n // bn) * (k // bk)


def proxy_problem(bm: int, bn: int, bk: int,
                  steps_per_dim: int = 16) -> tuple:
    """The canonical problem that measures tiles (bm, bn, bk).

    The device measurement protocol (:mod:`repro_torch.tc.device`) times
    a tile config on this problem and models the *per-step* cost; a full
    problem's compute term is that cost scaled by :func:`grid_steps`.
    On a GPU the blocks run in parallel, so the proxy must fill the card
    to measure throughput rather than one block's latency: 16 x 16 = 256
    blocks (about two per SM on the H100's 132) and 16 k-slabs, which
    also amortizes each block's prologue and epilogue.
    """
    return (bm * steps_per_dim, bn * steps_per_dim, bk * steps_per_dim)


def matmul_plain(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
                 bk: int) -> torch.Tensor:
    """The kernel's tile loop in plain PyTorch (any device).

    Per output tile the kernel zeroes a float32 accumulator, adds one
    ``bk``-deep slab product per k-step and casts at the end; the tiles
    are independent, so emulating all of them at once is one loop over
    the slabs with a float32 product each.
    """
    m, k = x.shape
    n = y.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, bk):
        acc += x[:, k0:k0 + bk].float() @ y[k0:k0 + bk, :].float()
    return acc.to(x.dtype)


def _launch(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor,
            bm: int, bn: int, bk: int) -> None:
    lib = _build.load("matmul")
    fn = lib.repro_matmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    (m, k), n = x.shape, y.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
             bk, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"matmul kernel launch failed at tiles "
                           f"({bm}, {bn}, {bk}) for ({m}, {n}, {k}): "
                           f"{msg} (cudaError {err})")


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128,
           bn: int = 128, bk: int = 32) -> torch.Tensor:
    """``x @ y`` through the tiled kernel, float32 accumulation.

    Tiles are clamped to the dims (``min(tile, dim)``) and must divide
    them, as in the reference.  CUDA tensors launch the hand-written
    kernel on the current stream — contiguous, float32 or bfloat16,
    tiles legal for the card — and anything the kernel does not take
    raises; CPU tensors run :func:`matmul_plain`.  ``matmul.launches``
    counts kernel launches.
    """
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul needs (m, k) @ (k, n), got "
                         f"{tuple(x.shape)} @ {tuple(y.shape)}")
    if x.dtype != y.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"matmul takes two float32 or two bfloat16 "
                        f"tensors, got {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    (m, k), n = x.shape, y.shape[1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if min(m, n, k) <= 0 or m % bm or n % bn or k % bk:
        raise ValueError(f"tiles ({bm}, {bn}, {bk}) must divide "
                         f"({m}, {n}, {k})")
    if x.device.type == "cpu":
        return matmul_plain(x, y, bm=bm, bn=bn, bk=bk)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or the CPU, not {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the matmul kernel takes contiguous row-major "
                         "operands")
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if not tile_legal(m, n, k, bm, bn, bk, limit):
        raise ValueError(
            f"tiles ({bm}, {bn}, {bk}) are not legal for the kernel: "
            f"(bm, bn) must be one of {KERNEL_TILES} and the staging "
            f"{smem_bytes(bm, bn, bk)} B must fit {limit} B")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _launch(x, y, out, bm, bn, bk)
    matmul.launches += 1
    return out


matmul.launches = 0
