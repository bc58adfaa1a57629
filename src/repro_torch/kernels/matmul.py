"""Tiled matmul: the hand-written Hopper kernel and its plain version.

The counterpart of ``repro/kernels/matmul.py``.  The kernel itself is
``csrc/matmul.cu``: one thread block per ``(bm, bn)`` output tile looping
over k in ``bk``-deep slabs, by two routes that an explicit table
(:func:`matmul_route`) chooses, neither a fall back for the other:

* ``"wgmma"``, the tensor cores (:data:`WGMMA_TILES`): a producer warp
  keeps a ring of TMA copies in flight and ``bm / 64`` consumer warpgroups
  run ``wgmma``; bfloat16 straight from the caller's tensors, float32 as
  three TF32 products (x_hi y_hi + x_hi y_lo + x_lo y_hi) on x and y^T
  split once into a scratch the wrapper allocates
  (:func:`split_scratch_floats`), each 32-deep slab a short chain added to
  a float32 sum;
* ``"ffma"``, every other legal tile: FP32 FFMA, a ring of :data:`STAGES`
  cp.async copies, each thread on a register tile of 4 x 4 quads fed by
  16-byte shared-memory loads.

Its note says what bounds each route and why it is built so.  The tile
sizes ``(bm, bn, bk)`` are the GPU counterpart of the paper's algorithmic
block size b: they fix the route, the shared-memory staging and the
register tile, and are selected by the model-based tile tuner
(:mod:`repro_torch.perf.tile_tuner`), which ranks both routes' tiles.

:func:`matmul` dispatches on where its operands lie: CUDA tensors launch
the kernel (or raise); CPU tensors take :func:`matmul_plain`, a blocked
emulation of the same tile loop — the counterpart of Pallas
``interpret=True``.  There is no fall back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build
from ._card import H100_SMEM_OPTIN

#: (bm, bn) register tiles of the ffma route: 16 x 16 threads, each owning
#: (bm/64) x (bn/64) quads of 4 x 4 accumulators, at most 64
KERNEL_TILES: Tuple[Tuple[int, int], ...] = tuple(
    (64 * gm, 64 * gn)
    for gm in (1, 2, 4) for gn in (1, 2, 4) if gm * gn <= 4)
#: slab depths of the ffma route (a compile-time size, so the k loop
#: unrolls whole)
KERNEL_BKS: Tuple[int, ...] = (8, 16, 32, 64, 128)
#: slabs in the ffma route's cp.async ring (fixed by its design)
STAGES = 3
#: threads per block of the ffma route (fixed by its design)
THREADS = 256
#: the routes (:func:`matmul_route`)
ROUTES: Tuple[str, ...] = ("wgmma", "ffma")
#: the wgmma route's (bm, bn, bk) per dtype: slabs of 128-byte rows (64
#: bfloat16, 32 float32), bm / 64 consumer warpgroups, bn up to 256 in
#: bfloat16 (128 accumulators a thread) and 128 in float32 (a slab's chain
#: beside the sum)
WGMMA_TILES: Dict[torch.dtype, Tuple[Tuple[int, int, int], ...]] = {
    torch.bfloat16: tuple((bm, bn, 64) for bm in (64, 128)
                          for bn in (64, 128, 256)),
    torch.float32: tuple((bm, bn, 32) for bm in (64, 128)
                         for bn in (64, 128)),
}
#: the most stages of the wgmma route's ring (``kMaxStages``)
WGMMA_MAX_STAGES = 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_route(dtype: torch.dtype, bm: int, bn: int,
                 bk: int) -> Optional[str]:
    """The route of tiles ``(bm, bn, bk)`` in ``dtype``: ``"wgmma"`` for
    the tiles of :data:`WGMMA_TILES`, ``"ffma"`` for every other tile of
    :data:`KERNEL_TILES` x :data:`KERNEL_BKS`, None where no route is
    built.  ``csrc/matmul.cu``'s ``route_of`` is the same table."""
    if dtype not in _DTYPE_CODES:
        return None
    if (bm, bn, bk) in WGMMA_TILES[dtype]:
        return "wgmma"
    if (bm, bn) in KERNEL_TILES and bk in KERNEL_BKS:
        return "ffma"
    return None


def matmul_route_table() -> str:
    """The route table, for the message of a tile it does not route."""
    return (f"wgmma: bfloat16 (bm, bn, bk) in "
            f"{WGMMA_TILES[torch.bfloat16]}, float32 in "
            f"{WGMMA_TILES[torch.float32]}; ffma: (bm, bn) in "
            f"{KERNEL_TILES} and bk in {KERNEL_BKS}, where wgmma does not "
            f"take the tile")


def wgmma_stages(dtype: torch.dtype, bm: int, bn: int) -> int:
    """Stages of the wgmma route's ring at ``(bm, bn)``: as many as the
    H100's opt-in shared memory holds beside 1024 bytes of alignment, each
    stage's 128-byte rows of x and y (the hi and lo halves of x and y^T in
    float32) and its two barriers, at most :data:`WGMMA_MAX_STAGES`
    (``WgCfg::NS``)."""
    stage = _wgmma_stage_bytes(dtype, bm, bn)
    return min(WGMMA_MAX_STAGES, (H100_SMEM_OPTIN - 1024) // (stage + 16))


def _wgmma_stage_bytes(dtype: torch.dtype, bm: int, bn: int) -> int:
    return 128 * (bm + bn) * (2 if dtype == torch.float32 else 1)


def smem_bytes(bm: int, bn: int, bk: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Shared memory one block of ``dtype`` at tiles ``(bm, bn, bk)``
    stages.  The wgmma route: its ring (:func:`wgmma_stages`), barriers and
    alignment.  The ffma route: a ring of :data:`STAGES` slabs, each an x
    slab (bm x bk) and a y slab (bk x bn), reckoned in float32 for both
    dtypes (bfloat16 operands stage half as much)."""
    if matmul_route(dtype, bm, bn, bk) == "wgmma":
        ns = wgmma_stages(dtype, bm, bn)
        return 1024 + ns * (_wgmma_stage_bytes(dtype, bm, bn) + 16)
    return 4 * STAGES * (bm + bn) * bk


def split_scratch_floats(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                         dtype: torch.dtype = torch.float32) -> int:
    """Floats of scratch a call allocates: the TF32 hi and lo halves of
    y^T and of x, 2 (m + n) k floats, on the float32 wgmma route; none
    elsewhere."""
    if dtype == torch.float32 and matmul_route(dtype, bm, bn, bk) == \
            "wgmma":
        return 2 * (m + n) * k
    return 0


def tile_legal(m: int, n: int, k: int, bm: int, bn: int, bk: int,
               smem_limit: int = H100_SMEM_OPTIN,
               dtype: torch.dtype = torch.float32) -> bool:
    """Can the kernel run ``(m, n, k)`` in ``dtype`` at tiles ``(bm, bn,
    bk)``?

    The tiles must divide the problem, a route must take them
    (:func:`matmul_route`: the union of the wgmma route's tiles and the
    ffma route's instantiated register tiles and slab depths), and its
    staging must fit ``smem_limit`` -- the card's opt-in shared memory per
    block.  This is the GPU analogue of the paper's cache-driven
    constraints on block sizes (§3.1.3).
    """
    if min(m, n, k, bm, bn, bk) <= 0 or m % bm or n % bn or k % bk:
        return False
    if matmul_route(dtype, bm, bn, bk) is None:
        return False
    return smem_bytes(bm, bn, bk, dtype) <= smem_limit


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
    to measure throughput rather than one block's latency: 16 x 16 =
    :data:`~repro_torch.kernels._card.PROXY_BLOCKS` blocks (about two per
    SM on the H100's 132) and 16 k-slabs, which
    also amortizes each block's prologue and epilogue.  Both routes take
    the same proxy (a block per output tile on both).
    """
    return (bm * steps_per_dim, bn * steps_per_dim, bk * steps_per_dim)


def matmul_plain(x: torch.Tensor, y: torch.Tensor, *, bm: int, bn: int,
                 bk: int) -> torch.Tensor:
    """The kernel's tile loop in plain PyTorch (any device), the plain
    version of both routes.

    Per output tile the kernel zeroes a float32 accumulator, adds one
    ``bk``-deep slab product per k-step and casts at the end; the tiles
    are independent, so emulating all of them at once is one loop over
    the slabs with a float32 product each.  (The wgmma route's 3xTF32
    arithmetic is emulated in ``tests/test_torch_matmul_tc.py``.)
    """
    m, k = x.shape
    n = y.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, bk):
        acc += x[:, k0:k0 + bk].float() @ y[k0:k0 + bk, :].float()
    return acc.to(x.dtype)


def _lib():
    lib = _build.load("matmul")
    lib.repro_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_matmul.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor,
            bm: int, bn: int, bk: int) -> None:
    lib = _lib()
    (m, k), n = x.shape, y.shape[1]
    code = _DTYPE_CODES[x.dtype]
    floats = split_scratch_floats(m, n, k, bm, bn, bk, x.dtype)
    scratch = torch.empty((floats,), dtype=torch.float32,
                          device=x.device) if floats else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_matmul(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n,
                           k, bm, bn, bk, code,
                           None if scratch is None else scratch.data_ptr(),
                           stream)
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
    kernel on the current stream, on the route :func:`matmul_route` gives
    -- contiguous, float32 or bfloat16, tiles legal for the card -- and
    anything the kernel does not take raises; CPU tensors run
    :func:`matmul_plain`.  ``matmul.launches`` counts kernel launches and
    ``matmul.launches_by_route`` splits them by route.
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
    route = matmul_route(x.dtype, bm, bn, bk)
    if route is None:
        raise ValueError(f"no route takes tiles ({bm}, {bn}, {bk}) in "
                         f"{x.dtype}: {matmul_route_table()}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, y)):
        raise ValueError("the matmul kernel takes contiguous, 16-byte "
                         "aligned row-major operands")
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if not tile_legal(m, n, k, bm, bn, bk, limit, x.dtype):
        raise ValueError(
            f"tiles ({bm}, {bn}, {bk}) are not legal for the kernel's "
            f"{route} route: its staging {smem_bytes(bm, bn, bk, x.dtype)} "
            f"B must fit {limit} B")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _launch(x, y, out, bm, bn, bk)
    matmul.launches += 1
    matmul.launches_by_route[route] += 1
    return out


matmul.launches = 0
matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
