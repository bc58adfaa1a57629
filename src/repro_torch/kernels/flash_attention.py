"""Flash attention: the hand-written Hopper kernel and its plain version.

The counterpart of ``repro/kernels/flash_attention.py``.  The kernel is
``csrc/flash_attention.cu``, on the tensor cores: one thread block per
(batch, query head, query block) loops over the kv blocks that hold a kept
(query, key) pair, with the online-softmax state in registers; its note
says what bounds it (the tensor cores, and the special-function unit for
exp and softcap's tanh) and why it is built so.  It has two routes, chosen
by an explicit table (:func:`attn_route`), neither a fall back for the
other: ``"wgmma"`` for bfloat16 at bq, bkv in :data:`WGMMA_BLOCKS` and a
head dim in :data:`WGMMA_HEAD_DIMS` (TMA copies from a producer warp,
warpgroup products, the models' blocks), ``"mma_sync"`` for every other
legal config (a warp a 16 query rows, bfloat16 as m16n8k16, float32 as
three TF32 products with short accumulation chains).  Both cover every
flavour the reference covers: GQA by index (kv head ``h // (Hq / Hkv)``,
nothing repeated), causal and sliding-window masks with the finite
``-1e30`` sentinel, and gemma2's logit softcap.

:func:`flash_attention` dispatches on where its operands lie: CUDA tensors
launch the kernel (or raise); CPU tensors take
:func:`flash_attention_plain`, the kernel's kv-block loop in plain PyTorch
— the counterpart of Pallas ``interpret=True``.  There is no fall back
from one to the other.  The forward and the backward are ``torch.library``
operators (``repro_torch::flash_attention_fwd`` and ``_bwd``) with fake
implementations, autograd and flop formulas, so that a sharded step
(``DTensor`` shards, :mod:`repro_torch.distributed.local`) and a traced
one (fake tensors, :mod:`repro_torch.launch.dryrun`) reach them; a fake
tensor runs only the fake implementation.

The kernel skips the kv blocks a mask removes (:func:`attn_kv_range`), so
:func:`attn_grid_steps` counts the (query block, kv block) pairs it
visits.  That differs on purpose from the reference's count, which is the
TPU kernel's full grid; the two agree where no mask removes a block.

Training.  When grad is enabled and an operand requires it,
:func:`flash_attention` runs :class:`FlashAttentionFn`: the same forward,
which also writes each row's log-sum-exp, and a backward through
:func:`flash_attention_bwd` -- on CUDA tensors the three hand-written
kernels of ``csrc/flash_attention_bwd.cu`` (delta, dK/dV, dQ), on CPU
tensors :func:`flash_attention_bwd_plain`, the same arithmetic blockwise.
The backward kernels run their products on the tensor cores by two routes,
chosen by an explicit table (:func:`attn_bwd_route`), neither a fall back
for the other: ``"wgmma"`` for bfloat16 at a block in
:data:`BWD_WGMMA_BLOCKS` and a head dim in :data:`WGMMA_HEAD_DIMS` (TMA
copies from a producer warp, warpgroup products; every backward of the
models' train steps), ``"mma_sync"`` for float32 (three TF32 products) and
the other bfloat16 configs at :data:`BWD_BLOCKS`.  bfloat16 takes dS as hi
+ lo; every sum runs in a fixed order without atomics, so the result is
the same bits from run to run.  The reference has no backward kernel (it
differentiates ``chunked_attention`` in XLA); the backward takes Sq = Skv
only.

Head dims.  The kernels are instantiated at :data:`KERNEL_HEAD_DIMS`; any
other head dim up to 128 (hubert-xlarge's 80, phi3-mini's 96) runs at the
next instantiated width: the wrappers zero-pad q, k and v (and o and dO
for the backward) to it, keep the scale at 1/sqrt(D) of the true D and
slice the results back (:func:`padded_forward`, :func:`padded_backward`).
Zero columns add exact zeros to q k^T, to the output and to every
gradient, so the result is the unpadded one; the work is the padded
width's (128 / 80 = 1.6x and 128 / 96 = 1.33x at those two).  Legality
(:func:`attn_tile_legal`, :func:`attn_bwd_tile_legal`) and staging are
reckoned at the padded width.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ._card import H100_SMEM_OPTIN, PROXY_BLOCKS, card_smem, plain_route

#: block sizes the kernel is instantiated for: bq and bkv (a warp a 16
#: query rows on the mma.sync route, a warpgroup a 64 on the wgmma route)
#: and the head dim D
KERNEL_BLOCKS: Tuple[int, ...] = (16, 32, 64, 128)
KERNEL_HEAD_DIMS: Tuple[int, ...] = (16, 32, 64, 128)
#: the wgmma route's blocks and head dims, bfloat16 only
WGMMA_BLOCKS: Tuple[int, ...] = (64, 128)
WGMMA_HEAD_DIMS: Tuple[int, ...] = (64, 128)
#: the forward's routes, in the order of the table
ATTN_ROUTES: Tuple[str, ...] = ("wgmma", "mma_sync")
#: stages of the kernel's K and V ring (both routes)
KV_STAGES = 2
#: kv rows a float32 stage of the mma.sync route holds (one online-softmax
#: step); a bfloat16 stage holds the whole kv block
F32_STAGE_ROWS = 32
#: the wgmma route's staging beyond its tiles: 1024 bytes to align them to
#: the 128-byte swizzle's period, and its mbarriers (8 bytes each: one for
#: q, four a stage)
WGMMA_SMEM_EXTRA = 1024 + 8 * (1 + 4 * KV_STAGES)
#: the reference kernel's finite mask sentinel
NEG_INF = -1e30
#: the backward's mma.sync blocks (bq = bkv): 16 rows a warp, two warps a
#: row group; its dK and dV accumulators would not fit in registers at 128
BWD_BLOCKS: Tuple[int, ...] = (32, 64)
#: the backward's wgmma blocks, bfloat16 only, in the order
#: :func:`attn_bwd_blocks` prefers them: the query block of the dQ kernel
#: (a consumer warpgroup a 64 rows); the dK/dV kernel takes kv blocks of
#: :data:`BWD_WGMMA_TILE` rows at either
BWD_WGMMA_BLOCKS: Tuple[int, ...] = (128, 64)
#: the backward's routes, in the order of the table
BWD_ROUTES: Tuple[str, ...] = ("wgmma", "mma_sync")
#: rows of the tiles the backward's wgmma route streams through its ring,
#: and of the dK/dV kernel's kv block
BWD_WGMMA_TILE = 64
#: stages of the backward's wgmma rings (the dK/dV kernel's q and dO
#: tiles, the dQ kernel's k and v tiles)
BWD_WGMMA_STAGES = 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def padded_head_dim(d: int) -> Optional[int]:
    """The instantiated head dim that head dim ``d`` runs at: the
    smallest of :data:`KERNEL_HEAD_DIMS` not below ``d`` (``d`` itself
    where it is instantiated); None above the largest."""
    return next((k for k in KERNEL_HEAD_DIMS if k >= d), None) \
        if d > 0 else None


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns appended to its last dim up to ``width``
    (``t`` itself when it is that wide already)."""
    return t if t.shape[-1] == width else \
        F.pad(t, (0, width - t.shape[-1])).contiguous()


def padded_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   run: Callable):
    """``run(q, k, v, scale) -> (out, lse)`` on q, k and v zero-padded to
    :func:`padded_head_dim`, with ``scale`` = 1/sqrt(D) of the true head
    dim D; the output is sliced back to D (lse needs nothing).  The
    route the kernel takes at a head dim it is not instantiated for."""
    d = q.shape[3]
    width = padded_head_dim(d)
    out, lse = run(*(pad_head_dim(t, width) for t in (q, k, v)),
                   1.0 / (d ** 0.5))
    return (out if width == d else out[..., :d].contiguous()), lse


def padded_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, do: torch.Tensor, run: Callable):
    """``run(q, k, v, o, do, scale) -> (dq, dk, dv)`` on the operands
    zero-padded to :func:`padded_head_dim`, ``scale`` = 1/sqrt(D) of the
    true D; the gradients are sliced back to D.  The padded columns of o
    are the padded forward's exact zeros, so the rows' delta = rowsum(do
    o) is unchanged."""
    d = q.shape[3]
    width = padded_head_dim(d)
    grads = run(*(pad_head_dim(t, width) for t in (q, k, v, o, do)),
                1.0 / (d ** 0.5))
    return grads if width == d else tuple(g[..., :d].contiguous()
                                          for g in grads)


def attn_route(dtype: torch.dtype, bq: int, bkv: int,
               d: int) -> Optional[str]:
    """The forward kernel's route for ``dtype`` operands at blocks
    ``(bq, bkv)`` and head dim ``d`` (reckoned at :func:`padded_head_dim`):
    ``"wgmma"`` for bfloat16 at bq and bkv in :data:`WGMMA_BLOCKS` and a
    padded head dim in :data:`WGMMA_HEAD_DIMS`, ``"mma_sync"`` for every
    other instantiated config, None where nothing is instantiated.
    ``csrc/flash_attention.cu``'s ``route_of`` is the same table."""
    width = padded_head_dim(d) if d > 0 else None
    if bq not in KERNEL_BLOCKS or bkv not in KERNEL_BLOCKS or \
            width is None or dtype not in _DTYPE_CODES:
        return None
    if dtype == torch.bfloat16 and bq in WGMMA_BLOCKS and \
            bkv in WGMMA_BLOCKS and width in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma_sync"


def attn_route_table() -> str:
    """The route table, for the message of a config it does not route."""
    return (f"wgmma: bfloat16, bq and bkv in {WGMMA_BLOCKS}, head dim in "
            f"{WGMMA_HEAD_DIMS}; mma_sync: float32 or bfloat16, bq and bkv "
            f"in {KERNEL_BLOCKS}, head dim padded to one of "
            f"{KERNEL_HEAD_DIMS}, where wgmma does not take it")


def attn_smem_bytes(bq: int, bkv: int, d: int,
                    dtype: torch.dtype = torch.float32) -> int:
    """Shared memory one forward block stages on its route
    (:func:`attn_route`), at the padded head dim (:func:`padded_head_dim`):
    the q tile (bq x d) and :data:`KV_STAGES` stages of k and v.  A wgmma
    stage holds the kv block (bkv x d each), plus
    :data:`WGMMA_SMEM_EXTRA`; an mma.sync stage holds the kv block in
    bfloat16 and :data:`F32_STAGE_ROWS` of its rows at most in float32.
    float32 at bq = bkv = d = 128 takes 131,072 bytes, bfloat16 on the
    wgmma route 164,936; every route stays within the H100's opt-in
    limit."""
    d = padded_head_dim(d) or d
    itemsize = dtype.itemsize
    if attn_route(dtype, bq, bkv, d) == "wgmma":
        return itemsize * d * (bq + 2 * KV_STAGES * bkv) + WGMMA_SMEM_EXTRA
    rows = min(bkv, F32_STAGE_ROWS) if dtype == torch.float32 else bkv
    return itemsize * d * (bq + 2 * KV_STAGES * rows)


def attn_tile_legal(sq: int, skv: int, bq: int, bkv: int, d: int,
                    smem_limit: int = H100_SMEM_OPTIN,
                    dtype: torch.dtype = torch.float32) -> bool:
    """Can the kernel run sequence lengths ``(sq, skv)`` at head dim
    ``d`` with blocks ``(bq, bkv)`` in ``dtype``?  The blocks must divide
    the sequences, :func:`attn_route` must route the config (bq, bkv
    instantiated, ``d`` padding to an instantiated head dim: any ``d`` up
    to 128), and the route's staging at the padded width must fit
    ``smem_limit`` — the card's opt-in shared memory per block."""
    if min(sq, skv, bq, bkv, d) <= 0 or sq % bq or skv % bkv:
        return False
    if attn_route(dtype, bq, bkv, d) is None:
        return False
    return attn_smem_bytes(bq, bkv, d, dtype) <= smem_limit


def attn_kv_range(qblk: int, bq: int, bkv: int, skv: int, causal: bool,
                  window: int) -> Tuple[int, int]:
    """The kv blocks ``[lo, hi)`` the kernel visits for query block
    ``qblk``: those that hold a kept (query, key) pair.

    Under ``causal`` the blocks up to the diagonal; under ``window > 0``
    those from ``(qblk bq - window + 1) // bkv``, clamped at 0.  A block
    with a row whose window lies wholly past the keys (``sq > skv``)
    visits every block: that row keeps no key, and the reference returns
    the mean of v over every key, which only the full loop reproduces.
    ``csrc/flash_attention.cu`` computes the same range.
    """
    nkv = skv // bkv
    q0, q_last = qblk * bq, qblk * bq + bq - 1
    if window > 0 and q_last >= skv + window - 1:
        return 0, nkv
    hi = min(nkv, q_last // bkv + 1) if causal else nkv
    lo = max(0, q0 - window + 1) // bkv if window > 0 else 0
    return lo, hi


def attn_bwd_route(dtype: torch.dtype, blk: int, d: int) -> Optional[str]:
    """The backward kernels' route for ``dtype`` operands at block ``blk``
    and head dim ``d`` (reckoned at :func:`padded_head_dim`): ``"wgmma"``
    for bfloat16 at a block in :data:`BWD_WGMMA_BLOCKS` and a padded head
    dim in :data:`WGMMA_HEAD_DIMS`, ``"mma_sync"`` for float32 and every
    other bfloat16 config at a block in :data:`BWD_BLOCKS`, None where
    nothing is instantiated.  ``csrc/flash_attention_bwd.cu``'s
    ``route_of`` is the same table."""
    width = padded_head_dim(d) if d > 0 else None
    if width is None or dtype not in _DTYPE_CODES:
        return None
    if dtype == torch.bfloat16 and blk in BWD_WGMMA_BLOCKS and \
            width in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "mma_sync" if blk in BWD_BLOCKS else None


def attn_bwd_route_table() -> str:
    """The backward's route table, for the message of a config it does
    not route."""
    return (f"wgmma: bfloat16, block in {BWD_WGMMA_BLOCKS}, head dim in "
            f"{WGMMA_HEAD_DIMS}; mma_sync: float32 or bfloat16, block in "
            f"{BWD_BLOCKS}, head dim padded to one of {KERNEL_HEAD_DIMS}, "
            f"where wgmma does not take it")


def attn_bwd_smem_bytes(blk: int, d: int, itemsize: int = 4) -> int:
    """Shared memory a backward block stages on its route
    (:func:`attn_bwd_route`; the larger of its two kernels), at the padded
    head dim (:func:`padded_head_dim`).  mma.sync (the dK/dV kernel): its
    k and v tiles and two stages of the q and dO tiles (blk x d each, in
    the operands' dtype), two stages of the rows' lse and delta, and, for
    bfloat16 operands, the two column slices' dK sums in float32.  wgmma
    (bfloat16, tiles of t = :data:`BWD_WGMMA_TILE` rows,
    :data:`BWD_WGMMA_STAGES` stages): the dK/dV kernel's k and v (t x d),
    its stages of a q and a dO tile with their lse and delta rows, and the
    float32 dK and dV sums (t x d each); the dQ kernel's q and dO
    (blk x d) and its stages of a k and a v tile; each with its mbarriers
    (8 bytes: one for the block's own tiles, two a stage), plus 1024 bytes
    to align the tiles to the 128-byte swizzle's period.  blk = 64, d =
    128 takes 197,632 bytes in float32; the wgmma route at d = 128 165,928
    (the dK/dV kernel's).
    """
    d = padded_head_dim(d) or d
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    if attn_bwd_route(dtype, blk, d) == "wgmma":
        t, ns = BWD_WGMMA_TILE, BWD_WGMMA_STAGES
        dkdv = (2 * t * d * itemsize + ns * (2 * t * d * itemsize + 2 * 4 * t)
                + 2 * t * d * 4)
        dq = 2 * blk * d * itemsize + ns * 2 * t * d * itemsize
        return 1024 + max(dkdv, dq) + 8 * (1 + 2 * ns)
    dk_sums = 2 * blk * d * 4 if itemsize == 2 else 0
    return 6 * blk * d * itemsize + 4 * 4 * blk + dk_sums


def attn_bwd_tile_legal(s: int, blk: int, d: int, itemsize: int = 4,
                        smem_limit: int = H100_SMEM_OPTIN) -> bool:
    """Can the backward kernels run sequence length ``s`` (= Sq = Skv) at
    head dim ``d`` with block ``blk`` in operands of ``itemsize`` bytes
    (4 float32, 2 bfloat16)?  The block must divide the sequence,
    :func:`attn_bwd_route` must route the config (``d`` padding to an
    instantiated head dim), and the route's staging at the padded width
    must fit ``smem_limit``."""
    if min(s, blk, d) <= 0 or s % blk:
        return False
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    if attn_bwd_route(dtype, blk, d) is None:
        return False
    return attn_bwd_smem_bytes(blk, d, itemsize) <= smem_limit


def attn_bwd_blocks(s: int, dtype: torch.dtype = torch.float32,
                    d: int = 128) -> int:
    """The backward's block for sequence length ``s`` in ``dtype`` at head
    dim ``d``: the first block that divides ``s`` of the wgmma route's
    (:data:`BWD_WGMMA_BLOCKS`, where :func:`attn_bwd_route` gives it the
    config) and then the mma.sync route's (:data:`BWD_BLOCKS`, largest
    first); when none does, ``s`` itself (one block), which the plain
    version takes and the card refuses."""
    for blk in BWD_WGMMA_BLOCKS + tuple(sorted(BWD_BLOCKS, reverse=True)):
        if s % blk == 0 and attn_bwd_route(dtype, blk, d) is not None:
            return blk
    return s


def attn_grid_steps(b: int, h: int, sq: int, skv: int, bq: int, bkv: int,
                    causal: bool = True, window: int = 0) -> int:
    """(query block, kv block) pairs one attention call visits at blocks
    (bq, bkv): the blocks of :func:`attn_kv_range` for every query block.
    Without a mask that is the full grid, the reference's count."""
    per_head = 0
    for qblk in range(sq // bq):
        lo, hi = attn_kv_range(qblk, bq, bkv, skv, causal, window)
        per_head += hi - lo
    return b * h * per_head


def attn_proxy_problem(bq: int, bkv: int, d: int,
                       steps_per_dim: int = 16) -> tuple:
    """(b, h, sq, skv, d) of the problem that measures blocks (bq, bkv).

    The device protocol (:mod:`repro_torch.tc.device`) times a config on
    this problem and models its per-step cost.  The reference's proxy is
    one batch and one head, which on a GPU is ``steps_per_dim`` query
    blocks — a few of the card's 132 SMs, timing one block's latency.
    Here the proxy adds heads until it launches :data:`PROXY_BLOCKS`
    blocks (16 heads at 16 steps a dimension), so it measures
    throughput, and its per-step cost transfers to a full-width problem.
    """
    heads = -(-PROXY_BLOCKS // steps_per_dim)
    return (1, heads, bq * steps_per_dim, bkv * steps_per_dim, d)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention needs q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq = {q.shape[1]} is not a multiple of "
                         f"Hkv = {k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, bkv: int, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          bq: Optional[int] = None,
                          return_lse: bool = False,
                          scale: Optional[float] = None):
    """The kernel's online-softmax loop over kv blocks in plain PyTorch.

    With ``bq``, each query block visits only the kv blocks of
    :func:`attn_kv_range`, as the kernel does; without, every query row
    visits every kv block at once, as the TPU kernel's grid does.  The
    two give the same result: a skipped block adds nothing (see
    ``attn_kv_range``).  Vectorised over batches and query heads; GQA
    broadcasts each kv head over its query-head group.  Same arithmetic
    as the kernel: float32 logits and state, ``-1e30`` masking, ``p``
    rounded to the value dtype before ``p @ v`` while the denominator
    sums the unrounded ``p``, output ``acc / max(l, 1e-30)`` cast to the
    input dtype.  ``return_lse`` also returns each row's log-sum-exp
    ``m + log(max(l, 1e-30))``, float32 (B, Hq, Sq), as the kernel writes
    it for the backward.  ``scale`` defaults to 1/sqrt(D); the padded
    route passes the true D's.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    dev = q.device
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    if bq is None:
        blocks = [(0, sq, 0, skv // bkv)]
    else:
        blocks = [(i * bq, i * bq + bq,
                   *attn_kv_range(i, bq, bkv, skv, causal, window))
                  for i in range(sq // bq)]
    out = torch.empty_like(qf)
    lse = torch.empty((*qf.shape[:-1], 1), device=dev)
    for r0, r1, lo, hi in blocks:
        qb = qf[..., r0:r1, :]
        m = torch.full((*qb.shape[:-1], 1), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        q_pos = torch.arange(r0, r1, device=dev)[:, None]
        for j0 in range(lo * bkv, hi * bkv, bkv):
            kb = k[:, :, None, j0:j0 + bkv].float()
            vb = v[:, :, None, j0:j0 + bkv]
            s = (qb @ kb.transpose(-1, -2)) * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            k_pos = torch.arange(j0, j0 + bkv, device=dev)[None, :]
            mask = torch.ones((r1 - r0, bkv), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos >= k_pos
            if window > 0:
                mask &= (q_pos - k_pos) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ vb.float()
            m = m_new
        denom = torch.clamp_min(l, 1e-30)
        out[..., r0:r1, :] = acc / denom
        lse[..., r0:r1, :] = m + torch.log(denom)
    out = out.reshape(b, hq, sq, d).to(q.dtype)
    if return_lse:
        return out, lse.reshape(b, hq, sq)
    return out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0,
                              bq: Optional[int] = None,
                              scale: Optional[float] = None):
    """The backward kernels' arithmetic in plain PyTorch: (dq, dk, dv).

    ``o`` and ``lse`` are the forward's output and row log-sum-exp
    (:func:`flash_attention_plain` with ``return_lse``), ``do`` the
    output's gradient; Sq = Skv.  With ``delta = rowsum(do * o)`` and,
    per kept (query, key) pair, ``p = exp(x - lse)`` from the recomputed
    scaled and soft-capped logit ``x = cap tanh(s scale / cap)``:
    ``dv = round(p)^T do`` (p rounded to the value dtype: the gradient of
    the forward's cast passes straight through), ``ds = p (do v^T -
    delta) (1 - tanh^2)``, ``dk = ds^T q scale``, ``dq = ds k scale``;
    masked pairs give nothing.  Every sum is float32; GQA sums each kv
    head's gradient over its query-head group; results are cast to the
    operands' dtype.  With ``bq`` each query block takes only the kv
    blocks of :func:`attn_kv_range`, as the kernels do; without, every
    row at once.  ``scale`` defaults to 1/sqrt(D); the padded route passes
    the true D's.
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[2] != s:
        raise ValueError(f"the attention backward takes Sq = Skv, got "
                         f"{s} and {k.shape[2]}")
    g = hq // hkv
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    dev = q.device
    qf = q.float().reshape(b, hkv, g, s, d)
    gf = do.float().reshape(b, hkv, g, s, d)
    lf = lse.float().reshape(b, hkv, g, s, 1)
    delta = (gf * o.float().reshape(b, hkv, g, s, d)).sum(-1, keepdim=True)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dq = torch.empty_like(qf)
    dk = torch.zeros((b, hkv, s, d), device=dev)
    dv = torch.zeros_like(dk)
    if bq is None:
        blocks = [(0, s, 0, s)]
    else:
        blocks = [(i * bq, i * bq + bq, lo * bq, hi * bq)
                  for i in range(s // bq)
                  for lo, hi in [attn_kv_range(i, bq, bq, s, causal,
                                               window)]]
    for r0, r1, c0, c1 in blocks:
        qb, gb = qf[..., r0:r1, :], gf[..., r0:r1, :]
        kb, vb = kf[..., c0:c1, :], vf[..., c0:c1, :]
        x = (qb @ kb.transpose(-1, -2)) * scale
        fac = 1.0
        if softcap > 0.0:
            t = torch.tanh(x / softcap)
            x = softcap * t
            fac = 1.0 - t * t
        q_pos = torch.arange(r0, r1, device=dev)[:, None]
        k_pos = torch.arange(c0, c1, device=dev)[None, :]
        mask = torch.ones((r1 - r0, c1 - c0), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos >= k_pos
        if window > 0:
            mask &= (q_pos - k_pos) < window
        p = torch.where(mask, torch.exp(x - lf[..., r0:r1, :]), 0.0)
        dp = gb @ vb.transpose(-1, -2)
        ds = torch.where(mask, p * (dp - delta[..., r0:r1, :]) * fac, 0.0)
        dv[..., c0:c1, :] += (p.to(v.dtype).float().transpose(-1, -2)
                              @ gb).sum(2)
        dk[..., c0:c1, :] += (ds.transpose(-1, -2) @ qb).sum(2)
        dq[..., r0:r1, :] = (ds @ kb) * scale
    return (dq.reshape(b, hq, s, d).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def _lib(name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn


def _raise_on(err: int, name: str, what: str) -> None:
    if err != 0:
        msg = _build.load(name).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: {msg} (cudaError {err})")


def _launch(q, k, v, out, lse, bq: int, bkv: int, causal: bool,
            window: int, softcap: float, scale: float) -> None:
    """The forward kernel at an instantiated head dim; ``lse`` is None or
    the float32 (B, Hq, Sq) buffer for the rows' log-sum-exp."""
    fn = _lib("flash_attention", "repro_flash_attention",
              [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 +
              [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p])
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             0 if lse is None else lse.data_ptr(), b, hq, hkv, sq, skv, d,
             bq, bkv, scale, int(causal), int(window),
             float(softcap), _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "flash_attention",
              f"flash_attention kernel launch failed at blocks ({bq}, {bkv})"
              f" for q {tuple(q.shape)}, kv {tuple(k.shape)}")


def _launch_bwd(q, k, v, o, lse, do, delta, dq, dk, dv, blk: int,
                causal: bool, window: int, softcap: float,
                scale: float) -> None:
    """The three backward kernels (delta, dK/dV, dQ) on the current
    stream, at an instantiated head dim."""
    fn = _lib("flash_attention_bwd", "repro_flash_attention_bwd",
              [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 +
              [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p])
    b, hq, s, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk,
                                      dv)),
             b, hq, k.shape[1], s, d, blk, scale, int(causal),
             int(window), float(softcap), _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "flash_attention_bwd",
              f"flash_attention backward launch failed at block {blk} for q "
              f"{tuple(q.shape)}, kv {tuple(k.shape)}")


def _card_ready(tensors, what: str) -> int:
    """Raise unless every tensor is contiguous and 16-byte aligned; the
    card's opt-in shared memory per block."""
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"the {what} kernel takes contiguous, 16-byte "
                         f"aligned operands")
    return card_smem(tensors[0])


def _forward(q, k, v, bq: int, bkv: int, causal: bool, window: int,
             softcap: float, with_lse: bool):
    """(out, lse or None): the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, bq=bq, bkv=bkv, causal=causal,
                                    window=window, softcap=softcap,
                                    return_lse=with_lse)
        return res if with_lse else (res, None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    limit = _card_ready((q, k, v), "flash_attention")
    sq, d, skv = q.shape[2], q.shape[3], k.shape[2]
    route = attn_route(q.dtype, bq, bkv, d)
    if route is None:
        raise ValueError(
            f"no route of the kernel takes blocks ({bq}, {bkv}) at head dim "
            f"{d} in {q.dtype}; the route table: {attn_route_table()}")
    if not attn_tile_legal(sq, skv, bq, bkv, d, limit, q.dtype):
        raise ValueError(
            f"blocks ({bq}, {bkv}) at head dim {d} are not legal for the "
            f"kernel's {route} route: the staging "
            f"{attn_smem_bytes(bq, bkv, d, q.dtype)} B must fit {limit} B")

    def run(qp, kp, vp, scale):
        out = torch.empty_like(qp)
        lse = torch.empty(qp.shape[:3], dtype=torch.float32,
                          device=qp.device) if with_lse else None
        _launch(qp, kp, vp, out, lse, bq, bkv, causal, window, softcap,
                scale)
        return out, lse

    res = padded_forward(q, k, v, run)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return res


# ------------------------------------------------------------ operators --
# The forward and the backward are torch.library operators, so that the
# dispatcher sees them: a fake tensor (a traced step, ``launch.dryrun``)
# runs the fake implementation, which only shapes the outputs, and
# FlopCounterMode reads the formulas below.  The real implementation is
# the launch above (CUDA) or the plain version (CPU).  The wrappers call
# the operators for CUDA and fake tensors; a real CPU tensor runs the
# plain version as it always has, its products visible to a dispatch mode
# (the "dots" policy, the product counts of the tests).

@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bq: int, bkv: int, causal: bool, window: int,
                  softcap: float, with_lse: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): lse the float32 (B, Hq, Sq) row log-sum-exp, or an
    empty tensor without ``with_lse``."""
    out, lse = _forward(q, k, v, bq, bkv, causal, window, softcap, with_lse)
    return out, (q.new_empty((0,), dtype=torch.float32) if lse is None
                 else lse)


@_attention_op.register_fake
def _(q, k, v, bq, bkv, causal, window, softcap, with_lse):
    lse_shape = q.shape[:3] if with_lse else (0,)
    return torch.empty_like(q), q.new_empty(lse_shape, dtype=torch.float32)


def _attention_setup(ctx, inputs, output) -> None:
    q, k, v, _, _, causal, window, softcap, _ = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.mask = (causal, window, softcap)


def _attention_backward(ctx, dout, _dlse=None):
    q, k, v, out, lse = ctx.saved_tensors
    if lse.numel() == 0:
        raise RuntimeError("the attention backward needs the forward's row "
                           "log-sum-exp (with_lse=True)")
    causal, window, softcap = ctx.mask
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                     causal=causal, window=window,
                                     softcap=softcap)
    return dq, dk, dv, None, None, None, None, None, None


_attention_op.register_autograd(_attention_backward,
                                setup_context=_attention_setup)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      causal: bool, window: int, softcap: float, blk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the three backward kernels on CUDA tensors, the plain
    backward on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, softcap=softcap,
                                         bq=blk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or the CPU, not "
                         f"{q.device}")
    _card_ready((q, k, v, o, lse, do), "flash_attention backward")

    def run(qp, kp, vp, op, dop, scale):
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(t) for t in (qp, kp, vp))
        _launch_bwd(qp, kp, vp, op, lse, dop, delta, dq, dk, dv, blk,
                    causal, window, softcap, scale)
        return dq, dk, dv

    grads = padded_backward(q, k, v, o, do, run)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[
        attn_bwd_route(q.dtype, blk, q.shape[3])] += 1
    return grads


@_attention_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, window, softcap, blk):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def attn_kept_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs a mask keeps over one sq x skv head: row i
    keeps keys max(0, i - window + 1) .. min(i, skv - 1) under
    ``causal`` (skv - 1 without), as :func:`flash_attention_plain`'s mask
    does.  Causal and unwindowed at sq = skv = S: S (S + 1) / 2, the
    average kv length (S + 1) / 2 of ``perf.analytic``."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _attention_flops(q_shape, k_shape, v_shape, bq, bkv, causal, window,
                     softcap, with_lse, out_shape=None, **kwargs) -> int:
    """q k^T and p v: 4 D flops per kept (query, key) pair and query
    head."""
    b, hq, sq, d = q_shape
    return 4 * b * hq * d * attn_kept_pairs(sq, k_shape[2], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _attention_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape,
                         do_shape, causal, window, softcap, blk,
                         out_shape=None, **kwargs) -> int:
    """The five products of the backward (s, dP, dV, dK, dQ), 2 D flops a
    kept pair each: 2.5 times the forward's."""
    b, hq, s, d = q_shape
    return 10 * b * hq * d * attn_kept_pairs(s, k_shape[2], causal, window)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, bq: int = 128, bkv: int = 128, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """The forward with its row statistics, as :class:`FlashAttentionFn`
    runs it: ``(out, lse)``, lse the float32 (B, Hq, Sq) log-sum-exp that
    :func:`flash_attention_bwd` takes.  No gradient is recorded.  Blocks
    and dispatch as :func:`flash_attention`'s (the kernel on CUDA tensors,
    counted in ``flash_attention.launches``)."""
    _check(q, k, v)
    sq, skv = q.shape[2], k.shape[2]
    bq, bkv = min(bq, sq), min(bkv, skv)
    if min(sq, skv) <= 0 or sq % bq or skv % bkv:
        raise ValueError(f"blocks ({bq}, {bkv}) must divide the sequence "
                         f"lengths ({sq}, {skv})")
    with torch.no_grad():
        if plain_route(q):
            return _forward(q, k, v, bq, bkv, causal, window, softcap, True)
        return _attention_op(q, k, v, bq, bkv, causal, window, softcap, True)


def _bwd_legal(q, k, blk: int) -> None:
    """Raise unless the backward kernels take these operands at ``blk``."""
    s, d = q.shape[2], q.shape[3]
    limit = card_smem(q)
    if k.shape[2] != s:
        raise ValueError(f"the attention backward kernels do not take Sq = "
                         f"{s}, Skv = {k.shape[2]}: Sq must equal Skv")
    route = attn_bwd_route(q.dtype, blk, d)
    if route is None:
        raise ValueError(
            f"the attention backward kernels do not take block {blk} at head "
            f"dim {d} in {q.dtype}: no route does; the route table: "
            f"{attn_bwd_route_table()}")
    if not attn_bwd_tile_legal(s, blk, d, q.element_size(), limit):
        raise ValueError(
            f"the attention backward kernels do not take S = {s} at head dim "
            f"{d} and block {blk} on their {route} route: the block must "
            f"divide S, d be at most {max(KERNEL_HEAD_DIMS)} (run at the next"
            f" of {KERNEL_HEAD_DIMS}), and the staging "
            f"{attn_bwd_smem_bytes(blk, d, q.element_size())} B fit "
            f"{limit} B")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        blk: Optional[int] = None):
    """The gradient of attention: (dq, dk, dv) for the forward's operands,
    its output ``o`` and row log-sum-exp ``lse`` (float32 (B, Hq, S)) and
    the output's gradient ``do``, at Sq = Skv.

    CUDA tensors launch the three hand-written kernels of
    ``csrc/flash_attention_bwd.cu`` on the current stream (block ``blk``,
    by default :func:`attn_bwd_blocks`, on the route
    :func:`attn_bwd_route` gives it), and anything they do not take
    raises; CPU tensors run :func:`flash_attention_bwd_plain` over the
    same blocks.  ``flash_attention_bwd.launches`` counts calls that
    launched the kernels: one per backward, three kernel launches inside;
    ``flash_attention_bwd.route_launches`` splits them by route.
    """
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"o and do must be {tuple(q.shape)} and lse "
                         f"{tuple(q.shape[:3])}, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    s = q.shape[2]
    if k.shape[2] != s:
        raise ValueError(f"the attention backward takes Sq = Skv, got {s} "
                         f"and {k.shape[2]}")
    blk = attn_bwd_blocks(s, q.dtype, q.shape[3]) if blk is None \
        else blk
    if q.device.type == "cuda":
        if o.dtype != q.dtype or do.dtype != q.dtype or \
                lse.dtype != torch.float32:
            raise TypeError(f"o and do must be {q.dtype} and lse float32, "
                            f"got {o.dtype}, {do.dtype}, {lse.dtype}")
        _bwd_legal(q, k, blk)
    if plain_route(q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, softcap=softcap,
                                         bq=blk)
    return _attention_bwd_op(q, k, v, o, lse, do, causal, window, softcap,
                             blk)


flash_attention_bwd.launches = 0
#: backward launches per route (:func:`attn_bwd_route`)
flash_attention_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: the forward operator with the rows'
    log-sum-exp, and the backward operator (:func:`flash_attention_bwd`).
    A thin caller of the operators' own autograd (``_attention_setup``,
    ``_attention_backward``).  q, k and v get gradients; the block, mask
    and softcap arguments none."""

    @staticmethod
    def forward(ctx, q, k, v, bq: int, bkv: int, causal: bool, window: int,
                softcap: float):
        inputs = (q, k, v, bq, bkv, causal, window, softcap, True)
        out, lse = _forward(*inputs) if plain_route(q) else \
            _attention_op(*inputs)
        _attention_setup(ctx, inputs, (out, lse))
        return out

    @staticmethod
    def backward(ctx, dout):
        return _attention_backward(ctx, dout)[:8]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bq: int = 128, bkv: int = 128, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Attention over (B, Hq, Sq, D) queries and (B, Hkv, Skv, D) kv.

    Hq must be a multiple of Hkv (GQA); ``window > 0`` enables sliding-
    window attention; ``softcap > 0`` applies gemma2-style logit
    soft-capping.  Blocks are clamped to the sequence lengths and must
    divide them, as in the reference.  CUDA tensors launch the
    hand-written kernel on the current stream — contiguous, 16-byte
    aligned, float32 or bfloat16, blocks legal for the card — and anything
    the kernel does not take raises; CPU tensors run
    :func:`flash_attention_plain` over the same visited kv blocks; fake
    tensors only shape the output (the operator's fake implementation).
    All visit only the kv blocks of :func:`attn_kv_range`.

    When grad is enabled and an operand requires it, the call goes through
    :class:`FlashAttentionFn`, whose backward is :func:`flash_attention_bwd`
    (Sq = Skv only; on CUDA the backward kernels must take the shape, which
    is checked here); otherwise no row statistics are written and nothing
    is saved.  ``flash_attention.launches`` counts forward kernel
    launches, and ``flash_attention.route_launches`` splits them by route
    (:func:`attn_route`).
    """
    _check(q, k, v)
    sq = q.shape[2]
    skv = k.shape[2]
    bq, bkv = min(bq, sq), min(bkv, skv)
    if min(sq, skv) <= 0 or sq % bq or skv % bkv:
        raise ValueError(f"blocks ({bq}, {bkv}) must divide the sequence "
                         f"lengths ({sq}, {skv})")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        if sq != skv:
            raise ValueError(f"the attention backward takes Sq = Skv, got "
                             f"{sq} and {skv}")
        if q.device.type == "cuda":
            _bwd_legal(q, k, attn_bwd_blocks(sq, q.dtype, q.shape[3]))
        return FlashAttentionFn.apply(q, k, v, bq, bkv, causal, window,
                                      softcap)
    if plain_route(q):
        return _forward(q, k, v, bq, bkv, causal, window, softcap, False)[0]
    return _attention_op(q, k, v, bq, bkv, causal, window, softcap,
                         False)[0]


flash_attention.launches = 0
#: forward kernel launches per route (:func:`attn_route`)
flash_attention.route_launches = dict.fromkeys(ATTN_ROUTES, 0)
