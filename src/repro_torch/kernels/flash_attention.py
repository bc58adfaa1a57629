"""Flash attention: the hand-written Hopper kernel and its plain version.

The counterpart of ``repro/kernels/flash_attention.py``.  The kernel is
``csrc/flash_attention.cu`` (FP32 FFMA; one thread block per (batch, query
head, query block) looping over the kv blocks that hold a kept (query,
key) pair, with the online-softmax state in registers, 16-byte vector
loads from shared memory and cp.async copies of k and v that overlap the
FFMAs; its note says what bounds it and why it is built so).  One kernel
covers every flavour the reference covers: GQA by index (kv head
``h // (Hq / Hkv)``, nothing repeated), causal and sliding-window masks
with the finite ``-1e30`` sentinel, and gemma2's logit softcap.

:func:`flash_attention` dispatches on where its operands lie: CUDA tensors
launch the kernel (or raise); CPU tensors take
:func:`flash_attention_plain`, the kernel's kv-block loop in plain PyTorch
— the counterpart of Pallas ``interpret=True``.  There is no fall back
from one to the other.

The kernel skips the kv blocks a mask removes (:func:`attn_kv_range`), so
:func:`attn_grid_steps` counts the (query block, kv block) pairs it
visits.  That differs on purpose from the reference's count, which is the
TPU kernel's full grid; the two agree where no mask removes a block.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ._card import H100_SMEM_OPTIN, PROXY_BLOCKS

#: block sizes the kernel is instantiated for: bq and bkv (16 x 16 threads,
#: each owning bq/16 rows and bkv/16 logit columns) and the head dim D
#: (each thread owns D/16 accumulator columns)
KERNEL_BLOCKS: Tuple[int, ...] = (16, 32, 64, 128)
KERNEL_HEAD_DIMS: Tuple[int, ...] = (16, 32, 64, 128)
#: the reference kernel's finite mask sentinel
NEG_INF = -1e30
#: widest column chunk of the probability tile the kernel stages at once
PROB_CHUNK = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attn_smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Shared memory one block stages, in float32 (bfloat16 operands
    stage half as much for q, k and v): one q tile (bq x d), one k tile
    and one v tile (bkv x d each; the next block's k and v land in them
    while the other product runs), and the probability tile in column
    chunks of at most :data:`PROB_CHUNK`.  bq = bkv = d = 128 takes
    229,376 bytes, within the H100's opt-in limit."""
    return 4 * ((bq + 2 * bkv) * d + bq * min(bkv, PROB_CHUNK))


def attn_tile_legal(sq: int, skv: int, bq: int, bkv: int, d: int,
                    smem_limit: int = H100_SMEM_OPTIN) -> bool:
    """Can the kernel run sequence lengths ``(sq, skv)`` at head dim
    ``d`` with blocks ``(bq, bkv)``?  The blocks must divide the
    sequences, ``(bq, bkv, d)`` must be instantiated, and the staging
    must fit ``smem_limit`` — the card's opt-in shared memory per block."""
    if min(sq, skv, bq, bkv, d) <= 0 or sq % bq or skv % bkv:
        return False
    if bq not in KERNEL_BLOCKS or bkv not in KERNEL_BLOCKS or \
            d not in KERNEL_HEAD_DIMS:
        return False
    return attn_smem_bytes(bq, bkv, d) <= smem_limit


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, bkv: int, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          bq: Optional[int] = None) -> torch.Tensor:
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
    input dtype.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    if bq is None:
        blocks = [(0, sq, 0, skv // bkv)]
    else:
        blocks = [(i * bq, i * bq + bq,
                   *attn_kv_range(i, bq, bkv, skv, causal, window))
                  for i in range(sq // bq)]
    out = torch.empty_like(qf)
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
        out[..., r0:r1, :] = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def _launch(q, k, v, out, bq: int, bkv: int, causal: bool, window: int,
            softcap: float) -> None:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 +
                   [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
             hkv, sq, skv, d, bq, bkv, 1.0 / (d ** 0.5), int(causal),
             int(window), float(softcap), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed at blocks "
                           f"({bq}, {bkv}) for q {tuple(q.shape)}, kv "
                           f"{tuple(k.shape)}: {msg} (cudaError {err})")


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
    :func:`flash_attention_plain` over the same visited kv blocks.  Both
    visit only the kv blocks of :func:`attn_kv_range`.
    ``flash_attention.launches`` counts kernel launches.
    """
    _check(q, k, v)
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    bq, bkv = min(bq, sq), min(bkv, skv)
    if min(sq, skv) <= 0 or sq % bq or skv % bkv:
        raise ValueError(f"blocks ({bq}, {bkv}) must divide the sequence "
                         f"lengths ({sq}, {skv})")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bq=bq, bkv=bkv, causal=causal,
                                     window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("the flash_attention kernel takes contiguous, "
                         "16-byte aligned (B, H, S, D) operands")
    limit = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    if not attn_tile_legal(sq, skv, bq, bkv, d, limit):
        raise ValueError(
            f"blocks ({bq}, {bkv}) at head dim {d} are not legal for the "
            f"kernel: bq, bkv must be in {KERNEL_BLOCKS}, d in "
            f"{KERNEL_HEAD_DIMS}, and the staging "
            f"{attn_smem_bytes(bq, bkv, d)} B must fit {limit} B")
    out = torch.empty_like(q)
    _launch(q, k, v, out, bq, bkv, causal, window, softcap)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
