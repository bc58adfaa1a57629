"""Flash attention: the hand-written Hopper kernel and its plain version.

The counterpart of ``repro/kernels/flash_attention.py``.  The kernel is
``csrc/flash_attention.cu`` (FP32 FFMA; one thread block per (batch, query
head, query block) looping over every kv block with the online-softmax
state in registers; its note says what bounds it and why it is built so).
One kernel covers every flavour the reference covers: GQA by index (kv
head ``h // (Hq / Hkv)``, nothing repeated), causal and sliding-window
masks with the finite ``-1e30`` sentinel, and gemma2's logit softcap.

:func:`flash_attention` dispatches on where its operands lie: CUDA tensors
launch the kernel (or raise); CPU tensors take
:func:`flash_attention_plain`, the kernel's kv-block loop in plain PyTorch
— the counterpart of Pallas ``interpret=True``.  There is no fall back
from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _prob_stride(bkv: int) -> int:
    """Row stride of the kernel's staged probability tile (% 32 == 16)."""
    return bkv + 16 - bkv % 32


def attn_smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Shared memory one block stages, all float32: the query block
    transposed (d x (bq + 1)), one buffer that holds k transposed
    (d x (bkv + 1)) and then v (bkv x d), and the probability tile
    (bq x stride).  k and v share their buffer, which keeps bq = bkv =
    d = 128 at 205,824 bytes, within the H100's opt-in limit."""
    return 4 * (d * (bq + 1) + d * (bkv + 1) + bq * _prob_stride(bkv))


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


def attn_grid_steps(b: int, h: int, sq: int, skv: int,
                    bq: int, bkv: int) -> int:
    """(query block, kv block) steps of one attention call at blocks
    (bq, bkv): every kv block is visited, masked or not."""
    return b * h * (sq // bq) * (skv // bkv)


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
                          window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """The kernel's online-softmax loop over kv blocks in plain PyTorch.

    Vectorised over batches, query heads and every query row at once:
    the rows are independent, so the query block size changes nothing and
    only ``bkv`` (where the running max is refreshed) matters.  GQA
    broadcasts each kv head over its query-head group.  Same arithmetic
    as the kernel: float32 logits and state, ``-1e30`` masking, ``p``
    rounded to the value dtype before ``p @ v``, output
    ``acc / max(l, 1e-30)`` cast to the input dtype.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    m = torch.full((b, hkv, hq // hkv, sq, 1), NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    q_pos = torch.arange(sq, device=dev)[:, None]
    for j0 in range(0, skv, bkv):
        kb = k[:, :, None, j0:j0 + bkv].float()
        vb = v[:, :, None, j0:j0 + bkv]
        s = (qf @ kb.transpose(-1, -2)) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(j0, j0 + bkv, device=dev)[None, :]
        mask = torch.ones((sq, bkv), dtype=torch.bool, device=dev)
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
    out = acc / torch.clamp_min(l, 1e-30)
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
    hand-written kernel on the current stream — contiguous, float32 or
    bfloat16, blocks legal for the card — and anything the kernel does not
    take raises; CPU tensors run :func:`flash_attention_plain`.
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
        return flash_attention_plain(q, k, v, bkv=bkv, causal=causal,
                                     window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash_attention kernel takes contiguous "
                         "(B, H, S, D) operands")
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
