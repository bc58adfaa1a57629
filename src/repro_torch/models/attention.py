"""Attention layers, the counterparts of ``repro/models/attention.py``.

The reference computes every attention call with ``chunked_attention``, an
online-softmax scan in XLA, and its docstring promises that the Pallas
flash-attention kernel replaces it 1:1.  Here that promise is kept: the
cache-free call (prefill and the training forward) goes to the
hand-written kernel, :func:`repro_torch.kernels.flash_attention`, with the
model's causal flag, the layer's window and the attention softcap; GQA is
by index, so nothing is repeated.  The decode call (a KV cache given, one
query row at an offset) stays :func:`chunked_attention` in plain PyTorch,
as the reference computes it outside any kernel; the kernel takes neither
an offset nor a one-row query.  A cached call of more than one row (the
reference's scan allows it, its models never make it) is refused.

On a CUDA tensor the kernel runs or raises (for example at a head dim above
128, or a sequence length no legal block divides); a head dim between the
instantiated ones (hubert-xlarge's 80, phi3-mini's 96) runs zero-padded
to the next.  On a CPU tensor its wrapper runs the kernel's plain
version.  ``use_kernel=False``
sends the call to that plain version on any device, to compare the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..distributed import local
from ..kernels.flash_attention import (KERNEL_BLOCKS, flash_attention,
                                       flash_attention_plain)
from .layers import apply_rope, normal, softcap

_NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      attn_softcap: float = 0.0,
                      q_offset: int = 0) -> torch.Tensor:
    """Decode attention: one query row at absolute position ``q_offset``
    against the whole KV cache, one softmax (the reference's ``sq == 1``
    path).

    q: (B, Hq, 1, D); k, v: (B, Hkv, Skv, D); GQA via head folding.  A
    prompt of more than one row goes to the kernel (:func:`attend`); the
    reference's multi-row scan is not carried over.
    """
    b, hq, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"decode attention takes one query row, got {sq}; "
                         "a prompt goes through attend() and the kernel")
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k).float() * (1.0 / d ** 0.5)
    if attn_softcap > 0.0:
        s = softcap(s, attn_softcap)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((skv,), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_offset >= k_pos
    if window > 0:
        mask &= (q_offset - k_pos) < window
    s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attn_blocks(s: int) -> int:
    """The kernel's query and kv block for a length-``s`` self-attention
    call: the largest of its blocks that divides ``s``, largest first
    (128 is phase 7's choice at head dim 128).  When none divides, ``min(
    128, s)``, which the kernel's wrapper refuses on the card with its own
    message."""
    for blk in sorted(KERNEL_BLOCKS, reverse=True):
        if blk <= s and s % blk == 0:
            return blk
    return min(max(KERNEL_BLOCKS), s)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int, attn_softcap: float,
           use_kernel: bool = True) -> torch.Tensor:
    """Self-attention over (B, H, S, D) operands without a cache: the
    flash-attention kernel (or, ``use_kernel=False``, its plain version).
    ``DTensor`` operands run it on their local shards
    (:func:`repro_torch.distributed.local.attention`)."""
    blk = attn_blocks(q.shape[2])
    kernel = flash_attention if use_kernel else flash_attention_plain

    def run(q, k, v):
        return kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                      bq=blk, bkv=blk, causal=causal, window=window,
                      softcap=attn_softcap)

    if local.is_sharded(q):
        return local.attention(run, q, k, v)
    return run(q, k, v)


class AttnParams(nn.Module):
    """wq (d_model, Hq * D), wk and wv (d_model, Hkv * D), wo (Hq * D,
    d_model): the reference's ``AttnParams`` fields, as frozen
    parameters."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 wo: torch.Tensor):
        super().__init__()
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def init_attn(cfg: ArchConfig, generator: torch.Generator, dtype,
              device: DeviceLike = None) -> AttnParams:
    """Random projections drawn from ``generator`` and moved to ``device``
    (the card unless the CPU is asked for)."""
    device = resolve_device(device)
    d, hd = cfg.d_model, cfg.head_dim_
    s = d ** -0.5

    def w(shape):
        return normal(shape, s, generator, dtype, device)

    return AttnParams(wq=w((d, cfg.n_heads * hd)),
                      wk=w((d, cfg.n_kv_heads * hd)),
                      wv=w((d, cfg.n_kv_heads * hd)),
                      wo=w((cfg.n_heads * hd, d)))


def attn_forward(cfg: ArchConfig, p: AttnParams, x: torch.Tensor, *,
                 window: int = 0, positions: Optional[torch.Tensor] = None,
                 kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 cache_index: Optional[int] = None,
                 mask_offset: Optional[int] = None, use_kernel: bool = True):
    """Self-attention with optional KV cache.

    Training/prefill: ``kv_cache=None`` — full-sequence attention through
    the kernel; the returned cache is this call's ``(k, v)`` (B, Hkv, S, D)
    after RoPE, which :func:`~repro_torch.models.prefill.prefill` keeps (the
    reference returns None and computes them again).  Decode:
    ``kv_cache=(K, V)`` of shape (B, Hkv, S_ctx, D); the current token's
    k/v are written at ring slot ``cache_index`` *in place*;
    ``mask_offset`` (default: ``cache_index``) is the highest cache slot
    considered "past"; a cached call takes one token.  Returns (output,
    cache).
    """
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = local.split_last(x @ p.wq, cfg.n_heads, hd)
    k = local.split_last(x @ p.wk, cfg.n_kv_heads, hd)
    v = local.split_last(x @ p.wv, cfg.n_kv_heads, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)
        if cache_index is not None:
            positions = positions + cache_index
    q = apply_rope(q.transpose(1, 2), positions, cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), positions, cfg.rope_theta)
    v = v.transpose(1, 2)
    if kv_cache is None:
        out = attend(q, k, v, causal=cfg.causal, window=window,
                     attn_softcap=cfg.attn_softcap, use_kernel=use_kernel)
        cache = (k, v)
    else:
        ck, cv = kv_cache
        # the reference's dynamic_update_slice clamps the start to fit
        start = min(cache_index, ck.shape[2] - s)
        cache = (ck, cv)
        off = cache_index if mask_offset is None else mask_offset
        if local.is_sharded(ck):
            if s != 1:
                raise ValueError("a sharded decode step takes one token")
            out = local.decode_attention(q, k, v, ck, cv, start, off,
                                         window, cfg.attn_softcap)
        else:
            ck[:, :, start:start + s] = k.to(ck.dtype)
            cv[:, :, start:start + s] = v.to(cv.dtype)
            out = chunked_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                    causal=True, window=window,
                                    attn_softcap=cfg.attn_softcap,
                                    q_offset=off)
    out = local.merge_last(out.transpose(1, 2))
    return out @ p.wo, cache
