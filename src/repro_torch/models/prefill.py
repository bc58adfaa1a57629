"""Prefill forward, the counterpart of ``repro/models/prefill.py``:
populate decode caches + last-token logits.

Unlike ``forward`` (training: full logits), prefill returns only the final
position's logits plus the KV caches / SSM states the decode loop continues
from.  Window-capped caches keep the last ``ctx`` positions (slot =
position % ctx when the prompt length is a multiple of every cap).  Each
attention layer's prompt attention runs through the flash-attention kernel
and each SSM layer's scan through the SSD kernel, which hands back the
final state.  The reference recomputes k and v for the cache after the
attention call; here the call's own k and v (the same values) are kept.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..configs.base import ArchConfig
from ..distributed import local
from .transformer import Model, _block_forward, _embed, _head


def _cache_ctx(cfg: ArchConfig, spec, s: int) -> int:
    """Positions an attention layer's prefill cache keeps."""
    ctx = s
    if cfg.long_context_kv_cap and s > cfg.long_context_kv_cap:
        ctx = cfg.long_context_kv_cap
    if spec.window:
        ctx = min(ctx, spec.window)
    return ctx


def prefill(cfg: ArchConfig, params: Model, inputs: torch.Tensor, *,
            use_kernel: bool = True) -> Tuple[torch.Tensor, List]:
    """Returns (last-token logits (B, 1, V), decode caches, one per
    layer).  Sharded inputs pin the hidden state to their batch sharding
    (:func:`repro_torch.distributed.local.batch_sharding`) after the
    embedding and every block."""
    act = local.batch_sharding(inputs)
    x = local.redistribute(_embed(cfg, params, inputs), act)
    s = x.shape[1]
    caches = []
    for blk in params.blocks:
        spec = blk.spec
        window = spec.window
        if spec.mixer == "attn" and cfg.long_context_kv_cap and \
                s > cfg.long_context_kv_cap:
            window = min(window or cfg.long_context_kv_cap,
                         cfg.long_context_kv_cap)
        x, cache = _block_forward(cfg, blk, x, window=window,
                                  use_kernel=use_kernel)
        x = local.redistribute(x, act)
        if spec.mixer == "attn":
            ctx = _cache_ctx(cfg, spec, s)
            # a copy, so the full-length k and v are freed
            cache = tuple(t[:, :, s - ctx:].contiguous() for t in cache)
        caches.append(cache)
    return _head(cfg, params, x[:, -1:, :], use_kernel), caches
