"""Shared neural-net layers, the counterparts of ``repro/models/layers.py``.

Plain functions on tensors.  Each computes in float32 and casts back
where the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(x w_gate) * x w_up) w_down``, every product in x's dtype."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, D); positions: (S,) or broadcastable."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    angles = positions[..., :, None].float() * freqs        # (S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's ``logZ - gold`` in float32; logits (..., V), labels
    (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())
    if isinstance(gold, DTensor):
        # over vocab-sharded logits the gather is a masked partial sum,
        # whose mask has the gather's shape: reduce it (an all-reduce)
        # before the squeeze
        gold = gold.redistribute(gold.device_mesh,
                                 [Replicate()] * gold.device_mesh.ndim)
    return logz - gold.squeeze(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level cross entropy; logits (..., V), labels (...) int."""
    return torch.mean(token_nll(logits, labels))


def normal(shape, scale: float, generator: torch.Generator, dtype,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """Parameter init: ``N(0, 1) * scale`` drawn in float32 from
    ``generator`` on its own device, then cast to ``dtype`` and moved to
    ``device`` (the generator's when None)."""
    t = torch.randn(shape, generator=generator, device=generator.device)
    return (t * scale).to(device=device, dtype=dtype)
