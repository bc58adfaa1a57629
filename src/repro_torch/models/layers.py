"""Shared neural-net layers, the counterparts of ``repro/models/layers.py``.

Plain functions on tensors.  Each computes in float32 and casts back
where the reference does.  The block RMSNorm runs on the card as the
hand-written kernels of :mod:`repro_torch.kernels.rmsnorm`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from ..distributed import local
from ..kernels._card import plain_route
from ..kernels.rmsnorm import RmsNormFn, rmsnorm_fwd, rmsnorm_plain


#: the block norm's routes, by :func:`norm_route`: "plain" (real CPU
#: tensors, ``DTensor``s of them too: the plain version, its operations and
#: its autograd graph as before the kernels), "kernel" (CUDA and fake
#: tensors: the hand-written kernels, through
#: :class:`repro_torch.kernels.rmsnorm.RmsNormFn` under grad), "local"
#: (``DTensor``s of CUDA or fake tensors: the same on local shards,
#: ``distributed.local.rmsnorm``) and "reference" (``use_kernel=False``:
#: the plain version on any device)
NORM_ROUTES = ("plain", "kernel", "local", "reference")


def norm_route(x: torch.Tensor, use_kernel: bool) -> str:
    """The route of one :func:`rmsnorm` call on ``x`` (:data:`NORM_ROUTES`)."""
    if not use_kernel:
        return "reference"
    if plain_route(x):
        return "plain"
    return "local" if local.is_sharded(x) else "kernel"


def _norm_on_tensor(x: torch.Tensor, scale: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """The kernels' route on a plain (or local) tensor: :class:`RmsNormFn`
    when a gradient is wanted, the forward kernel alone otherwise."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RmsNormFn.apply(x, scale, eps)
    return rmsnorm_fwd(x, scale, eps)[0]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
            use_kernel: bool = True) -> torch.Tensor:
    """``(x / rms(x)) (1 + scale)`` in float32, cast back to x's dtype, by
    :func:`norm_route`'s route, each call counted in
    ``rmsnorm.route_calls``."""
    route = norm_route(x, use_kernel)
    rmsnorm.route_calls[route] += 1
    if route == "local":
        return local.rmsnorm(functools.partial(_norm_on_tensor, eps=eps), x,
                             scale)
    if route == "kernel":
        return _norm_on_tensor(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)


rmsnorm.route_calls = dict.fromkeys(NORM_ROUTES, 0)


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
