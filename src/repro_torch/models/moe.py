"""Mixture-of-Experts FFN, the counterpart of ``repro/models/moe.py``.

Top-k routing with capacity-based dispatch: router -> top-k -> each
(token, choice) takes a slot in its expert's capacity buffer, tokens past
the capacity are dropped (they fall through the residual connection).  The
reference has no Pallas kernel here, so this is plain PyTorch.  Of the
reference's two definitions named ``moe_forward_einsum`` the second, the
one-hot dispatch/combine version, is the effective one and is the one
ported; the first is shadowed and never runs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from .layers import normal


class MoEParams(nn.Module):
    """router (d_model, E); w_gate, w_up (E, d_model, d_ff); w_down (E,
    d_ff, d_model): the reference's ``MoEParams`` fields, as frozen
    parameters."""

    def __init__(self, router: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor):
        super().__init__()
        for name, t in (("router", router), ("w_gate", w_gate),
                        ("w_up", w_up), ("w_down", w_down)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def init_moe(cfg: ArchConfig, generator: torch.Generator, dtype,
             device: DeviceLike = None) -> MoEParams:
    """Random router and expert weights drawn from ``generator`` and moved
    to ``device`` (the card unless the CPU is asked for)."""
    device = resolve_device(device)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = d ** -0.5
    return MoEParams(
        router=normal((d, e), s, generator, dtype, device),
        w_gate=normal((e, d, f), s, generator, dtype, device),
        w_up=normal((e, d, f), s, generator, dtype, device),
        w_down=normal((e, f, d), f ** -0.5, generator, dtype, device),
    )


def _route(logits: torch.Tensor, k: int, e: int, cap: int):
    """Top-k gates, experts and capacity positions over the token axis
    (-2) of router logits (..., t, e): (gate_vals, experts, pos, keep),
    each (..., t, k); a choice is kept while its position in its expert's
    buffer, in (token, choice) order, is below ``cap``."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, experts = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    onehot = F.one_hot(experts, e)                          # (..., t, k, e)
    lead, t = onehot.shape[:-3], onehot.shape[-3]
    flat = onehot.reshape(*lead, t * k, e)
    pos = (torch.cumsum(flat, dim=-2) - flat).reshape(onehot.shape)
    pos = (pos * onehot).sum(-1)                            # (..., t, k)
    return gate_vals, experts, pos, pos < cap


def moe_forward(cfg: ArchConfig, p: MoEParams, x: torch.Tensor,
                capacity_factor: float = None,
                groups: int = 1) -> torch.Tensor:
    """Default MoE forward: shard-local scatter dispatch.

    Tokens are viewed as (D, t_local, d) with D = ``cfg.moe_data_shards``;
    routing, capacity positions and the dispatch scatter are local to a
    shard (pure reshape semantics, as in the reference).  ``groups`` > 1
    routes each of that many runs of consecutive tokens as a call of its
    own would, each split into its own shards.  ``cfg.moe_impl ==
    "einsum"`` takes :func:`moe_forward_einsum`.
    """
    if cfg.moe_impl == "einsum":
        return moe_forward_einsum(cfg, p, x, capacity_factor, groups)
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    D = max(1, cfg.moe_data_shards)
    if t // groups % D:
        D = 1
    D *= groups
    tl = t // D
    xt = x.reshape(D, tl, d)
    cap = max(1, int(math.ceil(capacity_factor * k * tl / e)))
    gate_vals, experts, pos, keep = _route(xt @ p.router, k, e, cap)
    slot = experts * cap + torch.clamp_max(pos, cap - 1)
    slot = torch.where(keep, slot, e * cap).reshape(D, tl * k)

    rows = torch.arange(D, device=x.device)[:, None]
    src = xt[:, :, None, :].expand(D, tl, k, d).reshape(D, tl * k, d)
    buf = torch.zeros((D, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[rows, slot] = src                 # dropped choices land in row e*cap
    xe = buf[:, :e * cap].reshape(D, e, cap, d)

    g = torch.einsum("Decd,edf->Decf", xe, p.w_gate)
    u = torch.einsum("Decd,edf->Decf", xe, p.w_up)
    ye = torch.einsum("Decf,efd->Decd", F.silu(g) * u, p.w_down)

    ye_flat = torch.cat([ye.reshape(D, e * cap, d),
                         ye.new_zeros((D, 1, d))], dim=1)
    y_tok = ye_flat[rows, slot].reshape(D, tl, k, d)
    w = (gate_vals * keep).to(y_tok.dtype)
    yt = torch.einsum("Dtkd,Dtk->Dtd", y_tok, w)
    return yt.reshape(b, s, d)


def moe_forward_einsum(cfg: ArchConfig, p: MoEParams, x: torch.Tensor,
                       capacity_factor: float = None,
                       groups: int = 1) -> torch.Tensor:
    """Classic one-hot dispatch/combine einsum MoE (baseline); ``groups``
    as in :func:`moe_forward`."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    tg = t // groups
    xt = x.reshape(groups, tg, d)
    capacity = max(1, int(math.ceil(capacity_factor * k * tg / e)))
    gate_vals, experts, pos, keep = _route(xt @ p.router, k, e, capacity)

    # dispatch tensor: (G, t, k, e, c) one-hot -> combine weights
    dispatch = (F.one_hot(experts, e).to(x.dtype)[..., None] *
                F.one_hot(torch.clamp_max(pos, capacity), capacity + 1)
                [..., None, :capacity].to(x.dtype))
    dispatch = dispatch * keep[..., None, None].to(x.dtype)
    combine = dispatch * gate_vals[..., None, None].to(x.dtype)
    dispatch = dispatch.sum(dim=2)                          # (G, t, e, c)
    combine = combine.sum(dim=2)                            # (G, t, e, c)

    xe = torch.einsum("Gtd,Gtec->Gecd", xt, dispatch)       # (G, e, c, d)
    g = torch.einsum("Gecd,edf->Gecf", xe, p.w_gate)
    u = torch.einsum("Gecd,edf->Gecf", xe, p.w_up)
    ye = torch.einsum("Gecf,efd->Gecd", F.silu(g) * u, p.w_down)
    yt = torch.einsum("Gecd,Gtec->Gtd", ye, combine)
    return yt.reshape(b, s, d)


def aux_load_balance_loss(logits: torch.Tensor, experts: torch.Tensor,
                          e: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    probs = torch.softmax(logits.float(), dim=-1)
    density = F.one_hot(experts[..., 0], e).float().mean(dim=0)
    density_proxy = probs.mean(dim=0)
    return e * torch.sum(density * density_proxy)
