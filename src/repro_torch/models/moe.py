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
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..distributed import local
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


def _route(logits: torch.Tensor, k: int, e: int, cap: int,
           offset: Optional[torch.Tensor] = None):
    """Top-k gates, experts and capacity positions over the token axis
    (-2) of router logits (..., t, e): (gate_vals, experts, pos, keep),
    each (..., t, k); a choice is kept while its position in its expert's
    buffer, in (token, choice) order, is below ``cap``.  ``offset`` (e,)
    counts each expert's choices that come before these tokens (a shard's
    predecessors)."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, experts = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    onehot = F.one_hot(experts, e)                          # (..., t, k, e)
    lead, t = onehot.shape[:-3], onehot.shape[-3]
    flat = onehot.reshape(*lead, t * k, e)
    before = torch.cumsum(flat, dim=-2) - flat
    if offset is not None:
        before = before + offset
    pos = (before.reshape(onehot.shape) * onehot).sum(-1)   # (..., t, k)
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
    "einsum"`` takes :func:`moe_forward_einsum`.  A ``DTensor`` x takes
    :func:`_moe_sharded`, which keeps each token on its data shard by
    construction (the reference's ``_maybe_constrain`` there).
    """
    if local.is_sharded(x):
        return _moe_sharded(cfg, p, x, capacity_factor, groups)
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


# ---------------------------------------------------------------- sharded --

def _moe_sharded(cfg: ArchConfig, p: MoEParams, x: torch.Tensor,
                 capacity_factor: Optional[float], groups: int
                 ) -> torch.Tensor:
    """The MoE on ``DTensor``s: the same function as the unsharded call
    (one routing group over every token of the call, the global capacity),
    computed on local shards (``local_map``).

    The tokens are sharded over the mesh dimensions that shard x's batch
    (the "token" dimensions).  Each rank routes its tokens; the choices
    that come before them (their experts' counts on the preceding token
    shards, all-gathered) give their global capacity positions.  Each
    rank fills its tokens' slots of the (E, C, d) expert buffer (the
    one-hot einsum, or with ``moe_impl == "scatter"`` an index scatter),
    and the buffers are summed by a reduce-scatter over each token
    dimension: along the experts where the experts are sharded over it
    (expert parallelism over a batch axis, the ``dp`` strategy), along
    the slots otherwise, so every rank runs the experts on a distinct
    part of the buffer.  The expert weights are expert-parallel where
    their dim 0 is sharded (each rank runs its experts), tensor-parallel
    where d_ff is (partial sums), gathered elsewhere.  The outputs are
    all-gathered back the way they were scattered and combined with each
    token's gates; the result is a partial sum over the expert- and
    tensor-parallel dimensions, which ``DTensor`` reduces where it is
    next used."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if groups != 1 or cfg.moe_data_shards > 1:
        raise ValueError("a sharded MoE call routes one group over all its "
                         "tokens (groups = 1, moe_data_shards = 1)")
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    mesh = x.device_mesh
    sizes = list(mesh.shape)
    tok = [isinstance(pl, Shard) and pl.dim == 0 and n > 1
           for pl, n in zip(x.placements, sizes)]
    ep = [isinstance(pl, Shard) and pl.dim == 0 and n > 1
          for pl, n in zip(p.w_gate.placements, sizes)]
    tp = [isinstance(pl, Shard) and pl.dim == 2 and n > 1 and not t
          for pl, n, t in zip(p.w_gate.placements, sizes, tok)]
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(math.ceil(capacity_factor * k * b * s / e)))
    # the buffer's slots are split over the token-only dimensions: padded
    # to a multiple of their shards with slots no choice takes (zero rows)
    n_slot = math.prod(n for n, t, x_ in zip(sizes, tok, ep) if t and not x_)
    slots = -(-cap // n_slot) * n_slot
    if any(x_ and t for x_, t in zip(ep, tok)) and \
            any(x_ and not t for x_, t in zip(ep, tok)):
        raise ValueError("experts sharded over a token dimension and over "
                         "another dimension at once")

    def pl(shard_dim, partial, other=Replicate()):
        """Placements: Shard(shard_dim) on the token dims, ``partial`` on
        the expert- and tensor-parallel ones, ``other`` elsewhere."""
        out = []
        for t, x_, y_ in zip(tok, ep, tp):
            out.append(Shard(shard_dim) if t else partial if (x_ or y_)
                       else other)
        return tuple(out)

    rep = (Replicate(),) * mesh.ndim
    x_pl, x_grad = pl(0, Replicate()), pl(0, Partial())
    w_pl = tuple(Shard(0) if x_ else Shard(wdim) if y_ else Replicate()
                 for x_, y_, wdim in zip(ep, tp, [2] * mesh.ndim))
    down_pl = tuple(Shard(1) if isinstance(pl_, Shard) and pl_.dim == 2
                    else pl_ for pl_ in w_pl)
    w_grad = tuple(Partial() if t and not x_ else pl_
                   for t, x_, pl_ in zip(tok, ep, w_pl))
    down_grad = tuple(Partial() if t and not x_ else pl_
                      for t, x_, pl_ in zip(tok, ep, down_pl))
    router_grad = tuple(Partial() if (t or x_ or y_) else Replicate()
                        for t, x_, y_ in zip(tok, ep, tp))
    out_pl = pl(0, Partial())

    def run(x, router, w_gate, w_up, w_down):
        return _moe_local(cfg, mesh, tok, ep, x, router, w_gate, w_up,
                          w_down, cap, slots)

    fn = local_map(run, out_placements=(out_pl,),
                   in_placements=(x_pl, rep, w_pl, w_pl, down_pl),
                   in_grad_placements=(x_grad, router_grad, w_grad, w_grad,
                                       down_grad),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, p.router, p.w_gate, p.w_up, p.w_down)


def _moe_local(cfg: ArchConfig, mesh, tok: List[bool], ep: List[bool], x,
               router, w_gate, w_up, w_down, cap: int,
               slots: int) -> torch.Tensor:
    """One rank's part of :func:`_moe_sharded`: x its (b, s, d) token
    shard, the weights its shards (experts ``w_gate.shape[0]`` of the
    ``cfg.n_experts``); ``cap`` the capacity, ``slots`` >= ``cap`` the
    buffer's slots an expert."""
    import torch.distributed._functional_collectives as funcol
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(b * s, d)
    coord = mesh.get_coordinate()
    logits = xt @ router
    # global positions: each expert's choices on the preceding token shards
    counts = F.one_hot(torch.topk(torch.softmax(logits.float(), -1), k,
                                  dim=-1)[1], e).sum((0, 1))[None]
    shard, stride = 0, 1
    for dim in reversed(range(mesh.ndim)):
        if tok[dim]:
            counts = funcol.all_gather_tensor(counts, 0, (mesh, dim))
            shard += coord[dim] * stride
            stride *= mesh.shape[dim]
    offset = counts[:shard].sum(0)
    gate_vals, experts, pos, keep = _route(logits, k, e, cap, offset)
    if cfg.moe_impl == "einsum":
        dispatch = (F.one_hot(experts, e).to(x.dtype)[..., None] *
                    F.one_hot(torch.clamp_max(pos, slots), slots + 1)
                    [..., None, :slots].to(x.dtype))
        dispatch = dispatch * keep[..., None, None].to(x.dtype)
        combine = (dispatch * gate_vals[..., None, None].to(x.dtype)).sum(1)
        xe = torch.einsum("td,tec->ecd", xt, dispatch.sum(1))
    else:
        slot = torch.where(keep, experts * slots + torch.clamp_max(
            pos, cap - 1), e * slots).reshape(-1)
        src = xt[:, None, :].expand(b * s, k, d).reshape(-1, d)
        buf = torch.zeros((e * slots + 1, d), dtype=x.dtype,
                          device=x.device)
        buf = buf.index_put((slot,), src)
        xe = buf[:e * slots].reshape(e, slots, d)
    # sum the buffers: along e over a token dim the experts shard, along
    # the slots over the other token dims; keep this rank's experts
    e_lo = 0
    for dim in range(mesh.ndim):
        if tok[dim]:
            xe = funcol.reduce_scatter_tensor_autograd(
                xe, "sum", 0 if ep[dim] else 1, (mesh, dim))
        elif ep[dim]:
            n_e = xe.shape[0] // mesh.shape[dim]
            e_lo += coord[dim] * n_e
            xe = xe.narrow(0, coord[dim] * n_e, n_e)
    g = torch.einsum("ecd,edf->ecf", xe, w_gate)
    u = torch.einsum("ecd,edf->ecf", xe, w_up)
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * u, w_down)
    for dim in reversed(range(mesh.ndim)):
        if tok[dim]:
            ye = funcol.all_gather_tensor_autograd(
                ye, 0 if ep[dim] else 1, (mesh, dim))
    # ye: every slot of the experts this rank ran (all of them unless an
    # expert-parallel dimension carries no tokens)
    if cfg.moe_impl == "einsum":
        y = torch.einsum("ecd,tec->td", ye,
                         combine[:, e_lo:e_lo + ye.shape[0]])
    else:
        full = ye.new_zeros((e, slots, d))
        full[e_lo:e_lo + ye.shape[0]] = ye
        ye_flat = torch.cat([full.reshape(e * slots, d),
                             ye.new_zeros((1, d))], dim=0)
        y_tok = ye_flat[slot].reshape(b * s, k, d)
        w = (gate_vals * keep).to(y_tok.dtype)
        y = torch.einsum("tkd,tk->td", y_tok, w)
    return y.reshape(b, s, d)
