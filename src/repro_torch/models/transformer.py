"""Model assembly, the counterpart of ``repro/models/transformer.py``:
embedding -> blocks -> final norm -> tied head.

The reference stacks each pattern position's parameters over a leading
``n_periods`` dimension and scans over periods (a JAX compile-time device).
Here each layer is its own :class:`Block` in an ``nn.ModuleList``, layer
``per * len(block_pattern) + pi`` being period ``per``'s position ``pi``;
:func:`repro_torch.convert.model_params_from_reference` undoes the stacking.
Decode caches are a list over layers in the same order: ``(K, V)`` for an
attention layer, the (B, H, P, N) state for an SSM layer.

Entry points: :func:`init_params` (random frozen parameters from a
``torch.Generator``; the trainer turns their gradients on),
:func:`forward_hidden` / :func:`forward` (full sequence; attention, the
SSD scan and the block norms through the hand-written kernels;
``remat=True`` checkpoints each period, ``remat_policy="dots"`` keeping
the products' outputs),
:func:`chunked_cross_entropy` and :func:`loss_fn` (the training loss),
:func:`init_decode_state` and :func:`decode_step` (one token, KV caches
written in place).  Sharded parameters and inputs (``DTensor``s,
:mod:`repro_torch.distributed`) run the same code: the kernels on local
shards, ``act_spec`` pinning the hidden state's sharding.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig, LayerSpec
from ..distributed import local
from .attention import AttnParams, attn_forward, init_attn
from .layers import normal, rmsnorm, softcap, swiglu, token_nll
from .mamba import MambaParams, init_mamba, init_ssm_state, mamba_forward
from .moe import MoEParams, init_moe, moe_forward


def n_periods(cfg: ArchConfig) -> int:
    period = len(cfg.block_pattern)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers is not a whole number of "
                         f"{period}-layer periods")
    return cfg.n_layers // period


def _frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Mlp(nn.Module):
    """The dense SwiGLU FFN: w_gate, w_up (d_model, d_ff), w_down (d_ff,
    d_model)."""

    def __init__(self, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_frozen,
                                                  (w_gate, w_up, w_down))


class Block(nn.Module):
    """One layer: ``ln1`` and its mixer (``attn`` or ``ssm``), then, unless
    the FFN is "none", ``ln2`` and ``mlp`` and/or ``moe``."""

    def __init__(self, spec: LayerSpec, ln1: torch.Tensor, *,
                 attn: Optional[AttnParams] = None,
                 ssm: Optional[MambaParams] = None,
                 ln2: Optional[torch.Tensor] = None,
                 mlp: Optional[Mlp] = None, moe: Optional[MoEParams] = None):
        super().__init__()
        self.spec = spec
        self.ln1, self.ln2 = _frozen(ln1), _frozen(ln2)
        self.attn, self.ssm, self.mlp, self.moe = attn, ssm, mlp, moe


class Model(nn.Module):
    """The whole model: ``embed`` (vocab, d_model) for token models, or
    ``frontend_proj`` (frontend_dim, d_model) and ``head`` (d_model, vocab)
    for a modality frontend; ``blocks`` over layers; ``final_norm``.
    ``period`` is ``len(cfg.block_pattern)``: layer ``l`` is position
    ``l % period`` of its period, the reference's ``blocks/p{pi}`` leaf
    (the sharding rules read it)."""

    def __init__(self, blocks: List[Block], final_norm: torch.Tensor, *,
                 period: int, embed: Optional[torch.Tensor] = None,
                 frontend_proj: Optional[torch.Tensor] = None,
                 head: Optional[torch.Tensor] = None):
        super().__init__()
        self.period = period
        self.embed = _frozen(embed)
        self.frontend_proj, self.head = _frozen(frontend_proj), _frozen(head)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _frozen(final_norm)


# ----------------------------------------------------------------- params --

def _init_block(cfg: ArchConfig, spec: LayerSpec, generator, dtype,
                device) -> Block:
    d = cfg.d_model
    kw = {}
    if spec.mixer == "attn":
        kw["attn"] = init_attn(cfg, generator, dtype, device)
    else:
        kw["ssm"] = init_mamba(cfg, generator, dtype, device)
    if spec.ffn != "none":
        kw["ln2"] = torch.zeros((d,), dtype=dtype, device=device)
    if spec.ffn in ("dense", "moe+dense"):
        s = d ** -0.5
        kw["mlp"] = Mlp(
            w_gate=normal((d, cfg.d_ff), s, generator, dtype, device),
            w_up=normal((d, cfg.d_ff), s, generator, dtype, device),
            w_down=normal((cfg.d_ff, d), cfg.d_ff ** -0.5, generator, dtype,
                          device))
    if spec.ffn in ("moe", "moe+dense"):
        kw["moe"] = init_moe(cfg, generator, dtype, device)
    return Block(spec, torch.zeros((d,), dtype=dtype, device=device), **kw)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device: DeviceLike = None) -> Model:
    """Random parameters drawn from ``generator`` (on its own device, then
    moved to ``device``: the card unless the CPU is asked for), frozen."""
    device = resolve_device(device)
    d = cfg.d_model
    kw = {}
    if cfg.frontend == "none":
        kw["embed"] = normal((cfg.vocab, d), d ** -0.5, generator, dtype,
                             device)
    else:
        # modality frontend stub: linear projection of precomputed embeddings
        kw["frontend_proj"] = normal((cfg.frontend_dim, d),
                                     cfg.frontend_dim ** -0.5, generator,
                                     dtype, device)
        kw["head"] = normal((d, cfg.vocab), d ** -0.5, generator, dtype,
                            device)
    n_periods(cfg)
    blocks = [_init_block(cfg, spec, generator, dtype, device)
              for spec in cfg.layer_specs()]
    return Model(blocks, torch.zeros((d,), dtype=dtype, device=device),
                 period=len(cfg.block_pattern), **kw)


# ---------------------------------------------------------------- forward --

def _ffn(cfg: ArchConfig, blk: Block, x: torch.Tensor,
         route_by_position: bool = False,
         use_kernel: bool = True) -> torch.Tensor:
    """The residual FFN half of a block.  ``route_by_position`` routes the
    MoE tokens of each position (one a row) as a call of their own, as a
    decode step of the batch routes them; ``use_kernel=False`` sends the
    norm to its plain version."""
    spec = blk.spec
    if spec.ffn == "none":
        return x
    h = rmsnorm(x, blk.ln2, use_kernel=use_kernel)
    y = 0.0
    if spec.ffn in ("dense", "moe+dense"):
        y = y + swiglu(h, blk.mlp.w_gate, blk.mlp.w_up, blk.mlp.w_down)
    if spec.ffn in ("moe", "moe+dense"):
        if route_by_position:
            y = y + moe_forward(cfg, blk.moe, h.transpose(0, 1),
                                groups=h.shape[1]).transpose(0, 1)
        else:
            y = y + moe_forward(cfg, blk.moe, h)
    return x + local.like(y, x)


def _block_forward(cfg: ArchConfig, blk: Block, x: torch.Tensor, *,
                   window: int, cache=None, cache_index=None, positions=None,
                   mask_offset=None, use_kernel: bool = True,
                   route_by_position: bool = False):
    """One block; returns (x, cache): the attention layer's (K, V) — the
    updated ring with a cache given, else the call's own — or the SSM
    layer's state.  ``route_by_position`` as in :func:`_ffn`.  Sharded,
    the block's weights are all-gathered over the batch's mesh axes
    first (FSDP, :func:`repro_torch.distributed.local.gathered`)."""
    with local.gathered(blk, x):
        return _block_body(cfg, blk, x, window=window, cache=cache,
                           cache_index=cache_index, positions=positions,
                           mask_offset=mask_offset, use_kernel=use_kernel,
                           route_by_position=route_by_position)


def _block_body(cfg: ArchConfig, blk: Block, x: torch.Tensor, *,
                window: int, cache, cache_index, positions, mask_offset,
                use_kernel: bool, route_by_position: bool):
    h = rmsnorm(x, blk.ln1, use_kernel=use_kernel)
    if blk.spec.mixer == "attn":
        y, new_cache = attn_forward(cfg, blk.attn, h, window=window,
                                    positions=positions, kv_cache=cache,
                                    cache_index=cache_index,
                                    mask_offset=mask_offset,
                                    use_kernel=use_kernel)
    else:
        y, new_cache = mamba_forward(cfg, blk.ssm, h, state=cache,
                                     return_state=True,
                                     use_kernel=use_kernel)
    return _ffn(cfg, blk, x + local.like(y, x), route_by_position,
                use_kernel), new_cache


def _embed(cfg: ArchConfig, params: Model,
           inputs: torch.Tensor) -> torch.Tensor:
    if cfg.frontend == "none":
        if local.is_sharded(inputs):
            return local.embedding(params.embed, inputs)
        return params.embed[inputs]
    return inputs.to(params.frontend_proj.dtype) @ \
        local.gathered_weight(params.frontend_proj, inputs)


def _head_logits(cfg: ArchConfig, params: Model,
                 x: torch.Tensor) -> torch.Tensor:
    if cfg.frontend == "none":
        logits = x @ local.gathered_weight(params.embed, x).T
    else:
        logits = x @ local.gathered_weight(params.head, x)
    return softcap(logits, cfg.logit_softcap)


def _head(cfg: ArchConfig, params: Model, x: torch.Tensor,
          use_kernel: bool = True) -> torch.Tensor:
    return _head_logits(cfg, params, rmsnorm(
        x, local.gathered_weight(params.final_norm, x),
        use_kernel=use_kernel))


def _window(spec: LayerSpec, window_cap: int) -> int:
    window = spec.window
    if window_cap:
        window = min(window or window_cap, window_cap)
    return window


#: the products with no batch dimension: ``(B, S, d) @ (d, f)`` reaches
#: the dispatcher as ``mm``
_NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of the reference's
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep the
    output of every product with no batch dimension, recompute the rest
    (batched products, elementwise ops, the kernels' launches).  A ``bmm``
    over a batch of one is a single product: the MoE's einsum dispatch
    carries a leading group axis (1 for a training call) that the
    reference's ``"td,tec->ecd"`` and ``"ecd,tec->td"`` lack."""
    if op in _NO_BATCH_PRODUCTS or (op is torch.ops.aten.bmm.default and
                                    args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_policy(name: Optional[str]) -> Optional[Callable]:
    """The reference's ``remat_policy`` names: None and "full" recompute
    the whole period (``torch.utils.checkpoint``; no policy); "dots" keeps
    the outputs of the products with no batch dimension
    (:func:`_dots_with_no_batch_dims_saveable`).  Values do not change,
    only what the backward keeps."""
    if name is None or name == "full":
        return None
    if name == "dots":
        return _dots_with_no_batch_dims_saveable
    raise ValueError(name)


def forward_hidden(cfg: ArchConfig, params: Model, inputs: torch.Tensor, *,
                   window_cap: int = 0, use_kernel: bool = True,
                   remat: bool = False, remat_policy: Optional[str] = None,
                   act_spec=None) -> torch.Tensor:
    """Embedding + blocks + final norm -> hidden states (B, S, d).

    ``remat=True`` applies per-period activation checkpointing: each
    period of ``len(cfg.block_pattern)`` blocks runs under
    ``torch.utils.checkpoint`` (non-reentrant), so the backward keeps only
    the hidden state between periods and recomputes the blocks' insides,
    the attention kernel's forward included.  ``remat_policy`` as the
    reference's (:func:`_remat_policy`): under "dots" the backward keeps
    the outputs of the products with no batch dimension as well.

    ``act_spec`` (a :class:`repro_torch.distributed.sharding.
    NamedSharding` of the (B, S, d) hidden state; sharded parameters and
    inputs) redistributes the hidden state to it after the embedding and
    after every block, the reference's ``with_sharding_constraint``
    points: without it the propagation may keep activations replicated and
    turn the FSDP weight sharding into per-product reductions.
    """
    x = local.redistribute(_embed(cfg, params, inputs), act_spec)
    blocks = list(params.blocks)
    period = len(cfg.block_pattern)

    def run(x, group):
        for blk in group:
            x, _ = _block_forward(cfg, blk, x,
                                  window=_window(blk.spec, window_cap),
                                  use_kernel=use_kernel)
            x = local.redistribute(x, act_spec)
        return x

    kw = {}
    policy = _remat_policy(remat_policy) if remat else None
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    for start in range(0, len(blocks), period):
        group = blocks[start:start + period]
        if remat:
            x = checkpoint(run, x, group, use_reentrant=False, **kw)
        else:
            x = run(x, group)
    return rmsnorm(x, local.gathered_weight(params.final_norm, x),
                   use_kernel=use_kernel)


def forward(cfg: ArchConfig, params: Model, inputs: torch.Tensor, *,
            window_cap: int = 0, use_kernel: bool = True) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    x = forward_hidden(cfg, params, inputs, window_cap=window_cap,
                       use_kernel=use_kernel)
    return _head_logits(cfg, params, x)


def _chunk_nll(cfg: ArchConfig, params: Model, xc: torch.Tensor,
               lc: torch.Tensor) -> torch.Tensor:
    return torch.sum(token_nll(_head_logits(cfg, params, xc), lc))


def chunked_cross_entropy(cfg: ArchConfig, params: Model, x: torch.Tensor,
                          labels: torch.Tensor,
                          chunk: int = 512) -> torch.Tensor:
    """Sequence-chunked mean cross entropy of the head's logits (final
    softcap included) on hidden states ``x`` (B, S, d): each chunk's
    logits are made, reduced to the sum of ``logZ - gold`` in float32 and
    dropped, under ``torch.utils.checkpoint``, so neither pass holds the
    full (B, S, V) logits.  The chunk sums add up in order, then divide by
    B S, as the reference's scan does."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence {s}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(_chunk_nll, cfg, params,
                                   x[:, c0:c0 + chunk],
                                   labels[:, c0:c0 + chunk],
                                   use_reentrant=False)
    return total / (b * s)


def loss_fn(cfg: ArchConfig, params: Model, inputs: torch.Tensor,
            labels: torch.Tensor, *, remat_policy: Optional[str] = None,
            use_kernel: bool = True, act_spec=None) -> torch.Tensor:
    """The training loss: the forward with per-period remat, then the
    chunked cross entropy.  ``use_kernel=False`` sends attention, the
    SSD and the norms to their plain versions on any device (autograd
    differentiates them), to compare the kernels' gradients with; ``act_spec`` as
    :func:`forward_hidden`'s."""
    x = forward_hidden(cfg, params, inputs, remat=True,
                       remat_policy=remat_policy, use_kernel=use_kernel,
                       act_spec=act_spec)
    return chunked_cross_entropy(cfg, params, x, labels)


# ----------------------------------------------------------------- decode --

def init_decode_state(cfg: ArchConfig, batch: int, ctx_len: int,
                      dtype=torch.bfloat16, device: DeviceLike = None
                      ) -> list:
    """KV caches / SSM states, one entry per layer (zeros)."""
    device = resolve_device(device)
    hd = cfg.head_dim_
    caches = []
    for spec in cfg.layer_specs():
        if spec.mixer == "attn":
            ctx = ctx_len
            if cfg.long_context_kv_cap and ctx_len > cfg.long_context_kv_cap:
                ctx = cfg.long_context_kv_cap
            if spec.window:
                ctx = min(ctx, max(spec.window, 1))
            shape = (batch, cfg.n_kv_heads, ctx, hd)
            caches.append((torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device)))
        else:
            caches.append(init_ssm_state(cfg, batch, device))
    return caches


def decode_step(cfg: ArchConfig, params: Model, caches: list,
                token: torch.Tensor, index: int):
    """One decode step.  token: (B, 1) int (or (B, 1, F) frames).

    Returns (logits (B, 1, V), caches): the attention caches are updated
    in place at ring slot ``index % ctx`` and attend up to slot
    ``min(index, ctx - 1)`` (a wrapped ring attends every slot), ``index``
    being the absolute position; the SSM states are replaced.
    """
    index = int(index)
    act = local.batch_sharding(token)
    x = local.redistribute(_embed(cfg, params, token), act)
    pos = torch.tensor([index], device=x.device)
    new = []
    for blk, cache in zip(params.blocks, caches):
        kw = {}
        if blk.spec.mixer == "attn":
            ctx = cache[0].shape[2]
            kw = dict(cache_index=index % ctx, positions=pos,
                      mask_offset=min(index, ctx - 1))
        x, nc = _block_forward(cfg, blk, x, window=blk.spec.window,
                               cache=cache, **kw)
        x = local.redistribute(x, act)
        new.append(nc)
    return _head(cfg, params, x), new
