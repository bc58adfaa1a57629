"""Step functions and abstract inputs for every (arch x shape) cell, the
counterpart of ``repro/launch/steps.py``.

PyTorch runs eagerly, so a step is a plain function.  The train step is
the loss through :func:`repro_torch.models.loss_fn` (per-period remat,
chunked cross entropy; attention and the SSD through their kernels and
backwards on the card), the gradients by ``torch.autograd.grad``, then
AdamW's ``update_apply`` (its kernels on the card); the parameters and the
AdamW moments are updated in place.  The
prefill and serve steps are :func:`repro_torch.models.prefill.prefill`
and :func:`repro_torch.models.decode_step`.

Sharded steps: the same functions take ``DTensor`` parameters, state and
inputs (placed by :mod:`repro_torch.distributed.sharding`).  A step then
runs under ``implicit_replication``, so the tensors the models make
themselves (positions, masks, the rotary table) count as replicated.

:func:`abstract_params`, :func:`abstract_opt_state` and
:func:`abstract_caches` are fake tensors (``FakeTensorMode``): shapes,
dtypes and devices, no allocation; :func:`input_specs` gives each cell's
step inputs as :class:`TensorSpec` stand-ins, the reference's
``ShapeDtypeStruct``s.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

from .._device import DeviceLike
from ..configs.base import ArchConfig, ShapeSpec
from ..distributed import local
from ..models import decode_step, init_decode_state, init_params, loss_fn
from ..models.prefill import prefill
from ..train.optimizer import AdamW, AdamWState, zeros_f32

#: the dtype the launchers train full-width models in
PARAM_DTYPE = torch.bfloat16


def decayed(params) -> List[bool]:
    """Which of the model's parameters (``parameters()`` order) AdamW
    decays: those whose leaf in the reference's tree has more than one
    dimension.  The reference stacks each block's leaves over a leading
    periods axis, so every block parameter counts one dimension more
    than the port's per-layer tensor: a layer's 1-D norm scales are
    decayed there, and so here; the final norm is not."""
    return [p.dim() + name.startswith("blocks.") > 1
            for name, p in params.named_parameters()]


def _sharded_context(tensors) -> contextlib.AbstractContextManager:
    """``implicit_replication`` when any of ``tensors`` is a ``DTensor``
    (the models' own tensors then count as replicated), else nothing."""
    if any(local.is_sharded(t) for t in tensors):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _full(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s full value (a differentiable gather); a tensor
    itself."""
    return t.full_tensor() if local.is_sharded(t) else t


def make_train_step(cfg: ArchConfig, optimizer: AdamW, act_spec=None,
                    accum_steps: int = 1, remat_policy: Optional[str] = None):
    """Build the train step ``(params, opt_state, batch) -> (params,
    opt_state, loss)``.

    ``act_spec`` (a :class:`repro_torch.distributed.sharding.
    NamedSharding` of the (B, S, d) hidden state) pins the activations'
    sharding at every block boundary of a sharded step (see
    :func:`repro_torch.models.forward_hidden`); the loss comes back as a
    plain, replicated scalar.  ``accum_steps > 1`` splits the batch into
    that many micro-batches along its first axis and sums their float32
    gradients before one update, dividing activation memory by the
    factor; ``remat_policy`` as :func:`repro_torch.models.loss_fn`'s.  A
    loss that is not finite skips the update and leaves the parameters
    and state as they were (the loop's circuit breaker; the step reads
    the loss on the host for it; a traced step, whose loss is a fake
    tensor with no value, has no breaker).
    """

    def grads_of(params, batch) -> tuple:
        leaves = list(params.parameters())
        loss = _full(loss_fn(cfg, params, batch["inputs"], batch["labels"],
                             remat_policy=remat_policy, act_spec=act_spec))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step(params, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        leaves = list(params.parameters())
        with _sharded_context(leaves):
            if accum_steps == 1:
                loss, grads = grads_of(params, batch)
            else:
                micro = {k: v.reshape((accum_steps,
                                       v.shape[0] // accum_steps)
                                      + tuple(v.shape[1:]))
                         for k, v in batch.items()}
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                grads: List[torch.Tensor] = [zeros_f32(p) for p in leaves]
                for i in range(accum_steps):
                    mloss, mgrads = grads_of(
                        params, {k: v[i] for k, v in micro.items()})
                    loss = loss + mloss
                    for acc, g in zip(grads, mgrads):
                        acc.add_(g.float())
                loss = loss / accum_steps
                grads = [g / accum_steps for g in grads]
            if not is_fake(loss) and not math.isfinite(float(loss)):
                return params, opt_state, loss
            opt_state = optimizer.update_apply(grads, opt_state, leaves,
                                               decayed(params))
            del grads
        return params, opt_state, loss

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """``(params, batch) -> (last-token logits, caches)``."""

    def prefill_step(params, batch):
        with _sharded_context(params.parameters()):
            return prefill(cfg, params, batch["inputs"])

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """``(params, caches, token, index) -> (logits, caches)``: one decode
    step, the attention caches written in place."""

    def serve_step(params, caches, token, index):
        with _sharded_context(params.parameters()):
            return decode_step(cfg, params, caches, token, index)

    return serve_step


# ------------------------------------------------------------ input specs --

class TensorSpec(NamedTuple):
    """A tensor's shape and dtype: the reference's ``ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _token_spec(cfg: ArchConfig, batch: int, seq: int) -> TensorSpec:
    if cfg.frontend == "none":
        return TensorSpec((batch, seq), torch.int32)
    return TensorSpec((batch, seq, cfg.frontend_dim), PARAM_DTYPE)


def _fake_mode() -> FakeTensorMode:
    """A fake mode for the abstract trees; the tensors it makes keep their
    stated device (``cuda`` included), with no card."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def abstract_params(cfg: ArchConfig, dtype=PARAM_DTYPE,
                    device: DeviceLike = "cuda", mode=None):
    """The model of ``cfg`` as fake tensors on ``device`` under ``mode``
    (a new ``FakeTensorMode`` when None): every parameter's shape, dtype
    and device, nothing allocated."""
    mode = mode or _fake_mode()
    with mode:
        gen = torch.Generator()
        return init_params(cfg, gen, dtype, device)


def abstract_opt_state(optimizer: AdamW, params_abs, mode=None
                       ) -> AdamWState:
    """``optimizer.init`` of fake parameters, as fake tensors under
    ``mode`` (the parameters' own when None)."""
    leaves = list(params_abs.parameters())
    mode = mode or leaves[0].fake_mode
    with mode:
        return optimizer.init(leaves)


def abstract_caches(cfg: ArchConfig, batch: int, ctx: int,
                    dtype=PARAM_DTYPE, device: DeviceLike = "cuda",
                    mode=None) -> list:
    """:func:`repro_torch.models.init_decode_state` as fake tensors."""
    mode = mode or _fake_mode()
    with mode:
        return init_decode_state(cfg, batch, ctx, dtype=dtype, device=device)


def _cache_specs(cfg: ArchConfig, batch: int, ctx: int,
                 dtype=PARAM_DTYPE) -> list:
    """The shapes and dtypes of :func:`abstract_caches`' tensors."""
    mode = _fake_mode()
    caches = abstract_caches(cfg, batch, ctx, dtype, "cpu", mode)
    return [tuple(TensorSpec(tuple(t.shape), t.dtype) for t in c)
            if isinstance(c, tuple) else TensorSpec(tuple(c.shape), c.dtype)
            for c in caches]


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """:class:`TensorSpec` stand-ins for one cell's step inputs; the
    decode caches a list over layers (``(K, V)`` specs for an attention
    layer), as the port lays them out."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": {"inputs": _token_spec(cfg, b, s),
                          "labels": TensorSpec((b, s), torch.int32)}}
    if shape.kind == "prefill":
        return {"batch": {"inputs": _token_spec(cfg, b, s)}}
    if shape.kind == "decode":
        return {"caches": _cache_specs(cfg, b, s),
                "token": _token_spec(cfg, b, 1),
                "index": TensorSpec((), torch.int32)}
    raise ValueError(shape.kind)
