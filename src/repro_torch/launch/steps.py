"""The train step (the reference's ``make_train_step`` without
``act_spec``, which belongs to the distributed slice).

PyTorch runs eagerly, so the step is a plain function: the loss through
:func:`repro_torch.models.loss_fn` (per-period remat, chunked cross
entropy; attention through the flash-attention kernel and its backward on
the card), the gradients by ``torch.autograd.grad``, then AdamW.  The
parameters and the AdamW moments are updated in place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..configs.base import ArchConfig
from ..models import loss_fn
from ..train.optimizer import AdamW, AdamWState, apply_updates

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


def make_train_step(cfg: ArchConfig, optimizer: AdamW, accum_steps: int = 1,
                    remat_policy: Optional[str] = None):
    """Build the train step ``(params, opt_state, batch) -> (params,
    opt_state, loss)``.

    ``accum_steps > 1`` splits the batch into that many micro-batches
    along its first axis and sums their float32 gradients before one
    update, dividing activation memory by the factor; ``remat_policy`` as
    :func:`repro_torch.models.loss_fn`'s.  A loss that is not finite skips
    the update and leaves the parameters and state as they were (the
    loop's circuit breaker; the step reads the loss on the host for it).
    """

    def grads_of(params, batch) -> tuple:
        leaves = list(params.parameters())
        loss = loss_fn(cfg, params, batch["inputs"], batch["labels"],
                       remat_policy=remat_policy)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step(params, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        leaves = list(params.parameters())
        if accum_steps == 1:
            loss, grads = grads_of(params, batch)
        else:
            micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads: List[torch.Tensor] = [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
            for i in range(accum_steps):
                mloss, mgrads = grads_of(params,
                                         {k: v[i] for k, v in micro.items()})
                loss = loss + mloss
                for acc, g in zip(grads, mgrads):
                    acc.add_(g.float())
            loss = loss / accum_steps
            grads = [g / accum_steps for g in grads]
        if not math.isfinite(float(loss)):
            return params, opt_state, loss
        updates, opt_state = optimizer.update(grads, opt_state, leaves,
                                              decayed(params))
        del grads
        apply_updates(leaves, updates)
        return params, opt_state, loss

    return train_step
