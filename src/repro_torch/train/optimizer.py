"""AdamW with the reference's arithmetic, on lists of tensors.

Not ``torch.optim.AdamW``, which rounds in another order, decays every
parameter and clips nothing: here, as in ``repro.train.optimizer``, the
gradients are clipped to a global norm computed in float32, the moments are
float32 whatever the parameter dtype, the bias corrections ``1 - b**step``
are float32, weight decay applies only to tensors of more than one
dimension (for a model, dimensions as the reference's tree has them: see
:func:`repro_torch.launch.steps.decayed`), and the update is cast to the
parameter's dtype before it is added.

Two departures, both for memory (a full-width model's float32 moments are
four times its bfloat16 parameters): :meth:`AdamW.update` updates the
moments *in place* and returns a state holding the same tensors, and
:meth:`AdamW.update_apply` also updates the parameters in place, bit for
bit ``update`` followed by :func:`apply_updates`, without the list of
updates.  On the card each tensor's update is one pass of a hand-written
kernel (``kernels/adamw.py``: the moments, then the update or the
parameter) and each gradient's squared sum one more; on the CPU the plain
version works through large tensors in slices of :data:`SLICE` elements, so
its float32 temporaries stay small.  The kernel rounds every operation as
the plain version's separate kernels do, so only the norm's summation
order differs between the two.  Everything runs under ``torch.no_grad()``.

Sharded parameters (``DTensor``s, :mod:`repro_torch.distributed`): the
moments take their parameter's placements, a gradient is first brought to
its parameter's placements (the reduction its ``Partial`` entries owe),
and the update runs on each local shard, so nothing is gathered.  The
global norm is one reduction over the mesh of the per-shard float32
squared sums, each divided by the number of ranks that hold the same
shard.  Plain tensors take the arithmetic above bit for bit.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels import adamw

#: elements the plain update works through at once (256 MB of float32)
SLICE = adamw.SLICE


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the parameters' device
    mu: List[torch.Tensor]      # first moment, float32, one per parameter
    nu: List[torch.Tensor]      # second moment, float32


class AdamW(NamedTuple):
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        params = list(params)
        zeros = [zeros_f32(p) for p in params]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=params[0].device),
            mu=zeros, nu=[torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor],
               decay: Optional[Sequence[bool]] = None, *,
               use_kernel: bool = True
               ) -> Tuple[List[torch.Tensor], AdamWState]:
        """(updates in each parameter's dtype, the new state).  The state's
        moment tensors are updated in place.  ``decay`` says which
        parameters take weight decay; by default those of more than one
        dimension (the model's train step passes the reference's leaf
        ranks, :func:`repro_torch.launch.steps.decayed`).
        ``use_kernel=False`` runs the kernels' plain versions on any
        device."""
        updates = [torch.empty_like(p) for p in params]
        state = self._step(grads, state, params, decay, updates, use_kernel)
        return updates, state

    @torch.no_grad()
    def update_apply(self, grads: Sequence[torch.Tensor], state: AdamWState,
                     params: Sequence[torch.Tensor],
                     decay: Optional[Sequence[bool]] = None, *,
                     use_kernel: bool = True) -> AdamWState:
        """:meth:`update` followed by :func:`apply_updates`, bit for bit,
        in one pass over each tensor: the moments and the parameters are
        updated in place and no update is kept; returns the new state."""
        return self._step(grads, state, params, decay, None, use_kernel)

    def _step(self, grads, state: AdamWState, params, decay,
              updates: Optional[List[torch.Tensor]],
              use_kernel: bool) -> AdamWState:
        """The moments in place, then each update into ``updates`` or, when
        that is None, added to its parameter in place."""
        if decay is None:
            decay = [p.dim() > 1 for p in params]
        grads = [_placed_like(g, p) for g, p in zip(grads, params)]
        step = state.step + 1
        scale = None
        if self.grad_clip > 0:
            gnorm = torch.sqrt(_squared_norm(grads, use_kernel))
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        stepf = _local(step).float()
        bc1 = 1 - torch.tensor(self.b1, device=stepf.device) ** stepf
        bc2 = 1 - torch.tensor(self.b2, device=stepf.device) ** stepf
        adamw.adamw_update(
            [_local(g).contiguous() for g in grads],
            [_local(m) for m in state.mu], [_local(v) for v in state.nu],
            [_local(p) for p in params],
            None if updates is None else [_local(u) for u in updates],
            scale=scale, bc1=bc1, bc2=bc2, lr=self.lr, b1=self.b1,
            b2=self.b2, eps=self.eps, weight_decay=self.weight_decay,
            decay=decay, use_kernel=use_kernel, slice_elems=SLICE)
        return AdamWState(step=step, mu=state.mu, nu=state.nu)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard (a view: writing it writes the
    ``DTensor``); a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """Float32 zeros of ``p``'s shape on its device (for a ``DTensor``,
    with its placements)."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient on its parameter's placements (a ``DTensor`` gradient's
    pending reduction done); a plain gradient itself."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor) and tuple(g.placements) != \
            tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _squared_norm(grads: Sequence[torch.Tensor],
                  use_kernel: bool = True) -> torch.Tensor:
    """The float32 sum of every gradient's squares by
    :func:`repro_torch.kernels.adamw.adamw_sqnorm` (the kernel on the card,
    the plain version on the CPU).  Plain tensors: the sums added in list
    order.  ``DTensor``s: the per-shard sums, each divided by the ranks
    that hold the same shard, added in the same order, then one all-reduce
    over the mesh (over each of its dimensions when the mesh is smaller
    than the world)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate
    sharded = [g for g in grads if isinstance(g, DTensor)]
    if not sharded:
        return adamw.adamw_sqnorm([g.contiguous() for g in grads],
                                  use_kernel=use_kernel)
    mesh = sharded[0].device_mesh

    def copies(g) -> int:
        return math.prod(n for n, pl in zip(g.device_mesh.shape,
                                            g.placements)
                         if isinstance(pl, Replicate))

    local = sum(adamw.adamw_sqnorm([_local(g).contiguous()],
                                   use_kernel=use_kernel) / copies(g)
                for g in grads)
    if mesh.size() == dist.get_world_size():       # one all-reduce
        out = funcol.all_reduce(local, "sum", dist.group.WORLD)
        return out.wait() if hasattr(out, "wait") else out
    return DTensor.from_local(local, mesh, [Partial()] * mesh.ndim
                              ).full_tensor()


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """``p + u`` for each pair, in place (the sum rounded once to the
    parameter's dtype, as the reference's add); returns ``params``."""
    for p, u in zip(params, updates):
        _local(p).add_(_local(u))
    return params
