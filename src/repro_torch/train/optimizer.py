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
moments *in place* and returns a state holding the same tensors, and it
works through large tensors in slices of :data:`SLICE` elements, so its
float32 temporaries stay small.  Slicing an elementwise update changes no
value.  Everything runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

#: elements an update works through at once (256 MB of float32)
SLICE = 1 << 26


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
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=params[0].device),
            mu=zeros, nu=[torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamWState,
               params: Sequence[torch.Tensor],
               decay: Optional[Sequence[bool]] = None
               ) -> Tuple[List[torch.Tensor], AdamWState]:
        """(updates in each parameter's dtype, the new state).  The state's
        moment tensors are updated in place.  ``decay`` says which
        parameters take weight decay; by default those of more than one
        dimension (the model's train step passes the reference's leaf
        ranks, :func:`repro_torch.launch.steps.decayed`)."""
        if decay is None:
            decay = [p.dim() > 1 for p in params]
        step = state.step + 1
        if self.grad_clip > 0:
            gsq = sum(torch.sum(torch.square(g.float())) for g in grads)
            gnorm = torch.sqrt(gsq)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        else:
            scale = 1.0
        stepf = step.float()
        bc1 = 1 - torch.tensor(self.b1, device=stepf.device) ** stepf
        bc2 = 1 - torch.tensor(self.b2, device=stepf.device) ** stepf
        updates = []
        for g, m, v, p, dec in zip(grads, state.mu, state.nu, params,
                                   decay):
            u = torch.empty_like(p)
            flat = [t.reshape(-1) for t in (g, m, v, p, u)]
            for lo in range(0, p.numel(), SLICE):
                self._update_slice(*(t[lo:lo + SLICE] for t in flat),
                                   decay=dec, scale=scale, bc1=bc1, bc2=bc2)
            updates.append(u)
        return updates, AdamWState(step=step, mu=state.mu, nu=state.nu)

    def _update_slice(self, g, m, v, p, u, *, decay: bool, scale, bc1,
                      bc2) -> None:
        g = g.float() * scale
        m.copy_(self.b1 * m + (1 - self.b1) * g)
        v.copy_(self.b2 * v + (1 - self.b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
        if self.weight_decay and decay:
            upd = upd + self.weight_decay * p.float()
        u.copy_((-self.lr * upd).to(u.dtype))


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """``p + u`` for each pair, in place (the sum rounded once to the
    parameter's dtype, as the reference's add); returns ``params``."""
    for p, u in zip(params, updates):
        p.add_(u)
    return params
