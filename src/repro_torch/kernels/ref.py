"""Plain PyTorch oracles for the hand-written kernels (the ``ref.py``
contract of ``repro.kernels.ref``); they run on any device."""

from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` with float32 accumulation, cast to the input dtype."""
    return torch.matmul(x.float(), y.float()).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """Dense reference attention with GQA / causal / window / softcap.

    The kv heads are repeated over their query-head groups; logits are
    formed in the input dtype, then scaled, capped and masked in float32
    (``-1e30`` where masked), and the softmax is rounded to the value
    dtype before its product with v, as in the reference.
    """
    d = q.shape[3]
    sq, skv = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr).float()
    s = s / (d ** 0.5)
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), vr)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, *,
            d_skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential (O(L)) reference for the Mamba-2 SSD recurrence.

    x: (B, L, H, P); dt: (B, L, H); a_log: (H,); b, c: (B, L, G, N).
    State h: (B, H, P, N) in float32, groups broadcast over heads
    (H % G == 0); ``d_skip`` (H,) adds the model's ``D x`` skip.
    """
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    a = -torch.exp(a_log)                                   # (H,)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(l):
        xt, dtt = x[:, t], dt[:, t]                         # (B,H,P), (B,H)
        decay = torch.exp(a[None, :] * dtt)                 # (B, H)
        bt = b[:, t].repeat_interleave(rep, dim=1)          # (B, H, N)
        ct = c[:, t].repeat_interleave(rep, dim=1)
        state = state * decay[..., None, None] + (
            (dtt[..., None] * xt)[..., :, None] * bt[..., None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ct))
    y = torch.stack(ys, dim=1)                              # (B, L, H, P)
    if d_skip is not None:
        y = y + d_skip[None, None, :, None] * x
    return y.to(x.dtype)
