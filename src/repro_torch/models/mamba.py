"""Mamba-2 (SSD) block, the counterpart of ``repro/models/mamba.py``.

The reference's docstring says that the Pallas SSD kernel replaces its
chunked scan on real hardware; here it does.  Every call with more than one
step goes to the hand-written kernel, :func:`repro_torch.kernels.ssd`, at
``cfg.ssm_chunk`` (clamped to the length), with the incoming state as its
``h0`` and its final state taken back.  The kernel takes float32 operands,
so the operands are cast to float32 first: the reference carries the state
and the decay in float32 too, and a bfloat16 model runs the float32 kernel.
The one-step decode recurrence, the D skip, the gated RMSNorm and the
projections stay in PyTorch, as they stay in XLA in the reference.

Training: the kernel scan is differentiable.  Under grad it runs
:class:`repro_torch.kernels.ssd.SsdFn`, whose backward is the hand-written
SSD backward (``csrc/ssd_bwd.cu``), so ``models.loss_fn`` trains an
``ssm``-family config such as mamba2-2.7b on the card, per-period remat
re-running the forward kernels inside ``torch.utils.checkpoint``; the
softplus, the D skip, the norm and the projections differentiate in
PyTorch.  The reference differentiates ``_ssd_chunked`` in XLA.

``use_kernel=False`` sends the scan to the kernel's plain version
(:func:`repro_torch.kernels.ssd.ssd_plain`) on any device: the port's one
plain scan, in place of the reference's ``_ssd_chunked``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..distributed import local
from ..kernels.ssd import ssd, ssd_plain
from .layers import normal


class MambaParams(nn.Module):
    """in_proj (d_model, 2 d_inner + 2 G N + H); a_log, d_skip, dt_bias
    (H,) float32; norm_g (d_inner,), the gated RMSNorm's scale; out_proj
    (d_inner, d_model): the reference's ``MambaParams`` fields, as frozen
    parameters."""

    def __init__(self, in_proj: torch.Tensor, a_log: torch.Tensor,
                 d_skip: torch.Tensor, dt_bias: torch.Tensor,
                 norm_g: torch.Tensor, out_proj: torch.Tensor):
        super().__init__()
        for name, t in (("in_proj", in_proj), ("a_log", a_log),
                        ("d_skip", d_skip), ("dt_bias", dt_bias),
                        ("norm_g", norm_g), ("out_proj", out_proj)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def init_mamba(cfg: ArchConfig, generator: torch.Generator, dtype,
               device: DeviceLike = None) -> MambaParams:
    """Random projections drawn from ``generator`` and the reference's
    constant a_log, d_skip, dt_bias and norm_g, on ``device`` (the card
    unless the CPU is asked for)."""
    device = resolve_device(device)
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    width = 2 * di + 2 * g * n + h
    f32 = dict(dtype=torch.float32, device=device)
    return MambaParams(
        in_proj=normal((d, width), d ** -0.5, generator, dtype, device),
        a_log=torch.zeros((h,), **f32),
        d_skip=torch.ones((h,), **f32),
        dt_bias=torch.full((h,), -2.0, **f32),
        norm_g=torch.zeros((di,), dtype=dtype, device=device),
        out_proj=normal((di, d), di ** -0.5, generator, dtype, device),
    )


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z, x, b, c, dt = torch.split(
        zxbcdt, [di, di, g * n, g * n, cfg.ssm_heads], dim=-1)
    return z, x, b, c, dt


def _recurrence(x, dt, a_log, b, c, state):
    """One decode step of the recurrence: x (B, 1, H, P), dt (B, 1, H)
    float32, b, c (B, 1, G, N), state (B, H, P, N) float32 -> (y (B, 1,
    H, P) float32, the new state)."""
    rep = x.shape[2] // b.shape[2]
    a = -torch.exp(a_log)
    decay = torch.exp(a[None, :] * dt[:, 0])                  # (B, H)
    b1 = b[:, 0].repeat_interleave(rep, dim=1)                # (B, H, N)
    c1 = c[:, 0].repeat_interleave(rep, dim=1)
    new_state = state * decay[..., None, None] + (
        (dt[:, 0, :, None] * x[:, 0])[..., None] * b1[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, c1.float())[:, None]
    return y, new_state


def mamba_forward(cfg: ArchConfig, p: MambaParams, x_in: torch.Tensor, *,
                  state: Optional[torch.Tensor] = None,
                  return_state: bool = False, use_kernel: bool = True):
    """x_in: (B, S, d_model).  Training/prefill: state=None.

    Decode: S==1 and ``state`` (B, H, P, N) -> O(1) recurrence step.
    Otherwise the SSD kernel scans the S steps from ``state`` (zero when
    None).  With ``return_state`` returns ``(out, new_state)``.
    """
    bsz, S, _ = x_in.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    z, xi, bb, cc, dt = _split_proj(cfg, x_in @ p.in_proj)
    xh = local.split_last(xi, h, pdim)
    bg = local.split_last(bb, g, n)
    cg = local.split_last(cc, g, n)
    dt = F.softplus(dt.float() + p.dt_bias)

    if S == 1 and state is not None:
        ops, h0, run = (xh, dt, p.a_log, bg, cg), state, _recurrence
    else:
        chunk = min(cfg.ssm_chunk, S)
        if S % chunk:
            raise ValueError(f"chunk {chunk} must divide S = {S}")
        ops = [t.float().contiguous() for t in (xh, dt, p.a_log, bg, cg)]
        h0 = None if state is None else state.float().contiguous()
        scan = ssd if use_kernel else ssd_plain

        def run(x, dt, a_log, b, c, h0=None):
            return scan(x, dt, a_log, b, c, chunk=chunk, h0=h0,
                        return_state=True)

    if local.is_sharded(xh):
        y, new_state = local.ssd(run, *ops, h0)
    else:
        y, new_state = run(*ops, h0)

    y = y + p.d_skip[None, None, :, None] * xh.float()
    y = local.merge_last(y).to(x_in.dtype)
    # gated RMSNorm (Mamba-2 norm before out_proj)
    yf = y.float() * F.silu(z.float())
    if local.is_sharded(yf):
        # sharded over the heads, the mean is a partial sum: reduced (as
        # a sum, which DTensor's backward can take) onto the block input's
        # layout, batch-sharded and replicated over the heads
        var = local.like(torch.sum(yf * yf, dim=-1, keepdim=True), x_in) \
            / yf.shape[-1]
    else:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * (1.0 + p.norm_g.float())
    out = yf.to(x_in.dtype) @ p.out_proj
    if return_state:
        return out, new_state
    return out


def init_ssm_state(cfg: ArchConfig, batch: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """A zero (B, H, P, N) float32 state on ``device`` (the card unless
    the CPU is asked for)."""
    return torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                        cfg.ssm_state), dtype=torch.float32,
                       device=resolve_device(device))
