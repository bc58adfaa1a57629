"""Mamba-2 (SSD) block, the counterpart of ``repro/models/mamba.py``.

The reference's docstring says that the Pallas SSD kernel replaces its
chunked scan on real hardware; here it does, and the elementwise glue
around the scan, which XLA fuses in the reference, runs as hand-written
kernels too (:mod:`repro_torch.kernels.mamba_mixer`).  Between the two
projections a call takes one of the routes :func:`mixer_route` gives:

* "mixer": :func:`repro_torch.kernels.mamba_mixer.mamba_mixer` from the
  in-projection's output to the normed output -- ``mamba_in`` (the split,
  the float32 operands, ``softplus(dt + dt_bias)``), the SSD kernel at
  ``cfg.ssm_chunk`` (clamped to the length) from the incoming state, and
  ``mamba_out`` (the D skip, the round to the model's dtype, the gated
  RMSNorm).  Under grad its backward is ``mamba_out_bwd``, the SSD
  backward (``csrc/ssd_bwd.cu``) and ``mamba_in_bwd``, which write the
  in-projection's gradient into one buffer; ``models.loss_fn`` trains an
  ``ssm``-family config such as mamba2-2.7b through it on the card,
  per-period remat re-running the forward kernels inside
  ``torch.utils.checkpoint``;
* "mixer_local": the same on the local shards of ``DTensor``s whose mesh
  splits no heads (``distributed.local.mixer``);
* "decode": a one-step decode (S = 1 with a state) on plain tensors:
  ``mamba_in`` and ``mamba_out`` around the torch recurrence;
* "composite": ``DTensor``s whose mesh splits the heads (the gated norm's
  row mean then needs a sum across head shards) and sharded decode: the
  glue in torch ops around the SSD kernel on local shards;
* "reference": ``use_kernel=False``, the composite around the kernel's
  plain scan (:func:`repro_torch.kernels.ssd.ssd_plain`) on any device:
  the port's one plain mixer, in place of the reference's
  ``_ssd_chunked``, which autograd differentiates.

On CPU tensors every kernel wrapper runs its plain version.  The kernels
take float32 SSD operands, as the reference carries the state and the
decay in float32; a bfloat16 model runs the float32 scan.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..distributed import local
from ..kernels.mamba_mixer import mamba_in, mamba_mixer, mamba_out
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


#: the mixer's routes, by :func:`mixer_route`: "mixer" (plain tensors:
#: :class:`repro_torch.kernels.mamba_mixer.MambaMixerFn`, the glue's kernels
#: around the SSD's), "mixer_local" (``DTensor``s whose mesh splits no
#: heads: the same on local shards), "decode" (a one-step decode on plain
#: tensors: the glue's forward kernels around the recurrence), "composite"
#: (``DTensor``s whose mesh splits the heads, and sharded decode: the glue
#: in torch ops around the SSD kernel on local shards, the norm's row sum
#: reduced across head shards) and "reference" (``use_kernel=False``: the
#: same composite around the plain scan)
MIXER_ROUTES = ("mixer", "mixer_local", "decode", "composite", "reference")


def mixer_route(cfg: ArchConfig, zxbcdt: torch.Tensor, decode: bool,
                use_kernel: bool) -> str:
    """The route of one :func:`mamba_forward` call (:data:`MIXER_ROUTES`)
    for the in-projection's output ``zxbcdt``: ``decode`` is a one-step
    call with a state."""
    if not use_kernel:
        return "reference"
    if local.is_sharded(zxbcdt):
        if decode or local.splits_heads(zxbcdt, cfg.ssm_heads):
            return "composite"
        return "mixer_local"
    return "decode" if decode else "mixer"


def mamba_forward(cfg: ArchConfig, p: MambaParams, x_in: torch.Tensor, *,
                  state: Optional[torch.Tensor] = None,
                  return_state: bool = False, use_kernel: bool = True):
    """x_in: (B, S, d_model).  Training/prefill: state=None.

    Decode: S==1 and ``state`` (B, H, P, N) -> O(1) recurrence step.
    Otherwise the SSD kernel scans the S steps from ``state`` (zero when
    None).  With ``return_state`` returns ``(out, new_state)``.  The route
    is :func:`mixer_route`'s, each call counted in
    ``mamba_forward.route_calls``.
    """
    S = x_in.shape[1]
    decode = S == 1 and state is not None
    zxbcdt = x_in @ p.in_proj
    route = mixer_route(cfg, zxbcdt, decode, use_kernel)
    mamba_forward.route_calls[route] += 1
    if route in ("mixer", "mixer_local"):
        y, new_state = _mixer(cfg, p, zxbcdt, state, route == "mixer_local")
    elif route == "decode":
        y, new_state = _decode(cfg, p, zxbcdt, state)
    else:
        y, new_state = _composite(cfg, p, x_in, zxbcdt, state, use_kernel)
    out = y @ p.out_proj
    if return_state:
        return out, new_state
    return out


mamba_forward.route_calls = dict.fromkeys(MIXER_ROUTES, 0)


def _mixer(cfg: ArchConfig, p: MambaParams, zxbcdt: torch.Tensor,
           state: Optional[torch.Tensor], on_shards: bool):
    """The mixer's kernels from zxbcdt to the normed output (B, S, d_inner)
    in zxbcdt's dtype, and the final state: :func:`mamba_mixer` at
    ``cfg.ssm_chunk`` (clamped to S), on local shards when ``on_shards``."""
    h0 = None if state is None else state.float().contiguous()
    kw = dict(heads=cfg.ssm_heads, groups=cfg.ssm_groups,
              state=cfg.ssm_state, chunk=cfg.ssm_chunk, want_state=True)

    def run(zxbcdt, dt_bias, a_log, d_skip, norm_g, h0=None):
        return mamba_mixer(zxbcdt, dt_bias, a_log, d_skip, norm_g, h0=h0,
                           **kw)

    args = (zxbcdt, p.dt_bias, p.a_log, p.d_skip, p.norm_g, h0)
    if on_shards:
        return local.mixer(run, cfg.ssm_heads, *args)
    return run(*args)


def _decode(cfg: ArchConfig, p: MambaParams, zxbcdt: torch.Tensor,
            state: torch.Tensor):
    """One decode step on plain tensors: :func:`mamba_in`, the recurrence
    on its float32 operands (the promotions it computed on the model's
    dtype), :func:`mamba_out`."""
    xh, dt, bg, cg = mamba_in(zxbcdt, p.dt_bias, heads=cfg.ssm_heads,
                              groups=cfg.ssm_groups, state=cfg.ssm_state)
    y, new_state = _recurrence(xh, dt, p.a_log, bg, cg, state)
    out, _ = mamba_out(y, zxbcdt, p.d_skip, p.norm_g)
    return out, new_state


def _composite(cfg: ArchConfig, p: MambaParams, x_in: torch.Tensor,
               zxbcdt: torch.Tensor, state: Optional[torch.Tensor],
               use_kernel: bool):
    """The glue in torch ops around the SSD kernel (its plain version
    without ``use_kernel``), on local shards for ``DTensor``s."""
    bsz, S, _ = x_in.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    z, xi, bb, cc, dt = _split_proj(cfg, zxbcdt)
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
    return yf.to(x_in.dtype), new_state


def init_ssm_state(cfg: ArchConfig, batch: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """A zero (B, H, P, N) float32 state on ``device`` (the card unless
    the CPU is asked for)."""
    return torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                        cfg.ssm_state), dtype=torch.float32,
                       device=resolve_device(device))
