"""The block RMSNorm as hand-written CUDA kernels, beside their plain
versions (``csrc/rmsnorm.cu``).

No Pallas body is replaced: the reference's ``rmsnorm``
(``src/repro/models/layers.py:11-16``) runs under ``jit``, where XLA fuses
the square, the row mean, ``rsqrt``, the two products and the round to the
model's dtype, and their backward.  The port runs eagerly, so its plain
version is some ten launches forward and autograd's chain backward; every
block runs it once or twice and every model once more as its final norm.
The two kernels here are that fusion:

* :func:`rmsnorm_fwd` -- ``y = round((x rstd)(1 + scale))`` with ``rstd =
  rsqrt(mean(x^2) + eps)`` in float32, and each row's ``rstd`` (float32)
  for the backward;
* :func:`rmsnorm_bwd` -- ``dx = round(rstd (g - x_hat sum(g x_hat) / d))``
  with ``x_hat = x rstd`` and ``g = dy (1 + scale)``, and scale's gradient
  ``sum_rows dy x_hat`` (float32): per-block partials over fixed groups of
  rows and a fixed-order finish, so two calls give the same bits.

x (..., d) may be a strided view whose leading dims fold into at most two
strided levels (a prefill's last-token rows); every output is contiguous.
The kernels take float32 and bfloat16, x and scale in one dtype, and rows
of at most :data:`MAX_D` elements.

Dispatch, as the Mamba mixer's (:func:`._card.card_call`): real CPU tensors
run the plain versions directly; fake tensors, and CUDA tensors while a
dispatch mode is on, go through the ``torch.library`` operators
``repro_torch::rmsnorm_fwd`` and ``repro_torch::rmsnorm_bwd``; other CUDA
tensors launch the kernels directly.  On CUDA tensors the kernels launch or
raise.  Each wrapper's ``.launches`` counts its kernel's launches, one a
call (the backward's finish included).  :class:`RmsNormFn` spans the norm
under autograd, saving x and rstd.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from ._card import card_call, plain_route

#: the dtypes the kernels take (x, scale and the outputs in one)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest row the kernels hold (the library's kMaxWidth): every
#: d_model of the configs, 1280 to 8192
MAX_D = 8192
#: the norm's epsilon (the reference's default)
EPS = 1e-6
#: row groups of the backward's column partials, at most (the library's
#: kBwdBlocks: two blocks an SM on the H100's 132)
BWD_BLOCKS = 264


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions' working dtype: float64 stays float64 (the
    gradient tests' oracle), anything else computes in float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


# ------------------------------------------------------- plain versions --

def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = EPS) -> torch.Tensor:
    """The reference's RMSNorm in torch ops: computed in float32, cast back
    to x's dtype (the models' CPU route)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def rmsnorm_fwd_plain(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y in x's dtype, rstd (x.shape[:-1]) in the working dtype): the
    kernel's plain version, :func:`rmsnorm_plain`'s operations (its bits,
    in float32 and bfloat16) with each row's ``rstd`` kept."""
    acc = _acc(x)
    xf = x.to(acc)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    y = (xf * r * (1.0 + scale.to(acc))).to(x.dtype)
    return y, r.squeeze(-1)


def rmsnorm_bwd_plain(dy: torch.Tensor, x: torch.Tensor,
                      scale: torch.Tensor, rstd: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, scale's gradient (d,) in the working dtype): the
    kernel's arithmetic in torch ops, ``dx = rstd (g - x_hat (sum(g x_hat)
    / d))`` with ``x_hat = x rstd``, ``g = dy (1 + scale)``, and ``dscale
    = sum over rows of dy x_hat``."""
    acc = _acc(x)
    d = x.shape[-1]
    r = rstd.to(acc)[..., None]
    xh = x.to(acc) * r
    dyf = dy.to(acc)
    g = dyf * (1.0 + scale.to(acc))
    mean = torch.sum(g * xh, dim=-1, keepdim=True) / d
    dx = (r * (g - xh * mean)).to(x.dtype)
    dscale = torch.sum((dyf * xh).reshape(-1, d), dim=0)
    return dx, dscale


# ------------------------------------------------------------- launches --

def _fn(name: str, argtypes):
    lib = _build.load("rmsnorm")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGS = {
    "repro_rmsnorm_fwd": [_P, _I, _L, _L, _L, _L, _I, _P, _F, _P, _P, _P],
    "repro_rmsnorm_bwd": [_P, _P, _I, _L, _L, _L, _L, _P, _I, _P, _P, _P, _P,
                          _P],
    "repro_rmsnorm_launch": [_I, _I, _I, _L, _I, _P],
}


def _launch(name: str, what: str, *args) -> None:
    """Call the C launcher ``name`` with ``args`` (tensors as their data
    pointers) on the current stream; raise on a refused launch."""
    lib, fn = _fn(name, _ARGS[name])
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args), stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def row_layout(x: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """(rows, seq, sb, ss): x's rows (every dim but the last) as (outer,
    inner) pairs at element strides sb and ss, seq inner rows an outer
    one, as the kernels address them; None when the leading dims do not
    fold into two strided levels."""
    rows = math.prod(x.shape[:-1])
    levels = []
    for n, st in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if levels and levels[-1][1] == st * n:
            levels[-1] = (levels[-1][0] * n, st)
        else:
            levels.append((n, st))
    if not levels:
        return rows, 1, 0, 0
    if len(levels) == 1:
        return rows, levels[0][0], 0, levels[0][1]
    if len(levels) == 2:
        (_, sb), (seq, ss) = levels
        return rows, seq, sb, ss
    return None


def row_groups(rows: int) -> int:
    """Row groups of the backward's partial sums for ``rows`` rows, at most
    BWD_BLOCKS: the rule of the library's ``row_groups``, which reads the
    row count alone, so two calls sum in the same order."""
    blocks = min(rows, BWD_BLOCKS)
    per = -(-rows // blocks)
    return -(-rows // per)


def launch_of(kernel: str, dtype: torch.dtype, d: int, rows: int,
              vector: bool = True) -> dict:
    """The launch ``kernel`` ("rmsnorm_fwd" or "rmsnorm_bwd") makes at width
    ``d`` over ``rows`` rows on the vector path (or the scalar one) on the
    current card: threads a block, slots a thread (chunks of 8 elements,
    or elements), warps a row, rows a block at once, blocks, blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the dynamic
    shared memory."""
    which = ("rmsnorm_fwd", "rmsnorm_bwd").index(kernel)
    lib, fn = _fn("repro_rmsnorm_launch", _ARGS["repro_rmsnorm_launch"])
    out = (ctypes.c_int * 7)()
    err = fn(which, _DTYPE_CODES[dtype], d, rows, int(vector),
             ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{kernel} launch: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    return dict(zip(("threads", "chunks", "warps", "teams", "blocks",
                     "blocks_per_sm", "smem_bytes"), out))


def _launch_fwd(x, scale, eps):
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rstd = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if y.numel():
        _launch("repro_rmsnorm_fwd", "rmsnorm_fwd", x, _DTYPE_CODES[x.dtype],
                *row_layout(x), x.shape[-1], scale, eps, y, rstd)
        rmsnorm_fwd.launches += 1
    return y, rstd


def _launch_bwd(dy, x, scale, rstd):
    d = x.shape[-1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = row_layout(x)
    if not dx.numel():
        return dx, torch.zeros((d,), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    part = torch.empty((row_groups(rows[0]), d), dtype=torch.float32,
                       device=x.device)
    _launch("repro_rmsnorm_bwd", "rmsnorm_bwd", dy, x, _DTYPE_CODES[x.dtype],
            *rows, rstd, d, scale, dx, part, dscale)
    rmsnorm_bwd.launches += 1
    return dx, dscale


# ------------------------------------------------------------ operators --
# Real CPU tensors run the plain versions (as the wrappers do); CUDA
# tensors launch the kernels; fake tensors run the fake implementations.

@torch.library.custom_op("repro_torch::rmsnorm_fwd", mutates_args=())
def _fwd_op(x: torch.Tensor, scale: torch.Tensor,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y in x's dtype, rstd float32), both contiguous."""
    if x.device.type == "cpu":
        y, rstd = rmsnorm_fwd_plain(x, scale, eps)
        return y.contiguous(), rstd.contiguous()
    return _launch_fwd(x, scale, eps)


@_fwd_op.register_fake
def _(x, scale, eps):
    return (x.new_empty(x.shape),
            x.new_empty(x.shape[:-1], dtype=_acc(x)))


@torch.library.custom_op("repro_torch::rmsnorm_bwd", mutates_args=())
def _bwd_op(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
            rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, contiguous; scale's gradient, float32)."""
    if x.device.type == "cpu":
        dx, dscale = rmsnorm_bwd_plain(dy, x, scale, rstd)
        return dx.contiguous(), dscale
    return _launch_bwd(dy, x, scale, rstd)


@_bwd_op.register_fake
def _(dy, x, scale, rstd):
    return x.new_empty(x.shape), x.new_empty(x.shape[-1:], dtype=_acc(x))


# ------------------------------------------------------------- wrappers --

def _shapes(x, scale, what: str, **more) -> None:
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or tuple(scale.shape) != (d,):
        raise ValueError(f"{what}: x {tuple(x.shape)} and scale "
                         f"{tuple(scale.shape)} disagree")
    for name, (t, shape) in more.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    devices = {t.device for t in (x, scale, *(t for t, _ in more.values()))}
    if len(devices) != 1:
        raise ValueError(f"{what} takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")


def _kernel_ready(x, scale, what: str, **same) -> None:
    """Raise unless the kernels take these tensors: x float32 or bfloat16
    with a contiguous last dim, rows that fold into two strided levels and
    at most MAX_D elements; scale and ``same`` (contiguous) in x's dtype.
    Reads no data, so a fake tensor is checked as a real one."""
    if x.dtype not in _DTYPE_CODES or x.stride(-1) != 1 or \
            row_layout(x) is None:
        raise ValueError(f"{what} takes a float32 or bfloat16 x whose last "
                         f"dim is contiguous and whose rows fold into two "
                         f"strided levels, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.shape[-1] > MAX_D:
        raise ValueError(f"{what}'s kernels hold rows of at most {MAX_D} "
                         f"elements, not {x.shape[-1]}")
    for name, t in (("scale", scale), *same.items()):
        if t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{what} takes a contiguous {name} in x's dtype "
                             f"{x.dtype}, got {t.dtype} {tuple(t.shape)}")


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = EPS, *,
                use_kernel: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RMSNorm of x (..., d) with ``scale`` (d,): ``(y, rstd)``, y
    contiguous in x's dtype, rstd (x.shape[:-1]) float32.  The kernel on
    CUDA tensors (counted in ``rmsnorm_fwd.launches``), the plain version
    on CPU tensors or with ``use_kernel=False``."""
    _shapes(x, scale, "rmsnorm_fwd")
    if not use_kernel or plain_route(x):
        return rmsnorm_fwd_plain(x, scale, eps)
    _kernel_ready(x, scale, "rmsnorm_fwd")
    return card_call(_fwd_op, _launch_fwd, x, scale, float(eps))


def rmsnorm_bwd(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                rstd: torch.Tensor, *, use_kernel: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rmsnorm_fwd`'s gradient from ``dy`` (y's, contiguous, in x's
    dtype) and the forward's ``rstd``: ``(dx, dscale)``, dx contiguous in
    x's dtype, dscale (d,) float32.  The kernel on CUDA tensors (counted
    in ``rmsnorm_bwd.launches``), the plain version on CPU tensors or with
    ``use_kernel=False``."""
    _shapes(x, scale, "rmsnorm_bwd", dy=(dy, x.shape),
            rstd=(rstd, x.shape[:-1]))
    if not use_kernel or plain_route(x):
        return rmsnorm_bwd_plain(dy, x, scale, rstd)
    _kernel_ready(x, scale, "rmsnorm_bwd", dy=dy)
    if rstd.dtype != torch.float32 or not rstd.is_contiguous():
        raise ValueError(f"rmsnorm_bwd takes a contiguous float32 rstd, got "
                         f"{rstd.dtype}")
    return card_call(_bwd_op, _launch_bwd, dy, x, scale, rstd)


rmsnorm_fwd.launches = 0
rmsnorm_bwd.launches = 0


def rmsnorm_bytes(rows: int, d: int, dtype: torch.dtype, kernel: str) -> int:
    """The bytes one call of ``kernel`` must move over ``rows`` rows of
    ``d``, each input read once and each output written once (the
    partials' scratch not counted): the forward x, scale in, y, rstd out;
    the backward dy, x, scale, rstd in, dx and dscale (float32) out."""
    item = dtype.itemsize
    if kernel == "rmsnorm_fwd":
        return rows * (2 * d * item + 4) + d * item
    if kernel == "rmsnorm_bwd":
        return rows * (3 * d * item + 4) + d * (item + 4)
    raise ValueError(kernel)


# --------------------------------------------------------- the autograd --

class RmsNormFn(torch.autograd.Function):
    """``y = rmsnorm(x, scale)`` through :func:`rmsnorm_fwd`, its gradient
    through :func:`rmsnorm_bwd`; saves x and rstd (not y).  x and scale
    get gradients in their own dtypes."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        y, rstd = rmsnorm_fwd(x, scale, eps)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(dy.contiguous(), x, scale, rstd)
        return dx, dscale.to(scale.dtype), None
