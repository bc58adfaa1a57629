"""The Mamba-2 mixer's elementwise glue as hand-written CUDA kernels, beside
their plain versions (``csrc/mamba_mixer.cu``).

No Pallas body is replaced: the reference's ``mamba_forward``
(``src/repro/models/mamba.py:95-137``) runs under ``jit``, where XLA fuses
everything between the in- and out-projections -- the split of ``zxbcdt``,
``softplus(dt + dt_bias)``, the D skip, the round to the model's dtype and
the gated RMSNorm -- and their backwards.  The port runs eagerly, so its
plain version is some 22 elementwise launches a layer forward and 35
backward; the four kernels here are that fusion:

* :func:`mamba_in` -- the rows of ``zxbcdt`` (B, S, W), ``W = 2 d_inner +
  2 G N + H``, read in place: x as float32 (B, S, H, P), b and c (B, S, G,
  N), dt = softplus(dt + dt_bias) (B, S, H): the SSD kernel's operands;
* :func:`mamba_out` -- ``y + d_skip x`` rounded to the model's dtype, times
  ``silu(z)``, RMS-normalised and scaled by ``1 + norm_g``: the mixer's
  output in the model's dtype, and each row's ``rsqrt`` (B, S) for the
  backward;
* :func:`mamba_out_bwd` -- that chain's gradient: y's (float32, for the SSD
  backward), z's into the z columns of ``zxbcdt``'s gradient buffer, and
  norm_g's and d_skip's (float32);
* :func:`mamba_in_bwd` -- the rest of the buffer from the SSD backward's
  dx, db, dc and ddt (x's column gets the D skip's term too), and
  dt_bias's gradient (float32).

Every sum over tokens is a per-block partial and a fixed-order finish, so
two calls give the same bits.  The rounding points are the plain
version's (the composite ``mamba_forward`` ran before this module), up to
one difference: the x columns' gradient is ``round(dx + d_skip dy)``,
where autograd added two gradients already rounded to the model's dtype.

:class:`MambaMixerFn` spans ``zxbcdt -> normed output``: its forward is
:func:`mamba_in`, the SSD forward operator (``kernels.ssd._ssd_op``, its
scratches kept) and :func:`mamba_out`; its backward
:func:`mamba_out_bwd`, :func:`repro_torch.kernels.ssd.ssd_bwd` and
:func:`mamba_in_bwd`, which fill one gradient buffer between them.

Dispatch: real CPU tensors run the plain versions directly; fake tensors,
and CUDA tensors while a dispatch mode is on, go through the
``torch.library`` operators ``repro_torch::mamba_in``, ``mamba_out``,
``mamba_out_bwd`` and ``mamba_in_bwd`` (their fake implementations shape
the outputs); other CUDA tensors launch the kernels directly, sparing a
host-bound decode step the operators' dispatch.  On CUDA tensors the
kernels launch or raise.  Each wrapper's ``.launches`` counts
its kernel's launches, one a call (the backwards' finishes included).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._card import card_call, card_smem, plain_route
from .ssd import (_plain_parts, _ssd_op, ssd_bwd, ssd_bwd_legal,
                  ssd_route_table, ssd_tile_legal)

#: the dtypes the kernels take: the model's (activations) and the
#: per-head / per-channel vectors'
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the widest row (d_inner) the row kernels hold: 1024 threads of 8
#: elements (jamba-v0.1-52b's 8192)
MAX_D_INNER = 8192
#: the norm's epsilon and softplus's threshold (torch's default)
EPS = 1e-6
THRESHOLD = 20.0


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions' working dtype: float64 stays float64 (the
    gradient tests' oracle), anything else computes in float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _copy(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous copy of ``t`` in ``dtype`` (never a view of ``t``)."""
    return t.to(dtype, memory_format=torch.contiguous_format, copy=True)


def split_widths(zxbcdt: torch.Tensor, heads: int, groups: int,
                 state: int) -> Tuple[int, int]:
    """(d_inner, P) of a (B, S, 2 d_inner + 2 G N + H) projection."""
    di2 = zxbcdt.shape[-1] - 2 * groups * state - heads
    if di2 <= 0 or di2 % 2 or (di2 // 2) % heads:
        raise ValueError(f"zxbcdt's width {zxbcdt.shape[-1]} does not split "
                         f"into 2 d_inner + 2 G N + H with H = {heads}, G = "
                         f"{groups}, N = {state}")
    return di2 // 2, di2 // 2 // heads


# ------------------------------------------------------- plain versions --

def mamba_in_plain(zxbcdt: torch.Tensor, dt_bias: torch.Tensor, *,
                   heads: int, groups: int, state: int):
    """(x (B, S, H, P), dt (B, S, H), b, c (B, S, G, N)) in the working
    dtype, contiguous: the split of ``zxbcdt`` and ``softplus(dt +
    dt_bias)``, as the composite ``mamba_forward`` computes them."""
    acc = _acc(zxbcdt)
    di, p = split_widths(zxbcdt, heads, groups, state)
    gn = groups * state
    _, x, b, c, dt = torch.split(zxbcdt, [di, di, gn, gn, heads], dim=-1)
    bsz, s = zxbcdt.shape[:2]
    xh = _copy(x, acc).view(bsz, s, heads, p)
    bg = _copy(b, acc).view(bsz, s, groups, state)
    cg = _copy(c, acc).view(bsz, s, groups, state)
    dt = F.softplus(dt.to(acc) + dt_bias.to(acc)).contiguous()
    return xh, dt, bg, cg


def mamba_out_plain(y: torch.Tensor, zxbcdt: torch.Tensor,
                    d_skip: torch.Tensor, norm_g: torch.Tensor, *,
                    acc: Optional[torch.dtype] = None):
    """(out (B, S, d_inner) in zxbcdt's dtype, r (B, S) in the working
    dtype): ``y_t = round(y + d_skip x)``, ``u = y_t silu(z)``, ``r =
    rsqrt(mean(u^2) + 1e-6)``, ``out = round((u r)(1 + norm_g))``, with
    y (B, S, H, P) the SSD's output.  ``acc`` (float64: the parameter
    gradients' oracle) is the working dtype after the first round, which
    is taken from float32 as the kernel takes it."""
    work = _acc(zxbcdt)
    acc = acc or work
    bsz, s, heads, p = y.shape
    di = heads * p
    z, x = zxbcdt[..., :di], zxbcdt[..., di:2 * di]
    yp = y.to(work) + d_skip.to(work)[None, None, :, None] * \
        x.reshape(bsz, s, heads, p).to(work)
    yt = yp.reshape(bsz, s, di).to(zxbcdt.dtype)
    u = yt.to(acc) * F.silu(z.to(acc))
    var = torch.mean(u * u, dim=-1, keepdim=True)
    r = torch.rsqrt(var + EPS)
    out = (u * r * (1.0 + norm_g.to(acc))).to(zxbcdt.dtype)
    return out, r[..., 0]


def mamba_out_bwd_plain(d_out: torch.Tensor, y: torch.Tensor,
                        zxbcdt: torch.Tensor, r: torch.Tensor,
                        d_skip: torch.Tensor, norm_g: torch.Tensor,
                        grad: torch.Tensor, *,
                        acc: Optional[torch.dtype] = None):
    """The gradient of :func:`mamba_out_plain` at its rounding points:
    writes z's gradient into ``grad[..., :d_inner]`` (zxbcdt's dtype) and
    returns (dy (B, S, H, P), d_norm_g (d_inner,), d_skip's (H,)) in the
    working dtype ``acc`` (as :func:`mamba_out_plain`'s), dy being
    ``round(dy_t)`` (the gradient through the round trip to the model's
    dtype)."""
    work = _acc(zxbcdt)
    acc = acc or work
    bsz, s, heads, p = y.shape
    di = heads * p
    dt_ = zxbcdt.dtype
    z, x = zxbcdt[..., :di].to(acc), \
        zxbcdt[..., di:2 * di].reshape(bsz, s, heads, p).to(acc)
    yp = y.to(work) + d_skip.to(work)[None, None, :, None] * x.to(work)
    yt = yp.reshape(bsz, s, di).to(dt_).to(acc)
    sig = torch.sigmoid(z)
    sz = z * sig
    u = yt * sz
    r = r.to(acc)[..., None]
    w = 1.0 + norm_g.to(acc)
    dof = d_out.to(acc)
    a = dof * w
    dr = torch.sum(a * u, dim=-1, keepdim=True)
    dvar = -0.5 * dr * r ** 3
    du = a * r + 2.0 * u * dvar / di
    dy = (du * sz).to(dt_).to(acc)
    dz = du * yt * sig * (1.0 + z * (1.0 - sig))
    grad[..., :di] = dz.to(grad.dtype)
    d_norm_g = torch.sum(dof * (u * r), dim=(0, 1))
    dy = dy.reshape(bsz, s, heads, p)
    d_skip_grad = torch.sum(dy * x, dim=(0, 1, 3))
    return dy.contiguous(), d_norm_g, d_skip_grad


def mamba_in_bwd_plain(dx: torch.Tensor, db: torch.Tensor, dc: torch.Tensor,
                       ddt: torch.Tensor, dy: torch.Tensor,
                       zxbcdt: torch.Tensor, dt_bias: torch.Tensor,
                       d_skip: torch.Tensor, grad: torch.Tensor, *,
                       acc: Optional[torch.dtype] = None) -> torch.Tensor:
    """Writes the x, b, c and dt columns of ``grad`` (zxbcdt's gradient,
    in its dtype): ``round(dx + d_skip dy)``, ``round(db)``,
    ``round(dc)``, ``round(ddt sigmoid(dt + dt_bias))`` (``ddt`` above
    softplus's threshold); returns dt_bias's gradient (H,) in the working
    dtype ``acc``."""
    acc = acc or _acc(zxbcdt)
    bsz, s, heads, p = dx.shape
    di, gn = heads * p, db.shape[2] * db.shape[3]
    xg = dx.to(acc) + d_skip.to(acc)[None, None, :, None] * dy.to(acc)
    v = zxbcdt[..., 2 * di + 2 * gn:].to(acc) + dt_bias.to(acc)
    g = ddt.to(acc)
    e = torch.exp(v)
    gdt = torch.where(v > THRESHOLD, g, g * e / (e + 1.0))
    grad[..., di:2 * di] = xg.reshape(bsz, s, di).to(grad.dtype)
    grad[..., 2 * di:2 * di + gn] = db.reshape(bsz, s, gn).to(grad.dtype)
    grad[..., 2 * di + gn:2 * di + 2 * gn] = \
        dc.reshape(bsz, s, gn).to(grad.dtype)
    grad[..., 2 * di + 2 * gn:] = gdt.to(grad.dtype)
    return torch.sum(gdt, dim=(0, 1))


# ------------------------------------------------------------- launches --

def _fn(name: str, argtypes):
    lib = _build.load("mamba_mixer")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = {
    "repro_mamba_in": [_P, _I, _L, _L, _L, _L, _I, _I, _I, _P, _I, _P, _P,
                       _P, _P, _P],
    "repro_mamba_out": [_P, _P, _I, _L, _L, _L, _L, _I, _I, _P, _I, _P, _I,
                        _P, _P, _P],
    "repro_mamba_out_bwd": [_P, _P, _P, _I, _L, _L, _L, _L, _P, _I, _I, _I,
                            _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "repro_mamba_in_bwd": [_P, _P, _P, _P, _P, _P, _I, _L, _L, _L, _L, _I,
                           _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P],
    "repro_mamba_bwd_occupancy": [_I, _I, _I, _P],
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


def _rows(zxbcdt: torch.Tensor):
    """(rows, seq, stride_b, stride_s) of zxbcdt's token rows."""
    bsz, s = zxbcdt.shape[:2]
    return bsz * s, s, zxbcdt.stride(0), zxbcdt.stride(1)


#: row groups of the backwards' partial sums, at most (the library's
#: kOutBwdBlocks and kInBwdBlocks): mamba_out_bwd's (d_inner wide, a
#: block a group, one wave of one block an SM on the H100's 132) and
#: mamba_in_bwd's dt columns' (H wide, the launch's first blocks)
OUT_BWD_BLOCKS = 128
IN_BWD_BLOCKS = 128


def partial_blocks(rows: int, most: int = OUT_BWD_BLOCKS) -> int:
    """Row groups of a backward's partial sums for ``rows`` tokens, at most
    ``most``: the rule of the library's ``row_groups``, which reads the row
    count alone, so two calls sum in the same order."""
    blocks = min(rows, most)
    per = -(-rows // blocks)
    return -(-rows // per)


def bwd_occupancy(kernel: str, dtype: torch.dtype, d_inner: int) -> dict:
    """The launch a backward's vector path makes at ``d_inner`` on the
    current card: ``{"blocks_per_sm", "threads", "smem_bytes", "stages"}``
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; ``stages``
    mamba_out_bwd's ring, 0 for mamba_in_bwd)."""
    which = ("mamba_out_bwd", "mamba_in_bwd").index(kernel)
    lib, fn = _fn("repro_mamba_bwd_occupancy",
                  _ARGS["repro_mamba_bwd_occupancy"])
    out = (ctypes.c_int * 4)()
    err = fn(which, _DTYPE_CODES[dtype], d_inner, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{kernel} occupancy: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes", "stages"),
                    out))


def _launch_in(zxbcdt, dt_bias, heads, groups, state):
    bsz, s = zxbcdt.shape[:2]
    di, p = split_widths(zxbcdt, heads, groups, state)
    f32 = dict(dtype=torch.float32, device=zxbcdt.device)
    x = torch.empty((bsz, s, heads, p), **f32)
    dt = torch.empty((bsz, s, heads), **f32)
    b = torch.empty((bsz, s, groups, state), **f32)
    c = torch.empty_like(b)
    _launch("repro_mamba_in", "mamba_in", zxbcdt,
            _DTYPE_CODES[zxbcdt.dtype], *_rows(zxbcdt), di, groups * state,
            heads, dt_bias, _DTYPE_CODES[dt_bias.dtype], x, b, c, dt)
    mamba_in.launches += 1
    return x, dt, b, c


def _launch_out(y, zxbcdt, d_skip, norm_g):
    bsz, s, heads, p = y.shape
    out = torch.empty((bsz, s, heads * p), dtype=zxbcdt.dtype,
                      device=y.device)
    r = torch.empty((bsz, s), dtype=torch.float32, device=y.device)
    _launch("repro_mamba_out", "mamba_out", y, zxbcdt,
            _DTYPE_CODES[zxbcdt.dtype], *_rows(zxbcdt), heads * p, p, d_skip,
            _DTYPE_CODES[d_skip.dtype], norm_g, _DTYPE_CODES[norm_g.dtype],
            out, r)
    mamba_out.launches += 1
    return out, r


def _launch_out_bwd(d_out, y, zxbcdt, r, d_skip, norm_g, grad):
    bsz, s, heads, p = y.shape
    di = heads * p
    f32 = dict(dtype=torch.float32, device=y.device)
    dy = torch.empty_like(y)
    # norm_g's and d_skip's partials, a row a row group
    part_g = torch.empty((partial_blocks(bsz * s), di), **f32)
    part_s = torch.empty_like(part_g)
    d_norm_g = torch.empty((di,), **f32)
    d_skip_grad = torch.empty((heads,), **f32)
    _launch("repro_mamba_out_bwd", "mamba_out_bwd", d_out, y, zxbcdt,
            _DTYPE_CODES[zxbcdt.dtype], *_rows(zxbcdt), r, di, p,
            grad.shape[-1], d_skip, _DTYPE_CODES[d_skip.dtype], norm_g,
            _DTYPE_CODES[norm_g.dtype], dy, grad, part_g, part_s, d_norm_g,
            d_skip_grad)
    mamba_out_bwd.launches += 1
    return dy, d_norm_g, d_skip_grad


def _launch_in_bwd(dx, db, dc, ddt, dy, zxbcdt, dt_bias, d_skip, grad):
    bsz, s, heads, p = dx.shape
    groups, state = db.shape[2:]
    part = torch.empty((partial_blocks(bsz * s, IN_BWD_BLOCKS), heads),
                       dtype=torch.float32, device=dx.device)
    d_dt_bias = torch.empty((heads,), dtype=torch.float32, device=dx.device)
    _launch("repro_mamba_in_bwd", "mamba_in_bwd", dx, db, dc, ddt, dy,
            zxbcdt, _DTYPE_CODES[zxbcdt.dtype], *_rows(zxbcdt), heads * p,
            groups * state, heads, p, grad.shape[-1], dt_bias,
            _DTYPE_CODES[dt_bias.dtype], d_skip, _DTYPE_CODES[d_skip.dtype],
            grad, part, d_dt_bias)
    mamba_in_bwd.launches += 1
    return d_dt_bias


# ------------------------------------------------------------ operators --
# Real CPU tensors run the plain versions (as the wrappers do); CUDA
# tensors launch the kernels; fake tensors run the fake implementations.

@torch.library.custom_op("repro_torch::mamba_in", mutates_args=())
def _in_op(zxbcdt: torch.Tensor, dt_bias: torch.Tensor, heads: int,
           groups: int, state: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, dt, b, c), float32, contiguous."""
    if zxbcdt.device.type == "cpu":
        return mamba_in_plain(zxbcdt, dt_bias, heads=heads, groups=groups,
                              state=state)
    return _launch_in(zxbcdt, dt_bias, heads, groups, state)


@_in_op.register_fake
def _(zxbcdt, dt_bias, heads, groups, state):
    bsz, s = zxbcdt.shape[:2]
    _, p = split_widths(zxbcdt, heads, groups, state)
    kw = dict(dtype=_acc(zxbcdt))
    return (zxbcdt.new_empty((bsz, s, heads, p), **kw),
            zxbcdt.new_empty((bsz, s, heads), **kw),
            zxbcdt.new_empty((bsz, s, groups, state), **kw),
            zxbcdt.new_empty((bsz, s, groups, state), **kw))


@torch.library.custom_op("repro_torch::mamba_out", mutates_args=())
def _out_op(y: torch.Tensor, zxbcdt: torch.Tensor, d_skip: torch.Tensor,
            norm_g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out in zxbcdt's dtype, r float32)."""
    if y.device.type == "cpu":
        out, r = mamba_out_plain(y, zxbcdt, d_skip, norm_g)
        return out, r.contiguous()
    return _launch_out(y, zxbcdt, d_skip, norm_g)


@_out_op.register_fake
def _(y, zxbcdt, d_skip, norm_g):
    bsz, s, heads, p = y.shape
    return (zxbcdt.new_empty((bsz, s, heads * p)),
            y.new_empty((bsz, s), dtype=_acc(zxbcdt)))


@torch.library.custom_op("repro_torch::mamba_out_bwd",
                         mutates_args=("grad",))
def _out_bwd_op(d_out: torch.Tensor, y: torch.Tensor, zxbcdt: torch.Tensor,
                r: torch.Tensor, d_skip: torch.Tensor, norm_g: torch.Tensor,
                grad: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dy, d_norm_g, d_skip's gradient), float32; z's gradient written
    into ``grad``'s z columns."""
    if y.device.type == "cpu":
        return mamba_out_bwd_plain(d_out, y, zxbcdt, r, d_skip, norm_g,
                                   grad)
    return _launch_out_bwd(d_out, y, zxbcdt, r, d_skip, norm_g, grad)


@_out_bwd_op.register_fake
def _(d_out, y, zxbcdt, r, d_skip, norm_g, grad):
    di = y.shape[2] * y.shape[3]
    return (torch.empty_like(y), y.new_empty((di,)),
            y.new_empty((y.shape[2],)))


@torch.library.custom_op("repro_torch::mamba_in_bwd", mutates_args=("grad",))
def _in_bwd_op(dx: torch.Tensor, db: torch.Tensor, dc: torch.Tensor,
               ddt: torch.Tensor, dy: torch.Tensor, zxbcdt: torch.Tensor,
               dt_bias: torch.Tensor, d_skip: torch.Tensor,
               grad: torch.Tensor) -> torch.Tensor:
    """dt_bias's gradient, float32; the x, b, c and dt columns written
    into ``grad``."""
    if dx.device.type == "cpu":
        return mamba_in_bwd_plain(dx, db, dc, ddt, dy, zxbcdt, dt_bias,
                                  d_skip, grad)
    return _launch_in_bwd(dx, db, dc, ddt, dy, zxbcdt, dt_bias, d_skip, grad)


@_in_bwd_op.register_fake
def _(dx, db, dc, ddt, dy, zxbcdt, dt_bias, d_skip, grad):
    return dx.new_empty((dx.shape[2],))


# ------------------------------------------------------------- wrappers --

def _on_device(tensors, what: str) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")


def _kernel_ready(zxbcdt: torch.Tensor, vectors, floats, what: str) -> None:
    """Raise unless the kernel takes these tensors: zxbcdt float32 or
    bfloat16 with contiguous rows, the vectors float32 or bfloat16 and
    contiguous, the float32 operands float32 and contiguous, d_inner at
    most MAX_D_INNER.  Reads no data, so a fake tensor is checked as a
    real one."""
    if zxbcdt.dtype not in _DTYPE_CODES or zxbcdt.dim() != 3 or \
            zxbcdt.stride(-1) != 1:
        raise ValueError(f"{what} takes a (B, S, W) float32 or bfloat16 "
                         f"zxbcdt with contiguous rows, got {zxbcdt.dtype} "
                         f"{tuple(zxbcdt.shape)} strides {zxbcdt.stride()}")
    for v in vectors:
        if v.dtype not in _DTYPE_CODES or not v.is_contiguous():
            raise ValueError(f"{what} takes contiguous float32 or bfloat16 "
                             f"vectors, got {v.dtype} {tuple(v.shape)}")
    for t in floats:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous float32 operands, got "
                             f"{t.dtype} {tuple(t.shape)}")


def mamba_in(zxbcdt: torch.Tensor, dt_bias: torch.Tensor, *, heads: int,
             groups: int, state: int, use_kernel: bool = True):
    """The SSD's operands from the in-projection's output ``zxbcdt`` (B, S,
    2 d_inner + 2 G N + H): ``(x (B, S, H, P), dt (B, S, H), b, c (B, S,
    G, N))``, float32 and contiguous, ``dt = softplus(dt + dt_bias)``.
    The kernel on CUDA tensors (counted in ``mamba_in.launches``), the
    plain version on CPU tensors or with ``use_kernel=False``."""
    split_widths(zxbcdt, heads, groups, state)
    if tuple(dt_bias.shape) != (heads,):
        raise ValueError(f"dt_bias must be ({heads},), got "
                         f"{tuple(dt_bias.shape)}")
    _on_device((zxbcdt, dt_bias), "mamba_in")
    if not use_kernel or plain_route(zxbcdt):
        return mamba_in_plain(zxbcdt, dt_bias, heads=heads, groups=groups,
                              state=state)
    _kernel_ready(zxbcdt, (dt_bias,), (), "mamba_in")
    return card_call(_in_op, _launch_in, zxbcdt, dt_bias, heads, groups,
                     state)


def _out_shapes(y, zxbcdt, d_skip, norm_g, what: str) -> None:
    bsz, s, heads, p = y.shape
    di = heads * p
    if tuple(zxbcdt.shape[:2]) != (bsz, s) or zxbcdt.shape[-1] < 2 * di or \
            tuple(d_skip.shape) != (heads,) or tuple(norm_g.shape) != (di,):
        raise ValueError(f"{what}: y {tuple(y.shape)}, zxbcdt "
                         f"{tuple(zxbcdt.shape)}, d_skip "
                         f"{tuple(d_skip.shape)} and norm_g "
                         f"{tuple(norm_g.shape)} disagree")
    if y.device.type == "cuda" and di > MAX_D_INNER:
        raise ValueError(f"{what}'s kernel holds rows of at most "
                         f"{MAX_D_INNER} channels, not {di}")


def mamba_out(y: torch.Tensor, zxbcdt: torch.Tensor, d_skip: torch.Tensor,
              norm_g: torch.Tensor, *, use_kernel: bool = True):
    """The mixer's output from the SSD's ``y`` (B, S, H, P), float32:
    ``(out (B, S, d_inner) in zxbcdt's dtype, r (B, S) float32)`` -- the D
    skip (``d_skip`` (H,)), the round to the model's dtype and the gated
    RMSNorm (``norm_g`` (d_inner,)), ``r`` each row's ``rsqrt``.  The
    kernel on CUDA tensors (counted in ``mamba_out.launches``), the plain
    version on CPU tensors or with ``use_kernel=False``."""
    _out_shapes(y, zxbcdt, d_skip, norm_g, "mamba_out")
    _on_device((y, zxbcdt, d_skip, norm_g), "mamba_out")
    if not use_kernel or plain_route(y):
        return mamba_out_plain(y, zxbcdt, d_skip, norm_g)
    _kernel_ready(zxbcdt, (d_skip, norm_g), (y,), "mamba_out")
    return card_call(_out_op, _launch_out, y, zxbcdt, d_skip, norm_g)


def mamba_out_bwd(d_out: torch.Tensor, y: torch.Tensor,
                  zxbcdt: torch.Tensor, r: torch.Tensor,
                  d_skip: torch.Tensor, norm_g: torch.Tensor,
                  grad: torch.Tensor, *, use_kernel: bool = True):
    """:func:`mamba_out`'s gradient from ``d_out`` (its output's, in
    zxbcdt's dtype): z's written into ``grad[..., :d_inner]`` (``grad``
    (B, S, W) contiguous in zxbcdt's dtype, zxbcdt's gradient buffer),
    ``(dy (B, S, H, P), d_norm_g (d_inner,), d_skip's (H,))`` returned in
    float32.  The kernel on CUDA tensors (counted in
    ``mamba_out_bwd.launches``), the plain version on CPU tensors or with
    ``use_kernel=False``."""
    _out_shapes(y, zxbcdt, d_skip, norm_g, "mamba_out_bwd")
    bsz, s, heads, p = y.shape
    if tuple(d_out.shape) != (bsz, s, heads * p) or \
            tuple(r.shape) != (bsz, s) or grad.shape != zxbcdt.shape or \
            grad.dtype != zxbcdt.dtype or not grad.is_contiguous():
        raise ValueError(f"mamba_out_bwd: d_out {tuple(d_out.shape)}, r "
                         f"{tuple(r.shape)} and grad {tuple(grad.shape)} "
                         f"{grad.dtype} do not fit y {tuple(y.shape)} and "
                         f"zxbcdt {tuple(zxbcdt.shape)} {zxbcdt.dtype}")
    _on_device((d_out, y, zxbcdt, r, d_skip, norm_g, grad), "mamba_out_bwd")
    if not use_kernel or plain_route(y):
        return mamba_out_bwd_plain(d_out, y, zxbcdt, r, d_skip, norm_g, grad)
    _kernel_ready(zxbcdt, (d_skip, norm_g), (y, r), "mamba_out_bwd")
    if d_out.dtype != zxbcdt.dtype or not d_out.is_contiguous():
        raise ValueError(f"mamba_out_bwd takes a contiguous d_out in "
                         f"{zxbcdt.dtype}, got {d_out.dtype}")
    return card_call(_out_bwd_op, _launch_out_bwd, d_out, y, zxbcdt, r,
                     d_skip, norm_g, grad)


def mamba_in_bwd(dx: torch.Tensor, db: torch.Tensor, dc: torch.Tensor,
                 ddt: torch.Tensor, dy: torch.Tensor, zxbcdt: torch.Tensor,
                 dt_bias: torch.Tensor, d_skip: torch.Tensor,
                 grad: torch.Tensor, *, use_kernel: bool = True
                 ) -> torch.Tensor:
    """:func:`mamba_in`'s gradient, with the D skip's term of x: from the
    SSD backward's ``dx`` (B, S, H, P), ``db``, ``dc`` (B, S, G, N) and
    ``ddt`` (B, S, H) and :func:`mamba_out_bwd`'s ``dy``, the x, b, c and
    dt columns of ``grad`` are written; dt_bias's gradient (H,) float32
    is returned.  The kernel on CUDA tensors (counted in
    ``mamba_in_bwd.launches``), the plain version on CPU tensors or with
    ``use_kernel=False``."""
    bsz, s, heads, p = dx.shape
    groups, state = db.shape[2:]
    if tuple(dy.shape) != tuple(dx.shape) or dc.shape != db.shape or \
            tuple(ddt.shape) != (bsz, s, heads) or \
            tuple(db.shape[:2]) != (bsz, s) or \
            tuple(dt_bias.shape) != (heads,) or \
            tuple(d_skip.shape) != (heads,) or \
            grad.shape != zxbcdt.shape or grad.dtype != zxbcdt.dtype or \
            not grad.is_contiguous() or \
            split_widths(zxbcdt, heads, groups, state) != (heads * p, p):
        raise ValueError(f"mamba_in_bwd's shapes disagree: dx "
                         f"{tuple(dx.shape)}, db {tuple(db.shape)}, ddt "
                         f"{tuple(ddt.shape)}, zxbcdt {tuple(zxbcdt.shape)},"
                         f" grad {tuple(grad.shape)} {grad.dtype}")
    _on_device((dx, db, dc, ddt, dy, zxbcdt, dt_bias, d_skip, grad),
               "mamba_in_bwd")
    if not use_kernel or plain_route(dx):
        return mamba_in_bwd_plain(dx, db, dc, ddt, dy, zxbcdt, dt_bias,
                                  d_skip, grad)
    _kernel_ready(zxbcdt, (dt_bias, d_skip), (dx, db, dc, ddt, dy),
                  "mamba_in_bwd")
    return card_call(_in_bwd_op, _launch_in_bwd, dx, db, dc, ddt, dy, zxbcdt,
                     dt_bias, d_skip, grad)


mamba_in.launches = 0
mamba_out.launches = 0
mamba_out_bwd.launches = 0
mamba_in_bwd.launches = 0


def mixer_bytes(kernel: str, rows: int, heads: int, p: int, gn: int,
                itemsize: int) -> int:
    """The bytes one call of ``kernel`` must move over ``rows`` tokens,
    each input read once and each output written once (the partials'
    scratch not counted): ``gn`` = G N, ``itemsize`` the model dtype's."""
    di = heads * p
    cols = di + 2 * gn + heads          # the x, b, c and dt columns
    if kernel == "mamba_in":
        return rows * cols * (itemsize + 4) + 4 * heads
    if kernel == "mamba_out":           # y, x, z in; out, r out
        return rows * (di * (4 + 3 * itemsize) + 4) + 4 * heads + \
            itemsize * di
    if kernel == "mamba_out_bwd":       # d_out, y, x, z, r in; dy, dz out
        return rows * (di * (8 + 4 * itemsize) + 4) + (4 + itemsize) * di + \
            8 * heads
    if kernel == "mamba_in_bwd":        # dx, dy, db, dc, ddt, dt in
        return rows * ((cols + di) * 4 + heads * itemsize + cols * itemsize) \
            + 12 * heads
    raise ValueError(kernel)


# ------------------------------------------------------ the mixer's span --

class MambaMixerFn(torch.autograd.Function):
    """The Mamba-2 mixer from ``zxbcdt`` to its normed output: ``(out (B,
    S, d_inner) in zxbcdt's dtype, h_final (B, H, P, N) float32, empty
    without ``want_state``)``.

    Forward: :func:`mamba_in`, the SSD forward (``kernels.ssd._ssd_op``
    on CUDA and fake tensors, keeping its scratches; its plain passes on
    CPU tensors) from ``h0`` (zero when None) at ``chunk``, and
    :func:`mamba_out`.  Backward: :func:`mamba_out_bwd`, the SSD backward
    (:func:`repro_torch.kernels.ssd.ssd_bwd`) and :func:`mamba_in_bwd`,
    which write zxbcdt's gradient into one buffer between them; a_log's
    gradient is the SSD backward's.  zxbcdt, dt_bias, a_log, d_skip,
    norm_g and h0 get gradients, each in its own dtype."""

    @staticmethod
    def forward(ctx, zxbcdt, dt_bias, a_log, d_skip, norm_g, h0,
                chunk: int, heads: int, groups: int, state: int,
                want_state: bool):
        x, dt, b, c = mamba_in(zxbcdt, dt_bias, heads=heads, groups=groups,
                               state=state)
        if plain_route(x):
            y, h_final, s, h_in = _plain_parts(x, dt, a_log, b, c, chunk, h0)
        else:
            y, h_final, s, h_in = _ssd_op(x, dt, a_log, b, c, h0, chunk,
                                          want_state)
        out, r = mamba_out(y, zxbcdt, d_skip, norm_g)
        ctx.save_for_backward(zxbcdt, dt_bias, a_log, d_skip, norm_g, x, dt,
                              b, c, s, h_in, y, r)
        ctx.chunk, ctx.has_h0 = chunk, h0 is not None
        ctx.set_materialize_grads(False)
        if not want_state:
            h_final = s.new_empty((0,))
        return out, h_final

    @staticmethod
    def backward(ctx, d_out, dh_final):
        (zxbcdt, dt_bias, a_log, d_skip, norm_g, x, dt, b, c, s, h_in, y,
         r) = ctx.saved_tensors
        bsz, seq, heads, p = y.shape
        if d_out is None:
            d_out = zxbcdt.new_zeros((bsz, seq, heads * p))
        if dh_final is not None and dh_final.numel() == 0:
            dh_final = None
        grad = torch.empty(zxbcdt.shape, dtype=zxbcdt.dtype,
                           device=zxbcdt.device)
        dy, d_norm_g, d_skip_grad = mamba_out_bwd(
            d_out.contiguous(), y, zxbcdt, r, d_skip, norm_g, grad)
        dx, ddt, da_log, db, dc, dh0 = ssd_bwd(
            x, dt, a_log, b, c, s, h_in, dy,
            None if dh_final is None else dh_final.contiguous(),
            chunk=ctx.chunk)
        d_dt_bias = mamba_in_bwd(dx, db, dc, ddt, dy, zxbcdt, dt_bias,
                                 d_skip, grad)
        return (grad, d_dt_bias.to(dt_bias.dtype), da_log.to(a_log.dtype),
                d_skip_grad.to(d_skip.dtype), d_norm_g.to(norm_g.dtype),
                dh0 if ctx.has_h0 else None, None, None, None, None, None)


def mamba_mixer(zxbcdt: torch.Tensor, dt_bias: torch.Tensor,
                a_log: torch.Tensor, d_skip: torch.Tensor,
                norm_g: torch.Tensor, *, heads: int, groups: int, state: int,
                chunk: int, h0: Optional[torch.Tensor] = None,
                want_state: bool = False):
    """:class:`MambaMixerFn` on ``zxbcdt`` (B, S, 2 d_inner + 2 G N + H):
    ``(out (B, S, d_inner), h_final)`` (h_final empty without
    ``want_state``).  The chunk is clamped to S and must divide it; on
    CUDA tensors the SSD kernels' legality (and, when a gradient is
    needed, their backward's) is checked before anything launches."""
    bsz, s = zxbcdt.shape[:2]
    di, p = split_widths(zxbcdt, heads, groups, state)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide S = {s}")
    state_shape = (bsz, heads, p, state)
    if h0 is not None and tuple(h0.shape) != state_shape:
        raise ValueError(f"h0 must be {state_shape}, got {tuple(h0.shape)}")
    if zxbcdt.device.type == "cuda":
        if di > MAX_D_INNER:
            raise ValueError(f"the mixer's kernels hold rows of at most "
                             f"{MAX_D_INNER} channels, not {di}")
        limit = card_smem(zxbcdt)
        if not ssd_tile_legal(s, chunk, p, state, limit):
            raise ValueError(f"chunk {chunk} at (P, N) = ({p}, {state}) is "
                             f"not legal for the ssd kernels "
                             f"({ssd_route_table()})")
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (zxbcdt, dt_bias, a_log, d_skip, norm_g))
        if needs_grad and not ssd_bwd_legal(s, chunk, p, state, limit):
            raise ValueError(f"the ssd backward kernels do not take chunk "
                             f"{chunk} at (P, N) = ({p}, {state}) on this "
                             f"card")
    return MambaMixerFn.apply(zxbcdt, dt_bias, a_log, d_skip, norm_g, h0,
                              chunk, heads, groups, state, want_state)
