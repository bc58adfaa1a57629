"""AdamW's optimizer step as hand-written CUDA kernels, beside their plain
versions (``csrc/adamw.cu``).

No Pallas body is replaced: the reference's ``AdamW.update`` and
``apply_updates`` (``src/repro/train/optimizer.py:38-74``) run inside its
jitted train step, where XLA fuses each leaf's update into one pass and its
squared norm into a reduction.  The port runs eagerly, so its plain version
is about 22 elementwise kernels a slice of :data:`SLICE` elements; the
kernels here are the fusion, rounding every operation as the plain
version's separate torch kernels do, so the update is the same bits.

Both wrappers take the step's tensors as lists, so a step makes one
operator call for each, whatever its number of tensors (mamba2-2.7b has
450), and launches one kernel a tensor inside it:

* :func:`adamw_sqnorm` -- the float32 sum of every gradient's squares,
  the tensors' sums added in list order, as
  :func:`repro_torch.train.optimizer._squared_norm` adds them.  The kernel
  sums a tensor in float64 in a fixed order (no atomics, the same bits
  twice), rounds once and adds it to the running sum on the card.
* :func:`adamw_update` -- each tensor's moments updated in place and its
  update written to ``u`` (``AdamW.update``'s contract), or, with ``u``
  None, its parameter updated in place (``AdamW.update_apply``: what the
  update followed by ``apply_updates`` rounds to), in one pass.

Dispatch as the other kernels': real CPU tensors run the plain version
directly; CUDA and fake tensors go through the ``torch.library`` operators
``repro_torch::adamw_sqnorm``, ``adamw_update`` and ``adamw_update_apply``
(the fake implementations shape the outputs, so a traced step reaches
them); on CUDA tensors the kernels launch or raise.  ``use_kernel=False``
runs the plain version on any device.  ``adamw_sqnorm.launches`` and
``adamw_update.launches`` count the kernels' launches, one a tensor.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import _build
from ._card import plain_route

#: elements the plain update works through at once (256 MB of float32
#: temporaries); the optimizer passes its own
SLICE = 1 << 26
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------- plain versions --

def adamw_sqnorm_plain(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 sum of every gradient's squares, as torch's kernels
    compute it: each tensor's float32 squares summed in float32, the sums
    added in list order."""
    total = None
    for g in grads:
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return total


def _update_slice(g, m, v, p, u, *, scale, bc1, bc2, lr, b1, b2, eps,
                  weight_decay, decay: bool) -> None:
    """One slice of the update, each step a separate torch kernel: m and v
    in place, the update in ``p``'s dtype into ``u``."""
    g = g.float() if scale is None else g.float() * scale
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * g * g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay and decay:
        upd = upd + weight_decay * p.float()
    u.copy_((-lr * upd).to(u.dtype))


def adamw_update_plain(g, m, v, p, u, *, scale, bc1, bc2, lr, b1, b2, eps,
                       weight_decay, decay: Sequence[bool],
                       slice_elems: int = SLICE) -> None:
    """The update of each tensor of the lists by :func:`_update_slice`
    over slices of ``slice_elems`` elements: m and v in place, then ``u``
    (given) or ``p`` in place (``u`` None; each slice's update in ``p``'s
    dtype added to it, as ``apply_updates`` adds).  Slicing an elementwise
    update changes no value.  The written tensors are flattened by
    ``view``, so a non-contiguous one raises rather than losing its
    write."""
    apply = u is None
    kw = dict(scale=scale, bc1=bc1, bc2=bc2, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    for i in range(len(g)):
        flat_g = g[i].reshape(-1)
        flat_m, flat_v = m[i].view(-1), v[i].view(-1)
        flat_p = p[i].view(-1) if apply else p[i].reshape(-1)
        flat_u = None if apply else u[i].view(-1)
        for lo in range(0, flat_g.numel(), slice_elems):
            hi = lo + slice_elems
            ps = flat_p[lo:hi]
            us = torch.empty_like(ps) if apply else flat_u[lo:hi]
            _update_slice(flat_g[lo:hi], flat_m[lo:hi], flat_v[lo:hi], ps,
                          us, decay=decay[i], **kw)
            if apply:
                ps.add_(us)


# ------------------------------------------------------------- launches --

_ARGTYPES = {
    "repro_adamw_sqnorm": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p],
    "repro_adamw_update": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p] + [ctypes.c_float] * 7 +
                          [ctypes.c_int, ctypes.c_void_p],
    "repro_adamw_sqnorm_blocks": [],
    "repro_cuda_error_string": [ctypes.c_int],
}


def _lib() -> ctypes.CDLL:
    """The built library, its functions' argument and result types set."""
    lib = _build.load("adamw")
    if lib.repro_adamw_update.argtypes is None:
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p \
                if name == "repro_cuda_error_string" else ctypes.c_int
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: {msg} (cudaError {err})")


def _on_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA, not {t.device}")


def _scalar(t: Optional[torch.Tensor], what: str):
    if t is not None and (t.dtype != torch.float32 or t.numel() != 1):
        raise TypeError(f"{what} must be a one-element float32 tensor, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")
    return None if t is None else t.data_ptr()


def _launch_sqnorm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """One norm kernel a tensor, each adding its sum to one 0-d total on
    the card (the first writing it), through one scratch of partials."""
    lib = _lib()
    dev = grads[0].device
    _on_card(grads[0], "adamw_sqnorm")
    total = torch.empty((), dtype=torch.float32, device=dev)
    partials = torch.empty((lib.repro_adamw_sqnorm_blocks(),),
                           dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, g in enumerate(grads):
        err = lib.repro_adamw_sqnorm(
            g.data_ptr(), _DTYPE_CODES[g.dtype], g.numel(),
            total.data_ptr() if i else None, total.data_ptr(),
            partials.data_ptr(), stream)
        _raise_on(lib, err, f"adamw_sqnorm launch failed for "
                            f"{tuple(g.shape)} {g.dtype}")
        adamw_sqnorm.launches += 1
    return total


def _launch_update(g, m, v, p, u, scale, bc1, bc2, lr, b1, b2, eps,
                   weight_decay, decay) -> None:
    """One update kernel a tensor (none for an empty one)."""
    lib = _lib()
    _on_card(g[0], "adamw_update")
    ptrs = [_scalar(scale, "scale"), _scalar(bc1, "bc1"), _scalar(bc2, "bc2")]
    # the float32 roundings of the Python doubles, as torch rounds a Python
    # scalar against a float32 tensor
    hyper = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay, -lr)
    stream = torch.cuda.current_stream(g[0].device).cuda_stream
    for i in range(len(g)):
        if g[i].numel() == 0:
            continue
        err = lib.repro_adamw_update(
            g[i].data_ptr(), _DTYPE_CODES[g[i].dtype], m[i].data_ptr(),
            v[i].data_ptr(), p[i].data_ptr(), _DTYPE_CODES[p[i].dtype],
            None if u is None else u[i].data_ptr(), g[i].numel(), *ptrs,
            *hyper, int(bool(weight_decay) and decay[i]), stream)
        _raise_on(lib, err, f"adamw_update launch failed for "
                            f"{tuple(p[i].shape)} (g {g[i].dtype}, p "
                            f"{p[i].dtype})")
        adamw_update.launches += 1


# ------------------------------------------------------------ operators --
# Real CPU tensors run the plain versions (as the wrappers do); CUDA
# tensors launch the kernels; fake tensors run the fake implementations.

@torch.library.custom_op("repro_torch::adamw_sqnorm", mutates_args=())
def _sqnorm_op(grads: List[torch.Tensor]) -> torch.Tensor:
    """The float32 sum of every gradient's squares, 0-d."""
    if grads[0].device.type == "cpu":
        return adamw_sqnorm_plain(grads)
    return _launch_sqnorm(grads)


@_sqnorm_op.register_fake
def _(grads):
    return grads[0].new_empty((), dtype=torch.float32)


@torch.library.custom_op("repro_torch::adamw_update",
                         mutates_args=("m", "v", "u"))
def _update_op(g: List[torch.Tensor], m: List[torch.Tensor],
               v: List[torch.Tensor], p: List[torch.Tensor],
               u: List[torch.Tensor], scale: Optional[torch.Tensor],
               bc1: torch.Tensor, bc2: torch.Tensor, lr: float, b1: float,
               b2: float, eps: float, weight_decay: float,
               decay: List[bool]) -> None:
    """Each tensor's m and v in place, its update in ``p``'s dtype into
    ``u``."""
    kw = dict(scale=scale, bc1=bc1, bc2=bc2, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay, decay=decay)
    if g[0].device.type == "cpu":
        adamw_update_plain(g, m, v, p, u, **kw)
    else:
        _launch_update(g, m, v, p, u, **kw)


@_update_op.register_fake
def _(g, m, v, p, u, scale, bc1, bc2, lr, b1, b2, eps, weight_decay, decay):
    return None


@torch.library.custom_op("repro_torch::adamw_update_apply",
                         mutates_args=("m", "v", "p"))
def _update_apply_op(g: List[torch.Tensor], m: List[torch.Tensor],
                     v: List[torch.Tensor], p: List[torch.Tensor],
                     scale: Optional[torch.Tensor], bc1: torch.Tensor,
                     bc2: torch.Tensor, lr: float, b1: float, b2: float,
                     eps: float, weight_decay: float,
                     decay: List[bool]) -> None:
    """Each tensor's m, v and p in place (the update in ``p``'s dtype added
    to ``p``)."""
    kw = dict(scale=scale, bc1=bc1, bc2=bc2, lr=lr, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay, decay=decay)
    if g[0].device.type == "cpu":
        adamw_update_plain(g, m, v, p, None, **kw)
    else:
        _launch_update(g, m, v, p, None, **kw)


@_update_apply_op.register_fake
def _(g, m, v, p, scale, bc1, bc2, lr, b1, b2, eps, weight_decay, decay):
    return None


# ------------------------------------------------------------- wrappers --

def _kernel_ready(tensors, what: str) -> None:
    """Raise unless every tensor lies on one device, contiguous (the
    kernel writes in place, and a flattening copy would lose the write);
    checked on the operator route, fake tensors included."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"the {what} kernel takes tensors on one "
                             f"device: {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"the {what} kernel takes contiguous tensors; "
                             f"got strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")


def adamw_sqnorm(grads: Sequence[torch.Tensor], *,
                 use_kernel: bool = True) -> torch.Tensor:
    """The float32 sum of every gradient's squares (0-d), the tensors'
    sums added in list order; each gradient float32 or bfloat16.  The
    kernel a tensor on CUDA tensors (contiguous, else it raises; each
    launch counted in ``adamw_sqnorm.launches``), the plain version on CPU
    tensors or with ``use_kernel=False``."""
    grads = list(grads)
    if not grads:
        raise ValueError("adamw_sqnorm needs at least one gradient")
    for g in grads:
        if g.dtype not in _DTYPE_CODES:
            raise TypeError(f"adamw_sqnorm takes float32 or bfloat16, not "
                            f"{g.dtype}")
    if not use_kernel or plain_route(grads[0]):
        return adamw_sqnorm_plain(grads)
    _kernel_ready(grads, "adamw_sqnorm")
    return _sqnorm_op(grads)


def adamw_update(g: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
                 v: Sequence[torch.Tensor], p: Sequence[torch.Tensor],
                 u: Optional[Sequence[torch.Tensor]], *,
                 scale: Optional[torch.Tensor], bc1: torch.Tensor,
                 bc2: torch.Tensor, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float, decay: Sequence[bool],
                 use_kernel: bool = True, slice_elems: int = SLICE) -> None:
    """AdamW's update of each tensor of the lists: the float32 moments
    ``m[i]`` and ``v[i]`` in place, then the update ``round_p(-lr d)``
    into ``u[i]`` or, with ``u`` None, added to ``p[i]`` in place.
    ``g[i]`` float32 or bfloat16, ``p[i]`` (and ``u[i]``) float32 or
    bfloat16, all of ``p[i]``'s shape; ``decay[i]`` whether the tensor
    takes weight decay; ``scale`` (None: no clip), ``bc1`` and ``bc2``
    one-element float32 tensors.  One kernel a tensor on CUDA tensors
    (contiguous, else it raises; each launch counted in
    ``adamw_update.launches``), the plain version over slices of
    ``slice_elems`` on CPU tensors or with ``use_kernel=False``."""
    g, m, v, p = list(g), list(m), list(v), list(p)
    u = None if u is None else list(u)
    decay = [bool(d) for d in decay]
    lists = [g, m, v, p, decay] + ([] if u is None else [u])
    if not g or len({len(x) for x in lists}) != 1:
        raise ValueError(f"adamw_update takes lists of one length, at least "
                         f"one: {[len(x) for x in lists]}")
    for i in range(len(g)):
        if g[i].dtype not in _DTYPE_CODES or p[i].dtype not in _DTYPE_CODES:
            raise TypeError(f"adamw_update takes float32 or bfloat16 "
                            f"gradients and parameters, not {g[i].dtype} "
                            f"and {p[i].dtype}")
        if m[i].dtype != torch.float32 or v[i].dtype != torch.float32:
            raise TypeError(f"the moments are float32, not {m[i].dtype} "
                            f"and {v[i].dtype}")
        shapes = {tuple(t[i].shape) for t in (g, m, v, p) +
                  (() if u is None else (u,))}
        if len(shapes) != 1 or (u is not None and u[i].dtype != p[i].dtype):
            raise ValueError(f"adamw_update takes g, m, v, p and u of one "
                             f"shape (u in p's dtype): {shapes}")
    kw = dict(scale=scale, bc1=bc1, bc2=bc2, lr=float(lr), b1=float(b1),
              b2=float(b2), eps=float(eps),
              weight_decay=float(weight_decay), decay=decay)
    if not use_kernel or plain_route(g[0]):
        adamw_update_plain(g, m, v, p, u, slice_elems=slice_elems, **kw)
        return
    _kernel_ready(g + m + v + p + ([] if u is None else u) +
                  [t for t in (scale, bc1, bc2) if t is not None],
                  "adamw_update")
    if u is None:
        _update_apply_op(g, m, v, p, **kw)
    else:
        _update_op(g, m, v, p, u, **kw)


adamw_sqnorm.launches = 0
adamw_update.launches = 0


def adamw_update_bytes(n: int, g_dtype: torch.dtype,
                       p_dtype: torch.dtype) -> int:
    """The bytes one update of ``n`` elements must move on the train step,
    each input read once and each output written once: g and the two
    float32 moments read, the moments written, p read and written."""
    return n * (g_dtype.itemsize + 16 + 2 * p_dtype.itemsize)
