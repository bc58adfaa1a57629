"""Mamba-2 SSD chunked scan: the hand-written Hopper kernel and its plain
version.

The counterpart of ``repro/kernels/ssd.py``.  The kernel is
``csrc/ssd.cu`` (FP32 FFMA; one thread block per (batch, head) walking
the chunks in order with the (P, N) state in shared memory; each chunk's
Q x Q decay-weighted product is formed in R-row tiles, never whole; its
note says what bounds it and why it is built so).  The recurrence is
``h_t = h_{t-1} * exp(a dt_t) + dt_t x_t (x) b_t``, ``y_t = c_t . h_t`` with
``a = -exp(a_log)``, computed chunk-wise in the dual form; no softplus on
dt and no D skip (the kernel's contract).

:func:`ssd` dispatches on where its operands lie: CUDA tensors launch the
kernel (or raise); CPU tensors take :func:`ssd_plain`, the kernel's chunk
loop in plain PyTorch — the counterpart of Pallas ``interpret=True``.
There is no fall back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from ._card import H100_SMEM_OPTIN, PROXY_BLOCKS

#: head dims P and state sizes N the kernel is instantiated for
KERNEL_HEAD_DIMS: Tuple[int, ...] = (8, 16, 32, 64)
KERNEL_STATES: Tuple[int, ...] = (8, 16, 32, 64, 128)
#: rows of the kernel's query tiles and key slabs: min(chunk, ROWS)
ROWS = 64


def _rows(chunk: int) -> int:
    return min(chunk, ROWS)


def ssd_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory one block stages, all float32: the (P, N) state, a
    C tile and a B slab of R rows transposed (N x (R + 1) each), an X slab
    (R x P), the decayed G tile (R x stride, stride % 32 == 16) and the
    chunk's cumulative decay and dt, with R = min(chunk, 64)."""
    r = _rows(chunk)
    return 4 * (n * p + 2 * n * (r + 1) + r * p + r * (r + 16 - r % 32) +
                2 * chunk)


def ssd_tile_legal(l: int, chunk: int, p: int, n: int,
                   smem_limit: int = H100_SMEM_OPTIN) -> bool:
    """Can the kernel scan ``l`` steps in chunks of ``chunk`` at head dim
    ``p`` and state ``n``?  The chunk must divide ``l`` and be 16, 32 or a
    multiple of 64 (the kernel's row tiles), ``(p, n)`` must be
    instantiated, and the staging must fit ``smem_limit`` — the card's
    opt-in shared memory per block."""
    if min(l, chunk, p, n) <= 0 or l % chunk:
        return False
    if _rows(chunk) not in (16, 32, 64) or chunk % _rows(chunk):
        return False
    if p not in KERNEL_HEAD_DIMS or n not in KERNEL_STATES:
        return False
    return ssd_smem_bytes(chunk, p, n) <= smem_limit


def ssd_grid_steps(b: int, l: int, h: int, chunk: int) -> int:
    """(batch, head, chunk) steps of one SSD call at chunk length
    ``chunk``."""
    return b * h * (l // chunk)


def ssd_proxy_problem(chunk: int, p: int, n: int,
                      steps_per_dim: int = 16) -> tuple:
    """(b, l, h, p, g, n) of the problem that measures ``chunk``.

    The device protocol (:mod:`repro_torch.tc.device`) times a config on
    this problem and models its per-step cost.  The reference's proxy is
    one batch and one head: one thread block here, on one of the card's
    132 SMs, timing its latency.  Here the proxy has :data:`PROXY_BLOCKS`
    heads (one group), each ``steps_per_dim`` chunks long, so it measures
    throughput: its per-step cost transfers to a problem that fills the
    card too, while one with fewer (batch, head) blocks than the card
    holds (mamba2-2.7b's 80 heads at batch 1) runs slower per step than
    that.
    """
    return (1, chunk * steps_per_dim, PROXY_BLOCKS, p, 1, n)


def _check(x, dt, a_log, b, c) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a_log.dim() != 1 or b.dim() != 4 \
            or b.shape != c.shape:
        raise ValueError("ssd needs x (B, L, H, P), dt (B, L, H), a_log (H,) "
                         "and b, c (B, L, G, N)")
    bsz, l, h, _ = x.shape
    if tuple(dt.shape) != (bsz, l, h) or tuple(a_log.shape) != (h,) or \
            tuple(b.shape[:2]) != (bsz, l):
        raise ValueError(f"ssd operand shapes disagree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, a_log {tuple(a_log.shape)},"
                         f" b {tuple(b.shape)}")
    if h % b.shape[2]:
        raise ValueError(f"H = {h} is not a multiple of G = {b.shape[2]}")
    devices = {t.device for t in (x, dt, a_log, b, c)}
    if len(devices) != 1:
        raise ValueError(f"operands on {sorted(map(str, devices))}")


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *,
              chunk: int) -> torch.Tensor:
    """The kernel's chunk loop in plain PyTorch, vectorised over batches
    and heads, carrying the float32 (B, H, P, N) state from chunk to
    chunk.  Per chunk the same arithmetic as the kernel: inclusive
    cumulative log-decay ``s``, ``G = (C B^T) * decay * dt`` with the
    decay exponentiated only on and below the diagonal, ``y = G X +
    exp(s) C h^T``, ``h = exp(s_Q) h + X^T (B * w)``."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    dev = x.device
    a = -torch.exp(a_log.float())                            # (H,)
    state = torch.zeros((bsz, h, p, n), device=dev)
    lower = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=dev).tril()
    ys = []
    for c0 in range(0, l, chunk):
        xc = x[:, c0:c0 + chunk].float().permute(0, 2, 1, 3)     # (B,H,Q,P)
        dtc = dt[:, c0:c0 + chunk].float().permute(0, 2, 1)      # (B,H,Q)
        bc = b[:, c0:c0 + chunk].float().permute(0, 2, 1, 3)     # (B,G,Q,N)
        cc = c[:, c0:c0 + chunk].float().permute(0, 2, 1, 3)
        bc = bc.repeat_interleave(rep, dim=1)                    # (B,H,Q,N)
        cc = cc.repeat_interleave(rep, dim=1)
        s = torch.cumsum(a[None, :, None] * dtc, dim=-1)         # (B,H,Q)
        seg = s[..., :, None] - s[..., None, :]
        decay = torch.exp(torch.where(lower, seg, -torch.inf))
        gm = (cc @ bc.transpose(-1, -2)) * decay * dtc[..., None, :]
        y = gm @ xc
        y = y + torch.exp(s)[..., None] * (cc @ state.transpose(-1, -2))
        w = dtc * torch.exp(s[..., -1:] - s)
        state = torch.exp(s[..., -1])[..., None, None] * state + \
            xc.transpose(-1, -2) @ (bc * w[..., None])
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(x.dtype)


def _launch(x, dt, a_log, b, c, y, chunk: int) -> None:
    lib = _build.load("ssd")
    fn = lib.repro_ssd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
             c.data_ptr(), y.data_ptr(), bsz, l, h, g, p, n, chunk, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"ssd kernel launch failed at chunk {chunk} for x "
                           f"{tuple(x.shape)}, b {tuple(b.shape)}: {msg} "
                           f"(cudaError {err})")


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """Chunked SSD scan.  x: (B, L, H, P); dt: (B, L, H); a_log: (H,);
    b, c: (B, L, G, N) with H % G == 0.  Returns (B, L, H, P).

    The chunk is clamped to L and must divide it, as in the reference.
    CUDA tensors launch the hand-written kernel on the current stream —
    contiguous float32, a chunk and (P, N) legal for the card — and
    anything the kernel does not take raises; CPU tensors run
    :func:`ssd_plain`.  ``ssd.launches`` counts kernel launches.
    """
    _check(x, dt, a_log, b, c)
    l, p, n = x.shape[1], x.shape[3], b.shape[3]
    chunk = min(chunk, l)
    if l <= 0 or l % chunk:
        raise ValueError(f"chunk {chunk} must divide L = {l}")
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a_log, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on CUDA or the CPU, not {x.device}")
    ops = (x, dt, a_log, b, c)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("the ssd kernel takes float32 operands, got "
                        f"{[str(t.dtype) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the ssd kernel takes contiguous operands")
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if not ssd_tile_legal(l, chunk, p, n, limit):
        raise ValueError(
            f"chunk {chunk} at (P, N) = ({p}, {n}) is not legal for the "
            f"kernel: the chunk must be 16, 32 or a multiple of {ROWS}, P in "
            f"{KERNEL_HEAD_DIMS}, N in {KERNEL_STATES}, and the staging "
            f"{ssd_smem_bytes(chunk, p, n)} B must fit {limit} B")
    y = torch.empty_like(x)
    _launch(x, dt, a_log, b, c, y, chunk)
    ssd.launches += 1
    return y


ssd.launches = 0
