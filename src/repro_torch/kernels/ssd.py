"""Mamba-2 SSD chunked scan: the hand-written Hopper kernels and their plain
version.

The counterpart of ``repro/kernels/ssd.py``.  The kernels are
``csrc/ssd.cu`` (FP32 FFMA), Mamba-2's chunk-parallel three-pass form:

1. ``ssd_chunk_state_kernel``, one block per (batch, head, chunk): the
   chunk's cumulative log-decay ``s`` and its own state contribution
   ``S_c = X^T (B * w)``, both written to scratch;
2. ``ssd_state_pass_kernel``: the short scan over chunks, turning each
   ``S_c`` in place into ``h_in[c]``, the state entering chunk ``c``,
   from an initial state ``h0`` (zero unless given), and writing the
   state after the last chunk where it is asked for;
3. ``ssd_chunk_scan_kernel``, one block per (batch, head, chunk, query
   tile): the outputs from the key slabs on and below the diagonal and
   from ``h_in[c]``.

Its note says what bounds each pass and why it is built so.  The
recurrence is ``h_t = h_{t-1} * exp(a dt_t) + dt_t x_t (x) b_t``,
``y_t = c_t . h_t`` with ``a = -exp(a_log)``, computed chunk-wise in the
dual form; no softplus on dt and no D skip (the kernel's contract).

:func:`ssd` dispatches on where its operands lie: CUDA tensors launch the
three kernels (or raise); CPU tensors take :func:`ssd_plain`, the same
three passes in plain PyTorch — the counterpart of Pallas
``interpret=True``.  There is no fall back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from . import _build
from ._card import H100_SMEM_OPTIN, PROXY_BLOCKS

#: head dims P and state sizes N the kernel is instantiated for
KERNEL_HEAD_DIMS: Tuple[int, ...] = (8, 16, 32, 64)
KERNEL_STATES: Tuple[int, ...] = (8, 16, 32, 64, 128)
#: rows of pass 3's query tiles and key slabs: min(chunk, ROWS)
ROWS = 64
#: pass 1: rows of a slab and slabs in its cp.async ring (fixed by design)
STATE_SLAB, STATE_STAGES = 16, 3


def _rows(chunk: int) -> int:
    return min(chunk, ROWS)


def ssd_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory the larger of the two staging passes takes, all
    float32.  Pass 3: the C rows of a query tile (R x N), a B slab (R x N),
    then either h_in (P x N) or, in the same space, an X slab (R x P) and
    the G^T tile (R x R), and s and dt of the chunk, with R = min(chunk,
    64).  Pass 1: a ring of three 16-row slabs of X and B, s and w of the
    chunk and the totals of its four warps."""
    r = _rows(chunk)
    scan = 2 * r * n + max(r * (p + r), p * n) + 2 * chunk
    state = STATE_STAGES * STATE_SLAB * (p + n) + 2 * chunk + 4
    return 4 * max(scan, state)


def ssd_chunk_legal(l: int, chunk: int) -> bool:
    """The length rule of :func:`ssd_tile_legal` alone: ``chunk`` divides
    ``l`` and is 16, 32 or a multiple of 64."""
    if min(l, chunk) <= 0 or l % chunk:
        return False
    return _rows(chunk) in (16, 32, 64) and chunk % _rows(chunk) == 0


def ssd_tile_legal(l: int, chunk: int, p: int, n: int,
                   smem_limit: int = H100_SMEM_OPTIN) -> bool:
    """Can the kernel scan ``l`` steps in chunks of ``chunk`` at head dim
    ``p`` and state ``n``?  The chunk must divide ``l`` and be 16, 32 or a
    multiple of 64 (the kernel's row tiles), ``(p, n)`` must be
    instantiated, and the staging must fit ``smem_limit`` — the card's
    opt-in shared memory per block."""
    if min(p, n) <= 0 or not ssd_chunk_legal(l, chunk):
        return False
    if p not in KERNEL_HEAD_DIMS or n not in KERNEL_STATES:
        return False
    return ssd_smem_bytes(chunk, p, n) <= smem_limit


def ssd_grid_steps(b: int, l: int, h: int, chunk: int) -> int:
    """(batch, head, chunk) steps of one SSD call at chunk length
    ``chunk``: the reference's grid, and the blocks of pass 1."""
    return b * h * (l // chunk)


def ssd_query_tiles(chunk: int) -> List[int]:
    """Pass 3's query tiles of a chunk in launch order: tile ``t`` holds
    rows ``t R .. t R + R - 1`` and visits ``t + 1`` key slabs, so the
    heaviest tiles come first (the kernel's outermost block index)."""
    nq = chunk // _rows(chunk)
    return [nq - 1 - i for i in range(nq)]


def ssd_key_slabs(tile: int) -> range:
    """The key slabs query tile ``tile`` visits: those on and below the
    diagonal.  A slab above it holds no pair ``i >= j``."""
    return range(tile + 1)


def ssd_scan_blocks(b: int, l: int, h: int, chunk: int) -> int:
    """Blocks of pass 3: one per (batch, head, chunk, query tile)."""
    return ssd_grid_steps(b, l, h, chunk) * (chunk // _rows(chunk))


def ssd_scratch_bytes(b: int, l: int, h: int, p: int, n: int,
                      chunk: int) -> int:
    """Bytes of the two scratches :func:`ssd` allocates on the card: the
    cumulative log-decay ``s`` (B, H, L) and the chunk states (B, H,
    L / chunk, P, N), float32."""
    return 4 * (b * h * l + ssd_grid_steps(b, l, h, chunk) * p * n)


def ssd_proxy_problem(chunk: int, p: int, n: int,
                      steps_per_dim: int = 16) -> tuple:
    """(b, l, h, p, g, n) of the problem that measures ``chunk``.

    The device protocol (:mod:`repro_torch.tc.device`) times a config on
    this problem and models its per-step cost.  The reference's proxy is
    one batch and one head.  Here the proxy has :data:`PROXY_BLOCKS` heads
    (one group), each ``steps_per_dim`` chunks long, so its pass 1
    launches ``PROXY_BLOCKS * steps_per_dim`` blocks and pass 3 as many
    times the query tiles of a chunk: it measures throughput.  A real
    problem fills the card the same way, since its blocks are per
    (batch, head, chunk) too: mamba2-2.7b at batch 1 and 4096 tokens
    launches 80 * 4096 / chunk >= 1,280 blocks in pass 1 at every chunk up
    to 256, so its per-step cost is the proxy's.
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


def _chunked(t: torch.Tensor, chunk: int, rep: int = 1) -> torch.Tensor:
    """(B, L, K, ...) float32 as (B, K * rep, L / chunk, chunk, ...):
    heads (or groups repeated to heads) before chunks and steps."""
    bsz, l, k = t.shape[:3]
    t = t.float().reshape(bsz, l // chunk, chunk, k, *t.shape[3:])
    t = t.movedim(3, 1)
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def _states(xc, dtc, bc, a_log, h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Passes 1 and 2 on chunked operands: s (B, H, C, Q), h_in
    (B, H, C, P, N) from the initial state ``h0`` (B, H, P, N; zero when
    None), and the state after the last chunk (B, H, P, N)."""
    a = -torch.exp(a_log.float())                             # (H,)
    s = torch.cumsum(a[:, None, None] * dtc, dim=-1)
    w = dtc * torch.exp(s[..., -1:] - s)
    states = xc.transpose(-1, -2) @ (bc * w[..., None])       # (B,H,C,P,N)
    decay = torch.exp(s[..., -1])                             # (B,H,C)
    h_in = torch.empty_like(states)
    carry = torch.zeros_like(states[:, :, 0]) if h0 is None else h0.float()
    for ci in range(states.shape[2]):
        h_in[:, :, ci] = carry
        carry = decay[:, :, ci, None, None] * carry + states[:, :, ci]
    return s, h_in, carry


def ssd_chunk_states_plain(x: torch.Tensor, dt: torch.Tensor,
                           a_log: torch.Tensor, b: torch.Tensor, *,
                           chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Passes 1 and 2 in plain PyTorch: ``s`` (B, H, L), each chunk's
    inclusive cumulative log-decay, and ``h_in`` (B, H, L / chunk, P, N),
    the state entering each chunk (zero for the first).

    Pass 1 forms every chunk's own contribution ``S_c = X^T (B * w)``,
    ``w = dt * exp(s_Q - s)``, by one batched product; pass 2 is the short
    scan over chunks, ``h_in[c] = h``, ``h = exp(s_Q) h + S_c``."""
    bsz, l, h, _ = x.shape
    dtc = _chunked(dt[..., None], chunk)[..., 0]
    s, h_in, _ = _states(_chunked(x, chunk), dtc,
                         _chunked(b, chunk, h // b.shape[2]), a_log)
    return s.reshape(bsz, h, l), h_in


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int,
              h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """The kernels' three passes in plain PyTorch, vectorised over
    batches, heads and chunks: :func:`ssd_chunk_states_plain` (its carry
    starting at ``h0`` where one is given), then per chunk
    ``G = (C B^T) * decay * dt`` with the decay exponentiated only on and
    below the diagonal, ``y = G X + exp(s) C h_in^T``.  With
    ``return_state`` it returns ``(y, h_final)``, the state after the last
    chunk in float32."""
    bsz, l, h, p = x.shape
    rep = h // b.shape[2]
    xc = _chunked(x, chunk)                                   # (B,H,C,Q,P)
    dtc = _chunked(dt[..., None], chunk)[..., 0]              # (B,H,C,Q)
    bc = _chunked(b, chunk, rep)                              # (B,H,C,Q,N)
    cc = _chunked(c, chunk, rep)
    s, h_in, h_final = _states(xc, dtc, bc, a_log, h0)
    lower = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=x.device).tril()
    seg = s[..., :, None] - s[..., None, :]
    decay = torch.exp(torch.where(lower, seg, -torch.inf))
    gm = (cc @ bc.transpose(-1, -2)) * decay * dtc[..., None, :]
    y = gm @ xc + torch.exp(s)[..., None] * (cc @ h_in.transpose(-1, -2))
    y = y.movedim(1, 3).reshape(bsz, l, h, p).to(x.dtype)
    return (y, h_final) if return_state else y


# ------------------------------------------------------------ launchers --

def _fn(name: str, n_ptr: int, n_int: int):
    """The C launcher ``name`` of the built library: ``n_ptr`` pointers,
    ``n_int`` ints and the stream, returning a cudaError_t."""
    lib = _build.load("ssd")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _call(name: str, what: str, ptrs, ints, device) -> None:
    """Launch ``name`` on ``device``'s current stream; a ``None`` among
    ``ptrs`` passes a null pointer."""
    lib, fn = _fn(name, len(ptrs), len(ints))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(None if t is None else t.data_ptr() for t in ptrs), *ints,
             stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"ssd {what} launch failed for {ints}: {msg} "
                           f"(cudaError {err})")


def ssd_scratch(x: torch.Tensor, b: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two scratches of one call, uninitialised on x's device: ``s``
    (B, H, L) and the chunk states (B, H, L / chunk, P, N), float32."""
    bsz, l, h, p = x.shape
    s = torch.empty((bsz, h, l), dtype=torch.float32, device=x.device)
    states = torch.empty((bsz, h, l // chunk, p, b.shape[3]),
                         dtype=torch.float32, device=x.device)
    return s, states


def _launch_chunk_state(x, dt, a_log, b, s, states, chunk: int) -> None:
    """Pass 1: ``s`` and each chunk's ``S_c`` into ``states``."""
    bsz, l, h, p = x.shape
    _call("repro_ssd_chunk_state", "chunk-state pass",
          (x, dt, a_log, b, s, states),
          (bsz, l, h, b.shape[2], p, b.shape[3], chunk), x.device)


def _launch_state_pass(s, states, chunk: int, h0=None,
                       h_final=None) -> None:
    """Pass 2: ``states`` from each chunk's ``S_c`` to ``h_in``, in
    place, the carry starting at ``h0`` (zero when None); the state after
    the last chunk goes to ``h_final`` when one is given."""
    bsz, h, _, p, n = states.shape
    _call("repro_ssd_state_pass", "state pass", (states, s, h0, h_final),
          (bsz, s.shape[2], h, p, n, chunk), s.device)


def _launch_chunk_scan(x, dt, b, c, s, states, y, chunk: int) -> None:
    """Pass 3: ``y`` from the key slabs and ``h_in``."""
    bsz, l, h, p = x.shape
    _call("repro_ssd_chunk_scan", "chunk-scan pass",
          (x, dt, b, c, s, states, y),
          (bsz, l, h, b.shape[2], p, b.shape[3], chunk), x.device)


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
        h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """Chunked SSD scan.  x: (B, L, H, P); dt: (B, L, H); a_log: (H,);
    b, c: (B, L, G, N) with H % G == 0.  Returns y (B, L, H, P), or
    ``(y, h_final)`` with ``return_state``: the (B, H, P, N) float32 state
    after the last step, which a model's decode continues from.  ``h0``
    (B, H, P, N) is the state before the first step (zero when None), as
    ``h0`` of the reference model's ``_ssd_chunked``.

    The chunk is clamped to L and must divide it, as in the reference.
    CUDA tensors launch the three hand-written kernels on the current
    stream — contiguous float32, a chunk and (P, N) legal for the card —
    and anything the kernels do not take raises; CPU tensors run
    :func:`ssd_plain`.  The kernels have no backward: on CUDA, with grad
    enabled, an operand that requires grad raises ``NotImplementedError``
    (on the CPU ``ssd_plain`` differentiates).  ``ssd.launches`` counts
    calls that launched the kernels: one per scan, three kernel launches
    inside.
    """
    _check(x, dt, a_log, b, c)
    l, p, n = x.shape[1], x.shape[3], b.shape[3]
    chunk = min(chunk, l)
    if l <= 0 or l % chunk:
        raise ValueError(f"chunk {chunk} must divide L = {l}")
    state_shape = (x.shape[0], x.shape[2], p, n)
    if h0 is not None and (tuple(h0.shape) != state_shape or
                           h0.device != x.device):
        raise ValueError(f"h0 must be {state_shape} on {x.device}, got "
                         f"{tuple(h0.shape)} on {h0.device}")
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a_log, b, c, chunk=chunk, h0=h0,
                         return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on CUDA or the CPU, not {x.device}")
    ops = (x, dt, a_log, b, c) + (() if h0 is None else (h0,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise NotImplementedError(
            "the ssd kernel has no backward yet, so a scan on the card "
            "cannot pass a gradient to its operands; it refuses rather than "
            "drop it (Mamba training on the card waits for an SSD backward "
            "kernel: ROADMAP.md Queue A item 9).  ssd_plain on CPU tensors "
            "is differentiable")
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("the ssd kernel takes float32 operands, got "
                        f"{[str(t.dtype) for t in ops]}")
    if not all(t.is_contiguous() for t in ops) or \
            (h0 is not None and h0.data_ptr() % 16):
        raise ValueError("the ssd kernel takes contiguous operands and a "
                         "16-byte aligned h0")
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if not ssd_tile_legal(l, chunk, p, n, limit):
        raise ValueError(
            f"chunk {chunk} at (P, N) = ({p}, {n}) is not legal for the "
            f"kernel: the chunk must be 16, 32 or a multiple of {ROWS}, P in "
            f"{KERNEL_HEAD_DIMS}, N in {KERNEL_STATES}, and the staging "
            f"{ssd_smem_bytes(chunk, p, n)} B must fit {limit} B")
    s, states = ssd_scratch(x, b, chunk)
    y = torch.empty_like(x)
    h_final = torch.empty(state_shape, dtype=torch.float32,
                          device=x.device) if return_state else None
    _launch_chunk_state(x, dt, a_log, b, s, states, chunk)
    _launch_state_pass(s, states, chunk, h0, h_final)
    _launch_chunk_scan(x, dt, b, c, s, states, y, chunk)
    ssd.launches += 1
    return (y, h_final) if return_state else y


ssd.launches = 0
