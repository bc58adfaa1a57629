"""Mamba-2 SSD chunked scan: the hand-written Hopper kernels and their plain
version.

The counterpart of ``repro/kernels/ssd.py``.  The kernels are
``csrc/ssd.cu``, Mamba-2's chunk-parallel three-pass form, passes 1 and 3
on the tensor cores as 3xTF32 by the route :func:`ssd_route` gives:
``"wgmma"`` at mamba2-2.7b's and jamba-v0.1-52b's (P, N) with a chunk that
is a multiple of 64 (TMA into an mbarrier ring, the operands split into
K-major TF32 tiles in the kernels, two warpgroups a block), ``"mma_sync"``
for the rest:

1. the chunk state, one block per (batch, chunk, two heads of a group,
   :func:`ssd_state_heads`): each head's cumulative log-decay ``s`` and its
   own state contribution ``S_c = X^T (B * w)``, both written to scratch,
   the B rows staged once for both heads;
2. ``ssd_state_pass_kernel``: the short scan over chunks, turning each
   ``S_c`` in place into ``h_in[c]``, the state entering chunk ``c``,
   from an initial state ``h0`` (zero unless given), and writing the
   state after the last chunk where it is asked for;
3. the chunk scan, one block per (batch, chunk, query tile,
   :func:`ssd_scan_heads` heads of a group): the outputs from ``h_in[c]``
   and from the key slabs on and below the diagonal; ``C B^T`` formed once
   a slab for all the block's heads (mma_sync), or once a group by a
   pre-pass into a scratch of :func:`ssd_cb_floats` floats (wgmma).

Its note says what bounds each pass and why it is built so.  The
recurrence is ``h_t = h_{t-1} * exp(a dt_t) + dt_t x_t (x) b_t``,
``y_t = c_t . h_t`` with ``a = -exp(a_log)``, computed chunk-wise in the
dual form; no softplus on dt and no D skip (the kernel's contract).

:func:`ssd` dispatches on where its operands lie: CUDA tensors launch the
kernels of their route (or raise); CPU tensors take :func:`ssd_plain`, the
same three passes in plain PyTorch — the counterpart of Pallas
``interpret=True``, and the plain version of both routes.  There is no
fall back from one to the other.  The
forward and the backward are ``torch.library`` operators
(``repro_torch::ssd_fwd`` and ``ssd_bwd``) with fake implementations,
autograd and flop formulas, so that a sharded step and a traced one reach
them; a fake tensor runs only the fake implementation.

Training.  When grad is enabled and an operand requires it, :func:`ssd`
runs :class:`SsdFn`: the same forward, which keeps its scratches (``s``
and the chunk-entry states), and a backward through :func:`ssd_bwd` -- on
CUDA tensors the hand-written kernels of ``csrc/ssd_bwd.cu`` (each
chunk's D_c, the reverse state pass over the chunks, the chunk backward
over a block of heads, a fixed-order finish; the products on the tensor
cores as 3xTF32) by the route :func:`ssd_bwd_route` gives: ``"wgmma"`` at
mamba2-2.7b's and jamba-v0.1-52b's (P, N) with a chunk that is a
multiple of 64 (split operand tiles in a scratch, C B^T formed once a
group, a producer warp streaming the tiles to one consumer warpgroup),
``"mma_sync"`` for the rest; on CPU tensors :func:`ssd_bwd_plain`, the
same passes.  No atomics, so two calls give the same bits.  The
reference has no backward kernel: it differentiates ``_ssd_chunked`` in
XLA.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ._card import H100_SMEM_OPTIN, PROXY_BLOCKS, card_smem, plain_route

#: head dims P and state sizes N the kernel is instantiated for
KERNEL_HEAD_DIMS: Tuple[int, ...] = (8, 16, 32, 64)
KERNEL_STATES: Tuple[int, ...] = (8, 16, 32, 64, 128)
#: rows of pass 3's query tiles and key slabs: min(chunk, ROWS)
ROWS = 64
#: pass 1: steps of a slab (fixed by design)
STATE_SLAB = 32
#: head lanes of the forward's blocks: the warps of a row group, one head
#: each (``kLanes`` in ``csrc/ssd.cu``); pass 1 takes this many heads
LANES = 2
#: the most heads a block of the forward's pass 3 takes (``kMaxHeads``;
#: :func:`ssd_scan_heads` picks the number)
SCAN_HEADS = 4
#: the forward's routes (:func:`ssd_route`)
ROUTES: Tuple[str, ...] = ("wgmma", "mma_sync")
#: (P, N) the forward's wgmma route takes, at a chunk that is a multiple
#: of :data:`ROWS`: mamba2-2.7b's and jamba-v0.1-52b's widths (the
#: backward's :data:`BWD_WGMMA_PN`)
WGMMA_PN: Tuple[Tuple[int, int], ...] = ((64, 128), (64, 16))
#: the wgmma route's pass-3 ring stages of up to ``WGMMA_RAW_BYTES``
#: (``NS3`` in ``csrc/ssd.cu``): at N above 64 and up to 64; pass 1's
#: (``NS1``)
WGMMA_SCAN_STAGES = (5, 8)
WGMMA_RAW_BYTES = 16384
WGMMA_STATE_STAGES = (3, 4)
#: steps the wgmma route's pass 1 scans at a time (``kScanSeg``)
WGMMA_SCAN_SEG = 256
#: threads of a block of the backward's reverse state pass (ii)
BWD_PASS_THREADS = 128
#: the most heads a block of the backward's chunk pass (iii) takes
#: (``kMaxHeads`` in ``csrc/ssd_bwd.cu``; :func:`ssd_bwd_heads` picks the
#: number).  10 at mamba2-2.7b's 80 heads timed 1 % faster than 8 at chunk
#: 256 and 3 % at chunk 64 on the H100, 16 11 % slower (PERF.md)
BWD_HEADS = 10
#: the backward's routes (:func:`ssd_bwd_route`)
BWD_ROUTES: Tuple[str, ...] = ("wgmma", "mma_sync")
#: (P, N) the backward's wgmma route takes, at a chunk that is a multiple
#: of :data:`ROWS`: mamba2-2.7b's and jamba-v0.1-52b's widths
BWD_WGMMA_PN: Tuple[Tuple[int, int], ...] = WGMMA_PN
#: the wgmma route's ring stages, units of ``BWD_UNIT_BYTES`` each (64 rows
#: of 32 depth steps, hi and lo): the chunk pass's at N above 64 and up to
#: 64 (``Wg::NS``), D_c's (``Wg::NSD``)
BWD_WGMMA_STAGES = (6, 9)
BWD_WGMMA_DSTATE_STAGES = 4
BWD_UNIT_BYTES = ROWS * 256


def _rows(chunk: int) -> int:
    return min(chunk, ROWS)


def _group_heads(h: int, g: int, most: int) -> int:
    """The largest divisor of a group's ``h // g`` heads that is at most
    ``most``: the heads of one block of a pass that takes a group's heads
    together."""
    rep = h // g
    return max(k for k in range(1, min(most, rep) + 1) if rep % k == 0)


def ssd_state_heads(h: int, g: int) -> int:
    """Heads of a block of the forward's pass 1: two of one group (one a
    head lane, the B rows staged once for both) where the group's heads
    are even in number, else one."""
    return _group_heads(h, g, LANES)


def ssd_scan_heads(h: int, g: int) -> int:
    """Heads of a block of the forward's pass 3: the largest divisor of a
    group's ``h // g`` heads up to :data:`SCAN_HEADS`.  The block forms
    ``C B^T`` once a key slab for all of them: 4 at mamba2-2.7b (80 heads,
    one group), 1,280 blocks at chunk 256."""
    return _group_heads(h, g, SCAN_HEADS)


def ssd_route(p: int, n: int, chunk: int) -> Optional[str]:
    """The forward kernels' route at head dim ``p``, state ``n`` and
    ``chunk``: ``"wgmma"`` at a (P, N) of :data:`WGMMA_PN` and a chunk that
    is a multiple of :data:`ROWS` (every forward of more than 32 steps the
    models run), ``"mma_sync"`` for every other instantiated (P, N) and for
    chunks 16 and 32, None where nothing is instantiated.  ``csrc/ssd.cu``'s
    ``route_of`` is the same table, and so is the backward's
    (:func:`ssd_bwd_route`)."""
    if p not in KERNEL_HEAD_DIMS or n not in KERNEL_STATES or chunk < 16 \
            or chunk % 16 or (chunk > 32 and chunk % ROWS):
        return None
    if (p, n) in WGMMA_PN and chunk % ROWS == 0:
        return "wgmma"
    return "mma_sync"


def ssd_route_table() -> str:
    """The forward's route table, for the message of a config it does not
    route."""
    return (f"wgmma: (P, N) in {WGMMA_PN}, chunk a multiple of {ROWS}; "
            f"mma_sync: P in {KERNEL_HEAD_DIMS}, N in {KERNEL_STATES}, chunk "
            f"16, 32 or a multiple of {ROWS}, where wgmma does not take it")


def _wgmma_smem(n: int) -> Tuple[int, int, int]:
    """(pass 1, C B^T, pass 3) shared memory of the wgmma route at state
    ``n`` (``WgShape`` in ``csrc/ssd.cu``), bytes with the 1024 that align
    the 128-byte swizzle; none depends on the chunk."""
    kun = -(-n // 32)
    nrw = min(n, 64)
    unit = ROWS * 256                       # a split unit, hi and lo
    ns1 = WGMMA_STATE_STAGES[0] if n > 64 else WGMMA_STATE_STAGES[1]
    ns3 = WGMMA_SCAN_STAGES[0] if n > 64 else WGMMA_SCAN_STAGES[1]
    state = (ns1 * (128 * n + 2 * 8192) + 3 * (n // nrw) * nrw * 256 +
             4 * LANES * WGMMA_SCAN_SEG + 4 * 2 * 2 * 32 + 4 * 2 * 8 +
             8 * 2 * ns1)
    cb = 2 * 256 * n + 2 * kun * unit + 8
    scan = (kun * unit + 4 * unit + ns3 * WGMMA_RAW_BYTES + 4 * 2 * 6 * ROWS +
            4 * SCAN_HEADS * ROWS + 8 * 2 * ns3)
    return 1024 + state, 1024 + cb, 1024 + scan


def ssd_cb_floats(b: int, l: int, g: int, p: int, n: int,
                  chunk: int) -> int:
    """Floats of the C B^T scratch the wgmma route's pass 3 takes
    (``repro_ssd_cb_floats``; 0 on the mma_sync route): a 64 x 64 float32
    tile for each query tile and key slab on or below it, a (batch, group,
    chunk), 2.6 MB at mamba2-2.7b's width and chunk 256."""
    if ssd_route(p, n, chunk) != "wgmma":
        return 0
    nq = chunk // ROWS
    return b * g * (l // chunk) * (nq * (nq + 1) // 2) * ROWS * ROWS


def ssd_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory the larger of the two staging passes takes on the
    route :func:`ssd_route` gives (``repro_ssd_smem_bytes`` in
    ``csrc/ssd.cu``).

    wgmma (``WgShape``): pass 3 the query tile's C rows as K-major split
    units (64 rows x 32 depth, hi and lo: 16 KB a unit, N padded to 32),
    two split slots a warpgroup, a ring of raw stages of
    :data:`WGMMA_RAW_BYTES` (:data:`WGMMA_SCAN_STAGES`), each warpgroup's s
    and dt of a slab, s of the tile's rows for :data:`SCAN_HEADS` heads,
    the mbarriers; its C B^T pre-pass the raw C and B rows of a tile pair
    and both split; pass 1 a ring of raw stages (32 steps of B and of two
    heads' X), three B^T split tiles, the scan's segment of
    :data:`WGMMA_SCAN_SEG` steps, w of two units, the scan's warp totals,
    the mbarriers; each with 1024 bytes to align the swizzle.  216,144
    bytes at (64, 128) (pass 3; pass 1 200,304, C B^T 197,640), 216,192 at
    (64, 16), at any chunk.

    mma_sync, all float32 (``ScanShape`` and ``StateShape``).  Pass 3:
    the C rows of a query tile (R x N); two step buffers, each the larger
    of a pair of heads' h_in (2 x P x N) and a key slab's B rows (R x N)
    with two heads' X rows (R x P), s and dt (2 R); the swap of the C B^T
    halves (R x R); s of the tile's rows for :data:`SCAN_HEADS` heads; R =
    min(chunk, 64).  Pass 1: two slab buffers of the B rows (32 x N) and
    two heads' X rows (32 x P), w of the chunk for two heads, and two
    totals of each of its warps."""
    if ssd_route(p, n, chunk) == "wgmma":
        return max(_wgmma_smem(n))
    r = _rows(chunk)
    step = max(r * n + LANES * (r * p + 2 * r), LANES * p * n)
    scan = r * n + 2 * step + r * r + SCAN_HEADS * r
    warps = LANES * -(-p // 16)
    state = 2 * STATE_SLAB * (n + LANES * p) + LANES * (chunk + warps)
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
    instantiated (so :func:`ssd_route` routes it), and the staging on its
    route must fit ``smem_limit`` — the card's opt-in shared memory per
    block."""
    if min(p, n) <= 0 or not ssd_chunk_legal(l, chunk):
        return False
    if ssd_route(p, n, chunk) is None:
        return False
    return ssd_smem_bytes(chunk, p, n) <= smem_limit


def ssd_grid_steps(b: int, l: int, h: int, chunk: int) -> int:
    """(batch, head, chunk) steps of one SSD call at chunk length
    ``chunk``: the reference's grid.  Pass 1 launches one block per
    :func:`ssd_state_heads` of them."""
    return b * h * (l // chunk)


def ssd_query_tiles(chunk: int) -> List[int]:
    """Pass 3's query tiles of a chunk in launch order: tile ``t`` holds
    rows ``t R .. t R + R - 1`` and visits ``t + 1`` key slabs, so the
    heaviest tiles come first: the mma_sync kernel's outermost block index
    (the one-slab tiles fill the tail of the last wave), the wgmma
    kernel's innermost (a chunk's tiles run together, their reads of the
    same h_in and X rows meeting in L2)."""
    nq = chunk // _rows(chunk)
    return [nq - 1 - i for i in range(nq)]


def ssd_key_slabs(tile: int) -> range:
    """The key slabs query tile ``tile`` visits: those on and below the
    diagonal.  A slab above it holds no pair ``i >= j``."""
    return range(tile + 1)


def ssd_scan_blocks(b: int, l: int, h: int, chunk: int,
                    heads: int = 1) -> int:
    """Blocks of pass 3: one per (batch, chunk, query tile) and block of
    ``heads`` heads (:func:`ssd_scan_heads`)."""
    return ssd_grid_steps(b, l, h // heads, chunk) * (chunk // _rows(chunk))


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
    launches ``PROXY_BLOCKS * steps_per_dim / 2`` blocks (two heads a
    block) and pass 3 a quarter of ``PROXY_BLOCKS * steps_per_dim`` times
    the query tiles of a chunk (four heads a block): it measures
    throughput.  A real problem fills the card the same way, since its
    blocks are per (batch, chunk, heads of a group) too: mamba2-2.7b at
    batch 1 and 4096 tokens launches 40 * 4096 / chunk >= 640 blocks in
    pass 1 at every chunk up to 256, so its per-step cost is the proxy's.
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


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working dtype: float64 stays float64
    (the gradient tests' oracle), anything else computes in float32."""
    return t if t.dtype == torch.float64 else t.float()


def _chunked(t: torch.Tensor, chunk: int, rep: int = 1) -> torch.Tensor:
    """(B, L, K, ...) in the working dtype as (B, K * rep, L / chunk,
    chunk, ...): heads (or groups repeated to heads) before chunks and
    steps."""
    bsz, l, k = t.shape[:3]
    t = _acc(t).reshape(bsz, l // chunk, chunk, k, *t.shape[3:])
    t = t.movedim(3, 1)
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def _unchunked(t: torch.Tensor) -> torch.Tensor:
    """(B, K, C, Q, ...) back to (B, C Q, K, ...): the inverse of
    :func:`_chunked` without the repeat."""
    bsz, k, nc, q = t.shape[:4]
    return t.movedim(1, 3).reshape(bsz, nc * q, k, *t.shape[4:])


def _states(xc, dtc, bc, a_log, h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Passes 1 and 2 on chunked operands: s (B, H, C, Q), h_in
    (B, H, C, P, N) from the initial state ``h0`` (B, H, P, N; zero when
    None), and the state after the last chunk (B, H, P, N)."""
    a = -torch.exp(_acc(a_log))                               # (H,)
    s = torch.cumsum(a[:, None, None] * dtc, dim=-1)
    w = dtc * torch.exp(s[..., -1:] - s)
    states = xc.transpose(-1, -2) @ (bc * w[..., None])       # (B,H,C,P,N)
    decay = torch.exp(s[..., -1])                             # (B,H,C)
    h_in = torch.empty_like(states)
    carry = torch.zeros_like(states[:, :, 0]) if h0 is None else \
        h0.to(states.dtype)
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


def _plain_parts(x, dt, a_log, b, c, chunk: int, h0=None):
    """The three passes in plain PyTorch: (y in x's dtype, h_final, s
    (B, H, L), h_in (B, H, L / chunk, P, N)), the last three in the
    working dtype; s and h_in are what the kernels leave in their
    scratches, and what the backward takes."""
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
    return (_unchunked(y).to(x.dtype), h_final, s.reshape(bsz, h, l),
            h_in)


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int,
              h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """The kernels' three passes in plain PyTorch, vectorised over
    batches, heads and chunks: :func:`ssd_chunk_states_plain` (its carry
    starting at ``h0`` where one is given), then per chunk
    ``G = (C B^T) * decay * dt`` with the decay exponentiated only on and
    below the diagonal, ``y = G X + exp(s) C h_in^T``.  With
    ``return_state`` it returns ``(y, h_final)``, the state after the last
    chunk in float32 (float64 for float64 operands, which the plain
    versions keep)."""
    y, h_final, _, _ = _plain_parts(x, dt, a_log, b, c, chunk, h0)
    return (y, h_final) if return_state else y


def ssd_state_grads_plain(c: torch.Tensor, s: torch.Tensor,
                          h_in: torch.Tensor, dy: torch.Tensor,
                          dh_final: Optional[torch.Tensor] = None, *,
                          chunk: int):
    """The backward's passes (i) and (ii) in plain PyTorch: ``(dS, ds_q,
    dh0)``.  dS (B, H, L / chunk, P, N) holds, for each chunk c, the
    gradient of the state leaving it (``dS_c``, the one entering chunk
    c + 1; ``dh_final`` for the last); ds_q (B, H, L / chunk) the gradient
    of each chunk's last log-decay through its carry, ``exp(s_Q) <dS_c,
    h_in[c]>``; dh0 the gradient of the state entering the first chunk.

    Pass (i) forms each chunk's ``D_c = sum_i exp(s_i) dy_i c_i^T``, the
    state's gradient through the chunk's own outputs; pass (ii) walks the
    chunks backwards from ``g = dh_final`` (zero when None): ``dS_c = g``,
    ``g = D_c + exp(s_Q) g``.  In the working dtype."""
    bsz, l, h, _ = dy.shape
    dyc = _chunked(dy, chunk)                                 # (B,H,C,Q,P)
    cc = _chunked(c, chunk, h // c.shape[2])                  # (B,H,C,Q,N)
    es = torch.exp(_acc(s).reshape(dyc.shape[:4]))
    e_q = es[..., -1]                                         # (B,H,C)
    h_in = _acc(h_in)
    d_c = (dyc * es[..., None]).transpose(-1, -2) @ cc        # (B,H,C,P,N)
    g = torch.zeros_like(d_c[:, :, 0]) if dh_final is None else \
        _acc(dh_final)
    d_s = torch.empty_like(d_c)
    ds_q = torch.empty_like(e_q)
    for ci in reversed(range(d_c.shape[2])):
        d_s[:, :, ci] = g
        ds_q[:, :, ci] = e_q[:, :, ci] * (g * h_in[:, :, ci]).sum((-1, -2))
        g = d_c[:, :, ci] + e_q[:, :, ci, None, None] * g
    return d_s, ds_q, g


def ssd_bwd_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
                  h_in: torch.Tensor, dy: torch.Tensor,
                  dh_final: Optional[torch.Tensor] = None, *, chunk: int):
    """The backward kernels' four passes in plain PyTorch, vectorised over
    batches, heads and chunks: ``(dx, ddt, da_log, db, dc, dh0)``.

    ``s`` (B, H, L) and ``h_in`` (B, H, L / chunk, P, N) are the forward's
    (its scratches on the card, :func:`_plain_parts` here); ``dy`` is y's
    gradient and ``dh_final`` the final state's (zero when None).  Per
    (batch, head, chunk), with ``L_ij = exp(s_i - s_j)`` on and below the
    diagonal, ``G = (C B^T) L dt``, ``w = dt exp(s_Q - s)``:

    1. and 2. :func:`ssd_state_grads_plain`: each chunk's outgoing state
       gradient ``dS_c``, ``ds_Q += exp(s_Q) <dS_c, h_in[c]>`` and dh0;
    3. per chunk, with ``dG = dY X^T`` and ``M = dG L dt``: ``dx = G^T dY
       + w (B dS^T)``, ``dc = M B + exp(s) dY h_in``, ``db = M^T C + w (X
       dS)``, ``ddt = colsum(dG (C B^T) L) + exp(s_Q - s) u`` with ``u_j =
       x_j^T dS b_j``, and ``ds`` from the decay (row sums less column sums
       of ``E = M (C B^T)``), from the state term and from ``w``;
    4. ``r``, the reverse cumulative sum of ``ds`` within each chunk:
       ``ddt += a r``, ``da_log = a sum(dt r)``; db and dc summed over the
       heads of each group.

    Every sum is in the working dtype (float64 operands stay float64);
    results come back in their operands' dtypes, ``dh0`` in the working
    dtype.
    """
    bsz, l, h, p = x.shape
    rep = h // b.shape[2]
    d_s, ds_q, dh0 = ssd_state_grads_plain(c, s, h_in, dy, dh_final,
                                           chunk=chunk)
    xc, dyc = _chunked(x, chunk), _chunked(dy, chunk)         # (B,H,C,Q,P)
    dtc = _chunked(dt[..., None], chunk)[..., 0]              # (B,H,C,Q)
    bc, cc = _chunked(b, chunk, rep), _chunked(c, chunk, rep)
    sc = _acc(s).reshape(dtc.shape)
    h_in = _acc(h_in)
    a = -torch.exp(_acc(a_log))
    es = torch.exp(sc)
    w = dtc * torch.exp(sc[..., -1:] - sc)
    # 3. the chunk backward
    lower = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=x.device).tril()
    seg = sc[..., :, None] - sc[..., None, :]
    decay = torch.exp(torch.where(lower, seg, -torch.inf))
    cb = cc @ bc.transpose(-1, -2)
    d_g = dyc @ xc.transpose(-1, -2)
    gm = cb * decay * dtc[..., None, :]
    m = d_g * decay * dtc[..., None, :]
    e = m * cb
    v = xc @ d_s                                              # (B,H,C,Q,N)
    u = (v * bc).sum(-1)
    hc = dyc @ h_in                                           # (B,H,C,Q,N)
    dx = gm.transpose(-1, -2) @ dyc + w[..., None] * (bc @ d_s.transpose(
        -1, -2))
    dcc = m @ bc + es[..., None] * hc
    dbc = m.transpose(-1, -2) @ cc + w[..., None] * v
    ddt = (d_g * cb * decay).sum(-2) + torch.exp(sc[..., -1:] - sc) * u
    ds = e.sum(-1) - e.sum(-2) + es * (hc * cc).sum(-1) - u * w
    ds[..., -1] += ds_q + (u * w).sum(-1)
    # 4. s = cumsum(a dt) within each chunk
    r = ds.flip(-1).cumsum(-1).flip(-1)
    ddt = ddt + a[:, None, None] * r
    da_log = a * (dtc * r).sum((0, 2, 3))

    def grouped(t):
        t = _unchunked(t)                                     # (B,L,H,N)
        return t.reshape(bsz, l, h // rep, rep, -1).sum(3)

    return (_unchunked(dx).to(x.dtype),
            _unchunked(ddt[..., None])[..., 0].to(dt.dtype),
            da_log.to(a_log.dtype), grouped(dbc).to(b.dtype),
            grouped(dcc).to(c.dtype), dh0)


# ------------------------------------------------------------ launchers --

def _fn(name: str, n_ptr: int, n_int: int, lib_name: str = "ssd"):
    """The C launcher ``name`` of the built library ``lib_name``:
    ``n_ptr`` pointers, ``n_int`` ints and the stream, returning a
    cudaError_t."""
    lib = _build.load(lib_name)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _call(name: str, what: str, ptrs, ints, device,
          lib_name: str = "ssd") -> None:
    """Launch ``name`` on ``device``'s current stream; a ``None`` among
    ``ptrs`` passes a null pointer."""
    lib, fn = _fn(name, len(ptrs), len(ints), lib_name)
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


def _launch_chunk_state(x, dt, a_log, b, s, states, chunk: int,
                        heads: Optional[int] = None) -> None:
    """Pass 1: ``s`` and each chunk's ``S_c`` into ``states``, ``heads``
    heads a block (:func:`ssd_state_heads` when None)."""
    bsz, l, h, p = x.shape
    g = b.shape[2]
    heads = ssd_state_heads(h, g) if heads is None else heads
    _call("repro_ssd_chunk_state", "chunk-state pass",
          (x, dt, a_log, b, s, states),
          (bsz, l, h, g, p, b.shape[3], chunk, heads), x.device)


def _launch_state_pass(s, states, chunk: int, h0=None,
                       h_final=None) -> None:
    """Pass 2: ``states`` from each chunk's ``S_c`` to ``h_in``, in
    place, the carry starting at ``h0`` (zero when None); the state after
    the last chunk goes to ``h_final`` when one is given."""
    bsz, h, _, p, n = states.shape
    _call("repro_ssd_state_pass", "state pass", (states, s, h0, h_final),
          (bsz, s.shape[2], h, p, n, chunk), s.device)


def _launch_chunk_scan(x, dt, b, c, s, states, y, chunk: int,
                       heads: Optional[int] = None) -> None:
    """Pass 3: ``y`` from ``h_in`` and the key slabs, ``heads`` heads a
    block (:func:`ssd_scan_heads` when None); on the wgmma route its C B^T
    pre-pass first, into a scratch of :func:`ssd_cb_floats` floats."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    heads = ssd_scan_heads(h, g) if heads is None else heads
    size = ssd_cb_floats(bsz, l, g, p, n, chunk)
    cb = torch.empty((size,), dtype=torch.float32, device=x.device) \
        if size else None
    _call("repro_ssd_chunk_scan", "chunk-scan pass",
          (x, dt, b, c, s, states, cb, y),
          (bsz, l, h, g, p, n, chunk, heads), x.device)


def _prepare(x, dt, a_log, b, c, chunk: int, h0) -> int:
    """Validate one call; return the chunk clamped to L."""
    _check(x, dt, a_log, b, c)
    l = x.shape[1]
    chunk = min(chunk, l)
    if l <= 0 or l % chunk:
        raise ValueError(f"chunk {chunk} must divide L = {l}")
    state_shape = (x.shape[0], x.shape[2], x.shape[3], b.shape[3])
    if h0 is not None and (tuple(h0.shape) != state_shape or
                           h0.device != x.device):
        raise ValueError(f"h0 must be {state_shape} on {x.device}, got "
                         f"{tuple(h0.shape)} on {h0.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd runs on CUDA or the CPU, not {x.device}")
    return chunk


def _card_legal(ops, l: int, chunk: int, p: int, n: int) -> None:
    """Raise unless the kernels (forward and backward) take these
    operands' shapes and dtypes: contiguous float32, a legal chunk and
    (P, N) whose staging fits the card.  Reads no data, so a fake tensor
    is checked as a real one."""
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("the ssd kernels take float32 operands, got "
                        f"{[str(t.dtype) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("the ssd kernels take contiguous, 16-byte aligned "
                         "operands")
    limit = card_smem(ops[0])
    if not ssd_tile_legal(l, chunk, p, n, limit):
        raise ValueError(
            f"chunk {chunk} at (P, N) = ({p}, {n}) is not legal for the "
            f"kernel: a route must take it ({ssd_route_table()}) and the "
            f"staging {ssd_smem_bytes(chunk, p, n)} B must fit {limit} B")


def _card_ready(ops, l: int, chunk: int, p: int, n: int) -> None:
    """:func:`_card_legal`, and every operand 16-byte aligned."""
    _card_legal(ops, l, chunk, p, n)
    if not all(t.data_ptr() % 16 == 0 for t in ops):
        raise ValueError("the ssd kernels take contiguous, 16-byte aligned "
                         "operands")


def _kernel_parts(x, dt, a_log, b, c, chunk: int, h0, want_state: bool):
    """The three forward kernels: (y, h_final or None, s, h_in), the last
    two the scratches pass 2 leaves (``s`` and the chunk-entry states),
    which the backward takes."""
    s, states = ssd_scratch(x, b, chunk)
    y = torch.empty_like(x)
    h_final = torch.empty((x.shape[0], x.shape[2], x.shape[3], b.shape[3]),
                          dtype=torch.float32,
                          device=x.device) if want_state else None
    route = ssd_route(x.shape[3], b.shape[3], chunk)
    if route is None:
        raise ValueError(f"no forward route takes chunk {chunk} at (P, N) = "
                         f"({x.shape[3]}, {b.shape[3]}): {ssd_route_table()}")
    _launch_chunk_state(x, dt, a_log, b, s, states, chunk)
    _launch_state_pass(s, states, chunk, h0, h_final)
    _launch_chunk_scan(x, dt, b, c, s, states, y, chunk)
    ssd.launches += 1
    ssd.route_launches[route] += 1
    return y, h_final, s, states


def ssd_bwd_pass_blocks(p: int, n: int) -> int:
    """Blocks of the reverse state pass (ii) per (batch, head): 128
    threads, one float4 of the (P, N) state each."""
    return -(-(p * n // 4) // BWD_PASS_THREADS)


def ssd_bwd_heads(h: int, g: int) -> int:
    """Heads of a chunk-pass block: the largest divisor of a group's
    ``h // g`` heads that is at most :data:`BWD_HEADS`.  A block sums db
    and dc over its heads in registers, so the scratch the finish pass
    adds holds ``h // (g * heads)`` partials a group in place of ``h // g``
    heads: 10 at mamba2-2.7b (80 heads, one group) gives 8 partials and,
    at chunk 256, 512 blocks of one an SM."""
    return _group_heads(h, g, BWD_HEADS)


def ssd_bwd_route(p: int, n: int, chunk: int) -> Optional[str]:
    """The backward kernels' route at head dim ``p``, state ``n`` and
    ``chunk``: ``"wgmma"`` at a (P, N) of :data:`BWD_WGMMA_PN` and a chunk
    that is a multiple of :data:`ROWS` (every backward the models run),
    ``"mma_sync"`` for every other instantiated (P, N) and for chunks 16
    and 32, None where nothing is instantiated: the forward's table
    (:func:`ssd_route`).  ``csrc/ssd_bwd.cu``'s ``route_of`` is the same
    table."""
    return ssd_route(p, n, chunk)


def ssd_bwd_route_table() -> str:
    """The backward's route table, for the message of a config it does
    not route."""
    return (f"wgmma: (P, N) in {BWD_WGMMA_PN}, chunk a multiple of {ROWS};"
            f" mma_sync: P in {KERNEL_HEAD_DIMS}, N in {KERNEL_STATES}, "
            f"chunk 16, 32 or a multiple of {ROWS}, where wgmma does not "
            f"take it")


def _wgmma_units(p: int, n: int) -> dict:
    """The wgmma route's tile units (``Wg`` in ``csrc/ssd_bwd.cu``):
    depth N padded to 32 in ``kun`` units of 32, depth P in ``kup``, a
    tile of N rows in ``rhn`` row blocks of ``nr`` rows."""
    nr = min(n, ROWS)
    return {"kun": max(n, 32) // 32, "kup": p // 32, "nr": nr,
            "rhn": n // nr}


def ssd_bwd_smem_bytes(chunk: int, p: int, n: int) -> int:
    """Shared memory of the backward's chunk pass (iii), its largest, on
    the route :func:`ssd_bwd_route` gives.

    wgmma (``Wg`` in ``csrc/ssd_bwd.cu``): 1024 bytes to align the
    128-byte swizzle, the role's own C_t or B_t as split units (64 rows x
    N padded to 32, hi and lo) and the head's dY_t or X_t (64 x P), a
    head's dx sums (64 x P float32), a ring of units of
    :data:`BWD_UNIT_BYTES` (:data:`BWD_WGMMA_STAGES`: 6 at N = 128, 9 at
    N = 16), each stage's s and dt of a slab (128 floats), the query role's
    row sums (:data:`BWD_HEADS` x 64), u w of two heads (2 x 64) and the
    mbarriers (two a stage, four more): 220,288 bytes at (64, 128),
    221,872 at (64, 16).

    mma_sync, all float32 (``ChunkShape``): the tile's own C or B rows
    (R x N); two head buffers of a head's dY or X rows (R x P) with its s
    and dt (2 R); two slab buffers of B_k or C_k, or a head's h_in or dS
    (max(R, P) x N), with X_k or dY_k (R x P) and s, dt (2 R); each warp's
    dx sums of a head (2 x R x P); and the row sums (2 x :data:`BWD_HEADS`
    x R for the query role's heads, 3 x 2 x R for the key role's).  R =
    min(chunk, 64)."""
    if ssd_bwd_route(p, n, chunk) == "wgmma":
        w = _wgmma_units(p, n)
        ns = BWD_WGMMA_STAGES[0] if n > 64 else BWD_WGMMA_STAGES[1]
        return (1024 + (w["kun"] + w["kup"]) * BWD_UNIT_BYTES +
                4 * ROWS * p + ns * BWD_UNIT_BYTES + 4 * ns * 128 +
                4 * BWD_HEADS * ROWS + 4 * 2 * ROWS + 8 * (2 * ns + 4))
    r = _rows(chunk)
    own = r * n
    head = r * p + 2 * r
    slab = max(r, p) * n + r * p + 2 * r
    rows = (2 * BWD_HEADS + 6) * r
    return 4 * (own + 2 * head + 2 * slab + 2 * r * p + rows)


def ssd_bwd_dstate_smem_bytes() -> int:
    """Shared memory of the wgmma route's D_c pass (``Wg::kDSmem``, the
    same at both of its (P, N)): the alignment, a ring of
    :data:`BWD_WGMMA_DSTATE_STAGES` units, each stage's s (128 floats) and
    two mbarriers a stage: 68,672 bytes."""
    ns = BWD_WGMMA_DSTATE_STAGES
    return 1024 + ns * BWD_UNIT_BYTES + 4 * ns * 128 + 8 * 2 * ns


def ssd_bwd_split_floats(b: int, l: int, h: int, g: int, p: int, n: int,
                         chunk: int) -> int:
    """Floats of the split scratch the wgmma route writes once a call
    (``split_layout`` in ``csrc/ssd_bwd.cu``; 0 on the mma_sync route):
    x and dy as split tiles of 64 steps x P and dy^T as P x 64 steps a
    (batch, head, slab); b and c as 64 steps x N and N x 64 steps a (batch,
    group, slab); h_in^T and dS^T as N x P and dS as P x N a (batch, head,
    chunk); dt as (B, H, L); and each chunk's C B^T tiles, 64 x 64 float32
    with their transposes, for every query tile and key slab on or below
    it a (batch, group, chunk).  A split tile holds each value twice (hi
    and lo), depth N padded to 32."""
    if ssd_bwd_route(p, n, chunk) != "wgmma":
        return 0
    w = _wgmma_units(p, n)
    per_h = b * h * (l // ROWS)
    per_g = b * g * (l // ROWS)
    states = b * h * (l // chunk)
    nat_p = w["kup"] * ROWS * 64
    nat_n = w["kun"] * ROWS * 64
    time_p = 2 * ROWS * 64
    time_n = 2 * w["rhn"] * w["nr"] * 64
    state_t = w["kup"] * w["rhn"] * w["nr"] * 64
    state_n = w["kun"] * ROWS * 64
    nq = chunk // ROWS
    pairs = b * g * (l // chunk) * (nq * (nq + 1) // 2)
    return (per_h * (2 * nat_p + time_p) + per_g * 2 * (nat_n + time_n) +
            states * (2 * state_t + state_n) + b * h * l +
            pairs * 2 * ROWS * ROWS)


def ssd_bwd_legal(l: int, chunk: int, p: int, n: int,
                  smem_limit: int = H100_SMEM_OPTIN) -> bool:
    """Can the backward kernels take what :func:`ssd_tile_legal` admits
    for the forward at ``(l, chunk, p, n)``?  The same rule, and the chunk
    pass's staging (:func:`ssd_bwd_smem_bytes`) must fit ``smem_limit``:
    at every instantiated (P, N) and chunk it does on the H100."""
    return ssd_tile_legal(l, chunk, p, n, smem_limit) and \
        ssd_bwd_smem_bytes(chunk, p, n) <= smem_limit


def _working(x: torch.Tensor) -> torch.dtype:
    """The dtype of the scan's states and scratches: float64 for float64
    operands (the plain versions keep it), else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


# ------------------------------------------------------------ operators --
# The forward and the backward are torch.library operators, so that the
# dispatcher sees them: a fake tensor (a traced step, ``launch.dryrun``)
# runs the fake implementation, which only shapes the outputs, and
# FlopCounterMode reads the formulas below.  The real implementation is
# the kernels (CUDA) or the plain passes (CPU).  The wrappers call the
# operators for CUDA and fake tensors; a real CPU tensor runs the plain
# passes as it always has, visible to a dispatch mode.

@torch.library.custom_op("repro_torch::ssd_fwd", mutates_args=())
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, h0: Optional[torch.Tensor],
            chunk: int, want_state: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """(y, h_final, s, h_in): h_final an empty tensor without
    ``want_state``; s (B, H, L) and h_in (B, H, L / chunk, P, N) the
    scratches the backward takes."""
    if x.device.type == "cpu":
        y, h_final, s, h_in = _plain_parts(x, dt, a_log, b, c, chunk, h0)
        y, s, h_in = y.contiguous(), s.contiguous(), h_in.contiguous()
    else:
        ops = (x, dt, a_log, b, c) + (() if h0 is None else (h0,))
        _card_ready(ops, x.shape[1], chunk, x.shape[3], b.shape[3])
        y, h_final, s, h_in = _kernel_parts(x, dt, a_log, b, c, chunk, h0,
                                            want_state)
    if not want_state:
        h_final = s.new_empty((0,))
    return y, h_final, s, h_in


@_ssd_op.register_fake
def _(x, dt, a_log, b, c, h0, chunk, want_state):
    bsz, l, h, p = x.shape
    n = b.shape[3]
    work = dict(dtype=_working(x), device=x.device)
    h_final = x.new_empty((bsz, h, p, n) if want_state else (0,),
                          dtype=work["dtype"])
    return (torch.empty_like(x), h_final, x.new_empty((bsz, h, l), **work),
            x.new_empty((bsz, h, l // chunk, p, n), **work))


def _ssd_setup(ctx, inputs, output) -> None:
    x, dt, a_log, b, c, h0, chunk, _ = inputs
    _, _, s, h_in = output
    ctx.save_for_backward(x, dt, a_log, b, c, s, h_in)
    ctx.chunk, ctx.has_h0 = chunk, h0 is not None


def _ssd_backward(ctx, dy, dh_final, *_):
    x, dt, a_log, b, c, s, h_in = ctx.saved_tensors
    dy = torch.zeros_like(x) if dy is None else dy.contiguous()
    if dh_final is not None:
        dh_final = dh_final.contiguous()
    dx, ddt, da_log, db, dc, dh0 = ssd_bwd(
        x, dt, a_log, b, c, s, h_in, dy, dh_final, chunk=ctx.chunk)
    return (dx, ddt, da_log, db, dc, dh0 if ctx.has_h0 else None, None,
            None)


_ssd_op.register_autograd(_ssd_backward, setup_context=_ssd_setup)


@torch.library.custom_op("repro_torch::ssd_bwd", mutates_args=())
def _ssd_bwd_op(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
                h_in: torch.Tensor, dy: torch.Tensor,
                dh_final: Optional[torch.Tensor], chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, ddt, da_log, db, dc, dh0): the four backward kernels on CUDA
    tensors, :func:`ssd_bwd_plain` on CPU tensors."""
    if x.device.type == "cpu":
        return tuple(t.contiguous() for t in ssd_bwd_plain(
            x, dt, a_log, b, c, s, h_in, dy, dh_final, chunk=chunk))
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = l // chunk
    ops = (x, dt, a_log, b, c, s, h_in, dy) + \
        (() if dh_final is None else (dh_final,))
    _card_ready(ops, l, chunk, p, n)
    rep = h // g
    heads = ssd_bwd_heads(h, g)
    route = ssd_bwd_route(p, n, chunk)
    if route is None:
        raise ValueError(f"no backward route takes chunk {chunk} at (P, N) ="
                         f" ({p}, {n}): {ssd_bwd_route_table()}")
    f32 = dict(dtype=torch.float32, device=x.device)
    nq = chunk // _rows(chunk)
    d_s = torch.empty((bsz, h, nc, p, n), **f32)
    dsq_pass = torch.empty((bsz, h, nc, ssd_bwd_pass_blocks(p, n)), **f32)
    dsq_scan = torch.empty((bsz, h, nc, nq), **f32)
    ds, ddt_part = (torch.empty((bsz, h, l), **f32) for _ in range(2))
    db_part, dc_part = (torch.empty((bsz, l, g * (rep // heads), n), **f32)
                        for _ in range(2))
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    da_log = torch.empty_like(a_log)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    dh0 = torch.empty((bsz, h, p, n), **f32)
    split = torch.empty((ssd_bwd_split_floats(bsz, l, h, g, p, n, chunk),),
                        **f32) if route == "wgmma" else None
    _call("repro_ssd_bwd", "backward",
          (x, dt, a_log, b, c, dy, s, h_in, dh_final, d_s, dsq_pass,
           dsq_scan, ds, ddt_part, db_part, dc_part, dx, ddt, da_log, db, dc,
           dh0, split),
          (bsz, l, h, g, p, n, chunk, heads), x.device, lib_name="ssd_bwd")
    ssd_bwd.launches += 1
    ssd_bwd.route_launches[route] += 1
    return dx, ddt, da_log, db, dc, dh0


@_ssd_bwd_op.register_fake
def _(x, dt, a_log, b, c, s, h_in, dy, dh_final, chunk):
    bsz, _, h, p = x.shape
    dh0 = x.new_empty((bsz, h, p, b.shape[3]), dtype=_working(x))
    return tuple(torch.empty_like(t) for t in (x, dt, a_log, b, c)) + (dh0,)


@register_flop_formula(torch.ops.repro_torch.ssd_fwd)
def _ssd_flops(x_shape, dt_shape, a_log_shape, b_shape, c_shape, h0_shape,
               chunk, want_state, out_shape=None, **kwargs) -> int:
    """What ``perf.analytic._ssm_flops_per_token`` counts for the scan, a
    token: the two Q x Q products of its chunk, 2 Q H (N + P), and the
    state update and inter-chunk read, 6 H N P."""
    bsz, l, h, p = x_shape
    n = b_shape[3]
    return bsz * l * (2 * chunk * h * (n + p) + 6 * h * n * p)


@register_flop_formula(torch.ops.repro_torch.ssd_bwd)
def _ssd_bwd_flops(x_shape, dt_shape, a_log_shape, b_shape, c_shape,
                   s_shape, h_in_shape, dy_shape, dh_final_shape, chunk,
                   out_shape=None, **kwargs) -> int:
    """The backward kernels' work per head and chunk, as the kernel
    table's bound reckons it: C B^T, dY X^T, G^T dY, M B and M^T C over
    the Q (Q + 1) / 2 kept pairs (2 N, 2 P, 2 P, 2 N and 2 N flops a
    pair), and D_c, dY h_in, X dS and B dS^T (2 Q P N each)."""
    bsz, l, h, p = x_shape
    n = b_shape[3]
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 2 * pairs * (3 * n + 2 * p) + 8 * chunk * p * n
    return per_chunk * bsz * h * (l // chunk)


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
            h_in: torch.Tensor, dy: torch.Tensor,
            dh_final: Optional[torch.Tensor] = None, *, chunk: int):
    """The SSD scan's gradient: ``(dx, ddt, da_log, db, dc, dh0)`` for
    the forward's operands, its scratches ``s`` (B, H, L) and ``h_in``
    (B, H, L / chunk, P, N) (what :class:`SsdFn`'s forward keeps), y's
    gradient ``dy`` and the final state's ``dh_final`` (zero when None).

    CUDA tensors launch the hand-written kernels of ``csrc/ssd_bwd.cu``
    on the current stream, on the route :func:`ssd_bwd_route` gives -- (i)
    each chunk's D_c, (ii) the reverse state pass, (iii) the chunk
    backward, each block over :func:`ssd_bwd_heads` heads of one group,
    summing db and dc over them, (iv) the fixed-order finish: ds's reverse
    sums into ddt and da_log, db and dc added over each group's block
    partials; the wgmma route first splits its operands into a scratch of
    :func:`ssd_bwd_split_floats` floats and forms each chunk's C B^T once
    -- in a fixed order with no atomics, so two calls give the same bits;
    anything they do not take raises.  CPU tensors run
    :func:`ssd_bwd_plain`, the same passes.  ``ssd_bwd.launches`` counts
    calls that launched the kernels, one per backward, and
    ``ssd_bwd.route_launches`` splits them by route.
    """
    chunk = _prepare(x, dt, a_log, b, c, chunk, None)
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = l // chunk
    if tuple(dy.shape) != tuple(x.shape) or \
            tuple(s.shape) != (bsz, h, l) or \
            tuple(h_in.shape) != (bsz, h, nc, p, n) or \
            (dh_final is not None and
             tuple(dh_final.shape) != (bsz, h, p, n)):
        raise ValueError(
            f"ssd_bwd needs dy {tuple(x.shape)}, s {(bsz, h, l)}, h_in "
            f"{(bsz, h, nc, p, n)} and dh_final {(bsz, h, p, n)}, got "
            f"{tuple(dy.shape)}, {tuple(s.shape)}, {tuple(h_in.shape)}, "
            f"{None if dh_final is None else tuple(dh_final.shape)}")
    if x.device.type == "cuda":
        ops = (x, dt, a_log, b, c, s, h_in, dy) + \
            (() if dh_final is None else (dh_final,))
        if len({t.device for t in ops}) != 1:
            raise ValueError("ssd_bwd's operands lie on more than one "
                             "device")
        _card_legal(ops, l, chunk, p, n)
        limit = card_smem(x)
        if ssd_bwd_smem_bytes(chunk, p, n) > limit:
            raise ValueError(f"the ssd backward's staging "
                             f"{ssd_bwd_smem_bytes(chunk, p, n)} B at chunk "
                             f"{chunk}, (P, N) = ({p}, {n}) does not fit "
                             f"{limit} B")
    if plain_route(x):
        return ssd_bwd_plain(x, dt, a_log, b, c, s, h_in, dy, dh_final,
                             chunk=chunk)
    return _ssd_bwd_op(x, dt, a_log, b, c, s, h_in, dy, dh_final, chunk)


ssd_bwd.launches = 0
ssd_bwd.route_launches = dict.fromkeys(BWD_ROUTES, 0)


class SsdFn(torch.autograd.Function):
    """The SSD scan with a gradient: ``(y, h_final)``.  The forward
    operator keeps its scratches, ``s`` and the chunk-entry states (41.9
    MB a layer at mamba2-2.7b's width and chunk 256, held only while a
    layer's remat is differentiated), so the backward recomputes neither;
    the backward is :func:`ssd_bwd`.  A thin caller of the operator's own
    autograd (``_ssd_setup``, ``_ssd_backward``).  x, dt, a_log, b, c and
    h0 get gradients; y's or the final state's gradient may be absent."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, h0, chunk: int):
        inputs = (x, dt, a_log, b, c, h0, chunk, True)
        out = _plain_parts(x, dt, a_log, b, c, chunk, h0) \
            if plain_route(x) else _ssd_op(*inputs)
        _ssd_setup(ctx, inputs, out)
        ctx.set_materialize_grads(False)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, dy, dh_final):
        return _ssd_backward(ctx, dy, dh_final)[:7]


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
    CUDA tensors launch the hand-written kernels on the current stream, on
    the route :func:`ssd_route` gives — contiguous float32, a chunk and
    (P, N) legal for the card — and anything the kernels do not take
    raises; CPU tensors run :func:`ssd_plain`.  When grad is enabled and an
    operand requires it, the call goes through :class:`SsdFn`, whose
    backward is :func:`ssd_bwd` (the four backward kernels on the card,
    their plain version on the CPU).  ``ssd.launches`` counts calls that
    launched the forward kernels, one per scan (three kernel launches
    inside on mma_sync, four on wgmma: its C B^T pre-pass), and
    ``ssd.route_launches`` splits them by route.
    """
    chunk = _prepare(x, dt, a_log, b, c, chunk, h0)
    ops = (x, dt, a_log, b, c) + (() if h0 is None else (h0,))
    if x.device.type == "cuda":
        _card_legal(ops, x.shape[1], chunk, x.shape[3], b.shape[3])
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        if x.device.type == "cuda" and not ssd_bwd_legal(
                x.shape[1], chunk, x.shape[3], b.shape[3], card_smem(x)):
            raise ValueError(f"the ssd backward kernels do not take chunk "
                             f"{chunk} at (P, N) = ({x.shape[3]}, "
                             f"{b.shape[3]}) on this card")
        y, h_final = SsdFn.apply(x, dt, a_log, b, c, h0, chunk)
        return (y, h_final) if return_state else y
    if plain_route(x):
        return ssd_plain(x, dt, a_log, b, c, chunk=chunk, h0=h0,
                         return_state=return_state)
    y, h_final, _, _ = _ssd_op(x, dt, a_log, b, c, h0, chunk, return_state)
    return (y, h_final) if return_state else y


ssd.launches = 0
ssd.route_launches = dict.fromkeys(ROUTES, 0)
