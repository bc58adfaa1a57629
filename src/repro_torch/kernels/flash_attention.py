"""Flash attention: the hand-written Hopper kernel and its plain version.

The counterpart of ``repro/kernels/flash_attention.py``.  The kernel is
``csrc/flash_attention.cu`` (FP32 FFMA; one thread block per (batch, query
head, query block) looping over the kv blocks that hold a kept (query,
key) pair, with the online-softmax state in registers, 16-byte vector
loads from shared memory and cp.async copies of k and v that overlap the
FFMAs; its note says what bounds it and why it is built so).  One kernel
covers every flavour the reference covers: GQA by index (kv head
``h // (Hq / Hkv)``, nothing repeated), causal and sliding-window masks
with the finite ``-1e30`` sentinel, and gemma2's logit softcap.

:func:`flash_attention` dispatches on where its operands lie: CUDA tensors
launch the kernel (or raise); CPU tensors take
:func:`flash_attention_plain`, the kernel's kv-block loop in plain PyTorch
— the counterpart of Pallas ``interpret=True``.  There is no fall back
from one to the other.

The kernel skips the kv blocks a mask removes (:func:`attn_kv_range`), so
:func:`attn_grid_steps` counts the (query block, kv block) pairs it
visits.  That differs on purpose from the reference's count, which is the
TPU kernel's full grid; the two agree where no mask removes a block.

Training.  When grad is enabled and an operand requires it,
:func:`flash_attention` runs :class:`FlashAttentionFn`: the same forward,
which also writes each row's log-sum-exp, and a backward through
:func:`flash_attention_bwd` -- on CUDA tensors the three hand-written
kernels of ``csrc/flash_attention_bwd.cu`` (delta, dK/dV, dQ), on CPU
tensors :func:`flash_attention_bwd_plain`, the same arithmetic blockwise.
The backward kernels run their products on the tensor cores (``mma.sync``:
bfloat16 in one rounding, float32 as three TF32 products, dS in bfloat16 as
hi + lo) in a fixed order without atomics, so their result is the same
bits from run to run.  The reference has no backward kernel (it
differentiates ``chunked_attention`` in XLA); the backward takes Sq = Skv
only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ._card import H100_SMEM_OPTIN, PROXY_BLOCKS

#: block sizes the kernel is instantiated for: bq and bkv (16 x 16 threads,
#: each owning bq/16 rows and bkv/16 logit columns) and the head dim D
#: (each thread owns D/16 accumulator columns)
KERNEL_BLOCKS: Tuple[int, ...] = (16, 32, 64, 128)
KERNEL_HEAD_DIMS: Tuple[int, ...] = (16, 32, 64, 128)
#: the reference kernel's finite mask sentinel
NEG_INF = -1e30
#: widest column chunk of the probability tile the kernel stages at once
PROB_CHUNK = 64
#: the backward's blocks (bq = bkv): 16 rows a warp, two warps a row group;
#: its dK and dV accumulators would not fit in registers at the forward's 128
BWD_BLOCKS: Tuple[int, ...] = (32, 64)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attn_smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Shared memory one block stages, in float32 (bfloat16 operands
    stage half as much for q, k and v): one q tile (bq x d), one k tile
    and one v tile (bkv x d each; the next block's k and v land in them
    while the other product runs), and the probability tile in column
    chunks of at most :data:`PROB_CHUNK`.  bq = bkv = d = 128 takes
    229,376 bytes, within the H100's opt-in limit."""
    return 4 * ((bq + 2 * bkv) * d + bq * min(bkv, PROB_CHUNK))


def attn_tile_legal(sq: int, skv: int, bq: int, bkv: int, d: int,
                    smem_limit: int = H100_SMEM_OPTIN) -> bool:
    """Can the kernel run sequence lengths ``(sq, skv)`` at head dim
    ``d`` with blocks ``(bq, bkv)``?  The blocks must divide the
    sequences, ``(bq, bkv, d)`` must be instantiated, and the staging
    must fit ``smem_limit`` — the card's opt-in shared memory per block."""
    if min(sq, skv, bq, bkv, d) <= 0 or sq % bq or skv % bkv:
        return False
    if bq not in KERNEL_BLOCKS or bkv not in KERNEL_BLOCKS or \
            d not in KERNEL_HEAD_DIMS:
        return False
    return attn_smem_bytes(bq, bkv, d) <= smem_limit


def attn_kv_range(qblk: int, bq: int, bkv: int, skv: int, causal: bool,
                  window: int) -> Tuple[int, int]:
    """The kv blocks ``[lo, hi)`` the kernel visits for query block
    ``qblk``: those that hold a kept (query, key) pair.

    Under ``causal`` the blocks up to the diagonal; under ``window > 0``
    those from ``(qblk bq - window + 1) // bkv``, clamped at 0.  A block
    with a row whose window lies wholly past the keys (``sq > skv``)
    visits every block: that row keeps no key, and the reference returns
    the mean of v over every key, which only the full loop reproduces.
    ``csrc/flash_attention.cu`` computes the same range.
    """
    nkv = skv // bkv
    q0, q_last = qblk * bq, qblk * bq + bq - 1
    if window > 0 and q_last >= skv + window - 1:
        return 0, nkv
    hi = min(nkv, q_last // bkv + 1) if causal else nkv
    lo = max(0, q0 - window + 1) // bkv if window > 0 else 0
    return lo, hi


def attn_bwd_smem_bytes(blk: int, d: int, itemsize: int = 4) -> int:
    """Shared memory one backward block stages (the dK/dV kernel, the
    larger of the two): its k and v tiles and two stages of the q and dO
    tiles (blk x d each, in the operands' dtype), two stages of the rows'
    lse and delta, and, for bfloat16 operands, the two column slices' dK
    sums in float32.  blk = 64, d = 128 takes 197,632 bytes in float32
    and 164,864 in bfloat16."""
    dk_sums = 2 * blk * d * 4 if itemsize == 2 else 0
    return 6 * blk * d * itemsize + 4 * 4 * blk + dk_sums


def attn_bwd_tile_legal(s: int, blk: int, d: int, itemsize: int = 4,
                        smem_limit: int = H100_SMEM_OPTIN) -> bool:
    """Can the backward kernels run sequence length ``s`` (= Sq = Skv) at
    head dim ``d`` with blocks ``(blk, blk)``?  The block must divide the
    sequence, ``(blk, d)`` must be instantiated, and the staging must fit
    ``smem_limit``."""
    if min(s, blk, d) <= 0 or s % blk:
        return False
    if blk not in BWD_BLOCKS or d not in KERNEL_HEAD_DIMS:
        return False
    return attn_bwd_smem_bytes(blk, d, itemsize) <= smem_limit


def attn_bwd_blocks(s: int) -> int:
    """The backward's block for sequence length ``s``: the largest of
    :data:`BWD_BLOCKS` that divides ``s``; when none does, ``s`` itself
    (one block), which the plain version takes and the card refuses."""
    for blk in sorted(BWD_BLOCKS, reverse=True):
        if s % blk == 0:
            return blk
    return s


def attn_grid_steps(b: int, h: int, sq: int, skv: int, bq: int, bkv: int,
                    causal: bool = True, window: int = 0) -> int:
    """(query block, kv block) pairs one attention call visits at blocks
    (bq, bkv): the blocks of :func:`attn_kv_range` for every query block.
    Without a mask that is the full grid, the reference's count."""
    per_head = 0
    for qblk in range(sq // bq):
        lo, hi = attn_kv_range(qblk, bq, bkv, skv, causal, window)
        per_head += hi - lo
    return b * h * per_head


def attn_proxy_problem(bq: int, bkv: int, d: int,
                       steps_per_dim: int = 16) -> tuple:
    """(b, h, sq, skv, d) of the problem that measures blocks (bq, bkv).

    The device protocol (:mod:`repro_torch.tc.device`) times a config on
    this problem and models its per-step cost.  The reference's proxy is
    one batch and one head, which on a GPU is ``steps_per_dim`` query
    blocks — a few of the card's 132 SMs, timing one block's latency.
    Here the proxy adds heads until it launches :data:`PROXY_BLOCKS`
    blocks (16 heads at 16 steps a dimension), so it measures
    throughput, and its per-step cost transfers to a full-width problem.
    """
    heads = -(-PROXY_BLOCKS // steps_per_dim)
    return (1, heads, bq * steps_per_dim, bkv * steps_per_dim, d)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention needs q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq = {q.shape[1]} is not a multiple of "
                         f"Hkv = {k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, bkv: int, causal: bool = True,
                          window: int = 0, softcap: float = 0.0,
                          bq: Optional[int] = None,
                          return_lse: bool = False):
    """The kernel's online-softmax loop over kv blocks in plain PyTorch.

    With ``bq``, each query block visits only the kv blocks of
    :func:`attn_kv_range`, as the kernel does; without, every query row
    visits every kv block at once, as the TPU kernel's grid does.  The
    two give the same result: a skipped block adds nothing (see
    ``attn_kv_range``).  Vectorised over batches and query heads; GQA
    broadcasts each kv head over its query-head group.  Same arithmetic
    as the kernel: float32 logits and state, ``-1e30`` masking, ``p``
    rounded to the value dtype before ``p @ v`` while the denominator
    sums the unrounded ``p``, output ``acc / max(l, 1e-30)`` cast to the
    input dtype.  ``return_lse`` also returns each row's log-sum-exp
    ``m + log(max(l, 1e-30))``, float32 (B, Hq, Sq), as the kernel writes
    it for the backward.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    if bq is None:
        blocks = [(0, sq, 0, skv // bkv)]
    else:
        blocks = [(i * bq, i * bq + bq,
                   *attn_kv_range(i, bq, bkv, skv, causal, window))
                  for i in range(sq // bq)]
    out = torch.empty_like(qf)
    lse = torch.empty((*qf.shape[:-1], 1), device=dev)
    for r0, r1, lo, hi in blocks:
        qb = qf[..., r0:r1, :]
        m = torch.full((*qb.shape[:-1], 1), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        q_pos = torch.arange(r0, r1, device=dev)[:, None]
        for j0 in range(lo * bkv, hi * bkv, bkv):
            kb = k[:, :, None, j0:j0 + bkv].float()
            vb = v[:, :, None, j0:j0 + bkv]
            s = (qb @ kb.transpose(-1, -2)) * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            k_pos = torch.arange(j0, j0 + bkv, device=dev)[None, :]
            mask = torch.ones((r1 - r0, bkv), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos >= k_pos
            if window > 0:
                mask &= (q_pos - k_pos) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ vb.float()
            m = m_new
        denom = torch.clamp_min(l, 1e-30)
        out[..., r0:r1, :] = acc / denom
        lse[..., r0:r1, :] = m + torch.log(denom)
    out = out.reshape(b, hq, sq, d).to(q.dtype)
    if return_lse:
        return out, lse.reshape(b, hq, sq)
    return out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              softcap: float = 0.0,
                              bq: Optional[int] = None):
    """The backward kernels' arithmetic in plain PyTorch: (dq, dk, dv).

    ``o`` and ``lse`` are the forward's output and row log-sum-exp
    (:func:`flash_attention_plain` with ``return_lse``), ``do`` the
    output's gradient; Sq = Skv.  With ``delta = rowsum(do * o)`` and,
    per kept (query, key) pair, ``p = exp(x - lse)`` from the recomputed
    scaled and soft-capped logit ``x = cap tanh(s scale / cap)``:
    ``dv = round(p)^T do`` (p rounded to the value dtype: the gradient of
    the forward's cast passes straight through), ``ds = p (do v^T -
    delta) (1 - tanh^2)``, ``dk = ds^T q scale``, ``dq = ds k scale``;
    masked pairs give nothing.  Every sum is float32; GQA sums each kv
    head's gradient over its query-head group; results are cast to the
    operands' dtype.  With ``bq`` each query block takes only the kv
    blocks of :func:`attn_kv_range`, as the kernels do; without, every
    row at once.
    """
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[2] != s:
        raise ValueError(f"the attention backward takes Sq = Skv, got "
                         f"{s} and {k.shape[2]}")
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qf = q.float().reshape(b, hkv, g, s, d)
    gf = do.float().reshape(b, hkv, g, s, d)
    lf = lse.float().reshape(b, hkv, g, s, 1)
    delta = (gf * o.float().reshape(b, hkv, g, s, d)).sum(-1, keepdim=True)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dq = torch.empty_like(qf)
    dk = torch.zeros((b, hkv, s, d), device=dev)
    dv = torch.zeros_like(dk)
    if bq is None:
        blocks = [(0, s, 0, s)]
    else:
        blocks = [(i * bq, i * bq + bq, lo * bq, hi * bq)
                  for i in range(s // bq)
                  for lo, hi in [attn_kv_range(i, bq, bq, s, causal,
                                               window)]]
    for r0, r1, c0, c1 in blocks:
        qb, gb = qf[..., r0:r1, :], gf[..., r0:r1, :]
        kb, vb = kf[..., c0:c1, :], vf[..., c0:c1, :]
        x = (qb @ kb.transpose(-1, -2)) * scale
        fac = 1.0
        if softcap > 0.0:
            t = torch.tanh(x / softcap)
            x = softcap * t
            fac = 1.0 - t * t
        q_pos = torch.arange(r0, r1, device=dev)[:, None]
        k_pos = torch.arange(c0, c1, device=dev)[None, :]
        mask = torch.ones((r1 - r0, c1 - c0), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos >= k_pos
        if window > 0:
            mask &= (q_pos - k_pos) < window
        p = torch.where(mask, torch.exp(x - lf[..., r0:r1, :]), 0.0)
        dp = gb @ vb.transpose(-1, -2)
        ds = torch.where(mask, p * (dp - delta[..., r0:r1, :]) * fac, 0.0)
        dv[..., c0:c1, :] += (p.to(v.dtype).float().transpose(-1, -2)
                              @ gb).sum(2)
        dk[..., c0:c1, :] += (ds.transpose(-1, -2) @ qb).sum(2)
        dq[..., r0:r1, :] = (ds @ kb) * scale
    return (dq.reshape(b, hq, s, d).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def _lib(name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn


def _raise_on(err: int, name: str, what: str) -> None:
    if err != 0:
        msg = _build.load(name).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: {msg} (cudaError {err})")


def _launch(q, k, v, out, lse, bq: int, bkv: int, causal: bool,
            window: int, softcap: float) -> None:
    """The forward kernel; ``lse`` is None or the float32 (B, Hq, Sq)
    buffer for the rows' log-sum-exp."""
    fn = _lib("flash_attention", "repro_flash_attention",
              [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 +
              [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p])
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             0 if lse is None else lse.data_ptr(), b, hq, hkv, sq, skv, d,
             bq, bkv, 1.0 / (d ** 0.5), int(causal), int(window),
             float(softcap), _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "flash_attention",
              f"flash_attention kernel launch failed at blocks ({bq}, {bkv})"
              f" for q {tuple(q.shape)}, kv {tuple(k.shape)}")


def _launch_bwd(q, k, v, o, lse, do, delta, dq, dk, dv, blk: int,
                causal: bool, window: int, softcap: float) -> None:
    """The three backward kernels (delta, dK/dV, dQ) on the current
    stream."""
    fn = _lib("flash_attention_bwd", "repro_flash_attention_bwd",
              [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 +
              [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p])
    b, hq, s, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (q, k, v, o, do, lse, delta, dq, dk,
                                      dv)),
             b, hq, k.shape[1], s, d, blk, 1.0 / (d ** 0.5), int(causal),
             int(window), float(softcap), _DTYPE_CODES[q.dtype], stream)
    _raise_on(err, "flash_attention_bwd",
              f"flash_attention backward launch failed at block {blk} for q "
              f"{tuple(q.shape)}, kv {tuple(k.shape)}")


def _card_ready(tensors, what: str) -> int:
    """Raise unless every tensor is contiguous and 16-byte aligned; the
    card's opt-in shared memory per block."""
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"the {what} kernel takes contiguous, 16-byte "
                         f"aligned operands")
    return torch.cuda.get_device_properties(
        tensors[0].device).shared_memory_per_block_optin


def _forward(q, k, v, bq: int, bkv: int, causal: bool, window: int,
             softcap: float, with_lse: bool):
    """(out, lse or None): the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, bq=bq, bkv=bkv, causal=causal,
                                    window=window, softcap=softcap,
                                    return_lse=with_lse)
        return res if with_lse else (res, None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    limit = _card_ready((q, k, v), "flash_attention")
    sq, d, skv = q.shape[2], q.shape[3], k.shape[2]
    if not attn_tile_legal(sq, skv, bq, bkv, d, limit):
        raise ValueError(
            f"blocks ({bq}, {bkv}) at head dim {d} are not legal for the "
            f"kernel: bq, bkv must be in {KERNEL_BLOCKS}, d in "
            f"{KERNEL_HEAD_DIMS}, and the staging "
            f"{attn_smem_bytes(bq, bkv, d)} B must fit {limit} B")
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32,
                      device=q.device) if with_lse else None
    _launch(q, k, v, out, lse, bq, bkv, causal, window, softcap)
    flash_attention.launches += 1
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, bq: int = 128, bkv: int = 128, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """The forward with its row statistics, as :class:`FlashAttentionFn`
    runs it: ``(out, lse)``, lse the float32 (B, Hq, Sq) log-sum-exp that
    :func:`flash_attention_bwd` takes.  No gradient is recorded.  Blocks
    and dispatch as :func:`flash_attention`'s (the kernel on CUDA tensors,
    counted in ``flash_attention.launches``)."""
    _check(q, k, v)
    sq, skv = q.shape[2], k.shape[2]
    bq, bkv = min(bq, sq), min(bkv, skv)
    if min(sq, skv) <= 0 or sq % bq or skv % bkv:
        raise ValueError(f"blocks ({bq}, {bkv}) must divide the sequence "
                         f"lengths ({sq}, {skv})")
    with torch.no_grad():
        return _forward(q, k, v, bq, bkv, causal, window, softcap,
                        with_lse=True)


def _bwd_legal(q, k, blk: int) -> None:
    """Raise unless the backward kernels take these operands at ``blk``."""
    s, d = q.shape[2], q.shape[3]
    limit = torch.cuda.get_device_properties(
        q.device).shared_memory_per_block_optin
    if k.shape[2] != s or not attn_bwd_tile_legal(
            s, blk, d, q.element_size(), limit):
        raise ValueError(
            f"the attention backward kernels do not take Sq = {s}, Skv = "
            f"{k.shape[2]} at head dim {d} and block {blk}: Sq must equal "
            f"Skv, the block be one of {BWD_BLOCKS} dividing it, d one of "
            f"{KERNEL_HEAD_DIMS}, and the staging "
            f"{attn_bwd_smem_bytes(blk, d, q.element_size())} B fit "
            f"{limit} B")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        blk: Optional[int] = None):
    """The gradient of attention: (dq, dk, dv) for the forward's operands,
    its output ``o`` and row log-sum-exp ``lse`` (float32 (B, Hq, S)) and
    the output's gradient ``do``, at Sq = Skv.

    CUDA tensors launch the three hand-written kernels of
    ``csrc/flash_attention_bwd.cu`` on the current stream (blocks ``blk``,
    by default :func:`attn_bwd_blocks`), and anything they do not take
    raises; CPU tensors run :func:`flash_attention_bwd_plain` over the
    same blocks.  ``flash_attention_bwd.launches`` counts calls that
    launched the kernels: one per backward, three kernel launches inside.
    """
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"o and do must be {tuple(q.shape)} and lse "
                         f"{tuple(q.shape[:3])}, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    s = q.shape[2]
    if k.shape[2] != s:
        raise ValueError(f"the attention backward takes Sq = Skv, got {s} "
                         f"and {k.shape[2]}")
    blk = attn_bwd_blocks(s) if blk is None else blk
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, softcap=softcap,
                                         bq=blk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or the CPU, not "
                         f"{q.device}")
    if o.dtype != q.dtype or do.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError(f"o and do must be {q.dtype} and lse float32, got "
                        f"{o.dtype}, {do.dtype}, {lse.dtype}")
    _card_ready((q, k, v, o, lse, do), "flash_attention backward")
    _bwd_legal(q, k, blk)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _launch_bwd(q, k, v, o, lse, do, delta, dq, dk, dv, blk, causal, window,
                softcap)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: the forward kernel (or, on the CPU, its
    plain version) also writes each row's log-sum-exp, and the backward
    is :func:`flash_attention_bwd`.  q, k and v get gradients; the
    block, mask and softcap arguments none."""

    @staticmethod
    def forward(ctx, q, k, v, bq: int, bkv: int, causal: bool, window: int,
                softcap: float):
        out, lse = _forward(q, k, v, bq, bkv, causal, window, softcap,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), causal=causal,
                                         window=window, softcap=softcap)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bq: int = 128, bkv: int = 128, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Attention over (B, Hq, Sq, D) queries and (B, Hkv, Skv, D) kv.

    Hq must be a multiple of Hkv (GQA); ``window > 0`` enables sliding-
    window attention; ``softcap > 0`` applies gemma2-style logit
    soft-capping.  Blocks are clamped to the sequence lengths and must
    divide them, as in the reference.  CUDA tensors launch the
    hand-written kernel on the current stream — contiguous, 16-byte
    aligned, float32 or bfloat16, blocks legal for the card — and anything
    the kernel does not take raises; CPU tensors run
    :func:`flash_attention_plain` over the same visited kv blocks.  Both
    visit only the kv blocks of :func:`attn_kv_range`.

    When grad is enabled and an operand requires it, the call goes through
    :class:`FlashAttentionFn`, whose backward is :func:`flash_attention_bwd`
    (Sq = Skv only; on CUDA the backward kernels must take the shape, which
    is checked here); otherwise no row statistics are written and nothing
    is saved.  ``flash_attention.launches`` counts forward kernel
    launches.
    """
    _check(q, k, v)
    sq = q.shape[2]
    skv = k.shape[2]
    bq, bkv = min(bq, sq), min(bkv, skv)
    if min(sq, skv) <= 0 or sq % bq or skv % bkv:
        raise ValueError(f"blocks ({bq}, {bkv}) must divide the sequence "
                         f"lengths ({sq}, {skv})")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        if sq != skv:
            raise ValueError(f"the attention backward takes Sq = Skv, got "
                             f"{sq} and {skv}")
        if q.device.type == "cuda":
            _bwd_legal(q, k, attn_bwd_blocks(sq))
        return FlashAttentionFn.apply(q, k, v, bq, bkv, causal, window,
                                      softcap)
    return _forward(q, k, v, bq, bkv, causal, window, softcap,
                    with_lse=False)[0]


flash_attention.launches = 0
