"""The kernels' call sites on sharded tensors.

A ``DTensor`` has no storage the kernels' launchers could take, so the
models call attention and the SSD scan on local shards through
``local_map``: each call's operands are redistributed to placements under
which the kernel is shard-local, the kernel (its ``torch.library``
operator) runs on every rank's shard, and the outputs are wrapped back.
The placements are chosen per mesh dimension from what the operands
already carry:

* attention is shard-local over batch and heads: a mesh dimension that
  shards the batch keeps it; otherwise it shards the query heads where
  they divide (the kv heads too, or, where the kv heads do not divide,
  each kv head repeated to its query heads first, so every rank holds the
  kv heads its query heads read); otherwise it replicates;
* the SSD is shard-local over batch and heads the same way, B and C
  sharded over their groups where the groups divide, else replicated
  (jamba has one group); a_log follows the heads;
* the block norm is shard-local over every dim but its last: the hidden
  state keeps its batch and sequence shards, its scale is replicated.

An operand replicated over a mesh dimension whose work is sharded gets a
``Partial`` gradient there (each rank's share of the sum).  Any other
placement the operands arrive with (a sharded sequence, a sharded head
dim) is gathered by the redistribution, and the traced step's collective
bytes (:mod:`repro_torch.launch.dryrun`) show it.
"""

from __future__ import annotations

from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch


def is_sharded(t) -> bool:
    """Whether ``t`` is a ``DTensor``."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _work_split(t, mesh, batch: int, heads: int) -> Tuple[List[str], int]:
    """Per mesh dimension, what a shard-local call splits there: "batch"
    where ``t`` shards dim 0 and the batch divides, else "heads" where
    the heads divide, else "" (replicated work); and the number of head
    shards."""
    from torch.distributed.tensor import Shard
    out, b_prod, h_prod = [], 1, 1
    for pl, n in zip(t.placements, mesh.shape):
        if n > 1 and isinstance(pl, Shard) and pl.dim == 0 and \
                batch % (b_prod * n) == 0:
            out.append("batch")
            b_prod *= n
        elif n > 1 and heads % (h_prod * n) == 0:
            out.append("heads")
            h_prod *= n
        else:
            out.append("")
    return out, h_prod


def _placements(split: Sequence[str], batch_dim: Optional[int],
                head_dim: Optional[int], heads_divide: bool = True,
                ) -> tuple:
    """An operand's placements and its gradient's: ``Shard`` on the
    dimension each mesh dimension splits (the operand's batch or head
    dim), ``Replicate`` where the operand has no such dim or its heads do
    not divide, with a ``Partial`` gradient where the work is split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    pls, grads = [], []
    for what in split:
        dim = {"batch": batch_dim, "heads": head_dim if heads_divide
               else None}.get(what)
        if dim is not None:
            pls.append(Shard(dim))
            grads.append(Shard(dim))
        else:
            pls.append(Replicate())
            grads.append(Partial() if what else Replicate())
    return tuple(pls), tuple(grads)


def attention(fn: Callable, q, k, v):
    """``fn(q, k, v)`` (the attention kernel's wrapper, or its plain
    version) on local shards of (B, Hq, S, D) and (B, Hkv, S, D)
    ``DTensor``s, shard-local over batch and heads."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    split, h_prod = _work_split(q, mesh, b, hq)
    if hkv % h_prod:
        g = hq // hkv
        k, v = (t[:, :, None].expand(b, hkv, g, s, d).reshape(b, hq, s, d)
                for t in (k, v))
    pl, grad = _placements(split, 0, 1)
    run = local_map(fn, out_placements=(pl,), in_placements=(pl, pl, pl),
                    in_grad_placements=(grad, grad, grad),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, v)


def ssd(fn: Callable, x, dt, a_log, b, c, h0=None):
    """``fn(x, dt, a_log, b, c, h0) -> (y, h_final)`` (the SSD kernel's
    wrapper, or its plain version) on local shards of ``DTensor``s: x
    (B, L, H, P), dt (B, L, H), a_log (H,), b and c (B, L, G, N), h0
    (B, H, P, N) or None; shard-local over batch and heads."""
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    bsz, _, h, _ = x.shape
    groups = b.shape[2]
    split, g_prod = _work_split(x, mesh, bsz, h)
    if groups > 1 and groups % g_prod:
        raise ValueError(f"{groups} groups do not split over the {g_prod} "
                         f"head shards")
    px, gx = _placements(split, 0, 2)
    pa, ga = _placements(split, None, 0)
    pb, gb = _placements(split, 0, 2, heads_divide=groups % g_prod == 0)
    ph, gh = _placements(split, 0, 1)
    args = (x, dt, a_log, b, c) + (() if h0 is None else (h0,))
    pls = (px, px, pa, pb, pb) + (() if h0 is None else (ph,))
    grads = (gx, gx, ga, gb, gb) + (() if h0 is None else (gh,))
    run = local_map(fn, out_placements=(px, ph), in_placements=pls,
                    in_grad_placements=grads, device_mesh=mesh,
                    redistribute_inputs=True)
    return run(*args)


def splits_heads(t, heads: int) -> bool:
    """Whether a shard-local call on ``t`` (a ``DTensor`` whose dim 0 is
    the batch) would split ``heads`` heads over some mesh dimension
    (:func:`_work_split`): a Mamba mixer's gated norm then needs a sum
    across the head shards."""
    return _work_split(t, t.device_mesh, t.shape[0], heads)[1] > 1


def mixer(fn: Callable, heads: int, zxbcdt, dt_bias, a_log, d_skip, norm_g,
          h0=None):
    """``fn(zxbcdt, dt_bias, a_log, d_skip, norm_g, h0) -> (out,
    h_final)`` (the Mamba mixer's kernels) on local shards of
    ``DTensor``s whose mesh splits none of the ``heads`` heads
    (:func:`splits_heads` false): zxbcdt (B, S, W), out (B, S, d_inner)
    and h0, h_final (B, H, P, N) keep the batch where a mesh dimension
    shards it and are replicated elsewhere; the per-head and per-channel
    vectors are replicated, their gradients partial sums over the batch's
    dimensions."""
    from torch.distributed.tensor.experimental import local_map
    mesh = zxbcdt.device_mesh
    split, h_prod = _work_split(zxbcdt, mesh, zxbcdt.shape[0], heads)
    if h_prod > 1:
        raise ValueError("local.mixer takes a mesh that splits no heads")
    pb, gb = _placements(split, 0, None)
    pv, gv = _placements(split, None, None)
    args = (zxbcdt, dt_bias, a_log, d_skip, norm_g) + \
        (() if h0 is None else (h0,))
    pls = (pb, pv, pv, pv, pv) + (() if h0 is None else (pb,))
    grads = (gb, gv, gv, gv, gv) + (() if h0 is None else (gb,))
    run = local_map(fn, out_placements=(pb, pb), in_placements=pls,
                    in_grad_placements=grads, device_mesh=mesh,
                    redistribute_inputs=True)
    return run(*args)


def rmsnorm(fn: Callable, x, scale):
    """``fn(x, scale)`` (the block norm on a plain tensor) on local shards
    of a ``DTensor`` x (..., d): x keeps its placements on every dim but
    the last (the norm's row sum needs the whole row: a sharded last dim,
    or a partial sum, is gathered first) and y takes them; scale (d,) is
    replicated, its gradient a partial sum over the mesh dimensions that
    shard x."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    last = x.dim() - 1
    px = tuple(pl if isinstance(pl, Shard) and pl.dim != last
               and pl.dim != -1 else Replicate() for pl in x.placements)
    pv = tuple(Replicate() for _ in px)
    gv = tuple(Partial() if isinstance(pl, Shard) else Replicate()
               for pl in px)
    run = local_map(fn, out_placements=(px,), in_placements=(px, pv),
                    in_grad_placements=(px, gv), device_mesh=x.device_mesh,
                    redistribute_inputs=True)
    return run(x, scale)


#: the MoE expert weights, whose dim 0 (the experts) is expert-parallel
_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


def gathered_weight(p, x, expert: bool = False):
    """The weight ``p`` all-gathered over the mesh dimensions that shard
    the batch of the activation ``x`` (its dim 0): the FSDP / ZeRO axes,
    "data" (and "pod"; under the ``dp`` strategy "model" too), on which
    every rank computes the same product of a different batch shard.  A
    "model" shard on any other mesh dimension (tensor or expert
    parallelism) stays; so does an expert weight's dim-0 shard
    (``expert``).  Differentiable: the backward reduce-scatters the
    gradient back onto ``p``'s placements.  Plain tensors pass through."""
    from torch.distributed.tensor import Replicate, Shard
    if not (is_sharded(p) and is_sharded(x)):
        return p
    new = []
    for pl, xpl, n in zip(p.placements, x.placements, p.device_mesh.shape):
        fsdp = n > 1 and isinstance(xpl, Shard) and xpl.dim == 0 and \
            isinstance(pl, Shard) and not (expert and pl.dim == 0)
        new.append(Replicate() if fsdp else pl)
    if tuple(new) == tuple(p.placements):
        return p
    return p.redistribute(p.device_mesh, new)


def gathered(module, x):
    """A context in which ``module``'s parameters read as
    :func:`gathered_weight` of themselves (``torch.nn.utils.stateless``
    re-parametrization); nothing when ``x`` is not sharded.  A block is
    gathered where it runs, so remat gathers it again in the backward, as
    FSDP does."""
    import contextlib
    if not is_sharded(x):
        return contextlib.nullcontext()
    from torch.nn.utils.stateless import _reparametrize_module
    swap = {}
    for name, p in module.named_parameters():
        expert = name.startswith("moe.") and name.endswith(_EXPERT_WEIGHTS)
        g = gathered_weight(p, x, expert)
        if g is not p:
            swap[name] = g
    return _reparametrize_module(module, swap)


def split_last(t, parts: int, width: int):
    """``t`` (..., parts * width) viewed as (..., parts, width).  A
    ``DTensor`` sharded on its last dim over mesh dimensions that
    ``parts`` does not divide is gathered on those first (a projection's
    output whose heads cannot take the axis: jamba's 8 kv heads on a
    16-wide "model" axis)."""
    if is_sharded(t):
        from torch.distributed.tensor import Replicate, Shard
        last, prod, new = t.dim() - 1, 1, []
        for pl, n in zip(t.placements, t.device_mesh.shape):
            if isinstance(pl, Shard) and pl.dim == last:
                if parts % (prod * n):
                    pl = Replicate()
                else:
                    prod *= n
            new.append(pl)
        if tuple(new) != tuple(t.placements):
            t = t.redistribute(t.device_mesh, new)
    return t.reshape(*t.shape[:-1], parts, width)


def merge_last(t):
    """``t`` (..., parts, width) viewed as (..., parts * width).  For a
    ``DTensor`` the view runs on the local shard (``local_map``), so that
    its backward takes the gradient onto ``t``'s own placements first: a
    gradient sharded on the merged dim over an axis the parts do not
    divide (the heads of a reduced config, or jamba's on a wider axis)
    could not be viewed back otherwise."""
    if not is_sharded(t):
        return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    last = t.dim() - 1
    if any(isinstance(pl, Shard) and pl.dim == last for pl in t.placements):
        raise ValueError("merge_last takes a tensor whose last dim is whole")
    fn = local_map(lambda x: x.reshape(*x.shape[:-2], -1),
                   out_placements=(tuple(t.placements),),
                   in_placements=(tuple(t.placements),),
                   device_mesh=t.device_mesh)
    return fn(t)


def embedding(weight, ids):
    """``weight[ids]`` for a (V, d) ``DTensor`` weight and ``DTensor``
    ids, on local shards (``local_map``; ``DTensor``'s own index
    strategies refuse ids sharded over two mesh dimensions, and a
    vocabulary-sharded gather's backward): the weight is gathered over the
    ids' batch axes (FSDP) and stays vocabulary-parallel where its dim 0
    is sharded, each rank looking up the ids in its slice (zeros
    elsewhere), so the rows are a partial sum over those dimensions."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ids.device_mesh
    weight = gathered_weight(weight, ids)
    tok = [isinstance(pl, Shard) and pl.dim == 0 and n > 1
           for pl, n in zip(ids.placements, mesh.shape)]
    vocab = [isinstance(pl, Shard) and pl.dim == 0 and n > 1 and not t
             for pl, n, t in zip(weight.placements, mesh.shape, tok)]
    ids_pl = tuple(Shard(0) if t else Replicate() for t in tok)
    w_pl = tuple(Shard(0) if v else Replicate() for v in vocab)
    w_grad = tuple(Partial() if t else pl for t, pl in zip(tok, w_pl))
    out_pl = tuple(Shard(0) if t else Partial() if v else Replicate()
                   for t, v in zip(tok, vocab))

    def run(w, i):
        if not any(vocab):
            return w[i]
        coord, lo, n = mesh.get_coordinate(), 0, weight.shape[0]
        for dim in range(mesh.ndim):
            if vocab[dim]:
                n //= mesh.shape[dim]
                lo += coord[dim] * n
        local_ids = i - lo
        mine = (local_ids >= 0) & (local_ids < n)
        rows = w[torch.where(mine, local_ids, 0)]
        return torch.where(mine[..., None], rows, 0.0).to(w.dtype)

    fn = local_map(run, out_placements=(out_pl,), in_placements=(w_pl, ids_pl),
                   in_grad_placements=(w_grad, ids_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(weight, ids)


class Placed(NamedTuple):
    """A mesh and placements: what :func:`redistribute` reads of a
    sharding."""

    mesh: Any
    placements: tuple


def batch_sharding(t) -> Optional[Placed]:
    """The hidden states' sharding for inputs ``t``: their batch (dim 0)
    sharded where ``t``'s is, replicated on every other mesh dimension;
    None for a plain tensor.  Prefill and decode pin the hidden state to
    it at the blocks' boundaries, as training pins it to ``act_spec``."""
    if not is_sharded(t):
        return None
    from torch.distributed.tensor import Replicate, Shard
    return Placed(t.device_mesh, tuple(
        Shard(0) if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
        for pl in t.placements))


def decode_attention(q, k, v, ck, cv, slot: int, q_offset: int, window: int,
                     softcap: float):
    """One decode step's attention against sharded KV caches (B, Hkv, ctx,
    D): the new token's k and v (B, Hkv, 1, D) written at ring slot
    ``slot`` in place, then the query (B, Hq, 1, D) at absolute position
    ``q_offset`` against every cached slot, as
    :func:`repro_torch.models.attention.chunked_attention`.  The caches
    stay where they are: the rank holding ``slot`` writes it, and where
    the cache's sequence is sharded (its kv heads cannot take the "model"
    axis, or the batch is one) each rank attends its slice of the slots
    and the slices' softmax statistics are combined by all-reduces of the
    row maximum, the sums and the weighted values (sequence-parallel
    decode)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ck.device_mesh
    seq_dims = [i for i, pl in enumerate(ck.placements)
                if isinstance(pl, Shard) and pl.dim == 2]
    q_pl = tuple(pl if isinstance(pl, Shard) and pl.dim in (0, 1)
                 else Replicate() for pl in ck.placements)
    c_pl = tuple(ck.placements)

    def run(q, k, v, ck, cv):
        b, hq, _, d = q.shape
        hkv, ctx = ck.shape[1], ck.shape[2]
        coord = mesh.get_coordinate()
        shard, stride = 0, 1
        for dim in reversed(seq_dims):
            shard += coord[dim] * stride
            stride *= mesh.shape[dim]
        lo = shard * ctx
        if lo <= slot < lo + ctx:
            ck[:, :, slot - lo] = k[:, :, 0].to(ck.dtype)
            cv[:, :, slot - lo] = v[:, :, 0].to(cv.dtype)
        qg = q.reshape(b, hkv, hq // hkv, 1, d)
        x = torch.einsum("bhgqd,bhkd->bhgqk", qg, ck.to(q.dtype)).float() \
            * (1.0 / d ** 0.5)
        if softcap > 0.0:
            x = softcap * torch.tanh(x / softcap)
        k_pos = lo + torch.arange(ctx, device=q.device)
        mask = q_offset >= k_pos
        if window > 0:
            mask &= (q_offset - k_pos) < window
        x = torch.where(mask, x, -1e30)
        m = x.amax(-1, keepdim=True)
        for dim in seq_dims:
            m = funcol.all_reduce(m, "max", (mesh, dim))
        p = torch.exp(x - m)
        den = p.sum(-1, keepdim=True)
        num = torch.einsum("bhgqk,bhkd->bhgqd", p, cv.float())
        for dim in seq_dims:
            den = funcol.all_reduce(den, "sum", (mesh, dim))
            num = funcol.all_reduce(num, "sum", (mesh, dim))
        return (num / den).reshape(b, hq, 1, d).to(q.dtype)

    fn = local_map(run, out_placements=(q_pl,),
                   in_placements=(q_pl, q_pl, q_pl, c_pl, c_pl),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v, ck, cv)


class _Constrain(torch.autograd.Function):
    """A redistribution whose gradient is held to the same placements:
    the reference's sharding constraint, which binds the cotangent too.
    ``DTensor``'s own redistribution hands the gradient back on the
    input's placements (a partial sum for a reduced one), from which its
    propagation may choose to shard the sequence, and a view of a
    sequence-sharded gradient cannot merge it with the batch."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def _constrain(x, mesh, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return _Constrain.apply(x, mesh, tuple(placements))


def like(y, x):
    """``y`` on ``x``'s placements where both are ``DTensor``s (a block's
    output added to the residual stream keeps the stream's layout: a
    partial sum is reduced onto it, and its gradient comes back on that
    layout); else ``y``."""
    if is_sharded(y) and is_sharded(x):
        return _constrain(y, x.device_mesh, x.placements)
    return y


def redistribute(x: torch.Tensor, sharding) -> torch.Tensor:
    """``x`` (a ``DTensor``) on ``sharding``'s placements, its gradient
    too: the reference's ``with_sharding_constraint``.  None leaves ``x``
    as it is."""
    if sharding is None:
        return x
    return _constrain(x, sharding.mesh, sharding.placements)
