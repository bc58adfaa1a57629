"""Sharding rules: parameter, activation and cache specs, the counterpart
of ``repro/distributed/sharding.py``.

The rules are the reference's, divisibility-checked against the mesh: an
axis is sharded only where the dimension divides evenly (grok-1's 8
experts cannot be expert-parallel on a 16-wide "model" axis, so its MoE
weights shard d_ff instead).  After the "model" (TP / EP) assignment, the
largest remaining dimension of every large parameter is sharded over
"data" (FSDP / ZeRO-3); the AdamW moments take their parameter's spec.

A :class:`Spec` holds one entry per tensor dimension, as the reference's
``PartitionSpec`` does: a mesh axis name, a tuple of axis names, or None.
The spec functions read only the mesh's axis names and sizes
(:func:`axis_sizes`), so a ``DeviceMesh`` and a plain ``{name: size}``
mapping serve alike and the rules run without a process group.
:func:`placements` turns a spec into ``DTensor`` placements on a
``DeviceMesh``: a dimension over several axes is ``Shard`` on each of
their mesh dimensions, in mesh order (pod-major, as the reference's).

The port keeps one tensor per layer (``blocks.{l}.attn.wq``) where the
reference stacks each pattern position's leaves over a leading periods
axis (``blocks/p{pi}/attn/wq``, shape ``(n_periods, *shape)``), and its
rules see that stacked shape: the FSDP threshold is on the stacked size
and "largest remaining dimension" ranges over the stacked dimensions.  So
:func:`param_specs` evaluates each rule on the reference's stacked path
and shape and drops the leading entry.  Where the reference shards the
periods axis itself (only grok-1-314b's router under ``dp``:
``P('model', 'data', None)`` on both production meshes), a per-layer
tensor cannot carry it, and the port replicates that leaf over the axis.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
from torch import nn

from ..configs.base import ArchConfig

#: parameters smaller than this stay replicated (norms, biases, routers)
_FSDP_MIN_SIZE = 2 ** 20

#: (substring match, preferred axis index -> mesh axis) rules; the FIRST rule
#: whose substring occurs in the path applies.  Dims are relative to the
#: UNSTACKED parameter; stacked block params have a leading period dim.
_MODEL_RULES: Tuple[Tuple[str, Dict[int, str]], ...] = (
    ("attn/wq", {1: "model"}),
    ("attn/wk", {1: "model"}),
    ("attn/wv", {1: "model"}),
    ("attn/wo", {0: "model"}),
    ("mlp/w_gate", {1: "model"}),
    ("mlp/w_up", {1: "model"}),
    ("mlp/w_down", {0: "model"}),
    ("moe/router", {}),
    ("moe/w_gate", {0: "model", 2: "model"}),   # EP if E divides, else d_ff
    ("moe/w_up", {0: "model", 2: "model"}),
    ("moe/w_down", {0: "model", 1: "model"}),
    ("ssm/in_proj", {1: "model"}),
    ("ssm/out_proj", {0: "model"}),
    ("embed", {0: "model"}),
    ("head", {1: "model"}),
    ("frontend_proj", {}),
)


class Spec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of axis
    names (sharded over all of them, outermost first) or None
    (replicated); ``Spec()`` replicates the whole tensor."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "Spec" + tuple.__repr__(self)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (by its dim names) or of a
    mapping that already is one, in mesh order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fits(dim: int, sizes: Dict[str, int], axis: str) -> bool:
    return dim % sizes[axis] == 0


def _spec_for(path: str, shape: Tuple[int, ...], mesh, stacked: bool,
              strategy: str = "tp") -> Spec:
    """The reference's rule for the leaf at ``path`` (its ``/`` path) of
    ``shape``.  Strategies:

    * ``tp`` — Megatron-style tensor parallelism on "model" (+ EP for MoE
      experts) with FSDP over "data";
    * ``dp`` — no tensor parallelism: "model" becomes a second data / ZeRO
      axis; MoE experts keep expert parallelism on "model"; every large
      parameter is FSDP-sharded over both axes;
    * ``serve`` — TP as ``tp``, but weights stay replicated over "data"
      unless a leaf holds 2^31 elements or more (4 GiB in bfloat16).
    """
    sizes = axis_sizes(mesh)
    offset = 1 if stacked else 0
    axes: list = [None] * len(shape)
    apply_model_rules = strategy in ("tp", "serve")
    if strategy == "dp" and "moe/" in path:
        apply_model_rules = True       # EP stays even under pure DP
    if apply_model_rules:
        for pat, rule in _MODEL_RULES:
            if pat in path:
                for dim, mesh_axis in rule.items():
                    d = dim + offset
                    if d < len(shape) and axes[d] is None \
                            and mesh_axis in sizes \
                            and _fits(shape[d], sizes, mesh_axis):
                        axes[d] = mesh_axis
                        break   # one model-axis assignment per param
                break
    # FSDP: shard the largest remaining dims over "data" (and, under the
    # dp strategy, over "model" as well — ZeRO over both axes)
    fsdp_axes = ["data"] if strategy in ("tp", "serve") \
        else ["data", "model"]
    min_size = _FSDP_MIN_SIZE if strategy != "serve" else 2 * 2 ** 30
    if int(np.prod(shape)) >= min_size:
        for mesh_axis in fsdp_axes:
            if mesh_axis not in sizes or mesh_axis in axes:
                continue   # each mesh axis at most once per spec
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for d in order:
                if axes[d] is None and _fits(shape[d], sizes, mesh_axis):
                    axes[d] = mesh_axis
                    break
    return Spec(*axes)


def reference_path(name: str, period: int) -> Tuple[str, bool]:
    """The reference's tree path of the port's parameter ``name`` and
    whether it is stacked over periods: layer ``l``'s ``blocks.{l}.attn.wq``
    is ``blocks/p{l % period}/attn/wq``; ``embed``, ``frontend_proj``,
    ``head`` and ``final_norm`` are themselves."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return "/".join(parts), False
    return "/".join(["blocks", f"p{int(parts[1]) % period}", *parts[2:]]), \
        True


def param_specs(params: nn.Module, mesh, strategy: str = "tp"
                ) -> Dict[str, Spec]:
    """The spec of every parameter of a model (``{name: Spec}`` in
    ``named_parameters`` order): the reference's rule on its stacked path
    and shape ``(n_periods, *shape)``, the periods entry dropped (an axis
    the reference puts there is replicated here)."""
    period = params.period
    n_periods = len(params.blocks) // period
    out = {}
    for name, p in params.named_parameters():
        path, stacked = reference_path(name, period)
        shape = (n_periods, *p.shape) if stacked else tuple(p.shape)
        spec = _spec_for(path, shape, mesh, stacked, strategy)
        out[name] = Spec(*spec[1:]) if stacked else spec
    return out


class NamedSharding(NamedTuple):
    """A spec on a ``DeviceMesh``: the reference's ``NamedSharding``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def placements(spec: Spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    every mesh dimension named by entry ``d``, ``Replicate()`` on the
    rest.  The axes of one entry must come in mesh order (DTensor shards
    a dimension over its mesh dimensions left to right).  A mesh
    dimension of size 1 holds the whole tensor whatever the spec says,
    and is ``Replicate()`` (a shard over it would only stop ``DTensor``
    from viewing a size-1 dimension away)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {d} are "
                             f"not in the mesh's order {names}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return out


def shardings_of(specs: Any, mesh) -> Any:
    """Each :class:`Spec` of a dict, list or tuple (of them) on ``mesh``."""
    if isinstance(specs, Spec):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: shardings_of(v, mesh) for k, v in specs.items()}
    return type(specs)(shardings_of(v, mesh) for v in specs)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over (pod outermost)."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def data_specs(mesh, batch: int, strategy: str = "tp") -> Dict[str, Spec]:
    """Input specs for (inputs, labels)."""
    tok = simple_batch_spec(mesh, batch, strategy)
    return {"inputs": tok, "labels": tok}


def simple_batch_spec(mesh, batch: int, strategy: str = "tp") -> Spec:
    """Shard the batch over as many mesh axes as divisibility allows:
    ``tp`` uses (pod, data); ``dp`` also folds "model" into the batch
    axes (pure data parallelism over the whole mesh)."""
    sizes = axis_sizes(mesh)
    cand = list(batch_axes(mesh))
    if strategy == "dp" and "model" in sizes:
        cand.append("model")
    axes = []
    prod = 1
    for a in cand:
        if batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return Spec(tuple(axes)) if axes else Spec()


def cache_specs(cfg: ArchConfig, mesh, batch: int) -> List[Any]:
    """Decode-state specs, one entry per layer as the port's caches are
    laid out: ``(K spec, V spec)`` for an attention layer's (B, Hkv, ctx,
    D) caches, the spec of an SSM layer's (B, H, P, N) state.  KV heads
    and SSM heads on "model", the batch on the data axes; where the kv
    heads cannot take "model", the KV sequence goes there (sequence-
    parallel decode); at batch 1 (long_500k) the sequence goes on "data".
    The reference's per-position specs, without its leading periods
    entry."""
    sizes = axis_sizes(mesh)
    bspec = simple_batch_spec(mesh, batch)
    b_axes = bspec[0] if len(bspec) else None
    by_position = []
    for spec in cfg.block_pattern:
        if spec.mixer == "attn":
            head_ax = "model" if "model" in sizes and \
                _fits(cfg.n_kv_heads, sizes, "model") else None
            if head_ax is None and "model" in sizes:
                seq_ax: Optional[str] = "model"
            elif b_axes is None and "data" in sizes:
                seq_ax = "data"
            else:
                seq_ax = None
            kv = Spec(b_axes, head_ax, seq_ax, None)
            by_position.append((kv, kv))
        else:
            head_ax = "model" if "model" in sizes and \
                _fits(cfg.ssm_heads, sizes, "model") else None
            by_position.append(Spec(b_axes, head_ax, None, None))
    period = len(cfg.block_pattern)
    return [by_position[l % period] for l in range(cfg.n_layers)]
