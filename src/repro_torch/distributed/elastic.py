"""Elastic re-scaling: resume a job on a different mesh, the counterpart
of ``repro/distributed/elastic.py``.

On node failure the launcher re-forms a (smaller or larger) mesh from the
surviving hosts; parameters and optimizer state restore from the last
checkpoint and are re-placed under the new mesh's rules
(``checkpoint.restore(shardings=...)``: each rank reads the saved array
and keeps its shard).  The data pipeline needs no rewind logic because
batches are a pure function of the step.

A tree here is a model, or ``(model, AdamWState)`` as the trainer saves
it: the moments take their parameter's spec, the step count is
replicated.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from ..train.optimizer import AdamWState
from .sharding import NamedSharding, Spec, param_specs


def leaf_specs(tree: Any, mesh, strategy: str = "tp") -> List[Spec]:
    """The spec of every leaf of ``tree`` in checkpoint order
    (:func:`repro_torch.train.checkpoint.leaves`): a model's parameters
    under :func:`param_specs`, then for an ``AdamWState`` a replicated
    step and each moment under its parameter's spec."""
    if isinstance(tree, nn.Module):
        return list(param_specs(tree, mesh, strategy).values())
    model, state = tree
    if not isinstance(model, nn.Module) or \
            not isinstance(state, AdamWState):
        raise TypeError("a tree is a model or (model, AdamWState), got "
                        f"{type(tree)}")
    specs = leaf_specs(model, mesh, strategy)
    return specs + [Spec()] + specs + specs


def _placed(leaf: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``leaf`` (a tensor, or a ``DTensor`` on another mesh, gathered
    first) as a ``DTensor`` on ``sharding``; every rank holds the full
    value, so each keeps its shard without communication."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    device = torch.device(sharding.mesh.device_type, leaf.device.index)
    return distribute_tensor(leaf.detach().to(device), sharding.mesh,
                             sharding.placements, src_data_rank=None)


def reshard_tree(tree: Any, mesh, strategy: str = "tp") -> Any:
    """Re-place every leaf under the sharding rules evaluated on ``mesh``:
    a model's parameters become ``DTensor`` parameters in place (their
    ``requires_grad`` kept), an ``AdamWState``'s tensors new ``DTensor``s.
    Returns the tree (the model itself, or ``(model, new state)``)."""
    from ..train.checkpoint import leaves, rebuild
    specs = leaf_specs(tree, mesh, strategy)
    placed = [_placed(leaf, NamedSharding(mesh, spec))
              for leaf, spec in zip(leaves(tree), specs)]
    return rebuild(tree, placed)


def resume_on_mesh(ckpt_dir: str, tree_like: Any, mesh,
                   step: Optional[int] = None,
                   strategy: str = "tp") -> Tuple[Any, int]:
    """Restore the latest checkpoint (or ``step``) directly onto ``mesh``:
    ``(tree, step)``, every leaf a ``DTensor`` under the rules on
    ``mesh``."""
    from ..train.checkpoint import restore
    shardings = [NamedSharding(mesh, s)
                 for s in leaf_specs(tree_like, mesh, strategy)]
    return restore(ckpt_dir, tree_like, step=step, shardings=shardings)
