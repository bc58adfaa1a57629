"""Production and local meshes, the counterpart of
``repro/launch/mesh.py``.

Both are functions, never module-level constants, so importing this module
touches no device and no process group.  The single-pod mesh is 16 x 16 =
256 cards ("data", "model"); the multi-pod mesh stacks a "pod" axis in
front: 2 x 16 x 16 = 512.  Each is a ``DeviceMesh`` over the default
process group, which the caller starts (NCCL on the cards; the dry run's
``"fake"`` group of 256 or 512 ranks, :mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .._device import DeviceLike, resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one, of ``device``'s type (the
    card's unless the CPU is asked for)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceLike = None) -> DeviceMesh:
    """A small ("data", "model") mesh over the ranks that exist (tests,
    examples): ``data`` clamped to the world size, ``model`` to what is
    left, as the reference clamps to ``len(jax.devices())``."""
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, n // data)
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))
