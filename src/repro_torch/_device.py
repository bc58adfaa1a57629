"""Device resolution and numpy <-> torch conversion for the port.

Every entry point of :mod:`repro_torch` takes an explicit ``device=``
argument and resolves it here.  ``None`` means the CUDA card: the port is
written for it, and a missing card is an error, never a silent fall back
to the CPU.  The CPU runs only when a caller asks for it
(``device="cpu"``), as the tests do.

Importing this module pins float32 matrix products and convolutions to
full IEEE float32 (no TF32): the reference computes in float32 and the
kernel tolerances (2e-5) leave no room for TF32's ten-bit mantissa.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Optional[Union[str, torch.device]]

#: numpy dtype name -> torch dtype for the port's three value types.
#: numpy has no bfloat16: a bf16 tensor converts from and to float32 arrays.
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the CPU is asked for.

    Raises ``RuntimeError`` when CUDA is requested (explicitly or by
    default) and no card is present, and ``ValueError`` for any device
    type other than ``cuda`` and ``cpu``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch paths on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for every queued operation on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_torch(array, device: DeviceLike = None,
             dtype: Union[str, torch.dtype, None] = None) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (resolved as above).

    ``dtype`` is a torch dtype or one of ``"float32"``, ``"float64"``,
    ``"bfloat16"``; ``None`` keeps the array's own type.
    """
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    t = torch.from_numpy(np.ascontiguousarray(array))
    return t.to(device=resolve_device(device), dtype=dtype)


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bfloat16 widens to float32, exactly).

    For a CUDA tensor this is the blocking device-to-host copy the timing
    protocol relies on (:mod:`repro_torch.core.sampler`).
    """
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
