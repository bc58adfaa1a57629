"""Plain PyTorch oracles for the hand-written kernels (the ``ref.py``
contract of ``repro.kernels.ref``)."""

from __future__ import annotations

import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` with float32 accumulation, cast to the input dtype."""
    return torch.matmul(x.float(), y.float()).to(x.dtype)
