"""Peak rates of the cards the port runs on, keyed by device name.

The counterpart of the constants of ``repro/perf/roofline.py`` (which are
a TPU's).  Every number here is the card's published figure (NVIDIA's
H100 data sheet, SXM part, dense rates without sparsity, at its full
700 W power limit); a card set below that limit runs slower under load,
so measured shares are stated beside the card's power limit.  The names
are what ``torch.cuda.get_device_name()`` returns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


@dataclass(frozen=True)
class Card:
    """Published peak rates and sizes of one card."""

    name: str
    fp32_flops: float        # FLOP/s, float32 outside the tensor cores
    bf16_tensor_flops: float  # FLOP/s, dense bfloat16 on the tensor cores
    tf32_tensor_flops: float  # FLOP/s, dense TF32 on the tensor cores
    hbm_bytes_per_s: float   # device-memory bandwidth
    sms: int                 # streaming multiprocessors
    power_w: float           # the power limit the rates assume


#: the H100 SXM (80 GB HBM3), the card the port is written for
H100_SXM = Card(name="NVIDIA H100 80GB HBM3", fp32_flops=67e12,
                bf16_tensor_flops=989e12, tf32_tensor_flops=495e12,
                hbm_bytes_per_s=3.35e12, sms=132,
                power_w=700.0)

CARDS: Dict[str, Card] = {c.name: c for c in (H100_SXM,)}


def card(name: str) -> Card:
    """The constants of the card ``torch.cuda.get_device_name()`` names;
    raises ``KeyError`` for a card whose figures are not recorded here
    (no silent substitution of another card's peaks)."""
    try:
        return CARDS[name]
    except KeyError:
        raise KeyError(f"no published constants recorded for {name!r}; "
                       f"known cards: {sorted(CARDS)}") from None


def card_of(device: torch.device) -> Card:
    """The constants of ``device``'s card: a CUDA device is looked up by
    ``torch.cuda.get_device_name``; the CPU, which has no card, ranks
    with the H100 SXM's (the card the port is written for)."""
    if device.type == "cuda":
        return card(torch.cuda.get_device_name(device))
    return H100_SXM


def peak_flops(the_card: Card, dtype: torch.dtype) -> float:
    """The card's peak rate for operands of ``dtype``: the dense bfloat16
    tensor-core rate for bfloat16 (the least time any bfloat16 kernel
    could take), the FP32 non-tensor rate for float32 (kept IEEE, no
    TF32)."""
    if dtype == torch.bfloat16:
        return the_card.bf16_tensor_flops
    if dtype == torch.float32:
        return the_card.fp32_flops
    raise ValueError(f"no peak rate recorded for {dtype}")
