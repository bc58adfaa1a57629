"""repro_torch.perf — tile tuning for the hand-written kernels and the
card constants it ranks with."""

from .roofline import CARDS, H100_SXM, Card, card, card_of, peak_flops
from .tile_tuner import (TileChoice, predict_tile_time, rank_tiles,
                         select_tiles)

__all__ = ["CARDS", "H100_SXM", "Card", "card", "card_of", "peak_flops",
           "TileChoice",
           "predict_tile_time", "rank_tiles", "select_tiles"]
