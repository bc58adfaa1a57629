"""repro_torch.perf — tile tuning for the hand-written kernels and the
card constants it ranks with."""

from .roofline import CARDS, H100_SXM, Card, card, card_of
from .tile_tuner import (TileChoice, predict_tile_time, rank_tiles,
                         select_tiles)

__all__ = ["CARDS", "H100_SXM", "Card", "card", "card_of", "TileChoice",
           "predict_tile_time", "rank_tiles", "select_tiles"]
