"""repro_torch.perf — tile tuning for the hand-written kernels, the card
constants it ranks with, and configuration ranking on the batched
prediction engine."""

from .predictor import RankedTracedConfig, rank_traced_configs
from .roofline import CARDS, H100_SXM, Card, card, card_of, peak_flops
from .tile_tuner import (TileChoice, predict_tile_time, rank_tiles,
                         select_tiles, tile_table)

__all__ = ["CARDS", "H100_SXM", "Card", "card", "card_of", "peak_flops",
           "RankedTracedConfig", "rank_traced_configs", "TileChoice",
           "predict_tile_time", "rank_tiles", "select_tiles", "tile_table"]
