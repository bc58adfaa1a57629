"""repro_torch.perf — tile tuning for the hand-written kernels, the card
constants it ranks with, roofline terms on those constants, the analytic
cell costs, HLO collective parsing, and configuration ranking."""

from .analytic import CellCost, cell_cost, forward_flops
from .hlo_scale import scaled_collective_bytes, split_computations
from .predictor import (ConfigCandidate, RankedConfig, RankedTracedConfig,
                        rank_configs, rank_traced_configs)
from .roofline import (CARDS, H100_SXM, Card, RooflineTerms, card, card_of,
                       collective_bytes, model_flops_for, peak_flops)
from .tile_tuner import (TileChoice, predict_tile_time, rank_tiles,
                         select_tiles, tile_table)

__all__ = ["CARDS", "H100_SXM", "Card", "card", "card_of", "peak_flops",
           "RooflineTerms", "collective_bytes", "model_flops_for",
           "CellCost", "cell_cost", "forward_flops",
           "scaled_collective_bytes", "split_computations",
           "ConfigCandidate", "RankedConfig", "rank_configs",
           "RankedTracedConfig", "rank_traced_configs", "TileChoice",
           "predict_tile_time", "rank_tiles", "select_tiles", "tile_table"]
