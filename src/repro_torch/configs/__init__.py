"""Assigned architecture configs (``--arch <id>``): the port's copy of
``repro.configs``, data only, held against it field for field."""

from . import (arctic_480b, chameleon_34b, deepseek_7b, gemma2_27b,
               grok_1_314b, hubert_xlarge, jamba_v0_1_52b, mamba2_2_7b,
               phi3_medium_14b, phi3_mini_3_8b)
from .base import (SHAPES, ArchConfig, LayerSpec, ShapeSpec, all_configs,
                   get_config, reduced, register)

ALL_ARCHS = tuple(sorted(all_configs()))

__all__ = ["SHAPES", "ArchConfig", "LayerSpec", "ShapeSpec", "all_configs",
           "get_config", "reduced", "register", "ALL_ARCHS"]
