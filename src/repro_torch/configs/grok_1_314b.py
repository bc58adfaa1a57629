"""grok-1-314b — MoE 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.
Pure full attention: long_500k skipped (DESIGN.md §4).
"""

from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    block_pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    n_experts=8,
    top_k=2,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
))
