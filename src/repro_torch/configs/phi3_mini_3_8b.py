"""phi3-mini-3.8b — RoPE SwiGLU dense LM [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32 => MHA) d_ff=8192 vocab=32064.
Pure full attention: long_500k skipped (DESIGN.md §4).
"""

from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    block_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
))
