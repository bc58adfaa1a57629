"""deepseek-7b — llama-arch dense LM [arXiv:2401.02954; hf].

30L d_model=4096 32H (GQA kv=32 => MHA) d_ff=11008 vocab=102400.
Pure full attention: long_500k skipped (DESIGN.md §4).
"""

from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    block_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
))
