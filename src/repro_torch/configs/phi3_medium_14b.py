"""phi3-medium-14b — RoPE SwiGLU GQA dense LM [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
40 q-heads / 10 kv-heads: with TP > 10 the kv heads are replicated
x(tp/10) by the sharding rules (DESIGN.md §4).
Pure full attention: long_500k skipped.
"""

from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    block_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
))
