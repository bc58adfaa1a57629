"""gemma2-27b — local+global alternating attention, logit softcap
[arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128.
Alternating sliding-window (4096) / global layers; attention softcap 50,
final-logit softcap 30.  long_500k decode runs with global-layer KV windowed
to 32k (deviation documented in DESIGN.md §4).
"""

from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    attn_softcap=50.0,
    logit_softcap=30.0,
    block_pattern=(
        LayerSpec(mixer="attn", ffn="dense", window=4096),  # local
        LayerSpec(mixer="attn", ffn="dense", window=0),     # global
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    long_context_kv_cap=32768,
))
