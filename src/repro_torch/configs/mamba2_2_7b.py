"""mamba2-2.7b — pure SSM (attention-free) LM [arXiv:2405.21060].

64L d_model=2560, vocab=50280, ssm_state=128, SSD (state-space duality).
d_ff=0: no separate FFN — the Mamba-2 block carries all per-layer compute.
Sub-quadratic state => long_500k runs (DESIGN.md §4).
"""

from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,            # no attention heads (attn-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    block_pattern=(LayerSpec(mixer="ssm", ffn="none"),),
    ssm_state=128,
    ssm_heads=80,         # d_inner 5120 / head_dim 64
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    ssm_chunk=256,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
))
