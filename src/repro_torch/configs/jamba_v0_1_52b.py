"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.  Each period of 8
layers has 1 attention + 7 Mamba layers; MoE (16 experts, top-2) on every
second layer.  7/8 of layers are SSM => long_500k runs; the attention
layers use a KV window capped at 4096 for that shape (DESIGN.md §4).
"""

from .base import ArchConfig, LayerSpec, register

_P = []
for i in range(8):
    mixer = "attn" if i == 4 else "ssm"   # 1:7 attn:mamba per period
    ffn = "moe" if i % 2 == 1 else "dense"
    _P.append(LayerSpec(mixer=mixer, ffn=ffn))

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    block_pattern=tuple(_P),
    n_experts=16,
    top_k=2,
    moe_impl="einsum",   # beats scatter dispatch for 16 experts (§Perf)
    ssm_state=16,
    ssm_heads=128,        # d_inner 8192 / head_dim 64
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    ssm_chunk=256,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    long_context_kv_cap=4096,
))
