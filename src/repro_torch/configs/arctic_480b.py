"""arctic-480b — 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000.  Every layer combines
a dense residual MLP with a 128-expert top-2 MoE (``ffn="moe+dense"``) — the
heaviest expert-parallel case in the pool.
Pure full attention: long_500k skipped (DESIGN.md §4).
"""

from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    block_pattern=(LayerSpec(mixer="attn", ffn="moe+dense"),),
    n_experts=128,
    top_k=2,
    moe_impl="einsum",   # best compiling config at 128 experts (§Perf)
    shapes=("train_4k", "prefill_32k", "decode_32k"),
))
