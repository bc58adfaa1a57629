"""chameleon-34b — early-fusion VLM, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  The modality
frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch-token embeddings; the backbone is a dense GQA decoder over
the fused token stream.
"""

from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    block_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    frontend="vision",
    frontend_dim=1024,   # VQ-VAE patch embedding dim (stub)
    shapes=("train_4k", "prefill_32k", "decode_32k"),
))
