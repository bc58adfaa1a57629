"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means target units).
Encoder-only (bidirectional, non-causal): no decode step — shapes limited to
train_4k and prefill_32k (encoder forward); decode_32k / long_500k skipped
(DESIGN.md §4).  The CNN waveform frontend is a STUB: ``input_specs()``
provides precomputed 20ms frame embeddings.
"""

from .base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    block_pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    frontend="audio",
    frontend_dim=512,    # conv feature extractor output dim (stub)
    shapes=("train_4k", "prefill_32k"),
))
