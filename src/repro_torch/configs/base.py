"""Architecture configuration schema for the assigned model pool.

The port's copy of ``repro/configs/base.py``, field for field: the schema
has no backend.  One declarative :class:`ArchConfig` drives model
construction (``repro_torch.models``), input specs, sharding rules and the
dry-run.  Layers are described by a repeating *block pattern* so dense /
MoE / SSM / hybrid architectures share one code path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One transformer block: mixer (attention or SSM) + FFN flavour."""

    mixer: str = "attn"         # "attn" | "ssm"
    ffn: str = "dense"          # "dense" | "moe" | "moe+dense" | "none"
    window: int = 0             # sliding-window size for local attention


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    causal: bool = True          # False => encoder-only (hubert)
    # attention details
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    # block pattern (repeated/truncated to n_layers)
    block_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    # MoE
    n_experts: int = 0
    top_k: int = 2
    moe_capacity_factor: float = 1.25
    #: data-axis width for shard-local MoE dispatch (set by the launcher to
    #: the mesh's data extent; 1 = single shard, same semantics)
    moe_data_shards: int = 1
    #: "scatter" (O(t*k*d) dispatch, default) or "einsum" (one-hot O(t*e*c);
    #: best compiling config for arctic's 128 experts — EXPERIMENTS §Perf)
    moe_impl: str = "scatter"
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # modality frontend stub
    frontend: str = "none"       # none | audio | vision
    frontend_dim: int = 0        # precomputed frame/patch embedding dim
    # which shapes this arch supports (see DESIGN.md §4)
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    # long-context KV window cap for attention layers (jamba/gemma2 long_500k)
    long_context_kv_cap: int = 0

    # ------------------------------------------------------------ derived --
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_specs(self) -> List[LayerSpec]:
        pat = self.block_pattern
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def param_count(self, active_only: bool = False) -> float:
        """Approximate parameter count N (for MODEL_FLOPS = 6 N D)."""
        d, hd = self.d_model, self.head_dim_
        n = 0.0
        for spec in self.layer_specs():
            if spec.mixer == "attn":
                n += d * hd * self.n_heads            # q
                n += 2 * d * hd * self.n_kv_heads     # k, v
                n += hd * self.n_heads * d            # o
            else:  # ssm
                di, g, ns, h = (self.d_inner, self.ssm_groups,
                                self.ssm_state, self.ssm_heads)
                n += d * (2 * di + 2 * g * ns + h)    # in_proj
                n += di * d                           # out_proj
            dense_ffn = 3 * d * self.d_ff             # SwiGLU
            if spec.ffn == "dense":
                n += dense_ffn
            elif spec.ffn == "moe":
                k = self.n_experts if not active_only else self.top_k
                n += k * dense_ffn
            elif spec.ffn == "moe+dense":
                k = self.n_experts if not active_only else self.top_k
                n += k * dense_ffn + dense_ffn
            n += 2 * d                                # norms
        n += self.vocab * d                           # embed (tied head)
        return n


# -------------------------------------------------------------- shapes ----

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


# ------------------------------------------------------------- registry ---

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (ensure arch modules imported)
    return _REGISTRY[name]


def all_configs() -> Dict[str, ArchConfig]:
    import repro_torch.configs  # noqa: F401
    return dict(_REGISTRY)


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 64,
            d_ff: int = 128, vocab: int = 512) -> ArchConfig:
    """Smoke-test-sized config of the same family (assignment requirement)."""
    heads = max(2, min(4, cfg.n_heads))
    kv = max(1, min(heads, cfg.n_kv_heads * heads // cfg.n_heads)) or heads
    kv = heads // max(1, heads // max(1, kv))
    while heads % kv:
        kv -= 1
    kw = {}
    if cfg.n_experts:
        kw["n_experts"] = min(4, cfg.n_experts)
        # lossless capacity at smoke scale: prefill == decode numerics
        kw["moe_capacity_factor"] = float(kw["n_experts"]) / cfg.top_k
    if cfg.ssm_heads:
        kw["ssm_head_dim"] = 16
        kw["ssm_heads"] = cfg.ssm_expand * d_model // 16  # = d_inner / hd
        kw["ssm_state"] = 16
        kw["ssm_groups"] = 1
        kw["ssm_chunk"] = 32
    if cfg.frontend_dim:
        kw["frontend_dim"] = 32
    period = len(cfg.block_pattern)
    n_layers = max(n_layers, period)
    n_layers += (-n_layers) % period
    return replace(cfg, name=cfg.name + "-smoke", n_layers=n_layers,
                   d_model=d_model, n_heads=heads, n_kv_heads=kv,
                   d_ff=d_ff, vocab=vocab, head_dim=None, **kw)
