"""repro_torch.models — the port of ``repro.models`` for the assigned
architecture pool: ``nn.Module`` parameters, plain functions on tensors,
attention and the Mamba-2 scan through the hand-written kernels."""

from .attention import attn_forward, chunked_attention, init_attn
from .layers import apply_rope, cross_entropy, rmsnorm, softcap, swiglu
from .mamba import init_mamba, init_ssm_state, mamba_forward
from .moe import init_moe, moe_forward
from .prefill import prefill
from .transformer import (decode_step, forward, forward_hidden,
                          init_decode_state, init_params, n_periods)

__all__ = ["attn_forward", "chunked_attention", "init_attn", "apply_rope",
           "cross_entropy", "rmsnorm", "softcap", "swiglu", "init_mamba",
           "init_ssm_state", "mamba_forward", "init_moe", "moe_forward",
           "prefill", "decode_step", "forward", "forward_hidden",
           "init_decode_state", "init_params", "n_periods"]
