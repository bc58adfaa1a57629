"""Hand-written CUDA kernels for Hopper, each beside its plain version.

* ``matmul`` — tiled matmul (the dgemm analogue; tunable tiles) by two
  routes, ``wgmma`` on the tensor cores (bfloat16, and float32 as three
  TF32 products) and FP32 FFMA, replacing
  ``repro/kernels/matmul.py::_matmul_kernel``
* ``flash_attention`` — online-softmax attention (GQA, causal, sliding
  window, softcap) on the tensor cores by two routes (``wgmma`` for the
  models' bfloat16 blocks, ``mma.sync`` for the rest), replacing
  ``repro/kernels/flash_attention.py::_attn_kernel``, and its gradient ``flash_attention_bwd`` (three kernels:
  delta, dK/dV, dQ; the reference has no backward kernel)
* ``ssd`` — the Mamba-2 chunked SSD scan, replacing
  ``repro/kernels/ssd.py::_ssd_kernel``, and its gradient ``ssd_bwd``
  (four kernels: each chunk's D_c, the reverse state pass, the chunk
  backward, the fixed-order finish; the reference has no backward kernel)
* ``adamw`` -- the optimizer step: each gradient's sum of squares for the
  clip and one tensor's AdamW update in one pass, the plain version's
  bits (the reference's update is fused by XLA; no Pallas body)
* ``mamba_mixer`` -- the Mamba-2 mixer's elementwise glue around the SSD:
  the SSD's operands from the in-projection's output, the D skip with the
  gated RMSNorm, and both backwards into one gradient buffer, spanned by
  ``MambaMixerFn`` (XLA fuses the reference's glue; no Pallas body)
* ``rmsnorm`` -- the block RMSNorm: its forward (each row's rstd kept)
  and its backward (scale's gradient as per-block partials and a
  fixed-order finish), spanned by ``RmsNormFn`` (XLA fuses the
  reference's norm; no Pallas body)

``ops`` holds the public wrappers, ``ref`` the plain PyTorch oracles.  The
kernels are built from ``csrc/`` on first use (:mod:`._build`).  The
attention and SSD forwards and backwards are also ``torch.library``
operators (``repro_torch::flash_attention_fwd``, ``flash_attention_bwd``,
``ssd_fwd``, ``ssd_bwd``) with fake implementations, autograd and flop
formulas, and so are AdamW's (``adamw_sqnorm``, ``adamw_update``,
``adamw_update_apply``) and the mixer's (``mamba_in``, ``mamba_out``,
``mamba_out_bwd``, ``mamba_in_bwd``) and the norm's (``rmsnorm_fwd``,
``rmsnorm_bwd``), so that a sharded or traced step reaches them.
"""

from . import ops, ref
from .flash_attention import flash_attention, flash_attention_bwd
from .matmul import matmul, smem_bytes, tile_legal
from .rmsnorm import rmsnorm_bwd, rmsnorm_fwd
from .ssd import ssd, ssd_bwd

__all__ = ["ops", "ref", "matmul", "flash_attention", "flash_attention_bwd",
           "ssd", "ssd_bwd", "rmsnorm_fwd", "rmsnorm_bwd", "smem_bytes",
           "tile_legal"]
