"""Analytic per-cell FLOP and HBM-byte accounting (MaxText-style): the
port's copy of ``repro.perf.analytic``, the same arithmetic term for term,
so its counts equal the reference's bit for bit.

The reference reports these counts beside XLA's ``cost_analysis()``,
which counts ``while``-loop bodies once; the port has no compiled module,
and uses them as the model-FLOP count of a step (``chip_smoke.py`` sets
them beside a step's measured time).  Every formula is per GLOBAL step;
callers divide by device count.

Conventions:
* attention score/value FLOPs use the *average* causal kv length
  (S+1)/2, window-clipped;
* training = 3x forward (fwd + 2x bwd) + 1x forward for the per-period
  remat recompute;
* HBM bytes: parameter reads (fwd + bwd), optimizer moment traffic,
  activation carries, KV/state cache traffic for decode — a deliberate
  first-order model.  ``BF16`` and ``F32`` below are byte sizes, not
  rates of any device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..configs.base import ArchConfig, ShapeSpec

BF16 = 2
F32 = 4


def _attn_flops_per_token(cfg: ArchConfig, kv_len: float,
                          window: int) -> float:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * d * hq * hd + 2 * 2 * d * hkv * hd + 2 * hq * hd * d
    eff = min(kv_len, window) if window else kv_len
    scores = 2 * 2 * hq * hd * eff          # QK^T + PV
    return proj + scores


def _ssm_flops_per_token(cfg: ArchConfig) -> float:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, p = (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                  cfg.ssm_head_dim)
    q = cfg.ssm_chunk
    proj = 2 * d * (2 * di + 2 * g * n + h) + 2 * di * d
    # SSD per chunk: CB^T (q^2 n h), GX (q^2 p h), state update + inter
    intra = 2 * q * h * (n + p)             # per token: two q x q matmuls
    state = 6 * h * n * p                   # update + inter-chunk read
    return proj + intra + state


def _ffn_flops_per_token(cfg: ArchConfig, ffn: str) -> float:
    d, f = cfg.d_model, cfg.d_ff
    dense = 3 * 2 * d * f
    if ffn == "dense":
        return dense
    moe = (cfg.top_k * dense                         # expert matmuls
           + 2 * d * cfg.n_experts                   # router
           + 2 * 2 * d * cfg.n_experts * 1.25 * cfg.top_k)  # dispatch+combine
    if ffn == "moe":
        return moe
    if ffn == "moe+dense":
        return moe + dense
    return 0.0


def forward_flops(cfg: ArchConfig, batch: int, seq: int, *,
                  kv_len: float = None, decode: bool = False) -> float:
    """FLOPs of one forward pass over batch x seq tokens."""
    tokens = batch * seq
    kv = kv_len if kv_len is not None else (seq + 1) / 2.0
    total = 0.0
    for spec in cfg.layer_specs():
        if spec.mixer == "attn":
            w = spec.window
            if cfg.long_context_kv_cap and kv > cfg.long_context_kv_cap:
                w = min(w or cfg.long_context_kv_cap,
                        cfg.long_context_kv_cap)
            total += tokens * _attn_flops_per_token(cfg, kv, w)
        else:
            if decode:
                # O(1) recurrence step: projections + state update
                d, di = cfg.d_model, cfg.d_inner
                g, n, h, p = (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                              cfg.ssm_head_dim)
                total += tokens * (2 * d * (2 * di + 2 * g * n + h)
                                   + 2 * di * d + 6 * h * n * p)
            else:
                total += tokens * _ssm_flops_per_token(cfg)
        total += tokens * _ffn_flops_per_token(cfg, spec.ffn)
    total += tokens * 2 * cfg.d_model * cfg.vocab      # head
    return total


@dataclass(frozen=True)
class CellCost:
    flops: float          # global FLOPs per step
    hbm_bytes: float      # global HBM bytes per step


def cell_cost(cfg: ArchConfig, shape: ShapeSpec,
              remat_policy=None) -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    n_params = cfg.param_count()
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        fwd = forward_flops(cfg, b, s)
        # full remat recomputes the whole forward (4x fwd total);
        # the "dots" policy saves matmul outputs -> ~3.2x fwd
        factor = 3.2 if remat_policy == "dots" else 4.0
        flops = factor * fwd
        act_carry = cfg.n_layers * b * s * cfg.d_model * BF16
        act_factor = 4 if remat_policy != "dots" else 8  # more saved acts
        hbm = (4 * n_active * BF16            # param reads fwd/bwd/remat/upd
               + 3 * n_params * F32           # adam moments r/w + grads
               + act_factor * act_carry)      # carry save + reload
        return CellCost(flops, hbm)
    if shape.kind == "prefill":
        fwd = forward_flops(cfg, b, s)
        act = cfg.n_layers * b * s * cfg.d_model * BF16
        return CellCost(fwd, n_active * BF16 + 2 * act + _cache_bytes(cfg,
                                                                      b, s))
    # decode: one token against a KV/state cache of length s
    kv = min(s, cfg.long_context_kv_cap) if cfg.long_context_kv_cap else s
    flops = forward_flops(cfg, b, 1, kv_len=kv, decode=True)
    hbm = n_active * BF16 + _cache_bytes(cfg, b, s)
    return CellCost(flops, hbm)


def _cache_bytes(cfg: ArchConfig, batch: int, ctx: int) -> float:
    """Bytes of the full decode cache (read each decode step)."""
    total = 0.0
    hd = cfg.head_dim_
    for spec in cfg.layer_specs():
        if spec.mixer == "attn":
            c = ctx
            if cfg.long_context_kv_cap:
                c = min(c, cfg.long_context_kv_cap)
            if spec.window:
                c = min(c, spec.window)
            total += 2 * batch * cfg.n_kv_heads * c * hd * BF16
        else:
            total += batch * cfg.ssm_heads * cfg.ssm_head_dim * \
                cfg.ssm_state * F32
    return total
