"""Measured tile selection for the hand-written matmul (the paper's
block-size optimization applied to kernel tiles).

The paper tunes a blocked algorithm's block size b by predicting runtime
over candidate b and taking the argmin (§4.6).  The GPU analogue tunes the
CUDA matmul's (bm, bn, bk) across its two routes (the tile picks the route,
:func:`~repro_torch.kernels.matmul.matmul_route`): candidates are the union
of the routes' tiles, filtered by *legality* (tiles that divide the
problem, a route that takes them, staging that fits the card's shared
memory per block — :func:`~repro_torch.kernels.matmul.tile_legal`) and
ranked by **measured per-step tile models** served through a
:class:`~repro_torch.tc.session.PredictorSession`'s device facet
(:mod:`repro_torch.tc.device`): each candidate's predicted total is
``T_h2d + per_step(bm, bn, bk) * grid_steps + T_d2h``, with the transfer
terms fitted from the memcpy micro-benchmark; each route's measurements
fit a model of their own (:mod:`repro_torch.tc.device`).

The *analytic* three-term model (:func:`predict_tile_time`) ranks with
``analytic=True`` or without a session: the measurement-free path, and
the measured path's equivalence oracle.  It takes the card's published
constants (:mod:`repro_torch.perf.roofline`): those of the session's
card, or of the current card without a session; the CPU, which has none,
ranks with the H100 SXM's:

* compute:   2 m n k FLOPs at the tile's route's rate: the card's FP32
  rate on the ffma route (both input types), its bfloat16 tensor rate on
  the wgmma route in bfloat16, and a third of its TF32 tensor rate on the
  wgmma route in float32 (three TF32 products a product);
* memory:    device-memory traffic: every block re-reads its operand
  panels, so total traffic = m*k*(n/bn) + k*n*(m/bm) + m*n elements —
  small bm/bn re-stream the other operand (the float32 wgmma route's
  panels are the operands' hi and lo halves, counted as the panels they
  replace: the term stands for the panels' count, as L2 serves most
  re-reads on the card); its split pre-passes, which read x and y and
  write the 2 (m + n) k floats before the kernel runs, add their bytes'
  time;
* overhead:  a fixed cost per (block, k-slab) step (the barrier and the
  ring's bookkeeping of one slab), spread over the card's SMs, which run
  blocks in parallel.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from ..kernels._card import H100_SMEM_OPTIN
from ..kernels.matmul import grid_steps, matmul_route, tile_legal
from .roofline import H100_SXM, Card, card_of

#: napkin cost of one (block, k-slab) step: one barrier and a ring slot
_SLAB_OVERHEAD_S = 5e-7
#: tile sizes tried in every dimension; legality keeps the tiles a route
#: takes whose staging fits
_CANDIDATES = (8, 16, 32, 64, 128, 256)
#: the device-suite registry name of the hand-written matmul
KERNEL = "cuda_matmul"


@dataclass(frozen=True)
class TileChoice:
    """One selected/ranked tile config.  ``predicted_s`` is the ranking
    total; the transfer/compute split and provenance are populated on the
    measured path (zeros and ``"analytic"`` on the analytic one)."""

    bm: int
    bn: int
    bk: int
    predicted_s: float
    t_h2d: float = 0.0
    t_compute: float = 0.0
    t_d2h: float = 0.0
    source: str = "analytic"     # "analytic" | "measured" | "model"


def _dtype(itemsize: int) -> torch.dtype:
    """The operands' dtype of an itemsize: 4 float32, 2 bfloat16."""
    return torch.float32 if itemsize == 4 else torch.bfloat16


def predict_tile_time(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                      itemsize: int = 4, card: Card = H100_SXM) -> float:
    """The analytic three-term estimate — the measured path's oracle — at
    the rate of the route the tile takes."""
    flops = 2.0 * m * n * k
    split_bytes = 0.0
    if matmul_route(_dtype(itemsize), bm, bn, bk) != "wgmma":
        compute = flops / card.fp32_flops
    elif itemsize == 4:
        compute = 3.0 * flops / card.tf32_tensor_flops
        split_bytes = 4.0 * 3 * (m + n) * k
    else:
        compute = flops / card.bf16_tensor_flops
    traffic = itemsize * (m * k * (n / bn) + k * n * (m / bm) + m * n)
    memory = traffic / card.hbm_bytes_per_s
    steps = grid_steps(m, n, k, bm, bn, bk)
    return max(compute, memory) + split_bytes / card.hbm_bytes_per_s + \
        steps * _SLAB_OVERHEAD_S / card.sms


def legal_candidates(m: int, n: int, k: int,
                     candidates: Sequence[int] = _CANDIDATES,
                     smem_limit: int = H100_SMEM_OPTIN,
                     dtype: torch.dtype = torch.float32,
                     ) -> List[Tuple[int, int, int]]:
    """Clamped-to-dims, deduplicated, legality-filtered candidate tiles:
    the union of both routes' tiles in ``dtype``."""
    legal = []
    seen = set()
    for bm, bn, bk in itertools.product(candidates, repeat=3):
        cfg = (min(bm, m), min(bn, n), min(bk, k))
        if cfg in seen:
            continue
        seen.add(cfg)
        if tile_legal(m, n, k, *cfg, smem_limit, dtype):
            legal.append(cfg)
    return legal


def rank_tiles(m: int, n: int, k: int, *,
               session=None, analytic: bool = False,
               smem_limit: int = H100_SMEM_OPTIN,
               candidates: Sequence[int] = _CANDIDATES,
               stat: str = "med", transfer: bool = True,
               itemsize: int = 4) -> List[TileChoice]:
    """Every legal tile config ranked fastest-predicted first.

    With a ``session`` (a :class:`~repro_torch.tc.PredictorSession`) and
    ``analytic=False``, rankings come from measured per-step device
    models plus fitted H2D/D2H transfer terms
    (:meth:`~repro_torch.tc.session.PredictorSession.rank_device_tiles`);
    measurements already in the session's suite are never re-taken.
    ``analytic=True`` (or ``session=None``) ranks with
    :func:`predict_tile_time` instead, on the constants of the session's
    card (of the current card without a session, of the H100 SXM on the
    CPU).  ``smem_limit`` is the card's opt-in shared memory per block.
    """
    legal = legal_candidates(m, n, k, candidates, smem_limit,
                             _dtype(itemsize))
    if not legal:
        raise ValueError(f"no legal tile for ({m},{n},{k}) "
                         f"within {smem_limit} B of shared memory")
    if analytic or session is None:
        if session is not None:
            dev = session.device_suite().device
        else:
            dev = torch.device("cuda" if torch.cuda.is_available()
                               else "cpu")
        the_card = card_of(dev)
        ranked = [TileChoice(bm, bn, bk,
                             predict_tile_time(m, n, k, bm, bn, bk,
                                               itemsize, the_card))
                  for bm, bn, bk in legal]
        ranked.sort(key=lambda t: (t.predicted_s, (t.bm, t.bn, t.bk)))
        return ranked
    device = session.rank_device_tiles(KERNEL, (m, n, k), legal,
                                       stat=stat, transfer=transfer,
                                       itemsize=itemsize)
    return [TileChoice(r.config[0], r.config[1], r.config[2],
                       predicted_s=r.t_total, t_h2d=r.t_h2d,
                       t_compute=r.t_compute, t_d2h=r.t_d2h,
                       source=r.source)
            for r in device]


def select_tiles(m: int, n: int, k: int, *,
                 session=None, analytic: bool = False,
                 smem_limit: int = H100_SMEM_OPTIN,
                 candidates: Sequence[int] = _CANDIDATES,
                 stat: str = "med", transfer: bool = True,
                 itemsize: int = 4) -> TileChoice:
    """Pick (bm, bn, bk) without executing any candidate at problem size
    (the paper's prediction-not-execution principle): the argmin of
    :func:`rank_tiles` — measured models through the session's device
    facet by default, the analytic model with ``analytic=True`` or no
    session."""
    return rank_tiles(m, n, k, session=session, analytic=analytic,
                      smem_limit=smem_limit, candidates=candidates,
                      stat=stat, transfer=transfer,
                      itemsize=itemsize)[0]


def tile_table(shapes: Sequence[Tuple[int, int, int]],
               **kw) -> Dict[Tuple[int, int, int], TileChoice]:
    """:func:`select_tiles` over many shapes; one session's measurements
    are shared across the whole table (proxy-problem keys depend only on
    the tile config, not the problem size)."""
    return {s: select_tiles(*s, **kw) for s in shapes}
