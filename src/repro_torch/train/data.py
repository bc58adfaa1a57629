"""Deterministic, restart-safe data pipeline (the reference's, in numpy).

Batches are a pure function of ``(seed, step)`` — no iterator state to
checkpoint, and after a node failure the resumed job regenerates exactly
the batches it would have seen (skip-ahead is O(1)).  The synthetic token
stream models a tokenized corpus (Zipfian unigram + short-range
structure).  The arrays are the reference's bit for bit;
:func:`to_device` places a batch for the port's models (token ids as
int64, which ``nn.Embedding``-style indexing takes).  The reference's
``shard_batch`` belongs to the distributed slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_dim: int = 0     # > 0 => emit frame embeddings, not tokens


def _fold(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def _tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    # Zipfian unigram draw with local repetition structure
    ranks = rng.zipf(1.3, size=shape).astype(np.int64)
    toks = (ranks - 1) % vocab
    rep = rng.random(shape) < 0.1
    shifted = np.roll(toks, 1, axis=-1)
    return np.where(rep, shifted, toks).astype(np.int32)


def batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The batch for one step — pure function of (seed, step)."""
    rng = _fold(cfg.seed, step)
    b, s = cfg.global_batch, cfg.seq_len
    if cfg.frontend_dim:
        inputs = rng.standard_normal((b, s, cfg.frontend_dim),
                                     dtype=np.float32)
        labels = _tokens(rng, (b, s), cfg.vocab)
        return {"inputs": inputs, "labels": labels}
    stream = _tokens(rng, (b, s + 1), cfg.vocab)
    return {"inputs": stream[:, :-1], "labels": stream[:, 1:]}


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: integer arrays (token ids,
    labels) as int64, frame embeddings as float32."""
    out = {}
    for name, arr in batch.items():
        dtype = torch.int64 if np.issubdtype(arr.dtype, np.integer) \
            else torch.float32
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=device, dtype=dtype)
    return out
