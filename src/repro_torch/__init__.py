"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

The paper's pipeline (Peise 2017) on an NVIDIA H100: measure the
BLAS/LAPACK-style kernels (:mod:`repro_torch.dla`), fit piecewise-polynomial
performance models (:mod:`repro_torch.core`), predict blocked-algorithm
runtimes and rank variants and block sizes; predict tensor contractions
and einsum paths from cache-aware micro-benchmarks (Ch. 6,
:mod:`repro_torch.core.contractions`, :mod:`repro_torch.tc`) — and, on
the accelerator, measure and tune the tiles of the hand-written CUDA
kernels (:mod:`repro_torch.kernels`, :mod:`repro_torch.tc.device`,
:mod:`repro_torch.perf.tile_tuner`); persist what was measured under a
fingerprint of the card, warm-start later sessions from it, probe it for
drift and score predictor snapshots (:mod:`repro_torch.store`); run the
model pool's configs and models with attention and the Mamba-2 scan
through the hand-written kernels (:mod:`repro_torch.configs`,
:mod:`repro_torch.models`) and serve them, a blocking admission being one
batched pass through those kernels, under the FIFO or the model-guided
scheduler (:mod:`repro_torch.serve`), train them (:mod:`repro_torch.train`)
and shard them over a mesh of cards, or trace a step on the production
mesh without one (:mod:`repro_torch.distributed`,
:mod:`repro_torch.launch`).

The package mirrors ``repro``'s module layout and names so each counterpart
is easy to find.  It imports ``torch`` and never ``jax`` or ``repro``.
Every entry point runs on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch._device`).
"""

from ._device import resolve_device, synchronize, to_numpy, to_torch

__all__ = ["resolve_device", "synchronize", "to_numpy", "to_torch"]
