"""Host<->device transfer-term models: ``T_h2d`` / ``T_d2h`` (additive).

Every kernel execution decomposes as ``T_total = T_h2d + T_compute +
T_d2h`` with *per-direction* constants — a fixed overhead plus a
bandwidth term, and asymmetric directions.  This module gives the
prediction stack those additive transfer pieces: a :class:`TransferModel`
per direction, fitted from a small memcpy micro-benchmark with the
paper's relative least squares (§3.2.4) over the affine basis
``time(bytes) = overhead + bytes / bandwidth``.

The probe copies *pageable* host memory (an ordinary numpy array), as
:class:`~repro_torch.dla.engine.ExecEngine` and
:meth:`~repro_torch.dla.kernels.KernelDef.make_call` do on every kernel
call: H2D is ``torch.from_numpy(host).to(device)`` followed by
``torch.cuda.synchronize()``, D2H is ``tensor.cpu()``, which blocks.
Measurement here is deliberately synchronizing — the copies ARE the
quantity being measured.  ``measure_fn`` is injectable so tests fit
against synthetic bandwidth/overhead constants deterministically.

Fitted models serialize as ordinary :class:`~repro_torch.core.model.Piece`
objects (per-stat polynomials replicated from the one affine fit), in the
same dict form as the reference package's transfer models.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device, synchronize
from .fitting import Polynomial, fit_relative
from .grids import Domain
from .model import Piece
from .sampler import STATS, Stats

#: transfer directions; model-set kernel names are ``memcpy_<direction>``
H2D, D2H = "h2d", "d2h"

#: default memcpy probe sizes (bytes): spans the fixed-overhead-dominated
#: and the bandwidth-dominated regimes so the affine fit is conditioned
DEFAULT_SIZES = (1 << 12, 1 << 15, 1 << 18, 1 << 21)

#: a direction's raw probe: (direction, nbytes, repetitions) -> samples (s)
TransferMeasureFn = Callable[[str, int, int], Sequence[float]]


@dataclass(frozen=True)
class TransferModel:
    """One direction's fitted transfer-time model (seconds over bytes).

    ``poly`` is the §3.2.4 relative fit over the affine basis
    ``((0,), (1,))`` — evaluating it at 0 bytes isolates the fixed
    overhead, and the slope between two sizes isolates the bandwidth, so
    both constants are recoverable from the fit (the test contract).
    """

    direction: str               # H2D or D2H
    poly: Polynomial

    def time(self, nbytes: float) -> float:
        """Predicted one-way transfer time for ``nbytes`` (clipped >= 0)."""
        return max(float(self.poly(np.asarray([[nbytes]], float))), 0.0)

    @property
    def overhead_s(self) -> float:
        """The fixed per-transfer overhead: the fit at 0 bytes."""
        return float(self.poly(np.asarray([[0.0]], float)))

    @property
    def bytes_per_s(self) -> float:
        """The fitted bandwidth: bytes over the affine slope."""
        n = float(self.poly.scale[0])          # a well-conditioned probe pt
        slope = (float(self.poly(np.asarray([[n]], float))) -
                 self.overhead_s) / n
        return 1.0 / slope if slope > 0 else float("inf")

    # ---------------------------------------------------------- persistence --
    def to_piece(self, hi_bytes: float = 1 << 40) -> Piece:
        """The model as one piece (the affine fit replicated per stat)."""
        return Piece(domain=Domain((0.0,), (float(hi_bytes),)),
                     polys={s: self.poly for s in STATS})

    @classmethod
    def from_piece(cls, direction: str, piece: Piece) -> "TransferModel":
        return cls(direction=direction, poly=piece.polys["med"])


def fit_transfer(direction: str, sizes_bytes: Sequence[int],
                 seconds: Sequence[float]) -> TransferModel:
    """Fit one direction's affine transfer model (§3.2.4 relative LS)."""
    points = np.asarray(sizes_bytes, dtype=np.float64)[:, None]
    poly = fit_relative(points, np.asarray(seconds, dtype=np.float64),
                        basis=((0,), (1,)))
    return TransferModel(direction=direction, poly=poly)


def _measure_memcpy(direction: str, nbytes: int, repetitions: int, *,
                    device: torch.device) -> List[float]:
    """The real probe: time one pageable H2D or D2H copy per sample.

    Synchronization is the point here — each sample brackets exactly one
    blocking one-way copy (on H2D followed by the device sync that makes
    the copy complete), matching how the transfer constants are consumed.
    """
    n = max(nbytes // 4, 1)
    host = np.zeros(n, dtype=np.float32)
    dev = torch.from_numpy(host).to(device)         # warm both paths
    dev.cpu()
    synchronize(device)
    samples = []
    for _ in range(repetitions):
        t0 = time.perf_counter()
        if direction == H2D:
            torch.from_numpy(host).to(device)
            synchronize(device)
        else:
            dev.cpu()
        samples.append(time.perf_counter() - t0)
    return samples


def measure_transfers(*, sizes: Sequence[int] = DEFAULT_SIZES,
                      repetitions: int = 5,
                      measure_fn: Optional[TransferMeasureFn] = None,
                      device: DeviceLike = None,
                      ) -> Tuple[TransferModel, TransferModel, float]:
    """Fit both directions from the memcpy micro-benchmark.

    Returns ``(h2d, d2h, cost_seconds)`` where ``cost_seconds`` is the
    probe's total wall-clock — callers fold it into their suite's cost
    accounting.  Each size contributes its *median* sample to the fit
    (the §2.1.2 stance: a summary statistic, never a single sample).
    The real probe runs on ``device`` (the CUDA card unless the CPU is
    asked for); an injected ``measure_fn`` replaces it.
    """
    fn = measure_fn or functools.partial(_measure_memcpy,
                                         device=resolve_device(device))
    t0 = time.perf_counter()
    models = []
    for direction in (H2D, D2H):
        meds = [Stats.from_samples(fn(direction, n, repetitions)).med
                for n in sizes]
        models.append(fit_transfer(direction, sizes, meds))
    return models[0], models[1], time.perf_counter() - t0
