"""Fault-tolerant training loop (the reference's ``train``).

* deterministic restart-safe data (``data.batch_at(seed, step)``),
* checkpoint/restore with atomic commit + CRC + keep-N (``checkpoint``),
* async checkpoint cadence,
* **straggler watchdog**: per-step wall time is tracked against a rolling
  median; steps slower than ``straggler_factor`` x median are counted and
  reported,
* loss-NaN circuit breaker: a step whose loss is not finite is skipped and
  the next batch tried, the parameters and optimizer state untouched.

The port's train step updates the parameters and AdamW moments in place
(:mod:`repro_torch.launch.steps`), so the breaker lives in the step: it
reads the loss before it updates, and leaves everything as it was when the
loss is not finite.  The loop records the skip, as the reference's does.
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from .._device import DeviceLike, resolve_device, synchronize
from ..configs.base import ArchConfig
from . import checkpoint as ckpt_lib
from .data import DataConfig, batch_at, to_device
from .optimizer import AdamW


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 0


@dataclass
class TrainReport:
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    straggler_steps: List[int] = field(default_factory=list)
    skipped_nan_steps: List[int] = field(default_factory=list)
    resumed_from: Optional[int] = None

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


def train(cfg: ArchConfig, data_cfg: DataConfig, tc: TrainConfig, *,
          params=None, opt: Optional[AdamW] = None,
          train_step: Optional[Callable] = None, dtype=torch.float32,
          device: DeviceLike = None) -> tuple:
    """Run (or resume) a training job.  Returns (params, opt_state, report).

    ``params`` is a model of :mod:`repro_torch.models` (random from a
    generator seeded with ``data_cfg.seed`` on ``device`` when None); its
    parameters get ``requires_grad`` and are trained in place.  The job runs
    on the card unless ``device="cpu"`` and raises without one.
    ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``
    defaults to :func:`repro_torch.launch.steps.make_train_step`.
    """
    from ..launch.steps import make_train_step
    from ..models import init_params

    device = resolve_device(device)
    opt = opt or AdamW(lr=3e-4)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(data_cfg.seed)
        params = init_params(cfg, gen, dtype, device)
    for p in params.parameters():
        p.requires_grad_(True)
    opt_state = opt.init(list(params.parameters()))
    step_fn = train_step or make_train_step(cfg, opt)

    report = TrainReport()
    start_step = 0
    ckptr = None
    if tc.ckpt_dir:
        ckptr = ckpt_lib.AsyncCheckpointer(tc.ckpt_dir)
        latest = ckpt_lib.latest_step(tc.ckpt_dir)
        if latest is not None:
            ckpt_lib.restore(tc.ckpt_dir, (params, opt_state), step=latest)
            start_step = latest + 1
            report.resumed_from = latest

    times: List[float] = []
    step = start_step
    while step < tc.steps:
        batch = to_device(batch_at(data_cfg, step), device)
        t0 = time.perf_counter()
        params, new_opt_state, loss = step_fn(params, opt_state, batch)
        # the NaN circuit breaker and the straggler watchdog both need the
        # step's loss and wall time on the host before the next step
        loss = float(loss)
        synchronize(device)
        dt = time.perf_counter() - t0
        if not math.isfinite(loss):
            # circuit breaker: the step left the state as it was
            report.skipped_nan_steps.append(step)
            step += 1
            continue
        opt_state = new_opt_state
        report.losses.append(loss)
        report.step_times.append(dt)
        times.append(dt)
        if len(times) > 20:
            times.pop(0)
        if len(times) >= 5:
            med = statistics.median(times)
            if dt > tc.straggler_factor * med:
                report.straggler_steps.append(step)
        if ckptr and tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
            ckptr.save_async(step, (params, opt_state))
        step += 1
    if ckptr:
        ckptr.save_async(tc.steps - 1, (params, opt_state))
        ckptr.wait()
    return params, opt_state, report
