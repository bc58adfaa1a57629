"""Device measurement of the hand-written kernels' tile configs.

The counterpart of ``repro.tc.device``: a device kernel family in the
:class:`~repro_torch.tc.suite.MicroBenchmarkSuite` for each CUDA kernel —
the matmul's (bm, bn, bk) tiles, flash attention's (bq, bkv, d) blocks
and the SSD scan's (chunk, p, n) configs — keyed by (kernel name, tile
config, shared-memory class) through the key's ``config`` facet,
deduplicated and cost-accounted like any key.

**Measurement protocol**: each tile config is timed on its canonical
*proxy problem* (:func:`repro_torch.kernels.matmul.proxy_problem`,
:func:`~repro_torch.kernels.flash_attention.attn_proxy_problem`,
:func:`~repro_torch.kernels.ssd.ssd_proxy_problem`, each sized to fill
the card), so the measured quantity is a per-step kernel cost (one
block's step, in throughput terms); a full problem's compute term is
that cost scaled by the problem's step count — the paper's
measure-the-kernel / predict-the-blocked-algorithm split (§4.6) applied
to tiles.  The sweep times on the device: every launch is bracketed by a
pair of ``torch.cuda.Event(enable_timing=True)`` on one stream, and the
host synchronises exactly once, at sweep end, before reading the events.
A host clock around an asynchronous launch would measure the enqueue.

**Shared-memory classes**: a config whose staging fits in half of the
card's opt-in shared memory per block is RESIDENT (two blocks can share
an SM's shared memory); one that claims more is TIGHT and runs one block
per SM — measurably different, so the two do not share measurements.  A
family whose configs run by more than one route (the matmul's ``wgmma``
and ``ffma`` tiles, the SSD's ``wgmma`` and ``mma_sync`` chunks) puts the
route beside the shared-memory class in the key's classes, so each
route's measurements fit a model of their own.

**Transfer terms**: predictions decompose as ``T_total = T_h2d +
T_compute + T_d2h`` with per-direction bandwidth + fixed-overhead models
fitted by :mod:`repro_torch.core.transfer` from a pageable memcpy probe.

Fitted per-(kernel, class) config models and the transfer models export
to one :class:`~repro_torch.core.model.ModelSet` (:meth:`DeviceSuite.
to_model_set`) in the reference's dict form, and load back
(:meth:`DeviceSuite.load_model_set`) so a warm suite ranks tiles with
zero fresh measurements.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.fitting import Polynomial, fit_relative, monomial_basis
from ..core.grids import Domain
from ..core.model import CaseModel, ModelSet, PerformanceModel, Piece
from ..core.sampler import STATS, Stats
from ..core.transfer import D2H, H2D, TransferModel, measure_transfers
from ..kernels.flash_attention import (attn_grid_steps, attn_proxy_problem,
                                       attn_smem_bytes, flash_attention)
from ..kernels._card import H100_SMEM_OPTIN
from ..kernels.matmul import grid_steps as matmul_grid_steps
from ..kernels.matmul import matmul, matmul_route, proxy_problem, smem_bytes
from ..kernels.ssd import (ssd, ssd_grid_steps, ssd_proxy_problem,
                           ssd_route, ssd_smem_bytes)
from .suite import MicroBenchmark, MicroBenchmarkKey, MicroBenchmarkSuite

#: the two shared-memory classes: two blocks per SM fit, or one
RESIDENT, TIGHT = "smem_resident", "smem_tight"
#: proxy steps per grid dimension (see ``kernels.matmul.proxy_problem``)
STEPS_PER_DIM = 16

#: model-set case tags (mirrors the reference's percall/first split)
_PERCALL, _FIRST = "percall", "first"
_TRANSFER_CASE = ("transfer",)
_VALUE_FLOOR = 1e-12       # relative fits need strictly positive values


def smem_class(staging_bytes: int, smem_limit: int = H100_SMEM_OPTIN) -> str:
    """The shared-memory class of one block's staging."""
    return RESIDENT if staging_bytes <= smem_limit // 2 else TIGHT


def shared_memory_limit(device: torch.device) -> int:
    """Opt-in shared memory per block of ``device``'s card; on the CPU,
    where the kernel's plain version runs, the H100's."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin
    return H100_SMEM_OPTIN


# --------------------------------------------------------------- registry --
class _MatmulDevice:
    """(bm, bn, bk) tiles of the CUDA matmul (``kernels/matmul.py``),
    float32 operands.  The tile picks its route (``wgmma`` or ``ffma``,
    :func:`~repro_torch.kernels.matmul.matmul_route`), and the two run
    different kernels at different rates, so the route is a facet of the
    key's classes beside the shared-memory class."""

    name = "cuda_matmul"
    config_dims = ("bm", "bn", "bk")

    def smem_bytes(self, cfg: Tuple[int, ...]) -> int:
        return smem_bytes(*cfg)

    def classes(self, cfg: Tuple[int, ...], cls: str) -> Tuple[str, str]:
        return cls, matmul_route(torch.float32, *cfg) or "unrouted"

    def proxy(self, cfg, steps_per_dim: int) -> Tuple[int, ...]:
        return proxy_problem(*cfg, steps_per_dim=steps_per_dim)

    def proxy_steps(self, cfg, steps_per_dim: int) -> int:
        return steps_per_dim ** 3

    def steps(self, problem, cfg) -> int:
        return matmul_grid_steps(*problem, *cfg)

    def operand_shapes(self, problem):
        m, n, k = problem
        return (m, k), (k, n), (m, n)

    def operands(self, problem, rng):
        a_sh, b_sh, _ = self.operand_shapes(problem)
        return (rng.standard_normal(a_sh).astype(np.float32),
                rng.standard_normal(b_sh).astype(np.float32))

    def bind(self, cfg):
        bm, bn, bk = cfg
        return lambda x, y: matmul(x, y, bm=bm, bn=bn, bk=bk)

    def transfer_bytes(self, problem, itemsize: int = 4):
        m, n, k = problem
        return itemsize * (m * k + k * n), itemsize * m * n


class _FlashAttentionDevice:
    """(bq, bkv, d) blocks of the CUDA flash attention
    (``kernels/flash_attention.py``).  The head dim rides in the config:
    it is a compile-time size of every block, so two head dims are two
    kernel configurations.  The measured call is the reference's: causal,
    no window, no softcap, as many kv heads as query heads.  Its steps are
    the (query block, kv block) pairs the kernel visits, which skips the
    blocks above the diagonal; the reference counts the TPU's full grid.
    The family times and models the instantiated head dims only: a head
    dim between them (80, 96) runs zero-padded at the next one's config,
    as :func:`attn_smem_bytes` and the legality rules reckon it."""

    name = "cuda_flash_attention"
    config_dims = ("bq", "bkv", "d")

    def smem_bytes(self, cfg: Tuple[int, ...]) -> int:
        return attn_smem_bytes(*cfg)

    def classes(self, cfg: Tuple[int, ...], cls: str) -> Tuple[str, str]:
        return cls, cls

    def proxy(self, cfg, steps_per_dim: int) -> Tuple[int, ...]:
        return attn_proxy_problem(*cfg, steps_per_dim=steps_per_dim)

    def proxy_steps(self, cfg, steps_per_dim: int) -> int:
        return self.steps(self.proxy(cfg, steps_per_dim), cfg)

    def steps(self, problem, cfg) -> int:
        b, h, sq, skv, d = problem
        assert d == cfg[2], (d, cfg)
        return attn_grid_steps(b, h, sq, skv, cfg[0], cfg[1], causal=True,
                               window=0)

    def operand_shapes(self, problem):
        b, h, sq, skv, d = problem
        return (b, h, sq, d), (b, h, skv, d), (b, h, sq, d)

    def operands(self, problem, rng):
        q_sh, kv_sh, _ = self.operand_shapes(problem)
        q = rng.standard_normal(q_sh).astype(np.float32)
        k = rng.standard_normal(kv_sh).astype(np.float32)
        v = rng.standard_normal(kv_sh).astype(np.float32)
        return q, k, v

    def bind(self, cfg):
        bq, bkv, _ = cfg
        return lambda q, k, v: flash_attention(q, k, v, bq=bq, bkv=bkv)

    def transfer_bytes(self, problem, itemsize: int = 4):
        q_sh, kv_sh, o_sh = self.operand_shapes(problem)
        nin = int(np.prod(q_sh)) + 2 * int(np.prod(kv_sh))
        return itemsize * nin, itemsize * int(np.prod(o_sh))


class _SsdDevice:
    """(chunk, p, n) configs of the CUDA SSD scan (``kernels/ssd.py``),
    measured on the reference's operands: dt = 1e-3 and a_log = 0
    everywhere, x, b and c standard normal.  The config picks its route
    (``wgmma`` or ``mma_sync``, :func:`~repro_torch.kernels.ssd.ssd_route`),
    and the two run different kernels at different rates, so the route is
    a facet of the key's classes beside the shared-memory class."""

    name = "cuda_ssd"
    config_dims = ("chunk", "p", "n")

    def smem_bytes(self, cfg: Tuple[int, ...]) -> int:
        return ssd_smem_bytes(*cfg)

    def classes(self, cfg: Tuple[int, ...], cls: str) -> Tuple[str, str]:
        chunk, p, n = cfg
        return cls, ssd_route(p, n, chunk) or "unrouted"

    def proxy(self, cfg, steps_per_dim: int) -> Tuple[int, ...]:
        return ssd_proxy_problem(*cfg, steps_per_dim=steps_per_dim)

    def proxy_steps(self, cfg, steps_per_dim: int) -> int:
        return self.steps(self.proxy(cfg, steps_per_dim), cfg)

    def steps(self, problem, cfg) -> int:
        b, l, h, p, g, n = problem
        assert (p, n) == (cfg[1], cfg[2]), (problem, cfg)
        return ssd_grid_steps(b, l, h, cfg[0])

    def operand_shapes(self, problem):
        b, l, h, p, g, n = problem
        return (b, l, h, p), (b, l, g, n), (b, l, h, p)

    def operands(self, problem, rng):
        b, l, h, p, g, n = problem
        x = rng.standard_normal((b, l, h, p)).astype(np.float32)
        dt = np.full((b, l, h), 1e-3, dtype=np.float32)
        a_log = np.zeros((h,), dtype=np.float32)
        bb = rng.standard_normal((b, l, g, n)).astype(np.float32)
        cc = rng.standard_normal((b, l, g, n)).astype(np.float32)
        return x, dt, a_log, bb, cc

    def bind(self, cfg):
        chunk = cfg[0]
        return lambda x, dt, a_log, b, c: ssd(x, dt, a_log, b, c,
                                              chunk=chunk)

    def transfer_bytes(self, problem, itemsize: int = 4):
        b, l, h, p, g, n = problem
        nin = b * l * h * p + b * l * h + h + 2 * b * l * g * n
        return itemsize * nin, itemsize * b * l * h * p


#: the device kernel registry: name -> adapter
DEVICE_KERNELS = {k.name: k for k in (_MatmulDevice(),
                                      _FlashAttentionDevice(),
                                      _SsdDevice())}


def device_key(kernel_name: str, config: Sequence[int], *,
               steps_per_dim: int = STEPS_PER_DIM,
               smem_limit: int = H100_SMEM_OPTIN) -> MicroBenchmarkKey:
    """The suite key of one (kernel, tile config, shared-memory class)
    benchmark (and route, for the matmul).  The operand shapes are the
    config's proxy-problem operands, so the key fully reconstructs its
    measurement and two problems tuned at the same config share one
    key."""
    kernel = DEVICE_KERNELS[kernel_name]
    config = tuple(int(c) for c in config)
    problem = kernel.proxy(config, steps_per_dim)
    a_sh, b_sh, o_sh = kernel.operand_shapes(problem)
    cls = smem_class(kernel.smem_bytes(config), smem_limit)
    return MicroBenchmarkKey(equation=kernel_name, a_shape=tuple(a_sh),
                             b_shape=tuple(b_sh), out_shape=tuple(o_sh),
                             classes=kernel.classes(config, cls),
                             config=config)


@dataclass(frozen=True)
class DeviceRanked:
    """One ranked tile config with its transfer/compute decomposition."""

    config: Tuple[int, ...]
    t_total: float             # T_h2d + T_compute + T_d2h (seconds)
    t_h2d: float
    t_compute: float
    t_d2h: float
    per_step_s: float          # measured/modeled per-step kernel cost
    source: str                # "measured" | "model"


class DeviceSuite:
    """Device sweeps + measured tile models over one shared suite.

    Device kernel measurements land in ``suite.results`` with ordinary
    "measured" provenance and wall-clock cost accounting.  ``device`` is
    the CUDA card unless the CPU is asked for; the real sweep needs the
    card (a CPU suite must inject ``sweep_fn``, as the tests do).
    ``passes`` defaults to the suite's repetitions; ``transfer_measure_fn``
    injects a synthetic memcpy probe.
    """

    def __init__(self, suite: MicroBenchmarkSuite, *,
                 device: DeviceLike = None,
                 steps_per_dim: int = STEPS_PER_DIM,
                 passes: Optional[int] = None,
                 transfer_measure_fn=None,
                 transfer_repetitions: int = 5,
                 sweep_fn=None):
        self.suite = suite
        self.device = resolve_device(device)
        self.smem_limit = shared_memory_limit(self.device)
        self.steps_per_dim = steps_per_dim
        self.passes = suite.repetitions if passes is None else passes
        self.transfer_measure_fn = transfer_measure_fn
        self.transfer_repetitions = transfer_repetitions
        #: injectable sweep backend: (kernel_name, configs) -> {config:
        #: (Stats, first, seconds)}.  Tests inject a deterministic one;
        #: the default is the real event-timed loop on the card.
        self.sweep_fn = sweep_fn or self._sweep
        self._transfer: Optional[Tuple[TransferModel, TransferModel]] = None
        #: (kernel, classes) -> {"percall": CaseModel, "first": Polynomial}
        self._loaded: Dict[Tuple[str, Tuple[str, str]], Dict] = {}

    # -------------------------------------------------------------- keys --
    def key(self, kernel_name: str,
            config: Sequence[int]) -> MicroBenchmarkKey:
        return device_key(kernel_name, config,
                          steps_per_dim=self.steps_per_dim,
                          smem_limit=self.smem_limit)

    # ------------------------------------------------------- measurement --
    def measure_grid(self, kernel_name: str,
                     configs: Sequence[Sequence[int]],
                     ) -> Dict[Tuple[int, ...], MicroBenchmark]:
        """Measured benchmarks for every config, deduplicated: only
        configs whose key the suite does not hold enter the sweep."""
        configs = [tuple(int(c) for c in cfg) for cfg in configs]
        missing = []
        seen = set()
        for cfg in configs:
            if cfg in seen:
                continue
            seen.add(cfg)
            if self.key(kernel_name, cfg) not in self.suite.results:
                missing.append(cfg)
        if missing:
            for cfg, (stats, first, seconds) in self.sweep_fn(
                    kernel_name, missing).items():
                self.suite.record_measurement(self.key(kernel_name, cfg),
                                              stats, first, seconds)
        return {cfg: self.suite.results[self.key(kernel_name, cfg)]
                for cfg in configs}

    def _sweep(self, kernel_name: str,
               configs: Sequence[Tuple[int, ...]]) -> Dict:
        """The event-timed measurement loop on the card.

        Per config: one first launch (its device time is the first-call
        overhead), then ``passes`` rounds over all configs, each launch
        between a start and an end CUDA event on the current stream.
        Nothing waits inside the loop; one ``torch.cuda.synchronize`` at
        the end lets every event be read.  The sweep's wall-clock is
        shared over the configs in proportion to their device time.
        """
        if self.device.type != "cuda":
            raise RuntimeError("the device sweep times kernels on the card; "
                               "a CPU DeviceSuite needs an injected "
                               "sweep_fn")
        kernel = DEVICE_KERNELS[kernel_name]
        t_start = time.perf_counter()
        rng = np.random.default_rng(self.suite.seed)
        runners = []
        for cfg in configs:
            problem = kernel.proxy(cfg, self.steps_per_dim)
            ops = tuple(torch.from_numpy(o).to(self.device)
                        for o in kernel.operands(problem, rng))
            runners.append((cfg, kernel.bind(cfg), ops))

        def timed(run, ops):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(*ops)
            end.record()
            return start, end

        with torch.cuda.device(self.device):
            firsts = {cfg: timed(run, ops) for cfg, run, ops in runners}
            events = {cfg: [] for cfg in configs}
            for _ in range(self.passes):
                for cfg, run, ops in runners:
                    events[cfg].append(timed(run, ops))
            torch.cuda.synchronize(self.device)   # the one sweep-end sync
        wall = time.perf_counter() - t_start
        first_s = {cfg: s.elapsed_time(e) / 1e3
                   for cfg, (s, e) in firsts.items()}
        samples = {cfg: [s.elapsed_time(e) / 1e3 for s, e in evs]
                   for cfg, evs in events.items()}
        weights = {cfg: first_s[cfg] + sum(samples[cfg]) for cfg in configs}
        wtotal = sum(weights.values()) or 1.0
        return {cfg: (Stats.from_samples(samples[cfg]), first_s[cfg],
                      wall * weights[cfg] / wtotal)
                for cfg in configs}

    # ---------------------------------------------------------- transfer --
    def transfer_models(self) -> Tuple[TransferModel, TransferModel]:
        """The (H2D, D2H) transfer models — measured once per suite on
        this suite's device (the probe's wall-clock lands in
        ``suite.cost_seconds``), or loaded from a model set."""
        if self._transfer is None:
            h2d, d2h, cost = measure_transfers(
                measure_fn=self.transfer_measure_fn,
                repetitions=self.transfer_repetitions, device=self.device)
            self.suite.cost_seconds += cost
            self._transfer = (h2d, d2h)
        return self._transfer

    # ------------------------------------------------------------ ranking --
    def rank(self, kernel_name: str, problem: Sequence[int],
             configs: Sequence[Sequence[int]], *, stat: str = "med",
             transfer: bool = True, itemsize: int = 4,
             ) -> List[DeviceRanked]:
        """Rank tile configs for ``problem``, fastest-predicted first.

        Per config the total decomposes as ``T_h2d + T_compute +
        T_d2h``: per-step kernel cost (measured, or predicted by a
        loaded model) scaled to the problem's step count, plus one H2D
        transfer of the input operands and one D2H of the output.
        """
        kernel = DEVICE_KERNELS[kernel_name]
        problem = tuple(int(p) for p in problem)
        configs = [tuple(int(c) for c in cfg) for cfg in configs]
        est: Dict[Tuple[int, ...], Tuple[float, str]] = {}
        need = []
        for cfg in configs:
            key = self.key(kernel_name, cfg)
            mb = self.suite.results.get(key)
            if mb is not None:
                est[cfg] = (getattr(mb.stats, stat), "measured")
                continue
            pred = self._model_predict(kernel_name, key.classes, cfg, stat)
            if pred is not None:
                est[cfg] = (pred, "model")
            else:
                need.append(cfg)
        for cfg, mb in (self.measure_grid(kernel_name, need).items()
                        if need else ()):
            est[cfg] = (getattr(mb.stats, stat), "measured")
        t_h2d = t_d2h = 0.0
        if transfer:
            h2d, d2h = self.transfer_models()
            in_bytes, out_bytes = kernel.transfer_bytes(problem, itemsize)
            t_h2d, t_d2h = h2d.time(in_bytes), d2h.time(out_bytes)
        ranked = []
        for cfg in configs:
            per_call, source = est[cfg]
            per_step = per_call / kernel.proxy_steps(cfg,
                                                     self.steps_per_dim)
            t_compute = per_step * kernel.steps(problem, cfg)
            ranked.append(DeviceRanked(
                config=cfg, t_total=t_h2d + t_compute + t_d2h,
                t_h2d=t_h2d, t_compute=t_compute, t_d2h=t_d2h,
                per_step_s=per_step, source=source))
        ranked.sort(key=lambda r: (r.t_total, r.config))
        return ranked

    def _model_predict(self, kernel_name: str, classes: Tuple[str, str],
                       cfg: Tuple[int, ...],
                       stat: str) -> Optional[float]:
        entry = self._loaded.get((kernel_name, classes))
        if entry is None:
            return None
        piece = entry[_PERCALL].find_piece(cfg)
        if piece is None:
            return None               # outside the fitted config domain
        return piece.estimate(cfg)[stat]

    # -------------------------------------------------------- persistence --
    def to_model_set(self) -> ModelSet:
        """Measured device kernels + transfer models as one
        :class:`ModelSet`.  Per (kernel, classes): per-call-stat
        polynomials fitted over the measured config points (relative LS
        on the multilinear basis, §3.2.4) under case ``(classes,
        "percall")``, and a constant first-call fit under ``(classes,
        "first")`` whose piece domain records the config bounding box.
        Transfer models ride as ``memcpy_h2d`` / ``memcpy_d2h`` kernels.
        """
        groups: Dict[Tuple[str, Tuple[str, str]], List] = {}
        for key, mb in self.suite.results.items():
            if key.config is not None and key.equation in DEVICE_KERNELS:
                groups.setdefault((key.equation, key.classes),
                                  []).append((key.config, mb))
        ms = ModelSet()
        for (name, classes) in sorted(groups):
            entries = sorted(groups[(name, classes)], key=lambda e: e[0])
            points = np.asarray([cfg for cfg, _ in entries], float)
            ndim = points.shape[1]
            lo = tuple(float(v) for v in points.min(axis=0))
            hi = tuple(float(v) for v in points.max(axis=0))
            basis = monomial_basis(((1,) * ndim,))
            polys = {}
            for s in STATS:
                vals = np.maximum([getattr(mb.stats, s)
                                   for _, mb in entries], _VALUE_FLOOR)
                polys[s] = fit_relative(points, vals, basis)
            first_vals = np.maximum([mb.first for _, mb in entries],
                                    _VALUE_FLOOR)
            first_poly = fit_relative(points, first_vals, ((0,) * ndim,))
            if name not in ms:
                ms.add(PerformanceModel(kernel=name, setup="tc-device"))
            pm = ms[name]
            pm.add_piece((classes, _PERCALL),
                         Piece(domain=Domain(lo, hi), polys=polys))
            pm.add_piece((classes, _FIRST),
                         Piece(domain=Domain(lo, hi),
                               polys={s: first_poly for s in STATS}))
        if self._transfer is not None:
            for model in self._transfer:
                pm = PerformanceModel(kernel=f"memcpy_{model.direction}",
                                      setup="tc-device")
                pm.add_piece(_TRANSFER_CASE, model.to_piece())
                ms.add(pm)
        return ms

    def load_model_set(self, ms: ModelSet) -> int:
        """Restore :meth:`to_model_set` output (a warm start); returns how
        many (kernel, classes) config models were loaded.  In-memory
        models win over loaded ones."""
        loaded = 0
        transfer: Dict[str, TransferModel] = {}
        for name, pm in ms.models.items():
            if name.startswith("memcpy_"):
                direction = name[len("memcpy_"):]
                piece = pm.cases[_TRANSFER_CASE].pieces[0]
                transfer[direction] = TransferModel.from_piece(direction,
                                                              piece)
                continue
            percall: Dict[Tuple[str, str], CaseModel] = {}
            first: Dict[Tuple[str, str], Polynomial] = {}
            for case, cm in pm.cases.items():
                classes, kind = case
                if kind == _PERCALL:
                    percall[tuple(classes)] = cm
                elif kind == _FIRST:
                    first[tuple(classes)] = cm.pieces[0].polys["med"]
            for classes, cm in percall.items():
                slot = (name, classes)
                if slot in self._loaded or classes not in first:
                    continue
                self._loaded[slot] = {_PERCALL: cm,
                                      _FIRST: first[classes]}
                loaded += 1
        if self._transfer is None and H2D in transfer and D2H in transfer:
            self._transfer = (transfer[H2D], transfer[D2H])
        return loaded
