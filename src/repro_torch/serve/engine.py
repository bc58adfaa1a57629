"""Batched serving engine, the counterpart of ``repro/serve/engine.py``:
continuous-batching prefill + decode loop.

Requests join a batch slot, a prefill populates the caches, decode steps
advance every active slot one token per step, and finished sequences free
their slot for waiting requests.  The engine exposes the reference's step
hooks — :meth:`ServeEngine.add_request` (blocking prefill),
:meth:`ServeEngine.begin_prefill` (interleaved prefill lane),
:meth:`ServeEngine.advance` (ONE fused step over every decode and prefill
lane) and :meth:`ServeEngine.free_slots` — and delegates the tick loop to
a scheduler (:mod:`repro_torch.serve.scheduler`).

The one place the port computes differently is the blocking admission.
The reference replays every prompt token through its jitted
``decode_step``, and that step writes *every* slot's cache row at one
scalar index (``repro/models/transformer.py:298-306``).  So a replay of a
prompt of length L at slot s (a) prefills row s causally over positions
0..L-1, (b) prefills every other row causally over L copies of token 0,
each step attending only ring slots written earlier in the same replay,
and (c) advances every SSM layer's state of every row through those L
tokens from the state it holds.  One batched pass over a (slots, H) token
array — the prompt's first H tokens in row s, zeros elsewhere — computes
the same caches and states up to float rounding: every attention layer
through the flash-attention kernel, causal within the layer's ring length,
every SSM layer through the SSD kernel from the current states as ``h0``,
and every MoE layer routing each position's tokens as one replay step
routes them (:meth:`ServeEngine._admission_pass`).  H is the longest
prefix the kernels take (:func:`admission_head`): one pass, or for a model
of SSM layers alone a second pass at a smaller chunk from the first's
final states (:func:`admission_passes`); the remaining L - H tokens replay
through ``decode_step`` exactly as the reference does.  The engine's
tokens therefore equal the reference engine's, the stale prefix the
reference's scalar index leaves in other slots included.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device, synchronize
from ..configs.base import ArchConfig
from ..kernels.flash_attention import KERNEL_BLOCKS
from ..kernels.ssd import ssd_chunk_legal
from ..models import decode_step, init_decode_state
from ..models.transformer import Model, _block_forward, _embed


@dataclass
class Request:
    """One generation request.

    ``arrival_s`` is the request's open-loop arrival offset on the
    ``run()`` clock (0 = available immediately — the closed-loop default);
    ``submitted_s``/``finished_s`` are stamped by the serve loop, and
    :attr:`latency_s` is the submit→finish span the load generator
    reports percentiles over.
    """

    uid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    arrival_s: float = 0.0       # open-loop arrival time (run() clock)
    submitted_s: Optional[float] = None   # entered the waiting queue
    finished_s: Optional[float] = None    # last token produced

    @property
    def latency_s(self) -> Optional[float]:
        """Submit→finish latency (seconds), once finished."""
        if self.submitted_s is None or self.finished_s is None:
            return None
        return self.finished_s - self.submitted_s


@dataclass
class EngineStats:
    """Aggregated serving counters (one engine run).

    ``prefill_s``/``decode_s`` time the step calls *synchronized* — under
    asynchronous launches an unsynchronized wall-clock stop under-reports
    by whatever was still queued on the card.  ``latencies_s`` collects
    per-request submit→finish spans; ``tick_overhead_s``/``ticks`` account
    the scheduler's own planning cost per tick.  ``kernel_admissions``
    counts blocking admissions whose head went through the kernels, and
    ``tail_tokens`` the prompt tokens they replayed through
    ``decode_step`` after it.
    """

    prefill_s: float = 0.0
    decode_steps: int = 0
    decode_s: float = 0.0
    tokens_out: int = 0
    ticks: int = 0
    tick_overhead_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    kernel_admissions: int = 0
    tail_tokens: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.decode_s if self.decode_s else 0.0

    @property
    def tick_overhead_ms(self) -> float:
        """Mean scheduler planning overhead per tick, milliseconds."""
        return 1e3 * self.tick_overhead_s / self.ticks if self.ticks else 0.0

    def latency_ms(self, percentile: float) -> float:
        """A submit→finish latency percentile (milliseconds)."""
        if not self.latencies_s:
            return 0.0
        return 1e3 * float(np.percentile(np.asarray(self.latencies_s),
                                         percentile))


def admission_passes(cfg: ArchConfig, length: int) -> List[Tuple[int, int]]:
    """The batched passes that admit a ``length``-token prompt's head, as
    (tokens, SSM chunk) in order; none when no pass takes a token.

    The first pass takes the longest prefix that every layer's kernel
    takes at the config's chunk: an attention layer needs a multiple of a
    block of the flash-attention kernel (:data:`KERNEL_BLOCKS`), an SSM
    layer a chunk ``min(cfg.ssm_chunk, H)`` that divides H and that the
    SSD kernel takes (:func:`~repro_torch.kernels.ssd.ssd_chunk_legal`).
    A model of SSM layers alone scans on from that pass's final states: a
    second pass takes the longest rest that a legal chunk divides, at the
    largest such chunk up to the config's.
    """
    mixers = {spec.mixer for spec in cfg.block_pattern}
    for h in range(length, 0, -1):
        if "attn" in mixers and h % min(KERNEL_BLOCKS):
            continue
        if "ssm" in mixers and not ssd_chunk_legal(h, min(cfg.ssm_chunk, h)):
            continue
        break
    else:
        return []
    passes = [(h, min(cfg.ssm_chunk, h))]
    if mixers == {"ssm"}:
        for rest in range(length - h, 0, -1):
            chunks = [c for c in range(min(cfg.ssm_chunk, rest), 0, -1)
                      if ssd_chunk_legal(rest, c)]
            if chunks:
                passes.append((rest, chunks[0]))
                break
    return passes


def admission_head(cfg: ArchConfig, length: int) -> int:
    """H, the longest prefix of a ``length``-token prompt that the kernels
    take in the batched passes of :func:`admission_passes` (0 when none
    does)."""
    return sum(n for n, _ in admission_passes(cfg, length))


class ServeEngine:
    """Static-batch serving engine (batch slots, per-slot position).

    Slot states: *free* (neither active nor prefilling), *prefilling*
    (an interleaved-prefill lane consuming one prompt token per fused
    step) and *active* (decoding one output token per step).  The blocking
    path (:meth:`add_request`) prefills a slot to completion in one call;
    the interleaved path (:meth:`begin_prefill` + :meth:`advance`) folds
    prefill tokens into the same fused steps that advance decode lanes.

    ``params`` is a :class:`~repro_torch.models.transformer.Model` on
    ``device`` (the card unless the CPU is asked for; parameters elsewhere
    are refused).  ``dtype`` is the caches' type, float32 as in the
    reference.  ``use_kernel=False`` sends the blocking admission's head to
    the kernels' plain versions, to compare the two routes; decode runs no
    kernel either way.
    """

    def __init__(self, cfg: ArchConfig, params: Model, *,
                 batch_slots: int = 4, ctx_len: int = 512,
                 dtype=torch.float32, scheduler=None,
                 use_kernel: bool = True, device: DeviceLike = None):
        if not cfg.causal:
            raise ValueError("decoder-only architectures serve")
        self.device = resolve_device(device)
        where = {p.device for p in params.parameters()}
        if where != {self.device}:
            raise ValueError(f"the parameters lie on {sorted(map(str, where))}"
                             f", the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.ctx = ctx_len
        self.use_kernel = use_kernel
        self.caches = init_decode_state(cfg, batch_slots, ctx_len,
                                        dtype=dtype, device=self.device)
        self.positions = np.zeros(batch_slots, dtype=np.int64)
        self.active: Dict[int, Request] = {}
        self.prefilling: Dict[int, Request] = {}
        self.prefill_done: Dict[int, int] = {}   # prompt tokens consumed
        self.stats = EngineStats()
        self.scheduler = scheduler

    def _decode(self, token: np.ndarray, index: int):
        """One ``decode_step`` on a host (slots, 1) token array."""
        tok = torch.from_numpy(token.astype(np.int64)).to(self.device)
        logits, self.caches = decode_step(self.cfg, self.params,
                                          self.caches, tok, index)
        return logits

    # -------------------------------------------------------------- slots --
    def free_slots(self) -> List[int]:
        """Slots neither decoding nor mid-prefill, lowest first."""
        return [s for s in range(self.slots)
                if s not in self.active and s not in self.prefilling]

    # ------------------------------------------------------------ prefill --
    def _admission_pass(self, head: np.ndarray, slot: int,
                        chunk: int) -> None:
        """Prompt tokens of every slot in one batched pass, from position
        0 for a model with attention layers: ``head`` in row ``slot`` and
        token 0 in every other row, as the reference's replay feeds them.
        Each attention layer attends causally within its ring length (what
        the replay's ring keeps) and writes the last ``min(H, ctx)``
        positions p of every row to ring slot ``p % ctx``; each SSM layer
        scans at ``chunk`` from the rows' current states, which its final
        states replace; each MoE layer routes a position's tokens as one
        replay step routes them."""
        cfg, h = dataclasses.replace(self.cfg, ssm_chunk=chunk), len(head)
        toks = np.zeros((self.slots, h), dtype=np.int64)
        toks[slot] = head
        x = _embed(cfg, self.params, torch.from_numpy(toks).to(self.device))
        new = []
        for blk, cache in zip(self.params.blocks, self.caches):
            if blk.spec.mixer == "attn":
                ck, cv = cache
                ctx = ck.shape[2]
                x, (k, v) = _block_forward(cfg, blk, x, window=ctx,
                                           use_kernel=self.use_kernel,
                                           route_by_position=True)
                kept = min(h, ctx)
                ring = torch.arange(h - kept, h, device=self.device) % ctx
                ck[:, :, ring] = k[:, :, h - kept:].to(ck.dtype)
                cv[:, :, ring] = v[:, :, h - kept:].to(cv.dtype)
                new.append(cache)
            else:
                x, state = _block_forward(cfg, blk, x, window=0, cache=cache,
                                          use_kernel=self.use_kernel,
                                          route_by_position=True)
                new.append(state)
        self.caches = new

    def add_request(self, req: Request) -> bool:  # reprolint: hot-path
        """Admit a request into a free slot; a batched prefill of its head,
        then a decode replay of its tail.

        The *blocking* prefill hook: the whole prompt is in the caches
        before this returns, so every other lane stalls meanwhile — the
        reference's behaviour, which the FIFO baseline preserves.  The
        head (:func:`admission_passes`) goes through the kernels in
        batched passes over every slot, the rest through ``decode_step``
        at its own indices; both give what the reference's replay of the
        whole prompt gives (the module's docstring says why).
        """
        free = self.free_slots()
        if not free:
            return False
        slot = free[0]
        t0 = time.perf_counter()
        prompt = req.prompt
        passes = admission_passes(self.cfg, len(prompt))
        h = 0
        for n, chunk in passes:
            self._admission_pass(prompt[h:h + n], slot, chunk)
            h += n
        if passes:
            self.stats.kernel_admissions += 1
        token = np.zeros((self.slots, 1), dtype=np.int64)
        for i in range(h, len(prompt)):
            token[slot, 0] = int(prompt[i])
            self._decode(token, i)
        self.stats.tail_tokens += len(prompt) - h
        self.positions[slot] = len(prompt)
        self.active[slot] = req
        # prefill_s is a wall-clock bill: the request is not admitted until
        # its cache writes land, so the clock must stop on a drained queue
        # reprolint: allow[host-sync]
        synchronize(self.device)
        self.stats.prefill_s += time.perf_counter() - t0
        return True

    def begin_prefill(self, req: Request, slot: Optional[int] = None) -> int:
        """Open an *interleaved* prefill lane for ``req``.

        The lane consumes one prompt token per :meth:`advance` call,
        riding along with the decode lanes in the same fused step; when
        the last prompt token is consumed the slot transitions to decode.
        Returns the slot used.
        """
        free = self.free_slots()
        if slot is None:
            if not free:
                raise ValueError("no free slot for prefill")
            slot = free[0]
        elif slot not in free:
            raise ValueError(f"slot {slot} is not free")
        self.prefilling[slot] = req
        self.prefill_done[slot] = 0
        return slot

    # ------------------------------------------------------------- decode --
    def advance(self) -> List[Request]:  # reprolint: hot-path
        """ONE fused engine step: advance every decode and prefill lane.

        Decode lanes are fed their last token and append the argmax
        output; prefill lanes consume their next prompt token (the slot
        flips to decode once the prompt is exhausted, after which it
        behaves exactly like a blocking-prefilled slot).  Returns the
        requests that finished on this step.
        """
        if not self.active and not self.prefilling:
            return []
        t0 = time.perf_counter()
        token = np.zeros((self.slots, 1), dtype=np.int64)
        for slot, req in self.active.items():
            last = req.out_tokens[-1] if req.out_tokens else \
                int(req.prompt[-1])
            token[slot, 0] = last
        for slot, req in self.prefilling.items():
            token[slot, 0] = int(req.prompt[self.prefill_done[slot]])
        index = int(max(
            [int(self.positions[s]) for s in self.active] +
            [self.prefill_done[s] for s in self.prefilling]))
        logits = self._decode(token, index)
        had_decode = bool(self.active)
        finished: List[Request] = []
        if had_decode:
            # the engine's one designed D2H point per step: the argmax
            # tokens must reach the host to extend request state
            # reprolint: allow[host-sync]
            nxt = logits[:, 0, :].argmax(dim=-1).cpu().numpy()
            for slot, req in list(self.active.items()):
                req.out_tokens.append(int(nxt[slot]))
                self.positions[slot] += 1
                self.stats.tokens_out += 1
                if len(req.out_tokens) >= req.max_new_tokens:
                    req.done = True
                    finished.append(req)
                    del self.active[slot]
        for slot in list(self.prefilling):
            self.prefill_done[slot] += 1
            req = self.prefilling[slot]
            if self.prefill_done[slot] >= len(req.prompt):
                self.positions[slot] = len(req.prompt)
                del self.prefilling[slot]
                del self.prefill_done[slot]
                self.active[slot] = req
        # decode_s/prefill_s time one fused step end-to-end; StepCostModel
        # calibrates against these, so the step must be complete here
        # reprolint: allow[host-sync]
        synchronize(self.device)
        dt = time.perf_counter() - t0
        if had_decode:
            self.stats.decode_steps += 1
            self.stats.decode_s += dt
        else:
            self.stats.prefill_s += dt
        return finished

    def step(self) -> None:  # reprolint: hot-path
        """Advance every active slot one token (legacy decode hook —
        :meth:`advance` restricted to the no-prefill-lane case)."""
        self.advance()

    # ---------------------------------------------------------------- run --
    def run(self, requests: List[Request], *,
            scheduler=None) -> EngineStats:
        """Serve ``requests`` to completion under a scheduling policy.

        ``scheduler`` (or the engine's constructor-time one) decides
        per-tick admissions; the default
        :class:`~repro_torch.serve.scheduler.FifoScheduler` is the
        first-come-first-served blocking-prefill baseline.  Open-loop
        traces (``Request.arrival_s > 0``) are released onto the waiting
        queue as the run clock passes their arrival time.
        """
        from .scheduler import FifoScheduler, serve_loop
        sched = scheduler if scheduler is not None else \
            (self.scheduler if self.scheduler is not None
             else FifoScheduler())
        return serve_loop(self, list(requests), sched)
