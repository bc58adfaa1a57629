"""BLAS-based tensor-contraction algorithms + micro-benchmark prediction
(paper Ch. 6), on the card.

A contraction like ``C[abc] = A[ai] * B[ibc]`` can be computed by many
alternative algorithms, each consisting of nested **for**-loops around a
single fixed-size compute kernel (gemm / gemv / ger / dot / axpy analogues —
here: ``torch.einsum`` over the kernel dimensions, which dispatches to
cuBLAS on the card).  §6.1's generator enumerates them systematically:
choose which indices become loop indices, check the remainder matches a
kernel pattern, and permute the loop order.

Since each algorithm performs its *entire* computation in repeated calls to
ONE kernel with FIXED operand sizes, a micro-benchmark of a handful of calls
predicts the whole algorithm (§6.2).  The benchmark is *cache-aware*: for
each operand the *access distance* (bytes touched between consecutive uses
of the same operand slice, §6.2.3) decides whether the timed calls reuse a
warm buffer or cycle through fresh buffers, recreating the cache state of
the real loop nest.  The cache capacity is the card's L2, read from the
device; a CPU caller passes ``cache_bytes=`` explicitly.  First-iteration
overhead (§6.2.6) is measured separately and added once.

Where this differs from the reference on purpose:

* **one kernel call for both paths.** :func:`kernel_call` — the einsum,
  then its result added into the output slice — is what :func:`execute`
  runs each iteration and what :func:`run_kernel_benchmark` times, so the
  two cannot drift apart.  The output starts at zero and a store
  algorithm writes each slice once, so adding is storing; an iteration is
  two launches (the einsum, the in-place add) either way;
* **the data stays on the device.** :func:`execute` moves A and B to the
  device once and keeps C there; the reference copies every iteration's
  operand slices host to device and its result back;
* **every iteration's operands are contiguous.** :func:`execute` lays
  A, B and C out once with their loop indices outermost, so the slices
  it hands the kernel call are contiguous blocks like the benchmark's
  buffers (the reference's per-iteration host copies were contiguous
  too);
* **the timing protocol prices pipelined launches.** A device-resident
  loop does not wait for each call, so the benchmark times bursts of
  calls ended by one synchronisation and divides by the burst length
  (:func:`run_kernel_benchmark`); :func:`measure_contraction`
  synchronises before it reads the clock.
"""

from __future__ import annotations

import functools
import itertools
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from .._device import DeviceLike, resolve_device, synchronize
from .sampler import Stats

#: bytes per float32 operand element
_ITEM = 4
#: kernel calls per timed burst of :func:`run_kernel_benchmark`
BURST = 8


# ------------------------------------------------------------------- spec --

@dataclass(frozen=True)
class ContractionSpec:
    """``C[out] = A[a_idx] * B[b_idx]`` in Einstein notation."""

    a_idx: str
    b_idx: str
    out_idx: str

    @staticmethod
    def parse(expr: str) -> "ContractionSpec":
        """Parse e.g. ``"abc=ai,ibc"`` or einsum-style ``"ai,ibc->abc"``."""
        if "->" in expr:
            ins, out = expr.split("->")
            a, b = ins.split(",")
        else:
            out, ins = expr.split("=")
            a, b = ins.split(",")
        return ContractionSpec(a.strip(), b.strip(), out.strip())

    @property
    def contracted(self) -> Tuple[str, ...]:
        """Indices summed over: shared by A and B but absent from C.

        An index shared by A and B that *also* appears in the output is a
        batch index (e.g. ``b`` in ``bij,bjk->bik``), not a contraction.
        """
        return tuple(i for i in self.a_idx
                     if i in self.b_idx and i not in self.out_idx)

    @property
    def batch(self) -> Tuple[str, ...]:
        """Indices shared by A, B and C (batch dimensions).

        The §6.1 kernels are plain BLAS calls without batching, so batch
        indices can only ever be loop indices.
        """
        return tuple(i for i in self.a_idx
                     if i in self.b_idx and i in self.out_idx)

    @property
    def all_indices(self) -> Tuple[str, ...]:
        seen = []
        for i in self.a_idx + self.b_idx:
            if i not in seen:
                seen.append(i)
        return tuple(seen)

    def flops(self, sizes: Mapping[str, int]) -> float:
        return 2.0 * math.prod(sizes[i] for i in self.all_indices)

    def einsum_expr(self) -> str:
        return f"{self.a_idx},{self.b_idx}->{self.out_idx}"


# -------------------------------------------------------------- algorithms --

#: kernel patterns: (#free-A kernel dims, #free-B kernel dims, #contracted)
_KERNEL_PATTERNS = {
    "gemm": (1, 1, 1),
    "gemv": (1, 0, 1),   # A matrix, B vector
    "gevm": (0, 1, 1),   # row-vector x matrix
    "ger": (1, 1, 0),    # outer-product update
    "dot": (0, 0, 1),
    "axpy_a": (1, 0, 0),  # scaled copy of an A fiber
    "axpy_b": (0, 1, 0),
}


@dataclass(frozen=True)
class ContractionAlgorithm:
    """One loop-nest + kernel decomposition of a contraction (§6.1)."""

    spec: ContractionSpec
    kernel: str
    kernel_dims: Tuple[str, ...]   # indices handled inside the kernel call
    loop_order: Tuple[str, ...]    # outer-to-inner loop indices

    @property
    def name(self) -> str:
        loops = "".join(self.loop_order) or "-"
        return f"loops[{loops}]_{self.kernel}[{''.join(self.kernel_dims)}]"

    def kernel_equation(self) -> str:
        """Einsum equation of one kernel invocation."""
        a = "".join(i for i in self.spec.a_idx if i in self.kernel_dims)
        b = "".join(i for i in self.spec.b_idx if i in self.kernel_dims)
        o = "".join(i for i in self.spec.out_idx if i in self.kernel_dims)
        return f"{a},{b}->{o}"

    def n_iterations(self, sizes: Mapping[str, int]) -> int:
        return math.prod(sizes[i] for i in self.loop_order) if \
            self.loop_order else 1

    def kernel_shapes(self, sizes: Mapping[str, int]):
        a = tuple(sizes[i] for i in self.spec.a_idx if i in self.kernel_dims)
        b = tuple(sizes[i] for i in self.spec.b_idx if i in self.kernel_dims)
        o = tuple(sizes[i] for i in self.spec.out_idx
                  if i in self.kernel_dims)
        return a, b, o

    def kernel_flops(self, sizes: Mapping[str, int]) -> float:
        return 2.0 * math.prod(sizes[i] for i in self.kernel_dims)


def generate_algorithms(spec: ContractionSpec,
                        max_loop_perms: int = 24) -> List[ContractionAlgorithm]:
    """Enumerate all loop/kernel decompositions (§6.1).

    For every kernel pattern, choose kernel indices (free-A, free-B,
    contracted) consistent with the pattern, make the rest loop indices, and
    emit one algorithm per loop-order permutation.
    """
    contracted = set(spec.contracted)
    batch = set(spec.batch)
    # batch indices are neither free nor contracted: the BLAS-style kernel
    # patterns cannot absorb them, so they may only become loop indices
    free_a = [i for i in spec.a_idx if i not in contracted and i not in batch]
    free_b = [i for i in spec.b_idx if i not in contracted and i not in batch]
    algs: List[ContractionAlgorithm] = []
    seen = set()
    for kernel, (nfa, nfb, nc) in _KERNEL_PATTERNS.items():
        for ka in itertools.combinations(free_a, nfa):
            for kb in itertools.combinations(free_b, nfb):
                for kc in itertools.combinations(sorted(contracted), nc):
                    kdims = tuple(ka) + tuple(kb) + tuple(kc)
                    loops = [i for i in spec.all_indices if i not in kdims]
                    perms = list(itertools.permutations(loops))
                    if len(perms) > max_loop_perms:
                        perms = perms[:max_loop_perms]
                    for order in perms:
                        key = (kernel, kdims, order)
                        if key in seen:
                            continue
                        seen.add(key)
                        algs.append(ContractionAlgorithm(
                            spec, kernel, kdims, order))
    return algs


# --------------------------------------------------------------- execution --

_ALPHABET = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


@functools.lru_cache(maxsize=None)
def canonical_equation(equation: str) -> str:
    """Relabel an einsum equation by order of first appearance.

    ``ik,kl->il`` and ``ij,jk->ik`` both become ``ab,bc->ac``: einsum is
    invariant under index renaming (operand *shapes* are positional), so
    one micro-benchmark serves every renaming.  Execution
    (:func:`execute`) and the ``repro_torch.tc`` suite both key on the
    canonical form.
    """
    ins, out = equation.split("->")
    a, b = ins.split(",")
    mapping: Dict[str, str] = {}
    for ch in a + b + out:
        if ch not in mapping:
            mapping[ch] = _ALPHABET[len(mapping)]
    rename = lambda s: "".join(mapping[c] for c in s)  # noqa: E731
    return f"{rename(a)},{rename(b)}->{rename(out)}"


def kernel_call(equation: str, a: torch.Tensor, b: torch.Tensor,
                out: torch.Tensor) -> None:
    """ONE kernel invocation: ``out += einsum(equation, a, b)``.

    The function both :func:`execute` (per loop iteration, on slices of
    A, B and C) and :func:`run_kernel_benchmark` (on its buffers) run,
    so the measured call is the executed call.  Two launches on the card:
    the einsum (a cuBLAS product, or a reduction) and the in-place add.
    ``equation`` must be canonical (:func:`canonical_equation`).
    """
    out.add_(torch.einsum(equation, a, b))


def _on(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (dtype kept)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
    return t.to(device)


def _loops_first(idx: str, alg: ContractionAlgorithm):
    """(permutation, loop indices) that lay an operand with index string
    ``idx`` out with its loop indices outermost, in loop order, and its
    kernel dims after them in ``idx`` order."""
    loops = [i for i in alg.loop_order if i in idx]
    order = loops + [i for i in idx if i not in loops]
    return [idx.index(i) for i in order], loops


def execute(alg: ContractionAlgorithm, A, B, sizes: Mapping[str, int], *,
            device: DeviceLike = None) -> torch.Tensor:
    """Run the loop nest on ``device``, one :func:`kernel_call` per
    iteration; returns C as a tensor on ``device``.

    A and B (numpy arrays or tensors) move to the device once, before the
    loop, and C is allocated there: no iteration copies anything between
    host and device (the reference copies each iteration's slices and
    result).  Before the loop, A and B are laid out with their loop
    indices outermost (a copy unless they already are), and C is built in
    that layout and laid back at the end, so every iteration's operands
    are contiguous blocks, as the micro-benchmark's buffers are: a strided
    slice would cost a hidden copy inside ``torch.einsum`` and strided
    writes that the benchmark does not price.  The loop does not
    synchronise, so its launches pipeline.
    """
    dev = resolve_device(device)
    spec = alg.spec
    (pa, la), (pb, lb), (pc, lc) = (_loops_first(idx, alg) for idx in
                                    (spec.a_idx, spec.b_idx, spec.out_idx))
    A = _on(A, dev).permute(pa).contiguous()
    B = _on(B, dev).permute(pb).contiguous()
    C = torch.zeros(tuple(sizes[spec.out_idx[k]] for k in pc),
                    dtype=torch.promote_types(A.dtype, B.dtype), device=dev)
    eq = canonical_equation(alg.kernel_equation())
    ranges = [range(sizes[i]) for i in alg.loop_order]
    for combo in itertools.product(*ranges):
        assign = dict(zip(alg.loop_order, combo))
        kernel_call(eq, A[tuple(assign[i] for i in la)],
                    B[tuple(assign[i] for i in lb)],
                    C[tuple(assign[i] for i in lc)])
    return C.permute([pc.index(k) for k in range(len(pc))]).contiguous()


def execute_reference(spec: ContractionSpec, A, B, *,
                      device: DeviceLike = None) -> torch.Tensor:
    """The whole contraction as one ``torch.einsum`` on ``device``."""
    dev = resolve_device(device)
    return torch.einsum(spec.einsum_expr(), _on(A, dev), _on(B, dev))


# ----------------------------------------------------- cache-aware predict --

def l2_cache_bytes(device: DeviceLike = None) -> int:
    """The card's L2 capacity in bytes, read from the device.

    The warm/cold cache classes are decided against it.  The CPU has no
    such number here: CPU callers pass ``cache_bytes=`` explicitly.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the CPU has no device L2 to read; pass "
                         "cache_bytes= explicitly")
    return int(torch.cuda.get_device_properties(dev).L2_cache_size)


def _cache_bytes(cache_bytes: Optional[int], device: DeviceLike) -> int:
    return l2_cache_bytes(device) if cache_bytes is None else cache_bytes


def access_distance(alg: ContractionAlgorithm,
                    sizes: Mapping[str, int]) -> Dict[str, float]:
    """Bytes touched between consecutive uses of the same slice (§6.2.3).

    For each operand, count the iterations of the innermost loops that do
    NOT index it: the same slice is reused once those loops cycle, and the
    data touched in between — that many calls' working sets — is the access
    distance.  Operands indexed by the innermost loop change slice every
    iteration, and operands not indexed by any loop are touched on *every*
    iteration; in both cases one call's working set separates consecutive
    uses (distance = ``call_bytes``, never 0).
    """
    spec = alg.spec
    a_sh, b_sh, o_sh = alg.kernel_shapes(sizes)
    call_bytes = _ITEM * (math.prod(a_sh) + math.prod(b_sh) +
                          math.prod(o_sh))
    out = {}
    for name, idx in (("A", spec.a_idx), ("B", spec.b_idx),
                      ("C", spec.out_idx)):
        # walk loops inner -> outer; accumulate iteration space not touching
        # this operand, up to the innermost loop that does index it
        reuse_span = 1
        indexed = False
        for loop in reversed(alg.loop_order):
            if loop in idx:
                indexed = True
                break
            reuse_span *= sizes[loop]
        out[name] = call_bytes * (reuse_span if indexed else 1)
    return out


def cold_pool_size(repetitions: int, call_bytes: int,
                   cache_bytes: int) -> int:
    """Buffers needed to keep a cold operand cold across the benchmark.

    Cycling through ``n`` buffers re-uses each one every ``n`` calls —
    with ``n * call_bytes`` of kernel traffic in between — so ``n`` must
    span the cache capacity; alternatively ``repetitions + 1`` buffers
    (one per timed call plus the overhead call) suffice outright because
    no buffer is ever re-used.  On the card the span term keeps the pool
    of a large operand small: a 256 MiB operand against a 50 MiB L2 needs
    two buffers.
    """
    span = math.ceil(cache_bytes / max(call_bytes, 1)) + 1
    return max(2, min(repetitions + 1, span))


# reprolint: hot-path
def run_kernel_benchmark(equation: str, a_shape: Sequence[int],
                         b_shape: Sequence[int], out_shape: Sequence[int], *,
                         cold_a: bool, cold_b: bool, repetitions: int,
                         cache_bytes: Optional[int] = None,
                         device: DeviceLike = None,
                         seed: int = 0) -> Tuple[Stats, float]:
    """The §6.2 measurement protocol for one kernel signature.

    Returns (per-call stats, first-call overhead in seconds).  Each of the
    ``repetitions`` samples is a burst of :data:`BURST` back-to-back
    :func:`kernel_call`\\ s ended by one synchronisation, divided by
    :data:`BURST`: the calls pipeline as they do in :func:`execute`, which
    does not wait for each call, so a sample prices launch and kernel as
    the loop pays them (a sync per call would add its latency to every
    call).  Cold input operands cycle through a pool of distinct buffers
    over all ``repetitions * BURST`` timed calls — sized by
    :func:`cold_pool_size` against ``cache_bytes`` (the card's L2 when not
    given) — while warm ones reuse one buffer.  Buffers are contiguous;
    :func:`execute` may pass strided slices (see ``PERF.md``).  One
    untimed call comes first: it pays what a process pays once per kernel
    and shape (CUDA's lazy module loading, the library's handles and
    heuristics), which :func:`measure_contraction`'s warm-up also keeps
    out of the measured time and which would otherwise land on whichever
    key happens to be measured first.  The first-call overhead is then
    the next call's time, synchronised on its own, beyond the median
    per-call time, at least 0: the latency a loop pays once per
    execution.  Shared by the per-algorithm
    :func:`microbenchmark` and the deduplicated ``repro_torch.tc`` suite,
    so the two paths can never desynchronize.
    """
    dev = resolve_device(device)
    cache_bytes = _cache_bytes(cache_bytes, dev)
    eq = canonical_equation(equation)
    call_bytes = _ITEM * (math.prod(a_shape) + math.prod(b_shape) +
                          math.prod(out_shape))
    n_cyc = cold_pool_size(repetitions * BURST, call_bytes, cache_bytes)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def buffers(shape, n):
        return [torch.randn(tuple(shape), generator=gen, device=dev)
                for _ in range(n)]

    a_bufs = buffers(a_shape, n_cyc if cold_a else 1)
    b_bufs = buffers(b_shape, n_cyc if cold_b else 1)
    out = torch.zeros(tuple(out_shape), device=dev)
    counter = [0]

    def call():
        i = counter[0]
        counter[0] += 1
        kernel_call(eq, a_bufs[i % len(a_bufs)], b_bufs[i % len(b_bufs)],
                    out)

    call()                                 # process-once set-up, untimed
    synchronize(dev)
    t0 = time.perf_counter()
    call()
    # the sync IS the measurement: the host clock brackets the call only
    # once the device has finished it
    # reprolint: allow[host-sync]
    synchronize(dev)
    first = time.perf_counter() - t0
    samples = []
    for _ in range(repetitions):
        t0 = time.perf_counter()
        for _ in range(BURST):
            call()
        # one sync per burst: the burst's calls pipeline, as in execute
        # reprolint: allow[host-sync]
        synchronize(dev)
        samples.append((time.perf_counter() - t0) / BURST)
    stats = Stats.from_samples(samples)
    return stats, max(first - stats.med, 0.0)


def microbenchmark(alg: ContractionAlgorithm, sizes: Mapping[str, int], *,
                   repetitions: int = 5, cache_bytes: Optional[int] = None,
                   device: DeviceLike = None,
                   seed: int = 0) -> Tuple[Stats, float]:
    """Cache-aware micro-benchmark of ONE kernel invocation (§6.2).

    Classifies each input operand warm/cold by its access distance versus
    the cache capacity (the card's L2 unless ``cache_bytes`` is given)
    and delegates the measurement to :func:`run_kernel_benchmark`.
    """
    dev = resolve_device(device)
    cache_bytes = _cache_bytes(cache_bytes, dev)
    a_sh, b_sh, o_sh = alg.kernel_shapes(sizes)
    dists = access_distance(alg, sizes)
    return run_kernel_benchmark(alg.kernel_equation(), a_sh, b_sh, o_sh,
                                cold_a=dists["A"] > cache_bytes,
                                cold_b=dists["B"] > cache_bytes,
                                repetitions=repetitions,
                                cache_bytes=cache_bytes, device=dev,
                                seed=seed)


def predict_contraction(alg: ContractionAlgorithm,
                        sizes: Mapping[str, int], *,
                        repetitions: int = 5,
                        stat: str = "med",
                        breakdown: bool = False,
                        cache_bytes: Optional[int] = None,
                        device: DeviceLike = None):
    """Predicted total runtime: first-call overhead + n_iterations x per-call.

    The measured first-call overhead (§6.2.6) is included once in the
    total; ``breakdown=True`` returns the components instead.
    """
    stats, first = microbenchmark(alg, sizes, repetitions=repetitions,
                                  cache_bytes=cache_bytes, device=device)
    n = alg.n_iterations(sizes)
    per_call = getattr(stats, stat)
    total = first + per_call * n
    if breakdown:
        return {"total_s": total, "first_call_s": first,
                "loop_s": per_call * n, "per_call_s": per_call,
                "n_iterations": n}
    return total


def rank_contraction_algorithms(spec: ContractionSpec,
                                sizes: Mapping[str, int], *,
                                algorithms: Optional[Sequence[
                                    ContractionAlgorithm]] = None,
                                stat: str = "med",
                                batched: bool = True,
                                session=None,
                                repetitions: Optional[int] = None,
                                cache_bytes: Optional[int] = None,
                                device: DeviceLike = None,
                                ) -> List[Tuple[ContractionAlgorithm, float]]:
    """Predict every algorithm and sort ascending by predicted runtime.

    By default this runs on :class:`repro_torch.tc.ContractionPredictor`
    through ``session`` (a :class:`repro_torch.tc.PredictorSession`; a
    default session when ``None``): the candidate set — batched-kernel
    algorithms included when ``algorithms`` is not given — shares one
    deduplicated micro-benchmark suite and is predicted through the
    batched :class:`PredictionEngine`.  ``batched=False`` keeps the
    original per-algorithm path — one independent micro-benchmark per
    candidate — as the equivalence oracle; ``repetitions``,
    ``cache_bytes`` and ``device`` configure that path only (the session
    owns them on the batched one).
    """
    algorithms = list(algorithms) if algorithms is not None else None
    if batched:
        if repetitions is not None or cache_bytes is not None or \
                device is not None:
            raise ValueError("repetitions=/cache_bytes=/device= configure "
                             "the scalar oracle (batched=False); the "
                             "batched path takes them from session=")
        if session is None:
            from ..tc.session import PredictorSession  # lazy: tc needs core
            session = PredictorSession()
        ranked = session.rank_contraction_algorithms(
            spec, sizes, stat=stat, algorithms=algorithms)
        return [(r.algorithm, getattr(r.runtime, stat)) for r in ranked]
    if session is not None:
        raise ValueError("session= applies to the batched predictor; the "
                         "scalar oracle (batched=False) runs without one")
    algs = algorithms if algorithms is not None else \
        generate_algorithms(spec)
    reps = 5 if repetitions is None else repetitions
    ranked = [(a, predict_contraction(a, sizes, repetitions=reps, stat=stat,
                                      cache_bytes=cache_bytes,
                                      device=device)) for a in algs]
    ranked.sort(key=lambda t: t[1])
    return ranked


def measure_contraction(alg: ContractionAlgorithm, A, B,
                        sizes: Mapping[str, int], repetitions: int = 3, *,
                        device: DeviceLike = None) -> Stats:
    """Time full algorithm executions (the expensive reference, §6.3).

    A and B move to the device before any timing; one untimed execution
    warms up; every timed execution is bracketed by synchronisations, so
    the host clock reads the device's finish, not the last launch.
    """
    dev = resolve_device(device)
    A, B = _on(A, dev), _on(B, dev)
    execute(alg, A, B, sizes, device=dev)  # warm-up
    samples = []
    for _ in range(repetitions):
        synchronize(dev)
        t0 = time.perf_counter()
        execute(alg, A, B, sizes, device=dev)
        synchronize(dev)
        samples.append(time.perf_counter() - t0)
    return Stats.from_samples(samples)
