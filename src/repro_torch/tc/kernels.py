"""Batched-kernel extension of the §6.1 contraction-algorithm generator.

The paper's §6.1 kernels are plain BLAS calls, so any output index that is
not a kernel dimension — in particular every batch index shared by A, B and
C — can only become a loop index.  Modern BLAS-like libraries (cuBLAS's
strided-batched products behind ``torch.einsum``) provide *batched*
kernels: one call evaluating a whole stack of gemms/gemvs/dots.  This
generator promotes them to first-class §6.1 kernels: on top of a base
kernel pattern, a nonempty subset of the remaining output indices is
absorbed into the kernel call as batch dimensions (broadcasting the
operand that lacks them), e.g.
``bij,bjk->bik`` executed as ONE batched matmul, or with ``b`` batched
inside a ``bij,bj->bi`` batched gemv while ``k`` stays a loop index.

The absorbed indices simply join ``kernel_dims``, so the existing
:class:`ContractionAlgorithm` machinery — ``kernel_equation``/``execute``
(the kernel is the einsum over the kernel dims), ``kernel_flops`` (2x the
product of all kernel-dim extents) and ``access_distance`` (a walk over
the remaining loops) — handles the new kernel class unchanged; batched
algorithms are distinguished by the ``_batch`` kernel-name suffix.
Algorithms whose kernel equation and loop order coincide with an already
generated one (a batched gemv over the full free range *is* a gemm) are
dropped, and :func:`validate_algorithms` checks every survivor against
``execute_reference`` on the device.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.contractions import (ContractionAlgorithm, ContractionSpec,
                                 _ITEM, _KERNEL_PATTERNS, execute,
                                 execute_reference)
from ..core.contractions import generate_algorithms as generate_loop_algorithms

#: kernel-name suffix marking the batched-kernel class
BATCH_SUFFIX = "_batch"

#: base kernels that have a batched counterpart (batched gemm/gemv analogues)
BATCHABLE_KERNELS = ("gemm", "gemv", "gevm", "dot")


def is_batched_kernel(kernel: str) -> bool:
    """Whether ``kernel`` belongs to the batched-kernel class (name carries
    the ``_batch`` suffix, e.g. ``"gemm_batch"``)."""
    return kernel.endswith(BATCH_SUFFIX)


def base_kernel(kernel: str) -> str:
    """The plain-BLAS kernel a (possibly batched) kernel is built on."""
    return kernel[:-len(BATCH_SUFFIX)] if is_batched_kernel(kernel) else kernel


def kernel_batch_dims(alg: ContractionAlgorithm) -> Tuple[str, ...]:
    """The kernel dims ``alg`` absorbed as batch dimensions.

    Empty for plain kernels.  For batched kernels this relies on the
    generator's layout contract: ``kernel_dims`` is always the base
    pattern's dims (free-A, free-B, contracted — their count fixed by
    :data:`_KERNEL_PATTERNS`) followed by the absorbed output indices, so
    the batch dims are exactly the tail beyond the base pattern's arity.
    """
    if not is_batched_kernel(alg.kernel):
        return ()
    nfa, nfb, nc = _KERNEL_PATTERNS[base_kernel(alg.kernel)]
    return alg.kernel_dims[nfa + nfb + nc:]


def slice_call_bytes(alg: ContractionAlgorithm,
                     sizes: Mapping[str, int]) -> int:
    """Bytes one *batch slice* of a kernel call touches.

    A batched kernel walks its batch dimensions slice by slice — strided
    access where at any instant the cache holds one slice's working set,
    not the whole stacked operands.  The footprint relevant for cache
    classification is therefore the per-slice call bytes: each operand
    contributes the product of its non-batch kernel-dim extents (operands
    that lack a batch dim are broadcast, i.e. shared by every slice, and
    contribute their full kernel footprint).  For plain kernels this
    equals the whole call's bytes.
    """
    batch = set(kernel_batch_dims(alg))
    spec = alg.spec
    total = 0
    for idx in (spec.a_idx, spec.b_idx, spec.out_idx):
        dims = [i for i in idx if i in alg.kernel_dims and i not in batch]
        total += math.prod(sizes[i] for i in dims)
    return _ITEM * total


def generate_batched_algorithms(
        spec: ContractionSpec, *,
        kernels: Sequence[str] = BATCHABLE_KERNELS,
        max_loop_perms: int = 24,
        existing: Sequence[ContractionAlgorithm] = (),
) -> List[ContractionAlgorithm]:
    """Enumerate batched-kernel decompositions of ``spec``.

    For every base kernel pattern, choose kernel indices exactly as the
    loop-only generator does, then absorb each nonempty subset of the
    remaining *output* indices into the kernel as batch dimensions (an
    index summed over cannot batch — it would change the result).  The
    rest stay loop indices.  Candidates operationally identical to one in
    ``existing`` or generated earlier — same kernel equation AND same loop
    order — are dropped.
    """
    contracted = set(spec.contracted)
    batch = set(spec.batch)
    free_a = [i for i in spec.a_idx if i not in contracted and i not in batch]
    free_b = [i for i in spec.b_idx if i not in contracted and i not in batch]
    seen = {(a.kernel_equation(), a.loop_order) for a in existing}
    algs: List[ContractionAlgorithm] = []
    for kernel in kernels:
        nfa, nfb, nc = _KERNEL_PATTERNS[kernel]
        for ka in itertools.combinations(free_a, nfa):
            for kb in itertools.combinations(free_b, nfb):
                for kc in itertools.combinations(sorted(contracted), nc):
                    base_dims = tuple(ka) + tuple(kb) + tuple(kc)
                    pool = [i for i in spec.out_idx if i not in base_dims]
                    for r in range(1, len(pool) + 1):
                        for bd in itertools.combinations(pool, r):
                            kdims = base_dims + bd
                            loops = [i for i in spec.all_indices
                                     if i not in kdims]
                            perms = list(itertools.permutations(loops))
                            if len(perms) > max_loop_perms:
                                perms = perms[:max_loop_perms]
                            for order in perms:
                                alg = ContractionAlgorithm(
                                    spec, kernel + BATCH_SUFFIX, kdims, order)
                                key = (alg.kernel_equation(), order)
                                if key in seen:
                                    continue
                                seen.add(key)
                                algs.append(alg)
    return algs


def generate_algorithms(spec: ContractionSpec, *,
                        include_batched: bool = True,
                        max_loop_perms: int = 24,
                        batched_kernels: Sequence[str] = BATCHABLE_KERNELS,
                        ) -> List[ContractionAlgorithm]:
    """All loop/kernel decompositions, batched-kernel class included.

    The superset of the core §6.1 generator: its loop-only algorithms plus
    (unless ``include_batched=False``) the batched-kernel algorithms of
    :func:`generate_batched_algorithms`, deduplicated against them.
    """
    algs = generate_loop_algorithms(spec, max_loop_perms=max_loop_perms)
    if include_batched:
        algs = algs + generate_batched_algorithms(
            spec, kernels=batched_kernels, max_loop_perms=max_loop_perms,
            existing=algs)
    return algs


def validate_algorithms(spec: ContractionSpec,
                        algorithms: Sequence[ContractionAlgorithm],
                        sizes: Mapping[str, int], *,
                        rng: Optional[np.random.Generator] = None,
                        rtol: float = 2e-4, atol: float = 2e-4,
                        device: DeviceLike = None) -> None:
    """Execute every algorithm on random operands against the einsum
    reference on ``device``; raises ``AssertionError`` naming the
    mismatches."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal(
        [sizes[i] for i in spec.a_idx]).astype(np.float32)).to(dev)
    B = torch.from_numpy(rng.standard_normal(
        [sizes[i] for i in spec.b_idx]).astype(np.float32)).to(dev)
    ref = execute_reference(spec, A, B, device=dev)
    bad = []
    for alg in algorithms:
        got = execute(alg, A, B, sizes, device=dev)
        if not torch.allclose(got, ref, rtol=rtol, atol=atol):
            bad.append(alg.name)
    if bad:
        raise AssertionError(
            f"{len(bad)}/{len(algorithms)} algorithms disagree with "
            f"execute_reference for {spec.einsum_expr()}: {bad}")
