"""Named tracer catalogs: (n, b) -> kernel-call sequence (paper §4.5/§4.6).

These are the algorithm sets the paper ranks: 3 Cholesky variants, 8
triangular-inversion variants, 8 Sylvester combinations, and the blocked
LAPACK algorithms of §4.4.  Each tracer produces the exact call sequence of
one algorithm execution without running any kernel.
"""

from __future__ import annotations

from typing import Dict, List

from ..core.predict import KernelCall, Tracer
from . import blocked
from .engine import Matrix, TraceEngine, trace_calls

_traced = trace_calls


def potrf_tracer(variant: int) -> Tracer:
    def tracer(n: int, b: int) -> List[KernelCall]:
        return _traced(lambda e: blocked.potrf(e, Matrix("A", n, n), n, b,
                                               variant))
    return tracer


def trtri_tracer(variant: int) -> Tracer:
    def tracer(n: int, b: int) -> List[KernelCall]:
        return _traced(lambda e: blocked.trtri(e, Matrix("A", n, n), n, b,
                                               variant))
    return tracer


def lauum_tracer() -> Tracer:
    def tracer(n: int, b: int) -> List[KernelCall]:
        return _traced(lambda e: blocked.lauum(e, Matrix("A", n, n), n, b))
    return tracer


def sygst_tracer() -> Tracer:
    def tracer(n: int, b: int) -> List[KernelCall]:
        return _traced(lambda e: blocked.sygst(e, Matrix("A", n, n),
                                               Matrix("L", n, n), n, b))
    return tracer


def getrf_tracer() -> Tracer:
    def tracer(n: int, b: int) -> List[KernelCall]:
        return _traced(lambda e: blocked.getrf(e, Matrix("A", n, n), n, b))
    return tracer


def geqrf_tracer() -> Tracer:
    def tracer(n: int, b: int) -> List[KernelCall]:
        return _traced(lambda e: blocked.geqrf(e, Matrix("A", n, n), n, n, b))
    return tracer


def sylvester_tracer(algorithm: str) -> Tracer:
    def tracer(n: int, b: int) -> List[KernelCall]:
        return _traced(lambda e: blocked.sylvester(
            e, Matrix("A", n, n), Matrix("B", n, n), Matrix("C", n, n),
            n, n, b, algorithm))
    return tracer


CHOLESKY_TRACERS: Dict[str, Tracer] = {
    f"potrf{v}": potrf_tracer(v) for v in (1, 2, 3)
}

TRTRI_TRACERS: Dict[str, Tracer] = {
    f"trtri{v}": trtri_tracer(v) for v in range(1, 9)
}

SYLVESTER_TRACERS: Dict[str, Tracer] = {
    alg: sylvester_tracer(alg) for alg in blocked.SYLVESTER_ALGORITHMS
}

LAPACK_TRACERS: Dict[str, Tracer] = {
    "lauum": lauum_tracer(),
    "sygst": sygst_tracer(),
    "trtri": trtri_tracer(5),   # LAPACK dtrtri_LN = algorithm 5
    "potrf": potrf_tracer(2),   # LAPACK dpotrf_L  = algorithm 2
    "getrf": getrf_tracer(),
    "geqrf": geqrf_tracer(),
}

#: the full catalog, one flat name -> tracer map (LAPACK aliases shadow the
#: identically-named variant entries they point at)
ALL_TRACERS: Dict[str, Tracer] = {**CHOLESKY_TRACERS, **TRTRI_TRACERS,
                                  **SYLVESTER_TRACERS, **LAPACK_TRACERS}


def required_kernel_cases(tracers=None, n: int = 264, b: int = 56,
                          dims: Dict[str, int] = None) -> dict:
    """All (kernel, case) pairs any catalog algorithm emits — used to decide
    which sub-models to generate (§3.2.1: 'only a limited set').

    Pass a dict as ``dims`` to also collect each kernel's size-argument
    count (the model-domain rank), e.g. for building synthetic model sets.
    """
    cats = tracers or ALL_TRACERS
    need: Dict[str, set] = {}
    for tracer in cats.values():
        for call in tracer(n, b):
            need.setdefault(call.kernel, set()).add(call.case)
            if dims is not None:
                dims[call.kernel] = len(call.sizes)
    return need
