"""Blocked algorithms (paper Ch. 1/4): algorithm variants as engine programs.

Every algorithm is written once against the :class:`~repro_torch.dla.engine.Engine`
interface; running it on a :class:`TraceEngine` yields the kernel-call
sequence consumed by the predictor, running it on an :class:`ExecEngine`
computes the actual decomposition (validated against ``numpy.linalg`` oracles
in the tests).

Implemented catalogs:

* Cholesky ``potrf`` — 3 variants (Fig 1.1: bordered / left- / right-looking)
* triangular inversion ``trtri`` — 8 variants (Fig 4.13: lazy-row,
  swapped-lazy-row, right-looking-gemm, wasteful-square ×2 traversals)
* ``lauum``, ``sygst``, ``getrf`` (non-pivoted panel), ``geqrf`` — LAPACK's
  blocked algorithms (Fig 4.8/4.9)
* triangular Sylvester solvers — m1/m2/n1/n2 panel traversals and their 8
  "complete" combinations (Fig 4.15, §4.5.3)
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ..core.predict import KernelCall
from .engine import Engine, ExecEngine, Matrix, TraceEngine


def _steps(n: int, b: int):
    k = 0
    while k < n:
        kb = min(b, n - k)
        yield k, kb
        k += kb


def _steps_rev(n: int, b: int):
    """Bottom-up traversal aligned to the same block boundaries."""
    return reversed(list(_steps(n, b)))


# ------------------------------------------------------------------ potrf --

def potrf(eng: Engine, A: Matrix, n: int, b: int, variant: int = 3) -> None:
    """Lower Cholesky L L^T := A, in place (Fig 1.1 variants 1-3)."""
    for k, kb in _steps(n, b):
        A00 = A.v(0, k, 0, k)
        A10 = A.v(k, k + kb, 0, k)
        A11 = A.v(k, k + kb, k, k + kb)
        A20 = A.v(k + kb, n, 0, k)
        A21 = A.v(k + kb, n, k, k + kb)
        A22 = A.v(k + kb, n, k + kb, n)
        if variant == 1:      # bordered: touch only current block row
            eng.trsm("R", "L", "T", "N", 1, A00, A10)
            eng.syrk("L", "N", -1, 1, A10, A11)
            eng.potf2("L", A11)
        elif variant == 2:    # left-looking (LAPACK dpotrf)
            eng.syrk("L", "N", -1, 1, A10, A11)
            eng.potf2("L", A11)
            eng.gemm("N", "T", -1, 1, A20, A10, A21)
            eng.trsm("R", "L", "T", "N", 1, A11, A21)
        elif variant == 3:    # right-looking ("greedy", Fig 4.1)
            eng.potf2("L", A11)
            eng.trsm("R", "L", "T", "N", 1, A11, A21)
            eng.syrk("L", "N", -1, 1, A21, A22)
        else:
            raise ValueError(f"potrf variant {variant}")


# ------------------------------------------------------------------ trtri --

def trtri(eng: Engine, A: Matrix, n: int, b: int, variant: int = 3) -> None:
    """Lower-triangular inversion A := A^{-1}, in place (Fig 4.13).

    Variants 1-4 traverse ↘, 5-8 are their ↖ mirrors.  Variants 4/8 are the
    wasteful "square" variants (triangular panels treated as full matrices →
    ~2-3× the minimal FLOPs; cf. the paper's unstable algorithms 4/8).
    """
    if variant in (1, 2, 3, 4):
        for k, kb in _steps(n, b):
            A00 = A.v(0, k, 0, k)
            A10 = A.v(k, k + kb, 0, k)
            A11 = A.v(k, k + kb, k, k + kb)
            A20 = A.v(k + kb, n, 0, k)
            A21 = A.v(k + kb, n, k, k + kb)
            if variant == 1:   # lazy row panel (Table 4.1)
                eng.trmm("R", "L", "N", "N", 1, A00, A10)
                eng.trsm("L", "L", "N", "N", -1, A11, A10)
                eng.trti2("L", "N", A11)
            elif variant == 2:  # lazy row panel, swapped update order
                eng.trsm("L", "L", "N", "N", -1, A11, A10)
                eng.trmm("R", "L", "N", "N", 1, A00, A10)
                eng.trti2("L", "N", A11)
            elif variant == 3:  # right-looking, gemm-rich
                eng.trti2("L", "N", A11)
                eng.trmm("R", "L", "N", "N", -1, A11, A21)
                eng.gemm("N", "N", 1, 1, A21, A10, A20)
                eng.trmm("L", "L", "N", "N", 1, A11, A10)
            else:               # 4: wasteful square version of variant 1
                eng.gemm("N", "N", 1, 0, A10, A00, A10)
                eng.trti2("L", "N", A11)
                eng.gemm("N", "N", -1, 0, A11, A10, A10)
        if variant == 4:
            return
    elif variant in (5, 6, 7, 8):
        for k, kb in _steps_rev(n, b):
            A10 = A.v(k, k + kb, 0, k)
            A11 = A.v(k, k + kb, k, k + kb)
            A20 = A.v(k + kb, n, 0, k)
            A21 = A.v(k + kb, n, k, k + kb)
            A22 = A.v(k + kb, n, k + kb, n)
            if variant == 5:   # lazy column panel (LAPACK dtrtri_LN)
                eng.trmm("L", "L", "N", "N", 1, A22, A21)
                eng.trsm("R", "L", "N", "N", -1, A11, A21)
                eng.trti2("L", "N", A11)
            elif variant == 6:  # swapped update order
                eng.trsm("R", "L", "N", "N", -1, A11, A21)
                eng.trmm("L", "L", "N", "N", 1, A22, A21)
                eng.trti2("L", "N", A11)
            elif variant == 7:  # right-looking mirror, gemm-rich
                eng.trti2("L", "N", A11)
                eng.trmm("L", "L", "N", "N", -1, A11, A10)
                eng.gemm("N", "N", 1, 1, A21, A10, A20)
                eng.trmm("R", "L", "N", "N", 1, A11, A21)
            else:               # 8: wasteful square version of variant 5
                eng.gemm("N", "N", 1, 0, A22, A21, A21)
                eng.trti2("L", "N", A11)
                eng.gemm("N", "N", -1, 0, A21, A11, A21)
    else:
        raise ValueError(f"trtri variant {variant}")


# ------------------------------------------------------------------ lauum --

def lauum(eng: Engine, A: Matrix, n: int, b: int) -> None:
    """A := L^T L for lower-triangular L in A (LAPACK dlauum_L, Fig 4.8a)."""
    for k, kb in _steps(n, b):
        A10 = A.v(k, k + kb, 0, k)
        A11 = A.v(k, k + kb, k, k + kb)
        A20 = A.v(k + kb, n, 0, k)
        A21 = A.v(k + kb, n, k, k + kb)
        eng.trmm("L", "L", "T", "N", 1, A11, A10)
        eng.gemm("T", "N", 1, 1, A21, A20, A10)
        eng.lauu2("L", A11)
        eng.syrk("L", "T", 1, 1, A21, A11)


# ------------------------------------------------------------------ sygst --

def sygst(eng: Engine, A: Matrix, L: Matrix, n: int, b: int) -> None:
    """A := L^{-1} A L^{-T} (LAPACK dsygst itype=1 lower, Fig 4.8b)."""
    for k, kb in _steps(n, b):
        A11 = A.v(k, k + kb, k, k + kb)
        A21 = A.v(k + kb, n, k, k + kb)
        A22 = A.v(k + kb, n, k + kb, n)
        L11 = L.v(k, k + kb, k, k + kb)
        L21 = L.v(k + kb, n, k, k + kb)
        L22 = L.v(k + kb, n, k + kb, n)
        eng.sygs2(1, "L", A11, L11)
        if k + kb < n:
            eng.trsm("R", "L", "T", "N", 1, L11, A21)
            eng.symm("R", "L", -0.5, 1, A11, L21, A21)
            eng.syr2k("L", "N", -1, 1, A21, L21, A22)
            eng.symm("R", "L", -0.5, 1, A11, L21, A21)
            eng.trsm("L", "L", "N", "N", 1, L22, A21)


# ------------------------------------------------------------------ getrf --

def getrf(eng: Engine, A: Matrix, n: int, b: int) -> None:
    """Blocked LU (non-pivoted panel; see DESIGN.md §8.5), Fig 4.8e."""
    for k, kb in _steps(n, b):
        panel = A.v(k, n, k, k + kb)
        A11 = A.v(k, k + kb, k, k + kb)
        A12 = A.v(k, k + kb, k + kb, n)
        A21 = A.v(k + kb, n, k, k + kb)
        A22 = A.v(k + kb, n, k + kb, n)
        eng.getf2(panel)
        eng.trsm("L", "L", "N", "U", 1, A11, A12)
        eng.gemm("N", "N", -1, 1, A21, A12, A22)


# ------------------------------------------------------------------ geqrf --

def geqrf(eng: Engine, A: Matrix, m: int, n: int, b: int) -> None:
    """Blocked Householder QR (LAPACK dgeqrf, Fig 4.9) — trace structure.

    Per step: panel factorization (``geqr2`` + ``larft``, modeled as one
    unblocked kernel), then the compact-WY block-reflector update
    ``C := (I - V T^T V^T) C`` as gemm / trmm / gemm.
    """
    for k, kb in _steps(min(m, n), b):
        panel = A.v(k, m, k, k + kb)
        eng.geqr2(panel)
        if k + kb < n:
            trail = A.v(k, m, k + kb, n)
            w = A.v(0, kb, 0, trail.cols)      # sizes-only proxy for W
            t = A.v(0, kb, 0, kb)              # sizes-only proxy for T
            eng.gemm("T", "N", 1, 0, panel, trail, w)   # W := V^T C
            eng.trmm("L", "U", "T", "N", 1, t, w)       # W := T^T W
            eng.gemm("N", "N", -1, 1, panel, w, trail)  # C := C - V W


def _house_panel(P):
    """Householder panel factorization + larft (numpy; the geqr2 analogue).

    Returns (V unit-lower-trapezoidal, T upper-triangular, R11).
    """
    import numpy as np

    P = np.asarray(P, dtype=np.float64)
    mp, nb = P.shape
    R = P.copy()
    V = np.zeros((mp, nb))
    taus = np.zeros(nb)
    for j in range(min(mp, nb)):
        x = R[j:, j].copy()
        normx = np.linalg.norm(x)
        if normx == 0.0:
            V[j, j] = 1.0
            continue
        alpha = -np.copysign(normx, x[0] if x[0] != 0 else 1.0)
        v = x.copy()
        v[0] -= alpha
        if abs(v[0]) < 1e-300:
            V[j, j] = 1.0
            R[j, j] = alpha
            continue
        v = v / v[0]
        tau = 2.0 / (v @ v)
        R[j:, j:] -= tau * np.outer(v, v @ R[j:, j:])
        V[j:, j] = v
        taus[j] = tau
    # larft: T upper triangular with H_1..H_nb = I - V T V^T
    T = np.zeros((nb, nb))
    for j in range(nb):
        T[j, j] = taus[j]
        if j:
            T[:j, j] = -taus[j] * (T[:j, :j] @ (V[:, :j].T @ V[:, j]))
    return V, T, np.triu(R[:nb, :nb])


def geqrf_exec(eng: ExecEngine, A: Matrix, m: int, n: int, b: int) -> list:
    """Executable blocked QR mirroring :func:`geqrf`'s kernel calls.

    Returns [(row offset, V, T)] for Q reconstruction in tests.
    """
    import numpy as np

    fac = []
    for k, kb in _steps(min(m, n), b):
        P = eng.mats[A.key][k:m, k:k + kb]
        V, T, R11 = _house_panel(P)
        out = np.zeros_like(P)
        out[:kb, :kb] = R11
        eng.mats[A.key][k:m, k:k + kb] = out
        fac.append((k, V, T))
        if k + kb < n:
            Vm = eng.bind(f"_V{k}", V)
            Tm = eng.bind(f"_T{k}", T)
            Wm = eng.bind(f"_W{k}", np.zeros((kb, n - k - kb)))
            trail = A.v(k, m, k + kb, n)
            eng.gemm("T", "N", 1, 0, Vm.full(), trail, Wm.full())
            eng.trmm("L", "U", "T", "N", 1, Tm.full(), Wm.full())
            eng.gemm("N", "N", -1, 1, Vm.full(), Wm.full(), trail)
    return fac


# -------------------------------------------------------------- sylvester --

def sylv_m1(eng: Engine, A: Matrix, B: Matrix, C: Matrix,
            m: int, n: int, b: int, inner: Callable) -> None:
    """Vertical traversal, lazy: update row panel, then solve (Fig 4.15)."""
    for k, kb in _steps_rev(m, b):
        C1 = C.v(k, k + kb, 0, n)
        A12 = A.v(k, k + kb, k + kb, m)
        C2 = C.v(k + kb, m, 0, n)
        eng.gemm("N", "N", -1, 1, A12, C2, C1)
        inner(eng, A, B, C, k, kb)


def sylv_m2(eng: Engine, A: Matrix, B: Matrix, C: Matrix,
            m: int, n: int, b: int, inner: Callable) -> None:
    """Vertical traversal, eager: solve, then update remaining rows."""
    for k, kb in _steps_rev(m, b):
        inner(eng, A, B, C, k, kb)
        C1 = C.v(k, k + kb, 0, n)
        A01 = A.v(0, k, k, k + kb)
        C0 = C.v(0, k, 0, n)
        eng.gemm("N", "N", -1, 1, A01, C1, C0)


def _sylv_row_inner(n: int, b: int, col_alg: str):
    """Solve one b x n row sub-problem with a horizontal traversal."""

    def inner(eng: Engine, A: Matrix, B: Matrix, C: Matrix,
              r0: int, rb: int) -> None:
        if col_alg == "n1":
            for j, jb in _steps(n, b):
                C1 = C.v(r0, r0 + rb, j, j + jb)
                C0 = C.v(r0, r0 + rb, 0, j)
                B01 = B.v(0, j, j, j + jb)
                eng.gemm("N", "N", -1, 1, C0, B01, C1)
                eng.trsyl("N", "N", 1, A.v(r0, r0 + rb, r0, r0 + rb),
                          B.v(j, j + jb, j, j + jb), C1)
        elif col_alg == "n2":
            for j, jb in _steps(n, b):
                C1 = C.v(r0, r0 + rb, j, j + jb)
                eng.trsyl("N", "N", 1, A.v(r0, r0 + rb, r0, r0 + rb),
                          B.v(j, j + jb, j, j + jb), C1)
                C2 = C.v(r0, r0 + rb, j + jb, n)
                B12 = B.v(j, j + jb, j + jb, n)
                eng.gemm("N", "N", -1, 1, C1, B12, C2)
        else:
            raise ValueError(col_alg)

    return inner


def sylv_n1(eng: Engine, A: Matrix, B: Matrix, C: Matrix,
            m: int, n: int, b: int, inner: Callable) -> None:
    """Horizontal traversal, lazy."""
    for j, jb in _steps(n, b):
        C1 = C.v(0, m, j, j + jb)
        C0 = C.v(0, m, 0, j)
        B01 = B.v(0, j, j, j + jb)
        eng.gemm("N", "N", -1, 1, C0, B01, C1)
        inner(eng, A, B, C, j, jb)


def sylv_n2(eng: Engine, A: Matrix, B: Matrix, C: Matrix,
            m: int, n: int, b: int, inner: Callable) -> None:
    """Horizontal traversal, eager."""
    for j, jb in _steps(n, b):
        inner(eng, A, B, C, j, jb)
        C1 = C.v(0, m, j, j + jb)
        C2 = C.v(0, m, j + jb, n)
        B12 = B.v(j, j + jb, j + jb, n)
        eng.gemm("N", "N", -1, 1, C1, B12, C2)


def _sylv_col_inner(m: int, b: int, row_alg: str):
    """Solve one m x b column sub-problem with a vertical traversal."""

    def inner(eng: Engine, A: Matrix, B: Matrix, C: Matrix,
              c0: int, cb: int) -> None:
        if row_alg == "m1":
            for k, kb in _steps_rev(m, b):
                C1 = C.v(k, k + kb, c0, c0 + cb)
                A12 = A.v(k, k + kb, k + kb, m)
                C2 = C.v(k + kb, m, c0, c0 + cb)
                eng.gemm("N", "N", -1, 1, A12, C2, C1)
                eng.trsyl("N", "N", 1, A.v(k, k + kb, k, k + kb),
                          B.v(c0, c0 + cb, c0, c0 + cb), C1)
        elif row_alg == "m2":
            for k, kb in _steps_rev(m, b):
                C1 = C.v(k, k + kb, c0, c0 + cb)
                eng.trsyl("N", "N", 1, A.v(k, k + kb, k, k + kb),
                          B.v(c0, c0 + cb, c0, c0 + cb), C1)
                A01 = A.v(0, k, k, k + kb)
                C0 = C.v(0, k, c0, c0 + cb)
                eng.gemm("N", "N", -1, 1, A01, C1, C0)
        else:
            raise ValueError(row_alg)

    return inner


SYLVESTER_ALGORITHMS = ("m1n1", "m1n2", "m2n1", "m2n2",
                        "n1m1", "n1m2", "n2m1", "n2m2")


def sylvester(eng: Engine, A: Matrix, B: Matrix, C: Matrix,
              m: int, n: int, b: int, algorithm: str = "n2m2") -> None:
    """Solve A X + X B = C (A, B upper triangular), X overwrites C (§4.5.3)."""
    outer, inner = algorithm[:2], algorithm[2:]
    if outer.startswith("m"):
        fn = sylv_m1 if outer == "m1" else sylv_m2
        fn(eng, A, B, C, m, n, b, _sylv_row_inner(n, b, inner))
    else:
        fn = sylv_n1 if outer == "n1" else sylv_n2
        fn(eng, A, B, C, m, n, b, _sylv_col_inner(m, b, inner))


# ------------------------------------------------------------ trace entry --

def trace(algorithm: Callable, *args, **kwargs) -> List[KernelCall]:
    """Run an algorithm on a TraceEngine and return its call sequence."""
    eng = TraceEngine()
    algorithm(eng, *args, **kwargs)
    return eng.calls
