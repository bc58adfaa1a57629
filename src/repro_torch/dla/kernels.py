"""Dense linear algebra kernels (the BLAS/unblocked-LAPACK layer) in PyTorch.

Every kernel is exposed through a uniform :class:`KernelDef` so that the
performance-model generator (``repro_torch.core.modelgen``), the
blocked-algorithm tracers (``repro_torch.dla.tracers``) and the execution
engine all speak the same vocabulary: ``(kernel name, case, sizes)``.

Cases encode the paper's *flag arguments* (§3.1.1): transpositions, side,
uplo, unit-diagonal.  Scalar arguments are restricted to the special values
the paper identifies ({-1, 0, 1, other}, §3.1.2) and are part of the case.

These are library calls — cuBLAS and cuSOLVER through torch on the card —
which is what the paper measures.  Operands are float32 (the reference's
working type).  Two kernels are loops by contract: ``getf2`` is an
*unpivoted* column elimination (``torch.linalg.lu_factor`` pivots) and
``trsyl`` a column back-substitution.  ``potf2`` uses ``cholesky_ex``,
which neither raises on a matrix that is not positive definite nor adds
a host sync for that check.

Each kernel carries its minimal FLOP count and the maximal monomial exponents
it implies for the polynomial basis (§3.2.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

Case = Tuple
Sizes = Tuple[int, ...]

_DTYPE = np.float32  # the reference's working type


# ----------------------------------------------------------------- helpers --

def _rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def _rand(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(_DTYPE)


def _spd(rng, n) -> np.ndarray:
    a = rng.standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(_DTYPE)


def _lower_nonsing(rng, n) -> np.ndarray:
    a = np.tril(rng.standard_normal((n, n)))
    np.fill_diagonal(a, np.abs(a.diagonal()) + n)
    return a.astype(_DTYPE)


def _solve_tri(A, B, *, side: str, uplo: str, transA: str = "N",
               diag: str = "N"):
    """op(A) X = B (side L) or X op(A) = B (side R), triangle of A only.

    ``op(A) = A^T`` is passed as ``A.mT``, whose stored triangle is the
    opposite one: a lower A transposed is upper.
    """
    t = transA == "T"
    return torch.linalg.solve_triangular(
        A.mT if t else A, B, upper=(uplo == "U") != t, left=(side == "L"),
        unitriangular=(diag == "U"))


# ------------------------------------------------------------- level 3 ops --

def _gemm(case, A, B, C):
    transA, transB, alpha, beta = case
    a = A.mT if transA == "T" else A
    b = B.mT if transB == "T" else B
    return float(beta) * C + float(alpha) * (a @ b)


def _syrk(case, A, C):
    # C := beta C + alpha A A^T (trans=N) or beta C + alpha A^T A (trans=T)
    _, trans, alpha, beta = case
    aat = A @ A.mT if trans == "N" else A.mT @ A
    return float(beta) * C + float(alpha) * aat


def _syr2k(case, A, B, C):
    _, trans, alpha, beta = case
    if trans == "N":
        upd = A @ B.mT + B @ A.mT
    else:
        upd = A.mT @ B + B.mT @ A
    return float(beta) * C + float(alpha) * upd


def _symm(case, A, B, C):
    side, uplo, alpha, beta = case
    sym = torch.tril(A) + torch.tril(A, -1).mT if uplo == "L" else \
        torch.triu(A) + torch.triu(A, 1).mT
    prod = sym @ B if side == "L" else B @ sym
    return float(beta) * C + float(alpha) * prod


def _trsm(case, A, B):
    side, uplo, transA, diag, alpha = case
    return float(alpha) * _solve_tri(A, B, side=side, uplo=uplo,
                                     transA=transA, diag=diag)


def _trmm(case, A, B):
    side, uplo, transA, diag, alpha = case
    tri = torch.tril(A) if uplo == "L" else torch.triu(A)
    if diag == "U":
        tri = tri - torch.diag(torch.diag(tri)) + torch.eye(
            tri.shape[0], dtype=tri.dtype, device=tri.device)
    t = tri.mT if transA == "T" else tri
    return float(alpha) * (t @ B) if side == "L" else float(alpha) * (B @ t)


# ---------------------------------------------------- unblocked LAPACK ops --

def _potf2(A):
    """Unblocked lower Cholesky (the dpotf2 analogue)."""
    return torch.linalg.cholesky_ex(A).L


def _trti2(A):
    """Unblocked lower-triangular inversion via solve against identity."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return _solve_tri(A, eye, side="L", uplo="L")


def _lauu2(A):
    """A := L^T L for lower-triangular L stored in A (dlauu2, lower)."""
    L = torch.tril(A)
    return L.mT @ L


def _sygs2(A, L):
    """A := L^{-1} A L^{-T} (dsygs2 itype=1, lower)."""
    t = _solve_tri(L, A, side="L", uplo="L")
    return _solve_tri(L, t.mT, side="L", uplo="L").mT


def _getf2_nopiv(A):
    """Unblocked LU without pivoting of an m x nb panel (m >= nb)."""
    a = A.clone()
    m, nb = a.shape
    for k in range(min(m, nb)):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= torch.outer(a[k + 1:, k], a[k, k + 1:])
    return a


def _geqr2(A):
    """Unblocked QR panel: returns (Q, R) of the reduced factorization."""
    return tuple(torch.linalg.qr(A, mode="reduced"))


def _trsyl(A, B, C):
    """Unblocked triangular Sylvester solve A X + X B = C.

    A (m x m) and B (n x n) upper triangular.  Column-by-column
    back-substitution: (A + b_jj I) x_j = c_j - X[:, :j] B[:j, j].
    """
    m, n = C.shape
    eye = torch.eye(m, dtype=C.dtype, device=C.device)
    X = torch.zeros_like(C)
    for j in range(n):
        rhs = C[:, j:j + 1] - X[:, :j] @ B[:j, j:j + 1]
        X[:, j:j + 1] = _solve_tri(A + B[j, j] * eye, rhs, side="L",
                                   uplo="U")
    return X


# ------------------------------------------------------------- kernel defs --

@dataclass(frozen=True)
class KernelDef:
    name: str
    cases: Tuple[Case, ...]
    #: minimal FLOP count as a function of (case, sizes)
    flops: Callable[[Case, Sizes], float]
    #: maximal monomial exponents for the model basis
    cost_exponents: Callable[[Case], Sequence[Tuple[int, ...]]]
    #: build host (numpy float32) operands for a concrete invocation
    make_operands: Callable[[Case, Sizes, np.random.Generator], Tuple]
    #: execute one invocation on tensors (returns tensor or tuple of them)
    run: Callable[[Case, Tuple], object]

    def make_call(self, case: Case, sizes: Sizes, seed: int = 0,
                  device: DeviceLike = None) -> Callable[[], None]:
        """Zero-arg synchronous callable for the model generator.

        The timed call includes the host->device operand copy and the
        device->host result fetch, because that is exactly what the
        blocked algorithms' ExecEngine does per kernel invocation — the
        paper's principle of modeling the call as the algorithm makes it
        (§3.2.3).  The blocking D2H ``.cpu()`` at the end is also the
        device sync that makes the host clock around the call valid.
        """
        dev = resolve_device(device)
        ops_np = self.make_operands(case, sizes, _rng(seed))

        def call():
            out = self.run(case, tuple(torch.from_numpy(o).to(dev)
                                       for o in ops_np))
            for t in (out if isinstance(out, tuple) else (out,)):
                t.cpu()

        return call


def _gemm_flops(case, sizes):
    m, n, k = sizes
    return 2.0 * m * n * k


def _trsm_flops(case, sizes):
    side = case[0]
    m, n = sizes
    return float(m * m * n) if side == "L" else float(m * n * n)


KERNELS: Dict[str, KernelDef] = {}


def _register(kd: KernelDef):
    KERNELS[kd.name] = kd
    return kd


GEMM = _register(KernelDef(
    name="gemm",
    cases=(("N", "N", 1, 1), ("N", "T", -1, 1), ("T", "N", -1, 1),
           ("N", "N", -1, 1), ("T", "N", 1, 1), ("N", "T", 1, 1),
           ("N", "N", 1, 0), ("N", "N", -1, 0), ("T", "N", 1, 0)),
    flops=_gemm_flops,
    cost_exponents=lambda case: [(1, 1, 1)],
    make_operands=lambda case, s, rng: (
        _rand(rng, *((s[0], s[2]) if case[0] == "N" else (s[2], s[0]))),
        _rand(rng, *((s[2], s[1]) if case[1] == "N" else (s[1], s[2]))),
        _rand(rng, s[0], s[1]),
    ),
    run=lambda case, ops: _gemm(case, *ops),
))

SYRK = _register(KernelDef(
    name="syrk",
    cases=(("L", "N", -1, 1), ("L", "T", -1, 1), ("L", "T", 1, 1)),
    flops=lambda case, s: float(s[0] * s[0] * s[1]),  # n^2 k
    cost_exponents=lambda case: [(2, 1)],
    make_operands=lambda case, s, rng: (
        _rand(rng, *((s[0], s[1]) if case[1] == "N" else (s[1], s[0]))),
        _rand(rng, s[0], s[0]),
    ),
    run=lambda case, ops: _syrk(case, *ops),
))

SYR2K = _register(KernelDef(
    name="syr2k",
    cases=(("L", "N", -1, 1),),
    flops=lambda case, s: float(2 * s[0] * s[0] * s[1]),
    cost_exponents=lambda case: [(2, 1)],
    make_operands=lambda case, s, rng: (
        _rand(rng, s[0], s[1]), _rand(rng, s[0], s[1]),
        _rand(rng, s[0], s[0]),
    ),
    run=lambda case, ops: _syr2k(case, *ops),
))

SYMM = _register(KernelDef(
    name="symm",
    cases=(("R", "L", -0.5, 1), ("L", "L", 1, 0)),
    flops=lambda case, s: float(2 * s[0] * s[1] *
                                (s[1] if case[0] == "R" else s[0])),
    cost_exponents=lambda case: [(1, 2)] if case[0] == "R" else [(2, 1)],
    make_operands=lambda case, s, rng: (
        _rand(rng, *((s[1], s[1]) if case[0] == "R" else (s[0], s[0]))),
        _rand(rng, s[0], s[1]),
        _rand(rng, s[0], s[1]),
    ),
    run=lambda case, ops: _symm(case, *ops),
))

TRSM = _register(KernelDef(
    name="trsm",
    cases=(("L", "L", "N", "N", 1), ("L", "L", "N", "N", -1),
           ("R", "L", "T", "N", 1), ("R", "L", "N", "N", -1),
           ("L", "L", "N", "U", 1), ("L", "U", "N", "N", 1)),
    flops=_trsm_flops,
    cost_exponents=lambda case: [(2, 1)] if case[0] == "L" else [(1, 2)],
    make_operands=lambda case, s, rng: (
        _lower_nonsing(rng, s[0] if case[0] == "L" else s[1]).T.copy()
        if case[1] == "U" else
        _lower_nonsing(rng, s[0] if case[0] == "L" else s[1]),
        _rand(rng, s[0], s[1]),
    ),
    run=lambda case, ops: _trsm(case, *ops),
))

TRMM = _register(KernelDef(
    name="trmm",
    cases=(("R", "L", "N", "N", 1), ("L", "L", "T", "N", 1),
           ("L", "L", "N", "N", 1), ("L", "L", "N", "U", 1),
           ("R", "L", "N", "N", -1), ("L", "L", "N", "N", -1),
           ("L", "U", "T", "N", 1)),
    flops=lambda case, s: float(s[0] ** 2 * s[1]) if case[0] == "L"
    else float(s[0] * s[1] ** 2),
    cost_exponents=lambda case: [(2, 1)] if case[0] == "L" else [(1, 2)],
    make_operands=lambda case, s, rng: (
        _lower_nonsing(rng, s[0] if case[0] == "L" else s[1]),
        _rand(rng, s[0], s[1]),
    ),
    run=lambda case, ops: _trmm(case, *ops),
))

POTF2 = _register(KernelDef(
    name="potf2",
    cases=(("L",),),
    flops=lambda case, s: s[0] ** 3 / 3.0,
    cost_exponents=lambda case: [(3,)],
    make_operands=lambda case, s, rng: (_spd(rng, s[0]),),
    run=lambda case, ops: _potf2(*ops),
))

TRTI2 = _register(KernelDef(
    name="trti2",
    cases=(("L", "N"),),
    flops=lambda case, s: s[0] ** 3 / 3.0,
    cost_exponents=lambda case: [(3,)],
    make_operands=lambda case, s, rng: (_lower_nonsing(rng, s[0]),),
    run=lambda case, ops: _trti2(*ops),
))

LAUU2 = _register(KernelDef(
    name="lauu2",
    cases=(("L",),),
    flops=lambda case, s: s[0] ** 3 / 3.0,
    cost_exponents=lambda case: [(3,)],
    make_operands=lambda case, s, rng: (_lower_nonsing(rng, s[0]),),
    run=lambda case, ops: _lauu2(*ops),
))

SYGS2 = _register(KernelDef(
    name="sygs2",
    cases=((1, "L"),),
    flops=lambda case, s: 2.0 * s[0] ** 3,
    cost_exponents=lambda case: [(3,)],
    make_operands=lambda case, s, rng: (_spd(rng, s[0]),
                                        _lower_nonsing(rng, s[0])),
    run=lambda case, ops: _sygs2(*ops),
))

GETF2 = _register(KernelDef(
    name="getf2",
    cases=(("NP",),),  # non-pivoted panel
    flops=lambda case, s: float(s[0] * s[1] ** 2 - s[1] ** 3 / 3.0),
    cost_exponents=lambda case: [(1, 2), (0, 3)],
    make_operands=lambda case, s, rng: (
        (rng.standard_normal((s[0], s[1])) +
         np.eye(s[0], s[1]) * s[0]).astype(_DTYPE),),
    run=lambda case, ops: _getf2_nopiv(ops[0]),
))

GEQR2 = _register(KernelDef(
    name="geqr2",
    cases=(("N",),),
    flops=lambda case, s: float(2 * s[0] * s[1] ** 2),
    cost_exponents=lambda case: [(1, 2)],
    make_operands=lambda case, s, rng: (_rand(rng, s[0], s[1]),),
    run=lambda case, ops: _geqr2(*ops),
))

TRSYL = _register(KernelDef(
    name="trsyl",
    cases=(("N", "N", 1),),
    flops=lambda case, s: float(s[0] ** 2 * s[1] + s[0] * s[1] ** 2),
    cost_exponents=lambda case: [(2, 1), (1, 2)],
    make_operands=lambda case, s, rng: (
        (np.triu(rng.standard_normal((s[0], s[0]))) +
         np.eye(s[0]) * s[0]).astype(_DTYPE),
        (np.triu(rng.standard_normal((s[1], s[1]))) +
         np.eye(s[1]) * s[1]).astype(_DTYPE),
        _rand(rng, s[0], s[1]),
    ),
    run=lambda case, ops: _trsyl(*ops),
))


def kernel_flops(name: str, case: Case, sizes: Sizes) -> float:
    return KERNELS[name].flops(tuple(case), tuple(sizes))
