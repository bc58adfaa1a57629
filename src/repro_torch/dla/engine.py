"""Execution and tracing engines for blocked algorithms.

A blocked algorithm is written ONCE against the :class:`Engine` interface and
then either

* **executed** (:class:`ExecEngine`) — sub-matrix views of numpy-backed
  host storage are copied to the device, pushed through the torch kernels
  of ``repro_torch.dla.kernels`` and copied back (the "LAPACK calling
  BLAS" structure; host round-trips are part of the call, and the model
  generator times kernels the same way so predictions and executions see
  identical per-call overhead), or
* **traced** (:class:`TraceEngine`) — only the ``(kernel, case, sizes)``
  sequence is recorded, *without any execution*.  This is what the paper's
  predictions consume (§4.1): the call sequence is fully determined by the
  problem size and block size.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device, to_numpy
from ..core.predict import CompiledCalls, KernelCall, compile_calls
from . import kernels as K


@dataclass(frozen=True)
class View:
    """A rectangular sub-matrix view: (matrix key, row range, col range)."""

    mat: str
    r0: int
    r1: int
    c0: int
    c1: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.r1 - self.r0, self.c1 - self.c0)

    @property
    def rows(self) -> int:
        return self.r1 - self.r0

    @property
    def cols(self) -> int:
        return self.c1 - self.c0


class Matrix:
    """Handle for a matrix participating in a blocked algorithm."""

    def __init__(self, key: str, n_rows: int, n_cols: int):
        self.key = key
        self.n_rows = n_rows
        self.n_cols = n_cols

    def v(self, r0: int, r1: int, c0: int, c1: int) -> View:
        assert 0 <= r0 <= r1 <= self.n_rows, (r0, r1, self.n_rows)
        assert 0 <= c0 <= c1 <= self.n_cols, (c0, c1, self.n_cols)
        return View(self.key, r0, r1, c0, c1)

    def full(self) -> View:
        return self.v(0, self.n_rows, 0, self.n_cols)


class Engine:
    """Kernel-call interface shared by execution and tracing."""

    # level 3
    def gemm(self, transA, transB, alpha, beta, A: View, B: View, C: View):
        raise NotImplementedError

    def syrk(self, uplo, trans, alpha, beta, A: View, C: View):
        raise NotImplementedError

    def syr2k(self, uplo, trans, alpha, beta, A: View, B: View, C: View):
        raise NotImplementedError

    def symm(self, side, uplo, alpha, beta, A: View, B: View, C: View):
        raise NotImplementedError

    def trsm(self, side, uplo, transA, diag, alpha, A: View, B: View):
        raise NotImplementedError

    def trmm(self, side, uplo, transA, diag, alpha, A: View, B: View):
        raise NotImplementedError

    # unblocked LAPACK
    def potf2(self, uplo, A: View):
        raise NotImplementedError

    def trti2(self, uplo, diag, A: View):
        raise NotImplementedError

    def lauu2(self, uplo, A: View):
        raise NotImplementedError

    def sygs2(self, itype, uplo, A: View, L: View):
        raise NotImplementedError

    def getf2(self, A: View):
        raise NotImplementedError

    def geqr2(self, A: View):
        raise NotImplementedError

    def trsyl(self, transA, transB, sgn, A: View, B: View, C: View):
        raise NotImplementedError


class TraceEngine(Engine):
    """Records the kernel-call sequence without executing (paper §4.1)."""

    def __init__(self):
        self.calls: List[KernelCall] = []

    def _rec(self, kernel: str, case: Tuple, sizes: Tuple[int, ...]):
        # degenerate (zero-size) calls are kept: the models estimate them as
        # 0 s, mirroring Example 4.1's zero-width panels
        self.calls.append(KernelCall(kernel, case, sizes))

    def gemm(self, tA, tB, a, b, A, B, C):
        m, n = C.shape
        k = A.cols if tA == "N" else A.rows
        self._rec("gemm", (tA, tB, a, b), (m, n, k))

    def syrk(self, uplo, trans, a, b, A, C):
        n = C.rows
        k = A.cols if trans == "N" else A.rows
        self._rec("syrk", (uplo, trans, a, b), (n, k))

    def syr2k(self, uplo, trans, a, b, A, B, C):
        n = C.rows
        k = A.cols if trans == "N" else A.rows
        self._rec("syr2k", (uplo, trans, a, b), (n, k))

    def symm(self, side, uplo, a, b, A, B, C):
        self._rec("symm", (side, uplo, a, b), C.shape)

    def trsm(self, side, uplo, tA, diag, a, A, B):
        self._rec("trsm", (side, uplo, tA, diag, a), B.shape)

    def trmm(self, side, uplo, tA, diag, a, A, B):
        self._rec("trmm", (side, uplo, tA, diag, a), B.shape)

    def potf2(self, uplo, A):
        self._rec("potf2", (uplo,), (A.rows,))

    def trti2(self, uplo, diag, A):
        self._rec("trti2", (uplo, diag), (A.rows,))

    def lauu2(self, uplo, A):
        self._rec("lauu2", (uplo,), (A.rows,))

    def sygs2(self, itype, uplo, A, L):
        self._rec("sygs2", (itype, uplo), (A.rows,))

    def getf2(self, A):
        self._rec("getf2", ("NP",), A.shape)

    def geqr2(self, A):
        self._rec("geqr2", ("N",), A.shape)

    def trsyl(self, tA, tB, sgn, A, B, C):
        self._rec("trsyl", (tA, tB, sgn), C.shape)

    def compile(self) -> CompiledCalls:
        """Compile the recorded sequence into per-(kernel, case) size
        matrices — the form the batched :class:`PredictionEngine` consumes."""
        return compile_calls([self.calls])


def trace_calls(fn: Callable[["Engine"], None]) -> List[KernelCall]:
    """Trace one blocked-algorithm execution into its kernel-call sequence."""
    eng = TraceEngine()
    fn(eng)
    return eng.calls


def compile_traces(fns: Sequence[Callable[["Engine"], None]],
                   ) -> CompiledCalls:
    """Trace a whole batch of algorithm builders and compile them into one
    reusable per-(kernel, case) batch — the artifact
    :meth:`repro_torch.core.predict.PredictionEngine.predict_compiled`
    consumes."""
    return compile_calls([trace_calls(fn) for fn in fns])


class ExecEngine(Engine):
    """Executes blocked algorithms on numpy host storage via torch kernels.

    Every kernel call copies its operand views host->device (pageable
    memory), runs on ``device`` (the CUDA card unless the CPU is asked
    for) and copies the result back, exactly like the timed calls the
    models are generated from (:meth:`~repro_torch.dla.kernels.KernelDef.
    make_call`).
    """

    def __init__(self, mats: Optional[Dict[str, np.ndarray]] = None, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.mats: Dict[str, np.ndarray] = dict(mats or {})
        # QR panels store reflector blocks out-of-place
        self.q_panels: Dict[Tuple, np.ndarray] = {}

    # -------------------------------------------------------------- store --
    def bind(self, key: str, array: np.ndarray) -> Matrix:
        arr = np.array(array, dtype=np.float32, copy=True)
        self.mats[key] = arr
        return Matrix(key, arr.shape[0], arr.shape[1])

    def get(self, v: View) -> np.ndarray:
        return self.mats[v.mat][v.r0:v.r1, v.c0:v.c1]

    def put(self, v: View, value) -> None:
        if isinstance(value, torch.Tensor):
            value = to_numpy(value)      # the blocking D2H of the result
        self.mats[v.mat][v.r0:v.r1, v.c0:v.c1] = value

    @staticmethod
    def _skip(*views: View) -> bool:
        return any(0 in v.shape for v in views)

    def _run(self, name: str, case: Tuple, *ops: np.ndarray):
        return K.KERNELS[name].run(case, tuple(
            torch.from_numpy(o).to(self.device) for o in ops))

    # ------------------------------------------------------------ level 3 --
    def gemm(self, tA, tB, a, b, A, B, C):
        if self._skip(C) or (A.cols if tA == "N" else A.rows) == 0:
            return
        out = self._run("gemm", (tA, tB, a, b),
                        self.get(A), self.get(B), self.get(C))
        self.put(C, out)

    def syrk(self, uplo, trans, a, b, A, C):
        if self._skip(C) or (A.cols if trans == "N" else A.rows) == 0:
            return
        self.put(C, self._run("syrk", (uplo, trans, a, b),
                              self.get(A), self.get(C)))

    def syr2k(self, uplo, trans, a, b, A, B, C):
        if self._skip(C) or (A.cols if trans == "N" else A.rows) == 0:
            return
        self.put(C, self._run("syr2k", (uplo, trans, a, b),
                              self.get(A), self.get(B), self.get(C)))

    def symm(self, side, uplo, a, b, A, B, C):
        if self._skip(C, A):
            return
        self.put(C, self._run("symm", (side, uplo, a, b),
                              self.get(A), self.get(B), self.get(C)))

    def trsm(self, side, uplo, tA, diag, a, A, B):
        if self._skip(B):
            return
        self.put(B, self._run("trsm", (side, uplo, tA, diag, a),
                              self.get(A), self.get(B)))

    def trmm(self, side, uplo, tA, diag, a, A, B):
        if self._skip(B):
            return
        self.put(B, self._run("trmm", (side, uplo, tA, diag, a),
                              self.get(A), self.get(B)))

    # -------------------------------------------------- unblocked kernels --
    def potf2(self, uplo, A):
        if self._skip(A):
            return
        self.put(A, self._run("potf2", (uplo,), self.get(A)))

    def trti2(self, uplo, diag, A):
        if self._skip(A):
            return
        self.put(A, self._run("trti2", (uplo, diag), self.get(A)))

    def lauu2(self, uplo, A):
        if self._skip(A):
            return
        self.put(A, self._run("lauu2", (uplo,), self.get(A)))

    def sygs2(self, itype, uplo, A, L):
        if self._skip(A):
            return
        self.put(A, self._run("sygs2", (itype, uplo),
                              self.get(A), self.get(L)))

    def getf2(self, A):
        if self._skip(A):
            return
        self.put(A, self._run("getf2", ("NP",), self.get(A)))

    def geqr2(self, A):
        if self._skip(A):
            return
        q, r = self._run("geqr2", ("N",), self.get(A))
        self.q_panels[(A.mat, A.r0, A.c0)] = to_numpy(q)
        m, nb = A.shape
        out = np.zeros((m, nb), dtype=np.float32)
        out[:nb, :nb] = np.triu(to_numpy(r))
        self.put(A, out)

    def trsyl(self, tA, tB, sgn, A, B, C):
        if self._skip(C):
            return
        self.put(C, self._run("trsyl", (tA, tB, sgn),
                              self.get(A), self.get(B), self.get(C)))
