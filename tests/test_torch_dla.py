"""The port's dla layer against the JAX package's, on the same inputs.

* every ``KernelDef`` and case: identical numpy operands from one seed,
  results at ``test_dla_blocked.py``'s tolerances (2e-4; 2e-3 for the
  two-sided sygs2 solve, as for sygst there);
* ``TraceEngine`` call sequences identical for every tracer;
* ``ExecEngine`` blocked algorithms against the reference's results.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dla import ExecEngine as RefExec  # noqa: E402
from repro.dla import blocked as ref_blocked  # noqa: E402
from repro.dla import tracers as ref_tracers  # noqa: E402
from repro.dla.kernels import KERNELS as REF_KERNELS  # noqa: E402
from repro_torch.dla import ExecEngine, blocked, tracers  # noqa: E402
from repro_torch.dla.kernels import KERNELS, _rng  # noqa: E402

torch.set_num_threads(1)

N, B = 96, 32

#: small sizes per kernel (size-argument rank from the model domain)
SIZES = {"gemm": (24, 16, 20), "syrk": (24, 16), "syr2k": (24, 16),
         "symm": (24, 16), "trsm": (24, 16), "trmm": (24, 16),
         "potf2": (24,), "trti2": (24,), "lauu2": (24,), "sygs2": (24,),
         "getf2": (32, 16), "geqr2": (32, 16), "trsyl": (16, 12)}
TOL = {"sygs2": 2e-3}

CASES = [(name, case) for name in sorted(KERNELS)
         for case in KERNELS[name].cases]


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def test_registries_match():
    assert sorted(KERNELS) == sorted(REF_KERNELS)
    for name, kd in KERNELS.items():
        ref = REF_KERNELS[name]
        assert kd.cases == ref.cases
        for case in kd.cases:
            assert kd.cost_exponents(case) == ref.cost_exponents(case)
            assert kd.flops(case, SIZES[name]) == ref.flops(case, SIZES[name])


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{n}-{'.'.join(map(str, c))}"
                              for n, c in CASES])
def test_kernel_matches_reference(name, case):
    sizes = SIZES[name]
    ops = KERNELS[name].make_operands(case, sizes, _rng(5))
    ref_ops = REF_KERNELS[name].make_operands(case, sizes, _rng(5))
    for o, r in zip(ops, ref_ops):           # one seed, identical inputs
        np.testing.assert_array_equal(o, np.asarray(r))
    out = _tuple(KERNELS[name].run(case, tuple(torch.from_numpy(o)
                                               for o in ops)))
    ref = _tuple(REF_KERNELS[name].run(case, ref_ops))
    tol = TOL.get(name, 2e-4)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                   rtol=tol, atol=tol)


def test_make_call_runs_on_the_cpu_when_asked():
    call = KERNELS["gemm"].make_call(("N", "N", 1, 1), (16, 16, 16),
                                     device="cpu")
    call()


@pytest.mark.parametrize("n,b", [(264, 56), (100, 32), (64, 64)])
def test_trace_sequences_identical(n, b):
    assert list(tracers.ALL_TRACERS) == list(ref_tracers.ALL_TRACERS)
    for name, tracer in tracers.ALL_TRACERS.items():
        mine = [(c.kernel, c.case, c.sizes) for c in tracer(n, b)]
        ref = [(c.kernel, c.case, c.sizes)
               for c in ref_tracers.ALL_TRACERS[name](n, b)]
        assert mine == ref, name
    assert tracers.required_kernel_cases(n=n, b=b) == \
        ref_tracers.required_kernel_cases(n=n, b=b)


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _lower(rng, n):
    a = np.tril(rng.standard_normal((n, n)))
    np.fill_diagonal(a, np.abs(a.diagonal()) + n)
    return a


def _both(run, mats):
    """Run one blocked algorithm on both engines over the same inputs."""
    out = []
    for eng in (ExecEngine(device="cpu"), RefExec()):
        handles = {k: eng.bind(k, v) for k, v in mats.items()}
        extra = run(eng, handles)
        out.append((eng.mats, extra))
    return out


@pytest.mark.parametrize("variant", [1, 2, 3])
def test_exec_potrf(variant):
    A0 = _spd(np.random.default_rng(variant), N)
    (mine, _), (ref, _) = _both(
        lambda e, h: (blocked if isinstance(e, ExecEngine) else
                      ref_blocked).potrf(e, h["A"], N, B, variant),
        {"A": A0})
    np.testing.assert_allclose(np.tril(mine["A"]), np.tril(ref["A"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.tril(mine["A"]), np.linalg.cholesky(A0),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("variant", list(range(1, 9)))
def test_exec_trtri(variant):
    L0 = _lower(np.random.default_rng(10 + variant), N)
    (mine, _), (ref, _) = _both(
        lambda e, h: (blocked if isinstance(e, ExecEngine) else
                      ref_blocked).trtri(e, h["A"], N, B, variant),
        {"A": L0})
    np.testing.assert_allclose(np.tril(mine["A"]), np.tril(ref["A"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.tril(mine["A"]), np.linalg.inv(L0),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("alg", ["lauum", "sygst", "getrf"])
def test_exec_lapack_blocked(alg):
    rng = np.random.default_rng(20)
    mats = {"A": _lower(rng, N)} if alg == "lauum" else \
        {"A": _spd(rng, N), "L": _lower(rng, N)} if alg == "sygst" else \
        {"A": rng.standard_normal((N, N)) + N * np.eye(N)}

    def run(e, h):
        mod = blocked if isinstance(e, ExecEngine) else ref_blocked
        if alg == "sygst":
            mod.sygst(e, h["A"], h["L"], N, B)
        else:
            getattr(mod, alg)(e, h["A"], N, B)

    (mine, _), (ref, _) = _both(run, mats)
    tol = 2e-3 if alg == "sygst" else 2e-4
    pick = (lambda a: a) if alg == "getrf" else np.tril
    np.testing.assert_allclose(pick(mine["A"]), pick(ref["A"]),
                               rtol=tol, atol=tol)


def test_exec_geqrf():
    m = 128
    M0 = np.random.default_rng(30).standard_normal((m, N))
    (mine, fac), (ref, ref_fac) = _both(
        lambda e, h: (blocked if isinstance(e, ExecEngine) else
                      ref_blocked).geqrf_exec(e, h["A"], m, N, B),
        {"A": M0})
    np.testing.assert_allclose(mine["A"], ref["A"], rtol=1e-4, atol=1e-4)
    for (k, V, T), (rk, rV, rT) in zip(fac, ref_fac):
        assert k == rk
        np.testing.assert_allclose(V, rV, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(T, rT, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("alg", ["n2m2", "m1n1"])
def test_exec_sylvester(alg):
    m, n, b = 32, 48, 16
    rng = np.random.default_rng(40)
    Au = np.triu(rng.standard_normal((m, m))) + m * np.eye(m)
    Bu = np.triu(rng.standard_normal((n, n))) + n * np.eye(n)
    C0 = rng.standard_normal((m, n))

    def run(e, h):
        mod = blocked if isinstance(e, ExecEngine) else ref_blocked
        mod.sylvester(e, h["A"], h["B"], h["C"], m, n, b, algorithm=alg)

    (mine, _), (ref, _) = _both(run, {"A": Au, "B": Bu, "C": C0})
    np.testing.assert_allclose(mine["C"], ref["C"], rtol=2e-4, atol=2e-4)
    X = np.linalg.solve(
        np.kron(np.eye(n), Au) + np.kron(Bu.T, np.eye(m)),
        C0.flatten(order="F")).reshape((m, n), order="F")
    np.testing.assert_allclose(mine["C"], X, rtol=2e-4, atol=2e-4)


def test_exec_engine_needs_a_card_unless_the_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExecEngine()
