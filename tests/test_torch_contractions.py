"""The Ch. 6 contraction layer of the port against the JAX package.

``repro_torch.core.contractions`` (and the cache study) hold the §6.1
enumeration, the §6.2.3 access distances and cold pools, and the loop-nest
execution on the device.  Here, on the CPU (``device="cpu"``), the
enumerations, canonical equations, distances and pool sizes must be
identical to the reference's, and ``execute`` must agree with the
reference's ``execute`` (jax on the CPU) and with ``np.einsum`` at
rtol = atol = 2e-4, the reference tests' tolerance.  Inputs come from
``numpy.random.default_rng``.  Tests marked ``cuda`` need the card and
skip here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cachestudy as ref_cachestudy  # noqa: E402
from repro.core import contractions as ref  # noqa: E402
from repro.tc import generate_algorithms as ref_generate  # noqa: E402
from repro_torch.core import cachestudy, contractions  # noqa: E402
from repro_torch.core.contractions import (ContractionAlgorithm,  # noqa: E402
                                           ContractionSpec, access_distance,
                                           canonical_equation,
                                           cold_pool_size, execute,
                                           execute_reference, kernel_call,
                                           l2_cache_bytes,
                                           measure_contraction,
                                           predict_contraction,
                                           rank_contraction_algorithms,
                                           run_kernel_benchmark)
from repro_torch.tc import generate_algorithms  # noqa: E402

torch.set_num_threads(1)

CACHE = 32 * 2 ** 20
TOL = dict(rtol=2e-4, atol=2e-4)
#: every spec the reference's test_contractions.py, test_tc.py and
#: test_parametric.py enumerate, at the sizes they use
SPECS = [
    ("abc=ai,ibc", dict(a=24, b=20, c=16, i=8)),
    ("a=iaj,ji", dict(a=16, i=8, j=12)),
    ("abc=ija,jbic", dict(a=8, b=8, c=8, i=6, j=6)),
    ("bij,bjk->bik", dict(b=4, i=16, j=16, k=16)),
    ("ab=ai,ib", dict(a=10, b=7, i=4)),
    ("abc,cd->abd", dict(a=3, b=4, c=5, d=6)),
    ("ij,jk->ik", dict(i=8, j=8, k=8)),
    ("ik,kl->il", dict(i=8, k=8, l=8)),
    ("ai,ibc->abc", dict(a=48, b=48, c=48, i=8)),
]
#: tiny sizes at which every algorithm of a spec executes through both
#: packages (the reference dispatches one jitted call per iteration)
TINY = {
    "abc=ai,ibc": dict(a=5, b=4, c=3, i=3),
    "a=iaj,ji": dict(a=6, i=3, j=4),
    "abc=ija,jbic": dict(a=3, b=3, c=2, i=2, j=3),
    "bij,bjk->bik": dict(b=3, i=4, j=5, k=3),
    "abc,cd->abd": dict(a=3, b=4, c=5, d=3),
}


def _operands(spec, sizes, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal([sizes[i] for i in spec.a_idx]
                            ).astype(np.float32)
    B = rng.standard_normal([sizes[i] for i in spec.b_idx]
                            ).astype(np.float32)
    return A, B


def _signature(algs):
    return [(a.kernel, a.kernel_dims, a.loop_order, a.kernel_equation())
            for a in algs]


# ------------------------------------------------------------ enumeration --

@pytest.mark.parametrize("expr,sizes", SPECS)
def test_enumerations_are_identical(expr, sizes):
    spec = ContractionSpec.parse(expr)
    rspec = ref.ContractionSpec.parse(expr)
    assert (spec.a_idx, spec.b_idx, spec.out_idx, spec.contracted,
            spec.batch, spec.all_indices) == \
        (rspec.a_idx, rspec.b_idx, rspec.out_idx, rspec.contracted,
         rspec.batch, rspec.all_indices)
    assert spec.flops(sizes) == rspec.flops(sizes)
    # the core §6.1 loop-only generator and the batched superset
    assert _signature(contractions.generate_algorithms(spec)) == \
        _signature(ref.generate_algorithms(rspec))
    mine, theirs = generate_algorithms(spec), ref_generate(rspec)
    assert _signature(mine) == _signature(theirs)
    for a, r in zip(mine, theirs):
        assert a.name == r.name
        assert a.n_iterations(sizes) == r.n_iterations(sizes)
        assert a.kernel_shapes(sizes) == r.kernel_shapes(sizes)
        assert a.kernel_flops(sizes) == r.kernel_flops(sizes)
        # §6.2.3 access distances, loop-less algorithms included
        assert access_distance(a, sizes) == \
            ref.access_distance(r, sizes)
        assert canonical_equation(a.kernel_equation()) == \
            ref.canonical_equation(r.kernel_equation())


def test_paper_example_has_36_algorithms():
    spec = ContractionSpec.parse("abc=ai,ibc")
    algs = contractions.generate_algorithms(spec)
    assert len(algs) == 36
    assert len([a for a in algs if a.kernel == "gemm"]) == 2


@pytest.mark.parametrize("equation", [
    "ik,kl->il", "ij,jk->ik", "bij,bjk->bik", "a,b->ab", "ai,ib->ab",
    "ija,jbic->abc", "i,i->", "zyx,xw->zyw"])
def test_canonical_equation_is_identical(equation):
    assert canonical_equation(equation) == ref.canonical_equation(equation)


def test_access_distance_of_hand_built_loop_nests():
    spec = ContractionSpec.parse("ab=ai,ib")
    rspec = ref.ContractionSpec.parse("ab=ai,ib")
    sizes = dict(a=10, b=7, i=4)
    for kernel, kdims, loops in [("dot", ("i",), ("a", "b")),
                                 ("axpy_a", ("a",), ("b", "i")),
                                 ("gemm", ("a", "b", "i"), ())]:
        mine = ContractionAlgorithm(spec, kernel, kdims, loops)
        theirs = ref.ContractionAlgorithm(rspec, kernel, kdims, loops)
        assert access_distance(mine, sizes) == \
            ref.access_distance(theirs, sizes)
    dot = ContractionAlgorithm(spec, "dot", ("i",), ("a", "b"))
    assert access_distance(dot, sizes)["A"] == 4 * (4 + 4 + 1) * 7


@pytest.mark.parametrize("reps,call_bytes,cache", [
    (32, 4 * 9, CACHE), (32, CACHE // 2, CACHE), (20, 1024, CACHE),
    (5, 1024, CACHE), (100, 16 * 2 ** 20, CACHE), (1, 64, CACHE),
    (40, 3 * 2 ** 28, 50 * 2 ** 20), (40, 12 * 2 ** 20, 50 * 2 ** 20)])
def test_cold_pool_size_is_identical(reps, call_bytes, cache):
    assert cold_pool_size(reps, call_bytes, cache) == \
        ref.cold_pool_size(reps, call_bytes, cache)


# -------------------------------------------------------------- execution --

@pytest.mark.parametrize("expr", sorted(TINY))
def test_execute_matches_reference_and_einsum(expr):
    sizes = TINY[expr]
    spec = ContractionSpec.parse(expr)
    rspec = ref.ContractionSpec.parse(expr)
    A, B = _operands(spec, sizes)
    want = np.einsum(spec.einsum_expr(), A, B)
    np.testing.assert_allclose(
        execute_reference(spec, A, B, device="cpu").numpy(), want, **TOL)
    for alg, ralg in zip(generate_algorithms(spec), ref_generate(rspec)):
        got = execute(alg, A, B, sizes, device="cpu")
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, err_msg=alg.name,
                                   **TOL)
        np.testing.assert_allclose(got.numpy(),
                                   ref.execute(ralg, A, B, sizes),
                                   err_msg=alg.name, **TOL)


@pytest.mark.parametrize("expr,sizes", [SPECS[0], SPECS[3]])
def test_execute_at_reference_sizes(expr, sizes):
    """The reference tests' own sizes (24-wide, i = 8; b = 4, 16-wide),
    every third algorithm as there, against np.einsum."""
    spec = ContractionSpec.parse(expr)
    A, B = _operands(spec, sizes)
    want = np.einsum(spec.einsum_expr(), A, B)
    for alg in generate_algorithms(spec)[::3]:
        np.testing.assert_allclose(
            execute(alg, A, B, sizes, device="cpu").numpy(), want,
            err_msg=alg.name, **TOL)


def test_execute_and_benchmark_run_the_same_kernel_call(monkeypatch):
    """One function is the kernel call of both the loop nest and the
    micro-benchmark: n_iterations calls per execution, and one untimed
    set-up call, one overhead call and repetitions x burst timed calls
    per benchmark."""
    calls = []
    real = contractions.kernel_call

    def counting(eq, a, b, out):
        calls.append((eq, tuple(a.shape), tuple(b.shape), tuple(out.shape)))
        real(eq, a, b, out)

    monkeypatch.setattr(contractions, "kernel_call", counting)
    spec = ContractionSpec.parse("abc=ai,ibc")
    sizes = TINY["abc=ai,ibc"]
    alg = next(a for a in contractions.generate_algorithms(spec)
               if a.kernel == "gemm")
    A, B = _operands(spec, sizes)
    execute(alg, A, B, sizes, device="cpu")
    executed = list(calls)
    assert len(executed) == alg.n_iterations(sizes)
    del calls[:]
    a_sh, b_sh, o_sh = alg.kernel_shapes(sizes)
    run_kernel_benchmark(alg.kernel_equation(), a_sh, b_sh, o_sh,
                         cold_a=True, cold_b=False, repetitions=3,
                         cache_bytes=CACHE, device="cpu")
    assert len(calls) == 2 + 3 * contractions.BURST
    assert set(calls) == {executed[0]}


@pytest.mark.parametrize("expr", sorted(TINY))
def test_execute_hands_the_kernel_call_contiguous_blocks(expr,
                                                         monkeypatch):
    """Every iteration's A, B and C operands are contiguous, as the
    benchmark's buffers are, whatever the loop order."""
    real = contractions.kernel_call

    def checking(eq, a, b, out):
        assert a.is_contiguous() and b.is_contiguous() and \
            out.is_contiguous(), (eq, a.stride(), b.stride(), out.stride())
        real(eq, a, b, out)

    monkeypatch.setattr(contractions, "kernel_call", checking)
    spec = ContractionSpec.parse(expr)
    sizes = TINY[expr]
    A, B = _operands(spec, sizes)
    want = np.einsum(spec.einsum_expr(), A, B)
    for alg in generate_algorithms(spec):
        got = execute(alg, A, B, sizes, device="cpu")
        assert got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, err_msg=alg.name,
                                   **TOL)


def test_kernel_call_accumulates_into_a_slice():
    C = torch.zeros(3, 4, 2)
    a, b = torch.ones(3, 5), torch.ones(5, 4)
    kernel_call("ab,bc->ac", a, b, C[:, :, 1])
    kernel_call("ab,bc->ac", a, b, C[:, :, 1])
    assert torch.all(C[:, :, 1] == 10) and torch.all(C[:, :, 0] == 0)


# ------------------------------------------------------------ measurement --

def test_cache_capacity_is_never_a_cpu_guess():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the L2 read succeeds")
    with pytest.raises(ValueError, match="cache_bytes"):
        l2_cache_bytes("cpu")
    with pytest.raises(ValueError, match="cache_bytes"):
        run_kernel_benchmark("ab,bc->ac", (4, 4), (4, 4), (4, 4),
                             cold_a=False, cold_b=False, repetitions=2,
                             device="cpu")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            l2_cache_bytes(device)
        with pytest.raises(RuntimeError, match="CUDA"):
            execute(ContractionAlgorithm(ContractionSpec.parse("ab=ai,ib"),
                                         "gemm", ("a", "b", "i"), ()),
                    np.ones((2, 2), np.float32), np.ones((2, 2), np.float32),
                    dict(a=2, b=2, i=2), device=device)


def test_predict_contraction_breakdown_on_cpu():
    spec = ContractionSpec.parse("ab=ai,ib")
    sizes = dict(a=4, b=4, i=4)
    alg = ContractionAlgorithm(spec, "ger", ("a", "b"), ("i",))
    bd = predict_contraction(alg, sizes, repetitions=2, breakdown=True,
                             cache_bytes=CACHE, device="cpu")
    assert set(bd) == {"total_s", "first_call_s", "loop_s", "per_call_s",
                       "n_iterations"}
    assert bd["n_iterations"] == 4
    assert bd["per_call_s"] > 0 and bd["first_call_s"] >= 0
    assert bd["total_s"] == pytest.approx(
        bd["first_call_s"] + bd["per_call_s"] * bd["n_iterations"])


def test_scalar_oracle_ranks_every_candidate_on_cpu():
    spec = ContractionSpec.parse("ab=ai,ib")
    sizes = dict(a=4, b=4, i=4)
    algs = contractions.generate_algorithms(spec)[:4]
    ranked = rank_contraction_algorithms(spec, sizes, algorithms=algs,
                                         batched=False, repetitions=2,
                                         cache_bytes=CACHE, device="cpu")
    assert sorted(a.name for a, _ in ranked) == sorted(a.name for a in algs)
    ts = [t for _, t in ranked]
    assert ts == sorted(ts) and all(t > 0 for t in ts)
    with pytest.raises(ValueError, match="session"):
        rank_contraction_algorithms(spec, sizes, batched=True,
                                    repetitions=2)


def test_measure_contraction_on_cpu():
    spec = ContractionSpec.parse("ab=ai,ib")
    sizes = dict(a=8, b=8, i=8)
    alg = ContractionAlgorithm(spec, "gemm", ("a", "b", "i"), ())
    A, B = _operands(spec, sizes)
    stats = measure_contraction(alg, A, B, sizes, repetitions=3,
                                device="cpu")
    assert 0 < stats.min <= stats.med <= stats.max


def test_cache_study_on_cpu_and_mixing_identical():
    a = torch.ones(64, 64)
    timings = cachestudy.measure_cache_effects(
        lambda i: (lambda: a @ a), repetitions=3, n_buffers=2,
        device="cpu")
    assert timings.warm.med > 0 and timings.cold.med > 0
    for w, c, m in [(1.0, 2.0, 1.5), (1.0, 2.0, 3.0), (2.0, 2.0, 2.0),
                    (1.0, 4.0, 0.5)]:
        assert cachestudy.calibrate_alpha(w, c, m) == \
            ref_cachestudy.calibrate_alpha(w, c, m)
        alpha = cachestudy.calibrate_alpha(w, c, m)
        assert cachestudy.combine_estimates(w, c, alpha) == \
            ref_cachestudy.combine_estimates(w, c, alpha)


# ---------------------------------------------------------------- on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the L2 capacity and the §6.2 "
                    "protocol's timings are the card's own (chip_smoke.py "
                    "runs them on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_l2_is_read_from_the_device(card):
    props = torch.cuda.get_device_properties(card)
    assert l2_cache_bytes(card) == props.L2_cache_size > 0


@pytest.mark.cuda
def test_cold_operands_measure_no_faster_than_warm_on_the_card(card):
    """A 64 MiB gemv matrix read from HBM each call (cold) against the
    same read from one buffer: cold calls cycle through a pool spanning
    the L2 and may not come out faster."""
    cache = l2_cache_bytes(card)
    n = 4096
    warm, _ = run_kernel_benchmark("ab,b->a", (n, 1024), (1024,), (n,),
                                   cold_a=False, cold_b=False,
                                   repetitions=5, device=card)
    cold, _ = run_kernel_benchmark("ab,b->a", (n, 1024), (1024,), (n,),
                                   cold_a=True, cold_b=False,
                                   repetitions=5, device=card)
    assert cold.med >= 0.9 * warm.med
    assert cold_pool_size(5 * contractions.BURST, 4 * n * 1026,
                          cache) >= 2


@pytest.mark.cuda
def test_execute_on_the_card_matches_the_whole_einsum(card):
    spec = ContractionSpec.parse("abc=ai,ibc")
    sizes = dict(a=48, b=48, c=48, i=8)
    A, B = _operands(spec, sizes)
    want = execute_reference(spec, A, B, device=card)
    for alg in generate_algorithms(spec):
        if alg.n_iterations(sizes) <= 2304:
            got = execute(alg, A, B, sizes, device=card)
            torch.testing.assert_close(got, want, **TOL)
