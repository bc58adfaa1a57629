"""The Mamba-2 mixer's kernels (``csrc/mamba_mixer.cu``) against their plain
versions on a CUDA card.

Every test here is marked ``cuda`` and skips without a card; on one, run
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_mamba_mixer_cuda.py``.  The
shapes are small: an aligned row (the vector path) and an unaligned one
(the scalar path), in float32 and bfloat16.  Tolerances: 1e-5 normwise in
float32 (the same operations, sums in other orders), 4e-3 in bfloat16 (an
element may round to the neighbouring bfloat16), the parameter gradients
1e-5 normwise of the float64 plain version; two calls give the same bits.
chip_smoke's phase "2 mamba" holds them at the models' widths.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import mamba_mixer as mm  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
#: (batch, length, heads, P, groups, N): aligned, unaligned and ragged
#: rows
SHAPES = [(2, 64, 4, 16, 1, 16), (1, 48, 5, 8, 1, 12),
          (3, 1365, 80, 64, 1, 128)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mixer's kernels run only there "
                    "(chip_smoke.py phase \"2 mamba\" runs them on the H100)")
    return torch.device("cuda")


def _normwise(got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _inputs(card, shape, dtype, seed=0):
    b, s, h, p, g, n = shape
    gen = torch.Generator(device=card).manual_seed(seed)
    di = h * p
    w = 2 * di + 2 * g * n + h

    def rand(*sh, scale=1.0):
        return torch.randn(sh, generator=gen, device=card) * scale

    return dict(zx=rand(b, s, w).to(dtype), dt_bias=rand(h, scale=0.5) - 1,
                d_skip=1 + rand(h, scale=0.3),
                norm_g=rand(di, scale=0.2).to(dtype),
                y=rand(b, s, h, p), d_out=rand(b, s, di).to(dtype),
                dx=rand(b, s, h, p), db=rand(b, s, g, n), dc=rand(b, s, g, n),
                ddt=rand(b, s, h), dims=dict(heads=h, groups=g, state=n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES,
                         ids=["aligned", "unaligned", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_and_repeat(card, shape, dtype):
    t = _inputs(card, shape, dtype)
    tol = TOL[dtype]
    got = mm.mamba_in(t["zx"], t["dt_bias"], **t["dims"])
    want = mm.mamba_in(t["zx"], t["dt_bias"], use_kernel=False, **t["dims"])
    for a, b in zip(got, want):
        assert _normwise(a, b) <= 1e-6
    args = (t["y"], t["zx"], t["d_skip"], t["norm_g"])
    out, r = mm.mamba_out(*args)
    out_p, r_p = mm.mamba_out(*args, use_kernel=False)
    assert _normwise(out, out_p) <= tol and _normwise(r, r_p) <= 1e-5
    assert torch.equal(out, mm.mamba_out(*args)[0])
    grads = []
    for use_kernel in (True, True, False):
        grad = torch.full_like(t["zx"], float("nan"))
        dy, d_g, d_s = mm.mamba_out_bwd(t["d_out"], t["y"], t["zx"], r_p,
                                        t["d_skip"], t["norm_g"], grad,
                                        use_kernel=use_kernel)
        d_b = mm.mamba_in_bwd(t["dx"], t["db"], t["dc"], t["ddt"], dy,
                              t["zx"], t["dt_bias"], t["d_skip"], grad,
                              use_kernel=use_kernel)
        grads.append((grad, dy, d_g, d_s, d_b))
    assert not grads[0][0].isnan().any()
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)
    for a, b in zip(grads[0][:2], grads[2][:2]):
        assert _normwise(a, b) <= tol
    for a, b in zip(grads[0][2:], grads[2][2:]):
        assert _normwise(a, b) <= 1e-5


@pytest.mark.cuda
def test_mixer_fn_kernel_route_matches_plain_route(card):
    """MambaMixerFn on the card (the glue's kernels around the SSD's) and on
    the CPU (the plain versions) from the same float32 inputs: output,
    final state and every gradient within 1e-4 normwise."""
    t = _inputs(card, (1, 128, 4, 16, 1, 16), torch.float32, seed=3)
    a_log = torch.zeros(4, device=card)
    res = {}
    for dev in (card, torch.device("cpu")):
        leaves = [x.detach().to(dev).requires_grad_(True) for x in (
            t["zx"], t["dt_bias"], a_log, t["d_skip"], t["norm_g"])]
        out, h = mm.mamba_mixer(*leaves, chunk=64, want_state=True,
                                **t["dims"])
        g = torch.autograd.grad((out * out).sum() + h.sum(), leaves)
        res[dev.type] = [out, h, *g]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert _normwise(a.cpu(), b) <= 1e-4
