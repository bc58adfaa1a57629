"""The block RMSNorm's kernels (``csrc/rmsnorm.cu``) against their plain
versions on a CUDA card.

Every test here is marked ``cuda`` and skips without a card; on one, run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rmsnorm_cuda.py``.
The widths are the models' d_model (mamba2-2.7b's 2560, gemma2-27b's
4608, chameleon's 8192: the vector path) and an unaligned 100 (the scalar
path), at 1, 4095 and 4096 rows, in float32 and bfloat16.  Tolerances,
normwise: y and dx 1e-5 in float32 (the same operations, sums in other
orders) and 4e-3 in bfloat16 (an element may round to the neighbouring
bfloat16); rstd and scale's gradient (float32 in both) 1e-5; two calls
give the same bits.  chip_smoke's phase "2 rmsnorm" holds them at every
model width and times them.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
WIDTHS = (2560, 4608, 8192, 100)
ROWS = (1, 4095, 4096)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the norm's kernels run only there "
                    "(chip_smoke.py phase \"2 rmsnorm\" runs them on the "
                    "H100)")
    return torch.device("cuda")


def _normwise(got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _inputs(card, rows, d, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((rows, d), generator=gen, device=card).to(dtype)
    scale = (0.1 * torch.randn((d,), generator=gen, device=card)).to(dtype)
    dy = torch.randn((rows, d), generator=gen, device=card).to(dtype)
    return x, scale, dy


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_and_repeat(card, rows, d, dtype):
    x, scale, dy = _inputs(card, rows, d, dtype, seed=rows + d)
    tol = TOL[dtype]
    before = (rn.rmsnorm_fwd.launches, rn.rmsnorm_bwd.launches)
    y, r = rn.rmsnorm_fwd(x, scale)
    yp, rp = rn.rmsnorm_fwd(x, scale, use_kernel=False)
    assert _normwise(y, yp) <= tol and _normwise(r, rp) <= 1e-5
    assert torch.equal(y, rn.rmsnorm_fwd(x, scale)[0])
    dx, ds = rn.rmsnorm_bwd(dy, x, scale, r)
    dxp, dsp = rn.rmsnorm_bwd(dy, x, scale, r, use_kernel=False)
    assert _normwise(dx, dxp) <= tol and _normwise(ds, dsp) <= 1e-5
    dx2, ds2 = rn.rmsnorm_bwd(dy, x, scale, r)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    assert (rn.rmsnorm_fwd.launches, rn.rmsnorm_bwd.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_last_token_view_and_autograd(card, dtype):
    """A prefill's strided last-token rows, and the models' norm under
    autograd (``RmsNormFn``), against the plain route."""
    x, scale, _ = _inputs(card, 3 * 40, 2560, dtype, seed=7)
    x = x.reshape(3, 40, 2560)
    last = x[:, -1:, :]
    assert torch.equal(layers.rmsnorm(last, scale),
                       layers.rmsnorm(last.contiguous(), scale))
    xk = x.clone().requires_grad_(True)
    sk = scale.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    sp = scale.clone().requires_grad_(True)
    yk = layers.rmsnorm(xk, sk)
    yp = layers.rmsnorm(xp, sp, use_kernel=False)
    assert _normwise(yk, yp) <= TOL[dtype]
    dy = torch.randn_like(yk)
    gk = torch.autograd.grad(yk, (xk, sk), dy)
    gp = torch.autograd.grad(yp, (xp, sp), dy)
    for a, b in zip(gk, gp):
        assert a.dtype == b.dtype and _normwise(a, b) <= TOL[dtype]


@pytest.mark.cuda
def test_unsupported_cuda_inputs_raise(card):
    x = torch.randn(4, 64, device=card)
    with pytest.raises(ValueError, match="at most"):
        rn.rmsnorm_fwd(torch.zeros(2, rn.MAX_D + 8, device=card),
                       torch.zeros(rn.MAX_D + 8, device=card))
    with pytest.raises(ValueError, match="scale in x's dtype"):
        rn.rmsnorm_fwd(x, torch.zeros(64, device=card, dtype=torch.bfloat16))
