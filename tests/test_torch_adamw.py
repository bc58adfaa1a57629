"""The optimizer step's kernels (``repro_torch.kernels.adamw``,
``csrc/adamw.cu``) and ``AdamW.update_apply``, on the CPU.

* ``update_apply`` is bit for bit ``update`` followed by ``apply_updates``
  in every case of chip_smoke's phase-2 check (the three (parameter,
  gradient) dtype pairs, weight decay on and off, no clip and the clip
  active, one element, seven, a million and three, a view one element
  into its buffers), and with ``SLICE`` made small.
* Three steps of ``update_apply`` against the reference's ``update`` and
  ``apply_updates`` (float32, clip active): the moments at
  ``test_torch_train.py``'s 1e-6 of their scale; the parameters, which
  add each update to values near 1 and round, at 1e-6 of the update's
  scale plus one float32 ulp of the parameter a step.
* The update kernel's arithmetic, emulated in numpy float32 operation by
  operation in ``adamw.cu``'s order (bfloat16 rounded to nearest even on
  the bits), equals the plain version bit for bit, its square root taken
  as the plain version takes it here: torch's vectorised CPU ``sqrt`` need
  not round correctly, while ``__fsqrt_rn`` and torch's CUDA ``sqrt`` do
  (chip_smoke's phase 2 holds the kernel to the plain version on the
  card, bit for bit); the norm kernel's
  (float64 sums rounded once, added to the running sum in float32) is
  within chip_smoke's 1e-6 of the float64 sum and sums as
  ``_squared_norm`` always has.
* The three operators pass ``torch.library.opcheck`` on CPU tensors; fake
  CUDA tensors reach their fake implementations, never a plain version,
  and launch nothing; real CPU tensors run the plain versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.train import optimizer as ref_optimizer  # noqa: E402
from repro_torch.kernels import adamw as kern  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.optimizer import AdamW, apply_updates  # noqa: E402

torch.set_num_threads(1)

DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
          (torch.bfloat16, torch.float32)]
SIZES = (1, 7, (1 << 20) + 3)


def _draw(rng, n, dtype, scale=1.0, offset=0):
    """``n`` normal values times ``scale`` in ``dtype``, a view ``offset``
    elements into a buffer of its own."""
    buf = torch.from_numpy((rng.standard_normal(n + offset) * scale)
                           .astype(np.float32)).to(dtype)
    return buf[offset:]


def _params(rng, p_dtype):
    return [_draw(rng, n, p_dtype) for n in SIZES] + \
        [_draw(rng, SIZES[-1], p_dtype, offset=1)]


def _grads(rng, g_dtype):
    return [_draw(rng, n, g_dtype, 4.0) for n in SIZES] + \
        [_draw(rng, SIZES[-1], g_dtype, 4.0, offset=1)]


def _copies(ts):
    """Copies at the same offset into buffers of their own."""
    out = []
    for t in ts:
        off = t.storage_offset()
        buf = torch.empty(t.numel() + off, dtype=t.dtype)
        out.append(buf[off:].view(t.shape).copy_(t))
    return out


def _assert_same(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _two_ways(opt, params, grads_per_step, decay):
    """(update_apply's params and state, update + apply_updates')."""
    pa, pb = _copies(params), _copies(params)
    sa, sb = opt.init(pa), opt.init(pb)
    for grads in grads_per_step:
        sa = opt.update_apply(grads, sa, pa, decay)
        upd, sb = opt.update(grads, sb, pb, decay)
        apply_updates(pb, upd)
    return (pa, sa), (pb, sb)


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("p_dtype,g_dtype", DTYPES)
def test_update_apply_equals_update_then_apply_updates(p_dtype, g_dtype,
                                                       decay, clip):
    rng = np.random.default_rng(3)
    params = _params(rng, p_dtype)
    steps = [_grads(rng, g_dtype) for _ in range(2)]
    opt = AdamW(lr=3e-4, grad_clip=clip)
    if clip:            # the global norm is far above the clip: active
        assert float(torch.sqrt(optimizer._squared_norm(steps[0]))) > 100
    (pa, sa), (pb, sb) = _two_ways(opt, params, steps,
                                   [decay] * len(params))
    assert int(sa.step) == int(sb.step) == 2
    _assert_same(pa + sa.mu + sa.nu, pb + sb.mu + sb.nu)
    assert not torch.equal(pa[2], params[2])          # it did update
    assert pa[3].storage_offset() == 1          # the view was written


@pytest.mark.parametrize("p_dtype,g_dtype", DTYPES)
def test_update_apply_with_small_slices(monkeypatch, p_dtype, g_dtype):
    rng = np.random.default_rng(4)
    params = [_draw(rng, n, p_dtype).reshape(-1, 1) if n > 1 else
              _draw(rng, n, p_dtype) for n in (1, 7, 40 * 30 + 3)]
    steps = [[_draw(rng, p.numel(), g_dtype, 4.0).reshape(p.shape)
              for p in params] for _ in range(2)]
    opt = AdamW(lr=3e-4)
    (pw, sw), _ = _two_ways(opt, params, steps, None)
    monkeypatch.setattr(optimizer, "SLICE", 7)
    (pa, sa), (pb, sb) = _two_ways(opt, params, steps, None)
    _assert_same(pa + sa.mu + sa.nu, pb + sb.mu + sb.nu)
    _assert_same(pa + sa.mu + sa.nu, pw + sw.mu + sw.nu)


def test_update_apply_matches_the_reference_over_three_steps():
    rng = np.random.default_rng(0)
    shapes = [(16, 24), (24,), (3, 8, 5), (7,)]
    params = [(rng.standard_normal(s)).astype(np.float32) for s in shapes]
    opt_kw = dict(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    ref_opt, opt = ref_optimizer.AdamW(**opt_kw), AdamW(**opt_kw)
    ref_params = [jnp.asarray(p) for p in params]
    ref_state = ref_opt.init(ref_params)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    state = opt.init(tparams)
    for step in range(3):
        grads = [(rng.standard_normal(s) * 2.0).astype(np.float32)
                 for s in shapes]
        assert np.sqrt(sum((g ** 2).sum() for g in grads)) > 10
        ref_upd, ref_state = ref_opt.update([jnp.asarray(g) for g in grads],
                                            ref_state, ref_params)
        ref_params = ref_optimizer.apply_updates(ref_params, ref_upd)
        state = opt.update_apply([torch.from_numpy(g) for g in grads],
                                 state, tparams)
        assert int(state.step) == step + 1
        for mine, ref in zip(state.mu + state.nu,
                             list(ref_state.mu) + list(ref_state.nu)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max())
        for mine, ref, ru in zip(tparams, ref_params, ref_upd):
            ref, ru = np.asarray(ref), np.asarray(ru)
            atol = (step + 1) * (1e-6 * np.abs(ru).max() +
                                 np.spacing(np.abs(ref).max()))
            np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=atol)


# ------------------------------------------- the kernels' arithmetic --

def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bfloat16 (nearest, ties to even) and back, on
    the bits, as ``__float2bfloat16_rn``."""
    bits = x.astype(np.float32).view(np.uint32)
    bias = ((bits >> 16) & 1) + np.uint32(0x7FFF)
    return ((bits + bias) & np.uint32(0xFFFF0000)).view(np.float32)


def _emulate_update(g, m, v, p, *, scale, bc1, bc2, lr, b1, b2, eps,
                    weight_decay, decay, p_bf16, apply, sqrt=np.sqrt):
    """``adamw_update_kernel``'s element arithmetic in numpy float32, one
    rounded operation at a time in the source's order (``sqrt`` the square
    root); returns (m, v, u or the new p)."""
    f = np.float32
    g = g.astype(f)
    if scale is not None:
        g = g * f(scale)
    m = f(b1) * m + f(1 - b1) * g
    v = f(b2) * v + (f(1 - b2) * g) * g
    den = sqrt(v / f(bc2)) + f(eps)
    d = (m / f(bc1)) / den
    if weight_decay and decay:
        d = d + f(weight_decay) * p
    upd = f(-lr) * d
    rnd = _bf16 if p_bf16 else (lambda x: x)
    if apply:
        return m, v, rnd(p + rnd(upd))
    return m, v, rnd(upd)


@pytest.mark.parametrize("apply", [False, True])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("decay", [True, False])
@pytest.mark.parametrize("p_dtype,g_dtype", DTYPES)
def test_kernel_arithmetic_emulated_equals_the_plain_version(
        p_dtype, g_dtype, decay, clip, apply):
    rng = np.random.default_rng(5)
    n = 4099
    p, g = _draw(rng, n, p_dtype), _draw(rng, n, g_dtype, 4.0)
    m = _draw(rng, n, torch.float32, 0.1)
    v = torch.from_numpy(rng.uniform(0, 0.01, n).astype(np.float32))
    stepf = torch.tensor(3, dtype=torch.int32).float()
    consts = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    bc1 = 1 - torch.tensor(consts["b1"]) ** stepf
    bc2 = 1 - torch.tensor(consts["b2"]) ** stepf
    scale = torch.tensor(0.0123, dtype=torch.float32) if clip else None
    want_m, want_v, want_p = m.clone(), v.clone(), p.clone()
    u = None if apply else torch.empty_like(p)
    kern.adamw_update_plain([g], [want_m], [want_v], [want_p],
                            None if apply else [u], scale=scale, bc1=bc1,
                            bc2=bc2, decay=[decay], **consts)
    got_m, got_v, got = _emulate_update(
        g.float().numpy(), m.numpy(), v.numpy(), p.float().numpy(),
        scale=None if scale is None else float(scale), bc1=float(bc1),
        bc2=float(bc2), decay=decay, p_bf16=p_dtype == torch.bfloat16,
        apply=apply, sqrt=lambda x: torch.sqrt(torch.from_numpy(x)).numpy(),
        **consts)
    np.testing.assert_array_equal(got_m, want_m.numpy())
    np.testing.assert_array_equal(got_v, want_v.numpy())
    want = (want_p if apply else u).float().numpy()
    np.testing.assert_array_equal(got, want)


def _emulate_sqnorm(grads) -> np.float32:
    """The norm kernels' arithmetic over a list: each tensor's squares
    summed in float64 (any fixed order; here numpy's) and rounded once to
    float32, the sums added to the running sum in float32."""
    total = None
    for g in grads:
        s = np.float32(np.sum(g.astype(np.float64) ** 2))
        total = s if total is None else np.float32(total + s)
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 1 << 16, (1 << 20) + 3])
def test_norm_kernel_arithmetic_within_the_gate(dtype, n):
    rng = np.random.default_rng(n)
    g = _draw(rng, n, dtype, 4.0).float().numpy()
    exact = np.sum(g.astype(np.float64) ** 2)
    got = _emulate_sqnorm([g])
    assert abs(float(got) - exact) <= 1e-6 * exact
    first = np.full(3, 0.5, dtype=np.float32)
    assert _emulate_sqnorm([first, g]) == np.float32(0.75) + got


def test_squared_norm_adds_the_tensors_in_list_order():
    rng = np.random.default_rng(6)
    grads = [_draw(rng, n, torch.float32, 3.0) for n in (5, 1000, 77)]
    want = sum(torch.sum(torch.square(g.float())) for g in grads)
    assert torch.equal(optimizer._squared_norm(grads), want)
    assert torch.equal(kern.adamw_sqnorm(grads), want)


def test_a_non_contiguous_parameter_is_refused_not_lost():
    p = torch.randn(8, 6).t()
    opt = AdamW()
    state = opt.init([p])
    with pytest.raises(RuntimeError):
        opt.update_apply([torch.ones_like(p)], state, [p])


def test_bytes_of_one_update():
    n = 1000
    assert kern.adamw_update_bytes(n, torch.bfloat16, torch.bfloat16) == \
        22 * n
    assert kern.adamw_update_bytes(n, torch.float32, torch.float32) == \
        28 * n
    assert kern.adamw_update_bytes(n, torch.float32, torch.bfloat16) == \
        24 * n


# ------------------------------------------------------------ operators --

def _op_args(p_dtype, g_dtype, sizes=(37, 5)):
    """Lists of g, m, v and p, one tensor a size, and scale, bc1, bc2."""
    rng = np.random.default_rng(7)
    t = {"g": [_draw(rng, n, g_dtype, 4.0) for n in sizes],
         "m": [_draw(rng, n, torch.float32) for n in sizes],
         "v": [torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
               for n in sizes],
         "p": [_draw(rng, n, p_dtype) for n in sizes]}
    return t, [torch.tensor(x) for x in (0.5, 0.271, 0.142)]


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("p_dtype,g_dtype", DTYPES)
def test_update_operators_pass_opcheck(p_dtype, g_dtype, clip):
    t, (scale, bc1, bc2) = _op_args(p_dtype, g_dtype)
    hyper = (3e-4, 0.9, 0.95, 1e-8, 0.1, [True, False])
    scale = scale if clip else None
    torch.library.opcheck(torch.ops.repro_torch.adamw_update,
                          (t["g"], t["m"], t["v"], t["p"],
                           [torch.empty_like(p) for p in t["p"]], scale, bc1,
                           bc2, *hyper))
    torch.library.opcheck(torch.ops.repro_torch.adamw_update_apply,
                          (t["g"], t["m"], t["v"], t["p"], scale, bc1, bc2,
                           *hyper))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sqnorm_operator_passes_opcheck(dtype):
    t, _ = _op_args(dtype, dtype)
    torch.library.opcheck(torch.ops.repro_torch.adamw_sqnorm, (t["g"],))


@pytest.mark.parametrize("p_dtype,g_dtype", DTYPES)
def test_fake_cuda_tensors_reach_the_fake_implementations(p_dtype, g_dtype):
    before = (kern.adamw_update.launches, kern.adamw_sqnorm.launches)
    with FakeTensorMode():
        params = [torch.empty(s, dtype=p_dtype, device="cuda")
                  for s in ((64, 32), (32,))]
        grads = [torch.empty(p.shape, dtype=g_dtype, device="cuda")
                 for p in params]
        opt = AdamW()
        state = opt.update_apply(grads, opt.init(params), params)
        upd, state = opt.update(grads, state, params)
        assert [u.shape for u in upd] == [p.shape for p in params]
        assert all(u.dtype == p_dtype and u.device.type == "cuda"
                   for u in upd)
        assert state.mu[0].dtype == torch.float32
        s = kern.adamw_sqnorm(grads)
        assert s.shape == () and s.dtype == torch.float32
    assert (kern.adamw_update.launches, kern.adamw_sqnorm.launches) == before


def test_fake_cuda_tensors_are_checked_for_contiguity():
    with FakeTensorMode():
        p = torch.empty(8, 6, device="cuda").t()
        opt = AdamW()
        state = opt.init([torch.empty(6, 8, device="cuda")])
        with pytest.raises(ValueError, match="contiguous"):
            opt.update_apply([torch.empty(6, 8, device="cuda")], state, [p])


def test_fake_tensors_never_run_the_plain_versions(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on fake tensors")

    for name in ("adamw_update_plain", "adamw_sqnorm_plain",
                 "_update_slice"):
        monkeypatch.setattr(kern, name, refuse)
    for device in ("cpu", "cuda"):
        with FakeTensorMode():
            params = [torch.empty(s, dtype=torch.bfloat16, device=device)
                      for s in ((16, 8), (8,))]
            grads = [torch.empty_like(p) for p in params]
            opt = AdamW()
            state = opt.update_apply(grads, opt.init(params), params)
            opt.update(grads, state, params)


def test_real_cpu_tensors_run_the_plain_versions(monkeypatch):
    calls = []
    plain = kern.adamw_update_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(kern, "adamw_update_plain", counted)
    before = (kern.adamw_update.launches, kern.adamw_sqnorm.launches)
    p = [torch.randn(4, 3), torch.randn(3)]
    opt = AdamW()
    opt.update_apply([torch.ones_like(x) for x in p], opt.init(p), p)
    assert calls == [1]             # one call for the step's tensors
    assert (kern.adamw_update.launches, kern.adamw_sqnorm.launches) == before
