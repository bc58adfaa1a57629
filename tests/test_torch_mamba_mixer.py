"""The Mamba-2 mixer's glue (``repro_torch.kernels.mamba_mixer``) and the
port's Mamba layer against the reference, on the CPU.

On CPU tensors the four kernels' wrappers run their plain versions, and
:class:`MambaMixerFn`'s backward is the plain versions of the two glue
backwards around the SSD's plain backward.  Inputs are made with numpy
from a seed and the reference's parameters carried across, at reduced
mamba2-2.7b and jamba-v0.1-52b widths and at an unaligned one (rows whose
column offsets are not multiples of 8, which the kernels take on their
scalar path).  Tolerances: the layer's forward ``rtol = atol = 1e-4`` in
float32 (``tests/test_torch_models.py``'s; sums in other orders) and 2e-2
normwise in bfloat16 (chip_smoke's kernel-vs-plain route tolerance: a few
bfloat16 roundings at other points); every gradient 1e-4 normwise against
``jax.vjp`` (``tests/test_torch_train.py``'s) in float32; the plain
backward against float64 autograd of the plain forward at 1e-10, and
``gradcheck`` in float64.  The kernels themselves run on a card only
(``tests/test_torch_mamba_mixer_cuda.py`` and chip_smoke's phase
"2 mamba").
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import mamba_mixer as mm  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4
BF16_TOL = 2e-2
GRAD_TOL = 1e-4
#: (arch, config replacements): the reduced configs, and one whose rows
#: are not 16-byte aligned (d_inner 40 in 5 heads, N 12, W = 109)
CASES = [("mamba2-2.7b", {}), ("jamba-v0.1-52b", {}),
         ("mamba2-2.7b", dict(d_model=20, ssm_heads=5, ssm_head_dim=8,
                              ssm_state=12, ssm_chunk=16))]
IDS = ["mamba2", "jamba", "unaligned"]


def _cfgs(arch, replace):
    ref = ref_configs.reduced(ref_configs.get_config(arch))
    mine = configs.reduced(configs.get_config(arch))
    return (dataclasses.replace(ref, **replace),
            dataclasses.replace(mine, **replace))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(ref_cfg, seed):
    """Reference parameters with a_log, d_skip, dt_bias and norm_g drawn
    around the model's initial values (0, 1, -2, 0: every term exercised,
    and decays over a chunk whose exponentials the reference's own
    gradient keeps finite), and the port's from the same arrays."""
    p = ref_mamba.init_mamba(ref_cfg, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    h = ref_cfg.ssm_heads
    p = p._replace(a_log=jnp.asarray(_normal(rng, (h,), 0.3)),
                   d_skip=jnp.asarray(1.0 + _normal(rng, (h,), 0.3)),
                   dt_bias=jnp.asarray(-1.0 + _normal(rng, (h,), 0.5)),
                   norm_g=jnp.asarray(_normal(rng, (ref_cfg.d_inner,), 0.1)))
    arrays = {k: np.asarray(v) for k, v in p._asdict().items()}
    return p, arrays


def _port(arrays, dtype):
    """MambaParams from the arrays: the projections and norm_g in
    ``dtype``, a_log, d_skip and dt_bias float32 (the reference's)."""
    t = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    for k in ("in_proj", "norm_g", "out_proj"):
        t[k] = t[k].to(dtype)
    return mamba.MambaParams(**t)


def _ref_params(p, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return p._replace(in_proj=p.in_proj.astype(jd),
                      norm_g=p.norm_g.astype(jd),
                      out_proj=p.out_proj.astype(jd))


def _np(t):
    return t.detach().float().numpy()


def _normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------- the layer vs reference --

@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["prefill", "prefill_h0", "decode"])
def test_layer_matches_reference(case, dtype, mode):
    """Prefill without and with an incoming state (the final state
    returned) and a decode step, on the mixer's kernel routes ("mixer",
    "decode"), against the reference's ``mamba_forward``."""
    arch, replace = CASES[case]
    ref_cfg, cfg = _cfgs(arch, replace)
    p, arrays = _params(ref_cfg, 3 + case)
    rng = np.random.default_rng(11)
    s = 1 if mode == "decode" else 2 * cfg.ssm_chunk
    x = _normal(rng, (2, s, cfg.d_model))
    state = None
    if mode != "prefill":
        state = _normal(rng, (2, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), 0.5)
    route = "decode" if mode == "decode" else "mixer"
    before = mamba.mamba_forward.route_calls[route]
    out, new = mamba.mamba_forward(
        cfg, _port(arrays, dtype), torch.from_numpy(x).to(dtype),
        state=None if state is None else torch.from_numpy(state),
        return_state=True)
    assert mamba.mamba_forward.route_calls[route] == before + 1
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref, ref_new = ref_mamba.mamba_forward(
        ref_cfg, _ref_params(p, dtype), jnp.asarray(x).astype(jd),
        state=None if state is None else jnp.asarray(state),
        return_state=True)
    assert out.dtype == dtype and new.dtype == torch.float32
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(_np(new), np.asarray(ref_new), rtol=TOL,
                                   atol=TOL)
    else:
        assert _normwise(_np(out), np.asarray(ref, np.float32)) <= BF16_TOL
        assert _normwise(_np(new), np.asarray(ref_new, np.float32)) <= \
            BF16_TOL


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_gradients_match_jax_vjp(case):
    """Every parameter's and the input's gradient through the "mixer"
    route (MambaMixerFn: the glue's plain backwards around the SSD's)
    against ``jax.vjp`` of the reference's ``mamba_forward``, float32."""
    arch, replace = CASES[case]
    ref_cfg, cfg = _cfgs(arch, replace)
    p, arrays = _params(ref_cfg, 5 + case)
    rng = np.random.default_rng(12)
    x = _normal(rng, (2, 2 * cfg.ssm_chunk, cfg.d_model))
    cot = _normal(rng, x.shape)
    mine = _port(arrays, torch.float32)
    leaves = list(mine.parameters())
    for t in leaves:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mamba.mamba_forward(cfg, mine, xt)
    grads = torch.autograd.grad(out, [xt] + leaves,
                                grad_outputs=torch.from_numpy(cot))
    _, vjp = jax.vjp(lambda pp, xx: ref_mamba.mamba_forward(ref_cfg, pp, xx),
                     p, jnp.asarray(x))
    ref_p, ref_x = vjp(jnp.asarray(cot))
    names = ["input"] + [n for n, _ in mine.named_parameters()]
    want = [ref_x] + [getattr(ref_p, n) for n in names[1:]]
    for name, g, w in zip(names, grads, want):
        assert _normwise(_np(g), w) <= GRAD_TOL, name


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_bf16_gradients_match_the_reference_route(case):
    """In bfloat16 the mixer's backward rounds at the plain version's
    points but adds x's two gradients before rounding (autograd rounded
    each first): every gradient within 2e-2 normwise of the composite's
    ("reference" route, autograd through the same forward)."""
    arch, replace = CASES[case]
    ref_cfg, cfg = _cfgs(arch, replace)
    _, arrays = _params(ref_cfg, 7 + case)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(_normal(rng, (2, 2 * cfg.ssm_chunk, cfg.d_model)))
    cot = torch.from_numpy(_normal(rng, tuple(x.shape))).bfloat16()
    got = {}
    for use_kernel in (True, False):
        mine = _port(arrays, torch.bfloat16)
        leaves = list(mine.parameters())
        for t in leaves:
            t.requires_grad_(True)
        xt = x.bfloat16().requires_grad_(True)
        out = mamba.mamba_forward(cfg, mine, xt, use_kernel=use_kernel)
        got[use_kernel] = torch.autograd.grad(out, [xt] + leaves,
                                              grad_outputs=cot)
    for g, w in zip(got[True], got[False]):
        assert g.dtype == w.dtype
        assert _normwise(_np(g), _np(w)) <= BF16_TOL


# ------------------------------------------------- the plain backward --

def _mixer_inputs(dtype, b=1, s=8, h=2, p=4, g=1, n=4, seed=0):
    rng = np.random.default_rng(seed)
    di = h * p
    w = 2 * di + 2 * g * n + h
    zx = torch.from_numpy(_normal(rng, (b, s, w))).to(dtype)
    vec = dict(dt_bias=_normal(rng, (h,), 0.5), a_log=_normal(rng, (h,), 0.5),
               d_skip=1.0 + _normal(rng, (h,), 0.3),
               norm_g=_normal(rng, (di,), 0.2))
    vec = {k: torch.from_numpy(v).to(dtype) for k, v in vec.items()}
    h0 = torch.from_numpy(_normal(rng, (b, h, p, n), 0.5)).to(dtype)
    return zx, vec, h0, dict(heads=h, groups=g, state=n)


def _composite(zx, vec, h0, dims, chunk):
    """The mixer as the composite computes it, differentiated by autograd:
    the plain forwards and the SSD's plain passes."""
    x, dt, b, c = mm.mamba_in_plain(zx, vec["dt_bias"], **dims)
    y, h_final, _, _ = mm._plain_parts(x, dt, vec["a_log"], b, c, chunk, h0)
    out, _ = mm.mamba_out_plain(y, zx, vec["d_skip"], vec["norm_g"])
    return out, h_final


def test_plain_backward_matches_float64_autograd():
    """MambaMixerFn's backward (the glue's plain backwards around the
    SSD's plain backward, one gradient buffer) against float64 autograd
    of the composite, with an incoming state and the final state's
    gradient."""
    zx, vec, h0, dims = _mixer_inputs(torch.float64, b=2, s=8)
    leaves = [zx, *vec.values(), h0]
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.default_rng(1)
    d_out = torch.from_numpy(rng.standard_normal((2, 8, 8)))
    d_h = torch.from_numpy(rng.standard_normal(tuple(h0.shape)))
    got_out, got_h = mm.MambaMixerFn.apply(
        zx, vec["dt_bias"], vec["a_log"], vec["d_skip"], vec["norm_g"], h0,
        4, dims["heads"], dims["groups"], dims["state"], True)
    got = torch.autograd.grad((got_out, got_h), leaves, (d_out, d_h))
    want_out, want_h = _composite(zx, vec, h0, dims, 4)
    want = torch.autograd.grad((want_out, want_h), leaves, (d_out, d_h))
    torch.testing.assert_close(got_out, want_out, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_mixer_fn_passes_gradcheck():
    zx, vec, h0, dims = _mixer_inputs(torch.float64, b=1, s=8, seed=2)
    args = [zx, vec["dt_bias"], vec["a_log"], vec["d_skip"], vec["norm_g"],
            h0]
    for t in args:
        t.requires_grad_(True)

    def fn(*a):
        return mm.MambaMixerFn.apply(*a, 4, dims["heads"], dims["groups"],
                                     dims["state"], True)

    assert torch.autograd.gradcheck(fn, tuple(args), eps=1e-6, atol=1e-7)


def test_out_backward_rounds_dy_through_the_model_dtype():
    """In bfloat16, dy (the SSD backward's input) is the round trip of
    y_t's float32 gradient through bfloat16, as autograd rounds it; z's
    gradient lands in the buffer's z columns only."""
    zx, vec, _, dims = _mixer_inputs(torch.bfloat16, b=1, s=6, seed=3)
    x, dt, b, c = mm.mamba_in(zx, vec["dt_bias"].float(), **dims)
    y = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    out, r = mm.mamba_out(y, zx, vec["d_skip"].float(), vec["norm_g"])
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(5)
                        ).bfloat16()
    grad = torch.full_like(zx, float("nan"))
    dy, d_g, d_s = mm.mamba_out_bwd(d_out, y, zx, r, vec["d_skip"].float(),
                                    vec["norm_g"], grad)
    di = dims["heads"] * 4
    assert torch.equal(dy, dy.bfloat16().float())
    assert not grad[..., :di].isnan().any()
    assert grad[..., di:].isnan().all()
    assert d_g.dtype == d_s.dtype == torch.float32
    assert tuple(d_g.shape) == (di,) and tuple(d_s.shape) == (2,)


# ------------------------------------------------------------- operators --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_pass_opcheck(dtype):
    zx, vec, _, dims = _mixer_inputs(dtype, b=2, s=4, seed=6)
    f32 = {k: v.float() for k, v in vec.items()}
    ops = torch.ops.repro_torch
    torch.library.opcheck(ops.mamba_in, (zx, f32["dt_bias"], 2, 1, 4))
    x, dt, b, c = mm.mamba_in(zx, f32["dt_bias"], **dims)
    y = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    torch.library.opcheck(ops.mamba_out, (y, zx, f32["d_skip"],
                                          vec["norm_g"]))
    out, r = mm.mamba_out(y, zx, f32["d_skip"], vec["norm_g"])
    d_out = torch.randn(out.shape).to(dtype)
    torch.library.opcheck(ops.mamba_out_bwd, (
        d_out, y, zx, r, f32["d_skip"], vec["norm_g"], torch.zeros_like(zx)))
    torch.library.opcheck(ops.mamba_in_bwd, (
        torch.randn(x.shape), torch.randn(b.shape), torch.randn(c.shape),
        torch.randn(dt.shape), y, zx, f32["dt_bias"], f32["d_skip"],
        torch.zeros_like(zx)))


def test_fake_cuda_tensors_reach_the_operators():
    """On fake CUDA tensors (a traced step) the mixer's forward reaches the
    operators' fake implementations, never a plain version, and launches
    nothing; the outputs have the kernels' shapes and dtypes."""
    before = (mm.mamba_in.launches, mm.mamba_out.launches)
    with FakeTensorMode():
        zx = torch.empty(1, 64, 2 * 128 + 2 * 16 + 8, dtype=torch.bfloat16,
                         device="cuda")
        vec = [torch.empty(8, device="cuda") for _ in range(3)]
        g = torch.empty(128, dtype=torch.bfloat16, device="cuda")
        out, h = mm.mamba_mixer(zx, vec[0], vec[1], vec[2], g, heads=8,
                                groups=1, state=16, chunk=32,
                                want_state=True)
        assert out.shape == (1, 64, 128) and out.dtype == torch.bfloat16
        assert h.shape == (1, 8, 16, 16) and h.dtype == torch.float32
        assert out.device.type == "cuda"
    assert (mm.mamba_in.launches, mm.mamba_out.launches) == before


def test_fake_cuda_tensors_are_checked():
    with FakeTensorMode():
        zx = torch.empty(1, 64, 2 * 128 + 2 * 16 + 8, device="cuda")
        v = torch.empty(8, device="cuda")
        with pytest.raises(ValueError, match="contiguous rows"):
            mm.mamba_in(torch.empty_strided((1, 64, 296), (64 * 592, 592, 2),
                                        device="cuda"), v,
                        heads=8, groups=1, state=16)
        with pytest.raises(ValueError, match="float32 operands"):
            mm.mamba_out(torch.empty(1, 64, 8, 16, dtype=torch.float64,
                                     device="cuda"),
                         zx, v, torch.empty(128, device="cuda"))
        wide = torch.empty(1, 2, 2 * 8320 + 2 * 16 + 8, device="cuda")
        with pytest.raises(ValueError, match="at most"):
            mm.mamba_mixer(wide, torch.empty(8, device="cuda"),
                           torch.empty(8, device="cuda"),
                           torch.empty(8, device="cuda"),
                           torch.empty(8320, device="cuda"), heads=8,
                           groups=1, state=16, chunk=2)


#: the library's row-group limits, read from its source
CU = (Path(mm.__file__).parent / "csrc" / "mamba_mixer.cu").read_text()
CU_BLOCKS = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 CU).group(1))
             for name in ("kOutBwdBlocks", "kInBwdBlocks")}
#: row counts the scratch is checked at: the models' 4096, ragged counts
#: about it, two sequences of 4096, and small ones
SCRATCH_ROWS = [(1, 1), (1, 7), (1, 4095), (1, 4096), (1, 4097), (2, 4096),
                (3, 1365)]


def _row_groups(rows: int, most: int):
    """(rows a group, groups): the library's ``row_groups``, written out
    again here."""
    blocks = min(rows, most)
    per = -(-rows // blocks)
    return per, -(-rows // per)


def test_partial_blocks_depend_on_the_rows_alone():
    """Both backwards' row groups: mamba_out_bwd's (a block a group, one
    wave on the H100's 132 SMs) and mamba_in_bwd's dt columns' (the
    launch's first blocks) follow the library's rule from the row count
    alone: every group holds a row, none is past the rows, at most the
    limit the source sets."""
    assert (mm.OUT_BWD_BLOCKS, mm.IN_BWD_BLOCKS) == (
        CU_BLOCKS["kOutBwdBlocks"], CU_BLOCKS["kInBwdBlocks"])
    assert mm.OUT_BWD_BLOCKS <= 132
    for most in (mm.OUT_BWD_BLOCKS, mm.IN_BWD_BLOCKS):
        for rows in (1, 5, 127, 128, 129, 255, 256, 257, 2049, 4095, 4096,
                     4097, 8192, 10 ** 6 + 1):
            nb = mm.partial_blocks(rows, most)
            per, want = _row_groups(rows, most)
            assert nb == want
            assert nb <= most and (nb - 1) * per < rows <= nb * per


@pytest.mark.parametrize("bs", SCRATCH_ROWS,
                         ids=[f"{b}x{s}" for b, s in SCRATCH_ROWS])
@pytest.mark.parametrize("width", [(80, 64, 1, 128), (128, 64, 1, 16)],
                         ids=["mamba2", "jamba"])
def test_wrappers_allocate_the_scratch_their_kernels_need(monkeypatch, bs,
                                                          width):
    """Through fake CUDA tensors at the models' widths, each backward's
    wrapper hands its kernel the row count and a partials' scratch of as
    many rows as the library's rule gives its groups: (2, groups, d_inner)
    for mamba_out_bwd, (groups, H) for mamba_in_bwd's dt columns."""
    b, s = bs
    h, p, g, n = width
    di, rows = h * p, b * s
    calls = {}

    def record(name, what, *args):
        calls[name] = args

    monkeypatch.setattr(mm, "_launch", record)
    with FakeTensorMode():
        kw = dict(device="cuda")
        zx = torch.empty(b, s, 2 * di + 2 * g * n + h, dtype=torch.bfloat16,
                         **kw)
        y = torch.empty(b, s, h, p, **kw)
        r = torch.empty(b, s, **kw)
        vec = torch.empty(h, **kw)
        norm_g = torch.empty(di, dtype=torch.bfloat16, **kw)
        d_out = torch.empty(b, s, di, dtype=torch.bfloat16, **kw)
        grad = torch.empty_like(zx)
        dy, d_g, d_s = mm._launch_out_bwd(d_out, y, zx, r, vec, norm_g, grad)
        db = torch.empty(b, s, g, n, **kw)
        d_b = mm._launch_in_bwd(y, db, db, torch.empty(b, s, h, **kw), dy,
                                zx, vec, vec, grad)
    out_args, in_args = calls["repro_mamba_out_bwd"], calls[
        "repro_mamba_in_bwd"]
    _, nb = _row_groups(rows, CU_BLOCKS["kOutBwdBlocks"])
    assert out_args[4] == rows
    assert tuple(out_args[18].shape) == tuple(out_args[19].shape) == (nb, di)
    assert out_args[18] is not out_args[19]
    _, nb = _row_groups(rows, CU_BLOCKS["kInBwdBlocks"])
    assert in_args[7] == rows
    assert tuple(in_args[21].shape) == (nb, h)
    assert tuple(d_g.shape) == (di,) and tuple(d_s.shape) == (h,)
    assert tuple(d_b.shape) == (h,)


# ----------------------------------------------------------------- routes --

def test_route_table():
    """Plain tensors take "mixer" (S > 1) or "decode" (one step with a
    state), ``use_kernel=False`` "reference"; on a fake mesh a DTensor
    whose mesh splits no heads takes "mixer_local", one that splits the
    heads "composite", and so does a sharded decode step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _, cfg = _cfgs("mamba2-2.7b", {})
    zx = torch.zeros(2, 4, 2 * cfg.d_inner + 2 * cfg.ssm_state +
                     cfg.ssm_heads)
    assert mamba.mixer_route(cfg, zx, False, True) == "mixer"
    assert mamba.mixer_route(cfg, zx[:, :1], True, True) == "decode"
    assert mamba.mixer_route(cfg, zx, False, False) == "reference"
    assert mamba.mixer_route(cfg, zx[:, :1], True, False) == "reference"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                              "model"))
        batch = DTensor.from_local(zx, mesh, [Shard(0), Replicate()])
        assert mamba.mixer_route(cfg, batch, False, True) == "composite"
        flat = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data",
                                                              "model"))
        batch = DTensor.from_local(zx, flat, [Shard(0), Replicate()])
        assert mamba.mixer_route(cfg, batch, False, True) == "mixer_local"
        assert mamba.mixer_route(cfg, batch, True, True) == "composite"
    finally:
        dist.destroy_process_group()
    assert mamba.MIXER_ROUTES == ("mixer", "mixer_local", "decode",
                                  "composite", "reference")


def test_layer_counts_each_call_by_route():
    _, cfg = _cfgs("mamba2-2.7b", {})
    p = mamba.init_mamba(cfg, torch.Generator().manual_seed(0),
                         torch.float32, device="cpu")
    x = torch.randn(1, cfg.ssm_chunk, cfg.d_model)
    calls = mamba.mamba_forward.route_calls
    before = dict(calls)
    _, st = mamba.mamba_forward(cfg, p, x, return_state=True)
    mamba.mamba_forward(cfg, p, x[:, :1], state=st)
    mamba.mamba_forward(cfg, p, x, use_kernel=False)
    assert {k: calls[k] - before[k] for k in calls} == {
        "mixer": 1, "mixer_local": 0, "decode": 1, "composite": 0,
        "reference": 1}
