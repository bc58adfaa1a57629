"""The block RMSNorm (``repro_torch.kernels.rmsnorm``, ``models.layers.
rmsnorm``) against the reference's, on the CPU.

On CPU tensors the kernels' wrappers run their plain versions, and
:class:`RmsNormFn`'s backward is :func:`rmsnorm_bwd_plain`.  Inputs are made
with numpy from a seed, at 1, 7 and 64 rows and the models' widths 1280,
2560 and 4608 (the kernels' vector path) and 100 (their scalar path), in
float32 and bfloat16.  Tolerances, normwise: 1e-5 in float32 (the same
operations, sums in other orders) and 4e-3 in bfloat16 (an element may
round to the neighbouring bfloat16), as chip_smoke's phase "2 mamba" holds
the mixer; the plain backward against float64 autograd at 1e-10, and
``gradcheck`` in float64.  The kernels themselves run on a card only
(``tests/test_torch_rmsnorm_cuda.py`` and chip_smoke's phase
"2 rmsnorm").
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

from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 4e-3}
ROWS = (1, 7, 64)
WIDTHS = (1280, 2560, 4608, 100)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the library's source, for its constants
CU = (Path(rn.__file__).parent / "csrc" / "rmsnorm.cu").read_text()


def _normwise(got, want) -> float:
    got = torch.as_tensor(np.asarray(got, dtype=np.float64)) \
        if not isinstance(got, torch.Tensor) else got.double()
    want = torch.as_tensor(np.asarray(want, dtype=np.float64)) \
        if not isinstance(want, torch.Tensor) else want.double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def _inputs(rows, d, dtype, seed=0):
    """x (rows, d), scale (d,) near the models' (about zero: ``1 + scale``
    is the weight) and a cotangent, as numpy float32 arrays rounded to
    ``dtype``, and the same as port tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((rows, d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32),
            rng.standard_normal((rows, d)).astype(np.float32)]
    ts = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]
    return [t.float().numpy() for t in ts], ts


def _reference(x, scale, dy, dtype):
    """The reference's forward and ``jax.vjp`` for (dx, dscale)."""
    xj, sj, dj = (jnp.asarray(a, JNP[dtype]) for a in (x, scale, dy))
    y, vjp = jax.vjp(ref_layers.rmsnorm, xj, sj)
    dx, ds = vjp(dj)
    return [np.asarray(a.astype(jnp.float32)) for a in (y, dx, ds)]


def _port(x, scale, dy, route):
    """The port's forward and gradients by ``route``: "layers" the models'
    ``rmsnorm`` (the plain route, differentiated by autograd), "kernel"
    :class:`RmsNormFn` (the kernels' plain versions, forward and
    backward)."""
    x = x.clone().requires_grad_(True)
    scale = scale.clone().requires_grad_(True)
    if route == "layers":
        y = layers.rmsnorm(x, scale)
    else:
        y = rn.RmsNormFn.apply(x, scale, rn.EPS)
    dx, ds = torch.autograd.grad(y, (x, scale), dy)
    assert dx.dtype == x.dtype and ds.dtype == scale.dtype
    return y.detach(), dx, ds


@pytest.mark.parametrize("route", ["layers", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_norm_and_gradients_match_the_reference(rows, d, dtype, route):
    arrs, ts = _inputs(rows, d, dtype, seed=rows * d)
    want = _reference(*arrs, dtype)
    got = _port(*ts, route)
    for name, g, w in zip(("y", "dx", "dscale"), got, want):
        assert _normwise(g, w) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernels_plain_forward_is_the_models_bit_for_bit(dtype):
    """``rmsnorm_fwd_plain``'s y is ``rmsnorm_plain``'s, whose operations
    are the models' norm before the kernels; on a (B, S, d) tensor and on a
    strided last-token view."""
    _, (x, scale, _) = _inputs(24, 256, "float32", seed=3)
    x, scale = x.reshape(2, 12, 256).to(dtype), scale.to(dtype)
    for xv in (x, x[:, -1:, :]):
        y, rstd = rn.rmsnorm_fwd_plain(xv, scale)
        assert torch.equal(y, rn.rmsnorm_plain(xv, scale))
        assert torch.equal(y, layers.rmsnorm(xv, scale))
        assert rstd.dtype == torch.float32 and rstd.shape == xv.shape[:-1]


def test_plain_backward_matches_float64_autograd():
    """:func:`rmsnorm_bwd_plain` against autograd of the plain forward in
    float64, over a (B, S, d) input."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 48)))
    scale = torch.from_numpy(0.1 * rng.standard_normal(48))
    dy = torch.from_numpy(rng.standard_normal((2, 5, 48)))
    xl, sl = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    y, rstd = rn.rmsnorm_fwd_plain(xl, sl)
    want = torch.autograd.grad(y, (xl, sl), dy)
    got = rn.rmsnorm_bwd_plain(dy, x, scale, rstd.detach())
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_norm_fn_passes_gradcheck():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 4, 24))).requires_grad_(True)
    scale = torch.from_numpy(0.1 * rng.standard_normal(24)).requires_grad_(
        True)
    assert torch.autograd.gradcheck(
        lambda a, b: rn.RmsNormFn.apply(a, b, rn.EPS), (x, scale), eps=1e-6,
        atol=1e-7)


# ------------------------------------------------------------- operators --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["rows", "last_token"])
def test_operators_pass_opcheck(dtype, view):
    _, (x, scale, dy) = _inputs(12, 64, "float32", seed=4)
    x, scale, dy = x.reshape(2, 6, 64).to(dtype), scale.to(dtype), \
        dy.reshape(2, 6, 64).to(dtype)
    if view == "last_token":
        x, dy = x[:, -1:, :], dy[:, -1:, :].contiguous()
    ops = torch.ops.repro_torch
    torch.library.opcheck(ops.rmsnorm_fwd, (x, scale, rn.EPS))
    _, rstd = rn.rmsnorm_fwd(x, scale)
    torch.library.opcheck(ops.rmsnorm_bwd, (dy, x, scale, rstd.contiguous()))


def test_fake_cuda_tensors_reach_the_operators(monkeypatch):
    """On fake CUDA tensors (a traced step) the norm reaches the operators'
    fake implementations, never a plain version or a launch; the outputs
    have the kernels' shapes, dtypes and contiguity, a strided last-token
    view included."""
    reached = []

    def spy(op):
        def run(*args):
            reached.append(op)
            return op(*args)
        return run

    monkeypatch.setattr(rn, "_fwd_op", spy(rn._fwd_op))
    monkeypatch.setattr(rn, "_bwd_op", spy(rn._bwd_op))
    monkeypatch.setattr(rn, "rmsnorm_fwd_plain", None)
    monkeypatch.setattr(rn, "rmsnorm_bwd_plain", None)
    before = (rn.rmsnorm_fwd.launches, rn.rmsnorm_bwd.launches)
    with FakeTensorMode():
        kw = dict(device="cuda", dtype=torch.bfloat16)
        x = torch.empty(2, 4096, 2560, **kw)
        last = torch.empty_strided((2, 1, 2560), (4096 * 2560, 2560, 1),
                                   **kw)
        scale = torch.empty(2560, **kw)
        for xv in (x, last):
            y = layers.rmsnorm(xv, scale)
            assert y.shape == xv.shape and y.dtype == torch.bfloat16
            assert y.device.type == "cuda" and y.is_contiguous()
            y, rstd = rn.rmsnorm_fwd(xv, scale)
            assert rstd.shape == xv.shape[:-1] and \
                rstd.dtype == torch.float32
            dx, ds = rn.rmsnorm_bwd(torch.empty(xv.shape, **kw), xv, scale,
                                    rstd)
            assert dx.shape == xv.shape and dx.dtype == torch.bfloat16
            assert ds.shape == (2560,) and ds.dtype == torch.float32
    assert len(reached) == 6
    assert (rn.rmsnorm_fwd.launches, rn.rmsnorm_bwd.launches) == before


def test_unsupported_inputs_raise():
    """What the kernels cannot take raises on a (fake) CUDA tensor, before
    anything launches: another dtype, scale in another dtype, a row wider
    than MAX_D, rows that do not fold into two strided levels, a strided
    last dim, a non-contiguous dy, a float64 rstd, mismatched shapes."""
    assert rn.MAX_D == int(re.search(r"constexpr int kMaxWidth = (\d+);",
                                     CU).group(1))
    with FakeTensorMode():
        kw = dict(device="cuda")
        x = torch.empty(4, 64, **kw)
        s = torch.empty(64, **kw)
        r = torch.empty(4, **kw)
        cases = [
            (lambda: rn.rmsnorm_fwd(x.double(), s.double()), "float32 or"),
            (lambda: rn.rmsnorm_fwd(x, s.bfloat16()), "scale in x's dtype"),
            (lambda: rn.rmsnorm_fwd(torch.empty(2, rn.MAX_D + 8, **kw),
                                    torch.empty(rn.MAX_D + 8, **kw)),
             "at most"),
            (lambda: rn.rmsnorm_fwd(torch.empty_strided(
                (4, 2, 2, 64), (1024, 256, 64, 1), **kw), s),
             "two strided levels"),
            (lambda: rn.rmsnorm_fwd(torch.empty_strided((4, 64), (1, 4),
                                                        **kw), s),
             "last dim is contiguous"),
            (lambda: rn.rmsnorm_bwd(torch.empty_strided((4, 64), (128, 1),
                                                        **kw), x, s, r),
             "contiguous dy"),
            (lambda: rn.rmsnorm_bwd(x, x, s, r.double()), "float32 rstd"),
            (lambda: rn.rmsnorm_fwd(x, torch.empty(32, **kw)), "disagree"),
            (lambda: rn.rmsnorm_bwd(x, x, s, torch.empty(5, **kw)),
             "rstd must be"),
        ]
        for call, match in cases:
            with pytest.raises(ValueError, match=match):
                call()
    with pytest.raises(ValueError, match="one device"):
        rn.rmsnorm_fwd(torch.empty(4, 64), torch.empty(64, device="meta"))


@pytest.mark.parametrize("shape,view,want", [
    ((2, 7, 64), None, (14, 14, 0, 64)),
    ((2, 7, 64), (slice(None), slice(-1, None)), (2, 2, 0, 448)),
    ((64,), None, (1, 1, 0, 0)),
    ((3, 4, 8, 64), (slice(None), slice(None), slice(0, 2)), (24, 2, 512,
                                                              64)),
    ((3, 4, 8, 64), (slice(None), slice(0, 2), slice(0, 2)), None),
])
def test_row_layout_folds_the_leading_dims(shape, view, want):
    x = torch.empty(shape)
    if view is not None:
        x = x[view]
    got = rn.row_layout(x)
    assert got == want
    if got is not None:       # the kernels' row r is x's r-th row
        rows, seq, sb, ss = got
        assert [(r // seq) * sb + (r % seq) * ss for r in range(rows)] == [
            x[idx].storage_offset() - x.storage_offset()
            for idx in np.ndindex(*x.shape[:-1])]


# ---------------------------------------------------------------- groups --

def test_row_groups_depend_on_the_rows_alone():
    """The backward's row groups follow the library's rule from the row
    count alone: every group holds a row, none is past the rows, at most
    the limit the source sets."""
    assert rn.BWD_BLOCKS == int(re.search(r"constexpr int kBwdBlocks = (\d+);",
                                          CU).group(1))
    for rows in (1, 2, 7, 263, 264, 265, 4095, 4096, 8192, 10 ** 6 + 1):
        nb = rn.row_groups(rows)
        per = -(-rows // min(rows, rn.BWD_BLOCKS))
        assert nb == -(-rows // per)
        assert nb <= rn.BWD_BLOCKS and (nb - 1) * per < rows <= nb * per


@pytest.mark.parametrize("shape", [(1, 1, 4608), (1, 4095, 2560),
                                   (2, 4096, 2560), (1, 4096, 8192),
                                   (3, 7, 100)])
def test_wrappers_hand_their_kernels_rows_and_scratch(monkeypatch, shape):
    """Through fake CUDA tensors each wrapper hands its kernel the row
    layout and width, and the backward a partials' scratch of as many rows
    as the library's rule gives its groups, d floats each."""
    calls = {}

    def record(name, what, *args):
        calls[name] = args

    monkeypatch.setattr(rn, "_launch", record)
    d = shape[-1]
    with FakeTensorMode():
        kw = dict(device="cuda", dtype=torch.bfloat16)
        x, s = torch.empty(shape, **kw), torch.empty(d, **kw)
        y, rstd = rn._launch_fwd(x, s, rn.EPS)
        rn._launch_bwd(torch.empty(shape, **kw), x, s, rstd)
    rows = int(np.prod(shape[:-1]))
    layout = (rows, rows, 0, d if rows > 1 else 0)   # one level of rows
    fwd, bwd = calls["repro_rmsnorm_fwd"], calls["repro_rmsnorm_bwd"]
    assert fwd[1] == 1 and fwd[2:6] == layout and fwd[6] == d
    assert bwd[2] == 1 and bwd[3:7] == layout and bwd[8] == d
    assert tuple(bwd[11].shape) == (rn.row_groups(rows), d)
    assert bwd[11].dtype == torch.float32


# ----------------------------------------------------------------- routes --

def test_routes_are_counted_and_use_kernel_false_is_plain(monkeypatch):
    """A real CPU tensor takes "plain", a fake CUDA one "kernel", and
    ``use_kernel=False`` "reference" (the plain version, on any device)."""
    calls = layers.rmsnorm.route_calls
    before = dict(calls)
    x, s = torch.randn(3, 16), torch.zeros(16)
    assert torch.equal(layers.rmsnorm(x, s),
                       layers.rmsnorm(x, s, use_kernel=False))
    monkeypatch.setattr(rn, "rmsnorm_fwd_plain", None)
    with FakeTensorMode():
        xf = torch.empty(3, 16, device="cuda")
        sf = torch.empty(16, device="cuda")
        layers.rmsnorm(xf, sf)
        layers.rmsnorm(xf, sf, use_kernel=False)
    assert {k: calls[k] - before[k] for k in calls} == {
        "plain": 1, "kernel": 1, "local": 0, "reference": 2}
    assert layers.NORM_ROUTES == ("plain", "kernel", "local", "reference")


@pytest.mark.parametrize("arch", ["gemma2-27b", "mamba2-2.7b",
                                  "jamba-v0.1-52b"])
def test_a_train_step_runs_each_norm_twice_forward(arch):
    """Under per-period remat the loss runs each block norm twice forward
    (the period's recompute) and the final norm once: chip_smoke's launch
    counts (``norm_want``) from the config."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              vocab=64)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     torch.float32, device="cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (1, 32),
                         generator=torch.Generator().manual_seed(1))
    calls = layers.rmsnorm.route_calls
    before = dict(calls)
    loss = transformer.loss_fn(cfg, params, toks, toks)
    loss.backward()
    want = chip_smoke.norm_want(cfg, 1)
    assert calls["plain"] - before["plain"] == want["rmsnorm_fwd"]
    n_norms = sum(1 + (s.ffn != "none") for s in cfg.layer_specs())
    assert want == {"rmsnorm_fwd": 2 * n_norms + 1,
                    "rmsnorm_bwd": n_norms + 1}


# ------------------------------------------------------------ distributed --

def test_dtensor_routes_on_a_world_of_one_are_bit_for_bit(tmp_path):
    """On a gloo world of one, a ``DTensor`` of real CPU tensors takes the
    "plain" route (the plain version in ``DTensor``'s ops) and gives the
    plain tensor's bits; the "local" route's ``local_map`` (what a
    ``DTensor`` of CUDA or fake tensors takes) gives the unsharded kernel
    route's bits (:class:`RmsNormFn`, here its plain versions), forward
    and both gradients, y on x's placements."""
    import functools
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed import local
    _, (x, scale, dy) = _inputs(12, 64, "float32", seed=5)
    x, dy = x.reshape(2, 6, 64), dy.reshape(2, 6, 64)
    on_tensor = functools.partial(layers._norm_on_tensor, eps=rn.EPS)
    routes = {"plain": (layers.rmsnorm, layers.rmsnorm),
              "local": (functools.partial(local.rmsnorm, on_tensor),
                        on_tensor)}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        pl = [Shard(0), Shard(1)]
        dyd = distribute_tensor(dy, mesh, pl)
        calls = layers.rmsnorm.route_calls
        for how, (sharded, unsharded) in routes.items():
            xl = x.clone().requires_grad_(True)
            sl = scale.clone().requires_grad_(True)
            yl = unsharded(xl, sl)
            want = (yl, *torch.autograd.grad(yl, (xl, sl), dy))
            xd = distribute_tensor(x, mesh, pl).requires_grad_(True)
            sd = distribute_tensor(scale, mesh, [Replicate(), Replicate()]
                                   ).requires_grad_(True)
            before = calls["plain"]
            y = sharded(xd, sd)
            assert calls["plain"] == before + (how == "plain")
            assert tuple(y.placements) == tuple(pl)
            got = (y, *torch.autograd.grad(y, (xd, sd), dyd))
            for g, w in zip(got, want):
                assert torch.equal(g.full_tensor(), w), how
    finally:
        dist.destroy_process_group()


def test_sharded_cuda_or_fake_tensors_take_the_local_route():
    """On a fake process group, a ``DTensor`` of fake tensors (the dry
    run's) takes "local"; one of real CPU tensors "plain"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2))
        pl = [Shard(0), Replicate()]
        x = DTensor.from_local(torch.zeros(2, 4, 8), mesh, pl)
        assert layers.norm_route(x, True) == "plain"
        with FakeTensorMode():
            xf = DTensor.from_local(torch.zeros(2, 4, 8), mesh, pl)
            assert layers.norm_route(xf, True) == "local"
            assert layers.norm_route(xf, False) == "reference"
    finally:
        dist.destroy_process_group()
