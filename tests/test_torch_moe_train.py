"""MoE training with tokens dropped: the port's ``moe_forward`` /
``moe_forward_einsum`` under autograd, ``loss_fn`` and one
``make_train_step`` update against the reference's at capacity factor
1.0, where experts drop choices.

``configs.reduced`` makes every MoE lossless (capacity factor E / k, so
no choice is ever dropped); each case here sets ``moe_capacity_factor =
1.0`` on both packages' configs with ``dataclasses.replace``, and first
asserts that the reference's routing drops at least one choice at its
seed, so the comparison cannot be vacuous.  The reference's routing (its
``moe_forward`` does not return it) is its own lines restated in jax
(:func:`_ref_route`: softmax, ``jax.lax.top_k``, positions by a cumsum
over (token, choice) order, per data shard).

Inputs are made with numpy from a seed and parameters carried across from
the reference (``convert.model_params_from_reference``).  Tolerances,
each measured here first.  One MoE layer on the same tokens: the routing
(experts, positions, keep) exactly and the gates 1e-6; the output 1e-5
and each gradient (the router, the three expert weights, the input) 1e-4
normwise (measured at most 1.4e-7 and 2.8e-7).  The whole model: each MoE
layer's routing of its own input exactly and the gates 1e-5 (the inputs
differ in the last bits; measured 3.5e-6); ``loss_fn`` 1e-5 relative and
every gradient leaf 1e-4 normwise, ``test_torch_train.py``'s (measured
1.6e-7 and 2.0e-5, jamba's, whose error grows back through its seven SSD
layers as it does without drops); one ``make_train_step`` update: the
loss 1e-5 and each new parameter 1e-4 normwise, as that file's five
steps (measured 1.6e-7 and 7.0e-5, on a norm scale that starts at zero,
so that its new value is the AdamW update alone).
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
import repro.models.transformer as ref_transformer  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.train import optimizer as ref_optimizer  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import (model_params_from_reference,  # noqa: E402
                                 model_params_to_reference)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train.data import DataConfig, batch_at, to_device  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: (arch, what ``dataclasses.replace`` sets on both configs besides the
#: capacity factor): jamba's einsum dispatch and the scatter one, grok-1's
#: scatter on one shard and on two, arctic's MoE beside a dense FFN
CASES = [
    ("jamba-v0.1-52b", {}),
    ("jamba-v0.1-52b", {"moe_impl": "scatter"}),
    ("grok-1-314b", {}),
    ("grok-1-314b", {"moe_data_shards": 2}),
    ("arctic-480b", {}),
]
IDS = ["jamba-einsum", "jamba-scatter", "grok1", "grok1-shards2",
       "arctic-moe+dense"]
CAPACITY_FACTOR = 1.0


def _cfgs(arch, extra):
    kw = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
    extra = dict(extra, moe_capacity_factor=CAPACITY_FACTOR)
    return (dataclasses.replace(
        ref_configs.reduced(ref_configs.get_config(arch), **kw), **extra),
        dataclasses.replace(
        configs.reduced(configs.get_config(arch), **kw), **extra))


def _plain(tree):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _pairs(got, want, path=""):
    assert set(got) == set(want), (path, set(got), set(want))
    for k in sorted(want):
        if isinstance(want[k], dict):
            yield from _pairs(got[k], want[k], f"{path}/{k}")
        else:
            yield f"{path}/{k}", got[k], want[k]


def _normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _shards(cfg, t: int) -> int:
    """The data shards a call of ``t`` tokens routes over (both packages:
    ``moe_data_shards`` for the scatter dispatch when it divides t)."""
    if cfg.moe_impl == "einsum":
        return 1
    d = max(1, cfg.moe_data_shards)
    return 1 if t % d else d


def _capacity(cfg, tl: int) -> int:
    return max(1, int(math.ceil(cfg.moe_capacity_factor * cfg.top_k * tl /
                                cfg.n_experts)))


def _ref_route(ref_cfg, x, router):
    """The reference's routing of tokens ``x`` (b, s, d), restated from
    ``src/repro/models/moe.py`` in jax: (gates, experts, pos, keep), each
    (D, t / D, k) over the call's data shards."""
    b, s, d = x.shape
    e, k = ref_cfg.n_experts, ref_cfg.top_k
    D = _shards(ref_cfg, b * s)
    tl = b * s // D
    xt = jnp.asarray(x).reshape(D, tl, d)
    logits = jnp.einsum("Dtd,de->Dte", xt, jnp.asarray(router)).astype(
        jnp.float32)
    gate_vals, experts = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    onehot = jax.nn.one_hot(experts, e, dtype=jnp.int32)
    flat = onehot.reshape(D, tl * k, e)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(D, tl, k, e)
    pos = (pos * onehot).sum(-1)
    keep = pos < _capacity(ref_cfg, tl)
    return tuple(np.asarray(a) for a in (gate_vals, experts, pos, keep))


def _port_route(cfg, x, router):
    """The port's routing (``moe._route``) of the same tokens, viewed as
    its ``moe_forward`` views them."""
    b, s, d = x.shape
    D = _shards(cfg, b * s)
    tl = b * s // D
    xt = torch.tensor(np.asarray(x)).reshape(D, tl, d)
    out = moe._route(xt @ torch.tensor(np.asarray(router)), cfg.top_k,
                     cfg.n_experts, _capacity(cfg, tl))
    return tuple(a.numpy() for a in out)


def _assert_same_routing(ref_cfg, cfg, ref_x, x, router,
                         gate_tol: float) -> int:
    """The port's routing of ``x`` equals the reference's of ``ref_x``
    (the same tokens, or each package's own MoE input in a model), the
    gates within ``gate_tol``; returns the count of dropped choices, which
    must be positive."""
    want = _ref_route(ref_cfg, ref_x, router)
    got = _port_route(cfg, x, router)
    for name, g, w in zip(("experts", "pos", "keep"), got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=gate_tol)
    dropped = int((~want[3]).sum())
    assert dropped > 0, "no choice dropped: the case would be vacuous"
    return dropped


@pytest.mark.parametrize("arch,extra", CASES, ids=IDS)
def test_moe_routing_output_and_gradients_drop_as_the_reference(arch, extra):
    """One MoE layer on random tokens: the same routing (with drops), the
    same output, and under autograd the same gradients of the router, the
    expert weights and the input (so the dropped rows' scatter and the
    ``keep`` mask route no gradient), as ``jax.value_and_grad``."""
    ref_cfg, cfg = _cfgs(arch, extra)
    rng = np.random.default_rng(11)
    p = ref_moe.init_moe(ref_cfg, jax.random.PRNGKey(5), jnp.float32)
    x = rng.standard_normal((4, 32, ref_cfg.d_model)).astype(np.float32)
    w_out = rng.standard_normal(x.shape).astype(np.float32)
    _assert_same_routing(ref_cfg, cfg, x, x, p.router, 1e-6)

    def ref_obj(p, x):
        y = ref_moe.moe_forward(ref_cfg, p, x)
        return jnp.sum(y * w_out), y

    (_, ref_y), ref_g = jax.value_and_grad(ref_obj, argnums=(0, 1),
                                           has_aux=True)(p, jnp.asarray(x))
    mp = moe.MoEParams(**{k: torch.tensor(np.asarray(v))
                          for k, v in p._asdict().items()})
    leaves = [mp.router, mp.w_gate, mp.w_up, mp.w_down]
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = moe.moe_forward(cfg, mp, tx)
    assert _normwise(y.detach().numpy(), ref_y) <= 1e-5
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(w_out)),
                              leaves + [tx])
    want = [ref_g[0].router, ref_g[0].w_gate, ref_g[0].w_up,
            ref_g[0].w_down, ref_g[1]]
    for name, g, w in zip(("router", "w_gate", "w_up", "w_down", "x"), got,
                          want):
        assert _normwise(g.numpy(), w) <= 1e-4, name


def _capture(module, monkeypatch, store, jax_side: bool):
    """Record every MoE input of a forward: the port's (``transformer``'s
    ``moe_forward``) or the reference's (through ``jax.debug.callback``,
    inside its scan over periods)."""
    inner = module.moe_forward

    def recording(cfg, p, h, *args, **kwargs):
        if jax_side:
            jax.debug.callback(lambda v, r: store.append(
                (np.asarray(v), np.asarray(r))), h, p.router)
        else:
            store.append((h.detach().numpy(), p.router.detach().numpy()))
        return inner(cfg, p, h, *args, **kwargs)

    monkeypatch.setattr(module, "moe_forward", recording)


@pytest.mark.parametrize("arch,extra", CASES, ids=IDS)
def test_moe_model_loss_gradients_and_step_drop_as_the_reference(
        arch, extra, monkeypatch):
    """The whole reduced model at capacity factor 1.0: every MoE layer's
    routing of its own input equal to the reference's, with choices
    dropped; ``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad``; one ``make_train_step`` AdamW update against
    the reference's."""
    ref_cfg, cfg = _cfgs(arch, extra)
    ref_params = ref_models.init_params(ref_cfg, jax.random.PRNGKey(7),
                                        dtype=jnp.float32)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                                seed=7), 0)
    model = model_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    tb = to_device(batch, CPU)

    ref_in, port_in = [], []
    with monkeypatch.context() as m:
        _capture(ref_transformer, m, ref_in, jax_side=True)
        _capture(transformer, m, port_in, jax_side=False)
        jax.block_until_ready(ref_transformer.forward_hidden(
            ref_cfg, ref_params, jnp.asarray(batch["inputs"])))
        with torch.no_grad():
            models.forward_hidden(cfg, model, tb["inputs"])
    n_moe = sum(s.ffn in ("moe", "moe+dense") for s in cfg.layer_specs())
    assert len(ref_in) == len(port_in) == n_moe
    for (rx, rr), (px, pr) in zip(ref_in, port_in):
        np.testing.assert_array_equal(pr, rr)
        _assert_same_routing(ref_cfg, cfg, rx, px, rr, 1e-5)

    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: ref_models.loss_fn(ref_cfg, p, jnp.asarray(batch["inputs"]),
                                     jnp.asarray(batch["labels"])))(
        ref_params)
    for p in model.parameters():
        p.requires_grad_(True)
    loss = models.loss_fn(cfg, model, tb["inputs"], tb["labels"])
    assert abs(float(loss.detach()) - float(ref_loss)) <= \
        1e-5 * abs(float(ref_loss))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    n = 0
    for path, g, w in _pairs(model_params_to_reference(cfg, model, grads),
                             _plain(ref_grads)):
        assert _normwise(g, w) <= 1e-4, path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(ref_params))

    opt_kw = dict(lr=1e-3)
    ref_opt = ref_optimizer.AdamW(**opt_kw)
    ref_new, _, ref_step_loss = jax.jit(ref_steps.make_train_step(
        ref_cfg, ref_opt))(ref_params, ref_opt.init(ref_params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    opt = AdamW(**opt_kw)
    _, _, step_loss = make_train_step(cfg, opt)(
        model, opt.init(list(model.parameters())), tb)
    assert abs(float(step_loss) - float(ref_step_loss)) <= \
        1e-5 * abs(float(ref_step_loss))
    for path, g, w in _pairs(model_params_to_reference(cfg, model),
                             _plain(ref_new)):
        assert _normwise(g, w) <= 1e-4, path
