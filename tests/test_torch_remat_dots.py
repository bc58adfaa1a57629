"""``remat_policy="dots"`` in the port (``models.forward_hidden``'s
selective checkpoint) against the reference's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.

Inputs are made with numpy from a seed and parameters carried across from
the reference (``convert.model_params_from_reference``), as in
``test_torch_train.py``, whose tolerances hold here: the loss 1e-5
relative and every gradient leaf 1e-4 normwise (float32 forward and
backward in other orders; measured: the loss at most 2.4e-7, the
leaves 1.4e-6 for gemma2, 3.8e-6 for mamba2's SSD, 1.1e-6 for grok-1 and
3.1e-5 for jamba, whose error grows back through its seven SSD layers:
against the reference's "full" it reads 3.0e-5 as well).  Within the port the policy
changes only what the backward keeps, so "dots", "full" and no remat
agree bit for bit; and the products the backward runs, counted at the
dispatcher, show that under "dots" no product with no batch dimension of
the forward is run again while the batched ones (attention scores, the
SSD's chunk products, the experts) are.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import (model_params_from_reference,  # noqa: E402
                                 model_params_to_reference)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.train.data import DataConfig, batch_at, to_device  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCHS = ["gemma2-27b", "mamba2-2.7b", "jamba-v0.1-52b", "grok-1-314b"]


def _cfgs(arch):
    kw = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
    return (ref_configs.reduced(ref_configs.get_config(arch), **kw),
            configs.reduced(configs.get_config(arch), **kw))


def _model(cfg, ref_params):
    model = model_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    return model


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


def _batch(cfg, seed=0, b=4, s=32):
    return batch_at(DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                               seed=seed), 0)


def _setup(arch, seed=0):
    ref_cfg, cfg = _cfgs(arch)
    ref_params = ref_models.init_params(ref_cfg, jax.random.PRNGKey(seed),
                                        dtype=jnp.float32)
    return ref_cfg, cfg, ref_params, _model(cfg, ref_params)


def _loss(cfg, model, tb, policy):
    """The training loss under ``policy``: "none" runs the periods without
    remat (the chunked cross entropy as ``loss_fn``'s)."""
    if policy == "none":
        x = models.forward_hidden(cfg, model, tb["inputs"])
        return models.chunked_cross_entropy(cfg, model, x, tb["labels"])
    return models.loss_fn(cfg, model, tb["inputs"], tb["labels"],
                          remat_policy=policy)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_loss_and_every_gradient_match_the_reference(arch):
    ref_cfg, cfg, ref_params, model = _setup(arch)
    batch = _batch(cfg)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: ref_models.loss_fn(ref_cfg, p, jnp.asarray(batch["inputs"]),
                                     jnp.asarray(batch["labels"]),
                                     remat_policy="dots"))(ref_params)
    tb = to_device(batch, CPU)
    loss = _loss(cfg, model, tb, "dots")
    assert abs(float(loss.detach()) - float(ref_loss)) <= \
        1e-5 * abs(float(ref_loss))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    n = 0
    for path, g, w in _pairs(model_params_to_reference(cfg, model, grads),
                             _plain(ref_grads)):
        assert g.shape == w.shape, path
        assert _normwise(g, w) <= 1e-4, path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(ref_params))


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_equals_full_and_no_remat_bit_for_bit(arch):
    _, cfg, _, model = _setup(arch, seed=1)
    tb = to_device(_batch(cfg, seed=1), CPU)
    leaves = list(model.parameters())
    runs = {}
    for policy in ("none", "full", "dots"):
        loss = _loss(cfg, model, tb, policy)
        runs[policy] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], runs["none"][0]), policy
        for a, b in zip(runs[policy][1], runs["none"][1]):
            assert torch.equal(a, b), policy


class _Products(TorchDispatchMode):
    """Counts the products that reach the dispatcher: ``mm`` and a ``bmm``
    over a batch of one (products with no batch dimension) apart from the
    batched ``bmm``."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.counts["no_batch"] += 1
        elif func is torch.ops.aten.bmm.default:
            self.counts["no_batch" if args[0].shape[0] == 1
                        else "batched"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_recomputes_no_product_without_a_batch_dimension(arch):
    """The backward under "dots" runs exactly the products of the backward
    without remat: the forward's products with no batch dimension are kept,
    none is run again; under "full" they are run again.  The batched
    products are recomputed under both policies."""
    _, cfg, _, model = _setup(arch, seed=2)
    tb = to_device(_batch(cfg, seed=2), CPU)
    leaves = list(model.parameters())
    with _Products() as fwd:
        models.forward_hidden(cfg, model, tb["inputs"])
    assert fwd.counts["no_batch"] > 0 and fwd.counts["batched"] > 0
    bwd = {}
    for policy in ("none", "full", "dots"):
        loss = _loss(cfg, model, tb, policy)
        with _Products() as mode:
            torch.autograd.grad(loss, leaves)
        bwd[policy] = mode.counts
    # a period's recompute stops after the last op whose output its
    # backward keeps, so each period's final product may not run again
    assert bwd["full"]["no_batch"] - bwd["none"]["no_batch"] >= \
        fwd.counts["no_batch"] - models.n_periods(cfg)
    assert bwd["dots"]["no_batch"] == bwd["none"]["no_batch"]
    assert bwd["dots"]["batched"] == bwd["full"]["batched"] > \
        bwd["none"]["batched"]


@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_under_dots_equals_full(arch):
    _, cfg, ref_params, _ = _setup(arch, seed=3)
    batch = to_device(_batch(cfg, seed=3), CPU)
    out = {}
    for policy in ("full", "dots"):
        model = _model(cfg, ref_params)
        opt = AdamW(lr=1e-3)
        state = opt.init(list(model.parameters()))
        step = make_train_step(cfg, opt, remat_policy=policy)
        _, state, loss = step(model, state, batch)
        out[policy] = (loss, [p.detach() for p in model.parameters()],
                       state)
    assert torch.equal(out["full"][0], out["dots"][0])
    for a, b in zip(out["full"][1], out["dots"][1]):
        assert torch.equal(a, b)
    for a, b in zip(out["full"][2].mu + out["full"][2].nu,
                    out["dots"][2].mu + out["dots"][2].nu):
        assert torch.equal(a, b)
