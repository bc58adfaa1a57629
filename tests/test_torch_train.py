"""The port's training substrate (``repro_torch.train``,
``repro_torch.launch``, ``models.loss_fn``) against the reference's
(``repro.train``, ``repro.launch.steps``), and the reference's own
training tests run on the port.

Inputs are made with numpy from a seed, and parameters carried across from
the reference (``convert.model_params_from_reference``; gradients and
trained parameters come back through ``model_params_to_reference``), so
both packages see the same numbers.  Tolerances, each measured here first:
the data, the int8 compression and the checkpoints are bit for bit; one
AdamW update 1e-6 of the update's scale (float32, the same arithmetic in
another summation order for the clip's norm; measured at most 3.6e-7);
``loss_fn`` 1e-5 relative and every gradient leaf 1e-4 normwise (float32
forward and backward in other orders; measured 0 and at most 1.4e-6);
five steps of ``train`` 1e-4 relative on the losses and 1e-4 normwise on
each final parameter (measured at most 1.7e-7 and 7.3e-7; before the
port decayed the layers' norm scales as the reference's stacked tree
does, the norms read 7.2e-5).
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
from repro.train import compression as ref_compression  # noqa: E402
from repro.train import data as ref_data  # noqa: E402
from repro.train import optimizer as ref_optimizer  # noqa: E402
from repro.train import train_loop as ref_loop  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import (model_params_from_reference,  # noqa: E402
                                 model_params_to_reference)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.steps import decayed, make_train_step  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train.compression import (compress_tree,  # noqa: E402
                                           decompress_tree, init_error)
from repro_torch.train.data import (DataConfig, batch_at,  # noqa: E402
                                    to_device)
from repro_torch.train.optimizer import AdamW, apply_updates  # noqa: E402
from repro_torch.train.train_loop import TrainConfig, train  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCHS = ["gemma2-27b", "deepseek-7b"]


def _cfgs(arch):
    """The reference's reduced config and the port's (``test_train.py``'s
    sizes)."""
    kw = dict(n_layers=2, d_model=64, d_ff=128, vocab=256)
    return (ref_configs.reduced(ref_configs.get_config(arch), **kw),
            configs.reduced(configs.get_config(arch), **kw))


def _ref_params(ref_cfg, seed=0):
    return ref_models.init_params(ref_cfg, jax.random.PRNGKey(seed),
                                  dtype=jnp.float32)


def _model(cfg, ref_params, grad=True):
    model = model_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    for p in model.parameters():
        p.requires_grad_(grad)
    return model


def _plain(tree):
    """A reference tree as nested dicts of float32 numpy arrays (its
    parameter tuples as dicts by field)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _pairs(got, want, path=""):
    """(path, got leaf, want leaf) over two trees of the same structure."""
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
    dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=seed)
    return batch_at(dc, 0)


# ------------------------------------------------------------------- data --

@pytest.mark.parametrize("dc", [
    dict(vocab=256, seq_len=32, global_batch=4, seed=7),
    dict(vocab=256000, seq_len=128, global_batch=2, seed=0),
    dict(vocab=64, seq_len=16, global_batch=3, seed=1, frontend_dim=8),
])
def test_batch_at_equals_the_reference_bit_for_bit(dc):
    for step in (0, 5, 123):
        mine = batch_at(DataConfig(**dc), step)
        ref = ref_data.batch_at(ref_data.DataConfig(**dc), step)
        assert mine.keys() == ref.keys()
        for k in ref:
            assert mine[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(mine[k], ref[k])
    dev = to_device(mine, CPU)
    assert dev["labels"].dtype == torch.int64
    want = torch.float32 if dc.get("frontend_dim") else torch.int64
    assert dev["inputs"].dtype == want


def test_data_determinism_and_skip_ahead():
    dc = DataConfig(vocab=256, seq_len=32, global_batch=4, seed=7)
    b1, b2, b3 = batch_at(dc, 5), batch_at(dc, 5), batch_at(dc, 6)
    np.testing.assert_array_equal(b1["inputs"], b2["inputs"])
    assert not np.array_equal(b1["inputs"], b3["inputs"])
    np.testing.assert_array_equal(b1["inputs"][:, 1:], b1["labels"][:, :-1])


# -------------------------------------------------------------- optimizer --

def _grad_like(rng, shapes, scale):
    return [(rng.standard_normal(sh) * scale).astype(np.float32)
            for sh in shapes]


def test_adamw_update_matches_the_reference_with_the_clip_active():
    rng = np.random.default_rng(0)
    shapes = [(16, 24), (24,), (3, 8, 5), (7,)]
    params = _grad_like(rng, shapes, 1.0)
    opt_kw = dict(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
    ref_opt, opt = ref_optimizer.AdamW(**opt_kw), AdamW(**opt_kw)
    ref_state = ref_opt.init([jnp.asarray(p) for p in params])
    state = opt.init([torch.from_numpy(p) for p in params])
    for step in range(3):
        grads = _grad_like(rng, shapes, 2.0)     # global norm ~ 50: clipped
        assert np.sqrt(sum((g ** 2).sum() for g in grads)) > 10
        ref_upd, ref_state = ref_opt.update([jnp.asarray(g) for g in grads],
                                            ref_state,
                                            [jnp.asarray(p) for p in params])
        tparams = [torch.from_numpy(p.copy()) for p in params]
        upd, state = opt.update([torch.from_numpy(g) for g in grads], state,
                                tparams)
        assert int(state.step) == step + 1
        for u, ru in zip(upd, ref_upd):
            ru = np.asarray(ru)
            np.testing.assert_allclose(u.numpy(), ru, rtol=0,
                                       atol=1e-6 * np.abs(ru).max())
        for mine, ref in zip(state.mu + state.nu,
                             list(ref_state.mu) + list(ref_state.nu)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max())
        apply_updates(tparams, upd)
        params = [p.numpy() for p in tparams]


def test_adamw_keeps_moments_in_float32_and_updates_in_the_param_dtype():
    p = torch.randn(8, 4, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    opt = AdamW(lr=1e-2)
    state = opt.init([p])
    assert state.mu[0].dtype == torch.float32
    upd, state = opt.update([torch.ones_like(p)], state, [p])
    assert upd[0].dtype == torch.bfloat16
    before = p.clone()
    apply_updates([p], upd)
    assert torch.equal(p, before + upd[0])


def test_adamw_slices_do_not_change_the_update(monkeypatch):
    from repro_torch.train import optimizer
    rng = np.random.default_rng(1)
    p, g = (torch.from_numpy(a) for a in _grad_like(rng, [(40, 30)] * 2, 1))
    whole, _ = AdamW().update([g], AdamW().init([p]), [p])
    monkeypatch.setattr(optimizer, "SLICE", 7)
    sliced, _ = AdamW().update([g], AdamW().init([p]), [p])
    assert torch.equal(whole[0], sliced[0])


# ------------------------------------------------------------ compression --

def test_compression_equals_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    shapes = [(64, 33), (7,), (2048,), (3, 5, 101)]
    grads = _grad_like(rng, shapes, 1.0)
    grads[2][17] = 0.0
    grads[2][1024:] = 0.0                 # an all-zero chunk: scale 1e-12
    err = init_error([torch.from_numpy(g) for g in grads])
    ref_err = ref_compression.init_error([jnp.asarray(g) for g in grads])
    for _ in range(2):                    # the second round carries error
        q, err = compress_tree([torch.from_numpy(g) for g in grads], err)
        ref_q, ref_err = ref_compression.compress_tree(
            [jnp.asarray(g) for g in grads], ref_err)
        for (codes, scale), (rc, rs) in zip(q, ref_q):
            assert codes.dtype == torch.int8
            np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
            np.testing.assert_array_equal(scale.numpy(), np.asarray(rs))
        for e, re_ in zip(err, ref_err):
            np.testing.assert_array_equal(e.numpy(), np.asarray(re_))
        deq = decompress_tree(q, [torch.from_numpy(g) for g in grads])
        ref_deq = ref_compression.decompress_tree(
            ref_q, [jnp.asarray(g) for g in grads])
        for d, rd in zip(deq, ref_deq):
            np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
        grads = _grad_like(rng, shapes, 1.0)


def test_compression_roundtrip_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 33)).astype(np.float32))
    q, err1 = compress_tree([g, torch.zeros(7)], init_error([g,
                                                            torch.zeros(7)]))
    deq = decompress_tree(q, [g, torch.zeros(7)])
    assert float(torch.linalg.norm(deq[0] - g) / torch.linalg.norm(g)) < 0.02
    np.testing.assert_allclose(err1[0].numpy(), (g - deq[0]).numpy(),
                               atol=1e-6)


# ------------------------------------------------------------ loss, grads --

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_params = _ref_params(ref_cfg)
    batch = _batch(cfg)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: ref_models.loss_fn(ref_cfg, p, jnp.asarray(batch["inputs"]),
                                     jnp.asarray(batch["labels"])))(
        ref_params)
    model = _model(cfg, ref_params)
    tb = to_device(batch, CPU)
    loss = models.loss_fn(cfg, model, tb["inputs"], tb["labels"])
    assert abs(float(loss.detach()) - float(ref_loss)) <= \
        1e-5 * abs(float(ref_loss))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = model_params_to_reference(cfg, model, grads)
    n = 0
    for path, g, w in _pairs(got, _plain(ref_grads)):
        assert g.shape == w.shape, path
        assert _normwise(g, w) <= 1e-4, path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(ref_params))


@pytest.mark.parametrize("arch", ARCHS)
def test_five_steps_of_train_match_the_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_params = _ref_params(ref_cfg, seed=1)
    model = _model(cfg, ref_params)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=3)
    ref_dc = ref_data.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                                 seed=3)
    ref_out, _, ref_rep = ref_loop.train(ref_cfg, ref_dc,
                                         ref_loop.TrainConfig(steps=5),
                                         params=ref_params)
    out, _, rep = train(cfg, dc, TrainConfig(steps=5), params=model,
                        device="cpu")
    assert out is model and len(rep.losses) == 5
    np.testing.assert_allclose(rep.losses, ref_rep.losses, rtol=1e-4)
    for path, g, w in _pairs(model_params_to_reference(cfg, out),
                             _plain(ref_out)):
        assert _normwise(g, w) <= 1e-4, path


# ------------------------------------------------ the model's new options --

def test_remat_and_chunked_cross_entropy_change_nothing():
    _, cfg = _cfgs("gemma2-27b")
    cfg = dataclasses.replace(cfg, n_layers=4)
    model = models.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    tb = to_device(_batch(cfg, s=64), CPU)
    plain = models.forward_hidden(cfg, model, tb["inputs"])
    remat = models.forward_hidden(cfg, model, tb["inputs"], remat=True)
    assert torch.equal(plain, remat)
    leaves = list(model.parameters())
    g_plain = torch.autograd.grad(plain.square().mean(), leaves)
    g_remat = torch.autograd.grad(remat.square().mean(), leaves)
    for a, b in zip(g_plain, g_remat):
        assert torch.equal(a, b)
    with torch.no_grad():
        logits = models.forward(cfg, model, tb["inputs"])
        full = float(models.cross_entropy(logits, tb["labels"]))
        for chunk in (16, 64, 512):
            ce = models.chunked_cross_entropy(cfg, model, plain.detach(),
                                              tb["labels"], chunk=chunk)
            assert abs(float(ce) - full) <= 1e-6 * full
    with pytest.raises(ValueError, match="divide"):
        models.chunked_cross_entropy(cfg, model, plain, tb["labels"],
                                     chunk=24)
    with pytest.raises(NotImplementedError, match="dots"):
        models.loss_fn(cfg, model, tb["inputs"], tb["labels"],
                       remat_policy="dots")
    with pytest.raises(ValueError):
        models.forward_hidden(cfg, model, tb["inputs"], remat=True,
                              remat_policy="fancy")


def test_model_params_to_reference_inverts_from_reference():
    for arch in ("gemma2-27b", "jamba-v0.1-52b"):
        ref_cfg, cfg = _cfgs(arch)
        tree = _plain(_ref_params(ref_cfg))
        back = model_params_to_reference(cfg, _model(cfg, tree))
        for path, g, w in _pairs(back, tree):
            np.testing.assert_array_equal(g, w, err_msg=path)


def test_decay_follows_the_reference_trees_ranks():
    """The reference decays every leaf of more than one dimension, and
    stacks a block's leaves over periods: a layer's norm scales decay, the
    final norm does not."""
    for arch in ARCHS + ["jamba-v0.1-52b"]:
        ref_cfg, cfg = _cfgs(arch)
        ref_params = _plain(_ref_params(ref_cfg))
        model = _model(cfg, ref_params)
        flags = model_params_to_reference(
            cfg, model, [torch.tensor(float(f)) for f in decayed(model)])
        for path, flag, leaf in _pairs(flags, ref_params):
            assert np.all(flag == float(leaf.ndim > 1)), path
        named = dict(zip((n for n, _ in model.named_parameters()),
                         decayed(model)))
        assert named["blocks.0.ln1"] and not named["final_norm"]


def test_accumulated_step_matches_one_batch():
    """Two micro-batches of 2 give the loss and (within float32 rounding)
    the update of one batch of 4."""
    _, cfg = _cfgs("deepseek-7b")
    batch = to_device(_batch(cfg), CPU)
    losses, params = [], []
    for accum in (1, 2):
        model = models.init_params(cfg, torch.Generator().manual_seed(0),
                                   torch.float32, device="cpu")
        for p in model.parameters():
            p.requires_grad_(True)
        opt = AdamW(lr=1e-3)
        state = opt.init(list(model.parameters()))
        step = make_train_step(cfg, opt, accum_steps=accum)
        _, _, loss = step(model, state, batch)
        losses.append(float(loss))
        params.append([p.detach().clone() for p in model.parameters()])
    assert abs(losses[0] - losses[1]) <= 1e-6 * losses[0]
    for a, b in zip(*params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_step_leaves_everything_as_it_was_on_a_nonfinite_loss():
    _, cfg = _cfgs("deepseek-7b")
    model = models.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
    with torch.no_grad():
        model.final_norm.fill_(float("nan"))
    for p in model.parameters():
        p.requires_grad_(True)
    before = [p.detach().clone() for p in model.parameters()]
    opt = AdamW()
    state = opt.init(list(model.parameters()))
    _, new_state, loss = make_train_step(cfg, opt)(
        model, state, to_device(_batch(cfg), CPU))
    assert math.isnan(float(loss))
    assert new_state is state and int(state.step) == 0
    assert all(float(m.abs().sum()) == 0 for m in state.mu + state.nu)
    for a, b in zip(before, model.parameters()):
        assert torch.equal(a, b.detach()) or (a.isnan().all() and
                                              b.isnan().all())


# --------------------------------------- the reference's tests, on the port --

def _small():
    return configs.reduced(configs.get_config("deepseek-7b"), n_layers=2,
                           d_model=64, d_ff=128, vocab=256)


def test_loss_decreases():
    cfg = _small()
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    _, _, report = train(cfg, dc, TrainConfig(steps=30), device="cpu")
    assert len(report.losses) == 30
    assert report.losses[-1] < report.losses[0]
    assert not report.skipped_nan_steps


def test_checkpoint_roundtrip_and_crc(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4))}}
    ck.save(str(tmp_path), 3, tree)
    like = {"a": torch.zeros(10), "b": {"c": torch.zeros((3, 4))}}
    restored, step = ck.restore(str(tmp_path), like)
    assert step == 3 and restored is like
    assert torch.equal(like["a"], tree["a"])
    assert torch.equal(like["b"]["c"], tree["b"]["c"])
    victim = next(tmp_path.glob("step_*/arr_00000.npy"))
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0xFF
    victim.write_bytes(bytes(data))
    assert ck.latest_step(str(tmp_path)) is None
    with pytest.raises(IOError):
        ck.restore(str(tmp_path), like, step=3)


def test_checkpoint_falls_back_to_the_previous_valid_step(tmp_path):
    for s in (1, 2):
        ck.save(str(tmp_path), s, {"w": torch.full((5,), float(s))})
    assert (tmp_path / "LATEST").read_text() == "step_000000002"
    victim = tmp_path / "step_000000002" / "arr_00000.npy"
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0x01
    victim.write_bytes(bytes(data))
    assert ck.latest_step(str(tmp_path)) == 1
    like = {"w": torch.zeros(5)}
    _, step = ck.restore(str(tmp_path), like)
    assert step == 1 and torch.equal(like["w"], torch.ones(5))


def test_checkpoint_keep_n_and_latest(tmp_path):
    tree = {"a": torch.zeros(4)}
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, tree, keep=2)
    dirs = sorted(p.name for p in tmp_path.glob("step_*"))
    assert dirs == ["step_000000004", "step_000000005"]
    assert ck.latest_step(str(tmp_path)) == 5


def test_checkpoint_keeps_a_bfloat16_leaf_bit_for_bit(tmp_path):
    w = torch.randn(6, 7, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    tree = (w, {"n": torch.arange(3, dtype=torch.int32)})
    path = ck.save(str(tmp_path), 0, tree)
    manifest = (path / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest and '"dtype": "int32"' in manifest
    like = (torch.zeros(6, 7, dtype=torch.bfloat16),
            {"n": torch.zeros(3, dtype=torch.int32)})
    ck.restore(str(tmp_path), like)
    assert torch.equal(like[0].view(torch.int16), w.view(torch.int16))
    with pytest.raises(ValueError, match="dtype"):
        ck.restore(str(tmp_path), (torch.zeros(6, 7), like[1]))


def test_async_checkpointer_snapshots_before_it_returns(tmp_path):
    w = torch.arange(100.0)
    ac = ck.AsyncCheckpointer(str(tmp_path))
    ac.save_async(1, {"w": w})
    w.add_(1.0)                   # an in-place update after the snapshot
    ac.wait()
    assert ck.latest_step(str(tmp_path)) == 1
    like = {"w": torch.zeros(100)}
    ck.restore(str(tmp_path), like)
    assert torch.equal(like["w"], torch.arange(100.0))


def test_resume_after_interrupt_continues_bit_for_bit(tmp_path):
    cfg = _small()
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    _, _, whole = train(cfg, dc, TrainConfig(steps=14), device="cpu")
    tc1 = TrainConfig(steps=10, ckpt_dir=str(tmp_path), ckpt_every=5)
    _, _, rep1 = train(cfg, dc, tc1, device="cpu")
    assert ck.latest_step(str(tmp_path)) == 9
    tc2 = TrainConfig(steps=14, ckpt_dir=str(tmp_path), ckpt_every=5)
    _, _, rep2 = train(cfg, dc, tc2, device="cpu")
    assert rep2.resumed_from == 9
    assert len(rep2.losses) == 4
    assert rep1.losses + rep2.losses == whole.losses


def test_nan_circuit_breaker():
    cfg = _small()
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    opt = AdamW(lr=1e-3)
    calls = {"n": 0}
    inner = make_train_step(cfg, opt)

    def poisoned(params, opt_state, batch):
        calls["n"] += 1
        p, o, loss = inner(params, opt_state, batch)
        if calls["n"] == 3:
            return p, o, torch.tensor(float("nan"))
        return p, o, loss

    _, _, report = train(cfg, dc, TrainConfig(steps=6), opt=opt,
                         train_step=poisoned, device="cpu")
    assert report.skipped_nan_steps == [2]
    assert len(report.losses) == 5


def test_train_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py phase 14 trains there")
    cfg = _small()
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, dc, TrainConfig(steps=1))


def test_launcher_trains_on_the_cpu(capsys):
    launch_train.main(["--arch", "gemma2-27b", "--device", "cpu", "--steps",
                       "3", "--seq", "32", "--batch", "2", "--d-model",
                       "64"])
    out = capsys.readouterr().out
    assert "arch=gemma2-27b-smoke layers=2 steps=3" in out
