"""The port's model modules (``repro_torch.models``) against the
reference's, one module at a time, and the route each call takes.

Inputs are made with numpy from a seed and parameters carried across from
the reference, so both packages see the same numbers.  Tolerances:
``rtol = atol = 1e-4`` for the float32 layers, attention and Mamba (sums in
other orders), and the reference's own 2e-5 for MoE
(``tests/test_cache_and_moe.py``).  The attention and SSD calls reach the
kernel wrappers, which on the CPU run the kernels' plain versions; the one
``cuda``-marked test runs the kernels themselves on a card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.models import attention, layers, mamba, moe  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4
MOE_TOL = 2e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(mine, ref, tol=TOL):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def _cfgs(arch, **replace):
    ref = ref_configs.reduced(ref_configs.get_config(arch))
    mine = configs.reduced(configs.get_config(arch))
    return (dataclasses.replace(ref, **replace),
            dataclasses.replace(mine, **replace))


def _fields(group, ref_tuple):
    """A reference parameter tuple as numpy arrays and as port tensors."""
    arrays = {k: np.asarray(v) for k, v in ref_tuple._asdict().items()}
    return arrays, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


# ----------------------------------------------------------------- layers --

def test_layers_match_reference():
    rng = _rng(0)
    x, scale = _normal(rng, (2, 8, 32)), _normal(rng, (32,), 0.1)
    _close(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    ws = [_normal(rng, sh, 0.2) for sh in ((32, 48), (32, 48), (48, 32))]
    _close(layers.swiglu(torch.from_numpy(x), *map(torch.from_numpy, ws)),
           ref_layers.swiglu(jnp.asarray(x), *map(jnp.asarray, ws)))
    _close(layers.rope_freqs(16, 10000.0), ref_layers.rope_freqs(16, 1e4))
    q = _normal(rng, (2, 4, 8, 16))
    for pos in (np.arange(8), np.arange(8) + 1000):
        _close(layers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos),
                                 500000.0),
               ref_layers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                     500000.0))
    for cap in (0.0, 2.0):
        _close(layers.softcap(torch.from_numpy(x * 5), cap),
               ref_layers.softcap(jnp.asarray(x * 5), cap))
    logits, labels = _normal(rng, (2, 8, 50)), rng.integers(0, 50, (2, 8))
    _close(layers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels)),
           ref_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))


# -------------------------------------------------------------- attention --

@pytest.mark.parametrize("sq,skv,kw", [
    (1, 40, dict(causal=True, q_offset=16)),              # future slots
    (1, 16, dict(causal=False, window=5, attn_softcap=2.0, q_offset=3)),
    (1, 40, dict(causal=True, window=12, q_offset=30)),
    (1, 40, dict(causal=True, attn_softcap=2.0, q_offset=39)),
])
def test_chunked_attention_matches_reference(sq, skv, kw):
    """The decode path (one query row), the only one the port keeps: a
    prompt goes to the kernel."""
    rng = _rng(1)
    q = _normal(rng, (2, 4, sq, 16))
    k, v = _normal(rng, (2, 2, skv, 16)), _normal(rng, (2, 2, skv, 16))
    _close(attention.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                       **kw),
           ref_attention.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                           **kw))


def test_cached_attention_takes_one_row():
    """The reference's scan also takes several rows against a cache; its
    models never ask for that, and the port refuses it."""
    q, kv = torch.zeros(1, 2, 4, 16), torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="one query row"):
        attention.chunked_attention(q, kv, kv, q_offset=4)


def test_attn_forward_with_a_biting_window_and_softcap():
    """Reduced gemma2 keeps its 4096 window, which never bites at smoke
    length: here the window is 8 at S = 32 and the softcap 1.0, so both
    change the result, and the kernel route still holds the reference."""
    ref_cfg, cfg = _cfgs("gemma2-27b", attn_softcap=1.0)
    p = ref_attention.init_attn(ref_cfg, jax.random.PRNGKey(2), jnp.float32)
    arrays, tensors = _fields("attn", p)
    mine_p = attention.AttnParams(**tensors)
    x = _normal(_rng(3), (2, 32, cfg.d_model))
    outs = {}
    for window in (8, 0):
        out, (k, v) = attention.attn_forward(cfg, mine_p, torch.from_numpy(x),
                                             window=window)
        ref, _ = ref_attention.attn_forward(ref_cfg, p, jnp.asarray(x),
                                            window=window)
        _close(out, ref)
        assert k.shape == v.shape == (2, cfg.n_kv_heads, 32, cfg.head_dim_)
        outs[window] = out
    assert float((outs[8] - outs[0]).abs().max()) > 1e-2


def test_attn_blocks_take_the_largest_dividing_kernel_block():
    assert [attention.attn_blocks(s) for s in (8192, 4096, 96, 48, 32, 16)] \
        == [128, 128, 32, 16, 32, 16]
    # none divides: the kernel's wrapper refuses these on the card
    assert [attention.attn_blocks(s) for s in (8, 200)] == [8, 128]


# ------------------------------------------------------------------ mamba --

@pytest.mark.parametrize("s", [64, 1])
def test_mamba_forward_from_an_incoming_state(s):
    """S > 1 from a nonzero state runs the SSD kernel's route with ``h0``
    and takes its final state back; S = 1 with a state is the one-step
    decode recurrence."""
    ref_cfg, cfg = _cfgs("mamba2-2.7b")
    p = ref_mamba.init_mamba(ref_cfg, jax.random.PRNGKey(4), jnp.float32)
    # nonzero a_log, norm_g and dt_bias, so every term is exercised
    rng = _rng(5)
    h = cfg.ssm_heads
    p = p._replace(a_log=jnp.asarray(_normal(rng, (h,), 0.5)),
                   dt_bias=jnp.asarray(_normal(rng, (h,), 0.5)),
                   norm_g=jnp.asarray(_normal(rng, (cfg.d_inner,), 0.1)))
    _, tensors = _fields("ssm", p)
    mine_p = mamba.MambaParams(**tensors)
    x = _normal(rng, (2, s, cfg.d_model))
    state = _normal(rng, (2, h, cfg.ssm_head_dim, cfg.ssm_state), 0.5)
    out, new = mamba.mamba_forward(cfg, mine_p, torch.from_numpy(x),
                                   state=torch.from_numpy(state),
                                   return_state=True)
    ref, ref_new = ref_mamba.mamba_forward(ref_cfg, p, jnp.asarray(x),
                                           state=jnp.asarray(state),
                                           return_state=True)
    _close(out, ref)
    _close(new, ref_new)


# -------------------------------------------------------------------- moe --

def _moe_pair(arch, seed, **replace):
    ref_cfg, cfg = _cfgs(arch, **replace)
    p = ref_moe.init_moe(ref_cfg, jax.random.PRNGKey(seed), jnp.float32)
    _, tensors = _fields("moe", p)
    return ref_cfg, cfg, p, moe.MoEParams(**tensors)


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("impl", ["scatter", "einsum"])
def test_moe_matches_reference(arch, impl):
    ref_cfg, cfg, p, mine_p = _moe_pair(arch, 1, moe_impl=impl)
    x = _normal(_rng(6), (2, 16, cfg.d_model))
    ref = ref_moe.moe_forward(ref_cfg, p, jnp.asarray(x))
    _close(moe.moe_forward(cfg, mine_p, torch.from_numpy(x)), ref, MOE_TOL)
    _close(moe.moe_forward_einsum(cfg, mine_p, torch.from_numpy(x)),
           ref_moe.moe_forward_einsum(ref_cfg, p, jnp.asarray(x)), MOE_TOL)


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_data_shards_and_dropping_match_reference(capacity_factor):
    """``moe_data_shards = 4`` routes per shard; at capacity factor 0.5
    tokens are dropped, shard by shard, as the reference drops them."""
    ref_cfg, cfg, p, mine_p = _moe_pair("grok-1-314b", 2,
                                        moe_impl="scatter",
                                        moe_data_shards=4)
    x = _normal(_rng(7), (4, 16, cfg.d_model))
    _close(moe.moe_forward(cfg, mine_p, torch.from_numpy(x),
                           capacity_factor),
           ref_moe.moe_forward(ref_cfg, p, jnp.asarray(x), capacity_factor),
           MOE_TOL)
    _close(moe.moe_forward_einsum(cfg, mine_p, torch.from_numpy(x),
                                  capacity_factor),
           ref_moe.moe_forward_einsum(ref_cfg, p, jnp.asarray(x),
                                      capacity_factor), MOE_TOL)


def test_aux_load_balance_loss_matches_reference():
    rng = _rng(8)
    logits = _normal(rng, (32, 4))
    experts = rng.integers(0, 4, (32, 2))
    _close(moe.aux_load_balance_loss(torch.from_numpy(logits),
                                     torch.from_numpy(experts), 4),
           ref_moe.aux_load_balance_loss(jnp.asarray(logits),
                                         jnp.asarray(experts), 4), MOE_TOL)


# -------------------------------------------------------------- converter --

@pytest.mark.parametrize("arch", ["gemma2-27b", "jamba-v0.1-52b",
                                  "hubert-xlarge", "arctic-480b"])
def test_converted_state_dict_holds_every_reference_leaf_once(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_params = jax.tree_util.tree_map(
        np.asarray, ref_models.init_params(ref_cfg, jax.random.PRNGKey(9),
                                           dtype=jnp.float32))
    model = model_params_from_reference(cfg, ref_params, device="cpu")
    state = model.state_dict()
    period, n_per = len(cfg.block_pattern), models.n_periods(cfg)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_params)[0]:
        names = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        if names[0] != "blocks":
            want[".".join(names)] = leaf
            continue
        pi = int(names[1][1:])
        for per in range(n_per):
            want[".".join(["blocks", str(per * period + pi), *names[2:]])] = \
                leaf[per]
    assert sorted(state) == sorted(want)
    for key, leaf in want.items():
        assert tuple(state[key].shape) == leaf.shape, key
        np.testing.assert_array_equal(state[key].numpy(), leaf)
    # the model's dtype casts all but the SSM's float32 fields
    half = model_params_from_reference(cfg, ref_params, device="cpu",
                                       dtype=torch.bfloat16)
    for key, t in half.state_dict().items():
        keep = key.rsplit(".", 1)[-1] in ("a_log", "d_skip", "dt_bias")
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), key


# ----------------------------------------------------------------- routes --

def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("arch,kernel,plain,module", [
    ("gemma2-27b", "flash_attention", "flash_attention_plain", attention),
    ("mamba2-2.7b", "mamba_mixer", "ssd_plain", mamba),
    ("jamba-v0.1-52b", "mamba_mixer", "ssd_plain", mamba),
])
def test_models_reach_the_kernel_wrappers_unless_told_not_to(
        monkeypatch, arch, kernel, plain, module):
    """Every attention / SSM layer's full-sequence call goes to the kernel
    wrapper (which on a CUDA tensor launches or raises); the model itself
    calls a plain version only with ``use_kernel=False``, and then on every
    layer and never the kernel.  Decode calls neither."""
    _, cfg = _cfgs(arch)
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32, device="cpu")
    mixer = "attn" if kernel == "flash_attention" else "ssm"
    n = sum(spec.mixer == mixer for spec in cfg.layer_specs())
    toks = torch.from_numpy(_rng(10).integers(0, cfg.vocab, (2, 64)))
    kernel_calls = _spy(monkeypatch, module, kernel)
    plain_calls = _spy(monkeypatch, module, plain)
    out = {}
    for use_kernel in (True, False):
        del kernel_calls[:], plain_calls[:]
        out[use_kernel] = models.forward(cfg, params, toks,
                                         use_kernel=use_kernel)
        assert (len(kernel_calls), len(plain_calls)) == \
            ((n, 0) if use_kernel else (0, n))
    _close(out[True], out[False].numpy())
    del kernel_calls[:], plain_calls[:]
    caches = models.init_decode_state(cfg, 2, 8, torch.float32, "cpu")
    models.decode_step(cfg, params, caches, toks[:, :1], 0)
    assert kernel_calls == plain_calls == []


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the cuda-marked test runs there")
    _, cfg = _cfgs("jamba-v0.1-52b")
    gen = torch.Generator().manual_seed(0)
    for device in (None, "cuda"):
        for build in (
                lambda: models.init_params(cfg, gen, device=device),
                lambda: models.init_attn(cfg, gen, torch.float32, device),
                lambda: models.init_mamba(cfg, gen, torch.float32, device),
                lambda: models.init_moe(cfg, gen, torch.float32, device),
                lambda: models.init_ssm_state(cfg, 2, device),
                lambda: models.init_decode_state(cfg, 2, 8, device=device)):
            with pytest.raises(RuntimeError, match="CUDA"):
                build()


# ---------------------------------------------------------------- on card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (chip_smoke.py phase 12 drives the models on the "
                    "H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reduced_models_on_the_card_kernel_route_matches_plain(card):
    """Reduced gemma2-27b (window 8, so it bites) and mamba2-2.7b in
    float32 on the card: the kernel route against the plain route at 1e-4,
    every layer launching its kernel; attention at head dim 96 (phi3-mini's)
    runs the kernel, zero-padded to 128, and matches the plain route."""
    from repro_torch.kernels import flash_attention, ssd
    for arch, wrapper in (("gemma2-27b", flash_attention),
                          ("mamba2-2.7b", ssd)):
        _, cfg = _cfgs(arch)
        if arch == "gemma2-27b":
            cfg = dataclasses.replace(cfg, block_pattern=(
                configs.LayerSpec(window=8), configs.LayerSpec(window=0)))
        params = models.init_params(
            cfg, torch.Generator(device=card).manual_seed(0), torch.float32,
            device=card)
        toks = torch.from_numpy(_rng(11).integers(0, cfg.vocab, (2, 64)))
        toks = toks.to(card)
        before = wrapper.launches
        got = models.forward(cfg, params, toks)
        torch.cuda.synchronize()
        assert wrapper.launches - before == cfg.n_layers
        want = models.forward(cfg, params, toks, use_kernel=False)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=TOL, atol=TOL)
    _, cfg = _cfgs("phi3-mini-3.8b", d_model=384, n_heads=4, n_kv_heads=4)
    assert cfg.head_dim_ == 96
    p = attention.init_attn(cfg, torch.Generator(device=card).manual_seed(0),
                            torch.float32, card)
    x = torch.from_numpy(_rng(12).standard_normal((1, 64, 384)).astype(
        np.float32)).to(card)
    before = flash_attention.launches
    got, _ = attention.attn_forward(cfg, p, x)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 1
    want, _ = attention.attn_forward(cfg, p, x, use_kernel=False)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=TOL, atol=TOL)
