"""The port's decode path against the reference's on every architecture,
and prefill followed by decode.

Reduced configs, reference parameters carried across and numpy inputs, as
in ``tests/test_torch_models_archs.py``.  Four ``decode_step``s from
``init_decode_state`` hold the reference's logits and caches at
``rtol = atol = 1e-4`` (float32; decode attention and the one-step SSM
recurrence are plain PyTorch in both packages, summed in other orders).
Prefill then decode: the port's prefill logits equal its own token-by-token
replay through ``decode_step`` at the reference test's 2e-3
(``tests/test_cache_and_moe.py``: the chunked scans against the one-step
recurrences), and decode continuing from the port's prefill caches — a
global layer's ring wraps at the first step — holds the reference's
continuation from its own prefill caches at 1e-4.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
from repro.models.prefill import prefill as ref_prefill  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402

torch.set_num_threads(1)

ARCHS = ref_configs.ALL_ARCHS
TOL = 1e-4
REPLAY_TOL = 2e-3
B = 2


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, port cfg, reference params, port model)."""
    ref_cfg = ref_configs.reduced(ref_configs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    ref_params = ref_models.init_params(ref_cfg, jax.random.PRNGKey(3),
                                        dtype=jnp.float32)
    params = model_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


def _inputs(cfg, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "none":
        return rng.integers(0, cfg.vocab, (B, s))
    return rng.standard_normal((B, s, cfg.frontend_dim)).astype(np.float32)


def _close(mine, ref, tol=TOL):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def _close_caches(cfg, caches, ref_caches):
    period = len(cfg.block_pattern)
    for layer, cache in enumerate(caches):
        per, pi = divmod(layer, period)
        ref = ref_caches[f"p{pi}"]
        if cfg.block_pattern[pi].mixer == "attn":
            for mine, want in zip(cache, ref):
                _close(mine, want[per])
        else:
            _close(cache, ref[per])


@pytest.mark.parametrize("arch", ARCHS)
def test_four_decode_steps_match_reference(arch):
    ref_cfg, cfg, ref_params, params = _pair(arch)
    toks = _inputs(cfg, 4, seed=2)
    caches = models.init_decode_state(cfg, B, 16, dtype=torch.float32,
                                      device="cpu")
    ref_caches = ref_models.init_decode_state(ref_cfg, B, 16,
                                              dtype=jnp.float32)
    for i in range(4):
        tok = toks[:, i:i + 1]
        logits, caches = models.decode_step(cfg, params, caches,
                                            torch.from_numpy(tok), i)
        ref_logits, ref_caches = ref_models.decode_step(
            ref_cfg, ref_params, ref_caches, jnp.asarray(tok),
            jnp.asarray(i, dtype=jnp.int32))
        assert logits.shape == (B, 1, cfg.vocab)
        _close(logits, ref_logits)
    _close_caches(cfg, caches, ref_caches)


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma2-27b",
                                  "mamba2-2.7b"])
def test_prefill_then_decode_continues(arch):
    """Prefill caches seed decode as the token-by-token replay does."""
    ref_cfg, cfg, ref_params, params = _pair(arch)
    s = 16
    toks = _inputs(cfg, s, seed=4)
    logits, caches = models.prefill(cfg, params, torch.from_numpy(toks))
    replay = models.init_decode_state(cfg, B, s + 8, dtype=torch.float32,
                                      device="cpu")
    for i in range(s):
        last, replay = models.decode_step(
            cfg, params, replay, torch.from_numpy(toks[:, i:i + 1]), i)
    np.testing.assert_allclose(logits[:, 0].numpy(), last[:, 0].numpy(),
                               rtol=REPLAY_TOL, atol=REPLAY_TOL)
    # two steps on from the prefill caches, as the reference's decode_step
    # takes its own prefill's caches
    _, ref_caches = ref_prefill(ref_cfg, ref_params, jnp.asarray(toks))
    nxt = _inputs(cfg, 2, seed=5)
    for i in range(2):
        tok = nxt[:, i:i + 1]
        lg, caches = models.decode_step(cfg, params, caches,
                                        torch.from_numpy(tok), s + i)
        ref_lg, ref_caches = ref_models.decode_step(
            ref_cfg, ref_params, ref_caches, jnp.asarray(tok),
            jnp.asarray(s + i, dtype=jnp.int32))
        assert torch.isfinite(lg).all()
        _close(lg, ref_lg)
    _close_caches(cfg, caches, ref_caches)
