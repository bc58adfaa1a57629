"""The port's models against the reference's on every architecture:
``forward`` logits and ``prefill``'s last-token logits and caches.

Each architecture's reduced config is built as the reference's tests build
it (``tests/test_models_archs.py``), its parameters come from the
reference's ``init_params`` in float32 and are carried across with
``model_params_from_reference``, and the inputs are made with numpy from a
seed.  On the CPU the port's attention runs the flash-attention kernel's
plain version and its Mamba layers the SSD kernel's plain version, both
through the kernel wrappers, against the reference's XLA scans.
Tolerance: ``rtol = atol = 1e-4`` — float32 throughout, and the two
packages sum the same products in different orders (the online softmax
over other kv blocks, the SSD within and across chunks), an error of a few
1e-6 at these widths.
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
B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, port cfg, reference params, port model)."""
    ref_cfg = ref_configs.reduced(ref_configs.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    ref_params = ref_models.init_params(ref_cfg, jax.random.PRNGKey(0),
                                        dtype=jnp.float32)
    params = model_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


def _inputs(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "none":
        return rng.integers(0, cfg.vocab, (b, s))
    return rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)


def _close(mine, ref):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref_cfg, cfg, ref_params, params = _pair(arch)
    x = _inputs(cfg)
    logits = models.forward(cfg, params, torch.from_numpy(x))
    assert logits.shape == (B, S, cfg.vocab) and logits.dtype == torch.float32
    _close(logits, ref_models.forward(ref_cfg, ref_params, jnp.asarray(x)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(arch):
    ref_cfg, cfg, ref_params, params = _pair(arch)
    x = _inputs(cfg, seed=1)
    logits, caches = models.prefill(cfg, params, torch.from_numpy(x))
    ref_logits, ref_caches = ref_prefill(ref_cfg, ref_params, jnp.asarray(x))
    assert logits.shape == (B, 1, cfg.vocab)
    _close(logits, ref_logits)
    period = len(cfg.block_pattern)
    assert len(caches) == cfg.n_layers
    for layer, cache in enumerate(caches):
        per, pi = divmod(layer, period)
        ref = ref_caches[f"p{pi}"]
        if cfg.block_pattern[pi].mixer == "attn":
            for mine, want in zip(cache, ref):
                assert mine.is_contiguous()
                _close(mine, want[per])
        else:
            _close(cache, ref[per])
