"""The kernels as ``torch.library`` operators: ``repro_torch::
flash_attention_fwd``, ``flash_attention_bwd``, ``ssd_fwd`` and ``ssd_bwd``.

``torch.library.opcheck`` holds each on CPU tensors (schema, autograd
registration, fake implementation against the real one, AOT dispatch).
``FlopCounterMode`` counts the formulas on fake tensors, held against the
hand reckoning: attention 4 D flops per kept (query, key) pair and query
head (``perf.analytic``'s causal (S + 1) / 2 convention), its backward 2.5
times that; the SSD ``perf.analytic._ssm_flops_per_token`` a token, its
backward the kernel table's count.  Dispatch: fake tensors run the fake
implementation and never the plain version; real CPU tensors the plain
version.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

# the modules (the package exports functions of the same names)
fa = importlib.import_module("repro_torch.kernels.flash_attention")
ssd_mod = importlib.import_module("repro_torch.kernels.ssd")

RNG = np.random.default_rng(0)


def _t(*shape, scale=1.0):
    return torch.from_numpy((RNG.standard_normal(shape) * scale)
                            .astype(np.float32))


ATTN_ARGS = [
    dict(b=1, hq=4, hkv=2, s=32, d=16, blk=16, causal=True, window=0,
         softcap=0.0),
    dict(b=2, hq=2, hkv=2, s=64, d=16, blk=32, causal=False, window=24,
         softcap=5.0),
]


@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("a", ATTN_ARGS)
def test_attention_forward_operator_passes_opcheck(a, with_lse):
    q = _t(a["b"], a["hq"], a["s"], a["d"])
    k, v = (_t(a["b"], a["hkv"], a["s"], a["d"]) for _ in range(2))
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_fwd,
                          (q, k, v, a["blk"], a["blk"], a["causal"],
                           a["window"], a["softcap"], with_lse))


@pytest.mark.parametrize("a", ATTN_ARGS)
def test_attention_backward_operator_passes_opcheck(a):
    q = _t(a["b"], a["hq"], a["s"], a["d"])
    k, v = (_t(a["b"], a["hkv"], a["s"], a["d"]) for _ in range(2))
    kw = dict(causal=a["causal"], window=a["window"], softcap=a["softcap"])
    o, lse = fa.flash_attention_fwd(q, k, v, bq=a["blk"], bkv=a["blk"], **kw)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_bwd,
                          (q, k, v, o, lse, _t(*q.shape), a["causal"],
                           a["window"], a["softcap"], 32))


def _ssd_ops(b=2, l=64, h=4, p=8, g=2, n=8):
    x = _t(b, l, h, p)
    dt = torch.from_numpy(np.abs(RNG.standard_normal((b, l, h)))
                          .astype(np.float32) * 0.1)
    return x, dt, _t(h, scale=0.1), _t(b, l, g, n), _t(b, l, g, n)


@pytest.mark.parametrize("with_h0,want_state", [(False, True), (True, False),
                                                 (True, True)])
def test_ssd_forward_operator_passes_opcheck(with_h0, want_state):
    x, dt, a_log, b, c = _ssd_ops()
    h0 = _t(2, 4, 8, 8) if with_h0 else None
    torch.library.opcheck(torch.ops.repro_torch.ssd_fwd,
                          (x, dt, a_log, b, c, h0, 16, want_state))


@pytest.mark.parametrize("with_dh", [False, True])
def test_ssd_backward_operator_passes_opcheck(with_dh):
    x, dt, a_log, b, c = _ssd_ops()
    _, _, s, h_in = torch.ops.repro_torch.ssd_fwd(x, dt, a_log, b, c, None,
                                                  16, True)
    dh = _t(2, 4, 8, 8) if with_dh else None
    torch.library.opcheck(torch.ops.repro_torch.ssd_bwd,
                          (x, dt, a_log, b, c, s, h_in, _t(*x.shape), dh,
                           16))


def _pairs(sq, skv, causal, window):
    """Kept (query, key) pairs by brute force over the mask."""
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    keep = np.ones((sq, skv), dtype=bool)
    if causal:
        keep &= i >= j
    if window > 0:
        keep &= (i - j) < window
    return int(keep.sum())


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100), (False, 64)])
def test_kept_pairs_equal_brute_force(causal, window):
    for sq, skv in ((256, 256), (128, 256), (256, 128)):
        assert fa.attn_kept_pairs(sq, skv, causal, window) == \
            _pairs(sq, skv, causal, window)
    s = 4096
    assert fa.attn_kept_pairs(s, s, True, 0) == s * (s + 1) // 2


def test_flop_counter_reads_the_attention_formulas_on_fake_cuda_tensors():
    b, hq, hkv, s, d = 2, 32, 8, 4096, 128
    with FakeTensorMode():
        q = torch.empty(b, hq, s, d, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(b, hkv, s, d, device="cuda", dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            out = fa.flash_attention(q, k, k, bq=128, bkv=128, window=1024)
            o, lse = fa.flash_attention_fwd(q, k, k, bq=128, bkv=128)
            fa.flash_attention_bwd(q, k, k, o, lse, o)
        assert out.device.type == "cuda" and out.shape == q.shape
    counts = {str(k_): v for k_, v in fc.get_flop_counts()["Global"].items()}
    fwd = 4 * b * hq * d * (_pairs(s, s, True, 1024) + _pairs(s, s, True, 0))
    assert counts["repro_torch.flash_attention_fwd"] == fwd
    assert counts["repro_torch.flash_attention_bwd"] == \
        10 * b * hq * d * _pairs(s, s, True, 0)


def test_flop_counter_reads_the_ssd_formulas_on_fake_tensors():
    from repro_torch.configs import get_config
    from repro_torch.perf.analytic import _ssm_flops_per_token
    cfg = get_config("jamba-v0.1-52b")
    b, l = 1, 4096
    h, p, g, n, q = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                     cfg.ssm_state, cfg.ssm_chunk)
    d = cfg.d_model
    proj = 2 * d * (2 * cfg.d_inner + 2 * g * n + h) + 2 * cfg.d_inner * d
    with FakeTensorMode():
        x = torch.empty(b, l, h, p, requires_grad=True)
        dt = torch.empty(b, l, h)
        a_log = torch.empty(h)
        bc = torch.empty(b, l, g, n)
        with FlopCounterMode(display=False) as fc:
            y = ssd_mod.ssd(x, dt, a_log, bc, bc, chunk=q)
            torch.autograd.grad(y.sum(), x)
    counts = {str(k_): v for k_, v in fc.get_flop_counts()["Global"].items()}
    assert counts["repro_torch.ssd_fwd"] == \
        b * l * (_ssm_flops_per_token(cfg) - proj)
    pairs = q * (q + 1) // 2
    assert counts["repro_torch.ssd_bwd"] == \
        (2 * pairs * (3 * n + 2 * p) + 8 * q * p * n) * b * h * (l // q)


def test_fake_tensors_never_run_the_plain_versions(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on fake tensors")

    for name in ("flash_attention_plain", "flash_attention_bwd_plain"):
        monkeypatch.setattr(fa, name, refuse)
    for name in ("ssd_plain", "_plain_parts", "ssd_bwd_plain"):
        monkeypatch.setattr(ssd_mod, name, refuse)
    with FakeTensorMode():
        q = torch.empty(1, 4, 64, 16, requires_grad=True)
        k = torch.empty(1, 2, 64, 16)
        out = fa.flash_attention(q, k, k, bq=16, bkv=16)
        torch.autograd.grad(out.sum(), q)
        x, dt, a_log, b, c = (torch.empty(s) for s in (
            (1, 64, 4, 8), (1, 64, 4), (4,), (1, 64, 1, 8), (1, 64, 1, 8)))
        x.requires_grad_(True)
        y, hf = ssd_mod.ssd(x, dt, a_log, b, c, chunk=16, return_state=True)
        torch.autograd.grad(y.sum() + hf.sum(), x)


def test_real_cpu_tensors_run_the_plain_versions(monkeypatch):
    calls = []
    plain = fa.flash_attention_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_plain", counted)
    q, k = _t(1, 4, 32, 16), _t(1, 2, 32, 16)
    fa.flash_attention(q, k, k, bq=16, bkv=16)
    assert calls == [1]
