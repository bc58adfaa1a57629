"""The port's serve engine against the reference's.

Reduced configs, reference parameters carried across in float32 and numpy
traces from a seed, as in ``tests/test_torch_models_decode.py``.  The
reference engine (``repro.serve.ServeEngine``) admits a request by
replaying every prompt token through its jitted ``decode_step``; the
port's engine runs the longest prefix the kernels take as one batched
pass over every slot (the flash-attention kernel's and the SSD kernel's
plain versions here, on the CPU) and replays only the tail.  Under the
FIFO scheduler both must give *equal* tokens, and their caches must agree
normwise within 2e-3, the tolerance of the prefill-against-replay test
(``tests/test_torch_models_decode.py``).  The traces hold pure-replay
admissions (prompts under 16 tokens), admissions with a kernel head and
no tail, and admissions with both; later admissions start from the
non-zero states and stale cache rows left by earlier ones.  A model of
SSM layers alone scans on in a second pass, and a MoE whose capacity
drops tokens routes each head position as a replay step does: both are
held to the reference's tokens too.  The reference
test's own properties (``tests/test_serve_scheduler.py``) are held on the
port, and spies count the kernel calls an admission makes.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
import repro.serve as ref_serve  # noqa: E402
from repro_torch import configs, models  # noqa: E402
from repro_torch.convert import model_params_from_reference  # noqa: E402
from repro_torch.kernels.ssd import ssd_tile_legal  # noqa: E402
from repro_torch.models import attention, mamba  # noqa: E402
from repro_torch.serve import (FifoScheduler, ModelGuidedScheduler,  # noqa: E402
                               Request, ServeEngine, StepCostModel)
from repro_torch.serve.engine import (admission_head,  # noqa: E402
                                      admission_passes)
from repro_torch.tc.suite import COLD, WARM  # noqa: E402

torch.set_num_threads(1)

CACHE_TOL = 2e-3
SLOTS, CTX = 3, 64
#: the FIFO traces' seed: six prompts of 7, 34, 27, 16, 5 and 29 tokens,
#: so every config sees pure replays, a head with no tail and heads with
#: tails (``test_traces_cover_every_kind_of_admission``)
TRACE_SEED = 14
#: gemma2 with a 16-token local window, so its ring wraps under the
#: trace's longer prompts
WRAP_WINDOW = 16
ARCHS = ("deepseek-7b", "mamba2-2.7b", "jamba-v0.1-52b", "gemma2-27b-wrap")


def _cfgs(arch):
    """(reference cfg, port cfg), reduced at vocab 128."""
    name = arch.replace("-wrap", "")
    ref_cfg = ref_configs.reduced(ref_configs.get_config(name), vocab=128)
    cfg = configs.reduced(configs.get_config(name), vocab=128)
    if arch.endswith("-wrap"):
        ref_cfg = dataclasses.replace(ref_cfg, block_pattern=(
            ref_configs.LayerSpec(window=WRAP_WINDOW),
            ref_configs.LayerSpec(window=0)))
        cfg = dataclasses.replace(cfg, block_pattern=(
            configs.LayerSpec(window=WRAP_WINDOW), configs.LayerSpec(window=0)))
    return ref_cfg, cfg


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, port cfg, reference params, port model), float32."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params = ref_models.init_params(ref_cfg, jax.random.PRNGKey(3),
                                        dtype=jnp.float32)
    params = model_params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


def _trace(request_cls, vocab, *, n=6, seed=TRACE_SEED, lo=2, hi=40):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    new = rng.integers(2, 7, n)
    return [request_cls(uid=i,
                        prompt=rng.integers(1, vocab, int(lens[i])
                                            ).astype(np.int32),
                        max_new_tokens=int(new[i]))
            for i in range(n)]


@functools.lru_cache(maxsize=None)
def _reference_run(arch, ref_cfg=None, lo=2, hi=40):
    """The reference engine's FIFO run (on ``ref_cfg`` when given, over
    prompts of ``lo``..``hi`` tokens): (tokens by uid, caches as numpy)."""
    cfg_, cfg, ref_params, _ = _pair(arch)
    eng = ref_serve.ServeEngine(ref_cfg or cfg_, ref_params,
                                batch_slots=SLOTS, ctx_len=CTX)
    reqs = _trace(ref_serve.Request, cfg.vocab, lo=lo, hi=hi)
    eng.run(reqs, scheduler=ref_serve.FifoScheduler())
    return ({r.uid: r.out_tokens for r in reqs},
            jax.tree_util.tree_map(np.asarray, eng.caches))


def _normwise(mine, want):
    mine = mine.detach().numpy()
    return float(np.linalg.norm(mine - want) / np.linalg.norm(want))


def _caches_err(cfg, caches, ref_caches):
    """The largest normwise error over the layers' caches."""
    period = len(cfg.block_pattern)
    errs = []
    for layer, cache in enumerate(caches):
        per, pi = divmod(layer, period)
        ref = ref_caches[f"p{pi}"]
        if cfg.block_pattern[pi].mixer == "attn":
            errs += [_normwise(m, w[per]) for m, w in zip(cache, ref)]
        else:
            errs.append(_normwise(cache, ref[per]))
    return max(errs)


def _engine(arch, **kw):
    _, cfg, _, params = _pair(arch)
    return ServeEngine(cfg, params, batch_slots=SLOTS, ctx_len=CTX,
                       device="cpu", **kw)


# ------------------------------------------------------ reference parity --

@pytest.mark.parametrize("arch", ARCHS)
def test_traces_cover_every_kind_of_admission(arch):
    _, cfg = _cfgs(arch)
    kinds = set()
    for req in _trace(Request, cfg.vocab):
        h, n = admission_head(cfg, len(req.prompt)), len(req.prompt)
        kinds.add("replay" if h == 0 else "head" if h == n else "both")
    assert kinds == {"replay", "head", "both"}


@pytest.mark.parametrize("arch", ARCHS)
def test_fifo_run_gives_the_reference_tokens_and_caches(arch):
    """Six requests over three slots under FIFO: every request's tokens
    equal the reference engine's, and so do the caches, normwise."""
    want_tokens, want_caches = _reference_run(arch)
    _, cfg, _, _ = _pair(arch)
    eng = _engine(arch)
    reqs = _trace(Request, cfg.vocab)
    stats = eng.run(reqs, scheduler=FifoScheduler())
    assert {r.uid: r.out_tokens for r in reqs} == want_tokens
    assert all(r.done for r in reqs)
    heads = [admission_head(cfg, len(r.prompt)) for r in reqs]
    assert stats.kernel_admissions == sum(h > 0 for h in heads)
    assert stats.tail_tokens == sum(len(r.prompt) - h
                                    for r, h in zip(reqs, heads))
    assert _caches_err(cfg, eng.caches, want_caches) <= CACHE_TOL


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "gemma2-27b-wrap"])
def test_one_admission_equals_its_replay_from_live_state(arch):
    """An admission into slot 1 while slot 0 holds a request: the batched
    head and tail leave the caches a hand-driven replay of the whole
    prompt through ``decode_step`` leaves (every slot's rows, the stale
    prefix of slot 0 and the SSM states advanced from slot 0's included).
    """
    _, cfg, _, params = _pair(arch)
    eng = _engine(arch)
    first, second = _trace(Request, cfg.vocab)[1:3]      # 34, 27 tokens
    eng.add_request(first)
    caches = [tuple(t.clone() for t in c) if isinstance(c, tuple)
              else c.clone() for c in eng.caches]
    eng.add_request(second)
    for i, tok in enumerate(second.prompt):
        token = torch.zeros((SLOTS, 1), dtype=torch.int64)
        token[1, 0] = int(tok)
        _, caches = models.decode_step(cfg, params, caches, token, i)
    for got, want in zip(eng.caches, caches):
        for g, w in (zip(got, want) if isinstance(got, tuple)
                     else ((got, want),)):
            assert _normwise(g, w.numpy()) <= CACHE_TOL


def test_a_second_ssm_pass_gives_the_reference_tokens():
    """Prompts of 40-63 tokens on reduced mamba2 (chunk 32): the first
    pass takes 32 tokens, a second pass scans on from its final states at
    chunk 16, and at most 15 tokens replay; tokens equal the reference
    engine's and caches agree normwise."""
    _, cfg, _, _ = _pair("mamba2-2.7b")
    want_tokens, want_caches = _reference_run("mamba2-2.7b", lo=40, hi=63)
    reqs = _trace(Request, cfg.vocab, lo=40, hi=63)
    passes = [admission_passes(cfg, len(r.prompt)) for r in reqs]
    assert any(len(p) == 2 for p in passes)
    eng = _engine("mamba2-2.7b")
    stats = eng.run(reqs, scheduler=FifoScheduler())
    assert {r.uid: r.out_tokens for r in reqs} == want_tokens
    assert stats.tail_tokens == sum(len(r.prompt) % 16 for r in reqs)
    assert _caches_err(cfg, eng.caches, want_caches) <= CACHE_TOL


# ---------------------------------------- the reference test's properties --

#: tests/test_serve_scheduler.py's engine config and trace
SCHED_CFG = configs.reduced(configs.get_config("deepseek-7b"), n_layers=2,
                            d_model=64, d_ff=128, vocab=128)


@functools.lru_cache(maxsize=None)
def _sched_params():
    return models.init_params(SCHED_CFG, torch.Generator().manual_seed(0),
                              torch.float32, device="cpu")


def _sched_engine():
    return ServeEngine(SCHED_CFG, _sched_params(), batch_slots=3, ctx_len=64,
                       device="cpu")


def _sched_trace(n=5, long_prompts=False):
    rng = np.random.default_rng(3)
    hi = 41 if long_prompts else 9
    return [Request(uid=i,
                    prompt=rng.integers(1, SCHED_CFG.vocab,
                                        size=int(rng.integers(2, hi))
                                        ).astype(np.int32),
                    max_new_tokens=int(rng.integers(2, 6)))
            for i in range(n)]


@pytest.mark.parametrize("long_prompts", [False, True])
def test_fifo_policy_matches_legacy_loop(long_prompts):
    fifo = _sched_engine()
    reqs = _sched_trace(long_prompts=long_prompts)
    fifo.run(reqs, scheduler=FifoScheduler())

    # the legacy loop, driven by hand through the step hooks, on an
    # identical trace — same admissions, same steps, same tokens
    legacy = _sched_engine()
    reqs2 = _sched_trace(long_prompts=long_prompts)
    queue = list(reqs2)
    while queue or legacy.active:
        while queue and legacy.add_request(queue[0]):
            queue.pop(0)
        legacy.step()

    assert {r.uid: r.out_tokens for r in reqs} == \
        {r.uid: r.out_tokens for r in reqs2}
    assert all(r.done for r in reqs)


@pytest.mark.parametrize("prompt_len", [None, 40])
def test_interleaved_prefill_matches_blocking_for_lone_request(prompt_len):
    """A lone request prefilled one token per fused step gives the tokens
    the blocking admission gives: the reference test's trace (a pure
    replay in the port) and a 40-token prompt (a 32-token batched head
    and an 8-token tail)."""
    def lone():
        r = _sched_trace(1)[0]
        if prompt_len:
            r.prompt = np.random.default_rng(8).integers(
                1, SCHED_CFG.vocab, prompt_len).astype(np.int32)
        return r

    blocking = _sched_engine()
    r1 = lone()
    blocking.add_request(r1)
    while blocking.active:
        blocking.step()

    interleaved = _sched_engine()
    r2 = lone()
    interleaved.begin_prefill(r2)
    while interleaved.active or interleaved.prefilling:
        interleaved.advance()

    assert r2.out_tokens == r1.out_tokens
    assert r2.done
    assert blocking.stats.kernel_admissions == (1 if prompt_len else 0)


def test_begin_prefill_rejects_busy_slot():
    eng = _sched_engine()
    r1, r2 = _sched_trace(2)
    slot = eng.begin_prefill(r1)
    with pytest.raises(ValueError, match="not free"):
        eng.begin_prefill(r2, slot=slot)
    eng.prefilling.clear()
    eng.prefill_done.clear()
    eng.active = {s: r1 for s in range(eng.slots)}
    with pytest.raises(ValueError, match="free slot"):
        eng.begin_prefill(r2)
    assert eng.add_request(r2) is False


def test_stats_synchronized_and_latencies_tracked():
    eng = _sched_engine()
    reqs = _sched_trace(4, long_prompts=True)
    stats = eng.run(reqs, scheduler=FifoScheduler())
    assert stats.prefill_s > 0.0
    assert stats.decode_s > 0.0
    assert stats.ticks > 0
    assert len(stats.latencies_s) == len(reqs)
    assert all(lat > 0 for lat in stats.latencies_s)
    assert stats.latency_ms(99) >= stats.latency_ms(50) > 0.0
    for r in reqs:
        assert r.latency_s is not None and r.latency_s > 0
    assert stats.tokens_out == sum(r.max_new_tokens for r in reqs)
    assert stats.tokens_per_s > 0.0


def test_guided_run_serves_everything():
    eng = _sched_engine()
    tick_s = {}
    for occ in range(1, 4):
        tick_s[(occ, WARM)], tick_s[(occ, COLD)] = 1e-3, 2e-3
    sched = ModelGuidedScheduler(StepCostModel(tick_s=tick_s, slots=3))
    reqs = _sched_trace(6)
    stats = eng.run(reqs, scheduler=sched)
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == r.max_new_tokens for r in reqs)
    assert stats.kernel_admissions == 0       # interleaved lanes only


# ----------------------------------------------------------------- route --

def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("arch", ["gemma2-27b-wrap", "mamba2-2.7b",
                                  "jamba-v0.1-52b"])
def test_admissions_reach_the_kernel_wrappers(monkeypatch, arch):
    """An admission with a head calls each kernel wrapper once per layer
    of its kind (on a CUDA tensor the wrapper launches or raises); a pure
    replay calls none; ``use_kernel=False`` sends the head to the plain
    versions; decode ticks call neither."""
    _, cfg, _, _ = _pair(arch)
    specs = cfg.layer_specs()
    n_attn = sum(s.mixer == "attn" for s in specs)
    n_ssm = len(specs) - n_attn
    calls = {name: _spy(monkeypatch, module, name) for module, name in (
        (attention, "flash_attention"), (attention, "flash_attention_plain"),
        (mamba, "ssd"), (mamba, "ssd_plain"))}

    def admitted(use_kernel, length):
        for c in calls.values():
            del c[:]
        eng = _engine(arch, use_kernel=use_kernel)
        eng.add_request(Request(uid=0, prompt=np.arange(1, length + 1,
                                                        dtype=np.int32)))
        return {name: len(c) for name, c in calls.items()}

    assert admitted(True, 40) == {"flash_attention": n_attn,
                                  "flash_attention_plain": 0,
                                  "ssd": n_ssm, "ssd_plain": 0}
    assert admitted(False, 40) == {"flash_attention": 0,
                                   "flash_attention_plain": n_attn,
                                   "ssd": 0, "ssd_plain": n_ssm}
    assert admitted(True, 12) == dict.fromkeys(calls, 0)
    eng = _engine(arch)
    eng.add_request(Request(uid=0, prompt=np.arange(1, 17, dtype=np.int32),
                            max_new_tokens=3))
    for c in calls.values():
        del c[:]
    while eng.active:
        eng.step()
    assert all(not c for c in calls.values())


def test_admission_head_is_the_longest_prefix_the_kernels_take():
    """Against brute force: the first pass takes the longest prefix every
    layer's kernel takes (attention a multiple of the smallest kernel
    block, 16; an SSM layer a chunk ``min(ssm_chunk, H)`` that divides H
    and that the SSD kernel takes); a model of SSM layers alone scans on
    in a second pass over the longest rest some chunk up to its own
    divides, at the largest such chunk."""
    full = {a: configs.get_config(a) for a in
            ("gemma2-27b", "mamba2-2.7b", "jamba-v0.1-52b")}
    small = {a: _cfgs(a)[1] for a in ("deepseek-7b", "mamba2-2.7b")}
    for cfg in (*full.values(), *small.values()):
        mixers = {s.mixer for s in cfg.block_pattern}
        for n in list(range(0, 80)) + [300, 999, 2000, 4097]:
            def ok(h):
                if "attn" in mixers and h % 16:
                    return False
                return "ssm" not in mixers or ssd_tile_legal(
                    h, min(cfg.ssm_chunk, h), 16, 16)
            first = max([h for h in range(1, n + 1) if ok(h)], default=0)
            want = [(first, min(cfg.ssm_chunk, first))] if first else []
            rests = [(r, c) for r in range(1, n - first + 1)
                     for c in range(1, min(cfg.ssm_chunk, r) + 1)
                     if ssd_tile_legal(r, c, 16, 16)]
            if first and mixers == {"ssm"} and rests:
                want.append(max(rests))
            assert admission_passes(cfg, n) == want, (cfg.name, n)
            assert admission_head(cfg, n) == sum(h for h, _ in want)
    assert admission_head(full["gemma2-27b"], 2000) == 2000
    assert admission_head(full["gemma2-27b"], 1999) == 1984
    assert admission_passes(full["mamba2-2.7b"], 2000) == [(1792, 256),
                                                           (208, 16)]
    assert admission_passes(full["mamba2-2.7b"], 1999) == [(1792, 256),
                                                           (192, 192)]
    assert admission_passes(full["mamba2-2.7b"], 200) == [(192, 192)]
    assert admission_passes(full["jamba-v0.1-52b"], 2000) == [(1792, 256)]


# ------------------------------------------------------------------- MoE --

@pytest.mark.parametrize("impl", ["scatter", "einsum"])
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("factor", [0.5, 1.25, 2.0])
def test_moe_groups_route_each_group_as_a_call_of_its_own(impl, shards,
                                                          factor):
    """``groups=G`` gives what G calls on the runs of consecutive tokens
    give, one after the other: the capacity, the shards and the drops
    are each group's own (float32, normwise 1e-6)."""
    from repro_torch.models.moe import moe_forward
    _, cfg, _, params = _pair("jamba-v0.1-52b")
    cfg = dataclasses.replace(cfg, moe_impl=impl, moe_data_shards=shards,
                              moe_capacity_factor=factor)
    moe = next(b.moe for b in params.blocks if b.spec.ffn == "moe")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (5, SLOTS, cfg.d_model)).astype(np.float32))
    got = moe_forward(cfg, moe, x, groups=5)
    want = torch.cat([moe_forward(cfg, moe, x[g:g + 1]) for g in range(5)])
    assert _normwise(got, want.numpy()) <= 1e-6


@pytest.mark.parametrize("impl,shards", [("einsum", 1), ("scatter", 1),
                                         ("scatter", 3)])
def test_moe_that_drops_tokens_gives_the_reference_tokens(monkeypatch, impl,
                                                          shards):
    """Reduced jamba at the configs' capacity factor, 1.25: three slots
    route into buffers of two, so a replay step drops choices.  A batched
    head routes each position's tokens as that step does, so the FIFO
    trace still gives the reference engine's tokens, and caches agree."""
    from repro_torch.models import moe
    ref_cfg, cfg, _, _ = _pair("jamba-v0.1-52b")
    change = dict(moe_capacity_factor=1.25, moe_impl=impl,
                  moe_data_shards=shards)
    ref_cfg = dataclasses.replace(ref_cfg, **change)
    want_tokens, want_caches = _reference_run("jamba-v0.1-52b", ref_cfg)
    dropped = []
    route = moe._route

    def counted(*args):
        out = route(*args)
        dropped.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(moe, "_route", counted)
    _, _, _, params = _pair("jamba-v0.1-52b")
    cfg = dataclasses.replace(cfg, **change)
    eng = ServeEngine(cfg, params, batch_slots=SLOTS, ctx_len=CTX,
                      device="cpu")
    reqs = _trace(Request, cfg.vocab)
    eng.run(reqs, scheduler=FifoScheduler())
    assert {r.uid: r.out_tokens for r in reqs} == want_tokens
    assert _caches_err(cfg, eng.caches, want_caches) <= CACHE_TOL
    assert (sum(dropped) > 0) == (shards == 1)


# --------------------------------------------------------------- devices --

def test_engine_device_is_the_card_unless_the_cpu_is_asked_for():
    _, cfg, _, params = _pair("deepseek-7b")
    if not torch.cuda.is_available():
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                ServeEngine(cfg, params, device=device)
    eng = ServeEngine(cfg, params, batch_slots=2, ctx_len=16, device="cpu")
    assert eng.device == torch.device("cpu")
    assert all(t.device == eng.device for c in eng.caches
               for t in (c if isinstance(c, tuple) else (c,)))
    with pytest.raises(ValueError, match="parameters lie on"):
        ServeEngine(cfg, copy.deepcopy(params).to("meta"), device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(dataclasses.replace(cfg, causal=False), params,
                    device="cpu")


# --------------------------------------------------------------- on card --

@pytest.mark.cuda
def test_reduced_engines_on_the_card_launch_the_kernels():
    """On the card: an admission's head launches each kernel once per
    layer of its kind, and the FIFO trace gives the same tokens on the
    kernel route and the plain route (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (chip_smoke.py phase 13 serves on the H100)")
    from repro_torch.kernels import flash_attention, ssd
    card = torch.device("cuda")
    for arch in ("gemma2-27b-wrap", "mamba2-2.7b"):
        _, cfg, _, params = _pair(arch)
        params = copy.deepcopy(params).to(card)
        tokens = {}
        for use_kernel in (True, False):
            eng = ServeEngine(cfg, params, batch_slots=SLOTS, ctx_len=CTX,
                              use_kernel=use_kernel, device=card)
            before = flash_attention.launches + ssd.launches
            reqs = _trace(Request, cfg.vocab)
            stats = eng.run(reqs, scheduler=FifoScheduler())
            launched = flash_attention.launches + ssd.launches - before
            passes = sum(len(admission_passes(cfg, len(r.prompt)))
                         for r in reqs)
            assert launched == (passes * cfg.n_layers if use_kernel else 0)
            tokens[use_kernel] = [r.out_tokens for r in reqs]
        assert tokens[True] == tokens[False]
