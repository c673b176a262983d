"""The port's OLMoE family (repro_torch.models.olmoe, ``family="moe"``) with
params bridged from the JAX package, held to repro.models.olmoe at the
reference engine tests' tiny MoE config (E = 4, top_k 2, capacity_factor
4.0: drop-free); the reference's ``moe`` engine cases on the port's engine;
and the engine's family gates.

Tolerances: ``forward`` and ``prefill`` with ``length`` within rel 0.01 of
the reference run op by op (``jax.disable_jit()``; causal attention within
one block, whose f32 score and softmax ops XLA orders otherwise) and 0.03
of the jitted one, ``forward``'s aux loss within 1e-3 relative; the
bucketed ``decode_step`` from the reference's cache bit-equal to it op by
op; positions exact (``test_torch_olmoe_steps.py`` holds the paged, ragged
and prefix paths). Engine cases: greedy tokens exact against the port's own
solo oracle, as the reference holds its own.
"""

import dataclasses
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.models import common as JC_
from repro.models import olmoe as JO
from repro_torch.analysis.sanitizers import (
    assert_compile_budget,
    lifecycle_checks,
    page_invariant_checks,
)
from repro_torch.configs import ModelConfig, get_config
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.launch.serve import ContinuousBatchingEngine, Request, RequestState
from repro_torch.models import dense as TD
from repro_torch.models import olmoe as TO
from repro_torch.models import registry
from repro_torch.models.moe_layer import MoEFFN

torch.set_num_threads(2)

KW = dict(name="tiny-moe", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, vocab=256, n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=4.0)
JCFG, CFG = JCfg(**KW, remat=False), ModelConfig(**KW)


@pytest.fixture(scope="module")
def jparams():
    return JO.init_params(JCFG, jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _toks(shape, seed):
    return np.random.default_rng(seed).integers(0, KW["vocab"], shape).astype(np.int32)


# ---------------------------------------------------------------------------
# config, registry, params
# ---------------------------------------------------------------------------


def test_config_registry_and_count_params():
    cfg = get_config("olmoe-1b-7b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.n_experts, cfg.top_k, cfg.d_ff_expert, cfg.vocab) == (
        "moe", 16, 2048, 16, 16, 128, 64, 8, 1024, 50304)
    assert (cfg.capacity_factor, cfg.router_aux_weight, cfg.n_shared_experts) == (1.25, 0.001, 0)
    red = get_config("olmoe-1b-7b", reduced=True)
    assert (red.n_experts, red.top_k, red.d_model) == (8, 2, 128)
    assert registry.get_model(cfg).decode_step is TO.decode_step
    assert registry.get_model(get_config("llama3-8b")).decode_step is TD.decode_step
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.get_model(cfg.replace(family="mla_moe"))
    jcfg = JCfg(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                   if f.name != "quant"})
    assert TO.count_params(cfg) == JO.count_params(jcfg)


def test_bridged_params_keep_experts_stacked(params):
    lp = params.layers[0]
    assert isinstance(lp.moe, MoEFFN) and lp.moe.shared is None
    assert lp.moe.router.shape == (64, 4) and lp.moe.router.dtype == torch.float32
    assert lp.moe.experts["gate"].w.shape == (4, 64, 64)
    assert lp.moe.experts["down"].w.shape == (4, 64, 64)
    p = TO.init_params(CFG, seed=0, device="cpu")
    assert p.layers[1].moe.experts["up"].w.shape == (4, 64, 64)
    assert p.layers[1].moe.experts["up"].w.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# entry points against the reference
# ---------------------------------------------------------------------------


def _ops(fn, *args, **kw):
    """The reference run op by op (``jax.disable_jit()``)."""
    with jax.disable_jit():
        return fn(*args, **kw)


def test_forward_matches_jax(jparams, params):
    toks = _toks((2, 24), 0)
    lj, aj = JO.forward(jparams, JCFG, jnp.asarray(toks))
    lo, ao = _ops(JO.forward, jparams, JCFG, jnp.asarray(toks))
    lt, at = TO.forward(params, CFG, torch.as_tensor(toks, dtype=torch.long))
    assert lt.shape == (2, 24, CFG.padded_vocab)
    assert _rel(_np(lo), _np(lt)) <= 0.01
    assert _rel(_np(lj), _np(lt)) <= 0.03
    for a in (ao, aj):  # the routing probabilities of slightly other inputs
        assert abs(float(a) - float(at)) <= 1e-3 * abs(float(a))


def test_prefill_with_length_and_decode_match_jax(jparams, params):
    """A padded bucket (``length``), then two bucketed decode steps."""
    bucket, length = 32, 27
    toks = _toks((1, bucket), 1)
    toks[0, length:] = 0
    sj = JO.init_decode_state(JCFG, 1, 48)
    st = TO.init_decode_state(CFG, 1, 48, device="cpu")
    lj, sj_jit = JO.prefill(jparams, JCFG, jnp.asarray(toks), sj, length=jnp.asarray([length]))
    lo, sj = _ops(JO.prefill, jparams, JCFG, jnp.asarray(toks), sj, length=jnp.asarray([length]))
    lt, st = TO.prefill(params, CFG, torch.as_tensor(toks, dtype=torch.long), st,
                        length=torch.tensor([length]))
    assert _rel(_np(lo), _np(lt)) <= 0.01 and _rel(_np(sj["k"]), _np(st["k"])) <= 0.01
    assert _rel(_np(lj), _np(lt)) <= 0.03
    assert int(sj["pos"][0]) == int(st["pos"][0]) == length
    st = {k: _t(v) for k, v in sj.items()}  # decode on from the reference's cache
    for i in range(2):
        tok = np.array([[9 + i]], np.int32)
        lo, sj = _ops(JO.decode_step, jparams, JCFG, sj, jnp.asarray(tok))
        lt, st = TO.decode_step(params, CFG, st, torch.as_tensor(tok, dtype=torch.long))
        assert lt.shape == (1, 1, CFG.padded_vocab)
        assert torch.equal(lt, _t(lo))
    assert torch.equal(st["k"], _t(sj["k"])) and torch.equal(st["v"], _t(sj["v"]))
    assert int(st["pos"][0]) == length + 2


# ---------------------------------------------------------------------------
# the reference's moe engine cases on the port's engine
# ---------------------------------------------------------------------------


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, size=n).tolist() for n in lens]


def _solo(p, prompt, max_new=6):
    """Bucketed-engine solo serving: the port's token oracle."""
    r = Request(np.asarray(prompt), max_new=max_new)
    ContinuousBatchingEngine(CFG, p, batch_slots=1, max_len=64, device="cpu").serve([r])
    assert r.done
    return r.out


def test_speculative_greedy_token_equality_moe(params):
    prompts = _prompts((5, 23, 17, 9), seed=1)
    oracles = [_solo(params, p, max_new=24) for p in prompts]
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                   paged=True, page_size=8, n_pages=24, speculation=True,
                                   spec_k=4)
    assert eng.speculation
    reqs = [Request(np.asarray(p), max_new=24) for p in prompts]
    eng.serve(reqs)
    eng.check_page_invariants()
    for k, (r, o) in enumerate(zip(reqs, oracles)):
        assert r.out == o, (k, r.out, o)
    th = eng.throughput()
    assert th["routing"].get("paged_decode/kernel", 0) >= 1, th["routing"]
    assert th["spec_launches"] == th["decode_steps"] > 0
    cs = eng.compile_stats()
    assert cs["spec_traces"] == 1 and cs["decode_traces"] == 0, cs


def _ragged_engine(params):
    return ContinuousBatchingEngine(CFG, params, batch_slots=3, max_len=64, device="cpu",
                                    paged=True, ragged=True, token_budget=16)


def test_ragged_interleaved_token_equality_moe(params):
    """Pad rows route through the experts and take capacity; at
    capacity_factor 4 nothing drops, so interleaved ragged serving gives
    each request the tokens it gets served alone in ragged mode, and the
    bucketed solo oracle's for the prompts that fit one chunk. (A prompt
    cut into chunks is held to the bucketed oracle only on the card: the
    plain ragged attention here sums its f32 terms per chunk, as the
    reference's oracle does, and the 23-token prompt's first greedy token is
    a bf16 tie, 2.2969 twice, that those last bits settle either way. The
    CUDA kernel's rows keep their bits over any chunking, and
    ``chip_smoke.py`` holds its 1024-token prompt, served in chunks, to the
    solo run.)"""
    prompts = _prompts((5, 23, 17, 9))
    oracles = [_solo(params, p) for p in prompts]
    eng = _ragged_engine(params)
    assert eng.ragged
    reqs = [Request(np.asarray(p), max_new=6) for p in prompts]
    for r in reqs:
        eng.submit(r)
        eng.step()
        eng.check_page_invariants()
    eng.run_until_done()
    eng.check_page_invariants()
    for k, (p, r, o) in enumerate(zip(prompts, reqs, oracles)):
        alone = Request(np.asarray(p), max_new=6)
        _ragged_engine(params).serve([alone])
        assert r.out == alone.out, (k, r.out, alone.out)
        if len(p) <= 16:
            assert r.out == o, (k, r.out, o)
    cs = eng.compile_stats()
    assert cs["ragged_traces"] == 1 and cs["decode_traces"] == 0, cs
    assert set(eng.routing()) == {"ragged/kernel"}


def test_prefix_cache_hit_equivalence_moe(params):
    """A prefix hit skips the cached pages' prefill (MoE FFN blocks behind
    them): the hit's tokens equal a cold run's and the solo oracle's."""
    pre = list(range(1, 33))  # 4 full pages at page_size 8
    p1, p2 = pre + [40, 41, 42], pre + [50, 51]
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                   paged=True, page_size=8)
    assert eng.prefix_cache is not None
    eng.serve([Request(np.asarray(p1), max_new=4)])
    cold = eng.stats["prefill_tokens"]
    r2 = Request(np.asarray(p2), max_new=4)
    eng.serve([r2])
    eng.check_page_invariants()
    assert eng.stats["prefix_hits"] == 1 and eng.stats["prefix_hit_tokens"] == 32
    assert eng.stats["prefill_tokens"] - cold == len(p2) - 32
    r2c = Request(np.asarray(p2), max_new=4)
    ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu", paged=True,
                             page_size=8, prefix_caching=False).serve([r2c])
    assert r2.out == r2c.out == _solo(params, p2, 4)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 200, size=n)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculation"])
def test_randomized_schedule_moe(params, spec):
    """The reference's seeded schedules of submits, cancels and deadline
    expiries under page pressure with preemption on (6-page pool), without
    and with speculative decoding, on the MoE family: every request ends
    terminal, survivors' tokens equal the solo oracle, no page leaks."""
    rng = np.random.default_rng(42)
    extra = dict(speculation=True, spec_k=4) if spec else {}
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                   paged=True, page_size=16, n_pages=6, preemption=True, **extra)
    assert eng.speculation == spec
    prompts = {k: _prompt(int(rng.integers(8, 20)), 100 + k) for k in range(6)}
    reqs = {k: Request(v, max_new=6, priority=int(rng.integers(0, 3)),
                       deadline_steps=(None if rng.random() < 0.7 else int(rng.integers(2, 30))))
            for k, v in prompts.items()}
    pending = list(reqs)
    with lifecycle_checks(eng), page_invariant_checks(eng):
        for _ in range(200):
            if pending and rng.random() < 0.4:
                eng.submit(reqs[pending.pop(0)])
            if rng.random() < 0.1:
                eng.cancel(reqs[int(rng.integers(6))])  # may be a no-op
            if eng.step() == 0 and not eng.queue and not pending:
                break
    assert not pending
    leaked = eng.allocator.n_used - (len(eng.prefix_cache) if eng.prefix_cache else 0)
    assert leaked <= 0
    for k, r in reqs.items():
        assert r.status in RequestState.TERMINAL, (k, r.status)
        if r.status == RequestState.DONE and not r.truncated:
            assert r.out == _solo(params, prompts[k].tolist()), k
    eng.check_page_invariants()
    if spec:
        assert assert_compile_budget(eng)["spec_traces"] <= 1


# ---------------------------------------------------------------------------
# the engine's family gates
# ---------------------------------------------------------------------------


@pytest.fixture
def stand_in(monkeypatch):
    """A family with the dense entry points but no ``ragged_step``, no
    multi-row paged decode and no page-addressable state as far as the
    engine's gates know (the reference's recurrent or encoder families)."""
    fam = SimpleNamespace(**{k: v for k, v in vars(registry._DENSE).items()
                             if k != "ragged_step"})
    monkeypatch.setitem(registry._FAMILIES, "stand_in", fam)
    cfg = ModelConfig(name="stand-in", family="stand_in", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
    return cfg, TD.init_params(cfg, seed=0, device="cpu")


def _serves(eng, cfg, p) -> None:
    """The fallback serves: greedy tokens equal a bucketed solo run's."""
    prompt = _prompt(11, 3)
    r = Request(prompt, max_new=5)
    eng.serve([r])
    solo = Request(prompt, max_new=5)
    ContinuousBatchingEngine(cfg, p, batch_slots=1, max_len=64, device="cpu").serve([solo])
    assert r.done and r.out == solo.out


def test_ragged_needs_a_family_with_ragged_step(stand_in):
    cfg, p = stand_in
    with pytest.warns(UserWarning, match="a family with a ragged_step"):
        eng = ContinuousBatchingEngine(cfg, p, batch_slots=2, max_len=64, device="cpu",
                                       paged=True, ragged=True, prefix_caching=False)
    assert not eng.ragged and eng.allocator is not None
    _serves(eng, cfg, p)


def test_speculation_needs_dense_or_moe(stand_in):
    cfg, p = stand_in
    with pytest.warns(UserWarning, match="multi-row paged decode"):
        eng = ContinuousBatchingEngine(cfg, p, batch_slots=2, max_len=64, device="cpu",
                                       paged=True, speculation=True, prefix_caching=False)
    assert not eng.speculation
    _serves(eng, cfg, p)
    assert eng.compile_stats()["spec_traces"] == 0


def test_prefix_cache_needs_a_page_addressable_family(stand_in, params):
    cfg, p = stand_in
    with pytest.warns(UserWarning, match="page-addressable"):
        eng = ContinuousBatchingEngine(cfg, p, batch_slots=2, max_len=64, device="cpu",
                                       paged=True)
    assert eng.prefix_cache is None and eng.allocator is not None
    _serves(eng, cfg, p)
    with warnings.catch_warnings():  # dense and moe keep their prefix cache, quietly
        warnings.simplefilter("error")
        assert ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                        paged=True).prefix_cache is not None
