"""The port's self-speculative decoding (repro_torch.launch.serve: the n-gram
self-draft, the draft hook, the stacked verify launch and greedy acceptance
with pos-rewind rollback) held to the JAX package and to the port's own
non-speculative engine.

Tolerances: the n-gram draft equals the reference's exactly on seeded
histories; speculative greedy tokens equal the port's plain engine token for
token (dense and paged, bf16 and W4A4), as the reference holds its own;
sampled slots keep their random streams exactly; first greedy tokens equal
the JAX speculative engine's wherever the reference's top-2 margin exceeds
0.05 (bf16 logits tolerance, as in tests/test_torch_serve.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.launch.serve import _ngram_draft as j_ngram
from repro.models import dense as JD
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.twinquant import quantize_params
from repro_torch.interop import params_from_numpy
from repro_torch.launch.serve import ContinuousBatchingEngine, Request, SamplingParams, _ngram_draft
from repro_torch.models import dense as TD

torch.set_num_threads(2)

KW = dict(name="tiny-paged", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, d_ff=128, vocab=256)
JCFG, CFG = JCfg(**KW, remat=False), ModelConfig(**KW)


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, size=n).tolist() for n in lens]


def _solo(p, prompt, max_new=6, max_len=64, cfg=CFG, sampling=None):
    """Non-speculative bucketed solo serving: the token oracle."""
    r = Request(np.asarray(prompt), max_new=max_new, sampling=sampling or SamplingParams())
    ContinuousBatchingEngine(cfg, p, batch_slots=1, max_len=max_len, device="cpu").serve([r])
    assert r.done
    return r


def _spec(p, max_len=64, cfg=CFG, **kw):
    return ContinuousBatchingEngine(cfg, p, batch_slots=2, max_len=max_len, device="cpu",
                                    paged=True, page_size=8, n_pages=24, speculation=True,
                                    spec_k=4, **kw)


def test_ngram_draft_matches_jax():
    assert _ngram_draft([5, 6, 7, 8, 5, 6, 7], 3) == [8, 5, 6]
    assert _ngram_draft([9], 2) == [9, 9] and _ngram_draft([], 2) == [0, 0]
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(0, 40))
        hist = rng.integers(0, int(rng.integers(2, 9)), n).tolist()  # small alphabets repeat
        k = int(rng.integers(1, 8))
        assert _ngram_draft(hist, k) == j_ngram(hist, k), (hist, k)


def test_speculative_greedy_token_equality(params):
    """Drafts only shortcut steps the plain engine would take: greedy tokens
    equal the solo oracle's, through the paged-decode route, with one (batch,
    spec_k) launch shape and no page leaked across rollbacks."""
    prompts = _prompts((5, 23, 17, 9), seed=1)
    oracles = [_solo(params, p, max_new=24).out for p in prompts]
    eng = _spec(params)
    reqs = [Request(np.asarray(p), max_new=24) for p in prompts]
    eng.serve(reqs)
    eng.check_page_invariants()
    for k, (r, o) in enumerate(zip(reqs, oracles)):
        assert r.out == o, (k, r.out, o)
    th = eng.throughput()
    assert th["routing"].get("paged_decode/kernel", 0) >= 1, th["routing"]
    assert 0.0 <= th["acceptance_rate"] <= 1.0 and th["tokens_per_step"] >= 1.0
    assert th["spec_launches"] == th["decode_steps"] > 0
    cs = eng.compile_stats()
    assert cs["spec_traces"] == 1 and cs["decode_traces"] == 0, cs


@pytest.mark.parametrize("mode", ["w4a4", "w4a16"])
def test_speculative_greedy_equality_quantized(mode):
    """The same bar through the packed paths (d_model 256 so every linear
    packs). W4A4: the verify launch runs the linears at M = B * spec_k
    through the GEMM route, the plain decode at M = B through the GEMV
    route. W4A16: one weight-only route at both M, whose rows do not depend
    on M."""
    cfg = ModelConfig(name="q", n_layers=1, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=512, vocab=260)
    qp = quantize_params(TD.init_params(cfg, seed=0, device="cpu"), cfg,
                         QuantSpec(mode=mode, rank=32))
    prompts = [[5, 6, 7, 5, 6, 7, 5, 6], list(range(3, 15))]
    oracles = [_solo(qp, p, max_new=10, max_len=48, cfg=cfg).out for p in prompts]
    eng = _spec(qp, max_len=48, cfg=cfg)
    reqs = [Request(np.asarray(p), max_new=10) for p in prompts]
    eng.serve(reqs)
    assert [r.out for r in reqs] == oracles
    routes = eng.routing()
    assert not any("/ref" in k for k in routes), routes
    if mode == "w4a16":
        calls = eng.stats["spec_launches"] + eng.compile_stats()["prefill_calls"]
        assert routes["w4a16/prefill"] == 7 * cfg.n_layers * calls, routes
        assert not any(k.startswith("dual") for k in routes), routes
    else:
        assert routes["dual_fused/prefill"] > 0, routes


def test_speculative_sampled_slots_keep_rng_stream(params):
    prompts = _prompts((7, 12), seed=4)
    sp = SamplingParams(temperature=1.0, top_k=20, seed=42)
    oracle_g = _solo(params, prompts[0], max_new=12).out
    oracle_s = _solo(params, prompts[1], max_new=12, sampling=sp).out
    eng = _spec(params)
    greedy = Request(np.asarray(prompts[0]), max_new=12)
    sampled = Request(np.asarray(prompts[1]), max_new=12, sampling=sp)
    eng.serve([greedy, sampled])
    assert greedy.out == oracle_g and sampled.out == oracle_s


def test_speculative_truncation_matches_oracle(params):
    (prompt,) = _prompts([24], seed=6)
    oracle = _solo(params, prompt, max_new=20, max_len=32)
    assert oracle.truncated
    eng = _spec(params, max_len=32)
    req = Request(np.asarray(prompt), max_new=20)
    eng.serve([req])
    assert req.out == oracle.out and req.truncated == oracle.truncated
    eng.check_page_invariants()


def test_draft_fn_hook_cannot_crash_the_engine(params):
    (prompt,) = _prompts([9], seed=9)
    oracle = _solo(params, prompt, max_new=10).out
    eng = _spec(params, draft_fn=lambda req, k: [10**9, -5, 3])
    req = Request(np.asarray(prompt), max_new=10)
    eng.serve([req])
    assert req.out == oracle


def test_speculation_without_paged_falls_back_with_warning(params):
    with pytest.warns(UserWarning, match="speculation"):
        eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                       speculation=True)
    assert not eng.speculation
    (prompt,) = _prompts([7])
    req = Request(np.asarray(prompt), max_new=4)
    eng.serve([req])
    assert req.out == _solo(params, prompt, max_new=4).out


@pytest.mark.parametrize("bad_k", [1, 99])
def test_spec_k_validation(params, bad_k):
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                 paged=True, page_size=8, n_pages=24, speculation=True,
                                 spec_k=bad_k)


def test_first_tokens_match_jax_spec_engine(jparams, params):
    """The slice as a whole: the port's speculative engine and the
    reference's, on bridged params, give the same first greedy tokens
    wherever the reference's top-2 margin exceeds 0.05."""
    prompts = [[1, 2, 3], [7] * 5, [100, 3, 99, 4, 5, 6], list(range(50, 59)),
               list(range(10, 22)), [3, 1] * 8]
    kw = dict(batch_slots=2, max_len=64, paged=True, page_size=8, n_pages=24,
              speculation=True, spec_k=4)
    jreqs = [JRequest(jnp.asarray(p, jnp.int32), max_new=3) for p in prompts]
    JEngine(JCFG, jparams, **kw).serve(jreqs)
    treqs = [Request(np.asarray(p), max_new=3) for p in prompts]
    ContinuousBatchingEngine(CFG, params, device="cpu", **kw).serve(treqs)

    @jax.jit
    def last_logits(toks, length):
        logits, _ = JD.prefill(jparams, JCFG, toks, JD.init_decode_state(JCFG, 1, 64),
                               length=length)
        return logits[0, -1, :KW["vocab"]].astype(jnp.float32)

    checked = 0
    for p, jr, tr in zip(prompts, jreqs, treqs):
        toks = np.zeros((1, 8 if len(p) <= 8 else 16), np.int32)
        toks[0, :len(p)] = p
        top = np.sort(np.asarray(last_logits(jnp.asarray(toks), jnp.asarray([len(p)]))))
        if top[-1] - top[-2] > 0.05:
            assert tr.out[0] == jr.out[0], (p, tr.out, jr.out)
            checked += 1
    assert checked >= 3
