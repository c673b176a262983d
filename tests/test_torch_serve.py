"""The port's bucketed engine (repro_torch.launch.serve): the DESIGN.md §10
invariant (a request served interleaved with others gives the tokens it
gives alone), first greedy tokens against the JAX engine on the same
bridged params, preemption, and submit() validation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.models import dense as JD
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.twinquant import quantize_params
from repro_torch.interop import params_from_numpy
from repro_torch.launch.serve import ContinuousBatchingEngine, Request, SamplingParams

torch.set_num_threads(2)

KW = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, d_ff=128, vocab=128)
JC, TC = JCfg(**KW, remat=False), ModelConfig(**KW)


@pytest.fixture(scope="module")
def params():
    pj = JD.init_params(JC, jax.random.PRNGKey(0))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), TC, "cpu")


def _engine(p, **kw):
    return ContinuousBatchingEngine(TC, p, **{"batch_slots": 2, "max_len": 64, "device": "cpu",
                                              **kw})


def _solo(p, prompt, max_new=8):
    r = Request(np.asarray(prompt), max_new=max_new)
    _engine(p).serve([r])
    return r.out


def test_interleaved_equals_solo(params):
    _, pt = params
    a, b = list(range(10, 22)), list(range(100, 105))
    eng = _engine(pt)
    ra = Request(np.asarray(a), max_new=8)
    eng.submit(ra)
    for _ in range(3):  # A is mid-generation when B arrives
        eng.step()
    rb = Request(np.asarray(b), max_new=8)
    eng.submit(rb)
    eng.run_until_done()
    assert ra.status == rb.status == "DONE" and ra.done and rb.done
    assert ra.out == _solo(pt, a)
    assert rb.out == _solo(pt, b)


@pytest.mark.parametrize("mode", ["w4a4", "w4a16"])
def test_interleaved_equals_solo_quantized(mode):
    """The same invariant through the packed paths (d_model 256, so every
    block linear packs): W4A4 with fusion on, and the W4A16 baseline, whose
    seven weight-only linears a layer route ``w4a16/prefill`` at every M."""
    cfg = ModelConfig(name="q", n_layers=1, d_model=256, n_heads=4, n_kv_heads=2,
                      head_dim=64, d_ff=512, vocab=260)
    from repro_torch.models import dense

    qp = quantize_params(dense.init_params(cfg, seed=0, device="cpu"), cfg,
                         QuantSpec(mode=mode, rank=32))
    prompts = [list(range(3, 15)), [9, 8, 7], list(range(40, 60))]
    eng = ContinuousBatchingEngine(cfg, qp, batch_slots=2, max_len=48, device="cpu")
    reqs = [Request(np.asarray(p), max_new=5) for p in prompts]
    eng.serve(reqs)
    routes = eng.routing()  # process-wide counters: read before the solo runs
    for p, r in zip(prompts, reqs):
        solo = Request(np.asarray(p), max_new=5)
        ContinuousBatchingEngine(cfg, qp, batch_slots=2, max_len=48, device="cpu").serve([solo])
        assert r.out == solo.out
    if mode == "w4a16":
        calls = eng.stats["decode_steps"] + eng.compile_stats()["prefill_calls"]
        assert routes == {"w4a16/prefill": 7 * cfg.n_layers * calls}, routes
        return
    assert routes["dual_fused/decode"] > 0 and routes["dual/decode"] > 0
    assert routes["dual_fused/prefill"] > 0 and not any("/ref" in k for k in routes)


def test_first_token_matches_jax_engine(params):
    """Greedy first tokens equal the JAX engine's wherever the reference's
    top-2 logit margin exceeds the bf16 logits tolerance (0.05). Prompt
    lengths stay in two buckets (8, 16) to keep the reference's compiles few."""
    pj, pt = params
    prompts = [[1, 2, 3], [7] * 5, [100, 3, 99, 4, 5, 6], list(range(50, 59)),
               list(range(10, 22)), [3, 1] * 8]
    jreqs = [JRequest(jnp.asarray(p, jnp.int32), max_new=2) for p in prompts]
    JEngine(JC, pj, batch_slots=2, max_len=64).serve(jreqs)
    treqs = [Request(np.asarray(p), max_new=2) for p in prompts]
    _engine(pt).serve(treqs)

    @jax.jit
    def last_logits(toks, length):
        logits, _ = JD.prefill(pj, JC, toks, JD.init_decode_state(JC, 1, 64), length=length)
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


def test_sampled_request_is_seeded(params):
    _, pt = params
    outs = []
    for _ in range(2):
        r = Request(np.arange(5, 12), max_new=6,
                    sampling=SamplingParams(temperature=1.0, top_k=20, seed=3))
        _engine(pt).serve([r])
        outs.append(r.out)
    assert outs[0] == outs[1] and len(outs[0]) == 6


def test_accounting_surfaces(params):
    _, pt = params
    eng = _engine(pt)
    seen = []
    reqs = [Request(np.arange(1, 4), max_new=4, on_token=lambda r, t: seen.append(t)),
            Request(np.arange(1, 20), max_new=4)]
    eng.serve(reqs)
    assert seen == reqs[0].out
    assert all(len(r.token_times) == 4 and r.t_first_token >= r.t_submit for r in reqs)
    cs = eng.compile_stats()
    assert cs["prefill_buckets"] == [8, 32] and cs["prefill_calls"] == 2
    tp = eng.throughput()
    assert tp["requests_done"] == 2 and tp["decode_tokens"] > 0 and tp["routing"] == {}


def test_preemption_constructs_and_preempts(params):
    """``preemption=True`` builds a paged engine, and a higher-priority
    arrival that the 3-page pool cannot hold preempts the live request,
    which resumes and finishes with its solo tokens."""
    _, pt = params
    eng = _engine(pt, paged=True, page_size=16, n_pages=3, preemption=True)
    low = Request(np.arange(20, 40), max_new=8, priority=0)
    eng.submit(low)
    for _ in range(3):
        eng.step()
    high = Request(np.arange(60, 80), max_new=8, priority=1)
    eng.submit(high)
    assert low.status == "PREEMPTED" and eng.stats["requests_preempted"] == 1
    eng.run_until_done()
    assert low.status == high.status == "DONE" and low._preemptions == 1
    assert low.out == _solo(pt, np.arange(20, 40)) and high.out == _solo(pt, np.arange(60, 80))


def test_submit_rejects_bad_prompts(params):
    _, pt = params
    eng = _engine(pt)
    with pytest.raises(ValueError, match="vocab"):
        eng.submit(Request(np.asarray([1, 2, KW["vocab"]])))
    with pytest.raises(ValueError, match="vocab"):
        eng.submit(Request(np.asarray([-1, 2])))
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(Request(np.ones((2, 2), np.int32)))
    with pytest.raises(ValueError, match="integer"):
        eng.submit(Request(np.asarray([1.0, 2.0])))
    with pytest.raises(ValueError, match="reject|truncate"):
        _engine(pt, on_truncation="reject").submit(Request(np.arange(60), max_new=10))
    assert not eng.queue and all(s is None for s in eng.slots)


def test_engine_defaults_to_the_card(params, monkeypatch):
    _, pt = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(TC, pt)
