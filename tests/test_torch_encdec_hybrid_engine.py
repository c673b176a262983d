"""The serving engine of the port with the ``encdec`` (``whisper-base``) and
``mamba_hybrid`` (``zamba2-1.2b``) families at their reduced configs: the
reference's ``test_paged_interleaving_invariant_mamba_hybrid``; Whisper's
frames frontend (solo == interleaved for requests with different frames,
bucketed == paged); the prefix-cache, ragged and speculation gates (warn,
fall back, same tokens); preemption resuming by re-prefilling the
effective prompt; the constant ``_sub_template`` still zero after a
serve; and greedy tokens equal to the JAX engine's.

Tolerances: none. Every comparison is of greedy token ids. The JAX engine
runs its jitted steps, the port its plain versions on the CPU; at these
configs the two agree token for token.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.models import registry as JR
from repro_torch.analysis.sanitizers import guarded_decode, lifecycle_checks, page_invariant_checks
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.launch.serve import ContinuousBatchingEngine, Request, RequestState

torch.set_num_threads(2)

NAMES = ["whisper-base", "zamba2-1.2b"]


@pytest.fixture(scope="module")
def models():
    """name -> (cfg, JAX cfg, JAX params, port params bridged from them)."""
    out = {}
    for name, seed in zip(NAMES, (0, 2)):
        cfg = get_config(name, reduced=True)
        jc = j_get_config(name, reduced=True).replace(remat=False)
        jp = JR.get_model(jc).init_params(jc, jax.random.PRNGKey(seed))
        out[name] = (cfg, jc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu"))
    return out


def _frames(cfg, seed):
    f = jax.random.normal(jax.random.PRNGKey(seed), (1, cfg.n_frames, cfg.d_model), jnp.bfloat16)
    return f, to_torch(np.asarray(f), "cpu")


def _req(cfg, prompt, seed=0, **kw):
    fe = {"frames": _frames(cfg, seed)[1]} if cfg.family == "encdec" else {}
    return Request(np.asarray(prompt, np.int32), frontend=fe, **kw)


def _engine(cfg, p, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no prefix cache for these families (its own test)
        return ContinuousBatchingEngine(cfg, p, **{"batch_slots": 2, "max_len": 64,
                                                   "device": "cpu", **kw})


def _solo(cfg, p, prompt, seed=0, max_new=5):
    """Bucketed solo serving: the token oracle."""
    r = _req(cfg, prompt, seed, max_new=max_new)
    _engine(cfg, p, batch_slots=1).serve([r])
    assert r.status == RequestState.DONE
    return r.out


A, B = list(range(10, 22)), list(range(100, 105))


def test_paged_interleaving_invariant_mamba_hybrid(models):
    """The reference's case on the port: the shared block's K/V page through
    the pool while the recurrent ``ssm`` / ``conv`` leaves stay per slot;
    ``b`` admitted while ``a`` is mid-generation, under the page-invariant
    audit after every step and ``guarded_decode`` after the admissions;
    both equal their bucketed solo runs."""
    cfg, _, _, p = models["zamba2-1.2b"]
    eng = _engine(cfg, p, paged=True, page_size=16)
    with page_invariant_checks(eng):
        ra = _req(cfg, A, max_new=5)
        eng.submit(ra)
        for _ in range(2):
            eng.step()
        rb = _req(cfg, B, max_new=5)
        eng.submit(rb)
        with guarded_decode():
            eng.run_until_done()
    assert "bt" in eng.state and "ssm" in eng.state  # pools + slot state coexist
    assert eng.state["ssm"].shape[2] == 2 and eng.state["shared_k"].shape[1] == eng.n_pages
    assert ra.out == _solo(cfg, p, A) and rb.out == _solo(cfg, p, B)


@pytest.mark.parametrize("paged", [False, True], ids=["bucketed", "paged"])
def test_whisper_solo_equals_interleaved_with_different_frames(models, paged):
    """Each request behind its own frames: interleaved with another
    request (admitted mid-generation) it gives its solo tokens; the frames
    reach the decoder (the same prompt behind other frames differs);
    bucketed and paged agree (the paged case against the bucketed solo)."""
    cfg, _, _, p = models["whisper-base"]
    eng = _engine(cfg, p, paged=paged, page_size=8)
    ra, rb = _req(cfg, A, 1, max_new=5), _req(cfg, B, 2, max_new=5)
    eng.submit(ra)
    eng.step()
    eng.submit(rb)
    eng.run_until_done()
    eng.check_page_invariants()
    assert ra.out == _solo(cfg, p, A, 1) and rb.out == _solo(cfg, p, B, 2)
    assert _solo(cfg, p, A, 3) != ra.out
    assert eng.stats["prefix_lookups"] == 0 and eng.prefix_cache is None


@pytest.mark.parametrize("name", NAMES)
def test_prefix_ragged_and_speculation_gates(models, name):
    """Paged with the prefix cache on warns and serves without it (no
    lookup, the reference's check); ragged and speculation warn and fall
    back to bucketed prefill + one-token decode with the same tokens."""
    cfg, _, _, p = models[name]
    with pytest.warns(UserWarning, match="prefix_caching"):
        eng = ContinuousBatchingEngine(cfg, p, batch_slots=2, max_len=64, device="cpu",
                                       paged=True, page_size=8)
    assert eng.prefix_cache is None
    want = _solo(cfg, p, A)
    for kw, what in ((dict(ragged=True, token_budget=32), "ragged=True"),
                     (dict(speculation=True), "speculation=True")):
        with pytest.warns(UserWarning, match=what):
            e2 = ContinuousBatchingEngine(cfg, p, batch_slots=2, max_len=64, device="cpu",
                                          paged=True, prefix_caching=False, **kw)
        assert not e2.ragged and not e2.speculation
        r = _req(cfg, A, max_new=5)
        e2.serve([r])
        assert r.out == want and e2.stats["prefix_lookups"] == 0
    r = _req(cfg, A, max_new=5)
    eng.serve([r])
    assert r.out == want and eng.stats["prefix_lookups"] == 0


@pytest.mark.parametrize("name", NAMES)
def test_preemption_resumes_by_reprefill(models, name):
    """Page pressure preempts the low-priority request; with no prefix cache
    its readmission re-prefills the effective prompt (prompt + tokens so
    far), and its greedy tokens are the uninterrupted solo run's. The
    engine's constant batch-1 ``_sub_template`` is still zero after it."""
    cfg, _, _, p = models[name]
    eng = _engine(cfg, p, paged=True, page_size=16, n_pages=3, preemption=True)
    low = _req(cfg, list(range(20, 40)), 1, max_new=8, priority=0)
    seen = []
    low.on_token = lambda r, t: seen.append(t)
    with lifecycle_checks(eng), page_invariant_checks(eng):
        eng.submit(low)
        for _ in range(4):
            eng.step()
        assert len(low.out) >= 1
        high = _req(cfg, list(range(60, 80)), 2, max_new=8, priority=1)
        eng.submit(high)
        eng.run_until_done()
    assert eng.stats["requests_preempted"] >= 1 and low._preemptions >= 1
    assert low.status == high.status == RequestState.DONE and seen == low.out
    assert eng.stats["prefix_hits"] == 0
    calls = eng.compile_stats()["prefill_calls"]
    assert calls == 3  # low, high, low's resume over prompt + generated tokens
    assert low.out == _solo(cfg, p, list(range(20, 40)), 1, max_new=8)
    assert high.out == _solo(cfg, p, list(range(60, 80)), 2, max_new=8)
    assert all(not t.any() for t in eng._sub_template.values())


@pytest.mark.parametrize("paged", [False, True], ids=["bucketed", "paged"])
@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_equal_the_jax_engine(models, name, paged):
    """Three requests of three prompt buckets through the port's engine and
    the JAX package's, interleaved two slots at a time: the same greedy
    tokens; the template state of the port's engine still zero."""
    cfg, jc, jp, p = models[name]
    prompts = [list(range(3, 8)), list(range(40, 52)), list(range(200, 230))]
    kw = dict(paged=True, page_size=8, prefix_caching=False) if paged else {}
    eng = _engine(cfg, p, **kw)
    reqs = [_req(cfg, pr, i, max_new=6) for i, pr in enumerate(prompts)]
    eng.serve(reqs)
    assert all(not t.any() for t in eng._sub_template.values())
    jeng = JEngine(jc, jp, batch_slots=2, max_len=64, **kw)
    jreqs = [JRequest(jnp.asarray(pr, jnp.int32), max_new=6,
                      frontend={"frames": _frames(cfg, i)[0]} if cfg.family == "encdec" else {})
             for i, pr in enumerate(prompts)]
    jeng.serve(jreqs)
    assert [r.out for r in reqs] == [r.out for r in jreqs]
