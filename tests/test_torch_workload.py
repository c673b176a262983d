"""The port's traffic harness (``repro_torch.launch.workload``), stream API
and SLO metrics (``repro_torch.launch.metrics``): the cases of the
reference's ``tests/test_workload.py`` on the port's engine, and held to
the JAX package.

Parity with the reference, exact in every case:
* ``make_workload`` with the same seed and knobs gives the same arrivals,
  scenarios, prompts, quotas, priorities and deadlines in both packages
  (one ``np.random.default_rng`` stream drawn in the same order);
* ``percentiles`` / ``summarize`` give equal dicts on requests stamped
  alike;
* one seeded workload with preemption replayed through the JAX engine and
  the port's, on the same (bridged) params, in paged and in ragged mode,
  gives the same lifecycle trace: per request its status, error code,
  token count and preemptions, the integer stats counters and the queue
  depth at every step. Nothing stops on a token, so tokens do not steer
  the schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.launch import metrics as jmetrics
from repro.launch import workload as jworkload
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.models import dense as JD
from repro_torch.analysis.sanitizers import lifecycle_checks, page_invariant_checks
from repro_torch.configs import ModelConfig
from repro_torch.interop import params_from_numpy
from repro_torch.launch.metrics import SLO, meets_slo, percentiles, summarize
from repro_torch.launch.serve import (
    ContinuousBatchingEngine,
    EngineStalledError,
    Request,
    RequestState,
)
from repro_torch.launch.workload import (
    Scenario,
    default_scenarios,
    make_workload,
    poisson_arrivals,
    replay,
)
from repro_torch.models import dense as TD

torch.set_num_threads(2)

KW = dict(name="tiny-wl", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, d_ff=128, vocab=256)
JCFG, CFG = JCfg(**KW, remat=False), ModelConfig(**KW)


@pytest.fixture(scope="module")
def params():
    return TD.init_params(CFG, seed=0, device="cpu")


def _engine(p, **kw):
    return ContinuousBatchingEngine(CFG, p, **{"batch_slots": 2, "max_len": 64, "device": "cpu",
                                               **kw})


# ---------------------------------------------------------------------------
# workload determinism (no engine)
# ---------------------------------------------------------------------------


def _items(wl):
    return [(it.at, it.scenario, np.asarray(it.request.prompt).tolist(), it.request.max_new,
             it.request.priority, it.request.deadline_steps) for it in wl.items]


def test_same_seed_same_workload():
    assert _items(make_workload(11, n_requests=8)) == _items(make_workload(11, n_requests=8))


def test_different_seed_different_workload():
    a, b = make_workload(11, n_requests=8), make_workload(12, n_requests=8)
    assert any(not np.array_equal(x.request.prompt, y.request.prompt)
               for x, y in zip(a.items, b.items))


def test_poisson_arrivals_sorted_and_seeded():
    rng = np.random.default_rng(3)
    at = poisson_arrivals(rng, 20, 4.0)
    assert at[0] == 0 and at == sorted(at) and len(at) == 20
    assert poisson_arrivals(np.random.default_rng(3), 20, 4.0) == at
    assert poisson_arrivals(rng, 0, 4.0) == []


def test_trace_replay_arrivals_verbatim():
    trace = [0, 0, 5, 9, 40]
    wl = make_workload(5, n_requests=10, trace=trace,
                       scenarios=[Scenario("s", 1.0, (4, 6), (2, 3))])
    assert [it.at for it in wl.items] == trace  # the trace caps the count too


def test_shared_prefix_shared_within_scenario():
    wl = make_workload(2, n_requests=12)
    chat = [it.request for it in wl.items if it.scenario == "chat"]
    pre = default_scenarios()[0].shared_prefix_len
    assert len(chat) >= 2
    assert all(np.array_equal(r.prompt[:pre], chat[0].prompt[:pre]) for r in chat)


def test_workload_exercises_lifecycle_knobs():
    wl = make_workload(4, n_requests=16)
    assert {it.request.priority for it in wl.items} == {0, 1, 2}
    assert any(it.request.deadline_steps is not None for it in wl.items)
    by_at: dict = {}
    for it in wl.items:
        by_at.setdefault(it.at, []).append(it.scenario)
    assert any(v.count("burst") >= 3 for v in by_at.values())


@pytest.mark.parametrize("seed,n,page,vocab,trace", [
    (0, 12, 16, 128256, None), (4, 16, 8, 256, None), (21, 6, 8, 256, None),
    (5, 10, 8, 256, [0, 0, 5, 9, 40]),
], ids=["chip", "mix16", "replay", "trace"])
def test_make_workload_matches_reference(seed, n, page, vocab, trace):
    """The same seed gives identical items in both packages (``chip`` is
    ``chip_smoke.py``'s lifecycle workload at llama3-8b's vocab)."""
    kw = dict(n_requests=n, mean_gap_steps=4, vocab=vocab, trace=trace)
    ours = make_workload(seed, scenarios=default_scenarios(page_size=page), **kw)
    ref = jworkload.make_workload(seed, scenarios=jworkload.default_scenarios(page_size=page),
                                  **kw)
    assert _items(ours) == _items(ref) and ours.seed == ref.seed == seed
    assert [s.__dict__ for s in default_scenarios(page)] == [
        s.__dict__ for s in jworkload.default_scenarios(page)]
    assert poisson_arrivals(np.random.default_rng(seed), n, 4.0) == \
        jworkload.poisson_arrivals(np.random.default_rng(seed), n, 4.0)


# ---------------------------------------------------------------------------
# replay determinism through the engine
# ---------------------------------------------------------------------------


def _replayed(params, *, seed, ragged):
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=3, max_len=96, device="cpu",
                                   paged=True, page_size=8, preemption=True, ragged=ragged,
                                   token_budget=16)
    wl = make_workload(seed, n_requests=5)
    with lifecycle_checks(eng), page_invariant_checks(eng):
        reqs = replay(eng, wl)
    assert all(r.done for r in reqs)
    return eng, reqs


@pytest.mark.parametrize("ragged", [False, True], ids=["bucketed", "ragged"])
def test_replay_same_seed_same_token_streams(params, ragged):
    _, a = _replayed(params, seed=21, ragged=ragged)
    _, b = _replayed(params, seed=21, ragged=ragged)
    assert [r.out for r in a] == [r.out for r in b]
    assert [r.status for r in a] == [r.status for r in b]


def test_replay_records_latency_surface(params):
    eng, reqs = _replayed(params, seed=21, ragged=True)
    lat = eng.latency(slo=SLO(ttft_s=120.0, tpot_s=120.0))
    assert lat["n_requests"] == len(reqs)
    assert lat["n_done"] == sum(r.status == RequestState.DONE for r in reqs)
    for key in ("ttft_ms", "tpot_ms", "e2e_ms"):
        p = lat[key]
        assert p["n"] > 0 and 0 <= p["p50"] <= p["p95"] <= p["p99"] <= p["max"]
    assert lat["queue_depth_max"] >= lat["queue_depth_mean"] >= 0.0
    assert 0.0 <= lat["slo_met_rate"] <= 1.0
    assert lat["prefix_hit_rate"] > 0.0, "chat scenario shares a paged prefix"
    assert lat["ttft_ms"]["n"] == len(reqs)


def test_reset_stats_clears_latency_surface(params):
    """After a warm-up, ``reset_stats()`` zeroes the counters and forgets
    the warm-up's requests and queue depths; the route baseline and launch
    shapes stay."""
    eng, _ = _replayed(params, seed=21, ragged=True)
    shapes = eng.compile_stats()
    eng.reset_stats()
    assert all(v == 0 for v in eng.stats.values())
    assert eng.latency()["n_requests"] == 0 and eng.latency()["queue_depth_max"] == 0
    assert eng.compile_stats() == shapes
    r = Request(np.arange(1, 9), max_new=3)
    eng.serve([r])
    lat = eng.latency()
    assert lat["n_requests"] == 1 and lat["n_done"] == 1 and eng.stats["requests_done"] == 1


# ---------------------------------------------------------------------------
# stream API: exactly-once callbacks, iterator contract
# ---------------------------------------------------------------------------


def test_stream_iterator_yields_emitted_tokens(params):
    eng = _engine(params)
    req = Request(np.arange(1, 9), max_new=6)
    got = []
    for tok in eng.stream(req):
        got.append(tok)
        assert req.t_first_token is not None, "TTFT stamped by the first yield"
    assert got == req.out and len(got) == 6 and req.done
    assert len(req.token_times) == 6


def test_stream_exhaustion_raises(params):
    """A stream that runs out of steps times out every unfinished request
    (pages back) and raises, as ``run_until_done`` does."""
    eng = _engine(params, paged=True)
    other = Request(np.arange(1, 12), max_new=20)
    eng.submit(other)
    req = Request(np.arange(1, 9), max_new=20)
    with pytest.raises(EngineStalledError, match="engine stalled"):
        list(eng.stream(req, max_steps=3))
    assert req.status == other.status == RequestState.TIMED_OUT
    assert req.error == "engine_stalled" and 0 < len(req.out) < 20
    assert eng.allocator.n_used == len(eng.prefix_cache)


def test_stream_callbacks_exactly_once_under_chaos(params):
    """A preemption-heavy schedule (3-page pool, priority mix, one cancel)
    where every request streams through ``on_token``: each callback fires
    once per emitted token, in emission order; a resume never replays the
    tokens already emitted."""
    eng = _engine(params, paged=True, page_size=16, n_pages=3, preemption=True, ragged=True,
                  token_budget=16)
    rng = np.random.default_rng(9)
    seen: dict[str, list[int]] = {}

    def on_token(req, tok):
        seen.setdefault(req.request_id, []).append(tok)

    reqs = [Request(rng.integers(1, 200, size=int(rng.integers(16, 24)), dtype=np.int32),
                    max_new=int(rng.integers(3, 8)), priority=i % 3, request_id=f"r{i}",
                    on_token=on_token)
            for i in range(8)]
    with lifecycle_checks(eng), page_invariant_checks(eng):
        eng.submit(reqs[0])
        for _ in range(4):
            eng.step()
        for r in reqs[1:]:
            eng.submit(r)
            if rng.random() < 0.5:
                eng.step()
        eng.cancel(reqs[5])
        eng.run_until_done()
    assert any(r._preemptions > 0 for r in reqs), "the schedule must preempt"
    for r in reqs:
        assert seen.get(r.request_id, []) == r.out, r.request_id
        assert len(r.token_times) == len(r.out)


def test_raising_callback_detached_not_fatal(params):
    eng = _engine(params)
    calls = []

    def bad(req, tok):
        calls.append(tok)
        raise RuntimeError("hostile consumer")

    req = Request(np.arange(1, 7), max_new=5, on_token=bad)
    with pytest.warns(UserWarning, match="callback detached"):
        eng.serve([req])
    assert req.done and req.status == RequestState.DONE
    assert len(req.out) == 5 and calls == req.out[:1] and req.on_token is None


# ---------------------------------------------------------------------------
# metrics (no engine)
# ---------------------------------------------------------------------------


def test_percentiles_empty_is_zero_shaped():
    assert percentiles([]) == {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0,
                               "n": 0}


def _stamped(cls=Request, status=RequestState.DONE, ttft=0.1, gaps=(0.01, 0.01)):
    req = cls(np.arange(4, dtype=np.int32), status=status, done=True)
    req.t_submit = 100.0
    req.t_first_token = 100.0 + ttft
    req.token_times = list(100.0 + ttft + np.cumsum((0.0,) + tuple(gaps)))
    req.out = [1] * len(req.token_times)
    req.t_done = req.token_times[-1]
    return req


def test_meets_slo_bounds():
    slo = SLO(ttft_s=0.5, tpot_s=0.05)
    assert meets_slo(_stamped(), slo)
    assert not meets_slo(_stamped(ttft=0.9), slo), "TTFT over budget"
    assert not meets_slo(_stamped(gaps=(0.2, 0.2)), slo), "TPOT over budget"
    assert not meets_slo(_stamped(status=RequestState.FAILED), slo)


def test_summarize_goodput_counts_only_slo_met_tokens():
    fast, slow = _stamped(), _stamped(ttft=0.9)
    out = summarize([fast, slow], slo=SLO(ttft_s=0.5, tpot_s=0.05),
                    queue_depths=[0, 2, 1], stats={"requests_preempted": 1})
    assert out["n_done"] == 2 and out["n_slo_met"] == 1
    assert out["slo_met_rate"] == 0.5 and out["preemption_rate"] == 0.5
    span = max(fast.t_done, slow.t_done) - 100.0
    assert out["goodput_tok_s"] == pytest.approx(len(fast.out) / span)
    assert out["queue_depth_mean"] == 1.0 and out["queue_depth_max"] == 2
    raw = summarize([fast, slow])
    assert raw["slo"] is None and raw["n_slo_met"] == 2


def test_summarize_matches_reference():
    """``summarize`` and ``percentiles`` give equal dicts in both packages
    on requests stamped alike (done, failed, slow, single-token)."""
    shapes = [dict(), dict(ttft=0.9), dict(status=RequestState.FAILED), dict(gaps=()),
              dict(gaps=(0.2, 0.01, 0.07))]
    ours = [_stamped(Request, **s) for s in shapes]
    ref = [_stamped(JRequest, **s) for s in shapes]
    kw = dict(queue_depths=[0, 3, 1, 1], stats={"requests_preempted": 2, "prefix_hits": 1,
                                                "prefix_lookups": 4})
    for slo in (None, (0.5, 0.05)):
        a = summarize(ours, slo=slo and SLO(*slo), **kw)
        b = jmetrics.summarize(ref, slo=slo and jmetrics.SLO(*slo), **kw)
        assert a == b
    xs = [3.0, 1.0, 4.0, 1.5, 9.25]
    assert percentiles(xs) == jmetrics.percentiles(xs)


# ---------------------------------------------------------------------------
# the same lifecycle trace as the JAX engine
# ---------------------------------------------------------------------------

# seed 21 in a 12-page pool preempts twice in both modes (and hits the
# shared chat prefix): the schedule the two engines must agree on
TRACE_SEED, TRACE_PAGES = 21, 12


def _trace(eng, reqs) -> dict:
    counters = {k: v for k, v in eng.stats.items() if isinstance(v, int)}
    return {"requests": [(r.status, r.error, len(r.out), r._preemptions, r.truncated)
                         for r in reqs],
            "stats": counters, "queue_depths": list(eng._queue_depths)}


@pytest.mark.parametrize("ragged", [False, True], ids=["paged", "ragged"])
def test_lifecycle_trace_matches_jax_engine(ragged):
    """The seeded workload with preemption, replayed through both engines
    on the same params: the same statuses, reason codes, token counts,
    preemptions, counters and queue depths."""
    jp = JD.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, "cpu")
    kw = dict(batch_slots=3, max_len=96, paged=True, page_size=8, n_pages=TRACE_PAGES,
              preemption=True, ragged=ragged, token_budget=16)
    wkw = dict(n_requests=6, scenarios=default_scenarios(page_size=8), vocab=KW["vocab"])
    ours = ContinuousBatchingEngine(CFG, tp, device="cpu", **kw)
    with lifecycle_checks(ours), page_invariant_checks(ours):
        treqs = replay(ours, make_workload(TRACE_SEED, **wkw))
    jwl = jworkload.make_workload(TRACE_SEED, **{**wkw, "scenarios":
                                                 jworkload.default_scenarios(page_size=8)})
    for it in jwl.items:  # the reference engine takes device prompts
        it.request.prompt = jnp.asarray(it.request.prompt, jnp.int32)
    ref = JEngine(JCFG, jp, **kw)
    jreqs = jworkload.replay(ref, jwl)
    t, j = _trace(ours, treqs), _trace(ref, jreqs)
    assert t == j
    assert t["stats"]["requests_preempted"] >= 1 and t["stats"]["prefix_hits"] >= 1
