"""The port's fault-tolerance contract under seeded injection: the dense
cases of the reference's ``tests/test_chaos.py`` on the port's engine
(``repro_torch.launch.serve``) and fault injector
(``repro_torch.launch.faults``), at the reference's tiny configs.

Every test drives the engine through a deterministic fault (allocator
exhaustion, forced plain-version dispatch, a tampered TwinQuant pack, NaN
logits in one slot, deadlines, cancellation, preemption) and holds the
recovery invariants, not just survival: unaffected requests give the tokens
of a fault-free run; the page audit and the lifecycle audit hold after
every step; every request ends terminal with its reason code; a preempted
and resumed greedy request gives its uninterrupted solo tokens, in the
paged, ragged and speculative modes. The engine runs on the CPU here, where
the kernels' plain versions stand in; ``chip_smoke.py``'s lifecycle phase
runs the same contract on the card."""

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitizers import (
    assert_compile_budget,
    lifecycle_checks,
    page_invariant_checks,
)
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.twinquant import quantize_params
from repro_torch.kernels import dispatch
from repro_torch.kernels.contracts import ContractError
from repro_torch.launch.faults import FaultInjector
from repro_torch.launch.serve import (
    AllocatorError,
    ContinuousBatchingEngine,
    EngineStalledError,
    PageAllocator,
    PrefixCache,
    Request,
    RequestState,
)
from repro_torch.models import common as C
from repro_torch.models import dense as TD

torch.set_num_threads(2)

CFG = ModelConfig(name="tiny-chaos", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
# wide enough to pack: the forced-route and tampered-pack cases need real
# TwinQuant packs
QCFG = ModelConfig(name="tiny-chaos-quant", family="dense", n_layers=2, d_model=256, n_heads=4,
                   n_kv_heads=2, head_dim=64, d_ff=512, vocab=260)


@pytest.fixture(scope="module")
def params():
    return TD.init_params(CFG, seed=0, device="cpu")


@pytest.fixture(scope="module")
def qparams():
    return quantize_params(TD.init_params(QCFG, seed=2, device="cpu"), QCFG,
                           QuantSpec(mode="w4a4", rank=32))


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(1, 200, size=n)


def _engine(p, cfg=CFG, **kw):
    return ContinuousBatchingEngine(cfg, p, **{"batch_slots": 2, "max_len": 64, "device": "cpu",
                                               **kw})


def _solo(p, prompt, max_new=8):
    """Dense-engine solo serving: the token oracle."""
    req = Request(np.asarray(prompt), max_new=max_new)
    _engine(p, batch_slots=1).serve([req])
    assert req.done
    return req.out


def _leaked(eng) -> int:
    """Pages held past the prefix-cache registrations."""
    return eng.allocator.n_used - (len(eng.prefix_cache) if eng.prefix_cache else 0)


# ---------------------------------------------------------------------------
# lifecycle state machine
# ---------------------------------------------------------------------------


def test_lifecycle_states_and_cancel(params):
    """QUEUED -> PREFILL -> DECODE -> DONE for a served request; cancel()
    works queued and mid-decode, releases pages, and leaves the survivor's
    tokens equal to the solo oracle."""
    eng = _engine(params, paged=True)
    a, b, c = (Request(_prompt(12, s), max_new=8) for s in (1, 2, 3))
    assert a.status == RequestState.NEW
    with lifecycle_checks(eng), page_invariant_checks(eng):
        for r in (a, b, c):
            eng.submit(r)
        assert c.status == RequestState.QUEUED  # only 2 slots
        eng.step()
        assert a.status == RequestState.DECODE
        assert eng.cancel(c.request_id)  # queued
        assert eng.cancel(b)  # mid-decode
        assert not eng.cancel(b)  # already terminal
        assert not eng.cancel("no-such-request")
        eng.run_until_done()
    assert a.status == RequestState.DONE and a.done
    assert b.status == RequestState.CANCELLED and b.error is None and len(b.out) >= 1
    assert c.status == RequestState.CANCELLED and c.out == []
    assert eng.stats["requests_cancelled"] == 2
    assert a.out == _solo(params, _prompt(12, 1))
    assert _leaked(eng) == 0


def test_deadline_steps_timeout(params):
    """A request past its step budget is TIMED_OUT with its reason code,
    keeps its partial output, gives its pages back, and the survivor
    matches the oracle."""
    eng = _engine(params, paged=True)
    a = Request(_prompt(12, 1), max_new=8)
    b = Request(_prompt(12, 4), max_new=32, deadline_steps=3)
    with lifecycle_checks(eng), page_invariant_checks(eng):
        eng.submit(a)
        eng.submit(b)
        eng.run_until_done()
    assert a.status == RequestState.DONE
    assert b.status == RequestState.TIMED_OUT and b.done and b.error == "deadline_steps"
    assert eng.stats["requests_timed_out"] == 1
    assert len(b.out) == 3  # steps 1-3 emit; the top of step 4 is past the deadline
    assert a.out == _solo(params, _prompt(12, 1))
    assert _leaked(eng) == 0


def test_deadline_expires_while_queued_and_by_wall_clock(params):
    """A queued request whose step deadline passes before a slot frees is
    TIMED_OUT from the queue (no tokens); ``deadline_s`` expires on the
    wall clock at the top of a step."""
    eng = _engine(params, paged=True, batch_slots=1)
    a = Request(_prompt(12, 1), max_new=8)
    q = Request(_prompt(12, 2), max_new=8, deadline_steps=2)
    w = Request(_prompt(12, 3), max_new=8, deadline_s=0.0)
    with lifecycle_checks(eng), page_invariant_checks(eng):
        for r in (a, q, w):
            eng.submit(r)
        eng.run_until_done()
    assert a.status == RequestState.DONE
    assert q.status == RequestState.TIMED_OUT and q.error == "deadline_steps" and q.out == []
    assert "while queued" in q.error_detail
    assert w.status == RequestState.TIMED_OUT and w.error == "deadline_s" and w.out == []
    assert eng.stats["requests_timed_out"] == 2


def test_run_until_done_exhaustion_surfaces(params):
    """Exhausting max_steps raises EngineStalledError: stranded requests
    are TIMED_OUT (engine_stalled), their pages released."""
    eng = _engine(params, paged=True, batch_slots=1)
    r = Request(_prompt(12, 5), max_new=16)
    eng.submit(r)
    with pytest.raises(EngineStalledError, match="engine stalled"):
        eng.run_until_done(max_steps=3)
    assert r.status == RequestState.TIMED_OUT and r.done and r.error == "engine_stalled"
    assert _leaked(eng) == 0
    eng.check_page_invariants()


def test_submit_rejects_out_of_vocab(params):
    """Garbage token ids fail at submit() with a clear message."""
    eng = _engine(params, batch_slots=1)
    with pytest.raises(ValueError, match="vocab"):
        eng.submit(Request(np.asarray([3, 999, 5]), max_new=4))
    with pytest.raises(ValueError, match="vocab"):
        eng.submit(Request(np.asarray([-1, 2]), max_new=4))
    with pytest.raises(ValueError, match="integer"):
        eng.submit(Request(np.asarray([0.5, 2.0], np.float32), max_new=4))
    assert not eng.queue and all(s is None for s in eng.slots)


# ---------------------------------------------------------------------------
# preemption + requeue
# ---------------------------------------------------------------------------

# a 3-page pool where each request reserves 2: admitting the second request
# needs the first preempted
PREEMPT_MODES = {
    "paged": {},
    "ragged": dict(ragged=True),
    "spec": dict(speculation=True, spec_k=4),
}


@pytest.mark.parametrize("mode", list(PREEMPT_MODES))
def test_preempt_resume_matches_uninterrupted_oracle(params, mode):
    """Page pressure preempts the low-priority request; its readmission
    restores its written pages copy-free from the prefix cache, and the
    resumed greedy output is the uninterrupted solo run's, token for
    token, in the paged, ragged and speculative modes."""
    eng = _engine(params, paged=True, page_size=16, n_pages=3, preemption=True,
                  **PREEMPT_MODES[mode])
    low = Request(_prompt(20, 6), max_new=8, priority=0)
    seen = []
    low.on_token = lambda r, t: seen.append(t)
    with lifecycle_checks(eng), page_invariant_checks(eng):
        eng.submit(low)
        for _ in range(4):  # let `low` make decode progress first
            eng.step()
        assert len(low.out) >= 1
        high = Request(_prompt(20, 7), max_new=8, priority=1)
        eng.submit(high)
        eng.run_until_done()
    assert eng.stats["requests_preempted"] >= 1 and low._preemptions >= 1
    assert low.status == high.status == RequestState.DONE
    assert eng.stats["prefix_hits"] >= 1  # the copy-free restore
    assert seen == low.out  # resume fired no token twice
    assert low.out == _solo(params, _prompt(20, 6))
    assert high.out == _solo(params, _prompt(20, 7))
    assert _leaked(eng) == 0


def test_preemption_needs_strictly_lower_priority(params):
    """An equal-priority head waits for pages instead of preempting (no
    ping-pong); with preemption off, a higher-priority head waits too."""
    for preemption, prio in ((True, 0), (False, 1)):
        eng = _engine(params, paged=True, page_size=16, n_pages=3, preemption=preemption)
        low = Request(_prompt(20, 6), max_new=8, priority=0)
        eng.submit(low)
        eng.step()
        head = Request(_prompt(20, 7), max_new=8, priority=prio)
        eng.submit(head)
        assert head.status == RequestState.QUEUED and low.status == RequestState.DECODE
        eng.run_until_done()
        assert eng.stats["requests_preempted"] == 0
        assert low.out == _solo(params, _prompt(20, 6))
        assert head.out == _solo(params, _prompt(20, 7))


def test_evict_protects_matched_pages():
    """``PrefixCache.evict(protect=)`` never drops an entry holding a
    protected page, even when that leaves the pool short."""
    al = PageAllocator(4)
    pc = PrefixCache(al, page_size=2)
    pages = al.alloc(2)
    pc.register([1, 2, 3, 4], pages)
    al.release(pages)  # only the cache holds them now
    assert al.n_free == 2
    assert pc.evict(4, protect=frozenset(pages)) == 0 and len(pc) == 2
    assert pc.evict(3, protect=frozenset(pages[:1])) == 1 and al.n_free == 3
    assert pc.match([1, 2, 3, 4, 5]) == (2, pages[:1])
    al.audit()


# ---------------------------------------------------------------------------
# injected faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ragged", [False, True], ids=["paged", "ragged"])
def test_nan_logits_quarantines_only_offending_slot(params, ragged):
    """NaN injected into one slot's decode logits fails that request
    (nan_logits); the other slot's tokens equal the fault-free run's."""
    tag = "ragged" if ragged else "decode"

    def interleaved(inject):
        eng = _engine(params, paged=True, ragged=ragged)
        a = Request(_prompt(12, 8), max_new=8)
        b = Request(_prompt(12, 9), max_new=8)
        with FaultInjector(seed=0) as fi:
            if inject:
                fi.corrupt_logits(slot=1, at_call=4, tag=tag)
            with lifecycle_checks(eng), page_invariant_checks(eng):
                eng.submit(a)
                eng.submit(b)
                eng.run_until_done()
        return a, b, eng

    a0, b0, _ = interleaved(inject=False)
    a1, b1, eng = interleaved(inject=True)
    assert b1.status == RequestState.FAILED and b1.done and b1.error == "nan_logits"
    assert eng.stats["requests_failed"] == 1
    assert a1.status == RequestState.DONE and a1.out == a0.out
    assert 0 < len(b1.out) < 8 and b1.out == b0.out[:len(b1.out)]
    assert C.logits_tap(np.zeros(3), tag).tolist() == [0.0] * 3  # the tap is gone
    assert _leaked(eng) == 0


def test_nan_prefill_logits_fail_at_admission(params):
    """NaN in the prefill logits fails the request at admission without
    touching the other slot or leaking its reservation."""
    eng = _engine(params, paged=True)
    a = Request(_prompt(12, 8), max_new=8)
    b = Request(_prompt(13, 9), max_new=8)
    with FaultInjector(seed=0) as fi:
        with lifecycle_checks(eng), page_invariant_checks(eng):
            eng.submit(a)
            eng.step()  # a admitted cleanly
            fi.corrupt_logits(slot=0, at_call=1, tag="prefill")
            eng.submit(b)
            eng.run_until_done()
    assert b.status == RequestState.FAILED and b.error == "nan_logits" and b.out == []
    assert a.status == RequestState.DONE
    assert a.out == _solo(params, _prompt(12, 8))
    assert _leaked(eng) == 0


def test_alloc_denial_backpressure(params):
    """A transient allocator outage delays admission and loses nothing:
    every request finishes with its solo tokens, the audit holds."""
    eng = _engine(params, paged=True)
    reqs = [Request(_prompt(12, 10 + k), max_new=6) for k in range(3)]
    with FaultInjector(seed=0) as fi:
        fi.deny_alloc(eng, at_call=2, count=3)
        with lifecycle_checks(eng), page_invariant_checks(eng):
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
    assert [d["kind"] for d in fi.log].count("deny_alloc") >= 1
    for k, r in enumerate(reqs):
        assert r.status == RequestState.DONE
        assert r.out == _solo(params, _prompt(12, 10 + k), max_new=6)
    assert eng.allocator.alloc.__name__ == "alloc"  # restored


def test_forced_ref_dispatch_degrades_gracefully(qparams):
    """With every dispatch entry forced onto its plain version the
    quantized engine serves the same tokens, and every route it takes reads
    ``ref[forced]``; after restore() the routes are the kernels' again."""
    def run(force):
        with FaultInjector(seed=0) as fi:
            if force:
                fi.force_ref_dispatch()
            dispatch.reset_dispatch_counters()
            eng = _engine(qparams, QCFG, paged=True)
            reqs = [Request(_prompt(12, 20 + k), max_new=4) for k in range(2)]
            eng.serve(reqs)
            return [r.out for r in reqs], eng.routing()

    out_ref, routes_ref = run(force=True)
    out_base, routes_base = run(force=False)
    assert out_ref == out_base
    assert routes_ref and all(k.endswith(("/ref", "/ref[forced]")) for k in routes_ref)
    assert all(routes_ref[k] == routes_ref[f"{k}[forced]"] for k in routes_ref
               if k.endswith("/ref"))
    assert not dispatch.force_ref_enabled()
    assert not any("/ref" in k for k in routes_base)


def test_tampered_pack_is_quarantined(qparams):
    """A pack cut along K raises a ContractError inside prefill; the engine
    fails that request alone (prefill_exception), releases its reservation
    and keeps serving. The tampered model shares every tensor."""
    fi = FaultInjector(seed=0)
    bad = fi.tamper_pack(qparams)
    note = fi.log[-1]
    assert note["kind"] == "tamper_pack" and note["path"].endswith(("attn/o", "mlp/down"))
    victim = bad.get_submodule(note["path"].replace("/", "."))
    orig = qparams.get_submodule(note["path"].replace("/", "."))
    assert victim.rp.shape[-2] == orig.rp.shape[-2] - 1 and victim.up is orig.up
    assert bad.embed is qparams.embed and victim is not orig
    with pytest.raises(ContractError):
        C.linear(victim, torch.zeros((1, orig.rp.shape[-2] * 2), dtype=torch.bfloat16))
    eng = _engine(bad, QCFG, paged=True)
    r = Request(_prompt(12, 30), max_new=4)
    with lifecycle_checks(eng), page_invariant_checks(eng):
        eng.submit(r)
        eng.run_until_done()
    assert r.status == RequestState.FAILED and r.done and r.error == "prefill_exception"
    assert "ContractError" in r.error_detail
    assert eng.allocator.n_used == 0
    # the untouched model still serves
    ok = Request(_prompt(12, 30), max_new=4)
    _engine(qparams, QCFG, paged=True).serve([ok])
    assert ok.status == RequestState.DONE


# ---------------------------------------------------------------------------
# allocator hardening
# ---------------------------------------------------------------------------


def test_allocator_rejects_unknown_and_unreferenced_pages():
    """Double release, unknown ids and sharing a free page raise an
    AllocatorError naming the page and its refcount."""
    al = PageAllocator(4)
    pages = al.alloc(2)
    al.release(pages)
    with pytest.raises(AllocatorError, match="double release"):
        al.release([pages[0]])
    with pytest.raises(AllocatorError, match="unknown page"):
        al.release([99])
    with pytest.raises(AllocatorError, match="unknown page"):
        al.share([-3])
    with pytest.raises(AllocatorError, match="unreferenced page"):
        al.share([pages[0]])
    al.audit()


def test_page_invariants_catch_a_terminal_request_in_a_slot(params):
    """The page audit also holds the lifecycle's side of a slot: a slot
    whose request reached a terminal state without an exit through
    ``_release_slot`` fails it (the reference's check)."""
    eng = _engine(params, paged=True)
    r = Request(_prompt(12, 1), max_new=8)
    eng.submit(r)
    eng.check_page_invariants()
    r.status = RequestState.CANCELLED  # a bookkeeping fault: no release
    with pytest.raises(AssertionError, match="holds terminal request"):
        eng.check_page_invariants()


# ---------------------------------------------------------------------------
# randomized interleaved schedule (seeded)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pages", [6, 3], ids=["pool6", "pool3"])
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculation"])
def test_randomized_cancel_timeout_preempt_schedule(params, spec, n_pages):
    """A seeded random schedule of submits, cancels and deadline expiries
    under page pressure with preemption on, without and with speculative
    decoding (whose rewinds land between the cancels and preemptions):
    every request ends terminal, survivors' tokens equal the solo oracle,
    no page leaks, and one verify shape serves the whole run. The
    reference's 6-page pool never runs short on this seed; the 3-page pool
    preempts (and cancels a preempted request)."""
    rng = np.random.default_rng(42)
    extra = dict(speculation=True, spec_k=4) if spec else {}
    eng = _engine(params, paged=True, page_size=16, n_pages=n_pages, preemption=True, **extra)
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
    assert _leaked(eng) <= 0
    assert (eng.stats["requests_preempted"] > 0) == (n_pages == 3)
    for k, r in reqs.items():
        assert r.status in RequestState.TERMINAL, (k, r.status)
        if r.status == RequestState.DONE and not r.truncated:
            assert r.out == _solo(params, prompts[k], max_new=6), k
    eng.check_page_invariants()
    if spec:
        assert assert_compile_budget(eng)["spec_traces"] <= 1
