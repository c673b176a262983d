"""The port's runtime sanitizers (``repro_torch.analysis.sanitizers``) on its
engine: the dense cases of the reference's sanitizer tests
(``tests/test_ragged_engine.py::test_ragged_single_trace_no_recompiles``,
``tests/test_paged_decode.py::test_spec_single_trace_no_recompiles`` and the
``page_invariant_checks`` / ``guarded_decode`` loop of
``tests/test_paged_serving.py``), and each sanitizer catching what it is
for. The engine runs on the CPU here, where steps run eagerly (no capture)
and ``guarded_decode`` has no device to guard; ``chip_smoke.py`` serves
under all five on the card."""

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitizers import (
    SanitizerError,
    assert_compile_budget,
    guarded_decode,
    lifecycle_checks,
    no_recompiles,
    page_invariant_checks,
)
from repro_torch.configs import ModelConfig
from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.models import dense as TD

torch.set_num_threads(2)

CFG = ModelConfig(name="tiny-sanitized", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)


@pytest.fixture(scope="module")
def params():
    return TD.init_params(CFG, seed=0, device="cpu")


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, size=n) for n in lens]


def _solo(params, prompt, max_new=8):
    """Dense-engine solo serving: the token oracle."""
    req = Request(np.asarray(prompt), max_new=max_new)
    ContinuousBatchingEngine(CFG, params, batch_slots=1, max_len=64, device="cpu").serve([req])
    assert req.done
    return req.out


def test_ragged_single_trace_no_recompiles(params):
    """After the first step, admissions, chunk interleaves and evictions all
    reuse the one token-budget-shaped step."""
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=3, max_len=64, device="cpu",
                                   paged=True, ragged=True, token_budget=16)
    reqs = [Request(p, max_new=6) for p in _prompts((5, 23, 17, 9))]
    for r in reqs[:2]:
        eng.submit(r)
    eng.step()
    with no_recompiles(eng):
        for r in reqs[2:]:
            eng.submit(r)
        eng.run_until_done()
    cs = assert_compile_budget(eng)
    assert cs["ragged_traces"] == 1, cs
    assert cs["prefill_traces"] == 0 and cs["decode_traces"] == 0, cs
    assert all(r.status == "DONE" for r in reqs)


def test_spec_single_trace_no_recompiles(params):
    """After the first verify launch, every later admission mix reuses the
    one (batch, spec_k) shape."""
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                   paged=True, page_size=8, n_pages=24, speculation=True,
                                   spec_k=4)
    eng.serve([Request(p, max_new=8) for p in _prompts((5, 9), seed=7)])
    with no_recompiles(eng):
        eng.serve([Request(p, max_new=8) for p in _prompts((11, 4), seed=8)])
    assert assert_compile_budget(eng)["spec_traces"] == 1


def test_paged_interleaving_under_page_and_sync_sanitizers(params):
    """The reference's sanitized loop: b admitted while a is mid-generation,
    the allocator audited after every step, the post-admission decode run
    under ``guarded_decode``; both equal their dense solo runs."""
    a, b = list(range(10, 22)), list(range(100, 105))
    solo_a, solo_b = _solo(params, a), _solo(params, b)
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                   paged=True, page_size=16)
    with page_invariant_checks(eng), lifecycle_checks(eng):
        ra = Request(np.asarray(a), max_new=8)
        eng.submit(ra)
        for _ in range(2):
            eng.step()
        rb = Request(np.asarray(b), max_new=8)
        eng.submit(rb)
        with guarded_decode():
            eng.run_until_done()
    assert ra.out == solo_a and rb.out == solo_b
    assert eng.compile_stats()["decode_traces"] == 1
    assert assert_compile_budget(eng)["prefill_traces"] <= 2


def test_no_recompiles_raises_on_a_new_shape_or_capture(params):
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu")
    eng.serve([Request(np.arange(3, 8), max_new=3)])  # prefill bucket 8
    with no_recompiles(eng):
        eng.serve([Request(np.arange(3, 9), max_new=3)])  # bucket 8 again
    with pytest.raises(SanitizerError, match="prefill_traces grew 1 -> 2"):
        with no_recompiles(eng):
            eng.serve([Request(np.arange(3, 23), max_new=3)])  # bucket 32
    with pytest.raises(SanitizerError, match="decode_graphs grew 0 -> 1"):
        with no_recompiles(eng):
            eng.step_graph.captures += 1  # what a capture inside the region records
    with pytest.raises(SanitizerError, match="decode_graphs = 2"):
        eng.step_graph.captures += 1
        assert_compile_budget(eng)


def test_lifecycle_checks_raise_on_a_terminal_request_in_a_slot(params):
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                   paged=True)
    req = Request(np.arange(3, 9), max_new=3)
    with pytest.raises(SanitizerError, match="still held by a slot"):
        with lifecycle_checks(eng):
            eng.submit(req)
            eng.run_until_done()
            assert req.status == "DONE"
            eng.slots[1] = req  # a bookkeeping fault: a finished request left in a slot
    eng.slots[1] = None
    with pytest.raises(AssertionError, match="empty slot 0 still maps"):
        with page_invariant_checks(eng):
            eng._bt[0, 0] = 3  # an empty slot mapping a page it holds no reference to
            eng.step()
