"""A preempted request's readmission in the paged and speculative modes,
bit for bit: the rows past its restored pages are recomputed by the path
that first wrote them, the prompt rows by the (suffix) bucketed prefill and
the generated rows by decode steps (``ContinuousBatchingEngine.
_decode_rows``: one eager decode step a row, every other slot masked out),
so every token's logits row of the resumed request is ``torch.equal`` to
the uninterrupted run's.

On a tiny W4A4 config with the kernels' plain versions (the CPU), each
case preempts a low-priority request by a high-priority one after
``steps`` decode steps: after 4 the restored page ends inside the prompt
(prompt rows re-prefilled, then decode steps), after 14 past it (decode
steps only). A fresh prefill of the same timeline gives the first resumed
row other bits (4-bit activations carry the prefill's other rounding far),
the difference the old readmission had.
"""

import numpy as np
import pytest
import torch

from chip_smoke import _TokenLogits
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.twinquant import quantize_params
from repro_torch.launch.serve import ContinuousBatchingEngine, Request, RequestState
from repro_torch.models import dense as TD

torch.set_num_threads(2)

QCFG = ModelConfig(name="tiny-resume-quant", family="dense", n_layers=2, d_model=256,
                   n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab=260)
MODES = {"paged": {}, "spec": dict(speculation=True, spec_k=4)}
PROMPT, MAX_NEW, PAGE = 20, 16, 16


@pytest.fixture(scope="module")
def qparams():
    return quantize_params(TD.init_params(QCFG, seed=2, device="cpu"), QCFG,
                           QuantSpec(mode="w4a4", rank=32))


def _prompt(seed):
    return np.random.default_rng(seed).integers(1, 250, size=PROMPT)


def _run(qp, mode: str, steps: int, n_pages: int):
    """Serve ``low`` alone for ``steps`` steps, then ``high``; returns
    (engine, low, high, each emitted token's logits row by request, the
    tokens each preempted request had emitted)."""
    eng = ContinuousBatchingEngine(QCFG, qp, batch_slots=2, max_len=64, device="cpu",
                                   paged=True, page_size=PAGE, n_pages=n_pages,
                                   preemption=True, **MODES[mode])
    rec = _TokenLogits(eng, QCFG.vocab)
    emitted, preempt = [], eng._preempt

    def counting(i, req):
        emitted.append(len(req.out))
        preempt(i, req)

    eng._preempt = counting
    low = Request(_prompt(6), max_new=MAX_NEW, priority=0, request_id="low")
    high = Request(_prompt(7), max_new=MAX_NEW, priority=1, request_id="high")
    eng.submit(low)
    for _ in range(steps):
        eng.step()
    eng.submit(high)
    eng.run_until_done()
    rec.close()
    return eng, low, high, rec.rows, emitted


@pytest.mark.parametrize("steps", [4, 14], ids=["restored-in-prompt", "restored-past-prompt"])
@pytest.mark.parametrize("mode", list(MODES))
def test_resumed_rows_equal_the_uninterrupted_run(qparams, mode, steps):
    eng, low, high, rows, emitted = _run(qparams, mode, steps, n_pages=5)
    ref, rlow, rhigh, rrows, none = _run(qparams, mode, steps, n_pages=16)
    assert len(emitted) == low._preemptions == 1 and none == []
    assert low.status == high.status == RequestState.DONE
    assert low.out == rlow.out and high.out == rhigh.out
    for rid in ("low", "high"):
        assert len(rows[rid]) == len(rrows[rid])
        assert all(np.array_equal(a, b) for a, b in zip(rows[rid], rrows[rid])), rid
    # the rows past the restored pages went through decode steps
    (rid, start, n), = eng.resumed_by_decode
    restored = eng.stats["prefix_hit_tokens"]
    assert rid == "low" and start == max(restored, PROMPT)
    assert start + n == PROMPT + emitted[0]
    assert (restored < PROMPT) == (steps == 4)
    assert ref.resumed_by_decode == []


def test_a_fresh_prefill_of_the_timeline_gives_other_bits(qparams):
    """The old readmission (one prefill of prompt + generated tokens) gives
    the first resumed row other bits than the uninterrupted decode did."""
    ref, rlow, _, rrows, _ = _run(qparams, "paged", 14, n_pages=16)
    eng, low, _, rows, (t,) = _run(qparams, "paged", 14, n_pages=5)
    eff = np.concatenate([_prompt(6), np.asarray(rlow.out[:t])]).astype(np.int32)
    fresh = ref._run_prefill(eff)[0][:QCFG.vocab]
    assert np.array_equal(rows["low"][t], rrows["low"][t])
    assert not np.array_equal(fresh, rrows["low"][t])
