"""The reference's ``mla_moe`` engine cases on the port's engine
(``tests/test_paged_serving.py``: paged interleaving and a prefix-cache hit
at its ``MLA_CFG`` widths), the engine's fallbacks for ragged and
speculative serving, and the step-graph contract of the MLA decode steps.
Greedy tokens are held exactly to the port's own bucketed solo oracle, as
the reference holds its own; no JAX here.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import ModelConfig
from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.models import common as C
from repro_torch.models import deepseek as TDS

torch.set_num_threads(2)

# ``tests/test_torch_deepseek.py``'s config
CFG = ModelConfig(name="tiny-paged-mla", family="mla_moe", n_layers=2, d_model=64, n_heads=4,
                  d_ff=128, vocab=256, first_k_dense=1, q_lora_rank=32, kv_lora_rank=32,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, n_experts=4, top_k=2,
                  d_ff_expert=64, n_shared_experts=1, mtp=True)


@pytest.fixture(scope="module")
def params():
    return TDS.init_params(CFG, seed=1, device="cpu")


# ---------------------------------------------------------------------------
# the reference's mla_moe engine cases on the port's engine
# ---------------------------------------------------------------------------


def _solo(p, prompt, max_new):
    """Bucketed-engine solo serving: the port's token oracle."""
    r = Request(np.asarray(prompt), max_new=max_new)
    ContinuousBatchingEngine(CFG, p, batch_slots=1, max_len=64, device="cpu").serve([r])
    assert r.done
    return r.out


def test_paged_interleaving_invariant_mla(params):
    """b admitted while a decodes, on a paged engine (page 16): both equal
    their bucketed solo runs."""
    a, b = list(range(10, 22)), list(range(100, 105))
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                   paged=True, page_size=16)
    ra = Request(np.asarray(a), max_new=5)
    eng.submit(ra)
    eng.step()
    eng.step()
    rb = Request(np.asarray(b), max_new=5)
    eng.submit(rb)
    eng.run_until_done()
    eng.check_page_invariants()
    assert ra.out == _solo(params, a, 5) and rb.out == _solo(params, b, 5)
    assert eng.routing().get("paged_decode/kernel", 0) == 0  # MLA gathers its latent pages


def test_prefix_cache_hit_equivalence_mla(params):
    """A hit on 3 cached pages (bucketed down to 2, 16 rows) runs the suffix
    prefill over the expanded latent prefix: the same tokens as a cold run."""
    pre = list(range(1, 25))
    p2 = pre + [30, 31]

    def serve_one(prefix_caching):
        eng = ContinuousBatchingEngine(CFG, params, batch_slots=1, max_len=64, device="cpu",
                                       paged=True, page_size=8, prefix_caching=prefix_caching)
        eng.serve([Request(np.asarray(pre + [7]), max_new=3)])
        r = Request(np.asarray(p2), max_new=4)
        eng.serve([r])
        eng.check_page_invariants()
        return r, eng

    hit, eng = serve_one(True)
    cold, _ = serve_one(False)
    assert eng.stats["prefix_hits"] == 1 and eng.stats["prefix_hit_tokens"] == 16
    assert hit.out == cold.out == _solo(params, p2, 4)


@pytest.mark.parametrize("kw,match", [(dict(ragged=True), "a family with a ragged_step"),
                                      (dict(speculation=True), "multi-row paged decode")],
                         ids=["ragged", "speculation"])
def test_ragged_and_speculation_fall_back(params, kw, match):
    """As the reference: no ragged step and no multi-row decode for MLA, so
    the engine warns and serves paged one token a step, with the prefix
    cache, the tokens of a bucketed solo run."""
    with pytest.warns(UserWarning, match=match):
        eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                       paged=True, **kw)
    assert not eng.ragged and not eng.speculation and eng.prefix_cache is not None
    prompt = list(range(40, 51))
    r = Request(np.asarray(prompt), max_new=5)
    eng.serve([r])
    assert r.done and r.out == _solo(params, prompt, 5)
    cs = eng.compile_stats()
    assert cs["ragged_traces"] == cs["spec_traces"] == 0 and cs["decode_traces"] == 1, cs


# ---------------------------------------------------------------------------
# the step-graph contract of the MLA decode steps
# ---------------------------------------------------------------------------


def _same_tensors(state, before) -> bool:
    return all(state[k] is t and state[k].data_ptr() == t.data_ptr() for k, t in before.items())


@pytest.mark.parametrize("paged", [False, True], ids=["bucketed", "paged"])
def test_decode_step_keeps_its_state_tensors(params, paged):
    """The returned state is the given one: ``ckv`` / ``krope`` keep their
    storage, and ``pos`` advances in place, so a captured step reads and
    writes the same memory at every replay; the lines land at ``pos``."""
    B, max_len = 3, 32
    if paged:
        state = C.init_paged_state(TDS.init_decode_state, CFG, B, max_len, 8, 12, "cpu")
        state["bt"][0, :2] = torch.tensor([3, 7], dtype=torch.int32)
        state["bt"][1, :1] = torch.tensor([5], dtype=torch.int32)
    else:
        state = TDS.init_decode_state(CFG, B, max_len, device="cpu")
    state["pos"].copy_(torch.tensor([9, 2, 0], dtype=torch.int32))
    before = dict(state)
    logits, out = TDS.decode_step(params, CFG, state, torch.tensor([[5], [6], [7]]))
    assert out is state and _same_tensors(state, before)
    assert state["pos"].tolist() == [10, 3, 1] and tuple(logits.shape) == (B, 1, 256)
    rows = (state["ckv"][:, 7, 1], state["ckv"][:, 5, 2]) if paged else (
        state["ckv"][:, 0, 9], state["ckv"][:, 1, 2])
    assert all(bool(r.abs().sum(dim=-1).gt(0).all()) for r in rows)


@pytest.mark.parametrize("mode", [{}, {"paged": True}], ids=["bucketed", "paged"])
def test_engine_keeps_its_state_tensors(params, mode):
    """Serving leaves the engine's state dict and every tensor in it the
    same objects (no capture on the CPU)."""
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu", **mode)
    state, before = eng.state, dict(eng.state)
    reqs = [Request(np.arange(3, 3 + n), max_new=5) for n in (4, 11, 7)]
    eng.serve(reqs)
    assert all(r.status == "DONE" and len(r.out) == 5 for r in reqs)
    assert eng.state is state and _same_tensors(state, before)
    assert set(state) == ({"ckv", "krope", "pos", "bt"} if mode else {"ckv", "krope", "pos"})
    cs = eng.compile_stats()
    assert cs["graph_replays"] == 0 and eng.step_graph.steps == eng.stats["decode_steps"], cs


# ---------------------------------------------------------------------------
# chip_smoke.py's DeepSeek phase frees the bf16 model before serving
# ---------------------------------------------------------------------------


class _Served(Exception):
    """Raised where the phase would start serving."""


def test_chip_smoke_deepseek_phase_frees_the_bf16_model(monkeypatch):
    """``chip_smoke.deepseek_phase`` drops every bf16 expert weight of the
    init before it serves: at full width the MoE layer's experts are
    22.5 GB, and the packs, engines and stacked ``w4a16_gemm`` stacks that
    follow need that room on an 80 GB card."""
    import gc
    import sys
    import weakref
    from pathlib import Path

    from repro_torch.configs import get_config

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = get_config("deepseek-v3-671b", reduced=True).replace(
        n_layers=2, first_k_dense=1, q_lora_rank=256, kv_lora_rank=224, qk_nope_dim=32,
        qk_rope_dim=32, v_head_dim=64, n_heads=4, d_ff_expert=256, vocab=260)
    experts = []
    init = TDS.init_params

    def init_params(*a, **k):
        p = init(*a, **k)
        experts.extend(weakref.ref(lin.w) for lp in p.layers if hasattr(lp.moe, "experts")
                       for lin in lp.moe.experts.values())
        return p

    def served(*a, **k):
        gc.collect()
        live = sum(r() is not None for r in experts)
        raise _Served(f"{live} of {len(experts)} bf16 expert weights alive")

    monkeypatch.setattr(TDS, "init_params", init_params)
    monkeypatch.setattr(chip_smoke, "DeepSeekServed", served)
    for timer in ("graph_ms", "host_us", "cuda_ms"):
        monkeypatch.setattr(chip_smoke, timer, lambda *a, **k: 1.0)
    cps = {"dual_gemv": 8, "dual_gemv_group": 8, "dual_gemm": 32, "dual_gemm_group": 32}
    monkeypatch.setattr(chip_smoke, "DS_KERNEL_RUN", dict(
        chip_smoke.DS_KERNEL_RUN, cps=((8,), (32,)), table_cp=cps))
    monkeypatch.setattr(chip_smoke, "DS_LINEAR_MS", (8, 32))
    with pytest.raises(_Served, match="^0 of 3 bf16 expert weights alive"):
        chip_smoke.deepseek_phase(torch.device("cpu"), "cpu", cfg, prompt_lens=(3, 6),
                                  max_len=64, rank=32)
