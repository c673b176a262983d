"""The port's one-graph-per-step machinery (repro_torch: the fixed-shape row
writers ``kernels/paged_attention.pool_rows`` / ``write_page_rows`` and
``models/common.update_cache_slot_stacked``, the in-place steps of
``models/dense.py``, ``launch/step_graph.StepGraph`` and the engine's
``step_graphs`` argument).

Tolerances: none. The writers copy bf16 rows, so they are held bit for bit
to the masked writers they replace (kept here as the oracle) and to the
reference's ``mode="drop"`` scatters. The replay bookkeeping is held to the
exact counts. Capture itself needs the card: the ``gpu`` test captures one
paged step and holds its logits ``torch.equal`` to the eager step's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import common as JC_
from repro_torch.configs import ModelConfig
from repro_torch.interop import to_torch
from repro_torch.kernels import cuda_launch, dispatch
from repro_torch.kernels.paged_attention import pool_rows, write_page_rows
from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.launch.step_graph import StepGraph
from repro_torch.models import common as C
from repro_torch.models import dense as TD

torch.set_num_threads(2)

CFG = ModelConfig(name="tiny-graph", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)


@pytest.fixture(scope="module")
def params():
    return TD.init_params(CFG, seed=0, device="cpu")


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the masked writers the fixed-shape ones replace (the oracle)
# ---------------------------------------------------------------------------


def _masked_pool_write(pool, t, bt, slot, pos):
    """The pool row writer as it was: the kept rows selected with
    ``torch.nonzero`` (a data-dependent shape, a host sync on the card)."""
    b, maxp = bt.shape
    page, n_pages = pool.shape[2], pool.shape[1]
    slot, pos = slot.long(), pos.long()
    pi = torch.div(pos, page, rounding_mode="floor")
    page_id = bt.long()[slot.clamp(0, b - 1), pi.clamp(0, maxp - 1)]
    ok = (slot >= 0) & (slot < b) & (pi < maxp) & (page_id >= 0)
    page_id = torch.where(ok, page_id, n_pages)
    keep = torch.nonzero(page_id < n_pages).flatten()
    pool[:, page_id[keep], (pos % page)[keep]] = t[:, keep].to(pool.dtype)


def _masked_cache_write(cache, t, pos):
    """The dense cache writer as it was: boolean-mask indexing."""
    b, s = cache.shape[1], cache.shape[2]
    pos = pos.to(torch.long)
    ok = (pos >= 0) & (pos < s)
    cache[:, torch.arange(b)[ok], pos[ok]] = t[:, ok, 0].to(cache.dtype)


def _pool_case(seed=0):
    rng = np.random.default_rng(seed)
    L, P, page, KV, hd, B, maxp = 2, 6, 4, 2, 8, 3, 3
    pool = rng.standard_normal((L, P, page, KV, hd)).astype(np.float32)
    bt = np.full((B, maxp), -1, np.int32)
    bt[0, :2] = [4, 1]
    bt[1, :1] = [5]
    return pool, bt, rng


def _three_ways(pool, t, bt, slot, pos):
    """The rows written by the fixed-shape writer, the masked writer and the
    reference's scatter, each from the same bf16 pool."""
    jpool = jnp.asarray(pool, jnp.bfloat16)
    want = JC_.scatter_rows_pages(jpool, jnp.asarray(t, jnp.bfloat16), jnp.asarray(bt),
                                  jnp.asarray(slot), jnp.asarray(pos))
    got, old = _t(jpool), _t(jpool)
    tt = _t(jnp.asarray(t, jnp.bfloat16))
    write_page_rows(got, tt, pool_rows(_t(bt), _t(slot), _t(pos), got.shape[2], got.shape[1]))
    _masked_pool_write(old, tt, _t(bt), _t(slot), _t(pos))
    return got, old, want


@pytest.mark.parametrize("case", ["mixed", "nothing_kept"])
def test_pool_writer_equals_masked_writer_and_reference(case):
    """Pad rows (slot == B), rows into unmapped pages and rows past the
    block table are dropped alike; with no row kept the pool is untouched."""
    pool, bt, rng = _pool_case()
    t = rng.standard_normal((2, 7, 2, 8)).astype(np.float32)
    if case == "mixed":
        slot = np.array([0, 0, 1, 3, 2, 1, 0], np.int32)  # 3 == B: pad; slot 2 unmapped
        pos = np.array([2, 5, 3, 0, 1, 4, 12], np.int32)  # slot 1 pos 4 unmapped; 12 past table
    else:
        slot = np.array([3, 2, 2, 1, 0, 3, 3], np.int32)
        pos = np.array([0, 0, 5, 7, 40, 1, 2], np.int32)
    got, old, want = _three_ways(pool, t, bt, slot, pos)
    np.testing.assert_array_equal(_np(got), _np(old))
    np.testing.assert_array_equal(_np(got), _np(want))
    if case == "nothing_kept":
        np.testing.assert_array_equal(_np(got), _np(jnp.asarray(pool, jnp.bfloat16)))


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_pool_writer_random_rows(data):
    """Random block tables (distinct pages, some unmapped) and random rows
    (distinct slot/position pairs, pads, rows past the table): the three
    writers agree bit for bit."""
    B, maxp, P, page, R = 3, 3, 9, 4, 10
    pages = data.draw(st.permutations(range(P)))
    mapped = data.draw(st.lists(st.booleans(), min_size=B * maxp, max_size=B * maxp))
    bt = np.where(mapped, pages[:B * maxp], -1).astype(np.int32).reshape(B, maxp)
    pairs = data.draw(st.lists(st.tuples(st.integers(0, B), st.integers(0, maxp * page + 3)),
                               min_size=R, max_size=R, unique=True))
    slot = np.array([s for s, _ in pairs], np.int32)
    pos = np.array([p for _, p in pairs], np.int32)
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 16)))
    pool = rng.standard_normal((2, P, page, 2, 8)).astype(np.float32)
    t = rng.standard_normal((2, R, 2, 8)).astype(np.float32)
    got, old, want = _three_ways(pool, t, bt, slot, pos)
    np.testing.assert_array_equal(_np(got), _np(old))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_cache_writer_drops_rows_past_max_len():
    """The dense cache writer: slots at or past ``max_len`` write nothing,
    the others their own row, as the masked writer and the reference's
    ``update_cache_slot_stacked``."""
    rng = np.random.default_rng(3)
    L, B, S, KV, hd = 2, 4, 6, 2, 8
    cache = jnp.asarray(rng.standard_normal((L, B, S, KV, hd)), jnp.bfloat16)
    t = jnp.asarray(rng.standard_normal((L, B, 1, KV, hd)), jnp.bfloat16)
    pos = np.array([0, 5, 6, 9], np.int32)  # slots 2 and 3 past max_len
    want = JC_.update_cache_slot_stacked(cache, t, jnp.asarray(pos))
    got, old = _t(cache), _t(cache)
    C.update_cache_slot_stacked(got, _t(t), _t(pos))
    _masked_cache_write(old, _t(t), _t(pos))
    np.testing.assert_array_equal(_np(got), _np(old))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got)[:, 2:], _np(cache)[:, 2:])


# ---------------------------------------------------------------------------
# steps that keep their state tensors
# ---------------------------------------------------------------------------


def _same_tensors(state, before) -> bool:
    return all(state[k] is t and state[k].data_ptr() == t.data_ptr() for k, t in before.items())


@pytest.mark.parametrize("paged,sq", [(False, 1), (True, 1), (True, 3)])
def test_decode_step_advances_pos_in_place(params, paged, sq):
    B, max_len = 3, 32
    if paged:
        state = C.init_paged_state(TD.init_decode_state, CFG, B, max_len, 8, 12, "cpu")
        state["bt"][0, :2] = torch.tensor([3, 7], dtype=torch.int32)
        state["bt"][1, :1] = torch.tensor([5], dtype=torch.int32)
    else:
        state = TD.init_decode_state(CFG, B, max_len, device="cpu")
    state["pos"].copy_(torch.tensor([9, 2, 0], dtype=torch.int32))
    before = dict(state)
    tokens = torch.as_tensor(np.random.default_rng(sq).integers(0, 256, (B, sq)))
    logits, out = TD.decode_step(params, CFG, state, tokens)
    assert out is state and _same_tensors(state, before)
    assert state["pos"].tolist() == [9 + sq, 2 + sq, sq]
    assert tuple(logits.shape) == (B, sq, CFG.padded_vocab)


def test_ragged_step_advances_pos_in_place(params):
    B, T = 3, 8
    state = C.init_paged_state(TD.init_decode_state, CFG, B, 32, 8, 12, "cpu")
    state["bt"][0, :2] = torch.tensor([3, 7], dtype=torch.int32)
    state["bt"][1, :1] = torch.tensor([5], dtype=torch.int32)
    before = dict(state)
    slot = torch.tensor([0, 1, 1, 1, 3, 3, 3, 3], dtype=torch.int32)  # 3 == B: pad
    pos = torch.tensor([9, 2, 3, 4, 0, 0, 0, 0], dtype=torch.int32)
    ctx = torch.tensor([9, 2, 0], dtype=torch.int32)
    tokens = torch.arange(T) + 5
    _, out = TD.ragged_step(params, CFG, state, tokens, slot, pos, ctx,
                            torch.tensor([0, 3, 0]))
    assert out is state and _same_tensors(state, before)
    assert state["pos"].tolist() == [10, 5, 0]


@pytest.mark.parametrize("mode", [{}, {"paged": True}, {"paged": True, "speculation": True},
                                  {"paged": True, "ragged": True, "token_budget": 16}],
                         ids=["bucketed", "paged", "spec", "ragged"])
def test_engine_keeps_its_state_tensors(params, mode):
    """Serving leaves the engine's state dict and every tensor in it the
    same objects: the step graph reads and writes them at every replay. On
    the CPU the steps run eagerly, with no capture."""
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu", **mode)
    state, before = eng.state, dict(eng.state)
    reqs = [Request(np.arange(3, 3 + n), max_new=5) for n in (4, 11, 7)]
    eng.serve(reqs)
    assert all(r.status == "DONE" and len(r.out) == 5 for r in reqs)
    assert eng.state is state and _same_tensors(state, before)
    cs = eng.compile_stats()
    assert cs["decode_graphs"] == cs["spec_graphs"] == cs["ragged_graphs"] == 0, cs
    assert cs["graph_replays"] == 0 and eng.step_graph.steps == eng.stats["decode_steps"], cs


# ---------------------------------------------------------------------------
# replay bookkeeping and the argument
# ---------------------------------------------------------------------------


def _counted_step(params, state):
    """A paged decode step that, besides its routed calls, counts launches
    the way the kernel wrappers do on the card (they launch nothing here)."""

    def step(tokens):
        cuda_launch.add_launch_counts({"paged_decode_kernel": CFG.n_layers, "other": 1})
        return TD.decode_step(params, CFG, state, tokens)[0]

    return step


class _Graph:
    """Stands in for a captured CUDA graph: replay runs nothing."""

    def replay(self):
        pass


def test_replay_adds_captured_counts_once_and_capture_adds_none(params):
    state = C.init_paged_state(TD.init_decode_state, CFG, 2, 32, 8, 8, "cpu")
    state["bt"][0, :1] = 2
    step = _counted_step(params, state)
    tok = torch.zeros((2, 1), dtype=torch.long)
    cuda_launch.reset_launch_counts()
    dispatch.reset_dispatch_counters()
    step(tok)  # one eager step: what a replay must add
    one_l, one_r = cuda_launch.launch_counts(), dispatch.dispatch_counters()
    assert one_r.get("paged_decode/kernel") == CFG.n_layers, one_r

    sg = StepGraph(step, {"tokens": tok.clone()}, "cpu", capture=False)
    cuda_launch.reset_launch_counts()
    dispatch.reset_dispatch_counters()
    cuda_launch.add_launch_counts({"before": 4})
    sg._record()  # what the capture runs, driven eagerly
    assert cuda_launch.launch_counts() == {"before": 4}
    assert dispatch.dispatch_counters() == {}
    assert sg.launch_delta == one_l and sg.route_delta == one_r
    sg.graph, sg._flags = _Graph(), (dispatch.fusion_enabled(), dispatch.force_ref_enabled())
    for n in (1, 2, 3):
        sg.replay()
        assert cuda_launch.launch_counts() == {"before": 4, **{k: n * v for k, v in one_l.items()}}
        assert dispatch.dispatch_counters() == {k: n * v for k, v in one_r.items()}
    assert sg.replays == 3 and sg.captures == 0
    prev = dispatch.set_fusion(not dispatch.fusion_enabled())
    try:
        with pytest.raises(RuntimeError, match="dispatch flags"):
            sg.replay()
    finally:
        dispatch.set_fusion(prev)
    assert sg.replays == 3


def test_step_graph_inputs_checked(params):
    sg = StepGraph(lambda tokens: tokens * 2, {"tokens": torch.zeros((2, 1), dtype=torch.long)},
                   "cpu", capture=False)
    assert sg(tokens=np.array([[3], [4]])).tolist() == [[6], [8]]
    with pytest.raises(ValueError, match="static buffer"):
        sg(tokens=np.zeros((2, 4), np.int64))
    with pytest.raises(ValueError, match="step inputs"):
        sg(tokens=np.zeros((2, 1), np.int64), pos=np.zeros(2, np.int32))
    with pytest.raises(RuntimeError, match="no captured"):
        sg.replay()
    with pytest.raises(ValueError, match="CUDA device"):
        StepGraph(lambda tokens: tokens, {"tokens": torch.zeros(1)}, "cpu", capture=True)


def test_step_graphs_true_on_cpu_raises(params):
    with pytest.raises(ValueError, match="step_graphs=True"):
        ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=32, device="cpu",
                                 paged=True, step_graphs=True)
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=32, device="cpu",
                                   step_graphs=False)
    assert not eng.step_graph.capture


@pytest.mark.gpu
def test_paged_step_graph_equals_eager_on_card():
    """On the card: the third paged step replays the captured graph; its
    logits and committed pools equal the same step run eagerly from a copy
    of the state (chip_smoke.py does the same at llama3-8b, 32 layers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    p = TD.init_params(CFG, seed=0, device=dev)
    eng = ContinuousBatchingEngine(CFG, p, batch_slots=2, max_len=64, device=dev, paged=True)
    for r in (Request(np.arange(3, 13), max_new=12), Request(np.arange(40, 45), max_new=12)):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    sg = eng.step_graph
    assert sg.captures == 1 and sg.replays == 2
    snap = {k: v.clone() for k, v in eng.state.items()}
    sg.graph.replay()
    out_g = sg.out.clone()
    after_g = {k: v.clone() for k, v in eng.state.items()}
    for k, v in snap.items():
        eng.state[k].copy_(v)
    out_e = sg.fn(**sg.buffers)
    torch.cuda.synchronize()
    assert torch.equal(out_g, out_e)
    assert all(torch.equal(after_g[k], eng.state[k]) for k in snap)
