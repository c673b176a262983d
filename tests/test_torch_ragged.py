"""The port's ragged step (repro_torch: kernels/ragged_attention.py,
contracts.check_ragged_rows, dense.ragged_step, the engine's ragged mode)
held to the JAX package.

Tolerances, and where bit-equality holds:
* ``ragged_attention_ref`` against the reference's ``ragged_attention_ref``
  on real rows: decode rows bit-equal; prompt-chunk rows atol 0.03 / rtol
  0.05, because their f32 value sums run in another order in XLA and in
  PyTorch. Against the reference's Pallas kernel run with
  ``interpret=True``: atol 0.03 / rtol 0.05 (its own bound).
* one ragged model step: logits and committed pool rows rel <= 0.03 (the
  bf16 bound of tests/test_torch_dense.py).
* engine: ragged == the port's bucketed engine token for token on the
  reference's pinned workloads (multi-chunk prompts carry the reference's
  own f32 reassociation, ``ragged_attention.py:30-42``, so only pinned
  workloads are oracles); first greedy tokens equal the JAX ragged engine's
  wherever the reference's top-2 margin exceeds 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.kernels.ragged_attention import ragged_attention_kernel as j_kernel
from repro.kernels.ragged_attention import ragged_attention_ref as j_ref
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.models import common as JC_
from repro.models import dense as JD
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.twinquant import quantize_params
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import dispatch
from repro_torch.kernels.contracts import ContractError, check_ragged_rows
from repro_torch.kernels.ragged_attention import ragged_attention_kernel, ragged_attention_ref
from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.models import dense as TD

torch.set_num_threads(2)

KW = dict(name="tiny-ragged", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, d_ff=128, vocab=256)
JCFG, CFG = JCfg(**KW, remat=False), ModelConfig(**KW)


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 200, size=n).tolist() for n in lens]


def _solo(p, prompt, max_new=6):
    """Bucketed-engine solo serving: the port's token oracle."""
    r = Request(np.asarray(prompt), max_new=max_new)
    ContinuousBatchingEngine(CFG, p, batch_slots=1, max_len=64, device="cpu").serve([r])
    assert r.done
    return r.out


def _ragged(p, **kw):
    return ContinuousBatchingEngine(CFG, p, **{"batch_slots": 3, "max_len": 64, "device": "cpu",
                                               "paged": True, "ragged": True,
                                               "token_budget": 16, **kw})


def _mixed_batch(seed=3):
    """Every row species (the reference's test batch): a decode row, a chunk
    continuing behind committed pages, a cold chunk, pad rows. JAX arrays."""
    rng = np.random.default_rng(seed)
    B, maxp, page, T, KV, H, hd = 3, 4, 8, 16, 2, 4, 16
    P = B * maxp

    def f(*s):
        return jnp.asarray(rng.standard_normal(s), jnp.bfloat16)

    q, kt, vt = f(T, H, hd), f(T, KV, hd), f(T, KV, hd)
    kp, vp = f(P, page, KV, hd), f(P, page, KV, hd)
    ctx = np.array([13, 5, 0], np.int32)
    perm = rng.permutation(P)
    bt = np.full((B, maxp), -1, np.int32)
    for b in range(B):
        n_pg = -(-int(ctx[b]) // page) + 1
        bt[b, :n_pg] = perm[b * maxp: b * maxp + n_pg]
    slot = np.full(T, B, np.int32)
    pos = np.zeros(T, np.int32)
    slot[0], pos[0] = 0, 13
    slot[1:7], pos[1:7] = 1, np.arange(5, 11)
    slot[7:14], pos[7:14] = 2, np.arange(0, 7)
    args = (q, kp, vp, kt, vt, jnp.asarray(bt), jnp.asarray(slot), jnp.asarray(pos),
            jnp.asarray(ctx))
    return args, slot < B


# ---------------------------------------------------------------------------
# the plain version against the reference
# ---------------------------------------------------------------------------


def test_ragged_ref_matches_jax_ref():
    args, real = _mixed_batch()
    want = _np(j_ref(*args))
    got = _np(ragged_attention_ref(*(_t(a) for a in args)))
    np.testing.assert_array_equal(got[0], want[0])  # the decode row
    np.testing.assert_allclose(got[real], want[real], atol=0.03, rtol=0.05)
    assert not got[~real].any()  # pad rows are zeros


def test_ragged_ref_vs_jax_interpret_kernel():
    args, real = _mixed_batch(seed=5)
    ker = _np(j_kernel(*args, interpret=True))
    got = _np(ragged_attention_kernel(*(_t(a) for a in args)))  # CPU: the plain version
    np.testing.assert_allclose(got[real], ker[real], atol=0.03, rtol=0.05)


def test_check_ragged_rows():
    """The kernel's row contract, checked on the host: one contiguous run of
    consecutive positions from ctx per slot, slot ids in [0, B]."""
    args, _ = _mixed_batch()
    slot, pos, ctx = (np.asarray(a) for a in args[6:])
    check_ragged_rows(slot, pos, ctx)
    split = slot.copy()
    split[[6, 7]] = split[[7, 6]]  # slot 1's run broken by a slot-2 row
    with pytest.raises(ContractError, match="contiguous"):
        check_ragged_rows(split, pos, ctx)
    gap = pos.copy()
    gap[3] += 1
    with pytest.raises(ContractError, match="consecutive"):
        check_ragged_rows(slot, gap, ctx)
    late = ctx.copy()
    late[0] = 12  # decode row at 13 behind only 12 committed rows
    with pytest.raises(ContractError, match="consecutive"):
        check_ragged_rows(slot, pos, late)
    bad = slot.copy()
    bad[15] = 7
    with pytest.raises(ContractError, match="slot ids"):
        check_ragged_rows(bad, pos, ctx)


def test_check_ragged_rows_table_bound():
    """With the block table's size, the row contract also holds ``ctx <=
    maxp * page``: the kernel's chunk grid and scratch cover positions
    below ``maxp * page + T`` only."""
    args, _ = _mixed_batch()
    slot, pos, ctx = (np.asarray(a) for a in args[6:])
    check_ragged_rows(slot, pos, ctx, s_max=32)  # maxp 4 x page 8
    with pytest.raises(ContractError, match="exceeds the block table"):
        check_ragged_rows(slot, pos, ctx, s_max=12)


@pytest.mark.parametrize("model", ["llama3-8b", "qwen3-8b", "tiny"])
def test_ragged_contract_smem_and_scratch(model):
    """The split-KV ragged kernel's contract: the model's heads at any
    token budget pass, with the split block (the tile body for 32 query
    vectors) inside the budget, two blocks an SM at the models' widths,
    and a scratch of one f32 partial (hd + 2) per (tile, KV head, chunk, 32
    query vectors) over positions below maxp * page + T, then the plan: a
    count, 8 ints a tile and the work list; the chunk is whole 64-key
    tiles, and the work items fit the split launch's grid."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.autotune import PAGED_CHUNK, PAGED_TILE
    from repro_torch.kernels.contracts import (SMEM_BUDGET_BYTES, ragged_scratch_floats,
                                               ragged_smem_bytes, validate_ragged_attention)

    c = CFG if model == "tiny" else get_config(model)
    h, kv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    for t in (1, 16, 256, 2048):
        validate_ragged_attention(t, h, kv, hd, 8, 128, 16)
    assert ragged_smem_bytes(hd) <= SMEM_BUDGET_BYTES
    assert 2 * (ragged_smem_bytes(hd) + 1024) <= 233_472  # two blocks an SM
    nc = -(-(128 * 16 + 256) // PAGED_CHUNK)
    z = 8 + -(-256 // (32 // (h // kv)))  # B + ceil(T / rows a tile)
    parts = z * kv * nc * 32 * (hd + 2)
    assert parts % 4 == 0
    assert ragged_scratch_floats(256, 8, h, kv, hd, 128, 16) == parts + 4 + 8 * z + z * nc
    for chunk, ok in ((PAGED_TILE, True), (512, True), (96, False), (576, False)):
        if ok:
            validate_ragged_attention(256, h, kv, hd, 8, 128, 16, chunk=chunk)
        else:
            with pytest.raises(ContractError, match="chunk"):
                validate_ragged_attention(256, h, kv, hd, 8, 128, 16, chunk=chunk)
    with pytest.raises(ContractError, match="grid"):
        validate_ragged_attention(16384, h, kv, hd, 8, 4096, 16)


def test_dispatch_records_ragged_kind():
    args, _ = _mixed_batch()
    ta = tuple(_t(a) for a in args)
    dispatch.reset_dispatch_counters()
    dispatch.ragged_attention(*ta)
    prev = dispatch.set_force_ref(True)
    try:
        dispatch.ragged_attention(*ta)
    finally:
        dispatch.set_force_ref(prev)
    c = dispatch.dispatch_counters()
    assert c.get("ragged/kernel") == 1, c
    assert c.get("ragged/ref") == 1 and c.get("ragged/ref[forced]") == 1, c
    assert dispatch.classify_ragged(16, 4, 3, 16, 3, 4, 8).code == "hd_unaligned"
    assert dispatch.classify_ragged(16, 4, 2, 16, 3, 4, 128).code == "vmem"  # page > 64


def test_ragged_step_matches_jax(jparams, params):
    rng = np.random.default_rng(4)
    B, page, n_pages, max_len, T = 3, 8, 12, 32, 16
    js = JC_.init_paged_state(JD.init_decode_state, JCFG, B, max_len, page, n_pages)
    js["k"] = jnp.asarray(rng.standard_normal(js["k"].shape) * 0.5, jnp.bfloat16)
    js["v"] = jnp.asarray(rng.standard_normal(js["v"].shape) * 0.5, jnp.bfloat16)
    bt = np.full((B, max_len // page), -1, np.int32)
    bt[0, :3], bt[1, :2], bt[2, :1] = [7, 2, 9], [4, 0], [11]
    js["bt"] = jnp.asarray(bt)
    ctx = np.array([17, 3, 0], np.int32)
    slot = np.full(T, B, np.int32)
    pos = np.zeros(T, np.int32)
    slot[0], pos[0] = 0, 17  # decode row
    slot[1:9], pos[1:9] = 1, np.arange(3, 11)  # chunk behind 3 committed rows
    slot[9:13], pos[9:13] = 2, np.arange(0, 4)  # cold chunk
    logit_idx = np.array([0, 8, 12], np.int32)
    tokens = rng.integers(0, KW["vocab"], T).astype(np.int32)
    ts = {k: _t(v) for k, v in js.items()}
    lj, sj = JD.ragged_step(jparams, JCFG, js, *(jnp.asarray(a) for a in
                                                  (tokens, slot, pos, ctx, logit_idx)))
    lt, st = TD.ragged_step(params, CFG, ts, *(torch.as_tensor(a) for a in
                                               (tokens, slot, pos, ctx, logit_idx)))
    rel = np.linalg.norm(_np(lj) - _np(lt)) / np.linalg.norm(_np(lj))
    assert rel <= 0.03
    for key in ("k", "v"):
        a, b = _np(sj[key]), _np(st[key])
        assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 0.03
    assert st["pos"].tolist() == np.asarray(sj["pos"]).tolist() == [18, 11, 4]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_prompt", [16, 17])
def test_prompt_at_and_over_budget(params, n_prompt):
    """At the budget the prompt prefills in one launch; one token over spills
    a 1-token second chunk. Both equal the bucketed oracle, one launch shape."""
    (prompt,) = _prompts([n_prompt])
    eng = _ragged(params)
    req = Request(np.asarray(prompt), max_new=6)
    eng.serve([req])
    assert req.out == _solo(params, prompt)
    cs = eng.compile_stats()
    assert cs["ragged_traces"] == 1 and cs["prefill_traces"] == 0, cs


def test_ragged_interleaved_token_equality(params):
    prompts = _prompts((5, 23, 17, 9))
    oracles = [_solo(params, p) for p in prompts]
    eng = _ragged(params)
    reqs = [Request(np.asarray(p), max_new=6) for p in prompts]
    for r in reqs:
        eng.submit(r)
        eng.step()
        eng.check_page_invariants()
    eng.run_until_done()
    eng.check_page_invariants()
    for k, (r, o) in enumerate(zip(reqs, oracles)):
        assert r.out == o, (k, r.out, o)
    cs = eng.compile_stats()
    assert cs["ragged_traces"] == 1 and cs["decode_traces"] == 0, cs
    assert set(eng.routing()) == {"ragged/kernel"}


@pytest.mark.parametrize("mode", ["w4a4", "w4a16"])
def test_ragged_interleaved_token_equality_quantized(mode):
    """test_ragged_interleaved_token_equality's workload through packed
    linears (d_model 256, so every block linear packs): every ragged step
    runs the linears at M = token_budget, and the tokens equal the bucketed
    engine's solo tokens."""
    cfg = ModelConfig(name="q", n_layers=1, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=512, vocab=260)
    qp = quantize_params(TD.init_params(cfg, seed=0, device="cpu"), cfg,
                         QuantSpec(mode=mode, rank=32))
    prompts = _prompts((5, 23, 17, 9))
    oracles = []
    for p in prompts:
        r = Request(np.asarray(p), max_new=6)
        ContinuousBatchingEngine(cfg, qp, batch_slots=1, max_len=64, device="cpu").serve([r])
        oracles.append(r.out)
    eng = ContinuousBatchingEngine(cfg, qp, batch_slots=3, max_len=64, device="cpu", paged=True,
                                   ragged=True, token_budget=16)
    reqs = [Request(np.asarray(p), max_new=6) for p in prompts]
    for r in reqs:
        eng.submit(r)
        eng.step()
    eng.run_until_done()
    eng.check_page_invariants()
    for k, (r, o) in enumerate(zip(reqs, oracles)):
        assert r.out == o, (k, r.out, o)
    routes = eng.routing()
    assert not any("/ref" in k for k in routes), routes
    if mode == "w4a16":
        steps = eng.stats["decode_steps"]
        assert routes == {"ragged/kernel": cfg.n_layers * steps,
                          "w4a16/prefill": 7 * cfg.n_layers * steps}, routes


def test_decode_tokens_never_drop_during_admission(params):
    eng = _ragged(params)
    steady = [Request(np.asarray([7 + k, 11, 13]), max_new=30) for k in range(2)]
    for r in steady:
        eng.submit(r)
    eng.step()
    assert all(r._last_logits is not None for r in steady)
    (long_prompt,) = _prompts([40], seed=2)
    burst = Request(np.asarray(long_prompt), max_new=4)
    eng.submit(burst)
    deltas = []
    while burst._last_logits is None:
        before = eng.stats["decode_tokens"]
        eng.step()
        deltas.append(eng.stats["decode_tokens"] - before)
    assert len(deltas) >= 3 and all(d == 2 for d in deltas), deltas


def test_max_chunk_share_keeps_decode_cadence(params):
    """The cadence assertions of the reference's test. Its last assertion
    (the flooding request's tokens against the solo oracle) is left out: the
    40-token prompt chunked 4 at a time carries the reference's own
    multi-chunk f32 reassociation (``ragged_attention.py:30-42``), and the
    reference fails that assertion itself on jax 0.9.0."""
    eng = _ragged(params, max_chunk_share=0.25)
    cap = max(1, int(16 * 0.25))
    steady = [Request(np.asarray([7 + k, 11, 13]), max_new=30) for k in range(2)]
    for r in steady:
        eng.submit(r)
    for _ in range(4):
        if all(r._last_logits is not None for r in steady):
            break
        eng.step()
    assert all(r._last_logits is not None for r in steady)
    (long_prompt,) = _prompts([40], seed=2)
    burst = Request(np.asarray(long_prompt), max_new=4)
    eng.submit(burst)
    deltas, chunk_rows = [], []
    while burst._last_logits is None:
        before_d, before_p = eng.stats["decode_tokens"], eng.stats["prefill_tokens"]
        eng.step()
        deltas.append(eng.stats["decode_tokens"] - before_d)
        chunk_rows.append(eng.stats["prefill_tokens"] - before_p)
    assert len(deltas) >= 10, deltas
    assert all(d == 2 for d in deltas), deltas
    assert all(c <= cap for c in chunk_rows), chunk_rows
    eng.run_until_done()
    assert burst.done and len(burst.out) == 4


def test_ragged_without_paged_falls_back_with_warning(params):
    with pytest.warns(UserWarning, match="ragged"):
        eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                       ragged=True)
    assert not eng.ragged
    (prompt,) = _prompts([7])
    req = Request(np.asarray(prompt), max_new=4)
    eng.serve([req])
    assert req.out == _solo(params, prompt, max_new=4)


@pytest.mark.parametrize("kw, match", [
    (dict(batch_slots=4, token_budget=2), "token_budget"),
    (dict(max_chunk_share=0.0), "max_chunk_share"),
    (dict(max_chunk_share=1.5), "max_chunk_share"),
])
def test_ragged_engine_validation(params, kw, match):
    with pytest.raises(ValueError, match=match):
        _ragged(params, **kw)


def test_first_tokens_match_jax_ragged_engine(jparams, params):
    """The slice as a whole: the port's ragged engine and the reference's, on
    bridged params, give the same first greedy tokens (from the ragged
    step's logits) wherever the reference's top-2 margin exceeds 0.05."""
    prompts = [[1, 2, 3], [7] * 5, [100, 3, 99, 4, 5, 6], list(range(50, 59)),
               list(range(10, 22)), [3, 1] * 8]
    jreqs = [JRequest(jnp.asarray(p, jnp.int32), max_new=2) for p in prompts]
    JEngine(JCFG, jparams, batch_slots=3, max_len=64, paged=True, ragged=True,
            token_budget=16).serve(jreqs)
    treqs = [Request(np.asarray(p), max_new=2) for p in prompts]
    _ragged(params).serve(treqs)

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


@pytest.mark.gpu
def test_ragged_kernel_close_to_plain_version_on_card():
    """On the card: the kernel within atol 0.03 / rtol 0.05 of the plain
    version on real rows, pad rows zero (chip_smoke.py does the same at
    llama3-8b shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    args, real = _mixed_batch(seed=9)
    ta = [_t(a).to("cuda") for a in args]
    y_k = ragged_attention_kernel(*ta).cpu()
    y_p = ragged_attention_ref(*ta).cpu()
    real = torch.as_tensor(real)
    torch.testing.assert_close(y_k[real].float(), y_p[real].float(), atol=0.03, rtol=0.05)
    assert not y_k[~real].float().any()
