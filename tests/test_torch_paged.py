"""The port's paged KV runtime (repro_torch: kernels/paged_attention.py,
models/common.py's page helpers, dense.decode_step's paged branch, the
engine's PageAllocator / PrefixCache / paged admission) held to the JAX
package.

Tolerances, and where bit-equality holds:
* ``paged_decode_ref`` against the reference's ``paged_decode_ref``: equal
  bit for bit (both mirror the same roundings op for op); against the
  reference's Pallas kernel run with ``interpret=True``: atol 0.03 / rtol
  0.05, the reference's own bound for its kernel, since the kernel folds in
  f32; committed pools bit-equal (plain bf16 copies both ways).
* page scatter/gather helpers: bit-equal to the reference's.
* one paged decode step of the model (sq = 1 and a 4-row draft stack):
  logits rel <= 0.03 (bf16 rounding at other places in XLA's and PyTorch's
  CPU matmuls, the bound of tests/test_torch_dense.py), committed pool rows
  rel <= 0.03.
* engine invariants (paged == dense engine, prefix hits == cold misses,
  eviction, memory, truncation) are held within the port token for token,
  as the reference holds them within itself; first greedy tokens equal the
  JAX paged engine's wherever the reference's top-2 margin exceeds 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.kernels.paged_attention import paged_decode_kernel as j_kernel
from repro.kernels.paged_attention import paged_decode_ref as j_ref
from repro.launch.serve import ContinuousBatchingEngine as JEngine
from repro.launch.serve import Request as JRequest
from repro.models import common as JC_
from repro.models import dense as JD
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.twinquant import quantize_params
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import dispatch
from repro_torch.kernels.contracts import ContractError, validate_paged_decode
from repro_torch.kernels.paged_attention import paged_decode_kernel, paged_decode_ref
from repro_torch.launch.serve import ContinuousBatchingEngine, PageAllocator, Request
from repro_torch.models import common as C
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


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _spec_batch(seed=3, sq=4, hd=16):
    """A mixed-occupancy launch (the reference's test batch): slot 0
    mid-sequence with its draft span straddling a page boundary, slot 1
    early, slot 2 cold; every slot's tail pages mapped. JAX arrays."""
    rng = np.random.default_rng(seed)
    B, maxp, page, KV, H = 3, 4, 8, 2, 4
    P = B * maxp

    def f(*s):
        return jnp.asarray(rng.standard_normal(s), jnp.bfloat16)

    q, kt, vt = f(B, sq, H, hd), f(B, sq, KV, hd), f(B, sq, KV, hd)
    kp, vp = f(P, page, KV, hd), f(P, page, KV, hd)
    pos = np.array([13, 5, 0], np.int32)
    perm = rng.permutation(P)
    bt = np.full((B, maxp), -1, np.int32)
    for b in range(B):
        n_pg = (int(pos[b]) + sq - 1) // page + 1
        bt[b, :n_pg] = perm[b * maxp: b * maxp + n_pg]
    return (q, kp, vp, kt, vt, jnp.asarray(bt), jnp.asarray(pos))


def _both(args):
    return args, tuple(_t(a) for a in args)


def _solo(p, prompt, max_new=8, max_len=64):
    """Dense-engine solo serving: the port's correctness oracle."""
    r = Request(np.asarray(prompt), max_new=max_new)
    ContinuousBatchingEngine(CFG, p, batch_slots=1, max_len=max_len, device="cpu").serve([r])
    assert r.done
    return r.out


def _paged(p, **kw):
    return ContinuousBatchingEngine(CFG, p, **{"batch_slots": 2, "max_len": 64, "device": "cpu",
                                               "paged": True, **kw})


# ---------------------------------------------------------------------------
# the plain version against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("commit", [True, False])
def test_paged_decode_ref_bit_equal_to_jax_ref(commit):
    ja, ta = _both(_spec_batch(seed=5 if commit else 3))
    rj = j_ref(*ja, commit=commit)
    rt = paged_decode_ref(*ta, commit=commit)
    for a, b in zip(rj if commit else (rj,), rt if commit else (rt,)):
        np.testing.assert_array_equal(_np(b), _np(a))


@pytest.mark.parametrize("commit", [True, False])
def test_paged_decode_ref_vs_jax_interpret_kernel(commit):
    """The reference's Pallas kernel (interpret mode) folds in f32: the port's
    plain version agrees to its bound; the committed pools bit for bit."""
    ja, ta = _both(_spec_batch(seed=7))
    rk = j_kernel(*ja, commit=commit, interpret=True)
    rt = paged_decode_kernel(*ta, commit=commit)  # CPU tensors: the plain version
    out_k, out_t = (rk[0], rt[0]) if commit else (rk, rt)
    np.testing.assert_allclose(_np(out_t), _np(out_k), atol=0.03, rtol=0.05)
    if commit:
        np.testing.assert_array_equal(_np(rt[1]), _np(rk[1]))
        np.testing.assert_array_equal(_np(rt[2]), _np(rk[2]))


def test_stacked_rows_equal_sequential_commits():
    """Row i of a stacked draft launch equals a one-row launch at pos + i
    once the earlier drafts are committed: what makes greedy speculative
    acceptance exact."""
    q, kp, vp, kt, vt, bt, pos = (_t(a) for a in _spec_batch(seed=11))
    stacked = paged_decode_ref(q, kp, vp, kt, vt, bt, pos, commit=False)
    outs = []
    for i in range(q.shape[1]):
        o, kp, vp = paged_decode_ref(q[:, i:i + 1], kp, vp, kt[:, i:i + 1], vt[:, i:i + 1],
                                     bt, pos + i, commit=True)
        outs.append(o)
    assert torch.equal(stacked, torch.cat(outs, dim=1))


def test_sq1_equals_dense_decode_attention():
    """sq = 1 over pages equals the dense-cache decode attention over the
    gathered view, bit for bit (the A/B the paged engine rests on)."""
    q, kp, vp, kt, vt, bt, pos = (_t(a) for a in _spec_batch(seed=13, sq=1))
    out = paged_decode_ref(q, kp, vp, kt, vt, bt, pos, commit=False)
    kc, vc = C.gather_pages(kp, bt), C.gather_pages(vp, bt)
    qg = q.reshape(3, 1, 2, 2, 16)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, kc).to(torch.float32) / (16 ** 0.5)
    mask = torch.arange(kc.shape[1])[None, None, None, None, :] < pos.long()[:, None, None, None,
                                                                             None]
    logits = torch.where(mask, logits, -1e30)
    ls = torch.einsum("bskgh,bskh->bkgs", qg, kt).to(torch.float32)[..., None] / (16 ** 0.5)
    m = torch.maximum(logits.amax(-1, keepdim=True), ls)
    pc, ps = torch.exp(logits - m), torch.exp(ls - m)
    den = pc.sum(-1, keepdim=True) + ps
    ref = torch.einsum("bkgst,btkh->bskgh", (pc / den).to(vc.dtype), vc)
    ref = ref + (ps / den)[..., 0][..., None].permute(0, 3, 1, 2, 4).to(vt.dtype) * vt[:, :, :,
                                                                                       None]
    assert torch.equal(out, ref.reshape(out.shape))


# ---------------------------------------------------------------------------
# page helpers
# ---------------------------------------------------------------------------


def _pool_case(seed=0):
    rng = np.random.default_rng(seed)
    L, P, page, KV, hd, B, maxp = 2, 6, 4, 2, 8, 3, 3
    pool = jnp.asarray(rng.standard_normal((L, P, page, KV, hd)), jnp.bfloat16)
    bt = np.full((B, maxp), -1, np.int32)
    bt[0, :2] = [4, 1]
    bt[1, :1] = [5]
    # slot 2 unmapped (an idle slot): its rows must go nowhere, never into page P-1
    return pool, jnp.asarray(bt), rng


def test_scatter_rows_pages_drops_pad_unmapped_and_out_of_table_rows():
    pool, bt, rng = _pool_case()
    t = jnp.asarray(rng.standard_normal((2, 7, 2, 8)), jnp.bfloat16)
    slot = jnp.asarray([0, 0, 1, 3, 2, 1, 0], jnp.int32)  # 3 == B: pad
    pos = jnp.asarray([2, 5, 3, 0, 1, 4, 12], jnp.int32)  # slot 1 pos 4: unmapped page;
    want = JC_.scatter_rows_pages(pool, t, bt, slot, pos)  # slot 0 pos 12: past the table
    got = _t(pool)
    C.scatter_rows_pages(got, _t(t), _t(bt), _t(slot), _t(pos))
    np.testing.assert_array_equal(_np(got), _np(want))
    # unmapped pages untouched; the idle slot's row (pos 1) did not wrap into
    # the last page, which slot 1 owns
    for pg in (0, 2, 3):
        np.testing.assert_array_equal(_np(got)[:, pg], _np(pool)[:, pg])
    np.testing.assert_array_equal(_np(got)[:, 5, 1], _np(pool)[:, 5, 1])


def test_scatter_token_pages_and_gather_pages_match_jax():
    pool, bt, rng = _pool_case(1)
    t = jnp.asarray(rng.standard_normal((2, 3, 1, 2, 8)), jnp.bfloat16)
    pos = jnp.asarray([6, 2, 0], jnp.int32)
    want = JC_.scatter_token_pages(pool, t, bt, pos)
    got = _t(pool)
    C.scatter_token_pages(got, _t(t), _t(bt), _t(pos))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(C.gather_pages(got[0], _t(bt))),
                                  _np(JC_.gather_pages(want[0], bt)))


def test_paged_layout_and_state():
    assert C.paged_layout(TD.init_decode_state, CFG, 64) == {"k": (1, 2), "v": (1, 2),
                                                             "pos": (0, None)}
    st = C.init_paged_state(TD.init_decode_state, CFG, 3, 60, 8, 11, "cpu")
    assert tuple(st["k"].shape) == (2, 11, 8, 2, 16) and tuple(st["pos"].shape) == (3,)
    assert tuple(st["bt"].shape) == (3, 8) and bool((st["bt"] == -1).all())


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_dispatch_records_paged_decode_kind():
    _, ta = _both(_spec_batch())
    dispatch.reset_dispatch_counters()
    dispatch.paged_decode(*ta, commit=False)
    prev = dispatch.set_force_ref(True)
    try:
        dispatch.paged_decode(*ta, commit=False)
    finally:
        dispatch.set_force_ref(prev)
    c = dispatch.dispatch_counters()
    assert c.get("paged_decode/kernel") == 1, c
    assert c.get("paged_decode/ref") == 1 and c.get("paged_decode/ref[forced]") == 1, c


def test_dispatch_ref_reason_codes_and_raise_off_cpu():
    """A draft stack past DECODE_M_MAX routes ref[rows], an unloadable head
    dim ref[hd_unaligned]; both run the plain version on the CPU, and on any
    other device (meta, standing in for the card) the same route raises."""
    dispatch.reset_dispatch_counters()
    _, deep = _both(_spec_batch(sq=9))
    dispatch.paged_decode(*deep, commit=False)
    _, odd = _both(_spec_batch(hd=12))
    dispatch.paged_decode(*odd, commit=False)
    c = dispatch.dispatch_counters()
    assert c.get("paged_decode/ref[rows]") == 1 and c.get("paged_decode/ref[hd_unaligned]") == 1
    meta = tuple(a.to("meta") for a in deep)
    with pytest.raises(ContractError, match=r"ref\[rows\]"):
        dispatch.paged_decode(*meta, commit=False)


def test_validate_paged_decode_contract():
    validate_paged_decode(8, 8, 32, 8, 128, 128, 16)  # llama3-8b, 8 draft rows
    with pytest.raises(ContractError, match="query vectors"):
        validate_paged_decode(8, 8, 64, 8, 128, 128, 16)  # 8 rows x 8 heads > 32
    with pytest.raises(ContractError, match="page_size"):
        validate_paged_decode(8, 1, 32, 8, 128, 16, 128)
    with pytest.raises(ContractError, match="head_dim"):
        validate_paged_decode(8, 1, 32, 8, 512, 128, 16)


@pytest.mark.parametrize("model", ["llama3-8b", "qwen3-8b"])
def test_paged_decode_contract_chunk_smem_and_scratch(model):
    """The split-KV kernel's contract: every decode (sq = 1) and verify (sq
    up to 8) shape of llama3-8b / qwen3-8b passes, with the split block's
    shared memory inside the budget (three stages where two blocks fit an
    SM: sq = 1; two for the wider query tiles) and a scratch of one f32
    partial (hd + 2) per (slot, KV head, chunk, query vector); the chunk is
    whole 64-key tiles, one tile at least, at most the block table a block
    stages."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.autotune import PAGED_CHUNK, PAGED_TILE
    from repro_torch.kernels.contracts import (SMEM_BUDGET_BYTES, paged_scratch_floats,
                                               paged_smem_bytes)

    c = get_config(model)
    h, kv, hd = c.n_heads, c.n_kv_heads, c.head_dim
    assert PAGED_CHUNK % PAGED_TILE == 0
    for sq in range(1, 9):
        validate_paged_decode(8, sq, h, kv, hd, 128, 16)
        assert paged_smem_bytes(hd, sq * h // kv) <= SMEM_BUDGET_BYTES
    assert 2 * (paged_smem_bytes(hd, h // kv) + 1024) <= 233_472  # two decode blocks an SM
    nc = 128 * 16 // PAGED_CHUNK
    assert paged_scratch_floats(8, 4, h, kv, hd, 128, 16) == 8 * kv * nc * 4 * (h // kv) * (hd + 2)
    for chunk, ok in ((PAGED_TILE, True), (512, True), (96, False), (32, False), (576, False)):
        if ok:
            validate_paged_decode(8, 1, h, kv, hd, 128, 16, chunk=chunk)
        else:
            with pytest.raises(ContractError, match="chunk"):
                validate_paged_decode(8, 1, h, kv, hd, 128, 16, chunk=chunk)


# ---------------------------------------------------------------------------
# one model step against the reference
# ---------------------------------------------------------------------------


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.mark.parametrize("sq", [1, 4])
def test_paged_decode_step_matches_jax(jparams, params, sq):
    rng = np.random.default_rng(sq)
    B, page, n_pages, max_len = 3, 8, 12, 32
    js = JC_.init_paged_state(JD.init_decode_state, JCFG, B, max_len, page, n_pages)
    js["k"] = jnp.asarray(rng.standard_normal(js["k"].shape) * 0.5, jnp.bfloat16)
    js["v"] = jnp.asarray(rng.standard_normal(js["v"].shape) * 0.5, jnp.bfloat16)
    bt = np.full((B, max_len // page), -1, np.int32)
    bt[0, :3], bt[1, :2] = [7, 2, 9], [4, 0]  # slot 2 idle
    js["bt"] = jnp.asarray(bt)
    js["pos"] = jnp.asarray([17 - sq, 3, 0], jnp.int32)
    tokens = rng.integers(0, KW["vocab"], (B, sq)).astype(np.int32)
    ts = {k: _t(v) for k, v in js.items()}
    lj, sj = JD.decode_step(jparams, JCFG, js, jnp.asarray(tokens))
    lt, st = TD.decode_step(params, CFG, ts, torch.as_tensor(tokens, dtype=torch.long))
    live = [0, 1]
    assert _rel(_np(lj)[live], _np(lt)[live]) <= 0.03
    assert _rel(_np(sj["k"]), _np(st["k"])) <= 0.03 and _rel(_np(sj["v"]), _np(st["v"])) <= 0.03
    assert st["pos"].tolist() == np.asarray(sj["pos"]).tolist()
    # the idle slot wrote nowhere: only slots 0 and 1's draft rows changed
    changed = (_np(st["k"]) != _np(ts["k"])).any(axis=(0, 2, 3, 4))
    assert set(np.flatnonzero(changed).tolist()) <= {7, 2, 9, 4, 0}


# ---------------------------------------------------------------------------
# the page allocator
# ---------------------------------------------------------------------------


def test_page_allocator_churn():
    rng = np.random.default_rng(0)
    al = PageAllocator(13)
    held, shared = [], []
    for _ in range(500):
        r = rng.random()
        if held and r < 0.35:
            al.release(held.pop(int(rng.integers(len(held)))))
        elif held and r < 0.5:
            p = held[int(rng.integers(len(held)))][0]
            al.share([p])
            shared.append(p)
        elif shared and r < 0.6:
            al.release([shared.pop()])
        else:
            n = int(rng.integers(1, 5))
            pages = al.alloc(n)
            if pages is None:
                assert al.n_free < n
            else:
                assert len(set(pages)) == n
                held.append(pages)
        al.audit()
    for pages in held:
        al.release(pages)
    al.release(shared)
    al.audit()
    assert al.n_free == al.n_pages and al.peak_used <= al.n_pages


def test_page_allocator_refusal_and_double_release():
    al = PageAllocator(4)
    pages = al.alloc(4)
    assert al.alloc(1) is None
    al.release(pages)
    with pytest.raises(AssertionError, match="double release"):
        al.release([pages[0]])
    with pytest.raises(AssertionError, match="unknown page"):
        al.release([7])
    with pytest.raises(AssertionError, match="unreferenced"):
        al.share([0])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_paged_interleaving_equals_dense_solo(params):
    a, b = list(range(10, 22)), list(range(100, 105))
    eng = _paged(params, page_size=16)
    ra = Request(np.asarray(a), max_new=8)
    eng.submit(ra)
    for _ in range(2):
        eng.step()
        eng.check_page_invariants()
    rb = Request(np.asarray(b), max_new=8)
    eng.submit(rb)
    eng.run_until_done()
    eng.check_page_invariants()
    assert ra.out == _solo(params, a) and rb.out == _solo(params, b)
    assert eng.compile_stats()["decode_traces"] == 1
    assert eng.routing().get("paged_decode/kernel", 0) > 0


@pytest.mark.parametrize("mode", ["w4a4", "w4a16"])
def test_paged_interleaving_equals_dense_solo_quantized(mode):
    """test_paged_interleaving_equals_dense_solo's workload through packed
    linears (d_model 256, so every block linear packs): the paged engine's
    interleaved tokens equal the bucketed dense-cache engine's solo tokens."""
    cfg = ModelConfig(name="q", n_layers=1, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=512, vocab=260)
    qp = quantize_params(TD.init_params(cfg, seed=0, device="cpu"), cfg,
                         QuantSpec(mode=mode, rank=32))
    a, b = list(range(10, 22)), list(range(100, 105))
    eng = ContinuousBatchingEngine(cfg, qp, batch_slots=2, max_len=64, device="cpu", paged=True,
                                   page_size=16)
    ra = Request(np.asarray(a), max_new=8)
    eng.submit(ra)
    for _ in range(2):
        eng.step()
    rb = Request(np.asarray(b), max_new=8)
    eng.submit(rb)
    eng.run_until_done()
    eng.check_page_invariants()
    routes = eng.routing()  # process-wide counters: read before the solo runs
    for prompt, r in ((a, ra), (b, rb)):
        solo = Request(np.asarray(prompt), max_new=8)
        ContinuousBatchingEngine(cfg, qp, batch_slots=1, max_len=64, device="cpu").serve([solo])
        assert r.out == solo.out
    assert routes.get("paged_decode/kernel", 0) > 0 and not any("/ref" in k for k in routes)
    linear = "w4a16/prefill" if mode == "w4a16" else "dual_fused/decode"
    assert routes.get(linear, 0) > 0, routes


def test_paged_scrambled_pages(params):
    eng = _paged(params, page_size=8, prefix_caching=False)
    for k in range(3):
        eng.serve([Request(np.asarray([7 + k, 8, 9]), max_new=3)])
    a, b = list(range(30, 47)), list(range(200, 206))
    ra = Request(np.asarray(a), max_new=6)
    eng.submit(ra)
    eng.step()
    rb = Request(np.asarray(b), max_new=6)
    eng.submit(rb)
    eng.run_until_done()
    eng.check_page_invariants()
    assert ra.out == _solo(params, a, 6) and rb.out == _solo(params, b, 6)


def test_prefix_cache_hit_equivalence(params):
    pre = list(range(1, 33))  # 4 full pages at page_size 8
    p1, p2 = pre + [40, 41, 42], pre + [50, 51]
    eng = _paged(params, page_size=8)
    eng.serve([Request(np.asarray(p1), max_new=4)])
    cold = eng.stats["prefill_tokens"]
    assert cold == len(p1)
    r2 = Request(np.asarray(p2), max_new=4)
    eng.serve([r2])
    eng.check_page_invariants()
    assert eng.stats["prefix_hits"] == 1 and eng.stats["prefix_hit_tokens"] == 32
    assert eng.stats["prefill_tokens"] - cold == len(p2) - 32
    r2c = Request(np.asarray(p2), max_new=4)
    _paged(params, page_size=8, prefix_caching=False).serve([r2c])
    assert r2.out == r2c.out == _solo(params, p2, 4)


def test_prefix_cache_hit_while_owner_live(params):
    pre = list(range(60, 76))
    p1, p2 = pre + [1, 2], pre + [3]
    eng = _paged(params, page_size=8)
    r1 = Request(np.asarray(p1), max_new=10)
    eng.submit(r1)
    eng.step()
    r2 = Request(np.asarray(p2), max_new=10)
    eng.submit(r2)
    eng.run_until_done()
    eng.check_page_invariants()
    assert eng.stats["prefix_hits"] == 1
    assert r1.out == _solo(params, p1, 10) and r2.out == _solo(params, p2, 10)


def test_prefix_hit_survives_eviction_pressure(params):
    eng = _paged(params, page_size=8, n_pages=8)
    p1, pb = list(range(0, 17)), list(range(100, 117))
    for p in (p1, pb):
        eng.serve([Request(np.asarray(p), max_new=3)])
    assert len(eng.prefix_cache) == 4 and eng.allocator.n_free == 4
    p2 = p1[:16] + list(range(200, 209))
    r2 = Request(np.asarray(p2), max_new=25)
    eng.serve([r2])
    eng.check_page_invariants()
    assert r2.done and eng.stats["prefix_hits"] == 1
    assert r2.out == _solo(params, p2, 25)
    tiny = _paged(params, batch_slots=1, page_size=8, n_pages=4)
    with pytest.raises(ValueError, match="pool"):
        tiny.submit(Request(np.arange(40), max_new=16))


def test_prefix_cache_eviction_under_page_pressure(params):
    eng = _paged(params, page_size=8, n_pages=10)
    for base in (0, 40, 80, 120, 160):
        p = list(range(base, base + 17))
        r = Request(np.asarray(p), max_new=3)
        eng.serve([r])
        eng.check_page_invariants()
        assert r.out == _solo(params, p, 3)
    assert eng.memory()["pages_in_use"] <= 10


def test_peak_cache_memory_below_dense(params):
    eng = _paged(params, batch_slots=4, page_size=8)
    eng.serve([Request(np.asarray([i, i + 1, i + 2]), max_new=3) for i in range(0, 40, 10)])
    mem = eng.memory()
    assert mem["mode"] == "paged" and mem["dense_cache_bytes"] == 2 * 2 * 4 * 64 * 2 * 16 * 2
    assert mem["peak_cache_bytes"] < mem["dense_cache_bytes"] / 2, mem


@pytest.mark.parametrize("paged", [False, True])
def test_truncation_flagged_not_silent(params, paged):
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=1, max_len=16, device="cpu",
                                   paged=paged, page_size=8)
    req = Request(np.arange(10), max_new=12)
    with pytest.warns(UserWarning, match="truncate"):
        eng.serve([req])
    assert req.done and req.truncated and 0 < len(req.out) < 12
    assert eng.stats["requests_truncated"] == 1
    ok = Request(np.asarray([1, 2, 3]), max_new=4)
    eng.serve([ok])
    assert ok.done and not ok.truncated
    eng.check_page_invariants()


def test_truncation_reject_policy(params):
    eng = _paged(params, batch_slots=1, max_len=16, page_size=8, on_truncation="reject")
    with pytest.raises(ValueError, match="truncate"):
        eng.submit(Request(np.arange(10), max_new=12))
    assert not eng.queue and eng.slots == [None]


def test_first_tokens_match_jax_paged_engine(jparams, params):
    """The slice as a whole: the port's paged engine and the reference's,
    on bridged params, give the same first greedy tokens wherever the
    reference's top-2 logit margin exceeds the bf16 logits tolerance."""
    prompts = [[1, 2, 3], [7] * 5, [100, 3, 99, 4, 5, 6], list(range(50, 59)),
               list(range(10, 22)), [3, 1] * 8]
    jreqs = [JRequest(jnp.asarray(p, jnp.int32), max_new=2) for p in prompts]
    JEngine(JCFG, jparams, batch_slots=2, max_len=64, paged=True, page_size=8).serve(jreqs)
    treqs = [Request(np.asarray(p), max_new=2) for p in prompts]
    _paged(params, page_size=8).serve(treqs)

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
def test_paged_kernel_close_to_plain_version_on_card():
    """On the card: the kernel within atol 0.03 / rtol 0.05 of the plain
    version, the committed pools equal, the stacked rows equal to sequential
    launches (chip_smoke.py does the same at llama3-8b shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    q, kp, vp, kt, vt, bt, pos = (_t(a).to(dev) for a in _spec_batch(seed=17, hd=32))
    out_k, kk, vk = paged_decode_kernel(q, kp.clone(), vp.clone(), kt, vt, bt, pos)
    out_p, kq, vq = paged_decode_ref(q, kp, vp, kt, vt, bt, pos)
    torch.testing.assert_close(out_k.float(), out_p.float(), atol=0.03, rtol=0.05)
    assert torch.equal(kk, kq) and torch.equal(vk, vq)
    stacked = paged_decode_kernel(q, kp, vp, kt, vt, bt, pos, commit=False)
    ks, vs, outs = kp.clone(), vp.clone(), []
    for i in range(q.shape[1]):
        o, ks, vs = paged_decode_kernel(q[:, i:i + 1].contiguous(), ks, vs,
                                        kt[:, i:i + 1].contiguous(), vt[:, i:i + 1].contiguous(),
                                        bt, pos + i)
        outs.append(o)
    assert torch.equal(stacked, torch.cat(outs, dim=1))
