"""OLMoE served in W4A16 (weight-only int4 experts): the expert-stacked
weight-only packs, ``w4a16_gemm`` over an expert axis (its plain version and
dispatch on the CPU), the W4A16 OLMoE model against the JAX package, and the
engine's modes. A reduced OLMoE at d_model 256 (``_eligible`` packs K >= 256
only), params bridged from the reference. One test needs the card and skips
here.

Tolerances, and where bit-equality holds:
* packs (``quantize_params("w4a16")``, experts stacked) bit-equal to the
  reference's packer run op by op (``jax.disable_jit()``; its jitted packer
  turns the scale division into a reciprocal multiply, ROADMAP Queue 3);
* the stacked plain version ``torch.equal`` per expert to the 2-D plain
  version on that expert (the reference's vmap);
* W4A16 OLMoE logits (prefill with ``length``, two decode steps) within rel
  0.03 of the reference run op by op: every weight-only linear is within one
  bf16 ULP of the reference's (each group's dot has no fixed order in either
  framework; ``tests/test_torch_w4a16.py``), the bound of the dense W4A16
  model there;
* engine modes: greedy tokens exact against the bucketed run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.configs import QuantSpec as JQ
from repro.core import twinquant as JT
from repro.models import olmoe as JO
from repro_torch.configs import QuantSpec, get_config
from repro_torch.core.twinquant import _pack_one_w4a16, fuse_params, quantize_params
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as T
from repro_torch.kernels.contracts import ContractError, check_w4a16_pack, validate_w4a16
from repro_torch.kernels.cuda_launch import launch_counts, reset_launch_counts
from repro_torch.kernels.w4a16_gemm import w4a16_gemm
from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.models import common as C
from repro_torch.models import olmoe as TO

torch.set_num_threads(2)

CFG = get_config("olmoe-1b-7b", reduced=True).replace(
    name="olmoe-w4a16", d_model=256, d_ff_expert=256, n_heads=4, n_kv_heads=4, head_dim=64,
    vocab=260, n_experts=4, capacity_factor=4.0)
JCFG = JCfg(**{f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)
               if f.name not in ("quant", "remat")}, remat=False)
E, D, F = CFG.n_experts, CFG.d_model, CFG.d_ff_expert


@pytest.fixture(autouse=True)
def _clean():
    dispatch.reset_dispatch_counters()
    yield
    dispatch.reset_dispatch_counters()


@pytest.fixture(scope="module")
def jparams():
    return JO.init_params(JCFG, jax.random.PRNGKey(2))


@pytest.fixture(scope="module")
def jq16(jparams):
    with jax.disable_jit():  # the packer as written (module docstring)
        return JT.quantize_params(jparams, JCFG, JQ(mode="w4a16"))


def _bridge(p):
    return params_from_numpy(jax.tree.map(np.asarray, p), CFG, "cpu")


@pytest.fixture(scope="module")
def qp(jq16):
    return _bridge(jq16)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _stacked(seed, e=E, k=512, n=256, group=128):
    g = torch.Generator().manual_seed(seed)
    wq, ws = T.quantize_rows_ref(torch.randn(e, k, n, generator=g) * 0.1, group, 4)
    return T.pack_rows_groupsplit(wq, group), ws


# ---------------------------------------------------------------------------
# packs
# ---------------------------------------------------------------------------


def test_stacked_w4a16_packs_bit_equal_to_reference(jparams, qp):
    """The port's packer on the bridged bf16 model gives the reference's
    op-by-op packs bit for bit: every expert linear one stacked pack (E
    leading), attention 2-D, router and head untouched; ``fuse_params``
    fuses nothing."""
    qt = quantize_params(_bridge(jparams), CFG, QuantSpec("w4a16"))
    for lt, lb in zip(qt.layers, qp.layers):
        for name in ("gate", "up", "down"):
            got, want = lt.moe.experts[name], lb.moe.experts[name]
            assert isinstance(got, C.W4A16Linear) and got.group == 128
            k, n = (D, F) if name != "down" else (F, D)
            assert got.wp.shape == (E, k // 2, n) and got.ws.shape == (E, k // 128, n)
            assert torch.equal(got.wp, want.wp) and torch.equal(got.ws, want.ws), name
        for name, mod in lt.attn.items():
            assert mod.wp.ndim == 2
            assert torch.equal(mod.wp, lb.attn[name].wp) and torch.equal(mod.ws, lb.attn[name].ws)
        assert lt.moe.router.dtype == torch.float32
    assert isinstance(qt.head, C.Linear)
    ft = fuse_params(qt)
    assert set(ft.layers[0].moe.experts) == {"gate", "up", "down"}
    assert set(ft.layers[0].attn) == {"q", "k", "v", "o"}


def test_stacked_pack_slices_are_each_expert_packed_alone(jparams):
    model = _bridge(jparams)
    stacked = quantize_params(model, CFG, QuantSpec("w4a16")).layers[1].moe.experts["down"]
    for e in range(E):
        one = _pack_one_w4a16(C.Linear(model.layers[1].moe.experts["down"].w[e]),
                              QuantSpec("w4a16"))
        assert torch.equal(stacked.wp[e], one.wp) and torch.equal(stacked.ws[e], one.ws)


# ---------------------------------------------------------------------------
# the plain version, dispatch and contracts over an expert axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 8, 33])
def test_w4a16_gemm_ref_stacked_equals_per_expert(m):
    wp, ws = _stacked(m)
    x = torch.randn(E, m, 512, generator=torch.Generator().manual_seed(m)).bfloat16()
    y = T.w4a16_gemm_ref(x, wp, ws, 128)
    assert y.shape == (E, m, 256) and y.dtype == torch.bfloat16
    for e in range(E):
        assert torch.equal(y[e], T.w4a16_gemm_ref(x[e], wp[e], ws[e], 128))
    f32 = T.w4a16_gemm_f32(x, wp, ws, 128)
    assert f32.dtype == torch.float32 and torch.equal(f32.to(torch.bfloat16), y)
    # the wrapper on a CPU tensor: the plain version, no launch counted
    reset_launch_counts()
    assert torch.equal(w4a16_gemm(x, wp, ws), y)
    assert "w4a16_gemm" not in launch_counts()


def test_stacked_w4a16_linear_routes_once_on_cp():
    """One routed call for all experts, classified by Cp (an expert's rows),
    with (E, N) biases added per expert."""
    wp, ws = _stacked(5)
    x = torch.randn(E, 40, 512, generator=torch.Generator().manual_seed(5)).bfloat16()
    b = torch.randn(E, 256, generator=torch.Generator().manual_seed(6))
    y = dispatch.w4a16_linear(x, wp, ws, b)
    assert dispatch.dispatch_counters() == {"w4a16/prefill": 1}
    want = (T.w4a16_gemm_ref(x, wp, ws, 128).float() + b[:, None, :]).bfloat16()
    assert torch.equal(y, want)
    with pytest.raises(ContractError, match="expert-stacked"):
        dispatch.w4a16_linear(x[:2], wp, ws)
    with pytest.raises(ContractError, match=r"x must be \(E=4"):
        w4a16_gemm(x[0], wp, ws)


def test_stacked_w4a16_contracts():
    wp, ws = _stacked(7)
    check_w4a16_pack(wp, ws, 512, 128)
    with pytest.raises(ContractError, match="leading expert count"):
        check_w4a16_pack(wp, ws[:2], 512, 128)
    with pytest.raises(ContractError, match="leading expert count"):
        check_w4a16_pack(wp, ws[0], 512, 128)
    validate_w4a16(8, 1024, 2048, 128, 64, 64, 128, experts=64)
    with pytest.raises(ContractError, match="grid's z range"):
        validate_w4a16(8, 1024, 2048, 128, 64, 64, 128, experts=70000)
    # off the CPU a stacked call reaches the wrapper, which wants CUDA
    x = torch.empty(E, 8, 512, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ContractError, match="CUDA"):
        w4a16_gemm(x, wp.to("meta"), ws.to("meta"))


# ---------------------------------------------------------------------------
# the W4A16 OLMoE model against the reference
# ---------------------------------------------------------------------------


def test_w4a16_olmoe_prefill_and_decode_match_reference(jq16, qp):
    """A padded bucket (``length``) then two decode steps, against the
    reference run op by op; 7 weight-only routes a layer a model call (q, k,
    v, o and the experts' stacked gate, up, down)."""
    bucket, length = 32, 27
    toks = np.random.default_rng(3).integers(0, CFG.vocab, (1, bucket)).astype(np.int32)
    toks[0, length:] = 0
    sj = JO.init_decode_state(JCFG, 1, 48)
    st = TO.init_decode_state(CFG, 1, 48, device="cpu")
    with jax.disable_jit():
        lj, sj = JO.prefill(jq16, JCFG, jnp.asarray(toks), sj, length=jnp.asarray([length]))
        outs = [lj]
        for i in range(2):
            lj, sj = JO.decode_step(jq16, JCFG, sj, jnp.asarray([[11 + i]], jnp.int32))
            outs.append(lj)
    lt, st = TO.prefill(qp, CFG, torch.as_tensor(toks, dtype=torch.long), st,
                        length=torch.tensor([length]))
    got = [lt]
    assert dispatch.dispatch_counters() == {"w4a16/prefill": 7 * CFG.n_layers}
    for i in range(2):
        lt, st = TO.decode_step(qp, CFG, st, torch.tensor([[11 + i]]))
        got.append(lt)
    assert dispatch.dispatch_counters() == {"w4a16/prefill": 3 * 7 * CFG.n_layers}
    assert int(sj["pos"][0]) == int(st["pos"][0]) == length + 2
    for a, b in zip(outs, got):
        assert _np(a).shape == _np(b).shape
        assert _rel(_np(a), _np(b)) <= 0.03


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

MODES = {"bucketed": {}, "paged": dict(paged=True), "spec": dict(paged=True, speculation=True),
         "ragged": dict(paged=True, ragged=True, token_budget=32)}
PROMPTS = [np.random.default_rng(10 + i).integers(0, CFG.vocab, n).astype(np.int32)
           for i, n in enumerate((3, 9, 17, 30))]


def _serve(qp, mode):
    eng = ContinuousBatchingEngine(CFG, qp, batch_slots=2, max_len=64, device="cpu",
                                   **MODES[mode])
    reqs = [Request(p, max_new=5) for p in PROMPTS]
    dispatch.reset_dispatch_counters()
    eng.serve(reqs)
    assert all(r.status == "DONE" and len(r.out) == 5 for r in reqs)
    return eng, [r.out for r in reqs], dispatch.dispatch_counters()


@pytest.fixture(scope="module")
def bucketed(qp):
    return _serve(qp, "bucketed")


def test_w4a16_routes_seven_per_layer_per_model_call(bucketed):
    eng, _, routes = bucketed
    calls = eng.stats["decode_steps"] + eng.compile_stats()["prefill_calls"]
    assert routes == {"w4a16/prefill": 7 * CFG.n_layers * calls}


@pytest.mark.parametrize("mode", ["paged", "spec", "ragged"])
def test_modes_give_the_bucketed_greedy_tokens(qp, bucketed, mode):
    eng, outs, routes = _serve(qp, mode)
    assert outs == bucketed[1]
    assert routes.get("w4a16/prefill", 0) > 0
    assert all(k.startswith(("w4a16", "paged_decode", "ragged")) for k in routes)
    eng.check_page_invariants()


@pytest.mark.gpu
def test_stacked_w4a16_gemm_equals_one_expert_launches_on_card():
    """On the card: one stacked launch, each expert's slice ``torch.equal``
    to that expert launched alone, at a decode, a column-split and a tile
    schedule's Cp (``chip_smoke.py`` runs this at OLMoE's widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for cp, n in ((8, 256), (8, 8192), (40, 256)):
        wp, ws = (t.to(dev) for t in _stacked(cp, n=n))
        x = torch.randn(E, cp, 512, device=dev).bfloat16()
        y = w4a16_gemm(x, wp, ws)
        for e in range(E):
            assert torch.equal(y[e], w4a16_gemm(x[e], wp[e], ws[e]))
