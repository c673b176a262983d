"""The port's MoE layer (repro_torch.models.moe_layer), its expert-stacked
TwinQuant packs and the dual kernels' expert axis on the CPU, held to
repro.models.moe_layer and repro.core.twinquant.

Tolerances:
* routing: expert ids exact (a planted tie resolves to the lower index, as
  ``jax.lax.top_k``); weights and the aux loss within 1e-6 (XLA and
  PyTorch round ``exp`` in the softmax differently in the last bit);
* the dispatch indices (slot, token, order, keep) and the capacity exact;
* bf16 experts: rel <= 0.01 (bf16 matmul rounding at other places);
* W4A4 experts: ``moe_ffn`` bit-equal to the reference run op by op
  (``jax.disable_jit()``), combine order included; against the jitted
  reference rel <= 0.25 (XLA contracts the kernels' oracles into FMAs and
  keeps bf16 intermediates in f32, and 4-bit activations turn those last
  bits into quantization flips);
* stacked packs, stacked dispatch and the stacked plain version exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.configs import QuantSpec as JQ
from repro.core.twinquant import fuse_params as j_fuse
from repro.core.twinquant import quantize_params as j_quant
from repro.models import moe_layer as JM
from repro.models import olmoe as JO
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.twinquant import _pack_one, fuse_params, quantize_params
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import cuda_launch as CL
from repro_torch.kernels import dispatch
from repro_torch.kernels import ref as T
from repro_torch.kernels.contracts import ContractError
from repro_torch.models import common as C
from repro_torch.models import moe_layer as TM
from repro_torch.models import olmoe as TO

torch.set_num_threads(2)

# the reference's quantized MoE test config (tests/test_quant_integration.py)
QKW = dict(name="olmoe-q", family="moe", n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
           head_dim=64, d_ff=64, d_ff_expert=256, vocab=512, n_experts=4, top_k=2)
JQC, TQC = JCfg(**QKW, remat=False), ModelConfig(**QKW)
# the reference engine tests' tiny MoE (bf16 experts: d < 256 does not pack)
MKW = dict(name="tiny-moe", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           head_dim=16, vocab=256, n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=4.0)
JMC, TMC = JCfg(**MKW, remat=False), ModelConfig(**MKW)


def _f32(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y, jnp.float32))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _bf16(a):
    """The same bf16 values in both packages."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, to_torch(np.asarray(j), "cpu")


@pytest.fixture(scope="module")
def jq():
    p = JO.init_params(JQC, jax.random.PRNGKey(2))
    return jax.jit(lambda q: j_fuse(j_quant(q, JQC, JQ(mode="w4a4", rank=16))))(p)


@pytest.fixture(scope="module")
def tq(jq):
    return params_from_numpy(jax.tree.map(np.asarray, jq), TQC, "cpu")


@pytest.fixture(scope="module")
def jm():
    return JO.init_params(JMC, jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def tm(jm):
    return params_from_numpy(jax.tree.map(np.asarray, jm), TMC, "cpu")


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------


def _route_both(router, x, cfg_j, cfg_t):
    wj, ij, aj = JM.route(jnp.asarray(router), x[0], cfg_j)
    wt, it, at = TM.route(torch.from_numpy(router), x[1], cfg_t)
    return (np.asarray(wj), np.asarray(ij), float(aj)), (wt.numpy(), it.numpy(), float(at))


def test_route_matches_jax():
    rng = np.random.default_rng(0)
    cfg_j, cfg_t = JCfg(n_experts=64, top_k=8), ModelConfig(n_experts=64, top_k=8)
    router = (rng.standard_normal((128, 64)) / np.sqrt(128)).astype(np.float32)
    x = _bf16(rng.standard_normal((40, 128)))
    (wj, ij, aj), (wt, it, at) = _route_both(router, x, cfg_j, cfg_t)
    assert np.array_equal(ij, it)
    np.testing.assert_allclose(wt, wj, atol=1e-6, rtol=0)
    assert abs(at - aj) <= 1e-6 * abs(aj)
    assert it.dtype == np.int64 and wt.dtype == np.float32


def test_route_tie_resolves_to_lower_index():
    """Experts 5 and 2 share a router column, so every token ties them
    behind expert 7 (positive inputs: 7 > 2 = 5 > the rest). The lower
    index comes first, as jax.lax.top_k orders ties."""
    rng = np.random.default_rng(1)
    router = -np.abs(rng.standard_normal((32, 8))).astype(np.float32)
    router[:, 2] = 0.1 * np.abs(router[:, 2])
    router[:, 5] = router[:, 2]
    router[:, 7] = 1.0
    x = _bf16(np.abs(rng.standard_normal((12, 32))))
    cfg_j, cfg_t = JCfg(n_experts=8, top_k=3), ModelConfig(n_experts=8, top_k=3)
    (wj, ij, _), (wt, it, _) = _route_both(router, x, cfg_j, cfg_t)
    assert np.array_equal(ij, it)
    assert (it[:, 0] == 7).all() and (it[:, 1] == 2).all() and (it[:, 2] == 5).all(), it
    np.testing.assert_allclose(wt, wj, atol=1e-6, rtol=0)


@pytest.mark.parametrize("cap", [16, 8, 4], ids=["roomy", "exact", "overflow"])
def test_dispatch_indices_match_jax(cap):
    rng = np.random.default_rng(cap)
    E, k, t = 8, 2, 24
    top_i = np.stack([rng.choice(E, k, replace=False) for _ in range(t)]).astype(np.int32)
    top_i[:6] = [3, 5]  # expert 3 and 5 crowded
    got = TM._dispatch_indices(torch.from_numpy(top_i), k, E, cap)
    want = JM._dispatch_indices(jnp.asarray(top_i), k, E, cap)
    for g, w, name in zip(got, want, ("slot", "tok", "order", "keep")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    if cap == 4:
        assert not got[3].all() and (got[0][~got[3]] == E * cap).all()


def test_capacity_matches_jax():
    for t in (1, 7, 8, 16, 40, 100, 256, 1024, 2048):
        for e, k, cf in ((64, 8, 1.25), (64, 8, 8.0), (4, 2, 4.0), (8, 2, 1.0)):
            cj, ct = JCfg(n_experts=e, top_k=k, capacity_factor=cf), ModelConfig(
                n_experts=e, top_k=k, capacity_factor=cf)
            assert TM._capacity(t, ct) == JM._capacity(t, cj), (t, e, k, cf)
    assert TM._capacity(8, ModelConfig(n_experts=64, top_k=8, capacity_factor=8.0)) == 8


# ---------------------------------------------------------------------------
# the layer: bf16 and W4A4 experts
# ---------------------------------------------------------------------------


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree["layers"]["moe"])


def test_moe_ffn_bf16_matches_jax(jm, tm):
    x = _bf16(np.random.default_rng(3).standard_normal((2, 12, MKW["d_model"])))
    yt, at = TM.moe_ffn(tm.layers[1].moe, x[1], TMC)
    with jax.disable_jit():
        yj, aj = JM.moe_ffn(_layer(jm, 1), x[0], JMC)
    yjj, _ = jax.jit(lambda p, v: JM.moe_ffn(p, v, JMC))(_layer(jm, 1), x[0])
    assert yt.shape == (2, 12, MKW["d_model"]) and yt.dtype == torch.bfloat16
    assert _rel(_f32(yj), _f32(yt)) <= 0.01 and _rel(_f32(yjj), _f32(yt)) <= 0.01
    assert abs(float(at) - float(aj)) <= 1e-5


def _combined_desc(p, x, cfg):
    """The layer's output with each token's contributions added in
    descending expert order: another sound bf16 sum."""
    t, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cp = TM._capacity(t, cfg)
    top_w, top_i, _ = TM.route(p.router, x, cfg)
    slot, tok_s, order, keep = TM._dispatch_indices(top_i, k, E, cp)
    buf = torch.zeros((E * cp + 1, d), dtype=x.dtype)
    buf[slot] = x[tok_s]
    yb = C.mlp_apply(p.experts, buf[:E * cp].reshape(E, cp, d)).reshape(E * cp, d)
    yb = torch.cat([yb, torch.zeros((1, d), dtype=x.dtype)])
    contrib = yb[slot] * (top_w.reshape(-1)[order].to(x.dtype) * keep.to(x.dtype))[:, None]
    out = torch.zeros((t, d), dtype=x.dtype)
    for j in reversed(range(contrib.shape[0])):
        out = out.index_add(0, tok_s[j:j + 1], contrib[j:j + 1])
    return out


@pytest.mark.parametrize("top_k", [2, 3, 4])
def test_quantized_moe_ffn_bit_equal_to_jax_op_by_op(jq, tq, top_k):
    """W4A4 experts (stacked, gate/up fused) bit for bit against the
    reference run op by op, whose scatter-add sums each token's k
    contributions in ascending expert order from zero. From k = 3 the order
    shows in the bits: a descending sum gives others on this input."""
    assert "gate_up" in tq.layers[0].moe.experts
    jc, tc = dataclasses.replace(JQC, top_k=top_k), TQC.replace(top_k=top_k)
    x = _bf16(np.random.default_rng(0).standard_normal((2, 16, QKW["d_model"])))
    for i in range(QKW["n_layers"]):
        p = tq.layers[i].moe
        yt, at = TM.moe_ffn(p, x[1], tc)
        with jax.disable_jit():
            yj, aj = JM.moe_ffn(_layer(jq, i), x[0], jc)
        assert torch.equal(yt, to_torch(np.asarray(yj), "cpu")), i
        assert abs(float(at) - float(aj)) <= 1e-6
        yjj, _ = jax.jit(lambda q, v: JM.moe_ffn(q, v, jc))(_layer(jq, i), x[0])
        assert _rel(_f32(yjj), _f32(yt)) <= 0.25
    desc = _combined_desc(tq.layers[0].moe, x[1].reshape(-1, QKW["d_model"]), tc)
    asc, _ = TM.moe_ffn(tq.layers[0].moe, x[1], tc)
    assert torch.equal(desc, asc.reshape(desc.shape)) == (top_k == 2)


def test_moe_ffn_shared_expert_branch():
    """``n_shared_experts`` adds the shared MLP over every token."""
    cfg = TMC.replace(n_shared_experts=1)
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(1, 6, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(C.DTYPE)
    y, _ = TM.moe_ffn(p, x, cfg)
    routed, _ = TM._moe_local(p, x.reshape(6, -1), cfg)
    assert torch.equal(y.reshape(6, -1), routed + C.mlp_apply(p.shared, x.reshape(6, -1)))
    assert p.shared["gate"].w.shape == (cfg.d_model, cfg.d_ff_expert)


def test_record_drops_counts_assignments_past_capacity():
    """``record_drops`` logs each MoE call's (T, capacity, dropped), dropped
    being the assignments ``_dispatch_indices`` does not keep; None stops
    the log."""
    cfg = TMC.replace(capacity_factor=0.5)  # capacity 8 for 24 tokens x 2 over 4 experts
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(C.DTYPE)
    log = []
    TM.record_drops(log)
    try:
        TM.moe_ffn(p, x, cfg)
    finally:
        TM.record_drops(None)
    TM.moe_ffn(p, x, cfg)
    cp = TM._capacity(24, cfg)
    _, top_i, _ = TM.route(p.router, x.reshape(24, -1), cfg)
    keep = TM._dispatch_indices(top_i, cfg.top_k, cfg.n_experts, cp)[3]
    assert len(log) == 1 and log[0][:2] == (24, cp) == (24, 8)
    assert int(log[0][2]) == int((~keep).sum()) >= 48 - 4 * 8


def test_per_draft_row_routing_equals_flat_on_cpu(tq):
    """A speculative stack's router logits one draft column at a time give
    the flat call's result here (the CPU matmul's rows do not depend on
    the row count); on the card they keep a plain decode step's bits."""
    x = _bf16(np.random.default_rng(5).standard_normal((3, 4, QKW["d_model"])))[1]
    p = tq.layers[0].moe
    assert torch.equal(TM.moe_ffn(p, x, TQC, per_draft_row=True)[0], TM.moe_ffn(p, x, TQC)[0])


# ---------------------------------------------------------------------------
# expert-stacked packs, dispatch and the launch arguments
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def packed():
    model = TO.init_params(TQC, seed=0, device="cpu")
    return model, quantize_params(model, TQC, QuantSpec("w4a4", rank=16))


def test_quantize_params_packs_experts_stacked(packed):
    """One pack per expert linear with E leading, as the reference's vmap
    over stacked dims; expert e's pack equals expert e's weight packed
    alone; ``fuse_params`` fuses the experts' gate/up into one stacked
    group; the router stays f32."""
    model, qp = packed
    ex = qp.layers[0].moe.experts
    E, d, f = QKW["n_experts"], QKW["d_model"], QKW["d_ff_expert"]
    assert ex["gate"].rp.shape == (E, d // 2, f) and ex["down"].rp.shape == (E, f // 2, d)
    assert ex["gate"].up.shape == (E, d // 2, 16) and ex["gate"].weights().experts == E
    for e in range(E):
        w = model.layers[0].moe.experts["gate"].w[e]
        one = _pack_one(C.Linear(w), QuantSpec("w4a4", rank=16)).weights()
        got = ex["gate"].weights().expert(e)
        for name in ("up", "us", "vp", "vs", "rp", "rs"):
            assert torch.equal(getattr(got, name), getattr(one, name)), (e, name)
    fused = fuse_params(qp).layers[0].moe.experts
    assert set(fused) == {"gate_up", "down"}
    gw = fused["gate_up"].weights()
    assert gw.experts == E and gw.seg_n == (f, f) and gw.rp.shape == (E, d // 2, 2 * f)
    assert qp.layers[0].moe.router.dtype == torch.float32


def test_w4a16_expert_packs_are_not_ported_yet(packed):
    with pytest.raises(NotImplementedError, match="expert axis"):
        quantize_params(packed[0], TQC, QuantSpec("w4a16"))


def _stacked_pack(e, k, n, r, seed):
    g = torch.Generator().manual_seed(seed)
    return T.pack_twinquant_weights(torch.randn(e, k, r, generator=g) * 0.1,
                                    torch.randn(e, r, n, generator=g) * 0.1,
                                    torch.randn(e, k, n, generator=g) * 0.05, a_bits=4,
                                    group=128)


@pytest.mark.parametrize("m", [1, 8, 9, 40])
def test_stacked_dispatch_equals_per_expert_calls(m):
    """One stacked call (routed by M, the rows an expert gets; one route
    recorded) equals each expert's own call; a fused stacked group's
    segments equal the stacked single packs; the stacked plain version is
    the per-expert loop."""
    E, k = 3, 256
    w = _stacked_pack(E, k, 128, 32, seed=m)
    sib = [_stacked_pack(E, k, n, 32, seed=m + 10 * n) for n in (256, 128)]
    gw = T.fuse_twinquant_weights(sib)
    x = (torch.randn(E, m, k, generator=torch.Generator().manual_seed(m)) * 2).to(C.DTYPE)
    dispatch.reset_dispatch_counters()
    y = dispatch.quant_linear(x, w)
    ys = dispatch.fused_linear(x, gw)
    path = "decode" if m <= dispatch.DECODE_M_MAX else "prefill"
    assert dispatch.dispatch_counters() == {f"dual/{path}": 1, f"dual_fused/{path}": 1}
    assert y.shape == (E, m, 128) and [t.shape for t in ys] == [(E, m, 256), (E, m, 128)]
    for e in range(E):
        assert torch.equal(y[e], dispatch.quant_linear(x[e], w.expert(e)))
        assert torch.equal(y[e], T.dual_gemm_ref(x[e], w.expert(e)))
        for j in range(2):
            assert torch.equal(ys[j][e], T.dual_gemm_ref(x[e], sib[j].expert(e)))
    assert torch.equal(T.dual_gemm_ref(x, w), y)
    dispatch.reset_dispatch_counters()


def test_stacked_pack_contracts():
    w = _stacked_pack(3, 256, 128, 32, seed=0)
    x = torch.zeros(3, 4, 256, dtype=C.DTYPE)
    with pytest.raises(ContractError, match="expert-stacked"):
        dispatch.quant_linear(x[:2], w)  # two experts' rows for three
    with pytest.raises(ContractError, match="expert-stacked"):
        dispatch.quant_linear(x.reshape(12, 256), w)
    bad = dataclasses.replace(w, rs=w.rs[:2])
    with pytest.raises(ContractError, match="E=3 leading"):
        dispatch.quant_linear(x, bad)
    with pytest.raises(ValueError, match="experts"):
        T.fuse_twinquant_weights([w, _stacked_pack(2, 256, 128, 32, seed=1)])


def test_expert_strides_and_scratch_of_a_stacked_pack():
    """The C entry's per-expert strides: each pack tensor's stride(0), each
    expert's scratch and rows one after another; the scratch holds all E
    experts' buffers without overlap."""
    E, k, m = 4, 256, 8
    sib = [_stacked_pack(E, k, n, 16, seed=n) for n in (96, 64)]
    gw = T.fuse_twinquant_weights(sib)
    pa = CL.pack_args(gw, "dual_gemv_group")
    assert pa.experts == E
    planes = k // 128
    s = list(CL.expert_strides(m, k, pa, planes))
    assert s[:5] == [m * k, gw.up.stride(0), gw.us.stride(0), gw.rp.stride(0), gw.rs.stride(0)]
    per = [m * k, m * (k // 128), planes * m * 32, m * 32, m * pa.hs_cols]
    assert s[5:10] == per and s[10] == m * 160
    assert s[11:13] == [t.stride(0) for t in gw.vps] and s[13:15] == [0, 0]
    assert s[15:17] == [t.stride(0) for t in gw.vss] and s[17:] == [0, 0]
    total, offs = CL.scratch_layout(m, k, pa, planes)
    sizes = [E * n * b for n, b in zip(per, (1, 4, 4, 1, 4))]
    assert all(o2 - o1 >= sz for o1, o2, sz in zip(offs, offs[1:] + [total], sizes))
    single = CL.pack_args(gw.expert(0), "dual_gemv_group")
    assert single.experts == 1 and list(CL.expert_strides(m, k, single, planes)) == [0] * 19


def test_stacked_launch_needs_the_card():
    w = _stacked_pack(2, 256, 128, 32, seed=0)
    with pytest.raises(ContractError, match="CUDA tensor"):
        CL.launch_dual("dual_gemv", "twinquant_dual_gemv", "tq_dual_gemv",
                       torch.zeros(2, 4, 256, dtype=C.DTYPE), w)
    with pytest.raises(ContractError, match="experts"):
        CL.launch_dual("dual_gemv", "twinquant_dual_gemv", "tq_dual_gemv",
                       torch.zeros(3, 4, 256, dtype=C.DTYPE), w)
