"""The port's packers on the DeepSeek-V3 family, held to the JAX
package's at the reduced config (d_model 256, so ``_eligible`` packs): the
bridged tree (expert packs stacked), W4A4 and W4A16 packs, the reference's
own W4A4 packs through the port's MLA layer, and chunked expert packing.

Tolerances: W4A16 packs bit-equal to the reference's packer run op by op
(``jax.disable_jit()``); W4A4 packs judged, as ``tests/test_torch_dense.py``
does, by each linear's dequantized error within 0.01 of the reference
packer's (SVD signs are free); the reference's W4A4 packs through the
port's MLA layer bit-equal to it op by op; chunked packing bit-equal to
one-shot packing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_deepseek import CFG, JRED, RED, _j, _ops, _reference_tree, _t

from repro.configs import QuantSpec as JQ
from repro.core import twinquant as JT
from repro_torch.configs import QuantSpec
from repro_torch.core import twinquant as TT
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ref as R
from repro_torch.models import common as C
from repro_torch.models import deepseek as TDS

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return TDS.init_params(CFG, seed=1, device="cpu")


@pytest.fixture(scope="module")
def red():
    return TDS.init_params(RED, seed=2, device="cpu")


@pytest.fixture(scope="module")
def jq4(red):
    """The reference's W4A4 packs of the reduced model (one jitted graph:
    far quicker to build than the op-by-op vmapped SVDs)."""
    jred = _reference_tree(red)
    return jax.jit(lambda p: JT.quantize_params(p, JRED, JQ("w4a4", rank=32)))(jred)


@pytest.fixture(scope="module")
def q4(red):
    """The port's W4A4 packs of the reduced model, shared by the packer
    tests."""
    return TT.quantize_params(red, RED, QuantSpec("w4a4", rank=32))


# ---------------------------------------------------------------------------
# the bridged tree
# ---------------------------------------------------------------------------


def test_bridged_params_keep_expert_packs_stacked(params, jq4):
    """bf16: the reference's tree bridges back to the same model bit for
    bit, experts (E, K, N) stacked, ``mtp`` included; the reference's fused
    W4A4 packs: experts one stacked group (E leading), ``wqkv_a`` one
    group, ``wkv_b`` and ``mtp/proj`` bf16."""
    jparams = _reference_tree(params)
    back = params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")
    mine, theirs = dict(params.named_buffers()), dict(back.named_buffers())
    assert mine.keys() == theirs.keys()
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)
    lp = back.layers[1]
    assert lp.moe.experts["gate"].w.shape == (4, 64, 64) and lp.moe.router.dtype == torch.float32
    assert params.mtp.proj.w.shape == (128, 64) and params.mtp.ln_in.shape == (128,)
    assert params.mtp.layer.mlp["gate"].w.shape == (64, 4 * 64)
    assert torch.equal(params.mtp.proj.w, _t(jparams["mtp"]["proj"]["w"]))
    qp = params_from_numpy(jax.tree.map(np.asarray, JT.fuse_params(jq4)), RED, "cpu")
    ex = qp.layers[1].moe.experts
    assert set(ex) == {"gate_up", "down"} and isinstance(ex["gate_up"], C.TwinQuantLinearGroup)
    gw = ex["gate_up"].weights()
    assert gw.experts == 8 and gw.seg_n == (128, 128) and gw.rp.shape == (8, 128, 256)
    assert isinstance(ex["down"], C.ExpertLinear)  # K = 128: not eligible, bf16
    at = qp.layers[0].attn
    assert isinstance(at["wqkv_a"], C.TwinQuantLinearGroup)
    assert at["wqkv_a"].weights().seg_n == (64, 48)
    assert isinstance(at["wkv_b"], C.Linear) and isinstance(qp.mtp.proj, C.Linear)
    assert isinstance(qp.mtp.layer.mlp["gate_up"], C.TwinQuantLinearGroup)


# ---------------------------------------------------------------------------
# the packers at the reduced config
# ---------------------------------------------------------------------------


def _dequant(w: R.TwinQuantWeights) -> torch.Tensor:
    def dq(p, s, g):
        return R.unpack_rows_groupsplit(p, g).float() * s.repeat_interleave(g, dim=-2)

    return dq(w.up, w.us, w.group) @ dq(w.vp, w.vs, w.rgroup) + dq(w.rp, w.rs, w.group)


def _linears(model):
    """(path, module) of every linear of the port's model."""
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (C.Linear, C.ExpertLinear, C.TwinQuantLinear, C.W4A16Linear))]


def test_w4a4_packs_match_reference(red, jq4, q4):
    """The port's packer on the bridged bf16 reduced model packs the linears
    the reference packs (``wkv_b``, ``mtp/proj``, routers, embeddings, head
    and K < 256 stay bf16), each within 0.01 of the reference packer's
    dequantized error; ``fuse_params`` fuses ``wqkv_a`` (segments q_lora
    and kv_lora + rope) and every ``gate_up``."""
    want = params_from_numpy(jax.tree.map(np.asarray, jq4), RED, "cpu")
    pt, qt = red, q4
    got, ref = dict(_linears(qt)), dict(_linears(want))
    assert got.keys() == ref.keys()
    packed = [n for n, m in got.items() if isinstance(m, C.TwinQuantLinear)]
    assert sorted(packed) == sorted(n for n, m in ref.items() if isinstance(m, C.TwinQuantLinear))
    assert "layers.0.attn.wq_a" in packed and "mtp.layer.attn.wkv_a" in packed
    assert "layers.1.moe.experts.gate" in packed and "layers.1.moe.shared.up" in packed
    for name in ("layers.0.attn.wkv_b", "mtp.proj", "layers.0.attn.wq_b", "head"):
        assert isinstance(got[name], C.Linear), name
    base = dict(_linears(pt))
    for name in packed:
        w = base[name].w.float()
        e_t = float(torch.linalg.norm(_dequant(got[name].weights()) - w) / torch.linalg.norm(w))
        e_j = float(torch.linalg.norm(_dequant(ref[name].weights()) - w) / torch.linalg.norm(w))
        assert got[name].rp.shape == ref[name].rp.shape, name
        assert e_t < 0.2 and abs(e_t - e_j) <= 0.01, (name, e_t, e_j)
    ft = TT.fuse_params(qt)
    assert set(ft.layers[0].attn) == {"wqkv_a", "wq_b", "wkv_b", "o"}
    assert ft.layers[0].attn["wqkv_a"].weights().seg_n == (64, 48)
    assert set(ft.layers[1].moe.experts) == {"gate_up", "down"}
    assert set(ft.layers[1].moe.shared) == {"gate_up", "down"}
    assert isinstance(pt.layers[0].attn["wq_a"], C.Linear)  # the input is left untouched


def test_w4a16_packs_bit_equal_to_reference(red, q4):
    """Weight-only packs of every linear the W4A4 packer packs (the same
    ``_eligible``), experts stacked; ``wkv_b`` and ``mtp/proj`` bf16;
    ``fuse_params`` fuses nothing. Bit for bit against the reference's
    packer run op by op on one 2-D linear and one expert of a stack (a
    stacked pack's expert slice is that expert packed alone:
    ``tests/test_torch_moe_w4a16.py``)."""
    qt = TT.quantize_params(red, RED, QuantSpec("w4a16"))
    got = dict(_linears(qt))
    assert [n for n, m in got.items() if isinstance(m, C.W4A16Linear)] == [
        n for n, m in _linears(q4) if isinstance(m, C.TwinQuantLinear)]
    assert got["layers.2.moe.experts.up"].wp.shape == (8, 128, 128)
    assert isinstance(got["layers.1.attn.wkv_b"], C.Linear)
    assert isinstance(got["mtp.proj"], C.Linear)
    base = dict(_linears(red))
    for name, e in (("layers.0.attn.wkv_a", None), ("layers.2.moe.experts.gate", 5)):
        w, m = base[name].w, got[name]
        wp, ws = (m.wp, m.ws) if e is None else (m.wp[e], m.ws[e])
        want = _ops(JT._pack_one_w4a16, _j(w if e is None else w[e]), JQ("w4a16"))
        assert torch.equal(wp, _t(want["wp"])) and torch.equal(ws, _t(want["ws"])), name
    assert set(TT.fuse_params(qt).layers[0].attn) == {"wq_a", "wkv_a", "wq_b", "wkv_b", "o"}


def test_reference_w4a4_mla_layer_bit_equal(jq4):
    """The reference's fused W4A4 ``wqkv_a`` group (``wkv_b`` bf16, and
    ``wq_b`` and ``o`` at K = 64 and 128) through the port's MLA: the
    prefill layer over a cached prefix and one absorbed decode step
    bit-equal to the reference run op by op, the latent lines too."""
    from repro.models import mla as JM
    from repro_torch.models import mla as TM

    jf = JT.fuse_params(jq4)
    ja = jax.tree.map(lambda a: a[0], jf["moe_layers"]["attn"])
    at = params_from_numpy(jax.tree.map(np.asarray, jf), RED, "cpu").layers[1].attn
    assert isinstance(at["wqkv_a"], C.TwinQuantLinearGroup) and isinstance(at["o"], C.Linear)
    x = jnp.asarray(np.random.default_rng(3).standard_normal((1, 17, 256)), jnp.bfloat16)
    _, cj, kj = _ops(JM.mla_prefill_layer, ja, x[:, :8], JRED)
    _, ct, kt = TM.mla_prefill_layer(at, _t(x)[:, :8], RED)
    assert torch.equal(ct, _t(cj)) and torch.equal(kt, _t(kj))
    oj, _, _ = _ops(JM.mla_prefill_layer, ja, x[:, 8:16], JRED, prefix=(cj, kj))
    ot, _, _ = TM.mla_prefill_layer(at, _t(x)[:, 8:16], RED, prefix=(ct, kt))
    assert torch.equal(ot, _t(oj))
    cache_j = jnp.zeros((1, 24, RED.kv_lora_rank), jnp.bfloat16).at[:, :8].set(cj)
    kr_j = jnp.zeros((1, 24, RED.qk_rope_dim), jnp.bfloat16).at[:, :8].set(kj)
    oj, _, _ = _ops(JM.mla_decode, ja, x[:, 16:], JRED, cache_j, kr_j, jnp.asarray([8]))
    ot, _, _ = TM.mla_decode(at, _t(x)[:, 16:], RED, _t(cache_j), _t(kr_j), torch.tensor([8]))
    assert torch.equal(ot, _t(oj))


@pytest.mark.parametrize("mode", ["w4a4", "w4a16"])
def test_chunked_expert_packing_equals_one_shot(mode, monkeypatch):
    """An expert stack packed 3 experts at a time (the last chunk short;
    ``EXPERT_CHUNK_BYTES`` cut to 3 experts' f32) is the one-shot pack bit
    for bit."""
    g = torch.Generator().manual_seed(4)
    lin = C.ExpertLinear((torch.randn(8, 256, 128, generator=g) / 16).to(torch.bfloat16))
    spec = QuantSpec(mode, rank=32)
    pack = TT._pack_one_w4a16 if mode == "w4a16" else TT._pack_one
    one = pack(lin, spec)
    monkeypatch.setattr(TT, "EXPERT_CHUNK_BYTES", 3 * 256 * 128 * 4)
    chunked = pack(lin, spec)
    names = ("wp", "ws") if mode == "w4a16" else ("up", "us", "vp", "vs", "rp", "rs")
    for name in names:
        a, b = getattr(one, name), getattr(chunked, name)
        assert a.shape[0] == 8 and torch.equal(a, b), name
