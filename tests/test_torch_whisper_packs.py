"""The ``encdec`` family's quantized path (``whisper-base``) on the port,
held to the JAX package: W4A4 and W4A16 packs, ``fuse_params`` leaving
``xattn`` unfused, and both packs served (prefill, a decode step) at a
d_model-256 variant of the reduced config, so ``_eligible`` packs every
linear (K >= 256).

Tolerances:
- W4A16 packs bit-equal to the reference's packer run op by op
  (``jax.disable_jit()``); W4A4 packs bit-equal given the same SVD
  factors, and by dequantized error within 0.01 of the reference packer's
  (SVD signs are free).
- W4A4: one decode step from the reference's prefill state bit-equal to
  the reference run op by op once the self-attention is the reference's
  write-then-attend (``torch_oracles``); the port's own step within rel
  0.25 of it.
- W4A16 prefill and decode logits within rel 0.02 of the jitted
  reference (bf16 rounding in other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import QuantSpec as JQ
from repro.configs import get_config as j_get_config
from repro.core import twinquant as JT
from repro.kernels import ref as JKR
from repro.models import encdec as JE
from repro_torch.configs import QuantSpec, get_config
from repro_torch.core import twinquant as TT
from repro_torch.core.decomposition import svd_decompose
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import ref as TKR
from repro_torch.models import common as C
from repro_torch.models import encdec as TE
from torch_oracles import write_then_attend

torch.set_num_threads(2)

QCFG = get_config("whisper-base", reduced=True).replace(
    d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=256)
JQCFG = j_get_config("whisper-base", reduced=True).replace(
    remat=False, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64, d_ff=256)
REL = 0.02


def _f32(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y, jnp.float32))


def _rel(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _toks(b, s, seed):
    return np.random.default_rng(seed).integers(0, QCFG.vocab, (b, s)).astype(np.int32)


def _frames(seed, b):
    return jax.random.normal(jax.random.PRNGKey(seed), (b, QCFG.n_frames, QCFG.d_model),
                             jnp.bfloat16)


def _long(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long)



@pytest.fixture(scope="module")
def qparams():
    jp = JE.init_params(JQCFG, jax.random.PRNGKey(7))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), QCFG, "cpu")


@pytest.fixture(scope="module")
def jq4(qparams):
    """The reference's W4A4 packs of the quantized config (one jitted
    graph, shared by the W4A4 tests)."""
    return jax.jit(lambda p: JT.quantize_params(p, JQCFG, JQ("w4a4", rank=32)))(qparams[0])


def _linears(model) -> dict:
    return {n: m for n, m in model.named_modules()
            if isinstance(m, (C.Linear, C.TwinQuantLinear, C.TwinQuantLinearGroup,
                              C.W4A16Linear))}


def test_w4a16_packs_bit_equal_to_reference(qparams):
    """Every linear but the tied embedding packs (biases kept); one encoder
    and one decoder linear of each kind bit for bit against the reference's
    packer run op by op."""
    _, pt = qparams
    qt = TT.quantize_params(pt, QCFG, QuantSpec("w4a16"))
    got, base = _linears(qt), _linears(pt)
    assert all(isinstance(m, C.W4A16Linear) for m in got.values()) and len(got) == 32
    assert torch.equal(got["dec_layers.1.mlp.up"].b, base["dec_layers.1.mlp.up"].b)
    for name in ("enc_layers.0.attn.q", "enc_layers.1.mlp.down", "dec_layers.0.xattn.k",
                 "dec_layers.1.mlp.up"):
        with jax.disable_jit():
            want = JT._pack_one_w4a16(jnp.asarray(base[name].w.float().numpy()), JQ("w4a16"))
        assert torch.equal(got[name].wp, _t(want["wp"])), name
        assert torch.equal(got[name].ws, _t(want["ws"])), name
    ft = TT.fuse_params(qt)
    assert set(ft.dec_layers[0].attn) == {"q", "k", "v", "o"}  # W4A16 never fuses


def _dequant(w) -> torch.Tensor:
    def dq(p, s, g):
        return TKR.unpack_rows_groupsplit(p, g).float() * s.repeat_interleave(g, dim=-2)

    return dq(w.up, w.us, w.group) @ dq(w.vp, w.vs, w.rgroup) + dq(w.rp, w.rs, w.group)


def test_w4a4_packs_match_reference(qparams, jq4):
    """The port's W4A4 packer packs the linears the reference packs, each
    within 0.01 of the reference packer's dequantized error; given the same
    SVD factors its pack bytes equal the reference's ``pack_twinquant_
    weights`` run op by op."""
    _, pt = qparams
    want = _linears(params_from_numpy(jax.tree.map(np.asarray, jq4), QCFG, "cpu"))
    qt = TT.quantize_params(pt, QCFG, QuantSpec("w4a4", rank=32))
    got, base = _linears(qt), _linears(pt)
    assert got.keys() == want.keys() and len(got) == 32
    for name, m in got.items():
        assert isinstance(m, C.TwinQuantLinear) and isinstance(want[name], C.TwinQuantLinear)
        w = base[name].w.float()
        e_t = float(torch.linalg.norm(_dequant(m.weights()) - w) / torch.linalg.norm(w))
        e_j = float(torch.linalg.norm(_dequant(want[name].weights()) - w) / torch.linalg.norm(w))
        assert e_t < 0.2 and abs(e_t - e_j) <= 0.01, (name, e_t, e_j)
    assert torch.equal(got["enc_layers.0.mlp.up"].b, base["enc_layers.0.mlp.up"].b)
    w = base["dec_layers.0.xattn.v"].w.float()
    U, V, R = svd_decompose(w, 32)
    mine = TKR.pack_twinquant_weights(U, V, R, a_bits=4, group=128)
    with jax.disable_jit():
        theirs = JKR.pack_twinquant_weights(*(jnp.asarray(t.numpy()) for t in (U, V, R)),
                                            a_bits=4, group=128)
    for f in ("up", "us", "vp", "vs", "rp", "rs"):
        assert torch.equal(getattr(mine, f), _t(getattr(theirs, f))), f


def test_fuse_params_leaves_xattn_unfused(qparams, jq4):
    """Only ``attn`` fuses q/k/v: ``xattn`` stays q, k, v, o (the
    reference's ``test_fuse_params_excludes_encdec_cross_attention``); the
    MLP's up/down have no sibling to fuse; the reference's fused tree
    bridges to the same layout."""
    _, pt = qparams
    ft = TT.fuse_params(TT.quantize_params(pt, QCFG, QuantSpec("w4a4", rank=32)))
    for lp in ft.dec_layers:
        assert set(lp.attn) == {"qkv", "o"} and set(lp.xattn) == {"q", "k", "v", "o"}
        assert set(lp.mlp) == {"up", "down"}
    assert set(ft.enc_layers[0].attn) == {"qkv", "o"}
    jf = JT.fuse_params(jq4)
    assert set(jf["dec_layers"]["xattn"]) == {"q", "k", "v", "o"}
    bt = params_from_numpy(jax.tree.map(np.asarray, jf), QCFG, "cpu")
    assert isinstance(bt.dec_layers[1].attn["qkv"], C.TwinQuantLinearGroup)
    assert isinstance(bt.dec_layers[1].xattn["k"], C.TwinQuantLinear)


def test_w4a4_serving_path_bit_equal_to_reference_op_by_op(jq4, monkeypatch):
    """The reference's fused W4A4 packs through the port: one decode step
    from the reference's prefill state bit-equal to the reference run op by
    op once the self-attention is the
    reference's write-then-attend. The port's own read-only-cache step
    (its softmax sums the cached keys and this step's apart) moves the
    attention output by bf16 rounding, which W4A4's 4-bit activations carry
    to the logits: held at rel < 0.25 (reading 0.12; ROADMAP Queue 3). """
    jf = JT.fuse_params(jq4)
    bt = params_from_numpy(jax.tree.map(np.asarray, jf), QCFG, "cpu")
    toks, fr = _toks(2, 6, 8), _frames(9, 2)
    tok = np.array([[1], [2]], np.int32)
    lj, sj = JE.prefill(jf, JQCFG, jnp.asarray(toks), JE.init_decode_state(JQCFG, 2, 16),
                        frames=fr)
    with jax.disable_jit():
        dj, _ = JE.decode_step(jf, JQCFG, sj, jnp.asarray(tok))
    own, _ = TE.decode_step(bt, QCFG, {k: _t(v) for k, v in sj.items()}, _long(tok))
    assert 0 < _rel(dj, own) < 0.25
    monkeypatch.setattr(C, "attention_decode_ro", write_then_attend)
    dt, _ = TE.decode_step(bt, QCFG, {k: _t(v) for k, v in sj.items()}, _long(tok))
    assert torch.equal(dt, _t(dj))


def test_w4a16_serving_path_matches_reference(qparams):
    """The reference's W4A16 packs through the port: prefill and a decode
    step within rel 0.02 of the jitted reference (the port's plain
    weight-only GEMM takes each group's dot in f64 so its rows do not depend
    on M)."""
    jp, _ = qparams
    jq = jax.jit(lambda p: JT.quantize_params(p, JQCFG, JQ("w4a16")))(jp)
    bt = params_from_numpy(jax.tree.map(np.asarray, jq), QCFG, "cpu")
    assert isinstance(bt.dec_layers[0].xattn["k"], C.W4A16Linear)
    toks, fr = _toks(2, 6, 10), _frames(11, 2)
    lj, sj = JE.prefill(jq, JQCFG, jnp.asarray(toks), JE.init_decode_state(JQCFG, 2, 16),
                        frames=fr)
    lt, st = TE.prefill(bt, QCFG, _long(toks), TE.init_decode_state(QCFG, 2, 16, device="cpu"),
                        frames=_t(fr))
    assert _rel(lj, lt) < REL and _rel(sj["xk"], st["xk"]) < REL
    tok = np.array([[1], [2]], np.int32)
    dj, _ = JE.decode_step(jq, JQCFG, sj, jnp.asarray(tok))
    dt, _ = TE.decode_step(bt, QCFG, st, _long(tok))
    assert _rel(dj, dt) < REL
