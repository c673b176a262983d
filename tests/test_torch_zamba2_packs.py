"""The ``mamba_hybrid`` family's quantized path on the port, held to the
JAX package: W4A16 packs, the shared block's ``gate_up`` fusion (the
reference's ``test_mamba_hybrid_shared_attn_mlp_fuses``) and the W4A4
serving path (a decode step, the gated prefill).

All at a d_model-256 variant of the reduced config with 3 layers (one
segment with its shared-block invocation, one rest layer), so
``_eligible`` packs every linear but the head (K >= 256).

Tolerances:
- W4A16 packs bit-equal to the reference's packer run op by op
  (``jax.disable_jit()``); W4A16 logits over the reference's packs within
  rel 0.05 of the jitted reference (bf16 roundings placed otherwise,
  carried through the recurrence).
- The fused shared ``gate_up`` forward ``torch.equal`` to the unfused one.
- W4A4 over the reference's fused packs, one decode step from one state
  against the reference run op by op, the shared block's decode attention
  being the reference's write-then-attend (``torch_oracles``): the logits
  and every bf16 state leaf (``conv``, the shared block's rows) bit-equal;
  the f32 SSM state within rel 1e-6 (XLA's and PyTorch's ``exp`` and
  softplus differ in the last bit, which the bf16 outputs do not see).
  The port's own read-only-cache step within rel 0.5 of it (its softmax
  sums the cached keys and this step's apart; W4A4 carries that bf16
  rounding to the logits; ROADMAP Queue 3).
- The W4A4 bucket-padded prefill's state ``torch.equal`` to the unpadded
  one's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import QuantSpec as JQ
from repro.configs import get_config as j_get_config
from repro.core import twinquant as JT
from repro.models import mamba_hybrid as JM
from repro_torch.configs import QuantSpec, get_config
from repro_torch.core import twinquant as TT
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.models import common as C
from repro_torch.models import mamba_hybrid as TM
from torch_oracles import write_then_attend

torch.set_num_threads(2)

QCFG = get_config("zamba2-1.2b", reduced=True).replace(d_model=256, d_ff=256, n_layers=3)
JQCFG = j_get_config("zamba2-1.2b", reduced=True).replace(remat=False, d_model=256, d_ff=256,
                                                           n_layers=3)
REL = 0.05
_JDT = {torch.int32: jnp.int32, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _f32(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y, jnp.float32))


def _rel(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _long(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


def _toks(b, s, seed):
    return np.random.default_rng(seed).integers(0, QCFG.vocab, (b, s)).astype(np.int32)


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), QCFG, "cpu")


def _linears(model) -> dict:
    return {n: m for n, m in model.named_modules()
            if isinstance(m, (C.Linear, C.TwinQuantLinear, C.TwinQuantLinearGroup,
                              C.W4A16Linear))}


@pytest.fixture(scope="module")
def qparams():
    """The reference's params, their bridge, and the reference's W4A4
    packs (rank 16, unfused; one jitted graph)."""
    jp = JM.init_params(JQCFG, jax.random.PRNGKey(8))
    jq = jax.jit(lambda p: JT.quantize_params(p, JQCFG, JQ("w4a4", rank=16)))(jp)
    return jp, _bridge(jp), jq


def test_w4a16_packs_bit_equal_to_reference(qparams):
    """Every linear but the head packs (in_proj N = 2 d_inner + 2N + H);
    ``conv`` and the f32 leaves stay as they are; in_proj, out_proj, the
    shared q and the adapter bit for bit against the reference's packer op
    by op; the reference's packed tree bridges to the same packs."""
    jp, pt, _ = qparams
    qt = TT.quantize_params(pt, QCFG, QuantSpec("w4a16"))
    got, base = _linears(qt), _linears(pt)
    assert isinstance(got["head"], C.Linear)
    packed = [n for n, m in got.items() if isinstance(m, C.W4A16Linear)]
    assert len(packed) == 2 * QCFG.n_layers + 7 + 1  # blocks, shared, the adapter
    assert got["m_layers.0.0.in_proj"].wp.shape == (128, 2 * 512 + 2 * 16 + 16)
    assert torch.equal(qt.rest_layers[0].conv, pt.rest_layers[0].conv)
    for name in ("m_layers.0.0.in_proj", "rest_layers.0.out_proj", "shared.q", "adapters.0"):
        with jax.disable_jit():
            want = JT._pack_one_w4a16(jnp.asarray(base[name].w.float().numpy()), JQ("w4a16"))
        assert torch.equal(got[name].wp, _t(want["wp"])), name
        assert torch.equal(got[name].ws, _t(want["ws"])), name
    jq = jax.jit(lambda p: JT.quantize_params(p, JQCFG, JQ("w4a16")))(jp)
    bt = _linears(_bridge(jq))
    assert bt.keys() == got.keys()
    assert all(isinstance(bt[n], C.W4A16Linear) for n in packed)
    assert set(TT.fuse_params(qt).shared) == {"q", "k", "v", "o", "mlp"}  # W4A16 never fuses
    toks = np.arange(8)[None, :] % QCFG.vocab
    lj = JM.forward(jq, JQCFG, jnp.asarray(toks, jnp.int32))
    assert _rel(lj, TM.forward(_bridge(jq), QCFG, _long(toks))) <= REL


def test_shared_attn_mlp_fuses(qparams):
    """The reference's ``test_mamba_hybrid_shared_attn_mlp_fuses``: W4A4
    ``fuse_params`` merges the shared block's MLP gate/up (and nothing of
    its attention), and the forward over the merged pack equals the
    unfused one bit for bit; the reference's fused tree bridges to the
    same layout. (W4A4 logits are held to the reference run op by op in
    ``test_w4a4_serving_path_bit_equal_to_reference_op_by_op``, not to the
    jitted reference: that differs from itself run op by op far beyond
    bf16 rounding, its fused executable rounding otherwise where the 4-bit
    activations carry it through the recurrence.)"""
    _, pt, jq = qparams
    qp = TT.quantize_params(pt, QCFG, QuantSpec("w4a4", rank=16))
    fqp = TT.fuse_params(qp)
    assert set(fqp.shared) == {"q", "k", "v", "o", "mlp"}
    assert set(fqp.shared["mlp"]) == {"gate_up", "down"}
    toks = _long(np.arange(8)[None, :] % QCFG.vocab)
    assert torch.equal(TM.forward(qp, QCFG, toks), TM.forward(fqp, QCFG, toks))
    bt, bu = _bridge(JT.fuse_params(jq)), _bridge(jq)
    assert isinstance(bt.shared["mlp"]["gate_up"], C.TwinQuantLinearGroup)
    assert isinstance(bt.shared["q"], C.TwinQuantLinear)
    y = TM.forward(bt, QCFG, toks)
    assert torch.equal(y, TM.forward(bu, QCFG, toks))
    assert torch.equal(y, TM.forward(TT.fuse_params(bu), QCFG, toks))


def test_w4a4_serving_path_bit_equal_to_reference_op_by_op(qparams, monkeypatch):
    """The reference's fused W4A4 packs (in_proj, out_proj, the shared
    block's q / k / v / o, ``gate_up``, down, the adapter) through the
    port. The port's gated prefill fills the state (padded == unpadded
    bit for bit); from that state one decode step against the reference's
    run op by op (``_mamba_block`` at W4A4 in step mode, the recurrence,
    the shared block, the rest layer): logits and the bf16 leaves bit for
    bit once the shared block's decode attention is the reference's
    write-then-attend, the f32 SSM state within rel 1e-6; the port's own
    step within rel 0.5."""
    jf = JT.fuse_params(qparams[2])
    pt = _bridge(jf)
    assert isinstance(pt.shared["mlp"]["gate_up"], C.TwinQuantLinearGroup)
    assert isinstance(pt.rest_layers[0].in_proj, C.TwinQuantLinear)
    b, s, pad = 2, 5, 3
    toks = _toks(b, s, 9)
    padded = np.concatenate([toks, np.full((b, pad), 5, np.int32)], axis=1)
    st0 = TM.init_decode_state(QCFG, b, 16, device="cpu")
    _, sa = TM.prefill(pt, QCFG, _long(toks), st0)
    _, st = TM.prefill(pt, QCFG, _long(padded), st0, length=torch.full((b,), s))
    differ = [k for k in st if not torch.equal(sa[k], st[k])]
    assert not differ, differ
    tok = np.array([[1], [2]], np.int32)
    sj = {k: jnp.asarray(_f32(v), _JDT[v.dtype]) for k, v in st.items()}
    with jax.disable_jit():
        dj, nj = JM.decode_step(jf, JQCFG, sj, jnp.asarray(tok))
    own, _ = TM.decode_step(pt, QCFG, {k: v.clone() for k, v in st.items()}, _long(tok))
    assert 0 < _rel(dj, own) < 0.5
    monkeypatch.setattr(C, "attention_decode_ro", write_then_attend)
    dt, st = TM.decode_step(pt, QCFG, st, _long(tok))
    assert torch.equal(dt, _t(dj))
    assert st.keys() == nj.keys()
    for k in st:
        if st[k].dtype == torch.float32:
            assert 0 < _rel(nj[k], st[k]) <= 1e-6, k
        else:
            assert torch.equal(st[k], _t(nj[k])), k
