"""The ``xlstm`` family's quantized path on the port, held to the JAX
package, and the narrow-N tile that serves its gate linear ``wif`` (N = 2 x
heads, rank min(128, N)) on the card.

The model tests use a d_model-256 variant of the reduced config (the
convention of ``tests/test_quant_integration.py``), so ``_eligible`` packs
every linear but the head: ``up`` (K 256), ``wq`` / ``wk`` / ``wv`` /
``wif`` / ``down`` (K 512), the sLSTM ``w`` and its ffn.

Tolerances:
- W4A16 packs bit-equal to the reference's packer run op by op
  (``jax.disable_jit()``); the W4A4 packer's quantization bit-equal to the
  reference's ``pack_twinquant_weights`` run op by op on the same SVD
  factors (the SVDs themselves are LAPACK's and PyTorch's).
- W4A16 logits over the reference's packs within rel 0.05 of the jitted
  reference (XLA keeps bf16 intermediates in f32). W4A4 is held to the
  reference run op by op in ``test_torch_xlstm_w4a4.py``, not to the
  jitted reference: that differs from itself run op by op by rel ~0.44 on
  a decode step's logits here (its fused executable rounds otherwise, and
  4-bit activations carry it on; ROADMAP Queue 3).
- The fused sLSTM ffn ``gate_up`` forward ``torch.equal`` to the unfused
  one; the W4A4 bucket-padded prefill's state ``torch.equal`` to the
  unpadded one's.
- The CPU models of the kernels at the narrow shapes (the dual GEMV's and
  GEMM's schedules, the masked tile's byte loads and the rank edge's one
  zero-filled k-step, ``w4a16_gemm``'s masked decode tile) ``torch.equal``
  to the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import QuantSpec as JQ
from repro.configs import get_config as j_get_config
from repro.core import decomposition as JDec
from repro.core import twinquant as JT
from repro.kernels import ref as JRef
from repro.models import xlstm as JX
from repro_torch.configs import QuantSpec, get_config
from repro_torch.core import twinquant as TT
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.kernels import dispatch as TD
from repro_torch.kernels import ref as T
from repro_torch.kernels.contracts import ContractError
from repro_torch.models import common as C
from repro_torch.models import xlstm as TX
from test_torch_decode_schedule import w4a16_decode_model
from test_torch_dual_schedule import gemm_model, gemv_model

torch.set_num_threads(2)

QCFG = get_config("xlstm-1.3b", reduced=True).replace(d_model=256)
JQCFG = j_get_config("xlstm-1.3b", reduced=True).replace(remat=False, d_model=256)
WIF = dict(k=4096, n=8, r=8)  # xlstm-1.3b's gate linear at full width


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


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), QCFG, "cpu")


def _linears(model) -> dict:
    return {n: m for n, m in model.named_modules()
            if isinstance(m, (C.Linear, C.TwinQuantLinear, C.TwinQuantLinearGroup,
                              C.W4A16Linear))}


@pytest.fixture(scope="module")
def qparams():
    """The reference's params, their bridge, and the reference's W4A4
    (rank 16) and W4A16 packs (one jitted graph each)."""
    jp = JX.init_params(JQCFG, jax.random.PRNGKey(8))
    jq4 = jax.jit(lambda p: JT.quantize_params(p, JQCFG, JQ("w4a4", rank=16)))(jp)
    jq16 = jax.jit(lambda p: JT.quantize_params(p, JQCFG, JQ("w4a16")))(jp)
    return jp, _bridge(jp), jq4, jq16


def test_w4a16_packs_bit_equal_to_reference(qparams):
    jp, pt, _, jq16 = qparams
    qt = TT.quantize_params(pt, QCFG, QuantSpec("w4a16"))
    got, base = _linears(qt), _linears(pt)
    assert isinstance(got["head"], C.Linear)
    packed = [n for n, m in got.items() if isinstance(m, C.W4A16Linear)]
    n_seg, m_per = TX._segments(QCFG)
    assert len(packed) == 6 * n_seg * m_per + 4 * n_seg
    assert got["m_layers.0.0.wif"].wp.shape == (256, 2 * QCFG.n_heads)
    assert torch.equal(qt.m_layers[1][0].conv, pt.m_layers[1][0].conv)
    for name in ("m_layers.0.0.up", "m_layers.0.0.wq", "m_layers.1.0.wif", "m_layers.1.0.down",
                 "s_layers.0.w", "s_layers.1.ffn.gate", "s_layers.1.ffn.down"):
        with jax.disable_jit():
            want = JT._pack_one_w4a16(jnp.asarray(base[name].w.float().numpy()), JQ("w4a16"))
        assert torch.equal(got[name].wp, _t(want["wp"])), name
        assert torch.equal(got[name].ws, _t(want["ws"])), name
    bt = _linears(_bridge(jq16))
    assert bt.keys() == got.keys()
    assert all(isinstance(bt[n], C.W4A16Linear) for n in packed)
    assert set(TT.fuse_params(qt).s_layers[0].ffn) == {"gate", "up", "down"}  # never fused
    toks = np.arange(8)[None, :] % QCFG.vocab
    lj = jax.jit(lambda p, t: JX.forward(p, JQCFG, t))(jq16, jnp.asarray(toks, jnp.int32))
    assert _rel(lj, TX.forward(_bridge(jq16), QCFG, _long(toks))) <= 0.05


@pytest.mark.parametrize("name", ["m_layers.0.0.wif", "m_layers.0.0.up", "s_layers.0.w"])
def test_w4a4_packing_bit_equal_to_reference_on_the_same_factors(qparams, name):
    """The port's ``_pack_one`` picks the reference's rank (``wif``: N = 4,
    rank 4, rgroup 4), and its quantization of the reference's SVD factors
    is the reference's packer's, op by op, bit for bit."""
    _, pt, _, _ = qparams
    lin = _linears(pt)[name]
    spec = QuantSpec("w4a4", rank=16)
    w = jnp.asarray(lin.w.float().numpy())
    k, n = w.shape
    mine = TT._pack_one(lin, spec).weights()
    with jax.disable_jit():
        U, V, R = JDec.svd_decompose(w, max(2, min(16, k // 2, n) // 2 * 2))
        want = JRef.pack_twinquant_weights(U, V, R, a_bits=4, group=min(128, k))
    assert (mine.rank, mine.rgroup, mine.group) == (U.shape[1], want.rgroup, want.group)
    got = T.pack_twinquant_weights(_t(U), _t(V), _t(R), a_bits=4, group=min(128, k))
    for f in ("up", "us", "vp", "vs", "rp", "rs"):
        assert torch.equal(getattr(got, f), _t(getattr(want, f))), f


def test_w4a4_fused_forward_and_gated_prefill(qparams):
    """W4A4 ``fuse_params`` merges the sLSTM ffn's gate/up (and nothing of
    the mLSTM blocks); the merged forward equals the unfused one bit for
    bit; the reference's fused tree bridges to the same layout; the
    bucket-padded prefill leaves the unpadded one's state."""
    _, pt, jq4, _ = qparams
    qp = TT.quantize_params(pt, QCFG, QuantSpec("w4a4", rank=16))
    fqp = TT.fuse_params(qp)
    assert set(fqp.s_layers[0].ffn) == {"gate_up", "down"}
    assert {n for n, _ in fqp.m_layers[0][0].named_children()} == {
        "up", "wq", "wk", "wv", "wif", "down"}
    toks = np.random.default_rng(3).integers(0, QCFG.vocab, (1, 11)).astype(np.int32)
    assert torch.equal(TX.forward(qp, QCFG, _long(toks)), TX.forward(fqp, QCFG, _long(toks)))
    bt = _bridge(JT.fuse_params(jq4))
    assert isinstance(bt.s_layers[1].ffn["gate_up"], C.TwinQuantLinearGroup)
    assert isinstance(bt.m_layers[1][0].wif, C.TwinQuantLinear)
    assert _linears(bt).keys() == _linears(fqp).keys()
    pad = np.zeros((1, 16), np.int64)
    pad[0, :11] = toks[0]
    st = TX.init_decode_state(QCFG, 1, 32, device="cpu")
    lp, sp = TX.prefill(fqp, QCFG, _long(pad), st, length=torch.tensor([11]))
    lu, su = TX.prefill(fqp, QCFG, _long(toks), st)
    assert torch.equal(lp, lu) and all(torch.equal(sp[k], su[k]) for k in su)


# ---------------------------------------------------------------------------
# the narrow-N tile: routes and the kernels' schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,path", [(1, "decode"), (8, "decode"), (9, "prefill"),
                                    (64, "prefill")])
def test_wif_routes_to_a_kernel(m, path):
    """xlstm-1.3b's ``wif`` (K 4096, N 8, rank 8, rgroup 8) routes to the
    dual kernels and to ``w4a16_gemm`` at every served M; on a device other
    than the CPU (meta standing in for the card) the call reaches the
    kernel wrapper, not the plain version. N = 100 stays untileable."""
    k, n, r = WIF["k"], WIF["n"], WIF["r"]
    rt = TD.classify_dual(m, n, k, 128, r, r)
    assert (rt.path, rt.code) == (path, "ok")
    rw = TD.classify_w4a16(m, n, k, 128)
    assert (rw.path, rw.code) == ("prefill", "ok")
    bad = TD.classify_dual(m, 100, k, 128, 32, 32)
    assert (bad.path, bad.code) == ("ref", f"{path}_untileable")
    assert TD.classify_w4a16(m, 100, k, 128).code == "prefill_untileable"
    g = torch.Generator().manual_seed(m)
    w = T.pack_twinquant_weights(torch.randn(k, r, generator=g) * 0.1,
                                 torch.randn(r, n, generator=g) * 0.1,
                                 torch.randn(k, n, generator=g) * 0.05, a_bits=4)
    meta = T.TwinQuantWeights(*(t.to("meta") for t in (w.up, w.us, w.vp, w.vs, w.rp, w.rs)),
                              w.group, w.rgroup, w.a_bits)
    x = torch.empty(m, k, dtype=torch.bfloat16, device="meta")
    TD.reset_dispatch_counters()
    with pytest.raises(ContractError, match="CUDA"):
        TD.quant_linear(x, meta)
    wq, ws = T.quantize_rows_ref(torch.randn(k, n, generator=g), 128, 4)
    with pytest.raises(ContractError, match="CUDA"):
        TD.w4a16_linear(x, T.pack_rows_groupsplit(wq, 128).to("meta"), ws.to("meta"))
    assert TD.dispatch_counters() == {f"dual/{path}": 1, "w4a16/prefill": 1}
    TD.reset_dispatch_counters()


def test_contracts_admit_only_the_narrow_cases():
    """Even N below the column unit is one masked tile; a rank group below
    the GEMM's 32-deep step is one zero-filled step only in multiples of 8
    (the unpack's 4-byte stores of the high nibbles land at k = rgroup / 2
    + 4i); odd N, and N past a unit that is not a multiple of it, stay
    untileable."""
    assert TD.classify_dual(4, 6, 512, 128, 6, 6).code == "ok"  # the GEMV: any even rgroup
    for rg, code in ((8, "ok"), (16, "ok"), (24, "ok"), (4, "prefill_untileable"),
                     (12, "prefill_untileable")):
        assert TD.classify_dual(16, 8, 512, 128, rg, rg).code == code, rg
    for n, code in ((8, "ok"), (24, "ok"), (62, "ok"), (64, "ok"), (7, "prefill_untileable"),
                    (96, "prefill_untileable"), (100, "prefill_untileable")):
        assert TD.classify_dual(16, n, 512, 128, 8, 8).code == code, n
        assert TD.classify_w4a16(16, n, 512, 128).code == code, n
    assert TD.classify_dual(4, 30, 512, 128, 8, 8).code == "ok"
    assert TD.classify_dual(4, 48, 512, 128, 8, 8).code == "decode_untileable"


def _narrow(seed, k, seg_n, seg_r):
    g = torch.Generator().manual_seed(seed)
    return T.fuse_twinquant_weights([
        T.pack_twinquant_weights(torch.randn(k, r, generator=g) * 0.1,
                                 torch.randn(r, n, generator=g) * 0.1,
                                 torch.randn(k, n, generator=g) * 0.05, a_bits=4)
        for n, r in zip(seg_n, seg_r)])


@pytest.mark.parametrize("seg", [((8,), (8,)), ((8, 64), (8, 32))], ids=["wif", "group"])
def test_dual_schedules_bit_exact_at_the_narrow_shapes(seg):
    """The GEMV's per-segment tile map (a segment of 8 columns is one
    masked 16-column tile; the next segment starts at column 8) and the
    GEMM's masked tiles and rank-8 groups, modelled step for step, equal
    the plain version."""
    gw = _narrow(5, 512, *seg)
    for m in (1, 8):
        x = (torch.randn(m, 512, generator=torch.Generator().manual_seed(m)) * 2).bfloat16()
        assert torch.equal(gemv_model(x, gw), T.dual_gemm_group_ref(x, gw))
    for m in (9, 100):
        x = (torch.randn(m, 512, generator=torch.Generator().manual_seed(m)) * 2).bfloat16()
        assert torch.equal(gemm_model(x, gw), T.dual_gemm_group_ref(x, gw))


# The GEMM's shared-memory byte map (csrc/twinquant_dual_gemm.cu): a tile
# row is 128 bytes, 16-byte chunk c of row r at chunk c ^ (r & 7)
def _a_off(r, c):
    return r * 128 + ((c ^ (r & 7)) << 4)


def _byte_tile_a(a, m, g, bm, stale):
    """The byte path's A tile: bm rows x one k-step (32), byte k of row r at
    ``_a_off(r, k >> 4) + (k & 15)``, zero past the group and past M; the
    rest of the tile holds ``stale`` bytes (an earlier task's)."""
    kp = (g + 31) // 32 * 32
    tile = stale.clone()
    for r in range(bm):
        for k in range(kp):
            ok = k < g and r < m
            tile[_a_off(r, k >> 4) + (k & 15)] = a[r, k] if ok else 0
    return tile, kp


def _unpacked_b(packed, half, ncols, bn, stale):
    """The B tile after ``gm_unpack`` of a byte-loaded slot: packed row r's
    low nibble at k = r, its high nibble at k = half + r (16 x each, as
    sign-extended bytes), columns past ``ncols`` zero (the byte path zeroes
    them); k past 2 x half keeps ``stale`` bytes."""
    b = stale.clone()
    p = torch.zeros(half, bn, dtype=torch.int64)
    p[:, :ncols] = packed[:half, :ncols].to(torch.int64) & 0xFF
    lo = ((p << 4) & 0xF0).to(torch.int8).to(torch.int64)
    hi = (p & 0xF0).to(torch.int8).to(torch.int64)
    for r in range(half):
        b[:, r] = lo[r]
        b[:, half + r] = hi[r]
    return b


@pytest.mark.parametrize("rgroup", [8, 16, 24])
def test_rank_edge_and_masked_tile_index_math(rgroup):
    """One V task of a rank group below the MMA's 32-deep step, through the
    byte loads: the A tile's lanes past the group are zero, so the k-step's
    int32 dot over all 32 lanes (stale B bytes included) is 16 x the
    group's exact dot; the byte map covers each tile byte once and puts
    each byte where the 16-byte copies do; the high nibbles' 4-byte stores
    stay aligned (half % 4 == 0). The planted fault (lanes past the group
    not zeroed) changes the dot."""
    g = torch.Generator().manual_seed(rgroup)
    bm, bn, m, ncols, half = 16, 32, 11, 8, rgroup // 2
    assert half % 4 == 0
    offs = sorted(_a_off(r, c) + i for r in range(bm) for c in range(8) for i in range(16))
    assert offs == list(range(bm * 128))
    hq = torch.randint(-7, 8, (bm, 32), generator=g, dtype=torch.int8)
    vq = torch.randint(-8, 8, (rgroup, ncols), generator=g, dtype=torch.int8)
    packed = T.pack_rows_groupsplit(vq, rgroup)
    stale = torch.randint(-128, 128, (bm * 128,), generator=g, dtype=torch.int8)
    tile, kp = _byte_tile_a(hq, m, rgroup, bm, stale)
    assert kp == 32
    a = torch.stack([torch.stack([tile[_a_off(r, k >> 4) + (k & 15)] for k in range(kp)])
                     for r in range(bm)]).to(torch.int64)
    b = _unpacked_b(packed, half, ncols, bn,
                    torch.randint(-128, 128, (bn, kp), generator=g).to(torch.int64))
    dot = a @ b.T  # the MMA over the one k-step
    want = torch.zeros(bm, bn, dtype=torch.int64)
    want[:m, :ncols] = hq[:m, :rgroup].to(torch.int64) @ vq.to(torch.int64)
    assert torch.equal(dot, 16 * want)
    faulty = a.clone()
    faulty[:m, rgroup:] = hq[:m, rgroup:].to(torch.int64)  # lanes past the group read
    assert not torch.equal(faulty @ b.T, 16 * want)


@pytest.mark.parametrize("m", [1, 8, 32])
def test_w4a16_masked_decode_tile(m):
    """``w4a16_gemm``'s narrow decode tile: the 16-column tile's packed
    bytes and scales past N = 8 are zero, so its dequantized weights there
    are 0 x 0; the schedule over that tile gives the narrow plain version's
    columns bit for bit in f32."""
    g = torch.Generator().manual_seed(m)
    k, n = 512, 8
    wq, ws = T.quantize_rows_ref(torch.randn(k, n, generator=g) * 0.05, 128, 4)
    wp = T.pack_rows_groupsplit(wq, 128)
    wp16 = torch.cat([wp, torch.zeros(k // 2, 16 - n, dtype=torch.int8)], dim=1)
    ws16 = torch.cat([ws, torch.zeros(k // 128, 16 - n)], dim=1)
    x = (torch.randn(m, k, generator=g) * 2).bfloat16()
    y = w4a16_decode_model(x, wp16, ws16, 128)
    assert torch.equal(y[:, :n], T.w4a16_gemm_f32(x, wp, ws, 128))
    assert not y[:, n:].any()
