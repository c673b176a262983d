"""The port's plain versions and pack format (repro_torch.kernels.ref) held
to the JAX package: packing and quantization bit for bit; the dual GEMM /
group GEMM to the JAX oracle and to the JAX kernels in interpret mode under
stated tolerances; fused-group segments bit for bit within the port.

Two levels for the dual GEMM. Run op by op (``jax.disable_jit()``), the JAX
oracle performs exactly the port's operations in the port's order, and the
port's plain version equals it bit for bit. The jitted oracle is one fused
XLA executable: on the CPU it contracts ``acc + dot * s_x * s_w`` into FMAs
and rounds differently, so it is held to a tolerance, as are the JAX kernels
in interpret mode. At a_bits = 4 one f32 ULP in H can flip a requantized H
value and move a whole row by one ``hs * vs`` step, so W4A4 gets the wider
bound: relative error <= 0.15 (W4A4) and <= 0.01 (W4A8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as J
from repro.kernels.twinquant_dual_gemm import dual_gemm as j_dual_gemm
from repro.kernels.twinquant_dual_gemm import dual_gemm_group as j_dual_gemm_group
from repro.kernels.twinquant_dual_gemv import dual_gemv as j_dual_gemv
from repro.kernels.twinquant_dual_gemv import dual_gemv_group as j_dual_gemv_group
from repro_torch.kernels import ref as T

torch.set_num_threads(2)

REL_TOL = {4: 0.15, 8: 0.01}


def _t(a) -> torch.Tensor:
    """numpy / jax array -> torch tensor (bf16 through f32, exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y, jnp.float32))


def _factors(rng, K, N, r):
    U = rng.standard_normal((K, r)).astype(np.float32) * 0.1
    V = rng.standard_normal((r, N)).astype(np.float32) * 0.1
    R = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    return U, V, R


def _packs(rng, K, N, r, a_bits, zero_v=False):
    U, V, R = _factors(rng, K, N, r)
    if zero_v:
        V = np.zeros_like(V)
    wj = J.pack_twinquant_weights(jnp.asarray(U), jnp.asarray(V), jnp.asarray(R), a_bits=a_bits)
    wt = T.pack_twinquant_weights(torch.from_numpy(U), torch.from_numpy(V), torch.from_numpy(R),
                                  a_bits=a_bits)
    return wj, wt


def _x(rng, M, K):
    xb = jnp.asarray(rng.standard_normal((M, K)) * 2, jnp.bfloat16)
    return xb, _t(xb)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


# ---------------------------------------------------------------------------
# bit-equal pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", [16, 64, 128])
def test_pack_unpack_bit_equal(group):
    q = np.random.default_rng(group).integers(-7, 8, (256, 96)).astype(np.int8)
    pj = np.asarray(J.pack_rows_groupsplit(jnp.asarray(q), group))
    pt = T.pack_rows_groupsplit(torch.from_numpy(q), group)
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(T.unpack_rows_groupsplit(pt, group).numpy(), q)
    np.testing.assert_array_equal(
        T.unpack_rows_groupsplit(torch.from_numpy(pj), group).numpy(),
        np.asarray(J.unpack_rows_groupsplit(jnp.asarray(pj), group)))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_rows_and_act_bit_equal(bits):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((512, 64)).astype(np.float32)
    w[:128, 3] = 0.0  # an all-zero group takes scale 1
    qj, sj = J.quantize_rows_ref(jnp.asarray(w), 128, bits)
    qt, st = T.quantize_rows_ref(torch.from_numpy(w), 128, bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    xb, xt = _x(rng, 8, 512)
    qj, sj = J.quantize_act_ref(xb, 128, bits)
    qt, st = T.quantize_act_ref(xt, 128, bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("a_bits", [4, 8])
def test_pack_twinquant_weights_bit_equal(a_bits):
    wj, wt = _packs(np.random.default_rng(3), 512, 256, 64, a_bits)
    for f in ("up", "us", "vp", "vs", "rp", "rs"):
        np.testing.assert_array_equal(getattr(wt, f).numpy(), np.asarray(getattr(wj, f)))
    assert (wt.group, wt.rgroup, wt.a_bits) == (wj.group, wj.rgroup, wj.a_bits)


# ---------------------------------------------------------------------------
# dual GEMM vs the JAX oracle and the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a_bits", [4, 8])
@pytest.mark.parametrize("M,K,N,r", [(8, 768, 128, 128), (40, 512, 256, 64)])
def test_dual_gemm_ref_vs_jax_oracle(M, K, N, r, a_bits):
    rng = np.random.default_rng(M * 100 + a_bits)
    wj, wt = _packs(rng, K, N, r, a_bits)
    xb, xt = _x(rng, M, K)
    yt = _np(T.dual_gemm_ref(xt, wt))
    assert yt.shape == (M, N) and np.isfinite(yt).all()
    with jax.disable_jit():
        np.testing.assert_array_equal(yt, _np(J.dual_gemm_ref(xb, wj)))
    assert _rel(_np(J.dual_gemm_ref(xb, wj)), yt) <= REL_TOL[a_bits]


@pytest.mark.parametrize("a_bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8])
def test_dual_gemm_ref_vs_jax_gemv_interpret(M, a_bits):
    rng = np.random.default_rng(20 + M + a_bits)
    wj, wt = _packs(rng, 512, 256, 64, a_bits)
    xb, xt = _x(rng, M, 512)
    yk = _np(j_dual_gemv(xb, wj, block_n=128, interpret=True))
    assert _rel(yk, _np(T.dual_gemm_ref(xt, wt))) <= REL_TOL[a_bits]


@pytest.mark.parametrize("a_bits", [4, 8])
def test_dual_gemm_ref_vs_jax_gemm_interpret(a_bits):
    rng = np.random.default_rng(30 + a_bits)
    wj, wt = _packs(rng, 512, 256, 64, a_bits)
    xb, xt = _x(rng, 32, 512)
    yk = _np(j_dual_gemm(xb, wj, block_m=32, block_n=128, block_k=256, interpret=True))
    assert _rel(yk, _np(T.dual_gemm_ref(xt, wt))) <= REL_TOL[a_bits]


# ---------------------------------------------------------------------------
# fused groups with uneven segments (the reference's test_fused_group shapes)
# ---------------------------------------------------------------------------

K_G = 512
SEGS = ((256, 64), (128, 32), (128, 32))


def _groups(a_bits, seed=10):
    rng = np.random.default_rng(seed)
    pairs = [_packs(rng, K_G, n, r, a_bits) for n, r in SEGS]
    gj = J.fuse_twinquant_weights([p[0] for p in pairs])
    gt = T.fuse_twinquant_weights([p[1] for p in pairs])
    return gj, gt, [p[1] for p in pairs]


def test_fuse_segment_roundtrip_bit_equal():
    gj, gt, wts = _groups(4)
    assert gt.seg_n == gj.seg_n and gt.seg_r == gj.seg_r and gt.rgroups == gj.rgroups
    for j, w in enumerate(wts):
        seg = gt.segment(j)
        for f in ("up", "us", "vp", "vs", "rp", "rs"):
            assert torch.equal(getattr(seg, f), getattr(w, f))
            np.testing.assert_array_equal(getattr(seg, f).numpy(),
                                          np.asarray(getattr(gj.segment(j), f)))
        assert (seg.group, seg.rgroup, seg.a_bits) == (w.group, w.rgroup, w.a_bits)


@pytest.mark.parametrize("M", [1, 8, 40])
def test_group_ref_bit_equal_to_per_segment_ref(M):
    """Within the port, the fused plain version equals the per-segment one
    bit for bit (same operations, column-independent)."""
    _, gt, wts = _groups(4)
    _, xt = _x(np.random.default_rng(M), M, K_G)
    y = T.dual_gemm_group_ref(xt, gt)
    for j, w in enumerate(wts):
        assert torch.equal(gt.split(y)[j], T.dual_gemm_ref(xt, w))


@pytest.mark.parametrize("a_bits", [4, 8])
@pytest.mark.parametrize("M", [8, 40])
def test_group_ref_vs_jax_oracle(M, a_bits):
    gj, gt, _ = _groups(a_bits)
    xb, xt = _x(np.random.default_rng(M + 7), M, K_G)
    yt = _np(T.dual_gemm_group_ref(xt, gt))
    with jax.disable_jit():
        np.testing.assert_array_equal(yt, _np(J.dual_gemm_group_ref(xb, gj)))
    assert _rel(_np(J.dual_gemm_group_ref(xb, gj)), yt) <= REL_TOL[a_bits]


@pytest.mark.parametrize("a_bits", [4, 8])
def test_group_ref_vs_jax_group_kernels_interpret(a_bits):
    gj, gt, _ = _groups(a_bits)
    rng = np.random.default_rng(50 + a_bits)
    xb, xt = _x(rng, 8, K_G)
    yk = _np(j_dual_gemv_group(xb, gj, block_n=128, interpret=True))
    assert _rel(yk, _np(T.dual_gemm_group_ref(xt, gt))) <= REL_TOL[a_bits]
    xb, xt = _x(rng, 32, K_G)
    yk = _np(j_dual_gemm_group(xb, gj, block_m=32, block_n=128, block_k=256, interpret=True))
    assert _rel(yk, _np(T.dual_gemm_group_ref(xt, gt))) <= REL_TOL[a_bits]
