"""The port's quantization primitives, transforms, manifold optimizer and
error diagnostics (repro_torch.core.{quantization,transforms,manifold,
errors}) held to the JAX package's, on the same seeded numpy inputs.

JAX runs these functions op by op (none of them is jitted inside), so every
quotient is a true division on both sides. Tolerances:

* bit-equal: ``compute_scales``, ``quantize``, ``dequantize``, the
  ``fake_quant`` forward and its straight-through gradient (including a
  group whose maximum sits on the clip edge: ``|amax / (amax / 7)| > 7``
  there, so both zero that element's gradient), ``pack_int4`` /
  ``unpack_int4``, ``hadamard_matrix`` (built in float64 with numpy and
  rounded once on both sides), ``quant_error`` and ``groupwise_error_map``;
* relative error <= 1e-5: the GL transforms, the penalty, ``cayley_step``
  and the error sums — XLA and PyTorch sum matmuls and reductions in other
  orders, and their ``exp`` / ``log1p`` (softplus) differ by an ULP;
* 70 ``HybridOpt`` steps on identical gradients: max abs difference <= 1e-4
  (the same ULP-level differences, carried through 70 Cayley solves and the
  QR at step 64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import errors as JE
from repro.core import manifold as JM
from repro.core import quantization as JQ
from repro.core import transforms as JT
from repro_torch.core import errors as TE
from repro_torch.core import manifold as TM
from repro_torch.core import quantization as TQ
from repro_torch.core import transforms as TT
from repro_torch.interop import gl_params_from_numpy

torch.set_num_threads(2)

# a group maximum on the clip edge: 0.5097352 / (0.5097352 / 7) > 7 in f32
EDGE = np.float32(0.5097352)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.detach().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _case(name):
    """(x f32 numpy, cfg kwargs) of one quantizer case."""
    rng = np.random.default_rng(0)
    if name == "axis0":
        return rng.standard_normal((256, 96)).astype(np.float32), dict(group_size=128, axis=0)
    if name == "axis-1":
        return rng.standard_normal((8, 256)).astype(np.float32) * 3, dict(group_size=64, axis=-1)
    if name == "zero_group":
        x = rng.standard_normal((4, 256)).astype(np.float32)
        x[1, 64:128] = 0.0
        return x, dict(group_size=64, axis=-1)
    if name == "clip_edge":
        x = (rng.random((4, 128)).astype(np.float32) - 0.5) * 0.8
        x[2, 5] = EDGE  # the max of row 2's only group, on the clip edge
        return x, dict(group_size=128, axis=-1)
    raise KeyError(name)


CASES = ("axis0", "axis-1", "zero_group", "clip_edge")


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("case", CASES)
def test_quantize_dequantize_scales_bit_equal(case, bits):
    x, kw = _case(case)
    cj, ct = JQ.QuantConfig(bits=bits, **kw), TQ.QuantConfig(bits=bits, **kw)
    assert ct.qmax == cj.qmax and ct.replace(bits=8).qmax == 127
    qj, qt = JQ.quantize(jnp.asarray(x), cj), TQ.quantize(torch.from_numpy(x), ct)
    np.testing.assert_array_equal(_np(qt.scale), np.asarray(qj.scale))
    np.testing.assert_array_equal(_np(qt.q), np.asarray(qj.q))
    assert (qt.bits, qt.group_size, qt.axis) == (qj.bits, qj.group_size, qj.axis)
    np.testing.assert_array_equal(_np(TQ.dequantize(qt)), np.asarray(JQ.dequantize(qj)))
    np.testing.assert_array_equal(_np(TQ.compute_scales(torch.from_numpy(x), ct)),
                                  np.asarray(JQ.compute_scales(jnp.asarray(x), cj)))
    if case == "zero_group":
        assert float(qt.scale[1, 1]) == 1.0 and not qt.q[1, 64:128].any()


def test_quantize_bf16_input_bit_equal():
    """bf16 activations: the scale quotient is taken in bf16 on both sides."""
    x = np.random.default_rng(1).standard_normal((6, 256)).astype(np.float32) * 4
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _t(xj)
    cfg = dict(bits=4, group_size=128, axis=-1)
    yj = JQ.dequantize(JQ.quantize(xj, JQ.QuantConfig(**cfg)), dtype=jnp.bfloat16)
    yt = TQ.dequantize(TQ.quantize(xt, TQ.QuantConfig(**cfg)), dtype=torch.bfloat16)
    np.testing.assert_array_equal(_np(yt), _np(yj))
    np.testing.assert_array_equal(_np(TQ.fake_quant(xt, TQ.QuantConfig(**cfg))),
                                  _np(JQ.fake_quant(xj, JQ.QuantConfig(**cfg))))


@pytest.mark.parametrize("case", CASES)
def test_fake_quant_forward_and_ste_grad_bit_equal(case):
    x, kw = _case(case)
    cj, ct = JQ.QuantConfig(bits=4, **kw), TQ.QuantConfig(bits=4, **kw)
    c = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    yj = JQ.fake_quant(jnp.asarray(x), cj)
    gj = jax.grad(lambda v: jnp.sum(JQ.fake_quant(v, cj) * c))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = TQ.fake_quant(xt, ct)
    (gt,) = torch.autograd.grad(torch.sum(yt * torch.from_numpy(c)), xt)
    np.testing.assert_array_equal(_np(yt), np.asarray(yj))
    np.testing.assert_array_equal(_np(gt), np.asarray(gj))
    if case == "clip_edge":
        # the edge maximum saturates: no gradient there, on both sides
        assert float(gt[2, 5]) == 0.0 and float(gj[2, 5]) == 0.0
        assert float(yt.detach()[2, 5]) == float(EDGE)  # it still dequantizes to itself


def test_pack_unpack_int4_equal():
    q = np.random.default_rng(3).integers(-7, 8, size=(6, 64)).astype(np.int8)
    pj, pt = JQ.pack_int4(jnp.asarray(q)), TQ.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(_np(pt), np.asarray(pj))
    np.testing.assert_array_equal(_np(TQ.unpack_int4(pt)), np.asarray(JQ.unpack_int4(pj)))
    np.testing.assert_array_equal(_np(TQ.unpack_int4(pt)), q)
    with pytest.raises(ValueError):
        TQ.pack_int4(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("n", [128, 96, 14336])
def test_hadamard_matrix_equal(n):
    """14336 = 2^11 * 7 (llama3-8b's d_ff): kron(H_2048, Q_7), which the port
    rounds block by block."""
    hj = np.asarray(JT.hadamard_matrix(n))
    ht = TT.hadamard_matrix(n, device="cpu").numpy()
    assert ht.dtype == np.float32 and ht.shape == (n, n)
    for i in range(0, n, 2048):  # compare in row blocks: no third full copy
        np.testing.assert_array_equal(ht[i:i + 2048], hj[i:i + 2048])
    del hj, ht


def _gl_pair():
    """Perturbed GLParams on both sides: a random orthogonal P, a dense lower
    L with one diagonal entry above softplus's linear switch (25), gamma 0.3."""
    rng = np.random.default_rng(4)
    r = 16
    P, _ = np.linalg.qr(rng.standard_normal((r, r)))
    L = (np.eye(r) * 0.3 + np.tril(rng.standard_normal((r, r)) * 0.05)).astype(np.float32)
    L[3, 3] = 25.0
    gj = JT.GLParams(P=jnp.asarray(P, jnp.float32), L=jnp.asarray(L), gamma=jnp.asarray(0.3))
    return gj, gl_params_from_numpy(jax.tree.map(np.asarray, gj), device="cpu")


@pytest.mark.parametrize("fn", ["gl_materialize", "gl_inverse", "gl_conditioning_penalty"])
def test_gl_transforms_match_reference(fn):
    gj, gt = _gl_pair()
    a, b = np.asarray(getattr(JT, fn)(gj)), _np(getattr(TT, fn)(gt))
    assert _rel(a, b) <= 1e-5, (fn, _rel(a, b))


def test_gl_init_and_inverse_identity():
    """G == I and G^-1 == I exactly at init (the softplus offset lands on 1),
    as in the reference; G @ G^-1 == I at perturbed params."""
    for r in (16, 128):
        g0 = TT.gl_init(r, device="cpu")
        assert torch.equal(TT.gl_materialize(g0), torch.eye(r))
        assert torch.equal(TT.gl_inverse(g0), torch.eye(r))
        assert float(TT.gl_conditioning_penalty(g0)) == 0.0
        j0 = JT.gl_init(r)
        np.testing.assert_array_equal(_np(g0.L), np.asarray(j0.L))
    _, gt = _gl_pair()
    eye = TT.gl_materialize(gt) @ TT.gl_inverse(gt)
    assert float(torch.max(torch.abs(eye - torch.eye(16)))) < 1e-5


def test_orthogonal_inits_and_error():
    gen = torch.Generator().manual_seed(0)
    q = TT.random_orthogonal(gen, 64)
    assert float(TT.orthogonality_error(q)) < 1e-5
    q2 = TT.random_orthogonal(torch.Generator().manual_seed(0), 64)
    assert torch.equal(q, q2)  # seeded
    assert torch.equal(TT.orthogonal_init(8, "identity"), torch.eye(8))
    assert torch.equal(TT.orthogonal_init(96, "hadamard"), TT.hadamard_matrix(96))
    assert torch.equal(TT.orthogonal_init(64, "random", torch.Generator().manual_seed(0)), q)
    with pytest.raises(ValueError):
        TT.orthogonal_init(8, "nope")
    a = np.random.default_rng(5).standard_normal((32, 32)).astype(np.float32)
    assert _rel(np.asarray(JT.orthogonality_error(jnp.asarray(a))),
                _np(TT.orthogonality_error(torch.from_numpy(a)))) <= 1e-6


def _skew_case():
    rng = np.random.default_rng(6)
    q, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    g = rng.standard_normal((32, 32)).astype(np.float32)
    return q.astype(np.float32), g


def test_cayley_step_matches_reference():
    q, g = _skew_case()
    sj = JM._lift_skew(jnp.asarray(g), jnp.asarray(q))
    st = TM._lift_skew(torch.from_numpy(g), torch.from_numpy(q))
    assert _rel(np.asarray(sj), _np(st)) <= 1e-6
    qj = np.asarray(JM.cayley_step(jnp.asarray(q), sj, -0.05))
    qt = TM.cayley_step(torch.from_numpy(q), st, -0.05)
    assert _rel(qj, _np(qt)) <= 1e-5
    assert float(TT.orthogonality_error(qt)) < 1e-5
    # lr 0 leaves Q exactly where it was (the frozen stages rely on it)
    assert torch.equal(TM.cayley_step(torch.from_numpy(q), st, -0.0), torch.from_numpy(q))


def test_hybrid_opt_70_steps_match_reference():
    """70 steps on the same gradients, crossing the count-64 QR, with the
    stage scales switching at steps 20 and 40: Q trains, then G only (Q's
    scale 0 across step 64, where the QR still moves it), then both."""
    rng = np.random.default_rng(7)
    q0, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    pj = {"Q": jnp.asarray(q0, jnp.float32), "G": JT.gl_init(8)}
    pt = {"Q": torch.from_numpy(q0.astype(np.float32)), "G": TT.gl_init(8)}
    mask_j = {"Q": True, "G": JT.GLParams(P=True, L=False, gamma=False)}
    mask_t = {"Q": True, "G": TT.GLParams(P=True, L=False, gamma=False)}
    oj, ot = JM.HybridOpt(lr=0.05), TM.HybridOpt(lr=0.05)
    sj, st = oj.init(pj), ot.init(pt)
    # one compiled update (its only quotient is by a tensor; the rest is
    # within the tolerance's ULP-level reassociation)
    update_j = jax.jit(lambda g, s, p, sc: oj.update(g, s, p, mask_j, sc))

    def scales(i, lib):
        q, g = (1.0, 0.0) if i < 20 else (0.0, 1.0) if i < 40 else (1.0, 1.0)
        if i >= 60:
            q = 0.0  # frozen Q across the QR at count 64
        return {"Q": q, "G": lib.GLParams(P=g, L=g, gamma=g)}

    q_before_64 = None
    for i in range(70):
        gq = rng.standard_normal((24, 24)).astype(np.float32) * 3
        gp, gl = (rng.standard_normal((8, 8)).astype(np.float32) for _ in range(2))
        gg = np.float32(rng.standard_normal())
        grads_j = {"Q": jnp.asarray(gq), "G": JT.GLParams(jnp.asarray(gp), jnp.asarray(gl),
                                                          jnp.asarray(gg))}
        grads_t = {"Q": torch.from_numpy(gq), "G": TT.GLParams(torch.from_numpy(gp),
                                                              torch.from_numpy(gl),
                                                              torch.tensor(gg))}
        if i == 63:
            q_before_64 = pt["Q"]
        pj, sj = update_j(grads_j, sj, pj, scales(i, JT))
        pt, st = ot.update(grads_t, st, pt, mask_t, scales(i, TT))
    assert st.count == 70 == int(sj.count)
    # the QR at count 64 moved the frozen Q (by ~its f32 orthogonality drift)
    assert not torch.equal(pt["Q"], q_before_64)
    for a, b in zip(jax.tree.leaves(pj), TM.tree_leaves(pt)):
        assert np.max(np.abs(np.asarray(a) - _np(b))) <= 1e-4
    for a, b in zip(jax.tree.leaves(sj.momentum), TM.tree_leaves(st.momentum)):
        assert np.max(np.abs(np.asarray(a) - _np(b))) <= 1e-4
    assert float(TT.orthogonality_error(pt["Q"])) < 1e-5
    assert float(TT.orthogonality_error(pt["G"].P)) < 1e-5
    assert TM.is_stiefel_path(("G", "P")) and not TM.is_stiefel_path(("G", "L"))


def _err_inputs():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    x[:, 7] *= 30.0
    U = rng.standard_normal((256, 16)).astype(np.float32) * 0.2
    V = rng.standard_normal((16, 96)).astype(np.float32) * 0.2
    R = rng.standard_normal((256, 96)).astype(np.float32) * 0.05
    cfgs = [dict(bits=4, group_size=128, axis=-1), dict(bits=4, group_size=128, axis=0),
            dict(bits=4, group_size=16, axis=0), dict(bits=4, group_size=128, axis=0)]
    return (x, U, V, R), cfgs


@pytest.mark.parametrize("fn", ["error_terms", "total_delta"])
def test_error_sums_match_reference(fn):
    arrs, cfgs = _err_inputs()
    oj = getattr(JE, fn)(*map(jnp.asarray, arrs), *(JQ.QuantConfig(**c) for c in cfgs))
    ot = getattr(TE, fn)(*map(torch.from_numpy, arrs), *(TQ.QuantConfig(**c) for c in cfgs))
    if fn == "error_terms":
        assert sorted(oj) == sorted(ot)
        for k in oj:
            assert _rel(np.asarray(oj[k]), _np(ot[k])) <= 1e-5, k
    else:
        assert _rel(np.asarray(oj), _np(ot)) <= 1e-5


def test_gains_and_error_maps_match_reference():
    (x, U, V, R), _ = _err_inputs()
    H = JT.hadamard_matrix(256)
    zj = JE.zeta_gain(jnp.asarray(x), H)
    zt = TE.zeta_gain(torch.from_numpy(x), TT.hadamard_matrix(256))
    assert _rel(np.asarray(zj), _np(zt)) <= 1e-5 and float(zt) > 2.0
    U2, V2 = U * 3.0, V / 3.0
    ej = JE.eta_gain(*map(jnp.asarray, (U, V, U2, V2)))
    et = TE.eta_gain(*map(torch.from_numpy, (U, V, U2, V2)))
    assert _rel(np.asarray(ej), _np(et)) <= 1e-6
    for cfg in (dict(bits=4, group_size=64, axis=-1), dict(bits=4, group_size=64, axis=0)):
        mj = JE.groupwise_error_map(jnp.asarray(x), JQ.QuantConfig(**cfg))
        mt = TE.groupwise_error_map(torch.from_numpy(x), TQ.QuantConfig(**cfg))
        assert _np(mt).shape == np.asarray(mj).shape
        assert _rel(np.asarray(mj), _np(mt)) <= 1e-6
        np.testing.assert_array_equal(
            _np(TE.quant_error(torch.from_numpy(x), TQ.QuantConfig(**cfg))),
            np.asarray(JE.quant_error(jnp.asarray(x), JQ.QuantConfig(**cfg))))
