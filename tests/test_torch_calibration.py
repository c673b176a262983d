"""The port's calibration (repro_torch.core.{decomposition,calibration})
held to the JAX package's on the reference test's outlier-heavy layer (M =
128 inputs, N = 96 outputs, rank 16, 256 samples; built by JAX from key 42
and carried across as numpy), and the reference's own integration checks
(tests/test_core_calibration.py) reproduced on the port at the same step
counts.

JAX runs op by op (``jax.disable_jit()``) wherever the jitted oracle would
turn the scale quotient ``amax / qmax`` into a reciprocal multiply. What is
held, and to what:

* ``_layer_loss`` at Q = I, G = I (every fake-quantizer input is then
  exact on both sides): value and every gradient, relative error <= 1e-5;
* at the Hadamard start: value and G's gradients <= 1e-5, Q's gradient <=
  0.02. XLA and PyTorch round ``Q^T R`` differently in the last bit, and
  the straight-through mask at a group's maximum (``|amax / (amax / 7)| <=
  7``) lands on either side of the clip edge with that bit: 20 of R2's
  group maxima here. A flipped mask drops or keeps one outlier's gradient;
* ``search_alpha`` picks the same alpha, lambda within 2e-6;
* a 3 / 3 / 2-step ``calibrate_layer``: ``init_loss`` <= 1e-5, the loss
  history <= 0.01, Q <= 1e-3 max abs, G and G^-1 <= 0.02 max abs after
  conjugation by the SVD sign matrix D. The mask flips above steer each
  step's gradient a little differently, so the trajectories drift apart
  step by step (after 8 steps: history 3e-3, Q 6e-5, G 6e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as JC
from repro.core import decomposition as JD
from repro.core import transforms as JT
from repro_torch.core import calibration as TC
from repro_torch.core import decomposition as TD
from repro_torch.core import errors as TE
from repro_torch.core import manifold as TM
from repro_torch.core import transforms as TT
from repro_torch.core.quantization import QuantConfig
from repro_torch.interop import calib_result_from_numpy, gl_params_from_numpy
from repro_torch.kernels import dispatch
from repro_torch.kernels.ref import dual_gemm_ref, pack_twinquant_weights

torch.set_num_threads(2)

M, N, RANK, SAMPLES = 128, 96, 16, 256
SHORT = dict(steps_global=3, steps_invert=3, steps_joint=2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.fixture(scope="module")
def layer():
    """The reference test's synthetic heavy-tailed layer: a few outlier
    input channels (LLM-like), as numpy."""
    key = jax.random.PRNGKey(42)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    w = jax.random.normal(k1, (M, N)) * 0.05
    idx = jax.random.choice(k2, M, (6,), replace=False)
    w = w.at[idx].mul(12.0)
    x = jax.random.normal(k3, (SAMPLES, M))
    x = x.at[:, idx].mul(8.0)
    x = x * (1 + jnp.abs(jax.random.t(k4, df=3.0, shape=(SAMPLES, M))))
    return np.asarray(x), np.asarray(w)


@pytest.fixture(scope="module")
def short_runs(layer):
    """(JAX result op by op, port result) of a 3 / 3 / 2-step calibration."""
    x, w = layer
    with jax.disable_jit():
        rj = JC.calibrate_layer(jnp.asarray(x), jnp.asarray(w), JC.CalibConfig(rank=RANK, **SHORT))
    rt = TC.calibrate_layer(_t(x), _t(w), TC.CalibConfig(rank=RANK, **SHORT), device="cpu")
    return rj, rt


def _loss_inputs(layer):
    """The smoothed decomposition (JAX's, alpha 0.5) as kwargs for both
    libraries' ``_layer_loss``."""
    x, w = layer
    d = JD.decompose(jnp.asarray(w), RANK, act_absmax=jnp.max(jnp.abs(x), axis=0), alpha=0.5)
    xh = jnp.asarray(x) / d.lam[None, :]
    y_ref = xh @ (d.U @ d.V + d.R)
    aj = JC.layer_quant_configs(M, RANK, JC.CalibConfig(rank=RANK))
    at = TC.layer_quant_configs(M, RANK, TC.CalibConfig(rank=RANK))
    arrs = dict(x=xh, y_ref=y_ref, U=d.U, V=d.V, R=d.R)
    kj = dict(arrs, **dict(zip(("aq", "uq", "vq", "rq"), aj)), reg_lambda=1e-3, a_bits=4)
    kt = dict({k: _t(v) for k, v in arrs.items()}, **dict(zip(("aq", "uq", "vq", "rq"), at)),
              reg_lambda=1e-3, a_bits=4)
    return kj, kt


@pytest.mark.parametrize("q_init", ["identity", "hadamard"])
def test_layer_loss_value_and_grads_match_reference(layer, q_init):
    kj, kt = _loss_inputs(layer)
    pj = {"Q": JT.orthogonal_init(M, q_init), "G": JT.gl_init(RANK)}
    with jax.disable_jit():
        (lj, rj), gj = jax.value_and_grad(lambda p: JC._layer_loss(p, **kj), has_aux=True)(pj)
    pt = {"Q": _t(pj["Q"]), "G": gl_params_from_numpy(jax.tree.map(np.asarray, pj["G"]),
                                                      device="cpu")}
    live = TM.tree_map(lambda t: t.detach().requires_grad_(True), pt)
    lt, rt = TC._layer_loss(live, **kt)
    gt = torch.autograd.grad(lt, TM.tree_leaves(live))
    assert _rel(float(lj), float(lt.detach())) <= 1e-5
    assert _rel(float(rj), float(rt.detach())) <= 1e-5
    q_tol = 1e-5 if q_init == "identity" else 0.02
    for name, a, b in zip(("P", "L", "gamma", "Q"), jax.tree.leaves(gj), gt):
        assert _rel(a, b.numpy()) <= (q_tol if name == "Q" else 1e-5), (name, _rel(a, b.numpy()))


def test_search_alpha_picks_reference_alpha(layer):
    x, w = layer
    for cfg in (dict(group_size=64), dict(group_size=128)):
        wq = dict(bits=4, axis=0, **cfg)
        aq = dict(bits=4, axis=-1, **cfg)
        with jax.disable_jit():
            aj, lj = JD.search_alpha(jnp.asarray(x), jnp.asarray(w), RANK,
                                     JC.QuantConfig(**wq), JC.QuantConfig(**aq))
        at, lt = TD.search_alpha(_t(x), _t(w), RANK, QuantConfig(**wq), QuantConfig(**aq))
        assert at == aj
        assert np.max(np.abs(np.asarray(lj) - lt.numpy())) <= 2e-6


def test_decompose_matches_reference(layer):
    x, w = layer
    am = np.abs(x).max(axis=0)
    dj = JD.decompose(jnp.asarray(w), RANK, act_absmax=jnp.asarray(am), alpha=0.5)
    dt = TD.decompose(_t(w), RANK, act_absmax=_t(am), alpha=0.5)
    assert dt.rank == RANK
    assert _rel(dj.lam, dt.lam.numpy()) <= 1e-6
    assert _rel(dj.U @ dj.V, (dt.U @ dt.V).numpy()) <= 1e-5  # sign-invariant
    assert _rel(dj.R, dt.R.numpy()) <= 1e-4
    xt, wt = TD.apply_smoothing(_t(x), _t(w), dt.lam)
    torch.testing.assert_close(xt @ wt, _t(x) @ _t(w), rtol=1e-4, atol=1e-3)


def _sign_matrix(rj, rt) -> np.ndarray:
    return np.sign(np.diag(np.asarray(rj.decomp.U).T @ rt.decomp.U.numpy()))


@pytest.mark.parametrize("what", ["init_loss", "history", "Q", "G", "G_inv"])
def test_short_calibration_matches_reference(short_runs, what):
    rj, rt = short_runs
    D = _sign_matrix(rj, rt)
    if what == "init_loss":
        assert _rel(rj.init_loss, rt.init_loss) <= 1e-5
        assert rt.final_loss <= rt.init_loss and len(rt.stage_seconds) == 3
    elif what == "history":
        assert len(rt.loss_history) == len(rj.loss_history) == 4
        h_j, h_t = np.asarray(rj.loss_history), np.asarray(rt.loss_history)
        assert np.max(np.abs(h_j - h_t) / h_j) <= 0.01
        assert _rel(rj.final_loss, rt.final_loss) <= 0.01
    elif what == "Q":
        assert np.max(np.abs(np.asarray(rj.Q) - rt.Q.numpy())) <= 1e-3
    else:
        a = np.asarray(getattr(rj, what))
        assert np.max(np.abs(D[:, None] * a * D[None, :] - getattr(rt, what).numpy())) <= 0.02


# ---------------------------------------------------------------------------
# the reference's integration checks, on the port
# ---------------------------------------------------------------------------


def _err(x, U, V, R, cfg: TC.CalibConfig) -> float:
    aq, uq, vq, rq = TC.layer_quant_configs(x.shape[1], U.shape[1], cfg)
    return float(TE.total_delta(x, U, V, R, aq, uq, vq, rq))


def test_calibration_improves_over_svd_and_hadamard(layer):
    x, w = map(_t, layer)
    cfg = TC.CalibConfig(rank=RANK, steps_global=80, steps_invert=80, steps_joint=40, lr=5e-3)
    res = TC.calibrate_layer(x, w, cfg, device="cpu")
    x_hat = x / res.decomp.lam[None, :]
    U, V, R = res.decomp.U, res.decomp.V, res.decomp.R
    err_svd = _err(x_hat, U, V, R, cfg)
    H = TT.hadamard_matrix(M)
    err_had = _err(x_hat @ H, H.T @ U, V, H.T @ R, cfg)
    Q, G, Gi = res.Q, res.G, res.G_inv
    err_twin = _err(x_hat @ Q, Q.T @ U @ G, Gi @ V, Q.T @ R, cfg)
    assert err_twin < err_svd, (err_twin, err_svd)
    assert err_twin < err_had, (err_twin, err_had)
    assert res.final_loss < res.init_loss * 0.97


def test_calibrated_q_is_orthogonal(layer):
    x, w = map(_t, layer)
    cfg = TC.CalibConfig(rank=RANK, steps_global=30, steps_invert=10, steps_joint=10, lr=2e-3)
    res = TC.calibrate_layer(x, w, cfg, device="cpu")
    assert float(TT.orthogonality_error(res.Q)) < 1e-3
    torch.testing.assert_close(res.G @ res.G_inv, torch.eye(RANK), rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def fold_run(layer):
    x, w = map(_t, layer)
    cfg = TC.CalibConfig(rank=RANK, steps_global=8, steps_invert=8, steps_joint=4, lr=2e-3)
    return x, TC.calibrate_layer(x, w, cfg, device="cpu")


def test_fold_offline_equivalence(fold_run):
    """The transformed decomposition reproduces X W_hat in full precision."""
    x, res = fold_run
    x_hat = x / res.decomp.lam[None, :]
    U, V, R = res.decomp.U, res.decomp.V, res.decomp.R
    y_ref = x_hat @ (U @ V + R)
    Q, G, Gi = res.Q, res.G, res.G_inv
    y_tr = (x_hat @ Q) @ ((Q.T @ U @ G) @ (Gi @ V) + (Q.T @ R))
    rel = float(torch.linalg.norm(y_tr - y_ref) / torch.linalg.norm(y_ref))
    assert rel < 2e-3, rel


@pytest.mark.parametrize("m", [8, 64])
def test_calibrated_pack_through_quant_linear_equals_dual_gemm_ref(fold_run, m):
    """The calibrated components, packed, through the routed entry point on
    the CPU (the plain version of the route's kernel): equal to the plain
    dual GEMM bit for bit."""
    x, res = fold_run
    U, V, R = res.decomp.U, res.decomp.V, res.decomp.R
    pack = pack_twinquant_weights(res.Q.T @ U @ res.G, res.G_inv @ V, res.Q.T @ R, a_bits=4)
    xq = ((x / res.decomp.lam[None, :]) @ res.Q)[:m].to(torch.bfloat16)
    dispatch.reset_dispatch_counters()
    y = dispatch.quant_linear(xq, pack)
    assert sum(dispatch.dispatch_counters().values()) >= 1
    assert torch.equal(y, dual_gemm_ref(xq, pack))
    assert y.shape == (m, N) and bool(torch.isfinite(y.float()).all())


def test_decomposition_reconstructs_exactly():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 48)).astype(np.float32))
    d = TD.decompose(w, rank=8)
    torch.testing.assert_close(d.reconstruct(), w * d.lam[:, None], rtol=0, atol=1e-4)


def test_svd_rank_reduces_residual_energy():
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((256, 128)).astype(np.float32))
    energies = [float(torch.sum(TD.svd_decompose(w, r)[2] ** 2)) for r in (8, 32, 64)]
    assert energies[0] > energies[1] > energies[2]


def test_alpha_search_returns_valid(layer):
    x, w = map(_t, layer)
    wq = QuantConfig(bits=4, group_size=64, axis=0)
    aq = QuantConfig(bits=4, group_size=64, axis=-1)
    alpha, lam = TD.search_alpha(x, w, RANK, wq, aq, alphas=(0.0, 0.5, 1.0))
    assert alpha in (0.0, 0.5, 1.0)
    assert lam.shape == (M,)
    assert bool(torch.all(lam > 0))


def test_zeta_gain_hadamard_on_outliers():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((512, 128)).astype(np.float32))
    x[:, 3] *= 50.0
    assert float(TE.zeta_gain(x, TT.hadamard_matrix(128))) > 2.0


def test_calib_result_bridge(short_runs):
    """``calib_result_from_numpy`` carries the reference's result across."""
    rj, _ = short_runs
    rb = calib_result_from_numpy(rj, device="cpu")
    assert torch.equal(rb.Q, _t(rj.Q)) and torch.equal(rb.G_inv, _t(rj.G_inv))
    assert torch.equal(rb.decomp.R, _t(rj.decomp.R)) and rb.decomp.rank == RANK
    assert rb.init_loss == rj.init_loss and rb.loss_history == list(rj.loss_history)


def test_entry_points_default_to_the_card(layer):
    """Without ``device`` the calibration asks for CUDA, and on a machine
    without a card it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    x, w = map(_t, layer)
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.calibrate_layer(x, w, TC.CalibConfig(rank=RANK, **SHORT))


def test_chip_smoke_calibration_phase_rehearses_on_cpu(capsys):
    """``chip_smoke.calibration_phase`` end to end at a tiny width on the CPU
    (plain versions stand in for the kernels): its gates pass and each
    calibrated pack equals the plain dual GEMM."""
    import sys
    from pathlib import Path

    from repro_torch.configs import ModelConfig

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = ModelConfig(name="tiny", d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                      vocab=260)
    chip_smoke.calibration_phase(torch.device("cpu"), "cpu", cfg, rows=256, steps=(20, 20, 10),
                                 cut_steps={"gate_up": (4, 4, 2), "down": (4, 4, 2)},
                                 sim_steps=(2, 2, 1))
    out = capsys.readouterr().out
    assert "calib q gates ok" in out
    assert out.count("kernel == plain: equal") == 4
    assert sum(f" {m} seconds=" in out for m in ("naive", "lowrank", "hadamard", "twinquant")) == 4
