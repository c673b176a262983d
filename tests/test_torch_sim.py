"""The port's evaluation (simulation) path held to the JAX package's:
``build_sim_linear`` per method, ``SimLinear`` against the reference's
``linear`` on the same sim dict, ``forward_with_taps`` and
``simulate_quantize_params`` at model level, on a dense config with d_model
256 (``_eligible`` needs K >= 256), one layer, params bridged from JAX.

Tolerances:

* ``build_sim_linear``: ``naive`` bit-equal (RTN of the same f32 weight);
  ``lowrank`` / ``hadamard``: the dequantized product ``u_dq @ v_dq`` (the
  SVD's sign choice cancels in it) and ``r_dq`` within relative 0.02, ``Q``
  bit-equal — the two libraries' SVDs differ in the last bits, which moves a
  few 4-bit roundings; ``twinquant`` (JAX op by op, 1 / 1 / 1 steps):
  ``lam`` within 1e-6, the rest within 0.05 (its calibration adds the
  trajectory drift of tests/test_torch_calibration.py);
* ``SimLinear`` vs ``linear`` on one bridged sim dict: f32 input relative
  1e-5, bf16 input 0.02 (the matmuls round to bf16 in other orders);
* ``forward_with_taps``: logits and taps relative 0.03, as the bf16 dense
  model (tests/test_torch_dense.py);
* ``simulate_quantize_params`` logits: W4A8 relative 0.08 (bf16 rounding
  plus activation rounding flips, as the W4A8 dense model). At W4A4 the
  4-bit activations turn bf16 differences into quantization flips layer
  after layer, so the port is held as the W4A4 dense model is: difference
  <= 0.5 and its error against the bf16 reference within 5% of the
  reference's own. twinquant is held to JAX linear by linear
  (``build_sim_linear``); at model level the port's run is checked for its
  taps and against its own ``build_sim_linear`` bit for bit, since the
  reference's model-level calibration compiles one XLA step per linear
  (minutes of the suite's time on a loaded machine).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.configs import QuantSpec as JQS
from repro.core import calibration as JC
from repro.core import twinquant as JTQ
from repro.models import common as JCm
from repro.models import dense as JD
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core import calibration as TC
from repro_torch.core import twinquant as TTQ
from repro_torch.interop import _linear, params_from_numpy, to_torch
from repro_torch.models import common as TCm
from repro_torch.models import dense as TD

torch.set_num_threads(2)

KW = dict(name="simtest", family="dense", n_layers=1, d_model=256, n_heads=4, n_kv_heads=2,
          head_dim=64, d_ff=512, vocab=260)
JCFG, TCFG = JCfg(**KW, remat=False), ModelConfig(**KW)
STEPS = dict(steps_global=2, steps_invert=2, steps_joint=1)


def _f(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.fixture(scope="module")
def model():
    """(JAX params, the port's bridged model, tokens (2, 32), JAX logits,
    JAX taps + a (1, 64, d_ff) tap for the down projection, the same taps as
    tensors)."""
    pj = JD.init_params(JCFG, jax.random.PRNGKey(0))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), TCFG, "cpu")
    toks = np.random.default_rng(0).integers(0, KW["vocab"], size=(2, 32))
    lj, tj = JD.forward_with_taps(pj, JCFG, jnp.asarray(toks))
    down = np.random.default_rng(1).standard_normal((1, 64, KW["d_ff"])).astype(np.float32)
    # "down" first: the first key found in a path names its tap
    taps_j = {"down": jnp.asarray(down), "attn": tj["attn"], "mlp": tj["mlp"]}
    taps_t = {k: to_torch(np.asarray(v), "cpu") for k, v in taps_j.items()}
    return pj, pt, toks, lj, tj, taps_j, taps_t


def test_forward_with_taps_matches_reference(model):
    _, pt, toks, lj, tj, _, _ = model
    lt, tt = TD.forward_with_taps(pt, TCFG, torch.from_numpy(toks))
    assert tuple(tt["attn"].shape) == (1, 64, KW["d_model"]) == tuple(tt["mlp"].shape)
    assert _rel(_f(lj), _f(lt)) <= 0.03
    for k in ("attn", "mlp"):
        assert _rel(_f(tj[k]), _f(tt[k])) <= 0.03, k
    # the taps ride along the plain forward: the same logits bit for bit
    assert torch.equal(lt, TD.forward(pt, TCFG, torch.from_numpy(toks)))


def _w_and_x():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((256, 128)).astype(np.float32) * 0.06
    w[::37] *= 10.0  # outlier input channels
    x = rng.standard_normal((64, 256)).astype(np.float32)
    return w, x


@pytest.mark.parametrize("method", ["naive", "lowrank", "hadamard", "twinquant"])
def test_build_sim_linear_matches_reference(method):
    w, x = _w_and_x()
    spec_j, spec_t = JQS(mode="w4a4", rank=32), QuantSpec(mode="w4a4", rank=32)
    cc_j, cc_t = JC.CalibConfig(rank=32, **STEPS), TC.CalibConfig(rank=32, **STEPS)
    with jax.disable_jit():
        dj = JTQ.build_sim_linear(jnp.asarray(w), method, spec_j, jnp.asarray(x), cc_j)
    st = TTQ.build_sim_linear(torch.from_numpy(w), method, spec_t, torch.from_numpy(x), cc_t,
                              device="cpu")
    assert st.a_bits == dj["abits"].shape[-1] == 4
    assert (st.Q is None) == ("Q" not in dj) and (st.u_dq is None) == ("u_dq" not in dj)
    if method == "naive":
        np.testing.assert_array_equal(_f(st.r_dq), _f(dj["r_dq"]))
        np.testing.assert_array_equal(_f(st.lam), _f(dj["lam"]))
        return
    tol = 0.05 if method == "twinquant" else 0.02
    uv_j = _f(dj["u_dq"]) @ _f(dj["v_dq"])
    uv_t = _f(st.u_dq) @ _f(st.v_dq)
    assert _rel(uv_j, uv_t) <= tol, _rel(uv_j, uv_t)
    assert _rel(_f(dj["r_dq"]), _f(st.r_dq)) <= tol, _rel(_f(dj["r_dq"]), _f(st.r_dq))
    if method == "hadamard":
        np.testing.assert_array_equal(_f(st.Q), _f(dj["Q"]))
    if method == "twinquant":
        assert np.max(np.abs(_f(dj["lam"]) - _f(st.lam))) <= 1e-6
        assert _rel(_f(dj["Q"]), _f(st.Q)) <= tol


@pytest.fixture(scope="module")
def hadamard_sim():
    """The reference's hadamard sim dict plus a bias, and its bridge (built
    once for both dtypes)."""
    w, _ = _w_and_x()
    d = JTQ.build_sim_linear(jnp.asarray(w), "hadamard", JQS(mode="w4a4", rank=32))
    d["lam"] = jnp.asarray(np.random.default_rng(3).uniform(0.5, 2.0, 256), jnp.float32)
    d["b"] = jnp.asarray(np.random.default_rng(4).standard_normal(128), jnp.float32)
    return d, _linear(jax.tree.map(np.asarray, d), "cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sim_linear_matches_reference_linear(hadamard_sim, dtype):
    """One sim dict (the reference's hadamard sim plus a bias) through the
    reference's ``linear`` and, bridged by ``interop``, the port's
    ``SimLinear``."""
    d, sim = hadamard_sim
    assert isinstance(sim, TCm.SimLinear) and sim.a_bits == 4
    x = np.random.default_rng(5).standard_normal((2, 8, 256)).astype(np.float32) * 2
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    xj = jnp.asarray(x, jd)
    yj = JCm.linear(d, xj)
    yt = TCm.linear(sim, to_torch(np.asarray(xj), "cpu"))
    assert yt.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert _rel(_f(yj), _f(yt)) <= (1e-5 if dtype == "f32" else 0.02)


def test_sim_linears_run_per_sibling_and_never_fuse():
    """``linear_group`` runs sim siblings one ``linear`` each; ``fuse_params``
    leaves them unfused."""
    w, _ = _w_and_x()
    spec = QuantSpec(mode="w4a4", rank=32)
    sims = {n: TTQ.build_sim_linear(torch.from_numpy(w * s), "lowrank", spec, device="cpu")
            for n, s in (("q", 1.0), ("k", 0.5), ("v", 2.0))}
    group = torch.nn.ModuleDict(sims)
    x = torch.randn(1, 4, 256, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    ys = TCm.linear_group(group, ("q", "k", "v"), "qkv", x)
    for n, y in zip(("q", "k", "v"), ys):
        assert torch.equal(y, sims[n](x))
    fused = TTQ.fuse_params(torch.nn.ModuleDict({"attn": torch.nn.ModuleDict(sims)}))
    assert sorted(fused["attn"].keys()) == ["k", "q", "v"]


def test_simulate_taps_by_path_and_layer(monkeypatch):
    """The tap rule: the first key found in the path; a (L, T, K) tap gives
    layer i its block i; a tap of another width is dropped (down's d_ff)."""
    cfg = TCFG.replace(n_layers=2)
    model = TD.init_params(cfg, seed=0, device="cpu")
    seen = {}

    def spy(w, method, spec, calib_x=None, calib_cfg=None, device=None):
        seen[len(seen)] = (tuple(w.shape), calib_x)
        return TCm.SimLinear(torch.ones(w.shape[0]), w.to(torch.bfloat16), spec.a_bits)

    monkeypatch.setattr(TTQ, "build_sim_linear", spy)
    attn = torch.arange(2 * 3 * 256, dtype=torch.float32).reshape(2, 3, 256)
    mlp = torch.zeros(5, 256)
    out = TTQ.simulate_quantize_params(model, cfg, QuantSpec("w4a4", rank=32), "naive",
                                       {"attn": attn, "mlp": mlp}, device="cpu")
    assert isinstance(out.layers[1].attn["q"], TCm.SimLinear)
    assert isinstance(out.head, TCm.Linear)  # the lm head stays bf16
    got = [seen[i] for i in range(len(seen))]
    assert len(got) == 2 * 7
    for i in range(2):
        q, k, v, o, gate, up, down = got[7 * i:7 * i + 7]
        for _, tap in (q, k, v, o):
            assert torch.equal(tap, attn[i])
        for _, tap in (gate, up):
            assert tap is mlp
        assert down[0] == (512, 256) and down[1] is mlp  # dropped inside build_sim_linear


def _sim_logits(model, mode, method):
    pj, pt, toks, lj, _, taps_j, taps_t = model
    a_bits = QuantSpec(mode=mode).a_bits
    sj = JTQ.simulate_quantize_params(pj, JCFG, JQS(mode=mode, rank=32), method, taps_j,
                                      JC.CalibConfig(rank=32, a_bits=a_bits, **STEPS))
    st = TTQ.simulate_quantize_params(pt, TCFG, QuantSpec(mode=mode, rank=32), method, taps_t,
                                      TC.CalibConfig(rank=32, a_bits=a_bits, **STEPS),
                                      device="cpu")
    gj = _f(JD.forward(sj, JCFG, jnp.asarray(toks)))
    gt = _f(TD.forward(st, TCFG, torch.from_numpy(toks)))
    return _f(lj), gj, gt


@pytest.mark.parametrize("method", ["naive", "lowrank", "hadamard"])
def test_simulate_quantize_params_w4a8_matches_reference(model, method):
    _, gj, gt = _sim_logits(model, "w4a8", method)
    assert np.isfinite(gt).all()
    assert _rel(gj, gt) <= 0.08, _rel(gj, gt)


@pytest.mark.parametrize("method", ["naive", "hadamard"])
def test_simulate_quantize_params_w4a4_matches_reference(model, method):
    ref, gj, gt = _sim_logits(model, "w4a4", method)
    assert _rel(gj, gt) <= 0.5, _rel(gj, gt)
    e_j, e_t = _rel(ref, gj), _rel(ref, gt)
    assert abs(e_t - e_j) <= 0.05 * e_j, (e_t, e_j)


def test_simulate_twinquant_calibrates_each_linear_on_its_tap(model, monkeypatch):
    """Model-level twinquant on the port: each linear calibrates on its own
    tap (q/k/v/o the bf16 ln1 outputs, gate/up the ln2 outputs, down its
    own), and each sim module equals ``build_sim_linear`` on that weight and
    tap (the calibration itself is held to JAX above, linear by linear)."""
    _, pt, toks, lj, _, _, taps = model
    spec = QuantSpec(mode="w4a8", rank=32)
    cc = TC.CalibConfig(rank=32, a_bits=8, **STEPS)
    real, seen = TTQ.calibrate_layer, []

    def spy(x, w, cfg, generator=None, device=None):
        seen.append((x, tuple(w.shape)))
        return real(x, w, cfg, generator, device)

    monkeypatch.setattr(TTQ, "calibrate_layer", spy)
    st = TTQ.simulate_quantize_params(pt, TCFG, spec, "twinquant", taps, cc, device="cpu")
    layer, src = st.layers[0], pt.layers[0]
    want = [("attn", tuple(m.w.shape)) for m in src.attn.values()] + [
        ("down" if n == "down" else "mlp", tuple(m.w.shape)) for n, m in src.mlp.items()]
    assert len(want) == 7 and [shape for _, shape in seen] == [shape for _, shape in want]
    for (x, _), (key, _) in zip(seen, want):
        assert x.dtype == taps[key].dtype and torch.equal(x, taps[key][0]), key
    for part, name, key in (("attn", "q", "attn"), ("mlp", "down", "down")):
        one = TTQ.build_sim_linear(getattr(src, part)[name].w, "twinquant", spec, taps[key][0],
                                   cc, device="cpu")
        got = getattr(layer, part)[name]
        for buf in ("lam", "Q", "u_dq", "v_dq", "r_dq"):
            assert torch.equal(getattr(got, buf), getattr(one, buf)), (name, buf)
    lg = _f(TD.forward(st, TCFG, torch.from_numpy(toks)))
    assert np.isfinite(lg).all() and _rel(_f(lj), lg) < 1.0


def test_sim_variants_ordering():
    """The reference's ordering check on the port's own model: W4A8 beats
    W4A4; on outlier-structured weights lowrank beats naive."""
    cfg = TCFG.replace(n_layers=2)
    model = TD.init_params(cfg, seed=0, device="cpu")
    for layer in model.layers:
        for lin in list(layer.attn.values()) + list(layer.mlp.values()):
            if lin.w.shape[0] >= 256:
                rows = torch.arange(0, lin.w.shape[0], 37)
                lin.w[rows] = (lin.w[rows].float() * 10.0).to(lin.w.dtype)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 32)))
    ref = TD.forward(model, cfg, toks).float()

    def fid(method, mode):
        qp = TTQ.simulate_quantize_params(model, cfg, QuantSpec(mode=mode, rank=32), method,
                                          device="cpu")
        return float(torch.linalg.norm(TD.forward(qp, cfg, toks).float() - ref))

    e_naive, e_low, e_low8 = fid("naive", "w4a4"), fid("lowrank", "w4a4"), fid("lowrank", "w4a8")
    assert e_low < e_naive, (e_low, e_naive)
    assert e_low8 < e_low, (e_low8, e_low)
