"""The ``mamba_hybrid`` family (``zamba2-1.2b``) on the port, held to the
JAX package (``repro.models.mamba_hybrid``): configs and ``count_params``;
the SSD core (``_ssd_chunkwise``, ``_ssd_step``), ``_mamba_block``,
``_shared_attn`` and ``forward``; the prefill's gate (a bucket-padded
prefill leaves the unpadded one's state) with ``rest`` 0 and > 0; bucketed
and paged decode. The packs and the quantized serving path are in
``test_torch_zamba2_packs.py``.

Tolerances:
- The SSD core against the reference run op by op (``jax.disable_jit()``):
  relative Frobenius error <= 1e-5 in f32 (the einsums sum in other
  orders; XLA's and PyTorch's ``exp`` differ in the last bit).
- The Mamba block, the shared block: bf16 outputs and conv rows within rel
  0.01 of the jitted reference (bf16 matmul rows round otherwise).
- Model outputs (logits, state) within rel 0.05 of the jitted reference
  (readings 0.010 - 0.031: bf16 roundings placed otherwise, carried
  through the recurrence).
- The padded prefill's state ``torch.equal`` to the unpadded one's (the
  gate keeps every real step's update and no pad step's), its logits
  within rel 0.02; paged decode against bucketed rel < 0.02 (the paged
  plain version sums its softmax apart from the dense step's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import mamba_hybrid as JM
from repro.models import registry as JR
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.models import mamba_hybrid as TM
from repro_torch.models import registry as TR

torch.set_num_threads(2)

CFG = get_config("zamba2-1.2b", reduced=True)
JCFG = j_get_config("zamba2-1.2b", reduced=True).replace(remat=False)
REL = 0.05


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


def _toks(b, s, seed, vocab=CFG.vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _bridge(jp, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.fixture(scope="module")
def jparams():
    return JM.init_params(JCFG, jax.random.PRNGKey(2))


@pytest.fixture(scope="module")
def params(jparams):
    return _bridge(jparams, CFG)


# ---------------------------------------------------------------------------
# config, registry, count_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_reference_field_by_field(reduced):
    got, want = get_config("zamba2-1.2b", reduced), j_get_config("zamba2-1.2b", reduced)
    for f in dataclasses.fields(got):
        if f.name == "quant":
            assert dataclasses.asdict(got.quant) == dataclasses.asdict(want.quant)
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("padded_vocab", "d_inner_ssm", "n_ssm_heads", "sub_quadratic"):
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("over", [{}, {"n_layers": 7}], ids=["full", "rest"])
def test_count_params_and_registry(over):
    cfg = get_config("zamba2-1.2b").replace(**over)
    jc = j_get_config("zamba2-1.2b").replace(**over)
    m = TR.get_model(cfg)
    assert m.count_params(cfg) == JR.get_model(jc).count_params(jc)
    assert cfg.family == "mamba_hybrid" and getattr(m, "ragged_step", None) is None
    assert m.prefill is TM.prefill and m.decode_step is TM.decode_step
    small = CFG.replace(**over)
    n = sum(t.numel() for t in m.init_params(small, seed=0, device="cpu").buffers())
    assert n == m.count_params(small)[0]


@pytest.mark.parametrize("over", [{"shared_attn_every": 0}, {"n_layers": 1}],
                         ids=["every_0", "no_segment"])
def test_trunk_without_a_shared_segment_is_refused(over):
    """The port serves the trunk with its shared block: a config with no
    whole segment raises wherever the layout is read."""
    cfg = CFG.replace(**over)
    for call in (lambda: TM.count_params(cfg), lambda: TM.init_params(cfg, device="cpu"),
                 lambda: TM.init_decode_state(cfg, 1, 16, device="cpu")):
        with pytest.raises(ValueError, match="shared_attn_every"):
            call()


# ---------------------------------------------------------------------------
# the SSD core and the blocks
# ---------------------------------------------------------------------------


def _ssd_inputs(s, seed=0, b=2, h=4, p=32, n=16):
    rng = np.random.default_rng(seed)
    xs = jnp.asarray(rng.standard_normal((b, s, h, p)), jnp.bfloat16)
    dt = jax.nn.softplus(jnp.asarray(rng.standard_normal((b, s, h)), jnp.float32) - 2)
    A = -jnp.exp(jnp.asarray(rng.standard_normal(h) * 0.1, jnp.float32))
    Bm = jnp.asarray(rng.standard_normal((b, s, n)), jnp.bfloat16)
    Cm = jnp.asarray(rng.standard_normal((b, s, n)), jnp.bfloat16)
    st = jnp.asarray(rng.standard_normal((b, h, p, n)), jnp.float32)
    return xs, dt, A, Bm, Cm, st


def test_ssd_chunkwise_and_step_match_reference():
    """Two chunks carrying a nonzero state, and one recurrence step; the
    chunked form over S rows equals S recurrence steps."""
    args = _ssd_inputs(2 * TM.CHUNK)
    with jax.disable_jit():
        yj, sj = JM._ssd_chunkwise(*args)
        y1, s1 = JM._ssd_step(args[0][:, :1], args[1][:, :1], args[2], args[3][:, :1],
                              args[4][:, :1], args[5])
    yt, stt = TM._ssd_chunkwise(*(_t(a) for a in args))
    assert yt.dtype == stt.dtype == torch.float32
    assert _rel(yj, yt) <= 1e-5 and _rel(sj, stt) <= 1e-5
    y1t, s1t = TM._ssd_step(_t(args[0][:, :1]), _t(args[1][:, :1]), _t(args[2]),
                            _t(args[3][:, :1]), _t(args[4][:, :1]), _t(args[5]))
    assert _rel(y1, y1t) <= 1e-5 and _rel(s1, s1t) <= 1e-5
    xs, dt, A, Bm, Cm, st = (_t(a) for a in args)
    ys, s = [], st
    for i in range(16):
        y, s = TM._ssd_step(xs[:, i:i + 1], dt[:, i:i + 1], A, Bm[:, i:i + 1], Cm[:, i:i + 1], s)
        ys.append(y)
    xc = torch.cat([xs[:, :16], torch.zeros_like(xs[:, :TM.CHUNK - 16])], dim=1)
    dc = torch.cat([dt[:, :16], torch.zeros_like(dt[:, :TM.CHUNK - 16])], dim=1)
    yc, _ = TM._ssd_chunkwise(xc, dc, A, torch.cat([Bm[:, :16], Bm[:, 16:TM.CHUNK]], 1),
                              torch.cat([Cm[:, :16], Cm[:, 16:TM.CHUNK]], 1), st)
    assert _rel(torch.cat(ys, 1), yc[:, :16]) <= 1e-5


def _block_tree(jparams, seg=0, j=1):
    return jax.tree.map(lambda a: a[seg, j], jparams["m_layers"])


def test_mamba_block_matches_reference(jparams, params):
    """A block's chunked forward (S = CHUNK) and one decode step from its
    state: output, SSM state and conv rows (bf16 in_proj rows: rel 0.01)."""
    lj, lt = _block_tree(jparams), params.m_layers[0][1]
    x = jnp.asarray(np.random.default_rng(1).standard_normal((2, TM.CHUNK, CFG.d_model)),
                    jnp.bfloat16)
    blk = jax.jit(JM._mamba_block, static_argnums=(2, 5))
    oj, sj, cj = blk(lj, x, JCFG, None, None, False)
    o1, s1, c1 = blk(lj, x[:, :1], JCFG, sj, cj, True)
    ot, st, ct = TM._mamba_block(lt, _t(x), CFG)
    assert _rel(oj, ot) <= 0.01 and _rel(sj, st) <= REL and _rel(cj, ct) <= 0.01
    ssm, conv = st.clone(), ct.clone()
    o1t = TM._mamba_step(lt, _t(x[:, :1]), CFG, ssm, conv)
    assert _rel(o1, o1t) <= 0.01 and _rel(s1, ssm) <= REL and _rel(c1, conv) <= 0.01
    assert torch.equal(conv[:, :-1], ct[:, 1:])  # the conv rows shift by one


def test_shared_attn_matches_reference(jparams, params):
    """The shared block on concat(x, emb0) with its fixed RoPE, q / k / v
    three linears, the SwiGLU MLP and the adapter."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 12, CFG.d_model)), jnp.bfloat16)
    e = jnp.asarray(rng.standard_normal((2, 12, CFG.d_model)), jnp.bfloat16)
    ad = jax.tree.map(lambda a: a[1], jparams["adapters"])
    dj, _, _ = jax.jit(JM._shared_attn, static_argnums=(4,))(jparams["shared"], ad, x, e, JCFG)
    dt = TM._shared_attn(params.shared, params.adapters[1], _t(x), _t(e), CFG)
    assert dt.shape == (2, 12, CFG.d_model) and _rel(dj, dt) <= 0.01
    # the block's RoPE is fixed: another rope_theta in the config changes nothing
    other = TM._shared_attn(params.shared, params.adapters[1], _t(x), _t(e),
                            CFG.replace(rope_theta=500.0, rope_fraction=0.5))
    assert torch.equal(other, dt)


def test_forward_matches_reference(jparams, params):
    toks = _toks(2, 20, 0)
    lj = JM.forward(jparams, JCFG, jnp.asarray(toks))
    lt = TR.get_model(CFG).forward(params, CFG, _long(toks))
    assert lt.shape == (2, 20, CFG.padded_vocab) and _rel(lj, lt) <= REL


# ---------------------------------------------------------------------------
# prefill, decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layouts():
    """(config, reference params, port params) with rest 0 (the reduced
    config) and rest 1."""
    out = {}
    for name, over in (("rest0", {}), ("rest1", {"n_layers": 5})):
        cfg, jc = CFG.replace(**over), JCFG.replace(**over)
        jp = JM.init_params(jc, jax.random.PRNGKey(3))
        out[name] = (cfg, jc, jp, _bridge(jp, cfg))
    return out


@pytest.mark.parametrize("layout", ["rest0", "rest1"])
def test_prefill_gate_padded_equals_unpadded(layouts, layout):
    """A bucket-padded prefill (``length``) leaves the unpadded prefill's
    state exactly (every key, the shared block's cache included) and its
    logits; against the reference's padded prefill within tolerance; the
    input state left untouched."""
    cfg, jc, jp, pt = layouts[layout]
    b, s, pad = 2, 7, 9
    toks = _toks(b, s, 4)
    padded = np.concatenate([toks, np.full((b, pad), 5, np.int32)], axis=1)
    st0 = TM.init_decode_state(cfg, b, 32, device="cpu")
    la, sa = TM.prefill(pt, cfg, _long(toks), st0)
    lb, sb = TM.prefill(pt, cfg, _long(padded), st0, length=torch.full((b,), s))
    assert all(not v.any() for v in st0.values())
    assert sa.keys() == sb.keys() == st0.keys()
    assert ("ssm_rest" in sa) == (layout == "rest1")
    assert "shared_k" in sa
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    assert not differ, differ
    assert sb["pos"].tolist() == [s] * b and _rel(la, lb) < 0.02
    lj, sj = JM.prefill(jp, jc, jnp.asarray(padded), JM.init_decode_state(jc, b, 32),
                        length=jnp.full((b,), s, jnp.int32))
    assert _rel(lj, lb) <= REL
    for k in sb:
        if k != "pos":
            assert sb[k].shape == tuple(sj[k].shape) and _rel(sj[k], sb[k]) <= REL, k
    assert np.asarray(sj["pos"]).tolist() == [s] * b


def _paged(state: dict, page: int) -> dict:
    """The shared block's dense cache as page pools with the identity block
    table; the recurrent leaves stay per slot."""
    out = {k: v.clone() for k, v in state.items()}
    n_seg, b, s = state["shared_k"].shape[:3]
    maxp = s // page
    for key in ("shared_k", "shared_v"):
        out[key] = state[key].reshape(n_seg, b * maxp, page, *state[key].shape[3:]).clone()
    out["bt"] = torch.arange(b * maxp, dtype=torch.int32).reshape(b, maxp)
    return out


@pytest.mark.parametrize("layout", ["rest0", "rest1"])
def test_decode_bucketed_and_paged(layouts, layout):
    """Three decode steps from a prefill: bucketed against the reference
    (the state updated in place: ``ssm`` / ``conv`` every layer, the shared
    rows at ``pos``), paged against bucketed (the rows land in the pools)."""
    cfg, jc, jp, pt = layouts[layout]
    b, s = 2, 6
    toks = _toks(b, s, 5)
    _, sj = JM.prefill(jp, jc, jnp.asarray(toks), JM.init_decode_state(jc, b, 32))
    _, st = TM.prefill(pt, cfg, _long(toks), TM.init_decode_state(cfg, b, 32, device="cpu"))
    sp = _paged(st, 8)
    ssm0 = st["ssm"].clone()
    tok = np.array([[3], [9]], np.int32)
    for i in range(3):
        lj, sj = JM.decode_step(jp, jc, sj, jnp.asarray(tok))
        lt, st2 = TM.decode_step(pt, cfg, st, _long(tok))
        lp, sp2 = TM.decode_step(pt, cfg, sp, _long(tok))
        assert st2 is st and sp2 is sp and st["pos"].tolist() == [s + i + 1] * b
        assert _rel(lj, lt) <= REL and _rel(lt, lp) < 0.02
        tok = np.argmax(_f32(lt)[:, :, :cfg.vocab], axis=-1).astype(np.int32)
    for k in ("ssm", "conv", "ssm_rest", "conv_rest"):
        if k in st:
            assert _rel(sj[k], st[k]) <= REL, k
    assert not torch.equal(st["ssm"], ssm0)
    n_seg = st["shared_k"].shape[0]
    pooled = sp["shared_k"].reshape(n_seg, b, 32, *sp["shared_k"].shape[3:])
    assert _rel(st["shared_k"][:, :, :s + 3], pooled[:, :, :s + 3]) < 0.02
    assert _rel(_f32(sj["shared_k"])[:, :, :s + 3], st["shared_k"][:, :, :s + 3]) <= REL


def test_prefix_argument_is_refused(params):
    with pytest.raises(ValueError, match="prefix"):
        TM.prefill(params, CFG, _long(_toks(1, 4, 0)),
                   TM.init_decode_state(CFG, 1, 16, device="cpu"), prefix={"shared_k": None})
