"""The ``xlstm`` family (``xlstm-1.3b``) on the port, held to the JAX
package (``repro.models.xlstm``): configs, ``count_params`` and the
registry entry; the chunk choice and the trunk's pad; the causal conv, the
chunkwise mLSTM core (S = 256, 512 and 2048, the last in 1024-row chunks),
its recurrent step and the sLSTM cell; ``forward``, the gated ``prefill``
and ``decode_step``; the port's teacher-forced decode against its forward;
the engine bucketed and ``paged=True`` (the dense per-slot layout). The
packs and the quantized path are in ``test_torch_xlstm_packs.py``.

Tolerances:
- ``_causal_conv`` bit-equal to the reference (its sum order and dtype
  are the reference's); ``_mlstm_step``'s h (bf16) bit-equal, its f32
  state within rel 1e-6 (XLA's and PyTorch's log-sigmoid and exp differ in
  the last bit).
- The chunkwise core against the jitted reference (the same figures run
  op by op): h within rel 5e-4 (h is bf16, and the f32 einsums and
  cumsum sum in other orders, which flips a few bf16 roundings; readings
  4e-6 - 1.3e-4), the f32 state within rel 2e-5 (readings 2e-7 - 4.4e-6).
- The sLSTM cell: h bit-equal, the f32 state within rel 1e-6 (log-sigmoid
  and exp in the last bit; readings ~1e-7).
- Model outputs (logits, state) within rel 0.05 of the jitted reference
  (readings 0.007 - 0.023: XLA keeps bf16 intermediates in f32, and the
  recurrence carries those roundings on).
- One decode step against the reference run op by op (``jax.disable_jit``):
  logits and the bf16 conv rows bit-equal, the f32 states within rel 1e-6.
- The padded prefill's state ``torch.equal`` to the unpadded one's and
  its logits too; the port's teacher-forced decode against its forward
  within rel 0.01 (reading 0: the recurrent form rounds to the same bf16
  outputs here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import registry as JR
from repro.models import xlstm as JX
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.models import registry as TR
from repro_torch.models import xlstm as TX

torch.set_num_threads(2)

CFG = get_config("xlstm-1.3b", reduced=True)
JCFG = j_get_config("xlstm-1.3b", reduced=True).replace(remat=False)
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


def _toks(b, s, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def jparams():
    return JX.init_params(JCFG, jax.random.PRNGKey(3))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


@pytest.fixture(scope="module")
def prefilled(jparams, params):
    """A bucket-16 prefill of an 11-token prompt, jitted reference and
    port: (tokens, reference (logits, state), port (logits, state))."""
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = _toks(1, 11, 5)[0]
    jst = JX.init_decode_state(JCFG, 1, 64)
    want = jax.jit(lambda p, t, s, n: JX.prefill(p, JCFG, t, s, length=n))(
        jparams, toks, jst, jnp.asarray([11]))
    got = TX.prefill(params, CFG, _long(toks), TX.init_decode_state(CFG, 1, 64, device="cpu"),
                     length=torch.tensor([11]))
    return toks, want, got


# ---------------------------------------------------------------------------
# config, registry, count_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_reference_field_by_field(reduced):
    got, want = get_config("xlstm-1.3b", reduced), j_get_config("xlstm-1.3b", reduced)
    for f in dataclasses.fields(got):
        if f.name == "quant":
            assert dataclasses.asdict(got.quant) == dataclasses.asdict(want.quant)
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("padded_vocab", "sub_quadratic", "has_decoder"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert (TX._dims(got), TX._qk_dim(got), TX._segments(got)) == (
        JX._dims(want), JX._qk_dim(want), JX._segments(want))


@pytest.mark.parametrize("over", [{}, {"slstm_every": 0}, {"n_layers": 16}],
                         ids=["full", "mlstm_only", "two_segments"])
def test_count_params_and_registry(over):
    """``count_params`` is the reference's formula; it counts the mLSTM
    ``gn`` twice and one norm too many a sLSTM block, so a model's buffers
    hold n_m * d_inner + n_seg * d fewer elements than it says, as the
    reference's parameters do."""
    cfg, jc = get_config("xlstm-1.3b").replace(**over), j_get_config("xlstm-1.3b").replace(**over)
    m = TR.get_model(cfg)
    assert m.count_params(cfg) == JR.get_model(jc).count_params(jc)
    assert (cfg.total_params(), cfg.active_params()) == (jc.total_params(), jc.active_params())
    assert cfg.family == "xlstm" and getattr(m, "ragged_step", None) is None
    assert m.prefill is TX.prefill and m.decode_step is TX.decode_step
    small = CFG.replace(**over)
    n_seg, m_per = TX._segments(small)
    n_m = n_seg * m_per if n_seg else small.n_layers
    n = sum(t.numel() for t in m.init_params(small, seed=0, device="cpu").buffers())
    assert n == m.count_params(small)[0] - n_m * TX._dims(small)[0] - n_seg * small.d_model


def test_partial_segment_is_refused():
    cfg = CFG.replace(n_layers=5)
    with pytest.raises(ValueError, match="slstm_every"):
        TX.init_decode_state(cfg, 1, 16, device="cpu")
    with pytest.raises(AssertionError):
        JX._segments(cfg)


def test_chunk_choice_and_trunk_pad():
    for s in (1, 255, 256, 700, 1024, 1500, 2048, 3072, 4096):
        assert TX._pick_chunk(s) == JX._pick_chunk(s), s


# ---------------------------------------------------------------------------
# the cores
# ---------------------------------------------------------------------------


def _core_inputs(s, seed, b=1, h=2, dqk=16, dv=32):
    rng = np.random.default_rng(seed)

    def bf(*shape, shift=0.0):
        return jnp.asarray(rng.standard_normal(shape) + shift, jnp.bfloat16)

    st = {"C": jnp.asarray(rng.standard_normal((b, h, dqk, dv)), jnp.float32),
          "n": jnp.asarray(rng.standard_normal((b, h, dqk)), jnp.float32),
          "m": jnp.asarray(rng.standard_normal((b, h)), jnp.float32)}
    return (bf(b, s, h, dqk), bf(b, s, h, dqk), bf(b, s, h, dv), bf(b, s, h),
            bf(b, s, h, shift=3.0)), st


@pytest.mark.parametrize("s", [256, 512, 2048])
def test_mlstm_chunkwise_against_reference(s):
    """One chunk of 256, two of 256 (the carried inter-chunk state) and two
    of 1024 (CHUNK), from a random state and from the fresh one (m
    -1e30)."""
    args, st = _core_inputs(s, s)
    fresh = {"C": jnp.zeros_like(st["C"]), "n": jnp.zeros_like(st["n"]),
             "m": jnp.full_like(st["m"], -1e30)}
    for state in (st, fresh):
        hj, sj = jax.jit(JX._mlstm_chunkwise)(*args, state)
        ht, stt = TX._mlstm_chunkwise(*(_t(a) for a in args), {k: _t(v) for k, v in state.items()})
        assert ht.dtype == torch.bfloat16 and _rel(hj, ht) <= 5e-4
        for k in ("C", "n", "m"):
            assert _rel(sj[k], stt[k]) <= 2e-5, k


def test_mlstm_step_against_reference():
    args, st = _core_inputs(1, 1, b=2)
    with jax.disable_jit():
        hj, sj = JX._mlstm_step(*args, st)
    ht, stt = TX._mlstm_step(*(_t(a) for a in args), {k: _t(v) for k, v in st.items()})
    assert torch.equal(ht, _t(hj))
    for k in ("C", "n", "m"):
        assert _rel(sj[k], stt[k]) <= 1e-6, k


def test_causal_conv_bit_equal_to_reference():
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 7, 32)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 32)) * 0.1, jnp.bfloat16)
    state = jnp.asarray(rng.standard_normal((2, 3, 32)), jnp.bfloat16)
    for st in (None, state):
        with jax.disable_jit():
            oj, nj = JX._causal_conv(x, w, st)
        ot, nt = TX._causal_conv(_t(x), _t(w), None if st is None else _t(st))
        assert torch.equal(ot, _t(oj)) and torch.equal(nt, _t(nj))


def test_slstm_cell_against_reference(jparams, params):
    lp = jax.tree.map(lambda a: a[1], jparams["s_layers"])
    x = jnp.asarray(np.random.default_rng(2).standard_normal((2, 12, CFG.d_model)), jnp.bfloat16)
    hj, sj = jax.jit(lambda p, v: JX._slstm_cell(p, v, JCFG))(lp, x)
    ht, st = TX._slstm_cell(params.s_layers[1], _t(x), CFG)
    assert torch.equal(ht, _t(hj))
    for k in ("h", "c", "n", "m"):
        assert _rel(sj[k], st[k]) <= 1e-6, k


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_against_reference(jparams, params):
    """300 tokens: the trunk pads to 512 rows, two 256-row chunks."""
    toks = _toks(1, 300, 6)
    want = jax.jit(lambda p, t: JX.forward(p, JCFG, t))(jparams, toks)
    got = TX.forward(params, CFG, _long(toks))
    assert got.shape == (1, 300, CFG.padded_vocab) and _rel(want, got) <= REL


def test_prefill_against_reference_and_padding(params, prefilled):
    """The gated prefill: logits and every state leaf within rel of the
    reference; the bucket-padded prefill leaves the unpadded one's state
    and logits, bit for bit; the input state is left as it was."""
    toks, (lj, sj), (lt, st) = prefilled
    assert _rel(lj, lt) <= REL
    assert int(st["pos"][0]) == int(sj["pos"][0]) == 11
    for k in sj:
        if k != "pos":
            assert _rel(sj[k], st[k]) <= REL, k
    fresh = TX.init_decode_state(CFG, 1, 64, device="cpu")
    lu, su = TX.prefill(params, CFG, _long(toks[:, :11]), fresh)
    assert torch.equal(lu, lt)
    for k in st:
        assert torch.equal(su[k], st[k]), k
    assert all(torch.equal(v, TX.init_decode_state(CFG, 1, 64, device="cpu")[k])
               for k, v in fresh.items())


def test_decode_step_bit_equal_to_reference_op_by_op(jparams, params, prefilled):
    """One decode step from the prefilled state: the reference run op by
    op gives the same logits and conv rows bit for bit; the step updates
    the port's state in place (the same dict and storage)."""
    _, (_, sj), (_, st) = prefilled
    tok = np.array([[7]], np.int32)
    with jax.disable_jit():
        lj, nj = JX.decode_step(jparams, JCFG, sj, jnp.asarray(tok))
    state = {k: _t(v) for k, v in sj.items()}
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    lt, nt = TX.decode_step(params, CFG, state, _long(tok))
    assert nt is state and {k: v.data_ptr() for k, v in nt.items()} == ptrs
    assert torch.equal(lt, _t(lj))
    assert torch.equal(nt["conv"], _t(nj["conv"])) and torch.equal(nt["pos"], _t(nj["pos"]))
    for k in ("mC", "mn", "mm", "sh", "sc", "sn", "sm"):
        assert _rel(nj[k], nt[k]) <= 1e-6, k


def test_teacher_forced_decode_matches_forward(params):
    toks = _toks(1, 24, 9)
    want = TX.forward(params, CFG, _long(toks))
    st = TX.init_decode_state(CFG, 1, 64, device="cpu")
    got = torch.cat([TX.decode_step(params, CFG, st, _long(toks[:, i:i + 1]))[0]
                     for i in range(24)], dim=1)
    assert _rel(want, got) <= 0.01
    assert int(st["pos"][0]) == 24


def test_pure_mlstm_model_runs(jparams):
    """``slstm_every`` 0: the flat (n_layers, ...) layout, bridged from the
    reference, forward and decode within rel of it."""
    cfg, jc = CFG.replace(slstm_every=0, n_layers=2), JCFG.replace(slstm_every=0, n_layers=2)
    jp = JX.init_params(jc, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert tp.s_layers is None and len(tp.m_layers) == 2
    toks = _toks(1, 9, 2)
    assert _rel(jax.jit(lambda p, t: JX.forward(p, jc, t))(jp, toks),
                TX.forward(tp, cfg, _long(toks))) <= REL
    st = TX.init_decode_state(cfg, 2, 16, device="cpu")
    assert set(st) == {"mC", "mn", "mm", "conv", "pos"} and st["mC"].shape[:2] == (2, 2)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _serve(params, prompts, **kw):
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new=6) for p in prompts]
    eng.serve(reqs)
    assert all(r.status == "DONE" for r in reqs)
    return eng, [r.out for r in reqs]


def test_engine_paged_is_the_dense_per_slot_layout(params):
    """The reference's ``test_engine_recurrent_family``: a purely recurrent
    state has nothing to page, so ``paged=True`` builds no pool, allocator
    or block table (and warns that it serves no prefix cache); its tokens
    equal the bucketed engine's and each request's served alone. Ragged
    and speculation warn and fall back."""
    prompts = [np.asarray(_toks(1, n, 20 + n)[0]) for n in (3, 9, 20, 5)]
    eng_b, want = _serve(params, prompts)
    with pytest.warns(UserWarning, match="prefix_caching"):
        eng_p, got = _serve(params, prompts, paged=True)
    assert got == want
    assert eng_p.allocator is None and eng_p.prefix_cache is None and eng_p.n_pages == 0
    assert "bt" not in eng_p.state and eng_p.memory()["mode"] == "dense"
    assert {k: v.shape for k, v in eng_p.state.items()} == {
        k: v.shape for k, v in TX.init_decode_state(CFG, 2, 64, device="cpu").items()}
    for p, w in zip(prompts, want):
        assert _serve(params, [p])[1] == [w]
    for kw in (dict(ragged=True), dict(speculation=True)):
        with pytest.warns(UserWarning):
            eng, out = _serve(params, prompts[:1], paged=True, prefix_caching=False, **kw)
        assert not eng.ragged and not eng.speculation and out == want[:1]
