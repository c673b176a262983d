"""The ``encdec`` family (``whisper-base``) on the port, held to the JAX
package (``repro.models.encdec``): configs and ``count_params``; the
LayerNorm, the tanh GELU and the sinusoid; ``encode``, ``forward``,
``prefill`` with ``frames`` and ``length``; bucketed and paged
``decode_step``; teacher-forced decode against the forward (the
reference's ``test_decode_matches_forward[whisper-base]``). The packs and
the quantized serving path are in ``test_torch_whisper_packs.py``.

Tolerances:
- LayerNorm bit-equal to the reference run op by op (``jax.disable_jit()``);
  the GELU within rtol 1e-6 / atol 5e-7 of it (XLA's and PyTorch's ``tanh``
  differ in the last bits); the bf16 sinusoid within one bf16 ULP plus 1e-4 of it
  (24 of 66048 values differ at positions up to 896: the two libraries'
  f32 sin / cos of large angles differ in the last bits, 6e-5 of the angle
  at 900), bit-equal up to position 35.
- Model outputs (encoder states, logits, cache rows) within relative
  Frobenius error 0.02 of the jitted reference, which fuses and reorders
  the f32 reductions of LayerNorm, softmax and the GELU (readings 0.004 -
  0.008).
- A bucket-padded prefill against the unpadded one, paged decode against
  bucketed: rel < 0.02 (bf16 rounding in other places; paged decode's
  plain version sums its softmax apart from the dense step's). Decode
  against the forward: the reference's own 0.05 of the largest logit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import common as JC
from repro.models import encdec as JE
from repro.models import registry as JR
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.models import common as C
from repro_torch.models import encdec as TE
from repro_torch.models import registry as TR

torch.set_num_threads(2)

CFG = get_config("whisper-base", reduced=True)
JCFG = j_get_config("whisper-base", reduced=True).replace(remat=False)
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
    return np.random.default_rng(seed).integers(0, CFG.vocab, (b, s)).astype(np.int32)


def _frames(seed, b=1):
    return jax.random.normal(jax.random.PRNGKey(seed), (b, CFG.n_frames, CFG.d_model),
                             jnp.bfloat16)


def _long(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


@pytest.fixture(scope="module")
def jparams():
    return JE.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


# ---------------------------------------------------------------------------
# config, registry, count_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_reference_field_by_field(reduced):
    got, want = get_config("whisper-base", reduced), j_get_config("whisper-base", reduced)
    for f in dataclasses.fields(got):
        if f.name == "quant":
            assert dataclasses.asdict(got.quant) == dataclasses.asdict(want.quant)
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert (got.padded_vocab, got.sub_quadratic) == (want.padded_vocab, want.sub_quadratic)
    m = TR.get_model(got)
    assert m.count_params(got) == JR.get_model(want).count_params(want)


def test_arch_ids_and_registry():
    assert ARCH_IDS == J_ARCH_IDS
    m = TR.get_model(CFG)
    assert CFG.family == "encdec" and getattr(m, "ragged_step", None) is None
    assert m.prefill is TE.prefill and m.decode_step is TE.decode_step
    assert get_config("whisper-base").n_frames == 1500


# ---------------------------------------------------------------------------
# common pieces
# ---------------------------------------------------------------------------


def test_layernorm_gelu_sinusoid_match_reference():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((3, 7, 128)) * 3, jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal(128) * 0.1 + 1, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(128) * 0.1, jnp.bfloat16)
    xf = jnp.asarray(rng.standard_normal((5, 300)) * 3, jnp.float32)
    pos = np.arange(0, 900, 7)[None, :]
    with jax.disable_jit():
        ln = JC.layernorm(x, w, b, 1e-5)
        ge = jax.nn.gelu(xf)
        si = JE._sinusoid(jnp.asarray(pos), 512)
    assert torch.equal(C.layernorm(_t(x), _t(w), _t(b), 1e-5), _t(ln))
    got, want = TE._sinusoid(torch.as_tensor(pos), 512).float().numpy(), _f32(si)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100))) - 7)
    assert np.all(np.abs(got - want) <= ulp + 1e-4)
    assert np.array_equal(got[:, :6], want[:, :6])  # positions 0 .. 35
    got, want = C.gelu(_t(xf)).numpy(), np.asarray(ge)
    assert np.allclose(got, want, rtol=1e-6, atol=5e-7)
    assert not torch.equal(C.gelu(_t(xf)), torch.nn.functional.gelu(_t(xf)))  # not the erf form


# ---------------------------------------------------------------------------
# encoder, forward, prefill, decode
# ---------------------------------------------------------------------------


def test_encode_and_forward_match_reference(jparams, params):
    fr = _frames(1, 2)
    ej = JE.encode(jparams, JCFG, fr)
    et = TE.encode(params, CFG, _t(fr))
    assert et.shape == (2, CFG.n_frames, CFG.d_model) and _rel(ej, et) <= REL
    toks = _toks(2, 12, 0)
    lj = JE.forward(jparams, JCFG, jnp.asarray(toks), fr)
    lt = TR.get_model(CFG).forward(params, CFG, _long(toks), _t(fr))
    assert lt.shape == (2, 12, CFG.padded_vocab) and _rel(lj, lt) <= REL


def test_prefill_with_frames_and_length(jparams, params):
    """Logits of the last real row, ``pos``, the self-attention rows and
    every layer's cross-attention rows against the reference; the
    bucket-padded prefill (``length``) against the unpadded one, and
    against the reference's padded prefill; ``state`` left unchanged."""
    b, s, pad = 2, 11, 5
    toks, fr = _toks(b, s, 3), _frames(2, b)
    padded = np.concatenate([toks, np.zeros((b, pad), np.int32)], axis=1)
    st0 = TE.init_decode_state(CFG, b, 32, device="cpu")
    la, sa = TE.prefill(params, CFG, _long(toks), st0, frames=_t(fr))
    lb, sb = TE.prefill(params, CFG, _long(padded), st0, frames=_t(fr),
                        length=torch.full((b,), s))
    assert all(not v.any() for v in st0.values())
    lj, sj = JE.prefill(jparams, JCFG, jnp.asarray(padded), JE.init_decode_state(JCFG, b, 32),
                        frames=fr, length=jnp.full((b,), s, jnp.int32))
    assert la.shape == (b, 1, CFG.padded_vocab)
    assert sa["pos"].tolist() == sb["pos"].tolist() == np.asarray(sj["pos"]).tolist() == [s] * b
    assert _rel(la, lb) < REL and _rel(lj, lb) <= REL
    for key in ("k", "v"):
        assert _rel(sa[key][:, :, :s], sb[key][:, :, :s]) < REL
        assert _rel(_f32(sj[key])[:, :, :s], sb[key][:, :, :s]) <= REL
        assert not sa[key][:, :, s:].any()
    for key in ("xk", "xv"):
        assert sb[key].shape == (CFG.n_layers, b, CFG.n_frames, CFG.n_heads, CFG.head_dim)
        assert torch.equal(sa[key], sb[key]) and _rel(sj[key], sb[key]) <= REL


def _paged(state: dict, page: int) -> dict:
    """The dense state's ``k`` / ``v`` as page pools with the identity block
    table (slot b's pages b * maxp ...); ``xk`` / ``xv`` stay per slot."""
    L, b, s = state["k"].shape[:3]
    maxp = s // page
    out = {k: v.clone() for k, v in state.items()}
    for key in ("k", "v"):
        out[key] = state[key].reshape(L, b * maxp, page, *state[key].shape[3:]).clone()
    out["bt"] = torch.arange(b * maxp, dtype=torch.int32).reshape(b, maxp)
    return out


def test_decode_bucketed_and_paged_match_reference(jparams, params):
    """Three decode steps: bucketed against the reference (each step's
    self-attention row written at ``pos``, ``xk`` / ``xv`` read only, the
    state updated in place), paged against bucketed over the same rows."""
    b, s = 2, 9
    toks, fr = _toks(b, s, 4), _frames(3, b)
    _, sj = JE.prefill(jparams, JCFG, jnp.asarray(toks), JE.init_decode_state(JCFG, b, 32),
                       frames=fr)
    _, st = TE.prefill(params, CFG, _long(toks), TE.init_decode_state(CFG, b, 32, device="cpu"),
                       frames=_t(fr))
    sp = _paged(st, 8)
    xk = st["xk"].clone()
    tok = np.array([[3], [9]], np.int32)
    for i in range(3):
        lj, sj = JE.decode_step(jparams, JCFG, sj, jnp.asarray(tok))
        lt, st2 = TE.decode_step(params, CFG, st, _long(tok))
        lp, sp2 = TE.decode_step(params, CFG, sp, _long(tok))
        assert st2 is st and sp2 is sp and st["pos"].tolist() == [s + i + 1] * b
        assert _rel(lj, lt) <= REL and _rel(lt, lp) < REL
        assert _rel(_f32(sj["k"])[:, :, :s + i + 1], st["k"][:, :, :s + i + 1]) <= REL
        tok = np.argmax(_f32(lt)[:, :, :CFG.vocab], axis=-1).astype(np.int32)
    assert torch.equal(st["xk"], xk) and torch.equal(sp["xk"], xk)
    L = CFG.n_layers
    assert torch.equal(sp["k"].reshape(L, b, 32, *sp["k"].shape[3:])[:, :, :s + 3],
                       st["k"][:, :, :s + 3])


def test_decode_matches_forward(params):
    """The reference's ``test_decode_matches_forward[whisper-base]`` on the
    port: prefill the first token, teacher-force the rest through
    ``decode_step``, against the parallel forward."""
    s = 8
    toks, fr = _long(_toks(1, s, 5)), _t(_frames(6))
    full = TE.forward(params, CFG, toks, fr).float()
    lg, st = TE.prefill(params, CFG, toks[:, :1], TE.init_decode_state(CFG, 1, 2 * s,
                                                                       device="cpu"), frames=fr)
    steps = [lg[:, -1]]
    for t in range(1, s):
        lg, st = TE.decode_step(params, CFG, st, toks[:, t:t + 1])
        steps.append(lg[:, 0])
    err = (torch.stack(steps, dim=1).float() - full).abs().max()
    assert float(err / (full.abs().max() + 1e-6)) < 0.05


def test_prefix_argument_is_refused(params):
    with pytest.raises(ValueError, match="prefix"):
        TE.prefill(params, CFG, _long(_toks(1, 4, 0)), TE.init_decode_state(CFG, 1, 16,
                                                                            device="cpu"),
                   frames=_t(_frames(1)), prefix={"k": None})
