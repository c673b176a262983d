"""The ``vlm`` family (``internvl2-2b``: internlm2's dense backbone behind a
stub patch frontend) on the port, held to the JAX package: prefill with the
patch rows prepended (logits, ``pos``, cache rows), the reference's
bucket-padded prefill parity for vlm, and its paged-serving case for patch
rows; then the engine's frontend (``Request.frontend``): pages for prompt +
patch rows, no prefix cache, and the ragged and speculative modes refused
with a warning.

Tolerances (relative Frobenius error): prefill logits and cache rows
<= 0.03 against the reference (bf16 rounding at other places in XLA's and
PyTorch's CPU kernels, ``tests/test_torch_dense.py``); padded against
unpadded prefill and decode < 0.02, the reference's own
``test_bucketed_prefill_parity`` bound; positions and greedy tokens exact.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import dense as JD
from repro.models import registry as JR
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.models import dense as TD
from repro_torch.models import registry as TR

torch.set_num_threads(2)

CFG = get_config("internvl2-2b", reduced=True)
JCFG = j_get_config("internvl2-2b", reduced=True).replace(remat=False)
P = CFG.n_patches


@pytest.fixture(scope="module")
def jparams():
    return JD.init_params(JCFG, jax.random.PRNGKey(4))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _patches(seed, b=1):
    return jax.random.normal(jax.random.PRNGKey(seed), (b, P, CFG.d_model), jnp.bfloat16)


def _f32(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y, jnp.float32))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _toks(b, s, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (b, s)).astype(np.int32)


def test_registry_vlm_family():
    m = TR.get_model(CFG)
    assert CFG.family == "vlm" and P == 16 and get_config("internvl2-2b").n_patches == 256
    assert getattr(m, "ragged_step", None) is None
    assert m.prefill is TD.prefill and m.decode_step is TD.decode_step
    full, jfull = get_config("internvl2-2b"), j_get_config("internvl2-2b")
    assert m.count_params(full) == JR.get_model(jfull).count_params(jfull)


def test_prefill_with_patches_matches_reference(jparams, params):
    """Patch rows first: logits of the last real row, ``pos`` = patches +
    tokens, the cache's rows (patch rows included), then one decode step."""
    toks, pj = _toks(2, 12, 0), _patches(5, 2)
    sj = JD.init_decode_state(JCFG, 2, 48)
    st = TD.init_decode_state(CFG, 2, 48, device="cpu")
    lj, sj = JD.prefill(jparams, JCFG, jnp.asarray(toks), sj, patches=pj)
    lt, st = TR.get_model(CFG).prefill(params, CFG, torch.as_tensor(toks, dtype=torch.long), st,
                                       patches=to_torch(np.asarray(pj), "cpu"))
    assert lt.shape == (2, 1, CFG.padded_vocab)
    assert _rel(_f32(lj), _f32(lt)) <= 0.03
    assert np.asarray(sj["pos"]).tolist() == st["pos"].tolist() == [P + 12] * 2
    for key in ("k", "v"):
        a, b = _f32(sj[key])[:, :, :P + 12], _f32(st[key])[:, :, :P + 12]
        assert _rel(a, b) <= 0.03
        assert not np.any(_f32(st[key])[:, :, P + 12:])
    tok = np.array([[3], [9]], np.int32)
    lj, _ = JD.decode_step(jparams, JCFG, sj, jnp.asarray(tok))
    lt, _ = TD.decode_step(params, CFG, st, torch.as_tensor(tok, dtype=torch.long))
    assert _rel(_f32(lj), _f32(lt)) <= 0.03


def test_forward_with_patches_matches_reference(jparams, params):
    toks, pj = _toks(1, 10, 1), _patches(6)
    lj = JD.forward(jparams, JCFG, jnp.asarray(toks), pj)
    lt = TD.forward(params, CFG, torch.as_tensor(toks, dtype=torch.long),
                    to_torch(np.asarray(pj), "cpu"))
    assert lt.shape == (1, P + 10, CFG.padded_vocab)
    assert _rel(_f32(lj), _f32(lt)) <= 0.03


def test_bucketed_prefill_parity_vlm(jparams, params):
    """The reference's ``test_bucketed_prefill_parity`` case for vlm on the
    port: a bucket-padded prefill (``length``; the real length seen through
    the patches is ``length + P``) gives the unpadded prefill's ``pos``,
    logits and next two decode steps; the padded prefill also against the
    reference's."""
    b, s, pad = 2, 11, 5
    toks = _toks(b, s, 3)
    pj = _patches(3, b)
    pt = to_torch(np.asarray(pj), "cpu")
    padded = np.concatenate([toks, np.zeros((b, pad), np.int32)], axis=1)
    la, sa = TD.prefill(params, CFG, torch.as_tensor(toks, dtype=torch.long),
                        TD.init_decode_state(CFG, b, 48, device="cpu"), patches=pt)
    lb, sb = TD.prefill(params, CFG, torch.as_tensor(padded, dtype=torch.long),
                        TD.init_decode_state(CFG, b, 48, device="cpu"), patches=pt,
                        length=torch.full((b,), s))
    assert sa["pos"].tolist() == sb["pos"].tolist() == [P + s] * b
    assert _rel(_f32(la), _f32(lb)) < 0.02
    lj, _ = JD.prefill(jparams, JCFG, jnp.asarray(padded), JD.init_decode_state(JCFG, b, 48),
                       patches=pj, length=jnp.full((b,), s, jnp.int32))
    assert _rel(_f32(lj), _f32(lb)) <= 0.03
    tok = torch.argmax(la[:, -1:], dim=-1) % CFG.vocab
    for _ in range(2):
        la, sa = TD.decode_step(params, CFG, sa, tok)
        lb, sb = TD.decode_step(params, CFG, sb, tok)
        assert _rel(_f32(la), _f32(lb)) < 0.02
        tok = torch.argmax(la, dim=-1) % CFG.vocab


# ---------------------------------------------------------------------------
# the engine's frontend
# ---------------------------------------------------------------------------

PROMPT = list(range(5, 14))


def _serve_one(params, patches, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # paged vlm: no prefix cache (its own test)
        eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                       **kw)
    r = Request(np.asarray(PROMPT, np.int32), max_new=5, frontend={"patches": patches})
    eng.serve([r])
    assert r.status == "DONE" and len(r.out) == 5
    return r, eng


def test_paged_vlm_frontend_rows(params):
    """The reference's ``test_paged_vlm_frontend_rows``: paged admission
    reserves and writes pages for prompt + patch rows and gives the bucketed
    tokens; the frontend bypasses the prefix cache; the pages hold the patch
    rows."""
    patches = to_torch(np.asarray(_patches(5)), "cpu")
    r_dense, eng_d = _serve_one(params, patches)
    r_paged, eng = _serve_one(params, patches, paged=True, page_size=8)
    eng.check_page_invariants()
    assert r_paged.out == r_dense.out
    assert eng.stats["prefix_lookups"] == 0 and eng.prefix_cache is None
    assert eng_d.compile_stats()["prefill_variants"] == 1
    # another image, the same text: other tokens (the patches reach the model)
    r_other, _ = _serve_one(params, to_torch(np.asarray(_patches(6)), "cpu"))
    assert r_other.out != r_dense.out


def test_paged_vlm_warns_without_prefix_cache(params):
    with pytest.warns(UserWarning, match="prefix_caching"):
        eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                       paged=True, page_size=8)
    assert eng.prefix_cache is None


@pytest.mark.parametrize("kw,what", [
    (dict(paged=True, ragged=True, token_budget=32), "ragged=True"),
    (dict(paged=True, speculation=True), "speculation=True"),
])
def test_ragged_and_speculation_warn_and_fall_back(params, kw, what):
    with pytest.warns(UserWarning, match=what):
        eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                       prefix_caching=False, **kw)
    assert not eng.ragged and not eng.speculation
    patches = to_torch(np.asarray(_patches(5)), "cpu")
    r = Request(np.asarray(PROMPT, np.int32), max_new=5, frontend={"patches": patches})
    eng.serve([r])
    assert r.out == _serve_one(params, patches)[0].out


def test_submit_counts_the_patch_rows(params):
    eng = ContinuousBatchingEngine(CFG, params, batch_slots=2, max_len=64, device="cpu",
                                   on_truncation="reject")
    patches = torch.zeros(1, P, CFG.d_model, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\+16 frontend rows"):
        eng.submit(Request(np.arange(64 - P, dtype=np.int32) % CFG.vocab, max_new=1,
                           frontend={"patches": patches}))
    with pytest.raises(ValueError, match="will truncate"):
        eng.submit(Request(np.arange(40, dtype=np.int32), max_new=10,
                           frontend={"patches": patches}))
    assert not eng.queue and all(s is None for s in eng.slots)
    # fits: text + patch rows + max_new == max_len
    assert eng.submit(Request(np.arange(38, dtype=np.int32), max_new=10,
                              frontend={"patches": patches}))
