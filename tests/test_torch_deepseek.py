"""The port's DeepSeek-V3 family (repro_torch.models.deepseek,
``family="mla_moe"``) with params bridged from the JAX package, held to
repro.models.deepseek: the config and its registry entry, and the entry
points at the reference engine tests' ``MLA_CFG`` widths. The packers are
held in ``tests/test_torch_deepseek_packs.py`` (which imports this file's
configs and bridge) and the engine cases in
``tests/test_torch_deepseek_engine.py`` (three files, so that ``--dist
loadfile`` spreads them over workers).

Tolerances: ``forward`` within rel 0.01 of the reference run op by op
(``jax.disable_jit()``; causal attention within one block, whose f32
score and softmax ops XLA orders otherwise), its aux loss within 1e-3
relative; ``prefill`` with ``length``, the bucketed and the paged
``decode_step`` bit-equal to it op by op (logits, latent caches and pools).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.configs import get_config as j_get_config
from repro.models import deepseek as JDS
from repro_torch.configs import ModelConfig, get_config
from repro_torch.interop import to_torch
from repro_torch.models import deepseek as TDS
from repro_torch.models import registry

torch.set_num_threads(2)

KW = dict(name="tiny-paged-mla", family="mla_moe", n_layers=2, d_model=64, n_heads=4,
          d_ff=128, vocab=256, first_k_dense=1, q_lora_rank=32, kv_lora_rank=32,
          qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, n_experts=4, top_k=2, d_ff_expert=64,
          n_shared_experts=1, mtp=True)
JCFG, CFG = JCfg(**KW, remat=False), ModelConfig(**KW)
RED = get_config("deepseek-v3-671b", reduced=True)
JRED = j_get_config("deepseek-v3-671b", reduced=True).replace(remat=False)


def _j(t: torch.Tensor):
    """A tensor as the reference's array, bit for bit."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _layer_tree(lp) -> dict:
    """One port layer as the reference's layer dict."""
    def lins(d):
        return {k: {"w": _j(m.w)} for k, m in d.items()}

    out = {"attn": {**lins(lp.attn), "q_norm": _j(lp.attn.q_norm),
                    "kv_norm": _j(lp.attn.kv_norm)},
           "ln1": _j(lp.ln1), "ln2": _j(lp.ln2)}
    if lp.moe is None:
        out["mlp"] = lins(lp.mlp)
    else:
        out["moe"] = {"router": _j(lp.moe.router), **lins(lp.moe.experts),
                      "shared": lins(lp.moe.shared)}
    return out


def _reference_tree(model) -> dict:
    """The port's bf16 DeepSeek model as the reference's params tree (the
    inverse of ``params_from_numpy``): initialising here is far quicker
    than the reference's vmapped init op by op."""
    def stack(lps):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *[_layer_tree(lp) for lp in lps])

    nd = sum(lp.moe is None for lp in model.layers)
    tree = {"embed": _j(model.embed), "dense_layers": stack(model.layers[:nd]),
            "moe_layers": stack(model.layers[nd:]), "ln_f": _j(model.ln_f),
            "head": {"w": _j(model.head.w)}}
    if model.mtp is not None:
        tree["mtp"] = {"proj": {"w": _j(model.mtp.proj.w)}, "layer": _layer_tree(model.mtp.layer),
                       "ln_in": _j(model.mtp.ln_in)}
    return tree


@pytest.fixture(scope="module")
def params():
    return TDS.init_params(CFG, seed=1, device="cpu")


@pytest.fixture(scope="module")
def jparams(params):
    return _reference_tree(params)


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _toks(shape, seed, vocab=KW["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _ops(fn, *args, **kw):
    """The reference run op by op (``jax.disable_jit()``)."""
    with jax.disable_jit():
        return fn(*args, **kw)


# ---------------------------------------------------------------------------
# config, registry
# ---------------------------------------------------------------------------


def test_config_registry_and_count_params():
    cfg = get_config("deepseek-v3-671b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.d_ff_expert,
            cfg.vocab, cfg.n_experts, cfg.top_k, cfg.n_shared_experts, cfg.first_k_dense) == (
        "mla_moe", 61, 7168, 128, 18432, 2048, 129280, 256, 8, 1, 3)
    assert (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
            cfg.v_head_dim, cfg.mtp) == (1536, 512, 128, 64, 128, True)
    assert (RED.n_layers, RED.first_k_dense, RED.d_model, RED.n_experts) == (3, 1, 256, 8)
    m = registry.get_model(cfg)
    assert m.decode_step is TDS.decode_step and m.prefill is TDS.prefill
    assert getattr(m, "ragged_step", None) is None
    for c in (cfg, RED, CFG):
        jc = JCfg(**{f.name: getattr(c, f.name) for f in dataclasses.fields(c)
                     if f.name != "quant"})
        assert TDS.count_params(c) == JDS.count_params(jc), c.name
    total, active = TDS.count_params(cfg)
    assert 6.5e11 < total < 6.9e11 and 3.5e10 < active < 4.0e10


# ---------------------------------------------------------------------------
# entry points against the reference
# ---------------------------------------------------------------------------


def test_forward_matches_jax(jparams, params):
    toks = _toks((1, 32), 0)  # the prefill test's shape: the op-by-op compiles are shared
    lo, ao, ho = _ops(JDS.forward, jparams, JCFG, jnp.asarray(toks))
    lt, at, ht = TDS.forward(params, CFG, torch.as_tensor(toks, dtype=torch.long))
    assert lt.shape == (1, 32, CFG.padded_vocab) and ht.shape == (1, 32, 64)
    assert _rel(_np(lo), _np(lt)) <= 0.01 and _rel(_np(ho), _np(ht)) <= 0.01
    assert abs(float(ao) - float(at)) <= 1e-3 * abs(float(ao))


def _paged_from(dense: dict, page: int, bt: np.ndarray) -> dict:
    """The dense latent cache's rows (L, B, S, r) laid into pools of
    ``page`` rows through block table ``bt`` (B, maxp); 2 spare pages."""
    out = {"pos": dense["pos"], "bt": jnp.asarray(bt)}
    for k in ("ckv", "krope"):
        c = np.asarray(dense[k])
        n_pages = int(bt.max()) + 3
        pool = np.zeros((c.shape[0], n_pages, page, c.shape[-1]), c.dtype)
        for b in range(bt.shape[0]):
            for j, pid in enumerate(bt[b]):
                if pid >= 0:
                    pool[:, pid] = c[:, b, j * page:(j + 1) * page]
        out[k] = jnp.asarray(pool)
    return out


def test_prefill_with_length_and_decode_match_jax(jparams, params):
    """A padded bucket (``length``), then a bucketed decode step from the
    reference's cache, then a paged decode step over the same rows laid
    into pages (slot 0 maps pages 3, 0, 5; pages 1 and 6 unmapped)."""
    bucket, length = 32, 27
    toks = _toks((1, bucket), 1)
    toks[0, length:] = 0
    sj = JDS.init_decode_state(JCFG, 1, 48)
    st = TDS.init_decode_state(CFG, 1, 48, device="cpu")
    lo, sj = _ops(JDS.prefill, jparams, JCFG, jnp.asarray(toks), sj,
                  length=jnp.asarray([length]))
    lt, st = TDS.prefill(params, CFG, torch.as_tensor(toks, dtype=torch.long), st,
                         length=torch.tensor([length]))
    assert torch.equal(lt, _t(lo)) and torch.equal(st["ckv"], _t(sj["ckv"]))
    assert torch.equal(st["krope"], _t(sj["krope"]))
    assert int(sj["pos"][0]) == int(st["pos"][0]) == length
    st = {k: _t(v) for k, v in sj.items()}
    tok = np.array([[9]], np.int32)
    lo, sj = _ops(JDS.decode_step, jparams, JCFG, sj, jnp.asarray(tok))
    lt, st = TDS.decode_step(params, CFG, st, torch.as_tensor(tok, dtype=torch.long))
    assert lt.shape == (1, 1, CFG.padded_vocab) and torch.equal(lt, _t(lo))
    assert torch.equal(st["ckv"], _t(sj["ckv"])) and torch.equal(st["krope"], _t(sj["krope"]))
    assert int(st["pos"][0]) == length + 1
    pj = _paged_from(sj, 16, np.array([[3, 0, 5]], np.int32))
    pt = {k: _t(v) for k, v in pj.items()}
    tok = np.array([[11]], np.int32)
    lo, pj = _ops(JDS.decode_step, jparams, JCFG, pj, jnp.asarray(tok))
    lt, pt = TDS.decode_step(params, CFG, pt, torch.as_tensor(tok, dtype=torch.long))
    assert torch.equal(lt, _t(lo))
    assert torch.equal(pt["ckv"], _t(pj["ckv"])) and torch.equal(pt["krope"], _t(pj["krope"]))
    assert int(pt["pos"][0]) == length + 2
