"""The port's OLMoE decode paths with params bridged from the JAX package,
held to repro.models.olmoe at the reference engine tests' tiny MoE config
(E = 4, top_k 2, capacity_factor 4.0): ``prefill`` behind a cached prefix,
the paged ``decode_step`` (sq 1 and a 4-row speculative stack) and the
``ragged_step`` (decode row, a chunk behind committed pages, a cold chunk,
pad rows). Logits, caches and pools bit-equal to the reference run op by
op (``jax.disable_jit()``), positions exact. (The jitted reference's fused
executable keeps bf16 intermediates in f32 and so differs from its own
op-by-op run: by rel 0.04 on the prefix prefill's logits and 0.41 on one
sq-4 verify row whose routing it flips, on this config.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.models import common as JC_
from repro.models import olmoe as JO
from repro_torch.configs import ModelConfig
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.models import olmoe as TO

torch.set_num_threads(2)

KW = dict(name="tiny-moe", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          head_dim=16, vocab=256, n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=4.0)
JCFG, CFG = JCfg(**KW, remat=False), ModelConfig(**KW)


@pytest.fixture(scope="module")
def jparams():
    return JO.init_params(JCFG, jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _toks(shape, seed):
    return np.random.default_rng(seed).integers(0, KW["vocab"], shape).astype(np.int32)


def _ops(fn, *args, **kw):
    """The reference run op by op (``jax.disable_jit()``)."""
    with jax.disable_jit():
        return fn(*args, **kw)


def test_prefill_with_prefix_matches_jax(jparams, params):
    """A suffix prefill behind a cached post-RoPE prefix, bit-equal to the
    reference run op by op."""
    m, s = 16, 8
    full = _toks((1, m + s), 2)
    sj = JO.init_decode_state(JCFG, 1, 48)
    _, sj_full = JO.prefill(jparams, JCFG, jnp.asarray(full[:, :m]), sj)
    prefix = {"k": sj_full["k"][:, :, :m], "v": sj_full["v"][:, :, :m]}
    st = TO.init_decode_state(CFG, 1, 48, device="cpu")
    lt, st2 = TO.prefill(params, CFG, torch.as_tensor(full[:, m:], dtype=torch.long), st,
                         prefix={k: _t(v) for k, v in prefix.items()})
    lo, so = _ops(JO.prefill, jparams, JCFG, jnp.asarray(full[:, m:]), sj, prefix=prefix)
    assert torch.equal(lt, _t(lo)) and torch.equal(st2["k"], _t(so["k"]))
    assert int(st2["pos"][0]) == int(so["pos"][0]) == m + s


def _paged_states(sq, seed):
    rng = np.random.default_rng(seed)
    B, page, n_pages, max_len = 3, 8, 12, 32
    js = JC_.init_paged_state(JO.init_decode_state, JCFG, B, max_len, page, n_pages)
    js["k"] = jnp.asarray(rng.standard_normal(js["k"].shape) * 0.5, jnp.bfloat16)
    js["v"] = jnp.asarray(rng.standard_normal(js["v"].shape) * 0.5, jnp.bfloat16)
    bt = np.full((B, max_len // page), -1, np.int32)
    bt[0, :3], bt[1, :2] = [7, 2, 9], [4, 0]  # slot 2 idle
    js["bt"] = jnp.asarray(bt)
    js["pos"] = jnp.asarray([17 - sq, 3, 0], jnp.int32)
    return js, {k: _t(v) for k, v in js.items()}, rng


@pytest.mark.parametrize("sq", [1, 4])
def test_paged_decode_step_matches_jax(jparams, params, sq):
    js, ts, rng = _paged_states(sq, sq)
    tokens = rng.integers(0, KW["vocab"], (3, sq)).astype(np.int32)
    lo, sj = _ops(JO.decode_step, jparams, JCFG, js, jnp.asarray(tokens))
    lt, st = TO.decode_step(params, CFG, ts, torch.as_tensor(tokens, dtype=torch.long))
    assert torch.equal(lt, _t(lo))
    assert torch.equal(st["k"], _t(sj["k"])) and torch.equal(st["v"], _t(sj["v"]))
    assert st["pos"].tolist() == np.asarray(sj["pos"]).tolist()


def test_ragged_step_matches_jax(jparams, params):
    js, ts, rng = _paged_states(1, 4)
    B, T = 3, 16
    bt = np.asarray(js["bt"]).copy()
    bt[2, :1] = [11]
    js["bt"], ts["bt"] = jnp.asarray(bt), _t(bt)
    ctx = np.array([17, 3, 0], np.int32)
    slot = np.full(T, B, np.int32)
    pos = np.zeros(T, np.int32)
    slot[0], pos[0] = 0, 17  # decode row
    slot[1:9], pos[1:9] = 1, np.arange(3, 11)  # chunk behind 3 committed rows
    slot[9:13], pos[9:13] = 2, np.arange(0, 4)  # cold chunk; 3 pad rows
    logit_idx = np.array([0, 8, 12], np.int32)
    tokens = rng.integers(0, KW["vocab"], T).astype(np.int32)
    args = (tokens, slot, pos, ctx, logit_idx)
    lo, sj = _ops(JO.ragged_step, jparams, JCFG, js, *(jnp.asarray(a) for a in args))
    lt, st = TO.ragged_step(params, CFG, ts, *(torch.as_tensor(a) for a in args))
    assert torch.equal(lt, _t(lo))
    for key in ("k", "v"):
        assert torch.equal(st[key], _t(sj[key]))
    assert st["pos"].tolist() == np.asarray(sj["pos"]).tolist() == [18, 11, 4]
