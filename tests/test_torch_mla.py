"""The port's Multi-head Latent Attention (repro_torch.models.mla) held to
repro.models.mla layer function by layer function, with DeepSeek params
bridged from the JAX package at the reference engine tests' ``MLA_CFG``
widths (``tests/test_paged_serving.py``: d_model 64, 4 heads, q_lora and
kv_lora 32, nope / rope / v = 16 / 8 / 16).

Tolerances: each function runs on the same bf16 inputs as the reference
run op by op (``jax.disable_jit()``) and is held bit for bit:
``mla_prefill_layer``'s latent lines, its output over a cached prefix (the
causal output without one within rel 0.01: see its test), ``mla_decode``
(the port attends over a copy of the cache with this step's latent line
put in at ``pos``, where the reference writes it first, and returns that
line: held to the reference's updated cache rows) and ``mla_decode_paged``
over a block table with unmapped (-1) entries and an idle slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JCfg
from repro.models import deepseek as JDS
from repro.models import mla as JM
from repro_torch.configs import ModelConfig
from repro_torch.interop import params_from_numpy, to_torch
from repro_torch.models import common as C
from repro_torch.models import mla as TM
from repro_torch.models.deepseek import MLALayer

torch.set_num_threads(2)

KW = dict(name="tiny-paged-mla", family="mla_moe", n_layers=2, d_model=64, n_heads=4,
          d_ff=128, vocab=256, first_k_dense=1, q_lora_rank=32, kv_lora_rank=32,
          qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, n_experts=4, top_k=2, d_ff_expert=64,
          n_shared_experts=1)
JCFG, CFG = JCfg(**KW, remat=False), ModelConfig(**KW)
KVR, ROPE = KW["kv_lora_rank"], KW["qk_rope_dim"]


@pytest.fixture(scope="module")
def jparams():
    return JDS.init_params(JCFG, jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), CFG, "cpu")


def _layer(jparams, group: str):
    """Layer 0's attention dict of the reference's ``group`` stack."""
    return jax.tree.map(lambda a: a[0], jparams[group]["attn"])


def _bf16(shape, seed, scale=1.0):
    """The same bf16 values for both sides: (jax array, tensor)."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape) * scale, jnp.bfloat16)
    return a, to_torch(np.asarray(a), "cpu")


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a), "cpu")


def _ops(fn, *args, **kw):
    """The reference run op by op (``jax.disable_jit()``)."""
    with jax.disable_jit():
        return fn(*args, **kw)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def test_bridged_mla_params(jparams, params):
    """Dense layers first, then MoE layers; each attention an
    ``MLAAttention`` with the reference's linears and norms bit for bit."""
    h, nope, vd = KW["n_heads"], KW["qk_nope_dim"], KW["v_head_dim"]
    assert [lp.moe is None for lp in params.layers] == [True, False]
    for lp, group in zip(params.layers, ("dense_layers", "moe_layers")):
        assert isinstance(lp, MLALayer) and isinstance(lp.attn, TM.MLAAttention)
        at = lp.attn
        assert set(at) == {"wq_a", "wq_b", "wkv_a", "wkv_b", "o"}
        assert at["wq_a"].w.shape == (64, 32) and at["wkv_a"].w.shape == (64, KVR + ROPE)
        assert at["wkv_b"].w.shape == (KVR, h * (nope + vd)) and at["o"].w.shape == (h * vd, 64)
        ja = _layer(jparams, group)
        for name in at:
            assert torch.equal(at[name].w, _t(ja[name]["w"])), name
        assert torch.equal(at.q_norm, _t(ja["q_norm"])) and at.kv_norm.shape == (KVR,)
    assert params.layers[1].moe.shared is not None
    assert params.layers[1].moe.experts["gate"].w.shape == (4, 64, 64)
    assert set(params.layers[0].mlp) == {"gate", "up", "down"}


# ---------------------------------------------------------------------------
# the layer functions against the reference
# ---------------------------------------------------------------------------


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.float() - b.float()) / torch.linalg.norm(b.float()))


def test_prefill_layer_matches_jax(jparams, params):
    """Causal prefill: the latent lines bit for bit; the output within rel
    0.01 (one 24-row causal block, whose f32 score and softmax ops XLA
    orders otherwise, as ``tests/test_torch_olmoe.py`` states for GQA)."""
    ja, at = _layer(jparams, "moe_layers"), params.layers[1].attn
    xj, xt = _bf16((2, 24, 64), 0)
    oj, cj, kj = _ops(JM.mla_prefill_layer, ja, xj, JCFG)
    ot, ct, kt = TM.mla_prefill_layer(at, xt, CFG)
    assert ot.shape == (2, 24, 64) and ct.shape == (2, 24, KVR) and kt.shape == (2, 24, ROPE)
    assert torch.equal(ct, _t(cj)) and torch.equal(kt, _t(kj))
    assert _rel(ot, _t(oj)) <= 0.01


def test_prefill_layer_with_prefix_matches_jax(jparams, params):
    """A 16-row cached prefix (the port's own latents of the prompt's
    first 16 rows) and an 8-row suffix at positions 16..23: the suffix
    queries attend the expanded prefix and the causal suffix, bit for bit
    (the masked attention has no causal block)."""
    ja, at = _layer(jparams, "dense_layers"), params.layers[0].attn
    xj, xt = _bf16((2, 24, 64), 1)
    _, ct, kt = TM.mla_prefill_layer(at, xt[:, :16], CFG)
    oj, sj, rj = _ops(JM.mla_prefill_layer, ja, xj[:, 16:], JCFG,
                      prefix=(jnp.asarray(ct.float().numpy(), jnp.bfloat16),
                              jnp.asarray(kt.float().numpy(), jnp.bfloat16)))
    ot, st, rt = TM.mla_prefill_layer(at, xt[:, 16:], CFG, prefix=(ct, kt))
    assert torch.equal(ot, _t(oj)) and torch.equal(st, _t(sj)) and torch.equal(rt, _t(rj))
    # the suffix's rows continue the whole prompt's: RoPE at positions 16..
    _, _, whole = TM.mla_prefill_layer(at, xt, CFG)
    assert torch.equal(rt, whole[:, 16:])


def test_decode_matches_jax(jparams, params):
    """Four slots at positions 5, 0, 31 (the last row) and 32 (past the
    cache: the line is dropped, as the reference's write is): the same
    output, this step's lines equal the reference's written rows, and the
    port's cache is left as it was."""
    ja, at = _layer(jparams, "moe_layers"), params.layers[1].attn
    ckv_j, ckv_t = _bf16((4, 32, KVR), 2)
    kr_j, kr_t = _bf16((4, 32, ROPE), 3)
    xj, xt = _bf16((4, 1, 64), 4)
    pos = np.array([5, 0, 31, 32], np.int32)
    oj, cj, rj = _ops(JM.mla_decode, ja, xj, JCFG, ckv_j, kr_j, jnp.asarray(pos))
    before = ckv_t.clone()
    ot, c_line, r_line = TM.mla_decode(at, xt, CFG, ckv_t, kr_t, torch.as_tensor(pos))
    assert torch.equal(ot, _t(oj)) and torch.equal(ckv_t, before)
    assert c_line.shape == (4, 1, KVR) and r_line.shape == (4, 1, ROPE)
    for b in range(3):
        assert torch.equal(c_line[b, 0], _t(cj)[b, pos[b]])
        assert torch.equal(r_line[b, 0], _t(rj)[b, pos[b]])
    assert torch.equal(_t(cj)[3], ckv_t[3])  # pos 32: nothing written


def test_decode_paged_over_unmapped_entries_matches_jax(jparams, params):
    """Pools of 6 pages of 8 rows; slot 0 maps pages [4, 1] at pos 10, slot
    1 page [5] at pos 3, slot 2 is idle (all -1, pos 0): unmapped entries
    read page 0 behind the mask, never index -1."""
    ja, at = _layer(jparams, "moe_layers"), params.layers[1].attn
    ckv_j, ckv_t = _bf16((6, 8, KVR), 5)
    kr_j, kr_t = _bf16((6, 8, ROPE), 6)
    xj, xt = _bf16((3, 1, 64), 7)
    bt = np.full((3, 4), -1, np.int32)
    bt[0, :2] = [4, 1]
    bt[1, 0] = 5
    pos = np.array([10, 3, 0], np.int32)
    oj, cj, rj = _ops(JM.mla_decode_paged, ja, xj, JCFG, ckv_j, kr_j, jnp.asarray(bt),
                      jnp.asarray(pos))
    ot, ct, rt = TM.mla_decode_paged(at, xt, CFG, ckv_t, kr_t, torch.as_tensor(bt),
                                     torch.as_tensor(pos))
    assert torch.equal(ot, _t(oj)) and torch.equal(ct, _t(cj)) and torch.equal(rt, _t(rj))
    # the gathered view holds page 0 where the table is unmapped
    view = C.gather_pages(ckv_t, torch.as_tensor(bt))
    assert torch.equal(view[2], ckv_t[0].repeat(4, 1)) and torch.equal(view[0, 8:16], ckv_t[1])


def test_init_cache_layout():
    st = TM.mla_init_cache(CFG, 3, 40, 2, device="cpu")
    assert st["ckv"].shape == (2, 3, 40, KVR) and st["krope"].shape == (2, 3, 40, ROPE)
    assert st["pos"].dtype == torch.int32 and st["ckv"].dtype == torch.bfloat16
    ref = JM.mla_init_cache(JCFG, 3, 40, 2)
    assert {k: tuple(v.shape) for k, v in st.items()} == {k: v.shape for k, v in ref.items()}
