"""The dense configs beyond the paper's two models — ``qwen2-1.5b`` (qkv bias,
tied head, 12 / 2 heads), ``stablelm-12b`` (head_dim 160, ``rope_fraction``
0.25), ``phi4-mini-3.8b`` (``rope_fraction`` 0.75, tied, 24 / 8 heads) and
``internlm2-1.8b`` (16 / 8 heads) — held to the JAX package: the configs
field by field (and ``internvl2-2b``'s), ``count_params`` at full scale, and
each REDUCED model's prefill and decode with params bridged from the
reference, in bf16 and in W4A4 (packed + fused) at a d_model-256 variant
(``_eligible`` packs K >= 256 only). The qkv biases are drawn at random, so
qwen2's bias reaches the logits through the fused qkv pack.

Tolerances (relative Frobenius error of the logits), those of
``tests/test_torch_dense.py``:
* bf16 <= 0.03, for the unpadded prefill, a bucket-padded prefill with
  ``length`` and two decode steps after each;
* W4A4 <= 0.75 with correlation >= 0.8: 4-bit activations turn bf16
  rounding differences into quantization flips layer after layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import QuantSpec as JQ
from repro.configs import get_config as j_get_config
from repro.core.twinquant import fuse_params as j_fuse
from repro.core.twinquant import quantize_params as j_quant
from repro.models import dense as JD
from repro.models import registry as JR
from repro_torch.configs import ModelConfig, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import dense as TD
from repro_torch.models import registry as TR
from repro_torch.models.common import TwinQuantLinearGroup

torch.set_num_threads(2)

DENSE = ["qwen2-1.5b", "stablelm-12b", "phi4-mini-3.8b", "internlm2-1.8b"]
ALL = DENSE + ["internvl2-2b"]
# the W4A4 variant: each reduced config at d_model 256 (K >= 256 packs)
W4A4_KW = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab=260)


def _jcfg(cfg: ModelConfig):
    base = j_get_config(cfg.name, reduced=True)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name not in ("quant", "remat")}
    return base.replace(**kw, remat=False)


def _jparams(cfg: ModelConfig, seed: int):
    """Reference params of ``cfg`` with the qkv biases (if any) drawn at
    random instead of zeros."""
    jc = _jcfg(cfg)
    p = JD.init_params(jc, jax.random.PRNGKey(seed))
    if cfg.qkv_bias:
        attn = p["layers"]["attn"]
        for i, name in enumerate(("q", "k", "v")):
            b = attn[name]["b"]
            noise = jax.random.normal(jax.random.PRNGKey(100 + i), b.shape, jnp.float32)
            attn[name]["b"] = (0.5 * noise).astype(b.dtype)
    return jc, p


def _f32(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y, jnp.float32))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _serve_both(cfg, jc, p, bucket, length, steps=2):
    """Prefill a bucket (padded past ``length`` when shorter), then ``steps``
    decode steps, in both packages; returns [(jax, port) logits, ...]."""
    pt = params_from_numpy(jax.tree.map(np.asarray, p), cfg, "cpu")
    toks = np.random.default_rng(bucket).integers(0, cfg.vocab, (1, bucket)).astype(np.int32)
    toks[0, length:] = 0
    sj = JD.init_decode_state(jc, 1, bucket + 8)
    st = TD.init_decode_state(cfg, 1, bucket + 8, device="cpu")
    kw_j = {} if length == bucket else dict(length=jnp.asarray([length]))
    kw_t = {} if length == bucket else dict(length=torch.tensor([length]))
    lj, sj = JD.prefill(p, jc, jnp.asarray(toks), sj, **kw_j)
    lt, st = TD.prefill(pt, cfg, torch.as_tensor(toks, dtype=torch.long), st, **kw_t)
    out = [(_f32(lj), _f32(lt))]
    assert int(sj["pos"][0]) == int(st["pos"][0]) == length
    for i in range(steps):
        tok = np.array([[7 + i]], np.int32)
        lj, sj = JD.decode_step(p, jc, sj, jnp.asarray(tok))
        lt, st = TD.decode_step(pt, cfg, st, torch.as_tensor(tok, dtype=torch.long))
        out.append((_f32(lj), _f32(lt)))
    assert int(st["pos"][0]) == length + steps
    return out


# ---------------------------------------------------------------------------
# configs, registry, count_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ALL)
def test_config_equals_reference_field_by_field(name, reduced):
    got, want = get_config(name, reduced=reduced), j_get_config(name, reduced=reduced)
    for f in dataclasses.fields(got):
        if f.name == "quant":
            assert dataclasses.asdict(got.quant) == dataclasses.asdict(want.quant)
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.padded_vocab == want.padded_vocab


@pytest.mark.parametrize("name", ALL)
def test_count_params_equals_reference(name):
    cfg, jc = get_config(name), j_get_config(name)
    assert TR.get_model(cfg).count_params(cfg) == JR.get_model(jc).count_params(jc)
    assert TD.count_params(cfg) == JD.count_params(jc)


def test_registry_serves_the_new_configs():
    for name in DENSE:
        m = TR.get_model(get_config(name))
        assert m.prefill is TD.prefill and m.ragged_step is TD.ragged_step


# ---------------------------------------------------------------------------
# the reduced models against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_bf16_prefill_decode_and_bucket_padding_vs_reference(name):
    cfg = get_config(name, reduced=True)
    jc, p = _jparams(cfg, seed=0)
    for bucket, length in ((40, 40), (48, 41)):
        for a, b in _serve_both(cfg, jc, p, bucket, length):
            assert a.shape == b.shape == (1, 1, cfg.padded_vocab)
            assert _rel(a, b) <= 0.03


@pytest.mark.parametrize("name", DENSE)
def test_w4a4_fused_prefill_decode_vs_reference(name):
    cfg = get_config(name, reduced=True).replace(**W4A4_KW)
    jc, p = _jparams(cfg, seed=1)
    pq = j_fuse(jax.jit(lambda q: j_quant(q, jc, JQ(mode="w4a4", rank=32)))(p))
    pt = params_from_numpy(jax.tree.map(np.asarray, pq), cfg, "cpu")
    qkv = pt.layers[0].attn["qkv"]
    assert isinstance(qkv, TwinQuantLinearGroup)
    assert (qkv.b is not None) == cfg.qkv_bias
    assert (pt.head is None) == cfg.tie_embeddings
    for a, b in _serve_both(cfg, jc, pq, 64, 60):
        assert _rel(a, b) <= 0.75
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.8
