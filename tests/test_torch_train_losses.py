"""Every family's ``loss_fn`` of the port and its gradients, against
``jax.value_and_grad`` of the reference's ``loss_fn`` at the reduced
config, the params bridged by ``interop.params_to_numpy``; the bridge
itself and the reference's decay flags on its stacked tree.

Cases: dense (llama3-8b) at seq 33 (the shifted 32 rows take the full-logits
CE) and 513 (512 rows: the chunked, rematerialised CE; the reference takes
it only when S % 256 == 0 and S > 256, so 257 tokens would not), the vlm
(patches prepended, the loss on the text only), moe (OLMoE, the router aux
loss), mla_moe (DeepSeek-V3 with the ``mtp`` loss), encdec (Whisper,
frames), mamba_hybrid (Zamba2, padded to the SSD chunk) and xlstm, every
one with ``remat`` as configured (on).

The reference's value-and-grad is jitted (one compile a case) with
``xla_allow_excess_precision`` off, so that its bf16 intermediates round
where the reference run op by op rounds them: its jitted executable
otherwise keeps some in f32, which moves the MoE families' routing and
gradients past the bound (ROADMAP Queue 3). Tolerances: the loss within rel 1e-3 (read:
7e-8 for llama3-8b at seq 33, at most 2.8e-4, Zamba2), each leaf's
gradient within rel 0.03 (Frobenius; read: at most 0.024, DeepSeek-V3's
``mtp`` ``q_norm``), all bf16 rounding in another order. DeepSeek-V3 is
held drop-free (``OVERRIDES``). Every reference leaf has exactly one
gradient of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import common as JC
from repro.models.registry import get_model as jmodel
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, params_to_numpy, reference_leaf, reference_ndim
from repro_torch.models import common as C
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamW

torch.set_num_threads(2)

CASES = [("llama3-8b", 33), ("llama3-8b", 513), ("internvl2-2b", 33), ("olmoe-1b-7b", 33),
         ("deepseek-v3-671b", 33), ("whisper-base", 33), ("zamba2-1.2b", 33),
         ("xlstm-1.3b", 33)]
ARCHS = sorted({a for a, _ in CASES})
LOSS_REL, GRAD_REL = 1e-3, 0.03
# DeepSeek-V3's reduced config drops at its published capacity factor
# (1.25, 8 experts): a near-tie top-k flip ahead of a full expert moves
# which assignments drop and the router's gradient past the bound, against
# the reference run op by op as well (ROADMAP Queue 3). Drop-free, as the
# serving tests hold it; OLMoE is held at 1.25.
OVERRIDES = {"deepseek-v3-671b": dict(capacity_factor=8.0)}


def _model(arch):
    cfg = get_config(arch, reduced=True, **OVERRIDES.get(arch, {}))
    return cfg, C.trainable(get_model(cfg).init_params(cfg, seed=0, device="cpu"))


def _batch(cfg, seq: int):
    rng = np.random.default_rng(seq)
    toks = rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    extra = {"vlm": ("patches", cfg.n_patches, 0.02), "encdec": ("frames", cfg.n_frames, 1.0)}
    if cfg.family in extra:
        key, rows, std = extra[cfg.family]
        x = (rng.standard_normal((2, rows, cfg.d_model)) * std).astype(np.float32)
        jb[key] = jnp.asarray(x, jnp.bfloat16)
        tb[key] = torch.as_tensor(x).to(torch.bfloat16)
    return jb, tb


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.mark.parametrize("arch,seq", CASES, ids=[f"{a}-{s}" for a, s in CASES])
def test_loss_and_grads_vs_reference(arch, seq):
    cfg, params = _model(arch)
    jcfg = jget(arch, reduced=True, **OVERRIDES.get(arch, {}))
    tree = jax.tree.map(jnp.asarray, params_to_numpy(params, cfg))
    jb, tb = _batch(cfg, seq)
    jm = jmodel(jcfg)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, jcfg, b)))
    jloss, jgrads = vg.lower(tree, jb).compile({"xla_allow_excess_precision": False})(tree, jb)
    loss = get_model(cfg).loss_fn(params, cfg, tb)
    loss.backward()
    assert all(p.grad is not None for p in params.parameters())
    grads = params_to_numpy({n: p.grad for n, p in params.named_parameters()}, cfg)
    # every reference leaf has exactly one gradient of the port, of its shape
    assert jax.tree.structure(grads) == jax.tree.structure(jgrads)
    assert all(np.shape(a) == np.shape(b)
               for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jgrads)))
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    for (path, jg), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                             jax.tree.leaves(grads)):
        assert _rel(jg, g) <= GRAD_REL, (jax.tree_util.keystr(path), _rel(jg, g))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_is_the_reference_tree(arch):
    """params_to_numpy gives the reference's stacked tree (structure,
    shapes and dtypes of its init), params_from_numpy -> params_to_numpy
    keeps every bit, and each of the port's tensors lands in the reference
    leaf whose ndim its decay flag is taken from."""
    cfg, params = _model(arch)
    jcfg = jget(arch, reduced=True)
    tree = params_to_numpy(params, cfg)
    want = jax.eval_shape(lambda: jmodel(jcfg).init_params(jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree) == jax.tree.map(
        lambda a: (a.shape, str(a.dtype)), want)
    back = params_to_numpy(params_from_numpy(tree, cfg, "cpu"), cfg)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    decays = AdamW().decays(params)
    for n, p in params.named_parameters():
        path, idx = reference_leaf(n, cfg)
        leaf = want
        for k in path:
            leaf = leaf[k]
        assert reference_ndim(n, p) == len(leaf.shape) == p.ndim + len(idx), n
        assert decays[n] == (len(leaf.shape) >= 2), n


def test_decay_flags_follow_the_stacked_leaves():
    """The rule on the reference's shapes, not the port's: a layer's norm
    is (d,) in the port and (L, d) in the reference, so it decays; the
    final norm, DeepSeek-V3's ``mtp`` input norm and its unstacked ``mtp``
    layer's norms, and Zamba2's shared block's norms do not."""
    flags = {}
    for arch in ("llama3-8b", "deepseek-v3-671b", "zamba2-1.2b"):
        flags.update({f"{arch}:{n}": f for n, f in AdamW().decays(_model(arch)[1]).items()})
    for n in ("llama3-8b:layers.0.ln1", "deepseek-v3-671b:layers.0.attn.q_norm",
              "zamba2-1.2b:m_layers.0.1.A_log", "zamba2-1.2b:adapters.1.w"):
        assert flags[n], n
    for n in ("llama3-8b:ln_f", "deepseek-v3-671b:mtp.ln_in", "deepseek-v3-671b:mtp.layer.ln1",
              "zamba2-1.2b:shared.ln1"):
        assert not flags[n], n


@pytest.mark.parametrize("s", [32, 256, 512])
def test_cross_entropy_chunked_vs_reference(s):
    """Both branches of the chunked CE (S = 512 takes the chunks; 32 and
    256 the full logits) against the reference's, masked labels included."""
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 300)) / 8).astype(np.float32)
    lab = rng.integers(-1, 300, (2, s)).astype(np.int32)
    ht, wt = torch.as_tensor(h).to(torch.bfloat16), torch.as_tensor(w).to(torch.bfloat16)
    got = C.cross_entropy_chunked(ht, torch.as_tensor(lab), lambda x: x @ wt)
    hj, wj = jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = JC.cross_entropy_chunked(hj, jnp.asarray(lab), lambda x: x @ wj)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_embedding_gradient_is_the_references_bf16_scatter_add():
    """The embedding's gradient over repeated tokens (every row of a batch
    onto one of 8 tokens) bit for bit the reference's: both add the rows
    into the bf16 table one by one in bf16, so it carries the rounding of
    each add (the training phase's bound on ``embed`` is wider for it)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 8, (4, 512)).astype(np.int32)
    g = rng.standard_normal((4, 512, 64)).astype(np.float32)
    table = torch.zeros(16, 64, dtype=torch.bfloat16, requires_grad=True)
    C.embed_lookup(table, torch.as_tensor(toks)).backward(torch.as_tensor(g).to(torch.bfloat16))

    def f(e, t, w):
        return jnp.sum((JC.embed_lookup(e, t) * w).astype(jnp.float32))

    want = jax.jit(jax.grad(f))(jnp.zeros((16, 64), jnp.bfloat16), jnp.asarray(toks),
                                jnp.asarray(g, jnp.bfloat16))
    mine = table.grad.view(torch.int16).numpy()
    assert np.array_equal(np.asarray(want).view(np.int16), mine)


def test_trainable_and_frozen_keep_the_bits():
    """``trainable`` makes every float buffer a parameter and ``frozen``
    turns them back, same tensors, same bits; the serving forward reads
    either the same."""
    cfg = get_config("olmoe-1b-7b", reduced=True)
    model = get_model(cfg).init_params(cfg, seed=0, device="cpu")
    names = {n for n, _ in model.named_buffers()}
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (1, 9)))
    want = get_model(cfg).forward(model, cfg, toks)[0]
    C.trainable(model)
    assert {n for n, _ in model.named_parameters()} == names and not list(model.buffers())
    assert torch.equal(get_model(cfg).forward(model, cfg, toks)[0], want)
    C.frozen(model)
    assert {n for n, _ in model.named_buffers()} == names and not list(model.parameters())
    assert torch.equal(get_model(cfg).forward(model, cfg, toks)[0], want)
