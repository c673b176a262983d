"""DeepSeek-V3 (``family="mla_moe"``): MLA attention (``models/mla.py``) in
every layer, ``first_k_dense`` layers with a dense SwiGLU MLP, then layers
with an MoE FFN (``models/moe_layer.py``: routed experts top-k plus the
shared expert), and the multi-token-prediction block (``mtp``), with the
reference's serving entry points (``repro/models/deepseek.py``).

The reference scan-stacks ``dense_layers`` and ``moe_layers`` apart; here
the model is a :class:`DeepSeekModel` (a ``dense.DenseModel`` plus ``mtp``)
whose ``layers`` hold the dense :class:`MLALayer` s first, then the MoE
ones. The entry points run the dense family's layer loops
(``dense.run_layers``, ``prefill_layers``, ``decode_layers``) with MLA as
the attention step and each layer's own FFN, so the decode steps write the
latent caches or pools and the positions in place and one CUDA graph holds
a step. Routing is the reference's softmax top-k with capacity dispatch,
not DeepSeek-V3's published sigmoid, group-limited router. There is no
``ragged_step`` and no multi-row decode: the reference has neither, and the
engine serves the family bucketed or paged (with the prefix cache). ``mtp``
is built, and packed by ``quantize_params`` as the reference packs it, but
serving never reads it: only :func:`loss_fn` does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import dense as D
from repro_torch.models.mla import MLAAttention, mla_init, mla_init_cache, mla_prefill, mla_step
from repro_torch.models.moe_layer import MoEFFN, layer_ffn, moe_init

__all__ = ["MLALayer", "MTP", "DeepSeekModel", "init_params", "forward", "loss_fn",
           "init_decode_state", "prefill", "decode_step", "count_params"]


class MLALayer(nn.Module):
    """One pre-norm decoder layer: MLA, then a dense ``mlp`` (``gate``,
    ``up``, ``down``) or an MoE block ``moe``."""

    def __init__(self, attn: MLAAttention, ln1: torch.Tensor, ln2: torch.Tensor,
                 mlp: Optional[dict] = None, moe: Optional[MoEFFN] = None):
        super().__init__()
        self.attn = attn
        self.mlp = None if mlp is None else nn.ModuleDict(mlp)
        self.moe = moe
        self.register_buffer("ln1", ln1)
        self.register_buffer("ln2", ln2)


class MTP(nn.Module):
    """The multi-token-prediction block: ``proj`` (2D -> D, kept bf16 by
    the packer's ``mtp/proj``), a dense MLA ``layer`` at d_ff = 4 x
    d_ff_expert, and the input norm ``ln_in`` (2D)."""

    def __init__(self, proj: nn.Module, layer: MLALayer, ln_in: torch.Tensor):
        super().__init__()
        self.proj = proj
        self.layer = layer
        self.register_buffer("ln_in", ln_in)


class DeepSeekModel(D.DenseModel):
    """Embedding, the MLA layers (dense first), final norm, bf16 head and
    the optional ``mtp`` block."""

    def __init__(self, embed: torch.Tensor, layers: list, ln_f: torch.Tensor,
                 head: nn.Module, mtp: Optional[MTP] = None):
        super().__init__(embed, layers, ln_f, head)
        self.mtp = mtp


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> DeepSeekModel:
    """Random parameters with the reference's init (linears N(0, 1/d_in),
    embedding N(0, 0.02^2), norms ones, MoE blocks as
    ``moe_layer.moe_init``), drawn from ``generator`` (else one seeded
    ``seed`` on the device). Runs on the card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def lin(d_in, d_out):
        return C.Linear(C.init_normal(gen, (d_in, d_out), C.dense_std(d_in), dev))

    def ones(n=d):
        return torch.ones((n,), dtype=C.DTYPE, device=dev)

    def dense_layer(c: ModelConfig) -> MLALayer:
        return MLALayer(mla_init(gen, c, dev), ones(), ones(),
                        mlp={"gate": lin(d, c.d_ff), "up": lin(d, c.d_ff),
                             "down": lin(c.d_ff, d)})

    layers = [dense_layer(cfg) for _ in range(cfg.first_k_dense)]
    layers += [MLALayer(mla_init(gen, cfg, dev), ones(), ones(), moe=moe_init(gen, cfg, dev))
               for _ in range(cfg.n_layers - cfg.first_k_dense)]
    embed = C.init_normal(gen, (cfg.padded_vocab, d), 0.02, dev)
    head = lin(d, cfg.padded_vocab)
    mtp = None
    if cfg.mtp:
        mtp = MTP(lin(2 * d, d), dense_layer(cfg.replace(d_ff=cfg.d_ff_expert * 4)), ones(2 * d))
    return DeepSeekModel(embed, layers, ones(), head, mtp)


def _trunk(params: DeepSeekModel, cfg: ModelConfig, tokens: torch.Tensor) -> tuple:
    """(hidden (B, S, D) before the final norm, the router loss summed over
    the MoE layers and divided by their count)."""
    x, auxes = D.run_layers(params, cfg, C.embed_lookup(params.embed, tokens),
                            layer_ffn(cfg, aux=True), attend=mla_prefill)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxes:
        aux = aux + a
    return x, aux / max(1, cfg.n_layers - cfg.first_k_dense)


@torch.no_grad()
def forward(params: DeepSeekModel, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, padded_vocab), aux, hidden (B, S,
    D)), causal, as the reference's: aux is the router loss summed over the
    MoE layers and divided by their count."""
    x, aux = _trunk(params, cfg, tokens)
    return D._unembed(params, cfg, x), aux, x


def loss_fn(params: DeepSeekModel, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token CE (chunked) plus ``router_aux_weight`` x the router loss
    and, with the ``mtp`` block, 0.3 x its CE: from (h_t, embed(tok_{t+1}))
    through ``ln_in``, ``proj`` and a dense MLA layer at d_ff = 4 x
    d_ff_expert, the token at t + 2 (``labels[:, 2:]``), as the reference's.
    Differentiable (``common.trainable``)."""
    tokens, labels = batch["tokens"], batch["labels"]
    h_final, aux = _trunk(params, cfg, tokens)
    head = D.head_fn(params, cfg)
    hn = C.rmsnorm(h_final, params.ln_f, cfg.norm_eps)
    loss = C.cross_entropy_chunked(hn[:, :-1], labels[:, 1:], head) + cfg.router_aux_weight * aux
    if cfg.mtp and params.mtp is not None:
        mp = params.mtp
        emb_next = C.embed_lookup(params.embed, tokens[:, 1:])
        h = h_final[:, :-1]
        cat = C.rmsnorm(torch.cat([h, emb_next.to(h.dtype)], dim=-1), mp.ln_in, cfg.norm_eps)
        mcfg = cfg.replace(d_ff=cfg.d_ff_expert * 4)
        steps = [lambda lp, y: mla_prefill(lp, y, mcfg), lambda lp, y: C.mlp_apply(lp.mlp, y)]
        h_mtp, _ = D._layer(mp.layer, C.linear(mp.proj, cat), steps, D._rms(mcfg))
        h_mtp = C.rmsnorm(h_mtp, params.ln_f, cfg.norm_eps)
        loss = loss + 0.3 * C.cross_entropy_chunked(h_mtp[:, :-1], labels[:, 2:], head)
    return loss


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=C.DTYPE,
                      device=None) -> dict:
    """Latent cache (L, B, max_len, kvr / rope) and positions (B,)."""
    return mla_init_cache(cfg, batch, max_len, cfg.n_layers, dtype, resolve_device(device))


@torch.no_grad()
def prefill(params: DeepSeekModel, cfg: ModelConfig, tokens: torch.Tensor, state: dict,
            length=None, prefix=None):
    """Prompt prefill, filling a copy of the latent cache; returns
    (last_logits (B, 1, V), state). ``length`` marks the real prompt length
    when tokens are bucket-padded; ``prefix`` = {"ckv": (L, B, m, kvr),
    "krope": (L, B, m, rope)} is a cached latent prefix (shared pages):
    tokens then hold the suffix only and the expanded attention runs over
    [expanded prefix; causal suffix]. Pad positions route through the
    experts and take capacity, as in the reference."""
    x, new_state = D.prefill_layers(params, cfg, C.embed_lookup(params.embed, tokens), state,
                                    layer_ffn(cfg), attend=mla_prefill, length=length,
                                    prefix=prefix)
    return D._unembed(params, cfg, C.select_at_length(x, length)), new_state


@torch.no_grad()
def decode_step(params: DeepSeekModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, V), state): the absorbed-form MLA
    over the dense latent cache or, with ``"bt"`` in state, the latent
    pools; each layer's latent lines are written in place after all layers
    and ``state["pos"]`` advances in place (``dense.decode_layers``)."""
    return D.decode_layers(params, cfg, state, tokens, layer_ffn(cfg), attend=mla_step)


def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active per token) parameter counts, as the reference's (the
    ``mtp`` block and the norms not counted)."""
    d = cfg.d_model
    h = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    attn = d * qr + qr * h * (nope + rope) + d * (kvr + rope) + kvr * h * (nope + vd) + h * vd * d
    dense_mlp = 3 * d * cfg.d_ff
    expert = 3 * d * cfg.d_ff_expert
    nd, nm = cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense
    shared = cfg.n_shared_experts * expert
    total = nd * (attn + dense_mlp) + nm * (attn + cfg.n_experts * expert + shared
                                            + d * cfg.n_experts)
    active = nd * (attn + dense_mlp) + nm * (attn + cfg.top_k * expert + shared
                                             + d * cfg.n_experts)
    emb = cfg.padded_vocab * d * 2
    return total + emb, active + emb
