"""OLMoE (``family="moe"``): the dense GQA attention of ``models/dense.py``
and an MoE FFN (``models/moe_layer.py``) in every layer, with the
reference's serving entry points (``repro/models/olmoe.py``).

Each decoder layer is an :class:`OLMoELayer` (``attn``, ``moe``, ``ln1``,
``ln2``); the model is a :class:`~repro_torch.models.dense.DenseModel`
holding them (embedding, layers, final norm, head). The entry points run
the dense family's layer loops (``dense.prefill_layers``, ``decode_layers``,
``ragged_layers``) with the MoE block as the FFN, so the decode paths write
the caches, pools and positions in place and one CUDA graph holds a step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import dense as D
from repro_torch.models.moe_layer import MoEFFN, layer_ffn, moe_init

__all__ = ["OLMoELayer", "init_params", "forward", "loss_fn", "init_decode_state", "prefill",
           "decode_step", "ragged_step", "count_params"]


class OLMoELayer(nn.Module):
    """One pre-norm decoder layer: GQA attention + MoE FFN."""

    def __init__(self, attn: dict, moe: MoEFFN, ln1: torch.Tensor, ln2: torch.Tensor):
        super().__init__()
        self.attn = nn.ModuleDict(attn)
        self.moe = moe
        self.register_buffer("ln1", ln1)
        self.register_buffer("ln2", ln2)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> D.DenseModel:
    """Random parameters with the reference's init (attention and head
    N(0, 1/d_in), embedding N(0, 0.02^2), norms ones, experts as
    ``moe_layer.moe_init``), drawn from ``generator`` (else one seeded
    ``seed`` on the device). Runs on the card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def lin(d_in, d_out, bias=False):
        w = C.init_normal(gen, (d_in, d_out), C.dense_std(d_in), dev)
        b = torch.zeros((d_out,), dtype=C.DTYPE, device=dev) if bias else None
        return C.Linear(w, b)

    def ones():
        return torch.ones((d,), dtype=C.DTYPE, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        attn = {"q": lin(d, h * hd, cfg.qkv_bias), "k": lin(d, kvh * hd, cfg.qkv_bias),
                "v": lin(d, kvh * hd, cfg.qkv_bias), "o": lin(h * hd, d)}
        layers.append(OLMoELayer(attn, moe_init(gen, cfg, dev), ones(), ones()))
    embed = C.init_normal(gen, (cfg.padded_vocab, d), 0.02, dev)
    head = None if cfg.tie_embeddings else lin(d, cfg.padded_vocab)
    return D.DenseModel(embed, layers, ones(), head)


def _trunk(params: D.DenseModel, cfg: ModelConfig, tokens: torch.Tensor) -> tuple:
    """(final-norm hidden (B, S, D), the router loss averaged over the
    layers)."""
    x, auxes = D.run_layers(params, cfg, C.embed_lookup(params.embed, tokens),
                            layer_ffn(cfg, aux=True))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for a in auxes:
        aux = aux + a
    return C.rmsnorm(x, params.ln_f, cfg.norm_eps), aux / cfg.n_layers


@torch.no_grad()
def forward(params: D.DenseModel, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, padded_vocab), aux), causal; aux is
    the router load-balancing loss averaged over the layers."""
    h, aux = _trunk(params, cfg, tokens)
    return D.head_fn(params, cfg)(h), aux


def loss_fn(params: D.DenseModel, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token CE (chunked) plus ``router_aux_weight`` x the router
    loss averaged over the layers; differentiable (``common.trainable``)."""
    h, aux = _trunk(params, cfg, batch["tokens"])
    ce = C.cross_entropy_chunked(h[:, :-1], batch["labels"][:, 1:], D.head_fn(params, cfg))
    return ce + cfg.router_aux_weight * aux


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=C.DTYPE,
                      device=None) -> dict:
    """Dense per-slot KV cache (L, B, max_len, KV, hd) and positions (B,)."""
    return C.init_kv_cache(cfg, batch, max_len, cfg.n_layers, dtype, resolve_device(device))


@torch.no_grad()
def prefill(params: D.DenseModel, cfg: ModelConfig, tokens: torch.Tensor, state: dict,
            length=None, prefix=None):
    """Prompt prefill; ``length`` / ``prefix`` as in ``dense.prefill``
    (bucket padding and cached-prefix suffix prefill). Pad positions route
    through the experts and take capacity, as in the reference."""
    x, new_state = D.prefill_layers(params, cfg, C.embed_lookup(params.embed, tokens), state,
                                    layer_ffn(cfg), length=length, prefix=prefix)
    return D._unembed(params, cfg, C.select_at_length(x, length)), new_state


@torch.no_grad()
def decode_step(params: D.DenseModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor):
    """tokens (B, sq) -> (logits (B, sq, V), state), in place as
    ``dense.decode_step``; sq > 1 stacks speculative draft rows (paged state
    only), whose norms and router logits run one draft column at a time."""
    return D.decode_layers(params, cfg, state, tokens, layer_ffn(cfg, per_draft_row=True))


@torch.no_grad()
def ragged_step(params: D.DenseModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                slot: torch.Tensor, pos: torch.Tensor, ctx: torch.Tensor,
                logit_idx: torch.Tensor):
    """One unified ragged engine step, as ``dense.ragged_step``. Pad rows
    route through the experts and take capacity like bucketed-prefill pad
    tokens (keep ``capacity_factor`` generous for the token budget when
    exact equality with other modes matters)."""
    return D.ragged_layers(params, cfg, state, tokens, slot, pos, ctx, logit_idx, layer_ffn(cfg))


def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active per token) parameter counts, as the reference's."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    expert = 3 * d * cfg.d_ff_expert
    per_layer_total = attn + cfg.n_experts * expert + d * cfg.n_experts + 2 * d
    per_layer_active = attn + cfg.top_k * expert + d * cfg.n_experts + 2 * d
    emb = cfg.padded_vocab * d * 2
    return (cfg.n_layers * per_layer_total + emb + d,
            cfg.n_layers * per_layer_active + emb + d)
