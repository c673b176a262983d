"""OLMoE (``family="moe"``): the dense GQA attention of ``models/dense.py``
and an MoE FFN (``models/moe_layer.py``) in every layer, with the
reference's serving entry points (``repro/models/olmoe.py``).

Each decoder layer is an :class:`OLMoELayer` (``attn``, ``moe``, ``ln1``,
``ln2``); the model is a :class:`~repro_torch.models.dense.DenseModel`
holding them (embedding, layers, final norm, head). The decode paths write
the caches, pools and positions in place, as the dense family's do, so one
CUDA graph holds a whole step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.kernels.paged_attention import pool_rows
from repro_torch.models import common as C
from repro_torch.models import dense as D
from repro_torch.models.moe_layer import MoEFFN, moe_ffn, moe_init

__all__ = ["OLMoELayer", "init_params", "forward", "init_decode_state", "prefill",
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


def _block(lp: OLMoELayer, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
           prefix_kv=None, mask=None):
    h = C.rmsnorm(x, lp.ln1, cfg.norm_eps)
    att, k, v = C.gqa_prefill_attn(lp.attn, h, cfg, positions, prefix_kv=prefix_kv, mask=mask)
    x = x + att
    m, aux = moe_ffn(lp.moe, C.rmsnorm(x, lp.ln2, cfg.norm_eps), cfg)
    return x + m, k, v, aux


@torch.no_grad()
def forward(params: D.DenseModel, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, padded_vocab), aux), causal; aux is
    the router load-balancing loss averaged over the layers."""
    x = C.embed_lookup(params.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        x, _, _, a = _block(lp, x, cfg, positions)
        aux = aux + a
    return D._unembed(params, cfg, x), aux / cfg.n_layers


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
    x = C.embed_lookup(params.embed, tokens)
    b, s, _ = x.shape
    off = 0 if prefix is None else prefix["k"].shape[2]
    positions = off + torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    mask = None if prefix is None else C.prefix_attn_mask(s, off, x.device)
    k_cache = state["k"].clone()
    v_cache = state["v"].clone()
    for i, lp in enumerate(params.layers):
        x, k, v, _ = _block(lp, x, cfg, positions, mask=mask,
                            prefix_kv=None if prefix is None else (prefix["k"][i],
                                                                   prefix["v"][i]))
        k_cache[i, :, :s] = k.to(k_cache.dtype)
        v_cache[i, :, :s] = v.to(v_cache.dtype)
    new_state = {"k": k_cache, "v": v_cache,
                 "pos": off + C.prefill_pos(length, b, s, x.device)}
    return D._unembed(params, cfg, C.select_at_length(x, length)), new_state


@torch.no_grad()
def decode_step(params: D.DenseModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor):
    """tokens (B, sq) -> (logits (B, sq, V), state), in place as
    ``dense.decode_step``; sq > 1 stacks speculative draft rows (paged state
    only), whose norms and router logits run one draft column at a time."""
    x = C.embed_lookup(params.embed, tokens)
    b, sq = tokens.shape
    pos = C.slot_positions(state["pos"], b)[:, 0]
    paged = "bt" in state
    if paged:  # where each row lands, found before the layers launch
        kp0 = state["k"]
        slots = torch.arange(b, device=x.device)[:, None].expand(b, sq).reshape(-1)
        where = pool_rows(state["bt"], slots, C.slot_positions(pos, b, sq).reshape(-1),
                          kp0.shape[2], kp0.shape[1])
    kts, vts = [], []
    for i, lp in enumerate(params.layers):
        h = D._norm(x, lp.ln1, cfg)
        if paged:
            att, kt, vt = C.paged_attn(lp.attn, h, cfg, state["k"][i], state["v"][i],
                                       state["bt"], pos)
        else:
            att, kt, vt = C.attention_decode_ro(lp.attn, h, cfg, state["k"][i], state["v"][i],
                                                pos)
        x = x + att
        m, _ = moe_ffn(lp.moe, D._norm(x, lp.ln2, cfg), cfg, per_draft_row=True)
        x = x + m
        kts.append(kt)
        vts.append(vt)
    if paged:
        kvh, hd = cfg.n_kv_heads, cfg.head_dim
        C.write_page_rows(state["k"], torch.stack(kts).reshape(-1, b * sq, kvh, hd), where)
        C.write_page_rows(state["v"], torch.stack(vts).reshape(-1, b * sq, kvh, hd), where)
    else:
        C.update_cache_slot_stacked(state["k"], torch.stack(kts), pos)
        C.update_cache_slot_stacked(state["v"], torch.stack(vts), pos)
    state["pos"].copy_(pos + sq)
    return D._unembed(params, cfg, x), state


@torch.no_grad()
def ragged_step(params: D.DenseModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                slot: torch.Tensor, pos: torch.Tensor, ctx: torch.Tensor,
                logit_idx: torch.Tensor):
    """One unified ragged engine step, as ``dense.ragged_step``. Pad rows
    route through the experts and take capacity like bucketed-prefill pad
    tokens (keep ``capacity_factor`` generous for the token budget when
    exact equality with other modes matters)."""
    x = C.embed_lookup(params.embed, tokens[None, :])
    kp0 = state["k"]
    where = pool_rows(state["bt"], slot, pos, kp0.shape[2], kp0.shape[1])
    kts, vts = [], []
    for i, lp in enumerate(params.layers):
        h = C.rmsnorm(x, lp.ln1, cfg.norm_eps)
        att, kt, vt = C.ragged_attn(lp.attn, h, cfg, state["k"][i], state["v"][i], state["bt"],
                                    slot, pos, ctx)
        x = x + att
        m, _ = moe_ffn(lp.moe, C.rmsnorm(x, lp.ln2, cfg.norm_eps), cfg)
        x = x + m
        kts.append(kt)
        vts.append(vt)
    C.write_page_rows(state["k"], torch.stack(kts), where)
    C.write_page_rows(state["v"], torch.stack(vts), where)
    b = ctx.shape[0]
    counts = (slot.long()[None, :] == torch.arange(b, device=x.device)[:, None]).sum(dim=1)
    state["pos"].copy_(ctx.long() + counts)
    return D._unembed(params, cfg, x[0][logit_idx.long()][None])[0], state


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
