"""Dense decoder-only transformer (llama3 / qwen3): modules, init and the
serving entry points.

The reference scan-stacks its layers as ``(L, ...)`` arrays; here each
decoder layer is a :class:`DenseLayer` in an ``nn.ModuleList``, with the
reference's parameter names (``attn/{q,k,v,o}`` or ``attn/{qkv,o}``,
``mlp/{gate,up,down}`` or ``mlp/{gate_up,down}``, ``ln1``, ``ln2``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.kernels.paged_attention import pool_rows
from repro_torch.models import common as C

__all__ = ["DenseLayer", "DenseModel", "init_params", "forward", "init_decode_state",
           "prefill", "decode_step", "ragged_step"]


class DenseLayer(nn.Module):
    """One pre-norm decoder layer: GQA attention + SwiGLU MLP."""

    def __init__(self, attn: dict, mlp: dict, ln1: torch.Tensor, ln2: torch.Tensor):
        super().__init__()
        self.attn = nn.ModuleDict(attn)
        self.mlp = nn.ModuleDict(mlp)
        self.register_buffer("ln1", ln1)
        self.register_buffer("ln2", ln2)


class DenseModel(nn.Module):
    """Embedding, decoder layers, final norm and (untied) bf16 head."""

    def __init__(self, embed: torch.Tensor, layers: list, ln_f: torch.Tensor,
                 head: Optional[nn.Module]):
        super().__init__()
        self.register_buffer("embed", embed)
        self.layers = nn.ModuleList(layers)
        self.register_buffer("ln_f", ln_f)
        self.head = head


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> DenseModel:
    """Random bf16 parameters with the reference's init: N(0, 1/d_in) for
    linears, N(0, 0.02^2) for the embedding, ones for norms. Runs on the
    card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

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
        mlp = {"gate": lin(d, f), "up": lin(d, f), "down": lin(f, d)}
        layers.append(DenseLayer(attn, mlp, ones(), ones()))
    embed = C.init_normal(gen, (cfg.padded_vocab, d), 0.02, dev)
    head = None if cfg.tie_embeddings else lin(d, cfg.padded_vocab)
    return DenseModel(embed, layers, ones(), head)


def _norm(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return C.per_draft_row(lambda y: C.rmsnorm(y, w, cfg.norm_eps), x)


def _unembed(params: DenseModel, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = C.rmsnorm(x, params.ln_f, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params.embed.to(x.dtype).T
    return C.linear(params.head, x)


def _block(lp: DenseLayer, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
           prefix_kv=None, mask=None):
    h = C.rmsnorm(x, lp.ln1, cfg.norm_eps)
    att, k, v = C.gqa_prefill_attn(lp.attn, h, cfg, positions, prefix_kv=prefix_kv, mask=mask)
    x = x + att
    x = x + C.mlp_apply(lp.mlp, C.rmsnorm(x, lp.ln2, cfg.norm_eps))
    return x, k, v


@torch.no_grad()
def forward(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab), causal."""
    x = C.embed_lookup(params.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    for lp in params.layers:
        x, _, _ = _block(lp, x, cfg, positions)
    return _unembed(params, cfg, x)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=C.DTYPE,
                      device=None) -> dict:
    """Dense per-slot KV cache (L, B, max_len, KV, hd) and positions (B,)."""
    return C.init_kv_cache(cfg, batch, max_len, cfg.n_layers, dtype, resolve_device(device))


@torch.no_grad()
def prefill(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor, state: dict,
            length=None, prefix=None):
    """Run the prompt, filling a copy of the cache. Returns (last_logits
    (B, 1, V), state). ``length`` (B,) marks the real prompt length when
    ``tokens`` is padded to a bucket: attention is causal, so the pad tail
    cannot perturb real positions, and logits / ``pos`` come from position
    ``length - 1``. ``state`` itself is left unchanged.

    ``prefix`` = {"k": (L, B, m, KV, hd), "v": ...} is an already-cached
    post-RoPE prompt prefix (the engine's prefix cache, gathered from shared
    pages): ``tokens`` then holds only the suffix, every suffix query
    attends [prefix; causal suffix], positions start at m, the returned
    cache rows hold the suffix only (from row 0) and ``pos`` counts m too."""
    x = C.embed_lookup(params.embed, tokens)
    b, s, _ = x.shape
    off = 0 if prefix is None else prefix["k"].shape[2]
    positions = off + torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    mask = None if prefix is None else C.prefix_attn_mask(s, off, x.device)
    k_cache = state["k"].clone()
    v_cache = state["v"].clone()
    for i, lp in enumerate(params.layers):
        x, k, v = _block(lp, x, cfg, positions, mask=mask,
                         prefix_kv=None if prefix is None else (prefix["k"][i], prefix["v"][i]))
        k_cache[i, :, :s] = k.to(k_cache.dtype)
        v_cache[i, :, :s] = v.to(v_cache.dtype)
    new_state = {"k": k_cache, "v": v_cache,
                 "pos": off + C.prefill_pos(length, b, s, x.device)}
    return _unembed(params, cfg, C.select_at_length(x, length)), new_state


@torch.no_grad()
def decode_step(params: DenseModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor):
    """tokens (B, sq) -> (logits (B, sq, V), state). Each slot attends its own
    cache prefix; the new rows are written into ``state``'s caches (dense) or
    pools (paged, ``"bt"`` in state) in place after all layers ran, and
    ``state["pos"]`` advances by sq in place: the returned state is ``state``
    itself, its tensors the same objects, so a captured step reads and
    writes the same memory at every replay.

    ``sq > 1`` stacks speculative draft rows (paged state only): the paged
    branch routes ``dispatch.paged_decode``, whose row i equals a one-row
    decode at ``pos + i`` once the earlier drafts are committed. The rmsnorms
    run one draft column at a time (``C.per_draft_row``): their mean over D
    gives some rows other bits at B * sq rows than at B. The linears are
    row-independent kernels, and the bf16 head gives every row the same bits
    stacked (``chip_smoke.py``'s speculative probe checks both)."""
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
        h = _norm(x, lp.ln1, cfg)
        if paged:
            att, kt, vt = C.paged_attn(lp.attn, h, cfg, state["k"][i], state["v"][i],
                                       state["bt"], pos)
        else:
            att, kt, vt = C.attention_decode_ro(lp.attn, h, cfg, state["k"][i], state["v"][i],
                                                pos)
        x = x + att
        x = x + C.mlp_apply(lp.mlp, _norm(x, lp.ln2, cfg))
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
    return _unembed(params, cfg, x), state


@torch.no_grad()
def ragged_step(params: DenseModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                slot: torch.Tensor, pos: torch.Tensor, ctx: torch.Tensor,
                logit_idx: torch.Tensor):
    """One unified ragged engine step over a flat batch: ``tokens, slot,
    pos (T,)`` are the rows (slot == B pads), ``ctx (B,)`` each slot's
    committed rows at step start, ``logit_idx (B,)`` the row whose logits
    each slot wants back. Needs the paged state. The rows are committed to
    the pools in place and ``state["pos"]`` becomes ``ctx +`` the rows
    scheduled per slot, in place; returns (logits (B, V), state), the state
    being ``state`` itself."""
    x = C.embed_lookup(params.embed, tokens[None, :])
    kp0 = state["k"]
    where = pool_rows(state["bt"], slot, pos, kp0.shape[2], kp0.shape[1])
    kts, vts = [], []
    for i, lp in enumerate(params.layers):
        h = C.rmsnorm(x, lp.ln1, cfg.norm_eps)
        att, kt, vt = C.ragged_attn(lp.attn, h, cfg, state["k"][i], state["v"][i], state["bt"],
                                    slot, pos, ctx)
        x = x + att
        x = x + C.mlp_apply(lp.mlp, C.rmsnorm(x, lp.ln2, cfg.norm_eps))
        kts.append(kt)
        vts.append(vt)
    C.write_page_rows(state["k"], torch.stack(kts), where)
    C.write_page_rows(state["v"], torch.stack(vts), where)
    b = ctx.shape[0]
    counts = (slot.long()[None, :] == torch.arange(b, device=x.device)[:, None]).sum(dim=1)
    state["pos"].copy_(ctx.long() + counts)
    return _unembed(params, cfg, x[0][logit_idx.long()][None])[0], state
