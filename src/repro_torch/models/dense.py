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
from repro_torch.models import common as C

__all__ = ["DenseLayer", "DenseModel", "init_params", "forward", "init_decode_state",
           "prefill", "decode_step"]


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


def _unembed(params: DenseModel, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = C.rmsnorm(x, params.ln_f, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params.embed.to(x.dtype).T
    return C.linear(params.head, x)


def _block(lp: DenseLayer, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    h = C.rmsnorm(x, lp.ln1, cfg.norm_eps)
    att, k, v = C.gqa_prefill_attn(lp.attn, h, cfg, positions)
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
            length=None):
    """Run the prompt, filling a copy of the cache. Returns (last_logits
    (B, 1, V), state). ``length`` (B,) marks the real prompt length when
    ``tokens`` is padded to a bucket: attention is causal, so the pad tail
    cannot perturb real positions, and logits / ``pos`` come from position
    ``length - 1``. ``state`` itself is left unchanged."""
    x = C.embed_lookup(params.embed, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    k_cache = state["k"].clone()
    v_cache = state["v"].clone()
    for i, lp in enumerate(params.layers):
        x, k, v = _block(lp, x, cfg, positions)
        k_cache[i, :, :s] = k.to(k_cache.dtype)
        v_cache[i, :, :s] = v.to(v_cache.dtype)
    new_state = {"k": k_cache, "v": v_cache, "pos": C.prefill_pos(length, b, s, x.device)}
    return _unembed(params, cfg, C.select_at_length(x, length)), new_state


@torch.no_grad()
def decode_step(params: DenseModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor):
    """tokens (B, sq) -> (logits (B, sq, V), state). Each slot attends its own
    cache prefix; the new rows are written into ``state``'s caches in place
    after all layers ran, and ``pos`` advances by sq."""
    x = C.embed_lookup(params.embed, tokens)
    b, sq = tokens.shape
    pos = C.slot_positions(state["pos"], b)[:, 0]
    kts, vts = [], []
    for i, lp in enumerate(params.layers):
        h = C.rmsnorm(x, lp.ln1, cfg.norm_eps)
        att, kt, vt = C.attention_decode_ro(lp.attn, h, cfg, state["k"][i], state["v"][i], pos)
        x = x + att
        x = x + C.mlp_apply(lp.mlp, C.rmsnorm(x, lp.ln2, cfg.norm_eps))
        kts.append(kt)
        vts.append(vt)
    C.update_cache_slot_stacked(state["k"], torch.stack(kts), pos)
    C.update_cache_slot_stacked(state["v"], torch.stack(vts), pos)
    new_state = {"k": state["k"], "v": state["v"], "pos": pos + sq}
    return _unembed(params, cfg, x), new_state
