"""Whisper-style encoder-decoder (``whisper-base``, family ``encdec``): the
port of ``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_frames, D) (``Request.frontend =
{"frames": ...}`` in the engine). Both stacks use LayerNorm, a GELU MLP with
biases and sinusoidal positions (no RoPE). A decoder layer has three
pre-norm sublayers, each on its own LayerNorm: causal self-attention
(``ln1``), cross-attention over the encoder states (``ln2``) and the MLP
(``ln3``). The decoder runs ``models/dense.py``'s one layer loop with that
list of steps: its self-attention is the dense family's attention step
(``rope_theta`` 0 turns RoPE off), so decode goes through
``attention_decode_ro`` (bucketed) or the paged kernel; its cross-attention
is the reference's plain ``_sdpa`` over the per-slot ``xk`` / ``xv`` rows a
prefill computes once and every decode step only reads. The decoder's head
is tied to the embedding.

Layers are one module each (``enc_layers``, ``dec_layers``), with the
reference's names: ``attn/{q,k,v,o}`` (``attn/qkv`` once fused),
``xattn/{q,k,v,o}`` (never fused: q projects the decoder stream, k/v the
encoder states; a prefill fuses k/v at call time), ``mlp/{up,down}`` and
the LayerNorms ``ln1`` … ``ln3`` (``w``, ``b``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import dense as D

__all__ = ["LayerNorm", "EncLayer", "DecLayer", "EncDecModel", "init_params", "encode",
           "forward", "loss_fn", "init_decode_state", "prefill", "decode_step", "count_params"]


class LayerNorm(nn.Module):
    """LayerNorm parameters: ``w`` and ``b`` (D,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)


class EncLayer(nn.Module):
    """Encoder layer: full self-attention (``ln1``) and the GELU MLP (``ln2``)."""

    def __init__(self, attn: dict, mlp: dict, ln1: LayerNorm, ln2: LayerNorm):
        super().__init__()
        self.attn = nn.ModuleDict(attn)
        self.mlp = nn.ModuleDict(mlp)
        self.ln1, self.ln2 = ln1, ln2


class DecLayer(nn.Module):
    """Decoder layer: causal self-attention (``ln1``), cross-attention
    (``ln2``) and the GELU MLP (``ln3``)."""

    def __init__(self, attn: dict, xattn: dict, mlp: dict, ln1: LayerNorm, ln2: LayerNorm,
                 ln3: LayerNorm):
        super().__init__()
        self.attn = nn.ModuleDict(attn)
        self.xattn = nn.ModuleDict(xattn)
        self.mlp = nn.ModuleDict(mlp)
        self.ln1, self.ln2, self.ln3 = ln1, ln2, ln3


class EncDecModel(nn.Module):
    """Embedding (the tied head), encoder and decoder layers, ``ln_enc`` and
    ``ln_f``. ``layers`` is the decoder stack, for the shared layer loop."""

    def __init__(self, embed: torch.Tensor, enc_layers: list, dec_layers: list,
                 ln_enc: LayerNorm, ln_f: LayerNorm):
        super().__init__()
        self.register_buffer("embed", embed)
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.ln_enc, self.ln_f = ln_enc, ln_f

    @property
    def layers(self) -> nn.ModuleList:
        return self.dec_layers


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> EncDecModel:
    """Random bf16 parameters with the reference's init: N(0, 1/d_in)
    linears with zero biases in the MLP, N(0, 0.02^2) embedding, LayerNorms
    of ones and zeros. Runs on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    d, f, hhd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim

    def lin(d_in, d_out, bias=False):
        w = C.init_normal(gen, (d_in, d_out), C.dense_std(d_in), dev)
        return C.Linear(w, torch.zeros((d_out,), dtype=C.DTYPE, device=dev) if bias else None)

    def ln():
        return LayerNorm(torch.ones((d,), dtype=C.DTYPE, device=dev),
                         torch.zeros((d,), dtype=C.DTYPE, device=dev))

    def attn():
        return {"q": lin(d, hhd), "k": lin(d, hhd), "v": lin(d, hhd), "o": lin(hhd, d)}

    def mlp():
        return {"up": lin(d, f, bias=True), "down": lin(f, d, bias=True)}

    embed = C.init_normal(gen, (cfg.padded_vocab, d), 0.02, dev)
    enc = [EncLayer(attn(), mlp(), ln(), ln()) for _ in range(cfg.n_enc_layers)]
    dec = [DecLayer(attn(), attn(), mlp(), ln(), ln(), ln()) for _ in range(cfg.n_layers)]
    return EncDecModel(embed, enc, dec, ln(), ln())


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position embeddings (..., d) in bf16: sin then cos halves."""
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / max(half - 1, 1))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(C.DTYPE)


def _ln(cfg: ModelConfig):
    return lambda y, p: C.layernorm(y, p.w, p.b, cfg.norm_eps)


def _gelu_mlp(lp, x: torch.Tensor) -> torch.Tensor:
    h = C.gelu(C.linear(lp.mlp["up"], x).to(torch.float32)).to(x.dtype)
    return C.linear(lp.mlp["down"], h)


def _heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], cfg.n_heads, cfg.head_dim)


def _full(b: int, sq: int, sk: int, device) -> torch.Tensor:
    return torch.ones((b, sq, sk), dtype=torch.bool, device=device)


def _cross_kv(p: nn.ModuleDict, enc: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Cross-attention k, v (B, F, H, hd) of the encoder states: one launch
    (the packs fuse at call time)."""
    k, v = C.linear_group(p, ("k", "v"), "kv", enc)
    return _heads(k, cfg), _heads(v, cfg)


def _cross(p: nn.ModuleDict, h: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of the decoder rows ``h`` over every encoder row."""
    b, sq, _ = h.shape
    q = _heads(C.linear(p["q"], h), cfg)
    out = C._sdpa(q, xk, xv, _full(1, sq, xk.shape[1], h.device))
    return C.linear(p["o"], out.reshape(b, sq, -1))


def _self_full(p: nn.ModuleDict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's non-causal self-attention (fused q/k/v)."""
    b, s, _ = h.shape
    q, k, v = (_heads(t, cfg) for t in C.linear_group(p, ("q", "k", "v"), "qkv", h))
    out = C._sdpa(q, k, v, _full(1, s, s, h.device))
    return C.linear(p["o"], out.reshape(b, s, -1))


def _enc_layer(lp: EncLayer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    norm = _ln(cfg)
    x = x + _self_full(lp.attn, norm(x, lp.ln1), cfg)
    return x + _gelu_mlp(lp, norm(x, lp.ln2))


def encode(params: EncDecModel, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, n_frames, D) stub embeddings -> encoder states (B, F, D);
    each layer rematerialised in the backward when ``cfg.remat`` (under
    autograd only)."""
    _, s, d = frames.shape
    pos = torch.arange(s, device=frames.device)[None, :]
    x = frames.to(C.DTYPE) + _sinusoid(pos, d)
    for lp in params.enc_layers:
        x = C.remat(_enc_layer, lp, x, cfg, enabled=cfg.remat)
    return _ln(cfg)(x, params.ln_enc)


def _embed(params: EncDecModel, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    return C.embed_lookup(params.embed, tokens) + _sinusoid(positions, cfg.d_model)


def _unembed(params: EncDecModel, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = C.layernorm(x, params.ln_f.w, params.ln_f.b, cfg.norm_eps)
    return x @ C.embed_attend(params.embed).to(x.dtype).T  # tied head


def _hidden(params: EncDecModel, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder's rows (B, S, D) before ``ln_f``."""
    enc = encode(params, cfg, frames)
    _, s = tokens.shape
    x = _embed(params, cfg, tokens, torch.arange(s, device=tokens.device)[None, :])

    def cross(lp, h, cfg, positions):
        return _cross(lp.xattn, h, *_cross_kv(lp.xattn, enc, cfg), cfg)

    return D.run_layers(params, cfg, x, _gelu_mlp, attend=[D.gqa_prefill, cross],
                        norm=_ln(cfg))[0]


@torch.no_grad()
def forward(params: EncDecModel, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder over the encoded frames: (B, S, V) logits."""
    return _unembed(params, cfg, _hidden(params, cfg, tokens, frames))


def loss_fn(params: EncDecModel, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token CE (chunked, through the tied head) of the decoder over
    ``batch["frames"]`` (B, n_frames, D); differentiable
    (``common.trainable``)."""
    x = _hidden(params, cfg, batch["tokens"], batch["frames"])
    h = C.layernorm(x, params.ln_f.w, params.ln_f.b, cfg.norm_eps)
    return C.cross_entropy_chunked(h[:, :-1], batch["labels"][:, 1:],
                                   lambda xc: xc @ C.embed_attend(params.embed).to(xc.dtype).T)


# ---------------------------------------------------------------------------
# serving: cross-attention rows computed once at prefill, self-attention
# rows cached (dense per slot, or in page pools)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=C.DTYPE,
                      device=None) -> dict:
    """Self-attention cache ``k`` / ``v`` (L, B, max_len, H, hd), the
    per-slot cross-attention rows ``xk`` / ``xv`` (L, B, n_frames, H, hd) and
    positions (B,)."""
    dev = resolve_device(device)
    h, hd, L = cfg.n_heads, cfg.head_dim, cfg.n_layers

    def z(s):
        return torch.zeros((L, batch, s, h, hd), dtype=dtype, device=dev)

    return {"k": z(max_len), "v": z(max_len), "xk": z(cfg.n_frames), "xv": z(cfg.n_frames),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


@torch.no_grad()
def prefill(params: EncDecModel, cfg: ModelConfig, tokens: torch.Tensor, state: dict,
            frames: torch.Tensor = None, length=None, prefix=None):
    """Encode ``frames`` (B, n_frames, D), run the prompt through the decoder
    and fill a copy of the state: the self-attention rows of the prompt and
    every layer's cross-attention ``xk`` / ``xv``. ``length`` (B,) marks the
    real prompt length under bucket padding (causal self-attention keeps
    real positions exact; logits and ``pos`` come from position length-1).
    Returns (last_logits (B, 1, V), state); ``state`` is left unchanged. No
    prefix cache: the cross-attention rows are the request's own."""
    if prefix is not None:
        raise ValueError("encdec serves no prefix cache: its per-slot encoder rows are the "
                         "request's own")
    if frames is None:
        raise ValueError("encdec prefill needs the request's frames (B, n_frames, d_model)")
    enc = encode(params, cfg, frames)
    _, s = tokens.shape
    x = _embed(params, cfg, tokens, torch.arange(s, device=tokens.device)[None, :])

    def cross(lp, h, cfg, positions, mask, pre):
        xk, xv = _cross_kv(lp.xattn, enc, cfg)
        return _cross(lp.xattn, h, xk, xv, cfg), {"xk": xk, "xv": xv}

    x, new_state = D.prefill_layers(params, cfg, x, state, _gelu_mlp,
                                    attend=[D.gqa_prefill, cross], length=length, norm=_ln(cfg))
    return _unembed(params, cfg, C.select_at_length(x, length)), new_state


def _cross_decode(lp, h, cfg, cache, bt, pos):
    """The decode step's cross-attention: over this layer's per-slot
    encoder rows, read only (no rows returned, none written)."""
    return _cross(lp.xattn, h, cache["xk"], cache["xv"], cfg)


@torch.no_grad()
def decode_step(params: EncDecModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, V), state): the dense family's decode
    attention over the self-attention cache (paged when ``"bt"`` is in
    state), cross-attention over ``xk`` / ``xv``; the self-attention rows
    and ``pos`` are written in place (``dense.decode_layers``), so the
    returned state is ``state`` itself."""
    return D.decode_layers(
        params, cfg, state, tokens, _gelu_mlp, attend=[D.gqa_decode, _cross_decode],
        norm=_ln(cfg), embed=lambda t, pos: _embed(params, cfg, t, pos[:, None]),
        unembed=lambda x: _unembed(params, cfg, x))


def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameters, as the reference counts them."""
    d, f, h, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    attn = 4 * d * h * hd
    enc_l = attn + 2 * d * f + 4 * d
    dec_l = 2 * attn + 2 * d * f + 6 * d
    total = cfg.n_enc_layers * enc_l + cfg.n_layers * dec_l + cfg.padded_vocab * d + 4 * d
    return total, total
