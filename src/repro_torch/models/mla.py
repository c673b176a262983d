"""Multi-head Latent Attention (DeepSeek-V3) of the port, in plain PyTorch
(the reference's ``repro/models/mla.py`` is ``jnp`` too: no Pallas kernel).

Prefill runs the expanded form (q/k head dim ``qk_nope + qk_rope``, v head
dim ``v_head_dim``); decode runs the absorbed form over the compressed
latent cache (``ckv`` of ``kv_lora_rank`` and one shared RoPE key
``krope`` of ``qk_rope_dim`` per position), folding ``wkv_b``'s k half into
the query and its v half into the output.

A layer's attention is an :class:`MLAAttention`: a module dict of the
linears ``wq_a``, ``wq_b``, ``wkv_a``, ``wkv_b``, ``o`` (``wq_a`` and
``wkv_a`` fused into ``wqkv_a`` by ``core.twinquant.fuse_params``) with the
buffers ``q_norm`` and ``kv_norm``. ``wkv_b`` stays bf16 (the packer's
``EXCLUDE``): decode uses its weight as an einsum operand.

Unlike the reference, the decode steps never write the cache: they attend
over a copy of it (the dense cache, or the pools gathered through the block
table) with this step's latent line put in at ``pos``, as the reference's
cache holds it when it attends, and return that line; the layer loop
(``dense.decode_layers``) writes every layer's lines in place after all
layers ran. Fixed shapes, no host sync: a step captures as one CUDA graph.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.models import common as C

__all__ = ["MLAAttention", "mla_init", "mla_prefill_layer", "mla_init_cache", "mla_decode",
           "mla_decode_paged", "mla_prefill", "mla_step"]


class MLAAttention(nn.ModuleDict):
    """One layer's MLA: the linears by name, ``q_norm`` (q_lora) and
    ``kv_norm`` (kv_lora) as buffers."""

    def __init__(self, linears: dict, q_norm: torch.Tensor, kv_norm: torch.Tensor):
        super().__init__(linears)
        self.register_buffer("q_norm", q_norm)
        self.register_buffer("kv_norm", kv_norm)


def mla_init(gen: torch.Generator, cfg: ModelConfig, device) -> MLAAttention:
    """Random bf16 MLA with the reference's init: linears N(0, 1/d_in),
    norms ones, from ``gen`` on ``device``."""
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    def lin(d_in, d_out):
        return C.Linear(C.init_normal(gen, (d_in, d_out), C.dense_std(d_in), device))

    return MLAAttention(
        {"wq_a": lin(d, qr), "wq_b": lin(qr, h * (nope + rope)), "wkv_a": lin(d, kvr + rope),
         "wkv_b": lin(kvr, h * (nope + vd)), "o": lin(h * vd, d)},
        torch.ones((qr,), dtype=C.DTYPE, device=device),
        torch.ones((kvr,), dtype=C.DTYPE, device=device))


def _rope_1head(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on a (B, S, r) tensor (the shared key rope path, one 'head')."""
    tables = C.rope_tables(positions, x.shape[-1], 1.0, theta)
    return C.apply_rope(x[:, :, None, :], tables)[:, :, 0, :]


def _down_projs(p: MLAAttention, x: torch.Tensor):
    """The two latent down-projections of x: ``wq_a`` and ``wkv_a`` share
    the layer input, so packed they run as ONE fused launch (``wqkv_a``).
    Returns (cq_raw, ckv_full)."""
    return C.linear_group(p, ("wq_a", "wkv_a"), "wqkv_a", x)


def _latents(p: MLAAttention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope) post-RoPE, ckv (B,S,kvr),
    krope (B,S,rope) post-RoPE) of x (B, S, D) at ``positions`` (B, S)."""
    b, s, _ = x.shape
    h, nope, rope, kvr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    cq_raw, ckv_full = _down_projs(p, x)
    cq = C.rmsnorm(cq_raw, p.q_norm, cfg.norm_eps)
    q = C.linear(p["wq_b"], cq).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = C.apply_rope(q_rope, C.rope_tables(positions, rope, 1.0, cfg.rope_theta))
    ckv = C.rmsnorm(ckv_full[..., :kvr], p.kv_norm, cfg.norm_eps)
    krope = _rope_1head(ckv_full[..., kvr:], positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, krope


def _expand_latent(p: MLAAttention, ckv: torch.Tensor, cfg: ModelConfig, dtype):
    """Latent (B, m, kvr) -> expanded (k_nope (B,m,H,nope), v (B,m,H,vd))."""
    b, m, _ = ckv.shape
    kv = C.linear(p["wkv_b"], ckv.to(dtype)).reshape(b, m, cfg.n_heads,
                                                     cfg.qk_nope_dim + cfg.v_head_dim)
    return kv[..., :cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]


def _keys(k_nope: torch.Tensor, krope: torch.Tensor) -> torch.Tensor:
    """Per-head keys [k_nope; the shared krope broadcast over the heads]."""
    b, s, h, _ = k_nope.shape
    return torch.cat([k_nope, krope[:, :, None, :].expand(b, s, h, krope.shape[-1])], dim=-1)


def mla_prefill_layer(p: MLAAttention, x: torch.Tensor, cfg: ModelConfig, prefix=None):
    """Expanded attention; returns (out (B, S, D), ckv (B, S, kvr), krope
    (B, S, rope)): this layer's latent cache lines.

    ``prefix`` = (ckv_pre (B, m, kvr), krope_pre (B, m, rope)): a cached
    (post-RoPE krope) prompt prefix; x then holds only the suffix, whose
    queries attend [expanded prefix; causal suffix] with positions offset by
    m: the engine's prefix-cache suffix prefill."""
    b, s, _ = x.shape
    h, vd = cfg.n_heads, cfg.v_head_dim
    off = 0 if prefix is None else prefix[0].shape[1]
    positions = off + torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    q_nope, q_rope, ckv, krope = _latents(p, x, cfg, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k_nope, v = _expand_latent(p, ckv, cfg, x.dtype)
    k = _keys(k_nope, krope)
    if prefix is None:
        out = C._sdpa_causal_chunked(q, k, v)
    else:
        ckv_pre, krope_pre = prefix
        pk_nope, pv = _expand_latent(p, ckv_pre, cfg, x.dtype)
        pk = _keys(pk_nope, krope_pre.to(x.dtype))
        out = C._sdpa(q, torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1),
                      C.prefix_attn_mask(s, off, x.device))
    return C.linear(p["o"], out.reshape(b, s, h * vd)), ckv, krope


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                   dtype=C.DTYPE, device=None) -> dict:
    """Latent cache ``ckv`` (L, B, max_len, kvr), ``krope`` (L, B, max_len,
    rope) and positions (B,)."""
    return {
        "ckv": torch.zeros((n_layers, batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((n_layers, batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _with_row(cache: torch.Tensor, t: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """A copy of ``cache`` (B, S, r) whose row ``pos[b]`` of slot b is t (B,
    1, r); a position past S writes nothing (the reference's drop)."""
    rows = torch.arange(cache.shape[1], device=cache.device)[None, :, None]
    return torch.where(rows == pos.to(torch.long)[:, None, None], t.to(cache.dtype), cache)


def mla_decode(p: MLAAttention, x: torch.Tensor, cfg: ModelConfig, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, pos: torch.Tensor):
    """Absorbed-form one-token decode over one layer's dense latent cache
    (or any per-slot view of it): x (B, 1, D); ckv_cache (B, S_max, kvr);
    krope_cache (B, S_max, rope); pos (B,) per slot. Attends over a copy
    with this step's latent line at ``pos`` and returns (out (B, 1, D),
    ckv_t (B, 1, kvr), krope_t (B, 1, rope)); the caches are left as they
    are."""
    b, sq, _ = x.shape
    h, nope, rope, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    positions = C.slot_positions(pos, b, sq)
    pos_v = positions[:, 0]
    q_nope, q_rope, ckv_t, krope_t = _latents(p, x, cfg, positions)
    # this step's latent line, where the reference writes it before it attends
    ckv_cache = _with_row(ckv_cache, ckv_t, pos_v)
    krope_cache = _with_row(krope_cache, krope_t, pos_v)
    # absorb W_uk into q: q_eff (B, 1, H, kvr)
    wkv_b = p["wkv_b"].w.reshape(kvr, h, nope + vd)
    w_k, w_v = wkv_b[..., :nope], wkv_b[..., nope:]
    q_eff = torch.einsum("bqhn,khn->bqhk", q_nope, w_k.to(x.dtype))
    s_max = ckv_cache.shape[1]
    logits = torch.einsum("bqhk,btk->bhqt", q_eff, ckv_cache).to(torch.float32)
    logits = logits + torch.einsum("bqhr,btr->bhqt", q_rope, krope_cache).to(torch.float32)
    logits = logits / ((nope + rope) ** 0.5)
    mask = (torch.arange(s_max, device=x.device)[None, None, None, :]
            <= pos_v[:, None, None, None])
    logits = torch.where(mask, logits, C._NEG)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqt,btk->bqhk", probs, ckv_cache)
    out = torch.einsum("bqhk,khv->bqhv", ctx, w_v.to(x.dtype))
    return C.linear(p["o"], out.reshape(b, sq, h * vd)), ckv_t, krope_t


def mla_decode_paged(p: MLAAttention, x: torch.Tensor, cfg: ModelConfig,
                     ckv_pool: torch.Tensor, krope_pool: torch.Tensor, bt: torch.Tensor,
                     pos: torch.Tensor):
    """Paged decode: this layer's latent pages (P, page, ...) gathered
    through the block table ``bt`` (B, maxp) into the dense per-slot view
    (unmapped entries read page 0, behind the ``pos`` mask), then the same
    absorbed-form math; returns (out, ckv_t, krope_t) for the caller's one
    pool write after all layers."""
    return mla_decode(p, x, cfg, C.gather_pages(ckv_pool, bt), C.gather_pages(krope_pool, bt),
                      pos)


def mla_prefill(lp, h: torch.Tensor, cfg: ModelConfig, positions=None, mask=None,
                prefix=None):
    """The MLA attention step of ``dense.prefill_layers`` / ``run_layers``:
    ``prefix`` holds this layer's cached ``ckv`` / ``krope`` rows. Returns
    (out, {"ckv", "krope"})."""
    pre = None if prefix is None else (prefix["ckv"], prefix["krope"])
    att, ckv, krope = mla_prefill_layer(lp.attn, h, cfg, prefix=pre)
    return att, {"ckv": ckv, "krope": krope}


def mla_step(lp, h: torch.Tensor, cfg: ModelConfig, cache: dict, bt, pos: torch.Tensor):
    """The MLA attention step of ``dense.decode_layers``: over this layer's
    pools (``bt`` given) or its dense cache. Returns (out, {"ckv",
    "krope"}), the step's latent lines."""
    if bt is not None:
        att, ckv, krope = mla_decode_paged(lp.attn, h, cfg, cache["ckv"], cache["krope"], bt,
                                           pos)
    else:
        att, ckv, krope = mla_decode(lp.attn, h, cfg, cache["ckv"], cache["krope"], pos)
    return att, {"ckv": ckv, "krope": krope}
