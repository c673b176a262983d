"""Shared model substrate of the port: linear modules (bf16, TwinQuant and
the weight-only W4A16 baseline, routed through ``kernels/dispatch``, and the
quantized-numerics simulation ``SimLinear``; an MoE layer's experts as one
expert-stacked module each, ``ExpertLinear`` in bf16 or a stacked TwinQuant
pack), norms,
RoPE, GQA attention with a dense per-slot KV cache or paged KV pools, and the
serving helpers the engine uses.

The math mirrors ``repro/models/common.py`` function for function, in the
same layouts (activations (B, S, D), caches (L, B, S, KV, hd)), so the tests
compare like with like. Attention, RoPE, norms and the embedding are plain
tensor code here, as in the reference (they lie outside any Pallas kernel
there). Paged decode and ragged attention go through the block-table
kernels (``dispatch.paged_decode`` / ``dispatch.ragged_attention``).

Unlike the reference's immutable arrays, the decode paths update the KV
cache, the page pools and the position vector in place (one row write per
slot, row and layer instead of a copy of the whole cache or pool), at fixed
shapes and with no host sync, so that one CUDA graph can hold a whole step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.core.quantization import QuantConfig, fake_quant
from repro_torch.kernels import dispatch
# the page geometry lives beside the kernel; gather_pages is re-exported as
# the reference's models/common has it
from repro_torch.kernels.paged_attention import (  # noqa: F401
    gather_pages,
    pool_rows,
    write_page_rows,
)
from repro_torch.kernels.ref import (
    TwinQuantGroupWeights,
    TwinQuantWeights,
    fuse_twinquant_weights,
)

DTYPE = torch.bfloat16

# ---------------------------------------------------------------------------
# linear modules
# ---------------------------------------------------------------------------


class Linear(nn.Module):
    """bf16 dense linear: ``w`` (K, N) as in the reference, optional ``b``."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y


class ExpertLinear(nn.Module):
    """An MoE layer's experts' bf16 linears stacked: ``w`` (E, K, N); x (E, C,
    K) -> (E, C, N), the reference's ``einsum("ecd,edf->ecf")``."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.bmm(x, self.w.to(x.dtype))


class TwinQuantLinear(nn.Module):
    """A TwinQuant dual-component pack (buffers ``up us vp vs rp rs`` and an
    optional bias ``b``), applied through ``dispatch.quant_linear``. An
    expert-stacked pack (every buffer with a leading E) takes x (E, C, K)
    and runs all experts in one launch."""

    def __init__(self, w: TwinQuantWeights, b: Optional[torch.Tensor] = None):
        super().__init__()
        for name in ("up", "us", "vp", "vs", "rp", "rs"):
            self.register_buffer(name, getattr(w, name))
        self.register_buffer("b", b)
        self.group, self.rgroup, self.a_bits = w.group, w.rgroup, w.a_bits

    def weights(self) -> TwinQuantWeights:
        return TwinQuantWeights(self.up, self.us, self.vp, self.vs, self.rp, self.rs,
                                self.group, self.rgroup, self.a_bits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dispatch.quant_linear(x, self.weights(), self.b).to(x.dtype)


class TwinQuantLinearGroup(nn.Module):
    """Sibling packs fused along N (``up us rp rs`` concatenated, ``vp{j}``
    / ``vs{j}`` per segment, biases concatenated into ``b``); one launch of
    ``dispatch.fused_linear`` computes every sibling (of every expert, for
    an expert-stacked group)."""

    def __init__(self, gw: TwinQuantGroupWeights, b: Optional[torch.Tensor] = None):
        super().__init__()
        for name in ("up", "us", "rp", "rs"):
            self.register_buffer(name, getattr(gw, name))
        for j, (vp, vs) in enumerate(zip(gw.vps, gw.vss)):
            self.register_buffer(f"vp{j}", vp)
            self.register_buffer(f"vs{j}", vs)
        self.register_buffer("b", b)
        self.n_segments = gw.n_segments
        self.group, self.rgroups, self.a_bits = gw.group, gw.rgroups, gw.a_bits

    def weights(self) -> TwinQuantGroupWeights:
        n = self.n_segments
        return TwinQuantGroupWeights(
            self.up, self.us, tuple(getattr(self, f"vp{j}") for j in range(n)),
            tuple(getattr(self, f"vs{j}") for j in range(n)), self.rp, self.rs,
            self.group, self.rgroups, self.a_bits,
        )

    def forward(self, x: torch.Tensor) -> tuple:
        gw = self.weights()
        biases = gw.split(self.b) if self.b is not None else None
        return tuple(y.to(x.dtype) for y in dispatch.fused_linear(x, gw, biases))


class W4A16Linear(nn.Module):
    """A weight-only int4 pack (buffers ``wp`` (K/2, N) int8, ``ws`` (K/G, N)
    f32 and an optional bias ``b``), applied through
    ``dispatch.w4a16_linear``. The scale group comes from the shapes, as in
    the reference: ``group = 2 * wp.shape[-2] / ws.shape[-2]``."""

    def __init__(self, wp: torch.Tensor, ws: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("wp", wp)
        self.register_buffer("ws", ws)
        self.register_buffer("b", b)
        self.group = wp.shape[-2] * 2 // ws.shape[-2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dispatch.w4a16_linear(x, self.wp, self.ws, self.b, group=self.group).to(x.dtype)


class SimLinear(nn.Module):
    """Quantized-numerics simulation of a TwinQuant linear (the evaluation
    path; the reference's ``"r_dq"`` branch of ``linear``): dequantized bf16
    components ``r_dq`` (K, N) and, with the low-rank branch, ``u_dq`` (K, r)
    and ``v_dq`` (r, N); the smoothing vector ``lam`` (K,), the optional
    online rotation ``Q`` (K, K), activation bits ``a_bits`` and bias ``b``.

    ``y = fq(x / lam @ Q) @ r_dq + fq_H(fq(x / lam @ Q) @ u_dq) @ v_dq + b``
    in ``x``'s dtype, with activations fake-quantized in groups of min(128, K)
    and H (the kernel's requantization step) in groups of min(128, r), both
    when ``a_bits < 16``. Plain matmuls: never fused, never packed."""

    def __init__(self, lam: torch.Tensor, r_dq: torch.Tensor, a_bits: int,
                 Q: Optional[torch.Tensor] = None, u_dq: Optional[torch.Tensor] = None,
                 v_dq: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("lam", lam)
        self.register_buffer("Q", Q)
        self.register_buffer("u_dq", u_dq)
        self.register_buffer("v_dq", v_dq)
        self.register_buffer("r_dq", r_dq)
        self.register_buffer("b", b)
        self.a_bits = a_bits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = x / self.lam.to(x.dtype)
        if self.Q is not None:
            xh = xh @ self.Q.to(x.dtype)
        if self.a_bits < 16:
            k = xh.shape[-1]
            xh = fake_quant(xh, QuantConfig(bits=self.a_bits, group_size=min(128, k), axis=-1))
        y = xh @ self.r_dq.to(x.dtype)
        if self.u_dq is not None:
            h = xh @ self.u_dq.to(x.dtype)
            if self.a_bits < 16:  # H requantization (the fused kernel's s_H step)
                r = h.shape[-1]
                h = fake_quant(h, QuantConfig(bits=self.a_bits, group_size=min(128, r), axis=-1))
            y = y + h @ self.v_dq.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y


def linear(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a (possibly quantized) linear layer; x: (..., K) -> (..., N)."""
    return p(x)


def linear_group(p: nn.ModuleDict, names: tuple, fused_key: str, x: torch.Tensor) -> tuple:
    """Apply sibling projections of ONE activation.

    1. ``p[fused_key]`` exists (``core.twinquant.fuse_params``): one fused
       launch, or one launch per segment when fusion is switched off;
    2. the siblings are fusable TwinQuant packs and fusion is on: fuse them
       now and launch once;
    3. otherwise one :func:`linear` per sibling (bf16 and W4A16 siblings,
       which the reference never fuses)."""
    if fused_key in p:
        fp = p[fused_key]
        if not dispatch.fusion_enabled():
            gw = fp.weights()
            biases = gw.split(fp.b) if fp.b is not None else (None,) * gw.n_segments
            return tuple(dispatch.quant_linear(x, gw.segment(j), biases[j]).to(x.dtype)
                         for j in range(gw.n_segments))
        return fp(x)
    ps = [p[n] for n in names]
    if dispatch.fusion_enabled() and _fusable(ps):
        gw = fuse_twinquant_weights([pp.weights() for pp in ps])
        ys = dispatch.fused_linear(x, gw, biases=[pp.b for pp in ps])
        return tuple(y.to(x.dtype) for y in ys)
    return tuple(linear(pp, x) for pp in ps)


def _fusable(ps) -> bool:
    if not all(isinstance(pp, TwinQuantLinear) for pp in ps):
        return False
    base = ps[0]
    return all(pp.rp.shape[:-1] == base.rp.shape[:-1] and pp.group == base.group
               and pp.a_bits == base.a_bits for pp in ps)


# ---------------------------------------------------------------------------
# embedding, norms, activations
# ---------------------------------------------------------------------------


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather: (B, S) -> (B, S, D)."""
    return embed[tokens]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.to(torch.float32)).to(gate.dtype) * up


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, fraction: float, theta: float):
    """cos/sin tables for the rotated sub-dimension. positions: (...,)"""
    rot = int(head_dim * fraction) // 2 * 2
    if rot == 0 or theta <= 0:
        return None
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=positions.device) / rot
    # a fill, not an upload of a host scalar: no host sync inside a step
    freqs = 1.0 / (torch.full((), theta, dtype=torch.float32, device=positions.device) ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """x: (B, S, H, hd); tables from rope_tables with positions (B, S)."""
    if tables is None:
        return x
    cos, sin, rot = tables
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp], dim=-1) if xp.shape[-1] else yr


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

_ATTN_CHUNK = 512
_NEG = -1e30


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd); GQA by head grouping; f32 softmax."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32)
    logits = logits / (hd ** 0.5)
    logits = torch.where(mask[:, None, None, :, :], logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def _sdpa_causal_chunked(q, k, v, chunk: int = _ATTN_CHUNK) -> torch.Tensor:
    """Causal attention; online softmax over KV blocks (flash recurrence)
    when S is a multiple of ``chunk`` above it, fully-masked blocks skipped."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    hv = v.shape[-1]
    if s % chunk != 0 or s <= chunk:
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))[None]
        return _sdpa(q, k, v, causal)
    n = s // chunk
    scale = hd ** -0.5
    qb = (q * scale).reshape(b, n, chunk, kv, g, hd)
    kb = k.reshape(b, n, chunk, kv, hd)
    vb = v.reshape(b, n, chunk, kv, hv)
    ar = torch.arange(chunk, device=q.device)
    blocks = []
    for qi in range(n):
        qq = qb[:, qi]
        m = torch.full((b, kv, g, chunk), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kv, g, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kv, g, chunk, hv), dtype=torch.float32, device=q.device)
        for kj in range(qi + 1):
            kk, vv = kb[:, kj], vb[:, kj]
            logits = torch.einsum("bqkgh,bskh->bkgqs", qq, kk).to(torch.float32)
            causal = (qi * chunk + ar)[:, None] >= (kj * chunk + ar)[None, :]
            logits = torch.where(causal[None, None, None], logits, _NEG)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(vv.dtype), vv).to(torch.float32)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        blocks.append(out.permute(0, 3, 1, 2, 4).to(v.dtype))  # (B, cq, KV, G, hv)
    return torch.stack(blocks, dim=1).reshape(b, s, h, hv)


def prefix_attn_mask(s: int, off: int, device=None) -> torch.Tensor:
    """(1, s, off+s) mask for suffix prefill over a cached prefix: every
    suffix query sees the whole prefix plus the causal part of the suffix."""
    return torch.cat([torch.ones((1, s, off), dtype=torch.bool, device=device),
                      torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))[None]],
                     dim=-1)


def gqa_prefill_attn(p: nn.ModuleDict, h: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor, prefix_kv=None, mask=None):
    """One layer's prefill attention (fused q/k/v projection + RoPE), causal
    or, given ``prefix_kv`` = (pk (B, m, KV, hd), pv) from cached pages and
    the matching :func:`prefix_attn_mask`, over [prefix; causal suffix].
    Returns (attn_out, k, v) with k/v post-RoPE for the cache."""
    b, s, _ = h.shape
    hh, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = linear_group(p, ("q", "k", "v"), "qkv", h)
    q = q.reshape(b, s, hh, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    tables = rope_tables(positions, hd, cfg.rope_fraction, cfg.rope_theta)
    q = apply_rope(q, tables)
    k = apply_rope(k, tables)
    if prefix_kv is None:
        att = _sdpa_causal_chunked(q, k, v)
    else:
        pk, pv = prefix_kv
        att = _sdpa(q, torch.cat([pk.to(k.dtype), k], dim=1),
                    torch.cat([pv.to(v.dtype), v], dim=1), mask)
    return linear(p["o"], att.reshape(b, s, hh * hd)), k, v


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=DTYPE, device=None) -> dict:
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((n_layers, batch, max_len, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, max_len, kvh, hd), dtype=dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def slot_positions(pos: torch.Tensor, b: int, sq: int = 1) -> torch.Tensor:
    """Per-slot decode positions (B, sq) from a per-slot ``pos`` vector (B,)."""
    pos = torch.as_tensor(pos, dtype=torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(b)
    return pos[:, None] + torch.arange(sq, dtype=torch.int32, device=pos.device)[None, :]


def update_cache_slot_stacked(cache: torch.Tensor, t: torch.Tensor, pos: torch.Tensor) -> None:
    """In place: cache (L, B, S, ...) row ``pos[b]`` of every slot b gets
    t (L, B, 1, ...). Out-of-range positions are dropped, not clamped: such
    a slot writes its own (clamped) row's old value back. Each slot writes
    only its own row, so the fixed-shape write (no host sync) has no
    collisions."""
    b, s = cache.shape[1], cache.shape[2]
    pos = pos.to(torch.long)
    ok = ((pos >= 0) & (pos < s)).view(1, b, *([1] * (cache.ndim - 3)))
    slots = torch.arange(b, device=cache.device)
    row = pos.clamp(0, s - 1)
    cache[:, slots, row] = torch.where(ok, t[:, :, 0].to(cache.dtype), cache[:, slots, row])


def attention_decode_ro(p: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig,
                        k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor):
    """Read-only-cache decode attention: each slot attends its own cache
    prefix [0, pos_b) plus the current token. Returns (out, k_t, v_t)."""
    b, sq, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kt, vt = linear_group(p, ("q", "k", "v"), "qkv", x)
    q = q.reshape(b, sq, h, hd)
    kt = kt.reshape(b, sq, kvh, hd)
    vt = vt.reshape(b, sq, kvh, hd)
    positions = slot_positions(pos, b, sq)
    pos_v = positions[:, 0]
    tables = rope_tables(positions, hd, cfg.rope_fraction, cfg.rope_theta)
    q = apply_rope(q, tables)
    kt = apply_rope(kt, tables)

    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    s_max = k_cache.shape[1]
    logits_c = torch.einsum("bskgh,btkh->bkgst", qg, k_cache).to(torch.float32)
    logits_c = logits_c / (hd ** 0.5)
    mask = (torch.arange(s_max, device=x.device)[None, None, None, None, :]
            < pos_v[:, None, None, None, None])
    logits_c = torch.where(mask, logits_c, _NEG)
    logit_s = torch.einsum("bskgh,bskh->bkgs", qg, kt).to(torch.float32)[..., None] / (hd ** 0.5)
    m = torch.maximum(logits_c.amax(dim=-1, keepdim=True), logit_s)
    pc = torch.exp(logits_c - m)
    ps = torch.exp(logit_s - m)
    den = pc.sum(dim=-1, keepdim=True) + ps
    out = torch.einsum("bkgst,btkh->bskgh", (pc / den).to(v_cache.dtype), v_cache)
    self_w = (ps / den)[..., 0][..., None].permute(0, 3, 1, 2, 4).to(vt.dtype)
    out = out + self_w * vt[:, :, :, None, :]
    return linear(p["o"], out.reshape(b, sq, h * hd)), kt, vt


# ---------------------------------------------------------------------------
# paged KV cache
#
# The paged layout replaces every sequence-carrying leaf of the decode state
# with a global page pool (lead, n_pages, page_size, ...) shared by all
# slots, plus one block table ``bt (B, max_pages)`` of page ids per slot
# (-1 = unmapped). The host-side allocator in launch/serve.py owns the free
# list and refcounts. Which leaves become pools is decided structurally
# (paged_layout), from shapes on the meta device.
# ---------------------------------------------------------------------------


def paged_layout(init_fn, cfg: ModelConfig, max_len: int) -> dict:
    """Classify decode-state leaves: key -> (slot_axis, seq_axis | None),
    from a batch-2 vs batch-1 and a max_len vs 2*max_len shape diff. Pools
    need the (lead, B, S, ...) layout (slot axis 1, sequence axis 2)."""
    s2 = init_fn(cfg, 2, max_len, device="meta")
    s1 = init_fn(cfg, 1, max_len, device="meta")
    sl = init_fn(cfg, 1, 2 * max_len, device="meta")
    out = {}
    for key in s1:
        slot = [i for i, (a, b) in enumerate(zip(s2[key].shape, s1[key].shape)) if a != b]
        seq = [i for i, (a, b) in enumerate(zip(s1[key].shape, sl[key].shape)) if a != b]
        if len(slot) != 1 or len(seq) > 1:
            raise ValueError(f"cannot classify state leaf {key!r}: {tuple(s2[key].shape)} vs "
                             f"{tuple(s1[key].shape)} vs {tuple(sl[key].shape)}")
        if seq and (slot[0] != 1 or seq[0] != 2):
            raise ValueError(f"page pools need (lead, B, S, ...) layout, got {key!r} with slot "
                             f"axis {slot[0]}, seq axis {seq[0]}")
        out[key] = (slot[0], seq[0] if seq else None)
    return out


def init_paged_state(init_fn, cfg: ModelConfig, batch: int, max_len: int, page_size: int,
                     n_pages: int, device=None) -> dict:
    """Paged decode state: sequence-carrying leaves become zeroed page pools
    (lead, n_pages, page_size, trail); per-slot leaves are zeros of their
    dense shape; ``bt (B, ceil(max_len / page_size))`` starts all -1. Only
    the pools are allocated, never the dense cache."""
    layout = paged_layout(init_fn, cfg, max_len)
    shapes = init_fn(cfg, batch, max_len, device="meta")
    st = {}
    for key, (slot, seq) in layout.items():
        sh, dt = tuple(shapes[key].shape), shapes[key].dtype
        if seq is not None:
            sh = sh[:slot] + (n_pages, page_size) + sh[seq + 1:]
        st[key] = torch.zeros(sh, dtype=dt, device=device)
    st["bt"] = torch.full((batch, -(-max_len // page_size)), -1, dtype=torch.int32,
                          device=device)
    return st


def scatter_token_pages(pool: torch.Tensor, t: torch.Tensor, bt: torch.Tensor,
                        pos: torch.Tensor) -> None:
    """In place: each slot's one-token line t (lead, B, 1, ...) into its tail
    page ``bt[b, pos_b // page]`` row ``pos_b % page``; slots whose target is
    unmapped (an idle slot decoding in lock-step) or past the table are
    dropped."""
    scatter_rows_pages(pool, t[:, :, 0], bt, torch.arange(bt.shape[0], device=bt.device), pos)


def scatter_rows_pages(pool: torch.Tensor, t: torch.Tensor, bt: torch.Tensor,
                       slot: torch.Tensor, pos: torch.Tensor) -> None:
    """In place: a step's rows t (lead, T, ...) into their slots' pages (pad,
    unmapped and out-of-table rows dropped). The decode and ragged steps
    call :func:`pool_rows` once before their layers and ``write_page_rows``
    after them; this is the same write in one call."""
    write_page_rows(pool, t, pool_rows(bt, slot, pos, pool.shape[2], pool.shape[1]))


def paged_attn(p: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig, kp: torch.Tensor,
               vp: torch.Tensor, bt: torch.Tensor, pos: torch.Tensor):
    """One layer's decode attention straight over the paged pools: ``x (B,
    sq, D)`` holds each slot's rows (sq > 1: a speculative draft stack),
    ``kp/vp (P, page, KV, hd)`` one layer's pools, ``pos (B,)`` the committed
    prefix lengths. Routes ``dispatch.paged_decode`` with ``commit=False``
    (the caller commits every layer's rows once); no dense view of the
    cache is built on the kernel path. Returns (out, k_t, v_t) post-RoPE."""
    b, sq, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = linear_group(p, ("q", "k", "v"), "qkv", x)
    q = q.reshape(b, sq, h, hd)
    k = k.reshape(b, sq, kvh, hd)
    v = v.reshape(b, sq, kvh, hd)
    tables = rope_tables(slot_positions(pos, b, sq), hd, cfg.rope_fraction, cfg.rope_theta)
    q = apply_rope(q, tables)
    k = apply_rope(k, tables)
    out = dispatch.paged_decode(q, kp, vp, k, v, bt, pos, commit=False)
    return linear(p["o"], out.reshape(b, sq, h * hd)), k, v


def ragged_attn(p: nn.ModuleDict, h: torch.Tensor, cfg: ModelConfig, kp: torch.Tensor,
                vp: torch.Tensor, bt: torch.Tensor, slot: torch.Tensor, pos: torch.Tensor,
                ctx: torch.Tensor):
    """One layer's attention over a ragged step's flat rows ``h (1, T, D)``
    (``slot/pos (T,)``, slot == B pads; ``ctx (B,)`` committed rows per
    slot): the fused q/k/v launch runs once over all T rows, then
    ``dispatch.ragged_attention``. Returns (out (1, T, D), k_t, v_t)."""
    _, t, _ = h.shape
    hh, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = linear_group(p, ("q", "k", "v"), "qkv", h)
    q = q.reshape(1, t, hh, hd)
    k = k.reshape(1, t, kvh, hd)
    v = v.reshape(1, t, kvh, hd)
    tables = rope_tables(pos[None, :], hd, cfg.rope_fraction, cfg.rope_theta)
    q = apply_rope(q, tables)
    k = apply_rope(k, tables)
    out = dispatch.ragged_attention(q[0], kp, vp, k[0], v[0], bt, slot, pos, ctx)
    return linear(p["o"], out.reshape(1, t, hh * hd)), k[0], v[0]


def per_draft_row(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply a row-wise ``fn`` to x (B, sq, D) one draft column (B, 1, D) at
    a time, so a speculative stack's row i gets a plain decode step's bits.
    On the card, :func:`rmsnorm`'s ``torch.mean`` over D picks its reduction
    split by the number of rows: at B * sq rows some rows get other bits than
    at B, and greedy speculation then loses tokens (``chip_smoke.py
    --spec-probe`` shows both)."""
    if x.shape[1] == 1:
        return fn(x)
    return torch.cat([fn(x[:, i:i + 1].contiguous()) for i in range(x.shape[1])], dim=1)


def mlp_apply(p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    gate, up = linear_group(p, ("gate", "up"), "gate_up", x)
    return linear(p["down"], swiglu(gate, up))


# ---------------------------------------------------------------------------
# serving helpers
# ---------------------------------------------------------------------------


def select_at_length(x: torch.Tensor, length) -> torch.Tensor:
    """Last REAL position of each row: x (B, S, D) -> (B, 1, D)."""
    if length is None:
        return x[:, -1:]
    idx = torch.clamp(torch.as_tensor(length, device=x.device).reshape(-1).to(torch.long) - 1,
                      0, x.shape[1] - 1)
    idx = idx.expand(x.shape[0]) if idx.numel() == 1 else idx
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))


def prefill_pos(length, batch: int, s: int, device=None) -> torch.Tensor:
    """Per-slot position vector after a prefill of s (possibly padded)
    tokens of which ``length`` are real."""
    if length is None:
        return torch.full((batch,), s, dtype=torch.int32, device=device)
    return torch.as_tensor(length, device=device).reshape(-1).to(torch.int32).expand(batch).clone()


# The host-side tap on freshly downloaded logits: the engine passes every
# sync-point logits download through ``logits_tap`` (so ``launch/faults.py``
# can poison one slot's row) and checks ``nonfinite_rows`` right after.
# Identity unless a tap is installed.
_logits_tap: Optional[Callable] = None


def set_logits_tap(fn: Optional[Callable]) -> Optional[Callable]:
    """Install ``fn(last, tag) -> last`` as the host logits tap (``None``
    removes it); returns the tap it replaced. ``last`` is the host array
    just downloaded, never a device buffer; ``tag`` names the call site
    (``"prefill"``, ``"decode"`` (the verify step too) or ``"ragged"``)."""
    global _logits_tap
    prev = _logits_tap
    _logits_tap = fn
    return prev


def logits_tap(last: np.ndarray, tag: str) -> np.ndarray:
    """``last`` through the installed tap, if any."""
    if _logits_tap is None:
        return last
    return _logits_tap(last, tag)


def nonfinite_rows(last: np.ndarray, vocab: int) -> list:
    """Indices of rows of ``last (..., V)`` holding any NaN/Inf within the
    first ``vocab`` columns: the engine's finite-logits guard."""
    finite = np.isfinite(last[..., :vocab]).all(axis=-1)
    return [int(i) for i in np.flatnonzero(~finite.reshape(-1))]


def init_normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    """N(0, std^2) values from ``gen``, in bf16 (the reference's init std)."""
    return (torch.randn(*shape, generator=gen, device=device) * std).to(DTYPE)


def dense_std(d_in: int) -> float:
    return 1.0 / math.sqrt(d_in)
