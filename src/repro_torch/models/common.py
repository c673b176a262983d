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
import torch.utils.checkpoint
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
from repro_torch.models.context import get_mesh_context, psum

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
    the reference: ``group = 2 * wp.shape[-2] / ws.shape[-2]``. An MoE
    layer's experts are one expert-stacked pack (``wp`` (E, K/2, N), ``ws``
    (E, K/G, N)): x (E, Cp, K) -> (E, Cp, N) in one launch. W4A16 siblings
    are never fused (``linear_group`` runs one launch each)."""

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


def _cs(x: torch.Tensor, *spec_dims) -> torch.Tensor:
    """Context-aware sharding constraint (the reference's ``_cs``): under a
    mesh a DTensor is redistributed to the spec's placements; a plain
    tensor is this rank's block of the sharded step's layout (its dp rows,
    the weights gathered) and passes as is, as does everything without a
    mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import P, placements

    ctx = get_mesh_context()
    if ctx.mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, placements(ctx.mesh, P(*spec_dims)))


def embed_attend(embed: torch.Tensor) -> torch.Tensor:
    """The embedding table at its use site, (vocab over tp, features over
    fsdp) under a mesh."""
    ctx = get_mesh_context()
    if ctx.mesh is None:
        return embed
    fsdp = tuple(ctx.fsdp_axes) or None
    return _cs(embed, ctx.tp_axis, fsdp)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather: (B, S) -> (B, S, D), batch over dp under a
    mesh."""
    ctx = get_mesh_context()
    x = embed_attend(embed)[tokens]
    if ctx.mesh is None:
        return x
    dp = tuple(ctx.dp_axes) or None
    return _cs(x, dp, *([None] * (x.ndim - 1)))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm: f32 mean and two-pass variance, normalized in f32, cast to
    x's dtype before the affine step."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    d = xf - mu
    var = torch.mean(d * d, dim=-1, keepdim=True)
    norm = (d * torch.rsqrt(var + eps)).to(x.dtype)
    return norm * w.to(x.dtype) + b.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate.to(torch.float32)).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU (``jax.nn.gelu``'s default; PyTorch's
    default is the erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


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


def _shard_heads(x: torch.Tensor, head_axis: int) -> torch.Tensor:
    """An attention tensor's head dim over the TP axis (when it divides)
    and its batch dim over dp, under a mesh (:func:`_cs`)."""
    ctx = get_mesh_context()
    if ctx.mesh is None or ctx.tp_axis is None:
        return x
    sizes = ctx.sizes
    spec = [None] * x.ndim
    dp = tuple(ctx.dp_axes)
    dpn = 1
    for a in dp:
        dpn *= sizes[a]
    if dp and x.shape[0] % dpn == 0:
        spec[0] = dp
    if x.shape[head_axis] % sizes[ctx.tp_axis] == 0:
        spec[head_axis] = ctx.tp_axis
    return _cs(x, *spec)


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
    q = _shard_heads(q, 2)
    k = _shard_heads(k, 2)
    v = _shard_heads(v, 2)
    qb = (q * scale).reshape(b, n, chunk, kv, g, hd)
    kb = _shard_heads(k.reshape(b, n, chunk, kv, hd), 3)
    vb = _shard_heads(v.reshape(b, n, chunk, kv, hv), 3)
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


def qkv(p: nn.ModuleDict, x: torch.Tensor, fuse: bool = True) -> tuple:
    """q, k, v of ``x``: one fused launch (:func:`linear_group`), or with
    ``fuse=False`` one :func:`linear` each, as a block whose q/k/v the
    reference keeps apart (zamba2's shared block)."""
    if fuse:
        return linear_group(p, ("q", "k", "v"), "qkv", x)
    return tuple(linear(p[n], x) for n in ("q", "k", "v"))


def attention_decode_ro(p: nn.ModuleDict, x: torch.Tensor, cfg: ModelConfig,
                        k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                        fuse: bool = True):
    """Read-only-cache decode attention: each slot attends its own cache
    prefix [0, pos_b) plus the current token (the reference's write-then-
    attend over ``<= pos``, with this step's row apart). Returns (out, k_t,
    v_t)."""
    b, sq, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, kt, vt = qkv(p, x, fuse)
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
               vp: torch.Tensor, bt: torch.Tensor, pos: torch.Tensor, fuse: bool = True):
    """One layer's decode attention straight over the paged pools: ``x (B,
    sq, D)`` holds each slot's rows (sq > 1: a speculative draft stack),
    ``kp/vp (P, page, KV, hd)`` one layer's pools, ``pos (B,)`` the committed
    prefix lengths. Routes ``dispatch.paged_decode`` with ``commit=False``
    (the caller commits every layer's rows once); no dense view of the
    cache is built on the kernel path. Returns (out, k_t, v_t) post-RoPE;
    ``fuse`` as in :func:`qkv`."""
    b, sq, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = qkv(p, x, fuse)
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


def gate_state_update(new_state: dict, old_state: dict, valid: torch.Tensor,
                      b_axis: dict) -> dict:
    """Each slot's state update kept only where ``valid`` (B,) is True (a
    bucketed prefill gates recurrent-state updates off for pad steps).
    ``b_axis`` maps each key to its slot axis as a negative offset from the
    trailing dims, uniform across a family's stacked layouts."""
    out = {}
    for key, new in new_state.items():
        ax = b_axis[key] % new.ndim
        shape = [1] * new.ndim
        shape[ax] = valid.shape[0]
        out[key] = torch.where(valid.reshape(shape), new, old_state[key])
    return out


def gated_token_steps(step: Callable, tokens: torch.Tensor, state: dict, length,
                      b_axis: dict) -> dict:
    """A recurrent family's prefill state: ``step(st, tokens[:, i:i + 1])``
    (a decode step updating ``st`` in place) once per token on a copy of
    ``state``, each step's update kept only for the slots where the token is
    real (``i < length``; every token when ``length`` is None), so a
    bucket-padded prompt leaves the unpadded one's state. ``state`` is left
    unchanged."""
    st = {k: v.clone() for k, v in state.items()}
    real = None if length is None else torch.as_tensor(length, device=tokens.device).reshape(-1)
    for i in range(tokens.shape[1]):
        old = None if real is None else {k: v.clone() for k, v in st.items()}
        step(st, tokens[:, i:i + 1])
        if real is not None:
            st = gate_state_update(st, old, i < real, b_axis)
    return st


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


# ---------------------------------------------------------------------------
# training: losses, rematerialisation, trainable weights
# ---------------------------------------------------------------------------


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> tuple:
    """(sum of the f32 NLL over the labels >= 0, their count in f32)."""
    mask = labels >= 0
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    # -logp at each label (the reference's take_along_axis); its backward
    # writes one element a row, no scatter
    nll = torch.nn.functional.nll_loss(logp.reshape(-1, logp.shape[-1]), safe.reshape(-1),
                                       reduction="none").reshape(safe.shape)
    return torch.sum(nll * mask), torch.sum(mask).to(torch.float32)


def _global_mean(tot: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """``tot / max(cnt, 1)``; under a mesh both are first summed over the
    dp axes (each rank holds its dp rows), so every rank has the global
    mean."""
    ctx = get_mesh_context()
    if ctx.mesh is not None:
        tot, cnt = psum(tot, ctx, ctx.dp_axes), psum(cnt.detach(), ctx, ctx.dp_axes)
    return tot / torch.clamp_min(cnt, 1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over tokens in f32; labels < 0 are masked out."""
    return _global_mean(*_nll_sum(logits, labels))


def _shard_logits(x: torch.Tensor) -> torch.Tensor:
    """Chunk logits (dp, None, model) under a mesh (:func:`_cs`)."""
    ctx = get_mesh_context()
    if ctx.mesh is None or ctx.tp_axis is None:
        return x
    return _cs(x, tuple(ctx.dp_axes) or None, None, ctx.tp_axis)


_CE_CHUNK = 256


def _ce_chunk(unembed_fn, xc: torch.Tensor, lc: torch.Tensor) -> tuple:
    return _nll_sum(_shard_logits(unembed_fn(xc).to(torch.float32)), lc)


def cross_entropy_chunked(hidden: torch.Tensor, labels: torch.Tensor, unembed_fn,
                          chunk: int = _CE_CHUNK) -> torch.Tensor:
    """Memory-bounded CE: the unembed and log-softmax one sequence chunk at
    a time, each chunk rematerialised in the backward, so full-sequence f32
    logits never exist. Taken when the (already shifted) length S is a
    multiple of ``chunk`` above it, as in the reference; otherwise the full
    f32 logits and :func:`cross_entropy`.

    hidden (B, S, D) after the final norm; ``unembed_fn`` (B, c, D) -> (B,
    c, V)."""
    s = hidden.shape[1]
    if s % chunk != 0 or s <= chunk:
        return cross_entropy(_shard_logits(unembed_fn(hidden).to(torch.float32)), labels)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        t, c = remat(_ce_chunk, unembed_fn, hidden[:, i:i + chunk], labels[:, i:i + chunk])
        tot, cnt = tot + t, cnt + c
    return _global_mean(tot, cnt)


def remat(fn, *args, enabled: bool = True):
    """``fn(*args)``, rematerialised in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) when
    ``enabled`` and autograd is recording; a plain call otherwise (the
    serving forwards run under ``no_grad``: same ops, same bits)."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


_PACKED = (TwinQuantLinear, TwinQuantLinearGroup, W4A16Linear, SimLinear)


def trainable(model: nn.Module) -> nn.Module:
    """In place: every floating-point buffer of a bf16 model (its weights,
    norms, the f32 router and SSM vectors) becomes an ``nn.Parameter`` of
    the same name and tensor, bits unchanged, so a loss over the model has
    gradients. Packed linears are not trained (ValueError). The serving
    entry points run under ``no_grad`` and read the parameters as they read
    the buffers. Returns the model."""
    for mod in model.modules():
        if isinstance(mod, _PACKED):
            raise ValueError(f"trainable: {type(mod).__name__} is a pack; only bf16 models train")
        for name, buf in list(mod._buffers.items()):
            if buf is not None and buf.is_floating_point():
                del mod._buffers[name]
                mod.register_parameter(name, nn.Parameter(buf))
    return model


def frozen(model: nn.Module) -> nn.Module:
    """In place: the inverse of :func:`trainable` (every parameter a buffer
    again, detached, bits unchanged), as the packer and the engine take a
    model. Returns the model."""
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                del mod._parameters[name]
                mod.register_buffer(name, p.detach())
    return model


def init_normal(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    """N(0, std^2) values from ``gen``, in bf16 (the reference's init std)."""
    return (torch.randn(*shape, generator=gen, device=device) * std).to(DTYPE)


def dense_std(d_in: int) -> float:
    return 1.0 / math.sqrt(d_in)
