"""Zamba2-style hybrid (``zamba2-1.2b``, family ``mamba_hybrid``): the port
of ``repro/models/mamba_hybrid.py``.

A Mamba2 (SSD) trunk, with one weight-shared attention/MLP block invoked
after every ``shared_attn_every`` Mamba blocks on concat(hidden, embed0) and
projected back through that invocation's adapter (the Zamba re-injection);
the blocks left over after the last whole segment (``rest_layers``) follow
it. The forward runs the chunked SSD algorithm (``CHUNK`` 128 rows, the
(H, P, N) state carried across chunks); decode runs the O(1) recurrence.

Decode state: ``ssm`` (n_seg, every, B, H, P, N) f32 and ``conv`` (n_seg,
every, B, conv-1, d_inner + 2N), the slot on axis 2 (``ssm_rest`` /
``conv_rest`` for the rest layers, slot on axis 1), both per slot and never
paged; ``shared_k`` / ``shared_v`` (n_seg, B, S, H, hd), the shared block's
cache of each invocation, which the engine pages; ``pos``. A decode step
updates all of it in place, so one captured CUDA graph serves every step.
The shared block's decode attention is the dense family's step
(``attention_decode_ro``, or the paged kernel over the pools), with its
q / k / v three linears as in the reference (only its MLP's gate/up fuse)
and the block's fixed RoPE (fraction 1, theta 10000).

A prefill is the reference's algorithm: the full forward for the logits,
then one decode step per prompt token to build the state, each step's
update kept only where the token is real (``common.gate_state_update``),
so a bucket-padded prefill leaves the state of the unpadded one.

Modules keep the reference's names: ``m_layers[seg][j]`` and
``rest_layers[i]`` are
:class:`MambaBlock` (``in_proj``, ``out_proj``; ``ln``, ``conv``,
``A_log``, ``D``, ``dt_bias``, ``gn``), ``shared`` the :class:`SharedBlock`
(``q``, ``k``, ``v``, ``o``, ``mlp/{gate,up,down}``; ``ln1``, ``ln2``) and
``adapters[seg]`` one linear per invocation.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import dense as D

__all__ = ["CHUNK", "MambaBlock", "SharedBlock", "HybridModel", "init_params", "forward",
           "loss_fn", "init_decode_state", "prefill", "decode_step", "count_params"]

# SSD chunk: state traffic per token ~ H*P*N / chunk, intra-chunk work per
# token ~ chunk; they cross near 128 for P = N = 64
CHUNK = 128

# the shared block's RoPE (fraction, theta), fixed whatever the config says
SHARED_ROPE = (1.0, 10000.0)


class MambaBlock(nn.Module):
    """One Mamba2 block: ``in_proj`` and ``out_proj`` linears; the norm
    ``ln``, the depthwise causal ``conv`` (conv, d_inner + 2N), the f32
    ``A_log``, ``D``, ``dt_bias`` (H,) and the gate norm ``gn`` as buffers."""

    def __init__(self, in_proj: nn.Module, out_proj: nn.Module, ln: torch.Tensor,
                 conv: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                 dt_bias: torch.Tensor, gn: torch.Tensor):
        super().__init__()
        self.in_proj, self.out_proj = in_proj, out_proj
        for name, t in (("ln", ln), ("conv", conv), ("A_log", A_log), ("D", D),
                        ("dt_bias", dt_bias), ("gn", gn)):
            self.register_buffer(name, t)


class SharedBlock(nn.ModuleDict):
    """The weight-shared attention/MLP block: linears ``q``, ``k``, ``v``,
    ``o`` and ``mlp/{gate,up,down}`` by name, norms ``ln1`` / ``ln2`` (2D,)
    as buffers."""

    def __init__(self, linears: dict, mlp: dict, ln1: torch.Tensor, ln2: torch.Tensor):
        super().__init__({**linears, "mlp": nn.ModuleDict(mlp)})
        self.register_buffer("ln1", ln1)
        self.register_buffer("ln2", ln2)


class HybridModel(nn.Module):
    """Embedding, the Mamba trunk (``m_layers``: a list of segments, each a
    list of blocks), the shared block, the adapters (one a segment),
    ``rest_layers``, ``ln_f`` and the untied head."""

    def __init__(self, embed: torch.Tensor, m_layers: list, ln_f: torch.Tensor,
                 head: nn.Module, shared: SharedBlock, adapters: list,
                 rest_layers: Optional[list] = None):
        super().__init__()
        self.register_buffer("embed", embed)
        self.m_layers = nn.ModuleList([nn.ModuleList(seg) for seg in m_layers])
        self.register_buffer("ln_f", ln_f)
        self.head = head
        self.shared = shared
        self.adapters = nn.ModuleList(adapters)
        self.rest_layers = None if rest_layers is None else nn.ModuleList(rest_layers)


def _segments(cfg: ModelConfig) -> tuple[int, int, int]:
    """(segments, blocks a segment, rest blocks). The port serves the
    trunk with its shared block only: at least one whole segment."""
    every = cfg.shared_attn_every
    n_seg = cfg.n_layers // every if every > 0 else 0
    if n_seg == 0:
        raise ValueError(f"mamba_hybrid needs 0 < shared_attn_every <= n_layers, got "
                         f"{every} with {cfg.n_layers} layers")
    return n_seg, every, cfg.n_layers - n_seg * every


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> HybridModel:
    """Random parameters with the reference's init: N(0, 1/d_in) bf16
    linears, the conv N(0, 0.1^2), ``A_log`` 0, ``D`` 1, ``dt_bias`` -2 (f32),
    norms of ones, the embedding N(0, 0.02^2). Runs on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    d, di, n, h = cfg.d_model, cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads
    d2, hhd = 2 * d, cfg.n_heads * cfg.head_dim

    def lin(d_in, d_out):
        return C.Linear(C.init_normal(gen, (d_in, d_out), C.dense_std(d_in), dev))

    def ones(k, dtype=C.DTYPE):
        return torch.ones((k,), dtype=dtype, device=dev)

    def mamba():
        return MambaBlock(lin(d, 2 * di + 2 * n + h), lin(di, d), ones(d),
                          C.init_normal(gen, (cfg.ssm_conv, di + 2 * n), 0.1, dev),
                          torch.zeros((h,), dtype=torch.float32, device=dev),
                          ones(h, torch.float32),
                          torch.full((h,), -2.0, dtype=torch.float32, device=dev), ones(di))

    n_seg, every, rest = _segments(cfg)
    embed = C.init_normal(gen, (cfg.padded_vocab, d), 0.02, dev)
    head = lin(d, cfg.padded_vocab)
    m_layers = [[mamba() for _ in range(every)] for _ in range(n_seg)]
    shared = SharedBlock({"q": lin(d2, hhd), "k": lin(d2, hhd), "v": lin(d2, hhd),
                          "o": lin(hhd, hhd)},
                         {"gate": lin(d2, cfg.d_ff), "up": lin(d2, cfg.d_ff),
                          "down": lin(cfg.d_ff, hhd)}, ones(d2), ones(d2))
    adapters = [lin(hhd, d) for _ in range(n_seg)]
    rest_layers = [mamba() for _ in range(rest)] if rest else None
    return HybridModel(embed, m_layers, ones(d), head, shared, adapters, rest_layers)


# ---------------------------------------------------------------------------
# Mamba2 SSD core
# ---------------------------------------------------------------------------


def _ssd_chunkwise(x, dt, A, Bm, Cm, state):
    """x (B, S, H, P); dt (B, S, H); A (H,); Bm / Cm (B, S, N); state (B, H,
    P, N) f32; S a multiple of ``CHUNK``. Returns (y (B, S, H, P) f32,
    state)."""
    b, s, h, pdim = x.shape
    n = Bm.shape[-1]
    nc, l = s // CHUNK, CHUNK
    xf = x.to(torch.float32).reshape(b, nc, l, h, pdim)
    dtf = dt.reshape(b, nc, l, h)
    Bf = Bm.to(torch.float32).reshape(b, nc, l, n)
    Cf = Cm.to(torch.float32).reshape(b, nc, l, n)
    la = dtf * A[None, None, None, :]  # log decay (<= 0)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        xx, dd, bb, cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        F = torch.cumsum(la[:, c], dim=1)  # (B, l, H)
        # intra-chunk: y_t = sum_{s<=t} exp(F_t - F_s) dt_s (C_t . B_s) x_s,
        # masked in log space before exp (F_t - F_s > 0 above the diagonal)
        w = torch.exp(torch.where(tri, F[:, :, None, :] - F[:, None, :, :], -1e30))
        cb = torch.einsum("btn,bsn->bts", cc, bb)[:, :, :, None]
        scores = cb * w * dd[:, None, :, :]
        y = torch.einsum("btsh,bshp->bthp", scores, xx)
        # inter-chunk: the carried state
        y = y + torch.exp(F)[..., None] * torch.einsum("btn,bhpn->bthp", cc, state)
        g = F[:, -1]  # (B, H)
        wk = torch.exp(g[:, None, :] - F) * dd  # (B, l, H)
        state = torch.exp(g)[:, :, None, None] * state + torch.einsum(
            "blhp,bln->bhpn", xx * wk[..., None], bb)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, s, h, pdim), state


def _ssd_step(x, dt, A, Bm, Cm, state):
    """One step of the recurrence: x (B, 1, H, P); state (B, H, P, N) f32.
    Returns (y (B, 1, H, P) f32, the new state)."""
    xf = x[:, 0].to(torch.float32)
    dd = dt[:, 0]
    bb = Bm[:, 0].to(torch.float32)
    cc = Cm[:, 0].to(torch.float32)
    decay = torch.exp(dd * A[None, :])  # (B, H)
    # (x dt) B: the reference's einsum's order, so the state keeps its bits
    state = decay[:, :, None, None] * state + (
        (xf * dd[:, :, None])[:, :, :, None] * bb[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", cc, state)
    return y[:, None], state


def _mamba_block(lp: MambaBlock, x: torch.Tensor, cfg: ModelConfig, state=None,
                 conv_state=None, step: bool = False):
    """One Mamba2 block on x (B, S, D): in_proj, the depthwise causal conv
    over [x, B, C] (``conv_state`` (B, conv-1, C) the previous rows, zeros
    when None), ``dt`` softplus, ``A = -exp(A_log)``, the SSD core (chunked,
    or one ``step``), the ``D`` skip, the ``gn`` gate and out_proj. Returns
    (x + out, ssm state, the conv rows for the next step)."""
    b, s, _ = x.shape
    di, n, h, pdim = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    hin = C.rmsnorm(x, lp.ln, cfg.norm_eps)
    proj = C.linear(lp.in_proj, hin)
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * n]
    dt_raw = proj[..., 2 * di + 2 * n:].to(torch.float32)  # (B, S, H)
    k = lp.conv.shape[0]
    pad = (torch.zeros((b, k - 1, xbc.shape[-1]), dtype=xbc.dtype, device=x.device)
           if conv_state is None else conv_state)
    xp = torch.cat([pad, xbc], dim=1)
    xbc = sum(xp[:, i:i + s, :] * lp.conv[i][None, None, :] for i in range(k))
    new_conv = xp[:, -(k - 1):, :]
    xbc = torch.nn.functional.silu(xbc.to(torch.float32)).to(x.dtype)
    xs = xbc[..., :di].reshape(b, s, h, pdim)
    Bm = xbc[..., di:di + n]
    Cm = xbc[..., di + n:]
    dt = dt_raw + lp.dt_bias[None, None, :]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))  # softplus
    A = -torch.exp(lp.A_log)
    if state is None:
        state = torch.zeros((b, h, pdim, n), dtype=torch.float32, device=x.device)
    y, state = (_ssd_step if step else _ssd_chunkwise)(xs, dt, A, Bm, Cm, state)
    y = y + lp.D[None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, s, di).to(x.dtype)
    y = C.rmsnorm(y, lp.gn, cfg.norm_eps) * torch.nn.functional.silu(
        z.to(torch.float32)).to(x.dtype)
    return x + C.linear(lp.out_proj, y), state, new_conv


def _mamba_step(lp: MambaBlock, x: torch.Tensor, cfg: ModelConfig, ssm: torch.Tensor,
                conv: torch.Tensor) -> torch.Tensor:
    """One decode step of a block, its ``ssm`` (B, H, P, N) and ``conv``
    (B, conv-1, C) state views updated in place."""
    x, new_ssm, new_conv = _mamba_block(lp, x, cfg, ssm, conv, step=True)
    ssm.copy_(new_ssm)
    conv.copy_(new_conv)
    return x


# ---------------------------------------------------------------------------
# the shared attention block (Zamba re-injection)
# ---------------------------------------------------------------------------


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(rope_fraction=SHARED_ROPE[0], rope_theta=SHARED_ROPE[1])


def _shared_mlp(sp: SharedBlock, cat: torch.Tensor, y: torch.Tensor, adapter: nn.Module,
                cfg: ModelConfig) -> torch.Tensor:
    """The block's tail: its MLP on ``ln2(cat)`` added to the attention
    output ``y``, through the invocation's adapter."""
    h2 = C.rmsnorm(cat, sp.ln2, cfg.norm_eps)
    gate, up = C.linear_group(sp["mlp"], ("gate", "up"), "gate_up", h2)
    y = y + C.linear(sp["mlp"]["down"], C.swiglu(gate, up))
    return C.linear(adapter, y)


def _shared_attn(sp: SharedBlock, adapter: nn.Module, x: torch.Tensor, emb0: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The shared block's causal forward on concat(x, emb0) (B, S, 2D):
    returns the adapter's delta (B, S, D)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    cat = torch.cat([x, emb0.to(x.dtype)], dim=-1)
    hin = C.rmsnorm(cat, sp.ln1, cfg.norm_eps)
    q, k, v = (t.reshape(b, s, h, hd) for t in C.qkv(sp, hin, fuse=False))
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    tables = C.rope_tables(positions, hd, *SHARED_ROPE)
    att = C._sdpa_causal_chunked(C.apply_rope(q, tables), C.apply_rope(k, tables), v)
    y = C.linear(sp["o"], att.reshape(b, s, h * hd))
    return _shared_mlp(sp, cat, y, adapter, cfg)


def _shared_decode(sp: SharedBlock, adapter: nn.Module, x: torch.Tensor, emb0: torch.Tensor,
                   cfg: ModelConfig, kc: torch.Tensor, vc: torch.Tensor, bt,
                   pos: torch.Tensor) -> tuple:
    """The shared block's decode step over its invocation's cache ``kc`` /
    ``vc`` (dense (B, S, H, hd), or pools with ``bt``): the dense family's
    decode attention, q / k / v unfused. Returns (delta, {"shared_k",
    "shared_v"}: this step's rows)."""
    cat = torch.cat([x, emb0.to(x.dtype)], dim=-1)
    hin = C.rmsnorm(cat, sp.ln1, cfg.norm_eps)
    sc = _shared_cfg(cfg)
    if bt is not None:
        y, kt, vt = C.paged_attn(sp, hin, sc, kc, vc, bt, pos, fuse=False)
    else:
        y, kt, vt = C.attention_decode_ro(sp, hin, sc, kc, vc, pos, fuse=False)
    return _shared_mlp(sp, cat, y, adapter, cfg), {"shared_k": kt, "shared_v": vt}


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def _block(lp: MambaBlock, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _mamba_block(lp, x, cfg)[0]


def _hidden(params: HybridModel, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The trunk's rows (B, S, D) after ``ln_f``; the rows are zero-padded
    to a multiple of ``CHUNK`` inside. Under autograd, each Mamba block and
    each shared-block invocation is rematerialised in the backward when
    ``cfg.remat``."""
    x = C.embed_lookup(params.embed, tokens)
    b, s, d = x.shape
    pad = (-s) % CHUNK
    if pad:
        x = torch.cat([x, torch.zeros((b, pad, d), dtype=x.dtype, device=x.device)], dim=1)
    emb0 = x
    for seg, adapter in zip(params.m_layers, params.adapters):
        for lp in seg:
            x = C.remat(_block, lp, x, cfg, enabled=cfg.remat)
        x = x + C.remat(_shared_attn, params.shared, adapter, x, emb0, cfg, enabled=cfg.remat)
    for lp in params.rest_layers or ():
        x = C.remat(_block, lp, x, cfg, enabled=cfg.remat)
    return C.rmsnorm(x[:, :s], params.ln_f, cfg.norm_eps)


@torch.no_grad()
def forward(params: HybridModel, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab), causal; the rows are
    zero-padded to a multiple of ``CHUNK`` inside."""
    return C.linear(params.head, _hidden(params, cfg, tokens))


def loss_fn(params: HybridModel, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token CE (chunked) of the trunk; differentiable
    (``common.trainable``)."""
    h = _hidden(params, cfg, batch["tokens"])
    return C.cross_entropy_chunked(h[:, :-1], batch["labels"][:, 1:],
                                   lambda xc: C.linear(params.head, xc))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=C.DTYPE,
                      device=None) -> dict:
    """The recurrent state per slot (``ssm``, ``conv``; ``ssm_rest``,
    ``conv_rest`` for the rest layers), the shared block's cache of each
    invocation (``shared_k``, ``shared_v``) and positions (B,)."""
    dev = resolve_device(device)
    n_seg, every, rest = _segments(cfg)
    di, n, h_ssm, pdim = cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    conv_rows, conv_w = cfg.ssm_conv - 1, di + 2 * n

    def rec(lead):
        return {"ssm": torch.zeros((*lead, batch, h_ssm, pdim, n), dtype=torch.float32,
                                   device=dev),
                "conv": torch.zeros((*lead, batch, conv_rows, conv_w), dtype=dtype, device=dev)}

    st = rec((n_seg, every))
    st["pos"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    for key in ("shared_k", "shared_v"):
        st[key] = torch.zeros((n_seg, batch, max_len, cfg.n_heads, cfg.head_dim), dtype=dtype,
                              device=dev)
    if rest:
        r = rec((rest,))
        st["ssm_rest"], st["conv_rest"] = r["ssm"], r["conv"]
    return st


@torch.no_grad()
def decode_step(params: HybridModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, V), state). Every Mamba block's
    ``ssm`` / ``conv`` slice is updated in place; the shared block's rows of
    each invocation go into ``shared_k`` / ``shared_v`` (dense cache, or
    pools when ``"bt"`` is in state) in place after all layers, and ``pos``
    advances in place: the returned state is ``state`` itself."""
    x = C.embed_lookup(params.embed, tokens)
    emb0 = x
    b = tokens.shape[0]
    pos = C.slot_positions(state["pos"], b)[:, 0]
    bt = state.get("bt")
    rows: dict = {}
    for s_i, (seg, adapter) in enumerate(zip(params.m_layers, params.adapters)):
        for j, lp in enumerate(seg):
            x = _mamba_step(lp, x, cfg, state["ssm"][s_i, j], state["conv"][s_i, j])
        delta, new = _shared_decode(params.shared, adapter, x, emb0, cfg,
                                    state["shared_k"][s_i], state["shared_v"][s_i], bt, pos)
        x = x + delta
        for k, r in new.items():
            rows.setdefault(k, []).append(r)
    for i, lp in enumerate(params.rest_layers or ()):
        x = _mamba_step(lp, x, cfg, state["ssm_rest"][i], state["conv_rest"][i])
    D.commit_rows(state, rows, pos)
    state["pos"].copy_(pos + 1)
    x = C.rmsnorm(x, params.ln_f, cfg.norm_eps)
    return C.linear(params.head, x), state


# slot axis of every decode-state leaf as a negative offset from the trailing
# dims (the same for the segments' and the rest layers'): the prefill's gate
_B_AXIS = {"ssm": -4, "ssm_rest": -4, "conv": -3, "conv_rest": -3,
           "shared_k": -4, "shared_v": -4, "pos": -1}


@torch.no_grad()
def prefill(params: HybridModel, cfg: ModelConfig, tokens: torch.Tensor, state: dict,
            length=None, prefix=None):
    """The reference's prefill: the full forward for the logits (of
    position ``length - 1`` under bucket padding), then one decode step per
    prompt token on a copy of ``state``, each step's update kept only for
    the slots where the token is real (``length`` (B,)), so the recurrent
    state and the shared block's cache equal the unpadded prefill's.
    Returns (last_logits (B, 1, V), state); ``state`` is left unchanged. No
    prefix cache: the recurrent state is not page-addressable."""
    if prefix is not None:
        raise ValueError("mamba_hybrid serves no prefix cache: its recurrent state is not "
                         "page-addressable")
    logits = C.select_at_length(forward(params, cfg, tokens), length)
    return logits, C.gated_token_steps(lambda st, t: decode_step(params, cfg, st, t), tokens,
                                       state, length, _B_AXIS)


def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameters, as the reference counts them."""
    d, di, n, h_ssm = cfg.d_model, cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads
    m_layer = (d * (2 * di + 2 * n + h_ssm) + cfg.ssm_conv * (di + 2 * n) + 3 * h_ssm
               + di * d + di + d)
    n_seg, _, _ = _segments(cfg)
    d2, hhd = 2 * d, cfg.n_heads * cfg.head_dim
    shared = 3 * d2 * hhd + hhd * hhd + 2 * d2 * cfg.d_ff + cfg.d_ff * hhd + 2 * d2
    adapters = n_seg * hhd * d
    total = cfg.n_layers * m_layer + shared + adapters + cfg.padded_vocab * d * 2 + d
    return total, total
