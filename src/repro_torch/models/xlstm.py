"""xLSTM (``xlstm-1.3b``, family ``xlstm``): the port of
``repro/models/xlstm.py``.

mLSTM blocks (matrix memory, exponential gating) run in the stabilized
chunkwise form for a forward or prefill (a loop over chunks carrying C
(dqk, dv), n (dqk,) and the log-stabilizer m per head, attention-like
inside a chunk) and in the O(1) recurrent form for decode. sLSTM blocks
(scalar memory, block-diagonal recurrence) are sequential over time, so
the architecture uses them sparsely: the layers form segments of
``slstm_every - 1`` mLSTM blocks and one sLSTM block (``slstm_every`` 0:
mLSTM only).

Every linear goes through ``models.common``'s dispatch (packed linears
reach the dual kernels or ``w4a16_gemm``; the sLSTM ffn's gate/up fuse as
``gate_up``). The recurrent ``r`` product, the causal conv and the gate
arithmetic are plain tensor code, as in the reference (no Pallas kernel
there). The head and the embedding stay bf16.

Decode state, all per slot (nothing to page: ``paged=True`` serves it in
the dense per-slot layout, as the reference does): ``mC`` (n_seg, m_per,
B, H, dqk, dv), ``mn`` (..., B, H, dqk), ``mm`` (..., B, H) in f32 and
``conv`` (..., B, 3, d_inner) bf16 for the mLSTM blocks (leading axis
(n_m,) when ``n_seg`` is 0); ``sh``, ``sc``, ``sn``, ``sm`` (n_seg, B, D)
f32 for the sLSTM blocks; ``pos`` (B,). A decode step updates all of it in
place, so one captured CUDA graph serves every step.

A prefill is the reference's algorithm: the chunkwise trunk for the
logits, then one decode step per prompt token to build the state, each
step's update kept only where the token is real
(``common.gated_token_steps``, shared with Zamba2), so a bucket-padded
prefill leaves the unpadded one's state.

Modules keep the reference's names: ``m_layers[seg][j]`` (or
``m_layers[i]``) are :class:`MLSTMBlock` (linears ``up``, ``wq``, ``wk``,
``wv``, ``wif``, ``down``; ``ln``, ``conv``, ``gn``), ``s_layers[seg]``
:class:`SLSTMBlock` (linear ``w``, ``ffn/{gate,up,down}``; ``ln``, ``r``,
``gn``, ``ln2``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import common as C

__all__ = ["CHUNK", "CHUNK_MIN", "MLSTMBlock", "SLSTMBlock", "XLSTMModel", "init_params",
           "forward", "loss_fn", "init_decode_state", "prefill", "decode_step", "count_params"]

# chunk size: per-token state traffic scales as H*dqk*dv/chunk, the
# intra-chunk work as chunk; for the 1.3b dims they cross near 1k, so long
# sequences take 1024-token chunks
CHUNK = 1024
CHUNK_MIN = 256


def _pick_chunk(s: int) -> int:
    return CHUNK if s % CHUNK == 0 and s >= CHUNK else CHUNK_MIN


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = int(cfg.d_model * cfg.xlstm_proj_factor)
    h = cfg.n_heads
    return d_inner, h, d_inner // h


def _qk_dim(cfg: ModelConfig) -> int:
    # qk_dim_factor 0.5, as the official xLSTM (halves the matrix memory)
    _, _, dh = _dims(cfg)
    return max(2, dh // 2)


def _segments(cfg: ModelConfig) -> tuple[int, int]:
    """(segments, mLSTM blocks a segment); (0, n_layers) for mLSTM only."""
    if cfg.slstm_every <= 0:
        return 0, cfg.n_layers
    n_seg = cfg.n_layers // cfg.slstm_every
    if n_seg * cfg.slstm_every != cfg.n_layers:
        raise ValueError(f"xlstm needs n_layers % slstm_every == 0, got {cfg.n_layers} layers "
                         f"and slstm_every {cfg.slstm_every}")
    return n_seg, cfg.slstm_every - 1


class MLSTMBlock(nn.Module):
    """One mLSTM block: linears ``up`` (D, 2 d_inner), ``wq`` / ``wk``
    (d_inner, H dqk), ``wv`` (d_inner, d_inner), ``wif`` (d_inner, 2 H: the
    input and forget gates a head), ``down`` (d_inner, D); the norm ``ln``
    (D,), the depthwise causal ``conv`` (4, d_inner) and the cell norm
    ``gn`` (d_inner,) as buffers."""

    def __init__(self, linears: dict, ln: torch.Tensor, conv: torch.Tensor, gn: torch.Tensor):
        super().__init__()
        for name in ("up", "wq", "wk", "wv", "wif", "down"):
            setattr(self, name, linears[name])
        for name, t in (("ln", ln), ("conv", conv), ("gn", gn)):
            self.register_buffer(name, t)


class SLSTMBlock(nn.Module):
    """One sLSTM block: the linear ``w`` (D, 4 D) of the i, f, z, o
    pre-activations, the ffn ``{gate, up, down}`` (D -> 2 D -> D); the norms
    ``ln``, ``gn``, ``ln2`` (D,) and the block-diagonal recurrence ``r`` (H,
    dh, 4 dh) as buffers."""

    def __init__(self, w: nn.Module, ffn: dict, ln: torch.Tensor, r: torch.Tensor,
                 gn: torch.Tensor, ln2: torch.Tensor):
        super().__init__()
        self.w = w
        self.ffn = nn.ModuleDict(ffn)
        for name, t in (("ln", ln), ("r", r), ("gn", gn), ("ln2", ln2)):
            self.register_buffer(name, t)


class XLSTMModel(nn.Module):
    """Embedding, the mLSTM blocks (``m_layers``: a list of segments, each
    a list of blocks, or one flat list with no sLSTM), the sLSTM blocks
    (``s_layers``, one a segment), ``ln_f`` and the untied head."""

    def __init__(self, embed: torch.Tensor, m_layers: list, s_layers: Optional[list],
                 ln_f: torch.Tensor, head: nn.Module):
        super().__init__()
        self.register_buffer("embed", embed)
        if s_layers is None:
            self.m_layers = nn.ModuleList(m_layers)
            self.s_layers = None
        else:
            self.m_layers = nn.ModuleList([nn.ModuleList(seg) for seg in m_layers])
            self.s_layers = nn.ModuleList(s_layers)
        self.register_buffer("ln_f", ln_f)
        self.head = head


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> XLSTMModel:
    """Random parameters with the reference's init: N(0, 1/d_in) bf16
    linears, the conv N(0, 0.1^2), ``r`` N(0, 1/dh), norms of ones, the
    embedding N(0, 0.02^2). Runs on the card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    d_inner, h, _ = _dims(cfg)
    dqk = _qk_dim(cfg)
    sdh = d // h

    def lin(d_in, d_out):
        return C.Linear(C.init_normal(gen, (d_in, d_out), C.dense_std(d_in), dev))

    def ones(k):
        return torch.ones((k,), dtype=C.DTYPE, device=dev)

    def mlstm():
        return MLSTMBlock({"up": lin(d, 2 * d_inner), "wq": lin(d_inner, dqk * h),
                           "wk": lin(d_inner, dqk * h), "wv": lin(d_inner, d_inner),
                           "wif": lin(d_inner, 2 * h), "down": lin(d_inner, d)},
                          ones(d), C.init_normal(gen, (4, d_inner), 0.1, dev), ones(d_inner))

    def slstm():
        return SLSTMBlock(lin(d, 4 * d), {"gate": lin(d, 2 * d), "up": lin(d, 2 * d),
                                          "down": lin(2 * d, d)},
                          ones(d), C.init_normal(gen, (h, sdh, 4 * sdh), 1.0 / sdh ** 0.5, dev),
                          ones(d), ones(d))

    n_seg, m_per = _segments(cfg)
    embed = C.init_normal(gen, (cfg.padded_vocab, d), 0.02, dev)
    head = lin(d, cfg.padded_vocab)
    if n_seg == 0:
        return XLSTMModel(embed, [mlstm() for _ in range(cfg.n_layers)], None, ones(d), head)
    m_layers = [[mlstm() for _ in range(m_per)] for _ in range(n_seg)]
    return XLSTMModel(embed, m_layers, [slstm() for _ in range(n_seg)], ones(d), head)


# ---------------------------------------------------------------------------
# mLSTM core (chunkwise, stabilized) and its recurrent step
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv, kernel 4. x (B, S, D); w (4, D); ``state``
    (B, 3, D) the previous rows (zeros when None). The reference's sum:
    ((0 + t0) + t1) + t2 + t3, every product and add rounded to x's dtype.
    Returns (out, the last 3 rows)."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
           if state is None else state)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out, xp[:, -(k - 1):, :]


def _mlstm_chunkwise(q, k, v, i_raw, f_raw, state: dict):
    """q, k (B, S, H, dqk); v (B, S, H, dv); i_raw, f_raw (B, S, H); state
    {C (B, H, dqk, dv), n (B, H, dqk), m (B, H)} f32. Returns (h (B, S, H,
    dv) in q's dtype, the state after the last chunk)."""
    b, s, h, dqk = q.shape
    dv = v.shape[-1]
    f32 = torch.float32
    l = _pick_chunk(s)
    nc = s // l
    scale = 1.0 / (dqk ** 0.5)
    qc = (q * scale).reshape(b, nc, l, h, dqk).to(f32)
    kc = k.reshape(b, nc, l, h, dqk).to(f32)
    vc = v.reshape(b, nc, l, h, dv).to(f32)
    lf = torch.nn.functional.logsigmoid(f_raw.to(f32)).reshape(b, nc, l, h)
    ii = i_raw.to(f32).reshape(b, nc, l, h)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))[None, :, :, None]
    Cst, nst, mst = state["C"], state["n"], state["m"]
    hs = []
    for c in range(nc):
        qq, kk, vv, lff, iii = qc[:, c], kc[:, c], vc[:, c], lf[:, c], ii[:, c]
        F = torch.cumsum(lff, dim=1)  # (B, l, H) inclusive decay to t
        # intra-chunk log weights D[t, s] = F_t - F_s + i_s (s <= t)
        Dlog = F[:, :, None, :] - F[:, None, :, :] + iii[:, None, :, :]
        Dlog = torch.where(tri, Dlog, -torch.inf)
        b_t = F + mst[:, None, :]  # inter-chunk log coefficient
        # the stabilizer carries no gradient (the reference's stop_gradient)
        m_t = torch.maximum(torch.amax(Dlog, dim=2), b_t).detach()
        w_intra = torch.exp(Dlog - m_t[:, :, None, :])
        c_inter = torch.exp(b_t - m_t)
        scores = torch.einsum("blhd,bshd->blsh", qq, kk) * w_intra
        num = torch.einsum("blsh,bshd->blhd", scores, vv)
        num = num + c_inter[..., None] * torch.einsum("blhd,bhde->blhe", qq, Cst)
        den = torch.sum(scores, dim=2) + c_inter * torch.einsum("blhd,bhd->blh", qq, nst)
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None])
        # state update; wk is the reference's unstabilized per-key weight
        g = F[:, -1]  # (B, H) total chunk decay
        wk = torch.exp(g[:, None, :] - F + iii)
        m_new = torch.maximum(g + mst,
                              torch.amax(torch.log(torch.clamp_min(wk, 1e-38)), dim=1)).detach()
        wk_st = torch.exp(g[:, None, :] - F + iii - m_new[:, None, :])
        decay = torch.exp(g + mst - m_new)
        Cst = decay[:, :, None, None] * Cst + torch.einsum("blhd,blhe,blh->bhde", kk, vv, wk_st)
        nst = decay[:, :, None] * nst + torch.einsum("blhd,blh->bhd", kk, wk_st)
        mst = m_new
    h_out = torch.stack(hs, dim=1).reshape(b, s, h, dv)
    return h_out.to(q.dtype), {"C": Cst, "n": nst, "m": mst}


def _mlstm_step(q, k, v, i_raw, f_raw, state: dict):
    """One recurrent mLSTM step: q, k (B, 1, H, dqk); v (B, 1, H, dv).
    Returns (h (B, 1, H, dv) in q's dtype, the new state)."""
    dqk = q.shape[-1]
    f32 = torch.float32
    scale = 1.0 / (dqk ** 0.5)
    qq = (q[:, 0] * scale).to(f32)
    kk = k[:, 0].to(f32)
    vv = v[:, 0].to(f32)
    lf = torch.nn.functional.logsigmoid(f_raw[:, 0].to(f32))  # (B, H)
    ii = i_raw[:, 0].to(f32)
    m_new = torch.maximum(lf + state["m"], ii)
    f_st = torch.exp(lf + state["m"] - m_new)
    i_st = torch.exp(ii - m_new)
    C_new = f_st[:, :, None, None] * state["C"] + i_st[:, :, None, None] * torch.einsum(
        "bhd,bhe->bhde", kk, vv)
    n_new = f_st[:, :, None] * state["n"] + i_st[:, :, None] * kk
    num = torch.einsum("bhd,bhde->bhe", qq, C_new)
    den = torch.einsum("bhd,bhd->bh", qq, n_new)
    hout = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return hout[:, None].to(q.dtype), {"C": C_new, "n": n_new, "m": m_new}


def _mlstm_block(lp: MLSTMBlock, x: torch.Tensor, cfg: ModelConfig, state=None,
                 conv_state=None, step: bool = False):
    """One mLSTM block on x (B, S, D): ``up`` into the cell input and the
    output gate z, the causal conv and SiLU, q / k from the conv output, v
    from the cell input, the gates (the forget gate's bias init + 3.0), the
    chunkwise core (or one ``step``), the ``gn`` norm, the z gate and
    ``down``. Returns (x + out, state, the conv rows for the next step)."""
    d_inner, h, dh = _dims(cfg)
    b, s, _ = x.shape
    hin = C.rmsnorm(x, lp.ln, cfg.norm_eps)
    up = C.linear(lp.up, hin)
    xm, z = up[..., :d_inner], up[..., d_inner:]
    xc, conv_state = _causal_conv(xm, lp.conv, conv_state)
    xc = torch.nn.functional.silu(xc.to(torch.float32)).to(x.dtype)
    dqk = _qk_dim(cfg)
    q = C.linear(lp.wq, xc).reshape(b, s, h, dqk)
    k = C.linear(lp.wk, xc).reshape(b, s, h, dqk)
    v = C.linear(lp.wv, xm).reshape(b, s, h, dh)
    gates = C.linear(lp.wif, xc).reshape(b, s, h, 2)
    i_raw, f_raw = gates[..., 0], gates[..., 1] + 3.0  # forget-gate bias init
    if state is None:
        state = {"C": torch.zeros((b, h, dqk, dh), dtype=torch.float32, device=x.device),
                 "n": torch.zeros((b, h, dqk), dtype=torch.float32, device=x.device),
                 "m": torch.full((b, h), -1e30, dtype=torch.float32, device=x.device)}
    hcell, state = (_mlstm_step if step else _mlstm_chunkwise)(q, k, v, i_raw, f_raw, state)
    hcell = C.rmsnorm(hcell.reshape(b, s, d_inner), lp.gn, cfg.norm_eps)
    gate = torch.nn.functional.silu(z.to(torch.float32)).to(x.dtype)
    return x + C.linear(lp.down, hcell * gate), state, conv_state


# ---------------------------------------------------------------------------
# sLSTM core (sequential)
# ---------------------------------------------------------------------------


def _slstm_cell(lp: SLSTMBlock, x: torch.Tensor, cfg: ModelConfig, state=None,
                step: bool = False):
    """x (B, S, D): the scalar-memory LSTM with exponential gating and the
    block-diagonal recurrence. ``rec`` is per head, ``[i f z o]`` blocks of
    dh flattened to (B, 4 D), added positionally to the pre-activations,
    whose layout is ``[i f z o]`` blocks of D (the reference's layout).
    Returns (h (B, S, D) in x's dtype, the state {h, c, n, m} (B, D) f32)."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    f32 = torch.float32
    pre_all = C.linear(lp.w, x).to(f32)  # (B, S, 4D)
    r = lp.r.to(f32)  # (H, dh, 4 dh)
    if state is None:
        state = {"h": torch.zeros((b, d), dtype=f32, device=x.device),
                 "c": torch.zeros((b, d), dtype=f32, device=x.device),
                 "n": torch.ones((b, d), dtype=f32, device=x.device),
                 "m": torch.zeros((b, d), dtype=f32, device=x.device)}
    logsig = torch.nn.functional.logsigmoid
    outs = []
    for t in range(s):
        hp = state["h"].reshape(b, h, dh)
        rec = torch.einsum("bhd,hde->bhe", hp, r).reshape(b, 4 * d)
        pre = pre_all[:, t] + rec
        i_t, f_t, z_t, o_t = torch.split(pre, d, dim=-1)
        m_new = torch.maximum(logsig(f_t) + state["m"], i_t)
        i_st = torch.exp(i_t - m_new)
        f_st = torch.exp(logsig(f_t) + state["m"] - m_new)
        c_new = f_st * state["c"] + i_st * torch.tanh(z_t)
        n_new = f_st * state["n"] + i_st
        h_new = torch.sigmoid(o_t) * c_new / torch.clamp_min(n_new, 1e-6)
        state = {"h": h_new, "c": c_new, "n": n_new, "m": m_new}
        outs.append(h_new)
    return torch.stack(outs, dim=1).to(x.dtype), state


def _slstm_block(lp: SLSTMBlock, x: torch.Tensor, cfg: ModelConfig, state=None,
                 step: bool = False):
    """One sLSTM block: the cell on ``ln(x)``, ``gn``, the residual, then
    the ffn (gate/up, fused when packed) on ``ln2``. Returns (x, state)."""
    hin = C.rmsnorm(x, lp.ln, cfg.norm_eps)
    hcell, state = _slstm_cell(lp, hin, cfg, state, step)
    x = x + C.rmsnorm(hcell, lp.gn, cfg.norm_eps)
    x = x + C.mlp_apply(lp.ffn, C.rmsnorm(x, lp.ln2, cfg.norm_eps))
    return x, state


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def _trunk(params: XLSTMModel, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Every block with a fresh state over x (B, S, D), zero-padded inside
    to a multiple of CHUNK_MIN (S < CHUNK) or of the chunk. Returns the
    hidden rows (B, S, D). Under autograd each block is rematerialised in
    the backward when ``cfg.remat``."""
    b, s, d = x.shape
    chunk = _pick_chunk(max(s, CHUNK_MIN))
    pad = (-s) % (CHUNK_MIN if s < CHUNK else chunk)
    if pad:
        x = torch.cat([x, torch.zeros((b, pad, d), dtype=x.dtype, device=x.device)], dim=1)

    def m_block(lp, y):
        return _mlstm_block(lp, y, cfg)[0]

    def s_block(lp, y):
        return _slstm_block(lp, y, cfg)[0]

    segs = ([(params.m_layers, None)] if params.s_layers is None
            else zip(params.m_layers, params.s_layers))
    for seg, sp in segs:
        for lp in seg:
            x = C.remat(m_block, lp, x, enabled=cfg.remat)
        if sp is not None:
            x = C.remat(s_block, sp, x, enabled=cfg.remat)
    return x[:, :s]


@torch.no_grad()
def forward(params: XLSTMModel, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab), causal."""
    x = _trunk(params, cfg, C.embed_lookup(params.embed, tokens))
    return C.linear(params.head, C.rmsnorm(x, params.ln_f, cfg.norm_eps))


def loss_fn(params: XLSTMModel, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token CE (chunked) of the trunk, the sLSTM blocks through the
    plain cell (the reference's ``_slstm_cell_sharded`` without a mesh);
    differentiable (``common.trainable``)."""
    x = _trunk(params, cfg, C.embed_lookup(params.embed, batch["tokens"]))
    h = C.rmsnorm(x, params.ln_f, cfg.norm_eps)
    return C.cross_entropy_chunked(h[:, :-1], batch["labels"][:, 1:],
                                   lambda xc: C.linear(params.head, xc))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=C.DTYPE,
                      device=None) -> dict:
    """The recurrent state (O(1) in the sequence length; ``max_len`` is not
    read): see the module docstring."""
    dev = resolve_device(device)
    d_inner, h, dh = _dims(cfg)
    n_seg, m_per = _segments(cfg)
    lead = (n_seg, m_per) if n_seg else (cfg.n_layers,)
    dqk, f32 = _qk_dim(cfg), torch.float32
    st = {"mC": torch.zeros((*lead, batch, h, dqk, dh), dtype=f32, device=dev),
          "mn": torch.zeros((*lead, batch, h, dqk), dtype=f32, device=dev),
          "mm": torch.full((*lead, batch, h), -1e30, dtype=f32, device=dev),
          "conv": torch.zeros((*lead, batch, 3, d_inner), dtype=dtype, device=dev),
          "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if n_seg:
        shape = (n_seg, batch, cfg.d_model)
        st.update(sh=torch.zeros(shape, dtype=f32, device=dev),
                  sc=torch.zeros(shape, dtype=f32, device=dev),
                  sn=torch.ones(shape, dtype=f32, device=dev),
                  sm=torch.zeros(shape, dtype=f32, device=dev))
    return st


def _mlstm_decode(lp: MLSTMBlock, x: torch.Tensor, cfg: ModelConfig, state: dict,
                  idx: tuple) -> torch.Tensor:
    """One decode step of an mLSTM block, its state views at ``idx``
    (``mC``, ``mn``, ``mm``, ``conv``) updated in place."""
    views = {k: state[k][idx] for k in ("mC", "mn", "mm", "conv")}
    x, new, conv = _mlstm_block(lp, x, cfg, {"C": views["mC"], "n": views["mn"],
                                             "m": views["mm"]}, views["conv"], step=True)
    views["mC"].copy_(new["C"])
    views["mn"].copy_(new["n"])
    views["mm"].copy_(new["m"])
    views["conv"].copy_(conv)
    return x


@torch.no_grad()
def decode_step(params: XLSTMModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, 1, V), state). Every block's state is
    updated in place and ``pos`` advances in place: the returned state is
    ``state`` itself."""
    x = C.embed_lookup(params.embed, tokens)
    if params.s_layers is None:
        for i, lp in enumerate(params.m_layers):
            x = _mlstm_decode(lp, x, cfg, state, (i,))
    else:
        for s_i, (seg, sp) in enumerate(zip(params.m_layers, params.s_layers)):
            for j, lp in enumerate(seg):
                x = _mlstm_decode(lp, x, cfg, state, (s_i, j))
            keys = ("sh", "sc", "sn", "sm")
            old = {k[1]: state[k][s_i] for k in keys}
            x, new = _slstm_block(sp, x, cfg, old, step=True)
            for k in keys:
                state[k][s_i].copy_(new[k[1]])
    state["pos"].add_(1)
    x = C.rmsnorm(x, params.ln_f, cfg.norm_eps)
    return C.linear(params.head, x), state


# slot axis of every decode-state leaf as a negative offset from the
# trailing dims: the prefill's gate
_B_AXIS = {"mC": -4, "mn": -3, "mm": -2, "conv": -3,
           "sh": -2, "sc": -2, "sn": -2, "sm": -2, "pos": -1}


@torch.no_grad()
def prefill(params: XLSTMModel, cfg: ModelConfig, tokens: torch.Tensor, state: dict,
            length=None, prefix=None):
    """The reference's prefill: the chunkwise trunk for the logits (of
    position ``length - 1`` under bucket padding), then one decode step per
    prompt token on a copy of ``state``, each step's update kept only for
    the slots where the token is real (``length`` (B,)), so the state
    equals the unpadded prefill's. Returns (last_logits (B, 1, V), state);
    ``state`` is left unchanged. No prefix cache: nothing is paged."""
    if prefix is not None:
        raise ValueError("xlstm serves no prefix cache: its recurrent state is not "
                         "page-addressable")
    x = _trunk(params, cfg, C.embed_lookup(params.embed, tokens))
    h = C.rmsnorm(C.select_at_length(x, length), params.ln_f, cfg.norm_eps)
    logits = C.linear(params.head, h)
    return logits, C.gated_token_steps(lambda st, t: decode_step(params, cfg, st, t), tokens,
                                       state, length, _B_AXIS)


def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameters, as the reference counts them."""
    d = cfg.d_model
    d_inner, h, _ = _dims(cfg)
    dqk = _qk_dim(cfg)
    m_layer = (d * 2 * d_inner + 4 * d_inner + 2 * d_inner * dqk * h
               + d_inner * d_inner + d_inner * 2 * h + d_inner * d + 2 * d_inner + d)
    s_layer = 4 * d * d + h * (d // h) * 4 * (d // h) + 3 * d * 2 * d + 4 * d
    n_seg, m_per = _segments(cfg)
    n_m = cfg.n_layers if n_seg == 0 else n_seg * m_per
    total = n_m * m_layer + n_seg * s_layer + cfg.padded_vocab * d * 2 + d
    return total, total
