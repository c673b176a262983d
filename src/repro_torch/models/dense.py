"""Dense decoder-only transformer (llama3, qwen3, qwen2, stablelm, phi4,
internlm2; and the ``vlm`` family's backbone, internvl2): modules, init and
the serving entry points. A VLM request prepends its frontend's patch
embeddings to the prompt (``patches`` in :func:`forward` and
:func:`prefill`, the reference's ``_embed``).

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

__all__ = ["DenseLayer", "DenseModel", "init_params", "forward", "forward_with_taps",
           "init_decode_state", "prefill", "decode_step", "ragged_step", "count_params",
           "head_fn", "loss_fn",
           "run_layers", "prefill_layers", "decode_layers", "ragged_layers", "commit_rows",
           "gqa_prefill", "gqa_decode"]


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


def _embed(params: DenseModel, tokens: torch.Tensor, patches=None) -> torch.Tensor:
    """Token embeddings (B, S, D), after the patch rows (B, P, D) if given."""
    x = C.embed_lookup(params.embed, tokens)
    if patches is not None:  # VLM: prepend the stub frontend's patch embeddings
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def head_fn(params: DenseModel, cfg: ModelConfig):
    """Chunk-applicable unembed: (B, c, D) -> (B, c, V); tied to the
    embedding or the bf16 head."""
    if cfg.tie_embeddings:
        return lambda xc: xc @ C.embed_attend(params.embed).to(xc.dtype).T
    return lambda xc: C.linear(params.head, xc)


def _unembed(params: DenseModel, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return head_fn(params, cfg)(C.rmsnorm(x, params.ln_f, cfg.norm_eps))


def _mlp(lp, h: torch.Tensor) -> torch.Tensor:
    return C.mlp_apply(lp.mlp, h)


def _steps(attend) -> list:
    """A layer's attention steps: one callable or a sequence of them."""
    return list(attend) if isinstance(attend, (list, tuple)) else [attend]


def _rms(cfg: ModelConfig):
    return lambda y, w: C.rmsnorm(y, w, cfg.norm_eps)


def _layer(lp, x: torch.Tensor, steps, norm):
    """One pre-norm layer: step i, ``fn(lp, h) -> out`` or ``(out, rows)``,
    runs on ``norm(x, lp.ln<i>)`` (``ln1``, ``ln2``, ... in order) and its
    output is added to the stream. Returns (x, rows): the cache rows the
    steps returned, by state key."""
    rows = {}
    for i, fn in enumerate(steps, 1):
        out = fn(lp, norm(x, getattr(lp, f"ln{i}")))
        if isinstance(out, tuple):
            out, new = out
            rows.update(new)
        x = x + out
    return x, rows


def gqa_prefill(lp, h: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor, mask=None,
                prefix=None):
    """The GQA attention step of a prefill: ``prefix`` holds this layer's
    cached ``k`` / ``v`` rows. Returns (out, {"k", "v"})."""
    pkv = None if prefix is None else (prefix["k"], prefix["v"])
    att, k, v = C.gqa_prefill_attn(lp.attn, h, cfg, positions, prefix_kv=pkv, mask=mask)
    return att, {"k": k, "v": v}


def gqa_decode(lp, h: torch.Tensor, cfg: ModelConfig, cache: dict, bt, pos: torch.Tensor):
    """The GQA attention step of a decode: over this layer's pools through
    the paged kernel (``bt`` given), else over its dense cache. Returns
    (out, {"k", "v"}), the rows of this step."""
    if bt is not None:
        att, kt, vt = C.paged_attn(lp.attn, h, cfg, cache["k"], cache["v"], bt, pos)
    else:
        att, kt, vt = C.attention_decode_ro(lp.attn, h, cfg, cache["k"], cache["v"], pos)
    return att, {"k": kt, "v": vt}


def _aux_layer(lp, x: torch.Tensor, steps, norm) -> tuple:
    """:func:`_layer` keeping only the "aux" row (an MoE block's router
    loss, None for a layer without one)."""
    x, rows = _layer(lp, x, steps, norm)
    return x, rows.get("aux")


def run_layers(params, cfg: ModelConfig, x: torch.Tensor, ffn,
               attend=gqa_prefill, norm=None) -> tuple:
    """The causal forward's layers over the embedded ``x`` (B, S, D):
    ``attend(lp, h, cfg, positions)`` (one step or a sequence of them, on
    ``ln1``, ``ln2``, ...), then ``ffn(lp, h)`` on the next norm; ``norm(y,
    w)`` is the layer's norm (RMSNorm by default). Under autograd (a
    ``loss_fn``) each layer is rematerialised in the backward when
    ``cfg.remat``, as the reference's ``jax.checkpoint`` of its scan body.
    Returns (x, aux): the "aux" rows the layers' steps returned (an MoE
    layer's router loss), in layer order."""
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    steps = [lambda l, h, a=a: a(l, h, cfg, positions) for a in _steps(attend)] + [ffn]
    norm = norm or _rms(cfg)
    aux = []
    for lp in params.layers:
        x, a = C.remat(_aux_layer, lp, x, steps, norm, enabled=cfg.remat)
        if a is not None:
            aux.append(a)
    return x, aux


def prefill_layers(params, cfg: ModelConfig, x: torch.Tensor, state: dict, ffn,
                   attend=gqa_prefill, length=None, prefix=None, norm=None):
    """The prefill layer loop of every family: the embedded prompt ``x`` (B,
    S, D) through ``params.layers`` (``attend(lp, h, cfg, positions, mask,
    prefix)``, one step or a sequence of them, then ``ffn(lp, h)``; ``norm``
    as in :func:`run_layers`), the rows each layer's steps return written
    into a copy of its cache (every state key but ``pos``) from row 0.
    ``prefix`` = {key: (L, B, m, ...)} is a cached prompt prefix: positions
    start at m, queries see it whole (``C.prefix_attn_mask``) and ``pos``
    counts it. Returns (x, new_state); ``state`` itself is left unchanged."""
    b, s, _ = x.shape
    off = 0 if prefix is None else next(iter(prefix.values())).shape[2]
    positions = off + torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    mask = None if prefix is None else C.prefix_attn_mask(s, off, x.device)
    caches = {k: v.clone() for k, v in state.items() if k != "pos"}
    for i, lp in enumerate(params.layers):
        pre = None if prefix is None else {k: v[i] for k, v in prefix.items()}
        steps = [lambda l, h, a=a: a(l, h, cfg, positions, mask, pre)
                 for a in _steps(attend)] + [ffn]
        x, rows = _layer(lp, x, steps, norm or _rms(cfg))
        for k, r in rows.items():
            caches[k][i, :, :r.shape[1]] = r.to(caches[k].dtype)
    return x, {**caches, "pos": off + C.prefill_pos(length, b, s, x.device)}


def _commit(state: dict, rows: dict, write) -> None:
    """Each state key's rows of every layer, stacked (L, ...), written in
    place by ``write(cache, rows)``."""
    for k, ts in rows.items():
        write(state[k], torch.stack(ts))


def commit_rows(state: dict, rows: dict, pos: torch.Tensor, sq: int = 1) -> None:
    """In place: each key's rows of this step, ``rows[key]`` (L, B, sq, ...)
    stacked over the layers, into ``state[key]``'s dense cache at ``pos``
    or, with a block table ``state["bt"]``, its pools."""
    bt = state.get("bt")
    if bt is None:
        _commit(state, rows, lambda c, t: C.update_cache_slot_stacked(c, t, pos))
        return
    p0 = state[next(iter(rows))]
    b = pos.shape[0]
    slots = torch.arange(b, device=pos.device)[:, None].expand(b, sq).reshape(-1)
    where = pool_rows(bt, slots, C.slot_positions(pos, b, sq).reshape(-1),
                      p0.shape[2], p0.shape[1])
    _commit(state, rows, lambda c, t: C.write_page_rows(
        c, t.reshape(t.shape[0], b * sq, *t.shape[3:]), where))


def decode_layers(params, cfg: ModelConfig, state: dict, tokens: torch.Tensor, ffn,
                  attend=gqa_decode, norm=None, embed=None, unembed=None):
    """The decode layer loop of every family: tokens (B, sq) -> (logits (B,
    sq, V), state). ``attend(lp, h, cfg, cache, bt, pos)`` (one step or a
    sequence of them, on ``ln1``, ``ln2``, ..., then ``ffn`` on the next
    norm) gets this layer's slice of every state key (pools when ``"bt"`` is
    in state) and returns its output, or (output, the step's rows by key).
    Only the keys a step returns as rows are written: into ``state``'s
    caches (dense) or pools (paged), in place after all layers ran; the
    other keys (an encoder's cross-attention rows) are read only.
    ``state["pos"]`` advances by sq in place: the returned state is
    ``state`` itself, its tensors the same objects, so a captured step reads
    and writes the same memory at every replay. ``embed(tokens, pos)`` and
    ``unembed(x)`` default to the token embedding and the head; the norms
    (RMSNorm unless ``norm`` is given) run one draft column at a time
    (``C.per_draft_row``; see :func:`decode_step`)."""
    b, sq = tokens.shape
    pos = C.slot_positions(state["pos"], b)[:, 0]
    x = C.embed_lookup(params.embed, tokens) if embed is None else embed(tokens, pos)
    bt = state.get("bt")
    keys = [k for k in state if k not in ("pos", "bt")]
    rows: dict = {}
    norm = norm or _rms(cfg)
    for i, lp in enumerate(params.layers):
        cache = {k: state[k][i] for k in keys}
        steps = [lambda l, h, a=a: a(l, h, cfg, cache, bt, pos) for a in _steps(attend)] + [ffn]
        x, new = _layer(lp, x, steps,
                        lambda y, w: C.per_draft_row(lambda z: norm(z, w), y))
        for k, r in new.items():
            rows.setdefault(k, []).append(r)
    commit_rows(state, rows, pos, sq)
    state["pos"].copy_(pos + sq)
    return (_unembed(params, cfg, x) if unembed is None else unembed(x)), state


def ragged_layers(params, cfg: ModelConfig, state: dict, tokens: torch.Tensor,
                  slot: torch.Tensor, pos: torch.Tensor, ctx: torch.Tensor,
                  logit_idx: torch.Tensor, ffn):
    """The ragged layer loop of the GQA families (see :func:`ragged_step`):
    each layer's attention through ``C.ragged_attn`` over its pools, then
    ``ffn(lp, h)``; the rows committed to the pools and ``pos`` set in
    place. Returns (logits (B, V), state)."""
    x = C.embed_lookup(params.embed, tokens[None, :])
    kp0 = state["k"]
    where = pool_rows(state["bt"], slot, pos, kp0.shape[2], kp0.shape[1])

    def attend(i):
        def fn(lp, h):
            att, kt, vt = C.ragged_attn(lp.attn, h, cfg, state["k"][i], state["v"][i],
                                        state["bt"], slot, pos, ctx)
            return att, {"k": kt, "v": vt}
        return fn

    rows = {"k": [], "v": []}
    for i, lp in enumerate(params.layers):
        x, new = _layer(lp, x, [attend(i), ffn], _rms(cfg))
        for k in rows:
            rows[k].append(new[k])
    _commit(state, rows, lambda c, t: C.write_page_rows(c, t, where))
    b = ctx.shape[0]
    counts = (slot.long()[None, :] == torch.arange(b, device=x.device)[:, None]).sum(dim=1)
    state["pos"].copy_(ctx.long() + counts)
    return _unembed(params, cfg, x[0][logit_idx.long()][None])[0], state


@torch.no_grad()
def forward(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor,
            patches=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S[, +P], padded_vocab), causal; ``patches``
    (B, P, D) come first."""
    return _unembed(params, cfg, run_layers(params, cfg, _embed(params, tokens, patches), _mlp)[0])


def loss_fn(params: DenseModel, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Next-token CE of ``batch`` (``tokens``, ``labels`` (B, S); the
    ``vlm`` family's ``patches`` (B, P, D) prepended, the loss on the text
    positions only), through the chunked CE; the layers rematerialised when
    ``cfg.remat``. Differentiable: the weights must be parameters
    (``common.trainable``)."""
    patches = batch.get("patches")
    x, _ = run_layers(params, cfg, _embed(params, batch["tokens"], patches), _mlp)
    h = C.rmsnorm(x, params.ln_f, cfg.norm_eps)
    if patches is not None:
        h = h[:, patches.shape[1]:]
    return C.cross_entropy_chunked(h[:, :-1], batch["labels"][:, 1:], head_fn(params, cfg))


@torch.no_grad()
def forward_with_taps(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor):
    """Forward that also returns per-layer calibration activations:
    ``{"attn": (L, T, D) ln1 outputs, "mlp": (L, T, D) ln2 outputs}`` with
    T = B * S — the inputs the q/k/v and gate/up linears see (the paper's
    per-layer calibration set). Returns (logits (B, S, V), taps)."""
    x = C.embed_lookup(params.embed, tokens)
    b, s, d = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :].expand(b, s)
    t1, t2 = [], []
    for lp in params.layers:
        h1 = C.rmsnorm(x, lp.ln1, cfg.norm_eps)
        att, _, _ = C.gqa_prefill_attn(lp.attn, h1, cfg, positions)
        h = x + att
        h2 = C.rmsnorm(h, lp.ln2, cfg.norm_eps)
        x = h + C.mlp_apply(lp.mlp, h2)
        t1.append(h1.reshape(b * s, d))
        t2.append(h2.reshape(b * s, d))
    return _unembed(params, cfg, x), {"attn": torch.stack(t1), "mlp": torch.stack(t2)}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=C.DTYPE,
                      device=None) -> dict:
    """Dense per-slot KV cache (L, B, max_len, KV, hd) and positions (B,)."""
    return C.init_kv_cache(cfg, batch, max_len, cfg.n_layers, dtype, resolve_device(device))


@torch.no_grad()
def prefill(params: DenseModel, cfg: ModelConfig, tokens: torch.Tensor, state: dict,
            patches=None, length=None, prefix=None):
    """Run the prompt, filling a copy of the cache. Returns (last_logits
    (B, 1, V), state). ``length`` (B,) marks the real prompt length when
    ``tokens`` is padded to a bucket: attention is causal, so the pad tail
    cannot perturb real positions, and logits / ``pos`` come from position
    ``length - 1``. ``state`` itself is left unchanged.

    ``patches`` (B, P, D) (the ``vlm`` family) are prepended to the prompt:
    the cache's first P rows hold them, and the real length seen through
    them is ``length + P`` (the reference's ``eff``).

    ``prefix`` = {"k": (L, B, m, KV, hd), "v": ...} is an already-cached
    post-RoPE prompt prefix (the engine's prefix cache, gathered from shared
    pages): ``tokens`` then holds only the suffix, every suffix query
    attends [prefix; causal suffix], positions start at m, the returned
    cache rows hold the suffix only (from row 0) and ``pos`` counts m too."""
    x = _embed(params, tokens, patches)
    # the patch rows prepended to the prompt are all real
    eff = None if length is None else (
        torch.as_tensor(length, device=x.device).reshape(-1) + (x.shape[1] - tokens.shape[1]))
    x, new_state = prefill_layers(params, cfg, x, state, _mlp, length=eff, prefix=prefix)
    return _unembed(params, cfg, C.select_at_length(x, eff)), new_state


@torch.no_grad()
def decode_step(params: DenseModel, cfg: ModelConfig, state: dict, tokens: torch.Tensor):
    """tokens (B, sq) -> (logits (B, sq, V), state). Each slot attends its own
    cache prefix; the new rows are written into ``state``'s caches (dense) or
    pools (paged, ``"bt"`` in state) in place after all layers ran, and
    ``state["pos"]`` advances by sq in place: the returned state is ``state``
    itself, its tensors the same objects, so a captured step reads and
    writes the same memory at every replay (:func:`decode_layers`).

    ``sq > 1`` stacks speculative draft rows (paged state only): the paged
    branch routes ``dispatch.paged_decode``, whose row i equals a one-row
    decode at ``pos + i`` once the earlier drafts are committed. The rmsnorms
    run one draft column at a time (``C.per_draft_row``): their mean over D
    gives some rows other bits at B * sq rows than at B. The linears are
    row-independent kernels, and the bf16 head gives every row the same bits
    stacked (``chip_smoke.py``'s speculative probe checks both)."""
    return decode_layers(params, cfg, state, tokens, _mlp)


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
    return ragged_layers(params, cfg, state, tokens, slot, pos, ctx, logit_idx, _mlp)


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameters of ``cfg``, as the reference counts them
    (the embedding once more for an untied head; equal for a dense model)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    mlp = 3 * d * f
    per_layer = attn + mlp + 2 * d
    emb = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    total = cfg.n_layers * per_layer + emb + d
    return total, total
