"""Mixture-of-Experts layer of the port: top-k routing and sort-based
capacity dispatch, all experts resident (the reference's local,
collective-free path of ``repro/models/moe_layer.py``; its expert-parallel
path waits for the multi-GPU slice).

An MoE block is a :class:`MoEFFN`: the f32 router (D, E), the experts as
one expert-stacked module per linear under ``experts`` (bf16
:class:`~repro_torch.models.common.ExpertLinear` or stacked TwinQuant packs,
``gate``/``up`` fused into ``gate_up`` by ``fuse_params``) and an optional
shared-expert MLP. With packs, each expert linear is ONE launch over all E
experts (the reference's vmap over its ``pallas_call``).

Everything on the step path keeps fixed shapes and makes no host sync, so a
decode, verify or ragged step captures as one CUDA graph: the capacity is a
Python int of the call's static token count, experts count their tokens with
``scatter_add_`` (``torch.bincount`` reads its input's maximum on the host),
ties in the top-k resolve to the lower expert index through a stable sort
(``torch.topk`` promises no order), and the combine adds each token's k
contributions one after another in bf16 in ascending expert order, as the
reference's ``out.at[tok_s].add`` does, instead of ``index_add_`` (whose CUDA
atomics sum in a different order from run to run).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.kernels.ref import _exact_matmuls
from repro_torch.models import common as C

__all__ = ["MoEFFN", "moe_init", "route", "moe_ffn", "record_drops"]

_drop_log: Optional[list] = None


def record_drops(log: Optional[list]) -> None:
    """Record capacity drops into ``log`` (None stops): every later MoE call
    run eagerly appends ``(T, capacity, dropped)``, its token rows, each
    expert's capacity and the assignments past it as a device scalar, so
    recording makes no host sync. A CUDA graph's replays append nothing."""
    global _drop_log
    _drop_log = log


class MoEFFN(nn.Module):
    """One MoE FFN: buffer ``router`` (D, E) f32, ``experts`` (``gate``,
    ``up``, ``down`` or ``gate_up``, ``down``, each stacked over E) and the
    optional ``shared`` MLP (``gate``, ``up``, ``down``)."""

    def __init__(self, router: torch.Tensor, experts: dict, shared: Optional[dict] = None):
        super().__init__()
        self.register_buffer("router", router)
        self.experts = nn.ModuleDict(experts)
        self.shared = None if shared is None else nn.ModuleDict(shared)


def moe_init(gen: torch.Generator, cfg: ModelConfig, device, d: Optional[int] = None) -> MoEFFN:
    """Random parameters with the reference's init: router N(0, 1/d) in f32,
    expert ``gate``/``up`` N(0, 1/d) and ``down`` N(0, 1/f) in bf16, from
    ``gen`` on ``device``."""
    d = d or cfg.d_model
    f, e = cfg.d_ff_expert, cfg.n_experts
    std = 1.0 / math.sqrt(d)
    router = torch.randn(d, e, generator=gen, device=device) * std
    experts = {
        "gate": C.ExpertLinear(C.init_normal(gen, (e, d, f), std, device)),
        "up": C.ExpertLinear(C.init_normal(gen, (e, d, f), std, device)),
        "down": C.ExpertLinear(C.init_normal(gen, (e, f, d), 1.0 / math.sqrt(f), device)),
    }
    shared = None
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        shared = {"gate": C.Linear(C.init_normal(gen, (d, fs), C.dense_std(d), device)),
                  "up": C.Linear(C.init_normal(gen, (d, fs), C.dense_std(d), device)),
                  "down": C.Linear(C.init_normal(gen, (fs, d), C.dense_std(fs), device))}
    return MoEFFN(router, experts, shared)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def router_logits(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 router logits ``x @ router_w`` (..., E), TF32 off."""
    _exact_matmuls()
    return (x.to(torch.float32) @ router_w).to(torch.float32)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
          logits: Optional[torch.Tensor] = None):
    """x (T, D) -> (top_w (T, k) f32, top_i (T, k) int64, aux_loss scalar).
    ``logits`` (T, E), when given, are the router's logits of x already."""
    if logits is None:
        logits = router_logits(router_w, x)
    probs = torch.softmax(logits, dim=-1)
    k = cfg.top_k
    # ties to the lower index, as jax.lax.top_k
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = vals[:, :k], idx[:, :k]
    norm = top_w[:, 0]
    for j in range(1, k):  # one fixed order whatever the row count
        norm = norm + top_w[:, j]
    top_w = top_w / torch.clamp(norm, min=1e-9)[:, None]
    # GShard/Switch load-balancing aux loss
    e = cfg.n_experts
    me = torch.mean(probs, dim=0)
    fe = torch.mean(torch.nn.functional.one_hot(top_i[:, 0], e).to(torch.float32), dim=0)
    aux = e * torch.sum(fe * me)
    return top_w, top_i, aux


def _dispatch_indices(top_i: torch.Tensor, k: int, E: int, C: int):
    """Sort-based capacity assignment. Returns (slot (T*k,), tok (T*k,),
    order (T*k,), keep (T*k,)): the assignments sorted by expert (stable),
    each one's buffer row (E*C for one past its expert's capacity), token
    and whether it is kept."""
    fe = top_i.reshape(-1).to(torch.long)
    order = torch.sort(fe, stable=True).indices
    fe_s = fe[order]
    tok_s = order // k
    counts = torch.zeros(E, dtype=torch.long, device=fe.device).scatter_add_(
        0, fe_s, torch.ones_like(fe_s))
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(fe_s.shape[0], device=fe.device) - starts[fe_s]
    keep = pos < C
    slot = torch.where(keep, fe_s * C + pos, torch.full_like(pos, E * C))
    return slot, tok_s, order, keep


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


# ---------------------------------------------------------------------------
# local (collective-free) path
# ---------------------------------------------------------------------------


def _moe_local(p: MoEFFN, x: torch.Tensor, cfg: ModelConfig,
               logits: Optional[torch.Tensor] = None):
    t, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    Cp = _capacity(t, cfg)
    top_w, top_i, aux = route(p.router, x, cfg, logits)
    slot, tok_s, order, keep = _dispatch_indices(top_i, k, E, Cp)
    if _drop_log is not None:
        _drop_log.append((t, Cp, (~keep).sum()))
    buf = torch.zeros((E * Cp + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[tok_s]  # dropped assignments all land on the scratch row
    # the reference's _expert_ffn: (E, Cp, D) through the stacked experts,
    # bf16 or packed (gate/up one fused launch)
    yb = C.mlp_apply(p.experts, buf[:E * Cp].reshape(E, Cp, d))
    yb = torch.cat([yb.reshape(E * Cp, d), torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    w_s = top_w.reshape(-1)[order].to(x.dtype)
    contrib = yb[slot] * (w_s * keep.to(x.dtype))[:, None]
    # each token's k contributions in ascending expert order (their order in
    # the stable sort), added one after another in bf16 from zero
    n = order.shape[0]
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=x.device))
    asc = torch.sort(top_i, dim=1).indices  # a token's experts are distinct
    rows = inv[torch.arange(t, device=x.device)[:, None] * k + asc]  # (T, k)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + contrib[rows[:, j]]
    return out, aux


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def moe_ffn(p: MoEFFN, x: torch.Tensor, cfg: ModelConfig, *, per_draft_row: bool = False):
    """x (B, S, D) -> (B, S, D), aux_loss, on the local path; adds the
    shared-expert branch if present. ``per_draft_row`` (a decode step's
    speculative stack, S = sq) takes the router's f32 logits one draft
    column (B, D) at a time, so a stacked row routes on the bits of a plain
    decode step (``common.per_draft_row``); everything else in the layer is
    row-independent."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    logits = None
    if per_draft_row and s > 1:
        logits = C.per_draft_row(lambda y: router_logits(p.router, y), x).reshape(b * s, -1)
    out, aux = _moe_local(p, xf, cfg, logits)
    if p.shared is not None:
        out = out + C.mlp_apply(p.shared, xf)
    return out.reshape(b, s, d), aux
