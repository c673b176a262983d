"""Model-level TwinQuant for serving: rewrite a model into packed form.

* :func:`quantize_params` replaces every eligible bf16 linear with a
  :class:`~repro_torch.models.common.TwinQuantLinear` (W4A4 / W4A8: SVD
  split, sqrt-balanced, 4-bit packs) or a
  :class:`~repro_torch.models.common.W4A16Linear` (W4A16: group-wise RTN
  int4 weights, bf16 activations), looping over the decoder layers where
  the reference vmaps over its stacked layer axis. An MoE layer's
  :class:`~repro_torch.models.common.ExpertLinear` (E, K, N) becomes one
  expert-stacked pack, as the reference's vmap over the stacked expert
  axis: batched SVDs over chunks of experts (W4A4 / W4A8; ``EXPERT_CHUNK_
  BYTES`` of f32 each, so DeepSeek-V3's 256 experts fit beside the model),
  or the group-wise RTN of a chunk at once (W4A16; elementwise and a max
  per group, so each expert's slice is its pack made alone, bit for bit).
* :func:`fuse_params` merges sibling packs that consume the same activation
  (q/k/v -> ``qkv``, gate/up -> ``gate_up``) into one
  :class:`~repro_torch.models.common.TwinQuantLinearGroup`, which
  ``models.common.linear_group`` runs as ONE kernel launch. W4A16 packs are
  never fused, as in the reference.
* :func:`with_activation_bits` gives a TwinQuant model the other activation
  width: the packs do not depend on ``a_bits`` (H is requantized at run
  time), so W4A8 is the W4A4 packs with ``a_bits = 8``, bit for bit what
  ``quantize_params`` gives for ``w4a8``, without a second pass of SVDs.

* :func:`simulate_quantize_params` — the **evaluation** path: eligible
  linears become :class:`~repro_torch.models.common.SimLinear` modules that
  reproduce exact W4A4 / W4A8 TwinQuant numerics (online smoothing and
  rotation, activation and H fake-quant) with plain matmuls over
  dequantized components, under four methods: ``naive`` (RTN, no
  decomposition), ``lowrank`` (SVD, both factors 4-bit), ``hadamard`` (SVD +
  fixed rotation) and ``twinquant`` (Q and G learned per linear by
  :func:`~repro_torch.core.calibration.calibrate_layer`). The accuracy
  comparisons of the paper's ablation run on this path.

The rewriters return a new model and leave their input untouched; tensors
that do not change are shared, not copied. Exclusions (kept bf16, the
reference's ``EXCLUDE``): embeddings, the lm head, MoE routers, MLA's
``wkv_b`` (an einsum operand of the absorbed decode) and DeepSeek's
``mtp/proj``.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.calibration import CalibConfig, calibrate_layer
from repro_torch.core.decomposition import svd_decompose
from repro_torch.core.quantization import QuantConfig, dequantize, quantize
from repro_torch.core.transforms import hadamard_matrix
from repro_torch.kernels.ref import (
    fuse_twinquant_weights,
    pack_rows_groupsplit,
    pack_twinquant_weights,
    quantize_rows_ref,
)
from repro_torch.models.common import (
    ExpertLinear,
    Linear,
    SimLinear,
    TwinQuantLinear,
    TwinQuantLinearGroup,
    W4A16Linear,
)

__all__ = ["EXCLUDE", "FUSE_GROUPS", "quantize_params", "fuse_linear_packs", "fuse_params",
           "with_activation_bits", "build_sim_linear", "simulate_quantize_params"]

# the leaf modules the rewriters never descend into
_LEAVES = (ExpertLinear, Linear, SimLinear, TwinQuantLinear, TwinQuantLinearGroup, W4A16Linear)

EXCLUDE = re.compile(r"(embed|head|router|wkv_b|mtp/proj)")

# (sibling keys, fused key, parent keys that may fuse them — None = any)
FUSE_GROUPS = (
    (("q", "k", "v"), "qkv", ("attn",)),
    (("gate", "up"), "gate_up", None),
    (("wq_a", "wkv_a"), "wqkv_a", None),
)


def _eligible(path_str: str, w: torch.Tensor) -> bool:
    if EXCLUDE.search(path_str) or w.ndim < 2:
        return False
    k, n = w.shape[-2], w.shape[-1]
    return k % 256 == 0 and n % 2 == 0 and k >= 256


# f32 bytes of one chunk of an expert stack packed at once: DeepSeek-V3's
# (256, 7168, 2048) stack is 15 GB in f32, and its SVD's u and the residual
# as much again, so the experts are packed a chunk at a time (36 of them)
EXPERT_CHUNK_BYTES = 2 << 30


def _expert_chunks(w: torch.Tensor):
    """``w`` (K, N) whole, or an expert stack (E, K, N) in slices of
    ``EXPERT_CHUNK_BYTES`` of f32, each in f32."""
    if w.ndim == 2:
        yield w.to(torch.float32)
        return
    c = max(1, EXPERT_CHUNK_BYTES // (w.shape[-2] * w.shape[-1] * 4))
    for i in range(0, w.shape[0], c):
        yield w[i:i + c].to(torch.float32)


def _cat(ts: list) -> torch.Tensor:
    return ts[0] if len(ts) == 1 else torch.cat(ts)


def _cat_experts(parts: list):
    """Chunk packs (a dataclass of tensors) concatenated along the expert
    axis; a single part as it is."""
    if len(parts) == 1:
        return parts[0]
    tensors = {f.name: _cat([getattr(p, f.name) for p in parts])
               for f in dataclasses.fields(parts[0])
               if isinstance(getattr(parts[0], f.name), torch.Tensor)}
    return dataclasses.replace(parts[0], **tensors)


def _pack_one(lin, spec: QuantSpec) -> TwinQuantLinear:
    """bf16 linear -> TwinQuant pack (SVD split, sqrt-balanced); an
    :class:`ExpertLinear` -> an expert-stacked pack, a chunk of experts at
    a time (one batched SVD each; every expert's pack is the one it gets
    in a single batch)."""
    k, n = lin.w.shape[-2:]
    r = min(spec.rank, k // 2, n)
    r = max(2, r // 2 * 2)
    tq = _cat_experts([
        pack_twinquant_weights(*svd_decompose(w, r), a_bits=spec.a_bits,
                               group=min(spec.group_size, k))
        for w in _expert_chunks(lin.w)])
    return TwinQuantLinear(tq, lin.b)


def _pack_one_w4a16(lin, spec: QuantSpec) -> W4A16Linear:
    """bf16 linear -> weight-only pack (group-wise RTN int4, group-split); an
    :class:`ExpertLinear` (E, K, N) -> an expert-stacked pack (``wp`` (E,
    K/2, N), ``ws`` (E, K/G, N)), a chunk of experts at a time."""
    g = min(spec.group_size, lin.w.shape[-2])
    wps, wss = [], []
    for w in _expert_chunks(lin.w):
        wq, ws = quantize_rows_ref(w, g, 4)
        wps.append(pack_rows_groupsplit(wq, g))
        wss.append(ws)
    return W4A16Linear(_cat(wps), _cat(wss), lin.b)


def _rebuild(mod: nn.Module, children: dict) -> nn.Module:
    """A shallow copy of ``mod`` with new children; buffers are shared."""
    new = copy.copy(mod)
    new._modules = children
    new._buffers = dict(mod._buffers)
    new._parameters = dict(mod._parameters)
    return new


@torch.no_grad()
def quantize_params(params: nn.Module, cfg: ModelConfig, spec: QuantSpec) -> nn.Module:
    """Rewrite eligible linears into packed quantized form (values via
    RTN-SVD). ``bf16`` returns the model unchanged."""
    if spec.mode == "bf16":
        return params
    if spec.mode not in ("w4a16", "w4a8", "w4a4"):
        raise ValueError(f"unknown quant mode {spec.mode!r}")
    pack_one = _pack_one_w4a16 if spec.mode == "w4a16" else _pack_one

    def visit(mod: nn.Module, path: str) -> nn.Module:
        if isinstance(mod, (Linear, ExpertLinear)):
            if not _eligible(path + "/w", mod.w):
                return mod
            return pack_one(mod, spec)
        if isinstance(mod, _LEAVES):
            return mod
        return _rebuild(mod, {k: None if v is None else visit(v, f"{path}/{k}")
                              for k, v in mod._modules.items()})

    return visit(params, "")


def _packs_fusable(packs: list) -> bool:
    if not all(isinstance(p, TwinQuantLinear) for p in packs):
        return False
    base = packs[0]
    return all(p.rp.shape[:-1] == base.rp.shape[:-1] and p.group == base.group
               and p.a_bits == base.a_bits for p in packs)


def fuse_linear_packs(packs: list) -> TwinQuantLinearGroup:
    """Merge sibling packs into one fused group (pure concatenation; biases
    concatenate into one ``b``, zeros standing in for missing ones)."""
    gw = fuse_twinquant_weights([p.weights() for p in packs])
    b = None
    if any(p.b is not None for p in packs):
        b = torch.cat([
            p.b.to(torch.float32) if p.b is not None
            else torch.zeros(p.rp.shape[:-2] + p.rp.shape[-1:], dtype=torch.float32,
                             device=p.rp.device)
            for p in packs
        ], dim=-1)
    return TwinQuantLinearGroup(gw, b)


@torch.no_grad()
def fuse_params(params: nn.Module) -> nn.Module:
    """Merge sibling quantized packs that share an input into fused groups:
    ``attn/{q,k,v}`` -> ``attn/qkv``, ``{gate,up}`` -> ``gate_up`` under
    any parent (``mlp``, an MoE layer's stacked ``experts``) and MLA's
    ``{wq_a,wkv_a}`` -> ``wqkv_a``. Non-pack
    siblings (bf16, partially quantized groups) stay as they are."""

    def visit(mod: nn.Module, key: str) -> nn.Module:
        if isinstance(mod, _LEAVES):
            return mod
        children = {k: None if v is None else visit(v, k) for k, v in mod._modules.items()}
        if isinstance(mod, nn.ModuleDict):
            for names, fused_key, parents in FUSE_GROUPS:
                if parents is not None and key not in parents:
                    continue
                if all(n in children for n in names) and _packs_fusable(
                        [children[n] for n in names]):
                    children[fused_key] = fuse_linear_packs([children.pop(n) for n in names])
        return _rebuild(mod, children)

    return visit(params, "")


@torch.no_grad()
def with_activation_bits(params: nn.Module, a_bits: int) -> nn.Module:
    """The same TwinQuant model with activations (and H) quantized at
    ``a_bits``: every pack keeps its tensors (shared, not copied) and takes
    the new width. bf16 and W4A16 linears are left as they are."""

    def visit(mod: nn.Module) -> nn.Module:
        if isinstance(mod, (TwinQuantLinear, TwinQuantLinearGroup)):
            new = _rebuild(mod, {})
            new.a_bits = a_bits
            return new
        if isinstance(mod, _LEAVES):
            return mod
        return _rebuild(mod, {k: None if v is None else visit(v)
                              for k, v in mod._modules.items()})

    return visit(params)


# ---------------------------------------------------------------------------
# evaluation path: exact-numerics simulation modules
# ---------------------------------------------------------------------------

CALIB_SAMPLES = 256  # rows of the seeded stand-in calibration set


@torch.no_grad()
def build_sim_linear(w: torch.Tensor, method: str, spec: QuantSpec,
                     calib_x: Optional[torch.Tensor] = None,
                     calib_cfg: Optional[CalibConfig] = None, device=None) -> SimLinear:
    """2-D weight (K, N) -> :class:`SimLinear` for exact quantized-numerics
    evaluation, on ``device`` (the card unless asked otherwise).

    method: 'naive' (RTN, no decomposition) | 'lowrank' (SVD, both 4-bit) |
            'hadamard' (SVD + fixed rotation) | 'twinquant' (learned Q, G).
    ``calib_x`` (samples, K) feeds the calibration; a tap of another width
    (the down projection's input is d_ff wide) is ignored, and without one
    twinquant calibrates on ``CALIB_SAMPLES`` normal rows drawn from a
    generator seeded 0 on the device."""
    dev = resolve_device(device)
    k, n = w.shape
    w = w.to(device=dev, dtype=torch.float32)
    if calib_x is not None and calib_x.shape[-1] != k:
        calib_x = None  # tap dim mismatch (e.g. down-proj input is d_ff-dim)
    r = max(2, min(spec.rank, k // 2, n) // 2 * 2)
    g = min(spec.group_size, k)
    wq = QuantConfig(bits=4, group_size=g, axis=0)
    vq = QuantConfig(bits=4, group_size=min(spec.group_size, r), axis=0)

    def dq(t, c):
        return dequantize(quantize(t, c), dtype=torch.float32).to(torch.bfloat16)

    lam = torch.ones((k,), dtype=torch.float32, device=dev)
    if method == "naive":
        return SimLinear(lam, dq(w, wq), spec.a_bits)
    Q = None
    if method == "twinquant":
        cc = calib_cfg or CalibConfig(rank=r, a_bits=spec.a_bits, group_size=g,
                                      steps_global=40, steps_invert=40, steps_joint=20)
        cc = cc if cc.rank == r else dataclasses.replace(cc, rank=r)
        if calib_x is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            calib_x = torch.randn(CALIB_SAMPLES, k, generator=gen, device=dev)
        res = calibrate_layer(calib_x, w, cc, device=dev)
        lam = res.decomp.lam
        U2 = res.Q.T @ res.decomp.U @ res.G
        V2 = res.G_inv @ res.decomp.V
        R2 = res.Q.T @ res.decomp.R
        Q = res.Q
    elif method in ("lowrank", "hadamard"):
        U, V, R = svd_decompose(w, r)
        if method == "hadamard":
            Q = hadamard_matrix(k, device=dev)
            U2, V2, R2 = Q.T @ U, V, Q.T @ R
        else:
            U2, V2, R2 = U, V, R
    else:
        raise ValueError(f"unknown simulation method {method!r}")
    return SimLinear(lam, dq(R2, wq), spec.a_bits,
                     Q=None if Q is None else Q.to(torch.bfloat16),
                     u_dq=dq(U2, wq), v_dq=dq(V2, vq))


_LAYER = re.compile(r"/layers/(\d+)/")


def simulate_quantize_params(params: nn.Module, cfg: ModelConfig, spec: QuantSpec, method: str,
                             calib_taps: Optional[dict] = None,
                             calib_cfg: Optional[CalibConfig] = None, device=None) -> nn.Module:
    """Rewrite eligible linears into :class:`SimLinear` modules (on
    ``device``, the card unless asked otherwise), one decoder layer at a
    time. ``calib_taps``: optional ``{path substring: activations}`` map of
    real calibration data, e.g. :func:`~repro_torch.models.dense.
    forward_with_taps`' ``{"attn": (L, T, D), "mlp": (L, T, D)}``; the first
    key found in a linear's path names its tap, and a (L, T, K) tap gives
    layer i its row block i."""
    dev = resolve_device(device)
    n_layers = len(params.layers)

    def tap_for(path: str):
        for key, acts in (calib_taps or {}).items():
            if key in path:
                hit = _LAYER.search(path)
                if acts.ndim == 3 and hit and acts.shape[0] == n_layers:
                    return acts[int(hit.group(1))]
                return acts
        return None

    def visit(mod: nn.Module, path: str) -> nn.Module:
        if isinstance(mod, Linear):
            if not _eligible(path + "/w", mod.w):
                return mod
            sim = build_sim_linear(mod.w, method, spec, tap_for(path), calib_cfg, device=dev)
            sim.b = mod.b
            return sim
        if isinstance(mod, _LEAVES):
            return mod
        return _rebuild(mod, {k: None if v is None else visit(v, f"{path}/{k}")
                              for k, v in mod._modules.items()})

    return visit(params, "")
