"""Model-level TwinQuant for serving: rewrite a model into packed form.

* :func:`quantize_params` replaces every eligible bf16 linear with a
  :class:`~repro_torch.models.common.TwinQuantLinear` (W4A4 / W4A8: SVD
  split, sqrt-balanced, 4-bit packs) or a
  :class:`~repro_torch.models.common.W4A16Linear` (W4A16: group-wise RTN
  int4 weights, bf16 activations), looping over the decoder layers where
  the reference vmaps over its stacked layer axis.
* :func:`fuse_params` merges sibling packs that consume the same activation
  (q/k/v -> ``qkv``, gate/up -> ``gate_up``) into one
  :class:`~repro_torch.models.common.TwinQuantLinearGroup`, which
  ``models.common.linear_group`` runs as ONE kernel launch. W4A16 packs are
  never fused, as in the reference.
* :func:`with_activation_bits` gives a TwinQuant model the other activation
  width: the packs do not depend on ``a_bits`` (H is requantized at run
  time), so W4A8 is the W4A4 packs with ``a_bits = 8``, bit for bit what
  ``quantize_params`` gives for ``w4a8``, without a second pass of SVDs.

Both return a new model and leave their input untouched; tensors that do not
change are shared, not copied. Exclusions (kept bf16): embeddings and the lm
head. Calibration and the simulation path wait for a later slice.
"""

from __future__ import annotations

import copy
import re

import torch
from torch import nn

from repro_torch.configs import ModelConfig, QuantSpec
from repro_torch.core.decomposition import svd_decompose
from repro_torch.kernels.ref import (
    fuse_twinquant_weights,
    pack_rows_groupsplit,
    pack_twinquant_weights,
    quantize_rows_ref,
)
from repro_torch.models.common import Linear, TwinQuantLinear, TwinQuantLinearGroup, W4A16Linear

__all__ = ["EXCLUDE", "FUSE_GROUPS", "quantize_params", "fuse_linear_packs", "fuse_params",
           "with_activation_bits"]

# the leaf modules the rewriters never descend into
_LEAVES = (Linear, TwinQuantLinear, TwinQuantLinearGroup, W4A16Linear)

EXCLUDE = re.compile(r"(embed|head|router|wkv_b|mtp/proj)")

# (sibling keys, fused key, parent keys that may fuse them — None = any)
FUSE_GROUPS = (
    (("q", "k", "v"), "qkv", ("attn",)),
    (("gate", "up"), "gate_up", None),
)


def _eligible(path_str: str, w: torch.Tensor) -> bool:
    if EXCLUDE.search(path_str) or w.ndim < 2:
        return False
    k, n = w.shape[-2], w.shape[-1]
    return k % 256 == 0 and n % 2 == 0 and k >= 256


def _pack_one(lin: Linear, spec: QuantSpec) -> TwinQuantLinear:
    """bf16 linear -> TwinQuant pack (SVD split, sqrt-balanced)."""
    k, n = lin.w.shape
    r = min(spec.rank, k // 2, n)
    r = max(2, r // 2 * 2)
    U, V, R = svd_decompose(lin.w.to(torch.float32), r)
    tq = pack_twinquant_weights(U, V, R, a_bits=spec.a_bits, group=min(spec.group_size, k))
    return TwinQuantLinear(tq, lin.b)


def _pack_one_w4a16(lin: Linear, spec: QuantSpec) -> W4A16Linear:
    """bf16 linear -> weight-only pack (group-wise RTN int4, group-split)."""
    k = lin.w.shape[0]
    g = min(spec.group_size, k)
    wq, ws = quantize_rows_ref(lin.w.to(torch.float32), g, 4)
    return W4A16Linear(pack_rows_groupsplit(wq, g), ws, lin.b)


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
        if isinstance(mod, Linear):
            return pack_one(mod, spec) if _eligible(path + "/w", mod.w) else mod
        if isinstance(mod, _LEAVES):
            return mod
        return _rebuild(mod, {k: None if v is None else visit(v, f"{path}/{k}")
                              for k, v in mod._modules.items()})

    return visit(params, "")


def _packs_fusable(packs: list) -> bool:
    if not all(isinstance(p, TwinQuantLinear) for p in packs):
        return False
    base = packs[0]
    return all(p.rp.shape[0] == base.rp.shape[0] and p.group == base.group
               and p.a_bits == base.a_bits for p in packs)


def fuse_linear_packs(packs: list) -> TwinQuantLinearGroup:
    """Merge sibling packs into one fused group (pure concatenation; biases
    concatenate into one ``b``, zeros standing in for missing ones)."""
    gw = fuse_twinquant_weights([p.weights() for p in packs])
    b = None
    if any(p.b is not None for p in packs):
        b = torch.cat([
            p.b.to(torch.float32) if p.b is not None
            else torch.zeros(p.rp.shape[-1], dtype=torch.float32, device=p.rp.device)
            for p in packs
        ])
    return TwinQuantLinearGroup(gw, b)


@torch.no_grad()
def fuse_params(params: nn.Module) -> nn.Module:
    """Merge sibling quantized packs that share an input into fused groups:
    ``attn/{q,k,v}`` -> ``attn/qkv`` and ``mlp/{gate,up}`` -> ``mlp/gate_up``.
    Non-pack siblings (bf16, partially quantized groups) stay as they are."""

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
