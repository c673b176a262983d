"""Bridge from the reference's parameter trees to the port's modules.

:func:`params_from_numpy` takes the JAX package's dense params as a nested
dict of numpy arrays (``jax.tree.map(np.asarray, params)``) — bf16 weights,
TwinQuant packs from ``quantize_params`` (W4A4 / W4A8), weight-only packs
(W4A16), or fused packs from ``fuse_params`` — and builds the port's
:class:`~repro_torch.models.dense.DenseModel`, unstacking the ``(L, ...)``
layer axis into one module per layer. bf16 arrays are recognised by dtype name and moved bit for bit
through a 16-bit integer view, so no bf16 numpy extension is needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.kernels.ref import TwinQuantGroupWeights, TwinQuantWeights
from repro_torch.models.common import Linear, TwinQuantLinear, TwinQuantLinearGroup, W4A16Linear
from repro_torch.models.dense import DenseLayer, DenseModel

__all__ = ["params_from_numpy", "to_torch"]


def to_torch(a, device) -> torch.Tensor:
    """numpy array -> tensor on ``device``, bf16 by dtype name."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _linear(d: dict, device) -> torch.nn.Module:
    def t(key):
        return to_torch(d[key], device)

    b = t("b") if "b" in d else None
    if "w" in d:
        return Linear(t("w"), b)
    if "wp" in d:  # W4A16 weight-only pack; its group comes from the shapes
        return W4A16Linear(t("wp"), t("ws"), b)
    a_bits = d["abits"].shape[-1]
    group = d["rp"].shape[-2] * 2 // d["rs"].shape[-2]
    if "vp" in d:
        rgroup = d["vp"].shape[-2] * 2 // d["vs"].shape[-2]
        return TwinQuantLinear(TwinQuantWeights(
            t("up"), t("us"), t("vp"), t("vs"), t("rp"), t("rs"), group, rgroup, a_bits), b)
    vps, vss = [], []
    while f"vp{len(vps)}" in d:
        vps.append(t(f"vp{len(vps)}"))
        vss.append(t(f"vs{len(vss)}"))
    rgroups = tuple(vp.shape[-2] * 2 // vs.shape[-2] for vp, vs in zip(vps, vss))
    return TwinQuantLinearGroup(TwinQuantGroupWeights(
        t("up"), t("us"), tuple(vps), tuple(vss), t("rp"), t("rs"), group, rgroups, a_bits), b)


def _layer_slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> DenseModel:
    """The reference's dense params (numpy leaves, layers stacked on axis 0)
    as the port's model on ``device`` (the card unless asked otherwise)."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        lt = _layer_slice(tree["layers"], i)
        layers.append(DenseLayer(
            {k: _linear(v, dev) for k, v in lt["attn"].items()},
            {k: _linear(v, dev) for k, v in lt["mlp"].items()},
            to_torch(lt["ln1"], dev), to_torch(lt["ln2"], dev),
        ))
    head = _linear(tree["head"], dev) if "head" in tree else None
    return DenseModel(to_torch(tree["embed"], dev), layers, to_torch(tree["ln_f"], dev), head)
