"""Bridge from the reference's parameter trees to the port's modules.

:func:`params_from_numpy` takes the JAX package's dense or OLMoE params as
a nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``) — bf16
weights, TwinQuant packs from ``quantize_params`` (W4A4 / W4A8), weight-only
packs (W4A16), fused packs from ``fuse_params``, or the simulation dicts of
``simulate_quantize_params`` — and builds the port's
:class:`~repro_torch.models.dense.DenseModel`, unstacking the ``(L, ...)``
layer axis into one module per layer. An MoE layer's experts stay stacked,
E leading: bf16 ``(E, K, N)`` weights become one
:class:`~repro_torch.models.common.ExpertLinear`, packs one expert-stacked
pack. :func:`calib_result_from_numpy` and
:func:`gl_params_from_numpy` carry a calibration's result and a ``GLParams``
across the same way. bf16 arrays are recognised by dtype name and moved bit for bit
through a 16-bit integer view, so no bf16 numpy extension is needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.core.calibration import CalibResult
from repro_torch.core.decomposition import Decomposition
from repro_torch.core.transforms import GLParams
from repro_torch.kernels.ref import TwinQuantGroupWeights, TwinQuantWeights
from repro_torch.models.common import (
    ExpertLinear,
    Linear,
    SimLinear,
    TwinQuantLinear,
    TwinQuantLinearGroup,
    W4A16Linear,
)
from repro_torch.models.dense import DenseLayer, DenseModel
from repro_torch.models.moe_layer import MoEFFN
from repro_torch.models.olmoe import OLMoELayer

__all__ = ["calib_result_from_numpy", "gl_params_from_numpy", "params_from_numpy", "to_torch"]


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
        return ExpertLinear(t("w")) if np.ndim(d["w"]) == 3 else Linear(t("w"), b)
    if "wp" in d:  # W4A16 weight-only pack; its group comes from the shapes
        return W4A16Linear(t("wp"), t("ws"), b)
    if "r_dq" in d:  # quantized-numerics simulation; a_bits is the abits length
        def opt(key):
            return t(key) if key in d else None

        return SimLinear(t("lam"), t("r_dq"), d["abits"].shape[-1], Q=opt("Q"),
                         u_dq=opt("u_dq"), v_dq=opt("v_dq"), b=b)
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


def _moe(mt: dict, dev) -> MoEFFN:
    experts = {k: _linear(v, dev) for k, v in mt.items() if k not in ("router", "shared")}
    shared = None
    if "shared" in mt:
        shared = {k: _linear(v, dev) for k, v in mt["shared"].items()}
    return MoEFFN(to_torch(mt["router"], dev), experts, shared)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> DenseModel:
    """The reference's dense or OLMoE params (numpy leaves, layers stacked
    on axis 0) as the port's model on ``device`` (the card unless asked
    otherwise)."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        lt = _layer_slice(tree["layers"], i)
        attn = {k: _linear(v, dev) for k, v in lt["attn"].items()}
        ln1, ln2 = to_torch(lt["ln1"], dev), to_torch(lt["ln2"], dev)
        if "moe" in lt:
            layers.append(OLMoELayer(attn, _moe(lt["moe"], dev), ln1, ln2))
        else:
            layers.append(DenseLayer(attn, {k: _linear(v, dev) for k, v in lt["mlp"].items()},
                                     ln1, ln2))
    head = _linear(tree["head"], dev) if "head" in tree else None
    return DenseModel(to_torch(tree["embed"], dev), layers, to_torch(tree["ln_f"], dev), head)


def gl_params_from_numpy(p, device=None) -> GLParams:
    """The reference's ``GLParams`` (any object with numpy-convertible ``P``,
    ``L``, ``gamma``) as the port's, on ``device``."""
    dev = resolve_device(device)
    return GLParams(P=to_torch(p.P, dev), L=to_torch(p.L, dev), gamma=to_torch(p.gamma, dev))


def calib_result_from_numpy(res, device=None) -> CalibResult:
    """The reference's ``CalibResult`` (numpy-convertible arrays) as the
    port's: Q, G, G_inv and the smoothed decomposition, on ``device``."""
    dev = resolve_device(device)
    d = res.decomp
    return CalibResult(
        Q=to_torch(res.Q, dev), G=to_torch(res.G, dev), G_inv=to_torch(res.G_inv, dev),
        decomp=Decomposition(U=to_torch(d.U, dev), V=to_torch(d.V, dev), R=to_torch(d.R, dev),
                             lam=to_torch(d.lam, dev)),
        loss_history=list(res.loss_history), final_loss=float(res.final_loss),
        init_loss=float(res.init_loss),
    )
