"""Bridge from the reference's parameter trees to the port's modules.

:func:`params_from_numpy` takes the JAX package's dense, OLMoE or DeepSeek
params as a nested dict of numpy arrays (``jax.tree.map(np.asarray,
params)``) — bf16
weights, TwinQuant packs from ``quantize_params`` (W4A4 / W4A8), weight-only
packs (W4A16), fused packs from ``fuse_params``, or the simulation dicts of
``simulate_quantize_params`` — and builds the port's
:class:`~repro_torch.models.dense.DenseModel`, unstacking the ``(L, ...)``
layer axis into one module per layer. An MoE layer's experts stay stacked,
E leading: bf16 ``(E, K, N)`` weights become one
:class:`~repro_torch.models.common.ExpertLinear`, TwinQuant packs one
expert-stacked pack and weight-only packs (``wp`` (E, K/2, N), ``ws`` (E,
K/G, N)) one expert-stacked :class:`~repro_torch.models.common.W4A16Linear`.
A ``vlm`` model's tree is its dense backbone's. A DeepSeek tree's
``dense_layers`` and ``moe_layers`` become one ``layers`` list (dense first)
of :class:`~repro_torch.models.deepseek.MLALayer`, and its ``mtp`` block an
:class:`~repro_torch.models.deepseek.MTP`. A Whisper tree (``enc_layers``,
``dec_layers``, ``ln_enc``; LayerNorms ``{w, b}``) becomes an
:class:`~repro_torch.models.encdec.EncDecModel`; a Zamba2 tree (``m_layers``
stacked ``(n_seg, every, ...)``, ``shared``, ``adapters``,
``rest_layers``; f32 ``A_log`` / ``D`` / ``dt_bias``) a
:class:`~repro_torch.models.mamba_hybrid.HybridModel`, both stacked axes
unstacked; an xLSTM tree (``m_layers`` stacked ``(n_seg, m_per, ...)`` and
``s_layers`` ``(n_seg, ...)``, or ``m_layers`` ``(n_layers, ...)`` alone)
an :class:`~repro_torch.models.xlstm.XLSTMModel`. :func:`params_to_numpy` is the
inverse for the bf16 models of every family (the trained weights go back
to the reference's stacked tree): :func:`reference_leaf` names the
reference leaf and the stacked index each of the port's tensors lands in,
and :func:`port_spec` carries a partition spec across the same way.
:func:`calib_result_from_numpy` and
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
from repro_torch.models.deepseek import MTP, DeepSeekModel, MLALayer
from repro_torch.models.dense import DenseLayer, DenseModel
from repro_torch.models.encdec import DecLayer, EncDecModel, EncLayer, LayerNorm
from repro_torch.models.mamba_hybrid import HybridModel, MambaBlock, SharedBlock
from repro_torch.models.mla import MLAAttention
from repro_torch.models.moe_layer import MoEFFN
from repro_torch.models.olmoe import OLMoELayer
from repro_torch.models.xlstm import MLSTMBlock, SLSTMBlock, XLSTMModel

__all__ = ["calib_result_from_numpy", "gl_params_from_numpy", "named_tensors",
           "params_from_numpy", "params_to_numpy", "port_spec", "reference_leaf",
           "reference_ndim", "to_torch"]


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


def _mla_layer(lt: dict, dev) -> MLALayer:
    """One MLA layer of the reference's tree (``attn`` with its norms, and
    ``mlp`` or ``moe``)."""
    at = lt["attn"]
    attn = MLAAttention({k: _linear(v, dev) for k, v in at.items() if isinstance(v, dict)},
                        to_torch(at["q_norm"], dev), to_torch(at["kv_norm"], dev))
    ln1, ln2 = to_torch(lt["ln1"], dev), to_torch(lt["ln2"], dev)
    if "moe" in lt:
        return MLALayer(attn, ln1, ln2, moe=_moe(lt["moe"], dev))
    return MLALayer(attn, ln1, ln2, mlp={k: _linear(v, dev) for k, v in lt["mlp"].items()})


def _deepseek(tree: dict, cfg: ModelConfig, dev) -> DeepSeekModel:
    """The reference's DeepSeek tree: ``dense_layers`` and ``moe_layers``
    stacked apart (dense first in ``layers``), ``mtp`` unstacked."""
    nd = cfg.first_k_dense
    layers = [_mla_layer(_layer_slice(tree["dense_layers"], i), dev) for i in range(nd)]
    layers += [_mla_layer(_layer_slice(tree["moe_layers"], i), dev)
               for i in range(cfg.n_layers - nd)]
    mtp = None
    if "mtp" in tree:
        mt = tree["mtp"]
        mtp = MTP(_linear(mt["proj"], dev), _mla_layer(mt["layer"], dev),
                  to_torch(mt["ln_in"], dev))
    return DeepSeekModel(to_torch(tree["embed"], dev), layers, to_torch(tree["ln_f"], dev),
                         _linear(tree["head"], dev), mtp)


def _ln(t: dict, dev) -> LayerNorm:
    return LayerNorm(to_torch(t["w"], dev), to_torch(t["b"], dev))


def _linears(t: dict, dev) -> dict:
    return {k: _linear(v, dev) for k, v in t.items()}


def _whisper(tree: dict, cfg: ModelConfig, dev) -> EncDecModel:
    """The reference's Whisper tree: ``enc_layers`` and ``dec_layers``
    unstacked, LayerNorms ``{w, b}``."""
    enc = []
    for i in range(cfg.n_enc_layers):
        lt = _layer_slice(tree["enc_layers"], i)
        enc.append(EncLayer(_linears(lt["attn"], dev), _linears(lt["mlp"], dev),
                            _ln(lt["ln1"], dev), _ln(lt["ln2"], dev)))
    dec = []
    for i in range(cfg.n_layers):
        lt = _layer_slice(tree["dec_layers"], i)
        dec.append(DecLayer(_linears(lt["attn"], dev), _linears(lt["xattn"], dev),
                            _linears(lt["mlp"], dev), _ln(lt["ln1"], dev), _ln(lt["ln2"], dev),
                            _ln(lt["ln3"], dev)))
    return EncDecModel(to_torch(tree["embed"], dev), enc, dec, _ln(tree["ln_enc"], dev),
                       _ln(tree["ln_f"], dev))


def _mamba(t: dict, dev) -> MambaBlock:
    return MambaBlock(_linear(t["in_proj"], dev), _linear(t["out_proj"], dev),
                      *(to_torch(t[k], dev) for k in ("ln", "conv", "A_log", "D", "dt_bias",
                                                       "gn")))


def _zamba(tree: dict, cfg: ModelConfig, dev) -> HybridModel:
    """The reference's Zamba2 tree: ``m_layers`` (n_seg, every, ...),
    ``adapters`` and ``rest_layers`` unstacked."""
    ml = tree["m_layers"]
    embed, ln_f, head = (to_torch(tree["embed"], dev), to_torch(tree["ln_f"], dev),
                         _linear(tree["head"], dev))
    n_seg, every = np.shape(ml["A_log"])[:2]
    m_layers = [[_mamba(_layer_slice(_layer_slice(ml, s), j), dev) for j in range(every)]
                for s in range(n_seg)]
    st = tree["shared"]
    shared = SharedBlock({k: _linear(v, dev) for k, v in st.items() if k not in
                          ("ln1", "ln2", "mlp")}, _linears(st["mlp"], dev),
                         to_torch(st["ln1"], dev), to_torch(st["ln2"], dev))
    adapters = [_linear(_layer_slice(tree["adapters"], s), dev) for s in range(n_seg)]
    rest = None
    if "rest_layers" in tree:
        rl = tree["rest_layers"]
        rest = [_mamba(_layer_slice(rl, i), dev) for i in range(np.shape(rl["A_log"])[0])]
    return HybridModel(embed, m_layers, ln_f, head, shared, adapters, rest)


def _mlstm(t: dict, dev) -> MLSTMBlock:
    return MLSTMBlock({k: _linear(t[k], dev) for k in ("up", "wq", "wk", "wv", "wif", "down")},
                      *(to_torch(t[k], dev) for k in ("ln", "conv", "gn")))


def _xlstm(tree: dict, dev) -> XLSTMModel:
    """The reference's xLSTM tree: ``m_layers`` (n_seg, m_per, ...) and
    ``s_layers`` (n_seg, ...) unstacked, or ``m_layers`` (n_layers, ...)
    alone when the config has no sLSTM block."""
    ml = tree["m_layers"]
    embed, ln_f, head = (to_torch(tree["embed"], dev), to_torch(tree["ln_f"], dev),
                         _linear(tree["head"], dev))
    if "s_layers" not in tree:
        m_layers = [_mlstm(_layer_slice(ml, i), dev) for i in range(np.shape(ml["ln"])[0])]
        return XLSTMModel(embed, m_layers, None, ln_f, head)
    n_seg, m_per = np.shape(ml["ln"])[:2]
    m_layers = [[_mlstm(_layer_slice(_layer_slice(ml, s), j), dev) for j in range(m_per)]
                for s in range(n_seg)]
    s_layers = []
    for s in range(n_seg):
        st = _layer_slice(tree["s_layers"], s)
        s_layers.append(SLSTMBlock(_linear(st["w"], dev), _linears(st["ffn"], dev),
                                   *(to_torch(st[k], dev) for k in ("ln", "r", "gn", "ln2"))))
    return XLSTMModel(embed, m_layers, s_layers, ln_f, head)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> DenseModel:
    """The reference's dense, OLMoE, DeepSeek, Whisper, xLSTM or Zamba2
    params (numpy leaves, layers stacked on the leading axes) as the port's
    model on ``device`` (the card unless asked otherwise)."""
    dev = resolve_device(device)
    if cfg.family == "xlstm":
        return _xlstm(tree, dev)
    if "dense_layers" in tree:
        return _deepseek(tree, cfg, dev)
    if "enc_layers" in tree:
        return _whisper(tree, cfg, dev)
    if "m_layers" in tree:
        return _zamba(tree, cfg, dev)
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


def named_tensors(params) -> dict:
    """``{name: tensor}``: a model's floating-point parameters and buffers by
    their dotted names (or a dict of them, as it is)."""
    if not isinstance(params, torch.nn.Module):
        return dict(params)
    named = dict(params.named_parameters())
    named.update((n, t) for n, t in params.named_buffers() if t.is_floating_point())
    return named


def reference_leaf(name: str, cfg: ModelConfig = None) -> tuple:
    """(path, index) of the port's tensor ``name`` in the reference's tree:
    the path of keys down to the leaf, and the index of this tensor along
    the leaf's leading stacked axes. Each number in the dotted name is one
    stacked axis of the reference (``layers.3.ln1`` is row 3 of
    ``layers/ln1`` (L, d); Zamba2's and xLSTM's ``m_layers.1.2`` is row (1,
    2) of (n_seg, every, ...)); an MoE block's ``experts`` are the block's
    own keys there; DeepSeek-V3's ``layers`` are ``dense_layers`` then
    ``moe_layers`` (``cfg`` says where the split is)."""
    parts = name.split(".")
    idx = tuple(int(p) for p in parts if p.isdigit())
    path = [p for i, p in enumerate(parts)
            if not p.isdigit() and not (p == "experts" and parts[i - 1] == "moe")]
    if cfg is not None and cfg.family == "mla_moe" and path[0] == "layers":
        nd = cfg.first_k_dense
        path[0] = "dense_layers" if idx[0] < nd else "moe_layers"
        idx = (idx[0] - (0 if idx[0] < nd else nd),) + idx[1:]
    return tuple(path), idx


def port_spec(spec, name: str, cfg: ModelConfig = None) -> tuple:
    """A partition spec of the reference leaf that the port's tensor
    ``name`` lands in (a ``PartitionSpec`` or any sequence of its entries)
    as the port tensor's own: the entries of the leaf's leading stacked
    axes dropped. Raises when one of them shards (the port has no such
    axis)."""
    n = len(reference_leaf(name, cfg)[1])
    entries = tuple(spec)
    if any(e is not None for e in entries[:n]):
        raise ValueError(f"{name}: the spec {entries} shards a stacked axis of its reference leaf")
    return entries[n:]


def reference_ndim(name: str, t: torch.Tensor) -> int:
    """ndim of the reference leaf the port's tensor ``name`` lands in: its
    own plus one for each stacked axis."""
    return t.ndim + len(reference_leaf(name)[1])


def _to_numpy(t: torch.Tensor, bf16) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(bf16).copy()
    return t.numpy().copy()


def _stack(rows: dict) -> np.ndarray:
    """The leaf from its rows ``{index: array}`` (index () when unstacked)."""
    if () in rows:
        return rows[()]
    n = 1 + max(i[0] for i in rows)
    return np.stack([_stack({i[1:]: a for i, a in rows.items() if i[0] == j})
                     for j in range(n)])


def params_to_numpy(params, cfg: ModelConfig) -> dict:
    """The inverse of :func:`params_from_numpy` for a bf16 model (or a dict
    of its tensors by name, such as gradients or moments): the reference's
    nested tree of numpy arrays, every per-layer leaf stacked on its
    leading axes, bf16 as ``ml_dtypes.bfloat16`` (the reference's own
    numpy bf16 dtype), every bit kept."""
    import ml_dtypes

    leaves: dict = {}
    for name, t in named_tensors(params).items():
        path, idx = reference_leaf(name, cfg)
        leaves.setdefault(path, {})[idx] = _to_numpy(t, ml_dtypes.bfloat16)
    tree: dict = {}
    for path, rows in leaves.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _stack(rows)
    return tree


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
