"""Sharding rules of the port: parameter path -> spec, per architecture
family (the reference's ``repro/launch/sharding.py``), and specs ->
DTensor placements on a ``torch.distributed`` mesh.

The rules table is the reference's, copied: regexes over the reference's
``/``-joined parameter paths, first match wins, default replicate. A port
tensor reaches its reference path through ``interop.reference_leaf``; the
reference stacks per-layer leaves on leading axes that every rule leaves
unsharded (``last2`` / ``lastn`` / ``vec``), so the port's per-layer spec
is the reference leaf's with those axes dropped, and the spec functions below
give it straight from the port's shape.

A spec is a :class:`P`: one entry per tensor dim, ``None`` (replicated),
an axis name or a tuple of them (the dim sharded over their product, the
first the major). :func:`placements` turns it into one placement per mesh
dim, ``Shard(d)`` on each mesh dim that shards tensor dim ``d``, as
``NamedSharding`` lays it out; torch orders several mesh dims on one tensor
dim by mesh dim, so the axes of an entry must come in mesh order.

``decode_state_specs`` is defined on the port's bucketed decode state, a
flat dict whose keys and shapes are the reference's ``init_decode_state``
leaves. The reference never serves sharded, so these specs are the table
only, not an executed path.
"""

from __future__ import annotations

import re

from repro_torch.configs import ModelConfig
from repro_torch.interop import named_tensors, reference_leaf
from repro_torch.models.context import MeshContext, axis_sizes

__all__ = ["P", "batch_specs", "decode_state_specs", "make_shardings", "opt_state_specs",
           "param_path", "param_specs", "placements"]


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _rules(cfg: ModelConfig, ctx: MeshContext):
    f = tuple(ctx.fsdp_axes) or None  # fsdp axes (e.g. ("data",)) or replicate
    m = ctx.tp_axis  # "model"
    e = ctx.ep_axis

    def last2(spec_in, spec_out):
        """Spec for a (possibly layer-stacked) matrix: leading dims None."""

        def build(shape):
            lead = (None,) * (len(shape) - 2)
            return P(*lead, spec_in, spec_out)

        return build

    def lastn(*specs):
        def build(shape):
            lead = (None,) * (len(shape) - len(specs))
            return P(*lead, *specs)

        return build

    def vec(spec):
        def build(shape):
            lead = (None,) * (len(shape) - 1)
            return P(*lead, spec)

        return build

    R = [
        # --- embeddings / heads: vocab over model, feature over fsdp
        (r"embed$", lambda s: P(m, f)),
        (r"head/w$", last2(f, m)),
        # --- attention (dense/GQA, whisper, zamba shared, xlstm-free)
        (r"attn/[qkv]/w$", last2(f, m)),
        (r"attn/[qkv]/b$", vec(m)),
        (r"attn/o/w$", last2(m, f)),
        (r"xattn/[qkv]/w$", last2(f, m)),
        (r"xattn/o/w$", last2(m, f)),
        (r"shared/[qkv]/w$", last2(f, m)),
        (r"shared/o/w$", last2(m, f)),
        # --- MLA projections
        (r"wq_a/w$", last2(f, None)),
        (r"wq_b/w$", last2(f, m)),
        (r"wkv_a/w$", last2(f, None)),
        (r"wkv_b/w$", last2(f, m)),
        # --- MLP (dense & shared-expert & whisper gelu & slstm ffn)
        (r"(mlp|ffn|shared/mlp|moe/shared)/(gate|up)/w$", last2(f, m)),
        (r"(mlp|ffn|shared/mlp|moe/shared)/(gate|up)/b$", vec(m)),
        (r"(mlp|ffn|shared/mlp|moe/shared)/down/w$", last2(m, f)),
        # --- MoE experts: E over ep, then D over fsdp (gathered in-shard)
        (r"moe/(gate|up)/w$", lastn(e, f, None)),
        (r"moe/down/w$", lastn(e, None, f)),
        (r"moe/router$", lastn(None, None)),
        # --- quantized packs inherit their parent linear's layout
        (r"attn/[qkv]/(rp|rs|up|us)$", last2(f, m)),
        (r"attn/[qkv]/(vp|vs)$", last2(None, m)),
        (r"attn/o/(rp|rs|up|us)$", last2(m, f)),
        (r"attn/o/(vp|vs)$", last2(None, f)),
        (r"(mlp|ffn)/(gate|up)/(rp|rs|up|us)$", last2(f, m)),
        (r"(mlp|ffn)/(gate|up)/(vp|vs)$", last2(None, m)),
        (r"(mlp|ffn)/down/(rp|rs|up|us)$", last2(m, f)),
        (r"(mlp|ffn)/down/(vp|vs)$", last2(None, f)),
        (r"abits$", lambda s: P()),
        # --- xLSTM
        (r"m_layers/(up|wq|wk|wv)/w$", last2(f, m)),
        (r"m_layers/wif/w$", last2(f, None)),
        (r"m_layers/down/w$", last2(m, f)),
        (r"m_layers/conv$", vec(m)),
        # --- Mamba2
        (r"m_layers/in_proj/w$", last2(f, None)),
        (r"(m_layers|rest_layers)/out_proj/w$", last2(m, f)),
        (r"(m_layers|rest_layers)/conv$", vec(None)),
        (r"rest_layers/in_proj/w$", last2(f, None)),
        # --- sLSTM recurrence: heads over model
        (r"s_layers/w/w$", last2(f, None)),
        (r"s_layers/r$", lastn(m, None, None)),
        # --- zamba adapters
        (r"adapters/w$", last2(m, f)),
        # --- MTP
        (r"mtp/proj/w$", last2(f, m)),
    ]
    return [(re.compile(pat), fn) for pat, fn in R]


def param_path(name: str, cfg: ModelConfig) -> str:
    """The reference's ``/``-joined path of the port's tensor ``name``."""
    return "/".join(reference_leaf(name, cfg)[0])


def _axis_size(ctx: MeshContext, axes) -> int:
    if axes is None or ctx.mesh is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = ctx.sizes
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fit(spec: P, shape, ctx: MeshContext) -> P:
    """Drop axis assignments that don't divide the dim (keeps tiny dims
    like kv-head counts below the axis size unsharded)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
        elif dim % _axis_size(ctx, ax) == 0 and dim >= _axis_size(ctx, ax):
            out.append(ax)
        else:
            out.append(None)
    return P(*out)


def param_specs(cfg: ModelConfig, params, ctx: MeshContext, rules=None) -> dict:
    """``{name: P}`` for a model's tensors (``interop.named_tensors``; a
    module on the meta device gives the specs without allocating).
    ``rules`` replaces the table (a list of (compiled regex, spec function))."""
    rules = _rules(cfg, ctx) if rules is None else rules

    def spec_for(name, shape):
        s = param_path(name, cfg)
        for pat, fn in rules:
            if pat.search(s):
                return _fit(fn(shape), shape, ctx)
        return P()  # replicate (norms, scalars, gates, biases)

    return {n: spec_for(n, tuple(t.shape)) for n, t in named_tensors(params).items()}


def opt_state_specs(cfg: ModelConfig, params, pspecs: dict, ctx: MeshContext) -> dict:
    """ZeRO-1: when a parameter is replicated (small models, fsdp off), its
    f32 Adam moments are still sharded over the dp axes on their first
    divisible dim; a sharded parameter's moments follow its spec."""
    dp = tuple(ctx.dp_axes) or None

    def spec_for(shape, pspec):
        if any(ax is not None for ax in tuple(pspec)):
            return pspec  # follow the param sharding (ZeRO-3)
        for i, dim in enumerate(shape):
            if dp and dim % _axis_size(ctx, dp) == 0 and dim >= _axis_size(ctx, dp):
                spec = [None] * len(shape)
                spec[i] = dp
                return P(*spec)
        return P()

    return {n: spec_for(tuple(t.shape), pspecs[n]) for n, t in named_tensors(params).items()}


def batch_specs(cfg: ModelConfig, batch: dict, ctx: MeshContext) -> dict:
    """Batch inputs: leading batch dim over dp axes (dropped when the batch
    doesn't divide, e.g. long_500k's batch=1)."""
    dp = tuple(ctx.dp_axes) or None
    return {k: _fit(P(dp, *(None,) * (len(v.shape) - 1)), tuple(v.shape), ctx)
            for k, v in batch.items()}


def decode_state_specs(cfg: ModelConfig, state: dict, ctx: MeshContext, *,
                       seq_shard: bool = False) -> dict:
    """KV caches / recurrent states.

    Layout: (L, B, S, KV, hd) caches -> batch over dp; kv-heads over model if
    they divide, else the sequence dim; ``seq_shard=True`` (long_500k,
    batch < dp size) shards S over (dp + model) instead.
    """
    dp = tuple(ctx.dp_axes) or None
    m = ctx.tp_axis

    def spec_for(s, shape):
        if s.endswith("pos"):
            return P()
        if "shared_" in s or s.endswith(("k", "v", "xk", "xv")) and len(shape) == 5:
            # (L, B, S, KV, hd)
            if seq_shard:
                spec = P(None, None, tuple(ctx.dp_axes) + ((m,) if m else ()), None, None)
                return _fit(spec, shape, ctx)
            kv = shape[3]
            if m and kv % _axis_size(ctx, m) == 0:
                return _fit(P(None, dp, None, m, None), shape, ctx)
            return _fit(P(None, dp, m, None, None), shape, ctx)
        if s.endswith(("ckv", "krope")) and len(shape) == 4:
            # MLA latent cache (L, B, S, r): batch over dp, seq over model
            if seq_shard:
                spec = P(None, None, tuple(ctx.dp_axes) + ((m,) if m else ()), None)
                return _fit(spec, shape, ctx)
            return _fit(P(None, dp, m, None), shape, ctx)
        if s.endswith(("mC", "mn", "mm")):
            # xlstm matrix state (..., B, H, dh[, dh]): batch dp, value dim model
            idx = len(shape) - (4 if s.endswith("mC") else (3 if s.endswith("mn") else 2))
            spec = [None] * len(shape)
            spec[idx] = dp
            if s.endswith("mC") and m:
                spec[-1] = m
            return _fit(P(*spec), shape, ctx)
        if s.endswith("ssm") or s.endswith("ssm_rest"):
            # (L..., B, H, P, N): batch dp, ssm heads over model
            spec = [None] * len(shape)
            spec[-4] = dp
            spec[-3] = m
            return _fit(P(*spec), shape, ctx)
        if s.endswith(("conv", "conv_rest")):
            spec = [None] * len(shape)
            spec[-3] = dp
            return _fit(P(*spec), shape, ctx)
        if len(shape) >= 2:
            spec = [None] * len(shape)
            spec[-2] = dp  # (L?, B, D) recurrent vectors: batch dim heuristic
            return _fit(P(*spec), shape, ctx)
        return P()

    return {k: spec_for(k, tuple(v.shape)) for k, v in state.items()}


def placements(mesh, spec: P) -> tuple:
    """One DTensor placement per mesh dim for ``spec``: ``Shard(d)`` on each
    mesh dim that shards tensor dim ``d``, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {d} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def make_shardings(mesh, specs: dict) -> dict:
    """``{name: placements}`` for a dict of specs on ``mesh``."""
    return {n: placements(mesh, s) for n, s in specs.items()}
