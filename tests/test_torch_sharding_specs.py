"""The port's sharding table (``launch/sharding.py``) against the
reference's, shape only: no process group, no devices.

The reference runs through ``jax.eval_shape`` of its ``init_params`` /
``init_decode_state`` and a ``jax.sharding.AbstractMesh``; the port builds
its model on the meta device and its context on an ``AbstractMesh`` of the
same names and sizes. For every arch of ``ARCH_IDS``, at the reduced
config on a (2, 2) mesh and at the published widths on (16, 16) and (2, 16,
16), each of the port's tensors takes the spec of its counterpart leaf
(``interop.reference_leaf``) with the leading stacked axes dropped, for
``param_specs``, ``opt_state_specs``, ``batch_specs`` and
``decode_state_specs`` with and without ``seq_shard``, and every axis it
names divides its dim.

One difference is held: ZeRO-1 (``opt_state_specs`` of a replicated
parameter) shards the first dim that the dp size divides, and on the
reference's stacked leaf that can be the layer axis, which the port's
per-layer tensors do not have. There the port's spec must be the
reference's own rule applied to the unstacked leaf.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro.configs import get_config as jget
from repro.launch import sharding as JS
from repro.models.context import MeshContext as JContext
from repro.models.registry import get_model as jmodel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import port_spec, reference_leaf
from repro_torch.launch import sharding as S
from repro_torch.models.context import AbstractMesh as TAbstractMesh, MeshContext
from repro_torch.models.registry import get_model

MESHES = {"2x2": ((2, 2), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CASES = [(a, "2x2") for a in ARCH_IDS] + [(a, m) for a in ARCH_IDS for m in ("16x16", "2x16x16")]


def _contexts(mesh: str):
    shape, names = MESHES[mesh]
    dp = tuple(n for n in ("pod", "data") if n in names)
    kw = dict(dp_axes=dp, tp_axis="model", ep_axis="model", fsdp_axes=dp)
    return (JContext(mesh=AbstractMesh(shape, names), **kw),
            MeshContext(mesh=TAbstractMesh(shape, names), **kw))


def _by_path(tree) -> dict:
    return {JS._path_str(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))}


def _norm(spec, ndim: int) -> tuple:
    """A spec as a tuple of ``ndim`` entries (``P()`` replicates every dim),
    a one-axis tuple as its axis (``PartitionSpec`` stores ``("data",)`` as
    ``"data"``)."""
    out = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in tuple(spec))
    return out + (None,) * (ndim - len(out))


def _models(arch: str, reduced: bool):
    jcfg, cfg = jget(arch, reduced=reduced), get_config(arch, reduced=reduced)
    sds = jax.eval_shape(lambda k: jmodel(jcfg).init_params(jcfg, k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    params = get_model(cfg).init_params(cfg, seed=0, device="meta", generator=torch.Generator())
    return jcfg, cfg, sds, params


def _divides(spec, shape, ctx) -> bool:
    return all(ax is None or dim % S._axis_size(ctx, ax) == 0 for dim, ax in zip(shape, spec))


def _param_mismatches(cfg, jcfg, sds, params, jctx, ctx, rules=None) -> list:
    """Port tensors whose param spec differs from the reference leaf's."""
    want = _by_path(JS.param_specs(jcfg, sds, jctx))
    got = S.param_specs(cfg, params, ctx, rules=rules)
    bad = []
    for name, t in params.named_buffers():
        path, idx = reference_leaf(name, cfg)
        ref = port_spec(_norm(want["/".join(path)], len(idx) + t.ndim), name, cfg)
        if _norm(got[name], t.ndim) != ref:
            bad.append((name, got[name], ref))
        assert _divides(got[name], t.shape, ctx), (name, got[name], t.shape)
    return bad


@pytest.mark.parametrize("arch,mesh", CASES)
def test_specs_match_the_reference(arch, mesh):
    jctx, ctx = _contexts(mesh)
    jcfg, cfg, sds, params = _models(arch, reduced=mesh == "2x2")
    # every reference leaf has its port tensors, every port tensor a leaf
    paths = {"/".join(reference_leaf(n, cfg)[0]) for n, _ in params.named_buffers()}
    assert paths == set(_by_path(sds)), paths ^ set(_by_path(sds))
    assert _param_mismatches(cfg, jcfg, sds, params, jctx, ctx) == []

    # opt_state_specs: ZeRO-3 moments follow the params; ZeRO-1 (fsdp off)
    # shards a replicated parameter's moments over dp
    for fsdp in (jctx.fsdp_axes, ()):
        jc = JContext(**{**jctx.__dict__, "fsdp_axes": fsdp})
        tc = MeshContext(**{**ctx.__dict__, "fsdp_axes": fsdp})
        jp = JS.param_specs(jcfg, sds, jc)
        want = _by_path(JS.opt_state_specs(jcfg, sds, jp, jc))
        jp = _by_path(jp)
        got = S.opt_state_specs(cfg, params, S.param_specs(cfg, params, tc), tc)
        for name, t in params.named_buffers():
            path, idx = reference_leaf(name, cfg)
            ref = _norm(want["/".join(path)], len(idx) + t.ndim)
            if ref[:len(idx)] == (None,) * len(idx):
                assert _norm(got[name], t.ndim) == port_spec(ref, name, cfg), (name, got[name])
            else:  # the layer axis took the dp shards: the rule on the unstacked leaf
                pspec = JP(*port_spec(_norm(jp["/".join(path)], len(idx) + t.ndim), name, cfg))
                one = JS.opt_state_specs(jcfg, {"x": jax.ShapeDtypeStruct(t.shape, jnp.float32)},
                                         {"x": pspec}, jc)["x"]
                assert _norm(got[name], t.ndim) == _norm(one, t.ndim), (name, got[name], one)
            assert _divides(got[name], t.shape, tc), (name, got[name], t.shape)

    batch = {"tokens": jax.ShapeDtypeStruct((32, 64), jnp.int32),
             "labels": jax.ShapeDtypeStruct((1, 64), jnp.int32)}
    want = JS.batch_specs(jcfg, batch, jctx)
    got = S.batch_specs(cfg, {k: torch.empty(v.shape, device="meta") for k, v in batch.items()},
                        ctx)
    assert {k: _norm(v, 2) for k, v in got.items()} == {k: _norm(v, 2) for k, v in want.items()}

    b, s = (4, 64) if mesh == "2x2" else (64, 4096)
    jstate = jax.eval_shape(lambda: jmodel(jcfg).init_decode_state(jcfg, b, s))
    state = get_model(cfg).init_decode_state(cfg, b, s, device="meta")
    for seq_shard in (False, True):
        want = _by_path(JS.decode_state_specs(jcfg, jstate, jctx, seq_shard=seq_shard))
        got = S.decode_state_specs(cfg, state, ctx, seq_shard=seq_shard)
        assert set(got) == set(want)
        for k, v in state.items():
            assert _norm(got[k], v.ndim) == _norm(want[k], v.ndim), (k, seq_shard, got[k], want[k])
            assert _divides(got[k], v.shape, ctx)


def test_a_planted_wrong_rule_is_caught():
    """The attention output projection sharded like q/k/v (over its output
    dim) must show as a mismatch."""
    import re

    jctx, ctx = _contexts("2x2")
    jcfg, cfg, sds, params = _models("llama3-8b", reduced=True)
    f, m = ctx.fsdp_axes, ctx.tp_axis
    rules = [(re.compile(r"attn/o/w$"), lambda s: S.P(f, m))] + S._rules(cfg, ctx)
    bad = _param_mismatches(cfg, jcfg, sds, params, jctx, ctx, rules=rules)
    assert sorted(n for n, *_ in bad) == [f"layers.{i}.attn.o.w" for i in range(cfg.n_layers)]


def test_placements_follow_the_named_sharding_layout():
    """A dim over several axes is ``Shard(d)`` on each of their mesh dims;
    axes out of mesh order raise."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = TAbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert S.placements(mesh, S.P(("pod", "data"), None, "model")) == (Shard(0), Shard(0),
                                                                       Shard(2))
    assert S.placements(mesh, S.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        S.placements(mesh, S.P(("data", "pod")))
