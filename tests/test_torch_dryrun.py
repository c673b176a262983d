"""The port's dry-run (``repro_torch.launch.dryrun``) on the fake 256 / 512
rank meshes, against the reference's dry-run rules.

Three cells run once per worker (a module fixture; each inside
``dryrun_world``, which destroys its process group on exit): llama3-8b
``decode_32k`` (W4A4) and ``train_4k`` (bf16) on (16, 16), and olmoe-1b-7b
``train_4k`` on (2, 16, 16), the last with its collectives held to
``CommDebugMode``'s. Each must be ``ok``; the per-device parameter bytes
must equal, byte for byte, the reference's table (``param_specs`` on its
``eval_shape`` parameters, each leaf's bytes over the product of the axis
sizes its spec names; a W4A4 pack's ``abits`` leaf, the reference's marker
of its activation bits, is a dataclass field in the port and counts no
bytes); the MoE train cell must move all-to-all bytes (the
reference's ``test_ep_moe_collectives_present``). ``_model_flops`` equals
the reference's for all 12 archs, and a skipped shape carries the
reference's ``applicable_shapes`` reason."""

import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import QuantSpec as JQuant, get_config as jget
from repro.core.twinquant import quantize_params as jquantize
from repro.launch import sharding as JS
from repro.launch.mesh import dp_axes as jdp_axes
from repro.models.context import MeshContext as JContext
from repro.models.registry import applicable_shapes as japplicable, get_model as jmodel
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun as D
from repro_torch.models.registry import SHAPE_SETS


def _reference_dryrun_module():
    """``repro.launch.dryrun``, imported with XLA_FLAGS put back after: the
    module forces 512 host devices at import, which must not reach the JAX
    backend of the other tests in this worker (started first, so the flag
    cannot reach it)."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return ref


CELLS = {
    "llama3-8b/decode_32k/single/w4a4": ("llama3-8b", "decode_32k", False, "w4a4", False),
    "llama3-8b/train_4k/single/bf16": ("llama3-8b", "train_4k", False, "bf16", False),
    "olmoe-1b-7b/train_4k/multi/bf16": ("olmoe-1b-7b", "train_4k", True, "bf16", True),
}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    res = {}
    for key, (arch, shape, multi, quant, check) in CELLS.items():
        res[key] = D.run_cell(arch, shape, multi, quant, out, verbose=False, comm_check=check)
        assert not dist.is_initialized()  # dryrun_world took its process group down
    res["files"] = sorted(p.name for p in out.iterdir())
    return res


@pytest.mark.parametrize("key", list(CELLS))
def test_cells_are_ok(cells, key):
    r = cells[key]
    arch, shape, multi, quant, _ = CELLS[key]
    assert r["status"] == "ok" and r["chips"] == (512 if multi else 256)
    assert D._fname(arch, shape, multi, quant) in cells["files"]
    assert r["op_cost"]["flops"] > 0 and r["op_cost"]["bytes"] > 0
    assert r["op_cost"]["uncounted_calls"] == 0
    m = r["memory"]
    assert m["argument_bytes"] == sum(m[k] for k in ("param_bytes", "moment_bytes",
                                                     "batch_bytes", "state_bytes"))
    assert m["fits"] == (m["argument_bytes"] + m["gathered_bytes"] <= 80e9)
    rf = r["roofline"]
    assert rf["dominant"] in ("compute", "memory", "collective") and rf["roofline_fraction"] > 0
    json.dumps(r)  # the cell's JSON is plain


def _reference_param_bytes(arch: str, multi: bool, quant: str) -> int:
    jcfg = jget(arch, quant=JQuant(mode=quant))
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi else ((16, 16),
                                                                         ("data", "model"))
    mesh = AbstractMesh(shape, names)
    dps = jdp_axes(mesh)
    ctx = JContext(mesh=mesh, dp_axes=dps, tp_axis="model",
                   ep_axis="model" if jcfg.n_experts else None,
                   fsdp_axes=dps if jcfg.total_params() * 2 > 4e9 else ())
    sds = jax.eval_shape(lambda k: jmodel(jcfg).init_params(jcfg, k),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    if quant != "bf16":
        sds = jax.eval_shape(lambda p: jquantize(p, jcfg, jcfg.quant), sds)
    specs = JS.param_specs(jcfg, sds, ctx)
    sizes = dict(zip(names, shape))
    total = 0
    leaves = jax.tree_util.tree_leaves_with_path(sds)
    for (path, leaf), spec in zip(leaves, jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        if JS._path_str(path).endswith("abits"):
            continue  # the reference's a_bits marker (zeros of length a_bits): an int field here
        n = leaf.size * leaf.dtype.itemsize
        for entry in tuple(spec):
            for ax in (entry,) if isinstance(entry, str) else (entry or ()):
                n //= sizes[ax]
        total += n
    return total


@pytest.mark.parametrize("key", list(CELLS))
def test_param_bytes_per_device_equal_the_reference_table(cells, key):
    arch, _, multi, quant, _ = CELLS[key]
    assert cells[key]["memory"]["param_bytes"] == _reference_param_bytes(arch, multi, quant)


def test_moe_train_cell_moves_all_to_all_bytes(cells):
    r = cells["olmoe-1b-7b/train_4k/multi/bf16"]
    coll = r["collectives"]
    assert coll["all-to-all"] > 0, coll
    assert coll["comm_debug_counts"]["all-to-all"] == coll["count_all-to-all"]
    assert r["roofline"]["coll_bytes"] > 0 and r["roofline"]["coll_net_bytes"] > 0


def test_train_cell_gathers_every_parameter(cells):
    """The port's sharded step gathers each parameter at once: the
    gathered bytes are the whole bf16 model's, for a dense arch."""
    r = cells["llama3-8b/train_4k/single/bf16"]
    assert r["memory"]["gathered_bytes"] == r["param_bytes_global"]
    assert r["memory"]["moment_bytes"] > 0 and r["collectives"]["all-gather"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    ref = _reference_dryrun_module()
    for shape in SHAPE_SETS:
        assert D._model_flops(get_config(arch), shape) == ref._model_flops(jget(arch), shape)


def test_skipped_shape_carries_the_reference_reason(tmp_path, capsys):
    D.main(["--arch", "llama3-8b", "--shape", "long_500k", "--mesh", "both",
            "--out", str(tmp_path)])
    reason = japplicable(jget("llama3-8b"))["long_500k"]
    for mesh in ("single", "multi"):
        doc = json.loads((tmp_path / f"llama3-8b__long_500k__{mesh}__bf16.json").read_text())
        assert doc["status"] == "skip" and doc["reason"] == reason
    assert "SKIP" in capsys.readouterr().out
