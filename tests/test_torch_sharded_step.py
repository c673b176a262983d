"""The port's sharded train step on 4 gloo ranks (a (2, 2) ``("data",
"model")`` mesh, one spawn for every case, the rank body in
``torch_dist_worker``) against the reference's sharded step on 4 forced
host devices with ``Auto`` axes, and the same step at world size 1 in this
process.

Cases, each of reduced llama3-8b and reduced OLMoE (the EP path: E 8 over
the model axis, tokens over (data, model)), with ``fsdp_axes=("data",)``
(the moments follow the parameters' specs) and ``fsdp_axes=()`` (ZeRO-1
shards the moments of replicated parameters):

* the loss within rel ``LOSS_REL`` of the reference's sharded loss (read:
  at most 5.7e-5, OLMoE), each parameter's gradient within rel ``GRAD_REL``
  (Frobenius) of the reference leaf's (read: at most 0.016, llama3-8b);
  both are bf16 rounding in another order, as in
  ``test_torch_train_losses.py``. The reference runs compiled with
  ``xla_allow_excess_precision`` off, as there;
* OLMoE's EP loss differs from its local loss as the reference's does:
  EP routes and drops per shard (capacity of the shard's tokens,
  ``_capacity(T_loc)``), a gap of rel ~2.5e-3 on this batch, far above
  ``LOSS_REL``;
* every parameter, moment and batch leaf in the table's placements;
* the ZeRO-1 update bit-equal to one device's AdamW on the gathered
  gradients with the same clip factor, each moment's local shard the
  shape its spec gives;
* int8 compression: one amax per whole reference leaf, the per-leaf
  formula's bits on every shard;
* the elastic restore: saved on (2, 2), restored ``torch.equal`` onto (4,
  1) and onto world size 1;
* at world size 1 (gloo, in this process) a whole sharded step is
  ``torch.equal`` to the unsharded one, loss, parameters and moments.
"""

import os
import time

# must precede jax's first use in this process
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import torch_dist_worker as W  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models.context import MeshContext as JContext  # noqa: E402
from repro.models.context import mesh_context as jmesh_context  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_to_numpy, reference_leaf  # noqa: E402
from repro_torch.models.common import trainable  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

LOSS_REL = 2e-4
GRAD_REL = 0.03
WORLD = 4
SPAWN_TIMEOUT_S = 240
CASES = [(a, f) for a in ("llama3-8b", "olmoe-1b-7b") for f in ("fsdp", "zero1")]


def _spawn(out: str):
    """The 4 ranks, started."""
    return mp.start_processes(W.run, args=(WORLD, os.path.join(out, "store"), out),
                              nprocs=WORLD, join=False, start_method="spawn")


def _join(pc) -> None:
    """Wait for the ranks; kill them and fail past ``SPAWN_TIMEOUT_S``."""
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not pc.join(timeout=5):
        if time.monotonic() > deadline:
            for p in pc.processes:
                p.kill()
            pytest.fail(f"the {WORLD} gloo ranks did not finish in {SPAWN_TIMEOUT_S} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results per case, their directory, the reference's): the
    ranks run while this process computes the reference."""
    out = str(tmp_path_factory.mktemp("ranks"))
    pc = _spawn(out)
    try:
        ref = _reference()
    finally:
        _join(pc)
    res = {c: torch.load(os.path.join(out, f"{c[0]}-{c[1]}.pt"), weights_only=False)
           for c in CASES}
    return res, out, ref


def _batch(cfg):
    toks = W.tokens(cfg.vocab)
    return {"tokens": toks, "labels": toks}


def _port_local(arch: str):
    """(loss, {name: grad}) of the port's unsharded loss on the batch."""
    cfg = get_config(arch, reduced=True)
    params = trainable(get_model(cfg).init_params(cfg, seed=0, device="cpu"))
    loss = get_model(cfg).loss_fn(params, cfg, {k: torch.from_numpy(v)
                                                for k, v in _batch(cfg).items()})
    loss.backward()
    return float(loss.detach()), params


def _reference():
    """The reference's sharded (loss, grads) per case on a (2, 2) Auto mesh,
    and its local OLMoE loss."""
    assert len(jax.devices()) >= WORLD, "needs 4 forced host devices (XLA_FLAGS)"
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, mode in CASES:
        jcfg, cfg = jget(arch, reduced=True), get_config(arch, reduced=True)
        tree = params_to_numpy(get_model(cfg).init_params(cfg, seed=0, device="cpu"), cfg)
        ctx = JContext(mesh=mesh, dp_axes=("data",), tp_axis="model", ep_axis="model",
                       fsdp_axes=("data",) if mode == "fsdp" else ())
        fn = jax.value_and_grad(lambda p, b: jmodel(jcfg).loss_fn(p, jcfg, b))
        with jmesh_context(ctx), jax.set_mesh(mesh):
            p = jax.tree.map(jnp.asarray, tree)
            b = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
            p = jax.device_put(p, JS.make_shardings(mesh, JS.param_specs(jcfg, p, ctx)))
            b = jax.device_put(b, JS.make_shardings(mesh, JS.batch_specs(jcfg, b, ctx)))
            loss, grads = jax.jit(fn).lower(p, b).compile(
                {"xla_allow_excess_precision": False})(p, b)
        out[arch, mode] = float(loss), jax.tree.map(lambda a: np.asarray(a, np.float32), grads)
    jcfg = jget("olmoe-1b-7b", reduced=True)
    cfg = get_config("olmoe-1b-7b", reduced=True)
    tree = params_to_numpy(get_model(cfg).init_params(cfg, seed=0, device="cpu"), cfg)
    loss = jax.jit(lambda p, b: jmodel(jcfg).loss_fn(p, jcfg, b)).lower(tree, _batch(cfg)) \
        .compile({"xla_allow_excess_precision": False})(tree, _batch(cfg))
    out["olmoe local"] = float(loss)
    return out


def _leaf(tree, name, cfg):
    path, idx = reference_leaf(name, cfg)
    for k in path:
        tree = tree[k]
    return tree[idx] if idx else tree


@pytest.mark.parametrize("arch,mode", CASES)
def test_sharded_loss_and_grads_match_the_reference(runs, arch, mode):
    res, _, reference = runs
    got = res[arch, mode]
    want_loss, want = reference[arch, mode]
    assert abs(got["loss"] - want_loss) <= LOSS_REL * abs(want_loss), (got["loss"], want_loss)
    cfg = get_config(arch, reduced=True)
    rels = {}
    for n, g in got["grads"].items():
        a = _leaf(want, n, cfg)
        rels[n] = float(np.linalg.norm(g.float().numpy() - a) / np.linalg.norm(a))
    assert max(rels.values()) <= GRAD_REL, sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    assert got["mismatches"] == []


def test_ep_departs_from_the_local_path_as_the_reference_does(runs):
    """EP drops per shard: its loss differs from the local path's, in the
    port as in the reference, by far more than ``LOSS_REL``."""
    res, _, reference = runs
    port_local, _ = _port_local("olmoe-1b-7b")
    port_gap = res["olmoe-1b-7b", "fsdp"]["loss"] - port_local
    ref_gap = reference["olmoe-1b-7b", "fsdp"][0] - reference["olmoe local"]
    tol = LOSS_REL * abs(port_local)
    assert abs(port_gap) > 10 * tol and abs(ref_gap) > 10 * tol, (port_gap, ref_gap)
    assert abs(port_gap - ref_gap) <= 2 * tol, (port_gap, ref_gap)


def test_zero1_update_is_one_devices_adamw(runs):
    res = runs[0]
    z = res["llama3-8b", "zero1"]["zero1"]
    bad = [n for n, (p, mu, nu, *_) in z.items() if not (p and mu and nu)]
    assert bad == []
    # the moments of a replicated parameter are split over data (2 ranks)
    assert z["ln_f"][3:] == ((64,), ("S(0)", "R"))
    assert z["layers.0.attn.o.w"][3:] == ((64, 128), ("R", "S(0)"))
    assert 0 < res["llama3-8b", "zero1"]["factor"] < 1  # the clip was active


def test_compression_keeps_one_amax_per_leaf(runs):
    res = runs[0]
    c = res["llama3-8b", "fsdp"]["compress"]
    assert c and all(q and s for q, s in c.values()), c


def test_elastic_restore_onto_4x1(runs):
    res = runs[0]
    r = res["olmoe-1b-7b", "fsdp"]
    assert r["restore41"] and all(eq and pl for eq, pl in r["restore41"].values())
    assert r["restore41_mu"]


@pytest.fixture()
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store1"), 1),
                            rank=0, world_size=1)
    try:
        from repro_torch.launch.mesh import make_debug_mesh

        yield make_debug_mesh((1, 1), device="cpu")
    finally:
        dist.destroy_process_group()


def test_world_size_1_step_and_restore(runs, world1):
    """One gloo rank: a whole sharded step (loss, AdamW with its clip) is
    bit-equal to the unsharded one; the 4-rank checkpoint restores onto
    (1, 1) ``torch.equal``."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import sharding as S
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models.context import mesh_context
    from repro_torch.optim import AdamW

    cfg = get_config("olmoe-1b-7b", reduced=True)
    batch = _batch(cfg)
    opt = AdamW()
    params, state = init_train_state(cfg, opt, seed=0, device="cpu")
    params, state, loss = make_train_step(cfg, opt)(params, state, batch)
    ctx = W.context(world1, True)
    with mesh_context(ctx):
        sp, ss = init_train_state(cfg, opt, seed=0, device="cpu")
        sp, ss, sloss = make_train_step(cfg, opt)(sp, ss, batch)
    assert torch.equal(loss, sloss)
    for n, p in params.named_parameters():
        d = dict(sp.named_parameters())[n]
        assert torch.equal(p.detach(), d.full_tensor()), n
        assert torch.equal(state.mu[n], ss.mu[n].full_tensor()), n
        assert torch.equal(state.nu[n], ss.nu[n].full_tensor()), n

    res, out, _ = runs
    ckpt = CheckpointManager(os.path.join(out, "ckpt"))
    with mesh_context(ctx):
        like, opt_like = init_train_state(cfg, opt, seed=2, device="cpu")
        pl = S.make_shardings(world1, S.param_specs(cfg, like, ctx))
        got = ckpt.restore_like(1, {"params": like, "opt": opt_like},
                                shardings={f"params|{n}": (world1, pl[n]) for n in pl})
    for n, t in res["olmoe-1b-7b", "fsdp"]["saved"].items():
        p = dict(got["params"].named_parameters())[n]
        assert torch.equal(p.full_tensor(), t) and tuple(p.placements) == pl[n], n


def test_mesh_and_constraints_at_world_size_1(world1):
    """The production meshes name the world size they need; a sharding
    constraint lays a DTensor out as its spec says and passes a rank's
    plain block through."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import dp_axes, make_production_mesh
    from repro_torch.models import common as C
    from repro_torch.models.context import mesh_context

    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"world of {n} .* world size 1"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert dp_axes(world1) == ("data",)
    x = torch.arange(24.0).reshape(2, 3, 4)
    with mesh_context(W.context(world1, True)):
        d = C._cs(distribute_tensor(x, world1, (Replicate(), Replicate())), "data", None, "model")
        assert tuple(d.placements) == (Shard(0), Shard(2)) and torch.equal(d.full_tensor(), x)
        assert C._shard_logits(x) is x
        assert C.embed_lookup(x[0], torch.tensor([2, 0])).shape == (2, 4)
