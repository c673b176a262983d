"""Multi-pod dry-run of the port (the reference's ``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell: one step of the
cell's kind on the (16, 16) production mesh or the (2, 16, 16) multi-pod
mesh, on ``meta`` tensors, counted by ``op_cost.analyze_step``, with the
per-device memory computed from the sharding table's placements and the
H100 roofline (``launch.roofline``). Results land in
``<out>/<arch>__<shape>__<single|multi>__<quant>.json``.

The mesh is real and the world is not: :func:`dryrun_world` initialises
``torch.distributed``'s fake process group (no transport; a collective
returns at once) at 256 or 512 ranks, this process rank 0, and
``launch.mesh.make_production_mesh`` builds the ``DeviceMesh`` on it. This
is the one entry point of the port that does not run on the card: like the
reference's (forced host devices, nothing executed), it touches no device.

What a cell runs, per device (rank 0 stands for every rank):

* ``train``: the port's sharded train step (``launch.train.make_train_step``
  under the mesh context), on meta DTensors: parameters per
  ``sharding.param_specs``, AdamW moments per ``opt_state_specs`` (bf16 for
  DeepSeek-V3, as the reference), the batch per ``batch_specs``. The step
  gathers every parameter (the experts stay split on the ep axis), runs the
  loss on the rank's dp rows and reduces each gradient onto its parameter's
  placements: its collectives are DTensor's.
* ``prefill`` / ``decode``: the port has no sharded serving path (the
  reference's never runs; XLA partitions its dry-run). A rank gathers every
  parameter, and its dp rows of the decode state whole along the axes the
  table shards them over besides dp (the port's attention needs a row's
  whole sequence), then runs the family's ``prefill`` / ``decode_step`` on
  those rows with no mesh context. With ``quant != "bf16"`` the parameters
  are ``core.twinquant.quantize_params`` packs (unfused, so that the
  table's pack rules apply, as the reference's dry-run packs).

``memory`` (per device, from the placements; not the allocator):
``argument_bytes`` (parameters, moments, batch and state as placed),
``gathered_bytes`` (what the step gathers at once: every parameter
gathered, and for serve cells the state rows), ``fits`` (their sum <=
80e9, the H100's memory). Activations are not measured.

``python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k``
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, ModelConfig, QuantSpec, get_config
from repro_torch.core.twinquant import quantize_params
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.launch.op_cost import _COLL_KIND, analyze_step
from repro_torch.launch.roofline import from_counts
from repro_torch.launch.sharding import (
    P,
    batch_specs,
    decode_state_specs,
    opt_state_specs,
    param_specs,
    placements,
)
from repro_torch.launch.train import _expert_kept, distribute_params, make_train_step
from repro_torch.models.common import trainable
from repro_torch.models.context import MeshContext, gathered, mesh_context
from repro_torch.models.registry import (
    SHAPE_SETS,
    applicable_shapes,
    count_active_params,
    get_model,
    input_specs,
)
from repro_torch.optim.adamw import AdamW, AdamWState

__all__ = ["DEVICE_BYTES", "dryrun_world", "main", "run_cell"]

DEVICE_BYTES = 80e9  # H100 SXM memory


@contextlib.contextmanager
def dryrun_world(world: int):
    """The fake process group at ``world`` ranks (this process rank 0),
    unless a process group exists already; destroyed on exit if made
    here."""
    made = not dist.is_initialized()
    if made:
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        if made:
            dist.destroy_process_group()


def _mesh_ctx(cfg: ModelConfig, mesh) -> MeshContext:
    dps = dp_axes(mesh)
    # the reference's FSDP policy: parameters sharded over dp (ZeRO-3) only
    # when their bf16 bytes pass ~4 GB; otherwise replicated, with the f32
    # moments ZeRO-1-sharded (sharding.opt_state_specs)
    params_bytes = cfg.total_params() * 2
    fsdp = dps if params_bytes > 4e9 * 1 else ()
    return MeshContext(mesh=mesh, dp_axes=dps, tp_axis="model",
                       ep_axis="model" if cfg.n_experts else None, fsdp_axes=fsdp)


def _model_flops(cfg: ModelConfig, shape_name: str) -> float:
    spec = SHAPE_SETS[shape_name]
    n_active = count_active_params(cfg)
    if spec["kind"] == "train":
        return 6.0 * n_active * spec["batch"] * spec["seq"]
    if spec["kind"] == "prefill":
        return 2.0 * n_active * spec["batch"] * spec["seq"]
    return 2.0 * n_active * spec["batch"]  # decode: one token per sequence


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * dtype.itemsize


def _local_shape(shape, pls, mesh) -> tuple:
    from torch.distributed.tensor import Shard

    out = list(shape)
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            out[pl.dim] //= mesh.size(i)
    return tuple(out)


def _meta_dtensor(shape, dtype, mesh, pls):
    """A meta DTensor of global ``shape`` laid out as ``pls``."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(_local_shape(shape, pls, mesh), dtype=dtype, device="meta")
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, pls, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _rows_spec(spec: P, dp) -> P:
    """``spec`` with only its dp entry kept: a rank's rows, whole along
    every other axis."""
    return P(*(ax if ax == dp else None for ax in spec))


def _all_tensors(params) -> dict:
    named = dict(params.named_parameters())
    named.update(params.named_buffers())
    return named


def _serve_step(model, cfg, params, pspecs, state_specs, state_shapes, mesh, dp, kind,
                tokens, frontend, b_loc, max_len):
    """A rank's serve step: every parameter gathered, its state rows
    gathered whole, then the family's step on its rows (no mesh context)."""
    for n, t in _all_tensors(params).items():
        gathered(_meta_dtensor(tuple(t.shape), t.dtype, mesh, placements(mesh, pspecs[n])))
    for k, (shape, dtype) in state_shapes.items():
        dt = _meta_dtensor(shape, dtype, mesh, placements(mesh, state_specs[k]))
        dt.redistribute(mesh, placements(mesh, _rows_spec(state_specs[k], dp))).to_local()
    state = model.init_decode_state(cfg, b_loc, max_len, device="meta")
    if kind == "decode":
        return model.decode_step(params, cfg, state, tokens)
    return model.prefill(params, cfg, tokens, state, **frontend)


def _comm_debug_mode():
    """``CommDebugMode`` counting collectives by op with its own registry,
    without its per-module tracker: the tracker fails (an empty parent
    list) on a module that a rematerialised layer calls again (DeepSeek-V3's
    head, shared by its ``mtp`` block)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.debug._comm_mode import (
        NATIVE_TO_PY_MAPPING,
        c10d_collective_ops,
    )
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Counts(CommDebugMode):
        def __enter__(self):
            self.comm_counts.clear()
            TorchDispatchMode.__enter__(self)
            return self

        def __exit__(self, *args):
            TorchDispatchMode.__exit__(self, *args)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **(kwargs or {}))
            if any(t == DTensor for t in types):
                return NotImplemented  # DTensor desugars into collectives first
            out = func(*args, **(kwargs or {}))
            packet = func._overloadpacket
            if packet in self.comm_registry or packet in c10d_collective_ops:
                self.comm_counts[NATIVE_TO_PY_MAPPING.get(packet, packet)] += 1
            return out

    return _Counts()


def _comm_counts(cm) -> dict:
    out: dict = {}
    for packet, n in cm.get_comm_counts().items():
        kind = _COLL_KIND.get(packet.__name__.split(".")[-1])
        if kind:
            out[kind] = out.get(kind, 0) + n
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, quant: str, outdir: Path,
             verbose: bool = True, comm_check: bool = True) -> dict:
    """Count one cell and write its JSON; returns the result dict. With
    ``comm_check`` the counter's collectives are held, count per kind, to
    ``CommDebugMode``'s (which doubles a cell's time)."""
    cfg = get_config(arch, quant=QuantSpec(mode=quant))
    spec = SHAPE_SETS[shape_name]
    kind = spec["kind"]
    chips = 512 if multi_pod else 256
    t0 = time.monotonic()
    with dryrun_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        ctx = _mesh_ctx(cfg, mesh)
        dp = tuple(ctx.dp_axes)
        model = get_model(cfg)
        params = model.init_params(cfg, device="meta", generator=torch.Generator())
        if quant != "bf16" and kind != "train":
            params = quantize_params(params, cfg, cfg.quant)
        named = _all_tensors(params)
        pspecs = param_specs(cfg, named, ctx)
        pls = {n: placements(mesh, s) for n, s in pspecs.items()}
        param_bytes_global = sum(_nbytes(t.shape, t.dtype) for t in named.values())
        param_local = sum(_nbytes(_local_shape(t.shape, pls[n], mesh), t.dtype)
                          for n, t in named.items())
        batch = input_specs(cfg, shape_name)
        bspecs = batch_specs(cfg, batch, ctx)
        batch_local = sum(_nbytes(_local_shape(v.shape, placements(mesh, bspecs[k]), mesh),
                                  v.dtype) for k, v in batch.items())
        mem = {"param_bytes": param_local, "batch_bytes": batch_local, "moment_bytes": 0,
               "state_bytes": 0}
        with _comm_debug_mode() if comm_check else contextlib.nullcontext() as cm:
            if kind == "train":
                opt = AdamW(moment_dtype=torch.bfloat16 if "671b" in arch else torch.float32)
                with mesh_context(ctx):
                    params = trainable(params)
                    mspecs = opt_state_specs(cfg, params, param_specs(cfg, params, ctx), ctx)
                    distribute_params(cfg, params, ctx)

                    def moments():
                        return {n: _meta_dtensor(tuple(p.shape), opt.moment_dtype, mesh,
                                                 placements(mesh, mspecs[n]))
                                for n, p in params.named_parameters()}

                    mu, nu = moments(), moments()
                    mem["moment_bytes"] = 2 * sum(
                        _nbytes(m.to_local().shape, m.dtype) for m in mu.values())
                    opt_state = AdamWState(mu=mu, nu=nu,
                                           count=torch.zeros((), dtype=torch.int32, device="meta"))
                    # a view a parameter; an EP-kept expert weight keeps its ep shard
                    gathered_bytes = sum(
                        _nbytes(p.shape, p.dtype) // (ctx.ep_size if _expert_kept(n, p, ctx) else 1)
                        for n, p in params.named_parameters())
                    cost = analyze_step(make_train_step(cfg, opt), params, opt_state, batch)
            else:
                b = spec["batch"]
                max_len = spec["seq"] + (cfg.n_patches if cfg.family == "vlm" and kind == "prefill"
                                         else 0)
                state = model.init_decode_state(cfg, b, max_len, device="meta")
                sspecs = decode_state_specs(cfg, state, ctx,
                                            seq_shard=shape_name.startswith("long"))
                shapes = {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
                mem["state_bytes"] = sum(
                    _nbytes(_local_shape(s, placements(mesh, sspecs[k]), mesh), d)
                    for k, (s, d) in shapes.items())
                dpn = 1
                for a in dp:
                    dpn *= mesh.size(mesh.mesh_dim_names.index(a))
                b_loc = b // dpn if b % dpn == 0 else b
                loc = {k: torch.empty((b_loc, *v.shape[1:]), dtype=v.dtype, device="meta")
                       for k, v in batch.items()}
                tokens = loc.pop("tokens")
                rows = sum(_nbytes(_local_shape(s, placements(mesh, _rows_spec(sspecs[k], dp)),
                                                mesh), d) for k, (s, d) in shapes.items())
                gathered_bytes = param_bytes_global + rows
                cost = analyze_step(_serve_step, model, cfg, params, pspecs, sspecs, shapes,
                                    mesh, dp, kind, tokens, loc, b_loc, max_len)
        comm = _comm_counts(cm) if comm_check else None
    ours = {k[len("count_"):]: int(v) for k, v in cost["coll_detail"].items()
            if k.startswith("count_") and v}
    if comm_check and ours != comm:
        raise RuntimeError(f"collective counts differ from CommDebugMode's: {ours} vs {comm}")
    argument_bytes = sum(mem.values())
    rf = from_counts(cost, chips, _model_flops(cfg, shape_name))
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "quant": quant,
        "status": "ok",
        "t_run_s": time.monotonic() - t0,
        "memory": {**mem, "argument_bytes": argument_bytes, "gathered_bytes": gathered_bytes,
                   "fits": argument_bytes + gathered_bytes <= DEVICE_BYTES,
                   "activations": "not measured"},
        "param_bytes_global": param_bytes_global,
        "op_cost": {k: v for k, v in cost.items() if k != "coll_detail"},
        "collectives": {**cost["coll_detail"], "comm_debug_counts": comm},
        "roofline": rf.to_dict(),
    }
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / _fname(arch, shape_name, multi_pod, quant)).write_text(json.dumps(result, indent=2))
    if verbose:
        r, m = result["roofline"], result["memory"]
        print(f"[{arch} | {shape_name} | {result['mesh']} | {quant}] status ok "
              f"argument={m['argument_bytes'] / 1e9:.2f} GB gathered="
              f"{m['gathered_bytes'] / 1e9:.2f} GB fits={m['fits']}\n"
              f"  roofline: compute={r['t_compute_s']:.4f}s memory={r['t_memory_s']:.4f}s "
              f"collective={r['t_collective_s']:.4f}s dominant={r['dominant']} "
              f"roofline_fraction={r['roofline_fraction']}", flush=True)
    return result


def _fname(arch: str, shape: str, multi_pod: bool, quant: str) -> str:
    return f"{arch}__{shape}__{'multi' if multi_pod else 'single'}__{quant}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all", help="an arch id, or all 12")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--quant", default="bf16", choices=["bf16", "w4a16", "w4a8", "w4a4"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-comm-check", action="store_true",
                    help="skip holding the collectives to CommDebugMode's (half the time)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_SETS) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    outdir = Path(args.out)

    failures = []
    for arch in archs:
        applicable = applicable_shapes(get_config(arch))
        for shape in shapes:
            if applicable[shape] != "run":
                print(f"[{arch} | {shape}] SKIP: {applicable[shape]}")
                outdir.mkdir(parents=True, exist_ok=True)
                for mp in meshes:
                    (outdir / _fname(arch, shape, mp, args.quant)).write_text(json.dumps({
                        "arch": arch, "shape": shape, "quant": args.quant,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": "skip", "reason": applicable[shape],
                    }, indent=2))
                continue
            for mp in meshes:
                fname = _fname(arch, shape, mp, args.quant)
                if args.skip_existing and (outdir / fname).exists():
                    existing = json.loads((outdir / fname).read_text())
                    if existing.get("status") == "ok":
                        print(f"[{arch} | {shape} | {fname}] exists, skipping")
                        continue
                try:
                    run_cell(arch, shape, mp, args.quant, outdir,
                             comm_check=not args.no_comm_check)
                except Exception as e:  # a failed cell is recorded and the sweep goes on
                    traceback.print_exc()
                    failures.append((arch, shape, mp, str(e)))
                    outdir.mkdir(parents=True, exist_ok=True)
                    (outdir / fname).write_text(json.dumps({
                        "arch": arch, "shape": shape, "quant": args.quant,
                        "mesh": "2x16x16" if mp else "16x16",
                        "status": "fail", "error": str(e)[-2000:],
                    }, indent=2))
                    print(f"[{arch} | {shape} | {'2x16x16' if mp else '16x16'} | "
                          f"{args.quant}] status fail: {str(e)[:200]}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nAll dry-run cells ran.")


if __name__ == "__main__":
    main()
