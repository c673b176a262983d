"""Rank body of the port's 4-rank CPU tests (``test_torch_sharded_step.py``):
imports torch and the port only (never JAX, never a test module), so that
``torch.multiprocessing`` can spawn it.

``run(rank, world, store, out)`` joins a gloo group through the
``FileStore`` at ``store`` and runs every case on a (2, 2) ``("data",
"model")`` mesh; rank 0 saves each case's results (``torch.save``) under
``out``. The parent compares them with the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

BATCH = (4, 64)  # tokens of the sharded steps


def tokens(vocab: int, seed: int = 0) -> np.ndarray:
    """The global batch's tokens, the same on every rank and in the parent:
    Zipf-distributed ids, skewed as text is, so that routing is uneven and
    capacity drops."""
    z = np.random.default_rng(seed).zipf(1.2, BATCH)
    return ((z - 1) % vocab).astype(np.int32)


def context(mesh, fsdp: bool):
    from repro_torch.models.context import MeshContext

    return MeshContext(mesh=mesh, dp_axes=("data",), tp_axis="model", ep_axis="model",
                       fsdp_axes=("data",) if fsdp else ())


def sharded_step(arch: str, fsdp: bool, mesh, seed: int = 0):
    """(loss, {name: gathered gradient}, params, opt_state, grads) of one
    sharded step's loss and gradients (no update) on ``arch``'s reduced
    config."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import _sharded_loss, distribute_batch, init_train_state
    from repro_torch.models.context import mesh_context
    from repro_torch.models.registry import get_model
    from repro_torch.optim import AdamW

    cfg = get_config(arch, reduced=True)
    ctx = context(mesh, fsdp)
    with mesh_context(ctx):
        params, opt_state = init_train_state(cfg, AdamW(), seed=seed, device="cpu")
        toks = tokens(cfg.vocab)
        batch = distribute_batch(cfg, {"tokens": toks, "labels": toks}, ctx, "cpu")
        loss = _sharded_loss(get_model(cfg), params, cfg, batch, ctx)
    grads = {n: p.grad for n, p in params.named_parameters()}
    full = {n: g.full_tensor() for n, g in grads.items()}
    return float(loss.detach()), full, params, opt_state, grads, batch, ctx, cfg


def run(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        _cases(rank, out)
    finally:
        dist.destroy_process_group()


def _save(rank: int, out: str, name: str, obj) -> None:
    if rank == 0:
        torch.save(obj, os.path.join(out, f"{name}.pt"))


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _cases(rank: int, out: str) -> None:
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import init_train_state, placement_mismatches
    from repro_torch.models.context import mesh_context
    from repro_torch.optim import AdamW
    from repro_torch.optim.grad_compression import compress_grads_int8

    mesh = make_debug_mesh((2, 2), device="cpu")
    for arch in ("llama3-8b", "olmoe-1b-7b"):
        for fsdp in (True, False):
            loss, full, params, opt_state, grads, batch, ctx, cfg = sharded_step(arch, fsdp, mesh)
            res = {"loss": loss, "grads": full,
                   "mismatches": placement_mismatches(cfg, params, opt_state, batch, ctx)}
            if arch == "llama3-8b" and fsdp:
                # one amax per whole reference leaf, the per-leaf formula's bits
                q, scales, _ = compress_grads_int8(grads, None, cfg)
                q1, s1, _ = compress_grads_int8(full, None, cfg)
                res["compress"] = {n: (torch.equal(_full(q[n]), q1[n]),
                                       torch.equal(scales[n], s1[n])) for n in q}
            if arch == "llama3-8b" and not fsdp:
                # ZeRO-1: the sharded update against one device's AdamW on
                # the gathered gradients, with the same clip factor
                opt = AdamW()
                before = {n: p.full_tensor().clone() for n, p in params.named_parameters()}
                factor = opt.clip_factor(grads)
                opt.apply(grads, opt_state, params, factor)
                plain = {n: torch.nn.Parameter(t.clone()) for n, t in before.items()}
                st = opt.init(plain)
                opt.apply(full, st, plain, factor)
                res["zero1"] = {
                    n: (torch.equal(p.full_tensor(), plain[n].detach()),
                        torch.equal(opt_state.mu[n].full_tensor(), st.mu[n]),
                        torch.equal(opt_state.nu[n].full_tensor(), st.nu[n]),
                        tuple(opt_state.mu[n].to_local().shape),
                        tuple(str(p) for p in opt_state.mu[n].placements))
                    for n, p in params.named_parameters()}
                res["factor"] = float(factor)
            if arch == "olmoe-1b-7b" and fsdp:
                # elastic restore: saved on (2, 2), restored onto (4, 1)
                ckpt = CheckpointManager(os.path.join(out, "ckpt"), async_save=False)
                saved = {"params": params, "opt": opt_state}
                ckpt.save(1, saved)
                want = {n: p.full_tensor() for n, p in params.named_parameters()}
                mesh41 = make_debug_mesh((4, 1), device="cpu")
                ctx41 = context(mesh41, True)
                with mesh_context(ctx41):
                    like, opt_like = init_train_state(cfg, AdamW(), seed=1, device="cpu")
                    specs = S.param_specs(cfg, like, ctx41)
                    pl = S.make_shardings(mesh41, specs)
                    lay = {f"params|{n}": (mesh41, pl[n]) for n in pl}
                    got = ckpt.restore_like(1, {"params": like, "opt": opt_like}, shardings=lay)
                res["restore41"] = {
                    n: (torch.equal(p.full_tensor(), want[n]), tuple(p.placements) == pl[n])
                    for n, p in got["params"].named_parameters()}
                res["saved"] = want
                res["restore41_mu"] = all(
                    torch.equal(got["opt"].mu[n].full_tensor(), opt_state.mu[n].full_tensor())
                    for n in want)
            _save(rank, out, f"{arch}-{'fsdp' if fsdp else 'zero1'}", res)
