"""Training launcher of the port: the step (loss -> gradients -> optional
int8 gradient compression -> AdamW) and the fault-tolerant supervision
loop, as the reference's ``repro/launch/train.py``.

The state is the model itself, its weights made ``nn.Parameter`` s
(``models.common.trainable``), and the optimizer state keyed by the
parameters' names. A step updates both in place and returns them with the
loss; ``TrainLoop`` checkpoints them, and on a failure restores the latest
checkpoint over them, parameters and moments alike, so a step that failed
halfway through its in-place update leaves no trace.

Restart rule, a held difference: on a failure before the first checkpoint
the reference (``repro/launch/train.py:121-129``) restarts the data stream
at ``start_step`` but keeps ``params`` / ``opt_state`` as the last
successful step left them (its loop variables); the port restores the
state the run started from (host copies taken before the first step,
dropped at the first save), since its steps update the state in place and
a step that failed halfway would otherwise leave a torn state.

Under a mesh context (``models.context``) the step is the reference's
sharded step: ``init_train_state`` lays the parameters out as DTensors per
``launch.sharding.param_specs`` and the moments per ``opt_state_specs``
(ZeRO-1 for replicated parameters), the step lays the batch out per
``batch_specs``. Every rank builds the same global batch and keeps its dp
rows. A step gathers every parameter (``context.gathered``: ZeRO-3's
all-gather; the experts stay split over the ep axis for the EP path),
runs the model's loss on its rows (the CE's sums taken over dp, so every
rank has the global loss), seeds its backward with ``1 / world`` and gets
each parameter's gradient reduced onto the parameter's placements; then
the optional int8 round trip and AdamW on the moments' shards.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import from_host, host_copies, restore_into
from repro_torch.configs import ModelConfig
from repro_torch.interop import to_torch
from repro_torch.launch.sharding import (
    batch_specs,
    make_shardings,
    opt_state_specs,
    param_specs,
)
from repro_torch.models.common import trainable
from repro_torch.models.context import MeshContext, gathered, get_mesh_context
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamW
from repro_torch.optim.grad_compression import compress_grads_int8, decompress_grads_int8

__all__ = ["StragglerMonitor", "TrainLoop", "batch_to_device", "distribute_batch",
           "distribute_params", "init_train_state", "make_train_step", "placement_mismatches"]


def batch_to_device(batch: dict, device) -> dict:
    """A batch's arrays (numpy, bf16 by dtype name, or tensors) on ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else to_torch(v, device)
            for k, v in batch.items()}


def distribute_batch(cfg: ModelConfig, batch: dict, ctx: MeshContext, device) -> dict:
    """The global batch as DTensors per ``batch_specs`` (each rank keeps
    its dp rows); a batch already of DTensors as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if all(isinstance(v, DTensor) for v in batch.values()):
        return batch
    batch = batch_to_device(batch, device)
    specs = batch_specs(cfg, batch, ctx)
    dp = tuple(ctx.dp_axes) or None
    if any(s[0] != dp for s in specs.values()) and dp:
        # a replicated batch would count every row once a dp rank
        raise ValueError(f"the batch's leading dim must divide over the dp axes {dp}: "
                         f"{ {k: tuple(v.shape) for k, v in batch.items()} }")
    pl = make_shardings(ctx.mesh, specs)
    return {k: distribute_tensor(v, ctx.mesh, pl[k]) for k, v in batch.items()}


def distribute_params(cfg: ModelConfig, params: torch.nn.Module, ctx: MeshContext,
                      rules=None) -> torch.nn.Module:
    """In place: every parameter a DTensor laid out per ``param_specs``
    (``rules`` replaces the table) on the context's mesh, from the full
    tensor every rank holds. Returns the model."""
    from torch.distributed.tensor import distribute_tensor

    pl = make_shardings(ctx.mesh, param_specs(cfg, params, ctx, rules=rules))
    for name, p in list(params.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        owner = params.get_submodule(mod) if mod else params
        owner._parameters[leaf] = torch.nn.Parameter(
            distribute_tensor(p.detach(), ctx.mesh, pl[name]))
    return params


def placement_mismatches(cfg: ModelConfig, params, opt_state, batch: dict,
                         ctx: MeshContext) -> list:
    """(leaf, placements found, placements the table gives) for every
    parameter, moment and batch leaf not laid out as the table says on the
    context's mesh; [] when all are."""
    from torch.distributed.tensor import DTensor

    named = dict(params.named_parameters())
    pspecs = param_specs(cfg, params, ctx)
    want = {f"params|{n}": s for n, s in make_shardings(ctx.mesh, pspecs).items()}
    adam = opt_state if hasattr(opt_state, "mu") else opt_state[0]  # (AdamWState, ef)
    for n, s in make_shardings(ctx.mesh, opt_state_specs(cfg, params, pspecs, ctx)).items():
        want[f"mu|{n}"] = want[f"nu|{n}"] = s
    want.update((f"batch|{k}", s) for k, s in
                make_shardings(ctx.mesh, batch_specs(cfg, batch, ctx)).items())
    got = {**{f"params|{n}": p for n, p in named.items()},
           **{f"mu|{n}": t for n, t in adam.mu.items()},
           **{f"nu|{n}": t for n, t in adam.nu.items()},
           **{f"batch|{k}": v for k, v in batch.items()}}
    out = []
    for k, s in want.items():
        found = tuple(got[k].placements) if isinstance(got[k], DTensor) else None
        if found != tuple(s):
            out.append((k, found, tuple(s)))
    return out


def _expert_kept(name: str, p, ctx: MeshContext) -> bool:
    """An expert weight split over E on the ep axis: the EP path gathers
    it itself, keeping its shard (``moe_layer._moe_ep``)."""
    from torch.distributed.tensor import Shard

    if ctx.ep_size == 1 or ".moe.experts." not in name:
        return False
    i = p.device_mesh.mesh_dim_names.index(ctx.ep_axis)
    return p.placements[i] == Shard(0)


def _sharded_loss(model, params, cfg: ModelConfig, batch: dict, ctx: MeshContext):
    """The loss on this rank's dp rows with every parameter gathered, its
    backward seeded with ``1 / world``: each parameter's ``.grad`` is then
    the global loss's gradient in the parameter's placements."""
    from torch.nn.utils.stateless import _reparametrize_module

    named = dict(params.named_parameters())
    views = {n: gathered(p) for n, p in named.items() if not _expert_kept(n, p, ctx)}
    local = {k: v.to_local() for k, v in batch.items()}
    world = ctx.mesh.size()
    # the backward inside: the layers' remat recomputes with the views
    with _reparametrize_module(params, views):
        loss = model.loss_fn(params, cfg, local)
        (loss / world if world > 1 else loss).backward()
    return loss


def make_train_step(cfg: ModelConfig, opt: AdamW, grad_compress: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and its gradients (a parameter the loss does not reach gets a
    zero gradient, as ``jax.value_and_grad`` gives it), with
    ``grad_compress`` the int8 round trip with error feedback (``opt_state``
    is then (AdamWState, ef)), then AdamW, in place."""
    model = get_model(cfg)

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        ctx = get_mesh_context()
        for p in named.values():
            p.grad = None
        if ctx.mesh is None:
            dev = next(iter(named.values())).device
            loss = model.loss_fn(params, cfg, batch_to_device(batch, dev))
            loss.backward()
        else:
            dev = next(iter(named.values())).to_local().device
            loss = _sharded_loss(model, params, cfg, distribute_batch(cfg, batch, ctx, dev), ctx)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
        if grad_compress:
            # the int8 round trip the data-parallel all-reduce would carry
            adam_state, ef = opt_state
            q, s, ef = compress_grads_int8(grads, ef, cfg)
            params, adam_state = opt.update(decompress_grads_int8(q, s), adam_state, params)
            return params, (adam_state, ef), loss.detach()
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return train_step


def init_train_state(cfg: ModelConfig, opt: AdamW, seed: int = 0, grad_compress: bool = False,
                     device=None):
    """(params, opt_state): the family's ``init_params`` from ``seed`` made
    trainable, AdamW's zero moments (and zero error feedback with
    ``grad_compress``), on the card unless ``device`` says otherwise.
    Under a mesh context the parameters are DTensors per ``param_specs``
    (every rank makes the same full init first) and the moments per
    ``opt_state_specs``."""
    params = trainable(get_model(cfg).init_params(cfg, seed=seed, device=resolve_device(device)))
    ctx = get_mesh_context()
    placements = None
    if ctx.mesh is not None:
        pspecs = param_specs(cfg, params, ctx)
        placements = make_shardings(ctx.mesh, opt_state_specs(cfg, params, pspecs, ctx))
        distribute_params(cfg, params, ctx)
    opt_state = opt.init(params, placements)
    if grad_compress:
        return params, (opt_state, {n: torch.zeros_like(p)
                                    for n, p in params.named_parameters()})
    return params, opt_state


# ---------------------------------------------------------------------------
# supervision loop: checkpoint/restart + straggler monitoring
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than ``threshold`` x EWMA.

    On a real cluster the flag feeds preemption/rescheduling; here it is the
    hook point (and is unit-tested with injected delays)."""

    alpha: float = 0.1
    threshold: float = 2.0
    ewma: Optional[float] = None
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = self.ewma is not None and dt > self.threshold * self.ewma
        self.ewma = dt if self.ewma is None else (1 - self.alpha) * self.ewma + self.alpha * dt
        if is_straggler:
            self.flagged.append((step, dt))
        return is_straggler


def _block_until_ready(loss: torch.Tensor) -> None:
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)


class TrainLoop:
    """Fault-tolerant training driver.

    * periodic async checkpoints (manager handles atomic publish/retention)
    * on step failure: restore latest checkpoint and continue (max_restarts);
      with none, the state the run started from (its host copies)
    * data pipeline is resumed deterministically from the checkpointed step
    """

    def __init__(self, cfg: ModelConfig, step_fn, ckpt_manager, data_iter_factory,
                 ckpt_every: int = 100, max_restarts: int = 3,
                 monitor: Optional[StragglerMonitor] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.data_iter_factory = data_iter_factory
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.monitor = monitor or StragglerMonitor()
        self.restarts = 0

    def run(self, params, opt_state, start_step: int, num_steps: int,
            fail_injector: Optional[Callable[[int], None]] = None):
        """Returns (params, opt_state, losses, end_step)."""
        step = start_step
        losses = []
        data = self.data_iter_factory(step)
        # the restore point until the first checkpoint: the steps update the
        # state in place
        initial = None if self.ckpt.list_steps() else host_copies(
            {"params": params, "opt": opt_state})
        while step < num_steps:
            try:
                batch = next(data)
                if fail_injector is not None:
                    fail_injector(step)
                t0 = time.monotonic()
                params, opt_state, loss = self.step_fn(params, opt_state, batch)
                _block_until_ready(loss)
                self.monitor.observe(step, time.monotonic() - t0)
                losses.append(float(loss))
                step += 1
                if step % self.ckpt_every == 0:
                    initial = None  # the checkpoint is the restore point now
                    self.ckpt.save(step, {"params": params, "opt": opt_state})
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                template = {"params": params, "opt": opt_state}
                self.ckpt.wait()  # publish a save still being written first
                restored = self.ckpt.restore_latest(like=template)
                if restored is None:
                    if initial is None:  # a save that failed left no restore point
                        raise
                    # no checkpoint yet: the initial state, the stream from its step
                    restored = start_step, restore_into(template, from_host(*initial))
                step, state = restored
                params, opt_state = state["params"], state["opt"]
                data = self.data_iter_factory(step)
        self.ckpt.save(step, {"params": params, "opt": opt_state})
        self.ckpt.wait()
        return params, opt_state, losses, step
