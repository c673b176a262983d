"""Training launcher of the port: the step (loss -> gradients -> optional
int8 gradient compression -> AdamW) and the fault-tolerant supervision
loop, as the reference's ``repro/launch/train.py``.

The state is the model itself, its weights made ``nn.Parameter`` s
(``models.common.trainable``), and the optimizer state keyed by the
parameters' names. A step updates both in place and returns them with the
loss; ``TrainLoop`` checkpoints them, and on a failure restores the latest
checkpoint over them, parameters and moments alike, so a step that failed
halfway through its in-place update leaves no trace. With no checkpoint
yet it restores the state it started from (host copies taken before the
first step, dropped at the first save) and starts the data stream over, as
the reference, whose state is immutable, goes back to its initial state.
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
from repro_torch.models.common import trainable
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamW
from repro_torch.optim.grad_compression import compress_grads_int8, decompress_grads_int8

__all__ = ["StragglerMonitor", "TrainLoop", "batch_to_device", "init_train_state",
           "make_train_step"]


def batch_to_device(batch: dict, device) -> dict:
    """A batch's arrays (numpy, bf16 by dtype name, or tensors) on ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else to_torch(v, device)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt: AdamW, grad_compress: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss and its gradients (a parameter the loss does not reach gets a
    zero gradient, as ``jax.value_and_grad`` gives it), with
    ``grad_compress`` the int8 round trip with error feedback (``opt_state``
    is then (AdamWState, ef)), then AdamW, in place."""
    model = get_model(cfg)

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        dev = next(iter(named.values())).device
        for p in named.values():
            p.grad = None
        loss = model.loss_fn(params, cfg, batch_to_device(batch, dev))
        loss.backward()
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
    ``grad_compress``), on the card unless ``device`` says otherwise."""
    params = trainable(get_model(cfg).init_params(cfg, seed=seed, device=resolve_device(device)))
    opt_state = opt.init(params)
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
