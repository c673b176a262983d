"""One engine step as one captured CUDA graph: the port's counterpart of the
reference's ``jax.jit`` of a step (``repro/launch/serve.py``: the decode
step at ``:722``, the ragged step at ``:751``).

A :class:`StepGraph` owns one static input buffer per step input and the
step function, which reads only those buffers and tensors that live as long
as the engine (the parameters, the KV state the steps update in place).
Each call loads the step's host arrays into the buffers (pinned staging,
``non_blocking``: no host sync) and then, on the card:

1. the first step runs eagerly on the stream that will capture, and its
   result is used: it builds the kernels, their cached launch arguments and
   cuBLAS's state on that stream;
2. the second step is captured with ``torch.cuda.graph``, which runs
   nothing, and is replayed at once for its own result;
3. every later step replays the graph.

Allocations inside the step (wrapper outputs and scratch) come from the
graph's private pool, which lives as long as the graph. The kernel wrappers
count launches and routes on the host, so a replay alone would count
nothing: the capture's counts are taken back and kept as the graph's
deltas, added once per replay. A failed capture raises, and so does a
replay after ``dispatch.set_fusion`` / ``set_force_ref`` changed what the
capture recorded; nothing falls back to the eager step. Off the card, or
with capture off, every step runs eagerly from the same buffers.

:func:`sync_point` marks a sanctioned host sync (the logits download, the
position read, the capture): it lifts ``torch.cuda.set_sync_debug_mode``,
which ``analysis.sanitizers.guarded_decode`` sets to "error", for its
region.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import cuda_launch, dispatch

__all__ = ["StepGraph", "sync_point", "upload"]


@contextlib.contextmanager
def sync_point(device: torch.device):
    """A sanctioned host sync on ``device``: sync-debug mode is off for the
    region and restored after it (nothing to do off the card)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def upload(a, device: torch.device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Host array ``a`` on ``device`` with no host sync: staged in pinned
    memory (a block of the pinned allocator, held until the copy ran) and
    copied with ``non_blocking=True``; into ``out`` (in its dtype) when
    given, else into a new tensor."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if out is None:
        out = torch.empty(host.shape, dtype=host.dtype, device=device)
    host = host.to(out.dtype)
    if out.device.type == "cuda":
        host = host.pin_memory()
    return out.copy_(host, non_blocking=True)


def _flags() -> tuple:
    return dispatch.fusion_enabled(), dispatch.force_ref_enabled()


def _minus(after: dict, before: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)
            if after.get(k, 0) != before.get(k, 0)}


class StepGraph:
    """One engine mode's step over static input buffers: ``fn(**buffers)``
    returns the step's output tensor, ``buffers`` maps each input name to
    its static tensor on ``device``. With ``capture`` (a CUDA device only)
    the step is captured once and replayed; otherwise it runs eagerly.
    ``captures`` and ``replays`` count what the graph did."""

    def __init__(self, fn: Callable[..., torch.Tensor], buffers: dict, device, *,
                 capture: bool):
        device = torch.device(device)
        if capture and device.type != "cuda":
            raise ValueError(f"a step graph is captured on a CUDA device, not on {device}")
        self.fn, self.buffers, self.device, self.capture = fn, buffers, device, capture
        self.steps = 0
        self.captures = 0
        self.replays = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None  # the captured output, in the graph's pool
        self.launch_delta: dict = {}
        self.route_delta: dict = {}
        self._flags: Optional[tuple] = None
        self._stream = None

    def load(self, **arrays) -> None:
        """Copy one step's host arrays into the static buffers (no host
        sync); a shape other than the buffer's raises."""
        for name, a in arrays.items():
            buf = self.buffers[name]
            if tuple(np.shape(a)) != tuple(buf.shape):
                raise ValueError(f"step input {name!r} has shape {tuple(np.shape(a))}, its "
                                 f"static buffer {tuple(buf.shape)}")
            upload(a, self.device, out=buf)

    def __call__(self, **arrays) -> torch.Tensor:
        """Load one step's host inputs (every buffer's) and run the step.
        Returns its output; once captured, that is the graph's static output
        tensor, so read it before the next call."""
        if set(arrays) != set(self.buffers):
            raise ValueError(f"step inputs {sorted(arrays)}, the graph takes "
                             f"{sorted(self.buffers)}")
        self.load(**arrays)
        self.steps += 1
        if not self.capture:
            return self.fn(**self.buffers)
        if self.steps == 1:
            return self._warm_up()
        if self.graph is None:
            self._capture()
        return self.replay()

    def _warm_up(self) -> torch.Tensor:
        main = torch.cuda.current_stream(self.device)
        self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = self.fn(**self.buffers)
        main.wait_stream(self._stream)
        out.record_stream(main)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph synchronises the device before it captures: a
        # sanctioned sync, once per engine
        with sync_point(self.device):
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.graph(graph, stream=self._stream):
                out = self._record()
        self.graph, self.out, self._flags = graph, out, _flags()
        self.captures += 1

    def _record(self) -> torch.Tensor:
        """Run the step function, take back the launch and route counts it
        added and keep them as the per-replay deltas."""
        launches, routes = cuda_launch.launch_counts(), dispatch.dispatch_counters()
        out = self.fn(**self.buffers)
        self.launch_delta = _minus(cuda_launch.launch_counts(), launches)
        self.route_delta = _minus(dispatch.dispatch_counters(), routes)
        cuda_launch.add_launch_counts({k: -v for k, v in self.launch_delta.items()})
        dispatch.add_dispatch_counts({k: -v for k, v in self.route_delta.items()})
        return out

    def replay(self) -> torch.Tensor:
        """Replay the captured step on the current stream and count its
        launches and routes once; returns the static output. Raises when
        nothing was captured or the dispatch flags moved since the capture."""
        if self.graph is None:
            raise RuntimeError("no captured step graph to replay")
        if _flags() != self._flags:
            raise RuntimeError(f"dispatch flags (fusion, force_ref) are {_flags()}, the step "
                               f"graph was captured with {self._flags}: build a new engine")
        self.graph.replay()
        self._count_replay()
        return self.out

    def _count_replay(self) -> None:
        cuda_launch.add_launch_counts(self.launch_delta)
        dispatch.add_dispatch_counts(self.route_delta)
        self.replays += 1
