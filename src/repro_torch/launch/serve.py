"""Continuous-batching serving engine of the port: the bucketed, dense-cache
configuration of the reference's ``ContinuousBatchingEngine``
(``repro/launch/serve.py``).

* Every slot of the static batch is an independent timeline with its own
  position (``state["pos"] (B,)``); requests of different lengths decode in
  lock-step.
* Admission runs the model's prefill once on a batch-1 state, the prompt
  padded to a power-of-two bucket (at least 8); the ``length`` argument
  keeps the padded math exact. ``compile_stats()`` reports the bucket
  inventory (PyTorch runs eagerly, so a bucket is a launch shape, not a
  compiled executable).
* Sampling is per request (greedy / temperature / top-k) on the host, with
  ``np.random.default_rng(seed)`` as in the reference.
* Request lifecycle: ``NEW -> QUEUED -> PREFILL -> DECODE -> {DONE,
  FAILED}``; a finite-logits guard fails only the slot whose logits went
  NaN/Inf (``error="nan_logits"``).

With quantized params the engine pre-merges sibling packs (``fuse_params``)
when fusion is on, so q/k/v and gate/up each run as one kernel launch. The
paged KV pool, the ragged step, speculation and preemption are later slices
of the port and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models import common as C
from repro_torch.models.registry import get_model

__all__ = ["SamplingParams", "RequestState", "Request", "EngineStalledError",
           "ContinuousBatchingEngine"]


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling. ``temperature <= 0`` means greedy; ``top_k > 0``
    restricts sampling to the k most likely tokens."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


class RequestState:
    """Request lifecycle states; ``TERMINAL`` states are never left. The
    engine enforces the transition table, so an illegal edge raises."""

    NEW = "NEW"
    QUEUED = "QUEUED"
    PREFILL = "PREFILL"
    DECODE = "DECODE"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"
    TIMED_OUT = "TIMED_OUT"
    PREEMPTED = "PREEMPTED"
    TERMINAL = frozenset({DONE, FAILED, CANCELLED, TIMED_OUT})


_TRANSITIONS: dict[str, frozenset] = {
    RequestState.NEW: frozenset({RequestState.QUEUED}),
    RequestState.QUEUED: frozenset({
        RequestState.PREFILL, RequestState.CANCELLED, RequestState.TIMED_OUT,
    }),
    RequestState.PREFILL: frozenset({
        RequestState.DECODE, RequestState.FAILED, RequestState.CANCELLED,
        RequestState.TIMED_OUT, RequestState.PREEMPTED,
    }),
    RequestState.DECODE: frozenset({
        RequestState.DONE, RequestState.FAILED, RequestState.CANCELLED,
        RequestState.TIMED_OUT, RequestState.PREEMPTED,
    }),
    RequestState.PREEMPTED: frozenset({
        RequestState.PREFILL, RequestState.CANCELLED, RequestState.TIMED_OUT,
    }),
    RequestState.DONE: frozenset(),
    RequestState.FAILED: frozenset(),
    RequestState.CANCELLED: frozenset(),
    RequestState.TIMED_OUT: frozenset(),
}

_FINISH_COUNTER = {
    RequestState.DONE: "requests_done",
    RequestState.FAILED: "requests_failed",
    RequestState.TIMED_OUT: "requests_timed_out",
}


class _SlotFault(RuntimeError):
    """A slot-attributable fault during admission, with its reason code."""

    def __init__(self, code: str, detail: str):
        super().__init__(detail)
        self.code = code
        self.detail = detail


def _fault_of(e: Exception) -> tuple[str, str]:
    if isinstance(e, _SlotFault):
        return e.code, e.detail
    return "prefill_exception", f"{type(e).__name__}: {e}"


class EngineStalledError(RuntimeError):
    """``run_until_done`` exhausted its step budget with live work left; the
    unfinished requests are marked ``TIMED_OUT`` first."""


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request: a prompt, a token quota and sampling params.

    The engine writes results back: ``out`` (generated ids), ``status`` (a
    :class:`RequestState` value), ``done``, ``truncated`` (stopped by cache
    capacity before ``max_new``), ``error``/``error_detail`` on failure, and
    the timestamps ``t_submit`` / ``t_first_token`` / ``t_done`` plus one
    ``token_times`` entry per token (``time.monotonic``). ``on_token(request,
    token)`` fires once per emitted token; a raising callback is detached
    with a warning."""

    prompt: Any  # (S,) integer token ids
    max_new: int = 16
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    on_token: Optional[Callable] = dataclasses.field(default=None, repr=False)
    t_submit: Optional[float] = dataclasses.field(default=None, repr=False)
    t_first_token: Optional[float] = dataclasses.field(default=None, repr=False)
    t_done: Optional[float] = dataclasses.field(default=None, repr=False)
    token_times: list = dataclasses.field(default_factory=list, repr=False)
    truncated: bool = False
    request_id: Optional[str] = None
    status: str = RequestState.NEW
    error: Optional[str] = None
    error_detail: Optional[str] = None
    _last_logits: Any = dataclasses.field(default=None, repr=False)
    _rng: Any = dataclasses.field(default=None, repr=False)
    _prompt_host: Any = dataclasses.field(default=None, repr=False)


_LATER = {
    "paged": "ROADMAP Queue 1 item 5 (paged KV runtime)",
    "ragged": "ROADMAP Queue 1 item 6 (ragged step)",
    "speculation": "ROADMAP Queue 1 item 7 (speculative decoding)",
    "preemption": "ROADMAP Queue 1 item 8 (lifecycle, faults)",
}


class ContinuousBatchingEngine:
    """Continuous-batching server over a static batch of ``batch_slots``
    independent slot timelines with a dense per-slot KV cache: per-slot
    admission and eviction, per-request sampling, lock-step decode, and
    throughput accounting. Runs on the card unless ``device`` says
    otherwise; ``params`` must already live there."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4, max_len: int = 128,
                 *, device=None, on_truncation: str = "warn",
                 paged: bool = False, ragged: bool = False, speculation: bool = False,
                 preemption: bool = False):
        for flag, on in (("paged", paged), ("ragged", ragged), ("speculation", speculation),
                         ("preemption", preemption)):
            if on:
                raise NotImplementedError(
                    f"{flag}=True is not ported yet: it comes with {_LATER[flag]}"
                )
        if on_truncation not in ("warn", "reject"):
            raise ValueError(f"on_truncation must be 'warn' or 'reject', got {on_truncation!r}")
        from repro_torch.core.twinquant import fuse_params
        from repro_torch.kernels.dispatch import dispatch_counters, fusion_enabled

        self.device = resolve_device(device)
        if params.embed.device != self.device:
            raise ValueError(f"params live on {params.embed.device}, engine on {self.device}")
        self.cfg = cfg
        self.model = get_model(cfg)
        self.params = fuse_params(params) if fusion_enabled() else params
        self.batch = batch_slots
        self.max_len = max_len
        self.on_truncation = on_truncation
        self.state = self.model.init_decode_state(cfg, batch_slots, max_len, device=self.device)
        # constant zero batch-1 state: the prefill source of every admission
        self._sub_template = self.model.init_decode_state(cfg, 1, max_len, device=self.device)
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.queue: deque[Request] = deque()
        self._steps = 0
        self._next_rid = 0
        self._prefill_shapes: dict[int, int] = {}
        self.stats = {
            "prefill_tokens": 0, "prefill_s": 0.0,
            "decode_tokens": 0, "decode_steps": 0, "decode_s": 0.0,
            "requests_done": 0, "requests_truncated": 0,
            "requests_failed": 0, "requests_timed_out": 0,
        }
        self._dispatch0 = dispatch_counters()

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Enqueue a request and admit it at once if a slot is free. Returns
        True when it went straight into a slot. Invalid requests (not 1-D,
        not integer, token ids outside the vocab, no room in ``max_len``) are
        rejected here, before any queue or slot state changes."""
        if req.status in RequestState.TERMINAL or req.done:
            return True
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D (S,), got shape {prompt.shape}")
        n = int(prompt.shape[0])
        if n and not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(f"prompt must hold integer token ids, got dtype {prompt.dtype}")
        if n and (int(prompt.min()) < 0 or int(prompt.max()) >= self.cfg.vocab):
            bad = [int(t) for t in prompt if not 0 <= int(t) < self.cfg.vocab][:8]
            raise ValueError(
                f"prompt contains token ids outside the model vocab [0, {self.cfg.vocab}): "
                f"{bad} — rejected at submit()"
            )
        if not 1 <= n < self.max_len:
            raise ValueError(f"prompt length {n} must leave room in max_len={self.max_len}")
        if n + req.max_new > self.max_len:
            msg = (f"request will truncate: prompt {n} + max_new {req.max_new} > max_len "
                   f"{self.max_len}")
            if self.on_truncation == "reject":
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=2)
        if any(s is req for s in self.slots) or any(q is req for q in self.queue):
            return any(s is req for s in self.slots)
        if req.request_id is None:
            req.request_id = f"req-{self._next_rid}"
            self._next_rid += 1
        if req.t_submit is None:
            req.t_submit = time.monotonic()
        req._prompt_host = prompt.astype(np.int32)
        self._set_status(req, RequestState.QUEUED)
        self.queue.append(req)
        self._admit()
        return any(s is req for s in self.slots)

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Power-of-two prompt bucket (min 8), capped at the cache capacity."""
        return max(n, min(1 << max(3, (n - 1).bit_length()), cap))

    def _run_prefill(self, tokens: np.ndarray):
        """One batched prefill of the prompt, bucket-padded. Returns
        (last_logits np (V,), sub_state)."""
        s_real = len(tokens)
        bucket = self._bucket(s_real, self.max_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :s_real] = tokens
        self._prefill_shapes[bucket] = self._prefill_shapes.get(bucket, 0) + 1
        t0 = time.monotonic()
        logits, sub = self.model.prefill(
            self.params, self.cfg, torch.as_tensor(toks, device=self.device),
            self._sub_template, length=torch.tensor([s_real], device=self.device),
        )
        last = logits[0, -1].float().cpu().numpy()  # sync-point
        self.stats["prefill_s"] += time.monotonic() - t0
        self.stats["prefill_tokens"] += s_real
        return last, sub

    def _insert(self, sub: dict, i: int) -> None:
        """Splice a batch-1 prefill state into slot ``i`` (in place)."""
        self.state["k"][:, i] = sub["k"][:, 0]
        self.state["v"][:, i] = sub["v"][:, 0]
        self.state["pos"][i] = sub["pos"][0]

    def _admit(self) -> None:
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return
            self._admit_one(self.queue.popleft(), free[0])

    def _admit_one(self, req: Request, i: int) -> None:
        self._set_status(req, RequestState.PREFILL)
        try:
            last, sub = self._run_prefill(req._prompt_host)
            if C.nonfinite_rows(last[None, :], self.cfg.vocab):
                raise _SlotFault("nan_logits", "non-finite prefill logits")
            self._insert(sub, i)
        except Exception as e:  # noqa: BLE001 — a faulty request fails alone
            self._finish(req, RequestState.FAILED, *_fault_of(e))
            return
        req._last_logits = last
        if req._rng is None:
            req._rng = np.random.default_rng(req.sampling.seed)
        self._set_status(req, RequestState.DECODE)
        self.slots[i] = req

    # -- lifecycle ----------------------------------------------------------

    def _set_status(self, req: Request, new: str) -> None:
        if new not in _TRANSITIONS.get(req.status, frozenset()):
            raise RuntimeError(f"illegal request state transition {req.status} -> {new} "
                               f"(request {req.request_id})")
        req.status = new

    def _finish(self, req: Request, status: str, code: Optional[str] = None,
                detail: Optional[str] = None) -> None:
        self._set_status(req, status)
        req.done = True
        if req.t_done is None:
            req.t_done = time.monotonic()
        if code is not None:
            req.error = code
            req.error_detail = detail
        req._last_logits = None
        self.stats[_FINISH_COUNTER[status]] += 1

    def _evict(self, i: int, req: Request, truncated: bool) -> None:
        self.slots[i] = None
        req.truncated = truncated
        if truncated:
            self.stats["requests_truncated"] += 1
        self._finish(req, RequestState.DONE)

    # -- sampling -----------------------------------------------------------

    def _sample(self, req: Request) -> int:
        logits = req._last_logits[: self.cfg.vocab]
        sp = req.sampling
        if sp.temperature <= 0.0:
            return int(np.argmax(logits))
        scaled = logits / sp.temperature
        if 0 < sp.top_k < scaled.shape[0]:
            kth = np.partition(scaled, -sp.top_k)[-sp.top_k]
            scaled = np.where(scaled < kth, -np.inf, scaled)
        p = np.exp(scaled - scaled.max())
        p /= p.sum()
        return int(req._rng.choice(p.shape[0], p=p))

    def _emit_token(self, req: Request, tok: int) -> None:
        now = time.monotonic()
        req.out.append(tok)
        req.token_times.append(now)
        if req.t_first_token is None:
            req.t_first_token = now
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception as e:  # noqa: BLE001 — hostile-consumer guard
                req.on_token = None
                warnings.warn(f"on_token callback for request {req.request_id} raised "
                              f"{type(e).__name__}: {e} — callback detached", stacklevel=2)

    # -- decode -------------------------------------------------------------

    def step(self) -> int:
        """Admit queued work, sample one token per live slot, then run one
        lock-step decode for the slots that still need logits. Returns the
        number of slots live at entry."""
        self._steps += 1
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        tok = np.zeros((self.batch, 1), np.int64)
        pos = self.state["pos"].cpu().numpy()  # sync-point: next write offset per slot
        live = []
        for i in active:
            req = self.slots[i]
            nxt = self._sample(req)
            self._emit_token(req, nxt)
            tok[i, 0] = nxt
            if len(req.out) >= req.max_new:
                self._evict(i, req, truncated=False)
            elif int(pos[i]) >= self.max_len:
                self._evict(i, req, truncated=True)
            else:
                live.append(i)
        if live:
            t0 = time.monotonic()
            logits, self.state = self.model.decode_step(
                self.params, self.cfg, self.state, torch.as_tensor(tok, device=self.device))
            last = logits[:, -1].float().cpu().numpy()  # sync-point
            self.stats["decode_s"] += time.monotonic() - t0
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += len(live)
            bad = set(C.nonfinite_rows(last, self.cfg.vocab))
            for i in live:
                req = self.slots[i]
                if i in bad:
                    self.slots[i] = None
                    self._finish(req, RequestState.FAILED, "nan_logits",
                                 f"non-finite decode logits at engine step {self._steps}")
                else:
                    req._last_logits = last[i]
        self._admit()
        return len(active)

    # -- drivers ------------------------------------------------------------

    def run_until_done(self, max_steps: int = 100_000) -> None:
        """Drive ``step()`` until no slot is live and the queue is empty;
        exhausting ``max_steps`` marks the unfinished requests ``TIMED_OUT``
        and raises :class:`EngineStalledError`."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return
        stranded = [r for r in self.slots if r is not None] + list(self.queue)
        self.slots = [None] * self.batch
        self.queue.clear()
        for req in stranded:
            self._finish(req, RequestState.TIMED_OUT, "engine_stalled",
                         f"run_until_done exhausted {max_steps} steps")
        raise EngineStalledError(
            f"engine stalled after {max_steps} steps with {len(stranded)} request(s) unfinished"
        )

    def serve(self, requests: list[Request], max_steps: int = 100_000) -> list[Request]:
        """Submit all requests and drive the loop to completion; results ride
        on the Request objects."""
        for r in requests:
            self.submit(r)
        self.run_until_done(max_steps)
        return requests

    # -- introspection ------------------------------------------------------

    def compile_stats(self) -> dict:
        """Prefill shape inventory: with prompt bucketing every distinct
        bucket is one launch shape, O(log max_len) under any traffic."""
        return {
            "prefill_traces": len(self._prefill_shapes),
            "prefill_calls": sum(self._prefill_shapes.values()),
            "prefill_buckets": sorted(self._prefill_shapes),
            "decode_traces": 1 if self.stats["decode_steps"] else 0,
        }

    def routing(self) -> dict:
        """Kernel routes taken since this engine was built: {kind/path: n}
        (process-wide counters, so drive engines one after another)."""
        from repro_torch.kernels.dispatch import dispatch_counters

        now = dispatch_counters()
        return {k: v - self._dispatch0.get(k, 0) for k, v in now.items()
                if v - self._dispatch0.get(k, 0) > 0}

    def throughput(self) -> dict:
        """Tokens/s summary from the accounting counters."""
        st = self.stats
        return {
            "decode_tok_s": st["decode_tokens"] / max(st["decode_s"], 1e-9),
            "prefill_tok_s": st["prefill_tokens"] / max(st["prefill_s"], 1e-9),
            "mean_batch_occupancy": st["decode_tokens"] / max(st["decode_steps"], 1),
            "routing": self.routing(),
            **st,
        }
