"""Continuous-batching serving engine of the port: the reference's
``ContinuousBatchingEngine`` (``repro/launch/serve.py``) in its bucketed,
paged, ragged and speculative modes.

* Every slot of the static batch is an independent timeline with its own
  position (``state["pos"] (B,)``); requests of different lengths decode in
  lock-step.
* Admission runs the model's prefill once on a batch-1 state, the prompt
  padded to a power-of-two bucket (at least 8); the ``length`` argument
  keeps the padded math exact. Prefill runs eagerly, so a prefill "trace"
  in ``compile_stats()`` is a distinct launch shape.
* Every mode has one step shape: the bucketed or paged decode ``(B, 1)``,
  the speculative verify ``(B, spec_k)``, the ragged step
  ``(token_budget,)``. On the card that step runs as one captured CUDA
  graph, replayed once per step (``launch/step_graph.py``, the reference's
  jitted step): the first step warms up eagerly, the second captures, every
  later one replays. ``step_graphs=False`` runs every step eagerly, as the
  CPU does. Host inputs reach the device through pinned staging with no
  host sync; the engine syncs only at its ``# sync-point`` lines (position
  read, logits download, the capture), which ``analysis.sanitizers.
  guarded_decode`` allows.
* **Paged mode** (``paged=True``): the KV cache lives in page pools shared
  by all slots (``models.common.init_paged_state``); a host-side
  :class:`PageAllocator` owns the free list and refcounts, admission gates
  on free pages and reserves a request's whole timeline up front, and a
  :class:`PrefixCache` maps shared prompt prefixes (whole pages) into new
  slots copy-free so only the suffix is prefilled. Decode attention runs
  through the paged-decode kernel over the pages in use.
* **Ragged mode** (``ragged=True``, needs paged): every step packs one
  decode row per decoding slot, then prompt chunks, into one flat batch of
  ``token_budget`` rows and runs ONE ``ragged_step`` launch through the
  ragged-attention kernel; ``max_chunk_share`` caps the chunk rows a step.
* **Speculation** (``speculation=True``, needs paged, not ragged): each
  decode launch stacks the sampled token and ``spec_k - 1`` self-drafted
  tokens per slot, accepts the longest greedy-matching draft prefix, and
  rolls the rest back by rewinding ``pos``; greedy output equals the plain
  engine's token for token.
* Sampling is per request (greedy / temperature / top-k) on the host, with
  ``np.random.default_rng(seed)`` as in the reference.
* Request lifecycle: ``NEW -> QUEUED -> PREFILL -> DECODE -> {DONE,
  FAILED}``; a finite-logits guard fails only the slot whose logits went
  NaN/Inf (``error="nan_logits"``). Every exit releases the slot's pages
  through ``_release_slot``.

With TwinQuant params (W4A4 / W4A8) the engine pre-merges sibling packs
(``fuse_params``) when fusion is on, so q/k/v and gate/up each run as one
kernel launch. W4A16 params serve unfused, one weight-only launch per
projection (seven a layer), as in the reference.
Preemption is a later slice of the port and raises ``NotImplementedError``.
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
from repro_torch.launch.step_graph import StepGraph, sync_point, upload
from repro_torch.models import common as C
from repro_torch.models.registry import get_model

__all__ = ["SamplingParams", "RequestState", "Request", "EngineStalledError",
           "AllocatorError", "PageAllocator", "PrefixCache", "ContinuousBatchingEngine"]


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
    _prompt: Any = dataclasses.field(default=None, repr=False)  # ragged: prompt being chunked
    _filled: int = dataclasses.field(default=0, repr=False)  # ragged: prompt rows scheduled


# ---------------------------------------------------------------------------
# paged-pool host bookkeeping
# ---------------------------------------------------------------------------


class AllocatorError(AssertionError):
    """A page-allocator bookkeeping violation (double release, unknown page
    id, sharing an unreferenced page), raised with the page id and its
    refcount instead of silently corrupting the free list."""


class PageAllocator:
    """Free-list allocator with refcounts over the global KV page pool.

    A page's refcount is the number of slot block tables mapping it plus one
    if a prefix-cache entry holds it. ``alloc`` hands out ref=1 pages,
    ``share`` adds a reference, ``release`` drops one and returns fully
    freed pages to the free list; ``audit`` asserts that the free list and
    refcounts partition the pool."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free: deque[int] = deque(range(n_pages))
        self.ref = np.zeros(n_pages, np.int32)
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        """Pages currently on the free list."""
        return len(self.free)

    @property
    def n_used(self) -> int:
        """Pages currently mapped or cached (refcount > 0)."""
        return self.n_pages - len(self.free)

    def alloc(self, n: int) -> Optional[list[int]]:
        """Take ``n`` pages off the free list at ref=1; None when the pool
        cannot satisfy the request (admission then waits)."""
        if n > len(self.free):
            return None
        pages = [self.free.popleft() for _ in range(n)]
        for p in pages:
            assert self.ref[p] == 0, f"free page {p} had ref {self.ref[p]}"
            self.ref[p] = 1
        self.peak_used = max(self.peak_used, self.n_used)
        return pages

    def _known(self, p, op: str) -> int:
        p = int(p)
        if not 0 <= p < self.n_pages:
            raise AllocatorError(f"{op} of unknown page {p}: valid page ids are "
                                 f"0..{self.n_pages - 1}")
        return p

    def share(self, pages) -> None:
        """Add one reference to each already referenced page."""
        for p in pages:
            p = self._known(p, "share")
            if self.ref[p] <= 0:
                raise AllocatorError(f"sharing unreferenced page {p} (refcount "
                                     f"{int(self.ref[p])}): only mapped or cached pages can "
                                     "take another reference")
            self.ref[p] += 1

    def release(self, pages) -> None:
        """Drop one reference per page; unreferenced pages return to the
        free list. A page whose refcount is already zero raises."""
        for p in pages:
            p = self._known(p, "release")
            if self.ref[p] <= 0:
                raise AllocatorError(f"double release of page {p} (refcount already "
                                     f"{int(self.ref[p])}): releasing it again would put it "
                                     "on the free list twice")
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self.free.append(p)

    def audit(self) -> None:
        """Assert that the free list and refcounts partition the pool."""
        free = set(self.free)
        assert len(free) == len(self.free), "free list contains duplicates"
        for p in range(self.n_pages):
            if p in free:
                assert self.ref[p] == 0, f"free page {p} has ref {self.ref[p]}"
            else:
                assert self.ref[p] > 0, f"page {p} leaked (ref 0 but not free)"


class _PrefixEntry:
    __slots__ = ("key", "page", "eid", "parent", "children", "tick")


class PrefixCache:
    """Prompt-prefix page cache, hash-chained at page granularity.

    Entry j of a prompt's chain is keyed by (parent entry id, the page's
    token tuple), so a key names the whole token prefix up to that page
    boundary. Only whole pages fully covered by prompt tokens are
    registered, and decode writes land after the prompt, so registered pages
    are never written again. Each entry holds one page reference; ``evict``
    drops least-recently-used leaf entries when admission runs short."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self.entries: dict[tuple, _PrefixEntry] = {}
        self._by_id: dict[int, _PrefixEntry] = {}
        self._next_id = 1
        self._tick = 0

    def __len__(self) -> int:
        return len(self.entries)

    def _key(self, parent: int, prompt, j: int) -> tuple:
        ps = self.page_size
        return (parent, tuple(int(t) for t in prompt[j * ps:(j + 1) * ps]))

    def match(self, prompt) -> tuple[int, list[int]]:
        """Longest cached prefix of whole pages, capped at len(prompt) - 1
        so at least one suffix token is left to give prefill logits.
        Returns (tokens matched, pages)."""
        self._tick += 1
        pages: list[int] = []
        parent = 0
        for j in range((len(prompt) - 1) // self.page_size):
            e = self.entries.get(self._key(parent, prompt, j))
            if e is None:
                break
            e.tick = self._tick
            pages.append(e.page)
            parent = e.eid
        return len(pages) * self.page_size, pages

    def register(self, prompt, pages: list[int]) -> None:
        """Register an admitted prompt's full pages (``pages``: the slot's
        mapped pages in timeline order, shared prefix included)."""
        self._tick += 1
        parent = 0
        for j in range(min(len(prompt) // self.page_size, len(pages))):
            key = self._key(parent, prompt, j)
            e = self.entries.get(key)
            if e is None:
                e = _PrefixEntry()
                e.key, e.page, e.parent = key, pages[j], parent
                e.eid = self._next_id
                self._next_id += 1
                e.children = 0
                self.entries[key] = e
                self._by_id[e.eid] = e
                if parent:
                    self._by_id[parent].children += 1
                self.allocator.share([e.page])
            e.tick = self._tick
            parent = e.eid

    def evict(self, n_free_needed: int) -> int:
        """Drop LRU leaf entries (an inner entry only once its children are
        gone) until the allocator has ``n_free_needed`` free pages or nothing
        is evictable. Returns the entries evicted."""
        evicted = 0
        while self.allocator.n_free < n_free_needed:
            leaves = [e for e in self.entries.values() if e.children == 0]
            if not leaves:
                break
            e = min(leaves, key=lambda e: e.tick)
            del self.entries[e.key]
            del self._by_id[e.eid]
            if e.parent:
                self._by_id[e.parent].children -= 1
            self.allocator.release([e.page])
            evicted += 1
        return evicted


def _ngram_draft(hist: list, k: int) -> list:
    """Self-drafting for speculative decode: the ``k`` tokens that followed
    the most recent earlier occurrence of the history's trailing n-gram
    (n = 3, 2, 1, longest first), else the last token repeated. Host-side
    and deterministic; verification makes any draft safe."""
    n = len(hist)
    if n == 0:
        return [0] * k
    for m in (3, 2, 1):
        if n <= m:
            continue
        key = hist[n - m:]
        for j in range(n - m - 1, -1, -1):
            if hist[j:j + m] == key:
                cont = hist[j + m:j + m + k]
                if cont:
                    return cont + [cont[-1]] * (k - len(cont))
                break
    return [hist[-1]] * k


_LATER = {"preemption": "ROADMAP Queue 1 item 3 (lifecycle, faults)"}


class ContinuousBatchingEngine:
    """Continuous-batching server over a static batch of ``batch_slots``
    independent slot timelines: per-slot admission and eviction, per-request
    sampling, lock-step decode, and throughput accounting. Runs on the card
    unless ``device`` says otherwise; ``params`` must already live there.

    ``paged=True`` keeps the KV cache in page pools behind block tables
    (``page_size`` rows a page, ``n_pages`` pages, default enough for every
    slot's full timeline) with the prefix cache on unless
    ``prefix_caching=False``. ``ragged=True`` (needs paged) serves every
    step as one flat launch of ``token_budget`` rows, prompt chunks capped
    at ``max_chunk_share`` of it. ``speculation=True`` (needs paged, not
    ragged) verifies ``spec_k`` rows per slot per launch, drafted by
    ``draft_fn(req, k)`` when given, else by the n-gram self-draft. Ragged
    or speculation without their prerequisites warn and serve bucketed.

    ``step_graphs`` (default: on for a CUDA device, off elsewhere) runs the
    mode's step as one captured CUDA graph; ``False`` runs it eagerly, and
    ``True`` off a CUDA device raises. A failed capture raises; it never
    falls back to the eager step."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4, max_len: int = 128,
                 *, device=None, on_truncation: str = "warn", paged: bool = False,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefix_caching: bool = True, ragged: bool = False, token_budget: int = 64,
                 max_chunk_share: float = 1.0, speculation: bool = False, spec_k: int = 4,
                 draft_fn: Optional[Callable] = None, preemption: bool = False,
                 step_graphs: Optional[bool] = None):
        if preemption:
            raise NotImplementedError(
                f"preemption=True is not ported yet: it comes with {_LATER['preemption']}")
        if on_truncation not in ("warn", "reject"):
            raise ValueError(f"on_truncation must be 'warn' or 'reject', got {on_truncation!r}")
        if not 0.0 < max_chunk_share <= 1.0:
            raise ValueError(f"max_chunk_share must be in (0, 1], got {max_chunk_share}")
        from repro_torch.core.twinquant import fuse_params
        from repro_torch.kernels.dispatch import DECODE_M_MAX, dispatch_counters, fusion_enabled

        self.device = resolve_device(device)
        if step_graphs is None:
            step_graphs = self.device.type == "cuda"
        elif step_graphs and self.device.type != "cuda":
            raise ValueError(f"step_graphs=True captures CUDA graphs; the engine runs on "
                             f"{self.device}")
        if params.embed.device != self.device:
            raise ValueError(f"params live on {params.embed.device}, engine on {self.device}")
        self.cfg = cfg
        self.model = get_model(cfg)
        self.params = fuse_params(params) if fusion_enabled() else params
        self.batch = batch_slots
        self.max_len = max_len
        self.on_truncation = on_truncation
        self._layout = C.paged_layout(self.model.init_decode_state, cfg, max_len)
        self._pool_keys = tuple(k for k, (_, seq) in self._layout.items() if seq is not None)
        self._slot_keys = tuple(k for k in self._layout if k not in self._pool_keys)
        self.allocator: Optional[PageAllocator] = None
        self.prefix_cache: Optional[PrefixCache] = None
        if paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            self.page_size = page_size
            self._max_pages = -(-max_len // page_size)
            self.n_pages = n_pages if n_pages is not None else batch_slots * self._max_pages
            self.state = C.init_paged_state(self.model.init_decode_state, cfg, batch_slots,
                                            max_len, page_size, self.n_pages, self.device)
            self.allocator = PageAllocator(self.n_pages)
            if prefix_caching:
                self.prefix_cache = PrefixCache(self.allocator, page_size)
            self._bt = np.full((batch_slots, self._max_pages), -1, np.int32)
        else:
            self.page_size = 0
            self.n_pages = 0
            self.state = self.model.init_decode_state(cfg, batch_slots, max_len,
                                                      device=self.device)
        # constant zero batch-1 state: the prefill source of every admission
        self._sub_template = self.model.init_decode_state(cfg, 1, max_len, device=self.device)
        self.slots: list[Optional[Request]] = [None] * batch_slots
        self.queue: deque[Request] = deque()
        self._steps = 0
        self._next_rid = 0
        self._prefill_shapes: dict[tuple, int] = {}
        self.ragged = False
        self.token_budget = int(token_budget)
        self.max_chunk_share = float(max_chunk_share)
        self._ragged_shapes: dict[int, int] = {}
        if ragged:
            if self.allocator is None:
                warnings.warn("ragged=True needs paged mode; falling back to bucketed prefill "
                              "+ lock-step decode", stacklevel=2)
            else:
                if self.token_budget < batch_slots:
                    raise ValueError(f"token_budget ({self.token_budget}) must be >= "
                                     f"batch_slots ({batch_slots}) so every decoding slot gets "
                                     "a row each step")
                self.ragged = True
                # host mirror of each slot's committed rows: the ragged loop
                # never downloads state["pos"]
                self._pos_host = np.zeros(batch_slots, np.int32)
        self.speculation = False
        self.spec_k = int(spec_k)
        self._draft_fn = draft_fn
        self._spec_shapes: dict[tuple, int] = {}
        if speculation:
            if self.allocator is None or self.ragged:
                warnings.warn("speculation=True needs paged (non-ragged) mode; falling back to "
                              "one-token decode steps", stacklevel=2)
            elif not 2 <= self.spec_k <= DECODE_M_MAX:
                raise ValueError(f"spec_k must be in [2, {DECODE_M_MAX}] (the paged kernel's "
                                 f"draft-row cap), got {self.spec_k}")
            else:
                self.speculation = True
        self.stats = {
            "prefill_tokens": 0, "prefill_s": 0.0,
            "decode_tokens": 0, "decode_steps": 0, "decode_s": 0.0,
            "requests_done": 0, "requests_truncated": 0,
            "requests_failed": 0, "requests_timed_out": 0,
            "prefix_lookups": 0, "prefix_hits": 0, "prefix_hit_tokens": 0,
            "spec_launches": 0, "spec_slot_steps": 0, "spec_drafted": 0, "spec_accepted": 0,
        }
        self._dispatch0 = dispatch_counters()
        self.step_graph = self._build_step_graph(bool(step_graphs))

    def _build_step_graph(self, capture: bool) -> StepGraph:
        """The mode's one step over static input buffers; the step function
        holds the model, params and state, not the engine."""
        model, params, cfg, state, dev = self.model, self.params, self.cfg, self.state, self.device
        i32, i64 = torch.int32, torch.long
        if self.ragged:
            t, b = self.token_budget, self.batch

            def ragged(tokens, slot, pos, ctx, logit_idx):
                return model.ragged_step(params, cfg, state, tokens, slot, pos, ctx, logit_idx)[0]

            buffers = {"tokens": torch.zeros(t, dtype=i64, device=dev),
                       "slot": torch.zeros(t, dtype=i32, device=dev),
                       "pos": torch.zeros(t, dtype=i32, device=dev),
                       "ctx": torch.zeros(b, dtype=i32, device=dev),
                       "logit_idx": torch.zeros(b, dtype=i64, device=dev)}
            return StepGraph(ragged, buffers, dev, capture=capture)

        def decode(tokens):
            return model.decode_step(params, cfg, state, tokens)[0]

        sq = self.spec_k if self.speculation else 1
        return StepGraph(decode, {"tokens": torch.zeros((self.batch, sq), dtype=i64, device=dev)},
                         dev, capture=capture)

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Enqueue a request and admit it at once if a slot (and, paged,
        enough pages) is free. Returns True when it went straight into a
        slot. Invalid requests (not 1-D, not integer, token ids outside the
        vocab, no room in ``max_len``, more pages than the pool) are
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
        if self.allocator is not None:
            worst = -(-min(n + req.max_new, self.max_len) // self.page_size)
            if worst > self.n_pages:
                raise ValueError(f"request needs up to {worst} pages but the pool only has "
                                 f"{self.n_pages}; it could never be admitted")
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

    def _run_prefill(self, tokens: np.ndarray, off: int = 0,
                     shared_pages: Optional[list[int]] = None):
        """One batched prefill of ``tokens`` (the prompt, or the suffix after
        ``off`` prefix-cached tokens), bucket-padded. Returns (last_logits np
        (V,), sub_state, bucket)."""
        s_real = len(tokens)
        bucket = self._bucket(s_real, self.max_len - off)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :s_real] = tokens
        prefix = None
        if off:
            ids = upload(np.asarray(shared_pages, np.int64), self.device)
            prefix = {k: self.state[k][:, ids].reshape(self.state[k].shape[0], 1,
                                                       off, *self.state[k].shape[3:])
                      for k in self._pool_keys}
        key = (bucket, off)
        self._prefill_shapes[key] = self._prefill_shapes.get(key, 0) + 1
        t0 = time.monotonic()
        logits, sub = self.model.prefill(
            self.params, self.cfg, upload(toks, self.device), self._sub_template,
            length=upload(np.array([s_real], np.int64), self.device), prefix=prefix,
        )
        with sync_point(self.device):
            last = logits[0, -1].float().cpu().numpy()  # sync-point
        self.stats["prefill_s"] += time.monotonic() - t0
        self.stats["prefill_tokens"] += s_real
        return last, sub, bucket

    def _insert(self, sub: dict, i: int) -> None:
        """Splice a batch-1 prefill state's per-slot leaves (all leaves when
        dense) into slot ``i``, in place."""
        keys = self._slot_keys if self.allocator is not None else tuple(self._layout)
        for k in keys:
            ax = self._layout[k][0]
            self.state[k].select(ax, i).copy_(sub[k].select(ax, 0))

    def _write_pages(self, sub: dict, page_ids: list[int]) -> None:
        """In place: a batch-1 prefill's cache rows (L, 1, S, ...) into the
        pages ``page_ids``, zero-padded or cut to whole pages; rows past the
        prompt inside a page are hidden behind ``pos`` until decode
        overwrites them."""
        ids = upload(np.asarray(page_ids, np.int64), self.device)
        n, ps = len(page_ids), self.page_size
        for k in self._pool_keys:
            pool = self.state[k]
            rows = sub[k][:, 0, :n * ps]
            if rows.shape[1] < n * ps:
                pad = torch.zeros((rows.shape[0], n * ps - rows.shape[1], *rows.shape[2:]),
                                  dtype=rows.dtype, device=rows.device)
                rows = torch.cat([rows, pad], dim=1)
            pool[:, ids] = rows.reshape(rows.shape[0], n, ps, *rows.shape[2:]).to(pool.dtype)

    def _upload_bt(self) -> None:
        upload(self._bt, self.device, out=self.state["bt"])

    def _admit(self) -> None:
        while self.queue:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return
            if not self._admit_one(self.queue[0], free[0]):
                return  # page-gated: wait for evictions
            self.queue.popleft()

    def _reserve(self, req: Request, prompt: np.ndarray, bucket_prefix: bool):
        """Reserve the request's whole timeline (prompt + quota, capped at
        max_len) in pages, prefix-cache hits first. Returns (tokens matched,
        shared pages, own pages), or None when the pool cannot hold it."""
        need = min(len(prompt) + req.max_new - len(req.out), self.max_len)
        n_res = -(-need // self.page_size)
        m_tok, shared = 0, []
        if self.prefix_cache is not None:
            self.stats["prefix_lookups"] += 1
            m_tok, shared = self.prefix_cache.match(prompt)
            if shared and bucket_prefix:
                # a power-of-two page count keeps the suffix-prefill shapes
                # O(log max_pages), like prompt bucketing itself
                keep = 1 << (len(shared).bit_length() - 1)
                shared = shared[:keep]
                m_tok = keep * self.page_size
        # take our reference on the shared pages BEFORE any eviction, and
        # hand it back on every way out that admits nothing
        self.allocator.share(shared)
        try:
            pages = self.allocator.alloc(n_res - len(shared))
            if pages is None and self.prefix_cache is not None:
                self.prefix_cache.evict(n_res - len(shared))
                pages = self.allocator.alloc(n_res - len(shared))
        except Exception:
            self.allocator.release(shared)
            raise
        if pages is None:
            self.allocator.release(shared)
            return None
        if m_tok:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += m_tok
        return m_tok, shared, pages

    def _map_row(self, i: int, row: list[int]) -> None:
        self._bt[i, :] = -1
        self._bt[i, :len(row)] = row
        self._upload_bt()

    def _admit_one(self, req: Request, i: int) -> bool:
        """Admit ``req`` into slot ``i``; False when paged admission must wait
        for pages. A request whose prefill faults fails alone (and counts as
        consumed)."""
        if self.ragged:
            return self._admit_one_ragged(req, i)
        prompt = req._prompt_host
        if self.allocator is None:
            self._set_status(req, RequestState.PREFILL)
            try:
                last, sub, _ = self._run_prefill(prompt)
                if C.nonfinite_rows(last[None, :], self.cfg.vocab):
                    raise _SlotFault("nan_logits", "non-finite prefill logits")
                self._insert(sub, i)
            except Exception as e:  # noqa: BLE001 — a faulty request fails alone
                self._finish(req, RequestState.FAILED, *_fault_of(e))
                return True
        else:
            res = self._reserve(req, prompt, bucket_prefix=True)
            if res is None:
                return False
            m_tok, shared, pages = res
            self._set_status(req, RequestState.PREFILL)
            try:
                last, sub, bucket = self._run_prefill(prompt[m_tok:], off=m_tok,
                                                      shared_pages=shared)
                if C.nonfinite_rows(last[None, :], self.cfg.vocab):
                    raise _SlotFault("nan_logits", "non-finite prefill logits")
                self._insert(sub, i)
                self._write_pages(sub, pages[:min(-(-bucket // self.page_size), len(pages))])
                self._map_row(i, shared + pages)
                if self.prefix_cache is not None:
                    self.prefix_cache.register(prompt, shared + pages)
            except Exception as e:  # noqa: BLE001 — a faulty request fails alone
                self._map_row(i, [])
                self.allocator.release(shared + pages)
                self._finish(req, RequestState.FAILED, *_fault_of(e))
                return True
        req._last_logits = last
        if req._rng is None:
            req._rng = np.random.default_rng(req.sampling.seed)
        self._set_status(req, RequestState.DECODE)
        self.slots[i] = req
        return True

    def _admit_one_ragged(self, req: Request, i: int) -> bool:
        """Ragged admission: reserve the pages (prefix hits included) and
        park the request in slot ``i`` with its chunk cursor at the first
        uncached prompt token; the prompt streams through later steps."""
        prompt = req._prompt_host
        res = self._reserve(req, prompt, bucket_prefix=False)
        if res is None:
            return False
        m_tok, shared, pages = res
        self._set_status(req, RequestState.PREFILL)
        try:
            self._map_row(i, shared + pages)
        except Exception as e:  # noqa: BLE001 — a faulty request fails alone
            self.allocator.release(shared + pages)
            self._bt[i, :] = -1
            self._finish(req, RequestState.FAILED, *_fault_of(e))
            return True
        req._prompt = prompt
        req._filled = m_tok
        self._pos_host[i] = m_tok
        req._last_logits = None
        if req._rng is None:
            req._rng = np.random.default_rng(req.sampling.seed)
        self.slots[i] = req
        return True

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

    def _release_slot(self, i: int) -> None:
        """Release slot ``i``'s pages and neutralise its device state — the
        one reclaim path of every exit: pos 0 and an unmapped block-table row
        mean its lock-step decode attends nothing and writes nowhere."""
        self.slots[i] = None
        if self.allocator is not None:
            self.allocator.release([int(p) for p in self._bt[i] if p >= 0])
            self._map_row(i, [])
            self.state["pos"][i].zero_()  # a fill: item assignment would upload a host scalar
        if self.ragged:
            self._pos_host[i] = 0

    def _evict(self, i: int, req: Request, truncated: bool) -> None:
        self._release_slot(i)
        req.truncated = truncated
        if truncated:
            self.stats["requests_truncated"] += 1
        self._finish(req, RequestState.DONE)

    def _fail_slot(self, i: int, req: Request, what: str) -> None:
        self._release_slot(i)
        self._finish(req, RequestState.FAILED, "nan_logits",
                     f"non-finite {what} logits at engine step {self._steps}")

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

    def _draft_tokens(self, req: Request, k: int) -> list:
        """``k`` draft tokens continuing the request's history (prompt +
        generated). A ``draft_fn(req, k)`` hook takes precedence over the
        n-gram self-draft; its proposals are clamped into the vocab, so a
        sloppy hook can only lower the acceptance rate."""
        if self._draft_fn is not None:
            d = [int(t) for t in self._draft_fn(req, k)][:k]
            d = [min(max(t, 0), self.cfg.vocab - 1) for t in d]
            last = d[-1] if d else (req.out[-1] if req.out else 0)
            return d + [last] * (k - len(d))
        return _ngram_draft(req._prompt_host.tolist() + req.out, k)

    # -- decode -------------------------------------------------------------

    def step(self) -> int:
        """Admit queued work, sample one token per live slot, then run one
        lock-step decode for the slots that still need logits (speculative:
        one verify launch of ``spec_k`` rows a slot; ragged: one unified
        chunked-prefill + decode launch). Returns the slots live at entry."""
        if self.ragged:
            return self._step_ragged()
        self._steps += 1
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        if self.speculation:
            self._step_spec(active)
            self._admit()
            return len(active)
        tok = np.zeros((self.batch, 1), np.int64)
        with sync_point(self.device):
            # a copy, since the step advances pos in place
            pos = self.state["pos"].cpu().numpy().copy()  # sync-point: next write offset per slot
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
            logits = self.step_graph(tokens=tok)
            with sync_point(self.device):
                last = logits[:, -1].float().cpu().numpy()  # sync-point
            self.stats["decode_s"] += time.monotonic() - t0
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += len(live)
            bad = set(C.nonfinite_rows(last, self.cfg.vocab))
            for i in live:
                if i in bad:
                    self._fail_slot(i, self.slots[i], "decode")
                else:
                    self.slots[i]._last_logits = last[i]
        self._admit()
        return len(active)

    def _step_spec(self, active: list) -> None:
        """One speculative decode launch: per live slot, sample the next
        token from the held logits (exactly the plain commit), stack it with
        ``spec_k - 1`` drafts and run ONE (B, spec_k) decode launch. Greedy
        slots accept the longest draft prefix matching the launch's own
        argmaxes (each accepted row's logits verify the next), capped by
        quota and cache rows; sampled slots commit only the sampled token,
        so their random streams are untouched. Rejected rows are rolled back
        by rewinding ``pos``; the up-front page reservation hides them until
        they are overwritten."""
        k = self.spec_k
        tok = np.zeros((self.batch, k), np.int64)
        with sync_point(self.device):
            # a copy, since the step advances pos in place
            pos = self.state["pos"].cpu().numpy().copy()  # sync-point: next write offset per slot
        live: list[int] = []
        drafts: dict[int, list] = {}
        for i in active:
            req = self.slots[i]
            nxt = self._sample(req)
            self._emit_token(req, nxt)
            if len(req.out) >= req.max_new:
                self._evict(i, req, truncated=False)
            elif int(pos[i]) >= self.max_len:
                self._evict(i, req, truncated=True)
            else:
                drafts[i] = self._draft_tokens(req, k - 1)
                tok[i, 0] = nxt
                tok[i, 1:] = drafts[i]
                live.append(i)
        if not live:
            return
        t0 = time.monotonic()
        logits = self.step_graph(tokens=tok)
        with sync_point(self.device):
            last = logits.float().cpu().numpy()  # sync-point: (B, k, V) verify download
        dt = time.monotonic() - t0
        self._spec_shapes[(self.batch, k)] = self._spec_shapes.get((self.batch, k), 0) + 1
        bad = {f // k for f in C.nonfinite_rows(last, self.cfg.vocab)}  # row b*k+j -> slot b
        committed: dict[int, int] = {}
        delta = np.zeros(self.batch, np.int32)
        for i in live:
            req = self.slots[i]
            n_acc = 0
            if i not in bad and req.sampling.temperature <= 0.0:
                quota_room = req.max_new - len(req.out)
                cap_rows = self.max_len - int(pos[i]) - 1
                while (n_acc < k - 1 and n_acc < quota_room and n_acc < cap_rows
                       and int(drafts[i][n_acc])
                       == int(np.argmax(last[i, n_acc, : self.cfg.vocab]))):
                    self._emit_token(req, int(drafts[i][n_acc]))
                    n_acc += 1
                self.stats["spec_drafted"] += k - 1
                self.stats["spec_accepted"] += n_acc
            committed[i] = 1 + n_acc
            delta[i] = k - committed[i]
        # rewind before any exit: the release path zeroes pos
        self.state["pos"] -= upload(delta, self.device)
        self.stats["decode_s"] += dt
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += sum(committed.values())
        self.stats["spec_launches"] += 1
        self.stats["spec_slot_steps"] += len(live)
        for i in live:
            req = self.slots[i]
            if i in bad:
                self._fail_slot(i, req, "decode")
                continue
            req._last_logits = last[i, committed[i] - 1]
            if len(req.out) >= req.max_new:
                self._evict(i, req, truncated=False)
            elif int(pos[i]) + committed[i] >= self.max_len:
                # the plain order: the token past the last cache row is still
                # sampled and kept, then the slot exits
                self._emit_token(req, self._sample(req))
                self._evict(i, req, truncated=len(req.out) < req.max_new)

    def _step_ragged(self) -> int:
        """One unified ragged step: sample and schedule one decode row per
        decoding slot first (admission never displaces decode), fill the rest
        of the budget with prompt chunks FIFO across admitting slots (capped
        at ``max_chunk_share`` of the budget), then run ONE ``ragged_step``
        launch. Pad rows carry slot id B and are inert."""
        from repro_torch.kernels.contracts import check_ragged_rows

        self._steps += 1
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        budget = self.token_budget
        tokens = np.zeros(budget, np.int64)
        slot = np.full(budget, self.batch, np.int32)  # pad sentinel = B
        pos = np.zeros(budget, np.int32)
        logit_idx = np.zeros(self.batch, np.int64)
        row = 0
        decode_rows: list[int] = []
        for i in active:
            req = self.slots[i]
            if req._last_logits is None:
                continue  # still prefilling: chunks below
            nxt = self._sample(req)
            self._emit_token(req, nxt)
            if len(req.out) >= req.max_new:
                self._evict(i, req, truncated=False)
            elif int(self._pos_host[i]) >= self.max_len:
                self._evict(i, req, truncated=True)
            else:
                tokens[row] = nxt
                slot[row] = i
                pos[row] = self._pos_host[i]
                logit_idx[i] = row
                decode_rows.append(i)
                row += 1
        chunk_cap = max(1, int(self.token_budget * self.max_chunk_share))
        chunks: list[tuple[int, int]] = []
        n_chunk = 0
        for i in active:
            req = self.slots[i]
            if req is None or req._last_logits is not None:
                continue
            space = min(budget - row, chunk_cap - n_chunk)
            if space <= 0:
                break
            take = min(space, len(req._prompt) - req._filled)
            tokens[row:row + take] = req._prompt[req._filled:req._filled + take]
            slot[row:row + take] = i
            pos[row:row + take] = self._pos_host[i] + np.arange(take, dtype=np.int32)
            if req._filled + take == len(req._prompt):
                logit_idx[i] = row + take - 1
            chunks.append((i, take))
            n_chunk += take
            row += take
        if row == 0:
            self._admit()
            return len(active)
        ctx = self._pos_host.copy()
        check_ragged_rows(slot, pos, ctx, s_max=self._max_pages * self.page_size)
        t0 = time.monotonic()
        logits = self.step_graph(tokens=tokens, slot=slot, pos=pos, ctx=ctx, logit_idx=logit_idx)
        with sync_point(self.device):
            last = logits.float().cpu().numpy()  # sync-point: per-slot logits
        dt = time.monotonic() - t0
        # wall time split by scheduled-row share so both tok/s stay honest
        self.stats["decode_s"] += dt * len(decode_rows) / row
        self.stats["prefill_s"] += dt * n_chunk / row
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(decode_rows)
        self.stats["prefill_tokens"] += n_chunk
        self._ragged_shapes[budget] = self._ragged_shapes.get(budget, 0) + 1
        bad = set(C.nonfinite_rows(last, self.cfg.vocab))
        for i in decode_rows:
            req = self.slots[i]
            if i in bad:
                self._fail_slot(i, req, "decode")
                continue
            self._pos_host[i] += 1
            req._last_logits = last[i]
        for i, take in chunks:
            req = self.slots[i]
            self._pos_host[i] += take
            req._filled += take
            if req._filled == len(req._prompt):
                if i in bad:
                    self._fail_slot(i, req, "prefill")
                    continue
                req._last_logits = last[i]
                self._set_status(req, RequestState.DECODE)
                # the prompt's pages are whole only once its last chunk lands
                if self.prefix_cache is not None:
                    self.prefix_cache.register(req._prompt,
                                               [int(p) for p in self._bt[i] if p >= 0])
        self._admit()
        return len(active)

    # -- drivers ------------------------------------------------------------

    def run_until_done(self, max_steps: int = 100_000) -> None:
        """Drive ``step()`` until no slot is live and the queue is empty;
        exhausting ``max_steps`` marks the unfinished requests ``TIMED_OUT``
        (pages released) and raises :class:`EngineStalledError`."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                return
        stranded = []
        for i, req in enumerate(self.slots):
            if req is not None:
                self._release_slot(i)
                stranded.append(req)
        stranded += list(self.queue)
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
        """Launch-shape inventory: every distinct (bucket, prefix offset) is
        one prefill shape, O(log max_len) under any traffic; the ragged step
        has one (token_budget) shape, the speculative decode one (batch,
        spec_k) shape. ``decode_graphs`` / ``spec_graphs`` /
        ``ragged_graphs`` count the mode's step-graph captures (one per
        engine once warm), ``graph_replays`` its replays: the port's
        counterpart of the reference's trace counts."""
        graphs = dict.fromkeys(("decode_graphs", "spec_graphs", "ragged_graphs"), 0)
        mode = "ragged" if self.ragged else "spec" if self.speculation else "decode"
        graphs[f"{mode}_graphs"] = self.step_graph.captures
        return {
            "prefill_traces": len(self._prefill_shapes),
            "prefill_calls": sum(self._prefill_shapes.values()),
            "prefill_buckets": sorted({k[0] for k in self._prefill_shapes}),
            "prefill_variants": len({k[1] for k in self._prefill_shapes}),
            "decode_traces": 1 if (self.stats["decode_steps"] and not self.ragged
                                   and not self.speculation) else 0,
            "ragged_traces": len(self._ragged_shapes),
            "spec_traces": len(self._spec_shapes),
            **graphs,
            "graph_replays": self.step_graph.replays,
        }

    def memory(self) -> dict:
        """Cache-memory accounting: the page pool's bytes and peak pages in
        use against the dense per-slot cache the same (batch, max_len)
        engine would allocate."""
        dense = self.model.init_decode_state(self.cfg, self.batch, self.max_len, device="meta")
        dense_bytes = sum(dense[k].numel() * dense[k].element_size() for k in self._pool_keys)
        out = {"mode": "paged" if self.allocator is not None else "dense",
               "dense_cache_bytes": dense_bytes}
        if self.allocator is None:
            out["cache_bytes"] = dense_bytes
            out["peak_cache_bytes"] = dense_bytes
            return out
        page_bytes = sum(self.state[k][:, 0].numel() * self.state[k].element_size()
                         for k in self._pool_keys)
        out.update(
            page_size=self.page_size, n_pages=self.n_pages, page_bytes=page_bytes,
            cache_bytes=page_bytes * self.n_pages,
            pages_in_use=self.allocator.n_used, pages_peak=self.allocator.peak_used,
            peak_cache_bytes=page_bytes * self.allocator.peak_used,
            prefix_entries=0 if self.prefix_cache is None else len(self.prefix_cache),
        )
        return out

    def check_page_invariants(self) -> None:
        """Allocator audit plus exact refcount accounting: every page's
        refcount equals the block-table rows mapping it plus its prefix-cache
        entries, no slot maps a page twice, empty slots map nothing."""
        if self.allocator is None:
            return
        self.allocator.audit()
        refs = np.zeros(self.n_pages, np.int32)
        for i in range(self.batch):
            row = [int(p) for p in self._bt[i] if p >= 0]
            assert len(set(row)) == len(row), f"slot {i} maps a page twice: {row}"
            assert self.slots[i] is not None or not row, f"empty slot {i} still maps {row}"
            for p in row:
                refs[p] += 1
        if self.prefix_cache is not None:
            for e in self.prefix_cache.entries.values():
                refs[e.page] += 1
        assert np.array_equal(refs, self.allocator.ref), (
            f"refcount drift: mapped+cached {refs.tolist()} vs allocator "
            f"{self.allocator.ref.tolist()}")
        with sync_point(self.device):
            bt = self.state["bt"].cpu().numpy()  # sync-point: the audit's read-back
        assert np.array_equal(bt, self._bt), "device bt drifted"

    def routing(self) -> dict:
        """Kernel routes taken since this engine was built: {kind/path: n}
        (process-wide counters, so drive engines one after another)."""
        from repro_torch.kernels.dispatch import dispatch_counters

        now = dispatch_counters()
        return {k: v - self._dispatch0.get(k, 0) for k, v in now.items()
                if v - self._dispatch0.get(k, 0) > 0}

    def throughput(self) -> dict:
        """Tokens/s summary from the accounting counters, with speculation's
        acceptance rate (drafts accepted / drafted) and tokens per slot per
        decode launch (1.0 without speculation)."""
        st = self.stats
        return {
            "decode_tok_s": st["decode_tokens"] / max(st["decode_s"], 1e-9),
            "prefill_tok_s": st["prefill_tokens"] / max(st["prefill_s"], 1e-9),
            "mean_batch_occupancy": st["decode_tokens"] / max(st["decode_steps"], 1),
            "acceptance_rate": st["spec_accepted"] / max(st["spec_drafted"], 1),
            "tokens_per_step": (st["decode_tokens"] / max(st["spec_slot_steps"], 1)
                                if self.speculation else (1.0 if st["decode_tokens"] else 0.0)),
            "routing": self.routing(),
            **st,
        }
