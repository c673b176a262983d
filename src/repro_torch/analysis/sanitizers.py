"""Opt-in runtime sanitizers for serving tests: the reference's
``repro/analysis/sanitizers.py``, bound to the port's engine.

* :func:`no_recompiles` — fail if a region added a launch shape or captured
  a step graph (``engine.compile_stats()``): the port's counterpart of a
  recompile.
* :func:`assert_compile_budget` — the ratchet: an engine's lifetime prefill
  shapes stay within O(log max_len) buckets per prefix-offset variant, a
  speculative engine has one verify shape, a ragged engine one step shape
  (ragged + prefill <= 2), and each mode captures its step graph once.
* :func:`guarded_decode` — run the region under
  ``torch.cuda.set_sync_debug_mode("error")``: any host sync OUTSIDE the
  engine's ``# sync-point`` lines (which lift it for themselves,
  ``launch.step_graph.sync_point``) raises instead of silently stalling.
* :func:`page_invariant_checks` — wrap ``engine.step`` so
  ``check_page_invariants()`` runs every N steps.
* :func:`lifecycle_checks` — wrap ``engine.submit`` / ``engine.step`` so the
  request state machine is audited every step.

All are context managers for test bodies::

    with guarded_decode(), no_recompiles(engine), page_invariant_checks(engine):
        while engine.step():
            pass
    assert_compile_budget(engine)
"""

from __future__ import annotations

import contextlib
import math

import torch

__all__ = [
    "SanitizerError",
    "assert_compile_budget",
    "compile_budget",
    "guarded_decode",
    "lifecycle_checks",
    "no_recompiles",
    "page_invariant_checks",
]

_TRACE_KEYS = ("prefill_traces", "decode_traces", "ragged_traces", "spec_traces")
_GRAPH_KEYS = ("decode_graphs", "spec_graphs", "ragged_graphs")


class SanitizerError(AssertionError):
    """A sanitizer-detected hot-path violation."""


@contextlib.contextmanager
def no_recompiles(engine):
    """Fail if the region added a prefill / decode / ragged / verify launch
    shape or captured a step graph. Use around steady-state serving (after
    warm-up: the first step runs eagerly, the second captures)."""
    before = engine.compile_stats()
    yield engine
    after = engine.compile_stats()
    for key in _TRACE_KEYS + _GRAPH_KEYS:
        if after.get(key, 0) > before.get(key, 0):
            raise SanitizerError(
                f"recompile sanitizer: {key} grew {before.get(key, 0)} -> {after[key]} "
                f"inside a no-recompile region (now: {after})")


def compile_budget(max_len: int, variants: int) -> int:
    """The ratchet bound: distinct power-of-two prompt buckets (min 8) plus
    the capacity bucket, per prefix-offset variant."""
    buckets = max(1, int(math.log2(max(max_len, 8))) - 2) + 1
    return max(1, variants) * buckets


def assert_compile_budget(engine, max_len: int | None = None) -> dict:
    """Ratchet an engine's lifetime shapes and captures; returns the compile
    stats it validated. A mode's step shape is static, so its step graph is
    captured at most once and a speculative engine has one verify shape. A
    ragged engine is held to ragged + prefill shapes <= 2 (the one step
    shape, plus at most one prefill shape if a caller mixed modes); other
    engines to the O(log max_len) prefill bucket bound."""
    stats = engine.compile_stats()
    for key in _GRAPH_KEYS:
        if stats.get(key, 0) > 1:
            raise SanitizerError(
                f"compile-budget sanitizer: {key} = {stats[key]}; a mode's step shape is "
                "static, so its step graph must be captured once per engine")
    if stats.get("spec_traces", 0) > 1:
        raise SanitizerError(
            f"compile-budget sanitizer: {stats['spec_traces']} speculative decode shapes; "
            "the (batch, spec_k) launch shape is static, so there must be exactly one")
    if getattr(engine, "ragged", False):
        total = stats.get("ragged_traces", 0) + stats["prefill_traces"]
        if total > 2:
            raise SanitizerError(
                f"compile-budget sanitizer: ragged engine has {total} step shapes "
                f"(ragged={stats.get('ragged_traces', 0)}, prefill={stats['prefill_traces']}); "
                "the unified step must have one per token budget")
        return stats
    if max_len is None:
        max_len = engine.max_len
    budget = compile_budget(max_len, stats.get("prefill_variants", 1))
    if stats["prefill_traces"] > budget:
        raise SanitizerError(
            f"compile-budget sanitizer: {stats['prefill_traces']} prefill shapes exceed the "
            f"O(log max_len) budget {budget} for max_len={max_len}, "
            f"variants={stats.get('prefill_variants', 1)} (buckets: "
            f"{stats['prefill_buckets']}): prompt bucketing is leaking shapes")
    return stats


@contextlib.contextmanager
def guarded_decode():
    """Make every host sync in the region an error
    (``torch.cuda.set_sync_debug_mode("error")``, restored after it). The
    engine's sanctioned ``# sync-point`` lines lift it for themselves, so
    only an unsanctioned sync (a pageable upload, a ``.item()``, a
    ``nonzero``) raises. Without a card there is no device to sync with:
    the region is entered and left and checks nothing."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def page_invariant_checks(engine, every: int = 1):
    """Audit the page allocator inside the serving loop: ``engine.step`` is
    wrapped so ``check_page_invariants()`` runs after every ``every``-th
    step and once more on exit. No-op for dense (non-paged) engines."""
    if getattr(engine, "allocator", None) is None:
        yield engine
        return
    orig_step = engine.step
    count = 0

    def checked_step(*args, **kwargs):
        nonlocal count
        out = orig_step(*args, **kwargs)
        count += 1
        if count % every == 0:
            engine.check_page_invariants()
        return out

    engine.step = checked_step
    try:
        yield engine
        engine.check_page_invariants()
    finally:
        engine.step = orig_step


@contextlib.contextmanager
def lifecycle_checks(engine):
    """Audit the request state machine inside the serving loop:
    ``engine.submit`` is wrapped to learn which requests exist and
    ``engine.step`` so that after every step, for every request submitted
    in the region:

    * a terminal request (``RequestState.TERMINAL``) has ``done`` set, sits
      in no slot and not in the queue, and (FAILED / TIMED_OUT) carries an
      ``error`` code;
    * a request live in a slot is PREFILL or DECODE;
    * a queued request is QUEUED or PREEMPTED."""
    from repro_torch.launch.serve import RequestState

    seen: list = []
    orig_submit = engine.submit
    orig_step = engine.step

    def tracked_submit(req, *args, **kwargs):
        if all(req is not r for r in seen):
            seen.append(req)
        return orig_submit(req, *args, **kwargs)

    def audit() -> None:
        in_slots = [r for r in engine.slots if r is not None]
        in_queue = list(engine.queue)
        for req in seen:
            rid = req.request_id
            held = any(req is r for r in in_slots)
            queued = any(req is r for r in in_queue)
            if req.status in RequestState.TERMINAL:
                if not req.done:
                    raise SanitizerError(f"lifecycle sanitizer: {rid} is {req.status} but not "
                                         "done")
                if held or queued:
                    raise SanitizerError(f"lifecycle sanitizer: terminal request {rid} "
                                         f"({req.status}) still held by a slot or the queue")
                if req.status in (RequestState.FAILED, RequestState.TIMED_OUT) and not req.error:
                    raise SanitizerError(f"lifecycle sanitizer: {rid} is {req.status} with no "
                                         "error reason code")
            elif held:
                if req.status not in (RequestState.PREFILL, RequestState.DECODE):
                    raise SanitizerError(f"lifecycle sanitizer: slot-resident request {rid} is "
                                         f"{req.status}, expected PREFILL/DECODE")
            elif queued and req.status not in (RequestState.QUEUED, RequestState.PREEMPTED):
                raise SanitizerError(f"lifecycle sanitizer: queued request {rid} is "
                                     f"{req.status}, expected QUEUED/PREEMPTED")

    def checked_step(*args, **kwargs):
        out = orig_step(*args, **kwargs)
        audit()
        return out

    engine.submit = tracked_submit
    engine.step = checked_step
    try:
        yield engine
        audit()
    finally:
        engine.submit = orig_submit
        engine.step = orig_step
