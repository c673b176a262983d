"""SLO-facing latency metrics for the port's serving engine: the
reference's ``repro/launch/metrics.py``, over the port's
:class:`~repro_torch.launch.serve.Request`.

The engine stamps wall-clock times on every request it touches —
``t_submit`` at ``submit()``, ``t_first_token`` and one ``token_times``
entry per emitted token inside ``_emit_token``, ``t_done`` at ``_finish`` —
so every number here is measured at the emission site, not inferred from
aggregate counters. :func:`summarize` turns a set of finished (or
in-flight) requests into the tail-latency summary ``engine.latency()``
returns:

- **TTFT** (time to first token): ``t_first_token - t_submit``, the number a
  chat user feels. Queue wait is included by construction — a request that
  sat behind a long prompt pays for it here.
- **TPOT** (time per output token): inter-token gaps within one request's
  ``token_times``. Pooled across requests so p99 captures the worst gap
  anywhere in the run (a preemption or a long admission chunk shows up as a
  fat TPOT tail, not a hidden mean shift).
- **E2E**: ``t_done - t_submit`` for terminal requests.
- **goodput under SLO**: tokens from DONE requests that met the SLO, divided
  by the wall span of the run — throughput that served somebody on time.
  Tokens generated for requests that blew their deadline count for nothing.
- **queue depth / preemption / prefix-hit**: load-shape context for the
  latency numbers, straight from the engine's step samples and counters.

Stateless and engine-agnostic: anything that records the same stamps on its
request objects can be summarized, so bucketed, ragged and speculative runs
compare side by side.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.launch.serve import Request, RequestState


@dataclasses.dataclass(frozen=True)
class SLO:
    """A service-level objective: per-request latency bounds.

    A DONE request *meets* the SLO when its TTFT is at most ``ttft_s``
    seconds AND its mean time-per-output-token is at most ``tpot_s``
    seconds. Requests that exit FAILED / CANCELLED / TIMED_OUT never meet
    it regardless of speed — an answer that never arrived has no latency.
    Defaults are deliberately loose (interactive-chat scale); a caller pins
    its own."""

    ttft_s: float = 1.0
    tpot_s: float = 0.1


def percentiles(xs: Iterable[float]) -> dict:
    """``{"p50", "p95", "p99", "mean", "max", "n"}`` of a sample, in the
    sample's own units. Empty samples yield zeros (JSON-stable) with
    ``n == 0`` so a consumer can tell "fast" from "absent"."""
    arr = np.asarray(list(xs), dtype=np.float64)
    if arr.size == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0, "n": 0}
    p50, p95, p99 = np.percentile(arr, [50.0, 95.0, 99.0])
    return {
        "p50": float(p50),
        "p95": float(p95),
        "p99": float(p99),
        "mean": float(arr.mean()),
        "max": float(arr.max()),
        "n": int(arr.size),
    }


def request_ttft_s(req: Request) -> Optional[float]:
    """Seconds from submit to first emitted token; None before either stamp
    exists (a request that never produced a token has no TTFT)."""
    if req.t_submit is None or req.t_first_token is None:
        return None
    return req.t_first_token - req.t_submit


def request_tpot_s(req: Request) -> list[float]:
    """Inter-token gaps (seconds) within one request's emission trace —
    empty for requests with fewer than two tokens."""
    ts = req.token_times
    return [ts[i + 1] - ts[i] for i in range(len(ts) - 1)]


def meets_slo(req: Request, slo: SLO) -> bool:
    """Whether a request counts toward goodput under ``slo``: it finished
    DONE, its TTFT is within ``slo.ttft_s``, and its mean per-token gap is
    within ``slo.tpot_s`` (single-token requests have no gaps and pass the
    TPOT bound vacuously)."""
    if req.status != RequestState.DONE:
        return False
    ttft = request_ttft_s(req)
    if ttft is None or ttft > slo.ttft_s:
        return False
    gaps = request_tpot_s(req)
    return not gaps or float(np.mean(gaps)) <= slo.tpot_s


def summarize(
    requests: Sequence[Request],
    *,
    slo: Optional[SLO] = None,
    queue_depths: Sequence[int] = (),
    stats: Optional[dict] = None,
) -> dict:
    """The latency/SLO summary dict (``engine.latency()``).

    ``requests`` is every request the run touched (terminal or not);
    ``queue_depths`` is the engine's per-step queue-depth samples and
    ``stats`` its counter dict (for preemption / prefix-hit rates). With
    ``slo=None`` the goodput denominator still runs but every DONE request
    qualifies — goodput degenerates to completed-token throughput and
    ``slo_met_rate`` to the completion rate, which keeps the dict's shape
    (and the CI presence gate) identical with and without an objective."""
    stats = stats or {}
    ttfts = [t for r in requests if (t := request_ttft_s(r)) is not None]
    tpots = [g for r in requests for g in request_tpot_s(r)]
    e2es = [
        r.t_done - r.t_submit
        for r in requests
        if r.t_done is not None and r.t_submit is not None
    ]
    done = [r for r in requests if r.status == RequestState.DONE]
    met = [r for r in done if slo is None or meets_slo(r, slo)]
    t0 = min((r.t_submit for r in requests if r.t_submit is not None), default=None)
    t1 = max((r.t_done for r in requests if r.t_done is not None), default=None)
    span_s = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
    qd = np.asarray(list(queue_depths), dtype=np.float64)
    return {
        "n_requests": len(requests),
        "n_done": len(done),
        "n_slo_met": len(met),
        "slo": None if slo is None else dataclasses.asdict(slo),
        "slo_met_rate": len(met) / max(len(requests), 1),
        "goodput_tok_s": sum(len(r.out) for r in met) / max(span_s, 1e-9),
        "span_s": span_s,
        "ttft_ms": percentiles(t * 1e3 for t in ttfts),
        "tpot_ms": percentiles(g * 1e3 for g in tpots),
        "e2e_ms": percentiles(t * 1e3 for t in e2es),
        "queue_depth_mean": float(qd.mean()) if qd.size else 0.0,
        "queue_depth_max": int(qd.max()) if qd.size else 0,
        "preemption_rate": stats.get("requests_preempted", 0) / max(len(requests), 1),
        "prefix_hit_rate": (
            stats.get("prefix_hits", 0) / max(stats.get("prefix_lookups", 0), 1)
        ),
    }
