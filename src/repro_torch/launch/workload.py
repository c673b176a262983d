"""Trace-driven traffic generation for the port's serving engine: the
reference's ``repro/launch/workload.py``, making the port's
:class:`~repro_torch.launch.serve.Request`. The same seed draws the same
items in both packages (one ``np.random.default_rng(seed)`` stream, drawn in
the same order).

A workload is a *deterministic function of its seed*: arrival times, scenario
mix, prompt contents, priorities and deadlines all come from one
``np.random.default_rng(seed)`` stream, so building the same workload twice
yields request-for-request identical traffic. That determinism is the whole
point: a workload replayed through the engine under test can be rebuilt from
the same seed and replayed through an oracle engine, and the two held
request by request.

Arrival times are in ENGINE STEPS, not wall-clock seconds: :func:`replay`
submits a request the moment the step counter reaches its ``at`` and drives
``engine.step()`` in between. Step-clocked arrivals keep the schedule (and
therefore every token stream) reproducible on any machine; wall-clock stamps
for TTFT/TPOT are still recorded per emission, so latency numbers stay real
while the *traffic* stays deterministic. For the same reason scenarios use
``deadline_steps`` (step-clocked) rather than ``deadline_s``.

Two arrival processes:

- :func:`poisson_arrivals` — seeded exponential inter-arrival gaps (the
  classic open-loop load model), with per-scenario burst clustering layered
  on top (a burst scenario lands ``burst`` requests on one step).
- a replayed trace — pass ``trace=[0, 3, 3, 17, ...]`` to
  :func:`make_workload` and those step numbers are used verbatim, so a
  production arrival log can be replayed against any engine configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.launch.serve import Request


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One traffic class in the mix.

    ``weight`` is the relative draw probability; ``prompt_len`` / ``max_new``
    are inclusive ``(lo, hi)`` ranges sampled per request;
    ``shared_prefix_len`` prepends a prefix common to every request of this
    scenario (page-align it to the engine's ``page_size`` so the prefix
    cache can serve it); ``burst`` clusters that many requests onto one
    arrival step (short-query fan-out); ``priority`` / ``deadline_steps``
    ride onto the Request so the lifecycle machinery (preemption ordering,
    deadline expiry) is exercised by the mix itself."""

    name: str
    weight: float
    prompt_len: tuple[int, int]
    max_new: tuple[int, int]
    priority: int = 0
    deadline_steps: Optional[int] = None
    shared_prefix_len: int = 0
    burst: int = 1


def default_scenarios(page_size: int = 8) -> list[Scenario]:
    """The reference's three-way production mix: chat
    turns behind one shared system prompt (3 pages — the prefix-cache hit
    path), long-document summarization (the chunked-prefill path), and
    short bursty queries at top priority with a step deadline (the
    preemption / deadline path). Prompt lengths are the reference's, sized
    for tiny configs; scale them up for real models."""
    return [
        Scenario(
            name="chat",
            weight=0.5,
            prompt_len=(4, 12),
            max_new=(6, 12),
            priority=1,
            shared_prefix_len=3 * page_size,
        ),
        Scenario(
            name="summarize",
            weight=0.25,
            prompt_len=(40, 56),
            max_new=(8, 16),
            priority=0,
        ),
        Scenario(
            name="burst",
            weight=0.25,
            prompt_len=(4, 8),
            max_new=(4, 8),
            priority=2,
            deadline_steps=600,
            burst=3,
        ),
    ]


@dataclasses.dataclass(frozen=True)
class WorkloadItem:
    """One scheduled arrival: submit ``request`` when the engine-step
    counter reaches ``at``. ``scenario`` names the traffic class it was
    drawn from (for per-class reporting)."""

    at: int
    scenario: str
    request: Request


@dataclasses.dataclass
class Workload:
    """A fully materialized traffic trace: ``items`` in arrival order.
    Rebuilding with :func:`make_workload` from the same ``seed`` (and the
    same scenario list / knobs) reproduces it exactly — requests included."""

    seed: int
    items: list[WorkloadItem]

    @property
    def requests(self) -> list[Request]:
        """The item requests in arrival order (results ride on these after
        :func:`replay`)."""
        return [it.request for it in self.items]


def poisson_arrivals(rng: np.random.Generator, n: int, mean_gap_steps: float) -> list[int]:
    """``n`` arrival steps with exponential inter-arrival gaps of mean
    ``mean_gap_steps`` engine steps (a seeded open-loop Poisson process),
    floored to integer steps starting at 0."""
    gaps = rng.exponential(mean_gap_steps, size=n)
    return [int(t) for t in np.floor(np.cumsum(gaps) - gaps[0])] if n else []


def make_workload(
    seed: int,
    *,
    n_requests: int = 12,
    mean_gap_steps: float = 4.0,
    scenarios: Optional[Sequence[Scenario]] = None,
    vocab: int = 256,
    trace: Optional[Sequence[int]] = None,
) -> Workload:
    """Materialize a deterministic workload from ``seed``.

    Draws ``n_requests`` scenario assignments (weight-proportional), lays
    them on Poisson arrivals of mean ``mean_gap_steps`` — or on ``trace``
    verbatim when given (replayed-trace mode; its length caps the request
    count) — then expands burst scenarios into clusters sharing one arrival
    step. Prompt token ids are drawn in ``[1, vocab)`` (0 stays free for
    padding conventions); each scenario's shared prefix is drawn once and
    prepended to all of its requests."""
    rng = np.random.default_rng(seed)
    scenarios = list(default_scenarios() if scenarios is None else scenarios)
    # shared prefixes first, in scenario order, so the draw sequence (and
    # therefore every downstream sample) is fixed by (seed, scenario list)
    prefixes = {
        s.name: rng.integers(1, vocab, size=s.shared_prefix_len, dtype=np.int32)
        for s in scenarios
    }
    weights = np.asarray([s.weight for s in scenarios], dtype=np.float64)
    weights = weights / weights.sum()
    picks = rng.choice(len(scenarios), size=n_requests, p=weights)
    if trace is not None:
        arrivals = [int(t) for t in trace]
        picks = picks[: len(arrivals)]
    else:
        arrivals = poisson_arrivals(rng, n_requests, mean_gap_steps)
    items: list[WorkloadItem] = []
    for at, pick in zip(arrivals, picks):
        s = scenarios[int(pick)]
        for _ in range(max(1, s.burst)):
            tail = rng.integers(
                1, vocab,
                size=int(rng.integers(s.prompt_len[0], s.prompt_len[1] + 1)),
                dtype=np.int32,
            )
            prompt = np.concatenate([prefixes[s.name], tail])
            items.append(WorkloadItem(
                at=at,
                scenario=s.name,
                request=Request(
                    prompt=prompt,
                    max_new=int(rng.integers(s.max_new[0], s.max_new[1] + 1)),
                    priority=s.priority,
                    deadline_steps=s.deadline_steps,
                ),
            ))
    items.sort(key=lambda it: it.at)  # stable: ties keep draw order
    return Workload(seed=seed, items=items)


def replay(engine, workload: Workload, *, max_steps: int = 100_000) -> list[Request]:
    """Drive ``workload`` through ``engine`` on the step clock.

    Submits each item the moment the step counter reaches its ``at``
    (idle gaps still advance the clock — open-loop load does not wait for
    the engine), steps once per tick, then drains the tail with
    ``run_until_done`` so a wedged engine surfaces as
    :class:`~repro_torch.launch.serve.EngineStalledError` rather than a silent
    partial replay. Returns the workload's requests; results (tokens,
    stamps, terminal states) ride on them."""
    i, step = 0, 0
    items = workload.items
    while i < len(items) and step < max_steps:
        while i < len(items) and items[i].at <= step:
            engine.submit(items[i].request)
            i += 1
        engine.step()
        step += 1
    engine.run_until_done(max_steps)
    return workload.requests
