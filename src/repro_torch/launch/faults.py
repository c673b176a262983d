"""Seeded, deterministic fault injection for the port's serving engine: the
reference's ``repro/launch/faults.py``.

:class:`FaultInjector` perturbs exactly one thing at one point,
reproducibly, so a test can hold the engine's recovery invariants
(unaffected requests give the tokens of a fault-free run, the allocator
audit holds after every step) and not just survival. Faults on offer:

* :meth:`deny_alloc` — ``PageAllocator.alloc`` reports exhaustion at the Nth
  call (admission back-pressure, a preemption trigger, without shrinking
  the pool);
* :meth:`force_ref_dispatch` — every dispatch entry takes its plain version
  (``<kind>/ref[forced]``): the degraded mode when a kernel is suspect;
* :meth:`tamper_pack` — a model whose one TwinQuant pack has ``rp`` cut along
  K, so the next call through it raises a ``ContractError`` (the engine's
  quarantine-on-prefill-exception path);
* :meth:`corrupt_logits` — one slot's row of the downloaded logits poisoned
  at the Nth tap of the engine's sync points (the finite-logits guard).

Every injection logs an entry and pushes an undo; :meth:`restore` (or
leaving the ``with`` block) unwinds them last-in first-out, so a fault
cannot leak into the next test.

All injection is on the host (allocator calls, the logits tap, the model
before the engine is built): no kernel and no captured step graph is
patched, which keeps an injected run comparable with a clean one.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from repro_torch.kernels import dispatch
from repro_torch.models import common as C

__all__ = ["FaultInjector"]

# sibling keys the fusion pass merges when the engine is built
# (core.twinquant.FUSE_GROUPS): a tampered one would fail fuse_params before
# the engine exists, not in a prefill
_FUSABLE_KEYS = frozenset({"q", "k", "v", "gate", "up", "qkv", "gate_up"})


class FaultInjector:
    """Deterministic, seeded fault injection with last-in first-out undo.

    Use as a context manager so faults cannot outlive the test::

        with FaultInjector(seed=0) as fi:
            fi.deny_alloc(engine, at_call=3)
            engine.serve(requests)
    """

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.log: list[dict] = []
        self._undo: list = []

    def _note(self, kind: str, **info) -> None:
        self.log.append({"kind": kind, **info})

    def restore(self) -> None:
        """Unwind every active injection, the most recent first."""
        while self._undo:
            self._undo.pop()()

    def __enter__(self) -> "FaultInjector":
        return self

    def __exit__(self, *exc) -> None:
        self.restore()

    def deny_alloc(self, engine, at_call: int, count: int = 1) -> None:
        """Make the engine's ``PageAllocator.alloc`` return None for calls
        ``at_call .. at_call + count - 1`` (1-based, counted from now);
        ``count=0`` denies every call from ``at_call`` on. The free list is
        untouched: this is back-pressure only."""
        allocator = engine.allocator
        orig = allocator.alloc
        calls = [0]

        def flaky_alloc(n):
            calls[0] += 1
            c = calls[0]
            if c >= at_call and (count == 0 or c < at_call + count):
                self._note("deny_alloc", call=c, n=n)
                return None
            return orig(n)

        allocator.alloc = flaky_alloc
        self._undo.append(lambda: setattr(allocator, "alloc", orig))

    def force_ref_dispatch(self) -> None:
        """Route every dispatch entry called from now on to its plain version
        (``<kind>/ref[forced]``), on the card too. Build the engine under
        test after this, with ``step_graphs=False`` on the card: a step
        graph keeps the routes of its capture (replaying one captured before
        the flip raises), and the plain paged decode writes its draft rows
        through a boolean mask, which a capture refuses."""
        prev = dispatch.set_force_ref(True)
        self._note("force_ref_dispatch", prev=prev)
        self._undo.append(lambda: dispatch.set_force_ref(prev))

    def tamper_pack(self, params: nn.Module) -> nn.Module:
        """A model like ``params`` with ONE non-fusable TwinQuant pack (an
        attention ``o`` or an MLP ``down`` of one layer, chosen by the
        injector's rng) whose ``rp`` is cut by one packed row along K: the
        dispatch contract rejects it with a ContractError at the next call,
        inside the engine's prefill. Only the modules on the path to the
        victim are new; every tensor is shared with ``params``, so on the
        card it costs no second model. (The reference deep-copies its
        stacked pytree, where one ``o`` pack holds every layer's, so its
        victim list has two entries where this one has two a layer.)"""
        from repro_torch.core.twinquant import _rebuild
        from repro_torch.models.common import TwinQuantLinear

        packs: list[tuple[str, ...]] = []

        def walk(mod: nn.Module, path: tuple) -> None:
            for key, sub in mod._modules.items():
                if isinstance(sub, TwinQuantLinear) and key not in _FUSABLE_KEYS:
                    packs.append(path + (key,))
                elif sub is not None:
                    walk(sub, path + (key,))

        walk(params, ())
        if not packs:
            raise ValueError("tamper_pack: no non-fusable TwinQuant pack in params")
        victim = packs[int(self.rng.integers(len(packs)))]

        def rebuilt(mod: nn.Module, path: tuple) -> nn.Module:
            if not path:
                new = _rebuild(mod, {})
                new.rp = mod.rp[..., :-1, :]
                return new
            children = dict(mod._modules)
            children[path[0]] = rebuilt(children[path[0]], path[1:])
            return _rebuild(mod, children)

        tampered = rebuilt(params, victim)
        pack = tampered.get_submodule(".".join(victim))
        self._note("tamper_pack", path="/".join(victim), rp_shape=tuple(pack.rp.shape))
        return tampered

    def corrupt_logits(self, slot: int, at_call: int = 1, tag: str = "decode",
                       value: float = float("nan")) -> None:
        """Poison slot ``slot``'s row of the downloaded logits at the Nth
        tap (1-based) whose tag is ``tag`` (``"prefill"``, ``"decode"`` (the
        verify step too) or ``"ragged"``). The host array is copied before
        the write, so nothing upstream (device buffers, other rows) is
        touched: the rest of the batch must keep its tokens."""
        calls = [0]

        def tap(last, t):
            if t != tag:
                return last
            calls[0] += 1
            if calls[0] != at_call:
                return last
            self._note("corrupt_logits", slot=slot, tag=t, call=at_call)
            last = np.array(last, copy=True)
            if last.ndim == 1:
                last[:] = value
            else:
                last[slot] = value
            return last

        prev = C.set_logits_tap(tap)
        self._undo.append(lambda: C.set_logits_tap(prev))
