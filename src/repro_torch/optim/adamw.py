"""AdamW (decoupled weight decay) of the port: the reference's update
(``repro/optim/adamw.py``) written out in f32 on the card.

It is not ``torch.optim.AdamW``, which does its arithmetic in the
parameter's dtype (bf16 here), keeps bf16 moments and decays as ``p (1 -
lr wd)``. Here every leaf is upcast to f32: global-norm clipping over all
leaves, bias correction ``1 - b^count`` in f32, ``new_p = p32 - lr (step +
decay p32)`` cast back to the parameter's dtype, moments kept in
``moment_dtype`` (f32 by default).

Which leaves decay is the reference's rule, ``ndim >= 2`` ("no decay on
norms"), taken on the reference's tree: the reference stacks every
per-layer leaf on a leading layer axis, so a layer's ``ln1`` is ``(L, d)``
there and decays, while unstacked 1-D leaves (``ln_f``, DeepSeek's
``mtp.ln_in``, Zamba2's shared block's norms) do not. The port keeps one
module per layer, so each parameter's flag comes from the reference leaf it
lands in (``interop.reference_ndim``), not from its own ``ndim``.

State is ``AdamWState(mu, nu, count)``: ``mu`` / ``nu`` by the port's
parameter names, ``count`` an int32 scalar on the parameters' device. An
update writes the parameters and the moments in place, one leaf at a time
(so the f32 temporaries of one leaf are alive at once), and returns them
with a new ``count``.

Sharded (the parameters DTensors of the sharded train step): each moment
lives in its own placements (``init``'s ``placements``, from
``launch.sharding.opt_state_specs``). The update is computed on the
moment's shard, the gradient and the parameter taken onto the moment's
placements first, and the new parameter shard is redistributed to the
parameter's placements (ZeRO-1 when a replicated parameter has sharded
moments: an all-gather). Every op is elementwise, so a shard's update has
the bits of the same rows updated on one device. The global norm sums each
leaf's local sum of squares over the mesh dims that shard it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.interop import named_tensors, reference_ndim
from repro_torch.models.context import local_shard, reduce_over_shards, shard_like

__all__ = ["AdamW", "AdamWState"]


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device: divisions by it stay true
    divisions (CUDA turns a division by a host scalar into a reciprocal
    multiply)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32
    clip_norm: Optional[float] = 1.0

    def init(self, params, placements: Optional[dict] = None) -> AdamWState:
        """Zero moments; a DTensor parameter's in ``placements[name]``
        (default: the parameter's own) on its mesh."""
        from torch.distributed.tensor import DTensor, zeros as dzeros

        named = named_tensors(params)

        def z(n, p):
            if isinstance(p, DTensor):
                pl = (placements or {}).get(n, p.placements)
                return dzeros(p.shape, dtype=self.moment_dtype, device_mesh=p.device_mesh,
                              placements=pl)
            return torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device)

        dev = local_shard(next(iter(named.values()))).device
        return AdamWState(mu={n: z(n, p) for n, p in named.items()},
                          nu={n: z(n, p) for n, p in named.items()},
                          count=torch.zeros((), dtype=torch.int32, device=dev))

    def decays(self, params) -> dict:
        """``{name: bool}``: whether the reference decays the leaf (its
        stacked ``ndim >= 2``)."""
        return {n: reference_ndim(n, p) >= 2 for n, p in named_tensors(params).items()}

    @torch.no_grad()
    def clip_factor(self, grads: dict) -> Optional[torch.Tensor]:
        """``min(1, clip_norm / (global norm + 1e-12))`` as an f32 0-d tensor
        (None without clipping): the reference's Python sum over its leaves,
        then one sqrt."""
        if self.clip_norm is None:
            return None
        gn = torch.sqrt(sum(reduce_over_shards(torch.sum(local_shard(g).to(torch.float32) ** 2), g)
                            for g in grads.values()))
        return torch.clamp(_full(self.clip_norm, gn) / (gn + 1e-12), max=1.0)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params):
        """One step: ``grads`` by name (any float dtype). Writes the
        parameters and ``state``'s moments in place; returns (params,
        AdamWState with the new count)."""
        return self.apply(grads, state, params, self.clip_factor(grads))

    @torch.no_grad()
    def apply(self, grads: dict, state: AdamWState, params, factor: Optional[torch.Tensor]):
        """:meth:`update` with the clip ``factor`` given (None: no clip)."""
        f32 = torch.float32
        named = named_tensors(params)
        count = state.count + 1
        cf = count.to(f32)
        b1c = 1 - torch.pow(_full(self.b1, cf), cf)
        b2c = 1 - torch.pow(_full(self.b2, cf), cf)
        decays = self.decays(named)
        for n, p in named.items():
            mu, nu = state.mu[n], state.nu[n]
            g = _onto(grads[n], mu)
            if factor is not None:
                # a bf16 leaf times the f32 factor is f32 in the reference
                g = g.to(f32) * factor
            g32 = g.to(f32)
            mu32 = self.b1 * local_shard(mu).to(f32) + (1 - self.b1) * g32
            nu32 = self.b2 * local_shard(nu).to(f32) + (1 - self.b2) * g32 * g32
            step = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + self.eps)
            decay = self.weight_decay if decays[n] else 0.0
            p32 = _onto(p, mu).to(f32)
            _write(p, (p32 - self.lr * (step + decay * p32)).to(p.dtype), mu)
            local_shard(mu).copy_(mu32.to(self.moment_dtype))
            local_shard(nu).copy_(nu32.to(self.moment_dtype))
        return params, AdamWState(mu=state.mu, nu=state.nu, count=count)


def _onto(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``'s local shard in ``like``'s placements (a DTensor ``like``)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return t
    return t.redistribute(like.device_mesh, like.placements).to_local()


def _write(p: torch.Tensor, new: torch.Tensor, like: torch.Tensor) -> None:
    """In place: the parameter ``p`` from ``new``, its shard in ``like``'s
    placements, redistributed to ``p``'s."""
    from torch.distributed.tensor import DTensor

    if isinstance(like, DTensor):
        new = shard_like(new, like).redistribute(p.device_mesh, p.placements).to_local()
    local_shard(p).copy_(new)
