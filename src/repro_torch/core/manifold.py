"""Hybrid manifold optimizer (paper §4.2).

Updates each parameter according to its geometry:

* Stiefel-manifold parameters (the global rotation Q and the P factor of G)
  use **Cayley SGD with momentum** (Li et al., 2020):

      W_hat = M @ Q^T            (momentum-averaged Euclidean grad lifted)
      Y     = W_hat - W_hat^T    (skew-symmetric tangent)
      Q'    = (I - a/2 Y)^(-1) (I + a/2 Y) Q

  The Cayley map keeps Q orthogonal up to linear-solve precision; a
  sign-fixed QR re-orthonormalizes every ``reortho_every`` steps against f32
  drift over long calibrations.

* Euclidean parameters (L, gamma) use classical momentum SGD; the
  conditioning regularizer is part of the caller's loss.

The optimizer is functional, written by hand over a params tree (dicts and
:class:`~repro_torch.core.transforms.GLParams`): ``init`` returns a state,
``update`` maps (grads, state, params) -> (new_params, new_state). Unlike a
``torch.optim`` optimizer it keeps the reference's semantics exactly: the
gradient clip takes the global norm over *every* leaf, frozen ones included;
momentum advances for every leaf on every step; the step count runs across
stages; and the periodic QR runs on every Stiefel leaf even when its
learning-rate scale is 0. Stage masking (the three-stage schedule) is a
per-leaf learning-rate scale — see :mod:`repro_torch.core.calibration`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.transforms import GLParams

__all__ = ["HybridOpt", "HybridState", "cayley_step", "is_stiefel_path", "tree_leaves",
           "tree_map"]


def tree_leaves(tree: Any) -> list:
    """Leaves of a params tree in the reference's pytree order: dict keys
    sorted, ``GLParams`` as (P, L, gamma)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, GLParams):
        return [tree.P, tree.L, tree.gamma]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of trees of one structure, visited in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, GLParams):
        return GLParams(*(fn(*leaves) for leaves in zip(
            (tree.P, tree.L, tree.gamma), *((r.P, r.L, r.gamma) for r in rest))))
    return fn(tree, *rest)


def cayley_step(q: torch.Tensor, skew: torch.Tensor, lr: float) -> torch.Tensor:
    """One Cayley-transform retraction: (I - a/2 Y)^-1 (I + a/2 Y) Q."""
    n = q.shape[0]
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    a = lr * 0.5  # a product, exact like the reference's lr / 2
    return torch.linalg.solve(eye - a * skew, (eye + a * skew) @ q)


def _lift_skew(grad: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    w_hat = grad @ q.T
    return w_hat - w_hat.T


def _reortho(q: torch.Tensor) -> torch.Tensor:
    qq, rr = torch.linalg.qr(q)
    return qq * torch.sign(torch.diagonal(rr))[None, :]


class HybridState(NamedTuple):
    momentum: Any  # tree matching params
    count: int  # steps taken, across stages (host-side: no device sync)


@dataclasses.dataclass(frozen=True)
class HybridOpt:
    """Hybrid Stiefel/Euclidean optimizer over a params tree.

    ``stiefel_mask`` is a tree of booleans (same structure as params)
    marking which leaves live on the Stiefel manifold."""

    lr: float = 5e-3
    momentum: float = 0.9
    reortho_every: int = 64
    # global-norm gradient clipping — the G-branch (L, gamma) gradients are
    # scaled by ||U||·||V|| and explode on outlier-heavy layers without it
    clip_norm: float = 1.0

    def init(self, params: Any) -> HybridState:
        return HybridState(momentum=tree_map(torch.zeros_like, params), count=0)

    @torch.no_grad()
    def update(self, grads: Any, state: HybridState, params: Any, stiefel_mask: Any,
               lr_scale: Any = None) -> tuple[Any, HybridState]:
        """lr_scale: optional tree of per-leaf multipliers (stage masking)."""
        if lr_scale is None:
            lr_scale = tree_map(lambda _: 1.0, params)

        if self.clip_norm is not None:
            total = 0
            for g in tree_leaves(grads):
                total = total + torch.sum(g.to(torch.float32) ** 2)
            gnorm = torch.sqrt(total)
            # a quotient of tensors (a Python divisor turns into a reciprocal
            # multiply on CUDA)
            factor = torch.clamp(torch.full_like(gnorm, self.clip_norm) / (gnorm + 1e-12),
                                 max=1.0)
            grads = tree_map(lambda g: g * factor, grads)

        new_m = tree_map(lambda m, g: self.momentum * m + g, state.momentum, grads)
        count = state.count + 1
        do_reortho = count % self.reortho_every == 0

        def leaf_update(p, m, is_stiefel, scale):
            eff_lr = self.lr * scale
            if is_stiefel:
                q = cayley_step(p, _lift_skew(m, p), -eff_lr)  # descend: negative step
                return _reortho(q) if do_reortho else q
            return p - eff_lr * m

        new_params = tree_map(leaf_update, params, new_m, stiefel_mask, lr_scale)
        return new_params, HybridState(momentum=new_m, count=count)


def is_stiefel_path(path: tuple) -> bool:
    """Default mask rule: leaves named 'Q', 'Q1', 'Q2', or 'P' are Stiefel."""
    names = {getattr(p, "name", getattr(p, "key", p)) for p in path}
    return bool(names & {"Q", "Q1", "Q2", "P"})
