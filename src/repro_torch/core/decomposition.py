"""Weight decomposition: SmoothQuant-style smoothing + SVD low-rank split.

Pipeline (paper §2, §4.1):

1. ``lambda_i = max|X[:, i]|^alpha / max|W[i, :]|^(1-alpha)`` per input
   channel; ``X_hat = X diag(lambda)^-1``, ``W_hat = diag(lambda) W``.
   ``alpha`` is grid-searched per layer to minimize post-TwinQuant MSE.
2. Truncated SVD of ``W_hat``: ``U V`` with a *sqrt-balanced* magnitude split
   (``U = U_r sqrt(S_r)``, ``V = sqrt(S_r) V_r^T``) — balancing the factor
   magnitudes lowers their 4-bit dynamic range, since TwinQuant quantizes
   both factors.
3. ``R = W_hat - U V`` residual.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.core.quantization import QuantConfig, fake_quant

__all__ = [
    "Decomposition",
    "smoothing_factors",
    "apply_smoothing",
    "svd_decompose",
    "decompose",
    "search_alpha",
]


@dataclasses.dataclass
class Decomposition:
    """W_hat = U @ V + R, with the smoothing vector that produced W_hat."""

    U: torch.Tensor  # (m, r)
    V: torch.Tensor  # (r, n)
    R: torch.Tensor  # (m, n)
    lam: torch.Tensor  # (m,) smoothing factors (identity == ones)

    @property
    def rank(self) -> int:
        return self.U.shape[1]

    def reconstruct(self) -> torch.Tensor:
        return self.U @ self.V + self.R


def smoothing_factors(act_absmax: torch.Tensor, w_absmax: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """Per-channel lambda (paper A.6). Zero-safe on both sides."""
    a = torch.clamp(act_absmax, min=1e-5)
    w = torch.clamp(w_absmax, min=1e-5)
    lam = a ** alpha / w ** (1.0 - alpha)
    return torch.clamp(lam, min=1e-5)


def apply_smoothing(x: torch.Tensor, w: torch.Tensor, lam: torch.Tensor):
    """Returns (x diag(lam)^-1, diag(lam) w)."""
    return x / lam[None, :], w * lam[:, None]


def svd_decompose(w: torch.Tensor, rank: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Truncated SVD with sqrt-balanced factors; returns (U, V, R) in f32.
    A leading axis (an MoE layer's stacked experts) is one batched SVD."""
    w = w.to(torch.float32)
    u, s, vt = torch.linalg.svd(w, full_matrices=False)
    r = min(rank, s.shape[-1])
    sq = torch.sqrt(s[..., :r])
    U = u[..., :r] * sq[..., None, :]
    V = sq[..., :, None] * vt[..., :r, :]
    R = w - U @ V
    return U, V, R


def decompose(w: torch.Tensor, rank: int, act_absmax: Optional[torch.Tensor] = None,
              alpha: Optional[float] = None) -> Decomposition:
    """Smooth (optional) + SVD split."""
    m = w.shape[0]
    if act_absmax is not None and alpha is not None:
        lam = smoothing_factors(act_absmax, torch.amax(torch.abs(w), dim=1), alpha)
    else:
        lam = torch.ones((m,), dtype=torch.float32, device=w.device)
    w_hat = w * lam[:, None]
    U, V, R = svd_decompose(w_hat, rank)
    return Decomposition(U=U, V=V, R=R, lam=lam)


def _twinquant_mse(x: torch.Tensor, w: torch.Tensor, lam: torch.Tensor, rank: int,
                   wq: QuantConfig, aq: QuantConfig) -> torch.Tensor:
    """Layer-output MSE after smoothing + decomposition + fake 4-bit quant."""
    x_hat = x / lam[None, :]
    w_hat = w * lam[:, None]
    U, V, R = svd_decompose(w_hat, rank)
    dt = torch.promote_types(x.dtype, w.dtype)  # a bf16 tap meets an f32 weight
    y_ref = x.to(dt) @ w.to(dt)
    xq = fake_quant(x_hat, aq) if aq.bits < 16 else x_hat
    # group quantizers need the group axis divisible; U/V rank axis uses one group
    uq_cfg = wq.replace(axis=0, group_size=min(wq.group_size, U.shape[0]))
    vq_cfg = wq.replace(axis=0, group_size=min(wq.group_size, V.shape[0]))
    rq_cfg = wq.replace(axis=0, group_size=min(wq.group_size, R.shape[0]))
    y = xq @ (fake_quant(U, uq_cfg) @ fake_quant(V, vq_cfg) + fake_quant(R, rq_cfg))
    return torch.mean((y - y_ref) ** 2)


@torch.no_grad()
def search_alpha(x: torch.Tensor, w: torch.Tensor, rank: int, wq: QuantConfig,
                 aq: QuantConfig,
                 alphas: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0)
                 ) -> tuple[float, torch.Tensor]:
    """Grid search the migration strength alpha (paper A.6).

    Returns (best_alpha, best_lambda); the first alpha wins a tie. Each
    candidate is evaluated under the full decomposition + fake-quant path."""
    act_absmax = torch.amax(torch.abs(x), dim=0)
    w_absmax = torch.amax(torch.abs(w), dim=1)
    best = (None, math.inf, None)
    for a in alphas:
        lam = smoothing_factors(act_absmax, w_absmax, a)
        mse = float(_twinquant_mse(x, w, lam, rank, wq, aq))
        if mse < best[1]:
            best = (a, mse, lam)
    return best[0], best[2]
