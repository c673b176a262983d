"""Weight decomposition for the serving quantizer: truncated SVD with
sqrt-balanced factors (``U = U_r sqrt(S_r)``, ``V = sqrt(S_r) V_r^T``) and
the residual ``R = W - U V``. Balancing the factor magnitudes lowers their
4-bit dynamic range, since TwinQuant quantizes both factors."""

from __future__ import annotations

import torch

__all__ = ["svd_decompose"]


def svd_decompose(w: torch.Tensor, rank: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Truncated SVD with sqrt-balanced factors; returns (U, V, R) in f32."""
    w = w.to(torch.float32)
    u, s, vt = torch.linalg.svd(w, full_matrices=False)
    r = min(rank, s.shape[0])
    sq = torch.sqrt(s[:r])
    U = u[:, :r] * sq[None, :]
    V = sq[:, None] * vt[:r, :]
    R = w - U @ V
    return U, V, R
