"""Learnable transforms: global orthogonal Q (Stiefel) and layer-specific
invertible G in GL(r) via polar parameterization (paper §4.1–4.2).

* ``Q`` is stored directly as an orthogonal matrix and updated with Cayley
  SGD (:mod:`repro_torch.core.manifold`), so it stays on the Stiefel
  manifold to machine precision throughout calibration.
* ``G = P @ S`` with ``P`` orthogonal (same Cayley updates) and
  ``S = exp(gamma) * (L @ L.T)`` symmetric positive definite (L lower-
  triangular with softplus-positive diagonal), so G is always invertible and
  ``G^-1 = exp(-gamma) * (L L^T)^-1 P^T`` takes two triangular solves.
* Hadamard / random-orthogonal constructions serve the fixed-rotation
  baselines (QuaRot-style ablation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "GLParams",
    "gl_init",
    "gl_materialize",
    "gl_inverse",
    "gl_conditioning_penalty",
    "hadamard_matrix",
    "random_orthogonal",
    "orthogonal_init",
    "orthogonality_error",
]


# ---------------------------------------------------------------------------
# G in GL(r): polar parameterization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GLParams:
    """Parameters of G = P * exp(gamma) * (L L^T)."""

    P: torch.Tensor  # (r, r) orthogonal — manifold-updated
    L: torch.Tensor  # (r, r) unconstrained; only the lower triangle is used
    gamma: torch.Tensor  # scalar log-scale


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # the reference's softplus is logaddexp(x, 0); F.softplus switches to x
    # above its threshold instead
    return torch.logaddexp(x, torch.zeros_like(x))


def _chol_factor(L: torch.Tensor) -> torch.Tensor:
    """Lower-triangular factor with strictly positive diagonal."""
    tril = torch.tril(L, diagonal=-1)
    diag = _softplus(torch.diagonal(L)) + 1e-4
    return tril + torch.diag(diag)


def gl_init(r: int, dtype=torch.float32, device=None) -> GLParams:
    """G == I at init (the regularizer keeps G near identity)."""
    # softplus(x) + 1e-4 = 1  =>  x = log(expm1(1 - 1e-4))
    d = float(np.log(np.expm1(1.0 - 1e-4)))
    return GLParams(
        P=torch.eye(r, dtype=dtype, device=device),
        L=torch.diag(torch.full((r,), d, dtype=dtype, device=device)),
        gamma=torch.zeros((), dtype=dtype, device=device),
    )


def gl_materialize(p: GLParams) -> torch.Tensor:
    Lf = _chol_factor(p.L)
    S = torch.exp(p.gamma) * (Lf @ Lf.T)
    return p.P @ S


def gl_inverse(p: GLParams) -> torch.Tensor:
    """exp(-gamma) * (L L^T)^-1 @ P^T via two triangular solves, the lower
    factor first."""
    Lf = _chol_factor(p.L)
    y = torch.linalg.solve_triangular(Lf, p.P.T, upper=False)
    x = torch.linalg.solve_triangular(Lf.T, y, upper=True)
    return torch.exp(-p.gamma) * x


def gl_conditioning_penalty(p: GLParams) -> torch.Tensor:
    """``||diag(L) - 1||^2 + gamma^2`` — keeps G near identity (paper §4.2);
    zero at init, since it penalizes the materialized Cholesky diagonal's
    deviation from 1."""
    d = torch.diagonal(_chol_factor(p.L))
    return torch.sum((d - 1.0) ** 2) + p.gamma ** 2


# ---------------------------------------------------------------------------
# Fixed rotations (baselines) + orthogonal init/checks
# ---------------------------------------------------------------------------

_KRON_ROWS = 256  # rows of the Sylvester factor per block of the Kronecker product


def hadamard_matrix(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized Hadamard-like orthogonal matrix, built in float64 with
    numpy and rounded once to ``dtype``.

    Exact Sylvester Hadamard for powers of two; for n = 2^k * m (m odd > 1)
    kron(H_{2^k}, Q_m) with Q_m a random orthogonal factor seeded by m —
    full Hadamard matrices don't exist for every m, and the role here is only
    "fixed incoherent rotation" (QuaRot baseline), which the kron preserves.
    The Kronecker product is rounded block by block, so a large n (14336 =
    2^11 * 7) never holds the whole float64 matrix."""
    k = n & (-n)  # largest power of two dividing n
    m = n // k
    h = np.array([[1.0]])
    size = 1
    while size < k:
        h = np.block([[h, h], [h, -h]])
        size *= 2
    h = h / np.sqrt(k)
    if m == 1:
        return torch.from_numpy(h).to(dtype=dtype, device=device)
    rng = np.random.default_rng(seed=m)
    q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    out = torch.empty((n, n), dtype=dtype)
    for i in range(0, k, _KRON_ROWS):
        blk = np.kron(h[i:i + _KRON_ROWS], q)
        out[i * m:i * m + blk.shape[0]] = torch.from_numpy(blk).to(dtype)
    return out.to(device)


def random_orthogonal(generator: torch.Generator, n: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """Haar-like orthogonal matrix from ``generator`` (sign-fixed QR of a
    normal matrix), on ``device`` (the generator's by default)."""
    device = generator.device if device is None else device
    a = torch.randn(n, n, generator=generator, device=device, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.to(dtype)


def orthogonal_init(n: int, mode: str = "identity",
                    generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    if mode == "identity":
        return torch.eye(n, dtype=torch.float32, device=device)
    if mode == "hadamard":
        return hadamard_matrix(n, device=device)
    if mode == "random":
        assert generator is not None
        return random_orthogonal(generator, n, device=device)
    raise ValueError(f"unknown orthogonal init {mode!r}")


def orthogonality_error(q: torch.Tensor) -> torch.Tensor:
    n = q.shape[0]
    return torch.max(torch.abs(q.T @ q - torch.eye(n, dtype=q.dtype, device=q.device)))
