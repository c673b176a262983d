"""Symmetric quantization conventions (paper Eq. 1).

``q = clip(round(x / s), -qmax, qmax)`` with ``s = max|group| / qmax`` and
``qmax = 2**(bits-1) - 1``; ``torch.round`` rounds half to even, like the
reference's ``jnp.round`` and CUDA's ``rintf``.
"""

from __future__ import annotations

__all__ = ["qmax_for_bits"]


def qmax_for_bits(bits: int) -> int:
    return 2 ** (bits - 1) - 1
