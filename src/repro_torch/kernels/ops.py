"""The reference's stable kernel API (``repro/kernels/ops.py``) over the
port's dispatch layer.

:func:`twinquant_matmul` and :func:`w4a16_matmul` route through
``kernels/dispatch`` (``quant_linear`` / ``w4a16_linear``): the CUDA kernels
for CUDA tensors, the plain versions for CPU tensors. ``use_ref=True``
forces the plain version (route ``ref[forced]``) on any device. The
reference's explicit ``block_*`` / ``interpret`` arguments have no
counterpart: each CUDA kernel has one tile per regime.

:func:`pick_blocks` returns the prefill (dual GEMM) launch tile for a shape
the kernel's contract accepts, else ``None`` (the shape routes ``ref``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.autotune import GEMM_BLOCK_M, GEMM_BLOCK_N
from repro_torch.kernels.contracts import ContractError, validate_dual_gemm
from repro_torch.kernels.ref import TwinQuantWeights, pack_twinquant_weights  # re-export

__all__ = ["TwinQuantWeights", "pack_twinquant_weights", "pick_blocks", "twinquant_matmul",
           "w4a16_matmul"]


def pick_blocks(m: int, n: int, k: int, group: int,
                rank: int = 32) -> Optional[tuple[int, int, int]]:
    """The prefill-regime dual GEMM tile for (M, N, K), ``None`` when its
    contract refuses the shape. ``rank`` (the low-rank branch, rank group
    ``min(group, rank)``) takes part in that contract."""
    try:
        validate_dual_gemm(m, n, k, rank, group, min(group, rank), GEMM_BLOCK_N)
    except ContractError:
        return None
    return (GEMM_BLOCK_M, GEMM_BLOCK_N, group)


def _forced(use_ref: bool, fn):
    if not use_ref:
        return fn()
    prev = dispatch.set_force_ref(True)
    try:
        return fn()
    finally:
        dispatch.set_force_ref(prev)


def twinquant_matmul(x: torch.Tensor, w: TwinQuantWeights, bias: Optional[torch.Tensor] = None,
                     *, use_ref: bool = False) -> torch.Tensor:
    """y = TwinQuant(x) for x of shape (..., K); returns (..., N) bf16."""
    return _forced(use_ref, lambda: dispatch.quant_linear(x, w, bias))


def w4a16_matmul(x: torch.Tensor, wp: torch.Tensor, ws: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, group: int = 128,
                 use_ref: bool = False) -> torch.Tensor:
    """Weight-only int4 linear for x of shape (..., K); returns (..., N) bf16."""
    return _forced(use_ref, lambda: dispatch.w4a16_linear(x, wp, ws, bias, group=group))
