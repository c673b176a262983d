"""Prefill-shaped dual-component matmul (M > 8, the paper's §4.3 kernel):
wrappers over the CUDA kernel in ``csrc/twinquant_dual_gemm.cu``.

For a CUDA tensor each wrapper launches the kernel (or raises); for a CPU
tensor it runs the plain version in ``kernels/ref.py``, whose operation order
the kernel follows bit for bit. The kernel masks the ragged M edge itself,
so no padding is needed. An expert-stacked pack takes x (E, M, K): one
launch for all E experts. ``dual_gemm`` and ``dual_gemm_group`` keep their
own launch counts, one a call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.autotune import GEMM_BLOCK_N
from repro_torch.kernels.contracts import validate_dual_gemm, validate_dual_gemm_group
from repro_torch.kernels.cuda_launch import launch_dual
from repro_torch.kernels.ref import TwinQuantGroupWeights, TwinQuantWeights

__all__ = ["dual_gemm", "dual_gemm_group"]


def dual_gemm(x: torch.Tensor, w: TwinQuantWeights) -> torch.Tensor:
    """x (M, K) -> (M, N) bf16 through the prefill kernel."""
    m, k = x.shape[-2:]
    validate_dual_gemm(m, w.ndim_out, k, w.rank, w.group, w.rgroup, GEMM_BLOCK_N)
    if x.device.type == "cpu":
        return _ref.dual_gemm_ref(x, w)
    return launch_dual("dual_gemm", "twinquant_dual_gemm", "tq_dual_gemm", x, w)


def dual_gemm_group(x: torch.Tensor, gw: TwinQuantGroupWeights) -> torch.Tensor:
    """x (M, K) -> (M, sum N_j) bf16: one launch for a fused sibling group."""
    m, k = x.shape[-2:]
    validate_dual_gemm_group(m, k, gw.group, gw.seg_n, gw.seg_r, gw.rgroups, GEMM_BLOCK_N)
    if x.device.type == "cpu":
        return _ref.dual_gemm_group_ref(x, gw)
    return launch_dual("dual_gemm_group", "twinquant_dual_gemm", "tq_dual_gemm", x, gw)
