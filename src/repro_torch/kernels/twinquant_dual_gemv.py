"""Decode-shaped dual-component matmul (M <= 8): wrappers over the CUDA
kernel in ``csrc/twinquant_dual_gemv.cu``.

For a CUDA tensor each wrapper launches the kernel (or raises); for a CPU
tensor it runs the plain version in ``kernels/ref.py``, whose operation order
the kernel follows bit for bit. An expert-stacked pack takes x (E, M, K):
one launch for all E experts (``gridDim.z = E``), each expert's rows those
of that expert launched alone. ``dual_gemv`` and ``dual_gemv_group`` keep
their own launch counts (``cuda_launch.launch_counts()``), one a call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.autotune import DECODE_M_MAX, GEMV_BLOCK_N
from repro_torch.kernels.contracts import validate_dual_gemv, validate_dual_gemv_group
from repro_torch.kernels.cuda_launch import launch_dual
from repro_torch.kernels.ref import TwinQuantGroupWeights, TwinQuantWeights

__all__ = ["dual_gemv", "dual_gemv_group", "DECODE_M_MAX"]


def dual_gemv(x: torch.Tensor, w: TwinQuantWeights) -> torch.Tensor:
    """x (M<=8, K) -> (M, N) bf16 through the decode kernel."""
    m, k = x.shape[-2:]
    validate_dual_gemv(m, w.ndim_out, k, w.rank, w.group, w.rgroup, GEMV_BLOCK_N,
                       decode_m_max=DECODE_M_MAX)
    if x.device.type == "cpu":
        return _ref.dual_gemm_ref(x, w)
    return launch_dual("dual_gemv", "twinquant_dual_gemv", "tq_dual_gemv", x, w,
                       h_planes=k // w.group)


def dual_gemv_group(x: torch.Tensor, gw: TwinQuantGroupWeights) -> torch.Tensor:
    """x (M<=8, K) -> (M, sum N_j) bf16: one launch for a fused sibling group
    (X quantized once, H built once over the stacked rank, each N block's V
    epilogue from the segment that owns it)."""
    m, k = x.shape[-2:]
    validate_dual_gemv_group(m, k, gw.group, gw.seg_n, gw.seg_r, gw.rgroups, GEMV_BLOCK_N,
                             decode_m_max=DECODE_M_MAX)
    if x.device.type == "cpu":
        return _ref.dual_gemm_group_ref(x, gw)
    return launch_dual("dual_gemv_group", "twinquant_dual_gemv", "tq_dual_gemv", x, gw,
                       h_planes=k // gw.group)
