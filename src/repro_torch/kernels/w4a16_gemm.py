"""Weight-only int4 GEMM (W4A16, the paper's baseline): the wrapper over the
CUDA kernel in ``csrc/w4a16_gemm.cu``.

For a CUDA tensor :func:`w4a16_gemm` launches the kernel (or raises); for a
CPU tensor it runs the plain version ``ref.w4a16_gemm_ref``, which the
kernel follows but for the order of the sum inside a scale group. The kernel
guards the ragged M edge itself, so no padding copy is made. It picks its
schedule by M and N (``autotune.W4A16_DECODE_M``, ``W4A16_DECODE_COL_N``):
decode-sized M splits K across a block's warps, or, for wide N, gives each
warp 16 columns of a 64-column block; larger M runs 64 x 64 tiles. All give
a row the same bits. Launches are counted under ``w4a16_gemm``, one per
call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.autotune import w4a16_blocks
from repro_torch.kernels.contracts import ContractError, validate_w4a16
from repro_torch.kernels.cuda_launch import device_operand, run_kernel

__all__ = ["w4a16_gemm"]

# (x, wp, ws, out, M, N, K, G)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4


def w4a16_gemm(x: torch.Tensor, wp: torch.Tensor, ws: torch.Tensor, *,
               group: int = 128) -> torch.Tensor:
    """x (M, K) bf16, wp (K/2, N) int8, ws (K/G, N) f32 -> (M, N) bf16."""
    m, k = x.shape
    n = wp.shape[1]
    validate_w4a16(m, n, k, group, *w4a16_blocks(group))
    if x.device.type == "cpu":
        return _ref.w4a16_gemm_ref(x, wp, ws, group)
    if x.device.type != "cuda":
        raise ContractError(f"[w4a16_gemm] the CUDA kernel needs a CUDA tensor, got {x.device}")
    dev = x.device
    x_ = device_operand("w4a16_gemm", x, torch.bfloat16, "x", dev)
    wp_ = device_operand("w4a16_gemm", wp, torch.int8, "wp", dev)
    ws_ = device_operand("w4a16_gemm", ws, torch.float32, "ws", dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    args = [x_.data_ptr(), wp_.data_ptr(), ws_.data_ptr(), out.data_ptr(), m, n, k, group]
    run_kernel("w4a16_gemm", "w4a16_gemm", "w4a16_gemm", _ARGS, args, dev)
    return out
