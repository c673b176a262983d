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

An expert-stacked pack (an MoE layer's experts: ``wp`` (E, K/2, N), ``ws``
(E, K/G, N)) takes x (E, M, K) and runs ONE launch for all E experts, the
counterpart of the reference's ``jax.vmap`` over its ``pallas_call``: every
block offsets its operands by its expert's strides (``gridDim.z = E``), and
an expert's slice of the launch is that expert launched alone, bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.autotune import w4a16_blocks
from repro_torch.kernels.contracts import ContractError, validate_w4a16
from repro_torch.kernels.cuda_launch import device_operand, run_kernel

__all__ = ["w4a16_gemm"]

# (x, wp, ws, out, E, M, N, K, G, then the per-expert element strides of x,
#  wp, ws, out)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4


def w4a16_gemm(x: torch.Tensor, wp: torch.Tensor, ws: torch.Tensor, *,
               group: int = 128) -> torch.Tensor:
    """x (M, K) bf16, wp (K/2, N) int8, ws (K/G, N) f32 -> (M, N) bf16; an
    expert-stacked pack (``wp`` (E, K/2, N), ``ws`` (E, K/G, N)) takes x (E,
    M, K) -> (E, M, N) in one launch."""
    stacked = wp.ndim == 3
    if x.ndim != wp.ndim or (stacked and x.shape[0] != wp.shape[0]):
        want = f"(E={wp.shape[0]}, M, K)" if stacked else "(M, K)"
        raise ContractError(f"[w4a16_gemm] x must be {want} for a pack of shape "
                            f"{tuple(wp.shape)}, got {tuple(x.shape)}")
    m, k = x.shape[-2:]
    n = wp.shape[-1]
    e = wp.shape[0] if stacked else 1
    validate_w4a16(m, n, k, group, *w4a16_blocks(group), experts=e)
    if x.device.type == "cpu":
        return _ref.w4a16_gemm_ref(x, wp, ws, group)
    if x.device.type != "cuda":
        raise ContractError(f"[w4a16_gemm] the CUDA kernel needs a CUDA tensor, got {x.device}")
    dev = x.device
    x_ = device_operand("w4a16_gemm", x, torch.bfloat16, "x", dev)
    wp_ = device_operand("w4a16_gemm", wp, torch.int8, "wp", dev)
    ws_ = device_operand("w4a16_gemm", ws, torch.float32, "ws", dev)
    out = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=dev)
    strides = [m * k, wp_[0].numel(), ws_[0].numel(), m * n] if stacked else [0] * 4
    args = [x_.data_ptr(), wp_.data_ptr(), ws_.data_ptr(), out.data_ptr(), e, m, n, k, group,
            *strides]
    run_kernel("w4a16_gemm", "w4a16_gemm", "w4a16_gemm", _ARGS, args, dev)
    return out
