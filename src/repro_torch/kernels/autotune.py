"""Shape regimes and block choice for the Hopper dual-component kernels.

* :data:`DECODE_M_MAX` splits the two regimes, as in the JAX package:
  M <= 8 runs the decode-shaped GEMV, larger M the prefill GEMM.
* :func:`hopper_blocks` is the tile the CUDA kernel launches with: the GEMV
  takes 32 columns a block (one per lane), the GEMM a 64 x 64 tile; the K
  step is one scale group in both. Whether a shape can be tiled at all is
  the kernels' own contract (``kernels/contracts.validate_dual_*``).
* :func:`w4a16_blocks` is the weight-only kernel's tile: 64 x 64 outputs,
  one scale group a K step, the same for every M. There is no split-K or
  other schedule keyed on M, so an output row's bits never depend on how
  many rows share its launch (``contracts.validate_w4a16`` judges tiling).

A measured, persisted tune cache waits for a later change; when it comes it
keeps its own directory, apart from the reference's ``artifacts/tune/``.
"""

from __future__ import annotations

__all__ = ["DECODE_M_MAX", "GEMM_BLOCK_M", "GEMM_BLOCK_N", "GEMV_BLOCK_N", "W4A16_BLOCK_M",
           "W4A16_BLOCK_N", "hopper_blocks", "regime", "w4a16_blocks"]

DECODE_M_MAX = 8
GEMV_BLOCK_N = 32
GEMM_BLOCK_M = 64
GEMM_BLOCK_N = 64
W4A16_BLOCK_M = 64
W4A16_BLOCK_N = 64


def regime(m: int) -> str:
    """Shape regime of an M (flattened token-row count)."""
    return "decode" if m <= DECODE_M_MAX else "prefill"


def hopper_blocks(m: int, group: int) -> tuple[int, int, int]:
    """(block_m, block_n, block_k) of the CUDA launch for this M."""
    if m <= DECODE_M_MAX:
        return (DECODE_M_MAX, GEMV_BLOCK_N, group)
    return (GEMM_BLOCK_M, GEMM_BLOCK_N, group)


def w4a16_blocks(group: int) -> tuple[int, int, int]:
    """(block_m, block_n, block_k) of the weight-only CUDA launch, any M."""
    return (W4A16_BLOCK_M, W4A16_BLOCK_N, group)
