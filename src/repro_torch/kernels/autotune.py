"""Shape regimes and block choice for the Hopper dual-component kernels.

* :data:`DECODE_M_MAX` splits the two regimes, as in the JAX package:
  M <= 8 runs the decode-shaped GEMV, larger M the prefill GEMM.
* :func:`hopper_blocks` is the (rows, column unit, K step) the contracts
  judge a shape by: every segment width is a multiple of the column unit
  (32 for the GEMV, 64 for the GEMM), the K step is one scale group. Whether
  a shape can be tiled at all is the kernels' own contract
  (``kernels/contracts.validate_dual_*``).
* The dual kernels' own tiles: the GEMV's main block takes ``GEMV_TILE_N``
  = 16 columns (one 16-byte chunk of a packed row) on ``GEMV_WARPS`` warps,
  each with a ring of ``GEMV_STAGES`` scale groups; its H pass is one warp
  per (group, 16 columns). The GEMM's tile kernel takes ``GEMM_TILE``
  (128 x 128, four wgmma warpgroups of 64 x 64, the last tile of a segment
  masked to 64), its
  split kernel ``GEMM_SPLIT_TILE`` (16 x 32) with K split over
  ``GEMM_TEAMS`` one-warp teams; both keep rings of ``GEMM_STAGES`` scale
  groups. The split kernel runs the H pass, and the main pass up to
  ``GEMM_SPLIT_M`` rows. Either gives every output the same f32 chain (K
  groups, then V groups, ascending), so an output row's bits never depend
  on how many rows share its launch.
* :func:`w4a16_blocks` is the weight-only kernel's tile: 64 x 64 outputs,
  one scale group a K step, the same for every M. There is no split-K or
  other schedule keyed on M, so an output row's bits never depend on how
  many rows share its launch (``contracts.validate_w4a16`` judges tiling).

A measured, persisted tune cache waits for a later change; when it comes it
keeps its own directory, apart from the reference's ``artifacts/tune/``.
"""

from __future__ import annotations

__all__ = ["DECODE_M_MAX", "GEMM_BLOCK_M", "GEMM_BLOCK_N", "GEMM_SPLIT_M", "GEMM_SPLIT_TILE",
           "GEMM_STAGES", "GEMM_TEAMS", "GEMM_TILE", "GEMV_BLOCK_N", "GEMV_STAGES", "GEMV_TILE_N",
           "GEMV_WARPS", "W4A16_BLOCK_M", "W4A16_BLOCK_N", "hopper_blocks", "regime",
           "w4a16_blocks"]

DECODE_M_MAX = 8
GEMV_BLOCK_N = 32
GEMM_BLOCK_M = 64
GEMM_BLOCK_N = 64
GEMV_TILE_N = 16
GEMV_WARPS = 8
GEMV_STAGES = 3
GEMM_TILE = (128, 128)
GEMM_SPLIT_TILE = (16, 32)
GEMM_TEAMS = 8
GEMM_STAGES = 4
GEMM_SPLIT_M = 64
W4A16_BLOCK_M = 64
W4A16_BLOCK_N = 64


def regime(m: int) -> str:
    """Shape regime of an M (flattened token-row count)."""
    return "decode" if m <= DECODE_M_MAX else "prefill"


def hopper_blocks(m: int, group: int) -> tuple[int, int, int]:
    """(block_m, column unit, block_k) the contracts judge this M by."""
    if m <= DECODE_M_MAX:
        return (DECODE_M_MAX, GEMV_BLOCK_N, group)
    return (GEMM_BLOCK_M, GEMM_BLOCK_N, group)


def w4a16_blocks(group: int) -> tuple[int, int, int]:
    """(block_m, block_n, block_k) of the weight-only CUDA launch, any M."""
    return (W4A16_BLOCK_M, W4A16_BLOCK_N, group)
