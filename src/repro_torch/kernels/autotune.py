"""Shape regimes and block choice for the Hopper kernels.

* :data:`DECODE_M_MAX` splits the two regimes, as in the JAX package:
  M <= 8 runs the decode-shaped GEMV, larger M the prefill GEMM.
* :func:`hopper_blocks` is the (rows, column unit, K step) the contracts
  judge a shape by: every segment width is a multiple of the column unit
  (32 for the GEMV, 64 for the GEMM) or, below one unit, even (one masked
  tile: xLSTM's gate linear, N = 8), the K step is one scale group. Whether
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
* :func:`w4a16_blocks` is what the weight-only kernel's contract judges a
  shape by: 64-column units of N (or an even N below 64, one masked
  tile), one scale group a K step, for every M.
  Its schedule has three shapes. Up to ``W4A16_DECODE_M`` rows and N below
  ``W4A16_DECODE_COL_N``, a block takes ``W4A16_DECODE_N`` = 16 columns and
  splits K over its ``W4A16_DECODE_WARPS`` = 8 warps, each warp taking
  every 8th scale group through its own ring of ``W4A16_DECODE_STAGES``
  slots; the warps park each group's f32 term and one
  thread per output adds them in ascending group order. Wider N (gate /
  up): a block of four warps takes 64 columns, one warp each 16, and walks
  all groups with one ring of ``W4A16_COL_STAGES`` slots, each output's
  chain in one thread's registers. Larger M runs the 64 x 64 tile, one
  block walking all groups. All three take each group's term by the same
  MMA sequence (x as A, k16 steps ascending from zero) and add the terms to
  one f32 chain per output in ascending order, so an output row's bits
  never depend on M or on which schedule ran it.
* :data:`PAGED_CHUNK` is both attention kernels' split of the key range
  (``paged_decode_kernel`` and ``ragged_attention_kernel`` share one tile
  body, ``csrc/attention_common.cuh``): one block per chunk of 256
  absolute positions (four ``PAGED_TILE`` = 64-key tiles), a fixed grid
  that never depends on the row, sq, the chunking or the launch, so
  stacked draft rows keep the bits of sequential one-row launches and a
  prompt row keeps its bits however the prompt was chunked. At llama3-8b's
  decode batch (8 slots of up to 2048 keys) it gives about 200 working
  blocks for 132 SMs; at the ragged table case (T = 256) about 800.

A measured, persisted tune cache waits for a later change; when it comes it
keeps its own directory, apart from the reference's ``artifacts/tune/``.
"""

from __future__ import annotations

__all__ = ["DECODE_M_MAX", "GEMM_BLOCK_M", "GEMM_BLOCK_N", "GEMM_SPLIT_M", "GEMM_SPLIT_TILE",
           "GEMM_STAGES", "GEMM_TEAMS", "GEMM_TILE", "GEMV_BLOCK_N", "GEMV_STAGES", "GEMV_TILE_N",
           "GEMV_WARPS", "PAGED_CHUNK", "PAGED_TILE", "W4A16_BLOCK_M", "W4A16_BLOCK_N",
           "W4A16_COL_STAGES", "W4A16_DECODE_COL_N", "W4A16_DECODE_M", "W4A16_DECODE_N",
           "W4A16_DECODE_STAGES", "W4A16_DECODE_WARPS", "hopper_blocks", "regime", "w4a16_blocks"]

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
W4A16_DECODE_M = 32
W4A16_DECODE_N = 16
W4A16_DECODE_STAGES = 2
W4A16_DECODE_WARPS = 8
W4A16_DECODE_COL_N = 8192
W4A16_COL_STAGES = 4
PAGED_TILE = 64
PAGED_CHUNK = 256


def regime(m: int) -> str:
    """Shape regime of an M (flattened token-row count)."""
    return "decode" if m <= DECODE_M_MAX else "prefill"


def hopper_blocks(m: int, group: int) -> tuple[int, int, int]:
    """(block_m, column unit, block_k) the contracts judge this M by."""
    if m <= DECODE_M_MAX:
        return (DECODE_M_MAX, GEMV_BLOCK_N, group)
    return (GEMM_BLOCK_M, GEMM_BLOCK_N, group)


def w4a16_blocks(group: int) -> tuple[int, int, int]:
    """(block_m, block_n, block_k) the weight-only launch's contract judges
    any M by."""
    return (W4A16_BLOCK_M, W4A16_BLOCK_N, group)

