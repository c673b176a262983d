"""Launch contracts for the Hopper dual-component kernels.

* :func:`check_twinquant_pack` / :func:`check_twinquant_group_pack` — shape
  and dtype consistency of a pack against the activation's K, run at every
  dispatch entry so a malformed pack raises a diagnostic instead of giving
  garbage or an unexplained plain-version route. An expert-stacked pack
  (every tensor with the same leading E) is checked the same way.
* :func:`validate_dual_gemv` / :func:`validate_dual_gemv_group` /
  :func:`validate_dual_gemm` / :func:`validate_dual_gemm_group` — what the
  CUDA kernels can tile (divisibility, group sizes, segment count) and their
  shared memory against the Hopper budget of 227 KB a block. They raise
  :class:`ContractError` before anything is launched. Dispatch asks them
  too: a consistent pack they reject is a ``ref`` route, which runs the
  plain version for a CPU tensor and raises for any other.
* :func:`check_w4a16_pack` — the same for a weight-only (``wp``, ``ws``)
  pair; :func:`validate_w4a16` — what the weight-only CUDA kernel tiles: N
  in whole 64-column blocks, groups that are whole 16-deep MMA steps and fit
  its shared tile, and its shared memory against the budget for the regime
  M selects (:func:`w4a16_launch`; M is covered by a guarded grid, so any
  M >= 1 launches).
* :func:`check_paged_decode_args` / :func:`check_ragged_args` — shape
  consistency of a block-table attention call, run at its dispatch entry.
* :func:`validate_paged_decode` / :func:`validate_ragged_attention` — what
  the CUDA attention kernels take: GQA grouping, head dims in whole 16-byte
  loads, at most ``ATT_QV_MAX`` query vectors a block, pages of at most
  ``ATT_PAGE_MAX`` rows, each kernel's key-range chunk (whole 64-key
  tiles) and shared memory against the budget, and their scratch
  (:func:`paged_scratch_floats`, :func:`ragged_scratch_floats`).
* :func:`check_ragged_rows` — the ragged kernel's row contract (each slot
  one contiguous run of consecutive positions from its ``ctx``), checked on
  the host while the metadata is still numpy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import torch

from repro_torch.kernels.autotune import (GEMM_SPLIT_TILE, GEMM_STAGES, GEMM_TEAMS, GEMM_TILE,
                                          GEMV_STAGES, GEMV_TILE_N, GEMV_WARPS, PAGED_CHUNK,
                                          PAGED_TILE, W4A16_COL_STAGES, W4A16_DECODE_COL_N,
                                          W4A16_DECODE_M, W4A16_DECODE_N,
                                          W4A16_DECODE_STAGES, W4A16_DECODE_WARPS)

__all__ = [
    "ATT_PAGE_MAX",
    "ATT_QV_MAX",
    "ContractError",
    "SMEM_BUDGET_BYTES",
    "MAX_SEGMENTS",
    "check_paged_decode_args",
    "check_ragged_args",
    "check_ragged_rows",
    "check_twinquant_group_pack",
    "check_twinquant_pack",
    "check_w4a16_pack",
    "divisible",
    "gemm_smem_bytes",
    "gemv_smem_bytes",
    "paged_scratch_floats",
    "paged_smem_bytes",
    "ragged_scratch_floats",
    "ragged_smem_bytes",
    "validate_dual_gemm",
    "validate_dual_gemm_group",
    "validate_dual_gemv",
    "validate_dual_gemv_group",
    "validate_paged_decode",
    "validate_ragged_attention",
    "validate_w4a16",
    "w4a16_launch",
    "w4a16_smem_bytes",
]

SMEM_BUDGET_BYTES = 232_448  # 227 KB: the most one H100 block can use
MAX_SEGMENTS = 4  # segment table size compiled into the kernels
_GMAX = 128  # largest scale group the kernels' shared tiles hold
ATT_QV_MAX = 32  # query vectors (rows x query heads of one KV head) an attention block
ATT_PAGE_MAX = 64  # page rows an attention block folds as one tile
_ATT_HD_MAX = 256  # head dims a lane set of 32 x 8 covers


class ContractError(ValueError):
    """A kernel-launch or weight-pack contract violation, with the relation
    that failed and the offending values."""


def divisible(a: int, b: int, what: str, *, kind: str, hint: str = "") -> None:
    """Contract: ``a % b == 0`` with a positive ``b``."""
    if b <= 0 or a % b != 0:
        raise ContractError(
            f"[{kind}] {what}: {a} is not a multiple of {b}"
            + (f"\n  hint: {hint}" if hint else "")
        )


def gemv_smem_bytes() -> int:
    """Dynamic shared memory of the GEMV's main block (``tq_gemv_main`` in
    ``csrc/twinquant_dual_gemv.cu``): each warp's ring of task slots (packed
    rows, activation rows, both scale vectors) and two rounds of terms."""
    warps, stages, mmax, bn = GEMV_WARPS, GEMV_STAGES, 8, GEMV_TILE_N
    slot = (_GMAX // 2) * bn + mmax * (_GMAX + 16) + bn * 4 + mmax * 4
    return warps * stages * slot + 2 * warps * mmax * bn * 4


def _gemm_slot(bm: int, bn: int) -> int:
    slot = bm * _GMAX + (_GMAX // 2) * bn + (bm + bn) * 4
    return (slot + 127) // 128 * 128


def gemm_smem_bytes() -> int:
    """Dynamic shared memory of the larger GEMM block (``csrc/
    twinquant_dual_gemm.cu``): the tile kernel's ring of task slots (A tile,
    packed rows, scales), two unpacked B tiles and 1 KB to align them to the
    swizzle's 1024-byte period, or the split kernel's rings and B tiles of
    its one-warp teams and two rounds of their terms."""
    (bm, bn), (sm, sn) = GEMM_TILE, GEMM_SPLIT_TILE
    tile = GEMM_STAGES * _gemm_slot(bm, bn) + 2 * bn * _GMAX + 1024  # + 1024-byte alignment
    team = GEMM_STAGES * _gemm_slot(sm, sn) + sn * _GMAX
    split = GEMM_TEAMS * team + 2 * GEMM_TEAMS * sm * sn * 4
    return max(tile, split)


def _w4a16_decode_smem(rows: int, group: int, warps: int) -> int:
    slot = rows * (group + 8) * 2 + (group // 2) * W4A16_DECODE_N + W4A16_DECODE_N * 4
    return warps * W4A16_DECODE_STAGES * slot + 2 * warps * rows * W4A16_DECODE_N * 4


def w4a16_launch(m: int, n: int, group: int) -> tuple[int, int]:
    """(warps, dynamic shared memory bytes) of the weight-only GEMM launch
    for (M, N, G), as ``csrc/w4a16_gemm.cu`` picks them. Decode regime (M <=
    ``W4A16_DECODE_M``), N >= ``W4A16_DECODE_COL_N``: four warps sharing one
    ring of ``W4A16_COL_STAGES`` slots (x rows, 64 columns of packed rows,
    their scales). Narrower N: slots of 8, 16 or 32 x rows, each of the
    ``W4A16_DECODE_WARPS`` warps a ring of ``W4A16_DECODE_STAGES`` slots of x
    rows, the block's 16 columns of packed rows and their scales, and two
    rounds of parked terms. Prefill: the 64 x 64
    tile's ``W4Smem`` (two x tiles, two groups of packed rows and scales, one
    dequantized bf16 group)."""
    if m <= W4A16_DECODE_M:
        rows = 8 if m <= 8 else 16 if m <= 16 else 32
        if n >= W4A16_DECODE_COL_N:  # 64 columns a block, one warp per 16, no K split
            slot = rows * (group + 8) * 2 + (group // 2) * 64 + 64 * 4
            return 4, W4A16_COL_STAGES * slot
        return W4A16_DECODE_WARPS, _w4a16_decode_smem(rows, group, W4A16_DECODE_WARPS)
    bm, bn = 64, 64
    return 4, (2 * bm * (_GMAX + 8) * 2 + 2 * (_GMAX // 2) * bn + 2 * bn * 4
               + _GMAX * (bn + 8) * 2)


def w4a16_smem_bytes(m: int, n: int, group: int) -> int:
    """Dynamic shared memory of the weight-only GEMM launch for (M, N, G)
    (``w4a16_smem_bytes`` in ``csrc/w4a16_gemm.cu``)."""
    return w4a16_launch(m, n, group)[1]


def _smem(kind: str, nbytes: int) -> None:
    if nbytes > SMEM_BUDGET_BYTES:
        raise ContractError(
            f"[{kind}] shared memory {nbytes} B exceeds the {SMEM_BUDGET_BYTES} B block budget"
        )


def _group_sizes(kind: str, group: int, rgroups: Sequence[int], mult: int) -> None:
    for name, g in [("group", group)] + [(f"rgroup[{j}]", gr) for j, gr in enumerate(rgroups)]:
        divisible(g, mult, f"{name} % {mult}", kind=kind,
                  hint="the kernel consumes whole packed rows (and MMA k-steps)")
        if g > _GMAX:
            raise ContractError(f"[{kind}] {name}={g} exceeds the kernel's largest group {_GMAX}")


def _segments(kind: str, seg_n, seg_r, rgroups, block_n: int) -> None:
    if not (len(seg_n) == len(seg_r) == len(rgroups)) or not seg_n:
        raise ContractError(f"[{kind}] segment tables disagree: {seg_n}, {seg_r}, {rgroups}")
    if len(seg_n) > MAX_SEGMENTS:
        raise ContractError(f"[{kind}] {len(seg_n)} segments exceed the kernel's {MAX_SEGMENTS}")
    for j, (nj, rj, gr) in enumerate(zip(seg_n, seg_r, rgroups)):
        divisible(nj, block_n, f"segment {j}: N_j % block_n", kind=kind,
                  hint="an N block must never straddle a segment boundary")
        divisible(rj, gr, f"segment {j}: rank_j % rgroup_j", kind=kind,
                  hint="each segment's H requantizes with its own rank groups")


def validate_dual_gemv_group(m: int, k: int, group: int, seg_n, seg_r, rgroups,
                             block_n: int, *, decode_m_max: int,
                             kind: str = "dual_gemv_group") -> None:
    """Contract for the decode-shaped (M <= 8) CUDA launch."""
    if not 1 <= m <= decode_m_max:
        raise ContractError(f"[{kind}] M={m} outside the decode panel [1, {decode_m_max}]")
    divisible(k, group, "K % group", kind=kind)
    _group_sizes(kind, group, rgroups, 2)
    _segments(kind, seg_n, seg_r, rgroups, block_n)
    _smem(kind, gemv_smem_bytes())


def validate_dual_gemv(m, n, k, r, group, rgroup, block_n, *, decode_m_max,
                       kind: str = "dual_gemv") -> None:
    """Contract for the single-pack decode launch."""
    validate_dual_gemv_group(m, k, group, (n,), (r,), (rgroup,), block_n,
                             decode_m_max=decode_m_max, kind=kind)


def validate_dual_gemm_group(m: int, k: int, group: int, seg_n, seg_r, rgroups,
                             block_n: int, *, kind: str = "dual_gemm_group") -> None:
    """Contract for the prefill-shaped (M > 8) CUDA launch: groups are whole
    32-deep MMA steps, tiles never straddle segments, and every 16-byte A
    load stays aligned (K and the stacked rank multiples of 16)."""
    if m < 1:
        raise ContractError(f"[{kind}] M={m} must be positive")
    divisible(k, group, "K % group", kind=kind)
    _group_sizes(kind, group, rgroups, 32)
    _segments(kind, seg_n, seg_r, rgroups, block_n)
    divisible(sum(seg_r), 16, "stacked rank % 16", kind=kind, hint="16-byte Hq loads")
    _smem(kind, gemm_smem_bytes())


def validate_dual_gemm(m, n, k, r, group, rgroup, block_n, *, kind: str = "dual_gemm") -> None:
    """Contract for the single-pack prefill launch."""
    validate_dual_gemm_group(m, k, group, (n,), (r,), (rgroup,), block_n, kind=kind)


def validate_w4a16(m: int, n: int, k: int, group: int, block_m: int, block_n: int,
                   block_k: int, *, kind: str = "w4a16_gemm") -> None:
    """Contract for the weight-only int4 GEMM launch on Hopper: the grid
    covers M with guarded tiles (any M >= 1, no padding), N in whole
    ``block_n`` tiles, K in whole ``block_k`` steps of whole scale groups;
    groups are whole 16-deep MMA steps and fit the kernel's shared tile; the
    block's shared memory (decode or prefill regime, by M) fits the 227 KB
    budget."""
    if m < 1:
        raise ContractError(f"[{kind}] M={m} must be positive")
    hint = "the grid's tiles must cover the operand exactly"
    divisible(n, block_n, "N % block_n", kind=kind, hint=hint)
    divisible(k, block_k, "K % block_k", kind=kind, hint=hint)
    divisible(block_k, group, "block_k % group", kind=kind,
              hint="every K step must hold whole scale groups")
    divisible(group, 16, "group % 16", kind=kind,
              hint="a group is whole 16-deep MMA steps (and pairs its nibble rows)")
    if group > _GMAX:
        raise ContractError(f"[{kind}] group={group} exceeds the kernel's largest group {_GMAX}")
    _smem(kind, w4a16_smem_bytes(m, n, group))


# ---------------------------------------------------------------------------
# weight-pack consistency (dispatch entries)
# ---------------------------------------------------------------------------


def _dtype_problems(fields) -> list[str]:
    """Field types, and one layout for all fields: 2-D, or 3-D with one
    leading expert count (an expert-stacked pack)."""
    problems = []
    lead = fields[0][1].shape[:-2] if fields[0][1].ndim == 3 else ()
    for name, a, want_int8 in fields:
        if a.ndim != 2 + len(lead) or a.shape[:-2] != lead:
            want = f"3-D with E={lead[0]} leading" if lead else "2-D"
            problems.append(f"{name}: expected a {want} pack field, got shape "
                            f"{tuple(a.shape)}")
        if want_int8 and a.dtype != torch.int8:
            problems.append(f"{name}: expected packed int8 nibbles, got {a.dtype}")
        if not want_int8 and not a.dtype.is_floating_point:
            problems.append(f"{name}: expected float scales, got {a.dtype}")
    return problems


def check_twinquant_pack(w, k: int, *, kind: str = "dual") -> None:
    """Internal consistency of a :class:`TwinQuantWeights` against K."""
    problems = _dtype_problems([
        ("up", w.up, True), ("us", w.us, False), ("vp", w.vp, True),
        ("vs", w.vs, False), ("rp", w.rp, True), ("rs", w.rs, False),
    ])
    if problems:
        raise ContractError(f"[{kind}] malformed pack:\n  " + "\n  ".join(problems))
    r, n = w.up.shape[-1], w.rp.shape[-1]
    if w.up.shape[-2] * 2 != k or w.rp.shape[-2] * 2 != k:
        problems.append(f"packed K ({w.up.shape[-2] * 2} in up, {w.rp.shape[-2] * 2} in rp) "
                        f"!= activation K={k}")
    if w.us.shape[-2] * w.group != k or w.rs.shape[-2] * w.group != k:
        problems.append(f"scale rows ({w.us.shape[-2]}, {w.rs.shape[-2]}) x group={w.group} "
                        f"!= K={k}")
    if w.us.shape[-1] != r:
        problems.append(f"us width {w.us.shape[-1]} != rank {r}")
    if w.vp.shape[-2] * 2 != r or w.vs.shape[-2] * w.rgroup != r:
        problems.append(f"V rows ({w.vp.shape[-2]} packed, {w.vs.shape[-2]} scales, "
                        f"rgroup={w.rgroup}) inconsistent with rank {r}")
    if w.vp.shape[-1] != n or w.vs.shape[-1] != n or w.rs.shape[-1] != n:
        problems.append(f"widths (vp {w.vp.shape[-1]}, vs {w.vs.shape[-1]}, rs "
                        f"{w.rs.shape[-1]}) != output N={n}")
    if problems:
        raise ContractError(f"[{kind}] malformed pack (K={k}, N={n}, rank={r}):\n  "
                            + "\n  ".join(problems))


def check_twinquant_group_pack(gw, k: int, *, kind: str = "dual_fused") -> None:
    """Consistency of a fused :class:`TwinQuantGroupWeights` against K."""
    if not (len(gw.vps) == len(gw.vss) == len(gw.rgroups)) or not gw.vps:
        raise ContractError(
            f"[{kind}] segment tables disagree: {len(gw.vps)} vp, {len(gw.vss)} vs, "
            f"{len(gw.rgroups)} rgroups"
        )
    fields = [("up", gw.up, True), ("us", gw.us, False), ("rp", gw.rp, True),
              ("rs", gw.rs, False)]
    for j, (vp, vs) in enumerate(zip(gw.vps, gw.vss)):
        fields += [(f"vp{j}", vp, True), (f"vs{j}", vs, False)]
    problems = _dtype_problems(fields)
    if problems:
        raise ContractError(f"[{kind}] malformed fused pack:\n  " + "\n  ".join(problems))
    if gw.up.shape[-2] * 2 != k or gw.rp.shape[-2] * 2 != k:
        problems.append(f"packed K ({gw.up.shape[-2] * 2} in up, {gw.rp.shape[-2] * 2} in rp) "
                        f"!= activation K={k}")
    if gw.us.shape[-2] * gw.group != k or gw.rs.shape[-2] * gw.group != k:
        problems.append(f"scale rows x group={gw.group} do not cover K={k}")
    if gw.up.shape[-1] != sum(gw.seg_r) or gw.us.shape[-1] != gw.up.shape[-1]:
        problems.append(f"stacked U rank {gw.up.shape[-1]} != sum of segment ranks "
                        f"{sum(gw.seg_r)}")
    if gw.rp.shape[-1] != sum(gw.seg_n) or gw.rs.shape[-1] != gw.rp.shape[-1]:
        problems.append(f"concatenated R width {gw.rp.shape[-1]} != sum of segment widths "
                        f"{sum(gw.seg_n)}")
    for j, (vp, vs, gr) in enumerate(zip(gw.vps, gw.vss, gw.rgroups)):
        if vp.shape[-1] != vs.shape[-1] or vs.shape[-2] * gr != vp.shape[-2] * 2:
            problems.append(f"segment {j}: vp {tuple(vp.shape)} / vs {tuple(vs.shape)} "
                            f"inconsistent with rgroup {gr}")
    if problems:
        raise ContractError(f"[{kind}] malformed fused pack (K={k}, segments N={gw.seg_n}, "
                            f"r={gw.seg_r}):\n  " + "\n  ".join(problems))


def check_w4a16_pack(wp, ws, k: int, group: int, *, kind: str = "w4a16") -> None:
    """Consistency contract for a weight-only (packed, scales) pair."""
    problems = []
    if wp.ndim != 2 or ws.ndim != 2:
        problems.append(f"expected 2-D (wp, ws), got {tuple(wp.shape)}, {tuple(ws.shape)}")
    elif wp.dtype != torch.int8:
        problems.append(f"wp: expected packed int8 nibbles, got {wp.dtype}")
    elif not ws.dtype.is_floating_point:
        problems.append(f"ws: expected float scales, got {ws.dtype}")
    else:
        if wp.shape[-2] * 2 != k:
            problems.append(f"wp rows {wp.shape[-2]} pack K={wp.shape[-2] * 2}, but the "
                            f"activation has K={k}")
        if ws.shape[-2] * group != k:
            problems.append(f"ws has {ws.shape[-2]} scale rows for group={group}, "
                            f"covering K={ws.shape[-2] * group} != {k}")
        if wp.shape[-1] != ws.shape[-1]:
            problems.append(f"wp width {wp.shape[-1]} != ws width {ws.shape[-1]}")
    if problems:
        raise ContractError(f"[{kind}] malformed w4a16 pack (K={k}, group={group}):\n  "
                            + "\n  ".join(problems))


# ---------------------------------------------------------------------------
# block-table attention (paged decode, ragged)
# ---------------------------------------------------------------------------


_PAGED_CHUNK_MAX = 512  # longest key chunk an attention block's shared block table spans
_SM_SMEM_BYTES = 233_472  # shared memory of one H100 SM (1 KB reserved a block)
_GRID_Y_MAX = 65_535  # a launch grid's y extent


def _paged_smem(hd: int, nt: int, stages: int) -> int:
    ld = (hd + 15) // 16 * 16 + 8  # bf16 row of the K, V and query tiles
    tile = PAGED_TILE
    return (stages * 2 * tile * ld * 2 + 8 * nt * ld * 2 + 8 * nt * (tile + 4) * 4
            + 2 * 8 * nt * (tile + 8) * 2 + stages * tile * 4 + ATT_QV_MAX * 4 + 516 * 4)


def paged_smem_bytes(hd: int, nqv: int) -> int:
    """Dynamic shared memory of a paged-decode split block for head dim
    ``hd`` and ``nqv`` query vectors (``paged_decode_smem_bytes`` in
    ``csrc/paged_attention.cu``): a ring of K and V tiles (three stages where
    two such blocks fit an SM, else two), the bf16 query tile, f32 scores
    and bf16 hi / lo probabilities of ``ceil(nqv / 8)`` n8 tiles of vectors,
    key flags, the per-vector factors and the chunk's block-table entries."""
    nt = (nqv + 7) // 8
    three = _paged_smem(hd, nt, 3)
    return three if 2 * (three + 1024) <= _SM_SMEM_BYTES else _paged_smem(hd, nt, 2)


def paged_scratch_floats(b: int, sq: int, h: int, kvh: int, hd: int, maxp: int, page: int,
                         chunk: int = PAGED_CHUNK) -> int:
    """f32 scratch of a paged-decode launch: each (slot, KV head, chunk,
    query vector)'s partial accumulator (hd) and its (m, l)."""
    nc = -(-maxp * page // chunk)
    return b * kvh * nc * sq * (h // kvh) * (hd + 2)


def _ragged_tiles(t: int, b: int, h: int, kvh: int) -> int:
    """The most tiles a ragged launch can have: tiles of ``ATT_QV_MAX // g``
    rows, at most B + ceil(T / rows) of them."""
    return b + -(-t // (ATT_QV_MAX // (h // kvh)))


def ragged_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of a ragged split block for head dim ``hd``
    (``ragged_attention_smem_bytes`` in ``csrc/ragged_attention.cu``): the
    paged split block's for ``ATT_QV_MAX`` query vectors, whatever a
    tile's height (one compiled body)."""
    return paged_smem_bytes(hd, ATT_QV_MAX)


def ragged_scratch_floats(t: int, b: int, h: int, kvh: int, hd: int, maxp: int, page: int,
                          chunk: int = PAGED_CHUNK) -> int:
    """f32 scratch of a ragged launch: each (tile, KV head, chunk, query
    vector)'s partial accumulator (hd) and its (m, l), ``ATT_QV_MAX`` vectors
    a tile, over the chunks of positions below ``maxp * page + t`` (the most
    a row can see while every slot's ``ctx <= maxp * page``), rounded up to
    whole 16 bytes; then the plan (ints): the work-item count and 3 spare, 8
    per tile, the work list."""
    nc = -(-(maxp * page + t) // chunk)
    z = _ragged_tiles(t, b, h, kvh)
    return -(-z * kvh * nc * ATT_QV_MAX * (hd + 2) // 4) * 4 + 4 + 8 * z + z * nc


def _attn_chunk(kind: str, chunk: int) -> None:
    if not PAGED_TILE <= chunk <= _PAGED_CHUNK_MAX:
        raise ContractError(f"[{kind}] chunk={chunk} outside [{PAGED_TILE}, {_PAGED_CHUNK_MAX}] "
                            "keys (one tile .. the block table a block stages)")
    divisible(chunk, PAGED_TILE, "chunk % tile", kind=kind,
              hint="a chunk is whole 64-key tiles at fixed absolute positions")


def _attn_common(kind: str, h: int, kvh: int, hd: int, page: int, maxp: int) -> None:
    if h < 1 or kvh < 1:
        raise ContractError(f"[{kind}] head counts must be positive, got H={h} KV={kvh}")
    divisible(h, kvh, "n_heads % n_kv_heads", kind=kind,
              hint="GQA groups share each KV head across h//kvh query heads")
    divisible(hd, 8, "head_dim % 8", kind=kind, hint="K/V rows move in 16-byte copies")
    if hd > _ATT_HD_MAX:
        raise ContractError(f"[{kind}] head_dim={hd} exceeds the kernel's {_ATT_HD_MAX}")
    if h // kvh > ATT_QV_MAX:
        raise ContractError(f"[{kind}] {h // kvh} query heads per KV head exceed the "
                            f"block's {ATT_QV_MAX} query vectors")
    if not 1 <= page <= ATT_PAGE_MAX:
        raise ContractError(f"[{kind}] page_size={page} outside [1, {ATT_PAGE_MAX}]")
    if maxp < 1:
        raise ContractError(f"[{kind}] max_pages={maxp} must be positive")


def validate_paged_decode(b: int, sq: int, h: int, kvh: int, hd: int, maxp: int, page: int,
                          *, decode_m_max: int = 8, chunk: int = PAGED_CHUNK,
                          kind: str = "paged_decode") -> None:
    """Contract for the paged decode-attention launch: a split block per
    (chunk of ``chunk`` key positions, KV head, slot) holds all ``sq`` rows
    of its ``h // kvh`` query heads, so ``sq`` is bounded by the decode
    panel and ``sq * h // kvh`` by the block's query vectors; the chunk is
    whole 64-key tiles; the block's shared memory fits the budget. The
    sequence length sets only the grid and the scratch."""
    if b < 1:
        raise ContractError(f"[{kind}] B={b} slots must be positive")
    if not 1 <= sq <= decode_m_max:
        raise ContractError(
            f"[{kind}] sq={sq} draft rows outside [1, DECODE_M_MAX={decode_m_max}]\n"
            "  hint: the speculative engine verifies at most DECODE_M_MAX tokens per slot"
        )
    _attn_common(kind, h, kvh, hd, page, maxp)
    if sq * (h // kvh) > ATT_QV_MAX:
        raise ContractError(f"[{kind}] sq * H/KV = {sq * (h // kvh)} query vectors exceed "
                            f"the block's {ATT_QV_MAX}")
    _attn_chunk(kind, chunk)
    _smem(kind, paged_smem_bytes(hd, sq * (h // kvh)))


def validate_ragged_attention(t: int, h: int, kvh: int, hd: int, b: int, maxp: int, page: int,
                              *, chunk: int = PAGED_CHUNK, kind: str = "ragged") -> None:
    """Contract for the ragged-attention launch: a split block per (chunk of
    ``chunk`` key positions, KV head, tile of ``ATT_QV_MAX // (h // kvh)``
    of a slot's rows) holds at most ``ATT_QV_MAX`` query vectors, so the
    token budget T sets only the grid and the scratch
    (:func:`ragged_scratch_floats`), within the split launch's grid; the
    chunk is whole 64-key tiles; the split block's shared memory fits the
    budget, and so does the plan launch's (the slots' run table)."""
    if t < 1 or b < 1:
        raise ContractError(f"[{kind}] T={t} rows and B={b} slots must be positive")
    _attn_common(kind, h, kvh, hd, page, maxp)
    _attn_chunk(kind, chunk)
    _smem(kind, ragged_smem_bytes(hd))
    z = _ragged_tiles(t, b, h, kvh)
    nc = -(-(maxp * page + t) // chunk)
    if z * nc > _GRID_Y_MAX:
        raise ContractError(f"[{kind}] {z} tiles x {nc} chunks = {z * nc} work items exceed "
                            f"the split launch's grid ({_GRID_Y_MAX})")
    _smem(f"{kind} plan", (3 * (b + 1) + 2 * (z + 1)) * 4)


def check_paged_decode_args(q, kp, vp, kt, vt, bt, pos, *, kind: str = "paged_decode") -> None:
    """Shape consistency of a paged-decode call: ``q (B, sq, H, hd)``,
    ``kt, vt (B, sq, KV, hd)``, one layer's pools ``kp, vp (P, page, KV,
    hd)``, block tables ``bt (B, maxp)`` and ``pos (B,)``."""
    problems = []
    if q.ndim != 4:
        problems.append(f"q: expected (B, sq, H, hd), got {tuple(q.shape)}")
    if kt.ndim != 4 or vt.ndim != 4 or kt.shape != vt.shape:
        problems.append(f"kt/vt: expected matching (B, sq, KV, hd), got {tuple(kt.shape)} "
                        f"vs {tuple(vt.shape)}")
    if kp.ndim != 4 or vp.ndim != 4 or kp.shape != vp.shape:
        problems.append(f"kp/vp: expected matching (P, page, KV, hd) pools, got "
                        f"{tuple(kp.shape)} vs {tuple(vp.shape)}")
    if bt.ndim != 2:
        problems.append(f"bt: expected (B, max_pages), got {tuple(bt.shape)}")
    if problems:
        raise ContractError(f"[{kind}] malformed paged-decode call:\n  " + "\n  ".join(problems))
    b, sq, _, hd = q.shape
    if kt.shape[0] != b or kt.shape[1] != sq or kt.shape[3] != hd:
        problems.append(f"kt shape {tuple(kt.shape)} disagrees with q {tuple(q.shape)}")
    if kp.shape[2] != kt.shape[2] or kp.shape[3] != hd:
        problems.append(f"pool trailing dims {tuple(kp.shape[2:])} != draft (KV, hd)="
                        f"({kt.shape[2]}, {hd})")
    if q.shape[2] % kt.shape[2] != 0:
        problems.append(f"n_heads {q.shape[2]} not a multiple of n_kv_heads {kt.shape[2]}")
    if bt.shape[0] != b:
        problems.append(f"bt rows {bt.shape[0]} != B={b} slots")
    if tuple(pos.shape) != (b,):
        problems.append(f"pos: expected ({b},), got {tuple(pos.shape)}")
    if problems:
        raise ContractError(f"[{kind}] malformed paged-decode call:\n  " + "\n  ".join(problems))


def check_ragged_args(q, kp, vp, kt, vt, bt, slot, pos, ctx, *, kind: str = "ragged") -> None:
    """Shape consistency of a ragged-attention call: ``q (T, H, hd)``,
    ``kt, vt (T, KV, hd)``, pools ``kp, vp (P, page, KV, hd)``, ``bt (B,
    maxp)``, ``slot, pos (T,)`` (slot == B marks a pad row), ``ctx (B,)``."""
    problems = []
    if q.ndim != 3:
        problems.append(f"q: expected (T, H, hd), got {tuple(q.shape)}")
    if kt.ndim != 3 or vt.ndim != 3 or kt.shape != vt.shape:
        problems.append(f"kt/vt: expected matching (T, KV, hd), got {tuple(kt.shape)} "
                        f"vs {tuple(vt.shape)}")
    if kp.ndim != 4 or vp.ndim != 4 or kp.shape != vp.shape:
        problems.append(f"kp/vp: expected matching (P, page, KV, hd) pools, got "
                        f"{tuple(kp.shape)} vs {tuple(vp.shape)}")
    if bt.ndim != 2:
        problems.append(f"bt: expected (B, max_pages), got {tuple(bt.shape)}")
    if problems:
        raise ContractError(f"[{kind}] malformed ragged call:\n  " + "\n  ".join(problems))
    t, _, hd = q.shape
    if kt.shape[0] != t or kt.shape[2] != hd:
        problems.append(f"kt rows/head_dim {tuple(kt.shape)} disagree with q {tuple(q.shape)}")
    if kp.shape[2] != kt.shape[1] or kp.shape[3] != hd:
        problems.append(f"pool trailing dims {tuple(kp.shape[2:])} != in-batch (KV, hd)="
                        f"({kt.shape[1]}, {hd})")
    if q.shape[1] % kt.shape[1] != 0:
        problems.append(f"n_heads {q.shape[1]} not a multiple of n_kv_heads {kt.shape[1]}")
    if tuple(slot.shape) != (t,) or tuple(pos.shape) != (t,):
        problems.append(f"slot/pos: expected ({t},), got {tuple(slot.shape)} / "
                        f"{tuple(pos.shape)}")
    if tuple(ctx.shape) != (bt.shape[0],):
        problems.append(f"ctx: expected ({bt.shape[0]},) to match bt rows, got "
                        f"{tuple(ctx.shape)}")
    if problems:
        raise ContractError(f"[{kind}] malformed ragged call:\n  " + "\n  ".join(problems))


def check_ragged_rows(slot, pos, ctx, *, s_max: int | None = None,
                      kind: str = "ragged") -> None:
    """The ragged kernel's row contract, on host (numpy) metadata: every
    row's slot lies in [0, B] (B marks padding), and each slot's rows form
    ONE contiguous run whose positions are ctx[slot], ctx[slot] + 1, ...
    The kernel finds a slot's run by its first row and row count and takes
    each key's place from that, so a broken batch would attend wrong keys.
    With ``s_max`` (the block table's ``maxp * page`` positions), also
    ``ctx <= s_max``: the kernel's chunk grid and scratch cover the
    positions below ``s_max + T`` only."""
    slot = np.asarray(slot)
    pos = np.asarray(pos)
    ctx = np.asarray(ctx)
    b = ctx.shape[0]
    if slot.shape != pos.shape or slot.ndim != 1:
        raise ContractError(f"[{kind}] slot/pos must be matching 1-D arrays, got "
                            f"{slot.shape} / {pos.shape}")
    if s_max is not None and ctx.size and ctx.max() > s_max:
        raise ContractError(f"[{kind}] ctx {int(ctx.max())} exceeds the block table's "
                            f"{s_max} positions")
    if slot.size and (slot.min() < 0 or slot.max() > b):
        raise ContractError(f"[{kind}] slot ids must lie in [0, {b}] ({b} = pad), got "
                            f"{sorted(set(slot.tolist()))[:8]}")
    for s in np.unique(slot[slot < b]):
        rows = np.flatnonzero(slot == s)
        if rows[-1] - rows[0] + 1 != rows.size:
            raise ContractError(f"[{kind}] slot {int(s)}'s rows {rows.tolist()[:8]} are not "
                                "one contiguous run")
        want = int(ctx[s]) + np.arange(rows.size)
        if not np.array_equal(pos[rows], want):
            raise ContractError(f"[{kind}] slot {int(s)}'s positions {pos[rows].tolist()[:8]} "
                                f"are not consecutive from ctx={int(ctx[s])}")
