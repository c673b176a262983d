"""Launch contracts for the Hopper dual-component kernels.

* :func:`check_twinquant_pack` / :func:`check_twinquant_group_pack` — shape
  and dtype consistency of a pack against the activation's K, run at every
  dispatch entry so a malformed pack raises a diagnostic instead of giving
  garbage or an unexplained plain-version route.
* :func:`validate_dual_gemv` / :func:`validate_dual_gemv_group` /
  :func:`validate_dual_gemm` / :func:`validate_dual_gemm_group` — what the
  CUDA kernels can tile (divisibility, group sizes, segment count) and their
  shared memory against the Hopper budget of 227 KB a block. They raise
  :class:`ContractError` before anything is launched. Dispatch asks them
  too: a consistent pack they reject is a ``ref`` route, which runs the
  plain version for a CPU tensor and raises for any other.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = [
    "ContractError",
    "SMEM_BUDGET_BYTES",
    "MAX_SEGMENTS",
    "check_twinquant_group_pack",
    "check_twinquant_pack",
    "divisible",
    "gemm_smem_bytes",
    "gemv_smem_bytes",
    "validate_dual_gemm",
    "validate_dual_gemm_group",
    "validate_dual_gemv",
    "validate_dual_gemv_group",
]

SMEM_BUDGET_BYTES = 232_448  # 227 KB: the most one H100 block can use
MAX_SEGMENTS = 4  # segment table size compiled into the kernels
_GMAX = 128  # largest scale group the kernels' shared tiles hold


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
    """Static shared memory of the GEMV block (A slices, scales, terms)."""
    warps, mmax, bn = 8, 8, 32
    return warps * mmax * _GMAX + warps * mmax * 4 + warps * mmax * bn * 4


def gemm_smem_bytes() -> int:
    """Static shared memory of the GEMM block (A and W tiles, scales)."""
    return 2 * 64 * (_GMAX + 16) + 2 * 64 * 4


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


# ---------------------------------------------------------------------------
# weight-pack consistency (dispatch entries)
# ---------------------------------------------------------------------------


def _dtype_problems(fields) -> list[str]:
    problems = []
    for name, a, want_int8 in fields:
        if a.ndim != 2:
            problems.append(f"{name}: expected a 2-D pack field, got shape {tuple(a.shape)}")
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
