"""Kernel dispatch: the quantized linears, routed by shape regime, and the
block-table attention entries.

Every dual-component matmul of the model goes through :func:`quant_linear`
(one pack) or :func:`fused_linear` (a fused sibling group: q/k/v, gate/up),
which route each call by its flattened M, as the JAX package does:

* ``decode``  — M <= DECODE_M_MAX (the engine's slot count): the GEMV kernel;
* ``prefill`` — larger M: the GEMM kernel;
* ``ref``     — shapes the regime's kernel cannot tile, as its own launch
  contract (``contracts.validate_dual_gemv_group`` /
  ``validate_dual_gemm_group``) judges them, keep the reference's routing
  decision and reason codes, counted as ``<kind>/ref`` and
  ``<kind>/ref[<code>]``. Such a route runs the plain version for a CPU
  tensor; for any other tensor it raises :class:`ContractError` naming the
  code, so nothing on the card falls back to the plain version.

Each decision bumps a counter keyed ``<kind>/<path>`` (kinds ``dual`` and
``dual_fused``), one bump per call; a captured step graph adds its
capture's decisions once per replay (``add_dispatch_counts``).

An expert-stacked pack (an MoE layer's experts, every pack tensor with a
leading E) takes x (E, M, K) and returns (E, M, N): one call, classified by
M (the rows each expert gets) as the reference classifies its vmapped call,
one route recorded and one kernel launch for all E experts.

The weight-only baseline :func:`w4a16_linear` (kind ``w4a16``) has one
kernel schedule for every M, so as in the reference a routed call counts
``w4a16/prefill`` whatever its M; ``ref`` codes ``k_group`` (K not whole
even groups) and ``prefill_untileable`` (the kernel's contract
``contracts.validate_w4a16`` refuses the shape).

The attention entries :func:`paged_decode` (kind ``paged_decode``) and
:func:`ragged_attention` (kind ``ragged``) have one kernel schedule each,
so their classification is a viability check with the reference's reason
codes: ``hd_unaligned`` (heads not grouped by the KV heads, or a head dim
the kernel cannot load whole), ``rows`` (a draft stack past DECODE_M_MAX)
and ``vmem`` (the kernel's own launch contract refuses the shape; on the
card that is its shared memory and tiles, not TPU VMEM). Path ``kernel``
calls the wrapper; a ``ref`` route follows the same rule as above.

A ``decode`` or ``prefill`` route calls the kernel wrapper, which launches
the CUDA kernel for a CUDA tensor and runs the plain version for a CPU
tensor. :func:`set_force_ref` runs the plain version on any device (route
``ref[forced]``), which is how the kernels are held to it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.autotune import DECODE_M_MAX, hopper_blocks, w4a16_blocks
from repro_torch.kernels.contracts import (
    ContractError,
    check_paged_decode_args,
    check_ragged_args,
    check_twinquant_group_pack,
    check_twinquant_pack,
    check_w4a16_pack,
    validate_dual_gemm_group,
    validate_dual_gemv_group,
    validate_paged_decode,
    validate_ragged_attention,
    validate_w4a16,
)
from repro_torch.kernels.cuda_launch import add_counts
from repro_torch.kernels.paged_attention import paged_decode_kernel, paged_decode_ref
from repro_torch.kernels.ragged_attention import ragged_attention_kernel, ragged_attention_ref
from repro_torch.kernels.ref import (
    TwinQuantGroupWeights,
    TwinQuantWeights,
    fuse_twinquant_weights,
)
from repro_torch.kernels.twinquant_dual_gemm import dual_gemm, dual_gemm_group
from repro_torch.kernels.twinquant_dual_gemv import dual_gemv, dual_gemv_group
from repro_torch.kernels.w4a16_gemm import w4a16_gemm

__all__ = [
    "DECODE_M_MAX",
    "Route",
    "add_dispatch_counts",
    "classify_dual",
    "classify_dual_group",
    "classify_paged_decode",
    "classify_ragged",
    "classify_w4a16",
    "dispatch_counters",
    "force_ref_enabled",
    "fused_linear",
    "fusion_enabled",
    "paged_decode",
    "quant_linear",
    "ragged_attention",
    "reset_dispatch_counters",
    "set_force_ref",
    "set_fusion",
    "w4a16_linear",
]

PATH_PREFILL = "prefill"
PATH_DECODE = "decode"
PATH_REF = "ref"
PATH_KERNEL = "kernel"

_fusion_enabled = True
_force_ref = False
_counters: dict[str, int] = {}


def fusion_enabled() -> bool:
    """Whether sibling-projection groups run as one fused launch (default)."""
    return _fusion_enabled


def set_fusion(enabled: bool) -> bool:
    """Enable/disable horizontal fusion; returns the previous setting. With
    fusion off, ``models.common.linear_group`` runs each sibling through its
    own :func:`quant_linear` call."""
    global _fusion_enabled
    prev = _fusion_enabled
    _fusion_enabled = bool(enabled)
    return prev


def force_ref_enabled() -> bool:
    """Whether every dispatch entry is forced onto the plain version."""
    return _force_ref


def set_force_ref(enabled: bool) -> bool:
    """Force every dispatch entry onto the plain version (route
    ``<kind>/ref[forced]``); returns the previous setting."""
    global _force_ref
    prev = _force_ref
    _force_ref = bool(enabled)
    return prev


@dataclasses.dataclass(frozen=True)
class Route:
    """A routing decision: which schedule, which blocks, and why. ``code``
    names why a ``ref`` route was taken (``forced``, ``k_group``,
    ``rank_rgroup``, ``decode_untileable``, ``prefill_untileable``,
    ``hd_unaligned``, ``rows``, ``vmem``)."""

    path: str  # "prefill" | "decode" | "kernel" | "ref"
    blocks: Optional[tuple[int, int, int]]  # (bm, bn, bk) of the CUDA launch
    reason: str
    code: str = "ok"


def dispatch_counters() -> dict[str, int]:
    """Snapshot of per-(kind, path) routing decision counts."""
    return dict(_counters)


def reset_dispatch_counters() -> None:
    """Zero the routing counters."""
    _counters.clear()


def add_dispatch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (decisions per ``<kind>/<path>`` key, negative to take
    some back) to the routing counters; a key that reaches 0 is dropped."""
    add_counts(_counters, delta)


def _record(kind: str, route: Route) -> None:
    key = f"{kind}/{route.path}"
    _counters[key] = _counters.get(key, 0) + 1
    if route.path == PATH_REF:
        rkey = f"{kind}/ref[{route.code}]"
        _counters[rkey] = _counters.get(rkey, 0) + 1


def classify_dual(m: int, n: int, k: int, group: int, rgroup: int, rank: int) -> Route:
    """Route a dual-component (M, K) x (K, N) call by shape regime."""
    return classify_dual_group(m, k, group, (n,), (rank,), (rgroup,))


def classify_dual_group(m: int, k: int, group: int, seg_n: tuple[int, ...],
                        seg_r: tuple[int, ...], rgroups: tuple[int, ...]) -> Route:
    """Route a fused sibling group by shape regime. The regime's kernel
    contract decides whether it tiles the shape (no N block may straddle a
    segment boundary); a shape it rejects routes ``ref`` with the
    reference's reason code."""
    if k % group != 0 or group % 2 != 0:
        return Route(PATH_REF, None, f"K={k} not tileable by group={group}", "k_group")
    for rj, gr in zip(seg_r, rgroups):
        if rj % gr != 0 or gr % 2 != 0:
            return Route(PATH_REF, None, f"rank={rj} not tileable by rgroup={gr}",
                         "rank_rgroup")
    blocks = hopper_blocks(m, group)
    decode = m <= DECODE_M_MAX
    try:
        if decode:
            validate_dual_gemv_group(m, k, group, seg_n, seg_r, rgroups, blocks[1],
                                     decode_m_max=DECODE_M_MAX)
        else:
            validate_dual_gemm_group(m, k, group, seg_n, seg_r, rgroups, blocks[1])
    except ContractError as e:
        return Route(PATH_REF, None, str(e),
                     "decode_untileable" if decode else "prefill_untileable")
    if decode:
        return Route(PATH_DECODE, blocks, f"M={m}<={DECODE_M_MAX}")
    return Route(PATH_PREFILL, blocks, f"M={m}>{DECODE_M_MAX}")


def _require_cpu_for_ref(kind: str, route: Route, x: torch.Tensor) -> None:
    """The plain version stands in for a kernel only on a CPU tensor (or when
    the caller forces it); elsewhere an untileable shape is an error."""
    if route.path == PATH_REF and route.code != "forced" and x.device.type != "cpu":
        raise ContractError(
            f"[{kind}] ref[{route.code}]: no kernel tiles this shape on {x.device}: "
            f"{route.reason}\n  hint: the plain version runs only for CPU tensors "
            f"or under set_force_ref(True)"
        )


def _finish(y: torch.Tensor, batch_shape, n: int, bias) -> torch.Tensor:
    y = y.reshape(*batch_shape, n)
    if bias is not None:
        if bias.ndim == 2:  # an expert-stacked pack's (E, N) biases
            bias = bias[:, None, :]
        y = (y.to(torch.float32) + bias.to(torch.float32)).to(y.dtype)
    return y


def _rows(kind: str, x: torch.Tensor, experts) -> tuple[int, torch.Tensor]:
    """(M, the kernel's x) of a call: x flattened to (M, K), or for an
    expert-stacked pack x itself, (E, M, K), with M the rows an expert gets."""
    k = x.shape[-1]
    if experts is None:
        m = math.prod(x.shape[:-1])
        return m, x.reshape(m, k)
    if x.ndim != 3 or x.shape[0] != experts:
        raise ContractError(f"[{kind}] an expert-stacked pack of E={experts} takes x (E, M, K), "
                            f"got {tuple(x.shape)}")
    return x.shape[1], x


def quant_linear(x: torch.Tensor, w: TwinQuantWeights,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dual-component quantized linear: (..., K) -> (..., N) bf16, routed;
    an expert-stacked pack takes (E, M, K) -> (E, M, N)."""
    k = x.shape[-1]
    n = w.ndim_out
    check_twinquant_pack(w, k)
    batch_shape = x.shape[:-1]
    m, x2 = _rows("dual", x, w.experts)
    if _force_ref:
        route = Route(PATH_REF, None, "set_force_ref(True)", "forced")
    else:
        route = classify_dual(m, n, k, w.group, w.rgroup, w.rank)
    _require_cpu_for_ref("dual", route, x)
    _record("dual", route)
    if route.path == PATH_REF:
        y = _ref.dual_gemm_ref(x2, w)
    elif route.path == PATH_DECODE:
        y = dual_gemv(x2, w)
    else:
        y = dual_gemm(x2, w)
    return _finish(y, batch_shape, n, bias)


def fused_linear(x: torch.Tensor,
                 ws: Union[TwinQuantGroupWeights, Sequence[TwinQuantWeights]],
                 biases: Optional[Sequence[Optional[torch.Tensor]]] = None
                 ) -> tuple[torch.Tensor, ...]:
    """Fused sibling-projection linear: (..., K) -> per-segment (..., N_j);
    an expert-stacked group takes (E, M, K) -> per-segment (E, M, N_j).

    One routed launch computes every projection of the group; the
    activation is quantized once. Kind ``dual_fused``. Each segment equals
    :func:`quant_linear` on its own pack bit for bit."""
    gw = ws if isinstance(ws, TwinQuantGroupWeights) else fuse_twinquant_weights(ws)
    if biases is None:
        biases = (None,) * gw.n_segments
    if len(biases) != gw.n_segments:
        raise ValueError(f"{len(biases)} biases for {gw.n_segments} segments")
    k = x.shape[-1]
    check_twinquant_group_pack(gw, k)
    batch_shape = x.shape[:-1]
    m, x2 = _rows("dual_fused", x, gw.experts)
    if _force_ref:
        route = Route(PATH_REF, None, "set_force_ref(True)", "forced")
    else:
        route = classify_dual_group(m, k, gw.group, gw.seg_n, gw.seg_r, gw.rgroups)
    _require_cpu_for_ref("dual_fused", route, x)
    _record("dual_fused", route)
    if route.path == PATH_REF:
        y = _ref.dual_gemm_group_ref(x2, gw)
    elif route.path == PATH_DECODE:
        y = dual_gemv_group(x2, gw)
    else:
        y = dual_gemm_group(x2, gw)
    return tuple(
        _finish(yj, batch_shape, nj, bj)
        for yj, nj, bj in zip(gw.split(y), gw.seg_n, biases)
    )


def classify_w4a16(m: int, n: int, k: int, group: int) -> Route:
    """Route a weight-only call: the kernel (path ``prefill``, every M) or,
    where its contract refuses the shape, the plain version."""
    if k % group != 0 or group % 2 != 0:
        return Route(PATH_REF, None, f"K={k} not tileable by group={group}", "k_group")
    blocks = w4a16_blocks(group)
    try:
        validate_w4a16(m, n, k, group, *blocks)
    except ContractError as e:
        return Route(PATH_REF, None, str(e), "prefill_untileable")
    return Route(PATH_PREFILL, blocks, "weight-only kernel schedule")


def w4a16_linear(x: torch.Tensor, wp: torch.Tensor, ws: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, group: int = 128) -> torch.Tensor:
    """Weight-only quantized linear: (..., K) -> (..., N) bf16, routed."""
    k = x.shape[-1]
    n = wp.shape[-1]
    check_w4a16_pack(wp, ws, k, group)
    batch_shape = x.shape[:-1]
    m = math.prod(batch_shape)
    x2 = x.reshape(m, k)
    if _force_ref:
        route = Route(PATH_REF, None, "set_force_ref(True)", "forced")
    else:
        route = classify_w4a16(m, n, k, group)
    _require_cpu_for_ref("w4a16", route, x)
    _record("w4a16", route)
    if route.path == PATH_REF:
        y = _ref.w4a16_gemm_ref(x2, wp, ws, group)
    else:
        y = w4a16_gemm(x2, wp, ws, group=group)
    return _finish(y, batch_shape, n, bias)


# ---------------------------------------------------------------------------
# block-table attention
# ---------------------------------------------------------------------------


def _attn_viability(h: int, kvh: int, hd: int) -> Optional[Route]:
    if h % kvh != 0:
        return Route(PATH_REF, None, f"H={h} not grouped by KV={kvh}", "hd_unaligned")
    if hd % 8 != 0:
        return Route(PATH_REF, None, f"head_dim={hd} not a whole number of 16-byte loads",
                     "hd_unaligned")
    return None


def classify_ragged(t: int, h: int, kvh: int, hd: int, b: int, maxp: int, page: int) -> Route:
    """Route a ragged-attention call (kind ``ragged``)."""
    bad = _attn_viability(h, kvh, hd)
    if bad is not None:
        return bad
    try:
        validate_ragged_attention(t, h, kvh, hd, b, maxp, page)
    except ContractError as e:
        return Route(PATH_REF, None, str(e), "vmem")
    return Route(PATH_KERNEL, None, f"ragged schedule (T={t}, maxp={maxp})")


def classify_paged_decode(b: int, sq: int, h: int, kvh: int, hd: int, maxp: int,
                          page: int) -> Route:
    """Route a paged decode-attention call (kind ``paged_decode``)."""
    bad = _attn_viability(h, kvh, hd)
    if bad is not None:
        return bad
    if sq > DECODE_M_MAX:
        return Route(PATH_REF, None, f"sq={sq} draft rows exceed DECODE_M_MAX={DECODE_M_MAX}",
                     "rows")
    try:
        validate_paged_decode(b, sq, h, kvh, hd, maxp, page, decode_m_max=DECODE_M_MAX)
    except ContractError as e:
        return Route(PATH_REF, None, str(e), "vmem")
    return Route(PATH_KERNEL, None, f"paged decode schedule (B={b}, sq={sq})")


def ragged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, kt: torch.Tensor,
                     vt: torch.Tensor, bt: torch.Tensor, slot: torch.Tensor,
                     pos: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """Routed ragged paged attention over one step's flat rows (kind
    ``ragged``): ``q (T, H, hd)``, ``kt, vt (T, KV, hd)``, one layer's pools
    ``kp, vp (P, page, KV, hd)``, ``bt (B, maxp)``, ``slot, pos (T,)``
    (slot == B pads), ``ctx (B,)``. Returns (T, H, hd); pad rows are zero."""
    check_ragged_args(q, kp, vp, kt, vt, bt, slot, pos, ctx)
    t, h, hd = q.shape
    b, maxp = bt.shape
    if _force_ref:
        route = Route(PATH_REF, None, "set_force_ref(True)", "forced")
    else:
        route = classify_ragged(t, h, kt.shape[1], hd, b, maxp, kp.shape[1])
    _require_cpu_for_ref("ragged", route, q)
    _record("ragged", route)
    if route.path == PATH_REF:
        return ragged_attention_ref(q, kp, vp, kt, vt, bt, slot, pos, ctx)
    return ragged_attention_kernel(q, kp, vp, kt, vt, bt, slot, pos, ctx)


def paged_decode(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, kt: torch.Tensor,
                 vt: torch.Tensor, bt: torch.Tensor, pos: torch.Tensor, *,
                 commit: bool = True):
    """Routed paged decode attention (kind ``paged_decode``): ``q (B, sq, H,
    hd)`` and ``kt, vt (B, sq, KV, hd)`` post-RoPE rows, one layer's pools,
    ``bt (B, maxp)`` and ``pos (B,)``; no dense view of the cache is built on
    the kernel path. ``commit=True`` returns ``(out, kp, vp)`` with the rows
    written into their tail pages (in place on the card, copies from the
    plain version); ``commit=False`` returns ``out`` only, and the decode
    step writes every layer's rows once after its layers
    (``paged_attention.pool_rows`` + ``write_page_rows``)."""
    check_paged_decode_args(q, kp, vp, kt, vt, bt, pos)
    b, sq, h, hd = q.shape
    if _force_ref:
        route = Route(PATH_REF, None, "set_force_ref(True)", "forced")
    else:
        route = classify_paged_decode(b, sq, h, kt.shape[2], hd, bt.shape[1], kp.shape[1])
    _require_cpu_for_ref("paged_decode", route, q)
    _record("paged_decode", route)
    if route.path == PATH_REF:
        return paged_decode_ref(q, kp, vp, kt, vt, bt, pos, commit=commit)
    return paged_decode_kernel(q, kp, vp, kt, vt, bt, pos, commit=commit)
