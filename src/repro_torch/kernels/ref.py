"""Plain PyTorch versions of the TwinQuant kernels, and the pack format.

These are the port's counterparts of the JAX package's oracles
(``repro/kernels/ref.py``): the same group structure, the same rounding
(``torch.round``, half to even) and the same f32 accumulation order (K
groups ascending, ``acc = acc + (dot * s_x) * s_w``). The CUDA kernels in
``csrc/`` follow that order operation for operation and never contract it
into an FMA, so on the card each kernel is held to its plain version bit for
bit. Against the JAX oracle run op by op (``jax.disable_jit()``) they are
bit-identical too; the jitted oracle is one fused XLA executable that
contracts ``acc + dot * s_x * s_w`` into FMAs on the CPU, so against it they
are held to a tolerance (at a_bits = 4 one f32 ULP in H can flip a
requantized H value and move a whole output row).

Integer dots run as float32 matmuls of the int values. That is exact: every
partial sum is an integer below 2**24 (|sum| <= 128 * 127 * 8). TF32 is
switched off wherever these run, so the card computes the same products.

The weight-only GEMM (``w4a16_gemm_ref``) dequantizes to bf16 and takes each
scale group's dot of bf16 values in float64, then rounds it to float32: the
correctly rounded f32 dot, whatever order a matmul sums in. So its bits do not
depend on the row count, on the CPU as on the card (a float32 matmul's do),
and greedy tokens of the W4A16 engine hold across its modes on the CPU too.
Groups still accumulate in f32, ascending, as in the reference.

Packing layout ("group-split rows"): int4 values are packed two per int8
byte along the contraction axis (axis -2). Within each scale group of ``G``
rows, packed row ``j`` holds logical row ``j`` (low nibble) and row
``j + G/2`` (high nibble), so every packed block stays local to its group.

Expert-stacked packs (an MoE layer's experts, the reference's vmap over a
stacked weight) carry a leading E on every tensor of a pack; the packers
here take such stacks as they are, and :func:`dual_gemm_group_ref` (and so
:func:`dual_gemm_ref`) given one is the plain version of one launch over all
experts: x (E, M, K), each expert's rows computed alone, stacked.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quantization import qmax_for_bits, scale_of

__all__ = [
    "pack_rows_groupsplit",
    "unpack_rows_groupsplit",
    "quantize_rows_ref",
    "quantize_act_ref",
    "dual_gemm_ref",
    "dual_gemm_group_ref",
    "w4a16_gemm_f32",
    "w4a16_gemm_ref",
    "TwinQuantWeights",
    "TwinQuantGroupWeights",
    "as_group",
    "pack_twinquant_weights",
    "fuse_twinquant_weights",
]


# ---------------------------------------------------------------------------
# group-split packing along axis 0
# ---------------------------------------------------------------------------


def _to_int8(v32: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 256) -> int8 with two's-complement wrap."""
    return (((v32 + 128) % 256) - 128).to(torch.int8)


def _sext4(v32: torch.Tensor) -> torch.Tensor:
    """Sign-extend the 4-bit values in ``v32`` (0..15) to int32."""
    return v32 - 16 * (v32 >= 8).to(torch.int32)


def pack_rows_groupsplit(q: torch.Tensor, group: int) -> torch.Tensor:
    """(..., K, N) int4-valued int8 -> (..., K/2, N) packed, group-split
    layout."""
    *lead, k, n = q.shape
    if k % group or group % 2:
        raise ValueError(f"K={k} must be a multiple of an even group={group}")
    q4 = q.to(torch.int32).reshape(*lead, k // group, 2, group // 2, n)
    packed = (q4[..., 0, :, :] & 0x0F) | ((q4[..., 1, :, :] & 0x0F) << 4)
    return _to_int8(packed).reshape(*lead, k // 2, n)


def unpack_rows_groupsplit(p: torch.Tensor, group: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows_groupsplit`."""
    *lead, k2, n = p.shape
    g2 = group // 2
    u = p.to(torch.int32).reshape(*lead, k2 // g2, g2, n) & 0xFF
    lo = _sext4(u & 0x0F)
    hi = _sext4((u >> 4) & 0x0F)
    return torch.cat([lo, hi], dim=-2).reshape(*lead, k2 * 2, n).to(torch.int8)


# ---------------------------------------------------------------------------
# quantization helpers shared with the kernels (identical rounding)
# ---------------------------------------------------------------------------


def quantize_rows_ref(w: torch.Tensor, group: int, bits: int):
    """Group-wise symmetric quantization along axis -2 (a leading expert
    axis, if any, is carried through).

    Returns (q int8 (..., K, N), scales f32 (..., K/group, N))."""
    *lead, k, n = w.shape
    qmax = qmax_for_bits(bits)
    g = w.to(torch.float32).contiguous().reshape(*lead, k // group, group, n)
    scale = scale_of(g.abs().amax(dim=-2), qmax)
    q = torch.clamp(torch.round(g / scale[..., None, :]), -qmax, qmax)
    return q.reshape(*lead, k, n).to(torch.int8), scale


def quantize_act_ref(x: torch.Tensor, group: int, bits: int):
    """Group-wise symmetric quantization along axis 1 (activations).

    Returns (q int8 (M, K), scales f32 (M, K/group))."""
    m, k = x.shape
    qmax = qmax_for_bits(bits)
    g = x.to(torch.float32).contiguous().reshape(m, k // group, group)
    scale = scale_of(g.abs().amax(dim=2), qmax)
    q = torch.clamp(torch.round(g / scale[:, :, None]), -qmax, qmax)
    return q.reshape(m, k).to(torch.int8), scale


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 dot as a float32 matmul (every partial sum is an
    integer below 2**24); the caller has switched TF32 off."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _exact_matmuls() -> None:
    # a float32 product on the card must stay float32: TF32 would round the
    # int operands' products (they are exact only in full f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# packed-weight containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TwinQuantWeights:
    """Offline-quantized dual-component weights (4-bit packed). An
    expert-stacked pack has a leading E on every tensor (``experts``)."""

    up: torch.Tensor  # (K/2, r)   packed int4 — low-rank in-factor
    us: torch.Tensor  # (K/G, r)   f32 scales
    vp: torch.Tensor  # (r/2, N)   packed int4 — low-rank out-factor
    vs: torch.Tensor  # (r/gr, N)  f32 scales
    rp: torch.Tensor  # (K/2, N)   packed int4 — residual
    rs: torch.Tensor  # (K/G, N)   f32 scales
    group: int  # K-axis scale group (128)
    rgroup: int  # r-axis scale group (min(128, r))
    a_bits: int  # activation bits (4 or 8); H is requantized at a_bits

    @property
    def kdim(self) -> int:
        return self.up.shape[-2] * 2

    @property
    def ndim_out(self) -> int:
        return self.rp.shape[-1]

    @property
    def rank(self) -> int:
        return self.up.shape[-1]

    @property
    def experts(self):
        """E of an expert-stacked pack, ``None`` for a single pack."""
        return self.rp.shape[0] if self.rp.ndim == 3 else None

    def expert(self, e: int) -> "TwinQuantWeights":
        """Expert ``e`` of a stacked pack, as views."""
        return dataclasses.replace(self, up=self.up[e], us=self.us[e], vp=self.vp[e],
                                   vs=self.vs[e], rp=self.rp[e], rs=self.rs[e])


def pack_twinquant_weights(U, V, R, *, w_bits: int = 4, a_bits: int = 4,
                           group: int = 128) -> TwinQuantWeights:
    """Quantize + pack the (already transformed) components offline; U, V,
    R may carry a leading expert axis, which every pack tensor keeps."""
    if w_bits != 4:
        raise ValueError("the packed path is int4")
    k, r = U.shape[-2:]
    rgroup = min(group, r)
    uq, us = quantize_rows_ref(U, group, w_bits)
    vq, vs = quantize_rows_ref(V, rgroup, w_bits)
    rq, rs = quantize_rows_ref(R, group, w_bits)
    return TwinQuantWeights(
        up=pack_rows_groupsplit(uq, group), us=us,
        vp=pack_rows_groupsplit(vq, rgroup), vs=vs,
        rp=pack_rows_groupsplit(rq, group), rs=rs,
        group=group, rgroup=rgroup, a_bits=a_bits,
    )


@dataclasses.dataclass
class TwinQuantGroupWeights:
    """Sibling :class:`TwinQuantWeights` fused along N (one launch per group).

    ``rp``/``rs`` and ``up``/``us`` are concatenated (R along N, U along the
    rank axis; both are column-independent, so concatenation is the
    per-segment quantization bit for bit). V stays per segment
    (``vps``/``vss``) to keep each segment's own rank-group structure."""

    up: torch.Tensor  # (K/2, R)     U factors stacked along rank
    us: torch.Tensor  # (K/G, R)
    vps: tuple  # per segment: (r_j/2, N_j) packed int4
    vss: tuple  # per segment: (r_j/gr_j, N_j) f32 scales
    rp: torch.Tensor  # (K/2, sum N) residuals concatenated
    rs: torch.Tensor  # (K/G, sum N)
    group: int
    rgroups: tuple  # per-segment r-axis scale group
    a_bits: int

    @property
    def kdim(self) -> int:
        return self.rp.shape[-2] * 2

    @property
    def n_segments(self) -> int:
        return len(self.vps)

    @property
    def seg_n(self) -> tuple:
        return tuple(vp.shape[-1] for vp in self.vps)

    @property
    def seg_r(self) -> tuple:
        return tuple(vp.shape[-2] * 2 for vp in self.vps)

    @property
    def ndim_out(self) -> int:
        return self.rp.shape[-1]

    @property
    def rank(self) -> int:
        return self.up.shape[-1]

    @property
    def experts(self):
        """E of an expert-stacked group, ``None`` for a single one."""
        return self.rp.shape[0] if self.rp.ndim == 3 else None

    def expert(self, e: int) -> "TwinQuantGroupWeights":
        """Expert ``e`` of a stacked group, as views."""
        return dataclasses.replace(self, up=self.up[e], us=self.us[e], rp=self.rp[e],
                                   rs=self.rs[e], vps=tuple(v[e] for v in self.vps),
                                   vss=tuple(v[e] for v in self.vss))

    @staticmethod
    def _offsets(sizes) -> tuple:
        offs, acc = [], 0
        for s in sizes:
            offs.append(acc)
            acc += s
        return tuple(offs)

    @property
    def n_offsets(self) -> tuple:
        return self._offsets(self.seg_n)

    @property
    def r_offsets(self) -> tuple:
        return self._offsets(self.seg_r)

    def segment(self, j: int) -> TwinQuantWeights:
        """The j-th sibling pack, recovered as exact views of the fused one."""
        no, ro = self.n_offsets[j], self.r_offsets[j]
        nj, rj = self.seg_n[j], self.seg_r[j]
        return TwinQuantWeights(
            up=self.up[..., ro:ro + rj], us=self.us[..., ro:ro + rj],
            vp=self.vps[j], vs=self.vss[j],
            rp=self.rp[..., no:no + nj], rs=self.rs[..., no:no + nj],
            group=self.group, rgroup=self.rgroups[j], a_bits=self.a_bits,
        )

    def split(self, y: torch.Tensor) -> tuple:
        """Split a fused (..., sum N) output into per-segment views."""
        return tuple(y[..., no:no + nj] for no, nj in zip(self.n_offsets, self.seg_n))


def as_group(w: TwinQuantWeights) -> TwinQuantGroupWeights:
    """A single pack as a one-segment group (shared kernel entry)."""
    return TwinQuantGroupWeights(
        up=w.up, us=w.us, vps=(w.vp,), vss=(w.vs,), rp=w.rp, rs=w.rs,
        group=w.group, rgroups=(w.rgroup,), a_bits=w.a_bits,
    )


def fuse_twinquant_weights(ws) -> TwinQuantGroupWeights:
    """Merge sibling packs (same K, group, a_bits, and experts if stacked)
    into one fused group.

    Pure concatenation along the last axis — ``fused.segment(j)`` recovers
    ``ws[j]`` bit for bit."""
    ws = tuple(ws)
    if not ws:
        raise ValueError("need at least one pack")
    base = ws[0]
    for w in ws:
        key, base_key = (w.kdim, w.group, w.a_bits, w.experts), (
            base.kdim, base.group, base.a_bits, base.experts)
        if key != base_key:
            raise ValueError(f"packs disagree on (K, group, a_bits, experts): {key} vs {base_key}")
    return TwinQuantGroupWeights(
        up=torch.cat([w.up for w in ws], dim=-1),
        us=torch.cat([w.us for w in ws], dim=-1),
        vps=tuple(w.vp for w in ws),
        vss=tuple(w.vs for w in ws),
        rp=torch.cat([w.rp for w in ws], dim=-1),
        rs=torch.cat([w.rs for w in ws], dim=-1),
        group=base.group,
        rgroups=tuple(w.rgroup for w in ws),
        a_bits=base.a_bits,
    )


# ---------------------------------------------------------------------------
# the dual-component GEMM: plain versions
# ---------------------------------------------------------------------------


def dual_gemm_group_ref(x: torch.Tensor, gw: TwinQuantGroupWeights) -> torch.Tensor:
    """Fused-group plain version: x (M, K) -> (M, sum N_j) bf16; an
    expert-stacked group takes x (E, M, K) -> (E, M, sum N_j), expert e's
    rows being this function of x[e] with pack e.

    X is quantized once; one ascending pass over K groups builds the
    residual accumulator and the stacked H; each segment then requantizes
    its own H columns with its own rank groups and adds its V epilogue.
    Every operation is column-independent, so each output segment equals
    :func:`dual_gemm_ref` on the segment's own pack bit for bit."""
    if gw.experts is not None:
        return torch.stack([dual_gemm_group_ref(x[e], gw.expert(e)) for e in range(gw.experts)])
    _exact_matmuls()
    m, k = x.shape
    G, a_bits = gw.group, gw.a_bits
    a_qmax = qmax_for_bits(a_bits)
    xq, xs = quantize_act_ref(x, G, a_bits)
    uq = unpack_rows_groupsplit(gw.up, G)
    rq = unpack_rows_groupsplit(gw.rp, G)
    acc_r = torch.zeros((m, gw.ndim_out), dtype=torch.float32, device=x.device)
    h = torch.zeros((m, gw.rank), dtype=torch.float32, device=x.device)
    for g in range(k // G):
        xg = xq[:, g * G:(g + 1) * G]
        sg = xs[:, g:g + 1]
        acc_r = acc_r + _int_dot(xg, rq[g * G:(g + 1) * G]) * sg * gw.rs[g:g + 1]
        h = h + _int_dot(xg, uq[g * G:(g + 1) * G]) * sg * gw.us[g:g + 1]
    outs = []
    for j in range(gw.n_segments):
        no, ro = gw.n_offsets[j], gw.r_offsets[j]
        nj, rj, gr = gw.seg_n[j], gw.seg_r[j], gw.rgroups[j]
        hg = h[:, ro:ro + rj].reshape(m, rj // gr, gr)
        hs = scale_of(hg.abs().amax(dim=2), a_qmax)
        hq = torch.clamp(torch.round(hg / hs[:, :, None]), -a_qmax, a_qmax)
        hq = hq.reshape(m, rj).to(torch.int8)
        vq = unpack_rows_groupsplit(gw.vps[j], gr)
        out = acc_r[:, no:no + nj]
        for gg in range(rj // gr):
            p = _int_dot(hq[:, gg * gr:(gg + 1) * gr], vq[gg * gr:(gg + 1) * gr])
            out = out + p * hs[:, gg:gg + 1] * gw.vss[j][gg:gg + 1]
        outs.append(out)
    return torch.cat(outs, dim=-1).to(torch.bfloat16)


def dual_gemm_ref(x: torch.Tensor, w: TwinQuantWeights) -> torch.Tensor:
    """Plain dual-component GEMM: x (M, K) -> (M, N) bf16,

    y = dq(Xq @ Rq) + dq(requant(dq(Xq @ Uq)) @ Vq)

    with group-wise scales and H requantized at ``w.a_bits``; K groups
    accumulate in ascending order. A single pack is a one-segment group;
    an expert-stacked pack takes x (E, M, K) -> (E, M, N)."""
    return dual_gemm_group_ref(x, as_group(w))


# ---------------------------------------------------------------------------
# the weight-only (W4A16) GEMM: plain version
# ---------------------------------------------------------------------------


def w4a16_gemm_f32(x: torch.Tensor, wp: torch.Tensor, ws: torch.Tensor,
                   group: int = 128) -> torch.Tensor:
    """:func:`w4a16_gemm_ref` before its final bf16 cast: (M, N) float32, or
    (E, M, N) for an expert-stacked pack."""
    if wp.ndim == 3:  # each expert alone, stacked (the reference's vmap)
        return torch.stack([w4a16_gemm_f32(x[e], wp[e], ws[e], group)
                            for e in range(wp.shape[0])])
    wq = unpack_rows_groupsplit(wp, group)
    k, n = wq.shape
    xb = x.to(torch.bfloat16)
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32, device=x.device)
    for g in range(k // group):
        w_deq = (wq[g * group:(g + 1) * group].to(torch.float32) * ws[g:g + 1]).to(torch.bfloat16)
        xg = xb[:, g * group:(g + 1) * group]
        p = (xg.to(torch.float64) @ w_deq.to(torch.float64)).to(torch.float32)
        acc = acc + p
    return acc


def w4a16_gemm_ref(x: torch.Tensor, wp: torch.Tensor, ws: torch.Tensor,
                   group: int = 128) -> torch.Tensor:
    """Weight-only quantized GEMM: x (M, K) bf16, wp (K/2, N) packed int4,
    ws (K/G, N) f32 -> (M, N) bf16. Weights dequantize to bf16 as
    ``bf16(f32(q) * s)``; each group's dot is added to an f32 accumulator in
    ascending group order; one bf16 cast at the end. An expert-stacked pack
    (``wp`` (E, K/2, N), ``ws`` (E, K/G, N)) takes x (E, M, K) -> (E, M,
    N), each expert computed alone."""
    return w4a16_gemm_f32(x, wp, ws, group).to(torch.bfloat16)
