"""Roofline of the port on one NVIDIA H100 (the reference's
``repro/launch/roofline.py``, whose constants are a TPU's):

    compute    = sum over classes of flops[class] / PEAK[class]
    memory     = bytes / HBM_BW
    collective = sum over groups of bytes / (LINK_BW within a host, NET_BW across)

every count per device. The constants are NVIDIA's published peaks for the
H100 SXM (dense, no sparsity, at the 700 W limit), not measurements; a card
set below 700 W runs slower under load.

Operation classes: ``bf16`` (tensor-core matmuls in bf16 / fp16), ``int8``
(tensor-core int8: the dual kernels' products) and ``f32`` (everything on
the CUDA cores: f32 matmuls with TF32 off, every elementwise op and
reduction, whatever its dtype).

:func:`kernel_cost` is the one count of each hand-written kernel's work,
read by ``chip_smoke.py``'s bound column and by ``op_cost.analyze_step``
at each dispatch entry: each input byte read once, each output byte
written once, and the operations the inputs need (for the attention
kernels, the context lengths of this call, read on the host).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = ["HBM_BW", "LINK_BW", "NET_BW", "PEAK", "PEAK_BF16", "PEAK_F32", "PEAK_INT8",
           "Roofline", "bound_ms", "dual_pack_bytes", "from_counts", "kernel_cost"]

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BF16 = 9.89e14  # bf16 / fp16 tensor core, FLOP/s
PEAK_INT8 = 1.979e15  # int8 tensor core, OP/s
PEAK_F32 = 6.7e13  # f32 on the CUDA cores (no tensor core), FLOP/s
HBM_BW = 3.35e12  # HBM3, bytes/s
LINK_BW = 4.5e11  # NVLink 4, bytes/s each way per GPU, within a host of 8
# DGX H100: one 400 Gb/s NIC a GPU, for a group that spans hosts
NET_BW = 5e10
HOST_GPUS = 8  # GPUs a host joins by NVLink

PEAK = {"bf16": PEAK_BF16, "int8": PEAK_INT8, "f32": PEAK_F32}


@dataclasses.dataclass
class Roofline:
    """Roofline terms of one step from per-device counts (``flops``,
    ``hbm_bytes``, ``coll_bytes``); ``model_flops`` is global. The
    reference's fields and keys, plus ``flops_by_class`` (None: every flop
    at the bf16 peak, as the reference's one peak) and ``coll_net_bytes``,
    the part of ``coll_bytes`` moved in groups that span hosts."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    model_flops: Optional[float] = None
    flops_by_class: Optional[dict] = None
    coll_net_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        if self.flops_by_class is None:
            return self.flops / PEAK_BF16
        return sum(v / PEAK[c] for c, v in self.flops_by_class.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.coll_bytes - self.coll_net_bytes) / LINK_BW + self.coll_net_bytes / NET_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if not self.model_flops or not self.flops:
            return None
        return (self.model_flops / self.chips) / self.flops

    @property
    def roofline_fraction(self) -> Optional[float]:
        """The time the model's flops would take at the bf16 peak over the
        roofline-bound step time."""
        if not self.model_flops:
            return None
        return (self.model_flops / (self.chips * PEAK_BF16)) / self.bound_time

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "flops_by_class": self.flops_by_class,
            "coll_net_bytes": self.coll_net_bytes,
        }


def from_counts(cost: dict, chips: int, model_flops: Optional[float] = None) -> Roofline:
    """A :class:`Roofline` from ``op_cost.analyze_step``'s dict (the
    reference's ``from_compiled``)."""
    return Roofline(flops=cost["flops"], hbm_bytes=cost["bytes"],
                    coll_bytes=cost["coll_bytes"], chips=chips, model_flops=model_flops,
                    flops_by_class=dict(cost["flops_by_class"]),
                    coll_net_bytes=cost.get("coll_net_bytes", 0.0))


# ---------------------------------------------------------------------------
# the hand-written kernels' work
# ---------------------------------------------------------------------------


def dual_pack_bytes(k: int, seg_n: Sequence[int], seg_r: Sequence[int], group: int = 128,
                    rgroups: Optional[Sequence[int]] = None, experts: int = 1) -> int:
    """Bytes of a dual pack (one segment per linear of a fused group): the
    int4 U, V and residual packs, two values a byte, and their f32 scales,
    one a ``group`` of K (U, R) or a rank group of r (V)."""
    rgroups = rgroups or [min(group, r) for r in seg_r]
    rank, n = sum(seg_r), sum(seg_n)
    b = k // 2 * rank + k // group * rank * 4 + k // 2 * n + k // group * n * 4
    b += sum(r // 2 * nj + r // gr * nj * 4 for r, nj, gr in zip(seg_r, seg_n, rgroups))
    return experts * b


def _dual(m: int, k: int, seg_n, seg_r, pack_bytes: int, experts: int = 1):
    """A dual launch over ``experts`` experts of ``m`` rows each: x in, the
    pack once, y out; the residual, H = Xq U and V products in int8."""
    n, r = sum(seg_n), sum(seg_r)
    nbytes = experts * m * k * 2 + pack_bytes + experts * m * n * 2
    ops = experts * (2 * m * k * n + 2 * m * k * r
                     + sum(2 * m * rj * nj for rj, nj in zip(seg_r, seg_n)))
    return {"int8": ops}, nbytes


def _dual_from(m: int, w=None, *, k=None, seg_n=None, seg_r=None, group: int = 128,
               rgroups=None, experts: int = 1, pack_bytes=None):
    if w is not None:  # a TwinQuantWeights or TwinQuantGroupWeights
        vps = getattr(w, "vps", None) or (w.vp,)
        vss = getattr(w, "vss", None) or (w.vs,)
        ts = [w.up, w.us, w.rp, w.rs, *vps, *vss]
        pack_bytes = sum(t.numel() * t.element_size() for t in ts)
        k = w.kdim
        seg_n = tuple(v.shape[-1] for v in vps)
        seg_r = tuple(v.shape[-2] * 2 for v in vps)
        experts = w.experts or 1
    elif pack_bytes is None:
        pack_bytes = dual_pack_bytes(k, seg_n, seg_r, group, rgroups, experts)
    return _dual(m, k, seg_n, seg_r, pack_bytes, experts)


def _w4a16(m: int, k: int, n: int, group: int = 128, experts: int = 1):
    """``X dq(Wq)``: int4 weights, f32 scales a group of K, bf16 in and out;
    bf16 tensor-core operations."""
    nbytes = experts * (k * n // 2 + (k // group) * n * 4 + m * k * 2 + m * n * 2)
    return {"bf16": 2 * experts * m * n * k}, nbytes


def _paged(b: int, sq: int, h: int, kv: int, hd: int, maxp: int, lens: Sequence[int],
           commit: bool = False):
    """Paged decode over ``lens`` committed keys a slot: those keys and
    values read once, q and the output, this step's rows (written to the
    pool too with ``commit``), the block table and positions; the score and
    P.V products of each row over its keys and the rows before it."""
    nbytes = (2 * sum(lens) * kv * hd * 2 + 2 * b * sq * h * hd * 2
              + (2 + 2 * commit) * b * sq * kv * hd * 2 + b * maxp * 4 + b * 4)
    flops = sum(4 * hd * h * (n + i + 1) for n in lens for i in range(sq))
    return {"bf16": flops}, nbytes


def _ragged(t: int, h: int, kv: int, hd: int, b: int, maxp: int, slot: Sequence[int],
            pos: Sequence[int], ctx: Sequence[int]):
    """Ragged attention over one step's ``t`` flat rows (slot ``b`` pads):
    the committed keys and values of the slots with rows, the rows' q, k, v
    and output, the metadata; the score and P.V products of every real row
    over its ``pos + 1`` keys."""
    live = {s for s in slot if s < b}
    keys = sum(ctx[s] for s in live)
    nbytes = 2 * keys * kv * hd * 2 + t * (2 * h + 2 * kv) * hd * 2 + b * maxp * 4 + t * 8 + b * 4
    flops = sum(4 * hd * h * (p + 1) for p, s in zip(pos, slot) if s < b)
    return {"bf16": flops}, nbytes


_COSTS = {
    "dual_gemv": _dual_from,
    "dual_gemv_group": _dual_from,
    "dual_gemm": _dual_from,
    "dual_gemm_group": _dual_from,
    "w4a16_gemm": _w4a16,
    "paged_decode_kernel": _paged,
    "ragged_attention_kernel": _ragged,
}


def kernel_cost(name: str, **shapes) -> tuple[dict, int]:
    """``(ops by class, bytes)`` of one call of the hand-written kernel
    ``name`` (a wrapper of ``chip_smoke.KERNELS``):

    * the four dual kernels: ``m`` (rows an expert) and the pack ``w``, or
      ``k``, ``seg_n``, ``seg_r`` (``group``, ``rgroups``, ``experts``);
    * ``w4a16_gemm``: ``m``, ``k``, ``n`` (``group``, ``experts``);
    * ``paged_decode_kernel``: ``b``, ``sq``, ``h``, ``kv``, ``hd``, ``maxp``,
      ``lens`` (each slot's committed keys), ``commit``;
    * ``ragged_attention_kernel``: ``t``, ``h``, ``kv``, ``hd``, ``b``,
      ``maxp`` and the ``slot``, ``pos``, ``ctx`` lists.
    """
    if name not in _COSTS:
        raise KeyError(f"no cost model for kernel {name!r}; known: {sorted(_COSTS)}")
    ops, nbytes = _COSTS[name](**shapes)
    return ops, int(nbytes)


def bound_ms(cost: tuple[dict, int]) -> tuple[float, str]:
    """The least time in ms for ``cost`` = (ops by class, bytes), and what
    bounds it: ``"bytes"`` (over ``HBM_BW``) or ``"operations"`` (each
    class over its peak, summed)."""
    ops, nbytes = cost
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = sum(v / PEAK[c] for c, v in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
