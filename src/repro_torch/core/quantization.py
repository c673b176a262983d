"""Symmetric group-wise quantization primitives (paper Eq. 1).

Conventions, the same as the reference's:

* ``q = clip(round(x / s), -qmax, qmax)`` with ``s = max|group| / qmax`` and
  ``qmax = 2**(bits-1) - 1`` (int4 uses the symmetric range [-7, 7]).
* Grouping runs along ONE axis (the contraction axis of the consuming
  matmul), ``group_size`` contiguous elements per scale.
* Integer values are stored as int8 whatever ``bits`` is; 4-bit tensors are
  packed two nibbles per byte by :func:`pack_int4` / :func:`unpack_int4`.
* ``torch.round`` rounds half to even, like ``jnp.round`` and CUDA's
  ``rintf``.
* Scales divide by a tensor, never by a Python number (:func:`scale_of`):
  otherwise the scale, and with it the straight-through clip mask, would
  move by an ULP on CUDA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "QuantConfig",
    "QTensor",
    "qmax_for_bits",
    "scale_of",
    "compute_scales",
    "quantize",
    "dequantize",
    "fake_quant",
    "pack_int4",
    "unpack_int4",
]


def qmax_for_bits(bits: int) -> int:
    return 2 ** (bits - 1) - 1


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static description of one quantizer (weights OR activations)."""

    bits: int = 4
    group_size: int = 128
    # axis the groups run along; -1 == last axis (the matmul contraction dim)
    axis: int = -1

    @property
    def qmax(self) -> int:
        return qmax_for_bits(self.bits)

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class QTensor:
    """A quantized tensor: int values + per-group scales + static metadata."""

    q: torch.Tensor  # int8 storage (values within the `bits` range)
    scale: torch.Tensor  # f32, shape == q.shape with `axis` reduced by group_size
    bits: int
    group_size: int
    axis: int

    @property
    def shape(self):
        return self.q.shape


def _grouped(x: torch.Tensor, axis: int, group_size: int) -> tuple[torch.Tensor, int]:
    """Reshape ``axis`` into (n_groups, group_size); returns (y, norm_axis)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    if n % group_size != 0:
        raise ValueError(f"axis size {n} not divisible by group_size {group_size}")
    new_shape = x.shape[:axis] + (n // group_size, group_size) + x.shape[axis + 1:]
    return x.reshape(new_shape), axis + 1


def scale_of(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """``amax / qmax`` per group, 1 where ``amax`` is 0 (an all-zero group
    quantizes to zeros), in ``amax``'s dtype. The divisor is a tensor: on
    CUDA, PyTorch turns division by a Python number into multiplication by
    its reciprocal, which is not the correctly rounded quotient the kernels
    and the reference compute."""
    return torch.where(amax > 0, amax / torch.full_like(amax, qmax), torch.ones_like(amax))


def compute_scales(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Per-group symmetric scales ``max|group| / qmax`` (zero-safe), in f32.
    The quotient is taken in ``x``'s dtype, as the reference takes it."""
    g, gaxis = _grouped(x, cfg.axis, cfg.group_size)
    return scale_of(torch.amax(torch.abs(g), dim=gaxis), cfg.qmax).to(torch.float32)


def quantize(x: torch.Tensor, cfg: QuantConfig, scale: Optional[torch.Tensor] = None) -> QTensor:
    """Quantize ``x`` group-wise along ``cfg.axis``."""
    if scale is None:
        scale = compute_scales(x, cfg)
    g, gaxis = _grouped(x.to(torch.float32), cfg.axis, cfg.group_size)
    s = scale.unsqueeze(gaxis)
    q = torch.clamp(torch.round(g / s), -cfg.qmax, cfg.qmax)
    q = q.reshape(x.shape).to(torch.int8)
    return QTensor(q=q, scale=scale, bits=cfg.bits, group_size=cfg.group_size,
                   axis=cfg.axis % x.ndim)


def dequantize(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    g, gaxis = _grouped(t.q.to(torch.float32), t.axis, t.group_size)
    s = t.scale.unsqueeze(gaxis)
    return (g * s).reshape(t.q.shape).to(dtype)


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize; the backward is the reference's straight-through
    estimator: the cotangent passes where ``|x / s| <= qmax`` and is zero
    where the value saturated. The scale gets no gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
        scale = compute_scales(x, cfg)
        y = dequantize(quantize(x, cfg, scale), dtype=x.dtype)
        g, gaxis = _grouped(x, cfg.axis, cfg.group_size)
        inside = (torch.abs(g / scale.unsqueeze(gaxis)) <= cfg.qmax).reshape(x.shape)
        ctx.save_for_backward(inside)
        return y

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (inside,) = ctx.saved_tensors
        return ct * inside.to(ct.dtype), None


def fake_quant(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator (paper §4.2):
    the calibration trainer's gradients flow through the rounding as
    identity within the clip range."""
    return _FakeQuant.apply(x, cfg)


# ---------------------------------------------------------------------------
# int4 nibble packing: two int4 values per int8 byte along the LAST axis
# ---------------------------------------------------------------------------


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4-valued int8 pairs along the last axis: out[..., i] holds
    (q[..., 2i] & 0xF) | (q[..., 2i+1] << 4). Last axis must be even."""
    if q.shape[-1] % 2 != 0:
        raise ValueError("last axis must be even to pack int4 pairs")
    lo = q[..., 0::2].to(torch.int32)
    hi = q[..., 1::2].to(torch.int32)
    return ((lo & 0x0F) | ((hi & 0x0F) << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extends each nibble)."""
    p32 = p.to(torch.int32)
    lo = (p32 << 28) >> 28
    hi = (p32 << 24) >> 28
    out = torch.stack([lo, hi], dim=-1).reshape(p.shape[:-1] + (p.shape[-1] * 2,))
    return out.to(torch.int8)
