"""int8 gradient compression with error feedback, for the data-parallel
all-reduce (the reference's ``repro/optim/grad_compression.py``).

Each gradient leaf is quantized to int8 with its own scale ``amax / 127``
(1.0 when the leaf is all zeros), rounded half to even and clipped to
+-127, before the data-parallel reduction; the quantization residual is
kept, in the gradient's dtype, in an error-feedback accumulator that is
added back on the next step (EF-SGD). 4x less all-reduce traffic. The
train step compresses and decompresses the gradients after their
reduction, as the reference's step does under SPMD (its psum is implicit
and comes first); no collective carries int8.

Sharded gradients (DTensors) keep the per-leaf formula's bits on every
shard: the amax is the whole leaf's (the shards' maxima reduced with an
all-reduce max), every other op is elementwise on the local shard, and the
results come back as DTensors in the gradient's placements.

A leaf is a leaf of the reference's tree: the reference stacks every
per-layer tensor on a leading layer axis, so all layers' ``ln1`` (say)
are one leaf there with one amax. The port's tensors share a scale when
they land in one reference leaf (``interop.reference_leaf``; ``cfg`` tells
DeepSeek-V3's dense layers from its MoE layers).

Every division is by a device tensor, so on the card it is a true division
as the reference run op by op does it (CUDA turns a division by a host
scalar into a reciprocal multiply).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ModelConfig
from repro_torch.interop import reference_leaf
from repro_torch.models.context import local_shard, reduce_over_shards, shard_like

__all__ = ["compress_grads_int8", "decompress_grads_int8"]


def compress_grads_int8(grads: dict, ef: Optional[dict] = None, cfg: ModelConfig = None):
    """``grads`` by name -> (q int8, scales f32 0-d, new error feedback in
    each gradient's dtype), all by name; the tensors of one reference leaf
    share its scale. Dequantize with ``q * scale``."""
    f32 = torch.float32
    if ef is None:
        ef = {n: torch.zeros_like(g) for n, g in grads.items()}
    leaves: dict = {}
    for n in grads:
        leaves.setdefault(reference_leaf(n, cfg)[0], []).append(n)
    q, scales, new_ef = {}, {}, {}
    for names in leaves.values():
        g32 = {n: local_shard(grads[n]).to(f32) + local_shard(ef[n]).to(f32) for n in names}
        amax = torch.stack([reduce_over_shards(torch.max(torch.abs(g)), grads[n],
                                               dist.ReduceOp.MAX)
                            for n, g in g32.items()]).max()
        scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
        for n, g in g32.items():
            qq = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            q[n], scales[n] = shard_like(qq, grads[n]), scale
            new_ef[n] = shard_like((g - qq.to(f32) * scale).to(grads[n].dtype), grads[n])
    return q, scales, new_ef


def decompress_grads_int8(q: dict, scales: dict) -> dict:
    """f32 gradients ``q * scale`` by name."""
    return {n: shard_like(local_shard(qq).to(torch.float32) * scales[n], qq) for n, qq in q.items()}
