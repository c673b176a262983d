"""Ragged paged attention: the plain version and the wrapper over the CUDA
kernel in ``csrc/ragged_attention.cu``.

One launch serves the ragged engine step's flat batch of T rows (decode
rows and prompt chunks of many slots): ``q (T, H, hd)`` / ``kt, vt (T, KV,
hd)`` are post-RoPE rows, row ``t`` belongs to slot ``slot[t]`` (``slot ==
B`` marks padding) at position ``pos[t]``, and attends its slot's committed
pages ``[0, ctx[slot])`` through ``bt`` plus the rows of the same slot with
``pos <= pos[t]``.

* :func:`ragged_attention_ref` is the plain version, mirroring the
  reference's oracle rounding for rounding: decode-like rows (one in-batch
  term, themselves) round the cache and self value dots to bf16 apart, as
  ``models/common.attention_decode_ro`` does; prompt rows take one f32 sum
  and one rounding, as the prefill attention does. Pad rows give zeros.
* :func:`ragged_attention_kernel` launches the kernel for CUDA tensors and
  runs the plain version for CPU tensors. The kernel needs each slot's rows
  as one contiguous run of consecutive positions from ``ctx``, and ``ctx <=
  maxp * page`` (the engine's schedule; ``contracts.check_ragged_rows``
  checks it on the host). It cuts each slot's run into tiles of
  ``ATT_QV_MAX // g`` rows and each row's keys into chunks of
  ``PAGED_CHUNK`` absolute positions: a one-block launch lists on the
  device the (tile, chunk) pairs that hold keys; one block per pair and KV
  head folds its chunk into f32 partials in a scratch this wrapper
  allocates; a last launch folds each row's chunks in ascending order, the
  self term last, as the paged decode kernel does. It accumulates in f32,
  agrees with the plain version to bf16 tolerance, and gives a row the same
  bits however its prompt was chunked and whichever slots share the call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.autotune import PAGED_CHUNK
from repro_torch.kernels.contracts import ragged_scratch_floats, validate_ragged_attention
from repro_torch.kernels.cuda_launch import device_operand, run_kernel
from repro_torch.kernels.paged_attention import gather_pages

__all__ = ["ragged_attention_kernel", "ragged_attention_ref"]

_NEG = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
# (q, kp, vp, kt, vt, bt, slot, ctx, out, scratch, T, B, H, KV, hd, maxp, page, chunk,
#  scale)
_ARGS = [_P] * 10 + [_I] * 8 + [ctypes.c_float]


def ragged_attention_ref(q, kp, vp, kt, vt, bt, slot, pos, ctx) -> torch.Tensor:
    """Plain ragged attention: (T, H, hd) in ``vt.dtype``, pad rows zero."""
    t, h, hd = q.shape
    kv = kt.shape[1]
    g = h // kv
    b, maxp = bt.shape
    page = kp.shape[1]
    s_max = maxp * page
    dev = q.device
    slot, pos, ctx = slot.long(), pos.long(), ctx.long()
    slot_c = slot.clamp(0, b - 1)
    # dense per-row view through the block tables (unmapped -> page 0,
    # masked below by the ctx prefix)
    kc = gather_pages(kp, bt)[slot_c]  # (T, S, KV, hd)
    vc = gather_pages(vp, bt)[slot_c]
    qg = q.reshape(t, kv, g, hd)
    real = slot < b

    logits_c = torch.einsum("tkgh,tskh->tkgs", qg, kc).to(torch.float32) / (hd ** 0.5)
    mask_c = (torch.arange(s_max, device=dev)[None, :] < ctx[slot_c][:, None]) & real[:, None]
    logits_c = torch.where(mask_c[:, None, None, :], logits_c, _NEG)
    logits_b = torch.einsum("tkgh,ukh->tkgu", qg, kt).to(torch.float32) / (hd ** 0.5)
    mask_b = (slot[None, :] == slot[:, None]) & (pos[None, :] <= pos[:, None]) & real[:, None]
    logits_b = torch.where(mask_b[:, None, None, :], logits_b, _NEG)

    m = torch.maximum(logits_c.amax(dim=-1, keepdim=True), logits_b.amax(dim=-1, keepdim=True))
    pc = torch.exp(logits_c - m)
    pb = torch.exp(logits_b - m)
    den = pc.sum(dim=-1, keepdim=True) + pb.sum(dim=-1, keepdim=True)
    pcd = (pc / den).to(vc.dtype)
    pbd = (pb / den).to(vt.dtype)
    # prompt rows: both partial dots in f32, one rounding (bf16 products are
    # exact in f32, so this is the reference's f32-accumulated einsum)
    out_fused = (torch.einsum("tkgs,tskh->tkgh", pcd.float(), vc.float())
                 + torch.einsum("tkgu,ukh->tkgh", pbd.float(), vt.float()))
    # decode-like rows: each dot rounded to bf16, then a bf16 add
    out_split = (torch.einsum("tkgs,tskh->tkgh", pcd, vc)
                 + torch.einsum("tkgu,ukh->tkgh", pbd, vt))
    decode_like = (mask_b.sum(dim=-1) <= 1)[:, None, None, None]
    out = torch.where(decode_like, out_split.float(), out_fused)
    out = torch.where(real[:, None, None, None], out, 0.0)
    return out.to(vt.dtype).reshape(t, h, hd)


def ragged_attention_kernel(q, kp, vp, kt, vt, bt, slot, pos, ctx) -> torch.Tensor:
    """Ragged attention through the CUDA kernel (the plain version for CPU
    tensors). The kernel reads positions from ``ctx`` and each slot's run
    of rows, so ``pos`` and ``ctx`` must follow the row contract (not
    re-checked on the card: that would synchronise)."""
    t, h, hd = q.shape
    kv = kt.shape[1]
    b, maxp = bt.shape
    page = kp.shape[1]
    validate_ragged_attention(t, h, kv, hd, b, maxp, page)
    if q.device.type == "cpu":
        return ragged_attention_ref(q, kp, vp, kt, vt, bt, slot, pos, ctx)
    dev = q.device
    kp_, vp_ = (device_operand("ragged", x, torch.bfloat16, n, dev, in_place=True)
                for x, n in ((kp, "kp"), (vp, "vp")))
    q_, kt_, vt_ = (device_operand("ragged", x, torch.bfloat16, n, dev)
                    for x, n in ((q, "q"), (kt, "kt"), (vt, "vt")))
    bt_, slot_, ctx_ = (device_operand("ragged", x.to(torch.int32), torch.int32, n, dev)
                        for x, n in ((bt, "bt"), (slot, "slot"), (ctx, "ctx")))
    out = torch.empty((t, h, hd), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(ragged_scratch_floats(t, b, h, kv, hd, maxp, page, PAGED_CHUNK),
                          dtype=torch.float32, device=dev)
    args = [q_.data_ptr(), kp_.data_ptr(), vp_.data_ptr(), kt_.data_ptr(), vt_.data_ptr(),
            bt_.data_ptr(), slot_.data_ptr(), ctx_.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), t, b, h, kv, hd, maxp, page, PAGED_CHUNK, float(hd ** -0.5)]
    run_kernel("ragged_attention_kernel", "ragged_attention", "ragged_attention", _ARGS, args,
               dev)
    return out
