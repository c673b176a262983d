"""Block-table paged decode attention: the plain version and the wrapper over
the CUDA kernel in ``csrc/paged_attention.cu``.

``q (B, sq, H, hd)`` / ``kt, vt (B, sq, KV, hd)`` are post-RoPE rows: row
``i`` of slot ``b`` sits at position ``pos[b] + i`` and attends the committed
prefix ``[0, pos[b])`` of the slot's pages (``kp, vp (P, page, KV, hd)``
through ``bt (B, maxp)``, -1 unmapped), the earlier rows of its own slot,
and itself. ``sq == 1`` is plain decode; ``sq > 1`` a speculative draft
stack. With ``commit=True`` the rows are also written into their tail pages.

* :func:`paged_decode_ref` is the plain version. Its numerics mirror the
  reference's oracle rounding for rounding (one bf16 cache dot per row
  under a strict per-row prefix mask over a dense view with the draft rows
  written in, the self term rounded apart), so ``sq == 1`` equals the
  dense-cache decode (``models/common.attention_decode_ro``) bit for bit
  and row ``i`` of a stack equals a sequential launch at ``pos + i``.
* :func:`paged_decode_kernel` launches the kernel for CUDA tensors and runs
  the plain version for CPU tensors. The kernel splits each slot's keys
  into chunks of ``PAGED_CHUNK`` absolute positions (one block each, f32
  partials in a scratch this wrapper allocates) and folds the chunks in
  ascending order, then the self term, in a second launch. It accumulates
  in f32 with an online softmax, so it agrees with the plain version to
  bf16 tolerance, and its own stacked rows equal its sequential launches
  bit for bit. Its commit updates the caller's pools in place; the plain
  version returns updated copies.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.autotune import DECODE_M_MAX, PAGED_CHUNK
from repro_torch.kernels.contracts import paged_scratch_floats, validate_paged_decode
from repro_torch.kernels.cuda_launch import device_operand, run_kernel

__all__ = ["gather_pages", "paged_decode_kernel", "paged_decode_ref", "pool_rows",
           "scatter_rows_pool", "write_page_rows"]

_NEG = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
# (q, kp, vp, kt, vt, bt, pos, out, scratch, B, sq, H, KV, hd, maxp, page, chunk, scale,
#  commit)
_ARGS = [_P] * 9 + [_I] * 8 + [ctypes.c_float, _I]


def pool_rows(bt: torch.Tensor, slot: torch.Tensor, pos: torch.Tensor, page: int,
              n_pages: int):
    """Where flat rows land in a pool, at a fixed shape and with no host sync
    (so a CUDA graph can hold it): row ``i`` goes to page ``bt[slot_i, pos_i
    // page]`` at offset ``pos_i % page``. Pad rows (slot >= B), rows past
    the block table and rows into unmapped pages (or page ids past
    ``n_pages``) are dropped, as the reference's ``mode="drop"`` drops them:
    a dropped row repeats the first kept row's place and value, so the
    writes that land together are identical and the result does not depend
    on their order; with no row kept, the rows write page 0 offset 0's own
    value back. Returns (source row per row, flat place ``page_id * page +
    offset`` per row, whether any row is kept) for :func:`write_page_rows`."""
    b, maxp = bt.shape
    slot, pos = slot.long(), pos.long()
    rows = torch.arange(slot.shape[0], device=slot.device)
    if slot.shape[0] == 0:
        return rows, rows, torch.zeros((), dtype=torch.bool, device=slot.device)
    pi = torch.div(pos, page, rounding_mode="floor")
    page_id = bt.long()[slot.clamp(0, b - 1), pi.clamp(0, maxp - 1)]
    ok = (slot >= 0) & (slot < b) & (pi < maxp) & (page_id >= 0) & (page_id < n_pages)
    place = page_id * page + pos % page
    # the first kept row (0 when none is), kept 1-D: indexing with a 0-d
    # tensor reads it on the host
    first = torch.argmax(ok.to(torch.int32), dim=0, keepdim=True)
    kept = ok.any()
    src = torch.where(ok, rows, first)
    place = torch.where(ok, place, torch.where(kept, place[first], 0))
    return src, place, kept


def write_page_rows(pool: torch.Tensor, t: torch.Tensor, where) -> None:
    """In place: pool (lead, P, page, ...) gets rows t (lead, R, ...) at the
    places :func:`pool_rows` gave (the steps compute them once, before their
    layers launch). The one row writer of the port: every other page write
    goes through it. Fixed shapes, no host sync."""
    src, place, kept = where
    flat = pool.view(pool.shape[0], -1, *pool.shape[3:])  # raises rather than copy
    rows = torch.where(kept, t[:, src].to(pool.dtype), flat[:, place[:1]])
    flat[:, place] = rows


def gather_pages(pool_l: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """One layer's pool (P, page, ...) + block table (B, maxp) -> the dense
    per-slot view (B, maxp*page, ...). Unmapped (-1) entries read page 0;
    callers mask those rows with the per-slot prefix."""
    b, maxp = bt.shape
    pages = pool_l[bt.long().clamp(min=0)]
    return pages.reshape(b, maxp * pool_l.shape[1], *pool_l.shape[2:])


def scatter_rows_pool(pool: torch.Tensor, t: torch.Tensor, bt: torch.Tensor,
                      slot: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """A copy of the single-layer pool ``(P, page, KV, hd)`` with flat rows
    ``t (R, KV, hd)`` scattered in where :func:`pool_rows` puts them."""
    out = pool.clone()
    write_page_rows(out[None], t[None], pool_rows(bt, slot, pos, pool.shape[1], pool.shape[0]))
    return out


def paged_decode_ref(q, kp, vp, kt, vt, bt, pos, *, commit: bool = True):
    """Plain paged decode attention; returns ``(out, kp_new, vp_new)``, or
    ``out`` alone when ``commit=False``."""
    b, sq, h, hd = q.shape
    kv = kt.shape[2]
    g = h // kv
    maxp, page = bt.shape[1], kp.shape[1]
    s_max = maxp * page
    dev = q.device
    pos = pos.long()
    # dense per-slot view (unmapped -> page 0, masked below), then the draft
    # span written in: the view holds exactly the rows a sequential engine's
    # cache would hold at each verified position
    kc, vc = gather_pages(kp, bt), gather_pages(vp, bt)
    rows = pos[:, None] + torch.arange(sq, device=dev)[None, :]
    ok = rows < s_max
    bi = torch.arange(b, device=dev)[:, None].expand(b, sq)
    kc[bi[ok], rows[ok]] = kt[ok].to(kc.dtype)
    vc[bi[ok], rows[ok]] = vt[ok].to(vc.dtype)

    qg = q.reshape(b, sq, kv, g, hd)
    logits_c = torch.einsum("bskgh,btkh->bkgst", qg, kc).to(torch.float32)
    logits_c = logits_c / (hd ** 0.5)
    mask = torch.arange(s_max, device=dev)[None, None, :] < rows[:, :, None]  # (B, sq, S)
    logits_c = torch.where(mask[:, None, None, :, :], logits_c, _NEG)
    logit_s = torch.einsum("bskgh,bskh->bkgs", qg, kt).to(torch.float32)[..., None] / (hd ** 0.5)
    m = torch.maximum(logits_c.amax(dim=-1, keepdim=True), logit_s)
    pc = torch.exp(logits_c - m)
    ps = torch.exp(logit_s - m)
    den = pc.sum(dim=-1, keepdim=True) + ps
    out = torch.einsum("bkgst,btkh->bskgh", (pc / den).to(vc.dtype), vc)
    self_w = (ps / den)[..., 0][..., None].permute(0, 3, 1, 2, 4).to(vt.dtype)
    out = (out + self_w * vt[:, :, :, None, :]).reshape(b, sq, h, hd)
    if not commit:
        return out
    slot_ids = torch.arange(b, device=dev).repeat_interleave(sq)
    flat = rows.reshape(-1)
    kp_new = scatter_rows_pool(kp, kt.reshape(b * sq, kv, hd), bt, slot_ids, flat)
    vp_new = scatter_rows_pool(vp, vt.reshape(b * sq, kv, hd), bt, slot_ids, flat)
    return out, kp_new, vp_new


def paged_decode_kernel(q, kp, vp, kt, vt, bt, pos, *, commit: bool = True):
    """Paged decode attention through the CUDA kernel (the plain version for
    CPU tensors). ``commit=True`` returns ``(out, kp, vp)`` with the rows
    written into the pools in place on the card; ``commit=False`` returns
    ``out`` and leaves the pools untouched."""
    b, sq, h, hd = q.shape
    kv = kt.shape[2]
    maxp, page = bt.shape[1], kp.shape[1]
    validate_paged_decode(b, sq, h, kv, hd, maxp, page, decode_m_max=DECODE_M_MAX)
    if q.device.type == "cpu":
        return paged_decode_ref(q, kp, vp, kt, vt, bt, pos, commit=commit)
    dev = q.device
    for x, n in ((kp, "kp"), (vp, "vp")):  # the commit writes the caller's pools
        device_operand("paged_decode", x, torch.bfloat16, n, dev, in_place=True)
    q_, kt_, vt_ = (device_operand("paged_decode", x, torch.bfloat16, n, dev)
                    for x, n in ((q, "q"), (kt, "kt"), (vt, "vt")))
    bt_, pos_ = (device_operand("paged_decode", x.to(torch.int32), torch.int32, n, dev)
                 for x, n in ((bt, "bt"), (pos, "pos")))
    out = torch.empty((b, sq, h, hd), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(paged_scratch_floats(b, sq, h, kv, hd, maxp, page, PAGED_CHUNK),
                          dtype=torch.float32, device=dev)
    args = [q_.data_ptr(), kp.data_ptr(), vp.data_ptr(), kt_.data_ptr(), vt_.data_ptr(),
            bt_.data_ptr(), pos_.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            b, sq, h, kv, hd, maxp, page, PAGED_CHUNK, float(hd ** -0.5), int(commit)]
    run_kernel("paged_decode_kernel", "paged_attention", "paged_decode", _ARGS, args, dev)
    return (out, kp, vp) if commit else out
