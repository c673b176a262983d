"""Test oracles shared by the port's tests: plain PyTorch forms of the
reference's algorithms where the port computes the same function another
way, so a comparison with the reference run op by op can be bit for bit."""

import torch

from repro_torch.models import common as C


def write_then_attend(p, x, cfg, kc, vc, pos, fuse=True):
    """The reference's dense decode self-attention (``repro/models/encdec.py``
    238-250, ``repro/models/mamba_hybrid.py`` ``_shared_attn`` with a cache):
    this step's row written into a copy of the cache at ``pos``, then
    ``_sdpa`` over ``<= pos``. It takes and returns what the port's
    read-only-cache step ``common.attention_decode_ro`` does: (out, k, v)."""
    b, sq, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = (t.reshape(b, sq, h, hd) for t in C.qkv(p, x, fuse))
    tables = C.rope_tables(C.slot_positions(pos, b, sq), hd, cfg.rope_fraction,
                           cfg.rope_theta)
    q, k = C.apply_rope(q, tables), C.apply_rope(k, tables)
    slots, row = torch.arange(b), pos.long()
    kc, vc = kc.clone(), vc.clone()
    kc[slots, row], vc[slots, row] = k[:, 0], v[:, 0]
    mask = torch.arange(kc.shape[1])[None, None, :] <= pos[:, None, None]
    out = C._sdpa(q, kc, vc, mask)
    return C.linear(p["o"], out.reshape(b, sq, h * hd)), k, v
