"""Plain-PyTorch models of the schedules of the two decode-step kernels,
``csrc/w4a16_gemm.cu`` (decode regime) and ``csrc/paged_attention.cu``, held
to the plain versions on the CPU.

The CUDA kernels cannot run here. What makes them right is their schedule:

* ``w4a16_gemm``: below ``W4A16_DECODE_COL_N`` columns a block of 16
  columns splits K over its warps, warp w taking groups w, w + warps, ...;
  each group's f32 term is parked and one thread per output adds a round's
  terms in ascending group order. Wider N takes blocks of 64 columns, one
  warp per 16 (XOR-swizzled shared rows), each chain in one thread. The
  packed rows reach the MMA through ``ldmatrix.trans`` as byte pairs and are
  dequantized in registers (a 2^23 float bias for the sign, one multiply by
  the scale) into an even-column and an odd-column n8 tile. The model
  follows both step for step and is ``torch.equal`` to ``ref.w4a16_gemm_ref``;
  the same terms summed pairwise within a round fail.
* ``paged_decode_kernel``: each slot's keys are cut into chunks of
  ``PAGED_CHUNK`` absolute positions and folded in 64-key tiles of
  absolute positions (online softmax, a tile with no valid key skipped);
  the chunks' partials fold in ascending order, the self term last. A
  stacked sq = 4 model's rows equal sequential sq = 1 models with the
  drafts committed between, also when the stack straddles a chunk
  boundary, and agree with ``paged_decode_ref`` within the attention
  tolerance; a model whose tiles start at the launch's own position fails
  the stacked check.

Where a step is the MMA's sum (a group's dot, a tile's scores or P.V), the
model takes it in f64 and rounds once to f32: its bits are not the card's,
but the order of every f32 step around it is the kernel's.
"""

import math

import pytest
import torch

from repro_torch.kernels import contracts as C
from repro_torch.kernels import ref as T
from repro_torch.kernels.autotune import PAGED_CHUNK, PAGED_TILE, W4A16_DECODE_N
from repro_torch.kernels.paged_attention import paged_decode_ref, scatter_rows_pool

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# w4a16_gemm, decode regime
# ---------------------------------------------------------------------------


def _w4a16_pack(seed, k, n, group):
    g = torch.Generator().manual_seed(seed)
    wq, ws = T.quantize_rows_ref(torch.randn(k, n, generator=g) * 0.05, group, 4)
    return T.pack_rows_groupsplit(wq, group), ws


def _ldsm_x1_trans(tile):
    """``ldmatrix.x1.trans`` of an 8 x 16-byte shared tile (packed rows x
    columns, uint8): lane (g, t) receives the b16 elements (2t, g) and (2t +
    1, g), i.e. the bytes (2t, 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g +
    1) from the low byte up. Returns the 32 lanes' words as int64."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    b = [tile[2 * t, 2 * g], tile[2 * t, 2 * g + 1], tile[2 * t + 1, 2 * g],
         tile[2 * t + 1, 2 * g + 1]]
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


def _nib(v):
    """``w4_nib``: the float bits 0x4B000000 | (nibble ^ 8), i.e. 2^23 + q + 8,
    less 2^23 + 8 in f32."""
    bits = ((v & 0xF) ^ 0x4B000008).to(torch.int32)
    return bits.view(torch.float32) - torch.tensor(8388616.0)


def _deq(r, sh, se, so):
    """``w4_deq``: the bf16 B-fragment halves (k = 2t, 2t + 1) of the even
    column (bytes 0, 2) and the odd one (bytes 1, 3)."""
    v = r >> sh
    e = [(_nib(v) * se).bfloat16(), (_nib(v >> 16) * se).bfloat16()]
    o = [(_nib(v >> 8) * so).bfloat16(), (_nib(v >> 24) * so).bfloat16()]
    return e, o


def _group_weights(wp, ws, g, n0, group):
    """One group's dequantized (G, 16) bf16 weights of columns n0 .. n0 + 15
    as the kernel's B fragments carry them: per k8 block of rows, one
    ``ldmatrix.trans`` of the packed rows (k mod G/2) + [0, 8) and the low
    (k < G/2) or high nibbles, each lane's halves placed at their (k, col)."""
    half = group // 2
    raw = (wp[g * half:(g + 1) * half, n0:n0 + 16].to(torch.int64) & 0xFF)
    s = ws[g, n0:n0 + 16]
    out = torch.zeros(group, 16, dtype=torch.bfloat16)
    lane = torch.arange(32)
    gid, tig = lane // 4, lane % 4
    for k8 in range(0, group, 8):
        hi = int(k8 >= half)
        regs = _ldsm_x1_trans(raw[k8 - hi * half:k8 - hi * half + 8])
        e, o = _deq(regs, 4 * hi, s[2 * gid], s[2 * gid + 1])
        for j in range(2):
            out[k8 + 2 * tig + j, 2 * gid] = e[j]
            out[k8 + 2 * tig + j, 2 * gid + 1] = o[j]
    return out


def _ascending(acc, terms):
    for p in terms:
        acc = acc + p
    return acc


def _pairwise(acc, terms):
    """The wrong order the test must catch: a round's terms in a tree."""
    terms = list(terms)
    while len(terms) > 1:
        terms = [terms[i] + terms[i + 1] if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    return acc + terms[0]


def w4a16_decode_model(x, wp, ws, group, combine=_ascending):
    """``w4a16_decode_kernel``: blocks of 16 columns, K split over the
    block's warps in rounds; per group the even / odd n8 tiles' terms (MMA
    column c is column 2c, resp. 2c + 1), parked at column 4 tig + 2 (e & 1) +
    t; one thread per output adds each round's parked terms in warp order.
    Returns the f32 sums, before the kernel's one rounding to bf16."""
    m, k = x.shape
    n = wp.shape[1]
    warps, _ = C.w4a16_launch(m, n, group)
    n_groups = k // group
    xb = x.to(torch.bfloat16).double()
    out = torch.zeros(m, n)
    for n0 in range(0, n, W4A16_DECODE_N):
        acc = torch.zeros(m, W4A16_DECODE_N)
        for r in range(math.ceil(n_groups / warps)):
            parked = []
            for w in range(warps):
                g = r * warps + w
                if g >= n_groups:
                    break
                wg = _group_weights(wp, ws, g, n0, group).double()
                xg = xb[:, g * group:(g + 1) * group]
                tiles = [(xg @ wg[:, t::2]).float() for t in (0, 1)]  # (M, 8) each
                pk = torch.zeros(m, W4A16_DECODE_N)
                for t in (0, 1):
                    for c in range(8):  # MMA column c = 2 tig + (e & 1)
                        tig, e1 = c // 2, c % 2
                        pk[:, 4 * tig + 2 * e1 + t] = tiles[t][:, c]
                parked.append(pk)
            acc = combine(acc, parked)
        out[:, n0:n0 + W4A16_DECODE_N] = acc
    return out


def _swizzled_slice(raw64, warp):
    """The 64-column block's packed rows as ``w4a16_col_kernel`` stores them
    (16-byte chunk c of row j at chunk c ^ ((j >> 1) & 3)) and reads them
    back for warp ``warp``'s 16 columns."""
    rows = raw64.shape[0]
    smem = torch.zeros(rows, 4, 16, dtype=raw64.dtype)
    for j in range(rows):
        for c in range(4):
            smem[j, c ^ ((j >> 1) & 3)] = raw64[j, 16 * c:16 * c + 16]
    return torch.stack([smem[j, warp ^ ((j >> 1) & 3)] for j in range(rows)])


def w4a16_col_model(x, wp, ws, group):
    """``w4a16_col_kernel`` (N >= ``W4A16_DECODE_COL_N``): blocks of 64
    columns through the swizzled shared rows, warp w the 16 columns n0 + 16
    w, each output's f32 chain in one thread over all groups ascending."""
    m, k = x.shape
    n = wp.shape[1]
    half = group // 2
    xb = x.to(torch.bfloat16).double()
    out = torch.zeros(m, n)
    for n0 in range(0, n, 64):
        for warp in range(4):
            c0 = n0 + 16 * warp
            acc = torch.zeros(m, 16)
            for g in range(k // group):
                raw64 = wp[g * half:(g + 1) * half, n0:n0 + 64]
                sl = wp.clone()
                sl[g * half:(g + 1) * half, c0:c0 + 16] = _swizzled_slice(raw64, warp)
                wg = _group_weights(sl, ws, g, c0, group).double()
                xg = xb[:, g * group:(g + 1) * group]
                acc = acc + torch.stack([(xg @ wg[:, t::2]).float() for t in (0, 1)],
                                        dim=2).reshape(m, 16)
            out[:, c0:c0 + 16] = acc
    return out


def test_w4a16_register_dequant_is_exact():
    """Every nibble value at scales of every magnitude dequantizes through
    the bias trick and the byte-pair fragments to exactly the plain
    version's ``bf16((float)q * s)``."""
    group, n = 32, 16
    q = torch.arange(group * n).reshape(group, n) % 16 - 8  # every nibble, every place
    g = torch.Generator().manual_seed(3)
    ws = (torch.rand(1, n, generator=g) + 0.5) * torch.logspace(-30, 30, n)[None]
    wp = T.pack_rows_groupsplit(q.to(torch.int8), group)
    want = (q.float() * ws).to(torch.bfloat16)
    assert torch.equal(_group_weights(wp, ws, 0, 0, group), want)


@pytest.mark.parametrize("k,n,group", [(512, 256, 128), (512, 256, 32), (256, 2304, 16)])
@pytest.mark.parametrize("m", [1, 8, 32])
def test_w4a16_decode_schedule_equals_plain(m, k, n, group):
    """d_model-256-scale shapes (down: K = d_ff 512 -> 256; a wide N past
    the 8-warp threshold; the smallest group, whose one k16 step takes low
    and high nibbles): the split-K schedule with its ordered combine is
    ``torch.equal`` to the plain version at M in {1, 8, 32}, in f32 before
    the one rounding and in bf16 after it."""
    wp, ws = _w4a16_pack(k + n + group, k, n, group)
    x = (torch.randn(m, k, generator=torch.Generator().manual_seed(m)) * 2).bfloat16()
    y32 = w4a16_decode_model(x, wp, ws, group)
    assert torch.equal(y32, T.w4a16_gemm_f32(x, wp, ws, group))
    assert torch.equal(y32.to(torch.bfloat16), T.w4a16_gemm_ref(x, wp, ws, group))


@pytest.mark.parametrize("m", [1, 8, 32])
def test_w4a16_col_schedule_equals_plain(m):
    """The wide-N schedule (64-column blocks, swizzled shared rows, one
    thread's chain over all groups) is ``torch.equal`` to the plain version
    in f32 and in bf16 at M in {1, 8, 32}."""
    from repro_torch.kernels.autotune import W4A16_DECODE_COL_N

    k, n, group = 256, W4A16_DECODE_COL_N, 64
    assert C.w4a16_launch(m, n, group)[0] == 4  # the column-split launch
    wp, ws = _w4a16_pack(m + 7, k, n, group)
    x = (torch.randn(m, k, generator=torch.Generator().manual_seed(m)) * 2).bfloat16()
    cols = slice(0, 256)  # the model is slow: four blocks of the 128 are enough
    y32 = w4a16_col_model(x, wp[:, cols].contiguous(), ws[:, cols].contiguous(), group)
    want = T.w4a16_gemm_f32(x, wp, ws, group)[:, cols]
    assert torch.equal(y32, want)
    assert torch.equal(y32.to(torch.bfloat16), T.w4a16_gemm_ref(x, wp, ws, group)[:, cols])


def test_w4a16_pairwise_round_fails():
    """The same terms added pairwise within a round (an f32 tree) give other
    f32 bits: the ordered combine is what keeps the plain version's bits."""
    k, n, group = 512, 256, 32  # 16 groups, 8 warps: rounds of 8 terms
    wp, ws = _w4a16_pack(9, k, n, group)
    x = (torch.randn(8, k, generator=torch.Generator().manual_seed(1)) * 2).bfloat16()
    y = T.w4a16_gemm_f32(x, wp, ws, group)
    assert torch.equal(w4a16_decode_model(x, wp, ws, group), y)
    bad = w4a16_decode_model(x, wp, ws, group, combine=_pairwise)
    assert int((bad != y).sum()) > 0


# ---------------------------------------------------------------------------
# paged_decode_kernel: split-KV fold
# ---------------------------------------------------------------------------


def _butterfly_sum(v):
    """A warp's sum of 64 values, lane l holding l and l + 32: their f32 sum,
    then xor butterflies over 16, 8, 4, 2, 1 (lane 0's result)."""
    s = v[..., :32] + v[..., 32:]
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., torch.arange(32) ^ off]
    return s[..., 0]


def _keys(kp, vp, kt, vt, bt_row, ctx, p_end, b, kvh, p0):
    """The tile [p0, p0 + 64) as ``pd_load_tile`` stages it: pages below
    ctx, the draft panel in [ctx, p_end), zeros (and no key) elsewhere."""
    page, maxp = kp.shape[1], bt_row.shape[0]
    hd = kp.shape[-1]
    k_t, v_t = torch.zeros(PAGED_TILE, hd), torch.zeros(PAGED_TILE, hd)
    ok = torch.zeros(PAGED_TILE, dtype=torch.bool)
    for t in range(PAGED_TILE):
        p = p0 + t
        if p < 0:
            continue
        if p < ctx:
            pi = p // page
            pg = int(bt_row[pi]) if pi < maxp else -1
            if pg >= 0:
                k_t[t], v_t[t], ok[t] = kp[pg, p % page, kvh], vp[pg, p % page, kvh], True
        elif p < p_end:
            k_t[t], v_t[t], ok[t] = kt[b, p - ctx, kvh], vt[b, p - ctx, kvh], True
    return k_t, v_t, ok


def paged_split_model(q, kp, vp, kt, vt, bt, pos, *, anchor=None, f32=False):
    """``pd_split_kernel`` + ``pd_combine_kernel``; ``f32`` returns the
    outputs before their one rounding to bf16. ``anchor(ctx)`` moves the
    tile and chunk grid (the planted fault: a grid anchored at the launch's
    own position); None keeps it at absolute positions."""
    b_n, sq, h, hd = q.shape
    kv = kt.shape[2]
    g = h // kv
    nqv = sq * g
    maxp, page = bt.shape[1], kp.shape[1]
    s_max = maxp * page
    scale = torch.tensor(hd ** -0.5)
    kp, vp, kt, vt = (t.float() for t in (kp, vp, kt, vt))
    out = torch.zeros(b_n, sq, h, hd)
    for b in range(b_n):
        ctx = int(pos[b])
        p_end = min(ctx + sq - 1, s_max)
        off = 0 if anchor is None else anchor(ctx) % PAGED_TILE
        for kvh in range(kv):
            qv = torch.stack([q[b, v // g, kvh * g + v % g].float() for v in range(nqv)])
            p_row = torch.tensor([ctx + v // g for v in range(nqv)])
            parts = []  # per chunk: (m, l, acc) of every vector
            for c0 in range(-off, p_end, PAGED_CHUNK):
                m = torch.full((nqv,), -math.inf)
                l, acc = torch.zeros(nqv), torch.zeros(nqv, hd)
                for p0 in range(c0, min(c0 + PAGED_CHUNK, p_end), PAGED_TILE):
                    k_t, v_t, ok = _keys(kp, vp, kt, vt, bt[b], ctx, p_end, b, kvh, p0)
                    keypos = torch.arange(p0, p0 + PAGED_TILE)
                    valid = ok[None, :] & (keypos[None, :] < p_row[:, None])
                    s = (qv.double() @ k_t.double().T).float() * scale
                    s = torch.where(valid, s, torch.tensor(-math.inf))
                    mt = s.amax(dim=1)
                    live = mt > -math.inf  # a tile with no valid key is skipped
                    m_new = torch.maximum(m, mt)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    ls = _butterfly_sum(p)
                    ph = p.bfloat16().float()
                    pl = (p - ph).bfloat16().float()
                    part = ((ph + pl).double() @ v_t.double()).float()
                    l = torch.where(live, l * corr + ls, l)
                    acc = torch.where(live[:, None], acc * corr[:, None] + part, acc)
                    m = torch.where(live, m_new, m)
                parts.append((c0, m, l, acc))
            for v in range(nqv):
                r, hh = v // g, v % g
                ks, vs = kt[b, r, kvh], vt[b, r, kvh]
                s_self = (q[b, r, kvh * g + hh].double() @ ks.double()).float() * scale
                m_, l_, a_ = torch.tensor(-math.inf), torch.tensor(0.0), torch.zeros(hd)
                for c0, mc, lc, ac in parts:
                    if c0 >= min(ctx + r, s_max) or mc[v] == -math.inf:
                        continue  # no key of the row in the chunk
                    m_new = torch.maximum(m_, mc[v])
                    ca, cb = torch.exp(m_ - m_new), torch.exp(mc[v] - m_new)
                    l_ = l_ * ca + lc[v] * cb
                    a_ = a_ * ca + ac[v] * cb
                    m_ = m_new
                m_new = torch.maximum(m_, s_self)
                corr, p = torch.exp(m_ - m_new), torch.exp(s_self - m_new)
                lf = l_ * corr + p
                out[b, r, kvh * g + hh] = (a_ * corr + p * vs) / lf
    return out if f32 else out.to(torch.bfloat16)


def _paged_case(seed, lens, sq=4, page=8, maxp=80, h=4, kv=2, hd=32):
    """Pools and block tables for slots of ``lens`` committed keys (0: idle,
    no pages) with room for ``sq`` draft rows, pages from a shuffled pool."""
    g = torch.Generator().manual_seed(seed)
    b = len(lens)
    n_pages = b * maxp
    kp = torch.randn(n_pages, page, kv, hd, generator=g).bfloat16()
    vp = torch.randn(n_pages, page, kv, hd, generator=g).bfloat16()
    perm = torch.randperm(n_pages, generator=g)
    bt = torch.full((b, maxp), -1, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens):
        if n:
            n_pg = (n + sq - 1) // page + 1
            bt[i, :n_pg] = perm[used:used + n_pg].to(torch.int32)
            used += n_pg
    q = torch.randn(b, sq, h, hd, generator=g).bfloat16()
    kt = torch.randn(b, sq, kv, hd, generator=g).bfloat16()
    vt = torch.randn(b, sq, kv, hd, generator=g).bfloat16()
    return q, kp, vp, kt, vt, bt, torch.tensor(lens, dtype=torch.int32)


# slot 1's four rows straddle the first chunk boundary, slot 2's the second
# tile's; slot 3 idle
LENS = (130, PAGED_CHUNK - 2, PAGED_TILE * 5 - 1, 0)


def _sequential(model, q, kp, vp, kt, vt, bt, pos, **kw):
    """Four sq = 1 launches at pos + i, each draft committed into its page
    before the next."""
    b, sq = q.shape[:2]
    outs = []
    for i in range(sq):
        outs.append(model(q[:, i:i + 1], kp, vp, kt[:, i:i + 1], vt[:, i:i + 1], bt, pos + i, **kw))
        slots = torch.arange(b)
        kp = scatter_rows_pool(kp, kt[:, i], bt, slots, pos + i)
        vp = scatter_rows_pool(vp, vt[:, i], bt, slots, pos + i)
    return torch.cat(outs, dim=1)


def test_paged_split_stacked_equals_sequential():
    """A stacked sq = 4 launch's rows equal four sequential one-row launches
    bit for bit, the drafts committed between, including stacks that
    straddle a chunk boundary and a tile boundary (the idle slot's drafts
    commit nowhere, so it is left out)."""
    case = _paged_case(0, LENS)
    stacked = paged_split_model(*case, f32=True)
    seq = _sequential(paged_split_model, *case, f32=True)
    mapped = case[-1] > 0
    assert torch.equal(stacked[mapped], seq[mapped])


def test_paged_split_anchored_at_launch_fails_stacked_check():
    """Tiles and chunks anchored at the launch's own position (not at
    absolute positions) fold a row's keys in other groups in a stacked
    launch than in a one-row launch: its rows' f32 bits differ."""
    case = _paged_case(0, LENS)
    stacked = paged_split_model(*case, anchor=lambda ctx: ctx, f32=True)
    seq = _sequential(paged_split_model, *case, anchor=lambda ctx: ctx, f32=True)
    mapped = case[-1] > 0
    assert int((stacked[mapped] != seq[mapped]).sum()) > 0


@pytest.mark.parametrize("sq", [1, 4])
def test_paged_split_matches_plain_within_tolerance(sq):
    """The split-KV fold agrees with ``paged_decode_ref`` within the
    attention tolerance: atol 0.03 / rtol 0.05 against the bf16 plain
    version, and per (row, head) rel <= 0.005 against the plain version run
    in f32, the limits ``chip_smoke.py`` holds the kernel to."""
    case = _paged_case(1, LENS, sq=sq)
    y = paged_split_model(*case)
    y_p = paged_decode_ref(*case, commit=False)
    q, kp, vp, kt, vt, bt, pos = case
    y32 = paged_decode_ref(q.float(), kp.float(), vp.float(), kt.float(), vt.float(), bt, pos,
                           commit=False)
    assert torch.allclose(y.float(), y_p.float(), atol=0.03, rtol=0.05)
    rel = (y.float() - y32).norm(dim=-1) / y32.norm(dim=-1)
    assert rel.max().item() <= 0.005
