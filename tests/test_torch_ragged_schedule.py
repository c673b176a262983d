"""Plain-PyTorch model of the schedule of ``csrc/ragged_attention.cu``, held
to the plain version on the CPU.

The CUDA kernel cannot run here. What makes it right is its schedule:

* each slot's run of rows is cut into tiles of R = ``ATT_QV_MAX // g``
  rows, the tiles enumerated in slot order (``rg_plan_kernel``: a run table
  of first rows, row counts and first tiles, then a search for each tile's
  slot), at most B + ceil(T / R) of them;
* a tile's keys are cut into chunks of ``PAGED_CHUNK`` absolute positions
  and folded in 64-key tiles of absolute positions (online softmax, a tile
  with no valid key for a row skipped), keys below ``ctx`` from the slot's
  pages and the rest from the slot's in-batch rows;
* a row's chunk partials fold in ascending order, the self term last, then
  one rounding to bf16.

The model follows that step for step. A slot's rows from one launch equal
the same rows from two launches with the first part committed into pages
between them (the cut mid-tile, the second run across a chunk boundary);
decode rows keep their bits with or without prompt chunks beside them; the
model agrees with ``ragged_attention_ref`` within the attention tolerance;
and a model whose grid starts at the run's own ``ctx`` fails the two-launch
check. Where a step is the MMA's sum (a tile's scores or P.V), the model
takes it in f64 and rounds once to f32: its bits are not the card's, but
the order of every f32 step around it is the kernel's.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.autotune import PAGED_CHUNK, PAGED_TILE
from repro_torch.kernels.contracts import ATT_QV_MAX, check_ragged_rows
from repro_torch.kernels.paged_attention import scatter_rows_pool
from repro_torch.kernels.ragged_attention import ragged_attention_ref

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # degrade to fixed-seed cases
    from hypothesis_fallback import given, settings, strategies as st

torch.set_num_threads(2)


def tile_map(slot, b, rows):
    """``rg_plan_kernel``'s tile table: the run table (each slot's first
    row and row count from the run boundaries), the tiles' exclusive prefix
    ``tb``, and for each z < B + ceil(T / rows) the slot found by the
    kernel's search (the last slot with ``tb[s] <= z``) with the run's
    first row and the tile's rows ``(slot, start, r0, nr)``, or None past
    the last tile."""
    slot = np.asarray(slot)
    t_n = slot.shape[0]
    st_, end = np.zeros(b + 1, np.int64), np.zeros(b + 1, np.int64)
    for t in range(t_n):
        s = int(slot[t])
        if not 0 <= s < b:
            continue
        if t == 0 or slot[t - 1] != s:
            st_[s] = t
        if t == t_n - 1 or slot[t + 1] != s:
            end[s] = t + 1
    cnt = np.where(end > 0, end - st_, 0)
    tb = np.zeros(b + 1, np.int64)
    for s in range(b):
        tb[s + 1] = tb[s] + -(-int(cnt[s]) // rows)
    out = []
    for z in range(b + -(-t_n // rows)):
        if z >= tb[b]:
            out.append(None)
            continue
        lo, hi = 0, b - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if tb[mid] <= z:
                lo = mid
            else:
                hi = mid - 1
        r0 = int(z - tb[lo]) * rows
        out.append((lo, int(st_[lo]), r0, min(rows, int(cnt[lo]) - r0)))
    return out


def _butterfly_sum(v):
    """A warp's sum of 64 values, lane l holding l and l + 32: their f32 sum,
    then xor butterflies over 16, 8, 4, 2, 1 (lane 0's result)."""
    s = v[..., :32] + v[..., 32:]
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., torch.arange(32) ^ off]
    return s[..., 0]


def _tile_keys(kp, vp, kt, vt, bt_row, ctx, p_end, start, kvh, p0):
    """The tile [p0, p0 + 64) as ``att_load_tile`` stages it: pages below
    ctx, the slot's in-batch rows in [ctx, p_end), zeros (and no key)
    elsewhere."""
    page, maxp = kp.shape[1], bt_row.shape[0]
    p = torch.arange(p0, p0 + PAGED_TILE)
    pi = torch.div(p, page, rounding_mode="floor")
    pg = bt_row.long()[pi.clamp(0, maxp - 1)]
    in_page = (p >= 0) & (p < ctx) & (pi < maxp) & (pg >= 0)
    in_panel = (p >= 0) & (p >= ctx) & (p < p_end)
    k_t, v_t = torch.zeros(PAGED_TILE, kp.shape[-1]), torch.zeros(PAGED_TILE, kp.shape[-1])
    k_t[in_page] = kp[pg[in_page], p[in_page] % page, kvh]
    v_t[in_page] = vp[pg[in_page], p[in_page] % page, kvh]
    k_t[in_panel] = kt[start + p[in_panel] - ctx, kvh]
    v_t[in_panel] = vt[start + p[in_panel] - ctx, kvh]
    return k_t, v_t, in_page | in_panel


def ragged_split_model(q, kp, vp, kt, vt, bt, slot, ctx, *, anchor=None, f32=False):
    """``rg_split_kernel`` + ``rg_combine_kernel``; ``f32`` returns the
    outputs before their one rounding to bf16 (pad rows zero).
    ``anchor(ctx)`` moves the tile and chunk grid (the planted fault: a grid
    anchored at the run's own ``ctx``); None keeps it at absolute
    positions."""
    t_n, h, hd = q.shape
    kv = kt.shape[1]
    g = h // kv
    rows = ATT_QV_MAX // g
    b_n = bt.shape[0]
    scale = torch.tensor(hd ** -0.5)
    kp, vp, kt, vt = (t.float() for t in (kp, vp, kt, vt))
    out = torch.zeros(t_n, h, hd)
    for tile in tile_map(slot, b_n, rows):
        if tile is None:
            continue
        s, start, r0, nr = tile
        c_s = int(ctx[s])
        p_end = c_s + r0 + nr - 1  # keys some row of the tile needs
        off = 0 if anchor is None else anchor(c_s) % PAGED_TILE
        nqv = nr * g
        rows_t = [start + r0 + v // g for v in range(nqv)]
        p_row = torch.tensor([c_s + r0 + v // g for v in range(nqv)])
        for kvh in range(kv):
            qv = torch.stack([q[rows_t[v], kvh * g + v % g].float() for v in range(nqv)])
            parts = []  # per chunk: (m, l, acc) of every vector
            for c0 in range(-off, p_end, PAGED_CHUNK):
                m = torch.full((nqv,), -math.inf)
                l, acc = torch.zeros(nqv), torch.zeros(nqv, hd)
                for p0 in range(c0, min(c0 + PAGED_CHUNK, p_end), PAGED_TILE):
                    k_t, v_t, ok = _tile_keys(kp, vp, kt, vt, bt[s], c_s, p_end, start, kvh, p0)
                    keypos = torch.arange(p0, p0 + PAGED_TILE)
                    valid = ok[None, :] & (keypos[None, :] < p_row[:, None])
                    sc = (qv.double() @ k_t.double().T).float() * scale
                    sc = torch.where(valid, sc, torch.tensor(-math.inf))
                    mt = sc.amax(dim=1)
                    live = mt > -math.inf  # a tile with no valid key is skipped
                    m_new = torch.maximum(m, mt)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    ls = _butterfly_sum(p)
                    ph = p.bfloat16().float()
                    pl = (p - ph).bfloat16().float()
                    part = ((ph + pl).double() @ v_t.double()).float()
                    l = torch.where(live, l * corr + ls, l)
                    acc = torch.where(live[:, None], acc * corr[:, None] + part, acc)
                    m = torch.where(live, m_new, m)
                parts.append((c0, m, l, acc))
            for v in range(nqv):
                t, hh = rows_t[v], v % g
                ks, vs = kt[t, kvh], vt[t, kvh]
                s_self = (q[t, kvh * g + hh].double() @ ks.double()).float() * scale
                m_, l_, a_ = torch.tensor(-math.inf), torch.tensor(0.0), torch.zeros(hd)
                for c0, mc, lc, ac in parts:
                    if c0 >= int(p_row[v]) or mc[v] == -math.inf:
                        continue  # no key of the row in the chunk
                    m_new = torch.maximum(m_, mc[v])
                    ca, cb = torch.exp(m_ - m_new), torch.exp(mc[v] - m_new)
                    l_ = l_ * ca + lc[v] * cb
                    a_ = a_ * ca + ac[v] * cb
                    m_ = m_new
                m_new = torch.maximum(m_, s_self)
                corr, p = torch.exp(m_ - m_new), torch.exp(s_self - m_new)
                lf = l_ * corr + p
                out[t, kvh * g + hh] = (a_ * corr + p * vs) / lf
    return out if f32 else out.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# a batch of slots' runs, assembled from fixed per-slot rows
# ---------------------------------------------------------------------------

H, KV, HD, PAGE, MAXP = 8, 2, 32, 8, 64  # g = 4: R = 8 rows a tile, as llama3-8b


def _world(seed, ctxs, n_rows):
    """Pools, block tables mapping every slot's pages for ``ctx + n_rows``
    positions, and each slot's in-batch rows (q, k, v for positions ctx ..
    ctx + n_rows - 1)."""
    g = torch.Generator().manual_seed(seed)
    b = len(ctxs)
    n_pages = b * MAXP
    kp = torch.randn(n_pages, PAGE, KV, HD, generator=g).bfloat16()
    vp = torch.randn(n_pages, PAGE, KV, HD, generator=g).bfloat16()
    perm = torch.randperm(n_pages, generator=g)
    bt = torch.full((b, MAXP), -1, dtype=torch.int32)
    used = 0
    for i, (c, n) in enumerate(zip(ctxs, n_rows)):
        n_pg = -(-(c + n) // PAGE)
        bt[i, :n_pg] = perm[used:used + n_pg].to(torch.int32)
        used += n_pg
    rows = [tuple(torch.randn(n, hh, HD, generator=g).bfloat16() for hh in (H, KV, KV))
            for n in n_rows]
    return kp, vp, bt, rows


def _batch(world, ctxs, runs, t_n):
    """One launch's arguments: ``runs`` is [(slot, first row of its rows,
    rows)] in row order, pad rows (slot B) after them; a slot's run starts
    at position ctx[slot] + first."""
    kp, vp, bt, rows = world
    b = len(ctxs)
    q, kt, vt = torch.zeros(t_n, H, HD), torch.zeros(t_n, KV, HD), torch.zeros(t_n, KV, HD)
    slot, pos = np.full(t_n, b, np.int32), np.zeros(t_n, np.int32)
    ctx = np.array(ctxs, np.int32)
    r = 0
    for s, first, n in runs:
        q[r:r + n], kt[r:r + n], vt[r:r + n] = (x[first:first + n] for x in rows[s])
        slot[r:r + n] = s
        pos[r:r + n] = ctxs[s] + first + np.arange(n)
        r += n
    for s, first, _ in runs:
        ctx[s] = ctxs[s] + first
    check_ragged_rows(slot, pos, ctx, s_max=MAXP * PAGE)
    return (q.bfloat16(), kp, vp, kt.bfloat16(), vt.bfloat16(), bt, torch.from_numpy(slot),
            torch.from_numpy(pos), torch.from_numpy(ctx))


def _commit(args, n_first, s):
    """The pools after slot s's first ``n_first`` rows of this launch are
    written into their pages."""
    q, kp, vp, kt, vt, bt, slot, pos, ctx = args
    rows = torch.nonzero(slot == s).flatten()[:n_first]
    return (scatter_rows_pool(kp, kt[rows], bt, slot[rows], pos[rows]),
            scatter_rows_pool(vp, vt[rows], bt, slot[rows], pos[rows]))


def _model(args, **kw):
    q, kp, vp, kt, vt, bt, slot, _, ctx = args
    return ragged_split_model(q, kp, vp, kt, vt, bt, slot, ctx, **kw)


# slot 0: a decode row behind 300 keys (two chunks); slot 1: a 100-row chunk
# at positions 200 .. 299, across the first chunk boundary (256); slot 2: a
# cold 20-row chunk; slot 3: a decode row behind 70 keys
CTXS, N_ROWS, T = [300, 200, 0, 70], [1, 100, 20, 1], 128
CUT = 37  # slot 1's first part: ends mid-tile (R = 8); the rest starts at 237


def _one_and_two(anchor=None):
    """Slot 1's rows from one launch and from two launches with its first
    ``CUT`` rows committed into pages between them (f32 outputs)."""
    world = _world(0, CTXS, N_ROWS)
    whole = _batch(world, CTXS, [(0, 0, 1), (1, 0, 100), (2, 0, 20), (3, 0, 1)], T)
    first = _batch(world, CTXS, [(0, 0, 1), (1, 0, CUT), (2, 0, 20), (3, 0, 1)], T)
    kp2, vp2 = _commit(first, CUT, 1)
    world2 = (kp2, vp2) + world[2:]
    second = _batch(world2, CTXS, [(1, CUT, 100 - CUT)], T)
    y1 = _model(whole, anchor=anchor, f32=True)
    ya = _model(first, anchor=anchor, f32=True)
    yb = _model(second, anchor=anchor, f32=True)
    one = y1[1:101]
    two = torch.cat([ya[1:1 + CUT], yb[:100 - CUT]])
    return one, two


def test_ragged_split_one_launch_equals_two():
    """A slot's rows from one launch equal, bit for bit, its rows from two
    launches with the first part committed into pages between them: the cut
    falls mid-tile and the second run straddles a chunk boundary."""
    one, two = _one_and_two()
    assert torch.equal(one, two)


def test_ragged_split_anchored_at_run_ctx_fails_two_launch_check():
    """Tiles and chunks anchored at the run's own ctx (not at absolute
    positions) fold a row's keys in other groups when the prompt is cut
    differently: the two-launch rows' f32 bits differ."""
    one, two = _one_and_two(anchor=lambda ctx: ctx)
    assert int((one != two).sum()) > 0


def test_ragged_split_decode_rows_independent_of_prompt_chunks():
    """Decode rows give the same bits whether they share the launch with
    prompt chunks or not (and wherever they sit in the batch)."""
    world = _world(1, CTXS, N_ROWS)
    mixed = _batch(world, CTXS, [(1, 0, 100), (0, 0, 1), (2, 0, 20), (3, 0, 1)], T)
    alone = _batch(world, CTXS, [(3, 0, 1), (0, 0, 1)], 8)
    y_m = _model(mixed, f32=True)
    y_a = _model(alone, f32=True)
    assert torch.equal(y_m[100], y_a[1])  # slot 0
    assert torch.equal(y_m[121], y_a[0])  # slot 3


def test_ragged_split_matches_plain_within_tolerance():
    """The split-KV fold agrees with ``ragged_attention_ref`` within the
    attention tolerance: atol 0.03 / rtol 0.05 against the bf16 plain
    version, and per (row, head) rel <= 0.005 against the plain version run
    in f32, the limits ``chip_smoke.py`` holds the kernel to; pad rows are
    zero."""
    world = _world(2, CTXS, N_ROWS)
    args = _batch(world, CTXS, [(0, 0, 1), (1, 0, 100), (2, 0, 20), (3, 0, 1)], T)
    y = _model(args)
    y_p = ragged_attention_ref(*args)
    q, kp, vp, kt, vt, bt, slot, pos, ctx = args
    y32 = ragged_attention_ref(q.float(), kp.float(), vp.float(), kt.float(), vt.float(), bt,
                               slot, pos, ctx)
    real = slot < len(CTXS)
    assert torch.allclose(y[real].float(), y_p[real].float(), atol=0.03, rtol=0.05)
    rel = (y[real].float() - y32[real]).norm(dim=-1) / y32[real].norm(dim=-1)
    assert rel.max().item() <= 0.005
    assert not y[~real].float().any()


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 1 << 30), st.integers(1, 9), st.integers(1, 70),
       st.sampled_from([1, 2, 4, 8, 3, 32]))
def test_ragged_tile_map_covers_each_row_once(seed, b, t_n, g):
    """For random row layouts (slots in any order, runs of any length, pad
    rows anywhere), the z -> (slot, tile) mapping answers each real row
    exactly once and every tile lies within the grid's B + ceil(T / R)."""
    rng = np.random.default_rng(seed)
    rows = ATT_QV_MAX // g
    slots = list(rng.permutation(b)[:rng.integers(0, b + 1)])
    pieces = [[s] * int(rng.integers(1, t_n + 1)) for s in slots]
    pieces += [[b]] * int(rng.integers(0, t_n + 1))  # pad rows
    order = rng.permutation(len(pieces))
    slot = [x for i in order for x in pieces[i]][:t_n]
    slot += [b] * (t_n - len(slot))
    slot = np.asarray(slot)
    seen = np.zeros(t_n, np.int64)
    for tile in tile_map(slot, b, rows):
        if tile is None:
            continue
        s, start, r0, nr = tile
        assert 1 <= nr <= rows
        rows_t = np.arange(start + r0, start + r0 + nr)
        assert (slot[rows_t] == s).all()
        seen[rows_t] += 1
    assert (seen == (slot < b)).all()


@pytest.mark.parametrize("b", [1, 3, 8])
def test_ragged_tile_map_enumerates_tiles_in_slot_order(b):
    """Tiles are enumerated in slot order, whatever the row order: slot s's
    tiles come before slot s + 1's, each slot's in run order."""
    rng = np.random.default_rng(b)
    lens = rng.integers(1, 30, size=b)
    order = rng.permutation(b)
    slot = np.concatenate([np.full(lens[s], s) for s in order] + [np.full(5, b)])
    tiles = [t for t in tile_map(slot, b, 8) if t is not None]
    assert [t[0] for t in tiles] == sorted(t[0] for t in tiles)
    assert len(tiles) == sum(-(-int(n) // 8) for n in lens) <= b + -(-len(slot) // 8)
