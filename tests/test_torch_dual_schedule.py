"""Plain-PyTorch models of the Hopper dual kernels' operation order, held
bit for bit to the plain versions (``ref.dual_gemm_ref`` /
``ref.dual_gemm_group_ref``) on the CPU.

The CUDA kernels (``csrc/twinquant_dual_gemv.cu``, ``csrc/twinquant_dual_gemm.cu``)
cannot run here. What makes them bit-exact is their schedule: which tiles
they cut, how K is split across warps or blocks, the per-group f32 terms and
the order in which one thread adds them, how H's per-group terms are summed
before it is requantized, and the zero-filled edges of masked tiles. Each
model below follows one kernel's schedule step for step, including the MMA's
16 x nibble bytes and the bias trick that turns its int32 sum into
``(float)dot`` without a conversion. A model with one step in another order
(H's terms summed pairwise) is shown to fail.
"""

import pytest
import torch

from repro_torch.core.quantization import qmax_for_bits
from repro_torch.kernels import ref as T
from repro_torch.kernels.autotune import (GEMM_SPLIT_M, GEMM_SPLIT_TILE, GEMM_TEAMS, GEMM_TILE,
                                          GEMV_TILE_N, GEMV_WARPS)

torch.set_num_threads(2)

DOT_BIAS = 0x49400000  # TQ_DOT_BIAS: the bits of 1.5 * 2**19, ULP 1/16
DOT_BASE = torch.tensor(786432.0)


def _pack(seed, k, n, r, a_bits=4):
    g = torch.Generator().manual_seed(seed)
    return T.pack_twinquant_weights(torch.randn(k, r, generator=g) * 0.1,
                                    torch.randn(r, n, generator=g) * 0.1,
                                    torch.randn(k, n, generator=g) * 0.05, a_bits=a_bits)


def _packs(name, a_bits):
    """d_model-256 packs (the quantized test model of the JAX package:
    d_model 256, 4 query / 2 KV heads of 64, d_ff 512, rank 32): the fused
    qkv group, the single down pack, and groups with the shapes the kernels
    mask (odd ranks for the GEMV; segments ending mid-tile for the GEMM)."""
    if name == "qkv":
        ws = [_pack(10 + j, 256, n, 32, a_bits) for j, n in enumerate((256, 128, 128))]
        return T.fuse_twinquant_weights(ws)
    if name == "down":
        return T.as_group(_pack(20, 512, 256, 32, a_bits))
    if name == "odd_gemv":
        return T.fuse_twinquant_weights([_pack(30 + j, 512, n, r, a_bits) for j, (n, r) in
                                         enumerate(zip((256, 128, 96), (64, 30, 6)))])
    return T.fuse_twinquant_weights([_pack(40 + j, 512, n, r, a_bits) for j, (n, r) in
                                     enumerate(zip((192, 64, 320), (64, 32, 128)))])


def _x(m, k, seed=0):
    return (torch.randn(m, k, generator=torch.Generator().manual_seed(seed)) * 2).bfloat16()


# ---------------------------------------------------------------------------
# the kernels' arithmetic pieces
# ---------------------------------------------------------------------------


def _dot(a, w):
    """(float)dot of an int8 A (rows, k) and int4 W (k, cols) as the kernels
    take it: the MMA sums bytes of 16 x each nibble into an accumulator that
    starts at DOT_BIAS; its bits as a float, less 1.5 * 2**19, are the dot."""
    d = DOT_BIAS + a.to(torch.int64) @ (16 * w.to(torch.int64))
    return d.to(torch.int32).view(torch.float32) - DOT_BASE


def _term(a, sa, w, sw):
    """One group's f32 term ((float)dot * s_a) * s_w, uncontracted."""
    return (_dot(a, w) * sa) * sw


def _ascending(terms):
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


def _pairwise(terms):
    """The wrong order the test must catch: a tree of pairwise sums."""
    terms = list(terms)
    while len(terms) > 1:
        terms = [terms[i] + terms[i + 1] if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    return terms[0]


def _requant(h, gw):
    """``tq_requant_h``: each segment's H columns in its own rank groups."""
    qmax = qmax_for_bits(gw.a_bits)
    m = h.shape[0]
    hq = torch.zeros(h.shape, dtype=torch.int8)
    hs = []
    for ro, rj, gr in zip(gw.r_offsets, gw.seg_r, gw.rgroups):
        hg = h[:, ro:ro + rj].reshape(m, rj // gr, gr)
        amax = hg.abs().amax(dim=2)
        s = torch.where(amax > 0, amax / torch.full_like(amax, qmax), torch.ones_like(amax))
        q = torch.clamp(torch.round(hg / s[:, :, None]), -qmax, qmax)
        hq[:, ro:ro + rj] = q.reshape(m, rj).to(torch.int8)
        hs.append(s)
    return hq, torch.cat(hs, dim=1)


class _Tasks:
    """The task list of an output column tile: the K groups of (Xq, xs) x
    (W, ws), then, for the main pass, the owning segment's V groups of (Hq,
    hs) x (Vq, vs). ``term(t, rows, cols)`` is task t's f32 terms for those
    rows and columns, rows past M and columns past the segment zero-filled
    (as the kernels' cp.async zero fill)."""

    def __init__(self, gw, xq, xs, w, ws, n0, ncols, hq=None, hs=None):
        G = gw.group
        self.items = [(xq[:, g * G:(g + 1) * G], xs[:, g:g + 1],
                       w[g * G:(g + 1) * G, n0:n0 + ncols], ws[g:g + 1, n0:n0 + ncols])
                      for g in range(xq.shape[1] // G)]
        if hq is not None:
            j = max(i for i, no in enumerate(gw.n_offsets) if no <= n0)
            no, ro, rj, gr = gw.n_offsets[j], gw.r_offsets[j], gw.seg_r[j], gw.rgroups[j]
            hs_off = sum(r // g for r, g in zip(gw.seg_r[:j], gw.rgroups[:j]))
            vq = T.unpack_rows_groupsplit(gw.vps[j], gr)
            c = slice(n0 - no, n0 - no + ncols)
            self.items += [(hq[:, ro + v * gr:ro + (v + 1) * gr],
                            hs[:, hs_off + v:hs_off + v + 1],
                            vq[v * gr:(v + 1) * gr, c], gw.vss[j][v:v + 1, c])
                           for v in range(rj // gr)]

    def __len__(self):
        return len(self.items)

    def term(self, t, m0, bm, bn):
        a, sa, w, sw = self.items[t]
        rows = a[m0:m0 + bm]
        a_t = torch.zeros((bm, a.shape[1]), dtype=a.dtype)
        a_t[:rows.shape[0]] = rows
        sa_t = torch.zeros((bm, 1))
        sa_t[:rows.shape[0]] = sa[m0:m0 + bm]
        w_t = torch.zeros((w.shape[0], bn), dtype=w.dtype)
        w_t[:, :w.shape[1]] = w
        sw_t = torch.zeros((1, bn))
        sw_t[:, :w.shape[1]] = sw
        return _term(a_t, sa_t, w_t, sw_t)


def _col_tiles(gw, bn, segmented=True):
    """(n0, ncols) of each column tile: per segment, the last one masked."""
    spans = zip(gw.n_offsets, gw.seg_n) if segmented else [(0, gw.rank)]
    return [(no + c, min(bn, nj - c)) for no, nj in spans for c in range(0, nj, bn)]


# ---------------------------------------------------------------------------
# the GEMV (M <= 8): csrc/twinquant_dual_gemv.cu
# ---------------------------------------------------------------------------


def gemv_model(x, gw, h_sum=_ascending):
    m, k = x.shape
    G, R = gw.group, gw.rank
    xq, xs = T.quantize_act_ref(x, G, gw.a_bits)
    uq = T.unpack_rows_groupsplit(gw.up, G)
    rq = T.unpack_rows_groupsplit(gw.rp, G)
    # launch 1 (tq_gemv_h): K split across blocks, one warp per (group, 16
    # columns of U), columns past R masked; every group's terms to memory
    nk = k // G
    terms = torch.zeros(nk, m, R)
    for n0, nc in _col_tiles(gw, GEMV_TILE_N, segmented=False):
        tasks = _Tasks(gw, xq, xs, uq, gw.us, n0, nc)
        for g in range(nk):
            terms[g, :, n0:n0 + nc] = tasks.term(g, 0, m, GEMV_TILE_N)[:, :nc]
    # launch 2 (tq_requant_h): one thread per H column adds its terms
    hq, hs = _requant(h_sum(terms), gw)
    # launch 3 (tq_gemv_main): a block per 16 columns; warp w takes tasks w,
    # w + WARPS, ...; per round one thread per output adds the round's terms
    # in task order
    out = torch.zeros(m, gw.ndim_out)
    for n0, nc in _col_tiles(gw, GEMV_TILE_N):
        tasks = _Tasks(gw, xq, xs, rq, gw.rs, n0, nc, hq, hs)
        acc = torch.zeros(m, GEMV_TILE_N)
        for r0 in range(0, len(tasks), GEMV_WARPS):
            parked = [tasks.term(t, 0, m, GEMV_TILE_N)
                      for t in range(r0, min(r0 + GEMV_WARPS, len(tasks)))]
            for p in parked:
                acc = acc + p
        out[:, n0:n0 + nc] = acc[:, :nc]
    return out.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the GEMM (M > 8): csrc/twinquant_dual_gemm.cu
# ---------------------------------------------------------------------------


def _split_pass(tasks, m, bm, bn):
    """``tq_gemm_split`` on one column tile: row tiles of bm; GEMM_TEAMS
    one-warp teams take tasks round-robin, park their terms, and one thread
    per output adds each round's terms in task order."""
    out = torch.zeros(m, bn)
    for m0 in range(0, m, bm):
        acc = torch.zeros(bm, bn)
        for r0 in range(0, len(tasks), GEMM_TEAMS):
            parked = [tasks.term(t, m0, bm, bn)
                      for t in range(r0, min(r0 + GEMM_TEAMS, len(tasks)))]
            for p in parked:
                acc = acc + p
        out[m0:m0 + bm] = acc[:min(bm, m - m0)]
    return out


def _tile_pass(tasks, m, bm, bn):
    """``tq_gemm_tile`` on one column tile: row tiles of bm, every thread's
    chain over all tasks in order."""
    out = torch.zeros(m, bn)
    for m0 in range(0, m, bm):
        acc = torch.zeros(bm, bn)
        for t in range(len(tasks)):
            acc = acc + tasks.term(t, m0, bm, bn)
        out[m0:m0 + bm] = acc[:min(bm, m - m0)]
    return out


def gemm_model(x, gw):
    m, k = x.shape
    G, R = gw.group, gw.rank
    xq, xs = T.quantize_act_ref(x, G, gw.a_bits)  # launch 1 (tq_quantize_act)
    uq = T.unpack_rows_groupsplit(gw.up, G)
    rq = T.unpack_rows_groupsplit(gw.rp, G)
    # launch 2: H through the split kernel (16 x 32 tiles over the stacked U)
    sm, sn = GEMM_SPLIT_TILE
    h = torch.zeros(m, R)
    for n0, nc in _col_tiles(gw, sn, segmented=False):
        h[:, n0:n0 + nc] = _split_pass(_Tasks(gw, xq, xs, uq, gw.us, n0, nc), m, sm, sn)[:, :nc]
    # launch 3: requantization of H itself (one plane: 0 + H)
    hq, hs = _requant(_ascending([h]), gw)
    # launch 4: the split kernel up to GEMM_SPLIT_M rows, 128 x 128 tiles above
    bm, bn = (sm, sn) if m <= GEMM_SPLIT_M else GEMM_TILE
    run = _split_pass if m <= GEMM_SPLIT_M else _tile_pass
    out = torch.zeros(m, gw.ndim_out)
    for n0, nc in _col_tiles(gw, bn):
        tasks = _Tasks(gw, xq, xs, rq, gw.rs, n0, nc, hq, hs)
        out[:, n0:n0 + nc] = run(tasks, m, bm, bn)[:, :nc]
    return out.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a_bits", [4, 8])
@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("pack", ["qkv", "down", "odd_gemv"])
def test_gemv_schedule_bit_exact(pack, m, a_bits):
    gw = _packs(pack, a_bits)
    x = _x(m, gw.kdim, seed=m)
    assert torch.equal(gemv_model(x, gw), T.dual_gemm_group_ref(x, gw))


@pytest.mark.parametrize("a_bits", [4, 8])
@pytest.mark.parametrize("m", [9, 32, 100])
@pytest.mark.parametrize("pack", ["qkv", "down", "odd_gemm"])
def test_gemm_schedule_bit_exact(pack, m, a_bits):
    gw = _packs(pack, a_bits)
    x = _x(m, gw.kdim, seed=m)
    assert torch.equal(gemm_model(x, gw), T.dual_gemm_group_ref(x, gw))


@pytest.mark.parametrize("pack", ["down", "odd_gemm"])
def test_gemm_rows_do_not_depend_on_m(pack):
    """The main pass switches from the split kernel to 128-row tiles above
    GEMM_SPLIT_M rows; every output keeps the same chain, so a row of a
    100-row launch equals that row launched alone."""
    gw = _packs(pack, 4)
    x = _x(100, gw.kdim, seed=7)
    y = gemm_model(x, gw)
    for i in (0, 63, 64, 99):
        assert torch.equal(gemm_model(x[i:i + 1], gw), y[i:i + 1])


def test_bias_trick_is_exact_over_the_dot_range():
    """(float)dot from the biased accumulator equals the conversion for every
    dot a scale group can give (|dot| <= 127 * 8 * 128)."""
    lim = 127 * 8 * 128
    dots = torch.cat([torch.arange(-lim, lim + 1, 97), torch.tensor([-lim, -1, 0, 1, lim])])
    got = (DOT_BIAS + 16 * dots).to(torch.int32).view(torch.float32) - DOT_BASE
    assert torch.equal(got, dots.to(torch.float32))


def test_planted_wrong_order_is_caught():
    """H's terms summed pairwise instead of in ascending group order. The
    input makes the order matter: scale group 2 is the exact negation of
    group 0 (its U rows equal group 0's, its activations are group 0's
    negated), both ~1e5 x the other groups, so the f32 sums cancel and keep
    different rounding errors, which move H's scales. The kernels' order
    still equals the plain version; the planted one does not."""
    g = torch.Generator().manual_seed(3)
    k, n, r, G = 512, 256, 32, 128
    U = torch.randn(k, r, generator=g) * 0.1
    U[2 * G:3 * G] = U[:G]
    # the residual is zero, so the output is the low-rank path, where H's
    # scales land
    w = T.pack_twinquant_weights(U, torch.randn(r, n, generator=g) * 0.1, torch.zeros(k, n),
                                 a_bits=4)
    gw = T.as_group(w)
    x = torch.randn(8, k, generator=g)
    x[:, :G] *= 1e5
    x[:, 2 * G:3 * G] = -x[:, :G]
    x = x.bfloat16()
    want = T.dual_gemm_group_ref(x, gw)
    assert torch.equal(gemv_model(x, gw), want)
    assert (gemv_model(x, gw, h_sum=_pairwise) != want).sum() > 100
