// Shared tile body of the block-table attention kernels (paged_attention.cu,
// ragged_attention.cu) for Hopper, sm_90a.
//
// Both kernels attend, for one slot and one KV head, a panel of consecutive
// query rows: row r of the slot's run sits at absolute position ctx + r,
// where ctx is the slot's committed prefix length. A row sees
//   * the committed keys [0, ctx), read from the slot's pages through its
//     block-table row (an unmapped page, -1, gives no keys), and
//   * the earlier rows of the run, [ctx, its own position), read from the
//     launch's own K/V rows (the draft panel, or the slot's in-batch rows),
// and then itself. All g = H/KV query heads of the KV head are handled by
// the same block, so each K/V tile is read once for all of them. The two
// kernels differ only in addressing: where the block's query rows and the
// run's K/V rows lie, which rows a block answers, and what is done after
// the fold (the paged kernel commits its draft rows into their pages).
//
// Split-KV schedule (flash-decoding). The key range is cut into chunks of
// `chunk` absolute positions (autotune.PAGED_CHUNK for both kernels), one
// block per (chunk, KV head, panel of rows); a block whose chunk holds no
// key its rows need exits at once. A working block reads its chunk's
// block-table entries once into shared memory and walks the chunk in tiles
// of 64 keys through a ring of cp.async stages (three where two blocks
// still fit an SM, else two), one wait and one barrier a tile
// (att_split_chunk). For each tile:
//   * scores: mma.sync.m16n8k16 bf16 with 16 keys as A (each warp of a
//     group of four one 16-key slice) and the query vectors (rows x heads
//     of the KV head, <= 32) as n8 tiles, f32 accumulate, k16 steps
//     ascending; q is bf16 already, so feeding it to the MMA is exact;
//   * the tile's online-softmax step per query vector (one warp per vector:
//     max and sum over the 64 keys by xor butterflies, a fixed order);
//   * P.V: the probabilities split exactly enough into bf16 hi + lo parts
//     (p - hi rounded again: 16 significant bits), V^T as A through
//     ldmatrix.trans, two MMAs per k16 step, f32 accumulate.
// A block has one group of four warps (the paged kernel) or two (the
// ragged kernel, whose blocks hold 32 query vectors), each group taking
// its share of the n8 tiles; an MMA's output element, and each vector's
// softmax step, go through the same operations in either case.
// The block writes each query vector's f32 partial (m, l, acc[hd]) to a
// scratch the wrapper allocates. A second launch folds, one warp per query
// vector (att_combine_vec), the vector's partials of the chunks that hold
// its keys in ascending chunk order, skipping a chunk with no valid key,
// then the self term last, and rounds once to bf16.
//
// Fold order. A key is folded in the tile of absolute positions [64 j,
// 64 j + 64) that holds it, wherever it lives (page or panel); a tile with
// no valid key for a row is skipped, not folded as zeros; chunks fold in
// ascending order from a fixed absolute grid; the self term folds last.
// Every add, multiply and exp outside the MMAs is an explicit
// round-to-nearest intrinsic, and an MMA's output element depends only on
// its own row and column. So a row's bits depend only on its position and
// the key values, not on where the keys came from, on which rows share its
// block or on how many rows share the launch: a row of a stacked draft
// launch equals the row a one-row launch computes once the earlier drafts
// sit in pages, and a prompt row's output does not depend on how the
// prompt was chunked.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ATT_WARPS 4
#define ATT_THREADS (ATT_WARPS * 32)
#define ATT_TILE 64              // keys a tile folds
#define ATT_QV_MAX 32            // query vectors (rows x heads) a block
#define ATT_SC_LD (ATT_TILE + 4)  // f32 score row: conflict-free fragment stores
#define ATT_P_LD (ATT_TILE + 8)   // bf16 probability row: conflict-free ldmatrix
#define ATT_SM_SMEM 233472       // shared memory of an SM (1 KB of it reserved a block)
#define ATT_CHUNK_MAX 512        // longest chunk the launch contracts admit
#define ATT_BT_MAX 516           // block-table entries a chunk spans (<= chunk / page + 1)
#define ATT_CPF 8                // chunk partials the combine loads at a time
#define ATT_FULL 0xffffffffu

typedef __nv_bfloat16 bf16;

// padded head dim (whole k16 steps) and the bf16 row stride of the K, V and
// q tiles (+8: conflict-free ldmatrix rows)
__host__ __device__ inline int att_hdp(int hd) { return (hd + 15) & ~15; }
__host__ __device__ inline int att_ld(int hd) { return att_hdp(hd) + 8; }

// Dynamic shared memory of a split block: `stages` K and V tiles, the query
// tile, the f32 scores, the bf16 hi / lo probabilities (nt n8 tiles of query
// vectors each), the key flags of each stage, the per-vector factors and the
// chunk's block-table entries.
inline size_t att_smem_bytes(int hd, int nt, int stages) {
  const size_t ld = att_ld(hd);
  return (size_t)stages * 2 * ATT_TILE * ld * 2 + (size_t)8 * nt * ld * 2 +
         (size_t)8 * nt * ATT_SC_LD * 4 + (size_t)2 * 8 * nt * ATT_P_LD * 2 +
         (size_t)stages * ATT_TILE * 4 + (size_t)ATT_QV_MAX * 4 + (size_t)ATT_BT_MAX * 4;
}
// three stages where two such blocks fit an SM, else two (two blocks an SM
// hide more latency than a third stage)
inline int att_stages(int hd, int nt) {
  return 2 * (att_smem_bytes(hd, nt, 3) + 1024) <= ATT_SM_SMEM ? 3 : 2;
}

// ceil(hd / 32) rounded up to a compiled lane width (the combine's dims a lane)
inline int attn_dpl(int hd) { return hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 128 ? 4 : 8; }

template <typename Kernel>
inline int attn_prepare(Kernel k, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

__device__ __forceinline__ void att_cp16(void* smem, const void* gmem, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void att_cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void att_cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void att_ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void att_ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void att_ldsm_x2(unsigned& r0, unsigned& r1, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}
__device__ __forceinline__ void att_mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                        unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// What every block of a launch shares: a member of the kernel's parameter
// struct, read from the parameter space.
struct AttConst {
  const bf16* q;   // query row i, head h at q + (i * H + h) * hd
  const bf16* kp;  // pools (P, page, KV, hd)
  const bf16* vp;
  const bf16* kt;  // the launch's own K/V rows (draft panels, in-batch rows)
  const bf16* vt;
  const int* bt;  // (B, maxp), -1 unmapped
  float* part_acc;  // vector v's partial acc at part_acc + (part_base + v) * hd,
  float* part_ml;   // (m, l) at part_ml + (part_base + v) * 2 (part_base: AttChunk)
  int H, KV, g, hd, maxp, page, stages;
  int pshift;  // log2(page) for a power-of-two page, else -1
  float scale;
};

// One split block's work: the chunk [c0, c_end) of one slot's keys for one
// KV head and a panel of nqv query vectors (v = i * g + hh: the block's row
// i, head kvh * g + hh).
struct AttChunk {
  int row0;   // the block's row i is q's row row0 + i
  int prow0;  // the run's row at position ctx + r is kt's row prow0 + r
  int slot;   // the block-table row
  long long part_base;  // the partials of the block's vector 0
  int ctx;    // keys below ctx lie in pages, keys from ctx in the panel
  int p_end;  // keys some row of the block needs: [0, p_end)
  int pos0;   // position of the block's row 0
  int c0, c_end;
  int nqv, kvh;
};

// Start the copy of the tile at absolute positions [p0, p0 + 64): keys below
// ctx from the slot's pages, keys in [ctx, p_end) from the panel, the rest
// zero-filled (never read); ok[t] says whether key t exists.
// The thread walks items (key t, 16-byte dim chunk cd) from (t0, cd0) in
// steps of the block's thread count (dt keys and dc chunks, carried), no division;
// at most IT items (a compile-time count, so the block-table reads of all
// of them are in flight together).
template <int IT>
__device__ __forceinline__ void att_load_tile(const AttConst& k, const AttChunk& a, const int* pg_s,
                                              int pi0, int p0, int t0, int cd0, int dt, int dc,
                                              bf16* ks, bf16* vs, int* ok) {
  const int hd = k.hd, c8 = hd >> 3, ld = att_ld(hd);
  const long long row = (long long)k.KV * hd;
  // pass 1: each item's key and chunk, and the page id of keys below ctx
  // (from the chunk's block-table entries in shared memory)
  int tk[IT], ck[IT], pgk[IT];
  {
    int t = t0, cd = cd0;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      tk[it] = t;
      ck[it] = cd;
      const int p = p0 + t;
      const int pi = k.pshift >= 0 ? p >> k.pshift : p / k.page;
      pgk[it] = (t < ATT_TILE && p < a.ctx && p < a.p_end) ? pg_s[pi - pi0] : -1;
      cd += dc;
      t += dt;
      if (cd >= c8) {
        cd -= c8;
        ++t;
      }
    }
  }
  // pass 2: the copies
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int t = tk[it], d = ck[it] * 8;
    if (t >= ATT_TILE) break;
    const int p = p0 + t;
    const bf16 *ksrc = k.kp, *vsrc = k.vp;
    bool valid = false;
    if (p < a.ctx) {
      const int pg = pgk[it];
      if (pg >= 0) {
        const int pi = k.pshift >= 0 ? p >> k.pshift : p / k.page;
        const long long off =
            ((long long)pg * k.page + (p - pi * k.page)) * row + (long long)a.kvh * hd + d;
        ksrc = k.kp + off;
        vsrc = k.vp + off;
        valid = true;
      }
    } else if (p < a.p_end) {
      const long long off = ((long long)a.prow0 + (p - a.ctx)) * row + (long long)a.kvh * hd + d;
      ksrc = k.kt + off;
      vsrc = k.vt + off;
      valid = true;
    }
    att_cp16(ks + t * ld + d, ksrc, valid);
    att_cp16(vs + t * ld + d, vsrc, valid);
    if (d == 0) ok[t] = valid ? 1 : 0;
  }
}

// The split block's body. MTW: 16-dim slices of V^T a warp owns (hd <= 64 *
// MTW); NT: n8 tiles of query vectors (nqv <= 8 * NT); W: warps (4 or 8,
// the block's threads W * 32). The caller has checked that the chunk holds
// a key some row needs (c0 < p_end).
template <int MTW, int NT, int W = ATT_WARPS>
__device__ __forceinline__ void att_split_chunk(const AttConst& k, const AttChunk& a,
                                                unsigned char* smem) {
  const int c0 = a.c0;
  const int n_tiles = (a.c_end - c0 + ATT_TILE - 1) / ATT_TILE;
  const int hd = k.hd, hdp = att_hdp(hd), ld = att_ld(hd), stages = k.stages;
  const int nqv = a.nqv, g = k.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2,
            tig = lane & 3;
  // W / 4 warp groups: warp group wg takes n8 tiles [wg NTW, wg NTW + NTW)
  // of the scores and of P.V; wq = warp % 4 its key / dim slice
  constexpr int NTW = NT * ATT_WARPS / W;
  const int wq = warp & (ATT_WARPS - 1), nb = (warp / ATT_WARPS) * NTW;
  const int c8 = hd >> 3, dt = (W * 32) / c8, dc = (W * 32) - dt * c8;
  const int t0 = tid / c8, cd0 = tid - t0 * c8;

  bf16* kv_s = reinterpret_cast<bf16*>(smem);
  bf16* q_s = kv_s + (size_t)stages * 2 * ATT_TILE * ld;
  float* sc_s = reinterpret_cast<float*>(q_s + 8 * NT * ld);
  bf16* ph_s = reinterpret_cast<bf16*>(sc_s + 8 * NT * ATT_SC_LD);
  bf16* pl_s = ph_s + 8 * NT * ATT_P_LD;
  int* ok_s = reinterpret_cast<int*>(pl_s + 8 * NT * ATT_P_LD);
  float* cf_s = reinterpret_cast<float*>(ok_s + stages * ATT_TILE);
  int* pg_s = reinterpret_cast<int*>(cf_s + ATT_QV_MAX);

  // the chunk's block-table entries (-1 past the table), read once
  const int pi0 = k.pshift >= 0 ? c0 >> k.pshift : c0 / k.page;
  {
    const int last = a.c_end - 1;
    const int n_pg = (k.pshift >= 0 ? last >> k.pshift : last / k.page) - pi0 + 1;
    for (int i = tid; i < n_pg; i += (W * 32))
      pg_s[i] = pi0 + i < k.maxp ? k.bt[(long long)a.slot * k.maxp + pi0 + i] : -1;
  }

  // zeros where no copy writes: the K / V pad dims, the query tile's pad
  // dims and vectors past nqv, the probabilities of vectors past nqv
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (hdp > hd)
    for (int i = tid; i < stages * 2 * ATT_TILE * (hdp - hd); i += (W * 32)) {
      const int r = i / (hdp - hd);
      kv_s[(size_t)r * ld + hd + (i - r * (hdp - hd))] = zero;
    }
  for (int i = tid; i < 8 * NT * hdp; i += (W * 32)) {
    const int v = i / hdp, d = i - v * hdp;
    if (v >= nqv || d >= hd) q_s[v * ld + d] = zero;
  }
  for (int i = tid; i < (8 * NT - nqv) * ATT_P_LD; i += (W * 32)) {
    ph_s[nqv * ATT_P_LD + i] = zero;
    pl_s[nqv * ATT_P_LD + i] = zero;
  }
  // query vector v = i * g + hh: the block's row i, head kvh * g + hh
  for (int i = tid; i < nqv * (hd >> 3); i += (W * 32)) {
    const int v = i / (hd >> 3), d = (i - v * (hd >> 3)) * 8, r = v / g, hh = v - r * g;
    *reinterpret_cast<uint4*>(q_s + v * ld + d) = *reinterpret_cast<const uint4*>(
        k.q + (((long long)a.row0 + r) * k.H + (long long)a.kvh * g + hh) * hd + d);
  }

  __syncthreads();  // the chunk's page ids, before the first tile's copies
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_tiles) {
      bf16* ks = kv_s + (size_t)s * 2 * ATT_TILE * ld;
      att_load_tile<16 * MTW / W>(k, a, pg_s, pi0, c0 + s * ATT_TILE, t0, cd0, dt, dc, ks,
                             ks + ATT_TILE * ld, ok_s + s * ATT_TILE);
    }
    att_cp_commit();
  }

  // running softmax state of the vectors this warp owns (v = warp + W i),
  // the same in every lane; P.V accumulators: V^T rows (dims) x vectors
  float m_run[ATT_QV_MAX / W], l_run[ATT_QV_MAX / W];
#pragma unroll
  for (int i = 0; i < ATT_QV_MAX / W; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  float acc[MTW][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  // position of the row of each vector this lane's score fragments hold
  // (v = 8 n + 2 tig + e)
  int rowpos[NTW][2];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) rowpos[n][e] = a.pos0 + (8 * (nb + n) + 2 * tig + e) / g;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % stages;
    if (stages == 3)
      asm volatile("cp.async.wait_group 1;\n" ::);
    else
      att_cp_wait_all();
    __syncthreads();  // tile j visible to all; tile j - 1 fully consumed
    {
      const int jn = j + stages - 1;
      if (jn < n_tiles) {
        bf16* ks = kv_s + (size_t)(jn % stages) * 2 * ATT_TILE * ld;
        att_load_tile<16 * MTW / W>(k, a, pg_s, pi0, c0 + jn * ATT_TILE, t0, cd0, dt, dc, ks,
                               ks + ATT_TILE * ld, ok_s + (jn % stages) * ATT_TILE);
      }
      att_cp_commit();
    }
    const bf16* ks = kv_s + (size_t)st * 2 * ATT_TILE * ld;
    const bf16* vs = ks + ATT_TILE * ld;
    const int* ok = ok_s + st * ATT_TILE;
    const int p0 = c0 + j * ATT_TILE;

    // 1. scores of keys [16 wq, 16 wq + 16) x the group's vectors
    {
      float s[NTW][4];
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 64 * MTW; kk += 16) {
        if (kk < hdp) {
          unsigned af[4];
          att_ldsm_x4(af, ks + (16 * wq + (lane & 15)) * ld + kk + (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < NTW; ++n) {
            unsigned b0, b1;
            att_ldsm_x2(b0, b1,
                        q_s + (8 * (nb + n) + (lane & 7)) * ld + kk + ((lane >> 3) & 1) * 8);
            att_mma(s[n], af, b0, b1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * wq + gid + 8 * (e >> 1), v = 8 * (nb + n) + 2 * tig + (e & 1);
          if (v < nqv) {
            const bool valid = ok[key] && p0 + key < rowpos[n][e & 1];
            sc_s[v * ATT_SC_LD + key] = valid ? __fmul_rn(s[n][e], k.scale) : -INFINITY;
          }
        }
    }
    __syncthreads();

    // 2. the tile's softmax step, one warp per vector (v = warp + W i, at
    // most 8 NT / W of them): the warp's vectors step together, each
    // through its own fixed order (max and sum by xor butterflies over the
    // 64 keys)
    {
      constexpr int VPW = 8 * NT / W;
      float s0[VPW], s1[VPW], mt[VPW], ls[VPW], mn[VPW], corr[VPW], p0f[VPW], p1f[VPW];
#pragma unroll
      for (int i = 0; i < VPW; ++i) {
        const int v = min(warp + W * i, 8 * NT - 1);  // past nqv: computed, unused
        s0[i] = sc_s[v * ATT_SC_LD + lane];
        s1[i] = sc_s[v * ATT_SC_LD + lane + 32];
        mt[i] = fmaxf(s0[i], s1[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < VPW; ++i) mt[i] = fmaxf(mt[i], __shfl_xor_sync(ATT_FULL, mt[i], off));
#pragma unroll
      for (int i = 0; i < VPW; ++i) {
        mn[i] = fmaxf(m_run[i], mt[i]);
        corr[i] = expf(__fadd_rn(m_run[i], -mn[i]));
        p0f[i] = expf(__fadd_rn(s0[i], -mn[i]));  // a masked key: exp(-inf) = 0
        p1f[i] = expf(__fadd_rn(s1[i], -mn[i]));
        ls[i] = __fadd_rn(p0f[i], p1f[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < VPW; ++i)
          ls[i] = __fadd_rn(ls[i], __shfl_xor_sync(ATT_FULL, ls[i], off));
#pragma unroll
      for (int i = 0; i < VPW; ++i) {
        const int v = warp + W * i;
        if (v >= nqv) break;
        if (mt[i] == -INFINITY) {  // no key of this tile precedes the row: not folded
          if (lane == 0) cf_s[v] = -1.f;
          continue;
        }
        l_run[i] = __fadd_rn(__fmul_rn(l_run[i], corr[i]), ls[i]);
        m_run[i] = mn[i];
        const bf16 h0 = __float2bfloat16_rn(p0f[i]), h1 = __float2bfloat16_rn(p1f[i]);
        ph_s[v * ATT_P_LD + lane] = h0;
        ph_s[v * ATT_P_LD + lane + 32] = h1;
        pl_s[v * ATT_P_LD + lane] = __float2bfloat16_rn(__fadd_rn(p0f[i], -__bfloat162float(h0)));
        pl_s[v * ATT_P_LD + lane + 32] =
            __float2bfloat16_rn(__fadd_rn(p1f[i], -__bfloat162float(h1)));
        if (lane == 0) cf_s[v] = corr[i];
      }
    }
    __syncthreads();

    // 3. P.V: V^T dims [16 (4 mt + wq), +16) x the group's vectors, keys in
    // k16 steps
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      const int dm = 16 * (ATT_WARPS * mt + wq);
      if (dm >= hdp) break;
      float part[NTW][4];
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ATT_TILE; kk += 16) {
        unsigned af[4];
        att_ldsm_x4_t(af, vs + (kk + (lane & 7) + ((lane >> 4) << 3)) * ld + dm +
                              ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          unsigned h0, h1, l0, l1;
          const int off = (8 * (nb + n) + (lane & 7)) * ATT_P_LD + kk + ((lane >> 3) & 1) * 8;
          att_ldsm_x2(h0, h1, ph_s + off);
          att_ldsm_x2(l0, l1, pl_s + off);
          att_mma(part[n], af, h0, h1);
          att_mma(part[n], af, l0, l1);
        }
      }
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = 8 * (nb + n) + 2 * tig + (e & 1);
          if (v < nqv) {
            const float cf = cf_s[v];
            if (cf >= 0.f) acc[mt][n][e] = __fadd_rn(__fmul_rn(acc[mt][n][e], cf), part[n][e]);
          }
        }
    }
  }

  // the chunk's partials: (m, l) by lane 0 of the owning warp, acc by fragment
  const long long base = a.part_base;
#pragma unroll
  for (int i = 0; i < ATT_QV_MAX / W; ++i) {
    const int v = warp + W * i;
    if (v >= nqv) break;
    if (lane == 0) {
      k.part_ml[(base + v) * 2] = m_run[i];
      k.part_ml[(base + v) * 2 + 1] = l_run[i];
    }
  }
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
    const int dm = 16 * (ATT_WARPS * mt + wq);
    if (dm >= hdp) break;
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = 8 * (nb + n) + 2 * tig + (e & 1), d = dm + gid + 8 * (e >> 1);
        if (v < nqv && d < hd) k.part_acc[(base + v) * hd + d] = acc[mt][n][e];
      }
  }
}

// One query vector's combine, run by one warp: fold the partials of chunks
// 0 .. n_c - 1 (chunk c's at index base0 + c * cstride) in ascending order,
// loaded ATT_CPF chunks at a time and skipping a chunk with no valid key of
// the row, then the self term (q . kself, value vself), then the one
// rounding to bf16 into o.
template <int DPL>
__device__ __forceinline__ void att_combine_vec(const bf16* qr, const bf16* kself,
                                                const bf16* vself, const float* part_acc,
                                                const float* part_ml, long long base0,
                                                long long cstride, int n_c, int hd, float scale,
                                                bf16* o) {
  const int lane = threadIdx.x & 31;
  float vs[DPL];
#pragma unroll
  for (int k8 = 0; k8 < DPL; ++k8) {
    const int d = lane + 32 * k8;
    vs[k8] = d < hd ? __bfloat162float(vself[d]) : 0.f;
  }
  // self score: the lane's dims in order, then a butterfly (every lane
  // ends with the same bits: each level adds a commutative pair)
  float dot = 0.f;
#pragma unroll
  for (int k8 = 0; k8 < DPL; ++k8) {
    const int d = lane + 32 * k8;
    if (d < hd) dot = __fmaf_rn(__bfloat162float(qr[d]), __bfloat162float(kself[d]), dot);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dot = __fadd_rn(dot, __shfl_xor_sync(ATT_FULL, dot, off));
  const float s = __fmul_rn(dot, scale);

  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int k8 = 0; k8 < DPL; ++k8) acc[k8] = 0.f;
  for (int c0 = 0; c0 < n_c; c0 += ATT_CPF) {
    float mc[ATT_CPF], lc[ATT_CPF], ac[ATT_CPF][DPL];
#pragma unroll
    for (int u = 0; u < ATT_CPF; ++u) {
      const long long base = base0 + (long long)(c0 + u) * cstride;
      const bool live = c0 + u < n_c;
      mc[u] = live ? part_ml[base * 2] : -INFINITY;
      lc[u] = live ? part_ml[base * 2 + 1] : 0.f;
#pragma unroll
      for (int k8 = 0; k8 < DPL; ++k8) {
        const int d = lane + 32 * k8;
        ac[u][k8] = live && d < hd ? part_acc[base * hd + d] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < ATT_CPF; ++u) {
      if (mc[u] == -INFINITY) continue;  // past n_c, or no valid key of the row
      const float m_new = fmaxf(m, mc[u]);
      const float ca = expf(__fadd_rn(m, -m_new)), cb = expf(__fadd_rn(mc[u], -m_new));
      l = __fadd_rn(__fmul_rn(l, ca), __fmul_rn(lc[u], cb));
#pragma unroll
      for (int k8 = 0; k8 < DPL; ++k8)
        acc[k8] = __fadd_rn(__fmul_rn(acc[k8], ca), __fmul_rn(ac[u][k8], cb));
      m = m_new;
    }
  }
  const float m_new = fmaxf(m, s);
  const float corr = expf(__fadd_rn(m, -m_new));
  const float p = expf(__fadd_rn(s, -m_new));
  const float lf = __fadd_rn(__fmul_rn(l, corr), p);
#pragma unroll
  for (int k8 = 0; k8 < DPL; ++k8) {
    const int d = lane + 32 * k8;
    if (d < hd) {
      const float af = __fadd_rn(__fmul_rn(acc[k8], corr), __fmul_rn(p, vs[k8]));
      o[d] = __float2bfloat16_rn(__fdiv_rn(af, lf));
    }
  }
}
