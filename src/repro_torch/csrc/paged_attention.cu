// Block-table paged decode attention for Hopper, sm_90a.
//
// Replaces: repro/kernels/paged_attention.py : paged_decode_kernel (body
// _paged_decode_fwd, _fold).
//
// Each slot b has sq <= 8 post-RoPE query rows (a decode token, or a
// speculative draft stack); row i sits at position pos[b] + i and attends
// the committed prefix [0, pos[b]) through the slot's block table, the
// earlier draft rows of the slot, and itself. Keys at positions past the
// table (maxp * page) do not exist, as in the plain version's dense view.
//
// What bounds it: bytes. Each key and value of the pages in use is read
// once per KV head and used by all g = H/KV query heads and all sq rows, a
// few flops per byte, so the least time is the pages actually read,
// about 2 * sum_b pos_b * KV * hd * 2 bytes, over the memory rate.
//
// Design (flash-decoding). The key range is cut into chunks of `chunk`
// absolute positions (a multiple of the 64-key tile; the wrapper passes
// autotune.PAGED_CHUNK, the same for every launch). Launch 1 (pd_split_kernel) runs one block per
// (chunk, KV head, slot); a block whose chunk holds no key of its slot's
// rows exits at once, so idle slots and short contexts cost nothing. A
// working block reads its chunk's block-table entries once into shared
// memory and walks the chunk in tiles of 64 keys through a ring of cp.async
// stages (three where two blocks still fit an SM, else two), one wait and
// one barrier a tile. For each tile:
//   * scores: mma.sync.m16n8k16 bf16 with 16 keys as A (four warps, one
//     16-key slice each) and the query vectors (rows x heads of the KV
//     head, <= 32) as n8 tiles, f32 accumulate, k16 steps ascending; q is
//     bf16 already, so feeding it to the MMA is exact;
//   * the tile's online-softmax step per query vector (one warp per vector:
//     max and sum over the 64 keys by xor butterflies, a fixed order);
//   * P.V: the probabilities split exactly enough into bf16 hi + lo parts
//     (p - hi rounded again: 16 significant bits), V^T as A through
//     ldmatrix.trans, two MMAs per k16 step, f32 accumulate.
// The block writes each query vector's f32 partial (m, l, acc[hd]) to the
// scratch the wrapper allocates. Launch 2 (pd_combine_kernel, one warp per
// query vector) folds the vector's partials of the chunks that hold its
// keys in ascending chunk order, skipping a chunk with no valid key, then
// the self term last, rounds once to bf16, and runs the commit.
//
// Fold order. A key is folded in the tile of absolute positions [64 j,
// 64 j + 64) that holds it, wherever it lives (page or draft panel); a tile
// with no valid key for a row is skipped, not folded as zeros; chunks fold
// in ascending order from a fixed absolute grid; the self term folds last.
// Every add, multiply and exp outside the MMAs is an explicit
// round-to-nearest intrinsic. So a row's bits depend only on its position
// and the key values: a row of a stacked draft launch equals the row a
// one-row launch computes once the earlier drafts sit in pages.
//
// Commit (commit != 0): launch 2 writes its KV head's columns of the draft
// rows into their tail pages, skipping rows whose page is unmapped or lies
// past the table. It runs after every read of launch 1 (stream order) and
// only positions >= pos[b] of the slot's own pages are written, which no
// block reads from a page.
#include "attention_common.cuh"

#define PD_WARPS 4
#define PD_THREADS (PD_WARPS * 32)
#define PD_TILE 64           // keys a tile folds
#define PD_QV_MAX 32         // query vectors a block
#define PD_SC_LD (PD_TILE + 4)  // f32 score row: conflict-free fragment stores
#define PD_P_LD (PD_TILE + 8)   // bf16 probability row: conflict-free ldmatrix
#define PD_SM_SMEM 233472       // shared memory of an SM (1 KB of it reserved a block)
#define PD_CHUNK_MAX 512        // longest chunk the launch contract admits
#define PD_BT_MAX 516           // block-table entries a chunk spans (<= chunk / page + 1)

typedef __nv_bfloat16 bf16;

// padded head dim (whole k16 steps) and the bf16 row stride of the K, V and
// q tiles (+8: conflict-free ldmatrix rows)
__host__ __device__ inline int pd_hdp(int hd) { return (hd + 15) & ~15; }
__host__ __device__ inline int pd_ld(int hd) { return pd_hdp(hd) + 8; }

// Dynamic shared memory of a split block: `stages` K and V tiles, the query
// tile, the f32 scores, the bf16 hi / lo probabilities (nt n8 tiles of query
// vectors each), the key flags of each stage, the per-vector factors and the
// chunk's block-table entries.
inline size_t pd_smem_bytes(int hd, int nt, int stages) {
  const size_t ld = pd_ld(hd);
  return (size_t)stages * 2 * PD_TILE * ld * 2 + (size_t)8 * nt * ld * 2 +
         (size_t)8 * nt * PD_SC_LD * 4 + (size_t)2 * 8 * nt * PD_P_LD * 2 +
         (size_t)stages * PD_TILE * 4 + (size_t)PD_QV_MAX * 4 + (size_t)PD_BT_MAX * 4;
}
// three stages where two such blocks fit an SM, else two (two blocks an SM
// hide more latency than a third stage)
inline int pd_stages(int hd, int nt) {
  return 2 * (pd_smem_bytes(hd, nt, 3) + 1024) <= PD_SM_SMEM ? 3 : 2;
}

__device__ __forceinline__ void pd_ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void pd_ldsm_x4_t(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void pd_ldsm_x2(unsigned& r0, unsigned& r1, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}
__device__ __forceinline__ void pd_mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct PdArgs {
  const bf16* q;  // (B, sq, H, hd)
  const bf16* kp;  // pools (P, page, KV, hd)
  const bf16* vp;
  const bf16* kt;  // draft rows (B, sq, KV, hd)
  const bf16* vt;
  const int* bt;  // (B, maxp), -1 unmapped
  const int* pos;
  float* part_acc;  // (B, KV, nc, nqv, hd) f32
  float* part_ml;   // (B, KV, nc, nqv, 2) f32: m, l
  int sq, H, KV, hd, maxp, page, chunk, nc, stages;
  int pshift;  // log2(page) for a power-of-two page, else -1
  float scale;
};

// Start the copy of the tile at absolute positions [p0, p0 + 64): keys below
// ctx from the slot's pages, keys in [ctx, p_end) from the draft panel, the
// rest zero-filled (never read); ok[t] says whether key t exists.
// The thread walks items (key t, 16-byte dim chunk cd) from (t0, cd0) in
// steps of PD_THREADS items (dt keys and dc chunks, carried), no division;
// at most IT items (a compile-time count, so the block-table reads of all
// of them are in flight together).
template <int IT>
__device__ __forceinline__ void pd_load_tile(const PdArgs& a, const int* pg_s, int pi0, int ctx,
                                             int p_end, int b, int kvh, int p0, int t0,
                                             int cd0, int dt, int dc, bf16* ks, bf16* vs,
                                             int* ok) {
  const int hd = a.hd, c8 = hd >> 3, ld = pd_ld(hd);
  const long long row = (long long)a.KV * hd;
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
      const int pi = a.pshift >= 0 ? p >> a.pshift : p / a.page;
      pgk[it] = (t < PD_TILE && p < ctx && p < p_end) ? pg_s[pi - pi0] : -1;
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
    if (t >= PD_TILE) break;
    const int p = p0 + t;
    const bf16 *ksrc = a.kp, *vsrc = a.vp;
    bool valid = false;
    if (p < ctx) {
      const int pg = pgk[it];
      if (pg >= 0) {
        const int pi = a.pshift >= 0 ? p >> a.pshift : p / a.page;
        const long long off =
            ((long long)pg * a.page + (p - pi * a.page)) * row + (long long)kvh * hd + d;
        ksrc = a.kp + off;
        vsrc = a.vp + off;
        valid = true;
      }
    } else if (p < p_end) {
      const long long off = ((long long)b * a.sq + (p - ctx)) * row + (long long)kvh * hd + d;
      ksrc = a.kt + off;
      vsrc = a.vt + off;
      valid = true;
    }
    att_cp16(ks + t * ld + d, ksrc, valid);
    att_cp16(vs + t * ld + d, vsrc, valid);
    if (d == 0) ok[t] = valid ? 1 : 0;
  }
}

// MTW: 16-dim slices of V^T a warp owns (hd <= 64 * MTW); NT: n8 tiles of
// query vectors (nqv <= 8 * NT).
template <int MTW, int NT>
__global__ void __launch_bounds__(PD_THREADS) pd_split_kernel(const PdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.KV, nqv = a.sq * g;
  const int ctx = a.pos[b];
  const int s_max = a.maxp * a.page;
  // keys some row needs: [0, min(position of the last row, s_max))
  const int p_end = min(ctx + a.sq - 1, s_max);
  const int c0 = c * a.chunk;
  if (c0 >= p_end) return;
  const int n_tiles = (min(c0 + a.chunk, p_end) - c0 + PD_TILE - 1) / PD_TILE;
  const int hd = a.hd, hdp = pd_hdp(hd), ld = pd_ld(hd), stages = a.stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2,
            tig = lane & 3;
  const int* bt_row = a.bt + (long long)b * a.maxp;
  const int c8 = hd >> 3, dt = PD_THREADS / c8, dc = PD_THREADS - dt * c8;
  const int t0 = tid / c8, cd0 = tid - t0 * c8;

  bf16* kv_s = reinterpret_cast<bf16*>(smem);
  bf16* q_s = kv_s + (size_t)stages * 2 * PD_TILE * ld;
  float* sc_s = reinterpret_cast<float*>(q_s + 8 * NT * ld);
  bf16* ph_s = reinterpret_cast<bf16*>(sc_s + 8 * NT * PD_SC_LD);
  bf16* pl_s = ph_s + 8 * NT * PD_P_LD;
  int* ok_s = reinterpret_cast<int*>(pl_s + 8 * NT * PD_P_LD);
  float* cf_s = reinterpret_cast<float*>(ok_s + stages * PD_TILE);
  int* pg_s = reinterpret_cast<int*>(cf_s + PD_QV_MAX);

  // the chunk's block-table entries (-1 past the table), read once
  const int pi0 = a.pshift >= 0 ? c0 >> a.pshift : c0 / a.page;
  {
    const int last = min(c0 + a.chunk, p_end) - 1;
    const int n_pg = (a.pshift >= 0 ? last >> a.pshift : last / a.page) - pi0 + 1;
    for (int i = tid; i < n_pg; i += PD_THREADS)
      pg_s[i] = pi0 + i < a.maxp ? bt_row[pi0 + i] : -1;
  }

  // zeros where no copy writes: the K / V pad dims, the query tile's pad
  // dims and vectors past nqv, the probabilities of vectors past nqv
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (hdp > hd)
    for (int i = tid; i < stages * 2 * PD_TILE * (hdp - hd); i += PD_THREADS) {
      const int r = i / (hdp - hd);
      kv_s[(size_t)r * ld + hd + (i - r * (hdp - hd))] = zero;
    }
  for (int i = tid; i < 8 * NT * hdp; i += PD_THREADS) {
    const int v = i / hdp, d = i - v * hdp;
    if (v >= nqv || d >= hd) q_s[v * ld + d] = zero;
  }
  for (int i = tid; i < (8 * NT - nqv) * PD_P_LD; i += PD_THREADS) {
    ph_s[nqv * PD_P_LD + i] = zero;
    pl_s[nqv * PD_P_LD + i] = zero;
  }
  // query vector v = r * g + hh: row r, head kvh * g + hh
  for (int i = tid; i < nqv * (hd >> 3); i += PD_THREADS) {
    const int v = i / (hd >> 3), d = (i - v * (hd >> 3)) * 8, r = v / g, hh = v - r * g;
    *reinterpret_cast<uint4*>(q_s + v * ld + d) = *reinterpret_cast<const uint4*>(
        a.q + (((long long)b * a.sq + r) * a.H + (long long)kvh * g + hh) * hd + d);
  }

  __syncthreads();  // the chunk's page ids, before the first tile's copies
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_tiles) {
      bf16* ks = kv_s + (size_t)s * 2 * PD_TILE * ld;
      pd_load_tile<4 * MTW>(a, pg_s, pi0, ctx, p_end, b, kvh, c0 + s * PD_TILE, t0, cd0, dt, dc, ks,
                   ks + PD_TILE * ld, ok_s + s * PD_TILE);
    }
    att_cp_commit();
  }

  // running softmax state of the vectors this warp owns (v = warp + 4 i),
  // the same in every lane; P.V accumulators: V^T rows (dims) x vectors
  float m_run[PD_QV_MAX / PD_WARPS], l_run[PD_QV_MAX / PD_WARPS];
#pragma unroll
  for (int i = 0; i < PD_QV_MAX / PD_WARPS; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  float acc[MTW][NT][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  // position of the row of each vector this lane's score fragments hold
  // (v = 8 n + 2 tig + e)
  int rowpos[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) rowpos[n][e] = ctx + (8 * n + 2 * tig + e) / g;

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
        bf16* ks = kv_s + (size_t)(jn % stages) * 2 * PD_TILE * ld;
        pd_load_tile<4 * MTW>(a, pg_s, pi0, ctx, p_end, b, kvh, c0 + jn * PD_TILE, t0, cd0, dt, dc,
                              ks,
                     ks + PD_TILE * ld, ok_s + (jn % stages) * PD_TILE);
      }
      att_cp_commit();
    }
    const bf16* ks = kv_s + (size_t)st * 2 * PD_TILE * ld;
    const bf16* vs = ks + PD_TILE * ld;
    const int* ok = ok_s + st * PD_TILE;
    const int p0 = c0 + j * PD_TILE;

    // 1. scores of keys [16 warp, 16 warp + 16) x all vectors
    {
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 64 * MTW; kk += 16) {
        if (kk < hdp) {
          unsigned af[4];
          pd_ldsm_x4(af, ks + (16 * warp + (lane & 15)) * ld + kk + (lane >> 4) * 8);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            unsigned b0, b1;
            pd_ldsm_x2(b0, b1, q_s + (8 * n + (lane & 7)) * ld + kk + ((lane >> 3) & 1) * 8);
            pd_mma(s[n], af, b0, b1);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * warp + gid + 8 * (e >> 1), v = 8 * n + 2 * tig + (e & 1);
          if (v < nqv) {
            const bool valid = ok[key] && p0 + key < rowpos[n][e & 1];
            sc_s[v * PD_SC_LD + key] = valid ? __fmul_rn(s[n][e], a.scale) : -INFINITY;
          }
        }
    }
    __syncthreads();

    // 2. the tile's softmax step, one warp per vector
#pragma unroll
    for (int i = 0; i < PD_QV_MAX / PD_WARPS; ++i) {
      const int v = warp + PD_WARPS * i;
      if (v >= nqv) break;
      const float s0 = sc_s[v * PD_SC_LD + lane], s1 = sc_s[v * PD_SC_LD + lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(ATT_FULL, mt, off));
      if (mt == -INFINITY) {  // no key of this tile precedes the row: not folded
        if (lane == 0) cf_s[v] = -1.f;
        continue;
      }
      const float m_new = fmaxf(m_run[i], mt);
      const float corr = expf(__fadd_rn(m_run[i], -m_new));
      const float p0f = expf(__fadd_rn(s0, -m_new));  // a masked key: exp(-inf) = 0
      const float p1f = expf(__fadd_rn(s1, -m_new));
      float ls = __fadd_rn(p0f, p1f);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ls = __fadd_rn(ls, __shfl_xor_sync(ATT_FULL, ls, off));
      l_run[i] = __fadd_rn(__fmul_rn(l_run[i], corr), ls);
      m_run[i] = m_new;
      const bf16 h0 = __float2bfloat16_rn(p0f), h1 = __float2bfloat16_rn(p1f);
      ph_s[v * PD_P_LD + lane] = h0;
      ph_s[v * PD_P_LD + lane + 32] = h1;
      pl_s[v * PD_P_LD + lane] = __float2bfloat16_rn(__fadd_rn(p0f, -__bfloat162float(h0)));
      pl_s[v * PD_P_LD + lane + 32] = __float2bfloat16_rn(__fadd_rn(p1f, -__bfloat162float(h1)));
      if (lane == 0) cf_s[v] = corr;
    }
    __syncthreads();

    // 3. P.V: V^T dims [16 (4 mt + warp), +16) x vectors, keys in k16 steps
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      const int dm = 16 * (PD_WARPS * mt + warp);
      if (dm >= hdp) break;
      float part[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < PD_TILE; kk += 16) {
        unsigned af[4];
        pd_ldsm_x4_t(af, vs + (kk + (lane & 7) + ((lane >> 4) << 3)) * ld + dm +
                             ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          unsigned h0, h1, l0, l1;
          const int off = (8 * n + (lane & 7)) * PD_P_LD + kk + ((lane >> 3) & 1) * 8;
          pd_ldsm_x2(h0, h1, ph_s + off);
          pd_ldsm_x2(l0, l1, pl_s + off);
          pd_mma(part[n], af, h0, h1);
          pd_mma(part[n], af, l0, l1);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int v = 8 * n + 2 * tig + (e & 1);
          if (v < nqv) {
            const float cf = cf_s[v];
            if (cf >= 0.f) acc[mt][n][e] = __fadd_rn(__fmul_rn(acc[mt][n][e], cf), part[n][e]);
          }
        }
    }
  }

  // the chunk's partials: (m, l) by lane 0 of the owning warp, acc by fragment
  const long long base = (((long long)b * a.KV + kvh) * a.nc + c) * nqv;
#pragma unroll
  for (int i = 0; i < PD_QV_MAX / PD_WARPS; ++i) {
    const int v = warp + PD_WARPS * i;
    if (v >= nqv) break;
    if (lane == 0) {
      a.part_ml[(base + v) * 2] = m_run[i];
      a.part_ml[(base + v) * 2 + 1] = l_run[i];
    }
  }
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) {
    const int dm = 16 * (PD_WARPS * mt + warp);
    if (dm >= hdp) break;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = 8 * n + 2 * tig + (e & 1), d = dm + gid + 8 * (e >> 1);
        if (v < nqv && d < hd) a.part_acc[(base + v) * hd + d] = acc[mt][n][e];
      }
  }
}

// Launch 2: per (slot, KV head, 4 query vectors), one warp per vector folds
// its chunks' partials in ascending order (loaded PD_CPF chunks at a time),
// then the self term, then the one rounding to bf16; blocks of the first
// vector tile then run the commit.
#define PD_CPF 8
template <int DPL>
__global__ void __launch_bounds__(PD_THREADS)
pd_combine_kernel(const PdArgs a, __nv_bfloat16* __restrict__ out, bf16* kp_w, bf16* vp_w,
                  int commit) {
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = a.H / a.KV, nqv = a.sq * g, hd = a.hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ctx = a.pos[b], s_max = a.maxp * a.page;
  const long long krow = (long long)a.KV * hd;
  const int v = blockIdx.z * PD_WARPS + warp;
  if (v < nqv) {
    const int r = v / g, hh = v - r * g;
    const bf16* qr = a.q + (((long long)b * a.sq + r) * a.H + (long long)kvh * g + hh) * hd;
    const bf16* kself = a.kt + ((long long)b * a.sq + r) * krow + (long long)kvh * hd;
    const bf16* vself = a.vt + ((long long)b * a.sq + r) * krow + (long long)kvh * hd;
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
    const float s = __fmul_rn(dot, a.scale);

    float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
    for (int k8 = 0; k8 < DPL; ++k8) acc[k8] = 0.f;
    const int n_c = (min(ctx + r, s_max) + a.chunk - 1) / a.chunk;  // chunks with its keys
    const long long base0 = ((long long)b * a.KV + kvh) * a.nc * nqv + v;
    for (int c0 = 0; c0 < n_c; c0 += PD_CPF) {
      float mc[PD_CPF], lc[PD_CPF], ac[PD_CPF][DPL];
#pragma unroll
      for (int u = 0; u < PD_CPF; ++u) {
        const long long base = base0 + (long long)(c0 + u) * nqv;
        const bool live = c0 + u < n_c;
        mc[u] = live ? a.part_ml[base * 2] : -INFINITY;
        lc[u] = live ? a.part_ml[base * 2 + 1] : 0.f;
#pragma unroll
        for (int k8 = 0; k8 < DPL; ++k8) {
          const int d = lane + 32 * k8;
          ac[u][k8] = live && d < hd ? a.part_acc[base * hd + d] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < PD_CPF; ++u) {
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
    bf16* o = out + (((long long)b * a.sq + r) * a.H + (long long)kvh * g + hh) * hd;
#pragma unroll
    for (int k8 = 0; k8 < DPL; ++k8) {
      const int d = lane + 32 * k8;
      if (d < hd) {
        const float af = __fadd_rn(__fmul_rn(acc[k8], corr), __fmul_rn(p, vs[k8]));
        o[d] = __float2bfloat16_rn(__fdiv_rn(af, lf));
      }
    }
  }
  if (!commit || blockIdx.z != 0) return;
  const bf16* kpanel = a.kt + (long long)b * a.sq * krow;
  const bf16* vpanel = a.vt + (long long)b * a.sq * krow;
  const int* bt_row = a.bt + (long long)b * a.maxp;
  for (int i = threadIdx.x; i < a.sq * hd; i += PD_THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int p = ctx + r, pi = p / a.page;
    if (pi >= a.maxp) continue;
    const int pg = bt_row[pi];
    if (pg < 0) continue;
    const long long dst = ((long long)pg * a.page + (p - pi * a.page)) * krow + (long long)kvh * hd + d;
    const long long src = (long long)r * krow + (long long)kvh * hd + d;
    kp_w[dst] = kpanel[src];
    vp_w[dst] = vpanel[src];
  }
}

template <int MTW, int NT>
static int launch_split(const PdArgs& a, int B, size_t smem, cudaStream_t st) {
  int err = attn_prepare(pd_split_kernel<MTW, NT>, smem);
  if (err) return err;
  // all of the SM's shared memory as such: two blocks an SM where they fit
  err = (int)cudaFuncSetAttribute(pd_split_kernel<MTW, NT>,
                                  cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err) return err;
  pd_split_kernel<MTW, NT><<<dim3(a.nc, a.KV, B), PD_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int MTW>
static int launch_split_nt(const PdArgs& a, int B, int nt, size_t smem, cudaStream_t st) {
  switch (nt) {
    case 1: return launch_split<MTW, 1>(a, B, smem, st);
    case 2: return launch_split<MTW, 2>(a, B, smem, st);
    case 3: return launch_split<MTW, 3>(a, B, smem, st);
    default: return launch_split<MTW, 4>(a, B, smem, st);
  }
}

template <int DPL>
static int launch_combine(const PdArgs& a, int B, bf16* out, bf16* kp, bf16* vp, int commit,
                          cudaStream_t st) {
  const int nqv = a.sq * (a.H / a.KV);
  pd_combine_kernel<DPL><<<dim3(B, a.KV, (nqv + PD_WARPS - 1) / PD_WARPS), PD_THREADS, 0, st>>>(
      a, out, kp, vp, commit);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the split launch for (hd, query vectors a
// block); the launch contract mirrors it.
extern "C" int paged_decode_smem_bytes(int hd, int nqv) {
  const int nt = (nqv + 7) / 8;
  return (int)pd_smem_bytes(hd, nt, pd_stages(hd, nt));
}

// q (B, sq, H, hd), kp/vp (P, page, KV, hd), kt/vt (B, sq, KV, hd), all bf16
// contiguous; bt (B, maxp) and pos (B,) int32; out (B, sq, H, hd) bf16;
// scratch: B * KV * nc * sq * H/KV * (hd + 2) f32, nc = ceil(maxp * page /
// chunk), chunk a multiple of 64. Returns the cudaError of the launches (0
// on success).
extern "C" int paged_decode(const void* q, void* kp, void* vp, const void* kt, const void* vt,
                            const void* bt, const void* pos, void* out, void* scratch, int B,
                            int sq, int H, int KV, int hd, int maxp, int page, int chunk,
                            float scale, int commit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nqv = sq * (H / KV), nt = (nqv + 7) / 8, hdp = pd_hdp(hd);
  PdArgs a;
  a.q = (const bf16*)q;
  a.kp = (const bf16*)kp;
  a.vp = (const bf16*)vp;
  a.kt = (const bf16*)kt;
  a.vt = (const bf16*)vt;
  a.bt = (const int*)bt;
  a.pos = (const int*)pos;
  a.sq = sq;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.maxp = maxp;
  a.page = page;
  a.chunk = chunk;
  a.pshift = (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1;
  a.nc = (maxp * page + chunk - 1) / chunk;
  a.stages = pd_stages(hd, nt);
  a.scale = scale;
  a.part_acc = (float*)scratch;
  a.part_ml = a.part_acc + (size_t)B * KV * a.nc * nqv * hd;
  const size_t smem = pd_smem_bytes(hd, nt, a.stages);
  int err = hdp <= 64    ? launch_split_nt<1>(a, B, nt, smem, st)
            : hdp <= 128 ? launch_split_nt<2>(a, B, nt, smem, st)
                         : launch_split_nt<4>(a, B, nt, smem, st);
  if (err) return err;
  bf16 *o = (bf16*)out, *kw = (bf16*)kp, *vw = (bf16*)vp;
  switch (attn_dpl(hd)) {
    case 1: return launch_combine<1>(a, B, o, kw, vw, commit, st);
    case 2: return launch_combine<2>(a, B, o, kw, vw, commit, st);
    case 4: return launch_combine<4>(a, B, o, kw, vw, commit, st);
    default: return launch_combine<8>(a, B, o, kw, vw, commit, st);
  }
}
