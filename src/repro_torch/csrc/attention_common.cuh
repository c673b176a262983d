// Shared body of the block-table attention kernels (paged_attention.cu,
// ragged_attention.cu) for Hopper, sm_90a.
//
// Both kernels attend, for one slot and one KV head, a run of consecutive
// query rows: row r of the run sits at absolute position ctx + r, where ctx
// is the slot's committed prefix length. Row r sees
//   * the committed keys [0, ctx), read from the slot's pages through its
//     block-table row (an unmapped page, -1, gives no keys), and
//   * the earlier rows of the run, [ctx, ctx + r), read from the launch's
//     own K/V rows (the draft panel, or the slot's in-batch rows),
// and then itself. All g = H/KV query heads of the KV head are handled by
// the same block, so each K/V tile is read once for all of them.
//
// Fold order. Keys are folded into an online softmax (running max m, sum l,
// f32 accumulator) in tiles of absolute positions [j*page, (j+1)*page),
// wherever each key lives, and the self term is folded last. A row's
// arithmetic therefore depends only on its position and the key values, not
// on where the keys came from or on how many rows share the launch: a row of
// a stacked draft launch equals the row a one-row launch computes once the
// earlier drafts sit in pages, and a prompt row's output does not depend on
// how the prompt was chunked. Every add, multiply and exp is an explicit
// round-to-nearest intrinsic (no contraction choices left to the compiler),
// and a tile with no valid key for a row is skipped, not folded as zeros.
//
// Memory: tiles are copied global -> shared with cp.async into two buffers,
// the next tile's copy in flight while the current one is folded.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ATT_WARPS 4
#define ATT_THREADS (ATT_WARPS * 32)
#define ATT_QV_MAX 32                  // query vectors (rows x heads) a block
#define ATT_QPW (ATT_QV_MAX / ATT_WARPS)  // query vectors a warp
#define ATT_PAGE_MAX 64
#define ATT_FULL 0xffffffffu

struct AttnRun {
  const int* bt_row;  // the slot's block-table row, maxp entries (-1 unmapped)
  int maxp, page, ctx;
  const __nv_bfloat16* kp;  // pools (P, page, KV, hd)
  const __nv_bfloat16* vp;
  const __nv_bfloat16* kpanel;  // run row r (position ctx + r) at kpanel + r * KV * hd
  const __nv_bfloat16* vpanel;
  int n_panel;  // rows of the run present in the launch
  int r0, nr;   // the rows [r0, r0 + nr) this block answers
  const __nv_bfloat16* q;  // run row r, head h at q + r * H * hd + h * hd
  __nv_bfloat16* out;      // same layout as q
  int kvh, KV, g, hd;
  float scale;
};

// Dynamic shared memory of one block (bytes); the launch contract checks it.
inline size_t attn_smem_bytes(int page, int hd) {
  return (size_t)ATT_QV_MAX * hd * sizeof(float)                 // queries, f32
         + (size_t)2 * 2 * page * hd * sizeof(__nv_bfloat16)    // K, V x 2 buffers
         + (size_t)2 * page * sizeof(int);                      // key valid flags
}

__device__ __forceinline__ void att_cp16(void* smem, const void* gmem, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void att_cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void att_cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Start the copy of tile j (positions [j*page, (j+1)*page)) into buffer buf.
__device__ __forceinline__ void att_load_tile(const AttnRun& a, int j, __nv_bfloat16* ks,
                                              __nv_bfloat16* vs, int* ok) {
  const int hd = a.hd, page = a.page, c8 = hd / 8;
  const long long row = (long long)a.KV * hd;
  const int pg = (j < a.maxp) ? a.bt_row[j] : -1;
  for (int i = threadIdx.x; i < page * c8; i += ATT_THREADS) {
    const int t = i / c8, d = (i - t * c8) * 8;
    const int p = j * page + t;
    const __nv_bfloat16 *ksrc = a.kp, *vsrc = a.vp;
    bool valid;
    if (p < a.ctx) {
      valid = pg >= 0;
      if (valid) {
        const long long off = ((long long)pg * page + t) * row + (long long)a.kvh * hd + d;
        ksrc = a.kp + off;
        vsrc = a.vp + off;
      }
    } else {
      const int r = p - a.ctx;
      valid = r < a.n_panel;
      if (valid) {
        const long long off = (long long)r * row + (long long)a.kvh * hd + d;
        ksrc = a.kpanel + off;
        vsrc = a.vpanel + off;
      }
    }
    att_cp16(ks + t * hd + d, ksrc, valid);
    att_cp16(vs + t * hd + d, vsrc, valid);
    if (d == 0) ok[t] = valid ? 1 : 0;
  }
  att_cp_commit();
}

// Scores of keys t0 .. t0 + ATT_KU - 1 (those < page) against the query
// held in registers: per key a dot over the lane's dims d = lane + 32 k,
// then a butterfly sum (every lane ends with the same bits: each level adds
// a commutative pair). The ATT_KU keys' chains are independent, so they
// overlap; each key's own operation order does not depend on the grouping.
#define ATT_KU 8
template <int DPL>
__device__ __forceinline__ void att_scores(const float (&q)[DPL], const __nv_bfloat16* ks,
                                           int t0, int page, int hd, int lane,
                                           float (&s)[ATT_KU]) {
#pragma unroll
  for (int u = 0; u < ATT_KU; ++u) {
    float dot = 0.f;
    if (t0 + u < page) {
#pragma unroll
      for (int k8 = 0; k8 < DPL; ++k8) {
        const int d = lane + 32 * k8;
        if (d < hd) dot = __fmaf_rn(q[k8], __bfloat162float(ks[(t0 + u) * hd + d]), dot);
      }
    }
    s[u] = dot;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int u = 0; u < ATT_KU; ++u) s[u] = __fadd_rn(s[u], __shfl_xor_sync(ATT_FULL, s[u], off));
  }
}

template <int DPL>
__device__ void attend_run(const AttnRun& a, unsigned char* smem) {
  const int hd = a.hd, page = a.page, g = a.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nqv = a.nr * g;
  const int H = a.KV * g;
  float* q_s = reinterpret_cast<float*>(smem);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(q_s + ATT_QV_MAX * hd);
  int* ok_s = reinterpret_cast<int*>(kv_s + 4 * page * hd);

  // query vector v = r * g + hh: run row r0 + r, head kvh * g + hh
  for (int i = threadIdx.x; i < nqv * hd; i += ATT_THREADS) {
    const int v = i / hd, d = i - v * hd, r = v / g, hh = v - r * g;
    q_s[i] = __bfloat162float(
        a.q[(long long)(a.r0 + r) * H * hd + (long long)(a.kvh * g + hh) * hd + d]);
  }

  float m[ATT_QPW], l[ATT_QPW], acc[ATT_QPW][DPL];
#pragma unroll
  for (int j = 0; j < ATT_QPW; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < DPL; ++k8) acc[j][k8] = 0.f;
  }

  // keys some row needs: [0, position of the last row); self is folded apart
  const int p_end = a.ctx + a.r0 + a.nr - 1;
  const int n_tiles = (p_end + page - 1) / page;
  if (n_tiles > 0) att_load_tile(a, 0, kv_s, kv_s + page * hd, ok_s);
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    __nv_bfloat16* ks = kv_s + buf * 2 * page * hd;
    __nv_bfloat16* vs = ks + page * hd;
    const int* ok = ok_s + buf * page;
    att_cp_wait_all();
    __syncthreads();  // tile j (and, on j == 0, the queries) visible to all
    if (j + 1 < n_tiles) {
      __nv_bfloat16* kn = kv_s + (buf ^ 1) * 2 * page * hd;
      att_load_tile(a, j + 1, kn, kn + page * hd, ok_s + (buf ^ 1) * page);
    }
#pragma unroll
    for (int jq = 0; jq < ATT_QPW; ++jq) {
      const int v = warp + ATT_WARPS * jq;
      if (v >= nqv) break;
      const int p_row = a.ctx + a.r0 + v / g;
      if (j * page >= p_row) continue;  // no key of this tile precedes the row
      float qr[DPL];
#pragma unroll
      for (int k8 = 0; k8 < DPL; ++k8) {
        const int d = lane + 32 * k8;
        qr[k8] = d < hd ? q_s[v * hd + d] : 0.f;
      }
      // pass 1: scores; lane t & 31 keeps key t's score (s_lo: t < 32)
      float s_lo = -INFINITY, s_hi = -INFINITY, mt = -INFINITY;
      for (int t0 = 0; t0 < page; t0 += ATT_KU) {
        float sc[ATT_KU];
        att_scores<DPL>(qr, ks, t0, page, hd, lane, sc);
#pragma unroll
        for (int u = 0; u < ATT_KU; ++u) {
          const int t = t0 + u;
          const float s = __fmul_rn(sc[u], a.scale);
          const bool valid = t < page && (j * page + t < p_row) && ok[t];
          if (valid) mt = fmaxf(mt, s);
          if ((t & 31) == lane) {
            if (t < 32) s_lo = valid ? s : -INFINITY;
            else s_hi = valid ? s : -INFINITY;
          }
        }
      }
      if (mt == -INFINITY) continue;  // e.g. an unmapped page
      const float m_new = fmaxf(m[jq], mt);
      const float corr = expf(__fadd_rn(m[jq], -m_new));
      // pass 2: probabilities and values, keys in position order
      float lsum = 0.f, part[DPL];
#pragma unroll
      for (int k8 = 0; k8 < DPL; ++k8) part[k8] = 0.f;
      for (int t0 = 0; t0 < page; t0 += ATT_KU) {
        float pr[ATT_KU];
#pragma unroll
        for (int u = 0; u < ATT_KU; ++u) {
          const int t = t0 + u;
          const float s = __shfl_sync(ATT_FULL, t < 32 ? s_lo : s_hi, t & 31);
          pr[u] = (t < page && s != -INFINITY) ? expf(__fadd_rn(s, -m_new)) : -1.f;
        }
#pragma unroll
        for (int u = 0; u < ATT_KU; ++u) {
          if (pr[u] < 0.f) continue;  // masked key: not folded at all
          lsum = __fadd_rn(lsum, pr[u]);
#pragma unroll
          for (int k8 = 0; k8 < DPL; ++k8) {
            const int d = lane + 32 * k8;
            if (d < hd)
              part[k8] = __fmaf_rn(pr[u], __bfloat162float(vs[(t0 + u) * hd + d]), part[k8]);
          }
        }
      }
      l[jq] = __fadd_rn(__fmul_rn(l[jq], corr), lsum);
#pragma unroll
      for (int k8 = 0; k8 < DPL; ++k8) acc[jq][k8] = __fadd_rn(__fmul_rn(acc[jq][k8], corr), part[k8]);
      m[jq] = m_new;
    }
  }
  if (n_tiles == 0) __syncthreads();  // the queries, when no tile ran

  // the self term, folded last; then the one rounding to bf16
  const long long krow = (long long)a.KV * hd;
#pragma unroll
  for (int jq = 0; jq < ATT_QPW; ++jq) {
    const int v = warp + ATT_WARPS * jq;
    if (v >= nqv) break;
    const int r = a.r0 + v / g, hh = v - (v / g) * g;
    const __nv_bfloat16* kself = a.kpanel + (long long)r * krow + (long long)a.kvh * hd;
    const __nv_bfloat16* vself = a.vpanel + (long long)r * krow + (long long)a.kvh * hd;
    float qr[DPL], sc[ATT_KU];
#pragma unroll
    for (int k8 = 0; k8 < DPL; ++k8) {
      const int d = lane + 32 * k8;
      qr[k8] = d < hd ? q_s[v * hd + d] : 0.f;
    }
    att_scores<DPL>(qr, kself, 0, 1, hd, lane, sc);  // one key: the row itself
    const float s = __fmul_rn(sc[0], a.scale);
    const float m_new = fmaxf(m[jq], s);
    const float corr = expf(__fadd_rn(m[jq], -m_new));
    const float p = expf(__fadd_rn(s, -m_new));
    const float lf = __fadd_rn(__fmul_rn(l[jq], corr), p);
    __nv_bfloat16* o = a.out + (long long)r * H * hd + (long long)(a.kvh * g + hh) * hd;
#pragma unroll
    for (int k8 = 0; k8 < DPL; ++k8) {
      const int d = lane + 32 * k8;
      if (d < hd) {
        const float af = __fadd_rn(__fmul_rn(acc[jq][k8], corr),
                                   __fmul_rn(p, __bfloat162float(vself[d])));
        o[d] = __float2bfloat16_rn(__fdiv_rn(af, lf));
      }
    }
  }
}

// ceil(hd / 32) rounded up to a compiled lane width
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
