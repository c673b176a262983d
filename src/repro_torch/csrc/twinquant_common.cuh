// Shared pieces of the dual-component TwinQuant kernels for Hopper (sm_90a):
// the segment table, the expert axis, cp.async / ldmatrix / int8 MMA helpers,
// the in-register nibble unpack, activation quantization and H requantization.
//
// The expert axis (an MoE layer's experts in one launch, the counterpart of
// the reference's vmap over its pallas_call): every kernel runs gridDim.z = E
// and offsets each pointer by blockIdx.z times that operand's per-expert
// element stride (TqExp; all zero for E = 1) at its top. The segment table is
// the same for every expert, and nothing crosses experts, so an expert's
// slice of a launch is that expert launched alone, bit for bit.
//
// Arithmetic contract (held bit for bit against the plain PyTorch versions
// in repro_torch/kernels/ref.py):
//   * scale = amax > 0 ? amax / qmax : 1, with IEEE division (__fdiv_rn);
//   * q = clamp(rintf(x / scale), -qmax, qmax)  (rintf rounds half to even);
//   * a scale group's int dot is exact in int32 whatever its order;
//   * for every output, acc = acc + ((float)dot * s_a) * s_w over the groups
//     in ascending order, starting from 0, written with __fmul_rn/__fadd_rn
//     so nvcc cannot contract it; one thread owns each output's chain, or
//     the per-group terms are stored and one thread adds them in order.
// Build without --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TQ_MAX_SEGS 4
#define TQ_MMAX 8  // the decode panel: at most 8 token rows

// Fused sibling group geometry (a single pack is one segment). Passed by
// value to the kernels.
struct TqSegs {
  int n;                          // number of segments
  int n_off[TQ_MAX_SEGS];         // column offset of segment j in the output
  int n_len[TQ_MAX_SEGS];         // N_j
  int r_off[TQ_MAX_SEGS];         // rank offset of segment j in the stacked H
  int r_len[TQ_MAX_SEGS];         // r_j
  int rgroup[TQ_MAX_SEGS];        // gr_j
  int hs_off[TQ_MAX_SEGS];        // first H-scale column of segment j
  int t_off[TQ_MAX_SEGS + 1];     // first column tile of segment j (tq_set_tiles)
  const int8_t* vp[TQ_MAX_SEGS];  // (r_j/2, N_j) packed
  const float* vs[TQ_MAX_SEGS];   // (r_j/gr_j, N_j)
};

// Per-expert element strides of a launch over an expert axis.
struct TqExp {
  long long x, up, us, rp, rs;      // activation and pack tensors
  long long xq, xs, hf, hq, hs;     // scratch
  long long out;
  long long vp[TQ_MAX_SEGS], vs[TQ_MAX_SEGS];
};

// From the host array: x, up, us, rp, rs, xq, xs, hf, hq, hs, out, then vp
// and vs of each of TQ_MAX_SEGS segments.
static inline TqExp tq_make_exp(const long long* s) {
  TqExp e;
  e.x = s[0];
  e.up = s[1];
  e.us = s[2];
  e.rp = s[3];
  e.rs = s[4];
  e.xq = s[5];
  e.xs = s[6];
  e.hf = s[7];
  e.hq = s[8];
  e.hs = s[9];
  e.out = s[10];
  for (int j = 0; j < TQ_MAX_SEGS; ++j) {
    e.vp[j] = s[11 + j];
    e.vs[j] = s[11 + TQ_MAX_SEGS + j];
  }
  return e;
}

static inline TqSegs tq_make_segs(int n_seg, const long long* info,
                                  const void* const* vps, const void* const* vss) {
  // info holds 5 ints per segment: n_off, n_len, r_off, r_len, rgroup
  TqSegs s;
  s.n = n_seg;
  int hs = 0;
  for (int j = 0; j < TQ_MAX_SEGS; ++j) {
    if (j < n_seg) {
      s.n_off[j] = (int)info[5 * j + 0];
      s.n_len[j] = (int)info[5 * j + 1];
      s.r_off[j] = (int)info[5 * j + 2];
      s.r_len[j] = (int)info[5 * j + 3];
      s.rgroup[j] = (int)info[5 * j + 4];
      s.hs_off[j] = hs;
      hs += s.r_len[j] / s.rgroup[j];
      s.vp[j] = (const int8_t*)vps[j];
      s.vs[j] = (const float*)vss[j];
    } else {
      s.n_off[j] = s.n_len[j] = s.r_off[j] = s.r_len[j] = 0;
      s.rgroup[j] = 1;
      s.hs_off[j] = hs;
      s.vp[j] = nullptr;
      s.vs[j] = nullptr;
    }
  }
  for (int j = 0; j <= TQ_MAX_SEGS; ++j) s.t_off[j] = 0;
  return s;
}

// Column tiles of width bn per segment, the last one of a segment masked:
// segment j owns tiles [t_off[j], t_off[j+1]). Returns the tile count.
static inline int tq_set_tiles(TqSegs& s, int bn) {
  int t = 0;
  for (int j = 0; j < TQ_MAX_SEGS; ++j) {
    s.t_off[j] = t;
    if (j < s.n) t += (s.n_len[j] + bn - 1) / bn;
  }
  s.t_off[TQ_MAX_SEGS] = t;
  return t;
}

static inline int tq_hs_cols(const TqSegs& s) {
  int hs = 0;
  for (int j = 0; j < s.n; ++j) hs += s.r_len[j] / s.rgroup[j];
  return hs;
}

// ---------------------------------------------------------------------------
// copies, fragments, MMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned tq_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !ok (src must
// still be a valid address).
__device__ __forceinline__ void tq_cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(tq_smem(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void tq_cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(tq_smem(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void tq_cp_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void tq_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void tq_ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tq_smem(p)));
}

// d += A (16 x 32, row) * B (32 x 8, col), int8 in, int32 accumulate
__device__ __forceinline__ void tq_mma(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Nibble unpack in place of a sign extension: each byte of the result is 16
// times the sign-extended low (tq_lo16) or high (tq_hi16) nibble of the
// same byte of p, as an int8. A dot of such bytes with int8 activations is
// exactly 16 times the true dot (see tq_term).
__device__ __forceinline__ unsigned tq_lo16(unsigned p) { return (p << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ unsigned tq_hi16(unsigned p) { return p & 0xF0F0F0F0u; }

// 4 x 4 byte transpose: c[q] byte i = w[i] byte q.
__device__ __forceinline__ void tq_transpose4(const unsigned (&w)[4], unsigned (&c)[4]) {
  const unsigned t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// ---------------------------------------------------------------------------
// quantization
// ---------------------------------------------------------------------------

__device__ __forceinline__ float tq_scale(float amax, int qmax) {
  return amax > 0.f ? __fdiv_rn(amax, (float)qmax) : 1.f;
}

__device__ __forceinline__ int8_t tq_quant(float v, float scale, int qmax) {
  float q = rintf(__fdiv_rn(v, scale));
  q = fminf(fmaxf(q, (float)-qmax), (float)qmax);
  return (int8_t)(int)q;
}

// Every int8 MMA accumulator of a task starts from TQ_DOT_BIAS, the bits of
// 1.5 * 2^19, whose ULP is 1/16: the MMA then leaves d = TQ_DOT_BIAS + 16 x
// dot (the sum of tq_lo16 / tq_hi16 bytes), and __int_as_float(d) is 1.5 *
// 2^19 + dot exactly for |16 dot| < 2^22 (|dot| <= 127 * 8 * 128 here). So
// (float)dot costs one exact subtraction and no conversion instruction (1/8
// of the FP32 rate on sm_90).
#define TQ_DOT_BIAS 0x49400000
#define TQ_DOT_BASE 786432.0f

// ((float)dot * sa) * sw, uncontracted: one group's term, from d as above.
__device__ __forceinline__ float tq_term(int d, float sa, float sw) {
  const float dot = __fsub_rn(__int_as_float(d), TQ_DOT_BASE);
  return __fmul_rn(__fmul_rn(dot, sa), sw);
}

__device__ __forceinline__ float tq_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// X (M, K) bf16 -> Xq (M, K) int8 + xs (M, K/G) f32. One warp per (m, g);
// a lane keeps its <= 4 values (G <= 128) in registers between the amax and
// the quantization. blockIdx.z: the expert (strides sx, sxq, sxs).
__global__ void tq_quantize_act(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                                float* __restrict__ xs, int M, int K, int G, int qmax,
                                long long sx, long long sxq, long long sxs) {
  const size_t z = blockIdx.z;
  x += z * sx;
  xq += z * sxq;
  xs += z * sxs;
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  int ng = K / G;
  if (warp >= M * ng) return;
  int m = warp / ng, g = warp % ng;
  const __nv_bfloat16* row = x + (size_t)m * K + (size_t)g * G;
  int8_t* qrow = xq + (size_t)m * K + (size_t)g * G;
  float v[4];
  float amax = 0.f;
  if (G == 128 && ((((uintptr_t)row) | ((uintptr_t)qrow)) & 7) == 0) {
    const uint2 raw = *(const uint2*)(row + 4 * lane);
    const __nv_bfloat16* b = (const __nv_bfloat16*)&raw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = __bfloat162float(b[i]);
      amax = fmaxf(amax, fabsf(v[i]));
    }
    const float scale = tq_scale(tq_warp_max(amax), qmax);
    unsigned q = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) q |= (unsigned)(uint8_t)tq_quant(v[i], scale, qmax) << (8 * i);
    *(unsigned*)(qrow + 4 * lane) = q;
    if (lane == 0) xs[(size_t)m * ng + g] = scale;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < G ? __bfloat162float(row[e]) : 0.f;
    amax = fmaxf(amax, fabsf(v[i]));
  }
  const float scale = tq_scale(tq_warp_max(amax), qmax);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = lane + 32 * i;
    if (e < G) qrow[e] = tq_quant(v[i], scale, qmax);
  }
  if (lane == 0) xs[(size_t)m * ng + g] = scale;
}

// H = sum over t of terms[t] (each (M, R) f32, t ascending, from 0), then
// H -> Hq (M, R) int8 + hs (M, sum_j r_j/gr_j) f32, each segment with its
// own rank groups. One block (128 threads) per (m, H group); gr <= 128, so
// one column a thread. blockIdx.z: the expert (strides st, shq, shs).
__global__ void tq_requant_h(const float* __restrict__ terms, int n_terms,
                             int8_t* __restrict__ hq, float* __restrict__ hs, int M, int R,
                             int hs_cols, TqSegs segs, int qmax, long long st, long long shq,
                             long long shs) {
  __shared__ float red[4];
  const size_t z = blockIdx.z;
  terms += z * st;
  hq += z * shq;
  hs += z * shs;
  int m = blockIdx.y;
  int hcol = blockIdx.x;
  int j = 0;
  for (int t = 1; t < segs.n; ++t)
    if (hcol >= segs.hs_off[t]) j = t;
  int gg = hcol - segs.hs_off[j];
  int gr = segs.rgroup[j];
  int c = segs.r_off[j] + gg * gr + threadIdx.x;
  const bool mine = (int)threadIdx.x < gr;
  float h = 0.f;
  if (mine) {
    const float* p = terms + (size_t)m * R + c;
    const size_t plane = (size_t)M * R;
#pragma unroll 16
    for (int t = 0; t < n_terms; ++t) h = __fadd_rn(h, p[(size_t)t * plane]);
  }
  float amax = tq_warp_max(mine ? fabsf(h) : 0.f);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  float scale = tq_scale(amax, qmax);
  if (mine) hq[(size_t)m * R + c] = tq_quant(h, scale, qmax);
  if (threadIdx.x == 0) hs[(size_t)m * hs_cols + hcol] = scale;
}

// Allow `bytes` of dynamic shared memory for kernel `fn`, once per device.
static inline int tq_smem_attr(const void* fn, int bytes) {
  static const void* done[64][4];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  dev &= 63;
  for (int i = 0; i < 4; ++i) {
    if (done[dev][i] == fn) return 0;
    if (done[dev][i] == nullptr) {
      err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (!err) done[dev][i] = fn;
      return err;
    }
  }
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

static inline int tq_launch_quantize(const void* x, void* xq, void* xs, int E, int M, int K,
                                     int G, int qmax, const TqExp& ex, cudaStream_t st) {
  int warps = M * (K / G);
  int threads = 256;
  dim3 grid((warps * 32 + threads - 1) / threads, 1, E);
  tq_quantize_act<<<grid, threads, 0, st>>>((const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs, M,
                                            K, G, qmax, ex.x, ex.xq, ex.xs);
  return (int)cudaGetLastError();
}

static inline int tq_launch_requant(const float* terms, int n_terms, void* hq, void* hs, int E,
                                    int M, int R, const TqSegs& segs, int qmax, const TqExp& ex,
                                    cudaStream_t st) {
  int cols = tq_hs_cols(segs);
  dim3 grid(cols, M, E);
  tq_requant_h<<<grid, 128, 0, st>>>(terms, n_terms, (int8_t*)hq, (float*)hs, M, R, cols, segs,
                                     qmax, ex.hf, ex.hq, ex.hs);
  return (int)cudaGetLastError();
}
