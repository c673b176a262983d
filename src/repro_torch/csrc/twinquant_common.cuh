// Shared pieces of the dual-component TwinQuant kernels for Hopper (sm_90a):
// the segment table, activation quantization and H requantization.
//
// Arithmetic contract (held bit for bit against the plain PyTorch versions
// in repro_torch/kernels/ref.py):
//   * scale = amax > 0 ? amax / qmax : 1, with IEEE division (__fdiv_rn);
//   * q = clamp(rintf(x / scale), -qmax, qmax)  (rintf rounds half to even);
//   * int4 nibbles are sign-extended to int, dots accumulate in int32;
//   * across groups acc = acc + ((float)dot * s_a) * s_w in ascending group
//     order, written with __fmul_rn/__fadd_rn so nvcc cannot contract it.
// Build without --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TQ_MAX_SEGS 4

// Fused sibling group geometry (a single pack is one segment). Passed by
// value to the kernels.
struct TqSegs {
  int n;                       // number of segments
  int n_off[TQ_MAX_SEGS];      // column offset of segment j in the output
  int n_len[TQ_MAX_SEGS];      // N_j
  int r_off[TQ_MAX_SEGS];      // rank offset of segment j in the stacked H
  int r_len[TQ_MAX_SEGS];      // r_j
  int rgroup[TQ_MAX_SEGS];     // gr_j
  int hs_off[TQ_MAX_SEGS];     // first H-scale column of segment j
  const int8_t* vp[TQ_MAX_SEGS];  // (r_j/2, N_j) packed
  const float* vs[TQ_MAX_SEGS];   // (r_j/gr_j, N_j)
};

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
  return s;
}

static inline int tq_hs_cols(const TqSegs& s) {
  int hs = 0;
  for (int j = 0; j < s.n; ++j) hs += s.r_len[j] / s.rgroup[j];
  return hs;
}

// Segment that owns output column c (tiles never straddle segments).
__device__ __forceinline__ int tq_owner(const TqSegs& s, int c) {
  int j = 0;
#pragma unroll
  for (int t = 1; t < TQ_MAX_SEGS; ++t)
    if (t < s.n && c >= s.n_off[t]) j = t;
  return j;
}

// sign-extended low / high nibble of a packed byte (only its low 8 bits count)
__device__ __forceinline__ int tq_sext_lo(int b) { return ((int)((unsigned)b << 28)) >> 28; }
__device__ __forceinline__ int tq_sext_hi(int b) { return ((int)((unsigned)b << 24)) >> 28; }

__device__ __forceinline__ float tq_scale(float amax, int qmax) {
  return amax > 0.f ? __fdiv_rn(amax, (float)qmax) : 1.f;
}

__device__ __forceinline__ int8_t tq_quant(float v, float scale, int qmax) {
  float q = rintf(__fdiv_rn(v, scale));
  q = fminf(fmaxf(q, (float)-qmax), (float)qmax);
  return (int8_t)(int)q;
}

// acc + ((float)dot * sa) * sw, uncontracted
__device__ __forceinline__ float tq_acc(float acc, int dot, float sa, float sw) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn((float)dot, sa), sw));
}

__device__ __forceinline__ float tq_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// X (M, K) bf16 -> Xq (M, K) int8 + xs (M, K/G) f32. One warp per (m, g).
__global__ void tq_quantize_act(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                                float* __restrict__ xs, int M, int K, int G, int qmax) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  int ng = K / G;
  if (warp >= M * ng) return;
  int m = warp / ng, g = warp % ng;
  const __nv_bfloat16* row = x + (size_t)m * K + (size_t)g * G;
  float amax = 0.f;
  for (int i = lane; i < G; i += 32) amax = fmaxf(amax, fabsf(__bfloat162float(row[i])));
  amax = tq_warp_max(amax);
  float scale = tq_scale(amax, qmax);
  int8_t* qrow = xq + (size_t)m * K + (size_t)g * G;
  for (int i = lane; i < G; i += 32) qrow[i] = tq_quant(__bfloat162float(row[i]), scale, qmax);
  if (lane == 0) xs[(size_t)m * ng + g] = scale;
}

// H (M, R) f32 -> Hq (M, R) int8 + hs (M, sum_j r_j/gr_j) f32, each
// segment with its own rank groups. One block (128 threads) per (m, H group).
__global__ void tq_requant_h(const float* __restrict__ h, int8_t* __restrict__ hq,
                             float* __restrict__ hs, int M, int R, int hs_cols, TqSegs segs,
                             int qmax) {
  __shared__ float red[4];
  int m = blockIdx.y;
  int hcol = blockIdx.x;
  int j = 0;
  for (int t = 1; t < segs.n; ++t)
    if (hcol >= segs.hs_off[t]) j = t;
  int gg = hcol - segs.hs_off[j];
  int gr = segs.rgroup[j];
  int c0 = segs.r_off[j] + gg * gr;
  const float* hrow = h + (size_t)m * R + c0;
  float amax = 0.f;
  for (int i = threadIdx.x; i < gr; i += blockDim.x) amax = fmaxf(amax, fabsf(hrow[i]));
  amax = tq_warp_max(amax);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  float scale = tq_scale(amax, qmax);
  for (int i = threadIdx.x; i < gr; i += blockDim.x)
    hq[(size_t)m * R + c0 + i] = tq_quant(hrow[i], scale, qmax);
  if (threadIdx.x == 0) hs[(size_t)m * hs_cols + hcol] = scale;
}

static inline int tq_launch_quantize(const void* x, void* xq, void* xs, int M, int K, int G,
                                     int qmax, cudaStream_t st) {
  int warps = M * (K / G);
  int threads = 256;
  int blocks = (warps * 32 + threads - 1) / threads;
  tq_quantize_act<<<blocks, threads, 0, st>>>((const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs,
                                              M, K, G, qmax);
  return (int)cudaGetLastError();
}

static inline int tq_launch_requant(const float* h, void* hq, void* hs, int M, int R,
                                    const TqSegs& segs, int qmax, cudaStream_t st) {
  int cols = tq_hs_cols(segs);
  dim3 grid(cols, M);
  tq_requant_h<<<grid, 128, 0, st>>>(h, (int8_t*)hq, (float*)hs, M, R, cols, segs, qmax);
  return (int)cudaGetLastError();
}
