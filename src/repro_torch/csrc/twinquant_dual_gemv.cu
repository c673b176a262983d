// Decode-shaped dual-component TwinQuant GEMV (M <= 8) for Hopper, sm_90a.
//
// Replaces: repro/kernels/twinquant_dual_gemv.py : dual_gemv (body
// _dual_gemv_kernel) and dual_gemv_group. One C entry serves both; a single
// pack is a one-segment group.
//
//   Y = dq(Xq Rq) + dq(requant(dq(Xq Uq)) Vq)
//
// What bounds it: bytes. At M = 8 the work is ~16 int ops per packed weight
// byte, far below the card's ops/byte balance, so the least time is the
// packed residual Rq (K/2 x N) plus its scales rs (K/G x N f32) read once
// over the memory rate.
//
// Design. The TPU kernel keeps Xq and Hq in VMEM scratch across a
// sequential N grid; CUDA blocks over N run concurrently and share nothing.
// So the front half runs as a prologue of small launches that leave their
// results in global memory (the wrapper allocates them):
//   1. tq_quantize_act: X -> Xq (M x K int8), xs (M x K/G);
//   2. tq_gemv with W = Uq: H = dq(Xq Uq) in f32 (M x R);
//   3. tq_requant_h: H -> Hq, hs, each segment with its own rank groups;
// then the main launch, tq_gemv with W = Rq plus the V epilogue of the
// segment that owns the block, writes bf16 once.
//
// tq_gemv: one block of 8 warps per BN = 32 output columns, one column per
// lane (so a warp reads 32 contiguous packed bytes per weight row). The 8
// warps take 8 consecutive K groups at once; each computes its group's exact
// int32 dots for all M rows and the scaled term (dot * s_a) * s_w, parks it
// in shared memory, and after a barrier the terms are added into the f32
// accumulators in ascending group order — the order of the plain version, so
// the result is bit-identical to it.
#include "twinquant_common.cuh"

#define TQ_GEMV_WARPS 8
#define TQ_GEMV_MMAX 8
#define TQ_GEMV_GMAX 128
#define TQ_GEMV_ROWS 16  // packed weight rows loaded per batch
#define TQ_GEMV_BN 32    // output columns a block: one per lane

struct __align__(16) GemvSmem {
  int8_t a[TQ_GEMV_WARPS][TQ_GEMV_MMAX][TQ_GEMV_GMAX];
  float as[TQ_GEMV_WARPS][TQ_GEMV_MMAX];
  float t[TQ_GEMV_WARPS][TQ_GEMV_MMAX * TQ_GEMV_BN];
};

// acc (thread tid -> row tid / BN, column tid % BN) += sum over groups g of
// ((float)dot_g * As[m, g]) * Ws[g, col], g ascending.
__device__ void gemv_groups(GemvSmem& sm, const int8_t* __restrict__ A, int lda,
                            const float* __restrict__ As, int lds,
                            const int8_t* __restrict__ W, const float* __restrict__ Ws,
                            int ldw, int wcol, int wcols, int n_groups, int gsz, int M,
                            float& acc) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = gsz / 2;
  for (int g0 = 0; g0 < n_groups; g0 += TQ_GEMV_WARPS) {
    const int g = g0 + warp;
    if (g < n_groups) {
      for (int i = lane; i < M * gsz; i += 32) {
        int m = i / gsz, k = i - m * gsz;
        sm.a[warp][m][k] = A[(size_t)m * lda + (size_t)g * gsz + k];
      }
      if (lane < M) sm.as[warp][lane] = As[(size_t)lane * lds + g];
      __syncwarp();
      int dot[TQ_GEMV_MMAX];
#pragma unroll
      for (int m = 0; m < TQ_GEMV_MMAX; ++m) dot[m] = 0;
      const int c = wcol + lane;
      if (c < wcols) {
        const int8_t* wcolp = W + (size_t)g * half * ldw + c;
        // packed rows go in batches of TQ_GEMV_ROWS: a batch's loads are all
        // issued before any is used, so that many independent loads per lane
        // are in flight, at a register cost that still fits two blocks per SM
        for (int j0 = 0; j0 < half; j0 += TQ_GEMV_ROWS) {
          int wv[TQ_GEMV_ROWS];
#pragma unroll
          for (int jj = 0; jj < TQ_GEMV_ROWS; ++jj) {
            const int j = j0 + jj;
            if (j < half) wv[jj] = (int)(unsigned char)wcolp[(size_t)j * ldw];
          }
#pragma unroll
          for (int jj = 0; jj < TQ_GEMV_ROWS; ++jj) {
            const int j = j0 + jj;
            if (j < half) {
              const int lo = tq_sext_lo(wv[jj]), hi = tq_sext_hi(wv[jj]);
#pragma unroll
              for (int m = 0; m < TQ_GEMV_MMAX; ++m)
                if (m < M) dot[m] += (int)sm.a[warp][m][j] * lo + (int)sm.a[warp][m][j + half] * hi;
            }
          }
        }
      }
      const float sw = c < wcols ? Ws[(size_t)g * ldw + c] : 0.f;
#pragma unroll
      for (int m = 0; m < TQ_GEMV_MMAX; ++m)
        if (m < M)
          sm.t[warp][m * TQ_GEMV_BN + lane] = __fmul_rn(__fmul_rn((float)dot[m], sm.as[warp][m]), sw);
    }
    __syncthreads();
    const int nw = min(TQ_GEMV_WARPS, n_groups - g0);
    if (tid < M * TQ_GEMV_BN)
      for (int w = 0; w < nw; ++w) acc = __fadd_rn(acc, sm.t[w][tid]);
    __syncthreads();
  }
}

// One pass: out[:, n0:n0+BN] = sum over K groups of (A, As) x (W, Ws), then
// (segs.n > 0) the owning segment's V epilogue from (hq, hs).
__global__ void __launch_bounds__(256, 2) tq_gemv(
    const int8_t* __restrict__ xq, const float* __restrict__ xs, const int8_t* __restrict__ W,
    const float* __restrict__ Ws, int M, int K, int N, int G, const int8_t* __restrict__ hq,
    const float* __restrict__ hs, int R, int hs_cols, TqSegs segs, float* __restrict__ out_f32,
    __nv_bfloat16* __restrict__ out_bf16) {
  __shared__ GemvSmem sm;
  const int n0 = blockIdx.x * TQ_GEMV_BN;
  float acc = 0.f;
  gemv_groups(sm, xq, K, xs, K / G, W, Ws, N, n0, N, K / G, G, M, acc);
  if (segs.n > 0) {
    const int j = tq_owner(segs, n0);
    const int gr = segs.rgroup[j];
    gemv_groups(sm, hq + segs.r_off[j], R, hs + segs.hs_off[j], hs_cols, segs.vp[j],
                segs.vs[j], segs.n_len[j], n0 - segs.n_off[j], segs.n_len[j],
                segs.r_len[j] / gr, gr, M, acc);
  }
  const int m = threadIdx.x / TQ_GEMV_BN, col = n0 + threadIdx.x % TQ_GEMV_BN;
  if (m < M && col < N) {
    if (out_f32) out_f32[(size_t)m * N + col] = acc;
    else out_bf16[(size_t)m * N + col] = __float2bfloat16_rn(acc);
  }
}

static int launch_gemv(const void* xq, const void* xs, const void* W, const void* Ws, int M,
                       int K, int N, int G, const void* hq, const void* hs, int R, int hs_cols,
                       const TqSegs& segs, float* out_f32, void* out_bf16, cudaStream_t st) {
  tq_gemv<<<(N + TQ_GEMV_BN - 1) / TQ_GEMV_BN, 256, 0, st>>>(
      (const int8_t*)xq, (const float*)xs, (const int8_t*)W, (const float*)Ws, M, K, N, G,
      (const int8_t*)hq, (const float*)hs, R, hs_cols, segs, out_f32,
      (__nv_bfloat16*)out_bf16);
  return (int)cudaGetLastError();
}

// x (M, K) bf16 -> out (M, N) bf16 for a fused group of n_seg segments.
// seg_info: n_seg x (n_off, n_len, r_off, r_len, rgroup) int64 on the host;
// vps/vss: host arrays of n_seg device pointers. Scratch (device): xq (M, K)
// int8, xs (M, K/G) f32, hf (M, R) f32, hq (M, R) int8, hs (M, hs_cols) f32.
// Returns the first non-zero cudaGetLastError() of its launches, else 0.
extern "C" int tq_dual_gemv(const void* x, const void* up, const void* us, const void* rp,
                            const void* rs, int M, int K, int N, int R, int G, int a_bits,
                            int n_seg, const void* seg_info, const void* vps, const void* vss,
                            void* xq, void* xs, void* hf, void* hq, void* hs, void* out,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int qmax = (1 << (a_bits - 1)) - 1;
  TqSegs segs = tq_make_segs(n_seg, (const long long*)seg_info, (const void* const*)vps,
                             (const void* const*)vss);
  const int hs_cols = tq_hs_cols(segs);
  int err = tq_launch_quantize(x, xq, xs, M, K, G, qmax, st);
  if (err) return err;
  TqSegs none = segs;
  none.n = 0;
  err = launch_gemv(xq, xs, up, us, M, K, R, G, nullptr, nullptr, R, 0, none, (float*)hf,
                    nullptr, st);
  if (err) return err;
  err = tq_launch_requant((const float*)hf, hq, hs, M, R, segs, qmax, st);
  if (err) return err;
  return launch_gemv(xq, xs, rp, rs, M, K, N, G, hq, hs, R, hs_cols, segs, nullptr, out, st);
}
