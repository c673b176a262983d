// Prefill-shaped dual-component TwinQuant GEMM (M > 8) for Hopper, sm_90a.
//
// Replaces: repro/kernels/twinquant_dual_gemm.py : dual_gemm (body
// _dual_gemm_kernel) and dual_gemm_group — the paper's §4.3 kernel. One C
// entry serves both; a single pack is a one-segment group.
//
// What bounds it: int8 operations once M reaches a few hundred rows (2*M*N*K
// for the residual plus 2*M*R*(K+N) for the low-rank path, against 1,979
// int8 TOP/s); at small M the packed weight bytes bound it, as in the GEMV.
//
// Design. As in the GEMV, the TPU kernel's scratch that persists across a
// sequential N sweep (Xq at n == 0, H accumulated across K) becomes a
// prologue that leaves Xq/xs and Hq/hs in global memory:
//   1. tq_quantize_act: X -> Xq, xs;
//   2. tq_gemm with W = Uq: H = dq(Xq Uq) in f32;
//   3. tq_requant_h: H -> Hq, hs per segment;
// then the main launch, tq_gemm with W = Rq and the owning segment's V
// epilogue, writes bf16 once.
//
// tq_gemm: a 64 x 64 output tile per block of 4 warps (2 x 2, 32 x 32 each).
// Per scale group it stages the int8 A tile (64 x G) and the unpacked W tile
// (stored n-major, k contiguous) in shared memory and runs int8 tensor-core
// MMA (mma.sync m16n8k32, s32 accumulate) over the group's K; the group's
// exact int dot is then scaled and added to the f32 accumulator in
// registers, group by group in ascending order — the plain version's order,
// so the result is bit-identical to it. The V epilogue is one more run of
// the same loop over the owning segment's rank groups, with A = Hq.
// wgmma, TMA and a multi-stage pipeline are left for later work.
#include "twinquant_common.cuh"

#define TQ_BM 64
#define TQ_BN 64
#define TQ_GMAX 128
#define TQ_LDS (TQ_GMAX + 16)  // padded row: conflict-free fragment loads

struct __align__(16) GemmSmem {
  int8_t a[TQ_BM][TQ_LDS];  // A tile, row-major (m, k)
  int8_t b[TQ_BN][TQ_LDS];  // W tile unpacked, n-major (n, k)
  float as[TQ_BM];          // A scales of this group
  float ws[TQ_BN];          // W scales of this group
};

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[mt][nt][e] += sum over groups g of ((float)dot_g * As[row, g]) *
// Ws[g, col], g ascending. Fragment element (mt, nt, e) sits at tile row
// wm*32 + mt*16 + gid + 8*(e >= 2), column wn*32 + nt*8 + 2*tig + (e & 1).
__device__ void gemm_groups(GemmSmem& sm, const int8_t* __restrict__ A, int lda, int M, int m0,
                            const float* __restrict__ As, int lds,
                            const int8_t* __restrict__ W, const float* __restrict__ Ws,
                            int ldw, int wcol0, int wcols, int n_groups, int gsz,
                            float (&acc)[2][4][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, gid = lane >> 2, tig = lane & 3;
  const int half = gsz / 2;
  for (int g = 0; g < n_groups; ++g) {
    const int vpr = gsz / 16;  // 16-byte vectors per A row
    for (int i = tid; i < TQ_BM * vpr; i += blockDim.x) {
      const int r = i / vpr, v = i - r * vpr;
      int4 val = make_int4(0, 0, 0, 0);
      if (m0 + r < M)
        val = *(const int4*)(A + (size_t)(m0 + r) * lda + (size_t)g * gsz + v * 16);
      *(int4*)&sm.a[r][v * 16] = val;
    }
    for (int i = tid; i < half * (TQ_BN / 4); i += blockDim.x) {
      const int jr = i / (TQ_BN / 4), cw = i - jr * (TQ_BN / 4);
      const int c = wcol0 + cw * 4;
      unsigned word = 0;
      if (c < wcols) word = *(const unsigned*)(W + (size_t)(g * half + jr) * ldw + c);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = (int)((word >> (8 * q)) & 0xFFu);
        sm.b[cw * 4 + q][jr] = (int8_t)tq_sext_lo(b);
        sm.b[cw * 4 + q][jr + half] = (int8_t)tq_sext_hi(b);
      }
    }
    if (tid < TQ_BM) {
      sm.as[tid] = (m0 + tid < M) ? As[(size_t)(m0 + tid) * lds + g] : 0.f;
    } else if (tid < TQ_BM + TQ_BN) {
      const int c = tid - TQ_BM;
      sm.ws[c] = (wcol0 + c < wcols) ? Ws[(size_t)g * ldw + wcol0 + c] : 0.f;
    }
    __syncthreads();
    int dot[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dot[mt][nt][e] = 0;
    for (int kk = 0; kk < gsz; kk += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + gid;
        a[mt][0] = *(const unsigned*)&sm.a[row][kk + tig * 4];
        a[mt][1] = *(const unsigned*)&sm.a[row + 8][kk + tig * 4];
        a[mt][2] = *(const unsigned*)&sm.a[row][kk + 16 + tig * 4];
        a[mt][3] = *(const unsigned*)&sm.a[row + 8][kk + 16 + tig * 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + gid;
        const unsigned b0 = *(const unsigned*)&sm.b[col][kk + tig * 4];
        const unsigned b1 = *(const unsigned*)&sm.b[col][kk + 16 + tig * 4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_s8(dot[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = wm * 32 + mt * 16 + gid + ((e >> 1) << 3);
          const int col = wn * 32 + nt * 8 + tig * 2 + (e & 1);
          acc[mt][nt][e] = tq_acc(acc[mt][nt][e], dot[mt][nt][e], sm.as[row], sm.ws[col]);
        }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(128) tq_gemm(
    const int8_t* __restrict__ xq, const float* __restrict__ xs, const int8_t* __restrict__ W,
    const float* __restrict__ Ws, int M, int K, int N, int G, const int8_t* __restrict__ hq,
    const float* __restrict__ hs, int R, int hs_cols, TqSegs segs, float* __restrict__ out_f32,
    __nv_bfloat16* __restrict__ out_bf16) {
  __shared__ GemmSmem sm;
  const int n0 = blockIdx.x * TQ_BN, m0 = blockIdx.y * TQ_BM;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  gemm_groups(sm, xq, K, M, m0, xs, K / G, W, Ws, N, n0, N, K / G, G, acc);
  if (segs.n > 0) {
    const int j = tq_owner(segs, n0);
    const int gr = segs.rgroup[j];
    gemm_groups(sm, hq + segs.r_off[j], R, M, m0, hs + segs.hs_off[j], hs_cols, segs.vp[j],
                segs.vs[j], segs.n_len[j], n0 - segs.n_off[j], segs.n_len[j],
                segs.r_len[j] / gr, gr, acc);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mt * 16 + gid + ((e >> 1) << 3);
        const int col = n0 + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (m < M && col < N) {
          if (out_f32) out_f32[(size_t)m * N + col] = acc[mt][nt][e];
          else out_bf16[(size_t)m * N + col] = __float2bfloat16_rn(acc[mt][nt][e]);
        }
      }
}

static int launch_gemm(const void* xq, const void* xs, const void* W, const void* Ws, int M,
                       int K, int N, int G, const void* hq, const void* hs, int R, int hs_cols,
                       const TqSegs& segs, float* out_f32, void* out_bf16, cudaStream_t st) {
  dim3 grid((N + TQ_BN - 1) / TQ_BN, (M + TQ_BM - 1) / TQ_BM);
  tq_gemm<<<grid, 128, 0, st>>>((const int8_t*)xq, (const float*)xs, (const int8_t*)W,
                                (const float*)Ws, M, K, N, G, (const int8_t*)hq,
                                (const float*)hs, R, hs_cols, segs, out_f32,
                                (__nv_bfloat16*)out_bf16);
  return (int)cudaGetLastError();
}

// x (M, K) bf16 -> out (M, N) bf16 for a fused group of n_seg segments;
// arguments as tq_dual_gemv (no column-per-lane choice). Returns the first
// non-zero cudaGetLastError() of its launches, else 0.
extern "C" int tq_dual_gemm(const void* x, const void* up, const void* us, const void* rp,
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
  err = launch_gemm(xq, xs, up, us, M, K, R, G, nullptr, nullptr, R, 0, none, (float*)hf,
                    nullptr, st);
  if (err) return err;
  err = tq_launch_requant((const float*)hf, hq, hs, M, R, segs, qmax, st);
  if (err) return err;
  return launch_gemm(xq, xs, rp, rs, M, K, N, G, hq, hs, R, hs_cols, segs, nullptr, out, st);
}
