// Weight-only int4 GEMM (W4A16, the paper's AWQ/GPTQ-style baseline) for
// Hopper, sm_90a.
//
// Replaces: repro/kernels/w4a16_gemm.py : w4a16_gemm (body _w4a16_kernel).
//
//   y (M, N) bf16 = x (M, K) bf16 @ dq(wp (K/2, N) int4 pairs, ws (K/G, N) f32)
//
// Arithmetic contract (the plain version, ref.w4a16_gemm_ref):
//   * nibbles: group-split rows, byte j of a group holds row j (low nibble,
//     (p << 28) >> 28) and row j + G/2 (high nibble, (p << 24) >> 28);
//   * w = bf16_rn((float)q * s), the weight exactly as the plain version has it;
//   * p_g = the group's dot in f32 (bf16 tensor-core MMA, f32 accumulate,
//     starting from zero), acc = acc + p_g with __fadd_rn, g ascending;
//   * y = bf16_rn(acc).
// Only the order of the sum inside a group differs from the plain version.
//
// Row independence: one K schedule for every M (no split-K, nothing keyed
// on M), rows past M are never loaded (their shared rows stay zero) and
// never stored, and an MMA row only ever meets its own row of x. So the
// bits of an output row depend on that row of x alone, not on M or on the
// row's place in the launch: the speculative verify at M = B * spec_k gives
// the decode step's bits at M = B, and the ragged step a row's bits however
// it is batched.
//
// What bounds it: bytes at decode M (the packed weights, K*N/2, dominate:
// about 2 flops a byte at M = 8), bf16 MMA operations from M of a few
// hundred on.
//
// Design. A 64 x 64 output tile per block of 4 warps (2 x 2, 32 x 32 each),
// one scale group a K step. A two-stage cp.async pipeline copies group
// g + 1's x tile (64 x G bf16, only rows < M), packed weight rows (G/2 x 64
// bytes) and scales (64 f32) into shared memory while group g is unpacked
// and multiplied. Unpacking writes the dequantized group k-major (row k,
// 64 columns) in bf16; ldmatrix.trans turns it into B fragments for
// mma.sync.m16n8k16. The TPU kernel's sequential K grid axis with its f32
// VMEM accumulator becomes the in-block group loop with the accumulator in
// registers. wgmma, TMA and a deeper pipeline are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define W4_BM 64
#define W4_BN 64
#define W4_GMAX 128
#define W4_THREADS 128
#define W4_LDA (W4_GMAX + 8)  // x tile row (bf16): 272 B, conflict-free fragment loads
#define W4_LDB (W4_BN + 8)    // dequantized row (bf16): 144 B, conflict-free ldmatrix

struct __align__(16) W4Smem {
  __nv_bfloat16 a[2][W4_BM][W4_LDA];  // x tiles of two groups, row-major (m, k)
  int8_t raw[2][W4_GMAX / 2][W4_BN];  // packed weight rows of two groups
  float s[2][W4_BN];                  // their scales
  __nv_bfloat16 b[W4_GMAX][W4_LDB];   // the group being multiplied, k-major (k, n)
};

__device__ __forceinline__ void w4_cp16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void w4_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void w4_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// sign-extended low / high nibble of a packed byte (only its low 8 bits count)
__device__ __forceinline__ int w4_sext_lo(int b) { return ((int)((unsigned)b << 28)) >> 28; }
__device__ __forceinline__ int w4_sext_hi(int b) { return ((int)((unsigned)b << 24)) >> 28; }

// two dequantized weights bf16_rn((float)q * s) as one bf16 pair (first in
// the low half, the lower address)
__device__ __forceinline__ unsigned w4_pair(int q0, float s0, int q1, float s1) {
  const unsigned short b0 = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn((float)q0, s0)));
  const unsigned short b1 = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn((float)q1, s1)));
  return (unsigned)b0 | ((unsigned)b1 << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage group g's operands of this block into buffer st.
__device__ __forceinline__ void w4_stage(W4Smem& sm, int st, int g, const __nv_bfloat16* x,
                                         const int8_t* wp, const float* ws, int rows, int m0,
                                         int K, int N, int G, int n0) {
  const int vpr = G / 8;  // 16-byte vectors per x row
  for (int i = threadIdx.x; i < rows * vpr; i += W4_THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    w4_cp16(&sm.a[st][r][v * 8], x + (size_t)(m0 + r) * K + (size_t)g * G + v * 8);
  }
  const int half = G / 2;
  for (int i = threadIdx.x; i < half * (W4_BN / 16); i += W4_THREADS) {
    const int j = i / (W4_BN / 16), c = i - j * (W4_BN / 16);
    w4_cp16(&sm.raw[st][j][c * 16], wp + (size_t)(g * half + j) * N + n0 + c * 16);
  }
  if (threadIdx.x < W4_BN / 4)
    w4_cp16(&sm.s[st][threadIdx.x * 4], ws + (size_t)g * N + n0 + threadIdx.x * 4);
}

__global__ void __launch_bounds__(W4_THREADS)
w4a16_gemm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wp,
                  const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int M, int N,
                  int K, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W4Smem& sm = *reinterpret_cast<W4Smem*>(smem_raw);
  const int n0 = blockIdx.x * W4_BN, m0 = blockIdx.y * W4_BM;
  const int rows = min(W4_BM, M - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, gid = lane >> 2, tig = lane & 3;
  const int half = G / 2, n_groups = K / G;

  // rows past M stay zero in both x buffers: never copied, never stored
  for (int i = tid; i < (W4_BM - rows) * (W4_LDA / 8); i += W4_THREADS) {
    const int r = rows + i / (W4_LDA / 8), v = i % (W4_LDA / 8);
    *(uint4*)&sm.a[0][r][v * 8] = make_uint4(0, 0, 0, 0);
    *(uint4*)&sm.a[1][r][v * 8] = make_uint4(0, 0, 0, 0);
  }

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // a 16-row MMA tile wholly past M is skipped (warp-uniform)
  const bool live0 = m0 + wm * 32 < M, live1 = m0 + wm * 32 + 16 < M;

  w4_stage(sm, 0, 0, x, wp, ws, rows, m0, K, N, G, n0);
  w4_commit();
  for (int g = 0; g < n_groups; ++g) {
    const int cur = g & 1;
    __syncthreads();  // iteration g - 1 is done with buffer cur ^ 1 and with sm.b
    if (g + 1 < n_groups) w4_stage(sm, cur ^ 1, g + 1, x, wp, ws, rows, m0, K, N, G, n0);
    w4_commit();
    w4_wait_prev();
    __syncthreads();  // group g's copies are visible to every thread

    // unpack + dequantize: 16 columns of packed row j -> rows j and j + G/2
    for (int i = tid; i < half * (W4_BN / 16); i += W4_THREADS) {
      const int j = i / (W4_BN / 16), c0 = (i - j * (W4_BN / 16)) * 16;
      const uint4 pk = *(const uint4*)&sm.raw[cur][j][c0];
      const unsigned words[4] = {pk.x, pk.y, pk.z, pk.w};
      unsigned lo[8], hi[8];  // bf16 pairs of columns (c0 + 2t, c0 + 2t + 1)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const unsigned w = words[t >> 1] >> (16 * (t & 1));
        const int p0 = (int)(w & 0xFFu), p1 = (int)((w >> 8) & 0xFFu);
        const float s0 = sm.s[cur][c0 + 2 * t], s1 = sm.s[cur][c0 + 2 * t + 1];
        lo[t] = w4_pair(w4_sext_lo(p0), s0, w4_sext_lo(p1), s1);
        hi[t] = w4_pair(w4_sext_hi(p0), s0, w4_sext_hi(p1), s1);
      }
      *(uint4*)&sm.b[j][c0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *(uint4*)&sm.b[j][c0 + 8] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      *(uint4*)&sm.b[j + half][c0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *(uint4*)&sm.b[j + half][c0 + 8] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    __syncthreads();

    // the group's dot from zero, then acc = acc + p (ascending groups)
    float p[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[mt][nt][e] = 0.f;
    for (int kk = 0; kk < G; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm * 32 + mt * 16 + gid;
        a[mt][0] = *(const unsigned*)&sm.a[cur][row][kk + 2 * tig];
        a[mt][1] = *(const unsigned*)&sm.a[cur][row + 8][kk + 2 * tig];
        a[mt][2] = *(const unsigned*)&sm.a[cur][row][kk + 8 + 2 * tig];
        a[mt][3] = *(const unsigned*)&sm.a[cur][row + 8][kk + 8 + 2 * tig];
      }
      unsigned b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // matrices: (k lo, n lo), (k hi, n lo), (k lo, n hi), (k hi, n hi)
        const int mat = lane >> 3, r = lane & 7;
        const unsigned addr = (unsigned)__cvta_generic_to_shared(
            &sm.b[kk + r + 8 * (mat & 1)][wn * 32 + np * 16 + 8 * (mat >> 1)]);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(b[2 * np][0]), "=r"(b[2 * np][1]), "=r"(b[2 * np + 1][0]),
                       "=r"(b[2 * np + 1][1])
                     : "r"(addr));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (live0) mma_bf16(p[0][nt], a[0], b[nt][0], b[nt][1]);
        if (live1) mma_bf16(p[1][nt], a[1], b[nt][0], b[nt][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], p[mt][nt][e]);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + gid + 8 * h;
        const int col = n0 + wn * 32 + nt * 8 + 2 * tig;
        if (m < M) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(acc[mt][nt][2 * h]);
          v.y = __float2bfloat16_rn(acc[mt][nt][2 * h + 1]);
          *(__nv_bfloat162*)&out[(size_t)m * N + col] = v;
        }
      }
}

// x (M, K) bf16, wp (K/2, N) int8, ws (K/G, N) f32, out (M, N) bf16, all
// contiguous and 16-byte aligned; N % 64 == 0, K % G == 0, G % 16 == 0,
// G <= 128 (contracts.validate_w4a16). Returns the cudaError of the launch.
extern "C" int w4a16_gemm(const void* x, const void* wp, const void* ws, void* out, int M,
                          int N, int K, int G, void* stream) {
  const size_t smem = sizeof(W4Smem);
  cudaError_t e = cudaFuncSetAttribute(w4a16_gemm_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / W4_BN, (M + W4_BM - 1) / W4_BM);
  w4a16_gemm_kernel<<<grid, W4_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)wp, (const float*)ws, (__nv_bfloat16*)out, M, N,
      K, G);
  return (int)cudaGetLastError();
}
