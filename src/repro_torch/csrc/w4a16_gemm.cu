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
// Row independence: every regime computes each p_g by the same instruction
// sequence (mma.sync.m16n8k16 bf16 with the row's x as A, k16 steps
// ascending from zero, the weight as B) and adds it to the output's one
// chain in ascending g; rows past M are never loaded (their shared rows
// stay zero) and never stored, and an MMA row only ever meets its own row
// of x. So the bits of an output row depend on that row of x alone, not on
// M, the regime or the row's place in the launch: the speculative verify at
// M = B * spec_k gives the decode step's bits at M = B, and the ragged step
// a row's bits however it is batched.
//
// What bounds it: bytes at decode M (the packed weights, K*N/2, dominate:
// about 2 flops a byte at M = 8), bf16 MMA operations from M of a few
// hundred on.
//
// Decode regime (M <= W4D_M_MAX = 32). For N < W4D_COL_N
// (w4a16_decode_kernel) a block takes 16 output columns (one 16-byte chunk
// of a packed row) and splits K over its 8 warps: warp w takes groups w,
// w + 8, ... through its own ring of cp.async slots (x rows < M, the packed
// rows of its 16 columns, their scales), so the grid is N / 16 blocks (256
// at N = 4096). The packed rows go through ldmatrix.trans as 8 x 8
// matrices of byte pairs: lane (g, t) then holds packed rows 2t, 2t + 1 of
// columns 2g and 2g + 1, exactly the k pairs of an m16n8k16 B fragment, so
// the nibbles are dequantized in registers (sign via a 2^23 float bias, one
// f32 multiply by the scale, one bf16x2 rounding) straight into two B
// fragments: even columns as one n8 tile, odd columns as another. Each
// round every warp parks its group's p_g in shared memory; after one
// barrier one thread per output adds the round's terms in ascending g
// (double-buffered, so one barrier a round). For N >= W4D_COL_N
// (w4a16_col_kernel) a block of 4 warps takes 64 columns, one warp each 16,
// and walks all of K with one shared ring, so x is read once per 64 columns
// and no term is parked. The group size and the row count (8, 16 or 32)
// are template arguments, so a group's loads, dequantization and MMAs
// unroll without guards.
//
// Prefill regime (M > 32; w4a16_gemm_kernel). A 64 x 64 output tile per
// block of 4 warps (2 x 2, 32 x 32 each), one scale group a K step. A
// two-stage cp.async pipeline copies group g + 1's x tile (64 x G bf16,
// only rows < M), packed weight rows (G/2 x 64 bytes) and scales (64 f32)
// into shared memory while group g is unpacked and multiplied. Unpacking
// writes the dequantized group k-major (row k, 64 columns) in bf16;
// ldmatrix.trans turns it into B fragments for mma.sync.m16n8k16. The TPU
// kernel's sequential K grid axis with its f32 VMEM accumulator becomes the
// in-block group loop with the accumulator in registers. wgmma and TMA are
// left for later work.
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

// ---------------------------------------------------------------------------
// decode regime
// ---------------------------------------------------------------------------

#define W4D_STAGES 2  // ring slots a warp (two gave the shortest times of 2, 3, 4)
#define W4D_WARPS 8   // the K split of a block
#define W4D_M_MAX 32    // largest M of the decode regime

// x rows a slot holds for M (8, 16 or 32)
inline int w4d_rows(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : 32; }
// One slot of a warp's ring: group g's x rows (rm x (G + 8) bf16, rows >= M
// zero), the packed rows of the block's 16 columns (G/2 x 16 bytes), their
// 16 scales.
__host__ __device__ constexpr int w4d_slot_bytes(int rm, int G) {
  return rm * (G + 8) * 2 + (G / 2) * 16 + 16 * 4;
}
// at most 189,440 bytes (32 rows, G = 128)
inline size_t w4d_smem_bytes(int rm, int G) {
  return (size_t)W4D_WARPS * W4D_STAGES * w4d_slot_bytes(rm, G) +
         (size_t)2 * W4D_WARPS * rm * 16 * sizeof(float);  // two rounds of parked terms
}

__device__ __forceinline__ void w4_ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void w4_ldsm_x2(unsigned& r0, unsigned& r1, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}
__device__ __forceinline__ void w4_ldsm_x4_t(unsigned* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void w4_ldsm_x1_t(unsigned* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r[0])
               : "r"(a));
}

// (float)q of the nibble at bits [0, 4) of v: bits 2^23 + (q + 8) as a float
// (q + 8 = nibble ^ 8), less 2^23 + 8; exact.
__device__ __forceinline__ float w4_nib(unsigned v) {
  return __fsub_rn(__uint_as_float((v & 0xFu) ^ 0x4B000008u), 8388616.f);
}

// r holds packed bytes {(2t, 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g +
// 1)} (packed row, column) from ldmatrix.trans; `sh` = 0 takes the low
// nibbles (group rows j), 4 the high ones (rows j + G/2). Returns the B
// fragment words bf16_rn((float)q * s) for the even column 2g and the odd
// column 2g + 1 (k = 2t in the low half, 2t + 1 in the high half).
__device__ __forceinline__ void w4_deq(unsigned r, int sh, float se, float so, unsigned& be,
                                       unsigned& bo) {
  const unsigned v = r >> sh;
  const __nv_bfloat162 e =
      __floats2bfloat162_rn(__fmul_rn(w4_nib(v), se), __fmul_rn(w4_nib(v >> 16), se));
  const __nv_bfloat162 o =
      __floats2bfloat162_rn(__fmul_rn(w4_nib(v >> 8), so), __fmul_rn(w4_nib(v >> 24), so));
  be = *reinterpret_cast<const unsigned*>(&e);
  bo = *reinterpret_cast<const unsigned*>(&o);
}

// RM: x rows of a slot (8, 16 or 32; M <= RM); KS: k16 steps a group (G =
// 16 KS), both compile-time, so a group's loads, dequantization and MMAs
// unroll without guards and overlap.
template <int RM, int KS>
__global__ void __launch_bounds__(256)
w4a16_decode_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wp,
                    const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int M, int N,
                    int K) {
  constexpr int G = 16 * KS, HALF = G / 2, LDX = G + 8, VPR = G / 8;
  constexpr int S = W4D_STAGES, SLOT = w4d_slot_bytes(RM, G);
  constexpr int MT = RM >= 16 ? RM / 16 : 1;  // m16 tiles (RM = 8: one, rows 8-15 zero)
  constexpr int OPT = (RM * 16 + 127) / 128;  // outputs a thread adds (>= 4 warps)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  unsigned char* ring = smem_raw + (size_t)warp * S * SLOT;
  float* park = reinterpret_cast<float*>(smem_raw + (size_t)warps * S * SLOT);  // [2][warps][RM][16]
  const int n0 = blockIdx.x * 16, n_groups = K / G;
  auto xs = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(ring + st * SLOT); };
  auto wsl = [&](int st) { return reinterpret_cast<int8_t*>(ring + st * SLOT + RM * LDX * 2); };
  auto ssl = [&](int st) {
    return reinterpret_cast<float*>(ring + st * SLOT + RM * LDX * 2 + HALF * 16);
  };

  for (int st = 0; st < S; ++st)
    for (int i = lane; i < (RM - M) * (LDX / 8); i += 32) {
      const int r = M + i / (LDX / 8), v = i % (LDX / 8);
      *reinterpret_cast<uint4*>(xs(st) + r * LDX + v * 8) = make_uint4(0, 0, 0, 0);
    }

  // the lane's x chunks: (row, 16-byte chunk) from (lane / VPR, lane % VPR)
  // in steps of 32 chunks (DR rows and DV chunks, carried)
  constexpr int DR = 32 / VPR, DV = 32 % VPR;
  auto stage = [&](int st, int g) {
    const __nv_bfloat16* xg = x + (size_t)g * G;
    for (int r = lane / VPR, v = lane % VPR; r < M;) {
      w4_cp16(xs(st) + r * LDX + v * 8, xg + (size_t)r * K + v * 8);
      v += DV;
      r += DR;
      if (v >= VPR) {
        v -= VPR;
        ++r;
      }
    }
    for (int j = lane; j < HALF; j += 32)
      w4_cp16(wsl(st) + j * 16, wp + (size_t)(g * HALF + j) * N + n0);
    if (lane < 4) w4_cp16(ssl(st) + lane * 4, ws + (size_t)g * N + n0 + lane * 4);
  };

  const int rounds = (n_groups + warps - 1) / warps;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s * warps + warp < n_groups) stage(s, s * warps + warp);
    w4_commit();
  }
  float acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = 0.f;

  for (int r = 0; r < rounds; ++r) {
    const int g = r * warps + warp;
    {
      const int rn = r + S - 1;
      __syncwarp();  // every lane is done with the slot of round r - 1
      if (rn * warps + warp < n_groups) stage(rn % S, rn * warps + warp);
      w4_commit();
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1));
    __syncwarp();  // round r's slot has landed for every lane
    float* pk = park + ((r & 1) * warps + warp) * RM * 16;
    if (g < n_groups) {
      const int st = r % S;
      const float se = ssl(st)[2 * gid], so = ssl(st)[2 * gid + 1];
      // the G/16 packed 8-row blocks, each once: block i's low nibbles are
      // k rows 8i + [0, 8), its high ones k rows G/2 + 8i + [0, 8)
      unsigned raw[KS];
      const int8_t* wb = wsl(st);
      constexpr int K4 = KS / 4 * 4;  // blocks loaded four at a time
#pragma unroll
      for (int i = 0; i < K4; i += 4) w4_ldsm_x4_t(raw + i, wb + (8 * i + lane) * 16);
#pragma unroll
      for (int i = K4; i < KS; ++i) w4_ldsm_x1_t(raw + i, wb + (8 * i + (lane & 7)) * 16);
      unsigned be[2 * KS], bo[2 * KS];
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        w4_deq(raw[i], 0, se, so, be[i], bo[i]);
        w4_deq(raw[i], 4, se, so, be[KS + i], bo[KS + i]);
      }
      // the group's dot from zero: k16 steps ascending; even / odd columns
      float p[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[mt][t][e] = 0.f;
      const __nv_bfloat16* xb = xs(st);
#pragma unroll
      for (int s16 = 0; s16 < KS; ++s16) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned a[4];
          if (RM == 8) {
            w4_ldsm_x2(a[0], a[2], xb + (lane & 7) * LDX + 16 * s16 + ((lane >> 3) & 1) * 8);
            a[1] = a[3] = 0u;
          } else {
            w4_ldsm_x4(a, xb + (16 * mt + (lane & 15)) * LDX + 16 * s16 + (lane >> 4) * 8);
          }
          mma_bf16(p[mt][0], a, be[2 * s16], be[2 * s16 + 1]);
          mma_bf16(p[mt][1], a, bo[2 * s16], bo[2 * s16 + 1]);
        }
      }
      // park p_g: tile t, MMA column 2 tig + (e & 1) is column 4 tig + 2 (e & 1) + t
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = 16 * mt + gid + 8 * (e >> 1);
            if (row < M) pk[row * 16 + 4 * tig + 2 * (e & 1) + t] = p[mt][t][e];
          }
    }
    __syncthreads();  // the round's terms are parked
    // one thread per output adds the round's terms in ascending g
    const int nk = min(warps, n_groups - r * warps);
    const float* pr = park + (r & 1) * warps * RM * 16;
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int o = tid + i * blockDim.x;
      if (o < M * 16)
        for (int k = 0; k < nk; ++k) acc[i] = __fadd_rn(acc[i], pr[k * RM * 16 + o]);
    }
  }
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int o = tid + i * blockDim.x;
    if (o < M * 16) out[(size_t)(o >> 4) * N + n0 + (o & 15)] = __float2bfloat16_rn(acc[i]);
  }
}

// Wide N (N >= W4D_COL_N): a block of 4 warps takes 64 columns, warp w the
// 16 columns n0 + 16 w, and walks every group itself (no K split): the
// block's ring of W4C_STAGES slots holds each group's x rows once for all
// four warps and the packed rows 64 bytes wide (whole sectors; 16-byte
// chunks XOR-swizzled by row pair so ldmatrix.trans reads hit 32 banks).
// Each output's chain stays in one thread's registers, so no term is
// parked; one barrier a group. Same per-group MMA sequence and ascending
// chain as w4a16_decode_kernel, so the same bits.
#define W4D_COL_N 8192  // from this N on, the column-split schedule
#define W4C_STAGES 4    // ring slots of a column-split block
__host__ __device__ constexpr int w4c_slot_bytes(int rm, int G) {
  return rm * (G + 8) * 2 + (G / 2) * 64 + 64 * 4;
}
inline size_t w4c_smem_bytes(int rm, int G) { return (size_t)W4C_STAGES * w4c_slot_bytes(rm, G); }

template <int RM, int KS>
__global__ void __launch_bounds__(128)
w4a16_col_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wp,
                 const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int M, int N,
                 int K) {
  constexpr int G = 16 * KS, HALF = G / 2, LDX = G + 8, VPR = G / 8;
  constexpr int S = W4C_STAGES, SLOT = w4c_slot_bytes(RM, G);
  constexpr int MT = RM >= 16 ? RM / 16 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * 64, n_groups = K / G;
  auto xs = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + st * SLOT); };
  auto wsl = [&](int st) { return reinterpret_cast<int8_t*>(smem_raw + st * SLOT + RM * LDX * 2); };
  auto ssl = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + st * SLOT + RM * LDX * 2 + HALF * 64);
  };
  for (int st = 0; st < S; ++st)
    for (int i = tid; i < (RM - M) * (LDX / 8); i += 128) {
      const int r = M + i / (LDX / 8), v = i % (LDX / 8);
      *reinterpret_cast<uint4*>(xs(st) + r * LDX + v * 8) = make_uint4(0, 0, 0, 0);
    }
  // the thread's x chunks from (tid / VPR, tid % VPR) in steps of 128 chunks
  constexpr int DR = 128 / VPR, DV = 128 % VPR;
  auto stage = [&](int st, int g) {
    const __nv_bfloat16* xg = x + (size_t)g * G;
    for (int r = tid / VPR, v = tid % VPR; r < M;) {
      w4_cp16(xs(st) + r * LDX + v * 8, xg + (size_t)r * K + v * 8);
      v += DV;
      r += DR;
      if (v >= VPR) {
        v -= VPR;
        ++r;
      }
    }
    // packed row j, 16-byte chunk c at chunk c ^ ((j >> 1) & 3)
    for (int i = tid; i < HALF * 4; i += 128) {
      const int j = i >> 2, c = i & 3;
      w4_cp16(wsl(st) + j * 64 + ((c ^ ((j >> 1) & 3)) << 4),
              wp + (size_t)(g * HALF + j) * N + n0 + c * 16);
    }
    if (tid < 16) w4_cp16(ssl(st) + tid * 4, ws + (size_t)g * N + n0 + tid * 4);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_groups) stage(s, s);
    w4_commit();
  }
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

  for (int g = 0; g < n_groups; ++g) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
    __syncthreads();  // group g visible to all; group g - 1 fully consumed
    if (g + S - 1 < n_groups) stage((g + S - 1) % S, g + S - 1);
    w4_commit();
    const int st = g % S;
    const float se = ssl(st)[16 * warp + 2 * gid], so = ssl(st)[16 * warp + 2 * gid + 1];
    unsigned raw[KS];
    const int8_t* wb = wsl(st);
    // lane's row of packed block i: 8 i + (lane & 7) (x4: + 8 (lane >> 3)),
    // its 16 bytes at chunk warp ^ ((row >> 1) & 3)
    constexpr int K4 = KS / 4 * 4;
#pragma unroll
    for (int i = 0; i < K4; i += 4) {
      const int row = 8 * i + lane;
      w4_ldsm_x4_t(raw + i, wb + row * 64 + ((warp ^ ((row >> 1) & 3)) << 4));
    }
#pragma unroll
    for (int i = K4; i < KS; ++i) {
      const int row = 8 * i + (lane & 7);
      w4_ldsm_x1_t(raw + i, wb + row * 64 + ((warp ^ ((row >> 1) & 3)) << 4));
    }
    unsigned be[2 * KS], bo[2 * KS];
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      w4_deq(raw[i], 0, se, so, be[i], bo[i]);
      w4_deq(raw[i], 4, se, so, be[KS + i], bo[KS + i]);
    }
    float p[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[mt][t][e] = 0.f;
    const __nv_bfloat16* xb = xs(st);
#pragma unroll
    for (int s16 = 0; s16 < KS; ++s16) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        if (RM == 8) {
          w4_ldsm_x2(a[0], a[2], xb + (lane & 7) * LDX + 16 * s16 + ((lane >> 3) & 1) * 8);
          a[1] = a[3] = 0u;
        } else {
          w4_ldsm_x4(a, xb + (16 * mt + (lane & 15)) * LDX + 16 * s16 + (lane >> 4) * 8);
        }
        mma_bf16(p[mt][0], a, be[2 * s16], be[2 * s16 + 1]);
        mma_bf16(p[mt][1], a, bo[2 * s16], bo[2 * s16 + 1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][t][e] = __fadd_rn(acc[mt][t][e], p[mt][t][e]);
  }
  // tile t, MMA column 2 tig + (e & 1) is column 4 tig + 2 (e & 1) + t
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + gid + 8 * (e >> 1);
        if (row < M)
          out[(size_t)row * N + n0 + 16 * warp + 4 * tig + 2 * (e & 1) + t] =
              __float2bfloat16_rn(acc[mt][t][e]);
      }
}

template <int RM, int KS>
static int launch_col(const void* x, const void* wp, const void* ws, void* out, int M, int N,
                      int K, cudaStream_t st) {
  const size_t smem = w4c_smem_bytes(RM, 16 * KS);
  cudaError_t e = cudaFuncSetAttribute(w4a16_col_kernel<RM, KS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(w4a16_col_kernel<RM, KS>,
                           cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return (int)e;
  w4a16_col_kernel<RM, KS><<<N / 64, 128, smem, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)wp, (const float*)ws, (__nv_bfloat16*)out, M, N,
      K);
  return (int)cudaGetLastError();
}

template <int RM, int KS>
static int launch_decode(const void* x, const void* wp, const void* ws, void* out, int M, int N,
                         int K, cudaStream_t st) {
  const size_t smem = w4d_smem_bytes(RM, 16 * KS);
  cudaError_t e = cudaFuncSetAttribute(w4a16_decode_kernel<RM, KS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // all of the SM's shared memory as such: as many blocks an SM as fit
  e = cudaFuncSetAttribute(w4a16_decode_kernel<RM, KS>,
                           cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return (int)e;
  w4a16_decode_kernel<RM, KS><<<N / 16, 32 * W4D_WARPS, smem, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)wp, (const float*)ws, (__nv_bfloat16*)out, M, N,
      K);
  return (int)cudaGetLastError();
}

template <int RM>
static int launch_rows(const void* x, const void* wp, const void* ws, void* out, int M, int N,
                       int K, int G, cudaStream_t st) {
  if (N >= W4D_COL_N) {
    switch (G / 16) {
      case 1: return launch_col<RM, 1>(x, wp, ws, out, M, N, K, st);
      case 2: return launch_col<RM, 2>(x, wp, ws, out, M, N, K, st);
      case 3: return launch_col<RM, 3>(x, wp, ws, out, M, N, K, st);
      case 4: return launch_col<RM, 4>(x, wp, ws, out, M, N, K, st);
      case 5: return launch_col<RM, 5>(x, wp, ws, out, M, N, K, st);
      case 6: return launch_col<RM, 6>(x, wp, ws, out, M, N, K, st);
      case 7: return launch_col<RM, 7>(x, wp, ws, out, M, N, K, st);
      default: return launch_col<RM, 8>(x, wp, ws, out, M, N, K, st);
    }
  }
  switch (G / 16) {
    case 1: return launch_decode<RM, 1>(x, wp, ws, out, M, N, K, st);
    case 2: return launch_decode<RM, 2>(x, wp, ws, out, M, N, K, st);
    case 3: return launch_decode<RM, 3>(x, wp, ws, out, M, N, K, st);
    case 4: return launch_decode<RM, 4>(x, wp, ws, out, M, N, K, st);
    case 5: return launch_decode<RM, 5>(x, wp, ws, out, M, N, K, st);
    case 6: return launch_decode<RM, 6>(x, wp, ws, out, M, N, K, st);
    case 7: return launch_decode<RM, 7>(x, wp, ws, out, M, N, K, st);
    default: return launch_decode<RM, 8>(x, wp, ws, out, M, N, K, st);
  }
}

// Dynamic shared memory of the launch for (M, N, G); the contract mirrors it.
extern "C" int w4a16_smem_bytes(int M, int N, int G) {
  if (M > W4D_M_MAX) return (int)sizeof(W4Smem);
  const int rm = w4d_rows(M);
  if (N >= W4D_COL_N) return (int)w4c_smem_bytes(rm, G);
  return (int)w4d_smem_bytes(rm, G);
}

// x (M, K) bf16, wp (K/2, N) int8, ws (K/G, N) f32, out (M, N) bf16, all
// contiguous and 16-byte aligned; N % 64 == 0, K % G == 0, G % 16 == 0,
// G <= 128 (contracts.validate_w4a16). Returns the cudaError of the launch.
extern "C" int w4a16_gemm(const void* x, const void* wp, const void* ws, void* out, int M,
                          int N, int K, int G, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 8) return launch_rows<8>(x, wp, ws, out, M, N, K, G, st);
  if (M <= 16) return launch_rows<16>(x, wp, ws, out, M, N, K, G, st);
  if (M <= W4D_M_MAX) return launch_rows<32>(x, wp, ws, out, M, N, K, G, st);
  const size_t smem = sizeof(W4Smem);
  cudaError_t e = cudaFuncSetAttribute(w4a16_gemm_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / W4_BN, (M + W4_BM - 1) / W4_BM);
  w4a16_gemm_kernel<<<grid, W4_THREADS, smem, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)wp, (const float*)ws, (__nv_bfloat16*)out, M, N,
      K, G);
  return (int)cudaGetLastError();
}
