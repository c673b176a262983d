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
// Over an expert axis (E > 1: an MoE layer's stacked packs) every launch
// runs gridDim.z = E, each block reading and writing its expert's slices
// (the per-expert strides in TqExp / GmArgs).
//
// Four launches: tq_quantize_act (X -> Xq, xs); the H pass, tq_gemm_split
// with W = Uq, writing H in f32; tq_requant_h (H -> Hq, hs per segment); the
// main pass with W = Rq and each column tile's owning segment's V groups,
// writing bf16 once: tq_gemm_split up to GM_SPLIT_M rows, tq_gemm_tile
// above.
//
// A task is one scale group: the K groups of W, then the V groups with A =
// Hq. Per task, cp.async brings the int8 A tile, the packed W rows and both
// scale vectors into a ring of stages; the packed rows are unpacked into
// the k-major B tile the int8 MMA needs: a lane reads 4 packed rows x 4
// columns as four 32-bit words, transposes the bytes (__byte_perm) and
// stores 16 x the sign-extended nibbles (low nibbles: the group's rows j,
// high: rows j + G/2) as 32-bit words. A and B tiles are K-major rows of
// 128 bytes in the 128-byte swizzle (16-byte chunk c of row r at c ^ (r &
// 7)), the layout wgmma reads; the packed rows get an XOR swizzle of their
// own, so the unpack reads no conflicting banks. The MMA sums the group's
// exact int dot from TQ_DOT_BIAS, and the group's term ((float)dot * s_a) *
// s_w is added to each output's f32 chain in ascending task order: the
// plain version's chain, for any M and either kernel, so a row's bits do
// not depend on how many rows share its launch.
//
// tq_gemm_tile: one block per 128 x 128 output tile, the last tile of a
// segment masked; four warpgroups of 64 x 64 run wgmma m64n64k32 s8 from
// the shared tiles (the mma.sync of the first design ran at ~570 int8
// TOP/s here, half of this kernel's time). 4 stages of 25 KB keep two tasks
// loading while one computes; the block unpacks task t + 1 into the other B
// buffer while task t's wgmmas run; every thread keeps its 32 outputs'
// chains in registers. 128 blocks at llama3-8b's down, M = 512.
//
// tq_gemm_split: K split across the block's warps. Eight one-warp teams
// share a 16 x 32 output tile, team w taking tasks w, w + 8, ... through
// its own ring and B tile (mma.sync m16n8k32 from ldmatrix fragments); per
// round the teams park their terms in shared memory and one thread per
// output adds them in ascending task order. It gives the H pass (R = 128
// columns) 128 blocks at M = 512 without splitting K across blocks, and
// small-M main passes a block per 32 columns.
//
// Groups of 128 (every llama3-8b / qwen3-8b group) take the per-task
// functions compiled for that size; smaller groups the contract admits take
// the same functions with the size read at run time.
//
// Narrow edges (xLSTM's gate linear wif: N = 8, rank 8). A column tile is
// masked to the columns its segment has left (any even count, also below
// 16); an operand whose rows are not whole aligned 16-byte chunks (packed
// rows of such a narrow N, Hq rows of a rank that is not a multiple of 16)
// takes byte loads that zero the columns past the edge. A rank group below
// the 32-deep MMA step (8, 16 or 24) takes one k-step whose A lanes past
// the group are zero in shared memory: int8 x int4 products summed in
// int32, so the zero lanes change no bit of the dot, and the group's one
// scale applies as before.
#include "twinquant_common.cuh"

#define GM_KMAX 128   // bytes of an A or B tile row: the largest group
#define GM_CH 8       // 16-byte chunks of such a row
#define GM_TEAMS 8    // tq_gemm_split: one-warp teams a block
#define GM_STAGES 4   // tq_gemm_split ring stages
#define GM_SPLIT_M 64 // main pass: tq_gemm_split up to this M, tq_gemm_tile above

// A team: the warps that share one output tile and one task at a time.
template <int BM_, int BN_, int WARPS_M, int WARPS_N, int STAGES_>
struct GmCfg {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int WARPS_COLS = WARPS_N, WARPS = WARPS_M * WARPS_N, THREADS = WARPS * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N, MT = WM / 16, NT = WN / 8;
  static constexpr int A_BYTES = BM * GM_KMAX;      // A tile, row-major (m, k)
  static constexpr int P_BYTES = GM_KMAX / 2 * BN;  // packed W rows (k/2, n)
  static constexpr int SLOT = (A_BYTES + P_BYTES + (BM + BN) * 4 + 127) / 128 * 128;
  static constexpr int B_BYTES = BN * GM_KMAX;      // unpacked W tile, k-major (n, k)
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
};

// tq_gemm_tile: 16 warps for its loads and unpack, 4 stages; its wgmma
// warpgroups (64 x 64 each) do not follow GmCfg's warp grid
using GmTile = GmCfg<128, 128, 8, 2, 4>;
// tq_gemm_split: a warp's 16 x 32 team tile
using GmWarp = GmCfg<16, 32, 1, 1, GM_STAGES>;

// + 1 KB to align the tiles to the 1024-byte period of the 128-byte swizzle
constexpr int kTileSmem = GmTile::STAGES * GmTile::SLOT + 2 * GmTile::B_BYTES + 1024;
constexpr int kSplitTeam = GmWarp::STAGES * GmWarp::SLOT + GmWarp::B_BYTES;
constexpr int kSplitSmem = GM_TEAMS * kSplitTeam + 2 * GM_TEAMS * GmWarp::BM * GmWarp::BN * 4;

// Swizzled byte offsets (16-byte chunk c of a row XOR-ed with row bits):
// A and B tiles in the 128-byte swizzle wgmma reads, the packed rows
// permuted so the unpack's four-row reads hit 32 banks.
__device__ __forceinline__ int gm_a_off(int r, int c) { return r * GM_KMAX + ((c ^ (r & 7)) << 4); }
__device__ __forceinline__ int gm_b_off(int n, int c) { return n * GM_KMAX + ((c ^ (n & 7)) << 4); }
template <int BN>
__device__ __forceinline__ int gm_p_off(int r, int c) {
  return ((r * (BN / 16) + c) ^ ((r >> 2) & 7)) << 4;
}

// One launch's operands: A = (xq, xs) against W = (w, ws) over the K groups,
// then (segs.n > 0) each column tile's owning segment's V groups with A =
// (hq, hs); out f32 or bf16, (M, N); expert 0's pointers and the
// per-expert element strides s_* (blockIdx.z is the expert).
struct GmArgs {
  const int8_t* xq;
  const float* xs;
  const int8_t* w;
  const float* ws;
  int M, K, N, G;
  const int8_t* hq;
  const float* hs;
  int R, hs_cols;
  TqSegs segs;
  float* out_f32;
  __nv_bfloat16* out_bf16;
  long long s_xq, s_xs, s_w, s_ws, s_hq, s_hs, s_out;
  long long s_vp[TQ_MAX_SEGS], s_vs[TQ_MAX_SEGS];
};

struct GmTask {
  const int8_t* a;   // A rows (M, lda), this group's columns
  const float* as;   // A scales, stride las
  const int8_t* w;   // packed rows of this group, tile's first column
  const float* ws;   // W scales of this group, tile's first column
  int lda, las, ldw, gsz;
};

// Where column tile bx of width bn lies: its segment j, first column n0,
// valid columns; how many tasks it walks; its expert z.
struct GmPlace {
  int j, n0, ncols, n_tasks;
  size_t z;
};

__device__ __forceinline__ GmPlace gm_place(const GmArgs& p, int bx, int bn) {
  GmPlace q;
  q.z = blockIdx.z;
  q.j = 0;
  q.n0 = bx * bn;
  int nend = p.N;
  if (p.segs.n > 0) {
    for (int t = 1; t < p.segs.n; ++t)
      if (bx >= p.segs.t_off[t]) q.j = t;
    q.n0 = p.segs.n_off[q.j] + (bx - p.segs.t_off[q.j]) * bn;
    nend = p.segs.n_off[q.j] + p.segs.n_len[q.j];
  }
  q.ncols = min(bn, nend - q.n0);
  q.n_tasks = p.K / p.G + (p.segs.n > 0 ? p.segs.r_len[q.j] / p.segs.rgroup[q.j] : 0);
  return q;
}

__device__ __forceinline__ GmTask gm_task(const GmArgs& p, const GmPlace& q, int t) {
  GmTask k;
  const int nk = p.K / p.G;
  if (t < nk) {
    k.a = p.xq + q.z * p.s_xq + (size_t)t * p.G;
    k.as = p.xs + q.z * p.s_xs + t;
    k.w = p.w + q.z * p.s_w + (size_t)t * (p.G / 2) * p.N + q.n0;
    k.ws = p.ws + q.z * p.s_ws + (size_t)t * p.N + q.n0;
    k.lda = p.K;
    k.las = nk;
    k.ldw = p.N;
    k.gsz = p.G;
  } else {
    const int v = t - nk, j = q.j, gr = p.segs.rgroup[j], nj = p.segs.n_len[j];
    const int vcol = q.n0 - p.segs.n_off[j];
    k.a = p.hq + q.z * p.s_hq + p.segs.r_off[j] + v * gr;
    k.as = p.hs + q.z * p.s_hs + p.segs.hs_off[j] + v;
    k.w = p.segs.vp[j] + q.z * p.s_vp[j] + (size_t)v * (gr / 2) * nj + vcol;
    k.ws = p.segs.vs[j] + q.z * p.s_vs[j] + (size_t)v * nj + vcol;
    k.lda = p.R;
    k.las = p.hs_cols;
    k.ldw = nj;
    k.gsz = gr;
  }
  return k;
}

// The per-task functions take the group size as a template argument GSZ
// (GM_KMAX) so trip counts and offsets fold to constants; GSZ = 0 reads it
// at run time.

// A task's A tile, packed rows and scales into a slot (the team's threads).
// Every loop has a compile-time trip count (thread tid takes items tid + k *
// THREADS), so it unrolls without remainder code.
template <class C, int GSZ>
__device__ __forceinline__ void gm_load(unsigned char* slot, const GmTask& t, int M, int m0,
                                        int ncols, int tid) {
  int8_t* A = (int8_t*)slot;
  int8_t* P = A + C::A_BYTES;
  float* as = (float*)(P + C::P_BYTES);
  float* ws = as + C::BM;
  constexpr int PCH = C::BN / 16;
  constexpr int NA = C::BM * GM_CH, NP = GM_KMAX / 2 * PCH, NS = C::BM + C::BN;
  const int g = GSZ ? GSZ : t.gsz, ach = g >> 4, half = g >> 1;
  // A in whole aligned 16-byte chunks of whole k-steps, else byte loads
  // zero-filled to the k-step (the rank edge)
  if ((g & 31) || ((((uintptr_t)t.a) | (unsigned)t.lda) & 15)) {
    const int kp = (g + 31) & ~31;
    for (int i = tid; i < C::BM * kp; i += C::THREADS) {
      const int r = i / kp, k = i - r * kp;
      const bool ok = k < g && m0 + r < M;
      A[gm_a_off(r, k >> 4) + (k & 15)] = ok ? t.a[(size_t)(m0 + r) * t.lda + k] : (int8_t)0;
    }
  } else {
#pragma unroll
  for (int k = 0; k < (NA + C::THREADS - 1) / C::THREADS; ++k) {
    const int i = tid + k * C::THREADS, r = i / GM_CH, c = i % GM_CH;
    if ((NA % C::THREADS == 0 || i < NA) && (GSZ == GM_KMAX || c < ach)) {
      const bool ok = m0 + r < M;
      tq_cp16(A + gm_a_off(r, c), ok ? t.a + (size_t)(m0 + r) * t.lda + c * 16 : t.a, ok);
    }
  }
  }
  // packed rows in whole aligned 16-byte chunks, else byte loads (the
  // narrow column edge), zero past the tile's columns
  if ((((uintptr_t)t.w) | (unsigned)t.ldw | (unsigned)ncols) & 15) {
    for (int i = tid; i < half * C::BN; i += C::THREADS) {
      const int r = i / C::BN, c = i - r * C::BN;
      P[gm_p_off<C::BN>(r, c >> 4) + (c & 15)] = c < ncols ? t.w[(size_t)r * t.ldw + c] : (int8_t)0;
    }
  } else {
#pragma unroll
  for (int k = 0; k < (NP + C::THREADS - 1) / C::THREADS; ++k) {
    const int i = tid + k * C::THREADS, r = i / PCH, c = i % PCH;
    if ((NP % C::THREADS == 0 || i < NP) && (GSZ == GM_KMAX || r < half)) {
      const bool ok = c * 16 < ncols;
      tq_cp16(P + gm_p_off<C::BN>(r, c), ok ? t.w + (size_t)r * t.ldw + c * 16 : t.w, ok);
    }
  }
  }
#pragma unroll
  for (int k = 0; k < (NS + C::THREADS - 1) / C::THREADS; ++k) {
    const int i = tid + k * C::THREADS;
    if (i < C::BM) {
      const bool ok = m0 + i < M;
      tq_cp4(as + i, ok ? t.as + (size_t)(m0 + i) * t.las : t.as, ok);
    } else if (i < NS) {
      const int c = i - C::BM;
      tq_cp4(ws + c, c < ncols ? t.ws + c : t.ws, c < ncols);
    }
  }
}

// Packed rows of a slot -> B tile (n, k), 16 x the sign-extended nibbles.
// A warp takes units of 16 columns x 32 packed rows: lane (row quad lane >>
// 2, column quad lane & 3).
template <class C, int GSZ>
__device__ __forceinline__ void gm_unpack(const unsigned char* slot, int8_t* B, int gsz, int tid) {
  const int8_t* P = (const int8_t*)slot + C::A_BYTES;
  const int warp = tid >> 5, lane = tid & 31;
  const int half = (GSZ ? GSZ : gsz) >> 1;
  constexpr int PCH = C::BN / 16, UNITS = PCH * GM_KMAX / 64;  // units of a full group
  const int cw = lane & 3, rq = lane >> 2;
#pragma unroll
  for (int k = 0; k < (UNITS + C::WARPS - 1) / C::WARPS; ++k) {
    const int u = warp + k * C::WARPS;
    const int cc = u % PCH, r0 = (u / PCH) * 32 + rq * 4;
    if ((UNITS % C::WARPS == 0 || u < UNITS) && (GSZ == GM_KMAX || r0 < half)) {
      unsigned w[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *(const unsigned*)(P + gm_p_off<C::BN>(r0 + i, cc) + cw * 4);
      tq_transpose4(w, c);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = cc * 16 + cw * 4 + q;
        *(unsigned*)(B + gm_b_off(n, r0 >> 4) + (r0 & 15)) = tq_lo16(c[q]);
        *(unsigned*)(B + gm_b_off(n, (half + r0) >> 4) + ((half + r0) & 15)) = tq_hi16(c[q]);
      }
    }
  }
}

// d = TQ_DOT_BIAS + 16 x the task's exact int dots for this thread's fragments: element
// (mt, nt, e) is tile row gm_row<C>(tid, mt, e), column gm_col<C>(tid, nt, e).
template <class C, int GSZ>
__device__ __forceinline__ void gm_mma(const unsigned char* slot, const int8_t* B, int gsz,
                                       int tid, int (&d)[C::MT][C::NT][4]) {
  const int8_t* A = (const int8_t*)slot;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::WARPS_COLS, wn = warp % C::WARPS_COLS;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[mt][nt][e] = TQ_DOT_BIAS;
  // ldmatrix row addresses: A matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31),
  // B matrices (k 0-15 | 16-31) x (columns 0-7 | 8-15)
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_c = lane >> 4;
  const int b_n = (lane & 7) + (lane >> 4) * 8, b_c = (lane >> 3) & 1;
#pragma unroll
  for (int ks = 0; ks < (((GSZ ? GSZ : gsz) + 31) >> 5); ++ks) {
    unsigned a[C::MT][4], b[C::NT][2];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
      tq_ldsm4(a[mt], A + gm_a_off(wm * C::WM + mt * 16 + a_r, 2 * ks + a_c));
#pragma unroll
    for (int np = 0; np < C::NT / 2; ++np) {
      unsigned r[4];
      tq_ldsm4(r, B + gm_b_off(wn * C::WN + np * 16 + b_n, 2 * ks + b_c));
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        tq_mma(d[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[nt][0], b[nt][1]);
  }
}

template <class C>
__device__ __forceinline__ int gm_row(int tid, int mt, int e) {
  return (tid >> 5) / C::WARPS_COLS * C::WM + mt * 16 + ((tid & 31) >> 2) + ((e >> 1) << 3);
}
template <class C>
__device__ __forceinline__ int gm_col(int tid, int nt, int e) {
  return (tid >> 5) % C::WARPS_COLS * C::WN + nt * 8 + (tid & 3) * 2 + (e & 1);
}

__device__ __forceinline__ void gm_store(const GmArgs& p, size_t z, int m, int n, float v) {
  const size_t i = z * p.s_out + (size_t)m * p.N + n;
  if (p.out_f32) p.out_f32[i] = v;
  else p.out_bf16[i] = __float2bfloat16_rn(v);
}

// wgmma operand descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (gm_a_off / gm_b_off), 8-row groups 1024 bytes apart; the
// tile starts on a 1024-byte boundary, and a k-step of 32 bytes advances the
// start address inside the swizzle atom.
__device__ __forceinline__ uint64_t gm_desc(const void* p) {
  return (uint64_t)((tq_smem(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 64 s32 of a warpgroup) += A (64 x 32 s8) * B (32 x 64 s8), asynchronous
__device__ __forceinline__ void gm_wgmma(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// Keep the compiler from moving accumulator reads or writes across a wgmma
// fence or wait.
__device__ __forceinline__ void gm_pin(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// One block per 128 x 128 output tile: four warpgroups of 64 x 64 (wr, wc),
// each with wgmma m64n64k32 s8 from the shared A and B tiles; every thread
// keeps its 32 outputs' f32 chains in registers and adds each task's terms
// in ascending order. Stages hold tasks t + 1 .. t + STAGES - 1 in flight
// (at least two loaded ahead) while task t multiplies; the block unpacks
// task t + 1 into the other B buffer while task t's wgmmas run. Grid:
// (column tiles, row tiles).
__global__ void __launch_bounds__(GmTile::THREADS, 1) tq_gemm_tile(GmArgs p) {
  using C = GmTile;
  extern __shared__ __align__(128) unsigned char gm_raw[];
  unsigned char* sm = (unsigned char*)(((uintptr_t)gm_raw + 1023) & ~(uintptr_t)1023);
  int8_t* Bt = (int8_t*)(sm + C::STAGES * C::SLOT);  // [2][B_BYTES]
  const int tid = threadIdx.x, m0 = blockIdx.y * C::BM;
  const GmPlace q = gm_place(p, blockIdx.x, C::BN);
  const int nk = p.K / p.G;
  // warpgroup g = (wr, wc) of 64 x 64; its warp ww holds rows 16 ww ..
  const int g = tid >> 7, ww = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = (g >> 1) * 64 + ww * 16 + (lane >> 2), col0 = (g & 1) * 64 + (lane & 3) * 2;
  auto gsz = [&](int t) { return t < nk ? p.G : p.segs.rgroup[q.j]; };
  // The K groups' copies (full groups): this thread's two A chunks (rows ar,
  // ar + 64), one packed-row chunk (row pr) and one scale, at offsets from
  // each task's base that do not change from task to task.
  static_assert(C::THREADS == 512, "two A chunks, one packed chunk, one scale a thread");
  const int ar = tid >> 3, ac = tid & 7, pr = tid >> 3;
  const bool a_ok0 = m0 + ar < p.M, a_ok1 = m0 + ar + 64 < p.M, p_ok = ac * 16 < q.ncols;
  // the fast path needs whole aligned 16-byte chunks of packed rows
  const bool wide = ((unsigned)p.N | (unsigned)q.ncols) % 16 == 0;
  const int a_off = (m0 + ar) * p.K + ac * 16, p_off = pr * p.N + ac * 16;
  const int a_dst = gm_a_off(ar, ac), p_dst = C::A_BYTES + gm_p_off<C::BN>(pr, ac);
  const bool s_ok = tid < C::BM ? m0 + tid < p.M : tid - C::BM < q.ncols;
  const int s_off = tid < C::BM ? (m0 + tid) * nk : tid - C::BM;
  auto load = [&](int t) {
    if (t < q.n_tasks) {
      unsigned char* slot = sm + (t % C::STAGES) * C::SLOT;
      if (t < nk && p.G == GM_KMAX && wide) {
        const int8_t* a = p.xq + q.z * p.s_xq + (size_t)t * GM_KMAX;
        const int8_t* w = p.w + q.z * p.s_w + (size_t)t * (GM_KMAX / 2) * p.N + q.n0;
        tq_cp16(slot + a_dst, a_ok0 ? a + a_off : a, a_ok0);
        tq_cp16(slot + a_dst + 64 * GM_KMAX, a_ok1 ? a + a_off + 64 * p.K : a, a_ok1);
        tq_cp16(slot + p_dst, p_ok ? w + p_off : w, p_ok);
        if (tid < C::BM + C::BN) {
          const float* sc = tid < C::BM ? p.xs + q.z * p.s_xs + t
                                        : p.ws + q.z * p.s_ws + (size_t)t * p.N + q.n0;
          tq_cp4(slot + C::A_BYTES + C::P_BYTES + 4 * tid, s_ok ? sc + s_off : sc, s_ok);
        }
      } else {
        const GmTask k = gm_task(p, q, t);
        if (k.gsz == GM_KMAX) gm_load<C, GM_KMAX>(slot, k, p.M, m0, q.ncols, tid);
        else gm_load<C, 0>(slot, k, p.M, m0, q.ncols, tid);
      }
    }
    tq_cp_commit();
  };
  auto unpack = [&](int t) {
    const unsigned char* slot = sm + (t % C::STAGES) * C::SLOT;
    int8_t* B = Bt + (t & 1) * C::B_BYTES;
    if (gsz(t) == GM_KMAX) gm_unpack<C, GM_KMAX>(slot, B, GM_KMAX, tid);
    else gm_unpack<C, 0>(slot, B, gsz(t), tid);
  };

  // fragment element i = 4 j + e: row row0 + 8 (e >> 1), column col0 + 8 j + (e & 1)
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

#pragma unroll
  for (int t = 0; t < C::STAGES - 1; ++t) load(t);
  tq_cp_wait<C::STAGES - 2>();
  __syncthreads();
  unpack(0);
  for (int t = 0; t < q.n_tasks; ++t) {
    tq_cp_wait<C::STAGES - 3>();
    // this thread's copies and unpack stores, visible to the wgmma (async) proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load(t + C::STAGES - 1);
    const unsigned char* slot = sm + (t % C::STAGES) * C::SLOT;
    const uint64_t da = gm_desc(slot + (g >> 1) * 64 * GM_KMAX);
    const uint64_t db = gm_desc(Bt + (t & 1) * C::B_BYTES + (g & 1) * 64 * GM_KMAX);
    int d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = TQ_DOT_BIAS;
    gm_pin(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (gsz(t) == GM_KMAX) {
#pragma unroll
      for (int ks = 0; ks < GM_KMAX / 32; ++ks) gm_wgmma(d, da + 2 * ks, db + 2 * ks);
    } else {
      for (int ks = 0; ks < ((gsz(t) + 31) >> 5); ++ks) gm_wgmma(d, da + 2 * ks, db + 2 * ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    gm_pin(d);
    if (t + 1 < q.n_tasks) unpack(t + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    gm_pin(d);
    const float* as = (const float*)(slot + C::A_BYTES + C::P_BYTES);
    const float* ws = as + C::BM;
    const float sa[2] = {as[row0], as[row0 + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float sw0 = ws[col0 + 8 * j], sw1 = ws[col0 + 8 * j + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * j + e] = __fadd_rn(acc[4 * j + e],
                                   tq_term(d[4 * j + e], sa[e >> 1], (e & 1) ? sw1 : sw0));
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int m = m0 + row0 + 8 * ((i & 3) >> 1), c = col0 + 8 * (i >> 2) + (i & 1);
    if (m < p.M && c < q.ncols) gm_store(p, q.z, m, q.n0 + c, acc[i]);
  }
}

// K split across the block's warps: GM_TEAMS one-warp teams per 16 x 32
// output tile, team w taking tasks w, w + GM_TEAMS, ... through its own
// ring of stages and B tile. Per round each team parks its task's terms in
// shared memory and, after one barrier, one thread per output adds the
// round's terms in ascending task order: the same f32 chain as
// tq_gemm_tile. Used for the H pass (K groups only) and for the main pass
// at small M, where 128-row tiles would leave most SMs idle.
__global__ void __launch_bounds__(GM_TEAMS * 32, 1) tq_gemm_split(GmArgs p) {
  using C = GmWarp;
  constexpr int TILE = C::BM * C::BN, OUT = TILE / (GM_TEAMS * 32);
  extern __shared__ __align__(128) unsigned char gm_smem[];
  const int team = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* ring = gm_smem + team * kSplitTeam;
  int8_t* B = (int8_t*)(ring + C::STAGES * C::SLOT);
  float* terms = (float*)(gm_smem + GM_TEAMS * kSplitTeam);  // [2][teams][TILE]
  const int m0 = blockIdx.y * C::BM;
  const GmPlace q = gm_place(p, blockIdx.x, C::BN);
  const int nk = p.K / p.G;
  const int rounds = (q.n_tasks + GM_TEAMS - 1) / GM_TEAMS;
  auto load = [&](int i) {  // this team's i-th task
    const int t = i * GM_TEAMS + team;
    if (t < q.n_tasks) {
      unsigned char* slot = ring + (i % C::STAGES) * C::SLOT;
      const GmTask k = gm_task(p, q, t);
      if (k.gsz == GM_KMAX) gm_load<C, GM_KMAX>(slot, k, p.M, m0, q.ncols, lane);
      else gm_load<C, 0>(slot, k, p.M, m0, q.ncols, lane);
    }
    tq_cp_commit();
  };

#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) load(i);
  float acc[OUT];
#pragma unroll
  for (int o = 0; o < OUT; ++o) acc[o] = 0.f;
  for (int i = 0; i < rounds; ++i) {
    load(i + C::STAGES - 1);
    tq_cp_wait<C::STAGES - 1>();
    __syncwarp();
    const int t = i * GM_TEAMS + team;
    if (t < q.n_tasks) {
      const int g = t < nk ? p.G : p.segs.rgroup[q.j];
      const unsigned char* slot = ring + (i % C::STAGES) * C::SLOT;
      int d[C::MT][C::NT][4];
      if (g == GM_KMAX) {
        gm_unpack<C, GM_KMAX>(slot, B, g, lane);
        __syncwarp();
        gm_mma<C, GM_KMAX>(slot, B, g, lane, d);
      } else {
        gm_unpack<C, 0>(slot, B, g, lane);
        __syncwarp();
        gm_mma<C, 0>(slot, B, g, lane, d);
      }
      const float* as = (const float*)(slot + C::A_BYTES + C::P_BYTES);
      const float* ws = as + C::BM;
      float* tb = terms + ((i & 1) * GM_TEAMS + team) * TILE;
      const float sa[2] = {as[gm_row<C>(lane, 0, 0)], as[gm_row<C>(lane, 0, 2)]};
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const float sw[2] = {ws[gm_col<C>(lane, nt, 0)], ws[gm_col<C>(lane, nt, 1)]};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gm_row<C>(lane, 0, 2 * h), c = gm_col<C>(lane, nt, 0);
          *(float2*)&tb[r * C::BN + c] = make_float2(tq_term(d[0][nt][2 * h], sa[h], sw[0]),
                                                     tq_term(d[0][nt][2 * h + 1], sa[h], sw[1]));
        }
      }
    }
    __syncthreads();
    const int nw = min(GM_TEAMS, q.n_tasks - i * GM_TEAMS);
    const float* rb = terms + (i & 1) * GM_TEAMS * TILE + threadIdx.x;
#pragma unroll
    for (int o = 0; o < OUT; ++o)
      for (int w = 0; w < nw; ++w) acc[o] = __fadd_rn(acc[o], rb[w * TILE + o * GM_TEAMS * 32]);
  }
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    const int e = threadIdx.x + o * GM_TEAMS * 32;
    const int m = m0 + e / C::BN, c = e % C::BN;
    if (m < p.M && c < q.ncols) gm_store(p, q.z, m, q.n0 + c, acc[o]);
  }
}

// Dynamic shared memory of the larger launch (contracts.gemm_smem_bytes).
extern "C" int tq_gemm_smem_bytes() { return kTileSmem > kSplitSmem ? kTileSmem : kSplitSmem; }

// One pass over E experts: split (small M, or the H pass) or 128 x 128 tiles.
static int launch_pass(GmArgs p, int E, bool split, cudaStream_t st) {
  const int bm = split ? GmWarp::BM : GmTile::BM, bn = split ? GmWarp::BN : GmTile::BN;
  const int tiles = p.segs.n > 0 ? tq_set_tiles(p.segs, bn) : (p.N + bn - 1) / bn;
  dim3 grid(tiles, (p.M + bm - 1) / bm, E);
  int err;
  if (split) {
    err = tq_smem_attr((const void*)tq_gemm_split, kSplitSmem);
    if (err) return err;
    tq_gemm_split<<<grid, GM_TEAMS * 32, kSplitSmem, st>>>(p);
  } else {
    err = tq_smem_attr((const void*)tq_gemm_tile, kTileSmem);
    if (err) return err;
    tq_gemm_tile<<<grid, GmTile::THREADS, kTileSmem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// x (M, K) bf16 -> out (M, N) bf16 for a fused group of n_seg segments,
// for each of E experts; arguments as tq_dual_gemv, with hf (M, R) f32 (H
// itself). Four launches: quantize, H (split), requantize, main (split up to
// GM_SPLIT_M rows, tiles above; both give every output the same f32 chain,
// so a row's bits do not depend on M). Returns the first non-zero
// cudaGetLastError(), else 0.
extern "C" int tq_dual_gemm(const void* x, const void* up, const void* us, const void* rp,
                            const void* rs, int E, int M, int K, int N, int R, int G, int a_bits,
                            int n_seg, const void* seg_info, const void* vps, const void* vss,
                            const void* strides, void* xq, void* xs, void* hf, void* hq,
                            void* hs, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int qmax = (1 << (a_bits - 1)) - 1;
  TqSegs segs = tq_make_segs(n_seg, (const long long*)seg_info, (const void* const*)vps,
                             (const void* const*)vss);
  const TqExp ex = tq_make_exp((const long long*)strides);
  int err = tq_launch_quantize(x, xq, xs, E, M, K, G, qmax, ex, st);
  if (err) return err;
  GmArgs p;
  p.s_xq = ex.xq;
  p.s_xs = ex.xs;
  p.s_hq = ex.hq;
  p.s_hs = ex.hs;
  for (int j = 0; j < TQ_MAX_SEGS; ++j) {
    p.s_vp[j] = ex.vp[j];
    p.s_vs[j] = ex.vs[j];
  }
  p.xq = (const int8_t*)xq;
  p.xs = (const float*)xs;
  p.w = (const int8_t*)up;
  p.ws = (const float*)us;
  p.M = M;
  p.K = K;
  p.N = R;
  p.G = G;
  p.hq = nullptr;
  p.hs = nullptr;
  p.R = R;
  p.hs_cols = 0;
  p.segs = segs;
  p.segs.n = 0;
  p.out_f32 = (float*)hf;
  p.out_bf16 = nullptr;
  p.s_w = ex.up;
  p.s_ws = ex.us;
  p.s_out = ex.hf;
  err = launch_pass(p, E, true, st);
  if (err) return err;
  err = tq_launch_requant((const float*)hf, 1, hq, hs, E, M, R, segs, qmax, ex, st);
  if (err) return err;
  p.w = (const int8_t*)rp;
  p.ws = (const float*)rs;
  p.s_w = ex.rp;
  p.s_ws = ex.rs;
  p.s_out = ex.out;
  p.N = N;
  p.hq = (const int8_t*)hq;
  p.hs = (const float*)hs;
  p.hs_cols = tq_hs_cols(segs);
  p.segs = segs;
  p.out_f32 = nullptr;
  p.out_bf16 = (__nv_bfloat16*)out;
  return launch_pass(p, E, M <= GM_SPLIT_M, st);
}
