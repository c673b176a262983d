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
// over the memory rate. The design spreads every pass over more blocks than
// the card has SMs and keeps ~48 KB of copies in flight on each.
//
// Over an expert axis (E > 1: an MoE layer's stacked packs) every launch
// below runs gridDim.z = E, each block offsetting its pointers by its
// expert's strides (TqExp) first.
//
// Three launches:
//   1. tq_gemv_h: one warp per (K group, 16 columns of the stacked U). It
//      quantizes its group of X itself (the blocks of column 0 also write
//      Xq / xs for launch 3) and writes the group's f32 terms
//      ((float)dot * s_x) * s_u of H, (M, R) a group, to global memory: K is
//      split across (R/16) x (K/G) blocks, 896 at llama3-8b's down.
//   2. tq_requant_h: adds each H column's terms in ascending group order,
//      then requantizes H per segment (twinquant_common.cuh).
//   3. tq_gemv_main: one block of 8 warps per 16 output columns (256 blocks
//      at N = 4096, three an SM), the column tiles cut per segment
//      (tq_set_tiles): a segment narrower than 16 columns, or a last tile
//      past a segment's end, is one masked tile whose loads zero the
//      columns past the edge and whose stores stop at it. A task is one scale group: the K groups of
//      Rq, then the owning segment's V groups with A = Hq. Warp w takes
//      tasks w, w + 8, ... through its own ring of 3 cp.async stages
//      (16-byte copies of the packed rows, its activation rows and scales).
//      Per round each warp parks its task's M x 16 terms in shared memory
//      and, after one barrier, one thread per output adds the round's terms
//      in ascending task order, so every output's f32 chain is the plain
//      version's.
//
// The product runs on the tensor cores with the roles swapped, Y^T = W^T
// X^T: mma.sync m16n8k32 s8 with the 16 output columns as A and the <= 8
// token rows as n8 (rows past M are never stored). One MMA covers 16
// columns x 8 rows x 32 k, so the instructions per weight byte do not grow
// with M, as __dp4a's would (one per row per 4 bytes). A lane's A operand
// is 4 consecutive packed rows of one column: four 32-bit shared loads, a
// byte transpose (__byte_perm) and the nibble unpack tq_lo16 / tq_hi16 (low
// nibbles are the group's rows j, high nibbles rows j + G/2); the
// accumulator starts at TQ_DOT_BIAS, so tq_term reads (float)dot off it
// exactly. Packed rows sit in shared memory at permuted 16-byte slots and
// activation rows are padded, which makes every fragment load
// conflict-free. Groups of 128 take 16-byte copies and unrolled k-steps;
// smaller or unaligned groups (odd ranks the contract admits) take byte
// loads and zero the rows past the group.
#include "twinquant_common.cuh"

#define GV_NT 16     // output columns a block: one 16-byte chunk of a packed row
#define GV_WARPS 8   // main pass: warps a block, one task each per round
#define GV_STAGES 3  // tasks in a warp's cp.async ring
#define GV_BLOCKS 3  // main-pass blocks an SM (__launch_bounds__)
#define GV_XLD 144   // activation row: low-nibble half at 0, high half at 64, 16 pad
#define GV_ROWS 64   // packed rows of the largest group (G = 128)

// One task's operands in shared memory.
struct __align__(16) GvSlot {
  int8_t w[GV_ROWS][GV_NT];   // packed row j at slot gv_pos(j); rows past the group zero
  int8_t x[TQ_MMAX][GV_XLD];  // activation rows of the task's group (split halves)
  float ws[GV_NT];            // weight scales of the task's group
  float xs[TQ_MMAX];          // activation scales of the task's group
};

// Shared slot of packed row j: rows 4t + i of a k-step, t = 0..3, land in 4
// different bank quads.
__device__ __forceinline__ int gv_pos(int j) { return j ^ ((j >> 3) & 1); }

// One scale group of one operand pair: activation rows a (row stride lda),
// their scales as (stride las), packed weight rows w (row stride ldw) of a
// 16-column tile with ncols valid columns, their scales ws.
struct GvTask {
  const int8_t* a;
  const float* as;
  const int8_t* w;
  const float* ws;
  int lda, las, ldw, half, ncols;
};

// Whether a task takes the fast loads: a full group (G = 128) of whole,
// 16-byte aligned packed and activation rows.
__device__ __forceinline__ bool gv_full(const GvTask& t) {
  return t.half == GV_ROWS && t.ncols == GV_NT &&
         ((((uintptr_t)t.w) | ((uintptr_t)t.a) | (unsigned)t.ldw | (unsigned)t.lda) & 15) == 0;
}

// A full task into s (one warp): 64 packed rows and M activation rows as
// 16-byte copies, both scale vectors.
__device__ __forceinline__ void gv_load_full(GvSlot& s, const GvTask& t, int M, int lane) {
#pragma unroll
  for (int k = 0; k < GV_ROWS / 32; ++k) {
    const int j = lane + 32 * k;
    tq_cp16(s.w[gv_pos(j)], t.w + (size_t)j * t.ldw, true);
  }
#pragma unroll
  for (int k = 0; k < TQ_MMAX * 8 / 32; ++k) {  // 8 chunks a row: 4 a half
    const int i = lane + 32 * k, m = i >> 3, hh = (i >> 2) & 1, c = i & 3;
    if (m < M) tq_cp16(&s.x[m][hh * 64 + c * 16], t.a + (size_t)m * t.lda + hh * 64 + c * 16, true);
  }
  const int m = lane - GV_NT;
  if (lane < GV_NT) tq_cp4(&s.ws[lane], t.ws + lane, true);
  else if (m < M) tq_cp4(&s.xs[m], t.as + (size_t)m * t.las, true);
}

// Any other task (groups that are not whole 16-row k-steps, columns past
// R, unaligned rows): byte loads, rows past the group zero.
__device__ void gv_load_any(GvSlot& s, const GvTask& t, int M, int lane) {
  const int rows = ((t.half + 15) >> 4) << 4, h = t.half;
  for (int j = lane; j < rows; j += 32) {
    unsigned v[4] = {0u, 0u, 0u, 0u};
    if (j < h)
      for (int c = 0; c < t.ncols; ++c)
        v[c >> 2] |= (unsigned)(uint8_t)t.w[(size_t)j * t.ldw + c] << (8 * (c & 3));
    *(uint4*)s.w[gv_pos(j)] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  for (int i = lane; i < M * 2 * h; i += 32) {
    const int m = i / (2 * h), r = i - m * 2 * h, hh = r >= h;
    s.x[m][hh * 64 + r - hh * h] = t.a[(size_t)m * t.lda + r];
  }
  const int m = lane - GV_NT;
  if (lane < GV_NT) tq_cp4(&s.ws[lane], lane < t.ncols ? t.ws + lane : t.ws, lane < t.ncols);
  else if (m < M) tq_cp4(&s.xs[m], t.as + (size_t)m * t.las, true);
}

// d (fragment: column 2 gid + (e >> 1), token 2 tig + (e & 1)) = TQ_DOT_BIAS +
// 16 x the task's exact int dots. HALF = GV_ROWS (a full group of 128) unrolls the
// k-steps; HALF = 0 reads half at run time.
template <int HALF>
__device__ __forceinline__ void gv_mma(const GvSlot& s, int half, int lane, int (&d)[4]) {
  const int gid = lane >> 2, tig = lane & 3;
  const int b = (gid & 1) * 2;  // byte of column 2 gid in its 32-bit word
  const unsigned sel = b | ((b + 4) << 4) | ((b + 1) << 8) | ((b + 5) << 12);
  d[0] = d[1] = d[2] = d[3] = TQ_DOT_BIAS;
  const int nk = ((HALF ? HALF : half) + 15) >> 4;
#pragma unroll
  for (int ks = 0; ks < nk; ++ks) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *(const unsigned*)&s.w[gv_pos(ks * 16 + tig * 4 + i)][(gid >> 1) * 4];
    const unsigned t01 = __byte_perm(w[0], w[1], sel), t23 = __byte_perm(w[2], w[3], sel);
    const unsigned ca = __byte_perm(t01, t23, 0x5410), cb = __byte_perm(t01, t23, 0x7632);
    const unsigned b0 = *(const unsigned*)&s.x[gid][ks * 16 + tig * 4];
    const unsigned b1 = *(const unsigned*)&s.x[gid][64 + ks * 16 + tig * 4];
    tq_mma(d, tq_lo16(ca), tq_lo16(cb), tq_hi16(ca), tq_hi16(cb), b0, b1);
  }
}

// Launch 1: H terms. Block (one warp) = (16 columns of U, K group g).
// terms[g][m][c] = ((float)dot * xs[m, g]) * us[g, c] for m < M, c < R.
__global__ void __launch_bounds__(32) tq_gemv_h(
    const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
    const int8_t* __restrict__ up, const float* __restrict__ us, int M, int K, int R, int G,
    int qmax, float* __restrict__ terms, TqExp ex) {
  __shared__ GvSlot s;
  const size_t z = blockIdx.z;
  x += z * ex.x;
  xq += z * ex.xq;
  xs += z * ex.xs;
  up += z * ex.up;
  us += z * ex.us;
  terms += z * ex.hf;
  const int lane = threadIdx.x, g = blockIdx.y, c0 = blockIdx.x * GV_NT;
  const int half = G / 2, ng = K / G;
  GvTask t;
  t.w = up + (size_t)g * half * R + c0;
  t.ws = us + (size_t)g * R + c0;
  t.ldw = R;
  t.half = half;
  t.ncols = min(GV_NT, R - c0);
  if (half == GV_ROWS && t.ncols == GV_NT && ((((uintptr_t)t.w) | (unsigned)R) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < GV_ROWS / 32; ++k) {
      const int j = lane + 32 * k;
      tq_cp16(s.w[gv_pos(j)], t.w + (size_t)j * R, true);
    }
  } else {
    for (int j = lane; j < ((half + 15) >> 4) << 4; j += 32) {
      unsigned v[4] = {0u, 0u, 0u, 0u};
      if (j < half)
        for (int c = 0; c < t.ncols; ++c)
          v[c >> 2] |= (unsigned)(uint8_t)t.w[(size_t)j * R + c] << (8 * (c & 3));
      *(uint4*)s.w[gv_pos(j)] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  if (lane < GV_NT) tq_cp4(&s.ws[lane], lane < t.ncols ? t.ws + lane : t.ws, lane < t.ncols);
  tq_cp_commit();
  // quantize X[:, g] (as tq_quantize_act) while the weights are in flight
  for (int m = 0; m < M; ++m) {
    const __nv_bfloat16* row = x + (size_t)m * K + (size_t)g * G;
    float v[GV_ROWS * 2 / 32];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < GV_ROWS * 2 / 32; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < G ? __bfloat162float(row[e]) : 0.f;
      amax = fmaxf(amax, fabsf(v[i]));
    }
    const float scale = tq_scale(tq_warp_max(amax), qmax);
#pragma unroll
    for (int i = 0; i < GV_ROWS * 2 / 32; ++i) {
      const int e = lane + 32 * i;
      if (e < G) {
        const int8_t q = tq_quant(v[i], scale, qmax);
        const int hh = e >= half;
        s.x[m][hh * 64 + e - hh * half] = q;
        if (blockIdx.x == 0) xq[(size_t)m * K + (size_t)g * G + e] = q;
      }
    }
    if (lane == 0) {
      s.xs[m] = scale;
      if (blockIdx.x == 0) xs[(size_t)m * ng + g] = scale;
    }
  }
  tq_cp_wait<0>();
  __syncwarp();
  int d[4];
  if (half == GV_ROWS) gv_mma<GV_ROWS>(s, half, lane, d);
  else gv_mma<0>(s, half, lane, d);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = 2 * gid + (e >> 1), m = 2 * tig + (e & 1);
    if (m < M && col < t.ncols)
      terms[((size_t)g * M + m) * R + c0 + col] = tq_term(d[e], s.xs[m], s.ws[col]);
  }
}

// Launch 3: Y[:, n0:n0+16] = sum over the K groups of (Xq, xs) x (Rq, rs),
// then the owning segment's V groups from (Hq, hs), in ascending order.
__global__ void __launch_bounds__(GV_WARPS * 32, GV_BLOCKS) tq_gemv_main(
    const int8_t* __restrict__ xq, const float* __restrict__ xs, const int8_t* __restrict__ rp,
    const float* __restrict__ rs, int M, int K, int N, int G, const int8_t* __restrict__ hq,
    const float* __restrict__ hs, int R, int hs_cols, TqSegs segs,
    __nv_bfloat16* __restrict__ out, TqExp ex) {
  extern __shared__ __align__(128) unsigned char gv_smem[];
  const size_t z = blockIdx.z;
  xq += z * ex.xq;
  xs += z * ex.xs;
  rp += z * ex.rp;
  rs += z * ex.rs;
  hq += z * ex.hq;
  hs += z * ex.hs;
  out += z * ex.out;
  GvSlot* slots = (GvSlot*)gv_smem;                                    // [warps][stages]
  float* tbuf = (float*)(slots + GV_WARPS * GV_STAGES);               // [2][warps][M x 16]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int j = 0;
  for (int t = 1; t < segs.n; ++t)
    if ((int)blockIdx.x >= segs.t_off[t]) j = t;
  const int n0 = segs.n_off[j] + ((int)blockIdx.x - segs.t_off[j]) * GV_NT;
  const int ncols = min(GV_NT, segs.n_off[j] + segs.n_len[j] - n0);  // masked edge tile
  const int gr = segs.rgroup[j], nk = K / G;
  const int n_tasks = nk + segs.r_len[j] / gr;
  const int rounds = (n_tasks + GV_WARPS - 1) / GV_WARPS;
  const int vcol = n0 - segs.n_off[j], nj = segs.n_len[j];
  const int8_t* vpj = segs.vp[j] + z * ex.vp[j];
  const float* vsj = segs.vs[j] + z * ex.vs[j];

  auto task = [&](int t) {
    GvTask k;
    k.ncols = ncols;
    if (t < nk) {
      k.a = xq + (size_t)t * G;
      k.as = xs + t;
      k.w = rp + (size_t)t * (G / 2) * N + n0;
      k.ws = rs + (size_t)t * N + n0;
      k.lda = K;
      k.las = nk;
      k.ldw = N;
      k.half = G / 2;
    } else {
      const int v = t - nk;
      k.a = hq + segs.r_off[j] + v * gr;
      k.as = hs + segs.hs_off[j] + v;
      k.w = vpj + (size_t)v * (gr / 2) * nj + vcol;
      k.ws = vsj + (size_t)v * nj + vcol;
      k.lda = R;
      k.las = hs_cols;
      k.ldw = nj;
      k.half = gr / 2;
    }
    return k;
  };
  auto load = [&](int i) {  // this warp's i-th task into its ring
    const int t = i * GV_WARPS + warp;
    if (t < n_tasks) {
      const GvTask k = task(t);
      GvSlot& s = slots[warp * GV_STAGES + i % GV_STAGES];
      if (gv_full(k)) gv_load_full(s, k, M, lane);
      else gv_load_any(s, k, M, lane);
    }
    tq_cp_commit();
  };

#pragma unroll
  for (int i = 0; i < GV_STAGES - 1; ++i) load(i);
  const int mo = threadIdx.x / GV_NT, co = threadIdx.x % GV_NT;
  const int gid = lane >> 2, tig = lane & 3;
  float acc = 0.f;
  for (int i = 0; i < rounds; ++i) {
    load(i + GV_STAGES - 1);
    tq_cp_wait<GV_STAGES - 1>();
    __syncwarp();
    const int t = i * GV_WARPS + warp;
    float* tb = tbuf + ((i & 1) * GV_WARPS + warp) * (TQ_MMAX * GV_NT);
    if (t < n_tasks) {
      const GvSlot& s = slots[warp * GV_STAGES + i % GV_STAGES];
      int d[4];
      const int half = t < nk ? G / 2 : gr / 2;
      if (half == GV_ROWS) gv_mma<GV_ROWS>(s, half, lane, d);
      else gv_mma<0>(s, half, lane, d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * gid + (e >> 1), m = 2 * tig + (e & 1);
        if (m < M) tb[m * GV_NT + col] = tq_term(d[e], s.xs[m], s.ws[col]);
      }
    }
    __syncthreads();
    if (mo < M) {
      const int nw = min(GV_WARPS, n_tasks - i * GV_WARPS);
      const float* rb = tbuf + (i & 1) * GV_WARPS * (TQ_MMAX * GV_NT) + mo * GV_NT + co;
      for (int w = 0; w < nw; ++w) acc = __fadd_rn(acc, rb[w * (TQ_MMAX * GV_NT)]);
    }
  }
  if (mo < M && co < ncols) out[(size_t)mo * N + n0 + co] = __float2bfloat16_rn(acc);
}

static const int kGvMainSmem =
    GV_WARPS * GV_STAGES * (int)sizeof(GvSlot) + 2 * GV_WARPS * TQ_MMAX * GV_NT * 4;

// Dynamic shared memory of the main pass (contracts.gemv_smem_bytes).
extern "C" int tq_gemv_smem_bytes() { return kGvMainSmem; }

// x (M, K) bf16 -> out (M, N) bf16 for a fused group of n_seg segments, for
// each of E experts. seg_info: n_seg x (n_off, n_len, r_off, r_len, rgroup)
// int64 on the host; vps/vss: host arrays of n_seg device pointers (expert
// 0's); strides: the host array tq_make_exp reads (all 0 for E = 1).
// Scratch (device, per expert): xq (M, K) int8, xs (M, K/G) f32, hf (K/G,
// M, R) f32 (H's per-group terms), hq (M, R) int8, hs (M, hs_cols) f32.
// Three launches; returns the first non-zero cudaGetLastError() of them,
// else 0.
extern "C" int tq_dual_gemv(const void* x, const void* up, const void* us, const void* rp,
                            const void* rs, int E, int M, int K, int N, int R, int G, int a_bits,
                            int n_seg, const void* seg_info, const void* vps, const void* vss,
                            const void* strides, void* xq, void* xs, void* hf, void* hq,
                            void* hs, void* out, void* stream) {
  int err = tq_smem_attr((const void*)tq_gemv_main, kGvMainSmem);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const int qmax = (1 << (a_bits - 1)) - 1;
  TqSegs segs = tq_make_segs(n_seg, (const long long*)seg_info, (const void* const*)vps,
                             (const void* const*)vss);
  const TqExp ex = tq_make_exp((const long long*)strides);
  const int hs_cols = tq_hs_cols(segs);
  dim3 hgrid((R + GV_NT - 1) / GV_NT, K / G, E);
  tq_gemv_h<<<hgrid, 32, 0, st>>>((const __nv_bfloat16*)x, (int8_t*)xq, (float*)xs,
                                  (const int8_t*)up, (const float*)us, M, K, R, G, qmax,
                                  (float*)hf, ex);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = tq_launch_requant((const float*)hf, K / G, hq, hs, E, M, R, segs, qmax, ex, st);
  if (err) return err;
  const int tiles = tq_set_tiles(segs, GV_NT);
  tq_gemv_main<<<dim3(tiles, 1, E), GV_WARPS * 32, kGvMainSmem, st>>>(
      (const int8_t*)xq, (const float*)xs, (const int8_t*)rp, (const float*)rs, M, K, N, G,
      (const int8_t*)hq, (const float*)hs, R, hs_cols, segs, (__nv_bfloat16*)out, ex);
  return (int)cudaGetLastError();
}
