// Ragged paged attention for Hopper, sm_90a: one call (three device
// launches) for a flat batch of T rows that mixes decode rows and prompt
// chunks of many slots.
//
// Replaces: repro/kernels/ragged_attention.py : ragged_attention_kernel
// (body _ragged_attention_fwd).
//
// Row t belongs to slot slot[t] (slot == B marks a pad row); it attends the
// slot's committed pages [0, ctx[slot]) and the rows of the same slot
// before it, then itself. The engine gives each slot one contiguous run of
// rows with consecutive positions from ctx[slot] (one decode row, or one
// chunk), and ctx[slot] <= maxp * page; the kernel relies on that contract,
// which the host checks while the metadata is still numpy
// (contracts.check_ragged_rows). Pad rows are written as zeros.
//
// What bounds it: bytes. Each page in use is read once per (KV head, row
// tile) and used by all query heads of the KV head, so the least time is
// about 2 * sum over slots with rows of ctx * KV * hd * 2 bytes (plus the T
// rows of q, k, v and the output) over the memory rate.
//
// Design: the split-KV schedule of attention_common.cuh, with the slot's
// in-batch rows as the panel. The TPU kernel sweeps a sequential (B,
// max_pages) grid with the whole T-row panel resident and masks the rows of
// other slots; here each slot's run is cut into tiles of R = 32 / g rows
// (R x g <= 32 query vectors), the tiles enumerated in slot order: slot s's
// tiles are z = tb[s] .. tb[s + 1] - 1, tb the prefix sum of ceil(rows /
// R), so at most Z = B + ceil(T / R) tiles exist. Three launches:
//   * rg_plan_kernel (one block): builds the run table from slot[] (each
//     slot's first row, row count and first tile) in shared memory, writes
//     each tile z's (slot, first row of the run, r0, rows, ctx) and the
//     work list: every (tile, chunk of PAGED_CHUNK absolute positions) that
//     holds a key the tile's rows need, tile by tile, chunks ascending, and
//     its length W. All of it lives in the scratch, on the device: the host
//     learns nothing and waits for nothing.
//   * rg_split_kernel: one block of eight warps per (KV head, work item),
//     KV heads fastest, so the W x KV working blocks are scheduled first;
//     blocks past W exit after one read. A block folds its chunk for its
//     tile's rows (att_split_chunk) into the scratch, at (tile, KV head,
//     chunk, query vector).
//   * rg_combine_kernel: per (tile z, KV head, 4 query vectors), one warp
//     per vector folds the row's chunk partials ascending, then the self
//     term (att_combine_vec); its blocks also zero the pad rows among rows
//     [z R, z R + R).
// A row's position is ctx[slot] + its index in the run, and every chunk and
// tile sits at fixed absolute positions, so decode rows and prompt rows
// take one path, and a row's bits depend neither on how its prompt was
// chunked nor on which other slots share the launch.
#include "attention_common.cuh"

#define RG_PLAN_THREADS 256
#define RG_WARPS 8  // two groups of four warps a split block: it holds 32 query vectors
#define RG_NT (ATT_QV_MAX / 8)  // n8 tiles of query vectors a split block holds
#define RG_QV ATT_QV_MAX        // query vectors of a tile's partials in the scratch

struct RgArgs {
  AttConst k;  // q (T, H, hd), pools, in-batch rows kt/vt (T, KV, hd), bt (B,
               // maxp), scratch (Z, KV, nc, RG_QV, hd) and (..., 2): m, l; shapes
  const int* slot;
  const int* ctx;
  int* plan;  // W, 3 spare, Z tile entries of 8 ints, the work list (Z * nc)
  int T, B, chunk, nc;
  int rows;  // R: rows a tile
  int Z;     // B + ceil(T / R): the most tiles a launch can have
};

// bytes of the plan launch's shared memory: the run table (first row, row
// count and first tile of each slot), each tile's chunks and their offsets
// in the work list
inline size_t rg_plan_smem(int B, int Z) { return ((size_t)3 * (B + 1) + 2 * (Z + 1)) * 4; }

// Exclusive prefix of n[0 .. len) into off[], by warp 0 (lane l sums a
// contiguous range, then a shuffle scan); returns the total in lane 31.
__device__ __forceinline__ int rg_prefix(const int* n, int* off, int len) {
  const int lane = threadIdx.x & 31, per = (len + 31) / 32, s0 = lane * per,
            s1 = min(s0 + per, len);
  int sum = 0;
  for (int s = s0; s < s1; ++s) {
    off[s] = sum;
    sum += n[s];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(ATT_FULL, incl, o);
    if (lane >= o) incl += y;
  }
  for (int s = s0; s < s1; ++s) off[s] += incl - sum;
  return incl;
}

__global__ void __launch_bounds__(RG_PLAN_THREADS) rg_plan_kernel(const RgArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, T = a.T, R = a.rows, Z = a.Z, tid = threadIdx.x;
  int* st = reinterpret_cast<int*>(smem);  // first row of each slot's run
  int* cnt = st + B + 1;                   // its rows
  int* tb = cnt + B + 1;                   // its first tile (tb[B]: the tile count)
  int* nch = tb + B + 1;                   // chunks of each tile's work
  int* off = nch + Z + 1;                  // their first work item
  for (int s = tid; s <= B; s += RG_PLAN_THREADS) {
    st[s] = 0;
    cnt[s] = 0;
  }
  __syncthreads();
  // run boundaries (one run a slot, by the row contract)
  for (int t = tid; t < T; t += RG_PLAN_THREADS) {
    const int s = a.slot[t];
    if (s < 0 || s >= B) continue;
    if (t == 0 || a.slot[t - 1] != s) st[s] = t;
    if (t == T - 1 || a.slot[t + 1] != s) cnt[s] = t + 1;  // the run's end, for now
  }
  __syncthreads();
  for (int s = tid; s < B; s += RG_PLAN_THREADS) {
    const int n = cnt[s] > 0 ? cnt[s] - st[s] : 0;
    cnt[s] = n;
    nch[s] = (n + R - 1) / R;  // tiles, parked in nch for the prefix
  }
  __syncthreads();
  if (tid < 32) {
    const int total = rg_prefix(nch, tb, B);
    if (tid == 31) tb[B] = total;
  }
  __syncthreads();
  int* tiles = a.plan + 4;
  for (int z = tid; z < Z; z += RG_PLAN_THREADS) {
    int* e = tiles + 8 * z;
    if (z >= tb[B]) {
      e[0] = -1;
      nch[z] = 0;
      continue;
    }
    // the last slot whose first tile is <= z (a slot without rows shares
    // its successor's first tile, so the last such slot has tiles)
    int lo = 0, hi = B - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tb[mid] <= z) lo = mid;
      else hi = mid - 1;
    }
    const int r0 = (z - tb[lo]) * R, nr = min(R, cnt[lo] - r0), c_s = a.ctx[lo];
    e[0] = lo;
    e[1] = st[lo];
    e[2] = r0;
    e[3] = nr;
    e[4] = c_s;
    // chunks holding a key the tile's rows need: keys [0, c_s + r0 + nr - 1)
    // (at most nc while ctx <= maxp * page, the row contract)
    nch[z] = min((c_s + r0 + nr - 1 + a.chunk - 1) / a.chunk, a.nc);
  }
  __syncthreads();
  if (tid < 32) {
    const int total = rg_prefix(nch, off, Z);
    if (tid == 31) a.plan[0] = total;
  }
  __syncthreads();
  int* work = tiles + 8 * Z;
  for (int z = tid; z < Z; z += RG_PLAN_THREADS)
    for (int c = 0; c < nch[z]; ++c) work[off[z] + c] = z * a.nc + c;
}

template <int MTW>
__global__ void __launch_bounds__(RG_WARPS * 32) rg_split_kernel(const RgArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, w = blockIdx.y;
  const int* tiles = a.plan + 4;
  const int item = tiles[8 * a.Z + w];  // in bounds for any w < Z * nc
  if (w >= a.plan[0]) return;
  const int z = item / a.nc, c = item - z * a.nc;
  const int4 e = reinterpret_cast<const int4*>(tiles)[2 * z];
  const int s = e.x, start = e.y, r0 = e.z, nr = e.w, ctx = tiles[8 * z + 4];
  const int KV = a.k.KV, g = a.k.g;
  const int p_end = ctx + r0 + nr - 1;  // keys some row of the tile needs: [0, p_end)
  const int c0 = c * a.chunk;
  AttChunk t;
  t.row0 = start + r0;
  t.prow0 = start;
  t.slot = s;
  t.part_base = (((long long)z * KV + kvh) * a.nc + c) * RG_QV;
  t.ctx = ctx;
  t.p_end = p_end;
  t.pos0 = ctx + r0;
  t.c0 = c0;
  t.c_end = min(c0 + a.chunk, p_end);
  t.nqv = nr * g;
  t.kvh = kvh;
  // one body for every tile, the MMAs over ATT_QV_MAX / 8 n8 tiles of
  // query vectors (a vector's bits do not depend on how many tiles they
  // span, nor on how many warps share them); it measured faster than a
  // body per tile height, and eight warps faster than four
  att_split_chunk<MTW, RG_NT, RG_WARPS>(a.k, t, smem);
}

template <int DPL>
__global__ void __launch_bounds__(ATT_THREADS)
rg_combine_kernel(const RgArgs a, bf16* __restrict__ out) {
  const int z = blockIdx.x, kvh = blockIdx.y;
  const int KV = a.k.KV, H = a.k.H, hd = a.k.hd, g = a.k.g, R = a.rows;
  if (blockIdx.z == 0) {  // pad rows among [z R, z R + R): zeros in this KV head's heads
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < R * g * hd; i += ATT_THREADS) {
      const int t = z * R + i / (g * hd);
      if (t >= a.T) break;
      const int sl = a.slot[t];
      if (sl >= 0 && sl < a.B) continue;
      out[(long long)t * H * hd + (long long)kvh * g * hd + i % (g * hd)] = zero;
    }
  }
  const int* e = a.plan + 4 + 8 * z;
  const int s = e[0];
  if (s < 0) return;
  const int v = blockIdx.z * ATT_WARPS + (threadIdx.x >> 5);
  if (v >= e[3] * g) return;
  const int i = v / g, hh = v - i * g, r0 = e[2];
  const long long t = e[1] + r0 + i;
  const int p = e[4] + r0 + i;  // the row's position: its keys are [0, p)
  const long long qo = (t * H + (long long)kvh * g + hh) * hd;
  const long long ko = t * KV * hd + (long long)kvh * hd;
  att_combine_vec<DPL>(a.k.q + qo, a.k.kt + ko, a.k.vt + ko, a.k.part_acc, a.k.part_ml,
                       ((long long)z * KV + kvh) * a.nc * RG_QV + v, RG_QV,
                       (p + a.chunk - 1) / a.chunk, hd, a.k.scale, out + qo);
}

template <int MTW>
static int launch_split(const RgArgs& a, size_t smem, cudaStream_t st) {
  int err = attn_prepare(rg_split_kernel<MTW>, smem);
  if (err) return err;
  // all of the SM's shared memory as such: two blocks an SM where they fit
  err = (int)cudaFuncSetAttribute(rg_split_kernel<MTW>,
                                  cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err) return err;
  rg_split_kernel<MTW><<<dim3(a.k.KV, a.Z * a.nc), RG_WARPS * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int DPL>
static int launch_combine(const RgArgs& a, bf16* out, cudaStream_t st) {
  const int nqv = a.rows * a.k.g;
  rg_combine_kernel<DPL><<<dim3(a.Z, a.k.KV, (nqv + ATT_WARPS - 1) / ATT_WARPS), ATT_THREADS, 0,
                           st>>>(a, out);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the split launch for head dim hd; the launch
// contract mirrors it.
extern "C" int ragged_attention_smem_bytes(int hd) {
  return (int)att_smem_bytes(hd, RG_NT, att_stages(hd, RG_NT));
}

// q (T, H, hd), kt/vt (T, KV, hd), kp/vp (P, page, KV, hd), all bf16
// contiguous; bt (B, maxp), slot (T,), ctx (B,) int32; out (T, H, hd) bf16;
// scratch: the partials, Z * KV * nc * 32 * (hd + 2) f32 rounded up to a
// multiple of 4, Z = B + ceil(T / (32 / g)), nc = ceil((maxp * page + T) /
// chunk), then the plan, 4 + 8 Z + Z nc ints; chunk a multiple of 64.
// Returns the cudaError of the launches (0 on success).
extern "C" int ragged_attention(const void* q, const void* kp, const void* vp, const void* kt,
                                const void* vt, const void* bt, const void* slot,
                                const void* ctx, void* out, void* scratch, int T, int B, int H,
                                int KV, int hd, int maxp, int page, int chunk, float scale,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int g = H / KV, R = ATT_QV_MAX / g, hdp = att_hdp(hd);
  RgArgs a;
  a.k.q = (const bf16*)q;
  a.k.kt = (const bf16*)kt;
  a.k.vt = (const bf16*)vt;
  a.k.bt = (const int*)bt;
  a.k.H = H;
  a.k.g = g;
  a.k.kp = (const bf16*)kp;
  a.k.vp = (const bf16*)vp;
  a.k.KV = KV;
  a.k.hd = hd;
  a.k.maxp = maxp;
  a.k.page = page;
  a.k.pshift = (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1;
  a.k.stages = att_stages(hd, RG_NT);
  a.k.scale = scale;
  a.slot = (const int*)slot;
  a.ctx = (const int*)ctx;
  a.T = T;
  a.B = B;
  a.chunk = chunk;
  a.nc = (maxp * page + T + chunk - 1) / chunk;
  a.rows = R;
  a.Z = B + (T + R - 1) / R;
  const size_t n_part = (size_t)a.Z * KV * a.nc * RG_QV;
  a.k.part_acc = (float*)scratch;
  a.k.part_ml = a.k.part_acc + n_part * hd;
  a.plan = (int*)(a.k.part_acc + ((n_part * (hd + 2) + 3) & ~(size_t)3));
  const size_t plan_smem = rg_plan_smem(B, a.Z);
  int err = attn_prepare(rg_plan_kernel, plan_smem);
  if (err) return err;
  rg_plan_kernel<<<1, RG_PLAN_THREADS, plan_smem, st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = att_smem_bytes(hd, RG_NT, a.k.stages);
  err = hdp <= 64    ? launch_split<1>(a, smem, st)
        : hdp <= 128 ? launch_split<2>(a, smem, st)
                     : launch_split<4>(a, smem, st);
  if (err) return err;
  bf16* o = (bf16*)out;
  switch (attn_dpl(hd)) {
    case 1: return launch_combine<1>(a, o, st);
    case 2: return launch_combine<2>(a, o, st);
    case 4: return launch_combine<4>(a, o, st);
    default: return launch_combine<8>(a, o, st);
  }
}
