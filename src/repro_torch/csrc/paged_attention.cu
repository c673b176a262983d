// Block-table paged decode attention for Hopper, sm_90a.
//
// Replaces: repro/kernels/paged_attention.py : paged_decode_kernel (body
// _paged_decode_fwd, _fold).
//
// Each slot b has sq <= 8 post-RoPE query rows (a decode token, or a
// speculative draft stack); row i sits at position pos[b] + i and attends
// the committed prefix [0, pos[b]) through the slot's block table, the
// earlier draft rows of the slot, and itself. Keys at positions past the
// table (maxp * page) do not exist, as in the plain version's dense view.
//
// What bounds it: bytes. Each key and value of the pages in use is read
// once per KV head and used by all g = H/KV query heads and all sq rows, a
// few flops per byte, so the least time is the pages actually read,
// about 2 * sum_b pos_b * KV * hd * 2 bytes, over the memory rate.
//
// Design: the split-KV schedule of attention_common.cuh. The wrapper passes
// chunk = autotune.PAGED_CHUNK, the same for every launch. Launch 1
// (pd_split_kernel) runs one block per (chunk, KV head, slot) over the
// slot's sq rows (the draft panel: row i at position pos[b] + i); launch 2
// (pd_combine_kernel, one warp per query vector) folds the chunks'
// partials, the self term last, and runs the commit.
//
// Commit (commit != 0): launch 2 writes its KV head's columns of the draft
// rows into their tail pages, skipping rows whose page is unmapped or lies
// past the table. It runs after every read of launch 1 (stream order) and
// only positions >= pos[b] of the slot's own pages are written, which no
// block reads from a page.
#include "attention_common.cuh"

struct PdArgs {
  AttConst k;  // q (B, sq, H, hd), pools, draft rows kt/vt (B, sq, KV, hd), bt (B,
               // maxp), scratch (B, KV, nc, nqv, hd) and (..., 2): m, l; shapes
  const int* pos;
  int sq, chunk, nc;
};

template <int MTW, int NT>
__global__ void __launch_bounds__(ATT_THREADS) pd_split_kernel(const PdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nqv = a.sq * a.k.g;
  const int ctx = a.pos[b];
  // keys some row needs: [0, min(position of the last row, maxp * page))
  const int p_end = min(ctx + a.sq - 1, a.k.maxp * a.k.page);
  const int c0 = c * a.chunk;
  if (c0 >= p_end) return;
  AttChunk t;
  t.row0 = b * a.sq;
  t.prow0 = b * a.sq;
  t.slot = b;
  t.part_base = (((long long)b * a.k.KV + kvh) * a.nc + c) * nqv;
  t.ctx = ctx;
  t.p_end = p_end;
  t.pos0 = ctx;
  t.c0 = c0;
  t.c_end = min(c0 + a.chunk, p_end);
  t.nqv = nqv;
  t.kvh = kvh;
  att_split_chunk<MTW, NT>(a.k, t, smem);
}

// Launch 2: per (slot, KV head, 4 query vectors), one warp per vector folds
// its chunks' partials (att_combine_vec); blocks of the first vector tile
// then run the commit.
template <int DPL>
__global__ void __launch_bounds__(ATT_THREADS)
pd_combine_kernel(const PdArgs a, bf16* __restrict__ out, bf16* kp_w, bf16* vp_w, int commit) {
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int KV = a.k.KV, H = a.k.H, g = a.k.g, nqv = a.sq * g, hd = a.k.hd;
  const int warp = threadIdx.x >> 5;
  const int ctx = a.pos[b], maxp = a.k.maxp, page = a.k.page, s_max = maxp * page;
  const long long krow = (long long)KV * hd;
  const int v = blockIdx.z * ATT_WARPS + warp;
  if (v < nqv) {
    const int r = v / g, hh = v - r * g;
    const long long qo = (((long long)b * a.sq + r) * H + (long long)kvh * g + hh) * hd;
    const long long ko = ((long long)b * a.sq + r) * krow + (long long)kvh * hd;
    const int n_c = (min(ctx + r, s_max) + a.chunk - 1) / a.chunk;  // chunks with its keys
    att_combine_vec<DPL>(a.k.q + qo, a.k.kt + ko, a.k.vt + ko, a.k.part_acc, a.k.part_ml,
                         ((long long)b * KV + kvh) * a.nc * nqv + v, nqv, n_c, hd, a.k.scale,
                         out + qo);
  }
  if (!commit || blockIdx.z != 0) return;
  const bf16* kpanel = a.k.kt + (long long)b * a.sq * krow;
  const bf16* vpanel = a.k.vt + (long long)b * a.sq * krow;
  const int* bt_row = a.k.bt + (long long)b * maxp;
  for (int i = threadIdx.x; i < a.sq * hd; i += ATT_THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int p = ctx + r, pi = p / page;
    if (pi >= maxp) continue;
    const int pg = bt_row[pi];
    if (pg < 0) continue;
    const long long dst = ((long long)pg * page + (p - pi * page)) * krow + (long long)kvh * hd + d;
    const long long src = (long long)r * krow + (long long)kvh * hd + d;
    kp_w[dst] = kpanel[src];
    vp_w[dst] = vpanel[src];
  }
}

template <int MTW, int NT>
static int launch_split(const PdArgs& a, int B, size_t smem, cudaStream_t st) {
  int err = attn_prepare(pd_split_kernel<MTW, NT>, smem);
  if (err) return err;
  // all of the SM's shared memory as such: two blocks an SM where they fit
  err = (int)cudaFuncSetAttribute(pd_split_kernel<MTW, NT>,
                                  cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err) return err;
  pd_split_kernel<MTW, NT><<<dim3(a.nc, a.k.KV, B), ATT_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int MTW>
static int launch_split_nt(const PdArgs& a, int B, int nt, size_t smem, cudaStream_t st) {
  switch (nt) {
    case 1: return launch_split<MTW, 1>(a, B, smem, st);
    case 2: return launch_split<MTW, 2>(a, B, smem, st);
    case 3: return launch_split<MTW, 3>(a, B, smem, st);
    default: return launch_split<MTW, 4>(a, B, smem, st);
  }
}

template <int DPL>
static int launch_combine(const PdArgs& a, int B, bf16* out, bf16* kp, bf16* vp, int commit,
                          cudaStream_t st) {
  const int nqv = a.sq * a.k.g;
  pd_combine_kernel<DPL><<<dim3(B, a.k.KV, (nqv + ATT_WARPS - 1) / ATT_WARPS), ATT_THREADS, 0, st>>>(
      a, out, kp, vp, commit);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the split launch for (hd, query vectors a
// block); the launch contract mirrors it.
extern "C" int paged_decode_smem_bytes(int hd, int nqv) {
  const int nt = (nqv + 7) / 8;
  return (int)att_smem_bytes(hd, nt, att_stages(hd, nt));
}

// q (B, sq, H, hd), kp/vp (P, page, KV, hd), kt/vt (B, sq, KV, hd), all bf16
// contiguous; bt (B, maxp) and pos (B,) int32; out (B, sq, H, hd) bf16;
// scratch: B * KV * nc * sq * H/KV * (hd + 2) f32, nc = ceil(maxp * page /
// chunk), chunk a multiple of 64. Returns the cudaError of the launches (0
// on success).
extern "C" int paged_decode(const void* q, void* kp, void* vp, const void* kt, const void* vt,
                            const void* bt, const void* pos, void* out, void* scratch, int B,
                            int sq, int H, int KV, int hd, int maxp, int page, int chunk,
                            float scale, int commit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nqv = sq * (H / KV), nt = (nqv + 7) / 8, hdp = att_hdp(hd);
  PdArgs a;
  a.k.q = (const bf16*)q;
  a.k.kt = (const bf16*)kt;
  a.k.vt = (const bf16*)vt;
  a.k.bt = (const int*)bt;
  a.k.H = H;
  a.k.g = H / KV;
  a.k.kp = (const bf16*)kp;
  a.k.vp = (const bf16*)vp;
  a.k.KV = KV;
  a.k.hd = hd;
  a.k.maxp = maxp;
  a.k.page = page;
  a.k.pshift = (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1;
  a.k.stages = att_stages(hd, nt);
  a.k.scale = scale;
  a.pos = (const int*)pos;
  a.sq = sq;
  a.chunk = chunk;
  a.nc = (maxp * page + chunk - 1) / chunk;
  a.k.part_acc = (float*)scratch;
  a.k.part_ml = a.k.part_acc + (size_t)B * KV * a.nc * nqv * hd;
  const size_t smem = att_smem_bytes(hd, nt, a.k.stages);
  int err = hdp <= 64    ? launch_split_nt<1>(a, B, nt, smem, st)
            : hdp <= 128 ? launch_split_nt<2>(a, B, nt, smem, st)
                         : launch_split_nt<4>(a, B, nt, smem, st);
  if (err) return err;
  bf16 *o = (bf16*)out, *kw = (bf16*)kp, *vw = (bf16*)vp;
  switch (attn_dpl(hd)) {
    case 1: return launch_combine<1>(a, B, o, kw, vw, commit, st);
    case 2: return launch_combine<2>(a, B, o, kw, vw, commit, st);
    case 4: return launch_combine<4>(a, B, o, kw, vw, commit, st);
    default: return launch_combine<8>(a, B, o, kw, vw, commit, st);
  }
}
