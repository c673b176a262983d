// Block-table paged decode attention for Hopper, sm_90a.
//
// Replaces: repro/kernels/paged_attention.py : paged_decode_kernel (body
// _paged_decode_fwd, _fold).
//
// Each slot b has sq <= 8 post-RoPE query rows (a decode token, or a
// speculative draft stack); row i sits at position pos[b] + i and attends
// the committed prefix [0, pos[b)) through the slot's block table, the
// earlier draft rows of the slot, and itself (attention_common.cuh).
//
// What bounds it: bytes. Each key and value of the pages in use is read
// once per KV head and used by all g = H/KV query heads and all sq rows, a
// few flops per byte, so the least time is the pages actually read,
// about 2 * sum_b pos_b * KV * hd * 2 bytes, over the memory rate.
//
// Design. The TPU kernel sweeps a sequential (B, max_pages + 2) grid with
// the softmax state in VMEM scratch. Here one block takes one (slot, KV
// head) pair with all of its query heads and rows, and walks the slot's
// pages itself, reading the block table and pos in the kernel: each key and
// value is fetched once per block, the state stays in registers, and no
// block depends on another. Idle slots (bt all -1, pos 0) read no page.
//
// Commit (commit != 0): after its reads, each block writes its own KV
// head's columns of the draft rows into their tail pages, skipping rows
// whose page is unmapped or lies past the table. Only positions >= pos[b]
// of the slot's own pages are written, which no block of the launch reads
// from a page, so the epilogue needs no ordering between blocks and never
// rewrites whole pages.
#include "attention_common.cuh"

template <int DPL>
__global__ void __launch_bounds__(ATT_THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* kp,
                    const __nv_bfloat16* vp, __nv_bfloat16* kp_w, __nv_bfloat16* vp_w,
                    const __nv_bfloat16* __restrict__ kt, const __nv_bfloat16* __restrict__ vt,
                    const int* __restrict__ bt, const int* __restrict__ pos,
                    __nv_bfloat16* __restrict__ out, int sq, int H, int KV, int hd, int maxp,
                    int page, float scale, int commit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = H / KV;
  AttnRun a;
  a.bt_row = bt + (long long)b * maxp;
  a.maxp = maxp;
  a.page = page;
  a.ctx = pos[b];
  a.kp = kp;
  a.vp = vp;
  a.kpanel = kt + (long long)b * sq * KV * hd;
  a.vpanel = vt + (long long)b * sq * KV * hd;
  a.n_panel = sq;
  a.r0 = 0;
  a.nr = sq;
  a.q = q + (long long)b * sq * H * hd;
  a.out = out + (long long)b * sq * H * hd;
  a.kvh = kvh;
  a.KV = KV;
  a.g = g;
  a.hd = hd;
  a.scale = scale;
  attend_run<DPL>(a, smem);
  if (!commit) return;
  __syncthreads();  // every read of this block is done
  const long long row = (long long)KV * hd;
  for (int i = threadIdx.x; i < sq * hd; i += ATT_THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int p = a.ctx + r, pi = p / page;
    if (pi >= maxp) continue;
    const int pg = a.bt_row[pi];
    if (pg < 0) continue;
    const long long dst = ((long long)pg * page + (p - pi * page)) * row + (long long)kvh * hd + d;
    const long long src = (long long)r * row + (long long)kvh * hd + d;
    kp_w[dst] = a.kpanel[src];
    vp_w[dst] = a.vpanel[src];
  }
}

template <int DPL>
static int launch(const void* q, void* kp, void* vp, const void* kt, const void* vt,
                  const void* bt, const void* pos, void* out, int B, int sq, int H, int KV,
                  int hd, int maxp, int page, float scale, int commit, cudaStream_t st) {
  const size_t smem = attn_smem_bytes(page, hd);
  int err = attn_prepare(paged_decode_kernel<DPL>, smem);
  if (err) return err;
  dim3 grid(B, KV);
  paged_decode_kernel<DPL><<<grid, ATT_THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp, (const __nv_bfloat16*)vp,
      (__nv_bfloat16*)kp, (__nv_bfloat16*)vp, (const __nv_bfloat16*)kt,
      (const __nv_bfloat16*)vt, (const int*)bt, (const int*)pos, (__nv_bfloat16*)out, sq, H,
      KV, hd, maxp, page, scale, commit);
  return (int)cudaGetLastError();
}

// q (B, sq, H, hd), kp/vp (P, page, KV, hd), kt/vt (B, sq, KV, hd), all bf16
// contiguous; bt (B, maxp) and pos (B,) int32; out (B, sq, H, hd) bf16.
// Returns the cudaError of the launch (0 on success).
extern "C" int paged_decode(const void* q, void* kp, void* vp, const void* kt, const void* vt,
                            const void* bt, const void* pos, void* out, int B, int sq, int H,
                            int KV, int hd, int maxp, int page, float scale, int commit,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (attn_dpl(hd)) {
    case 1: return launch<1>(q, kp, vp, kt, vt, bt, pos, out, B, sq, H, KV, hd, maxp, page, scale, commit, st);
    case 2: return launch<2>(q, kp, vp, kt, vt, bt, pos, out, B, sq, H, KV, hd, maxp, page, scale, commit, st);
    case 4: return launch<4>(q, kp, vp, kt, vt, bt, pos, out, B, sq, H, KV, hd, maxp, page, scale, commit, st);
    default: return launch<8>(q, kp, vp, kt, vt, bt, pos, out, B, sq, H, KV, hd, maxp, page, scale, commit, st);
  }
}
