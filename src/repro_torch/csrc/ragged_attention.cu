// Ragged paged attention for Hopper, sm_90a: one launch for a flat batch of
// T rows that mixes decode rows and prompt chunks of many slots.
//
// Replaces: repro/kernels/ragged_attention.py : ragged_attention_kernel
// (body _ragged_attention_fwd).
//
// Row t belongs to slot slot[t] (slot == B marks a pad row) at position
// pos[t]; it attends the slot's committed pages [0, ctx[slot]) and the rows
// of the same slot with pos <= its own. The engine gives each slot one
// contiguous run of rows with consecutive positions from ctx[slot] (one
// decode row, or one chunk); the kernel relies on that contract, which the
// host checks while the metadata is still numpy (contracts.check_ragged_rows).
// Pad rows are written as zeros.
//
// What bounds it: bytes, as for paged decode: each page in use is read once
// per (KV head, row tile) and used by all query heads of the KV head, so
// the least time is about 2 * sum over slots with rows of ctx * KV * hd * 2
// bytes (plus the T rows of q, k, v and the output) over the memory rate.
//
// Design. The TPU kernel sweeps a sequential (B, max_pages) grid with the
// whole T-row panel resident and masks the rows of other slots. Here a
// block takes (slot, KV head, tile of R = 32 / g of the slot's rows): it
// finds its slot's run in slot[] itself, reads bt and ctx in the kernel,
// and walks only the pages its rows need, with the fold order of
// attention_common.cuh, so a row's output does not depend on the chunking.
// Blocks of slot index B zero the pad rows; blocks whose tile lies past
// their slot's run exit at once.
#include "attention_common.cuh"

template <int DPL>
__global__ void __launch_bounds__(ATT_THREADS)
ragged_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* kp,
                        const __nv_bfloat16* vp, const __nv_bfloat16* __restrict__ kt,
                        const __nv_bfloat16* __restrict__ vt, const int* __restrict__ bt,
                        const int* __restrict__ slot, const int* __restrict__ ctx,
                        __nv_bfloat16* __restrict__ out, int T, int B, int H, int KV, int hd,
                        int maxp, int page, int rows_per_block, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int run_start, run_count;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = H / KV;
  const int r0 = blockIdx.z * rows_per_block;
  if (b == B) {  // pad rows of this tile: zeros in this KV head's query heads
    for (int i = threadIdx.x; i < rows_per_block * g * hd; i += ATT_THREADS) {
      const int t = r0 + i / (g * hd);
      if (t >= T || slot[t] < B) continue;
      const int rem = i % (g * hd);
      out[(long long)t * H * hd + (long long)kvh * g * hd + rem] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  if (threadIdx.x == 0) {
    run_start = T;
    run_count = 0;
  }
  __syncthreads();
  int first = T, count = 0;
  for (int t = threadIdx.x; t < T; t += ATT_THREADS) {
    if (slot[t] == b) {
      first = min(first, t);
      ++count;
    }
  }
  if (count) {
    atomicMin(&run_start, first);
    atomicAdd(&run_count, count);
  }
  __syncthreads();
  const int start = run_start, n = run_count;
  if (r0 >= n) return;
  AttnRun a;
  a.bt_row = bt + (long long)b * maxp;
  a.maxp = maxp;
  a.page = page;
  a.ctx = ctx[b];
  a.kp = kp;
  a.vp = vp;
  a.kpanel = kt + (long long)start * KV * hd;
  a.vpanel = vt + (long long)start * KV * hd;
  a.n_panel = n;
  a.r0 = r0;
  a.nr = min(rows_per_block, n - r0);
  a.q = q + (long long)start * H * hd;
  a.out = out + (long long)start * H * hd;
  a.kvh = kvh;
  a.KV = KV;
  a.g = g;
  a.hd = hd;
  a.scale = scale;
  attend_run<DPL>(a, smem);
}

template <int DPL>
static int launch(const void* q, const void* kp, const void* vp, const void* kt, const void* vt,
                  const void* bt, const void* slot, const void* ctx, void* out, int T, int B,
                  int H, int KV, int hd, int maxp, int page, float scale, cudaStream_t st) {
  const size_t smem = attn_smem_bytes(page, hd);
  int err = attn_prepare(ragged_attention_kernel<DPL>, smem);
  if (err) return err;
  const int rows = ATT_QV_MAX / (H / KV);
  dim3 grid(B + 1, KV, (T + rows - 1) / rows);
  ragged_attention_kernel<DPL><<<grid, ATT_THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp, (const __nv_bfloat16*)vp,
      (const __nv_bfloat16*)kt, (const __nv_bfloat16*)vt, (const int*)bt, (const int*)slot,
      (const int*)ctx, (__nv_bfloat16*)out, T, B, H, KV, hd, maxp, page, rows, scale);
  return (int)cudaGetLastError();
}

// q (T, H, hd), kt/vt (T, KV, hd), kp/vp (P, page, KV, hd), all bf16
// contiguous; bt (B, maxp), slot (T,), ctx (B,) int32; out (T, H, hd) bf16.
// Returns the cudaError of the launch (0 on success).
extern "C" int ragged_attention(const void* q, const void* kp, const void* vp, const void* kt,
                                const void* vt, const void* bt, const void* slot,
                                const void* ctx, void* out, int T, int B, int H, int KV, int hd,
                                int maxp, int page, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (attn_dpl(hd)) {
    case 1: return launch<1>(q, kp, vp, kt, vt, bt, slot, ctx, out, T, B, H, KV, hd, maxp, page, scale, st);
    case 2: return launch<2>(q, kp, vp, kt, vt, bt, slot, ctx, out, T, B, H, KV, hd, maxp, page, scale, st);
    case 4: return launch<4>(q, kp, vp, kt, vt, bt, slot, ctx, out, T, B, H, KV, hd, maxp, page, scale, st);
    default: return launch<8>(q, kp, vp, kt, vt, bt, slot, ctx, out, T, B, H, KV, hd, maxp, page, scale, st);
  }
}
