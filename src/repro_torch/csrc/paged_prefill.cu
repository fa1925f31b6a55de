// Chunked-prefill attention over the paged KV pool for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_prefill_kernel`
// (src/repro/kernels/paged_prefill.py): the C query rows of a lane's
// prefill chunk attend to two sources with one f32 online softmax —
//   1. the lane's page history, clipped to 0 <= kpos < chunk_start
//      (the chunk's own positions may already sit in the pool: they
//      come from source 2, exactly once);
//   2. the chunk's own in-flight keys/values (f32, not the bf16 pool),
//      causally (ckpos <= qpos).
// A sliding window (window > 0) applies to both; rows at position -1
// (ragged tails, idle prefill slots) write zeros.
//
// Contract (the plain PyTorch version in
// repro_torch/kernels/paged_prefill.py computes the same):
//   q (B, C, H, hd) f32 contiguous, H = G * Hkv; q_pos (B, C) i32;
//   k/v pool (P, ps, Hkv, hd) bf16 in the model's layout, read through
//     its strides (never transposed or padded); pos (P, ps) i32;
//   table (B, maxp) i32; chunk_start (B,) i32; ck/cv (B, C, Hkv, hd) f32
//   contiguous with positions c_pos (B, C) i32 (-1 = padding);
//   out (B, C, H, hd) f32.  History pages visited: j < clip(ceil(start /
//   ps), 0, maxp).
//
// Bound on the H100: bytes.  Each (lane, kv head) needs its history K/V
// rows (bf16) and the chunk's in-flight K/V rows (f32) once, plus q in
// and out once; the flops are 4 * hd per (query row, key) — at C = 16
// rows about 16 flops a byte of history, still far under the tensor
// cores' ridge, and the least time is those bytes over 3.35 TB/s.  At
// the serve path's shapes (8 lanes x 12 heads x hd 64, 16-row chunks of
// 32-token prompts, so at most one 16-slot history page a lane) one
// layer moves 393,216 B of bf16 history, 786,432 B of f32 ck/cv and
// 786,432 B of q in and out: 1.97 MB, 0.59 us at 3.35 TB/s, against at
// most 128 rows x 32 keys x 12 heads x 256 = 12.6 MFLOP, 0.19 us at 67
// TFLOP/s in f32: below the cost of a launch.
//
// Design for that bound: grid (B * Hkv, C), one warp per (row c, group
// head g), each thread holding hd / 32 elements of q and of the
// accumulator; a key row is read in one coalesced warp sweep and masked
// slots are skipped before any byte is read.  The C blocks of one lane
// re-read the same history rows, which L2 (50 MB) serves; staging them
// in shared memory, cp.async/TMA and tensor cores are left for a later
// change.

#include "common.cuh"

namespace {

template <int HD>
__global__ void paged_prefill_kernel(
    const float* __restrict__ q, const int* __restrict__ q_pos,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ pos_pages, const int* __restrict__ page_table,
    const int* __restrict__ chunk_start, const float* __restrict__ ck,
    const float* __restrict__ cv, const int* __restrict__ c_pos,
    float* __restrict__ out, int C, int H, int Hkv, int ps, int maxp,
    long long k_sp, long long k_ss, long long k_sh, long long v_sp,
    long long v_ss, long long v_sh, long long pos_sp, long long pos_ss,
    float scale, int window) {
  constexpr int EPT = HD / 32;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int G = H / Hkv;
  const int h = kvh * G + g;
  const long long row_off = (((long long)b * C + c) * H + h) * HD;

  repro::OnlineRow<EPT> row;
  row.load_q(q + row_off, lane);
  const int qp = q_pos[(long long)b * C + c];
  if (qp >= 0) {
    // 1. page history below the chunk start
    const int start = chunk_start[b];
    const int n_hist = start <= 0 ? 0 : min((start + ps - 1) / ps, maxp);
    const int* table = page_table + (long long)b * maxp;
    for (int j = 0; j < n_hist; ++j) {
      const long long page = table[j];
      const int* prow = pos_pages + page * pos_sp;
      const __nv_bfloat16* kp = k_pages + page * k_sp + kvh * k_sh;
      const __nv_bfloat16* vp = v_pages + page * v_sp + kvh * v_sh;
      for (int s = 0; s < ps; ++s) {
        const int kpos = prow[s * pos_ss];
        if (kpos >= start || !repro::key_visible(kpos, qp, window)) continue;
        row.add(kp + s * k_ss, vp + s * v_ss, lane, scale);
      }
    }
    // 2. the chunk's own in-flight keys, causally
    const int* cp = c_pos + (long long)b * C;
    for (int t = 0; t < C; ++t) {
      if (!repro::key_visible(cp[t], qp, window)) continue;
      const long long kv_off = (((long long)b * C + t) * Hkv + kvh) * HD;
      row.add(ck + kv_off, cv + kv_off, lane, scale);
    }
  }
  row.store(out + row_off, lane);
}

template <int HD>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const float* q,
            const int* q_pos, const __nv_bfloat16* k,
            const __nv_bfloat16* v, const int* pos, const int* table,
            const int* start, const float* ck, const float* cv,
            const int* c_pos, float* out, int C, int H, int Hkv, int ps,
            int maxp, long long k_sp, long long k_ss, long long k_sh,
            long long v_sp, long long v_ss, long long v_sh, long long pos_sp,
            long long pos_ss, float scale, int window) {
  paged_prefill_kernel<HD><<<grid, block, 0, stream>>>(
      q, q_pos, k, v, pos, table, start, ck, cv, c_pos, out, C, H, Hkv, ps,
      maxp, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, pos_sp, pos_ss, scale,
      window);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  hd must be 32,
// 64 or 128 and H a multiple of Hkv with H / Hkv <= 32.
extern "C" int repro_paged_prefill(
    const void* q, const void* q_pos, const void* k_pages,
    const void* v_pages, const void* pos_pages, const void* page_table,
    const void* chunk_start, const void* ck, const void* cv,
    const void* c_pos, void* out, int B, int C, int H, int Hkv, int hd,
    int ps, int maxp, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long pos_sp,
    long long pos_ss, float scale, int window, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > 32 || B <= 0 || C <= 0 ||
      C > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * Hkv, C);
  const dim3 block(32 * (H / Hkv));
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto qpi = static_cast<const int*>(q_pos);
  auto kb = static_cast<const __nv_bfloat16*>(k_pages);
  auto vb = static_cast<const __nv_bfloat16*>(v_pages);
  auto pi = static_cast<const int*>(pos_pages);
  auto ti = static_cast<const int*>(page_table);
  auto si = static_cast<const int*>(chunk_start);
  auto ckf = static_cast<const float*>(ck);
  auto cvf = static_cast<const float*>(cv);
  auto cpi = static_cast<const int*>(c_pos);
  auto of = static_cast<float*>(out);
  switch (hd) {
    case 32:
      launch<32>(grid, block, st, qf, qpi, kb, vb, pi, ti, si, ckf, cvf, cpi,
                 of, C, H, Hkv, ps, maxp, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh,
                 pos_sp, pos_ss, scale, window);
      break;
    case 64:
      launch<64>(grid, block, st, qf, qpi, kb, vb, pi, ti, si, ckf, cvf, cpi,
                 of, C, H, Hkv, ps, maxp, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh,
                 pos_sp, pos_ss, scale, window);
      break;
    case 128:
      launch<128>(grid, block, st, qf, qpi, kb, vb, pi, ti, si, ckf, cvf,
                  cpi, of, C, H, Hkv, ps, maxp, k_sp, k_ss, k_sh, v_sp, v_ss,
                  v_sh, pos_sp, pos_ss, scale, window);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
