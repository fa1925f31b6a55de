// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_kernel`
// (src/repro/kernels/paged_attention.py): one query token per lane
// attends over the lane's page-table slice of the global bf16 KV pool,
// with an f32 online softmax over the visited pages.
//
// Contract (the plain PyTorch version in
// repro_torch/kernels/paged_attention.py computes the same):
//   q (B, H, hd) f32 contiguous, H = G * Hkv;
//   k/v pool (P, ps, Hkv, hd) bf16 in the model's layout, read through
//     its strides (page, slot, head; hd contiguous) — never transposed
//     or padded;
//   pos (P, ps) i32, -1 = empty slot; table (B, maxp) i32; q_pos (B,) i32;
//   out (B, H, hd) f32.  A lane visits pages j < min(q_pos // ps + 1,
//   maxp); a key is visible when its stored position is >= 0, <= q_pos
//   and inside the sliding window (window <= 0: none).  A lane that sees
//   no visible key writes zeros.
//
// Bound on the H100: bytes.  Per lane and kv head the kernel reads each
// visible K and V row once (2 * hd bf16 values a slot) and does 4 * hd
// flops a visible slot and query head: about one flop per byte, two
// orders of magnitude under the ridge of the tensor cores, so the least
// time is the visible K/V bytes over 3.35 TB/s.  At the serve path's
// shapes (8 lanes x 12 heads x hd 64, at most 48 positions = 3 pages of
// 16 a lane) one layer reads at most 8 * 48 * 12 * 64 * 2 B * 2 (K, V)
// = 1,179,648 B of K/V, 0.35 us at 3.35 TB/s, against 1.2 MFLOP, 0.02
// us at 67 TFLOP/s in f32: far below the cost of a launch.
//
// Design for that bound: grid (B, Hkv), one warp per query head of the
// group, each thread holding hd / 32 elements of q and of the
// accumulator.  A key row is read by a whole warp in one coalesced
// sweep (hd * 2 bytes), its dot product reduced with warp shuffles, and
// masked slots are skipped before any K/V byte is read.  No shared
// memory and no second pass: flash-decoding splits, cp.async/TMA and
// tensor cores are left for a later change.

#include "common.cuh"

namespace {

template <int HD>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ pos_pages, const int* __restrict__ page_table,
    const int* __restrict__ q_pos, float* __restrict__ out, int H, int Hkv,
    int ps, int maxp, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long pos_sp,
    long long pos_ss, float scale, int window) {
  constexpr int EPT = HD / 32;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int G = H / Hkv;
  const int h = kvh * G + g;

  repro::OnlineRow<EPT> row;
  row.load_q(q + ((long long)b * H + h) * HD, lane);

  const int qp = q_pos[b];
  // floor division: a lane at position -1 visits no page
  const int n_used = qp < 0 ? 0 : min(qp / ps + 1, maxp);
  const int* table = page_table + (long long)b * maxp;
  for (int j = 0; j < n_used; ++j) {
    const long long page = table[j];
    const int* prow = pos_pages + page * pos_sp;
    const __nv_bfloat16* kp = k_pages + page * k_sp + kvh * k_sh;
    const __nv_bfloat16* vp = v_pages + page * v_sp + kvh * v_sh;
    for (int s = 0; s < ps; ++s) {
      if (!repro::key_visible(prow[s * pos_ss], qp, window)) continue;
      row.add(kp + s * k_ss, vp + s * v_ss, lane, scale);
    }
  }
  row.store(out + ((long long)b * H + h) * HD, lane);
}

template <int HD>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const float* q,
            const __nv_bfloat16* k, const __nv_bfloat16* v, const int* pos,
            const int* table, const int* q_pos, float* out, int H, int Hkv,
            int ps, int maxp, long long k_sp, long long k_ss, long long k_sh,
            long long v_sp, long long v_ss, long long v_sh, long long pos_sp,
            long long pos_ss, float scale, int window) {
  paged_attention_kernel<HD><<<grid, block, 0, stream>>>(
      q, k, v, pos, table, q_pos, out, H, Hkv, ps, maxp, k_sp, k_ss, k_sh,
      v_sp, v_ss, v_sh, pos_sp, pos_ss, scale, window);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  hd must be 32,
// 64 or 128 and H a multiple of Hkv with H / Hkv <= 32.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* pos_pages, const void* page_table, const void* q_pos,
    void* out, int B, int H, int Hkv, int hd, int ps, int maxp,
    long long k_sp, long long k_ss, long long k_sh, long long v_sp,
    long long v_ss, long long v_sh, long long pos_sp, long long pos_ss,
    float scale, int window, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > 32 || B <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, Hkv);
  const dim3 block(32 * (H / Hkv));
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto kb = static_cast<const __nv_bfloat16*>(k_pages);
  auto vb = static_cast<const __nv_bfloat16*>(v_pages);
  auto pi = static_cast<const int*>(pos_pages);
  auto ti = static_cast<const int*>(page_table);
  auto qpi = static_cast<const int*>(q_pos);
  auto of = static_cast<float*>(out);
  switch (hd) {
    case 32:
      launch<32>(grid, block, st, qf, kb, vb, pi, ti, qpi, of, H, Hkv, ps,
                 maxp, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, pos_sp, pos_ss,
                 scale, window);
      break;
    case 64:
      launch<64>(grid, block, st, qf, kb, vb, pi, ti, qpi, of, H, Hkv, ps,
                 maxp, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, pos_sp, pos_ss,
                 scale, window);
      break;
    case 128:
      launch<128>(grid, block, st, qf, kb, vb, pi, ti, qpi, of, H, Hkv, ps,
                  maxp, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, pos_sp, pos_ss,
                  scale, window);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
