// Shared device helpers: the position mask of the paged KV pool,
// cp.async copies, the visible-key list and the split merge of the two
// paged kernels, and the f32 view of a stored element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;

// A stored key at position kpos is visible to a query at position qp
// when the slot is filled (kpos >= 0), causal (kpos <= qp) and, with a
// sliding window (window > 0), inside it (kpos > qp - window).
__device__ __forceinline__ bool key_visible(int kpos, int qp, int window) {
  return kpos >= 0 && kpos <= qp && (window <= 0 || kpos > qp - window);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes from device to shared memory (both 16-byte aligned); with
// in == false the destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in = true) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes from device to shared memory (both 4-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Slots first .. n_keys - 1 of a lane's pages (slot i is slot i % ps of
// page tab[i / ps]; page ids in shared memory) that pass `kpos < lt &&
// key_visible(kpos, qp, window)`, in slot order: list[i] = the slot and,
// when kpos_out is given, kpos_out[i] = its stored position.  The
// positions of up to kPer * NT slots are loaded at once before any is
// used, so up to that many cost one round trip.  cnt holds 4 * (NT /
// 32) + 1 ints of shared memory.  Every thread of the block calls it;
// it returns the count to all, the list written.
template <int NT>
__device__ __forceinline__ int gather_visible(
    const int* tab, int first, int n_keys, int ps,
    const int* __restrict__ pos_pages, long long pos_sp, long long pos_ss,
    int qp, int window, int lt, int* list, int* kpos_out, int* cnt) {
  constexpr int kPer = 4, kWarps = NT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int total = 0;
  for (int base = first; base < n_keys; base += kPer * NT) {
    int kp[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = base + i * NT + tid;
      kp[i] = -1;
      if (idx < n_keys) {
        const int j = idx / ps, s = idx - j * ps;
        kp[i] = pos_pages[(long long)tab[j] * pos_sp + s * pos_ss];
      }
    }
    unsigned bits[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = base + i * NT + tid;
      bits[i] = __ballot_sync(0xffffffffu, idx < n_keys && kp[i] < lt &&
                                               key_visible(kp[i], qp, window));
      if (lane == 0) cnt[i * kWarps + warp] = __popc(bits[i]);
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    int off = total;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      int pre = off;
      for (int w = 0; w < warp; ++w) pre += cnt[i * kWarps + w];
      if ((bits[i] >> lane) & 1u) {
        const int at = pre + __popc(bits[i] & below);
        list[at] = base + i * NT + tid;
        if (kpos_out) kpos_out[at] = kp[i];
      }
      for (int w = 0; w < kWarps; ++w) off += cnt[i * kWarps + w];
    }
    total = off;
    __syncthreads();                    // cnt reused by the next round
  }
  return total;
}

// The split merge of the paged kernels.  The S blocks of one unit (a
// lane and kv head, and a row tile for prefill) each leave, for their
// share of the keys, rows x hd sums unnormalised (relative to their own
// running max) and rows x (m, l); the last block to finish (an integer
// ticket per unit, which it puts back to zero) merges them.
// `last_of_splits` returns true in that block, after the other blocks'
// parts are visible.
__device__ __forceinline__ bool last_of_splits(int* ticket, int S,
                                               int* flag) {
  __threadfence();                      // this block's part, device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    *flag = t == S - 1;
    if (t == S - 1) atomicExch(ticket, 0);
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// Merge S parts of `rows` rows (sums in `acc` [S][rows][HD], (m, l) in
// `ml` [S][rows][2], both written by other blocks, so read through L2)
// into the rows of out: dst(r) is row r's output pointer, 16-byte
// aligned, or nullptr for a row that is not written.  Each thread takes
// 4 columns of a row and folds the parts in split order, so the result
// does not depend on which block finished last; the parts' loads do
// not wait on each other.  A part that saw no visible key has m =
// kNegInf and l = acc = 0 and adds nothing; a row no part saw writes
// zeros.
template <int HD, int NT, typename Dst>
__device__ __forceinline__ void merge_parts(const float* acc,
                                            const float* ml, int S,
                                            int rows, Dst dst) {
  for (int c = threadIdx.x; c < rows * (HD / 4); c += NT) {
    const int r = c / (HD / 4), d = (c - r * (HD / 4)) * 4;
    float* o = dst(r);
    if (o == nullptr) continue;
    float m = kNegInf, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const long long sr = (long long)s * rows + r;
      const float2 p = __ldcg(reinterpret_cast<const float2*>(ml + 2 * sr));
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(acc + sr * HD + d));
      const float mn = fmaxf(m, p.x);
      const float f0 = expf(m - mn), f1 = expf(p.x - mn);
      l = l * f0 + p.y * f1;
      a.x = a.x * f0 + v.x * f1;
      a.y = a.y * f0 + v.y * f1;
      a.z = a.z * f0 + v.z * f1;
      a.w = a.w * f0 + v.w * f1;
      m = mn;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<float4*>(o + d) =
        make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
}

}  // namespace repro
