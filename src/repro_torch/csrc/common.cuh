// Shared device helpers of the paged attention kernels: a warp-wide sum
// and the position mask of the paged KV pool.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

// f32 online softmax of one query row held by one warp: lane `lane`
// owns elements [lane * EPT, lane * EPT + EPT) of q and of the output.
template <int EPT>
struct OnlineRow {
  float q[EPT];
  float acc[EPT];
  float m = kNegInf;
  float l = 0.f;

  __device__ __forceinline__ void load_q(const float* row, int lane) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      q[i] = row[lane * EPT + i];
      acc[i] = 0.f;
    }
  }

  // Fold one visible key/value row into the running max, sum and
  // accumulator.  Every lane of the warp calls this with the same key.
  template <typename T>
  __device__ __forceinline__ void add(const T* krow, const T* vrow,
                                      int lane, float scale) {
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) d += q[i] * to_float(krow[lane * EPT + i]);
    const float s = warp_sum(d) * scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < EPT; ++i)
      acc[i] = acc[i] * alpha + p * to_float(vrow[lane * EPT + i]);
    m = m_new;
  }

  // A row that saw no visible key has acc == 0 and writes zeros.
  __device__ __forceinline__ void store(float* row, int lane) const {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < EPT; ++i) row[lane * EPT + i] = acc[i] / denom;
  }
};

}  // namespace repro
