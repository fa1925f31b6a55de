// The fused T-Tamer exit decision for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ramp_exit_kernel`
// (src/repro/kernels/ramp_exit.py): after a ramp head's logits, one
// observation of the recall-index strategy,
//
//     conf  = max softmax(logits[b])         (one streamed (max, sumexp)
//                                              pass over V, no softmax
//                                              written anywhere)
//     loss  = lam * (1 - conf)
//     bin   = #{edges < loss}                (searchsorted, left)
//     new_x = min(x_idx[b], bin + 1)
//     stop  = table[bin, new_x] != 0
//
// which is RecallIndexStrategy.observe with table = LineTables.stop[node
// + 1] (repro_torch/strategy/line.py).
//
// Contract (the plain PyTorch version in repro_torch/kernels/ramp_exit.py
// computes the same): logits (B, V) f32 or bf16, read through its row
// stride (a sliced view costs no copy; unit stride along V); edges (E,)
// f32; table (K, X) uint8, contiguous (LineTables.stop's bool bytes);
// x_idx (B,) i32.  Outputs loss f32, bin i32, new_x i32, stop uint8
// (torch.bool), all (B,).  Nothing is padded: the V tail and any B are
// bounds-checked.  The TPU kernel also takes the lanes' previous bins
// (s_bin), reads them and never uses them; so does the wrapper, and
// they never reach this kernel.
//
// Bound on the H100: bytes.  The logits are read once (B * V * 4 bytes;
// 1,608,224 B at B = 8, V = 50,257, 0.48 us at 3.35 TB/s); a few flops
// an element.  Design: one block per row, 512 threads striding over V
// with four independent loads in flight a thread (rows of odd length are
// not 16-byte aligned, so loads are scalar and coalesced across the
// warp); each thread keeps a running (m, l) pair, the warps combine
// theirs by shuffles and the block through shared memory, and thread 0
// takes conf = 1 / max(l, 1e-30) as the TPU kernel does, counts the
// edges and gathers the table entry.  At B = 8 only 8 of the 132 SMs
// work, so the call is bound by one SM's read rate, not the card's;
// splitting V across blocks (a second pass combining the pairs) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;

// Fold a (m2, l2) pair into (m, l): the log-sum-exp merge.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ramp_exit_kernel(const T* __restrict__ logits, long long row_stride, int V,
                 const float* __restrict__ edges, int n_edges,
                 const unsigned char* __restrict__ table, int X,
                 const int* __restrict__ x_idx, float lam,
                 float* __restrict__ loss_out, int* __restrict__ bin_out,
                 int* __restrict__ newx_out,
                 unsigned char* __restrict__ stop_out) {
  const int b = blockIdx.x;
  const T* row = logits + (long long)b * row_stride;
  float m = repro::kNegInf, l = 0.f;
  for (int base = threadIdx.x; base < V; base += kThreads * kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = base + u * kThreads;
      x[u] = v < V ? repro::to_float(row[v]) : repro::kNegInf;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads >= V) break;
      if (x[u] > m) {
        l = l * expf(m - x[u]) + 1.f;
        m = x[u];
      } else {
        l += expf(x[u] - m);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  __shared__ float sm[kThreads / 32], sl[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  m = sm[0];
  l = sl[0];
  for (int w = 1; w < kThreads / 32; ++w) merge(m, l, sm[w], sl[w]);
  const float conf = 1.f / fmaxf(l, 1e-30f);     // exp(m - logsumexp)
  const float loss = lam * (1.f - conf);
  int bin = 0;
  for (int e = 0; e < n_edges; ++e) bin += edges[e] < loss;
  const int nx = min(x_idx[b], bin + 1);
  loss_out[b] = loss;
  bin_out[b] = bin;
  newx_out[b] = nx;
  stop_out[b] = table[bin * X + nx] != 0;
}

template <typename T>
int launch(const void* logits, long long row_stride, int B, int V,
           const void* edges, int n_edges, const void* table, int X,
           const void* x_idx, float lam, void* loss, void* bin, void* new_x,
           void* stop, void* stream) {
  ramp_exit_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), row_stride, V,
      static_cast<const float*>(edges), n_edges,
      static_cast<const unsigned char*>(table), X,
      static_cast<const int*>(x_idx), lam, static_cast<float*>(loss),
      static_cast<int*>(bin), static_cast<int*>(new_x),
      static_cast<unsigned char*>(stop));
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  dtype: 0 = f32
// logits, 1 = bf16.  B >= 1 and V >= 1.
extern "C" int repro_ramp_exit(const void* logits, long long row_stride,
                               int B, int V, int dtype, const void* edges,
                               int n_edges, const void* table, int X,
                               const void* x_idx, float lam, void* loss,
                               void* bin, void* new_x, void* stop,
                               void* stream) {
  if (B <= 0 || V <= 0 || n_edges < 0 || X <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(logits, row_stride, B, V, edges, n_edges, table, X,
                         x_idx, lam, loss, bin, new_x, stop, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, row_stride, B, V, edges, n_edges,
                                 table, X, x_idx, lam, loss, bin, new_x,
                                 stop, stream);
  return (int)cudaErrorInvalidValue;
}
