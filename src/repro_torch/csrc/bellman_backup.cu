// One T-Tamer Bellman backup of the line DP for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bellman_backup_kernel`
// (src/repro/kernels/bellman_backup.py): one backward step of the line
// solve (paper Alg. 2, Thm 4.5),
//
//     cont[s, x] = cost + sum_y trans[s, y] * phi_next[y, mi_t[y, x]],
//
// with the min-gather M[y, x] = phi_next[y, mi_t[y, x]] built in shared
// memory and consumed there: M never reaches device memory, which is
// the point of fusing the gather with the product.
//
// Contract (the plain PyTorch version in
// repro_torch/kernels/bellman_backup.py computes the same):
//   phi_next (K, X) f32, trans (K, K) f32, mi_t (K, X) i32 with entries
//   in [0, X), all contiguous; cost a one-element f32 tensor on the
//   card (read there, so the host never waits for it); out (K, X) f32.
//   X is K + 2 on the solve's path; any X works, there is no padding.
//
// Bound on the H100: bytes, and far below a launch.  At the served
// K = 24 (X = 26) one backup reads 2.5 KB of phi, 2.5 KB of mi_t and
// 2.3 KB of trans and writes 2.5 KB, about 3 ns at 3.35 TB/s, against
// 30 KFLOP; the solve runs one backup per node (6 at paper-ee-100m),
// each waiting on the one before.  So the launch latency sets its time,
// and its value is parity with the reference, not speed.
//
// Design: one block of up to 1024 threads.  The threads first fill M in
// shared memory, one element each in turn over (y, x), then compute the
// outputs over (s, x) with a loop over y: neighbouring threads take
// neighbouring x, so a warp reads neighbouring words of an M row.  The TPU wrapper pads X to
// 128 with repeats of the edge column; here the ragged edge needs no
// padding, since each thread checks its own index.  Running the whole
// backward solve in one launch is a later option (ROADMAP).

#include <cuda_runtime.h>

namespace {

__global__ void bellman_backup_kernel(const float* __restrict__ phi,
                                      const float* __restrict__ trans,
                                      const int* __restrict__ mi_t,
                                      const float* __restrict__ cost,
                                      float* __restrict__ out, int K,
                                      int X) {
  extern __shared__ float m[];                  // [K][X]
  const int n = K * X;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = i / X;
    m[i] = phi[y * X + mi_t[i]];
  }
  __syncthreads();
  const float c = cost[0];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s = i / X, x = i % X;
    const float* row = trans + s * K;
    float acc = 0.f;
    for (int y = 0; y < K; ++y) acc += row[y] * m[y * X + x];
    out[i] = c + acc;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  K * X floats
// must fit one block's shared memory (227 KB).
extern "C" int repro_bellman_backup(const void* phi_next, const void* trans,
                                    const void* mi_t, const void* cost,
                                    void* out, int K, int X, void* stream) {
  if (K <= 0 || X <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)K * X;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bellman_backup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int n = K * X;
  const int threads = n < 1024 ? (n + 31) / 32 * 32 : 1024;
  bellman_backup_kernel<<<1, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phi_next), static_cast<const float*>(trans),
      static_cast<const int*>(mi_t), static_cast<const float*>(cost),
      static_cast<float*>(out), K, X);
  return (int)cudaGetLastError();
}
