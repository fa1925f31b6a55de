// The T-Tamer line DP's backward solve for Hopper (sm_90a): n Bellman
// backups in one launch.
//
// Replaces the Pallas TPU kernel `bellman_backup_kernel`
// (src/repro/kernels/bellman_backup.py), one backward step of the line
// solve (paper Alg. 2, Thm 4.5),
//
//     cont[s, x] = cost + sum_y trans[s, y] * phi_next[y, mi_t[y, x]],
//
// and the `lax.scan` of the JAX solve that calls it once a node
// (src/repro/core/line_dp.py): for node i = n-1 .. 0,
//
//     cont_i = costs[i] + trans_i @ M,  M[y, x] = phi[y, mi_t[y, x]]
//     phi    = min(xvals, cont_i)        (phi starts as the base)
//
// writing cont (n, K, X) and phi (n + 1, K, X), phi[n] = the base.  The
// TPU kernel's single backup is the n = 1 case, launched with no xvals
// and no phi output.
//
// Contract (the plain PyTorch versions in
// repro_torch/kernels/bellman_backup.py compute the same): base (K, X),
// trans (n, K, K), costs (n,), xvals (X,) f32 and mi_t (K, X) i32 with
// entries in [0, X), all contiguous on the card (costs too, so the host
// never waits for them).  X is K + 2 on the solve's path; any X works,
// there is no padding.
//
// Bound on the H100: bytes, and far below a launch.  At the served
// K = 24 (X = 26) a backup reads 2.3 KB of trans and the solve about
// 16 KB in all against 30 KFLOP a backup; each backup waits on the one
// before.  So one block runs the whole solve, and its time is the
// launch, one trip to memory and n short rounds on one SM.  A round is
// bound by latency: a load from shared memory takes tens of cycles, a
// sum over y is a chain of K FMAs, and a few warps cannot hide either.
// (Spreading the rows over a cluster of SMs was tried: a cluster
// barrier a node cost about what the split saved at K = 24.)  So:
//
//   - base, mi_t, xvals, costs and every node's trans are staged in one
//     trip (cp.async); mi_t becomes offsets into phi in place.  Where n
//     transitions do not fit the block's shared memory, two buffers
//     take turns: the next node's trans is copied in while this node
//     computes;
//   - a node gathers M[y, x] = phi[y, mi_t[y, x]] into shared memory,
//     four elements a thread at a time (the loads issued before any is
//     used);
//   - a warp takes 4 rows s and a lane one column x; every operand of
//     8 steps of y (the warp-uniform 16-byte words trans[s, y .. y+3]
//     of the 4 rows, and M[y, x]) is loaded before their 32 FMAs, so the
//     chain waits on one load a batch, not one a step.  Each output sums
//     y in ascending order in one FMA chain, so every backup gives the
//     same bits whatever n it is launched in;
//   - phi lives in shared memory in two buffers (read by this node's
//     gather, written for the next); cont and phi go to device memory
//     from the lanes a row at a time, so the stores coalesce.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRows = 4;                 // rows s a warp task
constexpr int kSteps = 8;                // y steps a batch
constexpr int kThreads = 512;
constexpr int kSmemWords = 232448 / 4;   // a block's shared memory (H100)

__host__ __device__ constexpr int pad4(int w) { return (w + 3) / 4 * 4; }

// Dynamic shared memory in 4-byte words, each region 16-byte aligned;
// `bufs` transitions (n, or 2 taking turns) in rows of pad4(K) words.
struct Layout {
  int bufs, tr, ph, m, mp, xv, cs, words;
  __host__ __device__ Layout(int n, int K, int X) {
    bufs = n;
    for (int pass = 0; pass < 2; ++pass) {
      tr = 0;                            // [bufs][K][pad4(K)] trans
      ph = tr + bufs * K * pad4(K);      // [2][K][X] phi, two buffers
      m = pad4(ph + 2 * K * X);          // [K][X] the gathered M
      mp = pad4(m + K * X);              // [K][X] int: offsets into phi
      xv = pad4(mp + K * X);             // [X]
      cs = pad4(xv + X);                 // [n]
      words = cs + n;
      if (words <= kSmemWords || bufs <= 2) break;
      bufs = 2;
    }
  }
};

// count words from src to dst (shared): 16 bytes a copy where both are
// 16-byte aligned, else one word a copy
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count, int tid) {
  int done = 0;
  if (((reinterpret_cast<size_t>(src) |
        (size_t)__cvta_generic_to_shared(dst)) & 15) == 0) {
    done = count / 4 * 4;
    for (int i = tid; i < count / 4; i += kThreads)
      repro::cp_async16(dst + 4 * i, src + 4 * i);
  }
  for (int i = done + tid; i < count; i += kThreads)
    repro::cp_async4(dst + i, src + i);
}

// `count` K x K transitions into rows of pad4(K) words
__device__ __forceinline__ void stage_trans(float* dst, const float* src,
                                            int count, int K, int tid) {
  const int kr = pad4(K);
  if (kr == K) {
    stage(dst, src, count * K * K, tid);
    return;
  }
  for (int r = 0; r < count * K; ++r)
    for (int c = tid; c < K; c += kThreads)
      repro::cp_async4(dst + r * kr + c, src + r * K + c);
}

__global__ void __launch_bounds__(kThreads)
bellman_solve_kernel(const float* __restrict__ base,
                     const float* __restrict__ trans,
                     const float* __restrict__ costs,
                     const float* __restrict__ xvals,
                     const int* __restrict__ mi_t, float* __restrict__ cont,
                     float* __restrict__ phi_out, int n, int K, int X) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(n, K, X);
  const int kx = K * X, kk = K * K, kr = pad4(K);
  float* tr = smem + L.tr;
  float* ph = smem + L.ph;
  float* m = smem + L.m;
  int* mp = reinterpret_cast<int*>(smem + L.mp);
  float* xv = smem + L.xv;
  float* cs = smem + L.cs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool turns = L.bufs < n;        // two buffers taking turns

  // one trip: base, mi_t, xvals, costs and the transitions
  stage(ph, base, kx, tid);
  stage(reinterpret_cast<float*>(mp), reinterpret_cast<const float*>(mi_t),
        kx, tid);
  if (xvals != nullptr) stage(xv, xvals, X, tid);
  stage(cs, costs, n, tid);
  if (turns)
    stage_trans(tr + ((n - 1) & 1) * K * kr, trans + (long long)(n - 1) * kk,
                1, K, tid);
  else
    stage_trans(tr, trans, n, K, tid);
  repro::cp_commit();
  repro::cp_wait<0>();
  __syncthreads();                      // the first trip landed
  for (int i = tid; i < kx; i += kThreads) {
    mp[i] += i / X * X;                 // an offset into phi (own words)
    if (phi_out != nullptr) phi_out[(long long)n * kx + i] = ph[i];
  }

  // a warp task: rows s0 .. s0+3 and columns 32 c .. 32 c + 31
  const int xc = (X + 31) / 32, tasks = (K + kRows - 1) / kRows * xc;
  int cur = 0;
  for (int node = n - 1; node >= 0; --node) {
    if (turns && node > 0) {            // in flight while this node runs
      stage_trans(tr + ((node - 1) & 1) * K * kr,
                  trans + (long long)(node - 1) * kk, 1, K, tid);
      repro::cp_commit();
    }
    const float* phi = ph + cur * kx;
    float* nxt = ph + (cur ^ 1) * kx;
    for (int i0 = tid; i0 < kx; i0 += 4 * kThreads) {   // own mp words
      int p[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        p[u] = i < kx ? mp[i] : 0;
      }
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = phi[p[u]];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kThreads < kx) m[i0 + u * kThreads] = v[u];
    }
    __syncthreads();                    // M gathered
    const float* t = tr + (turns ? node & 1 : node) * K * kr;
    const float c = cs[node];
    for (int task = warp; task < tasks; task += kThreads / 32) {
      const int s0 = task / xc * kRows, x = task % xc * 32 + lane;
      const int xr = min(x, X - 1);     // lanes past X read column X - 1
      const float* tp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) tp[r] = t + min(s0 + r, K - 1) * kr;
      float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
      for (int y0 = 0; y0 < K; y0 += kSteps) {
        float4 tv[kRows][kSteps / 4];   // trans[s0 + r, y0 .. y0 + 7]
        float mv[kSteps];               // M[y0 .. y0 + 7, x]
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int q = 0; q < kSteps / 4; ++q)
            tv[r][q] = *reinterpret_cast<const float4*>(
                tp[r] + min(y0 + 4 * q, kr - 4));
#pragma unroll
        for (int u = 0; u < kSteps; ++u)
          mv[u] = m[min(y0 + u, K - 1) * X + xr];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          if (y0 + u < K) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 w = tv[r][u / 4];
              const float tw = u % 4 == 0 ? w.x : u % 4 == 1 ? w.y
                             : u % 4 == 2 ? w.z : w.w;
              acc[r] += tw * mv[u];
            }
          }
        }
      }
      if (x < X) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int s = s0 + r;
          if (s < K) {
            const float v = c + acc[r];
            cont[(long long)node * kx + s * X + x] = v;
            if (phi_out != nullptr) {
              const float p = fminf(xv[x], v);
              nxt[s * X + x] = p;
              phi_out[(long long)node * kx + s * X + x] = p;
            }
          }
        }
      }
    }
    repro::cp_wait<0>();
    __syncthreads();            // the next phi written, M read; the next
    cur ^= 1;                   // trans landed
  }
}

size_t smem_bytes(int n, int K, int X) {
  return sizeof(float) * (size_t)Layout(n, K, X).words;
}

cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(bellman_solve_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  n >= 1 backups;
// with phi == nullptr (then xvals is not read) only cont is written,
// which n = 1 alone allows: the single backup.  The shared memory (see
// Layout; with two transitions, about 4 * (2 K pad4(K) + 4 K X + X + n)
// bytes) must fit one block's 227 KB.
extern "C" int repro_bellman_solve(const void* base, const void* trans,
                                   const void* costs, const void* xvals,
                                   const void* mi_t, void* cont, void* phi,
                                   int n, int K, int X, void* stream) {
  if (n <= 0 || K <= 0 || X <= 0 || (phi == nullptr && n != 1) ||
      (phi != nullptr && xvals == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, K, X);
  if (smem > sizeof(float) * kSmemWords) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  bellman_solve_kernel<<<1, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const float*>(trans),
      static_cast<const float*>(costs), static_cast<const float*>(xvals),
      static_cast<const int*>(mi_t), static_cast<float*>(cont),
      static_cast<float*>(phi), n, K, X);
  return (int)cudaGetLastError();
}

// The kernel's resources for an n-node solve at K, X, as the runtime
// reports them: out[0] registers a thread, out[1] shared memory a block
// (bytes), out[2] threads of the block, out[3] local (spill) bytes a
// thread, out[4] transitions held in shared memory at once.
extern "C" int repro_bellman_solve_info(int n, int K, int X, int* out) {
  if (n <= 0 || K <= 0 || X <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, K, X);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, bellman_solve_kernel);
  out[0] = a.numRegs;
  out[1] = (int)(smem + a.sharedSizeBytes);
  out[2] = kThreads;
  out[3] = (int)a.localSizeBytes;
  out[4] = Layout(n, K, X).bufs;
  return (int)err;
}
