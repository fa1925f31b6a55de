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
// an element.  The whole input of a readout is smaller than what the
// card must keep in flight to read at its full rate, so the design puts
// all of it in flight at once, spread over the card:
//
//   - a row is split over the S blocks of one thread-block cluster
//     (S <= 8, the portable cluster size, chosen by the wrapper so that
//     B * S covers twice the SMs where V allows it); the grid is S * B
//     blocks of 256 threads, block i taking split i % S of row i / S;
//   - a block streams its share with 16-byte loads (4 f32 or 8 bf16):
//     a row view starts anywhere, so the elements before the row's first
//     16-byte boundary (the head, split 0) and after its last (the tail,
//     split S - 1) are scalar loads; every load of a round (4 words a
//     thread, and the scalars) is issued before the first is used;
//   - each thread keeps a running (m, l) pair: a max over the round,
//     then exp(x - m) as 2^((x - m) log2 e) on the SFU, exact where x
//     is the max (so a lone dominant logit counts exactly 1);
//   - warps merge their pairs by butterflies, then warp 0 over the
//     warps' (a fixed order, so the result does not depend on timing);
//   - every block stores its pair into rank 0's shared memory through
//     distributed shared memory (after a barrier that each block arrived
//     at when it started, so rank 0 is running) and one cluster barrier
//     later rank 0 holds all S pairs; the other blocks exit.  No global
//     scratch, no ticket, no float atomics;
//   - rank 0 merges the S pairs by a butterfly and takes the decision as
//     the TPU kernel does: conf = 1 / max(l, 1e-30), the edges counted,
//     the table gathered.  Its inputs (edges, x index, the table up to
//     1,024 entries) were loaded into registers by rank 0's threads
//     before the logits, so the decision waits on no trip to memory:
//     the block counts the edges below the loss (__syncthreads_count)
//     and the thread that holds the table entry writes the stop bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // 16-byte loads a thread has in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSplits = 8;     // the portable cluster size
constexpr int kTableRegs = 4;     // table bytes a thread of rank 0 holds

// Fold a (m2, l2) pair into (m, l): the log-sum-exp merge.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// Fold one element into (m, l).
__device__ __forceinline__ void push(float& m, float& l, float x) {
  if (x > m) {
    l = l * expf(m - x) + 1.f;
    m = x;
  } else {
    l += expf(x - m);
  }
}

// 2^x by the SFU (relative error about 2^-22; a result below the
// smallest normal f32 is flushed to 0, which the sums never notice)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The W = 16 / sizeof(T) elements of a 16-byte word, as f32.
__device__ __forceinline__ void unpack(uint4 w, float* x, float) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(uint4 w, float* x, __nv_bfloat16) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 -> f32: the high half of a word
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Merge the (m, l) pairs of the lanes of a warp in `width`-lane groups
// by a butterfly (a fixed order): every lane of a group ends with the
// group's pair.
__device__ __forceinline__ void warp_merge(float& m, float& l, int width) {
  for (int off = width / 2; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ramp_exit_kernel(const T* __restrict__ logits, long long row_stride, int V,
                 int S, const float* __restrict__ edges, int n_edges,
                 const unsigned char* __restrict__ table, int X,
                 const int* __restrict__ x_idx, float lam,
                 float* __restrict__ loss_out, int* __restrict__ bin_out,
                 int* __restrict__ newx_out,
                 unsigned char* __restrict__ stop_out) {
  constexpr int W = 16 / sizeof(T), kWarps = kThreads / 32;
  // every block of the cluster has started once this barrier completes
  // (waited for below, before the first remote store)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x;
  const T* row = logits + (long long)b * row_stride;
  // head: elements before the first 16-byte boundary; the body's whole
  // 16-byte words split evenly over the S blocks; tail: what is left
  const int mis = (int)((reinterpret_cast<size_t>(row) % 16) / sizeof(T));
  const int head = min(V, (W - mis) % W);
  const int words = (V - head) / W;
  const int tail_at = head + words * W;
  const int w0 = (int)((long long)words * split / S);
  const int w1 = (int)((long long)words * (split + 1) / S);
  const uint4* body = reinterpret_cast<const uint4*>(row + head);

  // issued first, used last: rank 0's share of the decision's inputs
  // (an edge and kTableRegs table bytes a thread, the lane's x index),
  // so the decision waits on no trip to memory
  const bool rank0 = split == 0;
  const int n_table = (n_edges + 1) * X;
  const float edge = rank0 && tid < n_edges ? edges[tid] : 0.f;
  unsigned char tab[kTableRegs];
#pragma unroll
  for (int j = 0; j < kTableRegs; ++j) {
    const int i = tid + j * kThreads;
    tab[j] = rank0 && i < n_table ? table[i] : 0;
  }
  const int xi = rank0 && tid == 0 ? x_idx[b] : 0;
  // the scalars of the head and tail, used after the body's loads
  const bool has_head = rank0 && tid < head;
  const bool has_tail = split == S - 1 && tid < V - tail_at;
  const float xh = has_head ? repro::to_float(row[tid]) : 0.f;
  const float xt = has_tail ? repro::to_float(row[tail_at + tid]) : 0.f;

  float m = repro::kNegInf, l = 0.f;
  for (int base = w0 + tid; base < w1; base += kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = base + u * kThreads;
      if (w < w1) raw[u] = __ldg(body + w);
    }
    float x[kUnroll][W];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads >= w1) break;
      unpack(raw[u], x[u], T());
#pragma unroll
      for (int j = 0; j < W; ++j) mx = fmaxf(mx, x[u][j]);
    }
    // exp(x - mx) as 2^((x - mx) log2(e)) on the SFU; x - mx is exact
    // at the max, so a lone dominant logit counts exactly 1
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads >= w1) break;
#pragma unroll
      for (int j = 0; j < W; ++j)
        acc += exp2_approx((x[u][j] - mx) * kLog2e);
    }
    l = l * expf(m - mx) + acc;
    m = mx;
  }
  if (has_head) push(m, l, xh);
  if (has_tail) push(m, l, xt);

  // the block's pair: warps by butterflies, then warp 0 over the warps'
  __shared__ float wm[kWarps], wl[kWarps];
  __shared__ float parts[2 * kMaxSplits];   // rank 0's: every split's pair
  const int warp = tid / 32, lane = tid % 32;
  warp_merge(m, l, 32);
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? wm[lane] : repro::kNegInf;
    l = lane < kWarps ? wl[lane] : 0.f;
    warp_merge(m, l, kWarps);
  }
  // each block stores its pair into rank 0's shared memory; one cluster
  // barrier later rank 0 holds them all, and the other blocks may exit
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid == 0) {
    float* dst = cluster.map_shared_rank(parts, 0);
    dst[2 * split] = m;
    dst[2 * split + 1] = l;
  }
  cluster.sync();
  if (!rank0) return;
  // the decision: warp 0 merges the S pairs, the block counts the edges
  // below the loss and the thread that holds the table entry writes the
  // stop bit
  __shared__ float s_loss;
  __shared__ int s_at;
  if (warp == 0) {
    m = lane < S ? parts[2 * lane] : repro::kNegInf;
    l = lane < S ? parts[2 * lane + 1] : 0.f;
    warp_merge(m, l, kMaxSplits);
    if (lane == 0) {
      const float conf = 1.f / fmaxf(l, 1e-30f);  // exp(m - logsumexp)
      s_loss = lam * (1.f - conf);
    }
  }
  __syncthreads();
  const float loss = s_loss;
  int bin = __syncthreads_count(tid < n_edges && edge < loss);
  if (tid == 0) {
    for (int e = kThreads; e < n_edges; ++e) bin += edges[e] < loss;
    const int nx = min(xi, bin + 1);
    loss_out[b] = loss;
    bin_out[b] = bin;
    newx_out[b] = nx;
    s_at = bin * X + nx;
    if (s_at >= kTableRegs * kThreads) stop_out[b] = table[s_at] != 0;
  }
  __syncthreads();
  const int at = s_at;
  if (at < kTableRegs * kThreads && at % kThreads == tid) {
    unsigned char v = 0;
#pragma unroll
    for (int j = 0; j < kTableRegs; ++j)
      if (at / kThreads == j) v = tab[j];
    stop_out[b] = v != 0;
  }
}

cudaLaunchConfig_t config(int B, int S, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * S));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch(const void* logits, long long row_stride, int B, int V, int S,
           const void* edges, int n_edges, const void* table, int X,
           const void* x_idx, float lam, void* loss, void* bin, void* new_x,
           void* stop, void* stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(B, S, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ramp_exit_kernel<T>, static_cast<const T*>(logits),
      row_stride, V, S, static_cast<const float*>(edges), n_edges,
      static_cast<const unsigned char*>(table), X,
      static_cast<const int*>(x_idx), lam, static_cast<float*>(loss),
      static_cast<int*>(bin), static_cast<int*>(new_x),
      static_cast<unsigned char*>(stop));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int info(int B, int S, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, ramp_exit_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, ramp_exit_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(B, S, nullptr, attr);
  err = cudaOccupancyMaxActiveClusters(&clusters, ramp_exit_kernel<T>, &cfg);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = blocks;
  out[3] = (int)a.localSizeBytes;
  out[4] = clusters;
  return (int)err;
}

bool valid(int B, int V, int S) {
  return B > 0 && V > 0 && S >= 1 && S <= kMaxSplits &&
         (long long)B * S <= 0x7fffffffLL;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success; a cluster launch
// the device refuses returns its error).  dtype: 0 = f32 logits, 1 =
// bf16.  B >= 1, V >= 1, 1 <= S <= 8 blocks (one cluster) a row.
extern "C" int repro_ramp_exit(const void* logits, long long row_stride,
                               int B, int V, int S, int dtype,
                               const void* edges, int n_edges,
                               const void* table, int X, const void* x_idx,
                               float lam, void* loss, void* bin, void* new_x,
                               void* stop, void* stream) {
  if (!valid(B, V, S) || n_edges < 0 || X <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(logits, row_stride, B, V, S, edges, n_edges, table,
                         X, x_idx, lam, loss, bin, new_x, stop, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, row_stride, B, V, S, edges, n_edges,
                                 table, X, x_idx, lam, loss, bin, new_x,
                                 stop, stream);
  return (int)cudaErrorInvalidValue;
}

// The f32 kernel's resources as the runtime reports them: out[0]
// registers a thread, out[1] static shared memory a block (bytes), out[2]
// blocks an SM, out[3] local (spill) bytes a thread, out[4] clusters of
// S blocks the device holds at once for a grid of B rows.
extern "C" int repro_ramp_exit_info(int B, int S, int* out) {
  if (!valid(B, 1, S)) return (int)cudaErrorInvalidValue;
  return info<float>(B, S, out);
}
