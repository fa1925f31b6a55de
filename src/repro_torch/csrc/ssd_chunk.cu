// Mamba2 SSD within-chunk dual form for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_chunk_kernel`
// (src/repro/kernels/ssd_chunk.py:60): per (batch, chunk, head) the
// chunk's quadratic "dual form" and its end state,
//
//   seg     = cumsum(da)                         (Q,)
//   L[i,j]  = exp(seg_i - seg_j) for i >= j, 0 above the diagonal
//   Y       = ((C B^T) * L * dt_j) X             (Q, P)
//   S_chunk = (exp(seg_{Q-1} - seg) * dt * B)^T X -> stored (P, N)
//
// so that no Q x Q intermediate reaches device memory.
//
// Contract (the plain PyTorch version in
// repro_torch/kernels/ssd_chunk.py computes the same):
//   x (B, C, Q, H, P), dt/da (B, C, Q, H), b/c (B, C, Q, H, N), f32,
//     read in place through their (batch, chunk, row, head) strides with
//     the last axis contiguous; the head stride of b/c may be 0 (one
//     group broadcast over the heads);
//   y (B, C, Q, H, P) and st (B, C, H, P, N) f32 contiguous;
//   P <= 128, P and N multiples of 4.
//
// Bound on the H100: operations.  Per (b, c, h) the visible (i >= j)
// pairs cost 2N + 2P flops each and the state 2QPN.  At the calibration
// prefill's shape (B 512, C 1, Q 256, H 24, P 64, N 128) that is 207
// GFLOP, 3.1 ms at 67 TFLOP/s in f32 (no tensor cores: the inputs are
// f32 and TF32 would change the numbers), against 2.1 GB of operands
// (b/c read once, broadcast over the heads), 0.6 ms at 3.35 TB/s.
//
// Design for that bound.  A block of 256 threads has one of two roles:
//   * a 64-row tile of Y: the C rows of the tile stay in shared memory;
//     for each 64-key tile at or left of the diagonal it stages B and X,
//     forms S = C B^T with each thread a 4 x 4 register tile fed by
//     float4 shared-memory loads, turns it into M = S * L * dt (the
//     exponential is taken only where i >= j: above the diagonal
//     seg_i - seg_j is large and positive and would overflow to inf),
//     writes M to shared memory and accumulates Y += M X in registers;
//   * a share of the state: the block walks all Q rows in 64-row tiles
//     of (w_j X_j) and B_j, each thread a 4 x 4 tile of (P, N).
// Q x Q never leaves shared memory, nothing is carried between blocks
// and no atomics are used, so every run sums in the same order.  The
// cumsum is accumulated in f64 by one warp (each lane a run of rows,
// then a shuffle scan of the runs) and each prefix rounded to f32, as
// the plain version's `prefix_sum` does: at the model's decay seg
// reaches -500 in a chunk, where f32 accumulators of different orders
// drift apart by several ulp (6.1e-5 each) and L = exp(seg_i - seg_j)
// with them.
// Padded rows (dt = 0, x = 0) are computed like any other; skipping
// them, tensor cores (TF32 or bf16 wgmma) and TMA are for a later
// change.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;              // rows (and keys) per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kMaxPT = 8;           // Y columns per thread: P <= 128
constexpr int kLdM = kT + 16;       // M row stride: the two rows of a
                                    // warp's stores fall in other banks
constexpr int kMaxSmem = 232448;    // a block's shared memory on sm_90

struct Params {
  const float* x;
  const float* dt;
  const float* da;
  const float* b;
  const float* c;
  float* y;
  float* st;
  int C, Q, H, P, N, n_qt, n_st;
  long long x_sb, x_sc, x_sq, x_sh;
  long long t_sb, t_sc, t_sq, t_sh;
  long long a_sb, a_sc, a_sq, a_sh;
  long long b_sb, b_sc, b_sq, b_sh;
  long long c_sb, c_sc, c_sq, c_sh;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// rows [0, kT) of a (rows, width) operand starting at row r0, row stride
// `sr`, into shared memory with row stride `ld`; rows past Q are zero
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long sr, int r0, int width,
                                      int Q) {
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int r = e / width, k = e - r * width;
    const int i = r0 + r;
    dst[r * ld + k] = i < Q ? src[i * sr + k] : 0.f;
  }
}

__device__ __forceinline__ void y_role(const Params& a, int qt, int bi,
                                       int ci, int h, const float* xb,
                                       const float* bb, const float* cb,
                                       const float* seg, const float* dts,
                                       float* buf) {
  const int Q = a.Q, P = a.P, N = a.N;
  const int ldn = N + 4, ldp = P + 4;
  float* cs = buf;                    // [kT][ldn] C rows of the tile
  float* bs = cs + kT * ldn;          // [kT][ldn] B rows of a key tile
  float* xs = bs + kT * ldn;          // [kT][ldp] X rows of a key tile
  float* ms = xs + kT * ldp;          // [kT][kLdM] M of the tile pair
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int i0 = qt * kT;
  stage(cs, ldn, cb, a.c_sq, i0, N, Q);

  float acc[4][kMaxPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < kMaxPT; ++k) acc[r][k] = 0.f;

  for (int j0 = 0; j0 <= i0; j0 += kT) {
    __syncthreads();          // the scan, C tile / last key tile consumed
    stage(bs, ldn, bb, a.b_sq, j0, N, Q);
    stage(xs, ldp, xb, a.x_sq, j0, P, Q);
    __syncthreads();

    // S = C B^T: rows ty + 16r, keys tx + 16k
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[r][k] = 0.f;
    for (int n = 0; n < N; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ld4(cs + (ty + 16 * r) * ldn + n);
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = ld4(bs + (tx + 16 * k) * ldn + n);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s[r][k] = fmaf(cv[r].x, bv[k].x, s[r][k]);
          s[r][k] = fmaf(cv[r].y, bv[k].y, s[r][k]);
          s[r][k] = fmaf(cv[r].z, bv[k].z, s[r][k]);
          s[r][k] = fmaf(cv[r].w, bv[k].w, s[r][k]);
        }
    }
    // M = S * L * dt_j, masked before the exponential
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + tx + 16 * k;
        float m = 0.f;
        if (i < Q && j <= i) m = s[r][k] * expf(seg[i] - seg[j]) * dts[j];
        ms[(ty + 16 * r) * kLdM + tx + 16 * k] = m;
      }
    }
    __syncthreads();

    // Y += M X: rows ty + 16r, columns tx + 16k
    for (int jj = 0; jj < kT; jj += 4) {
      float4 mv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) mv[r] = ld4(ms + (ty + 16 * r) * kLdM + jj);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* xrow = xs + (jj + u) * ldp;
#pragma unroll
        for (int k = 0; k < kMaxPT; ++k) {
          const int p = tx + 16 * k;
          if (p < P) {
            const float xv = xrow[p];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[r][k] = fmaf(comp(mv[r], u), xv, acc[r][k]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= Q) continue;
    float* yrow = a.y + ((((long long)bi * a.C + ci) * Q + i) * a.H + h) * P;
#pragma unroll
    for (int k = 0; k < kMaxPT; ++k) {
      const int p = tx + 16 * k;
      if (p < P) yrow[p] = acc[r][k];
    }
  }
}

__device__ __forceinline__ void state_role(const Params& a, int sr, int bi,
                                           int ci, int h, const float* xb,
                                           const float* bb, const float* seg,
                                           float* w, float* buf) {
  const int Q = a.Q, P = a.P, N = a.N;
  const int ldn = N + 4, ldp = P + 4;
  float* xw = buf;                    // [kT][ldp] w_j X_j
  float* bs = xw + kT * ldp;          // [kT][ldn] B_j
  const int tid = threadIdx.x;
  __syncthreads();                    // the scan is done
  // w_j = exp(seg_{Q-1} - seg_j) dt_j, in place of dt
  const float last = seg[Q - 1];
  for (int i = tid; i < Q; i += kThreads) w[i] = expf(last - seg[i]) * w[i];

  // this thread's 4 x 4 tile of the (P, N) state
  const int nq = N / 4;
  const int m = sr * kThreads + tid;
  const bool live = m < (P / 4) * nq;
  const int p0 = live ? 4 * (m / nq) : 0;
  const int n0 = live ? 4 * (m % nq) : 0;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kT) {
    __syncthreads();                  // w ready / last tile consumed
    for (int e = tid; e < kT * P; e += kThreads) {
      const int r = e / P, p = e - r * P;
      const int j = j0 + r;
      xw[r * ldp + p] = j < Q ? w[j] * xb[j * a.x_sq + p] : 0.f;
    }
    stage(bs, ldn, bb, a.b_sq, j0, N, Q);
    __syncthreads();
    if (!live) continue;
    const int rows = min(kT, Q - j0);
    for (int jj = 0; jj < rows; ++jj) {
      const float4 xv = ld4(xw + jj * ldp + p0);
      const float4 bv = ld4(bs + jj * ldn + n0);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[r][k] = fmaf(comp(xv, r), comp(bv, k), acc[r][k]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* row =
        a.st + ((((long long)bi * a.C + ci) * a.H + h) * P + p0 + r) * N + n0;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const Params a) {
  extern __shared__ float4 smem4[];   // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  const int roles = a.n_qt + a.n_st;
  const int role = blockIdx.x % roles;
  long long bch = blockIdx.x / roles;
  const int h = (int)(bch % a.H);
  bch /= a.H;
  const int ci = (int)(bch % a.C);
  const int bi = (int)(bch / a.C);
  const int Q = a.Q;

  const float* xb = a.x + bi * a.x_sb + ci * a.x_sc + h * a.x_sh;
  const float* tb = a.dt + bi * a.t_sb + ci * a.t_sc + h * a.t_sh;
  const float* ab = a.da + bi * a.a_sb + ci * a.a_sc + h * a.a_sh;
  const float* bb = a.b + bi * a.b_sb + ci * a.b_sc + h * a.b_sh;
  const float* cb = a.c + bi * a.c_sb + ci * a.c_sc + h * a.c_sh;

  float* seg = smem;                  // [Q] cumsum(da)
  float* dts = smem + Q;              // [Q] dt
  float* buf = smem + ((2 * Q + 3) & ~3);
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    dts[i] = tb[i * a.t_sq];
    seg[i] = ab[i * a.a_sq];
  }
  __syncthreads();
  if (threadIdx.x < 32) {             // f64 prefix sum, rounded to f32
    const int lane = threadIdx.x;
    const int per = (Q + 31) / 32;
    const int lo = min(Q, lane * per), hi = min(Q, lo + per);
    double run = 0.0;
    for (int i = lo; i < hi; ++i) run += (double)seg[i];
    for (int off = 1; off < 32; off <<= 1) {   // inclusive scan of runs
      const double v = __shfl_up_sync(0xffffffffu, run, off);
      if (lane >= off) run += v;
    }
    double pre = __shfl_up_sync(0xffffffffu, run, 1);
    if (lane == 0) pre = 0.0;
    for (int i = lo; i < hi; ++i) {
      pre += (double)seg[i];
      seg[i] = (float)pre;
    }
  }
  if (role < a.n_qt)
    y_role(a, role, bi, ci, h, xb, bb, cb, seg, dts, buf);
  else
    state_role(a, role - a.n_qt, bi, ci, h, xb, bb, seg, dts, buf);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).
extern "C" int repro_ssd_chunk(
    const void* x, const void* dt, const void* da, const void* b,
    const void* c, void* y, void* st, int B, int C, int Q, int H, int P,
    int N, long long x_sb, long long x_sc, long long x_sq, long long x_sh,
    long long t_sb, long long t_sc, long long t_sq, long long t_sh,
    long long a_sb, long long a_sc, long long a_sq, long long a_sh,
    long long b_sb, long long b_sc, long long b_sq, long long b_sh,
    long long c_sb, long long c_sc, long long c_sq, long long c_sh,
    void* stream) {
  if (B <= 0 || C <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 ||
      P > 16 * kMaxPT || P % 4 != 0 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Params a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.da = static_cast<const float*>(da);
  a.b = static_cast<const float*>(b);
  a.c = static_cast<const float*>(c);
  a.y = static_cast<float*>(y);
  a.st = static_cast<float*>(st);
  a.C = C, a.Q = Q, a.H = H, a.P = P, a.N = N;
  a.n_qt = (Q + kT - 1) / kT;
  a.n_st = ((P / 4) * (N / 4) + kThreads - 1) / kThreads;
  a.x_sb = x_sb, a.x_sc = x_sc, a.x_sq = x_sq, a.x_sh = x_sh;
  a.t_sb = t_sb, a.t_sc = t_sc, a.t_sq = t_sq, a.t_sh = t_sh;
  a.a_sb = a_sb, a.a_sc = a_sc, a.a_sq = a_sq, a.a_sh = a_sh;
  a.b_sb = b_sb, a.b_sc = b_sc, a.b_sq = b_sq, a.b_sh = b_sh;
  a.c_sb = c_sb, a.c_sc = c_sc, a.c_sq = c_sq, a.c_sh = c_sh;

  const long long floats = ((2LL * Q + 3) & ~3LL) + 2LL * kT * (N + 4) +
                           (long long)kT * (P + 4) + (long long)kT * kLdM;
  const long long smem = floats * (long long)sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;            // the raised limit, once per process
  if (smem > 48 * 1024 && smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = (int)smem;
  }
  const long long blocks = (long long)B * C * H * (a.n_qt + a.n_st);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
