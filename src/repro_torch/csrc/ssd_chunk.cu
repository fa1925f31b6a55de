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
//     the last axis contiguous and every row of x, b and c starting on
//     16 bytes (the wrapper checks: 16-byte aligned base pointers,
//     strides multiples of 4 elements); the head stride of b/c may be
//     0 (one group broadcast over the heads);
//   q_valid in 1..Q: rows at or past q_valid of the LAST chunk are the
//     caller's padding and hold x = B = C = dt = da = 0.  Their y rows
//     are then exactly 0 (C = 0), they add exactly 0 to every other row
//     and to the state (B = x = dt = 0), and seg is flat across them
//     (da = 0): the kernel never reads or multiplies them, and writes
//     exact zeros to their y rows.  q_valid = Q computes every row;
//   y (B, C, Q, H, P) and st (B, C, H, P, N) f32 contiguous, every
//     element written;
//   P <= 128, P and N multiples of 4.
//
// Bound on the H100.  Per (b, c, h) the visible (i >= j) pairs of the
// q_valid rows cost 2N + 2P flops each and the state 2 q_valid P N.  On
// a full chunk at the calibration prefill's shape (B 512, C 1, Q 256,
// H 24, P 64, N 128) that is 206.8 GFLOP; the products run in 3xTF32 on
// the tensor cores (three TF32 products a product, 3 x 206.8 GFLOP at
// 494.7 TFLOP/s: 1.25 ms), against 2.2 GB of inputs and outputs (0.65
// ms at 3.35 TB/s).  The calibration's real call has 64 valid rows of
// 256: one tile pair and a quarter of the state, while y is still
// written whole (805 MB of its 1.44 GB), so there the bytes bound it
// (0.43 ms).
//
// Design for those bounds.  Every call skips the caller's padding
// (q_valid), which at the calibration removes 9 of 10 (row tile, key
// tile) pairs and 3 of 4 state tiles.  What remains runs on the tensor
// cores with mma.sync.m16n8k8 in TF32, in the 3xTF32 split that keeps
// f32-level accuracy (CUTLASS's OpMultiplyAddFastF32): each operand a
// becomes big = tf32(a) and small = tf32(a - big), and the product is
// small.big + big.small + big.big, accumulated in f32.  A block of 256
// threads (8 warps) has one of two roles:
//   * a 64-row tile of Y: the C rows stay in shared memory; for each
//     64-key tile at or left of the diagonal (and below q_valid) it
//     stages B and X, each warp forms a 16 x 32 tile of S = C B^T
//     (8-key sub-tiles wholly above its rows skipped), turns it into
//     M = S * L * dt in f32 (the exponential taken only where i >= j:
//     above the diagonal seg_i - seg_j is large and positive and would
//     overflow to inf), writes M to shared memory, and accumulates a
//     16 x P/2 tile of Y += M X in its registers;
//   * a share of the state: each warp owns a 16 x 64 tile of (P, N) and
//     walks the valid rows in 64-row tiles of (w_j X_j) and B_j.
// Tiles in shared memory are padded so that every fragment load is
// free of bank conflicts (row strides of 4 mod 32 words where a
// fragment reads along a row, 8 mod 32 where it reads down a column).
// Q x Q never leaves shared memory, nothing is carried between blocks
// and no atomics are used, so every run sums in the same order.  The
// cumsum is accumulated in f64 by one warp (each lane a run of rows,
// then a shuffle scan of the runs) and each prefix rounded to f32, as
// the plain version's `prefix_sum` does: at the model's decay seg
// reaches -500 in a chunk, where f32 accumulators of different orders
// drift apart by several ulp (6.1e-5 each) and L = exp(seg_i - seg_j)
// with them.  A row tile wholly past q_valid gets no block: the first
// state block of the chunk writes its zeros.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 64;              // rows (and keys) per tile
constexpr int kThreads = 256;       // 8 warps
constexpr int kMaxP = 128;          // Y columns a warp pair holds
constexpr int kLdM = kT + 4;        // M row stride (4 mod 32)
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
  int n_qt_last;                      // row tiles of the last chunk below
                                      // q_valid: only those get a block
  int Pp, Np;                         // P to a multiple of 16, N of 8
  int q_valid;                        // rows of the last chunk to compute
  long long x_sb, x_sc, x_sq, x_sh;
  long long t_sb, t_sc, t_sq, t_sh;
  long long a_sb, a_sc, a_sq, a_sh;
  long long b_sb, b_sc, b_sq, b_sh;
  long long c_sb, c_sc, c_sq, c_sh;
};

// ---- 3xTF32 on mma.sync.m16n8k8 -------------------------------------
// Fragments (PTX ISA, m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                    a3 (g + 8, t + 4);
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g);
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                    c3 (g + 8, 2t + 1).

// x = big + small for the 3xTF32 products.  The tensor core reads only
// the upper 19 bits (sign, exponent, 10 mantissa bits) of a .tf32
// operand, so big is x rounded to nearest with ties away, by integer
// arithmetic (what cvt.rna.tf32.f32 gives, at full rate instead of the
// conversion unit's), and small = x - big is exact in f32 and enters
// truncated: the error of a product is about 2^-21 of it.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA {
  uint32_t big[4], small[4];
  // A[r][k] = p[r * ld + k]: rows g, g + 8; columns t, t + 4
  __device__ __forceinline__ void rows(const float* p, int ld, int g,
                                       int t) {
    split(p[g * ld + t], big[0], small[0]);
    split(p[(g + 8) * ld + t], big[1], small[1]);
    split(p[g * ld + t + 4], big[2], small[2]);
    split(p[(g + 8) * ld + t + 4], big[3], small[3]);
  }
  // A[r][k] = p[k * ld + r] * w_k: the operand stored transposed, its
  // columns t and t + 4 scaled by w_t and w_t4
  __device__ __forceinline__ void cols(const float* p, int ld, int g, int t,
                                       float w_t, float w_t4) {
    split(p[t * ld + g] * w_t, big[0], small[0]);
    split(p[t * ld + g + 8] * w_t, big[1], small[1]);
    split(p[(t + 4) * ld + g] * w_t4, big[2], small[2]);
    split(p[(t + 4) * ld + g + 8] * w_t4, big[3], small[3]);
  }
};

struct FragB {
  uint32_t big[2], small[2];
  // B[k][n] = p[k * ld + n]: rows t, t + 4; column g
  __device__ __forceinline__ void rows(const float* p, int ld, int g,
                                       int t) {
    split(p[t * ld + g], big[0], small[0]);
    split(p[(t + 4) * ld + g], big[1], small[1]);
  }
  // B[k][n] = p[n * ld + k]: the operand stored transposed
  __device__ __forceinline__ void cols(const float* p, int ld, int g,
                                       int t) {
    split(p[g * ld + t], big[0], small[0]);
    split(p[g * ld + t + 4], big[1], small[1]);
  }
};

// 16 bytes from device to shared memory; zeros when !in (no read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// d += a b in 3xTF32 (the small terms first)
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.small, b.big);
  mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// rows r0 .. r0 + 63 of a (rows, width) operand with row stride `sr`
// into shared memory [kT][ld]; rows at or past `lim` and columns
// width .. wpad - 1 are zero.  The copies are cp.async of 16 bytes, all
// in flight at once (every row starts on 16 bytes: the wrapper checks),
// and the caller waits with cp_wait_all before its barrier.  width and
// wpad are multiples of 4.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long sr, int r0, int width,
                                      int wpad, int lim) {
  const int w4 = wpad >> 2;
  for (int e = threadIdx.x; e < kT * w4; e += kThreads) {
    const int r = e / w4, k = (e - r * w4) << 2;
    const int i = r0 + r;
    const bool in = i < lim && k < width;
    cp_async16(dst + r * ld + k, in ? src + i * sr + k : src, in);
  }
}

// seg[0 .. Q) = cumsum(da) in place, accumulated in f64 by warp 0
// (each lane a run of rows, then a shuffle scan of the runs) and each
// prefix rounded to f32; the caller synchronises before and after
__device__ __forceinline__ void prefix_sum(float* seg, int Q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  const int lo = min(Q, lane * per), hi = min(Q, lo + per);
  double run = 0.0;
  for (int i = lo; i < hi; ++i) run += (double)seg[i];
  for (int off = 1; off < 32; off <<= 1) {     // inclusive scan of runs
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

__device__ __forceinline__ void y_role(const Params& a, int qt, int bi,
                                       int ci, int h, int qv,
                                       const float* xb, const float* bb,
                                       const float* cb, float* seg,
                                       const float* dts, float* buf) {
  const int Q = a.Q, P = a.P, N = a.N, Pp = a.Pp, Np = a.Np;
  const int ldn = Np + 4, ldp = Pp + 8;
  float* cs = buf;                    // [kT][ldn] C rows of the tile
  float* bs = cs + kT * ldn;          // [kT][ldn] B rows of a key tile
  float* xs = bs + kT * ldn;          // [kT][ldp] X rows of a key tile
  float* ms = xs + kT * ldp;          // [kT][kLdM] M of the tile pair
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = w >> 1, wn = w & 1;  // rows 16 wm, S keys / Y cols half
  const int i0 = qt * kT;
  const int r_lo = i0 + 16 * wm;      // the warp's first and last row
  const int r_hi = r_lo + 15;
  const int nty = Pp / 16;            // Y n-tiles of the warp
  const int yc0 = wn * (Pp / 2);      // its first Y column
  // the C tile and the first key tile, in flight with dt and da
  stage(cs, ldn, cb, a.c_sq, i0, N, Np, qv);
  stage(bs, ldn, bb, a.b_sq, 0, N, Np, qv);
  stage(xs, ldp, xb, a.x_sq, 0, P, Pp, qv);
  cp_wait_all();
  __syncthreads();
  prefix_sum(seg, Q);

  float acc[kMaxP / 16][4];
#pragma unroll
  for (int j = 0; j < kMaxP / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j0 = 0; j0 <= i0 && j0 < qv; j0 += kT) {
    if (j0 > 0) {
      __syncthreads();        // the last key tile consumed
      stage(bs, ldn, bb, a.b_sq, j0, N, Np, qv);
      stage(xs, ldp, xb, a.x_sq, j0, P, Pp, qv);
      cp_wait_all();
    }
    __syncthreads();          // the scan done, this key tile staged

    // S = C B^T on the warp's 16 rows x keys j0 + 32 wn + 8 jn + (0..7);
    // an 8-key sub-tile is live when some row of the warp sees a key of
    // it (the same test as the k-steps of M X below)
    const int kw = j0 + 32 * wn;
    float s[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < Np; k0 += 8) {
      FragA fa;
      fa.rows(cs + 16 * wm * ldn + k0, ldn, g, t);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int key = kw + 8 * jn;
        if (key > r_hi || key >= qv || r_lo >= qv) continue;  // warp-uniform
        FragB fb;
        fb.cols(bs + (32 * wn + 8 * jn) * ldn + k0, ldn, g, t);
        mma3(s[jn], fa, fb);
      }
    }
    // M = S * L * dt_j, masked before the exponential
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int key = kw + 8 * jn;
      if (key > r_hi || key >= qv || r_lo >= qv) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r_lo + g + 8 * (e >> 1);
        const int j = key + 2 * t + (e & 1);
        float m = 0.f;
        if (i < qv && j <= i) m = s[jn][e] * expf(seg[i] - seg[j]) * dts[j];
        ms[(i - i0) * kLdM + (j - j0)] = m;
      }
    }
    __syncthreads();

    // Y += M X: the warp's 16 rows x columns yc0 + 8 jn + (0..7)
#pragma unroll
    for (int k0 = 0; k0 < kT; k0 += 8) {
      const int key = j0 + k0;
      if (key > r_hi || key >= qv || r_lo >= qv) break;  // warp-uniform
      FragA fa;
      fa.rows(ms + 16 * wm * kLdM + k0, kLdM, g, t);
#pragma unroll
      for (int jn = 0; jn < kMaxP / 16; ++jn) {
        if (jn >= nty) break;
        FragB fb;
        fb.rows(xs + k0 * ldp + yc0 + 8 * jn, ldp, g, t);
        mma3(acc[jn], fa, fb);
      }
    }
  }

#pragma unroll
  for (int jn = 0; jn < kMaxP / 16; ++jn) {
    if (jn >= nty) break;
    const int p = yc0 + 8 * jn + 2 * t;
    if (p >= P) continue;             // P is even: p + 1 < P as well
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r_lo + g + 8 * half;
      if (i >= Q) continue;
      const bool live = i < qv;       // padding rows: exact zeros
      float* yrow =
          a.y + ((((long long)bi * a.C + ci) * Q + i) * a.H + h) * P + p;
      *reinterpret_cast<float2*>(yrow) =
          make_float2(live ? acc[jn][2 * half] : 0.f,
                      live ? acc[jn][2 * half + 1] : 0.f);
    }
  }
}

__device__ __forceinline__ void state_role(const Params& a, int sr, int bi,
                                           int ci, int h, int qv,
                                           const float* xb, const float* bb,
                                           float* seg, float* w,
                                           float* buf) {
  const int Q = a.Q, P = a.P, N = a.N, Pp = a.Pp, Np = a.Np;
  const int ldp = Pp + 8, ldn = Np + 8;
  float* xs = buf;                    // [kT][ldp] X_j
  float* bs = xs + kT * ldp;          // [kT][ldn] B_j
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // the first row tile, in flight with dt and da
  stage(xs, ldp, xb, a.x_sq, 0, P, Pp, qv);
  stage(bs, ldn, bb, a.b_sq, 0, N, Np, qv);
  cp_wait_all();
  __syncthreads();
  prefix_sum(seg, Q);
  __syncthreads();
  // w_j = exp(seg_{Q-1} - seg_j) dt_j, in place of dt
  const float last = seg[Q - 1];
  for (int i = tid; i < Q; i += kThreads) w[i] = expf(last - seg[i]) * w[i];

  // this warp's 16 x 64 tile of the (P, N) state
  const int ng = (Np + 63) / 64;
  const int wt = sr * (kThreads / 32) + (tid >> 5);
  const bool live = wt < (Pp / 16) * ng;
  const int p0 = live ? 16 * (wt / ng) : 0;
  const int n0 = live ? 64 * (wt % ng) : 0;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j0 = 0; j0 < qv; j0 += kT) {
    if (j0 > 0) {
      __syncthreads();                // the last tile consumed
      stage(xs, ldp, xb, a.x_sq, j0, P, Pp, qv);
      stage(bs, ldn, bb, a.b_sq, j0, N, Np, qv);
      cp_wait_all();
    }
    __syncthreads();                  // w ready, this tile staged
    if (!live) continue;
#pragma unroll 2
    for (int k0 = 0; k0 < kT && j0 + k0 < qv; k0 += 8) {
      const int j = j0 + k0 + t;      // the fragment's rows j, j + 4
      FragA fa;                       // A[p][j] = w_j X[j][p]
      fa.cols(xs + k0 * ldp + p0, ldp, g, t, j < qv ? w[j] : 0.f,
              j + 4 < qv ? w[j + 4] : 0.f);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        if (n0 + 8 * jn >= Np) break;
        FragB fb;
        fb.rows(bs + k0 * ldn + n0 + 8 * jn, ldn, g, t);
        mma3(acc[jn], fa, fb);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const int n = n0 + 8 * jn + 2 * t;
    if (n >= N) continue;             // N is even: n + 1 < N as well
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + g + 8 * half;
      if (p >= P) continue;
      float* row =
          a.st + ((((long long)bi * a.C + ci) * a.H + h) * P + p) * N + n;
      *reinterpret_cast<float2*>(row) =
          make_float2(acc[jn][2 * half], acc[jn][2 * half + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(
    const Params a) {
  extern __shared__ float4 smem4[];   // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  // blocks of a batch row: (C - 1) chunks of H x (n_qt + n_st) roles,
  // then the last chunk's H x (n_qt_last + n_st)
  const int full = a.n_qt + a.n_st, last = a.n_qt_last + a.n_st;
  const long long head = (long long)(a.C - 1) * a.H * full;
  const long long per_b = head + (long long)a.H * last;
  const int bi = (int)(blockIdx.x / per_b);
  long long r = blockIdx.x % per_b;
  int ci, h, role, n_y;
  if (r < head) {
    ci = (int)(r / ((long long)a.H * full));
    r %= (long long)a.H * full;
    h = (int)(r / full), role = (int)(r % full), n_y = a.n_qt;
  } else {
    r -= head;
    ci = a.C - 1;
    h = (int)(r / last), role = (int)(r % last), n_y = a.n_qt_last;
  }
  const int Q = a.Q;
  const int qv = ci == a.C - 1 ? a.q_valid : Q;  // rows to compute
  if (role == n_y && n_y < a.n_qt) {  // the tiles of padding: y = 0
    const int i0 = n_y * kT, p4 = a.P / 4;
    float4* yb = reinterpret_cast<float4*>(
        a.y + ((((long long)bi * a.C + ci) * Q + i0) * a.H + h) * a.P);
    for (int e = threadIdx.x; e < (Q - i0) * p4; e += kThreads) {
      const int rr = e / p4;
      yb[(long long)rr * a.H * p4 + e - rr * p4] = make_float4(0, 0, 0, 0);
    }
  }

  const float* xb = a.x + bi * a.x_sb + ci * a.x_sc + h * a.x_sh;
  const float* tb = a.dt + bi * a.t_sb + ci * a.t_sc + h * a.t_sh;
  const float* ab = a.da + bi * a.a_sb + ci * a.a_sc + h * a.a_sh;
  const float* bb = a.b + bi * a.b_sb + ci * a.b_sc + h * a.b_sh;
  const float* cb = a.c + bi * a.c_sb + ci * a.c_sc + h * a.c_sh;

  float* seg = smem;                  // [Q] cumsum(da)
  float* dts = smem + Q;              // [Q] dt
  float* buf = smem + ((2 * Q + 3) & ~3);
  for (int i = threadIdx.x; i < Q; i += kThreads) {  // padding: 0
    cp_async4(dts + i, tb + (long long)i * a.t_sq, i < qv);
    cp_async4(seg + i, ab + (long long)i * a.a_sq, i < qv);
  }
  if (role < n_y)
    y_role(a, role, bi, ci, h, qv, xb, bb, cb, seg, dts, buf);
  else
    state_role(a, role - n_y, bi, ci, h, qv, xb, bb, seg, dts, buf);
}

long long smem_bytes(int Q, int Pp, int Np) {
  const long long y = 2LL * kT * (Np + 4) + (long long)kT * (Pp + 8) +
                      (long long)kT * kLdM;
  const long long st = (long long)kT * (Pp + 8) + (long long)kT * (Np + 8);
  return (((2LL * Q + 3) & ~3LL) + (y > st ? y : st)) *
         (long long)sizeof(float);
}

// the raised shared-memory limit, once per process
cudaError_t allow_smem() {
  static cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return err;
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
    int q_valid, void* stream) {
  if (B <= 0 || C <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 ||
      P > kMaxP || P % 4 != 0 || N % 4 != 0 || q_valid < 1 ||
      q_valid > Q)
    return (int)cudaErrorInvalidValue;
  Params a;
  a.x = static_cast<const float*>(x);
  a.dt = static_cast<const float*>(dt);
  a.da = static_cast<const float*>(da);
  a.b = static_cast<const float*>(b);
  a.c = static_cast<const float*>(c);
  a.y = static_cast<float*>(y);
  a.st = static_cast<float*>(st);
  a.C = C, a.Q = Q, a.H = H, a.P = P, a.N = N, a.q_valid = q_valid;
  a.Pp = (P + 15) / 16 * 16;
  a.Np = (N + 7) / 8 * 8;
  a.n_qt = (Q + kT - 1) / kT;
  a.n_qt_last = (q_valid + kT - 1) / kT;
  const int warp_tiles = (a.Pp / 16) * ((a.Np + 63) / 64);
  a.n_st = (warp_tiles + kThreads / 32 - 1) / (kThreads / 32);
  a.x_sb = x_sb, a.x_sc = x_sc, a.x_sq = x_sq, a.x_sh = x_sh;
  a.t_sb = t_sb, a.t_sc = t_sc, a.t_sq = t_sq, a.t_sh = t_sh;
  a.a_sb = a_sb, a.a_sc = a_sc, a.a_sq = a_sq, a.a_sh = a_sh;
  a.b_sb = b_sb, a.b_sc = b_sc, a.b_sq = b_sq, a.b_sh = b_sh;
  a.c_sb = c_sb, a.c_sc = c_sc, a.c_sq = c_sq, a.c_sh = c_sh;

  const long long smem = smem_bytes(Q, a.Pp, a.Np);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)B * H *
      ((long long)(C - 1) * (a.n_qt + a.n_st) + a.n_qt_last + a.n_st);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ssd_chunk_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The kernel's resources at chunk length Q, head dim P and state N:
// out[0] registers a thread, out[1] shared memory a block (bytes),
// out[2] blocks an SM can hold, out[3] local (spill) bytes a thread.
// Returns the cudaError_t.
extern "C" int repro_ssd_chunk_info(int Q, int P, int N, int* out) {
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, ssd_chunk_kernel);
  if (err != cudaSuccess) return (int)err;
  const long long smem =
      smem_bytes(Q, (P + 15) / 16 * 16, (N + 7) / 8 * 8);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, ssd_chunk_kernel, kThreads, (size_t)smem);
  out[0] = attr.numRegs;
  out[1] = (int)smem + (int)attr.sharedSizeBytes;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return (int)err;
}
