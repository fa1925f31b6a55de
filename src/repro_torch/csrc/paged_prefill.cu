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
//   ps), 0, maxp).  q, ck, cv and the pool's rows start on 16 bytes (the
//   wrapper checks), since they are copied in 16-byte pieces.
//
// Bound on the H100: bytes.  Each (lane, kv head) needs its history K/V
// rows (bf16) and the chunk's in-flight K/V rows (f32) once, plus q in
// and out once; the flops are 4 * hd per visible (query row, key).  The
// chunked serve's call (8 lanes x 12 heads x hd 64, 16-row chunks, at
// most one 16-slot history page a lane) moves 1.8 MB, 0.53 us at 3.35
// TB/s — below a launch and the dependent trips to memory, which set the
// time there; a 1008-token history moves 26 MB for 0.4 GFLOP, 7.8 us by
// bytes and 5.9 us in f32 on the CUDA cores.
//
// Design: stage the keys once for all the rows of a (lane, kv head) and
// multiply 16-row tiles on the CUDA cores in f32:
//   * grid (B * Hkv * ceil(C * G / 16), S), 128 threads; a block takes 16
//     rows (c, g) of one lane and kv head — the query heads of a group
//     share the staged keys — and one of S shares of the history pages
//     (S > 1 only for long histories: about 256 keys a block, up to 4
//     blocks an SM);
//   * q rows and the in-flight ck/cv rows (f32) are copied to shared
//     memory by 16-byte cp.async at once, beside the scalar loads (row
//     positions, chunk start, table entries); then a history split of
//     at most 64 slots (a short history) is staged as it is — K, V and
//     stored positions in one round trip, masked per row; a longer split
//     loads the positions of all its slots at once, lists those that
//     some row of the tile can see (`kpos < start`, causal, window
//     widened by the tile's spread of positions) and stages only those,
//     64 a tile, double-buffered;
//   * keys go to the warps in 16-key groups, in turn: the chunk's own
//     first, then each history tile's, so that the serve's chunk (one
//     group of each) runs on two warps side by side; each warp keeps its
//     own running (m, l, O) for the 16 rows;
//   * scores are a register-tiled f32 product: lane (g, t) of a warp
//     owns rows g and g + 8 and keys t, t + 4, t + 8, t + 12 of its
//     group, read as float4 (q, in-flight K) or 16-byte bf16 pieces
//     (history K) from rows padded by 16 bytes, so the 8 rows or 4 keys
//     of one read fall in different banks; the softmax runs once per
//     group, a row's max and sum over its 4 lanes by shuffles;
//   * O += P V: the 4 lanes of a row trade their P by shuffles, and each
//     owns 2 rows x hd / 4 columns (4 at 16 n + 4 t), reading V rows as
//     float4 or 8-byte bf16 pieces; V rows past a tile's keys, to a
//     multiple of 16, are zeros, so masked keys (P = 0) add exactly 0;
//   * the four warps' rows are merged in warp order: (m, l) through
//     shared memory, each warp's O scaled in registers and summed
//     through shared memory, written 16 bytes at a time; with S > 1 that
//     is the block's part, and the last block of the unit to finish (an
//     integer ticket) merges the S parts in order (`repro::merge_parts`),
//     with no second launch and no float atomics.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // rows (c, g) a block
constexpr int kTile = 64;      // history keys a staged tile, 16 a warp

template <int HD>
struct Layout {
  static constexpr int kLdF = HD + 4;           // padded f32 row
  static constexpr int kLdB = HD + 8;           // padded bf16 row
  static constexpr int kHist = 2 * kTile * kLdB;   // one K | V, bf16
  // bytes of dynamic shared memory for `ck` in-flight keys a tile and a
  // split of at most `keys` slots over `pages` pages; the warps' parts
  // reuse the history buffers once the keys are done
  static size_t bytes(int ck, int pages, int keys) {
    return sizeof(float) * ((size_t)kRows * kLdF + 2 * (size_t)ck * kLdF) +
           2 * sizeof(__nv_bfloat16) * (size_t)kHist +
           sizeof(int) * ((size_t)kRows + ck + pages + kTile +
                          2 * (size_t)keys + 4 * kWarps + 1);
  }
  static_assert(2 * sizeof(__nv_bfloat16) * kHist >=
                    sizeof(float) * kWarps * kRows * (HD + 2),
                "the warps' parts fit in the history buffers");
};

// 8 consecutive elements of a staged row as f32 (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
  f[4] = y.x, f[5] = y.y, f[6] = y.z, f[7] = y.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// 4 consecutive elements as f32 (16-byte aligned f32, 8-byte bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// A lane's share of its warp's running softmax: rows g and g + 8 (g =
// lane / 4) of the 16, O over columns 16 n + 4 t .. + 3 (t = lane % 4).
template <int HD>
struct WarpRows {
  float4 o[2][HD / 16];
  float m[2], l[2];
  int qp[2];
};

// Keys k0 .. k0 + 15 of a staged tile of `cnt` keys (K rows of stride
// ldk, V rows of stride ldv, stored positions kpos; a key is seen by a
// row at qp when `kpos < lt && key_visible(kpos, qp, window)`) folded
// into the warp's rows, q read from q_s (rows of stride kLdF).  T is
// __nv_bfloat16 (history) or float (in-flight).  V rows from cnt to the
// next multiple of 16 are zero.
template <int HD, typename T>
__device__ __forceinline__ void attend16(WarpRows<HD>& w, const float* q_s,
                                         const T* ks, int ldk, const T* vs,
                                         int ldv, int k0, int cnt,
                                         const int* kpos, int lt, int window,
                                         float scale) {
  constexpr int kLdF = Layout<HD>::kLdF;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // S = Q K^T: s[r][j] for row g + 8 r and key k0 + t + 4 j
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const float* q0 = q_s + g * kLdF;
  const T* k_lane = ks + (k0 + t) * ldk;
#pragma unroll 2
  for (int d = 0; d < HD; d += 8) {
    float qv[2][8];
    load8(q0 + d, qv[0]);
    load8(q0 + 8 * kLdF + d, qv[1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float kf[8];
      load8(k_lane + 4 * j * ldk + d, kf);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) s[r][j] = fmaf(qv[r][e], kf[e], s[r][j]);
    }
  }

  // online softmax over the 16 keys; the four lanes of a row reduce
  unsigned vis = 0u;
  float mt[2] = {repro::kNegInf, repro::kNegInf};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + t + 4 * j;
    const int kp = key < cnt ? kpos[key] : -1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = kp < lt &&
                      repro::key_visible(kp, w.qp[r], window);
      vis |= (unsigned)ok << (4 * r + j);
      s[r][j] = ok ? s[r][j] * scale : repro::kNegInf;
      mt[r] = fmaxf(mt[r], s[r][j]);
    }
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(w.m[r], mt[r]);
    alpha[r] = expf(w.m[r] - m_new);
    w.m[r] = m_new;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p =
          (vis >> (4 * r + j)) & 1u ? expf(s[r][j] - m_new) : 0.f;
      s[r][j] = p;
      sum[r] += p;
    }
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    w.l[r] = w.l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      w.o[r][n].x *= alpha[r];
      w.o[r][n].y *= alpha[r];
      w.o[r][n].z *= alpha[r];
      w.o[r][n].w *= alpha[r];
    }
  }

  // O += P V: key k0 + u + 4 j's P sits in lane (g, u) as s[r][j]
  const int base = lane & ~3;
  const T* v_lane = vs + k0 * ldv + 4 * t;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int u = kk & 3, j = kk >> 2;
    const float p0 = __shfl_sync(0xffffffffu, s[0][j], base | u);
    const float p1 = __shfl_sync(0xffffffffu, s[1][j], base | u);
    const T* vr = v_lane + (u + 4 * j) * ldv;
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      const float4 v = load4(vr + 16 * n);
      w.o[0][n].x = fmaf(p0, v.x, w.o[0][n].x);
      w.o[0][n].y = fmaf(p0, v.y, w.o[0][n].y);
      w.o[0][n].z = fmaf(p0, v.z, w.o[0][n].z);
      w.o[0][n].w = fmaf(p0, v.w, w.o[0][n].w);
      w.o[1][n].x = fmaf(p1, v.x, w.o[1][n].x);
      w.o[1][n].y = fmaf(p1, v.y, w.o[1][n].y);
      w.o[1][n].z = fmaf(p1, v.z, w.o[1][n].z);
      w.o[1][n].w = fmaf(p1, v.w, w.o[1][n].w);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const float* __restrict__ q, const int* __restrict__ q_pos,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ pos_pages, const int* __restrict__ page_table,
    const int* __restrict__ chunk_start, const float* __restrict__ ck,
    const float* __restrict__ cv, const int* __restrict__ c_pos,
    float* __restrict__ out, float* __restrict__ part,
    int* __restrict__ tickets, int C, int H, int Hkv, int ps, int maxp,
    int n_rt, int ck_tile, int pages_max, long long k_sp, long long k_ss,
    long long k_sh, long long v_sp, long long v_ss, long long v_sh,
    long long pos_sp, long long pos_ss, float scale, int window) {
  using L = Layout<HD>;
  const int S = gridDim.y, split = blockIdx.y;
  const int unit = blockIdx.x;
  const int rt = unit % n_rt;
  const int kvh = (unit / n_rt) % Hkv;
  const int b = unit / n_rt / Hkv;
  const int G = H / Hkv;
  const int n_rows = C * G;                     // rows (c, g) of the unit
  const int r0 = rt * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);          // [kRows][kLdF]
  float* ck_s = q_s + kRows * L::kLdF;                   // [ck_tile][kLdF]
  float* cv_s = ck_s + ck_tile * L::kLdF;                // [ck_tile][kLdF]
  auto* hist = reinterpret_cast<__nv_bfloat16*>(cv_s + ck_tile * L::kLdF);
  int* qpos_s = reinterpret_cast<int*>(hist + 2 * L::kHist);   // [kRows]
  int* cpos_s = qpos_s + kRows;                          // [ck_tile]
  int* tab = cpos_s + ck_tile;                           // [pages_max]
  int* fk = tab + pages_max;                             // [kTile]
  int* list = fk + kTile;                                // [pages_max ps]
  int* kpos_l = list + pages_max * ps;                   // [pages_max ps]
  int* cnt = kpos_l + pages_max * ps;                    // [4 warps + 1]

  // the in-flight keys t0 .. t0 + ck_tile - 1 (f32) and their positions;
  // V rows past the chunk, to a multiple of 16, are zeros
  auto stage_inflight = [&](int t0) {
    constexpr int kC = HD / 4;
    const int rows = min(ck_tile, C - t0);
    const int padded = min(ck_tile, (rows + 15) & ~15);
    for (int e = tid; e < (rows + padded) * kC; e += kThreads) {
      const bool is_v = e >= rows * kC;
      const int f = is_v ? e - rows * kC : e;
      const int r = f / kC, c = (f - r * kC) * 4;
      const bool in = r < rows;
      const long long off =
          (((long long)b * C + t0 + (in ? r : 0)) * Hkv + kvh) * HD + c;
      if (is_v)
        repro::cp_async16(cv_s + r * L::kLdF + c, cv + off, in);
      else
        repro::cp_async16(ck_s + r * L::kLdF + c, ck + off);
    }
    for (int r = tid; r < rows; r += kThreads)
      cpos_s[r] = c_pos[(long long)b * C + t0 + r];
    return rows;
  };

  // q rows of the tile, zeros past the unit's rows
  {
    constexpr int kC = HD / 4;
    for (int e = tid; e < kRows * kC; e += kThreads) {
      const int row = e / kC, c = (e - row * kC) * 4;
      const int r = r0 + row;
      const bool in = r < n_rows;
      const float* src =
          in ? q + (((long long)b * C + r / G) * H + kvh * G + r % G) * HD + c
             : q;
      repro::cp_async16(q_s + row * L::kLdF + c, src, in);
    }
  }
  const int n_in = split == 0 ? stage_inflight(0) : 0;
  repro::cp_commit();
  if (tid < kRows) {
    const int r = r0 + tid;
    qpos_s[tid] = r < n_rows ? q_pos[(long long)b * C + r / G] : -1;
  }
  // split `split` takes history columns j0 .. j0 + pages_max - 1
  const int j0 = split * pages_max;
  const int n_cols = max(0, min(pages_max, maxp - j0));
  for (int j = tid; j < n_cols; j += kThreads)
    tab[j] = page_table[(long long)b * maxp + j0 + j];
  const int start = chunk_start[b];
  const int n_hist = start <= 0 ? 0 : min((start + ps - 1) / ps, maxp);
  __syncthreads();

  WarpRows<HD> w;
  w.qp[0] = qpos_s[g];
  w.qp[1] = qpos_s[g + 8];
  int q_lo = INT_MAX, q_hi = -1;
  for (int r = 0; r < kRows; ++r) {
    const int p = qpos_s[r];
    if (p >= 0) {
      q_lo = min(q_lo, p);
      q_hi = max(q_hi, p);
    }
  }
  // The history: a split of at most 64 slots (a short history) is one
  // tile staged as it is, K, V and stored positions copied together
  // (masked slots are masked per row): one round trip after the table.
  // A longer split lists, from their positions, the slots that some row
  // of the tile can see (visible to its last row in a window widened by
  // the tile's spread of positions) and stages only those, 64 a tile.
  const int n_pages = q_hi < 0 ? 0 : max(0, min(n_hist - j0, n_cols));
  const int n_keys = n_pages * ps;
  const int n_raw = n_keys <= kTile ? n_keys : 0;  // the raw tile's slots
  const int n_lst = n_raw > 0 ? 1 : 0;          // list tiles start here
  int n = 0;                                    // listed slots after those
  const __nv_bfloat16* kb = k_pages + kvh * k_sh;
  const __nv_bfloat16* vb = v_pages + kvh * v_sh;
  // history tile tt into buffer `buf`; V rows past its keys, to a
  // multiple of 16, are zeros
  auto stage_hist = [&](int tt, int buf) {
    constexpr int kC = HD / 8;
    __nv_bfloat16* ks = hist + buf * L::kHist;
    __nv_bfloat16* vs = ks + kTile * L::kLdB;
    const int rows =
        tt < n_lst ? n_raw : min(kTile, n - (tt - n_lst) * kTile);
    const int padded = min(kTile, (rows + 15) & ~15);
    for (int e = tid; e < (rows + padded) * kC; e += kThreads) {
      const bool is_v = e >= rows * kC;
      const int f = is_v ? e - rows * kC : e;
      const int r = f / kC, c = (f - r * kC) * 8;
      const bool in = r < rows;
      const int idx = tt < n_lst ? (in ? r : 0)
                                 : list[(tt - n_lst) * kTile + (in ? r : 0)];
      const int j = idx / ps, s = idx - j * ps;
      const long long page = tab[j];
      if (is_v)
        repro::cp_async16(vs + r * L::kLdB + c,
                          vb + page * v_sp + s * v_ss + c, in);
      else
        repro::cp_async16(ks + r * L::kLdB + c,
                          kb + page * k_sp + s * k_ss + c);
    }
    if (tt < n_lst)
      for (int r = tid; r < rows; r += kThreads) {
        const int j = r / ps, s = r - j * ps;
        repro::cp_async4(fk + r, pos_pages + (long long)tab[j] * pos_sp +
                                     s * pos_ss);
      }
  };
  if (n_raw > 0) {
    stage_hist(0, 0);
    repro::cp_commit();
  }
  const int wide = window > 0 ? window + (q_hi - q_lo) : window;
  n = repro::gather_visible<kThreads>(
      tab, n_raw, n_keys, ps, pos_pages, pos_sp, pos_ss, q_hi, wide, start,
      list, kpos_l, cnt);
  const int n_tiles = n_lst + (n + kTile - 1) / kTile;
  if (n_lst == 0 && n_tiles > 0) {
    stage_hist(0, 0);
    repro::cp_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    w.m[r] = repro::kNegInf;
    w.l[r] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < HD / 16; ++n)
      w.o[r][n] = make_float4(0.f, 0.f, 0.f, 0.f);

  // The keys in 16-key groups, warp by warp in turn: first the chunk's
  // own (split 0), then each history tile's, so that with one group of
  // each (the serve's chunks) two warps take them side by side.
  const int n_own = split == 0 ? (n_in + 15) / 16 : 0;
  const int n_iter = max(n_tiles, 1);
  for (int tt = 0; tt < n_iter; ++tt) {
    __syncthreads();                            // buffer (tt + 1) & 1 free
    if (tt + 1 < n_tiles) {
      stage_hist(tt + 1, (tt + 1) & 1);
      repro::cp_commit();
      repro::cp_wait<1>();
    } else {
      repro::cp_wait<0>();
    }
    __syncthreads();
    if (tt == 0) {
      for (int j = warp; j < n_own; j += kWarps)
        attend16<HD>(w, q_s, ck_s, L::kLdF, cv_s, L::kLdF, 16 * j, n_in,
                     cpos_s, INT_MAX, window, scale);
    }
    if (tt < n_tiles) {
      const __nv_bfloat16* ks = hist + (tt & 1) * L::kHist;
      const int rows =
          tt < n_lst ? n_raw : min(kTile, n - (tt - n_lst) * kTile);
      const int* kp = tt < n_lst ? fk : kpos_l + (tt - n_lst) * kTile;
      for (int j = (warp - n_own) & (kWarps - 1); 16 * j < rows;
           j += kWarps)
        attend16<HD>(w, q_s, ks, L::kLdB, ks + kTile * L::kLdB, L::kLdB,
                     16 * j, rows, kp, start, window, scale);
    }
  }
  // the chunk's keys past its first staged tile (chunks over 64 rows)
  for (int c0 = ck_tile; split == 0 && c0 < C; c0 += ck_tile) {
    __syncthreads();
    const int rows = stage_inflight(c0);
    repro::cp_commit();
    repro::cp_wait<0>();
    __syncthreads();
    for (int j = warp; 16 * j < rows; j += kWarps)
      attend16<HD>(w, q_s, ck_s, L::kLdF, cv_s, L::kLdF, 16 * j, rows,
                   cpos_s, INT_MAX, window, scale);
  }

  // The four warps' rows merged in warp order: (m, l) through shared
  // memory, each warp's O scaled in registers, then summed through
  // shared memory (the history buffers, free now) and written 16 bytes
  // at a time.
  __syncthreads();
  float* wml = reinterpret_cast<float*>(hist);           // [4][16][2]
  float* wacc = wml + kWarps * kRows * 2;                // [4][16][HD]
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wml[2 * (warp * kRows + g + 8 * r)] = w.m[r];
      wml[2 * (warp * kRows + g + 8 * r) + 1] = w.l[r];
    }
  }
  __syncthreads();
  // with S > 1 the block's part: sums relative to the rows' M, and (M, L)
  float* gacc = part + (long long)unit * S * kRows * HD;        // [S][16][HD]
  float* gml = part + (long long)gridDim.x * S * kRows * HD +
               (long long)unit * S * kRows * 2;                 // [S][16][2]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float m = repro::kNegInf, l = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) m = fmaxf(m, wml[2 * (v * kRows + row)]);
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      l += wml[2 * (v * kRows + row) + 1] *
           expf(wml[2 * (v * kRows + row)] - m);
    float f = expf(w.m[r] - m);
    if (S == 1) f /= fmaxf(l, 1e-30f);
    else if (warp == 0 && t == 0) {
      gml[2 * (split * kRows + row)] = m;
      gml[2 * (split * kRows + row) + 1] = l;
    }
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      const float4 o = w.o[r][n];
      *reinterpret_cast<float4*>(wacc + (warp * kRows + row) * HD + 16 * n +
                                 4 * t) =
          make_float4(o.x * f, o.y * f, o.z * f, o.w * f);
    }
  }
  __syncthreads();
  auto out_row = [&](int row) -> float* {
    const int r = r0 + row;
    if (r >= n_rows) return nullptr;
    return out + (((long long)b * C + r / G) * H + kvh * G + r % G) * HD;
  };
  {
    constexpr int kPer = kRows * HD / kThreads;   // contiguous, one row
    const int e0 = tid * kPer, row = e0 / HD, d0 = e0 - row * HD;
    float4 v[kPer / 4];
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      v[i] = *reinterpret_cast<const float4*>(wacc + e0 + 4 * i);
#pragma unroll
      for (int u = 1; u < kWarps; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(
            wacc + u * kRows * HD + e0 + 4 * i);
        v[i].x += x.x;
        v[i].y += x.y;
        v[i].z += x.z;
        v[i].w += x.w;
      }
    }
    float* o = S == 1 ? out_row(row)
                      : gacc + ((long long)split * kRows + row) * HD;
    if (o != nullptr) {
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i)
        *reinterpret_cast<float4*>(o + d0 + 4 * i) = v[i];
    }
  }
  if (S == 1 || !repro::last_of_splits(tickets + unit, S, cnt)) return;
  repro::merge_parts<HD, kThreads>(gacc, gml, S, kRows, out_row);
}

// the raised shared-memory limit of each instance, once per process
template <int HD>
cudaError_t allow_smem() {
  static cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      232448);
  return err;
}

struct Args {
  const float* q;
  const int* q_pos;
  const __nv_bfloat16 *k, *v;
  const int *pos, *table, *start;
  const float *ck, *cv;
  const int* c_pos;
  float *out, *part;
  int* tickets;
  int B, C, H, Hkv, ps, maxp, S;
  long long k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, pos_sp, pos_ss;
  float scale;
  int window;
};

// in-flight keys a staged tile: C rounded up to 16, at most 64
int ck_tile(int C) { return C >= kTile ? kTile : (C + 15) / 16 * 16; }

template <int HD>
size_t smem(int C, int maxp, int ps, int S) {
  const int pages = (maxp + S - 1) / S;
  return Layout<HD>::bytes(ck_tile(C), pages, pages * ps);
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return (int)err;
  const int n_rt = (a.C * (a.H / a.Hkv) + kRows - 1) / kRows;
  const long long units = (long long)a.B * a.Hkv * n_rt;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = smem<HD>(a.C, a.maxp, a.ps, a.S);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  paged_prefill_kernel<HD>
      <<<dim3((unsigned)units, a.S), kThreads, bytes, stream>>>(
          a.q, a.q_pos, a.k, a.v, a.pos, a.table, a.start, a.ck, a.cv,
          a.c_pos, a.out, a.part, a.tickets, a.C, a.H, a.Hkv, a.ps, a.maxp,
          n_rt, ck_tile(a.C), (a.maxp + a.S - 1) / a.S, a.k_sp, a.k_ss,
          a.k_sh, a.v_sp, a.v_ss, a.v_sh, a.pos_sp, a.pos_ss, a.scale,
          a.window);
  return (int)cudaGetLastError();
}

template <int HD>
int info(int C, int maxp, int ps, int S, int* out) {
  cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, paged_prefill_kernel<HD>);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = smem<HD>(C, maxp, ps, S);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, paged_prefill_kernel<HD>, kThreads, bytes);
  out[0] = fa.numRegs;
  out[1] = (int)(bytes + fa.sharedSizeBytes);
  out[2] = blocks;
  out[3] = (int)fa.localSizeBytes;
  return (int)err;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  hd must be 32,
// 64, 96 or 128, H a multiple of Hkv with H / Hkv <= 32, 1 <= S <= 65535
// splits of each lane's history pages, B * Hkv * ceil(C * G / 16) <
// 2^31 and the shared memory within 227 KB; with S > 1, `part` holds
// B * Hkv * ceil(C * G / 16) * S * 16 * (hd + 2) floats of scratch
// and `tickets` B * Hkv * ceil(C * G / 16) ints that are zero (and are
// left zero).
extern "C" int repro_paged_prefill(
    const void* q, const void* q_pos, const void* k_pages,
    const void* v_pages, const void* pos_pages, const void* page_table,
    const void* chunk_start, const void* ck, const void* cv,
    const void* c_pos, void* out, void* part, void* tickets, int B, int C,
    int H, int Hkv, int hd, int ps, int maxp, int S, long long k_sp,
    long long k_ss, long long k_sh, long long v_sp, long long v_ss,
    long long v_sh, long long pos_sp, long long pos_ss, float scale,
    int window, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > 32 || B <= 0 || C <= 0 ||
      ps <= 0 || maxp <= 0 || S < 1 || S > 65535 ||
      (S > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q),
               static_cast<const int*>(q_pos),
               static_cast<const __nv_bfloat16*>(k_pages),
               static_cast<const __nv_bfloat16*>(v_pages),
               static_cast<const int*>(pos_pages),
               static_cast<const int*>(page_table),
               static_cast<const int*>(chunk_start),
               static_cast<const float*>(ck),
               static_cast<const float*>(cv),
               static_cast<const int*>(c_pos),
               static_cast<float*>(out),
               static_cast<float*>(part),
               static_cast<int*>(tickets),
               B, C, H, Hkv, ps, maxp, S, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh,
               pos_sp, pos_ss, scale, window};
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(a, st);
    case 64: return launch<64>(a, st);
    case 96: return launch<96>(a, st);
    case 128: return launch<128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The kernel's resources for a C-row chunk and S splits of maxp history
// pages of ps slots: out[0] registers a thread, out[1] shared memory a
// block (bytes), out[2] blocks an SM can hold, out[3] local memory a
// thread (bytes, spills).  Returns the cudaError_t.
extern "C" int repro_paged_prefill_info(int hd, int C, int maxp, int ps,
                                        int S, int* out) {
  switch (hd) {
    case 32: return info<32>(C, maxp, ps, S, out);
    case 64: return info<64>(C, maxp, ps, S, out);
    case 96: return info<96>(C, maxp, ps, S, out);
    case 128: return info<128>(C, maxp, ps, S, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
