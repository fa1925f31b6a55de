// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_kernel`
// (src/repro/kernels/paged_attention.py): one query token per lane
// attends over the lane's page-table slice of the global bf16 KV pool,
// with an f32 softmax over the visited pages.
//
// Contract (the plain PyTorch version in
// repro_torch/kernels/paged_attention.py computes the same):
//   q (B, H, hd) f32 contiguous, H = G * Hkv;
//   k/v pool (P, ps, Hkv, hd) bf16 in the model's layout, read through
//     its strides (page, slot, head; hd contiguous) — never transposed
//     or padded; rows start on 16 bytes (the wrapper checks), since
//     they are copied in 16-byte pieces;
//   pos (P, ps) i32, -1 = empty slot; table (B, maxp) i32; q_pos (B,) i32;
//   out (B, H, hd) f32.  A lane visits pages j < min(q_pos // ps + 1,
//   maxp); a key is visible when its stored position is >= 0, <= q_pos
//   and inside the sliding window (window <= 0: none).  A lane that sees
//   no visible key writes zeros.
//
// Bound on the H100: bytes.  Each visible K and V row is needed once
// (2 * hd bf16 values a key and kv head) for 4 * hd flops per query
// head: about one flop a byte, far under the tensor cores' ridge, so the
// least time is the visible K/V bytes over 3.35 TB/s — 0.3 us for the
// chunked serve's decode (8 lanes x 12 heads x hd 64, at most 48 keys a
// lane), 7.4 us for 1024-token histories.  At the serve's size that is
// far below a launch and a few dependent trips to memory, so latency,
// not bandwidth, sets the time there.  So the design keeps a tile's
// keys in flight and the dependent trips few:
//   * grid (B, Hkv, S), 128 threads; a block takes one lane's pages for
//     one kv head, and the G query heads of the group share what it
//     stages.  S splits the lane's pages over blocks (flash-decoding)
//     when the context is long: the wrapper picks it from maxp, about
//     128 keys a block and up to 8 blocks an SM; the serve's 8-page
//     tables take S = 1;
//   * the block reads q_pos, its table entries and q together; then a
//     split of at most 64 slots (a short context) is staged as it is —
//     K, V (16-byte cp.async) and stored positions (4-byte cp.async) in
//     one round trip, masked slots masked in the scores; a longer split
//     loads the positions of all its slots at once, lists the visible
//     ones (a ballot per warp) and stages only those, 64 a tile, so a
//     masked slot costs no K/V bytes and no arithmetic;
//   * tiles are double-buffered, the next loading while this one is
//     used; K rows are padded by 16 bytes so a warp reading 8 rows at
//     one column hits 8 different bank groups;
//   * a tile's G x 64 scores are computed at once (a thread a (head,
//     key) pair), its max and sum taken once per head with shuffles,
//     then P.V accumulated from shared memory, each thread owning
//     column pairs of a head (and, when G * hd / 2 < 128, a share of
//     the keys, summed in a fixed order at the end);
//   * with S > 1 each block leaves (m, l, unnormalised sum) per head;
//     the last block of a (lane, kv head) to finish, by an integer
//     ticket, merges them in split order (`repro::merge_parts`): no
//     second launch and no float atomics, and a split that saw nothing
//     adds nothing, so an all-masked lane still writes exact zeros.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;      // keys a staged tile

template <int HD>
struct Layout {
  static constexpr int kLdK = HD + 8;           // padded K row (bf16)
  static constexpr int kBuf = kTile * (kLdK + HD);   // K | V, bf16
  static constexpr int kMaxR = HD / 8;          // column pairs a thread
  // bytes of dynamic shared memory for G heads and a split of at most
  // `keys` slots over `pages` pages
  static size_t bytes(int G, int pages, int keys) {
    return 2 * sizeof(__nv_bfloat16) * (size_t)kBuf +
           sizeof(float) * ((size_t)G * HD + (size_t)G * kTile + 3 * G +
                            2 * kThreads) +
           sizeof(int) * ((size_t)pages + kTile + keys + 4 * (kThreads / 32) +
                          1);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ pos_pages, const int* __restrict__ page_table,
    const int* __restrict__ q_pos, float* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int H, int Hkv,
    int ps, int maxp, int S, int pages_max, long long k_sp, long long k_ss,
    long long k_sh, long long v_sp, long long v_ss, long long v_sh,
    long long pos_sp, long long pos_ss, float scale, int window) {
  using L = Layout<HD>;
  constexpr int kChunks = HD / 8;               // 16-byte pieces a row
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float4 smem4[];
  auto* kv = reinterpret_cast<__nv_bfloat16*>(smem4);   // [2][K | V]
  float* q_s = reinterpret_cast<float*>(kv + 2 * L::kBuf);   // [G][HD]
  float* sc = q_s + G * HD;                     // [G][kTile]
  float* m_s = sc + G * kTile;                  // [G] running max
  float* l_s = m_s + G;                         // [G] running sum
  float* a_s = l_s + G;                         // [G] this tile's rescale
  float* red = a_s + G;                         // [2 * kThreads]
  int* tab = reinterpret_cast<int*>(red + 2 * kThreads);  // [pages_max]
  int* fk = tab + pages_max;                    // [kTile] tile 0's positions
  int* list = fk + kTile;                       // [pages_max * ps]
  int* cnt = list + pages_max * ps;             // [4 * warps + 1]

  // split `split` takes table columns j0 .. j0 + pages_max - 1; their
  // entries load beside q_pos, not after it
  const int j0 = split * pages_max;
  const int n_cols = max(0, min(pages_max, maxp - j0));
  const float* qb = q + ((long long)b * H + kvh * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) q_s[i] = qb[i];
  for (int j = tid; j < n_cols; j += kThreads)
    tab[j] = page_table[(long long)b * maxp + j0 + j];
  const int qp = q_pos[b];
  // floor division: a lane at position -1 visits no page
  const int n_used = qp < 0 ? 0 : min(qp / ps + 1, maxp);
  const int n_pages = max(0, min(n_used - j0, n_cols));
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = repro::kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  // A split of at most 64 slots (a short context) is one tile staged as
  // it is, K, V and stored positions copied together (masked slots are
  // masked in the scores): one round trip after the table.  A longer
  // split lists its visible slots from their positions first and
  // stages only those, 64 a tile.
  const int n_keys = n_pages * ps;
  const int n_raw = n_keys <= kTile ? n_keys : 0;  // the raw tile's slots
  const int n_lst = n_raw > 0 ? 1 : 0;          // list tiles start here
  int n = 0;                                    // listed slots after those
  const __nv_bfloat16* kb = k_pages + kvh * k_sh;
  const __nv_bfloat16* vb = v_pages + kvh * v_sh;
  auto stage = [&](int t, int buf) {
    __nv_bfloat16* ks = kv + buf * L::kBuf;
    __nv_bfloat16* vs = ks + kTile * L::kLdK;
    const int rows = t < n_lst ? n_raw : min(kTile, n - (t - n_lst) * kTile);
    for (int e = tid; e < 2 * rows * kChunks; e += kThreads) {
      const bool is_v = e >= rows * kChunks;
      const int f = is_v ? e - rows * kChunks : e;
      const int r = f / kChunks, c = (f - r * kChunks) * 8;
      const int idx = t < n_lst ? r : list[(t - n_lst) * kTile + r];
      const int j = idx / ps, s = idx - j * ps;
      const long long page = tab[j];
      if (is_v)
        repro::cp_async16(vs + r * HD + c, vb + page * v_sp + s * v_ss + c);
      else
        repro::cp_async16(ks + r * L::kLdK + c,
                          kb + page * k_sp + s * k_ss + c);
    }
    if (t < n_lst)
      for (int r = tid; r < rows; r += kThreads) {
        const int j = r / ps, s = r - j * ps;
        repro::cp_async4(fk + r, pos_pages + (long long)tab[j] * pos_sp +
                                     s * pos_ss);
      }
  };
  if (n_raw > 0) {
    stage(0, 0);
    repro::cp_commit();
  }
  n = repro::gather_visible<kThreads>(
      tab, n_raw, n_keys, ps, pos_pages, pos_sp, pos_ss, qp, window, INT_MAX,
      list, nullptr, cnt);

  // P.V work: item -> (column pair of a head, share of the keys)
  const int own = G * HD / 2;
  const int KS = own >= kThreads ? 1 : kThreads / own;
  const int R = (own * KS + kThreads - 1) / kThreads;
  float acc[L::kMaxR][2];
#pragma unroll
  for (int r = 0; r < L::kMaxR; ++r) acc[r][0] = acc[r][1] = 0.f;

  const int n_tiles = n_lst + (n + kTile - 1) / kTile;
  if (n_lst == 0 && n_tiles > 0) {
    stage(0, 0);
    repro::cp_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int cnt_t = t < n_lst ? n_raw : min(kTile, n - (t - n_lst) * kTile);
    if (t + 1 < n_tiles) {                      // the next tile, meanwhile
      stage(t + 1, (t + 1) & 1);
      repro::cp_commit();
      repro::cp_wait<1>();
    } else {
      repro::cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv + (t & 1) * L::kBuf;
    const __nv_bfloat16* vs = ks + kTile * L::kLdK;

    // scores: a thread a (head, key) pair, neighbouring threads on
    // neighbouring keys
    for (int p = tid; p < G * kTile; p += kThreads) {
      const int g = p / kTile, k = p - g * kTile;
      float s = repro::kNegInf;
      if (k < cnt_t &&
          (t >= n_lst || repro::key_visible(fk[k], qp, window))) {
        const float* qg = q_s + g * HD;
        const __nv_bfloat16* kr = ks + k * L::kLdK;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int c = 0; c < HD; c += 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
          const auto* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float4 qa = *reinterpret_cast<const float4*>(qg + c);
          const float4 qc = *reinterpret_cast<const float4*>(qg + c + 4);
          const float2 f0 = __bfloat1622float2(k2[0]);
          const float2 f1 = __bfloat1622float2(k2[1]);
          const float2 f2 = __bfloat1622float2(k2[2]);
          const float2 f3 = __bfloat1622float2(k2[3]);
          d0 = fmaf(qa.x, f0.x, d0);
          d1 = fmaf(qa.y, f0.y, d1);
          d0 = fmaf(qa.z, f1.x, d0);
          d1 = fmaf(qa.w, f1.y, d1);
          d0 = fmaf(qc.x, f2.x, d0);
          d1 = fmaf(qc.y, f2.y, d1);
          d0 = fmaf(qc.z, f3.x, d0);
          d1 = fmaf(qc.w, f3.y, d1);
        }
        s = (d0 + d1) * scale;
      }
      sc[p] = s;
    }
    __syncthreads();

    // the tile's max and sum, once per head
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sg = sc + g * kTile;
      const float s0 = sg[lane], s1 = sg[lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      // masked keys hold exactly kNegInf
      const float p0 = s0 == repro::kNegInf ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == repro::kNegInf ? 0.f : expf(s1 - m_new);
      sg[lane] = p0;
      sg[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // O += P V from shared memory
#pragma unroll
    for (int r = 0; r < L::kMaxR; ++r) {
      const int item = tid + r * kThreads;
      if (r >= R || item >= own * KS) break;
      const int pair = item % own, kk = item / own;
      const int g = pair / (HD / 2), c = (pair - g * (HD / 2)) * 2;
      const float alpha = a_s[g];
      float a0 = acc[r][0] * alpha, a1 = acc[r][1] * alpha;
      const float* pg = sc + g * kTile;
      for (int k = kk; k < cnt_t; k += KS) {
        const float p = pg[k];
        const float2 v2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vs + k * HD + c));
        a0 = fmaf(p, v2.x, a0);
        a1 = fmaf(p, v2.y, a1);
      }
      acc[r][0] = a0;
      acc[r][1] = a1;
    }
    __syncthreads();                            // this buffer consumed
  }

  // key shares of a column pair, summed in share order
  if (KS > 1) {
    if (tid < own * KS) {
      red[2 * tid] = acc[0][0];
      red[2 * tid + 1] = acc[0][1];
    }
    __syncthreads();
    if (tid < own) {
      float a0 = 0.f, a1 = 0.f;
      for (int kk = 0; kk < KS; ++kk) {
        a0 += red[2 * (tid + kk * own)];
        a1 += red[2 * (tid + kk * own) + 1];
      }
      acc[0][0] = a0;
      acc[0][1] = a1;
    }
  }
  const int n_own = KS > 1 ? (tid < own ? 1 : 0) : R;
  float* ob = out + ((long long)b * H + kvh * G) * HD;
  if (S == 1) {
#pragma unroll
    for (int r = 0; r < L::kMaxR; ++r) {
      const int pair = tid + r * kThreads;
      if (r >= n_own || pair >= own) break;
      const int g = pair / (HD / 2), c = (pair - g * (HD / 2)) * 2;
      const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
      *reinterpret_cast<float2*>(ob + g * HD + c) =
          make_float2(acc[r][0] * inv, acc[r][1] * inv);
    }
    return;
  }
  // S > 1: leave this split's part; the last split merges
  const long long unit = (long long)b * Hkv + kvh;
  float* pacc = part + unit * S * G * HD;             // [S][G][HD]
  float* ml = part + (long long)gridDim.x * Hkv * S * G * HD +
              unit * S * G * 2;                       // [S][G][2]
#pragma unroll
  for (int r = 0; r < L::kMaxR; ++r) {
    const int pair = tid + r * kThreads;
    if (r >= n_own || pair >= own) break;
    const int g = pair / (HD / 2), c = (pair - g * (HD / 2)) * 2;
    *reinterpret_cast<float2*>(pacc + ((long long)split * G + g) * HD + c) =
        make_float2(acc[r][0], acc[r][1]);
  }
  for (int g = tid; g < G; g += kThreads) {
    ml[2 * (split * G + g)] = m_s[g];
    ml[2 * (split * G + g) + 1] = l_s[g];
  }
  if (!repro::last_of_splits(tickets + unit, S, cnt)) return;
  repro::merge_parts<HD, kThreads>(pacc, ml, S, G,
                                   [&](int g) { return ob + g * HD; });
}

// the raised shared-memory limit of each instance, once per process
template <int HD>
cudaError_t allow_smem() {
  static cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  return err;
}

struct Args {
  const float* q;
  const __nv_bfloat16 *k, *v;
  const int *pos, *table, *q_pos;
  float *out, *part;
  int* tickets;
  int B, H, Hkv, ps, maxp, S;
  long long k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, pos_sp, pos_ss;
  float scale;
  int window;
};

size_t smem_bytes(int hd, int G, int pages, int ps) {
  switch (hd) {
    case 32: return Layout<32>::bytes(G, pages, pages * ps);
    case 64: return Layout<64>::bytes(G, pages, pages * ps);
    case 96: return Layout<96>::bytes(G, pages, pages * ps);
    default: return Layout<128>::bytes(G, pages, pages * ps);
  }
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return (int)err;
  const int pages = (a.maxp + a.S - 1) / a.S;
  const size_t smem = Layout<HD>::bytes(a.H / a.Hkv, pages, pages * a.ps);
  paged_attention_kernel<HD>
      <<<dim3(a.B, a.Hkv, a.S), kThreads, smem, stream>>>(
          a.q, a.k, a.v, a.pos, a.table, a.q_pos, a.out, a.part, a.tickets,
          a.H, a.Hkv, a.ps, a.maxp, a.S, pages, a.k_sp, a.k_ss, a.k_sh,
          a.v_sp, a.v_ss, a.v_sh, a.pos_sp, a.pos_ss, a.scale, a.window);
  return (int)cudaGetLastError();
}

template <int HD>
int info(int G, int pages, int ps, int* out) {
  cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, paged_attention_kernel<HD>);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Layout<HD>::bytes(G, pages, pages * ps);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, paged_attention_kernel<HD>, kThreads, smem);
  out[0] = fa.numRegs;
  out[1] = (int)(smem + fa.sharedSizeBytes);
  out[2] = blocks;
  out[3] = (int)fa.localSizeBytes;
  return (int)err;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  hd must be 32,
// 64, 96 or 128, H a multiple of Hkv with H / Hkv <= 32, 1 <= S <= 65535
// splits of each lane's pages; with S > 1, `part` holds B * Hkv * S *
// G * (hd + 2) floats of scratch and `tickets` B * Hkv ints that are
// zero (and are left zero).
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* pos_pages, const void* page_table, const void* q_pos,
    void* out, void* part, void* tickets, int B, int H, int Hkv, int hd,
    int ps, int maxp, int S, long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long pos_sp,
    long long pos_ss, float scale, int window, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > 32 || B <= 0 || ps <= 0 ||
      maxp <= 0 || S < 1 || S > 65535 || Hkv > 65535 ||
      (S > 1 && (part == nullptr || tickets == nullptr)) ||
      smem_bytes(hd, H / Hkv, (maxp + S - 1) / S, ps) > 232448)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q),
               static_cast<const __nv_bfloat16*>(k_pages),
               static_cast<const __nv_bfloat16*>(v_pages),
               static_cast<const int*>(pos_pages),
               static_cast<const int*>(page_table),
               static_cast<const int*>(q_pos),
               static_cast<float*>(out),
               static_cast<float*>(part),
               static_cast<int*>(tickets),
               B, H, Hkv, ps, maxp, S, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh,
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

// The kernel's resources for G query heads a kv head and S splits of
// maxp pages of ps slots: out[0] registers a thread, out[1] shared
// memory a block (bytes), out[2] blocks an SM can hold, out[3] local
// memory a thread (bytes, spills).  Returns the cudaError_t.
extern "C" int repro_paged_attention_info(int hd, int G, int maxp, int ps,
                                          int S, int* out) {
  const int pages = (maxp + S - 1) / S;
  switch (hd) {
    case 32: return info<32>(G, pages, ps, out);
    case 64: return info<64>(G, pages, ps, out);
    case 96: return info<96>(G, pages, ps, out);
    case 128: return info<128>(G, pages, ps, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
