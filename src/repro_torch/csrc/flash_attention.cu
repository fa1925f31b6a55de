// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention.py): whole-prompt causal attention
// with an optional sliding window, one f32 online softmax per query row,
// so the (S x S) score matrix never reaches device memory.
//
// Contract (the plain PyTorch version in
// repro_torch/kernels/flash_attention.py computes the same):
//   q (B, S, H, hd) f32 and k/v (B, S, Hkv, hd) f32 in the model's
//     layout, read in place through their (batch, seq, head) strides
//     with hd contiguous — never transposed or padded; every row starts
//     on 16 bytes (the wrapper checks: 16-byte aligned base pointers,
//     strides multiples of 4 elements), since tiles are copied in
//     16-byte pieces;
//   H = G * Hkv, query head h reads kv head h / G;
//   key t is visible to query row s when t <= s and, with a window
//     (window > 0), t > s - window;
//   masked scores are -1e30 and masked probabilities 0;
//   out (B, S, H, hd) f32 contiguous.
//
// Bound on the H100: bytes.  Each element of q, k and v is needed once
// and each output element written once; the work is 4 * hd flops per
// visible (row, key) pair.  At the calibration prefill's shape (B 512,
// S 64, 12 heads, hd 64) one layer moves 4 x 100.7 MB = 403 MB, 0.120 ms
// at 3.35 TB/s, against 3.27 GFLOP, 0.049 ms at 67 TFLOP/s in f32 on
// the CUDA cores.  Tensor cores buy nothing against that bound, and
// TF32 or bf16 would change the numbers.
//
// What held the first version back was shared memory, not device
// memory: one shared load per FMA runs an SM at 32 FMA a clock of its
// 128.  So both products are register-tiled:
//   * one block per (b, h, 64-row query tile), 256 threads; thread
//     (ty, tx) = (tid / 16, tid % 16) owns query rows 4ty .. 4ty + 3;
//   * S = Q K^T: the thread computes a 4 x 4 tile of scores, keys
//     tx + 16k (k < 4), from float4 reads of Q and K rows that are
//     padded to hd + 4 words, so the eight rows of a quarter warp fall
//     in eight different bank groups: 8 shared words per 16 FMAs;
//   * the row max and sum are reduced with shuffles over the 16 lanes
//     that share a row (one half warp);
//   * O += P V: the thread accumulates its 4 rows x output dims
//     tx + 16i (i < hd / 16), reading P as float4 over keys (a
//     broadcast in its half warp) and V rows as neighbouring words:
//     (4 + hd / 16) words per 4 hd / 16 FMAs.  At a head dim that is
//     not a multiple of 16 (24: the small models of the skip-cascade
//     example) the last i runs on the lanes with tx + 16i < hd only;
//     the other instances compile without that test.
// The masked half of the diagonal tile is skipped by 16-key sub-tiles:
// a warp holds 8 neighbouring rows, and a sub-tile wholly above its
// last row (or, with a window, wholly left of its first row's window)
// is neither multiplied nor read; inside a partly visible sub-tile the
// mask is exact per (row, key).  K/V tiles (and the Q tile) are copied
// with cp.async, 16 bytes a thread, zero-filled past S; when S spans
// more than one key tile they are double-buffered, so the next tile
// loads while this one is used.  At S = 64 there is one key tile, and
// the overlap comes from co-resident blocks: at hd <= 64 a block takes
// at most 68.6 KB of shared memory and 80 registers a thread, so three
// blocks share an SM.  The K/V tiles of the heads of one GQA group are
// re-read by each head's block (from L2).

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kLdP = kKeys + 4;

template <int HD>
struct Layout {
  static constexpr int kLd = HD + 4;            // padded Q/K row stride
  static constexpr int kQ = kRows * kLd;
  static constexpr int kKV = kKeys * kLd + kKeys * HD;   // one K|V buffer
  static constexpr int kP = kRows * kLdP;
  static size_t bytes(int nbuf) {
    return sizeof(float) * ((size_t)kQ + kP + (size_t)nbuf * kKV);
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 16 bytes from device to shared memory; zeros when !in (no read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows r0 .. r0 + 63 of a (S, HD) operand with row stride `rs` into
// shared memory with row stride LD; rows past S are zero
template <int HD, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long rs, int r0, int S) {
  constexpr int kC = HD / 4;                    // 16-byte pieces a row
  for (int e = threadIdx.x; e < kRows * kC; e += kThreads) {
    const int r = e / kC, c = (e - r * kC) * 4;
    const int s = r0 + r;
    const bool in = s < S;
    cp_async16(dst + r * LD + c, in ? src + s * rs + c : src, in);
  }
}

template <int HD>
__device__ __forceinline__ void load_kv(float* buf, const float* kb,
                                        const float* vb, long long k_ss,
                                        long long v_ss, int k0, int S) {
  using L = Layout<HD>;
  load_rows<HD, L::kLd>(buf, kb, k_ss, k0, S);
  load_rows<HD, HD>(buf + kKeys * L::kLd, vb, v_ss, k0, S);
}

// at hd <= 64, three blocks an SM (at most 80 registers a thread)
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int H, int Hkv, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, float scale, int window) {
  using L = Layout<HD>;
  constexpr int DPT = (HD + 15) / 16;           // output dims per thread
  constexpr bool kWhole = HD % 16 == 0;         // every lane owns DPT dims
  extern __shared__ float4 smem4[];             // 16-byte aligned
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][kLd]
  float* ps = qs + L::kQ;                       // [kRows][kLdP]
  float* kvb = ps + L::kP;                      // [nbuf][K | V]

  const int n_qt = (S + kRows - 1) / kRows;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H;
  const int b = bh / H;
  const int kvh = h / (H / Hkv);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  // the warp's rows: 8 neighbouring ones, clipped to S
  const int w_lo = q0 + 8 * (tid >> 5);
  const int w_hi = min(w_lo + 7, S - 1);

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  // key tiles that some row of this tile can see
  const int k_end = min(S, q0 + kRows);         // causal: keys <= last row
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kKeys * kKeys;
  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;

  load_rows<HD, L::kLd>(qs, qb, q_ss, q0, S);
  load_kv<HD>(kvb, kb, vb, k_ss, v_ss, k_begin, S);
  cp_commit();

  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = repro::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kKeys;
    const float* ks = kvb + (t & 1) * L::kKV;   // one buffer when n_tiles 1
    const float* vs = ks + kKeys * L::kLd;
    if (t + 1 < n_tiles) {                      // the next tile, meanwhile
      load_kv<HD>(kvb + ((t + 1) & 1) * L::kKV, kb, vb, k_ss, v_ss,
                  k0 + kKeys, S);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // 16-key sub-tiles some row of this warp sees (a contiguous run)
    unsigned live = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lo = k0 + 16 * j;
      const bool ok = w_lo <= w_hi && lo < S && lo <= w_hi &&
                      (window <= 0 || lo + 15 > w_lo - window);
      live |= (unsigned)ok << j;
    }

    if (live) {
      // S = Q K^T: rows 4ty + r, keys k0 + tx + 16j
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
      const float* qrow = qs + 4 * ty * L::kLd;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 qv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) qv[r] = ld4(qrow + r * L::kLd + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!((live >> j) & 1u)) continue;    // warp-uniform
          const float4 kv = ld4(ks + (tx + 16 * j) * L::kLd + d);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            s[r][j] = fmaf(qv[r].x, kv.x, s[r][j]);
            s[r][j] = fmaf(qv[r].y, kv.y, s[r][j]);
            s[r][j] = fmaf(qv[r].z, kv.z, s[r][j]);
            s[r][j] = fmaf(qv[r].w, kv.w, s[r][j]);
          }
        }
      }

      // online softmax of each row over its 16 lanes
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = q0 + 4 * ty + r;
        unsigned vis = 0u;
        float m_tile = repro::kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t_key = k0 + tx + 16 * j;
          const bool ok = ((live >> j) & 1u) && qi < S && t_key < S &&
                          t_key <= qi &&
                          (window <= 0 || t_key > qi - window);
          vis |= (unsigned)ok << j;
          s[r][j] = ok ? s[r][j] * scale : repro::kNegInf;
          m_tile = fmaxf(m_tile, s[r][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
        const float m_new = fmaxf(m[r], m_tile);
        const float alpha = expf(m[r] - m_new);
        float psum = 0.f;
        float* prow = ps + (4 * ty + r) * kLdP + tx;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!((live >> j) & 1u)) continue;
          const float p = (vis >> j) & 1u ? expf(s[r][j] - m_new) : 0.f;
          prow[16 * j] = p;
          psum += p;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        l[r] = l[r] * alpha + psum;
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[r][i] *= alpha;
      }
      __syncwarp();                             // the warp's P rows written

      // O += P V over the live sub-tiles' keys
      const int j_lo = 16 * (__ffs(live) - 1);
      const int j_hi = 16 * (32 - __clz(live));
      const float* prow = ps + 4 * ty * kLdP;
      for (int jj = j_lo; jj < j_hi; jj += 4) {
        float4 pv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[r] = ld4(prow + r * kLdP + jj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vrow = vs + (jj + u) * HD + tx;
#pragma unroll
          for (int i = 0; i < DPT; ++i) {
            const float vv =
                kWhole || tx + 16 * i < HD ? vrow[16 * i] : 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[r][i] = fmaf(comp(pv[r], u), vv, acc[r][i]);
          }
        }
      }
    }
    __syncthreads();                            // this buffer consumed
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = out + (((long long)b * S + qi) * H + h) * HD + tx;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (kWhole || tx + 16 * i < HD) orow[16 * i] = acc[r][i] * inv;
  }
}

// the raised shared-memory limit of each instance, once per process
template <int HD>
cudaError_t allow_smem() {
  static cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<HD>::bytes(2));
  return err;
}

template <int HD>
int launch(int B, int S, int H, int Hkv, const float* q, const float* k,
           const float* v, float* out, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, float scale,
           int window, cudaStream_t stream) {
  cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Layout<HD>::bytes(S > kKeys ? 2 : 1);
  const long long n_qt = (S + kRows - 1) / kRows;
  const long long blocks = (long long)B * H * n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_attention_kernel<HD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, out, S, H, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, scale, window);
  return (int)cudaGetLastError();
}

template <int HD>
int info(int S, int* out) {
  cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, flash_attention_kernel<HD>);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = Layout<HD>::bytes(S > kKeys ? 2 : 1);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_attention_kernel<HD>, kThreads, smem);
  out[0] = a.numRegs;
  out[1] = (int)(smem + a.sharedSizeBytes);
  out[2] = blocks;
  out[3] = (int)a.localSizeBytes;
  return (int)err;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  hd must be 24,
// 32, 48, 64, 96 or 128 and H a multiple of Hkv; window <= 0 means none.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int window, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(out);
  switch (hd) {
    case 24:
      return launch<24>(B, S, H, Hkv, qf, kf, vf, of, q_sb, q_ss, q_sh, k_sb,
                        k_ss, k_sh, v_sb, v_ss, v_sh, scale, window, st);
    case 32:
      return launch<32>(B, S, H, Hkv, qf, kf, vf, of, q_sb, q_ss, q_sh, k_sb,
                        k_ss, k_sh, v_sb, v_ss, v_sh, scale, window, st);
    case 48:
      return launch<48>(B, S, H, Hkv, qf, kf, vf, of, q_sb, q_ss, q_sh, k_sb,
                        k_ss, k_sh, v_sb, v_ss, v_sh, scale, window, st);
    case 64:
      return launch<64>(B, S, H, Hkv, qf, kf, vf, of, q_sb, q_ss, q_sh, k_sb,
                        k_ss, k_sh, v_sb, v_ss, v_sh, scale, window, st);
    case 96:
      return launch<96>(B, S, H, Hkv, qf, kf, vf, of, q_sb, q_ss, q_sh, k_sb,
                        k_ss, k_sh, v_sb, v_ss, v_sh, scale, window, st);
    case 128:
      return launch<128>(B, S, H, Hkv, qf, kf, vf, of, q_sb, q_ss, q_sh,
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, window,
                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's resources at head dim hd and length S: out[0] registers a
// thread, out[1] shared memory a block (bytes), out[2] blocks an SM can
// hold, out[3] local memory a thread (bytes, spills).  Returns the
// cudaError_t.
extern "C" int repro_flash_attention_info(int hd, int S, int* out) {
  switch (hd) {
    case 24: return info<24>(S, out);
    case 32: return info<32>(S, out);
    case 48: return info<48>(S, out);
    case 64: return info<64>(S, out);
    case 96: return info<96>(S, out);
    case 128: return info<128>(S, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
