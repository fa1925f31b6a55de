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
//     with hd contiguous — never transposed or padded;
//   H = G * Hkv, query head h reads kv head h / G;
//   key t is visible to query row s when t <= s and, with a window
//     (window > 0), t > s - window;
//   out (B, S, H, hd) f32 contiguous.
//
// Bound on the H100: bytes.  Each element of q, k and v is needed once
// and each output element written once; the work is 4 * hd flops per
// visible (row, key) pair.  At the calibration prefill's shape (B 512,
// S 64, 12 heads, hd 64) one layer moves 4 x 100.7 MB = 403 MB, 0.120 ms
// at 3.35 TB/s, against 3.27 GFLOP, 0.049 ms at 67 TFLOP/s in f32 (no
// tensor cores: the inputs are f32 and TF32 would change the numbers).
//
// Design for that bound: one block per (b, h, 64-row query tile), 256
// threads, four per query row.  The block stages its q tile and, one
// after another, 64-key K and V tiles in shared memory (dynamic: 112 KB
// at hd 128), so each q, k and v byte is read from device memory once
// per block; key tiles wholly above the diagonal or wholly left of the
// window are never loaded.  Thread (row, sub) computes the scores of
// keys sub, sub + 4, ... against its row, the row's max and sum are
// reduced over the four threads with shuffles, the probabilities go
// through shared memory, and the thread accumulates output dims sub,
// sub + 4, ... so that the four threads of a row read four neighbouring
// words of a V row.  Rows are padded by one word (Q, K) so that the
// eight rows of a warp fall in different banks.  Masked scores are
// -1e30 and masked probabilities 0, as in the TPU kernel.  The K/V
// tiles of the heads of one GQA group are re-read by each head's block
// (from L2); tensor cores (bf16 wgmma), TMA and a pipeline of tiles are
// left for a later change.

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kSub = 4;        // threads per query row
constexpr int kThreads = kRows * kSub;

template <int HD>
struct Smem {
  static constexpr int kQK = HD + 1;            // padded Q/K row stride
  static constexpr int kP = kKeys + 1;          // padded P row stride
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)kRows * kQK + (size_t)kKeys * kQK +
                       (size_t)kKeys * HD + (size_t)kRows * kP);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int H, int Hkv, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, float scale, int window) {
  using L = Smem<HD>;
  constexpr int DPT = HD / kSub;                // output dims per thread
  constexpr int KPT = kKeys / kSub;             // scores per thread
  extern __shared__ float smem[];
  float* qs = smem;                             // [kRows][kQK]
  float* ks = qs + kRows * L::kQK;              // [kKeys][kQK]
  float* vs = ks + kKeys * L::kQK;              // [kKeys][HD]
  float* ps = vs + kKeys * HD;                  // [kRows][kP]

  const int n_qt = (S + kRows - 1) / kRows;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % H;
  const int b = bh / H;
  const int kvh = h / (H / Hkv);
  const int q0 = qt * kRows;
  const int tid = threadIdx.x;
  const int r = tid / kSub;                     // this thread's row
  const int sub = tid % kSub;
  const int qi = q0 + r;                        // its absolute position

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int row = i / HD, d = i % HD;
    const int s = q0 + row;
    qs[row * L::kQK + d] = s < S ? qb[s * q_ss + d] : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = repro::kNegInf, l = 0.f;

  // key tiles that some row of this tile can see
  const int k_end = min(S, q0 + kRows);         // causal: keys <= last row
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kKeys * kKeys;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();                            // previous tile consumed
    for (int i = tid; i < kKeys * HD; i += kThreads) {
      const int row = i / HD, d = i % HD;
      const int t = k0 + row;
      const bool in = t < S;
      ks[row * L::kQK + d] = in ? kb[t * k_ss + d] : 0.f;
      vs[row * HD + d] = in ? vb[t * v_ss + d] : 0.f;
    }
    __syncthreads();

    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
    const float* qrow = qs + r * L::kQK;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        sc[j] += qd * ks[(sub + kSub * j) * L::kQK + d];
    }
    float m_tile = repro::kNegInf;
    unsigned visible = 0u;                      // bit j: key sub + 4j
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int t = k0 + sub + kSub * j;
      const bool ok = t < S && t <= qi && (window <= 0 || t > qi - window);
      visible |= (unsigned)ok << j;
      sc[j] = ok ? sc[j] * scale : repro::kNegInf;
      m_tile = fmaxf(m_tile, sc[j]);
    }
    // the four threads of a row are neighbouring lanes of one warp
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float* prow = ps + r * L::kP;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = (visible >> j) & 1u ? expf(sc[j] - m_new) : 0.f;
      prow[sub + kSub * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();                               // the row's P is written
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    const int n_keys = min(kKeys, S - k0);
    for (int j = 0; j < n_keys; ++j) {
      const float p = prow[j];
      const float* vrow = vs + j * HD + sub;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += p * vrow[kSub * i];
    }
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = out + (((long long)b * S + qi) * H + h) * HD + sub;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[kSub * i] = acc[i] * inv;
  }
}

template <int HD>
int launch(int B, int S, int H, int Hkv, const float* q, const float* k,
           const float* v, float* out, long long q_sb, long long q_ss,
           long long q_sh, long long k_sb, long long k_ss, long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, float scale,
           int window, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  static bool smem_set = false;        // once per instance and process
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const long long n_qt = (S + kRows - 1) / kRows;
  const long long blocks = (long long)B * H * n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_attention_kernel<HD><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, out, S, H, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  hd must be 32,
// 64, 96 or 128 and H a multiple of Hkv; window <= 0 means none.
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
    case 32:
      return launch<32>(B, S, H, Hkv, qf, kf, vf, of, q_sb, q_ss, q_sh, k_sb,
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
