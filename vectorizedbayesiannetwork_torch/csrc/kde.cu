// Kernel-density (KDE) kernels for the PyTorch port, written for Hopper (sm_90a).
//
// vbn_kde_root replaces the TPU kernel
//   vectorizedbayesiannetwork_tpu/ops/kde_pallas.py:147 _kde_root_kernel_direct,
// vbn_kde_cond replaces
//   vectorizedbayesiannetwork_tpu/ops/kde_pallas.py:106 _kde_cond_kernel_direct,
// vbn_kde_cond_wide replaces
//   vectorizedbayesiannetwork_tpu/ops/kde_pallas.py:72 _kde_cond_kernel,
// and vbn_kde_pick replaces
//   vectorizedbayesiannetwork_tpu/ops/kde_pallas.py:390 _kde_pick_kernel
//   and :412 _kde_pick_kernel_extg.
//
// For M query rows against a support of N points (data_x [N, Dx], data_p
// [N, Dp], log_mask [N]):
//   ky_mn = -|x_m - dx_n|^2 / (2 h_y^2) + const_y,
//   kp_mn = -|p_m - dp_n|^2 / (2 h_p^2) + const_p + log_mask_n,
//   root: lse_n(ky_mn + log_mask_n);  cond: lse_n(kp + ky) - lse_n(kp);
//   pick: n* = argmax_n(-|p_m - dp_n|^2 / (2 h_p^2) + log_mask_n + g_mn),
//         the first index on ties; out_m = data_x[n*].
//
// Bound: operations. The bytes are the queries and outputs (M x (Dx + Dp + 1)
// floats, once each) and a support of kilobytes; the work is M x N pairs.
// Per pair the root takes one exp and the conditional two (one per
// logsumexp), on the SFU at 16 a clock per SM, beside 2 float32 operations
// per feature and about 6 more; the pick takes two logs a pair for its
// Gumbel noise (-log(-log u)), a Philox-4x32-10 call per four pairs and the
// distance terms. The TPU kernels held the [TM, N] logit tiles in VMEM; here
// no pair's value is ever stored.
//
// Design (all four): one thread per query row, 256 threads a block. The
// block stages the support through shared memory in tiles of 256 points,
// one contiguous row per feature (the global loads run along the [N, D]
// rows, so they coalesce), so any N works and an unaligned or masked tail
// needs no padding. Each thread holds its query row in registers (the
// kernels are instantiated for the next power of two of the widest feature
// count, up to 32) and walks the tile; all threads read the same shared
// word at once (a broadcast). Each logsumexp is online: a running (max,
// sum), rescaled when a larger term arrives, so either branch costs one
// exp (__expf: the SFU's ex2 after one multiply). The result takes the JAX
// kernels' guard max(mx, -1e30): a row whose terms all lie below -1e30
// gives -inf, as there.
//
// vbn_kde_cond_wide (max(Dx, Dp) > 32): the features do not fit registers.
// Per sub-tile of 32 support points the block stages the features in
// chunks of 32 through shared memory (padded a column against bank
// conflicts), each thread holds a chunk of its query row in registers and
// accumulates the 32 squared distances in registers, in plain float32: the
// TPU kernel's bf16x3 cross-term GEMM existed for the MXU's bf16 inputs,
// and direct differences are exact to float32 rounding. Tensor cores (TF32
// or 3xTF32 on the expanded form) are later work.
//
// vbn_kde_pick: the distance terms in the plain version's float32 order
// with _rn intrinsics (nvcc fuses nothing), accurate logf for the Gumbel
// noise, and a strict running argmax in index order, so the kernel picks
// the plain version's support point. The Gumbel field is read from
// `gumbel` [M, N] when given, else drawn: Philox-4x32-10 with key = the two
// 32-bit words of the device tensor `key` (no host sync per node), counter
// (row, n / 4, 0, 0), word n % 4, u = min(((bits >> 8) + 0.5) 2^-24,
// 1 - 2^-24), g = -log(-log u); ops/kde_fused.py rebuilds it in torch. The
// clamp departs from the TPU kernel, where the top 24-bit value rounds u to
// exactly 1.0 and g to +inf, which picks that support point whatever its
// mask (once in 2^24 pairs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vbn_common.cuh"

namespace {

constexpr int THREADS = 256;     // query rows per block
constexpr int TILE = 256;        // support points per shared-memory tile
constexpr int WIDE_THREADS = 128;
constexpr int WN = 32;           // wide: support points per sub-tile
constexpr int WC = 32;           // wide: features per staged chunk
constexpr float GUARD = -1e30f;  // kde_pallas.py:66
constexpr float U_MAX = 0.99999994039535522f;  // 1 - 2^-24
static_assert(TILE % 4 == 0, "a Philox call covers four support points");

// Online logsumexp: running max m and sum s of exp(v - m).
struct Lse {
  float m, s;
  __device__ __forceinline__ void init() {
    m = -INFINITY;
    s = 0.f;
  }
  __device__ __forceinline__ void add(float v) {
    if (v == -INFINITY) return;  // weight 0
    if (v > m) {
      s = s * __expf(m - v) + 1.f;  // 0 * 0 + 1 on the first term
      m = v;
    } else {
      s += __expf(v - m);
    }
  }
  __device__ __forceinline__ float value() const {
    return m < GUARD ? -INFINITY : m + logf(s);
  }
};

// Rows [0, tn) of a row-major [., d] block at src into s[f * TILE + j].
__device__ __forceinline__ void stage(float* s, const float* __restrict__ src,
                                      int tn, int d) {
  for (int i = threadIdx.x; i < tn * d; i += blockDim.x) {
    const int j = i / d, f = i - j * d;
    s[f * TILE + j] = src[i];
  }
}

// Root (COND false) and conditional KDE for max(Dx, Dp) <= MD <= 32.
template <int MD, bool COND>
__global__ void __launch_bounds__(THREADS)
kde_direct_kernel(const float* __restrict__ x, const float* __restrict__ p,
                  const float* __restrict__ data_x,
                  const float* __restrict__ data_p,
                  const float* __restrict__ log_mask, int m, int n, int dx,
                  int dp, float inv2y, float inv2p, float const_y,
                  float const_p, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_x = smem;               // [dx][TILE]
  float* s_p = s_x + dx * TILE;    // [dp][TILE]
  float* s_lm = s_p + dp * TILE;   // [TILE]
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < m;
  float q[MD], r[MD];
#pragma unroll
  for (int d = 0; d < MD; ++d) {
    q[d] = (live && d < dx) ? x[row * dx + d] : 0.f;
    r[d] = (COND && live && d < dp) ? p[row * dp + d] : 0.f;
  }
  Lse num, den;
  num.init();
  den.init();
  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int tn = min(TILE, n - t0);
    __syncthreads();  // the previous tile is read by every thread
    stage(s_x, data_x + (size_t)t0 * dx, tn, dx);
    if (COND) stage(s_p, data_p + (size_t)t0 * dp, tn, dp);
    for (int j = threadIdx.x; j < tn; j += THREADS) s_lm[j] = log_mask[t0 + j];
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      float sy = 0.f;
#pragma unroll
      for (int d = 0; d < MD; ++d) {
        if (d < dx) {
          const float e = q[d] - s_x[d * TILE + j];
          sy = fmaf(e, e, sy);
        }
      }
      const float ky = fmaf(-sy, inv2y, const_y);
      if (COND) {
        float sp = 0.f;
#pragma unroll
        for (int d = 0; d < MD; ++d) {
          if (d < dp) {
            const float e = r[d] - s_p[d * TILE + j];
            sp = fmaf(e, e, sp);
          }
        }
        const float kp = fmaf(-sp, inv2p, const_p) + s_lm[j];
        den.add(kp);
        num.add(kp + ky);
      } else {
        num.add(ky + s_lm[j]);
      }
    }
  }
  if (live) out[row] = COND ? num.value() - den.value() : num.value();
}

// Squared distances of one query row (q_row, d features) to the WN support
// points [t0, t0 + tn) of `data`, into acc[WN]; every thread of the block
// calls it (it stages through s_f).
__device__ __forceinline__ void wide_sq(const float* __restrict__ q_row,
                                        bool live,
                                        const float* __restrict__ data, int d,
                                        int t0, int tn, float (*s_f)[WN + 1],
                                        float acc[WN]) {
#pragma unroll
  for (int j = 0; j < WN; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += WC) {
    const int dc = min(WC, d - c0);
    __syncthreads();  // s_f is free
    for (int i = threadIdx.x; i < WN * WC; i += blockDim.x) {
      const int j = i / WC, f = i - j * WC;
      s_f[f][j] = (j < tn && f < dc) ? data[(size_t)(t0 + j) * d + c0 + f] : 0.f;
    }
    __syncthreads();
    float qc[WC];
#pragma unroll
    for (int f = 0; f < WC; ++f) qc[f] = (live && f < dc) ? q_row[c0 + f] : 0.f;
#pragma unroll
    for (int f = 0; f < WC; ++f) {
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const float e = qc[f] - s_f[f][j];
        acc[j] = fmaf(e, e, acc[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(WIDE_THREADS)
kde_wide_kernel(const float* __restrict__ x, const float* __restrict__ p,
                const float* __restrict__ data_x,
                const float* __restrict__ data_p,
                const float* __restrict__ log_mask, int m, int n, int dx, int dp,
                float inv2y, float inv2p, float const_y, float const_p,
                float* __restrict__ out) {
  __shared__ float s_f[WC][WN + 1];
  __shared__ float s_lm[WN];
  const long long row = (long long)blockIdx.x * WIDE_THREADS + threadIdx.x;
  const bool live = row < m;
  const float* q_x = x + (live ? row * dx : 0);
  const float* q_p = p + (live ? row * dp : 0);
  Lse num, den;
  num.init();
  den.init();
  for (int t0 = 0; t0 < n; t0 += WN) {
    const int tn = min(WN, n - t0);
    __syncthreads();  // the previous sub-tile's s_lm is read by every thread
    if (threadIdx.x < tn) s_lm[threadIdx.x] = log_mask[t0 + threadIdx.x];
    float kp[WN], ky[WN];
    wide_sq(q_p, live, data_p, dp, t0, tn, s_f, kp);  // syncs: s_lm visible
    wide_sq(q_x, live, data_x, dx, t0, tn, s_f, ky);
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      if (j < tn) {
        const float a = fmaf(-kp[j], inv2p, const_p) + s_lm[j];
        den.add(a);
        num.add(a + fmaf(-ky[j], inv2y, const_y));
      }
    }
  }
  if (live) out[row] = num.value() - den.value();
}

template <int MD, bool EXTG>
__global__ void __launch_bounds__(THREADS)
kde_pick_kernel(const float* __restrict__ p, const float* __restrict__ data_p,
                const float* __restrict__ data_x,
                const float* __restrict__ log_mask,
                const int64_t* __restrict__ key,
                const float* __restrict__ gumbel, int m, int n, int dp, int dx,
                float inv2p, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_p = smem;              // [dp][TILE]
  float* s_lm = s_p + dp * TILE;  // [TILE]
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < m;
  float r[MD];
#pragma unroll
  for (int d = 0; d < MD; ++d) r[d] = (live && d < dp) ? p[row * dp + d] : 0.f;
  uint64_t seed = 0;
  if (!EXTG)
    seed = (uint64_t)(uint32_t)key[0] | ((uint64_t)(uint32_t)key[1] << 32);
  float best = -INFINITY;
  int best_n = 0;
  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int tn = min(TILE, n - t0);
    __syncthreads();
    if (dp > 0) stage(s_p, data_p + (size_t)t0 * dp, tn, dp);
    for (int j = threadIdx.x; j < tn; j += THREADS) s_lm[j] = log_mask[t0 + j];
    __syncthreads();
    for (int j = 0; j < tn; j += 4) {
      float g[4];
      if (EXTG) {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          g[w] = (live && j + w < tn) ? gumbel[row * n + t0 + j + w] : 0.f;
      } else {
        uint32_t c[4] = {(uint32_t)row, (uint32_t)((t0 + j) >> 2), 0u, 0u};
        vbn::philox4x32_10(c, seed);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          g[w] = -logf(-logf(fminf(vbn::uniform_from_bits(c[w]), U_MAX)));
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int jj = j + w;
        if (jj < tn) {
          float score = s_lm[jj];
          if (dp > 0) {
            float sq = 0.f;
#pragma unroll
            for (int d = 0; d < MD; ++d) {
              if (d < dp) {
                const float e = __fsub_rn(r[d], s_p[d * TILE + jj]);
                sq = __fadd_rn(sq, __fmul_rn(e, e));
              }
            }
            score = __fadd_rn(__fmul_rn(-sq, inv2p), score);
          }
          const float v = __fadd_rn(score, g[w]);
          if (v > best) {
            best = v;
            best_n = t0 + jj;
          }
        }
      }
    }
  }
  if (live)
    for (int f = 0; f < dx; ++f)
      out[row * dx + f] = data_x[(size_t)best_n * dx + f];
}

// The instantiation for the widest feature count md (1 .. 32): the next
// power of two, or -1 past 32.
inline int pow2_at_least(int md) {
  int v = 1;
  while (v < md) v <<= 1;
  return v <= 32 ? v : -1;
}

template <int MD, bool COND>
cudaError_t go_direct(const float* x, const float* p, const float* data_x,
                      const float* data_p, const float* log_mask, int m, int n,
                      int dx, int dp, float inv2y, float inv2p, float const_y,
                      float const_p, float* out, cudaStream_t st) {
  const size_t smem = (size_t)(dx + dp + 1) * TILE * sizeof(float);
  auto kernel = kde_direct_kernel<MD, COND>;
  cudaError_t e = vbn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(m + THREADS - 1) / THREADS, THREADS, smem, st>>>(
      x, p, data_x, data_p, log_mask, m, n, dx, dp, inv2y, inv2p, const_y,
      const_p, out);
  return cudaGetLastError();
}

template <bool COND>
cudaError_t launch_direct(const float* x, const float* p, const float* data_x,
                          const float* data_p, const float* log_mask, int m,
                          int n, int dx, int dp, float inv2y, float inv2p,
                          float const_y, float const_p, float* out,
                          cudaStream_t st) {
  switch (pow2_at_least(dx > dp ? dx : dp)) {
#define VBN_KDE_CASE(V)                                                     \
  case V:                                                                   \
    return go_direct<V, COND>(x, p, data_x, data_p, log_mask, m, n, dx, dp, \
                              inv2y, inv2p, const_y, const_p, out, st);
    VBN_KDE_CASE(1)
    VBN_KDE_CASE(2)
    VBN_KDE_CASE(4)
    VBN_KDE_CASE(8)
    VBN_KDE_CASE(16)
    VBN_KDE_CASE(32)
#undef VBN_KDE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <int MD, bool EXTG>
cudaError_t go_pick(const float* p, const float* data_p, const float* data_x,
                    const float* log_mask, const int64_t* key,
                    const float* gumbel, int m, int n, int dp, int dx,
                    float inv2p, float* out, cudaStream_t st) {
  const size_t smem = (size_t)(dp + 1) * TILE * sizeof(float);
  auto kernel = kde_pick_kernel<MD, EXTG>;
  cudaError_t e = vbn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(m + THREADS - 1) / THREADS, THREADS, smem, st>>>(
      p, data_p, data_x, log_mask, key, gumbel, m, n, dp, dx, inv2p, out);
  return cudaGetLastError();
}

template <bool EXTG>
cudaError_t launch_pick(const float* p, const float* data_p,
                        const float* data_x, const float* log_mask,
                        const int64_t* key, const float* gumbel, int m, int n,
                        int dp, int dx, float inv2p, float* out,
                        cudaStream_t st) {
  switch (pow2_at_least(dp)) {
#define VBN_KDE_CASE(V)                                                      \
  case V:                                                                    \
    return go_pick<V, EXTG>(p, data_p, data_x, log_mask, key, gumbel, m, n, \
                            dp, dx, inv2p, out, st);
    VBN_KDE_CASE(1)
    VBN_KDE_CASE(2)
    VBN_KDE_CASE(4)
    VBN_KDE_CASE(8)
    VBN_KDE_CASE(16)
    VBN_KDE_CASE(32)
#undef VBN_KDE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch (or the error that kept
// it from launching); stream is a cudaStream_t passed as an integer.

int vbn_kde_root(const float* x, const float* data_x, const float* log_mask,
                 int m, int n, int dx, float inv2y, float const_y, float* out,
                 void* stream) {
  return (int)launch_direct<false>(x, nullptr, data_x, nullptr, log_mask, m, n,
                                   dx, 0, inv2y, 0.f, const_y, 0.f, out,
                                   (cudaStream_t)stream);
}

int vbn_kde_cond(const float* x, const float* p, const float* data_x,
                 const float* data_p, const float* log_mask, int m, int n,
                 int dx, int dp, float inv2y, float inv2p, float const_y,
                 float const_p, float* out, void* stream) {
  return (int)launch_direct<true>(x, p, data_x, data_p, log_mask, m, n, dx, dp,
                                  inv2y, inv2p, const_y, const_p, out,
                                  (cudaStream_t)stream);
}

int vbn_kde_cond_wide(const float* x, const float* p, const float* data_x,
                      const float* data_p, const float* log_mask, int m, int n,
                      int dx, int dp, float inv2y, float inv2p, float const_y,
                      float const_p, float* out, void* stream) {
  kde_wide_kernel<<<(m + WIDE_THREADS - 1) / WIDE_THREADS, WIDE_THREADS, 0,
                    (cudaStream_t)stream>>>(x, p, data_x, data_p, log_mask, m,
                                            n, dx, dp, inv2y, inv2p, const_y,
                                            const_p, out);
  return (int)cudaGetLastError();
}

int vbn_kde_pick(const float* p, const float* data_p, const float* data_x,
                 const float* log_mask, const int64_t* key,
                 const float* gumbel, int m, int n, int dp, int dx,
                 float inv2p, float* out, void* stream) {
  if (gumbel != nullptr)
    return (int)launch_pick<true>(p, data_p, data_x, log_mask, key, gumbel, m,
                                  n, dp, dx, inv2p, out, (cudaStream_t)stream);
  return (int)launch_pick<false>(p, data_p, data_x, log_mask, key, gumbel, m,
                                 n, dp, dx, inv2p, out, (cudaStream_t)stream);
}

}  // extern "C"
