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
// per feature and about 6 more. The TPU kernels held the [TM, N] logit
// tiles in VMEM; here no pair's value is ever stored.
//
// Design of the root and the conditional (vbn_kde_root, vbn_kde_cond; one
// template, kde_direct_kernel): one thread per query row, 256 threads a
// block. The block stages the support through shared memory in tiles of
// 256 points, one contiguous row per feature (the global loads run along
// the [N, D] rows, so they coalesce), so any N works; a tile's ragged end
// is padded to four points of mask -inf. The kernel is instantiated for the
// next powers of two of Dx and Dp (MX, MP <= 32); the features past Dx and
// Dp are zeros in the query registers and the staged rows, so the pair
// loop has no feature guards. Per pair the SFU's exps bound it, so
// everything else is cut down to an FFMA chain and one ex2 a term:
// - The base-2 domain. The wrapper passes c = sqrt(log2(e) / 2h^2) and
//   log2(e) * const; the kernel scales the query in registers and the
//   staged support by c, and stages log2(e) * log_mask + const_p (the
//   root: + const_y), so a term is kp2 = mask2_n - sum_d (c r_d - c P_nd)^2
//   and kp2 - sum_d (c q_d - c X_nd)^2: one FADD and one FFMA a feature,
//   then ex2.approx.ftz (one MUFU.EX2, no multiply by log2(e)). The result
//   takes one multiply by ln 2.
// - A lazy reference in place of the online max. Each logsumexp sums
//   2^(v - ref) against a reference that moves (rescaling what was summed)
//   only when a term passes it by LSE_MARGIN (2^32 bounds a term). Four
//   points' exponents are formed first; one compare of their largest with
//   the margin sends the four, rarely, down the rescaling path, so the
//   common path has no data-dependent branch per term. The reference starts
//   at the JAX kernels' guard -1e30 (in base 2): a term under it never
//   moves it and adds 0, so a row whose terms all lie below -1e30 gives
//   -inf, as max(mx, -1e30) does there, and a -inf mask adds nothing.
// - Vectorised shared loads: four consecutive points of one feature are
//   one 16-byte word ([f][TILE] layout), read by every thread at once (a
//   broadcast): one LDS.128 per feature and per mask for four pairs.
// - Registers: __launch_bounds__ with a minimum of blocks by the widths
//   (kde_min_blocks), so ptxas keeps the query rows and the four points'
//   exponents in registers without spilling.
//
// The pick's conditional form stages the support the same way, unscaled
// (stage), and keeps its own sums (below).
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
// vbn_kde_pick draws, per query row, one support point from the categorical
// with weights mask_n exp(-|p - P_n|^2 / 2h^2), then copies data_x[n*].
// The TPU kernel draws it as a Gumbel-argmax over all N points (two logs
// and a random word a pair). Here the served route (the model's: a device
// key, no Gumbel field) draws it by inverse CDF on one uniform a row: with
// s_n = -|p - P_n|^2 inv2p + log_mask_n (the plain version's float32
// order, _rn intrinsics), m = max s_n and w_n = exp(s_n - m), it takes the
// first n, in index order, whose running sum of w exceeds t = u * sum w.
// If rounding keeps every running sum at or below t, it takes the last
// point that moved the sum (never a point of negligible weight). The
// uniform: Philox-4x32-10 with key = the two 32-bit words of the device
// tensor `key` (no host sync per node), counter (row, 0, 0, 2), word 0,
// u = min(((bits >> 8) + 0.5) 2^-24, 1 - 2^-24); ops/kde_fused.py's
// pick_uniforms rebuilds it in torch.
// - Root (Dp = 0): the weights do not depend on the row, so each block
//   builds the CDF of the N masked weights once (expf, in double: a
//   sequential sum per thread's chunk, a block scan of the chunk sums) in
//   shared memory, then serves a grid-stride run of rows: one uniform and a
//   binary search of about log2 N steps a row. It is bound by the bytes it
//   writes. Past ROOT_CDF_MAX points the CDF leaves shared memory, and such
//   a root takes the conditional form with Dp = 0.
// - Conditional (Dp >= 1): one pass over the staged support tiles sums the
//   weights, one __expf a pair, against a reference score that moves up
//   (rescaling what was summed) only when a score passes it by RESCALE; the
//   sums are float32 within chunks of 64 points (at most PICK_CHUNKS chunks,
//   longer ones past 2048 points), each chunk's sum kept in the thread's
//   column of shared memory. The chunk sums are added in float-float
//   (TwoSum, about 2^-48 of the total) to the total and to the running sum
//   that finds the chunk holding t; the thread then walks only that chunk,
//   re-reading its points from global memory (the support is kilobytes, in
//   L1). The pair work is thus one distance, one exp and one add, once.
// Why float-float across chunks: a float32 running sum over 2048 terms
// depends on the order of its additions, and against the plain version's
// float64 cumsum it picked another point on about 3 rows in 10^4 (a
// float32 form of this kernel, measured on an H100). Float32 only within a
// chunk of 64 leaves about 2 in 10^5 (a numpy model of both sums), beside
// the terms' own rounding (__expf against torch.exp): on such a row t lies
// within rounding of a running sum and the two pick neighbours.
//
// The external-Gumbel route (`gumbel` [M, N], the JAX kernels' test hook,
// _kde_pick_kernel_extg) keeps the Gumbel-argmax: the distance terms in the
// plain version's float32 order with _rn intrinsics and a strict running
// argmax in index order, so it picks the plain version's support point.

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
constexpr int ROOT_CDF_MAX = 16384;  // root pick: CDF points in shared memory
constexpr float RESCALE = 32.f;  // conditional pick: e^32 bounds a term
constexpr int PICK_CHUNKS = 32;  // conditional pick: chunk sums a row
constexpr int ROOT_BLOCKS_PER_SM = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.69314718055994531f;
constexpr float GUARD2 = GUARD * LOG2E;  // the guard in base 2
constexpr float LSE_MARGIN = 32.f;       // direct kernels: 2^32 bounds a term

// Blocks an SM the direct kernels are built for: registers hold MX + MP
// query features, ~30 other values and the staged words in flight, so 64
// registers a thread up to 8 features, 128 up to 32, then 255.
__host__ __device__ constexpr int kde_min_blocks(int mx, int mp) {
  return mx + mp <= 8 ? 4 : mx + mp <= 32 ? 2 : 1;
}

// Online logsumexp (the wide kernel): running max m and sum s of
// exp(v - m).
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

using vbn::ex2;

// Base-2 logsumexp of the direct kernels: s = sum 2^(v - ref), the
// reference moved only when a term passes it by LSE_MARGIN. The pair loop
// adds to s directly; add() is the rescaling path.
struct Lse2 {
  float ref, s;
  __device__ __forceinline__ void init() {
    ref = GUARD2;
    s = 0.f;
  }
  __device__ __forceinline__ void add(float v) {
    float a = v - ref;
    if (a > LSE_MARGIN) {  // the first term over the guard, or one far above
      s *= ex2(-a);
      ref = v;
      a = 0.f;
    }
    s += ex2(a);
  }
  // ln(sum 2^(v + offset)): -inf when every term lies under the guard, the
  // guard itself when the terms that count lie at it (never moved), as
  // max(mx, -1e30) + log(sum) gives
  __device__ __forceinline__ float value(float offset) const {
    if (!(s > 0.f)) return -INFINITY;
    if (ref == GUARD2) return GUARD + log2f(s) * LN2;
    return (ref + offset + log2f(s)) * LN2;
  }
};

// Rows [0, tn) of a row-major [., d] block at src, times `scale`, into
// s[f * TILE + j] for f < M and j < tn4; features f >= d and points
// j >= tn are 0.
template <int M>
__device__ __forceinline__ void stage_scaled(float* s,
                                             const float* __restrict__ src,
                                             int tn, int tn4, int d,
                                             float scale) {
  for (int i = threadIdx.x; i < tn4 * M; i += blockDim.x) {
    const int j = i / M, f = i - j * M;
    s[f * TILE + j] = (j < tn && f < d) ? src[j * d + f] * scale : 0.f;
  }
}

// Root (COND false) and conditional KDE for Dx <= MX and Dp <= MP, MX and
// MP powers of two up to 32. sy, sp: the coordinate scales; c_stage: the
// constant staged with the mask (const_p, or the root's const_y); c_num:
// the numerator's other constant (const_y, or 0 for the root); all base 2.
template <int MX, int MP, bool COND>
__global__ void __launch_bounds__(THREADS, kde_min_blocks(MX, COND ? MP : 0))
kde_direct_kernel(const float* __restrict__ x, const float* __restrict__ p,
                  const float* __restrict__ data_x,
                  const float* __restrict__ data_p,
                  const float* __restrict__ log_mask, int m, int n, int dx,
                  int dp, float sy, float sp, float c_stage, float c_num,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                          // [MX][TILE]
  float* s_p = s_x + MX * TILE;               // [MP][TILE] (COND)
  float* s_lm = s_p + (COND ? MP : 0) * TILE; // [TILE]
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < m;
  float q[MX], r[MP];
#pragma unroll
  for (int d = 0; d < MX; ++d)
    q[d] = (live && d < dx) ? x[row * dx + d] * sy : 0.f;
#pragma unroll
  for (int d = 0; d < MP; ++d)
    r[d] = (COND && live && d < dp) ? p[row * dp + d] * sp : 0.f;
  Lse2 num, den;
  num.init();
  den.init();
  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int tn = min(TILE, n - t0), tn4 = (tn + 3) & ~3;
    __syncthreads();  // the previous tile is read by every thread
    stage_scaled<MX>(s_x, data_x + (size_t)t0 * dx, tn, tn4, dx, sy);
    if (COND) stage_scaled<MP>(s_p, data_p + (size_t)t0 * dp, tn, tn4, dp, sp);
    for (int j = threadIdx.x; j < tn4; j += THREADS)
      s_lm[j] = j < tn ? fmaf(log_mask[t0 + j], LOG2E, c_stage) : -INFINITY;
    __syncthreads();
    for (int j = 0; j < tn4; j += 4) {
      const float4 lm = *(const float4*)(s_lm + j);
      float kp[4] = {lm.x, lm.y, lm.z, lm.w};
      if (COND) {
#pragma unroll
        for (int d = 0; d < MP; ++d) {
          const float4 v = *(const float4*)(s_p + d * TILE + j);
          float e;
          e = r[d] - v.x; kp[0] = fmaf(-e, e, kp[0]);
          e = r[d] - v.y; kp[1] = fmaf(-e, e, kp[1]);
          e = r[d] - v.z; kp[2] = fmaf(-e, e, kp[2]);
          e = r[d] - v.w; kp[3] = fmaf(-e, e, kp[3]);
        }
      }
      float an[4], ap[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        an[k] = kp[k] - num.ref;
        ap[k] = kp[k] - den.ref;
      }
#pragma unroll
      for (int d = 0; d < MX; ++d) {
        const float4 v = *(const float4*)(s_x + d * TILE + j);
        float e;
        e = q[d] - v.x; an[0] = fmaf(-e, e, an[0]);
        e = q[d] - v.y; an[1] = fmaf(-e, e, an[1]);
        e = q[d] - v.z; an[2] = fmaf(-e, e, an[2]);
        e = q[d] - v.w; an[3] = fmaf(-e, e, an[3]);
      }
      float mx = fmaxf(fmaxf(an[0], an[1]), fmaxf(an[2], an[3]));
      if (COND) mx = fmaxf(mx, fmaxf(fmaxf(ap[0], ap[1]), fmaxf(ap[2], ap[3])));
      if (mx > LSE_MARGIN) {
        // rare: a term passes its reference by the margin (every row's
        // first term over the guard): the four points one by one, their
        // support read again (volatile: reusing the loads above would keep
        // every difference of the four points live across the branch)
        const volatile float* vx = s_x;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float sq = 0.f;
#pragma unroll
          for (int d = 0; d < MX; ++d) {
            const float e = q[d] - vx[d * TILE + j + k];
            sq = fmaf(e, e, sq);
          }
          if (COND) den.add(kp[k]);
          num.add(kp[k] - sq);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (COND) den.s += ex2(ap[k]);
          num.s += ex2(an[k]);
        }
      }
    }
  }
  if (live)
    out[row] = COND ? num.value(c_num) - den.value(0.f) : num.value(0.f);
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

// The pick's uniform of query row `row` (see the note at the top).
__device__ __forceinline__ float pick_uniform(long long row, uint64_t seed) {
  uint32_t c[4] = {(uint32_t)row, 0u, 0u, 2u};
  vbn::philox4x32_10(c, seed);
  return fminf(vbn::uniform_from_bits(c[0]), U_MAX);
}

__device__ __forceinline__ uint64_t key_seed(const int64_t* __restrict__ key) {
  return (uint64_t)(uint32_t)key[0] | ((uint64_t)(uint32_t)key[1] << 32);
}

__device__ __forceinline__ void copy_row(const float* __restrict__ data_x,
                                         int n_star, long long row, int dx,
                                         float* __restrict__ out) {
  for (int f = 0; f < dx; ++f)
    out[row * dx + f] = data_x[(size_t)n_star * dx + f];
}

// Root pick (Dp = 0, N <= ROOT_CDF_MAX): the CDF of the masked weights in
// shared memory, in double, and a binary search per row.
__global__ void __launch_bounds__(THREADS)
kde_pick_root_kernel(const float* __restrict__ data_x,
                     const float* __restrict__ log_mask,
                     const int64_t* __restrict__ key, long long m, int n,
                     int dx, float* __restrict__ out) {
  extern __shared__ double s_cdf[];  // [n]
  __shared__ double s_part[THREADS];
  const int tid = threadIdx.x;
  // m0 = max_n log_mask_n (guarded, so an all -inf mask gives weights 0)
  float mx = -INFINITY;
  for (int j = tid; j < n; j += THREADS) mx = fmaxf(mx, log_mask[j]);
  s_part[tid] = mx;
  __syncthreads();
  if (tid == 0) {
    double v = -INFINITY;
    for (int t = 0; t < THREADS; ++t) v = fmax(v, s_part[t]);
    s_part[0] = fmax(v, -3.402823466e38);
  }
  __syncthreads();
  const float m0 = (float)s_part[0];
  __syncthreads();
  // each thread sums its contiguous chunk, a scan of the chunk sums, then
  // each thread adds its chunk's offset
  const int chunk = (n + THREADS - 1) / THREADS;
  const int j0 = min(tid * chunk, n), j1 = min(j0 + chunk, n);
  double run = 0.0;
  for (int j = j0; j < j1; ++j) {
    run += (double)expf(__fsub_rn(log_mask[j], m0));
    s_cdf[j] = run;
  }
  s_part[tid] = run;
  __syncthreads();
  if (tid == 0) {
    double acc = 0.0;
    for (int t = 0; t < THREADS; ++t) {
      const double v = s_part[t];
      s_part[t] = acc;
      acc += v;
    }
  }
  __syncthreads();
  const double off = s_part[tid];
  for (int j = j0; j < j1; ++j) s_cdf[j] += off;
  __syncthreads();
  const double total = s_cdf[n - 1];
  const uint64_t seed = key_seed(key);
  for (long long row = (long long)blockIdx.x * THREADS + tid; row < m;
       row += (long long)gridDim.x * THREADS) {
    const double t = (double)pick_uniform(row, seed) * total;
    int lo = 0, hi = n;  // the first n with cdf[n] > t
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cdf[mid] > t) hi = mid; else lo = mid + 1;
    }
    copy_row(data_x, lo < n ? lo : 0, row, dx, out);  // n: all weights 0
  }
}

// (hi, lo) += w by TwoSum: hi + lo carries the running sum to about 2^-48
// of it, so the sum of the chunk sums does not depend on rounding order.
__device__ __forceinline__ void ff_add(float& hi, float& lo, float w) {
  const float s = __fadd_rn(hi, w);
  const float bb = __fsub_rn(s, hi);
  lo = __fadd_rn(lo, __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(w, bb)));
  hi = s;
}

// (hi, lo) + p > (thi, tlo), the differences taken first (exact where the
// two sides are close).
__device__ __forceinline__ bool ff_above(float hi, float lo, float p,
                                         float thi, float tlo) {
  return __fadd_rn(__fadd_rn(__fsub_rn(hi, thi), __fsub_rn(lo, tlo)), p) > 0.f;
}

// s_n = -|r - P|^2 inv2p + lm of one support point whose feature d lies at
// pt[d * dstride] (a staged tile: stride TILE; a row of data_p: stride 1).
template <int MD>
__device__ __forceinline__ float pick_score(const float r[MD], const float* pt,
                                            int dstride, float lm, int dp,
                                            float inv2p) {
  if (dp == 0) return lm;
  float sq = 0.f;
#pragma unroll
  for (int d = 0; d < MD; ++d) {
    if (d < dp) {
      const float e = __fsub_rn(r[d], pt[d * dstride]);
      sq = __fadd_rn(sq, __fmul_rn(e, e));
    }
  }
  return __fadd_rn(__fmul_rn(-sq, inv2p), lm);
}

// Conditional pick (and a root past ROOT_CDF_MAX points). Pass 1 walks the
// staged support tiles once: each weight against a reference score `ref`,
// which moves up (rescaling what was summed) only when a score passes it by
// RESCALE, summed in float32 within chunks of `ch` points, each chunk's sum
// kept in the thread's column of s_chunk. Then t = u * (the chunks' sums,
// added in float-float); the first chunk whose running sum passes t holds
// the pick, and the thread walks only that chunk's points, re-reading them
// from global memory (L1: the support is kilobytes).
template <int MD>
__global__ void __launch_bounds__(THREADS)
kde_pick_cond_kernel(const float* __restrict__ p,
                     const float* __restrict__ data_p,
                     const float* __restrict__ data_x,
                     const float* __restrict__ log_mask,
                     const int64_t* __restrict__ key, int m, int n, int dp,
                     int dx, float inv2p, int ch, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_p = smem;                 // [dp][TILE]
  float* s_lm = s_p + dp * TILE;     // [TILE]
  float* s_chunk = s_lm + TILE;      // [n_chunks][THREADS]
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * THREADS + tid;
  const bool live = row < m;
  float r[MD];
#pragma unroll
  for (int d = 0; d < MD; ++d) r[d] = (live && d < dp) ? p[row * dp + d] : 0.f;
  const int sub = ch < TILE ? ch : TILE;  // ch divides TILE or is a multiple
  float ref = -3.402823466e38f, lim = -3.402823466e38f, acc = 0.f;
  int c = 0;  // chunks stored
  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int tn = min(TILE, n - t0);
    __syncthreads();  // the previous tile is read by every thread
    if (dp > 0) stage(s_p, data_p + (size_t)t0 * dp, tn, dp);
    for (int j = tid; j < tn; j += THREADS) s_lm[j] = log_mask[t0 + j];
    __syncthreads();
    for (int j0 = 0; j0 < tn; j0 += sub) {
      const int j1 = min(j0 + sub, tn);
      for (int j = j0; j < j1; ++j) {
        const float v = pick_score<MD>(r, s_p + j, TILE, s_lm[j], dp, inv2p);
        if (v > lim) {  // the first finite score, or one far above ref
          const float f = __expf(__fsub_rn(ref, v));
          for (int k = 0; k < c; ++k) s_chunk[k * THREADS + tid] *= f;
          acc *= f;
          ref = v;
          lim = __fadd_rn(v, RESCALE);
        }
        acc = __fadd_rn(acc, __expf(__fsub_rn(v, ref)));
      }
      if ((t0 + j1) % ch == 0 || t0 + j1 == n) {
        s_chunk[c * THREADS + tid] = acc;
        acc = 0.f;
        ++c;
      }
    }
  }
  if (!live) return;  // no barrier follows
  float shi = 0.f, slo = 0.f;
  for (int k = 0; k < c; ++k) ff_add(shi, slo, s_chunk[k * THREADS + tid]);
  const float u = pick_uniform(row, key_seed(key));
  const float thi = __fmul_rn(u, shi);
  const float tlo = fmaf(u, slo, fmaf(u, shi, -thi));
  // the first chunk whose running sum passes t; where rounding keeps every
  // one at or below t, the last chunk with weight (whose first point with
  // weight then passes the full sum's comparison)
  float bhi = 0.f, blo = 0.f;
  int k = 0, kw = 0;
  for (; k < c; ++k) {
    const float q = s_chunk[k * THREADS + tid];
    if (ff_above(bhi, blo, q, thi, tlo)) break;
    if (q > 0.f) kw = k;
    ff_add(bhi, blo, q);
  }
  if (k == c) k = kw;
  // walk the chunk: the first point whose running sum passes t; where
  // rounding keeps every sum at or below t, the last point that moved it
  const int n0 = k * ch, n1 = min(n0 + ch, n);
  float run = 0.f;
  int pick = -1, moved = n0;
  for (int q = n0; q < n1 && pick < 0; ++q) {
    const float before = run;
    run = __fadd_rn(run, __expf(__fsub_rn(
        pick_score<MD>(r, data_p + (size_t)q * dp, 1, log_mask[q], dp, inv2p),
        ref)));
    if (run != before) moved = q;
    if (ff_above(bhi, blo, run, thi, tlo)) pick = q;
  }
  copy_row(data_x, pick >= 0 ? pick : moved, row, dx, out);
}

// External-Gumbel pick (the JAX kernels' test hook): argmax_n of s_n + g_mn,
// the first index on ties.
template <int MD>
__global__ void __launch_bounds__(THREADS)
kde_pick_gumbel_kernel(const float* __restrict__ p,
                       const float* __restrict__ data_p,
                       const float* __restrict__ data_x,
                       const float* __restrict__ log_mask,
                       const float* __restrict__ gumbel, int m, int n, int dp,
                       int dx, float inv2p, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_p = smem;              // [dp][TILE]
  float* s_lm = s_p + dp * TILE;  // [TILE]
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < m;
  float r[MD];
#pragma unroll
  for (int d = 0; d < MD; ++d) r[d] = (live && d < dp) ? p[row * dp + d] : 0.f;
  float best = -INFINITY;
  int best_n = 0;
  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int tn = min(TILE, n - t0);
    __syncthreads();
    if (dp > 0) stage(s_p, data_p + (size_t)t0 * dp, tn, dp);
    for (int j = threadIdx.x; j < tn; j += THREADS) s_lm[j] = log_mask[t0 + j];
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      const float g = live ? gumbel[row * n + t0 + j] : 0.f;
      const float v =
          __fadd_rn(pick_score<MD>(r, s_p + j, TILE, s_lm[j], dp, inv2p), g);
      if (v > best) {
        best = v;
        best_n = t0 + j;
      }
    }
  }
  if (live) copy_row(data_x, best_n, row, dx, out);
}

// The instantiation for a feature count md (1 .. 32): the next power of
// two, or -1 past 32.
inline int pow2_at_least(int md) {
  int v = 1;
  while (v < md) v <<= 1;
  return v <= 32 ? v : -1;
}

template <int MX, int MP, bool COND>
cudaError_t go_direct(const float* x, const float* p, const float* data_x,
                      const float* data_p, const float* log_mask, int m, int n,
                      int dx, int dp, float sy, float sp, float c_stage,
                      float c_num, float* out, cudaStream_t st) {
  const size_t smem = (size_t)(MX + (COND ? MP : 0) + 1) * TILE * sizeof(float);
  auto kernel = kde_direct_kernel<MX, MP, COND>;
  cudaError_t e = vbn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(m + THREADS - 1) / THREADS, THREADS, smem, st>>>(
      x, p, data_x, data_p, log_mask, m, n, dx, dp, sy, sp, c_stage, c_num,
      out);
  return cudaGetLastError();
}

// The instantiation for MX = pow2(dx); MP = pow2(dp) for the conditional.
template <int MX, bool COND>
cudaError_t launch_direct_mp(const float* x, const float* p,
                             const float* data_x, const float* data_p,
                             const float* log_mask, int m, int n, int dx,
                             int dp, float sy, float sp, float c_stage,
                             float c_num, float* out, cudaStream_t st) {
  if constexpr (!COND) {
    return go_direct<MX, 1, false>(x, p, data_x, data_p, log_mask, m, n, dx,
                                   dp, sy, sp, c_stage, c_num, out, st);
  } else {
    switch (pow2_at_least(dp)) {
#define VBN_KDE_CASE(V)                                                     \
  case V:                                                                   \
    return go_direct<MX, V, COND>(x, p, data_x, data_p, log_mask, m, n, dx, \
                                  dp, sy, sp, c_stage, c_num, out, st);
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
}

template <bool COND>
cudaError_t launch_direct(const float* x, const float* p, const float* data_x,
                          const float* data_p, const float* log_mask, int m,
                          int n, int dx, int dp, float sy, float sp,
                          float c_stage, float c_num, float* out,
                          cudaStream_t st) {
  switch (pow2_at_least(dx)) {
#define VBN_KDE_CASE(V)                                                     \
  case V:                                                                   \
    return launch_direct_mp<V, COND>(x, p, data_x, data_p, log_mask, m, n,  \
                                     dx, dp, sy, sp, c_stage, c_num, out,   \
                                     st);
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

template <int MD>
cudaError_t go_pick(const float* p, const float* data_p, const float* data_x,
                    const float* log_mask, const int64_t* key,
                    const float* gumbel, int m, int n, int dp, int dx,
                    float inv2p, float* out, cudaStream_t st) {
  const size_t smem = (size_t)(dp + 1) * TILE * sizeof(float);
  const int grid = (m + THREADS - 1) / THREADS;
  if (gumbel != nullptr) {
    auto kernel = kde_pick_gumbel_kernel<MD>;
    cudaError_t e = vbn::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, THREADS, smem, st>>>(p, data_p, data_x, log_mask, gumbel,
                                        m, n, dp, dx, inv2p, out);
  } else {
    // chunks of ch points, at most PICK_CHUNKS a row: 64 (a quarter tile)
    // up to 2048 points, past that a whole number of tiles
    const int ch = n <= PICK_CHUNKS * 64
                       ? 64
                       : TILE * ((n + PICK_CHUNKS * TILE - 1) / (PICK_CHUNKS * TILE));
    const int n_chunks = (n + ch - 1) / ch;
    const size_t smem_c = smem + (size_t)n_chunks * THREADS * sizeof(float);
    auto kernel = kde_pick_cond_kernel<MD>;
    cudaError_t e = vbn::allow_smem(kernel, smem_c);
    if (e != cudaSuccess) return e;
    kernel<<<grid, THREADS, smem_c, st>>>(p, data_p, data_x, log_mask, key, m,
                                          n, dp, dx, inv2p, ch, out);
  }
  return cudaGetLastError();
}

cudaError_t launch_pick(const float* p, const float* data_p,
                        const float* data_x, const float* log_mask,
                        const int64_t* key, const float* gumbel, int m, int n,
                        int dp, int dx, float inv2p, float* out,
                        cudaStream_t st) {
  if (gumbel == nullptr && dp == 0 && n <= ROOT_CDF_MAX) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const size_t smem = (size_t)n * sizeof(double);
    e = vbn::allow_smem(kde_pick_root_kernel, smem);
    if (e != cudaSuccess) return e;
    const long long blocks = ((long long)m + THREADS - 1) / THREADS;
    const int grid = (int)(blocks < (long long)sms * ROOT_BLOCKS_PER_SM
                               ? blocks
                               : (long long)sms * ROOT_BLOCKS_PER_SM);
    kde_pick_root_kernel<<<grid, THREADS, smem, st>>>(data_x, log_mask, key,
                                                      m, n, dx, out);
    return cudaGetLastError();
  }
  switch (pow2_at_least(dp > 0 ? dp : 1)) {
#define VBN_KDE_CASE(V)                                                      \
  case V:                                                                    \
    return go_pick<V>(p, data_p, data_x, log_mask, key, gumbel, m, n, dp,  \
                      dx, inv2p, out, st);
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

// The direct kernels take the base-2 constants (ops/kde_fused.py::
// direct_consts): sy, sp = sqrt(log2(e) / 2h^2), cy, cp = log2(e) * const.
int vbn_kde_root(const float* x, const float* data_x, const float* log_mask,
                 int m, int n, int dx, float sy, float cy, float* out,
                 void* stream) {
  return (int)launch_direct<false>(x, nullptr, data_x, nullptr, log_mask, m, n,
                                   dx, 0, sy, 0.f, cy, 0.f, out,
                                   (cudaStream_t)stream);
}

int vbn_kde_cond(const float* x, const float* p, const float* data_x,
                 const float* data_p, const float* log_mask, int m, int n,
                 int dx, int dp, float sy, float sp, float cy, float cp,
                 float* out, void* stream) {
  return (int)launch_direct<true>(x, p, data_x, data_p, log_mask, m, n, dx, dp,
                                  sy, sp, cp, cy, out, (cudaStream_t)stream);
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
  return (int)launch_pick(p, data_p, data_x, log_mask, key, gumbel, m, n, dp,
                          dx, inv2p, out, (cudaStream_t)stream);
}

}  // extern "C"
