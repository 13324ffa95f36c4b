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
// logsumexp), on the SFU at 16 a clock per SM, beside a multiply-add per
// feature (2 float32 operations, or tensor-core work at the TF32 rate)
// and about 6 more. The TPU kernels held the [TM, N] logit
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
// vbn_kde_cond_wide (max(Dx, Dp) > 32): past 32 features a pair's two
// float32 operations a feature outweigh its two exps, so the features go
// to the tensor cores, by the expanded form |q - P|^2 = |q|^2 + |P|^2 -
// 2 q.P, in the same base-2 domain as the direct kernels:
// - The cross term by mma.sync m16n8k8 in TF32, three passes (big.big +
//   big.small + small.big, each operand split by cvt.rna.tf32.f32 into a
//   big part and the rounded rest), float32 accumulators: about float32
//   accuracy, where one TF32 pass misses the 1e-4 check by two orders.
// - The tensor core does not round to nearest: it aligns the products and
//   C to the largest exponent among them (a product's the sum of its
//   factors'), drops the bits past 25 below it, toward zero, and truncates
//   the sum (measured bit for bit on an H100; tests/test_torch_tf32.py
//   models it). Chained through C across the k-steps, each product loses
//   up to a quarter ulp of the running cross term, always toward zero.
//   The parents' errors enter both logsumexps and mostly cancel, so the
//   parents' k-steps chain, the big products' sum apart from the small
//   ones' where registers allow (two chains of dependent MMAs, not one;
//   wide_chains). The target's errors enter one logsumexp: with 35-40
//   target features and queries off the support they reached the 1e-4
//   check. So when the GEMM takes the target (mma3's STEP), each k-step's
//   three MMAs, the parents' too, start from zero, a product then loses at
//   most a quarter ulp of the k-step's largest, and the k-step's sum is
//   added to the accumulator by an FADD, rounded to nearest. The MMAs
//   are volatile asm, kept in program order: ptxas otherwise held every
//   k-step's sum at once and spilled.
// - Queries and support centred on the support's mean (over its live
//   points; kde_wide_mean_kernel, once a call) before the split: the
//   norms and the cross term then stay of the order of the spread, not of
//   the offset, which would cancel (+20 in every feature costs 1e-2).
// - The norms are summed in double from the centred float32 values and
//   rounded once. A target of at most WIDE_DIRECT_DX features (W4's one)
//   takes direct differences in the epilogue; a wider one joins the GEMM's
//   features after the parents', into accumulators of its own (the
//   numerator needs both sums, the denominator the parents' alone).
// - kde_wide_prep_kernel prepares the support once a call: its fragments
//   already doubled and split, in the m16n8k8 B layout, and a record a
//   point {-|P|^2, staged mask, target features} (the padding's mask
//   -inf).
// - Tiles: a block of eight warps takes 128 query rows, one m16 tile a
//   warp, whose fragments (big and small) stay in registers for up to
//   WKS_MAX k-steps (48 features; W4's 40 are five; fewer are padded to
//   WKS_MIN, as the served widths, past 32 features, never are). The
//   support goes by in stages of 128 points, copied into shared memory by
//   cp.async while the block works on the stage before (one LDS.128 a
//   lane a k-step and n8 tile feeds three MMAs). In a stage the n8 tiles
//   go one after another, the next one's MMAs started before this one's
//   terms. Past WKS_MAX k-steps the features go in chunks of WKS_CHUNK
//   (stages of 32 points), the query fragments loaded again for each
//   chunk.
// - Epilogue as in kde_direct_kernel: a term is -|q - P|^2 = 2 q.P -
//   |P|^2 - |q|^2, clamped at 0 where rounding leaves it above, plus the
//   staged mask; one ex2.approx a logsumexp against a lazily moved
//   reference (Lse2, same guard semantics), the slow path taken when a
//   thread's eight exponents pass the margin. A row's columns lie on a
//   quad of threads, each with its own states, merged by shuffles at the
//   end.
// The squared distances never leave registers; the bound is the two exps
// a pair, as for the direct conditional, with the feature work at the
// TF32 tensor rate. Measured apart (H100), the three passes alone take
// about as long as the terms alone, and the two add rather than overlap:
// an mma.sync warp runs its epilogue only after its MMAs, in order.
// wgmma (asynchronous, A from registers) overlapped them a little better,
// but its accumulators spilled at two blocks an SM and ran slower at one;
// A from shared memory would free those registers (later work).

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
// tensor `key` (no host sync per node), counter (g, g >> 32, 0, 2), word
// 0, u = min(((bits >> 8) + 0.5) 2^-24, 1 - 2^-24), where g is the row's
// global flat row (RowMap: base + (row / s_loc) * stride + row % s_loc; a
// mesh rank's block of rows and particles draws the unmeshed uniforms, and
// an unmeshed call passes base 0, s_loc = stride, so g = row);
// ops/kde_fused.py's pick_uniforms rebuilds it in torch.
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
//
// The read flag (vbn_kde_root, vbn_kde_cond, the conditional pick): a
// caller that reads a launch's result on some query rows only (the
// per-node dynamic sweep keeps a node's log-density on its evidence rows
// and its pick on its free rows) passes `read`, a float per query row of
// any stride, and the launch's rows a query row (s): launch row r is read
// when read[(r / s) * stride] is nonzero. A block none of whose live rows
// is read returns before it loads a query or stages a support point (one
// __syncthreads_or, block-uniform, so a block that straddles query rows
// stays whole); every unread row's output is 0, and the arithmetic of a
// read row is that of the launch without a flag. Row numbers are the
// launch's own, so the pick's RowMap counters do not move. A null `read`
// is the unflagged kernel. The root pick and the Gumbel pick take no
// flag (ops/kde_fused.py drops it there), nor does vbn_kde_cond_wide.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vbn_common.cuh"

namespace {

constexpr int THREADS = 256;     // query rows per block
constexpr int TILE = 256;        // support points per shared-memory tile
constexpr int WIDE_THREADS = 256;  // wide: eight warps of 16 query rows
constexpr int WIDE_ROWS = 128;     // wide: query rows per block
constexpr int WT_RESIDENT = 128;   // wide: support points a stage
constexpr int WT_CHUNKED = 32;     // wide: the same, features in chunks
constexpr int WKS_MAX = 6;         // wide: k-steps of query fragments in registers
constexpr int WKS_MIN = 5;         // wide: the same, at least (past 32 features)
constexpr int WKS_CHUNK = 4;       // wide: k-steps a chunk past WKS_MAX
constexpr int WIDE_DIRECT_DX = 2;  // wide: targets up to this take direct differences
constexpr int WIDE_PREP_THREADS = 256;
constexpr float WIDE_LIVE_MASK = -30.f;  // wide: points the mean counts
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

// The conditional pick at 32 features holds them and its sums in
// registers; without a minimum of blocks ptxas spilled 16 bytes there.
__host__ __device__ constexpr int kde_pick_min_blocks(int md) {
  return md > 16 ? 2 : 1;
}

// The read flag of a launch (see the note at the top); p null: every row.
struct ReadFlag {
  const float* p;
  long long stride;
  int s;
};

// Whether live launch row `row` is read.
__device__ __forceinline__ bool is_read(const ReadFlag& rd, long long row) {
  return rd.p[(row / rd.s) * rd.stride] != 0.f;
}

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
                  ReadFlag rd, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                          // [MX][TILE]
  float* s_p = s_x + MX * TILE;               // [MP][TILE] (COND)
  float* s_lm = s_p + (COND ? MP : 0) * TILE; // [TILE]
  const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < m;
  bool want = live;
  if (rd.p != nullptr) {
    want = live && is_read(rd, row);
    if (!__syncthreads_or(want)) {  // no row of the block is read
      if (live) out[row] = 0.f;
      return;
    }
  }
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
    out[row] = !want ? 0.f
                     : COND ? num.value(c_num) - den.value(0.f) : num.value(0.f);
}

// ---------------------------------------------------------------------------
// vbn_kde_cond_wide: squared distances by the expanded form on the tensor
// cores (see the note at the top)
// ---------------------------------------------------------------------------

// One call's layout. The GEMM's features are the parents' (kp k-steps of
// 8, zeros past Dp), then, when Dx passes WIDE_DIRECT_DX, the target's
// (zeros past Dx); a target of dxd <= WIDE_DIRECT_DX features takes direct
// differences instead. Up to WKS_MAX k-steps the kernel holds all of a
// row's query fragments in registers (ks = kt, at least WKS_MIN); past
// that it takes them in chunks of WKS_CHUNK k-steps (kt_pad, a whole
// number of chunks; the padding zeros). The scratch the wrapper allocates
// holds the support's fragments [n_pad / 8 n8 tiles][kt_pad][32 lanes]
// float4, its records [n_pad] float4 {-|P_p|^2, mask, f0, f1} (f: the
// direct target features, or -|P_x|^2 when the GEMM takes the target) and
// the feature means [dp + dx], in that order.
struct WideLayout {
  int dxd, kp, kt, ks, kt_pad, nchunks, n_pad;
  size_t rec, mu, floats;  // float offsets into the scratch
};

__host__ __device__ inline WideLayout wide_layout(int n, int dx, int dp) {
  WideLayout l;
  l.dxd = dx <= WIDE_DIRECT_DX ? dx : 0;
  l.kp = (dp + 7) / 8;
  l.kt = l.kp + (l.dxd ? 0 : (dx + 7) / 8);
  l.ks = l.kt <= WKS_MAX ? (l.kt > WKS_MIN ? l.kt : WKS_MIN) : WKS_CHUNK;
  l.kt_pad = (l.kt + l.ks - 1) / l.ks * l.ks;
  l.nchunks = l.kt_pad / l.ks;
  l.n_pad = (n + WT_RESIDENT - 1) / WT_RESIDENT * WT_RESIDENT;
  l.rec = (size_t)(l.n_pad / 8) * l.kt_pad * 32 * 4;
  l.mu = l.rec + 4 * (size_t)l.n_pad;
  l.floats = l.mu + dp + dx;
  return l;
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d += a b on the tensor cores: m16n8k8, TF32 inputs, float32 accumulators
// (volatile: the MMAs stay in program order).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of 3xTF32 with b = {big b0, big b1, small b0, small b1}
// (small.small, 2^-22 of the product, is left out). STEP: small.big,
// big.small, then big.big from zero, the k-step's sum added to d[0] by an
// FADD (see the note at the top). Else chained: big.big into d[0],
// small.big and big.small into d[C - 1]; two accumulators (C = 2) halve
// the chain of dependent MMAs and keep the small products' sum apart from
// the big.
template <int C, bool STEP>
__device__ __forceinline__ void mma3(float (&d)[C][4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float4 b) {
  const uint32_t bb0 = __float_as_uint(b.x), bb1 = __float_as_uint(b.y);
  if (STEP) {
    float k[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(k, as, bb0, bb1);
    mma_tf32(k, ab, __float_as_uint(b.z), __float_as_uint(b.w));
    mma_tf32(k, ab, bb0, bb1);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[0][e] += k[e];
    return;
  }
  mma_tf32(d[C - 1], as, bb0, bb1);
  mma_tf32(d[0], ab, bb0, bb1);
  mma_tf32(d[C - 1], ab, __float_as_uint(b.z), __float_as_uint(b.w));
}

// An n8 tile's cross term from its accumulators: the big sum plus the small.
template <int C>
__device__ __forceinline__ float cross(const float (&d)[C][4], int e) {
  return C > 1 ? d[0][e] + d[C - 1][e] : d[0][e];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Feature f of a row in the GEMM's order (parents, then dxg target
// features), centred on the support's mean and scaled to base 2; 0 in the
// padding.
__device__ __forceinline__ float wide_feature(const float* __restrict__ p_row,
                                             const float* __restrict__ x_row,
                                             const float* __restrict__ mu,
                                             int f, int kp, int dp, int dxg,
                                             float sp, float sy) {
  if (f < kp * 8) return f < dp ? (p_row[f] - mu[f]) * sp : 0.f;
  f -= kp * 8;
  return f < dxg ? (x_row[f] - mu[dp + f]) * sy : 0.f;
}

// The squared norm of a row's features [f0, f1) in the GEMM's order, summed
// in double and rounded once (the features as the GEMM takes them).
__device__ __forceinline__ float wide_norm(const float* __restrict__ p_row,
                                           const float* __restrict__ x_row,
                                           const float* __restrict__ mu,
                                           int f0, int f1, int kp, int dp,
                                           int dxg, float sp, float sy) {
  double acc = 0.0;
  for (int f = f0; f < f1; ++f) {
    const double v = wide_feature(p_row, x_row, mu, f, kp, dp, dxg, sp, sy);
    acc = fma(v, v, acc);
  }
  return (float)acc;
}

// Column means of the support over the points whose mask passes
// WIDE_LIVE_MASK (over all points where none does): one block a column,
// a fixed-order tree sum. The parents' columns, then the target's when
// the GEMM takes them.
__global__ void __launch_bounds__(WIDE_PREP_THREADS)
kde_wide_mean_kernel(const float* __restrict__ data_p,
                     const float* __restrict__ data_x,
                     const float* __restrict__ log_mask, int n, int dp,
                     int dx, float* __restrict__ mu) {
  __shared__ float s_sum[WIDE_PREP_THREADS], s_live[WIDE_PREP_THREADS],
      s_all[WIDE_PREP_THREADS];
  const int c = blockIdx.x, tid = threadIdx.x;
  const float* src = c < dp ? data_p + c : data_x + (c - dp);
  const int d = c < dp ? dp : dx;
  float sum = 0.f, live = 0.f, all = 0.f;
  for (int j = tid; j < n; j += WIDE_PREP_THREADS) {
    const float v = src[(size_t)j * d];
    all += v;
    if (log_mask[j] > WIDE_LIVE_MASK) {
      sum += v;
      live += 1.f;
    }
  }
  s_sum[tid] = sum;
  s_live[tid] = live;
  s_all[tid] = all;
  __syncthreads();
  for (int w = WIDE_PREP_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) {
      s_sum[tid] += s_sum[tid + w];
      s_live[tid] += s_live[tid + w];
      s_all[tid] += s_all[tid + w];
    }
    __syncthreads();
  }
  if (tid == 0)
    mu[c] = s_live[0] > 0.f ? s_sum[0] / s_live[0] : s_all[0] / (float)n;
}

// One thread a support point (n_pad of them; the padding has mask -inf):
// its record {-|P_p|^2, mask, f0, f1} (the squared norm of its centred,
// scaled parents; the mask and constant in base 2; its scaled direct
// target features, or -|P_x|^2), and its fragments: the centred, scaled
// features doubled (so the product is the 2 q.P of the expanded form) and
// split into TF32 big and small parts, in the m16n8k8 B layout (lane
// 4 (j % 8) + t holds features 8k + t and 8k + t + 4).
__global__ void __launch_bounds__(WIDE_PREP_THREADS)
kde_wide_prep_kernel(const float* __restrict__ data_x,
                     const float* __restrict__ data_p,
                     const float* __restrict__ log_mask, int n, int dx,
                     int dp, WideLayout l, float sy, float sp, float c_stage,
                     float* __restrict__ scratch) {
  const int j = blockIdx.x * WIDE_PREP_THREADS + threadIdx.x;
  if (j >= l.n_pad) return;
  const bool live = j < n;
  const int dxg = l.dxd ? 0 : dx;
  const float* mu = scratch + l.mu;
  const float* pr = data_p + (size_t)(live ? j : 0) * dp;
  const float* xr = data_x + (size_t)(live ? j : 0) * dx;
  float4 rec = make_float4(0.f, -INFINITY, 0.f, 0.f);
  if (live) {
    rec.x = -wide_norm(pr, xr, mu, 0, dp, l.kp, dp, dxg, sp, sy);
    rec.y = fmaf(log_mask[j], LOG2E, c_stage);
    if (l.dxd) {
      rec.z = xr[0] * sy;
      if (l.dxd > 1) rec.w = xr[1] * sy;
    } else {
      rec.z = -wide_norm(pr, xr, mu, 8 * l.kp, 8 * l.kp + dx, l.kp, dp, dxg,
                         sp, sy);
    }
  }
  reinterpret_cast<float4*>(scratch + l.rec)[j] = rec;
  float4* frag = reinterpret_cast<float4*>(scratch);
  const int lane0 = 4 * (j % 8);
  for (int k = 0; k < l.kt_pad; ++k) {
    for (int t = 0; t < 4; ++t) {
      float v[2];
      for (int i = 0; i < 2; ++i)
        v[i] = live ? 2.f * wide_feature(pr, xr, mu, 8 * k + t + 4 * i, l.kp,
                                         dp, dxg, sp, sy)
                    : 0.f;
      const uint32_t b0 = tf32(v[0]), b1 = tf32(v[1]);
      frag[((size_t)(j / 8) * l.kt_pad + k) * 32 + lane0 + t] =
          make_float4(__uint_as_float(b0), __uint_as_float(b1),
                      __uint_as_float(tf32(v[0] - __uint_as_float(b0))),
                      __uint_as_float(tf32(v[1] - __uint_as_float(b1))));
    }
  }
}

// The numerator's term from v = the denominator's (or it less a
// reference): plus the target's -|q - P|^2, from the GEMM (clamped at 0)
// or by direct differences.
template <int DXD, int NX>
__device__ __forceinline__ float wide_num(float v, float acc_x, float4 r,
                                          const float (&ax)[NX], float qx) {
  if (DXD == 0) return v + fminf(acc_x + r.z - qx, 0.f);
#pragma unroll
  for (int f = 0; f < DXD; ++f) {
    const float d = ax[f] - (f ? r.w : r.z);
    v = fmaf(-d, d, v);
  }
  return v;
}

// The four pairs of one thread in an m16n8 tile: rows g and g + 8 (h),
// columns col and col + 1 (c, records r[c]); accumulator e = 2h + c.
// acc[0] holds 2 q.P of the parents, acc[1] of the target (DXD = 0); qd,
// qx: the rows' squared norms; ax: their direct target features. A term:
// -|q - P|^2 = 2 q.P - |P|^2 - |q|^2, clamped at 0, plus the mask.
template <int DXD, int C, int NX = DXD ? DXD : 1>
__device__ __forceinline__ void wide_terms(const float (&acc)[2][C][4],
                                           const float4 (&r)[2],
                                           const float (&ax)[2][NX],
                                           const float (&qd)[2],
                                           const float (&qx)[2],
                                           Lse2 (&den)[2], Lse2 (&num)[2]) {
  float acc_p[4], acc_x[4], kp[4], vp[4], vn[4];  // kp: the denominator's terms
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int h = e >> 1, c = e & 1;
    acc_p[e] = cross<C>(acc[0], e);
    acc_x[e] = DXD ? 0.f : cross<C>(acc[1], e);
    kp[e] = fminf(acc_p[e] + r[c].x - qd[h], 0.f) + r[c].y;
    vp[e] = kp[e] - den[h].ref;
    vn[e] = wide_num<DXD>(kp[e] - num[h].ref, acc_x[e], r[c], ax[h], qx[h]);
  }
  const float mx = fmaxf(fmaxf(fmaxf(vp[0], vp[1]), fmaxf(vp[2], vp[3])),
                         fmaxf(fmaxf(vn[0], vn[1]), fmaxf(vn[2], vn[3])));
  if (mx > LSE_MARGIN) {
    // rare: a term passes its reference by the margin (every row's first
    // terms over the guard): the four one by one
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = e & 1;
      den[h].add(kp[e]);
      num[h].add(wide_num<DXD>(kp[e], acc_x[e], r[c], ax[h], qx[h]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      den[e >> 1].s += ex2(vp[e]);
      num[e >> 1].s += ex2(vn[e]);
    }
  }
}

// The four lanes of a quad hold one row's columns: merge their states.
__device__ __forceinline__ void quad_merge(Lse2& a) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float r2 = __shfl_xor_sync(0xffffffffu, a.ref, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, a.s, o);
    const float r = fmaxf(a.ref, r2);
    a.s = a.s * ex2(a.ref - r) + s2 * ex2(r2 - r);
    a.ref = r;
  }
}

// Accumulators an n8 tile: two (the big products apart from the small)
// while the query fragments (8 registers a k-step), the accumulators and
// the target features fit the 128 registers of two blocks an SM; past
// that ptxas spilled, and one accumulator leaves room. When the GEMM
// takes the target (dxd = 0: STEP) it is always one, the k-step's sum
// taking the second's registers.
__host__ __device__ constexpr int wide_chains(int ks, int dxd, bool chunked) {
  return 8 * ks + (dxd ? 4 * (dxd - 1) : 16) + (chunked ? 16 : 0) <= 40 ? 2
                                                                        : 1;
}

// Support points a stage: WT_RESIDENT, half of it at WKS_MAX k-steps held
// at once (the unrolled stage's addresses spilled there), WT_CHUNKED in
// chunks.
__host__ __device__ constexpr int wide_tile(int ks, bool chunked) {
  return chunked ? WT_CHUNKED : ks < WKS_MAX ? WT_RESIDENT : WT_RESIDENT / 2;
}

// Dynamic shared memory of the wide kernel: two stages of fragments and
// two tiles of records (more than the 48 KB of static shared memory).
template <int KS, bool CHUNKED>
constexpr size_t wide_smem() {
  constexpr int wt = wide_tile(KS, CHUNKED);
  return (2 * (wt / 8) * KS * 32 + 2 * wt) * sizeof(float4);
}

// The wide conditional: KS k-steps of query fragments in registers, DXD
// target features by direct differences (0: the GEMM takes the target);
// CHUNKED: the features in nchunks chunks of KS k-steps, else all at once.
// Each warp takes 16 query rows (one m16 tile), the block 128. The support
// goes by in stages (a tile of WT points, and a chunk of its features),
// each copied into shared memory by cp.async while the block works on the
// one before. Held at once (not CHUNKED), the n8 tiles of a stage go one
// after another, the next one's MMAs started before this one's terms (the
// tensor cores may work while the epilogue runs); in chunks, every n8 tile's
// accumulators carry over the chunks and the terms follow the last.
template <int KS, int DXD, bool CHUNKED>
__global__ void __launch_bounds__(WIDE_THREADS, 2)
kde_wide_kernel(const float* __restrict__ x, const float* __restrict__ p,
                const float* __restrict__ scratch, int m, int dx, int dp,
                WideLayout l, float sy, float sp, float c_num,
                float* __restrict__ out) {
  constexpr bool XG = DXD == 0;
  constexpr int NX = DXD ? DXD : 1;
  constexpr int C = wide_chains(KS, DXD, CHUNKED);
  constexpr int WT = wide_tile(KS, CHUNKED);
  constexpr int WNB = WT / 8;
  constexpr int STAGE = WNB * KS * 32;  // float4 of fragments a stage
  static_assert(STAGE % WIDE_THREADS == 0, "a stage is whole float4s a thread");
  // wide_smem<KS, CHUNKED>() bytes: the fragments [stage & 1][n8 tile]
  // [k-step][lane], then the records [tile & 1][point]
  extern __shared__ float4 s_wide[];
  float4* const s_rec = s_wide + 2 * STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int dxg = XG ? dx : 0;
  const float* mu = scratch + l.mu;
  const float4* frag = reinterpret_cast<const float4*>(scratch);
  const float4* rec = reinterpret_cast<const float4*>(scratch + l.rec);
  // this thread's rows: row0 + 8 h
  const long long row0 = (long long)blockIdx.x * WIDE_ROWS + warp * 16 + g;
  float qd[2], qx[2], ax[2][NX];
  Lse2 den[2], num[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row0 + 8 * h;
    const bool live = r < m;
    const float* pr = p + (live ? r : 0) * dp;
    const float* xr = x + (live ? r : 0) * dx;
    qd[h] = live ? wide_norm(pr, xr, mu, 0, dp, l.kp, dp, dxg, sp, sy) : 0.f;
    qx[h] = live && XG ? wide_norm(pr, xr, mu, 8 * l.kp, 8 * l.kp + dx, l.kp,
                                   dp, dxg, sp, sy)
                       : 0.f;
#pragma unroll
    for (int f = 0; f < NX; ++f) ax[h][f] = (DXD && live) ? xr[f] * sy : 0.f;
    den[h].init();
    num[h].init();
  }
  // the query fragments (m16n8k8 A layout: a_i at row g + 8 (i & 1),
  // feature 8k + t + 4 (i >> 1)), split into TF32 big and small parts
  uint32_t a_big[KS][4], a_small[KS][4];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = row0 + 8 * (i & 1);
        const float v =
            r < m ? wide_feature(p + r * dp, x + r * dx, mu,
                                 8 * (k0 + ks) + t + 4 * (i >> 1), l.kp, dp,
                                 dxg, sp, sy)
                  : 0.f;
        a_big[ks][i] = tf32(v);
        a_small[ks][i] = tf32(v - __uint_as_float(a_big[ks][i]));
      }
    }
  };
  // stage st: tile st / nchunks, chunk st % nchunks
  auto fetch = [&](int st) {
    const int tile = st / l.nchunks, c = st - tile * l.nchunks;
#pragma unroll
    for (int it = 0; it < STAGE / WIDE_THREADS; ++it) {
      const int i = it * WIDE_THREADS + tid;
      const int nb = i / (KS * 32), k = (i / 32) % KS;
      cp_async16(s_wide + (st & 1) * STAGE + i,
                 frag + ((size_t)(tile * WNB + nb) * l.kt_pad + c * KS + k) * 32 +
                     (i & 31));
    }
    if (c == 0 && tid < WT)
      cp_async16(s_rec + (tile & 1) * WT + tid, rec + (size_t)tile * WT + tid);
    cp_async_commit();
  };
  // the MMAs of n8 tile nb, k-steps k0.. of this stage, into acc (p, x)
  auto mmas = [&](const float4* sf, int nb, int k0, float (&acc)[2][C][4]) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float4 b = sf[(nb * KS + ks) * 32 + lane];
      if (!XG || k0 + ks < l.kp)
        mma3<C, XG>(acc[0], a_big[ks], a_small[ks], b);
      else
        mma3<C, XG>(acc[1], a_big[ks], a_small[ks], b);
    }
  };
  auto terms = [&](const float4* sr, int nb, const float (&acc)[2][C][4]) {
    const int col = nb * 8 + 2 * t;
    const float4 r[2] = {sr[col], sr[col + 1]};
    wide_terms<DXD, C>(acc, r, ax, qd, qx, den, num);
  };
  auto zero = [](float (&acc)[2][C][4]) {
#pragma unroll
    for (int i = 0; i < 2 * C * 4; ++i) acc[i / (C * 4)][(i / 4) % C][i % 4] = 0.f;
  };
  const int stages = l.n_pad / WT * l.nchunks;
  // [n8 tile (chunked) or its parity][parents, target][chain][element]
  float acc[CHUNKED ? WNB : 2][2][C][4];
  if (!CHUNKED) load_a(0);
  fetch(0);
  for (int st = 0; st < stages; ++st) {
    const int tile = st / l.nchunks, c = st - tile * l.nchunks;
    if (st + 1 < stages) {
      fetch(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage st is in shared memory for every warp
    const float4* sf = s_wide + (st & 1) * STAGE;
    const float4* sr = s_rec + (tile & 1) * WT;
    if (!CHUNKED) {
      zero(acc[0]);
      mmas(sf, 0, 0, acc[0]);
#pragma unroll
      for (int nb = 0; nb < WNB; ++nb) {
        if (nb + 1 < WNB) {
          zero(acc[(nb + 1) & 1]);
          mmas(sf, nb + 1, 0, acc[(nb + 1) & 1]);
        }
        terms(sr, nb, acc[nb & 1]);
      }
    } else {
      if (c == 0) {
#pragma unroll
        for (int nb = 0; nb < (CHUNKED ? WNB : 2); ++nb) zero(acc[nb]);
      }
      load_a(c * KS);
#pragma unroll
      for (int nb = 0; nb < (CHUNKED ? WNB : 2); ++nb) mmas(sf, nb, c * KS, acc[nb]);
      if (c == l.nchunks - 1) {
#pragma unroll
        for (int nb = 0; nb < (CHUNKED ? WNB : 2); ++nb) terms(sr, nb, acc[nb]);
      }
    }
    __syncthreads();  // every warp is done with stage st's buffers
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    quad_merge(den[h]);
    quad_merge(num[h]);
    const long long r = row0 + 8 * h;
    if (t == 0 && r < m) out[r] = num[h].value(c_num) - den[h].value(0.f);
  }
}

// A launch's rows in the global flat order of the batch (see the note at
// the top): row -> base + (row / s_loc) * stride + row % s_loc.
struct RowMap {
  long long base, stride;
  int s_loc;
};

// The pick's uniform of query row `row` (see the note at the top).
__device__ __forceinline__ float pick_uniform(long long row, uint64_t seed,
                                              const RowMap& rm) {
  const unsigned long long g =
      (unsigned long long)(rm.base + (row / rm.s_loc) * rm.stride + row % rm.s_loc);
  uint32_t c[4] = {(uint32_t)g, (uint32_t)(g >> 32), 0u, 2u};
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

__device__ __forceinline__ void zero_row(long long row, int dx,
                                         float* __restrict__ out) {
  for (int f = 0; f < dx; ++f) out[row * dx + f] = 0.f;
}

// Root pick (Dp = 0, N <= ROOT_CDF_MAX): the CDF of the masked weights in
// shared memory, in double, and a binary search per row.
__global__ void __launch_bounds__(THREADS)
kde_pick_root_kernel(const float* __restrict__ data_x,
                     const float* __restrict__ log_mask,
                     const int64_t* __restrict__ key, RowMap rm,
                     long long m, int n, int dx, float* __restrict__ out) {
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
    const double t = (double)pick_uniform(row, seed, rm) * total;
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
__global__ void __launch_bounds__(THREADS, kde_pick_min_blocks(MD))
kde_pick_cond_kernel(const float* __restrict__ p,
                     const float* __restrict__ data_p,
                     const float* __restrict__ data_x,
                     const float* __restrict__ log_mask,
                     const int64_t* __restrict__ key, RowMap rm, int m,
                     int n, int dp, int dx, float inv2p, int ch, ReadFlag rd,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_p = smem;                 // [dp][TILE]
  float* s_lm = s_p + dp * TILE;     // [TILE]
  float* s_chunk = s_lm + TILE;      // [n_chunks][THREADS]
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * THREADS + tid;
  const bool live = row < m;
  bool want = live;
  if (rd.p != nullptr) {
    want = live && is_read(rd, row);
    if (!__syncthreads_or(want)) {  // no row of the block is read
      if (live) zero_row(row, dx, out);
      return;
    }
  }
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
  if (!want) {
    zero_row(row, dx, out);
    return;
  }
  float shi = 0.f, slo = 0.f;
  for (int k = 0; k < c; ++k) ff_add(shi, slo, s_chunk[k * THREADS + tid]);
  const float u = pick_uniform(row, key_seed(key), rm);
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
                      float c_num, ReadFlag rd, float* out, cudaStream_t st) {
  const size_t smem = (size_t)(MX + (COND ? MP : 0) + 1) * TILE * sizeof(float);
  auto kernel = kde_direct_kernel<MX, MP, COND>;
  cudaError_t e = vbn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(m + THREADS - 1) / THREADS, THREADS, smem, st>>>(
      x, p, data_x, data_p, log_mask, m, n, dx, dp, sy, sp, c_stage, c_num,
      rd, out);
  return cudaGetLastError();
}

// The instantiation for MX = pow2(dx); MP = pow2(dp) for the conditional.
template <int MX, bool COND>
cudaError_t launch_direct_mp(const float* x, const float* p,
                             const float* data_x, const float* data_p,
                             const float* log_mask, int m, int n, int dx,
                             int dp, float sy, float sp, float c_stage,
                             float c_num, ReadFlag rd, float* out,
                             cudaStream_t st) {
  if constexpr (!COND) {
    return go_direct<MX, 1, false>(x, p, data_x, data_p, log_mask, m, n, dx,
                                   dp, sy, sp, c_stage, c_num, rd, out, st);
  } else {
    switch (pow2_at_least(dp)) {
#define VBN_KDE_CASE(V)                                                     \
  case V:                                                                   \
    return go_direct<MX, V, COND>(x, p, data_x, data_p, log_mask, m, n, dx, \
                                  dp, sy, sp, c_stage, c_num, rd, out, st);
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
                          float c_stage, float c_num, ReadFlag rd, float* out,
                          cudaStream_t st) {
  switch (pow2_at_least(dx)) {
#define VBN_KDE_CASE(V)                                                     \
  case V:                                                                   \
    return launch_direct_mp<V, COND>(x, p, data_x, data_p, log_mask, m, n,  \
                                     dx, dp, sy, sp, c_stage, c_num, rd,    \
                                     out, st);
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

template <int KS, int DXD, bool CHUNKED>
cudaError_t go_wide(const float* x, const float* p, const float* scratch,
                    int m, int dx, int dp, const WideLayout& l, float sy,
                    float sp, float c_num, float* out, cudaStream_t st) {
  auto kernel = kde_wide_kernel<KS, DXD, CHUNKED>;
  constexpr size_t smem = wide_smem<KS, CHUNKED>();
  cudaError_t e = vbn::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(m + WIDE_ROWS - 1) / WIDE_ROWS, WIDE_THREADS, smem, st>>>(
      x, p, scratch, m, dx, dp, l, sy, sp, c_num, out);
  return cudaGetLastError();
}

template <int DXD>
cudaError_t launch_wide_ks(const float* x, const float* p,
                           const float* scratch, int m, int dx, int dp,
                           const WideLayout& l, float sy, float sp,
                           float c_num, float* out, cudaStream_t st) {
  if (l.nchunks > 1)
    return go_wide<WKS_CHUNK, DXD, true>(x, p, scratch, m, dx, dp, l, sy, sp,
                                         c_num, out, st);
  switch (l.ks) {
#define VBN_WIDE_CASE(V)                                                   \
  case V:                                                                  \
    return go_wide<V, DXD, false>(x, p, scratch, m, dx, dp, l, sy, sp,     \
                                  c_num, out, st);
    VBN_WIDE_CASE(5)
    VBN_WIDE_CASE(6)
#undef VBN_WIDE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The wide conditional's three launches: the support's means, its
// records and fragments, then the kernel.
cudaError_t launch_wide(const float* x, const float* p, const float* data_x,
                        const float* data_p, const float* log_mask, int m,
                        int n, int dx, int dp, float sy, float sp,
                        float c_stage, float c_num, float* scratch,
                        float* out, cudaStream_t st) {
  const WideLayout l = wide_layout(n, dx, dp);
  kde_wide_mean_kernel<<<dp + (l.dxd ? 0 : dx), WIDE_PREP_THREADS, 0, st>>>(
      data_p, data_x, log_mask, n, dp, dx, scratch + l.mu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kde_wide_prep_kernel<<<(l.n_pad + WIDE_PREP_THREADS - 1) / WIDE_PREP_THREADS,
                         WIDE_PREP_THREADS, 0, st>>>(
      data_x, data_p, log_mask, n, dx, dp, l, sy, sp, c_stage, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (l.dxd) {
    case 0:
      return launch_wide_ks<0>(x, p, scratch, m, dx, dp, l, sy, sp, c_num, out, st);
    case 1:
      return launch_wide_ks<1>(x, p, scratch, m, dx, dp, l, sy, sp, c_num, out, st);
    case 2:
      return launch_wide_ks<2>(x, p, scratch, m, dx, dp, l, sy, sp, c_num, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// A test hook: d = c + a b by one mma_tf32 a warp (the wide kernel's
// instruction), `warps` tiles of a [16 x 8] row-major, b [8 x 8] (b[k][n]),
// c and d [16 x 8], the inputs already TF32. The tests hold it bit for bit
// against their model of the tensor core's rounding.
__global__ void kde_mma_probe_kernel(const float* __restrict__ a,
                                     const float* __restrict__ b,
                                     const float* __restrict__ c,
                                     float* __restrict__ d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  a += blockIdx.x * 128;
  b += blockIdx.x * 64;
  c += blockIdx.x * 128;
  d += blockIdx.x * 128;
  const uint32_t af[4] = {
      __float_as_uint(a[g * 8 + t]), __float_as_uint(a[(g + 8) * 8 + t]),
      __float_as_uint(a[g * 8 + t + 4]), __float_as_uint(a[(g + 8) * 8 + t + 4])};
  // accumulator e at row g + 8 (e >> 1), column 2t + (e & 1)
  float acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = c[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)];
  mma_tf32(acc, af, __float_as_uint(b[t * 8 + g]),
           __float_as_uint(b[(t + 4) * 8 + g]));
#pragma unroll
  for (int e = 0; e < 4; ++e) d[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = acc[e];
}

template <int MD>
cudaError_t go_pick(const float* p, const float* data_p, const float* data_x,
                    const float* log_mask, const int64_t* key, RowMap rm,
                    const float* gumbel, int m, int n, int dp, int dx,
                    float inv2p, ReadFlag rd, float* out, cudaStream_t st) {
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
    kernel<<<grid, THREADS, smem_c, st>>>(p, data_p, data_x, log_mask, key,
                                          rm, m, n, dp, dx, inv2p, ch, rd, out);
  }
  return cudaGetLastError();
}

cudaError_t launch_pick(const float* p, const float* data_p,
                        const float* data_x, const float* log_mask,
                        const int64_t* key, RowMap rm, const float* gumbel,
                        int m, int n, int dp, int dx, float inv2p,
                        ReadFlag rd, float* out, cudaStream_t st) {
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
                                                      rm, m, n, dx, out);
    return cudaGetLastError();
  }
  switch (pow2_at_least(dp > 0 ? dp : 1)) {
#define VBN_KDE_CASE(V)                                                      \
  case V:                                                                    \
    return go_pick<V>(p, data_p, data_x, log_mask, key, rm, gumbel, m, n,  \
                      dp, dx, inv2p, rd, out, st);
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
// read (null: every row), read_stride, read_s: the read flag (see the note
// at the top), as vbn_kde_pick takes it too.
int vbn_kde_root(const float* x, const float* data_x, const float* log_mask,
                 int m, int n, int dx, float sy, float cy, const float* read,
                 long long read_stride, int read_s, float* out, void* stream) {
  if (read_s < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_direct<false>(x, nullptr, data_x, nullptr, log_mask, m, n,
                                   dx, 0, sy, 0.f, cy, 0.f,
                                   ReadFlag{read, read_stride, read_s}, out,
                                   (cudaStream_t)stream);
}

int vbn_kde_cond(const float* x, const float* p, const float* data_x,
                 const float* data_p, const float* log_mask, int m, int n,
                 int dx, int dp, float sy, float sp, float cy, float cp,
                 const float* read, long long read_stride, int read_s,
                 float* out, void* stream) {
  if (read_s < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_direct<true>(x, p, data_x, data_p, log_mask, m, n, dx, dp,
                                  sy, sp, cp, cy,
                                  ReadFlag{read, read_stride, read_s}, out,
                                  (cudaStream_t)stream);
}

// The wide conditional takes the base-2 constants too, and a scratch of
// vbn_kde_cond_wide_scratch(n, dx, dp) floats (16-byte aligned).
long long vbn_kde_cond_wide_scratch(int n, int dx, int dp) {
  return (long long)wide_layout(n, dx, dp).floats;
}

int vbn_kde_cond_wide(const float* x, const float* p, const float* data_x,
                      const float* data_p, const float* log_mask, int m, int n,
                      int dx, int dp, float sy, float sp, float cy, float cp,
                      float* scratch, float* out, void* stream) {
  return (int)launch_wide(x, p, data_x, data_p, log_mask, m, n, dx, dp, sy, sp,
                          cp, cy, scratch, out, (cudaStream_t)stream);
}

int vbn_kde_pick(const float* p, const float* data_p, const float* data_x,
                 const float* log_mask, const int64_t* key,
                 const float* gumbel, int m, int n, int dp, int dx,
                 float inv2p, long long row_base, int s_loc,
                 long long row_stride, const float* read,
                 long long read_stride, int read_s, float* out,
                 void* stream) {
  if (s_loc < 1 || read_s < 1) return (int)cudaErrorInvalidValue;
  const RowMap rm{row_base, row_stride, s_loc};
  return (int)launch_pick(p, data_p, data_x, log_mask, key, rm, gumbel, m, n,
                          dp, dx, inv2p, ReadFlag{read, read_stride, read_s},
                          out, (cudaStream_t)stream);
}

int vbn_kde_mma_probe(const float* a, const float* b, const float* c,
                      float* d, int warps, void* stream) {
  kde_mma_probe_kernel<<<warps, 32, 0, (cudaStream_t)stream>>>(a, b, c, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
