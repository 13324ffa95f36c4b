// Fused ancestral sweeps for the PyTorch port, written for Hopper (sm_90a).
//
// vbn_cat_sweep replaces the TPU kernel
//   vectorizedbayesiannetwork_tpu/ops/sweep_pallas.py:207 _sweep_kernel
// and vbn_lg_sweep replaces
//   vectorizedbayesiannetwork_tpu/ops/sweep_pallas.py:514 _lg_sweep_kernel,
// each with the _reduction_tile epilogue (:172-195) folded in.
//
// One block of 128 threads owns one query row b and a contiguous span of
// 128 * ppt particles; each thread walks ppt particles, one per step, and
// each particle walks the plan's nodes in topological order. The plan is
// runtime data (small int arrays copied into shared memory), so one build
// serves every network and query skeleton. Per-particle node values live in
// shared memory, vals[node][thread], because they are indexed at runtime by
// the parent lists. The CPT (categorical) or the [N, dmax + 2] parameter
// table (LG) is copied into shared memory once per block when it fits.
//
// Random numbers: Philox-4x32-10 with key = the 64-bit seed and counter =
// (particle, row, node, 0) (vbn_common.cuh); the categorical walk takes
// output word 0, the LG Box-Muller pair words 0 and 1. A non-null u_ext ([B, N, S] or
// [B, 2N, S] float32) replaces the generator, which is how the kernels are
// held against their plain PyTorch versions.
//
// Outputs: [B, S] float32 streams (logw / tgt / lpt) when asked for, or,
// in reduction mode, one [K + 1] partial per block: the class histogram
// (K = target classes) or the moments (sum w, sum w x, sum w x^2; K = 3) of
// w = exp(src - m_blk), followed by the block's max shift m_blk. The caller
// combines blocks: m = max m_blk, sums = sum exp(m_blk - m) * partial.
//
// Bound on an H100: with reductions on, a kernel reads a few KB (plan,
// tables, query rows) and writes B * nblk * (K + 1) floats (a few MB), so
// it is bound by operations: per latent node one Philox call (10 rounds),
// the class walk or Box-Muller transform, and a log per weighted node.
// The design keeps every per-particle value in registers and shared memory
// and writes nothing per particle in reduction mode.
//
// The arithmetic of the class walk is bit-exact with the TPU kernel under
// the same uniforms: total = sum_j col(j) in class order, thresh = u*total,
// val = sum_{j>=1} [cum_{j-1} <= thresh]; the _rn intrinsics keep nvcc
// from contracting multiply-adds, so the plain version's float32 order holds.

#include <math.h>

#include "vbn_common.cuh"

#define VBN_THREADS 128

using vbn::Acc;
using vbn::align16;
using vbn::allow_smem;
using vbn::philox4x32_10;
using vbn::uniform_from_bits;

namespace {

// meta (int32): off[N] card[N] flags[N] pstart[N+1] plist[P] pstride[P]
// flags bit 0 = evidence, bit 1 = do.
template <int RED>
__global__ void __launch_bounds__(VBN_THREADS)
cat_sweep_kernel(const int32_t* __restrict__ meta, int n_nodes, int n_par,
                 int target, const float* __restrict__ table, int table_len,
                 int cmax, int tbl_in_smem, const int32_t* __restrict__ fixed,
                 const float* __restrict__ u_ext, uint64_t seed, int n_samples,
                 int nblk, int ppt, int need_logw, int need_lpt, int want_logw,
                 int want_tgt, int want_lpt, int red_src, int k,
                 float* __restrict__ out_logw, float* __restrict__ out_tgt,
                 float* __restrict__ out_lpt, float* __restrict__ out_red) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const int meta_len = 4 * n_nodes + 1 + 2 * n_par;

  int32_t* s_meta = (int32_t*)smem;
  size_t at = align16(meta_len * sizeof(int32_t));
  int32_t* s_fixed = (int32_t*)(smem + at);
  at += align16(n_nodes * sizeof(int32_t));
  int32_t* s_vals = (int32_t*)(smem + at);
  at += align16((size_t)n_nodes * VBN_THREADS * sizeof(int32_t));
  float* s_red = (float*)(smem + at);
  at += align16((size_t)(k + 1) * VBN_THREADS * sizeof(float));
  float* s_tbl = (float*)(smem + at);

  for (int j = tid; j < meta_len; j += VBN_THREADS) s_meta[j] = meta[j];
  for (int j = tid; j < n_nodes; j += VBN_THREADS)
    s_fixed[j] = fixed[(size_t)b * n_nodes + j];
  if (tbl_in_smem)
    for (int j = tid; j < table_len; j += VBN_THREADS) s_tbl[j] = table[j];
  __syncthreads();
  const float* tbl = tbl_in_smem ? s_tbl : table;
  const int32_t* off = s_meta;
  const int32_t* card = off + n_nodes;
  const int32_t* flags = card + n_nodes;
  const int32_t* pstart = flags + n_nodes;
  const int32_t* plist = pstart + n_nodes + 1;
  const int32_t* pstride = plist + n_par;

  Acc<RED> acc;
  acc.init(s_red, k);
  for (int it = 0; it < ppt; ++it) {
    const int s = (blk * ppt + it) * VBN_THREADS + tid;
    float logw = 0.f, lpt = 0.f;
    int tval = 0;
    for (int i = 0; i < n_nodes; ++i) {
      int row = 0;
      for (int q = pstart[i]; q < pstart[i + 1]; ++q)
        row += s_vals[plist[q] * VBN_THREADS + tid] * pstride[q];
      const float* r = tbl + (size_t)(off[i] + row) * cmax;
      const int c = card[i];
      float total = r[0];
      for (int j = 1; j < c; ++j) total = __fadd_rn(total, r[j]);
      int v;
      const int fl = flags[i];
      if (fl & 3) {
        v = s_fixed[i];
      } else {
        float u;
        if (u_ext != nullptr) {
          u = u_ext[((size_t)b * n_nodes + i) * n_samples + s];
        } else {
          uint32_t ctr[4] = {(uint32_t)s, (uint32_t)b, (uint32_t)i, 0u};
          philox4x32_10(ctr, seed);
          u = uniform_from_bits(ctr[0]);
        }
        const float thresh = __fmul_rn(u, total);
        float cum = r[0];
        v = 0;
        for (int j = 1; j < c; ++j) {
          v += (cum <= thresh) ? 1 : 0;
          cum = __fadd_rn(cum, r[j]);
        }
      }
      s_vals[i * VBN_THREADS + tid] = v;
      const bool ev = (fl & 1) && need_logw;
      const bool tg = (i == target) && need_lpt;
      if (ev || tg) {
        const float prob = __fdiv_rn(r[v], fmaxf(total, 1e-12f));
        const float lp = logf(fmaxf(prob, 1e-12f));
        if (ev) logw = __fadd_rn(logw, lp);
        if (tg) lpt = lp;
      }
      if (i == target) tval = v;
    }
    const size_t o = (size_t)b * n_samples + s;
    if (want_logw) out_logw[o] = logw;
    if (want_tgt) out_tgt[o] = (float)tval;
    if (want_lpt) out_lpt[o] = lpt;
    if (RED != 0) acc.add(red_src == 0 ? logw : lpt, tval, (float)tval);
  }
  if (RED != 0)
    acc.block_store(s_red, out_red + ((size_t)b * nblk + blk) * (k + 1));
}

// meta (int32): flags[N] pstart[N+1] plist[P]; ptab [N, dmax + 2] rows are
// [w_0 .. w_{d-1}, 0 pad, bias, sigma].
template <int RED>
__global__ void __launch_bounds__(VBN_THREADS)
lg_sweep_kernel(const int32_t* __restrict__ meta, int n_nodes, int n_par,
                int target, const float* __restrict__ ptab, int dmax,
                const float* __restrict__ fixed, const float* __restrict__ u_ext,
                uint64_t seed, int n_samples, int nblk, int ppt, int need_logw,
                int need_lpt, int want_logw, int want_tgt, int want_lpt,
                int red_src, float* __restrict__ out_logw,
                float* __restrict__ out_tgt, float* __restrict__ out_lpt,
                float* __restrict__ out_red) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const int meta_len = 2 * n_nodes + 1 + n_par;
  const int width = dmax + 2;
  const int k = 3;

  int32_t* s_meta = (int32_t*)smem;
  size_t at = align16(meta_len * sizeof(int32_t));
  float* s_fixed = (float*)(smem + at);
  at += align16(n_nodes * sizeof(float));
  float* s_ptab = (float*)(smem + at);
  at += align16((size_t)n_nodes * width * sizeof(float));
  float* s_vals = (float*)(smem + at);
  at += align16((size_t)n_nodes * VBN_THREADS * sizeof(float));
  float* s_red = (float*)(smem + at);

  for (int j = tid; j < meta_len; j += VBN_THREADS) s_meta[j] = meta[j];
  for (int j = tid; j < n_nodes; j += VBN_THREADS)
    s_fixed[j] = fixed[(size_t)b * n_nodes + j];
  for (int j = tid; j < n_nodes * width; j += VBN_THREADS) s_ptab[j] = ptab[j];
  __syncthreads();
  const int32_t* flags = s_meta;
  const int32_t* pstart = flags + n_nodes;
  const int32_t* plist = pstart + n_nodes + 1;
  const float two_pi = 6.28318530717958647692f;
  const float half_log_2pi = 0.9189385332046727f;

  Acc<RED> acc;
  acc.init(s_red, k);
  for (int it = 0; it < ppt; ++it) {
    const int s = (blk * ppt + it) * VBN_THREADS + tid;
    float logw = 0.f, lpt = 0.f, tval = 0.f;
    for (int i = 0; i < n_nodes; ++i) {
      const float* prow = s_ptab + i * width;
      float loc = prow[dmax];
      for (int q = pstart[i]; q < pstart[i + 1]; ++q)
        loc = __fadd_rn(loc, __fmul_rn(s_vals[plist[q] * VBN_THREADS + tid],
                                       prow[q - pstart[i]]));
      const float sigma = prow[dmax + 1];
      const int fl = flags[i];
      float v;
      if (fl & 3) {
        v = s_fixed[i];
      } else {
        float u1, u2;
        if (u_ext != nullptr) {
          const size_t base = ((size_t)b * 2 * n_nodes + 2 * i) * n_samples + s;
          u1 = u_ext[base];
          u2 = u_ext[base + n_samples];
        } else {
          uint32_t ctr[4] = {(uint32_t)s, (uint32_t)b, (uint32_t)i, 0u};
          philox4x32_10(ctr, seed);
          u1 = uniform_from_bits(ctr[0]);
          u2 = uniform_from_bits(ctr[1]);
        }
        const float z = __fmul_rn(sqrtf(__fmul_rn(-2.f, logf(u1))),
                                  cosf(__fmul_rn(two_pi, u2)));
        v = __fadd_rn(loc, __fmul_rn(sigma, z));
      }
      s_vals[i * VBN_THREADS + tid] = v;
      const bool ev = (fl & 1) && need_logw;
      const bool tg = (i == target) && need_lpt;
      if (ev || tg) {
        const float zz = __fdiv_rn(__fsub_rn(v, loc), sigma);
        const float lp = __fsub_rn(
            __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, zz), zz), logf(sigma)),
            half_log_2pi);
        if (ev) logw = __fadd_rn(logw, lp);
        if (tg) lpt = lp;
      }
      if (i == target) tval = v;
    }
    const size_t o = (size_t)b * n_samples + s;
    if (want_logw) out_logw[o] = logw;
    if (want_tgt) out_tgt[o] = tval;
    if (want_lpt) out_lpt[o] = lpt;
    if (RED != 0) acc.add(red_src == 0 ? logw : lpt, 0, tval);
  }
  if (RED != 0)
    acc.block_store(s_red, out_red + ((size_t)b * nblk + blk) * (k + 1));
}

}  // namespace

extern "C" {

// Shared-memory bytes the categorical kernel needs (without / with table).
size_t vbn_cat_smem_bytes(int n_nodes, int n_par, int k, int table_len) {
  size_t at = align16((4 * n_nodes + 1 + 2 * n_par) * sizeof(int32_t));
  at += align16(n_nodes * sizeof(int32_t));
  at += align16((size_t)n_nodes * VBN_THREADS * sizeof(int32_t));
  at += align16((size_t)(k + 1) * VBN_THREADS * sizeof(float));
  return at + (size_t)table_len * sizeof(float);
}

size_t vbn_lg_smem_bytes(int n_nodes, int n_par, int dmax) {
  size_t at = align16((2 * n_nodes + 1 + n_par) * sizeof(int32_t));
  at += align16(n_nodes * sizeof(float));
  at += align16((size_t)n_nodes * (dmax + 2) * sizeof(float));
  at += align16((size_t)n_nodes * VBN_THREADS * sizeof(float));
  return at + (size_t)4 * VBN_THREADS * sizeof(float);
}

// red_kind: 0 none, 1 pmf (K = k classes), 2 moments (K = 3).
// red_src: 0 logw, 1 lpt. Returns cudaGetLastError() after the launch.
int vbn_cat_sweep(const int32_t* meta, int n_nodes, int n_par, int target,
                  const float* table, int table_len, int cmax, int tbl_in_smem,
                  const int32_t* fixed, const float* u_ext, uint64_t seed,
                  int batch, int n_samples, int ppt, int need_logw,
                  int need_lpt, int want_logw, int want_tgt, int want_lpt,
                  int red_kind, int red_src, int k, float* out_logw,
                  float* out_tgt, float* out_lpt, float* out_red,
                  void* stream) {
  const int nblk = n_samples / (VBN_THREADS * ppt);
  const int grid = batch * nblk;
  const int kk = red_kind == 0 ? 0 : k;
  const size_t smem =
      vbn_cat_smem_bytes(n_nodes, n_par, kk, tbl_in_smem ? table_len : 0);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define VBN_CAT(R)                                                            \
  e = allow_smem(cat_sweep_kernel<R>, smem);                                   \
  if (e != cudaSuccess) return (int)e;                                        \
  cat_sweep_kernel<R><<<grid, VBN_THREADS, smem, st>>>(                       \
      meta, n_nodes, n_par, target, table, table_len, cmax, tbl_in_smem,      \
      fixed, u_ext, seed, n_samples, nblk, ppt, need_logw, need_lpt,          \
      want_logw, want_tgt, want_lpt, red_src, kk, out_logw, out_tgt, out_lpt, \
      out_red);
  if (red_kind == 1) {
    VBN_CAT(1)
  } else if (red_kind == 2) {
    VBN_CAT(2)
  } else {
    VBN_CAT(0)
  }
#undef VBN_CAT
  return (int)cudaGetLastError();
}

int vbn_lg_sweep(const int32_t* meta, int n_nodes, int n_par, int target,
                 const float* ptab, int dmax, const float* fixed,
                 const float* u_ext, uint64_t seed, int batch, int n_samples,
                 int ppt, int need_logw, int need_lpt, int want_logw,
                 int want_tgt, int want_lpt, int red_kind, int red_src,
                 float* out_logw, float* out_tgt, float* out_lpt,
                 float* out_red, void* stream) {
  const int nblk = n_samples / (VBN_THREADS * ppt);
  const int grid = batch * nblk;
  const size_t smem = vbn_lg_smem_bytes(n_nodes, n_par, dmax);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define VBN_LG(R)                                                           \
  e = allow_smem(lg_sweep_kernel<R>, smem);                                  \
  if (e != cudaSuccess) return (int)e;                                      \
  lg_sweep_kernel<R><<<grid, VBN_THREADS, smem, st>>>(                      \
      meta, n_nodes, n_par, target, ptab, dmax, fixed, u_ext, seed,         \
      n_samples, nblk, ppt, need_logw, need_lpt, want_logw, want_tgt,       \
      want_lpt, red_src, out_logw, out_tgt, out_lpt, out_red);
  if (red_kind == 2) {
    VBN_LG(2)
  } else {
    VBN_LG(0)
  }
#undef VBN_LG
  return (int)cudaGetLastError();
}

}  // extern "C"
