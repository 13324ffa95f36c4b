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
// runtime data, so one build serves every network and query skeleton.
// Per-particle node values live in shared memory, [slot][thread], because
// they are indexed at runtime by the parent lists.
//
// vbn_cat_sweep walks as vbn_cat_scan does (cat_walk.cuh): the plan's
// evidence and do flags are constants, so the wrapper packs them into the
// row's words (value | ev << 16 | do << 17) and passes which groups of four
// nodes draw as a bit mask; the grouped Philox stream (counter (particle,
// row, i >> 2, 1), word i & 3), the padded running-sum tables walked with
// one float4 load a node of <= 4 classes, the log-probability table and the
// uniform __ldg records are the scan's. So on a static plan the two kernels
// draw the same classes bit for bit, on their in-kernel streams and on the
// same external uniforms. The value scratch takes a byte a value: at most
// 81 slots, 10 KB a block, never what limits the blocks an SM (registers
// are), and a byte is read and written with fewer integer instructions than
// the scan's 2-bit packing.
//
// vbn_lg_sweep walks as vbn_lg_scan does (lg_walk.cuh): the grouped Philox
// stream (counter (particle, row, i >> 1, 3), node i words 2 (i & 1) and
// 2 (i & 1) + 1, a call a pair of nodes), the per-node and per-parent
// records built on the device (real parents of nonzero weight only), the
// value slots by liveness, one MUFU rsqrt and one MUFU cos, per-node
// density pairs. The plan's flags are constants: the block copies them
// beside the row's clamped values into shared memory, and the wrapper
// passes which pairs of nodes draw as a bit mask. So on a static plan the
// two kernels draw the same values bit for bit, on their in-kernel streams
// and on the same external uniforms. A thread walks 64 particles where S
// allows it (ops/sweep.py::_lg_ppt).
//
// A non-null u_ext ([B, N, S] or [B, 2N, S] float32) replaces the
// generator, which is how the kernels are held against their plain PyTorch
// versions.
//
// Outputs: [B, S] float32 streams (logw / tgt / lpt) when asked for, or,
// in reduction mode, one [K + 1] partial per block: the class histogram
// (K = target classes) or the moments (sum w, sum w x, sum w x^2; K = 3) of
// w = exp(src - m_blk), followed by the block's max shift m_blk. The caller
// combines blocks: m = max m_blk, sums = sum exp(m_blk - m) * partial.
//
// Bound on an H100: with reductions on, a kernel reads a few KB (plan,
// tables, query rows) and writes B * nblk * (K + 1) floats (a few MB), so
// it is bound by operations: per latent node a random word (a quarter
// Philox call for a class, half a call for a Box-Muller pair), the class
// walk or Box-Muller transform, and a log per weighted node. The designs
// keep every per-particle value in registers and shared memory and write
// nothing per particle in reduction mode.
//
// The arithmetic of the class walk is bit-exact with the TPU kernel under
// the same uniforms: total = sum_j col(j) in class order, thresh = u*total,
// val = sum_{j>=1} [cum_{j-1} <= thresh]; the _rn intrinsics keep nvcc
// from contracting multiply-adds, so the plain version's float32 order holds.

#include <math.h>

#include "cat_walk.cuh"
#include "lg_walk.cuh"
#include "vbn_common.cuh"

#define VBN_THREADS 128

using vbn::Acc;
using vbn::align16;
using vbn::allow_smem;

namespace {

// Shared memory of the categorical kernel: the row's packed words, the
// byte value scratch, the reduction array (k = 0: none).
__host__ __device__ __forceinline__ size_t cat_sweep_smem(int n_nodes,
                                                          int n_slots, int k) {
  size_t at = align16((size_t)n_nodes * 4);
  at += align16((size_t)n_slots * VBN_THREADS);
  if (k > 0) at += align16((size_t)(k + 1) * VBN_THREADS * 4);
  return at;
}

// rec [N + 1] int4 {off, card, slot, pstart} (rec[N].w = P); par [P] int2
// {slot, stride}; ctab, lpt: padded running sums and log-probabilities;
// nflags [N] int32: ev << 16 | do << 17 of the plan; glive: bit g set when
// group g has a node to draw; fixed [B, N] int32 clamped classes; EXT:
// u_ext [B, N, S], else the Philox stream of key.
template <int RED, bool EXT>
__global__ void __launch_bounds__(VBN_THREADS, VBN_MIN_BLOCKS)
cat_sweep_kernel(const int4* __restrict__ rec, const int2* __restrict__ par,
                 int n_nodes, int n_slots, int target,
                 const float* __restrict__ ctab,
                 const float* __restrict__ lpt_tab,
                 const int32_t* __restrict__ nflags, uint32_t glive,
                 const int32_t* __restrict__ fixed,
                 const float* __restrict__ u_ext, const vbn::PhiloxKey key,
                 int n_samples,
                 int nblk, int ppt, int need_logw, int need_lpt, int want_logw,
                 int want_tgt, int want_lpt, int red_src, int k,
                 float* __restrict__ out_logw, float* __restrict__ out_tgt,
                 float* __restrict__ out_lpt, float* __restrict__ out_red) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;

  int32_t* s_packed = (int32_t*)smem;
  size_t at = align16((size_t)n_nodes * 4);
  uint8_t* s_vals = smem + at;
  at += align16((size_t)n_slots * VBN_THREADS);
  float* s_red = (float*)(smem + at);

  for (int j = tid; j < n_nodes; j += VBN_THREADS)
    s_packed[j] = (fixed[(size_t)b * n_nodes + j] & 0xFFFF) | nflags[j];
  __syncthreads();
  const float* u_row = EXT ? u_ext + (size_t)b * n_nodes * n_samples : nullptr;

  Acc<RED> acc;
  acc.init(s_red, k);
  for (int it = 0; it < ppt; ++it) {
    const int s = (blk * ppt + it) * VBN_THREADS + tid;
    float logw = 0.f, lpt = 0.f;
    int tval = 0;
    vbn::cat_particle<8, EXT>(rec, par, n_nodes, ctab, lpt_tab, s_packed,
                                 s_vals, VBN_THREADS, tid,
                                 vbn::GroupMask{glive}, target, u_row, key, b,
                                 s, n_samples, need_logw, need_lpt, logw, lpt,
                                 tval);
    const size_t o = (size_t)b * n_samples + s;
    if (want_logw) out_logw[o] = logw;
    if (want_tgt) out_tgt[o] = (float)tval;
    if (want_lpt) out_lpt[o] = lpt;
    if (RED != 0) acc.add(red_src == 0 ? logw : lpt, tval, (float)tval);
  }
  if (RED != 0)
    acc.block_store(s_red, out_red + ((size_t)b * nblk + blk) * (k + 1));
}

// Shared memory of the LG kernel, in the order the kernel lays it out: the
// row's clamped values, the plan's flags, the float value scratch, the
// moments array.
__host__ __device__ __forceinline__ size_t lg_sweep_smem(int n_nodes,
                                                         int n_slots,
                                                         int red) {
  size_t at = 2 * align16((size_t)n_nodes * 4);
  at += align16((size_t)n_slots * VBN_THREADS * 4);
  if (red) at += align16((size_t)4 * VBN_THREADS * 4);
  return at;
}

// rec [N + 1] int4 {out slot, parent start, bias, sigma} (bias and sigma as
// float bits; rec[N].y = P ends the last parent list); par [P] int2 {slot,
// weight bits}; dens [N] {1 / sigma, log(sigma) + log(2 pi) / 2};
// nflags [N] int32: ev | do << 1 of the plan; plive: bit p set when pair p
// has a node to draw; fixed [B, N] float32 clamped values; EXT: u_ext
// [B, 2N, S], else the Philox stream of key.
template <int RED, bool EXT>
__global__ void __launch_bounds__(VBN_THREADS, VBN_MIN_BLOCKS)
lg_sweep_kernel(const int4* __restrict__ rec, const int2* __restrict__ par,
                const float2* __restrict__ dens, int n_nodes, int n_slots,
                int target,
                const int32_t* __restrict__ nflags, uint64_t plive,
                const float* __restrict__ fixed,
                const float* __restrict__ u_ext, const vbn::PhiloxKey key,
                int n_samples, int nblk, int ppt, int need_logw, int need_lpt,
                int want_logw, int want_tgt, int want_lpt, int red_src,
                float* __restrict__ out_logw, float* __restrict__ out_tgt,
                float* __restrict__ out_lpt, float* __restrict__ out_red) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;

  float* s_fixed = (float*)smem;
  size_t at = align16((size_t)n_nodes * 4);
  int32_t* s_flags = (int32_t*)(smem + at);
  at += align16((size_t)n_nodes * 4);
  float* s_vals = (float*)(smem + at);
  at += align16((size_t)n_slots * VBN_THREADS * 4);
  float* s_red = (float*)(smem + at);

  for (int j = tid; j < n_nodes; j += VBN_THREADS) {
    s_fixed[j] = fixed[(size_t)b * n_nodes + j];
    s_flags[j] = nflags[j];
  }
  __syncthreads();
  const float* u_row =
      EXT ? u_ext + (size_t)b * 2 * n_nodes * n_samples : nullptr;

  const bool want_any = want_logw || want_tgt || want_lpt;
  Acc<RED> acc;
  acc.init(s_red, 3);
  for (int it = 0; it < ppt; ++it) {
    const int s = (blk * ppt + it) * VBN_THREADS + tid;
    float logw = 0.f, lpt = 0.f, tval = 0.f;
    vbn::lg_particle<EXT>(rec, par, dens, n_nodes, s_fixed, s_flags, s_vals,
                          VBN_THREADS, tid, vbn::PairMask{plive}, target,
                          u_row, key, b, s, n_samples, need_logw, need_lpt,
                          logw, lpt, tval);
    if (want_any) {  // reduction mode stores nothing a particle
      const size_t o = (size_t)b * n_samples + s;
      if (want_logw) out_logw[o] = logw;
      if (want_tgt) out_tgt[o] = tval;
      if (want_lpt) out_lpt[o] = lpt;
    }
    if (RED != 0) acc.add(red_src == 0 ? logw : lpt, 0, tval);
  }
  if (RED != 0)
    acc.block_store(s_red, out_red + ((size_t)b * nblk + blk) * 4);
}

}  // namespace

extern "C" {

size_t vbn_cat_sweep_smem_bytes(int n_nodes, int n_slots, int k) {
  return cat_sweep_smem(n_nodes, n_slots, k);
}

// red_kind: 0 none, 1 pmf (K = k classes), 2 moments (K = 3).
// red_src: 0 logw, 1 lpt. Returns cudaGetLastError() after the launch.
int vbn_cat_sweep(const int4* rec, const int2* par, int n_nodes, int n_slots,
                  int target, const float* ctab, const float* lpt,
                  const int32_t* nflags, uint32_t glive, const int32_t* fixed,
                  const float* u_ext, uint64_t seed, int batch, int n_samples,
                  int ppt, int need_logw, int need_lpt,
                  int want_logw, int want_tgt, int want_lpt, int red_kind,
                  int red_src, int k, float* out_logw, float* out_tgt,
                  float* out_lpt, float* out_red, void* stream) {
  const int nblk = n_samples / (VBN_THREADS * ppt);
  const int grid = batch * nblk;
  const int kk = red_kind == 0 ? 0 : k;
  const size_t smem = cat_sweep_smem(n_nodes, n_slots, kk);
  cudaStream_t st = (cudaStream_t)stream;
  const vbn::PhiloxKey key = vbn::philox_key(seed);
  const bool ext = u_ext != nullptr;
  cudaError_t e = cudaErrorInvalidValue;
#define VBN_CAT(R, X)                                                        \
  if (red_kind == R && ext == X) {                                           \
    e = allow_smem(cat_sweep_kernel<R, X>, smem);                            \
    if (e != cudaSuccess) return (int)e;                                     \
    cat_sweep_kernel<R, X><<<grid, VBN_THREADS, smem, st>>>(                 \
        rec, par, n_nodes, n_slots, target, ctab, lpt, nflags, glive, fixed, \
        u_ext, key, n_samples, nblk, ppt, need_logw, need_lpt, want_logw,    \
        want_tgt, want_lpt, red_src, kk, out_logw, out_tgt, out_lpt,         \
        out_red);                                                            \
    return (int)cudaGetLastError();                                          \
  }
  VBN_CAT(0, false) VBN_CAT(1, false) VBN_CAT(2, false)
  VBN_CAT(0, true) VBN_CAT(1, true) VBN_CAT(2, true)
#undef VBN_CAT
  return (int)e;
}

// red_kind: 0 none, 2 moments.
int vbn_lg_sweep(const int4* rec, const int2* par, const float2* dens,
                 int n_nodes, int n_slots, int target, const int32_t* nflags,
                 uint64_t plive, const float* fixed, const float* u_ext, uint64_t seed,
                 int batch, int n_samples, int ppt, int need_logw,
                 int need_lpt, int want_logw, int want_tgt, int want_lpt,
                 int red_kind, int red_src, float* out_logw, float* out_tgt,
                 float* out_lpt, float* out_red, void* stream) {
  const int nblk = n_samples / (VBN_THREADS * ppt);
  const int grid = batch * nblk;
  const size_t smem = lg_sweep_smem(n_nodes, n_slots, red_kind == 2);
  cudaStream_t st = (cudaStream_t)stream;
  const vbn::PhiloxKey key = vbn::philox_key(seed);
  const bool ext = u_ext != nullptr;
  cudaError_t e = cudaErrorInvalidValue;
#define VBN_LG(R, X)                                                         \
  if ((red_kind == 2) == (R == 2) && ext == X) {                             \
    e = allow_smem(lg_sweep_kernel<R, X>, smem);                             \
    if (e != cudaSuccess) return (int)e;                                     \
    lg_sweep_kernel<R, X><<<grid, VBN_THREADS, smem, st>>>(                  \
        rec, par, dens, n_nodes, n_slots, target, nflags, plive, fixed,      \
        u_ext, key, n_samples, nblk, ppt, need_logw, need_lpt, want_logw,    \
        want_tgt, want_lpt, red_src, out_logw, out_tgt, out_lpt, out_red);   \
    return (int)cudaGetLastError();                                          \
  }
  VBN_LG(0, false) VBN_LG(2, false) VBN_LG(0, true) VBN_LG(2, true)
#undef VBN_LG
  return (int)e;
}

}  // extern "C"
