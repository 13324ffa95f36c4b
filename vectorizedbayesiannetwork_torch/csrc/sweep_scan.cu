// Mask-dynamic scan sweeps for the PyTorch port, written for Hopper (sm_90a).
//
// vbn_cat_scan replaces the TPU kernel
//   vectorizedbayesiannetwork_tpu/ops/sweep_scan_pallas.py:210 _scan_kernel
// and vbn_lg_scan replaces
//   vectorizedbayesiannetwork_tpu/ops/sweep_scan_pallas.py:978 _lg_scan_kernel.
//
// Both run the topological sweep of sweep.cu with the query's structure as
// per-row data: each query row carries its own evidence/do flags, clamped
// values and target node, so one launch serves any mix of queries on one
// network, of up to 1500 nodes. One block of T threads (128, 64 or 32, as
// the wrapper's layout chooses) owns one query row b and a contiguous
// span of T * ppt particles; each thread walks ppt particles, one per step,
// and each particle walks the nodes in topological order. The block reads
// its row's [N] words (categorical: value | ev << 16 | do << 17; LG: values
// and flags) into shared memory once.
//
// The TPU kernel's row loop with masked selects (sweep_scan_pallas.py:
// 364-422) exists because the TPU's vector unit cannot gather per lane; here
// a thread owns its particle and indexes its own CPT row directly:
// row = sum_k vals[slot(pid_k)] * stride_k.
//
// vbn_cat_scan. Bound on an H100: a reduction-mode launch reads kilobytes
// (plan, tables, query rows) and writes a few MB of partials, so it is
// bound by operations; per drawn node the work is a quarter of a Philox
// call, the uniform, the parent row and the class walk. The walk is
// cat_walk.cuh's, shared with vbn_cat_sweep: grouped Philox (four nodes a
// call, counter (particle, row, i >> 2, 1)), padded running-sum tables
// walked with one float4 load, uniform __ldg records, a 2-bit value
// scratch up to 4 classes a node. Here a group is live when the row draws
// one of its nodes (a byte per group in shared memory).
// - Shared memory holds only the row's packed words, the group flags, the
//   value scratch and the pmf histogram. Only nodes that are some node's
//   parent get a scratch slot, plus one trash slot for the rest (the
//   compaction of sweep_scan_pallas.py:604-616).
// - Occupancy and L1: the wrapper sets the shared-memory carveout to the
//   smallest configuration that holds the most blocks an SM while leaving
//   L1 room for the cumulative table and the metadata; the trade-off it
//   takes is L1 residency of the table over blocks beyond that count
//   (ops/sweep_scan.py::_cat_layout).
//
// vbn_lg_scan. Bound by operations as well: per drawn node two uniforms
// (half a Philox call), Box-Muller (log, sqrt, cos) and the location, a
// multiply-add per parent. Its walk is lg_walk.cuh's, shared with
// vbn_lg_sweep: grouped Philox (two nodes a call, counter (particle, row,
// i >> 1, 3)), per-node and per-parent records read with uniform __ldg
// loads, one MUFU rsqrt and one MUFU cos in Box-Muller, per-node density
// pairs for the weighted node, value slots by liveness. Here a pair is
// live when the row draws one of its nodes (a byte per pair in shared
// memory).
// - Shared memory holds only the row's clamped values and flags, the pair
//   flags, the float value scratch and the moments. The wrapper picks the
//   block size and the carveout for the most resident threads an SM while
//   L1 keeps room for the records (ops/sweep_scan.py::_lg_layout).
//
#include <math.h>

#include "cat_walk.cuh"
#include "lg_walk.cuh"
#include "vbn_common.cuh"

using vbn::Acc;
using vbn::align16;
using vbn::allow_smem;
using vbn::vals_col;

namespace {

// Shared memory of the categorical kernel, in the order the kernel lays it
// out: the row's packed words, the group flags, the value scratch, the
// reduction array.
__host__ __device__ __forceinline__ size_t cat_scan_smem(
    int n_nodes, int n_slots, int threads, int k, int bits) {
  size_t at = align16((size_t)n_nodes * 4);
  at += align16((size_t)(n_nodes + 3) / 4);
  at += align16(vals_col(n_slots, bits) * threads);
  if (k > 0) at += align16((size_t)(k + 1) * threads * 4);
  return at;
}

// rec [N + 1] int4 {off, card, slot, pstart} (rec[N].w = P);
// par [P] int2 {slot, stride}; ctab, lpt: padded running sums and
// log-probabilities; packed [B, N] int32: value | ev << 16 | do << 17;
// tgt_idx [B] int32; EXT: u_ext [B, N, S], else the Philox stream of key.
template <int RED, int BITS, bool EXT>
__global__ void __launch_bounds__(128, VBN_MIN_BLOCKS)
cat_scan_kernel(const int4* __restrict__ rec, const int2* __restrict__ par,
                int n_nodes, int n_slots, const float* __restrict__ ctab,
                const float* __restrict__ lpt_tab,
                const int32_t* __restrict__ packed,
                const int32_t* __restrict__ tgt_idx,
                const float* __restrict__ u_ext, const vbn::PhiloxKey key,
                int n_samples,
                int nblk, int ppt, int need_logw, int need_lpt, int want_logw,
                int want_tgt, int want_lpt, int red_src, int k,
                float* __restrict__ out_logw, float* __restrict__ out_tgt,
                float* __restrict__ out_lpt, float* __restrict__ out_red) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const int n_groups = (n_nodes + 3) / 4;

  int32_t* s_packed = (int32_t*)smem;
  size_t at = align16((size_t)n_nodes * 4);
  uint8_t* s_glive = smem + at;
  at += align16((size_t)n_groups);
  uint8_t* s_vals = smem + at;
  at += align16(vals_col(n_slots, BITS) * T);
  float* s_red = (float*)(smem + at);

  const int32_t* row_words = packed + (size_t)b * n_nodes;
  for (int j = tid; j < n_nodes; j += T) s_packed[j] = row_words[j];
  for (int g = tid; g < n_groups; g += T) {
    int live = 0;
    for (int i = 4 * g; i < min(4 * g + 4, n_nodes); ++i)
      live |= ((row_words[i] >> 16) & 3) == 0;
    s_glive[g] = (uint8_t)live;
  }
  __syncthreads();
  const int ti = tgt_idx[b];
  const float* u_row = EXT ? u_ext + (size_t)b * n_nodes * n_samples : nullptr;

  Acc<RED> acc;
  acc.init(s_red, k);
  for (int it = 0; it < ppt; ++it) {
    const int s = (blk * ppt + it) * T + tid;
    float logw = 0.f, lpt = 0.f;
    int tval = 0;
    vbn::cat_particle<BITS, EXT>(rec, par, n_nodes, ctab, lpt_tab, s_packed,
                                 s_vals, T, tid, vbn::GroupBytes{s_glive}, ti,
                                 u_row, key, b, s, n_samples, need_logw,
                                 need_lpt, logw, lpt, tval);
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
// row's clamped values and flags, the pair flags, the float value scratch,
// the moments array.
__host__ __device__ __forceinline__ size_t lg_scan_smem(int n_nodes,
                                                        int n_slots,
                                                        int threads, int red) {
  size_t at = 2 * align16((size_t)n_nodes * 4);
  at += align16((size_t)(n_nodes + 1) / 2);
  at += align16((size_t)n_slots * threads * 4);
  if (red) at += align16((size_t)4 * threads * 4);
  return at;
}

// rec [N + 1] int4 {out slot, parent start, bias, sigma} (bias and sigma as
// float bits; rec[N].y = P ends the last parent list); par [P] int2 {slot,
// weight bits}: each node's parents of nonzero weight, in its row's order;
// dens [N] {1 / sigma, log(sigma) + log(2 pi) / 2};
// fixed [B, N] float32, flags [B, N] int32 (ev | do << 1), tgt_idx [B];
// EXT: u_ext [B, 2N, S], else the Philox stream of key.
template <int RED, bool EXT>
__global__ void __launch_bounds__(128, VBN_MIN_BLOCKS)
lg_scan_kernel(const int4* __restrict__ rec, const int2* __restrict__ par,
               const float2* __restrict__ dens, int n_nodes, int n_slots,
               const float* __restrict__ fixed,
               const int32_t* __restrict__ flags,
               const int32_t* __restrict__ tgt_idx,
               const float* __restrict__ u_ext, const vbn::PhiloxKey key,
               int n_samples,
               int nblk, int ppt, int need_logw, int need_lpt, int want_logw,
               int want_tgt, int want_lpt, int red_src,
               float* __restrict__ out_logw, float* __restrict__ out_tgt,
               float* __restrict__ out_lpt, float* __restrict__ out_red) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const int n_pairs = (n_nodes + 1) / 2;

  float* s_fixed = (float*)smem;
  size_t at = align16((size_t)n_nodes * 4);
  int32_t* s_flags = (int32_t*)(smem + at);
  at += align16((size_t)n_nodes * 4);
  uint8_t* s_plive = smem + at;
  at += align16((size_t)n_pairs);
  float* s_vals = (float*)(smem + at);
  at += align16((size_t)n_slots * T * 4);
  float* s_red = (float*)(smem + at);

  const float* row_fixed = fixed + (size_t)b * n_nodes;
  const int32_t* row_flags = flags + (size_t)b * n_nodes;
  for (int j = tid; j < n_nodes; j += T) {
    s_fixed[j] = row_fixed[j];
    s_flags[j] = row_flags[j];
  }
  for (int p = tid; p < n_pairs; p += T)
    s_plive[p] = (uint8_t)(row_flags[2 * p] == 0 ||
                           (2 * p + 1 < n_nodes && row_flags[2 * p + 1] == 0));
  __syncthreads();
  const int ti = tgt_idx[b];
  const float* u_row = EXT ? u_ext + (size_t)b * 2 * n_nodes * n_samples : nullptr;

  const bool want_any = want_logw || want_tgt || want_lpt;
  Acc<RED> acc;
  acc.init(s_red, 3);
  for (int it = 0; it < ppt; ++it) {
    const int s = (blk * ppt + it) * T + tid;
    float logw = 0.f, lpt = 0.f, tval = 0.f;
    vbn::lg_particle<EXT>(rec, par, dens, n_nodes, s_fixed, s_flags, s_vals, T, tid,
                          vbn::PairBytes{s_plive}, ti, u_row, key, b, s,
                          n_samples, need_logw, need_lpt, logw, lpt, tval);
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


// Dynamic shared memory (above 48 KB it must be allowed first) and the
// preferred shared-memory carveout of one kernel instantiation.
template <typename K>
cudaError_t configure(K kernel, size_t smem, int carveout) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
}

}  // namespace

extern "C" {

// A block's shared-memory limit on `device` (opt-in maximum).
int vbn_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

size_t vbn_cat_scan_smem_bytes(int n_nodes, int n_slots, int threads, int k,
                               int bits) {
  return cat_scan_smem(n_nodes, n_slots, threads, k, bits);
}

size_t vbn_lg_scan_smem_bytes(int n_nodes, int n_slots, int threads,
                              int red) {
  return lg_scan_smem(n_nodes, n_slots, threads, red);
}

// Sets the categorical kernel's dynamic shared memory and carveout (percent
// of the SM's shared-memory maximum) for (red_kind, bits), and returns the
// blocks of `threads` an SM then holds (negative: a CUDA error), counted on
// the in-kernel-stream instantiation the served path launches.
int vbn_cat_scan_occupancy(int red_kind, int bits, int threads, size_t smem,
                           int carveout) {
  int blocks = 0;
  cudaError_t e = cudaSuccess;
#define VBN_OCC(R, BI)                                                        \
  if (red_kind == R && bits == BI) {                                          \
    e = configure(cat_scan_kernel<R, BI, false>, smem, carveout);             \
    if (e == cudaSuccess)                                                     \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                      \
          &blocks, cat_scan_kernel<R, BI, false>, threads, smem);             \
  }
  VBN_OCC(0, 2) VBN_OCC(1, 2) VBN_OCC(2, 2)
  VBN_OCC(0, 8) VBN_OCC(1, 8) VBN_OCC(2, 8)
#undef VBN_OCC
  return e == cudaSuccess ? blocks : -(int)e;
}

// The same for the LG kernel (red_kind 0 or 2).
int vbn_lg_scan_occupancy(int red_kind, int threads, size_t smem,
                          int carveout) {
  int blocks = 0;
  cudaError_t e = cudaSuccess;
  if (red_kind == 2) {
    e = configure(lg_scan_kernel<2, false>, smem, carveout);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, lg_scan_kernel<2, false>, threads, smem);
  } else {
    e = configure(lg_scan_kernel<0, false>, smem, carveout);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, lg_scan_kernel<0, false>, threads, smem);
  }
  return e == cudaSuccess ? blocks : -(int)e;
}

// red_kind: 0 none, 1 pmf (K = k classes), 2 moments (k = 3).
// red_src: 0 logw, 1 lpt; bits: 2 or 8 a scratch value; carveout: percent.
// Returns cudaGetLastError() after the launch.
int vbn_cat_scan(const int4* rec, const int2* par, int n_nodes, int n_slots,
                 const float* ctab, const float* lpt, const int32_t* packed,
                 const int32_t* tgt_idx, const float* u_ext, uint64_t seed,
                 int batch, int n_samples, int threads, int ppt, int bits,
                 int carveout, int need_logw, int need_lpt, int want_logw,
                 int want_tgt, int want_lpt, int red_kind, int red_src, int k,
                 float* out_logw, float* out_tgt, float* out_lpt,
                 float* out_red, void* stream) {
  const int nblk = n_samples / (threads * ppt);
  const int grid = batch * nblk;
  const int kk = red_kind == 0 ? 0 : k;
  const size_t smem = cat_scan_smem(n_nodes, n_slots, threads, kk, bits);
  cudaStream_t st = (cudaStream_t)stream;
  const vbn::PhiloxKey key = vbn::philox_key(seed);
  const bool ext = u_ext != nullptr;
  cudaError_t e = cudaErrorInvalidValue;
#define VBN_CAT_SCAN(R, BI, X)                                               \
  if (red_kind == R && bits == BI && ext == X) {                             \
    e = configure(cat_scan_kernel<R, BI, X>, smem, carveout);                \
    if (e != cudaSuccess) return (int)e;                                     \
    cat_scan_kernel<R, BI, X><<<grid, threads, smem, st>>>(                  \
        rec, par, n_nodes, n_slots, ctab, lpt, packed, tgt_idx, u_ext, key,  \
        n_samples, nblk, ppt, need_logw, need_lpt, want_logw, want_tgt,      \
        want_lpt, red_src, kk, out_logw, out_tgt, out_lpt, out_red);         \
    return (int)cudaGetLastError();                                          \
  }
  VBN_CAT_SCAN(0, 2, false) VBN_CAT_SCAN(1, 2, false) VBN_CAT_SCAN(2, 2, false)
  VBN_CAT_SCAN(0, 8, false) VBN_CAT_SCAN(1, 8, false) VBN_CAT_SCAN(2, 8, false)
  VBN_CAT_SCAN(0, 2, true) VBN_CAT_SCAN(1, 2, true) VBN_CAT_SCAN(2, 2, true)
  VBN_CAT_SCAN(0, 8, true) VBN_CAT_SCAN(1, 8, true) VBN_CAT_SCAN(2, 8, true)
#undef VBN_CAT_SCAN
  return (int)e;
}

// red_kind: 0 none, 2 moments; carveout: percent.
int vbn_lg_scan(const int4* rec, const int2* par, const float2* dens,
                int n_nodes, int n_slots, const float* fixed,
                const int32_t* flags, const int32_t* tgt_idx, const float* u_ext, uint64_t seed,
                int batch, int n_samples, int threads, int ppt, int carveout,
                int need_logw, int need_lpt, int want_logw, int want_tgt,
                int want_lpt, int red_kind, int red_src, float* out_logw,
                float* out_tgt, float* out_lpt, float* out_red,
                void* stream) {
  const int nblk = n_samples / (threads * ppt);
  const int grid = batch * nblk;
  const size_t smem = lg_scan_smem(n_nodes, n_slots, threads, red_kind != 0);
  cudaStream_t st = (cudaStream_t)stream;
  const vbn::PhiloxKey key = vbn::philox_key(seed);
  const bool ext = u_ext != nullptr;
  cudaError_t e = cudaErrorInvalidValue;
#define VBN_LG_SCAN(R, X)                                                    \
  if ((red_kind == 2) == (R == 2) && ext == X) {                             \
    e = configure(lg_scan_kernel<R, X>, smem, carveout);                     \
    if (e != cudaSuccess) return (int)e;                                     \
    lg_scan_kernel<R, X><<<grid, threads, smem, st>>>(                       \
        rec, par, dens, n_nodes, n_slots, fixed, flags, tgt_idx, u_ext, key, \
        n_samples, nblk, ppt, need_logw, need_lpt, want_logw, want_tgt,      \
        want_lpt, red_src, out_logw, out_tgt, out_lpt, out_red);             \
    return (int)cudaGetLastError();                                          \
  }
  VBN_LG_SCAN(0, false) VBN_LG_SCAN(2, false)
  VBN_LG_SCAN(0, true) VBN_LG_SCAN(2, true)
#undef VBN_LG_SCAN
  return (int)e;
}

}  // extern "C"
