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
// network, of up to 1500 nodes. One block of T threads (128, 64 or 32, the
// largest whose shared memory fits) owns one query row b and a contiguous
// span of T * ppt particles; each thread walks ppt particles, one per step,
// and each particle walks the nodes in topological order. The block reads
// its row's [N] packed words (value | ev << 16 | do << 17; LG: values and
// flags) into shared memory once.
//
// The TPU kernel's row loop with masked selects (sweep_scan_pallas.py:
// 364-422) exists because the TPU's vector unit cannot gather per lane; here
// a thread owns its particle and indexes its own CPT row directly:
// row = sum_k vals[slot(pid_k)] * stride_k, then the inverse-CDF walk over
// that row, in the float32 order of sweep.cu (total and cum summed in class
// order, thresh = u * total, val = sum_{j < card-1} [cum_j <= thresh]), so
// the classes equal vbn_cat_sweep's and the plain version's bit for bit.
// A clamped node takes its row's value and, when it is evidence, adds
// log(max(cnt[v] / max(total, 1e-12), 1e-12)) to the weight; the per-row
// target's value and its log-density at the final value stay in registers.
//
// Value scratch: only nodes that are some node's parent get a slot, plus one
// trash slot for the rest (the compaction of sweep_scan_pallas.py:604-616);
// parent ids arrive as slot ids. Classes are < 128, so the categorical
// scratch is uint8 [slot][T] (309 slots: 40 KB at T = 128); the LG scratch
// is float32 [slot][T]. Per-node metadata is in shared memory; the flat CPT
// table is copied there only when the block stays small enough for two
// blocks per SM, and is read through the read-only cache otherwise.
//
// Random numbers: Philox-4x32-10, counter (particle, row, node, 0), as in
// sweep.cu: one uniform (word 0) per categorical node, the Box-Muller pair
// (words 0, 1) per LG node. The generator is counter-based, so a clamped
// node skips its call without moving any other draw, and a static plan
// draws what vbn_cat_sweep draws. A non-null u_ext ([B, N, S] or
// [B, 2N, S] float32) replaces the generator.
//
// Outputs: [B, S] float32 streams (logw / tgt / lpt), or one [K + 1]
// max-shifted partial per block, as sweep.cu writes them. The pmf histogram
// has K = the network's largest class count (the target varies by row, up
// to 128 classes); each thread keeps its shifted sums in its own column of
// a [K][T] shared array, so K costs no registers. Moments keep K = 3 sums
// in registers.
//
// Bound on an H100: a reduction-mode launch reads kilobytes (plan, table,
// query rows) and writes a few MB of partials, so it is bound by
// operations: per latent node one Philox call, the row's total and walk
// (two reads of card entries each), a log per weighted node. The design
// keeps every per-particle value on chip and writes nothing per particle
// in reduction mode.

#include <math.h>

#include "vbn_common.cuh"

using vbn::Acc;
using vbn::align16;
using vbn::allow_smem;
using vbn::philox4x32_10;
using vbn::uniform_from_bits;

namespace {

// Shared memory of the categorical kernel, in the order the kernel lays it
// out: meta, the row's packed words, the uint8 value scratch, the
// reduction array, the table (table_len 0 when it stays in global memory).
__host__ __device__ __forceinline__ size_t cat_scan_smem(
    int n_nodes, int n_par, int n_slots, int threads, int k, int table_len) {
  size_t at = align16((4 * (size_t)n_nodes + 1 + 2 * (size_t)n_par) * 4);
  at += align16((size_t)n_nodes * 4);
  at += align16((size_t)n_slots * threads);
  if (k > 0) at += align16((size_t)(k + 1) * threads * 4);
  return at + (size_t)table_len * 4;
}

// meta (int32): eoff[N] card[N] smap[N] pstart[N+1] pslot[P] pstride[P]
// packed [B, N] int32: value | ev << 16 | do << 17; tgt_idx [B] int32.
template <int RED>
__global__ void __launch_bounds__(128)
cat_scan_kernel(const int32_t* __restrict__ meta, int n_nodes, int n_par,
                int n_slots, const float* __restrict__ table, int table_len,
                int tbl_in_smem, const int32_t* __restrict__ packed,
                const int32_t* __restrict__ tgt_idx,
                const float* __restrict__ u_ext, uint64_t seed, int n_samples,
                int nblk, int ppt, int need_logw, int need_lpt, int want_logw,
                int want_tgt, int want_lpt, int red_src, int k,
                float* __restrict__ out_logw, float* __restrict__ out_tgt,
                float* __restrict__ out_lpt, float* __restrict__ out_red) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const int meta_len = 4 * n_nodes + 1 + 2 * n_par;

  int32_t* s_meta = (int32_t*)smem;
  size_t at = align16((size_t)meta_len * 4);
  int32_t* s_packed = (int32_t*)(smem + at);
  at += align16((size_t)n_nodes * 4);
  uint8_t* s_vals = smem + at;
  at += align16((size_t)n_slots * T);
  float* s_red = (float*)(smem + at);
  if (RED != 0) at += align16((size_t)(k + 1) * T * 4);
  float* s_tbl = (float*)(smem + at);

  for (int j = tid; j < meta_len; j += T) s_meta[j] = meta[j];
  for (int j = tid; j < n_nodes; j += T)
    s_packed[j] = packed[(size_t)b * n_nodes + j];
  if (tbl_in_smem)
    for (int j = tid; j < table_len; j += T) s_tbl[j] = table[j];
  __syncthreads();
  const int32_t* eoff = s_meta;
  const int32_t* card = eoff + n_nodes;
  const int32_t* smap = card + n_nodes;
  const int32_t* pstart = smap + n_nodes;
  const int32_t* pslot = pstart + n_nodes + 1;
  const int32_t* pstride = pslot + n_par;
  const int ti = tgt_idx[b];
  auto ld = [&](int e) -> float {
    return tbl_in_smem ? s_tbl[e] : __ldg(table + e);
  };

  Acc<RED> acc;
  acc.init(s_red, k);
  for (int it = 0; it < ppt; ++it) {
    const int s = (blk * ppt + it) * T + tid;
    float logw = 0.f, lpt = 0.f;
    int tval = 0;
    for (int i = 0; i < n_nodes; ++i) {
      const int pk = s_packed[i];
      const int fl = (pk >> 16) & 3;
      const int c = card[i];
      int row = 0;
      for (int q = pstart[i]; q < pstart[i + 1]; ++q)
        row += (int)s_vals[pslot[q] * T + tid] * pstride[q];
      const int base = eoff[i] + row * c;
      float total = ld(base);
      for (int j = 1; j < c; ++j) total = __fadd_rn(total, ld(base + j));
      int v;
      if (fl) {
        v = min(pk & 0xFFFF, c - 1);
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
        float cum = ld(base);
        v = 0;
        for (int j = 1; j < c; ++j) {
          v += (cum <= thresh) ? 1 : 0;
          cum = __fadd_rn(cum, ld(base + j));
        }
      }
      s_vals[smap[i] * T + tid] = (uint8_t)v;
      const bool ev = (fl & 1) && need_logw;
      const bool tg = (i == ti) && need_lpt;
      if (ev || tg) {
        const float prob = __fdiv_rn(ld(base + v), fmaxf(total, 1e-12f));
        const float lp = logf(fmaxf(prob, 1e-12f));
        if (ev) logw = __fadd_rn(logw, lp);
        if (tg) lpt = lp;
      }
      if (i == ti) tval = v;
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

// Shared memory of the LG kernel: meta, the row's values and flags, the
// parameter table, the float value scratch, the moments array.
__host__ __device__ __forceinline__ size_t lg_scan_smem(
    int n_nodes, int pmax, int n_slots, int threads, int red) {
  size_t at = align16((size_t)n_nodes * (1 + pmax) * 4);
  at += 2 * align16((size_t)n_nodes * 4);
  at += align16((size_t)n_nodes * (pmax + 2) * 4);
  at += align16((size_t)n_slots * threads * 4);
  if (red) at += align16((size_t)4 * threads * 4);
  return at;
}

// meta (int32): smap[N] pslot[N * pmax] (parent SLOT ids, 0-padded);
// ptab [N * (pmax + 2)] rows [w_0 .. w_{pmax-1} (0-padded), bias, sigma];
// fixed [B, N] float32, flags [B, N] int32 (ev | do << 1), tgt_idx [B].
template <int RED>
__global__ void __launch_bounds__(128)
lg_scan_kernel(const int32_t* __restrict__ meta, int n_nodes, int pmax,
               int n_slots, const float* __restrict__ ptab,
               const float* __restrict__ fixed,
               const int32_t* __restrict__ flags,
               const int32_t* __restrict__ tgt_idx,
               const float* __restrict__ u_ext, uint64_t seed, int n_samples,
               int nblk, int ppt, int need_logw, int need_lpt, int want_logw,
               int want_tgt, int want_lpt, int red_src,
               float* __restrict__ out_logw, float* __restrict__ out_tgt,
               float* __restrict__ out_lpt, float* __restrict__ out_red) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const int meta_len = n_nodes * (1 + pmax);
  const int width = pmax + 2;

  int32_t* s_meta = (int32_t*)smem;
  size_t at = align16((size_t)meta_len * 4);
  float* s_fixed = (float*)(smem + at);
  at += align16((size_t)n_nodes * 4);
  int32_t* s_flags = (int32_t*)(smem + at);
  at += align16((size_t)n_nodes * 4);
  float* s_ptab = (float*)(smem + at);
  at += align16((size_t)n_nodes * width * 4);
  float* s_vals = (float*)(smem + at);
  at += align16((size_t)n_slots * T * 4);
  float* s_red = (float*)(smem + at);

  for (int j = tid; j < meta_len; j += T) s_meta[j] = meta[j];
  for (int j = tid; j < n_nodes; j += T) {
    s_fixed[j] = fixed[(size_t)b * n_nodes + j];
    s_flags[j] = flags[(size_t)b * n_nodes + j];
  }
  for (int j = tid; j < n_nodes * width; j += T) s_ptab[j] = ptab[j];
  __syncthreads();
  const int32_t* smap = s_meta;
  const int32_t* pslot = smap + n_nodes;
  const int ti = tgt_idx[b];
  const float two_pi = 6.28318530717958647692f;
  const float half_log_2pi = 0.9189385332046727f;

  Acc<RED> acc;
  acc.init(s_red, 3);
  for (int it = 0; it < ppt; ++it) {
    const int s = (blk * ppt + it) * T + tid;
    float logw = 0.f, lpt = 0.f, tval = 0.f;
    for (int i = 0; i < n_nodes; ++i) {
      const float* prow = s_ptab + i * width;
      float loc = prow[pmax];
      for (int q = 0; q < pmax; ++q) {
        // a padded slot has weight 0 and points at slot 0, whose value may
        // not be written yet: gate the product so NaN * 0 cannot arise
        const float w = prow[q];
        if (w != 0.f)
          loc = __fadd_rn(loc, __fmul_rn(s_vals[pslot[i * pmax + q] * T + tid], w));
      }
      const float sigma = prow[pmax + 1];
      const int fl = s_flags[i];
      float v;
      if (fl) {
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
      s_vals[smap[i] * T + tid] = v;
      const bool ev = (fl & 1) && need_logw;
      const bool tg = (i == ti) && need_lpt;
      if (ev || tg) {
        const float zz = __fdiv_rn(__fsub_rn(v, loc), sigma);
        const float lp = __fsub_rn(
            __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, zz), zz), logf(sigma)),
            half_log_2pi);
        if (ev) logw = __fadd_rn(logw, lp);
        if (tg) lpt = lp;
      }
      if (i == ti) tval = v;
    }
    const size_t o = (size_t)b * n_samples + s;
    if (want_logw) out_logw[o] = logw;
    if (want_tgt) out_tgt[o] = tval;
    if (want_lpt) out_lpt[o] = lpt;
    if (RED != 0) acc.add(red_src == 0 ? logw : lpt, 0, tval);
  }
  if (RED != 0)
    acc.block_store(s_red, out_red + ((size_t)b * nblk + blk) * 4);
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

size_t vbn_cat_scan_smem_bytes(int n_nodes, int n_par, int n_slots,
                               int threads, int k, int table_len) {
  return cat_scan_smem(n_nodes, n_par, n_slots, threads, k, table_len);
}

size_t vbn_lg_scan_smem_bytes(int n_nodes, int pmax, int n_slots, int threads,
                              int red) {
  return lg_scan_smem(n_nodes, pmax, n_slots, threads, red);
}

// red_kind: 0 none, 1 pmf (K = k classes), 2 moments (k = 3).
// red_src: 0 logw, 1 lpt. Returns cudaGetLastError() after the launch.
int vbn_cat_scan(const int32_t* meta, int n_nodes, int n_par, int n_slots,
                 const float* table, int table_len, int tbl_in_smem,
                 const int32_t* packed, const int32_t* tgt_idx,
                 const float* u_ext, uint64_t seed, int batch, int n_samples,
                 int threads, int ppt, int need_logw, int need_lpt,
                 int want_logw, int want_tgt, int want_lpt, int red_kind,
                 int red_src, int k, float* out_logw, float* out_tgt,
                 float* out_lpt, float* out_red, void* stream) {
  const int nblk = n_samples / (threads * ppt);
  const int grid = batch * nblk;
  const int kk = red_kind == 0 ? 0 : k;
  const size_t smem = cat_scan_smem(n_nodes, n_par, n_slots, threads, kk,
                                    tbl_in_smem ? table_len : 0);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define VBN_CAT_SCAN(R)                                                      \
  e = allow_smem(cat_scan_kernel<R>, smem);                                   \
  if (e != cudaSuccess) return (int)e;                                       \
  cat_scan_kernel<R><<<grid, threads, smem, st>>>(                           \
      meta, n_nodes, n_par, n_slots, table, table_len, tbl_in_smem, packed,  \
      tgt_idx, u_ext, seed, n_samples, nblk, ppt, need_logw, need_lpt,       \
      want_logw, want_tgt, want_lpt, red_src, kk, out_logw, out_tgt,         \
      out_lpt, out_red);
  if (red_kind == 1) {
    VBN_CAT_SCAN(1)
  } else if (red_kind == 2) {
    VBN_CAT_SCAN(2)
  } else {
    VBN_CAT_SCAN(0)
  }
#undef VBN_CAT_SCAN
  return (int)cudaGetLastError();
}

int vbn_lg_scan(const int32_t* meta, int n_nodes, int pmax, int n_slots,
                const float* ptab, const float* fixed, const int32_t* flags,
                const int32_t* tgt_idx, const float* u_ext, uint64_t seed,
                int batch, int n_samples, int threads, int ppt, int need_logw,
                int need_lpt, int want_logw, int want_tgt, int want_lpt,
                int red_kind, int red_src, float* out_logw, float* out_tgt,
                float* out_lpt, float* out_red, void* stream) {
  const int nblk = n_samples / (threads * ppt);
  const int grid = batch * nblk;
  const size_t smem = lg_scan_smem(n_nodes, pmax, n_slots, threads,
                                   red_kind != 0);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
#define VBN_LG_SCAN(R)                                                       \
  e = allow_smem(lg_scan_kernel<R>, smem);                                    \
  if (e != cudaSuccess) return (int)e;                                       \
  lg_scan_kernel<R><<<grid, threads, smem, st>>>(                            \
      meta, n_nodes, pmax, n_slots, ptab, fixed, flags, tgt_idx, u_ext,      \
      seed, n_samples, nblk, ppt, need_logw, need_lpt, want_logw, want_tgt,  \
      want_lpt, red_src, out_logw, out_tgt, out_lpt, out_red);
  if (red_kind == 2) {
    VBN_LG_SCAN(2)
  } else {
    VBN_LG_SCAN(0)
  }
#undef VBN_LG_SCAN
  return (int)cudaGetLastError();
}

}  // extern "C"
