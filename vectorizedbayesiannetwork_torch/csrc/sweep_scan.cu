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
// call, the uniform, the parent row and the class walk. The design:
//
// - Random numbers: Philox-4x32-10 with counter (particle, row, i >> 2, 1);
//   node i takes word i & 3, so one call serves four nodes (the sweeps of
//   sweep.cu use one call a node, counter (particle, row, node, 0): the two
//   streams differ, and a static plan draws other classes here than on
//   vbn_cat_sweep unless both take the same external uniforms). A group
//   whose four nodes are all clamped in this row skips its call (the flags
//   are the row's, so the whole block takes the same branch), and the next
//   group's call is issued before the current group's walks, so its
//   integer work overlaps their table loads. core/rng.py's
//   philox_uniforms(grouped=True) is the same stream in torch ops.
// - Tables: the wrapper builds, per call, the running sums of every CPT row
//   (cum_0 .. cum_{c-1}, total = cum_{c-1}) in float32, one add per class
//   in class order (the rounding of a sequential __fadd_rn chain), each row
//   padded to a multiple of four floats and 16-byte aligned. A node with
//   c <= 4 reads its whole row in one float4 load and walks in registers:
//   thresh = u * total, val = sum_{j < c-1} [cum_j <= thresh], the classes
//   of the plain version (and of vbn_cat_sweep on the same uniforms) bit for
//   bit. The raw counts sit in the same padded layout and are read only for
//   a weighted node (evidence, target):
//   log(max(cnt[v] / max(total, 1e-12), 1e-12)).
// - Metadata stays in global memory, read with uniform __ldg loads (every
//   thread of a warp reads the same word at the same step: one request,
//   served from L1): a record {off, card, slot, pstart} per node (int4,
//   the next record's pstart ends its parent list) and {slot, stride} per
//   parent (int2).
// - Shared memory holds only the row's packed words, a per-group "any node
//   drawn" byte, the value scratch and the pmf histogram. Only nodes that
//   are some node's parent get a scratch slot, plus one trash slot for the
//   rest (the compaction of sweep_scan_pallas.py:604-616). When the network
//   has at most 4 classes a node, a value takes 2 bits (four slots a byte;
//   each thread owns its own byte column, so the read-modify-write of a
//   byte involves no other thread), else a byte (classes are < 128).
// - Occupancy and L1: the wrapper sets the shared-memory carveout to the
//   smallest configuration that holds the most blocks an SM while leaving
//   L1 room for the cumulative table and the metadata; the trade-off it
//   takes is L1 residency of the table over blocks beyond that count
//   (ops/sweep_scan.py::_cat_layout).
//
// Outputs: [B, S] float32 streams (logw / tgt / lpt), or one [K + 1]
// max-shifted partial per block, as sweep.cu writes them. The pmf histogram
// has K = the network's largest class count (the target varies by row, up
// to 128 classes); each thread keeps its shifted sums in its own column of
// a [K][T] shared array, so K costs no registers. Moments keep K = 3 sums
// in registers.

#include <math.h>

#include "vbn_common.cuh"

using vbn::Acc;
using vbn::align16;
using vbn::allow_smem;
using vbn::philox4x32_10;
using vbn::uniform_from_bits;

namespace {

// Bytes of one thread's value-scratch column at BITS bits a value.
__host__ __device__ __forceinline__ size_t vals_col(int n_slots, int bits) {
  return bits == 2 ? (size_t)(n_slots + 3) / 4 : (size_t)n_slots;
}

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

template <int BITS>
__device__ __forceinline__ int get_val(const uint8_t* s_vals, int slot, int T,
                                       int tid) {
  if (BITS == 2) return (s_vals[(slot >> 2) * T + tid] >> (2 * (slot & 3))) & 3;
  return s_vals[slot * T + tid];
}

template <int BITS>
__device__ __forceinline__ void set_val(uint8_t* s_vals, int slot, int T,
                                        int tid, int v) {
  if (BITS == 2) {
    uint8_t* at = s_vals + (slot >> 2) * T + tid;
    const int sh = 2 * (slot & 3);
    *at = (uint8_t)((*at & ~(3 << sh)) | (v << sh));
  } else {
    s_vals[slot * T + tid] = (uint8_t)v;
  }
}

// rec [N + 1] int4 {off, card, slot, pstart} (rec[N].w = P);
// par [P] int2 {slot, stride}; ctab, cnt: padded running sums and counts;
// packed [B, N] int32: value | ev << 16 | do << 17; tgt_idx [B] int32.
template <int RED, int BITS>
__global__ void __launch_bounds__(128)
cat_scan_kernel(const int4* __restrict__ rec, const int2* __restrict__ par,
                int n_nodes, int n_slots, const float* __restrict__ ctab,
                const float* __restrict__ cnt,
                const int32_t* __restrict__ packed,
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
  const bool philox = u_ext == nullptr;

  Acc<RED> acc;
  acc.init(s_red, k);
  for (int it = 0; it < ppt; ++it) {
    const int s = (blk * ppt + it) * T + tid;
    float logw = 0.f, lpt = 0.f;
    int tval = 0;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (philox && s_glive[0]) {
      uint32_t c[4] = {(uint32_t)s, (uint32_t)b, 0u, 1u};
      philox4x32_10(c, seed);
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = c[q];
    }
    for (int g = 0; g < n_groups; ++g) {
      // the next group's words, ahead of this group's walks
      uint32_t nw[4] = {0u, 0u, 0u, 0u};
      if (philox && g + 1 < n_groups && s_glive[g + 1]) {
        uint32_t c[4] = {(uint32_t)s, (uint32_t)b, (uint32_t)(g + 1), 1u};
        philox4x32_10(c, seed);
#pragma unroll
        for (int q = 0; q < 4; ++q) nw[q] = c[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * g + q;
        if (i >= n_nodes) break;
        const int4 r = __ldg(rec + i);
        const int pend = __ldg(&rec[i + 1].w);
        const int c = r.y;
        int row = 0;
        for (int p = r.w; p < pend; ++p) {
          const int2 pp = __ldg(par + p);
          row += get_val<BITS>(s_vals, pp.x, T, tid) * pp.y;
        }
        const int base = r.x + row * ((c + 3) & ~3);
        const int pk = s_packed[i];
        const int fl = (pk >> 16) & 3;
        const bool ev = (fl & 1) && need_logw;
        const bool tg = (i == ti) && need_lpt;
        int v;
        float total = 0.f;
        if (fl) {
          v = min(pk & 0xFFFF, c - 1);
          if (ev || tg) total = __ldg(ctab + base + c - 1);
        } else {
          const float u =
              philox ? uniform_from_bits(w[q])
                     : u_ext[((size_t)b * n_nodes + i) * n_samples + s];
          v = 0;
          if (c <= 4) {
            const float4 cm = __ldg((const float4*)(ctab + base));
            total = c == 1 ? cm.x : c == 2 ? cm.y : c == 3 ? cm.z : cm.w;
            const float thresh = __fmul_rn(u, total);
            v = (c > 1 && cm.x <= thresh) + (c > 2 && cm.y <= thresh) +
                (c > 3 && cm.z <= thresh);
          } else {
            total = __ldg(ctab + base + c - 1);
            const float thresh = __fmul_rn(u, total);
            for (int j = 0; j < c - 1; j += 4) {
              const float4 cm = __ldg((const float4*)(ctab + base + j));
              v += (cm.x <= thresh) + (j + 1 < c - 1 && cm.y <= thresh) +
                   (j + 2 < c - 1 && cm.z <= thresh) +
                   (j + 3 < c - 1 && cm.w <= thresh);
            }
          }
        }
        set_val<BITS>(s_vals, r.z, T, tid, v);
        if (ev || tg) {
          const float prob = __fdiv_rn(__ldg(cnt + base + v), fmaxf(total, 1e-12f));
          const float lp = logf(fmaxf(prob, 1e-12f));
          if (ev) logw = __fadd_rn(logw, lp);
          if (tg) lpt = lp;
        }
        if (i == ti) tval = v;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = nw[q];
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


// Dynamic shared memory (above 48 KB it must be allowed first) and the
// preferred shared-memory carveout of one categorical instantiation.
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

size_t vbn_lg_scan_smem_bytes(int n_nodes, int pmax, int n_slots, int threads,
                              int red) {
  return lg_scan_smem(n_nodes, pmax, n_slots, threads, red);
}

// Sets the categorical kernel's dynamic shared memory and carveout (percent
// of the SM's shared-memory maximum) for (red_kind, bits), and returns the
// blocks of `threads` an SM then holds (negative: a CUDA error).
int vbn_cat_scan_occupancy(int red_kind, int bits, int threads, size_t smem,
                           int carveout) {
  int blocks = 0;
  cudaError_t e = cudaSuccess;
#define VBN_OCC(R, BI)                                                        \
  if (red_kind == R && bits == BI) {                                          \
    e = configure(cat_scan_kernel<R, BI>, smem, carveout);                    \
    if (e == cudaSuccess)                                                     \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                      \
          &blocks, cat_scan_kernel<R, BI>, threads, smem);                    \
  }
  VBN_OCC(0, 2) VBN_OCC(1, 2) VBN_OCC(2, 2)
  VBN_OCC(0, 8) VBN_OCC(1, 8) VBN_OCC(2, 8)
#undef VBN_OCC
  return e == cudaSuccess ? blocks : -(int)e;
}

// red_kind: 0 none, 1 pmf (K = k classes), 2 moments (k = 3).
// red_src: 0 logw, 1 lpt; bits: 2 or 8 a scratch value; carveout: percent.
// Returns cudaGetLastError() after the launch.
int vbn_cat_scan(const int4* rec, const int2* par, int n_nodes, int n_slots,
                 const float* ctab, const float* cnt, const int32_t* packed,
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
  cudaError_t e = cudaErrorInvalidValue;
#define VBN_CAT_SCAN(R, BI)                                                  \
  if (red_kind == R && bits == BI) {                                         \
    e = configure(cat_scan_kernel<R, BI>, smem, carveout);                   \
    if (e != cudaSuccess) return (int)e;                                     \
    cat_scan_kernel<R, BI><<<grid, threads, smem, st>>>(                     \
        rec, par, n_nodes, n_slots, ctab, cnt, packed, tgt_idx, u_ext, seed, \
        n_samples, nblk, ppt, need_logw, need_lpt, want_logw, want_tgt,      \
        want_lpt, red_src, kk, out_logw, out_tgt, out_lpt, out_red);         \
    return (int)cudaGetLastError();                                          \
  }
  VBN_CAT_SCAN(0, 2) VBN_CAT_SCAN(1, 2) VBN_CAT_SCAN(2, 2)
  VBN_CAT_SCAN(0, 8) VBN_CAT_SCAN(1, 8) VBN_CAT_SCAN(2, 8)
#undef VBN_CAT_SCAN
  return (int)e;
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
