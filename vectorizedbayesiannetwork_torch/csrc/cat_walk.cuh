// The categorical walk shared by vbn_cat_sweep (sweep.cu) and vbn_cat_scan
// (sweep_scan.cu): one particle's pass over the nodes in topological order.
//
// - Random numbers: Philox-4x32-10 with counter (particle, row, i >> 2, 1)
//   and the seed's round keys from the constant bank (vbn_common.cuh);
//   node i takes word i & 3, so one call serves four nodes. A group whose
//   four nodes are all clamped in this row skips its call (the kernel says
//   which groups are live, the same for every thread of a block), and the
//   next group's call is issued before the current group's walks, so its
//   integer work overlaps their table loads. core/rng.py's
//   philox_uniforms(grouped=True) is the same stream in torch ops.
// - Tables: the wrappers build, per call, the running sums of every CPT row
//   (cum_0 .. cum_{c-1}, total = cum_{c-1}) in float32, one add per class in
//   class order (the rounding of a sequential __fadd_rn chain), each row
//   padded to a multiple of four floats and 16-byte aligned
//   (ops/cat_tables.py). A node with c <= 4 reads its whole row in one
//   float4 load and walks in registers: thresh = u * total,
//   val = sum_{j < c-1} [cum_j <= thresh], the classes of the plain versions
//   bit for bit. Beside them, in the same padded layout, the wrapper puts
//   each class's log-probability log(max(cnt / max(total, 1e-12), 1e-12)),
//   computed by the plain version's own torch ops: a weighted node
//   (evidence, target) reads its class's entry, with no division and no log
//   in the kernel, and bit for bit the plain version's value.
// - Metadata stays in global memory, read with uniform __ldg loads (every
//   thread of a warp reads the same word at the same step: one request,
//   served from L1): a record {off, card, slot, pstart} per node (int4, the
//   next record's pstart ends its parent list) and {slot, stride} per
//   parent (int2).
// - Values: only nodes that are some node's parent get a scratch slot, plus
//   one trash slot for the rest. When every node has at most 4 classes a
//   value takes 2 bits (four slots a byte; each thread owns its own byte
//   column, so the read-modify-write of a byte involves no other thread),
//   else a byte (classes are < 128).

#pragma once

#include "vbn_common.cuh"

namespace vbn {

// Bytes of one thread's value-scratch column at BITS bits a value.
__host__ __device__ __forceinline__ size_t vals_col(int n_slots, int bits) {
  return bits == 2 ? (size_t)(n_slots + 3) / 4 : (size_t)n_slots;
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

// Which groups of four nodes have a node to draw in this row: a byte per
// group in shared memory (the scan: the row's own flags) or a bit mask (the
// unrolled sweep: a plan constant, at most 80 nodes).
struct GroupBytes {
  const uint8_t* live;
  __device__ __forceinline__ bool operator()(int g) const { return live[g]; }
};
struct GroupMask {
  uint32_t live;
  __device__ __forceinline__ bool operator()(int g) const {
    return (live >> g) & 1u;
  }
};

// One node: its parent row from the value scratch, its class (the clamped
// value, or the running-sum walk on u), stored in its slot, and, when
// `weighted`, the log-probability of that class in `lp`. Returns the class.
template <int BITS>
__device__ __forceinline__ int cat_node(
    const int4 r, int pend, const int2* __restrict__ par,
    const float* __restrict__ ctab, const float* __restrict__ lpt,
    uint8_t* s_vals, int T, int tid, bool clamped, int fixed, float u,
    bool weighted, float& lp) {
  const int c = r.y;
  int row = 0;
#pragma unroll 1
  for (int p = r.w; p < pend; ++p) {
    const int2 pp = __ldg(par + p);
    row += get_val<BITS>(s_vals, pp.x, T, tid) * pp.y;
  }
  const int base = r.x + row * ((c + 3) & ~3);
  int v = 0;
  if (clamped) {
    v = min(fixed, c - 1);
  } else if (c <= 4) {
    const float4 cm = __ldg((const float4*)(ctab + base));
    const float total = c == 1 ? cm.x : c == 2 ? cm.y : c == 3 ? cm.z : cm.w;
    const float thresh = __fmul_rn(u, total);
    v = (c > 1 && cm.x <= thresh) + (c > 2 && cm.y <= thresh) +
        (c > 3 && cm.z <= thresh);
  } else {
    const float thresh = __fmul_rn(u, __ldg(ctab + base + c - 1));
    for (int j = 0; j < c - 1; j += 4) {
      const float4 cm = __ldg((const float4*)(ctab + base + j));
      v += (cm.x <= thresh) + (j + 1 < c - 1 && cm.y <= thresh) +
           (j + 2 < c - 1 && cm.z <= thresh) + (j + 3 < c - 1 && cm.w <= thresh);
    }
  }
  set_val<BITS>(s_vals, r.z, T, tid, v);
  if (weighted) lp = __ldg(lpt + base + v);
  return v;
}

// One particle s of query row `row` over all nodes: s_packed [N] holds the
// row's words (value | ev << 16 | do << 17), ti its target node. EXT: u_row
// is the row's [N, S] external uniforms; else the grouped Philox stream of
// `key`. Adds the evidence log-probabilities to logw; the target's goes to
// lpt and its class to tval.
template <int BITS, bool EXT, class Live>
__device__ __forceinline__ void cat_particle(
    const int4* __restrict__ rec, const int2* __restrict__ par, int n_nodes,
    const float* __restrict__ ctab, const float* __restrict__ lpt_tab,
    const int32_t* s_packed, uint8_t* s_vals, int T, int tid, Live live,
    int ti, const float* __restrict__ u_row, const PhiloxKey& key, int row,
    int s, int n_samples, int need_logw, int need_lpt, float& logw,
    float& lpt, int& tval) {
  const int n_groups = (n_nodes + 3) / 4;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (!EXT && live(0)) {
    uint32_t c[4] = {(uint32_t)s, (uint32_t)row, 0u, 1u};
    philox4x32_10(c, key);
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = c[q];
  }
  for (int g = 0; g < n_groups; ++g) {
    // the next group's words, ahead of this group's walks
    uint32_t nw[4] = {0u, 0u, 0u, 0u};
    if (!EXT && g + 1 < n_groups && live(g + 1)) {
      uint32_t c[4] = {(uint32_t)s, (uint32_t)row, (uint32_t)(g + 1), 1u};
      philox4x32_10(c, key);
#pragma unroll
      for (int q = 0; q < 4; ++q) nw[q] = c[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * g + q;
      if (i >= n_nodes) break;
      const int pk = s_packed[i];
      const int fl = (pk >> 16) & 3;
      const bool ev = (fl & 1) && need_logw;
      const bool tg = (i == ti) && need_lpt;
      float u = 0.f;
      if (!fl)
        u = EXT ? u_row[(size_t)i * n_samples + s] : uniform_from_bits(w[q]);
      float lp = 0.f;
      const int v = cat_node<BITS>(__ldg(rec + i), __ldg(&rec[i + 1].w), par,
                                   ctab, lpt_tab, s_vals, T, tid, fl != 0,
                                   pk & 0xFFFF, u, ev || tg, lp);
      if (ev) logw = __fadd_rn(logw, lp);
      if (tg) lpt = lp;
      if (i == ti) tval = v;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = nw[q];
  }
}

}  // namespace vbn
