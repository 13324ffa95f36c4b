// The linear-Gaussian walk shared by vbn_lg_sweep (sweep.cu) and
// vbn_lg_scan (sweep_scan.cu): one particle's pass over the nodes in
// topological order.
//
// - Random numbers: Philox-4x32-10 with counter (particle, row, i >> 1, 3)
//   and the seed's round keys from the constant bank (vbn_common.cuh);
//   node i takes words 2 (i & 1) and 2 (i & 1) + 1 as its Box-Muller pair
//   (u1, u2), so one call serves two nodes. A pair whose two nodes are
//   both clamped skips its call (the kernel says which pairs are live, the
//   same for every thread of a block), and the next pair's call is issued
//   before the current pair's parent loops and Box-Muller.
//   core/rng.py's philox_uniforms(words=2, grouped=True) is the same
//   stream in torch ops. The external-uniform route is its own
//   instantiation, so the in-kernel one carries no predicated loads.
// - Records instead of padded rows: one 16-byte record a node {out slot,
//   parent start, bias, sigma} and one 8-byte record a parent {slot,
//   weight}, read with uniform __ldg loads from L1. The wrappers build them
//   on the device from the parameter rows (ops/lg_records.py), leaving out
//   every padded slot and every parent whose weight is exactly 0 (the
//   plain versions skip those products too), so the parent loop (not
//   unrolled: ~1.6 parents a node) walks only real parents and no product
//   can meet an unwritten slot.
// - Box-Muller: z = -r cos(2 pi (u2 - 1/2)), r = sqrt(-2 log u1) as
//   r2 rsqrt(r2) (0 when u1 = 1): one MUFU.RSQ and one MUFU.COS on an
//   argument in [-pi, pi] (u2 - 1/2 exact on the stream's uniforms), whose
//   absolute error (2^-21.4) moves z by under 2e-6, a hundredth of the
//   plain versions' tolerance. logf stays the accurate one: __logf's absolute error near
//   u1 = 1 would reach ~1e-3 in z.
// - The density of a weighted node (evidence, target) takes 1 / sigma and
//   log(sigma) + log(2 pi) / 2 from a per-node pair the wrappers build in
//   torch ops (ops/lg_records.py::lg_densities): a multiply and a
//   subtraction where a division and a logf were.
// - Values: a float scratch in shared memory, [slot][thread]; the slots go
//   by liveness (ops/lg_records.py::lg_slot_map): a value holds its slot
//   from its draw to its last reader, every other node writes one trash
//   slot.
//
// Both kernels hold the row's clamped values and flags in shared memory
// and call lg_particle with the same arguments; only the pair flags differ
// (the scan: a byte per pair from the row's own flags; the unrolled sweep:
// a bit mask of the plan). So on a static plan the two draw the same values
// bit for bit, on their in-kernel streams and on the same external uniforms.

#pragma once

#include "vbn_common.cuh"

namespace vbn {

// MUFU.RSQ alone: the Box-Muller radius squared is 0 (the caller's case) or
// at least 1.1e-7, never denormal, so rsqrtf's denormal scaling is not
// needed.
__device__ __forceinline__ float rsqrt_approx(float x) {
#if defined(__CUDA_ARCH__)
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return rsqrtf(x);
#endif
}

// Which pairs of nodes have a node to draw: a byte per pair in shared
// memory (the scan: the row's own flags) or a bit mask (the unrolled
// sweep: a plan constant, at most 80 nodes).
struct PairBytes {
  const uint8_t* live;
  __device__ __forceinline__ bool operator()(int p) const { return live[p]; }
};
struct PairMask {
  uint64_t live;
  __device__ __forceinline__ bool operator()(int p) const {
    return (live >> p) & 1u;
  }
};

// One particle s of query row `row`: s_fixed [N] and s_flags [N] (ev | do
// << 1) hold the row's clamped values and flags, ti is its target node;
// dens [N] the nodes' {1 / sigma, log(sigma) + log(2 pi) / 2}.
// EXT: u_row is the row's [2N, S] external uniforms; else the grouped
// Philox stream of `key`. Adds the evidence log-densities to logw; the
// target's goes to lpt and its value to tval.
template <bool EXT, class Live>
__device__ __forceinline__ void lg_particle(
    const int4* __restrict__ rec, const int2* __restrict__ par,
    const float2* __restrict__ dens, int n_nodes,
    const float* s_fixed, const int32_t* s_flags, float* s_vals, int T,
    int tid, Live live, int ti, const float* __restrict__ u_row,
    const PhiloxKey& key, int row, int s, int n_samples, int need_logw,
    int need_lpt, float& logw, float& lpt, float& tval) {
  const int n_pairs = (n_nodes + 1) / 2;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (!EXT && live(0)) {
    uint32_t c[4] = {(uint32_t)s, (uint32_t)row, 0u, 3u};
    philox4x32_10(c, key);
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = c[q];
  }
  for (int p = 0; p < n_pairs; ++p) {
    // the next pair's words, ahead of this pair's parent loops
    uint32_t nw[4] = {0u, 0u, 0u, 0u};
    if (!EXT && p + 1 < n_pairs && live(p + 1)) {
      uint32_t c[4] = {(uint32_t)s, (uint32_t)row, (uint32_t)(p + 1), 3u};
      philox4x32_10(c, key);
#pragma unroll
      for (int q = 0; q < 4; ++q) nw[q] = c[q];
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = 2 * p + q;
      if (i >= n_nodes) break;
      const int4 r = __ldg(rec + i);
      const int pend = __ldg(&rec[i + 1].y);
      float loc = __int_as_float(r.z);
#pragma unroll 1
      for (int k = r.y; k < pend; ++k) {
        const int2 pp = __ldg(par + k);
        loc = __fadd_rn(loc, __fmul_rn(s_vals[pp.x * T + tid],
                                       __int_as_float(pp.y)));
      }
      const float sigma = __int_as_float(r.w);
      const int fl = s_flags[i];
      float v;
      if (fl) {
        v = s_fixed[i];
      } else {
        float u1, u2;
        if (EXT) {
          const size_t at_u = (size_t)2 * i * n_samples + s;
          u1 = u_row[at_u];
          u2 = u_row[at_u + n_samples];
        } else {
          u1 = uniform_from_bits(w[2 * q]);
          u2 = uniform_from_bits(w[2 * q + 1]);
        }
        // r = sqrt(-2 log u1) as r2 * rsqrt(r2) (u1 = 1 gives r2 = 0)
        const float r2 = __fmul_rn(-2.f, logf(u1));
        const float rad = r2 > 0.f ? __fmul_rn(r2, rsqrt_approx(r2)) : 0.f;
        const float c = __cosf(__fmul_rn(6.28318530717958647692f,
                                         __fsub_rn(u2, 0.5f)));
        const float z = -__fmul_rn(rad, c);
        v = __fadd_rn(loc, __fmul_rn(sigma, z));
      }
      s_vals[r.x * T + tid] = v;
      const bool ev = (fl & 1) && need_logw;
      const bool tg = (i == ti) && need_lpt;
      if (ev || tg) {
        const float2 dn = __ldg(dens + i);  // {1 / sigma, log(sigma) + c}
        const float zz = __fmul_rn(__fsub_rn(v, loc), dn.x);
        const float lp = __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, zz), zz), dn.y);
        if (ev) logw = __fadd_rn(logw, lp);
        if (tg) lpt = lp;
      }
      if (i == ti) tval = v;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = nw[q];
  }
}

}  // namespace vbn
