// vbn_uniforms: the row stream of the port's torch-op sweeps, a list of
// nodes a launch.
//
// No TPU kernel stands behind it: the JAX package draws a node's values in
// XLA from fold(key, node) by partitionable threefry. The port's torch-op
// sweeps draw them here instead, from Philox-4x32-10 keyed by the call's
// 64-bit seed with counter (particle0 + p, row0 + r, node, 4 | (j << 3)):
// slot 4 j + w of an element is word w of its call j, and the low three
// bits of the last word (4) keep the stream apart from the kernels' tags
// 0-3. So a value is a function of (key, global particle, global row,
// node) alone: a row's draws do not depend on its batch, and a rank of a
// mesh that sweeps a block of rows and particles draws exactly the
// unmeshed ones. core/rng.py::stream_values_many is the plain version.
//
// One launch writes out[g][r * s + p][c], c < k, float32, node-major, for
// the B x S elements of each of G <= 64 nodes (a level's group, or the
// next chunk of a stacked-table sweep):
// - uniforms: slot at + c by uniform_from_bits, clamped to 1 - 2^-24, so
//   in (0, 1) (a Gumbel stays finite, an inverse CDF never reaches the
//   total);
// - normals (at even): Box-Muller on slots at + 2c, at + 2c + 1 in the LG
//   walk's formula, -sqrt(-2 log u1) cos(2 pi (u2 - 1/2)), with the
//   accurate logf, sqrtf and cosf (the plain version's torch.log, sqrt and
//   cos round apart from them by an ulp or two; the uniforms are equal bit
//   for bit).
//
// Design: a 3-D grid, z the node in the list, y the row (a grid-stride
// loop past 65535 rows), x blocks of THREADS * PER particles. A thread
// takes PER particles THREADS apart and runs their Philox chains
// interleaved, so one chain's dependent multiplies issue behind the
// others'; neighbouring threads take neighbouring particles, so a warp's
// stores for one slot cover one contiguous span at k = 1. Past one word a
// thread loops over its calls j and writes its element's k values. The
// item path has no division: a node's and a row's base pointer are one
// product each, a particle's offset p * k is 32-bit unless S * k passes
// 2^32. Each word is picked by a compile-time index (a runtime index into
// the counter array would put it in local memory).
//
// Bound: operations at one uniform a particle. Each particle's first word
// costs a whole Philox call: ten rounds of two 32 x 32 -> 64-bit
// multiplies (IMAD.HI.U32 and IMAD, the integer multiplier running at half
// the float32 rate) and two three-input XORs (LOP3), the round keys
// precomputed; then the uniform's conversion (I2F, at 16 an SM a clock). chip_smoke.py counts the kernel's SASS (uniforms_sass) and
// prices each class at its issue rate: the multiplies bound it, at 0.0201
// ms for W1's [8, 2^20] on an H100 SXM. Past four values a particle the
// bytes written bound it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vbn_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;  // particles a thread, their chains interleaved
constexpr int MAX_NODES = 64;  // nodes a launch (the wrapper splits longer lists)
constexpr uint32_t STREAM_TAG = 4u;
constexpr float U_MAX = 0.99999994039535522461f;  // 1 - 2^-24

struct NodeList {
  uint32_t id[MAX_NODES];
};

// PER Philox-4x32-10 chains, their rounds interleaved.
__device__ __forceinline__ void philox_interleaved(uint32_t c[PER][4],
                                                   const vbn::PhiloxKey& key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const uint32_t hi0 = __umulhi(0xD2511F53u, c[q][0]);
      const uint32_t lo0 = 0xD2511F53u * c[q][0];
      const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[q][2]);
      const uint32_t lo1 = 0xCD9E8D57u * c[q][2];
      c[q][0] = hi1 ^ c[q][1] ^ key.k0[r];
      c[q][2] = hi0 ^ c[q][3] ^ key.k1[r];
      c[q][1] = lo1;
      c[q][3] = lo0;
    }
  }
}

__device__ __forceinline__ float box_muller(uint32_t w1, uint32_t w2) {
  const float u1 = vbn::uniform_from_bits(w1);
  const float u2 = vbn::uniform_from_bits(w2);
  const float rad = sqrtf(__fmul_rn(-2.f, logf(u1)));
  return -__fmul_rn(
      rad, cosf(__fmul_rn(6.28318530717958647692f, __fsub_rn(u2, 0.5f))));
}

template <typename I, bool NORMAL>  // I: uint32_t while S * k fits, else uint64_t
__global__ void __launch_bounds__(THREADS)
uniforms_kernel(vbn::PhiloxKey key, NodeList nodes, uint32_t b, I s, int k,
                int at, uint32_t row0, uint32_t particle0,
                float* __restrict__ out) {
  const int words = NORMAL ? 2 * k : k;
  const int j0 = at >> 2, j1 = (at + words - 1) >> 2;
  const uint32_t node = nodes.id[blockIdx.z];
  const I p0 = (I)blockIdx.x * (THREADS * PER) + threadIdx.x;
  float* const node_out = out + (size_t)blockIdx.z * b * (size_t)s * k;
  for (uint32_t r = blockIdx.y; r < b; r += gridDim.y) {
    float* const row = node_out + (size_t)r * (size_t)s * k;
    for (int j = j0; j <= j1; ++j) {
      uint32_t c[PER][4];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        c[q][0] = particle0 + (uint32_t)(p0 + (I)(q * THREADS));
        c[q][1] = row0 + r;
        c[q][2] = node;
        c[q][3] = STREAM_TAG | ((uint32_t)j << 3);
      }
      philox_interleaved(c, key);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const I p = p0 + (I)(q * THREADS);
        if (p >= s) continue;
        float* const e = row + p * (I)k;
        if (NORMAL) {
#pragma unroll
          for (int w = 0; w < 4; w += 2) {
            const int slot = 4 * j + w - at;  // even: a pair never splits
            if (slot >= 0 && slot < words)
              e[slot >> 1] = box_muller(c[q][w], c[q][w + 1]);
          }
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int slot = 4 * j + w - at;
            if (slot >= 0 && slot < words)
              e[slot] = fminf(vbn::uniform_from_bits(c[q][w]), U_MAX);
          }
        }
      }
    }
  }
}

template <bool NORMAL>
cudaError_t launch(const vbn::PhiloxKey& key, const NodeList& nodes, int g,
                   long long b, long long s, int k, int at, uint32_t row0,
                   uint32_t particle0, float* out, cudaStream_t stream) {
  const long long xs = (s + THREADS * PER - 1) / (THREADS * PER);
  const dim3 grid((unsigned)xs, (unsigned)(b < 65535 ? b : 65535), (unsigned)g);
  if (s * (long long)k + THREADS * PER < (1LL << 32))
    uniforms_kernel<uint32_t, NORMAL><<<grid, THREADS, 0, stream>>>(
        key, nodes, (uint32_t)b, (uint32_t)s, k, at, row0, particle0, out);
  else
    uniforms_kernel<uint64_t, NORMAL><<<grid, THREADS, 0, stream>>>(
        key, nodes, (uint32_t)b, (uint64_t)s, k, at, row0, particle0, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out: [g, b * s, k] float32; nodes: g host 32-bit counter words,
// 1 <= g <= 64.
int vbn_uniforms(unsigned long long seed, long long b, int s,
                 const unsigned int* nodes,
                 int g, int k, int at, int normal, int row0, int particle0,
                 float* out, void* stream) {
  if (b < 1 || b >= (1LL << 31) || s < 1 || k < 1 || at < 0 ||
      (normal && (at & 1)) || g < 1 || g > MAX_NODES)
    return (int)cudaErrorInvalidValue;
  NodeList list;
  for (int i = 0; i < g; ++i) list.id[i] = nodes[i];
  const vbn::PhiloxKey key = vbn::philox_key(seed);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(normal ? launch<true>(key, list, g, b, s, k, at, (uint32_t)row0,
                                     (uint32_t)particle0, out, st)
                      : launch<false>(key, list, g, b, s, k, at, (uint32_t)row0,
                                      (uint32_t)particle0, out, st));
}

}  // extern "C"
