// vbn_uniforms: the row stream of the port's torch-op sweeps.
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
// unmeshed ones. core/rng.py::stream_values is the plain version.
//
// One launch writes out[r * s + p][c], c < k, float32, for the B x S
// elements of one node:
// - uniforms: slot at + c by uniform_from_bits, clamped to 1 - 2^-24, so
//   in (0, 1) (a Gumbel stays finite, an inverse CDF never reaches the
//   total);
// - normals (at even): Box-Muller on slots at + 2c, at + 2c + 1 in the LG
//   walk's formula, -sqrt(-2 log u1) cos(2 pi (u2 - 1/2)), with the
//   accurate logf, sqrtf and cosf (the plain version's torch.log, sqrt and
//   cos round apart from them by an ulp or two; the uniforms are equal bit
//   for bit).
//
// Design: a work item is one (element, call) pair, j = at / 4 .. (at +
// words - 1) / 4: one Philox, and the call's slots that fall in the draw
// written. Consecutive threads take consecutive calls of a row, then the
// next row, so a warp's stores cover one contiguous span of the [B*S, k]
// output (a thread a row would put neighbouring threads k floats apart).
// The index arithmetic is 32-bit whenever the items fit (a 64-bit
// division is a long emulated sequence, and every item takes two). The
// function is bound by its operations at one uniform a particle (a whole
// Philox call for each particle's first word: ten rounds of two 32-bit
// multiplies and their high halves), by the bytes it writes past four.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vbn_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr uint32_t STREAM_TAG = 4u;
constexpr float U_MAX = 0.99999994039535522461f;  // 1 - 2^-24

template <typename I>  // uint32_t when the items fit, else uint64_t
__global__ void __launch_bounds__(THREADS)
uniforms_kernel(vbn::PhiloxKey key, I items, I s, uint32_t node, int k,
                int at, int normal, uint32_t row0, uint32_t particle0,
                float* __restrict__ out) {
  const int words = normal ? 2 * k : k;
  const int j0 = at >> 2;
  const I calls = (I)(((at + words - 1) >> 2) - j0 + 1);
  for (I it = (I)blockIdx.x * THREADS + threadIdx.x; it < items;
       it += (I)gridDim.x * THREADS) {
    const I e = it / calls;
    const int j = j0 + (int)(it - e * calls);
    const I rr = e / s;
    const uint32_t r = (uint32_t)rr, p = (uint32_t)(e - rr * s);
    float* row = out + (size_t)e * k;
    uint32_t c[4] = {particle0 + p, row0 + r, node,
                     STREAM_TAG | ((uint32_t)j << 3)};
    vbn::philox4x32_10(c, key);
    const int first = max(4 * j, at) - at, last = min(4 * j + 4, at + words) - at;
    if (normal) {
      for (int w = first; w < last; w += 2) {
        const float u1 = vbn::uniform_from_bits(c[(w + at) & 3]);
        const float u2 = vbn::uniform_from_bits(c[(w + at + 1) & 3]);
        const float rad = sqrtf(__fmul_rn(-2.f, logf(u1)));
        const float z = -__fmul_rn(
            rad, cosf(__fmul_rn(6.28318530717958647692f, __fsub_rn(u2, 0.5f))));
        row[w >> 1] = z;
      }
    } else {
      for (int w = first; w < last; ++w)
        row[w] = fminf(vbn::uniform_from_bits(c[(w + at) & 3]), U_MAX);
    }
  }
}

}  // namespace

extern "C" {

int vbn_uniforms(unsigned long long seed, long long b, int s, int node, int k,
                 int at, int normal, int row0, int particle0, float* out,
                 void* stream) {
  if (b < 1 || s < 1 || k < 1 || at < 0 || (normal && (at & 1)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int calls = ((at + (normal ? 2 * k : k) - 1) >> 2) - (at >> 2) + 1;
  const long long items = b * (long long)s * calls;
  const long long blocks = (items + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < (long long)sms * 16 ? blocks : (long long)sms * 16);
  const vbn::PhiloxKey key = vbn::philox_key(seed);
  if (items + (long long)grid * THREADS < (1LL << 32))
    uniforms_kernel<uint32_t><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        key, (uint32_t)items, (uint32_t)s, (uint32_t)node, k, at, normal,
        (uint32_t)row0, (uint32_t)particle0, out);
  else
    uniforms_kernel<uint64_t><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        key, (uint64_t)items, (uint64_t)s, (uint32_t)node, k, at, normal,
        (uint32_t)row0, (uint32_t)particle0, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
