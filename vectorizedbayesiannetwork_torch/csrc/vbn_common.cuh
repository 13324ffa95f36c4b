// Pieces shared by the port's sweep kernels (sweep.cu, sweep_scan.cu).
//
// Random numbers: Philox-4x32-10 (Salmon et al., SC'11) with key = the
// 64-bit seed; callers pass the counter (particle, row, node, tag). Uniforms
// are ((bits >> 8) + 0.5) * 2^-24, as in the TPU kernels' _uniform_from_bits,
// and core/rng.py reproduces both in torch ops.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vbn {

// The ten round keys of Philox-4x32-10 for one seed (k + r * the Weyl
// constants). The redesigned sweeps take them as a kernel parameter, which
// lives in the constant bank: a call then spends no instruction on the key
// schedule, each round's key an operand of its three-input xor.
struct PhiloxKey {
  uint32_t k0[10], k1[10];
};

__host__ __device__ __forceinline__ PhiloxKey philox_key(uint64_t seed) {
  PhiloxKey key;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    key.k0[r] = k0;
    key.k1[r] = k1;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return key;
}

__device__ __forceinline__ void philox4x32_10(uint32_t c[4],
                                              const PhiloxKey& key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    uint32_t n0 = hi1 ^ c[1] ^ key.k0[r], n2 = hi0 ^ c[3] ^ key.k1[r];
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The same with the key schedule computed in the kernel.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint64_t seed) {
  philox4x32_10(c, philox_key(seed));
}

__device__ __forceinline__ float uniform_from_bits(uint32_t x) {
  return __fmul_rn(__fadd_rn((float)(x >> 8), 0.5f), 5.9604644775390625e-08f);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Launch bounds of the redesigned sweeps: 128 threads, at least 8 blocks an
// SM (their layouts hold 8-10), so at most 64 registers, which they fit
// without spilling. Without the minimum, ptxas picks 32 or 40 registers
// for them and moves long-lived per-thread values to local memory.
#define VBN_MIN_BLOCKS 8

// Dynamic shared memory above 48 KB must be allowed per kernel first.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// 2^x on the SFU: one MUFU.EX2 (-inf gives 0; ftz: results under 2^-126
// give 0).
__device__ __forceinline__ float ex2(float x) {
#if defined(__CUDA_ARCH__)
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

constexpr float ACC_LOG2E = 1.4426950408889634f;
constexpr float ACC_MARGIN = 20.f;  // e^20 bounds a weight against ref

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reduction state of one thread: the largest source so far (m, the shift
// the block reports) and the sums of exp(src - ref) against a reference
// that moves, rescaling what was summed, only when a weight passes it by
// e^ACC_MARGIN (the first weight included), so a particle costs one
// ex2.approx and no data-dependent branch; block_store rescales to m.
// RED == 1: class histogram, sums in this thread's column of the shared
// [K][T] array after a [T] row (red = row[T] | sums[K][T]);
// RED == 2: moments (sum w, sum w x, sum w x^2) in registers.
template <int RED>
struct Acc {
  float m, ref;
  float s[3];
  float* col;
  int k, T, tid;

  __device__ __forceinline__ void init(float* red, int k_) {
    m = ref = -INFINITY;
    s[0] = s[1] = s[2] = 0.f;
    k = k_;
    T = blockDim.x;
    tid = threadIdx.x;
    col = red + T + tid;
    if (RED == 1)
      for (int j = 0; j < k; ++j) col[j * T] = 0.f;
  }

  __device__ __forceinline__ void add(float src, int cls, float x) {
    float a = src - ref;
    if (!(a <= ACC_MARGIN) || src == -INFINITY) {  // rare
      if (src == -INFINITY) return;  // weight 0
      const float sc = ex2((ref - src) * ACC_LOG2E);  // 0 on the first
      if (RED == 1) {
        for (int j = 0; j < k; ++j) col[j * T] *= sc;
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) s[j] *= sc;
      }
      ref = src;
      a = 0.f;
    }
    m = fmaxf(m, src);
    const float e = ex2(a * ACC_LOG2E);
    if (RED == 1) {
      col[cls * T] += e;
    } else {
      const float ex = e * x;
      s[0] += e;
      s[1] += ex;
      s[2] = fmaf(ex, x, s[2]);
    }
  }

  // Fold the block's threads into out[0..K-1] (sums) and out[K] (max),
  // every warp at work: the block max by shuffles and a [warps] row in
  // shared memory, one exp a thread to rescale its sums to it (from ref),
  // then the
  // sums added across the block (RED == 1: a warp per class reads the
  // class's column; RED == 2: shuffles, then the warps' partials).
  __device__ __forceinline__ void block_store(float* red, float* out) {
    const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
    float mb = m;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
    if (lane == 0) red[warp] = mb;
    __syncthreads();
    mb = red[0];
    for (int w = 1; w < nw; ++w) mb = fmaxf(mb, red[w]);
    const float sc = ref > -INFINITY ? expf(ref - mb) : 0.f;  // 0: no weight
    float* part = red + T;
    if (RED == 1) {
      for (int j = 0; j < k; ++j) col[j * T] *= sc;
      __syncthreads();
      for (int j = warp; j < k; j += nw) {
        float sum = 0.f;
        for (int t = lane; t < T; t += 32) sum += part[j * T + t];
        sum = warp_sum(sum);
        if (lane == 0) out[j] = sum;
      }
    } else {
      float v[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) v[j] = warp_sum(s[j] * sc);
      if (lane == 0)
        for (int j = 0; j < 3; ++j) part[j * nw + warp] = v[j];
      __syncthreads();
      if (tid < 3) {
        float sum = 0.f;
        for (int w = 0; w < nw; ++w) sum += part[tid * nw + w];
        out[tid] = sum;
      }
    }
    if (tid == 0) out[k] = mb;
  }
};

}  // namespace vbn
