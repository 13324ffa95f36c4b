// Pieces shared by the port's sweep kernels (sweep.cu, sweep_scan.cu).
//
// Random numbers: Philox-4x32-10 (Salmon et al., SC'11) with key = the
// 64-bit seed; callers pass the counter (particle, row, node, 0). Uniforms
// are ((bits >> 8) + 0.5) * 2^-24, as in the TPU kernels' _uniform_from_bits,
// and core/rng.py reproduces both in torch ops.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vbn {

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint64_t seed) {
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

__device__ __forceinline__ float uniform_from_bits(uint32_t x) {
  return __fmul_rn(__fadd_rn((float)(x >> 8), 0.5f), 5.9604644775390625e-08f);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

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

// Reduction state of one thread: running max shift and shifted sums.
// RED == 1: class histogram, sums in this thread's column of the shared
// [K][T] array after the [T] max row (red = m[T] | sums[K][T]);
// RED == 2: moments (sum w, sum w x, sum w x^2) in registers.
template <int RED>
struct Acc {
  float m;
  float s[3];
  float* col;
  int k, T, tid;

  __device__ __forceinline__ void init(float* red, int k_) {
    m = -INFINITY;
    s[0] = s[1] = s[2] = 0.f;
    k = k_;
    T = blockDim.x;
    tid = threadIdx.x;
    col = red + T + tid;
    if (RED == 1)
      for (int j = 0; j < k; ++j) col[j * T] = 0.f;
  }

  __device__ __forceinline__ void add(float src, int cls, float x) {
    if (src == -INFINITY) return;  // weight 0
    if (src > m) {
      const float sc = expf(m - src);  // 0 on the first particle
      if (RED == 1) {
        for (int j = 0; j < k; ++j) col[j * T] *= sc;
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) s[j] *= sc;
      }
      m = src;
    }
    const float e = expf(src - m);
    if (RED == 1) {
      col[cls * T] += e;
    } else {
      s[0] += e;
      s[1] += e * x;
      s[2] += e * x * x;
    }
  }

  // Fold the block's threads into out[0..K-1] (sums) and out[K] (max).
  __device__ __forceinline__ void block_store(float* red, float* out) {
    float* sm = red;      // [T]
    float* ss = red + T;  // [K][T]
    sm[tid] = m;
    if (RED == 2)
      for (int j = 0; j < 3; ++j) ss[j * T + tid] = s[j];
    __syncthreads();
    for (int j = tid; j <= k; j += T) {
      float mb = -INFINITY;
      for (int t = 0; t < T; ++t) mb = fmaxf(mb, sm[t]);
      if (j < k) {
        float sum = 0.f;
        for (int t = 0; t < T; ++t)
          if (sm[t] > -INFINITY) sum += expf(sm[t] - mb) * ss[j * T + t];
        out[j] = sum;
      } else {
        out[k] = mb;
      }
    }
  }
};

}  // namespace vbn
