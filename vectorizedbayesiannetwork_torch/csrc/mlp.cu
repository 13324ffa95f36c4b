// vbn_gauss_mlp: the served forward of a neural Gaussian CPD (gaussian_nn)
// in one pass, from a node's flat parents to its denormalized (loc, scale).
//
// No TPU kernel stands behind it: the JAX package leaves the MLP to XLA
// (models/gaussian_nn.py, models/_mlp.py), and the port's plain route is
// models/gaussian_nn.py::_denorm_params -> models/_mlp.py::mlp_apply: three
// addmm products (a bias copy and a cuBLAS float32 GEMM at K = 32 each),
// ReLU as passes of their own, the standardization, softplus and
// denormalization as elementwise passes, and two [m, 32] hiddens written to
// and read from device memory. ops/mlp_fused.py::gauss_mlp_plain is the
// plain version of this kernel's arithmetic.
//
// For each row, in float32 and in the plain route's order of operations:
//   pn  = (parents - mean_x) / std_x                  (a true division)
//   h1  = relu(pn @ W1 + b1);  h2 = relu(h1 @ W2 + b2);  out = h2 @ W3 + b3
//   loc = out[:D] * std_y + mean_y
//   scale = (softplus(out[D:]) + min_scale) * std_y   (softplus: x past 20
//                                                      is x, else log1p(exp))
// Each product is a chain of FFMA over ascending k with the bias added after
// it; no TF32, no fast-math intrinsic. ReLU keeps a NaN (max.NaN), as
// torch's does.
//
// Bound: operations. A row at dp = 3 parents and widths (32, 32) takes 1,184
// multiply-adds and about 2,500 float32 operations in all; its inputs and
// outputs are 20 bytes. With the hiddens kept out of device memory the
// kernel is bound by FFMA issue on the CUDA cores (67 TFLOP/s float32 on an
// H100 SXM: about 3.8 ms for 100.7M rows at dp = 3).
//
// Design: each block first stages the node's weights and statistics (about
// 5 KB) in shared memory, W2 transposed so that a second-layer unit's 32
// weights lie side by side. A thread takes ROWS rows THREADS apart (a warp
// reads and writes neighbouring rows) and keeps their first hidden layer in
// registers; the second layer runs UNITS units at a time, each unit's dot
// product for every row its own accumulator chain (ROWS x UNITS chains hide
// the FFMA latency), and each finished unit goes at once through its ReLU
// into the head's accumulators, so no second hidden is ever held whole. A
// weight is read as one of a 16-byte broadcast (every thread of the block
// reads the same address) and feeds ROWS multiply-adds. Blocks are
// persistent: as many as fit on the card at once walk the tiles of
// THREADS x ROWS rows, with 64-bit row indices.
//
// The kernel is templated on the number of parents (1-4), the two hidden
// widths and the output width; (32, 32) with one output is instantiated,
// the configuration's shape. The wrapper routes every other shape to the
// plain route.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 4;   // rows a thread
constexpr int UNITS = 2;  // second-layer units a step
constexpr int MAX_DEVICES = 64;  // devices whose grid cap is cached

// The node's tensors, each contiguous float32 on the device.
struct Net {
  const float* mean_x;  // [dp]
  const float* std_x;   // [dp]
  const float* w1;      // [dp, h1]
  const float* b1;      // [h1]
  const float* w2;      // [h1, h2]
  const float* b2;      // [h2]
  const float* w3;      // [h2, 2 dout]
  const float* b3;      // [2 dout]
  const float* mean_y;  // [dout]
  const float* std_y;   // [dout]
};

__device__ __forceinline__ float relu(float x) {
  float y;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(y) : "f"(x));
  return y;
}

// F.softplus at beta 1, threshold 20.
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <int DP, int H1, int H2, int DOUT>
struct Smem {
  static constexpr int O = 2 * DOUT;
  float w1[DP][H1];
  float b1[H1];
  float w2t[H2][H1];  // W2 transposed: a unit's weights side by side
  float b2[H2];
  float w3[H2][O];
  float b3[O];
  float mean_x[DP], std_x[DP];
  float mean_y[DOUT], std_y[DOUT];
};

template <int DP, int H1, int H2, int DOUT>
__device__ void stage(Smem<DP, H1, H2, DOUT>& s, const Net& net) {
  constexpr int O = 2 * DOUT;
  for (int i = threadIdx.x; i < DP * H1; i += THREADS)
    s.w1[i / H1][i % H1] = net.w1[i];
  for (int i = threadIdx.x; i < H1 * H2; i += THREADS)
    s.w2t[i % H2][i / H2] = net.w2[i];
  for (int i = threadIdx.x; i < H2 * O; i += THREADS)
    s.w3[i / O][i % O] = net.w3[i];
  for (int i = threadIdx.x; i < H1; i += THREADS) s.b1[i] = net.b1[i];
  for (int i = threadIdx.x; i < H2; i += THREADS) s.b2[i] = net.b2[i];
  if (threadIdx.x < O) s.b3[threadIdx.x] = net.b3[threadIdx.x];
  if (threadIdx.x < DP) {
    s.mean_x[threadIdx.x] = net.mean_x[threadIdx.x];
    s.std_x[threadIdx.x] = net.std_x[threadIdx.x];
  }
  if (threadIdx.x < DOUT) {
    s.mean_y[threadIdx.x] = net.mean_y[threadIdx.x];
    s.std_y[threadIdx.x] = net.std_y[threadIdx.x];
  }
  __syncthreads();
}

template <int DP, int H1, int H2, int DOUT>
__global__ void __launch_bounds__(THREADS)
gauss_mlp_kernel(const float* __restrict__ parents, long long m, Net net,
                 float min_scale, float* __restrict__ loc,
                 float* __restrict__ scale) {
  static_assert(H1 % 4 == 0 && H2 % UNITS == 0, "widths: H1 % 4, H2 % UNITS");
  constexpr int O = 2 * DOUT;
  __shared__ __align__(16) Smem<DP, H1, H2, DOUT> s;
  stage(s, net);

  const long long tiles = (m + THREADS * ROWS - 1) / (THREADS * ROWS);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * (THREADS * ROWS) + threadIdx.x;
    long long row[ROWS];
    bool live[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      row[r] = row0 + (long long)r * THREADS;
      live[r] = row[r] < m;
    }

    // the standardized parents
    float pn[ROWS][DP];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        const float p = live[r] ? __ldg(parents + row[r] * DP + k) : 0.f;
        pn[r][k] = __fdiv_rn(__fsub_rn(p, s.mean_x[k]), s.std_x[k]);
      }

    // the first hidden layer, held in registers
    float h1[ROWS][H1];
#pragma unroll
    for (int j = 0; j < H1; j += 4) {
      float acc[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(&s.w1[k][j]);
        const float wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = __fmaf_rn(pn[r][k], wq[q], acc[r][q]);
      }
      const float4 b = *reinterpret_cast<const float4*>(&s.b1[j]);
      const float bq[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          h1[r][j + q] = relu(__fadd_rn(acc[r][q], bq[q]));
    }

    // the second layer, UNITS units at a time, each through its ReLU into
    // the head
    float out[ROWS][O];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int o = 0; o < O; ++o) out[r][o] = 0.f;
#pragma unroll 1
    for (int j = 0; j < H2; j += UNITS) {
      float acc[ROWS][UNITS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int u = 0; u < UNITS; ++u) acc[r][u] = 0.f;
#pragma unroll
      for (int k = 0; k < H1; k += 4) {
        float wq[UNITS][4];
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
          const float4 w = *reinterpret_cast<const float4*>(&s.w2t[j + u][k]);
          wq[u][0] = w.x;
          wq[u][1] = w.y;
          wq[u][2] = w.z;
          wq[u][3] = w.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < UNITS; ++u)
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r][u] = __fmaf_rn(h1[r][k + q], wq[u][q], acc[r][u]);
      }
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const float b = s.b2[j + u];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float h2 = relu(__fadd_rn(acc[r][u], b));
#pragma unroll
          for (int o = 0; o < O; ++o)
            out[r][o] = __fmaf_rn(h2, s.w3[j + u][o], out[r][o]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (!live[r]) continue;
#pragma unroll
      for (int d = 0; d < DOUT; ++d) {
        const float a = __fadd_rn(out[r][d], s.b3[d]);
        const float z = __fadd_rn(out[r][DOUT + d], s.b3[DOUT + d]);
        loc[row[r] * DOUT + d] =
            __fadd_rn(__fmul_rn(a, s.std_y[d]), s.mean_y[d]);
        scale[row[r] * DOUT + d] =
            __fmul_rn(__fadd_rn(softplus(z), min_scale), s.std_y[d]);
      }
    }
  }
}

template <int DP, int H1, int H2, int DOUT>
cudaError_t launch(const float* parents, long long m, const Net& net,
                   float min_scale, float* loc, float* scale,
                   cudaStream_t stream) {
  auto kernel = gauss_mlp_kernel<DP, H1, H2, DOUT>;
  // blocks resident on a card at once, read once per process and device
  static std::atomic<int> cap_cache[MAX_DEVICES];  // 0 = not read
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int grid_cap =
      dev < MAX_DEVICES ? cap_cache[dev].load(std::memory_order_relaxed) : 0;
  if (grid_cap == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
    if (e != cudaSuccess) return e;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < MAX_DEVICES)
      cap_cache[dev].store(grid_cap, std::memory_order_relaxed);
  }
  const long long tiles = (m + THREADS * ROWS - 1) / (THREADS * ROWS);
  const int grid = (int)(tiles < grid_cap ? tiles : grid_cap);
  kernel<<<grid, THREADS, 0, stream>>>(parents, m, net, min_scale, loc, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// parents: [m, dp]; tensors: a host array of the ten device pointers of Net,
// in its order; loc, scale: [m, dout]; all float32, contiguous.
// Returns a CUDA error code, cudaErrorInvalidValue for a shape no template
// covers.
int vbn_gauss_mlp(const float* parents, long long m, int dp, int h1, int h2,
                  int dout, const float* const* tensors, float min_scale,
                  float* loc, float* scale, void* stream) {
  if (m < 1 || h1 != 32 || h2 != 32 || dout != 1)
    return (int)cudaErrorInvalidValue;
  const Net net = {tensors[0], tensors[1], tensors[2], tensors[3], tensors[4],
                   tensors[5], tensors[6], tensors[7], tensors[8], tensors[9]};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dp) {
    case 1: return (int)launch<1, 32, 32, 1>(parents, m, net, min_scale, loc, scale, st);
    case 2: return (int)launch<2, 32, 32, 1>(parents, m, net, min_scale, loc, scale, st);
    case 3: return (int)launch<3, 32, 32, 1>(parents, m, net, min_scale, loc, scale, st);
    case 4: return (int)launch<4, 32, 32, 1>(parents, m, net, min_scale, loc, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
