// Particle resampling kernels for the PyTorch port, written for Hopper (sm_90a).
//
// vbn_cumsum replaces the TPU kernel
//   vectorizedbayesiannetwork_tpu/ops/scan_pallas.py:33 _cumsum_kernel,
// vbn_cum_index replaces
//   vectorizedbayesiannetwork_tpu/ops/resample_pallas.py:250 _prebuild_kernel,
// vbn_srg replaces
//   vectorizedbayesiannetwork_tpu/ops/resample_pallas.py:472 _srg_kernel,
// and vbn_spg replaces
//   vectorizedbayesiannetwork_tpu/ops/resample_pallas.py:531 _spg_kernel.
//
// vbn_cumsum: inclusive scan of each row of a [B, S] float32 array, a
// deterministic reduce-then-scan over tiles of CS_TILE = 8192 entries, a
// block of 1024 threads a tile (B x S / 8192 blocks, so every SM works at
// RIS's B = 8, S = 2^20: 1024 blocks). Both passes scan their tile the
// same way (tile_scan: every thread starts its 8 coalesced loads at once,
// each warp scans its 32 entries of a sub-chunk with shuffles, warp 0
// scans the 256 warp totals), so a tile's local prefix sums l_i are the
// same bits in both.
// - Pass 1 (cumsum_tile_kernel) writes each tile's total and the largest
//   of its l_i to a [B, tiles] scratch the wrapper allocates.
// - Pass 2 (cumsum_kernel): warp 0 scans the row's tile totals in one fixed
//   order (a contiguous run a lane, then the lanes' totals by shuffles), the
//   same in every block, so tile j's exclusive prefix e_j is the same bits
//   wherever it is computed; the block writes fl(e_j + l_i). With
//   `monotone`, the running max of those outputs: within the tile by the
//   same shuffle pattern, seeded with the largest output of the earlier
//   tiles, max over j' < j of fl(e_j' + max l) (round-to-nearest addition
//   is monotone, so that is the largest of their outputs): an exact running
//   max over the kernel's own prefix sums, nondecreasing, with no chained
//   look-back between blocks. A decoupled look-back would group the sums by
//   which predecessor published first, so two runs could differ in the last
//   bit; this grouping does not depend on timing, and reruns are bitwise
//   equal.
// On weights that are multiples of 2^-23 summing to at most 2, every
// partial sum is exact, so any grouping gives torch.cumsum's bits.
// Bound: bytes (one read and one write of the row); the second pass reads
// the row again, mostly from L2 (RIS's 33.5 MB fits the 50 MB).
//
// The merge's tile pointers. The TPU kernel _prebuild_kernel builds, per
// 512-entry window of the CDF, a header (supercolumn lasts, the CDF
// transposed to 8 sublanes, column lasts) and a transposed copy of the
// values, because its vector unit resolves a rank with in-register lane
// gathers of 8 candidates. A CUDA thread indexes shared memory directly, so
// the Hopper merge needs neither; what it needs of an index is each output
// tile's window pointer, min(#{w : lasts[w] <= q_k}, S/512 - 2) (the
// _window_pointers of resample_pallas.py:83), where lasts[w] = c[w*512 + 511]
// and q_k is the tile's first position. merge_kernel derives its run's
// pointers itself, at the run's start, with run_pointers: the block stages
// a coarse sample of the lasts (every G-th, G = max(16, ceil(kw / 2048)))
// into shared memory in one round trip; each thread counts the coarse
// entries <= q by a shared-memory search, which puts its count in a bracket
// of G - 1 lasts, and counts those, loaded together from the CDF in place
// (a second round trip). The same count yields c[p*512 - 1], the CDF entry
// before the pair (a load only where the pointer is clamped). A pointer is
// a hint: the merge is exact for any pointer (below). vbn_cum_index is the
// routine's own entry point (cum_index_kernel calls run_pointers on runs of
// 128 queries): it writes the lasts and the pointers of any queries, so the
// routine is held bit for bit against its plain version; the served path
// does not launch it.
//
// vbn_srg / vbn_spg: one template, merge_kernel<SYS, DS>. The function:
// each output position u (systematic: (k*512 + lane) * (1/S) + u0 * (1/S),
// in that float32 order with _rn intrinsics so nvcc fuses nothing; sorted:
// read from pos), clamped to [0, 1 - 2^-24], takes the ancestor
// #{i : cum_i <= u} = searchsorted(cum, u, 'right'), clipped to S - 1, and
// the output copies that ancestor's D values. Bound: bytes (the CDF, the
// values, the positions and the output once each); a chain of dependent
// loads per tile (pointer, window, search, values) makes a naive design
// latency-bound instead, so the design keeps loads in flight:
// - Runs: a block of MT = 128 threads owns a run of consecutive output
//   tiles (512 positions each) of one row, and derives the run's tile
//   pointers at its start (run_pointers, above). The grid is sized once per
//   process and device from the SM count and the kernel's occupancy, so
//   the runs fill the card in one wave (at most RUN_MAX tiles a run); a
//   run never crosses rows, and the last run of a row may be shorter.
// - A ring of NS = 4 shared windows (slot = window & 3) holds the CDF and,
//   for D <= STAGE_D (DS > 0), the same windows' values. While a block
//   resolves tile r from its pair (p, p+1), cp.async brings in tile r+1's
//   pair: only the windows not staged yet, so a run reads each window once.
//   A pair that moves back, or more than NS - 2 windows ahead, would
//   overwrite the pair in use: it is loaded after the tile (one stall).
// - Each thread takes PPT = 4 positions, t + 128 j, and resolves each by
//   its own 11-step branchless search of the pair, the four interleaved,
//   so positions need not be sorted; neighbouring threads search
//   neighbouring entries, so the searches meet few bank conflicts. A position below the window before
//   the pair (c[p*512 - 1], read once per tile at the run's start) takes a
//   binary search of the CDF in global memory; one past the pair, the
//   window just past it when its last (read in place, c[w*512 + 511])
//   exceeds the position, else a search of the lasts, and then a search
//   inside the window: the count is exact for any position and any pointer
//   (pointers are clamped to [0, S/512 - 2]). Positions past the pair are
//   rare, but a search of the lasts holds its warp for 11 dependent loads;
//   most land in the next window, where one load settles them.
// - Staged values: the gather reads shared memory and consecutive threads
//   store consecutive positions. Wider D stages the ancestors instead
//   and copies the values with consecutive threads on consecutive output
//   floats (ancestors are nondecreasing for sorted positions, so the reads
//   coalesce too).
// Offsets into [B, S, D] arrays are 64-bit: B*S*D passes 2^31 at D = 512.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W = 512;           // CDF entries per window
constexpr int T = 512;           // output positions per tile
constexpr int CS_THREADS = 1024;  // vbn_cumsum threads per block
constexpr int CS_ITEMS = 8;       // entries per thread per chunk
constexpr int CS_WARPS = CS_THREADS / 32;
constexpr int CS_TILE = CS_THREADS * CS_ITEMS;  // vbn_cumsum entries per tile
constexpr float POS_MAX = 0.99999994039535522f;  // 1 - 2^-24
constexpr int MT = 128;          // merge threads a block
constexpr int PPT = T / MT;      // merge positions a thread
constexpr int NS = 4;            // merge ring: shared windows a block
constexpr int RUN_MAX = MT;      // merge tiles a run (one pointer a thread)
constexpr int STAGE_D = 4;       // widest D whose values the ring stages
constexpr int MAX_DEVICES = 64;  // devices whose merge grid is cached
constexpr int CG = 16;           // least windows per coarse entry
constexpr int C_MAX = NS * W;    // most coarse entries (the ring's CDF slots)
static_assert(T == W && T % MT == 0, "a tile is PPT rounds of MT positions");
static_assert((NS & (NS - 1)) == 0, "slot = window & (NS - 1)");

__device__ __forceinline__ float clamp_pos(float u) {
  return fminf(fmaxf(u, 0.f), POS_MAX);
}

// #{i in [lo, hi) : a[i] <= u} + lo for a nondecreasing a.
__device__ __forceinline__ long long upper_bound(const float* __restrict__ a,
                                                 long long lo, long long hi,
                                                 float u) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= u)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// #{w in [lo, hi) : c[w*W + W-1] <= u} + lo: the window lasts, read in place.
// Not inlined: the merge takes it rarely, and inlined into its four
// positions' fallbacks it spilled merge_kernel<0,1> at 64 registers.
__device__ __noinline__ int upper_bound_lasts(const float* __restrict__ c,
                                              int lo, int hi, float u) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c[(size_t)mid * W + (W - 1)] <= u)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Windows per coarse entry for kw windows: at least CG, and at most C_MAX
// entries (kw / g of them, whole groups only).
__device__ __forceinline__ int coarse_stride(int kw) {
  return max(CG, (kw + C_MAX - 1) / C_MAX);
}

// The window pointers of a block's run of n <= MT positions (thread t < n
// holds head t, clamped): s_ptr[t] = min(#{w : lasts[w] <= head}, kw - 2)
// and s_prev[t] = c[s_ptr[t]*W - 1] (-inf for 0), where lasts[w] =
// c[w*W + W-1] is read in place. Every thread of the block calls it. The
// block stages a coarse sample of the lasts, entry m the last of window
// m*g + g - 1 (m < kw / g), into s_coarse (one round trip); each thread
// t < n counts the entries <= its head by bisection, cm, which puts its
// count in [cm*g, cm*g + g - 1] (the lasts are nondecreasing), and counts
// that bracket's lasts, loaded together CG - 1 at a time (a second round
// trip); the largest last <= head is lasts[count - 1]. It ends in a
// barrier, after which s_coarse may be reused.
__device__ __forceinline__ void run_pointers(const float* __restrict__ c,
                                             int kw, float head, int t, int n,
                                             float* s_coarse, int32_t* s_ptr,
                                             float* s_prev) {
  const int g = coarse_stride(kw), nc = kw / g;
  for (int m = t; m < nc; m += MT)
    s_coarse[m] = c[((size_t)m * g + g - 1) * W + (W - 1)];
  __syncthreads();
  if (t < n) {
    int cm = 0, hi = nc;
    while (cm < hi) {
      const int mid = (cm + hi) >> 1;
      if (s_coarse[mid] <= head)
        cm = mid + 1;
      else
        hi = mid;
    }
    float last = cm > 0 ? s_coarse[cm - 1] : -INFINITY;
    const int w0 = cm * g, w1 = min(w0 + g - 1, kw);
    int count = w0;
    for (int base = w0; base < w1; base += CG - 1) {
      float l[CG - 1];
#pragma unroll
      for (int i = 0; i < CG - 1; ++i)
        l[i] = base + i < w1 ? c[(size_t)(base + i) * W + (W - 1)] : INFINITY;
#pragma unroll
      for (int i = 0; i < CG - 1; ++i)
        if (l[i] <= head) {
          ++count;
          last = l[i];
        }
    }
    const int p = min(count, kw - 2);
    if (p < count) last = p > 0 ? c[(size_t)p * W - 1] : -INFINITY;
    s_ptr[t] = p;
    s_prev[t] = last;
  }
  __syncthreads();
}

// Exclusive scan by warp 0 of the CS_ITEMS * CS_WARPS block partials in
// `buf` (sum, or max with MAX), in entry order j * CS_WARPS + warp. Writes
// each partial's exclusive prefix (seeded with `seed`) back into `buf` and
// returns the inclusive total (lane-uniform) to warp 0.
template <bool MAX>
__device__ __forceinline__ float scan_partials(float* buf, float seed,
                                               int lane) {
  constexpr int PER = CS_ITEMS * CS_WARPS / 32;  // 8 partials a lane
  float t[PER];
  float run = MAX ? -INFINITY : 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float x = buf[lane * PER + i];
    t[i] = run;  // exclusive within the lane
    run = MAX ? fmaxf(run, x) : __fadd_rn(run, x);
  }
  float incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = MAX ? fmaxf(incl, y) : __fadd_rn(incl, y);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = MAX ? -INFINITY : 0.f;
  excl = MAX ? fmaxf(excl, seed) : __fadd_rn(seed, excl);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    buf[lane * PER + i] = MAX ? fmaxf(excl, t[i]) : __fadd_rn(excl, t[i]);
  const float total = __shfl_sync(0xffffffffu, incl, 31);
  return MAX ? fmaxf(seed, total) : __fadd_rn(seed, total);
}

// The local inclusive scan of tile `tile` of row xr: v[j] = the prefix sum
// within the tile up to entry tile * CS_TILE + j * CS_THREADS + tid (entries
// past s count 0). Every thread of the block calls it; it leaves the tile's
// total in *s_total.
__device__ __forceinline__ void tile_scan(const float* __restrict__ xr,
                                          long long s, long long base,
                                          float (&v)[CS_ITEMS], float* s_part,
                                          float* s_total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < CS_ITEMS; ++j) {
    const long long e = base + (long long)j * CS_THREADS + tid;
    v[j] = e < s ? xr[e] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < CS_ITEMS; ++j) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, v[j], d);
      if (lane >= d) v[j] = __fadd_rn(v[j], y);
    }
    if (lane == 31) s_part[j * CS_WARPS + warp] = v[j];
  }
  __syncthreads();
  if (warp == 0) {
    const float total = scan_partials<false>(s_part, 0.f, lane);
    if (lane == 0) *s_total = total;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CS_ITEMS; ++j)
    v[j] = __fadd_rn(s_part[j * CS_WARPS + warp], v[j]);
}

// Pass 1: tile (blockIdx.y) of row (blockIdx.x): its total and the largest
// of its local prefix sums into part[row * tiles + tile].
__global__ void __launch_bounds__(CS_THREADS)
cumsum_tile_kernel(const float* __restrict__ x, long long s, int tiles,
                   float2* __restrict__ part) {
  __shared__ float s_part[CS_ITEMS * CS_WARPS];
  __shared__ float s_max[CS_WARPS];
  __shared__ float s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x, tile = blockIdx.y;
  const long long base = (long long)tile * CS_TILE;
  float v[CS_ITEMS];
  tile_scan(x + (size_t)row * (size_t)s, s, base, v, s_part, &s_total);
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < CS_ITEMS; ++j)
    if (base + (long long)j * CS_THREADS + tid < s) mx = fmaxf(mx, v[j]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = s_max[lane];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    if (lane == 0) part[(size_t)row * tiles + tile] = make_float2(s_total, mx);
  }
}

// Warp 0 of pass 2: the exclusive prefix e of tile `tile` over the row's
// tile totals, in one fixed order (lane L sums its contiguous run of
// `per` totals, the lanes' sums are scanned by shuffles, then each run is
// walked again from its lane's prefix), and the largest output of the
// earlier tiles, max over j < tile of fl(e_j + max l_j) (-inf for tile 0).
__device__ __forceinline__ void tile_prefix(const float2* __restrict__ part,
                                            int tiles, int tile, int lane,
                                            float* s_carry) {
  const int per = (tiles + 31) / 32, j0 = lane * per;
  const int j1 = min(j0 + per, tiles);
  float run = 0.f;
  for (int j = j0; j < j1; ++j) run = __fadd_rn(run, part[j].x);
  float incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = __fadd_rn(incl, y);
  }
  float e = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) e = 0.f;
  float mx = -INFINITY;
  for (int j = j0; j < j1 && j <= tile; ++j) {
    const float2 pj = part[j];
    if (j == tile) {
      s_carry[0] = e;
    } else {
      mx = fmaxf(mx, __fadd_rn(e, pj.y));
      e = __fadd_rn(e, pj.x);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  if (lane == 0) s_carry[1] = mx;
}

// Pass 2: tile (blockIdx.y) of row (blockIdx.x): fl(e + l_i), then with
// `monotone` the running max seeded with the earlier tiles' largest output.
__global__ void __launch_bounds__(CS_THREADS, 1)  // ptxas spilled at its own pick
cumsum_kernel(const float* __restrict__ x, float* __restrict__ out,
              long long s, int tiles, const float2* __restrict__ part,
              int monotone) {
  __shared__ float s_part[CS_ITEMS * CS_WARPS];
  __shared__ float s_carry[2];
  __shared__ float s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x, tile = blockIdx.y;
  const long long base = (long long)tile * CS_TILE;
  if (warp == 0)
    tile_prefix(part + (size_t)row * tiles, tiles, tile, lane, s_carry);
  float v[CS_ITEMS];
  tile_scan(x + (size_t)row * (size_t)s, s, base, v, s_part, &s_total);
  const float e = s_carry[0];  // written before tile_scan's barriers
#pragma unroll
  for (int j = 0; j < CS_ITEMS; ++j) v[j] = __fadd_rn(e, v[j]);
  if (monotone) {
    __syncthreads();  // every thread has read its offsets
#pragma unroll
    for (int j = 0; j < CS_ITEMS; ++j) {
      float m = v[j];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, m, d);
        if (lane >= d) m = fmaxf(m, y);
      }
      if (lane == 31) s_part[j * CS_WARPS + warp] = m;
      v[j] = m;  // the running max within the warp
    }
    __syncthreads();
    if (warp == 0) scan_partials<true>(s_part, s_carry[1], lane);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CS_ITEMS; ++j)
      v[j] = fmaxf(v[j], s_part[j * CS_WARPS + warp]);
  }
  float* outr = out + (size_t)row * (size_t)s;
#pragma unroll
  for (int j = 0; j < CS_ITEMS; ++j) {
    const long long i = base + (long long)j * CS_THREADS + tid;
    if (i < s) outr[i] = v[j];
  }
}

// vbn_cum_index: block x of row y writes lasts[w] and the pointers of
// queries i, for w, i in [x*MT, x*MT + MT), the queries taken as a merge
// block takes its run's tile heads (run_pointers).
__global__ void __launch_bounds__(MT)
cum_index_kernel(const float* __restrict__ cum, long long s, int kw,
                 const float* __restrict__ q, long long q_row,
                 long long q_col, int k, float* __restrict__ lasts,
                 int32_t* __restrict__ ptrs) {
  __shared__ float s_coarse[C_MAX];
  __shared__ int32_t s_ptr[MT];
  __shared__ float s_prev[MT];
  const int b = blockIdx.y, t = threadIdx.x;
  const int i = blockIdx.x * MT + t, n = min(MT, k - blockIdx.x * MT);
  const float* c = cum + (size_t)b * (size_t)s;
  const float head =
      t < n ? clamp_pos(q[(size_t)b * q_row + (size_t)i * q_col]) : 0.f;
  run_pointers(c, kw, head, t, n, s_coarse, s_ptr, s_prev);
  if (i < kw) lasts[(size_t)b * kw + i] = c[(size_t)i * W + (W - 1)];
  if (t < n) ptrs[(size_t)b * k + i] = s_ptr[t];
}

// 16 bytes global -> shared, asynchronous (cp.async.cg: L2 only).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Window w of the row's CDF (and, with DS > 0, its 512 x DS values) into
// ring slot w & (NS - 1): one 16-byte copy a thread per 2 KB.
template <int DS>
__device__ __forceinline__ void stage_window(const float* c, const float* vb,
                                             long long w, float* s_cum,
                                             float* s_val, int t) {
  const int slot = (int)(w & (NS - 1));
  cp_async16(s_cum + slot * W + 4 * t, c + w * W + 4 * t);
#pragma unroll
  for (int i = 0; i < DS; ++i)
    cp_async16(s_val + slot * W * DS + (i * MT + t) * 4,
               vb + w * W * DS + (i * MT + t) * 4);
}

// SYS: systematic positions from u0 [B]; else positions pos [B, n_out].
// DS: D when the ring stages the values (1..STAGE_D), else 0 (runtime d).
// Grid (runs, B): block x takes tiles [x * run, x * run + run) of row y.
// At DS >= 3 the ring caps an SM at 6 blocks, so 80 registers cost nothing
// (at 64, merge_kernel<1,3> spilled).
template <bool SYS, int DS>
__global__ void __launch_bounds__(MT, DS >= 3 ? 6 : 8)
merge_kernel(const float* __restrict__ cum, long long s, int kw,
             int k_tiles, int run, const float* __restrict__ u0, float inv_s,
             const float* __restrict__ pos, long long n_out,
             const float* __restrict__ values, int d,
             float* __restrict__ out) {
  extern __shared__ __align__(16) float s_ring[];  // NS x W CDF, NS x W x DS
  __shared__ int32_t s_ptr[RUN_MAX];
  __shared__ float s_prev[RUN_MAX];
  __shared__ int32_t s_anc[DS > 0 ? 1 : T];
  float* s_cum = s_ring;
  float* s_val = s_ring + NS * W;
  const int t = threadIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.x * run;
  const int n = min(run, k_tiles - k0);
  const int dd = DS > 0 ? DS : d;
  const float* c = cum + (size_t)b * (size_t)s;
  const float* vb = values + (size_t)b * (size_t)s * dd;
  const float* pr = SYS ? nullptr : pos + (size_t)b * (size_t)n_out + t;
  float next[PPT];
  float u0s = 0.f;
  float head = 0.f;  // thread t < n: tile k0 + t's first position
  if (SYS) {
    u0s = __fmul_rn(u0[b], inv_s);
    head = fminf(__fadd_rn(__fmul_rn((float)((k0 + t) * T), inv_s), u0s),
                 POS_MAX);
  } else {  // the positions of the run's first tile; each tile loads the next's
#pragma unroll
    for (int j = 0; j < PPT; ++j) next[j] = pr[(size_t)k0 * T + MT * j];
    if (t < n) head = clamp_pos(pos[(size_t)b * (size_t)n_out +
                                    (size_t)(k0 + t) * T]);
  }
  // The run's tile pointers; the coarse sample lives in the ring's CDF
  // slots until the first stage.
  run_pointers(c, kw, head, t, n, s_cum, s_ptr, s_prev);
  int p = s_ptr[0];
  stage_window<DS>(c, vb, p, s_cum, s_val, t);
  stage_window<DS>(c, vb, p + 1, s_cum, s_val, t);
  cp_async_commit();
  for (int r = 0; r < n; ++r) {
    const int k = k0 + r;
    float u[PPT];
    if (SYS) {
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        u[j] = fminf(__fadd_rn(__fmul_rn((float)(k * T + MT * j + t), inv_s),
                               u0s),
                     POS_MAX);
    } else {
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        u[j] = clamp_pos(next[j]);
        if (r + 1 < n) next[j] = pr[(size_t)(k + 1) * T + MT * j];
      }
    }
    cp_async_wait_all();
    __syncthreads();  // tile r's pair is staged; tile r - 1 is done
    int pn = p;       // tile r + 1's pair: prefetch the windows it lacks
    bool later = false;
    if (r + 1 < n) {
      pn = s_ptr[r + 1];
      if (pn >= p && pn <= p + NS - 2) {
        for (int w = max(p + 2, pn); w < pn + 2; ++w)
          stage_window<DS>(c, vb, w, s_cum, s_val, t);
        cp_async_commit();
      } else {
        later = true;  // it would overwrite the pair in use
      }
    }
    // branchless search of the pair: the first step picks the window
    const float prev = s_prev[r];
    const int oa = (p & (NS - 1)) * W, ob = ((p + 1) & (NS - 1)) * W;
    const float last_a = s_cum[oa + W - 1];
    int off[PPT], cnt[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const bool in_b = last_a <= u[j];
      off[j] = in_b ? ob : oa;
      cnt[j] = in_b ? W : 0;
    }
    int i[PPT] = {0, 0, 0, 0};
#pragma unroll
    for (int step = W / 2; step > 0; step >>= 1) {
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        if (s_cum[off[j] + i[j] + step - 1] <= u[j]) i[j] += step;
    }
    const long long w0 = (long long)p * W;
    long long anc[PPT];
    int loc[PPT];  // index in the pair, or -1 where the pair is not it
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int lo = cnt[j] + i[j] + (s_cum[off[j] + i[j]] <= u[j]);
      long long rank;
      loc[j] = -1;
      if (u[j] < prev) {
        rank = upper_bound(c, 0, w0, u[j]);  // before the pair
      } else if (lo < 2 * W) {
        rank = w0 + lo;
        loc[j] = lo;
      } else {  // past the pair: the window by its last entry (most often
                // the next one: one load), then the entry
        int w = p + 2;
        if (w < kw && c[(size_t)w * W + (W - 1)] <= u[j])
          w = upper_bound_lasts(c, p + 3, kw, u[j]);
        const long long e = (long long)w * W;
        rank = w == kw ? s : upper_bound(c, e, e + W, u[j]);
      }
      anc[j] = rank < s ? rank : s - 1;
    }
    if (DS > 0) {
      float* ot = out + ((size_t)b * (size_t)n_out + (size_t)k * T + t) * DS;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int l = loc[j];
        float* oj = ot + MT * j * DS;
        if (l >= 0) {
          const int so = ((p + (l >> 9)) & (NS - 1)) * W + (l & (W - 1));
#pragma unroll
          for (int f = 0; f < DS; ++f) oj[f] = s_val[so * DS + f];
        } else {
#pragma unroll
          for (int f = 0; f < DS; ++f) oj[f] = vb[anc[j] * DS + f];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < PPT; ++j) s_anc[MT * j + t] = (int32_t)anc[j];
      __syncthreads();
      float* ot = out + ((size_t)b * (size_t)n_out + (size_t)k * T) * d;
      for (int e = t; e < T * d; e += MT) {
        const int j = e / d, f = e - j * d;
        ot[e] = vb[(size_t)s_anc[j] * d + f];
      }
    }
    if (later) {
      __syncthreads();  // every thread is done with the pair in use
      stage_window<DS>(c, vb, pn, s_cum, s_val, t);
      stage_window<DS>(c, vb, pn + 1, s_cum, s_val, t);
      cp_async_commit();
    }
    p = pn;
  }
}

constexpr size_t merge_smem(int ds) {
  return (size_t)NS * W * (1 + ds) * sizeof(float);
}

// Launch merge_kernel<SYS, DS> on tiles of S_out / 512 positions. The grid
// is sized from the SM count and the kernel's blocks an SM, read once per
// process and device: runs of ceil(tiles / slots) tiles, at most RUN_MAX.
template <bool SYS, int DS>
cudaError_t launch_merge(const float* cum, int b, long long s_in,
                         const float* u0, float inv_s, const float* pos,
                         long long s_out, const float* values, int d,
                         float* out, cudaStream_t st, int* grid_out) {
  static int slots_cache[MAX_DEVICES];  // SMs x blocks an SM; 0 = not read
  auto kernel = merge_kernel<SYS, DS>;
  const size_t smem = merge_smem(DS);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int slots = dev < MAX_DEVICES ? slots_cache[dev] : 0;
  if (slots == 0) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MT,
                                                        smem);
    if (e != cudaSuccess) return e;
    slots = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < MAX_DEVICES) slots_cache[dev] = slots;
  }
  const int k_tiles = (int)(s_out / T);
  long long run = ((long long)b * k_tiles + slots - 1) / slots;
  run = run < 1 ? 1 : (run > RUN_MAX ? RUN_MAX : run);
  const int runs = (int)((k_tiles + run - 1) / run);
  if (grid_out) {
    grid_out[0] = runs;
    grid_out[1] = (int)run;
    grid_out[2] = slots;
    return cudaSuccess;
  }
  kernel<<<dim3(runs, b), MT, smem, st>>>(cum, s_in, (int)(s_in / W), k_tiles,
                                         (int)run, u0, inv_s, pos, s_out,
                                         values, d, out);
  return cudaGetLastError();
}

template <bool SYS>
cudaError_t merge_by_d(const float* cum, int b, long long s_in,
                       const float* u0, float inv_s, const float* pos,
                       long long s_out, const float* values, int d, float* out,
                       cudaStream_t st, int* grid_out) {
  switch (d) {
#define VBN_MERGE_CASE(DS)                                                   \
  case DS:                                                                   \
    return launch_merge<SYS, DS>(cum, b, s_in, u0, inv_s, pos, s_out, values, \
                                 d, out, st, grid_out);
    VBN_MERGE_CASE(1)
    VBN_MERGE_CASE(2)
    VBN_MERGE_CASE(3)
    VBN_MERGE_CASE(4)
#undef VBN_MERGE_CASE
    default:
      return launch_merge<SYS, 0>(cum, b, s_in, u0, inv_s, pos, s_out, values,
                                  d, out, st, grid_out);
  }
}
static_assert(STAGE_D == 4, "merge_by_d stages D = 1..4");

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launch; stream is a
// cudaStream_t passed as an integer by the caller.

// vbn_cumsum's scratch: floats per row (two a tile).
long long vbn_cumsum_scratch(long long s) {
  return 2 * ((s + CS_TILE - 1) / CS_TILE);
}

int vbn_cumsum(const float* x, float* out, int b, long long s, int monotone,
               float* scratch, void* stream) {
  const int tiles = (int)((s + CS_TILE - 1) / CS_TILE);
  float2* part = reinterpret_cast<float2*>(scratch);
  const dim3 grid(b, tiles);
  cumsum_tile_kernel<<<grid, CS_THREADS, 0, (cudaStream_t)stream>>>(
      x, s, tiles, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cumsum_kernel<<<grid, CS_THREADS, 0, (cudaStream_t)stream>>>(
      x, out, s, tiles, part, monotone);
  return (int)cudaGetLastError();
}

int vbn_cum_index(const float* cum, int b, long long s, const float* q,
                  long long q_row, long long q_col, int k, float* lasts,
                  int32_t* ptrs, void* stream) {
  const int kw = (int)(s / W);
  const int n = kw > k ? kw : k;
  dim3 grid((n + MT - 1) / MT, b);
  cum_index_kernel<<<grid, MT, 0, (cudaStream_t)stream>>>(
      cum, s, kw, q, q_row, q_col, k, lasts, ptrs);
  return (int)cudaGetLastError();
}

int vbn_srg(const float* cum, int b, long long s, const float* u0,
            float inv_s, const float* values, int d, float* out,
            void* stream) {
  return (int)merge_by_d<true>(cum, b, s, u0, inv_s, nullptr, s, values, d,
                               out, (cudaStream_t)stream, nullptr);
}

int vbn_spg(const float* cum, int b, long long s_in, const float* pos,
            long long s_out, const float* values, int d, float* out,
            void* stream) {
  return (int)merge_by_d<false>(cum, b, s_in, nullptr, 0.f, pos, s_out,
                                values, d, out, (cudaStream_t)stream, nullptr);
}

// The merge's grid for B rows of S_out positions and D columns, as
// vbn_srg / vbn_spg would launch it: grid[0] runs a row, grid[1] tiles a
// run, grid[2] the card's block slots (SMs x blocks an SM). Launches
// nothing.
int vbn_merge_grid(int b, long long s_out, int d, int sys, int* grid) {
  return (int)(sys ? merge_by_d<true>(nullptr, b, s_out, nullptr, 0.f,
                                      nullptr, s_out, nullptr, d, nullptr, 0,
                                      grid)
                   : merge_by_d<false>(nullptr, b, s_out, nullptr, 0.f,
                                       nullptr, s_out, nullptr, d, nullptr, 0,
                                       grid));
}

}  // extern "C"
