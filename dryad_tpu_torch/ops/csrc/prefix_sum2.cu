// prefix_sum2 — compensated (double-single) f32 inclusive scan: every
// prefix comes back as an unevaluated pair (hi, lo) with hi + lo the
// prefix to about twice f32's precision.
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_kernels.py:300 prefix_sum2
// (pallas_call at :330, body _scan2_kernel_body at :219, combine _dd_add
// at :205).
//
// Bound on Hopper: bytes.  The scan must read n floats and write 2n
// (12n bytes); the ~20 flops of each TwoSum combine are nothing to the
// card at these sizes.
//
// Design: prefix_sum.cu's reduce-then-scan in three launches, with every
// `+` replaced by the TwoSum combine on a (hi, lo) pair and every warp
// shuffle moving both floats:
//   1. scan2_partials: each block reduces one tile of kTile elements to a
//      (hi, lo) total;
//   2. scan2_carry: one block turns the tile totals into their exclusive
//      prefix, walking them tile by tile with a register carry;
//   3. scan2_tiles: each block scans its tile again and adds the
//      exclusive prefix of the tiles before it.
// (The names differ from prefix_sum.cu's so that a profile tells the two
// kernels apart.)  Inside a tile, each thread scans its kItems values, the
// warps scan the thread totals, warp 0 scans the warp totals — all from
// zero, so the tile-local prefix stays at the tile's own magnitude.  The
// large exclusive offset of the tiles before is added to each element
// ONCE, last: a prefix of size P then takes one rounding at P's scale
// (plus the offset's own, shared by the whole tile), which is what keeps
// the difference of two nearby prefixes near ulp of the difference.
//
// Every addition is __fadd_rn / __fsub_rn: round-to-nearest, never
// contracted into an FMA, never flushed to zero, in the order written —
// TwoSum is exact only under those rules.  The combine is not associative
// in the last bits, so this kernel, its plain version (a log-step scan)
// and the JAX function agree within an error bound, not bit for bit.
// Like prefix_sum.cu it reads its input twice (16n bytes moved for 12n
// needed).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

struct dd {
  float hi, lo;
};

__device__ __forceinline__ dd dd_zero() { return {0.0f, 0.0f}; }

// The JAX package's _dd_add, step for step: Knuth's TwoSum of the high
// parts, the low parts and the rounding error summed, Dekker's
// renormalisation.  `a` is the earlier operand.
__device__ __forceinline__ dd dd_add(dd a, dd b) {
  const float s = __fadd_rn(a.hi, b.hi);
  const float bb = __fsub_rn(s, a.hi);
  const float err = __fadd_rn(__fsub_rn(a.hi, __fsub_rn(s, bb)),
                              __fsub_rn(b.hi, bb));
  const float lo = __fadd_rn(__fadd_rn(a.lo, b.lo), err);
  const float hn = __fadd_rn(s, lo);
  return {hn, __fsub_rn(lo, __fsub_rn(hn, s))};
}

__device__ __forceinline__ dd shfl_up(dd v, int o) {
  return {__shfl_up_sync(kFull, v.hi, o), __shfl_up_sync(kFull, v.lo, o)};
}

__device__ __forceinline__ dd shfl_down(dd v, int o) {
  return {__shfl_down_sync(kFull, v.hi, o),
          __shfl_down_sync(kFull, v.lo, o)};
}

// shared-memory index with one pad slot per 32 (see prefix_sum.cu)
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ dd warp_inclusive(dd v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const dd u = shfl_up(v, o);
    if (lane >= o) v = dd_add(u, v);
  }
  return v;
}

// Scan the tile held in s[pad(0 .. kTile)] in place: each slot becomes
// offset + (the tile-local exclusive or inclusive prefix).  Returns the
// tile-local total (the same value in every thread).
__device__ dd scan_smem(dd* s, dd offset, bool exclusive, dd* warp_tot) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = tid * kItems;
  dd v[kItems];
  dd run = dd_zero();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    v[i] = s[pad(k0 + i)];
    run = dd_add(run, v[i]);
  }
  const dd incl = warp_inclusive(run, lane);
  dd excl = shfl_up(incl, 1);
  if (lane == 0) excl = dd_zero();
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    dd w = lane < kWarps ? warp_tot[lane] : dd_zero();
    w = warp_inclusive(w, lane);
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  // the tile-local prefix before this thread's first item
  dd acc = warp > 0 ? dd_add(warp_tot[warp - 1], excl) : excl;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (exclusive) {
      s[pad(k0 + i)] = dd_add(offset, acc);
      acc = dd_add(acc, v[i]);
    } else {
      acc = dd_add(acc, v[i]);
      s[pad(k0 + i)] = dd_add(offset, acc);
    }
  }
  const dd total = warp_tot[kWarps - 1];
  __syncthreads();
  return total;
}

__global__ void scan2_partials(const float* __restrict__ x, long long n,
                               dd* __restrict__ totals) {
  __shared__ dd warp_tot[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  dd acc = dd_zero();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = base + i * kThreads + threadIdx.x;
    if (j < n) acc = dd_add(acc, dd{x[j], 0.0f});
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc = dd_add(acc, shfl_down(acc, o));
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    dd w = threadIdx.x < kWarps ? warp_tot[threadIdx.x] : dd_zero();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w = dd_add(w, shfl_down(w, o));
    if (threadIdx.x == 0) totals[blockIdx.x] = w;
  }
}

__global__ void scan2_carry(dd* totals, long long tiles) {
  __shared__ dd s[kTile + kTile / 32];
  __shared__ dd warp_tot[kWarps];
  dd carry = dd_zero();
  for (long long base = 0; base < tiles; base += kTile) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + threadIdx.x;
      const long long j = base + k;
      s[pad(k)] = j < tiles ? totals[j] : dd_zero();
    }
    __syncthreads();
    const dd tot = scan_smem(s, carry, true, warp_tot);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + threadIdx.x;
      const long long j = base + k;
      if (j < tiles) totals[j] = s[pad(k)];
    }
    __syncthreads();
    carry = dd_add(carry, tot);
  }
}

__global__ void scan2_tiles(const float* __restrict__ x,
                            float* __restrict__ hi, float* __restrict__ lo,
                            long long n, const dd* __restrict__ excl) {
  __shared__ dd s[kTile + kTile / 32];
  __shared__ dd warp_tot[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    const long long j = base + k;
    s[pad(k)] = dd{j < n ? x[j] : 0.0f, 0.0f};
  }
  __syncthreads();
  scan_smem(s, excl[blockIdx.x], false, warp_tot);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + threadIdx.x;
    const long long j = base + k;
    if (j < n) {
      const dd r = s[pad(k)];
      hi[j] = r.hi;
      lo[j] = r.lo;
    }
  }
}

}  // namespace

// scratch holds ceil(n / kTile) (hi, lo) pairs = 2 * ceil(n / 4096) floats
// (hopper_kernels._SCAN_TILE mirrors kTile)
extern "C" int dryad_prefix_sum2_f32(const void* x, void* hi, void* lo,
                                     long long n, void* scratch,
                                     void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kTile - 1) / kTile;
  const float* xi = static_cast<const float*>(x);
  dd* tot = static_cast<dd*>(scratch);
  scan2_partials<<<(unsigned)tiles, kThreads, 0, s>>>(xi, n, tot);
  scan2_carry<<<1, kThreads, 0, s>>>(tot, tiles);
  scan2_tiles<<<(unsigned)tiles, kThreads, 0, s>>>(
      xi, static_cast<float*>(hi), static_cast<float*>(lo), n, tot);
  return (int)cudaGetLastError();
}
