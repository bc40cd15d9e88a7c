// prefix_sum — inclusive 1-D scan (modular for 32-bit integers).
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_kernels.py:270 prefix_sum
// (pallas_call at :286, body _scan_kernel_body at :177).
//
// Bound on Hopper: bytes.  The scan must read n values and write n values
// (8n bytes for 32-bit types); one add per element is nothing to the card.
//
// Design: the TPU kernel streams tiles through ONE core in grid order and
// carries the running total in SMEM from one grid step to the next.
// Hopper's blocks run in parallel and in no order, so nothing carries
// between them.  This is reduce-then-scan in three launches:
//   1. tile_totals: each block sums one tile of kTile elements;
//   2. scan_totals: one block turns the tile totals into their exclusive
//      prefix, walking them tile by tile with a register carry;
//   3. tile_scan_offset: each block scans its tile again and adds the
//      exclusive prefix of the tiles before it.
// Inside a tile, values pass through shared memory so that the loads and
// stores are coalesced; each thread scans kItems contiguous values, warps
// scan thread totals with shuffles, and warp 0 scans the warp totals.
// 32-bit integers (int32 and uint32 alike) run as unsigned int: modular
// addition is the same for both and unsigned overflow is defined, so the
// result is bit-exact.  float32 adds in another order than a sequential
// cumsum; the caller states the tolerance.  Reading every element twice
// (passes 1 and 3) costs 12n bytes instead of 8n; decoupled look-back
// would bring it to 8n in one launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;

// shared-memory index with one pad word per 32 so that a thread reading
// kItems contiguous values does not hit the same bank as its neighbours
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

template <typename T>
__device__ T warp_inclusive(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Scan the tile in[base, base + kTile) (elements >= n read as 0) into
// out, each result plus `offset`; exclusive or inclusive.  Returns the
// tile total (the same value in every thread).  Safe in place.
template <typename T>
__device__ T scan_tile(const T* in, T* out, long long base, long long n,
                       T offset, bool exclusive, T* s, T* warp_tot) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + tid;
    const long long j = base + k;
    s[pad(k)] = j < n ? in[j] : T(0);
  }
  __syncthreads();
  const int k0 = tid * kItems;
  T v[kItems];
  T run = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    v[i] = s[pad(k0 + i)];
    run += v[i];
  }
  const T incl = warp_inclusive(run, lane);
  T excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_tot[lane] : T(0);
    w = warp_inclusive(w, lane);
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  T acc = offset + (warp > 0 ? warp_tot[warp - 1] : T(0)) + excl;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (exclusive) {
      s[pad(k0 + i)] = acc;
      acc += v[i];
    } else {
      acc += v[i];
      s[pad(k0 + i)] = acc;
    }
  }
  const T total = warp_tot[kWarps - 1];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = i * kThreads + tid;
    const long long j = base + k;
    if (j < n) out[j] = s[pad(k)];
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void tile_totals(const T* __restrict__ x, long long n,
                            T* __restrict__ totals) {
  __shared__ T warp_tot[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long j = base + i * kThreads + threadIdx.x;
    if (j < n) acc += x[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    T w = threadIdx.x < kWarps ? warp_tot[threadIdx.x] : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(kFull, w, o);
    if (threadIdx.x == 0) totals[blockIdx.x] = w;
  }
}

template <typename T>
__global__ void scan_totals(T* totals, long long tiles) {
  __shared__ T s[kTile + kTile / 32];
  __shared__ T warp_tot[kWarps];
  T carry = T(0);
  for (long long base = 0; base < tiles; base += kTile) {
    carry += scan_tile(totals, totals, base, tiles, carry, true, s,
                       warp_tot);
  }
}

template <typename T>
__global__ void tile_scan_offset(const T* __restrict__ x, T* __restrict__ y,
                                 long long n, const T* __restrict__ excl) {
  __shared__ T s[kTile + kTile / 32];
  __shared__ T warp_tot[kWarps];
  scan_tile(x, y, (long long)blockIdx.x * kTile, n, excl[blockIdx.x], false,
            s, warp_tot);
}

template <typename T>
int launch(const void* x, void* y, long long n, void* scratch,
           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kTile - 1) / kTile;
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  T* tot = static_cast<T*>(scratch);
  tile_totals<T><<<(unsigned)tiles, kThreads, 0, s>>>(xi, n, tot);
  scan_totals<T><<<1, kThreads, 0, s>>>(tot, tiles);
  tile_scan_offset<T><<<(unsigned)tiles, kThreads, 0, s>>>(xi, yo, n, tot);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch holds ceil(n / kTile) = ceil(n / 4096) values of the element type
// (hopper_kernels._SCAN_TILE mirrors kTile)
extern "C" int dryad_prefix_sum_u32(const void* x, void* y, long long n,
                                    void* scratch, void* stream) {
  return launch<unsigned int>(x, y, n, scratch, stream);
}

extern "C" int dryad_prefix_sum_f32(const void* x, void* y, long long n,
                                    void* scratch, void* stream) {
  return launch<float>(x, y, n, scratch, stream);
}
