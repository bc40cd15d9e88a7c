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
// Hopper's blocks run in parallel and in no order, so the carry becomes a
// single-pass scan with decoupled look-back (scan_lookback.cuh): ONE
// kernel launch per call, `scan_lookback`, and nothing else (no memset:
// the kernel leaves its scratch cleared for the next launch on the
// stream).  It reads each element once and writes it once — the 8n bytes
// of the bound.  A single tile (n <= kTile: the exchange's D = 8 offsets)
// skips the look-back and touches no scratch.
//
// Status word of a tile: the flag in the high half and the aggregate's 32
// bits in the low half, published with one 64-bit store, so a reader that
// sees the flag sees the value.  32-bit integers (int32 and uint32 alike)
// run as unsigned int: modular addition is the same for both and unsigned
// overflow is defined, so the result is bit-exact.  float32 adds in
// another order than a sequential cumsum (the caller states the
// tolerance), but in the SAME order on every run: each tile's offset
// folds its predecessors' aggregates in a fixed order (see the header), so
// the result is deterministic to the bit.  The look-back reads tiles^2/2
// status words from L2: 0.37 MB at 306 tiles (1.25M values), ~95 MB at
// 4,883 tiles (20M).

#include <cuda_runtime.h>

#include "scan_lookback.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
// kItems = 8: 4,096-value tiles give 306 blocks at the main path's 1.25M
// values, two or three to an SM; 16 would halve the blocks (and quarter
// the look-back's reads, which are small at these sizes) but leave some
// SMs with twice the bytes of others.
// scratch, in 64-bit words: lookback::kHeadWords, then one status word a
// tile (hopper_kernels._SCAN_TILE mirrors kTile, _SCAN_SCRATCH_WORDS the
// words a tile)
constexpr int kScratchWordsPerTile = 1;

__device__ __forceinline__ unsigned bits(unsigned v) { return v; }
__device__ __forceinline__ unsigned bits(float v) {
  return __float_as_uint(v);
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned w);
template <>
__device__ __forceinline__ unsigned from_bits<unsigned>(unsigned w) {
  return w;
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned w) {
  return __uint_as_float(w);
}

template <typename T>
struct Sum {
  using V = T;
  static constexpr int kLanes = 1;
  static constexpr int kWords = kScratchWordsPerTile;
  __device__ static V zero() { return T(0); }
  __device__ static V lift(unsigned w) { return from_bits<T>(w); }
  __device__ static unsigned lane(V v, int) { return bits(v); }
  __device__ static V add(V a, V b) { return a + b; }
  __device__ static V shfl_up(V v, int o) {
    return __shfl_up_sync(lookback::kFull, v, o);
  }
  __device__ static V shfl_down(V v, int o) {
    return __shfl_down_sync(lookback::kFull, v, o);
  }
  __device__ static void publish(unsigned long long* status, long long t,
                                 V agg) {
    lookback::st_relaxed(status + t, (1ull << 32) | bits(agg));
  }
  __device__ static V read(const unsigned long long* status, long long j) {
    unsigned spins = 0;
    unsigned long long w;
    while (((w = lookback::ld_relaxed(status + j)) >> 32) == 0)
      lookback::backoff(spins);
    return from_bits<T>((unsigned)w);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_lookback(const unsigned* __restrict__ x, unsigned* __restrict__ y,
                  long long n, unsigned long long* scratch) {
  lookback::scan<Sum<T>, kThreads, kItems>(x, y, nullptr, n, scratch);
}

template <typename T>
int launch(const void* x, void* y, long long n, void* scratch,
           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kTile - 1) / kTile;
  scan_lookback<T><<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(y), n,
      static_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: lookback::kHeadWords + kScratchWordsPerTile * ceil(n / kTile)
// 64-bit words, all zero (and left so), kept by the caller for the stream;
// null when n <= kTile
extern "C" int dryad_prefix_sum_u32(const void* x, void* y, long long n,
                                    void* scratch, void* stream) {
  return launch<unsigned int>(x, y, n, scratch, stream);
}

extern "C" int dryad_prefix_sum_f32(const void* x, void* y, long long n,
                                    void* scratch, void* stream) {
  return launch<float>(x, y, n, scratch, stream);
}
