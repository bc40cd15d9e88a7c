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
// Design: the TPU kernel carries a (hi, lo) pair in SMEM across a
// sequential grid.  Here it is prefix_sum.cu's single-pass scan with
// decoupled look-back (scan_lookback.cuh) on a `dd {hi, lo}` pair, every
// `+` the TwoSum combine and every shuffle two floats: ONE kernel launch
// per call, `scan2_lookback` (named apart from prefix_sum.cu's so that a
// profile tells the two kernels apart), and nothing else (no memset: the
// kernel leaves its flags cleared for the next launch on the stream).  It
// reads each input once and writes both lanes once — the 12n bytes of the
// bound.  A single tile skips the look-back and touches no scratch.
//
// A tile's aggregate goes to its own value word, and its flag word is
// written after it with a release store (st.release.gpu); a reader
// acquires the flag (ld.acquire.gpu) before it reads the value.  (A
// 128-bit store of hi, lo and the flag together is not ordered by the
// PTX memory model.)  Each tile's offset folds its predecessors'
// aggregates in a fixed order, never an inclusive prefix, so the result
// is deterministic to the bit (see the header); the look-back reads
// tiles^2/2 flag and value pairs from L2: 0.75 MB at 306 tiles, ~190 MB
// at 4,883 tiles (20M values), which is a test shape.
//
// Accuracy: inside a tile, each thread scans its kItems values, the warps
// scan the thread totals, warp 0 scans the warp totals — all from zero, so
// the tile-local prefix stays at the tile's own magnitude.  The large
// exclusive offset of the tiles before is added to each element ONCE,
// last: a prefix of size P then takes one rounding at P's scale (plus the
// offset's own, shared by the whole tile), which is what keeps the
// difference of two nearby prefixes near ulp of the difference.
//
// Every addition is __fadd_rn / __fsub_rn: round-to-nearest, never
// contracted into an FMA, never flushed to zero, in the order written —
// TwoSum is exact only under those rules.  The combine is not associative
// in the last bits, so this kernel, its plain version (a log-step scan)
// and the JAX function agree within an error bound, not bit for bit.

#include <cuda_runtime.h>

#include "scan_lookback.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
// kItems = 8: 4,096-value tiles give only 62 blocks for 132 SMs at the
// main path's 250,000 values; 16 would halve them again and lengthen each
// block's critical path.
// scratch, in 64-bit words: lookback::kHeadWords, then for each tile its
// flag word and its (hi, lo) value word, side by side — so that a later
// call's flags never fall on an earlier call's values
// (hopper_kernels._SCAN_TILE mirrors kTile, _SCAN_SCRATCH_WORDS the words
// a tile)
constexpr int kScratchWordsPerTile = 2;

struct dd {
  float hi, lo;
};

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

struct DD {
  using V = dd;
  static constexpr int kLanes = 2;
  static constexpr int kWords = kScratchWordsPerTile;
  __device__ static V zero() { return {0.0f, 0.0f}; }
  __device__ static V lift(unsigned w) { return {__uint_as_float(w), 0.0f}; }
  __device__ static unsigned lane(V v, int l) {
    return __float_as_uint(l == 0 ? v.hi : v.lo);
  }
  __device__ static V add(V a, V b) { return dd_add(a, b); }
  __device__ static V shfl_up(V v, int o) {
    return {__shfl_up_sync(lookback::kFull, v.hi, o),
            __shfl_up_sync(lookback::kFull, v.lo, o)};
  }
  __device__ static V shfl_down(V v, int o) {
    return {__shfl_down_sync(lookback::kFull, v.hi, o),
            __shfl_down_sync(lookback::kFull, v.lo, o)};
  }
  // tile t's flag at status[2t], its value at status[2t + 1]
  __device__ static void publish(unsigned long long* status, long long t,
                                 V agg) {
    *reinterpret_cast<float2*>(status + kWords * t + 1) =
        make_float2(agg.hi, agg.lo);
    lookback::st_release(status + kWords * t, 1ull);
  }
  __device__ static V read(const unsigned long long* status, long long j) {
    unsigned spins = 0;
    while (lookback::ld_acquire(status + kWords * j) == 0)
      lookback::backoff(spins);
    const float2 v =
        __ldcg(reinterpret_cast<const float2*>(status + kWords * j + 1));
    return {v.x, v.y};
  }
};

__global__ void __launch_bounds__(kThreads)
    scan2_lookback(const unsigned* __restrict__ x, unsigned* __restrict__ hi,
                   unsigned* __restrict__ lo, long long n,
                   unsigned long long* scratch) {
  lookback::scan<DD, kThreads, kItems>(x, hi, lo, n, scratch);
}

}  // namespace

// scratch: lookback::kHeadWords + kScratchWordsPerTile * ceil(n / kTile)
// 64-bit words, all zero but for value words (and left so: value words
// are written before they are read), kept by the caller for the stream;
// null when n <= kTile
extern "C" int dryad_prefix_sum2_f32(const void* x, void* hi, void* lo,
                                     long long n, void* scratch,
                                     void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kTile - 1) / kTile;
  scan2_lookback<<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(hi),
      static_cast<unsigned*>(lo), n,
      static_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}
