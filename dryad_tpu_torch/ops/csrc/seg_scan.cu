// seg_scan — the segmented inclusive scans of one _seg_scan_multi call
// (ops/kernels.py, the group op's scan lowering): every (value, op) leaf of
// the call in one pass of three launches (one pass per 16 lanes).
//
// New in the port: it replaces no TPU kernel.  The JAX package lowers the
// same scan to lax.associative_scan (dryad_tpu/ops/kernels.py), which XLA
// fuses; there is no pallas_call counterpart.  It replaces the port's plain
// version, hopper_kernels.seg_scan_multi_plain: a Hillis-Steele scan in
// PyTorch ops (ops/scan.py) of ceil(log2 n) passes, each a where, an op and
// a cat over every leaf and the whole capacity — about 360 bytes a row a
// pass for TPC-H Q1's seven leaves, 25 passes at 22.5M rows.
//
// The result is the plain version's over all n rows, padding included:
// output i of a lane is the op-fold of its values from the last row at or
// before i whose start flag is set (from row 0 where there is none) up to
// i.  Lanes are int32, int64, float32 or float64 (the wrapper widens
// narrower integers, bool and 16-bit floats).  Integer adds wrap modulo
// 2^32 or 2^64 (they are done in unsigned registers); integer min and max
// compare signed.  Float min and max propagate NaN as torch.minimum /
// torch.maximum do (a NaN operand gives a NaN, its bits whichever NaN came
// first; the caller canonicalises NaN bits); of two equal operands min
// gives the OR of their bits and max the AND, so a fold over +0.0 and -0.0
// gives -0.0 for min and +0.0 for max whatever the order.  Float sums are
// added in this kernel's fixed order (a thread's rows in turn, a warp's
// threads in a shuffle tree, the warps and the tiles in turn), which
// differs from the plain version's, so they agree within the rounding of
// a sum, and each output is a fixed function of the inputs: the same bits
// from every launch.
//
// Bound on Hopper: bytes.  Q1's call (22.5M rows; the flags, the int32
// count leaf, five int64 leaves) reads 45 bytes a row and writes 44:
// 2.00 GB, 0.60 ms at 3.35 TB/s.  This design reads the inputs twice:
// 3.02 GB, 0.90 ms.  The operations (a combine and a select a lane a row, a shuffle
// tree a lane per 8 rows) are far below the 67 TOP/s line.
//
// Design: reduce, then scan the tile carries, then rescan.
//   1. seg_tile_reduce, one block per tile of kTile = 2048 rows but the
//      last: each thread reads its kRows = 8 consecutive rows (16-byte
//      vector loads where a lane is contiguous and aligned) and folds them
//      in registers; a warp combines its threads' folds in a segmented
//      shuffle tree (the start flags travel as one ballot), the block its
//      warps' totals in shared memory.  The block writes the tile's total
//      of each lane and whether the tile holds a start.
//   2. seg_tile_carry, one block a lane: 1024 threads each fold a run of
//      consecutive tile totals, scan the folds as in 1, and write each
//      tile's carry-in (the fold of every earlier tile) over the total of
//      the tile before it.
//   3. seg_tile_apply, one block per tile: each thread reads and folds its
//      rows again, takes its exclusive prefix from the tile's carry-in, the
//      earlier warps' totals and the earlier threads of its warp, applies
//      it to its rows up to its first start and writes them.
// Nothing is read on the host and nothing is atomic, so the outputs are
// deterministic.  The lanes come as descriptors in the kernels' parameters (a
// __grid_constant__ struct): pointers, byte strides, kind and op, so a
// column of an [n, k] leaf is read where it lies.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                  // consecutive rows a thread owns
constexpr int kTile = kThreads * kRows;   // rows a block
constexpr int kMaxLanes = 16;             // lanes a launch takes
constexpr int kCarryThreads = 1024;
constexpr int kCarryWarps = kCarryThreads / 32;
constexpr unsigned kAll = 0xFFFFFFFFu;

// lane kinds (ops/hopper_kernels.py _SEG_KIND)
constexpr int kI32 = 0;
constexpr int kI64 = 1;
constexpr int kF32 = 2;
constexpr int kF64 = 3;
// ops (ops/hopper_kernels.py _SEG_OPS)
constexpr int kAdd = 0;
constexpr int kMin = 1;
constexpr int kMax = 2;

struct Lane {
  const unsigned char* in;   // row 0's value
  unsigned char* out;        // row 0's output
  long long in_stride;       // bytes from a row to the next
  long long out_stride;
  int kind;
  int op;
  int vec;                   // in and out contiguous and 16-byte aligned
};

struct Params {
  Lane lanes[kMaxLanes];
  const unsigned char* flags;   // the start flags, bool [n]
  unsigned long long* agg;      // [nlanes][tiles] totals, then carries
  int* agg_start;               // [tiles] the tile holds a start
  long long n;
  long long tiles;
  int nlanes;
  int flags_vec;                // flags 8-byte aligned
};

// a value's bits in a 64-bit word (shared memory, the tile scratch)
__device__ __forceinline__ unsigned long long to_bits(unsigned x) { return x; }
__device__ __forceinline__ unsigned long long to_bits(int x) {
  return (unsigned)x;
}
__device__ __forceinline__ unsigned long long to_bits(unsigned long long x) {
  return x;
}
__device__ __forceinline__ unsigned long long to_bits(long long x) {
  return (unsigned long long)x;
}
__device__ __forceinline__ unsigned long long to_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long to_bits(double x) {
  return (unsigned long long)__double_as_longlong(x);
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b);
template <>
__device__ __forceinline__ unsigned from_bits<unsigned>(unsigned long long b) {
  return (unsigned)b;
}
template <>
__device__ __forceinline__ int from_bits<int>(unsigned long long b) {
  return (int)(unsigned)b;
}
template <>
__device__ __forceinline__ unsigned long long from_bits<unsigned long long>(
    unsigned long long b) {
  return b;
}
template <>
__device__ __forceinline__ long long from_bits<long long>(
    unsigned long long b) {
  return (long long)b;
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned long long b) {
  return __uint_as_float((unsigned)b);
}
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double((long long)b);
}

template <typename T, int OP>
struct Op {
  __device__ static __forceinline__ T f(T a, T b) {
    if (OP == kAdd) return a + b;
    if (OP == kMin) return b < a ? b : a;
    return a < b ? b : a;
  }
};

// float and double: NaN first, then equal operands by their bits
template <typename F, int OP>
__device__ __forceinline__ F float_op(F a, F b) {
  if (OP == kAdd) return a + b;
  if (a != a) return a;
  if (b != b) return b;
  if (a == b) {
    const unsigned long long x = to_bits(a), y = to_bits(b);
    return from_bits<F>(OP == kMin ? (x | y) : (x & y));
  }
  if (OP == kMin) return b < a ? b : a;
  return a < b ? b : a;
}

template <int OP>
struct Op<float, OP> {
  __device__ static __forceinline__ float f(float a, float b) {
    return float_op<float, OP>(a, b);
  }
};

template <int OP>
struct Op<double, OP> {
  __device__ static __forceinline__ double f(double a, double b) {
    return float_op<double, OP>(a, b);
  }
};

template <typename T>
union Rows {
  T v[kRows];
  int4 q[kRows * sizeof(T) / 16];
};

// the thread's rows of one lane (rows at or past n read as 0)
template <typename T>
__device__ __forceinline__ void load_rows(const Lane& L, long long row0,
                                          int nrows, Rows<T>& r) {
  const unsigned char* p = L.in + row0 * L.in_stride;
  if (L.vec && nrows == kRows) {
    const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int i = 0; i < kRows * (int)sizeof(T) / 16; ++i) r.q[i] = __ldg(q + i);
    return;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    r.v[i] = i < nrows ? __ldg(reinterpret_cast<const T*>(p + i * L.in_stride))
                       : T(0);
}

template <typename T>
__device__ __forceinline__ void store_rows(const Lane& L, long long row0,
                                           int nrows, const Rows<T>& r) {
  unsigned char* p = L.out + row0 * L.out_stride;
  if (L.vec && nrows == kRows) {
    int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
    for (int i = 0; i < kRows * (int)sizeof(T) / 16; ++i) q[i] = r.q[i];
    return;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i < nrows) *reinterpret_cast<T*>(p + i * L.out_stride) = r.v[i];
}

// bit i: row0 + i starts a segment; rows at or past n count as starts
__device__ __forceinline__ unsigned start_bits(const Params& p,
                                               long long row0, int nrows) {
  unsigned bits = 0u;
  if (p.flags_vec && nrows == kRows) {
    const unsigned long long w =
        __ldg(reinterpret_cast<const unsigned long long*>(p.flags + row0));
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      bits |= ((w >> (8 * i)) & 0xFFull) ? (1u << i) : 0u;
    return bits;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i >= nrows || __ldg(p.flags + row0 + i)) bits |= 1u << i;
  return bits;
}

// the warp's inclusive segmented scan of one value a thread; ``starts``
// the ballot of the threads whose value begins at a start
template <typename T, int OP>
__device__ __forceinline__ T warp_scan(T x, unsigned starts, int lane) {
  const unsigned upto = starts & (kAll >> (31 - lane));
  const int s = upto ? 31 - __clz((int)upto) : -1;   // last start <= lane
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kAll, x, d);
    if (lane >= d && lane - d >= s) x = Op<T, OP>::f(y, x);
  }
  return x;
}

// one lane of a tile: with APPLY false the tile's total to agg, with APPLY
// true the rows' outputs
template <typename T, int OP, bool APPLY>
__device__ __forceinline__ void tile_lane(
    const Params& p, int li, long long tile, long long row0, int nrows,
    unsigned bits, unsigned wstarts,
    unsigned long long (*sh_total)[kWarps], const int* sh_any) {
  using O = Op<T, OP>;
  const Lane& L = p.lanes[li];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Rows<T> r;
  load_rows<T>(L, row0, nrows, r);
#pragma unroll
  for (int i = 1; i < kRows; ++i)
    if (!((bits >> i) & 1u)) r.v[i] = O::f(r.v[i - 1], r.v[i]);
  const T x = warp_scan<T, OP>(r.v[kRows - 1], wstarts, lane);
  if (lane == 31) sh_total[li][warp] = to_bits(x);
  __syncthreads();
  if (!APPLY) {
    if (threadIdx.x == 0) {
      T acc = from_bits<T>(sh_total[li][0]);
      for (int w = 1; w < kWarps; ++w) {
        const T b = from_bits<T>(sh_total[li][w]);
        acc = sh_any[w] ? b : O::f(acc, b);
      }
      p.agg[li * p.tiles + tile] = to_bits(acc);
    }
    return;
  }
  // the thread's exclusive prefix: the tile's carry-in (kept over the
  // total of the tile before), the earlier warps, the earlier threads
  bool has = tile > 0;
  T acc = has ? from_bits<T>(p.agg[li * p.tiles + tile - 1]) : T(0);
  for (int w = 0; w < warp; ++w) {
    const T b = from_bits<T>(sh_total[li][w]);
    acc = (has && !sh_any[w]) ? O::f(acc, b) : b;
    has = true;
  }
  const T xe = __shfl_up_sync(kAll, x, 1);
  if (lane > 0) {
    const bool before = (wstarts & ((1u << lane) - 1u)) != 0u;
    acc = (has && !before) ? O::f(acc, xe) : xe;
    has = true;
  }
  if (has) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (!(bits & ((2u << i) - 1u))) r.v[i] = O::f(acc, r.v[i]);
  }
  store_rows<T>(L, row0, nrows, r);
}

template <bool APPLY>
__device__ __forceinline__ void tile_lanes(const Params& p, long long tile) {
  __shared__ unsigned long long sh_total[kMaxLanes][kWarps];
  __shared__ int sh_any[kWarps];
  const long long row0 = tile * kTile + (long long)threadIdx.x * kRows;
  const long long left = p.n - row0;
  const int nrows = left <= 0 ? 0 : (left < kRows ? (int)left : kRows);
  const unsigned bits = start_bits(p, row0, nrows);
  const unsigned wstarts = __ballot_sync(kAll, bits != 0u);
  if ((threadIdx.x & 31) == 0) sh_any[threadIdx.x >> 5] = wstarts != 0u;
  for (int li = 0; li < p.nlanes; ++li) {
    const Lane& L = p.lanes[li];
    switch (L.kind * 3 + L.op) {
#define DRYAD_SEG_LANE(KIND, OPC, T)                                       \
  case KIND * 3 + OPC:                                                      \
    tile_lane<T, OPC, APPLY>(p, li, tile, row0, nrows, bits, wstarts,       \
                             sh_total, sh_any);                             \
    break;
      DRYAD_SEG_LANE(kI32, kAdd, unsigned)
      DRYAD_SEG_LANE(kI32, kMin, int)
      DRYAD_SEG_LANE(kI32, kMax, int)
      DRYAD_SEG_LANE(kI64, kAdd, unsigned long long)
      DRYAD_SEG_LANE(kI64, kMin, long long)
      DRYAD_SEG_LANE(kI64, kMax, long long)
      DRYAD_SEG_LANE(kF32, kAdd, float)
      DRYAD_SEG_LANE(kF32, kMin, float)
      DRYAD_SEG_LANE(kF32, kMax, float)
      DRYAD_SEG_LANE(kF64, kAdd, double)
      DRYAD_SEG_LANE(kF64, kMin, double)
      DRYAD_SEG_LANE(kF64, kMax, double)
#undef DRYAD_SEG_LANE
      default: break;
    }
  }
  if (!APPLY && threadIdx.x == 0) {
    int any = 0;
    for (int w = 0; w < kWarps; ++w) any |= sh_any[w];
    p.agg_start[tile] = any;
  }
}

__global__ void __launch_bounds__(kThreads)
    seg_tile_reduce(const __grid_constant__ Params p) {
  tile_lanes<false>(p, blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
    seg_tile_apply(const __grid_constant__ Params p) {
  tile_lanes<true>(p, blockIdx.x);
}

// one lane's carries: tile t's carry-in (the fold of the totals of tiles
// 0 .. t-1) replaces the total of tile t - 1
template <typename T, int OP>
__device__ __forceinline__ void carry_lane(
    const Params& p, int li, unsigned long long* sh_total, int* sh_any) {
  using O = Op<T, OP>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = p.tiles - 1;   // totals that feed a carry
  const long long per = (m + kCarryThreads - 1) / kCarryThreads;
  const long long a = threadIdx.x * per;
  const long long b = a + per < m ? a + per : m;
  unsigned long long* slot = p.agg + li * p.tiles;
  bool has = false, any = false;
  T v = T(0);
  for (long long j = a; j < b; ++j) {
    const T t = from_bits<T>(slot[j]);
    const bool s = p.agg_start[j] != 0;
    v = (!has || s) ? t : O::f(v, t);
    has = true;
    any |= s;
  }
  // threads past the last total come last and feed no carry
  const unsigned wstarts = __ballot_sync(kAll, any);
  const T x = warp_scan<T, OP>(v, wstarts, lane);
  if (lane == 31) {
    sh_total[warp] = to_bits(x);
    sh_any[warp] = wstarts != 0u;
  }
  __syncthreads();
  bool h = false;
  T acc = T(0);
  for (int w = 0; w < warp; ++w) {
    const T t = from_bits<T>(sh_total[w]);
    acc = (h && !sh_any[w]) ? O::f(acc, t) : t;
    h = true;
  }
  const T xe = __shfl_up_sync(kAll, x, 1);
  if (lane > 0) {
    const bool before = (wstarts & ((1u << lane) - 1u)) != 0u;
    acc = (h && !before) ? O::f(acc, xe) : xe;
    h = true;
  }
  for (long long j = a; j < b; ++j) {
    const T t = from_bits<T>(slot[j]);
    acc = (!h || p.agg_start[j] != 0) ? t : O::f(acc, t);
    h = true;
    slot[j] = to_bits(acc);
  }
}

__global__ void __launch_bounds__(kCarryThreads)
    seg_tile_carry(const __grid_constant__ Params p) {
  __shared__ unsigned long long sh_total[kCarryWarps];
  __shared__ int sh_any[kCarryWarps];
  const int li = blockIdx.x;
  const Lane& L = p.lanes[li];
  switch (L.kind * 3 + L.op) {
#define DRYAD_SEG_CARRY(KIND, OPC, T)                 \
  case KIND * 3 + OPC:                                 \
    carry_lane<T, OPC>(p, li, sh_total, sh_any);       \
    break;
    DRYAD_SEG_CARRY(kI32, kAdd, unsigned)
    DRYAD_SEG_CARRY(kI32, kMin, int)
    DRYAD_SEG_CARRY(kI32, kMax, int)
    DRYAD_SEG_CARRY(kI64, kAdd, unsigned long long)
    DRYAD_SEG_CARRY(kI64, kMin, long long)
    DRYAD_SEG_CARRY(kI64, kMax, long long)
    DRYAD_SEG_CARRY(kF32, kAdd, float)
    DRYAD_SEG_CARRY(kF32, kMin, float)
    DRYAD_SEG_CARRY(kF32, kMax, float)
    DRYAD_SEG_CARRY(kF64, kAdd, double)
    DRYAD_SEG_CARRY(kF64, kMin, double)
    DRYAD_SEG_CARRY(kF64, kMax, double)
#undef DRYAD_SEG_CARRY
    default: break;
  }
}

}  // namespace

// desc: nlanes rows of 7 int64s — input pointer, output pointer, input
// and output row strides (bytes), kind, op, vec.  flags: bool [n].  agg:
// nlanes * ceil(n / kTile) uint64 and agg_start ceil(n / kTile) int32 of
// scratch, written before they are read.  Launches nothing for n = 0.
extern "C" int dryad_seg_scan(const long long* desc, int nlanes, long long n,
                              const void* flags, void* agg,
                              void* agg_start, void* stream) {
  if (nlanes < 1 || nlanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    Params p;
    for (int i = 0; i < nlanes; ++i) {
      const long long* d = desc + 7 * i;
      p.lanes[i].in = reinterpret_cast<const unsigned char*>(d[0]);
      p.lanes[i].out = reinterpret_cast<unsigned char*>(d[1]);
      p.lanes[i].in_stride = d[2];
      p.lanes[i].out_stride = d[3];
      p.lanes[i].kind = (int)d[4];
      p.lanes[i].op = (int)d[5];
      p.lanes[i].vec = (int)d[6];
    }
    for (int i = nlanes; i < kMaxLanes; ++i) p.lanes[i] = Lane{};
    p.flags = static_cast<const unsigned char*>(flags);
    p.agg = static_cast<unsigned long long*>(agg);
    p.agg_start = static_cast<int*>(agg_start);
    p.n = n;
    p.tiles = (n + kTile - 1) / kTile;
    p.nlanes = nlanes;
    p.flags_vec = (reinterpret_cast<unsigned long long>(flags) & 7ull) == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p.tiles > 1) {
      seg_tile_reduce<<<(unsigned)(p.tiles - 1), kThreads, 0, s>>>(p);
      seg_tile_carry<<<(unsigned)nlanes, kCarryThreads, 0, s>>>(p);
    }
    seg_tile_apply<<<(unsigned)p.tiles, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
