// hash_keys — the 64-bit key hash of one hash_batch_keys call: every key
// column of the call, every row, in one launch (one per 32 key columns).
//
// New in the port: it replaces no TPU kernel.  The JAX package hashes its
// keys through XLA-fused elementwise ops (dryad_tpu/ops/hashing.py), so
// there is no pallas_call counterpart.  It replaces the port's plain
// version, ops/hashing.py hash_columns, which carries each 32-bit lane as
// an int64 tensor: about 96 elementwise PyTorch kernels for one int32 key
// column and 54 more for each further column, each a full pass over the
// rows that reads and writes 8-byte lanes.  The output is that version's
// bit for bit: hi and lo as int64 in [0, 2**32), for every row of the
// capacity, the invalid ones included.
//
// Bound on Hopper: bytes.  A row reads each key column's words once (12
// bytes for three int32 keys) and writes the two int64 lanes (16 bytes):
// 28 bytes a row, 5 GB over 180M rows, 1.5 ms at 3.35 TB/s.  In source
// operations each 32-bit word costs two murmur3-shaped mixes and one
// combine, 44, and each further column one more combine, 28: three int32
// keys are 188 a row, 0.5 ms over 180M rows at the 67 TOP/s the port's
// other kernel bounds take (chip_smoke.py hash_work counts the same).
//
// Design: each thread takes kRows rows kThreads apart (so a warp's loads
// and stores of one row index are contiguous), reads each key column's
// words once and computes the whole chain in uint32 registers — the two
// per-word mixes, the fold into the column's running (hi, lo), and the
// combine between columns — then stores the two lanes.  A grid-stride
// loop over at most one wave of blocks covers any row count.  In uint32
// the plain version's 16-bit-split multiply is one wrapping multiply and
// its masked right shift a plain one.  The columns come as descriptors in
// the kernel's parameters (a __grid_constant__ struct, read in place from
// the constant bank: no copy to local memory, no device buffer, no copy
// from the host per call): a pointer, a kind, a width and byte strides,
// so views of any row stride are read as they lie.  A launch takes up to
// kMaxCols columns; a call with more launches once per kMaxCols columns,
// each launch after the first seeded with the lanes the one before wrote
// and combining its columns into them, as the plain version's chain does.
//
// Word layout by kind, as the plain version builds it:
//   * 32-bit and narrower integers: the value sign- or zero-extended to 32
//     bits; a bool is 0 or 1;
//   * int64 and uint64: the high then the low half of a 1-D column; of a
//     2-D [n, k] column all k high halves first, then all k low halves;
//   * floating point: zero and the subnormals of the column's own dtype
//     (an exponent field of 0) become +0.0, then the value rounds to
//     float32 (to nearest even, subnormal results kept) and its bits are
//     taken.  A NaN keeps its sign and the top bits of its payload, with
//     the quiet bit set, as the host's conversion leaves it.  Built
//     without --use_fast_math, so nothing is flushed to zero;
//   * strings: the sums over j < min(length, max_len) of (byte + 1) * w[j]
//     for the two weight vectors, in wrapping uint32 (the plain version's
//     int64 sum masked to 32 bits is the same value), each mixed, combined
//     with the mixed length.  The weights (2 x kMaxHashLen words) are a
//     device buffer the wrapper keeps per device; every thread of a warp
//     reads the same weight at a time, so they are served from L1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;             // rows a thread per pass, loads in flight
constexpr int kMaxCols = 32;         // key columns a launch takes
constexpr int kMaxHashLen = 512;     // string bytes hashed (_MAX_HASH_LEN)
constexpr long long kMaxBlocks = 132 * 8;

constexpr unsigned kGolden = 0x9E3779B9u;   // the combine's golden ratio
constexpr unsigned kHiMul1 = 0x85EBCA6Bu;   // the hi lane's mix
constexpr unsigned kHiMul2 = 0xC2B2AE35u;
constexpr unsigned kLoMul1 = 0xCC9E2D51u;   // the lo lane's mix
constexpr unsigned kLoMul2 = 0x1B873593u;

// column kinds (ops/hashing.py _KIND)
constexpr int kI8 = 0;
constexpr int kU8 = 1;
constexpr int kI16 = 2;
constexpr int kU16 = 3;
constexpr int kI32 = 4;          // int32 and uint32
constexpr int kI64 = 5;          // int64 and uint64
constexpr int kBool = 6;
constexpr int kF16 = 7;
constexpr int kBF16 = 8;
constexpr int kF32 = 9;
constexpr int kF64 = 10;
constexpr int kStr = 11;

struct KeyCol {
  const unsigned char* data;   // row 0's first element (strings: bytes)
  const int* lens;             // strings: the lengths; else unused
  long long row_stride;        // bytes from a row to the next
  long long col_stride;        // bytes between a 2-D column's elements
  long long lens_stride;       // elements from a length to the next
  int kind;
  int width;                   // elements a row (strings: max_len)
};

struct Params {
  KeyCol cols[kMaxCols];
  const unsigned* weights;     // strings' byte weights: hi lane's, lo lane's
  long long* hi;
  long long* lo;
  long long n;
  int ncols;
  int seeded;                  // start from hi, lo (a later launch of a call)
};

__device__ __forceinline__ unsigned mix32(unsigned x, unsigned c1,
                                          unsigned c2) {
  x ^= x >> 16;
  x *= c1;
  x ^= x >> 13;
  x *= c2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ unsigned combine1(unsigned a, unsigned b,
                                             unsigned c1, unsigned c2) {
  return mix32(a ^ (b + kGolden + (a << 6) + (a >> 2)), c1, c2);
}

// (h, l) = the plain version's _combine((h, l), (g, k))
__device__ __forceinline__ void combine(unsigned& h, unsigned& l, unsigned g,
                                        unsigned k) {
  h = combine1(h, g, kHiMul1, kHiMul2);
  l = combine1(l, k, kLoMul1, kLoMul2);
}

__device__ __forceinline__ unsigned quiet_nan(unsigned sign, unsigned top) {
  return sign | 0x7FC00000u | (top & 0x007FFFFFu);
}

__device__ __forceinline__ unsigned f16_bits(unsigned u) {
  const unsigned e = (u >> 10) & 0x1Fu, m = u & 0x3FFu;
  const unsigned s = (u & 0x8000u) << 16;
  if (e == 0) return 0u;
  if (e == 0x1Fu) return m ? quiet_nan(s, m << 13) : s | 0x7F800000u;
  return s | ((e + 112u) << 23) | (m << 13);
}

__device__ __forceinline__ unsigned f64_bits(unsigned long long u) {
  if ((u & 0x7FF0000000000000ull) == 0) return 0u;
  if ((u & 0x7FFFFFFFFFFFFFFFull) > 0x7FF0000000000000ull)
    return quiet_nan((unsigned)(u >> 32) & 0x80000000u, (unsigned)(u >> 29));
  return __float_as_uint(__double2float_rn(__longlong_as_double(u)));
}

// word w of a row of a dense column of kind K, as the plain version's bits
template <int K>
__device__ __forceinline__ unsigned word(const KeyCol& c, long long row,
                                         int w) {
  const unsigned char* p = c.data + row * c.row_stride;
  if (K == kI64) {
    const bool high = w < c.width;
    const auto v = __ldg(reinterpret_cast<const unsigned long long*>(
        p + (high ? w : w - c.width) * c.col_stride));
    return high ? (unsigned)(v >> 32) : (unsigned)v;
  }
  p += w * c.col_stride;
  const auto* u16 = reinterpret_cast<const unsigned short*>(p);
  const auto* u32 = reinterpret_cast<const unsigned*>(p);
  if (K == kI8)
    return (unsigned)(int)__ldg(reinterpret_cast<const signed char*>(p));
  if (K == kU8) return __ldg(p);
  if (K == kBool) return __ldg(p) != 0;
  if (K == kI16)
    return (unsigned)(int)__ldg(reinterpret_cast<const short*>(p));
  if (K == kU16) return __ldg(u16);
  if (K == kI32) return __ldg(u32);
  if (K == kF16) return f16_bits(__ldg(u16));
  if (K == kBF16) {
    const unsigned u = __ldg(u16);
    return (u & 0x7F80u) ? u << 16 : 0u;
  }
  if (K == kF32) {
    const unsigned u = __ldg(u32);
    return (u & 0x7F800000u) ? u : 0u;
  }
  return f64_bits(__ldg(reinterpret_cast<const unsigned long long*>(p)));
}

// the hash of a dense column of kind K at each of the thread's rows
template <int K>
__device__ __forceinline__ void dense(const KeyCol& c,
                                      const long long (&row)[kRows],
                                      long long n, unsigned (&h)[kRows],
                                      unsigned (&l)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) h[r] = l[r] = 0u;
  const int words = K == kI64 ? 2 * c.width : c.width;
  for (int w = 0; w < words; ++w) {
    unsigned b[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      b[r] = row[r] < n ? word<K>(c, row[r], w) : 0u;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      combine(h[r], l[r], mix32(b[r], kHiMul1, kHiMul2),
              mix32(b[r], kLoMul1, kLoMul2));
  }
}

// the hash of a string column at each of the thread's rows
__device__ __forceinline__ void strings(const KeyCol& c,
                                        const long long (&row)[kRows],
                                        long long n,
                                        const unsigned* __restrict__ wts,
                                        unsigned (&h)[kRows],
                                        unsigned (&l)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    h[r] = l[r] = 0u;
    if (row[r] >= n) continue;
    const int len = __ldg(c.lens + row[r] * c.lens_stride);
    const int m = len < 0 ? 0 : (len < c.width ? len : c.width);
    const unsigned char* p = c.data + row[r] * c.row_stride;
    unsigned s1 = 0u, s2 = 0u;
    for (int j = 0; j < m; ++j) {
      const unsigned b = __ldg(p + j) + 1u;
      s1 += b * __ldg(wts + j);
      s2 += b * __ldg(wts + kMaxHashLen + j);
    }
    unsigned hh = mix32(s1, kLoMul1, kHiMul1);
    unsigned ll = mix32(s2, kLoMul2, kHiMul2);
    const unsigned lu = (unsigned)len;
    combine(hh, ll, mix32(lu, kHiMul1, kHiMul2),
            mix32(lu, kLoMul1, kLoMul2));
    h[r] = hh;
    l[r] = ll;
  }
}

__device__ __forceinline__ void column(const KeyCol& c,
                                       const long long (&row)[kRows],
                                       long long n, const unsigned* wts,
                                       unsigned (&h)[kRows],
                                       unsigned (&l)[kRows]) {
  switch (c.kind) {
    case kI8: dense<kI8>(c, row, n, h, l); break;
    case kU8: dense<kU8>(c, row, n, h, l); break;
    case kI16: dense<kI16>(c, row, n, h, l); break;
    case kU16: dense<kU16>(c, row, n, h, l); break;
    case kI32: dense<kI32>(c, row, n, h, l); break;
    case kI64: dense<kI64>(c, row, n, h, l); break;
    case kBool: dense<kBool>(c, row, n, h, l); break;
    case kF16: dense<kF16>(c, row, n, h, l); break;
    case kBF16: dense<kBF16>(c, row, n, h, l); break;
    case kF32: dense<kF32>(c, row, n, h, l); break;
    case kF64: dense<kF64>(c, row, n, h, l); break;
    case kStr:
    default: strings(c, row, n, wts, h, l); break;
  }
}

__global__ void __launch_bounds__(kThreads)
    key_hash_rows(const __grid_constant__ Params p) {
  const long long step = (long long)gridDim.x * kThreads * kRows;
  for (long long base = (long long)blockIdx.x * kThreads * kRows +
                        threadIdx.x;
       base < p.n; base += step) {
    long long row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) row[r] = base + (long long)r * kThreads;
    unsigned h[kRows], l[kRows];
    int c = 0;
    if (p.seeded) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        h[r] = row[r] < p.n ? (unsigned)p.hi[row[r]] : 0u;
        l[r] = row[r] < p.n ? (unsigned)p.lo[row[r]] : 0u;
      }
    } else {
      column(p.cols[0], row, p.n, p.weights, h, l);
      c = 1;
    }
    for (; c < p.ncols; ++c) {
      unsigned ch[kRows], cl[kRows];
      column(p.cols[c], row, p.n, p.weights, ch, cl);
#pragma unroll
      for (int r = 0; r < kRows; ++r) combine(h[r], l[r], ch[r], cl[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row[r] < p.n) {
        p.hi[row[r]] = (long long)h[r];
        p.lo[row[r]] = (long long)l[r];
      }
    }
  }
}

}  // namespace

// desc: ncols rows of 7 int64s — data pointer, lengths pointer, row stride
// (bytes), column stride (bytes), lengths stride (elements), kind, width.
// weights: 2 * kMaxHashLen uint32 on the device, or null when no column is
// a string.  seeded: 0 for a call's first launch, which writes hi and lo;
// 1 for each later one, which reads them first.  hi, lo: int64 [n].
extern "C" int dryad_hash_keys(const long long* desc, int ncols, long long n,
                               const void* weights, int seeded, void* hi,
                               void* lo, void* stream) {
  if (ncols < 1 || ncols > kMaxCols) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    Params p;
    for (int c = 0; c < ncols; ++c) {
      const long long* d = desc + 7 * c;
      p.cols[c].data = reinterpret_cast<const unsigned char*>(d[0]);
      p.cols[c].lens = reinterpret_cast<const int*>(d[1]);
      p.cols[c].row_stride = d[2];
      p.cols[c].col_stride = d[3];
      p.cols[c].lens_stride = d[4];
      p.cols[c].kind = (int)d[5];
      p.cols[c].width = (int)d[6];
    }
    for (int c = ncols; c < kMaxCols; ++c) p.cols[c] = KeyCol{};
    p.weights = static_cast<const unsigned*>(weights);
    p.hi = static_cast<long long*>(hi);
    p.lo = static_cast<long long*>(lo);
    p.n = n;
    p.ncols = ncols;
    p.seeded = seeded;
    long long blocks = (n + (long long)kThreads * kRows - 1) /
                       ((long long)kThreads * kRows);
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    key_hash_rows<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p);
  }
  return (int)cudaGetLastError();
}
