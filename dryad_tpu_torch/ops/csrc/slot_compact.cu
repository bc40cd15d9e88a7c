// slot_compact — receive-side compaction of an exchange, for Dd
// destinations in one launch.
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_kernels.py:445 slot_compact
// (pallas_call at :484, body _compact_kernel_body at :423).
//
// recv is Dd received slot buffers [Dd, S*C, W] of 32-bit words: in
// destination d, source block s holds its valid rows as the prefix
// counts[d, s] (clamped to [0, C]) of rows [s*C, (s+1)*C).  Slice d of
// the [Dd, out_rows, W] output holds those rows densely in source order
// — row starts[s] + j is row j of block s, starts being the exclusive
// prefix of the clamped counts — and zeros at and past the total.  Rows
// past out_rows are dropped.  For Dd = 1 this is the TPU kernel's
// [out_rows, W]; for Dd it is one exchange's unpack for every
// destination.
//
// Bound on Hopper: bytes.  Dd*out_rows*W words are written once and the
// min(total, out_rows)*W valid words of each destination read once.
//
// Design: the TPU kernel lets every block write its full C rows at the
// running cursor and relies on the sequential grid to make the last
// writer win where blocks overlap.  Blocks on Hopper run in parallel, so
// nothing may be written twice; the loop runs over OUTPUT chunks.  Grid
// (chunks of kChunkWords output words, Dd).  A block loads counts[d, :]
// once, clamps it and builds starts[0..S] in shared memory with a block
// scan, then finds the source span its chunk starts in with ONE binary
// search (one division per block: row = first word / W).  It walks the
// spans from there: each piece [a, b) of the chunk inside one span is a
// contiguous copy whose source is the output word plus a shift that is
// the same over the whole piece ((s*C - starts[s]) * W words), and the
// piece past min(total, out_rows) rows is one zero span.  No thread
// divides or searches per word.  Every store is an aligned int4 store,
// except scalar heads and tails of at most 3 words a piece.  A source
// need not be 16-byte aligned (rows of W = 7 or 46 words start anywhere):
// its misalignment against the aligned store is a whole number of words,
// uniform over the piece, so each vector is the two aligned int4s that
// cover it, joined by a select that is uniform across the block (as
// slot_expand.cu does).  The second of the two is the next lane's first,
// so a lane loads one int4 and takes the other by a warp shuffle: one
// load a vector instead of two where a span's start is not 16-byte
// aligned.  kVecs vectors are in flight a thread.  The zero span stores
// int4 zeros with no load.  Offsets are 64-bit throughout.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                           // 16-byte stores a thread
constexpr long long kChunkWords = 4LL * kThreads * kVecs;   // 16 KB

__device__ __forceinline__ unsigned word_mis(const void* p) {
  return (unsigned)((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
}

// The four words from word shift (1 to 3) of lo on, running into hi.
__device__ __forceinline__ int4 join(int4 lo, int4 hi, unsigned shift) {
  if (shift == 1) return make_int4(lo.y, lo.z, lo.w, hi.x);
  if (shift == 2) return make_int4(lo.z, lo.w, hi.x, hi.y);
  return make_int4(lo.w, hi.x, hi.y, hi.z);
}

__device__ __forceinline__ int4 shfl_down1(int4 v) {
  v.x = __shfl_down_sync(0xffffffffu, v.x, 1);
  v.y = __shfl_down_sync(0xffffffffu, v.y, 1);
  v.z = __shfl_down_sync(0xffffffffu, v.z, 1);
  v.w = __shfl_down_sync(0xffffffffu, v.w, 1);
  return v;
}

// Output words [a, b) of one destination: dst[e] = src[e + delta], or
// zero when zero is set.  m is dst's word misalignment.  Every thread of
// the block calls it with the same arguments.
__device__ __forceinline__ void copy_piece(int* __restrict__ dst,
                                           const int* __restrict__ src,
                                           long long a, long long b,
                                           long long delta, bool zero,
                                           unsigned m) {
  const int tid = threadIdx.x;
  // [va, vb): the whole 16-byte vectors of the piece
  long long va = a + ((4 - ((m + a) & 3)) & 3);
  long long vb = b - ((m + b) & 3);
  if (va > vb) va = vb = b;              // under one vector: all scalar
  const int head = (int)(va - a), tail = (int)(b - vb);
  if (tid < head) dst[a + tid] = zero ? 0 : src[a + tid + delta];
  if (tid >= 4 && tid - 4 < tail) {
    const long long e = vb + tid - 4;
    dst[e] = zero ? 0 : src[e + delta];
  }
  const long long nv = (vb - va) >> 2;
  int4* dv = reinterpret_cast<int4*>(dst + va);
  if (zero) {
    const int4 z = make_int4(0, 0, 0, 0);
    for (long long q = tid; q < nv; q += kThreads) dv[q] = z;
    return;
  }
  // vector q is words [4q, 4q + 4) of s, covered by the aligned int4s
  // sa[q] and (where s is misaligned) sa[q + 1]; each holds a word of
  // the piece, so neither load leaves the allocation.  Lane l loads
  // sa[q] and takes sa[q + 1] from lane l + 1, which loaded it as its
  // own; a warp's last lane and the piece's last vector load it.
  const int* s = src + va + delta;
  const unsigned shift = word_mis(s);
  const int4* sa = reinterpret_cast<const int4*>(s - shift);
  const int lane = tid & 31;
  for (long long base = 0; base < nv; base += kThreads * kVecs) {
    int4 v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const long long q = base + u * kThreads + tid;
      int4 lo = make_int4(0, 0, 0, 0);
      if (q < nv) lo = __ldg(sa + q);
      if (shift == 0) {                  // uniform over the block
        v[u] = lo;
        continue;
      }
      int4 hi = shfl_down1(lo);          // every lane takes part
      if (q < nv && (lane == 31 || q + 1 == nv)) hi = __ldg(sa + q + 1);
      v[u] = join(lo, hi, shift);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const long long q = base + u * kThreads + tid;
      if (q < nv) dv[q] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    slot_compact_v2(const int* __restrict__ recv,
                    const int* __restrict__ counts, int S, int C, int W,
                    long long out_rows, int* __restrict__ out) {
  extern __shared__ long long starts[];          // S + 1 entries
  __shared__ long long warp_sum[kThreads / 32];
  const int d = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // starts[0..S]: each thread clamps a run of consecutive counts, then a
  // block scan of the runs' sums
  const int* cnt = counts + (long long)d * S;
  const int per = (S + kThreads - 1) / kThreads;
  const int i0 = tid * per, i1 = min(S, i0 + per);
  long long own = 0;
  for (int i = i0; i < i1; ++i) {
    int c = __ldg(cnt + i);
    c = c < 0 ? 0 : (c > C ? C : c);
    starts[i] = c;
    own += c;
  }
  long long x = own;                             // inclusive, in the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kThreads / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kThreads / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  long long run = x - own + (warp ? warp_sum[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    const long long c = starts[i];
    starts[i] = run;
    run += c;
  }
  if (tid == kThreads - 1) starts[S] = run;      // the total
  __syncthreads();

  // this block's chunk of destination d's output words; chunk
  // boundaries past the first sit on 16-byte boundaries of the output
  const long long n = out_rows * W;
  int* dst = out + (long long)d * n;
  const int* src = recv + (long long)d * S * C * W;
  const unsigned m = word_mis(dst);
  const long long head = (4 - m) & 3;
  const long long k = blockIdx.x;
  long long lo = k == 0 ? 0 : head + k * kChunkWords;
  long long hi = k + 1 == gridDim.x ? n : head + (k + 1) * kChunkWords;
  lo = lo < n ? lo : n;
  hi = hi < n ? hi : n;
  const long long total = starts[S];
  const long long valid = (total < out_rows ? total : out_rows) * W;

  // the span holding the chunk's first row: the last s whose start is
  // at or before it (empty blocks share their start with the next one)
  int s = 0;
  if (lo < valid) {
    const long long r = lo / W;
    int a = 0, b = S - 1;
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (starts[mid] <= r) a = mid; else b = mid - 1;
    }
    s = a;
  }
  long long pos = lo;
  while (pos < hi) {
    if (pos >= valid) {
      copy_piece(dst, src, pos, hi, 0, true, m);
      break;
    }
    while (starts[s + 1] * W <= pos) ++s;        // skip empty blocks
    long long end = starts[s + 1] * W;
    end = end < valid ? end : valid;
    end = end < hi ? end : hi;
    copy_piece(dst, src, pos, end, ((long long)s * C - starts[s]) * W,
               false, m);
    pos = end;
  }
}

}  // namespace

// recv: [Dd, S*C, W] int32; counts: [Dd, S] int32; out: [Dd, out_rows, W].
// Dd at most 65535 (grid dimension y), S at most 4096 (starts in 48 KB of
// shared memory).
extern "C" int dryad_slot_compact(const void* recv, const void* counts,
                                  int Dd, int S, int C, int W,
                                  long long out_rows, void* out,
                                  void* stream) {
  const long long n = out_rows * W;
  if (Dd > 0 && n > 0) {
    const long long chunks = (n + kChunkWords - 1) / kChunkWords;
    dim3 grid((unsigned)chunks, (unsigned)Dd);
    slot_compact_v2<<<grid, kThreads, sizeof(long long) * (S + 1),
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(recv), static_cast<const int*>(counts), S,
        C, W, out_rows, static_cast<int*>(out));
  }
  return (int)cudaGetLastError();
}
