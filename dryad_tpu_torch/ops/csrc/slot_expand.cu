// slot_expand — send-slot grid of an exchange, for P source partitions in
// one launch, written in the receive layout.
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_kernels.py:384 slot_expand
// (pallas_call at :408, body _expand_kernel_body at :365).
//
// words is P dest-sorted packed row matrices [P, cap, W] of 32-bit words;
// in partition p, destination d's rows start at offsets[p, d].  Block
// (d, p) of the [D, P*C, W] output — rows [p*C, (p+1)*C) of destination
// d's receive buffer — holds the C rows of partition p starting at
// clip(offsets[p, d], 0, cap), padded with C zero rows (the TPU wrapper
// pads the same way at :407, so no start is clamped down onto another
// destination's run).  Slots past a run's count hold whatever follows it;
// the receiver masks them with the send counts.  For one partition
// (P = 1) this is the TPU kernel's [D*C, W]; for P it is the TPU's P
// per-core calls after their all_to_all, which on one card is only a
// choice of store address.
//
// Bound on Hopper: bytes.  D*P*C*W words are written, and the union of
// the runs read (runs overlap: C is twice the fair share, and the rows
// read again for a second destination come from L2).
//
// Design: each (d, p) block is one contiguous span of C*W output words
// and reads one contiguous span of source words, cut off at the end of
// partition p (past it, the zeros of the pad, stored with no load).
// Grid (blocks per span, P, D): a block reads its offset once and copies
// chunks of kThreads * kVecs 16-byte vectors (16 KB), kVecs loads in
// flight a thread.  Every store is an aligned int4 store, except a scalar
// head and tail of at most 3 words where C*W is not a multiple of 4.
// Sources need not be 16-byte aligned (GroupByReduce's exchange moves
// W = 7 words a row, so a run starts on 16 bytes only when its start row
// is a multiple of 4): the shift of the source against the aligned
// store is a whole number of words, the same for a whole span, so each
// vector is the two aligned int4 loads that cover it, joined by a
// register select that is uniform across the block — never 4-byte loads.
// Only the one vector that crosses the end of the partition's rows reads
// word by word.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                         // 16-byte stores a thread
constexpr long long kChunkVecs = kThreads * kVecs;
constexpr long long kTargetBlocks = 132 * 8;     // one wave on 132 SMs

__device__ __forceinline__ unsigned word_mis(const void* p) {
  return (unsigned)((reinterpret_cast<unsigned long long>(p) >> 2) & 3);
}

// src[e .. e+3], words at and past avail reading as zero.  shift is the
// word misalignment of src + e (the same for every e of a span).
__device__ __forceinline__ int4 fetch(const int* __restrict__ src,
                                      long long e, long long avail,
                                      unsigned shift) {
  if (e + 4 <= avail) {
    // both aligned vectors hold a word of the run, so neither faults
    const int4* a = reinterpret_cast<const int4*>(src + e - shift);
    const int4 lo = __ldg(a);
    if (shift == 0) return lo;
    const int4 hi = __ldg(a + 1);
    if (shift == 1) return make_int4(lo.y, lo.z, lo.w, hi.x);
    if (shift == 2) return make_int4(lo.z, lo.w, hi.x, hi.y);
    return make_int4(lo.w, hi.x, hi.y, hi.z);
  }
  if (e >= avail) return make_int4(0, 0, 0, 0);
  return make_int4(src[e], e + 1 < avail ? src[e + 1] : 0,
                   e + 2 < avail ? src[e + 2] : 0, 0);
}

__global__ void __launch_bounds__(kThreads)
    slot_expand_v4(const int* __restrict__ words, long long cap, int W,
                   const int* __restrict__ offsets, int D, int C,
                   int* __restrict__ out) {
  const int p = blockIdx.y;
  const int d = blockIdx.z;
  const int P = gridDim.y;
  long long start = __ldg(offsets + (long long)p * D + d);
  start = start < 0 ? 0 : (start > cap ? cap : start);
  const long long run = (long long)C * W;
  const long long avail = (cap - start) * W;   // real source words left
  const int* src = words + ((long long)p * cap + start) * W;
  int* dst = out + ((long long)d * P + p) * run;

  // scalar head up to the first 16-byte boundary of dst, int4 body,
  // scalar tail
  const long long head = run < ((4 - word_mis(dst)) & 3)
                             ? run : ((4 - word_mis(dst)) & 3);
  const long long nvec = (run - head) >> 2;
  const long long tail = head + 4 * nvec;
  const int tid = threadIdx.x;
  if (blockIdx.x == 0) {
    if (tid < head) dst[tid] = tid < avail ? src[tid] : 0;
    const long long e = tail + tid;
    if (e < run) dst[e] = e < avail ? src[e] : 0;
  }

  const int* s = src + head;
  const long long av = avail - head;
  const unsigned shift = word_mis(s);
  int4* dv = reinterpret_cast<int4*>(dst + head);
  for (long long base = (long long)blockIdx.x * kChunkVecs; base < nvec;
       base += (long long)gridDim.x * kChunkVecs) {
    int4 v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const long long q = base + u * kThreads + tid;
      if (q < nvec) v[u] = fetch(s, 4 * q, av, shift);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const long long q = base + u * kThreads + tid;
      if (q < nvec) dv[q] = v[u];
    }
  }
}

}  // namespace

// words: [P, cap, W] int32; offsets: [P, D] int32; out: [D, P*C, W].
// P and D at most 65535 (grid dimensions y and z).
extern "C" int dryad_slot_expand(const void* words, int P, long long cap,
                                 int W, const void* offsets, int D, int C,
                                 void* out, void* stream) {
  const long long run = (long long)C * W;
  if (P > 0 && D > 0 && run > 0) {
    const long long spans = (long long)P * D;
    const long long chunks = ((run >> 2) + kChunkVecs - 1) / kChunkVecs;
    long long per_span = (kTargetBlocks + spans - 1) / spans;
    if (chunks < 1) per_span = 1;
    else if (per_span > chunks) per_span = chunks;
    // even out the chunks over the span's blocks
    if (chunks > 0) {
      const long long each = (chunks + per_span - 1) / per_span;
      per_span = (chunks + each - 1) / each;
    }
    dim3 grid((unsigned)per_span, (unsigned)P, (unsigned)D);
    slot_expand_v4<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(words), cap, W,
        static_cast<const int*>(offsets), D, C, static_cast<int*>(out));
  }
  return (int)cudaGetLastError();
}
