// slot_compact — receive-side compaction of an exchange.
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_kernels.py:445 slot_compact
// (pallas_call at :484, body _compact_kernel_body at :423).
//
// words is the received slot buffer [D*C, W]: source block s holds its
// valid rows as the prefix counts[s] (clamped to [0, C]) of rows
// [s*C, (s+1)*C).  The [out_rows, W] output holds the valid rows densely in
// source order — row starts[s] + j is row j of block s, starts being the
// exclusive prefix of the clamped counts — and zeros at and past the
// total.  Rows past out_rows are truncated.
//
// Bound on Hopper: bytes.  out_rows*W words are written once and the
// min(total, out_rows)*W valid words read once; the index arithmetic is a
// few integer operations per word.
//
// Design: the TPU kernel lets every block write its full C rows at the
// running cursor and relies on the sequential grid to make the last
// writer win where blocks overlap.  Blocks on Hopper run in parallel, so
// nothing may be written twice.  Here the loop runs over OUTPUT words:
// each block first builds starts[0..D] in shared memory, then each thread
// takes output words in a grid-stride loop, finds its source block by a
// binary search of starts, and either copies one valid word (coalesced:
// the valid rows of a block are contiguous on both sides) or writes zero.
// Every output word is written exactly once and only valid rows are read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;

__global__ void slot_compact_k(const int* __restrict__ words,
                               const int* __restrict__ counts, int D, int C,
                               int W, long long out_rows,
                               int* __restrict__ out) {
  extern __shared__ long long starts[];   // D + 1 entries
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (int s = 0; s < D; ++s) {
      starts[s] = acc;
      int c = counts[s];
      c = c < 0 ? 0 : (c > C ? C : c);
      acc += c;
    }
    starts[D] = acc;
  }
  __syncthreads();
  const long long total = starts[D];
  const long long n = out_rows * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    const long long r = e / W;
    const int w = (int)(e - r * W);
    int v = 0;
    if (r < total) {
      // the last block whose start is <= r holds row r (empty blocks
      // share their start with the next block, which comes later)
      int lo = 0, hi = D - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (starts[mid] <= r) lo = mid; else hi = mid - 1;
      }
      v = words[((long long)lo * C + (r - starts[lo])) * W + w];
    }
    out[e] = v;
  }
}

}  // namespace

extern "C" int dryad_slot_compact(const void* words, const void* counts,
                                  int D, int C, int W, long long out_rows,
                                  void* out, void* stream) {
  const long long n = out_rows * W;
  if (n > 0) {
    long long want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
    slot_compact_k<<<blocks, kThreads, sizeof(long long) * (D + 1),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(words), static_cast<const int*>(counts), D,
        C, W, out_rows, static_cast<int*>(out));
  }
  return (int)cudaGetLastError();
}
