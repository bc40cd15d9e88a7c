// slot_expand — send-slot grid of an exchange.
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_kernels.py:384 slot_expand
// (pallas_call at :408, body _expand_kernel_body at :365).
//
// words is the dest-sorted packed row matrix [cap, W] of 32-bit words;
// destination d's rows start at offsets[d].  Block d of the [D*C, W]
// output holds the C rows starting at clip(offsets[d], 0, cap) of the
// source padded with C zero rows (the TPU wrapper pads the same way at
// :407, so no start is clamped down onto another destination's run).
// Slots past a run's count hold whatever follows it; the receiver masks
// them with the send counts.
//
// Bound on Hopper: bytes.  D*C*W words are written and at most as many
// read: 8 bytes per output word, no arithmetic.
//
// Design: the TPU kernel issues one dynamic-offset block DMA per
// destination.  Here each destination's run is one contiguous span of
// C*W words, so grid (row tile, destination) copies it with coalesced
// word loads and stores, neighbouring threads on neighbouring words.  The
// C pad rows are never materialized: a word past the source's end reads as
// the zero the padded source would hold.  D = 1 and C < 8, which the TPU
// wrapper sends to an XLA gather, take the same path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksPerDest = 1024;

__global__ void slot_expand_k(const int* __restrict__ words, long long cap,
                              int W, const int* __restrict__ offsets,
                              int C, int* __restrict__ out) {
  const int d = blockIdx.y;
  long long start = offsets[d];
  start = start < 0 ? 0 : (start > cap ? cap : start);
  const long long run = (long long)C * W;
  const long long avail = (cap - start) * W;   // real source words left
  const int* src = words + start * W;
  int* dst = out + (long long)d * run;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < run; e += stride) {
    dst[e] = e < avail ? src[e] : 0;
  }
}

}  // namespace

extern "C" int dryad_slot_expand(const void* words, long long cap, int W,
                                 const void* offsets, int D, int C,
                                 void* out, void* stream) {
  const long long run = (long long)C * W;
  if (D > 0 && run > 0) {
    long long want = (run + kThreads - 1) / kThreads;
    dim3 grid((unsigned)(want < kMaxBlocksPerDest ? want : kMaxBlocksPerDest),
              (unsigned)D);
    slot_expand_k<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(words), cap, W,
        static_cast<const int*>(offsets), C, static_cast<int*>(out));
  }
  return (int)cudaGetLastError();
}
