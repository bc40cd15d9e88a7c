// hist_buckets — counts of each bucket id in [0, n_buckets).
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_kernels.py:137 hist_buckets
// (pallas_call at :158, body _hist_kernel_body at :119).  Ids outside
// [0, n_buckets) — the invalid-row sentinel n_buckets, negatives — are
// skipped.
//
// Bound on Hopper: bytes.  The kernel reads n int32 ids once and writes
// n_buckets int32 counts once; one compare and one add per id is far below
// the card's integer rate.
//
// Design: the TPU kernel broadcast-compares each [128, 128] tile against a
// bucket iota in VMEM because the TPU has no scatter unit.  Hopper has fast
// shared-memory atomics, so each block keeps a private histogram in shared
// memory, walks its grid-stride share of the ids with coalesced loads and
// one shared atomicAdd per id, then merges into the global output with one
// global atomicAdd per non-empty bucket.  When the histogram does not fit
// the shared budget every id goes straight to a global atomicAdd, so every
// n_buckets is taken (the TPU wrapper's 512-bucket gate has no
// counterpart).  The output is zeroed on the stream before the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;            // 8 resident blocks per SM
constexpr int kMaxSharedBuckets = 12 * 1024;   // 48 KB of shared memory

__global__ void hist_shared(const int* __restrict__ bid, long long n,
                            int n_buckets, int* __restrict__ out) {
  extern __shared__ int h[];
  for (int i = threadIdx.x; i < n_buckets; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int b = bid[i];
    if ((unsigned)b < (unsigned)n_buckets) atomicAdd(&h[b], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_buckets; i += blockDim.x) {
    const int c = h[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
}

__global__ void hist_global(const int* __restrict__ bid, long long n,
                            int n_buckets, int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int b = bid[i];
    if ((unsigned)b < (unsigned)n_buckets) atomicAdd(&out[b], 1);
  }
}

}  // namespace

extern "C" int dryad_hist_buckets(const void* bid, long long n,
                                  int n_buckets, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)n_buckets,
                                    s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && n_buckets > 0) {
    long long want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
    const int* b = static_cast<const int*>(bid);
    int* o = static_cast<int*>(out);
    if (n_buckets <= kMaxSharedBuckets) {
      hist_shared<<<blocks, kThreads, sizeof(int) * n_buckets, s>>>(
          b, n, n_buckets, o);
    } else {
      hist_global<<<blocks, kThreads, 0, s>>>(b, n, n_buckets, o);
    }
  }
  return (int)cudaGetLastError();
}
