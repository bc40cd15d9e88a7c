// hist_buckets — counts of each bucket id in [0, n_buckets), for P rows of
// ids in one launch.
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_kernels.py:137 hist_buckets
// (pallas_call at :158, body _hist_kernel_body at :119).  Row p of the
// [P, n_buckets] output counts row p of the [P, n] ids; ids outside
// [0, n_buckets) — the invalid-row sentinel n_buckets, negatives — are
// skipped.  One row is the TPU kernel's whole call; the exchange passes
// its P source partitions together.
//
// Bound on Hopper: bytes.  The kernel reads P*n int32 ids once and writes
// P*n_buckets int32 counts once; one compare and one add per id and bucket
// is far below the card's integer rate at the buckets this route takes.
//
// Design, small route (n_buckets <= kMaxSmallBuckets; the exchange has
// n_buckets = P = 8): grid (blocks per row, P), the wrapper choosing the
// blocks per row.  Each thread reads 4 ids per 16-byte load, kVecs loads in
// flight (a row that does not start on 16 bytes peels a scalar head, and
// the ragged end a scalar tail), and counts in registers by comparing each
// id with every bucket — the TPU kernel's broadcast-compare, with no
// atomics at all.  A warp sums its counters with __reduce_add_sync, the
// block sums its warps in shared memory, and writes its n_buckets partial
// counts to a scratch slot.  The last block of each row to finish (a
// per-row ticket taken with atomicAdd after a __threadfence) sums that
// row's partials in block order, writes the row, and sets the ticket back
// to zero.  So a call is one kernel launch: no memset, no atomic on the
// output.  The tickets are kept zero between launches (the wrapper keeps
// one zeroed ticket buffer per device and stream; each launch leaves it as
// it found it); the partials are written before they are read and need no
// clearing.  With one block a row there is no scratch at all.
//
// Large route (more buckets): per (row, block) a shared-memory histogram
// with shared atomics merged by global atomics, or global atomics alone
// past kMaxSharedBuckets (every n_buckets is taken; the TPU wrapper's
// 512-bucket gate has no counterpart).  The output is zeroed on the stream
// first.  No main path takes it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                       // 16-byte loads a thread
constexpr int kMaxSmallBuckets = 32;
constexpr int kMaxSharedBuckets = 12 * 1024;   // 48 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;

template <int NB>
__device__ __forceinline__ void count1(int id, int (&c)[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) c[b] += id == b;
}

template <int NB>
__device__ __forceinline__ void count4(int4 v, int (&c)[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
    c[b] += (v.x == b) + (v.y == b) + (v.z == b) + (v.w == b);
}

// NB: a power of two >= n_buckets.  Ids in [n_buckets, NB) are counted
// in registers that are never written out.
template <int NB>
__global__ void __launch_bounds__(kThreads)
    hist_small(const int* __restrict__ bid, long long n, int n_buckets,
               int* __restrict__ out, int* __restrict__ tickets,
               int* __restrict__ partials) {
  const int p = blockIdx.y;
  const int tid = threadIdx.x;
  const int* row = bid + (long long)p * n;
  int c[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) c[b] = 0;

  // scalar head up to the first 16-byte boundary, vectors, scalar tail
  const int mis = (int)((reinterpret_cast<unsigned long long>(row) >> 2) & 3);
  const long long head = n < ((4 - mis) & 3) ? n : ((4 - mis) & 3);
  const long long nv = (n - head) >> 2;
  const long long tail = head + 4 * nv;
  if (blockIdx.x == 0) {
    if (tid < head) count1<NB>(row[tid], c);
    if (tail + tid < n) count1<NB>(row[tail + tid], c);
  }
  const int4* v4 = reinterpret_cast<const int4*>(row + head);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + tid; q < nv;
       q += kVecs * stride) {
    int4 v[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const long long j = q + u * stride;
      v[u] = j < nv ? __ldg(v4 + j) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) count4<NB>(v[u], c);
  }

  // warp, then block, sums of the counters
  __shared__ int warp_c[kWarps][NB];
  __shared__ bool s_last;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int s = __reduce_add_sync(kFull, c[b]);
    if (lane == 0) warp_c[warp][b] = s;
  }
  __syncthreads();
  int total = 0;
  if (tid < n_buckets) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_c[w][tid];
  }
  int* o = out + (long long)p * n_buckets;
  if (gridDim.x == 1) {
    if (tid < n_buckets) o[tid] = total;
    return;
  }

  // the row's partials; its last block sums them
  int* part = partials + (long long)p * gridDim.x * n_buckets;
  if (tid < n_buckets) part[blockIdx.x * n_buckets + tid] = total;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(tickets + p, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid < n_buckets) {
    int s = 0;
    for (unsigned j = 0; j < gridDim.x; ++j)
      s += __ldcg(part + j * n_buckets + tid);
    o[tid] = s;
  }
  if (tid == 0) tickets[p] = 0;
}

__global__ void __launch_bounds__(kThreads)
    hist_shared(const int* __restrict__ bid, long long n, int n_buckets,
                int* __restrict__ out) {
  extern __shared__ int h[];
  const int* row = bid + (long long)blockIdx.y * n;
  int* o = out + (long long)blockIdx.y * n_buckets;
  for (int i = threadIdx.x; i < n_buckets; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int b = row[i];
    if ((unsigned)b < (unsigned)n_buckets) atomicAdd(&h[b], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_buckets; i += blockDim.x) {
    const int c = h[i];
    if (c != 0) atomicAdd(&o[i], c);
  }
}

__global__ void __launch_bounds__(kThreads)
    hist_global(const int* __restrict__ bid, long long n, int n_buckets,
                int* __restrict__ out) {
  const int* row = bid + (long long)blockIdx.y * n;
  int* o = out + (long long)blockIdx.y * n_buckets;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int b = row[i];
    if ((unsigned)b < (unsigned)n_buckets) atomicAdd(&o[b], 1);
  }
}

}  // namespace

// bid: [P, n] int32; out: [P, n_buckets] int32.  blocks_per_row >= 1.
// Small route: tickets (P int32, all zero, left zero) and partials
// (P * blocks_per_row * n_buckets int32) are the caller's, kept for the
// stream; both may be null when blocks_per_row is 1.
extern "C" int dryad_hist_buckets(const void* bid, int P, long long n,
                                  int n_buckets, int blocks_per_row,
                                  void* out, void* tickets, void* partials,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || n_buckets <= 0) return (int)cudaGetLastError();
  const int* b = static_cast<const int*>(bid);
  int* o = static_cast<int*>(out);
  const dim3 grid((unsigned)blocks_per_row, (unsigned)P);
  if (n_buckets <= kMaxSmallBuckets) {
    int* t = static_cast<int*>(tickets);
    int* part = static_cast<int*>(partials);
    if (n_buckets <= 8)
      hist_small<8><<<grid, kThreads, 0, s>>>(b, n, n_buckets, o, t, part);
    else if (n_buckets <= 16)
      hist_small<16><<<grid, kThreads, 0, s>>>(b, n, n_buckets, o, t, part);
    else
      hist_small<32><<<grid, kThreads, 0, s>>>(b, n, n_buckets, o, t, part);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int) * (size_t)P * (size_t)n_buckets, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    if (n_buckets <= kMaxSharedBuckets) {
      hist_shared<<<grid, kThreads, sizeof(int) * n_buckets, s>>>(
          b, n, n_buckets, o);
    } else {
      hist_global<<<grid, kThreads, 0, s>>>(b, n, n_buckets, o);
    }
  }
  return (int)cudaGetLastError();
}
