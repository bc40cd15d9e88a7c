// scan_lookback.cuh — the single-pass scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016) shared by prefix_sum.cu and prefix_sum2.cu,
// in a deterministic form.
//
// One launch scans the whole input.  Each block of kThreads threads:
//   1. takes its tile from an atomic ticket (scratch word 0), not from
//      blockIdx.x.  A block waits on the tiles before its own; with
//      tickets, every earlier tile belongs to a block that is already
//      running, so the wait ends however many tiles outnumber the blocks
//      the card holds at once;
//   2. reads its tile of kThreads * kItems values ONCE into shared memory
//      (16-byte vector loads when the tile is full and aligned);
//   3. scans it from zero in registers: kItems contiguous values a thread,
//      warp shuffles over the thread totals, warp 0 over the warp totals.
//      The last warp total is the tile's aggregate;
//   4. publishes the aggregate behind a flag (Op::publish: one 64-bit
//      store for 32-bit values, a release store of the flag after the
//      value for the (hi, lo) pair);
//   5. looks back: folds the aggregates of ALL earlier tiles (Op::read
//      spins on each flag), thread i taking tiles i, i + kThreads, ... in
//      order, then a fixed shuffle tree and warp 0 over the warp results.
//      That is the tile's exclusive offset.  Then it counts itself done
//      (scratch word 1); the last block done knows every flag read has
//      returned, and clears the ticket, the count and the flags, so they
//      are zero again when the kernel ends — the next launch on the
//      stream needs no memset;
//   6. adds the offset to each tile-local prefix, once and last, and
//      writes the tile through shared memory (16-byte vector stores when
//      full and aligned).
//
// Determinism: textbook look-back stops at the first earlier tile whose
// inclusive prefix is ready, and which tile that is depends on timing, so
// a float scan would change in its last bits from run to run.  Here the
// offset folds the earlier tiles' aggregates only, never an inclusive
// prefix, in an order fixed by the tile index: every output is a fixed
// function of the input, bit for bit, on every run (Dryad re-executes
// vertices and relies on that).  The price is extra reads from L2: tile t
// reads t aggregates, tiles^2 / 2 in all — 47,000 at 306 tiles (1.25M
// values), 11.9M at 4,883 tiles (20M values: ~95 MB with 8-byte words,
// ~190 MB for prefix_sum2, which reads a flag word and a value word
// each).  A spin that outlasts ~2^26 naps traps (a launch error) instead
// of hanging the card.

#pragma once

#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSpinLimit = 1u << 26;
// scratch words before the tiles' status words: the ticket, the count of
// blocks done
constexpr int kHeadWords = 2;

// shared-memory index with one pad word per 32, so that a thread reading
// kItems contiguous words, and a warp writing 16-byte vectors, hit 32
// different banks
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// one more turn of a spin on a flag: nap, and trap past kSpinLimit
__device__ __forceinline__ void backoff(unsigned& spins) {
  if (++spins > kSpinLimit) __trap();
  __nanosleep(32);
}

template <class Op>
__device__ __forceinline__ typename Op::V warp_inclusive(typename Op::V v,
                                                         int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const typename Op::V u = Op::shfl_up(v, o);
    if (lane >= o) v = Op::add(u, v);
  }
  return v;
}

// lane 0 gets the fold of the warp's 32 values, lower lanes first
template <class Op>
__device__ __forceinline__ typename Op::V warp_fold(typename Op::V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = Op::add(v, Op::shfl_down(v, o));
  return v;
}

// s[pad(k)] = the tile's word k, for k < kTile; zero past n
template <int kThreads, int kItems>
__device__ __forceinline__ void load_tile(const unsigned* __restrict__ x,
                                          long long base, long long n,
                                          bool vec, unsigned* s) {
  const int tid = threadIdx.x;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int i = 0; i < kItems / 4; ++i) {
      const int q = i * kThreads + tid;
      const uint4 w = __ldcs(xv + q);  // read once: evict first
      s[pad(4 * q)] = w.x;
      s[pad(4 * q + 1)] = w.y;
      s[pad(4 * q + 2)] = w.z;
      s[pad(4 * q + 3)] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + tid;
      const long long j = base + k;
      s[pad(k)] = j < n ? x[j] : 0u;
    }
  }
}

// out[base + k] = s[pad(k)], for k < kTile and base + k < n
template <int kThreads, int kItems>
__device__ __forceinline__ void store_tile(unsigned* __restrict__ out,
                                           long long base, long long n,
                                           bool vec, const unsigned* s) {
  const int tid = threadIdx.x;
  if (vec) {
    uint4* ov = reinterpret_cast<uint4*>(out + base);
#pragma unroll
    for (int i = 0; i < kItems / 4; ++i) {
      const int q = i * kThreads + tid;
      ov[q] = make_uint4(s[pad(4 * q)], s[pad(4 * q + 1)], s[pad(4 * q + 2)],
                         s[pad(4 * q + 3)]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = i * kThreads + tid;
      const long long j = base + k;
      if (j < n) out[j] = s[pad(k)];
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// The whole scan, one tile per block (see the head of this file).  Op
// gives the value type V, its zero, the combine add(earlier, later), the
// shuffles, the 32-bit input word -> V (lift), V -> the word of output
// lane l (lane), and the publish / read of a tile's aggregate in its
// Op::kWords status words after the head, the first of them its flag.
// x and the kLanes outputs are 32-bit words; gridDim.x is the number of
// tiles.  The head and the flags must be zero at launch, and are again
// at the end; with one tile the scratch is not touched (it may be null).
template <class Op, int kThreads, int kItems>
__device__ __forceinline__ void scan(const unsigned* __restrict__ x,
                                     unsigned* __restrict__ out0,
                                     unsigned* __restrict__ out1, long long n,
                                     unsigned long long* scratch) {
  using V = typename Op::V;
  constexpr int kWarps = kThreads / 32;
  constexpr int kTile = kThreads * kItems;
  static_assert(kItems % 4 == 0, "16-byte vectors cover a thread's items");
  __shared__ unsigned s[kTile + kTile / 32];
  __shared__ V warp_tot[kWarps];
  __shared__ V fold_tot[kWarps];
  __shared__ V s_offset;
  __shared__ long long s_tile;
  __shared__ bool s_last;
  unsigned long long* status = scratch + kHeadWords;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long tiles = gridDim.x;

  // 1. the tile, from the ticket
  long long tile = 0;
  if (tiles > 1) {
    if (tid == 0) s_tile = (long long)atomicAdd(scratch, 1ull);
    __syncthreads();
    tile = s_tile;
  }
  const long long base = tile * kTile;
  const bool full = base + kTile <= n;

  // 2. the tile's one read
  load_tile<kThreads, kItems>(x, base, n, full && aligned16(x), s);
  __syncthreads();

  // 3. the tile-local inclusive prefix, from zero
  const int k0 = tid * kItems;
  V v[kItems];
  V run = Op::zero();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run = Op::add(run, Op::lift(s[pad(k0 + i)]));
    v[i] = run;
  }
  const V incl = warp_inclusive<Op>(run, lane);
  V excl = Op::shfl_up(incl, 1);
  if (lane == 0) excl = Op::zero();
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    V w = lane < kWarps ? warp_tot[lane] : Op::zero();
    w = warp_inclusive<Op>(w, lane);
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  // the tile-local prefix before this thread's first item
  const V before = warp > 0 ? Op::add(warp_tot[warp - 1], excl) : excl;

  // 4-5. publish the aggregate; fold the earlier tiles' aggregates
  V offset = Op::zero();
  if (tiles > 1) {
    if (tid == 0) Op::publish(status, tile, warp_tot[kWarps - 1]);
    if (tile > 0) {
      V acc = Op::zero();
      for (long long j = tid; j < tile; j += kThreads)
        acc = Op::add(acc, Op::read(status, j));
      acc = warp_fold<Op>(acc);
      if (lane == 0) fold_tot[warp] = acc;
      __syncthreads();
      if (warp == 0) {
        V w = lane < kWarps ? fold_tot[lane] : Op::zero();
        w = warp_fold<Op>(w);
        if (lane == 0) s_offset = w;
      }
      __syncthreads();
      offset = s_offset;
    }
    // every read of this block's look-back has returned: count it done;
    // the last block clears the scratch (the fences order every
    // publish before the count, and the count before the clearing)
    if (tid == 0) {
      __threadfence();
      s_last = atomicAdd(scratch + 1, 1ull) + 1 == (unsigned long long)tiles;
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      for (long long j = tid; j < tiles; j += kThreads)
        status[j * Op::kWords] = 0ull;
      if (tid == 0) scratch[0] = scratch[1] = 0ull;
    }
  }

  // 6. offset + tile-local prefix, the offset added once and last
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    v[i] = Op::add(offset, Op::add(before, v[i]));
#pragma unroll
  for (int l = 0; l < Op::kLanes; ++l) {
    unsigned* out = l == 0 ? out0 : out1;
    if (l > 0) __syncthreads();  // the previous lane's stores read s
#pragma unroll
    for (int i = 0; i < kItems; ++i) s[pad(k0 + i)] = Op::lane(v[i], l);
    __syncthreads();
    store_tile<kThreads, kItems>(out, base, n, full && aligned16(out), s);
  }
}

}  // namespace lookback
