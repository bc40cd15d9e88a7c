/* 64-bit FNV-1a over host bytes: the store's partition checksums.
 *
 * The same function as the JAX package's native engine
 * (native/dryad_io.cpp dryad_fingerprint_seed), so either package
 * verifies the other's stores.  Chain a partition's segments by passing
 * the previous return as `seed` (start from the offset basis
 * 0xcbf29ce484222325).  Host C, built with the host compiler into
 * build/host/ at first use (ops/_build.py host_library) and loaded with
 * ctypes, which releases the interpreter lock for the call, so
 * partitions checksum in parallel on a thread pool.  Bound by the
 * multiply's latency: one byte per dependent xor-multiply.
 */
#include <stdint.h>

uint64_t dryad_fnv64(const uint8_t* buf, long long len, uint64_t seed) {
  uint64_t h = seed;
  for (long long i = 0; i < len; ++i) {
    h ^= buf[i];
    h *= 1099511628211ULL;
  }
  return h;
}
