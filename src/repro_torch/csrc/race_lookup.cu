// Batched RACE hash-index probe (FUSEE SEARCH phase 1) for Hopper.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/race_lookup/kernel.py::race_lookup_fwd (_lookup_kernel)
// with the same semantics: xorshift-multiply hash32 with seeds 1 and 2 gives
// buckets b1 and b2 (b2 == b1 -> b1 + 1), the fingerprint is the top 8 bits
// of the seed-7 hash (0 -> 1); row b1 then row b2 of the (nb, spb) table of
// fp:8|ptr:24 slots is scanned and the first fingerprint match yields its
// 24-bit pointer, else 0.
//
// Design: one thread per key.  The TPU kernel gathers rows with a one-hot
// matmul on the MXU (and splits slots into f32 halves for it) because the
// TPU lacks a sublane gather; here each thread reads its two rows directly.
// What bounds it on the H100: memory bytes (8 B key + 2*spb*4 B slots in,
// 5 B out per key) and, at fleet sizes of a few thousand keys, launch
// latency.  No shared memory, no tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMask24 = (1u << 24) - 1u;

__device__ __forceinline__ uint32_t hash32(uint32_t x, uint32_t seed) {
  x += 0x9E3779B9u * (seed + 1u);
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__global__ void race_lookup_kernel(const int64_t* __restrict__ keys,
                                   const uint32_t* __restrict__ table,
                                   int64_t n, uint32_t nb, int spb,
                                   int32_t* __restrict__ ptr,
                                   bool* __restrict__ found) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t k = (uint32_t)keys[i];
  uint32_t b1 = hash32(k, 1u) % nb;
  uint32_t b2 = hash32(k, 2u) % nb;
  if (b2 == b1) b2 = (b1 + 1u) % nb;
  uint32_t fp = hash32(k, 7u) >> 24;
  if (fp == 0u) fp = 1u;
  const uint32_t* r1 = table + (int64_t)b1 * spb;
  const uint32_t* r2 = table + (int64_t)b2 * spb;
  int32_t p = 0;
  bool f = false;
  for (int s = 0; s < spb && !f; ++s) {
    uint32_t v = r1[s];
    if ((v >> 24) == fp) { p = (int32_t)(v & kMask24); f = true; }
  }
  for (int s = 0; s < spb && !f; ++s) {
    uint32_t v = r2[s];
    if ((v >> 24) == fp) { p = (int32_t)(v & kMask24); f = true; }
  }
  ptr[i] = p;
  found[i] = f;
}

}  // namespace

// keys: (n,) int64 holding uint32 values; table: (nb, spb) int32 slots;
// ptr: (n,) int32 out; found: (n,) bool out.  Returns cudaGetLastError().
extern "C" int race_lookup_launch(const void* keys, const void* table,
                                  long long n, int nb, int spb, void* ptr,
                                  void* found, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    race_lookup_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        (const int64_t*)keys, (const uint32_t*)table, (int64_t)n,
        (uint32_t)nb, spb, (int32_t*)ptr, (bool*)found);
  }
  return (int)cudaGetLastError();
}
