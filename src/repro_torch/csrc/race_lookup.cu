// Batched RACE hash-index probe (FUSEE SEARCH phase 1) for Hopper.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/race_lookup/kernel.py::race_lookup_fwd (_lookup_kernel)
// with the same semantics: xorshift-multiply hash32 with seeds 1 and 2 gives
// buckets b1 and b2 (b2 == b1 -> (b1 + 1) % nb), the fingerprint is the top
// 8 bits of the seed-7 hash (0 -> 1); row b1 then row b2 of the (nb, spb)
// table of fp:8|ptr:24 slots is scanned and the first fingerprint match
// yields its 24-bit pointer, else 0.  The answer is written either as
// ptr (int32) and found (bool), or packed into one int32 word a key,
// found << 24 | ptr (exact: ptr < 2^24).
//
// What bounds it on the H100: latency, not bandwidth.  A probe wave holds
// at most a few thousand keys (clients x depth) against a table of a few
// MB that sits in L2, so the byte bound is tens of nanoseconds and the time
// is the chain of dependent loads plus the launch.  The TPU kernel gathers
// rows with a one-hot matmul on the MXU because the TPU lacks a sublane
// gather.  Here a group of g = min(32, next power of two >= 2*spb) lanes
// probes one key: every lane hashes the key itself (a broadcast load, no
// shuffle) and lane l loads slot l of the concatenated pair of rows
// (b1's slots, then b2's; for 2*spb > 32 also slots l + 32, l + 64, ...),
// all through the read-only path and all issued before any compare, so a
// key costs one L2 round trip however many slots it scans.  __ballot_sync
// over the group's matches and __ffs pick the first matching slot in order;
// __shfl_sync brings its word to the group's leader, which writes the
// answer.  At spb = 8 a warp probes two keys and 4 096 keys make 256 CTAs,
// spread over all 132 SMs.  A one-thread-per-key body with all 2*spb loads
// unrolled ahead of its compares was measured against it and removed
// (PERF.md, Findings).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMask24 = (1u << 24) - 1u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;            // threads per CTA at full size

__device__ __forceinline__ uint32_t hash32(uint32_t x, uint32_t seed) {
  x += 0x9E3779B9u * (seed + 1u);
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ void write_answer(int64_t i, bool f, uint32_t v,
                                             int32_t* ptr, bool* found,
                                             int32_t* packed) {
  const uint32_t p = f ? (v & kMask24) : 0u;
  if (packed != nullptr) {
    packed[i] = (int32_t)(((uint32_t)f << 24) | p);
  } else {
    ptr[i] = (int32_t)p;
    found[i] = f;
  }
}

// 2^log2g lanes per key; each lane loads C slots a round, all of them
// before any compare; one round covers C * g slots (one round whenever
// 2 * spb <= 4 * 32).  Every lane of every warp runs to the end: the
// ballots and shuffles take the full warp, dead lanes (past n) included.
template <int C>
__global__ void __launch_bounds__(kThreads)
race_lookup_kernel(const int64_t* __restrict__ keys,
                   const uint32_t* __restrict__ table, int64_t n,
                   uint32_t nb, int spb, int log2g, int32_t* __restrict__ ptr,
                   bool* __restrict__ found, int32_t* __restrict__ packed) {
  const int g = 1 << log2g;
  const int64_t i = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> log2g;
  const int lane = threadIdx.x & 31;
  const int l = lane & (g - 1);                       // lane in the group
  const unsigned gmask =
      g == 32 ? kFull : ((1u << g) - 1u) << (lane & ~(g - 1));
  const bool live = i < n;
  uint32_t b1 = 0, b2 = 0, fp = 0;
  if (live) {
    const uint32_t k = (uint32_t)__ldg((const long long*)keys + i);
    b1 = hash32(k, 1u) % nb;
    b2 = hash32(k, 2u) % nb;
    if (b2 == b1) b2 = (b1 + 1u) % nb;
    fp = hash32(k, 7u) >> 24;
    if (fp == 0u) fp = 1u;
  }
  const int slots = 2 * spb;
  const uint32_t* r1 = table + (size_t)b1 * spb;
  const uint32_t* r2 = table + (size_t)b2 * spb;
  bool hit = false;
  uint32_t word = 0;
  for (int base = 0; base < slots; base += C * g) {   // warp-uniform trips
    uint32_t v[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int s = base + j * g + l;
      v[j] = 0u;
      if (live && s < slots) v[j] = __ldg(s < spb ? r1 + s : r2 + (s - spb));
    }
    bool now = false;                                 // group-uniform
    int src = lane, pick = 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int s = base + j * g + l;
      const bool m = live && s < slots && (v[j] >> 24) == fp;
      const unsigned bal = __ballot_sync(kFull, m) & gmask;
      if (!hit && !now && bal != 0u) {
        now = true;
        src = __ffs(bal) - 1;
        pick = j;
      }
    }
    uint32_t mine = v[0];
#pragma unroll
    for (int j = 1; j < C; ++j)
      if (j == pick) mine = v[j];
    const uint32_t got = __shfl_sync(kFull, mine, src);
    if (now) {
      hit = true;
      word = got;
    }
  }
  if (live && l == 0) write_answer(i, hit, word, ptr, found, packed);
}

int launch(const void* keys, const void* table, long long n, int nb, int spb,
           void* ptr, void* found, void* packed, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int slots = 2 * spb;
  int log2g = 0;
  while ((1 << log2g) < slots && log2g < 5) ++log2g;
  const int g = 1 << log2g;
  const int per_lane = (slots + g - 1) / g;           // slots a lane loads
  const long long threads_needed = n << log2g;
  const int threads = threads_needed < kThreads
                          ? (int)((threads_needed + 31) / 32 * 32)
                          : kThreads;
  const long long blocks = (threads_needed + threads - 1) / threads;
  const auto* k = (const int64_t*)keys;
  const auto* t = (const uint32_t*)table;
  auto* p = (int32_t*)ptr;
  auto* f = (bool*)found;
  auto* w = (int32_t*)packed;
  if (per_lane <= 1)
    race_lookup_kernel<1><<<(unsigned)blocks, threads, 0, stream>>>(
        k, t, n, (uint32_t)nb, spb, log2g, p, f, w);
  else if (per_lane <= 2)
    race_lookup_kernel<2><<<(unsigned)blocks, threads, 0, stream>>>(
        k, t, n, (uint32_t)nb, spb, log2g, p, f, w);
  else
    race_lookup_kernel<4><<<(unsigned)blocks, threads, 0, stream>>>(
        k, t, n, (uint32_t)nb, spb, log2g, p, f, w);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: (n,) int64 holding uint32 values; table: (nb, spb) int32 slots;
// either packed: (n,) int32 out (found << 24 | ptr), or (packed null)
// ptr: (n,) int32 and found: (n,) bool out.  Returns cudaGetLastError().
extern "C" int race_lookup_launch(const void* keys, const void* table,
                                  long long n, int nb, int spb, void* ptr,
                                  void* found, void* packed, void* stream) {
  return launch(keys, table, n, nb, spb, ptr, found, packed,
                (cudaStream_t)stream);
}

// The probe path's whole round trip on one stream: the n keys go from
// pinned host memory h_keys to the device buffer d_keys (one asynchronous
// copy), the kernel writes the packed answers into out, pinned host memory,
// across the bus (no copy back), and the stream is synchronised.  Returns
// the first CUDA error met, else 0.
extern "C" int race_lookup_probe(const void* h_keys, void* d_keys,
                                 const void* table, long long n, int nb,
                                 int spb, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemcpyAsync(d_keys, h_keys, (size_t)n * 8,
                                          cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int rc = launch(d_keys, table, n, nb, spb, nullptr, nullptr, out, s);
  if (rc != 0) return rc;
  return (int)cudaStreamSynchronize(s);
}
