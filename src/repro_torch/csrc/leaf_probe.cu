// Batched ordered-keydir leaf probe (the "locate" phase of SCAN/RANGE and of
// the keydir half of INSERT) for Hopper.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/leaf_probe/kernel.py::leaf_probe_fwd (_probe_kernel)
// with the same function: for each start key, count(lows <= start) - 1
// under the UNSIGNED 64-bit order, for lows sorted ascending (duplicates
// allowed: the last of a run of equal lows wins); -1 when every low exceeds
// the start (or there are no lows).  The TPU kernel splits 64-bit words into
// hi/lo uint32 lanes and compares the whole (BLOCK, M) table on the VPU;
// here the words stay native 64-bit (the int64 bit patterns are read as
// unsigned long long, so keys >= 2^63 order above 2^63 - 1).
//
// What bounds it on the H100: latency, not bandwidth.  Almost every call
// locates ONE start (a client's _locate) against at most a few thousand
// fences (<= 35 000 by the keydir's size, <= 280 KB, resident in L2), and a
// locate wave has at most a few thousand starts, so the time is the chain of
// dependent loads.  An upper-bound binary search per thread takes
// ceil(log2 M) of them (12 at 3 312 fences).  Here one warp per start runs a
// 32-ary search: each step the 32 lanes load 32 evenly spaced lows of the
// remaining range at once, compare them unsigned, and __ballot_sync +
// __popc narrow the range to one of 32 segments; the last step loads the
// <= 32 remaining lows in one coalesced 256-byte load.  ceil(log32 M)
// dependent loads: 3 at 3 312 fences, 4 at 35 000.  A second body for large
// waves (every 32nd low staged in shared memory as splitters) was slower at
// every wave size the keydir makes and was not kept (PERF.md, Findings).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;        // warps (starts) per CTA

// starts == nullptr: the one start is start0, passed by value
__global__ void leaf_probe_kernel(
    const unsigned long long* __restrict__ starts, unsigned long long start0,
    const unsigned long long* __restrict__ lows, int64_t n, int64_t m,
    int32_t* __restrict__ out) {
  const int64_t i = blockIdx.x * (int64_t)kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;                    // warp-uniform
  const int lane = threadIdx.x & 31;
  const unsigned long long s = starts != nullptr ? starts[i] : start0;
  // invariant: count(lows <= s) lies in [lo, lo + len]; lows[lo .. lo+len)
  // are the ones not yet compared
  int64_t lo = 0, len = m;
  while (len > 32) {
    const int64_t step = (len + 31) >> 5;
    const int64_t idx = lo + (lane + 1) * step - 1;   // last of segment lane
    const bool le = idx < lo + len && __ldg(lows + idx) <= s;
    const int k = __popc(__ballot_sync(kFull, le));  // segments wholly <= s
    lo += k * step;
    const int64_t rest = len - k * step;
    len = rest < step - 1 ? rest : step - 1;
  }
  const bool le = lane < len && __ldg(lows + lo + lane) <= s;
  const int k = __popc(__ballot_sync(kFull, le));
  if (lane == 0) out[i] = (int32_t)(lo + k - 1);
}

}  // namespace

// starts: (n,) int64 bit patterns of uint64 keys, in device memory or
// (starts_on_host) in pinned host memory; lows: (m,) the same, sorted
// ascending as uint64 (m may be 0); out: (n,) int32.  One start in host
// memory (a locate's) is read here, when the call is made, and passed to
// the kernel by value, which spares the kernel a read across the bus
// before its first load.  Returns cudaGetLastError().
extern "C" int leaf_probe_launch(const void* starts, int starts_on_host,
                                 const void* lows, long long n, long long m,
                                 void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto* st = (const unsigned long long*)starts;
  unsigned long long start0 = 0;
  if (starts_on_host && n == 1) {
    start0 = st[0];
    st = nullptr;
  }
  const long long warps = n < kWarpsPerBlock ? n : kWarpsPerBlock;
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  leaf_probe_kernel<<<(unsigned)blocks, (unsigned)(warps * 32), 0,
                      (cudaStream_t)stream>>>(
      st, start0, (const unsigned long long*)lows, n, m, (int32_t*)out);
  return (int)cudaGetLastError();
}
