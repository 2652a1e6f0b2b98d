// Batched ordered-keydir leaf probe (the "locate" phase of SCAN/RANGE and of
// the keydir half of INSERT) for Hopper.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/leaf_probe/kernel.py::leaf_probe_fwd (_probe_kernel)
// with the same function: for each start key, count(lows <= start) - 1
// under the UNSIGNED 64-bit order, for lows sorted ascending (duplicates
// allowed); -1 when every low exceeds the start (or there are no lows).
//
// Design: one thread per start key runs an upper-bound binary search over
// the sorted lows (the first index whose low is > start, minus one), which
// equals count(lows <= start) - 1 on sorted input, duplicates included —
// the last of a run of equal lows wins, as searchsorted(side="right") - 1
// does.  The TPU kernel splits 64-bit words into hi/lo uint32 lanes and
// compares the whole (BLOCK, M) table on the VPU; here the words stay
// native 64-bit (the int64 bit patterns are read as unsigned long long, so
// keys >= 2^63 order above 2^63 - 1) and each thread touches log2(M) lows
// through the read-only path.  At the keydir's <= 35 000 fences (<= 280 KB)
// the lows stay resident in L2 across a wave.  What bounds it on the H100:
// memory bytes (8 B per start and per low read, 4 B out per start) and, at
// a wave's few thousand starts, launch latency.  No shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void leaf_probe_kernel(const unsigned long long* __restrict__ starts,
                                  const unsigned long long* __restrict__ lows,
                                  int64_t n, int64_t m,
                                  int32_t* __restrict__ out) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long s = starts[i];
  int64_t lo = 0, hi = m;               // upper bound: first low > s
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(lows + mid) <= s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = (int32_t)(lo - 1);
}

}  // namespace

// starts: (n,) int64 bit patterns of uint64 keys; lows: (m,) the same,
// sorted ascending as uint64 (m may be 0); out: (n,) int32.  Returns
// cudaGetLastError().
extern "C" int leaf_probe_launch(const void* starts, const void* lows,
                                 long long n, long long m, void* out,
                                 void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    leaf_probe_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        (const unsigned long long*)starts, (const unsigned long long*)lows,
        (int64_t)n, (int64_t)m, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
