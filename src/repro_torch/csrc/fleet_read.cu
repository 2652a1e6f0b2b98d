// Fused fleet-tick READ sweep for Hopper: one launch gathers every read
// verb of a tick from the flat region slab.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/fleet_tick/kernel.py::fleet_read_fwd (_read_sweep_kernel)
// and is the device half of DMPool._fused_read_sweep: verb v copies the
// contiguous words slab[base[v] .. base[v] + len_v) into
// out[start[v] .. start[v + 1]), where base is the global word address
// (cell * region_words + offset) and start the CSR offsets of the lengths.
//
// Design: lengths are ragged (1-word slot reads beside 128-word objects), so
// one warp serves one verb and its lanes stride over the verb's words —
// neighbouring lanes read neighbouring addresses.  The TPU kernel needed one
// uniform length per call and hi/lo uint32 planes; here words are native
// 64-bit and one launch covers the whole ragged sweep.  What bounds it on the
// H100: memory bytes (each gathered word read once and written once, plus
// 16 B of coordinates per verb) and, at a tick's few thousand verbs, launch
// latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void fleet_read_kernel(const int64_t* __restrict__ slab,
                                  const int64_t* __restrict__ base,
                                  const int64_t* __restrict__ start,
                                  int64_t nverbs,
                                  int64_t* __restrict__ out) {
  int64_t v = blockIdx.x * (int64_t)kWarpsPerBlock + (threadIdx.x >> 5);
  if (v >= nverbs) return;
  const int lane = threadIdx.x & 31;
  const int64_t s = start[v];
  const int64_t e = start[v + 1];
  const int64_t shift = base[v] - s;  // slab address - out index
  for (int64_t j = s + lane; j < e; j += 32) out[j] = slab[shift + j];
}

}  // namespace

// slab: flat int64 words; base: (nverbs,) int64; start: (nverbs + 1,) int64
// CSR offsets; out: (start[nverbs],) int64.  Returns cudaGetLastError().
extern "C" int fleet_read_launch(const void* slab, const void* base,
                                 const void* start, long long nverbs,
                                 void* out, void* stream) {
  if (nverbs > 0) {
    const long long blocks = (nverbs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    fleet_read_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
        (const int64_t*)slab, (const int64_t*)base, (const int64_t*)start,
        (int64_t)nverbs, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}
