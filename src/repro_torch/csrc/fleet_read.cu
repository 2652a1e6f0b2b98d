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
// What bounds it on the H100: memory bytes (each gathered word read once and
// written once, plus 16 B of coordinates per verb) in principle; at a tick's
// few thousand verbs and ~10^5 words (<= 1 MB) the launch itself.  The TPU
// kernel needed one uniform length per call and hi/lo uint32 planes; here
// words are native 64-bit and one launch covers the whole ragged sweep: one
// warp serves one verb and its lanes stride over the verb's words, so
// neighbouring lanes read neighbouring addresses.  Lengths are ragged
// (1-word slot reads beside 128-word objects), so a 1-word verb leaves 31
// lanes idle; a load-balanced body (fixed chunks of output words per CTA,
// each word finding its verb by a search) measured slower on the card and
// was not kept (PERF.md, Findings).
//
// Two entry points share the body: fleet_read_launch takes separate base
// and start arrays (the public wrapper), fleet_read_tick the pool's per-tick
// upload buffer with element offsets and writes at an offset of the pool's
// staging buffer.
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

int launch(const int64_t* slab, const int64_t* base, const int64_t* start,
           long long nverbs, long long total, int64_t* out,
           cudaStream_t stream) {
  if (nverbs > 0 && total > 0) {
    const long long blocks = (nverbs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    fleet_read_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        slab, base, start, nverbs, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// slab: flat int64 words; base: (nverbs,) int64; start: (nverbs + 1,) int64
// CSR offsets; out: (total = start[nverbs],) int64.  Launches nothing when
// total is 0.  Returns cudaGetLastError().
extern "C" int fleet_read_launch(const void* slab, const void* base,
                                 const void* start, long long nverbs,
                                 long long total, void* out, void* stream) {
  return launch((const int64_t*)slab, (const int64_t*)base,
                (const int64_t*)start, nverbs, total, (int64_t*)out,
                (cudaStream_t)stream);
}

// The fused tick's entry: base and start are the int64 elements at
// base_off and start_off of the tick's upload buffer buf, and the words
// land at element out_off of out.
extern "C" int fleet_read_tick(const void* slab, const void* buf,
                               long long base_off, long long start_off,
                               long long nverbs, long long total, void* out,
                               long long out_off, void* stream) {
  const int64_t* b = (const int64_t*)buf;
  return launch((const int64_t*)slab, b + base_off, b + start_off, nverbs,
                total, (int64_t*)out + out_off, (cudaStream_t)stream);
}
