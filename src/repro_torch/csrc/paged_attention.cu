// One-token GQA decode attention over the page-major KV cache, for Hopper.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_fwd
// (_decode_kernel).  q (B, H, hd); kc, vc (nb, tb, B, KV, hd) — the FUSEE
// block pool, pages on the leading axis — all bf16 or all f32, contiguous;
// out (B, H, hd) in q's dtype.  Positions >= valid_len are masked; scores
// are scaled by hd^-0.5; the softmax runs online in f32.
//
// Cache position p = page * tb + offset, so the pool is (nb * tb) rows of
// B * KV * hd values and row p of (b, kv head) sits at
// ((p * B + b) * KV + kvh) * hd.
//
// Design: one CTA of 256 threads per (kv head, batch row) covers the G =
// H / KV query heads of the group together, so each K and V row is read
// from device memory once per group (the TPU kernel's grid reads it once
// per query head).  The CTA walks the valid positions in chunks of 256:
// each thread dots one K row (16-byte loads) with the G query heads held in
// shared memory; one warp per head turns the chunk's scores into
// probabilities against the running max; then each thread accumulates its
// (head, dim) outputs over the chunk's V rows, reading rows coalesced
// across threads.  Only positions < valid_len are read.
//
// What bounds it on the H100: device-memory bytes (q, the valid K and V
// rows, the output); at decode batch sizes B * KV CTAs leave most SMs idle,
// so this first version is latency-bound well above that byte bound.  A
// split over pages (flash-decode) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // also the positions per chunk
constexpr int kMaxG = 8;         // query heads per kv head

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// eight consecutive values at a 16-byte aligned address (two 16-byte loads
// for f32, one for bf16)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, T* __restrict__ o, int B,
                    int H, int KV, int valid_len, float scale) {
  const int G = H / KV;
  extern __shared__ float smem[];
  float* Qs = smem;                      // G x HD
  float* Ss = Qs + G * HD;               // G x kThreads scores / probs
  float* Os = Ss + G * kThreads;         // G x HD accumulators
  float* Ms = Os + G * HD;               // G running max
  float* Ls = Ms + G;                    // G running sum
  float* As = Ls + G;                    // G rescale of this chunk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const size_t head0 = ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int e = tid; e < G * HD; e += kThreads) {
    Qs[e] = to_f(q[head0 + e]);
    Os[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = -INFINITY;
    Ls[g] = 0.f;
  }
  const size_t pitch = (size_t)B * KV * HD;      // between positions
  const size_t base = ((size_t)b * KV + kvh) * HD;
  __syncthreads();

  for (int c0 = 0; c0 < valid_len; c0 += kThreads) {
    const int pos = c0 + tid;
    if (pos < valid_len) {
      const T* kr = kc + base + (size_t)pos * pitch;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float kv[8];
        load8(kr + d0, kv);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              s[g] = fmaf(Qs[g * HD + d0 + j], kv[j], s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) Ss[g * kThreads + tid] = s[g] * scale;
    } else {
      for (int g = 0; g < G; ++g) Ss[g * kThreads + tid] = -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      float* sg = Ss + g * kThreads;
      float mx = -INFINITY;
      for (int t = lane; t < kThreads; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      // position c0 < valid_len is in the chunk, so m_new is finite
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < kThreads; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
        As[g] = alpha;
      }
    }
    __syncthreads();

    const int n = min(kThreads, valid_len - c0);
    for (int e = tid; e < G * HD; e += kThreads) {
      const int g = e / HD, d = e % HD;
      const float* pg = Ss + g * kThreads;
      const T* vr = vc + base + (size_t)c0 * pitch + d;
      float a = Os[e] * As[g];
#pragma unroll 8
      for (int t = 0; t < n; ++t)
        a = fmaf(pg[t], to_f(vr[(size_t)t * pitch]), a);
      Os[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * HD; e += kThreads)
    o[head0 + e] = from_f<T>(Os[e] / fmaxf(Ls[e / HD], 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, void* o, int B,
           int H, int KV, int valid_len, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * (2 * G * HD + G * kThreads + 3 * G);
  const dim3 grid(KV, B);
  paged_decode_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (T*)o, B, H, KV, valid_len,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* kc, const void* vc, void* o,
             int B, int H, int KV, int vl, float sc, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, kc, vc, o, B, H, KV, vl, sc, s);
    case 128: return launch<T, 128>(q, kc, vc, o, B, H, KV, vl, sc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd), kc/vc (nb, tb, B, KV, hd), out (B, H, hd): contiguous,
// 16-byte aligned, all bf16 (is_bf16 = 1) or all f32.  hd in {16, 128}
// (the head dims of the port's configs); H / KV <= 8; 1 <= valid_len <=
// nb * tb; scale = hd^-0.5.  Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* kc,
                                      const void* vc, void* out, int B, int H,
                                      int KV, int hd, int valid_len,
                                      float scale, int is_bf16,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (H % KV != 0 || H / KV > kMaxG || valid_len < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, kc, vc, out, B, H, KV, valid_len,
                                   scale, s);
  return dispatch<float>(hd, q, kc, vc, out, B, H, KV, valid_len, scale, s);
}
