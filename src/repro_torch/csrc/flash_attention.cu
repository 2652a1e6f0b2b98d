// Forward GQA attention (prefill) for Hopper: online softmax in f32.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
// (_fwd_kernel).  q (B, H, Sq, hd); k, v (B, KV, Skv, hd), all bf16 or all
// f32, contiguous; out (B, H, Sq, hd) in q's dtype.  Query head h reads KV
// head h / (H / KV); KV is never repeated in memory.  Scores are scaled by
// hd^-0.5 after the dot, as in flash_attention_ref.
//
// Causal masking follows flash_attention_ref (bottom-right aligned): query
// row i sees key j iff j <= i + (Skv - Sq).  Masked scores are -1e30, as in
// the reference, so a row with no visible key averages all keys exactly as
// the reference's softmax does; keys past Skv (the ragged last tile) take
// no weight at all.  The ragged last q and kv tiles are masked, so any Sq
// and Skv work (the TPU kernel asserts tile-multiple lengths).  K/V tiles
// wholly past the last visible key of a q tile are skipped.
//
// Two kernels, one per input type, both with 64-row q tiles and 64-row
// K/V tiles staged in shared memory:
//
// * bf16 (the serving path): tensor cores through mma.sync m16n8k16 (bf16
//   in, f32 accumulate).  4 warps per CTA, each owning 16 query rows: S =
//   Q K^T lands in registers in the C layout, the online softmax runs on
//   it (row max and sum over the 4 lanes of a quad), and P, rounded to
//   bf16, feeds P V directly as the A operand (the C layout of two 8-key
//   tiles is the A layout of one 16-key step).  Row pitch hd+8 keeps the
//   fragment loads conflict-free.
// * f32: the CUDA cores, 256 threads as a 16x16 grid owning score rows
//   ty + 16i and columns tx + 16j (i, j < 4); f32 tensor-core math (TF32)
//   would lose the f32 tolerance.
//
// What bounds it on the H100: at prefill lengths the FLOPs (4·B·H·hd per
// visible (q, k) pair).  mma.sync reaches only part of Hopper's tensor
// rate (wgmma and TMA-fed pipelines are later work), and the tiles are
// loaded synchronously, without overlap.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // k/v rows per tile
constexpr float kMasked = -1e30f;

typedef __nv_bfloat16 bf16;

// The last key index (exclusive) any row of the q tile at q0 can see.
__device__ __forceinline__ int kv_limit(int q0, int Sq, int Skv,
                                        int causal) {
  const int off = Skv - Sq;              // bottom-right causal offset
  if (!causal || q0 + off < 0) return Skv;  // a row sees nothing: all keys
  const int last_row = min(q0 + kBQ, Sq) - 1;
  return min(Skv, last_row + off + 1);
}

// Scaled score of (row, col), masked as in flash_attention_ref.
__device__ __forceinline__ float masked_score(float dot, float scale,
                                              int row, int col, int Sq,
                                              int Skv, int causal) {
  if (col >= Skv) return -INFINITY;      // not a key
  if (causal && col > row + (Skv - Sq)) return kMasked;
  return dot * scale;
}

// ------------------------------------------------ bf16: mma.sync tiles
constexpr int kWarps = 4;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + 64) of a (rows, HD) bf16 matrix into shared memory with
// row pitch HD + 8; rows past nrows are zero
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int nrows) {
  constexpr int kVec = HD / 8;           // 16-byte vectors per row
  for (int e = threadIdx.x; e < 64 * kVec; e += kWarps * 32) {
    const int r = e / kVec, c = (e % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = val;
  }
}

template <int HD>
constexpr size_t smem_bf16() {
  return sizeof(bf16) * 3 * 64 * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int H, int KV, int Sq, int Skv, int causal,
                      float scale) {
  constexpr int LD = HD + 8;             // shared row pitch (elements)
  constexpr int KS = HD / 16;            // k-steps of Q K^T
  constexpr int NT = HD / 8;             // 8-wide output tiles of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + 64 * LD;
  bf16* Vs = Ks + 64 * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma groupID, thread-in-group
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const bf16* qp = q + ((size_t)b * H + h) * Sq * HD;
  const bf16* kp = k + ((size_t)b * KV + kvh) * Skv * HD;
  const bf16* vp = v + ((size_t)b * KV + kvh) * Skv * HD;
  bf16* op = o + ((size_t)b * H + h) * Sq * HD;

  load_tile<HD>(Qs, qp, q0, Sq);
  __syncthreads();
  const int r_lo = warp * 16 + g;        // this lane's rows: r_lo, r_lo + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* a = Qs + r_lo * LD + ks * 16 + t * 2;
    qf[ks][0] = ld32(a);
    qf[ks][1] = ld32(a + 8 * LD);
    qf[ks][2] = ld32(a + 8);
    qf[ks][3] = ld32(a + 8 * LD + 8);
  }
  const int row[2] = {q0 + r_lo, q0 + r_lo + 8};

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int kv_end = kv_limit(q0, Sq, Skv, causal);
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                     // the last tile is consumed
    load_tile<HD>(Ks, kp, k0, Skv);
    load_tile<HD>(Vs, vp, k0, Skv);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* kb = Ks + (n * 8 + g) * LD + ks * 16 + t * 2;
        const uint32_t bfr[2] = {ld32(kb), ld32(kb + 8)};
        mma_bf16(s[n], qf[ks], bfr);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = masked_score(s[n][e], scale, row[e >> 1],
                               k0 + n * 8 + t * 2 + (e & 1), Sq, Skv,
                               causal);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // col k0 < Skv is in every tile, so the new max is finite
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* vb = Vs + (kk * 16 + t * 2) * LD + n * 8 + g;
        const uint32_t bfr[2] = {pack_bf16(vb[0], vb[LD]),
                                 pack_bf16(vb[8 * LD], vb[9 * LD])};
        mma_bf16(acc[n], pa, bfr);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(op + (size_t)row[i] * HD + n * 8 + t * 2) =
          pack_f32(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// ------------------------------------------------ f32: CUDA-core tiles
constexpr int kThreads = 256;

template <int HD>
constexpr size_t smem_f32() {
  return sizeof(float) * (2 * kBQ * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int H, int KV, int Sq, int Skv, int causal,
                     float scale) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // kBQ x LD
  float* Ks = Qs + kBQ * LD;             // kBK x LD
  float* Vs = Ks + kBK * LD;             // kBK x HD
  float* Ps = Vs + kBK * HD;             // kBQ x (kBK + 1)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const float* qp = q + ((size_t)b * H + h) * Sq * HD;
  const float* kp = k + ((size_t)b * KV + kvh) * Skv * HD;
  const float* vp = v + ((size_t)b * KV + kvh) * Skv * HD;
  float* op = o + ((size_t)b * H + h) * Sq * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    Qs[r * LD + d] = (q0 + r < Sq) ? qp[(size_t)(q0 + r) * HD + d] : 0.f;
  }
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = kv_limit(q0, Sq, Skv, causal);
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                     // Q stored / last tile consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < Skv;
      const size_t gi = (size_t)(k0 + r) * HD + d;
      Ks[r * LD + d] = in ? kp[gi] : 0.f;
      Vs[r * HD + d] = in ? vp[gi] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], scale, row, k0 + tx + 16 * j, Sq,
                               Skv, causal);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      // col k0 < Skv is in every tile, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + jj];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vs[jj * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      op[(size_t)row * HD + tx + 16 * c] = acc[i][c] * inv;
  }
}

// ------------------------------------------------------------ launching
struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, KV, Sq, Skv, causal;
  float scale;
  cudaStream_t stream;
};

template <int HD>
int launch_bf16(const Args& a) {
  const size_t smem = smem_bf16<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_bf16_kernel<HD><<<grid, kWarps * 32, smem, a.stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o, a.H,
      a.KV, a.Sq, a.Skv, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const Args& a) {
  const size_t smem = smem_f32<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_f32_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      a.H, a.KV, a.Sq, a.Skv, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const Args& a, int is_bf16) {
  return is_bf16 ? launch_bf16<HD>(a) : launch_f32<HD>(a);
}

}  // namespace

// q (B, H, Sq, hd), k/v (B, KV, Skv, hd), out (B, H, Sq, hd): contiguous,
// 16-byte aligned, all bf16 (is_bf16 = 1) or all f32.  hd in {16, 128}
// (the head dims of the port's configs); H % KV == 0; Sq >= 1, Skv >= 1; scale = hd^-0.5.  Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int KV, int Sq, int Skv, int hd,
                                      int causal, float scale, int is_bf16,
                                      void* stream) {
  const Args a{q, k, v, out, B, H, KV, Sq, Skv, causal, scale,
               (cudaStream_t)stream};
  switch (hd) {
    case 16: return launch<16>(a, is_bf16);
    case 128: return launch<128>(a, is_bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}
