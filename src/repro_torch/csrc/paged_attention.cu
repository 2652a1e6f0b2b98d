// One-token GQA decode attention over the page-major KV cache, for Hopper:
// split over cache positions (flash-decode), then a combine.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_fwd
// (_decode_kernel).  q (B, H, hd); kc, vc (nb, tb, B, KV, hd) — the FUSEE
// block pool, pages on the leading axis — all bf16 or all f32, contiguous;
// out (B, H, hd) in q's dtype.  Positions >= valid_len are masked and never
// read; scores are scaled by hd^-0.5; the softmax runs online in f32.
//
// Cache position p = page * tb + offset, so the pool is (nb * tb) rows of
// B * KV * hd values and row p of (b, kv head) sits at
// ((p * B + b) * KV + kvh) * hd: one 16-byte-aligned run of hd values, rows
// B * KV * hd values apart.
//
// What bounds it on the H100: device-memory bytes.  Each call reads the
// valid K and V rows once (19.1 MB at the serve shape: 0.0057 ms at
// 3.35 TB/s) and does 2 FMAs per byte, far below the ridge point.  The
// time goes to latency unless enough rows are in flight on every SM.
//
// Design:
// * Grid (splits, KV, B).  The wrapper cuts [0, valid_len) into splits of
//   `chunk` positions (none starts at or past valid_len), so a decode batch
//   of B * KV groups still fills the card: at the serve shape 19 splits x
//   32 groups = 608 CTAs of 4 warps, all resident at once.
// * Every warp streams its own tiles of 8 positions (tiles w, w + 4, ... of
//   the split) into a private ring of shared-memory stages with 16-byte
//   `cp.async.cg` copies, so the whole split is in flight before the first
//   score is computed and no __syncthreads runs in the loop.  Positions
//   past the split's end are zero-filled, never read.
// * bf16 (the serving path): each warp's tile is two tensor-core products
//   (mma.sync) with the G query heads as the rows of A: S = Q K^T, then
//   O += P V with P rounded to bf16 in the registers that hold it and V
//   through ldmatrix.trans; the softmax runs on exp2 with hd^-0.5 * log2(e)
//   folded into one multiply.  Each K and V row is read once for all G
//   heads of its group.  (On the CUDA cores the same arithmetic is bound by
//   shared-memory reads and shuffles, not by the bytes.)
// * f32: the CUDA cores, four lanes per position each dotting a quarter of
//   the K row (16-byte shared reads, rows padded by 16 bytes against bank
//   conflicts) with the G heads held in shared memory, and each lane owning
//   hd/32 output dims of all G heads for P.V (f32 tensor-core math would
//   lose the f32 tolerance).
// * Partials: the four warps' online-softmax states (m, l, o[G][hd]) merge
//   in shared memory, and each CTA writes one (m, l, o) in f32 to scratch
//   from the wrapper.  A second kernel, launched by the same call, rescales
//   and sums the splits of each query head, one thread per output dim; it
//   is launched as a programmatic dependent (griddepcontrol.wait before its
//   first read), so its launch overlaps the split kernel's tail.  (A thread
//   block cluster per (b, kv head) that combines in distributed shared
//   memory, with at most 16 splits, measured slower.)
// * Device-held length (paged_attention_launch_dev): the same kernels read
//   valid_len from a device int at run time, so a CUDA graph can replay the
//   call at every decode step.  The grid is sized for all nb * tb
//   positions; a split CTA whose start is at or past valid_len returns at
//   once, and the combine sums only the splits below it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;           // positions per warp tile
constexpr int kStages = 2;         // tiles in flight per warp
// MG, a template parameter of the split kernels, is the most query heads
// per kv head an instance takes: 8 (llama3-8b and every config with
// G <= 8 keep that instance and its registers) or 16 (G 9..16:
// mistral-large-123b's 12)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD, int MG>
struct Shape {
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kChunks = kRowBytes / 16;     // 16-byte chunks a row
  static constexpr int kElems = 16 / (int)sizeof(T);  // values a chunk
  static constexpr int kPitch = kRowBytes + 16;       // padded shared row
  static constexpr int kTileBytes = 2 * kTile * kPitch;     // K then V rows
  static constexpr int kRingBytes = kWarps * kStages * kTileBytes;
  static constexpr int kDims = HD >= 32 ? HD / 32 : 1;  // P.V dims a lane
  // the warps' partial states, written over the rings once they are done
  static constexpr int kMergeBytes =
      (int)sizeof(float) * kWarps * MG * (2 + HD);
  static constexpr int kTailBytes =
      kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive floats from shared memory (one 16-byte load for N = 4)
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// 16 bytes global -> shared, bypassing L1; ok == false zero-fills the
// destination and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The positions to attend: the host's valid_len, or with a device-held
// length vlen, *vlen clamped to valid_len (then the pages' nb * tb)
__device__ __forceinline__ int run_len(const int* vlen, int valid_len) {
  return vlen ? min(*vlen, valid_len) : valid_len;
}

// One warp's share of split blockIdx.x of (b, kv head) = (blockIdx.z,
// blockIdx.y): positions [p0, p1), cut into tiles of 8 of which the warp
// takes w, w + kWarps, ...  fetch(i) streams the warp's i-th tile into stage
// i % kStages of its ring (K rows then V rows, padded) with 16-byte
// cp.async, one commit group per tile, empty past the last; positions past
// p1 are zero-filled, never read.
template <typename T, int HD, int MG>
struct WarpTiles {
  using S = Shape<T, HD, MG>;
  const T *kg, *vg;             // row 0 of this (b, kv head) in K and V
  size_t pitch;                 // values between positions
  int p0, p1, warp, lane, count;
  unsigned char* ring;

  __device__ WarpTiles(const T* kc, const T* vc, unsigned char* rings, int B,
                       int KV, int valid_len, int chunk) {
    const size_t head = ((size_t)blockIdx.z * KV + blockIdx.y) * HD;
    kg = kc + head;
    vg = vc + head;
    pitch = (size_t)B * KV * HD;
    p0 = blockIdx.x * chunk;
    p1 = min(p0 + chunk, valid_len);
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    const int ntiles = (p1 - p0 + kTile - 1) / kTile;
    count = warp < ntiles ? (ntiles - warp + kWarps - 1) / kWarps : 0;
    ring = rings + warp * kStages * S::kTileBytes;
  }
  __device__ int first(int i) const {        // the i-th tile's position 0
    return p0 + (warp + i * kWarps) * kTile;
  }
  __device__ unsigned char* stage(int i) const {
    return ring + (i % kStages) * S::kTileBytes;
  }
  __device__ void fetch(int i) const {
    if (i < count) {
      const int t0 = first(i);
      unsigned char* st = stage(i);
      for (int e = lane; e < kTile * S::kChunks; e += 32) {
        const int r = e / S::kChunks, c = e % S::kChunks;
        const bool ok = t0 + r < p1;
        const size_t off =
            (size_t)(ok ? t0 + r : p0) * pitch + c * S::kElems;
        cp_async16(st + r * S::kPitch + c * 16, kg + off, ok);
        cp_async16(st + (kTile + r) * S::kPitch + c * 16, vg + off, ok);
      }
    }
    cp_async_commit();
  }
};

// The four warps' online-softmax states, in shared memory as wm, wl
// [warp][MG] and wo [warp][MG][HD], merged into the split's partial:
// (m, l) to part_ml[slot * G + g] and o to part_o[(slot * G + g) * HD + d].
template <int HD, int MG>
__device__ __forceinline__ void write_partial(
    const float* wm, const float* wl, const float* wo,
    float* __restrict__ part_o, float2* __restrict__ part_ml, size_t slot,
    int G) {
  for (int e = threadIdx.x; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * MG + g]);
    const float mref = M == -INFINITY ? 0.f : M;
    float L = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2f(wm[w * MG + g] - mref);
      L = fmaf(a, wl[w * MG + g], L);
      acc = fmaf(a, wo[(w * MG + g) * HD + d], acc);
    }
    part_o[slot * G * HD + e] = acc;
    if (d == 0) part_ml[slot * G + g] = make_float2(M, L);
  }
}

// Split `blockIdx.x` of (b, kv head) = (blockIdx.z, blockIdx.y): positions
// [split * chunk, min(split * chunk + chunk, valid_len)), on the CUDA cores
// (the f32 path).  Writes the split's (m, l) in log2 units to part_ml and
// its unnormalised o to part_o, both laid out [B][KV][splits][G](...).
template <int HD, int MG>
__global__ void __launch_bounds__(kThreads)
paged_split_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ kc,
                       const float* __restrict__ vc,
                       float* __restrict__ part_o,
                       float2* __restrict__ part_ml, int B, int H, int KV,
                       int valid_len, int chunk, float qscale,
                       const int* __restrict__ vlen) {
  using S = Shape<float, HD, MG>;
  valid_len = run_len(vlen, valid_len);
  if ((int)blockIdx.x * chunk >= valid_len) return;   // past the length
  const int G = H / KV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);        // G x HD, log2 units
  unsigned char* tail = smem + sizeof(float) * MG * HD;
  const WarpTiles<float, HD, MG> tiles(kc, vc, tail, B, KV, valid_len, chunk);
#pragma unroll
  for (int i = 0; i < kStages; ++i) tiles.fetch(i);

  const float* qg = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int e = tid; e < G * HD; e += kThreads) qs[e] = qg[e] * qscale;
  __syncthreads();

  float m[MG], l[MG], o[MG][S::kDims];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < S::kDims; ++d) o[g][d] = 0.f;
  }
  const int t = lane >> 2, quarter = lane & 3;       // score lane's role
  const bool has_dims = lane * S::kDims < HD;        // P.V lane's role

  for (int i = 0; i < tiles.count; ++i) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* st = tiles.stage(i);
    const int pos = tiles.first(i) + t;

    float s[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) s[g] = 0.f;
    const float* kr = reinterpret_cast<const float*>(st + t * S::kPitch);
#pragma unroll 4
    for (int c = quarter; c < S::kChunks; c += 4) {
      float kv[S::kElems];
      load_vals<S::kElems>(kr + c * S::kElems, kv);
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const float* qq = qs + g * HD + c * S::kElems;
#pragma unroll
          for (int j = 0; j < S::kElems; j += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qq + j);
            s[g] = fmaf(q4.x, kv[j], s[g]);
            s[g] = fmaf(q4.y, kv[j + 1], s[g]);
            s[g] = fmaf(q4.z, kv[j + 2], s[g]);
            s[g] = fmaf(q4.w, kv[j + 3], s[g]);
          }
        }
      }
    }

    // online softmax over the tile's 8 positions (lanes 4t..4t+3 share
    // position t), in log2 units
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
        float x = s[g];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (pos >= tiles.p1) x = -INFINITY;
        float mx = x;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[g], mx);
        // a warp may have seen no valid position yet: keep exp2 finite
        const float mref = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[g] - mref);
        const float p = exp2f(x - mref);
        float sum = p;
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
#pragma unroll
        for (int d = 0; d < S::kDims; ++d) o[g][d] *= alpha;
        s[g] = p;
      }
    }

    const float* vr =
        reinterpret_cast<const float*>(st + kTile * S::kPitch) +
        lane * S::kDims;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      float pv[MG];
#pragma unroll
      for (int g = 0; g < MG; ++g)
        pv[g] = g < G ? __shfl_sync(0xffffffffu, s[g], r * 4) : 0.f;
      if (has_dims) {
        float v[S::kDims];
        load_vals<S::kDims>(vr + r * (S::kPitch / 4), v);
#pragma unroll
        for (int g = 0; g < MG; ++g)
          if (g < G) {
#pragma unroll
            for (int d = 0; d < S::kDims; ++d)
              o[g][d] = fmaf(pv[g], v[d], o[g][d]);
          }
      }
    }
    __syncwarp();                        // the stage is read: refill it
    tiles.fetch(i + kStages);
  }

  // merge the four warps' states over the rings (every copy has landed:
  // the last groups committed are empty)
  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(tail);        // [warp][MG]
  float* wl = wm + kWarps * MG;                      // [warp][MG]
  float* wo = wl + kWarps * MG;                      // [warp][MG][HD]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      wm[warp * MG + g] = m[g];
      wl[warp * MG + g] = l[g];
    }
  }
  if (has_dims) {
#pragma unroll
    for (int g = 0; g < MG; ++g)
      if (g < G) {
#pragma unroll
        for (int d = 0; d < S::kDims; ++d)
          wo[(warp * MG + g) * HD + lane * S::kDims + d] = o[g][d];
      }
  }
  __syncthreads();
  write_partial<HD, MG>(wm, wl, wo, part_o, part_ml,
                        ((size_t)b * KV + kvh) * gridDim.x + blockIdx.x, G);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0..1] += A (16 x 16, rows 8..15 zero) . B (16 x 8), bf16 in, f32 out;
// the accumulator rows 8..15 are dropped
__device__ __forceinline__ void mma_16816(float (&d)[2], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  float x2, x3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(x2), "=f"(x3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(d[0]),
        "f"(d[1]), "f"(0.f), "f"(0.f));
}
// d[0..1] += A (16 x 8, rows 8..15 zero) . B (8 x 8)
__device__ __forceinline__ void mma_1688(float (&d)[2], uint32_t a0,
                                         uint32_t b0) {
  float x2, x3;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(x2), "=f"(x3)
      : "r"(a0), "r"(0u), "r"(b0), "f"(d[0]), "f"(d[1]), "f"(0.f),
        "f"(0.f));
}
// N (2 or 4) 8x8 bf16 matrices from shared memory, transposed: the B
// fragments of N m16n8k8 steps whose k runs down the rows
template <int N>
__device__ __forceinline__ void ldmatrix_trans(uint32_t (&r)[N],
                                               uint32_t addr) {
  if constexpr (N == 4)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(addr));
}

// The A . B products of a warp's tile with R = MG / 8 query heads a lane:
// R = 1 fills rows g of A (rows 8..15 zero, their accumulators dropped),
// R = 2 rows g and g + 8.  S: d[2r + e] += (row g + 8r of A, 16 k) . B;
// a[2r] holds row g + 8r's k 2t, 2t + 1 and a[2r + 1] its k 2t + 8, 2t + 9.
template <int R>
__device__ __forceinline__ void mma_s(float (&d)[2 * R],
                                      const uint32_t (&a)[2 * R],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (R == 1) {
    mma_16816(d, a[0], a[1], b0, b1);
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[2]), "r"(a[1]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}
// P V: d[2r + e] += (row g + 8r of P, 8 k) . B, pa[r] row g + 8r's P
template <int R>
__device__ __forceinline__ void mma_pv(float (&d)[2 * R],
                                       const uint32_t (&pa)[R],
                                       uint32_t b0) {
  if constexpr (R == 1) {
    mma_1688(d, pa[0], b0);
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(pa[0]), "r"(pa[1]), "r"(b0));
  }
}

// The bf16 split on the tensor cores: the same splits, tiles, ring and
// partials as paged_split_f32_kernel, but each warp's tile of 8 positions is
// two mma.sync products with the G query heads as the rows of A (rows past
// G are zero): S (heads x 8 positions) = Q K^T in HD / 16 m16n8k16 steps
// (K rows read as 32-bit pairs, conflict-free in the padded rows), and
// O += P V in HD / 8 m16n8k8 steps, P's accumulator layout being exactly
// the A fragment of the second product and V's fragments coming from
// ldmatrix.trans.  Lane (g, t) = (lane / 4, lane % 4) owns head g's scores
// at positions 2t, 2t + 1 and its outputs at dims 8n + 2t, 8n + 2t + 1, and
// with MG = 16 head g + 8's as well (A's rows 8..15, empty at MG = 8).
// (MG = 8: at 140 registers a thread, three CTAs fit an SM and the serve
// shape's 608 do not all run at once; the launch bound asks for four.
// MG = 16 holds twice the scores and outputs and asks for two.)
template <int HD, int MG>
__global__ void __launch_bounds__(kThreads, MG == 8 ? 4 : 2)
paged_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ kc,
                       const __nv_bfloat16* __restrict__ vc,
                       float* __restrict__ part_o,
                       float2* __restrict__ part_ml, int B, int H, int KV,
                       int valid_len, int chunk, float qscale,
                       const int* __restrict__ vlen) {
  using S = Shape<__nv_bfloat16, HD, MG>;
  valid_len = run_len(vlen, valid_len);
  if ((int)blockIdx.x * chunk >= valid_len) return;   // past the length
  constexpr int R = MG / 8;                   // query heads a lane owns
  constexpr int NT = HD / 8;                  // 8-dim output tiles
  constexpr int LD = NT >= 4 ? 4 : NT;        // of them per ldmatrix
  const int G = H / KV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  extern __shared__ __align__(16) unsigned char tail[];   // no Q in smem
  const WarpTiles<__nv_bfloat16, HD, MG> tiles(kc, vc, tail, B, KV,
                                               valid_len, chunk);
#pragma unroll
  for (int i = 0; i < kStages; ++i) tiles.fetch(i);

  // the rows of Q of heads g (and g + 8) as A fragments, straight from
  // device memory
  uint32_t qa[HD / 16][2 * R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = g + 8 * r;
    const uint32_t* qg = reinterpret_cast<const uint32_t*>(
        q + ((size_t)b * H + (size_t)kvh * G + h) * HD);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][2 * r] = h < G ? qg[8 * kk + t] : 0u;
      qa[kk][2 * r + 1] = h < G ? qg[8 * kk + 4 + t] : 0u;
    }
  }
  float m[R], l[R], o[NT][2 * R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2 * R; ++e) o[n][e] = 0.f;

  for (int i = 0; i < tiles.count; ++i) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* st = tiles.stage(i);
    const int pos = tiles.first(i) + 2 * t;

    float sc[2 * R];
#pragma unroll
    for (int e = 0; e < 2 * R; ++e) sc[e] = 0.f;
    const uint32_t* kr =
        reinterpret_cast<const uint32_t*>(st + g * S::kPitch);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_s<R>(sc, qa[kk], kr[8 * kk + t], kr[8 * kk + 4 + t]);
    float alpha[R];
    uint32_t pa[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s0 = pos < tiles.p1 ? sc[2 * r] * qscale : -INFINITY;
      const float s1 =
          pos + 1 < tiles.p1 ? sc[2 * r + 1] * qscale : -INFINITY;
      float mx = fmaxf(s0, s1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // a warp may have seen no valid position yet: keep exp2 finite
      const float mref = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - mref);
      const float e0 = exp2f(s0 - mref), e1 = exp2f(s1 - mref);
      l[r] = l[r] * alpha[r] + e0 + e1;      // this lane's share of l
      m[r] = m_new;
      pa[r] = pack_bf16(e0, e1);
    }
    const uint32_t vt =
        (uint32_t)__cvta_generic_to_shared(st + kTile * S::kPitch) +
        (lane & 7) * S::kPitch + ((lane >> 3) % LD) * 16;
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += LD) {
      uint32_t bv[LD];
      ldmatrix_trans<LD>(bv, vt + n0 * 16);
#pragma unroll
      for (int j = 0; j < LD; ++j) {
#pragma unroll
        for (int e = 0; e < 2 * R; ++e) o[n0 + j][e] *= alpha[e / 2];
        mma_pv<R>(o[n0 + j], pa, bv[j]);
      }
    }
    __syncwarp();                        // the stage is read: refill it
    tiles.fetch(i + kStages);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(tail);        // [warp][MG]
  float* wl = wm + kWarps * MG;                      // [warp][MG]
  float* wo = wl + kWarps * MG;                      // [warp][MG][HD]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = g + 8 * r;
    if (h < G) {
      if (t == 0) {
        wm[warp * MG + h] = m[r];
        wl[warp * MG + h] = l[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        wo[(warp * MG + h) * HD + 8 * n + 2 * t] = o[n][2 * r];
        wo[(warp * MG + h) * HD + 8 * n + 2 * t + 1] = o[n][2 * r + 1];
      }
    }
  }
  __syncthreads();
  write_partial<HD, MG>(wm, wl, wo, part_o, part_ml,
                        ((size_t)b * KV + kvh) * gridDim.x + blockIdx.x, G);
}

// out[b, kvh * G + g, :] from the `splits` partials of (b, kv head), one
// CTA per (g, kv head, b) and one thread per output dim: a single pass of
// online rescaling, unrolled so that the loads of eight splits are in
// flight at once.  With a device-held length vlen only the splits that
// start below *vlen (`chunk` positions each) are summed.
template <typename T, int HD>
__global__ void __launch_bounds__(HD >= 32 ? HD : 32)
paged_combine_kernel(const float* __restrict__ part_o,
                     const float2* __restrict__ part_ml, T* __restrict__ o,
                     int H, int KV, int splits, const int* __restrict__ vlen,
                     int chunk) {
  const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.x, d = threadIdx.x;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the partials
  if (d >= HD) return;
  const int used =
      vlen ? min((max(*vlen, 0) + chunk - 1) / chunk, splits) : splits;
  const size_t slot0 = ((size_t)b * KV + kvh) * splits;
  float M = -INFINITY, L = 0.f, acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < used; ++s) {
    const float2 ml = part_ml[(slot0 + s) * G + g];
    const float x = part_o[((slot0 + s) * G + g) * HD + d];
    // every split saw a valid position, so ml.x and m_new are finite
    const float m_new = fmaxf(M, ml.x);
    const float alpha = exp2f(M - m_new), a = exp2f(ml.x - m_new);
    L = fmaf(L, alpha, a * ml.y);
    acc = fmaf(acc, alpha, a * x);
    M = m_new;
  }
  o[((size_t)b * H + (size_t)kvh * G + g) * HD + d] =
      from_f<T>(acc / fmaxf(L, 1e-30f));
}

template <typename T, int HD, int MG>
int launch(const void* q, const void* kc, const void* vc, void* o,
           float* part_o, float2* part_ml, int B, int H, int KV,
           int valid_len, int chunk, int splits, float scale,
           const int* vlen, cudaStream_t stream) {
  using S = Shape<T, HD, MG>;
  const dim3 grid(splits, KV, B);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = S::kTailBytes;
    err = cudaFuncSetAttribute(paged_split_mma_kernel<HD, MG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    paged_split_mma_kernel<HD, MG><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)kc, (const T*)vc, part_o, part_ml, B, H, KV,
        valid_len, chunk, scale * kLog2e, vlen);
  } else {
    const size_t smem = sizeof(float) * MG * HD + S::kTailBytes;
    err = cudaFuncSetAttribute(paged_split_f32_kernel<HD, MG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    paged_split_f32_kernel<HD, MG><<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)kc, (const float*)vc, part_o, part_ml,
        B, H, KV, valid_len, chunk, scale * kLog2e, vlen);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H / KV, KV, B);
  cfg.blockDim = dim3(HD >= 32 ? HD : 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_combine_kernel<T, HD>,
                           (const float*)part_o, (const float2*)part_ml,
                           (T*)o, H, KV, splits, vlen, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the instance of (hd, G): MG = 8 for G <= 8, else 16
template <typename T, int HD>
int launch_g(const void* q, const void* kc, const void* vc, void* o,
             float* po, float2* pml, int B, int H, int KV, int vl, int chunk,
             int splits, float sc, const int* vlen, cudaStream_t s) {
  if (H / KV <= 8)
    return launch<T, HD, 8>(q, kc, vc, o, po, pml, B, H, KV, vl, chunk,
                            splits, sc, vlen, s);
  return launch<T, HD, 16>(q, kc, vc, o, po, pml, B, H, KV, vl, chunk,
                           splits, sc, vlen, s);
}

template <typename T>
int dispatch(int hd, const void* q, const void* kc, const void* vc, void* o,
             float* po, float2* pml, int B, int H, int KV, int vl, int chunk,
             int splits, float sc, const int* vlen, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_g<T, 16>(q, kc, vc, o, po, pml, B, H, KV, vl, chunk,
                             splits, sc, vlen, s);
    case 64:
      return launch_g<T, 64>(q, kc, vc, o, po, pml, B, H, KV, vl, chunk,
                             splits, sc, vlen, s);
    case 128:
      return launch_g<T, 128>(q, kc, vc, o, po, pml, B, H, KV, vl, chunk,
                              splits, sc, vlen, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, hd), kc/vc (nb, tb, B, KV, hd), out (B, H, hd): contiguous,
// 16-byte aligned, all bf16 (is_bf16 = 1) or all f32.  hd in {16, 64, 128}
// (the head dims of the port's configs); H / KV <= 16; 1 <= valid_len <=
// nb * tb; splits = ceil(valid_len / chunk); part_o holds B * KV * splits
// * H / KV * hd floats and part_ml B * KV * splits * H / KV float pairs;
// scale = hd^-0.5.  Launches the split kernel and the combine on `stream`.
// Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* kc,
                                      const void* vc, void* out,
                                      void* part_o, void* part_ml, int B,
                                      int H, int KV, int hd, int valid_len,
                                      int chunk, int splits, float scale,
                                      int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (KV < 1 || H % KV != 0 || H / KV > 16 || valid_len < 1 ||
      chunk < 1 || splits != (valid_len + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  float* po = (float*)part_o;
  float2* pml = (float2*)part_ml;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, kc, vc, out, po, pml, B, H, KV,
                                   valid_len, chunk, splits, scale, nullptr,
                                   s);
  return dispatch<float>(hd, q, kc, vc, out, po, pml, B, H, KV, valid_len,
                         chunk, splits, scale, nullptr, s);
}

// The same call with the length read on the device: valid_len points at
// one int32 on the card (positions >= *valid_len are masked; 1 <=
// *valid_len, larger values are clamped to n_pos), read when the kernels
// run, so the call can be captured once in a CUDA graph and replayed at
// every length.  n_pos = nb * tb; splits = ceil(n_pos / chunk) CTAs of each
// (b, kv head) are launched, and part_o / part_ml are sized for them.
extern "C" int paged_attention_launch_dev(const void* q, const void* kc,
                                          const void* vc, void* out,
                                          void* part_o, void* part_ml, int B,
                                          int H, int KV, int hd,
                                          const int* valid_len, int n_pos,
                                          int chunk, int splits, float scale,
                                          int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (KV < 1 || H % KV != 0 || H / KV > 16 || valid_len == nullptr ||
      n_pos < 1 || chunk < 1 || splits != (n_pos + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  float* po = (float*)part_o;
  float2* pml = (float2*)part_ml;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, kc, vc, out, po, pml, B, H, KV,
                                   n_pos, chunk, splits, scale, valid_len, s);
  return dispatch<float>(hd, q, kc, vc, out, po, pml, B, H, KV, n_pos, chunk,
                         splits, scale, valid_len, s);
}
