// Forward GQA attention (prefill) for Hopper: online softmax in f32.
//
// Replaces the JAX package's TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd
// (_fwd_kernel).  q (B, H, Sq, hd); k, v (B, KV, Skv, hd), all bf16 or all
// f32, contiguous; out (B, H, Sq, hd) in q's dtype.  Query head h reads KV
// head h / (H / KV); KV is never repeated in memory.
//
// Causal masking follows flash_attention_ref (bottom-right aligned): query
// row i sees key j iff j <= i + (Skv - Sq).  Masked scores are -1e30, as in
// the reference, so a row with no visible key averages all keys exactly as
// the reference's softmax does; keys past Skv (the ragged last tile) take
// no weight at all.  Any Sq >= 1 and Skv >= 1 work (the TPU kernel asserts
// tile-multiple lengths).  K/V tiles wholly past the last visible key of a
// q tile are skipped.
//
// What bounds it on the H100: at prefill lengths the FLOPs, 4·B·H·hd per
// visible (q, k) pair (4.35e10 at the serve shape: 0.044 ms at 989 TFLOP/s
// bf16).  Only wgmma reaches that rate, and only if the tensor cores never
// wait for a tile, for the softmax or for shared memory: S = Q·Kᵀ re-reads
// Q from shared memory for every wgmma, so with 96-key tiles the operand
// reads and the TMA writes ask about 115 B of shared memory a clock of the
// 128 it delivers, and the exponentials run on the MUFU unit at a quarter
// of the FMA rate.
//
// Two kernels, one per input type:
//
// * bf16 (the serving path): persistent, warp-specialised CTAs, one per SM,
//   each of three warpgroups walking the (128 query rows, head, batch row)
//   tiles heaviest first (the causal tiles with the most keys).
//   - Warpgroup 2 produces: after `setmaxnreg` hands its registers to the
//     consumers, one thread loads each tile's Q into one of two buffers and
//     its 96-row K and V tiles into a three-stage ring with TMA (4-D tensor
//     maps over (hd, S, heads, batch) with the tensors' own strides, so the
//     transposed views the model passes need no copy, and rows past Sq or
//     Skv arrive as zeros and never come from the next head), each stage
//     and buffer guarded by
//     a full and an empty mbarrier.  It runs ahead into the next tile while
//     the consumers finish the current one.
//   - Warpgroups 0 and 1 own 64 query rows each.  S = Q·Kᵀ is one wgmma
//     m64n96k16 per 16 columns of hd, both operands K-major in shared memory
//     (128-byte swizzle at hd 64 and 128, 32-byte at hd 16, as TMA wrote
//     them; hd 128 is two 64-column atoms, hd 64 one).  The
//     online softmax runs on the accumulator registers with ex2 and
//     log2(e)·hd^-0.5 folded into the exponent's FMA, masking element by
//     element only in tiles that cross the diagonal or the ragged edge, and
//     rescaling O only when a row max moved.  P, rounded to bf16 in
//     registers, is the A operand of O += P·V (wgmma m64n{hd}k16, V read
//     MN-major through the descriptor's transpose bit); O stays in f32
//     registers.
//   - Each step starts S of tile j and P·V of tile j - 1 as two wgmma groups
//     and starts tile j's softmax as soon as S is in; named barriers hand the
//     tensor cores from one consumer warpgroup to the other after each
//     block, so one's softmax overlaps the other's wgmma (ping-pong).
//   - The output goes through shared memory (the tile's Q buffer, swizzled)
//     and one TMA store per warpgroup: scattered 4-byte stores cost as much
//     as all the loads.
//   Registers: 112- and 128-key tiles, or Q held in registers as the A
//   operand of S, made ptxas serialise every wgmma (warning C7512,
//   "insufficient register resources") and ran slower, also with one
//   producer warp and 224 registers a thread; 96-key tiles with Q in
//   shared memory do not, and run faster than 64 or 80.
// * f32: the CUDA cores, 256 threads as a 16x16 grid owning score rows
//   ty + 16i and columns tx + 16j (i, j < 4) of a 64x64 tile; f32 tensor-
//   core math (TF32) would lose the f32 tolerance.
//
// Tensor maps are encoded on the host for every call with
// cuTensorMapEncodeTiled from libcuda (the library links -lcuda) and passed as
// __grid_constant__ parameters.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// The last key index (exclusive) any row of the q tile [q0, q0 + rows)
// can see.
__device__ __forceinline__ int kv_limit(int q0, int rows, int Sq, int Skv,
                                        int causal) {
  const int off = Skv - Sq;              // bottom-right causal offset
  if (!causal || q0 + off < 0) return Skv;  // a row sees nothing: all keys
  const int last_row = min(q0 + rows, Sq) - 1;
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

// ------------------------------------------- bf16: wgmma fed by a TMA ring
namespace wg {

constexpr int kWGs = 2;          // consumer warpgroups, 64 q rows each
constexpr int kBQ = 64 * kWGs;   // q rows per CTA
constexpr int kStages = 3;       // K/V tiles in the ring
constexpr int kOrderBar = 1;     // named barriers 1..kWGs order the consumers
constexpr int kStoreBar = kOrderBar + kWGs;   // then one per warpgroup
constexpr int kConsumers = 128 * kWGs;
constexpr int kThreads = kConsumers + 128;   // the last warpgroup produces
// setmaxnreg: the producer keeps 24 registers a thread and the consumers
// take the rest of the 64K register file
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "register file");
constexpr uint32_t kSpinLimit = 1u << 28;   // a lost barrier traps

template <int HD>
struct Cfg {
  static constexpr int kBK = 96;                        // k/v rows a tile
  static constexpr int kAtomCols = HD >= 64 ? 64 : HD;  // columns an atom
  static constexpr int kAtoms = HD / kAtomCols;         // along hd
  static constexpr int kSw = 2 * kAtomCols;   // swizzle span: 128 or 32 B
  static constexpr uint64_t kLayout = HD >= 64 ? 1 : 3;  // B128 or B32
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;       // one K or V tile
  static constexpr int kBarBytes = 8 * (2 * kStages + 4);
  // + 1024 to align the tiles to the 128-byte swizzle's 1024-byte period
  static constexpr int kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kTileBytes + kBarBytes;
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == kSpinLimit) __trap();
  }
}

// TMA: the box at (column, row, head, batch) of `map` into shared memory
// at `dst`, completing its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// TMA: shared memory at `src` to the box at (column, row, head, batch) of
// `map` (rows past the map's extent are not written)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are pending (groups complete
// in order)
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving register reads or writes across the
// asynchronous wgmma that owns the registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define D8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D64 D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
#define R48                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47}"
#define R64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 96, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 96, smem,
// K-major: 96 rows of 16)
__device__ __forceinline__ void mma_s(float (&d)[48], uint64_t da,
                                      uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " R48
      ", %48, %49, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x HD, f32) += A (64 x 16, bf16 registers) . B (16 x HD, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void mma_o(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#define R32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
__device__ __forceinline__ void mma_o(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef R32
__device__ __forceinline__ void mma_o(float (&d)[8], const uint32_t (&a)[4],
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef R64
#undef R48
#undef D64
#undef D8

// named barrier `id` over one warpgroup (128 threads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// named barrier `id` between two consumer warpgroups (256 threads): one
// syncs, the other arrives
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// 2^x on the MUFU unit (the f32 exp2f adds range fix-ups around it); -inf
// gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The q tiles of all (batch, head) pairs, heaviest first: item i is q
// tile nqt - 1 - i / (B * H) of head (i % (B * H)) % H of batch row
// (i % (B * H)) / H.
struct Item {
  int q0, b, h, ntiles;
};

template <int HD>
__device__ __forceinline__ Item item_at(int i, int B, int H, int Sq, int Skv,
                                        int causal) {
  const int nqt = (Sq + kBQ - 1) / kBQ;
  const int bh = i % (B * H);
  Item it;
  it.q0 = (nqt - 1 - i / (B * H)) * kBQ;
  it.b = bh / H;
  it.h = bh % H;
  it.ntiles = (kv_limit(it.q0, kBQ, Sq, Skv, causal) + Cfg<HD>::kBK - 1) /
              Cfg<HD>::kBK;
  return it;
}

// Persistent: CTA c takes items c, c + gridDim.x, ...
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, int B, int H,
                       int KV, int Sq, int Skv, int causal,
                       float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  // two Q buffers (item n uses n % 2; each warpgroup stages its output
  // tile in its own 64 rows of it), then the K/V ring, then barriers
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + 2 * C::kQBytes;    // stage s: K, then V
  const uint32_t bars = skv + 2 * kStages * C::kTileBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  auto qfull = [&](int n) { return bars + 8u * (2 * kStages + (n & 1)); };
  auto qempty = [&](int n) { return bars + 8u * (2 * kStages + 2 + (n & 1)); };
  const int items = (Sq + kBQ - 1) / kBQ * B * H;
  const int group = H / KV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    for (int n = 0; n < 2; ++n) {
      mbar_init(qfull(n), 1);
      mbar_init(qempty(n), kWGs);     // each warpgroup's stored output
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs)
                 : "memory");
    if (threadIdx.x == kConsumers) {
      int tile = 0;                              // over all items
      for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
        const Item w = item_at<HD>(i, B, H, Sq, Skv, causal);
        const int kvh = w.h / group;
        const uint32_t qs = sq + (n & 1) * C::kQBytes;
        mbar_wait(qempty(n), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(qfull(n), C::kQBytes);
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load(qs + a * kBQ * C::kSw, &tq, qfull(n), a * C::kAtomCols,
                   w.q0, w.h, w.b);
        for (int j = 0; j < w.ntiles; ++j, ++tile) {
          const int s = tile % kStages;
          mbar_wait(empty(s), ((tile / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * C::kTileBytes);
          const uint32_t ks = skv + 2 * s * C::kTileBytes;
          const uint32_t vs = ks + C::kTileBytes;
          for (int a = 0; a < C::kAtoms; ++a) {
            tma_load(ks + a * C::kBK * C::kSw, &tk, full(s),
                     a * C::kAtomCols, j * C::kBK, kvh, w.b);
            tma_load(vs + a * C::kBK * C::kSw, &tv, full(s),
                     a * C::kAtomCols, j * C::kBK, kvh, w.b);
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs)
                 : "memory");
    const int cw = threadIdx.x / 128;           // consumer warpgroup
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;       // accumulator fragment
    const int off = Skv - Sq;
    // descriptors: 8-row groups 8 * kSw bytes apart; V's hd atoms one
    // tile of rows apart
    const uint32_t sbo = 8 * C::kSw;

    constexpr int NS = C::kBK / 2;              // S accumulators a thread
    float acc[HD / 2], s[NS], m[2], l[2];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    uint32_t pa[C::kBK / 16][4];                // P of the last tile
    // the current item: its first q row, this thread's rows row0 and
    // row0 + 8, and this warpgroup's 64 rows of Q in shared memory
    int q0 = 0, row0 = 0;
    uint32_t q_wg = 0;

    // O += P V over the keys of the tile in stage st, 16 rows a step
    auto gemm_pv = [&](int st) {
      const uint32_t vs = skv + (2 * st + 1) * C::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < C::kBK / 16; ++kk)
        mma_o(acc, pa[kk],
              desc(vs + kk * 16 * C::kSw, C::kBK * C::kSw, sbo, C::kLayout));
    };
    // S = Q K^T for the tile in stage st, 16 columns (32 bytes) of hd a step
    auto gemm_s = [&](int st) {
      const uint32_t ks = skv + 2 * st * C::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int a = kk * 16 / C::kAtomCols;
        const uint32_t col = (kk * 16 % C::kAtomCols) * 2;
        mma_s(s, desc(q_wg + a * kBQ * C::kSw + col, 16, sbo, C::kLayout),
              desc(ks + a * C::kBK * C::kSw + col, 16, sbo, C::kLayout),
              kk > 0);
      }
    };
    // online softmax of tile it's scores, rows row0, row0 + 8, in log2
    // units: updates m and l, leaves P in s and the rescale of O in alpha.
    // Element 4j + e sits at row row0 + 8 (e / 2), col k0 + 8j + 2t + e % 2.
    float alpha[2];
    auto softmax = [&](int it) {
      const int k0 = it * C::kBK;
      float mx[2] = {-INFINITY, -INFINITY}, mc[2];
      if (k0 + C::kBK > Skv ||
          (causal && k0 + C::kBK - 1 > q0 + 64 * cw + off)) {
        // a tile across the diagonal or the ragged edge: mask, then scale
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            if (col >= Skv)
              s[4 * j + e] = -INFINITY;
            else if (causal && col > row + off)
              s[4 * j + e] = kMasked;
          }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] *= scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
        mc[0] = mc[1] = 1.f;
      } else {
        // every score is a key's: the scale rides on the exponent's FFMA
#pragma unroll
        for (int i = 0; i < NS; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        mx[0] *= scale_log2;
        mx[1] *= scale_log2;
        mc[0] = mc[1] = scale_log2;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // col k0 < Skv is in every tile, so the new max is finite
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];                   // this thread's share of l
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = ex2(fmaf(s[i], mc[(i >> 1) & 1], -m[(i >> 1) & 1]));
        l[(i >> 1) & 1] += s[i];
      }
    };
    // O *= alpha (once O holds every earlier tile's P V), and P into the
    // A fragments of the next P V
    auto finish = [&]() {
      // once the row maxima settle, alpha is 1 and O needs no rescale
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      // P in bf16 as the A fragments of 16-key steps: the accumulator
      // blocks 2kk, 2kk + 1 are the A layout of one k16 step
#pragma unroll
      for (int kk = 0; kk < C::kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // Each step starts one block of wgmma (P V of the last tile, then
    // Q K^T of this one) and runs this tile's softmax while the other
    // consumer warpgroups' blocks occupy the tensor cores: named barrier
    // kOrderBar + cw is this warpgroup's turn, which the warpgroup before
    // it in the ring hands over after issuing its block.  Peeled, so that
    // no wgmma sits on a branch.
    const int next = kOrderBar + (cw + 1) % kWGs;
    if (cw == kWGs - 1) bar_arrive(kOrderBar);  // warpgroup 0 goes first
    int tile = 0;                               // over all items
    for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
      const Item w = item_at<HD>(i, B, H, Sq, Skv, causal);
      q0 = w.q0;
      row0 = q0 + 64 * cw + 16 * warp + g;
      q_wg = sq + (n & 1) * C::kQBytes + 64 * cw * C::kSw;
#pragma unroll
      for (int k = 0; k < HD / 2; ++k) acc[k] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      mbar_wait(qfull(n), (n >> 1) & 1);
      mbar_wait(full(tile % kStages), (tile / kStages) & 1);
      bar_sync(kOrderBar + cw);
      wgmma_fence();
      gemm_s(tile % kStages);
      wgmma_commit();
      bar_arrive(next);
      wgmma_wait();
      fence_regs(s);
      softmax(0);
      finish();
      for (int j = 1; j < w.ntiles; ++j) {
        // S of tile j and P V of tile j - 1 in two groups: tile j's softmax
        // runs once S is in, while P V still occupies the tensor cores
        const int st = (tile + j) % kStages, pst = (tile + j - 1) % kStages;
        mbar_wait(full(st), ((tile + j) / kStages) & 1);
        bar_sync(kOrderBar + cw);
        fence_regs(acc);
        wgmma_fence();
        gemm_s(st);
        wgmma_commit();
        gemm_pv(pst);
        wgmma_commit();
        bar_arrive(next);
        wgmma_wait<1>();
        fence_regs(s);
        softmax(j);
        wgmma_wait();
        fence_regs(acc);
        mbar_arrive(empty(pst));                // K and V of tile j - 1
        finish();
      }
      const int last = (tile + w.ntiles - 1) % kStages;
      bar_sync(kOrderBar + cw);
      fence_regs(acc);
      wgmma_fence();
      gemm_pv(last);
      wgmma_commit();
      bar_arrive(next);
      wgmma_wait();
      fence_regs(acc);
      mbar_arrive(empty(last));
      tile += w.ntiles;

      // O / l in bf16 into this warpgroup's 64 rows of the Q buffer (no
      // wgmma reads them any more), swizzled as the tensor map lays them
      // out, then one TMA store; the buffer is released once it is read
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        const int row = 16 * warp + g + 8 * r;   // in the warpgroup's rows
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int a = j * 8 / C::kAtomCols, chunk = j % (C::kAtomCols / 8);
          const int sw = chunk ^ ((row * C::kSw >> 7) & (C::kSw / 16 - 1));
          const uint32_t dst =
              q_wg + a * kBQ * C::kSw + row * C::kSw + sw * 16 + t * 4;
          const uint32_t v = pack_bf16(acc[4 * j + 2 * r] * inv,
                                       acc[4 * j + 2 * r + 1] * inv);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v)
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(kStoreBar + cw);
      if (threadIdx.x % 128 == 0) {
        if (q0 + 64 * cw < Sq) {               // else every row is past Sq
          for (int a = 0; a < C::kAtoms; ++a)
            tma_store(&to, q_wg + a * kBQ * C::kSw, a * C::kAtomCols,
                      q0 + 64 * cw, w.h, w.b);
          tma_store_commit_and_wait_read();
        }
        mbar_arrive(qempty(n));
      }
    }
    if (cw == 0) bar_sync(kOrderBar);     // the last warpgroup's last turn
  }
}

// 4-D map over (hd, rows, heads, batch) of a bf16 tensor whose rows, heads
// and batch rows lie `st` = {row, head, batch} elements apart (multiples of
// 8) and whose hd values are contiguous; boxes of (one swizzle atom of
// columns, box_rows, 1, 1)
template <int HD>
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int heads,
                int batch, const long long* st, int box_rows) {
  using C = Cfg<HD>;
  cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)rows, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)st[0] * 2, (cuuint64_t)st[1] * 2,
                           (cuuint64_t)st[2] * 2};
  cuuint32_t box[4] = {(cuuint32_t)C::kAtomCols, (cuuint32_t)box_rows, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             HD >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg

// ------------------------------------------------ f32: CUDA-core tiles
namespace f32 {

constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // k/v rows per tile
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

  const int kv_end = kv_limit(q0, kBQ, Sq, Skv, causal);
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

}  // namespace f32

// ------------------------------------------------------------ launching
struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, KV, Sq, Skv, causal;
  float scale;
  const long long* st;    // {row, head, batch} strides of q, k, v, out
  cudaStream_t stream;
};

template <int HD>
int launch_bf16(const Args& a) {
  using C = wg::Cfg<HD>;
  CUtensorMap tq, tk, tv, to;
  if (!wg::encode_map<HD>(&tq, a.q, a.Sq, a.H, a.B, a.st, wg::kBQ) ||
      !wg::encode_map<HD>(&tk, a.k, a.Skv, a.KV, a.B, a.st + 3, C::kBK) ||
      !wg::encode_map<HD>(&tv, a.v, a.Skv, a.KV, a.B, a.st + 6, C::kBK) ||
      !wg::encode_map<HD>(&to, a.o, a.Sq, a.H, a.B, a.st + 9, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wg::flash_fwd_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  // one persistent CTA per SM (at most one fits), never more than items
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long items =
      (long long)((a.Sq + wg::kBQ - 1) / wg::kBQ) * a.B * a.H;
  const int grid = (int)(items < sms ? items : sms);
  wg::flash_fwd_wgmma_kernel<HD><<<grid, wg::kThreads, C::kSmem, a.stream>>>(
      tq, tk, tv, to, a.B, a.H, a.KV, a.Sq, a.Skv, a.causal,
      a.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const Args& a) {
  const size_t smem = f32::smem_f32<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      f32::flash_fwd_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + f32::kBQ - 1) / f32::kBQ, a.H, a.B);
  f32::flash_fwd_f32_kernel<HD><<<grid, f32::kThreads, smem, a.stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o,
      a.H, a.KV, a.Sq, a.Skv, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const Args& a, int is_bf16) {
  return is_bf16 ? launch_bf16<HD>(a) : launch_f32<HD>(a);
}

}  // namespace

// q (B, H, Sq, hd), k/v (B, KV, Skv, hd), out (B, H, Sq, hd), all bf16
// (is_bf16 = 1) or all f32, 16-byte aligned.  bf16: each tensor's hd values
// contiguous and its {row, head, batch} strides, in elements and multiples
// of 8, in st[3i .. 3i + 2] for q, k, v, out (i = 0..3); f32: contiguous
// (st unread).  hd in {16, 64, 128} (the head dims of the port's configs);
// H % KV == 0; Sq >= 1, Skv >= 1; scale = hd^-0.5.  Returns a cudaError_t
// (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int KV, int Sq, int Skv, int hd,
                                      int causal, float scale, int is_bf16,
                                      const long long* st, void* stream) {
  const Args a{q, k, v, out, B, H, KV, Sq, Skv, causal, scale, st,
               (cudaStream_t)stream};
  switch (hd) {
    case 16: return launch<16>(a, is_bf16);
    case 64: return launch<64>(a, is_bf16);
    case 128: return launch<128>(a, is_bf16);
    default: return (int)cudaErrorInvalidValue;
  }
}
