// Flash-attention forward for NVIDIA Hopper (sm_90a): exact
// softmax(q k^T / sqrt(d)) v over whole sequences, optionally causal, without
// the [S, S] scores ever reaching device memory.
//
// Replaces the TPU kernel `_flash_kernel`, reached through `flash_attention`
// (k8s_dra_driver_tpu/compute/flashattention.py). It computes the same
// function: scores q.k accumulated in f32 and multiplied by 1/sqrt(d); with
// `causal`, key j masked for query row i when j > i; an online softmax with
// f32 running max and denominator; p rounded to V's dtype before the PV
// product (a no-op in f32); an f32 accumulator; output acc / l in q's dtype.
//
// Layout: q and k are [bh, S, d], v and out are [bh, S, dv], all contiguous,
// d and dv multiples of 16 up to 256.
//
// What bounds it: operations. Per (b, h) the kernel does 4 S^2 d multiply-adds
// counted as flops (half of them under causal) on (3 d + dv) S elements, so at
// S = 2048, d = 128 in bf16 each byte moved feeds ~1000 flops, far above the
// ~295 flops per byte at which the H100's bf16 tensor cores, not its memory,
// become the limit. Hopper reaches its dense bf16 rate only through
// warpgroup `wgmma`, so the bf16 path is built around it:
//   * 3 warpgroups per block and one block per SM at most (a persistent
//     grid), each block walking its share of the (bh, 128-row query tile)
//     list. Warpgroup 0 is the producer: one thread issues every TMA load,
//     and `setmaxnreg` hands its registers to warpgroups 1 and 2, the
//     consumers, which own 64 query rows each;
//   * TMA copies each Q tile once and K and V through a 2-stage ring, each
//     tile as 64-column (128-byte) panels in the 128-byte swizzle that
//     `wgmma` reads without bank conflicts. `full` mbarriers count the bytes
//     in; `empty` ones count the consumer warps out, separately for K (freed
//     once S is computed) and V (freed once P V is). The tensor maps are
//     rank 3 over (cols, S, bh), so a tile never reads the next head's rows:
//     TMA zero-fills rows beyond S and columns beyond d or dv;
//   * S = Q K^T by `wgmma` m64nNk16 with both operands in shared memory (both
//     are K-major: d contiguous), one instruction per 16 columns of d;
//   * the online softmax runs on the accumulator registers, whose layout is
//     `mma.sync`'s: each thread holds rows 16 warp + lane / 4 (+ 8), columns
//     8 j + 2 (lane % 4) (+ 1). Row max by two quad shuffles, the denominator
//     summed per thread and reduced once at the end, all in base 2: one FMA
//     and one ex2 per score;
//   * P, rounded to bf16 in registers (the point where the TPU kernel casts
//     p to V's dtype), is the register A operand of O += P V by `wgmma`
//     m64nDk16; V is MN-major (dv contiguous), read with the transpose bit;
//   * a consumer issues S of key tile kt together with P V of tile kt - 1
//     and runs the softmax of kt while P V is in flight; the two consumers
//     take turns to issue (named barriers), so one's softmax overlaps the
//     other's products;
//   * head dims are bucketed at compile time (64, 128, 256 by max(d, dv)):
//     176 keys per tile up to 128, 64 at 256, so O, S and P fit the
//     consumers' 240 registers; the columns beyond d or dv are TMA's zeros;
//   * under causal, key tiles beyond a query tile's last row are never
//     loaded, the mask runs only on tiles that cross the diagonal or S, and
//     the query tiles with the most keys come first, dealt to the blocks in
//     a snake so that their causal work evens out.
// What holds it back (PERF.md): at S = 2048 about a fifth of its time is a
// fixed cost per query tile; at S = 8192 it streams K and V from L2 at
// ~5 TB/s.
// The f32 path keeps a walk with scalar FMA (never TF32) on 32 x 32 tiles:
// 8 threads per query row, each with 4 keys of the score tile and dv / 8
// columns of the accumulator.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run
                   // time, so the library does not link libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxD = 256;   // head dims d and dv
constexpr int kDimStep = 16; // d and dv are multiples of it (one wgmma k-step)

// ---- bf16 path ------------------------------------------------------------

constexpr int kRowsQ = 128;          // query rows per block
constexpr int kConsumers = 2;        // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kPanelCols = 64;       // bf16 columns in one 128-byte swizzle row
constexpr int kPanelRowBytes = 128;

// Registers per thread after `setmaxnreg`: 128 x 24 + 256 x 240 = 64,512 of
// the SM's 65,536.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int DMAX>
struct Tiles {
  static constexpr int kN = DMAX <= 128 ? 176 : 64;  // keys per K/V tile
  static constexpr int kStages = 2;                   // K/V ring depth
  static constexpr int kPanels = DMAX / kPanelCols;
  static constexpr int kQPanelBytes = kRowsQ * kPanelRowBytes;
  static constexpr int kKVPanelBytes = kN * kPanelRowBytes;
  static constexpr int kQBytes = kPanels * kQPanelBytes;
  static constexpr int kKVBytes = kPanels * kKVPanelBytes;  // one K or V tile
  // Q | K stages | V stages | barriers, with room to align the base to the
  // 1024-byte swizzle atom.
  static constexpr int kBarrierOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmemBytes =
      1024 + kBarrierOffset + (2 + 4 * kStages) * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also tells the barrier to expect `bytes` from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Until the phase of parity `parity` has completed. A fresh barrier is in
// phase 0, so parity 1 (the phase before it) passes at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of `map` at (c0, c1, c2) into shared memory at `dst`, counted in
// bytes on `bar`. Elements outside the tensor arrive as zeros and count too.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---- wgmma

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes (its accumulator, its A fragment)
// across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle: start
// address, leading and stride byte offsets (all in 16-byte units), layout 1.
// K-major (Q, K): SBO = 1024, the stride between 8-row groups; LBO unused.
// MN-major (V): SBO = 1024 between 8-key groups, LBO between 64-column
// panels.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1)
                                                      << 62;
}

// d[64 x N] (+)= a * b, bf16 in, f32 accumulate:
// _ss (S, N = keys per tile: 64, 176): a (64 x 16) and b (16 x N) both
// K-major in shared memory;
// _rs (O, N = 64, 128, 256): a (64 x 16) in registers, b (16 x N) MN-major
// in shared memory.
// `acc` = 0 overwrites d. Thread t of the warpgroup holds d[i] at row
// 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (t % 4) + i % 2; a's registers are mma.sync's m16n8k16 A fragment of
// the warp's 16 rows.
#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F32(i)                                                           \
  F4(i), F4(i + 4), F4(i + 8), F4(i + 12), F4(i + 16), F4(i + 20),       \
      F4(i + 24), F4(i + 28)

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(0)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n176(float (&d)[88], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87}, "
      "%88, %89, p, 1, 1, 0, 0;\n}\n"
      : F32(0), F32(32), F4(64), F4(68), F4(72), F4(76), F4(80), F4(84)
      : "l"(a), "l"(b), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F32(0), F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F32(0), F32(32), F32(64), F32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef F32
#undef F4

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, acc);
  else wgmma_ss_n176(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b, 1);
  else wgmma_rs_n256(d, a, b, 1);
}

// Two floats rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// exp2 of x on the special-function unit; exp2(-inf) = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 pass the turn to issue wgmmas between the two
// consumer warpgroups (barrier 0 is __syncthreads).
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}

__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// Key tiles that the query tile starting at row q0 walks: under causal, none
// beyond its last row.
template <int kN>
__device__ __forceinline__ int key_tiles(int q0, int n_tiles, int causal) {
  return causal ? min(n_tiles, (q0 + kRowsQ + kN - 1) / kN)
                : n_tiles;
}

// Every tile is DMAX columns wide in shared memory. The tensor maps cover d
// (Q, K) or dv (V) columns, and TMA fills the rest of each box with zeros,
// so every loop runs to DMAX with no branch (a zero column adds nothing to
// Q K^T, and a zero V column gives an output column that is never stored).
//
// The grid is persistent: each block takes its query tiles from the list
// of (query tile, bh) ordered by the most keys first (`tile_of`), and the
// producer loads the next tile's Q and K while the consumers finish the
// last one. The K/V ring runs on across query tiles; `it` counts the key
// tiles this block has walked, which gives each one's stage and phase.
//
// Each consumer overlaps its own work and the other's: in iteration kt it
// issues S = Q K_kt^T, rescales O to tile kt - 1's max while S runs, issues
// O += P_(kt-1) V_(kt-1), and runs the softmax of tile kt while P V is in
// flight. The two consumers take turns to issue (ping-pong), so one's
// softmax runs while the tensor cores work on the other's products. The
// first key tile of a query tile has no P V to pair with, the last one's
// P V none to hide behind: both are peeled out of the loop, whose body has
// no branch around a wgmma (with the branches inside, the same kernel took
// 46% longer on an H100; PERF.md).
template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      bf16* __restrict__ out, int n_bh, int S, int dv,
                      float scale_log2, int causal) {
  using T = Tiles<DMAX>;
  constexpr int kN = T::kN;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  // The swizzle repeats every 1024 bytes; wgmma's descriptors assume tiles
  // start on that boundary.
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + T::kQBytes;                 // kStages tiles
  const uint32_t v_s = k_s + kStages * T::kKVBytes;      // kStages tiles
  const uint32_t bars = base + T::kBarrierOffset;
  const uint32_t q_full = bars, q_empty = bars + 8;
  const auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  const auto v_full = [&](int st) { return bars + 8 * (2 + kStages + st); };
  const auto k_empty = [&](int st) {
    return bars + 8 * (2 + 2 * kStages + st);
  };
  const auto v_empty = [&](int st) {
    return bars + 8 * (2 + 3 * kStages + st);
  };

  const int wg = threadIdx.x / 128;
  const int n_qt = (S + kRowsQ - 1) / kRowsQ;
  const int n_work = n_bh * n_qt;
  const int n_tiles = (S + kN - 1) / kN;
  // The block's r-th query tile: index j of the list ordered by the most
  // keys first, dealt to the blocks in a snake (0 .. G-1, then G-1 .. 0) so
  // that every block's causal work adds up to about the same.
  const int grid = gridDim.x, block = blockIdx.x;
  const auto tile_of = [&](int r) {
    return r * grid + ((r & 1) ? grid - 1 - block : block);
  };
  const auto bh_of = [&](int j) { return j % n_bh; };
  const auto q0_of = [&](int j) { return (n_qt - 1 - j / n_bh) * kRowsQ; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * kConsumers);  // lane 0 of each consumer warp
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 4 * kConsumers);
      mbar_init(v_empty(st), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer. Its registers go to the consumers; one thread issues loads.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0; tile_of(r) < n_work; ++r) {
        const int j = tile_of(r);
        const int bh = bh_of(j), q0 = q0_of(j);
        // A fresh barrier lets the first tile's Q in at once.
        mbar_wait(q_empty, (r & 1) ^ 1);
        mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p)
          tma_load(q_s + p * T::kQPanelBytes, &q_map, q_full,
                   p * kPanelCols, q0, bh);
        const int n_kt = key_tiles<kN>(q0, n_tiles, causal);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int st = it % kStages;
          // The first pass through the ring finds every stage free.
          const uint32_t free_ph = ((it / kStages) & 1) ^ 1;
          mbar_wait(k_empty(st), free_ph);
          mbar_expect_tx(k_full(st), T::kKVBytes);
#pragma unroll
          for (int p = 0; p < T::kPanels; ++p)
            tma_load(k_s + st * T::kKVBytes + p * T::kKVPanelBytes, &k_map,
                     k_full(st), p * kPanelCols, kt * kN, bh);
          mbar_wait(v_empty(st), free_ph);
          mbar_expect_tx(v_full(st), T::kKVBytes);
#pragma unroll
          for (int p = 0; p < T::kPanels; ++p)
            tma_load(v_s + st * T::kKVBytes + p * T::kKVPanelBytes, &v_map,
                     v_full(st), p * kPanelCols, kt * kN, bh);
        }
      }
    }
  } else {
    // Consumer warpgroup cw: query rows q0 + 64 cw .. q0 + 64 cw + 63 of
    // each of the block's query tiles.
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5, lane = t & 31;
    const int t4 = lane & 3;

    float o[DMAX / 2];
    float s[kN / 2];           // one tile's scores, then its p
    uint32_t pa[kN / 16][4];   // the previous tile's p in bf16

    const uint64_t q_desc = sw128_desc(q_s + 64 * cw * kPanelRowBytes, 16);
    // S = Q K^T: one wgmma per 16 columns of d; the descriptor's start
    // address moves 32 bytes along a panel row, then to the next panel.
    const auto issue_qk = [&](int st) {
      const uint64_t k_desc = sw128_desc(k_s + st * T::kKVBytes, 16);
#pragma unroll
      for (int ks = 0; ks < DMAX / kDimStep; ++ks) {
        const uint32_t qoff = (ks / 4) * T::kQPanelBytes + (ks % 4) * 32;
        const uint32_t koff = (ks / 4) * T::kKVPanelBytes + (ks % 4) * 32;
        wgmma_ss<kN>(s, q_desc + (qoff >> 4), k_desc + (koff >> 4), ks > 0);
      }
      wgmma_commit();
    };
    // O += P V, 16 keys per wgmma: the descriptor moves 16 rows of the V
    // panels (two 8-key groups of 1024 bytes).
    const auto issue_pv = [&](int st) {
      const uint64_t v_desc =
          sw128_desc(v_s + st * T::kKVBytes, T::kKVPanelBytes);
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<DMAX>(o, pa[kk], v_desc + ((kk * 2048) >> 4));
      wgmma_commit();
    };

    // The softmax of the key tile at k0 on the scores in s, in place: s
    // becomes p (f32), l takes its row sums, and corr gets the factor by
    // which O must be rescaled for the new row max.
    const auto softmax = [&](int k0, int r0, int row_a, float (&m)[2],
                             float (&l)[2], float (&corr)[2]) {
      const int row_b = row_a + 8;
      if (k0 + kN > S || (causal && k0 + kN - 1 > r0)) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int row = (i & 2) ? row_b : row_a;
          if (col >= S || (causal && col > row)) s[i] = -CUDART_INF_F;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kN / 2; i += 4) {
        mx[0] = fmaxf(mx[0], fmaxf(s[i], s[i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[i + 2], s[i + 3]));
      }
      float nbase[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // A row with no unmasked key yet keeps its exponents finite.
        nbase[r] = mx[r] == -CUDART_INF_F ? 0.f : -mx[r] * scale_log2;
        corr[r] = fast_exp2(fmaf(m[r], scale_log2, nbase[r]));
        m[r] = mx[r];
      }
      // p = exp(scale (s - max)) = exp2(s scale log2(e) - max scale log2(e)).
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        s[i] = fast_exp2(fmaf(s[i], scale_log2, nbase[(i >> 1) & 1]));
        ps[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
    };
    // p in bf16 as the A fragments of P V: k-step kk covers keys
    // 16 kk .. 16 kk + 15, which are s[8 kk .. 8 kk + 7].
    const auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    const auto rescale_o = [&](const float (&corr)[2]) {
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    };

    // Consumer 0 issues first; consumer 0 takes one more turn at the end
    // than consumer 1 passes it, so the counts on both barriers match.
    if (cw == 1) turn_pass(cw);
    int it = 0;
    for (int r = 0; tile_of(r) < n_work; ++r) {
      const int j = tile_of(r);
      const int bh = bh_of(j), q0 = q0_of(j);
      const int n_kt = key_tiles<kN>(q0, n_tiles, causal);
      const int r0 = q0 + 64 * cw;                     // the warpgroup's rows
      const int row_a = r0 + 16 * warp + (lane >> 2);  // this thread's rows
      const int row_b = row_a + 8;
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i) o[i] = 0.f;
      // Running max of the raw scores q.k of rows row_a and row_b, and this
      // thread's share of their denominators.
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
      float l[2] = {0.f, 0.f};
      float corr[2];

      // Key tile 0: S alone.
      mbar_wait(q_full, r & 1);
      turn_wait(cw);
      mbar_wait(k_full(it % kStages), (it / kStages) & 1);
      fence_regs(s);
      wgmma_fence();
      issue_qk(it % kStages);
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) {
        mbar_arrive(k_empty(it % kStages));
        if (n_kt == 1) mbar_arrive(q_empty);
      }
      softmax(0, r0, row_a, m, l, corr);
      pack_p();

      // Key tiles 1 ..: S of tile kt and P V of tile kt - 1 in flight
      // together, the softmax of kt while P V runs.
      for (int kt = 1; kt < n_kt; ++kt) {
        const int st = (it + kt) % kStages;
        const int pst = (it + kt - 1) % kStages;
        turn_wait(cw);
        mbar_wait(k_full(st), ((it + kt) / kStages) & 1);
        fence_regs(s);
        wgmma_fence();
        issue_qk(st);
        rescale_o(corr);  // to tile kt - 1's max, in the shadow of S
        mbar_wait(v_full(pst), ((it + kt - 1) / kStages) & 1);
        fence_regs(o);
        wgmma_fence();
        issue_pv(pst);
        turn_pass(cw);
        wgmma_wait<1>();
        fence_regs(s);
        if (lane == 0) {
          mbar_arrive(k_empty(st));  // S is in registers
          if (kt + 1 == n_kt) mbar_arrive(q_empty);
        }
        softmax(kt * kN, r0, row_a, m, l, corr);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);  // read by the P V in flight until here
        if (lane == 0) mbar_arrive(v_empty(pst));
        pack_p();
      }
      // The last key tile's P V.
      it += n_kt;
      const int lst = (it - 1) % kStages;
      rescale_o(corr);
      mbar_wait(v_full(lst), ((it - 1) / kStages) & 1);
      fence_regs(o);
      wgmma_fence();
      issue_pv(lst);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(v_empty(lst));

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
      }
      bf16* ob = out + static_cast<size_t>(bh) * S * dv;
#pragma unroll
      for (int c = 0; c < DMAX / 8; ++c) {
        if (c * 8 < dv) {
          const int col = c * 8 + 2 * t4;
          if (row_a < S)
            *reinterpret_cast<uint32_t*>(
                ob + static_cast<size_t>(row_a) * dv + col) =
                pack_bf16(o[4 * c] * inv[0], o[4 * c + 1] * inv[0]);
          if (row_b < S)
            *reinterpret_cast<uint32_t*>(
                ob + static_cast<size_t>(row_b) * dv + col) =
                pack_bf16(o[4 * c + 2] * inv[1], o[4 * c + 3] * inv[1]);
        }
      }
    }
    if (cw == 0) turn_wait(cw);  // consumer 1's last pass
  }
}

// ---- f32 path -------------------------------------------------------------

constexpr int kTileF = 32;       // query rows per block, keys per tile
constexpr int kThreadsF = 256;   // 8 per query row
constexpr int kRowThreads = 8;

size_t smem_bytes_f32(int d, int dv) {
  // Q and K tiles with rows padded by one float, V tile, P tile.
  return (static_cast<size_t>(kTileF) * (2 * (d + 1) + dv) +
          kTileF * (kTileF + 1)) *
         sizeof(float);
}

__global__ void __launch_bounds__(kThreadsF)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int S, int d, int dv, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = d + 1, ldp = kTileF + 1;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kTileF * ldk;
  float* v_s = k_s + kTileF * ldk;
  float* p_s = v_s + kTileF * dv;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTileF;
  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;  // query row in the tile
  const int c = tid % kRowThreads;  // keys c + 8j, columns c + 8n
  const int row = q0 + r;

  const float* qb = q + static_cast<size_t>(bh) * S * d;
  const float* kb = k + static_cast<size_t>(bh) * S * d;
  const float* vb = v + static_cast<size_t>(bh) * S * dv;

  for (int i = tid; i < kTileF * d; i += kThreadsF) {
    const int rr = i / d, cc = i - rr * d;
    q_s[rr * ldk + cc] =
        q0 + rr < S ? qb[static_cast<size_t>(q0 + rr) * d + cc] : 0.f;
  }

  const int n_tiles = (S + kTileF - 1) / kTileF;
  const int n_kt = causal ? min(n_tiles, qt + 1) : n_tiles;
  const int n_cols = dv / kRowThreads;

  float o[kMaxD / kRowThreads];
#pragma unroll
  for (int n = 0; n < kMaxD / kRowThreads; ++n) o[n] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTileF;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kTileF * d; i += kThreadsF) {
      const int rr = i / d, cc = i - rr * d;
      k_s[rr * ldk + cc] =
          k0 + rr < S ? kb[static_cast<size_t>(k0 + rr) * d + cc] : 0.f;
    }
    for (int i = tid; i < kTileF * dv; i += kThreadsF) {
      const int rr = i / dv;
      v_s[i] = k0 + rr < S ? vb[static_cast<size_t>(k0) * dv + i] : 0.f;
    }
    __syncthreads();

    float s[kTileF / kRowThreads];
#pragma unroll
    for (int j = 0; j < kTileF / kRowThreads; ++j) s[j] = 0.f;
    for (int kk = 0; kk < d; ++kk) {
      const float qv = q_s[r * ldk + kk];
#pragma unroll
      for (int j = 0; j < kTileF / kRowThreads; ++j)
        s[j] = fmaf(qv, k_s[(c + kRowThreads * j) * ldk + kk], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < kTileF / kRowThreads; ++j) {
      const int col = k0 + c + kRowThreads * j;
      s[j] = col >= S || (causal && col > row) ? -CUDART_INF_F
                                               : s[j] * scale;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 1; off < kRowThreads; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float base = mx == -CUDART_INF_F ? 0.f : mx;
    const float corr = expf(m - base);
    m = mx;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kTileF / kRowThreads; ++j) {
      const float p = expf(s[j] - base);
      ps += p;
      p_s[r * ldp + c + kRowThreads * j] = p;
    }
    l = l * corr + ps;
#pragma unroll
    for (int n = 0; n < kMaxD / kRowThreads; ++n) o[n] *= corr;
    __syncthreads();
    for (int key = 0; key < kTileF; ++key) {
      const float p = p_s[r * ldp + key];
      const float* vr = v_s + key * dv + c;
#pragma unroll
      for (int n = 0; n < kMaxD / kRowThreads; ++n)
        if (n < n_cols) o[n] = fmaf(p, vr[kRowThreads * n], o[n]);
    }
  }

#pragma unroll
  for (int off = 1; off < kRowThreads; off <<= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  if (row < S) {
    float* orow = out + (static_cast<size_t>(bh) * S + row) * dv + c;
#pragma unroll
    for (int n = 0; n < kMaxD / kRowThreads; ++n)
      if (n < n_cols) orow[kRowThreads * n] = o[n] / l;
  }
}

// ---- launch ---------------------------------------------------------------

bool dims_ok(int bh, int S, int d, int dv, int tile) {
  return bh >= 1 && S >= 1 && d >= kDimStep && dv >= kDimStep &&
         d <= kMaxD && dv <= kMaxD && d % kDimStep == 0 &&
         dv % kDimStep == 0 && (S + tile - 1) / tile <= 65535;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of the bf16 tensor [bh, S, cols] in boxes of 64 columns x `rows`
// rows of one (b, h), swizzled by 128 bytes; out-of-bounds elements read as
// zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int bh, int S, int cols,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * sizeof(bf16),
      static_cast<cuuint64_t>(S) * cols * sizeof(bf16)};
  const cuuint32_t box[3] = {kPanelCols, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMAX>
int launch_bf16_dmax(const void* q, const void* k, const void* v, void* out,
                     int bh, int S, int d, int dv, float scale, int causal,
                     cudaStream_t stream) {
  using T = Tiles<DMAX>;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, bh, S, d, kRowsQ) ||
      !encode_map(&k_map, k, bh, S, d, T::kN) ||
      !encode_map(&v_map, v, bh, S, dv, T::kN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One block per SM at most (each takes all of an SM's registers), each
  // walking its share of the query tiles.
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_work = bh * ((S + kRowsQ - 1) / kRowsQ);
  flash_bf16_kernel<DMAX>
      <<<n_work < sms ? n_work : sms, kThreads, T::kSmemBytes, stream>>>(
          q_map, k_map, v_map, static_cast<bf16*>(out), bh, S, dv,
          scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream` (a cudaStream_t) on
// the calling thread's current device, does not synchronise, and returns the
// launch's cudaError_t (0 on success). `scale` multiplies q.k (1/sqrt(d)).
extern "C" {

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int bh, int S, int d, int dv, int causal,
                         float scale, void* stream) {
  if (!dims_ok(bh, S, d, dv, kRowsQ))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int dmax = d > dv ? d : dv;
  if (dmax <= 64)
    return launch_bf16_dmax<64>(q, k, v, out, bh, S, d, dv, scale, causal, s);
  if (dmax <= 128)
    return launch_bf16_dmax<128>(q, k, v, out, bh, S, d, dv, scale, causal,
                                 s);
  return launch_bf16_dmax<256>(q, k, v, out, bh, S, d, dv, scale, causal, s);
}

int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int bh, int S, int d, int dv, int causal,
                        float scale, void* stream) {
  if (!dims_ok(bh, S, d, dv, kTileF))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes_f32(d, dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (S + kTileF - 1) / kTileF);
  flash_f32_kernel<<<grid, kThreadsF, smem, static_cast<cudaStream_t>(
                                                 stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, d, dv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
