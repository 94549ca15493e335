// Hopper (sm_90a) building blocks shared by the attention kernels: mbarriers,
// TMA tensor loads and 1-D bulk copies, `setmaxnreg`, warpgroup MMAs
// (`wgmma`) with shared-memory descriptors in the 128-byte swizzle, and the
// driver's tensor-map encoder reached at run time (so no library links
// libcuda). Each source that includes it gets its own copy (an anonymous
// namespace).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run
                   // time, so the library does not link libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

// Whether a 16-bit element type of the wgmma path is f16 (else bf16).
template <typename T>
constexpr bool kIsF16 = std::is_same<T, f16>::value;

constexpr int kPanelCols = 64;       // bf16 columns in one 128-byte swizzle row
constexpr int kPanelRowBytes = 128;

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

// `bytes` contiguous bytes of global memory at `src` into shared memory at
// `dst`, counted in bytes on `bar`: the 1-D bulk copy, no tensor map. `src`,
// `dst` and `bytes` are multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))), "r"(bytes),
      "r"(bar)
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
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
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

// d[64 x N] (+)= a * b, T (bf16 or f16) in, f32 accumulate:
// _ss (S, N = keys per tile: 64, 176): a (64 x 16) and b (16 x N) both
// K-major in shared memory;
// _rs (O, N = 64, 128, 256): a (64 x 16) in registers, b (16 x N) MN-major
// in shared memory.
// `acc` = 0 overwrites d. Thread t of the warpgroup holds d[i] at row
// 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
// 2 (t % 4) + i % 2; a's registers are mma.sync's m16n8k16 A fragment of
// the warp's 16 rows. The two input types share every layout.
#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F32(i)                                                           \
  F4(i), F4(i + 4), F4(i + 8), F4(i + 12), F4(i + 16), F4(i + 20),       \
      F4(i + 24), F4(i + 28)

#define WGMMA_SS_N64(TY)                                                                   \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                      \
      : F32(0)                                                                             \
      : "l"(a), "l"(b), "r"(acc))
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  if constexpr (kIsF16<T>)
    WGMMA_SS_N64("f16");
  else
    WGMMA_SS_N64("bf16");
}
#undef WGMMA_SS_N64

#define WGMMA_SS_N176(TY)                                                                 \
  asm volatile(                                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n176k16.f32." TY "." TY " {"                       \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
      "%80, %81, %82, %83, %84, %85, %86, %87}, "                                         \
      "%88, %89, p, 1, 1, 0, 0;\n}\n"                                                     \
      : F32(0), F32(32), F4(64), F4(68), F4(72), F4(76), F4(80), F4(84)                   \
      : "l"(a), "l"(b), "r"(acc))
template <typename T>
__device__ __forceinline__ void wgmma_ss_n176(float (&d)[88], uint64_t a, uint64_t b, int acc) {
  if constexpr (kIsF16<T>)
    WGMMA_SS_N176("f16");
  else
    WGMMA_SS_N176("bf16");
}
#undef WGMMA_SS_N176
#define WGMMA_RS_N64(TY)                                                                   \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                        \
      : F32(0)                                                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc))
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  if constexpr (kIsF16<T>)
    WGMMA_RS_N64("f16");
  else
    WGMMA_RS_N64("bf16");
}
#undef WGMMA_RS_N64

#define WGMMA_RS_N128(TY)                                                                  \
  asm volatile(                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                        \
      : F32(0), F32(32)                                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc))
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
  if constexpr (kIsF16<T>)
    WGMMA_RS_N128("f16");
  else
    WGMMA_RS_N128("bf16");
}
#undef WGMMA_RS_N128

#define WGMMA_RS_N256(TY)                                                                                  \
  asm volatile(                                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                                        \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                   \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                   \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                   \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                   \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "       \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "  \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                                                   \
      : F32(0), F32(32), F32(64), F32(96)                                                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc))
template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int acc) {
  if constexpr (kIsF16<T>)
    WGMMA_RS_N256("f16");
  else
    WGMMA_RS_N256("bf16");
}
#undef WGMMA_RS_N256

#define WGMMA_SS_N32(TY)                                                         \
  asm volatile(                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                               \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"               \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "  \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                            \
      : F4(0), F4(4), F4(8), F4(12)                                              \
      : "l"(a), "l"(b), "r"(acc))
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  if constexpr (kIsF16<T>)
    WGMMA_SS_N32("f16");
  else
    WGMMA_SS_N32("bf16");
}
#undef WGMMA_SS_N32

#define WGMMA_SS_T_N256(TY)                                                                                \
  asm volatile(                                                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                                        \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                                        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                   \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                   \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                   \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                   \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "       \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "  \
      "%128, %129, p, 1, 1, 0, 1;\n}\n"                                                                    \
      : F32(0), F32(32), F32(64), F32(96)                                                                  \
      : "l"(a), "l"(b), "r"(acc))
template <typename T>
__device__ __forceinline__ void wgmma_sst_n256(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  if constexpr (kIsF16<T>)
    WGMMA_SS_T_N256("f16");
  else
    WGMMA_SS_T_N256("bf16");
}
#undef WGMMA_SS_T_N256

// ---- TF32: f32 operands on the tensor cores (the 3xTF32 route)
//
// A k-step of TF32 is 8 values, 32 bytes: the same 32-byte step through a
// 128-byte swizzle row as the 16-bit forms take, with 32 f32 columns to a
// row (kPanelColsF32). `wgmma` reads TF32 from shared memory K-major only
// (the transpose bits exist for f16 and bf16 alone), and it reads an f32
// operand's top 19 bits: the low 13 bits of the mantissa are ignored.

// d[64 x 64] (+)= a * b: a (64 x 8) in registers (the fragment below), b
// (8 x 64) K-major in shared memory; acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d[64 x 32] += a * b: a (64 x 8) in registers, b (8 x 32) K-major in
// shared memory. Each warp holds its 16 rows of a as mma.sync's m16n8k8
// TF32 A fragment: a[0] at row lane / 4, column lane % 4; a[1] eight rows
// down; a[2] four columns right; a[3] both.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : F4(0), F4(4), F4(8), F4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F32
#undef F4

constexpr int kPanelColsF32 = 32;  // f32 columns in one 128-byte swizzle row

// x rounded to TF32 (to nearest, ties away from zero): PTX's
// cvt.rna.tf32.f32, in f32's bit layout with the low 13 bits zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The TF32 value a `wgmma` reads from a raw f32 operand: x with the low 13
// bits of its mantissa cleared.
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc) {
  if constexpr (N == 64) wgmma_ss_n64<T>(d, a, b, acc);
  else wgmma_ss_n176<T>(d, a, b, acc);
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64<T>(d, a, b, 1);
  else if constexpr (N == 128) wgmma_rs_n128<T>(d, a, b, 1);
  else wgmma_rs_n256<T>(d, a, b, 1);
}

// Two floats rounded to T (bf16 or f16), `lo` in the low half (the lower
// column).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// exp2 of x on the special-function unit; exp2(-inf) = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Orders this thread's generic-proxy writes to shared memory before reads of
// the same bytes by the async proxy (a `wgmma` operand, a TMA store).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// A map of the 16-bit tensor [bh, S, cols] of element type E in boxes of
// 64 columns x `rows` rows of one (b, h), swizzled by 128 bytes;
// out-of-bounds elements read as zeros.
template <typename E>
bool encode_map(CUtensorMap* map, const void* ptr, int bh, int S, int cols,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * sizeof(E),
      static_cast<cuuint64_t>(S) * cols * sizeof(E)};
  const cuuint32_t box[3] = {kPanelCols, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map,
                kIsF16<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of a 16-bit tensor (bf16 or f16: TMA copies bits) [bh, S, cols] in
// boxes of 32 columns (64 bytes, the columns of an f32 panel) x `rows`,
// swizzled by 64 bytes: 16-byte chunk c of row r lands at chunk
// c ^ ((r / 2) % 4) (`sw64_offset`); out-of-bounds elements read as zeros.
inline bool encode_map_16_narrow(CUtensorMap* map, const void* ptr, int bh,
                                 int S, int cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * 2,
      static_cast<cuuint64_t>(S) * cols * 2};
  const cuuint32_t box[3] = {kPanelColsF32, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The byte offset of element `col` (0-31) of row `row` in a panel of
// `encode_map_16_narrow`: 64-byte rows, chunks swizzled by 64 bytes.
__device__ __forceinline__ int sw64_offset(int row, int col) {
  return row * 64 + ((((col >> 3) ^ (row >> 1)) & 3) << 4) + 2 * (col & 7);
}

// A 16-bit value's bits as f32 (exact): f16 where `is_f16`, else bf16.
// Both conversions are computed and one is selected, so no branch reaches
// the loops that issue wgmmas.
__device__ __forceinline__ float from16(uint32_t bits, bool is_f16) {
  const float h = __half2float(__ushort_as_half(static_cast<uint16_t>(bits)));
  const float b = __uint_as_float(bits << 16);
  return is_f16 ? h : b;
}

// x rounded to f16 where `is_f16`, else to bf16 (to nearest even), as f32.
__device__ __forceinline__ float round16(float x, bool is_f16) {
  const float h = __half2float(__float2half_rn(x));
  const float b = __bfloat162float(__float2bfloat16_rn(x));
  return is_f16 ? h : b;
}

// The same for an f32 tensor: boxes of 32 columns (128 bytes) x `rows`.
inline bool encode_map_f32(CUtensorMap* map, const void* ptr, int bh, int S,
                           int cols, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * sizeof(float),
      static_cast<cuuint64_t>(S) * cols * sizeof(float)};
  const cuuint32_t box[3] = {kPanelColsF32, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
