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
// d and dv multiples of 16 up to 256. Rows and keys beyond S in the last tile
// are zero-filled in shared memory, masked, and never stored.
//
// What bounds it: operations. Per (b, h) the kernel does 4 S^2 d multiply-adds
// counted as flops (half of them under causal) on (3 d + dv) S elements, so at
// S = 2048, d = 128 in bf16 each byte moved feeds ~1000 flops, far above the
// ~295 flops per byte at which the H100's bf16 tensor cores, not its memory,
// become the limit. So the bf16 path runs both products on the tensor cores:
//   * one block of 4 warps per (bh, 64-row query tile); each warp owns 16 rows
//     and the whole 16 x 64 score tile of those rows in registers;
//   * K and V tiles of 64 keys are copied to shared memory with 16-byte
//     cp.async, double-buffered, so the next tile's copies are in flight while
//     this tile is computed; the Q tile is copied once;
//   * S = Q K^T and O += P V by mma.sync m16n8k16 (bf16 in, f32 accumulate),
//     operand fragments read with ldmatrix from rows padded by 16 bytes so
//     that the 8 rows of one ldmatrix fall in 8 different bank groups; the
//     warp's Q fragments stay in registers for head dims up to 128;
//   * the head dims are bucketed at compile time (64, 128, 256) and the tiles
//     zero-padded to the bucket in shared memory, so every inner loop has a
//     fixed trip count and no branch: a runtime bound inside the unrolled
//     loops keeps the compiler from hoisting the ldmatrix loads ahead of the
//     mma's, which halves the speed (measured on an H100);
//   * the online softmax runs on the accumulator fragments in registers (row
//     max by two quad shuffles; the denominator is summed per thread and
//     reduced once at the end), in base 2: p = exp2(s * scale * log2(e) -
//     max * scale * log2(e)), one FMA and one ex2 per score;
//   * P is rounded to bf16 in registers and becomes the A operand of P V
//     directly: the point where the TPU kernel casts p to V's dtype;
//   * under causal, tiles above the diagonal are never loaded (query and key
//     tiles are both 64 wide, so a row's last tile is its diagonal tile), and
//     the query tiles with the most work are scheduled first.
// The f32 path keeps the same walk with scalar FMA (never TF32) on 32 x 32
// tiles: 8 threads per query row, each with 4 keys of the score tile and
// dv / 8 columns of the accumulator.
// wgmma, TMA, warp specialisation and a persistent schedule are left for
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxD = 256;   // head dims d and dv
constexpr int kDimStep = 16; // d and dv are multiples of it (one mma k-step)

// ---- bf16 path ------------------------------------------------------------

constexpr int kTile = 64;              // query rows per block, keys per tile
constexpr int kWarps = 4;              // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;                // bf16 of padding per shared row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Rows r0 .. r0 + kTile - 1 of a [S, cols] matrix into shared rows `ld`
// elements apart; rows at or beyond S are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int r0, int S, int cols, int tid) {
  const int chunks = cols / 8;  // 16-byte chunks per row
  for (int c = tid; c < kTile * chunks; c += kThreads) {
    const int r = c / chunks;
    const int col = (c - r * chunks) * 8;
    const bool valid = r0 + r < S;
    const bf16* g = src + static_cast<size_t>(valid ? r0 + r : 0) * cols + col;
    cp_async16(dst + r * ld + col, g, valid);
  }
}

// The Q tile and two buffers each of K and V tiles, DMAX + kPad wide.
size_t smem_bytes_bf16(int dmax) {
  return static_cast<size_t>(5) * kTile * (dmax + kPad) * sizeof(bf16);
}

// Every tile is DMAX columns wide in shared memory; the columns beyond d (Q
// and K) and dv (V) are zeroed once and never copied to, so every loop runs
// to DMAX with no branch (a zero column adds nothing to Q K^T, and a zero V
// column gives an output column that is never stored). Head dims below the
// bucket pay for the padding.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int S, int d, int dv, float scale_log2, int causal) {
  constexpr int kLd = DMAX + kPad;
  constexpr int kSteps = DMAX / kDimStep;  // k-steps of Q K^T, V column pairs
  constexpr bool kQInRegs = DMAX <= 128;   // else Q is re-read per k-step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTile * kLd;      // 2 buffers
  bf16* v_s = k_s + 2 * kTile * kLd;  // 2 buffers

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // most keys first under causal
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const int row_a = q0 + warp * 16 + g;    // this thread's two query rows
  const int row_b = row_a + 8;

  const bf16* qb = q + static_cast<size_t>(bh) * S * d;
  const bf16* kb = k + static_cast<size_t>(bh) * S * d;
  const bf16* vb = v + static_cast<size_t>(bh) * S * dv;

  const int n_tiles = (S + kTile - 1) / kTile;
  const int n_kt = causal ? min(n_tiles, qt + 1) : n_tiles;

  if (d < DMAX || dv < DMAX) {
    // Tiles 0 (Q), 1-2 (K) take d columns, 3-4 (V) dv.
    constexpr int kChunks = DMAX / 8;
    for (int i = tid; i < 5 * kTile * kChunks; i += kThreads) {
      const int t = i / (kTile * kChunks);
      const int rc = i - t * kTile * kChunks;
      const int r = rc / kChunks, col = (rc - r * kChunks) * 8;
      if (col >= (t < 3 ? d : dv))
        *reinterpret_cast<uint4*>(q_s + (t * kTile + r) * kLd + col) =
            make_uint4(0, 0, 0, 0);
    }
  }
  load_tile(q_s, kLd, qb, q0, S, d, tid);
  cp_async_commit();
  load_tile(k_s, kLd, kb, 0, S, d, tid);
  load_tile(v_s, kLd, vb, 0, S, dv, tid);
  cp_async_commit();

  uint32_t qf[kQInRegs ? kSteps : 1][4];
  if constexpr (kQInRegs) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      ldmatrix_x4(qf[ks], q_s + (warp * 16 + (lane & 15)) * kLd + ks * 16 +
                              (lane >> 4) * 8);
  }

  float o[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // Running max of the raw scores q.k of rows row_a and row_b, and this
  // thread's share of their denominators.
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile(k_s + (buf ^ 1) * kTile * kLd, kLd, kb, (kt + 1) * kTile, S,
                d, tid);
      load_tile(v_s + (buf ^ 1) * kTile * kLd, kLd, vb, (kt + 1) * kTile, S,
                dv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt_s = k_s + buf * kTile * kLd;
    const bf16* vt_s = v_s + buf * kTile * kLd;

    // s[j]: this warp's rows against keys 8j .. 8j + 7 of the tile.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
      } else {
        ldmatrix_x4(a, q_s + (warp * 16 + (lane & 15)) * kLd + ks * 16 +
                           (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, kt_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  kLd +
                           ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    const int k0 = kt * kTile;
    if (k0 + kTile > S || (causal && k0 + kTile - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (col >= S || (causal && col > row)) s[j][e] = -CUDART_INF_F;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // A row with no unmasked key yet keeps its exponents finite.
      base[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r] * scale_log2;
      corr[r] = fast_exp2(m[r] * scale_log2 - base[r]);
      m[r] = mx[r];
    }
    // p = exp(scale * (s - max)) = exp2(s * scale * log2(e) - base).
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[j][e], scale_log2, -base[e >> 1]));
        s[j][e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V, 16 keys per k-step; the score fragments of key tiles 2kk and
    // 2kk + 1 are exactly the A fragment of that step.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int vp = 0; vp < kSteps; ++vp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, vt_s + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                          kLd +
                   vp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * vp], a, b[0], b[1]);
        mma_bf16(o[2 * vp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
  bf16* ob = out + static_cast<size_t>(bh) * S * dv;
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    if (n * 8 < dv) {
      const int col = n * 8 + 2 * t4;
      if (row_a < S)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row_a) * dv +
                                     col) =
            pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
      if (row_b < S)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(row_b) * dv +
                                     col) =
            pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
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

template <int DMAX>
int launch_bf16_dmax(const void* q, const void* k, const void* v, void* out,
                     int bh, int S, int d, int dv, float scale, int causal,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes_bf16(DMAX);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (S + kTile - 1) / kTile);
  flash_bf16_kernel<DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, d, dv,
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
  if (!dims_ok(bh, S, d, dv, kTile))
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
