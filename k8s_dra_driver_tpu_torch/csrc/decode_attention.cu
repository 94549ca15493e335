// Decode attention for NVIDIA Hopper (sm_90a): a few query rows against a
// padded KV cache, with one valid length per sequence.
//
// Replaces the TPU kernel `_decode_kernel`, reached through
// `flash_attention_decode` (k8s_dra_driver_tpu/compute/flashattention.py).
// It computes the same function: scores q.k accumulated in f32 and then
// multiplied by 1/sqrt(d); keys at index >= kv_lengths[b] masked; an online
// softmax with f32 running max and denominator; p rounded to V's dtype before
// the PV product (a no-op in f32); output acc / l in q's dtype.
//
// Layout: q is [b, h, ql, d], k is [b, h, cap, d], v is [b, h, cap, dv] and
// out is [b, h, ql, dv], all contiguous; lens is [b] int32 and applies to
// every head of its sequence. A launch of the tuned or the general kernel
// takes query rows [row0, row0 + rows) of q, rows <= 8; the query rows do
// not attend to each other, so a caller with more rows launches once per
// group of 8 and the groups write disjoint rows of out. The wide entry takes
// every row in one call.
//
// Which kernel takes a call (the C entries at the end):
//   * q, k and v of one dtype (f32, bf16 or f16) with d, dv <= 256:
//     `decode_attention_kernel`, entries decode_attention_{f32,bf16,f16};
//   * q, k and v all bf16 or all f16, d or dv over 256, d <= 576 and
//     dv <= 512 (the wrapper zero-pads both to multiples of 16): the wide
//     tensor-core kernel of wide_attention.cuh and its merge, entries
//     decode_attention_wide_{bf16,f16} (its note says what bounds it and
//     what its design does about that: at absorbed MLA's 128 query rows
//     each key feeds 128 x 1,088 multiply-adds, which is work for `wgmma`,
//     not for the SIMT loop below);
//   * anything else (q, k and v each in its own dtype, f32 over 256, or
//     head dims past the wide kernel's): `decode_general_kernel`, entry
//     decode_attention_general.
//
// What bounds it: device-memory bytes. Every valid K and V row is read once,
// (d + dv) * sizeof(T) bytes per key per head (1 KiB at d = 128 in f32), and
// each element feeds only ql <= 8 multiply-adds, far below the operations per
// byte at which the card's arithmetic would become the limit. So the design
// is about keeping enough loads in flight and nothing else in their way:
//   * one thread block per (b, h) pair, so a batch of sequences gives enough
//     blocks to fill every SM, and the rows of one head stream through one SM;
//   * each warp walks its own share of the keys, kBatch keys at a time, with
//     its own online softmax (running max, denominator and accumulator in
//     registers), so no barrier stalls the stream; the warps' partial
//     results are merged once, at the end (the split-KV merge, inside a block);
//   * a row is read by one warp with its lanes across d, 16 bytes per lane
//     (512 contiguous bytes per K or V row at d = 128 in f32), and a batch's
//     K and V rows are all requested before any is used;
//   * the walk ends at key min(len, cap) - 1, so the masked tail of the padded
//     cache is never read. (The TPU kernel walks all cap / block_k blocks; a
//     fully masked block only adds exp(-inf) = 0 with a correction of 1, so
//     skipping it changes no output.);
//   * the number of query rows is a template parameter, so that the engine's
//     ql = 1 spends no registers on rows it does not have;
//   * so is whether V's head dim is K's (the engine's case): then one guard
//     and one row offset cover a key's K and V loads, which keeps all of a
//     batch's loads issued together (with separate guards the same shapes
//     ran 2.4% slower on the H100).
// The general kernel keeps that walk and lifts the width limit: a block
// takes 256 output columns (a second grid dimension over dv, each block
// computing the full scores again: q.k is cheap next to the bytes), walks d
// in chunks of one warp load, holds the launch's query rows in shared memory
// as f32 (interleaved so that a warp's reads hit 32 banks; row-major, a
// warp's reads of a row meet 8-way bank conflicts), and
// converts each operand from its own dtype as it is loaded (K
// and V by template, q and out by a code read once per element), so no
// caller has to cast a cache. Each block re-reads all of K: at dv = 512 the
// bytes are 2 d + dv per key, not d + dv.
// What holds the general kernel back (PERF.md): a grid of b * h * (dv /
// 256) blocks leaves most SMs idle when b * h is small, and each warp's
// batch waits on one load round trip per chunk of d. Its 16-bit calls at
// head dims up to 576/512, absorbed MLA's among them (16 launches of 8
// rows, each reading the whole latent cache: 24 ms on an H100 where the
// library took 0.48), go to the wide kernel instead; it keeps f32, mixed
// dtypes and wider heads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wide_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;   // keys a warp has in flight (K and V rows each)
constexpr int kMaxQ = 8;    // query rows per launch
constexpr int kMaxD = 256;  // head dims (d, dv); kThreads >= kMaxD: the merge

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// E consecutive elements at p, as floats: one 16-byte load when E elements
// fill 16 bytes (p then 16-byte aligned), else E scalar loads.
template <typename T, int E>
__device__ __forceinline__ void load_row(const T* p, float (&out)[E]) {
  if constexpr (E * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = to_float(p[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// T: element type. QL: query rows the kernel is built for (rows <= QL; rows
// rows..QL-1 are zero and never stored). E: elements per lane per load.
// kSameDims: dv == d. ql is q's and out's row count per (b, h), of which this
// launch takes rows row0 .. row0 + rows - 1.
template <typename T, int QL, int E, bool kSameDims>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lens, T* __restrict__ out,
                            int h, int ql, int row0, int rows, int cap, int d,
                            int dv, float scale) {
  constexpr int kChunk = 32 * E;                         // elements per warp load
  constexpr int kChunks = (kMaxD + kChunk - 1) / kChunk;  // per row, at most
  __shared__ float q_s[QL][kMaxD];
  __shared__ float m_s[kWarps][QL];
  __shared__ float l_s[kWarps][QL];
  __shared__ float acc_s[kWarps][kMaxD];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* kb = k + static_cast<size_t>(bh) * cap * d;
  const T* vb = v + static_cast<size_t>(bh) * cap * dv;
  const size_t q_off = (static_cast<size_t>(bh) * ql + row0) * d;
  const size_t o_off = (static_cast<size_t>(bh) * ql + row0) * dv;

  for (int i = tid; i < QL * kMaxD; i += kThreads) {
    const int r = i / kMaxD, c = i - r * kMaxD;
    q_s[r][c] = (r < rows && c < d) ? to_float(q[q_off + r * d + c]) : 0.f;
  }
  __syncthreads();

  // Lane `lane` owns elements ch * kChunk + lane * E + e of every row; with
  // d % E == 0 and dv % E == 0 those are all in range or all out of it.
  float qr[QL][kChunks][E];
#pragma unroll
  for (int r = 0; r < QL; ++r)
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = ch * kChunk + lane * E + e;
        qr[r][ch][e] = c < kMaxD ? q_s[r][c] : 0.f;
      }

  const int n_valid = min(lens[bh / h], cap);
  float m[QL], l[QL], acc[QL][kChunks][E];
#pragma unroll
  for (int r = 0; r < QL; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][ch][e] = 0.f;
  }

  // Warp w takes keys [w * kBatch, (w + 1) * kBatch), then the same span
  // kWarps * kBatch further on, and so on.
  for (int base = warp * kBatch; base < n_valid; base += kWarps * kBatch) {
    float kr[kBatch][kChunks][E], vr[kBatch][kChunks][E];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int c = ch * kChunk + lane * E;
        const bool key = base + u < n_valid;
        if constexpr (kSameDims) {
          if (key && c < d) {
            const size_t row = static_cast<size_t>(base + u) * d + c;
            load_row<T, E>(kb + row, kr[u][ch]);
            load_row<T, E>(vb + row, vr[u][ch]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) kr[u][ch][e] = vr[u][ch][e] = 0.f;
          }
        } else {
          if (key && c < d) {
            load_row<T, E>(kb + static_cast<size_t>(base + u) * d + c,
                           kr[u][ch]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) kr[u][ch][e] = 0.f;
          }
          if (key && c < dv) {
            load_row<T, E>(vb + static_cast<size_t>(base + u) * dv + c,
                           vr[u][ch]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) vr[u][ch][e] = 0.f;
          }
        }
      }

#pragma unroll
    for (int r = 0; r < QL; ++r) {
      float s[kBatch];
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        float part = 0.f;
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
          for (int e = 0; e < E; ++e)
            part = fmaf(qr[r][ch][e], kr[u][ch][e], part);
        s[u] = base + u < n_valid ? warp_sum(part) * scale : -CUDART_INF_F;
        m_new = fmaxf(m_new, s[u]);
      }
      // Key `base` is valid, so m_new is finite and no exp sees -inf - -inf;
      // the first batch gives corr = exp(-inf) = 0 against the empty state.
      const float corr = expf(m[r] - m_new);
      float p[kBatch], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float pu = expf(s[u] - m_new);
        psum += pu;
        p[u] = to_float(from_float<T>(pu));  // p in V's dtype for PV
      }
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[r][ch][e] * corr;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) a = fmaf(p[u], vr[u][ch][e], a);
          acc[r][ch][e] = a;
        }
    }
  }

  // Merge the warps' (m, l, acc): weights exp(m_w - max m); a warp that saw
  // no key has m_w = -inf and weight 0. len <= 0 leaves every warp empty,
  // l = 0, and a NaN output, as the plain version gives.
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < QL; ++r) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  }
  // r runs to the compile-time QL so that acc stays in registers; the guard
  // is the same in every thread, so the barriers inside are uniform.
#pragma unroll
  for (int r = 0; r < QL; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = ch * kChunk + lane * E + e;
        if (c < kMaxD) acc_s[warp][c] = acc[r][ch][e];
      }
    __syncthreads();
    if (tid < dv) {
      float m_tot = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, m_s[w][r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = m_s[w][r];
        const float wt = mw == -CUDART_INF_F ? 0.f : expf(mw - m_tot);
        num = fmaf(wt, acc_s[w][tid], num);
        den = fmaf(wt, l_s[w][r], den);
      }
      out[o_off + r * dv + tid] = from_float<T>(num / den);
    }
    __syncthreads();
  }
}

template <typename T, int QL, bool kSameDims>
void launch_dims(const void* q, const void* k, const void* v,
                 const void* lens, void* out, int b, int h, int ql, int row0,
                 int rows, int cap, int d, int dv, float scale,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && dv % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* lp = static_cast<const int*>(lens);
  auto* op = static_cast<T*>(out);
  if (vec)
    decode_attention_kernel<T, QL, kVec, kSameDims>
        <<<b * h, kThreads, 0, stream>>>(qp, kp, vp, lp, op, h, ql, row0,
                                         rows, cap, d, dv, scale);
  else
    decode_attention_kernel<T, QL, 1, kSameDims>
        <<<b * h, kThreads, 0, stream>>>(qp, kp, vp, lp, op, h, ql, row0,
                                         rows, cap, d, dv, scale);
}

template <typename T, int QL>
int launch_rows(const void* q, const void* k, const void* v, const void* lens,
                void* out, int b, int h, int ql, int row0, int rows, int cap,
                int d, int dv, float scale, cudaStream_t stream) {
  if (d == dv)
    launch_dims<T, QL, true>(q, k, v, lens, out, b, h, ql, row0, rows, cap, d,
                             dv, scale, stream);
  else
    launch_dims<T, QL, false>(q, k, v, lens, out, b, h, ql, row0, rows, cap,
                              d, dv, scale, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* out, int b, int h, int ql, int row0, int rows, int cap,
           int d, int dv, float scale, void* stream) {
  if (b < 1 || h < 1 || cap < 1 || rows < 1 || rows > kMaxQ || row0 < 0 ||
      row0 + rows > ql || d < 1 || d > kMaxD || dv < 1 || dv > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (rows == 1)
    return launch_rows<T, 1>(q, k, v, lens, out, b, h, ql, row0, rows, cap, d,
                             dv, scale, s);
  if (rows == 2)
    return launch_rows<T, 2>(q, k, v, lens, out, b, h, ql, row0, rows, cap, d,
                             dv, scale, s);
  if (rows <= 4)
    return launch_rows<T, 4>(q, k, v, lens, out, b, h, ql, row0, rows, cap, d,
                             dv, scale, s);
  return launch_rows<T, 8>(q, k, v, lens, out, b, h, ql, row0, rows, cap, d,
                           dv, scale, s);
}

// ---- general kernel: any head dims; q, k and v each in its own dtype ------

constexpr int kDvBlock = kThreads;  // output columns per block (grid.y)

// The dtype codes of the general entry (the wrapper's): f32, bf16, f16.
enum DtypeCode : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Element i of a tensor whose dtype is known only at run time (q, out).
__device__ __forceinline__ float load_any(const void* p, int type, size_t i) {
  if (type == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (type == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, int type, size_t i,
                                          float x) {
  if (type == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
  else if (type == kF16)
    static_cast<__half*>(p)[i] = __float2half(x);
  else
    static_cast<float*>(p)[i] = x;
}

// TK, TV: K's and V's element types. QL: query rows the kernel is built for
// (rows <= QL). kVec: 16-byte loads (d and dv multiples of a 16-byte vector
// of their types, k and v 16-byte aligned); else one element per lane.
// Block (bh, y) computes output columns [256 y, 256 y + 256) of every row.
template <typename TK, typename TV, int QL, bool kVec>
__global__ void __launch_bounds__(kThreads)
    decode_general_kernel(const void* __restrict__ q,
                          const TK* __restrict__ k, const TV* __restrict__ v,
                          const int* __restrict__ lens, void* __restrict__ out,
                          int h, int ql, int row0, int rows, int cap, int d,
                          int dv, float scale, int q_type) {
  constexpr int EK = kVec ? 16 / sizeof(TK) : 1;   // K elements per lane load
  constexpr int EV = kVec ? 16 / sizeof(TV) : 1;   // V elements per lane load
  constexpr int kChunkK = 32 * EK;                 // d columns per warp load
  constexpr int kChunkV = 32 * EV;
  constexpr int kChunksV = kDvBlock / kChunkV;     // per block's columns
  // The launch's query rows as f32, laid out so that a warp reads one
  // element of each lane's share of a chunk from 32 consecutive floats (no
  // bank conflict): column ch * kChunkK + lane * EK + e of row r at
  // (ch * rows + r) * kChunkK + e * 32 + lane, zeros past d.
  extern __shared__ float q_s[];
  __shared__ float m_s[kWarps][QL];
  __shared__ float l_s[kWarps][QL];
  __shared__ float acc_s[kWarps][kDvBlock];

  const int bh = blockIdx.x;
  const int c0 = blockIdx.y * kDvBlock;
  const int ncols = min(kDvBlock, dv - c0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const TK* kb = k + static_cast<size_t>(bh) * cap * d;
  const TV* vb = v + static_cast<size_t>(bh) * cap * dv + c0;
  const size_t q_off = (static_cast<size_t>(bh) * ql + row0) * d;
  const size_t o_off = (static_cast<size_t>(bh) * ql + row0) * dv + c0;

  const int n_ch = (d + kChunkK - 1) / kChunkK;
  for (int i = tid; i < n_ch * rows * kChunkK; i += kThreads) {
    const int ch_r = i / kChunkK, rem = i - ch_r * kChunkK;
    const int ch = ch_r / rows, r = ch_r - ch * rows;
    const int e = rem / 32, ln = rem - e * 32;
    const int col = ch * kChunkK + ln * EK + e;
    q_s[i] = col < d ? load_any(q, q_type, q_off + static_cast<size_t>(r) * d
                                               + col)
                     : 0.f;
  }
  __syncthreads();

  const int n_valid = min(lens[bh / h], cap);
  float m[QL], l[QL], acc[QL][kChunksV][EV];
#pragma unroll
  for (int r = 0; r < QL; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int ch = 0; ch < kChunksV; ++ch)
#pragma unroll
      for (int e = 0; e < EV; ++e) acc[r][ch][e] = 0.f;
  }

  // Warp w takes keys [w * kBatch, (w + 1) * kBatch), then the same span
  // kWarps * kBatch further on, and so on, as the tuned kernel does.
  for (int base = warp * kBatch; base < n_valid; base += kWarps * kBatch) {
    // The batch's V rows (this block's columns) are requested first: they
    // wait on nothing.
    float vr[kBatch][kChunksV][EV];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int ch = 0; ch < kChunksV; ++ch) {
        const int c = ch * kChunkV + lane * EV;
        if (base + u < n_valid && c < ncols) {
          load_row<TV, EV>(vb + static_cast<size_t>(base + u) * dv + c,
                           vr[u][ch]);
        } else {
#pragma unroll
          for (int e = 0; e < EV; ++e) vr[u][ch][e] = 0.f;
        }
      }
    // Each lane's share of q.k, d walked one warp load at a time.
    float part[QL][kBatch];
#pragma unroll
    for (int r = 0; r < QL; ++r)
#pragma unroll
      for (int u = 0; u < kBatch; ++u) part[r][u] = 0.f;
#pragma unroll 2
    for (int ch = 0; ch < n_ch; ++ch) {
      const int c = ch * kChunkK + lane * EK;
      float kr[kBatch][EK];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (base + u < n_valid && c < d) {
          load_row<TK, EK>(kb + static_cast<size_t>(base + u) * d + c, kr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < EK; ++e) kr[u][e] = 0.f;
        }
      }
      const float* qc = q_s + ch * rows * kChunkK + lane;
#pragma unroll
      for (int r = 0; r < QL; ++r) {
        if (r < rows) {
#pragma unroll
          for (int e = 0; e < EK; ++e) {
            const float qv = qc[r * kChunkK + e * 32];
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              part[r][u] = fmaf(qv, kr[u][e], part[r][u]);
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < QL; ++r) {
      float s[kBatch];
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        s[u] = base + u < n_valid ? warp_sum(part[r][u]) * scale
                                  : -CUDART_INF_F;
        m_new = fmaxf(m_new, s[u]);
      }
      // Key `base` is valid, so m_new is finite (as in the tuned kernel).
      const float corr = expf(m[r] - m_new);
      float p[kBatch], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float pu = expf(s[u] - m_new);
        psum += pu;
        p[u] = to_float(from_float<TV>(pu));  // p in V's dtype for PV
      }
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int ch = 0; ch < kChunksV; ++ch)
#pragma unroll
        for (int e = 0; e < EV; ++e) {
          float a = acc[r][ch][e] * corr;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) a = fmaf(p[u], vr[u][ch][e], a);
          acc[r][ch][e] = a;
        }
    }
  }

  // The warps' merge, as in the tuned kernel, over this block's columns.
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < QL; ++r) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < QL; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int ch = 0; ch < kChunksV; ++ch)
#pragma unroll
      for (int e = 0; e < EV; ++e)
        acc_s[warp][ch * kChunkV + lane * EV + e] = acc[r][ch][e];
    __syncthreads();
    if (tid < ncols) {
      float m_tot = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m_tot = fmaxf(m_tot, m_s[w][r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = m_s[w][r];
        const float wt = mw == -CUDART_INF_F ? 0.f : expf(mw - m_tot);
        num = fmaf(wt, acc_s[w][tid], num);
        den = fmaf(wt, l_s[w][r], den);
      }
      store_any(out, q_type, o_off + static_cast<size_t>(r) * dv + tid,
                num / den);
    }
    __syncthreads();
  }
}

template <typename TK, typename TV, int QL, bool kVec>
int launch_general_as(const void* q, const void* k, const void* v,
                      const void* lens, void* out, int b, int h, int ql,
                      int row0, int rows, int cap, int d, int dv, float scale,
                      int q_type, cudaStream_t stream) {
  const auto kernel = decode_general_kernel<TK, TV, QL, kVec>;
  constexpr int kChunkK = 32 * (kVec ? 16 / sizeof(TK) : 1);
  const size_t smem = static_cast<size_t>(rows) *
                      ((d + kChunkK - 1) / kChunkK) * kChunkK * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(b * h, (dv + kDvBlock - 1) / kDvBlock);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const TK*>(k), static_cast<const TV*>(v),
      static_cast<const int*>(lens), out, h, ql, row0, rows, cap, d, dv,
      scale, q_type);
  return static_cast<int>(cudaGetLastError());
}

template <typename TK, typename TV>
int launch_general(const void* q, const void* k, const void* v,
                   const void* lens, void* out, int b, int h, int ql, int row0,
                   int rows, int cap, int d, int dv, float scale, int q_type,
                   cudaStream_t s) {
  const bool vec = d % (16 / sizeof(TK)) == 0 &&
                   dv % (16 / sizeof(TV)) == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (rows == 1)
    return vec ? launch_general_as<TK, TV, 1, true>(
                     q, k, v, lens, out, b, h, ql, row0, rows, cap, d, dv,
                     scale, q_type, s)
               : launch_general_as<TK, TV, 1, false>(
                     q, k, v, lens, out, b, h, ql, row0, rows, cap, d, dv,
                     scale, q_type, s);
  return vec ? launch_general_as<TK, TV, kMaxQ, true>(
                   q, k, v, lens, out, b, h, ql, row0, rows, cap, d, dv,
                   scale, q_type, s)
             : launch_general_as<TK, TV, kMaxQ, false>(
                   q, k, v, lens, out, b, h, ql, row0, rows, cap, d, dv,
                   scale, q_type, s);
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the element type T of dtype code `code`.
template <typename F>
int with_dtype(int code, F&& f) {
  if (code == kF32) return f(Tag<float>{});
  if (code == kBF16) return f(Tag<__nv_bfloat16>{});
  if (code == kF16) return f(Tag<__half>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream` (a cudaStream_t) on
// the calling thread's current device, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" {

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lens, void* out, int b, int h, int ql,
                         int row0, int rows, int cap, int d, int dv,
                         float scale, void* stream) {
  return launch<float>(q, k, v, lens, out, b, h, ql, row0, rows, cap, d, dv,
                       scale, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lens, void* out, int b, int h, int ql,
                          int row0, int rows, int cap, int d, int dv,
                          float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lens, out, b, h, ql, row0, rows, cap,
                               d, dv, scale, stream);
}

int decode_attention_f16(const void* q, const void* k, const void* v,
                         const void* lens, void* out, int b, int h, int ql,
                         int row0, int rows, int cap, int d, int dv,
                         float scale, void* stream) {
  return launch<__half>(q, k, v, lens, out, b, h, ql, row0, rows, cap, d, dv,
                        scale, stream);
}

// The wide path (wide_attention.cuh): q, k and v all bf16 or all f16, d and
// dv multiples of 16 up to 576 and 512, every query row in one call. part_o
// and part_ml are the f32 partials' workspace, [b h, splits, ql, dv] and
// [b h, splits, ql, 2]; split s takes keys [s split_keys, (s + 1)
// split_keys). Launches the kernel and the merge, and returns the first
// error.
int decode_attention_wide_bf16(const void* q, const void* k, const void* v,
                               const void* lens, void* out, void* part_o,
                               void* part_ml, int b, int h, int ql, int cap,
                               int d, int dv, float scale, int splits,
                               int split_keys, void* stream) {
  return wide::launch_decode<__nv_bfloat16>(
      q, k, v, lens, out, part_o, part_ml, b, h, ql, cap, d, dv, scale,
      splits, split_keys, static_cast<cudaStream_t>(stream));
}

int decode_attention_wide_f16(const void* q, const void* k, const void* v,
                              const void* lens, void* out, void* part_o,
                              void* part_ml, int b, int h, int ql, int cap,
                              int d, int dv, float scale, int splits,
                              int split_keys, void* stream) {
  return wide::launch_decode<__half>(
      q, k, v, lens, out, part_o, part_ml, b, h, ql, cap, d, dv, scale,
      splits, split_keys, static_cast<cudaStream_t>(stream));
}

// Any head dims; q_type, k_type and v_type are each 0 (f32), 1 (bf16) or 2
// (f16), and out has q's dtype.
int decode_attention_general(const void* q, const void* k, const void* v,
                             const void* lens, void* out, int b, int h,
                             int ql, int row0, int rows, int cap, int d,
                             int dv, float scale, int q_type, int k_type,
                             int v_type, void* stream) {
  if (b < 1 || h < 1 || cap < 1 || rows < 1 || rows > kMaxQ || row0 < 0 ||
      row0 + rows > ql || d < 1 || dv < 1 ||
      (dv + kDvBlock - 1) / kDvBlock > 65535 || q_type < kF32 ||
      q_type > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return with_dtype(k_type, [&](auto tk) {
    return with_dtype(v_type, [&](auto tv) {
      return launch_general<typename decltype(tk)::type,
                            typename decltype(tv)::type>(
          q, k, v, lens, out, b, h, ql, row0, rows, cap, d, dv, scale,
          q_type, s);
    });
  });
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
