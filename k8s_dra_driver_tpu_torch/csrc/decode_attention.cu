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
// Layout: q and out are [b, h, ql, d], k and v are [b, h, cap, d], all
// contiguous; lens is [b] int32 and applies to every head of its sequence.
//
// What bounds it: device-memory bytes. Every valid K and V row is read once,
// 2 * d * sizeof(T) bytes per key per head (1 KiB at d = 128 in f32), and
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
//     ql = 1 spends no registers on rows it does not have.
// wgmma, TMA and split-KV across blocks (for batches too small to fill the
// SMs) are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;   // keys a warp has in flight (K and V rows each)
constexpr int kMaxQ = 8;    // query rows (ql)
constexpr int kMaxD = 256;  // head dim (d); kThreads >= kMaxD for the merge

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// T: element type. QL: query rows the kernel is built for (ql <= QL; rows
// ql..QL-1 are zero and never stored). E: elements per lane per load.
template <typename T, int QL, int E>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lens, T* __restrict__ out,
                            int h, int ql, int cap, int d, float scale) {
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
  const size_t kv_off = static_cast<size_t>(bh) * cap * d;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  const size_t q_off = static_cast<size_t>(bh) * ql * d;

  for (int i = tid; i < QL * kMaxD; i += kThreads) {
    const int r = i / kMaxD, c = i - r * kMaxD;
    q_s[r][c] = (r < ql && c < d) ? to_float(q[q_off + r * d + c]) : 0.f;
  }
  __syncthreads();

  // Lane `lane` owns elements ch * kChunk + lane * E + e of every row; with
  // d % E == 0 those are all in range or all out of it.
  const int n_chunks = (d + kChunk - 1) / kChunk;
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
        if (base + u < n_valid && ch < n_chunks && c < d) {
          const size_t row = static_cast<size_t>(base + u) * d + c;
          load_row<T, E>(kb + row, kr[u][ch]);
          load_row<T, E>(vb + row, vr[u][ch]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kr[u][ch][e] = vr[u][ch][e] = 0.f;
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
    if (r >= ql) break;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int c = ch * kChunk + lane * E + e;
        if (c < kMaxD) acc_s[warp][c] = acc[r][ch][e];
      }
    __syncthreads();
    if (tid < d) {
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
      out[q_off + r * d + tid] = from_float<T>(num / den);
    }
    __syncthreads();
  }
}

template <typename T, int QL>
int launch_rows(const void* q, const void* k, const void* v, const void* lens,
                void* out, int b, int h, int ql, int cap, int d, float scale,
                cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* lp = static_cast<const int*>(lens);
  auto* op = static_cast<T*>(out);
  if (vec)
    decode_attention_kernel<T, QL, kVec><<<b * h, kThreads, 0, stream>>>(
        qp, kp, vp, lp, op, h, ql, cap, d, scale);
  else
    decode_attention_kernel<T, QL, 1><<<b * h, kThreads, 0, stream>>>(
        qp, kp, vp, lp, op, h, ql, cap, d, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* out, int b, int h, int ql, int cap, int d, float scale,
           void* stream) {
  if (b < 1 || h < 1 || cap < 1 || ql < 1 || ql > kMaxQ || d < 1 ||
      d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (ql == 1)
    return launch_rows<T, 1>(q, k, v, lens, out, b, h, ql, cap, d, scale, s);
  if (ql == 2)
    return launch_rows<T, 2>(q, k, v, lens, out, b, h, ql, cap, d, scale, s);
  if (ql <= 4)
    return launch_rows<T, 4>(q, k, v, lens, out, b, h, ql, cap, d, scale, s);
  return launch_rows<T, 8>(q, k, v, lens, out, b, h, ql, cap, d, scale, s);
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream` (a cudaStream_t) on
// the calling thread's current device, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" {

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lens, void* out, int b, int h, int ql,
                         int cap, int d, float scale, void* stream) {
  return launch<float>(q, k, v, lens, out, b, h, ql, cap, d, scale, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lens, void* out, int b, int h, int ql,
                          int cap, int d, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lens, out, b, h, ql, cap, d, scale,
                               stream);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
