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
// every head of its sequence. A launch of the tuned kernels takes query rows
// [row0, row0 + rows) of q, rows <= 8; the query rows do
// not attend to each other, so a caller with more rows launches once per
// group of 8 and the groups write disjoint rows of out. The wide entry takes
// every row in one call.
//
// Which kernel takes a call (the C entries at the end):
//   * k and v of one dtype (f32, bf16 or f16) with d, dv <= 256, every K
//     and V row a whole number of 16-byte chunks and k and v on 16-byte
//     boundaries, q in that dtype or in another, entries
//     decode_attention_{f32,bf16,f16} (named by the cache's dtype):
//     `decode_ring_kernel` below (and, where the cache is split, the merge
//     of wide_attention.cuh). q is read once a row by a run-time code and
//     out written in q's dtype, so a 16-bit cache under an f32 query
//     streams as fast as under a 16-bit one;
//   * q, k and v all bf16 or all f16, d or dv over 256, d <= 576 and
//     dv <= 512 (the wrapper zero-pads both to multiples of 16): the wide
//     tensor-core kernel of wide_attention.cuh and its merge, entries
//     decode_attention_wide_{bf16,f16} (its note says what bounds it and
//     what its design does about that: at absorbed MLA's 128 query rows
//     each key feeds 128 x 1,088 multiply-adds, which is work for `wgmma`,
//     not for a SIMT loop);
//   * q, k and v all f32, d or dv over 256, d <= 576 and dv <= 512 (padded
//     the same way): the f32 tensor-core kernel of f32tc_attention.cuh and
//     the wide path's merge, entry decode_attention_f32tc, every query row
//     in one call, each f32 product as three TF32 products (3xTF32);
//   * q in a dtype apart from the one k and v share, d or dv over 256 (up
//     to padded 576/512): the same f32 tensor-core body built for 16-bit q
//     or K and V, in mixed_decode.cu (a source of its own: its own nvcc
//     job);
//   * anything else (k and v in different dtypes; rows that are not whole
//     16-byte chunks, such as d = 66 in 16 bits or an odd d in f32; a cache
//     view that starts off a 16-byte boundary; head dims past the wide, f32
//     and mixed kernels'): the any-dtype kernel of stream_decode.cu (its own
//     nvcc job), every query row in one call.
//
// What bounds the ring kernel: device-memory bytes. Every valid K and V row
// is read once, (d + dv) * sizeof(T) bytes per key per head (1 KiB at d =
// 128 in f32), and each element feeds only ql <= 8 multiply-adds, far below
// the operations per byte at which the card's arithmetic would become the
// limit. The walk ends at key min(len, cap) - 1, so the masked tail of the
// padded cache is never read. (The TPU kernel walks all cap / block_k
// blocks; a fully masked block only adds exp(-inf) = 0 with a correction of
// 1, so skipping it changes no output.) The number of query rows is a
// template parameter, so that the engine's ql = 1 spends no registers on
// rows it does not have. Its design:
//   * bytes in flight that cost no registers or issue slots: one producer
//     warp, one lane of it, keeps a 3-stage ring of K and V tiles in flight
//     into shared memory with the 1-D bulk copy (`cp.async.bulk`, UBLKCP in
//     the SASS), completing on mbarriers. A (b h)'s cache is one contiguous
//     [cap, d] span, so a tile of T keys is one copy of T d sizeof(T) bytes
//     (and one of V); the last tile copies only its valid keys, and nothing
//     at or past min(len, cap) is read. A stage is 32 KiB (T = 64 at d = 128
//     in 16 bits, 16 at d = 256 in f32), 96 KiB a block, two blocks an SM;
//   * every lane working: 4 consumer warps compute from shared memory. A
//     key takes G = 8, 16 or 32 lanes, C = 1 (or, for an f32 row of 33-64
//     chunks, 2) 16-byte chunks of its K row and of its V row each (G = 16
//     at d = 128 in 16 bits: a warp reads two keys' 512 contiguous bytes a
//     load, with no bank conflict); q.k sums over G lanes (log2 G shuffles),
//     so every lane of the warp works. Each lane group keeps its own online
//     softmax (base-2 max, denominator and C chunks of the accumulator in
//     f32) over U keys a step, p rounded to V's dtype before P V; the
//     block's 4 x 32 / G softmaxes merge once, at the end, through the
//     emptied ring;
//   * split-KV when b h leaves SMs idle: blocks (b h, split), the split
//     count sized by the wrapper from the shapes and the SM count alone
//     (`tuned_decode_splits`), one split at the serve shape (1,024 blocks);
//     with more, each block writes an f32 partial (O, base-2 max, l) and the
//     wide path's merge kernel combines them.
// Against a block per (b, h) with each warp loading its own keys from global
// memory, on an H100 (PERF.md): the f16 serve shape 0.836 -> 0.357 ms; the
// f32 serve shape 0.732-0.736 -> 0.696-0.705 ms in one call's interleaved
// turns (`chip_ab.py decode`); f32 rows of 129-256 (C = 2) in `chip_ab.py
// perwarp`.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "f32tc_attention.cuh"
#include "wide_attention.cuh"

namespace {

constexpr int kMaxQ = 8;    // query rows per launch
constexpr int kMaxD = 256;  // head dims (d, dv)

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

// The dtype codes of the entries (the wrapper's): f32, bf16, f16.
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

// ---- the ring kernel: 16-bit (and f32) rows streamed through shared memory

namespace ring {

constexpr int kConsumers = 4;                     // consumer warps a block
constexpr int kThreads = 32 * (kConsumers + 1);   // and one producer warp
constexpr int kStages = 3;                        // tiles in flight a block
constexpr int kStageBytes = 32 * 1024;            // a K tile and a V tile
constexpr int kQOffset = kStages * kStageBytes + 64;  // after the barriers
constexpr float kLog2e = 1.4426950408889634f;

// Whether a kernel of QL query rows holds q as f32 in shared memory rather
// than in registers (at 8 rows of 16 bits, q in registers made ptxas spill
// 176-488 bytes a thread under the 168 registers that two blocks an SM
// leave; `chip_ab.py ring-variants`); and its dynamic shared memory: the
// ring, its barriers and q.
__host__ __device__ constexpr bool q_in_smem(int ql) { return ql >= 8; }
__host__ __device__ constexpr int smem_bytes(int ql) {
  return kQOffset + (q_in_smem(ql) ? ql * kMaxD * 4 : 0);
}

// Keys a tile when a K or V row is at most `lanes` x `chunks` 16-byte
// chunks: two rows a key, so a stage never holds more than kStageBytes.
__host__ __device__ constexpr int tile_keys(int lanes, int chunks) {
  return kStageBytes / (2 * 16 * lanes * chunks);
}

// The form that takes this call, lanes a key (8, 16 or 32) and chunks a
// lane (1, or 2 for an f32 row of 33-64 chunks: d or dv from 129 to 256),
// or lanes 0 where the ring kernel does not take it: a K or V row whose
// byte width is not a multiple of 16, k or v not on a 16-byte boundary, or
// a row of more than 64 chunks.
struct Form {
  int lanes, chunks;
};

template <typename T>
Form form_for(const void* k, const void* v, int d, int dv) {
  constexpr int kChunk = 16 / sizeof(T);  // elements a 16-byte chunk
  if (d % kChunk || dv % kChunk || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return {0, 0};
  const int chunks = max(d, dv) / kChunk;
  if (chunks > 64) return {0, 0};
  if (chunks > 32) return {32, 2};
  return {chunks <= 8 ? 8 : chunks <= 16 ? 16 : 32, 1};
}

// Sum over the G lanes of an aligned group (xor offsets below G stay in it).
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A 16-byte chunk of T as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
    f[i] = to_float(e[i]);
}

struct Call {
  const void *q, *k, *v;
  const int* lens;
  void* out;
  float *part_o, *part_ml;
  int b, h, ql, row0, rows, cap, d, dv, splits, split_keys;
  float scale;
  int q_type;
};

// Block (bh, split) takes keys [split split_keys, (split + 1) split_keys)
// of (b h) bh's cache, stopping at min(len, cap). T: K's and V's element
// type; q and out are in the dtype of code q_type (T's, or another: q is
// read once a row and converted to f32, out written once). QL: query rows
// built for (rows <= QL); G: lanes a key; C: 16-byte chunks a lane holds of
// the key's K row and of its V row (chunks c, c + G, ...: for each j a
// group reads 16 G contiguous bytes).
template <typename T, int QL, int G, int C>
__global__ void __launch_bounds__(kThreads, 2)
    decode_ring_kernel(const void* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ lens,
                       void* __restrict__ out, float* __restrict__ part_o,
                       float* __restrict__ part_ml, int h, int ql, int row0,
                       int rows, int cap, int d, int dv, float scale_log2,
                       int split_keys, int q_type) {
  constexpr int E = 16 / sizeof(T);             // elements a chunk
  constexpr int NG = 32 / G;                    // lane groups a warp
  constexpr int U = QL >= 4 ? 2 : 4;            // keys a group takes a step
  constexpr bool kQSmem = q_in_smem(QL);
  constexpr int kStepKeys = NG * U;             // keys a warp takes a step
  constexpr int kTile = tile_keys(G, C);
  constexpr int kWarpKeys = kTile / kConsumers;  // a warp's share of a tile
  constexpr int kStates = kConsumers * NG;      // online softmaxes a block
  static_assert(kWarpKeys % kStepKeys == 0, "a warp's share in whole steps");

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring_s = smem_u32(smem);
  const uint32_t bars = ring_s + kStages * kStageBytes;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  const int bh = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_valid = min(lens[bh / h], cap);
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, n_valid);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile : 0;
  const int d_bytes = d * static_cast<int>(sizeof(T));
  const int dv_bytes = dv * static_cast<int>(sizeof(T));
  const int v_off = kTile * d_bytes;  // a stage's V tile, after its K tile

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // Producer: one lane keeps up to kStages tiles in flight, each tile one
    // bulk copy of its K rows and one of its V rows (a (b h)'s rows are
    // contiguous); the last tile copies only its valid keys.
    if (lane == 0) {
      const T* kb = k + static_cast<size_t>(bh) * cap * d;
      const T* vb = v + static_cast<size_t>(bh) * cap * dv;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const int key = k_begin + t * kTile;
        const int n = min(kTile, k_end - key);
        mbar_wait(empty(st), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full(st), n * (d_bytes + dv_bytes));
        bulk_load(ring_s + st * kStageBytes, kb + static_cast<size_t>(key) * d,
                  n * d_bytes, full(st));
        bulk_load(ring_s + st * kStageBytes + v_off,
                  vb + static_cast<size_t>(key) * dv, n * dv_bytes, full(st));
      }
    }
    return;
  }

  // Consumers. Lane (g, c): chunks c + j G (j < C) of the keys of group g.
  const int g = lane / G, c = lane % G;
  bool k_lane[C], v_lane[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    k_lane[j] = (c + j * G) * E < d;
    v_lane[j] = (c + j * G) * E < dv;
  }
  const size_t q_off = (static_cast<size_t>(bh) * ql + row0) * d;
  // q as f32: the lane's chunks of each row in registers, or every row in
  // shared memory ([QL][kMaxD], zeros past d and rows), read a chunk a row
  // a step.
  float qf[kQSmem ? 1 : QL][C][E];
  float* const qs = reinterpret_cast<float*>(smem + kQOffset);
  if constexpr (kQSmem) {
    for (int i = threadIdx.x; i < QL * kMaxD; i += 32 * kConsumers) {
      const int r = i / kMaxD, col = i - r * kMaxD;
      qs[i] = r < rows && col < d ? load_any(q, q_type, q_off + r * d + col)
                                  : 0.f;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
  } else {
#pragma unroll
    for (int r = 0; r < QL; ++r)
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          qf[r][j][e] =
              r < rows && k_lane[j]
                  ? load_any(q, q_type, q_off + r * d + (c + j * G) * E + e)
                  : 0.f;
  }

  // Each group's online softmax: base-2 running max, denominator and
  // accumulator, the same in the group's lanes but for the accumulator's
  // chunks.
  float m[QL], l[QL], acc[QL][C][E];
#pragma unroll
  for (int r = 0; r < QL; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][j][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int n = min(kTile, k_end - (k_begin + t * kTile));
    mbar_wait(full(st), (t / kStages) & 1);
    const unsigned char* ks = smem + st * kStageBytes;
    const unsigned char* vs = ks + v_off;
    // At 8 rows one step at a time: unrolled, ptxas spilled (PERF.md).
#pragma unroll (QL >= 8 ? 1 : kWarpKeys / kStepKeys)
    for (int step = 0; step < kWarpKeys / kStepKeys; ++step) {
      // A step's keys: NG consecutive rows a load, so a warp reads one
      // contiguous span; key0 + u NG + g for group g.
      const int key0 = warp * kWarpKeys + step * kStepKeys;
      if (key0 >= n) break;
      float kf[U][C][E], vf[U][C][E];
      bool valid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = key0 + u * NG + g;
        valid[u] = key < n;
        // Past the tile's valid keys the stage holds an older tile or
        // nothing yet: read zeros instead.
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int at = (c + j * G) * 16;
          uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
          if (valid[u] && k_lane[j])
            kr = *reinterpret_cast<const uint4*>(ks + key * d_bytes + at);
          if (valid[u] && v_lane[j])
            vr = *reinterpret_cast<const uint4*>(vs + key * dv_bytes + at);
          unpack<T>(kr, kf[u][j]);
          unpack<T>(vr, vf[u][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < QL; ++r) {
        float qr[C][E];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          if constexpr (kQSmem) {
            const float4* qp = reinterpret_cast<const float4*>(
                qs + r * kMaxD + (c + j * G) * E);
#pragma unroll
            for (int i = 0; i < E / 4; ++i) {
              const float4 x = qp[i];
              qr[j][4 * i] = x.x;
              qr[j][4 * i + 1] = x.y;
              qr[j][4 * i + 2] = x.z;
              qr[j][4 * i + 3] = x.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) qr[j][e] = qf[kQSmem ? 0 : r][j][e];
          }
        }
        float s[U], mx = -CUDART_INF_F;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < C; ++j)
#pragma unroll
            for (int e = 0; e < E; ++e)
              part = fmaf(qr[j][e], kf[u][j][e], part);
          part = group_sum<G>(part);
          s[u] = valid[u] ? part * scale_log2 : -CUDART_INF_F;
          mx = fmaxf(mx, s[u]);
        }
        // Until a group has seen a valid key its max stays -inf: offset by
        // 0 then, so that no exp2 sees -inf - -inf (p and corr are 0).
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
        const float corr = fast_exp2(m[r] - m_use);
        float p[U], psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float pu = fast_exp2(s[u] - m_use);
          psum += pu;
          p[u] = to_float(from_float<T>(pu));  // p in V's dtype for PV
        }
        l[r] = l[r] * corr + psum;
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < C; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float a = acc[r][j][e] * corr;
#pragma unroll
            for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][j][e], a);
            acc[r][j][e] = a;
          }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // Merge the block's kStates softmaxes: weights 2^(m_s - max m), a state
  // that saw no key weighing 0. Every consumer has read its last tile, so
  // the ring's first bytes hold the states: m and l [QL][kStates], then
  // acc [QL][kStates][dv].
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
  float* const ms = reinterpret_cast<float*>(smem);
  float* const ls = ms + QL * kStates;
  float* const as = ls + QL * kStates;
  const int state = warp * NG + g;
#pragma unroll
  for (int r = 0; r < QL; ++r) {
    if (c == 0) {
      ms[r * kStates + state] = m[r];
      ls[r * kStates + state] = l[r];
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (v_lane[j]) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          as[(r * kStates + state) * dv + (c + j * G) * E + e] = acc[r][j][e];
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
  const size_t o_off = (static_cast<size_t>(bh) * ql + row0) * dv;
  for (int i = threadIdx.x; i < rows * dv; i += 32 * kConsumers) {
    const int r = i / dv, col = i - r * dv;
    float m_tot = -CUDART_INF_F;
#pragma unroll
    for (int sn = 0; sn < kStates; ++sn)
      m_tot = fmaxf(m_tot, ms[r * kStates + sn]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int sn = 0; sn < kStates; ++sn) {
      const float mw = ms[r * kStates + sn];
      const float wt = mw == -CUDART_INF_F ? 0.f : fast_exp2(mw - m_tot);
      num = fmaf(wt, as[(r * kStates + sn) * dv + col], num);
      den = fmaf(wt, ls[r * kStates + sn], den);
    }
    if (splits == 1) {
      // len <= 0 leaves every state empty and 0 / 0 = NaN, as the plain
      // version gives.
      store_any(out, q_type, o_off + static_cast<size_t>(r) * dv + col,
                num / den);
    } else {
      // An f32 partial for the merge: O unnormalised, (max, denominator).
      const size_t part = (static_cast<size_t>(bh) * splits + split) * rows + r;
      part_o[part * dv + col] = num;
      if (col == 0) {
        part_ml[part * 2] = m_tot;
        part_ml[part * 2 + 1] = den;
      }
    }
  }
}

template <typename T, int QL, int G, int C>
int launch_as(const Call& a, cudaStream_t stream) {
  const auto kernel = decode_ring_kernel<T, QL, G, C>;
  constexpr int kSmem = smem_bytes(QL);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.b * a.h, a.splits);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lens,
      a.out, a.part_o, a.part_ml, a.h, a.ql, a.row0, a.rows, a.cap, a.d,
      a.dv, a.scale * kLog2e, a.split_keys, a.q_type);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  // The merge writes out in q's dtype.
  const auto merge = [&](auto* out) {
    using E = std::remove_pointer_t<decltype(out)>;
    wide::wide_decode_merge_kernel<E><<<a.b * a.h * a.rows, 128, 0, stream>>>(
        a.part_o, a.part_ml, out, a.rows, a.dv, a.splits, a.ql, a.row0);
  };
  if (a.q_type == kBF16)
    merge(static_cast<__nv_bfloat16*>(a.out));
  else if (a.q_type == kF16)
    merge(static_cast<__half*>(a.out));
  else
    merge(static_cast<float*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int QL>
int launch_form(const Call& a, Form f, cudaStream_t stream) {
  // Two chunks a lane only where a row is over 32 chunks: f32 past 128.
  if constexpr (sizeof(T) == 4)
    if (f.chunks == 2) return launch_as<T, QL, 32, 2>(a, stream);
  if (f.lanes == 8) return launch_as<T, QL, 8, 1>(a, stream);
  if (f.lanes == 16) return launch_as<T, QL, 16, 1>(a, stream);
  return launch_as<T, QL, 32, 1>(a, stream);
}

template <typename T>
int launch(const Call& a, Form f, cudaStream_t stream) {
  if (a.rows == 1) return launch_form<T, 1>(a, f, stream);
  if (a.rows == 2) return launch_form<T, 2>(a, f, stream);
  if (a.rows <= 4) return launch_form<T, 4>(a, f, stream);
  return launch_form<T, 8>(a, f, stream);
}

}  // namespace ring

// The tuned entries: the ring kernel, its splits checked against its tile.
// A call it does not take (rows not whole 16-byte chunks, a cache off a
// 16-byte boundary) is refused: the wrapper sends those to the any-dtype
// decode (stream_decode.cu).
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* out, void* part_o, void* part_ml, int b, int h, int ql,
           int row0, int rows, int cap, int d, int dv, float scale,
           int splits, int split_keys, int q_type, void* stream) {
  if (b < 1 || h < 1 || cap < 1 || rows < 1 || rows > kMaxQ || row0 < 0 ||
      row0 + rows > ql || d < 1 || d > kMaxD || dv < 1 || dv > kMaxD ||
      splits < 1 || q_type < kF32 || q_type > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const ring::Form form = ring::form_for<T>(k, v, d, dv);
  if (form.lanes == 0) return static_cast<int>(cudaErrorInvalidValue);
  // Splits of whole tiles that cover the cache, none empty by construction;
  // a workspace when there is more than one.
  const int tile = ring::tile_keys(form.lanes, form.chunks);
  if (split_keys < tile || split_keys % tile != 0 || splits > 65535 ||
      static_cast<long long>(splits - 1) * split_keys >= cap ||
      static_cast<long long>(splits) * split_keys < cap ||
      static_cast<long long>(b) * h * rows > 0x7fffffff ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  ring::Call a{q, k, v, static_cast<const int*>(lens), out,
               static_cast<float*>(part_o), static_cast<float*>(part_ml),
               b, h, ql, row0, rows, cap, d, dv, splits, split_keys, scale,
               q_type};
  return ring::launch<T>(a, form, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entries for ctypes. Each launches on `stream` (a cudaStream_t) on
// the calling thread's current device, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" {

// The tuned path, entries named by K's and V's dtype: the ring kernel, d
// and dv up to 256 on K and V rows of whole 16-byte chunks that start on
// 16-byte boundaries (anything else is refused), query rows [row0, row0 +
// rows) of q, rows <= 8. Split s takes keys [s split_keys, (s + 1)
// split_keys), split_keys a multiple of its tile (the wrapper's
// tuned_decode_tile), and with more than one split part_o and part_ml are
// the f32 partials' workspace, [b h, splits, rows, dv] and [b h, splits,
// rows, 2]. q_type (0 f32, 1 bf16, 2 f16) is q's and out's dtype: the
// entry's own, or another.

int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lens, void* out, void* part_o,
                         void* part_ml, int b, int h, int ql, int row0,
                         int rows, int cap, int d, int dv, float scale,
                         int splits, int split_keys, int q_type,
                         void* stream) {
  return launch<float>(q, k, v, lens, out, part_o, part_ml, b, h, ql, row0,
                       rows, cap, d, dv, scale, splits, split_keys, q_type,
                       stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lens, void* out, void* part_o,
                          void* part_ml, int b, int h, int ql, int row0,
                          int rows, int cap, int d, int dv, float scale,
                          int splits, int split_keys, int q_type,
                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lens, out, part_o, part_ml, b, h,
                               ql, row0, rows, cap, d, dv, scale, splits,
                               split_keys, q_type, stream);
}

int decode_attention_f16(const void* q, const void* k, const void* v,
                         const void* lens, void* out, void* part_o,
                         void* part_ml, int b, int h, int ql, int row0,
                         int rows, int cap, int d, int dv, float scale,
                         int splits, int split_keys, int q_type,
                         void* stream) {
  return launch<__half>(q, k, v, lens, out, part_o, part_ml, b, h, ql,
                        row0, rows, cap, d, dv, scale, splits, split_keys,
                        q_type, stream);
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

// The f32 path (f32tc_attention.cuh): q, k and v all f32 on the tensor
// cores in 3xTF32, d and dv multiples of 16 up to 576 and 512 with one of
// them over 256, every query row in one call; the arguments are the wide
// path's, and split_keys is a multiple of 64.
int decode_attention_f32tc(const void* q, const void* k, const void* v,
                           const void* lens, void* out, void* part_o,
                           void* part_ml, int b, int h, int ql, int cap,
                           int d, int dv, float scale, int splits,
                           int split_keys, void* stream) {
  return f32tc::launch_decode<false, false>(
      q, k, v, lens, out, part_o, part_ml, b, h, ql, cap, d, dv, scale,
      splits, split_keys, 0, 0, static_cast<cudaStream_t>(stream));
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
