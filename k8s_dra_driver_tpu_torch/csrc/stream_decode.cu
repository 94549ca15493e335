// Decode attention for NVIDIA Hopper (sm_90a) at any head dims and in any
// mix of dtypes: the calls that the tuned, wide, f32 and mixed decode
// kernels do not take (K and V in different dtypes; head dims past padded
// 576/512; rows the ring kernel does not take, such as d = 66 in 16 bits or
// an odd d in f32, whatever q's dtype; a cache view that starts off a
// 16-byte boundary).
//
// It replaces, for those calls, the TPU kernel `_decode_kernel`, reached
// through `flash_attention_decode` (k8s_dra_driver_tpu/compute/
// flashattention.py), and computes its function: scores q.k accumulated in
// f32 and scaled by 1/sqrt(d); keys at index >= kv_lengths[b] masked; an
// online softmax with f32 running max and denominator (base 2); p rounded to
// V's dtype before P V, which accumulates in f32; the output in q's dtype.
// q, k and v are each f32, bf16 or f16: q by a code read at run time (once a
// row), K and V by the kernel's template arguments.
//
// What bounds it: device-memory bytes. Every valid K and V row is read once,
// d sizeof(K) + dv sizeof(V) bytes a key, and each element feeds one
// multiply-add per query row (at most 8 in a block), far below the
// operations per byte at which arithmetic would become the limit. The design
// (the tuned ring kernel's, decode_attention.cu, generalised to any widths):
//   * one block per (b h, split, group of up to 8 query rows); the rows of
//     a call are a grid dimension, so one launch takes every row, and a
//     block reads its split's valid K and V rows once each, whole d and whole
//     dv, whatever their widths (the kernel it replaces re-read all of K for
//     every 256 output columns);
//   * one producer lane keeps a ring of 3 stages in flight, each a tile of T
//     keys' K rows and V rows, each operand in its own dtype, with the 1-D
//     bulk copy (`cp.async.bulk`: a (b h)'s cache is one contiguous span, so
//     a tile is one copy of K and one of V). Where a row is not a whole
//     number of 16-byte chunks or k or v starts off a 16-byte boundary (a
//     compile-time variant), the same lane bulk-copies the whole 16-byte
//     chunks around each span, and the consumers read the span from where
//     it starts in its first chunk: the same bytes in flight as whole rows
//     have (scalar copies by the producer warp's 32 lanes kept a few
//     hundred bytes in flight a block). Nothing of a key
//     at or past min(len, cap) is used, and no 16-byte chunk is read that
//     holds none of a tile's valid bytes;
//   * T, the rows a block takes and so the ring's size come from the
//     wrapper (`stream_decode_plan`): as many keys a tile (up to 64) as fit
//     two blocks an SM, else one;
//   * per tile, two phases. S: each of the 8 consumer warps takes keys of
//     the tile in turn, its lanes across d (16-byte chunks of the row),
//     converts K in registers and dots it with q, which is held as f32 in
//     shared memory, then sums over the warp (in the variant whose rows
//     start off 16-byte boundaries a key takes 4-32 lanes, about two of its
//     chunks a lane, each chunk shifted out of the two stage chunks it
//     spans, so that a narrow row such as d = 66 keeps the lanes busy and
//     sums over fewer shuffles).
//     Softmax: warp r takes query row r: the tile's max, the correction and
//     p = 2^(s - m), rounded to V's dtype, back into shared memory. P V:
//     each thread owns 4 columns of dv (and every 1,024th after) and a key
//     group (where dv leaves threads over, the threads split the tile's keys
//     into groups: 8 at dv = 128), and accumulates its columns of every row
//     in registers over its keys of the tile from the stage's V rows and p,
//     then stores them to its group's O in shared memory (f32, [groups,
//     rows, dv], the groups summed at the end);
//   * split-KV: the cache is split across blocks by a count the wrapper takes
//     from the shapes and the SM count alone (never the lengths), each split
//     an f32 partial (O, base-2 max, denominator) that the wide path's merge
//     kernel combines; with one split the block writes the output itself.
// There is no fallback: a call that cannot launch raises in the wrapper.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wide_attention.cuh"

namespace {
namespace stream {

constexpr int kConsumers = 8;                    // consumer warps a block
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kStages = 3;                       // tiles in flight a block
constexpr int kMaxRows = 8;                      // query rows a block
constexpr int kMaxTile = 64;                     // keys a tile
constexpr int kMaxSmem = 232448;                 // 227 KB a block
constexpr float kLog2e = 1.4426950408889634f;
// The wrapper's dtype codes.
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }

// x rounded to T, as f32 (p in V's dtype; a no-op for f32).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(__float2bfloat16(x));
  else if constexpr (std::is_same<T, f16>::value)
    return __half2float(__float2half(x));
  else
    return x;
}

// Element i of q (code `type`), and element i of out written in it.
__device__ __forceinline__ float load_code(const void* p, int type,
                                           size_t i) {
  if (type == kBF16) return __bfloat162float(static_cast<const bf16*>(p)[i]);
  if (type == kF16) return __half2float(static_cast<const f16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_code(void* p, int type, size_t i,
                                           float x) {
  if (type == kBF16)
    static_cast<bf16*>(p)[i] = __float2bfloat16(x);
  else if (type == kF16)
    static_cast<f16*>(p)[i] = __float2half(x);
  else
    static_cast<float*>(p)[i] = x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// A 16-byte chunk of T as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw,
                                       float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i) f[i] = to_f(e[i]);
}

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// The block's dynamic shared memory, in bytes from its start: the ring
// (kStages stages of a K tile then a V tile, each `pad` bytes longer where
// a tile's span is copied as the 16-byte chunks around it), the barriers, q
// as f32 [rows, d], O as f32 [key groups, rows, dvo], two buffers of
// scores/p [tile, 8], two of the rows' corrections and the rows' (max,
// denominator).
struct Layout {
  int pad, dq, stage, v_off, bars, q, o, s, corr, ml, total;
};

// The key groups of the P V phase: the consumer threads a group of dvo / 4
// (each 4 columns of every row), as many groups as the threads hold, each
// taking every kg-th key of a tile into its own partial O (summed at the
// end); one group past 1,024 columns.
__host__ __device__ constexpr int key_groups(int dvo) {
  return dvo / 4 >= 32 * kConsumers ? 1 : (32 * kConsumers) / (dvo / 4);
}

__host__ __device__ inline Layout layout(int tile, int rows, int d, int dv,
                                         int dvo, int k_size, int v_size,
                                         int pad) {
  Layout s{};
  s.pad = pad;
  // q's row stride: d, or d rounded up to 8 (zeros past d) where rows are
  // read as the 16-byte chunks around them, so that a chunk's q is whole
  // float4s.
  s.dq = pad ? (d + 7) & ~7 : d;
  s.v_off = align16(tile * d * k_size) + pad;
  s.stage = s.v_off + align16(tile * dv * v_size) + pad;
  s.bars = kStages * s.stage;
  s.q = s.bars + align16(2 * kStages * 8);
  s.o = s.q + align16(rows * s.dq * 4);
  s.s = s.o + align16(key_groups(dvo) * rows * dvo * 4);
  s.corr = s.s + 2 * tile * kMaxRows * 4;
  s.ml = s.corr + 2 * kMaxRows * 4;
  s.total = s.ml + 2 * kMaxRows * 4;
  return s;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lens;
  void* out;
  float* part_o;
  float* part_ml;
  int h, ql, rows, cap, d, dv, dvo, tile, split_keys, q_type;
  int key_lanes;  // lanes a key in S where rows are read off their chunks
  float scale_log2;
  Layout lay;
};

// The byte at which a span of global memory starts in its first 16-byte
// chunk: where the span lands in a stage that holds the chunks around it.
__device__ __forceinline__ int chunk_offset(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// The 16 bytes that start `off` bytes (0-15, a multiple of 2) into chunk
// lo and run on into chunk hi: the words are picked by selects (no
// register array indexed at run time) and shifted across word edges.
__device__ __forceinline__ uint4 bytes_at(const uint4& lo, const uint4& hi,
                                          int off) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = off >> 2;
  const uint32_t bits = (off & 3) * 8;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    x[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(x[0], x[1], bits),
                    __funnelshift_r(x[1], x[2], bits),
                    __funnelshift_r(x[2], x[3], bits),
                    __funnelshift_r(x[3], x[4], bits));
}

// Block (bh, split, group): query rows [group rows, + rows) of (b h) bh
// against keys [split split_keys, (split + 1) split_keys) of its cache,
// stopping at min(len, cap). TK, TV: K's and V's element types. kBulk: every
// K and V row whole 16-byte chunks and k and v on 16-byte boundaries (each
// tile's K and V spans bulk-copied as they are, 16-byte reads), else each
// span bulk-copied as the whole 16-byte chunks around it (a span then
// starts chunk_offset bytes into its stage buffer) and its rows read off
// those chunks (`bytes_at`).
template <typename TK, typename TV, bool kBulk>
__global__ void __launch_bounds__(kThreads)
    stream_decode_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout& lay = a.lay;
  const uint32_t bars = smem_u32(smem) + lay.bars;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  const int bh = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int row0 = blockIdx.z * a.rows;
  const int rows = min(a.rows, a.ql - row0);
  const int d = a.d, dv = a.dv, dvo = a.dvo, tile = a.tile;
  const int n_valid = min(a.lens[bh / a.h], a.cap);
  const int k_begin = split * a.split_keys;
  const int k_end = min(k_begin + a.split_keys, n_valid);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + tile - 1) / tile
                                      : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const TK* const kb = static_cast<const TK*>(a.k) +
                       static_cast<size_t>(bh) * a.cap * d;
  const TV* const vb = static_cast<const TV*>(a.v) +
                       static_cast<size_t>(bh) * a.cap * dv;
  if (warp == kConsumers) {
    // Producer: tile t into stage t % kStages, its K rows then its V rows;
    // the last tile copies only its valid keys.
    if (lane != 0) return;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int key = k_begin + t * tile;
      const int n = min(tile, k_end - key);
      const int k_bytes = n * d * static_cast<int>(sizeof(TK));
      const int v_bytes = n * dv * static_cast<int>(sizeof(TV));
      const TK* ksrc = kb + static_cast<size_t>(key) * d;
      const TV* vsrc = vb + static_cast<size_t>(key) * dv;
      unsigned char* const dst = smem + st * lay.stage;
      mbar_wait(empty(st), ((t / kStages) & 1) ^ 1);
      if constexpr (kBulk) {
        mbar_expect_tx(full(st), k_bytes + v_bytes);
        bulk_load(smem_u32(dst), ksrc, k_bytes, full(st));
        bulk_load(smem_u32(dst + lay.v_off), vsrc, v_bytes, full(st));
      } else {
        // The whole 16-byte chunks around each span (the bulk copy's
        // source, size and destination are all 16-byte aligned). A chunk
        // that holds a byte of the tensor lies in the same page as that
        // byte, so reading the rest of it is safe; those bytes are never
        // used.
        const int ko = chunk_offset(ksrc), vo = chunk_offset(vsrc);
        const int k_span = align16(ko + k_bytes);
        const int v_span = align16(vo + v_bytes);
        mbar_expect_tx(full(st), k_span + v_span);
        bulk_load(smem_u32(dst),
                  reinterpret_cast<const unsigned char*>(ksrc) - ko, k_span,
                  full(st));
        bulk_load(smem_u32(dst + lay.v_off),
                  reinterpret_cast<const unsigned char*>(vsrc) - vo, v_span,
                  full(st));
      }
    }
    return;
  }

  // Consumers: q as f32, O zeroed.
  float* const q_s = reinterpret_cast<float*>(smem + lay.q);
  float* const o_s = reinterpret_cast<float*>(smem + lay.o);
  float* const s_s = reinterpret_cast<float*>(smem + lay.s);
  float* const c_s = reinterpret_cast<float*>(smem + lay.corr);
  float* const ml_s = reinterpret_cast<float*>(smem + lay.ml);
  const int tid = threadIdx.x;
  constexpr int kCT = 32 * kConsumers;
  const size_t q_off = (static_cast<size_t>(bh) * a.ql + row0) * d;
  const int dq = lay.dq;
  for (int i = tid; i < rows * dq; i += kCT) {
    const int r = i / dq, col = i - r * dq;
    q_s[i] = col < d ? load_code(a.q, a.q_type, q_off + r * d + col) : 0.f;
  }
  const int kg = key_groups(dvo);
  for (int i = tid; i < kg * rows * dvo; i += kCT) o_s[i] = 0.f;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");

  // Warp r's running max (base 2) and denominator of query row r.
  float m = -CUDART_INF_F, l = 0.f;
  const float scale_log2 = a.scale_log2;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int n = min(tile, k_end - (k_begin + t * tile));
    mbar_wait(full(st), (t / kStages) & 1);
    // Where the tile's K and V rows start in the stage (past the bytes
    // before each span in its first chunk, where it was copied so).
    const int key_t = k_begin + t * tile;
    const unsigned char* const ks =
        smem + st * lay.stage +
        (kBulk ? 0 : chunk_offset(kb + static_cast<size_t>(key_t) * d));
    const unsigned char* const vs =
        smem + st * lay.stage + lay.v_off +
        (kBulk ? 0 : chunk_offset(vb + static_cast<size_t>(key_t) * dv));
    float* const sc = s_s + (t & 1) * tile * kMaxRows;
    float* const corr_t = c_s + (t & 1) * kMaxRows;

    // S: key kk's scores of every row into sc[kk][r], times log2(e)/sqrt(d);
    // each lane's products go to two sums (even and odd elements), so that
    // their chains are half as long.
    if constexpr (kBulk) {
      for (int kk = warp; kk < n; kk += kConsumers) {
        float part[2][kMaxRows];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) part[0][r] = part[1][r] = 0.f;
        constexpr int E = 16 / sizeof(TK);
        const uint4* row = reinterpret_cast<const uint4*>(
            ks + static_cast<size_t>(kk) * d * sizeof(TK));
        for (int c = lane; c * E < d; c += 32) {
          float kf[E];
          unpack<TK>(row[c], kf);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r) {
            if (r < rows) {
              const float4* qp =
                  reinterpret_cast<const float4*>(q_s + r * d + c * E);
#pragma unroll
              for (int j = 0; j < E / 4; ++j) {
                const float4 x = qp[j];
                part[0][r] = fmaf(x.x, kf[4 * j], part[0][r]);
                part[1][r] = fmaf(x.y, kf[4 * j + 1], part[1][r]);
                part[0][r] = fmaf(x.z, kf[4 * j + 2], part[0][r]);
                part[1][r] = fmaf(x.w, kf[4 * j + 3], part[1][r]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
            const float s = warp_sum(part[0][r] + part[1][r]);
            if (lane == 0) sc[kk * kMaxRows + r] = s * scale_log2;
          }
        }
      }
    } else {
      // Rows that start off 16-byte boundaries in the stage (rows not whole
      // chunks, or a cache off 16 bytes): a key takes key_lanes lanes (32 /
      // key_lanes keys a warp a pass), and a lane reads chunk c of its row
      // as the two stage chunks it spans, shifted to the row's start, then
      // drops the elements past d (the next row's or stale bytes, which may
      // not be finite). Every lane runs each pass's shuffles.
      constexpr int E = 16 / sizeof(TK);
      const int kl = a.key_lanes, per_warp = 32 / kl;
      const int c0 = lane % kl, chunks = (d + E - 1) / E;
      for (int base = warp * per_warp; base < n;
           base += kConsumers * per_warp) {
        const int kk = base + lane / kl;
        float part[kMaxRows];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) part[r] = 0.f;
        if (kk < n) {
          const uintptr_t at = reinterpret_cast<uintptr_t>(ks) +
                               static_cast<size_t>(kk) * d * sizeof(TK);
          const uint4* row = reinterpret_cast<const uint4*>(at & ~15ull);
          const int off = static_cast<int>(at & 15);
          for (int c = c0; c < chunks; c += kl) {
            float kf[E];
            unpack<TK>(bytes_at(row[c], row[c + 1], off), kf);
#pragma unroll
            for (int e = 0; e < E; ++e)
              if (c * E + e >= d) kf[e] = 0.f;
#pragma unroll
            for (int r = 0; r < kMaxRows; ++r) {
              if (r < rows) {
                const float4* qp =
                    reinterpret_cast<const float4*>(q_s + r * dq + c * E);
#pragma unroll
                for (int j = 0; j < E / 4; ++j) {
                  const float4 x = qp[j];
                  part[r] = fmaf(x.x, kf[4 * j], part[r]);
                  part[r] = fmaf(x.y, kf[4 * j + 1], part[r]);
                  part[r] = fmaf(x.z, kf[4 * j + 2], part[r]);
                  part[r] = fmaf(x.w, kf[4 * j + 3], part[r]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
            float s = part[r];
            for (int o = kl / 2; o > 0; o >>= 1)
              s += __shfl_xor_sync(0xffffffffu, s, o);
            if (c0 == 0 && kk < n) sc[kk * kMaxRows + r] = s * scale_log2;
          }
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");

    // Softmax of row r = warp: p = 2^(s - m) rounded to V's dtype in place
    // (l sums p unrounded), and the factor O is rescaled by.
    if (warp < rows) {
      float mx = -CUDART_INF_F;
      for (int kk = lane; kk < n; kk += 32)
        mx = fmaxf(mx, sc[kk * kMaxRows + warp]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m, mx);
      // Until a row has seen a key its max stays -inf: offset by 0 then.
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      float ps = 0.f;
      for (int kk = lane; kk < n; kk += 32) {
        float* const at = sc + kk * kMaxRows + warp;
        const float p = fast_exp2(*at - m_use);
        ps += p;
        *at = round_to<TV>(p);
      }
      ps = warp_sum(ps);
      const float corr = fast_exp2(m - m_use);
      l = l * corr + ps;
      m = m_new;
      if (lane == 0) corr_t[warp] = corr;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");

    // P V: columns 4 qd .. 4 qd + 3 of every row, this thread's qd, over
    // the keys of its key group g (every kg-th key of the tile) into the
    // group's partial O.
    float corr[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) corr[r] = r < rows ? corr_t[r] : 0.f;
    const int nq = dvo / 4;
    const int g = kg == 1 ? 0 : tid / nq;
    float* const o_g = o_s + static_cast<size_t>(g) * rows * dvo;
    for (int qd = kg == 1 ? tid : tid - g * nq; g < kg && qd < nq;
         qd += kg == 1 ? kCT : nq) {
      const int c0 = 4 * qd;
      float acc[kMaxRows][4];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const float4 o = *reinterpret_cast<const float4*>(o_g + r * dvo + c0);
          acc[r][0] = o.x * corr[r];
          acc[r][1] = o.y * corr[r];
          acc[r][2] = o.z * corr[r];
          acc[r][3] = o.w * corr[r];
        }
      }
#pragma unroll 2
      for (int kk = g; kk < n; kk += kg) {
        float vf[4];
        if constexpr (kBulk) {
          // dv is a multiple of 8 (16-bit V) or 4 (f32): whole quads.
          const unsigned char* vr = vs + (static_cast<size_t>(kk) * dv + c0) *
                                             sizeof(TV);
          if constexpr (sizeof(TV) == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vr);
            vf[0] = x.x;
            vf[1] = x.y;
            vf[2] = x.z;
            vf[3] = x.w;
          } else {
            const uint2 x = *reinterpret_cast<const uint2*>(vr);
            const TV* e = reinterpret_cast<const TV*>(&x);
#pragma unroll
            for (int j = 0; j < 4; ++j) vf[j] = to_f(e[j]);
          }
        } else {
          const TV* vr = reinterpret_cast<const TV*>(vs) +
                         static_cast<size_t>(kk) * dv + c0;
#pragma unroll
          for (int j = 0; j < 4; ++j) vf[j] = c0 + j < dv ? to_f(vr[j]) : 0.f;
        }
        const float4 p0 = *reinterpret_cast<const float4*>(sc + kk * kMaxRows);
        const float4 p1 =
            rows > 4 ? *reinterpret_cast<const float4*>(sc + kk * kMaxRows + 4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        const float pr[kMaxRows] = {p0.x, p0.y, p0.z, p0.w,
                                    p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(pr[r], vf[j], acc[r][j]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows)
          *reinterpret_cast<float4*>(o_g + r * dvo + c0) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // The rows' (max, denominator), then the output (one split) or the f32
  // partial for the merge (O unnormalised; a split that saw no key has max
  // -inf and the merge does not read its O).
  if (warp < rows && lane == 0) {
    ml_s[2 * warp] = m;
    ml_s[2 * warp + 1] = l;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCT) : "memory");
  for (int i = tid; i < rows * dvo; i += kCT) {
    const int r = i / dvo, col = i - r * dvo;
    float o = 0.f;
    for (int g = 0; g < kg; ++g) o += o_s[g * rows * dvo + i];
    if (splits == 1) {
      // No valid key leaves l = 0 and 0 / 0 = NaN, as the plain version.
      store_code(a.out, a.q_type,
                 (static_cast<size_t>(bh) * a.ql + row0 + r) * dvo + col,
                 o / ml_s[2 * r + 1]);
    } else {
      const size_t part =
          (static_cast<size_t>(bh) * splits + split) * a.ql + row0 + r;
      a.part_o[part * dvo + col] = o;
      if (col == 0) {
        a.part_ml[part * 2] = ml_s[2 * r];
        a.part_ml[part * 2 + 1] = ml_s[2 * r + 1];
      }
    }
  }
}

template <typename TK, typename TV, bool kBulk>
int launch_as(const Args& a, int b, int splits, cudaStream_t stream) {
  const auto kernel = stream_decode_kernel<TK, TV, kBulk>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * a.h, splits, (a.ql + a.rows - 1) / a.rows);
  kernel<<<grid, kThreads, a.lay.total, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  // The splits' merge, in q's dtype, over every row of the call.
  const auto merge = [&](auto* out) {
    using E = std::remove_pointer_t<decltype(out)>;
    wide::wide_decode_merge_kernel<E><<<b * a.h * a.ql, 128, 0, stream>>>(
        a.part_o, a.part_ml, out, a.ql, a.dvo, splits, a.ql, 0);
  };
  if (a.q_type == kBF16)
    merge(static_cast<bf16*>(a.out));
  else if (a.q_type == kF16)
    merge(static_cast<f16*>(a.out));
  else
    merge(static_cast<float*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

template <typename TK, typename TV>
int launch_kv(const Args& a, int b, int splits, cudaStream_t stream) {
  return a.lay.pad == 0 ? launch_as<TK, TV, true>(a, b, splits, stream)
                        : launch_as<TK, TV, false>(a, b, splits, stream);
}

template <typename TK>
int launch_k(const Args& a, int v_type, int b, int splits,
             cudaStream_t stream) {
  if (v_type == kBF16) return launch_kv<TK, bf16>(a, b, splits, stream);
  if (v_type == kF16) return launch_kv<TK, f16>(a, b, splits, stream);
  return launch_kv<TK, float>(a, b, splits, stream);
}

int size_of(int type) { return type == kF32 ? 4 : 2; }

// Lanes a key in S where rows are read off their chunks: about 2 of the
// row's 16-byte chunks a lane, a power of two from 4 to 32. Fewer lanes a
// key leave fewer idle at a row's last chunks and need fewer shuffles;
// more keep a pass's loads fewer deep. On an H100 (`chip_ab.py
// stream-parts`): at bf16 d = 66 and the bf16 serve shape off 16 bytes, 8
// lanes took 0.551 and 0.659 ms, one chunk a lane (16) 0.659 and 0.759,
// 4 lanes (with 128-key tiles at d = 66) 0.600 and 0.910.
int key_lanes(int d, int k_size) {
  const int chunks = (d * k_size + 15) / 16;
  int lanes = 4;
  while (lanes < 32 && 2 * lanes < chunks) lanes *= 2;
  return lanes;
}

}  // namespace stream
}  // namespace

extern "C" {

const char* stream_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Decode attention on q [b h, ql, d] (code q_type), k [b h, cap, d]
// (k_type) and v [b h, cap, dv] (v_type), any head dims, into out [b h, ql,
// dvo] in q's dtype (dvo: dv rounded up to a multiple of 4; the columns past
// dv are written as zeros). rows: query rows a block (1-8); tile: keys a
// tile; split s takes keys [s split_keys, (s + 1) split_keys), split_keys a
// multiple of tile; with more than one split, f32 partials in part_o [b h,
// splits, ql, dvo] and part_ml [b h, splits, ql, 2], merged into out. One
// launch (and the merge) for every query row. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for arguments it does not take).
int stream_decode_run(const void* q, const void* k, const void* v,
                      const void* lens, void* out, void* part_o,
                      void* part_ml, int b, int h, int ql, int rows, int cap,
                      int d, int dv, int dvo, int tile, int splits,
                      int split_keys, float scale, int q_type, int k_type,
                      int v_type, void* stream) {
  using namespace stream;
  const auto ok = [](int t) { return t >= kF32 && t <= kF16; };
  if (b < 1 || h < 1 || ql < 1 || cap < 1 || d < 1 || dv < 1 ||
      dvo < dv || dvo % 4 != 0 || rows < 1 || rows > kMaxRows || tile < 1 ||
      tile > kMaxTile || !ok(q_type) || !ok(k_type) || !ok(v_type) ||
      splits < 1 || splits > 65535 || split_keys < tile ||
      split_keys % tile != 0 ||
      static_cast<long long>(splits - 1) * split_keys >= cap ||
      static_cast<long long>(splits) * split_keys < cap ||
      (ql + rows - 1) / rows > 65535 ||
      static_cast<long long>(b) * h > 0x7fffffff ||
      static_cast<long long>(b) * h * ql > 0x7fffffff ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // Every byte count the kernel forms fits an int: a tile's rows.
  if (static_cast<long long>(tile) * (static_cast<long long>(d) * 4 +
                                      static_cast<long long>(dv) * 4) >
      kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lens = static_cast<const int*>(lens);
  a.out = out;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.h = h;
  a.ql = ql;
  a.rows = rows;
  a.cap = cap;
  a.d = d;
  a.dv = dv;
  a.dvo = dvo;
  a.tile = tile;
  a.split_keys = split_keys;
  a.q_type = q_type;
  a.scale_log2 = scale * kLog2e;
  a.key_lanes = key_lanes(d, size_of(k_type));
  // Bulk copies of the spans as they are where every K and V row is whole
  // 16-byte chunks and k and v start on 16-byte boundaries; else of the
  // chunks around each span, 16 bytes more a buffer.
  const bool bulk = (d * size_of(k_type)) % 16 == 0 &&
                    (dv * size_of(v_type)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0;
  a.lay = layout(tile, rows, d, dv, dvo, size_of(k_type), size_of(v_type),
                 bulk ? 0 : 16);
  if (a.lay.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (k_type == kBF16) return launch_k<bf16>(a, v_type, b, splits, s);
  if (k_type == kF16) return launch_k<f16>(a, v_type, b, splits, s);
  return launch_k<float>(a, v_type, b, splits, s);
}

}  // extern "C"
