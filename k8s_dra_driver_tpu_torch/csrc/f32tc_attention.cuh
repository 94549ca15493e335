// The f32 and mixed decode body for NVIDIA Hopper (sm_90a), on the tensor
// cores in 3xTF32: decode attention whose d or dv is over 256, up to padded
// 576/512 (DeepSeek-V3's absorbed MLA: 128 query rows of 576/512 against
// one latent head), with q, k and v all f32 (decode_attention.cu's
// decode_attention_f32tc) or q in one dtype and K and V sharing another
// (mixed_decode.cu). One device body computes one 64-row query tile of one
// split of the cache against a stream of 64-key K/V tiles and writes an f32
// partial; the wide path's merge kernel sums the splits. Built for a 16-bit
// q or 16-bit K and V (`body`'s kQ16 and kKV16), a 16-bit operand is exact
// in TF32, so it enters each product once and only an f32 operand is split.
// Flash attention of these dtypes runs on cluster_flash.cuh's body, a fork
// of this one with a flag an operand and a cluster exchange.
//
// It replaces, for those calls, the TPU kernel `_decode_kernel`
// (k8s_dra_driver_tpu/compute/flashattention.py) and computes its function:
// scores q.k of the upcast values accumulated in f32, scaled by 1/sqrt(d)
// of the true d; keys at index >= kv_lengths[b] masked; an online softmax
// with f32 running max and denominator; p rounded to V's dtype (f32 V: not
// rounded); P V accumulated in f32; the output in q's dtype. The wrapper
// zero-pads d and dv to multiples of 16; a zero column adds nothing to q.k,
// and the output's padded columns are cut off.
//
// Why 3xTF32 and not TF32. The tensor cores take f32 operands only as TF32
// (10 mantissa bits): one TF32 product is off by ~1e-3 of the value, 50
// times the f32 limit the checks hold (2e-5 + 2e-5 |ref|, the JAX package's
// own). Split x = hi + lo with hi = tf32(x) and lo = x - hi (exact in f32,
// and itself within 2^-11 of a TF32 value); then a b = hi_a hi_b + hi_a lo_b
// + lo_a hi_b + lo_a lo_b, and the first three, summed in f32 with the small
// terms first, leave ~2^-21 of the product: f32 accuracy for 3 TF32
// products, 494.7 / 3 = ~165 TFLOP/s of f32-accurate work against the SIMT
// units' 67.
//
// What bounds it: operations, at that 3xTF32 rate. Absorbed-MLA decode in
// f32 does 128 x 1,088 multiply-adds for each key's 4,352 bytes, 18.4 GFLOP
// on ~305 MB at the smoke's lengths (0.111 ms of work against 0.091 of
// bytes).
//
// The design:
//   * Operand major-ness. `wgmma` reads TF32 from shared memory K-major
//     only. S = Q K^T is K-major on both sides (d contiguous in Q and K).
//     P V is not: V is [keys, dv] with dv contiguous. The choice here: a
//     split pass writes each V panel transposed, [dv, keys] with keys
//     contiguous, as a hi and a lo plane (not mma.sync for P V, not
//     O^T = V^T P^T). P is the register A operand, split into hi and lo in
//     registers; the S accumulator holds keys 2 t4 and 2 t4 + 1 of each
//     8-key step where TF32's A fragment wants t4 and t4 + 4, so a step's
//     key order is permuted (slot j < 4 holds key 2 j, slot j + 4 key
//     2 j + 1) in P's registers and, to match, in the transposed V planes:
//     a sum over keys does not see the order.
//   * Q is the register A operand of S too: per 8-column k-step the
//     consumer reads its fragment of the stage's raw Q panel from shared
//     memory and splits it (two sets, so that one k-step's are read while
//     the last one's wgmmas run); K is the shared-memory B operand.
//   * hi and lo. A raw f32 operand stands in for K's hi (TMA copies raw
//     f32, and `wgmma` reads its top 19 bits): lo = k - (k with the low 13
//     bits cleared), exact, written as a plane. Q's, V's and P's hi are
//     cvt.rna.tf32.f32's (V's plane is written anyway, for the transpose).
//     The checks on the card hold the result to the f32 limit, and the
//     control that keeps one product of three (plain TF32) fails them.
//   * Everything streams through one ring of 32-column (128-byte) panels
//     in the 128-byte swizzle TMA writes and `wgmma` reads: a stage is Q's
//     and K's panel p of one 64-key tile (64 rows x 128 bytes each), or
//     V's panel of 32 dv columns, with room for the split planes: 32 KB a
//     stage, 6 stages (192 KB of the 227 KB a block may have). Q is not
//     resident: at 576 columns one f32 Q tile is 144 KB, and its panels
//     come again from L2 with each key tile.
//   * Head dims are one compile-time bucket of panels: 18 of d (576) and 8
//     of dv, whose dv goes in chunks of 256 columns, one work item each (O
//     of 64 x 256 is 128 registers a thread; S is computed once per chunk).
//     Every loop that issues a `wgmma` runs to a compile-time count (a
//     run-time panel count serialised every HGMMA of the wide kernels,
//     PERF.md); the panels past d or dv are TMA's zeros. The consumer holds
//     O, S, P's or Q's fragments and little else: 254 of 255 registers, no
//     spill once each stage's address is pinned after its wait (`pinned`).
//   * 8 warps a block, one block an SM. Warp 0: one thread issues every TMA
//     load. Warps 1-3: the split pass (K's lo plane; V's transposed hi and
//     lo planes), then `fence.proxy.async` and an arrival. Warps 4-7, one
//     warpgroup: S by `wgmma` m64n64k8 (per k-step lo.hi, hi.lo, then
//     hi.hi, a commit group each), the online softmax in registers (base
//     2, as the other routes), P's split, and O += P V by `wgmma` m64n32k8,
//     one 32-column accumulator per V panel. mbarriers per stage: full
//     (TMA bytes), split (the 96 split threads), empty (the 4 consumer
//     warps, once the `wgmma`s that read the stage are done).
//   * Grid: one block per (b h, split, 64-row tile, dv chunk), the cache
//     split across blocks by a count the wrapper takes from the shapes and
//     the SM count (`f32_decode_splits`), never the lengths; f32 partials
//     (O, base-2 max, l) merged by the wide path's merge kernel. All of
//     absorbed MLA's 128 query rows go in one launch.
// What holds it back (PERF.md): S is computed once per dv chunk (twice at
// dv = 512) and Q's panels are read and split again with every key tile.
// There is no fallback: a call that cannot build or launch raises.

#pragma once

#include <math_constants.h>

#include "hopper.cuh"
#include "wide_attention.cuh"

namespace {
namespace f32tc {

constexpr int kRows = 64;                      // query rows per tile
constexpr int kKeys = 64;                      // keys per K/V tile
constexpr int kCols = kPanelColsF32;           // f32 columns per panel
constexpr int kStages = 6;                     // ring depth
constexpr int kMaxD = 576;                     // padded head dims taken
constexpr int kMaxDv = 512;
constexpr int kDimStep = 16;                   // d, dv multiples of it
constexpr int kThreads = 256;
constexpr int kSplitThreads = 96;              // warps 1-3
constexpr int kPanelBytes = kRows * 128;       // 64 rows x 128 bytes: 8 KB
constexpr int kStageBytes = 4 * kPanelBytes;   // raw A | raw B | plane | plane
static_assert(kRows == kKeys, "a Q panel and a K panel are the same size");

constexpr int kBarsOffset = kStages * kStageBytes;
constexpr int kSmemBytes = 1024 + kBarsOffset + 3 * kStages * 8;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may have");

// What a launch computes: rows = ql query rows against keys = cap; part_o
// is [n_bh, splits, ql, dv] and part_ml [n_bh, splits, ql, 2] (base-2 max,
// denominator). dv_chunk: the output columns one work item takes. q_f16,
// kv_f16: a 16-bit q's and K/V's kind, 1 for f16 and 0 for bf16 (read where
// the kernel is built for 16-bit q or K/V).
struct Args {
  int n_bh, rows, keys, d, dv, dv_chunk;
  float scale_log2;
  const int* lens;
  int h, splits, split_keys;
  float* part_o;
  float* part_ml;
  int q_f16, kv_f16;
};

// One work item: query rows [q0, q0 + 64) of (b h) `bh`, output columns
// [c0, c0 + dv_chunk), against key tiles from k0, n_kt of them, keys >=
// k_limit masked. `part` is the item's partial (bh * splits + split).
struct Work {
  int bh, q0, c0, k0, n_kt, k_limit, part;
};

__device__ __forceinline__ int n_chunks(const Args& a) {
  return (a.dv + a.dv_chunk - 1) / a.dv_chunk;
}

__device__ __forceinline__ int n_work(const Args& a) {
  const int n_rt = (a.rows + kRows - 1) / kRows;
  return a.n_bh * n_rt * n_chunks(a) * a.splits;
}

// Item j: the chunks of one tile, then the row tiles of one split, side by
// side (neighbours read the same K and V, the later ones from L2).
__device__ __forceinline__ Work work_of(const Args& a, int j) {
  const int n_rt = (a.rows + kRows - 1) / kRows;
  const int nc = n_chunks(a);
  const int rest = j / nc;
  Work w;
  w.c0 = (j - rest * nc) * a.dv_chunk;
  const int part = rest / n_rt;
  w.part = part;
  w.bh = part / a.splits;
  w.q0 = (rest - part * n_rt) * kRows;
  w.k0 = (part - w.bh * a.splits) * a.split_keys;
  const int len = min(a.lens[w.bh / a.h], a.keys);
  w.k_limit = min(w.k0 + a.split_keys, len);
  w.n_kt = w.k_limit > w.k0 ? (w.k_limit - w.k0 + kKeys - 1) / kKeys : 0;
  return w;
}

// The body. DP: 32-column panels of Q and K; VP: of V in one dv chunk.
// kQ16, kKV16: q, or K and V, 16-bit (bf16 or f16, by a.q_f16 and
// a.kv_f16) rather than f32: TMA copies such a panel in its own dtype (32
// columns, 64-byte rows in the 64-byte swizzle, `sw64_offset`), and it is
// exact in TF32, so its lo part is zero and its lo product is not issued:
// S takes 1 + !kQ16 + !kKV16 TF32 products a multiply-add; P V takes 3
// with f32 V, and 1 with 16-bit V, where p is rounded to V's dtype (exact
// in TF32) as the TPU kernel rounds it. A 16-bit K panel lands in plane 3
// and the split warps write it as f32 into plane 1 (the hi plane a raw f32
// panel is); a 16-bit V panel's transposed hi plane comes from its own
// dtype; a 16-bit Q is converted in the consumers' registers.
template <int DP, int VP, bool kQ16, bool kKV16>
__device__ __forceinline__ void body(const CUtensorMap& q_map,
                                     const CUtensorMap& k_map,
                                     const CUtensorMap& v_map,
                                     const Args& a) {
  const float scale_log2 = a.scale_log2;  // 1/sqrt(d) log2(e)
  // Bytes of one Q, K or V panel as TMA copies it.
  constexpr int kQBytes = kQ16 ? kPanelBytes / 2 : kPanelBytes;
  constexpr int kKVBytes = kKV16 ? kPanelBytes / 2 : kPanelBytes;
  const bool q_f16 = a.q_f16 != 0, kv_f16 = a.kv_f16 != 0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + kBarsOffset;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto split = [&](int st) { return bars + 8 * (kStages + st); };
  const auto empty = [&](int st) { return bars + 8 * (2 * kStages + st); };
  const auto stage = [&](int st) { return base + st * kStageBytes; };
  unsigned char* const base_ptr = smem_raw + (base - raw);

  const int work = n_work(a);
  const int grid = gridDim.x, block = blockIdx.x;
  const auto item = [&](int r) {
    return r * grid + ((r & 1) ? grid - 1 - block : block);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(split(st), kSplitThreads);
      mbar_init(empty(st), 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp_id = threadIdx.x / 32;
  if (warp_id == 0) {
    // Producer: one thread issues every load. A stage of S holds Q's and
    // K's panel p of one key tile; a stage of P V, V's panel vp.
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0; item(r) < work; ++r) {
        const Work w = work_of(a, item(r));
        for (int kt = 0; kt < w.n_kt; ++kt) {
          const int key = w.k0 + kt * kKeys;
          for (int p = 0; p < DP; ++p, ++it) {
            const int st = it % kStages;
            mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(full(st), kQBytes + kKVBytes);
            tma_load(stage(st), &q_map, full(st), p * kCols, w.q0, w.bh);
            tma_load(stage(st) + (kKV16 ? 3 : 1) * kPanelBytes, &k_map,
                     full(st), p * kCols, key, w.bh);
          }
          for (int vp = 0; vp < VP; ++vp, ++it) {
            const int st = it % kStages;
            mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(full(st), kKVBytes);
            tma_load(stage(st), &v_map, full(st), w.c0 + vp * kCols, key,
                     w.bh);
          }
        }
      }
    }
  } else if (warp_id < 4) {
    // The split pass, 96 threads. S stages: lo = x - trunc(x) of K's panel
    // into plane 3, element for element (the swizzle is the same); a
    // 16-bit K panel (plane 3) as f32 into plane 1 instead, a 16-byte chunk
    // (8 columns) a task. P V stages: V's panel [64 keys x 32 columns]
    // transposed into [32 columns x 64 keys] (two 32-key halves of 32 rows
    // x 128 bytes), hi = rna(v) into plane 2 and lo into plane 3 (16-bit V:
    // hi = v, no lo). Thread task (column c = lane, group g of 8 keys,
    // parity): keys 8 g + parity + 2 j, j = 0..3, into slots 8 g + 4 parity
    // + j: a warp reads one key row and writes 32 rows, each in one 16-byte
    // chunk.
    const int ts = threadIdx.x - 32;
    int it = 0;
    for (int r = 0; item(r) < work; ++r) {
      const Work w = work_of(a, item(r));
      for (int kt = 0; kt < w.n_kt; ++kt) {
        for (int p = 0; p < DP; ++p, ++it) {
          const int st = it % kStages;
          mbar_wait(full(st), (it / kStages) & 1);
          unsigned char* const s = base_ptr + st * kStageBytes;
          if constexpr (kKV16) {
            for (int i = ts; i < kKeys * 4; i += kSplitThreads) {
              const int key = i >> 2, c8 = i & 3;
              const uint4 raw = *reinterpret_cast<const uint4*>(
                  s + 3 * kPanelBytes + sw64_offset(key, 8 * c8));
              const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
              float f[8];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                f[2 * e] = from16(w4[e] & 0xffffu, kv_f16);
                f[2 * e + 1] = from16(w4[e] >> 16, kv_f16);
              }
              // Columns 8 c8 .. 8 c8 + 7: the f32 row's chunks 2 c8, 2 c8 + 1.
              unsigned char* const row = s + kPanelBytes + key * 128;
              *reinterpret_cast<float4*>(
                  row + (((2 * c8) ^ (key & 7)) << 4)) =
                  make_float4(f[0], f[1], f[2], f[3]);
              *reinterpret_cast<float4*>(
                  row + (((2 * c8 + 1) ^ (key & 7)) << 4)) =
                  make_float4(f[4], f[5], f[6], f[7]);
            }
          } else {
            for (int i = ts; i < kPanelBytes / 16; i += kSplitThreads) {
              const float4 x =
                  *reinterpret_cast<const float4*>(s + kPanelBytes + 16 * i);
              *reinterpret_cast<float4*>(s + 3 * kPanelBytes + 16 * i) =
                  make_float4(x.x - tf32_trunc(x.x), x.y - tf32_trunc(x.y),
                              x.z - tf32_trunc(x.z), x.w - tf32_trunc(x.w));
            }
          }
          fence_proxy_async();
          mbar_arrive(split(st));
        }
        for (int vp = 0; vp < VP; ++vp, ++it) {
          const int st = it % kStages;
          mbar_wait(full(st), (it / kStages) & 1);
          unsigned char* const s = base_ptr + st * kStageBytes;
          for (int i = ts; i < kCols * 2 * (kKeys / 8); i += kSplitThreads) {
            const int c = i & 31, task = i >> 5;
            const int g = task >> 1, par = task & 1;
            float hi[4], lo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int key = 8 * g + par + 2 * j;
              if constexpr (kKV16) {
                hi[j] = from16(*reinterpret_cast<const uint16_t*>(
                                   s + sw64_offset(key, c)),
                               kv_f16);
                lo[j] = 0.f;
              } else {
                const float x = *reinterpret_cast<const float*>(
                    s + key * 128 + (((c >> 2) ^ (key & 7)) << 4) +
                    4 * (c & 3));
                hi[j] = tf32_rna(x);
                lo[j] = x - hi[j];
              }
            }
            // Slot 8 g + 4 par: key half g / 4, chunk 2 (g % 4) + par.
            const int chunk = 2 * (g & 3) + par;
            const int off = (g >> 2) * (kPanelBytes / 2) + c * 128 +
                            ((chunk ^ (c & 7)) << 4);
            *reinterpret_cast<float4*>(s + 2 * kPanelBytes + off) =
                make_float4(hi[0], hi[1], hi[2], hi[3]);
            if constexpr (!kKV16)
              *reinterpret_cast<float4*>(s + 3 * kPanelBytes + off) =
                  make_float4(lo[0], lo[1], lo[2], lo[3]);
          }
          fence_proxy_async();
          mbar_arrive(split(st));
        }
      }
    }
  } else {
    // The consumer warpgroup.
    const int t = threadIdx.x - 128;
    const int warp = t >> 5, lane = t & 31;
    const int t4 = lane & 3;
    // This thread's rows of the tile: row_in and row_in + 8; its columns
    // of a 64-row accumulator: 8 (i / 4) + 2 t4 + i % 2.
    const int row_in = 16 * warp + (lane >> 2);
    float o[VP][16];
    float s[kKeys / 2];
    uint32_t p_hi[kKeys / 8][4], p_lo[kKeys / 8][4];
    // A stage's address, computed after its wait: unpinned, ptxas hoisted
    // every stage's descriptors out of the unrolled loops and spilled (at
    // 18 panels of d).
    const auto pinned = [](uint32_t at) {
      asm volatile("" : "+r"(at));
      return at;
    };
    const auto release = [&](int it) {
      if (lane == 0) mbar_arrive(empty(it % kStages));
    };
    // S = Q K^T over the DP panels of one key tile, stage by stage; each
    // stage is released once the wgmmas that read it are done.
    // Q is the register A operand of S: this thread's fragment of one
    // 8-column k-step of a stage's Q panel, read from shared memory and
    // split here; two sets (even and odd k-steps), so that one is loaded
    // while the other's wgmmas read it.
    uint32_t q_hi[2][4], q_lo[2][4];
    const auto load_q = [&](int st, int ks) {
      const unsigned char* const qp = base_ptr + st * kStageBytes;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = row_in + 8 * (j & 1);
        const int col = 8 * ks + t4 + 4 * (j >> 1);
        if constexpr (kQ16) {
          q_hi[ks & 1][j] = __float_as_uint(from16(
              *reinterpret_cast<const uint16_t*>(qp + sw64_offset(row, col)),
              q_f16));
        } else {
          const float x = *reinterpret_cast<const float*>(
              qp + row * 128 + (((col >> 2) ^ (row & 7)) << 4) +
              4 * (col & 3));
          const float hi = tf32_rna(x);
          q_hi[ks & 1][j] = __float_as_uint(hi);
          q_lo[ks & 1][j] = __float_as_uint(x - hi);
        }
      }
    };
    // S = Q K^T over the DP panels of one key tile, stage by stage, a
    // commit group per k-step (lo.hi, hi.lo, hi.hi: the small terms first,
    // the lo products only of f32 operands); each stage is released once the
    // wgmmas that read it (and the A registers loaded from it) are done.
    const auto scores = [&](int it) {
#pragma unroll
      for (int p = 0; p < DP; ++p) {
        const int st = (it + p) % kStages;
        const uint32_t ph = ((it + p) / kStages) & 1;
        mbar_wait(full(st), ph);
        const uint32_t at = pinned(stage(st));
        const uint64_t kh = sw128_desc(at + kPanelBytes, 16);
        const uint64_t kl = sw128_desc(at + 3 * kPanelBytes, 16);
#pragma unroll
        for (int ks = 0; ks < kCols / 8; ++ks) {
          const int b = ks & 1;
          load_q(st, ks);
          if (ks == 0) mbar_wait(split(st), ph);
          if (p + ks == 0) fence_regs(s);  // none while a group writes s
          wgmma_fence();
          const uint32_t off = (ks * 32) >> 4;
          if constexpr (!kQ16)
            wgmma_tf32_rs_n64(s, q_lo[b], kh + off, p + ks > 0);
          if constexpr (!kKV16)
            wgmma_tf32_rs_n64(s, q_hi[b], kl + off, !kQ16 || p + ks > 0);
          wgmma_tf32_rs_n64(s, q_hi[b], kh + off,
                            !kQ16 || !kKV16 || p + ks > 0);
          wgmma_commit();
          if (p + ks > 0) {
            wgmma_wait<1>();  // the other set's group is done
            fence_regs(q_hi[b ^ 1]);
            if constexpr (!kQ16) fence_regs(q_lo[b ^ 1]);
            if (ks == 0) release(it + p - 1);
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(q_hi[1]);
      if constexpr (!kQ16) fence_regs(q_lo[1]);
      release(it + DP - 1);
    };
    // O += P V over the VP panels of the tile's dv chunk.
    const auto values = [&](int it) {
#pragma unroll
      for (int vp = 0; vp < VP; ++vp) {
        const int st = (it + vp) % kStages;
        mbar_wait(split(st), ((it + vp) / kStages) & 1);
        const uint32_t at = pinned(stage(st));
        const uint64_t vh = sw128_desc(at + 2 * kPanelBytes, 16);
        const uint64_t vl = sw128_desc(at + 3 * kPanelBytes, 16);
        fence_regs(o[vp]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKeys / 8; ++ks) {
          // Keys 8 ks .. 8 ks + 7: half ks / 4, 32-byte step ks % 4.
          const uint32_t off =
              ((ks >> 2) * (kPanelBytes / 2) + (ks & 3) * 32) >> 4;
          if constexpr (!kKV16) {
            wgmma_tf32_rs_n32(o[vp], p_lo[ks], vh + off);
            wgmma_tf32_rs_n32(o[vp], p_hi[ks], vl + off);
          }
          wgmma_tf32_rs_n32(o[vp], p_hi[ks], vh + off);
        }
        wgmma_commit();
        if (vp > 0) {
          wgmma_wait<1>();
          release(it + vp - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int vp = 0; vp < VP; ++vp) fence_regs(o[vp]);
      fence_regs(p_hi);
      if constexpr (!kKV16) fence_regs(p_lo);
      release(it + VP - 1);
    };
    // The softmax of the key tile at k0t, in place on s (base 2): s
    // becomes p, l takes its row sums, corr the factor by which O must be
    // rescaled for the new row max.
    const auto softmax = [&](const Work& w, int k0t, float (&m)[2],
                             float (&l)[2], float (&corr)[2]) {
      if (k0t + kKeys > w.k_limit) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const int col = k0t + 8 * (i / 4) + 2 * t4 + (i & 1);
          if (col >= w.k_limit) s[i] = -CUDART_INF_F;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kKeys / 2; i += 4) {
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
        corr[r] = exp2f(fmaf(m[r], scale_log2, nbase[r]));
        m[r] = mx[r];
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        s[i] = exp2f(fmaf(s[i], scale_log2, nbase[(i >> 1) & 1]));
        ps[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
    };
    // P's TF32 A fragments, hi and lo: for the 8 keys of step ks, a[0] and
    // a[1] (rows row_in, row_in + 8) hold key 2 t4 in slot t4, a[2] and
    // a[3] key 2 t4 + 1 in slot t4 + 4 (the V planes' key order). With
    // 16-bit V, p rounded to V's dtype alone (l keeps the unrounded sum).
    const auto split_p = [&]() {
#pragma unroll
      for (int ks = 0; ks < kKeys / 8; ++ks) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = s[4 * ks + 2 * (j & 1) + (j >> 1)];
          if constexpr (kKV16) {
            p_hi[ks][j] = __float_as_uint(round16(x, kv_f16));
          } else {
            const float hi = tf32_rna(x);
            p_hi[ks][j] = __float_as_uint(hi);
            p_lo[ks][j] = __float_as_uint(x - hi);
          }
        }
      }
    };

    int it = 0;
    for (int r = 0; item(r) < work; ++r) {
      const Work w = work_of(a, item(r));
      if (w.n_kt == 0) {
        // No valid key in the range: an empty partial for the merge.
        const int row = w.q0 + t;
        if (w.c0 == 0 && t < kRows && row < a.rows) {
          float* ml = a.part_ml +
                      (static_cast<size_t>(w.part) * a.rows + row) * 2;
          ml[0] = -CUDART_INF_F;
          ml[1] = 0.f;
        }
        continue;
      }
#pragma unroll
      for (int vp = 0; vp < VP; ++vp)
#pragma unroll
        for (int i = 0; i < 16; ++i) o[vp][i] = 0.f;
      // Running max of the raw scores q.k of this thread's two rows, and
      // its share of their denominators.
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
      float l[2] = {0.f, 0.f};
      float corr[2];
      for (int kt = 0; kt < w.n_kt; ++kt) {
        // The first wgmma overwrites s; zeros here end the last tile's p
        // in the compiler's eyes (the asm reads s), so that P V's registers
        // are free.
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
        scores(it);
        it += DP;
        softmax(w, w.k0 + kt * kKeys, m, l, corr);
#pragma unroll
        for (int vp = 0; vp < VP; ++vp)
#pragma unroll
          for (int i = 0; i < 16; ++i) o[vp][i] *= corr[(i >> 1) & 1];
        split_p();
        values(it);
        it += VP;
      }
      float sum[2];
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        sum[r2] = l[r2] + __shfl_xor_sync(0xffffffffu, l[r2], 1);
        sum[r2] += __shfl_xor_sync(0xffffffffu, sum[r2], 2);
      }
      // The partial (unnormalised), this thread's columns of each V panel,
      // and the rows' base-2 max and denominator.
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = w.q0 + row_in + 8 * hr;
        if (row >= a.rows) continue;
        const size_t at = (static_cast<size_t>(w.part) * a.rows + row) * a.dv;
#pragma unroll
        for (int vp = 0; vp < VP; ++vp)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = w.c0 + vp * kCols + 8 * c + 2 * t4;
            if (col >= a.dv) continue;
            *reinterpret_cast<float2*>(a.part_o + at + col) = make_float2(
                o[vp][4 * c + 2 * hr], o[vp][4 * c + 2 * hr + 1]);
          }
        if (w.c0 == 0 && t4 == 0) {
          float* ml = a.part_ml +
                      (static_cast<size_t>(w.part) * a.rows + row) * 2;
          ml[0] = m[hr] * scale_log2;
          ml[1] = sum[hr];
        }
      }
    }
  }
}

// The kernel; the build report names its bucket and dtype class (16-bit
// q, 16-bit K and V: all-f32 is <DP,VP,0,0>).
template <int DP, int VP, bool kQ16, bool kKV16>
__global__ void __launch_bounds__(kThreads, 1)
    f32tc_decode_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const Args a) {
  body<DP, VP, kQ16, kKV16>(q_map, k_map, v_map, a);
}

// ---- launch ---------------------------------------------------------------

// fn(kQ16, kKV16) as integral constants for the dtype class of a q and a
// K/V cache whose dtype codes (0 f32, 1 bf16, 2 f16: the wrappers') differ,
// then q's and the cache's 16-bit kinds (1 for f16) for `launch_decode`;
// cudaErrorInvalidValue for any other pair.
template <typename F>
int with_mixed_class(int q_type, int kv_type, F&& fn) {
  const auto ok = [](int t) { return t >= 0 && t <= 2; };
  if (!ok(q_type) || !ok(kv_type) || q_type == kv_type)
    return static_cast<int>(cudaErrorInvalidValue);
  using no = std::integral_constant<bool, false>;
  using yes = std::integral_constant<bool, true>;
  const int q_f16 = q_type == 2, kv_f16 = kv_type == 2;
  if (q_type == 0) return fn(no{}, yes{}, q_f16, kv_f16);
  if (kv_type == 0) return fn(yes{}, no{}, q_f16, kv_f16);
  return fn(yes{}, yes{}, q_f16, kv_f16);
}

// The padded head dims the path takes: multiples of 16, d <= 576,
// dv <= 512.
inline bool dims_ok(int d, int dv) {
  return d >= kDimStep && dv >= kDimStep && d <= kMaxD && dv <= kMaxDv &&
         d % kDimStep == 0 && dv % kDimStep == 0;
}

// Encodes the Q, K and V maps ([n_bh, rows or keys, cols] each; a 16-bit
// operand's in its own dtype, `encode_map_16_narrow`), sets the kernel's
// shared memory, and launches it on `grid` blocks.
template <bool kQ16, bool kKV16, typename K>
int launch_body(K kernel, const void* q, const void* k, const void* v,
                const Args& a, int grid, cudaStream_t stream) {
  const auto encode = [](bool is16, CUtensorMap* map, const void* ptr,
                         int n_bh, int rows, int cols, int box) {
    return is16 ? encode_map_16_narrow(map, ptr, n_bh, rows, cols, box)
                : encode_map_f32(map, ptr, n_bh, rows, cols, box);
  };
  CUtensorMap q_map, k_map, v_map;
  if (!encode(kQ16, &q_map, q, a.n_bh, a.rows, a.d, kRows) ||
      !encode(kKV16, &k_map, k, a.n_bh, a.keys, a.d, kKeys) ||
      !encode(kKV16, &v_map, v, a.n_bh, a.keys, a.dv, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(q_map, k_map, v_map, a);
  return static_cast<int>(cudaGetLastError());
}

// Decode attention on q [b h, ql, d], k [b h, cap, d] and v [b h, cap, dv]
// (padded dims, d or dv over 256) into out [b h, ql, dv] in q's dtype:
// one block per (b h, split, 64-row tile, dv chunk) writing f32 partials
// into part_o [b h, splits, ql, dv] and part_ml [b h, splits, ql, 2], then
// the wide path's merge. Split s takes keys [s split_keys, (s + 1)
// split_keys); split_keys is a multiple of 64. kQ16, kKV16: q, or k and v,
// 16-bit, of the kind q_f16 and kv_f16 say (1 f16, 0 bf16); f32 otherwise.
// (The launch is a template so that a source instantiates only the kernels
// it calls.)
template <bool kQ16, bool kKV16>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* lens, void* out, void* part_o, void* part_ml,
                  int b, int h, int ql, int cap, int d, int dv, float scale,
                  int splits, int split_keys, int q_f16, int kv_f16,
                  cudaStream_t stream) {
  if (b < 1 || h < 1 || ql < 1 || cap < 1 || !dims_ok(d, dv) ||
      (d <= 8 * kCols && dv <= 8 * kCols) || splits < 1 ||
      split_keys < kKeys || split_keys % kKeys != 0 ||
      static_cast<long long>(splits - 1) * split_keys >= cap)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kDP = kMaxD / kCols, kVP = 8;
  Args a{};
  a.n_bh = b * h;
  a.rows = ql;
  a.keys = cap;
  a.d = d;
  a.dv = dv;
  a.dv_chunk = kVP * kCols;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.lens = static_cast<const int*>(lens);
  a.h = h;
  a.splits = splits;
  a.split_keys = split_keys;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.q_f16 = q_f16;
  a.kv_f16 = kv_f16;
  const long long n_work = static_cast<long long>(b) * h * splits *
                           ((ql + kRows - 1) / kRows) *
                           ((dv + a.dv_chunk - 1) / a.dv_chunk);
  const long long rows = static_cast<long long>(b) * h * ql;
  if (n_work > 0x7fffffff || rows > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_body<kQ16, kKV16>(
      f32tc_decode_kernel<kDP, kVP, kQ16, kKV16>, q, k, v, a,
      static_cast<int>(n_work), stream);
  if (err != 0) return err;
  const auto merge = [&](auto* typed_out) {
    using E = std::remove_pointer_t<decltype(typed_out)>;
    wide::wide_decode_merge_kernel<E>
        <<<static_cast<int>(rows), 128, 0, stream>>>(
            static_cast<const float*>(part_o),
            static_cast<const float*>(part_ml), typed_out, ql, dv, splits,
            ql, 0);
  };
  if constexpr (kQ16) {
    if (q_f16)
      merge(static_cast<f16*>(out));
    else
      merge(static_cast<bf16*>(out));
  } else {
    merge(static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32tc
}  // namespace
