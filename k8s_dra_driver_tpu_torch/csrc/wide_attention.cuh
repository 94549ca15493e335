// The wide attention path for NVIDIA Hopper (sm_90a): head dims over the
// tuned kernels' 256, up to d = 576 and dv = 512 (DeepSeek-V3's absorbed
// MLA), with q, k and v all bf16 or all f16. One device body computes one
// 64-row query tile against a stream of 32-key K/V tiles; the decode kernels
// (decode_attention.cu) and the flash kernels (flash_attention.cu) differ
// only in which tiles a block takes and where its result goes.
//
// It computes the function of the TPU kernels `_decode_kernel` and
// `_flash_kernel` (k8s_dra_driver_tpu/compute/flashattention.py): scores
// q.k accumulated in f32 and scaled by 1/sqrt(d) of the true d; keys at
// index >= kv_lengths[b] (decode) or beyond the row (causal flash) masked;
// an online softmax with f32 running max and denominator; p rounded to V's
// dtype before P V, which accumulates in f32; the output in q's dtype. The
// wrapper zero-pads d and dv to multiples of 16; a zero column adds nothing
// to q.k, and the output's padded columns are cut off.
//
// What bounds it. Flash at 576/512: operations. Each score costs
// d + dv = 1,088 multiply-adds, so a 64-row tile does 64 x 1,088 for every
// 2,176 bytes of K and V it streams: 64 flops a byte from L2, above the
// card's 295 flops a byte from HBM only because the 16 x 32 query tiles of
// a head read the same K and V. Decode (absorbed MLA, 128 query rows
// against one latent cache): bytes. Each valid key's 2,176 bytes feed
// 128 x 1,088 multiply-adds, about 128 flops a byte, under the 295 at which
// the tensor cores would be the limit. So both are tensor-core work at
// 16 bits, and the design widens the tuned flash path (flash_attention.cu):
//   * 3 warpgroups a block. Warpgroup 0 is the producer: one thread issues
//     every TMA load, and `setmaxnreg` hands its registers to the two
//     consumers (24 / 240 / 240 a thread).
//   * TMA copies the Q tile once per query tile and K and V through a
//     2-stage ring of 32-key tiles, each tile as 64-column (128-byte) panels
//     in the 128-byte swizzle, with full/empty mbarriers per stage; TMA
//     zero-fills rows past the sequence or cache and columns past d or dv.
//   * The dv split is the design point: a 64 x 512 f32 accumulator is 256
//     registers a thread in one warpgroup. Consumer 1 owns output columns
//     [0, 256), consumer 2 [256, 512): 128 registers each.
//     Consumer 1 alone computes S = Q K^T by `wgmma` from shared memory (16
//     columns of d per m64n32k16: 36 at d = 576) and the online softmax,
//     once per key tile. It hands P, rounded to V's dtype, to consumer 2
//     through a double-buffered P tile in shared memory (written in the
//     swizzle `wgmma` reads, then `fence.proxy.async`), with each row's
//     rescale factor and, on the last tile, 1/l. Consumer 1 runs O += P V on
//     its half with P in registers; consumer 2 from the shared tile; both
//     read V MN-major through the transpose bit. Consumer 1 issues S of tile
//     kt with P V of tile kt - 1 in flight and runs the softmax of kt while
//     P V runs (the tuned kernel's overlap); consumer 2 lags it by up to
//     two tiles.
//   * One tile shape for every d and dv the path takes: Q and K tiles of 9
//     panels (576 columns) and 256 output columns a consumer; the columns
//     past d are TMA's zeros, and those past dv are never stored. The S
//     loop walks the 9 panels at compile time: with a run-time panel count,
//     ptxas made each wgmma wait for the one before (SASS: a
//     WARPGROUP.DEPBAR after every HGMMA), and flash at 576/512 took
//     0.69 ms instead of 0.40 (PERF.md).
//   * Shared memory at d = 576, dv = 512 (the most the path takes): Q 72 KB
//     (9 panels x 64 rows), 2 stages x (K 36 KB + V 32 KB) = 136 KB, two P
//     tiles of 64 rows x 128 bytes (keys in the first 64 bytes of each row)
//     = 16 KB, the rows' factors 1 KB and the barriers: 226.1 KB of the
//     227 KB a block may have, with 1 KB to align the swizzle atoms. 64-key
//     tiles would leave room for one stage only.
//   * Decode grid: one launch for all query rows. Blocks take (b h, split,
//     64-row tile), the row tile fastest, so that the two row tiles of one
//     sequence's split run side by side and the second reads K and V from
//     L2 (not a 2-block cluster with TMA multicast, which is untried). The
//     bytes bound counts K and V once; the launch reaches about half of it
//     at absorbed MLA's shape on an H100 (PERF.md). The cache range is
//     split across blocks (the wrapper picks the count from b, h, the row
//     tiles and kv_cap, never from the lengths, which would sync the
//     device); a block loads no tile at or past kv_lengths[b], and one
//     whose range starts there writes an empty partial (m = -inf, l = 0).
//     Each block writes an f32 partial (unnormalised O, base-2 max m, l);
//     a merge kernel weights the splits by 2^(m - max m) and writes the
//     output in q's dtype.
//   * Flash grid: persistent, one block an SM, over the (b h, 64-row query
//     tile) list with the most keys first, dealt to the blocks in a snake;
//     under causal, key tiles beyond a query tile's last row are never
//     loaded, and the mask runs only on tiles that cross the diagonal or S.
//   * f16 and bf16 from one body: `wgmma`'s f16 form and f16 tensor maps.
// What holds it back (PERF.md; `chip_ab.py wide-parts`): not the tensor
// cores. Leaving S's eight other panels of d or either consumer's P V out
// saves about an eighth of the time or less. A 64-row tile streams 2,176 bytes a key, so flash at [1, 16, 2048] moves
// 2.3 GB from L2 into the SMs (~5.7 TB/s at 0.40 ms); decode streams the
// cache from device memory with blocks of uneven length (ragged lengths,
// waves of one block an SM).
// There is no fallback: a wide call that cannot build or launch raises.

#pragma once

#include <math_constants.h>

#include "hopper.cuh"

namespace {
namespace wide {

constexpr int kRows = 64;      // query rows per tile: one wgmma M
constexpr int kKeys = 32;      // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kMaxD = 576;     // padded head dims the path takes
constexpr int kMaxDv = 512;
constexpr int kDimStep = 16;   // d and dv are multiples of it
constexpr int kDPanels = kMaxD / kPanelCols;  // 64-column panels of Q and K
constexpr int kDvHalf = kMaxDv / 2;           // output columns a consumer
constexpr int kThreads = 384;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kQPanelBytes = kRows * kPanelRowBytes;   // 8 KB
constexpr int kKVPanelBytes = kKeys * kPanelRowBytes;  // 4 KB
constexpr int kPBytes = kRows * kPanelRowBytes;        // one P tile

// Shared memory: Q | K stages | V stages | 2 P tiles | 2 x (factor, 1/l)
// per row | barriers.
struct Layout {
  static constexpr int kVPanels = kMaxDv / kPanelCols;
  static constexpr int kQBytes = kDPanels * kQPanelBytes;
  static constexpr int kKBytes = kDPanels * kKVPanelBytes;  // one K tile
  static constexpr int kVBytes = kVPanels * kKVPanelBytes;  // one V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kP = kV + kStages * kVBytes;
  static constexpr int kStats = kP + 2 * kPBytes;
  static constexpr int kBars = kStats + 2 * 2 * kRows * 4;
  static constexpr int kNumBars = 2 + 4 * kStages + 4;
  // The base is aligned by hand to the 1024-byte swizzle atom.
  static constexpr int kSmemBytes = 1024 + kBars + 8 * kNumBars;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may have");
};

// What a launch computes. Flash: rows = keys = S, out is [n_bh, S, dv] in
// q's dtype. Decode: rows = ql, keys = cap; part_o is [n_bh, splits, ql, dv]
// and part_ml [n_bh, splits, ql, 2] (base-2 max, denominator), both f32.
struct Args {
  int n_bh, rows, keys, d, dv;
  float scale_log2;
  int causal;
  void* out;
  const int* lens;
  int h, splits, split_keys;
  float* part_o;
  float* part_ml;
};

// One work item: query rows [q0, q0 + 64) of (b h) `bh` against key tiles
// from k0, n_kt of them, keys >= k_limit masked (decode; flash masks by S
// and causal). `part` is the decode item's partial (bh * splits + split).
struct Work {
  int bh, q0, k0, n_kt, k_limit, part;
};

template <bool kDecode>
__device__ __forceinline__ Work work_of(const Args& a, int j) {
  const int n_rt = (a.rows + kRows - 1) / kRows;
  Work w;
  if constexpr (kDecode) {
    const int rest = j / n_rt;
    w.part = rest;
    w.bh = rest / a.splits;
    w.q0 = (j - rest * n_rt) * kRows;
    w.k0 = (rest - w.bh * a.splits) * a.split_keys;
    const int len = min(a.lens[w.bh / a.h], a.keys);
    w.k_limit = min(w.k0 + a.split_keys, len);
    w.n_kt = w.k_limit > w.k0 ? (w.k_limit - w.k0 + kKeys - 1) / kKeys : 0;
  } else {
    // The list ordered by the most keys first: the last query tiles of
    // every (b h), then the ones before.
    w.part = 0;
    w.bh = j % a.n_bh;
    w.q0 = (n_rt - 1 - j / a.n_bh) * kRows;
    w.k0 = 0;
    w.k_limit = a.causal ? min(a.keys, w.q0 + kRows) : a.keys;
    w.n_kt = (w.k_limit + kKeys - 1) / kKeys;
  }
  return w;
}

// The body of every wide kernel. E: bf16 or f16. kDecode: decode's items
// and partials, else flash's items and output.
template <typename E, bool kDecode>
__device__ __forceinline__ void body(const CUtensorMap& q_map,
                                     const CUtensorMap& k_map,
                                     const CUtensorMap& v_map,
                                     const Args& a) {
  using L = Layout;
  const float scale_log2 = a.scale_log2;  // 1/sqrt(d) log2(e)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const base_ptr = smem_raw + (base - raw);
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV,
                 p_s = base + L::kP;
  // [slot][0]: each row's rescale factor; [slot][1]: 1/l (last tile).
  float(*const stats)[2][kRows] =
      reinterpret_cast<float(*)[2][kRows]>(base_ptr + L::kStats);
  const uint32_t bars = base + L::kBars;
  const uint32_t q_full = bars, q_empty = bars + 8;
  const auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  const auto v_full = [&](int st) { return bars + 8 * (2 + kStages + st); };
  const auto k_empty = [&](int st) {
    return bars + 8 * (2 + 2 * kStages + st);
  };
  const auto v_empty = [&](int st) {
    return bars + 8 * (2 + 3 * kStages + st);
  };
  const auto p_full = [&](int sl) { return bars + 8 * (2 + 4 * kStages + sl); };
  const auto p_empty = [&](int sl) {
    return bars + 8 * (4 + 4 * kStages + sl);
  };

  const int n_rt = (a.rows + kRows - 1) / kRows;
  const int n_work = kDecode ? a.n_bh * a.splits * n_rt : a.n_bh * n_rt;
  const int grid = gridDim.x, block = blockIdx.x;
  const auto item = [&](int r) {
    return r * grid + ((r & 1) ? grid - 1 - block : block);
  };
  // Panels of dv that a V tile holds (the columns past dv in a loaded panel
  // are TMA's zeros, and the panels past it feed only output columns that
  // are never stored).
  const int v_panels = min(L::kVPanels, (a.dv + kPanelCols - 1) / kPanelCols);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4);  // lane 0 of each warp of consumer 1
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 4);
      mbar_init(v_empty(st), 8);  // both consumers
    }
    for (int sl = 0; sl < 2; ++sl) {
      mbar_init(p_full(sl), 128);  // every thread of consumer 1
      mbar_init(p_empty(sl), 4);   // lane 0 of each warp of consumer 2
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer. Its registers go to the consumers; one thread issues loads.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, nq = 0;
      for (int r = 0; item(r) < n_work; ++r) {
        const Work w = work_of<kDecode>(a, item(r));
        if (w.n_kt == 0) continue;
        // A fresh barrier lets the first tile's Q in at once.
        mbar_wait(q_empty, (nq & 1) ^ 1);
        ++nq;
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int p = 0; p < kDPanels; ++p)
          tma_load(q_s + p * kQPanelBytes, &q_map, q_full, p * kPanelCols,
                   w.q0, w.bh);
        for (int kt = 0; kt < w.n_kt; ++kt, ++it) {
          const int st = it % kStages;
          const uint32_t free_ph = ((it / kStages) & 1) ^ 1;
          const int key = w.k0 + kt * kKeys;
          mbar_wait(k_empty(st), free_ph);
          mbar_expect_tx(k_full(st), L::kKBytes);
#pragma unroll
          for (int p = 0; p < kDPanels; ++p)
            tma_load(k_s + st * L::kKBytes + p * kKVPanelBytes, &k_map,
                     k_full(st), p * kPanelCols, key, w.bh);
          mbar_wait(v_empty(st), free_ph);
          mbar_expect_tx(v_full(st), v_panels * kKVPanelBytes);
          for (int p = 0; p < v_panels; ++p)
            tma_load(v_s + st * L::kVBytes + p * kKVPanelBytes, &v_map,
                     v_full(st), p * kPanelCols, key, w.bh);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5, lane = t & 31;
    const int t4 = lane & 3;
    // This thread's rows of the tile: row_in and row_in + 8; its columns of
    // a 64-row accumulator: 8 (i / 4) + 2 t4 + i % 2.
    const int row_in = 16 * warp + (lane >> 2);
    const int col_base = (wg - 1) * kDvHalf;

    // Stores this consumer's columns of O: the flash output (times each
    // row's 1/l, in E) or the decode partial (f32, unnormalised).
    const auto store_o = [&](const float (&o)[kDvHalf / 2], const Work& w,
                             const float (&inv)[2]) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = w.q0 + row_in + 8 * hr;
        if (row >= a.rows) continue;
        if constexpr (kDecode) {
          float* dst = a.part_o +
                       (static_cast<size_t>(w.part) * a.rows + row) * a.dv;
#pragma unroll
          for (int c = 0; c < kDvHalf / 8; ++c) {
            const int col = col_base + c * 8 + 2 * t4;
            if (col < a.dv)
              *reinterpret_cast<float2*>(dst + col) =
                  make_float2(o[4 * c + 2 * hr], o[4 * c + 2 * hr + 1]);
          }
        } else {
          E* dst = static_cast<E*>(a.out) +
                   (static_cast<size_t>(w.bh) * a.rows + row) * a.dv;
#pragma unroll
          for (int c = 0; c < kDvHalf / 8; ++c) {
            const int col = col_base + c * 8 + 2 * t4;
            if (col < a.dv)
              *reinterpret_cast<uint32_t*>(dst + col) =
                  pack2<E>(o[4 * c + 2 * hr] * inv[hr],
                           o[4 * c + 2 * hr + 1] * inv[hr]);
          }
        }
      }
    };

    if (wg == 1) {
      // Consumer 1: S, the softmax, P for both consumers, O's first half.
      float o[kDvHalf / 2];
      float s[kKeys / 2];          // one tile's scores, then its p
      uint32_t pa[kKeys / 16][4];  // p in E: the A fragments of P V
      const uint64_t q_desc = sw128_desc(q_s, 16);
      // S = Q K^T: one wgmma per 16 columns of d, four to a panel. The
      // columns past d are zeros in Q and K.
      const auto issue_qk = [&](int st) {
        const uint64_t k_desc = sw128_desc(k_s + st * L::kKBytes, 16);
#pragma unroll
        for (int p = 0; p < kDPanels; ++p) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint32_t qoff = p * kQPanelBytes + ks * 32;
            const uint32_t koff = p * kKVPanelBytes + ks * 32;
            wgmma_ss_n32<E>(s, q_desc + (qoff >> 4), k_desc + (koff >> 4),
                            p + ks > 0);
          }
        }
        wgmma_commit();
      };
      // O[:, 0:256] += P V, 16 keys per wgmma (two 8-key groups of V).
      const auto issue_pv = [&](int st) {
        const uint64_t v_desc =
            sw128_desc(v_s + st * L::kVBytes, kKVPanelBytes);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wgmma_rs_n256<E>(o, pa[kk], v_desc + ((kk * 2048) >> 4), 1);
        wgmma_commit();
      };
      // The softmax of the key tile at k0t, in place on s (the tuned
      // kernel's, in base 2): s becomes p, l takes its row sums, corr the
      // factor by which O must be rescaled for the new row max.
      const auto softmax = [&](const Work& w, int k0t, float (&m)[2],
                               float (&l)[2], float (&corr)[2]) {
        const int row_a = w.q0 + row_in;
        const bool edge =
            kDecode ? k0t + kKeys > w.k_limit
                    : k0t + kKeys > a.keys ||
                          (a.causal && k0t + kKeys - 1 > w.q0);
        if (edge) {
#pragma unroll
          for (int i = 0; i < kKeys / 2; ++i) {
            const int col = k0t + 8 * (i / 4) + 2 * t4 + (i & 1);
            const int row = row_a + ((i & 2) ? 8 : 0);
            const int limit =
                kDecode ? w.k_limit
                        : (a.causal ? min(row + 1, a.keys) : a.keys);
            if (col >= limit) s[i] = -CUDART_INF_F;
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
          corr[r] = fast_exp2(fmaf(m[r], scale_log2, nbase[r]));
          m[r] = mx[r];
        }
        float ps[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          s[i] = fast_exp2(fmaf(s[i], scale_log2, nbase[(i >> 1) & 1]));
          ps[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
      };
      const auto pack_p = [&]() {
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          pa[kk][0] = pack2<E>(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack2<E>(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack2<E>(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack2<E>(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };
      const auto rescale_o = [&](const float (&corr)[2]) {
#pragma unroll
        for (int i = 0; i < kDvHalf / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      };
      // P of one tile to consumer 2, in the layout of a Q panel: row r's
      // 16-byte chunk c at chunk c ^ (r % 8); pa[kk][j] holds row
      // row_in + 8 (j % 2), keys 16 kk + 8 (j / 2) + 2 t4 (+1).
      int pp = 0;
      const auto publish = [&](const float (&corr)[2], bool last,
                               const float (&inv)[2]) {
        const int sl = pp & 1;
        mbar_wait(p_empty(sl), ((pp >> 1) & 1) ^ 1);
        unsigned char* tile = base_ptr + L::kP + sl * kPBytes;
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = row_in + 8 * (j & 1);
            const int chunk = (2 * kk + (j >> 1)) ^ (row & 7);
            *reinterpret_cast<uint32_t*>(tile + row * kPanelRowBytes +
                                         chunk * 16 + 4 * t4) = pa[kk][j];
          }
        if (t4 == 0) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            stats[sl][0][row_in + 8 * hr] = corr[hr];
            if (last) stats[sl][1][row_in + 8 * hr] = inv[hr];
          }
        }
        fence_proxy_async();
        mbar_arrive(p_full(sl));
        ++pp;
      };
      // Each row's denominator summed over its quad of threads.
      const auto row_sums = [&](const float (&l)[2], float (&sum)[2],
                                float (&inv)[2]) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          inv[r] = 1.f / sum[r];
        }
      };

      int it = 0, nq = 0;
      for (int r = 0; item(r) < n_work; ++r) {
        const Work w = work_of<kDecode>(a, item(r));
        if (w.n_kt == 0) {
          // No valid key in the range: an empty partial for the merge.
          if constexpr (kDecode) {
            const int row = w.q0 + t;
            if (t < kRows && row < a.rows) {
              float* ml = a.part_ml +
                          (static_cast<size_t>(w.part) * a.rows + row) * 2;
              ml[0] = -CUDART_INF_F;
              ml[1] = 0.f;
            }
          }
          continue;
        }
        const int n_kt = w.n_kt;
#pragma unroll
        for (int i = 0; i < kDvHalf / 2; ++i) o[i] = 0.f;
        // Running max of the raw scores q.k of this thread's two rows, and
        // its share of their denominators.
        float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
        float l[2] = {0.f, 0.f};
        float corr[2], sum[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};

        // Key tile 0: S alone.
        mbar_wait(q_full, nq & 1);
        ++nq;
        mbar_wait(k_full(it % kStages), (it / kStages) & 1);
        fence_regs(s);
        wgmma_fence();
        issue_qk(it % kStages);
        wgmma_wait<0>();
        fence_regs(s);
        if (lane == 0) {
          mbar_arrive(k_empty(it % kStages));
          if (n_kt == 1) mbar_arrive(q_empty);
        }
        softmax(w, w.k0, m, l, corr);
        pack_p();
        if (n_kt == 1) row_sums(l, sum, inv);
        publish(corr, n_kt == 1, inv);

        // Key tiles 1 ..: S of tile kt and P V of tile kt - 1 in flight
        // together, the softmax of kt while P V runs.
        for (int kt = 1; kt < n_kt; ++kt) {
          const int st = (it + kt) % kStages;
          const int pst = (it + kt - 1) % kStages;
          mbar_wait(k_full(st), ((it + kt) / kStages) & 1);
          fence_regs(s);
          wgmma_fence();
          issue_qk(st);
          rescale_o(corr);  // to tile kt - 1's max, in the shadow of S
          mbar_wait(v_full(pst), ((it + kt - 1) / kStages) & 1);
          fence_regs(o);
          wgmma_fence();
          issue_pv(pst);
          wgmma_wait<1>();
          fence_regs(s);
          if (lane == 0) {
            mbar_arrive(k_empty(st));  // S is in registers
            if (kt + 1 == n_kt) mbar_arrive(q_empty);
          }
          softmax(w, w.k0 + kt * kKeys, m, l, corr);
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(pa);  // read by the P V in flight until here
          if (lane == 0) mbar_arrive(v_empty(pst));
          pack_p();
          if (kt + 1 == n_kt) row_sums(l, sum, inv);
          publish(corr, kt + 1 == n_kt, inv);
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

        store_o(o, w, inv);
        if constexpr (kDecode) {
          if (t4 == 0) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = w.q0 + row_in + 8 * hr;
              if (row < a.rows) {
                float* ml = a.part_ml +
                            (static_cast<size_t>(w.part) * a.rows + row) * 2;
                ml[0] = m[hr] * scale_log2;
                ml[1] = sum[hr];
              }
            }
          }
        }
      }
    } else {
      // Consumer 2: O's second half, P from shared memory.
      float o[kDvHalf / 2];
      int it = 0, pc = 0;
      for (int r = 0; item(r) < n_work; ++r) {
        const Work w = work_of<kDecode>(a, item(r));
        if (w.n_kt == 0) continue;
#pragma unroll
        for (int i = 0; i < kDvHalf / 2; ++i) o[i] = 0.f;
        float inv[2] = {0.f, 0.f};
        for (int kt = 0; kt < w.n_kt; ++kt, ++it, ++pc) {
          const int st = it % kStages, sl = pc & 1;
          mbar_wait(p_full(sl), (pc >> 1) & 1);
          const float c0 = stats[sl][0][row_in];
          const float c1 = stats[sl][0][row_in + 8];
#pragma unroll
          for (int i = 0; i < kDvHalf / 2; ++i) o[i] *= (i & 2) ? c1 : c0;
          if (kt + 1 == w.n_kt) {
            inv[0] = stats[sl][1][row_in];
            inv[1] = stats[sl][1][row_in + 8];
          }
          mbar_wait(v_full(st), (it / kStages) & 1);
          const uint64_t p_desc = sw128_desc(p_s + sl * kPBytes, 16);
          const uint64_t v_desc = sw128_desc(
              v_s + st * L::kVBytes + (kDvHalf / kPanelCols) * kKVPanelBytes,
              kKVPanelBytes);
          fence_regs(o);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKeys / 16; ++kk)
            wgmma_sst_n256<E>(o, p_desc + ((kk * 32) >> 4),
                              v_desc + ((kk * 2048) >> 4), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
          if (lane == 0) {
            mbar_arrive(v_empty(st));
            mbar_arrive(p_empty(sl));
          }
        }
        store_o(o, w, inv);
      }
    }
  }
}

// The kernels, one per function; the build report names each input type.
template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
    wide_flash_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const Args a) {
  body<E, false>(q_map, k_map, v_map, a);
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
    wide_decode_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const Args a) {
  body<E, true>(q_map, k_map, v_map, a);
}

// The decode splits' merge: one block per (b h, query row). Weights
// 2^(m_s - max m) (a split with m = -inf weighs 0 and its O is not read);
// out = sum w_s O_s / sum w_s l_s in E. With every split empty (a length of
// 0) the output is 0 / 0 = NaN, as the plain version gives. The partials
// hold `ql` rows a split; they are rows row0 .. row0 + ql - 1 of out, which
// has out_rows rows per (b h). The tuned decode kernel's splits
// (decode_attention.cu) are merged here too, f32 among them; dv % 4 == 0.
template <typename E>
__global__ void __launch_bounds__(128)
    wide_decode_merge_kernel(const float* __restrict__ part_o,
                             const float* __restrict__ part_ml,
                             E* __restrict__ out, int ql, int dv,
                             int splits, int out_rows, int row0) {
  const int bh = blockIdx.x / ql, row = blockIdx.x - bh * ql;
  const size_t first = static_cast<size_t>(bh) * splits * ql + row;
  float mx = -CUDART_INF_F;
  for (int sp = 0; sp < splits; ++sp)
    mx = fmaxf(mx, part_ml[(first + static_cast<size_t>(sp) * ql) * 2]);
  float den = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* ml = part_ml + (first + static_cast<size_t>(sp) * ql) * 2;
    if (ml[0] != -CUDART_INF_F) den += exp2f(ml[0] - mx) * ml[1];
  }
  const float inv = 1.f / den;
  E* dst = out + (static_cast<size_t>(bh) * out_rows + row0 + row) * dv;
  for (int c = 4 * threadIdx.x; c < dv; c += 4 * blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const size_t at = first + static_cast<size_t>(sp) * ql;
      const float m = part_ml[at * 2];
      if (m == -CUDART_INF_F) continue;
      const float wt = exp2f(m - mx);
      const float4 x = *reinterpret_cast<const float4*>(part_o + at * dv + c);
      acc.x = fmaf(wt, x.x, acc.x);
      acc.y = fmaf(wt, x.y, acc.y);
      acc.z = fmaf(wt, x.z, acc.z);
      acc.w = fmaf(wt, x.w, acc.w);
    }
    if constexpr (std::is_same<E, float>::value) {
      *reinterpret_cast<float4*>(dst + c) = make_float4(
          acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    } else {
      *reinterpret_cast<uint32_t*>(dst + c) =
          pack2<E>(acc.x * inv, acc.y * inv);
      *reinterpret_cast<uint32_t*>(dst + c + 2) =
          pack2<E>(acc.z * inv, acc.w * inv);
    }
  }
}

// ---- launch ---------------------------------------------------------------

// The padded head dims the path takes: multiples of 16, d <= 576, dv <= 512.
inline bool dims_ok(int d, int dv) {
  return d >= kDimStep && dv >= kDimStep && d <= kMaxD && dv <= kMaxDv &&
         d % kDimStep == 0 && dv % kDimStep == 0;
}

// Encodes the Q, K and V maps ([n_bh, rows or keys, cols] each), sets the
// kernel's shared memory, and launches it on `grid` blocks.
template <typename E, typename K>
int launch_body(K kernel, const void* q, const void* k, const void* v,
                const Args& a, int grid, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map<E>(&q_map, q, a.n_bh, a.rows, a.d, kRows) ||
      !encode_map<E>(&k_map, k, a.n_bh, a.keys, a.d, kKeys) ||
      !encode_map<E>(&v_map, v, a.n_bh, a.keys, a.dv, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, Layout::kSmemBytes, stream>>>(q_map, k_map, v_map,
                                                         a);
  return static_cast<int>(cudaGetLastError());
}

// Flash attention on q, k [bh, S, d] and v [bh, S, dv] (padded dims) into
// out [bh, S, dv]: a persistent grid of at most one block an SM.
template <typename E>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int bh, int S, int d, int dv, int causal, float scale,
                 cudaStream_t stream) {
  if (bh < 1 || S < 1 || !dims_ok(d, dv))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{};
  a.n_bh = bh;
  a.rows = a.keys = S;
  a.d = d;
  a.dv = dv;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.causal = causal;
  a.out = out;
  const long long n_work =
      static_cast<long long>(bh) * ((S + kRows - 1) / kRows);
  const int grid = n_work < sms ? static_cast<int>(n_work) : sms;
  return launch_body<E>(wide_flash_kernel<E>, q, k, v, a, grid, stream);
}

// Decode attention on q [b h, ql, d], k [b h, cap, d] and v [b h, cap, dv]
// (padded dims) into out [b h, ql, dv]: one block per (b h, split, 64-row
// tile) writing f32 partials into part_o [b h, splits, ql, dv] and part_ml
// [b h, splits, ql, 2], then the merge. Split s takes keys
// [s split_keys, (s + 1) split_keys); split_keys is a multiple of 32.
template <typename E>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* lens, void* out, void* part_o, void* part_ml,
                  int b, int h, int ql, int cap, int d, int dv, float scale,
                  int splits, int split_keys, cudaStream_t stream) {
  if (b < 1 || h < 1 || ql < 1 || cap < 1 || !dims_ok(d, dv) ||
      splits < 1 || split_keys < kKeys || split_keys % kKeys != 0 ||
      static_cast<long long>(splits - 1) * split_keys >= cap)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_work = static_cast<long long>(b) * h * splits *
                           ((ql + kRows - 1) / kRows);
  const long long rows = static_cast<long long>(b) * h * ql;
  if (n_work > 0x7fffffff || rows > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.n_bh = b * h;
  a.rows = ql;
  a.keys = cap;
  a.d = d;
  a.dv = dv;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.lens = static_cast<const int*>(lens);
  a.h = h;
  a.splits = splits;
  a.split_keys = split_keys;
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  const int err = launch_body<E>(wide_decode_kernel<E>, q, k, v, a,
                                 static_cast<int>(n_work), stream);
  if (err != 0) return err;
  wide_decode_merge_kernel<E><<<static_cast<int>(rows), 128, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<E*>(out), ql, dv, splits, ql, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide
}  // namespace
