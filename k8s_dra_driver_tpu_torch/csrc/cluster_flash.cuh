// Flash attention for NVIDIA Hopper (sm_90a) at any head dims and in any
// mix of dtypes, on the tensor cores: every call that the tuned and wide
// flash kernels (flash_attention.cu) do not take. That is every call with an
// f32 operand (q, k and v all f32; an f32 q over a 16-bit K and V; a 16-bit
// q over an f32 one), every mix of the two 16-bit dtypes, and head dims past
// padded 576/512 in every dtype. Built by cluster_flash_q32.cu (an f32 q)
// and cluster_flash_q16.cu (a bf16 or f16 q), each its own nvcc job.
//
// It replaces, for those calls, the TPU kernel `_flash_kernel`, reached
// through `flash_attention` (k8s_dra_driver_tpu/compute/flashattention.py),
// and computes its function: scores q.k of the upcast values accumulated in
// f32 and scaled by 1/sqrt(d) of the true d; the causal mask; an online
// softmax in f32 (base 2); p rounded to V's dtype before P V (f32 V: not
// rounded), which accumulates in f32; the output in q's dtype. Every operand
// is read in its own dtype (TMA copies it as it is), and each keeps its
// accuracy in the products: a 16-bit operand is exact in TF32 and enters a
// product once, an f32 one as hi and lo (3xTF32; f32tc_attention.cuh says
// why), so S takes 1 + [q f32] + [k f32] TF32 products a multiply-add and
// P V 1 (16-bit V, p rounded to it) or 3 (f32 V).
//
// What bounds it: operations, each product at its operands' own rate. At
// [1, 8, 2048] with d = dv = 1024 that is 137 GFLOP: 0.139 ms in bf16 at
// 989.4 TFLOP/s (this kernel issues them as TF32 products, 0.28 ms at
// 494.7), in f32 three TF32 products each (0.83 ms). In f32 at [4, 8, 2048,
// 128] it is 0.417 ms, at [1, 16, 2048] with 576/512 0.886 ms.
//
// The design: the f32 tensor-core body of the f32 and mixed decode
// (f32tc_attention.cuh: a TMA ring of 32-column panels, split warps that
// write K's f32 or lo plane and V transposed as hi and lo planes, one
// consumer warpgroup issuing TF32 `wgmma`s with Q and P as register A
// operands) with a flag an operand (kQ16, kK16, kV16), and a thread-block
// cluster so that S is computed once per key tile whatever dv is:
//   * a cluster of C CTAs (C = dv's 256-column slices, at most 8; the
//     wrapper's `cluster_flash_plan`) takes one 64-row query tile. CTA r
//     streams its own share of d: panel groups of kDP panels, groups
//     [r G, (r + 1) G) of d's, G from the wrapper, a group wholly past d
//     skipped, under a run-time loop whose body issues its
//     `wgmma`s to a compile-time count (a run-time count on that loop
//     serialised every HGMMA of the wide kernels, PERF.md); it adds the
//     partial S of its share;
//   * the partials are summed through distributed shared memory: each
//     consumer thread writes its 32 partial scores into its CTA's exchange
//     buffer (two, by key tile), each consumer warp arrives on every other
//     CTA's mbarrier (release at cluster scope), each thread waits on its
//     own (acquire) and reads the same thread's partials of every CTA in
//     rank order, so every CTA holds the same S to the bit;
//   * every CTA runs the same online softmax over that S and computes P V
//     for its own 256-column slice of dv (VP panels of 32 columns); so K and
//     V are each read once per query tile and no multiply-add is repeated.
//     Past 8 slices (dv over 2,048) a query tile takes one cluster item per
//     2,048 columns, each computing S again;
//   * the grid is persistent, at most the clusters that fit the card at
//     once (`cudaOccupancyMaxActiveClusters`), over (query tile, b h, column
//     chunk) with the most keys first, dealt to the clusters in a snake;
//     under causal no key tile past a query tile's last row is loaded;
//   * the ring's stages are sized for the dtype class (`Plan`): a 16-bit
//     panel takes half an f32 one's bytes, so the ring holds 12 stages where
//     q, K and V are 16-bit, 8 where they are f32 (the decode body holds 6
//     of 32 KB), and more loads are in flight ahead of the split warps and
//     the consumers;
//   * compile-time buckets: VP = 4 panels (dv up to 128) or 8, times the
//     eight dtype classes: 16 kernels in two sources.
// Where d is one group of 128 columns or less, the plan takes one CTA a
// cluster, each 256-column slice of dv an item that computes S itself: the
// exchange cost more than S of so narrow a d (PERF.md).
// What holds it back (PERF.md, `chip_ab.py cluster-parts`): the body's
// efficiency (a fifth to a third of the bound at the f32 and mixed
// headlines), and the exchange, a stall of every CTA of the cluster each key
// tile until the slowest has its partial (at 1,024/1,024 in bf16, 2.80 ms
// with it against 1.65 ms with it left out).
// There is no fallback: a call that cannot build or launch raises.

#pragma once

#include <math_constants.h>

#include "hopper.cuh"

namespace {
namespace cflash {

constexpr int kRows = 64;                      // query rows per tile
constexpr int kKeys = 64;                      // keys per K/V tile
constexpr int kCols = kPanelColsF32;           // f32 columns per panel
constexpr int kDP = 4;                         // d panels a group
constexpr int kMaxCluster = 8;                 // CTAs a cluster
constexpr int kDimStep = 16;                   // d, dv multiples of it
constexpr int kThreads = 256;
constexpr int kSplitThreads = 96;              // warps 1-3
constexpr int kConsumerThreads = 128;          // warps 4-7
constexpr int kPanelBytes = kRows * 128;       // 64 rows x 128 bytes: 8 KB
constexpr int kMaxStages = 12;
// The S exchange: two buffers of 128 threads x 32 floats.
constexpr int kXBufBytes = kConsumerThreads * 32 * 4;

// The shared memory of a dtype class (q, K and V 16-bit or not): a ring of
// stages, each of the bytes the larger of an S stage and a P V stage takes,
// as many as fit beside the exchange buffers and the barriers (at most
// kMaxStages): 12 stages of 16 KB where q, K and V are all 16-bit, 8 of 24
// KB where all are f32. An S stage: Q's panel as TMA copies it, K's f32
// panel (a raw f32 panel, or the split warps' f32 copy of a 16-bit one),
// then K's 16-bit panel as copied, or K's lo plane. A P V stage: V's panel
// as copied, then V transposed as a hi and (f32 V) a lo plane. Every plane
// starts on a 1,024-byte boundary, as the swizzled operands must.
template <bool kQ16, bool kK16, bool kV16>
struct Plan {
  static constexpr int kQBytes = kQ16 ? kPanelBytes / 2 : kPanelBytes;
  static constexpr int kKBytes = kK16 ? kPanelBytes / 2 : kPanelBytes;
  static constexpr int kVBytes = kV16 ? kPanelBytes / 2 : kPanelBytes;
  static constexpr int kKHi = kQBytes;
  static constexpr int kKSecond = kKHi + kPanelBytes;
  static constexpr int kSBytes = kKSecond + kKBytes;
  static constexpr int kVHi = kVBytes;
  static constexpr int kVLo = kVHi + kPanelBytes;
  static constexpr int kVStageBytes = kVLo + (kV16 ? 0 : kPanelBytes);
  static constexpr int kStageBytes =
      kSBytes > kVStageBytes ? kSBytes : kVStageBytes;
  static constexpr int kFit =
      (232448 - 1024 - 2 * kXBufBytes - (3 * kMaxStages + 2) * 8) /
      kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kXOffset = kStages * kStageBytes;
  static constexpr int kBarsOffset = kXOffset + 2 * kXBufBytes;
  static constexpr int kSmemBytes = 1024 + kBarsOffset + (3 * kStages + 2) * 8;
  static_assert(kStageBytes % 1024 == 0, "planes on 1,024-byte boundaries");
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block may have");
};

// What a launch computes: q, k [n_bh, S, d] and v [n_bh, S, dv] (padded
// dims) into out [n_bh, S, dv] in q's dtype. cluster: CTAs a cluster (C);
// groups: d panel groups a CTA (G); chunk: the output columns one cluster
// item takes (C VP 32); q_f16, k_f16, v_f16: a 16-bit operand's kind (1
// f16, 0 bf16), read where the kernel is built for it.
struct Args {
  int n_bh, S, d, dv, cluster, groups, chunk;
  float scale_log2;
  int causal;
  void* out;
  int q_f16, k_f16, v_f16;
};

struct Work {
  int bh, q0, c0, n_kt, k_limit;
};

// The low 16 bits of `bits` as f32 (exact): f16 where kF16, else bf16.
template <bool kF16>
__device__ __forceinline__ float from16_as(uint32_t bits) {
  if constexpr (kF16)
    return __half2float(__ushort_as_half(static_cast<uint16_t>(bits)));
  else
    return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster, at the start (barriers initialised) and at
// the end (no CTA leaves while another may still read its shared memory).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// The address of the same shared-memory byte in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// One arrival on a barrier of another CTA of the cluster, ordering this
// thread's earlier shared-memory writes before it at cluster scope.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t cluster_addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_addr)
      : "memory");
}

// Until phase `parity` of a local barrier has completed, acquiring at
// cluster scope what the arrivals from other CTAs released.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t cluster_addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(cluster_addr)
               : "memory");
  return x;
}

// How many of its a.groups panel groups this CTA takes: those that start
// inside d (read afresh where used: the consumers have no register to
// spare).
__device__ __forceinline__ int groups_here(const Args& a) {
  const int d_groups = (a.d + kDP * kCols - 1) / (kDP * kCols);
  return max(0, min(a.groups,
                    d_groups - static_cast<int>(cluster_rank()) * a.groups));
}

__device__ __forceinline__ int n_chunks(const Args& a) {
  return (a.dv + a.chunk - 1) / a.chunk;
}

__device__ __forceinline__ int n_work(const Args& a) {
  return a.n_bh * ((a.S + kRows - 1) / kRows) * n_chunks(a);
}

// Item j of the cluster: the most keys first (the last query tiles of every
// (b h), then the ones before), each in its column chunks; this CTA's
// columns start at c0.
__device__ __forceinline__ Work work_of(const Args& a, int j, int rank,
                                        int vp_cols) {
  const int n_rt = (a.S + kRows - 1) / kRows;
  const int nc = n_chunks(a);
  const int rest = j / nc;
  Work w;
  w.c0 = (j - rest * nc) * a.chunk + rank * vp_cols;
  w.bh = rest % a.n_bh;
  w.q0 = (n_rt - 1 - rest / a.n_bh) * kRows;
  w.k_limit = a.causal ? min(a.S, w.q0 + kRows) : a.S;
  w.n_kt = (w.k_limit + kKeys - 1) / kKeys;
  return w;
}

// The body. VP: 32-column panels of V a CTA; kQ16, kK16, kV16: q, K, V
// 16-bit (bf16 or f16 by a.q_f16, a.k_f16, a.v_f16) rather than f32. A
// 16-bit panel is copied by TMA in its own dtype (32 columns, 64-byte rows
// in the 64-byte swizzle, `sw64_offset`): a K panel lands in plane 3 and
// the split warps write it as f32 into plane 1 (where a raw f32 panel is
// the hi plane, and the split warps write its lo into plane 3); a V panel's
// transposed hi plane comes from its own dtype (no lo plane); a 16-bit Q is
// converted in the consumers' registers.
template <int VP, bool kQ16, bool kK16, bool kV16>
__device__ __forceinline__ void body(const CUtensorMap& q_map,
                                     const CUtensorMap& k_map,
                                     const CUtensorMap& v_map,
                                     const Args& a) {
  const float scale_log2 = a.scale_log2;  // 1/sqrt(d) log2(e)
  using P = Plan<kQ16, kK16, kV16>;
  constexpr int kStages = P::kStages, kStageBytes = P::kStageBytes;
  constexpr int kQBytes = P::kQBytes, kKBytes = P::kKBytes,
                kVBytes = P::kVBytes;
  const bool q_f16 = a.q_f16 != 0, k_f16 = a.k_f16 != 0,
             v_f16 = a.v_f16 != 0;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + P::kBarsOffset;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto split = [&](int st) { return bars + 8 * (kStages + st); };
  const auto empty = [&](int st) { return bars + 8 * (2 * kStages + st); };
  const auto xfull = [&](int b) { return bars + 8 * (3 * kStages + b); };
  const auto stage = [&](int st) { return base + st * kStageBytes; };
  const auto xbuf = [&](int b) {
    return base + P::kXOffset + b * kXBufBytes;
  };
  unsigned char* const base_ptr = smem_raw + (base - raw);

  // The cluster's shape and this CTA's place in it are read where they are
  // used (special registers, the kernel's arguments): the consumers have no
  // register to spare.
  const int work = n_work(a);
  const auto item = [&](int r) {
    const int ncl = static_cast<int>(cluster_count());
    const int cid = static_cast<int>(cluster_id());
    return r * ncl + ((r & 1) ? ncl - 1 - cid : cid);
  };
  // This CTA's d panel groups: [rank G, rank G + g_r), those that start
  // inside d.
  const int g_first = static_cast<int>(cluster_rank()) * a.groups;
  const int g_r = groups_here(a);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(split(st), kSplitThreads);
      mbar_init(empty(st), 4);  // lane 0 of each consumer warp
    }
    for (int b = 0; b < 2; ++b)  // lane 0 of each consumer warp of the others
      mbar_init(xfull(b), a.cluster > 1 ? (a.cluster - 1) * 4 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  const int warp_id = threadIdx.x / 32;
  if (warp_id == 0) {
    // Producer: one thread issues every load. Per key tile, the S stages
    // (Q's and K's panel p of this CTA's groups), then the P V stages (V's
    // panels of this CTA's columns).
    if (threadIdx.x == 0) {
      int it = 0;
      for (int r = 0; item(r) < work; ++r) {
        const Work w = work_of(a, item(r), static_cast<int>(cluster_rank()),
                            VP * kCols);
        for (int kt = 0; kt < w.n_kt; ++kt) {
          const int key = kt * kKeys;
          for (int g = 0; g < g_r; ++g) {
            for (int p = 0; p < kDP; ++p, ++it) {
              const int st = it % kStages;
              const int col = ((g_first + g) * kDP + p) * kCols;
              mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
              mbar_expect_tx(full(st), kQBytes + kKBytes);
              tma_load(stage(st), &q_map, full(st), col, w.q0, w.bh);
              tma_load(stage(st) + (kK16 ? P::kKSecond : P::kKHi), &k_map,
                       full(st), col, key, w.bh);
            }
          }
          for (int vp = 0; vp < VP; ++vp, ++it) {
            const int st = it % kStages;
            mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(full(st), kVBytes);
            tma_load(stage(st), &v_map, full(st), w.c0 + vp * kCols, key,
                     w.bh);
          }
        }
      }
    }
  } else if (warp_id < 4) {
    // The split pass, 96 threads (f32tc_attention.cuh's, per operand): S
    // stages, K's f32 plane from a 16-bit panel or K's lo plane; P V stages,
    // V's panel transposed into a hi plane (and a lo plane for f32 V), keys
    // permuted to TF32's A fragment order.
    const int ts = threadIdx.x - 32;
    int it = 0;
    for (int r = 0; item(r) < work; ++r) {
      const Work w = work_of(a, item(r), static_cast<int>(cluster_rank()),
                            VP * kCols);
      for (int kt = 0; kt < w.n_kt; ++kt) {
        for (int p = 0; p < g_r * kDP; ++p, ++it) {
          const int st = it % kStages;
          mbar_wait(full(st), (it / kStages) & 1);
          unsigned char* const s = base_ptr + st * kStageBytes;
          if constexpr (kK16) {
            // K's 16-bit panel as f32, a 16-byte chunk (8 columns) a task;
            // the kind's conversion chosen once, outside the loop.
            const auto convert = [&](auto is_f16) {
#pragma unroll 3
              for (int i = ts; i < kKeys * 4; i += kSplitThreads) {
                const int key = i >> 2, c8 = i & 3;
                const uint4 raw16 = *reinterpret_cast<const uint4*>(
                    s + P::kKSecond + sw64_offset(key, 8 * c8));
                const uint32_t w4[4] = {raw16.x, raw16.y, raw16.z, raw16.w};
                float f[8];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  f[2 * e] = from16_as<decltype(is_f16)::value>(w4[e]);
                  f[2 * e + 1] =
                      from16_as<decltype(is_f16)::value>(w4[e] >> 16);
                }
                unsigned char* const row = s + P::kKHi + key * 128;
                *reinterpret_cast<float4*>(
                    row + (((2 * c8) ^ (key & 7)) << 4)) =
                    make_float4(f[0], f[1], f[2], f[3]);
                *reinterpret_cast<float4*>(
                    row + (((2 * c8 + 1) ^ (key & 7)) << 4)) =
                    make_float4(f[4], f[5], f[6], f[7]);
              }
            };
            if (k_f16)
              convert(std::true_type{});
            else
              convert(std::false_type{});
          } else {
#pragma unroll 6
            for (int i = ts; i < kPanelBytes / 16; i += kSplitThreads) {
              const float4 x =
                  *reinterpret_cast<const float4*>(s + P::kKHi + 16 * i);
              *reinterpret_cast<float4*>(s + P::kKSecond + 16 * i) =
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
          // Thread task (column c, group g of 8 keys, parity): keys 8 g +
          // parity + 2 j, j = 0..3, into slots 8 g + 4 parity + j of row c
          // of the transposed plane; a 16-bit V's task takes the column
          // pair c, c + 1 (one 32-bit read a key).
          constexpr int kPair = kV16 ? 2 : 1;
          const auto transpose = [&](auto is_f16) {
#pragma unroll(kV16 ? 3 : 6)
            for (int i = ts; i < kCols / kPair * 2 * (kKeys / 8);
                 i += kSplitThreads) {
              const int c = kPair * (i % (kCols / kPair));
              const int task = i / (kCols / kPair);
              const int g = task >> 1, par = task & 1;
              float hi[kPair][4];
              [[maybe_unused]] float lo[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int key = 8 * g + par + 2 * j;
                if constexpr (kV16) {
                  const uint32_t two16 = *reinterpret_cast<const uint32_t*>(
                      s + sw64_offset(key, c));
                  hi[0][j] = from16_as<decltype(is_f16)::value>(two16);
                  hi[kPair - 1][j] =
                      from16_as<decltype(is_f16)::value>(two16 >> 16);
                } else {
                  const float x = *reinterpret_cast<const float*>(
                      s + key * 128 + (((c >> 2) ^ (key & 7)) << 4) +
                      4 * (c & 3));
                  hi[0][j] = tf32_rna(x);
                  lo[j] = x - hi[0][j];
                }
              }
              const int chunk = 2 * (g & 3) + par;
#pragma unroll
              for (int e = 0; e < kPair; ++e) {
                const int off = (g >> 2) * (kPanelBytes / 2) + (c + e) * 128 +
                                ((chunk ^ ((c + e) & 7)) << 4);
                *reinterpret_cast<float4*>(s + P::kVHi + off) =
                    make_float4(hi[e][0], hi[e][1], hi[e][2], hi[e][3]);
                if constexpr (!kV16)
                  *reinterpret_cast<float4*>(s + P::kVLo + off) =
                      make_float4(lo[0], lo[1], lo[2], lo[3]);
              }
            }
          };
          if (kV16 && v_f16)
            transpose(std::true_type{});
          else
            transpose(std::false_type{});
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
    const int row_in = 16 * warp + (lane >> 2);
    float o[VP][16];
    float s[kKeys / 2];
    uint32_t p_hi[kKeys / 8][4], p_lo[kKeys / 8][4];
    const auto pinned = [](uint32_t at) {
      asm volatile("" : "+r"(at));
      return at;
    };
    const auto release = [&](int it) {
      if (lane == 0) mbar_arrive(empty(it % kStages));
    };
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
    // One group of S = Q K^T: kDP panels of this CTA's share of d, stage by
    // stage, a commit group per k-step (lo.hi, hi.lo, hi.hi: the small terms
    // first, the lo products only of f32 operands), each adding to s (zeroed
    // before a key tile's first group).
    const auto scores = [&](int it) {
#pragma unroll
      for (int p = 0; p < kDP; ++p) {
        const int st = (it + p) % kStages;
        const uint32_t ph = ((it + p) / kStages) & 1;
        mbar_wait(full(st), ph);
        const uint32_t at = pinned(stage(st));
        const uint64_t kh = sw128_desc(at + P::kKHi, 16);
        const uint64_t kl = sw128_desc(at + P::kKSecond, 16);
#pragma unroll
        for (int ks = 0; ks < kCols / 8; ++ks) {
          const int b = ks & 1;
          load_q(st, ks);
          if (ks == 0) mbar_wait(split(st), ph);
          if (p + ks == 0) fence_regs(s);
          wgmma_fence();
          const uint32_t off = (ks * 32) >> 4;
          if constexpr (!kQ16) wgmma_tf32_rs_n64(s, q_lo[b], kh + off, 1);
          if constexpr (!kK16) wgmma_tf32_rs_n64(s, q_hi[b], kl + off, 1);
          wgmma_tf32_rs_n64(s, q_hi[b], kh + off, 1);
          wgmma_commit();
          if (p + ks > 0) {
            wgmma_wait<1>();
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
      release(it + kDP - 1);
    };
    // O += P V over the VP panels of this CTA's columns.
    const auto values = [&](int it) {
#pragma unroll
      for (int vp = 0; vp < VP; ++vp) {
        const int st = (it + vp) % kStages;
        mbar_wait(split(st), ((it + vp) / kStages) & 1);
        const uint32_t at = pinned(stage(st));
        const uint64_t vh = sw128_desc(at + P::kVHi, 16);
        const uint64_t vl = sw128_desc(at + P::kVLo, 16);
        fence_regs(o[vp]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKeys / 8; ++ks) {
          const uint32_t off =
              ((ks >> 2) * (kPanelBytes / 2) + (ks & 3) * 32) >> 4;
          if constexpr (!kV16) {
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
      if constexpr (!kV16) fence_regs(p_lo);
      release(it + VP - 1);
    };
    // The cluster's S: this thread's partial into exchange buffer xb, an
    // arrival on each other CTA's barrier, then the partials of every CTA
    // (this one's too, from its own buffer) summed in rank order into s, so
    // that every CTA holds the same S to the bit. A CTA's partial is read
    // with its 8 loads in flight at once.
    const auto exchange = [&](int tc) {
      const int xb = tc & 1;
      const uint32_t mine = xbuf(xb) + 16 * t;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(base_ptr + (mine - base) +
                                   i * kConsumerThreads * 16) =
            make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      // One arrival a warp on each other CTA's barrier, after the warp's
      // writes (__syncwarp orders them before lane 0's release).
      const int rank = static_cast<int>(cluster_rank());
      __syncwarp();
      if (lane == 0)
        for (int j = 0; j < a.cluster; ++j)
          if (j != rank)
            mbar_arrive_remote(
                map_rank(xfull(xb), static_cast<uint32_t>(j)));
      mbar_wait_cluster(xfull(xb), (tc >> 1) & 1);
      for (int j = 0; j < a.cluster; ++j) {
        // A CTA's 8 loads issued together (one round trip a CTA), its own
        // partial from its own shared memory.
        float4 x[8];
        if (j == rank) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            x[i] = *reinterpret_cast<const float4*>(
                base_ptr + (mine - base) + i * kConsumerThreads * 16);
        } else {
          const uint32_t at = map_rank(mine, static_cast<uint32_t>(j));
#pragma unroll
          for (int i = 0; i < 8; ++i)
            x[i] = ld_cluster_f4(at + i * kConsumerThreads * 16);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[4 * i] = j ? s[4 * i] + x[i].x : x[i].x;
          s[4 * i + 1] = j ? s[4 * i + 1] + x[i].y : x[i].y;
          s[4 * i + 2] = j ? s[4 * i + 2] + x[i].z : x[i].z;
          s[4 * i + 3] = j ? s[4 * i + 3] + x[i].w : x[i].w;
        }
      }
    };
    const auto softmax = [&](const Work& w, int k0t, float (&m)[2],
                             float (&l)[2], float (&corr)[2]) {
      const int row_a = w.q0 + row_in;
      const bool edge = k0t + kKeys > a.S ||
                        (a.causal && k0t + kKeys - 1 > w.q0);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const int col = k0t + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int row = row_a + ((i & 2) ? 8 : 0);
          const int limit = a.causal ? min(row + 1, a.S) : a.S;
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
    // P's TF32 A fragments (f32tc_attention.cuh's key order); with 16-bit V,
    // p rounded to V's dtype alone (l keeps the unrounded sum).
    const auto split_p = [&]() {
#pragma unroll
      for (int ks = 0; ks < kKeys / 8; ++ks) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = s[4 * ks + 2 * (j & 1) + (j >> 1)];
          if constexpr (kV16) {
            p_hi[ks][j] = __float_as_uint(round16(x, v_f16));
          } else {
            const float hi = tf32_rna(x);
            p_hi[ks][j] = __float_as_uint(hi);
            p_lo[ks][j] = __float_as_uint(x - hi);
          }
        }
      }
    };

    int it = 0, tc = 0;
    for (int r = 0; item(r) < work; ++r) {
      const Work w = work_of(a, item(r), static_cast<int>(cluster_rank()),
                            VP * kCols);
#pragma unroll
      for (int vp = 0; vp < VP; ++vp)
#pragma unroll
        for (int i = 0; i < 16; ++i) o[vp][i] = 0.f;
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
      float l[2] = {0.f, 0.f};
      float corr[2];
      for (int kt = 0; kt < w.n_kt; ++kt, ++tc) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
        for (int g = groups_here(a); g > 0; --g) {
          scores(it);
          it += kDP;
        }
        if (a.cluster > 1) exchange(tc);
        softmax(w, kt * kKeys, m, l, corr);
#pragma unroll
        for (int vp = 0; vp < VP; ++vp)
#pragma unroll
          for (int i = 0; i < 16; ++i) o[vp][i] *= corr[(i >> 1) & 1];
        split_p();
        values(it);
        it += VP;
      }
      float inv[2];
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        float sum = l[r2] + __shfl_xor_sync(0xffffffffu, l[r2], 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        inv[r2] = 1.f / sum;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = w.q0 + row_in + 8 * hr;
        if (row >= a.S) continue;
        const size_t at = (static_cast<size_t>(w.bh) * a.S + row) * a.dv;
#pragma unroll
        for (int vp = 0; vp < VP; ++vp)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = w.c0 + vp * kCols + 8 * c + 2 * t4;
            if (col >= a.dv) continue;
            const float x0 = o[vp][4 * c + 2 * hr] * inv[hr];
            const float x1 = o[vp][4 * c + 2 * hr + 1] * inv[hr];
            if constexpr (kQ16) {
              *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(a.out) +
                                           at + col) =
                  q_f16 ? pack2<f16>(x0, x1) : pack2<bf16>(x0, x1);
            } else {
              *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at +
                                         col) = make_float2(x0, x1);
            }
          }
      }
    }
  }
  cluster_sync();
}

// One kernel per V bucket and dtype class; the build report names each
// (<VP, q 16-bit, K 16-bit, V 16-bit>).
template <int VP, bool kQ16, bool kK16, bool kV16>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_flash_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const Args a) {
  body<VP, kQ16, kK16, kV16>(q_map, k_map, v_map, a);
}

// ---- launch ---------------------------------------------------------------

// The padded head dims the kernels take: multiples of 16.
inline bool dims_ok(int d, int dv) {
  return d >= kDimStep && dv >= kDimStep && d % kDimStep == 0 &&
         dv % kDimStep == 0;
}

// Flash attention on q, k [bh, S, d] and v [bh, S, dv] (padded dims; q's
// dtype kQ16, by kind q_f16; K's and V's by their codes) into out [bh, S,
// dv] in q's dtype: clusters of `cluster` CTAs, each CTA taking `groups`
// groups of kDP d panels and vp 32-column panels of dv (4 or 8), a
// persistent grid of the clusters that fit at once. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for arguments it does not take).
template <bool kQ16>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int S, int d, int dv, int causal, float scale, int q_f16,
           int k_type, int v_type, int cluster, int groups, int vp,
           cudaStream_t stream) {
  const auto ok = [](int t) { return t >= 0 && t <= 2; };
  if (bh < 1 || S < 1 || !dims_ok(d, dv) || !ok(k_type) || !ok(v_type) ||
      cluster < 1 || cluster > kMaxCluster || groups < 1 ||
      (vp != 4 && vp != 8) ||
      static_cast<long long>(cluster) * groups * kDP * kCols <
          static_cast<long long>(d) ||
      (vp == 4 && cluster != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.n_bh = bh;
  a.S = S;
  a.d = d;
  a.dv = dv;
  a.cluster = cluster;
  a.groups = groups;
  a.chunk = cluster * vp * kCols;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.causal = causal;
  a.out = out;
  a.q_f16 = q_f16;
  a.k_f16 = k_type == 2;
  a.v_f16 = v_type == 2;
  const long long n_work = static_cast<long long>(bh) *
                           ((S + kRows - 1) / kRows) *
                           ((dv + a.chunk - 1) / a.chunk);
  if (n_work > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const bool k16 = k_type != 0, v16 = v_type != 0;
  const auto encode = [](bool is16, CUtensorMap* map, const void* ptr,
                         int n_bh, int rows, int cols, int box) {
    return is16 ? encode_map_16_narrow(map, ptr, n_bh, rows, cols, box)
                : encode_map_f32(map, ptr, n_bh, rows, cols, box);
  };
  CUtensorMap q_map, k_map, v_map;
  if (!encode(kQ16, &q_map, q, bh, S, d, kRows) ||
      !encode(k16, &k_map, k, bh, S, d, kKeys) ||
      !encode(v16, &v_map, v, bh, S, dv, kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto go = [&](auto kernel, int smem) -> int {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    // As many clusters as fit the card at once (one CTA an SM), at most
    // one an item.
    int fit = 0;
    config.gridDim = dim3(cluster);
    e = cudaOccupancyMaxActiveClusters(&fit, kernel, &config);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int clusters = n_work < fit ? static_cast<int>(n_work) : fit;
    config.gridDim = dim3(clusters * cluster);
    e = cudaLaunchKernelEx(&config, kernel, q_map, k_map, v_map, a);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  };
  // The dtype class and V bucket as template arguments.
  const auto by_v = [&](auto k16c) -> int {
    constexpr bool kK = decltype(k16c)::value;
    if (v16) {
      constexpr int kSmem = Plan<kQ16, kK, true>::kSmemBytes;
      return vp == 4 ? go(cluster_flash_kernel<4, kQ16, kK, true>, kSmem)
                     : go(cluster_flash_kernel<8, kQ16, kK, true>, kSmem);
    }
    constexpr int kSmem = Plan<kQ16, kK, false>::kSmemBytes;
    return vp == 4 ? go(cluster_flash_kernel<4, kQ16, kK, false>, kSmem)
                   : go(cluster_flash_kernel<8, kQ16, kK, false>, kSmem);
  };
  return k16 ? by_v(std::integral_constant<bool, true>{})
             : by_v(std::integral_constant<bool, false>{});
}

}  // namespace cflash
}  // namespace
