// Decode attention for NVIDIA Hopper (sm_90a) whose q is in one dtype and
// whose K/V cache shares another (an f32 q over a bf16 or f16 cache, a
// 16-bit q over an f32 cache, a bf16 q over an f16 cache or the reverse),
// with d or dv over 256 up to padded 576/512: DeepSeek-V3's absorbed-MLA
// decode (128 query rows against one latent head of 576/512) with an f32
// query over a bf16 latent cache is the case it is built for. The kernel is
// the f32 tensor-core body's decode kernel (f32tc_attention.cuh), built
// here in a job of its own, with the wide path's merge.
//
// Replaces, for such inputs, the TPU kernel `_decode_kernel`, reached
// through `flash_attention_decode`
// (k8s_dra_driver_tpu/compute/flashattention.py), and computes its
// function: scores q.k of the upcast values accumulated in f32 and scaled by
// 1/sqrt(d) of the true d; keys at index >= kv_lengths[b] masked; an online
// softmax in f32; p rounded to V's dtype before P V (f32 V: not rounded),
// which accumulates in f32; the output in q's dtype. Every operand is read
// in its own dtype (no cast or copy of the cache by the wrapper), and an f32
// operand keeps f32 accuracy in its products: its hi and lo parts both
// enter (3xTF32), while a 16-bit operand is exact in TF32 and enters once.
// Every query row goes in one launch (the general SIMT kernel took one
// launch per 8 rows, each reading the whole cache), the cache split across
// blocks by a count the wrapper takes from the shapes and the SM count
// (`f32_decode_splits`).
//
// What bounds it: at absorbed MLA, operations (128 x 1,088 multiply-adds a
// key, at 2 + 1 TF32 products each with an f32 q over a bf16 cache). At d,
// dv <= 256 the same mixed calls go to decode_attention.cu's ring kernel
// (bytes-bound), and calls whose K and V differ, or whose head dims pass
// 576/512, to stream_decode.cu's. There is no fallback: a call that cannot
// build or launch raises.

#include "f32tc_attention.cuh"

// Plain C entry for ctypes: launches on `stream` (a cudaStream_t) on the
// calling thread's current device, does not synchronise, and returns the
// first launch's cudaError_t (0 on success).
extern "C" {

// The arguments of decode_attention_f32tc (decode_attention.cu): q [b h,
// ql, d], k [b h, cap, d], v [b h, cap, dv], d and dv multiples of 16 up to
// 576 and 512 with one of them over 256, every query row in one call; f32
// partials in part_o [b h, splits, ql, dv] and part_ml [b h, splits, ql,
// 2]; split s takes keys [s split_keys, (s + 1) split_keys), split_keys a
// multiple of 64. Then q_type and kv_type, 0 (f32), 1 (bf16) or 2 (f16),
// which differ; out has q's dtype.
int mixed_decode_f32tc(const void* q, const void* k, const void* v,
                       const void* lens, void* out, void* part_o,
                       void* part_ml, int b, int h, int ql, int cap, int d,
                       int dv, float scale, int splits, int split_keys,
                       int q_type, int kv_type, void* stream) {
  return f32tc::with_mixed_class(
      q_type, kv_type, [&](auto q16, auto kv16, int q_f16, int kv_f16) {
        return f32tc::launch_decode<decltype(q16)::value,
                                    decltype(kv16)::value>(
            q, k, v, lens, out, part_o, part_ml, b, h, ql, cap, d, dv, scale,
            splits, split_keys, q_f16, kv_f16,
            static_cast<cudaStream_t>(stream));
      });
}

const char* mixed_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
