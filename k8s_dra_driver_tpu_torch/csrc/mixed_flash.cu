// Flash attention for NVIDIA Hopper (sm_90a) whose q is in one dtype and
// whose K and V share another: an f32 q against bf16 or f16 K and V, a
// bf16 or f16 q against f32 K and V, or a bf16 q against f16 K and V (and
// the reverse). The kernels are the f32 tensor-core body's
// (f32tc_attention.cuh), built here, apart from the all-f32 ones of
// flash_attention.cu, so that nvcc compiles them in a job of their own.
//
// Replaces, for such inputs, the TPU kernel `_flash_kernel`, reached
// through `flash_attention` (k8s_dra_driver_tpu/compute/flashattention.py),
// and computes its function: scores q.k of the upcast values accumulated in
// f32 and scaled by 1/sqrt(d) of the true d; the causal mask; an online
// softmax in f32; p rounded to V's dtype before P V (f32 V: not rounded),
// which accumulates in f32; the output in q's dtype. Every operand is read
// in its own dtype (no cast or copy of K or V by the wrapper), and an f32
// operand keeps f32 accuracy in its products: its hi and lo parts both
// enter (3xTF32), while a 16-bit operand is exact in TF32 and enters once.
//
// What bounds it: operations, at the TF32 rate times the products a
// multiply-add takes (S: 1 + [q is f32] + [k is f32]; P V: 3 with f32 V, 1
// with 16-bit V). At [4, 8, 2048, 128] with an f32 q and bf16 K and V that
// is 2 + 1 products, half the all-f32 route's 6. The design is the f32
// body's (its note), with 16-bit panels copied by TMA in their own dtype
// and the lo products of 16-bit operands never issued.
//
// It replaces the general SIMT kernel of flash_attention.cu for these
// calls (5.95 ms for an f32 q at that shape on an H100 in PR 20's call,
// PERF.md); K and V in different dtypes and head dims past 576/512 go to
// cluster_flash.cuh's kernels. There is no fallback: a call that cannot
// build or launch raises.

#include "f32tc_attention.cuh"

// Plain C entry for ctypes: launches on `stream` (a cudaStream_t) on the
// calling thread's current device, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" {

// q, k [bh, S, d] and v [bh, S, dv] with d and dv multiples of 16 up to 576
// and 512 into out [bh, S, dv] in q's dtype; q_type and kv_type are 0
// (f32), 1 (bf16) or 2 (f16) and differ. `scale` multiplies q.k.
int mixed_flash_f32tc(const void* q, const void* k, const void* v,
                      void* out, int bh, int S, int d, int dv, int causal,
                      float scale, int q_type, int kv_type, void* stream) {
  return f32tc::with_mixed_class(
      q_type, kv_type, [&](auto q16, auto kv16, int q_f16, int kv_f16) {
        return f32tc::launch_flash<decltype(q16)::value,
                                   decltype(kv16)::value>(
            q, k, v, out, bh, S, d, dv, causal, scale, q_f16, kv_f16,
            static_cast<cudaStream_t>(stream));
      });
}

const char* mixed_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
