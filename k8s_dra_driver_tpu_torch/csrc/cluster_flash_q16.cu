// Flash attention on the tensor cores at any head dims and dtype mix
// (cluster_flash.cuh: what it replaces, what bounds it, its design): the
// kernels for a bf16 or f16 q, 8 of the 16 (two V buckets times K's and V's
// dtype classes), in a source of their own so that nvcc builds them in a job
// of their own.

#include "cluster_flash.cuh"

// Plain C entry for ctypes: launches on `stream` (a cudaStream_t) on the
// calling thread's current device, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" {

// q (bf16 for q_type 1, f16 for 2), k [bh, S, d] and v [bh, S, dv], d and
// dv multiples of 16, into out [bh, S, dv] in q's dtype; k_type and v_type
// are 0 (f32), 1 (bf16) or 2 (f16). cluster, groups and vp as for
// cluster_flash_q32_run. `scale` multiplies q.k.
int cluster_flash_q16_run(const void* q, const void* k, const void* v,
                          void* out, int bh, int S, int d, int dv,
                          int causal, float scale, int q_type, int k_type,
                          int v_type, int cluster, int groups, int vp,
                          void* stream) {
  if (q_type != 1 && q_type != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return cflash::launch<true>(q, k, v, out, bh, S, d, dv, causal, scale,
                              q_type == 2, k_type, v_type, cluster, groups,
                              vp, static_cast<cudaStream_t>(stream));
}

const char* cluster_flash_q16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
