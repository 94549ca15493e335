// Flash attention on the tensor cores at any head dims and dtype mix
// (cluster_flash.cuh: what it replaces, what bounds it, its design): the
// kernels for an f32 q, 8 of the 16 (two V buckets times K's and V's dtype
// classes), in a source of their own so that nvcc builds them in a job of
// their own.

#include "cluster_flash.cuh"

// Plain C entry for ctypes: launches on `stream` (a cudaStream_t) on the
// calling thread's current device, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" {

// q (f32), k [bh, S, d] and v [bh, S, dv], d and dv multiples of 16, into
// out [bh, S, dv] in f32; k_type and v_type are 0 (f32), 1 (bf16) or 2
// (f16). cluster: CTAs a cluster (1-8); groups: 4-panel groups of d a CTA
// (cluster x groups x 128 >= d); vp: 32-column V panels a CTA (4 with one
// CTA, else 8). `scale` multiplies q.k.
int cluster_flash_q32_run(const void* q, const void* k, const void* v,
                          void* out, int bh, int S, int d, int dv,
                          int causal, float scale, int k_type, int v_type,
                          int cluster, int groups, int vp, void* stream) {
  return cflash::launch<false>(q, k, v, out, bh, S, d, dv, causal, scale, 0,
                               k_type, v_type, cluster, groups, vp,
                               static_cast<cudaStream_t>(stream));
}

const char* cluster_flash_q32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
