// Entry points of the attention forward kernel (attention_fwd.cuh), bf16,
// for Hopper (sm_90a); loaded with ctypes by ops/attention.py.

#include "attention_fwd.cuh"

extern "C" {

// qkv: (B, L, 3*H*D) bf16, contiguous, 16-byte aligned; bias: (B, L) f32
// or NULL; out: (B, L, H*D) bf16. Dropout: keep a probability when its
// hash bits are >= thr (thr = 0: eval mode, no dropout), scale kept ones
// by inv_keep. Returns a cudaError_t code (0 = launched).
int mha_qkv_fwd_bf16(const void* qkv, const void* bias, void* out, int B,
                     int L, int H, int D, float scale, unsigned seed,
                     unsigned thr, float inv_keep, void* stream) {
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const int E = H * D;
  return attn_fwd::dispatch(q, q + E, q + 2 * E, 3 * E, bias, out, B, L, H,
                            D, scale, seed, thr, inv_keep, stream);
}

// q, k, v: (B, L, H*D) bf16 each, contiguous, 16-byte aligned; bias and
// out as above; the same numerics and dropout bits as mha_qkv_fwd_bf16.
int mha_fwd_bf16(const void* q, const void* k, const void* v,
                 const void* bias, void* out, int B, int L, int H, int D,
                 float scale, unsigned seed, unsigned thr, float inv_keep,
                 void* stream) {
  return attn_fwd::dispatch(static_cast<const __nv_bfloat16*>(q),
                            static_cast<const __nv_bfloat16*>(k),
                            static_cast<const __nv_bfloat16*>(v), H * D, bias,
                            out, B, L, H, D, scale, seed, thr, inv_keep,
                            stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
