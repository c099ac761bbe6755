// Entry points of the attention backward kernel (attention_bwd.cuh), bf16,
// for Hopper (sm_90a); loaded with ctypes by ops/attention.py.
//
// One library per range of head dims ATTN_D_LO, + ATTN_D_STEP, ...,
// ATTN_D_HI (multiples of 8; 8-64 by 8 by default), as attention_fwd.cu:
// ops/build.py's UNITS compile this source once per range, in parallel. A
// head dim outside the library's range returns cudaErrorInvalidValue.

#include "attention_bwd.cuh"

#ifndef ATTN_D_LO
#define ATTN_D_LO 8
#define ATTN_D_HI 64
#endif
#ifndef ATTN_D_STEP
#define ATTN_D_STEP 8
#endif

using attn_bwd::bf16p;
using attn_bwd::cbf16p;

extern "C" {

// qkv: (B, L, 3*H*D) bf16; bias: (B, L) f32 or NULL; dout: (B, L, H*D)
// bf16; dqkv: (B, L, 3*H*D) bf16, every element written; scratch: as
// attn_bwd::dispatch describes it. All contiguous and 16-byte aligned.
// Dropout as in mha_qkv_fwd_bf16 (thr = 0: none). Runs two kernels
// (attention_bwd.cuh). Returns a cudaError_t code (0 = launched).
int mha_qkv_bwd_bf16(const void* qkv, const void* bias, const void* dout,
                     void* dqkv, void* scratch, int B, int L, int H, int D,
                     float scale, unsigned seed, unsigned thr,
                     float inv_keep, void* stream) {
  cbf16p in = static_cast<cbf16p>(qkv);
  bf16p out = static_cast<bf16p>(dqkv);
  const int E = H * D;
  return attn_bwd::dispatch<ATTN_D_LO, ATTN_D_HI, ATTN_D_STEP>(
      in, in + E, in + 2 * E, 3 * E, bias, dout, out, out + E, out + 2 * E,
      scratch, B, L, H, D, scale, seed, thr, inv_keep, stream);
}

// q, k, v, dout: (B, L, H*D) bf16 each; dq, dk, dv: (B, L, H*D) bf16, every
// element written; scratch as above. All contiguous and 16-byte aligned. The
// same numerics and dropout bits as mha_qkv_bwd_bf16.
int mha_bwd_bf16(const void* q, const void* k, const void* v,
                 const void* bias, const void* dout, void* dq, void* dk,
                 void* dv, void* scratch, int B, int L, int H, int D,
                 float scale, unsigned seed, unsigned thr, float inv_keep,
                 void* stream) {
  return attn_bwd::dispatch<ATTN_D_LO, ATTN_D_HI, ATTN_D_STEP>(
      static_cast<cbf16p>(q), static_cast<cbf16p>(k),
      static_cast<cbf16p>(v), H * D, bias, dout, static_cast<bf16p>(dq),
      static_cast<bf16p>(dk), static_cast<bf16p>(dv), scratch, B, L, H, D,
      scale, seed, thr, inv_keep, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
