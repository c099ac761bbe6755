// The shared Hopper GEMM of hopper_gemm.cuh behind plain C entry points,
// loaded with ctypes by ops/hopper_gemm.py, so that the card tests can
// hold it against torch.matmul at any width the kernels take. The main
// paths reach the same code inside kernels 10, 11-12, 13 and 16
// (csrc/ffn.cu, csrc/attention_block.cu, csrc/mbconv_fwd.cu,
// csrc/mbconv_bwd.cu).

#include "hopper_gemm.cuh"

extern "C" {

// c (M, N) bf16 = a (M, K) bf16 . w + bias: w (N, K) with tb = 0, (K, N)
// with tb = 1, bf16; bias (N,) f32 or NULL. Returns a cudaError_t code.
int hopper_gemm_rows(const void* a, const void* w, int tb, const void* bias,
                     void* c, int M, int N, int K, void* stream) {
  return (int)hg::gemm(a, w, tb, bias, c, M, N, K,
                       static_cast<cudaStream_t>(stream));
}

// the route hg::gemm takes for an (N, K) weight: BN > 0 with the weight
// slice resident, -BN with it streamed beside A, 0 refused (gemm_route)
int hopper_gemm_route(int N, int K) { return hg::gemm_route(N, K); }

// c (M, N) bf16 = a (M, K) . w for w (K, N) bf16, and part (2, 2
// ceil(M / 128), N) f32: each 64-row chunk's column sums of c and c^2
// (kernel 13's expand). Returns a cudaError_t code.
int hopper_gemm_sums(const void* a, const void* w, void* c, void* part,
                     int M, int N, int K, void* stream) {
  return (int)hg::gemm_sums(a, w, c, static_cast<float*>(part), M, N, K,
                            static_cast<cudaStream_t>(stream));
}

// dw (N, K) = g^T x and, when db is given, db (N,) = the column sums of g,
// f32; g (rows, N) and x (rows, K) bf16; part: groups * (N K + N) f32.
int hopper_wgrad(const void* g, const void* x, void* part, int groups,
                 void* dw, void* db, int rows, int N, int K, void* stream) {
  return (int)hg::wgrad(g, x, static_cast<float*>(part), groups, dw, db, rows,
                        N, K, static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
