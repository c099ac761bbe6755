// The fused attention block, y = out(MHA(qkv(x))), and its backward, bf16,
// for Hopper (sm_90a). Plain C entry points, loaded with ctypes by
// ops/attention_block.py:
//   attn_block_fwd  replaces the TPU kernel
//     multimodal_plankton_recognition_tpu/ops/pallas/experimental/
//     attention_block.py::_fwd_kernel (kernel 11, reached through
//     attn_block / _attn_block_fwd);
//   attn_block_bwd  replaces ::_bwd_kernel (kernel 12, _attn_block_bwd).
//
// Numerics, kept from the TPU kernels (attention_block.py:55-185):
//   q|k|v = bf16(x . Wqkv^T + bqkv)   bf16 operands, f32 accumulation, the
//                                     f32 bias added before one rounding
//   o     = MHA(q, k, v)              the device code of kernel 1
//                                     (attention_fwd.cuh): f32 softmax,
//                                     hashed dropout (dropout.cuh), bf16 o
//   y     = bf16(o . Wo^T + bo)       f32 accumulation, one rounding
// backward, dy in bf16:
//   do    = bf16(dy . Wo)
//   dqkv  = the device code of kernel 2 (attention_bwd.cuh) on (qkv, do):
//           two launches, with row statistics and keep bits in scratch
//   dWo   = dy^T . o,   dbo = sum dy               f32
//   dWqkv = dqkv^T . x, dbqkv = sum dqkv           f32
//   dx    = bf16(dqkv . Wqkv)                      f32, one rounding
// Weights are in nn.Linear's (out, in) layout: Wqkv (3A, E) holds the q, k
// and v row blocks, Wo (E, A), A = H D the attention's width and E the
// model's. Every weight is read in place: the products that run along a
// weight's rows (do, dx) take it N-major.
//
// Shapes: D any multiple of 8 up to 256, of 64 up to 512 or of 128 up to
// 1,024, and E any multiple of 8. One library per range of head dims ATTN_D_LO, +
// ATTN_D_STEP, ..., ATTN_D_HI (8-64 by 8 by default), as
// attention_{fwd,bwd}.cu: ops/build.py compiles this source once per range
// (its UNITS), in parallel. ops/attention_block.py pads other shapes on
// the weights: each head's rows of Wqkv and bqkv and columns of Wo to the
// next instantiated head dim with zeros (zero columns of q and k add
// nothing to q.k^T, zero columns of v give o zero columns, which meet
// zero weights), the softmax scale that of the true head dim; where E is
// not a multiple of 8, x, dy, Wqkv's columns, Wo's rows and bo too. So
// A = E where nothing is padded, and E <= A otherwise.
//
// The backward takes the q|k|v and o that the forward wrote (the autograd
// path keeps them); given none, it rebuilds both first, with the same
// launches as the forward, so both routes give the same bits. The TPU
// kernel always rebuilds them, because VMEM cannot hold them; device
// memory can.
//
// What bounds it on this card: bytes at the shipped widths. Every product
// has a short side: K (the row operand's columns: E, A or 3A) and N (C's
// columns, up to 3A) are small beside the rows (B L, up to 57,600). A
// row of q|k|v at E 192 costs 2 K N = 221,184 flops for (K + N) 2 = 1,536
// bytes, 144 flops a byte, where the H100 needs 295 (989 TFLOP/s over
// 3.35 TB/s) before the tensor cores bind; dx at E 384 comes closest, at
// 288, and from E 512 on dx (384 a byte) and then every product pass it,
// so wide blocks are bound by the tensor rate. So each product
// must stream its rows once at the memory's rate; the attention stage
// between them runs kernels 1-2's tensor-core code (mma.sync,
// attention_fwd.cuh and attention_bwd.cuh) unchanged.
//
// Design: the five products run on the shared Hopper GEMM of
// hopper_gemm.cuh: q|k|v, y, do and dx on gemm_rows_kernel (a persistent
// block keeps a weight slice resident in shared memory and streams
// 128-row tiles of A through a TMA ring into wgmma; the weight K-major for
// q|k|v and y, N-major, read in place along its rows, for do and dx), the
// weight and bias gradients on wgrad_kernel (per-group f32 partials of
// G^T X, added in index order by reduce_kernel: no float atomics, so a
// run repeats bit for bit). Where a weight slice of 64 columns by K
// would not leave 4 ring stages (K above 1,152: dx from 3A = 1,536 at
// A 512), gemm streams the weight's boxes through the ring beside A's
// (hg::gemm_route): the same f32 sum over the whole K and one rounding.
//
// Each kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the entry points return a cudaError_t code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"
#include "hopper_gemm.cuh"

#ifndef ATTN_D_LO
#define ATTN_D_LO 8
#define ATTN_D_HI 64
#endif
#ifndef ATTN_D_STEP
#define ATTN_D_STEP 8
#endif

namespace {

using namespace hg;

#define CHECK(call)                        \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// q|k|v = x . Wqkv^T + bqkv, then o = MHA(q|k|v): the forward's first
// two steps, which the backward repeats when it is given neither
int qkv_and_o(const void* x, const void* wqkv, const void* bqkv,
              const void* bias, void* qkv, void* o, int B, int L, int E,
              int H, int D, float scale, unsigned seed, unsigned thr,
              float inv_keep, void* stream) {
  const int A = H * D;
  const bf16* q = static_cast<const bf16*>(qkv);
  CHECK(gemm(x, wqkv, 0, bqkv, qkv, B * L, 3 * A, E,
             static_cast<cudaStream_t>(stream)));
  CHECK((cudaError_t)(
      attn_fwd::dispatch<ATTN_D_LO, ATTN_D_HI, ATTN_D_STEP>(
          q, q + A, q + 2 * A, 3 * A, bias, o, B, L, H, D, scale, seed, thr,
          inv_keep, stream)));
  return 0;
}

// the shapes every entry point takes: E a multiple of 8 (TMA's rows), D
// one of this library's head dims (the dispatch refuses the others)
bool shapes_ok(int B, int L, int E, int H, int D) {
  return B > 0 && L > 0 && H > 0 && E > 0 && E % 8 == 0 && D >= ATTN_D_LO &&
         D <= ATTN_D_HI && (D - ATTN_D_LO) % ATTN_D_STEP == 0;
}

}  // namespace

extern "C" {

// x, y: (B, L, E) bf16; wqkv (3A, E) and wo (E, A) bf16, A = H D; bqkv
// (3A,) and bo (E,) f32; bias: (B, L) f32 or NULL; qkv: (B, L, 3A) and o
// (B, L, A) bf16, written for the caller (the autograd path keeps them
// for the backward). All contiguous and 16-byte aligned. scale: the
// softmax's (1 / sqrt of the true head dim where D is padded). Dropout:
// keep a probability when its hash bits are >= thr (thr = 0: eval mode),
// scale kept ones by inv_keep. Returns a cudaError_t code (0 = launched).
int attn_block_fwd(const void* x, const void* wqkv, const void* bqkv,
                   const void* wo, const void* bo, const void* bias,
                   void* qkv, void* o, void* y, int B, int L, int E, int H,
                   int D, float scale, unsigned seed, unsigned thr,
                   float inv_keep, void* stream) {
  if (!shapes_ok(B, L, E, H, D)) return (int)cudaErrorInvalidValue;
  const int err = qkv_and_o(x, wqkv, bqkv, bias, qkv, o, B, L, E, H, D,
                            scale, seed, thr, inv_keep, stream);
  if (err) return err;
  CHECK(gemm(o, wo, 0, bo, y, B * L, E, H * D,
             static_cast<cudaStream_t>(stream)));
  return 0;
}

// The forward's operands, plus: dy (B, L, E) bf16; qkv (B, L, 3A) and o
// (B, L, A) bf16, the forward's, or, with `recompute`, buffers this call
// fills first; scratch dqkv (B, L, 3A) and do (B, L, A) bf16; dx (B, L, E)
// bf16; dwqkv (3A, E), dbqkv (3A,), dwo (E, A), dbo (E,) f32; part:
// g_qkv * (3A E + 3A) + g_out * (E A + E) f32, 1 <= groups <=
// ceil(B L / 64); scratch: the attention backward's (attn_bwd::dispatch,
// sized by ops/attention.py bwd_scratch).
int attn_block_bwd(const void* x, const void* wqkv, const void* bqkv,
                   const void* wo, const void* bias, const void* dy,
                   void* qkv, void* o, int recompute, void* dout, void* dqkv,
                   void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
                   void* part, void* scratch, int g_qkv, int g_out, int B,
                   int L, int E, int H, int D, float scale, unsigned seed,
                   unsigned thr, float inv_keep, void* stream) {
  const int A = H * D, M = B * L, chunks = (M + 63) / 64;
  if (!shapes_ok(B, L, E, H, D) || g_qkv < 1 || g_out < 1 ||
      g_qkv > chunks || g_out > chunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (recompute) {
    const int err = qkv_and_o(x, wqkv, bqkv, bias, qkv, o, B, L, E, H, D,
                              scale, seed, thr, inv_keep, stream);
    if (err) return err;
  }
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* part_qkv = static_cast<float*>(part);
  float* part_out = part_qkv + (size_t)g_qkv * (3 * (size_t)A * E + 3 * A);
  CHECK(gemm(dy, wo, 1, nullptr, dout, M, A, E, s));
  CHECK((cudaError_t)(
      attn_bwd::dispatch<ATTN_D_LO, ATTN_D_HI, ATTN_D_STEP>(
          q, q + A, q + 2 * A, 3 * A, bias, dout, dq, dq + A, dq + 2 * A,
          scratch, B, L, H, D, scale, seed, thr, inv_keep, stream)));
  CHECK(gemm(dqkv, wqkv, 1, nullptr, dx, M, E, 3 * A, s));
  CHECK(wgrad(dqkv, x, part_qkv, g_qkv, dwqkv, dbqkv, M, 3 * A, E, s));
  CHECK(wgrad(dy, o, part_out, g_out, dwo, dbo, M, E, A, s));
  return 0;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
