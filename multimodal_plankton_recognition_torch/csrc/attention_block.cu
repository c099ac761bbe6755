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
//   dWo   = dy^T . o,   dbo = sum dy               f32, o recomputed
//   dWqkv = dqkv^T . x, dbqkv = sum dqkv           f32
//   dx    = bf16(dqkv . Wqkv)                      f32, one rounding
// Weights are in nn.Linear's (out, in) layout: Wqkv (3E, E) holds the q, k
// and v row blocks, Wo (E, E). The products that read a weight along its
// rows (do and dx) take it transposed from the wrapper.
//
// What bounds it: products. Per ViT-T layer at B = 256 (rows 50,432, E 192,
// L 197, 3 heads of 64) the forward's projections are 14.9 GFLOP and its
// attention 7.6; the backward needs twice both. The projections and the
// weight gradients run on the tensor cores (warp-level bf16 WMMA 16x16x16,
// f32 accumulators); the attention runs kernels 1-2's tensor-core code
// (mma.sync, attention_fwd.cuh and attention_bwd.cuh).
//
// Design. The TPU kernel keeps q, k, v and o of a block of samples in VMEM
// and runs every product in one pass. Here each step is its own launch on
// the caller's stream, with q|k|v, o, do and dqkv in bf16 scratch tensors
// the wrapper allocates:
//   gemm_nt_kernel: C = A . B^T (+ f32 bias), A (M, K) and B (N, K) bf16,
//     one bf16 rounding; a block of 8 warps owns a 128 x 64 tile of C and
//     walks K in 32-wide steps staged in shared memory, each warp a 32 x 32
//     sub-tile (2 x 2 fragments);
//   wgrad_kernel: the weight gradients are sums over every row, which the
//     TPU kernel accumulates in output blocks that persist over its
//     sequential grid. Here a block owns a 64 x 64 tile of the (N, K)
//     gradient and one group of 32-row chunks, and writes that group's
//     partial (and the bias column sums from its k-tile 0 blocks);
//     reduce_kernel adds the groups in index order. No float atomics, so
//     a run repeats bit for bit.
//
// Each kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
// gemm_nt_kernel: a 128 x 64 tile of C, K in steps of 32
constexpr int GM = 128, GN = 64, GK = 32;
constexpr int LDK = GK + 8;  // bf16 row of a staged step (80 bytes)
// wgrad_kernel: a 64 x 64 tile of the gradient, rows in chunks of 32
constexpr int WT = 64, WR = 32;
constexpr int LDW = WT + 8;  // bf16 row of a staged chunk (144 bytes)

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BCol;

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// n rows of 8 * v bf16 from src (row stride ld, rows >= valid are zero)
// into dst (row stride ldd)
__device__ __forceinline__ void stage_rows(bf16* dst, int ldd,
                                           const bf16* src, size_t ld,
                                           int row0, int valid, int n,
                                           int v) {
  for (int i = threadIdx.x; i < n * v; i += kThreads) {
    const int r = i / v, c = i - r * v;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      w = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld +
                                          c * 8);
    *reinterpret_cast<uint4*>(dst + r * ldd + c * 8) = w;
  }
}

// C (M, N) = A (M, K) . B^T with B (N, K), plus bias (N,) f32 when given,
// rounded once to bf16. N a multiple of 64, K of 32.
__global__ void __launch_bounds__(kThreads)
gemm_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
               const float* __restrict__ bias, bf16* __restrict__ C, int M,
               int N, int K) {
  __shared__ __align__(128) bf16 As[GM * LDK];
  __shared__ __align__(128) bf16 Bs[GN * LDK];
  __shared__ __align__(128) float stage[kWarps * 256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;

  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GK) {
    __syncthreads();  // the previous step is done with As and Bs
    stage_rows(As, LDK, A + k0, K, m0, M, GM, GK / 8);
    stage_rows(Bs, LDK, B + (size_t)n0 * K + k0, K, 0, GN, GN, GK / 8);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      ARow a[2];
      BCol b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDK + kk, LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn + j * 16) * LDK + kk, LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // each fragment through the warp's 16 x 16 f32 staging tile: lane owns 8
  // consecutive columns of one row
  float* st = stage + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm + i * 16 + r;
      const int col = n0 + wn + j * 16 + c0;
      if (row < M) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v[q] = st[r * 16 + c0 + q] + (bias ? bias[col + q] : 0.f);
        *reinterpret_cast<uint4*>(C + (size_t)row * N + col) = make_uint4(
            pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
            pack2(v[6], v[7]));
      }
      __syncwarp();
    }
  }
}

// One group's partial of dW (N, K) = G^T . X over its 32-row chunks, G
// (rows, N) and X (rows, K) bf16, at part + group * (N K + N); the k-tile 0
// blocks also write the column sums of G (the bias gradient) after it. N
// and K multiples of 64.
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const bf16* __restrict__ G, const bf16* __restrict__ X,
             float* __restrict__ part, int rows, int N, int K) {
  __shared__ __align__(128) bf16 Gs[WR * LDW];
  __shared__ __align__(128) bf16 Xs[WR * LDW];
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * WT, k0 = blockIdx.y * WT;
  const int chunks = (rows + WR - 1) / WR;
  const int c0 = (int)((long long)blockIdx.z * chunks / gridDim.z);
  const int c1 = (int)((long long)(blockIdx.z + 1) * chunks / gridDim.z);
  const int wn = (warp & 3) * 16, wk = (warp >> 2) * 32;
  const bool sums = blockIdx.y == 0 && threadIdx.x < WT;

  Acc acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  float bsum = 0.f;
  for (int c = c0; c < c1; ++c) {
    __syncthreads();  // the previous chunk is done with Gs and Xs
    stage_rows(Gs, LDW, G + n0, N, c * WR, rows, WR, WT / 8);
    stage_rows(Xs, LDW, X + k0, K, c * WR, rows, WR, WT / 8);
    __syncthreads();
    if (sums)  // in row order; rows past the end are zero
      for (int r = 0; r < WR; ++r)
        bsum += __bfloat162float(Gs[r * LDW + threadIdx.x]);
#pragma unroll
    for (int kk = 0; kk < WR; kk += 16) {
      ACol a;  // G^T: (n, row) at Gs[row * LDW + n]
      wmma::load_matrix_sync(a, Gs + kk * LDW + wn, LDW);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        BRow b;
        wmma::load_matrix_sync(b, Xs + kk * LDW + wk + j * 16, LDW);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  float* out = part + (size_t)blockIdx.z * ((size_t)N * K + N);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(out + (size_t)(n0 + wn) * K + k0 + wk + j * 16,
                            acc[j], K, wmma::mem_row_major);
  if (sums) out[(size_t)N * K + n0 + threadIdx.x] = bsum;
}

// dw[i] (i < N K) and db[i - N K] = the sum over groups g, in order, of
// part[g * (N K + N) + i]
__global__ void reduce_kernel(const float* __restrict__ part, int groups,
                              size_t nk, int N, float* __restrict__ dw,
                              float* __restrict__ db) {
  const size_t n = nk + N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += part[(size_t)g * n + i];
    if (i < nk)
      dw[i] = acc;
    else
      db[i - nk] = acc;
  }
}

cudaError_t gemm(const void* a, const void* b, const void* bias, void* c,
                 int M, int N, int K, cudaStream_t s) {
  const dim3 grid(N / GN, (M + GM - 1) / GM);
  gemm_nt_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const float*>(bias), static_cast<bf16*>(c), M, N, K);
  return cudaGetLastError();
}

// weight and bias gradient of an (N, K) weight into dw, db
cudaError_t wgrad(const void* g, const void* x, float* part, int groups,
                  void* dw, void* db, int rows, int N, int K,
                  cudaStream_t s) {
  wgrad_kernel<<<dim3(N / WT, K / WT, groups), kThreads, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(x), part, rows,
      N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t nk = (size_t)N * K;
  reduce_kernel<<<(int)((nk + N + 255) / 256), 256, 0, s>>>(
      part, groups, nk, N, static_cast<float*>(dw), static_cast<float*>(db));
  return cudaGetLastError();
}

// the (E, heads) of the paths: ViT-T, the flagship's profile encoder,
// ViT-S, the SigLIP card's profile encoder (ops/attention_block.py
// SUPPORTED_BLOCKS)
bool supported(int H, int D) {
  const int E = H * D;
  return (E == 192 && (H == 3 || H == 8)) || (E == 384 && H == 6) ||
         (E == 128 && H == 4);
}

#define CHECK(call)                        \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

}  // namespace

extern "C" {

// x, y, o: (B, L, E) bf16; wqkv (3E, E) and wo (E, E) bf16; bqkv (3E,) and
// bo (E,) f32; bias: (B, L) f32 or NULL; qkv: (B, L, 3E) bf16 scratch. All
// contiguous and 16-byte aligned. Dropout: keep a probability when its
// hash bits are >= thr (thr = 0: eval mode), scale kept ones by inv_keep.
// Returns a cudaError_t code (0 = launched).
int attn_block_fwd(const void* x, const void* wqkv, const void* bqkv,
                   const void* wo, const void* bo, const void* bias,
                   void* qkv, void* o, void* y, int B, int L, int H, int D,
                   float scale, unsigned seed, unsigned thr, float inv_keep,
                   void* stream) {
  if (!supported(H, D) || B <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = H * D, M = B * L;
  const bf16* q = static_cast<const bf16*>(qkv);
  CHECK(gemm(x, wqkv, bqkv, qkv, M, 3 * E, E, s));
  CHECK((cudaError_t)attn_fwd::dispatch(q, q + E, q + 2 * E, 3 * E, bias, o,
                                        B, L, H, D, scale, seed, thr,
                                        inv_keep, stream));
  CHECK(gemm(o, wo, bo, y, M, E, E, s));
  return 0;
}

// The forward's operands, plus: wqkv_t (E, 3E) and wo_t (E, E) the
// transposed weights; dy (B, L, E) bf16; scratch qkv and dqkv (B, L, 3E),
// do and o (B, L, E) bf16; dx (B, L, E) bf16; dwqkv (3E, E), dbqkv (3E,),
// dwo (E, E), dbo (E,) f32; part: g_qkv * (3E E + 3E) + g_out * (E E + E)
// f32, 1 <= groups <= ceil(B L / 32); scratch: the attention backward's
// (attn_bwd::dispatch, sized by ops/attention.py bwd_scratch).
int attn_block_bwd(const void* x, const void* wqkv, const void* bqkv,
                   const void* wqkv_t, const void* wo_t, const void* bias,
                   const void* dy, void* qkv, void* dout, void* o,
                   void* dqkv, void* dx, void* dwqkv, void* dbqkv, void* dwo,
                   void* dbo, void* part, void* scratch, int g_qkv, int g_out,
                   int B, int L, int H, int D, float scale, unsigned seed,
                   unsigned thr, float inv_keep, void* stream) {
  const int E = H * D, M = B * L, chunks = (M + WR - 1) / WR;
  if (!supported(H, D) || B <= 0 || L <= 0 || g_qkv < 1 || g_out < 1 ||
      g_qkv > chunks || g_out > chunks)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* part_qkv = static_cast<float*>(part);
  float* part_out = part_qkv + (size_t)g_qkv * (3 * (size_t)E * E + 3 * E);
  CHECK(gemm(x, wqkv, bqkv, qkv, M, 3 * E, E, s));
  CHECK(gemm(dy, wo_t, nullptr, dout, M, E, E, s));
  CHECK((cudaError_t)attn_fwd::dispatch(q, q + E, q + 2 * E, 3 * E, bias, o,
                                        B, L, H, D, scale, seed, thr,
                                        inv_keep, stream));
  CHECK((cudaError_t)attn_bwd::dispatch(q, q + E, q + 2 * E, 3 * E, bias,
                                        dout, dq, dq + E, dq + 2 * E, scratch,
                                        B, L, H, D, scale, seed, thr,
                                        inv_keep, stream));
  CHECK(gemm(dqkv, wqkv_t, nullptr, dx, M, E, 3 * E, s));
  CHECK(wgrad(dqkv, x, part_qkv, g_qkv, dwqkv, dbqkv, M, 3 * E, E, s));
  CHECK(wgrad(dy, o, part_out, g_out, dwo, dbo, M, E, E, s));
  return 0;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
