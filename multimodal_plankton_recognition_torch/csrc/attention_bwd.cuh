// Multi-head self-attention backward, bf16 in and out, for Hopper (sm_90a):
// the device code and its launcher (attn_bwd::dispatch), shared by the
// entry points of attention_bwd.cu (ops/attention.py) and by
// attention_block.cu (ops/attention_block.py). attention_bwd.cu exports
//   mha_qkv_bwd_bf16  on one packed (B, L, 3E) q|k|v operand and its packed
//     dqkv, replacing the TPU kernel
//     multimodal_plankton_recognition_tpu/ops/pallas/attention.py
//     ::_bwd_kernel_stacked_qkv (mha_core_qkv / _mha_qkv_bwd);
//   mha_bwd_bf16      on separate (B, L, E) q, k, v and dq, dk, dv,
//     replacing ::_bwd_kernel and ::_bwd_kernel_stacked (mha_core /
//     _mha_bwd).
// One kernel serves both: operands and cotangents through three pointers
// each, with a row stride of 3E (packed) or E (separate). The bias
// cotangent is not computed: the module builds the bias from the padding
// mask and drops its gradient (models/attention.py:182-184 of the JAX
// package).
//
// Numerics, kept from the TPU kernel (per head h):
//   z  = q . k^T * (1/sqrt(D)) + bias[key]   bf16 operands, f32 accumulation
//   p  = softmax(z)                          recomputed in f32
//   dp = dO . v^T                            f32, then * keep / (1 - p_drop)
//   dz = p * (dp - sum_j dp * p)
//   ds = bf16(dz * (1/sqrt(D)))
//   pd = bf16(p * keep / (1 - p_drop))
//   dQ = ds . K,  dK = ds^T . Q,  dV = pd^T . dO   f32 accumulation, bf16 out
// The dropout mask is regenerated from the seed (dropout.cuh), identical to
// the forward kernel's.
//
// What bounds it: per ViT-T layer at B = 256 (L = 197, H = 3, D = 64) the
// five products of the backward are about 19 GFLOP; this design runs seven
// (the scores and dO . V^T are recomputed once per pass), about 27 GFLOP on
// the CUDA cores in f32 FMA, against about 120 MB of reads and writes. It is
// bound by those operations, like the forward kernel.
//
// Design: grid (H, B), one block of 8 warps per (sample, head). The block
// stages Q_h, K_h, V_h and dO_h in shared memory (rows padded to an odd
// number of 32-bit words so 32 lanes reading 32 rows hit 32 banks; 104 KB at
// ViT-T, 47 KB at the profile shape), then runs two passes that need no
// atomics:
//   A. warps take query rows r. Lanes stride over keys: scores, the row max
//      and sum, dp, and delta_r = sum_j dp * p (warp shuffles); then ds for
//      the row, and dQ_r = sum_j ds_j K_j with the lanes split over column
//      pairs (as P.V in the forward kernel). Row max, sum and delta go to
//      shared memory.
//   B. warps take keys j. Lanes stride over query rows: the same scores
//      (bit for bit: the same FMA sequence), p from the stored row max and
//      sum, dp, ds and pd; then dK_j = sum_r ds_r Q_r and
//      dV_j = sum_r pd_r dO_r with the lanes split over column pairs.
// No wgmma, TMA or cp.async yet.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the entry point returns cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"

namespace attn_bwd {

constexpr int kWarps = 8;

template <int D>
struct Geom {
  static_assert(D % 2 == 0 && D <= 64, "head dim must be even and <= 64");
  static constexpr int kPairs = D / 2;  // bf16x2 words per head row
  // odd word stride: lane j reads row j, so 32 lanes land on 32 banks
  static constexpr int kStride = (kPairs % 2 == 0) ? kPairs + 1 : kPairs;
  static constexpr int kGroups = 32 / kPairs;  // row groups in the sums
};

template <int D>
size_t smem_bytes(int L) {
  using G = Geom<D>;
  return sizeof(uint32_t) * (size_t)4 * L * G::kStride +  // Q, K, V, dO
         sizeof(float) * (size_t)3 * L +                  // max, sum, delta
         sizeof(float) * (size_t)2 * kWarps * L;          // two rows per warp
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one staged head row (kPairs words) into f32 registers
template <int D>
__device__ __forceinline__ void load_row(float (&x)[D], const uint32_t* row) {
#pragma unroll
  for (int w = 0; w < D / 2; ++w) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + w));
    x[2 * w] = f.x;
    x[2 * w + 1] = f.y;
  }
}

// x . row, x in registers, row staged; always x first in the FMA, so the
// two passes compute the same scores bit for bit
template <int D>
__device__ __forceinline__ float dot_row(const float (&x)[D],
                                         const uint32_t* row) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < D / 2; ++w) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + w));
    s = fmaf(f.x, x[2 * w], s);
    s = fmaf(f.y, x[2 * w + 1], s);
  }
  return s;
}

// sum over rows i of coef[i] * M[i, column pair c], split over lane groups
// and combined with shuffles; the result is valid in group 0 (lane < kPairs)
template <int D>
__device__ __forceinline__ float2 weighted_rows(const float* coef,
                                                const uint32_t* m, int L,
                                                int lane) {
  using G = Geom<D>;
  const int c = lane % G::kPairs;
  const int g = lane / G::kPairs;
  float2 acc = make_float2(0.f, 0.f);
  if (g < G::kGroups) {
    for (int i = g; i < L; i += G::kGroups) {
      const float w = coef[i];
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(m + i * G::kStride + c));
      acc.x = fmaf(w, f.x, acc.x);
      acc.y = fmaf(w, f.y, acc.y);
    }
  }
  // lane c of group 0 adds the partial sums of lanes c + s*kPairs, read
  // from the unmodified copy so that no partial is counted twice
  const float2 part = acc;
#pragma unroll
  for (int s = 1; s < G::kGroups; ++s) {
    acc.x += __shfl_sync(0xffffffffu, part.x, c + s * G::kPairs);
    acc.y += __shfl_sync(0xffffffffu, part.y, c + s * G::kPairs);
  }
  return acc;
}

// q, k, v (dq, dk, dv): head 0 of token 0 of sample 0 of each operand
// (cotangent); ld: elements between consecutive tokens of one of them (3E
// packed, E separate); dout has a row stride of E
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
mha_bwd_kernel(const __nv_bfloat16* __restrict__ q_in,
               const __nv_bfloat16* __restrict__ k_in,
               const __nv_bfloat16* __restrict__ v_in, int ld,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ dout,
               __nv_bfloat16* __restrict__ dq_out,
               __nv_bfloat16* __restrict__ dk_out,
               __nv_bfloat16* __restrict__ dv_out,
               int L, int E, float scale, uint32_t seed, uint32_t thr,
               float inv_keep) {
  using G = Geom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem_raw);  // L x kStride each
  uint32_t* ks = qs + (size_t)L * G::kStride;
  uint32_t* vs = ks + (size_t)L * G::kStride;
  uint32_t* dos = vs + (size_t)L * G::kStride;
  float* row_max = reinterpret_cast<float*>(dos + (size_t)L * G::kStride);
  float* row_sum = row_max + L;
  float* row_delta = row_sum + L;
  float* bufs = row_delta + L;  // kWarps x 2 x L

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row_words = (size_t)ld / 2;  // 32-bit words per token
  const size_t head = ((size_t)b * L * ld + (size_t)h * D) / 2;
  const uint32_t* qsrc = reinterpret_cast<const uint32_t*>(q_in) + head;
  const uint32_t* ksrc = reinterpret_cast<const uint32_t*>(k_in) + head;
  const uint32_t* vsrc = reinterpret_cast<const uint32_t*>(v_in) + head;
  const uint32_t* dsrc = reinterpret_cast<const uint32_t*>(dout) +
                         ((size_t)b * L * E + (size_t)h * D) / 2;

  for (int i = threadIdx.x; i < L * G::kPairs; i += blockDim.x) {
    const int j = i / G::kPairs;
    const int w = i - j * G::kPairs;
    const size_t at = (size_t)j * row_words + w;
    qs[j * G::kStride + w] = qsrc[at];
    ks[j * G::kStride + w] = ksrc[at];
    vs[j * G::kStride + w] = vsrc[at];
    dos[j * G::kStride + w] = dsrc[(size_t)j * E / 2 + w];
  }
  __syncthreads();

  const float* brow = bias ? bias + (size_t)b * L : nullptr;
  float* buf_a = bufs + (size_t)warp * 2 * L;
  float* buf_b = buf_a + L;
  const uint32_t key = dropout_key(seed, b * gridDim.x + h);
  float x[D];  // the register row of the current pass step

  // ---- pass A: query rows -> softmax statistics, delta, dQ ----
  for (int r = warp; r < L; r += kWarps) {
    load_row<D>(x, qs + r * G::kStride);
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      float z = dot_row<D>(x, ks + j * G::kStride) * scale;
      if (brow) z += brow[j];
      buf_a[j] = z;
      mx = fmaxf(mx, z);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(buf_a[j] - mx);
      buf_a[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    load_row<D>(x, dos + r * G::kStride);
    float delta = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = buf_a[j] / sum;
      float dp = dot_row<D>(x, vs + j * G::kStride);
      if (thr) dp = dropout_bits(key, r * L + j) >= thr ? dp * inv_keep : 0.f;
      buf_a[j] = p;
      buf_b[j] = dp;
      delta = fmaf(dp, p, delta);
    }
    delta = warp_sum(delta);
    for (int j = lane; j < L; j += 32)
      buf_a[j] = round_bf16(buf_a[j] * (buf_b[j] - delta) * scale);
    __syncwarp();
    const float2 dq = weighted_rows<D>(buf_a, ks, L, lane);
    if (lane < G::kPairs) {
      reinterpret_cast<__nv_bfloat162*>(
          dq_out + ((size_t)b * L + r) * ld + h * D)[lane] =
          __floats2bfloat162_rn(dq.x, dq.y);
    }
    if (lane == 0) {
      row_max[r] = mx;
      row_sum[r] = sum;
      row_delta[r] = delta;
    }
    __syncwarp();  // the next row overwrites the buffers
  }
  __syncthreads();

  // ---- pass B: keys -> dK, dV ----
  for (int j = warp; j < L; j += kWarps) {
    load_row<D>(x, vs + j * G::kStride);
    for (int r = lane; r < L; r += 32)
      buf_b[r] = dot_row<D>(x, dos + r * G::kStride);  // dO_r . v_j
    load_row<D>(x, ks + j * G::kStride);
    const float bj = brow ? brow[j] : 0.f;
    for (int r = lane; r < L; r += 32) {
      float z = dot_row<D>(x, qs + r * G::kStride) * scale;
      if (brow) z += bj;
      const float p = expf(z - row_max[r]) / row_sum[r];
      float dp = buf_b[r];
      float pd = p;
      if (thr) {
        const bool keep = dropout_bits(key, r * L + j) >= thr;
        dp = keep ? dp * inv_keep : 0.f;
        pd = keep ? p * inv_keep : 0.f;
      }
      buf_a[r] = round_bf16(p * (dp - row_delta[r]) * scale);
      buf_b[r] = round_bf16(pd);
    }
    __syncwarp();
    const float2 dk = weighted_rows<D>(buf_a, qs, L, lane);
    const float2 dv = weighted_rows<D>(buf_b, dos, L, lane);
    if (lane < G::kPairs) {
      const size_t at = ((size_t)b * L + j) * ld + h * D;
      reinterpret_cast<__nv_bfloat162*>(dk_out + at)[lane] =
          __floats2bfloat162_rn(dk.x, dk.y);
      reinterpret_cast<__nv_bfloat162*>(dv_out + at)[lane] =
          __floats2bfloat162_rn(dv.x, dv.y);
    }
    __syncwarp();
  }
}

typedef const __nv_bfloat16* cbf16p;
typedef __nv_bfloat16* bf16p;

template <int D>
int launch(cbf16p q, cbf16p k, cbf16p v, int ld, const void* bias,
           const void* dout, bf16p dq, bf16p dk, bf16p dv, int B, int L,
           int H, float scale, uint32_t seed, uint32_t thr, float inv_keep,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(L);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  mha_bwd_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, ld, static_cast<const float*>(bias),
      static_cast<cbf16p>(dout), dq, dk, dv, L, H * D, scale, seed, thr,
      inv_keep);
  return (int)cudaGetLastError();
}

int dispatch(cbf16p q, cbf16p k, cbf16p v, int ld, const void* bias,
             const void* dout, bf16p dq, bf16p dk, bf16p dv, int B, int L,
             int H, int D, float scale, unsigned seed, unsigned thr,
             float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(DIM)                                                          \
  launch<DIM>(q, k, v, ld, bias, dout, dq, dk, dv, B, L, H, scale, seed, thr, \
              inv_keep, s)
  switch (D) {
    case 8: return LAUNCH(8);
    case 16: return LAUNCH(16);
    case 24: return LAUNCH(24);
    case 32: return LAUNCH(32);
    case 48: return LAUNCH(48);
    case 64: return LAUNCH(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH
}

}  // namespace attn_bwd
