// Multi-head self-attention forward, bf16 in and out, for Hopper (sm_90a):
// the device code and its launcher (attn_fwd::dispatch), shared by the
// entry points of attention_fwd.cu (ops/attention.py) and by
// attention_block.cu (ops/attention_block.py). attention_fwd.cu exports
//   mha_qkv_fwd_bf16  on one packed (B, L, 3E) q|k|v operand, replacing the
//     TPU kernel multimodal_plankton_recognition_tpu/ops/pallas/attention.py
//     ::_fwd_kernel_stacked_qkv (mha_core_qkv / _mha_qkv_fwd);
//   mha_fwd_bf16      on separate (B, L, E) q, k and v, replacing
//     ::_fwd_kernel and ::_fwd_kernel_stacked (mha_core / _mha_fwd).
// Both run in eval and train mode and share one kernel: it reads q, k and v
// through three pointers with a row stride of 3E (packed) or E (separate).
//
// Numerics, kept from the TPU kernel:
//   s = q_h . k_h^T     bf16 operands, f32 accumulation
//   z = s * (1/sqrt(D)) + bias[key]     (bias optional: NULL = no mask)
//   p = softmax(z)      f32: max-subtract, exp, divide by the sum
//   p *= keep / (1 - p_drop)   train mode only (thr != 0), see dropout.cuh
//   p rounded to bf16 before P.V
//   o = p . v_h         f32 accumulation, rounded to bf16 on store
//
// What bounds it: per ViT-T layer at B = 256 (L = 197, H = 3, D = 64) the
// two products are about 7.6 GFLOP, and the kernel must read qkv and write
// out, about 77 MB. This first version runs the products on the CUDA cores
// in f32 FMA (67 TFLOP/s peak), so it is bound by those operations, not by
// the 23 us the bytes take at 3.35 TB/s. The (L, L) scores never leave the
// SM: one warp owns one query row and keeps its L probabilities in shared
// memory, so device memory sees only qkv once (per row block) and out once.
//
// Design: grid (ceil(L / 32), H, B); a block of 8 warps stages K_h and V_h
// of one (sample, head) in shared memory (2 * L * D * 2 B, 50.4 KB for
// ViT-T, above the 48 KB default, hence the MaxDynamicSharedMemorySize
// attribute), then each warp takes query rows r = row0 + warp, + 8, ...
// (rows >= L are skipped). Lanes stride over keys for the scores (K rows
// padded to an odd number of 32-bit words, so the 32 lanes hit 32 banks),
// warp shuffles give the row max and sum. For P.V the lanes split the D/2
// column pairs, and when D/2 < 32 several lane groups split the keys and
// are summed with shuffles. No wgmma, TMA or cp.async yet.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the entry point returns cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"

namespace attn_fwd {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 32;

template <int D>
struct Geom {
  static_assert(D % 2 == 0 && D <= 64, "head dim must be even and <= 64");
  static constexpr int kPairs = D / 2;  // bf16x2 words per head row
  // odd word stride: lane j reads row j, so 32 lanes land on 32 banks
  static constexpr int kKStride = (kPairs % 2 == 0) ? kPairs + 1 : kPairs;
  static constexpr int kGroups = 32 / kPairs;  // key groups in P.V
};

template <int D>
size_t smem_bytes(int L) {
  using G = Geom<D>;
  return sizeof(uint32_t) * (size_t)L * (G::kKStride + G::kPairs) +
         sizeof(float) * (size_t)kWarps * L;
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

// q, k, v: head 0 of token 0 of sample 0 of each operand; ld: elements
// between consecutive tokens of one operand (3E packed, E separate)
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
mha_fwd_kernel(const __nv_bfloat16* __restrict__ q_in,
               const __nv_bfloat16* __restrict__ k_in,
               const __nv_bfloat16* __restrict__ v_in, int ld,
               const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out,
               int L, int E, float scale, uint32_t seed, uint32_t thr,
               float inv_keep) {
  using G = Geom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem_raw);   // L x kKStride
  uint32_t* vs = ks + (size_t)L * G::kKStride;             // L x kPairs
  float* ps = reinterpret_cast<float*>(vs + (size_t)L * G::kPairs);  // kWarps x L

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row_words = (size_t)ld / 2;  // 32-bit words per token
  const size_t head = ((size_t)b * L * ld + (size_t)h * D) / 2;
  const uint32_t* qsrc = reinterpret_cast<const uint32_t*>(q_in) + head;
  const uint32_t* ksrc = reinterpret_cast<const uint32_t*>(k_in) + head;
  const uint32_t* vsrc = reinterpret_cast<const uint32_t*>(v_in) + head;

  for (int i = threadIdx.x; i < L * G::kPairs; i += blockDim.x) {
    const int j = i / G::kPairs;
    const int w = i - j * G::kPairs;
    ks[j * G::kKStride + w] = ksrc[(size_t)j * row_words + w];
    vs[j * G::kPairs + w] = vsrc[(size_t)j * row_words + w];
  }
  __syncthreads();

  const float* brow = bias ? bias + (size_t)b * L : nullptr;
  float* p = ps + (size_t)warp * L;
  const int c = lane % G::kPairs;  // column pair this lane sums in P.V
  const int g = lane / G::kPairs;  // key group of this lane in P.V
  const int row_end = min(L, (int)(blockIdx.x + 1) * kRowsPerBlock);
  const uint32_t key = dropout_key(seed, b * gridDim.y + h);

  for (int r = blockIdx.x * kRowsPerBlock + warp; r < row_end; r += kWarps) {
    float q[D];
    const __nv_bfloat162* qrow = reinterpret_cast<const __nv_bfloat162*>(
        qsrc + (size_t)r * row_words);
#pragma unroll
    for (int w = 0; w < G::kPairs; ++w) {
      const float2 f = __bfloat1622float2(qrow[w]);
      q[2 * w] = f.x;
      q[2 * w + 1] = f.y;
    }

    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const __nv_bfloat162* krow =
          reinterpret_cast<const __nv_bfloat162*>(ks + j * G::kKStride);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < G::kPairs; ++w) {
        const float2 f = __bfloat1622float2(krow[w]);
        s = fmaf(q[2 * w], f.x, s);
        s = fmaf(q[2 * w + 1], f.y, s);
      }
      float z = s * scale;
      if (brow) z += brow[j];
      p[j] = z;
      mx = fmaxf(mx, z);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < L; j += 32) {
      float pj = p[j] / sum;
      if (thr) pj = dropout_bits(key, r * L + j) >= thr ? pj * inv_keep : 0.f;
      p[j] = __bfloat162float(__float2bfloat16_rn(pj));
    }
    __syncwarp();

    float2 acc = make_float2(0.f, 0.f);
    if (g < G::kGroups) {
      for (int j = g; j < L; j += G::kGroups) {
        const float pj = p[j];
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vs + j * G::kPairs + c));
        acc.x = fmaf(pj, f.x, acc.x);
        acc.y = fmaf(pj, f.y, acc.y);
      }
    }
    // lane c of group 0 adds the partial sums of lanes c + s*kPairs,
    // read from the unmodified copy so that no partial is counted twice
    const float2 part = acc;
#pragma unroll
    for (int s = 1; s < G::kGroups; ++s) {
      acc.x += __shfl_sync(0xffffffffu, part.x, c + s * G::kPairs);
      acc.y += __shfl_sync(0xffffffffu, part.y, c + s * G::kPairs);
    }
    if (g == 0) {
      __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)b * L + r) * E + h * D);
      orow[c] = __floats2bfloat162_rn(acc.x, acc.y);
    }
    __syncwarp();  // the next row overwrites p
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, int ld, const void* bias, void* out, int B,
           int L, int H, float scale, uint32_t seed, uint32_t thr,
           float inv_keep, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(L);
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  mha_fwd_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, ld, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), L, H * D, scale, seed, thr, inv_keep);
  return (int)cudaGetLastError();
}

int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, int ld, const void* bias, void* out,
             int B, int L, int H, int D, float scale, unsigned seed,
             unsigned thr, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(DIM) \
  launch<DIM>(q, k, v, ld, bias, out, B, L, H, scale, seed, thr, inv_keep, s)
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

}  // namespace attn_fwd
