// Warp-level tensor-core building blocks shared by the attention forward
// (attention_fwd.cuh) and backward (attention_bwd.cuh): 16-byte cp.async,
// ldmatrix, mma.sync.m16n8k16 with bf16 operands and f32 accumulators, the
// 16 x 16 tile products built from them, the corrected division and the
// quad reductions.
//
// Fragment layouts of m16n8k16 (g = lane / 4, quad = lane % 4):
//   A (16 x 16): a[0] row g, columns 2 quad + {0, 1}; a[1] row g + 8;
//                a[2] row g, columns 8 + 2 quad + {0, 1}; a[3] row g + 8
//   B (16 x 8):  b0 rows 2 quad + {0, 1} of column g; b1 rows 8 + 2 quad
//   C (16 x 8):  c[0..1] row g, columns 2 quad + {0, 1}; c[2..3] row g + 8
// The C pairs of two n8 halves of a 16 x 16 product are, packed to bf16,
// exactly the A fragment of that 16 x 16 tile (pack_a), so a product's
// result feeds the next product without leaving the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a . b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x[t][e], the C fragments of the two n8 halves t of a 16 x 16 tile, as
// the A fragment of that tile, rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&x)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    a[2 * t] = pack_bf16(x[t][0], x[t][1]);
    a[2 * t + 1] = pack_bf16(x[t][2], x[t][3]);
  }
}

// The A fragments of rows r0 and r0 + 8 (r0 = first row + lane / 4) of a
// 16-row slab of a (rows, D) bf16 operand in device memory (row stride
// ld), over a depth padded to 16 KSTEPS: zero past row L and past column
// D, so that a pad never meets stale data.
template <int KSTEPS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KSTEPS][4],
                                       const __nv_bfloat16* src, size_t ld,
                                       int r0, int L, int D, int quad) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e & 1) * 8;
      const int c = kk * 16 + (e >> 1) * 8 + 2 * quad;
      a[kk][e] = 0u;
      if (r < L && kk * 16 + (e >> 1) * 8 < D)
        a[kk][e] = *reinterpret_cast<const uint32_t*>(src + (size_t)r * ld +
                                                      c);
    }
  }
}

// This lane's ldmatrix address in a staged (rows, depth) bf16 operand
// (row stride `stride` elements) for the B fragments of A . X^T, where X
// is 16 rows of that operand: matrices (rows 0-7 | 8-15) x (depth lo | hi)
__device__ __forceinline__ const __nv_bfloat16* rows_lane(
    const __nv_bfloat16* base, int stride, int lane) {
  const int mi = lane >> 3;
  return base + ((lane & 7) + (mi >> 1) * 8) * stride + (mi & 1) * 8;
}

// ... and for the B fragments of A . X, X = 16 rows of that operand read
// transposed (ldmatrix.trans): matrices (rows 0-7 | 8-15) x (columns n |
// n + 8)
__device__ __forceinline__ const __nv_bfloat16* cols_lane(
    const __nv_bfloat16* base, int stride, int lane) {
  const int mi = lane >> 3;
  return base + ((lane & 7) + (mi & 1) * 8) * stride + (mi >> 1) * 8;
}

// s[t] = a . X^T over the two n8 halves t of the 16 rows X staged at p
// (rows_lane of the tile's first row), depth 16 KSTEPS
template <int KSTEPS>
__device__ __forceinline__ void dot_rows(float (&s)[2][4],
                                         const uint32_t (&a)[KSTEPS][4],
                                         const __nv_bfloat16* p) {
#pragma unroll
  for (int e = 0; e < 4; ++e) s[0][e] = s[1][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t b[4];
    ldmatrix_x4(b, p + kk * 16);
    mma16816(s[0], a[kk], b[0], b[1]);
    mma16816(s[1], a[kk], b[2], b[3]);
  }
}

// o[n] += a . X[:, 8n : 8n + 8] for the NT n8 tiles of the 16 rows X
// staged at p (cols_lane of the tile's first row), read transposed
template <int NT>
__device__ __forceinline__ void acc_cols(float (&o)[NT][4],
                                         const uint32_t (&a)[4],
                                         const __nv_bfloat16* p, int lane) {
#pragma unroll
  for (int nn = 0; nn + 1 < NT; nn += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, p + nn * 8);
    mma16816(o[nn], a, b[0], b[1]);
    mma16816(o[nn + 1], a, b[2], b[3]);
  }
  if (NT % 2) {
    uint32_t b[2];  // lanes 0-15 address the two matrices
    ldmatrix_x2_trans(b, p + (NT - 1) * 8 - ((lane >> 3) >> 1) * 8);
    mma16816(o[NT - 1], a, b[0], b[1]);
  }
}

// z = s * scale + bias: fmul then fadd, never contracted into one fma, so
// that every pass and both attention directions round z alike
__device__ __forceinline__ float logit(float s, float scale, float bias) {
  return __fadd_rn(__fmul_rn(s, scale), bias);
}

// z of 16 rows (the A fragments a) against the 16 keys X staged at p
// (rows_lane of the tile's first key), whose bias is at bs: z[t] is the n8
// half t (keys 8 t + 2 quad + {0, 1}; elements 0-1 on row lane / 4, 2-3
// on row lane / 4 + 8)
template <int KSTEPS>
__device__ __forceinline__ void scores(float (&z)[2][4],
                                       const uint32_t (&a)[KSTEPS][4],
                                       const __nv_bfloat16* p,
                                       const float* bs, float scale,
                                       int quad) {
  dot_rows<KSTEPS>(z, a, p);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float2 add = *reinterpret_cast<const float2*>(bs + t * 8 + 2 * quad);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      z[t][e] = logit(z[t][e], scale, e & 1 ? add.y : add.x);
  }
}

// a / b rounded to nearest, as IEEE division gives it, for a in [0, 1] and
// b in [1, 65536) (an exp over the row max, and a row sum of at most
// MAX_LENGTH such terms), from r = 1/b rounded to nearest: Markstein's
// correction q + (a - q b) r of q = a r, exact while the remainder stays
// normal; for 0 < a < 2^-100 a true divide. It costs two FMAs where
// div.rn costs a subroutine with a slow path on every element.
// tests/test_torch_attention.py::test_corrected_division_is_ieee_division
// holds an exact emulation of it to IEEE division on that domain.
__device__ __forceinline__ float div_rn(float a, float b, float r) {
  if (a < 0x1p-100f && a != 0.f) return __fdiv_rn(a, b);
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

// max / sum over the 4 lanes of a quad (the lanes that share a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tc
