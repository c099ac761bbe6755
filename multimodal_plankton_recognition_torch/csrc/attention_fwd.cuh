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
// Numerics, kept from the TPU kernel (attention.py:374-398):
//   s = q_h . k_h^T     bf16 operands, f32 accumulation
//   z = s * (1/sqrt(D)) + bias[key]     (bias optional: NULL = no mask;
//                       the scale is not folded into q)
//   p = softmax(z)      f32 over the whole row: the exact row max, exp,
//                       then a divide by the row sum (no online softmax:
//                       p is normalised before it is rounded)
//   p *= keep / (1 - p_drop)   train mode only (thr != 0), see dropout.cuh
//   p rounded to bf16 before P.V
//   o = p . v_h         f32 accumulation, rounded to bf16 on store
//
// What bounds it: per ViT-T layer at B = 256 (L = 197, H = 3, D = 64) the
// two products are about 7.6 GFLOP and the kernel must read qkv and write
// out, about 77 MB: about 99 flop a byte, below the H100's bf16 ridge of
// about 295, so the least time is the bytes' 23 us at 3.35 TB/s. The first
// version ran both products as f32 FMAs on the CUDA cores (9.6 TFLOP/s,
// 36x its bound). This one runs them on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulators), so what is left is
// the f32 work per score on the CUDA cores (the scale and bias, two exps,
// the divide, the dropout hash) and the bytes.
//
// Design: grid (query tiles, H, B); a block of 8 warps takes one tile of
// 128 query rows (16 a warp) of one (sample, head). K_h, V_h and the bias of up
// to kChunk keys (256 for D <= 64, fewer above so that a chunk fits shared
// memory: Geom::kChunk) sit in shared memory, copied with 16-byte cp.async;
// keys are padded to a multiple of 16 and the q.k^T depth to a multiple of
// 16 (D 24 -> 32, D 8 -> 16), every pad zero-filled (stale shared memory
// times a zero p could still give NaN; a padded key's bias is -inf), and
// the rows strided by an odd number of 16-byte words so that ldmatrix hits
// no bank conflict. A warp keeps its q rows as A fragments in registers
// and makes three passes over the keys, 16 at a time, recomputing
// z = s * scale + bias bit for bit in each: the row max, the row sum of
// exp(z - max), then p = exp(z - max) / sum, dropped, rounded to bf16 and
// multiplied by V. Row max and sum are reduced with shuffles inside the
// quad that holds a row; the score accumulators of a 16-key tile are
// reused directly as the A fragment of P.V (the m16n8k16 C layout is the A
// layout), with V's B fragments from ldmatrix.trans, so no score leaves
// the registers. O is D/8 n8-tiles of f32, rounded and stored as bf16x2.
// Keeping a row's 256 scores in registers instead (one pass, fully
// unrolled, most of the register file a thread) ran slower in trials:
// few warps an SM and no reuse of its instruction stream, while the
// recomputed q.k^T is cheap on tensor cores.
//
// Head dims: every multiple of 8 up to 256, of 64 up to 512 and of 128 up
// to 1,024, one instance each (dispatch's range and step; the wrapper
// pads other head dims to the next instance). Up to D 128 a warp holds
// all of O (16 n8-tiles, 64 f32 a thread) beside q's fragments; above, O
// is cut into kGroups column groups of kGT n8-tiles (V staged kGT kGroups
// 8 columns wide, the pad zero), and the P.V pass runs once per group,
// recomputing z, so that q (64 registers at D 256) and one group's O (64)
// fit a thread's 255 registers. Above D 256 q's fragments (D / 2
// registers) would not fit beside O: a warp reads them from device memory
// at each k-step where it uses them (MemA, mma.cuh), the same values in
// the same order, so z and every rounding point stay those of the
// resident path; only the time grows (the 16 rows are re-read, from L1 or
// L2, for every 16-key tile of every pass). Above D 64 an SM holds one
// block (MinBlocks).
//
// Lengths above kChunk stream K_h (and V_h) through the same shared memory
// in chunks in each pass, so the rounding points stay those of the
// one-chunk path and no length is refused (the wrapper caps L at 65535
// so that the dropout counter r*L + j stays within 32 bits).
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the entry point returns cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma.cuh"

namespace attn_fwd {

using namespace tc;

constexpr int kWarps = 8;
constexpr int kTileRows = 16 * kWarps;  // query rows of a tile
constexpr int kMaxHeadDim = 1024;
// q's fragments held in registers up to this head dim, read where used
// above it
constexpr int kResidentHeadDim = 256;
// shared memory a block may take above D 64, where an SM holds one block
constexpr int kWideSmem = 200 * 1024;

// an odd number of 16-byte words of at least `cols` bf16 columns: rows
// so strided put the 8 rows that one ldmatrix phase reads on 8 distinct
// groups of 4 banks
__host__ __device__ constexpr int odd_stride(int cols) {
  return (cols / 8) % 2 ? cols : cols + 8;
}

template <int D>
struct Geom {
  static_assert(D % 8 == 0 && D >= 8 && D <= kMaxHeadDim,
                "head dim: a multiple of 8, <= 1024");
  static constexpr bool kResident = D <= kResidentHeadDim;
  static constexpr int kDp = (D + 15) / 16 * 16;  // q.k^T depth, padded
  static constexpr int kKSteps = kDp / 16;
  static constexpr int kOTiles = D / 8;  // n8 tiles of P.V
  // column groups of O (one P.V pass each) and n8 tiles a group
  static constexpr int kGroups = (kOTiles + 15) / 16;
  static constexpr int kGT = (kOTiles + kGroups - 1) / kGroups;
  static constexpr int kDv = kGroups * kGT * 8;  // V's staged width
  static constexpr int kKStride = odd_stride(kDp);
  static constexpr int kVStride = odd_stride(kDv);
  // keys of K_h / V_h staged at once: 256, or as many (a multiple of 16)
  // as fit kWideSmem above D 64
  static constexpr int kRowBytes = 2 * (kKStride + kVStride) + 4;
  static constexpr int kChunk =
      D <= 64 ? 256
              : (kWideSmem / kRowBytes / 16 * 16 < 256
                     ? kWideSmem / kRowBytes / 16 * 16
                     : 256);
};

// blocks an SM must be able to hold, which caps a thread's registers: 2
// (128 registers) for D 32-64, which fit there with no spill, where
// ptxas' own choice of 80 spills at D 32; 3 (80 registers) for D <= 24,
// which fit there too and keep 24 warps an SM resident; 1 above D 64,
// where q's fragments and O take up to 128 registers
template <int D>
struct MinBlocks {
  static constexpr int value = D > 64 ? 1 : D >= 32 ? 2 : 3;
};

// rows of K and V held in shared memory at length L
template <int D>
__host__ __device__ inline int chunk_rows(int L) {
  constexpr int kChunk = Geom<D>::kChunk;
  return L < kChunk ? (L + 15) / 16 * 16 : kChunk;
}

template <int D>
size_t smem_bytes(int L) {
  using G = Geom<D>;
  return (sizeof(__nv_bfloat16) * (G::kKStride + G::kVStride) +
          sizeof(float)) * (size_t)chunk_rows<D>(L);
}

// zero columns [from, to) of `rows` staged rows (row stride `stride`),
// 16 bytes at a time: the pads that staging never writes
__device__ __forceinline__ void zero_cols(__nv_bfloat16* base, int stride,
                                          int rows, int from, int to) {
  const int pieces = (to - from) / 8;
  for (int i = threadIdx.x; i < rows * pieces; i += blockDim.x) {
    const int r = i / pieces;
    *reinterpret_cast<uint4*>(base + r * stride + from + (i - r * pieces) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Copy keys [j0, j0 + n) of K_h (and V_h) into shared memory, their bias
// into bs (0 without a mask), and zero the rows up to the next multiple of
// 16 (bias -inf there); the caller waits and syncs.
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                      float* bs, const __nv_bfloat16* ksrc,
                                      const __nv_bfloat16* vsrc,
                                      const float* brow, size_t ld, int j0,
                                      int n, bool with_v) {
  using G = Geom<D>;
  constexpr int kPieces = D / 8;  // 16-byte words of a head row
  const int rows = (n + 15) / 16 * 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < rows * kPieces; i += kWarps * 32) {
    const int r = i / kPieces;
    const int c = (i - r * kPieces) * 8;
    __nv_bfloat16* kd = ks + r * G::kKStride + c;
    __nv_bfloat16* vd = vs + r * G::kVStride + c;
    if (r < n) {
      const size_t off = (size_t)(j0 + r) * ld + c;
      cp_async16(kd, ksrc + off);
      if (with_v) cp_async16(vd, vsrc + off);
    } else {
      *reinterpret_cast<uint4*>(kd) = zero;
      if (with_v) *reinterpret_cast<uint4*>(vd) = zero;
    }
  }
  for (int r = threadIdx.x; r < rows; r += kWarps * 32)
    bs[r] = r < n ? (brow ? brow[j0 + r] : 0.f) : -INFINITY;
}

// q, k, v: head 0 of token 0 of sample 0 of each operand; ld: elements
// between consecutive tokens of one operand (3E packed, E separate)
template <int D>
__global__ void __launch_bounds__(kWarps * 32, MinBlocks<D>::value)
mha_fwd_kernel(const __nv_bfloat16* __restrict__ q_in,
               const __nv_bfloat16* __restrict__ k_in,
               const __nv_bfloat16* __restrict__ v_in, int ld,
               const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int L, int H, float scale,
               uint32_t seed, uint32_t thr, float inv_keep) {
  using G = Geom<D>;
  constexpr int kChunk = G::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cap = chunk_rows<D>(L);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + (size_t)cap * G::kKStride;
  float* bs = reinterpret_cast<float*>(vs + (size_t)cap * G::kVStride);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int quad = lane & 3;
  const int E = H * D;
  const size_t head = (size_t)b * L * ld + (size_t)h * D;
  const __nv_bfloat16* ksrc = k_in + head;
  const __nv_bfloat16* vsrc = v_in + head;
  const float* brow = bias ? bias + (size_t)b * L : nullptr;
  const uint32_t key = dropout_key(seed, (uint32_t)(b * H + h));
  const int chunks = (L + kChunk - 1) / kChunk;
  const int row0 = blockIdx.x * kTileRows + warp * 16;  // this warp's rows
  const int r0 = row0 + g;  // this lane's rows: r0 and r0 + 8
  // this lane's ldmatrix rows: K (x4: keys 0-7 / 8-15, depth lo / hi) and
  // V (x4.trans: keys 0-7 / 8-15, columns n / n + 8)
  const __nv_bfloat16* kp = rows_lane(ks, G::kKStride, lane);
  const __nv_bfloat16* vp = cols_lane(vs, G::kVStride, lane);

  // the pads staging never writes stay zero: K's q.k^T depth, V's columns
  // past D up to the last O group's
  if (G::kDp != D) zero_cols(ks, G::kKStride, cap, D, G::kDp);
  if (G::kDv != D) zero_cols(vs, G::kVStride, cap, D, G::kDv);
  if (chunks == 1) {  // K_h and V_h once
    stage<D>(ks, vs, bs, ksrc, vsrc, brow, ld, 0, L, true);
    cp_async_wait_all();
    __syncthreads();
    // a warp past the last row has nothing to do; with several chunks
    // every warp takes part in the staging's barriers
    if (row0 >= L) return;
  }

  typename AFrag<G::kKSteps, G::kResident>::type qa;
  load_a<G::kKSteps>(qa, q_in + head, ld, r0, L, D, quad);
  float o[G::kGT][4];
#pragma unroll
  for (int n = 0; n < G::kGT; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float inv0 = 0.f, inv1 = 0.f;  // 1 / l, rounded to nearest

  // passes over the keys, each recomputing z bit for bit: the row max; the
  // row sum of exp(z - max); then, once for each column group of O, p =
  // exp(z - max) / sum, dropped, rounded to bf16 and multiplied by V
  for (int pass = 0; pass < 2 + G::kGroups; ++pass) {
    const int c0 = (pass - 2) * G::kGT * 8;  // the group's first column
    for (int c = 0; c < chunks; ++c) {
      const int j0 = c * kChunk;
      const int n = min(kChunk, L - j0);
      const int tiles = (n + 15) / 16;
      if (chunks > 1) {
        __syncthreads();  // every warp is done with the previous chunk
        stage<D>(ks, vs, bs, ksrc, vsrc, brow, ld, j0, n, pass >= 2);
        cp_async_wait_all();
        __syncthreads();
      }
      if (pass == 0) {
#pragma unroll 2
        for (int jt = 0; jt < tiles; ++jt) {
          float s[2][4];
          scores<G::kKSteps>(s, qa, kp + jt * 16 * G::kKStride, bs + jt * 16,
                             scale, quad);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            m0 = fmaxf(m0, fmaxf(s[t][0], s[t][1]));
            m1 = fmaxf(m1, fmaxf(s[t][2], s[t][3]));
          }
        }
      } else if (pass == 1) {
#pragma unroll 2
        for (int jt = 0; jt < tiles; ++jt) {
          float s[2][4];
          scores<G::kKSteps>(s, qa, kp + jt * 16 * G::kKStride, bs + jt * 16,
                             scale, quad);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            l0 += expf(s[t][0] - m0) + expf(s[t][1] - m0);
            l1 += expf(s[t][2] - m1) + expf(s[t][3] - m1);
          }
        }
      } else {
#pragma unroll 2
        for (int jt = 0; jt < tiles; ++jt) {
          float s[2][4];
          scores<G::kKSteps>(s, qa, kp + jt * 16 * G::kKStride, bs + jt * 16,
                             scale, quad);
          uint32_t a[4];  // the C pairs of the two n8 halves: P's A
#pragma unroll
          for (int t = 0; t < 2; ++t) {
#pragma unroll
            for (int row = 0; row < 2; ++row) {
              const float m = row ? m1 : m0;
              const float l = row ? l1 : l0;
              const float rl = row ? inv1 : inv0;
              float x0 = div_rn(expf(s[t][2 * row] - m), l, rl);
              float x1 = div_rn(expf(s[t][2 * row + 1] - m), l, rl);
              if (thr) {
                const uint32_t idx = (uint32_t)(r0 + 8 * row) * L + j0 +
                                     jt * 16 + t * 8 + 2 * quad;
                x0 = dropout_bits(key, idx) >= thr ? x0 * inv_keep : 0.f;
                x1 = dropout_bits(key, idx + 1) >= thr ? x1 * inv_keep
                                                       : 0.f;
              }
              a[2 * t + row] = pack_bf16(x0, x1);
            }
          }
          acc_cols<G::kGT>(o, a, vp + jt * 16 * G::kVStride + c0, lane);
        }
      }
    }
    if (pass == 0) {
      m0 = quad_max(m0);
      m1 = quad_max(m1);
    } else if (pass == 1) {
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      inv0 = __frcp_rn(l0);
      inv1 = __frcp_rn(l1);
    } else {  // the group's columns of O, then a fresh group
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + half * 8;
        if (r < L) {
          __nv_bfloat16* orow = out + ((size_t)b * L + r) * E + h * D + c0;
#pragma unroll
          for (int n = 0; n < G::kGT; ++n)
            if (G::kDv == D || c0 + n * 8 < D)
              *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * quad) =
                  pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
        }
      }
#pragma unroll
      for (int n = 0; n < G::kGT; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    }
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, int ld, const void* bias, void* out, int B,
           int L, int H, float scale, uint32_t seed, uint32_t thr,
           float inv_keep, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D>(L);
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kTileRows - 1) / kTileRows, H, B);
  mha_fwd_kernel<D><<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, ld, static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), L, H, scale, seed, thr, inv_keep);
  return (int)cudaGetLastError();
}

// launch<D> for the head dim D of LO, LO + STEP, ..., HI (multiples of
// 8) that equals d; cudaErrorInvalidValue for any other d
template <int LO, int HI, int STEP = 8>
int dispatch(const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, int ld, const void* bias, void* out,
             int B, int L, int H, int d, float scale, unsigned seed,
             unsigned thr, float inv_keep, void* stream) {
  static_assert(LO % 8 == 0 && STEP % 8 == 0 && LO <= HI,
                "a range of multiples of 8");
  if (d == LO)
    return launch<LO>(q, k, v, ld, bias, out, B, L, H, scale, seed, thr,
                      inv_keep, static_cast<cudaStream_t>(stream));
  if constexpr (LO + STEP <= HI)
    return dispatch<LO + STEP, HI, STEP>(q, k, v, ld, bias, out, B, L, H, d,
                                         scale, seed, thr, inv_keep, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn_fwd
