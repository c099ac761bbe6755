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
// One device code serves both: operands and cotangents through three
// pointers each, with a row stride of 3E (packed) or E (separate), so the
// two entry points give the same bits. The bias cotangent is not
// computed: the module builds the bias from the padding mask and drops its
// gradient (models/attention.py:182-184 of the JAX package).
//
// Numerics, kept from the TPU kernel (per head h):
//   z  = q . k^T * (1/sqrt(D)) + bias[key]   bf16 operands, f32 accumulation
//   p  = softmax(z)                          recomputed in f32 over the
//                                            whole row (exact max, sum)
//   dp = dO . v^T                            f32, then * keep / (1 - p_drop)
//   delta = sum_j dp * p                     f32, from dp and p (not dO . O)
//   ds = bf16(p * (dp - delta) * (1/sqrt(D)))
//   pd = bf16(p * keep / (1 - p_drop))
//   dQ = ds . K,  dK = ds^T . Q,  dV = pd^T . dO   f32 accumulation, bf16 out
// The dropout mask is regenerated from the seed (dropout.cuh), identical to
// the forward kernel's; p is the forward's p bit for bit (the same z, exp,
// and corrected division by the same row sum).
//
// What bounds it: per ViT-T layer at B = 256 (L = 197, H = 3, D = 64) the
// five products are about 19 GFLOP and the kernel must read qkv and dO and
// write dqkv, about 135 MB: below the H100's bf16 ridge, so the least time
// is the bytes' 40 us at 3.35 TB/s. The first version ran every product as
// an f32 FMA on the CUDA cores (66x its bound). This one runs them on the
// tensor cores (mma.sync.m16n8k16 from mma.cuh, bf16 operands, f32
// accumulators); what is left is the f32 work per score on the CUDA cores
// (four exps, three corrected divisions, the dropout hash), q.k^T
// recomputed in five passes, and the bytes.
//
// Design: two kernels per call on the caller's stream, each with the grid
// (tiles of 16 kWarps rows, H, B) and warps of 16 rows (Cfg: 8 warps, 4 at
// D <= 24). No atomics: every dQ, dK and dV row is written by one warp, so
// a run repeats bit for bit.
//   A. mha_bwd_q_kernel, query side. A warp holds its 16 rows of q and dO
//      as A fragments. K_h, V_h and the key bias stream through shared
//      memory in chunks of kChunk = 256 keys (16-byte cp.async), and the
//      warp makes four rolled passes over 16-key tiles, recomputing z bit
//      for bit in each: the row max; the row sum of exp(z - max) and its
//      reciprocal; delta = sum dp * p with dp = dO . V^T on mma (V through
//      ldmatrix, not transposed); ds, whose accumulators are reused as the
//      A fragment of dQ += ds . K (K through ldmatrix.trans). It writes dQ
//      and (max, sum, 1/sum, delta) per (sample, head, row) to scratch.
//   B. mha_bwd_kv_kernel, key side. A warp holds its 16 rows of K_h and
//      V_h as A fragments. Q, dO and their rows' statistics stream through
//      shared memory in chunks of 256 queries; for each 16-query tile it
//      computes S^T = K . Q^T and dP^T = V . dO^T on mma, p from the
//      stored max, sum and 1/sum, then ds and pd, and accumulates
//      dK += dS^T . Q and dV += Pd^T . dO (accumulators reused as A
//      fragments, Q and dO through ldmatrix.trans).
// Dropout: the mask is a hash per score (dropout.cuh), about 20 integer
// operations, needed by A's last two passes and by B. Where one chunk
// holds every key (L <= 256, every path of the port), A hashes once, in
// its delta pass: it keeps a tile's 8 bits a lane in shared memory for its
// dQ pass, and writes each 16 x 16 tile's 256 bits (8 ballots) to scratch,
// where B reads its transposed tile back. Longer rows hash in each pass.
// Pads: keys and queries are padded to a multiple of 16 and the product
// depth to a multiple of 16 (D 24 -> 32, D 8 -> 16), every pad zero-filled
// (stale shared memory times a zero could still give NaN); a padded key
// has bias -inf (p = 0), and kernel B zeroes ds and pd of a padded query
// explicitly, since a padded query has no statistics. Staged rows are
// strided by an odd number of 16-byte words, so ldmatrix hits no bank
// conflict, plain or transposed. No length up to MAX_LENGTH is refused.
// S^T of kernel B need not equal z of kernel A bit for bit (another
// operand order in the tensor core), so its p may differ from kernel A's
// by about an ulp.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; dispatch returns cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma.cuh"

namespace attn_bwd {

using namespace tc;

typedef __nv_bfloat16 bf16;

constexpr int kChunk = 256;  // keys (A) or queries (B) staged at once

template <int D>
struct Geom {
  static_assert(D % 8 == 0 && D <= 64, "head dim: a multiple of 8, <= 64");
  static constexpr int kDp = (D + 15) / 16 * 16;  // product depth, padded
  static constexpr int kKSteps = kDp / 16;
  // row stride in elements of every staged operand: an odd number of
  // 16-byte words, so the 8 rows that one ldmatrix phase reads land on 8
  // distinct groups of 4 banks
  static constexpr int kStride = (kDp / 8) % 2 ? kDp : kDp + 8;
  static constexpr int kNTiles = D / 8;  // n8 tiles of a dQ, dK or dV row
};

// Block shape per head dim. Registers bound the resident warps: kernel A
// holds q, dO and dQ in registers, kernel B K, V, dK and dV. Above D 24 a
// block has 8 warps (128 rows) and an SM must hold kMinQ = 2 blocks of
// kernel A (128 registers a thread) and kMinKV = 2 of kernel B, 1 at
// D >= 48, where dK and dV need more. At D <= 24 a block has 4 warps (64
// rows) and an SM must hold 5 of either (96 registers): 20 warps an SM
// instead of 16, which ran the flagship profile's backward (D 24) faster
// on the H100; 8-warp blocks at 3 an SM (80 registers) spill there. ptxas
// must report 0 spill bytes for every instance.
template <int D>
struct Cfg {
  static constexpr bool kSmall = D <= 24;
  static constexpr int kWarps = kSmall ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTileRows = 16 * kWarps;  // query rows or keys
  static constexpr int kMinQ = kSmall ? 5 : 2;
  static constexpr int kMinKV = kSmall ? 5 : D >= 48 ? 1 : 2;
  // kernel A's cache of one chunk's keep bits, per warp: a 32-bit word
  // per lane for every 4 tiles of 16 keys
  static constexpr int kKeepWords = kWarps * (kChunk / 64) * 32;
};

// rows of a streamed operand held in shared memory at length L
__host__ __device__ inline int chunk_rows(int L) {
  return L < kChunk ? (L + 15) / 16 * 16 : kChunk;
}

// two staged operands and, per row, a float bias (A) or a float4 of row
// statistics (B)
template <int D>
size_t smem_bytes(int L, size_t per_row) {
  return (2 * sizeof(bf16) * Geom<D>::kStride + per_row) *
         (size_t)chunk_rows(L);
}

// Copy rows [r0, r0 + n) of a (row stride lda) and, with with_c, of c (row
// stride ldc) into shared memory at row stride kStride, and zero the rows
// up to the next multiple of 16; the caller waits and syncs.
template <int D>
__device__ __forceinline__ void stage(bf16* as, bf16* cs, const bf16* asrc,
                                      size_t lda, const bf16* csrc,
                                      size_t ldc, int r0, int n,
                                      bool with_c) {
  constexpr int kStride = Geom<D>::kStride;
  constexpr int kPieces = D / 8;  // 16-byte words of a head row
  const int rows = (n + 15) / 16 * 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < rows * kPieces; i += blockDim.x) {
    const int r = i / kPieces;
    const int c = (i - r * kPieces) * 8;
    bf16* ad = as + r * kStride + c;
    bf16* cd = cs + r * kStride + c;
    if (r < n) {
      cp_async16(ad, asrc + (size_t)(r0 + r) * lda + c);
      if (with_c) cp_async16(cd, csrc + (size_t)(r0 + r) * ldc + c);
    } else {
      *reinterpret_cast<uint4*>(ad) = zero;
      if (with_c) *reinterpret_cast<uint4*>(cd) = zero;
    }
  }
}

// zero the product-depth pad (columns D to kDp) of two staged operands
template <int D>
__device__ __forceinline__ void zero_depth_pad(bf16* as, bf16* cs, int cap) {
  using G = Geom<D>;
  if (G::kDp != D) {
    for (int r = threadIdx.x; r < cap; r += blockDim.x) {
      *reinterpret_cast<uint4*>(as + r * G::kStride + D) =
          make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(cs + r * G::kStride + D) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// store rows r0 and r0 + 8 of a (16, D) f32 block as bf16 at out (row
// stride ld)
template <int NT>
__device__ __forceinline__ void store_rows(bf16* out, size_t ld,
                                           const float (&x)[NT][4], int r0,
                                           int L, int quad) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r < L) {
      bf16* row = out + (size_t)r * ld;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * quad) =
            pack_bf16(x[n][2 * half], x[n][2 * half + 1]);
    }
  }
}

// p and the undropped dp of 16 query rows (A fragments qa of q, da of dO)
// against the 16 keys of a tile (kp: rows_lane of K, vp: of V, bs: the
// keys' bias): p = exp(z - max) / sum by the corrected division, the
// forward's p; dp = dO . V^T
template <int KS>
__device__ __forceinline__ void probs(float (&p)[2][4], float (&dp)[2][4],
                                      const uint32_t (&qa)[KS][4],
                                      const uint32_t (&da)[KS][4],
                                      const bf16* kp, const bf16* vp,
                                      const float* bs, float scale,
                                      const float (&m)[2], const float (&l)[2],
                                      const float (&rl)[2], int quad) {
  scores<KS>(p, qa, kp, bs, scale, quad);
  dot_rows<KS>(dp, da, vp);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[t][e] = div_rn(expf(p[t][e] - m[e >> 1]), l[e >> 1], rl[e >> 1]);
}

// the keep bits of this lane's 8 probabilities of a tile of 16 query rows
// and 16 keys (rows r0 and r0 + 8, keys j + 8 t + 2 quad + {0, 1}): bit
// 4 t + e for element [t][e]
__device__ __forceinline__ uint32_t keep_bits(uint32_t key, uint32_t thr,
                                              int r0, int L, int j,
                                              int quad) {
  uint32_t bits = 0;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t idx = (uint32_t)(r0 + 8 * (e >> 1)) * L + j + t * 8 +
                           2 * quad + (e & 1);
      bits |= (uint32_t)(dropout_bits(key, idx) >= thr) << (4 * t + e);
    }
  return bits;
}

// A 16 x 16 tile's 256 keep bits, from the 8 of each lane (keep_bits), as
// 8 words at dst: word 4 t + e holds element [t][e] of every lane, lane l
// at bit l. With query Q and key K in the tile, (Q, K) is word
// 4 (K / 8) + 2 (Q / 8) + K % 2, bit 4 (Q % 8) + (K % 8) / 2.
__device__ __forceinline__ void store_tile_bits(uint32_t* dst, uint32_t bits,
                                                int lane) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = __ballot_sync(0xffffffffu, (bits >> i) & 1u);
  if (lane == 0) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// ... and read back on the key side: this lane's 8 bits of the transposed
// tile (keys g and g + 8 as rows, queries 8 t + 2 quad + {0, 1} as
// columns, g = lane / 4), bit 4 t + e for element [t][e]
__device__ __forceinline__ uint32_t load_tile_bits(const uint32_t* src,
                                                   int lane) {
  const uint4 lo = reinterpret_cast<const uint4*>(src)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(src)[1];
  const bool odd = (lane >> 2) & 1;  // K % 2 = g % 2
  // word 4 (K / 8) + 2 (Q / 8) + K % 2 for K / 8 = e / 2, Q / 8 = t
  const uint32_t w[2][2] = {{odd ? lo.y : lo.x, odd ? lo.w : lo.z},
                            {odd ? hi.y : hi.x, odd ? hi.w : hi.z}};
  const int shift = 8 * (lane & 3) + (lane >> 3);  // 4 (Q % 8) + (K % 8) / 2
  uint32_t bits = 0;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)  // Q % 8 = 2 quad + e % 2
      bits |= ((w[e >> 1][t] >> (shift + 4 * (e & 1))) & 1u) << (4 * t + e);
  return bits;
}

// dp * keep / (1 - p_drop) where bit 4 t + e of bits is set, else 0
__device__ __forceinline__ void drop(float (&dp)[2][4], uint32_t bits,
                                     float inv_keep) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[t][e] = (bits >> (4 * t + e)) & 1u ? dp[t][e] * inv_keep : 0.f;
}

// ---- kernel A: query side -> dQ and the row statistics ----
// q, k, v, dq: head 0 of token 0 of sample 0 of each operand (cotangent);
// ld: elements between consecutive tokens of one of them (3E packed, E
// separate); dout has a row stride of E; stats: B H L float4; keep: the
// keep bits of B H T^2 tiles, T = ceil(L / 16), written with dropout at
// L <= kChunk
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinQ)
mha_bwd_q_kernel(const bf16* __restrict__ q_in, const bf16* __restrict__ k_in,
                 const bf16* __restrict__ v_in, int ld,
                 const float* __restrict__ bias,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq_out,
                 float4* __restrict__ stats, uint32_t* __restrict__ keep,
                 int L, int H, float scale, uint32_t seed, uint32_t thr,
                 float inv_keep) {
  using G = Geom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cap = chunk_rows(L);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + (size_t)cap * G::kStride;
  float* bs = reinterpret_cast<float*>(vs + (size_t)cap * G::kStride);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int E = H * D;
  // this lane's keep words (word w at kw[32 w]) when one chunk holds every
  // key: pass 2 hashes the mask and stores it, pass 3 reads it back
  uint32_t* kw = reinterpret_cast<uint32_t*>(bs + cap) +
                 warp * (kChunk / 64) * 32 + lane;
  const size_t head = (size_t)b * L * ld + (size_t)h * D;
  const float* brow = bias ? bias + (size_t)b * L : nullptr;
  const uint32_t key = dropout_key(seed, (uint32_t)(b * H + h));
  const int chunks = (L + kChunk - 1) / kChunk;
  const bool cached = thr && chunks == 1;
  const int row0 = blockIdx.x * Cfg<D>::kTileRows + warp * 16;  // its rows
  // with one chunk, the keep bits of this warp's 16-row block of tiles for
  // kernel B: tile jt at kg + 8 jt
  const int T = (L + 15) / 16;
  uint32_t* kg = keep + (((size_t)(b * H + h) * T + row0 / 16) * T) * 8;
  const int r0 = row0 + (lane >> 2);  // this lane's rows: r0 and r0 + 8
  const bf16* kp = rows_lane(ks, G::kStride, lane);  // K in q . K^T
  const bf16* kt = cols_lane(ks, G::kStride, lane);  // K in ds . K
  const bf16* vp = rows_lane(vs, G::kStride, lane);  // V in dO . V^T

  zero_depth_pad<D>(ks, vs, cap);
  if (chunks == 1) {  // K_h and V_h once
    stage<D>(ks, vs, k_in + head, ld, v_in + head, ld, 0, L, true);
    for (int r = threadIdx.x; r < cap; r += blockDim.x)
      bs[r] = r < L ? (brow ? brow[r] : 0.f) : -INFINITY;
    cp_async_wait_all();
    __syncthreads();
    // a warp past the last row has nothing to do; with several chunks
    // every warp takes part in the staging's barriers
    if (row0 >= L) return;
  }

  uint32_t qa[G::kKSteps][4], da[G::kKSteps][4];
  load_a<G::kKSteps>(qa, q_in + head, ld, r0, L, D, quad);
  load_a<G::kKSteps>(da, dout + (size_t)b * L * E + (size_t)h * D, E, r0, L,
                     D, quad);
  float dq[G::kNTiles][4];
#pragma unroll
  for (int n = 0; n < G::kNTiles; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  // per row (r0, r0 + 8): max, sum, 1 / sum rounded to nearest, delta
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float rl[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};

  // four passes over the keys: max; sum; delta; dQ
  for (int pass = 0; pass < 4; ++pass) {
    for (int c = 0; c < chunks; ++c) {
      const int j0 = c * kChunk;
      const int n = min(kChunk, L - j0);
      const int tiles = (n + 15) / 16;
      if (chunks > 1) {
        __syncthreads();  // every warp is done with the previous chunk
        stage<D>(ks, vs, k_in + head, ld, v_in + head, ld, j0, n, pass >= 2);
        for (int r = threadIdx.x; r < (n + 15) / 16 * 16;
             r += blockDim.x)
          bs[r] = r < n ? (brow ? brow[j0 + r] : 0.f) : -INFINITY;
        cp_async_wait_all();
        __syncthreads();
        if (row0 >= L) continue;
      }
      if (pass == 0) {
#pragma unroll 2
        for (int jt = 0; jt < tiles; ++jt) {
          float z[2][4];
          scores<G::kKSteps>(z, qa, kp + jt * 16 * G::kStride,
                             bs + jt * 16, scale, quad);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            m[0] = fmaxf(m[0], fmaxf(z[t][0], z[t][1]));
            m[1] = fmaxf(m[1], fmaxf(z[t][2], z[t][3]));
          }
        }
      } else if (pass == 1) {  // summed in the forward's order
#pragma unroll 2
        for (int jt = 0; jt < tiles; ++jt) {
          float z[2][4];
          scores<G::kKSteps>(z, qa, kp + jt * 16 * G::kStride,
                             bs + jt * 16, scale, quad);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            l[0] += expf(z[t][0] - m[0]) + expf(z[t][1] - m[0]);
            l[1] += expf(z[t][2] - m[1]) + expf(z[t][3] - m[1]);
          }
        }
      } else if (pass == 2) {  // delta = sum dp * p
        uint32_t word = 0;  // keep bits of 4 tiles, 8 a tile
#pragma unroll 1
        for (int jt = 0; jt < tiles; ++jt) {
          float p[2][4], dp[2][4];
          probs<G::kKSteps>(p, dp, qa, da, kp + jt * 16 * G::kStride,
                            vp + jt * 16 * G::kStride, bs + jt * 16, scale,
                            m, l, rl, quad);
          if (thr) {
            const uint32_t bits =
                keep_bits(key, thr, r0, L, j0 + jt * 16, quad);
            drop(dp, bits, inv_keep);
            if (cached) {
              word |= bits << ((jt & 3) * 8);
              if ((jt & 3) == 3 || jt == tiles - 1) {
                kw[(jt >> 2) * 32] = word;
                word = 0;
              }
              store_tile_bits(kg + 8 * jt, bits, lane);
            }
          }
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              delta[e >> 1] = fmaf(dp[t][e], p[t][e], delta[e >> 1]);
        }
      } else {  // dQ += ds . K
#pragma unroll 1
        for (int jt = 0; jt < tiles; ++jt) {
          float p[2][4], dp[2][4];
          probs<G::kKSteps>(p, dp, qa, da, kp + jt * 16 * G::kStride,
                            vp + jt * 16 * G::kStride, bs + jt * 16, scale,
                            m, l, rl, quad);
          if (thr)
            drop(dp,
                 cached ? kw[(jt >> 2) * 32] >> ((jt & 3) * 8)
                        : keep_bits(key, thr, r0, L, j0 + jt * 16, quad),
                 inv_keep);
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)  // ds, in f32
              p[t][e] = p[t][e] * (dp[t][e] - delta[e >> 1]) * scale;
          uint32_t a[4];
          pack_a(a, p);
          acc_cols<G::kNTiles>(dq, a, kt + jt * 16 * G::kStride, lane);
        }
      }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      if (pass == 0) {
        m[row] = quad_max(m[row]);
      } else if (pass == 1) {
        l[row] = quad_sum(l[row]);
        rl[row] = __frcp_rn(l[row]);
      } else if (pass == 2) {
        delta[row] = quad_sum(delta[row]);
      }
    }
  }

  store_rows<G::kNTiles>(dq_out + head, ld, dq, r0, L, quad);
  if (quad == 0) {
    float4* srow = stats + (size_t)(b * H + h) * L;
#pragma unroll
    for (int row = 0; row < 2; ++row)
      if (r0 + 8 * row < L)
        srow[r0 + 8 * row] = make_float4(m[row], l[row], rl[row], delta[row]);
  }
}

// ---- kernel B: key side -> dK and dV ----
// operands as in kernel A; stats and keep: kernel A's, read only
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinKV)
mha_bwd_kv_kernel(const bf16* __restrict__ q_in,
                  const bf16* __restrict__ k_in,
                  const bf16* __restrict__ v_in, int ld,
                  const float* __restrict__ bias,
                  const bf16* __restrict__ dout,
                  const float4* __restrict__ stats,
                  const uint32_t* __restrict__ keep,
                  bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
                  int L, int H, float scale, uint32_t seed, uint32_t thr,
                  float inv_keep) {
  using G = Geom<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cap = chunk_rows(L);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* os = qs + (size_t)cap * G::kStride;  // dO
  float4* ss = reinterpret_cast<float4*>(os + (size_t)cap * G::kStride);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int E = H * D;
  const size_t head = (size_t)b * L * ld + (size_t)h * D;
  const bf16* dsrc = dout + (size_t)b * L * E + (size_t)h * D;
  const float4* srow = stats + (size_t)(b * H + h) * L;
  const uint32_t key = dropout_key(seed, (uint32_t)(b * H + h));
  const int chunks = (L + kChunk - 1) / kChunk;
  const int key0 = blockIdx.x * Cfg<D>::kTileRows + warp * 16;  // its keys
  const int j0 = key0 + (lane >> 2);  // this lane's keys: j0 and j0 + 8
  // with dropout and one chunk, kernel A's keep bits of this warp's
  // column of tiles: query block it at kg + 8 T it
  const bool cached = thr && chunks == 1;
  const int T = (L + 15) / 16;
  const uint32_t* kg = keep + ((size_t)(b * H + h) * T * T + key0 / 16) * 8;
  const bf16* qp = rows_lane(qs, G::kStride, lane);  // Q in K . Q^T
  const bf16* qt = cols_lane(qs, G::kStride, lane);  // Q in dS^T . Q
  const bf16* op = rows_lane(os, G::kStride, lane);  // dO in V . dO^T
  const bf16* ot = cols_lane(os, G::kStride, lane);  // dO in Pd^T . dO

  zero_depth_pad<D>(qs, os, cap);
  uint32_t ka[G::kKSteps][4], va[G::kKSteps][4];
  load_a<G::kKSteps>(ka, k_in + head, ld, j0, L, D, quad);
  load_a<G::kKSteps>(va, v_in + head, ld, j0, L, D, quad);
  float bj[2];  // the keys' bias, -inf past the last key
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int j = j0 + 8 * row;
    bj[row] = j < L ? (bias ? bias[(size_t)b * L + j] : 0.f) : -INFINITY;
  }
  float dk[G::kNTiles][4], dv[G::kNTiles][4];
#pragma unroll
  for (int n = 0; n < G::kNTiles; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int c = 0; c < chunks; ++c) {
    const int i0 = c * kChunk;
    const int n = min(kChunk, L - i0);
    const int rows = (n + 15) / 16 * 16;
    if (c > 0) __syncthreads();  // every warp is done with the last chunk
    stage<D>(qs, os, q_in + head, ld, dsrc, E, i0, n, true);
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      if (r < n)
        cp_async16(ss + r, srow + i0 + r);
      else  // a padded query: finite placeholders, its ds and pd are zeroed
        ss[r] = make_float4(0.f, 1.f, 1.f, 0.f);
    }
    cp_async_wait_all();
    __syncthreads();
    if (key0 >= L) continue;  // nothing to compute, but every barrier

#pragma unroll 1
    for (int it = 0; it < rows / 16; ++it) {
      float s[2][4], dp[2][4], pd[2][4];
      dot_rows<G::kKSteps>(s, ka, qp + it * 16 * G::kStride);
      dot_rows<G::kKSteps>(dp, va, op + it * 16 * G::kStride);
      uint32_t bits = 0;  // keep bits, 4 t + e for element [t][e]
      if (cached) {
        bits = load_tile_bits(kg + (size_t)8 * T * it, lane);
      } else if (thr) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t idx =
                (uint32_t)(i0 + it * 16 + t * 8 + 2 * quad + (e & 1)) * L +
                (uint32_t)(j0 + 8 * (e >> 1));
            bits |= (uint32_t)(dropout_bits(key, idx) >= thr) << (4 * t + e);
          }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int col = it * 16 + t * 8 + 2 * quad + cc;  // query - i0
          const float4 st = ss[col];  // max, sum, 1 / sum, delta
          const bool valid = i0 + col < L;
#pragma unroll
          for (int row = 0; row < 2; ++row) {
            const int e = 2 * row + cc;
            const float z = logit(s[t][e], scale, bj[row]);
            const float p = div_rn(expf(z - st.x), st.y, st.z);
            float d = dp[t][e];
            float pk = p;
            if (thr) {
              const bool kept = (bits >> (4 * t + e)) & 1u;
              d = kept ? d * inv_keep : 0.f;
              pk = kept ? p * inv_keep : 0.f;
            }
            s[t][e] = valid ? p * (d - st.w) * scale : 0.f;  // ds
            pd[t][e] = valid ? pk : 0.f;
          }
        }
      }
      uint32_t a[4];
      pack_a(a, s);
      acc_cols<G::kNTiles>(dk, a, qt + it * 16 * G::kStride, lane);
      pack_a(a, pd);
      acc_cols<G::kNTiles>(dv, a, ot + it * 16 * G::kStride, lane);
    }
  }

  store_rows<G::kNTiles>(dk_out + head, ld, dk, j0, L, quad);
  store_rows<G::kNTiles>(dv_out + head, ld, dv, j0, L, quad);
}

typedef const bf16* cbf16p;
typedef bf16* bf16p;

template <int D>
int launch(cbf16p q, cbf16p k, cbf16p v, int ld, const void* bias,
           const void* dout, bf16p dq, bf16p dk, bf16p dv, void* scratch,
           int B, int L, int H, float scale, uint32_t seed, uint32_t thr,
           float inv_keep, cudaStream_t stream) {
  void* stats = scratch;
  if (B <= 0 || L <= 0 || H <= 0 || !stats) return (int)cudaErrorInvalidValue;
  const size_t smem_q = smem_bytes<D>(L, sizeof(float)) +
                        sizeof(uint32_t) * Cfg<D>::kKeepWords;
  const size_t smem_kv = smem_bytes<D>(L, sizeof(float4));
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_q_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mha_bwd_kv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + Cfg<D>::kTileRows - 1) / Cfg<D>::kTileRows, H, B);
  const float* b = static_cast<const float*>(bias);
  cbf16p d = static_cast<cbf16p>(dout);
  float4* st = static_cast<float4*>(stats);
  uint32_t* kb = reinterpret_cast<uint32_t*>(st + (size_t)B * H * L);
  mha_bwd_q_kernel<D><<<grid, Cfg<D>::kThreads, smem_q, stream>>>(
      q, k, v, ld, b, d, dq, st, kb, L, H, scale, seed, thr, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mha_bwd_kv_kernel<D><<<grid, Cfg<D>::kThreads, smem_kv, stream>>>(
      q, k, v, ld, b, d, st, kb, dk, dv, L, H, scale, seed, thr, inv_keep);
  return (int)cudaGetLastError();
}

// scratch, 16-byte aligned, written by kernel A and read by kernel B of
// this call: B H L float4 of row statistics, then, with dropout (thr != 0)
// and L <= kChunk, B H T^2 tiles of 8 words of keep bits, T = ceil(L / 16)
// (ops/attention.py bwd_scratch allocates it)
int dispatch(cbf16p q, cbf16p k, cbf16p v, int ld, const void* bias,
             const void* dout, bf16p dq, bf16p dk, bf16p dv, void* scratch,
             int B, int L, int H, int D, float scale, unsigned seed,
             unsigned thr, float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(DIM)                                                       \
  launch<DIM>(q, k, v, ld, bias, dout, dq, dk, dv, scratch, B, L, H, scale, \
              seed, thr, inv_keep, s)
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
