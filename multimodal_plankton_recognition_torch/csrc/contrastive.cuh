// The building blocks of the bucketed contrastive losses (sm_90a), shared
// by csrc/clip_loss.cu (kernels 5-6) and csrc/siglip_loss.cu (kernels
// 7-8). Per bucket of N image rows x and N profile rows y of width D (bf16
// or f32 in, f32 inside), every kernel works on TILE x TILE tiles of
//   s = (x . y) / (nx * ny),  nx = max(||x||, 1e-12), ny likewise,
// and the losses differ only in their per-element step and their merge:
//
//   * tile_dot stages x and y in chunks of KC = 64 columns through a ring
//     of 16-byte cp.async stages (four for 32-row tiles, eight for 16-row
//     ones; all but one in flight while one is used; a scalar path where a
//     row is not a whole number of 16-byte pieces), runs the tile's dot
//     products in 4 x 4 register tiles, the chunk's columns split over
//     groups of threads whose partials are added in group order, and takes
//     each row's norm from the same staged chunks: no normalisation pass
//     and no unit rows in device memory;
//   * last_block: a completion ticket, so that the last block of a grid
//     merges the tiles' partials in tile order and resets the ticket;
//   * dz_tile: the backward's step on one tile. A loss's Step gives dz
//     from s (CLIP from the forward's lse, SigLIP from z alone); the tile
//     then writes ds / ny and ds / nx (the gradient GEMM's operands), the
//     line sums q = sum ds s that the projection needs, and its sums of
//     dz s (and, for SigLIP, of dz);
//   * block_grads: one block a bucket of one 16-row tile; d_in and d_pn
//     from register tiles over the staged rows, projected in the epilogue:
//     di = (d_in - (q_r / nx) x) / nx, since d_in . x/nx = sum_c ds s = q_r;
//   * grad_gemm: above one tile, d_in and d_pn as one tiled GEMM over k = N
//     from the dz kernel's N x NP operands, with the same epilogue.
//
// Every sum is taken in a fixed order, so two calls agree bit for bit; no
// atomics but the ticket. The products are f32 FMAs on the CUDA cores: at
// these sizes the kernels wait on latency, not on the FMA rate.
//
// Internal linkage (an anonymous namespace), as mbconv.cuh: each library
// holds its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 64;       // embedding columns of one ring stage
constexpr int kStages = 4;   // ring depth of the d_in / d_pn GEMM
constexpr int kPad = 16;     // bytes after each staged row: 16-byte aligned,
                             // and rows 4 banks apart
constexpr int TR = 32;       // output rows of a d_in / d_pn tile (N > 16)
constexpr int TD = 64;       // embedding columns of a d_in / d_pn tile
constexpr int KB = 32;       // k rows of one d_in / d_pn stage
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// two neighbouring elements (the first at an even index) as f32
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 copies nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sum of one value per thread over the block, warps added in order; red
// holds kWarps floats
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// True in the block that finishes last among `blocks`; its reads of what
// the others wrote before their ticket must bypass L1 (__ldcg).
__device__ bool last_block(unsigned* ticket, unsigned blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The dot products of a TILE x TILE block: rows a[0, na) against rows
// b[0, nb) over D, and each row's norm.
template <typename T, int TILE>
struct Tile {
  static constexpr int kRow = KC * (int)sizeof(T) + kPad;  // bytes
  static constexpr int kStageBytes = 2 * TILE * kRow;
  // ring depth: 16-row tiles are latency-bound, so all of D = 512 is in
  // flight at once
  static constexpr int kDepth = TILE == 16 ? 8 : 4;
  static constexpr int kRingBytes = kDepth * kStageBytes;
  static constexpr int kSub = TILE / 4;  // a thread's rows and columns
                                         // lie kSub apart
  static constexpr int kGroupThreads = kSub * kSub;
  static constexpr int kGroups = kThreads / kGroupThreads;  // split-K
  static constexpr int kSlice = KC / kGroups;  // a group's stage columns
  static constexpr int kRowThreads = kThreads / (2 * TILE);  // per norm
  static constexpr int kLd = TILE + 1;  // row stride of the dot tile
  static_assert(kGroups * kGroupThreads == kThreads && kSlice % 2 == 0,
                "split-K groups");
  static_assert(kGroups * TILE * TILE * 4 <= kRingBytes,
                "the split-K partials overlay the ring");
  static_assert(KC % (2 * kRowThreads) == 0, "norm lanes");
};

// Stage columns [k0, k0 + KC) of rows a[0, TILE) and b[0, TILE): rows at
// or past na / nb and columns at or past D are zeros.
template <typename T, int TILE>
__device__ void load_stage(unsigned char* st, const T* a, int na,
                           const T* b, int nb, int D, int k0, bool vec) {
  constexpr int kRow = Tile<T, TILE>::kRow;
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T);  // elements of a piece
    constexpr int kPieces = KC / kPer;          // pieces of a row
    for (int p = threadIdx.x; p < 2 * TILE * kPieces; p += kThreads) {
      const int row = p / kPieces, q = p % kPieces;
      const bool side_b = row >= TILE;
      const int r = side_b ? row - TILE : row;
      const int col = k0 + q * kPer;
      const T* base = side_b ? b : a;
      const bool ok = r < (side_b ? nb : na) && col < D;
      cp_async16(st + row * kRow + q * 16,
                 ok ? base + (size_t)r * D + col : base, ok);
    }
  } else {
    for (int e = threadIdx.x; e < 2 * TILE * KC; e += kThreads) {
      const int row = e / KC, q = e % KC;
      const bool side_b = row >= TILE;
      const int r = side_b ? row - TILE : row;
      const int col = k0 + q;
      const T* base = side_b ? b : a;
      const bool ok = r < (side_b ? nb : na) && col < D;
      reinterpret_cast<T*>(st + row * kRow)[q] =
          ok ? base[(size_t)r * D + col] : from_f32<T>(0.f);
    }
  }
}

// dot[r * kLd + c] = a_r . b_c (r < TILE, c < TILE; zero rows beyond na,
// nb); nrm[r] = max(||a_r||, eps), nrm[TILE + c] = max(||b_c||, eps). red:
// kGroups TILE^2 floats for the split-K partials, the ring itself or, to
// keep the staged rows, space of its own. Ends with __syncthreads().
template <typename T, int TILE>
__device__ void tile_dot(unsigned char* ring, float* red, float* dot,
                         float* nrm, const T* a, int na, const T* b, int nb,
                         int D, bool vec) {
  using C = Tile<T, TILE>;
  const int tid = threadIdx.x;
  const int g = tid / C::kGroupThreads, u = tid % C::kGroupThreads;
  const int tr = u / C::kSub, tc = u % C::kSub;
  const int nrow = tid / C::kRowThreads, npart = tid % C::kRowThreads;
  float acc[4][4] = {};
  float ss = 0.f;
  const int chunks = (D + KC - 1) / KC;
  // a thread's first A and B element of a stage; its other rows lie at
  // constant offsets
  const int a_off = tr * C::kRow + g * C::kSlice * (int)sizeof(T);
  const int b_off = (TILE + tc) * C::kRow + g * C::kSlice * (int)sizeof(T);
#pragma unroll
  for (int s = 0; s < C::kDepth - 1; ++s) {
    if (s < chunks)
      load_stage<T, TILE>(ring + s * C::kStageBytes, a, na, b, nb, D,
                          s * KC, vec);
    cp_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_wait<C::kDepth - 2>();
    __syncthreads();  // stage k landed; stage k - 1 is free
    const int next = k + C::kDepth - 1;
    if (next < chunks)
      load_stage<T, TILE>(ring + (next % C::kDepth) * C::kStageBytes, a, na,
                          b, nb, D, next * KC, vec);
    cp_commit();
    const unsigned char* st = ring + (k % C::kDepth) * C::kStageBytes;
    const T* ar = reinterpret_cast<const T*>(st + a_off);
    const T* br = reinterpret_cast<const T*>(st + b_off);
    constexpr int kStep = C::kSub * C::kRow / (int)sizeof(T);  // elements
#pragma unroll
    for (int d = 0; d < C::kSlice; d += 2) {
      float2 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = pair(ar + i * kStep + d);
        bv[i] = pair(br + i * kStep + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        }
    }
    // squares: a row's lanes take interleaved column pairs
    const T* row = reinterpret_cast<const T*>(st + nrow * C::kRow);
#pragma unroll
    for (int q = npart; q < KC / 2; q += C::kRowThreads) {
      const float2 v = pair(row + 2 * q);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
    }
  }
  cp_wait<0>();
  __syncthreads();  // every thread is done with the ring
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[g * TILE * TILE + (tr + C::kSub * i) * TILE + tc + C::kSub * j] =
          acc[i][j];
#pragma unroll
  for (int o = C::kRowThreads / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (npart == 0) nrm[nrow] = fmaxf(sqrtf(ss), kEps);
  __syncthreads();
  for (int o = tid; o < TILE * TILE; o += kThreads) {
    float sum = red[o];
    for (int gg = 1; gg < C::kGroups; ++gg) sum += red[gg * TILE * TILE + o];
    dot[(o / TILE) * C::kLd + o % TILE] = sum;
  }
  __syncthreads();
}

// Lines of a TILE x TILE smem tile m (row stride TILE + 1): lines 0..TILE-1
// are its rows, TILE..2 TILE-1 its columns; kLineThreads lanes a line.
template <int TILE>
struct Lines {
  static constexpr int kLineThreads = kThreads / (2 * TILE);
  static constexpr int kPer = TILE / kLineThreads;
  int k, part;
  bool col;
  __device__ Lines() {
    const int line = threadIdx.x / kLineThreads;
    part = threadIdx.x % kLineThreads;
    col = line >= TILE;
    k = col ? line - TILE : line;
  }
  __device__ float at(const float* m, int j) const {
    const int t = part + kLineThreads * j;
    return col ? m[t * (TILE + 1) + k] : m[k * (TILE + 1) + t];
  }
  __device__ float reduce_sum(float x) const {
#pragma unroll
    for (int o = kLineThreads / 2; o > 0; o >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  }
  __device__ float reduce_max(float x) const {
#pragma unroll
    for (int o = kLineThreads / 2; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
  }
};

// The backward's work on one TILE x TILE block, once tile_dot ran: dz =
// step.dz(s, r, c) inside na x nb; a0[c * lda + r] = ds_rc / ny_c (d_in's
// k-major operand; rows c < nb, zero at r >= na) and a1[r * lda + c] =
// ds_rc / nx_r (d_pn's; rows r < na, zero at c >= nb), ds = dz e: no row
// past the bucket is written; the tile's q line sums (row sums of ds s to
// qr[r * qstride], column sums to qc[c * qstride]); returns the tile's sum
// of dz s and, where Step::kBias, of dz (the same values in every thread).
// m holds the dot products and is overwritten by ds; ds s goes to m + TILE
// (TILE + 1) (row stride TILE).
template <int TILE, typename Step>
__device__ float2 dz_tile(float* m, const float* nrm, const Step& step,
                          int na, int nb, float* a0, float* a1, int lda,
                          float* qr, float* qc, int qstride, float* red) {
  constexpr int kLd = TILE + 1;
  float* dss = m + TILE * kLd;
  float dzs = 0.f, dzb = 0.f;
  for (int o = threadIdx.x; o < TILE * TILE; o += kThreads) {
    const int r = o / TILE, c = o % TILE;
    float ds = 0.f, d2 = 0.f;
    if (r < na && c < nb) {
      const float s = m[r * kLd + c] / (nrm[r] * nrm[TILE + c]);
      const float dz = step.dz(s, r, c);
      dzs = fmaf(dz, s, dzs);
      if constexpr (Step::kBias) dzb += dz;
      ds = dz * step.e;
      d2 = ds * s;
    }
    if (r < na) a1[(size_t)r * lda + c] = c < nb ? ds / nrm[r] : 0.f;
    m[r * kLd + c] = ds;
    dss[o] = d2;
  }
  __syncthreads();
  // a0 in its own order, so that consecutive threads write consecutive r
  for (int o = threadIdx.x; o < TILE * TILE; o += kThreads) {
    const int c = o / TILE, r = o % TILE;
    if (c < nb)
      a0[(size_t)c * lda + r] = r < na ? m[r * kLd + c] / nrm[TILE + c] : 0.f;
  }
  // line sums of ds s (rows over the tile's columns, columns over rows)
  {
    const Lines<TILE> ln;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < Lines<TILE>::kPer; ++j) {
      const int t = ln.part + Lines<TILE>::kLineThreads * j;
      s += ln.col ? dss[t * TILE + ln.k] : dss[ln.k * TILE + t];
    }
    s = ln.reduce_sum(s);
    if (ln.part == 0 && ln.k < (ln.col ? nb : na))
      (ln.col ? qc : qr)[(size_t)ln.k * qstride] = s;
  }
  const float sum_s = block_sum(dzs, red);
  if constexpr (Step::kBias) {
    return make_float2(sum_s, block_sum(dzb, red));
  } else {
    return make_float2(sum_s, 0.f);
  }
}

// Shared memory of the dot tile, its norms and dz_tile's ds s beside it.
template <int TILE>
constexpr int tile_floats() {
  return TILE * (TILE + 1) + TILE * TILE + 2 * TILE;
}

// The one-block backward (one 16-row tile a bucket) after dz_tile: d_in
// (side 0, to dx) and d_pn (side 1, to dy) of the bucket's N rows x, y,
// over KC-column stages of x and y; a thread takes kRows rows of its side
// and two columns. a0s, a1s: dz_tile's operands (TILE x TILE, stride
// TILE, zero past N); q: the line sums (rows, then columns); nrm:
// tile_dot's norms. Where the ring held every chunk (D <= kDepth KC),
// tile_dot left them in place (stage k is chunk k); else they stream
// through it again.
template <typename T>
__device__ __forceinline__ void block_grads(unsigned char* smem,
                                            const float* a0s,
                                            const float* a1s, const float* q,
                                            const float* nrm, const T* x,
                                            const T* y, T* dx, T* dy, int N,
                                            int D, bool vec) {
  constexpr int TILE = 16;
  using C = Tile<T, TILE>;
  constexpr int kRows = TILE / 4;
  const int side = threadIdx.x / 128;
  const int tr = (threadIdx.x % 128) / 32, td = threadIdx.x % 32;
  const float* A = side ? a1s : a0s;  // [k][out row], stride TILE
  T* out = side ? dy : dx;
  const int chunks = (D + KC - 1) / KC;
  const bool resident = chunks <= C::kDepth;
  for (int s = 0; s < C::kDepth - 1 && !resident; ++s) {
    if (s < chunks)
      load_stage<T, TILE>(smem + s * C::kStageBytes, x, N, y, N, D, s * KC,
                          vec);
    cp_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    if (!resident) {
      cp_wait<C::kDepth - 2>();
      __syncthreads();
      const int next = k + C::kDepth - 1;
      if (next < chunks)
        load_stage<T, TILE>(smem + (next % C::kDepth) * C::kStageBytes, x,
                            N, y, N, D, next * KC, vec);
      cp_commit();
    }
    const unsigned char* st = smem + (k % C::kDepth) * C::kStageBytes;
    // the other side's rows are the k operand, the own side's rows the
    // epilogue's
    const unsigned char* other = st + (side ? 0 : TILE) * C::kRow;
    const unsigned char* own = st + (side ? TILE : 0) * C::kRow;
    float acc[kRows][2] = {};
    // rows past N are zeros on both sides: the loop runs to TILE
#pragma unroll 8
    for (int kk = 0; kk < TILE; ++kk) {
      const float2 bv =
          pair(reinterpret_cast<const T*>(other + kk * C::kRow) + 2 * td);
      const float4* a4 =
          reinterpret_cast<const float4*>(A + kk * TILE + tr * kRows);
#pragma unroll
      for (int i4 = 0; i4 < kRows / 4; ++i4) {
        const float4 a = a4[i4];
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[4 * i4 + i][0] = fmaf(av[i], bv.x, acc[4 * i4 + i][0]);
          acc[4 * i4 + i][1] = fmaf(av[i], bv.y, acc[4 * i4 + i][1]);
        }
      }
    }
    const int col = k * KC + 2 * td;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int o = tr * kRows + i;
      if (o >= N) break;
      const float inv = 1.f / nrm[side * TILE + o];
      const float qn = q[side * TILE + o] * inv;
      const float2 v =
          pair(reinterpret_cast<const T*>(own + o * C::kRow) + 2 * td);
      T* dst = out + (size_t)o * D + col;
      if (col < D) dst[0] = from_f32<T>((acc[i][0] - qn * v.x) * inv);
      if (col + 1 < D) dst[1] = from_f32<T>((acc[i][1] - qn * v.y) * inv);
    }
  }
  cp_wait<0>();
}

// Shared memory of the one-block backward: the ring | m (dot, then ds) and
// ds s | nrm | a0s, a1s (TILE x TILE, stride TILE) | q (2 TILE) | the
// split-K partials.
template <typename T>
constexpr int block_bwd_smem() {
  constexpr int TILE = 16;
  return Tile<T, TILE>::kRingBytes +
         4 * (tile_floats<TILE>() + 2 * TILE * TILE + 2 * TILE +
              Tile<T, TILE>::kGroups * TILE * TILE);
}

// The two-kernel backward's gradient GEMM, grid (D tiles, row tiles, 2 x
// buckets: side = z & 1, bucket = z >> 1): out rows [out0, out0 + TR) x
// columns [d0, d0 + TD) of d_img (side 0: sum_k a0[k][r] y_k) or d_prof
// (side 1: sum_k a1[k][c] x_k), projected in the epilogue with the q line
// partials (B x tiles) and the norms (nx | ny, B each). a0, a1: per bucket
// N x NP f32 (NP = N rounded up to TR). Block (0, 0, 0) also writes
// d_scale = e sum of parts[0, n_parts) and, where kBias, d_bias = sum of
// parts[n_parts, 2 n_parts).
template <typename T, bool kBias>
__device__ __forceinline__ void grad_gemm(
    unsigned char* smem, const T* __restrict__ img,
    const T* __restrict__ prof, const float* __restrict__ logit_scale,
    const float* __restrict__ norms, const float* a0, const float* a1,
    const float* qr, const float* qc, const float* parts, int n_parts,
    T* __restrict__ d_img, T* __restrict__ d_prof, float* d_scale,
    float* d_bias, int buckets, int N, int NP, int D, int tiles, int vec) {
  constexpr int kBRow = TD * (int)sizeof(T);  // bytes of a staged row
  constexpr int kStage = KB * TR * 4 + KB * kBRow;
  const int side = blockIdx.z & 1, b = blockIdx.z >> 1;
  const int out0 = blockIdx.y * TR, d0 = blockIdx.x * TD;
  const size_t base = (size_t)b * N;
  const int B = buckets * N;
  const float* A = (side ? a1 : a0) + (size_t)b * N * NP + out0;
  const T* other = (side ? img : prof) + base * D;
  const T* own = (side ? prof : img) + base * D;
  const int tr = threadIdx.x / 32, td = threadIdx.x % 32;
  auto load = [&](int s, int k0) {
    unsigned char* st = smem + s * kStage;
    {  // A: KB rows of TR floats, one piece a thread
      const int k = threadIdx.x / (TR / 4), q = threadIdx.x % (TR / 4);
      const bool ok = k0 + k < N;
      cp_async16(st + k * TR * 4 + q * 16,
                 ok ? A + (size_t)(k0 + k) * NP + q * 4 : A, ok);
    }
    unsigned char* bs = st + KB * TR * 4;
    if (vec) {
      constexpr int kPer = 16 / (int)sizeof(T);
      constexpr int kPieces = TD / kPer;
      for (int p = threadIdx.x; p < KB * kPieces; p += kThreads) {
        const int k = p / kPieces, q = p % kPieces;
        const int col = d0 + q * kPer;
        const bool ok = k0 + k < N && col < D;
        cp_async16(bs + k * kBRow + q * 16,
                   ok ? other + (size_t)(k0 + k) * D + col : other, ok);
      }
    } else {
      for (int e = threadIdx.x; e < KB * TD; e += kThreads) {
        const int k = e / TD, q = e % TD;
        const int col = d0 + q;
        const bool ok = k0 + k < N && col < D;
        reinterpret_cast<T*>(bs + k * kBRow)[q] =
            ok ? other[(size_t)(k0 + k) * D + col] : from_f32<T>(0.f);
      }
    }
  };
  float acc[4][2] = {};
  const int chunks = (N + KB - 1) / KB;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s * KB);
    cp_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = k + kStages - 1;
    if (next < chunks) load(next % kStages, next * KB);
    cp_commit();
    const unsigned char* st = smem + (k % kStages) * kStage;
    const float* As = reinterpret_cast<const float*>(st);
    const unsigned char* bs = st + KB * TR * 4;
    // k rows past N are zeros in both operands
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const float4 a =
          reinterpret_cast<const float4*>(As + kk * TR)[tr];
      const float2 bv = pair(reinterpret_cast<const T*>(bs + kk * kBRow) +
                             2 * td);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
      }
    }
  }
  cp_wait<0>();
  const float* qp = side ? qc : qr;
  const float* nrm = norms + side * B + base;
  T* out = (side ? d_prof : d_img) + base * D;
  const int col = d0 + 2 * td;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = out0 + 4 * tr + i;
    if (o >= N) break;
    float qs = 0.f;
    for (int t = 0; t < tiles; ++t) qs += qp[(base + o) * tiles + t];
    const float inv = 1.f / nrm[o];
    const float qn = qs * inv;
    const T* v = own + (size_t)o * D + col;
    T* dst = out + (size_t)o * D + col;
    if (col < D) dst[0] = from_f32<T>((acc[i][0] - qn * to_f32(v[0])) * inv);
    if (col + 1 < D)
      dst[1] = from_f32<T>((acc[i][1] - qn * to_f32(v[1])) * inv);
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0) {
    float total = 0.f;
    for (int p = 0; p < n_parts; ++p) total += parts[p];
    d_scale[0] = total * expf(logit_scale[0]);
    if constexpr (kBias) {
      float tb = 0.f;
      for (int p = 0; p < n_parts; ++p) tb += parts[n_parts + p];
      d_bias[0] = tb;
    }
  }
}

// Shared memory of grad_gemm: its kStages ring of A and row stages.
template <typename T>
constexpr int grad_gemm_smem() {
  return kStages * (KB * TR * 4 + KB * TD * (int)sizeof(T));
}

template <typename T>
bool aligned(const void* img, const void* prof, int D) {
  return (D * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(prof) % 16 == 0;
}

// what every entry point refuses (the backward's also refuse tile 16 past
// one tile a bucket)
bool bad_args(int buckets, int N, int D, int tile) {
  return buckets < 1 || N < 1 || D < 1 || (tile != 16 && tile != 32);
}

}  // namespace
