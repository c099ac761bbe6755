// Fused transformer feed-forward, y = Dense(F->E)(drop(act(Dense(E->F)(x)))),
// and its backward, for Hopper (sm_90a). Plain C entry points, loaded with
// ctypes by ops/ffn.py:
//   ffn_fwd  replaces the TPU kernel
//     multimodal_plankton_recognition_tpu/ops/pallas/experimental/ffn.py
//     ::_fwd_kernel (kernel 9, reached through ffn_core / _ffn_fwd);
//   ffn_bwd  replaces ::_bwd_kernel (kernel 10, _ffn_bwd).
//
// Numerics, kept from the TPU kernels (ffn.py:101-172):
//   h_pre = bf16(x . w1 + b1)      bf16 operands, f32 accumulation, f32 b1
//   h     = bf16(act(h_pre))       tanh-GELU (flax nn.gelu) or ReLU, in f32
//   h     = bf16(h * keep / (1 - p))           train mode only (thr != 0)
//   y     = h . w2 + b2            f32 accumulation, cast once to x's type
// backward, dy rounded to bf16:
//   db2 = sum dy,  dw2 = h^T . dy,  dh = dy . w2^T (f32) * keep / (1 - p),
//   dpre = dh * act'(h_pre),  db1 = sum dpre,  dw1 = bf16(x)^T . bf16(dpre),
//   dx = bf16(dpre) . w1^T
// The dropout mask is a hash of (seed, row, hidden column) (dropout.cuh),
// regenerated in the backward; ops/ffn.py (ffn_dropout_bits) makes the same
// bits.
//
// What bounds it: products, not bytes. Per ViT-T layer at B = 256 (rows
// 50,432, E 192, F 768) the forward's two products are 29.7 GFLOP (30 us at
// the tensor cores' 989 TFLOP/s) against 39 MB of x and y (12 us at 3.35
// TB/s); the backward's five are 2.5 times that. So the products run on the
// tensor cores: warp-level bf16 WMMA 16x16x16 with f32 accumulators (no
// wgmma, TMA or cp.async yet).
//
// Design. x and the weights are flattened to rows: x (rows, E); w1 is
// passed transposed, w1t (F, E), and w2 is (F, E), both bf16 with F
// zero-padded by the wrapper to a multiple of 64 (hidden units of value 0
// and gradient 0). A block of 8 warps owns a tile of 64 rows and walks the
// hidden dimension in chunks of FC = 64 columns (32 for E > 192, for shared
// memory and registers):
//   forward (ffn_fwd_kernel): x tile in shared memory; per chunk, the w1t
//     and w2 rows of the chunk are staged, h_pre = x . w1c goes through
//     shared memory for the elementwise step, the bf16 hidden chunk stays in
//     shared memory and y += h . w2c accumulates in registers. The hidden
//     never reaches device memory.
//   backward, pass A (ffn_bwd_dx_kernel): the same walk with x and dy tiles,
//     recomputing h_pre and dh per chunk; dx += bf16(dpre) . w1c in
//     registers.
//   backward, pass B (ffn_bwd_w_kernel): the weight gradients are sums over
//     every row. The TPU kernel adds them into output blocks that persist
//     over its sequential grid; a CUDA grid runs in parallel, so here a
//     block owns one hidden chunk (its dw1 and dw2 rows stay in registers)
//     and one group of row tiles, recomputing h and dpre per tile; each
//     (group) writes a partial of dw1, dw2, db1 and db2, and
//     ffn_reduce_kernel adds the groups in index order. No float atomics,
//     so a run repeats bit for bit. The wrapper picks the groups so that
//     there are about two blocks per SM (partials: 26-28 MB at the
//     flagship's and the card's shapes).
//
// Each kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the entry points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "dropout.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int BM = 64;         // rows of a tile
constexpr int kPadH = 8;       // bf16 row padding (16 bytes: ldmatrix banks)
constexpr int kPadF = 4;       // f32 row padding (16 bytes)
constexpr float kC = 0.7978845608028654f;  // sqrt(2/pi)

template <int E>
struct Cfg {
  static_assert(E % 32 == 0 && E <= 384, "width must be a multiple of 32");
  static constexpr int FC = E <= 192 ? 64 : 32;  // hidden columns a chunk
  static constexpr int LDE = E + kPadH;   // bf16 row of width E
  static constexpr int LDC = FC + kPadH;  // bf16 row of a chunk
  static constexpr int LDS = FC + kPadF;  // f32 row of a chunk
  static constexpr int ET = E / 16;       // 16-wide tiles of E
  static constexpr int CT = FC / 16;      // 16-wide tiles of a chunk
  // warp w: row tile w % 4, column half w / 4
  static constexpr int CF = CT / 2;  // chunk fragments of a warp (64 x FC)
  static constexpr int YF = ET / 2;  // fragments of a warp in a 64 x E tile
  static constexpr int NW = CT * ET / kWarps;  // of a warp in an FC x E tile
  static_assert(NW * kWarps == CT * ET, "FC x E tiles must split over warps");
  // shared memory (bytes, each a multiple of 128)
  static constexpr size_t kTile = (size_t)BM * LDE * 2;  // x or dy
  static constexpr size_t kW = (size_t)FC * LDE * 2;     // a weight chunk
  static constexpr size_t kS = (size_t)BM * LDS * 4;     // f32 chunk
  static constexpr size_t kH = (size_t)BM * LDC * 2;     // bf16 chunk
  static constexpr size_t kFwd = kTile + 2 * kW + kS + kH;
  static constexpr size_t kBwd = 2 * kTile + 2 * kW + 2 * kS + 2 * kH;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    ARow;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    ACol;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BCol;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float act(float z, bool relu) {
  if (relu) return fmaxf(z, 0.f);
  const float u = kC * (z + 0.044715f * z * z * z);
  return 0.5f * z * (1.f + tanhf(u));
}

__device__ __forceinline__ float dact(float z, bool relu) {
  if (relu) return z > 0.f ? 1.f : 0.f;
  const float u = kC * (z + 0.044715f * z * z * z);
  const float t = tanhf(u);
  return 0.5f * (1.f + t) +
         0.5f * z * (1.f - t * t) * kC * (1.f + 0.134145f * z * z);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 consecutive elements as 8 bf16
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                    pack2(b.z, b.w));
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// n rows of width E (rows >= valid are zero) into shared memory as bf16
template <int E, typename T>
__device__ __forceinline__ void load_rows(bf16* dst, const T* src, int row0,
                                          int valid, int n) {
  constexpr int V = E / 8;
  for (int i = threadIdx.x; i < n * V; i += kThreads) {
    const int r = i / V, c = i - r * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid) v = load8(src + (size_t)(row0 + r) * E + c * 8);
    *reinterpret_cast<uint4*>(dst + r * Cfg<E>::LDE + c * 8) = v;
  }
}

// S (64 x FC, f32) = A (64 x E tile) . W^T, W the chunk's FC rows of width E
template <int E>
__device__ __forceinline__ void chunk_product(const bf16* A, const bf16* W,
                                              float* S, int warp) {
  using C = Cfg<E>;
  const int mt = warp & 3, nt0 = (warp >> 2) * C::CF;
  Acc acc[C::CF];
#pragma unroll
  for (int c = 0; c < C::CF; ++c) wmma::fill_fragment(acc[c], 0.f);
#pragma unroll 4
  for (int kt = 0; kt < C::ET; ++kt) {
    ARow a;
    wmma::load_matrix_sync(a, A + mt * 16 * C::LDE + kt * 16, C::LDE);
#pragma unroll
    for (int c = 0; c < C::CF; ++c) {
      BCol b;
      wmma::load_matrix_sync(b, W + (nt0 + c) * 16 * C::LDE + kt * 16,
                             C::LDE);
      wmma::mma_sync(acc[c], a, b, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < C::CF; ++c)
    wmma::store_matrix_sync(S + mt * 16 * C::LDS + (nt0 + c) * 16, acc[c],
                            C::LDS, wmma::mem_row_major);
}

// acc (the warp's fragments of a 64 x E tile) += H (64 x FC) . W (FC x E)
template <int E>
__device__ __forceinline__ void wide_product(Acc (&acc)[Cfg<E>::YF],
                                             const bf16* H, const bf16* W,
                                             int warp) {
  using C = Cfg<E>;
  const int mt = warp & 3, nt0 = (warp >> 2) * C::YF;
#pragma unroll
  for (int kt = 0; kt < C::CT; ++kt) {
    ARow a;
    wmma::load_matrix_sync(a, H + mt * 16 * C::LDC + kt * 16, C::LDC);
#pragma unroll
    for (int j = 0; j < C::YF; ++j) {
      BRow b;
      wmma::load_matrix_sync(b, W + kt * 16 * C::LDE + (nt0 + j) * 16,
                             C::LDE);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// acc (the warp's fragments of an FC x E tile) += P^T (FC x 64) . X (64 x E)
template <int E>
__device__ __forceinline__ void weight_product(Acc (&acc)[Cfg<E>::NW],
                                               const bf16* P, const bf16* X,
                                               int warp) {
  using C = Cfg<E>;
#pragma unroll
  for (int kt = 0; kt < BM / 16; ++kt) {
#pragma unroll
    for (int j = 0; j < C::NW; ++j) {
      const int t = j * kWarps + warp;
      const int mt = t / C::ET, nt = t - mt * C::ET;
      ACol a;
      wmma::load_matrix_sync(a, P + kt * 16 * C::LDC + mt * 16, C::LDC);
      BRow b;
      wmma::load_matrix_sync(b, X + kt * 16 * C::LDE + nt * 16, C::LDE);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// the warp's fragments of a 64 x E tile (+ bias) to rows row0.. of out,
// through a 16 x 16 f32 staging tile of the warp
template <int E, typename T>
__device__ __forceinline__ void store_tile(Acc (&acc)[Cfg<E>::YF],
                                           float* stage, T* out,
                                           const float* bias, int row0,
                                           int rows, int warp, int lane) {
  using C = Cfg<E>;
  const int mt = warp & 3, nt0 = (warp >> 2) * C::YF;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  const int row = row0 + mt * 16 + r;
#pragma unroll
  for (int j = 0; j < C::YF; ++j) {
    wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (row < rows) {
      const int col = (nt0 + j) * 16 + c0;
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = stage[r * 16 + c0 + q] + (bias ? bias[col + q] : 0.f);
      store8(out + (size_t)row * E + col, v);
    }
    __syncwarp();
  }
}

struct Drop {
  uint32_t seed, thr;
  float inv_keep;
  // keep the hidden unit (row, col)?
  __device__ __forceinline__ bool keep(int row, int col) const {
    return dropout_bits(dropout_key(seed, (uint32_t)row), (uint32_t)col) >=
           thr;
  }
};

template <int E, typename T>
__global__ void __launch_bounds__(kThreads)
ffn_fwd_kernel(const T* __restrict__ x, const bf16* __restrict__ w1t,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ y, int rows,
               int F, bool relu, Drop drop) {
  using C = Cfg<E>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* W1c = reinterpret_cast<bf16*>(smem + C::kTile);
  bf16* W2c = reinterpret_cast<bf16*>(smem + C::kTile + C::kW);
  float* S = reinterpret_cast<float*>(smem + C::kTile + 2 * C::kW);
  bf16* H = reinterpret_cast<bf16*>(smem + C::kTile + 2 * C::kW + C::kS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;

  load_rows<E>(X, x, row0, rows, BM);
  Acc acc[C::YF];
#pragma unroll
  for (int j = 0; j < C::YF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int f0 = 0; f0 < F; f0 += C::FC) {
    __syncthreads();  // the previous chunk is done with W1c, W2c and H
    load_rows<E>(W1c, w1t + (size_t)f0 * E, 0, C::FC, C::FC);
    load_rows<E>(W2c, w2 + (size_t)f0 * E, 0, C::FC, C::FC);
    __syncthreads();
    chunk_product<E>(X, W1c, S, warp);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * C::FC; i += kThreads) {
      const int r = i / C::FC, c = i - r * C::FC;
      const float hp = round_bf16(S[r * C::LDS + c] + b1[f0 + c]);
      float h = round_bf16(act(hp, relu));
      if (drop.thr)
        h = drop.keep(row0 + r, f0 + c) ? round_bf16(h * drop.inv_keep) : 0.f;
      H[r * C::LDC + c] = __float2bfloat16_rn(h);
    }
    __syncthreads();
    wide_product<E>(acc, H, W2c, warp);
  }
  __syncthreads();
  store_tile<E>(acc, S + warp * 256, y, b2, row0, rows, warp, lane);
}

// the elementwise backward step of one (64-row tile, chunk): from h_pre in
// Sh and dh in Sd, bf16(dpre) to dP, dpre (f32) to Sd and, when H is given,
// the dropped bf16 hidden to H
template <int E>
__device__ __forceinline__ void backward_step(const float* Sh, float* Sd,
                                              bf16* dP, bf16* H,
                                              const float* b1, int row0,
                                              int f0, bool relu, Drop drop) {
  using C = Cfg<E>;
  for (int i = threadIdx.x; i < BM * C::FC; i += kThreads) {
    const int r = i / C::FC, c = i - r * C::FC;
    const float hp = round_bf16(Sh[r * C::LDS + c] + b1[f0 + c]);
    float dh = Sd[r * C::LDS + c];
    float h = H ? round_bf16(act(hp, relu)) : 0.f;
    if (drop.thr) {
      const bool keep = drop.keep(row0 + r, f0 + c);
      dh = keep ? dh * drop.inv_keep : 0.f;
      h = keep ? round_bf16(h * drop.inv_keep) : 0.f;
    }
    const float dpre = dh * dact(hp, relu);
    dP[r * C::LDC + c] = __float2bfloat16_rn(dpre);
    Sd[r * C::LDS + c] = dpre;
    if (H) H[r * C::LDC + c] = __float2bfloat16_rn(h);
  }
}

template <int E>
struct BwdSmem {
  using C = Cfg<E>;
  bf16 *X, *dY, *W1c, *W2c, *dP, *H;
  float *Sh, *Sd;
  __device__ explicit BwdSmem(unsigned char* smem) {
    X = reinterpret_cast<bf16*>(smem);
    dY = reinterpret_cast<bf16*>(smem + C::kTile);
    W1c = reinterpret_cast<bf16*>(smem + 2 * C::kTile);
    W2c = reinterpret_cast<bf16*>(smem + 2 * C::kTile + C::kW);
    Sh = reinterpret_cast<float*>(smem + 2 * C::kTile + 2 * C::kW);
    Sd = reinterpret_cast<float*>(smem + 2 * C::kTile + 2 * C::kW + C::kS);
    dP = reinterpret_cast<bf16*>(smem + 2 * C::kTile + 2 * C::kW +
                                 2 * C::kS);
    H = reinterpret_cast<bf16*>(smem + 2 * C::kTile + 2 * C::kW +
                                2 * C::kS + C::kH);
  }
};

// pass A: dx for one 64-row tile
template <int E, typename T>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_dx_kernel(const T* __restrict__ x, const bf16* __restrict__ w1t,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const T* __restrict__ dy, T* __restrict__ dx, int rows,
                  int F, bool relu, Drop drop) {
  using C = Cfg<E>;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<E> s(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * BM;

  load_rows<E>(s.X, x, row0, rows, BM);
  load_rows<E>(s.dY, dy, row0, rows, BM);
  Acc acc[C::YF];
#pragma unroll
  for (int j = 0; j < C::YF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int f0 = 0; f0 < F; f0 += C::FC) {
    __syncthreads();
    load_rows<E>(s.W1c, w1t + (size_t)f0 * E, 0, C::FC, C::FC);
    load_rows<E>(s.W2c, w2 + (size_t)f0 * E, 0, C::FC, C::FC);
    __syncthreads();
    chunk_product<E>(s.X, s.W1c, s.Sh, warp);
    chunk_product<E>(s.dY, s.W2c, s.Sd, warp);
    __syncthreads();
    backward_step<E>(s.Sh, s.Sd, s.dP, nullptr, b1, row0, f0, relu, drop);
    __syncthreads();
    wide_product<E>(acc, s.dP, s.W1c, warp);
  }
  __syncthreads();
  store_tile<E>(acc, s.Sh + warp * 256, dx, nullptr, row0, rows, warp, lane);
}

// pass B: one hidden chunk (blockIdx.x) over one group of row tiles
// (blockIdx.y); writes the group's partial dw1t, dw2, db1 (and db2 from
// chunk 0) at part + group * (2 F E + F + E)
template <int E, typename T>
__global__ void __launch_bounds__(kThreads)
ffn_bwd_w_kernel(const T* __restrict__ x, const bf16* __restrict__ w1t,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const T* __restrict__ dy, float* __restrict__ part,
                 int rows, int F, bool relu, Drop drop) {
  using C = Cfg<E>;
  constexpr int kE = (E + kThreads - 1) / kThreads;  // db2 columns a thread
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdSmem<E> s(smem);
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.x * C::FC;
  const int tiles = (rows + BM - 1) / BM;
  const int t0 = (int)((long long)blockIdx.y * tiles / gridDim.y);
  const int t1 = (int)((long long)(blockIdx.y + 1) * tiles / gridDim.y);

  load_rows<E>(s.W1c, w1t + (size_t)f0 * E, 0, C::FC, C::FC);
  load_rows<E>(s.W2c, w2 + (size_t)f0 * E, 0, C::FC, C::FC);
  Acc dw1[C::NW], dw2[C::NW];
#pragma unroll
  for (int j = 0; j < C::NW; ++j) {
    wmma::fill_fragment(dw1[j], 0.f);
    wmma::fill_fragment(dw2[j], 0.f);
  }
  float db1 = 0.f;
  float db2[kE] = {};

  for (int t = t0; t < t1; ++t) {
    const int row0 = t * BM;
    __syncthreads();  // the previous tile is done with X, dY, dP and H
    load_rows<E>(s.X, x, row0, rows, BM);
    load_rows<E>(s.dY, dy, row0, rows, BM);
    __syncthreads();
    chunk_product<E>(s.X, s.W1c, s.Sh, warp);
    chunk_product<E>(s.dY, s.W2c, s.Sd, warp);
    __syncthreads();
    backward_step<E>(s.Sh, s.Sd, s.dP, s.H, b1, row0, f0, relu, drop);
    __syncthreads();
    // column sums in row order: rows past the end hold dy = 0, so dh = 0
    if (threadIdx.x < C::FC)
      for (int r = 0; r < BM; ++r) db1 += s.Sd[r * C::LDS + threadIdx.x];
    if (blockIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int e = threadIdx.x + k * kThreads;
        if (e < E)
          for (int r = 0; r < BM; ++r)
            db2[k] += __bfloat162float(s.dY[r * C::LDE + e]);
      }
    }
    weight_product<E>(dw1, s.dP, s.X, warp);
    weight_product<E>(dw2, s.H, s.dY, warp);
  }

  float* out = part + (size_t)blockIdx.y * (2 * (size_t)F * E + F + E);
#pragma unroll
  for (int j = 0; j < C::NW; ++j) {
    const int t = j * kWarps + warp;
    const int mt = t / C::ET, nt = t - mt * C::ET;
    const size_t at = (size_t)(f0 + mt * 16) * E + nt * 16;
    wmma::store_matrix_sync(out + at, dw1[j], E, wmma::mem_row_major);
    wmma::store_matrix_sync(out + (size_t)F * E + at, dw2[j], E,
                            wmma::mem_row_major);
  }
  if (threadIdx.x < C::FC) out[2 * (size_t)F * E + f0 + threadIdx.x] = db1;
  if (blockIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kE; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < E) out[2 * (size_t)F * E + F + e] = db2[k];
    }
  }
}

// out[i] = sum over groups g, in order, of part[g * n + i]; out is dw1t,
// dw2, db1, db2 back to back (n = 2 F E + F + E)
__global__ void ffn_reduce_kernel(const float* __restrict__ part, int groups,
                                  size_t n, float* __restrict__ dw1t,
                                  float* __restrict__ dw2,
                                  float* __restrict__ db1,
                                  float* __restrict__ db2, size_t fe, int F) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += part[(size_t)g * n + i];
    if (i < fe)
      dw1t[i] = acc;
    else if (i < 2 * fe)
      dw2[i - fe] = acc;
    else if (i < 2 * fe + F)
      db1[i - 2 * fe] = acc;
    else
      db2[i - 2 * fe - F] = acc;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int E, typename T>
int launch_fwd(const void* x, const void* w1t, const void* b1, const void* w2,
               const void* b2, void* y, int rows, int F, bool relu, Drop drop,
               cudaStream_t stream) {
  using C = Cfg<E>;
  cudaError_t err = set_smem(ffn_fwd_kernel<E, T>, C::kFwd);
  if (err != cudaSuccess) return (int)err;
  ffn_fwd_kernel<E, T><<<(rows + BM - 1) / BM, kThreads, C::kFwd, stream>>>(
      static_cast<const T*>(x), static_cast<const bf16*>(w1t),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(y), rows, F, relu, drop);
  return (int)cudaGetLastError();
}

template <int E, typename T>
int launch_bwd(const void* x, const void* w1t, const void* b1, const void* w2,
               const void* dy, void* dx, void* dw1t, void* db1, void* dw2,
               void* db2, void* scratch, int groups, int rows, int F,
               bool relu, Drop drop, cudaStream_t stream) {
  using C = Cfg<E>;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const bf16* w1b = static_cast<const bf16*>(w1t);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const float* b1f = static_cast<const float*>(b1);
  float* part = static_cast<float*>(scratch);
  cudaError_t err = set_smem(ffn_bwd_dx_kernel<E, T>, C::kBwd);
  if (err == cudaSuccess) err = set_smem(ffn_bwd_w_kernel<E, T>, C::kBwd);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_dx_kernel<E, T><<<(rows + BM - 1) / BM, kThreads, C::kBwd,
                            stream>>>(xt, w1b, b1f, w2b, dyt,
                                      static_cast<T*>(dx), rows, F, relu,
                                      drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_w_kernel<E, T><<<dim3(F / C::FC, groups), kThreads, C::kBwd,
                           stream>>>(xt, w1b, b1f, w2b, dyt, part, rows, F,
                                     relu, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t fe = (size_t)F * E, n = 2 * fe + F + E;
  ffn_reduce_kernel<<<(int)((n + 255) / 256), 256, 0, stream>>>(
      part, groups, n, static_cast<float*>(dw1t), static_cast<float*>(dw2),
      static_cast<float*>(db1), static_cast<float*>(db2), fe, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (rows, E), bf16 (x_f32 = 0) or f32; w1t and w2: (F, E) bf16 (w1
// transposed), F a multiple of 64; b1 (F,) and b2 (E,) f32. All contiguous,
// 16-byte aligned. Dropout: keep a hidden unit when its hash bits are >= thr
// (thr = 0: eval mode), scale kept ones by inv_keep. Returns a cudaError_t
// code (0 = launched).
int ffn_fwd(const void* x, const void* w1t, const void* b1, const void* w2,
            const void* b2, void* y, int rows, int E, int F, int relu,
            int x_f32, unsigned seed, unsigned thr, float inv_keep,
            void* stream) {
  if (F % 64 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Drop drop{seed, thr, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FWD(W)                                                              \
  (x_f32 ? launch_fwd<W, float>(x, w1t, b1, w2, b2, y, rows, F, relu, drop, \
                                s)                                          \
         : launch_fwd<W, bf16>(x, w1t, b1, w2, b2, y, rows, F, relu, drop, s))
  switch (E) {
    case 64: return FWD(64);
    case 128: return FWD(128);
    case 192: return FWD(192);
    case 384: return FWD(384);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD
}

// dy, dx: (rows, E) of x's type; dw1t, dw2: (F, E) f32; db1 (F,), db2 (E,)
// f32; scratch: groups * (2 F E + F + E) f32, 1 <= groups <= ceil(rows /
// 64). The rest as in ffn_fwd.
int ffn_bwd(const void* x, const void* w1t, const void* b1, const void* w2,
            const void* b2, const void* dy, void* dx, void* dw1t, void* db1,
            void* dw2, void* db2, void* scratch, int groups, int rows, int E,
            int F, int relu, int x_f32, unsigned seed, unsigned thr,
            float inv_keep, void* stream) {
  (void)b2;  // y's bias has no part in the backward
  if (F % 64 || rows <= 0 || groups < 1 || groups > (rows + BM - 1) / BM)
    return (int)cudaErrorInvalidValue;
  const Drop drop{seed, thr, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(W)                                                             \
  (x_f32 ? launch_bwd<W, float>(x, w1t, b1, w2, dy, dx, dw1t, db1, dw2,    \
                                db2, scratch, groups, rows, F, relu, drop, \
                                s)                                         \
         : launch_bwd<W, bf16>(x, w1t, b1, w2, dy, dx, dw1t, db1, dw2, db2, \
                               scratch, groups, rows, F, relu, drop, s))
  switch (E) {
    case 64: return BWD(64);
    case 128: return BWD(128);
    case 192: return BWD(192);
    case 384: return BWD(384);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
