// Fused transformer feed-forward, y = Dense(F->E)(drop(act(Dense(E->F)(x)))),
// and its backward, for Hopper (sm_90a). Plain C entry points, loaded with
// ctypes by ops/ffn.py:
//   ffn_fwd  replaces the TPU kernel
//     multimodal_plankton_recognition_tpu/ops/pallas/experimental/ffn.py
//     ::_fwd_kernel (kernel 9, reached through ffn_core / _ffn_fwd);
//   ffn_bwd  replaces ::_bwd_kernel (kernel 10, _ffn_bwd).
//
// Numerics, kept from the TPU kernels (ffn.py:101-185):
//   h_pre = bf16(x . w1 + b1)      bf16 operands, f32 accumulation, f32 b1
//   h     = bf16(act(h_pre))       tanh-GELU (flax nn.gelu) or ReLU, in f32
//   h     = bf16(h * keep / (1 - p))           train mode only (thr != 0)
//   y     = h . w2 + b2            f32 accumulation, cast once to x's type
// backward, x and dy rounded to bf16 (the wrapper rounds an f32 x once):
//   db2 = sum dy,  dw2 = h^T . dy,  dh = dy . w2^T (f32) * keep / (1 - p),
//   dpre = dh * act'(h_pre) (f32),  db1 = sum dpre (f32),
//   dw1 = x^T . bf16(dpre),  dx = bf16(dpre) . w1^T, accumulated in f32
//   and cast once to x's type
// The dropout mask is a hash of (seed, row, hidden column) (dropout.cuh),
// regenerated in the backward; ops/ffn.py (ffn_dropout_bits) makes the same
// bits.
//
// What bounds it: products, not bytes. Per ViT-T layer at B = 256 (rows
// 50,432, E 192, F 768) the forward's two products are 29.7 GFLOP (30 us at
// the tensor cores' 989 TFLOP/s) against 39 MB of x and y (12 us at 3.35
// TB/s); the backward's five are 2.5 times that.
//
// Design. x and the weights are flattened to rows: x (rows, E); w1 is
// passed transposed, w1t (F, E), and w2 is (F, E), both bf16 with F
// zero-padded by the wrapper to a multiple of 64 (hidden units of value 0
// and gradient 0).
//   forward (ffn_fwd_kernel): a block of 8 warps owns a tile of 64 rows
//     and walks the hidden dimension in chunks of FC = 64 columns (32 for
//     E > 192): x tile in shared memory; per chunk, the w1t and w2 rows of
//     the chunk are staged, h_pre = x . w1c goes through shared memory for
//     the elementwise step, the bf16 hidden chunk stays in shared memory
//     and y += h . w2c accumulates in registers (bf16 WMMA 16x16x16). The
//     hidden never reaches device memory.
//   backward: five products, not seven, on wgmma.
//     ffn_bwd_rows_kernel, persistent over 64-row tiles: the x and dy
//       tiles are resident in shared memory (TMA, double-buffered for
//       E <= 192); a producer warp streams the w2 and w1t rows of each
//       64-column hidden chunk through a ring of TMA slots. Per chunk, each
//       of two consumer warpgroups computes dh = dy . w2c^T and h_pre =
//       x . w1c^T for its 32 hidden columns (wgmma m64n32k16, f32 in
//       registers), runs the elementwise step in registers, writes bf16
//       dpre and the dropped bf16 h into a swizzled staging tile (which TMA
//       stores to scratch for the weight gradients) and the chunk's f32
//       column sums of dpre (the db1 partials; per tile, also those of
//       dy, db2's); then dx += bf16(dpre) . w1c (m64n64k16, the dpre tile
//       as A, w1c read N-major from the same slot) accumulates over every
//       chunk in registers, the warpgroups owning alternate 64-column
//       boxes of dx.
//     dw1t = bf16(dpre)^T . x and dw2 = h^T . dy run on the shared
//       weight-gradient GEMM (hopper_gemm.cuh wgrad_kernel: per-group f32
//       partials added in index order); colsum_kernel adds the per-tile
//       db1 and db2 partials in a fixed order. db1 sums the f32 dpre, as
//       the TPU kernel does, never the stored bf16 one. No float atomics,
//       so a run repeats bit for bit.
//
// Each kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the entry points return a cudaError_t code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "dropout.cuh"
#include "hopper_gemm.cuh"

using namespace nvcuda;

namespace {

using namespace hg;  // bf16, pack2 and the Hopper GEMM

constexpr int kThreads = 256;  // 8 warps
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
  // shared memory (bytes, each a multiple of 128)
  static constexpr size_t kTile = (size_t)BM * LDE * 2;  // x or dy
  static constexpr size_t kW = (size_t)FC * LDE * 2;     // a weight chunk
  static constexpr size_t kS = (size_t)BM * LDS * 4;     // f32 chunk
  static constexpr size_t kH = (size_t)BM * LDC * 2;     // bf16 chunk
  static constexpr size_t kFwd = kTile + 2 * kW + kS + kH;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    ARow;
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

// act(z) as act computes it, and act'(z), with one tanh
__device__ __forceinline__ void act_pair(float z, bool relu, float& a,
                                         float& da) {
  if (relu) {
    a = fmaxf(z, 0.f);
    da = z > 0.f ? 1.f : 0.f;
    return;
  }
  const float u = kC * (z + 0.044715f * z * z * z);
  const float t = tanhf(u);
  a = 0.5f * z * (1.f + t);
  da = 0.5f * (1.f + t) +
       0.5f * z * (1.f - t * t) * kC * (1.f + 0.134145f * z * z);
}

// 2 consumer warpgroups and a producer warpgroup (one thread of which
// issues the loads): whole warpgroups, so that setmaxnreg can move the
// producer's registers to the consumers
constexpr int kRowThreads = 3 * 128;
constexpr int kMaxSlots = 6;               // weight slots: 3 chunks ahead

// shared memory of the row kernel, bytes from a 1024-byte boundary: tbuf
// x and dy tiles (E / 64 boxes each), nslot weight slots (E / 64 boxes of
// 64 hidden rows), the dpre and h staging boxes, the column-sum exchange
// (2 parities x 2 warpgroups x 4 warps x 32 floats), the mbarriers
struct RowSmem {
  int eb, tbuf, nslot;
  __host__ __device__ uint32_t slots() const {
    return (uint32_t)tbuf * 2 * eb * kBox;
  }
  __host__ __device__ uint32_t staging() const {
    return slots() + (uint32_t)nslot * eb * kBox;
  }
  __host__ __device__ uint32_t red() const { return staging() + 2 * kBox; }
  __host__ __device__ uint32_t bars() const {
    return red() + 2 * 2 * 4 * 32 * 4;
  }
  __host__ __device__ uint32_t bytes() const {
    return bars() + 8 * (2 * tbuf + 2 * nslot) + 1024;  // + alignment slack
  }
};

// The rows of the backward: dx, bf16(dpre) and the dropped bf16 h of every
// row, and the per-tile column sums of dpre and dy (colpart: tiles x (Fp +
// E) f32). x_map, dy_map: (rows, E) bf16, boxes of 64 x 64; w1_map,
// w2_map: w1t and w2 (Fp, E) bf16, boxes of 64 x 64; dp_map, h_map:
// (rows, Fp) bf16 scratch, boxes of 64 x 64. Block b owns the row tiles b,
// b + gridDim.x, ...
template <int E, typename TO>
__global__ void __launch_bounds__(kRowThreads, 1)
    ffn_bwd_rows_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap dy_map,
                        const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const __grid_constant__ CUtensorMap dp_map,
                        const __grid_constant__ CUtensorMap h_map,
                        const float* __restrict__ b1,
                        float* __restrict__ colpart, TO* __restrict__ dx,
                        int rows, int Fp, bool relu, Drop drop, int tbuf,
                        int nslot) {
  constexpr int EB = E / 64;         // 64-column boxes of a row of width E
  constexpr int NDX = (EB + 1) / 2;  // dx boxes of a warpgroup, at most
  static_assert(E % 64 == 0 && E <= 384, "width must be 64, 128, 192, 384");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const RowSmem L{EB, tbuf, nslot};
  const uint32_t slot0 = base + L.slots(), dp_s = base + L.staging();
  const uint32_t h_s = dp_s + kBox;
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw) + L.red());
  const uint32_t tile_full = base + L.bars();
  const uint32_t tile_empty = tile_full + 8 * tbuf;
  const uint32_t slot_full = tile_empty + 8 * tbuf;
  const uint32_t slot_empty = slot_full + 8 * nslot;
  const int tiles = (rows + 63) / 64, chunks = Fp / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto x_s = [&](int buf) { return base + (uint32_t)buf * 2 * EB * kBox; };
  auto dy_s = [&](int buf) { return x_s(buf) + EB * kBox; };
  auto slot_s = [&](int s) { return slot0 + (uint32_t)s * EB * kBox; };

  if (threadIdx.x == 0) {
    for (int b = 0; b < tbuf; ++b) {
      mbar_init(tile_full + 8 * b, 1);
      mbar_init(tile_empty + 8 * b, 8);  // each consumer warp
    }
    for (int s = 0; s < nslot; ++s) {
      mbar_init(slot_full + 8 * s, 1);
      mbar_init(slot_empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int it = 0, li = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++li) {
        const int buf = li % tbuf;
        mbar_wait(tile_empty + 8 * buf, ((li / tbuf) & 1) ^ 1);
        mbar_expect_tx(tile_full + 8 * buf, 2 * EB * kBox);
#pragma unroll
        for (int kb = 0; kb < EB; ++kb) {
          tma_load(x_s(buf) + kb * kBox, &x_map, tile_full + 8 * buf,
                   kb * 64, t * 64);
          tma_load(dy_s(buf) + kb * kBox, &dy_map, tile_full + 8 * buf,
                   kb * 64, t * 64);
        }
        for (int c = 0; c < chunks; ++c) {
          for (int w = 0; w < 2; ++w, ++it) {  // w2 rows, then w1t rows
            const int s = it % nslot;
            mbar_wait(slot_empty + 8 * s, ((it / nslot) & 1) ^ 1);
            mbar_expect_tx(slot_full + 8 * s, EB * kBox);
#pragma unroll
            for (int kb = 0; kb < EB; ++kb)
              tma_load(slot_s(s) + kb * kBox, w ? &w1_map : &w2_map,
                       slot_full + 8 * s, kb * 64, c * 64);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // the consumers: warpgroup wg computes hidden columns [32 wg, 32 wg + 32)
  // of each chunk and the dx boxes wg, wg + 2, ...; thread t holds rows r,
  // r + 8 and columns 8 i + cq (+ 1) of each wgmma tile
  const int wg = warp >> 2, tid = threadIdx.x;
  const int r = (warp & 3) * 16 + (lane >> 2), cq = (lane & 3) * 2;
  uint8_t* dp_gen = smem_raw + (dp_s - raw);
  uint8_t* h_gen = smem_raw + (h_s - raw);
  const size_t cstride = (size_t)Fp + E;
  int it = 0, li = 0, nc = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++li) {
    const int buf = li % tbuf;
    mbar_wait(tile_full + 8 * buf, (li / tbuf) & 1);
    // db2's partial: the tile's column sums of dy, rows in order (rows
    // past the end are TMA's zeros)
    for (int col = tid; col < E; col += 256) {
      const uint8_t* d = smem_raw + (dy_s(buf) - raw) + (col / 64) * kBox;
      float s = 0.f;
      for (int rr = 0; rr < 64; ++rr)
        s += __bfloat162float(
            *reinterpret_cast<const bf16*>(d + swz(rr, col & 63)));
      colpart[(size_t)t * cstride + Fp + col] = s;
    }
    float dxa[NDX][32];
#pragma unroll
    for (int j = 0; j < NDX; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dxa[j][i] = 0.f;
    fence_acc(dxa);

    for (int c = 0; c < chunks; ++c, it += 2, ++nc) {
      const int s2 = it % nslot, s1 = (it + 1) % nslot;
      float dh[16], hp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) dh[i] = hp[i] = 0.f;
      fence_regs(dh);
      fence_regs(hp);
      mbar_wait(slot_full + 8 * s2, (it / nslot) & 1);
      mbar_wait(slot_full + 8 * s1, ((it + 1) / nslot) & 1);
      // dh = dy . w2c^T and h_pre = x . w1c^T, interleaved: two independent
      // accumulator chains keep the tensor pipe fed
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < EB; ++kb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t w = kb * kBox + wg * 32 * 128 + kk * 32;
          wgmma32<0, 0>(dh, desc_k(dy_s(buf) + kb * kBox + kk * 32),
                        desc_k(slot_s(s2) + w));
          wgmma32<0, 0>(hp, desc_k(x_s(buf) + kb * kBox + kk * 32),
                        desc_k(slot_s(s1) + w));
        }
      wgmma_commit();
      wgmma_wait();
      fence_regs(dh);
      fence_regs(hp);
      if (lane == 0) {
        mbar_arrive(slot_empty + 8 * s2);  // w2's rows are done
        if (c == chunks - 1) mbar_arrive(tile_empty + 8 * buf);
      }

      // the elementwise step: hp becomes the dropped h, dh becomes dpre
      const int f0 = c * 64 + wg * 32;
      float cs[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = f0 + 8 * i + cq + e;
          const float bb = b1[col];
          cs[2 * i + e] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = 4 * i + 2 * h + e;
            const float z = round_bf16(hp[k] + bb);
            float a, da;
            act_pair(z, relu, a, da);
            float hv = round_bf16(a), d = dh[k];
            if (drop.thr) {
              const bool keep = drop.keep(t * 64 + r + 8 * h, col);
              d = keep ? d * drop.inv_keep : 0.f;
              hv = keep ? round_bf16(hv * drop.inv_keep) : 0.f;
            }
            hp[k] = hv;
            dh[k] = d * da;
            cs[2 * i + e] += dh[k];
          }
        }
      // column sums over the warp's 16 rows, in a fixed order
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          cs[q] += __shfl_xor_sync(0xffffffffu, cs[q], o);

      if (tid == 0) bulk_wait_read();  // the last chunk's stores left staging
      bar_sync(1, 256);
      float* rd = red + (((nc & 1) * 2 + wg) * 4 + (warp & 3)) * 32;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t o = swz(r + 8 * h, wg * 32 + 8 * i + cq);
          *reinterpret_cast<uint32_t*>(dp_gen + o) =
              pack2(dh[4 * i + 2 * h], dh[4 * i + 2 * h + 1]);
          *reinterpret_cast<uint32_t*>(h_gen + o) =
              pack2(hp[4 * i + 2 * h], hp[4 * i + 2 * h + 1]);
        }
        if (lane < 4) {
          rd[8 * i + cq] = cs[2 * i];
          rd[8 * i + cq + 1] = cs[2 * i + 1];
        }
      }
      fence_async_smem();
      bar_sync(1, 256);
      if (tid == 0) {
        tma_store(&dp_map, dp_s, c * 64, t * 64);
        tma_store(&h_map, h_s, c * 64, t * 64);
        bulk_commit();
      }
      if ((warp & 3) == 0) {  // db1's partial: the 4 warps' sums in order
        const float* rw = red + ((nc & 1) * 2 + wg) * 4 * 32;
        colpart[(size_t)t * cstride + f0 + lane] =
            ((rw[lane] + rw[32 + lane]) + rw[64 + lane]) + rw[96 + lane];
      }

      // dx += bf16(dpre) (64 x 64) . w1c (64 x E), this warpgroup's boxes
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_k(dp_s + kk * 32);
#pragma unroll
        for (int j = 0; j < NDX; ++j)
          if (2 * j + wg < EB)
            wgmma64<0, 1>(dxa[j], da,
                          desc_mn(slot_s(s1) + (2 * j + wg) * kBox +
                                  kk * 2048));
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(dxa);
      if (lane == 0) mbar_arrive(slot_empty + 8 * s1);  // w1t's rows are done
    }

    // dx, cast once to x's type
#pragma unroll
    for (int j = 0; j < NDX; ++j) {
      if (2 * j + wg >= EB) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = (2 * j + wg) * 64 + 8 * i + cq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = t * 64 + r + 8 * h;
          if (row >= rows) continue;
          const float v0 = dxa[j][4 * i + 2 * h];
          const float v1 = dxa[j][4 * i + 2 * h + 1];
          if constexpr (sizeof(TO) == 4)
            *reinterpret_cast<float2*>(dx + (size_t)row * E + col) =
                make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(dx + (size_t)row * E + col) =
                pack2(v0, v1);
        }
      }
    }
  }
  if (tid == 0) bulk_wait();
}

// out[c] (c < Fp: db1, else db2[c - Fp]) = the sum over tiles, in a fixed
// order, of part[t * (Fp + E) + c]. Block: 32 columns x 32 lanes; lane l
// adds tiles l, l + 32, ..., then lane 0 the 32 lanes in order.
__global__ void __launch_bounds__(1024)
    colsum_kernel(const float* __restrict__ part, int tiles, int Fp, int E,
                  float* __restrict__ db1, float* __restrict__ db2) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x % 32, l = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx, n = Fp + E;
  float acc = 0.f;
  if (c < n)
    for (int t = l; t < tiles; t += 32) acc += part[(size_t)t * n + c];
  red[l][tx] = acc;
  __syncthreads();
  if (l == 0 && c < n) {
    float s = 0.f;
    for (int q = 0; q < 32; ++q) s += red[q][tx];
    if (c < Fp)
      db1[c] = s;
    else
      db2[c - Fp] = s;
  }
}

// weight slots that fit beside the tiles, staging and exchange (0: none)
inline int row_slots(int E, int tbuf) {
  const RowSmem base{E / 64, tbuf, 0};
  const long long left = (long long)kSmemMax - (long long)base.bytes() -
                         16 * kMaxSlots;
  const long long n = left / ((long long)(E / 64) * kBox);
  return (int)(n < kMaxSlots ? n : kMaxSlots);
}

template <int E, typename TO>
int launch_bwd(const void* x, const void* w1t, const void* b1,
               const void* w2, const void* dy, void* dx, void* dw1t,
               void* db1, void* dw2, void* db2, void* dpre, void* h,
               void* colpart, void* wpart, int groups, int rows, int Fp,
               bool relu, Drop drop, cudaStream_t stream) {
  const int tbuf = E <= 192 ? 2 : 1;
  const int nslot = row_slots(E, tbuf);
  if (nslot < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, dym, w1m, w2m, dpm, hm;
  if (!make_map(&xm, x, rows, E, 64) || !make_map(&dym, dy, rows, E, 64) ||
      !make_map(&w1m, w1t, Fp, E, 64) || !make_map(&w2m, w2, Fp, E, 64) ||
      !make_map(&dpm, dpre, rows, Fp, 64) || !make_map(&hm, h, rows, Fp, 64))
    return (int)cudaErrorInvalidValue;
  const size_t smem = RowSmem{E / 64, tbuf, nslot}.bytes();
  cudaError_t err = set_smem(ffn_bwd_rows_kernel<E, TO>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (rows + 63) / 64;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  ffn_bwd_rows_kernel<E, TO><<<grid, kRowThreads, smem, stream>>>(
      xm, dym, w1m, w2m, dpm, hm, static_cast<const float*>(b1),
      static_cast<float*>(colpart), static_cast<TO*>(dx), rows, Fp, relu,
      drop, tbuf, nslot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* wp = static_cast<float*>(wpart);
  err = wgrad(dpre, x, wp, groups, dw1t, nullptr, rows, Fp, E, stream);
  if (err != cudaSuccess) return (int)err;
  err = wgrad(h, dy, wp, groups, dw2, nullptr, rows, Fp, E, stream);
  if (err != cudaSuccess) return (int)err;
  colsum_kernel<<<(Fp + E + 31) / 32, 1024, 0, stream>>>(
      static_cast<const float*>(colpart), tiles, Fp, E,
      static_cast<float*>(db1), static_cast<float*>(db2));
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

// x, dy: (rows, E) bf16 (the wrapper rounds an f32 x and dy once); dx:
// (rows, E), f32 when dx_f32, else bf16; w1t, w2: (Fp, E) bf16, Fp a
// multiple of 64; b1 (Fp,) f32; outs dw1t, dw2 (Fp, E), db1 (Fp,), db2
// (E,) f32. Scratch: dpre and h (rows, Fp) bf16, colpart ceil(rows / 64)
// x (Fp + E) f32, wpart groups x Fp E f32, 1 <= groups <= ceil(rows /
// 64) (ops/ffn.py bwd_scratch). All contiguous, 16-byte aligned. Dropout as
// in ffn_fwd. Returns a cudaError_t code (0 = launched).
int ffn_bwd(const void* x, const void* w1t, const void* b1, const void* w2,
            const void* dy, void* dx, void* dw1t, void* db1, void* dw2,
            void* db2, void* dpre, void* h, void* colpart, void* wpart,
            int groups, int rows, int E, int F, int relu, int dx_f32,
            unsigned seed, unsigned thr, float inv_keep, void* stream) {
  if (F % 64 || F <= 0 || rows <= 0 || groups < 1 ||
      groups > (rows + 63) / 64)
    return (int)cudaErrorInvalidValue;
  const Drop drop{seed, thr, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(W)                                                              \
  (dx_f32 ? launch_bwd<W, float>(x, w1t, b1, w2, dy, dx, dw1t, db1, dw2,    \
                                 db2, dpre, h, colpart, wpart, groups, rows, \
                                 F, relu, drop, s)                          \
          : launch_bwd<W, bf16>(x, w1t, b1, w2, dy, dx, dw1t, db1, dw2,     \
                                db2, dpre, h, colpart, wpart, groups, rows, \
                                F, relu, drop, s))
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
