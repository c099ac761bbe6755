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
// and gradient 0). Both directions walk the hidden dimension in chunks of
// 64 columns inside persistent row kernels on wgmma: a producer warpgroup
// (its registers handed to the consumers with setmaxnreg) streams each
// chunk's w1t and w2 rows through a ring of TMA slots, two consumer
// warpgroups run the products and the elementwise step in registers.
//   forward (ffn_fwd_rows_kernel): the x tile comes in by TMA (the wrapper
//     rounds an f32 x to bf16 once). Per chunk, h_pre = x . w1c^T on
//     wgmma, + b1, bf16, act, bf16 and dropout in registers, the bf16 h
//     chunk into a swizzled staging box, then y += h . w2c (the box as A,
//     the w2 slot read N-major in place) in f32 registers over every chunk;
//     the epilogue adds b2 and casts once. Nothing but y reaches device
//     memory. For E <= 192 each consumer warpgroup owns its own 64 rows of
//     a 128-row tile (kPing: 128-thread barriers only, and chunk c + 1's
//     h_pre product is issued before chunk c's y product, so an
//     elementwise step runs under the tensor cores' work); at E 384 y would
//     take 192 registers a thread, so both share a 64-row tile (kSplit: 32
//     hidden columns each, alternate 64-column boxes of y).
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
//   widths: E a multiple of 64 (the wrapper zero-pads x's columns, w1's
//     rows, w2's columns and b2 to one, and slices y, dx and the weight
//     gradients back). Up to 384 the row kernels above, one instance per
//     width (kPing up to 192, kSplit above); beyond, in the library built
//     with FFN_WIDE (ops/build.py UNITS), ffn_fwd_wide_kernel and
//     ffn_bwd_wide_kernel: the rows cut into slices of y's (dx's) columns,
//     h_pre and dh recomputed once a slice rather than the bf16 h written
//     out for a second GEMM: no hidden but kernel 10's own dpre and h
//     reaches device memory, and no product needs the shared GEMM's
//     resident weight slice (64 x F, which does not fit shared memory at
//     these F), then the same weight gradients.
//
// Each kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the entry points return a cudaError_t code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "hopper_gemm.cuh"

namespace {

using namespace hg;  // bf16, pack2 and the Hopper GEMM

constexpr float kC = 0.7978845608028654f;  // sqrt(2/pi)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// 2 consumer warpgroups and a producer warpgroup (one thread of which
// issues the loads): whole warpgroups, so that setmaxnreg can move the
// producer's registers to the consumers
constexpr int kRowThreads = 3 * 128;
constexpr int kMaxSlots = 6;               // weight slots: 3 chunks ahead

// ----------------------------- kernel 9 -----------------------------------

// The forward's two layouts of a block tile. kPing: 128 rows, each
// consumer warpgroup owns 64 of them and all 64 hidden columns of every
// chunk, stages its own h and syncs on its own 128-thread barrier, so the
// two warpgroups drift apart and one's elementwise step runs under the
// other's wgmma; each streamed weight chunk serves 128 rows. kSplit: 64
// rows shared by both warpgroups, each taking 32 hidden columns of a chunk
// (m64n32k16) and alternate 64-column boxes of y, a 256-thread barrier a
// chunk (y's registers, 64 x E f32 a warpgroup under kPing, do not fit at
// E 384).
enum FwdMode { kPing = 0, kSplit = 1 };

// weight slots of eb boxes that fit beside tbuf x tiles of xb boxes, hbox
// staging boxes, the mbarriers and the alignment slack (kMaxSlots at most)
constexpr int fwd_slots(int eb, int xb, int hbox, int tbuf) {
  const long long left = (long long)kSmemMax -
                         (long long)(tbuf * xb + hbox) * kBox - 16 * tbuf -
                         16 * kMaxSlots - 1024;
  const long long n = left / ((long long)eb * kBox);
  return (int)(n < kMaxSlots ? n : kMaxSlots);
}

template <int E, int MODE>
struct FwdCfg {
  static_assert(E % 64 == 0 && E <= 384, "width: a multiple of 64, <= 384");
  static_assert(MODE == kSplit || E <= 192, "kPing holds 64 x E f32 of y");
  static constexpr int EB = E / 64;              // 64-column boxes of a row
  static constexpr int RT = MODE == kPing ? 128 : 64;  // rows of a tile
  static constexpr int XB = RT / 64 * EB;        // boxes of an x tile
  static constexpr int NH = MODE == kPing ? 32 : 16;  // h_pre floats
  static constexpr int NY = MODE == kPing ? EB : (EB + 1) / 2;  // y boxes
  // h staging boxes: kPing two a warpgroup (chunk c + 1's elementwise step
  // runs while chunk c's y product still reads its box); kSplit two shared
  // boxes (both warpgroups finish chunk c's wait before either writes
  // chunk c + 1's)
  static constexpr int HBOX = MODE == kPing ? 4 : 2;
  // Shared memory, bytes from a 1024-byte boundary: TBUF x tiles, NSLOT
  // weight slots (EB boxes of 64 hidden rows: a chunk of w1t or of w2),
  // the h staging boxes, the mbarriers. Two x tiles where that still
  // leaves every weight slot, else one. Constants of the instance, so
  // every offset and ring index is (the consumers' registers are few:
  // 64 x E f32 of y and 64 x 64 of h_pre at E 192).
  static constexpr int TBUF =
      fwd_slots(EB, XB, HBOX, 2) >= kMaxSlots ? 2 : 1;
  static constexpr int NSLOT = fwd_slots(EB, XB, HBOX, TBUF);
  // kPing issues chunk c + 1's w1t rows while chunk c - 1's and c's w2
  // rows are still in use: 4 slots at least
  static_assert(NSLOT >= (MODE == kPing ? 4 : 3), "too few weight slots");
  static constexpr uint32_t SLOTS = TBUF * XB * kBox;
  static constexpr uint32_t STAGING = SLOTS + NSLOT * EB * kBox;
  static constexpr uint32_t BARS = STAGING + HBOX * kBox;
  static constexpr size_t BYTES = BARS + 16 * (TBUF + NSLOT) + 1024;
};

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The tanh GELU as 0.5 z (1 + tanh(u)) = z / (1 + e^(-2u)), u = sqrt(2/pi)
// (z + 0.044715 z^3): exp2 and a reciprocal on the special-function unit,
// no branch (tanhf's branches keep the compiler from interleaving the
// elements of a chunk), a few f32 ulps from tanhf's form before the bf16
// rounding that follows
__device__ __forceinline__ float gelu(float z) {
  const float u = kC * fmaf(0.044715f * z, z * z, z);
  return __fdividef(z, 1.f + __expf(-2.f * u));
}

// The forward's elementwise step on a thread's h_pre values of the chunk
// at hidden column f0 (NH / 4 column pairs at f0 + cb0 + 8 i (+ 1), tile
// rows r and r + 8, rows row0 and row0 + 8 of x), branch free: + b1,
// bf16, act, bf16, dropout; packed bf16 pairs into the swizzled staging
// box
template <bool RELU, bool DROP, int NH>
__device__ __forceinline__ void hidden_step(const float (&hp)[NH],
                                            const float* __restrict__ b1,
                                            uint8_t* hst, int r, int cb0,
                                            int f0, int row0,
                                            const Drop& drop) {
  uint32_t key0 = 0, key1 = 0;  // the rows' dropout keys
  if (DROP) {
    key0 = dropout_key(drop.seed, (uint32_t)row0);
    key1 = dropout_key(drop.seed, (uint32_t)(row0 + 8));
  }
#pragma unroll
  for (int i = 0; i < NH / 4; ++i) {
    const int cb = cb0 + 8 * i;
    const float2 bb = *reinterpret_cast<const float2*>(b1 + f0 + cb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z = round_bf16(hp[4 * i + 2 * h + e] + (e ? bb.y : bb.x));
        float hv = round_bf16(RELU ? fmaxf(z, 0.f) : gelu(z));
        if (DROP) {
          const bool keep = dropout_bits(h ? key1 : key0,
                                         (uint32_t)(f0 + cb + e)) >= drop.thr;
          hv = keep ? round_bf16(hv * drop.inv_keep) : 0.f;
        }
        v[e] = hv;
      }
      *reinterpret_cast<uint32_t*>(hst + swz(r + 8 * h, cb)) =
          pack2(v[0], v[1]);
    }
  }
}

// y (rows, E) = (dropped act(x . w1 + b1)) . w2 + b2, cast once to TY.
// x_map: x (rows, E) bf16, boxes of 64 x 64; w1_map, w2_map: w1t and w2
// (Fp, E) bf16, boxes of 64 x 64. Block b owns the row tiles b, b +
// gridDim.x, ... of RT rows; the hidden dimension goes by chunks of 64
// columns, whose w1t and w2 rows the producer streams through the slot
// ring (w1t's, then w2's).
//
// A consumer warpgroup's chunk: hp = x . w1c^T (wgmma, K-major from the
// x tile and the w1t slot) in f32 registers; the elementwise step in
// registers (+ b1, bf16, act, bf16, dropout) into a bf16 staging box; y +=
// h . w2c (the staging box as A, the w2 slot read N-major in place). Under
// kPing the next chunk's hp product is issued before this chunk's y
// product and waited for alone (wgmma.wait_group 1), so each warpgroup's
// elementwise step also runs under its own y product.
template <int E, int MODE, typename TY>
__global__ void __launch_bounds__(kRowThreads, 1)
    ffn_fwd_rows_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const float* __restrict__ b1,
                        const float* __restrict__ b2, TY* __restrict__ y,
                        int rows, int Fp, bool relu, Drop drop) {
  using C = FwdCfg<E, MODE>;
  constexpr int EB = C::EB, RT = C::RT, XB = C::XB;
  constexpr int tbuf = C::TBUF, nslot = C::NSLOT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t slot0 = base + C::SLOTS, h0 = base + C::STAGING;
  const uint32_t tile_full = base + C::BARS;
  const uint32_t tile_empty = tile_full + 8 * tbuf;
  const uint32_t slot_full = tile_empty + 8 * tbuf;
  const uint32_t slot_empty = slot_full + 8 * nslot;
  const int tiles = (rows + RT - 1) / RT, chunks = Fp / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto x_s = [&](int buf) { return base + (uint32_t)buf * XB * kBox; };
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
        mbar_expect_tx(tile_full + 8 * buf, XB * kBox);
        for (int q = 0; q < XB; ++q)  // rows 64 (q / EB), cols 64 (q % EB)
          tma_load(x_s(buf) + q * kBox, &x_map, tile_full + 8 * buf,
                   (q % EB) * 64, t * RT + (q / EB) * 64);
        for (int c = 0; c < chunks; ++c) {
          for (int w = 0; w < 2; ++w, ++it) {  // w1t rows, then w2 rows
            const int s = it % nslot;
            mbar_wait(slot_empty + 8 * s, ((it / nslot) & 1) ^ 1);
            mbar_expect_tx(slot_full + 8 * s, EB * kBox);
#pragma unroll
            for (int kb = 0; kb < EB; ++kb)
              tma_load(slot_s(s) + kb * kBox, w ? &w2_map : &w1_map,
                       slot_full + 8 * s, kb * 64, c * 64);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // the consumers: thread t holds rows r, r + 8 and columns 8 i + cq (+ 1)
  // of each wgmma tile. kPing: warpgroup wg owns rows [64 wg, 64 wg + 64)
  // of the tile and every y box; kSplit: hidden columns [32 wg, 32 wg +
  // 32) of each chunk and the y boxes wg, wg + 2, ...
  // warpgroup index, broadcast so that the compiler knows it is the same
  // across a warp: a branch on it is then not divergent, and ptxas need
  // not serialize the wgmma around it
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r = (warp & 3) * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const int cb0 = (MODE == kPing ? 0 : wg * 32) + cq;
  const uint32_t xrow = MODE == kPing ? (uint32_t)wg * EB * kBox : 0u;
  const uint32_t hcol = MODE == kPing ? 0u : (uint32_t)wg * 32 * 128;
  auto h_s = [&](int c) {
    return h0 + (uint32_t)((MODE == kPing ? 2 * wg : 0) + (c & 1)) * kBox;
  };
  auto ybox = [&](int j) { return MODE == kPing ? j : 2 * j + wg; };
  auto hp_product = [&](float (&hp)[C::NH], int buf, int s) {
#pragma unroll
    for (int i = 0; i < C::NH; ++i) hp[i] = 0.f;
    fence_regs(hp);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < EB; ++kb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_k(x_s(buf) + xrow + kb * kBox + kk * 32);
        const uint64_t db = desc_k(slot_s(s) + kb * kBox + hcol + kk * 32);
        if constexpr (MODE == kPing)
          wgmma64<0, 0>(hp, da, db);
        else
          wgmma32<0, 0>(hp, da, db);
      }
    wgmma_commit();
  };
  int it = 0, li = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++li) {
    const int buf = li % tbuf;
    const int row0 = t * RT + (MODE == kPing ? wg * 64 : 0) + r;
    float ya[C::NY][32];
#pragma unroll
    for (int j = 0; j < C::NY; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) ya[j][i] = 0.f;
    fence_acc(ya);
    float hp[C::NH];
    mbar_wait(tile_full + 8 * buf, (li / tbuf) & 1);
    mbar_wait(slot_full + 8 * (it % nslot), (it / nslot) & 1);
    hp_product(hp, buf, it % nslot);

    for (int c = 0; c < chunks; ++c) {
      const int s1 = (it + 2 * c) % nslot, s2 = (it + 2 * c + 1) % nslot;
      // chunk c's hp (and, under kPing, y up to chunk c - 2; under kSplit
      // y up to chunk c - 1)
      if (MODE == kPing && c > 0)
        wgmma_wait1();
      else
        wgmma_wait();
      fence_regs(hp);
      fence_acc(ya);
      if (lane == 0) {
        mbar_arrive(slot_empty + 8 * s1);  // w1t's rows are done
        if (c == chunks - 1) mbar_arrive(tile_empty + 8 * buf);
        const int done = MODE == kPing ? c - 2 : c - 1;  // w2's rows
        if (done >= 0)
          mbar_arrive(slot_empty + 8 * ((it + 2 * done + 1) % nslot));
      }

      // the elementwise step: hp becomes the dropped bf16 h
      uint8_t* hst = smem_raw + (h_s(c) - raw);
      const int f0 = c * 64;
      if (relu) {
        if (drop.thr)
          hidden_step<true, true>(hp, b1, hst, r, cb0, f0, row0, drop);
        else
          hidden_step<true, false>(hp, b1, hst, r, cb0, f0, row0, drop);
      } else {
        if (drop.thr)
          hidden_step<false, true>(hp, b1, hst, r, cb0, f0, row0, drop);
        else
          hidden_step<false, false>(hp, b1, hst, r, cb0, f0, row0, drop);
      }
      fence_async_smem();
      if constexpr (MODE == kPing)
        bar_sync(1 + wg, 128);
      else
        bar_sync(1, 256);

      if (MODE == kPing && c + 1 < chunks) {  // chunk c + 1's hp first
        const int n1 = (it + 2 * c + 2) % nslot;
        mbar_wait(slot_full + 8 * n1, ((it + 2 * c + 2) / nslot) & 1);
        hp_product(hp, buf, n1);
      }
      // y += h (64 x 64) . w2c (64 x E), this warpgroup's boxes
      mbar_wait(slot_full + 8 * s2, ((it + 2 * c + 1) / nslot) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_k(h_s(c) + kk * 32);
#pragma unroll
        for (int j = 0; j < C::NY; ++j)
          if (ybox(j) < EB)
            wgmma64<0, 1>(ya[j], da,
                          desc_mn(slot_s(s2) + ybox(j) * kBox + kk * 2048));
      }
      wgmma_commit();
      if (MODE == kSplit && c + 1 < chunks) {
        const int n1 = (it + 2 * c + 2) % nslot;
        mbar_wait(slot_full + 8 * n1, ((it + 2 * c + 2) / nslot) & 1);
        hp_product(hp, buf, n1);
      }
    }
    wgmma_wait();
    fence_acc(ya);
    if (lane == 0) {  // the last chunks' w2 rows
      if (MODE == kPing && chunks >= 2)
        mbar_arrive(slot_empty + 8 * ((it + 2 * chunks - 3) % nslot));
      mbar_arrive(slot_empty + 8 * ((it + 2 * chunks - 1) % nslot));
    }
    it += 2 * chunks;

    // y + b2, cast once to TY
#pragma unroll
    for (int j = 0; j < C::NY; ++j) {
      if (ybox(j) >= EB) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = ybox(j) * 64 + 8 * i + cq;
        const float c0 = b2[col], c1 = b2[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= rows) continue;
          const float v0 = ya[j][4 * i + 2 * h] + c0;
          const float v1 = ya[j][4 * i + 2 * h + 1] + c1;
          if constexpr (sizeof(TY) == 4)
            *reinterpret_cast<float2*>(y + (size_t)row * E + col) =
                make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(y + (size_t)row * E + col) =
                pack2(v0, v1);
        }
      }
    }
  }
}

template <int E, int MODE, typename TY>
int launch_fwd(const void* x, const void* w1t, const void* b1,
               const void* w2, const void* b2, void* y, int rows, int Fp,
               bool relu, Drop drop, cudaStream_t stream) {
  using C = FwdCfg<E, MODE>;
  CUtensorMap xm, w1m, w2m;
  if (!make_map(&xm, x, rows, E, 64) || !make_map(&w1m, w1t, Fp, E, 64) ||
      !make_map(&w2m, w2, Fp, E, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(ffn_fwd_rows_kernel<E, MODE, TY>, C::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (rows + C::RT - 1) / C::RT;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  ffn_fwd_rows_kernel<E, MODE, TY><<<grid, kRowThreads, C::BYTES, stream>>>(
      xm, w1m, w2m, static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<TY*>(y), rows, Fp, relu,
      drop);
  return (int)cudaGetLastError();
}

// ----------------------------- kernel 10 ----------------------------------

// act(z) and act'(z), with one tanh
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

// shared memory of the backward's row kernel, bytes from a 1024-byte
// boundary: tbuf x and dy tiles (E / 64 boxes each), nslot weight slots (E
// / 64 boxes of 64 hidden rows), the dpre and h staging boxes, the
// column-sum exchange
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
  static_assert(E % 64 == 0 && E <= 384, "width: a multiple of 64, <= 384");
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
[[maybe_unused]] inline int row_slots(int E, int tbuf) {
  const RowSmem base{E / 64, tbuf, 0};
  const long long left = (long long)kSmemMax - (long long)base.bytes() -
                         16 * kMaxSlots;
  const long long n = left / ((long long)(E / 64) * kBox);
  return (int)(n < kMaxSlots ? n : kMaxSlots);
}

// dw1t = bf16(dpre)^T . x and dw2 = h^T . dy on the shared weight-gradient
// GEMM, then db1 and db2 from the row kernel's per-tile column sums
inline int weight_grads(const void* x, const void* dy, void* dw1t, void* db1,
                        void* dw2, void* db2, void* dpre, void* h,
                        void* colpart, void* wpart, int groups, int rows,
                        int E, int Fp, cudaStream_t stream) {
  float* wp = static_cast<float*>(wpart);
  cudaError_t err =
      wgrad(dpre, x, wp, groups, dw1t, nullptr, rows, Fp, E, stream);
  if (err != cudaSuccess) return (int)err;
  err = wgrad(h, dy, wp, groups, dw2, nullptr, rows, Fp, E, stream);
  if (err != cudaSuccess) return (int)err;
  colsum_kernel<<<(Fp + E + 31) / 32, 1024, 0, stream>>>(
      static_cast<const float*>(colpart), (rows + 63) / 64, Fp, E,
      static_cast<float*>(db1), static_cast<float*>(db2));
  return (int)cudaGetLastError();
}

#ifdef FFN_WIDE
// ------------------------- kernels 9 and 10 above E 384 ---------------------

// Above E 384 a row tile's x (and dy) no longer fit shared memory beside a
// chunk's weight rows, nor y's (dx's) 64 x E f32 the consumers' registers.
// The wide kernels give a block a (64-row tile, slice of at most
// kWideBoxes 64-column boxes of y or dx) work item: the whole hidden
// dimension goes by for every slice, and h_pre (and dh) is recomputed
// once a slice (ceil(E / 384) times), while y (dx) stays in registers
// over every chunk, never rounded before the end, as in the narrow
// kernels. x (dy) and the weights stream through one ring of TMA slots:
// per chunk, one item per 64 columns of E (x's box and w1t's, and, in the
// backward, dy's and w2's) for the h_pre (dh) products, then one item per
// two boxes of the slice's w2 (w1t) rows for the y (dx) products. The
// consumers release a slot once the product that read it is done
// (wgmma.wait_group 1 once the next product is under way). Hidden columns
// are split between the two consumer warpgroups (32 each, kSplit's layout),
// y's (dx's) boxes alternate between them. Kernel 10's slice-0 blocks
// store dpre, h and the column sums; the other slices only add dx.
constexpr int kWideBoxes = 6;               // y (dx) boxes of a slice
constexpr int kWideNY = kWideBoxes / 2;     // ... of a consumer warpgroup
constexpr int kWideFwdSlots = 10;           // of 2 boxes: 160 KB
constexpr int kWideBwdSlots = 5;            // of 4 boxes: 160 KB

// slices of E's 64-column boxes (at most kWideBoxes each) and boxes of
// every slice but maybe the last
inline void wide_slices(int E, int& slices, int& per) {
  const int eb = E / 64;
  slices = (eb + kWideBoxes - 1) / kWideBoxes;
  per = (eb + slices - 1) / slices;
}

// y (rows, E) as ffn_fwd_rows_kernel computes it, for E a multiple of 64
// above 384; maps as there. Block b owns the work items b, b + gridDim.x,
// ... of (64-row tile t, slice sl): item t slices + sl.
template <typename TY>
__global__ void __launch_bounds__(kRowThreads, 1)
    ffn_fwd_wide_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const float* __restrict__ b1,
                        const float* __restrict__ b2, TY* __restrict__ y,
                        int rows, int E, int Fp, int slices, int per,
                        bool relu, Drop drop) {
  constexpr int nslot = kWideFwdSlots;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t h0 = base + nslot * 2 * kBox;
  const uint32_t full = h0 + 2 * kBox, empty = full + 8 * nslot;
  const int tiles = (rows + 63) / 64, chunks = Fp / 64, eb = E / 64;
  const int items = tiles * slices;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto slot_s = [&](int s) { return base + (uint32_t)s * 2 * kBox; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < nslot; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int it = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int t = w / slices, jb0 = (w % slices) * per;
        const int nb = min(per, eb - jb0);
        for (int c = 0; c < chunks; ++c) {
          for (int kb = 0; kb < eb; ++kb, ++it) {  // x's box, w1t's box
            const int s = it % nslot;
            mbar_wait(empty + 8 * s, ((it / nslot) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, 2 * kBox);
            tma_load(slot_s(s), &x_map, full + 8 * s, kb * 64, t * 64);
            tma_load(slot_s(s) + kBox, &w1_map, full + 8 * s, kb * 64,
                     c * 64);
          }
          for (int j = 0; j < nb; j += 2, ++it) {  // two boxes of w2 rows
            const int s = it % nslot, n = min(2, nb - j);
            mbar_wait(empty + 8 * s, ((it / nslot) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, n * kBox);
            for (int q = 0; q < n; ++q)
              tma_load(slot_s(s) + q * kBox, &w2_map, full + 8 * s,
                       (jb0 + j + q) * 64, c * 64);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // the consumers: warpgroup wg takes hidden columns [32 wg, 32 wg + 32)
  // of each chunk and the slice's boxes wg, wg + 2, ...; thread t holds
  // rows r, r + 8 and columns 8 i + cq (+ 1) of each wgmma tile
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r = (warp & 3) * 16 + (lane >> 2), cq = (lane & 3) * 2;
  auto h_s = [&](int c) { return h0 + (uint32_t)(c & 1) * kBox; };
  // the slot of item `it` once its product is done: each warp's arrival
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(empty + 8 * (it % nslot));
  };
  int it = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int t = w / slices, jb0 = (w % slices) * per;
    const int nb = min(per, eb - jb0);
    const int row0 = t * 64 + r;
    float ya[kWideNY][32];
#pragma unroll
    for (int j = 0; j < kWideNY; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) ya[j][i] = 0.f;
    fence_acc(ya);

    for (int c = 0; c < chunks; ++c) {
      // h_pre = x . w1c^T over E's boxes, this warpgroup's 32 columns
      float hp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) hp[i] = 0.f;
      fence_regs(hp);
      for (int kb = 0; kb < eb; ++kb, ++it) {
        const int s = it % nslot;
        mbar_wait(full + 8 * s, (it / nslot) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma32<0, 0>(hp, desc_k(slot_s(s) + kk * 32),
                        desc_k(slot_s(s) + kBox + wg * 32 * 128 + kk * 32));
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait1();
          release(it - 1);
        }
      }
      wgmma_wait();
      fence_regs(hp);
      release(it - 1);

      // the elementwise step into this chunk's staging box
      uint8_t* hst = smem_raw + (h_s(c) - raw);
      const int f0 = c * 64, cb0 = wg * 32 + cq;
      if (relu) {
        if (drop.thr)
          hidden_step<true, true>(hp, b1, hst, r, cb0, f0, row0, drop);
        else
          hidden_step<true, false>(hp, b1, hst, r, cb0, f0, row0, drop);
      } else {
        if (drop.thr)
          hidden_step<false, true>(hp, b1, hst, r, cb0, f0, row0, drop);
        else
          hidden_step<false, false>(hp, b1, hst, r, cb0, f0, row0, drop);
      }
      fence_async_smem();
      bar_sync(1, 256);

      // y += h (64 x 64) . w2c (64 x 64 a box), this warpgroup's boxes
#pragma unroll
      for (int i = 0; i < kWideNY; ++i) {
        if (2 * i >= nb) break;
        const int s = it % nslot;
        mbar_wait(full + 8 * s, (it / nslot) & 1);
        wgmma_fence();
        if (2 * i + wg < nb) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma64<0, 1>(ya[i], desc_k(h_s(c) + kk * 32),
                          desc_mn(slot_s(s) + wg * kBox + kk * 2048));
        }
        wgmma_commit();
        if (i > 0) {
          wgmma_wait1();
          release(it - 1);
        }
        ++it;
      }
      wgmma_wait();
      fence_acc(ya);
      release(it - 1);
    }

    // y + b2, cast once to TY
#pragma unroll
    for (int j = 0; j < kWideNY; ++j) {
      if (2 * j + wg >= nb) continue;
      const int box = jb0 + 2 * j + wg;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = box * 64 + 8 * i + cq;
        const float c0 = b2[col], c1 = b2[col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + 8 * h;
          if (row >= rows) continue;
          const float v0 = ya[j][4 * i + 2 * h] + c0;
          const float v1 = ya[j][4 * i + 2 * h + 1] + c1;
          if constexpr (sizeof(TY) == 4)
            *reinterpret_cast<float2*>(y + (size_t)row * E + col) =
                make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(y + (size_t)row * E + col) =
                pack2(v0, v1);
        }
      }
    }
  }
}

template <typename TY>
int launch_fwd_wide(const void* x, const void* w1t, const void* b1,
                    const void* w2, const void* b2, void* y, int rows, int E,
                    int Fp, bool relu, Drop drop, cudaStream_t stream) {
  CUtensorMap xm, w1m, w2m;
  if (!make_map(&xm, x, rows, E, 64) || !make_map(&w1m, w1t, Fp, E, 64) ||
      !make_map(&w2m, w2, Fp, E, 64))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kWideFwdSlots + 1) * 2 * kBox +
                      16 * kWideFwdSlots + 1024;
  cudaError_t err = set_smem(ffn_fwd_wide_kernel<TY>, smem);
  if (err != cudaSuccess) return (int)err;
  int slices, per;
  wide_slices(E, slices, per);
  const int items = (rows + 63) / 64 * slices;
  const int grid = items < sm_count() ? items : sm_count();
  ffn_fwd_wide_kernel<TY><<<grid, kRowThreads, smem, stream>>>(
      xm, w1m, w2m, static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<TY*>(y), rows, E, Fp,
      slices, per, relu, drop);
  return (int)cudaGetLastError();
}

// the rows of the backward as ffn_bwd_rows_kernel computes them, for E a
// multiple of 64 above 384: dx, and, from the slice-0 blocks, bf16(dpre),
// the dropped bf16 h and the per-tile column sums of dpre and dy (colpart:
// tiles x (Fp + E) f32, the same layout and order). Maps as there; work
// items as ffn_fwd_wide_kernel's.
template <typename TO>
__global__ void __launch_bounds__(kRowThreads, 1)
    ffn_bwd_wide_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap dy_map,
                        const __grid_constant__ CUtensorMap w1_map,
                        const __grid_constant__ CUtensorMap w2_map,
                        const __grid_constant__ CUtensorMap dp_map,
                        const __grid_constant__ CUtensorMap h_map,
                        const float* __restrict__ b1,
                        float* __restrict__ colpart, TO* __restrict__ dx,
                        int rows, int E, int Fp, int slices, int per,
                        bool relu, Drop drop) {
  constexpr int nslot = kWideBwdSlots;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t dp_s = base + nslot * 4 * kBox, h_s = dp_s + kBox;
  float* red = reinterpret_cast<float*>(smem_raw + (h_s + kBox - raw));
  const uint32_t full = h_s + kBox + 2 * 2 * 4 * 32 * 4;
  const uint32_t empty = full + 8 * nslot;
  const int tiles = (rows + 63) / 64, chunks = Fp / 64, eb = E / 64;
  const int items = tiles * slices;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto slot_s = [&](int s) { return base + (uint32_t)s * 4 * kBox; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < nslot; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int it = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int t = w / slices, jb0 = (w % slices) * per;
        const int nb = min(per, eb - jb0);
        for (int c = 0; c < chunks; ++c) {
          // x's, dy's, w2's and w1t's box of E's columns kb
          for (int kb = 0; kb < eb; ++kb, ++it) {
            const int s = it % nslot;
            const uint32_t d = slot_s(s), bar = full + 8 * s;
            mbar_wait(empty + 8 * s, ((it / nslot) & 1) ^ 1);
            mbar_expect_tx(bar, 4 * kBox);
            tma_load(d, &x_map, bar, kb * 64, t * 64);
            tma_load(d + kBox, &dy_map, bar, kb * 64, t * 64);
            tma_load(d + 2 * kBox, &w2_map, bar, kb * 64, c * 64);
            tma_load(d + 3 * kBox, &w1_map, bar, kb * 64, c * 64);
          }
          for (int j = 0; j < nb; j += 2, ++it) {  // two boxes of w1t rows
            const int s = it % nslot, n = min(2, nb - j);
            mbar_wait(empty + 8 * s, ((it / nslot) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, n * kBox);
            for (int q = 0; q < n; ++q)
              tma_load(slot_s(s) + q * kBox, &w1_map, full + 8 * s,
                       (jb0 + j + q) * 64, c * 64);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // the consumers: warpgroup wg computes hidden columns [32 wg, 32 wg + 32)
  // of each chunk and the slice's dx boxes wg, wg + 2, ...; thread t holds
  // rows r, r + 8 and columns 8 i + cq (+ 1) of each wgmma tile
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int tid = threadIdx.x;
  const int r = (warp & 3) * 16 + (lane >> 2), cq = (lane & 3) * 2;
  uint8_t* dp_gen = smem_raw + (dp_s - raw);
  uint8_t* h_gen = smem_raw + (h_s - raw);
  const size_t cstride = (size_t)Fp + E;
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(empty + 8 * (it % nslot));
  };
  int it = 0, nc = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int t = w / slices, sl = w % slices, jb0 = sl * per;
    const int nb = min(per, eb - jb0);
    float dxa[kWideNY][32];
#pragma unroll
    for (int j = 0; j < kWideNY; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dxa[j][i] = 0.f;
    fence_acc(dxa);

    for (int c = 0; c < chunks; ++c, ++nc) {
      // dh = dy . w2c^T and h_pre = x . w1c^T over E's boxes
      float dh[16], hp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) dh[i] = hp[i] = 0.f;
      fence_regs(dh);
      fence_regs(hp);
      for (int kb = 0; kb < eb; ++kb, ++it) {
        const int s = it % nslot;
        const uint32_t d = slot_s(s);
        mbar_wait(full + 8 * s, (it / nslot) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t wc = wg * 32 * 128 + kk * 32;
          wgmma32<0, 0>(dh, desc_k(d + kBox + kk * 32),
                        desc_k(d + 2 * kBox + wc));
          wgmma32<0, 0>(hp, desc_k(d + kk * 32), desc_k(d + 3 * kBox + wc));
        }
        wgmma_commit();
        if (c == 0 && sl == 0 && tid < 64) {
          // db2's partial: the tile's column sums of dy, rows in order
          // (rows past the end are TMA's zeros)
          const uint8_t* dyb = smem_raw + (d + kBox - raw);
          float sum = 0.f;
          for (int rr = 0; rr < 64; ++rr)
            sum += __bfloat162float(
                *reinterpret_cast<const bf16*>(dyb + swz(rr, tid)));
          colpart[(size_t)t * cstride + Fp + kb * 64 + tid] = sum;
        }
        if (kb > 0) {
          wgmma_wait1();
          release(it - 1);
        }
      }
      wgmma_wait();
      fence_regs(dh);
      fence_regs(hp);
      release(it - 1);

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
            float hv = round_bf16(a), dd = dh[k];
            if (drop.thr) {
              const bool keep = drop.keep(t * 64 + r + 8 * h, col);
              dd = keep ? dd * drop.inv_keep : 0.f;
              hv = keep ? round_bf16(hv * drop.inv_keep) : 0.f;
            }
            hp[k] = hv;
            dh[k] = dd * da;
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
      if (sl == 0) {
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
      }

      // dx += bf16(dpre) (64 x 64) . w1c (64 x 64 a box), this
      // warpgroup's boxes
#pragma unroll
      for (int i = 0; i < kWideNY; ++i) {
        if (2 * i >= nb) break;
        const int s = it % nslot;
        mbar_wait(full + 8 * s, (it / nslot) & 1);
        wgmma_fence();
        if (2 * i + wg < nb) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma64<0, 1>(dxa[i], desc_k(dp_s + kk * 32),
                          desc_mn(slot_s(s) + wg * kBox + kk * 2048));
        }
        wgmma_commit();
        if (i > 0) {
          wgmma_wait1();
          release(it - 1);
        }
        ++it;
      }
      wgmma_wait();
      fence_acc(dxa);
      release(it - 1);
    }

    // dx, cast once to x's type
#pragma unroll
    for (int j = 0; j < kWideNY; ++j) {
      if (2 * j + wg >= nb) continue;
      const int box = jb0 + 2 * j + wg;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = box * 64 + 8 * i + cq;
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
#endif  // FFN_WIDE

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
  return weight_grads(x, dy, dw1t, db1, dw2, db2, dpre, h, colpart, wpart,
                      groups, rows, E, Fp, stream);
}

#ifdef FFN_WIDE
template <typename TO>
int launch_bwd_wide(const void* x, const void* w1t, const void* b1,
                    const void* w2, const void* dy, void* dx, void* dw1t,
                    void* db1, void* dw2, void* db2, void* dpre, void* h,
                    void* colpart, void* wpart, int groups, int rows, int E,
                    int Fp, bool relu, Drop drop, cudaStream_t stream) {
  CUtensorMap xm, dym, w1m, w2m, dpm, hm;
  if (!make_map(&xm, x, rows, E, 64) || !make_map(&dym, dy, rows, E, 64) ||
      !make_map(&w1m, w1t, Fp, E, 64) || !make_map(&w2m, w2, Fp, E, 64) ||
      !make_map(&dpm, dpre, rows, Fp, 64) || !make_map(&hm, h, rows, Fp, 64))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWideBwdSlots * 4 * kBox + 2 * kBox +
                      2 * 2 * 4 * 32 * 4 + 16 * kWideBwdSlots + 1024;
  cudaError_t err = set_smem(ffn_bwd_wide_kernel<TO>, smem);
  if (err != cudaSuccess) return (int)err;
  int slices, per;
  wide_slices(E, slices, per);
  const int items = (rows + 63) / 64 * slices;
  const int grid = items < sm_count() ? items : sm_count();
  ffn_bwd_wide_kernel<TO><<<grid, kRowThreads, smem, stream>>>(
      xm, dym, w1m, w2m, dpm, hm, static_cast<const float*>(b1),
      static_cast<float*>(colpart), static_cast<TO*>(dx), rows, E, Fp,
      slices, per, relu, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return weight_grads(x, dy, dw1t, db1, dw2, db2, dpre, h, colpart, wpart,
                      groups, rows, E, Fp, stream);
}
#endif  // FFN_WIDE

}  // namespace

extern "C" {

// x: (rows, E) bf16 (the wrapper rounds an f32 x once); y: (rows, E), f32
// when y_f32, else bf16; w1t and w2: (F, E) bf16 (w1 transposed), F a
// multiple of 64; b1 (F,) and b2 (E,) f32. All contiguous, 16-byte
// aligned. Dropout: keep a hidden unit when its hash bits are >= thr (thr
// = 0: eval mode), scale kept ones by inv_keep. E a multiple of 64 (the
// wrapper pads E): this library (ops/build.py UNITS) takes E <= 384 (tile
// layout kPing for E <= 192, kSplit above) or, built with FFN_WIDE, E
// above 384 (ffn_fwd_wide_kernel); cudaErrorInvalidValue for the others.
// Returns a cudaError_t code (0 = launched).
int ffn_fwd(const void* x, const void* w1t, const void* b1, const void* w2,
            const void* b2, void* y, int rows, int E, int F, int relu,
            int y_f32, unsigned seed, unsigned thr, float inv_keep,
            void* stream) {
  if (F % 64 || F <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Drop drop{seed, thr, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef FFN_WIDE
  if (E <= 384 || E % 64) return (int)cudaErrorInvalidValue;
  return y_f32 ? launch_fwd_wide<float>(x, w1t, b1, w2, b2, y, rows, E, F,
                                        relu, drop, s)
               : launch_fwd_wide<bf16>(x, w1t, b1, w2, b2, y, rows, E, F,
                                       relu, drop, s);
#else
#define FWD(W, M)                                                           \
  (y_f32 ? launch_fwd<W, M, float>(x, w1t, b1, w2, b2, y, rows, F, relu,    \
                                   drop, s)                                 \
         : launch_fwd<W, M, bf16>(x, w1t, b1, w2, b2, y, rows, F, relu,     \
                                  drop, s))
  switch (E) {
    case 64: return FWD(64, kPing);
    case 128: return FWD(128, kPing);
    case 192: return FWD(192, kPing);
    case 256: return FWD(256, kSplit);
    case 320: return FWD(320, kSplit);
    case 384: return FWD(384, kSplit);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD
#endif
}

// x, dy: (rows, E) bf16 (the wrapper rounds an f32 x and dy once); dx:
// (rows, E), f32 when dx_f32, else bf16; w1t, w2: (Fp, E) bf16, Fp a
// multiple of 64; b1 (Fp,) f32; outs dw1t, dw2 (Fp, E), db1 (Fp,), db2
// (E,) f32. Scratch: dpre and h (rows, Fp) bf16, colpart ceil(rows / 64)
// x (Fp + E) f32, wpart groups x Fp E f32, 1 <= groups <= ceil(rows /
// 64) (ops/ffn.py bwd_scratch). All contiguous, 16-byte aligned. Dropout as
// in ffn_fwd; the widths as there. Returns a cudaError_t code (0 =
// launched).
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
#ifdef FFN_WIDE
  if (E <= 384 || E % 64) return (int)cudaErrorInvalidValue;
  return dx_f32 ? launch_bwd_wide<float>(x, w1t, b1, w2, dy, dx, dw1t, db1,
                                         dw2, db2, dpre, h, colpart, wpart,
                                         groups, rows, E, F, relu, drop, s)
                : launch_bwd_wide<bf16>(x, w1t, b1, w2, dy, dx, dw1t, db1,
                                        dw2, db2, dpre, h, colpart, wpart,
                                        groups, rows, E, F, relu, drop, s);
#else
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
    case 256: return BWD(256);
    case 320: return BWD(320);
    case 384: return BWD(384);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD
#endif
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
