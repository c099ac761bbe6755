// The Hopper GEMM shared by the kernels whose products stream rows
// (sm_90a): mbarriers, TMA and wgmma building blocks, a persistent row
// GEMM and a weight-gradient GEMM with a fixed-order group sum.
// Included by csrc/attention_block.cu (kernels 11-12), csrc/ffn.cu
// (kernels 9 and 10: their row kernels on the building blocks, kernel 10's
// weight gradients), csrc/mbconv_fwd.cu (kernel 13's expand with its
// column sums; kernel 14's passes on the building blocks),
// csrc/mbconv_bwd.cu (kernel 15's passes on the building blocks and its
// dwproj; kernel 16's y1, dx and dwexp) and csrc/hopper_gemm.cu (the
// entry points the card tests call).
//
//   gemm_rows_kernel: C (M, N) = A (M, K) . B (+ f32 bias), one bf16
//     rounding. A persistent block owns a BN-column slice of C and keeps
//     the whole (BN, K) slice of the weight resident in shared memory
//     (one TMA load at the start), then walks 128-row tiles of A. A
//     producer warp keeps a ring of TMA loads (64-column boxes, 128-byte
//     swizzle) in flight on mbarriers; two consumer warpgroups (64 rows
//     each) run wgmma.mma_async m64n64k16 (bf16, f32 accumulators) on the
//     ring and the resident weight. Where the resident slice would leave
//     fewer than 4 ring stages (K above 1,152 at BN 64), the STREAM
//     instances carry the weight's (BN, 64) box of each K step in the
//     ring stage beside A's box instead: the same products, summed in the
//     same order over the whole K in f32, the same epilogue, so the
//     result does not depend on the route (gemm_route picks it). B is
//     K-major (a weight (N, K) as
//     nn.Linear holds it) or N-major (a weight (K, N) read in place along
//     its rows), which wgmma takes through its transpose bit. The epilogue
//     adds the bias, rounds once in registers, writes a swizzled staging
//     tile and stores it with TMA. With SUMS (gemm_sums, kernel 13's
//     expand) it also writes, for every 64-row chunk, the column sums of
//     the rounded C and of its squares, read back from the staging tile.
//   wgrad_kernel: dW (N, K) = G^T X, a sum over every row of G (rows, N)
//     and X (rows, K). A block owns a 64 x TK tile of dW and one group of
//     64-row chunks; one warpgroup runs wgmma on both operands M- and
//     N-major (the row boxes as TMA loads them, read transposed through
//     the descriptors), behind a producer warp's ring. It writes its
//     group's f32 partial (and, when asked, in the tiles of column 0, G's
//     column sums: the bias gradient); reduce_kernel adds the groups in
//     index order. No float atomics, so a run repeats bit for bit.
//
// Widths: every row stride must be a multiple of 16 bytes (8 bf16
// columns), TMA's rule; make_map refuses the rest on the host, before any
// launch. K, N and the rows need not be multiples of 64: TMA fills what a
// box reads past the end of a matrix with zeros, which add nothing to a
// product, and clips what a store writes past it.
//
// TMA descriptors are encoded on the host for every call
// (cuTensorMapEncodeTiled, from cudaGetDriverEntryPoint: no -lcuda) and
// passed as __grid_constant__ parameters. Each kernel launches on the
// caller's stream, does not synchronise and allocates nothing.
//
// Internal linkage (an anonymous namespace), as mbconv.cuh: each library
// holds its own copy; the inner namespace keeps the names apart from
// mbconv.cuh's in csrc/mbconv_bwd.cu.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace hg {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;            // rows of a row tile: 2 warpgroups of 64
constexpr int kBK = 64;             // bf16 columns of a 128-byte box
constexpr uint32_t kBox = 64 * 64 * 2;  // bytes of a 64 x 64 box
constexpr uint32_t kATile = kBM * kBK * 2;  // bytes of one ring stage
constexpr int kGemmThreads = 2 * 128 + 32;  // 2 consumer warpgroups + producer
constexpr int kWgradThreads = 128 + 32;     // 1 consumer warpgroup + producer
constexpr int kMaxStages = 6;
constexpr size_t kSmemMax = 232448;  // the opt-in maximum of a block

__host__ __device__ inline int boxes(int n) { return (n + kBK - 1) / kBK; }

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed; a wait of
// about 2^34 clocks (seconds) can only be a broken pipeline, and traps, so
// that the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (!start) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// the box at (column c0, row c1) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the box at (column c0, row c1, matrix c2) of a 3-D `map`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory, visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: the start
// address, the leading and stride byte offsets (the 8-row groups of a
// swizzle atom lie 1024 bytes apart), layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major: a k16 step moves 32 bytes inside the 128-byte row
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return gmma_desc(addr, 0, 1024);
}
// M- or N-major (64 elements of M or N in a 128-byte row, K down the rows):
// a k16 step moves 16 rows, 2048 bytes. Both offsets are the 8-row stride;
// the leading one would step to the next 64 of M or N, which an m64 or n64
// product does not reach.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return gmma_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}
template <int J, int N>
__device__ __forceinline__ void fence_acc(float (&acc)[J][N]) {
#pragma unroll
  for (int j = 0; j < J; ++j) fence_regs(acc[j]);
}

// d (64 x 64, f32) += A (64 x 16) . B (16 x 64), bf16 from shared memory;
// TA / TB: A M-major / B N-major (the transpose bits). Thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 i + 2 (t % 4) (+ 1): d[4 i + 0, 1] and, 8 rows down, d[4 i + 2, 3].
template <int TA, int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// the same for a 64 x 32 tile: columns 8 i + 2 (t % 4) (+ 1), i < 4
template <int TA, int TB>
__device__ __forceinline__ void wgmma32(float (&d)[16], uint64_t a,
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of (row, col) in a 64-column box stored with the 128-byte
// swizzle (TMA's and wgmma's layout): 16-byte chunk col / 8 of the row
// moves to chunk (col / 8) ^ (row % 8)
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// C (M, N) = A (M, K) . B + bias (N,) f32 when given, rounded once to
// bf16. a_map: A, boxes of 64 columns x 128 rows; b_map: with TB = 0 the
// weight (N, K), boxes of 64 x BN; with TB = 1 the weight (K, N), boxes of
// 64 x 64; c_map: C, boxes of 64 x 64. Block (s, g) owns columns
// [s BN, s BN + BN) and the row tiles g, g + gridDim.y, ...
//
// Shared memory, from a 1024-byte boundary: the resident weight slice
// (boxes(K) boxes of BN rows when TB = 0; boxes(K) x BN / 64 boxes of 64
// rows when TB = 1), `stages` ring slots of one A box, two 64 x BN
// staging tiles of C (one a warpgroup, as BN / 64 swizzled boxes), the
// mbarriers; with SUMS, then 8 BN floats (sums_bytes). With STREAM no
// resident slice: a ring slot holds one A box and, after it, the
// weight's boxes of the same K step (one box of BN rows when TB = 0, BN /
// 64 boxes of 64 rows when TB = 1: BN 128 bytes either way).
//
// SUMS: part (2, C, N) f32, C = 2 ceil(M / 128) chunks of 64 rows (chunk
// 2 t + w: warpgroup w's rows of row tile t): part[0][c][n] = the sum of
// the rounded C over the chunk's rows < M, part[1][c][n] that of its
// squares. Thread t of a warpgroup adds column t % 64 of each staging box
// over the rows [32 (t / 64), + 32) in order, then the two halves add.
template <int BN, int TB, int SUMS = 0, int STREAM = 0>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_rows_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ CUtensorMap c_map,
                     const float* __restrict__ bias, int M, int N, int K,
                     int stages, float* __restrict__ part) {
  constexpr int NJ = BN / 64;
  // a ring slot: A's box, then (STREAM) the weight's boxes of its K step
  constexpr uint32_t kSlot = STREAM ? kATile + BN * kBK * 2 : kATile;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int kblocks = boxes(K);
  const uint32_t b_s = base;
  const uint32_t a_s =
      STREAM ? base : b_s + (uint32_t)BN * kblocks * kBK * 2;
  const uint32_t c_s = a_s + stages * kSlot;
  const uint32_t full = c_s + 2 * 64 * BN * 2;
  const uint32_t empty = full + 8 * stages, b_full = empty + 8 * stages;
  const int tiles = (M + kBM - 1) / kBM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // each consumer warp
    }
    mbar_init(b_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer: one thread issues every load
    if (lane == 0) {
      if constexpr (!STREAM) {
        mbar_expect_tx(b_full, (uint32_t)BN * kblocks * kBK * 2);
        for (int kb = 0; kb < kblocks; ++kb) {
          if constexpr (TB == 0) {
            tma_load(b_s + kb * BN * 128, &b_map, b_full, kb * kBK, n0);
          } else {
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              tma_load(b_s + (kb * NJ + j) * kBox, &b_map, b_full,
                       n0 + 64 * j, kb * kBK);
          }
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, kSlot);
          tma_load(a_s + stage * kSlot, &a_map, full + 8 * stage, kb * kBK,
                   t * kBM);
          if constexpr (STREAM) {
            const uint32_t w = a_s + stage * kSlot + kATile;
            if constexpr (TB == 0) {
              tma_load(w, &b_map, full + 8 * stage, kb * kBK, n0);
            } else {
#pragma unroll
              for (int j = 0; j < NJ; ++j)
                tma_load(w + j * kBox, &b_map, full + 8 * stage,
                         n0 + 64 * j, kb * kBK);
            }
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile
  const int wg = warp >> 2, tid = threadIdx.x & 127;
  const int r = (warp & 3) * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const uint32_t c_wg = c_s + wg * 64 * BN * 2;
  uint8_t* c_gen = smem_raw + (c_wg - raw);
  if constexpr (!STREAM) mbar_wait(b_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  float acc[NJ][32];
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    fence_acc(acc);
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(full + 8 * stage, phase);
      wgmma_fence();
      const uint32_t a = a_s + stage * kSlot + wg * 64 * 128;
      // the weight's boxes of this K step: resident, or in the ring slot
      const uint32_t w = STREAM ? a_s + stage * kSlot + kATile
                                : b_s + kb * BN * 128;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = desc_k(a + kk * 32);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if constexpr (TB == 0)
            wgmma64<0, 0>(acc[j], da, desc_k(w + j * 64 * 128 + kk * 32));
          else
            wgmma64<0, 1>(acc[j], da, desc_mn(w + j * kBox + kk * 2048));
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: bias, one rounding, the 128-byte swizzle TMA reads back
    if (tid == 0) bulk_wait_read();  // the last tile's store left staging
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = j * 64 + i * 8 + cq;
        const bool in = bias && n0 + col < N;  // N is even: so is col + 1
        const float b0 = in ? bias[n0 + col] : 0.f;
        const float b1 = in ? bias[n0 + col + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          *reinterpret_cast<uint32_t*>(c_gen + j * kBox +
                                       swz(row, i * 8 + cq)) =
              pack2(acc[j][4 * i + 2 * h] + b0,
                    acc[j][4 * i + 2 * h + 1] + b1);
        }
      }
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (n0 + 64 * j < N)
          tma_store(&c_map, c_wg + j * kBox, n0 + 64 * j, t * kBM + wg * 64);
      bulk_commit();
    }
    if constexpr (SUMS) {
      const int c = tid & 63, hh = tid >> 6;
      const int row0 = 32 * hh;
      const int rows = min(32, M - (t * kBM + wg * 64 + row0));
      float* red = reinterpret_cast<float*>(smem_raw + (b_full + 16 - raw)) +
                   wg * 4 * BN;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
        for (int rr = 0; rr < rows; ++rr) {
          const float y = __bfloat162float(*reinterpret_cast<const bf16*>(
              c_gen + j * kBox + swz(row0 + rr, c)));
          s1 += y;
          s2 += y * y;
        }
        red[(2 * hh) * BN + 64 * j + c] = s1;
        red[(2 * hh + 1) * BN + 64 * j + c] = s2;
      }
      bar_sync(1 + wg, 128);
      if (hh == 0) {
        const size_t chunks = 2 * (size_t)tiles, chunk = 2 * t + wg;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 64 * j + c, o = 64 * j + c;
          if (col < N) {
            part[chunk * N + col] = red[o] + red[2 * BN + o];
            part[(chunks + chunk) * N + col] = red[BN + o] + red[3 * BN + o];
          }
        }
      }
    }
  }
  if (tid == 0) bulk_wait();
}

// One group's partial of dW (N, K) = G^T . X over its 64-row chunks, G
// (rows, N) and X (rows, K) bf16, at part + group * (N K + N) (with
// `sums`) or group * N K; with `sums` the blocks of column tile 0 also
// write the column sums of G (the bias gradient) after dW. g_map, x_map:
// boxes of 64 columns x 64 rows. A block owns rows [64 bx, 64 bx + 64) and
// columns [TK by, TK by + TK) of dW, TK = 64 TJ. Shared memory: `stages`
// ring slots of one G box and TJ X boxes, 128 floats, the mbarriers.
template <int TJ>
__global__ void __launch_bounds__(kWgradThreads)
    wgrad_kernel(const __grid_constant__ CUtensorMap g_map,
                 const __grid_constant__ CUtensorMap x_map,
                 float* __restrict__ part, int rows, int N, int K,
                 int stages, int want_sums) {
  constexpr uint32_t kStage = (1 + TJ) * kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                        stages * kStage);
  const uint32_t full = base + stages * kStage + 128 * 4;
  const uint32_t empty = full + 8 * stages;
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64 * TJ;
  const int chunks = (rows + 63) / 64;
  const int c0 = (int)((long long)blockIdx.z * chunks / gridDim.z);
  const int c1 = (int)((long long)(blockIdx.z + 1) * chunks / gridDim.z);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int c = c0; c < c1; ++c) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t s = base + stage * kStage, bar = full + 8 * stage;
        mbar_expect_tx(bar, kStage);
        tma_load(s, &g_map, bar, n0, c * 64);
#pragma unroll
        for (int j = 0; j < TJ; ++j)
          tma_load(s + (1 + j) * kBox, &x_map, bar, k0 + 64 * j, c * 64);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroup; with `sums`, thread t also adds column t % 64
  // of G over the rows [32 (t / 64), 32 (t / 64) + 32) of each chunk
  const int tid = threadIdx.x;
  const bool sums = want_sums && blockIdx.y == 0;
  const int sn = tid & 63, sr = (tid >> 6) * 32;
  float bsum = 0.f;
  float acc[TJ][32];
#pragma unroll
  for (int j = 0; j < TJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  fence_acc(acc);
  int stage = 0;
  uint32_t phase = 0;
  for (int c = c0; c < c1; ++c) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t s = base + stage * kStage;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_mn(s + kk * 2048);
#pragma unroll
      for (int j = 0; j < TJ; ++j)
        wgmma64<1, 1>(acc[j], da, desc_mn(s + (1 + j) * kBox + kk * 2048));
    }
    wgmma_commit();
    if (sums) {  // rows in order; rows past the end are TMA's zeros
      const uint8_t* g = smem_raw + (s - raw);
#pragma unroll 8
      for (int rr = sr; rr < sr + 32; ++rr)
        bsum += __bfloat162float(
            *reinterpret_cast<const bf16*>(g + swz(rr, sn)));
    }
    wgmma_wait();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  float* out = part + (size_t)blockIdx.z *
                          ((size_t)N * K + (want_sums ? N : 0));
  const int row = n0 + warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < TJ; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = k0 + 64 * j + 8 * i + cq;  // K is even: so is col + 1
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row + 8 * h < N && col < K)
          *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * K + col) =
              make_float2(acc[j][4 * i + 2 * h], acc[j][4 * i + 2 * h + 1]);
    }
  if (sums) {
    red[tid] = bsum;
    bar_sync(1, 128);
    if (tid < 64 && n0 + tid < N)
      out[(size_t)N * K + n0 + tid] = red[tid] + red[tid + 64];
  }
}

// dw[i] (i < nk) and db[i - nk] (nk <= i < nk + N) = the sum over groups
// g, in order, of part[g * (nk + N) + i]
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

// ---------------------------------------------------------------------------
// host side: tensor maps and launches
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no
// -lcuda)
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// TMA's rules for a row-major bf16 matrix: a 16-byte aligned base and a
// row stride that is a multiple of 16 bytes (8 columns)
inline bool tma_ok(const void* p, int rows, int cols) {
  return p && rows > 0 && cols > 0 && cols % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a row-major (rows, cols) bf16 matrix in boxes of 64 columns x box_rows
// rows, 128-byte swizzle; what a box reads past the end loads as zeros
inline bool make_map(CUtensorMap* map, const void* p, int rows, int cols,
                     int box_rows) {
  const EncodeTiled encode = encoder();
  if (!encode || !tma_ok(p, rows, cols)) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(p), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `mats` row-major (rows, cols) bf16 matrices back to back, in boxes of 64
// columns x box_rows rows of one matrix, 128-byte swizzle: a box that
// reaches past a matrix's last row loads zeros there and stores nothing
// there, so a box never mixes two matrices
inline bool make_map3(CUtensorMap* map, const void* p, int mats, int rows,
                      int cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (!encode || mats <= 0 || !tma_ok(p, rows, cols)) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(p), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// shared memory the SUMS epilogue adds: its 16-byte alignment and the
// per-warpgroup column sums
__host__ __device__ constexpr size_t sums_bytes(int BN) {
  return 16 + 8 * (size_t)BN * 4;
}

// ring stages that fit beside a (BN, K) weight slice, its staging tiles,
// the alignment slack, the barriers and `extra` bytes
inline int gemm_stages(int BN, int K, size_t extra = 0) {
  const long long left = (long long)kSmemMax -
                         (long long)BN * boxes(K) * kBK * 2 -
                         2LL * 64 * BN * 2 - 1024 - 16 * kMaxStages - 8 -
                         (long long)extra;
  const long long n = left / (long long)kATile;
  return (int)(n < kMaxStages ? n : kMaxStages);
}

// ring stages of the STREAM route (no resident slice: a slot holds A's box
// and the weight's BN x 64 box): 4 at BN 192, 6 at 128 and 64
inline int gemm_stream_stages(int BN) {
  const long long left = (long long)kSmemMax - 2LL * 64 * BN * 2 - 1024 -
                         16 * kMaxStages - 8;
  const long long n = left / ((long long)kATile + (long long)BN * kBK * 2);
  return (int)(n < kMaxStages ? n : kMaxStages);
}

template <int BN, int TB, int SUMS = 0, int STREAM = 0>
cudaError_t gemm_launch(const void* a, const void* b, const float* bias,
                        void* c, int M, int N, int K, int stages,
                        cudaStream_t s, float* part = nullptr) {
  CUtensorMap am, bm, cm;
  const bool ok = make_map(&am, a, M, K, kBM) &&
                  (TB == 0 ? make_map(&bm, b, N, K, BN)
                           : make_map(&bm, b, K, N, 64)) &&
                  make_map(&cm, c, M, N, 64);
  if (!ok) return cudaErrorInvalidValue;
  const size_t smem =
      (STREAM ? (size_t)stages * BN * kBK * 2
              : (size_t)BN * boxes(K) * kBK * 2) +
      (size_t)stages * kATile + 2 * 64 * BN * 2 + 16 * stages + 8 + 1024 +
      (SUMS ? sums_bytes(BN) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_rows_kernel<BN, TB, SUMS, STREAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (M + kBM - 1) / kBM, slices = (N + BN - 1) / BN;
  int per = sm_count() / slices;
  per = per < 1 ? 1 : (per > tiles ? tiles : per);
  gemm_rows_kernel<BN, TB, SUMS, STREAM>
      <<<dim3(slices, per), kGemmThreads, smem, s>>>(am, bm, cm, bias, M, N,
                                                     K, stages, part);
  return cudaGetLastError();
}

// The route gemm takes for an (N, K) weight: the widest resident slice
// (192, 128 or 64 columns) that divides N and leaves room for 4 ring
// stages, 64 columns (the last slice clipped) where none divides N: BN;
// where even 64 resident columns leave fewer than 4 stages (K above
// 1,152), the streamed slice, 128 columns where they divide N, else 64:
// -BN; 0 for widths gemm refuses (N or K not a multiple of 8).
// ops/hopper_gemm.py gemm_route mirrors it.
inline int gemm_route(int N, int K) {
  if (N <= 0 || K <= 0 || N % 8 || K % 8) return 0;
  const int slices[3] = {192, 128, 64};
  for (int i = 0; i < 3; ++i) {
    const int bn = slices[i];
    if ((N % bn == 0 || bn == 64) && gemm_stages(bn, K) >= 4) return bn;
  }
  return N % 128 == 0 ? -128 : -64;
}

// C (M, N) = A (M, K) . W^T + bias for a weight W (N, K) (TB = 0), or
// A . W for W (K, N) (TB = 1), on gemm_route's slice. N and K multiples
// of 8. A template, so that only the libraries that call it hold its
// kernels.
template <int = 0>
cudaError_t gemm(const void* a, const void* w, int tb, const void* bias,
                 void* c, int M, int N, int K, cudaStream_t s) {
  const int route = gemm_route(N, K);
  if (M <= 0 || route == 0) return cudaErrorInvalidValue;
  const float* fb = static_cast<const float*>(bias);
#define GEMM(BN, STREAM, STAGES)                                            \
  return tb ? gemm_launch<BN, 1, 0, STREAM>(a, w, fb, c, M, N, K, STAGES, s) \
            : gemm_launch<BN, 0, 0, STREAM>(a, w, fb, c, M, N, K, STAGES, s);
  if (route == 192) GEMM(192, 0, gemm_stages(192, K))
  if (route == 128) GEMM(128, 0, gemm_stages(128, K))
  if (route == 64) GEMM(64, 0, gemm_stages(64, K))
  if (route == -128) GEMM(128, 1, gemm_stream_stages(128))
  GEMM(64, 1, gemm_stream_stages(64))
#undef GEMM
}

// gemm's C (M, N) = A . W for W (K, N), no bias, and its 64-row chunks'
// column sums of C and C^2 into part (2, 2 ceil(M / 128), N) f32
// (gemm_rows_kernel's SUMS). The slice rule of gemm with room for the
// sums. A template, so that only the libraries that call it hold its
// kernels.
template <int = 0>
cudaError_t gemm_sums(const void* a, const void* w, void* c, float* part,
                      int M, int N, int K, cudaStream_t s) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || !part)
    return cudaErrorInvalidValue;
#define GEMM(BN)                                                           \
  if ((N % BN == 0 || BN == 64) && gemm_stages(BN, K, sums_bytes(BN)) >= 4) \
    return gemm_launch<BN, 1, 1>(a, w, nullptr, c, M, N, K,                \
                                 gemm_stages(BN, K, sums_bytes(BN)), s,    \
                                 part);
  GEMM(192)
  GEMM(128)
  GEMM(64)
#undef GEMM
  return cudaErrorInvalidValue;
}

// column boxes a wgrad block owns: 3 where they divide K's boxes, else 2,
// 1 for K <= 64 (ops/hopper_gemm.py wgrad_tile_boxes)
inline int wgrad_tj(int K) {
  const int b = boxes(K);
  return b == 1 ? 1 : (b % 3 == 0 ? 3 : 2);
}

template <int TJ>
cudaError_t wgrad_launch(const CUtensorMap& gm, const CUtensorMap& xm,
                         float* part, int groups, int rows, int N, int K,
                         int sums, cudaStream_t s) {
  const int stages = TJ == 3 ? 3 : 4;  // about 100 KB: two blocks an SM
  const size_t smem = (size_t)stages * (1 + TJ) * kBox + 128 * 4 +
                      16 * stages + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<TJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  wgrad_kernel<TJ><<<dim3(boxes(N), (boxes(K) + TJ - 1) / TJ, groups),
                     kWgradThreads, smem, s>>>(gm, xm, part, rows, N, K,
                                               stages, sums);
  return cudaGetLastError();
}

// weight gradient dw (N, K) = G^T X of G (rows, N) and X (rows, K), and,
// when db is given, the bias gradient db (N,) = the column sums of G;
// part: groups * (N K + N) f32 (N K without db), 1 <= groups <=
// ceil(rows / 64). N and K multiples of 8.
inline cudaError_t wgrad(const void* g, const void* x, float* part,
                         int groups, void* dw, void* db, int rows, int N,
                         int K, cudaStream_t s) {
  CUtensorMap gm, xm;
  if (groups < 1 || groups > (rows + 63) / 64 ||
      !make_map(&gm, g, rows, N, 64) || !make_map(&xm, x, rows, K, 64))
    return cudaErrorInvalidValue;
  const int sums = db != nullptr;
  const int tj = wgrad_tj(K);
  cudaError_t err =
      tj == 3   ? wgrad_launch<3>(gm, xm, part, groups, rows, N, K, sums, s)
      : tj == 2 ? wgrad_launch<2>(gm, xm, part, groups, rows, N, K, sums, s)
                : wgrad_launch<1>(gm, xm, part, groups, rows, N, K, sums, s);
  if (err != cudaSuccess) return err;
  const size_t nk = (size_t)N * K;
  const int nb = sums ? N : 0;
  reduce_kernel<<<(int)((nk + nb + 255) / 256), 256, 0, s>>>(
      part, groups, nk, nb, static_cast<float*>(dw), static_cast<float*>(db));
  return cudaGetLastError();
}

}  // namespace hg
}  // namespace
