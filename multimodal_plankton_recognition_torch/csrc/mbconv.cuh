// Shared pieces of the MBConv kernels (csrc/mbconv_fwd.cu, mbconv_bwd.cu):
// bf16 rounding, the activations, the fixed-order reduction over partial
// sums, the depthwise passes' tiles and their 16-byte halo loader, and the
// squeeze-excite chain's steps.
//
// Layouts: activations NHWC, row-major (pixel n = (b*H + h)*W + w, channel
// fastest), bf16; weight matrices bf16 (cin, mid), (mid, r), (r, mid),
// (mid, cout), (k*k, mid); BatchNorm scales, biases and statistics f32.
// Every sum over pixels is taken in a fixed order: per-block partial sums
// into device scratch, then reduce_kernel adds them in index order. No
// float atomics, so a run repeats bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// internal linkage: the forward and backward libraries each hold their own
// copy, and neither exports these symbols to the other
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;  // flax.linen.BatchNorm's epsilon
constexpr int CC = 32;         // channels of a depthwise block (one warp)
constexpr int kGroups = kThreads / CC;  // pixel groups of a depthwise block

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) {
  return __float2bfloat16_rn(v);
}
// round through bf16
__device__ __forceinline__ float rb(float v) { return f32(to_bf(v)); }
__device__ __forceinline__ float sigm(float z) { return 1.f / (1.f + expf(-z)); }
__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }
__device__ __forceinline__ float dsilu(float z) {
  const float s = sigm(z);
  return s * (1.f + z * (1.f - s));
}
__device__ __forceinline__ float inv_std(float v) {
  return 1.f / sqrtf(v + kEps);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ inline int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}
__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// ---------------------------------------------------------------------------
// reduction of partial sums, in index order
// ---------------------------------------------------------------------------

// part: nar arrays of (T, C) f32, consecutive. With n > 0 (nar = 2: sums
// of y and y^2 over n values) writes out0 = mean, out1 = E[y^2] - mean^2;
// with n == 0 writes the plain sums, array a to out_a (out1 unused when
// nar = 1). Block: 32 columns x 32 lanes; lane l adds rows l, l + 32, ...
__global__ void __launch_bounds__(1024)
reduce_kernel(const float* __restrict__ part, int nar, int T, int C,
              float* __restrict__ out0, float* __restrict__ out1, float n) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x % 32, l = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  float sums[2] = {0.f, 0.f};
  for (int a = 0; a < nar; ++a) {
    float acc = 0.f;
    if (c < C)
      for (int t = l; t < T; t += 32) acc += part[((size_t)a * T + t) * C + c];
    red[l][tx] = acc;
    __syncthreads();
    if (l == 0)
      for (int q = 0; q < 32; ++q) sums[a] += red[q][tx];
    __syncthreads();
  }
  if (l == 0 && c < C) {
    if (n > 0.f) {
      const float m = sums[0] / n;
      out0[c] = m;
      out1[c] = sums[1] / n - m * m;
    } else {
      out0[c] = sums[0];
      if (nar > 1) out1[c] = sums[1];
    }
  }
}

inline void reduce(const float* part, int nar, int T, int C, float* out0,
                   float* out1, float n, cudaStream_t stream) {
  reduce_kernel<<<cdiv(C, 32), 1024, 0, stream>>>(part, nar, T, C, out0, out1,
                                                  n);
}

// ---------------------------------------------------------------------------
// depthwise tiles (kernels 13 and 16): a block owns (sample b, output rows
// r0 .. r0 + kDwTH, output columns w0 .. w0 + tw, channels c0 .. c0 +
// CC); the halo adds P rows and columns on each side
// ---------------------------------------------------------------------------

constexpr int kDwTH = 8;   // output rows of a block
constexpr int kDwTW = 32;  // output columns of a block, at most

// The depthwise sizes the kernels are instantiated for: every odd k from
// 1 to kMaxK (ops/mbconv.py MAX_KERNEL_SIZE); up to kRegK a thread holds
// its channels' k x k weights in registers, above it reads them where
// used. Even k is refused: the reference's own plain version pads k / 2 on
// both sides, so its output grows by a row and a column there.
// What sets kMaxK is registers, not shared memory (a k 11 halo of two
// buffers takes 99 KB): kernel 16's first depthwise pass keeps k^2 f32
// partial sums of dwdw a thread beside its other state, 121 of a
// thread's 255 registers at k 11.
constexpr int kMaxK = 11;
constexpr int kRegK = 9;

__host__ __device__ inline bool kernel_size_ok(int k) {
  return k >= 1 && k <= kMaxK && k % 2 == 1;
}

// f(std::integral_constant<int, k>{}) for an odd k of 1 .. kMaxK (the
// caller checked kernel_size_ok)
template <class F>
cudaError_t with_k(int k, F f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 9: return f(std::integral_constant<int, 9>{});
    default: return f(std::integral_constant<int, 11>{});
  }
}

struct DwTile {
  int B, H, W, mid, K, P, tw;
  bool expand;
  __host__ __device__ int row_tiles() const { return cdiv(H, kDwTH); }
  __host__ __device__ int col_tiles() const { return cdiv(W, tw); }
  __host__ __device__ int tiles() const {
    return B * row_tiles() * col_tiles();
  }
  __host__ __device__ int hr() const { return kDwTH + 2 * P; }
  __host__ __device__ int hc() const { return tw + 2 * P; }
  // a zero-padded (hr, hc, CC) bf16 halo: a1 or dy2
  __host__ __device__ size_t halo_bytes() const {
    return align16((size_t)hr() * hc() * CC * 2);
  }
  // y1 of the output pixels (kDwTH, tw, CC) bf16, with an expand
  __host__ __device__ size_t center_bytes() const {
    return expand ? align16((size_t)kDwTH * tw * CC * 2) : 0;
  }
};

// the width of a column tile: W in the fewest tiles of at most kDwTW
// (ops/mbconv.py dw_tiles)
inline DwTile dw_tile(int B, int H, int W, int mid, int k, bool expand) {
  const int n = cdiv(W, kDwTW);
  return DwTile{B, H, W, mid, k, k / 2, cdiv(W, n), expand};
}

// 16 bytes from global to shared memory, asynchronously; zeros when
// !valid (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The block's rows [r0 - P0, r0 - P0 + nr) x columns [w0 - P0, w0 - P0 +
// nc) of a per-channel NHWC tensor v (mid channels) into dst[(rr * nc +
// cc) * CC + c], 8 channels (16 bytes) a copy, zeros outside the image
// and for channels >= mid. Asynchronous: cp_wait_all and a barrier before
// use.
__device__ __forceinline__ void load_box(const bf16* __restrict__ v,
                                         const DwTile& g, int b, int r0,
                                         int w0, int c0, int P0, int nr,
                                         int nc, bf16* dst) {
  for (int e = threadIdx.x; e < nr * nc * (CC / 8); e += kThreads) {
    const int q = e % (CC / 8), pix = e / (CC / 8);
    const int rr = pix / nc, cc = pix % nc;
    const int r = r0 - P0 + rr, w = w0 - P0 + cc, ch = c0 + 8 * q;
    const bool valid = r >= 0 && r < g.H && w >= 0 && w < g.W && ch < g.mid;
    cp16(dst + pix * CC + 8 * q,
         valid ? v + (((size_t)b * g.H + r) * g.W + w) * g.mid + ch : v,
         valid);
  }
}

// ---------------------------------------------------------------------------
// squeeze-excite
// ---------------------------------------------------------------------------

// grid (B, mid / 32, arrays): out[(a B + b) mid + c] = the sum over
// group b's rows [b tps, min(T, b tps + tps)), in a fixed order, of
// part[(a T + t) mid + c] (arrays of (T, mid) f32: the per-tile sums of a
// pass, group b a sample's tps tiles; or any partials in groups of tps
// rows). Block: 32 channels x 32 lanes; lane l adds rows l, l + 32, ...
// of the group, then lane 0 the 32 lanes in order.
__global__ void __launch_bounds__(1024)
    tile_sums_kernel(const float* __restrict__ part, int T, int tps, int mid,
                     float* __restrict__ out) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x % 32, l = threadIdx.x / 32;
  const int b = blockIdx.x, a = blockIdx.z, c = blockIdx.y * 32 + tx;
  const int n = min(tps, T - b * tps);
  float acc = 0.f;
  if (c < mid)
    for (int t = l; t < n; t += 32)
      acc += part[((size_t)a * T + (size_t)b * tps + t) * mid + c];
  red[l][tx] = acc;
  __syncthreads();
  if (l == 0 && c < mid) {
    float s = 0.f;
    for (int q = 0; q < 32; ++q) s += red[q][tx];
    out[((size_t)a * gridDim.x + b) * mid + c] = s;
  }
}

// The SE chain's three steps, shared so that every kernel that computes
// them (kernel 14, and kernel 15 recomputing them) gets the same bits:
// s = bf16(mean a2) of sample b, channel c, from the per-split sums sq
// (B, S, mid)
__device__ __forceinline__ float se_s(const float* __restrict__ sq, int S,
                                      int HW, int b, int mid, int c) {
  float t = 0.f;
  for (int sp = 0; sp < S; ++sp) t += sq[((size_t)b * S + sp) * mid + c];
  return rb(t / (float)HW);
}
// su = bf16(s . wr + br) of column j, by one warp: each lane a strided
// partial, then the warp's sum (every lane returns it)
__device__ __forceinline__ float se_su(const float* s,
                                       const bf16* __restrict__ wr,
                                       const float* __restrict__ br, int mid,
                                       int r, int j, int lane) {
  float part = 0.f;
  for (int c = lane; c < mid; c += 32)
    part = fmaf(s[c], f32(wr[(size_t)c * r + j]), part);
  return rb(warp_sum(part) + br[j]);
}
// se = bf16(sigmoid(bf16(ub . we + be))) of channel c
__device__ __forceinline__ float se_out(const float* ub,
                                        const bf16* __restrict__ we,
                                        const float* __restrict__ be, int mid,
                                        int r, int c) {
  float acc = 0.f;
  for (int j = 0; j < r; ++j)
    acc = fmaf(ub[j], f32(we[(size_t)j * mid + c]), acc);
  return rb(sigm(rb(acc + be[c])));
}

// The SE chain of sample b into shared memory: s = bf16(mean a2) (mid),
// su = bf16(s . wr + br) (r), ub = bf16(SiLU(su)) (r), se =
// bf16(sigmoid(bf16(ub . we + be))) (mid). Ends with a barrier.
__device__ void se_sample(const float* __restrict__ sq, int S, int HW, int b,
                          const bf16* __restrict__ wr,
                          const float* __restrict__ br,
                          const bf16* __restrict__ we,
                          const float* __restrict__ be, int mid, int r,
                          float* s, float* su, float* ub, float* se) {
  for (int c = threadIdx.x; c < mid; c += kThreads)
    s[c] = se_s(sq, S, HW, b, mid, c);
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = warp; j < r; j += kThreads / 32) {
    const float v = se_su(s, wr, br, mid, r, j, lane);
    if (lane == 0) {
      su[j] = v;
      ub[j] = rb(silu(v));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < mid; c += kThreads)
    se[c] = se_out(ub, we, be, mid, r, c);
  __syncthreads();
}

}  // namespace
