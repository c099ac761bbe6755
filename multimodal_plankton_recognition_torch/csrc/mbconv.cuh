// Shared pieces of the MBConv kernels (csrc/mbconv_fwd.cu, mbconv_bwd.cu):
// bf16 rounding, the activations, a tiled f32 product on CUDA cores,
// per-column partial sums, the fixed-order reduction over partials, and the
// depthwise tile loaders (a1 = SiLU(BN1(x . wexp)) recomputed over a row
// tile and its halo, and a zero-padded tile of a per-channel tensor).
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

// internal linkage: the forward and backward libraries each hold their own
// copy, and neither exports these symbols to the other
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;  // flax.linen.BatchNorm's epsilon
constexpr int BM = 64;         // rows (pixels) of a product tile
constexpr int BN = 64;         // columns of a product tile
constexpr int BK = 16;         // contraction step of a product tile
constexpr int kPad = 4;        // smem row padding of the A tile (banks)
constexpr int CC = 32;         // channels of a depthwise block (one warp)
constexpr int TH = 8;          // output rows of a depthwise block
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
// spatial splits of a sample in squeeze_kernel
inline int squeeze_splits(int HW) { return cdiv(HW, 1024); }

// ---------------------------------------------------------------------------
// tiled product on CUDA cores: a 64 x 64 output tile per block of 256
// threads, 4 x 4 outputs per thread, f32 accumulation
// ---------------------------------------------------------------------------

struct Tile {
  float a[BK][BM + kPad];  // a[kk][m]
  float b[BK][BN];         // b[kk][j]
};

// thread (ty, tx) owns rows ty*4 .. +4 and columns tx*4 .. +4 of the tile
__device__ __forceinline__ int tile_row() { return (threadIdx.x / 16) * 4; }
__device__ __forceinline__ int tile_col() { return (threadIdx.x % 16) * 4; }

__device__ __forceinline__ void tile_fma(const Tile& s, float acc[4][4]) {
  const int r = tile_row(), c = tile_col();
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = s.a[kk][r + i];
      b[i] = s.b[kk][c + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] = sum_k A(m, k) * Bw(k, n0 + j') over k < K, for tile rows
// m < mlen and columns n0 + j' < ncols; A(m, k) and Bw(k, n) are functors
// called only inside those bounds (out-of-range entries are 0).
template <class ALoad, class BLoad>
__device__ void gemm_rows(Tile& s, int mlen, int K, int n0, int ncols,
                          ALoad aload, BLoad bload, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BK * BM; e += kThreads) {
      const int kk = e % BK, m = e / BK;
      s.a[kk][m] = (m < mlen && k0 + kk < K) ? aload(m, k0 + kk) : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += kThreads) {
      const int j = e % BN, kk = e / BN;
      s.b[kk][j] = (k0 + kk < K && n0 + j < ncols) ? bload(k0 + kk, n0 + j)
                                                   : 0.f;
    }
    __syncthreads();
    tile_fma(s, acc);
    __syncthreads();
  }
}

// Per-column sums over the tile's rows of two values f(i, j) -> (u, v)
// held by every thread (val0 / val1, 0 for rows or columns outside the
// tile); thread t < BN writes part0[t], part1[t] (null: skipped) for
// column t. Fixed order: rows within a thread, then the 16 row groups.
__device__ void tile_col_sums(const float val0[4][4], const float val1[4][4],
                              float* part0, float* part1, int n0, int ncols) {
  __shared__ float red[2][16][BN];
  const int g = threadIdx.x / 16, c = tile_col();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float u = 0.f, v = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u += val0[i][j];
      v += val1[i][j];
    }
    red[0][g][c + j] = u;
    red[1][g][c + j] = v;
  }
  __syncthreads();
  if (threadIdx.x < BN && n0 + (int)threadIdx.x < ncols) {
    float u = 0.f, v = 0.f;
    for (int q = 0; q < 16; ++q) {
      u += red[0][q][threadIdx.x];
      v += red[1][q][threadIdx.x];
    }
    part0[n0 + threadIdx.x] = u;
    if (part1) part1[n0 + threadIdx.x] = v;
  }
  __syncthreads();
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
// depthwise tiles: a block owns (sample b, output rows r0 .. r0 + TH,
// channels c0 .. c0 + CC); thread (g, c): channel c0 + c, pixel group g
// ---------------------------------------------------------------------------

struct DwGeom {
  int B, H, W, cin, mid, K, P;
  bool expand;
  __host__ __device__ int row_tiles() const { return (H + TH - 1) / TH; }
  __host__ __device__ int halo_rows() const { return TH + 2 * P; }
  __host__ __device__ int halo_cols() const { return W + 2 * P; }
  // shared-memory carve-up, bytes: x rows of the halo (bf16), the wexp
  // chunk (f32), a1 over the halo (bf16), a second padded tile (bf16,
  // dy2 in the backward), y1 of the output rows (bf16)
  __host__ __device__ size_t xs_bytes() const {
    return expand ? align16((size_t)halo_rows() * W * cin * 2) : 0;
  }
  __host__ __device__ size_t ws_bytes() const {
    return expand ? align16((size_t)cin * CC * 4) : 0;
  }
  __host__ __device__ size_t pad_bytes() const {
    return align16((size_t)halo_rows() * halo_cols() * CC * 2);
  }
  __host__ __device__ size_t y1_bytes() const {
    return expand ? align16((size_t)TH * W * CC * 2) : 0;
  }
};

// Zero-padded tile of a per-channel NHWC tensor v (C = mid channels):
// dst[(rr * halo_cols + w + P) * CC + c] = v[b, r0 - P + rr, w, c0 + c],
// zero outside the image and for channels >= mid. Ends with a barrier.
__device__ void load_padded(const bf16* __restrict__ v, const DwGeom& g,
                            int b, int r0, int c0, bf16* dst) {
  const int hr = g.halo_rows(), hc = g.halo_cols();
  for (int e = threadIdx.x; e < hr * hc * CC; e += kThreads) {
    const int c = e % CC, pix = e / CC;
    const int rr = pix / hc, cc = pix % hc;
    const int r = r0 - g.P + rr, w = cc - g.P;
    bf16 val = to_bf(0.f);
    if (r >= 0 && r < g.H && w >= 0 && w < g.W && c0 + c < g.mid)
      val = v[(((size_t)b * g.H + r) * g.W + w) * g.mid + c0 + c];
    dst[e] = val;
  }
  __syncthreads();
}

// a1 over the row tile and its halo into a1s (zero-padded, as
// load_padded): with an expand, y1 = bf16(x . wexp) from the x rows and
// the wexp chunk staged in shared memory, z1 = bf16(xhat1 * g1 + b1),
// a1 = bf16(SiLU(z1)); without, a1 = x. With y1s, also keeps y1 of the
// output rows (y1s[(row * W + w) * CC + c]). Ends with a barrier.
__device__ void load_a1(const bf16* __restrict__ x,
                        const bf16* __restrict__ wexp,
                        const float* __restrict__ g1,
                        const float* __restrict__ b1,
                        const float* __restrict__ mv1, const DwGeom& g, int b,
                        int r0, int c0, bf16* xs, float* ws, bf16* a1s,
                        bf16* y1s) {
  if (!g.expand) {
    load_padded(x, g, b, r0, c0, a1s);
    return;
  }
  const int hr = g.halo_rows(), hc = g.halo_cols(), W = g.W, cin = g.cin;
  const int rlo = max(r0 - g.P, 0), rhi = min(r0 + TH + g.P, g.H);
  const int nrows = rhi - rlo;  // valid halo rows, from rlo
  for (int e = threadIdx.x; e < hr * hc * CC; e += kThreads)
    a1s[e] = to_bf(0.f);
  const bf16* xsrc = x + ((size_t)b * g.H + rlo) * W * cin;
  for (int e = threadIdx.x; e < nrows * W * cin; e += kThreads)
    xs[e] = xsrc[e];
  for (int e = threadIdx.x; e < cin * CC; e += kThreads) {
    const int c = e % CC, i = e / CC;
    ws[e] = c0 + c < g.mid ? f32(wexp[(size_t)i * g.mid + c0 + c]) : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x % CC, grp = threadIdx.x / CC;
  const int ch = c0 + c;
  if (ch < g.mid) {
    const float m1 = mv1[ch], inv1 = inv_std(mv1[g.mid + ch]);
    const float gg = g1[ch], bb = b1[ch];
    for (int pix = grp; pix < nrows * W; pix += kGroups) {
      const bf16* xp = xs + (size_t)pix * cin;
      float acc = 0.f;
      for (int i = 0; i < cin; ++i) acc = fmaf(f32(xp[i]), ws[i * CC + c], acc);
      const float y1 = rb(acc);
      const float z1 = rb((y1 - m1) * inv1 * gg + bb);
      const int r = rlo + pix / W, w = pix % W;
      const int rr = r - (r0 - g.P);
      a1s[(rr * hc + w + g.P) * CC + c] = to_bf(silu(z1));
      if (y1s && r >= r0 && r < r0 + TH)
        y1s[((r - r0) * W + w) * CC + c] = to_bf(y1);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// squeeze-excite
// ---------------------------------------------------------------------------

// a2 = bf16(SiLU(bf16(xhat2 * g2 + b2))) of one y2 value at channel ch
__device__ __forceinline__ float a2_of(float y, const float* __restrict__ g2,
                                       const float* __restrict__ b2,
                                       const float* __restrict__ mv2, int mid,
                                       int ch) {
  const float z = rb((y - mv2[ch]) * inv_std(mv2[mid + ch]) * g2[ch] + b2[ch]);
  return rb(silu(z));
}

// grid (B, mid / CC, S): sq[(b * S + sp) * mid + c] = sum of a2 over the
// split's pixels of sample b (S = squeeze_splits(HW) spatial splits)
__global__ void __launch_bounds__(kThreads)
squeeze_kernel(const bf16* __restrict__ y2, const float* __restrict__ g2,
               const float* __restrict__ b2, const float* __restrict__ mv2,
               float* __restrict__ sq, int HW, int mid) {
  __shared__ float red[kGroups][CC];
  const int b = blockIdx.x, sp = blockIdx.z, S = gridDim.z;
  const int c = threadIdx.x % CC, grp = threadIdx.x / CC;
  const int ch = blockIdx.y * CC + c;
  const int chunk = cdiv(HW, S), p0 = sp * chunk, p1 = min(HW, p0 + chunk);
  float acc = 0.f;
  if (ch < mid)
    for (int p = p0 + grp; p < p1; p += kGroups)
      acc += a2_of(f32(y2[((size_t)b * HW + p) * mid + ch]), g2, b2, mv2, mid,
                   ch);
  red[grp][c] = acc;
  __syncthreads();
  if (grp == 0 && ch < mid) {
    float t = 0.f;
    for (int q = 0; q < kGroups; ++q) t += red[q][c];
    sq[((size_t)b * S + sp) * mid + ch] = t;
  }
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
  for (int c = threadIdx.x; c < mid; c += kThreads) {
    float t = 0.f;
    for (int sp = 0; sp < S; ++sp) t += sq[((size_t)b * S + sp) * mid + c];
    s[c] = rb(t / (float)HW);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = warp; j < r; j += kThreads / 32) {
    float part = 0.f;
    for (int c = lane; c < mid; c += 32)
      part = fmaf(s[c], f32(wr[(size_t)c * r + j]), part);
    const float tot = warp_sum(part);
    if (lane == 0) {
      su[j] = rb(tot + br[j]);
      ub[j] = rb(silu(su[j]));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < mid; c += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < r; ++j) acc = fmaf(ub[j], f32(we[(size_t)j * mid + c]), acc);
    se[c] = rb(sigm(rb(acc + be[c])));
  }
  __syncthreads();
}

}  // namespace
