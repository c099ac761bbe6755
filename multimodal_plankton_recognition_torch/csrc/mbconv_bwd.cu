// The fused stride-1 MBConv block, backward, for Hopper (sm_90a). Plain C
// entry points, loaded with ctypes by ops/mbconv.py.
//
// Replaces the TPU kernels
//   multimodal_plankton_recognition_tpu/ops/pallas/experimental/mbconv.py
//   ::_kb_bwd_kernel (kernel 15, through _kb_bwd) and ::_ka_bwd_kernel
//   (kernel 16, through _ka_bwd).
//
// Kernel 15 (mbconv_kb_bwd), for the cotangent dy3 of y3 (bf16, with the
// gradients through m3 and v3 already folded in by the caller):
//   recompute a2, s, su, se, a3 from y2 (as kernel 14);
//   da3 = dy3 . wproj^T; dse = per-sample sum of da3 * a2;
//   dsv = dse se (1 - se); dsu = (dsv . we^T) SiLU'(su); ds = dsu . wr^T;
//   dz2 = (da3 se + ds / HW) SiLU'(z2);
//   db2 = sum dz2, dg2 = sum dz2 xhat2 (over every pixel);
//   dy2 = bf16(g2 / sqrt(v2 + eps) (dz2 - db2 / N - xhat2 dg2 / N));
//   dwproj = a3^T . dy3, dwe = bf16(SiLU(su))^T . dsv, dbe = sum dsv,
//   dwr = s^T . dsu, dbr = sum dsu.
// Kernel 16 (mbconv_ka_bwd): y1 = bf16(x . wexp) (as kernel 13), xhat1,
//   z1, a1 from y1; dwdw[i, j] = sum a1[h + i - p, w + j - p] dy2[h, w];
//   da1 = the transposed stencil of dy2; dz1 = da1 SiLU'(z1);
//   db1 = sum dz1, dg1 = sum dz1 xhat1;
//   dy1 = bf16(g1 / sqrt(v1 + eps) (dz1 - db1 / N - xhat1 dg1 / N));
//   dx = bf16(dy1 . wexp^T), dwexp = x^T . dy1. Without an expand,
//   a1 = x and dx = bf16(da1).
//
// What bounds it on this card: bytes (y2, dy3, x in; dy2, dx out; the
// products do a few operations per byte).
//
// Design. Every global reduction is a pass that writes per-block partial
// sums and a reduce kernel adding them in a fixed order (no float
// atomics).
// Kernel 15: a3 is recomputed, never stored: da3 (a product over cout) is
// recomputed in each of the three passes that need it (the dse sums, the
// dz2 sums, the dy2 apply); its products run on CUDA cores in f32, and the
// weight gradient dwproj is a grid of (64 x 64 weight tile, pixel split)
// blocks with a fixed-order sum over the splits.
// Kernel 16: its three products run on the shared Hopper GEMM
// (hopper_gemm.cuh, wgmma fed by TMA): y1 once into scratch (bf16, as the
// TPU kernel rounds it), dx = bf16(dy1 . wexp^T) with wexp read K-major in
// place, and dwexp = x^T . dy1 with fixed-order group sums. Between them
// two depthwise passes (dw_bwd_kernel: the dwdw and BN1 sums, then dy1)
// read y1 instead of recomputing it: a block owns 8 rows x up to 32
// columns x 32 channels, loads its halos 16 bytes a copy with cp.async
// (zero fill past the image) and takes 44-72 KB of shared memory, so that
// several blocks share an SM and one's loads overlap another's stencil.
// dy1 is stored once, in bf16 (the TPU kernel rounds it before both of its
// products too). The kernels launch on the caller's stream, do not
// synchronise and allocate nothing; the entry points return a cudaError_t
// code.

#include "hopper_gemm.cuh"
#include "mbconv.cuh"

namespace {

// --------------------------- kernel 15 ------------------------------------

// da3 tile: rows of pixels base + m (m < mlen), columns j0 .. of mid
__device__ __forceinline__ void da3_tile(Tile& s, const bf16* __restrict__ dy3,
                                         const bf16* __restrict__ wproj,
                                         size_t base, int mlen, int j0,
                                         int mid, int cout, float acc[4][4]) {
  gemm_rows(
      s, mlen, cout, j0, mid,
      [&](int m, int o) { return f32(dy3[(base + m) * cout + o]); },
      [&](int o, int c) { return f32(wproj[(size_t)c * cout + o]); }, acc);
}

// grid (B * tiles per sample, mid / BN): dsep[tile][c] = sum of da3 * a2
// over the tile's pixels (tiles never straddle samples)
__global__ void __launch_bounds__(kThreads)
dse_kernel(const bf16* __restrict__ y2, const bf16* __restrict__ dy3,
           const float* __restrict__ g2, const float* __restrict__ b2,
           const float* __restrict__ mv2, const bf16* __restrict__ wproj,
           float* __restrict__ dsep, int HW, int tps, int mid, int cout) {
  __shared__ Tile s;
  const int b = blockIdx.x / tps, p0 = (blockIdx.x % tps) * BM;
  const int mlen = min(BM, HW - p0), j0 = blockIdx.y * BN;
  const size_t base = (size_t)b * HW + p0;
  float acc[4][4];
  da3_tile(s, dy3, wproj, base, mlen, j0, mid, cout, acc);
  float v0[4][4];
  const int r = tile_row(), c = tile_col();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = j0 + c + j;
      v0[i][j] = (r + i < mlen && ch < mid)
                     ? acc[i][j] * a2_of(f32(y2[(base + r + i) * mid + ch]),
                                         g2, b2, mv2, mid, ch)
                     : 0.f;
    }
  tile_col_sums(v0, v0, dsep + blockIdx.x * (size_t)mid, nullptr, j0, mid);
}

// grid B: the SE chain and its backward per sample. Writes se, ds / HW,
// s, dsv (B, mid) and ub, dsu (B, r).
__global__ void __launch_bounds__(kThreads)
se_bwd_kernel(const float* __restrict__ sq, const float* __restrict__ dsep,
              int S, int tps, int HW, const bf16* __restrict__ wr,
              const float* __restrict__ br, const bf16* __restrict__ we,
              const float* __restrict__ be, int mid, int r,
              float* __restrict__ se_o, float* __restrict__ ds_o,
              float* __restrict__ s_o, float* __restrict__ dsv_o,
              float* __restrict__ ub_o, float* __restrict__ dsu_o) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  float* se = s + mid;
  float* dsv = se + mid;
  float* su = dsv + mid;
  float* ub = su + r;
  float* dsu = ub + r;
  const int b = blockIdx.x;
  se_sample(sq, S, HW, b, wr, br, we, be, mid, r, s, su, ub, se);
  for (int c = threadIdx.x; c < mid; c += kThreads) {
    float dse = 0.f;
    for (int t = 0; t < tps; ++t) dse += dsep[((size_t)b * tps + t) * mid + c];
    dsv[c] = dse * se[c] * (1.f - se[c]);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = warp; j < r; j += kThreads / 32) {
    float part = 0.f;
    for (int c = lane; c < mid; c += 32)
      part = fmaf(dsv[c], f32(we[(size_t)j * mid + c]), part);
    const float du = warp_sum(part);
    if (lane == 0) dsu[j] = du * dsilu(su[j]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < mid; c += kThreads) {
    float ds = 0.f;
    for (int j = 0; j < r; ++j) ds = fmaf(dsu[j], f32(wr[(size_t)c * r + j]), ds);
    const size_t o = (size_t)b * mid + c;
    se_o[o] = se[c];
    ds_o[o] = ds / (float)HW;
    s_o[o] = s[c];
    dsv_o[o] = dsv[c];
  }
  for (int j = threadIdx.x; j < r; j += kThreads) {
    ub_o[(size_t)b * r + j] = ub[j];
    dsu_o[(size_t)b * r + j] = dsu[j];
  }
}

// one thread per output: dwe (r, mid), dwr (mid, r), dbe (mid), dbr (r),
// each a sum over the B samples in order
__global__ void __launch_bounds__(kThreads)
se_wgrad_kernel(const float* __restrict__ s, const float* __restrict__ dsv,
                const float* __restrict__ ub, const float* __restrict__ dsu,
                int B, int mid, int r, float* __restrict__ dwr,
                float* __restrict__ dbr, float* __restrict__ dwe,
                float* __restrict__ dbe) {
  int idx = blockIdx.x * kThreads + threadIdx.x;
  const int rm = r * mid;
  float acc = 0.f;
  if (idx < rm) {  // dwe[j][c]
    const int j = idx / mid, c = idx % mid;
    for (int b = 0; b < B; ++b)
      acc = fmaf(ub[(size_t)b * r + j], dsv[(size_t)b * mid + c], acc);
    dwe[idx] = acc;
  } else if ((idx -= rm) < rm) {  // dwr[c][j]
    const int c = idx / r, j = idx % r;
    for (int b = 0; b < B; ++b)
      acc = fmaf(s[(size_t)b * mid + c], dsu[(size_t)b * r + j], acc);
    dwr[idx] = acc;
  } else if ((idx -= rm) < mid) {
    for (int b = 0; b < B; ++b) acc += dsv[(size_t)b * mid + idx];
    dbe[idx] = acc;
  } else if ((idx -= mid) < r) {
    for (int b = 0; b < B; ++b) acc += dsu[(size_t)b * r + idx];
    dbr[idx] = acc;
  }
}

// grid (N / BM, mid / BN). APPLY = false: column sums of dz2 and dz2 xhat2
// per tile into part; APPLY = true: dy2 from the reduced sums db2s, dg2s.
template <bool APPLY>
__global__ void __launch_bounds__(kThreads)
dz2_kernel(const bf16* __restrict__ y2, const bf16* __restrict__ dy3,
           const float* __restrict__ g2, const float* __restrict__ b2,
           const float* __restrict__ mv2, const bf16* __restrict__ wproj,
           const float* __restrict__ se, const float* __restrict__ ds,
           const float* __restrict__ db2s, const float* __restrict__ dg2s,
           bf16* __restrict__ dy2, float* __restrict__ part, int N, int HW,
           int mid, int cout) {
  __shared__ Tile s;
  const int n0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  const int mlen = min(BM, N - n0);
  float acc[4][4];
  da3_tile(s, dy3, wproj, (size_t)n0, mlen, j0, mid, cout, acc);
  float v0[4][4], v1[4][4];
  const int r = tile_row(), c = tile_col();
  const float nf = (float)N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = j0 + c + j;
      const int n = n0 + r + i;
      float dz = 0.f, xhat = 0.f;
      if (r + i < mlen && ch < mid) {
        const float inv = inv_std(mv2[mid + ch]);
        xhat = (f32(y2[(size_t)n * mid + ch]) - mv2[ch]) * inv;
        const float z = rb(xhat * g2[ch] + b2[ch]);
        const size_t bc = (size_t)(n / HW) * mid + ch;
        dz = (acc[i][j] * se[bc] + ds[bc]) * dsilu(z);
        if (APPLY)
          dy2[(size_t)n * mid + ch] = to_bf(
              (g2[ch] * inv) * (dz - db2s[ch] / nf - xhat * (dg2s[ch] / nf)));
      }
      v0[i][j] = dz;
      v1[i][j] = dz * xhat;
    }
  if (!APPLY) {
    const size_t T = gridDim.x;
    tile_col_sums(v0, v1, part + blockIdx.x * (size_t)mid,
                  part + (T + blockIdx.x) * (size_t)mid, j0, mid);
  }
}

// Weight gradient out[k][j] = sum over pixels of A(n, k) D(n, j), split:
// grid (rows / BM, cols / BN, splits); part[split][k][j]
template <class ALoad, class DLoad>
__device__ void wgrad_tile(Tile& s, long long N, int rows, int cols,
                           ALoad aload, DLoad dload, float* part) {
  const int S = gridDim.z, sp = blockIdx.z;
  const int chunk = cdiv(N, S);
  const int p0 = sp * chunk, p1 = (int)min((long long)p0 + chunk, N);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[4][4];
  gemm_pixels(s, p0, p1, m0, rows, n0, cols, aload, dload, acc);
  const int r = tile_row(), c = tile_col();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m0 + r + i < rows && n0 + c + j < cols)
        part[((size_t)sp * rows + m0 + r + i) * cols + n0 + c + j] =
            acc[i][j];
}

// dwproj partials: A = a3 (recomputed), D = dy3
__global__ void __launch_bounds__(kThreads)
wproj_grad_kernel(const bf16* __restrict__ y2, const bf16* __restrict__ dy3,
                  const float* __restrict__ g2, const float* __restrict__ b2,
                  const float* __restrict__ mv2, const float* __restrict__ se,
                  float* __restrict__ part, int N, int HW, int mid,
                  int cout) {
  __shared__ Tile s;
  wgrad_tile(
      s, N, mid, cout,
      [&](int n, int c) {
        const float a2 =
            a2_of(f32(y2[(size_t)n * mid + c]), g2, b2, mv2, mid, c);
        return rb(a2 * se[(size_t)(n / HW) * mid + c]);
      },
      [&](int n, int o) { return f32(dy3[(size_t)n * cout + o]); }, part);
}

// --------------------------- kernel 16 ------------------------------------

// The depthwise passes' tiles: a block owns (sample b, output rows r0 ..
// r0 + kDwTH, output columns w0 .. w0 + tw, channels c0 .. c0 + CC); the
// halo adds P rows and columns on each side. Thread (g, c): channel c0 +
// c, pixel group g (kGroups of them).
constexpr int kDwTH = 8;   // output rows of a block
constexpr int kDwTW = 32;  // output columns of a block, at most

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

// grid (tiles, mid / CC). APPLY = false: partial dwdw (k*k, mid) and, with
// an expand, partial sums of dz1 and dz1 xhat1 per block; APPLY = true:
// dy1 (with an expand, from the reduced sums) or dx = da1. With an expand
// a1 = bf16(SiLU(bf16(xhat1 g1 + b1))) is made from the y1 halo in shared
// memory (y1 from the GEMM); without, a1 = x.
template <int K, bool APPLY>
__global__ void __launch_bounds__(kThreads)
    dw_bwd_kernel(const bf16* __restrict__ a_src, const bf16* __restrict__ y1,
                  const bf16* __restrict__ dy2, const float* __restrict__ g1,
                  const float* __restrict__ b1, const float* __restrict__ mv1,
                  const bf16* __restrict__ wdw,
                  const float* __restrict__ db1s,
                  const float* __restrict__ dg1s, bf16* __restrict__ out,
                  float* __restrict__ dwp, float* __restrict__ bnp,
                  DwTile g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kGroups][CC];
  constexpr int P = K / 2;
  bf16* dys = reinterpret_cast<bf16*>(smem);
  bf16* y1c = reinterpret_cast<bf16*>(smem + g.halo_bytes());
  bf16* a1s = reinterpret_cast<bf16*>(smem + g.halo_bytes() +
                                      g.center_bytes());
  const int rt = g.row_tiles(), ct = g.col_tiles();
  const int b = blockIdx.x / (rt * ct), rem = blockIdx.x % (rt * ct);
  const int r0 = (rem / ct) * kDwTH, w0 = (rem % ct) * g.tw;
  const int c0 = blockIdx.y * CC;
  const int hc = g.hc(), tw = g.tw;
  load_box(dy2, g, b, r0, w0, c0, P, g.hr(), hc, dys);
  if (g.expand) load_box(y1, g, b, r0, w0, c0, 0, kDwTH, tw, y1c);
  if (!APPLY) load_box(g.expand ? y1 : a_src, g, b, r0, w0, c0, P, g.hr(),
                       hc, a1s);
  cp_wait_all();
  __syncthreads();

  const int c = threadIdx.x % CC, grp = threadIdx.x / CC, ch = c0 + c;
  const int mid = g.mid;
  float m1 = 0.f, inv1 = 1.f, gg = 0.f, bb = 0.f;
  if (g.expand && ch < mid) {
    m1 = mv1[ch];
    inv1 = inv_std(mv1[mid + ch]);
    gg = g1[ch];
    bb = b1[ch];
  }
  if (!APPLY && g.expand) {  // y1 -> a1 over the halo, 0 outside the image
    for (int e = threadIdx.x; e < g.hr() * hc * CC; e += kThreads) {
      const int pix = e / CC, r = r0 - P + pix / hc, w = w0 - P + pix % hc;
      float a = 0.f;
      if (ch < mid && r >= 0 && r < g.H && w >= 0 && w < g.W)
        a = silu(rb((f32(a1s[e]) - m1) * inv1 * gg + bb));
      a1s[e] = to_bf(a);
    }
    __syncthreads();
  }

  const int rows = min(kDwTH, g.H - r0), cols = min(tw, g.W - w0);
  const float nf = (float)g.B * g.H * g.W;
  float wacc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wacc[t] = 0.f;
  float sdz = 0.f, sdzx = 0.f;
  if (ch < mid) {
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = f32(wdw[(size_t)t * mid + ch]);
    for (int pix = grp; pix < rows * cols; pix += kGroups) {
      const int row = pix / cols, col = pix % cols;
      const size_t n = ((size_t)b * g.H + r0 + row) * g.W + w0 + col;
      if (!APPLY) {
        const float d = f32(dys[((row + P) * hc + col + P) * CC + c]);
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int j = 0; j < K; ++j)
            wacc[i * K + j] = fmaf(
                f32(a1s[((row + i) * hc + col + j) * CC + c]), d,
                wacc[i * K + j]);
      }
      if (!APPLY && !g.expand) continue;
      float da1 = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          da1 = fmaf(
              f32(dys[((row + 2 * P - i) * hc + col + 2 * P - j) * CC + c]),
              wk[i * K + j], da1);
      if (!g.expand) {  // APPLY: dx = da1
        out[n * mid + ch] = to_bf(da1);
        continue;
      }
      const float xhat = (f32(y1c[(row * tw + col) * CC + c]) - m1) * inv1;
      const float z = rb(xhat * gg + bb);
      const float dz = da1 * dsilu(z);
      if (APPLY) {
        out[n * mid + ch] = to_bf(
            (gg * inv1) * (dz - db1s[ch] / nf - xhat * (dg1s[ch] / nf)));
      } else {
        sdz += dz;
        sdzx += dz * xhat;
      }
    }
  }
  if (APPLY) return;
  const size_t T = gridDim.x;
#pragma unroll
  for (int v = 0; v < K * K + 2; ++v) {
    red[grp][c] = v < K * K ? wacc[v] : (v == K * K ? sdz : sdzx);
    __syncthreads();
    if (grp == 0 && ch < mid) {
      float t = 0.f;
      for (int q = 0; q < kGroups; ++q) t += red[q][c];
      if (v < K * K)
        dwp[(blockIdx.x * (size_t)(K * K) + v) * mid + ch] = t;
      else if (g.expand)
        bnp[((v - K * K) * T + blockIdx.x) * mid + ch] = t;
    }
    __syncthreads();
  }
}

template <int K>
cudaError_t launch_dw_bwd(bool apply, const bf16* x, const bf16* y1,
                          const bf16* dy2, const float* g1, const float* b1,
                          const float* mv1, const bf16* wdw, const float* db1s,
                          const float* dg1s, bf16* out, float* dwp, float* bnp,
                          const DwTile& g, cudaStream_t stream) {
  const size_t smem =
      g.halo_bytes() * (apply ? 1 : 2) + g.center_bytes();
  const dim3 grid(g.tiles(), cdiv(g.mid, CC));
  cudaError_t err;
  if (apply) {
    err = cudaFuncSetAttribute(dw_bwd_kernel<K, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dw_bwd_kernel<K, true><<<grid, kThreads, smem, stream>>>(
        x, y1, dy2, g1, b1, mv1, wdw, db1s, dg1s, out, dwp, bnp, g);
  } else {
    err = cudaFuncSetAttribute(dw_bwd_kernel<K, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dw_bwd_kernel<K, false><<<grid, kThreads, smem, stream>>>(
        x, y1, dy2, g1, b1, mv1, wdw, db1s, dg1s, out, dwp, bnp, g);
  }
  return cudaGetLastError();
}

struct KbScratch {
  float *sq, *dsep, *se, *ds, *s, *dsv, *ub, *dsu, *part;
  size_t floats;
};

KbScratch kb_scratch(float* base, int B, int H, int W, int mid, int r,
                     int cout) {
  const int HW = H * W;
  const long long N = (long long)B * HW;
  const int S = squeeze_splits(HW), tps = cdiv(HW, BM);
  const size_t part_a = 2 * (size_t)cdiv(N, BM) * mid;
  const size_t part_b = (size_t)pixel_splits(N) * mid * cout;
  KbScratch k;
  size_t o = 0;
  auto take = [&](size_t n) {
    float* p = base ? base + o : nullptr;
    o += n;
    return p;
  };
  k.sq = take((size_t)B * S * mid);
  k.dsep = take((size_t)B * tps * mid);
  k.se = take((size_t)B * mid);
  k.ds = take((size_t)B * mid);
  k.s = take((size_t)B * mid);
  k.dsv = take((size_t)B * mid);
  k.ub = take((size_t)B * r);
  k.dsu = take((size_t)B * r);
  k.part = take(part_a > part_b ? part_a : part_b);
  k.floats = o;
  return k;
}

struct KaScratch {
  float *dwp, *bnp, *wpart;
  bf16 *dy1, *y1;
  int groups;
  size_t bytes;
};

// groups: dwexp's row groups (ops/hopper_gemm.py wgrad_groups; 0 without
// an expand)
KaScratch ka_scratch(unsigned char* base, int B, int H, int W, int cin,
                     int mid, int k, bool expand, int groups) {
  const long long N = (long long)B * H * W;
  const size_t T = dw_tile(B, H, W, mid, k, expand).tiles();
  KaScratch s;
  s.groups = groups;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + o : nullptr;
    o += align16(bytes);
    return p;
  };
  s.dwp = reinterpret_cast<float*>(take(T * k * k * mid * 4));
  s.bnp = reinterpret_cast<float*>(take(2 * T * mid * 4));
  s.wpart = reinterpret_cast<float*>(
      take((size_t)s.groups * cin * mid * 4));
  s.dy1 = reinterpret_cast<bf16*>(take(expand ? (size_t)N * mid * 2 : 0));
  s.y1 = reinterpret_cast<bf16*>(take(expand ? (size_t)N * mid * 2 : 0));
  s.bytes = o;
  return s;
}

}  // namespace

extern "C" {

// Bytes of scratch mbconv_kb_bwd needs.
long long mbconv_kb_bwd_scratch(int B, int H, int W, int mid, int r,
                                int cout) {
  return (long long)(kb_scratch(nullptr, B, H, W, mid, r, cout).floats * 4);
}

// y2, dy3: (B, H, W, mid) and (B, H, W, cout) bf16; g2, b2, mv2, wr, br,
// we, be, wproj as mbconv_kb_fwd; outs: dy2 (B, H, W, mid) bf16, dwproj
// (mid, cout), dwr (mid, r), dbr (r), dwe (r, mid), dbe (mid), dg2 (mid),
// db2 (mid) f32. Returns a cudaError_t code.
int mbconv_kb_bwd(const void* y2, const void* dy3, const void* g2,
                  const void* b2, const void* mv2, const void* wr,
                  const void* br, const void* we, const void* be,
                  const void* wproj, void* dy2, void* dwproj, void* dwr,
                  void* dbr, void* dwe, void* dbe, void* dg2, void* db2,
                  void* scratch, int B, int H, int W, int mid, int r,
                  int cout, void* stream) {
  if (B < 1 || H < 1 || W < 1 || mid < 1 || r < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const long long N = (long long)B * HW;
  const int S = squeeze_splits(HW), tps = cdiv(HW, BM);
  const KbScratch k =
      kb_scratch(static_cast<float*>(scratch), B, H, W, mid, r, cout);
  const bf16* y2b = static_cast<const bf16*>(y2);
  const bf16* dy3b = static_cast<const bf16*>(dy3);
  const float* g2f = static_cast<const float*>(g2);
  const float* b2f = static_cast<const float*>(b2);
  const float* mv = static_cast<const float*>(mv2);
  const bf16* wrb = static_cast<const bf16*>(wr);
  const bf16* web = static_cast<const bf16*>(we);
  const bf16* wpb = static_cast<const bf16*>(wproj);
  float* db2f = static_cast<float*>(db2);
  float* dg2f = static_cast<float*>(dg2);

  squeeze_kernel<<<dim3(B, cdiv(mid, CC), S), kThreads, 0, st>>>(
      y2b, g2f, b2f, mv, k.sq, HW, mid);
  dse_kernel<<<dim3(B * tps, cdiv(mid, BN)), kThreads, 0, st>>>(
      y2b, dy3b, g2f, b2f, mv, wpb, k.dsep, HW, tps, mid, cout);
  const size_t smem = (3 * (size_t)mid + 3 * (size_t)r) * 4;
  se_bwd_kernel<<<B, kThreads, smem, st>>>(
      k.sq, k.dsep, S, tps, HW, wrb, static_cast<const float*>(br), web,
      static_cast<const float*>(be), mid, r, k.se, k.ds, k.s, k.dsv, k.ub,
      k.dsu);
  se_wgrad_kernel<<<cdiv(2LL * r * mid + mid + r, kThreads), kThreads, 0,
                    st>>>(k.s, k.dsv, k.ub, k.dsu, B, mid, r,
                          static_cast<float*>(dwr), static_cast<float*>(dbr),
                          static_cast<float*>(dwe), static_cast<float*>(dbe));
  const int T = cdiv(N, BM);
  const dim3 grid(T, cdiv(mid, BN));
  dz2_kernel<false><<<grid, kThreads, 0, st>>>(
      y2b, dy3b, g2f, b2f, mv, wpb, k.se, k.ds, nullptr, nullptr, nullptr,
      k.part, (int)N, HW, mid, cout);
  reduce(k.part, 2, T, mid, db2f, dg2f, 0.f, st);
  dz2_kernel<true><<<grid, kThreads, 0, st>>>(
      y2b, dy3b, g2f, b2f, mv, wpb, k.se, k.ds, db2f, dg2f,
      static_cast<bf16*>(dy2), nullptr, (int)N, HW, mid, cout);
  const int SP = pixel_splits(N);
  wproj_grad_kernel<<<dim3(cdiv(mid, BM), cdiv(cout, BN), SP), kThreads, 0,
                      st>>>(y2b, dy3b, g2f, b2f, mv, k.se, k.part, (int)N, HW,
                            mid, cout);
  reduce(k.part, 1, SP, mid * cout, static_cast<float*>(dwproj), nullptr,
         0.f, st);
  return (int)cudaGetLastError();
}

// Bytes of scratch mbconv_ka_bwd needs.
long long mbconv_ka_bwd_scratch(int B, int H, int W, int cin, int mid, int k,
                                int expand, int groups) {
  return (long long)ka_scratch(nullptr, B, H, W, cin, mid, k, expand != 0,
                               groups)
      .bytes;
}

#define CHECK(call)                        \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// x: (B, H, W, cin) bf16; dy2: (B, H, W, mid) bf16; wexp, g1, b1 as
// mbconv_ka_fwd (null without an expand, then mid == cin; expand says
// which); wdw: (k*k, mid) bf16; mv1: (2, mid) f32 m1, v1 (null without an
// expand); outs: dx (B, H, W, cin) bf16, dwexp (cin, mid), dwdw (k*k,
// mid), dg1, db1 (mid) f32 (dwexp, dg1, db1 null without an expand). cin
// and mid multiples of 8 (16-byte rows), x and dy2 16-byte aligned;
// groups: dwexp's row groups, 1 <= groups <= ceil(B H W / 64) with an
// expand. Returns a cudaError_t code.
int mbconv_ka_bwd(const void* x, const void* dy2, const void* wexp,
                  const void* g1, const void* b1, const void* wdw,
                  const void* mv1, void* dx, void* dwexp, void* dwdw,
                  void* dg1, void* db1, void* scratch, int B, int H, int W,
                  int cin, int mid, int k, int expand, int groups,
                  void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin < 1 || mid < 1 || (k != 3 && k != 5) ||
      cin % 8 || mid % 8 || (expand != 0) != (wexp != nullptr) ||
      (!expand && cin != mid) || (expand && groups < 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy2) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = (long long)B * H * W;
  const KaScratch s = ka_scratch(static_cast<unsigned char*>(scratch), B, H,
                                 W, cin, mid, k, expand != 0, groups);
  const DwTile g = dw_tile(B, H, W, mid, k, expand != 0);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dy2b = static_cast<const bf16*>(dy2);
  const float* g1f = static_cast<const float*>(g1);
  const float* b1f = static_cast<const float*>(b1);
  const float* mv = static_cast<const float*>(mv1);
  const bf16* wd = static_cast<const bf16*>(wdw);
  float* db1f = static_cast<float*>(db1);
  float* dg1f = static_cast<float*>(dg1);
  bf16* out = expand ? s.dy1 : static_cast<bf16*>(dx);
  const int T = g.tiles();

  // y1 = bf16(x . wexp) once, on the tensor cores; the depthwise passes
  // read it instead of recomputing it
  if (expand) CHECK(hg::gemm(x, wexp, 1, nullptr, s.y1, (int)N, mid, cin, st));
  auto dw = [&](bool apply) {
    return k == 3 ? launch_dw_bwd<3>(apply, xb, s.y1, dy2b, g1f, b1f, mv, wd,
                                     db1f, dg1f, out, s.dwp, s.bnp, g, st)
                  : launch_dw_bwd<5>(apply, xb, s.y1, dy2b, g1f, b1f, mv, wd,
                                     db1f, dg1f, out, s.dwp, s.bnp, g, st);
  };
  CHECK(dw(false));
  reduce(s.dwp, 1, T, k * k * mid, static_cast<float*>(dwdw), nullptr, 0.f,
         st);
  if (expand) reduce(s.bnp, 2, T, mid, db1f, dg1f, 0.f, st);
  CHECK(dw(true));
  if (expand) {
    // dx = bf16(dy1 . wexp^T): wexp (cin, mid) read K-major in place
    CHECK(hg::gemm(s.dy1, wexp, 0, nullptr, dx, (int)N, cin, mid, st));
    // dwexp = x^T . dy1, fixed-order group sums
    CHECK(hg::wgrad(x, s.dy1, s.wpart, s.groups, dwexp, nullptr, (int)N,
                    cin, mid, st));
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
