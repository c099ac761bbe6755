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
// Kernel 16 (mbconv_ka_bwd): recompute y1, xhat1, z1, a1 from x (as
// kernel 13); dwdw[i, j] = sum a1[h + i - p, w + j - p] dy2[h, w];
//   da1 = the transposed stencil of dy2; dz1 = da1 SiLU'(z1);
//   db1 = sum dz1, dg1 = sum dz1 xhat1;
//   dy1 = bf16(g1 / sqrt(v1 + eps) (dz1 - db1 / N - xhat1 dg1 / N));
//   dx = bf16(dy1 . wexp^T), dwexp = x^T . dy1. Without an expand,
//   dx = bf16(da1).
//
// What bounds it on this card: bytes, as the forward (y2, dy3, x in; dy2,
// dx out; the products do a few operations per byte).
//
// Design. Every global reduction is a pass that writes per-block partial
// sums and reduce_kernel adding them in a fixed order (no float atomics).
// a3 and a1 are recomputed, never stored: da3 (a product over cout) is
// recomputed in each of the three passes of kernel 15 that need it (the
// dse sums, the dz2 sums, the dy2 apply); the a1 tile of kernel 16 is
// recomputed with its halo as in the forward. Kernel 16 stores dy1 once,
// in bf16 (the TPU kernel rounds it to bf16 before both of its products
// too), so that dx and dwexp are plain tiled products. The weight
// gradients (dwproj, dwexp) are sums over every pixel: a grid of
// (64 x 64 weight tile, pixel split) blocks and a fixed-order sum over the
// splits. The products run on CUDA cores in f32; the kernels launch on the
// caller's stream, do not synchronise and allocate nothing; the entry
// points return cudaGetLastError().

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

// grid (B * row tiles, mid / CC). APPLY = false: partial dwdw (k*k, mid)
// and, with an expand, partial sums of dz1 and dz1 xhat1 per block;
// APPLY = true: dy1 (with an expand, from the reduced sums) or dx = da1.
template <int K, bool APPLY>
__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy2,
              const bf16* __restrict__ wexp, const float* __restrict__ g1,
              const float* __restrict__ b1, const float* __restrict__ mv1,
              const bf16* __restrict__ wdw, const float* __restrict__ db1s,
              const float* __restrict__ dg1s, bf16* __restrict__ out,
              float* __restrict__ dwp, float* __restrict__ bnp, DwGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kGroups][CC];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* ws = reinterpret_cast<float*>(smem + g.xs_bytes());
  bf16* a1s = reinterpret_cast<bf16*>(smem + g.xs_bytes() + g.ws_bytes());
  bf16* dys = reinterpret_cast<bf16*>(smem + g.xs_bytes() + g.ws_bytes() +
                                      g.pad_bytes());
  bf16* y1s = reinterpret_cast<bf16*>(smem + g.xs_bytes() + g.ws_bytes() +
                                      2 * g.pad_bytes());
  const int rt = g.row_tiles();
  const int b = blockIdx.x / rt, r0 = (blockIdx.x % rt) * TH;
  const int c0 = blockIdx.y * CC;
  load_a1(x, wexp, g1, b1, mv1, g, b, r0, c0, xs, ws, a1s,
          g.expand ? y1s : nullptr);
  load_padded(dy2, g, b, r0, c0, dys);

  const int c = threadIdx.x % CC, grp = threadIdx.x / CC, ch = c0 + c;
  const int rows = min(TH, g.H - r0), W = g.W, hc = g.halo_cols();
  const int P = K / 2, mid = g.mid;
  const float nf = (float)g.B * g.H * g.W;
  float wacc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wacc[t] = 0.f;
  float sdz = 0.f, sdzx = 0.f;
  if (ch < mid) {
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = f32(wdw[(size_t)t * mid + ch]);
    float m1 = 0.f, inv1 = 1.f, gg = 0.f, bb = 0.f;
    if (g.expand) {
      m1 = mv1[ch];
      inv1 = inv_std(mv1[mid + ch]);
      gg = g1[ch];
      bb = b1[ch];
    }
    for (int pix = grp; pix < rows * W; pix += kGroups) {
      const int row = pix / W, col = pix % W;
      const size_t n = ((size_t)b * g.H + r0 + row) * W + col;
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
      const float xhat = (f32(y1s[(row * W + col) * CC + c]) - m1) * inv1;
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

// dx = bf16(dy1 . wexp^T): grid (N / BM, cin / BN)
__global__ void __launch_bounds__(kThreads)
dx_kernel(const bf16* __restrict__ dy1, const bf16* __restrict__ wexp,
          bf16* __restrict__ dx, int N, int cin, int mid) {
  __shared__ Tile s;
  const int n0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  const int mlen = min(BM, N - n0);
  float acc[4][4];
  gemm_rows(
      s, mlen, mid, j0, cin,
      [&](int m, int c) { return f32(dy1[(size_t)(n0 + m) * mid + c]); },
      [&](int c, int i) { return f32(wexp[(size_t)i * mid + c]); }, acc);
  const int r = tile_row(), c = tile_col();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r + i < mlen && j0 + c + j < cin)
        dx[(size_t)(n0 + r + i) * cin + j0 + c + j] = to_bf(acc[i][j]);
}

// dwexp partials: A = x, D = dy1
__global__ void __launch_bounds__(kThreads)
wexp_grad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy1,
                 float* __restrict__ part, int N, int cin, int mid) {
  __shared__ Tile s;
  wgrad_tile(
      s, N, cin, mid,
      [&](int n, int i) { return f32(x[(size_t)n * cin + i]); },
      [&](int n, int c) { return f32(dy1[(size_t)n * mid + c]); }, part);
}

template <int K>
cudaError_t launch_dw_bwd(bool apply, const bf16* x, const bf16* dy2,
                          const bf16* wexp, const float* g1, const float* b1,
                          const float* mv1, const bf16* wdw, const float* db1s,
                          const float* dg1s, bf16* out, float* dwp, float* bnp,
                          const DwGeom& g, cudaStream_t stream) {
  const size_t smem =
      g.xs_bytes() + g.ws_bytes() + 2 * g.pad_bytes() + g.y1_bytes();
  const dim3 grid(g.B * g.row_tiles(), cdiv(g.mid, CC));
  cudaError_t err;
  if (apply) {
    err = cudaFuncSetAttribute(dw_bwd_kernel<K, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dw_bwd_kernel<K, true><<<grid, kThreads, smem, stream>>>(
        x, dy2, wexp, g1, b1, mv1, wdw, db1s, dg1s, out, dwp, bnp, g);
  } else {
    err = cudaFuncSetAttribute(dw_bwd_kernel<K, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dw_bwd_kernel<K, false><<<grid, kThreads, smem, stream>>>(
        x, dy2, wexp, g1, b1, mv1, wdw, db1s, dg1s, out, dwp, bnp, g);
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
  bf16* dy1;
  size_t bytes;
};

KaScratch ka_scratch(unsigned char* base, int B, int H, int W, int cin,
                     int mid, int k) {
  const long long N = (long long)B * H * W;
  const size_t T = (size_t)B * cdiv(H, TH);
  KaScratch s;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + o : nullptr;
    o += align16(bytes);
    return p;
  };
  s.dwp = reinterpret_cast<float*>(take(T * k * k * mid * 4));
  s.bnp = reinterpret_cast<float*>(take(2 * T * mid * 4));
  s.wpart = reinterpret_cast<float*>(
      take((size_t)pixel_splits(N) * cin * mid * 4));
  s.dy1 = reinterpret_cast<bf16*>(take((size_t)N * mid * 2));
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
long long mbconv_ka_bwd_scratch(int B, int H, int W, int cin, int mid,
                                int k) {
  return (long long)ka_scratch(nullptr, B, H, W, cin, mid, k).bytes;
}

// x: (B, H, W, cin) bf16; dy2: (B, H, W, mid) bf16; wexp, g1, b1 as
// mbconv_ka_fwd (null without an expand, then mid == cin); wdw: (k*k, mid)
// bf16; mv1: (2, mid) f32 m1, v1 (null without an expand); outs: dx (B, H,
// W, cin) bf16, dwexp (cin, mid), dwdw (k*k, mid), dg1, db1 (mid) f32
// (dwexp, dg1, db1 null without an expand). Returns a cudaError_t code.
int mbconv_ka_bwd(const void* x, const void* dy2, const void* wexp,
                  const void* g1, const void* b1, const void* wdw,
                  const void* mv1, void* dx, void* dwexp, void* dwdw,
                  void* dg1, void* db1, void* scratch, int B, int H, int W,
                  int cin, int mid, int k, void* stream) {
  const bool expand = wexp != nullptr;
  if (B < 1 || H < 1 || W < 1 || cin < 1 || mid < 1 || (k != 3 && k != 5) ||
      (!expand && cin != mid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long N = (long long)B * H * W;
  const KaScratch s = ka_scratch(static_cast<unsigned char*>(scratch), B, H,
                                 W, cin, mid, k);
  const DwGeom g{B, H, W, cin, mid, k, k / 2, expand};
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dy2b = static_cast<const bf16*>(dy2);
  const bf16* wb = static_cast<const bf16*>(wexp);
  const float* g1f = static_cast<const float*>(g1);
  const float* b1f = static_cast<const float*>(b1);
  const float* mv = static_cast<const float*>(mv1);
  const bf16* wd = static_cast<const bf16*>(wdw);
  float* db1f = static_cast<float*>(db1);
  float* dg1f = static_cast<float*>(dg1);
  bf16* out = expand ? s.dy1 : static_cast<bf16*>(dx);
  const int T = B * g.row_tiles();

  auto dw = [&](bool apply) {
    return k == 3 ? launch_dw_bwd<3>(apply, xb, dy2b, wb, g1f, b1f, mv, wd,
                                     db1f, dg1f, out, s.dwp, s.bnp, g, st)
                  : launch_dw_bwd<5>(apply, xb, dy2b, wb, g1f, b1f, mv, wd,
                                     db1f, dg1f, out, s.dwp, s.bnp, g, st);
  };
  cudaError_t err = dw(false);
  if (err != cudaSuccess) return (int)err;
  reduce(s.dwp, 1, T, k * k * mid, static_cast<float*>(dwdw), nullptr, 0.f,
         st);
  if (expand) reduce(s.bnp, 2, T, mid, db1f, dg1f, 0.f, st);
  err = dw(true);
  if (err != cudaSuccess) return (int)err;
  if (expand) {
    dx_kernel<<<dim3(cdiv(N, BM), cdiv(cin, BN)), kThreads, 0, st>>>(
        s.dy1, wb, static_cast<bf16*>(dx), (int)N, cin, mid);
    const int SP = pixel_splits(N);
    wexp_grad_kernel<<<dim3(cdiv(cin, BM), cdiv(mid, BN), SP), kThreads, 0,
                       st>>>(xb, s.dy1, s.wpart, (int)N, cin, mid);
    reduce(s.wpart, 1, SP, cin * mid, static_cast<float*>(dwexp), nullptr,
           0.f, st);
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
