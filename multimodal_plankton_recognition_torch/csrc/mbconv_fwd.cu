// The fused stride-1 MBConv block, forward, for Hopper (sm_90a). Plain C
// entry points, loaded with ctypes by ops/mbconv.py.
//
// Replaces the TPU kernels
//   multimodal_plankton_recognition_tpu/ops/pallas/experimental/mbconv.py
//   ::_ka_fwd_kernel (kernel 13, through _ka_fwd) and ::_kb_fwd_kernel
//   (kernel 14, through _kb_fwd).
//
// Kernel 13 (mbconv_ka_fwd), x (B, H, W, cin) bf16 -> y2 (B, H, W, mid):
//   y1 = bf16(x . wexp); m1, v1 = batch mean and E[y1^2] - m1^2;
//   a1 = bf16(SiLU(bf16((y1 - m1) / sqrt(v1 + eps) * g1 + b1)));
//   y2 = bf16(depthwise k x k of a1, stride 1, zero 'same' padding);
//   m2, v2 likewise. Without an expand (wexp null), a1 = x.
// Kernel 14 (mbconv_kb_fwd), y2 -> y3 (B, H, W, cout):
//   a2 = bf16(SiLU(bf16(BN2(y2)))); s = bf16(spatial mean of a2) per
//   sample; se = bf16(sigmoid(bf16(bf16(SiLU(bf16(s . wr + br))) . we +
//   be))); a3 = bf16(a2 * se); y3 = bf16(a3 . wproj); m3, v3.
//
// What bounds it on this card: bytes. B0's stride-1 blocks do 2-30
// operations per byte they must move (x and y2 in, y2 and y3 out), far
// below the card's bf16 ridge (about 295); at B 64 the least time is the
// bytes over 3.35 TB/s, e.g. 20 us for kernel 13 at stage2_block1.
//
// Design. The TPU kernel keeps its accumulators in VMEM across a
// sequential grid; blocks here run in parallel, so each global reduction
// is a pass that writes per-block partial sums, then reduce_kernel adds
// them in a fixed order (no float atomics):
//   13: (i) the expand product per 64 x 64 tile, only its column sums
//       (y1 is never stored); (ii) reduce -> m1, v1; (iii) per (sample,
//       8-row tile, 32 channels): x rows of the tile and its k/2-row halo
//       and the wexp chunk into shared memory, the expand + BN1 + SiLU
//       recomputed for the halo (a1 never reaches device memory), the
//       stencil, y2 out and its column sums; (iv) reduce -> m2, v2.
//   14: (i) per-sample spatial sums of a2 over split pixel ranges; (ii)
//       the SE MLP per sample (one block each); (iii) the projection per
//       64 x 64 tile with a3 made while the A tile is loaded, y3 out and
//       its column sums; (iv) reduce -> m3, v3.
// The products run on CUDA cores in f32 (64 x 64 tiles, 4 x 4 per
// thread): a simple kernel first; tensor cores are later work. The
// kernels launch on the caller's stream, do not synchronise and allocate
// nothing (the caller passes scratch of the size *_scratch returns); the
// entry points return cudaGetLastError().

#include "mbconv.cuh"

namespace {

// (i) of kernel 13: column sums of y1 = bf16(x . wexp) and of y1^2 per
// 64-row tile: part[0][tile][c], part[1][tile][c]
__global__ void __launch_bounds__(kThreads)
expand_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wexp,
                    float* __restrict__ part, int N, int cin, int mid) {
  __shared__ Tile s;
  const int n0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  const int mlen = min(BM, N - n0);
  float acc[4][4];
  gemm_rows(
      s, mlen, cin, j0, mid,
      [&](int m, int k) { return f32(x[(size_t)(n0 + m) * cin + k]); },
      [&](int k, int j) { return f32(wexp[(size_t)k * mid + j]); }, acc);
  float v0[4][4], v1[4][4];
  const int r = tile_row(), c = tile_col();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = r + i < mlen && j0 + c + j < mid;
      const float y = ok ? rb(acc[i][j]) : 0.f;
      v0[i][j] = y;
      v1[i][j] = y * y;
    }
  const size_t T = gridDim.x;
  tile_col_sums(v0, v1, part + blockIdx.x * (size_t)mid,
                part + (T + blockIdx.x) * (size_t)mid, j0, mid);
}

// (iii) of kernel 13: grid (B * row tiles, mid / CC)
template <int K>
__global__ void __launch_bounds__(kThreads)
dw_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wexp,
              const float* __restrict__ g1, const float* __restrict__ b1,
              const float* __restrict__ mv1, const bf16* __restrict__ wdw,
              bf16* __restrict__ y2, float* __restrict__ part, DwGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][kGroups][CC];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* ws = reinterpret_cast<float*>(smem + g.xs_bytes());
  bf16* a1s = reinterpret_cast<bf16*>(smem + g.xs_bytes() + g.ws_bytes());
  const int rt = g.row_tiles();
  const int b = blockIdx.x / rt, r0 = (blockIdx.x % rt) * TH;
  const int c0 = blockIdx.y * CC;
  load_a1(x, wexp, g1, b1, mv1, g, b, r0, c0, xs, ws, a1s, nullptr);

  const int c = threadIdx.x % CC, grp = threadIdx.x / CC, ch = c0 + c;
  const int rows = min(TH, g.H - r0), W = g.W, hc = g.halo_cols();
  float s1 = 0.f, s2 = 0.f;
  if (ch < g.mid) {
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = f32(wdw[(size_t)t * g.mid + ch]);
    for (int pix = grp; pix < rows * W; pix += kGroups) {
      const int row = pix / W, col = pix % W;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          acc = fmaf(f32(a1s[((row + i) * hc + col + j) * CC + c]),
                     wk[i * K + j], acc);
      const bf16 y = to_bf(acc);
      y2[(((size_t)b * g.H + r0 + row) * W + col) * g.mid + ch] = y;
      const float yf = f32(y);
      s1 += yf;
      s2 += yf * yf;
    }
  }
  red[0][grp][c] = s1;
  red[1][grp][c] = s2;
  __syncthreads();
  if (grp == 0 && ch < g.mid) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < kGroups; ++q) {
      t1 += red[0][q][c];
      t2 += red[1][q][c];
    }
    const size_t T = gridDim.x;
    part[blockIdx.x * (size_t)g.mid + ch] = t1;
    part[(T + blockIdx.x) * (size_t)g.mid + ch] = t2;
  }
}

// (ii) of kernel 14: grid B; se[b * mid + c]
__global__ void __launch_bounds__(kThreads)
se_fwd_kernel(const float* __restrict__ sq, int S, int HW,
              const bf16* __restrict__ wr, const float* __restrict__ br,
              const bf16* __restrict__ we, const float* __restrict__ be,
              float* __restrict__ se, int mid, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  float* sev = s + mid;
  float* su = sev + mid;
  float* ub = su + r;
  se_sample(sq, S, HW, blockIdx.x, wr, br, we, be, mid, r, s, su, ub, sev);
  for (int c = threadIdx.x; c < mid; c += kThreads)
    se[(size_t)blockIdx.x * mid + c] = sev[c];
}

// (iii) of kernel 14: grid (N / BM, cout / BN)
__global__ void __launch_bounds__(kThreads)
proj_fwd_kernel(const bf16* __restrict__ y2, const float* __restrict__ g2,
                const float* __restrict__ b2, const float* __restrict__ mv2,
                const float* __restrict__ se, const bf16* __restrict__ wproj,
                bf16* __restrict__ y3, float* __restrict__ part, int N,
                int HW, int mid, int cout) {
  __shared__ Tile s;
  const int n0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  const int mlen = min(BM, N - n0);
  float acc[4][4];
  gemm_rows(
      s, mlen, mid, j0, cout,
      [&](int m, int k) {
        const int n = n0 + m;
        const float a2 = a2_of(f32(y2[(size_t)n * mid + k]), g2, b2, mv2, mid,
                               k);
        return rb(a2 * se[(size_t)(n / HW) * mid + k]);
      },
      [&](int k, int j) { return f32(wproj[(size_t)k * cout + j]); }, acc);
  float v0[4][4], v1[4][4];
  const int r = tile_row(), c = tile_col();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = r + i < mlen && j0 + c + j < cout;
      float y = 0.f;
      if (ok) {
        const bf16 yb = to_bf(acc[i][j]);
        y3[(size_t)(n0 + r + i) * cout + j0 + c + j] = yb;
        y = f32(yb);
      }
      v0[i][j] = y;
      v1[i][j] = y * y;
    }
  const size_t T = gridDim.x;
  tile_col_sums(v0, v1, part + blockIdx.x * (size_t)cout,
                part + (T + blockIdx.x) * (size_t)cout, j0, cout);
}

DwGeom geom(int B, int H, int W, int cin, int mid, int k, bool expand) {
  return DwGeom{B, H, W, cin, mid, k, k / 2, expand};
}

bool bad_dims(int B, int H, int W, int cin, int mid, int k) {
  return B < 1 || H < 1 || W < 1 || cin < 1 || mid < 1 ||
         (k != 3 && k != 5);
}

size_t ka_parts(int B, int H, int W, int mid, bool expand) {
  const long long N = (long long)B * H * W;
  const size_t t1 = expand ? cdiv(N, BM) : 0;
  const size_t t2 = (size_t)B * cdiv(H, TH);
  return 2 * (t1 > t2 ? t1 : t2) * mid;
}

template <int K>
cudaError_t launch_dw_fwd(const bf16* x, const bf16* wexp, const float* g1,
                          const float* b1, const float* mv1, const bf16* wdw,
                          bf16* y2, float* part, const DwGeom& g,
                          cudaStream_t stream) {
  const size_t smem = g.xs_bytes() + g.ws_bytes() + g.pad_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      dw_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.B * g.row_tiles(), cdiv(g.mid, CC));
  dw_fwd_kernel<K><<<grid, kThreads, smem, stream>>>(x, wexp, g1, b1, mv1,
                                                      wdw, y2, part, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch mbconv_ka_fwd needs (f32 partial sums; sized for an
// expand, which needs more).
long long mbconv_ka_fwd_scratch(int B, int H, int W, int cin, int mid,
                                int k) {
  return (long long)(ka_parts(B, H, W, mid, true) * 4);
}

// x: (B, H, W, cin) bf16; wexp: (cin, mid) bf16 or null (then mid == cin);
// g1, b1: (mid) f32 (null without wexp); wdw: (k*k, mid) bf16; y2: (B, H,
// W, mid) bf16 out; stats: (4, mid) f32 out m1, v1, m2, v2 (m1, v1 left as
// given without wexp). k is 3 or 5. Returns a cudaError_t code.
int mbconv_ka_fwd(const void* x, const void* wexp, const void* g1,
                  const void* b1, const void* wdw, void* y2, void* stats,
                  void* scratch, int B, int H, int W, int cin, int mid, int k,
                  void* stream) {
  const bool expand = wexp != nullptr;
  if (bad_dims(B, H, W, cin, mid, k) || (!expand && cin != mid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(wexp);
  float* st = static_cast<float*>(stats);
  float* part = static_cast<float*>(scratch);
  const long long N = (long long)B * H * W;
  if (expand) {
    const int T1 = cdiv(N, BM);
    expand_stats_kernel<<<dim3(T1, cdiv(mid, BN)), kThreads, 0, s>>>(
        xb, wb, part, (int)N, cin, mid);
    reduce(part, 2, T1, mid, st, st + mid, (float)N, s);
  }
  const DwGeom g = geom(B, H, W, cin, mid, k, expand);
  const float* g1f = static_cast<const float*>(g1);
  const float* b1f = static_cast<const float*>(b1);
  const bf16* wd = static_cast<const bf16*>(wdw);
  bf16* y2b = static_cast<bf16*>(y2);
  cudaError_t err =
      k == 3 ? launch_dw_fwd<3>(xb, wb, g1f, b1f, st, wd, y2b, part, g, s)
             : launch_dw_fwd<5>(xb, wb, g1f, b1f, st, wd, y2b, part, g, s);
  if (err != cudaSuccess) return (int)err;
  reduce(part, 2, B * g.row_tiles(), mid, st + 2 * mid, st + 3 * mid,
         (float)N, s);
  return (int)cudaGetLastError();
}

// Bytes of scratch mbconv_kb_fwd needs.
long long mbconv_kb_fwd_scratch(int B, int H, int W, int mid, int r,
                                int cout) {
  const long long N = (long long)B * H * W;
  const int S = squeeze_splits(H * W);
  return 4 * ((long long)B * S * mid + (long long)B * mid +
              2LL * cdiv(N, BM) * cout);
}

// y2: (B, H, W, mid) bf16; g2, b2: (mid) f32; mv2: (2, mid) f32 m2, v2;
// wr: (mid, r) bf16; br: (r) f32; we: (r, mid) bf16; be: (mid) f32;
// wproj: (mid, cout) bf16; y3: (B, H, W, cout) bf16 out; stats: (2, cout)
// f32 out m3, v3. Returns a cudaError_t code.
int mbconv_kb_fwd(const void* y2, const void* g2, const void* b2,
                  const void* mv2, const void* wr, const void* br,
                  const void* we, const void* be, const void* wproj, void* y3,
                  void* stats, void* scratch, int B, int H, int W, int mid,
                  int r, int cout, void* stream) {
  if (B < 1 || H < 1 || W < 1 || mid < 1 || r < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  const long long N = (long long)B * HW;
  const int S = squeeze_splits(HW);
  float* sq = static_cast<float*>(scratch);
  float* se = sq + (size_t)B * S * mid;
  float* part = se + (size_t)B * mid;
  const bf16* y2b = static_cast<const bf16*>(y2);
  const float* g2f = static_cast<const float*>(g2);
  const float* b2f = static_cast<const float*>(b2);
  const float* mv = static_cast<const float*>(mv2);
  squeeze_kernel<<<dim3(B, cdiv(mid, CC), S), kThreads, 0, s>>>(
      y2b, g2f, b2f, mv, sq, HW, mid);
  const size_t smem = (2 * (size_t)mid + 2 * (size_t)r) * 4;
  se_fwd_kernel<<<B, kThreads, smem, s>>>(
      sq, S, HW, static_cast<const bf16*>(wr), static_cast<const float*>(br),
      static_cast<const bf16*>(we), static_cast<const float*>(be), se, mid,
      r);
  const int T = cdiv(N, BM);
  float* st = static_cast<float*>(stats);
  proj_fwd_kernel<<<dim3(T, cdiv(cout, BN)), kThreads, 0, s>>>(
      y2b, g2f, b2f, mv, se, static_cast<const bf16*>(wproj),
      static_cast<bf16*>(y3), part, (int)N, HW, mid, cout);
  reduce(part, 2, T, cout, st, st + cout, (float)N, s);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
