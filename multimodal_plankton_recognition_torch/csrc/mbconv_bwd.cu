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
// atomics), so a run repeats bit for bit.
// Kernel 15: three passes (kb_pass_kernel) over blocks of one sample's
// 64-pixel tile x a 64-channel slice of mid, each loading the wproj slice
// and its y2 and dy3 tiles by TMA (3-D maps (B, HW, C): a tile never mixes
// two samples, so the per-sample SE sums stay exact and in order) and
// recomputing da3 = dy3 . wproj^T on wgmma in f32 (never rounded, as the
// TPU kernel keeps it; recomputing costs less than storing it in f32):
// the squeeze and dse sums per tile; after the SE kernels (the tiles'
// sums added per sample, one block a sample, then one thread per SE
// weight gradient), BN2's sums of dz2 and dz2 xhat2 (per tile, per
// sample, then over the samples), writing a3 = bf16(a2 se) once to
// scratch; then dy2. dwproj =
// a3^T . dy3 runs on the shared weight-gradient GEMM (hopper_gemm.cuh
// wgrad_kernel, fixed-order group sums). mid and cout must be multiples of
// 8 (TMA's 16-byte rows: ops/mbconv.py check_channels).
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

using hg::boxes;
using hg::bulk_commit;
using hg::bulk_wait;
using hg::desc_k;
using hg::fence_async_smem;
using hg::fence_regs;
using hg::kBox;
using hg::mbar_expect_tx;
using hg::mbar_fence_init;
using hg::mbar_init;
using hg::mbar_wait;
using hg::smem_u32;
using hg::swz;
using hg::tma_load;
using hg::tma_load3;
using hg::tma_store3;
using hg::wgmma64;
using hg::wgmma_commit;
using hg::wgmma_fence;
using hg::wgmma_wait;

// The three passes over (sample, 64-pixel tile, 64-channel slice of mid):
// kDse: per tile, the column sums of a2 (the squeeze) and of da3 * a2 (dse);
// kSums: the column sums of dz2 and dz2 * xhat2, and a3 = bf16(a2 se) to
// scratch; kApply: dy2. Each recomputes da3 = dy3 . wproj^T for its tile on
// wgmma (f32, never rounded, as the TPU kernel keeps it): 1.4 us of tensor
// work at stage2_block1, where storing it in f32 and reading it back would
// move 116 MB.
enum KbPass { kDse = 0, kSums = 1, kApply = 2 };

// Shared memory of a pass block, bytes from a 1024-byte boundary: kb boxes
// of the wproj slice (64 channels x 64 of cout each), then `stages` (1 or
// 2) stages of kb boxes of a dy3 tile and one box of a y2 tile (written
// over in place by a3 or dy2, then stored from there), 64 x 8 per-channel
// floats, the 4 warps' column sums (2 x 4 x 64 floats), two mbarriers.
struct KbSmem {
  int kb, stages;
  __host__ __device__ uint32_t stage(int s) const {
    return (uint32_t)(kb + s * (kb + 1)) * kBox;
  }
  __host__ __device__ uint32_t par() const { return stage(stages); }
  __host__ __device__ uint32_t red() const { return par() + 64 * 8 * 4; }
  __host__ __device__ uint32_t bar() const { return red() + 2 * 4 * 64 * 4; }
  __host__ __device__ uint32_t bytes() const { return bar() + 16 + 1024; }
};

// SiLU(z) and SiLU'(z) from one exp. a is mbconv.cuh's silu(z) bit for bit
// (expf and an IEEE division), so the recomputed a2 is the one kernel 14's
// squeeze stored (mbconv_fwd.cu); SiLU'(z), which no forward rounds, takes
// the sigmoid from the fast reciprocal (a few f32 ulps)
__device__ __forceinline__ void silu_pair(float z, float& a, float& da) {
  const float d = 1.f + expf(-z);
  const float s = __fdividef(1.f, d);
  a = z / d;
  da = s * (1.f + z * (1.f - s));
}

// Block (g, j): channels [64 j, 64 j + 64) of mid, tiles [g T / G, (g +
// 1) T / G) in order (G = gridDim.x; with one stage, G = T). Tile t: sample b = t / tps, pixels
// [64 (t % tps), + 64) of it (tps = ceil(HW / 64) tiles a sample, so a
// tile never mixes two samples: the 3-D maps load zeros past HW and store
// nothing there). One warpgroup: thread 0 loads the wproj slice once and
// the tiles by TMA, two stages deep (tile k + 2 into the stage tile k
// leaves); per tile the warpgroup runs da3 (m64n64, K = cout, both
// operands K-major), then the pass's epilogue in registers. part: kDse
// writes (sq, dse) at part + (0, T mid) + t mid, kSums (sums of dz2, of
// dz2 xhat2) likewise; se, ds: (B, mid) from se_bwd_kernel; db2s, dg2s:
// BN2's sums (kApply).
template <int PASS>
__global__ void __launch_bounds__(128)
    kb_pass_kernel(const __grid_constant__ CUtensorMap y2_map,
                   const __grid_constant__ CUtensorMap dy3_map,
                   const __grid_constant__ CUtensorMap wp_map,
                   const __grid_constant__ CUtensorMap out_map,
                   const float* __restrict__ g2, const float* __restrict__ b2,
                   const float* __restrict__ mv2,
                   const float* __restrict__ se,
                   const float* __restrict__ ds,
                   const float* __restrict__ db2s,
                   const float* __restrict__ dg2s, float* __restrict__ part,
                   int T, int HW, int tps, int mid, int cout, float n_inv,
                   int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int kb = boxes(cout);
  const KbSmem L{kb, stages};
  uint8_t* gen = smem_raw + (base - raw);
  float* par = reinterpret_cast<float*>(gen + L.par());
  float* red = reinterpret_cast<float*>(gen + L.red());
  const uint32_t bar = base + L.bar();
  const int j0 = blockIdx.y * 64;
  const int t0 = (int)((long long)blockIdx.x * T / gridDim.x);
  const int n = (int)((long long)(blockIdx.x + 1) * T / gridDim.x) - t0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the dy3 and y2 tiles of the block's k-th tile into stage k % 2 (the
  // first also brings the wproj slice)
  auto load = [&](int k) {
    const int t = t0 + k, st = k & 1;
    const int b = t / tps, p0 = (t % tps) * 64;
    const uint32_t full = bar + 8 * st, dst = base + L.stage(st);
    mbar_expect_tx(full, (k == 0 ? 2 * kb + 1 : kb + 1) * kBox);
    for (int q = 0; q < kb; ++q) {
      if (k == 0) tma_load(base + q * kBox, &wp_map, full, q * 64, j0);
      tma_load3(dst + q * kBox, &dy3_map, full, q * 64, p0, b);
    }
    tma_load3(dst + kb * kBox, &y2_map, full, j0, p0, b);
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    mbar_fence_init();
    load(0);
    if (n > 1) load(1);
  }
  // per channel: m2, 1 / sqrt(v2 + eps), g2, b2, then db2 / N and dg2 / N
  // (kApply), and per tile the sample's se and ds / HW
  if (tid < 64) {
    const int ch = j0 + tid;
    const bool in = ch < mid;
    float* q = par + tid * 8;
    q[0] = in ? mv2[ch] : 0.f;
    q[1] = in ? inv_std(mv2[mid + ch]) : 0.f;
    q[2] = in ? g2[ch] : 0.f;
    q[3] = in ? b2[ch] : 0.f;
    if (PASS == kApply) {
      q[6] = in ? db2s[ch] * n_inv : 0.f;
      q[7] = in ? dg2s[ch] * n_inv : 0.f;
    }
  }

  for (int k = 0; k < n; ++k) {
    const int t = t0 + k, st = k & 1;
    const int b = t / tps, p0 = (t % tps) * 64;
    const uint32_t dy3_s = base + L.stage(st), y_s = dy3_s + kb * kBox;
    if (PASS != kDse && tid < 64) {
      const int ch = j0 + tid;
      const bool in = ch < mid;
      par[tid * 8 + 4] = in ? se[(size_t)b * mid + ch] : 0.f;
      par[tid * 8 + 5] = in ? ds[(size_t)b * mid + ch] : 0.f;
    }
    __syncthreads();  // par written; the previous tile's red read
    mbar_wait(bar + 8 * st, (k >> 1) & 1);

    // da3 (64 pixels x 64 channels) = dy3 tile . wproj slice^T, f32
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
    for (int q = 0; q < kb; ++q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (q * 64 + kk * 16 < cout)
          wgmma64<0, 0>(acc, desc_k(dy3_s + q * kBox + kk * 32),
                        desc_k(base + q * kBox + kk * 32));
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);

    // thread t holds pixels r, r + 8 and channels 8 i + cq (+ 1) of the
    // tile; channel groups past mid (the last slice of a mid that is not a
    // multiple of 64) are skipped, a branch the whole block takes alike
    const int r = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
    float c0[16], c1[16];  // its column sums over its two pixels
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) c0[2 * i + e] = c1[2 * i + e] = 0.f;
      if (j0 + 8 * i >= mid) continue;
      const float* q0 = par + (8 * i + cq) * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        const bool valid = p0 + row < HW;
        uint32_t* yp = reinterpret_cast<uint32_t*>(
            gen + (y_s - base) + swz(row, 8 * i + cq));
        const float2 yv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(yp));
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* q = q0 + 8 * e;
          const float xhat = ((e ? yv.y : yv.x) - q[0]) * q[1];
          const float z = rb(xhat * q[2] + q[3]);
          float a, da;
          silu_pair(z, a, da);
          a = rb(a);  // a2
          const float d3 = acc[4 * i + 2 * h + e];
          if (PASS == kDse) {
            c0[2 * i + e] += valid ? a : 0.f;
            c1[2 * i + e] += d3 * a;  // dy3 is 0 past HW
            continue;
          }
          const float dz = (d3 * q[4] + q[5]) * da;
          if (PASS == kSums) {
            out[e] = a * q[4];  // a3
            c0[2 * i + e] += valid ? dz : 0.f;
            c1[2 * i + e] += valid ? dz * xhat : 0.f;
          } else {
            out[e] = (q[2] * q[1]) * (dz - q[6] - xhat * q[7]);  // dy2
          }
        }
        if (PASS != kDse) *yp = hg::pack2(out[0], out[1]);
      }
    }

    if (PASS != kDse) {  // a3 or dy2 back where y2 was, then out by TMA
      fence_async_smem();
      __syncthreads();
      if (tid == 0) {
        tma_store3(&out_map, y_s, j0, p0, b);
        bulk_commit();
      }
    }
    if (PASS != kApply) {
      // column sums over the warp's 16 pixels, then the 4 warps in order
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          c0[q] += __shfl_xor_sync(0xffffffffu, c0[q], o);
          c1[q] += __shfl_xor_sync(0xffffffffu, c1[q], o);
        }
      if (lane < 4)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            red[warp * 64 + 8 * i + cq + e] = c0[2 * i + e];
            red[256 + warp * 64 + 8 * i + cq + e] = c1[2 * i + e];
          }
      __syncthreads();
      if (j0 + (tid & 63) < mid) {
        const int c = tid & 63, w = tid >> 6;  // w: which of the two sums
        const float* rw = red + w * 256 + c;
        part[((size_t)w * T + t) * mid + j0 + c] =
            ((rw[0] + rw[64]) + rw[128]) + rw[192];
      }
    }
    // every thread is done with this stage (a barrier followed the
    // epilogue): tile k + 2 into it, once its store has read it
    if (tid == 0 && k + 2 < n) {
      if (PASS != kDse) hg::bulk_wait_read();
      load(k + 2);
    }
  }
  if (PASS != kDse && tid == 0) bulk_wait();
}

template <int PASS>
cudaError_t launch_pass(const CUtensorMap& y2m, const CUtensorMap& dy3m,
                        const CUtensorMap& wpm, const CUtensorMap& outm,
                        const float* g2, const float* b2, const float* mv2,
                        const float* se, const float* ds, const float* db2s,
                        const float* dg2s, float* part, int T, int HW,
                        int tps, int mid, int cout, float n_inv,
                        cudaStream_t st) {
  // Where each block gets 6 tiles or more and two fit on an SM, as many
  // blocks as fit on the card at once, each walking its share of the tiles
  // two stages deep; else one tile a block, one stage, and more blocks to
  // an SM (measured on an H100 at B0's shapes: the deep blocks win at
  // 112^2 to 28^2, where there are many tiles a slice, and lose at 14^2
  // and 7^2, where they hold fewer blocks to an SM)
  const int slices = boxes(mid), kb = boxes(cout);
  auto fit = [&](int stages) {  // blocks an SM: shared memory, 16 at most
    const long long n = (long long)hg::kSmemMax /
                        (KbSmem{kb, stages}.bytes() + 1024);
    return n < 1 ? 1LL : (n > 16 ? 16LL : n);
  };
  long long g = hg::sm_count() * fit(2) / slices;
  const int stages = fit(2) >= 2 && g >= 1 && T >= 6 * g ? 2 : 1;
  if (stages == 1) g = T;
  const size_t smem = KbSmem{kb, stages}.bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kb_pass_kernel<PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  kb_pass_kernel<PASS><<<dim3((int)g, slices), 128, smem, st>>>(
      y2m, dy3m, wpm, outm, g2, b2, mv2, se, ds, db2s, dg2s, part, T, HW,
      tps, mid, cout, n_inv, stages);
  return cudaGetLastError();
}

// grid B: the SE chain and its backward per sample, from the per-sample
// sums sq of a2 and dse of da3 a2 (B, mid). Writes se, ds / HW, s, dsv
// (B, mid) and ub, dsu (B, r).
__global__ void __launch_bounds__(kThreads)
se_bwd_kernel(const float* __restrict__ sq, const float* __restrict__ dse,
              int HW, const bf16* __restrict__ wr,
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
  se_sample(sq, 1, HW, b, wr, br, we, be, mid, r, s, su, ub, se);
  for (int c = threadIdx.x; c < mid; c += kThreads)
    dsv[c] = dse[(size_t)b * mid + c] * se[c] * (1.f - se[c]);
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

// --------------------------- kernel 16 ------------------------------------
// Its depthwise tiles, DwTile and load_box, are mbconv.cuh's (kernel 13's
// depthwise pass takes the same). Thread (g, c) of a block: channel c0 + c,
// pixel group g (kGroups of them).

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
    // the channel's k x k weights, in registers up to kRegK, else read
    // (through L1) where used, one stencil row at a time (as kernel 13's
    // depthwise pass)
    constexpr bool kRegW = K <= kRegK;
    constexpr int kRowUnroll = kRegW ? K : 1;
    float wk[kRegW ? K * K : 1];
    if constexpr (kRegW) {
#pragma unroll
      for (int t = 0; t < K * K; ++t) wk[t] = f32(wdw[(size_t)t * mid + ch]);
    }
    auto weight = [&](int t) {
      if constexpr (kRegW)
        return wk[t];
      else
        return f32(wdw[(size_t)t * mid + ch]);
    };
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
#pragma unroll kRowUnroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          da1 = fmaf(
              f32(dys[((row + 2 * P - i) * hc + col + 2 * P - j) * CC + c]),
              weight(i * K + j), da1);
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

#define CHECK(call)                        \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// y2, dy3: (B, H, W, mid) and (B, H, W, cout) bf16; g2, b2, mv2, wr, br,
// we, be, wproj as mbconv_kb_fwd; outs: dy2 (B, H, W, mid) bf16, dwproj
// (mid, cout), dwr (mid, r), dbr (r), dwe (r, mid), dbe (mid), dg2 (mid),
// db2 (mid) f32. Scratch (ops/mbconv.py kb_bwd_scratch): part 2 x B
// ceil(H W / 64) x mid f32; sample: 2 x B x mid per-sample sums, se, ds,
// s, dsv (B, mid), then ub, dsu (B, r) f32; a3 (B H W, mid) bf16; wpart
// groups x mid cout f32, 1 <=
// groups <= ceil(B H W / 64). mid and cout multiples of 8 (16-byte rows),
// y2, dy3, wproj and a3 16-byte aligned. Returns a cudaError_t code.
int mbconv_kb_bwd(const void* y2, const void* dy3, const void* g2,
                  const void* b2, const void* mv2, const void* wr,
                  const void* br, const void* we, const void* be,
                  const void* wproj, void* dy2, void* dwproj, void* dwr,
                  void* dbr, void* dwe, void* dbe, void* dg2, void* db2,
                  void* part, void* sample, void* a3, void* wpart, int B,
                  int H, int W, int mid, int r, int cout, int groups,
                  void* stream) {
  const long long N = (long long)B * H * W;
  if (B < 1 || H < 1 || W < 1 || mid < 1 || r < 1 || cout < 1 || mid % 8 ||
      cout % 8 || groups < 1 || groups > cdiv(N, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HW = H * W, tps = cdiv(HW, 64), T = B * tps;
  CUtensorMap y2m, dy3m, wpm, a3m, dy2m;
  if (!hg::make_map3(&y2m, y2, B, HW, mid, 64) ||
      !hg::make_map3(&dy3m, dy3, B, HW, cout, 64) ||
      !hg::make_map(&wpm, wproj, mid, cout, 64) ||
      !hg::make_map3(&a3m, a3, B, HW, mid, 64) ||
      !hg::make_map3(&dy2m, dy2, B, HW, mid, 64))
    return (int)cudaErrorInvalidValue;
  const float* g2f = static_cast<const float*>(g2);
  const float* b2f = static_cast<const float*>(b2);
  const float* mv = static_cast<const float*>(mv2);
  float* db2f = static_cast<float*>(db2);
  float* dg2f = static_cast<float*>(dg2);
  float* pt = static_cast<float*>(part);
  float* samp = static_cast<float*>(sample);  // per-sample pass sums
  float* se = samp + 2 * (size_t)B * mid;
  float* ds = se + (size_t)B * mid;
  float* s = ds + (size_t)B * mid;
  float* dsv = s + (size_t)B * mid;
  float* ub = dsv + (size_t)B * mid;
  float* dsu = ub + (size_t)B * r;

  const dim3 sums_grid(B, cdiv(mid, 32), 2);
  // the squeeze and dse sums per tile, then per sample; the SE chain and
  // its backward per sample; the SE weight gradients
  CHECK(launch_pass<kDse>(y2m, dy3m, wpm, y2m, g2f, b2f, mv, nullptr,
                          nullptr, nullptr, nullptr, pt, T, HW, tps, mid,
                          cout, 0.f, st));
  tile_sums_kernel<<<sums_grid, 1024, 0, st>>>(pt, T, tps, mid, samp);
  const size_t smem = (3 * (size_t)mid + 3 * (size_t)r) * 4;
  se_bwd_kernel<<<B, kThreads, smem, st>>>(
      samp, samp + (size_t)B * mid, HW, static_cast<const bf16*>(wr),
      static_cast<const float*>(br), static_cast<const bf16*>(we),
      static_cast<const float*>(be), mid, r, se, ds, s, dsv, ub, dsu);
  se_wgrad_kernel<<<cdiv(2LL * r * mid + mid + r, kThreads), kThreads, 0,
                    st>>>(s, dsv, ub, dsu, B, mid, r,
                          static_cast<float*>(dwr), static_cast<float*>(dbr),
                          static_cast<float*>(dwe), static_cast<float*>(dbe));
  // BN2's sums (and a3), then dy2
  CHECK(launch_pass<kSums>(y2m, dy3m, wpm, a3m, g2f, b2f, mv, se, ds,
                           nullptr, nullptr, pt, T, HW, tps, mid, cout, 0.f,
                           st));
  tile_sums_kernel<<<sums_grid, 1024, 0, st>>>(pt, T, tps, mid, samp);
  reduce(samp, 2, B, mid, db2f, dg2f, 0.f, st);
  CHECK(launch_pass<kApply>(y2m, dy3m, wpm, dy2m, g2f, b2f, mv, se, ds,
                            db2f, dg2f, pt, T, HW, tps, mid, cout,
                            1.f / (float)N, st));
  // dwproj = a3^T . dy3, fixed-order group sums
  CHECK(hg::wgrad(a3, dy3, static_cast<float*>(wpart), groups, dwproj,
                  nullptr, (int)N, mid, cout, st));
  return (int)cudaGetLastError();
}

// Bytes of scratch mbconv_ka_bwd needs.
long long mbconv_ka_bwd_scratch(int B, int H, int W, int cin, int mid, int k,
                                int expand, int groups) {
  return (long long)ka_scratch(nullptr, B, H, W, cin, mid, k, expand != 0,
                               groups)
      .bytes;
}

// x: (B, H, W, cin) bf16; dy2: (B, H, W, mid) bf16; wexp, g1, b1 as
// mbconv_ka_fwd (null without an expand, then mid == cin; expand says
// which); wdw: (k*k, mid) bf16; mv1: (2, mid) f32 m1, v1 (null without an
// expand); outs: dx (B, H, W, cin) bf16, dwexp (cin, mid), dwdw (k*k,
// mid), dg1, db1 (mid) f32 (dwexp, dg1, db1 null without an expand). cin
// and mid multiples of 8 (16-byte rows), x and dy2 16-byte aligned; k
// odd, 1 to kMaxK; groups: dwexp's row groups, 1 <= groups <= ceil(B H W
// / 64) with an expand. Returns a cudaError_t code.
int mbconv_ka_bwd(const void* x, const void* dy2, const void* wexp,
                  const void* g1, const void* b1, const void* wdw,
                  const void* mv1, void* dx, void* dwexp, void* dwdw,
                  void* dg1, void* db1, void* scratch, int B, int H, int W,
                  int cin, int mid, int k, int expand, int groups,
                  void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin < 1 || mid < 1 || !kernel_size_ok(k) ||
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
    return with_k(k, [&](auto kk) {
      return launch_dw_bwd<decltype(kk)::value>(apply, xb, s.y1, dy2b, g1f,
                                                b1f, mv, wd, db1f, dg1f, out,
                                                s.dwp, s.bnp, g, st);
    });
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
