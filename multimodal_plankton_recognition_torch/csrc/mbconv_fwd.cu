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
// below the card's bf16 ridge (about 295). The design reads each byte
// once where the TPU kernel recomputes, computes each SiLU once, keeps
// the products on the tensor cores (csrc/hopper_gemm.cuh's building
// blocks: TMA, wgmma) and moves elementwise work into 16-byte passes:
//   13: (i) y1 = bf16(x . wexp) on the shared row GEMM (gemm_sums, the y1
//       kernel 16 makes), stored once (at most 58 MB at B0's widths, B
//       64), with each 64-row chunk's column sums of the rounded y1 and
//       y1^2 from its epilogue; (ii) reduce -> m1, v1; (iii) a1 in place
//       of y1 (ka_a1_kernel, 8 channels a thread); (iv) the depthwise pass
//       (ka_dw_kernel): persistent blocks load each tile's a1 halo (x
//       without an expand) by 16-byte cp.async, the next tile's while
//       this one's stencil runs, two channels and two pixels a thread,
//       and write y2 and each tile's column sums of the rounded y2 and
//       y2^2; (v) reduce -> m2, v2. Making a1 inside the depthwise pass,
//       once per halo element, cost that pass more than it spared (1.4-2.5
//       conversions an output at B0's widths).
//   14: (i) per (sample, 64-pixel tile, 64 channels) a2 of a TMA box of
//       y2, stored once in bf16, and its column sums in kernel 15's
//       order; (ii) the SE chain per sample, with the steps and sum order
//       kernel 15 recomputes them in, so that s and se are its bits;
//       (iii) the projection (kb_proj_kernel): a producer warp streams a2
//       boxes (and, past 4 boxes of mid, wproj boxes; below, the wproj
//       slice stays resident) by TMA through a ring; the consumer
//       warpgroup turns each a2 box into a3 = bf16(a2 se) in place and
//       runs wgmma m64n64k16 on it; the epilogue rounds y3, stores it by
//       TMA and writes each tile's column sums; (iv) reduce -> m3, v3.
//       Making a2 from y2 boxes in the projection instead, with no a2
//       store, made kernel 14 1.4-1.8 times slower on an H100 at B0's
//       widths: the exact SiLU there holds up the wgmma warpgroup, once
//       per 64 columns of cout.
// Every sum over pixels is per-block partials added in index order (no
// float atomics): two calls agree bit for bit. cin, mid and cout must be
// multiples of 8 (TMA's and cp.async's 16-byte rows); ops/mbconv.py pads
// other channel counts with zero channels, on the weights and where
// needed the activations (kernel_channels). k: every odd size from 1 to
// kMaxK (mbconv.cuh). The kernels launch on the caller's stream, do not
// synchronise and allocate nothing (the caller passes scratch laid out as
// ops/mbconv.py ka_fwd_scratch / kb_fwd_scratch say); the entry points
// return a cudaError_t code.

#include "hopper_gemm.cuh"
#include "mbconv.cuh"

namespace {

using hg::boxes;
using hg::bulk_commit;
using hg::bulk_wait;
using hg::bulk_wait_read;
using hg::desc_k;
using hg::desc_mn;
using hg::fence_async_smem;
using hg::fence_regs;
using hg::kBox;
using hg::mbar_arrive;
using hg::mbar_expect_tx;
using hg::mbar_fence_init;
using hg::mbar_init;
using hg::mbar_wait;
using hg::pack2;
using hg::smem_u32;
using hg::swz;
using hg::tma_load;
using hg::tma_load3;
using hg::tma_store3;
using hg::wgmma64;
using hg::wgmma_commit;
using hg::wgmma_fence;
using hg::wgmma_wait;

// ------------------------ reductions over many rows ------------------------

constexpr int kRowGroup = 256;  // partial rows a first-level block adds

// mbconv.cuh's reduce for partials of many rows: first the sums of each
// 256-row group (tile_sums_kernel, into level: arrays x ceil(T / 256) x C
// f32), then reduce over those
inline void reduce_tall(const float* part, int nar, int T, int C,
                        float* out0, float* out1, float n, float* level,
                        cudaStream_t s) {
  if (T <= kRowGroup) {
    reduce(part, nar, T, C, out0, out1, n, s);
    return;
  }
  const int G = cdiv(T, kRowGroup);
  tile_sums_kernel<<<dim3(G, cdiv(C, 32), nar), 1024, 0, s>>>(
      part, T, kRowGroup, C, level);
  reduce(level, nar, G, C, out0, out1, n, s);
}

// blocks of kernel that fit on one SM with `smem` bytes of dynamic
// shared memory (at least 1)
template <class Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return 1;
  return n < 1 ? 1 : n;
}

// --------------------------- kernel 13 ------------------------------------

// the depthwise pass's halo row stride, in pixels: odd and above hc
__host__ __device__ inline int halo_stride(int hc) {
  return hc % 2 ? hc + 2 : hc + 1;
}

// (iii) of kernel 13: a1 = bf16(SiLU(bf16(xhat1 g1 + b1))) in place of
// y1, 16 bytes (8 channels) a thread and step: chunk i holds channels
// 8 (i % cpr) .. + 8 of row i / cpr (cpr = mid / 8). The same bits as
// kernel 16 makes a1 from y1 with (mbconv.cuh silu). BN1's four values
// per channel sit in shared memory, one array each.
__global__ void __launch_bounds__(kThreads)
    ka_a1_kernel(uint4* __restrict__ y1, const float* __restrict__ g1,
                 const float* __restrict__ b1, const float* __restrict__ mv1,
                 int chunks, int mid) {
  extern __shared__ __align__(16) float bn[];  // m1, inv1, g1, b1: 4 mid
  for (int c = threadIdx.x; c < mid; c += kThreads) {
    bn[c] = mv1[c];
    bn[mid + c] = inv_std(mv1[mid + c]);
    bn[2 * mid + c] = g1[c];
    bn[3 * mid + c] = b1[c];
  }
  __syncthreads();
  const int cpr = mid / 8, step = gridDim.x * kThreads, dcc = step % cpr;
  int i = blockIdx.x * kThreads + threadIdx.x, cc = i % cpr;
  for (; i < chunks; i += step) {
    const uint4 v = y1[i];
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float p[4][8];  // the chunk's channels' m1, inv1, g1, b1
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4* q = reinterpret_cast<const float4*>(bn + a * mid + 8 * cc);
      const float4 u = q[0], x = q[1];
      p[a][0] = u.x; p[a][1] = u.y; p[a][2] = u.z; p[a][3] = u.w;
      p[a][4] = x.x; p[a][5] = x.y; p[a][6] = x.z; p[a][7] = x.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 y =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      const int c = 2 * e;
      w[e] = pack2(
          silu(rb((y.x - p[0][c]) * p[1][c] * p[2][c] + p[3][c])),
          silu(rb((y.y - p[0][c + 1]) * p[1][c + 1] * p[2][c + 1] +
                   p[3][c + 1])));
    }
    y1[i] = make_uint4(w[0], w[1], w[2], w[3]);
    cc += dcc;
    if (cc >= cpr) cc -= cpr;
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the N most recent committed groups have landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (iv) of kernel 13: grid (G, mid / CC). Block (gb, s) owns channels c0 =
// CC s .. + CC and walks DwTile's tiles gb, gb + G, ..., two halo buffers
// deep: the next tile's halo of a1 (ka_a1_kernel's, or x without an
// expand) loads by 16-byte cp.async while this one is computed. The zero
// fill past the image is the padding of a1, where the TPU kernel pads;
// then the k x k stencil in f32 (i, then j). Thread t:
// channels c0 + 2 (t % 16) (+ 1), the output pairs t / 16, + 16, ...
// (pair p: row p % rows, columns 2 (p / rows) and + 1; each halo column
// it reads serves both outputs). The halo's rows are hs pixels apart, hs
// odd and past the halo's columns, so that the two half-warps (rows r and
// r + 1) read disjoint banks and the last pair of an odd width may read
// one column past the halo. part: each tile's column sums of the rounded
// y2 at part[tile][c], of y2^2 at part[T + tile][c].
template <int K>
__global__ void __launch_bounds__(kThreads)
    ka_dw_kernel(const bf16* __restrict__ a1, const bf16* __restrict__ wdw,
                 bf16* __restrict__ y2, float* __restrict__ part, DwTile g) {
  constexpr int P = K / 2, CP = CC / 2, kPixGroups = kThreads / CP;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][kPixGroups][CC];
  const int rt = g.row_tiles(), ct = g.col_tiles(), T = g.tiles();
  const int c0 = blockIdx.y * CC, hr = g.hr();
  const int hs = halo_stride(g.hc()), mid = g.mid;
  const int elems = hr * hs * CP;  // bf16 pairs of one halo buffer
  __nv_bfloat162* halos = reinterpret_cast<__nv_bfloat162*>(smem);
  auto issue = [&](int t, int buf) {  // the halo of tile t into buf
    const int b = t / (rt * ct), rem = t % (rt * ct);
    load_box(a1, g, b, (rem / ct) * kDwTH, (rem % ct) * g.tw, c0, P, hr, hs,
             reinterpret_cast<bf16*>(halos + buf * elems));
    cp_commit();
  };
  if ((int)blockIdx.x < T) issue(blockIdx.x, 0);

  const int cp = threadIdx.x % CP, grp = threadIdx.x / CP;
  const int ch = c0 + 2 * cp;  // and ch + 1: mid is even
  const bool in = ch < mid;
  // the channel pair's k x k weights, in registers up to kRegK, else read
  // (through L1) where used, one stencil row at a time (a row loop that is
  // not unrolled, so that the compiler cannot hoist all k^2 into
  // registers)
  constexpr bool kRegW = K <= kRegK;
  constexpr int kRowUnroll = kRegW ? K : 1;
  float wk[kRegW ? K * K : 1][2];
  if constexpr (kRegW) {
#pragma unroll
    for (int t = 0; t < K * K; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        wk[t][e] = in ? f32(wdw[(size_t)t * mid + ch + e]) : 0.f;
  }
  auto weight = [&](int t, int e) {
    if constexpr (kRegW)
      return wk[t][e];
    else
      return f32(wdw[(size_t)t * mid + ch + e]);
  };
  int k = 0;
  for (int t = blockIdx.x; t < T; t += gridDim.x, ++k) {
    if (t + (int)gridDim.x < T) {
      issue(t + gridDim.x, (k + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // this tile's halo has landed for every thread
    __nv_bfloat162* halo = halos + (k & 1) * elems;
    const int b = t / (rt * ct), rem = t % (rt * ct);
    const int r0 = (rem / ct) * kDwTH, w0 = (rem % ct) * g.tw;

    const int rows = min(kDwTH, g.H - r0), cols = min(g.tw, g.W - w0);
    const int pairs = (cols + 1) / 2;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    if (in) {
      // pair pp = grp + 16 j, its row and column kept without divisions
      const int drow = kPixGroups % rows, dcol = 2 * (kPixGroups / rows);
      int row = grp % rows, col = 2 * (grp / rows);
      for (int pp = grp; pp < rows * pairs; pp += kPixGroups) {
        float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [pixel][channel]
#pragma unroll kRowUnroll
        for (int i = 0; i < K; ++i) {
          float2 a[K + 1];
#pragma unroll
          for (int j = 0; j <= K; ++j)  // the last serves the second pixel
            a[j] = __bfloat1622float2(
                halo[((row + i) * hs + col + j) * CP + cp]);
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float w0 = weight(i * K + j, 0), w1 = weight(i * K + j, 1);
            acc[0][0] = fmaf(a[j].x, w0, acc[0][0]);
            acc[0][1] = fmaf(a[j].y, w1, acc[0][1]);
            acc[1][0] = fmaf(a[j + 1].x, w0, acc[1][0]);
            acc[1][1] = fmaf(a[j + 1].y, w1, acc[1][1]);
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 1 && col + 1 >= cols) break;
          const uint32_t y = pack2(acc[q][0], acc[q][1]);
          *reinterpret_cast<uint32_t*>(
              y2 + (((size_t)b * g.H + r0 + row) * g.W + w0 + col + q) * mid +
              ch) = y;
          const float2 yf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&y));
          s1[0] += yf.x;
          s1[1] += yf.y;
          s2[0] += yf.x * yf.x;
          s2[1] += yf.y * yf.y;
        }
        row += drow;
        col += dcol;
        if (row >= rows) {
          row -= rows;
          col += 2;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      red[0][grp][2 * cp + e] = s1[e];
      red[1][grp][2 * cp + e] = s2[e];
    }
    __syncthreads();  // also: every thread is done with this halo
    if (threadIdx.x < 2 * CC) {
      const int a = threadIdx.x / CC, c = threadIdx.x % CC;
      if (c0 + c < mid) {
        float sum = 0.f;
        for (int q = 0; q < kPixGroups; ++q) sum += red[a][q][c];
        part[((size_t)a * T + t) * mid + c0 + c] = sum;
      }
    }
    __syncthreads();  // red is read before the next tile writes it
  }
}

// as many blocks as fit on the card at once, spread over the channel
// slices, each walking its share of the tiles
template <int K>
cudaError_t launch_ka_dw(const bf16* a1, const bf16* wdw, bf16* y2,
                         float* part, const DwTile& g, cudaStream_t s) {
  const size_t smem = 2 * (size_t)g.hr() * halo_stride(g.hc()) * CC * 2;
  cudaError_t err = cudaFuncSetAttribute(
      ka_dw_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int slices = cdiv(g.mid, CC), T = g.tiles();
  long long G = (long long)hg::sm_count() *
                blocks_per_sm(ka_dw_kernel<K>, kThreads, smem) / slices;
  G = G < 1 ? 1 : (G > T ? T : G);
  ka_dw_kernel<K><<<dim3((int)G, slices), kThreads, smem, s>>>(a1, wdw, y2,
                                                                part, g);
  return cudaGetLastError();
}

// --------------------------- kernel 14 ------------------------------------

// (i) of kernel 14: grid (G, mid / 64). Block (g, j) owns channels j0 = 64
// j .. + 64 and the tiles [g T / G, (g + 1) T / G) in order, two TMA
// stages deep (tile k + 2 loads into the stage tile k leaves); tile t is
// pixels [64 (t % tps), + 64) of sample t / tps, one box of the 3-D map
// (B, HW, mid): zeros past HW and past mid. Writes a2 of the box (bf16,
// in place, then out by TMA: the map clips past HW and mid), and
// part[t][c] = the sum of a2 over the tile's pixels < HW, in kernel 15's
// kDse order: thread t holds pixels r, r + 8 and channels 8 i + cq (+ 1)
// of the box, adds its two pixels, then the lanes of a column (xor 4, 8,
// 16), then the 4 warps in order.
__global__ void __launch_bounds__(128)
    kb_squeeze_kernel(const __grid_constant__ CUtensorMap y2_map,
                      const __grid_constant__ CUtensorMap a2_map,
                      const float* __restrict__ g2,
                      const float* __restrict__ b2,
                      const float* __restrict__ m2,
                      const float* __restrict__ v2, float* __restrict__ part,
                      int T, int HW, int tps, int mid) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float par[64 * 4];  // m2, 1 / sqrt(v2 + eps), g2, b2
  __shared__ float red[2][4 * 64];
  __shared__ uint64_t full[2];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int j0 = blockIdx.y * 64;
  const int t0 = (int)((long long)blockIdx.x * T / gridDim.x);
  const int n = (int)((long long)(blockIdx.x + 1) * T / gridDim.x) - t0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto load = [&](int k) {  // tile t0 + k into stage k % 2
    const int t = t0 + k, st = k & 1;
    const uint32_t bar = smem_u32(&full[st]);
    mbar_expect_tx(bar, kBox);
    tma_load3(base + st * kBox, &y2_map, bar, j0, (t % tps) * 64, t / tps);
  };
  if (tid == 0) {
    mbar_init(smem_u32(&full[0]), 1);
    mbar_init(smem_u32(&full[1]), 1);
    mbar_fence_init();
    if (n > 0) load(0);
    if (n > 1) load(1);
  }
  if (tid < 64) {
    const int ch = j0 + tid;
    const bool in = ch < mid;
    par[tid * 4 + 0] = in ? m2[ch] : 0.f;
    par[tid * 4 + 1] = in ? inv_std(v2[ch]) : 0.f;
    par[tid * 4 + 2] = in ? g2[ch] : 0.f;
    par[tid * 4 + 3] = in ? b2[ch] : 0.f;
  }
  __syncthreads();

  const int r = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  for (int k = 0; k < n; ++k) {
    const int t = t0 + k, st = k & 1;
    const int b = t / tps, p0 = (t % tps) * 64;
    uint8_t* box = smem_raw + (base - raw) + st * kBox;
    mbar_wait(smem_u32(&full[st]), (k >> 1) & 1);
    float c0[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c0[2 * i] = c0[2 * i + 1] = 0.f;
      if (j0 + 8 * i >= mid) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        const bool valid = p0 + row < HW;
        uint32_t* yp =
            reinterpret_cast<uint32_t*>(box + swz(row, 8 * i + cq));
        const float2 yv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(yp));
        float a[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* q = par + (8 * i + cq + e) * 4;
          const float y = e ? yv.y : yv.x;
          a[e] = rb(silu(rb((y - q[0]) * q[1] * q[2] + q[3])));
          c0[2 * i + e] += valid ? a[e] : 0.f;
        }
        *yp = pack2(a[0], a[1]);  // a2: exact in bf16
      }
    }
    fence_async_smem();
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        c0[q] += __shfl_xor_sync(0xffffffffu, c0[q], o);
    float* rd = red[k & 1];
    if (lane < 4)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rd[warp * 64 + 8 * i + cq + e] = c0[2 * i + e];
    __syncthreads();  // a2 written, the sums in red, the box read
    if (tid == 0) {
      tma_store3(&a2_map, base + st * kBox, j0, p0, b);
      bulk_commit();
      if (k + 2 < n) {
        bulk_wait_read();  // the store has left the stage
        load(k + 2);
      }
    }
    if (tid < 64 && j0 + tid < mid)
      part[(size_t)t * mid + j0 + tid] =
          ((rd[tid] + rd[64 + tid]) + rd[128 + tid]) + rd[192 + tid];
  }
  if (tid == 0) bulk_wait_read();  // the last store has left shared memory
}

// (ii) of kernel 14: grid (B, ceil(mid / 512)), 512 threads. Block (b, q)
// takes sample b's s and ub, then se[b * mid + c] for the channels c of
// chunk q, with mbconv.cuh's SE steps: the bits kernel 15 recomputes
// (tile_sums_kernel, then se_sample). With sample (B, mid), s reads the
// per-sample sums tile_sums_kernel made; without (a sample of at most 32
// tiles), it adds the tiles' sums of a2 (sq: (T, mid)) as that kernel
// does, tile q as lane q's, in order, one thread a channel.
constexpr int kSeThreads = 512;
__global__ void __launch_bounds__(kSeThreads)
    se_fwd_kernel(const float* __restrict__ sq,
                  const float* __restrict__ sample, int tps, int HW,
                  const bf16* __restrict__ wr, const float* __restrict__ br,
                  const bf16* __restrict__ we, const float* __restrict__ be,
                  float* __restrict__ se, int mid, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  float* ub = s + mid;
  const int b = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* sqb = sq + (size_t)b * tps * mid;
  for (int c = threadIdx.x; c < mid; c += kSeThreads) {
    if (sample) {
      s[c] = se_s(sample, 1, HW, b, mid, c);
    } else {
      float sum = 0.f;
      for (int q = 0; q < 32; ++q)
        sum += q < tps ? 0.f + sqb[(size_t)q * mid + c] : 0.f;
      s[c] = se_s(&sum, 1, HW, 0, 1, 0);
    }
  }
  __syncthreads();
  for (int j = warp; j < r; j += kSeThreads / 32) {
    const float v = se_su(s, wr, br, mid, r, j, lane);
    if (lane == 0) ub[j] = rb(silu(v));
  }
  __syncthreads();
  const int c = blockIdx.y * kSeThreads + threadIdx.x;
  if (c < mid) se[(size_t)b * mid + c] = se_out(ub, we, be, mid, r, c);
}

// (iii) of kernel 14, the projection. Shared memory, from a 1024-byte
// boundary: with RES, the block's wproj slice, resident (kb boxes of 64
// channels x 64 of cout); `stages` ring slots of one a2 box (64 pixels x
// 64 channels) and, without RES, its wproj box; the y3 staging box; the
// warps' column sums (2 x 4 x 64 floats); the mbarriers. RES where mid
// has at most 4 boxes (B0's first three blocks, cout 16-40): streaming
// the slice with every tile made TMA fetch its narrow rows again and
// again, which cost more than the rest of the kernel there; at the wider
// mids the resident slice would hold one block to an SM.
struct ProjSmem {
  int kb, stages;
  bool res;
  __host__ __device__ uint32_t stage_bytes() const {
    return res ? kBox : 2 * kBox;
  }
  __host__ __device__ uint32_t ring() const {
    return res ? (uint32_t)kb * kBox : 0u;
  }
  __host__ __device__ uint32_t staging() const {
    return ring() + stages * stage_bytes();
  }
  __host__ __device__ uint32_t red() const { return staging() + kBox; }
  __host__ __device__ uint32_t bar() const { return red() + 2 * 4 * 64 * 4; }
  __host__ __device__ size_t bytes() const {
    return bar() + 16 * stages + 8 + 1024;
  }
};

// grid (cout / 64, G). Block (s, g): columns [64 s, + 64) of y3 over the
// tiles g, g + G, ... (tile t: pixels [64 (t % tps), + 64) of sample t /
// tps; the 3-D maps (B, HW, C) load zeros past HW and mid, and clip
// stores there). Warp 4 is the producer: with RES the wproj slice once,
// then per tile, for each 64-channel box q of mid, the a2 box (and
// without RES the wproj box q) into the next ring stage. Warps 0-3 turn
// the a2 box into a3 = bf16(a2 se) in place (lane l of warp w: the 8
// channels of chunk c = 2 w + l / 16 of the box, in rows l % 16 + 16 i,
// which the 128-byte swizzle puts at 16-byte chunk c ^ (row % 8) of the
// row; a warp whose channels lie past mid leaves TMA's zeros), fence it
// for the async proxy and run y3 += a3 . wproj on wgmma (A K-major, B
// N-major). Epilogue: y3 rounded into the staging box and
// stored by TMA; the tile's column sums of the rounded y3 and y3^2 at
// part[t][c], part[T + t][c] (rows past HW are 0, as their a2 is).
template <bool RES>
__global__ void __launch_bounds__(160)
    kb_proj_kernel(const __grid_constant__ CUtensorMap a2_map,
                   const __grid_constant__ CUtensorMap wp_map,
                   const __grid_constant__ CUtensorMap y3_map,
                   const float* __restrict__ se, float* __restrict__ part,
                   int T, int tps, int mid, int cout, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gen = smem_raw + (base - raw);
  const int kb = boxes(mid), n0 = blockIdx.x * 64;
  const ProjSmem L{kb, stages, RES};
  const uint32_t c_s = base + L.staging();
  uint8_t* c_gen = gen + L.staging();
  float* red = reinterpret_cast<float*>(gen + L.red());
  const uint32_t full = base + L.bar(), empty = full + 8 * stages;
  const uint32_t w_full = empty + 8 * stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // each consumer warp
    }
    mbar_init(w_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer: one thread issues every load
    if (lane == 0) {
      if (RES) {
        mbar_expect_tx(w_full, (uint32_t)kb * kBox);
        for (int q = 0; q < kb; ++q)
          tma_load(base + q * kBox, &wp_map, w_full, n0, q * 64);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.y; t < T; t += gridDim.y) {
        const int b = t / tps, p0 = (t % tps) * 64;
        for (int q = 0; q < kb; ++q) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          const uint32_t dst = base + L.ring() + stage * L.stage_bytes();
          mbar_expect_tx(bar, L.stage_bytes());
          tma_load3(dst, &a2_map, bar, q * 64, p0, b);
          if (!RES) tma_load(dst + kBox, &wp_map, bar, n0, q * 64);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lc = 2 * warp + (lane >> 4), row0 = lane & 15;
  const int r = warp * 16 + (lane >> 2), cq = (lane & 3) * 2;
  const int groups = min(8, (cout - n0 + 7) / 8);  // column groups of y3
  if (RES) mbar_wait(w_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const int b = t / tps, p0 = (t % tps) * 64;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int q = 0; q < kb; ++q) {
      const int ch = q * 64 + 8 * lc;
      const bool in = ch < mid;  // the same for the whole warp
      float ps[8];
      if (in) {
        const float4* sp =
            reinterpret_cast<const float4*>(se + (size_t)b * mid + ch);
        const float4 u = __ldg(sp), v = __ldg(sp + 1);
        ps[0] = u.x; ps[1] = u.y; ps[2] = u.z; ps[3] = u.w;
        ps[4] = v.x; ps[5] = v.y; ps[6] = v.z; ps[7] = v.w;
      }
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a_s = base + L.ring() + stage * L.stage_bytes();
      const uint32_t w_s = RES ? base + q * kBox : a_s + kBox;
      uint8_t* box = gen + (a_s - base);
      if (in) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row0 + 16 * i;
          uint4* p = reinterpret_cast<uint4*>(box + row * 128 +
                                              ((lc ^ (row & 7)) << 4));
          const uint4 v = *p;
          uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a =
                __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
            w[e] = pack2(a.x * ps[2 * e], a.y * ps[2 * e + 1]);  // a3
          }
          *p = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      fence_async_smem();
      hg::bar_sync(1, 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma64<0, 1>(acc, desc_k(a_s + kk * 32), desc_mn(w_s + kk * 2048));
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: one rounding, the staging box, the column sums; column
    // groups past cout (the store clips them) are skipped, a branch the
    // whole block takes alike
    if (tid == 0) bulk_wait_read();  // the last tile's store left staging
    hg::bar_sync(1, 128);
    float c0[16], c1[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c0[2 * i] = c0[2 * i + 1] = c1[2 * i] = c1[2 * i + 1] = 0.f;
      if (i >= groups) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t y = pack2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(c_gen + swz(r + 8 * h, 8 * i + cq)) = y;
        const float2 yf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
        c0[2 * i] += yf.x;
        c0[2 * i + 1] += yf.y;
        c1[2 * i] += yf.x * yf.x;
        c1[2 * i + 1] += yf.y * yf.y;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          c0[2 * i + e] += __shfl_xor_sync(0xffffffffu, c0[2 * i + e], o);
          c1[2 * i + e] += __shfl_xor_sync(0xffffffffu, c1[2 * i + e], o);
        }
    }
    if (lane < 4)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[warp * 64 + 8 * i + cq + e] = c0[2 * i + e];
          red[256 + warp * 64 + 8 * i + cq + e] = c1[2 * i + e];
        }
    fence_async_smem();
    hg::bar_sync(1, 128);
    if (tid == 0) {
      tma_store3(&y3_map, c_s, n0, p0, b);
      bulk_commit();
    }
    const int c = tid & 63, w = tid >> 6;  // w: which of the two sums
    if (n0 + c < cout) {
      const float* rw = red + w * 256 + c;
      part[((size_t)w * T + t) * cout + n0 + c] =
          ((rw[0] + rw[64]) + rw[128]) + rw[192];
    }
  }
  if (tid == 0) bulk_wait();
}

// RES with 4 ring stages where mid has at most 4 boxes, else 2 stages of
// a2 and wproj boxes; as many blocks as fit on the card at once, each
// walking its share of a cout slice's tiles
template <bool RES>
cudaError_t launch_proj_as(const CUtensorMap& a2m, const CUtensorMap& wpm,
                           const CUtensorMap& y3m, const float* se,
                           float* part, int T, int tps, int mid, int cout,
                           cudaStream_t s) {
  const int stages = RES ? 4 : 2;
  const size_t smem = ProjSmem{boxes(mid), stages, RES}.bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kb_proj_kernel<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int slices = boxes(cout);
  long long g = (long long)hg::sm_count() *
                blocks_per_sm(kb_proj_kernel<RES>, 160, smem) / slices;
  g = g < 1 ? 1 : (g > T ? T : g);
  kb_proj_kernel<RES><<<dim3(slices, (int)g), 160, smem, s>>>(
      a2m, wpm, y3m, se, part, T, tps, mid, cout, stages);
  return cudaGetLastError();
}

cudaError_t launch_proj(const CUtensorMap& a2m, const CUtensorMap& wpm,
                        const CUtensorMap& y3m, const float* se, float* part,
                        int T, int tps, int mid, int cout, cudaStream_t s) {
  return boxes(mid) <= 4
             ? launch_proj_as<true>(a2m, wpm, y3m, se, part, T, tps, mid,
                                    cout, s)
             : launch_proj_as<false>(a2m, wpm, y3m, se, part, T, tps, mid,
                                     cout, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

#define CHECK(call)                        \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// x: (B, H, W, cin) bf16; wexp: (cin, mid) bf16 or null (expand 0, then
// mid == cin); g1, b1: (mid) f32 (null without an expand); wdw: (k*k, mid)
// bf16; y2: (B, H, W, mid) bf16 out; stats: (4, mid) f32 out m1, v1, m2, v2
// (m1, v1 left as given without an expand). Scratch (ops/mbconv.py
// ka_fwd_scratch): y1 (B H W, mid) bf16; part1 (2, 2 ceil(B H W / 128),
// mid), part2 (2, tiles, mid) and level (2, ceil(max(rows) / 256), mid)
// f32 (y1 and part1 unused without an expand). cin and mid multiples of
// 8; x, wexp and y1 16-byte aligned; k odd, 1 to kMaxK. Returns a
// cudaError_t code.
int mbconv_ka_fwd(const void* x, const void* wexp, const void* g1,
                  const void* b1, const void* wdw, void* y2, void* stats,
                  void* y1, void* part1, void* part2, void* level, int B,
                  int H, int W, int cin, int mid, int k, int expand,
                  void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin < 1 || mid < 1 || !kernel_size_ok(k) ||
      cin % 8 || mid % 8 || (expand != 0) != (wexp != nullptr) ||
      (!expand && cin != mid) || !aligned16(x) ||
      (expand && !aligned16(y1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = (long long)B * H * W;
  float* st = static_cast<float*>(stats);
  float* lv = static_cast<float*>(level);
  if (expand) {
    // y1 = bf16(x . wexp) once, with its 64-row chunks' column sums
    float* p1 = static_cast<float*>(part1);
    CHECK(hg::gemm_sums(x, wexp, y1, p1, (int)N, mid, cin, s));
    reduce_tall(p1, 2, 2 * cdiv(N, hg::kBM), mid, st, st + mid, (float)N,
                lv, s);
  }
  if (expand) {  // a1 in place of y1
    const int chunks = (int)(N * mid / 8);
    int grid = cdiv(chunks, kThreads), most = hg::sm_count() * 8;
    grid = grid < most ? grid : most;
    ka_a1_kernel<<<grid, kThreads, 4 * (size_t)mid * 4, s>>>(
        static_cast<uint4*>(y1), static_cast<const float*>(g1),
        static_cast<const float*>(b1), st, chunks, mid);
  }
  const DwTile g = dw_tile(B, H, W, mid, k, expand != 0);
  const bf16* a1 = static_cast<const bf16*>(expand ? y1 : x);
  const bf16* wd = static_cast<const bf16*>(wdw);
  bf16* y2b = static_cast<bf16*>(y2);
  float* p2 = static_cast<float*>(part2);
  CHECK(with_k(k, [&](auto kk) {
    return launch_ka_dw<decltype(kk)::value>(a1, wd, y2b, p2, g, s);
  }));
  reduce_tall(p2, 2, g.tiles(), mid, st + 2 * mid, st + 3 * mid, (float)N,
              lv, s);
  return (int)cudaGetLastError();
}

// y2: (B, H, W, mid) bf16; g2, b2, m2, v2: (mid) f32;
// wr: (mid, r) bf16; br: (r) f32; we: (r, mid) bf16; be: (mid) f32;
// wproj: (mid, cout) bf16; y3: (B, H, W, cout) bf16 out; stats: (2, cout)
// f32 out m3, v3. Scratch (ops/mbconv.py kb_fwd_scratch): a2 (B H W,
// mid) bf16; f32: sq (T, mid) per-tile sums of a2 (T = B ceil(H W /
// 64)), sample (B, mid), se (B, mid), part (2, T, cout), level (2,
// ceil(T / 256), cout). mid and cout multiples of 8; y2, wproj, y3, a2
// and se 16-byte aligned. Returns a cudaError_t code.
int mbconv_kb_fwd(const void* y2, const void* g2, const void* b2,
                  const void* m2, const void* v2, const void* wr,
                  const void* br,
                  const void* we, const void* be, const void* wproj, void* y3,
                  void* stats, void* a2, void* sq, void* sample, void* se,
                  void* part, void* level, int B, int H, int W, int mid,
                  int r, int cout, void* stream) {
  if (B < 1 || H < 1 || W < 1 || mid < 1 || r < 1 || cout < 1 || mid % 8 ||
      cout % 8 || !aligned16(se))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W, tps = cdiv(HW, 64), T = B * tps;
  const long long N = (long long)B * HW;
  CUtensorMap y2m, a2m, wpm, y3m;
  if (!hg::make_map3(&y2m, y2, B, HW, mid, 64) ||
      !hg::make_map3(&a2m, a2, B, HW, mid, 64) ||
      !hg::make_map(&wpm, wproj, mid, cout, 64) ||
      !hg::make_map3(&y3m, y3, B, HW, cout, 64))
    return (int)cudaErrorInvalidValue;
  float* sqf = static_cast<float*>(sq);
  float* sef = static_cast<float*>(se);
  float* pt = static_cast<float*>(part);
  float* st = static_cast<float*>(stats);

  // a2 and the squeeze sums per tile; the SE chain per sample
  const size_t sq_smem = 2 * kBox + 1024;
  long long G = (long long)hg::sm_count() *
                blocks_per_sm(kb_squeeze_kernel, 128, sq_smem) / boxes(mid);
  G = G < 1 ? 1 : (G > T ? T : G);
  kb_squeeze_kernel<<<dim3((int)G, boxes(mid)), 128, sq_smem, s>>>(
      y2m, a2m, static_cast<const float*>(g2), static_cast<const float*>(b2),
      static_cast<const float*>(m2), static_cast<const float*>(v2), sqf, T,
      HW, tps, mid);
  float* samp = nullptr;
  if (tps > 32) {  // the per-sample sums in parallel first
    samp = static_cast<float*>(sample);
    tile_sums_kernel<<<dim3(B, cdiv(mid, 32), 1), 1024, 0, s>>>(sqf, T, tps,
                                                                mid, samp);
  }
  se_fwd_kernel<<<dim3(B, cdiv(mid, kSeThreads)), kSeThreads,
                  ((size_t)mid + r) * 4, s>>>(
      sqf, samp, tps, HW, static_cast<const bf16*>(wr),
      static_cast<const float*>(br), static_cast<const bf16*>(we),
      static_cast<const float*>(be), sef, mid, r);
  // the projection, then BN3's statistics
  CHECK(launch_proj(a2m, wpm, y3m, sef, pt, T, tps, mid, cout, s));
  reduce_tall(pt, 2, T, cout, st, st + cout, (float)N,
              static_cast<float*>(level), s);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
