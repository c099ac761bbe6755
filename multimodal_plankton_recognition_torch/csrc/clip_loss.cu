// Bucketed symmetric InfoNCE (CLIP) loss, forward and backward, for Hopper
// (sm_90a). Plain C entry points, loaded with ctypes by ops/contrastive.py.
//
// Replaces the TPU kernels
//   multimodal_plankton_recognition_tpu/ops/pallas/contrastive.py
//   ::_clip_fwd_kernel (through _clip_fwd) and ::_clip_bwd_kernel (through
//   _clip_bwd).
//
// Per bucket of N image rows x and N profile rows y of width D (bf16 or f32
// in, f32 inside), as the TPU kernels compute it:
//   nx = max(||x||, 1e-12), ny likewise;  s = (x / nx) . (y / ny)^T
//   z = s * exp(logit_scale)
//   loss = (sum_r (lse_r - z_rr) + sum_c (lse_c - z_cc)) * 0.5 / N
// and backward, with g the cotangent of the mean over buckets:
//   dz = g / buckets * 0.5 / N * ((softmax_r(z) - I) + (softmax_c(z) - I))
//   d logit_scale = sum(dz * s) * exp(logit_scale)
//   ds = dz * exp(logit_scale);  d_in = ds . (y / ny), d_pn = ds^T . (x / nx)
//   di = (d_in - (d_in . x/nx) x/nx) / nx, dp likewise.
//
// Rounding order. The TPU kernel normalises the rows and then takes their
// products; here s = (x . y) / (nx * ny): the products run on the raw rows
// and the norms come from the same staged chunks, so no pass of its own
// and no unit rows are stored. The projection uses
//   d_in . x/nx = sum_c ds_rc s_rc = q_r   (and q_c for the columns),
// so di = (d_in - (q_r / nx) x) / nx needs no second pass over D, and
// d_in = sum_c (ds_rc / ny_c) y_c runs on the raw rows too. All products
// are f32 FMAs on the CUDA cores. On bf16 rows the forward's products are
// exact in f32 (a bf16 x bf16 product is), so bf16 tensor cores with f32
// accumulation could take them at the same accuracy; the gradient GEMM's
// ds operand is f32, and there a bf16 or TF32 product would break the
// tolerances. At these sizes the kernels wait on latency, not on the FMA
// rate, so one product path serves both. Every sum is taken in a fixed
// order (split-K partials added in group order, line partials in tile
// order), so two calls agree bit for bit. No atomics but one completion
// ticket, reset by the block that takes it last.
//
// What bounds it. The work is 2 N^2 D products a bucket in the forward
// (on bf16 rows, at the tensor cores' rate: less time than reading the
// rows) and three times that in the backward (two thirds with an f32
// operand, at the CUDA cores' rate: about 2 us at the flagship's one
// bucket of 256), on 0.5 MB of embeddings. So the design is about
// spreading the products over the SMs, staging them through shared memory
// and keeping the round trips few:
//   * every kernel stages x and y in chunks of KC = 64 columns through a
//     ring of 16-byte cp.async stages (four for 32-row tiles, eight for
//     16-row ones; all but one in flight while one is used; a scalar path
//     where a row is not a whole number of 16-byte pieces), and a TILE x
//     TILE block of s runs in 4 x 4 register tiles,
//     the chunk's columns split over groups of threads whose partials are
//     added in group order;
//   * forward: a grid of (column tile, row tile, bucket). Each block
//     writes, for each row and column of its tile, the pair (max, sum of
//     exp) and, on the diagonal, z_rr; never the N x N logits. The last
//     block to finish (a ticket) merges the pairs in tile order
//     (m = max(m1, m2), s = s1 e^(m1 - m) + s2 e^(m2 - m)) into lse_r and
//     lse_c, and writes the loss's mean over buckets and the statistics
//     (lse_r, lse_c, nx, ny: 4 B floats) that autograd keeps for the
//     backward. The wrapper takes TILE = 16 up to N = 128 (more blocks;
//     one a bucket at the flagship's 16 x 16) and 32 above (fewer pairs
//     for the last block to merge), the crossover timed on the H100;
//   * backward, N <= 16 (one 16-row tile a bucket, latency-bound): one
//     block a bucket does everything in shared memory: s, dz, ds/ny and
//     ds/nx, the line sums q, then the gradients from register tiles over
//     the staged rows with the projection in the epilogue. The ring holds
//     all of D = 512 (eight stages), so those rows are read from device
//     memory once; a wider D streams through it again. One launch; the
//     buckets' d logit_scale partials are added by the last block. Timed
//     on the H100 against the two-kernel backward, it won at N = 16 and
//     lost with 32-row tiles at N = 20-32, so 32-row tiles take the two
//     kernels;
//   * backward, N > 16: clip_dz_kernel over (column tile, row tile,
//     bucket) recomputes s, writes ds/ny (k-major for d_in) and ds/nx (for
//     d_pn) to an N x NP f32 scratch (512 KB at N = 256: L2-resident), the
//     line partials of q and the block's sum of dz s; then clip_dx_kernel
//     over (D tile, row tile, side and bucket) runs d_in and d_pn as one
//     tiled GEMM over k = N with the projection in its epilogue.
// The statistics the forward keeps come in with the backward; without them
// the wrapper runs the forward kernel first, so given and recomputed
// statistics are the same bits.
//
// logit_scale and the cotangent are read from device memory, so no launch
// needs the host to read a device value. The kernels launch on the caller's
// stream, do not synchronise and allocate nothing; the entry points return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 64;       // embedding columns of one ring stage
constexpr int kStages = 4;   // ring depth of the d_in / d_pn GEMM
constexpr int kPad = 16;     // bytes after each staged row: 16-byte aligned,
                             // and rows 4 banks apart
constexpr int TR = 32;       // output rows of a d_in / d_pn tile (N > 16)
constexpr int TD = 64;       // embedding columns of a d_in / d_pn tile
constexpr int KB = 32;       // k rows of one d_in / d_pn stage
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// two neighbouring elements (the first at an even index) as f32
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 copies nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sum of one value per thread over the block, warps added in order; red
// holds kWarps floats
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// True in the block that finishes last among `blocks`; its reads of what
// the others wrote before their ticket must bypass L1 (__ldcg).
__device__ bool last_block(unsigned* ticket, unsigned blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == blocks - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The dot products of a TILE x TILE block: rows a[0, na) against rows
// b[0, nb) over D, and each row's norm.
template <typename T, int TILE>
struct Tile {
  static constexpr int kRow = KC * (int)sizeof(T) + kPad;  // bytes
  static constexpr int kStageBytes = 2 * TILE * kRow;
  // ring depth: 16-row tiles are latency-bound, so all of D = 512 is in
  // flight at once
  static constexpr int kDepth = TILE == 16 ? 8 : 4;
  static constexpr int kRingBytes = kDepth * kStageBytes;
  static constexpr int kSub = TILE / 4;  // a thread's rows and columns
                                         // lie kSub apart
  static constexpr int kGroupThreads = kSub * kSub;
  static constexpr int kGroups = kThreads / kGroupThreads;  // split-K
  static constexpr int kSlice = KC / kGroups;  // a group's stage columns
  static constexpr int kRowThreads = kThreads / (2 * TILE);  // per norm
  static constexpr int kLd = TILE + 1;  // row stride of the dot tile
  static_assert(kGroups * kGroupThreads == kThreads && kSlice % 2 == 0,
                "split-K groups");
  static_assert(kGroups * TILE * TILE * 4 <= kRingBytes,
                "the split-K partials overlay the ring");
  static_assert(KC % (2 * kRowThreads) == 0, "norm lanes");
};

// Stage columns [k0, k0 + KC) of rows a[0, TILE) and b[0, TILE): rows at
// or past na / nb and columns at or past D are zeros.
template <typename T, int TILE>
__device__ void load_stage(unsigned char* st, const T* a, int na,
                           const T* b, int nb, int D, int k0, bool vec) {
  constexpr int kRow = Tile<T, TILE>::kRow;
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T);  // elements of a piece
    constexpr int kPieces = KC / kPer;          // pieces of a row
    for (int p = threadIdx.x; p < 2 * TILE * kPieces; p += kThreads) {
      const int row = p / kPieces, q = p % kPieces;
      const bool side_b = row >= TILE;
      const int r = side_b ? row - TILE : row;
      const int col = k0 + q * kPer;
      const T* base = side_b ? b : a;
      const bool ok = r < (side_b ? nb : na) && col < D;
      cp_async16(st + row * kRow + q * 16,
                 ok ? base + (size_t)r * D + col : base, ok);
    }
  } else {
    for (int e = threadIdx.x; e < 2 * TILE * KC; e += kThreads) {
      const int row = e / KC, q = e % KC;
      const bool side_b = row >= TILE;
      const int r = side_b ? row - TILE : row;
      const int col = k0 + q;
      const T* base = side_b ? b : a;
      const bool ok = r < (side_b ? nb : na) && col < D;
      reinterpret_cast<T*>(st + row * kRow)[q] =
          ok ? base[(size_t)r * D + col] : from_f32<T>(0.f);
    }
  }
}

// dot[r * kLd + c] = a_r . b_c (r < TILE, c < TILE; zero rows beyond na,
// nb); nrm[r] = max(||a_r||, eps), nrm[TILE + c] = max(||b_c||, eps). red:
// kGroups TILE^2 floats for the split-K partials, the ring itself or, to
// keep the staged rows, space of its own. Ends with __syncthreads().
template <typename T, int TILE>
__device__ void tile_dot(unsigned char* ring, float* red, float* dot,
                         float* nrm, const T* a, int na, const T* b, int nb,
                         int D, bool vec) {
  using C = Tile<T, TILE>;
  const int tid = threadIdx.x;
  const int g = tid / C::kGroupThreads, u = tid % C::kGroupThreads;
  const int tr = u / C::kSub, tc = u % C::kSub;
  const int nrow = tid / C::kRowThreads, npart = tid % C::kRowThreads;
  float acc[4][4] = {};
  float ss = 0.f;
  const int chunks = (D + KC - 1) / KC;
  // a thread's first A and B element of a stage; its other rows lie at
  // constant offsets
  const int a_off = tr * C::kRow + g * C::kSlice * (int)sizeof(T);
  const int b_off = (TILE + tc) * C::kRow + g * C::kSlice * (int)sizeof(T);
#pragma unroll
  for (int s = 0; s < C::kDepth - 1; ++s) {
    if (s < chunks)
      load_stage<T, TILE>(ring + s * C::kStageBytes, a, na, b, nb, D,
                          s * KC, vec);
    cp_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_wait<C::kDepth - 2>();
    __syncthreads();  // stage k landed; stage k - 1 is free
    const int next = k + C::kDepth - 1;
    if (next < chunks)
      load_stage<T, TILE>(ring + (next % C::kDepth) * C::kStageBytes, a, na,
                          b, nb, D, next * KC, vec);
    cp_commit();
    const unsigned char* st = ring + (k % C::kDepth) * C::kStageBytes;
    const T* ar = reinterpret_cast<const T*>(st + a_off);
    const T* br = reinterpret_cast<const T*>(st + b_off);
    constexpr int kStep = C::kSub * C::kRow / (int)sizeof(T);  // elements
#pragma unroll
    for (int d = 0; d < C::kSlice; d += 2) {
      float2 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = pair(ar + i * kStep + d);
        bv[i] = pair(br + i * kStep + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        }
    }
    // squares: a row's lanes take interleaved column pairs
    const T* row = reinterpret_cast<const T*>(st + nrow * C::kRow);
#pragma unroll
    for (int q = npart; q < KC / 2; q += C::kRowThreads) {
      const float2 v = pair(row + 2 * q);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
    }
  }
  cp_wait<0>();
  __syncthreads();  // every thread is done with the ring
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[g * TILE * TILE + (tr + C::kSub * i) * TILE + tc + C::kSub * j] =
          acc[i][j];
#pragma unroll
  for (int o = C::kRowThreads / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (npart == 0) nrm[nrow] = fmaxf(sqrtf(ss), kEps);
  __syncthreads();
  for (int o = tid; o < TILE * TILE; o += kThreads) {
    float sum = red[o];
    for (int gg = 1; gg < C::kGroups; ++gg) sum += red[gg * TILE * TILE + o];
    dot[(o / TILE) * C::kLd + o % TILE] = sum;
  }
  __syncthreads();
}

// Lines of a TILE x TILE smem tile m (row stride TILE + 1): lines 0..TILE-1
// are its rows, TILE..2 TILE-1 its columns; kLineThreads lanes a line.
template <int TILE>
struct Lines {
  static constexpr int kLineThreads = kThreads / (2 * TILE);
  static constexpr int kPer = TILE / kLineThreads;
  int k, part;
  bool col;
  __device__ Lines() {
    const int line = threadIdx.x / kLineThreads;
    part = threadIdx.x % kLineThreads;
    col = line >= TILE;
    k = col ? line - TILE : line;
  }
  __device__ float at(const float* m, int j) const {
    const int t = part + kLineThreads * j;
    return col ? m[t * (TILE + 1) + k] : m[k * (TILE + 1) + t];
  }
  __device__ float reduce_sum(float x) const {
#pragma unroll
    for (int o = kLineThreads / 2; o > 0; o >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  }
  __device__ float reduce_max(float x) const {
#pragma unroll
    for (int o = kLineThreads / 2; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
  }
};

// z[r * kLd + c] = dot / (n_r n_c) * e inside na x nb, -inf outside (z may
// be dot), then ms[k] = (max, sum of exp) of tile row k and ms[TILE + k]
// of tile column k over the tile (lines past na / nb: (-inf, 0)). Ends
// with __syncthreads().
template <int TILE>
__device__ void tile_softmax_stats(const float* dot, const float* nrm,
                                   float e, int na, int nb, float* z,
                                   float2* ms) {
  constexpr int kLd = TILE + 1;
  for (int o = threadIdx.x; o < TILE * TILE; o += kThreads) {
    const int r = o / TILE, c = o % TILE;
    z[r * kLd + c] = r < na && c < nb
                         ? dot[r * kLd + c] / (nrm[r] * nrm[TILE + c]) * e
                         : -INFINITY;
  }
  __syncthreads();
  const Lines<TILE> ln;
  float v[Lines<TILE>::kPer];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < Lines<TILE>::kPer; ++j) {
    v[j] = ln.at(z, j);
    m = fmaxf(m, v[j]);
  }
  m = ln.reduce_max(m);
  const float shift = m == -INFINITY ? 0.f : m;  // a line past na / nb
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < Lines<TILE>::kPer; ++j) s += expf(v[j] - shift);
  s = ln.reduce_sum(s);
  if (ln.part == 0) ms[(ln.col ? TILE : 0) + ln.k] = make_float2(m, s);
  __syncthreads();
}

// grid (column tiles, row tiles, buckets). part_r[R * tiles + ct] and
// part_c[C * tiles + rt]: (max, sum of exp) of row R over column tile ct
// and of column C over row tile rt; diag[R] = z_RR; then the last block
// writes stats (lse_r | lse_c | nx | ny, B each) and loss[0], the mean of
// the buckets' losses.
template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads, 1)
clip_fwd_kernel(const T* __restrict__ img, const T* __restrict__ prof,
                const float* __restrict__ logit_scale, float* loss,
                float* stats, float2* part_r, float2* part_c, float* diag,
                unsigned* ticket, int buckets, int N, int D, int vec) {
  using C = Tile<T, TILE>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* z = reinterpret_cast<float*>(smem + C::kRingBytes);
  float* nrm = z + TILE * C::kLd;
  __shared__ float red[kWarps];
  __shared__ float2 ms[2 * TILE];
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  const int tiles = gridDim.x;
  const int row0 = rt * TILE, col0 = ct * TILE;
  const int na = min(TILE, N - row0), nb = min(TILE, N - col0);
  const size_t base = (size_t)b * N;
  const int B = buckets * N;
  tile_dot<T, TILE>(smem, reinterpret_cast<float*>(smem), z, nrm,
                    img + (base + row0) * D, na,
                    prof + (base + col0) * D, nb, D, vec);
  const float e = expf(logit_scale[0]);
  tile_softmax_stats<TILE>(z, nrm, e, na, nb, z, ms);
  for (int r = threadIdx.x; r < na; r += kThreads) {
    part_r[(base + row0 + r) * tiles + ct] = ms[r];
    if (rt == ct) diag[base + row0 + r] = z[r * C::kLd + r];
    if (ct == 0) stats[2 * B + base + row0 + r] = nrm[r];
  }
  for (int c = threadIdx.x; c < nb; c += kThreads) {
    part_c[(base + col0 + c) * tiles + rt] = ms[TILE + c];
    if (rt == 0) stats[3 * B + base + col0 + c] = nrm[TILE + c];
  }
  if (!last_block(ticket, gridDim.x * gridDim.y * gridDim.z)) return;

  // the last block: the lse of every line (rows, then columns, of every
  // bucket), merged in tile order; the mean loss is
  // sum over all lines of (lse - z_kk) * 0.5 / N / buckets
  float t = 0.f;
  for (int l = threadIdx.x; l < 2 * B; l += kThreads) {
    const bool col = l >= B;
    const int R = col ? l - B : l;
    const float2* p = (col ? part_c : part_r) + (size_t)R * tiles;
    const float2 p0 = __ldcg(p);
    float m = p0.x, s = p0.y;
    for (int k = 1; k < tiles; ++k) {
      const float2 q = __ldcg(p + k);
      const float m2 = fmaxf(m, q.x);
      s = s * expf(m - m2) + q.y * expf(q.x - m2);
      m = m2;
    }
    const float lse = m + logf(s);
    stats[l] = lse;  // lse_r | lse_c
    t += lse - __ldcg(diag + R);
  }
  const float total = block_sum(t, red);
  if (threadIdx.x == 0) {
    loss[0] = total * 0.5f / N / buckets;
    *ticket = 0u;
  }
}

// The backward's work on one TILE x TILE block, once tile_dot ran: dz from
// the forward's lse; a0[c * lda + r] = ds_rc / ny_c (d_in's k-major
// operand; rows c < nb, zero at r >= na) and a1[r * lda + c] = ds_rc / nx_r
// (d_pn's; rows r < na, zero at c >= nb): no row past the bucket is
// written; the tile's q line sums (row sums of ds s to qr[r * qstride],
// column sums to qc[c * qstride]); returns the tile's sum of dz s (the same
// value in every thread). m holds the dot products and is overwritten by
// ds; ds s goes to m + TILE (TILE + 1) (row stride TILE).
template <int TILE>
__device__ float dz_tile(float* m, const float* nrm, const float* lse_r,
                         const float* lse_c, int na, int nb, bool diagonal,
                         float e, float coef, float* a0, float* a1, int lda,
                         float* qr, float* qc, int qstride, float* red) {
  constexpr int kLd = TILE + 1;
  float* dss = m + TILE * kLd;
  float dzs = 0.f;
  for (int o = threadIdx.x; o < TILE * TILE; o += kThreads) {
    const int r = o / TILE, c = o % TILE;
    float ds = 0.f, d2 = 0.f;
    if (r < na && c < nb) {
      const float s = m[r * kLd + c] / (nrm[r] * nrm[TILE + c]);
      const float z = s * e;
      const float eye = diagonal && r == c ? 1.f : 0.f;
      const float dz = coef * ((expf(z - lse_r[r]) - eye) +
                               (expf(z - lse_c[c]) - eye));
      dzs = fmaf(dz, s, dzs);
      ds = dz * e;
      d2 = ds * s;
    }
    if (r < na) a1[(size_t)r * lda + c] = c < nb ? ds / nrm[r] : 0.f;
    m[r * kLd + c] = ds;
    dss[o] = d2;
  }
  __syncthreads();
  // a0 in its own order, so that consecutive threads write consecutive r
  for (int o = threadIdx.x; o < TILE * TILE; o += kThreads) {
    const int c = o / TILE, r = o % TILE;
    if (c < nb)
      a0[(size_t)c * lda + r] = r < na ? m[r * kLd + c] / nrm[TILE + c] : 0.f;
  }
  // line sums of ds s (rows over the tile's columns, columns over rows)
  {
    const Lines<TILE> ln;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < Lines<TILE>::kPer; ++j) {
      const int t = ln.part + Lines<TILE>::kLineThreads * j;
      s += ln.col ? dss[t * TILE + ln.k] : dss[ln.k * TILE + t];
    }
    s = ln.reduce_sum(s);
    if (ln.part == 0 && ln.k < (ln.col ? nb : na))
      (ln.col ? qc : qr)[(size_t)ln.k * qstride] = s;
  }
  return block_sum(dzs, red);
}

// Shared memory of the dot tile, its norms and dz_tile's ds s beside it.
template <int TILE>
constexpr int tile_floats() {
  return TILE * (TILE + 1) + TILE * TILE + 2 * TILE;
}

// N <= 16: one block a bucket, one 16-row tile. Smem: the ring | m (dot,
// then ds) and ds s | nrm | a0s, a1s (TILE x TILE, stride TILE) | q (2
// TILE) | the split-K partials. stats: the forward's.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
clip_bwd_small_kernel(const T* __restrict__ img, const T* __restrict__ prof,
                      const float* __restrict__ logit_scale,
                      const float* __restrict__ g,
                      const float* __restrict__ stats, T* __restrict__ d_img,
                      T* __restrict__ d_prof, float* d_scale,
                      float* dsc_part, unsigned* ticket, int buckets, int N,
                      int D, int vec) {
  constexpr int TILE = 16;
  using C = Tile<T, TILE>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* m = reinterpret_cast<float*>(smem + C::kRingBytes);
  float* nrm = m + TILE * C::kLd + TILE * TILE;
  float* a0s = nrm + 2 * TILE;
  float* a1s = a0s + TILE * TILE;
  float* q = a1s + TILE * TILE;
  float* red = q + 2 * TILE;  // the split-K partials, beside the ring
  __shared__ float wred[kWarps];
  const int b = blockIdx.x;
  const size_t base = (size_t)b * N;
  const int B = buckets * N;
  const T* x = img + base * D;
  const T* y = prof + base * D;
  // dz_tile writes rows [0, N) of a0s and a1s: the rest stay zeros
  for (int o = threadIdx.x; o < 2 * TILE * TILE; o += kThreads) a0s[o] = 0.f;
  tile_dot<T, TILE>(smem, red, m, nrm, x, N, y, N, D, vec);
  const float e = expf(logit_scale[0]);
  const float coef = g[0] / buckets * 0.5f / N;
  const float dzs =
      dz_tile<TILE>(m, nrm, stats + base, stats + B + base, N, N, true, e,
                    coef, a0s, a1s, TILE, q, q + TILE, 1, wred);
  if (threadIdx.x == 0) dsc_part[b] = dzs;
  // d_in (side 0) and d_pn (side 1) over KC-column stages of x and y: a
  // thread takes kRows rows of its side and two columns
  constexpr int kRows = TILE / 4;
  const int side = threadIdx.x / 128;
  const int tr = (threadIdx.x % 128) / 32, td = threadIdx.x % 32;
  const float* A = side ? a1s : a0s;  // [k][out row], stride TILE
  T* out = (side ? d_prof : d_img) + base * D;
  // where the ring held every chunk (D <= kDepth KC), tile_dot left them
  // in place: stage k is chunk k; else they stream through it again
  const int chunks = (D + KC - 1) / KC;
  const bool resident = chunks <= C::kDepth;
  for (int s = 0; s < C::kDepth - 1 && !resident; ++s) {
    if (s < chunks)
      load_stage<T, TILE>(smem + s * C::kStageBytes, x, N, y, N, D, s * KC,
                          vec);
    cp_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    if (!resident) {
      cp_wait<C::kDepth - 2>();
      __syncthreads();
      const int next = k + C::kDepth - 1;
      if (next < chunks)
        load_stage<T, TILE>(smem + (next % C::kDepth) * C::kStageBytes, x,
                            N, y, N, D, next * KC, vec);
      cp_commit();
    }
    const unsigned char* st = smem + (k % C::kDepth) * C::kStageBytes;
    // the other side's rows are the k operand, the own side's rows the
    // epilogue's
    const unsigned char* other = st + (side ? 0 : TILE) * C::kRow;
    const unsigned char* own = st + (side ? TILE : 0) * C::kRow;
    float acc[kRows][2] = {};
    // rows past N are zeros on both sides: the loop runs to TILE
#pragma unroll 8
    for (int kk = 0; kk < TILE; ++kk) {
      const float2 bv =
          pair(reinterpret_cast<const T*>(other + kk * C::kRow) + 2 * td);
      const float4* a4 =
          reinterpret_cast<const float4*>(A + kk * TILE + tr * kRows);
#pragma unroll
      for (int i4 = 0; i4 < kRows / 4; ++i4) {
        const float4 a = a4[i4];
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[4 * i4 + i][0] = fmaf(av[i], bv.x, acc[4 * i4 + i][0]);
          acc[4 * i4 + i][1] = fmaf(av[i], bv.y, acc[4 * i4 + i][1]);
        }
      }
    }
    const int col = k * KC + 2 * td;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int o = tr * kRows + i;
      if (o >= N) break;
      const float inv = 1.f / nrm[side * TILE + o];
      const float qn = q[side * TILE + o] * inv;
      const float2 v =
          pair(reinterpret_cast<const T*>(own + o * C::kRow) + 2 * td);
      T* dst = out + (size_t)o * D + col;
      if (col < D) dst[0] = from_f32<T>((acc[i][0] - qn * v.x) * inv);
      if (col + 1 < D) dst[1] = from_f32<T>((acc[i][1] - qn * v.y) * inv);
    }
  }
  cp_wait<0>();
  if (!last_block(ticket, gridDim.x)) return;
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int bb = 0; bb < buckets; ++bb) total += __ldcg(dsc_part + bb);
    d_scale[0] = total * e;
    *ticket = 0u;
  }
}

// N > 16: grid (column tiles, row tiles, buckets) of TILE = 32. a0, a1:
// per bucket N x NP f32 (NP = N rounded up to TR); qr, qc: B x tiles line
// partials; dsc_part[block]: the block's sum of dz s.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
clip_dz_kernel(const T* __restrict__ img, const T* __restrict__ prof,
               const float* __restrict__ logit_scale,
               const float* __restrict__ g, const float* __restrict__ stats,
               float* a0, float* a1, float* qr, float* qc, float* dsc_part,
               int buckets, int N, int NP, int D, int vec) {
  constexpr int TILE = 32;
  using C = Tile<T, TILE>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* m = reinterpret_cast<float*>(smem + C::kRingBytes);
  float* nrm = m + TILE * C::kLd + TILE * TILE;
  __shared__ float red[kWarps];
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  const int tiles = gridDim.x;
  const int row0 = rt * TILE, col0 = ct * TILE;
  const int na = min(TILE, N - row0), nb = min(TILE, N - col0);
  const size_t base = (size_t)b * N;
  const int B = buckets * N;
  tile_dot<T, TILE>(smem, reinterpret_cast<float*>(smem), m, nrm,
                    img + (base + row0) * D, na,
                    prof + (base + col0) * D, nb, D, vec);
  const float e = expf(logit_scale[0]);
  const float coef = g[0] / buckets * 0.5f / N;
  const size_t plane = (size_t)b * N * NP;
  const float dzs = dz_tile<TILE>(
      m, nrm, stats + base + row0, stats + B + base + col0, na, nb, rt == ct,
      e, coef, a0 + plane + (size_t)col0 * NP + row0,
      a1 + plane + (size_t)row0 * NP + col0, NP,
      qr + (base + row0) * tiles + ct, qc + (base + col0) * tiles + rt,
      tiles, red);
  if (threadIdx.x == 0)
    dsc_part[((size_t)b * tiles + rt) * tiles + ct] = dzs;
}

// grid (D tiles, row tiles, 2 x buckets: side = z & 1, bucket = z >> 1):
// out rows [out0, out0 + TR) x columns [d0, d0 + TD) of d_img (side 0:
// sum_k a0[k][r] y_k) or d_prof (side 1: sum_k a1[k][c] x_k), projected in
// the epilogue. Block (0, 0, 0) also writes d_scale.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
clip_dx_kernel(const T* __restrict__ img, const T* __restrict__ prof,
               const float* __restrict__ logit_scale,
               const float* __restrict__ stats, const float* a0,
               const float* a1, const float* qr, const float* qc,
               const float* dsc_part, int n_parts, T* __restrict__ d_img,
               T* __restrict__ d_prof, float* d_scale, int buckets, int N,
               int NP, int D, int tiles, int vec) {
  constexpr int kBRow = TD * (int)sizeof(T);  // bytes of a staged row
  constexpr int kStage = KB * TR * 4 + KB * kBRow;
  extern __shared__ __align__(16) unsigned char smem[];
  const int side = blockIdx.z & 1, b = blockIdx.z >> 1;
  const int out0 = blockIdx.y * TR, d0 = blockIdx.x * TD;
  const size_t base = (size_t)b * N;
  const int B = buckets * N;
  const float* A = (side ? a1 : a0) + (size_t)b * N * NP + out0;
  const T* other = (side ? img : prof) + base * D;
  const T* own = (side ? prof : img) + base * D;
  const int tr = threadIdx.x / 32, td = threadIdx.x % 32;
  auto load = [&](int s, int k0) {
    unsigned char* st = smem + s * kStage;
    {  // A: KB rows of TR floats, one piece a thread
      const int k = threadIdx.x / (TR / 4), q = threadIdx.x % (TR / 4);
      const bool ok = k0 + k < N;
      cp_async16(st + k * TR * 4 + q * 16,
                 ok ? A + (size_t)(k0 + k) * NP + q * 4 : A, ok);
    }
    unsigned char* bs = st + KB * TR * 4;
    if (vec) {
      constexpr int kPer = 16 / (int)sizeof(T);
      constexpr int kPieces = TD / kPer;
      for (int p = threadIdx.x; p < KB * kPieces; p += kThreads) {
        const int k = p / kPieces, q = p % kPieces;
        const int col = d0 + q * kPer;
        const bool ok = k0 + k < N && col < D;
        cp_async16(bs + k * kBRow + q * 16,
                   ok ? other + (size_t)(k0 + k) * D + col : other, ok);
      }
    } else {
      for (int e = threadIdx.x; e < KB * TD; e += kThreads) {
        const int k = e / TD, q = e % TD;
        const int col = d0 + q;
        const bool ok = k0 + k < N && col < D;
        reinterpret_cast<T*>(bs + k * kBRow)[q] =
            ok ? other[(size_t)(k0 + k) * D + col] : from_f32<T>(0.f);
      }
    }
  };
  float acc[4][2] = {};
  const int chunks = (N + KB - 1) / KB;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s * KB);
    cp_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = k + kStages - 1;
    if (next < chunks) load(next % kStages, next * KB);
    cp_commit();
    const unsigned char* st = smem + (k % kStages) * kStage;
    const float* As = reinterpret_cast<const float*>(st);
    const unsigned char* bs = st + KB * TR * 4;
    // k rows past N are zeros in both operands
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const float4 a =
          reinterpret_cast<const float4*>(As + kk * TR)[tr];
      const float2 bv = pair(reinterpret_cast<const T*>(bs + kk * kBRow) +
                             2 * td);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
      }
    }
  }
  cp_wait<0>();
  const float* qp = side ? qc : qr;
  const float* nrm = stats + (2 + side) * B + base;
  T* out = (side ? d_prof : d_img) + base * D;
  const int col = d0 + 2 * td;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = out0 + 4 * tr + i;
    if (o >= N) break;
    float qs = 0.f;
    for (int t = 0; t < tiles; ++t) qs += qp[(base + o) * tiles + t];
    const float inv = 1.f / nrm[o];
    const float qn = qs * inv;
    const T* v = own + (size_t)o * D + col;
    T* dst = out + (size_t)o * D + col;
    if (col < D) dst[0] = from_f32<T>((acc[i][0] - qn * to_f32(v[0])) * inv);
    if (col + 1 < D)
      dst[1] = from_f32<T>((acc[i][1] - qn * to_f32(v[1])) * inv);
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0) {
    float total = 0.f;
    for (int p = 0; p < n_parts; ++p) total += dsc_part[p];
    d_scale[0] = total * expf(logit_scale[0]);
  }
}

template <typename T>
bool aligned(const void* img, const void* prof, int D) {
  return (D * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(prof) % 16 == 0;
}

template <typename T, int TILE>
int fwd_tile(const T* img, const T* prof, const float* scale, float* loss,
             float* stats, float* scratch, unsigned* ticket, int buckets,
             int N, int D, cudaStream_t stream) {
  const int tiles = (N + TILE - 1) / TILE;
  const size_t B = (size_t)buckets * N;
  float2* part_r = reinterpret_cast<float2*>(scratch);
  float2* part_c = part_r + B * tiles;
  float* diag = reinterpret_cast<float*>(part_c + B * tiles);
  const int smem = Tile<T, TILE>::kRingBytes + 4 * tile_floats<TILE>();
  cudaError_t err = cudaFuncSetAttribute(
      clip_fwd_kernel<T, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  clip_fwd_kernel<T, TILE><<<dim3(tiles, tiles, buckets), kThreads, smem,
                             stream>>>(img, prof, scale, loss, stats, part_r,
                                       part_c, diag, ticket, buckets, N, D,
                                       aligned<T>(img, prof, D));
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_small(const T* img, const T* prof, const float* scale,
              const float* g, const float* stats, T* d_img, T* d_prof,
              float* d_scale, float* scratch, unsigned* ticket, int buckets,
              int N, int D, cudaStream_t stream) {
  constexpr int TILE = 16;
  const int smem =
      Tile<T, TILE>::kRingBytes +
      4 * (tile_floats<TILE>() + 2 * TILE * TILE + 2 * TILE +
           Tile<T, TILE>::kGroups * TILE * TILE);
  cudaError_t err = cudaFuncSetAttribute(
      clip_bwd_small_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  clip_bwd_small_kernel<T><<<buckets, kThreads, smem, stream>>>(
      img, prof, scale, g, stats, d_img, d_prof, d_scale, scratch, ticket,
      buckets, N, D, aligned<T>(img, prof, D));
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_tiled(const T* img, const T* prof, const float* scale,
              const float* g, const float* stats, T* d_img, T* d_prof,
              float* d_scale, float* scratch, int buckets, int N, int D,
              cudaStream_t stream) {
  constexpr int TILE = 32;
  const int tiles = (N + TILE - 1) / TILE;
  const int NP = (N + TR - 1) / TR * TR;
  const size_t B = (size_t)buckets * N;
  float* a0 = scratch;
  float* a1 = a0 + (size_t)buckets * N * NP;
  float* qr = a1 + (size_t)buckets * N * NP;
  float* qc = qr + B * tiles;
  float* dsc = qc + B * tiles;
  const int vec = aligned<T>(img, prof, D);
  const int smem_dz = Tile<T, TILE>::kRingBytes + 4 * tile_floats<TILE>();
  cudaError_t err = cudaFuncSetAttribute(
      clip_dz_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dz);
  if (err != cudaSuccess) return (int)err;
  clip_dz_kernel<T><<<dim3(tiles, tiles, buckets), kThreads, smem_dz,
                      stream>>>(img, prof, scale, g, stats, a0, a1, qr, qc,
                                dsc, buckets, N, NP, D, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem_dx = kStages * (KB * TR * 4 + KB * TD * (int)sizeof(T));
  err = cudaFuncSetAttribute(clip_dx_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dx);
  if (err != cudaSuccess) return (int)err;
  clip_dx_kernel<T><<<dim3((D + TD - 1) / TD, NP / TR, 2 * buckets),
                      kThreads, smem_dx, stream>>>(
      img, prof, scale, stats, a0, a1, qr, qc, dsc, buckets * tiles * tiles,
      d_img, d_prof, d_scale, buckets, N, NP, D, tiles, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* img, const void* prof, const void* scale, void* loss,
        void* stats, void* scratch, void* ticket, int buckets, int N, int D,
        int tile, cudaStream_t s) {
  const T* i = static_cast<const T*>(img);
  const T* p = static_cast<const T*>(prof);
  const float* sc = static_cast<const float*>(scale);
  float* l = static_cast<float*>(loss);
  float* st = static_cast<float*>(stats);
  float* sp = static_cast<float*>(scratch);
  unsigned* tk = static_cast<unsigned*>(ticket);
  return tile == 16
             ? fwd_tile<T, 16>(i, p, sc, l, st, sp, tk, buckets, N, D, s)
             : fwd_tile<T, 32>(i, p, sc, l, st, sp, tk, buckets, N, D, s);
}

template <typename T>
int bwd(const void* img, const void* prof, const void* scale, const void* g,
        const void* stats, void* d_img, void* d_prof, void* d_scale,
        void* scratch, void* ticket, int buckets, int N, int D, int tile,
        cudaStream_t s) {
  const T* i = static_cast<const T*>(img);
  const T* p = static_cast<const T*>(prof);
  const float* sc = static_cast<const float*>(scale);
  const float* gg = static_cast<const float*>(g);
  const float* st = static_cast<const float*>(stats);
  T* di = static_cast<T*>(d_img);
  T* dp = static_cast<T*>(d_prof);
  float* ds = static_cast<float*>(d_scale);
  float* sp = static_cast<float*>(scratch);
  unsigned* tk = static_cast<unsigned*>(ticket);
  if (tile == 32)
    return bwd_tiled<T>(i, p, sc, gg, st, di, dp, ds, sp, buckets, N, D, s);
  return bwd_small<T>(i, p, sc, gg, st, di, dp, ds, sp, tk, buckets, N, D,
                      s);
}

// what both entry points refuse (clip_bwd also refuses tile 16 past one
// tile a bucket)
bool bad_args(int buckets, int N, int D, int tile) {
  return buckets < 1 || N < 1 || D < 1 || (tile != 16 && tile != 32);
}

}  // namespace

extern "C" {

// img, prof: (buckets, N, D) bf16 (bf16 = 1) or f32 (bf16 = 0), contiguous;
// logit_scale: one f32 on the device; loss: one f32 (the mean over
// buckets); stats: 4 B f32 (lse_r | lse_c | nx | ny, B = buckets N);
// scratch: 4 B tiles + B f32 (tiles = ceil(N / tile)); ticket: one
// unsigned, 0 before the launch and after it. tile: 16 or 32 (the
// wrapper takes 16 up to N = 128).
// Returns a cudaError_t code.
int clip_fwd(const void* img, const void* prof, const void* logit_scale,
             void* loss, void* stats, void* scratch, void* ticket,
             int buckets, int N, int D, int tile, int bf16, void* stream) {
  if (bad_args(buckets, N, D, tile)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(img, prof, logit_scale, loss, stats,
                                   scratch, ticket, buckets, N, D, tile, s)
              : fwd<float>(img, prof, logit_scale, loss, stats, scratch,
                           ticket, buckets, N, D, tile, s);
}

// g: the cotangent of the mean loss, one f32 on the device; stats: the
// forward's; d_img, d_prof: like img, prof; d_scale: one f32. tile 16 (N
// <= 16): one launch, scratch: buckets f32, ticket as in clip_fwd. tile
// 32: two launches, scratch: 2
// buckets N NP + 2 B tiles + buckets tiles^2 f32 (NP = N rounded up to
// 32), no ticket.
int clip_bwd(const void* img, const void* prof, const void* logit_scale,
             const void* g, const void* stats, void* d_img, void* d_prof,
             void* d_scale, void* scratch, void* ticket, int buckets, int N,
             int D, int tile, int bf16, void* stream) {
  if (bad_args(buckets, N, D, tile) || (tile == 16 && N > 16) || !stats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(img, prof, logit_scale, g, stats, d_img,
                                   d_prof, d_scale, scratch, ticket, buckets,
                                   N, D, tile, s)
              : bwd<float>(img, prof, logit_scale, g, stats, d_img, d_prof,
                           d_scale, scratch, ticket, buckets, N, D, tile, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
