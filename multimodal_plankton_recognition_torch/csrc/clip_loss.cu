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
//   * every kernel stages x and y through the cp.async ring of
//     csrc/contrastive.cuh (tile_dot: TILE x TILE blocks of s in 4 x 4
//     register tiles, the norms from the same chunks), which kernels 7-8
//     (csrc/siglip_loss.cu) share, as they share the ticket, the
//     backward's tile step (dz_tile, here with CLIP's ClipStep) and both
//     gradient GEMMs (block_grads, grad_gemm);
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

#include "contrastive.cuh"

namespace {

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

// CLIP's dz from the forward's lse of the tile's rows and columns:
// dz = coef ((softmax_r(z) - I) + (softmax_c(z) - I)), z = s e
struct ClipStep {
  static constexpr bool kBias = false;
  const float* lse_r;
  const float* lse_c;
  float e, coef;
  bool diagonal;
  __device__ float dz(float s, int r, int c) const {
    const float z = s * e;
    const float eye = diagonal && r == c ? 1.f : 0.f;
    return coef * ((expf(z - lse_r[r]) - eye) + (expf(z - lse_c[c]) - eye));
  }
};

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
      dz_tile<TILE>(m, nrm, ClipStep{stats + base, stats + B + base, e, coef,
                                     true},
                    N, N, a0s, a1s, TILE, q, q + TILE, 1, wred).x;
  if (threadIdx.x == 0) dsc_part[b] = dzs;
  block_grads<T>(smem, a0s, a1s, q, nrm, x, y, d_img + base * D,
                 d_prof + base * D, N, D, vec);
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
      m, nrm, ClipStep{stats + base + row0, stats + B + base + col0, e, coef,
                       rt == ct},
      na, nb, a0 + plane + (size_t)col0 * NP + row0,
      a1 + plane + (size_t)row0 * NP + col0, NP,
      qr + (base + row0) * tiles + ct, qc + (base + col0) * tiles + rt,
      tiles, red).x;
  if (threadIdx.x == 0)
    dsc_part[((size_t)b * tiles + rt) * tiles + ct] = dzs;
}

// grid (D tiles, row tiles, 2 x buckets): grad_gemm, the norms from the
// forward's statistics; block (0, 0, 0) also writes d_scale.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
clip_dx_kernel(const T* __restrict__ img, const T* __restrict__ prof,
               const float* __restrict__ logit_scale,
               const float* __restrict__ stats, const float* a0,
               const float* a1, const float* qr, const float* qc,
               const float* dsc_part, int n_parts, T* __restrict__ d_img,
               T* __restrict__ d_prof, float* d_scale, int buckets, int N,
               int NP, int D, int tiles, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  grad_gemm<T, false>(smem, img, prof, logit_scale,
                      stats + 2 * (size_t)buckets * N, a0, a1, qr, qc,
                      dsc_part, n_parts, d_img, d_prof, d_scale, nullptr,
                      buckets, N, NP, D, tiles, vec);
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
  const int smem = block_bwd_smem<T>();
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
  const int smem_dx = grad_gemm_smem<T>();
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
