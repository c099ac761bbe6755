// Bucketed pairwise sigmoid (SigLIP) loss, forward and backward, for Hopper
// (sm_90a). Plain C entry points, loaded with ctypes by ops/contrastive.py.
//
// Replaces the TPU kernels
//   multimodal_plankton_recognition_tpu/ops/pallas/contrastive.py
//   ::_siglip_fwd_kernel (through _siglip_fwd) and ::_siglip_bwd_kernel
//   (through _siglip_bwd).
//
// Per bucket of N image rows x and N profile rows y of width D (bf16 or f32
// in, f32 inside), as the TPU kernels compute it:
//   nx = max(||x||, 1e-12), ny likewise;  s = (x / nx) . (y / ny)^T
//   z = s * exp(logit_scale) + logit_bias;  y = +1 on the diagonal, -1 off
//   loss = sum softplus(-y z) / N,  softplus(u) = max(u, 0) + log1p(e^-|u|)
// and backward, with g the cotangent of the mean over buckets:
//   dz = g / (buckets N) * (-y * sigmoid(-y z))
//   d logit_scale = sum(dz * s) * exp(logit_scale),  d logit_bias = sum(dz)
//   ds = dz * exp(logit_scale);  d_in = ds . (y / ny), d_pn = ds^T . (x / nx)
//   di = (d_in - (d_in . x/nx) x/nx) / nx, dp likewise.
//
// Rounding order, as kernels 5-6 (csrc/clip_loss.cu): s = (x . y) / (nx
// ny), the products on the raw rows and the norms from the same staged
// chunks; the projection from q_r = sum_c ds_rc s_rc = d_in . x/nx. All
// products are f32 FMAs on the CUDA cores. On bf16 rows the forward's
// products are exact in f32, so bf16 tensor cores could take them at the
// same accuracy; the backward's ds operand is f32. Every sum is taken in a
// fixed order, so two calls agree bit for bit; no atomics but one
// completion ticket, reset by the block that takes it last.
//
// What bounds it. 2 N^2 D products a bucket in the forward (on bf16 rows at
// the tensor cores' rate: less time than reading the rows), the same again
// and then 4 N^2 D with an f32 operand in the backward, on 64 KB (the
// SigLIP card's 4 x 16) to 1 MB (one bucket of 512) of embeddings: the
// kernels wait on latency. SigLIP has no row or column normaliser, so its
// tiles are independent: the design is kernels 5-6's (the ring, the
// register tiles, the ticket and the gradient GEMMs of csrc/
// contrastive.cuh), with SigLIP's per-element step and merge:
//   * forward, one launch: a grid of (column tile, row tile, bucket) of
//     TILE x TILE tiles of s; each block sums softplus(-y z) over its tile
//     in a fixed order and writes that partial; the last block to take the
//     ticket adds the partials and writes the mean over buckets of sum / N
//     as one f32. No N x N logits, no unit rows, no PyTorch op after it.
//     The wrapper picks TILE (siglip_fwd_tile);
//   * backward, N <= 16 (one 16-row tile a bucket): one block a bucket
//     does it all in shared memory (s, dz, ds/ny and ds/nx, the line sums
//     q, then the gradients from register tiles over the staged rows with
//     the projection in the epilogue); the last block adds the buckets'
//     partials of d logit_scale and d logit_bias. One launch;
//   * backward, N > 16: siglip_dz_kernel over (column tile, row tile,
//     bucket) of 32-row tiles recomputes s and writes ds/ny and ds/nx to
//     an N x NP f32 scratch, the line partials of q, each tile's two
//     partials and its rows' and columns' norms; then siglip_dx_kernel
//     runs d_in and d_pn as one tiled GEMM over k = N with the projection
//     in its epilogue and adds the partials in tile order. Two launches.
// The backward needs nothing from the forward: dz depends on z alone and
// the norms come from its own staged chunks. Any N >= 1 and any D >= 1.
//
// logit_scale, logit_bias and the cotangent are read from device memory, so
// no launch needs the host to read a device value. The kernels launch on
// the caller's stream, do not synchronise and allocate nothing; the entry
// points return cudaGetLastError().

#include "contrastive.cuh"

namespace {

// log(1 + e^u) without overflow for any finite u
__device__ __forceinline__ float softplus(float u) {
  return fmaxf(u, 0.f) + log1pf(expf(-fabsf(u)));
}

// 1 / (1 + e^-u): e^-u overflows to inf for u << 0 and gives 0, never NaN
__device__ __forceinline__ float sigmoid(float u) {
  return 1.f / (1.f + expf(-u));
}

// SigLIP's dz from z = s e + bias alone, y = +1 on the bucket's diagonal
struct SiglipStep {
  static constexpr bool kBias = true;
  float e, bias, coef;
  bool diagonal;
  __device__ float dz(float s, int r, int c) const {
    const float z = s * e + bias;
    const float y = diagonal && r == c ? 1.f : -1.f;
    return coef * (-y * sigmoid(-y * z));
  }
};

// grid (column tiles, row tiles, buckets): part[block] = the tile's sum of
// softplus(-y z); then the last block writes loss[0], the mean over
// buckets of each bucket's sum / N.
template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads, 1)
siglip_fwd_kernel(const T* __restrict__ img, const T* __restrict__ prof,
                  const float* __restrict__ logit_scale,
                  const float* __restrict__ logit_bias, float* loss,
                  float* part, unsigned* ticket, int buckets, int N, int D,
                  int vec) {
  using C = Tile<T, TILE>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dot = reinterpret_cast<float*>(smem + C::kRingBytes);
  float* nrm = dot + TILE * C::kLd;
  __shared__ float red[kWarps];
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  const int row0 = rt * TILE, col0 = ct * TILE;
  const int na = min(TILE, N - row0), nb = min(TILE, N - col0);
  const size_t base = (size_t)b * N;
  tile_dot<T, TILE>(smem, reinterpret_cast<float*>(smem), dot, nrm,
                    img + (base + row0) * D, na,
                    prof + (base + col0) * D, nb, D, vec);
  const float e = expf(logit_scale[0]);
  const float bias = logit_bias[0];
  float t = 0.f;
  for (int o = threadIdx.x; o < TILE * TILE; o += kThreads) {
    const int r = o / TILE, c = o % TILE;
    if (r < na && c < nb) {
      const float z = dot[r * C::kLd + c] / (nrm[r] * nrm[TILE + c]) * e +
                      bias;
      t += softplus(rt == ct && r == c ? -z : z);  // softplus(-y z)
    }
  }
  const float total = block_sum(t, red);
  const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
  const size_t blk = ((size_t)b * gridDim.y + rt) * gridDim.x + ct;
  if (threadIdx.x == 0) part[blk] = total;
  if (!last_block(ticket, blocks)) return;

  // the last block: every tile's partial, threads in a fixed order
  float s = 0.f;
  for (unsigned p = threadIdx.x; p < blocks; p += kThreads)
    s += __ldcg(part + p);
  const float all = block_sum(s, red);
  if (threadIdx.x == 0) {
    loss[0] = all / N / buckets;
    *ticket = 0u;
  }
}

// N <= 16: one block a bucket, one 16-row tile (smem: block_bwd_smem).
// part: the buckets' partials of sum dz s, then of sum dz.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
siglip_bwd_small_kernel(const T* __restrict__ img,
                        const T* __restrict__ prof,
                        const float* __restrict__ logit_scale,
                        const float* __restrict__ logit_bias,
                        const float* __restrict__ g, T* __restrict__ d_img,
                        T* __restrict__ d_prof, float* d_scale,
                        float* d_bias, float* part, unsigned* ticket,
                        int buckets, int N, int D, int vec) {
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
  const T* x = img + base * D;
  const T* y = prof + base * D;
  // dz_tile writes rows [0, N) of a0s and a1s: the rest stay zeros
  for (int o = threadIdx.x; o < 2 * TILE * TILE; o += kThreads) a0s[o] = 0.f;
  tile_dot<T, TILE>(smem, red, m, nrm, x, N, y, N, D, vec);
  const float e = expf(logit_scale[0]);
  const float coef = g[0] / buckets / N;
  const float2 sums =
      dz_tile<TILE>(m, nrm, SiglipStep{e, logit_bias[0], coef, true}, N, N,
                    a0s, a1s, TILE, q, q + TILE, 1, wred);
  if (threadIdx.x == 0) {
    part[b] = sums.x;
    part[buckets + b] = sums.y;
  }
  block_grads<T>(smem, a0s, a1s, q, nrm, x, y, d_img + base * D,
                 d_prof + base * D, N, D, vec);
  if (!last_block(ticket, gridDim.x)) return;
  if (threadIdx.x == 0) {
    float ts = 0.f, tb = 0.f;
    for (int bb = 0; bb < buckets; ++bb) {
      ts += __ldcg(part + bb);
      tb += __ldcg(part + buckets + bb);
    }
    d_scale[0] = ts * e;
    d_bias[0] = tb;
    *ticket = 0u;
  }
}

// N > 16: grid (column tiles, row tiles, buckets) of TILE = 32. a0, a1:
// per bucket N x NP f32 (NP = N rounded up to TR); qr, qc: B x tiles line
// partials; norms: nx | ny (B each), written by the blocks of column tile
// 0 (rows) and row tile 0 (columns); part: every block's sum of dz s, then
// every block's sum of dz.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
siglip_dz_kernel(const T* __restrict__ img, const T* __restrict__ prof,
                 const float* __restrict__ logit_scale,
                 const float* __restrict__ logit_bias,
                 const float* __restrict__ g, float* a0, float* a1,
                 float* qr, float* qc, float* norms, float* part,
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
  for (int r = threadIdx.x; r < na && ct == 0; r += kThreads)
    norms[base + row0 + r] = nrm[r];
  for (int c = threadIdx.x; c < nb && rt == 0; c += kThreads)
    norms[B + base + col0 + c] = nrm[TILE + c];
  const float e = expf(logit_scale[0]);
  const float coef = g[0] / buckets / N;
  const size_t plane = (size_t)b * N * NP;
  const float2 sums = dz_tile<TILE>(
      m, nrm, SiglipStep{e, logit_bias[0], coef, rt == ct}, na, nb,
      a0 + plane + (size_t)col0 * NP + row0,
      a1 + plane + (size_t)row0 * NP + col0, NP,
      qr + (base + row0) * tiles + ct, qc + (base + col0) * tiles + rt,
      tiles, red);
  if (threadIdx.x == 0) {
    const size_t blk = ((size_t)b * tiles + rt) * tiles + ct;
    part[blk] = sums.x;
    part[(size_t)buckets * tiles * tiles + blk] = sums.y;
  }
}

// grid (D tiles, row tiles, 2 x buckets): grad_gemm on siglip_dz_kernel's
// operands and norms; block (0, 0, 0) also writes d_scale and d_bias.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
siglip_dx_kernel(const T* __restrict__ img, const T* __restrict__ prof,
                 const float* __restrict__ logit_scale,
                 const float* __restrict__ norms, const float* a0,
                 const float* a1, const float* qr, const float* qc,
                 const float* part, int n_parts, T* __restrict__ d_img,
                 T* __restrict__ d_prof, float* d_scale, float* d_bias,
                 int buckets, int N, int NP, int D, int tiles, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  grad_gemm<T, true>(smem, img, prof, logit_scale, norms, a0, a1, qr, qc,
                     part, n_parts, d_img, d_prof, d_scale, d_bias, buckets,
                     N, NP, D, tiles, vec);
}

template <typename T, int TILE>
int fwd_tile(const T* img, const T* prof, const float* scale,
             const float* bias, float* loss, float* scratch,
             unsigned* ticket, int buckets, int N, int D,
             cudaStream_t stream) {
  const int tiles = (N + TILE - 1) / TILE;
  const int smem = Tile<T, TILE>::kRingBytes + 4 * tile_floats<TILE>();
  cudaError_t err = cudaFuncSetAttribute(
      siglip_fwd_kernel<T, TILE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  siglip_fwd_kernel<T, TILE><<<dim3(tiles, tiles, buckets), kThreads, smem,
                               stream>>>(img, prof, scale, bias, loss,
                                         scratch, ticket, buckets, N, D,
                                         aligned<T>(img, prof, D));
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_small(const T* img, const T* prof, const float* scale,
              const float* bias, const float* g, T* d_img, T* d_prof,
              float* d_scale, float* d_bias, float* scratch,
              unsigned* ticket, int buckets, int N, int D,
              cudaStream_t stream) {
  const int smem = block_bwd_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      siglip_bwd_small_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  siglip_bwd_small_kernel<T><<<buckets, kThreads, smem, stream>>>(
      img, prof, scale, bias, g, d_img, d_prof, d_scale, d_bias, scratch,
      ticket, buckets, N, D, aligned<T>(img, prof, D));
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_tiled(const T* img, const T* prof, const float* scale,
              const float* bias, const float* g, T* d_img, T* d_prof,
              float* d_scale, float* d_bias, float* scratch, int buckets,
              int N, int D, cudaStream_t stream) {
  constexpr int TILE = 32;
  const int tiles = (N + TILE - 1) / TILE;
  const int NP = (N + TR - 1) / TR * TR;
  const size_t B = (size_t)buckets * N;
  float* a0 = scratch;
  float* a1 = a0 + B * NP;
  float* qr = a1 + B * NP;
  float* qc = qr + B * tiles;
  float* norms = qc + B * tiles;
  float* part = norms + 2 * B;
  const int vec = aligned<T>(img, prof, D);
  const int smem_dz = Tile<T, TILE>::kRingBytes + 4 * tile_floats<TILE>();
  cudaError_t err = cudaFuncSetAttribute(
      siglip_dz_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dz);
  if (err != cudaSuccess) return (int)err;
  siglip_dz_kernel<T><<<dim3(tiles, tiles, buckets), kThreads, smem_dz,
                        stream>>>(img, prof, scale, bias, g, a0, a1, qr, qc,
                                  norms, part, buckets, N, NP, D, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem_dx = grad_gemm_smem<T>();
  err = cudaFuncSetAttribute(siglip_dx_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dx);
  if (err != cudaSuccess) return (int)err;
  siglip_dx_kernel<T><<<dim3((D + TD - 1) / TD, NP / TR, 2 * buckets),
                        kThreads, smem_dx, stream>>>(
      img, prof, scale, norms, a0, a1, qr, qc, part, buckets * tiles * tiles,
      d_img, d_prof, d_scale, d_bias, buckets, N, NP, D, tiles, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* img, const void* prof, const void* scale,
        const void* bias, void* loss, void* scratch, void* ticket,
        int buckets, int N, int D, int tile, cudaStream_t s) {
  const T* i = static_cast<const T*>(img);
  const T* p = static_cast<const T*>(prof);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* l = static_cast<float*>(loss);
  float* sp = static_cast<float*>(scratch);
  unsigned* tk = static_cast<unsigned*>(ticket);
  return tile == 16
             ? fwd_tile<T, 16>(i, p, sc, bi, l, sp, tk, buckets, N, D, s)
             : fwd_tile<T, 32>(i, p, sc, bi, l, sp, tk, buckets, N, D, s);
}

template <typename T>
int bwd(const void* img, const void* prof, const void* scale,
        const void* bias, const void* g, void* d_img, void* d_prof,
        void* d_scale, void* d_bias, void* scratch, void* ticket,
        int buckets, int N, int D, int tile, cudaStream_t s) {
  const T* i = static_cast<const T*>(img);
  const T* p = static_cast<const T*>(prof);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* gg = static_cast<const float*>(g);
  T* di = static_cast<T*>(d_img);
  T* dp = static_cast<T*>(d_prof);
  float* ds = static_cast<float*>(d_scale);
  float* db = static_cast<float*>(d_bias);
  float* sp = static_cast<float*>(scratch);
  unsigned* tk = static_cast<unsigned*>(ticket);
  if (tile == 32)
    return bwd_tiled<T>(i, p, sc, bi, gg, di, dp, ds, db, sp, buckets, N, D,
                        s);
  return bwd_small<T>(i, p, sc, bi, gg, di, dp, ds, db, sp, tk, buckets, N,
                      D, s);
}

}  // namespace

extern "C" {

// img, prof: (buckets, N, D) bf16 (bf16 = 1) or f32 (bf16 = 0), contiguous;
// logit_scale, logit_bias: one f32 each on the device; loss: one f32 (the
// mean over buckets); scratch: buckets tiles^2 f32 (tiles = ceil(N /
// tile)); ticket: one unsigned, 0 before the launch and after it. tile: 16
// or 32, at any N. Returns a cudaError_t code.
int siglip_fwd(const void* img, const void* prof, const void* logit_scale,
               const void* logit_bias, void* loss, void* scratch,
               void* ticket, int buckets, int N, int D, int tile, int bf16,
               void* stream) {
  if (bad_args(buckets, N, D, tile)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(img, prof, logit_scale, logit_bias, loss,
                                   scratch, ticket, buckets, N, D, tile, s)
              : fwd<float>(img, prof, logit_scale, logit_bias, loss, scratch,
                           ticket, buckets, N, D, tile, s);
}

// g: the cotangent of the mean loss, one f32 on the device; d_img, d_prof:
// like img, prof; d_scale, d_bias: one f32 each. tile 16 (N <= 16): one
// launch, scratch: 2 buckets f32, ticket as in siglip_fwd. tile 32: two
// launches, scratch: 2 B NP + 2 B tiles + 2 B + 2 buckets tiles^2 f32 (B =
// buckets N, NP = N rounded up to 32), no ticket.
int siglip_bwd(const void* img, const void* prof, const void* logit_scale,
               const void* logit_bias, const void* g, void* d_img,
               void* d_prof, void* d_scale, void* d_bias, void* scratch,
               void* ticket, int buckets, int N, int D, int tile, int bf16,
               void* stream) {
  if (bad_args(buckets, N, D, tile) || (tile == 16 && N > 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(img, prof, logit_scale, logit_bias, g,
                                   d_img, d_prof, d_scale, d_bias, scratch,
                                   ticket, buckets, N, D, tile, s)
              : bwd<float>(img, prof, logit_scale, logit_bias, g, d_img,
                           d_prof, d_scale, d_bias, scratch, ticket, buckets,
                           N, D, tile, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
