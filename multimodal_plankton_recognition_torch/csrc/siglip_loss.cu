// Bucketed pairwise sigmoid (SigLIP) loss, forward and backward, for Hopper
// (sm_90a). Plain C entry points, loaded with ctypes by ops/contrastive.py.
//
// Replaces the TPU kernels
//   multimodal_plankton_recognition_tpu/ops/pallas/contrastive.py
//   ::_siglip_fwd_kernel (through _siglip_fwd) and ::_siglip_bwd_kernel
//   (through _siglip_bwd).
//
// Per bucket of N image and N profile embeddings of width D (bf16 or f32
// in, f32 inside), as the TPU kernels compute it:
//   i = x / max(||x||, 1e-12), p likewise          (row L2 normalisation)
//   s = i . p^T,  z = s * exp(logit_scale) + logit_bias
//   y = +1 on the diagonal, -1 off it
//   loss = sum softplus(-y z) / N,  softplus(u) = max(u, 0) + log1p(e^-|u|)
// and backward, with g the cotangent of the bucket's loss:
//   dz = g / N * (-y * sigmoid(-y z))
//   d logit_scale = sum(dz * s) * exp(logit_scale),  d logit_bias = sum(dz)
//   d_in = (dz e^scale) . p,  d_pn = (dz e^scale)^T . i
//   di = (d_in - (d_in . i) i) / max(||x||, 1e-12), dp likewise
//
// What bounds it: at the SigLIP cards' shape (4 buckets of N = 16, D = 512)
// the loss is 128 KB of embeddings and a few MFLOP, so a launch is bound by
// latency; at one bucket of 256 a single block per bucket (the CLIP
// kernels' design) runs 33 MFLOP on one SM. SigLIP has no row or column
// normaliser, so the work splits into tiles of kRows rows:
//   * a normalisation pass writes every unit row (f32) and its norm to a
//     device scratch (one warp per row);
//   * the forward runs a grid of (row tile, bucket); each block takes
//     kRows image rows against all N profile rows, and writes one partial
//     sum; the wrapper adds the partials in a fixed order (no atomics);
//   * the backward runs a grid of (2 x row tiles, bucket): an image tile
//     recomputes its rows of z and gives d_in, a profile tile recomputes
//     its columns and gives d_pn, so every output row has one owner. d_s
//     for the tile sits in shared memory (kRows x 256 f32); d_in / d_pn go
//     through a per-block device scratch for the projection back through
//     the normalisation. Image tiles also write partial sums of dz * s and
//     dz, added by the wrapper.
// logit_scale, logit_bias and the cotangent are read from device memory, so
// no launch needs the host to read a device value. The kernels launch on
// the caller's stream, do not synchronise and allocate nothing; the entry
// points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;    // rows of one tile
constexpr int kMaxN = 256;  // rows of one bucket
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// sum of one value per thread over the block; red holds kWarps floats
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// log(1 + e^u) without overflow for any finite u
__device__ __forceinline__ float softplus(float u) {
  return fmaxf(u, 0.f) + log1pf(expf(-fabsf(u)));
}

// 1 / (1 + e^-u): e^-u overflows to inf for u << 0 and gives 0, never NaN
__device__ __forceinline__ float sigmoid(float u) {
  return 1.f / (1.f + expf(-u));
}

// Dot products of tile rows own[0..rows) with the row `other`, summed over
// the warp: every lane returns all kRows sums (rows past `rows` give 0).
__device__ __forceinline__ void tile_dots(const float* own, const float* other,
                                          int rows, int D, float* acc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float o = other[d];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (k < rows) acc[k] = fmaf(own[(size_t)k * D + d], o, acc[k]);
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = warp_sum(acc[k]);
}

// unit rows 0..B-1 image, B..2B-1 profile (f32); den[row] = max(||x||, eps)
template <typename T>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const T* __restrict__ img, const T* __restrict__ prof,
                 float* __restrict__ unit, float* __restrict__ den, int B,
                 int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= 2 * B) return;
  const T* x = row < B ? img + (size_t)row * D : prof + (size_t)(row - B) * D;
  float* u = unit + (size_t)row * D;
  float ss = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_f32(x[d]);
    ss = fmaf(v, v, ss);
  }
  const float nrm = fmaxf(sqrtf(warp_sum(ss)), kEps);
  for (int d = lane; d < D; d += 32) u[d] = to_f32(x[d]) / nrm;
  if (lane == 0) den[row] = nrm;
}

// grid (tiles, buckets): partial[bucket * tiles + tile] = the tile's
// sum of softplus(-y z)
__global__ void __launch_bounds__(kThreads)
siglip_fwd_kernel(const float* __restrict__ unit,
                  const float* __restrict__ logit_scale,
                  const float* __restrict__ logit_bias,
                  float* __restrict__ partial, int B, int N, int D) {
  __shared__ float red[kWarps];
  const int bucket = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, N - r0);
  const float* own = unit + (size_t)(bucket * N + r0) * D;
  const float* other = unit + (size_t)(B + bucket * N) * D;
  const float e = expf(logit_scale[0]);
  const float bias = logit_bias[0];
  float part = 0.f;
  float acc[kRows];
  for (int t = threadIdx.x >> 5; t < N; t += kWarps) {
    tile_dots(own, other + (size_t)t * D, rows, D, acc);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k >= rows) break;
        const float z = acc[k] * e + bias;
        part += softplus(r0 + k == t ? -z : z);  // softplus(-y z)
      }
    }
  }
  const float total = block_sum(part, red);
  if (threadIdx.x == 0) partial[bucket * gridDim.x + blockIdx.x] = total;
}

// grid (2 * tiles, buckets): x-blocks below `tiles` own image rows, the
// others profile rows (columns of z)
template <typename T>
__global__ void __launch_bounds__(kThreads)
siglip_bwd_kernel(const float* __restrict__ unit,
                  const float* __restrict__ den,
                  const float* __restrict__ logit_scale,
                  const float* __restrict__ logit_bias,
                  const float* __restrict__ g, T* __restrict__ d_img,
                  T* __restrict__ d_prof, float* __restrict__ ds_part,
                  float* __restrict__ db_part, float* __restrict__ dn_scratch,
                  int B, int N, int D) {
  __shared__ float ds[kRows][kMaxN];
  __shared__ float red[kWarps];
  const int tiles = gridDim.x / 2;
  const bool image = blockIdx.x < tiles;
  const int tile = image ? blockIdx.x : blockIdx.x - tiles;
  const int bucket = blockIdx.y;
  const int r0 = tile * kRows;
  const int rows = min(kRows, N - r0);
  const int own_row0 = (image ? 0 : B) + bucket * N + r0;
  const float* own = unit + (size_t)own_row0 * D;
  const float* other = unit + (size_t)((image ? B : 0) + bucket * N) * D;
  float* dn = dn_scratch +
              ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * kRows * D;
  const float e = expf(logit_scale[0]);
  const float bias = logit_bias[0];
  const float coef = g[0] / N;

  // d_s of the tile's rows (image) or columns (profile) into shared memory
  float s_part = 0.f, b_part = 0.f;
  float acc[kRows];
  for (int t = threadIdx.x >> 5; t < N; t += kWarps) {
    tile_dots(own, other + (size_t)t * D, rows, D, acc);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k >= rows) break;
        const float z = acc[k] * e + bias;
        const float y = r0 + k == t ? 1.f : -1.f;
        const float dz = coef * (-y * sigmoid(-y * z));
        s_part = fmaf(dz, acc[k], s_part);
        b_part += dz;
        ds[k][t] = dz * e;
      }
    }
  }
  __syncthreads();
  if (image) {  // block-uniform branch: every thread reaches block_sum
    const float s_total = block_sum(s_part, red);
    const float b_total = block_sum(b_part, red);
    if (threadIdx.x == 0) {
      ds_part[bucket * tiles + tile] = s_total * e;
      db_part[bucket * tiles + tile] = b_total;
    }
  }
  // dn[k, d] = sum_t d_s[k, t] other[t, d], one thread per d
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) a[k] = 0.f;
    for (int t = 0; t < N; ++t) {
      const float o = other[(size_t)t * D + d];
#pragma unroll
      for (int k = 0; k < kRows; ++k) a[k] = fmaf(ds[k][t], o, a[k]);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (k < rows) dn[(size_t)k * D + d] = a[k];
  }
  __syncthreads();
  // back through x -> x / ||x||, one warp per row
  const int lane = threadIdx.x & 31;
  T* out = (image ? d_img : d_prof) + (size_t)(bucket * N + r0) * D;
  for (int k = threadIdx.x >> 5; k < rows; k += kWarps) {
    const float* u = own + (size_t)k * D;
    const float* dk = dn + (size_t)k * D;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot = fmaf(dk[d], u[d], dot);
    dot = warp_sum(dot);
    const float nrm = den[own_row0 + k];
    for (int d = lane; d < D; d += 32)
      out[(size_t)k * D + d] = from_f32<T>((dk[d] - dot * u[d]) / nrm);
  }
}

int tiles_of(int N) { return (N + kRows - 1) / kRows; }

template <typename T>
void normalize(const void* img, const void* prof, float* unit, float* den,
               int B, int D, cudaStream_t stream) {
  normalize_kernel<T><<<(2 * B + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(prof), unit, den, B,
      D);
}

template <typename T>
void bwd(const void* img, const void* prof, const float* scale,
         const float* bias, const float* g, void* d_img, void* d_prof,
         float* ds_part, float* db_part, float* scratch, int buckets, int N,
         int D, cudaStream_t stream) {
  const int B = buckets * N;
  float* unit = scratch;
  float* den = unit + (size_t)2 * B * D;
  float* dn = den + 2 * B;
  normalize<T>(img, prof, unit, den, B, D, stream);
  const dim3 grid(2 * tiles_of(N), buckets);
  siglip_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      unit, den, scale, bias, g, static_cast<T*>(d_img),
      static_cast<T*>(d_prof), ds_part, db_part, dn, B, N, D);
}

}  // namespace

extern "C" {

// img, prof: (buckets, N, D) bf16 (bf16 = 1) or f32 (bf16 = 0), contiguous;
// logit_scale, logit_bias: one f32 each on the device; partial:
// (buckets, ceil(N / 8)) f32 sums of softplus(-y z); scratch: 2 B (D + 1)
// f32 with B = buckets N. N <= 256. Returns a cudaError_t code.
int siglip_fwd(const void* img, const void* prof, const void* logit_scale,
               const void* logit_bias, void* partial, void* scratch,
               int buckets, int N, int D, int bf16, void* stream) {
  if (N < 1 || N > kMaxN || D < 1 || buckets < 1 || buckets > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = buckets * N;
  float* unit = static_cast<float*>(scratch);
  float* den = unit + (size_t)2 * B * D;
  if (bf16)
    normalize<__nv_bfloat16>(img, prof, unit, den, B, D, s);
  else
    normalize<float>(img, prof, unit, den, B, D, s);
  siglip_fwd_kernel<<<dim3(tiles_of(N), buckets), kThreads, 0, s>>>(
      unit, static_cast<const float*>(logit_scale),
      static_cast<const float*>(logit_bias), static_cast<float*>(partial), B,
      N, D);
  return (int)cudaGetLastError();
}

// g: the cotangent of one bucket's loss, one f32 on the device; d_img,
// d_prof: like img, prof; ds_part, db_part: (buckets, ceil(N / 8)) f32
// partial d logit_scale and d logit_bias; scratch: 2 B (D + 1) +
// buckets * 2 ceil(N / 8) * 8 D f32.
int siglip_bwd(const void* img, const void* prof, const void* logit_scale,
               const void* logit_bias, const void* g, void* d_img,
               void* d_prof, void* ds_part, void* db_part, void* scratch,
               int buckets, int N, int D, int bf16, void* stream) {
  if (N < 1 || N > kMaxN || D < 1 || buckets < 1 || buckets > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scale = static_cast<const float*>(logit_scale);
  const float* bias = static_cast<const float*>(logit_bias);
  const float* gp = static_cast<const float*>(g);
  float* dsp = static_cast<float*>(ds_part);
  float* dbp = static_cast<float*>(db_part);
  float* scr = static_cast<float*>(scratch);
  if (bf16)
    bwd<__nv_bfloat16>(img, prof, scale, bias, gp, d_img, d_prof, dsp, dbp,
                       scr, buckets, N, D, s);
  else
    bwd<float>(img, prof, scale, bias, gp, d_img, d_prof, dsp, dbp, scr,
               buckets, N, D, s);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
