// Bucketed symmetric InfoNCE (CLIP) loss, forward and backward, for Hopper
// (sm_90a). Plain C entry points, loaded with ctypes by ops/contrastive.py.
//
// Replaces the TPU kernels
//   multimodal_plankton_recognition_tpu/ops/pallas/contrastive.py
//   ::_clip_fwd_kernel (through _clip_fwd) and ::_clip_bwd_kernel (through
//   _clip_bwd).
//
// Per bucket of N image and N profile embeddings of width D (bf16 or f32
// in, f32 inside), as the TPU kernels compute it:
//   i = x / max(||x||, 1e-12), p likewise        (row L2 normalisation)
//   s = i . p^T,  z = s * exp(logit_scale)
//   loss = (sum_r (lse_r - z_rr) + sum_c (lse_c - z_cc)) * 0.5 / N
// and backward, with g the cotangent of the bucket's loss:
//   dz = g * 0.5 / N * ((softmax_r(z) - I) + (softmax_c(z) - I))
//   d logit_scale = sum(dz * s) * exp(logit_scale)
//   d_in = (dz * e^scale) . p,  d_pn = (dz * e^scale)^T . i
//   di = (d_in - (d_in . i) i) / max(||x||, 1e-12), dp likewise
//
// What bounds it: at the ViT flagship's shape (16 buckets of N = 16,
// D = 512) the whole loss is 0.5 MB of embeddings and a few MFLOP, so a
// launch is bound by latency, not by bytes or operations. The design keeps
// one block per bucket and the logits out of the host's sight: the wrapper
// hands in a device scratch buffer (normalised rows, the N x N logits and,
// in the backward, d_in / d_pn), which stays in the 50 MB L2. N = 256 (the
// largest bucket, one bucket of 256) needs 256 KB of f32 logits, more than
// an SM's shared memory, hence the scratch in device memory; per-row and
// per-column statistics (N <= 256) live in shared memory.
//
// logit_scale and the cotangent are read from device memory, so neither
// launch needs the host to read a device value. The kernels launch on the
// caller's stream, do not synchronise and allocate nothing; the entry
// points return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 256;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
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

// Normalise the bucket's 2N rows into in / pn (f32); den[row] gets
// max(||x||, eps) (image rows 0..N-1, profile rows N..2N-1).
template <typename T>
__device__ void normalize_rows(const T* img, const T* prof, float* in,
                               float* pn, float* den, int N, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = warp; row < 2 * N; row += kWarps) {
    const T* x = row < N ? img + (size_t)row * D : prof + (size_t)(row - N) * D;
    float* y = row < N ? in + (size_t)row * D : pn + (size_t)(row - N) * D;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = to_f32(x[d]);
      ss = fmaf(v, v, ss);
    }
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), kEps);
    for (int d = lane; d < D; d += 32) y[d] = to_f32(x[d]) / nrm;
    if (lane == 0) den[row] = nrm;
  }
}

// s[r * N + c] = in_r . pn_c, one warp per entry
__device__ void similarities(const float* in, const float* pn, float* s,
                             int N, int D) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int rc = warp; rc < N * N; rc += kWarps) {
    const float* a = in + (size_t)(rc / N) * D;
    const float* b = pn + (size_t)(rc % N) * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(a[d], b[d], acc);
    acc = warp_sum(acc);
    if (lane == 0) s[rc] = acc;
  }
}

// Max and sum of exp(z - max) of each row (axis 0) and column (axis 1) of
// z = s * e, one warp per line; lines 0..N-1 are rows, N..2N-1 columns.
__device__ void line_stats(const float* s, float e, float* mx, float* se,
                           int N) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int line = warp; line < 2 * N; line += kWarps) {
    const bool row = line < N;
    const int k = row ? line : line - N;
    float m = -INFINITY;
    for (int t = lane; t < N; t += 32)
      m = fmaxf(m, s[row ? k * N + t : t * N + k] * e);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < N; t += 32)
      sum += expf(s[row ? k * N + t : t * N + k] * e - m);
    sum = warp_sum(sum);
    if (lane == 0) {
      mx[line] = m;
      se[line] = sum;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_fwd_kernel(const T* __restrict__ img, const T* __restrict__ prof,
                const float* __restrict__ logit_scale,
                float* __restrict__ losses, float* __restrict__ scratch,
                int N, int D) {
  __shared__ float den[2 * kMaxN];
  __shared__ float mx[2 * kMaxN];
  __shared__ float se[2 * kMaxN];
  __shared__ float red[kWarps];
  const int bucket = blockIdx.x;
  const size_t nd = (size_t)N * D;
  img += bucket * nd;
  prof += bucket * nd;
  float* in = scratch + bucket * (2 * nd + (size_t)N * N);
  float* pn = in + nd;
  float* s = pn + nd;
  const float e = expf(logit_scale[0]);

  normalize_rows(img, prof, in, pn, den, N, D);
  __syncthreads();
  similarities(in, pn, s, N, D);
  __syncthreads();
  line_stats(s, e, mx, se, N);
  __syncthreads();
  // lse_line - z_kk over the 2N lines
  float part = 0.f;
  for (int line = threadIdx.x; line < 2 * N; line += kThreads) {
    const int k = line < N ? line : line - N;
    part += mx[line] + logf(se[line]) - s[k * N + k] * e;
  }
  const float total = block_sum(part, red);
  if (threadIdx.x == 0) losses[bucket] = total * 0.5f / N;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_bwd_kernel(const T* __restrict__ img, const T* __restrict__ prof,
                const float* __restrict__ logit_scale,
                const float* __restrict__ g, T* __restrict__ d_img,
                T* __restrict__ d_prof, float* __restrict__ d_scale,
                float* __restrict__ scratch, int N, int D) {
  __shared__ float den[2 * kMaxN];
  __shared__ float mx[2 * kMaxN];
  __shared__ float se[2 * kMaxN];
  __shared__ float red[kWarps];
  const int bucket = blockIdx.x;
  const size_t nd = (size_t)N * D;
  img += bucket * nd;
  prof += bucket * nd;
  d_img += bucket * nd;
  d_prof += bucket * nd;
  float* in = scratch + bucket * (4 * nd + (size_t)N * N);
  float* pn = in + nd;
  float* d_in = pn + nd;
  float* d_pn = d_in + nd;
  float* s = d_pn + nd;
  const float e = expf(logit_scale[0]);
  const float coef = g[0] * 0.5f / N;

  normalize_rows(img, prof, in, pn, den, N, D);
  __syncthreads();
  similarities(in, pn, s, N, D);
  __syncthreads();
  line_stats(s, e, mx, se, N);
  __syncthreads();
  // dz, its d logit_scale term, and d_s = dz * e in place of s
  float ds_part = 0.f;
  for (int rc = threadIdx.x; rc < N * N; rc += kThreads) {
    const int r = rc / N;
    const int c = rc % N;
    const float eye = r == c ? 1.f : 0.f;
    const float sv = s[rc];
    const float z = sv * e;
    const float soft_r = expf(z - mx[r]) / se[r];
    const float soft_c = expf(z - mx[N + c]) / se[N + c];
    const float dz = coef * ((soft_r - eye) + (soft_c - eye));
    ds_part = fmaf(dz, sv, ds_part);
    s[rc] = dz * e;
  }
  const float ds_total = block_sum(ds_part, red);  // also syncs s
  if (threadIdx.x == 0) d_scale[bucket] = ds_total * e;
  // d_in[r, d] = sum_c d_s[r, c] pn[c, d]; d_pn[c, d] = sum_r d_s[r, c] in[r, d]
  for (int idx = threadIdx.x; idx < N * D; idx += kThreads) {
    const int k = idx / D;
    const int d = idx - k * D;
    float a = 0.f, b = 0.f;
    for (int t = 0; t < N; ++t) {
      a = fmaf(s[k * N + t], pn[(size_t)t * D + d], a);
      b = fmaf(s[t * N + k], in[(size_t)t * D + d], b);
    }
    d_in[idx] = a;
    d_pn[idx] = b;
  }
  __syncthreads();
  // back through x -> x / ||x||, one warp per row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = warp; row < 2 * N; row += kWarps) {
    const bool image = row < N;
    const size_t off = (size_t)(image ? row : row - N) * D;
    const float* dn = (image ? d_in : d_pn) + off;
    const float* x = (image ? in : pn) + off;
    T* out = (image ? d_img : d_prof) + off;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot = fmaf(dn[d], x[d], dot);
    dot = warp_sum(dot);
    for (int d = lane; d < D; d += 32)
      out[d] = from_f32<T>((dn[d] - dot * x[d]) / den[row]);
  }
}

template <typename T>
int fwd(const void* img, const void* prof, const void* logit_scale,
        void* losses, void* scratch, int buckets, int N, int D,
        cudaStream_t stream) {
  clip_fwd_kernel<T><<<buckets, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(prof),
      static_cast<const float*>(logit_scale), static_cast<float*>(losses),
      static_cast<float*>(scratch), N, D);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* img, const void* prof, const void* logit_scale,
        const void* g, void* d_img, void* d_prof, void* d_scale,
        void* scratch, int buckets, int N, int D, cudaStream_t stream) {
  clip_bwd_kernel<T><<<buckets, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(prof),
      static_cast<const float*>(logit_scale), static_cast<const float*>(g),
      static_cast<T*>(d_img), static_cast<T*>(d_prof),
      static_cast<float*>(d_scale), static_cast<float*>(scratch), N, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img, prof: (buckets, N, D) bf16 (bf16 = 1) or f32 (bf16 = 0), contiguous;
// logit_scale: one f32 on the device; losses: (buckets,) f32; scratch:
// buckets * (2 N D + N N) f32. N <= 256. Returns a cudaError_t code.
int clip_fwd(const void* img, const void* prof, const void* logit_scale,
             void* losses, void* scratch, int buckets, int N, int D,
             int bf16, void* stream) {
  if (N < 1 || N > kMaxN || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(img, prof, logit_scale, losses, scratch,
                                   buckets, N, D, s)
              : fwd<float>(img, prof, logit_scale, losses, scratch, buckets,
                           N, D, s);
}

// g: the cotangent of one bucket's loss, one f32 on the device; d_img,
// d_prof: like img, prof; d_scale: (buckets,) f32; scratch:
// buckets * (4 N D + N N) f32.
int clip_bwd(const void* img, const void* prof, const void* logit_scale,
             const void* g, void* d_img, void* d_prof, void* d_scale,
             void* scratch, int buckets, int N, int D, int bf16,
             void* stream) {
  if (N < 1 || N > kMaxN || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(img, prof, logit_scale, g, d_img, d_prof,
                                   d_scale, scratch, buckets, N, D, s)
              : bwd<float>(img, prof, logit_scale, g, d_img, d_prof, d_scale,
                           scratch, buckets, N, D, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
