// Fused InstanceNorm + leaky-ReLU for Hopper (sm_90a). Two kernels (each a
// short chain of launches) with a plain C interface, bound from Python with
// ctypes (skyhdr_torch/ops/kernels/instnorm.py).
//
// What they replace (skyhdr/ops/pallas/instnorm.py):
//   K8 skyhdr_in_fwd_k8 — `_fwd_kernel` driven by `_pallas_fwd`: per
//        (sample, channel) over H*W,
//          mean = E[x], var = E[(x-mean)^2], rstd = 1/sqrt(var+eps),
//          yf = (x-mean)*rstd*gamma + beta,   y = yf cast to x's type,
//          y  = yf >= 0 ? y : alpha*y          (mask on the f32 yf),
//        and mean / rstd [B, C] f32 for the backward.
//   K9 skyhdr_in_bwd_k9 — `_bwd_kernel` driven by `_pallas_bwd`: with
//          xhat = (x-mean)*rstd, dyf = (xhat*gamma+beta >= 0) ? dy : alpha*dy,
//          dbeta = sum_b sum_hw dyf,   dgamma = sum_b sum_hw dyf*xhat,
//          dx = rstd*(dxhat - E[dxhat] - xhat*E[dxhat*xhat]), dxhat = dyf*gamma.
//
// What bounds them on this card: bytes. Each output costs a few flops
// against 4-12 bytes moved, so the least time is the traffic over 3.35 TB/s:
// K8 reads x and writes y, K9 reads x and dy and writes dx.
//
// What the design does about it: the TPU kernel holds one sample's whole
// (H, W, C) slab in VMEM and reads it once. Here a slab is up to 2 MB
// (64x256x32 f32), far above the 227 KB a block may hold, and one block per
// sample would leave most of the 132 SMs idle at small batches. So both
// kernels split H*W into S contiguous pixel ranges per sample and run a
// grid of (S, B) blocks; threads run along C, so a warp reads contiguous
// channels of neighbouring pixels (coalesced). Three steps, each its own
// launch on the caller's stream:
//   K8: (1) in_moments_kernel: per (split, channel) count/mean/M2, each
//           thread by Welford's update over its pixels, the block's rows
//           merged with Chan's parallel formula (never E[x^2]-E[x]^2, whose
//           cancellation loses the variance of a large-mean channel);
//       (2) in_stats_kernel: per (sample, channel) the S partials merged in
//           split order -> mean, rstd;
//       (3) in_apply_kernel: normalise + activate, elementwise.
//   K9: (1) in_bwd_partials_kernel: per (split, channel) sum dyf and
//           sum dyf*xhat, rows summed in a fixed order;
//       (2) in_bwd_merge_kernel: per (sample, channel) the splits summed in
//           order -> the per-sample dbeta/dgamma partials and E[dxhat],
//           E[dxhat*xhat];
//       (3) in_bwd_batch_kernel: dgamma/dbeta summed over the batch by a
//           fixed tree in shared memory (deterministic, no atomics);
//       (4) in_bwd_dx_kernel: dx, elementwise.
// The price of this simple form is a second read of x in K8 (and of x, dy
// in K9): ~1.5x and ~1.67x the bound's traffic where the tensors exceed the
// 50 MB L2.
//
// Activation gradient at exactly 0: the mask is `ypre >= 0` (as the TPU
// kernel), so a pre-activation of exactly 0 passes dy with slope 1; the
// unfused graph's relu has slope 0 there. K9 rounds ypre = xhat*gamma +
// beta as its plain version does (the product, then the sum; no fused
// multiply-add), so the two take the same slope where ypre is within an
// ulp of 0: the slope's jump (1 - alpha) would otherwise reach dx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// xhat*gamma + beta, rounded after the product and after the sum.
__device__ __forceinline__ float pre_activation(float xhat, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(xhat, gamma), beta);
}

constexpr int kThreads = 256;

__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16(v);
}
// v rounded to the element type's precision.
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// Pixel range [p0, p1) of split s of S over HW pixels.
__device__ __forceinline__ void split_range(int s, int S, int HW, int* p0, int* p1) {
  *p0 = static_cast<int>(static_cast<long long>(s) * HW / S);
  *p1 = static_cast<int>(static_cast<long long>(s + 1) * HW / S);
}

// Chan et al.: fold (nb, mb, m2b) into (n, m, m2).
__device__ __forceinline__ void chan_merge(float& n, float& m, float& m2, float nb,
                                           float mb, float m2b) {
  if (nb == 0.f) return;
  const float nab = n + nb;
  const float d = mb - m;
  const float fb = nb / nab;
  m += d * fb;
  m2 += m2b + d * d * n * fb;
  n = nab;
}

// K8 step 1. Grid (S, B); block C*R threads (thread t: channel t % C, row
// t / C); dynamic smem 3*C*R floats. ws [B, S, C, 2]: (mean, M2).
template <typename T>
__global__ void __launch_bounds__(1024)
in_moments_kernel(const T* __restrict__ x, float* __restrict__ ws, int HW, int C, int S) {
  extern __shared__ float sh[];
  const int nt = blockDim.x, t = threadIdx.x;
  const int R = nt / C, c = t % C, r = t / C;
  const int s = blockIdx.x, b = blockIdx.y;
  int p0, p1;
  split_range(s, S, HW, &p0, &p1);
  const T* xb = x + static_cast<size_t>(b) * HW * C;
  float n = 0.f, m = 0.f, m2 = 0.f;
  for (int p = p0 + r; p < p1; p += R) {
    const float v = ld(xb, p * C + c);
    n += 1.f;
    const float d = v - m;
    m += d / n;
    m2 += d * (v - m);
  }
  sh[t] = n;
  sh[nt + t] = m;
  sh[2 * nt + t] = m2;
  __syncthreads();
  if (r == 0) {
    for (int q = 1; q < R; ++q) {
      const int u = q * C + c;
      chan_merge(n, m, m2, sh[u], sh[nt + u], sh[2 * nt + u]);
    }
    float* w = ws + ((static_cast<size_t>(b) * S + s) * C + c) * 2;
    w[0] = m;
    w[1] = m2;
  }
}

// K8 step 2. One thread per (b, c): the S partials in split order.
__global__ void in_stats_kernel(const float* __restrict__ ws, float* __restrict__ mean,
                                float* __restrict__ rstd, int B, int HW, int C, int S,
                                float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float n = 0.f, m = 0.f, m2 = 0.f;
  for (int s = 0; s < S; ++s) {
    int p0, p1;
    split_range(s, S, HW, &p0, &p1);
    const float* w = ws + ((static_cast<size_t>(b) * S + s) * C + c) * 2;
    chan_merge(n, m, m2, static_cast<float>(p1 - p0), w[0], w[1]);
  }
  mean[i] = m;
  rstd[i] = 1.0f / sqrtf(m2 / static_cast<float>(HW) + eps);
}

// K8 step 3. Grid (ceil(HW*C / (kThreads*4)), B); alpha already rounded to
// T's precision (the TPU kernel multiplies the cast output by alpha in T).
template <typename T>
__global__ void __launch_bounds__(kThreads)
in_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const float* __restrict__ mean,
                const float* __restrict__ rstd, T* __restrict__ y, int HW, int C,
                float alpha) {
  const int per = HW * C, b = blockIdx.y;
  const T* xb = x + static_cast<size_t>(b) * per;
  T* yb = y + static_cast<size_t>(b) * per;
  const float* mb = mean + static_cast<size_t>(b) * C;
  const float* rb = rstd + static_cast<size_t>(b) * C;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < per; j += gridDim.x * blockDim.x) {
    const int c = j % C;
    const float yf = (ld(xb, j) - mb[c]) * rb[c] * gamma[c] + beta[c];
    float out = rnd(yf, yb);
    if (!(yf >= 0.f)) out = alpha * out;
    st(yb, j, out);
  }
}

// K9 step 1. Grid (S, B); block C*R; dynamic smem 2*C*R floats.
// ws [B, S, C, 2]: (sum dyf, sum dyf*xhat).
template <typename T>
__global__ void __launch_bounds__(1024)
in_bwd_partials_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       float* __restrict__ ws, int HW, int C, int S, float alpha) {
  extern __shared__ float sh[];
  const int nt = blockDim.x, t = threadIdx.x;
  const int R = nt / C, c = t % C, r = t / C;
  const int s = blockIdx.x, b = blockIdx.y;
  int p0, p1;
  split_range(s, S, HW, &p0, &p1);
  const size_t off = static_cast<size_t>(b) * HW * C;
  const float m = mean[b * C + c], rs = rstd[b * C + c], g = gamma[c], be = beta[c];
  float s1 = 0.f, s2 = 0.f;
  for (int p = p0 + r; p < p1; p += R) {
    const int i = p * C + c;
    const float xh = (ld(x + off, i) - m) * rs;
    float d = ld(dy + off, i);
    if (!(pre_activation(xh, g, be) >= 0.f)) d *= alpha;
    s1 += d;
    s2 += d * xh;
  }
  sh[t] = s1;
  sh[nt + t] = s2;
  __syncthreads();
  if (r == 0) {
    for (int q = 1; q < R; ++q) {
      s1 += sh[q * C + c];
      s2 += sh[nt + q * C + c];
    }
    float* w = ws + ((static_cast<size_t>(b) * S + s) * C + c) * 2;
    w[0] = s1;
    w[1] = s2;
  }
}

// K9 step 2. One thread per (b, c). part [B, C, 2]: per-sample (dbeta,
// dgamma); m12 [B, C, 2]: (E[dxhat], E[dxhat*xhat]).
__global__ void in_bwd_merge_kernel(const float* __restrict__ ws,
                                    const float* __restrict__ gamma,
                                    float* __restrict__ part, float* __restrict__ m12,
                                    int B, int HW, int C, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float s1 = 0.f, s2 = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* w = ws + ((static_cast<size_t>(b) * S + s) * C + c) * 2;
    s1 += w[0];
    s2 += w[1];
  }
  part[2 * i] = s1;
  part[2 * i + 1] = s2;
  const float g = gamma[c], n = static_cast<float>(HW);
  m12[2 * i] = g * s1 / n;
  m12[2 * i + 1] = g * s2 / n;
}

// K9 step 3. One block per channel: thread t sums samples t, t+kThreads,
// ... in order, then a fixed tree in shared memory.
__global__ void __launch_bounds__(kThreads)
in_bwd_batch_kernel(const float* __restrict__ part, float* __restrict__ dgamma,
                    float* __restrict__ dbeta, int B, int C) {
  __shared__ float sb[kThreads], sg[kThreads];
  const int c = blockIdx.x, t = threadIdx.x;
  float tb = 0.f, tg = 0.f;
  for (int b = t; b < B; b += kThreads) {
    tb += part[2 * (b * C + c)];
    tg += part[2 * (b * C + c) + 1];
  }
  sb[t] = tb;
  sg[t] = tg;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      sb[t] += sb[t + h];
      sg[t] += sg[t + h];
    }
    __syncthreads();
  }
  if (t == 0) {
    dbeta[c] = sb[0];
    dgamma[c] = sg[0];
  }
}

// K9 step 4. Grid as in_apply_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
in_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 const float* __restrict__ m12, T* __restrict__ dx, int HW, int C,
                 float alpha) {
  const int per = HW * C, b = blockIdx.y;
  const size_t off = static_cast<size_t>(b) * per;
  const float* mb = mean + static_cast<size_t>(b) * C;
  const float* rb = rstd + static_cast<size_t>(b) * C;
  const float* qb = m12 + static_cast<size_t>(b) * C * 2;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < per; j += gridDim.x * blockDim.x) {
    const int c = j % C;
    const float rs = rb[c], g = gamma[c];
    const float xh = (ld(x + off, j) - mb[c]) * rs;
    float d = ld(dy + off, j);
    if (!(pre_activation(xh, g, beta[c]) >= 0.f)) d *= alpha;
    const float dxh = d * g;
    st(dx + off, j, rs * (dxh - qb[2 * c] - xh * qb[2 * c + 1]));
  }
}

int rows_for(int C) { return C >= kThreads ? 1 : kThreads / C; }

dim3 elementwise_grid(int HW, int C, int B) {
  const long long per = static_cast<long long>(HW) * C;
  const long long blocks = (per + kThreads * 4 - 1) / (kThreads * 4);
  return dim3(static_cast<unsigned>(blocks), B);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, void* ws,
                       void* y, void* mean, void* rstd, int B, int HW, int C, int S,
                       float eps, float alpha, cudaStream_t stream) {
  const int nt = C * rows_for(C);
  in_moments_kernel<T><<<dim3(S, B), nt, 3 * nt * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<float*>(ws), HW, C, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_stats_kernel<<<(B * C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(mean), static_cast<float*>(rstd),
      B, HW, C, S, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_apply_kernel<T><<<elementwise_grid(HW, C, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(y), HW, C, alpha);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                       const void* mean, const void* rstd, void* ws, void* part,
                       void* m12, void* dgamma, void* dbeta, void* dx, int B, int HW,
                       int C, int S, float alpha, cudaStream_t stream) {
  const int nt = C * rows_for(C);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* mn = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  in_bwd_partials_kernel<T><<<dim3(S, B), nt, 2 * nt * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), g, be, mn, rs,
      static_cast<float*>(ws), HW, C, S, alpha);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_merge_kernel<<<(B * C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(ws), g, static_cast<float*>(part), static_cast<float*>(m12),
      B, HW, C, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_batch_kernel<<<C, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), B, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_dx_kernel<T><<<elementwise_grid(HW, C, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), g, be, mn, rs,
      static_cast<const float*>(m12), static_cast<T*>(dx), HW, C, alpha);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K8: x [B,HW,C] (bf16 when is_bf16, else f32), gamma/beta [C] f32,
// ws [B,S,C,2] f32 scratch, y [B,HW,C] in x's type, mean/rstd [B,C] f32.
// `alpha` is the slope for a negative pre-activation, rounded to x's type
// by the caller (1: no activation). C <= 1024, HW*C < 2^31.
int skyhdr_in_fwd_k8(const void* x, const void* gamma, const void* beta, void* ws,
                     void* y, void* mean, void* rstd, int B, int HW, int C, int S,
                     float eps, float alpha, int is_bf16, int device, void* stream) {
  if (C < 1 || C > 1024 || S < 1 || B < 1 || B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<__nv_bfloat16>(x, gamma, beta, ws, y, mean, rstd, B, HW, C, S, eps,
                                     alpha, s);
  return launch_fwd<float>(x, gamma, beta, ws, y, mean, rstd, B, HW, C, S, eps, alpha, s);
}

// K9: x, dy [B,HW,C] of one type (bf16 when is_bf16, else f32), gamma/beta
// [C] f32, mean/rstd [B,C] f32 from K8; scratch ws [B,S,C,2], part and m12
// [B,C,2] f32; out dgamma/dbeta [C] f32 and dx [B,HW,C] in x's type.
int skyhdr_in_bwd_k9(const void* x, const void* dy, const void* gamma, const void* beta,
                     const void* mean, const void* rstd, void* ws, void* part, void* m12,
                     void* dgamma, void* dbeta, void* dx, int B, int HW, int C, int S,
                     float alpha, int is_bf16, int device, void* stream) {
  if (C < 1 || C > 1024 || S < 1 || B < 1 || B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(x, dy, gamma, beta, mean, rstd, ws, part, m12, dgamma,
                                     dbeta, dx, B, HW, C, S, alpha, s);
  return launch_bwd<float>(x, dy, gamma, beta, mean, rstd, ws, part, m12, dgamma, dbeta, dx,
                           B, HW, C, S, alpha, s);
}

}  // extern "C"
