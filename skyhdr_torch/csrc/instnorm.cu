// Fused InstanceNorm + leaky-ReLU for Hopper (sm_90a). Two kernels, one
// launch each, with a plain C interface, bound from Python with ctypes
// (skyhdr_torch/ops/kernels/instnorm.py).
//
// What they replace (skyhdr/ops/pallas/instnorm.py):
//   K8 skyhdr_in_fwd_k8 -> in_fwd_kernel: `_fwd_kernel` driven by
//        `_pallas_fwd`: per (sample, channel) over H*W,
//          mean = E[x], var = E[(x-mean)^2], rstd = 1/sqrt(var+eps),
//          yf = (x-mean)*rstd*gamma + beta,   y = yf cast to x's type,
//          y  = yf >= 0 ? y : alpha*y          (mask on the f32 yf),
//        and mean / rstd [B, C] f32 for the backward.
//   K9 skyhdr_in_bwd_k9 -> in_bwd_kernel: `_bwd_kernel` driven by
//        `_pallas_bwd`: with
//          xhat = (x-mean)*rstd, dyf = (xhat*gamma+beta >= 0) ? dy : alpha*dy,
//          dbeta = sum_b sum_hw dyf,   dgamma = sum_b sum_hw dyf*xhat,
//          dx = rstd*(dxhat - E[dxhat] - xhat*E[dxhat*xhat]), dxhat = dyf*gamma.
//
// What bounds them on this card: bytes. Each element costs 10-16 flops
// against 8-12 bytes moved, so the least time is the traffic over 3.35 TB/s:
// K8 reads x once and writes y once, K9 reads x and dy once and writes dx.
//
// What the design does about it. The TPU kernel holds one sample's whole
// (H, W, C) slab in VMEM and reads it once. A slab here is up to 2 MB f32
// (64x256x32), and 4 MB for K9's x and dy: far above the 227 KB a block may
// hold, but not above what a thread-block cluster holds. So each kernel
// runs one cluster of `cluster` blocks per (sample, channel group); the
// blocks split H*W into contiguous pixel ranges, and the channels into
// `groups` groups of CG = C / groups (each its own cluster: the statistics
// are per channel). Each block copies its share of x (and dy) once from
// device memory into shared memory with 16-byte cp.async (threads run
// along the group's channels, so a warp's copies are contiguous runs of
// >= 32 bytes). Then, all from shared memory:
//   K8: each thread sums its pixels; the block's rows are summed in a fixed
//       order (a warp butterfly, then the warps in order); the cluster's
//       block sums are read through distributed shared memory in rank order
//       -> the mean; the same again for sum (x - mean)^2 -> rstd (the TPU
//       kernel's two passes; never E[x^2] - E[x]^2, whose cancellation
//       loses the variance of a large-mean channel); then y is written from
//       the copy the block holds.
//   K9: one pass of sum dyf and sum dyf*xhat, merged the same way; rank 0
//       writes the sample's (dbeta, dgamma) partials [B, C, 2]; dx is written
//       from the copy held. The last cluster to finish (a ticket counter,
//       after __threadfence; the counter resets itself) sums the partials
//       over the batch in sample order: dbeta, dgamma, deterministic, with
//       no atomics on floats and no second launch.
// Device-memory traffic is therefore the bound's: one read of each input,
// one write of each output; every sum is in a fixed order, so both kernels
// are bitwise repeatable. A shape whose share does not fit (`hold` = 0:
// none the model runs) reads its share from device memory in each pass
// instead (K8 three times, K9 twice), mostly from L2.
//
// Activation gradient at exactly 0: the mask is `ypre >= 0` (as the TPU
// kernel), so a pre-activation of exactly 0 passes dy with slope 1; the
// unfused graph's relu has slope 0 there. K9 rounds ypre = xhat*gamma +
// beta as its plain version does (the product, then the sum; no fused
// multiply-add), so the two take the same slope where ypre is within an
// ulp of 0: the slope's jump (1 - alpha) would otherwise reach dx.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;  // non-portable above 8
// Dynamic shared memory a block may use: the card's 227 KB less 1 KB for
// static shared memory.
constexpr int kMaxSmem = 232448 - 1024;
// Threads a block may have: 512 with 16-byte vectors (their registers),
// 1024 with one element a thread (a group of up to 1024 channels).
__host__ __device__ constexpr int max_threads(int V) { return V == 1 ? 1024 : 512; }

// xhat*gamma + beta, rounded after the product and after the sum.
__device__ __forceinline__ float pre_activation(float xhat, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(xhat, gamma), beta);
}

// V elements of T at p as floats, and back (rounded to nearest even).
__device__ __forceinline__ void ldv(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void ldv(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void stv(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}
__device__ __forceinline__ void stv(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]), bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void stv(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void stv(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}
// v rounded to the element type's precision.
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// V elements from device memory into shared memory: one 16-byte cp.async
// (waited for by cp_wait), or plain copies for V = 1.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (V * sizeof(T) == 16) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = src[j];
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The two halves of a cluster barrier: after `cluster_arrive` a block reads
// no other block's shared memory; `cluster_wait` before it exits keeps its
// own alive until every block of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Pixel range [p0, p1) of block `rank` of n over HW pixels.
__device__ __forceinline__ void split_range(int rank, int n, int HW, int* p0, int* p1) {
  *p0 = static_cast<int>(static_cast<long long>(rank) * HW / n);
  *p1 = static_cast<int>(static_cast<long long>(rank + 1) * HW / n);
}

// Bytes of dynamic shared memory of a launch (the host's `in_smem_bytes`
// mirrors it): the held copies (tensors x pmax x CG elements, each padded
// to 16 bytes), then floats: the cluster partials and totals (4 CG), then
// the block reduction's rows (rows x (2 CG + 1): two quantities and a
// count a row).
__host__ __device__ inline int red_rows(int threads, int lanes) {
  return 32 % lanes == 0 ? threads / 32 : threads / lanes;
}
__host__ __device__ inline long long held_bytes(int HW, int n, int CG, int elem) {
  const long long pmax = (HW + n - 1) / n;
  return (pmax * CG * elem + 15) / 16 * 16;
}
long long smem_bytes(int HW, int n, int CG, int V, int threads, int elem, int tensors,
                     int hold) {
  const long long held = hold ? tensors * held_bytes(HW, n, CG, elem) : 0;
  return held + 4LL * (4 * CG + static_cast<long long>(red_rows(threads, CG / V)) * (2 * CG + 1));
}

// Sums s[q][j] (quantity q of channel lane*V + j over this thread's rows)
// over the block's rows in a fixed order into out[q * CG + lane * V + j]:
// a butterfly across a warp's rows where a warp holds whole rows (32 % L
// == 0), then the rows (warps) in order. Ends with out written by other
// threads than its readers: the caller's barrier publishes it.
template <int Q, int V>
__device__ __forceinline__ void block_sum(float (&s)[Q][V], float* red, float* out, int L,
                                          int CG) {
  const int t = threadIdx.x, nt = blockDim.x, lane = t % L;
  int rows = nt / L, r = t / L;
  bool write = true;
  if (32 % L == 0) {
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int j = 0; j < V; ++j) s[q][j] += __shfl_xor_sync(0xffffffffu, s[q][j], off);
    }
    rows = nt >> 5;
    r = t >> 5;
    write = (t & 31) < L;
  }
  if (write) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) red[(q * rows + r) * CG + lane * V + j] = s[q][j];
  }
  __syncthreads();
  for (int i = t; i < Q * CG; i += nt) {
    const int q = i / CG, cc = i - q * CG;
    float a = 0.f;
#pragma unroll 8
    for (int k = 0; k < rows; ++k) a += red[(q * rows + k) * CG + cc];
    out[i] = a;
  }
}

// Element i of the cluster's `part` arrays, summed in rank order (the
// remote reads issued four at a time, then added).
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* part, int i,
                                             int n) {
  float a = 0.f;
  for (int r = 0; r < n; r += 4) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = r + k < n ? cluster.map_shared_rank(part, r + k)[i] : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (r + k < n) a += v[k];
  }
  return a;
}

// Chan et al.: folds the moments (nb, mb, m2b) of a set into (n, m, m2):
// count, mean and sum of squared deviations from the mean.
__device__ __forceinline__ void chan(float& n, float& m, float& m2, float nb, float mb,
                                     float m2b) {
  if (nb == 0.f) return;
  const float nab = n + nb, d = mb - m, fb = nb / nab;
  m += d * fb;
  m2 += m2b + d * d * n * fb;
  n = nab;
}

// K8's block_sum: the moments (n; m[j], m2[j] of channel lane*V + j) of
// each thread's pixels merged over the block's rows by Chan's formula in a
// fixed order (the warp butterfly, then the rows in order) into out[i]
// (mean) and out[CG + i] (sum of squared deviations).
template <int V>
__device__ __forceinline__ void block_moments(float n, float (&m)[V], float (&m2)[V],
                                              float* red, float* out, int L, int CG) {
  const int t = threadIdx.x, nt = blockDim.x, lane = t % L;
  int rows = nt / L, r = t / L;
  bool write = true;
  if (32 % L == 0) {
    for (int off = L; off < 32; off <<= 1) {
      const float nb = __shfl_xor_sync(0xffffffffu, n, off);
      float nj = n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        nj = n;
        chan(nj, m[j], m2[j], nb, __shfl_xor_sync(0xffffffffu, m[j], off),
             __shfl_xor_sync(0xffffffffu, m2[j], off));
      }
      n = nj;
    }
    rows = nt >> 5;
    r = t >> 5;
    write = (t & 31) < L;
  }
  float* rn = red;          // [rows] counts
  float* rm = red + rows;   // [2][rows][CG]
  if (write) {
    if (lane == 0) rn[r] = n;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      rm[r * CG + lane * V + j] = m[j];
      rm[(rows + r) * CG + lane * V + j] = m2[j];
    }
  }
  __syncthreads();
  for (int i = t; i < CG; i += nt) {
    float a = 0.f, am = 0.f, am2 = 0.f;
    for (int k = 0; k < rows; ++k) chan(a, am, am2, rn[k], rm[k * CG + i], rm[(rows + k) * CG + i]);
    out[i] = am;
    out[CG + i] = am2;
  }
}

// K8. Grid (cluster, groups, B), cluster (cluster, 1, 1); block: lanes L =
// CG / V along the group's channels x rows R = blockDim / L along the
// pixels; thread (lane, row) takes pixels row, row + R, ... of its block's
// range and channels c0 + lane*V .. + V.
template <typename T, int V, bool HOLD>
__global__ void __launch_bounds__(max_threads(V))
in_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, float* __restrict__ mean,
              float* __restrict__ rstd, int HW, int C, int CG, float eps, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, nt = blockDim.x, L = CG / V, R = nt / L;
  const int lane = t % L, row = t / L;
  const int cg0 = blockIdx.y * CG, c = cg0 + lane * V;
  const size_t bc = static_cast<size_t>(blockIdx.z) * C;
  int p0, p1;
  split_range(rank, n, HW, &p0, &p1);
  const int P = p1 - p0;
  const size_t at = (static_cast<size_t>(blockIdx.z) * HW + p0) * C + c;
  const T* xg = x + at;
  T* held = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(smem + (HOLD ? held_bytes(HW, n, CG, sizeof(T)) : 0));
  float* tot = part + 2 * CG;
  float* red = tot + 2 * CG;
  auto src = [&](int p) -> const T* {
    return HOLD ? held + p * CG + lane * V : xg + static_cast<size_t>(p) * C;
  };

  // Copy the share in two cp.async groups, and sum the first half of the
  // thread's pixels while the second is in flight.
  const int mine = P > row ? (P - row + R - 1) / R : 0, half = mine / 2;
  if (HOLD) {
    int k = 0;
    for (int p = row; p < P; p += R, ++k) {
      stage<T, V>(held + p * CG + lane * V, xg + static_cast<size_t>(p) * C);
      if (k + 1 == half) cp_commit();
    }
    cp_commit();
    cp_wait<1>();  // each thread reads back only what it copied
  }
  // The moments of the thread's pixels: their mean, then the sum of squared
  // deviations from it (two passes over what the thread holds).
  float m[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = m2[j] = 0.f;
  int p = row;
  for (int k = 0; k < half; ++k, p += R) {
    float v[V];
    ldv(src(p), v);
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] += v[j];
  }
  if (HOLD) cp_wait<0>();
  for (; p < P; p += R) {
    float v[V];
    ldv(src(p), v);
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] += v[j];
  }
  const float cnt = static_cast<float>(mine);
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = mine ? m[j] / cnt : 0.f;
  for (p = row; p < P; p += R) {
    float v[V];
    ldv(src(p), v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - m[j];
      m2[j] += d * d;
    }
  }
  block_moments<V>(cnt, m, m2, red, part, L, CG);
  cluster.sync();
  // The cluster's blocks merged in rank order (block r holds its range's
  // p1 - p0 pixels).
  for (int i = t; i < CG; i += nt) {
    float a = 0.f, am = 0.f, am2 = 0.f;
    for (int r0 = 0; r0 < n; r0 += 4) {
      float mb[4], m2b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* q = r0 + k < n ? cluster.map_shared_rank(part, r0 + k) : part;
        mb[k] = q[i];
        m2b[k] = q[CG + i];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (r0 + k < n) {
          int q0, q1;
          split_range(r0 + k, n, HW, &q0, &q1);
          chan(a, am, am2, static_cast<float>(q1 - q0), mb[k], m2b[k]);
        }
      }
    }
    const float r = 1.0f / sqrtf(am2 / static_cast<float>(HW) + eps);
    tot[i] = am;
    tot[CG + i] = r;
    if (rank == 0) {
      mean[bc + cg0 + i] = am;
      rstd[bc + cg0 + i] = r;
    }
  }
  cluster_arrive();
  __syncthreads();
  float rs[V], g[V], be[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = tot[lane * V + j];
    rs[j] = tot[CG + lane * V + j];
    g[j] = gamma[c + j];
    be[j] = beta[c + j];
  }
  T* yg = y + at;
  for (int p = row; p < P; p += R) {
    float v[V];
    ldv(src(p), v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float yf = (v[j] - m[j]) * rs[j] * g[j] + be[j];
      float o = rnd(yf, yg);
      if (!(yf >= 0.f)) o = alpha * o;  // alpha already rounded to T's precision
      v[j] = o;
    }
    stv(yg + static_cast<size_t>(p) * C, v);
  }
  cluster_wait();
}

// K9. Grid and block as K8. part [B, C, 2] f32: each sample's (sum dyf,
// sum dyf*xhat); counter: an int that is 0 at launch and 0 again at exit.
template <typename T, int V, bool HOLD>
__global__ void __launch_bounds__(max_threads(V))
in_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              float* part_out, unsigned* __restrict__ counter,
              float* __restrict__ dgamma, float* __restrict__ dbeta, T* __restrict__ dx,
              int B, int HW, int C, int CG, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, nt = blockDim.x, L = CG / V, R = nt / L;
  const int lane = t % L, row = t / L;
  const int cg0 = blockIdx.y * CG, c = cg0 + lane * V;
  const size_t bc = static_cast<size_t>(blockIdx.z) * C;
  int p0, p1;
  split_range(rank, n, HW, &p0, &p1);
  const int P = p1 - p0;
  const size_t at = (static_cast<size_t>(blockIdx.z) * HW + p0) * C + c;
  const T* xg = x + at;
  const T* dyg = dy + at;
  const long long hb = HOLD ? held_bytes(HW, n, CG, sizeof(T)) : 0;
  T* hx = reinterpret_cast<T*>(smem);
  T* hdy = reinterpret_cast<T*>(smem + hb);
  float* part = reinterpret_cast<float*>(smem + 2 * hb);
  float* tot = part + 2 * CG;
  float* red = tot + 2 * CG;

  // Copy the shares in two cp.async groups, and sum the first half of the
  // thread's pixels while the second is in flight.
  const int mine = P > row ? (P - row + R - 1) / R : 0, half = mine / 2;
  if (HOLD) {
    int k = 0;
    for (int p = row; p < P; p += R, ++k) {
      const size_t off = static_cast<size_t>(p) * C;
      stage<T, V>(hx + p * CG + lane * V, xg + off);
      stage<T, V>(hdy + p * CG + lane * V, dyg + off);
      if (k + 1 == half) cp_commit();
    }
    cp_commit();
    cp_wait<1>();  // each thread reads back only what it copied
  }
  float m[V], rs[V], g[V], be[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = mean[bc + c + j];
    rs[j] = rstd[bc + c + j];
    g[j] = gamma[c + j];
    be[j] = beta[c + j];
  }
  // xhat and dyf of the thread's pixel p.
  auto load = [&](int p, float (&xh)[V], float (&d)[V]) {
    if (HOLD) {
      ldv(hx + p * CG + lane * V, xh);
      ldv(hdy + p * CG + lane * V, d);
    } else {
      ldv(xg + static_cast<size_t>(p) * C, xh);
      ldv(dyg + static_cast<size_t>(p) * C, d);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      xh[j] = (xh[j] - m[j]) * rs[j];
      if (!(pre_activation(xh[j], g[j], be[j]) >= 0.f)) d[j] *= alpha;
    }
  };
  float s[2][V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[0][j] = s[1][j] = 0.f;
  for (int p = row, k = 0; p < P; p += R, ++k) {
    if (HOLD && k == half) cp_wait<0>();
    float xh[V], d[V];
    load(p, xh, d);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[0][j] += d[j];
      s[1][j] += d[j] * xh[j];
    }
  }
  block_sum<2, V>(s, red, part, L, CG);
  cluster.sync();
  for (int i = t; i < 2 * CG; i += nt) {
    const int q = i / CG, cc = i - q * CG;
    const float a = cluster_sum(cluster, part, i, n);
    tot[i] = gamma[cg0 + cc] * a / static_cast<float>(HW);  // E[dxhat], E[dxhat*xhat]
    if (rank == 0) part_out[(bc + cg0 + cc) * 2 + q] = a;   // dbeta, dgamma of this sample
  }
  cluster_arrive();
  __syncthreads();
  float m1[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m1[j] = tot[lane * V + j];
    m2[j] = tot[CG + lane * V + j];
  }
  T* dxg = dx + at;
  for (int p = row; p < P; p += R) {
    float xh[V], d[V];
    load(p, xh, d);
#pragma unroll
    for (int j = 0; j < V; ++j) d[j] = rs[j] * (d[j] * g[j] - m1[j] - xh[j] * m2[j]);
    stv(dxg + static_cast<size_t>(p) * C, d);
  }
  if (rank == 0) {
    // The last of the B x groups clusters to get here sums every sample's
    // partials over the batch, in sample order.
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(counter, 1u) == gridDim.y * gridDim.z - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int i = t; i < 2 * C; i += nt) {
        float a = 0.f;
#pragma unroll 16
        for (int b = 0; b < B; ++b) a += __ldcg(part_out + static_cast<size_t>(b) * 2 * C + i);
        (i & 1 ? dgamma : dbeta)[i >> 1] = a;
      }
      if (t == 0) *counter = 0u;  // ready for the next launch on this stream
    }
  }
  cluster_wait();
}

// Sets the attributes a kernel needs once per device: up to kMaxSmem of
// dynamic shared memory and clusters of up to 16 blocks.
template <typename Kern>
cudaError_t prepare(Kern* kern, int device) {
  static const void* done[64][32];
  static int count[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  for (int i = 0; i < count[device]; ++i)
    if (done[device][i] == reinterpret_cast<const void*>(kern)) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && count[device] < 32)
    done[device][count[device]++] = reinterpret_cast<const void*>(kern);
  return err;
}

template <typename Kern, typename... Args>
cudaError_t cluster_launch(Kern* kern, int device, int cluster, int groups, int B,
                           int threads, int smem, cudaStream_t stream, Args... args) {
  cudaError_t err = prepare(kern, device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, groups, B);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Checks a plan (the host's `in_tiling`) and returns its shared memory in
// *smem, or an error.
cudaError_t check_plan(int B, int HW, int C, int cluster, int groups, int threads, int V,
                       int hold, int elem, int tensors, int device, int* smem,
                       std::initializer_list<const void*> ptrs) {
  if (C < 1 || C > 1024 || B < 1 || B > 65535 || HW < 1 || cluster < 1 ||
      cluster > kMaxCluster || groups < 1 || C % groups != 0 || threads < 1)
    return cudaErrorInvalidValue;
  const int CG = C / groups;
  if ((V != 1 && V * elem != 16) || CG % V != 0 || threads > max_threads(V))
    return cudaErrorInvalidValue;
  const int L = CG / V;
  if (threads % L != 0 || (32 % L == 0 && threads % 32 != 0)) return cudaErrorInvalidValue;
  if (V > 1)
    for (const void* p : ptrs)
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorMisalignedAddress;
  const long long bytes = smem_bytes(HW, cluster, CG, V, threads, elem, tensors, hold);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  *smem = static_cast<int>(bytes);
  return cudaSetDevice(device);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta, void* y,
                       void* mean, void* rstd, int B, int HW, int C, int cluster, int groups,
                       int threads, int V, int hold, float eps, float alpha, int device,
                       cudaStream_t s) {
  int smem = 0;
  cudaError_t err = check_plan(B, HW, C, cluster, groups, threads, V, hold, sizeof(T), 1,
                               device, &smem, {x, y});
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  float* mn = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  const int CG = C / groups;
  constexpr int VW = 16 / sizeof(T);
#define SKYHDR_IN_FWD(VV, H)                                                              \
  cluster_launch(in_fwd_kernel<T, VV, H>, device, cluster, groups, B, threads, smem, s, xt, \
                 g, be, yt, mn, rs, HW, C, CG, eps, alpha)
  if (V == 1) return hold ? SKYHDR_IN_FWD(1, true) : SKYHDR_IN_FWD(1, false);
  return hold ? SKYHDR_IN_FWD(VW, true) : SKYHDR_IN_FWD(VW, false);
#undef SKYHDR_IN_FWD
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* gamma, const void* beta,
                       const void* mean, const void* rstd, void* part, void* counter,
                       void* dgamma, void* dbeta, void* dx, int B, int HW, int C, int cluster,
                       int groups, int threads, int V, int hold, float alpha, int device,
                       cudaStream_t s) {
  int smem = 0;
  cudaError_t err = check_plan(B, HW, C, cluster, groups, threads, V, hold, sizeof(T), 2,
                               device, &smem, {x, dy, dx});
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* mn = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  unsigned* cnt = static_cast<unsigned*>(counter);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  T* dxt = static_cast<T*>(dx);
  const int CG = C / groups;
  constexpr int VW = 16 / sizeof(T);
#define SKYHDR_IN_BWD(VV, H)                                                              \
  cluster_launch(in_bwd_kernel<T, VV, H>, device, cluster, groups, B, threads, smem, s, xt, \
                 dyt, g, be, mn, rs, pt, cnt, dg, db, dxt, B, HW, C, CG, alpha)
  if (V == 1) return hold ? SKYHDR_IN_BWD(1, true) : SKYHDR_IN_BWD(1, false);
  return hold ? SKYHDR_IN_BWD(VW, true) : SKYHDR_IN_BWD(VW, false);
#undef SKYHDR_IN_BWD
}

}  // namespace

extern "C" {

// K8: x [B,HW,C] (bf16 when is_bf16, else f32), gamma/beta [C] f32; out y
// [B,HW,C] in x's type, mean/rstd [B,C] f32. The plan (cluster, groups,
// threads, vec, hold) is `in_tiling`'s; `alpha` is the slope for a
// negative pre-activation, rounded to x's type by the caller (1: none).
int skyhdr_in_fwd_k8(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                     void* rstd, int B, int HW, int C, int cluster, int groups, int threads,
                     int vec, int hold, float eps, float alpha, int is_bf16, int device,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fwd<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, B, HW, C, cluster, groups,
                                     threads, vec, hold, eps, alpha, device, s);
  return launch_fwd<float>(x, gamma, beta, y, mean, rstd, B, HW, C, cluster, groups, threads,
                           vec, hold, eps, alpha, device, s);
}

// K9: x, dy [B,HW,C] of one type (bf16 when is_bf16, else f32), gamma/beta
// [C] f32, mean/rstd [B,C] f32 from K8; scratch part [B,C,2] f32 and
// counter (one uint32, 0 before the first launch on a stream; the kernel
// leaves it 0); out dgamma/dbeta [C] f32 and dx [B,HW,C] in x's type.
int skyhdr_in_bwd_k9(const void* x, const void* dy, const void* gamma, const void* beta,
                     const void* mean, const void* rstd, void* part, void* counter,
                     void* dgamma, void* dbeta, void* dx, int B, int HW, int C, int cluster,
                     int groups, int threads, int vec, int hold, float alpha, int is_bf16,
                     int device, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(x, dy, gamma, beta, mean, rstd, part, counter, dgamma,
                                     dbeta, dx, B, HW, C, cluster, groups, threads, vec, hold,
                                     alpha, device, s);
  return launch_bwd<float>(x, dy, gamma, beta, mean, rstd, part, counter, dgamma, dbeta, dx, B,
                           HW, C, cluster, groups, threads, vec, hold, alpha, device, s);
}

}  // extern "C"
