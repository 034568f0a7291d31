// The optimizer update of skyhdr_torch/train/optim.py as one pass (K13),
// for Hopper (sm_90a), with a plain C interface bound from Python with
// ctypes (skyhdr_torch/ops/kernels/optim.py).
//
// What it replaces: no Pallas kernel. `skyhdr` runs optax's rmsprop / adam
// update (skyhdr/train/engine.py, `_with_param_master(_with_state_dtype(tx))`)
// under `jit`, where XLA fuses it into one loop or a few. The port's eager
// update (`_Optimizer._step_chunk`) is a chain of 10-13 elementwise launches
// a stretch, each reading and writing the whole stretch; this kernel is the
// counterpart of XLA's fusion: one launch a leaf.
//
// What it computes, per element, exactly as the eager chain computes it on
// the card (each product, sum, quotient and root rounded once, as each of
// the chain's launches rounds it; no contraction into fused multiply-adds):
//   term(g)   = (1 - decay) * g**order in the term's type: g's type with
//               float32 parameters, float32 under a float32 master (the
//               chain upcasts g first); in bfloat16 each product is rounded
//               to bfloat16 (the constant is bfloat16 already).
//   m'        = m * decay + term(g)                     (float32)
//   RMSprop:  u = rsqrt(nu' + eps) * g * -lr           (rsqrtf, as ATen's rsqrt)
//   Adam:     u = (mu' * (1/c1)) / (sqrt(nu' * (1/c2)) + eps) * -lr
//               (ATen divides by a host scalar as a product with its float
//               reciprocal, computed on the host; the wrapper hands 1/c in)
//   w        += u; the moments stored in their type (bfloat16: rounded to
//               nearest even); under a master, p = bfloat16(w).
//
// What bounds it on this card: bytes. An element costs ~10 operations
// against 20 (RMSprop) to 28 (Adam) bytes in float32, so the least time is
// the traffic over 3.35 TB/s: each of p (or the master), g and the moments
// read once, and p (and the bfloat16 parameter) and the moments written once.
//
// What the design does about it: every thread walks the leaf in groups of 4
// elements with 16-byte (float32) or 8-byte (bfloat16) loads and stores,
// grid-stride over at most 8 blocks of 256 an SM; one launch a leaf, so the
// traffic is the bound's. A leaf whose pointers are not all 16-byte aligned
// takes one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// A value a bfloat16 tensor holds: v rounded to bfloat16, as a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Four consecutive elements from / to index 4*i (the pointer 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, long long i, float v[4]) {
  const float4 q = reinterpret_cast<const float4*>(p)[i];
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16* p, long long i, float v[4]) {
  const uint2 q = reinterpret_cast<const uint2*>(p)[i];
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a), v[1] = __high2float(a), v[2] = __low2float(b), v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, long long i, const float v[4]) {
  reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, long long i, const float v[4]) {
  const __nv_bfloat162 a = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                              __float2bfloat16_rn(v[1]));
  const __nv_bfloat162 b = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                              __float2bfloat16_rn(v[3]));
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  reinterpret_cast<uint2*>(p)[i] = q;
}

struct Args {
  void* p;         // the parameter: float32, or bfloat16 under a master
  float* w;        // the float32 master (nullptr: the parameter itself)
  const void* g;   // the gradient, float32 or bfloat16
  void* mu;        // Adam's first moment (nullptr for RMSprop)
  void* nu;        // the second moment
  long long n;
  float decay_mu, decay_nu;  // b1 / b2 (RMSprop: decay_nu), rounded to float32
  float term_mu, term_nu;    // 1 - decay rounded to the term's type
  float eps, neg_lr;         // rounded to float32
  float inv_c1, inv_c2;      // float32 reciprocals of Adam's bias corrections
};

// One element's update: w, mu and nu in and out, in float32 before storage.
template <bool ADAM, bool TB>
__device__ __forceinline__ void update(float g, float& w, float& mu, float& nu, const Args& a) {
  const float term_nu = TB ? round_bf16(__fmul_rn(round_bf16(__fmul_rn(g, g)), a.term_nu))
                           : __fmul_rn(__fmul_rn(g, g), a.term_nu);
  nu = __fadd_rn(__fmul_rn(nu, a.decay_nu), term_nu);
  float u;
  if constexpr (ADAM) {
    const float term_mu = TB ? round_bf16(__fmul_rn(g, a.term_mu)) : __fmul_rn(g, a.term_mu);
    mu = __fadd_rn(__fmul_rn(mu, a.decay_mu), term_mu);
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, a.inv_c2)), a.eps);
    u = __fdiv_rn(__fmul_rn(mu, a.inv_c1), den);
  } else {
    u = __fmul_rn(rsqrtf(__fadd_rn(nu, a.eps)), g);
  }
  w = __fadd_rn(w, __fmul_rn(u, a.neg_lr));
}

// G: the gradient's type; MASTER: a float32 master and bfloat16 parameters;
// MU, NU: the moments' types. The term is in bfloat16 when the gradient is
// and there is no master (the chain upcasts g under a master).
template <bool ADAM, typename G, bool MASTER, typename MU, typename NU>
__global__ void __launch_bounds__(kThreads) optim_kernel(Args a, int vec) {
  constexpr bool TB = std::is_same<G, bf16>::value && !MASTER;
  using P = typename std::conditional<MASTER, bf16, float>::type;
  const G* g = static_cast<const G*>(a.g);
  P* p = static_cast<P*>(a.p);
  float* w = MASTER ? a.w : reinterpret_cast<float*>(a.p);
  MU* mu = static_cast<MU*>(a.mu);
  NU* nu = static_cast<NU*>(a.nu);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;  // elements the vector loop covers
  if (vec) {
    const long long n4 = a.n / 4;
    for (long long i = t; i < n4; i += stride) {
      float gv[4], wv[4], mv[4] = {0.f, 0.f, 0.f, 0.f}, nv[4];
      load4(g, i, gv);
      load4(w, i, wv);
      if constexpr (ADAM) load4(mu, i, mv);
      load4(nu, i, nv);
#pragma unroll
      for (int k = 0; k < 4; ++k) update<ADAM, TB>(gv[k], wv[k], mv[k], nv[k], a);
      store4(w, i, wv);
      if constexpr (MASTER) store4(p, i, wv);
      if constexpr (ADAM) store4(mu, i, mv);
      store4(nu, i, nv);
    }
    done = n4 * 4;
  }
  for (long long i = done + t; i < a.n; i += stride) {
    float wi = w[i], mi = ADAM ? to_f(mu[i]) : 0.f, ni = to_f(nu[i]);
    update<ADAM, TB>(to_f(g[i]), wi, mi, ni, a);
    w[i] = wi;
    if constexpr (MASTER) p[i] = from_f<bf16>(wi);
    if constexpr (ADAM) mu[i] = from_f<MU>(mi);
    nu[i] = from_f<NU>(ni);
  }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

template <bool ADAM, typename G, bool MASTER, typename MU, typename NU>
cudaError_t launch(const Args& a, int vec, int device, cudaStream_t s) {
  const long long work = vec ? (a.n + 3) / 4 : a.n;
  const long long most = static_cast<long long>(sm_count(device)) * kBlocksPerSm;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > most) blocks = most;
  optim_kernel<ADAM, G, MASTER, MU, NU><<<static_cast<int>(blocks), kThreads, 0, s>>>(a, vec);
  return cudaGetLastError();
}

template <bool ADAM, typename G, bool MASTER>
cudaError_t pick_moments(const Args& a, int mu_bf16, int nu_bf16, int vec, int device,
                         cudaStream_t s) {
  if (!ADAM || !mu_bf16)
    return nu_bf16 ? launch<ADAM, G, MASTER, float, bf16>(a, vec, device, s)
                   : launch<ADAM, G, MASTER, float, float>(a, vec, device, s);
  return nu_bf16 ? launch<ADAM, G, MASTER, bf16, bf16>(a, vec, device, s)
                 : launch<ADAM, G, MASTER, bf16, float>(a, vec, device, s);
}

template <bool ADAM>
cudaError_t pick(const Args& a, int g_bf16, int master, int mu_bf16, int nu_bf16, int vec,
                 int device, cudaStream_t s) {
  if (g_bf16)
    return master ? pick_moments<ADAM, bf16, true>(a, mu_bf16, nu_bf16, vec, device, s)
                  : pick_moments<ADAM, bf16, false>(a, mu_bf16, nu_bf16, vec, device, s);
  return master ? pick_moments<ADAM, float, true>(a, mu_bf16, nu_bf16, vec, device, s)
                : pick_moments<ADAM, float, false>(a, mu_bf16, nu_bf16, vec, device, s);
}

}  // namespace

extern "C" {

// K13: one leaf's update in place, n elements. adam: 1 (Adam: mu and nu),
// 0 (RMSprop: nu; mu unused). p float32 (w null) or bfloat16 with its
// float32 master w; g, mu, nu float32 or bfloat16 as the flags say; vec: 1
// when every pointer is 16-byte aligned. The constants are rounded by the
// caller as the eager chain rounds them.
int skyhdr_optim_k13(int adam, void* p, void* w, const void* g, void* mu, void* nu,
                     long long n, int g_bf16, int mu_bf16, int nu_bf16, int master, int vec,
                     float decay_mu, float decay_nu, float term_mu, float term_nu, float eps,
                     float neg_lr, float inv_c1, float inv_c2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  const Args a{p, static_cast<float*>(w), g, mu, nu, n, decay_mu, decay_nu, term_mu, term_nu,
               eps, neg_lr, inv_c1, inv_c2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return adam ? pick<true>(a, g_bf16, master, mu_bf16, nu_bf16, vec, device, s)
              : pick<false>(a, g_bf16, master, mu_bf16, nu_bf16, vec, device, s);
}

}  // extern "C"
