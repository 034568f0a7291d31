// The DA-conv probe kernels for Hopper (sm_90a): K10 (the k = 3 DA forward
// in the design variants the probes compare), K11 (sample packing) and K12
// (the dot-shape microbench), with a plain C interface bound from Python
// with ctypes (skyhdr_torch/ops/kernels/probes.py). They serve the probe
// tools under skyhdr_torch/tools/, not the model.
//
// K10 (probe_direct_kernel<T, VEC, FT> for G = kDirect,
//   probe_staged_kernel<T, TAPS, DEDUP, MMA, DIAG, CH> for G = kStaged; one
//   entry point, skyhdr_probe_fwd, picks the instantiation by these
//   choices) replaces the Pallas variants of tools/exp_daconv.py: forward_a
//   (`_kernel_a`), forward_b (`_kernel_b`), forward_c (`_kernel_c`,
//   `_kernel_cs`), forward_prodbf16 (`_kernel_prodbf16`), forward_diag
//   (`_kernel_diag`), forward_pair (`_kernel_pair`), forward_pack (those
//   bodies on P samples packed along the channels, block-diagonal K) and
//   forward_dedup (`_kernel_dedup`).
//   All compute out[b,i,j] = sum_t sample_t[b,i,j] @ K_t (no bias, f32 out),
//     rowY   = (1-wy) xpad[y0] + wy xpad[y1]   (xpad: one zero row above
//                                              and below, in the storage type)
//     sample = (1-wx) rowY[(j+cx) mod W] + wx rowY[(j+cx+1) mod W],
//   or, under DIAG, one stated part of it. The one design choice each
//   instantiation exists to measure:
//     T      storage of x: float, or bf16 (read as f32).
//     G      kDirect (A): the samples never go to shared memory: each lane
//            computes them in registers from reads of x in device memory
//            and feeds them straight to its FMAs; kStaged: the
//            interpolated sample tile is built in shared memory and
//            contracted from there.
//     TAPS   taps of the staged tile: 1 (A, C, prodbf16, dedup), 2 (pair:
//            one product of depth 2C per tap pair), 9 (B, cs: all nine
//            taps' samples of a row block in one [9C, M] tile, one
//            accumulation of depth 9C).
//     DEDUP  one y-interpolation per (row, kernel row) over the columns its
//            three taps read, staged in shared memory; the taps'
//            x-interpolations read it. mblk rows are stacked in the tile's
//            M (rows x columns of one block).
//     MMA    false: f32 FMA on CUDA cores; true: bf16 tensor cores,
//            mma.sync.m16n8k16 (bf16 samples and K in, f32 accumulate), the
//            card's counterpart of a bf16 MXU dot.
//     DIAG   kFull, or a stage isolated as `_kernel_diag` does: kNoRoll
//            (sample = rowY at column j), kNoMM (sum of samples, no
//            product), kMMOnly (xpad[y0] at column j into the product),
//            kMMHoist (xpad[y0 of tap 0] staged once per row, nine
//            products), kLoadOnly (sum of xpad[y0] + xpad[y1]), kLoad1Only
//            (sum of xpad[y0]). The sum modes output the first F channels
//            (C >= F).
//   What bounds it: at the probes' default shape (x 32x64x256x64, F 64) the
//   contraction is 38.65 GFLOP, 0.577 ms at the 67 TFLOP/s f32 CUDA-core
//   peak; in bf16 on tensor cores 0.039 ms, below the 0.060 ms of moving the
//   bf16 x (67 MB) and the f32 output (134 MB).
//   What held the first version (29.9 ms per default run of the tool,
//   7.7% of the bound): the direct variant's lanes held consecutive
//   columns (each float4 of x 4C bytes from the next lane's), read K from
//   device memory and walked the block's rows serially; the staged variants
//   built their tile from scalar loads of x between barriers, in series
//   with the product, read K from device memory at every depth step into
//   a 4x4 register tile, and the nine-tap tile (147 KB) halved the lanes
//   until it fitted; the tensor-core path loaded its fragments with 32-bit
//   shared loads.
//   What this design does (the launch plan is the host's: ops/kernels/
//   probes.py:probe_tiling, passed in as DirectPlan / StagedPlan):
//   * direct: a block is `rows` (rblk) output rows x wpr warps a row, the
//     rows' warps working at once; a warp owns 4 output columns x an F
//     tile of 4 FT channels. Its lanes are 8 along C (each a 16-byte run of
//     VEC channels, so a warp's reads of x are runs along C) x 4 along F.
//     A lane interpolates its channels' samples of its 4 columns in
//     registers and multiplies them by the tap's K slice, which the block
//     stages in shared memory with cp.async a tap ahead (the TPU kernel
//     keeps K in VMEM): each sample feeds FT FMAs, each K value read from
//     shared memory 4. The 8 lanes along C hold partial sums, summed by a
//     butterfly of shuffles at the end.
//   * staged: K1's scaffolding (deform_conv.cu:da_fwd_kernel). A step is
//     (ts taps, cc input channels); per step the raw source rows (tile
//     columns + 1, wrapped; rows outside [0, H) zero) are copied with
//     16-byte cp.async in the storage type, two steps ahead of the
//     product, and K's rows of the step one step ahead. One barrier a
//     step: in the same phase the tile of step s + lead is built from its
//     raw rows (DEDUP: from a y-interpolated window built a step earlier)
//     while step s is contracted, so the build overlaps the product. f32:
//     a transposed tile [depth][M] read as float4 into 8 x CH register
//     tiles (CH = 8 where the F tile is >= 64), ks thread groups splitting
//     each step's depth where a block would be small (their sums added in
//     group order at the end of each row group). cs keeps the nine taps'
//     tile [9C][M] and builds a kernel row (3C) ahead of the contraction;
//     its split sums use the tile slots idle at a row group's end.
//     Tensor cores: a bf16 tile [M][depth + 8] and the tap's K^T slice
//     [fb][depth + 8] (read from the f32 K in device memory and rounded a
//     step ahead), both loaded with ldmatrix.x4 from rows whose stride is
//     an odd multiple of 16 bytes (conflict-free); a warp owns 32 x 32
//     outputs, 8 mma per 4 ldmatrix.
//   Measured on an H100 80GB HBM3 at 700 W (tools/time_torch_probes.py):
//   the default run (a2 + a4 + a8 + b4) 8.52 ms against the first
//   version's 29.9 (27% of its bound); every whole-forward variant faster
//   than the first version's at both probe shapes; prodbf16 0.84x K1.
//   Every call is one launch; f32 sums in a fixed order: bitwise
//   repeatable.
//
// K11 pack_samples_kernel replaces `_pack_kernel` / `pack_pallas`
//   (tools/exp_pack.py): out[i, :, :, s*C:(s+1)*C] = x[i*P + s], a copy
//   [B,H,W,C] -> [B/P,H,W,P*C]. Bound by bytes: 2|x| (268 MB for the probe's
//   32x64x256x64 f32, 0.080 ms at 3.35 TB/s). One thread per 16-byte vector
//   of the output: writes are fully coalesced, reads coalesced within each
//   sample's channel block.
//
// K12 mm_shape_{f32,bf16}_kernel replace the `make_bench` kernel
//   (tools/exp_mmshape.py): `steps` blocks, each computing the whole
//   [m, f] = ndots * (lhs[m,k] @ rhs[k,f]) product ndots times (f32
//   accumulation) and storing it (all blocks store the same values, so no
//   block's work is dead). Bound by operations: 2*m*k*f*ndots*steps
//   (38.65 GFLOP for every configuration of the tool: 0.577 ms f32 on CUDA
//   cores, 0.039 ms bf16 on tensor cores). Every one of the ndots products
//   reads its operands from shared memory, as each `jnp.dot` of the TPU
//   kernel reads its VMEM refs. What held the first version (8.47 ms per
//   default run against 5.38 for one batched matmul; bf16 at 4-5% of its
//   bound): each chunk of the depth was staged synchronously behind two
//   barriers, in series with the products (f32 c3/d2, ndots 2-3, lost to
//   the library), lhs transposed one scalar at a time; and the bf16 mma
//   was fed by six 32-bit shared loads, every fragment loaded again for
//   each 16x8 tile. What this design does: stages of (output tile, 32-deep
//   chunk of the depth), the next (f32) or the next two (bf16, a ring of
//   three) copied with 16-byte cp.async under the current one's products;
//   a block tile of 256 x 64, 128 x 128 or 64 x 256 outputs (the wrapper
//   pads m, k and f to it). f32: 256 threads of 8 x 8, lhs kept row-major
//   and read as float4 along the depth (no transpose). bf16: 8 warps of
//   64 x 32 or 32 x 64 outputs; per 16-deep step a warp loads its A
//   fragments with ldmatrix.x4 and its B fragments (rhs^T, K-contiguous)
//   with ldmatrix.x4 from 80-byte rows (conflict-free), and each A
//   fragment feeds 4-8 mma.sync.m16n8k16, each B fragment 2-4. Every block
//   stages all of lhs and rhs (the TPU kernel's operands stay in VMEM
//   across its grid steps): 377 MB through L2 per run at d2, which holds
//   the long-depth bf16 configurations (c3h, d2h) to ~20-25% of the bound.
//
// Every launch is on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kBlock = 256;
using bf16 = __nv_bfloat16;

// The values skyhdr_probe_fwd takes (probes.py's GATHERS and DIAGS, in order).
enum Gather { kDirect = 0, kStaged = 1 };
enum Diag { kFull = 0, kNoRoll, kNoMM, kMMOnly, kMMHoist, kLoadOnly, kLoad1Only };

constexpr int kMaxRows = 16;  // K10: output rows a block (rblk), at most
constexpr int kLanesC = 8;    // K10 direct: lanes of a warp along C
constexpr int kLanesF = 4;    // K10 direct: lanes of a warp along F
constexpr int kCols = 4;      // K10 direct: output columns a lane
// Dynamic shared memory a K10 block may take: 227 KB less its static tables.
constexpr int kMaxSmem = 232448 - 4096;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// VEC consecutive elements as f32: one 16-byte load (f32 x 4, bf16 x 8) or,
// for bf16 with VEC = 4, one 8-byte load.
template <int VEC>
__device__ __forceinline__ void ldv(const float* p, float (&v)[VEC]) {
  static_assert(VEC == 4, "f32 lanes read 16 bytes");
  const float4 a = ld4(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
template <int VEC>
__device__ __forceinline__ void ldv(const bf16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 a = ld4(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    static_assert(VEC == 8, "bf16 lanes read 8 or 16 bytes");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      __nv_bfloat162 h;
      memcpy(&h, &w[q], sizeof(h));
      const float2 f = __bfloat1622float2(h);
      v[2 * q] = f.x, v[2 * q + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void st_bf16x4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  memcpy(&u.x, &lo, sizeof(lo));
  memcpy(&u.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = u;
}

// 16-byte asynchronous copy global -> shared (L2 only), and its groups; the
// zero-filling form reads nothing when `valid` is false.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory at the 32-bit
// shared address s; lanes 8q..8q+7 give the row addresses of matrix q, and
// r[q] is this lane's part of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr bool is_sum(int diag) {
  return diag == kNoMM || diag == kLoadOnly || diag == kLoad1Only;
}

// One step of a butterfly reduce-scatter over the lanes `mask` apart: the
// lane keeps the lower (up = false) or upper half of its N + N values,
// summed with its partner's; the sums land in a[0..N).
template <int N>
__device__ __forceinline__ void halve(float* a, bool up, int mask) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float send = up ? a[e] : a[e + N];
    const float keep = up ? a[e + N] : a[e];
    a[e] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// ---------------------------------------------------------------- K10 (A)
// The direct plan (ops/kernels/probes.py:DIRECT_FIELDS, in this order).
struct DirectPlan {
  int rows;     // output rows a block (rblk), each `wpr` warps
  int wpr;      // warps per output row, kCols columns each
  int vec;      // channels a lane reads at once (16 bytes; bf16 at C % 64: 8 bytes)
  int fb;       // output channels a block: kLanesF x FT
  int ldg;      // floats per channel group (VEC channels) of the staged K: VEC fb + 16
  int threads;  // 32 rows wpr
  int smem;     // two taps of K: 2 (C / VEC) ldg floats
};

// Grid (column tiles x F tiles, H / rows, B), p.threads threads. x
// [B,H,W,C] (T), kern f32 [9C,F], tables [H,9], out f32 [B,H,W,F]. Warp w
// owns output row i0 + w / wpr and columns j .. j + 3; lane (fs, cs) =
// (lane % 4, lane / 4) the channel groups cs, cs + 8, ... (VEC channels
// each) and the outputs f0 + 4 fs + 16 n + w (n < FT / 4, w < 4). Shared
// memory: K_t [C][fb] for two taps, grouped by VEC channels with a 16-float
// pad between groups (the 8 lanes of an LDS.128 phase hit distinct banks).
template <typename T, int VEC, int FT>
__global__ void __launch_bounds__(512)
probe_direct_kernel(const T* __restrict__ x, const float* __restrict__ kern,
                    const int* __restrict__ y0t, const int* __restrict__ y1t,
                    const int* __restrict__ cxt, const float* __restrict__ wyt,
                    const float* __restrict__ wxt, float* __restrict__ out,
                    int H, int W, int C, int F, DirectPlan p) {
  constexpr int NA = kCols * FT;  // accumulators a lane
  extern __shared__ __align__(16) float ksm[];
  __shared__ int s_r0[kMaxRows][9], s_r1[kMaxRows][9], s_cx[kMaxRows][9];
  __shared__ float s_wy[kMaxRows][9], s_wx[kMaxRows][9];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int fs = lane % kLanesF, cs = lane / kLanesF;
  const int r = warp / p.wpr;
  const int ftiles = F / p.fb;
  const int j = (blockIdx.x / ftiles) * (kCols * p.wpr) + kCols * (warp % p.wpr);
  const int f0 = (blockIdx.x % ftiles) * p.fb;
  const int i0 = blockIdx.y * p.rows;
  const int b = blockIdx.z;
  const size_t row_stride = static_cast<size_t>(W) * C;
  const T* xb = x + static_cast<size_t>(b) * H * row_stride;
  for (int e = tid; e < p.rows * 9; e += nthr) {
    const int rr = e / 9, t = e % 9, q = (i0 + rr) * 9 + t;
    s_r0[rr][t] = y0t[q] - 1;
    s_r1[rr][t] = y1t[q] - 1;
    s_cx[rr][t] = cxt[q];
    s_wy[rr][t] = wyt[q];
    s_wx[rr][t] = wxt[q];
  }
  const int groups = C / VEC;
  const int tap_floats = groups * p.ldg;
  const int vpr = p.fb / 4;  // 16-byte vectors of a K row's F tile
  auto load_k = [&](int t) {
    float* dst = ksm + (t & 1) * tap_floats;
    const float* src = kern + static_cast<size_t>(t) * C * F + f0;
    for (int e = tid; e < C * vpr; e += nthr) {
      const int c = e / vpr, v = e - c * vpr;
      cp_async16(dst + (c / VEC) * p.ldg + (c % VEC) * p.fb + 4 * v,
                 src + static_cast<size_t>(c) * F + 4 * v);
    }
    cp_async_commit();
  };

  float acc[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = 0.f;
  load_k(0);
  for (int t = 0; t < 9; ++t) {
    cp_async_wait_all();
    __syncthreads();  // K_t landed (and the tables); K_{t-1} is no longer read
    if (t + 1 < 9) load_k(t + 1);
    const int r0 = s_r0[r][t], r1 = s_r1[r][t];
    const float wy = s_wy[r][t], wx = s_wx[r][t];
    const bool in0 = r0 >= 0 && r0 < H, in1 = r1 >= 0 && r1 < H;
    const float w0 = in0 ? 1.f - wy : 0.f, w1 = in1 ? wy : 0.f;  // rows outside read zero
    const T* row0 = xb + static_cast<size_t>(in0 ? r0 : 0) * row_stride;
    const T* row1 = xb + static_cast<size_t>(in1 ? r1 : 0) * row_stride;
    int col[kCols + 1];
    col[0] = j + s_cx[r][t];
    while (col[0] >= W) col[0] -= W;
#pragma unroll
    for (int u = 1; u <= kCols; ++u) col[u] = col[u - 1] + 1 == W ? 0 : col[u - 1] + 1;
    const float* kt = ksm + (t & 1) * tap_floats + 4 * fs;
    for (int k = cs; k < groups; k += kLanesC) {
      const int c = k * VEC;
      float g[kCols + 1][VEC];  // rowY at the kCols + 1 source columns
#pragma unroll
      for (int u = 0; u <= kCols; ++u) {
        float a0[VEC], a1[VEC];
        ldv<VEC>(row0 + static_cast<size_t>(col[u]) * C + c, a0);
        ldv<VEC>(row1 + static_cast<size_t>(col[u]) * C + c, a1);
#pragma unroll
        for (int v = 0; v < VEC; ++v) g[u][v] = w0 * a0[v] + w1 * a1[v];
      }
      const float* kr = kt + k * p.ldg;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float s[kCols];
#pragma unroll
        for (int m = 0; m < kCols; ++m) s[m] = (1.f - wx) * g[m][v] + wx * g[m + 1][v];
#pragma unroll
        for (int n = 0; n < FT / 4; ++n) {
          const float4 kv = ld4(kr + v * p.fb + 4 * kLanesF * n);
#pragma unroll
          for (int m = 0; m < kCols; ++m) {
            float* a = acc + m * FT + 4 * n;
            a[0] = fmaf(s[m], kv.x, a[0]);
            a[1] = fmaf(s[m], kv.y, a[1]);
            a[2] = fmaf(s[m], kv.z, a[2]);
            a[3] = fmaf(s[m], kv.w, a[3]);
          }
        }
      }
    }
  }

  // Sum over the kLanesC lanes along C (lane bits 2-4): a butterfly
  // reduce-scatter leaves each lane NA / 8 of the sums, flat indices
  // base + e of acc[m * FT + 4 n + w]: m = 2 cs0 + cs1, n = cs2 FT / 8 + e / 4.
  halve<NA / 2>(acc, cs & 1, kLanesF);
  halve<NA / 4>(acc, (cs >> 1) & 1, 2 * kLanesF);
  halve<NA / 8>(acc, (cs >> 2) & 1, 4 * kLanesF);
  const int m = 2 * (cs & 1) + ((cs >> 1) & 1);
  const int n0 = ((cs >> 2) & 1) * (FT / 8);
  if (j + m < W) {
    float* o = out + ((static_cast<size_t>(b) * H + i0 + r) * W + j + m) * F + f0 + 4 * fs;
#pragma unroll
    for (int q = 0; q < FT / 8; ++q)
      *reinterpret_cast<float4*>(o + 4 * kLanesF * (n0 + q)) =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
}

// ------------------------------------------------------- K10 (staged)
// The staged plan (ops/kernels/probes.py:STAGED_FIELDS, in this order).
// Byte sizes and offsets into the dynamic shared memory; the tile ring
// starts at 0, then the raw ring, the window ring (DEDUP), the K ring and
// the split sums (cs: in the tile ring's slots 3 C / cc + 1 .., which no
// step reads or writes from a row group's last phase to the next one's).
struct StagedPlan {
  int g;       // output rows stacked in the tile: mblk for DEDUP, else 1
  int tw;      // columns of a tile row; M = g tw tile rows (row m / tw, column j0 + m % tw)
  int fb;      // output channels a block (F tile)
  int cc;      // input channels a step
  int ts;      // taps a step: 1; 2 (pair); 3 (DEDUP: a kernel row)
  int lead;    // steps the tile is built ahead of its product: 1; cs: a kernel row (3 C / cc)
  int nslot;   // tile slots of ts cc depth rows: 2; cs: 9 C / cc (the nine taps); mmhoist: 2 C / cc
  int wn;      // raw columns a (tap, row): tw + 1; tw at column j (diag); DEDUP: tw + span + 1
  int nrow;    // source rows copied a (tap, row): 2, or 1 (mmonly, mmhoist, load1only)
  int ks;      // FMA: thread groups splitting each step's depth
  int ch;      // FMA: output channels of a thread's register tile (x 8 columns): 4 or 8
  int ld;      // tile stride: FMA floats a depth row (M + 4); MMA bf16 a tile row (ts cc + 8)
  int ldk;     // K stride: FMA floats a depth row (fb); MMA bf16 an output channel (ts cc + 8)
  int threads;
  int smem;
  int off_raw, off_ywin, off_k, off_red;
  int raw_slot, ywin_slot, tile_slot, k_slot;
};

// Grid (column tiles x F tiles, H / rblk, B), p.threads threads. x
// [B,H,W,C] (T), kern f32 [9C,F], tables [H,9], out f32 [B,H,W,F]. The
// block's rblk rows go in row groups of g; a row group is 9 / ts tap groups
// x C / cc chunks of steps. Phase s (one barrier): copy the raw rows of
// step s + lead + 1 (+1 under DEDUP) and K of step s + 1 (MMA: read K of
// step s + 1 and store it as bf16 K^T); DEDUP: y-interpolate the window of
// step s + 2; build the tile of step s + lead; contract step s. A row
// group's outputs are stored in the phase after its last step. The copy
// and build loops walk (tap, row) alike in every thread and split only the
// columns x channels (powers of two: shifts and masks, no division).
// FMA threads: (split sp, tile tm, channel tile tf), tf fastest; a thread
// owns tile rows 8 tm .. 8 tm + 7 x channels f0 + CH tf .. + CH - 1. MMA:
// warps (wm, wn), wm fastest, each tile rows 32 wm .. x channels 32 wn ..
template <typename T, int TAPS, bool DEDUP, bool MMA, int DIAG, int CH>
__global__ void __launch_bounds__(kBlock, 2)
probe_staged_kernel(const T* __restrict__ x, const float* __restrict__ kern,
                    const int* __restrict__ y0t, const int* __restrict__ y1t,
                    const int* __restrict__ cxt, const float* __restrict__ wyt,
                    const float* __restrict__ wxt, float* __restrict__ out,
                    int H, int W, int C, int F, int rblk, StagedPlan p) {
  static_assert(!(MMA && (TAPS != 1 || DEDUP || DIAG == kMMHoist || is_sum(DIAG))),
                "the tensor-core path contracts one tap a step");
  constexpr bool kSum = is_sum(DIAG);
  constexpr bool kAtJ = DIAG != kFull && DIAG != kNoMM;  // samples at column j, no shift
  constexpr int kY = DEDUP ? 1 : 0;                      // the window stage
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_r0[kMaxRows][9], s_r1[kMaxRows][9], s_cx[kMaxRows][9], s_off[kMaxRows][9];
  __shared__ int s_start[kMaxRows][3];
  __shared__ float s_wy[kMaxRows][9], s_wx[kMaxRows][9];

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int g = p.g, tw = p.tw, M = g * tw, fb = p.fb, cc = p.cc, ts = p.ts;
  const int ftiles = F / fb;
  const int j0 = (blockIdx.x / ftiles) * tw;
  const int f0 = (blockIdx.x % ftiles) * fb;
  const int i0 = blockIdx.y * rblk;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * H * W * C;
  const int nch = C / cc;
  const int spg = (9 + ts - 1) / ts * nch;  // steps a row group
  const int S = rblk / g * spg;

  for (int e = tid; e < rblk * 9; e += nthr) {
    const int r = e / 9, t = e % 9;
    const int q = (i0 + r) * 9 + t;
    const int qy = DEDUP ? q - t % 3 : q;  // DEDUP: the kernel row's first tap's rows
    s_r0[r][t] = y0t[qy] - 1;
    s_r1[r][t] = y1t[qy] - 1;
    s_wy[r][t] = wyt[qy];
    s_cx[r][t] = cxt[q];
    s_wx[r][t] = wxt[q];
  }
  if (DEDUP) {
    __syncthreads();
    for (int e = tid; e < rblk * 3; e += nthr) {  // each kernel row's window start and offsets
      const int r = e / 3, ky = e % 3;
      const int c0 = s_cx[r][3 * ky];
      int rel[3], lo = 0;
      for (int kx = 0; kx < 3; ++kx) {
        int d = s_cx[r][3 * ky + kx] - c0;
        if (d < 0) d += W;
        if (d > W / 2) d -= W;
        rel[kx] = d;
        lo = d < lo ? d : lo;
      }
      for (int kx = 0; kx < 3; ++kx) s_off[r][3 * ky + kx] = rel[kx] - lo;
      const int st = (j0 + c0 + lo) % W;
      s_start[r][ky] = st < 0 ? st + W : st;
    }
  }

  struct Step {
    int gi, tg, c0, t0, ntap;
  };
  auto step = [&](int s) {
    Step st;
    st.gi = s / spg;
    const int rem = s - st.gi * spg;
    st.tg = rem / nch;
    st.c0 = (rem - st.tg * nch) * cc;
    st.t0 = st.tg * ts;
    st.ntap = 9 - st.t0 < ts ? 9 - st.t0 : ts;
    return st;
  };
  auto slot_of = [&](const Step& st, int s) {
    return DIAG == kMMHoist ? (st.gi & 1) * nch + st.c0 / cc : s % p.nslot;
  };

  T* raw = reinterpret_cast<T*>(smem + p.off_raw);
  float* ywin = reinterpret_cast<float*>(smem + p.off_ywin);
  float* kf = reinterpret_cast<float*>(smem + p.off_k);
  float* red = reinterpret_cast<float*>(smem + p.off_red);
  const int raw_elems = p.raw_slot / static_cast<int>(sizeof(T));
  const int ywin_floats = p.ywin_slot / 4;
  const int kf_floats = p.k_slot / 4;

  // The raw source rows of step s: [taps][g rows][nrow][wn columns][cc], T.
  auto copy_raw = [&](int s) {
    const Step st = step(s);
    if (DIAG == kMMHoist && st.tg != 0) return;
    constexpr int kEpv = 16 / static_cast<int>(sizeof(T));
    const int lv = __ffs(cc / kEpv) - 1;  // log2 of a column's 16-byte vectors
    const int n = p.wn << lv;
    const int nk = (DEDUP ? 1 : st.ntap) * g * p.nrow;
    for (int k = 0; k < nk; ++k) {  // (tap, row, source row): the same for every thread
      const int y = k % p.nrow, r = k / p.nrow % g, tt = k / p.nrow / g;
      const int ri = st.gi * g + r;
      const int t = DEDUP ? 3 * st.tg : st.t0 + tt;
      const int row = y ? s_r1[ri][t] : s_r0[ri][t];
      const bool in = row >= 0 && row < H;
      const int start = DEDUP ? s_start[ri][st.tg] : kAtJ ? j0 : j0 + s_cx[ri][t];
      const T* src = xb + static_cast<size_t>(in ? row : 0) * W * C + st.c0;
      T* dst = raw + (s & 1) * raw_elems + static_cast<size_t>(k) * p.wn * cc;
      for (int e = tid; e < n; e += nthr) {
        const int col_i = e >> lv, v = (e & ((1 << lv) - 1)) * kEpv;
        int col = start + col_i;
        while (col >= W) col -= W;
        cp_async16_zfill(dst + col_i * cc + v, src + static_cast<size_t>(col) * C + v, in);
      }
    }
  };
  // FMA: K's rows of step s, f32 [ntap cc][fb] (fb a power of two).
  auto copy_k = [&](int s) {
    const Step st = step(s);
    const int lv = __ffs(fb / 4) - 1;
    const int n = cc << lv;
    for (int tt = 0; tt < st.ntap; ++tt) {
      float* dst = kf + (s & 1) * kf_floats + tt * cc * fb;
      const float* src = kern + (static_cast<size_t>(st.t0 + tt) * C + st.c0) * F + f0;
      for (int e = tid; e < n; e += nthr) {
        const int q = e >> lv, v = 4 * (e & ((1 << lv) - 1));
        cp_async16(dst + q * fb + v, src + static_cast<size_t>(q) * F + v);
      }
    }
  };
  // DEDUP: the window of step s, y-interpolated once: f32 [g][wn][cc].
  auto build_ywin = [&](int s) {
    const Step st = step(s);
    const int n = p.wn * cc;
    for (int r = 0; r < g; ++r) {
      const T* a = raw + (s & 1) * raw_elems + static_cast<size_t>(2 * r) * n;
      float* dst = ywin + (s & 1) * ywin_floats + r * n;
      const float wy = s_wy[st.gi * g + r][3 * st.tg];
      for (int e = tid; e < n; e += nthr)
        dst[e] = (1.f - wy) * to_f(a[e]) + wy * to_f(a[n + e]);
    }
  };
  // The f32 tile of step s: [ntap cc][ld] (depth row tt cc + c, tile row
  // m), four tile rows a thread: 4 samples from 5 raw columns.
  float* tile = reinterpret_cast<float*>(smem);
  const int tile_floats = p.tile_slot / 4;
  auto build_fma = [&](int s) {
    const Step st = step(s);
    float* dst = tile + slot_of(st, s) * tile_floats;
    const T* src = raw + (s & 1) * raw_elems;
    const float* yw = ywin + (s & 1) * ywin_floats;
    const int lc = __ffs(cc) - 1;
    const int n = (tw / 4) << lc;
    for (int k = 0; k < st.ntap * g; ++k) {  // (tap, row): the same for every thread
      const int r = k % g, tt = k / g;
      const int ri = st.gi * g + r;
      const int t = st.t0 + tt;
      const float wy = s_wy[ri][t], wx = s_wx[ri][t];
      const float* yk = yw + (static_cast<size_t>(r) * p.wn + (DEDUP ? s_off[ri][t] : 0)) * cc;
      const T* sk = src + static_cast<size_t>(k * p.nrow) * p.wn * cc;
      float* dk = dst + static_cast<size_t>(tt * cc) * p.ld + r * tw;
      for (int e = tid; e < n; e += nthr) {
        const int c = e & (cc - 1);
        const int pc = 4 * (e >> lc);
        float v[4];
        if (DEDUP) {
          const float* y = yk + pc * cc + c;
          float a[5];
#pragma unroll
          for (int u = 0; u < 5; ++u) a[u] = y[u * cc];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = (1.f - wx) * a[u] + wx * a[u + 1];
        } else {
          const T* a0 = sk + pc * cc + c;
          const T* a1 = a0 + static_cast<size_t>(p.wn) * cc;
          if (DIAG == kFull || DIAG == kNoMM) {
            float gy[5];
#pragma unroll
            for (int u = 0; u < 5; ++u) gy[u] = (1.f - wy) * to_f(a0[u * cc]) + wy * to_f(a1[u * cc]);
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = (1.f - wx) * gy[u] + wx * gy[u + 1];
          } else if (DIAG == kNoRoll) {
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = (1.f - wy) * to_f(a0[u * cc]) + wy * to_f(a1[u * cc]);
          } else if (DIAG == kLoadOnly) {
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = to_f(a0[u * cc]) + to_f(a1[u * cc]);
          } else {  // kMMOnly, kMMHoist, kLoad1Only: xpad[y0] at column j
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = to_f(a0[u * cc]);
          }
        }
        *reinterpret_cast<float4*>(dk + static_cast<size_t>(c) * p.ld + pc) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  // The bf16 tile of step s (MMA, one tap): [M][ld] (tile row m, depth c),
  // four channels a thread, rounded to bf16 as the plain version rounds.
  bf16* tileb = reinterpret_cast<bf16*>(smem);
  const int tile_elems = p.tile_slot / 2;
  auto build_mma = [&](int s) {
    const Step st = step(s);
    bf16* dst = tileb + slot_of(st, s) * tile_elems;
    const T* src = raw + (s & 1) * raw_elems;
    const int lq = __ffs(cc / 4) - 1;
    const int n = tw << lq;  // g = 1: one row
    const int ri = st.gi;
    const float wy = s_wy[ri][st.t0], wx = s_wx[ri][st.t0];
    for (int e = tid; e < n; e += nthr) {
      const int c = 4 * (e & ((1 << lq) - 1)), jj = e >> lq;
      const T* a0 = src + static_cast<size_t>(jj) * cc + c;
      float4 v;
      if (DIAG == kMMOnly) {
        v = ld4(a0);
      } else {
        const T* a1 = a0 + static_cast<size_t>(p.wn) * cc;
        const float4 p00 = ld4(a0), p01 = ld4(a0 + cc), p10 = ld4(a1), p11 = ld4(a1 + cc);
        auto smp = [&](float q00, float q01, float q10, float q11) {
          return (1.f - wx) * ((1.f - wy) * q00 + wy * q10) + wx * ((1.f - wy) * q01 + wy * q11);
        };
        v = make_float4(smp(p00.x, p01.x, p10.x, p11.x), smp(p00.y, p01.y, p10.y, p11.y),
                        smp(p00.z, p01.z, p10.z, p11.z), smp(p00.w, p01.w, p10.w, p11.w));
      }
      st_bf16x4(dst + static_cast<size_t>(jj) * p.ld + c, v);
    }
  };
  // MMA: K's rows of step s (f32, from device memory, where the tap's
  // slice stays in L2) -> bf16 K^T [fb][ldk], two depth rows a thread.
  // (Batching a thread's loads ahead of its stores measured slower.)
  bf16* ktb = reinterpret_cast<bf16*>(smem + p.off_k);
  const int kt_elems = p.k_slot / 2;
  auto convert_k = [&](int s) {
    const Step st = step(s);
    const float* src = kern + (static_cast<size_t>(st.t0) * C + st.c0) * F + f0;
    bf16* dst = ktb + (s & 1) * kt_elems;
    const int n = cc / 2 * fb;
    const int lf = __ffs(fb) - 1;  // fb a power of two
    for (int e = tid; e < n; e += nthr) {
      const int nn = e & (fb - 1), q = 2 * (e >> lf);
      *reinterpret_cast<__nv_bfloat162*>(dst + nn * p.ldk + q) = __floats2bfloat162_rn(
          src[static_cast<size_t>(q) * F + nn], src[static_cast<size_t>(q + 1) * F + nn]);
    }
  };

  // FMA thread layout and its register tile.
  const int TF = fb / CH;
  const int tpg = M / 8 * TF;  // threads of one split
  const int sp = tid / tpg;
  const int tf = (tid - sp * tpg) % TF, tm = (tid - sp * tpg) / TF;
  float acc[8][CH];
  auto product_fma = [&](int s) {
    const Step st = step(s);
    const float* tp = tile + slot_of(st, s) * tile_floats + 8 * tm;
    if (kSum) {  // output channel f takes input channel f
      const int fa = f0 + CH * tf - st.c0;
      if (fa < 0 || fa >= cc) return;
      for (int tt = 0; tt < st.ntap; ++tt)
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          const float* row = tp + static_cast<size_t>(tt * cc + fa + n) * p.ld;
          const float4 lo = ld4(row), hi = ld4(row + 4);
          acc[0][n] += lo.x, acc[1][n] += lo.y, acc[2][n] += lo.z, acc[3][n] += lo.w;
          acc[4][n] += hi.x, acc[5][n] += hi.y, acc[6][n] += hi.z, acc[7][n] += hi.w;
        }
      return;
    }
    const float* kp = kf + (s & 1) * kf_floats + CH * tf;
    const int d = st.ntap * cc / p.ks;
    const int q0 = sp * d;
#pragma unroll 4
    for (int q = q0; q < q0 + d; ++q) {
      const float4 s0 = ld4(tp + q * p.ld), s1 = ld4(tp + q * p.ld + 4);
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float kv[CH];
#pragma unroll
      for (int n = 0; n < CH; n += 4) {
        const float4 v = ld4(kp + q * fb + n);
        kv[n] = v.x, kv[n + 1] = v.y, kv[n + 2] = v.z, kv[n + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < CH; ++n) acc[m][n] = fmaf(sv[m], kv[n], acc[m][n]);
    }
  };
  // Splits 1.. hand their sums to split 0 (after a row group's last step).
  auto spill_fma = [&]() {
    float* rp = red + (static_cast<size_t>(sp - 1) * M + 8 * tm) * fb + CH * tf;
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < CH; n += 4)
        *reinterpret_cast<float4*>(rp + m * fb + n) =
            make_float4(acc[m][n], acc[m][n + 1], acc[m][n + 2], acc[m][n + 3]);
  };
  auto finish_fma = [&](int gi) {
    if (sp != 0) return;
    for (int k = 1; k < p.ks; ++k) {  // in split order: bitwise repeatable
      const float* rp = red + (static_cast<size_t>(k - 1) * M + 8 * tm) * fb + CH * tf;
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < CH; n += 4) {
          const float4 v = ld4(rp + m * fb + n);
          acc[m][n] += v.x, acc[m][n + 1] += v.y, acc[m][n + 2] += v.z, acc[m][n + 3] += v.w;
        }
    }
    const int r = 8 * tm / tw, jj = 8 * tm - r * tw;  // tw % 8 == 0: one row
    float* o = out + ((static_cast<size_t>(b) * H + i0 + gi * g + r) * W + j0 + jj) * F + f0 +
               CH * tf;
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (j0 + jj + m < W)
#pragma unroll
        for (int n = 0; n < CH; n += 4)
          *reinterpret_cast<float4*>(o + static_cast<size_t>(m) * F + n) =
              make_float4(acc[m][n], acc[m][n + 1], acc[m][n + 2], acc[m][n + 3]);
  };

  // MMA warp layout: per 16-deep step two A fragments (tile rows) and two
  // B fragment pairs (K^T rows) by ldmatrix.x4, 2 x 4 mma.
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = MMA ? warp % (M / 32) : 0, wn = MMA ? warp / (M / 32) : 0;
  float macc[2][4][4];
  const unsigned tile_s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned kt_s = static_cast<unsigned>(__cvta_generic_to_shared(ktb));
  const int a_off = (wm * 32 + (lane & 15)) * p.ld + (lane >> 4) * 8;
  const int b_off = (wn * 32 + (lane & 7) + (lane >> 4) * 8) * p.ldk + ((lane >> 3) & 1) * 8;
  auto product_mma = [&](int s) {
    const Step st = step(s);
    const unsigned pa = tile_s + 2 * (slot_of(st, s) * tile_elems + a_off);
    const unsigned pb = kt_s + 2 * ((s & 1) * kt_elems + b_off);
    for (int k0 = 0; k0 < cc; k0 += 16) {
      uint32_t a[2][4], bq[2][4];
      ldmatrix_x4(a[0], pa + 2 * k0);
      ldmatrix_x4(a[1], pa + 2 * (16 * p.ld + k0));
      ldmatrix_x4(bq[0], pb + 2 * k0);
      ldmatrix_x4(bq[1], pb + 2 * (16 * p.ldk + k0));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16(macc[i][n], a[i], bq[n / 2][2 * (n & 1)], bq[n / 2][2 * (n & 1) + 1]);
    }
  };
  auto finish_mma = [&](int gi) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * 32 + 16 * i + (lane >> 2) + 8 * h;
        const int r = m / tw, j = j0 + m - r * tw;
        if (j >= W) continue;
        float* o = out + ((static_cast<size_t>(b) * H + i0 + gi * g + r) * W + j) * F + f0 +
                   wn * 32 + 2 * (lane & 3);
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<float2*>(o + 8 * n) = make_float2(macc[i][n][2 * h], macc[i][n][2 * h + 1]);
      }
  };

  const int lead = p.lead;
  for (int s = -(lead + 1 + kY); s <= S; ++s) {
    cp_async_wait_all();
    __syncthreads();  // this phase's copies landed; the last phase's reads are done
    if (s >= 1 && s % spg == 0) {
      if (MMA) finish_mma(s / spg - 1);
      else finish_fma(s / spg - 1);
    }
    const int sr = s + lead + 1 + kY;
    if (sr >= 0 && sr < S) copy_raw(sr);
    if (!kSum && !MMA && s + 1 >= 0 && s + 1 < S) copy_k(s + 1);
    cp_async_commit();
    if (MMA && s + 1 >= 0 && s + 1 < S) convert_k(s + 1);
    if (DEDUP && s + 2 >= 0 && s + 2 < S) build_ywin(s + 2);
    const int sb = s + lead;
    if (sb >= 0 && sb < S && (DIAG != kMMHoist || step(sb).tg == 0)) {
      if (MMA) build_mma(sb);
      else build_fma(sb);
    }
    if (s < 0 || s >= S) continue;
    if (s % spg == 0) {
      if (MMA) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) macc[i][n][q] = 0.f;
      } else {
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int n = 0; n < CH; ++n) acc[m][n] = 0.f;
      }
    }
    if (MMA) {
      product_mma(s);
    } else {
      product_fma(s);
      if (p.ks > 1 && sp > 0 && s % spg == spg - 1) spill_fma();
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launches `kernel` (grid, plan's threads and smem), or with `resident`
// set only counts the blocks an SM holds (the occupancy API).
template <typename K, typename... Args>
int launch_or_count(K kernel, dim3 grid, int threads, int smem, cudaStream_t s, int* resident,
                    Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (resident) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel, threads, smem);
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename P>
bool read_plan(const int* plan, int n, P* p) {
  if (n * static_cast<int>(sizeof(int)) != static_cast<int>(sizeof(P))) return false;
  memcpy(p, plan, sizeof(P));
  return true;
}

template <typename T>
int launch_direct(const void* x, const void* kern, const void* const* tab, void* out, int B,
                  int H, int W, int C, int F, int rblk, const int* plan, int nplan,
                  cudaStream_t s, int* resident) {
  DirectPlan p;
  if (!read_plan(plan, nplan, &p) || p.rows != rblk || rblk < 1 || rblk > kMaxRows ||
      H % rblk != 0 || p.wpr < 1 || p.threads != 32 * p.rows * p.wpr || p.threads > 512 ||
      (p.vec != 4 && p.vec != 16 / static_cast<int>(sizeof(T))) || C % (kLanesC * p.vec) != 0 ||
      (p.fb != 32 && p.fb != 64) || F % p.fb != 0 || p.ldg != p.vec * p.fb + 16 ||
      p.smem != 8 * (C / p.vec) * p.ldg || p.smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const dim3 grid((W + kCols * p.wpr - 1) / (kCols * p.wpr) * (F / p.fb), H / p.rows, B);
  auto run = [&](auto kernel) {
    return launch_or_count(kernel, grid, p.threads, p.smem, s, resident, static_cast<const T*>(x),
                           static_cast<const float*>(kern), static_cast<const int*>(tab[0]),
                           static_cast<const int*>(tab[1]), static_cast<const int*>(tab[2]),
                           static_cast<const float*>(tab[3]), static_cast<const float*>(tab[4]),
                           static_cast<float*>(out), H, W, C, F, p);
  };
  constexpr int kVec = 16 / sizeof(T);
  if (p.vec == kVec)
    return p.fb == 64 ? run(probe_direct_kernel<T, kVec, 16>) : run(probe_direct_kernel<T, kVec, 8>);
  return p.fb == 64 ? run(probe_direct_kernel<T, 4, 16>) : run(probe_direct_kernel<T, 4, 8>);
}

template <typename T, int TAPS, bool DEDUP, bool MMA, int DIAG>
int launch_staged(const void* x, const void* kern, const void* const* tab, void* out, int B,
                  int H, int W, int C, int F, int rblk, const int* plan, int nplan,
                  cudaStream_t s, int* resident) {
  StagedPlan p;
  if (!read_plan(plan, nplan, &p) || rblk < 1 || rblk > kMaxRows || H % rblk != 0 || p.g < 1 ||
      rblk % p.g != 0 || (!DEDUP && p.g != 1) || p.tw < 8 || p.tw % 8 != 0 || p.fb < 1 ||
      F % p.fb != 0 || p.cc < 1 || C % p.cc != 0 || p.ts != (DEDUP ? 3 : TAPS == 2 ? 2 : 1) ||
      p.lead < 1 || p.nslot < p.lead + 1 || p.ks < 1 || p.threads < 32 || p.threads > kBlock ||
      p.smem > kMaxSmem || (p.cc * static_cast<int>(sizeof(T))) % 16 != 0)
    return cudaErrorInvalidValue;
  const int M = p.g * p.tw;
  if (MMA ? (M % 32 != 0 || p.fb % 32 != 0 || (p.fb & (p.fb - 1)) != 0 || p.cc % 16 != 0 ||
             p.threads != M * p.fb / 32)
          : (p.ch != 4 && p.ch != 8) || p.fb % p.ch != 0 || p.cc % p.ks != 0 ||
                p.threads != M / 8 * (p.fb / p.ch) * p.ks || (is_sum(DIAG) && (C < F || p.ks != 1)))
    return cudaErrorInvalidValue;
  const dim3 grid((W + p.tw - 1) / p.tw * (F / p.fb), H / rblk, B);
  auto run = [&](auto kernel) {
    return launch_or_count(kernel, grid, p.threads, p.smem, s, resident, static_cast<const T*>(x),
                           static_cast<const float*>(kern), static_cast<const int*>(tab[0]),
                           static_cast<const int*>(tab[1]), static_cast<const int*>(tab[2]),
                           static_cast<const float*>(tab[3]), static_cast<const float*>(tab[4]),
                           static_cast<float*>(out), H, W, C, F, rblk, p);
  };
  if (MMA || p.ch == 8) return run(probe_staged_kernel<T, TAPS, DEDUP, MMA, DIAG, 8>);
  return run(probe_staged_kernel<T, TAPS, DEDUP, MMA, DIAG, 4>);
}

// ------------------------------------------------------------------ K11
// Grid-stride over the output's 16-byte vectors; vpc vectors per sample's
// channel block (C * elem_bytes / 16).
__global__ void pack_samples_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                                    size_t n, int vpc, int P, size_t hw) {
  for (size_t v = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < n;
       v += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t pix = v / (static_cast<size_t>(vpc) * P);
    const int within = static_cast<int>(v - pix * vpc * P);
    const int s = within / vpc;
    const int cv = within - s * vpc;
    const size_t i = pix / hw;
    const size_t p = pix - i * hw;
    out[v] = x[((i * P + s) * hw + p) * vpc + cv];
  }
}

// ------------------------------------------------------------------ K12
constexpr int kMmChunkF32 = 32;   // f32: depth staged per stage
constexpr int kMmStagesF32 = 2;   // f32: stages in the ring (1 in flight)
constexpr int kMmChunkBf16 = 32;  // bf16: depth staged per stage
constexpr int kMmStagesBf16 = 3;  // bf16: stages in the ring (2 in flight)
constexpr int kMmLdB = kMmChunkBf16 + 8;  // bf16 chunk row stride: 80 bytes

// K12 f32: a block tile of BM x (16384 / BM) outputs, 256 threads of 8 x 8.
// Grid (steps), 256 threads; dynamic smem 2 stages of lhs [BM][36] and rhs
// [32][BF] f32. lhs [m,k], rhs [k,f], out [m,f]; m a multiple of BM, f of
// BF, k of 32. Stages are (output tile, 32-deep chunk); the next stage is
// copied with 16-byte cp.async under the current one's ndots products.
// lhs keeps its row-major layout: a thread's 8 rows are tm + r BM/8, read
// as float4 along the depth (4 depth steps of 64 FMAs each per 8 + 8
// float4 loads); the rows of a warp are consecutive, so with the 36-float
// stride the loads are conflict-free.
template <int BM>
__global__ void __launch_bounds__(kBlock, 2)
mm_shape_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
                    float* __restrict__ out, int m, int k, int f, int ndots) {
  constexpr int BF = 16384 / BM;
  constexpr int TF = BF / 8;                   // threads along f
  constexpr int RS = BM / 8;                   // stride of a thread's rows
  constexpr int ldl = kMmChunkF32 + 4;
  constexpr int stage_floats = BM * ldl + kMmChunkF32 * BF;
  extern __shared__ __align__(16) float mm_smem[];
  const int tid = threadIdx.x;
  const int tf = tid % TF;
  const int tm = tid / TF;
  const int ftiles = f / BF;
  const int chunks = k / kMmChunkF32;
  const int stages = (m / BM) * ftiles * chunks;

  auto load = [&](int st, int buf) {
    const int tile = st / chunks;
    const int k0 = (st % chunks) * kMmChunkF32;
    const int m0 = tile / ftiles * BM;
    const int f0 = tile % ftiles * BF;
    float* ls = mm_smem + buf * stage_floats;
    float* rs = ls + BM * ldl;
    for (int e = tid; e < BM * kMmChunkF32 / 4; e += kBlock) {
      const int row = e / (kMmChunkF32 / 4), v = e % (kMmChunkF32 / 4);
      cp_async16(ls + row * ldl + 4 * v, lhs + static_cast<size_t>(m0 + row) * k + k0 + 4 * v);
    }
    for (int e = tid; e < kMmChunkF32 * BF / 4; e += kBlock) {
      const int kk = e / (BF / 4), v = e % (BF / 4);
      cp_async16(rs + kk * BF + 4 * v, rhs + static_cast<size_t>(k0 + kk) * f + f0 + 4 * v);
    }
    cp_async_commit();
  };

  float acc[8][8];
  for (int q = 0; q < kMmStagesF32 - 1; ++q) {
    if (q < stages) load(q, q);
    else cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    const int buf = st % kMmStagesF32;
    const int chunk = st % chunks;
    cp_async_wait<kMmStagesF32 - 2>();
    __syncthreads();  // stage st landed; stage st - 1 is no longer read
    const int next = st + kMmStagesF32 - 1;
    if (next < stages) load(next, next % kMmStagesF32);
    else cp_async_commit();
    if (chunk == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    }
    const float* ls = mm_smem + buf * stage_floats + tm * ldl;
    const float* rs = mm_smem + buf * stage_floats + BM * ldl + 8 * tf;
    for (int d = 0; d < ndots; ++d) {
#pragma unroll 2
      for (int kq = 0; kq < kMmChunkF32 / 4; ++kq) {
        float4 a[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = ld4(ls + r * RS * ldl + 4 * kq);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 b0 = ld4(rs + (4 * kq + u) * BF);
          const float4 b1 = ld4(rs + (4 * kq + u) * BF + 4);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float av = u == 0 ? a[r].x : u == 1 ? a[r].y : u == 2 ? a[r].z : a[r].w;
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av, bv[q], acc[r][q]);
          }
        }
      }
    }
    if (chunk == chunks - 1) {
      const int tile = st / chunks;
      const int m0 = tile / ftiles * BM, f0 = tile % ftiles * BF;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float* o = out + static_cast<size_t>(m0 + tm + r * RS) * f + f0 + 8 * tf;
        *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(o + 4) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
    }
  }
}

// K12 bf16: 8 warps in a WARPS_M x (8 / WARPS_M) grid, each a warp tile of
// (16 WTM) x (8 WTN) outputs: a block tile of BM x BF. Grid (steps), 256
// threads; dynamic smem a ring of 3 stages of lhs [BM][40] and rhs^T
// [BF][40] bf16 (the 80-byte rows put the 8 rows of every ldmatrix phase
// in distinct bank groups). lhs bf16 [m,k], rt bf16 [f,k] (rhs^T), out f32
// [m,f]; m a multiple of BM, f of BF, k of 32. Stages are (output tile,
// 32-deep chunk); the next two are copied with 16-byte cp.async under the
// current one's products. Per product and 16-deep step a warp loads its
// WTM A fragments with ldmatrix.x4 and its WTN B fragments with WTN / 2
// ldmatrix.x4 (rhs^T is K-contiguous, so no transpose), then issues
// WTM x WTN mma.sync.m16n8k16: each A fragment feeds WTN mmas and each B
// fragment WTM. (A 64-deep chunk left 4 such steps unrolled and spilled
// ~600 bytes at 128 registers.)
template <int WARPS_M, int WTM, int WTN>
__global__ void __launch_bounds__(kBlock, 2)
mm_shape_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rt,
                     float* __restrict__ out, int m, int k, int f, int ndots) {
  constexpr int BM = WARPS_M * 16 * WTM;
  constexpr int BF = (8 / WARPS_M) * 8 * WTN;
  constexpr int stage_elems = (BM + BF) * kMmLdB;
  extern __shared__ __align__(16) unsigned char mmb_smem[];
  bf16* smem = reinterpret_cast<bf16*>(mmb_smem);
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int ftiles = f / BF;
  const int chunks = k / kMmChunkBf16;
  const int stages = (m / BM) * ftiles * chunks;
  // This lane's ldmatrix row addresses: A rows lane % 16 at depth
  // (lane / 16) 8; B^T rows (lane & 7) + (lane / 16) 8 at depth
  // ((lane / 8) & 1) 8.
  const int a_off = (wm * 16 * WTM + lane % 16) * kMmLdB + (lane / 16) * 8;
  const int b_off = (wn * 8 * WTN + (lane & 7) + (lane >> 4) * 8) * kMmLdB + ((lane >> 3) & 1) * 8;

  auto load = [&](int st, int buf) {
    const int tile = st / chunks;
    const int k0 = (st % chunks) * kMmChunkBf16;
    const int m0 = tile / ftiles * BM;
    const int f0 = tile % ftiles * BF;
    bf16* la = smem + buf * stage_elems;
    for (int e = tid; e < (BM + BF) * (kMmChunkBf16 / 8); e += kBlock) {
      const int row = e / (kMmChunkBf16 / 8), v = e % (kMmChunkBf16 / 8);
      const bf16* src = row < BM ? lhs + static_cast<size_t>(m0 + row) * k
                                 : rt + static_cast<size_t>(f0 + row - BM) * k;
      cp_async16(la + row * kMmLdB + 8 * v, src + k0 + 8 * v);
    }
    cp_async_commit();
  };

  float acc[WTM][WTN][4];
  // A ring of kMmStagesBf16 stages: stages st + 1 .. st + S - 1 in flight
  // under stage st's products (an empty group where none is left).
  for (int q = 0; q < kMmStagesBf16 - 1; ++q) {
    if (q < stages) load(q, q);
    else cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    const int buf = st % kMmStagesBf16;
    const int chunk = st % chunks;
    cp_async_wait<kMmStagesBf16 - 2>();
    __syncthreads();  // stage st landed; stage st - 1 is no longer read
    const int next = st + kMmStagesBf16 - 1;
    if (next < stages) load(next, next % kMmStagesBf16);
    else cp_async_commit();
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < WTM; ++i)
#pragma unroll
        for (int j = 0; j < WTN; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
    // 32-bit shared addresses (bytes): the constant offsets below fold
    // into the ldmatrix instructions.
    const unsigned pa = sbase + 2 * (buf * stage_elems + a_off);
    const unsigned pb = sbase + 2 * (buf * stage_elems + BM * kMmLdB + b_off);
    for (int d = 0; d < ndots; ++d) {
#pragma unroll
      for (int ks = 0; ks < kMmChunkBf16; ks += 16) {
        uint32_t a[WTM][4], b[WTN / 2][4];
#pragma unroll
        for (int i = 0; i < WTM; ++i) ldmatrix_x4(a[i], pa + 2 * (i * 16 * kMmLdB + ks));
#pragma unroll
        for (int j = 0; j < WTN / 2; ++j) ldmatrix_x4(b[j], pb + 2 * (j * 16 * kMmLdB + ks));
#pragma unroll
        for (int i = 0; i < WTM; ++i)
#pragma unroll
          for (int j = 0; j < WTN; ++j)
            mma_bf16(acc[i][j], a[i], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);
      }
    }
    if (chunk == chunks - 1) {
      const int tile = st / chunks;
      const int m0 = tile / ftiles * BM + wm * 16 * WTM + lane / 4;
      const int f0 = tile % ftiles * BF + wn * 8 * WTN + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < WTM; ++i)
#pragma unroll
        for (int j = 0; j < WTN; ++j) {
          float* o = out + static_cast<size_t>(m0 + 16 * i) * f + f0 + 8 * j;
          *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<float2*>(o + 8 * static_cast<size_t>(f)) =
              make_float2(acc[i][j][2], acc[i][j][3]);
        }
    }
  }
}

template <typename T, typename K>
int launch_mm(K kernel, size_t smem, int steps, cudaStream_t s, const void* lhs,
              const void* rhs, void* out, int m, int k, int f, int ndots) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<steps, kBlock, smem, s>>>(static_cast<const T*>(lhs), static_cast<const T*>(rhs),
                                     static_cast<float*>(out), m, k, f, ndots);
  return cudaGetLastError();
}

}  // namespace

// The K10 instantiations the probe tools reach: storage, gather, taps per
// tile, dedup, tensor cores, diag mode. skyhdr_probe_fwd takes the same
// choices as arguments and launches the one instantiation that matches.
#define SKYHDR_PROBES(X)                            \
  X(float, kDirect, 1, false, false, kFull)         \
  X(bf16, kDirect, 1, false, false, kFull)          \
  X(float, kStaged, 1, false, false, kFull)         \
  X(bf16, kStaged, 1, false, false, kFull)          \
  X(float, kStaged, 9, false, false, kFull)         \
  X(bf16, kStaged, 9, false, false, kFull)          \
  X(bf16, kStaged, 2, false, false, kFull)          \
  X(bf16, kStaged, 1, false, true, kFull)           \
  X(bf16, kStaged, 1, true, false, kFull)           \
  X(float, kStaged, 1, false, true, kFull)          \
  X(bf16, kStaged, 1, false, false, kNoRoll)        \
  X(bf16, kStaged, 1, false, false, kNoMM)          \
  X(bf16, kStaged, 1, false, false, kMMOnly)        \
  X(bf16, kStaged, 1, false, false, kMMHoist)       \
  X(bf16, kStaged, 1, false, false, kLoadOnly)      \
  X(bf16, kStaged, 1, false, false, kLoad1Only)     \
  X(bf16, kStaged, 1, false, true, kMMOnly)         \
  X(float, kStaged, 1, false, false, kNoRoll)       \
  X(float, kStaged, 1, false, false, kNoMM)         \
  X(float, kStaged, 1, false, false, kMMOnly)       \
  X(float, kStaged, 1, false, false, kMMHoist)      \
  X(float, kStaged, 1, false, false, kLoadOnly)     \
  X(float, kStaged, 1, false, false, kLoad1Only)

extern "C" {

// The instantiation these choices name, launched with `plan` (or, with
// `resident` set, only its resident blocks per SM counted).
static int probe_dispatch(const void* x, const void* kern, const void* const* tab, void* out,
                          int is_bf16, int gather, int taps, int dedup, int mma, int diag, int B,
                          int H, int W, int C, int F, int rblk, const int* plan, int nplan,
                          cudaStream_t s, int* resident) {
#define SKYHDR_PROBE_CASE(T, G, TAPS, DEDUP, MMA, DIAG)                                      \
  if ((is_bf16 != 0) == (sizeof(T) == 2) && gather == G && taps == TAPS &&                   \
      (dedup != 0) == DEDUP && (mma != 0) == MMA && diag == DIAG) {                          \
    if (G == kDirect)                                                                        \
      return launch_direct<T>(x, kern, tab, out, B, H, W, C, F, rblk, plan, nplan, s,        \
                              resident);                                                     \
    return launch_staged<T, TAPS, DEDUP, MMA, DIAG>(x, kern, tab, out, B, H, W, C, F, rblk, \
                                                    plan, nplan, s, resident);               \
  }
  SKYHDR_PROBES(SKYHDR_PROBE_CASE)
#undef SKYHDR_PROBE_CASE
  return cudaErrorInvalidValue;
}

// K10: x [B,H,W,C] in the probe's storage type (is_bf16); kern f32 [9C,F];
// tables [H,9] (y0, y1 padded rows, cx, wy, wx); out f32 [B,H,W,F]. gather
// and diag take the values of Gather and Diag; taps, dedup and mma as the
// template arguments. plan: nplan ints, the host's launch plan
// (ops/kernels/probes.py:probe_tiling; a DirectPlan or a StagedPlan).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for choices
// no instantiation has, or a plan or shape it does not take).
int skyhdr_probe_fwd(const void* x, const void* kern, const void* y0, const void* y1,
                     const void* cx, const void* wy, const void* wx, void* out,
                     int is_bf16, int gather, int taps, int dedup, int mma, int diag,
                     int B, int H, int W, int C, int F, int rblk, const void* plan, int nplan,
                     int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* tab[5] = {y0, y1, cx, wy, wx};
  return probe_dispatch(x, kern, tab, out, is_bf16, gather, taps, dedup, mma, diag, B, H, W, C,
                        F, rblk, static_cast<const int*>(plan), nplan,
                        static_cast<cudaStream_t>(stream), nullptr);
}

// K10: the blocks of the instantiation and plan an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers, threads and
// shared memory), or minus a cudaError_t.
int skyhdr_probe_resident(int is_bf16, int gather, int taps, int dedup, int mma, int diag,
                          int H, int W, int C, int F, int rblk, const void* plan, int nplan,
                          int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -err;
  const void* tab[5] = {nullptr, nullptr, nullptr, nullptr, nullptr};
  int blocks = 0;
  const int code = probe_dispatch(nullptr, nullptr, tab, nullptr, is_bf16, gather, taps, dedup,
                                  mma, diag, 1, H, W, C, F, rblk, static_cast<const int*>(plan),
                                  nplan, nullptr, &blocks);
  return code != 0 ? -code : blocks;
}

// K11: x [B,H,W,C] -> out [B/P,H,W,P*C], elements of elem_bytes bytes;
// C * elem_bytes must be a multiple of 16 and B of P.
int skyhdr_pack_samples(const void* x, void* out, int B, int H, int W, int C, int P,
                        int elem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (P < 1 || B % P != 0 || (C * elem_bytes) % 16 != 0) return cudaErrorInvalidValue;
  const int vpc = C * elem_bytes / 16;
  const size_t n = static_cast<size_t>(B) * H * W * vpc;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const size_t want = (n + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 16u * sms ? want : 16u * sms);
  pack_samples_kernel<<<blocks > 0 ? blocks : 1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), n, vpc, P,
      static_cast<size_t>(H) * W);
  return cudaGetLastError();
}

// K12: is_bf16 = 0: lhs f32 [m,k], rhs f32 [k,f]; is_bf16 = 1: lhs bf16
// [m,k], rhs bf16 [f,k] (rhs^T). `tile` picks the block tile (0: 256 x 64,
// 1: 128 x 128, 2: 64 x 256 outputs; ops/kernels/probes.py:mm_tiling); m
// and f are multiples of its sides, k of 32. out f32
// [m,f]; `steps` blocks.
int skyhdr_mm_shape(const void* lhs, const void* rhs, void* out, int m, int k, int f,
                    int ndots, int steps, int is_bf16, int tile, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps < 1 || ndots < 1 || k < 1 || tile < 0 || tile > 2) return cudaErrorInvalidValue;
  const int bm = tile == 0 ? 256 : tile == 1 ? 128 : 64;
  const int bf = 16384 / bm;
  if (m % bm != 0 || f % bf != 0 || k % (is_bf16 ? kMmChunkBf16 : kMmChunkF32) != 0)
    return cudaErrorInvalidValue;
  if (is_bf16) {
    const size_t smem = sizeof(bf16) * kMmStagesBf16 * (bm + bf) * kMmLdB;
    auto kernel = tile == 0 ? mm_shape_bf16_kernel<4, 4, 4>
                            : tile == 1 ? mm_shape_bf16_kernel<2, 4, 4> : mm_shape_bf16_kernel<2, 2, 8>;
    return launch_mm<bf16>(kernel, smem, steps, s, lhs, rhs, out, m, k, f, ndots);
  }
  const size_t smem = sizeof(float) * kMmStagesF32 * (bm * (kMmChunkF32 + 4) + kMmChunkF32 * bf);
  auto kernel = tile == 0 ? mm_shape_f32_kernel<256>
                          : tile == 1 ? mm_shape_f32_kernel<128> : mm_shape_f32_kernel<64>;
  return launch_mm<float>(kernel, smem, steps, s, lhs, rhs, out, m, k, f, ndots);
}

}  // extern "C"
