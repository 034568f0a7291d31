// The DA-conv probe kernels for Hopper (sm_90a): K10 (the k = 3 DA forward
// in the design variants the probes compare), K11 (sample packing) and K12
// (the dot-shape microbench), with a plain C interface bound from Python
// with ctypes (skyhdr_torch/ops/kernels/probes.py). They serve the probe
// tools under skyhdr_torch/tools/, not the model.
//
// K10 (probe_direct_kernel<T> for G = kDirect, probe_staged_kernel<T, TAPS,
//   DEDUP, MMA, DIAG> for G = kStaged; one entry point, skyhdr_probe_fwd,
//   picks the instantiation by these choices) replaces the Pallas
//   variants of tools/exp_daconv.py: forward_a (`_kernel_a`), forward_b
//   (`_kernel_b`), forward_c (`_kernel_c`, `_kernel_cs`), forward_prodbf16
//   (`_kernel_prodbf16`), forward_diag (`_kernel_diag`), forward_pair
//   (`_kernel_pair`), forward_pack (those bodies on P samples packed along
//   the channels, block-diagonal K) and forward_dedup (`_kernel_dedup`).
//   All compute out[b,i,j] = sum_t sample_t[b,i,j] @ K_t (no bias, f32 out),
//     rowY   = (1-wy) xpad[y0] + wy xpad[y1]   (xpad: one zero row above
//                                              and below, in the storage type)
//     sample = (1-wx) rowY[(j+cx) mod W] + wx rowY[(j+cx+1) mod W],
//   or, under DIAG, one stated part of it. What they ask, asked of this card:
//     T      storage of x: float, or bf16 (read as f32).
//     G      kDirect (A): each thread reads its source rows from device
//            memory through L1/L2 at (j+cx) mod W, no staging; kStaged: the
//            interpolated [TW, TAPS*C] sample tile is built in shared memory
//            (K1's scheme) and contracted from there.
//     TAPS   taps contracted per staged tile: 1 (A, C, prodbf16, dedup),
//            2 (pair), 9 (B, cs: one contraction of depth 9C).
//     DEDUP  one y-interpolation per (row, kernel row) over the columns its
//            three taps read, staged in shared memory; the taps'
//            x-interpolations read it. mblk rows are stacked in the tile's
//            M (rows x columns of one block).
//     MMA    false: f32 FMA on CUDA cores (a 4x4 register tile per thread,
//            as K1); true: bf16 tensor cores, mma.sync.m16n8k16 (bf16
//            samples and K in, f32 accumulate), the card's counterpart of
//            a bf16 MXU dot.
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
//   bf16 x (67 MB) and the f32 output (134 MB). The f32 variants are fed
//   from shared memory at one load per 4 FMAs (K1's limit); the tensor-core
//   variants by 32-bit shared loads of both fragments: the tap's K^T slice
//   [F, C] (K pre-transposed to [F, 9C] by the wrapper) is staged in shared
//   memory beside the sample tile, once per block and tap.
//   What the design does about it: this is a probe, so each variant keeps
//   its one design choice and shares the rest: the same block (batch, rblk
//   output rows, TW columns), tables for the block's rows in shared memory,
//   the tile built with coalesced channel-fastest reads. The tile width TW
//   shrinks (fewer threads) until the tile fits the 227 KB a block may use
//   (B and cs: [TW, 9C+1] f32 is 147 KB at C=64, TW=64).
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
constexpr int kTileRows = 4;       // FMA: output columns held per thread
constexpr int kMmaM = 64;          // tensor-core tile rows (4 m16 tiles)
constexpr int kMaxGroup = 16;      // rows of one block's group (mblk)
// Dynamic shared memory a block may take: 227 KB less the static tables.
constexpr size_t kMaxSmem = 220 * 1024;

// The values skyhdr_probe_fwd takes (probes.py's GATHERS and DIAGS, in order).
enum Gather { kDirect = 0, kStaged = 1 };
enum Diag { kFull = 0, kNoRoll, kNoMM, kMMOnly, kMMHoist, kLoadOnly, kLoad1Only };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// ---------------------------------------------------------------- K10 (A)
// Grid (ceil(W / cols), H / rblk, B), kBlock threads; cols = 32 * warps /
// (F / 32). A warp holds 32 consecutive columns and one 32-wide chunk of F,
// so its reads of K are uniform. x [B,H,W,C] (T), kern [9C,F] f32.
template <typename T>
__global__ void __launch_bounds__(kBlock)
probe_direct_kernel(const T* __restrict__ x, const float* __restrict__ kern,
                    const int* __restrict__ y0t, const int* __restrict__ y1t,
                    const int* __restrict__ cxt, const float* __restrict__ wyt,
                    const float* __restrict__ wxt, float* __restrict__ out,
                    int H, int W, int C, int F, int rblk) {
  const int chunks = F / 32;
  const int warp = threadIdx.x / 32;
  const int chunk = warp % chunks;
  const int cols = (kBlock / 32 / chunks) * 32;
  const int j = blockIdx.x * cols + (warp / chunks) * 32 + threadIdx.x % 32;
  const int b = blockIdx.z;
  const size_t row_stride = static_cast<size_t>(W) * C;
  const T* xb = x + static_cast<size_t>(b) * H * row_stride;
  const float* kc = kern + 32 * chunk;
  for (int r = 0; r < rblk; ++r) {
    const int i = blockIdx.y * rblk + r;
    float acc[32] = {};
    if (j < W) {
      for (int t = 0; t < 9; ++t) {
        const int e = i * 9 + t;
        const int r0 = y0t[e] - 1;
        const int r1 = y1t[e] - 1;
        const float wy = wyt[e];
        const float wx = wxt[e];
        const bool in0 = r0 >= 0 && r0 < H;
        const bool in1 = r1 >= 0 && r1 < H;
        int q0 = j + cxt[e];
        if (q0 >= W) q0 -= W;
        const int q1 = q0 + 1 == W ? 0 : q0 + 1;
        const T* row0 = xb + static_cast<size_t>(in0 ? r0 : 0) * row_stride;
        const T* row1 = xb + static_cast<size_t>(in1 ? r1 : 0) * row_stride;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < C; c += 4) {
          const float4 a00 = in0 ? ld4(row0 + q0 * C + c) : z;
          const float4 a10 = in1 ? ld4(row1 + q0 * C + c) : z;
          const float4 a01 = in0 ? ld4(row0 + q1 * C + c) : z;
          const float4 a11 = in1 ? ld4(row1 + q1 * C + c) : z;
          const float s00[4] = {a00.x, a00.y, a00.z, a00.w};
          const float s10[4] = {a10.x, a10.y, a10.z, a10.w};
          const float s01[4] = {a01.x, a01.y, a01.z, a01.w};
          const float s11[4] = {a11.x, a11.y, a11.z, a11.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float g0 = (1.f - wy) * s00[u] + wy * s10[u];
            const float g1 = (1.f - wy) * s01[u] + wy * s11[u];
            const float s = (1.f - wx) * g0 + wx * g1;
            const float* kr = kc + static_cast<size_t>(t * C + c + u) * F;
#pragma unroll
            for (int v = 0; v < 8; ++v) {
              const float4 kv = ld4(kr + 4 * v);
              acc[4 * v + 0] = fmaf(s, kv.x, acc[4 * v + 0]);
              acc[4 * v + 1] = fmaf(s, kv.y, acc[4 * v + 1]);
              acc[4 * v + 2] = fmaf(s, kv.z, acc[4 * v + 2]);
              acc[4 * v + 3] = fmaf(s, kv.w, acc[4 * v + 3]);
            }
          }
        }
      }
      float* o = out + ((static_cast<size_t>(b) * H + i) * W + j) * F + 32 * chunk;
#pragma unroll
      for (int v = 0; v < 8; ++v)
        *reinterpret_cast<float4*>(o + 4 * v) =
            make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
    }
  }
}

// ------------------------------------------------------- K10 (staged)
// Grid (ceil(W / tw), H / rblk, B); block `threads` (FMA and sum modes:
// F/4 quads x lanes, M = 4 lanes tile rows; MMA: kBlock, M = kMmaM). The
// block's rows go in groups of mblk (1 unless DEDUP); tile row m is
// (row m / tw, column j0 + m % tw) with tw = M / mblk. Dynamic smem: the
// tile (f32 [M, TAPS*C+1], or bf16 [M, TAPS*C+8] for MMA), for MMA the
// tap's K^T slice bf16 [F, C+8], then for DEDUP the y-interpolated window
// f32 [mblk, win, C], win = tw + span + 1. The +8 row pads make the
// fragment loads conflict-free. kern: f32 [9C, F] (FMA) or bf16 K^T
// [F, 9C] (MMA).
template <typename T, int TAPS, bool DEDUP, bool MMA, int DIAG>
__global__ void __launch_bounds__(kBlock)
probe_staged_kernel(const T* __restrict__ x, const void* __restrict__ kern,
                    const int* __restrict__ y0t, const int* __restrict__ y1t,
                    const int* __restrict__ cxt, const float* __restrict__ wyt,
                    const float* __restrict__ wxt, float* __restrict__ out,
                    int H, int W, int C, int F, int rblk, int mblk, int span) {
  static_assert(!(MMA && (TAPS != 1 || DIAG == kMMHoist)),
                "the tensor-core product stages one tap's K per tile");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_r0[kMaxGroup][9], s_r1[kMaxGroup][9], s_cx[kMaxGroup][9];
  __shared__ float s_wy[kMaxGroup][9], s_wx[kMaxGroup][9];
  __shared__ int s_start[kMaxGroup], s_off[kMaxGroup][3];

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int depth = TAPS * C;
  const int quads = F / 4;
  const int lanes = nthr / quads;
  const int M = MMA ? kMmaM : lanes * kTileRows;
  const int tw = M / mblk;
  const int j0 = blockIdx.x * tw;
  const int b = blockIdx.z;
  const size_t row_stride = static_cast<size_t>(W) * C;
  const T* xb = x + static_cast<size_t>(b) * H * row_stride;

  float* tile = reinterpret_cast<float*>(smem);
  __nv_bfloat16* tileb = reinterpret_cast<__nv_bfloat16*>(smem);
  const int ld = MMA ? depth + 8 : depth + 1;
  const int ldk = C + 8;
  const int win = tw + span + 1;
  const size_t tile_bytes = static_cast<size_t>(M) * ld * (MMA ? 2 : 4);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + tile_bytes);
  float* window = reinterpret_cast<float*>(
      smem + tile_bytes + (MMA ? static_cast<size_t>(F) * ldk * 2 : 0));

  // FMA / sum layout
  const int quad = tid % quads;
  const int lane = tid / quads;
  // MMA layout: warp (m tile, n half), lane (group g, quad position tq)
  const int warp = tid / 32;
  const int mt = warp & 3;
  const int nh = warp >> 2;
  const int g = (tid & 31) >> 2;
  const int tq = tid & 3;
  const int ntw = F / 16;  // n8 tiles per warp

  for (int gi = 0; gi < rblk; gi += mblk) {
    const int ig = blockIdx.y * rblk + gi;
    __syncthreads();  // the previous group's tables and tile are no longer read
    for (int e = tid; e < mblk * 9; e += nthr) {
      const int r = e / 9, t = e % 9;
      const int q = (ig + r) * 9 + (DEDUP ? (t / 3) * 3 : t);  // dedup: kx = 0's y
      s_r0[r][t] = y0t[q] - 1;
      s_r1[r][t] = y1t[q] - 1;
      s_wy[r][t] = wyt[q];
      s_cx[r][t] = cxt[(ig + r) * 9 + t];
      s_wx[r][t] = wxt[(ig + r) * 9 + t];
    }
    float acc[kTileRows][4] = {};
    float macc[8][4] = {};

    for (int t0 = 0; t0 < 9; t0 += TAPS) {
      const int ntap = 9 - t0 < TAPS ? 9 - t0 : TAPS;
      if (!(DIAG == kMMHoist && t0 > 0)) {
        __syncthreads();  // tables visible; the previous tile is no longer read
        if (DEDUP && t0 % 3 == 0) {
          const int ky = t0 / 3;
          if (tid < mblk) {
            const int c0 = s_cx[tid][3 * ky];
            int lo = 0, hi = 0;
            for (int kx = 0; kx < 3; ++kx) {
              int rel = s_cx[tid][3 * ky + kx] - c0;
              if (rel < 0) rel += W;
              if (rel > W / 2) rel -= W;
              s_off[tid][kx] = rel;
              lo = rel < lo ? rel : lo;
              hi = rel > hi ? rel : hi;
            }
            for (int kx = 0; kx < 3; ++kx) s_off[tid][kx] -= lo;
            int st = (j0 + c0 + lo) % W;
            s_start[tid] = st < 0 ? st + W : st;
          }
          __syncthreads();
          for (int e = tid; e < mblk * win * C; e += nthr) {
            const int c = e % C;
            const int p = (e / C) % win;
            const int r = e / (C * win);
            int col = s_start[r] + p;
            col %= W;
            const int r0 = s_r0[r][3 * ky], r1 = s_r1[r][3 * ky];
            const float wy = s_wy[r][3 * ky];
            const float a0 = (r0 >= 0 && r0 < H) ? to_f(xb[r0 * row_stride + col * C + c]) : 0.f;
            const float a1 = (r1 >= 0 && r1 < H) ? to_f(xb[r1 * row_stride + col * C + c]) : 0.f;
            window[e] = (1.f - wy) * a0 + wy * a1;
          }
          __syncthreads();
        }
        for (int e = tid; e < M * ntap * C; e += nthr) {
          const int q = e / C;  // (tile row, tap of the group)
          const int c = e - q * C;
          const int tt = TAPS == 1 ? 0 : q % ntap;
          const int m = TAPS == 1 ? q : q / ntap;
          const int r = DEDUP ? m / tw : 0;  // one row per group unless DEDUP
          const int jj = m - r * tw;
          const int j = j0 + jj;
          const int t = DIAG == kMMHoist ? 0 : t0 + tt;
          float v = 0.f;
          if (j < W) {
            if (DEDUP) {
              const int p = jj + s_off[r][t % 3];
              const float* wr = window + (static_cast<size_t>(r) * win + p) * C + c;
              const float wx = s_wx[r][t];
              v = (1.f - wx) * wr[0] + wx * wr[C];
            } else {
              const int r0 = s_r0[r][t], r1 = s_r1[r][t];
              const bool in0 = r0 >= 0 && r0 < H;
              const bool in1 = r1 >= 0 && r1 < H;
              const T* row0 = xb + static_cast<size_t>(in0 ? r0 : 0) * row_stride + c;
              const T* row1 = xb + static_cast<size_t>(in1 ? r1 : 0) * row_stride + c;
              const float wy = s_wy[r][t];
              if (DIAG == kFull || DIAG == kNoMM) {
                int q0 = j + s_cx[r][t];
                if (q0 >= W) q0 -= W;
                const int q1 = q0 + 1 == W ? 0 : q0 + 1;
                const float a00 = in0 ? to_f(row0[q0 * C]) : 0.f;
                const float a10 = in1 ? to_f(row1[q0 * C]) : 0.f;
                const float a01 = in0 ? to_f(row0[q1 * C]) : 0.f;
                const float a11 = in1 ? to_f(row1[q1 * C]) : 0.f;
                const float g0 = (1.f - wy) * a00 + wy * a10;
                const float g1 = (1.f - wy) * a01 + wy * a11;
                const float wx = s_wx[r][t];
                v = (1.f - wx) * g0 + wx * g1;
              } else {
                const float a0 = in0 ? to_f(row0[j * C]) : 0.f;
                const float a1 = in1 ? to_f(row1[j * C]) : 0.f;
                if (DIAG == kNoRoll) v = (1.f - wy) * a0 + wy * a1;
                else if (DIAG == kLoadOnly) v = a0 + a1;
                else v = a0;  // kMMOnly, kMMHoist, kLoad1Only
              }
            }
          }
          if (MMA) tileb[m * ld + tt * C + c] = __float2bfloat16(v);
          else tile[m * ld + tt * C + c] = v;
        }
        if (MMA) {  // the tap's K^T slice, 16-byte vectors
          const __nv_bfloat16* kt = static_cast<const __nv_bfloat16*>(kern);
          const int vpr = C / 8;
          for (int e = tid; e < F * vpr; e += nthr) {
            const int col = e / vpr, v = e - col * vpr;
            *reinterpret_cast<uint4*>(ks + col * ldk + 8 * v) =
                *reinterpret_cast<const uint4*>(kt + static_cast<size_t>(col) * 9 * C +
                                                t0 * C + 8 * v);
          }
        }
        __syncthreads();
      }

      if (is_sum(DIAG)) {
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          const float* tr = tile + (lane + lanes * r) * ld + 4 * quad;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += tr[q];
        }
      } else if (MMA) {
        const __nv_bfloat16* ta = tileb + (16 * mt + g) * ld + 2 * tq;
        for (int k0 = 0; k0 < C; k0 += 16) {
          uint32_t a[4];
          a[0] = ld32(ta + k0);
          a[1] = ld32(ta + 8 * ld + k0);
          a[2] = ld32(ta + k0 + 8);
          a[3] = ld32(ta + 8 * ld + k0 + 8);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if (n < ntw) {
              const __nv_bfloat16* kb = ks + (8 * (nh * ntw + n) + g) * ldk + k0 + 2 * tq;
              mma_bf16(macc[n], a, ld32(kb), ld32(kb + 8));
            }
          }
        }
      } else {
        const float* km = static_cast<const float*>(kern) +
                          static_cast<size_t>(t0) * C * F + 4 * quad;
        for (int k = 0; k < ntap * C; ++k) {
          const float4 mv = ld4(km + static_cast<size_t>(k) * F);
#pragma unroll
          for (int r = 0; r < kTileRows; ++r) {
            const float s = tile[(lane + lanes * r) * ld + k];
            acc[r][0] = fmaf(s, mv.x, acc[r][0]);
            acc[r][1] = fmaf(s, mv.y, acc[r][1]);
            acc[r][2] = fmaf(s, mv.z, acc[r][2]);
            acc[r][3] = fmaf(s, mv.w, acc[r][3]);
          }
        }
      }
    }

    if (MMA) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n < ntw) {
          const int col = 8 * (nh * ntw + n) + 2 * tq;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int m = 16 * mt + g + 8 * h2;
            const int r = m / tw;
            const int j = j0 + m - r * tw;
            if (j < W) {
              float* o = out + ((static_cast<size_t>(b) * H + ig + r) * W + j) * F + col;
              *reinterpret_cast<float2*>(o) = make_float2(macc[n][2 * h2], macc[n][2 * h2 + 1]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < kTileRows; ++rr) {
        const int m = lane + lanes * rr;
        const int r = m / tw;
        const int j = j0 + m - r * tw;
        if (j < W) {
          float* o = out + ((static_cast<size_t>(b) * H + ig + r) * W + j) * F + 4 * quad;
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
        }
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_direct(const void* x, const void* kern, const void* const* tab, void* out,
                  int B, int H, int W, int C, int F, int rblk, cudaStream_t s) {
  if (F % 32 != 0 || (kBlock / 32) % (F / 32) != 0 || C % 4 != 0 || rblk < 1 ||
      H % rblk != 0)
    return cudaErrorInvalidValue;
  const int cols = (kBlock / 32 / (F / 32)) * 32;
  const dim3 grid((W + cols - 1) / cols, H / rblk, B);
  probe_direct_kernel<T><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(kern),
      static_cast<const int*>(tab[0]), static_cast<const int*>(tab[1]),
      static_cast<const int*>(tab[2]), static_cast<const float*>(tab[3]),
      static_cast<const float*>(tab[4]), static_cast<float*>(out), H, W, C, F, rblk);
  return cudaGetLastError();
}

template <typename T, int TAPS, bool DEDUP, bool MMA, int DIAG>
int launch_staged(const void* x, const void* kern, const void* const* tab, void* out,
                  int B, int H, int W, int C, int F, int rblk, int mblk, int span,
                  cudaStream_t s) {
  if (rblk < 1 || H % rblk != 0 || mblk < 1 || mblk > kMaxGroup || rblk % mblk != 0 ||
      (!DEDUP && mblk != 1) || span < 0 || F % 4 != 0 || F / 4 > kBlock ||
      kBlock % (F / 4) != 0 || (is_sum(DIAG) && C < F))
    return cudaErrorInvalidValue;
  if (MMA && (C % 16 != 0 || F % 16 != 0 || F > 128)) return cudaErrorInvalidValue;
  const int depth = TAPS * C;
  int threads = kBlock, M = 0;
  size_t smem = 0;
  for (;;) {  // the widest tile that fits: halve the lanes until it does
    M = MMA ? kMmaM : (threads / (F / 4)) * kTileRows;
    if (M % mblk != 0) return cudaErrorInvalidValue;
    const int tw = M / mblk;
    smem = MMA ? static_cast<size_t>(M) * (depth + 8) * 2 + static_cast<size_t>(F) * (C + 8) * 2
               : static_cast<size_t>(M) * (depth + 1) * 4;
    if (DEDUP) smem += static_cast<size_t>(mblk) * (tw + span + 1) * C * 4;
    if (smem <= kMaxSmem) break;
    if (MMA || threads / (F / 4) <= 1) return cudaErrorInvalidValue;
    threads /= 2;
  }
  auto kernel = probe_staged_kernel<T, TAPS, DEDUP, MMA, DIAG>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tw = M / mblk;
  const dim3 grid((W + tw - 1) / tw, H / rblk, B);
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), kern, static_cast<const int*>(tab[0]),
      static_cast<const int*>(tab[1]), static_cast<const int*>(tab[2]),
      static_cast<const float*>(tab[3]), static_cast<const float*>(tab[4]),
      static_cast<float*>(out), H, W, C, F, rblk, mblk, span);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

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

// 16-byte asynchronous copy global -> shared (L2 only), and its groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
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

// K10: x [B,H,W,C] in the probe's storage type (is_bf16); kern f32 [9C,F]
// (FMA and sum modes) or bf16 [F,9C] (tensor cores); tables [H,9] (y0, y1
// padded rows, cx, wy, wx); out f32 [B,H,W,F]. gather and diag take the
// values of Gather and Diag; taps, dedup and mma as the template arguments.
// span: the largest spread of the three column shifts of a kernel row
// (DEDUP's window). Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for choices no instantiation has, or a shape the
// probe does not take).
int skyhdr_probe_fwd(const void* x, const void* kern, const void* y0, const void* y1,
                     const void* cx, const void* wy, const void* wx, void* out,
                     int is_bf16, int gather, int taps, int dedup, int mma, int diag,
                     int B, int H, int W, int C, int F, int rblk, int mblk, int span,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* tab[5] = {y0, y1, cx, wy, wx};
#define SKYHDR_PROBE_CASE(T, G, TAPS, DEDUP, MMA, DIAG)                               \
  if ((is_bf16 != 0) == (sizeof(T) == 2) && gather == G && taps == TAPS &&            \
      (dedup != 0) == DEDUP && (mma != 0) == MMA && diag == DIAG) {                   \
    if (G == kDirect) return launch_direct<T>(x, kern, tab, out, B, H, W, C, F, rblk, s); \
    return launch_staged<T, TAPS, DEDUP, MMA, DIAG>(x, kern, tab, out, B, H, W, C, F,  \
                                                    rblk, mblk, span, s);             \
  }
  SKYHDR_PROBES(SKYHDR_PROBE_CASE)
#undef SKYHDR_PROBE_CASE
  return cudaErrorInvalidValue;
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
