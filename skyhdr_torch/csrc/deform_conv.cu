// Distortion-aware (DA) equirectangular conv, stride 1, for Hopper
// (sm_90a): the k = 3 kernels K1-K3 and the odd-k kernels K5-K7, with a
// plain C interface, bound from Python with ctypes
// (skyhdr_torch/ops/kernels/deform_conv.py).
//
// What they replace (skyhdr/ops/pallas/deform_conv.py):
//   K1 da_fwd_kernel<T, 3, CH> — `_kernel_k3` driven by `_forward_k3`: the
//        forward out[b,i,j] = bias + sum_t sample_t[b,i,j] @ K_t, with
//        rowY   = (1-wy) xpad[y0] + wy xpad[y1]         (xpad: 1 zero row
//                                                        above and below)
//        sample = (1-wx) rowY[(j+cx) mod W] + wx rowY[(j+cx+1) mod W].
//        Described below; K5 is the same kernel at a run-time k.
//   K2 da_dx_kernel<3>  — `_dx_k3_kernel` driven by `_pallas_dx` (k3
//        branch): the input gradient, over the forward's (row, tap) pairs,
//        dx[y] = sum_{(i,t): y0 = y} (1-wy) P_it + sum_{(i,t): y1 = y} wy P_it,
//        P_it = U_it @ K_t^T,
//        U_it[j] = (1-wx) g[i][(j-cx) mod W] + wx g[i][(j-cx-1) mod W]
//        (the TPU kernel sums the same terms per input row over the
//        scatter_tables_k3 slots). Described with K7 below: it is K7's
//        kernel at k = 3.
//   K3 da_dk_kernel<T, 3, CH> — `_dk_k3_kernel` driven by `_pallas_dk`:
//        the weight gradient dK[t*C+c, f] = sum_{b,i,j} sample_t[b,i,j,c]
//        g[b,i,j,f], the sample rebuilt from x as in K1 (never stored),
//        followed by da_dk_reduce_kernel, which sums the per-split partials.
//
// What bounds K1 and K5 on this card: at the serving shapes (C, F <= 128,
// H x W <= 64 x 256) each output costs 2*k^2*C*F flops against k^2*C
// interpolated samples, and a call moves little DRAM traffic (the 64x256
// b32 trunk layer at k = 3: 9.7 GFLOP against ~34 MB), so on CUDA cores in
// f32 (TF32 stays off) they are bound by operations: 0.144 ms for that
// layer at the 67 TFLOP/s peak. What held the first version (one block per
// output row and column tile, a [TW, C] sample tile per tap behind a
// barrier, a 4 x 4 register tile) to 17-30% of that bound: (1) the sample
// build and the product ran one after the other, no copy in flight; (2)
// every tap re-read and re-interpolated its two source rows, though y0, y1
// and wy are the same for all taps of a kernel row; (3) the product was fed
// one shared-memory float per 4 FMAs and one float4 of K from L1/L2 per 16
// (K never staged: each block streamed all of K for one output row); (4)
// the build, which scales with C, weighs most where F is small (F = 32).
//
// What this design does (da_fwd_kernel below): a block owns `rows` output
// rows x a column tile (rows x tw <= 128 outputs) x an F tile (the largest
// power of two up to 128 dividing F). The host groups the gather tables
// (ops/distortion.py:window_tables): where every tap of a kernel row reads
// the same two source rows with the same weight (every shape the model
// runs), one group per kernel row, with the column where the group's window
// starts and each tap's offset into it; otherwise one group per tap. A
// stage is (group, chunk of cc input channels), taps x cc <= 64 deep: the
// window's two raw source rows (tw + span + 1 columns, wrapped; rows outside
// [0, H) zero-filled) of each output row and the group's K chunk
// [taps x cc, ft] are copied with cp.async a stage ahead, under the current
// stage's product; the window is y-interpolated once per (output row,
// group, chunk), and each tap x-interpolates from it into a transposed
// sample tile [taps x cc][rows x tw], rounded to bf16 when x is bf16. Each
// thread accumulates 8 columns x CH output channels (CH = 8 for full
// 256-thread blocks of 128 channels, else 4; ops/kernels/deform_conv.py:
// fwd_tiling picks the tile and the rows so that the grid still gives each
// SM 1.5 blocks), fed by float4 shared loads of both operands: two of the
// sample and CH/4 of K per 8 x CH FMAs; each staged sample serves ft
// output channels and each staged K chunk every output of the block. Two barriers a stage. f32 FMAs and
// sums in a fixed order, no atomics: bitwise repeatable. The wrapper pads C
// to a multiple of 4 (the sun-pose input's 3) with zero channels.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py's timing phase):
// 0.307 ms for the 64x256 b32 trunk layer, 47% of its bound (the first
// version 0.497 ms, 29%); 36-39% at F = 64 and 31% at F = 32, where the
// 8 x 4 tile and the per-tap build weigh more against each product.
//
// K3 is bound by operations: 2*B*H*W*9*C*F flops (19.3 GFLOP for a 64x256
// b64 trunk layer, 0.29 ms at the 67 TFLOP/s f32 CUDA-core peak) against
// ~67 MB of x and g (20 us at 3.35 TB/s). Its output is small ([9C, F],
// 147k floats at the trunk) and its reduction long (B*H*W = 65,536 rows at
// the trunk, ~1M at conv2_f/u). The TPU kernel sums over its sequential
// grid into one resident block; here blocks run in no order, so the
// reduction is split across one wave of blocks (ops/kernels/deform_conv.py:
// dk_tiling) into a workspace [nsplit, 9C, F] that da_dk_reduce_kernel sums
// in split order: deterministic, no float atomics.
// What held the first version (one block per C x F tile, tap and row
// split; per 64-column chunk the rebuilt [64, Ct] sample and the [64, Ft]
// cotangent staged behind two barriers; a 4 x 4 register tile) to 12-25%
// of that bound (1.23 ms at the b64 trunk, 4.68 at conv2_f/u): (1) one tap
// a block, so each tap's block re-read and y-interpolated its two source
// rows and staged its own copy of the same cotangent chunk; (2) each
// sample built from four scalar loads and g copied synchronously, in
// series with the product; (3) two shared float4 loads per 16 FMAs; (4) the
// block size set by the tile: 8 threads at C = 4, F = 32 (k = 7,
// sunlayer1.conv1: 0.5% of its bound).
// What this design does (da_dk_kernel below, one template for every odd k):
// a block owns one group of the forward's window tables (a kernel row's k
// taps where they share their source rows, else one tap), cc input
// channels and ft output channels: an M = taps x cc by ft tile of dK. Per
// stage (one (b, i) row x tw columns) the group's two raw source rows
// (tw + span + 1 columns, wrapped; rows outside [0, H) zero) and the
// cotangent chunk [tw, ft] are copied with cp.async a stage ahead, under
// the current stage's product; the window is y-interpolated once and every
// tap x-interpolates its samples from it with float4 reads, so one staged g
// chunk serves all the group's taps. Each thread accumulates an 8 x 8 tile
// (8 x 4 below 64 output channels, and where 8 x 8 tiles leave a block
// small) fed by float4 shared loads: two of the samples and CH/4 of g per
// 8 x CH FMAs; the 8 x 8 instantiations keep ~160 registers (K3, two
// blocks of 192 threads an SM) or 128 (K6, three of 160). Where the tile
// leaves a block small (C = 3/4, or F = 4), `slices` copies of it split
// each stage's columns and are summed in slice order at the end, so every
// layer shape of the model gets a block of 160-256 threads (plan_dk). f32 samples even
// for bf16 x, as the TPU kernels, f32 FMAs (TF32 stays off).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py's timing phase):
// 0.702 ms for the 64x256 b64 trunk layer, 41% of its bound (the first
// version 1.23 ms, 23%); 38% at F = 64, 28% at conv2_f/u (F = 32), where
// each sample feeds only 32 FMAs; K6 at the k = 5 trunk 2.00 ms, 40%.
//
// The odd-k kernels (any odd k; the model runs k = 5 and k = 7) replace the
// generic branches of the same file:
//   K5 da_fwd_kernel<T, 0, CH> — `_kernel_body` driven by `_pallas_forward`:
//        K1's formula over k^2 taps, with k // 2 zero rows above and below.
//        It IS K1's kernel, templated on the kernel size (3 at compile time
//        for K1, 0 for a size given at run time): k enters through the
//        window tables (k groups of k taps, spans up to 9 columns at k = 5
//        and 15 at k = 7) and the stage depth (40 at k = 5, 56 at k = 7).
//        Bound by operations, as K1: 2*B*H*W*k^2*C*F.
//   K6 da_dk_kernel<T, 0, CH> — `_dk_kernel` driven by `_pallas_dk`:
//        K3's kernel at a run-time size; k enters through the window
//        tables (k groups of k taps) and the tile (taps x cc rows).
//        C must be a multiple of 4, as for K3; the wrapper pads the k = 7
//        sun-pose input (C = 3) with a zero channel.
//   K7 da_dx_kernel<0>      — `_dx_kernel` driven by `_pallas_dx`: K2's
//        input gradient at a run-time odd k (the TPU kernel walks the
//        `scatter_tables` references of each input row). One kernel,
//        templated on the kernel size as da_fwd_kernel is; k enters only
//        through the tables, and K2's C is never padded.
//        Bound by operations, counted at the forward's products,
//        2*B*H*W*k^2*C*F (19.3 GFLOP, 0.29 ms for the 64x256 b64 trunk
//        layer), against ~67 MB of g and dx.
//        What held the first version (one block per input row, per
//        reference a [TW, F] tile of the shifted, weighted cotangent row
//        rebuilt from global memory, then its product with K_t^T behind a
//        barrier) to 40-48 ms per GAN step: (1) every (i, t) product was
//        formed twice, once for row y0 and once for y1, though only the
//        scalar row weight differs; (2) tile build and product ran one
//        after the other; (3) one shared-memory float per 4 FMAs and one
//        L1 float4 of K per 16 fed the product.
//        What this design does (da_dx_kernel below): a block owns a strip
//        of R consecutive input rows (`rows`: R = 8, 4 or 2, the largest
//        that still gives the grid 1.5 blocks per SM, dx_strip_rows in
//        ops/kernels/deform_conv.py) and forms each (i, t) product whose y0
//        or y1 lies in the strip once, adding (1-wy) P to row y0 and wy P
//        to row y0 + 1: about k^2 (R + 1) pairs per strip against 2 k^2 R
//        references, so at most (R + 1) / R times the forward's products
//        (pad rows excluded; tests/test_torch_tables.py checks the bound;
//        0.96-1.06 at R = 8 at the model's 64x256 b64 shapes). The pair lists are
//        built on the host from the forward's gather tables, sorted by y0,
//        so two row accumulators per thread suffice. The raw cotangent
//        window and K_t^T's chunk are staged with cp.async, double
//        buffered under the current stage's work; the x-interpolation reads
//        shared memory; an 8 x 4 register tile is fed by float4 shared
//        loads of both operands. The column tile is sized from C and W.
//        float32 operands on CUDA cores (TF32 stays off), f32 sums, no
//        atomics: each block owns its dx rows and walks its pairs in a
//        fixed order, so dx is bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;     // K3/K6: threads per block, at most (8 x CH tiles x slices)
constexpr int kFwdThreads = 256;  // K1/K5: threads per block, at most
constexpr int kFwdCols = 8;       // K1/K5: output columns per thread (x 4 or 8 channels)
constexpr int kFwdMaxM = 128;     // K1/K5: output rows x columns per block, at most
constexpr int kFwdMaxFt = 128;    // K1/K5: output channels per block, at most
constexpr int kFwdDepth = 64;     // K1/K5: taps x input channels per stage, at most
constexpr int kDxThreads = 128;    // K2/K7: threads per block, at most
constexpr int kDxCols = 8;         // K2/K7: dx columns per thread (x 4 channels)
constexpr int kDxChunk = 32;       // K2/K7: output channels staged per stage (or twice)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round a float32 matmul operand to the element type's precision.
__device__ __forceinline__ float round_operand(float v, const float*) { return v; }
__device__ __forceinline__ float round_operand(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &u.x, sizeof(lo));
  memcpy(&hi, &u.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// e = first, first + step, ... walked as (q, r) = (e / width, e % width):
// one division at the start instead of one per step.
struct DivWalk {
  int q, r;
  const int dq, dr, width;
  __device__ DivWalk(int first, int step, int w)
      : q(first / w), r(first % w), dq(step / w), dr(step % w), width(w) {}
  __device__ void next() {
    q += dq;
    r += dr;
    if (r >= width) {
      r -= width;
      ++q;
    }
  }
};

// 16-byte asynchronous copy global -> shared (L2 only), and its groups.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 4-element asynchronous copy global -> shared: 16 bytes of float32 through
// L2 only, 8 bytes of bf16 through L1. When `valid` is false nothing is
// read and the 4 elements are zero-filled.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  memcpy(&u.x, &lo, sizeof(lo));
  memcpy(&u.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = u;
}

// K1/K5 launch plan (plan_fwd): a block owns `rows` output rows x tw
// columns x ft output channels; stages of `depth` = taps x cc (taps of one
// group x a chunk of cc input channels); shared memory as laid out below,
// byte offsets from the start.
struct FwdPlan {
  int rows, tw, ft, cc, taps, groups, k;
  int wn;     // window columns: tw + span + 1
  int ldy;    // window row stride (floats): cc + 4
  int ldm;    // sample tile row stride (floats): rows x tw rounded up to 32, + 4
  int depth;  // taps x cc
  int threads;
  int off_s, off_raw, off_k, off_rtab, off_ttab, smem;
};

// K1 (KC = 3) and K5 (KC = 0: kernel size k at run time). Grid
// (column tiles x F tiles, ceil(H / rows), B); block p.threads. x [B,H,W,Cp]
// and kern [k^2 Cp, F] (both T), bias [F] f32, out [B,H,W,F] T. Tables
// (ops/distortion.py:window_tables_on): rtab [H, G] (r0, r1, base, wy bits),
// r0/r1 unpadded source rows (outside [0, H) read zero); ttab [H, k^2]
// (d, wx bits).
//
// Stage s = (group g, channel chunk) of G x Cp / cc; per block and stage:
//   raw   [rows][2][wn][cc]  T   rows r0, r1 of each output row, window
//                                columns (j0 + base + c) mod W   (cp.async)
//   ywin  [2][rows][wn][ldy] f32 (1-wy) raw0 + wy raw1            (built)
//   kbuf  [2][depth][ft]     T   K_t[chunk, f-tile] of the group's taps (cp.async)
//   stile [depth][ldm]       f32 per tap, (1-wx) ywin[j+d] + wx ywin[j+d+1],
//                                rounded as the operand type     (built)
// Stage s's barrier-to-barrier phase builds stile(s) from ywin(s) and
// ywin(s+1) from raw(s+1); then the copies of raw(s+2) and K(s+1) are
// issued and run under stage s's product, in which each thread
// accumulates an 8-column x CH-channel register tile (CH = 4 or 8), fed by
// two float4 of the sample tile and CH/4 4-vectors of K per 8 x CH FMAs.
// Two barriers a stage.
template <typename T, int KC, int CH>
__global__ void __launch_bounds__(kFwdThreads, 2)
da_fwd_kernel(const T* __restrict__ x, const T* __restrict__ kern,
              const float* __restrict__ bias, const int4* __restrict__ rows_tab,
              const int2* __restrict__ taps_tab, T* __restrict__ out, int H, int W,
              int Cp, int F, FwdPlan p) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int k2 = KC ? KC * KC : p.k * p.k;
  const int R = p.rows, tw = p.tw, ft = p.ft, cc = p.cc, nt = p.taps, G = p.groups;
  const int wn = p.wn, ldy = p.ldy, ldm = p.ldm, depth = p.depth;
  float* ywin = reinterpret_cast<float*>(fwd_smem);
  float* stile = reinterpret_cast<float*>(fwd_smem + p.off_s);
  T* raw = reinterpret_cast<T*>(fwd_smem + p.off_raw);
  T* kbuf = reinterpret_cast<T*>(fwd_smem + p.off_k);
  int4* rtab = reinterpret_cast<int4*>(fwd_smem + p.off_rtab);
  int2* ttab = reinterpret_cast<int2*>(fwd_smem + p.off_ttab);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int ftiles = F / ft;
  const int j0 = (blockIdx.x / ftiles) * tw;
  const int f0 = (blockIdx.x % ftiles) * ft;
  const int i0 = blockIdx.y * R;
  const int b = blockIdx.z;
  const int chunks = Cp / cc;
  const int stages = G * chunks;
  const T* xb = x + static_cast<size_t>(b) * H * W * Cp;
  const T* rnd = nullptr;  // selects round_operand's overload

  for (int e = tid; e < R * G; e += nthr) {
    const int i = i0 + e / G;
    rtab[e] = i < H ? rows_tab[i * G + e % G] : make_int4(-1, -1, 0, 0);
  }
  for (int e = tid; e < R * k2; e += nthr) {
    const int i = i0 + e / k2;
    ttab[e] = i < H ? taps_tab[i * k2 + e % k2] : make_int2(0, 0);
  }

  // Each walk starts at this thread and steps over the block's threads.
  const DivWalk raw_walk(tid, nthr, cc / 4);  // (window column, 4 channels)
  const DivWalk k_walk(tid, nthr, ft / 4);    // (channel, 4 output channels)
  const DivWalk s_walk(tid, nthr, cc);        // (4 columns, channel)

  auto load_raw = [&](int st) {
    const int g = st / chunks;
    const int c0 = (st % chunks) * cc;
    for (int r = 0; r < R; ++r) {
      const int4 rt = rtab[r * G + g];
      for (int y = 0; y < 2; ++y) {
        const int row = y ? rt.y : rt.x;
        const bool in = row >= 0 && row < H;
        const T* src = xb + static_cast<size_t>(in ? row : 0) * W * Cp + c0;
        T* dst = raw + static_cast<size_t>(2 * r + y) * wn * cc;
        for (DivWalk v = raw_walk; v.q < wn; v.next()) {
          int col = j0 + rt.z + v.q;
          while (col >= W) col -= W;
          cp_async4(dst + v.q * cc + 4 * v.r, src + static_cast<size_t>(col) * Cp + 4 * v.r, in);
        }
      }
    }
  };
  auto load_k = [&](int st, int buf) {
    const int g = st / chunks;
    const int c0 = (st % chunks) * cc;
    for (int m = 0; m < nt; ++m) {
      const T* src = kern + (static_cast<size_t>(g * nt + m) * Cp + c0) * F + f0;
      T* dst = kbuf + (static_cast<size_t>(buf) * depth + m * cc) * ft;
      for (DivWalk v = k_walk; v.q < cc; v.next())
        cp_async4(dst + v.q * ft + 4 * v.r, src + static_cast<size_t>(v.q) * F + 4 * v.r, true);
    }
  };
  auto build_ywin = [&](int st, int buf) {
    const int g = st / chunks;
    for (int r = 0; r < R; ++r) {
      const float wy = __int_as_float(rtab[r * G + g].w);
      const T* a = raw + static_cast<size_t>(2 * r) * wn * cc;
      const T* c = a + static_cast<size_t>(wn) * cc;
      float* dst = ywin + static_cast<size_t>(buf * R + r) * wn * ldy;
      for (DivWalk v = raw_walk; v.q < wn; v.next()) {
        const float4 a0 = load4(a + v.q * cc + 4 * v.r);
        const float4 a1 = load4(c + v.q * cc + 4 * v.r);
        *reinterpret_cast<float4*>(dst + v.q * ldy + 4 * v.r) = make_float4(
            (1.f - wy) * a0.x + wy * a1.x, (1.f - wy) * a0.y + wy * a1.y,
            (1.f - wy) * a0.z + wy * a1.z, (1.f - wy) * a0.w + wy * a1.w);
      }
    }
  };
  auto build_s = [&](int st, int buf) {
    const int g = st / chunks;
    for (int m = 0; m < nt; ++m) {
      for (int r = 0; r < R; ++r) {
        const int2 tt = ttab[r * k2 + g * nt + m];
        const float wx = __int_as_float(tt.y);
        const float a0 = 1.f - wx;
        const float* src = ywin + static_cast<size_t>(buf * R + r) * wn * ldy + tt.x * ldy;
        float* dst = stile + static_cast<size_t>(m) * cc * ldm + r * tw;
        for (DivWalk v = s_walk; v.q < tw / 4; v.next()) {
          const float* s = src + 4 * v.q * ldy + v.r;
          const float v0 = s[0], v1 = s[ldy], v2 = s[2 * ldy], v3 = s[3 * ldy], v4 = s[4 * ldy];
          *reinterpret_cast<float4*>(dst + v.r * ldm + 4 * v.q) = make_float4(
              round_operand(a0 * v0 + wx * v1, rnd), round_operand(a0 * v1 + wx * v2, rnd),
              round_operand(a0 * v2 + wx * v3, rnd), round_operand(a0 * v3 + wx * v4, rnd));
        }
      }
    }
  };

  const int ncg = ft / CH;
  const int cg = tid % ncg;
  const int rg = tid / ncg;
  float acc[kFwdCols][CH] = {};
  auto product = [&](int buf) {
    const float* sp = stile + kFwdCols * rg;
    const T* kp = kbuf + static_cast<size_t>(buf) * depth * ft + CH * cg;
#pragma unroll 4
    for (int q = 0; q < depth; ++q) {
      const float4 s0 = *reinterpret_cast<const float4*>(sp + q * ldm);
      const float4 s1 = *reinterpret_cast<const float4*>(sp + q * ldm + 4);
      const float sv[kFwdCols] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float kv[CH];
#pragma unroll
      for (int n = 0; n < CH; n += 4) {
        const float4 v = load4(kp + q * ft + n);
        kv[n] = v.x;
        kv[n + 1] = v.y;
        kv[n + 2] = v.z;
        kv[n + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < kFwdCols; ++m)
#pragma unroll
        for (int n = 0; n < CH; ++n) acc[m][n] = fmaf(sv[m], kv[n], acc[m][n]);
    }
  };

  __syncthreads();  // the tables are in place
  load_raw(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  build_ywin(0, 0);
  __syncthreads();  // raw is free again
  if (stages > 1) load_raw(1);
  load_k(0, 0);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    cp_async_wait_all();
    __syncthreads();  // raw(st+1) and K(st) landed; the last product is done
    build_s(st, buf);
    if (st + 1 < stages) build_ywin(st + 1, buf ^ 1);
    __syncthreads();  // stile(st) and ywin(st+1) built; raw is free again
    if (st + 2 < stages) load_raw(st + 2);
    if (st + 1 < stages) load_k(st + 1, buf ^ 1);
    cp_async_commit();
    product(buf);
  }

  const int r = kFwdCols * rg / tw;
  const int jj = kFwdCols * rg - r * tw;
  const int i = i0 + r;
  if (i >= H) return;
  const int f = f0 + CH * cg;
  T* o = out + ((static_cast<size_t>(b) * H + i) * W + j0 + jj) * F + f;
#pragma unroll
  for (int n = 0; n < CH; n += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(bias + f + n);
#pragma unroll
    for (int m = 0; m < kFwdCols; ++m)
      if (j0 + jj + m < W)
        store4(o + static_cast<size_t>(m) * F + n,
               make_float4(acc[m][n] + bv.x, acc[m][n + 1] + bv.y, acc[m][n + 2] + bv.z,
                           acc[m][n + 3] + bv.w));
  }
}

// K2 (KC = 3) and K7 (KC = 0: kernel size k at run time): the DA input
// gradient over the strip tables (ops/distortion.py:strip_tables). Each
// block owns `rows` consecutive input rows (a strip) x tw columns x ct
// channels of dx for one batch image, and walks the strip's (output row i,
// tap t) pairs in their order (sorted by y0): for each it forms
// P = U_{i,t} @ K_t^T once, with U_{i,t}'s x-interpolation read from the
// staged cotangent window, and adds w0 * P to row y0 and w1 * P to row
// y0 + 1. The pairs come sorted by y0, so a thread holds just two row
// accumulators: `acc` (row r) and `nxt` (row r + 1); when the walk passes
// a row, that row is complete and is stored.
//
// Stages: (pair, chunk of fc = 64 or 32 output channels). Stage s + 1's
// raw window (tw + 1 columns of g's row i, from column j0 - cx - 1,
// wrapped) and K_t^T chunk [fc, ct] are copied into the other half of a double buffer with
// cp.async while stage s builds U^T [fc, tw] from its window (one pass,
// (1-wx) win[jj+1] + wx win[jj], stored transposed so that a thread reads
// its 8 columns as two float4) and runs the product: each thread an
// 8-column x 4-channel register tile, fed one float4 of K^T and two of U^T
// per 32 FMAs, all from shared memory. Grid (column tiles x channel tiles,
// strips, B); plan_dx sizes the tiles. dx rows outside [0, H) are never
// written; every row of the strip inside it is written exactly once.
template <int KC>
__global__ void __launch_bounds__(kDxThreads, 3)
da_dx_kernel(const float* __restrict__ g, const float* __restrict__ kt,
             const int4* __restrict__ pint, const float4* __restrict__ pflt,
             const int* __restrict__ start, int rows, float* __restrict__ dx,
             int H, int W, int C, int Cp, int F, int ct, int tw, int fc) {
  extern __shared__ __align__(16) float dx_smem[];
  const int ldw = fc + 4;  // window row stride (16-byte rows)
  const int ldu = tw + 4;  // U^T row stride: tw % 32 == 0, so ldu % 32 == 4
  float* win = dx_smem;                    // [2][tw + 1][ldw] raw cotangents
  float* kbuf = win + 2 * (tw + 1) * ldw;  // [2][fc][ct] K_t^T chunk
  float* ubuf = kbuf + 2 * fc * ct;        // [fc][ldu] U^T chunk
  const int ncg = ct / 4;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int cg = tid % ncg;
  const int rg = tid / ncg;
  const int ctiles = Cp / ct;
  const int j0 = (blockIdx.x / ctiles) * tw;
  const int c0 = (blockIdx.x % ctiles) * ct;
  const int y_lo = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int p0 = start[blockIdx.y];
  const int chunks = (F + fc - 1) / fc;
  const int stages = (start[blockIdx.y + 1] - p0) * chunks;
  const float* gb = g + static_cast<size_t>(b) * H * W * F;
  // K2's channels come unpadded (C % 4 == 0); K7's may be padded to Cp.
  const bool vec = KC == 3 || C % 4 == 0;

  auto load = [&](int st, int buf) {
    const int4 e = pint[p0 + st / chunks];  // (i, t, cx, r)
    const int f0 = (st % chunks) * fc;
    const int kc = min(fc, F - f0);
    const float* grow = gb + static_cast<size_t>(e.x) * W * F + f0;
    float* wb = win + buf * (tw + 1) * ldw;
    int col0 = (j0 - e.z - 1) % W;
    if (col0 < 0) col0 += W;
    const int vpr = kc / 4;
    for (DivWalk v(tid, nthr, vpr); v.q <= tw; v.next()) {
      int col = col0 + v.q;
      while (col >= W) col -= W;
      cp_async16(wb + v.q * ldw + 4 * v.r, grow + static_cast<size_t>(col) * F + 4 * v.r);
    }
    const float* ksrc = kt + (static_cast<size_t>(e.y) * F + f0) * Cp + c0;
    float* kb = kbuf + buf * fc * ct;
    for (DivWalk v(tid, nthr, ncg); v.q < kc; v.next())
      cp_async16(kb + v.q * ct + 4 * v.r, ksrc + static_cast<size_t>(v.q) * Cp + 4 * v.r);
    cp_async_commit();
  };

  float acc[kDxCols][4] = {};
  float nxt[kDxCols][4] = {};
  float prod[kDxCols][4];
  int r_cur = -1;  // the strip row `acc` holds; `nxt` holds r_cur + 1
  auto advance = [&]() {  // row r_cur is complete: store it, move down one
    const int y = y_lo + r_cur;
    if (r_cur >= 0 && y < H) {
      const int c = c0 + 4 * cg;
      float* o = dx + (static_cast<size_t>(b) * H + y) * W * C + c;
#pragma unroll
      for (int m = 0; m < kDxCols; ++m) {
        const int j = j0 + kDxCols * rg + m;
        if (j >= W) continue;
        float* oj = o + static_cast<size_t>(j) * C;
        if (vec) {
          *reinterpret_cast<float4*>(oj) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < C) oj[q] = acc[m][q];
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kDxCols; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[m][q] = nxt[m][q];
        nxt[m][q] = 0.f;
      }
    ++r_cur;
  };

  if (stages > 0) load(0, 0);
  int n = p0;      // the stage's pair
  int chunk = 0;   // and its channel chunk
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    cp_async_wait_all();
    __syncthreads();  // stage st has landed; stage st - 1 is no longer read
    if (st + 1 < stages) load(st + 1, buf ^ 1);
    const int kc = min(fc, F - chunk * fc);
    const float wx = pflt[n].x;
    const float a0 = 1.f - wx;
    const float* wb = win + buf * (tw + 1) * ldw;
    // U^T[f][jj] = (1-wx) win[jj + 1][f] + wx win[jj][f], 4 columns a step.
    for (DivWalk e(tid, nthr, kc); e.q < tw / 4; e.next()) {
      const float* s = wb + 4 * e.q * ldw + e.r;
      const float v0 = s[0], v1 = s[ldw], v2 = s[2 * ldw], v3 = s[3 * ldw], v4 = s[4 * ldw];
      *reinterpret_cast<float4*>(ubuf + e.r * ldu + 4 * e.q) =
          make_float4(fmaf(wx, v0, a0 * v1), fmaf(wx, v1, a0 * v2), fmaf(wx, v2, a0 * v3),
                      fmaf(wx, v3, a0 * v4));
    }
    __syncthreads();  // U^T is built
    if (chunk == 0) {
#pragma unroll
      for (int m = 0; m < kDxCols; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) prod[m][q] = 0.f;
    }
    const float* kb = kbuf + buf * fc * ct + 4 * cg;
    const float* ub = ubuf + kDxCols * rg;
    auto depth_step = [&](int f) {
      const float4 u0 = *reinterpret_cast<const float4*>(ub + f * ldu);
      const float4 u1 = *reinterpret_cast<const float4*>(ub + f * ldu + 4);
      const float4 kv = *reinterpret_cast<const float4*>(kb + f * ct);
      const float uv[kDxCols] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int m = 0; m < kDxCols; ++m) {
        prod[m][0] = fmaf(uv[m], kv.x, prod[m][0]);
        prod[m][1] = fmaf(uv[m], kv.y, prod[m][1]);
        prod[m][2] = fmaf(uv[m], kv.z, prod[m][2]);
        prod[m][3] = fmaf(uv[m], kv.w, prod[m][3]);
      }
    };
    if (kc == 2 * kDxChunk) {  // the full chunks, unrolled whole
#pragma unroll
      for (int f = 0; f < 2 * kDxChunk; ++f) depth_step(f);
    } else if (kc == kDxChunk) {
#pragma unroll
      for (int f = 0; f < kDxChunk; ++f) depth_step(f);
    } else {
#pragma unroll 4
      for (int f = 0; f < kc; ++f) depth_step(f);
    }
    if (++chunk == chunks) {  // P of pair n is complete
      const int r = pint[n].w;
      while (r_cur < r) advance();
      const float4 wt = pflt[n];  // (wx, w0, w1, 0)
#pragma unroll
      for (int m = 0; m < kDxCols; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[m][q] = fmaf(wt.y, prod[m][q], acc[m][q]);
          nxt[m][q] = fmaf(wt.z, prod[m][q], nxt[m][q]);
        }
      chunk = 0;
      ++n;
    }
  }
  while (r_cur < rows) advance();
}

// The threads a K3 (KC = 3) or K6 (KC = 0) block of 8 x CH tiles takes at
// most, and the blocks each instantiation is compiled to keep resident on
// an SM: the 8 x 8 tile runs fastest with ~160 registers, so K3's blocks of
// up to 192 threads two an SM, and K6's (160 threads at the k = 5 trunk)
// three, within 136 registers.
constexpr int dk_max_threads(int kc, int ch) { return ch == 4 ? kThreads : kc == 3 ? 192 : 160; }
constexpr int dk_min_blocks(int kc, int ch) { return ch == 8 && kc != 3 ? 3 : 2; }

// K3/K6 launch plan (plan_dk): a block owns one window group (`taps`
// taps of a kernel row, or one tap), cc input channels and ft output
// channels of dK, an M x ft tile (M = taps x cc rows, tap-major, padded to
// mp, a multiple of 8), held by (mp / 8) x (ft / CH) threads of 8 x CH and
// `slices` copies of them that split each stage's columns; a stage is one
// (b, i) row x tw columns. Shared memory as laid out below, byte offsets
// from the start (the window ywin at 0).
struct DkPlan {
  int cc, taps, groups, k, ft, chans, mp, slices, tw, chunks, wn, threads;
  int tiles;  // blocks per split: groups x C / cc x F / ft
  int off_s, off_raw, off_g, smem;
};

// K3 (KC = 3) and K6 (KC = 0: kernel size k at run time) partials. Grid
// (p.tiles, nsplit); block p.threads. x [B,H,W,Cp] (T, read as f32), g
// [B,H,W,F] f32, the window tables as in K1 (rows_tab [H, G] (r0, r1,
// base, wy bits), taps_tab [H, k^2] (d, wx bits)); ws [nsplit, k^2 Cp, F]
// f32 receives each split's sum over its stages s in [s_begin, s_end) of
// the B*H*chunks stages (row r = s / chunks, columns from (s % chunks) tw).
//
// Per block and stage:
//   raw   [2][wn][cc]   T   rows r0, r1 of the group at (b, i), window
//                           columns (j0 + base + q) mod W     (cp.async)
//   ywin  [2][wn][cc]   f32 (1-wy) raw0 + wy raw1              (built)
//   gbuf  [2][tw][ft]   f32 g[b, i, j0 + jj, f-tile], 0 past W (cp.async)
//   stile [tw][mp]      f32 per tap m, (1-wx) ywin[jj+d] + wx ywin[jj+d+1]
//                           at rows m cc + c                   (built)
// Stage s's barrier-to-barrier phase builds stile(s) from ywin(s) and
// ywin(s+1) from raw(s+1); then the copies of raw(s+2) and g(s+1) are
// issued and run under stage s's product, in which each thread adds the
// outer products of its slice's columns to an 8-row x CH-channel register
// tile, fed by two float4 of the sample tile and CH/4 of g per 8 x CH FMAs.
// Two barriers a stage. At the end the slices' tiles are summed through
// shared memory in slice order.
template <typename T, int KC, int CH>
__global__ void __launch_bounds__(dk_max_threads(KC, CH), dk_min_blocks(KC, CH))
da_dk_kernel(const T* __restrict__ x, const float* __restrict__ g,
             const int4* __restrict__ rows_tab, const int2* __restrict__ taps_tab,
             float* __restrict__ ws, int B, int H, int W, int Cp, int F, DkPlan p) {
  extern __shared__ __align__(16) unsigned char dk_smem[];
  const int k2 = KC ? KC * KC : p.k * p.k;
  const int nt = p.taps, G = p.groups, cc = p.cc, ft = p.ft, tw = p.tw, wn = p.wn;
  const int mp = p.mp, nch = p.chunks;
  float* ywin = reinterpret_cast<float*>(dk_smem);
  float* stile = reinterpret_cast<float*>(dk_smem + p.off_s);
  T* raw = reinterpret_cast<T*>(dk_smem + p.off_raw);
  float* gbuf = reinterpret_cast<float*>(dk_smem + p.off_g);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int ftiles = F / ft;
  const int ctiles = Cp / cc;
  const int grp = blockIdx.x / (ctiles * ftiles);
  const int c0 = (blockIdx.x / ftiles % ctiles) * cc;
  const int f0 = (blockIdx.x % ftiles) * ft;
  const long long total = static_cast<long long>(B) * H * nch;
  const int s_begin = static_cast<int>(blockIdx.y * total / gridDim.y);
  const int stages = static_cast<int>((blockIdx.y + 1) * total / gridDim.y) - s_begin;

  // Stage st of this block: image row r = b H + i and its first column j0.
  struct Stage {
    int r, i, j0;
  };
  auto stage = [&](int st) {
    const int s = s_begin + st;
    const int r = s / nch;
    return Stage{r, r % H, (s - r * nch) * tw};
  };

  // The copies and builds walk their elements from this thread in steps of
  // the block's threads: (window column, 4 channels), (column, 4 output
  // channels) or (column, tap x 4 channels). Each walk is set up per stage,
  // which keeps registers free for the product's tile.
  auto load_raw = [&](int st) {
    const Stage sg = stage(st);
    const int4 rt = rows_tab[sg.i * G + grp];
    const T* xb = x + static_cast<size_t>(sg.r - sg.i) * W * Cp + c0;  // image b
    for (int y = 0; y < 2; ++y) {
      const int row = y ? rt.y : rt.x;
      const bool in = row >= 0 && row < H;
      const T* src = xb + static_cast<size_t>(in ? row : 0) * W * Cp;
      T* dst = raw + static_cast<size_t>(y) * wn * cc;
      for (DivWalk v(tid, nthr, cc / 4); v.q < wn; v.next()) {
        int col = sg.j0 + rt.z + v.q;
        while (col >= W) col -= W;
        cp_async4(dst + v.q * cc + 4 * v.r, src + static_cast<size_t>(col) * Cp + 4 * v.r, in);
      }
    }
  };
  auto load_g = [&](int st, int buf) {
    const Stage sg = stage(st);
    const float* src = g + (static_cast<size_t>(sg.r) * W + sg.j0) * F + f0;
    float* dst = gbuf + static_cast<size_t>(buf) * tw * ft;
    for (DivWalk v(tid, nthr, ft / 4); v.q < tw; v.next()) {
      const bool in = sg.j0 + v.q < W;
      cp_async4(dst + v.q * ft + 4 * v.r, src + static_cast<size_t>(in ? v.q : 0) * F + 4 * v.r,
                in);
    }
  };
  auto build_ywin = [&](int st, int buf) {
    const Stage sg = stage(st);
    const float wy = __int_as_float(rows_tab[sg.i * G + grp].w);
    const T* a = raw;
    const T* c = raw + static_cast<size_t>(wn) * cc;
    float* dst = ywin + static_cast<size_t>(buf) * wn * cc;
    for (DivWalk v(tid, nthr, cc / 4); v.q < wn; v.next()) {
      const int e = v.q * cc + 4 * v.r;
      const float4 a0 = load4(a + e);
      const float4 a1 = load4(c + e);
      store4(dst + e, make_float4((1.f - wy) * a0.x + wy * a1.x, (1.f - wy) * a0.y + wy * a1.y,
                                  (1.f - wy) * a0.z + wy * a1.z, (1.f - wy) * a0.w + wy * a1.w));
    }
  };
  auto build_s = [&](int st, int buf) {
    const Stage sg = stage(st);
    const int2* tt = taps_tab + static_cast<size_t>(sg.i) * k2 + grp * nt;
    const float* src = ywin + static_cast<size_t>(buf) * wn * cc;
    const int lq = __ffs(cc) - 3;  // cc / 4 = 2^lq (cc is a power of two)
    for (DivWalk v(tid, nthr, nt << lq); v.q < tw; v.next()) {
      const int m = v.r >> lq;
      const int c = 4 * (v.r & ((1 << lq) - 1));
      const int2 t = tt[m];
      const float wx = __int_as_float(t.y);
      const float a0 = 1.f - wx;
      const float* s = src + (v.q + t.x) * cc + c;
      const float4 u0 = load4(s);
      const float4 u1 = load4(s + cc);
      store4(stile + v.q * mp + m * cc + c,
             make_float4(a0 * u0.x + wx * u1.x, a0 * u0.y + wx * u1.y, a0 * u0.z + wx * u1.z,
                         a0 * u0.w + wx * u1.w));
    }
  };

  const int ncg = ft / CH;
  const int base = mp / 8 * ncg;  // threads of one slice
  const int slice = tid / base;
  const int rg = tid % base / ncg;
  const int cg = tid % ncg;
  const int sw = tw / p.slices;  // columns of a slice per stage
  float acc[8][CH] = {};
  auto product = [&](int buf) {
    const float* sp = stile + static_cast<size_t>(slice) * sw * mp + 8 * rg;
    const float* gp = gbuf + (static_cast<size_t>(buf) * tw + slice * sw) * ft + CH * cg;
#pragma unroll 4
    for (int jj = 0; jj < sw; ++jj) {
      const float4 s0 = *reinterpret_cast<const float4*>(sp + jj * mp);
      const float4 s1 = *reinterpret_cast<const float4*>(sp + jj * mp + 4);
      const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float gv[CH];
#pragma unroll
      for (int n = 0; n < CH; n += 4) {
        const float4 v = *reinterpret_cast<const float4*>(gp + jj * ft + n);
        gv[n] = v.x;
        gv[n + 1] = v.y;
        gv[n + 2] = v.z;
        gv[n + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < CH; ++n) acc[m][n] = fmaf(sv[m], gv[n], acc[m][n]);
    }
  };

  if (stages > 0) {
    load_raw(0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    build_ywin(0, 0);
    __syncthreads();  // raw is free again
    if (stages > 1) load_raw(1);
    load_g(0, 0);
    cp_async_commit();
    for (int st = 0; st < stages; ++st) {
      const int buf = st & 1;
      cp_async_wait_all();
      __syncthreads();  // raw(st+1) and g(st) landed; the last product is done
      build_s(st, buf);
      if (st + 1 < stages) build_ywin(st + 1, buf ^ 1);
      __syncthreads();  // stile(st) and ywin(st+1) built; raw is free again
      if (st + 2 < stages) load_raw(st + 2);
      if (st + 1 < stages) load_g(st + 1, buf ^ 1);
      cp_async_commit();
      product(buf);
    }
  }

  // The slices' tiles summed in slice order: slices 1.. through shared
  // memory ([slices - 1][mp][ft] from the start), slice 0 adds and stores.
  if (p.slices > 1) {
    float* red = reinterpret_cast<float*>(dk_smem);
    __syncthreads();  // every product is done; shared memory is free
    if (slice > 0) {
      float* r = red + (static_cast<size_t>(slice - 1) * mp + 8 * rg) * ft + CH * cg;
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < CH; n += 4)
          *reinterpret_cast<float4*>(r + m * ft + n) =
              make_float4(acc[m][n], acc[m][n + 1], acc[m][n + 2], acc[m][n + 3]);
    }
    __syncthreads();
    if (slice > 0) return;
    for (int s = 1; s < p.slices; ++s) {
      const float* r = red + (static_cast<size_t>(s - 1) * mp + 8 * rg) * ft + CH * cg;
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < CH; n += 4) {
          const float4 v = *reinterpret_cast<const float4*>(r + m * ft + n);
          acc[m][n] += v.x;
          acc[m][n + 1] += v.y;
          acc[m][n + 2] += v.z;
          acc[m][n + 3] += v.w;
        }
    }
  }
  float* out = ws + static_cast<size_t>(blockIdx.y) * k2 * Cp * F + f0 + CH * cg;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int e = 8 * rg + m;  // tap-major row of the block's tile
    if (e >= nt * cc) break;
    const int tap = e / cc;
    const size_t row = static_cast<size_t>(grp * nt + tap) * Cp + c0 + e - tap * cc;
#pragma unroll
    for (int n = 0; n < CH; n += 4)
      *reinterpret_cast<float4*>(out + row * F + n) =
          make_float4(acc[m][n], acc[m][n + 1], acc[m][n + 2], acc[m][n + 3]);
  }
}

// K3/K6 second pass: out[e] = sum_s ws[s, e] in split order (deterministic).
__global__ void da_dk_reduce_kernel(const float* __restrict__ ws, int nsplit,
                                    size_t n, float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += ws[static_cast<size_t>(k) * n + e];
  out[e] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool odd_size(int k) { return k >= 1 && k % 2 == 1; }

// K1/K5 tiling for register tiles of 8 columns x `chans` (4 or 8) output
// channels: ft output channels (the largest power of two up to kFwdMaxFt
// dividing F) and m = rows x tw outputs, m at most kFwdMaxM and at most
// what kFwdThreads threads hold; tw is W rounded up to 8, capped at that
// m. The 8 x 8 tile only for a full block of kFwdThreads threads. False
// when the shape does not tile.
bool fwd_tiles(int W, int F, int rows, int chans, int* tw, int* ft) {
  if (W <= 0 || F <= 0 || F % 4 != 0 || rows < 1 || (chans != 4 && chans != 8)) return false;
  *ft = kFwdMaxFt;
  while (F % *ft != 0) *ft /= 2;
  if (*ft < chans) return false;
  int m = kFwdThreads * kFwdCols * chans / *ft;
  m = m < kFwdMaxM ? m : kFwdMaxM;
  *tw = (W + 7) / 8 * 8;
  *tw = *tw < m ? *tw : m;
  const int threads = rows * *tw / kFwdCols * (*ft / chans);
  return rows * *tw <= m && (chans == 4 || threads == kFwdThreads);
}

// K1/K5 launch plan: the tiles above, and cc input channels a stage (the
// largest of 32, 16, 8, 4 dividing Cp with taps x cc <= kFwdDepth). elem:
// the bytes of x's type. False when the shape does not tile or the shared
// memory exceeds a block's.
bool plan_fwd(int W, int Cp, int F, int k, int taps, int span, int rows, int chans, int elem,
              FwdPlan* p) {
  int tw, ft;
  if (!fwd_tiles(W, F, rows, chans, &tw, &ft) || Cp <= 0 || Cp % 4 != 0 || !odd_size(k) ||
      (taps != 1 && taps != k) || span < 0)
    return false;
  int cc = 32;
  while (cc >= 4 && (Cp % cc != 0 || taps * cc > kFwdDepth)) cc /= 2;
  if (cc < 4) return false;
  const int m = rows * tw;
  p->rows = rows;
  p->tw = tw;
  p->ft = ft;
  p->cc = cc;
  p->taps = taps;
  p->groups = k * k / taps;
  p->k = k;
  p->wn = tw + span + 1;
  p->ldy = cc + 4;
  p->ldm = (m + 31) / 32 * 32 + 4;
  p->depth = taps * cc;
  p->threads = (m / kFwdCols) * (ft / chans);
  auto up16 = [](size_t n) { return (n + 15) / 16 * 16; };
  size_t off = sizeof(float) * 2 * static_cast<size_t>(rows) * p->wn * p->ldy;  // ywin
  p->off_s = static_cast<int>(off);
  off += up16(sizeof(float) * static_cast<size_t>(p->depth) * p->ldm);
  p->off_raw = static_cast<int>(off);
  off += up16(static_cast<size_t>(elem) * rows * 2 * p->wn * cc);
  p->off_k = static_cast<int>(off);
  off += up16(static_cast<size_t>(elem) * 2 * p->depth * ft);
  p->off_rtab = static_cast<int>(off);
  off += sizeof(int4) * static_cast<size_t>(rows) * p->groups;
  p->off_ttab = static_cast<int>(off);
  off += sizeof(int2) * static_cast<size_t>(rows) * k * k;
  p->smem = static_cast<int>(off);
  return off <= 232448;
}

template <typename T, int KC, int CH>
int launch_fwd_plan(const FwdPlan& p, const void* x, const void* kern, const void* bias,
                    const void* rows_tab, const void* taps_tab, void* out, int B, int H, int W,
                    int Cp, int F, cudaStream_t stream) {
  cudaError_t err = allow_smem(da_fwd_kernel<T, KC, CH>, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((W + p.tw - 1) / p.tw) * (F / p.ft), (H + p.rows - 1) / p.rows, B);
  da_fwd_kernel<T, KC, CH><<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(kern), static_cast<const float*>(bias),
      static_cast<const int4*>(rows_tab), static_cast<const int2*>(taps_tab),
      static_cast<T*>(out), H, W, Cp, F, p);
  return cudaGetLastError();
}

template <typename T, int KC>
int launch_fwd(const void* x, const void* kern, const void* bias, const void* rows_tab,
               const void* taps_tab, void* out, int B, int H, int W, int Cp, int F, int k,
               int taps, int span, int rows, int chans, cudaStream_t stream) {
  FwdPlan p;
  if (!plan_fwd(W, Cp, F, k, taps, span, rows, chans, sizeof(T), &p))
    return cudaErrorInvalidValue;
  return (chans == 8 ? launch_fwd_plan<T, KC, 8> : launch_fwd_plan<T, KC, 4>)(
      p, x, kern, bias, rows_tab, taps_tab, out, B, H, W, Cp, F, stream);
}

// K2/K7 tiling: ct channels (the largest of 64, 32, 16, 8, 4 dividing
// Cp) by tw columns (kDxThreads threads of 8 columns x 4 channels, at most
// 256 columns, and no wider than W rounded up to 32, so that a narrow map
// or a 3-channel layer does not leave most of a block idle), fc output
// channels staged per chunk (64, 32 or 16, or F when it is smaller).
struct DxPlan {
  int ct, tw, fc, threads;
  size_t smem;
};

bool plan_dx(int W, int Cp, int F, DxPlan* p) {
  if (W <= 0 || Cp <= 0 || Cp % 4 != 0 || F <= 0 || F % 4 != 0) return false;
  int ct = 64;
  while (Cp % ct != 0) ct /= 2;
  const int ncg = ct / 4;
  int tw = kDxCols * (kDxThreads / ncg);
  const int wcap = (W + 31) / 32 * 32;
  tw = tw < wcap ? tw : wcap;
  tw = tw < 256 ? tw : 256;
  const int fc_max = tw >= 256 ? kDxChunk / 2 : kDxChunk;
  p->ct = ct;
  p->tw = tw;
  p->fc = F < fc_max ? F : fc_max;
  // Where F allows and the tile is at most 64 columns (85.5 KB of shared
  // memory, still 2 blocks an SM), a 64-deep stage halves the barriers,
  // U^T builds and cp.async calls per product.
  if (F >= 2 * kDxChunk && tw <= 64) p->fc = 2 * kDxChunk;
  p->threads = (tw / kDxCols) * ncg;
  p->smem = sizeof(float) * (static_cast<size_t>(2) * (tw + 1) * (p->fc + 4) +
                             2 * p->fc * ct + p->fc * (tw + 4));
  return true;
}

template <int KC>
int launch_dx(const void* g, const void* kt, const void* pint, const void* pflt,
              const void* start, int strips, int rows, void* dx, int B, int H,
              int W, int C, int Cp, int F, cudaStream_t stream) {
  DxPlan p;
  if (Cp < C || (KC == 3 && Cp != C) || rows < 1 || strips != (H + rows - 1) / rows ||
      !plan_dx(W, Cp, F, &p))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(da_dx_kernel<KC>, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((W + p.tw - 1) / p.tw) * (Cp / p.ct), strips, B);
  da_dx_kernel<KC><<<grid, p.threads, p.smem, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(kt),
      static_cast<const int4*>(pint), static_cast<const float4*>(pflt),
      static_cast<const int*>(start), rows, static_cast<float*>(dx), H, W, C,
      Cp, F, p.ct, p.tw, p.fc);
  return cudaGetLastError();
}

// K3/K6 tiling: ft output channels (the largest power of two up to 128
// dividing F); register tiles of 8 rows x CH, CH = 8 from ft = 64 on where
// blocks of at most dk_max_threads still hold 160 threads, else CH = 4 in
// up to kThreads; the most input channels cc (a power of two from 128 down
// to 4 dividing Cp) whose taps x cc rows, padded to 8, fit those threads,
// then the most slices (8, 4, 2) that do. A stage's columns tw: 64 where
// its shared memory stays within 64 KB, else 32, at most W rounded up to
// 8. elem: the bytes of x's type. False when the shape does not tile or
// the shared memory exceeds a block's.
bool plan_dk(int W, int Cp, int F, int k, int taps, int span, int elem, DkPlan* p) {
  if (W <= 0 || Cp <= 0 || Cp % 4 != 0 || F <= 0 || F % 4 != 0 || !odd_size(k) ||
      (taps != 1 && taps != k) || span < 0)
    return false;
  int ft = 128;
  while (F % ft != 0) ft /= 2;
  auto rows8 = [](int n) { return (n + 7) / 8 * 8; };
  // The input channels and slices of 8 x ch tiles in at most `limit`
  // threads: the most channels, then the most slices.
  int chans, cc, mp, base, slices;
  auto tile = [&](int ch, int limit) {
    chans = ch;
    cc = 128;
    while (cc >= 4 && (Cp % cc != 0 || rows8(taps * cc) / 8 * (ft / chans) > limit)) cc /= 2;
    if (cc < 4) return false;
    mp = rows8(taps * cc);
    base = mp / 8 * (ft / chans);
    slices = 8;
    while (slices > 1 && base * slices > limit) slices /= 2;
    return true;
  };
  // 8 x 8 tiles from 64 output channels on, in blocks of at most
  // dk_max_threads; 8 x 4 tiles where that leaves fewer than 160 threads.
  const bool wide = ft >= 64 && tile(8, dk_max_threads(k == 3 ? 3 : 0, 8)) &&
                    base * slices >= 160;
  if (!wide && !tile(4, kThreads)) return false;
  auto up16 = [](size_t n) { return (n + 15) / 16 * 16; };
  auto layout = [&](int tw) {
    p->wn = tw + span + 1;
    size_t off = sizeof(float) * 2 * static_cast<size_t>(p->wn) * cc;  // ywin
    p->off_s = static_cast<int>(off);
    off += sizeof(float) * static_cast<size_t>(tw) * mp;
    p->off_raw = static_cast<int>(off);
    off += up16(static_cast<size_t>(elem) * 2 * p->wn * cc);
    p->off_g = static_cast<int>(off);
    off += sizeof(float) * 2 * static_cast<size_t>(tw) * ft;
    const size_t red = sizeof(float) * static_cast<size_t>(slices - 1) * mp * ft;
    return off > red ? off : red;
  };
  const int wcap = (W + 7) / 8 * 8;
  int tw = wcap < 64 ? wcap : 64;
  size_t smem = layout(tw);
  if (tw > 32 && smem > 64 * 1024) smem = layout(tw = 32);
  p->cc = cc;
  p->taps = taps;
  p->groups = k * k / taps;
  p->k = k;
  p->ft = ft;
  p->chans = chans;
  p->mp = mp;
  p->slices = slices;
  p->tw = tw;
  p->chunks = (W + tw - 1) / tw;
  p->threads = base * slices;
  p->tiles = p->groups * (Cp / cc) * (F / ft);
  p->smem = static_cast<int>(smem);
  return smem <= 232448;
}

template <typename T, int KC, int CH>
cudaError_t launch_dk_plan(const DkPlan& p, const void* x, const void* g, const void* rows_tab,
                           const void* taps_tab, void* ws, int nsplit, int B, int H, int W,
                           int Cp, int F, cudaStream_t stream) {
  cudaError_t err = allow_smem(da_dk_kernel<T, KC, CH>, p.smem);
  if (err != cudaSuccess) return err;
  da_dk_kernel<T, KC, CH><<<dim3(p.tiles, nsplit), p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(g),
      static_cast<const int4*>(rows_tab), static_cast<const int2*>(taps_tab),
      static_cast<float*>(ws), B, H, W, Cp, F, p);
  return cudaGetLastError();
}

// Blocks of the K3/K6 instantiation that plan p launches resident on one
// SM at once (its registers and shared memory decide).
template <typename T, int KC, int CH>
cudaError_t resident_dk(const DkPlan& p, int* blocks) {
  cudaError_t err = allow_smem(da_dk_kernel<T, KC, CH>, p.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, da_dk_kernel<T, KC, CH>,
                                                       p.threads, p.smem);
}

template <typename T, int KC>
int launch_dk(const void* x, const void* g, const void* rows_tab, const void* taps_tab,
              void* ws, void* out, int nsplit, int B, int H, int W, int Cp, int F, int k,
              int taps, int span, cudaStream_t stream) {
  DkPlan p;
  if (!plan_dk(W, Cp, F, k, taps, span, sizeof(T), &p) || nsplit < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = (p.chans == 8 ? launch_dk_plan<T, KC, 8> : launch_dk_plan<T, KC, 4>)(
      p, x, g, rows_tab, taps_tab, ws, nsplit, B, H, W, Cp, F, stream);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(k) * k * Cp * F;
  const int threads = 256;
  da_dk_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                        stream>>>(static_cast<const float*>(ws), nsplit, n,
                                  static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 (k = 3) and K5 (any other odd k): x [B,H,W,Cp] and kern [k^2 Cp, F]
// of one dtype (bf16 when is_bf16, else float32; Cp a multiple of 4, the
// wrapper pads C with zero channels), bias [F] float32, out [B,H,W,F] in
// the dtype of x; the window tables rows [H, G, 4] and taps [H, k^2, 2]
// int32 with `taps` taps per group and their span
// (ops/distortion.py:window_tables_on); `rows` output rows a block, each
// thread 8 columns x `chans` (4 or 8) output channels.
// Returns the cudaError_t of the launch.
int skyhdr_da_fwd(const void* x, const void* kern, const void* bias, const void* rows_tab,
                  const void* taps_tab, void* out, int B, int H, int W, int Cp, int F,
                  int k, int taps, int span, int rows, int chans, int is_bf16, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = k == 3 ? (is_bf16 ? launch_fwd<__nv_bfloat16, 3> : launch_fwd<float, 3>)
                       : (is_bf16 ? launch_fwd<__nv_bfloat16, 0> : launch_fwd<float, 0>);
  return launch(x, kern, bias, rows_tab, taps_tab, out, B, H, W, Cp, F, k, taps, span, rows,
                chans, s);
}

// K1/K5: blocks per (image, group of `rows` output rows) of a launch with
// 8 x `chans` register tiles (column tiles x F tiles), or -1 when that
// does not tile W and F (fwd_tiles); the wrapper picks rows and chans.
int skyhdr_da_fwd_tiles(int W, int F, int rows, int chans) {
  int tw, ft;
  if (!fwd_tiles(W, F, rows, chans, &tw, &ft)) return -1;
  return ((W + tw - 1) / tw) * (F / ft);
}

// K2 (k = 3) and K7 (any other odd k): g [B,H,W,F] f32, kt [k^2,F,Cp] f32
// (K_t^T per tap; Cp = C rounded up to a multiple of 4, zero-padded; K2
// takes C % 4 == 0), dx [B,H,W,C] f32; the strip tables pint [n,4] i32,
// pflt [n,4] f32 and start [strips+1] i32 of `rows`-row strips
// (ops/distortion.py:strip_tables). F must be a multiple of 4.
int skyhdr_da_dx(const void* g, const void* kt, const void* pint,
                 const void* pflt, const void* start, int strips, int rows,
                 void* dx, int B, int H, int W, int C, int Cp, int F, int k,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3)
    return launch_dx<3>(g, kt, pint, pflt, start, strips, rows, dx, B, H, W, C, Cp, F, s);
  if (!odd_size(k)) return cudaErrorInvalidValue;
  return launch_dx<0>(g, kt, pint, pflt, start, strips, rows, dx, B, H, W, C, Cp, F, s);
}

// K2/K7: blocks per (image, strip) of a launch (column tiles x channel
// tiles), or -1 when the shape does not tile; the wrapper picks the strip
// height from it.
int skyhdr_da_dx_tiles(int W, int Cp, int F) {
  DxPlan p;
  if (!plan_dx(W, Cp, F, &p)) return -1;
  return ((W + p.tw - 1) / p.tw) * (Cp / p.ct);
}

// K3/K6 tiling of x [*, W, Cp] -> F at kernel size k over window tables
// of `taps` taps a group and this span (is_bf16: x's type): out[0] blocks
// per split, out[1] threads a block, out[2] blocks resident on one SM of
// card `device`, out[3] column chunks a (b, i) row. Returns 0, -1 when the
// shape does not tile, or a cudaError_t.
int skyhdr_da_dk_tiles(int W, int Cp, int F, int k, int taps, int span, int is_bf16,
                       int device, int* out) {
  DkPlan p;
  if (!plan_dk(W, Cp, F, k, taps, span, is_bf16 ? 2 : 4, &p)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  const bool k3 = k == 3, c8 = p.chans == 8;
  if (is_bf16)
    err = k3 ? (c8 ? resident_dk<__nv_bfloat16, 3, 8>(p, &blocks)
                   : resident_dk<__nv_bfloat16, 3, 4>(p, &blocks))
             : (c8 ? resident_dk<__nv_bfloat16, 0, 8>(p, &blocks)
                   : resident_dk<__nv_bfloat16, 0, 4>(p, &blocks));
  else
    err = k3 ? (c8 ? resident_dk<float, 3, 8>(p, &blocks) : resident_dk<float, 3, 4>(p, &blocks))
             : (c8 ? resident_dk<float, 0, 8>(p, &blocks) : resident_dk<float, 0, 4>(p, &blocks));
  if (err != cudaSuccess) return err;
  out[0] = p.tiles;
  out[1] = p.threads;
  out[2] = blocks;
  out[3] = p.chunks;
  return 0;
}

// K3 (k = 3) and K6 (any other odd k): x [B,H,W,Cp] (bf16 when is_bf16,
// else f32; Cp a multiple of 4, the wrapper pads C with zero channels), g
// [B,H,W,F] f32, the window tables rows [H, G, 4] and taps [H, k^2, 2]
// int32 with `taps` taps a group and their span (as for K1), ws
// [nsplit, k^2 Cp, F] f32 scratch, out [k^2 Cp, F] f32. Launches the
// partials over nsplit splits of the (b, i) rows' column chunks and the
// reduction in split order on `stream`; returns the cudaError_t.
int skyhdr_da_dk(const void* x, const void* g, const void* rows_tab, const void* taps_tab,
                 void* ws, void* out, int nsplit, int B, int H, int W, int Cp, int F, int k,
                 int taps, int span, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = k == 3 ? (is_bf16 ? launch_dk<__nv_bfloat16, 3> : launch_dk<float, 3>)
                       : (is_bf16 ? launch_dk<__nv_bfloat16, 0> : launch_dk<float, 0>);
  return launch(x, g, rows_tab, taps_tab, ws, out, nsplit, B, H, W, Cp, F, k, taps, span, s);
}

const char* skyhdr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
