// Fused CNN4-Omniglot block kernels for Hopper (sm_90a).
//
// One CNN4-Omniglot block is zero-pad -> 3x3 stride-2 conv + bias ->
// batch-statistics BN over (N, H, W) per channel (biased variance,
// eps 1e-5) -> scale/bias -> ReLU. Tensors are NHWC with HWIO weights and
// carry a leading task axis B: x [B,N,H,W,Ci], w [B,3,3,Ci,Co],
// b/scale/bias [B,Co]. Loads are f32 or bf16 (template T), all math is
// f32, and outputs are stored in T, as the TPU kernels do.
//
// What each kernel replaces (exploring_meta_tpu/pallas/cnn4_pallas.py):
//   cnn4_block_fwd        <- _blk_fwd_kernel / _blk_fwd_kernel_batched
//                            (_blk_fwd_call_single :295,
//                             _blk_fwd_pallas_batched :346), i.e.
//                            _block_fwd :116
//   cnn4_block_bwd_params <- the dy/dw/db/dscale/dbias half of
//                            _blk_bwd_kernel / _blk_bwd_kernel_batched
//                            (_blk_bwd_call_single :310,
//                             _blk_bwd_pallas_batched :364)
//   cnn4_block_bwd_input  <- the dx half of the same two kernels
//                            (_conv_s2_bwd :127, its lax.pad tap scatter)
//   cnn4_block_double_bwd <- none: the VJP of that backward, which JAX
//                            takes as plain XLA (_bwd_op_jvp :544); the
//                            last section of this file
// The single-task TPU forms are the B = 1 case here: at one task a call,
// at the shapes cluster_plan takes, the forward and bwd_params run
// fwd_cluster_kernel and bwd_params_cluster_kernel, one thread-block-
// cluster launch a block that keeps the task on chip (the last section
// below); every other call, and every batch, takes the tiled kernels.
//
// cnn4_block_fwd and cnn4_block_bwd_input: tiled implicit GEMMs.
//
// What bounds them. The reference runs its convs at Precision.HIGHEST and
// the port keeps TF32 off, so the math is full f32 FMAs on the CUDA cores
// (67 TFLOP/s on an H100 SXM at 700 W). At the served shapes both are
// bound by those operations, not by bytes: block 2 of a 64-request batch
// (14x14x64 -> 7x7x64, 25 images) is 5.2 GFLOP against 100 MB moved, 78 us
// against 30 us. What held the first versions of these kernels at ~0.5
// TFLOP/s was the inner loop: one serial FMA chain per output, each FMA
// paying a load from device memory, x re-read by each of 64 channel-CTAs,
// and channel-strided or uncoalesced loads and stores.
//
// What the design does about it:
// - One CTA owns a 64 x 64 output tile (kTileM positions x kTileN
//   channels) and loops over the reduction K in stages of kTileK = 16.
//   Each stage's A slice (16 input channels of one tap for the tile's 64
//   positions, gathered on the fly from the NHWC tensor: the implicit
//   GEMM) and B slice (16 rows of w) go to shared memory by 16-byte
//   cp.async into a ring of two stages, so stage c+1 is in flight while
//   stage c's FMAs run. A tap outside the image is zero-filled by the copy
//   itself, which is the padding. Each of 256 threads keeps a 4 x 4 tile of
//   f32 accumulators in registers and reads its operands as float4: 16
//   FMAs for every 2 shared loads, and 16 independent chains per thread.
// - These kernels are f32 only: bf16 takes the tensor cores (below).
// - Outputs go through a shared-memory tile, so each thread stores 4
//   contiguous channels of one position (16 bytes in f32).
// - Shapes the 16-byte path does not fit (Ci or Co not a multiple of the
//   stage, or an unaligned pointer: block 1 of the forward, Ci = 1) stage
//   element by element into the same tile; the product is the same.
//
// cnn4_block_fwd, three launches behind one call. Batch-statistics BN
// needs every position of a task before any output, and one task's conv
// output does not fit a CTA (block 2 at N = 25: 1225 x 64 x 4 B = 314
// KB). So:
//   A  fwd_conv_stats_kernel  conv + bias of one tile; per channel the
//      tile's count n_t, mean and centred sum of squares M2_t, taken in two
//      passes over the tile in shared memory (never E[y^2] - E[y]^2);
//   C  fwd_combine_kernel     per (task, channel), Chan's combine of the
//      tile statistics in tile order: mean = sum n_t mean_t / M,
//      M2 = sum M2_t + n_t (mean_t - mean)^2;
//   B  fwd_norm_kernel        relu((y - mean) * inv_std * scale + bias) of
//      one tile, stored in T.
// The combine is its own small launch: done inside every CTA of B, it
// would re-read all tile statistics of the task once per tile (4,928 CTAs
// x 39 KB at block 1 with N = 25, more than the output itself). y goes
// from A to B through an f32 scratch, which is the output buffer itself
// when T is f32. At block 1 (Ci = 1, N = 25) y is 80 MB against 5 MB of
// x, yet a B that recomputed the conv from x instead measured no faster
// there (PERF.md, Findings): block 1 is held by the fixed costs of its
// 4,928 small CTAs, not by bytes, and elsewhere recomputing doubles the
// FMAs.
//
// cnn4_block_bwd_input: the transposed stride-2 conv as four GEMMs. An
// input row hi takes tap row ty from output row i only where
// hi + 1 - ty = 2 i, so the input positions fall into four parity classes
// (hi % 2, wi % 2) with 4 taps (odd, odd), 2 (odd, even), 2 (even, odd)
// and 1 (even, even). Within one class dx is, per task, the GEMM
// [positions] x [taps*Co] times [taps*Co] x [Ci]: its A rows are whole dy
// rows (Co contiguous floats), its B is w[tap] read as [Ci][Co]. A CTA
// owns (task, class, 64 positions) x 64 input channels; the grid lists the
// heaviest class first. Every dx element is written by one thread: no
// atomics, as before.
//
// cnn4_block_bwd_params: dy, dw, db, dscale and dbias, the half of the TPU
// backward kernel that _block_fwd (the recompute), _block_bwd and the
// dw/db half of _conv_s2_bwd compute.
//
// What bounds it. At blocks 2-4 the operations: the recomputed conv and
// the dw GEMM, 4 FLOP per multiply-add of the forward, in f32 on the CUDA
// cores. At block 1 (Ci = 1) the bytes: g read and dy written, 80 MB each
// for a served batch of 64 (25 images), about 0.05 ms at 3.35 TB/s. The
// four served shapes sum to a 0.257 ms bound (H100 SXM, 700 W).
//
// What the design does about it: no CTA ever holds a whole task. One call
// is five launches (six where the positions are split):
//   1  kernels A and C of the forward, as they are: y = conv + bias into
//      an f32 scratch, and (mean, inv_std) per (task, channel),
//      bit-identical to the forward's statistics;
//   2  bwd_tile_sums_kernel  per tile of 64 positions x 64 channels, the
//      channel's sums of dz * xhat and dz over the tile, y and g read 16
//      bytes at a time, the row groups added in a fixed order;
//   3  bwd_combine_kernel    per (task, channel), those sums in tile order:
//      dscale, dbias and dy's constants m1 = scale * dbias / M, m2 = scale
//      * dscale / M;
//   4  bwd_dw_kernel         dw[(tap, ci), co] = sum_m x_tap(m, ci) dy(m,
//      co), per task a GEMM of 9 Ci rows and Co columns whose reduction
//      runs over the M positions. A CTA owns a 64 x 64 tile of dw and one
//      chunk of positions, staged 16 positions a stage into the same
//      two-stage ring: x gathered from the NHWC tensor as the forward's
//      conv_tile does (cp.async), dy formed in registers from y, g and the
//      constants, dy = inv_std (dz scale - m1 - xhat m2). The CTAs of the
//      first dw row tile also store dy (16 bytes a thread) and the chunk's
//      db. With one chunk the CTA stores dw and db; else its f32 partial;
//   5  bwd_dw_reduce_kernel  the chunk partials in chunk order -> dw, db.
// The positions are split into chunks only as far as it takes to give the
// card about 528 CTAs, two waves at two CTAs an SM (block 1: 64 tiles of
// dw in a batch, so 9 chunks; blocks 2-4: 576 tiles, one chunk).
//
// bf16: the conv of cnn4_block_fwd and of cnn4_block_bwd_params, the dw
// GEMM and the dx GEMMs of cnn4_block_bwd_input, on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 out).
//
// What bounds them. With the products on the tensor cores (989 TFLOP/s
// dense bf16 on an H100 SXM at 700 W) the forward's four served shapes
// take ~9 us of operations against a 37 us bytes bound, and bwd_params
// ~0.02 ms against 0.07: bytes set the floor. What held the bf16 kernels
// at 0.55 and 1.46 ms (B = 64, N = 25) was the f32 FMA design above. What
// holds them now: the f32 y scratch (block 1: 80 MB written, read back by
// kernel B, the tile sums and the dy pass) and the L2 traffic of 64 x 64
// tiles (the dw GEMM's nine row tiles each read all of dy's terms). dx
// reads dy (f32) and writes dx (bf16): 28.6 us of bytes at blocks 2-4 of a
// served batch, against 25 us of operations for its three MMAs a product.
//
// Precision. The reference upcasts bf16 inputs and contracts at HIGHEST in
// f32. A product of two bf16 is exact in f32, so the conv's MMAs (bf16 x
// and w) take the same products as f32 FMAs. dw's other operand, dy, is
// f32: it goes in as three bf16 terms, hi + mid + lo == dy (split3), three
// MMAs a k-step whose products are exact; so does dx's operand dy. The
// tensor cores round a running sum toward zero inside each MMA: left to
// accumulate a whole reduction, that moved 0.13-0.24 % of the bf16 dw
// elements off the twin's (PERF.md), so each stage's MMAs sum from zero
// and the stage's sum is added to the accumulator in f32.
//
// What the design does about it:
// - conv_tile_tc: a CTA owns 64 positions x 64 channels, 8 warps of 16 x
//   32, fed by ldmatrix (.trans for w's [k][n] rows). A stage is 32
//   channels of one tap: the gathered NHWC rows of A and the HWIO rows of B
//   go to shared memory as bf16 by 16-byte cp.async, zero-filled outside
//   the image (the padding), on a ring of 4 stages; rows padded to 80 and
//   144 bytes keep ldmatrix free of bank conflicts. Block 1 (Ci = 1, K = 9)
//   stages element by element into one k-step of 16. Kernel A
//   (fwd_conv_stats_tc_kernel) writes y and the tile statistics as the f32
//   kernel does (tile_y_stats); C and B are shared. A kernel B that
//   recomputed its tile from x instead of reading y measured no faster at
//   block 1 and slower at blocks 2-4 (PERF.md), so y stays.
// - cnn4_block_bwd_params: A and C as the forward, the tile sums and their
//   combine as in f32; then bwd_dy_split_kernel forms dy once per element
//   (the f32 output) and writes its three terms to the workspace, and
//   bwd_dw_tc_kernel (4 warps of 32 x 32, 32 positions a stage, a 4-stage
//   cp.async ring in 72 KB of dynamic shared memory) reads x as A with
//   ldmatrix.trans and the terms as B. Against dy formed in registers by
//   all nine row tiles, one stage ahead, that took bwd_params at block 2
//   from 0.40 to 0.23 ms (PERF.md). db is summed from the terms by the CTAs
//   of row tile 0; chunks and their reduce as in f32.
// - bwd_input_tc_kernel: the f32 kernel's four parity-class GEMMs and grid,
//   the CTA's 64 x 64 tile in conv_tile_tc's warp layout. A stage is 32
//   channels co of one tap: dy's rows loaded 16 bytes at a time into
//   registers a stage ahead (cp.async cannot convert), split into three
//   bf16 terms (split3x2) and stored as three A slices; w[tap] as it lies,
//   [ci][co], is the MMA's .col B operand, copied by cp.async and read by
//   ldmatrix without .trans. Two stages in 40 KB of static shared memory:
//   a 3-stage ring with dy loaded two or three stages ahead, and dy staged
//   unconverted by cp.async and split per MMA fragment, each measured
//   slower (PERF.md). It does not read the terms bwd_params wrote: they
//   are 6 bytes an element against dy's 4, and that workspace is gone by
//   then.
//
// Every sum has a fixed order (k or m ascending within a thread, the row
// groups, stages, tiles and chunks in order) and no result is summed with
// atomics, so results are deterministic.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Shape {
  int N, H, W, Ci, Co, Ho, Wo, M;  // M = N * Ho * Wo
};

// ---------------------------------------------------------------------------
// Tiled implicit GEMMs
// ---------------------------------------------------------------------------

constexpr int kTileM = 64;  // positions per CTA (cuda/cnn4_cuda.py:_TILE_M)
constexpr int kTileN = 64;  // channels per CTA: Co (forward), Ci (dx)
constexpr int kTileK = 16;  // reduction depth of one stage
constexpr int kLdK = kTileK + 4;  // row stride of a [row][k] slice: 16-byte
                                  // rows, conflict-free float4 reads
constexpr int kLdC = kTileN + 4;  // row stride of the output tile
constexpr int kSliceA = kTileM * kLdK;           // A slice [m][k]
constexpr int kStage = kSliceA + kTileN * kLdK;  // + B, [k][n] or [n][k]
constexpr int kRing = 2 * kStage;                // two stages, in floats
static_assert(kTileK * kTileN <= kTileN * kLdK, "B [k][n] fits its slice");
static_assert(kTileK * kTileM <= kSliceA, "A [k][m] fits its slice");
static_assert(kTileM * kLdC + 5 * kTileN <= kRing,
              "the epilogue's tile and reductions fit the ring");
static_assert(kThreads == 4 * kTileM && kThreads == 16 * kTileK,
              "one 16-byte piece of each slice per thread");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// p[0..3] as f32, one 16-byte load (8 bytes in bf16).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// A bf16 is the top half of the f32 with the same value; shifts, not the
// address of a local, so the words stay in registers.
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// p[0..3] as f32 for the channels below `limit` (the count of channels
// from p on), zeros past it: one load where `vec` says p is aligned.
template <typename T>
__device__ __forceinline__ float4 load_row4(const T* p, int limit, bool vec) {
  if (vec && limit >= 4) return ld4(p);
  return make_float4(limit > 0 ? ld(p) : 0.f, limit > 1 ? ld(p + 1) : 0.f,
                     limit > 2 ? ld(p + 2) : 0.f, limit > 3 ? ld(p + 3) : 0.f);
}

// dst[0..3] <- src[0..3], or zeros where !valid (src is then not read):
// one 16-byte cp.async.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool valid) {
  __pipeline_memcpy_async(dst, src, 16, valid ? 0 : 16);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  auto bits = [](float a) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a));
  };
  uint2 raw;
  raw.x = bits(v.x) | bits(v.y) << 16;
  raw.y = bits(v.z) | bits(v.w) << 16;
  *reinterpret_cast<uint2*>(p) = raw;
}

// p[0..3] <- v[0..3] for the channels below `limit` (the count of
// channels from p on): 16 bytes at once where `vec` says p is aligned.
template <typename T>
__device__ __forceinline__ void store_row4(T* p, float4 v, int limit,
                                           bool vec) {
  if (vec && limit >= 4) {
    st4(p, v);
  } else {
    for (int u = 0; u < 4 && u < limit; ++u) st(p + u, f4(v, u));
  }
}

// One stage of A [m][k] x B [k][n]: acc[r][c] += sum_k A[4ty+r][k] *
// B[k][4tx+c], k ascending.
__device__ __forceinline__ void mma_nn(const float* A, const float* Bk,
                                       float (&acc)[4][4], int tx, int ty) {
#pragma unroll
  for (int k = 0; k < kTileK; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (4 * ty + r) * kLdK + k);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      b[q] = *reinterpret_cast<const float4*>(Bk + (k + q) * kTileN + 4 * tx);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(f4(a[r], q), f4(b[q], c), acc[r][c]);
  }
}

// One stage of A [m][k] x Bt [n][k]^T: acc[r][c] += sum_k A[4ty+r][k] *
// Bt[tx+16c][k], k ascending. Columns tx + 16c keep the float4 reads of Bt
// (row stride kLdK) free of bank conflicts.
__device__ __forceinline__ void mma_nt(const float* A, const float* Bt,
                                       float (&acc)[4][4], int tx, int ty) {
#pragma unroll
  for (int k = 0; k < kTileK; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + (4 * ty + r) * kLdK + k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * c) * kLdK + k);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(f4(a[r], q), f4(b[c], q), acc[r][c]);
  }
}

// One stage of At [k][m] x Bt [k][n], both reduction-major (the dw GEMM:
// k is a position, m a row (tap, ci) of dw): acc[r][c] += sum_k
// At[k][4ty+r] * Bt[k][4tx+c], k ascending.
__device__ __forceinline__ void mma_tn(const float* At, const float* Bt,
                                       float (&acc)[4][4], int tx, int ty) {
#pragma unroll
  for (int k = 0; k < kTileK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(At + k * kTileM + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(Bt + k * kTileN + 4 * tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] = fmaf(f4(a, r), f4(b, c), acc[r][c]);
  }
}

// The K loop over nk stages on the ring: stage(c, buf) issues the copies
// of stage c into buf, mma(buf) consumes it. Stage c + 1 is in flight
// while stage c is consumed. Ends on a barrier, so the ring is free.
template <class Stage, class Mma>
__device__ __forceinline__ void k_loop(int nk, float* ring, Stage stage,
                                       Mma mma) {
  stage(0, ring);
  __pipeline_commit();
  for (int c = 0; c < nk; ++c) {
    if (c + 1 < nk) {
      stage(c + 1, ring + ((c + 1) & 1) * kStage);  // freed by c - 1
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    mma(ring + (c & 1) * kStage);
    __syncthreads();
  }
}

// The conv of one forward tile: acc[r][c] = sum_k A[m0+4ty+r][k] *
// w[k][co0+4tx+c] over K = 9 Ci, k = tap*Ci + ci, where A[m][k] =
// x[n, 2i+ty-1, 2j+tx-1, ci] for m = (n, i, j), zero outside the image.
// kVec: a stage is 16 channels of one tap, copied 16 bytes at a time.
// f32 only: bf16 takes conv_tile_tc.
template <bool kVec>
__device__ __forceinline__ void conv_tile(const float* __restrict__ x,
                                          const float* __restrict__ w,
                                          const Shape& s, int m0, int co0,
                                          float* ring, float (&acc)[4][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int K = 9 * s.Ci;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  auto mma = [&](const float* buf) { mma_nn(buf, buf + kSliceA, acc, tx, ty); };
  if constexpr (kVec) {
    const int row = tid >> 2, q = tid & 3;              // A piece
    const int bk = tid >> 4, bc = 4 * (tid & 15);       // B piece
    const int m = m0 + row;
    const bool in = m < s.M;
    const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
    const float* xn = x + (in ? (size_t)n * s.H * s.W * s.Ci : 0);
    const bool bin = co0 + bc < s.Co;
    k_loop(K / kTileK, ring, [&](int c, float* buf) {
      const int k0 = c * kTileK, tap = k0 / s.Ci, ci0 = k0 - tap * s.Ci;
      const int hi = 2 * i + tap / 3 - 1, wi = 2 * j + tap % 3 - 1;
      const bool ok = in && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
      stage4(buf + row * kLdK + 4 * q,
             ok ? xn + ((size_t)hi * s.W + wi) * s.Ci + ci0 + 4 * q : x, ok);
      stage4(buf + kSliceA + bk * kTileN + bc,
             bin ? w + (size_t)(k0 + bk) * s.Co + co0 + bc : w, bin);
    }, mma);
  } else {
    k_loop(cdiv(K, kTileK), ring, [&](int c, float* buf) {
      const int k0 = c * kTileK;
      for (int e = tid; e < kTileM * kTileK; e += kThreads) {
        const int row = e / kTileK, k = k0 + e % kTileK, m = m0 + row;
        float v = 0.f;
        if (k < K && m < s.M) {
          const int tap = k / s.Ci, ci = k - tap * s.Ci;
          const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
          const int hi = 2 * i + tap / 3 - 1, wi = 2 * j + tap % 3 - 1;
          if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W)
            v = ld(x + (((size_t)n * s.H + hi) * s.W + wi) * s.Ci + ci);
        }
        buf[row * kLdK + e % kTileK] = v;
      }
      for (int e = tid; e < kTileK * kTileN; e += kThreads) {
        const int k = k0 + e / kTileN, co = co0 + e % kTileN;
        buf[kSliceA + e] =
            (k < K && co < s.Co) ? ld(w + (size_t)k * s.Co + co) : 0.f;
      }
    }, mma);
  }
}

// The epilogue of kernel A: C [kTileM][kLdC] holds the tile's y (conv +
// bias, f32). Its rows go to yout[b][m][co]; per channel its mean and
// centred sum of squares over the tile's rows ->
// tstats[b][tile][co] = (mean_t, M2_t): 4 groups of 16 rows each, then the
// groups in order; the mean first, then the centred squares. The caller
// has synced after writing C.
__device__ __forceinline__ void tile_y_stats(float* C, float* yout,
                                             float2* __restrict__ tstats,
                                             const Shape& s, int t, int tile,
                                             int co0, int rows) {
  const int tid = threadIdx.x, m0 = tile * kTileM;
  yout += (size_t)t * s.M * s.Co;
  const bool vec = (s.Co & 3) == 0;
  for (int e = tid; e < kTileM * kTileN / 4; e += kThreads) {
    const int row = e >> 4, col = 4 * (e & 15);
    if (row < rows && co0 + col < s.Co)
      store_row4(yout + (size_t)(m0 + row) * s.Co + co0 + col,
                 *reinterpret_cast<const float4*>(C + row * kLdC + col),
                 s.Co - co0 - col, vec);
  }
  float* red = C + kTileM * kLdC;  // [4][kTileN]
  float* mean = red + 4 * kTileN;  // [kTileN]
  const int col = tid & (kTileN - 1), part = tid / kTileN;
  const int r0 = part * (kTileM / 4), r1 = min(r0 + kTileM / 4, rows);
  float a = 0.f;
  for (int r = r0; r < r1; ++r) a += C[r * kLdC + col];
  red[part * kTileN + col] = a;
  __syncthreads();
  if (tid < kTileN)
    mean[col] = (red[col] + red[kTileN + col] + red[2 * kTileN + col] +
                 red[3 * kTileN + col]) / rows;
  __syncthreads();
  const float mu = mean[col];
  a = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float d = C[r * kLdC + col] - mu;
    a += d * d;
  }
  red[part * kTileN + col] = a;
  __syncthreads();
  if (tid < kTileN && co0 + col < s.Co)
    tstats[((size_t)t * gridDim.x + tile) * s.Co + co0 + col] =
        make_float2(mu, red[col] + red[kTileN + col] + red[2 * kTileN + col] +
                            red[3 * kTileN + col]);
}

// Kernel A of the forward in f32 (bf16: fwd_conv_stats_tc_kernel). grid
// (tiles, ceil(Co/64), B). The conv plus bias of one tile -> yout[b][m][co]
// (f32) and the tile's statistics (tile_y_stats).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fwd_conv_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ yout,
                      float2* __restrict__ tstats, Shape s) {
  __shared__ __align__(16) float ring[kRing];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tile = blockIdx.x, co0 = blockIdx.y * kTileN, t = blockIdx.z;
  const int m0 = tile * kTileM, rows = min(kTileM, s.M - m0);
  x += (size_t)t * s.N * s.H * s.W * s.Ci;
  w += (size_t)t * 9 * s.Ci * s.Co;
  b += (size_t)t * s.Co;
  float acc[4][4];
  conv_tile<kVec>(x, w, s, m0, co0, ring, acc);

  float* C = ring;  // [kTileM][kLdC]: y of the tile
  float bias[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int co = co0 + 4 * tx + c;
    bias[c] = co < s.Co ? ld(b + co) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    st4(C + (4 * ty + r) * kLdC + 4 * tx,
        make_float4(acc[r][0] + bias[0], acc[r][1] + bias[1],
                    acc[r][2] + bias[2], acc[r][3] + bias[3]));
  __syncthreads();
  tile_y_stats(C, yout, tstats, s, t, tile, co0, rows);
}

// grid (ceil(Co/64), B), one thread per (task, channel): Chan's combine of
// the tile statistics, tiles in order,
//   mean = sum n_t mean_t / M,  M2 = sum M2_t + n_t (mean_t - mean)^2,
// -> stats[b][co] = (mean, 1 / sqrt(M2 / M + eps)).
__global__ void __launch_bounds__(kTileN)
fwd_combine_kernel(const float2* __restrict__ tstats,
                   float2* __restrict__ stats, int ntiles, Shape s) {
  const int co = blockIdx.x * kTileN + threadIdx.x, t = blockIdx.y;
  if (co >= s.Co) return;
  const float2* ts = tstats + (size_t)t * ntiles * s.Co + co;
  float sum = 0.f;
  for (int k = 0; k < ntiles; ++k)
    sum += (float)min(kTileM, s.M - k * kTileM) * ts[(size_t)k * s.Co].x;
  const float mu = sum / s.M;
  float m2 = 0.f;
  for (int k = 0; k < ntiles; ++k) {
    const float2 v = ts[(size_t)k * s.Co];
    const float d = v.x - mu;
    m2 += v.y + (float)min(kTileM, s.M - k * kTileM) * d * d;
  }
  stats[(size_t)t * s.Co + co] = make_float2(mu, rsqrtf(m2 / s.M + kEps));
}

// par[0..3][c] <- mean, inv_std, scale and bias of channel co0 + c of task
// t (zeros past Co), by the first kTileN threads; the caller syncs.
template <typename T>
__device__ __forceinline__ void load_bn_par(float (*par)[kTileN],
                                            const float2* stats, const T* sc,
                                            const T* be, int t, int co0,
                                            const Shape& s) {
  const int c = threadIdx.x;
  if (c >= kTileN) return;
  const bool in = co0 + c < s.Co;
  const size_t pc = (size_t)t * s.Co + co0 + c;
  const float2 st2 = in ? stats[pc] : make_float2(0.f, 0.f);
  par[0][c] = st2.x;
  par[1][c] = st2.y;
  par[2][c] = in ? ld(sc + pc) : 0.f;
  par[3][c] = in ? ld(be + pc) : 0.f;
}

// Kernel B of the forward. grid as kernel A: out = relu((y - mean) *
// inv_std * scale + bias) for one tile. yin may be out itself (T = f32):
// each element is read and then written by the same thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_norm_kernel(const T* __restrict__ sc, const T* __restrict__ be,
                const float* yin, const float2* __restrict__ stats, T* out,
                Shape s) {
  __shared__ float par[4][kTileN];  // mean, inv_std, scale, bias
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, co0 = blockIdx.y * kTileN, t = blockIdx.z;
  const int m0 = tile * kTileM, rows = min(kTileM, s.M - m0);
  load_bn_par(par, stats, sc, be, t, co0, s);
  __syncthreads();
  auto bn = [&](float y, int col) {
    return fmaxf((y - par[0][col]) * par[1][col] * par[2][col] + par[3][col],
                 0.f);
  };
  const size_t base = (size_t)t * s.M * s.Co;
  const bool vec = (s.Co & 3) == 0;
  for (int e = tid; e < kTileM * kTileN / 4; e += kThreads) {
    const int row = e >> 4, col = 4 * (e & 15);
    if (row >= rows || co0 + col >= s.Co) continue;
    const size_t off = base + (size_t)(m0 + row) * s.Co + co0 + col;
    const int limit = s.Co - co0 - col;
    const float4 y = load_row4(yin + off, limit, vec);
    store_row4(out + off,
               make_float4(bn(y.x, col), bn(y.y, col + 1), bn(y.z, col + 2),
                           bn(y.w, col + 3)),
               limit, vec);
  }
}

// Parity classes of the input positions, in grid order (heaviest first):
// class 0 (odd, odd) 4 taps, 1 (odd, even) 2, 2 (even, odd) 2, 3 (even,
// even) 1. Input row hi = 2a + ph; along an axis of parity 0 the one tap
// is ty = 1 from output row a, of parity 1 the taps are ty = 0 from row
// a + 1 and ty = 2 from row a (the first may fall off the end: zero).
__host__ __device__ inline int class_extent(int extent, int parity) {
  return (extent - parity + 1) / 2;
}
__host__ __device__ inline int class_ph(int cls) { return cls < 2 ? 1 : 0; }
__host__ __device__ inline int class_pw(int cls) { return (cls & 1) ? 0 : 1; }

// The CTA's parity class of cnn4_block_bwd_input: blockIdx.x counts the
// tiles of kTileM positions of all four classes, heaviest first. -> the
// class, its tile, its extents hc x wc and its P = N hc wc positions.
struct DxClass {
  int cls, tile, hc, wc, P;
};
__device__ __forceinline__ DxClass dx_class(const Shape& s) {
  DxClass c{0, (int)blockIdx.x, 0, 0, 0};
  for (; c.cls < 4; ++c.cls) {
    c.hc = class_extent(s.H, class_ph(c.cls));
    c.wc = class_extent(s.W, class_pw(c.cls));
    c.P = s.N * c.hc * c.wc;
    if (c.tile < cdiv(c.P, kTileM)) break;
    c.tile -= cdiv(c.P, kTileM);
  }
  return c;
}

// Stage c of a class's K loop, `width` channels co a stage and nco stages a
// tap: tap u = c / nco of the class, channels co0 .. co0 + width - 1. Tap
// (ky, kx) of the class is w[wtap] read from dy[n, a + di, b + dj].
struct DxTap {
  int wtap, di, dj, co0;
};
__device__ __forceinline__ DxTap dx_tap(int c, int nco, int ph, int pw,
                                        int width) {
  const int ntx = 1 + pw, u = c / nco, ky = u / ntx, kx = u - ky * ntx;
  DxTap tp;
  tp.wtap = (ph ? 2 * ky : 1) * 3 + (pw ? 2 * kx : 1);
  tp.di = ph ? 1 - ky : 0;
  tp.dj = pw ? 1 - kx : 0;
  tp.co0 = (c - u * nco) * width;
  return tp;
}

// cnn4_block_bwd_input in f32 (bf16: bwd_input_tc_kernel). grid (tiles of
// all four classes, ceil(Ci/64), B). dx[n, hi, wi, ci] = sum over the
// class's taps (ty, tx) and co of dy[n, i, j, co] * w[ty, tx, ci, co].
// kVec (Co % 16 == 0): a stage is 16 channels co of one tap, copied 16
// bytes at a time.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bwd_input_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                 float* __restrict__ dx, Shape s) {
  __shared__ __align__(16) float ring[kRing];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ci0 = blockIdx.y * kTileN, t = blockIdx.z;
  const DxClass dc = dx_class(s);
  const int cls = dc.cls, tile = dc.tile, hc = dc.hc, wc = dc.wc, P = dc.P;
  const int ph = class_ph(cls), pw = class_pw(cls);
  const int ntaps = (1 + ph) * (1 + pw);
  const int p0 = tile * kTileM;
  const int nco = cdiv(s.Co, kTileK);  // stages per tap
  dy += (size_t)t * s.M * s.Co;
  w += (size_t)t * 9 * s.Ci * s.Co;
  dx += (size_t)t * s.N * s.H * s.W * s.Ci;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  auto mma = [&](const float* buf) { mma_nt(buf, buf + kSliceA, acc, tx, ty); };
  auto tap_of = [&](int c) { return dx_tap(c, nco, ph, pw, kTileK); };
  if constexpr (kVec) {
    const int row = tid >> 2, q = tid & 3;  // A piece; B piece: ci row `row`
    const int p = p0 + row;
    const bool in = p < P;
    const int bb = p % wc, a = (p / wc) % hc, n = p / (wc * hc);
    const float* dyn = dy + (in ? (size_t)n * s.Ho * s.Wo * s.Co : 0);
    const bool bin = ci0 + row < s.Ci;
    k_loop(ntaps * nco, ring, [&](int c, float* buf) {
      const DxTap tp = tap_of(c);
      const int i = a + tp.di, j = bb + tp.dj;
      const bool ok = in && i < s.Ho && j < s.Wo;
      stage4(buf + row * kLdK + 4 * q,
             ok ? dyn + ((size_t)i * s.Wo + j) * s.Co + tp.co0 + 4 * q : dy,
             ok);
      stage4(buf + kSliceA + row * kLdK + 4 * q,
             bin ? w + ((size_t)tp.wtap * s.Ci + ci0 + row) * s.Co + tp.co0 +
                       4 * q
                 : w,
             bin);
    }, mma);
  } else {
    k_loop(ntaps * nco, ring, [&](int c, float* buf) {
      const DxTap tp = tap_of(c);
      for (int e = tid; e < kTileM * kTileK; e += kThreads) {
        const int row = e / kTileK, co = tp.co0 + e % kTileK, p = p0 + row;
        float v = 0.f;
        if (p < P && co < s.Co) {
          const int j = p % wc + tp.dj, i = (p / wc) % hc + tp.di;
          const int n = p / (wc * hc);
          if (i < s.Ho && j < s.Wo)
            v = dy[(((size_t)n * s.Ho + i) * s.Wo + j) * s.Co + co];
        }
        buf[row * kLdK + e % kTileK] = v;
      }
      for (int e = tid; e < kTileN * kTileK; e += kThreads) {
        const int ci = ci0 + e / kTileK, co = tp.co0 + e % kTileK;
        buf[kSliceA + (e / kTileK) * kLdK + e % kTileK] =
            (ci < s.Ci && co < s.Co)
                ? ld(w + ((size_t)tp.wtap * s.Ci + ci) * s.Co + co)
                : 0.f;
      }
    }, mma);
  }

  // through the tile: each thread then stores 4 contiguous channels
  float* C = ring;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      C[(4 * ty + r) * kLdC + tx + 16 * c] = acc[r][c];
  __syncthreads();
  const bool vec = (s.Ci & 3) == 0;
  for (int e = tid; e < kTileM * kTileN / 4; e += kThreads) {
    const int row = e >> 4, col = 4 * (e & 15), p = p0 + row;
    if (p >= P || ci0 + col >= s.Ci) continue;
    const int bb = p % wc, a = (p / wc) % hc, n = p / (wc * hc);
    const size_t pos = ((size_t)n * s.H + 2 * a + ph) * s.W + 2 * bb + pw;
    store_row4(dx + pos * s.Ci + ci0 + col,
               *reinterpret_cast<const float4*>(C + row * kLdC + col),
               s.Ci - ci0 - col, vec);
  }
}

// The BN + ReLU backward of one element (_block_bwd): xhat = (y - mean) *
// inv_std, and -> dz = g * [xhat * scale + bias > 0]. The one definition
// of the mask for the tile sums and for dy.
__device__ __forceinline__ float bn_dz(float y, float g, float mean,
                                       float inv, float scale, float bias,
                                       float& xh) {
  xh = (y - mean) * inv;
  return fmaf(xh, scale, bias) > 0.f ? g : 0.f;
}

// Step 2 of cnn4_block_bwd_params. grid (tiles, ceil(Co/64), B). Per
// channel of one tile, sum dz * xhat and sum dz -> tsums[b][tile][co].
// Thread (rg, q) takes rows rg, rg + 16, .. of channels 4q .. 4q + 3,
// reading y and g 16 bytes at a time where `vec`; then the 16 row groups
// are added in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_tile_sums_kernel(const T* __restrict__ sc, const T* __restrict__ be,
                     const T* __restrict__ g, const float* __restrict__ y,
                     const float2* __restrict__ stats,
                     float2* __restrict__ tsums, bool vec, Shape s) {
  constexpr int kGroups = kThreads / (kTileN / 4);
  __shared__ float par[4][kTileN];  // mean, inv_std, scale, bias
  __shared__ float red[2][kGroups][kTileN];
  const int tid = threadIdx.x, col = 4 * (tid & 15), rg = tid >> 4;
  const int tile = blockIdx.x, co0 = blockIdx.y * kTileN, t = blockIdx.z;
  const int m0 = tile * kTileM, rows = min(kTileM, s.M - m0);
  const int limit = s.Co - co0 - col;
  load_bn_par(par, stats, sc, be, t, co0, s);
  __syncthreads();
  float sx[4] = {0.f, 0.f, 0.f, 0.f}, sz[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = rg; r < rows && limit > 0; r += kGroups) {
    const size_t off = ((size_t)t * s.M + m0 + r) * s.Co + co0 + col;
    const float4 yv = load_row4(y + off, limit, vec);
    const float4 gv = load_row4(g + off, limit, vec);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xh;
      const float dz = bn_dz(f4(yv, u), f4(gv, u), par[0][col + u],
                             par[1][col + u], par[2][col + u],
                             par[3][col + u], xh);
      sx[u] += dz * xh;
      sz[u] += dz;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    red[0][rg][col + u] = sx[u];
    red[1][rg][col + u] = sz[u];
  }
  __syncthreads();
  if (tid < kTileN && co0 + tid < s.Co) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < kGroups; ++r) {
      a += red[0][r][tid];
      b += red[1][r][tid];
    }
    tsums[((size_t)t * gridDim.x + tile) * s.Co + co0 + tid] =
        make_float2(a, b);
  }
}

// Step 3. grid (ceil(Co/64), B), one thread per (task, channel): the tile
// sums in tile order -> dscale, dbias, and dy's constants in consts[b][co]
// = (m1, m2): m1 = scale * dbias / M = mean(dxhat), m2 = scale * dscale /
// M = mean(dxhat * xhat), dxhat = dz * scale.
template <typename T>
__global__ void __launch_bounds__(kTileN)
bwd_combine_kernel(const float2* __restrict__ tsums, const T* __restrict__ sc,
                   float2* __restrict__ consts, T* __restrict__ dsc,
                   T* __restrict__ dbe, int ntiles, Shape s) {
  const int co = blockIdx.x * kTileN + threadIdx.x, t = blockIdx.y;
  if (co >= s.Co) return;
  const float2* ts = tsums + (size_t)t * ntiles * s.Co + co;
  float ds = 0.f, db = 0.f;
  for (int k = 0; k < ntiles; ++k) {
    const float2 v = ts[(size_t)k * s.Co];
    ds += v.x;
    db += v.y;
  }
  const size_t pc = (size_t)t * s.Co + co;
  st(dsc + pc, ds);
  st(dbe + pc, db);
  const float scale = ld(sc + pc);
  consts[pc] = make_float2(scale * db / s.M, scale * ds / s.M);
}

// Step 4 in f32 (bf16: bwd_dy_split_kernel and bwd_dw_tc_kernel). grid
// (chunks, dw row tiles x column tiles, B). dw[k][co] = sum
// over the chunk's positions m of x_tap(m, ci) * dy(m, co), k = tap * Ci
// + ci, for the CTA's 64 x 64 tile of dw. A stage is 16 positions: the x
// slice [m][k] gathered as conv_tile gathers it (kVec: Ci % 4 == 0, each
// thread's 4 values of k lie in one tap, one 16-byte piece; else element
// by element, only the rows k < K, and threads whose rows all lie past K
// skip the FMAs: block 1 has 9 rows), the dy slice [m][co] formed in
// registers from y and g. The CTAs of dw row tile 0 also
// store dy and sum the chunk's db. With one chunk (gridDim.x == 1) the CTA
// stores dw and db; else the f32 partial part[b][chunk] = (dw [K][Co],
// db [Co]). At least two CTAs an SM, as dw_chunk's grid of kDwCtas assumes.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dw_kernel(const float* __restrict__ x, const float* __restrict__ sc,
              const float* __restrict__ be, const float* __restrict__ g,
              const float* __restrict__ y, const float2* __restrict__ stats,
              const float2* __restrict__ consts, float* __restrict__ dy,
              float* __restrict__ dw, float* __restrict__ db,
              float* __restrict__ part, int chunk, bool vec, Shape s) {
  __shared__ __align__(16) float ring[kRing];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, col = 4 * tx;
  const int K = 9 * s.Ci, nct = cdiv(s.Co, kTileN), nchunks = gridDim.x;
  const int ch = blockIdx.x, t = blockIdx.z;
  const int k0 = blockIdx.y / nct * kTileM, co0 = blockIdx.y % nct * kTileN;
  const bool first = k0 == 0;
  const int mb = ch * chunk, me = min(mb + chunk, s.M);
  const int limit = s.Co - co0 - col;  // channels from this thread's column
  const size_t row0 = (size_t)t * s.M;  // this task's rows of y, g and dy
  x += (size_t)t * s.N * s.H * s.W * s.Ci;

  // this thread's 4 channels: mean, inv_std, scale, bias, m1, m2
  float pm[4], pi[4], ps[4], pb[4], p1[4], p2[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool in = u < limit;
    const size_t pc = (size_t)t * s.Co + co0 + col + u;
    const float2 st2 = in ? stats[pc] : make_float2(0.f, 0.f);
    const float2 c2 = in ? consts[pc] : make_float2(0.f, 0.f);
    pm[u] = st2.x;
    pi[u] = st2.y;
    ps[u] = in ? ld(sc + pc) : 0.f;
    pb[u] = in ? ld(be + pc) : 0.f;
    p1[u] = c2.x;
    p2[u] = c2.y;
  }

  // x slice: row ty of a stage is position m0 + ty; kVec: its piece is
  // k = k0 + col .. + 3, one tap (dty, dtx) and channels ci .. ci + 3
  const int ka = k0 + col, tap = ka / s.Ci, ci = ka - tap * s.Ci;
  const int dty = tap / 3 - 1, dtx = tap % 3 - 1;
  const bool kin = ka < K;
  const int kw = min(kTileM, K - k0);  // rows of dw in this tile (block 1: 9)
  auto stage_x = [&](int m0, float* buf) {
    if constexpr (kVec) {
      const int m = m0 + ty;
      const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
      const int hi = 2 * i + dty, wi = 2 * j + dtx;
      const bool ok =
          kin && m < me && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
      stage4(buf + ty * kTileM + col,
             ok ? x + (((size_t)n * s.H + hi) * s.W + wi) * s.Ci + ci : x, ok);
    } else {  // the rows k < K only: the others stay zero
      for (int e = tid; e < kTileK * kw; e += kThreads) {
        const int row = e / kw, kk = e - row * kw;
        const int m = m0 + row, k = k0 + kk;
        float v = 0.f;
        if (m < me) {
          const int tp = k / s.Ci, c = k - tp * s.Ci;
          const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
          const int hi = 2 * i + tp / 3 - 1, wi = 2 * j + tp % 3 - 1;
          if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W)
            v = ld(x + (((size_t)n * s.H + hi) * s.W + wi) * s.Ci + c);
        }
        buf[row * kTileM + kk] = v;
      }
    }
  };

  // dy slice: row ty of a stage, channels co0 + col .. + 3. load_dy issues
  // the loads of y and g; stage_dy forms dy from them after the stage's
  // FMAs, so the loads are in flight meanwhile.
  float4 yv, gv;
  float dbacc[4] = {0.f, 0.f, 0.f, 0.f};
  auto load_dy = [&](int m0) {
    const int m = m0 + ty;
    yv = gv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < me && limit > 0) {
      const size_t off = (row0 + m) * s.Co + co0 + col;
      yv = load_row4(y + off, limit, vec);
      gv = load_row4(g + off, limit, vec);
    }
  };
  auto stage_dy = [&](int m0, float* buf) {
    const int m = m0 + ty;
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xh;
      const float dz =
          bn_dz(f4(yv, u), f4(gv, u), pm[u], pi[u], ps[u], pb[u], xh);
      d[u] = m < me ? pi[u] * (fmaf(dz, ps[u], -p1[u]) - xh * p2[u]) : 0.f;
    }
    const float4 dv = make_float4(d[0], d[1], d[2], d[3]);
    if (first && m < me && limit > 0) {
      store_row4(dy + (row0 + m) * s.Co + co0 + col, dv, limit, vec);
#pragma unroll
      for (int u = 0; u < 4; ++u) dbacc[u] += d[u];
    }
    st4(buf + kSliceA + ty * kTileN + col, dv);
  };

  // the reduction over the chunk: stage c + 1's copies and loads are in
  // flight while stage c's FMAs run; one barrier a stage
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const int nk = cdiv(me - mb, kTileK);
  if (!kVec && kw < kTileM) {  // x rows past K: zero in both stages, once
    for (int e = tid; e < kTileK * kTileM; e += kThreads)
      ring[e] = ring[kStage + e] = 0.f;
    __syncthreads();
  }
  stage_x(mb, ring);
  __pipeline_commit();
  load_dy(mb);
  stage_dy(mb, ring);
  for (int c = 0; c < nk; ++c) {
    float* cur = ring + (c & 1) * kStage;
    float* nxt = ring + ((c + 1) & 1) * kStage;  // last read in stage c - 1
    const int mn = mb + (c + 1) * kTileK;
    const bool more = c + 1 < nk;
    __pipeline_wait_prior(0);
    __syncthreads();
    if (more) {
      stage_x(mn, nxt);
      __pipeline_commit();
      load_dy(mn);
    }
    if (4 * ty < kw) mma_tn(cur, cur + kSliceA, acc, tx, ty);
    if (more) stage_dy(mn, nxt);
  }

  // dw rows k0 + 4ty + r, channels co0 + col .. + 3
  const bool vw = (s.Co & 3) == 0;
  float* dwt = dw + (size_t)t * K * s.Co;
  float* pt = part + ((size_t)t * nchunks + ch) * ((size_t)K * s.Co + s.Co);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + 4 * ty + r;
    if (k >= K || limit <= 0) continue;
    const float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    const size_t off = (size_t)k * s.Co + co0 + col;
    if (nchunks == 1)
      store_row4(dwt + off, v, limit, vw);
    else
      store_row4(pt + off, v, limit, vw);
  }
  if (!first) return;
  // db over the chunk: the 16 row groups of each channel, in order
  __syncthreads();  // the last stage's FMAs are done with the ring
  float* red = ring;  // [kTileK][kTileN]
#pragma unroll
  for (int u = 0; u < 4; ++u) red[ty * kTileN + col + u] = dbacc[u];
  __syncthreads();
  if (tid < kTileN && co0 + tid < s.Co) {
    float a = 0.f;
    for (int r = 0; r < kTileK; ++r) a += red[r * kTileN + tid];
    if (nchunks == 1)
      st(db + (size_t)t * s.Co + co0 + tid, a);
    else
      pt[(size_t)K * s.Co + co0 + tid] = a;
  }
}

// Step 5, where the positions were split: dw and db are the chunk
// partials summed in chunk order, one thread per output.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dw_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                     T* __restrict__ db, int nchunks, int B, Shape s) {
  const size_t kco = (size_t)9 * s.Ci * s.Co, len = kco + s.Co;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)B * len) return;
  const size_t t = e / len, i = e - t * len;
  const float* p = part + t * nchunks * len + i;
  float a = 0.f;
  for (int c = 0; c < nchunks; ++c) a += p[(size_t)c * len];
  if (i < kco)
    st(dw + t * kco + i, a);
  else
    st(db + t * s.Co + (i - kco), a);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the conv tile of the forward (kernel A)
// and the dw GEMM of cnn4_block_bwd_params
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcK = 32;       // reduction depth of one conv stage (2 MMA k-steps)
constexpr int kTcStages = 4;   // the conv's cp.async ring
constexpr int kLdA = kTcK + 8;     // bf16 row stride of A [m][k]: 80 B
constexpr int kLdB = kTileN + 8;   // bf16 row stride of a [k][n] slice: 144 B
// (both strides put the 8 rows an ldmatrix phase reads in 8 distinct
// 16-byte bank groups)
constexpr int kTcSliceA = kTileM * kLdA;           // bf16 elements
constexpr int kTcStage = kTcSliceA + kTcK * kLdB;  // + B [k][n]
constexpr int kTcRing = kTcStages * kTcStage;      // 38,912 bytes
static_assert(kTileM * kLdC * 4 + 5 * kTileN * 4 <= kTcRing * 2,
              "the epilogue's tile and reductions fit the conv ring");
static_assert(kThreads == 8 * kTcK && kThreads == 4 * kTileM,
              "one 16-byte piece of each conv slice per thread");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8; register j of lane l holds row l / 4, columns
// 2 (l % 4) .. + 1 of matrix j (.trans: column l / 4, rows 2 (l % 4) .. + 1).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp layout of a 64 x 64 tile: warp w owns rows 16 (w % 4) .. + 15
// and columns 32 (w / 4) .. + 31, four 16 x 8 MMA tiles; lane l holds
// acc[j][0..1] at row r0, columns c0 + 8 j .. + 1 and acc[j][2..3] at row
// r0 + 8 (tc_rc).
__device__ __forceinline__ void tc_rc(int& r0, int& c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  r0 = 16 * (warp & 3) + (lane >> 2);
  c0 = 32 * (warp >> 2) + 2 * (lane & 3);
}

// B fragments of n-tiles 2h and 2h + 1 of a warp whose columns start at
// n0, from a [k][n] slice (row stride kLdB) at reduction rows k0 .. + 15.
__device__ __forceinline__ void ldsm_b(unsigned (&b)[4], const bf16* Bk,
                                       int k0, int n0, int h) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, Bk + (k0 + r + 8 * (j & 1)) * kLdB + n0 + 16 * h +
                   8 * (j >> 1));
}

// One stage of the conv tile: A [m][k] (kLdA) x B [k][n] (kLdB) over its
// first `ksteps` k-steps of 16. The stage's products are summed from zero
// on the tensor cores and added to acc in f32, so the tensor cores' own
// rounding of a running sum acts on one stage's sum, never on the total.
__device__ __forceinline__ void tc_stage_nn(const bf16* A, const bf16* Bk,
                                            float (&acc)[4][4], int ksteps) {
  const int lane = threadIdx.x & 31, j = lane >> 3, r = lane & 7;
  const int wm = (threadIdx.x >> 5) & 3;
  float part[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < kTcK / 16; ++ks) {
    if (ks >= ksteps) break;
    unsigned a[4];
    ldsm_x4(a, A + (16 * wm + r + 8 * (j & 1)) * kLdA + 16 * ks + 8 * (j >> 1));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned b[4];
      ldsm_b(b, Bk, 16 * ks, 32 * (threadIdx.x >> 7), h);
      mma_bf16(part[2 * h], a, b[0], b[1]);
      mma_bf16(part[2 * h + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
}

// The bf16 conv of one forward tile on the tensor cores: acc (tc_rc's
// layout) = sum_k A[m][k] w[k][co] as conv_tile, in stages of kTcK on a
// ring of kTcStages. kVec (Ci % kTcK == 0, Co % 8 == 0, x and w 16-byte
// aligned): a stage is 32 channels of one tap, each thread copies one
// 16-byte piece of A and one of B. Else element by element, with zeros
// past K (block 1: K = 9, one k-step of 16).
template <bool kVec>
__device__ __forceinline__ void conv_tile_tc(const bf16* __restrict__ x,
                                             const bf16* __restrict__ w,
                                             const Shape& s, int m0, int co0,
                                             bf16* ring, float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int K = 9 * s.Ci, nk = cdiv(K, kTcK);
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const bf16 zero = __ushort_as_bfloat16(0);
  // A piece: position m0 + row, channels 8 q .. + 7 of the stage; B piece:
  // reduction row bk, channels co0 + bc .. + 7
  const int row = tid >> 2, q = tid & 3, bk = tid >> 3, bc = 8 * (tid & 7);
  const int m = m0 + row;
  const bool in = m < s.M;
  const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
  const bf16* xn = x + (in ? (size_t)n * s.H * s.W * s.Ci : 0);
  const bool bin = co0 + bc < s.Co;
  auto stage = [&](int c, bf16* buf) {
    const int k0 = c * kTcK;
    if constexpr (kVec) {
      const int tap = k0 / s.Ci, ci0 = k0 - tap * s.Ci;
      const int hi = 2 * i + tap / 3 - 1, wi = 2 * j + tap % 3 - 1;
      const bool ok = in && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
      __pipeline_memcpy_async(
          buf + row * kLdA + 8 * q,
          ok ? xn + ((size_t)hi * s.W + wi) * s.Ci + ci0 + 8 * q : x, 16,
          ok ? 0 : 16);
      __pipeline_memcpy_async(
          buf + kTcSliceA + bk * kLdB + bc,
          bin ? w + (size_t)(k0 + bk) * s.Co + co0 + bc : w, 16,
          bin ? 0 : 16);
    } else {
      // the columns the MMA reads (the stage's k-steps of 16), zeros past
      // K; thread (row, q) takes k = q, q + 4, .. of its own position
      const int kend = min(kTcK, 16 * cdiv(K - k0, 16));
#pragma unroll 1
      for (int kk = q; kk < kend; kk += 4) {
        const int k = k0 + kk;
        bf16 v = zero;
        if (in && k < K) {
          const int tap = k / s.Ci, ci = k - tap * s.Ci;
          const int hi = 2 * i + tap / 3 - 1, wi = 2 * j + tap % 3 - 1;
          if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W)
            v = xn[((size_t)hi * s.W + wi) * s.Ci + ci];
        }
        buf[row * kLdA + kk] = v;
      }
      for (int e = tid; e < kend * kTileN; e += kThreads) {
        const int k = k0 + e / kTileN, co = co0 + e % kTileN;
        buf[kTcSliceA + (e / kTileN) * kLdB + e % kTileN] =
            (k < K && co < s.Co) ? w[(size_t)k * s.Co + co] : zero;
      }
    }
  };
  // the ring: stage c + kTcStages - 1 is issued while stage c is consumed;
  // the barrier at the top of step c also frees the buffer step c - 1 read
  for (int c = 0; c < kTcStages - 1; ++c) {
    if (c < nk) stage(c, ring + c * kTcStage);
    __pipeline_commit();
  }
  for (int c = 0; c < nk; ++c) {
    __pipeline_wait_prior(kTcStages - 2);
    __syncthreads();
    const int nx = c + kTcStages - 1;
    if (nx < nk) stage(nx, ring + (nx % kTcStages) * kTcStage);
    __pipeline_commit();
    const bf16* buf = ring + (c % kTcStages) * kTcStage;
    tc_stage_nn(buf, buf + kTcSliceA, acc, min(kTcK, K - c * kTcK) > 16 ? 2 : 1);
  }
  __syncthreads();  // every warp is done with the ring
}

// C [kTileM][kLdC] <- acc + b: the tile's y (conv + bias, f32).
__device__ __forceinline__ void tc_tile_to_smem(const float (&acc)[4][4],
                                                const bf16* __restrict__ b,
                                                const Shape& s, int co0,
                                                float* C) {
  int r0, c0;
  tc_rc(r0, c0);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int col = c0 + 8 * n;
    const float b0 = co0 + col < s.Co ? ld(b + co0 + col) : 0.f;
    const float b1 = co0 + col + 1 < s.Co ? ld(b + co0 + col + 1) : 0.f;
    *reinterpret_cast<float2*>(C + r0 * kLdC + col) =
        make_float2(acc[n][0] + b0, acc[n][1] + b1);
    *reinterpret_cast<float2*>(C + (r0 + 8) * kLdC + col) =
        make_float2(acc[n][2] + b0, acc[n][3] + b1);
  }
}

// Kernel A of the forward in bf16: fwd_conv_stats_kernel with the conv
// tile on the tensor cores.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fwd_conv_stats_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const bf16* __restrict__ b, float* __restrict__ yout,
                         float2* __restrict__ tstats, Shape s) {
  __shared__ __align__(16) bf16 ring[kTcRing];
  const int tile = blockIdx.x, co0 = blockIdx.y * kTileN, t = blockIdx.z;
  const int m0 = tile * kTileM, rows = min(kTileM, s.M - m0);
  x += (size_t)t * s.N * s.H * s.W * s.Ci;
  w += (size_t)t * 9 * s.Ci * s.Co;
  b += (size_t)t * s.Co;
  float acc[4][4];
  conv_tile_tc<kVec>(x, w, s, m0, co0, ring, acc);
  float* C = reinterpret_cast<float*>(ring);
  tc_tile_to_smem(acc, b, s, co0, C);
  __syncthreads();
  tile_y_stats(C, yout, tstats, s, t, tile, co0, rows);
}

// f32 d as three bf16 terms, hi + mid + lo == d exactly for 0 and for
// 2^-110 <= |d| <= the largest bf16 (each remainder is exact in f32 and
// the last has at most 8 significant bits; cuda/cnn4_cuda.py:split3_bf16).
__device__ __forceinline__ void split3(float d, bf16& hi, bf16& mid,
                                       bf16& lo) {
  hi = __float2bfloat16_rn(d);
  const float r1 = d - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

__device__ __forceinline__ void st_bf16x4(bf16* p, const bf16 (&v)[4]) {
  uint2 raw;
  raw.x = (unsigned)__bfloat16_as_ushort(v[0]) |
          (unsigned)__bfloat16_as_ushort(v[1]) << 16;
  raw.y = (unsigned)__bfloat16_as_ushort(v[2]) |
          (unsigned)__bfloat16_as_ushort(v[3]) << 16;
  *reinterpret_cast<uint2*>(p) = raw;
}

// p[0..1] <- (a, b) for the channels below `limit`: one store where `vec`
// says p is aligned for two.
__device__ __forceinline__ void store_pair(float* p, float a, float b,
                                           int limit, bool vec) {
  if (vec && limit >= 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (limit > 0) p[0] = a;
    if (limit > 1) p[1] = b;
  }
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b,
                                           int limit, bool vec) {
  if (vec && limit >= 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    if (limit > 0) p[0] = __float2bfloat16(a);
    if (limit > 1) p[1] = __float2bfloat16(b);
  }
}

// Step 4a of cnn4_block_bwd_params in bf16. grid (tiles, ceil(Co/64), B),
// thread (rg, q) on rows rg, rg + 16, .. of channels 4q .. 4q + 3 as
// bwd_tile_sums_kernel. dy = inv_std (dz scale - m1 - xhat m2) from y, g
// and the constants -> dy (f32, the output) and its three bf16 terms
// (split3) -> terms[3][B][M][Co] for the dw GEMM: formed once, not once
// for every row tile of dw.
__global__ void __launch_bounds__(kThreads)
bwd_dy_split_kernel(const bf16* __restrict__ sc, const bf16* __restrict__ be,
                    const bf16* __restrict__ g, const float* __restrict__ y,
                    const float2* __restrict__ stats,
                    const float2* __restrict__ consts, float* __restrict__ dy,
                    bf16* __restrict__ terms, bool vec, int B, Shape s) {
  constexpr int kGroups = kThreads / (kTileN / 4);
  __shared__ float par[6][kTileN];  // mean, inv_std, scale, bias, m1, m2
  const int tid = threadIdx.x, col = 4 * (tid & 15), rg = tid >> 4;
  const int tile = blockIdx.x, co0 = blockIdx.y * kTileN, t = blockIdx.z;
  const int m0 = tile * kTileM, rows = min(kTileM, s.M - m0);
  const int limit = s.Co - co0 - col;
  load_bn_par(par, stats, sc, be, t, co0, s);
  if (tid < kTileN) {
    const float2 c2 = co0 + tid < s.Co ? consts[(size_t)t * s.Co + co0 + tid]
                                       : make_float2(0.f, 0.f);
    par[4][tid] = c2.x;
    par[5][tid] = c2.y;
  }
  __syncthreads();
  const size_t plane = (size_t)B * s.M * s.Co;
  for (int r = rg; r < rows && limit > 0; r += kGroups) {
    const size_t off = ((size_t)t * s.M + m0 + r) * s.Co + co0 + col;
    const float4 yv = load_row4(y + off, limit, vec);
    const float4 gv = load_row4(g + off, limit, vec);
    float d[4];
    bf16 hi[4], mid[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xh;
      const int c = col + u;
      const float dz = bn_dz(f4(yv, u), f4(gv, u), par[0][c], par[1][c],
                             par[2][c], par[3][c], xh);
      d[u] = par[1][c] * (fmaf(dz, par[2][c], -par[4][c]) - xh * par[5][c]);
      split3(d[u], hi[u], mid[u], lo[u]);
    }
    store_row4(dy + off, make_float4(d[0], d[1], d[2], d[3]), limit, vec);
    if (vec && limit >= 4) {
      st_bf16x4(terms + off, hi);
      st_bf16x4(terms + plane + off, mid);
      st_bf16x4(terms + 2 * plane + off, lo);
    } else {
      for (int u = 0; u < 4 && u < limit; ++u) {
        terms[off + u] = hi[u];
        terms[plane + off + u] = mid[u];
        terms[2 * plane + off + u] = lo[u];
      }
    }
  }
}

// The dw GEMM on the tensor cores: 4 warps, each 32 rows of dw x 32
// channels (2 x 4 MMA tiles); a stage is 32 positions, two MMA k-steps,
// on a ring of kDwStages in dynamic shared memory.
constexpr int kDwThreads = 128;
constexpr int kDwK = 32;                   // positions a stage
constexpr int kDwSlice = kDwK * kLdB;      // one [position][row] slice
constexpr int kDwStage = 4 * kDwSlice;     // x, then dy's hi, mid and lo
constexpr int kDwStages = 4;
constexpr int kDwSmem = kDwStages * kDwStage * 2;  // 73,728 bytes
constexpr int kDwTcMinBlocks = 3;          // CTAs an SM (the ring's bytes)
constexpr int kDwGroups = kDwThreads / (kTileN / 4);  // db's row groups
static_assert(kDwGroups * kTileN * 4 <= kDwSmem, "db's groups fit the ring");
static_assert(kDwK % kDwGroups == 0, "db: whole row groups a stage");

// Step 4b of cnn4_block_bwd_params in bf16, on the tensor cores. grid
// (chunks, dw row tiles x column tiles, B), chunks as bwd_dw_kernel's.
// dw[k][co] = sum over the chunk's positions m of x_tap(m, ci) dy(m, co),
// k = tap * Ci + ci, for the CTA's 64 x 64 tile of dw. A stage holds the
// x slice [position][row (tap, ci)], gathered as bwd_dw_kernel gathers it
// (kVec: Ci % 8 == 0, 16 bytes a piece by cp.async; else element by
// element, the rows past K zero), read as the A operand with
// ldmatrix.trans, and dy's three bf16 terms [position][co] (16 bytes a
// piece by cp.async where vec8), each read as B with ldmatrix.trans.
// Three MMAs a k-step and tile (x hi, x mid, x lo) into a stage sum from
// zero, added to acc in f32: the products of bf16 x and the terms are
// exact, so dw carries the f32 dy, as the reference's f32 dw does. The CTAs
// of dw row tile 0 also sum db over the chunk from the terms ((lo + mid) +
// hi == dy exactly). With one chunk the CTA stores dw and db in bf16; else
// its f32 partial part[b][chunk] = (dw [K][Co], db [Co]).
template <bool kVec>
__global__ void __launch_bounds__(kDwThreads, kDwTcMinBlocks)
bwd_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ terms,
                 bf16* __restrict__ dw, bf16* __restrict__ db,
                 float* __restrict__ part, int chunk, bool vec8, int B,
                 Shape s) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  bf16* ring = reinterpret_cast<bf16*>(dw_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lj = lane >> 3, lr = lane & 7;
  const int wm = warp & 1, wn = warp >> 1;  // rows 32 wm .., columns 32 wn ..
  const int K = 9 * s.Ci, nct = cdiv(s.Co, kTileN), nchunks = gridDim.x;
  const int ch = blockIdx.x, t = blockIdx.z;
  const int k0 = blockIdx.y / nct * kTileM, co0 = blockIdx.y % nct * kTileN;
  const bool first = k0 == 0;
  const int mb = ch * chunk, me = min(mb + chunk, s.M);
  const size_t row0 = (size_t)t * s.M, plane = (size_t)B * s.M * s.Co;
  x += (size_t)t * s.N * s.H * s.W * s.Ci;

  // x pieces: positions m0 + (tid >> 3) + 16 u, rows k0 + cq .. + 7 of dw
  // (one tap, 8 channels); term pieces: channels co0 + cq .. + 7
  const int cq = 8 * (tid & 7), pr = tid >> 3;
  const int ka = k0 + cq, tap = ka / s.Ci, ci = ka - tap * s.Ci;
  const int dty = tap / 3 - 1, dtx = tap % 3 - 1;
  const bool kin = ka < K, cin = co0 + cq < s.Co;
  const int kw = min(kTileM, K - k0);  // rows of dw in this tile (block 1: 9)
  const bf16 zero = __ushort_as_bfloat16(0);
  auto stage = [&](int c, bf16* buf) {
    const int m0 = mb + c * kDwK;
    if constexpr (kVec) {
#pragma unroll
      for (int u = 0; u < kDwK / 16; ++u) {
        const int r = pr + 16 * u, m = m0 + r;
        const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
        const int hi = 2 * i + dty, wi = 2 * j + dtx;
        const bool ok =
            kin && m < me && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
        __pipeline_memcpy_async(
            buf + r * kLdB + cq,
            ok ? x + (((size_t)n * s.H + hi) * s.W + wi) * s.Ci + ci : x, 16,
            ok ? 0 : 16);
      }
    } else {  // thread (r, q): rows k0 + q, q + 4, .. < K of position r;
              // the rows past K stay zero
      const int r = tid >> 2, q = tid & 3, m = m0 + r;
      const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
#pragma unroll 1
      for (int kk = q; kk < kw; kk += 4) {
        const int k = k0 + kk, tp = k / s.Ci, cc = k - tp * s.Ci;
        const int hi = 2 * i + tp / 3 - 1, wi = 2 * j + tp % 3 - 1;
        buf[r * kLdB + kk] =
            m < me && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W
                ? x[(((size_t)n * s.H + hi) * s.W + wi) * s.Ci + cc]
                : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < 3 * kDwK / 16; ++u) {  // term u / 2, rows pr + 16 (u % 2)
      const int term = u >> 1, r = pr + 16 * (u & 1), m = m0 + r;
      bf16* dst = buf + (1 + term) * kDwSlice + r * kLdB + cq;
      const size_t off = term * plane + (row0 + m) * s.Co + co0 + cq;
      if (vec8) {
        const bool ok = m < me && cin;
        __pipeline_memcpy_async(dst, ok ? terms + off : terms, 16,
                                ok ? 0 : 16);
      } else {
        for (int v = 0; v < 8; ++v)
          dst[v] = m < me && co0 + cq + v < s.Co ? terms[off + v] : zero;
      }
    }
  };

  // db: thread (g, q) sums channels 4 q .. + 3 over rows g, g + 8, ..
  const int dq = 4 * (tid & 15), dg = tid >> 4;
  float acc[2][4][4] = {};
  float dbacc[4] = {0.f, 0.f, 0.f, 0.f};
  auto consume = [&](const bf16* buf) {
    if (first) {
#pragma unroll
      for (int r = dg; r < kDwK; r += kDwGroups) {
        const int c = r * kLdB + dq;
        const float4 hi = ld4(buf + kDwSlice + c),
                     mid = ld4(buf + 2 * kDwSlice + c),
                     lo = ld4(buf + 3 * kDwSlice + c);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dbacc[u] += (f4(lo, u) + f4(mid, u)) + f4(hi, u);
      }
    }
    const int mts = min(2, cdiv(kw - 32 * wm, 16));  // MMA row tiles in K
    if (mts <= 0) return;
    float sum[2][4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kDwK / 16; ++ks) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < mts)
          ldsm_x4_t(a[mt], buf + (16 * ks + lr + 8 * (lj >> 1)) * kLdB +
                               32 * wm + 16 * mt + 8 * (lj & 1));
#pragma unroll
      for (int term = 1; term <= 3; ++term)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned b[4];
          ldsm_b(b, buf + term * kDwSlice, 16 * ks, 32 * wn, h);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (mt < mts) {
              mma_bf16(sum[mt][2 * h], a[mt], b[0], b[1]);
              mma_bf16(sum[mt][2 * h + 1], a[mt], b[2], b[3]);
            }
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][n][i] += sum[mt][n][i];
  };

  const int nk = cdiv(me - mb, kDwK);
  if (!kVec && kw < kTileM) {  // x rows past K: zero in every stage, once
    for (int e = tid; e < kDwStages * kDwSlice; e += kDwThreads)
      ring[(e / kDwSlice) * kDwStage + e % kDwSlice] = zero;
    __syncthreads();
  }
  // the ring: stage c + kDwStages - 1 is issued while stage c is consumed;
  // the barrier at the top of step c also frees the buffer step c - 1 read
  for (int c = 0; c < kDwStages - 1; ++c) {
    if (c < nk) stage(c, ring + c * kDwStage);
    __pipeline_commit();
  }
  for (int c = 0; c < nk; ++c) {
    __pipeline_wait_prior(kDwStages - 2);
    __syncthreads();
    const int nx = c + kDwStages - 1;
    if (nx < nk) stage(nx, ring + (nx % kDwStages) * kDwStage);
    __pipeline_commit();
    consume(ring + (c % kDwStages) * kDwStage);
  }

  // dw rows k0 + 32 wm + 16 mt + lane / 4 (+ 8), channels co0 + 32 wn + 8 n
  // + 2 (lane % 4) .. + 1
  const bool vw = (s.Co & 1) == 0;
  bf16* dwt = dw + (size_t)t * K * s.Co;
  float* pt = part + ((size_t)t * nchunks + ch) * ((size_t)K * s.Co + s.Co);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = k0 + 32 * wm + 16 * mt + (lane >> 2) + 8 * hf;
        const int cc = co0 + 32 * wn + 8 * n + 2 * (lane & 3);
        if (k >= K || cc >= s.Co) continue;
        const size_t off = (size_t)k * s.Co + cc;
        const float v0 = acc[mt][n][2 * hf], v1 = acc[mt][n][2 * hf + 1];
        if (nchunks == 1)
          store_pair(dwt + off, v0, v1, s.Co - cc, vw);
        else
          store_pair(pt + off, v0, v1, s.Co - cc, vw);
      }
  if (!first) return;
  // db over the chunk: the row groups of each channel, in order
  __pipeline_wait_prior(0);
  __syncthreads();  // every warp is done with the ring
  float* red = reinterpret_cast<float*>(dw_smem);  // [kDwGroups][kTileN]
#pragma unroll
  for (int u = 0; u < 4; ++u) red[dg * kTileN + dq + u] = dbacc[u];
  __syncthreads();
  if (tid < kTileN && co0 + tid < s.Co) {
    float a = 0.f;
    for (int r = 0; r < kDwGroups; ++r) a += red[r * kTileN + tid];
    if (nchunks == 1)
      st(db + (size_t)t * s.Co + co0 + tid, a);
    else
      pt[(size_t)K * s.Co + co0 + tid] = a;
  }
}

// The dw GEMM's ring exceeds the 48 KB of static shared memory. The
// attribute belongs to the current device's context, so it is set once a
// device, at the first call there (eager, before any capture of it); a
// server mesh runs its shards on several devices in one process.
constexpr int kMaxDevices = 64;
cudaError_t dw_tc_smem_once() {
  static std::atomic<bool> done[kMaxDevices];  // zero: not yet set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(bwd_dw_tc_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDwSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_dw_tc_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDwSmem);
  if (e == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return e;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: the dx GEMMs of cnn4_block_bwd_input
// ---------------------------------------------------------------------------

// A stage: dy's hi, mid and lo [m][k] (kLdA), then w[tap] [n][k] (kLdA), k
// the stage's 32 channels co; two stages.
constexpr int kDxStage = 3 * kTcSliceA + kTileN * kLdA;  // bf16 elements
constexpr int kDxRing = 2 * kDxStage;                    // 40,960 bytes
static_assert(kTileM * kLdC * 4 <= kDxRing * 2, "the epilogue's tile fits");
static_assert(kThreads * 8 == kTileM * kTcK && kThreads * 8 == kTileN * kTcK,
              "one 8-channel piece of dy and one of w a thread a stage");

__device__ __forceinline__ unsigned bf16x2_bits(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

// split3 of two values at once, as bf16x2 words (a in the low half): the
// same three terms, one conversion for every two.
__device__ __forceinline__ void split3x2(float a, float b, unsigned& hi,
                                         unsigned& mid, unsigned& lo) {
  auto low = [](unsigned u) { return __uint_as_float(u << 16); };
  auto high = [](unsigned u) { return __uint_as_float(u & 0xffff0000u); };
  hi = bf16x2_bits(a, b);
  const float ra = a - low(hi), rb = b - high(hi);
  mid = bf16x2_bits(ra, rb);
  lo = bf16x2_bits(ra - low(mid), rb - high(mid));
}

// cnn4_block_bwd_input in bf16, on the tensor cores. grid as
// bwd_input_kernel's, (tiles of all four classes, ceil(Ci/64), B), and the
// same GEMM a class: dx[p][ci] = sum over the class's taps and co of
// dy[p + tap][co] w[tap][ci][co]. A stage is 32 channels co of one tap. A:
// dy's rows (f32), each split into three bf16 terms hi + mid + lo == dy
// (split3x2), three [m][k] slices; B: w[tap] as it lies, [ci][co] = [n][k]
// with k contiguous, the .col operand of mma.sync, read by ldmatrix without
// .trans. Three MMAs a k-step and tile (hi, mid, lo times w, each product
// exact in f32); a stage's MMAs sum from zero, and the stage's sum is added
// to acc in f32. kVec (Co % 8 == 0, dy and w 16-byte aligned): each thread
// loads 8 channels of one position of dy (two 16-byte loads) into
// registers, issued before the current stage's MMAs, split and stored
// after them (16 bytes a term), and copies 8 channels of one row of w by
// cp.async; zero past Co, Ci and the image. Else element by element,
// between the MMAs. The
// epilogue stores dx through a shared-memory tile: 16 bytes (8 channels) a
// piece where vec8 (Ci % 8 == 0, dx 16-byte aligned), else element by
// element. Warps whose 32 columns lie past Ci skip their MMAs (block 1:
// Ci = 1).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bwd_input_tc_kernel(const float* __restrict__ dy, const bf16* __restrict__ w,
                    bf16* __restrict__ dx, bool vec8, Shape s) {
  __shared__ __align__(16) bf16 ring[kDxRing];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lj = lane >> 3, lr = lane & 7;
  const int wm = warp & 3, wn = warp >> 2;  // rows 16 wm .., columns 32 wn ..
  const int ci0 = blockIdx.y * kTileN, t = blockIdx.z;
  const DxClass dc = dx_class(s);
  const int hc = dc.hc, wc = dc.wc, P = dc.P;
  const int ph = class_ph(dc.cls), pw = class_pw(dc.cls);
  const int p0 = dc.tile * kTileM;
  const int nco = cdiv(s.Co, kTcK);                 // stages per tap
  const int nk = (1 + ph) * (1 + pw) * nco;
  dy += (size_t)t * s.M * s.Co;
  w += (size_t)t * 9 * s.Ci * s.Co;
  dx += (size_t)t * s.N * s.H * s.W * s.Ci;
  const bf16 zero = __ushort_as_bfloat16(0);

  // kVec pieces: channels 8 bq .. + 7 of the stage, of dy at position
  // p0 + br and of w at row ci0 + br
  const int br = tid >> 2, bq = tid & 3;
  const int pp = p0 + br;
  const bool pin = pp < P;
  const int pb = pp % wc, pa = (pp / wc) % hc;
  const float* dyn =
      dy + (pin ? (size_t)(pp / (wc * hc)) * s.Ho * s.Wo * s.Co : 0);
  const bool bin = ci0 + br < s.Ci;
  float4 av[2];
  auto load_a = [&](int c) {
    const DxTap tp = dx_tap(c, nco, ph, pw, kTcK);
    const int i = pa + tp.di, j = pb + tp.dj;
    const bool ok = pin && tp.co0 + 8 * bq < s.Co && i < s.Ho && j < s.Wo;
    const float* src = dyn + ((size_t)i * s.Wo + j) * s.Co + tp.co0 + 8 * bq;
    av[0] = ok ? ld4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    av[1] = ok ? ld4(src + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store_a = [&](bf16* buf) {
    uint4 hi, mid, lo;
    split3x2(av[0].x, av[0].y, hi.x, mid.x, lo.x);
    split3x2(av[0].z, av[0].w, hi.y, mid.y, lo.y);
    split3x2(av[1].x, av[1].y, hi.z, mid.z, lo.z);
    split3x2(av[1].z, av[1].w, hi.w, mid.w, lo.w);
    const int off = br * kLdA + 8 * bq;
    *reinterpret_cast<uint4*>(buf + off) = hi;
    *reinterpret_cast<uint4*>(buf + kTcSliceA + off) = mid;
    *reinterpret_cast<uint4*>(buf + 2 * kTcSliceA + off) = lo;
  };
  auto copy_b = [&](int c, bf16* buf) {
    const DxTap tp = dx_tap(c, nco, ph, pw, kTcK);
    const bool ok = bin && tp.co0 + 8 * bq < s.Co;
    __pipeline_memcpy_async(
        buf + 3 * kTcSliceA + br * kLdA + 8 * bq,
        ok ? w + ((size_t)tp.wtap * s.Ci + ci0 + br) * s.Co + tp.co0 + 8 * bq
           : w,
        16, ok ? 0 : 16);
  };
  auto stage_elems = [&](int c, bf16* buf) {
    const DxTap tp = dx_tap(c, nco, ph, pw, kTcK);
    for (int e = tid; e < kTileM * kTcK; e += kThreads) {
      const int row = e / kTcK, kk = e % kTcK, co = tp.co0 + kk, p = p0 + row;
      float v = 0.f;
      if (p < P && co < s.Co) {
        const int j = p % wc + tp.dj, i = (p / wc) % hc + tp.di;
        const int n = p / (wc * hc);
        if (i < s.Ho && j < s.Wo)
          v = dy[(((size_t)n * s.Ho + i) * s.Wo + j) * s.Co + co];
      }
      bf16 hi, mid, lo;
      split3(v, hi, mid, lo);
      buf[row * kLdA + kk] = hi;
      buf[kTcSliceA + row * kLdA + kk] = mid;
      buf[2 * kTcSliceA + row * kLdA + kk] = lo;
    }
    for (int e = tid; e < kTileN * kTcK; e += kThreads) {
      const int r = e / kTcK, kk = e % kTcK, ci = ci0 + r, co = tp.co0 + kk;
      buf[3 * kTcSliceA + r * kLdA + kk] =
          ci < s.Ci && co < s.Co ? w[((size_t)tp.wtap * s.Ci + ci) * s.Co + co]
                                 : zero;
    }
  };

  // one stage's MMAs: hi, mid and lo times w, summed from zero, then into
  // acc (tc_rc's layout)
  float acc[4][4] = {};
  const bool cols = ci0 + 32 * wn < s.Ci;  // this warp's columns hold a ci
  auto consume = [&](int c, const bf16* buf) {
    if (!cols) return;
    const int ksteps = s.Co - dx_tap(c, nco, ph, pw, kTcK).co0 > 16 ? 2 : 1;
    float part[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kTcK / 16; ++ks) {
      if (ks >= ksteps) break;
      unsigned a[3][4];
#pragma unroll
      for (int term = 0; term < 3; ++term)
        ldsm_x4(a[term], buf + term * kTcSliceA +
                             (16 * wm + lr + 8 * (lj & 1)) * kLdA + 16 * ks +
                             8 * (lj >> 1));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // n-tiles 2h, 2h + 1: rows n of the [n][k] slice, k 0-7 | 8-15
        unsigned b[4];
        ldsm_x4(b, buf + 3 * kTcSliceA +
                       (32 * wn + 16 * h + 8 * (lj >> 1) + lr) * kLdA +
                       16 * ks + 8 * (lj & 1));
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          mma_bf16(part[2 * h], a[term], b[0], b[1]);
          mma_bf16(part[2 * h + 1], a[term], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
  };

  // the K loop on two stages: stage c + 1's copies and loads are in flight
  // while stage c's MMAs run; one barrier a stage
  if constexpr (kVec) {
    load_a(0);
    copy_b(0, ring);
    __pipeline_commit();
    store_a(ring);
  } else {
    stage_elems(0, ring);
  }
  for (int c = 0; c < nk; ++c) {
    const bf16* cur = ring + (c & 1) * kDxStage;
    bf16* nxt = ring + ((c + 1) & 1) * kDxStage;  // last read in stage c - 1
    const bool more = c + 1 < nk;
    if constexpr (kVec) __pipeline_wait_prior(0);
    __syncthreads();
    if constexpr (kVec) {
      if (more) {
        copy_b(c + 1, nxt);
        __pipeline_commit();
        load_a(c + 1);
      }
    }
    consume(c, cur);
    if (more) {
      if constexpr (kVec)
        store_a(nxt);
      else
        stage_elems(c + 1, nxt);
    }
  }
  __syncthreads();  // every warp is done with the ring

  // through the tile: each thread then stores 8 contiguous channels
  float* C = reinterpret_cast<float*>(ring);
  int r0, c0;
  tc_rc(r0, c0);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<float2*>(C + r0 * kLdC + c0 + 8 * n) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(C + (r0 + 8) * kLdC + c0 + 8 * n) =
        make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  for (int e = tid; e < kTileM * kTileN / 8; e += kThreads) {
    const int row = e >> 3, col = 8 * (e & 7), p = p0 + row;
    if (p >= P || ci0 + col >= s.Ci) continue;
    const int bb = p % wc, a = (p / wc) % hc, n = p / (wc * hc);
    const size_t pos = ((size_t)n * s.H + 2 * a + ph) * s.W + 2 * bb + pw;
    bf16* out = dx + pos * s.Ci + ci0 + col;
    const float4 v0 = *reinterpret_cast<const float4*>(C + row * kLdC + col);
    const float4 v1 =
        *reinterpret_cast<const float4*>(C + row * kLdC + col + 4);
    if (vec8) {
      *reinterpret_cast<uint4*>(out) =
          make_uint4(bf16x2_bits(v0.x, v0.y), bf16x2_bits(v0.z, v0.w),
                     bf16x2_bits(v1.x, v1.y), bf16x2_bits(v1.z, v1.w));
    } else {
      const int limit = s.Ci - ci0 - col;
      for (int u = 0; u < 8 && u < limit; ++u)
        out[u] = __float2bfloat16(u < 4 ? f4(v0, u) : f4(v1, u - 4));
    }
  }
}

// ---------------------------------------------------------------------------
// One task in one launch a block: thread-block clusters (B = 1)
// ---------------------------------------------------------------------------
//
// The single-task TPU kernels (_blk_fwd_call_single, _blk_bwd_call_single)
// hold a whole task in VMEM and run as one program. Above, a task is tiles
// of 64 positions on separate CTAs, so batch-statistics BN, its backward
// sums and the dw reduction each cost a launch and a round trip through
// device memory: at B = 1 a forward is 3 dependent launches a block,
// bwd_params 5-7.
//
// fwd_cluster_kernel and bwd_params_cluster_kernel keep the task on chip
// instead: one cluster of up to 16 CTAs owns the task (all Co <= 64
// channels); CTA rank r owns the positions of tiles [r T, (r + 1) T), T =
// the plan's tiles a CTA, and keeps their f32 conv output y in its shared
// memory. The CTAs meet at cluster barriers and read each other's shared
// memory (DSMEM), so what the tiled path combines in separate launches is
// combined inside the one launch:
// - BN statistics: each CTA takes its rows' (n, mean, M2) in two passes;
//   after a cluster barrier every CTA reads all ranks' in rank order and
//   combines them by Chan's formula, so every CTA holds the same (mean,
//   inv_std) bit for bit;
// - bwd_params: each CTA sums dz * xhat and dz over its rows; the ranks'
//   sums in rank order give dscale, dbias and dy's constants in every
//   CTA. dy is formed in place of y (and stored: it is output 0, which
//   cnn4_block_bwd_input reads). Each CTA takes its dw and db partials over
//   its own positions on the CUDA cores into its shared memory; after a
//   cluster barrier each CTA sums its share of dw's rows over all ranks in
//   rank order and stores them.
// Every sum has a fixed order and none uses atomics. A final cluster
// barrier keeps every CTA resident until no peer reads its shared memory.
//
// What bounds them: a cluster has at most 16 SMs, one CTA each, so a CTA's
// tiles run one after another, where the tiled grid spreads them over one
// CTA each. Against the tiled launches in turns (PERF.md), each kernel
// wins only where that series is short, and cluster_plan takes only those
// shapes:
// - the forward where Ci % 64 == 0 and a CTA owns one tile (blocks 2-4 of
//   a served request's query and of the vision baseline's step, blocks
//   3-4 of its support set): a tap of 64 channels a stage ("fat"), on the
//   tensor cores in bf16 (conv_tile_tc's arithmetic, each 32 channels
//   summed from zero) and on the CUDA cores in f32 (conv_tile's); inputs
//   not 16-byte aligned take the tiled path's stages element by element.
//   Block 1 (Ci = 1) stays tiled: its conv is 9 products a position, and
//   the tiled grid's 31-77 CTAs beat 16;
// - bwd_params where Ci == 1 (block 1) and a CTA owns at most 3 tiles (N
//   <= 15): the images its positions read and w are copied to shared
//   memory once, and conv and dw gather their elements there (dw is 9 rows
//   of 64: a tensor-core tile would waste most of it). Blocks 2-4 stay
//   tiled: dw's 9 Ci rows on 16 CTAs lost to the tiled dw GEMM at every N.
// A table of the CTA's positions (the offset of each in x and the taps
// that fall inside the image), made once, replaces per-stage divisions.
// Clusters past the portable 8 need the device to schedule them
// (cluster_max asks it once a device, and takes 8 where it cannot).

constexpr int kGroupsRed = kThreads / (kTileN / 4);  // row groups a sum
constexpr int kClusterMax = 16;       // CTAs a cluster where schedulable
constexpr int kClusterPortable = 8;   // else
constexpr int kFwdTilesMax = 1;       // the forward's tiles a CTA at most
constexpr int kBwdTilesMax = 3;       // bwd_params' (block 1)
constexpr int kClusterSmemMax = 232448;  // 227 KB, an H100 CTA's most
constexpr int kTileYBytes = kTileM * kLdC * 4;  // a tile of y
// cst (mean, M2), csum (dz xhat, dz), dbp (db), par [6][kTileN]
constexpr int kAuxBytes = (2 * kTileN + 2 * kTileN + kTileN + 6 * kTileN) * 4;
// the forward's fat stages: 64 channels of one tap
constexpr int kCW = 64;
constexpr int kLdW = kCW + 8;         // bf16 row stride of a fat slice: 144 B
constexpr int kLdA32 = kCW + 4;       // f32 row stride of the conv's A slice
constexpr int kTcFat = 2 * kTileM * kLdW;           // bf16 conv: A + B
constexpr int kF32Fat = kTileM * kLdA32 + kCW * kTileN;  // f32 conv: A + B
constexpr int kConvDepthTc = 3;
constexpr int kConvDepthF32 = 2;
constexpr int kPartBytes = 9 * kLdC * 4;  // block 1's dw partial: 9 rows
static_assert(kThreads * 2 * 8 == kTileM * kCW, "two bf16 pieces a thread");
static_assert(kThreads * 4 * 4 == kTileM * kCW, "four f32 pieces a thread");

// The ring's bytes: the fat stages where Ci % 64 == 0 (`fat`), else the
// tiled path's stages two deep (the element paths)
__host__ __device__ constexpr int cluster_ring_bytes(bool bf16, bool fat) {
  return bf16 ? 2 * (fat ? kConvDepthTc * kTcFat : 2 * kTcStage)
              : 4 * (fat ? kConvDepthF32 * kF32Fat : 2 * kStage);
}
static_assert(2 * kGroupsRed * kTileN * 4 <= cluster_ring_bytes(true, false) &&
                  4 * 9 * kTileN * 4 <= cluster_ring_bytes(true, false),
              "the reductions fit the smallest ring");

// The route and its shared memory (cluster_plan): `size` CTAs of `tiles`
// tiles each; `ring` bytes of ring, `xspan` / `wspan` bytes of x and w
// where they are copied (bwd_params; 0 else); `smem` bytes in all.
struct ClusterPlan {
  int size, tiles, ring, xspan, wspan, smem;
};

// The cluster's shared memory: the ring (also the reductions' scratch),
// what peers read (cst, csum, dbp), par (mean, inv_std, scale, bias, m1,
// m2 per channel), the position table, y (T tiles of kTileM rows of kLdC
// floats; dy in place), x and w where copied, and bwd_params' dw partial.
struct ClusterSmem {
  unsigned char* ring;
  float2* cst;
  float2* csum;
  float* dbp;
  float (*par)[kTileN];
  int2* pos;
  float* y;
  unsigned char* xspan;
  unsigned char* wspan;
  float* part;
  __device__ ClusterSmem(unsigned char* base, const ClusterPlan& p) {
    ring = base;
    cst = reinterpret_cast<float2*>(base + p.ring);
    csum = cst + kTileN;
    dbp = reinterpret_cast<float*>(csum + kTileN);
    par = reinterpret_cast<float(*)[kTileN]>(dbp + kTileN);
    pos = reinterpret_cast<int2*>(par + 6);
    y = reinterpret_cast<float*>(pos + p.tiles * kTileM);
    xspan = reinterpret_cast<unsigned char*>(y + (size_t)p.tiles * kTileM * kLdC);
    wspan = xspan + p.xspan;
    part = reinterpret_cast<float*>(wspan + p.wspan);
  }
};

// Positions [m0, m1) of rank q when each rank owns `tiles` tiles.
__device__ __forceinline__ int rank_m0(int q, int tiles, int M) {
  return min(M, q * tiles * kTileM);
}

// n stages on a ring of kDepth buffers `stride` elements apart:
// stage(g, buf) issues stage g (cp.async copies, or plain stores),
// consume(g, buf) uses it. Stages g + 1 .. g + kDepth - 1 are in flight
// while stage g is consumed; the barrier at the top of step g also frees
// the buffer step g - 1 read. Ends with every copy landed and a barrier.
template <int kDepth, typename E, class Stage, class Consume>
__device__ __forceinline__ void ring_loop(int n, E* ring, int stride,
                                          Stage stage, Consume consume) {
#pragma unroll 1
  for (int g = 0; g < kDepth - 1; ++g) {
    if (g < n) stage(g, ring + g * stride);
    __pipeline_commit();
  }
#pragma unroll 1
  for (int g = 0; g < n; ++g) {
    __pipeline_wait_prior(kDepth - 2);
    __syncthreads();
    const int nx = g + kDepth - 1;
    if (nx < n) stage(nx, ring + (nx % kDepth) * stride);
    __pipeline_commit();
    consume(g, ring + (g % kDepth) * stride);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
}

// dst[0 .. n) <- src (16 bytes at a time where both sides allow).
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, size_t n) {
  const size_t bytes = n * sizeof(T);
  if (((uintptr_t)src & 15) == 0 && bytes % 16 == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t e = threadIdx.x; e < bytes / 16; e += kThreads) d4[e] = s4[e];
  } else {
    for (size_t e = threadIdx.x; e < n; e += kThreads) dst[e] = src[e];
  }
}

// The position table of the CTA's `rows` positions from m0: for m < m1,
// the offset in x (images from nf) of (image, row 2i - 1, column 2j - 1,
// channel 0) and the taps (bit ky * 3 + kx) that fall inside the image;
// zeros past m1. Tap t of position m reads x[pos.x + tap_off(t) + ci].
__device__ __forceinline__ void cluster_positions(int2* pos, const Shape& s,
                                                  int m0, int m1, int nf,
                                                  int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int m = m0 + r;
    int2 v = make_int2(0, 0);
    if (m < m1) {
      const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
      v.x = (((n - nf) * s.H + 2 * i - 1) * s.W + 2 * j - 1) * s.Ci;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int hi = 2 * i + t / 3 - 1, wi = 2 * j + t % 3 - 1;
        v.y |= (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W) << t;
      }
    }
    pos[r] = v;
  }
}
__device__ __forceinline__ int tap_off(int t, const Shape& s) {
  return ((t / 3) * s.W + t % 3) * s.Ci;
}

// The conv's tile t into y: acc + bias, rows t * kTileM .. (tc_rc's
// layout for bf16, the 4 x 4 register tile for f32), then acc zeroed.
__device__ __forceinline__ void tile_out(float (&acc)[4][4], const bf16* b,
                                         const Shape& s, float* y, int t) {
  tc_tile_to_smem(acc, b, s, 0, y + (size_t)t * kTileM * kLdC);
#pragma unroll
  for (int nn = 0; nn < 4; ++nn)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[nn][u] = 0.f;
}
__device__ __forceinline__ void tile_out(float (&acc)[4][4], const float* b,
                                         const Shape& s, float* y, int t) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* C = y + (size_t)t * kTileM * kLdC;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float v[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int co = 4 * tx + cc;
      v[cc] = acc[r][cc] + (co < s.Co ? b[co] : 0.f);
      acc[r][cc] = 0.f;
    }
    st4(C + (4 * ty + r) * kLdC + 4 * tx, make_float4(v[0], v[1], v[2], v[3]));
  }
}

// y of the CTA's n positions on the tensor cores, fat stages (Ci % 64 ==
// 0, x and w 16-byte aligned): a stage is one tap's 64 channels (A [64
// positions][72], B [64 k][72], each thread two 16-byte cp.async of each),
// its two halves of 32 channels each summed from zero on the tensor cores
// and added to acc in f32 (conv_tile_tc's arithmetic); one ring across the
// CTA's tiles.
template <int kDepth>
__device__ __forceinline__ void cluster_conv_fat(const bf16* __restrict__ x,
                                                 const bf16* __restrict__ w,
                                                 const bf16* __restrict__ b,
                                                 const Shape& s, int n,
                                                 const int2* pos, float* y,
                                                 bf16* ring) {
  const int tid = threadIdx.x, cpt = s.Ci / kCW, nk = 9 * cpt;
  const int lane = tid & 31, j8 = lane >> 3, r8 = lane & 7;
  const int wm = (tid >> 5) & 3, wn = tid >> 7;
  float acc[4][4] = {};
  auto stage = [&](int g, bf16* buf) {
    const int t = g / nk, c = g - t * nk, tap = c / cpt;
    const int toff = tap_off(tap, s) + (c - tap * cpt) * kCW;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + p * kThreads, row = idx >> 3, cq = 8 * (idx & 7);
      const int2 pv = pos[t * kTileM + row];
      const bool ok = (pv.y >> tap) & 1;
      __pipeline_memcpy_async(buf + row * kLdW + cq,
                              ok ? x + (pv.x + toff + cq) : x, 16,
                              ok ? 0 : 16);
      const bool bin = cq < s.Co;  // B: reduction row `row`, channels cq ..
      __pipeline_memcpy_async(
          buf + (kTileM + row) * kLdW + cq,
          bin ? w + (size_t)(c * kCW + row) * s.Co + cq : w, 16, bin ? 0 : 16);
    }
  };
  auto consume = [&](int g, const bf16* buf) {
    const int t = g / nk, c = g - t * nk;
    const bf16* Bk = buf + kTileM * kLdW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float part[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kc = 32 * half + 16 * ks;
        unsigned a[4];
        ldsm_x4(a, buf + (16 * wm + r8 + 8 * (j8 & 1)) * kLdW + kc +
                       8 * (j8 >> 1));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned bq[4];
          ldsm_b(bq, Bk, kc, 32 * wn, h);
          mma_bf16(part[2 * h], a, bq[0], bq[1]);
          mma_bf16(part[2 * h + 1], a, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[nn][u] += part[nn][u];
    }
    if (c == nk - 1) tile_out(acc, b, s, y, t);
  };
  ring_loop<kDepth>(cdiv(n, kTileM) * nk, ring, kTcFat, stage, consume);
}

// cluster_conv_fat in f32 on the CUDA cores: a stage is one tap's 64
// channels (A [64][68], B [64][64], each thread four 16-byte cp.async of
// each), k ascending in each thread's 4 x 4 FMAs (conv_tile's arithmetic).
template <int kDepth>
__device__ __forceinline__ void cluster_conv_fat(const float* __restrict__ x,
                                                 const float* __restrict__ w,
                                                 const float* __restrict__ b,
                                                 const Shape& s, int n,
                                                 const int2* pos, float* y,
                                                 float* ring) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int cpt = s.Ci / kCW, nk = 9 * cpt;
  float acc[4][4] = {};
  auto stage = [&](int g, float* buf) {
    const int t = g / nk, c = g - t * nk, tap = c / cpt;
    const int toff = tap_off(tap, s) + (c - tap * cpt) * kCW;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int idx = tid + p * kThreads, row = idx >> 4, q4 = 4 * (idx & 15);
      const int2 pv = pos[t * kTileM + row];
      const bool ok = (pv.y >> tap) & 1;
      stage4(buf + row * kLdA32 + q4, ok ? x + (pv.x + toff + q4) : x, ok);
      const bool bin = q4 < s.Co;
      stage4(buf + kTileM * kLdA32 + row * kTileN + q4,
             bin ? w + (size_t)(c * kCW + row) * s.Co + q4 : w, bin);
    }
  };
  auto consume = [&](int g, const float* buf) {
    const int t = g / nk, c = g - t * nk;
    const float* Bk = buf + kTileM * kLdA32;
#pragma unroll 4
    for (int k = 0; k < kCW; k += 4) {
      float4 a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(buf + (4 * ty + r) * kLdA32 + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bv[q] = *reinterpret_cast<const float4*>(Bk + (k + q) * kTileN + 4 * tx);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[r][cc] = fmaf(f4(a[r], q), f4(bv[q], cc), acc[r][cc]);
    }
    if (c == nk - 1) tile_out(acc, b, s, y, t);
  };
  ring_loop<kDepth>(cdiv(n, kTileM) * nk, ring, kF32Fat, stage, consume);
}

// y of the CTA's n positions element by element (the forward's x or w
// not 16-byte aligned): the tiled path's stages (32 channels bf16, 16
// f32), two deep, gathered through the position table.
__device__ __forceinline__ void cluster_conv_elems(const bf16* x,
                                                   const bf16* w,
                                                   const bf16* __restrict__ b,
                                                   const Shape& s, int n,
                                                   const int2* pos, float* y,
                                                   bf16* ring) {
  const int tid = threadIdx.x, K = 9 * s.Ci, nk = cdiv(K, kTcK);
  const int row = tid >> 2, q = tid & 3;
  const bf16 zero = __ushort_as_bfloat16(0);
  float acc[4][4] = {};
  auto stage = [&](int g, bf16* buf) {
    const int t = g / nk, k0 = (g - t * nk) * kTcK;
    const int kend = min(kTcK, 16 * cdiv(K - k0, 16));
    const int2 pv = pos[t * kTileM + row];
#pragma unroll 1
    for (int kk = q; kk < kend; kk += 4) {
      const int k = k0 + kk, tap = k / s.Ci;
      buf[row * kLdA + kk] = k < K && ((pv.y >> tap) & 1)
                                 ? x[pv.x + tap_off(tap, s) + k - tap * s.Ci]
                                 : zero;
    }
    for (int e = tid; e < kend * kTileN; e += kThreads) {
      const int k = k0 + e / kTileN, co = e % kTileN;
      buf[kTcSliceA + (e / kTileN) * kLdB + co] =
          (k < K && co < s.Co) ? w[(size_t)k * s.Co + co] : zero;
    }
  };
  auto consume = [&](int g, const bf16* buf) {
    const int t = g / nk, c = g - t * nk;
    tc_stage_nn(buf, buf + kTcSliceA, acc, K - c * kTcK > 16 ? 2 : 1);
    if (c == nk - 1) tile_out(acc, b, s, y, t);
  };
  ring_loop<2>(cdiv(n, kTileM) * nk, ring, kTcStage, stage, consume);
}
__device__ __forceinline__ void cluster_conv_elems(const float* x,
                                                   const float* w,
                                                   const float* __restrict__ b,
                                                   const Shape& s, int n,
                                                   const int2* pos, float* y,
                                                   float* ring) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int K = 9 * s.Ci, nk = cdiv(K, kTileK);
  float acc[4][4] = {};
  auto stage = [&](int g, float* buf) {
    const int t = g / nk, k0 = (g - t * nk) * kTileK;
    for (int e = tid; e < kTileM * kTileK; e += kThreads) {
      const int r = e / kTileK, k = k0 + e % kTileK, tap = k / s.Ci;
      const int2 pv = pos[t * kTileM + r];
      buf[r * kLdK + e % kTileK] =
          k < K && ((pv.y >> tap) & 1)
              ? x[pv.x + tap_off(tap, s) + k - tap * s.Ci]
              : 0.f;
    }
    for (int e = tid; e < kTileK * kTileN; e += kThreads) {
      const int k = k0 + e / kTileN, co = e % kTileN;
      buf[kSliceA + e] = (k < K && co < s.Co) ? w[(size_t)k * s.Co + co] : 0.f;
    }
  };
  auto consume = [&](int g, const float* buf) {
    const int t = g / nk, c = g - t * nk;
    mma_nn(buf, buf + kSliceA, acc, tx, ty);
    if (c == nk - 1) tile_out(acc, b, s, y, t);
  };
  ring_loop<2>(cdiv(n, kTileM) * nk, ring, kStage, stage, consume);
}

// y of the CTA's n positions where Ci == 1 (block 1: 9 taps, x and w in
// shared memory), on the CUDA cores: thread (co, pg) takes channel co of
// rows pg, pg + 4, .., y = b + sum over the taps in the image of x w, taps
// in order, each product of two bf16 exact in f32 (a tensor-core tile
// would use 9 of 16 reduction rows and restage w for every tile).
template <typename T>
__device__ __forceinline__ void cluster_conv_taps(const T* x, const T* w,
                                                  const T* __restrict__ b,
                                                  const Shape& s, int n,
                                                  const int2* pos, float* y) {
  const int co = threadIdx.x & (kTileN - 1), pg = threadIdx.x / kTileN;
  float wt[9];
  int off[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    wt[t] = co < s.Co ? ld(w + (size_t)t * s.Co + co) : 0.f;
    off[t] = tap_off(t, s);
  }
  const float bias = co < s.Co ? ld(b + co) : 0.f;
#pragma unroll 4
  for (int r = pg; r < n; r += 4) {
    const int2 pv = pos[r];
    float a = bias;
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if ((pv.y >> t) & 1) a = fmaf(ld(x + (pv.x + off[t])), wt[t], a);
    y[r * kLdC + co] = a;
  }
  __syncthreads();
}

// BN statistics of the task: the CTA's n rows of y in two passes (4 row
// groups a channel, rows g, g + 4, ..; then the groups in order; the
// divisions by __fdividef, whose IEEE form's slow path is a call that
// makes ptxas spill around it) ->
// cst[c] = (mean, M2); after a cluster barrier, every rank's in rank order
// by Chan's combine, mean = sum n_q mean_q / M, M2 = sum M2_q + n_q
// (mean_q - mean)^2 -> par[0] = mean, par[1] = inv_std, in every CTA.
// red: 5 kTileN floats of scratch.
__device__ __forceinline__ void cluster_bn_stats(cg::cluster_group& cluster,
                                                 const Shape& s, int tiles,
                                                 int n, const float* y,
                                                 float* red, ClusterSmem& sm) {
  const int tid = threadIdx.x, col = tid & (kTileN - 1), part = tid / kTileN;
  float* mean = red + 4 * kTileN;
  float a = 0.f;
#pragma unroll 4
  for (int r = part; r < n; r += 4) a += y[r * kLdC + col];
  red[part * kTileN + col] = a;
  __syncthreads();
  if (tid < kTileN)
    mean[col] = __fdividef(red[col] + red[kTileN + col] +
                               red[2 * kTileN + col] + red[3 * kTileN + col],
                           (float)n);
  __syncthreads();
  const float mu = mean[col];
  a = 0.f;
#pragma unroll 4
  for (int r = part; r < n; r += 4) {
    const float d = y[r * kLdC + col] - mu;
    a += d * d;
  }
  red[part * kTileN + col] = a;
  __syncthreads();
  if (tid < kTileN)
    sm.cst[col] = make_float2(mu, red[col] + red[kTileN + col] +
                                      red[2 * kTileN + col] +
                                      red[3 * kTileN + col]);
  cluster.sync();
  if (tid < kTileN) {
    const int size = (int)cluster.num_blocks();
    float2 v[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < size) v[q] = *cluster.map_shared_rank(sm.cst + col, q);
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < size)
        sum += (float)(rank_m0(q + 1, tiles, s.M) - rank_m0(q, tiles, s.M)) *
               v[q].x;
    const float mt = __fdividef(sum, (float)s.M);
    float m2 = 0.f;
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < size) {
        const float d = v[q].x - mt;
        m2 += v[q].y + (float)(rank_m0(q + 1, tiles, s.M) -
                               rank_m0(q, tiles, s.M)) * d * d;
      }
    sm.par[0][col] = mt;
    sm.par[1][col] = rsqrtf(__fdividef(m2, (float)s.M) + kEps);
  }
  __syncthreads();
}

// How a cluster kernel takes its conv: the forward's fat stages (Ci % 64
// == 0, aligned), its element path (unaligned), or block 1's taps from x
// and w copied to shared memory (bwd_params)
constexpr int kConvFat = 0, kConvElems = 1, kConvTaps = 2;

// The start of both cluster kernels: scale and bias into par[2], par[3];
// for kConvTaps x and w copied (x then holds images from nf); the position
// table; the conv of the CTA's tiles into y; the statistics
// (cluster_bn_stats). -> x as the dw sums read it.
template <typename T, int kConv>
__device__ __forceinline__ const T* cluster_forward(
    cg::cluster_group& cluster, const T* x, const T* w, const T* b,
    const T* sc, const T* be, const ClusterPlan& p, const Shape& s, int m0,
    int m1, ClusterSmem& sm) {
  const int c = threadIdx.x;
  if (c < kTileN) {
    sm.par[2][c] = c < s.Co ? ld(sc + c) : 0.f;
    sm.par[3][c] = c < s.Co ? ld(be + c) : 0.f;
  }
  int nf = 0;
  if constexpr (kConv == kConvTaps) {
    const int hw = s.Ho * s.Wo, nl = (m1 - 1) / hw;
    const size_t img = (size_t)s.H * s.W * s.Ci;
    nf = m0 / hw;
    copy_span(reinterpret_cast<T*>(sm.xspan), x + nf * img, (nl - nf + 1) * img);
    copy_span(reinterpret_cast<T*>(sm.wspan), w, (size_t)9 * s.Ci * s.Co);
    x = reinterpret_cast<const T*>(sm.xspan);
    w = reinterpret_cast<const T*>(sm.wspan);
  }
  cluster_positions(sm.pos, s, m0, m1, nf, p.tiles * kTileM);
  __syncthreads();
  T* ring = reinterpret_cast<T*>(sm.ring);
  if constexpr (kConv == kConvFat)
    cluster_conv_fat<std::is_same<T, bf16>::value ? kConvDepthTc
                                                  : kConvDepthF32>(
        x, w, b, s, m1 - m0, sm.pos, sm.y, ring);
  else if constexpr (kConv == kConvTaps)
    cluster_conv_taps(x, w, b, s, m1 - m0, sm.pos, sm.y);
  else
    cluster_conv_elems(x, w, b, s, m1 - m0, sm.pos, sm.y, ring);
  cluster_bn_stats(cluster, s, p.tiles, m1 - m0, sm.y,
                   reinterpret_cast<float*>(sm.ring), sm);
  return x;
}

// cnn4_block_fwd of one task in one launch: grid (cluster size), one
// cluster, the plan p. out = relu((y - mean) inv_std scale + bias) from y
// in shared memory, stored in T (16 bytes a row piece where `vec`).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
fwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, const T* __restrict__ sc,
                   const T* __restrict__ be, T* __restrict__ out,
                   ClusterPlan p, bool vec, Shape s) {
  extern __shared__ __align__(16) unsigned char cl_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  ClusterSmem sm(cl_smem, p);
  const int rank = (int)cluster.block_rank();
  const int m0 = rank_m0(rank, p.tiles, s.M);
  const int m1 = rank_m0(rank + 1, p.tiles, s.M), n = m1 - m0;
  cluster_forward<T, kVec ? kConvFat : kConvElems>(cluster, x, w, b, sc, be,
                                                   p, s, m0, m1, sm);
  const float(*par)[kTileN] = sm.par;
  for (int e = threadIdx.x; e < n * (kTileN / 4); e += kThreads) {
    const int row = e >> 4, col = 4 * (e & 15);
    if (col >= s.Co) continue;
    const float4 y = *reinterpret_cast<const float4*>(sm.y + row * kLdC + col);
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = fmaxf((f4(y, u) - par[0][col + u]) * par[1][col + u] *
                       par[2][col + u] + par[3][col + u], 0.f);
    store_row4(out + (size_t)(m0 + row) * s.Co + col,
               make_float4(v[0], v[1], v[2], v[3]), s.Co - col, vec);
  }
  cluster.sync();  // no CTA leaves while a peer may read its cst
}

// The dw partial where Ci == 1 (block 1: 9 rows), on the CUDA cores:
// thread (co, pg) sums x_tap dy over rows pg, pg + 4, .. of the CTA's n
// positions in order, the 9 taps in 9 chains; the 4 position groups are
// then added in order through `red` (4 x 9 x kTileN floats) -> part.
template <typename T>
__device__ __forceinline__ void cluster_dw_taps(const T* x, const Shape& s,
                                                int n, const int2* pos,
                                                const float* dyb, float* red,
                                                float* part) {
  const int co = threadIdx.x & (kTileN - 1), pg = threadIdx.x / kTileN;
  float acc[9];
  int off[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    acc[t] = 0.f;
    off[t] = tap_off(t, s);
  }
#pragma unroll 4
  for (int r = pg; r < n; r += 4) {
    const int2 pv = pos[r];
    const float d = dyb[r * kLdC + co];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      if ((pv.y >> t) & 1) acc[t] = fmaf(ld(x + (pv.x + off[t])), d, acc[t]);
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) red[(pg * 9 + t) * kTileN + co] = acc[t];
  __syncthreads();
  for (int e = threadIdx.x; e < 9 * kTileN; e += kThreads) {
    const int t = e / kTileN, c = e % kTileN;
    part[t * kLdC + c] = ((red[t * kTileN + c] + red[(9 + t) * kTileN + c]) +
                          red[(18 + t) * kTileN + c]) +
                         red[(27 + t) * kTileN + c];
  }
}

// cnn4_block_bwd_params of one task in one launch where Ci == 1 (block 1;
// x and w copied to shared memory by the plan): dy (f32), dw, db, dscale
// and dbias. grid (cluster size), one cluster, the plan p. After the
// forward's y and statistics (cluster_forward), the BN-backward sums over
// the CTA's rows (16 row groups a channel, rows g, g + 16, .., then the
// groups in order), combined over the ranks in rank order after a cluster
// barrier; dy = inv_std (dz scale - m1 - xhat m2) in place of y and
// stored, with the CTA's db partial; then the CTA's dw partial
// (cluster_dw_taps), a cluster barrier, after which each CTA sums its share
// of dw's 9 rows over the ranks in rank order and stores them (rank 0 db).
// `vec`: g, dy and dw rows by 16 bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_params_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ b, const T* __restrict__ sc,
                          const T* __restrict__ be, const T* __restrict__ g,
                          float* __restrict__ dy, T* __restrict__ dw,
                          T* __restrict__ db, T* __restrict__ dsc,
                          T* __restrict__ dbe, ClusterPlan p, bool vec,
                          Shape s) {
  extern __shared__ __align__(16) unsigned char cl_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  ClusterSmem sm(cl_smem, p);
  const int tid = threadIdx.x, rank = (int)cluster.block_rank();
  const int size = (int)cluster.num_blocks();
  const int m0 = rank_m0(rank, p.tiles, s.M);
  const int m1 = rank_m0(rank + 1, p.tiles, s.M), n = m1 - m0;
  const T* xs =
      cluster_forward<T, kConvTaps>(cluster, x, w, b, sc, be, p, s, m0, m1,
                                    sm);
  float* red = reinterpret_cast<float*>(sm.ring);  // [2][kGroupsRed][kTileN]
  float(*par)[kTileN] = sm.par;

  // the BN-backward sums of the CTA's rows: thread (rg, q) on rows rg, rg
  // + 16, .. of channels 4q .. 4q + 3
  const int col = 4 * (tid & 15), rg = tid >> 4, limit = s.Co - col;
  {
    float sx[4] = {0.f, 0.f, 0.f, 0.f}, sz[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = rg; r < n && limit > 0; r += kGroupsRed) {
      const float4 yv = *reinterpret_cast<const float4*>(sm.y + r * kLdC + col);
      const float4 gv = load_row4(g + (size_t)(m0 + r) * s.Co + col, limit, vec);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float xh;
        const float dz = bn_dz(f4(yv, u), f4(gv, u), par[0][col + u],
                               par[1][col + u], par[2][col + u],
                               par[3][col + u], xh);
        sx[u] += dz * xh;
        sz[u] += dz;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      red[rg * kTileN + col + u] = sx[u];
      red[(kGroupsRed + rg) * kTileN + col + u] = sz[u];
    }
    __syncthreads();
    if (tid < kTileN) {
      float a = 0.f, c = 0.f;
      for (int r = 0; r < kGroupsRed; ++r) {
        a += red[r * kTileN + tid];
        c += red[(kGroupsRed + r) * kTileN + tid];
      }
      sm.csum[tid] = make_float2(a, c);
    }
  }
  cluster.sync();
  if (tid < kTileN) {
    float2 v[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < size) v[q] = *cluster.map_shared_rank(sm.csum + tid, q);
    float ds = 0.f, dbs = 0.f;
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < size) {
        ds += v[q].x;
        dbs += v[q].y;
      }
    if (rank == 0 && tid < s.Co) {
      st(dsc + tid, ds);
      st(dbe + tid, dbs);
    }
    const float scale = par[2][tid];
    par[4][tid] = __fdividef(scale * dbs, (float)s.M);
    par[5][tid] = __fdividef(scale * ds, (float)s.M);
  }
  __syncthreads();

  // dy in place of y, stored, and the CTA's db partial
  {
    float dba[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = rg; r < n && limit > 0; r += kGroupsRed) {
      float* yr = sm.y + r * kLdC + col;
      const float4 yv = *reinterpret_cast<const float4*>(yr);
      const float4 gv = load_row4(g + (size_t)(m0 + r) * s.Co + col, limit, vec);
      float d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float xh;
        const int c = col + u;
        const float dz = bn_dz(f4(yv, u), f4(gv, u), par[0][c], par[1][c],
                               par[2][c], par[3][c], xh);
        d[u] = par[1][c] * (fmaf(dz, par[2][c], -par[4][c]) - xh * par[5][c]);
        dba[u] += d[u];
      }
      const float4 dv = make_float4(d[0], d[1], d[2], d[3]);
      st4(yr, dv);
      store_row4(dy + (size_t)(m0 + r) * s.Co + col, dv, limit, vec);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) red[rg * kTileN + col + u] = dba[u];
    __syncthreads();
    if (tid < kTileN) {
      float a = 0.f;
      for (int r = 0; r < kGroupsRed; ++r) a += red[r * kTileN + tid];
      sm.dbp[tid] = a;
    }
    __syncthreads();
  }

  // dw: the CTA's partial, a cluster barrier, then rows [rb, re) of the 9
  // are this CTA's to sum over the ranks in order and store
  cluster_dw_taps(xs, s, n, sm.pos, sm.y, red, sm.part);
  cluster.sync();
  const int per = cdiv(9, size), rb = min(9, rank * per);
  const int each = (min(9, rb + per) - rb) * (kTileN / 4);
  for (int e = tid; e < each; e += kThreads) {
    const int row = rb + (e >> 4), c4 = 4 * (e & 15);
    if (c4 >= s.Co) continue;
    float4 v[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < size)
        v[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(sm.part + row * kLdC + c4, q));
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < size) {
        a.x += v[q].x;
        a.y += v[q].y;
        a.z += v[q].z;
        a.w += v[q].w;
      }
    store_row4(dw + (size_t)row * s.Co + c4, a, s.Co - c4, vec);
  }
  if (rank == 0 && tid < s.Co) {
    float v[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < size) v[q] = *cluster.map_shared_rank(sm.dbp + tid, q);
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < size) a += v[q];
    st(db + tid, a);
  }
  cluster.sync();  // no CTA leaves while a peer may read its partials
}

Shape make_shape(int N, int H, int W, int Ci, int Co) {
  Shape s;
  s.N = N; s.H = H; s.W = W; s.Ci = Ci; s.Co = Co;
  s.Ho = (H - 1) / 2 + 1;
  s.Wo = (W - 1) / 2 + 1;
  s.M = N * s.Ho * s.Wo;
  return s;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

bool tc_vec(const bf16* x, const bf16* w, const Shape& s) {
  return s.Ci % kTcK == 0 && s.Co % 8 == 0 && aligned16(x) && aligned16(w);
}

// The forward's fat stages (cluster_conv_fat): whole taps of 64 channels,
// copied 16 bytes at a time.
template <typename T>
bool fat_vec(const T* x, const T* w, const Shape& s) {
  return s.Ci % kCW == 0 && s.Co % 8 == 0 && aligned16(x) && aligned16(w);
}

// The route of one call at B = 1 (cuda/cnn4_cuda.py:cluster_plan mirrors
// it) on clusters of at most `cmax` CTAs (cluster_max): 0 < Co <= 64, Co
// % 8 == 0, and for the forward Ci % 64 == 0 and at most kFwdTilesMax
// tiles a CTA, for bwd_params Ci == 1 (block 1: x and w copied to shared
// memory) and at most kBwdTilesMax; the CTA's shared memory within
// kClusterSmemMax. size = ceil(tiles of the task / ceil(tiles / cmax)), and
// a CTA owns ceil(tiles of the task / size) tiles. The copy of x holds the
// images a CTA's positions can read, ceil(tiles 64 / (Ho Wo)) + 1 of them
// at most N.
int round16(int bytes) { return (bytes + 15) / 16 * 16; }
bool cluster_plan(const Shape& s, bool bf16, bool bwd, int cmax,
                  ClusterPlan& p) {
  if (s.M == 0 || s.Co > kTileN || s.Co % 8 != 0 ||
      !(bwd ? s.Ci == 1 : s.Ci % kCW == 0))
    return false;
  const int ntiles = cdiv(s.M, kTileM), item = bf16 ? 2 : 4;
  p.size = cdiv(ntiles, cdiv(ntiles, cmax));
  p.tiles = cdiv(ntiles, p.size);
  if (p.tiles > (bwd ? kBwdTilesMax : kFwdTilesMax)) return false;
  p.ring = cluster_ring_bytes(bf16, !bwd);
  p.xspan = p.wspan = 0;
  if (bwd) {
    const int images =
        std::min(s.N, cdiv(p.tiles * kTileM, s.Ho * s.Wo) + 1);
    p.xspan = round16(images * s.H * s.W * s.Ci * item);
    p.wspan = round16(9 * s.Ci * s.Co * item);
  }
  p.smem = p.ring + kAuxBytes + p.tiles * kTileM * (int)sizeof(int2) +
           p.tiles * kTileYBytes + p.xspan + p.wspan + (bwd ? kPartBytes : 0);
  return p.smem <= kClusterSmemMax;
}

// The most CTAs a cluster this device schedules: the cluster kernels'
// dynamic shared-memory attribute (227 KB) and the non-portable size are
// set once a device, as dw_tc_smem_once's attribute, and each instance is
// asked whether a cluster of kClusterMax CTAs at that much shared memory
// can be scheduled; kClusterMax where all can, kClusterPortable else. A
// plan the device then cannot launch fails at its launch.
cudaError_t cluster_max(int& cmax) {
  static std::atomic<int> known[kMaxDevices];  // zero: not yet asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  cmax = known[dev].load(std::memory_order_acquire);
  if (cmax != 0) return cudaSuccess;
  cmax = kClusterMax;
  auto ask = [&cmax](auto* kern) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kClusterMax, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kClusterSmemMax;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterMax;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) {  // a size the device refuses to consider
      cudaGetLastError();
      clusters = 0;
    }
    if (clusters == 0) cmax = kClusterPortable;
    return cudaSuccess;
  };
  for (cudaError_t err :
       {ask(fwd_cluster_kernel<float, true>),
        ask(fwd_cluster_kernel<float, false>),
        ask(fwd_cluster_kernel<bf16, true>),
        ask(fwd_cluster_kernel<bf16, false>),
        ask(bwd_params_cluster_kernel<float>),
        ask(bwd_params_cluster_kernel<bf16>)})
    if (err != cudaSuccess) return err;
  known[dev].store(cmax, std::memory_order_release);
  return cudaSuccess;
}

// Whether one call takes the cluster route, and its plan: B = 1 and
// cluster_plan on this device's cluster_max.
cudaError_t cluster_route(int B, const Shape& s, bool bf16, bool bwd,
                          ClusterPlan& p, bool& planned) {
  planned = false;
  if (B != 1) return cudaSuccess;
  int cmax = 0;
  const cudaError_t e = cluster_max(cmax);
  if (e != cudaSuccess) return e;
  planned = cluster_plan(s, bf16, bwd, cmax, p);
  return cudaSuccess;
}

// One launch of a cluster kernel on the plan: grid (size), one cluster of
// `size` CTAs. A launch the device refuses returns its error.
template <typename... Params, typename... Args>
int launch_cluster(void (*kern)(Params...), const ClusterPlan& p,
                   cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.size, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd_cluster(const T* x, const T* w, const T* b, const T* sc,
                       const T* be, T* out, const Shape& s,
                       const ClusterPlan& p, cudaStream_t st) {
  const bool vec = aligned16(out);
  if (fat_vec(x, w, s))
    return launch_cluster(fwd_cluster_kernel<T, true>, p, st, x, w, b, sc,
                          be, out, p, vec, s);
  return launch_cluster(fwd_cluster_kernel<T, false>, p, st, x, w, b, sc,
                        be, out, p, vec, s);
}

template <typename T>
int launch_bwd_params_cluster(const T* x, const T* w, const T* b,
                              const T* sc, const T* be, const T* g, float* dy,
                              T* dw, T* db, T* dsc, T* dbe, const Shape& s,
                              const ClusterPlan& p, cudaStream_t st) {
  const bool vec = aligned16(g) && aligned16(dy) && aligned16(dw);
  return launch_cluster(bwd_params_cluster_kernel<T>, p, st, x, w, b, sc, be,
                        g, dy, dw, db, dsc, dbe, p, vec, s);
}

// Kernels A and C of the forward: y = conv + bias (f32) and per (task,
// channel) stats = (mean, inv_std); tstats holds the tile statistics
// between them. bf16 takes the tensor cores (fwd_conv_stats_tc_kernel).
template <typename T>
int conv_stats(const T* x, const T* w, const T* b, float* y, float2* tstats,
               float2* stats, int B, const Shape& s, cudaStream_t st) {
  const int ntiles = cdiv(s.M, kTileM);
  const dim3 grid(ntiles, cdiv(s.Co, kTileN), B);
  if constexpr (std::is_same<T, bf16>::value) {
    if (tc_vec(x, w, s))
      fwd_conv_stats_tc_kernel<true><<<grid, kThreads, 0, st>>>(x, w, b, y,
                                                                tstats, s);
    else
      fwd_conv_stats_tc_kernel<false><<<grid, kThreads, 0, st>>>(x, w, b, y,
                                                                 tstats, s);
  } else if (s.Ci % kTileK == 0 && s.Co % 4 == 0 && aligned16(x) &&
             aligned16(w)) {
    fwd_conv_stats_kernel<true><<<grid, kThreads, 0, st>>>(x, w, b, y,
                                                            tstats, s);
  } else {
    fwd_conv_stats_kernel<false><<<grid, kThreads, 0, st>>>(x, w, b, y,
                                                             tstats, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_combine_kernel<<<dim3(cdiv(s.Co, kTileN), B), kTileN, 0, st>>>(
      tstats, stats, ntiles, s);
  return (int)cudaGetLastError();
}

// ws: f32 scratch of cuda/cnn4_cuda.py:fwd_workspace_floats (the tiled
// route's; a planned cluster launch takes none).
template <typename T>
int launch_fwd(const T* x, const T* w, const T* b, const T* sc, const T* be,
               T* out, float* ws, int B, const Shape& s, cudaStream_t st) {
  if (B == 0 || s.M == 0) return 0;
  ClusterPlan plan;
  bool planned;
  const cudaError_t e =
      cluster_route(B, s, std::is_same<T, bf16>::value, false, plan, planned);
  if (e != cudaSuccess) return (int)e;
  if (planned) return launch_fwd_cluster(x, w, b, sc, be, out, s, plan, st);
  const int ntiles = cdiv(s.M, kTileM);
  const dim3 grid(ntiles, cdiv(s.Co, kTileN), B);
  float2* tstats = reinterpret_cast<float2*>(ws);
  float2* stats = tstats + (size_t)B * ntiles * s.Co;
  float* y;  // y between kernels A and B
  if constexpr (std::is_same<T, float>::value) {
    y = out;
  } else {
    y = reinterpret_cast<float*>(stats + (size_t)B * s.Co);
  }
  const int err = conv_stats(x, w, b, y, tstats, stats, B, s, st);
  if (err != 0) return err;
  fwd_norm_kernel<T><<<grid, kThreads, 0, st>>>(sc, be, y, stats, out, s);
  return (int)cudaGetLastError();
}

// Positions per chunk of the dw GEMM's reduction: enough chunks that the
// grid holds about kDwCtas CTAs (two waves of bwd_dw_kernel's two CTAs an
// SM on an H100's 132), none shorter than kDwMinChunk, a whole number of
// stages (cuda/cnn4_cuda.py:dw_chunk mirrors this).
constexpr int kDwCtas = 4 * 132;
constexpr int kDwMinChunk = 256;
int dw_chunk(const Shape& s, int B) {
  const int tiles = B * cdiv(9 * s.Ci, kTileM) * cdiv(s.Co, kTileN);
  const int want = std::max(
      1, std::min(cdiv(kDwCtas, tiles), cdiv(s.M, kDwMinChunk)));
  return cdiv(cdiv(s.M, want), kTileK) * kTileK;
}

// ws: f32 scratch of cuda/cnn4_cuda.py:bwd_params_workspace_floats, in
// order: tile statistics, then tile sums [B][tiles][Co] (float2); stats
// and consts [B][Co] (float2); y [B][M][Co]; the dw partials [B][chunks]
// [9 Ci Co + Co] where there is more than one chunk; in bf16, dy's three
// terms [3][B][M][Co] (bf16). A planned cluster launch takes none.
template <typename T>
int launch_bwd_params(const T* x, const T* w, const T* b, const T* sc,
                      const T* be, const T* g, float* dy, T* dw, T* db,
                      T* dsc, T* dbe, float* ws, int B, const Shape& s,
                      cudaStream_t st) {
  if (B == 0) return 0;
  const int K = 9 * s.Ci;
  if (s.M == 0) {  // no positions: every sum is empty
    const size_t per = (size_t)B * s.Co * sizeof(T);
    cudaMemsetAsync(dw, 0, K * per, st);
    cudaMemsetAsync(db, 0, per, st);
    cudaMemsetAsync(dsc, 0, per, st);
    cudaMemsetAsync(dbe, 0, per, st);
    return (int)cudaGetLastError();
  }
  ClusterPlan plan;
  bool planned;
  const cudaError_t e =
      cluster_route(B, s, std::is_same<T, bf16>::value, true, plan, planned);
  if (e != cudaSuccess) return (int)e;
  if (planned)
    return launch_bwd_params_cluster(x, w, b, sc, be, g, dy, dw, db, dsc, dbe,
                                     s, plan, st);
  const int ntiles = cdiv(s.M, kTileM), nct = cdiv(s.Co, kTileN);
  float2* tsums = reinterpret_cast<float2*>(ws);
  float2* stats = tsums + (size_t)B * ntiles * s.Co;
  float2* consts = stats + (size_t)B * s.Co;
  float* y = reinterpret_cast<float*>(consts + (size_t)B * s.Co);
  float* part = y + (size_t)B * s.M * s.Co;
  int err = conv_stats(x, w, b, y, tsums, stats, B, s, st);
  if (err != 0) return err;
  // y, g and dy rows by 16 bytes (ws keeps y's rows aligned when Co % 4 == 0)
  const bool vec = s.Co % 4 == 0 && aligned16(g) && aligned16(dy) &&
                   aligned16(ws);
  bwd_tile_sums_kernel<T><<<dim3(ntiles, nct, B), kThreads, 0, st>>>(
      sc, be, g, y, stats, tsums, vec, s);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  bwd_combine_kernel<T><<<dim3(nct, B), kTileN, 0, st>>>(tsums, sc, consts,
                                                         dsc, dbe, ntiles, s);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int chunk = dw_chunk(s, B), nchunks = cdiv(s.M, chunk);
  const dim3 grid(nchunks, cdiv(K, kTileM) * nct, B);
  const bool xvec = s.Ci % 4 == 0 && aligned16(x);
  if constexpr (std::is_same<T, bf16>::value) {
    err = (int)dw_tc_smem_once();
    if (err != 0) return err;
    bf16* terms = reinterpret_cast<bf16*>(
        part + (nchunks > 1 ? (size_t)B * nchunks * ((size_t)K * s.Co + s.Co)
                            : 0));
    bwd_dy_split_kernel<<<dim3(ntiles, nct, B), kThreads, 0, st>>>(
        sc, be, g, y, stats, consts, dy, terms, vec, B, s);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const bool vec8 = s.Co % 8 == 0 && aligned16(terms);
    if (s.Ci % 8 == 0 && aligned16(x))
      bwd_dw_tc_kernel<true><<<grid, kDwThreads, kDwSmem, st>>>(
          x, terms, dw, db, part, chunk, vec8, B, s);
    else
      bwd_dw_tc_kernel<false><<<grid, kDwThreads, kDwSmem, st>>>(
          x, terms, dw, db, part, chunk, vec8, B, s);
  } else if (xvec) {
    bwd_dw_kernel<true><<<grid, kThreads, 0, st>>>(
        x, sc, be, g, y, stats, consts, dy, dw, db, part, chunk, vec, s);
  } else {
    bwd_dw_kernel<false><<<grid, kThreads, 0, st>>>(
        x, sc, be, g, y, stats, consts, dy, dw, db, part, chunk, vec, s);
  }
  err = (int)cudaGetLastError();
  if (err != 0 || nchunks == 1) return err;
  const size_t outs = (size_t)B * ((size_t)K * s.Co + s.Co);
  bwd_dw_reduce_kernel<T><<<(unsigned)((outs + kThreads - 1) / kThreads),
                            kThreads, 0, st>>>(part, dw, db, nchunks, B, s);
  return (int)cudaGetLastError();
}

// f32 on the CUDA cores (bwd_input_kernel), bf16 on the tensor cores
// (bwd_input_tc_kernel); one launch, no workspace.
template <typename T>
int launch_bwd_input(const float* dy, const T* w, T* dx, int B,
                     const Shape& s, cudaStream_t st) {
  int tiles = 0;
  for (int cls = 0; cls < 4; ++cls)
    tiles += cdiv(s.N * class_extent(s.H, class_ph(cls)) *
                      class_extent(s.W, class_pw(cls)),
                  kTileM);
  if (B == 0 || tiles == 0) return 0;
  const dim3 grid(tiles, cdiv(s.Ci, kTileN), B);
  if constexpr (std::is_same<T, bf16>::value) {
    const bool vec8 = s.Ci % 8 == 0 && aligned16(dx);
    if (s.Co % 8 == 0 && aligned16(dy) && aligned16(w))
      bwd_input_tc_kernel<true><<<grid, kThreads, 0, st>>>(dy, w, dx, vec8,
                                                           s);
    else
      bwd_input_tc_kernel<false><<<grid, kThreads, 0, st>>>(dy, w, dx, vec8,
                                                            s);
  } else if (s.Co % kTileK == 0 && aligned16(dy) && aligned16(w)) {
    bwd_input_kernel<true><<<grid, kThreads, 0, st>>>(dy, w, dx, s);
  } else {
    bwd_input_kernel<false><<<grid, kThreads, 0, st>>>(dy, w, dx, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32,
// 1 = bfloat16. Each returns a cudaError_t code; 0 means launched.
extern "C" {

// ws: f32 scratch of cuda/cnn4_cuda.py:fwd_workspace_floats(...) floats.
int cnn4_block_fwd(int dtype, const void* x, const void* w, const void* b,
                   const void* sc, const void* be, void* out, void* ws, int B,
                   int N, int H, int W, int Ci, int Co, void* stream) {
  const Shape s = make_shape(N, H, W, Ci, Co);
  cudaStream_t st = (cudaStream_t)stream;
  using F = float;
  using H16 = __nv_bfloat16;
  if (dtype == 0)
    return launch_fwd<F>((const F*)x, (const F*)w, (const F*)b, (const F*)sc,
                         (const F*)be, (F*)out, (float*)ws, B, s, st);
  if (dtype == 1)
    return launch_fwd<H16>((const H16*)x, (const H16*)w, (const H16*)b,
                           (const H16*)sc, (const H16*)be, (H16*)out,
                           (float*)ws, B, s, st);
  return (int)cudaErrorInvalidValue;
}

// ws: f32 scratch of cuda/cnn4_cuda.py:bwd_params_workspace_floats(...)
// floats.
int cnn4_block_bwd_params(int dtype, const void* x, const void* w,
                          const void* b, const void* sc, const void* be,
                          const void* g, void* dy, void* dw, void* db,
                          void* dsc, void* dbe, void* ws, int B, int N, int H,
                          int W, int Ci, int Co, void* stream) {
  const Shape s = make_shape(N, H, W, Ci, Co);
  cudaStream_t st = (cudaStream_t)stream;
  using F = float;
  using H16 = __nv_bfloat16;
  if (dtype == 0)
    return launch_bwd_params<F>((const F*)x, (const F*)w, (const F*)b,
                                (const F*)sc, (const F*)be, (const F*)g,
                                (float*)dy, (F*)dw, (F*)db, (F*)dsc, (F*)dbe,
                                (float*)ws, B, s, st);
  if (dtype == 1)
    return launch_bwd_params<H16>((const H16*)x, (const H16*)w, (const H16*)b,
                                  (const H16*)sc, (const H16*)be,
                                  (const H16*)g, (float*)dy, (H16*)dw,
                                  (H16*)db, (H16*)dsc, (H16*)dbe, (float*)ws,
                                  B, s, st);
  return (int)cudaErrorInvalidValue;
}

// The route cnn4_block_fwd (kernel 0) or cnn4_block_bwd_params (kernel 1)
// takes at a shape on the current device: out = (cluster size, dynamic
// shared-memory bytes) of its one cluster, or (0, 0) for the tiled kernels.
// Returns a cudaError_t code.
int cnn4_cluster_plan(int dtype, int kernel, int B, int N, int H, int W,
                      int Ci, int Co, int* out) {
  ClusterPlan p;
  bool planned;
  const cudaError_t e = cluster_route(B, make_shape(N, H, W, Ci, Co),
                                      dtype == 1, kernel == 1, p, planned);
  out[0] = planned ? p.size : 0;
  out[1] = planned ? p.smem : 0;
  return (int)e;
}

// The most CTAs a cluster on the current device (cluster_max) into out[0].
// Returns a cudaError_t code.
int cnn4_cluster_max(int* out) { return (int)cluster_max(out[0]); }

int cnn4_block_bwd_input(int dtype, const void* dy, const void* w, void* dx,
                         int B, int N, int H, int W, int Ci, int Co,
                         void* stream) {
  const Shape s = make_shape(N, H, W, Ci, Co);
  cudaStream_t st = (cudaStream_t)stream;
  using H16 = __nv_bfloat16;
  if (dtype == 0)
    return launch_bwd_input<float>((const float*)dy, (const float*)w,
                                   (float*)dx, B, s, st);
  if (dtype == 1)
    return launch_bwd_input<H16>((const float*)dy, (const H16*)w, (H16*)dx, B,
                                 s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// ===========================================================================
// cnn4_block_double_bwd: the VJP of the block's backward (second-order MAML)
// ===========================================================================
//
// Second-order MAML differentiates the inner step's backward, (x, w, b,
// scale, bias, g) -> (dx, dw, db, dscale, dbias), once more
// (cuda/cnn4_cuda.py:FusedBlockBackward). No TPU kernel stands behind
// this section: JAX takes that derivative as plain XLA (_bwd_op_jvp,
// cnn4_pallas.py:538). The maths is derived in full in the wrapper's twin,
// cuda/cnn4_cuda.py:block_double_bwd_plain. Per (task, channel), with the
// forward's xhat, inv_std and ReLU mask, gz = g mask, and the backward dy =
// inv (gz s - mean(gz s) - xhat mean(gz s xhat)), the VJP at the
// cotangents (c_dx, c_dw, c_db, c_ds, c_dbias) is three sums of
// convolutions, each one implicit GEMM with its reduction doubled, and a BN
// step between them:
//   A  dbl_conv_kernel       v = conv(c_dx, w) + conv(x, c_dw) + c_db, dy's
//      cotangent, and in the same K loop the re-forward y = conv(x, w) + b
//      (x and w are shared operands: three products a stage of four
//      slices), y with its tile statistics exactly as fwd_conv_stats_kernel
//      takes them, so in f32 y, the statistics and the mask are the
//      forward's bit for bit;
//      dbl_stats_kernel      Chan's combine, as fwd_combine_kernel;
//   BN dbl_bn_sums_kernel    per tile the channel sums of v, v xhat, v gz,
//      gz and gz xhat;
//      dbl_bn_consts_kernel  per (task, channel) those sums in tile order ->
//      scale_bar, and seven constants that make y_bar and g_bar affine in
//      (gz, v, xhat) and (v, xhat);
//      dbl_bn_apply_kernel   y_bar (over v, in place) and g_bar =
//      mask (...), elementwise;
//   B  dbl_dgrad_kernel      x_bar = dgrad(dy, c_dw) + dgrad(y_bar, w): the
//      four parity-class GEMMs of bwd_input_kernel, each over both pairs;
//   C  dbl_wgrad_kernel      w_bar = wgrad(c_dx, dy) + wgrad(x, y_bar) and
//      b_bar = sum y_bar: bwd_dw_kernel's split reduction over both pairs'
//      positions; dbl_wgrad_reduce_kernel sums the chunks in order.
// bias_bar is zero (bias reaches the backward only through the mask) and is
// not computed. A missing cotangent launches none of its products, and pass
// B runs only where x takes a gradient (not at block 1, the images).
//
// What bounds it. Seven conv passes (three in A, two in B, two in C) of
// f32 FMAs on the CUDA cores, no TF32, as the first-order kernels: 25.3
// GFLOP over the four blocks of 32 tasks of 25 images, 0.38 ms at the 67
// TFLOP/s of an H100 SXM at 700 W; the BN passes and y and v (block 1:
// 40 MB each) are bytes, ~0.1 ms. bf16 takes the same templates: bf16
// operands converted to f32 as they are staged, f32 products and sums.
//
// What the design does about it: the tiles, rings and FMA loops of the
// first-order f32 kernels (conv_tile's, bwd_input_kernel's,
// bwd_dw_kernel's), each pass one launch over both pairs, so the doubled
// reduction costs no extra launch or pass over its output. Every sum has a
// fixed order and none uses atomics: replays repeat bit for bit.

namespace {

constexpr int kBSlice = kTileK * kTileN;                // a B slice [k][n]
constexpr int kDblStage = 2 * kSliceA + 2 * kBSlice;    // x, c_dx; w, c_dw
constexpr int kDblSums = 5;   // v, v xhat, v gz, gz, gz xhat
constexpr int kDblConsts = 8;  // A1 A2 A3 A0 B1 B2 B0, padded
static_assert(kTileM * kLdC + 5 * kTileN <= 2 * kDblStage,
              "the epilogue's tile and reductions fit the ring");

// dst[0..3] <- src[0..3] as f32, zeros where !valid (src then not read):
// f32 by one 16-byte cp.async, bf16 by one 8-byte load converted in
// registers.
template <typename T>
__device__ __forceinline__ void stage4t(float* dst, const T* src,
                                        bool valid) {
  if constexpr (std::is_same<T, float>::value) {
    __pipeline_memcpy_async(dst, src, 16, valid ? 0 : 16);
  } else {
    st4(dst, valid ? ld4(src) : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// Pass A. grid (tiles, ceil(Co/64), B). y = conv(x, w) + b of one tile ->
// yout[b][m][co] (f32) and its tile statistics (tile_y_stats); v =
// conv(u, w) + conv(x, uw) + ub -> vout[b][m][co] (f32). u = c_dx, uw =
// c_dw and ub = c_db may each be null. A stage is kTileK values of k of
// the four operands; y's FMAs run in conv_tile's order. kVec: Ci % 16 ==
// 0, Co % 4 == 0 and 16-byte aligned operands.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dbl_conv_kernel(const T* __restrict__ x, const T* __restrict__ u,
                const T* __restrict__ w, const T* __restrict__ uw,
                const T* __restrict__ b, const T* __restrict__ ub,
                float* __restrict__ yout, float* __restrict__ vout,
                float2* __restrict__ tstats, Shape s) {
  __shared__ __align__(16) float ring[2 * kDblStage];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tile = blockIdx.x, co0 = blockIdx.y * kTileN, t = blockIdx.z;
  const int m0 = tile * kTileM, rows = min(kTileM, s.M - m0);
  const bool hu = u != nullptr, huw = uw != nullptr;
  const size_t xo = (size_t)t * s.N * s.H * s.W * s.Ci;
  const size_t wo = (size_t)t * 9 * s.Ci * s.Co;
  x += xo;
  w += wo;
  if (hu) u += xo;
  if (huw) uw += wo;
  const int K = 9 * s.Ci;
  float ay[4][4], av[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) ay[r][c] = av[r][c] = 0.f;
  auto mma = [&](int, const float* buf) {
    const float* bw = buf + 2 * kSliceA;
    mma_nn(buf, bw, ay, tx, ty);
    if (hu) mma_nn(buf + kSliceA, bw, av, tx, ty);
    if (huw) mma_nn(buf, bw + kBSlice, av, tx, ty);
  };
  if constexpr (kVec) {
    const int row = tid >> 2, q = tid & 3;              // A piece
    const int bk = tid >> 4, bc = 4 * (tid & 15);       // B piece
    const int m = m0 + row;
    const bool in = m < s.M;
    const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
    const size_t xn = in ? (size_t)n * s.H * s.W * s.Ci : 0;
    const bool bin = co0 + bc < s.Co;
    ring_loop<2>(K / kTileK, ring, kDblStage, [&](int c, float* buf) {
      const int k0 = c * kTileK, tap = k0 / s.Ci, ci0 = k0 - tap * s.Ci;
      const int hi = 2 * i + tap / 3 - 1, wi = 2 * j + tap % 3 - 1;
      const bool ok = in && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
      const size_t xoff =
          ok ? xn + ((size_t)hi * s.W + wi) * s.Ci + ci0 + 4 * q : 0;
      const size_t woff = bin ? (size_t)(k0 + bk) * s.Co + co0 + bc : 0;
      stage4t(buf + row * kLdK + 4 * q, x + xoff, ok);
      if (hu) stage4t(buf + kSliceA + row * kLdK + 4 * q, u + xoff, ok);
      float* bs = buf + 2 * kSliceA + bk * kTileN + bc;
      stage4t(bs, w + woff, bin);
      if (huw) stage4t(bs + kBSlice, uw + woff, bin);
    }, mma);
  } else {
    ring_loop<2>(cdiv(K, kTileK), ring, kDblStage, [&](int c, float* buf) {
      const int k0 = c * kTileK;
      for (int e = tid; e < kTileM * kTileK; e += kThreads) {
        const int row = e / kTileK, k = k0 + e % kTileK, m = m0 + row;
        float vx = 0.f, vu = 0.f;
        if (k < K && m < s.M) {
          const int tap = k / s.Ci, ci = k - tap * s.Ci;
          const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
          const int hi = 2 * i + tap / 3 - 1, wi = 2 * j + tap % 3 - 1;
          if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W) {
            const size_t off = (((size_t)n * s.H + hi) * s.W + wi) * s.Ci + ci;
            vx = ld(x + off);
            if (hu) vu = ld(u + off);
          }
        }
        buf[row * kLdK + e % kTileK] = vx;
        if (hu) buf[kSliceA + row * kLdK + e % kTileK] = vu;
      }
      for (int e = tid; e < kBSlice; e += kThreads) {
        const int k = k0 + e / kTileN, co = co0 + e % kTileN;
        const bool ok = k < K && co < s.Co;
        const size_t off = ok ? (size_t)k * s.Co + co : 0;
        buf[2 * kSliceA + e] = ok ? ld(w + off) : 0.f;
        if (huw) buf[2 * kSliceA + kBSlice + e] = ok ? ld(uw + off) : 0.f;
      }
    }, mma);
  }

  // v from the registers: each thread holds 4 contiguous channels a row
  const int col = co0 + 4 * tx, limit = s.Co - col;
  float ubv[4], bias[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool in = c < limit;
    ubv[c] = (in && ub) ? ld(ub + (size_t)t * s.Co + col + c) : 0.f;
    bias[c] = in ? ld(b + (size_t)t * s.Co + col + c) : 0.f;
  }
  const bool vec = (s.Co & 3) == 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (4 * ty + r < rows && limit > 0)
      store_row4(vout + ((size_t)t * s.M + m0 + 4 * ty + r) * s.Co + col,
                 make_float4(av[r][0] + ubv[0], av[r][1] + ubv[1],
                             av[r][2] + ubv[2], av[r][3] + ubv[3]),
                 limit, vec);
  // y through the tile, as fwd_conv_stats_kernel
  float* C = ring;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    st4(C + (4 * ty + r) * kLdC + 4 * tx,
        make_float4(ay[r][0] + bias[0], ay[r][1] + bias[1],
                    ay[r][2] + bias[2], ay[r][3] + bias[3]));
  __syncthreads();
  tile_y_stats(C, yout, tstats, s, t, tile, co0, rows);
}

// grid (ceil(Co/64), B): y's statistics, fwd_combine_kernel's arithmetic.
__global__ void __launch_bounds__(kTileN)
dbl_stats_kernel(const float2* __restrict__ tstats,
                 float2* __restrict__ stats, int ntiles, Shape s) {
  const int co = blockIdx.x * kTileN + threadIdx.x, t = blockIdx.y;
  if (co >= s.Co) return;
  const float2* ts = tstats + (size_t)t * ntiles * s.Co + co;
  float sum = 0.f;
  for (int k = 0; k < ntiles; ++k)
    sum += (float)min(kTileM, s.M - k * kTileM) * ts[(size_t)k * s.Co].x;
  const float mu = sum / s.M;
  float m2 = 0.f;
  for (int k = 0; k < ntiles; ++k) {
    const float2 v = ts[(size_t)k * s.Co];
    const float d = v.x - mu;
    m2 += v.y + (float)min(kTileM, s.M - k * kTileM) * d * d;
  }
  stats[(size_t)t * s.Co + co] = make_float2(mu, rsqrtf(m2 / s.M + kEps));
}

// grid (tiles, ceil(Co/64), B). Per channel of one tile the kDblSums sums
// -> tsums[q][b][tile][co], rows and row groups in bwd_tile_sums_kernel's
// order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dbl_bn_sums_kernel(const T* __restrict__ sc, const T* __restrict__ be,
                   const T* __restrict__ g, const float* __restrict__ y,
                   const float* __restrict__ v,
                   const float2* __restrict__ stats, float* __restrict__ tsums,
                   bool vec, int B, Shape s) {
  constexpr int kGroups = kThreads / (kTileN / 4);
  __shared__ float par[4][kTileN];  // mean, inv_std, scale, bias
  __shared__ float red[kDblSums][kGroups][kTileN];
  const int tid = threadIdx.x, col = 4 * (tid & 15), rg = tid >> 4;
  const int tile = blockIdx.x, co0 = blockIdx.y * kTileN, t = blockIdx.z;
  const int m0 = tile * kTileM, rows = min(kTileM, s.M - m0);
  const int limit = s.Co - co0 - col;
  load_bn_par(par, stats, sc, be, t, co0, s);
  __syncthreads();
  float a[kDblSums][4] = {};
  for (int r = rg; r < rows && limit > 0; r += kGroups) {
    const size_t off = ((size_t)t * s.M + m0 + r) * s.Co + co0 + col;
    const float4 yv = load_row4(y + off, limit, vec);
    const float4 vv = load_row4(v + off, limit, vec);
    const float4 gv = load_row4(g + off, limit, vec);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float xh;
      const float dz = bn_dz(f4(yv, e), f4(gv, e), par[0][col + e],
                             par[1][col + e], par[2][col + e],
                             par[3][col + e], xh);
      const float ve = f4(vv, e);
      a[0][e] += ve;
      a[1][e] += ve * xh;
      a[2][e] += ve * dz;
      a[3][e] += dz;
      a[4][e] += dz * xh;
    }
  }
#pragma unroll
  for (int q = 0; q < kDblSums; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[q][rg][col + e] = a[q][e];
  __syncthreads();
  if (tid < kTileN && co0 + tid < s.Co) {
    for (int q = 0; q < kDblSums; ++q) {
      float acc = 0.f;
      for (int r = 0; r < kGroups; ++r) acc += red[q][r][tid];
      tsums[(((size_t)q * B + t) * gridDim.x + tile) * s.Co + co0 + tid] =
          acc;
    }
  }
}

// grid (ceil(Co/64), B), kDblSums x 64 threads: thread (q, c) adds sum q
// of channel c over the tiles in tile order (Sv, Svx, Svg, Sg, Sgx), then
// one thread per (task, channel): scale_bar = inv (Svg - Sv Sg / M -
// Svx Sgx / M); consts[b][co] = (A1, A2, A3, A0, B1, B2, B0) with y_bar =
// A1 gz + A2 v + A3 xhat + A0 and g_bar = mask (B1 v + B2 xhat + B0)
// (block_double_bwd_plain: h = alpha gz + gamma v, alpha = c_ds - inv s
// Svx / M, gamma = -inv s Sgx / M, q = s Svg - s Sg Sv / M - s Sgx Svx /
// M). cds = c_ds and cdbe = c_dbias may be null.
template <typename T>
__global__ void __launch_bounds__(kDblSums * kTileN)
dbl_bn_consts_kernel(const float* __restrict__ tsums,
                     const float2* __restrict__ stats, const T* __restrict__ sc,
                     const T* __restrict__ cds, const T* __restrict__ cdbe,
                     float* __restrict__ consts, T* __restrict__ sbar,
                     int ntiles, int B, Shape s) {
  __shared__ float sums[kDblSums][kTileN];
  const int c = threadIdx.x % kTileN, co = blockIdx.x * kTileN + c;
  const int t = blockIdx.y;
  if (co < s.Co) {
    const int q = threadIdx.x / kTileN;
    const float* ts = tsums + ((size_t)q * B + t) * ntiles * s.Co + co;
    float acc = 0.f;
    for (int k = 0; k < ntiles; ++k) acc += ts[(size_t)k * s.Co];
    sums[q][c] = acc;
  }
  __syncthreads();
  if (threadIdx.x >= kTileN || co >= s.Co) return;
  float S[kDblSums];
  for (int q = 0; q < kDblSums; ++q) S[q] = sums[q][c];
  const size_t pc = (size_t)t * s.Co + co;
  const float inv = stats[pc].y, scale = ld(sc + pc), m = (float)s.M;
  const float u_ds = cds ? ld(cds + pc) : 0.f;
  const float u_dbe = cdbe ? ld(cdbe + pc) : 0.f;
  const float v_mean = S[0] / m, vx_mean = S[1] / m;
  const float a_mean = scale * S[3] / m, ax_mean = scale * S[4] / m;
  st(sbar + pc, inv * (S[2] - v_mean * S[3] - vx_mean * S[4]));
  const float q = scale * S[2] - a_mean * S[0] - ax_mean * S[1];
  const float alpha = u_ds - inv * scale * vx_mean, gamma = -inv * ax_mean;
  const float h_mean = alpha * S[3] / m + gamma * v_mean;
  const float hx_mean = alpha * S[4] / m + gamma * vx_mean;
  float* out = consts + pc * kDblConsts;
  out[0] = inv * alpha;
  out[1] = inv * gamma;
  out[2] = -(inv * hx_mean + q * inv * inv / m);
  out[3] = -inv * h_mean;
  out[4] = scale * inv;
  out[5] = u_ds - scale * inv * vx_mean;
  out[6] = u_dbe - scale * inv * v_mean;
}

// grid (tiles, ceil(Co/64), B): y_bar over v (each element read, then
// written, by one thread) and g_bar (null: not asked for), one tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dbl_bn_apply_kernel(const T* __restrict__ sc, const T* __restrict__ be,
                    const T* __restrict__ g, const float* __restrict__ y,
                    float* v, const float2* __restrict__ stats,
                    const float* __restrict__ consts, T* __restrict__ gbar,
                    bool vec, Shape s) {
  __shared__ float par[4][kTileN];  // mean, inv_std, scale, bias
  __shared__ float cst[7][kTileN];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, co0 = blockIdx.y * kTileN, t = blockIdx.z;
  const int m0 = tile * kTileM, rows = min(kTileM, s.M - m0);
  load_bn_par(par, stats, sc, be, t, co0, s);
  if (tid < kTileN)
    for (int q = 0; q < 7; ++q)
      cst[q][tid] = co0 + tid < s.Co
                        ? consts[((size_t)t * s.Co + co0 + tid) * kDblConsts + q]
                        : 0.f;
  __syncthreads();
  const size_t base = (size_t)t * s.M * s.Co;
  for (int e = tid; e < kTileM * kTileN / 4; e += kThreads) {
    const int row = e >> 4, col = 4 * (e & 15);
    if (row >= rows || co0 + col >= s.Co) continue;
    const size_t off = base + (size_t)(m0 + row) * s.Co + co0 + col;
    const int limit = s.Co - co0 - col;
    const float4 yv = load_row4(y + off, limit, vec);
    const float4 vv = load_row4(v + off, limit, vec);
    const float4 gv = load_row4(g + off, limit, vec);
    float yb[4], gb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = col + u;
      const float xh = (f4(yv, u) - par[0][c]) * par[1][c];
      const bool on = fmaf(xh, par[2][c], par[3][c]) > 0.f;
      const float gz = on ? f4(gv, u) : 0.f, ve = f4(vv, u);
      yb[u] = cst[0][c] * gz + cst[1][c] * ve + cst[2][c] * xh + cst[3][c];
      gb[u] = on ? cst[4][c] * ve + cst[5][c] * xh + cst[6][c] : 0.f;
    }
    store_row4(v + off, make_float4(yb[0], yb[1], yb[2], yb[3]), limit, vec);
    if (gbar)
      store_row4(gbar + off, make_float4(gb[0], gb[1], gb[2], gb[3]), limit,
                 vec);
  }
}

// Pass B. grid (tiles of all four classes, ceil(Ci/64), B), as
// bwd_input_kernel: xbar = dgrad(dy, uw) + dgrad(yb, w), the stages of the
// pair (dy, uw) (where uw = c_dw is not null), then those of (yb, w).
// kVec: Co % 16 == 0 and 16-byte aligned operands.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dbl_dgrad_kernel(const float* __restrict__ dy, const T* __restrict__ uw,
                 const float* __restrict__ yb, const T* __restrict__ w,
                 T* __restrict__ xbar, Shape s) {
  __shared__ __align__(16) float ring[kRing];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ci0 = blockIdx.y * kTileN, t = blockIdx.z;
  const DxClass dc = dx_class(s);
  const int hc = dc.hc, wc = dc.wc, P = dc.P;
  const int ph = class_ph(dc.cls), pw = class_pw(dc.cls);
  const int p0 = dc.tile * kTileM;
  const int nco = cdiv(s.Co, kTileK);
  const int per = (1 + ph) * (1 + pw) * nco;  // stages of one pair
  const int first = uw ? 0 : 1;
  const size_t yo = (size_t)t * s.M * s.Co, wo = (size_t)t * 9 * s.Ci * s.Co;
  dy += yo;
  yb += yo;
  w += wo;
  if (uw) uw += wo;
  xbar += (size_t)t * s.N * s.H * s.W * s.Ci;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  auto mma = [&](int, const float* buf) {
    mma_nt(buf, buf + kSliceA, acc, tx, ty);
  };
  const int nst = (2 - first) * per;
  if constexpr (kVec) {
    const int row = tid >> 2, q = tid & 3;  // A piece; B piece: ci row `row`
    const int p = p0 + row;
    const bool in = p < P;
    const int bb = p % wc, a = (p / wc) % hc, n = p / (wc * hc);
    const size_t dyn = in ? (size_t)n * s.Ho * s.Wo * s.Co : 0;
    const bool bin = ci0 + row < s.Ci;
    ring_loop<2>(nst, ring, kStage, [&](int c, float* buf) {
      const bool second = first + c / per == 1;
      const DxTap tp = dx_tap(c % per, nco, ph, pw, kTileK);
      const int i = a + tp.di, j = bb + tp.dj;
      const bool ok = in && i < s.Ho && j < s.Wo;
      const float* A = second ? yb : dy;
      const T* Bm = second ? w : uw;
      stage4(buf + row * kLdK + 4 * q,
             A + (ok ? dyn + ((size_t)i * s.Wo + j) * s.Co + tp.co0 + 4 * q
                     : 0),
             ok);
      stage4t(buf + kSliceA + row * kLdK + 4 * q,
              Bm + (bin ? ((size_t)tp.wtap * s.Ci + ci0 + row) * s.Co +
                              tp.co0 + 4 * q
                        : 0),
              bin);
    }, mma);
  } else {
    ring_loop<2>(nst, ring, kStage, [&](int c, float* buf) {
      const bool second = first + c / per == 1;
      const DxTap tp = dx_tap(c % per, nco, ph, pw, kTileK);
      const float* A = second ? yb : dy;
      const T* Bm = second ? w : uw;
      for (int e = tid; e < kTileM * kTileK; e += kThreads) {
        const int row = e / kTileK, co = tp.co0 + e % kTileK, p = p0 + row;
        float v = 0.f;
        if (p < P && co < s.Co) {
          const int j = p % wc + tp.dj, i = (p / wc) % hc + tp.di;
          const int n = p / (wc * hc);
          if (i < s.Ho && j < s.Wo)
            v = A[(((size_t)n * s.Ho + i) * s.Wo + j) * s.Co + co];
        }
        buf[row * kLdK + e % kTileK] = v;
      }
      for (int e = tid; e < kTileN * kTileK; e += kThreads) {
        const int ci = ci0 + e / kTileK, co = tp.co0 + e % kTileK;
        buf[kSliceA + (e / kTileK) * kLdK + e % kTileK] =
            (ci < s.Ci && co < s.Co)
                ? ld(Bm + ((size_t)tp.wtap * s.Ci + ci) * s.Co + co)
                : 0.f;
      }
    }, mma);
  }

  float* C = ring;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      C[(4 * ty + r) * kLdC + tx + 16 * c] = acc[r][c];
  __syncthreads();
  const bool vec = (s.Ci & 3) == 0;
  for (int e = tid; e < kTileM * kTileN / 4; e += kThreads) {
    const int row = e >> 4, col = 4 * (e & 15), p = p0 + row;
    if (p >= P || ci0 + col >= s.Ci) continue;
    const int bb = p % wc, a = (p / wc) % hc, n = p / (wc * hc);
    const size_t pos = ((size_t)n * s.H + 2 * a + ph) * s.W + 2 * bb + pw;
    store_row4(xbar + pos * s.Ci + ci0 + col,
               *reinterpret_cast<const float4*>(C + row * kLdC + col),
               s.Ci - ci0 - col, vec);
  }
}

// Pass C. grid (chunks, dw row tiles x column tiles, B), as bwd_dw_kernel:
// wbar[k][co] = sum over the chunk's positions of u_tap(m, ci) dy(m, co) +
// x_tap(m, ci) yb(m, co), the stages of the pair (u, dy) (where u = c_dx
// is not null), then those of (x, yb). The CTAs of row tile 0 also sum b_bar
// = sum yb over the chunk. kVec: Ci % 4 == 0 and 16-byte aligned A
// operands; `vec`: Co % 4 == 0 and 16-byte aligned dy and yb.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dbl_wgrad_kernel(const T* __restrict__ u, const float* __restrict__ dy,
                 const T* __restrict__ x, const float* __restrict__ yb,
                 T* __restrict__ wbar, T* __restrict__ bbar,
                 float* __restrict__ part, int chunk, bool vec, Shape s) {
  __shared__ __align__(16) float ring[kRing];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, col = 4 * tx;
  const int K = 9 * s.Ci, nct = cdiv(s.Co, kTileN), nchunks = gridDim.x;
  const int ch = blockIdx.x, t = blockIdx.z;
  const int k0 = blockIdx.y / nct * kTileM, co0 = blockIdx.y % nct * kTileN;
  const bool first_row = k0 == 0;
  const int mb = ch * chunk, me = min(mb + chunk, s.M);
  const int limit = s.Co - co0 - col;
  const size_t xo = (size_t)t * s.N * s.H * s.W * s.Ci, yo = (size_t)t * s.M;
  const int pfirst = u ? 0 : 1;
  x += xo;
  if (u) u += xo;
  const int ka = k0 + col, tap = ka / s.Ci, ci = ka - tap * s.Ci;
  const int dty = tap / 3 - 1, dtx = tap % 3 - 1;
  const bool kin = ka < K;
  const int kw = min(kTileM, K - k0);  // rows of wbar in this tile
  const int nk = cdiv(me - mb, kTileK);
  float acc[4][4], dbacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  if (!kVec && kw < kTileM) {  // A rows past K: zero in both stages, once
    for (int e = tid; e < kTileK * kTileM; e += kThreads)
      ring[e] = ring[kStage + e] = 0.f;
    __syncthreads();
  }
  ring_loop<2>((2 - pfirst) * nk, ring, kStage, [&](int c, float* buf) {
    const bool second = pfirst + c / nk == 1;
    const int m0 = mb + (c % nk) * kTileK;
    const T* A = second ? x : u;
    const float* Bd = second ? yb : dy;
    if constexpr (kVec) {
      const int m = m0 + ty;
      const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
      const int hi = 2 * i + dty, wi = 2 * j + dtx;
      const bool ok =
          kin && m < me && hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
      stage4t(buf + ty * kTileM + col,
              A + (ok ? (((size_t)n * s.H + hi) * s.W + wi) * s.Ci + ci : 0),
              ok);
    } else {  // the rows k < K only: the others stay zero
      for (int e = tid; e < kTileK * kw; e += kThreads) {
        const int row = e / kw, kk = e - row * kw;
        const int m = m0 + row, k = k0 + kk;
        float v = 0.f;
        if (m < me) {
          const int tp = k / s.Ci, cc = k - tp * s.Ci;
          const int j = m % s.Wo, i = (m / s.Wo) % s.Ho, n = m / (s.Wo * s.Ho);
          const int hi = 2 * i + tp / 3 - 1, wi = 2 * j + tp % 3 - 1;
          if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W)
            v = ld(A + (((size_t)n * s.H + hi) * s.W + wi) * s.Ci + cc);
        }
        buf[row * kTileM + kk] = v;
      }
    }
    const int m = m0 + ty;
    const bool ok = m < me && limit > 0;
    const size_t off = ok ? (yo + m) * s.Co + co0 + col : 0;
    if (vec)
      stage4(buf + kSliceA + ty * kTileN + col, Bd + off, ok);
    else
      st4(buf + kSliceA + ty * kTileN + col,
          ok ? load_row4(Bd + off, limit, false)
             : make_float4(0.f, 0.f, 0.f, 0.f));
  }, [&](int c, const float* buf) {
    if (4 * ty < kw) mma_tn(buf, buf + kSliceA, acc, tx, ty);
    if (first_row && pfirst + c / nk == 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dbacc[e] += buf[kSliceA + ty * kTileN + col + e];
    }
  });

  const bool vw = (s.Co & 3) == 0;
  T* wt = wbar + (size_t)t * K * s.Co;
  float* pt = part + ((size_t)t * nchunks + ch) * ((size_t)K * s.Co + s.Co);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + 4 * ty + r;
    if (k >= K || limit <= 0) continue;
    const float4 v = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    const size_t off = (size_t)k * s.Co + co0 + col;
    if (nchunks == 1)
      store_row4(wt + off, v, limit, vw);
    else
      store_row4(pt + off, v, limit, vw);
  }
  if (!first_row) return;
  // b_bar over the chunk: the 16 row groups of each channel, in order
  float* red = ring;  // [kTileK][kTileN]; ring_loop ended on a barrier
#pragma unroll
  for (int e = 0; e < 4; ++e) red[ty * kTileN + col + e] = dbacc[e];
  __syncthreads();
  if (tid < kTileN && co0 + tid < s.Co) {
    float a = 0.f;
    for (int r = 0; r < kTileK; ++r) a += red[r * kTileN + tid];
    if (nchunks == 1)
      st(bbar + (size_t)t * s.Co + co0 + tid, a);
    else
      pt[(size_t)K * s.Co + co0 + tid] = a;
  }
}

// Where the positions were split: wbar and bbar are the chunk partials
// summed in chunk order, one thread per output (bwd_dw_reduce_kernel's).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dbl_wgrad_reduce_kernel(const float* __restrict__ part, T* __restrict__ wbar,
                        T* __restrict__ bbar, int nchunks, int B, Shape s) {
  const size_t kco = (size_t)9 * s.Ci * s.Co, len = kco + s.Co;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)B * len) return;
  const size_t t = e / len, i = e - t * len;
  const float* p = part + t * nchunks * len + i;
  float a = 0.f;
  for (int c = 0; c < nchunks; ++c) a += p[(size_t)c * len];
  if (i < kco)
    st(wbar + t * kco + i, a);
  else
    st(bbar + t * s.Co + (i - kco), a);
}

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

bool aligned16_or_null(const void* p) { return p == nullptr || aligned16(p); }

// ws: f32 scratch of cuda/cnn4_cuda.py:double_bwd_workspace_floats, each
// part rounded up to 16 bytes, in order: y and v (then y_bar) [B][M][Co];
// tile statistics [B][tiles][Co] and statistics [B][Co] (float2); the tile
// sums [kDblSums][B][tiles][Co]; the constants [B][Co][kDblConsts]; the
// wgrad partials [B][chunks][9 Ci Co + Co] where there is more than one
// chunk. A null cotangent (cdx .. cdbe) has no terms; a null xbar or gbar
// is not computed.
template <typename T>
int launch_double_bwd(const T* x, const T* w, const T* b, const T* sc,
                      const T* be, const T* g, const float* dy, const T* cdx,
                      const T* cdw, const T* cdb, const T* cds, const T* cdbe,
                      T* xbar, T* wbar, T* bbar, T* sbar, T* gbar, float* ws,
                      int B, const Shape& s, cudaStream_t st) {
  if (B == 0) return 0;
  const int K = 9 * s.Ci;
  if (s.M == 0) {  // no positions: every sum is empty
    const size_t per = (size_t)B * s.Co * sizeof(T);
    cudaMemsetAsync(wbar, 0, K * per, st);
    cudaMemsetAsync(bbar, 0, per, st);
    cudaMemsetAsync(sbar, 0, per, st);
    return (int)cudaGetLastError();
  }
  const int ntiles = cdiv(s.M, kTileM), nct = cdiv(s.Co, kTileN);
  const size_t ym = (size_t)B * s.M * s.Co;
  float* y = ws;
  float* v = y + round4(ym);
  float2* tstats = reinterpret_cast<float2*>(v + round4(ym));
  float2* stats = tstats + round4(2 * (size_t)B * ntiles * s.Co) / 2;
  float* tsums = reinterpret_cast<float*>(stats) + round4(2 * (size_t)B * s.Co);
  float* consts = tsums + round4((size_t)kDblSums * B * ntiles * s.Co);
  float* part = consts + round4((size_t)kDblConsts * B * s.Co);
  const dim3 tiles(ntiles, nct, B), chans(nct, B);
  int err;
  if (s.Ci % kTileK == 0 && s.Co % 4 == 0 && aligned16(x) && aligned16(w) &&
      aligned16_or_null(cdx) && aligned16_or_null(cdw))
    dbl_conv_kernel<T, true><<<tiles, kThreads, 0, st>>>(
        x, cdx, w, cdw, b, cdb, y, v, tstats, s);
  else
    dbl_conv_kernel<T, false><<<tiles, kThreads, 0, st>>>(
        x, cdx, w, cdw, b, cdb, y, v, tstats, s);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  dbl_stats_kernel<<<chans, kTileN, 0, st>>>(tstats, stats, ntiles, s);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const bool vec = s.Co % 4 == 0 && aligned16(g) && aligned16_or_null(gbar);
  dbl_bn_sums_kernel<T><<<tiles, kThreads, 0, st>>>(sc, be, g, y, v, stats,
                                                    tsums, vec, B, s);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  dbl_bn_consts_kernel<T><<<chans, kDblSums * kTileN, 0, st>>>(
      tsums, stats, sc, cds, cdbe, consts, sbar, ntiles, B, s);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  dbl_bn_apply_kernel<T><<<tiles, kThreads, 0, st>>>(sc, be, g, y, v, stats,
                                                     consts, gbar, vec, s);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (xbar) {
    int ctiles = 0;
    for (int cls = 0; cls < 4; ++cls)
      ctiles += cdiv(s.N * class_extent(s.H, class_ph(cls)) *
                         class_extent(s.W, class_pw(cls)),
                     kTileM);
    const dim3 grid(ctiles, cdiv(s.Ci, kTileN), B);
    if (s.Co % kTileK == 0 && aligned16(dy) && aligned16(w) &&
        aligned16_or_null(cdw))
      dbl_dgrad_kernel<T, true><<<grid, kThreads, 0, st>>>(dy, cdw, v, w,
                                                           xbar, s);
    else
      dbl_dgrad_kernel<T, false><<<grid, kThreads, 0, st>>>(dy, cdw, v, w,
                                                            xbar, s);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  const int chunk = dw_chunk(s, B), nchunks = cdiv(s.M, chunk);
  const dim3 grid(nchunks, cdiv(K, kTileM) * nct, B);
  const bool bvec = s.Co % 4 == 0 && aligned16(dy);
  if (s.Ci % 4 == 0 && aligned16(x) && aligned16_or_null(cdx))
    dbl_wgrad_kernel<T, true><<<grid, kThreads, 0, st>>>(
        cdx, dy, x, v, wbar, bbar, part, chunk, bvec, s);
  else
    dbl_wgrad_kernel<T, false><<<grid, kThreads, 0, st>>>(
        cdx, dy, x, v, wbar, bbar, part, chunk, bvec, s);
  if ((err = (int)cudaGetLastError()) != 0 || nchunks == 1) return err;
  const size_t outs = (size_t)B * ((size_t)K * s.Co + s.Co);
  dbl_wgrad_reduce_kernel<T><<<(unsigned)((outs + kThreads - 1) / kThreads),
                               kThreads, 0, st>>>(part, wbar, bbar, nchunks,
                                                  B, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The VJP of the block's backward at its cotangents (second-order MAML).
// dy: the backward's f32 dy (cnn4_block_bwd_params). cdx .. cdbe: the
// cotangents of dx, dw, db, dscale and dbias, any of them null (no terms);
// xbar, wbar, bbar, sbar, gbar: the cotangents of x, w, b, scale and g,
// xbar and gbar null where not wanted (bias's is zero). ws: f32 scratch of
// cuda/cnn4_cuda.py:double_bwd_workspace_floats(...) floats. Returns a
// cudaError_t code; 0 means launched.
int cnn4_block_double_bwd(int dtype, const void* x, const void* w,
                          const void* b, const void* sc, const void* be,
                          const void* g, const void* dy, const void* cdx,
                          const void* cdw, const void* cdb, const void* cds,
                          const void* cdbe, void* xbar, void* wbar, void* bbar,
                          void* sbar, void* gbar, void* ws, int B, int N,
                          int H, int W, int Ci, int Co, void* stream) {
  const Shape s = make_shape(N, H, W, Ci, Co);
  cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch_double_bwd<T>(
        (const T*)x, (const T*)w, (const T*)b, (const T*)sc, (const T*)be,
        (const T*)g, (const float*)dy, (const T*)cdx, (const T*)cdw,
        (const T*)cdb, (const T*)cds, (const T*)cdbe, (T*)xbar, (T*)wbar,
        (T*)bbar, (T*)sbar, (T*)gbar, (float*)ws, B, s, st);
  };
  if (dtype == 0) return run((float*)nullptr);
  if (dtype == 1) return run((bf16*)nullptr);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
