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
// The single-task TPU forms are the B = 1 case here.
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
// - bf16 loads are converted to f32 in registers on their way to shared
//   memory (cp.async cannot convert); the math is the same f32 FMAs.
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
// Every sum has a fixed order (k ascending within a thread, the tile
// statistics in tile order), so results are deterministic.
//
// cnn4_block_bwd_params keeps its first design: what bounds it on an H100,
// and what the design does about it: the work is small. A served batch of
// 64 requests does ~40 GFLOP of f32 conv in 15 launches, and each launch
// moves at most a few MB, so the kernels sit far below both the bytes and
// the FLOP roofline and are bound by latency: launch overhead, the serial
// BN reductions and the uncoalesced channel-strided stores. The design
// keeps every intermediate of a (task, channel) pair in one CTA's shared
// memory: the conv output y of one channel over all N*Ho*Wo positions
// (19.6 KB at block 1 with N = 25), so the BN statistics need no second
// kernel and no atomics, and no conv output or normalised value ever goes
// to device memory. Means and variances are taken in two passes (mean,
// then the sum of squared deviations), never as E[y^2] - E[y]^2, which
// drifts in f32. Every reduction has a fixed order, so results are
// deterministic. Tensor cores, TMA and tiling are left for a later change.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Sum of v over the block; every thread gets the result. red holds
// kThreads / 32 floats.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (kThreads >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

struct Shape {
  int N, H, W, Ci, Co, Ho, Wo, M;  // M = N * Ho * Wo
};

// ---------------------------------------------------------------------------
// cnn4_block_bwd_params: one CTA per (task, channel)
// ---------------------------------------------------------------------------

// Shared memory of the per-(task, channel) kernel, in floats:
//   wcol [9*Ci]   this channel's weight column, tap-major
//   red  [kThreads]
//   y    [M]      conv output, then dy, of this channel
// (cuda/cnn4_cuda.py:smem_bytes mirrors this to refuse oversized calls.)
inline size_t smem_floats(const Shape& s) {
  return (size_t)9 * s.Ci + kThreads + (size_t)s.M;
}

// y[m] = b + sum_{dy,dx,ci} x[n, 2i+dy-1, 2j+dx-1, ci] * w[dy,dx,ci,co]
// for every position m = (n, i, j) of this task, into shared memory.
// Out-of-range taps (the zero padding) are skipped.
template <typename T>
__device__ void conv_channel(const T* x, const float* wcol, float bias,
                             const Shape& s, float* y) {
  for (int m = threadIdx.x; m < s.M; m += blockDim.x) {
    const int j = m % s.Wo;
    const int i = (m / s.Wo) % s.Ho;
    const int n = m / (s.Wo * s.Ho);
    float acc = bias;
    for (int dy = 0; dy < 3; ++dy) {
      const int hi = 2 * i + dy - 1;
      if (hi < 0 || hi >= s.H) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int wi = 2 * j + dx - 1;
        if (wi < 0 || wi >= s.W) continue;
        const T* xp = x + (((size_t)n * s.H + hi) * s.W + wi) * s.Ci;
        const float* wp = wcol + (dy * 3 + dx) * s.Ci;
        for (int ci = 0; ci < s.Ci; ++ci) acc += ld(xp + ci) * wp[ci];
      }
    }
    y[m] = acc;
  }
}

// Loads this (task, channel)'s weight column into shared memory, then
// computes y over all positions and its BN statistics (two passes).
template <typename T>
__device__ void conv_bn_stats(const T* x, const T* w, const T* b,
                              const Shape& s, int co, float* wcol, float* red,
                              float* y, float* mean, float* inv_std) {
  for (int k = threadIdx.x; k < 9 * s.Ci; k += blockDim.x)
    wcol[k] = ld(w + (size_t)k * s.Co + co);
  __syncthreads();
  conv_channel(x, wcol, ld(b + co), s, y);
  __syncthreads();
  float acc = 0.f;
  for (int m = threadIdx.x; m < s.M; m += blockDim.x) acc += y[m];
  const float mu = block_sum(acc, red) / s.M;
  acc = 0.f;
  for (int m = threadIdx.x; m < s.M; m += blockDim.x) {
    const float d = y[m] - mu;
    acc += d * d;
  }
  const float var = block_sum(acc, red) / s.M;
  *mean = mu;
  *inv_std = rsqrtf(var + kEps);
}

// grid (Co, B). Recomputes y, xhat and inv_std, then the BN+ReLU
// backward of _block_bwd:
//   dz = g * [xhat*scale + bias > 0]
//   dscale = sum dz*xhat, dbias = sum dz
//   dy = inv_std * (dxh - mean(dxh) - xhat * mean(dxh*xhat)), dxh = dz*scale
// and the conv parameter grads dw[:, :, :, co] = sum_m tap(m) * dy(m),
// db = sum dy. dy goes to dy_out (f32) for the input-gradient kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cnn4_block_bwd_params_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const T* __restrict__ b, const T* __restrict__ sc,
                             const T* __restrict__ be,
                             const T* __restrict__ gout,
                             float* __restrict__ dy_out, T* __restrict__ dw,
                             T* __restrict__ db, T* __restrict__ dsc,
                             T* __restrict__ dbe, Shape s) {
  extern __shared__ float smem[];
  float* wcol = smem;
  float* red = wcol + 9 * s.Ci;
  float* y = red + kThreads;
  const int co = blockIdx.x, t = blockIdx.y;
  x += (size_t)t * s.N * s.H * s.W * s.Ci;
  w += (size_t)t * 9 * s.Ci * s.Co;
  b += (size_t)t * s.Co;
  sc += (size_t)t * s.Co;
  be += (size_t)t * s.Co;
  gout += (size_t)t * s.M * s.Co;
  dy_out += (size_t)t * s.M * s.Co;
  dw += (size_t)t * 9 * s.Ci * s.Co;
  db += (size_t)t * s.Co;
  dsc += (size_t)t * s.Co;
  dbe += (size_t)t * s.Co;

  float mu, inv;
  conv_bn_stats(x, w, b, s, co, wcol, red, y, &mu, &inv);
  const float g = ld(sc + co), h = ld(be + co);

  // pass 1: y[m] <- xhat; dscale and dbias
  float a_ds = 0.f, a_db = 0.f;
  for (int m = threadIdx.x; m < s.M; m += blockDim.x) {
    const float xh = (y[m] - mu) * inv;
    y[m] = xh;
    const float dz = (xh * g + h > 0.f) ? ld(gout + (size_t)m * s.Co + co) : 0.f;
    a_ds += dz * xh;
    a_db += dz;
  }
  const float dscale = block_sum(a_ds, red);
  const float dbias = block_sum(a_db, red);
  // mean(dxh) = scale * dbias / M, mean(dxh * xhat) = scale * dscale / M
  const float m1 = g * dbias / s.M, m2 = g * dscale / s.M;

  // pass 2: y[m] <- dy; db
  float a_b = 0.f;
  for (int m = threadIdx.x; m < s.M; m += blockDim.x) {
    const float xh = y[m];
    const float dz = (xh * g + h > 0.f) ? ld(gout + (size_t)m * s.Co + co) : 0.f;
    const float d = inv * (dz * g - m1 - xh * m2);
    y[m] = d;
    dy_out[(size_t)m * s.Co + co] = d;
    a_b += d;
  }
  const float dbv = block_sum(a_b, red);  // its barriers publish y = dy
  if (threadIdx.x == 0) {
    st(db + co, dbv);
    st(dsc + co, dscale);
    st(dbe + co, dbias);
  }

  // dw[k, co], k = (dy*3+dx)*Ci + ci: K = 9*Ci sums over the M positions.
  // With K >= kThreads each thread owns whole sums; otherwise (block 1,
  // Ci = 1) G groups of K threads split the positions and red combines.
  const int K = 9 * s.Ci;
  const int G = K >= kThreads ? 1 : kThreads / K;
  const int kk = threadIdx.x % K, grp = threadIdx.x / K;
  for (int k0 = 0; k0 < K; k0 += kThreads) {
    const int k = G == 1 ? k0 + threadIdx.x : kk;
    float acc = 0.f;
    if (k < K && grp < G) {
      const int ci = k % s.Ci, tap = k / s.Ci;
      const int ty = tap / 3, tx = tap % 3;
      for (int m = (G == 1 ? 0 : grp); m < s.M; m += G) {
        const int j = m % s.Wo;
        const int i = (m / s.Wo) % s.Ho;
        const int n = m / (s.Wo * s.Ho);
        const int hi = 2 * i + ty - 1, wi = 2 * j + tx - 1;
        if (hi < 0 || hi >= s.H || wi < 0 || wi >= s.W) continue;
        acc += ld(x + (((size_t)n * s.H + hi) * s.W + wi) * s.Ci + ci) * y[m];
      }
    }
    if (G == 1) {
      if (k < K) st(dw + (size_t)k * s.Co + co, acc);
    } else {
      __syncthreads();
      red[threadIdx.x] = acc;
      __syncthreads();
      if (threadIdx.x < K) {
        float tot = 0.f;
        for (int q = 0; q < G; ++q) tot += red[q * K + threadIdx.x];
        st(dw + (size_t)threadIdx.x * s.Co + co, tot);
      }
      break;  // G > 1 means K < kThreads: one round covers every k
    }
  }
}

// ---------------------------------------------------------------------------
// Tiled implicit GEMMs: cnn4_block_fwd and cnn4_block_bwd_input
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
static_assert(kTileM * kLdC + 5 * kTileN <= kRing,
              "the epilogue's tile and reductions fit the ring");
static_assert(kThreads == 4 * kTileM && kThreads == 16 * kTileK,
              "one 16-byte piece of each slice per thread");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// dst[0..3] <- src[0..3] as f32, or zeros where !valid (src is then not
// read). f32 goes as one 16-byte cp.async; bf16 through registers.
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool valid) {
  __pipeline_memcpy_async(dst, src, 16, valid ? 0 : 16);
}
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src,
                                       bool valid) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
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
template <typename T, bool kVec>
__device__ __forceinline__ void conv_tile(const T* __restrict__ x,
                                          const T* __restrict__ w,
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
    const T* xn = x + (in ? (size_t)n * s.H * s.W * s.Ci : 0);
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

// Kernel A of the forward. grid (tiles, ceil(Co/64), B). The conv plus
// bias of one tile -> yout[b][m][co] (f32); per channel its mean and
// centred sum of squares over the tile's rows -> tstats[b][tile][co] =
// (mean_t, M2_t).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
fwd_conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ b, float* __restrict__ yout,
                      float2* __restrict__ tstats, Shape s) {
  __shared__ __align__(16) float ring[kRing];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tile = blockIdx.x, co0 = blockIdx.y * kTileN, t = blockIdx.z;
  const int m0 = tile * kTileM, rows = min(kTileM, s.M - m0);
  x += (size_t)t * s.N * s.H * s.W * s.Ci;
  w += (size_t)t * 9 * s.Ci * s.Co;
  b += (size_t)t * s.Co;
  float acc[4][4];
  conv_tile<T, kVec>(x, w, s, m0, co0, ring, acc);

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
  yout += (size_t)t * s.M * s.Co;
  const bool vec = (s.Co & 3) == 0;
  for (int e = tid; e < kTileM * kTileN / 4; e += kThreads) {
    const int row = e >> 4, col = 4 * (e & 15);
    if (row < rows && co0 + col < s.Co)
      store_row4(yout + (size_t)(m0 + row) * s.Co + co0 + col,
                 *reinterpret_cast<const float4*>(C + row * kLdC + col),
                 s.Co - co0 - col, vec);
  }

  // The tile's statistics per channel: 4 groups of 16 rows each, then the
  // groups in order; the mean first, then the centred squares.
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
  if (tid < kTileN) {
    const int co = co0 + tid;
    const bool in = co < s.Co;
    const size_t pc = (size_t)t * s.Co + co;
    const float2 st2 = in ? stats[pc] : make_float2(0.f, 0.f);
    par[0][tid] = st2.x;
    par[1][tid] = st2.y;
    par[2][tid] = in ? ld(sc + pc) : 0.f;
    par[3][tid] = in ? ld(be + pc) : 0.f;
  }
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
    float4 y;
    if (vec) {
      y = *reinterpret_cast<const float4*>(yin + off);
    } else {
      y.x = yin[off];
      y.y = limit > 1 ? yin[off + 1] : 0.f;
      y.z = limit > 2 ? yin[off + 2] : 0.f;
      y.w = limit > 3 ? yin[off + 3] : 0.f;
    }
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

// cnn4_block_bwd_input. grid (tiles of all four classes, ceil(Ci/64), B).
// dx[n, hi, wi, ci] = sum over the class's taps (ty, tx) and co of
// dy[n, i, j, co] * w[ty, tx, ci, co]. kVec (Co % 16 == 0): a stage is 16
// channels co of one tap, copied 16 bytes at a time.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
bwd_input_kernel(const float* __restrict__ dy, const T* __restrict__ w,
                 T* __restrict__ dx, Shape s) {
  __shared__ __align__(16) float ring[kRing];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ci0 = blockIdx.y * kTileN, t = blockIdx.z;
  int cls = 0, tile = blockIdx.x, hc = 0, wc = 0, P = 0;
  for (; cls < 4; ++cls) {
    hc = class_extent(s.H, class_ph(cls));
    wc = class_extent(s.W, class_pw(cls));
    P = s.N * hc * wc;
    if (tile < cdiv(P, kTileM)) break;
    tile -= cdiv(P, kTileM);
  }
  const int ph = class_ph(cls), pw = class_pw(cls);
  const int ntx = 1 + pw, ntaps = (1 + ph) * ntx;
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
  // stage c: tap u = c / nco of the class, channels co0 .. co0 + 15; tap
  // (ky, kx) of the class is w[ty_w, tx_w] read from dy[n, a + di, b + dj]
  struct Tap {
    int wtap, di, dj, co0;
  };
  auto tap_of = [&](int c) {
    const int u = c / nco, ky = u / ntx, kx = u - ky * ntx;
    Tap tp;
    tp.wtap = (ph ? 2 * ky : 1) * 3 + (pw ? 2 * kx : 1);
    tp.di = ph ? 1 - ky : 0;
    tp.dj = pw ? 1 - kx : 0;
    tp.co0 = (c - u * nco) * kTileK;
    return tp;
  };
  if constexpr (kVec) {
    const int row = tid >> 2, q = tid & 3;  // A piece; B piece: ci row `row`
    const int p = p0 + row;
    const bool in = p < P;
    const int bb = p % wc, a = (p / wc) % hc, n = p / (wc * hc);
    const float* dyn = dy + (in ? (size_t)n * s.Ho * s.Wo * s.Co : 0);
    const bool bin = ci0 + row < s.Ci;
    k_loop(ntaps * nco, ring, [&](int c, float* buf) {
      const Tap tp = tap_of(c);
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
      const Tap tp = tap_of(c);
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

Shape make_shape(int N, int H, int W, int Ci, int Co) {
  Shape s;
  s.N = N; s.H = H; s.W = W; s.Ci = Ci; s.Co = Co;
  s.Ho = (H - 1) / 2 + 1;
  s.Wo = (W - 1) / 2 + 1;
  s.M = N * s.Ho * s.Wo;
  return s;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, bool kVec>
int launch_fwd_t(const T* x, const T* w, const T* b, const T* sc,
                 const T* be, T* out, float* ws, int B, const Shape& s,
                 cudaStream_t st) {
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
  fwd_conv_stats_kernel<T, kVec><<<grid, kThreads, 0, st>>>(x, w, b, y,
                                                             tstats, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_combine_kernel<<<dim3(cdiv(s.Co, kTileN), B), kTileN, 0, st>>>(
      tstats, stats, ntiles, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fwd_norm_kernel<T><<<grid, kThreads, 0, st>>>(sc, be, y, stats, out, s);
  return (int)cudaGetLastError();
}

// ws: f32 scratch of cuda/cnn4_cuda.py:fwd_workspace_floats.
template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, const void* sc,
               const void* be, void* out, void* ws, int B, const Shape& s,
               cudaStream_t st) {
  if (B == 0 || s.M == 0) return 0;
  const bool vec = s.Ci % kTileK == 0 && s.Co % 4 == 0 && aligned16(x) &&
                   aligned16(w);
  if (vec)
    return launch_fwd_t<T, true>((const T*)x, (const T*)w, (const T*)b,
                                 (const T*)sc, (const T*)be, (T*)out,
                                 (float*)ws, B, s, st);
  return launch_fwd_t<T, false>((const T*)x, (const T*)w, (const T*)b,
                                (const T*)sc, (const T*)be, (T*)out,
                                (float*)ws, B, s, st);
}

template <typename T>
int launch_bwd_params(const void* x, const void* w, const void* b,
                      const void* sc, const void* be, const void* g, void* dy,
                      void* dw, void* db, void* dsc, void* dbe, int B,
                      const Shape& s, cudaStream_t st) {
  const size_t smem = smem_floats(s) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cnn4_block_bwd_params_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cnn4_block_bwd_params_kernel<T><<<dim3(s.Co, B), kThreads, smem, st>>>(
      (const T*)x, (const T*)w, (const T*)b, (const T*)sc, (const T*)be,
      (const T*)g, (float*)dy, (T*)dw, (T*)db, (T*)dsc, (T*)dbe, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_input(const void* dy, const void* w, void* dx, int B,
                     const Shape& s, cudaStream_t st) {
  int tiles = 0;
  for (int cls = 0; cls < 4; ++cls)
    tiles += cdiv(s.N * class_extent(s.H, class_ph(cls)) *
                      class_extent(s.W, class_pw(cls)),
                  kTileM);
  if (B == 0 || tiles == 0) return 0;
  const dim3 grid(tiles, cdiv(s.Ci, kTileN), B);
  if (s.Co % kTileK == 0 && aligned16(dy) && aligned16(w))
    bwd_input_kernel<T, true><<<grid, kThreads, 0, st>>>(
        (const float*)dy, (const T*)w, (T*)dx, s);
  else
    bwd_input_kernel<T, false><<<grid, kThreads, 0, st>>>(
        (const float*)dy, (const T*)w, (T*)dx, s);
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
  if (dtype == 0)
    return launch_fwd<float>(x, w, b, sc, be, out, ws, B, s, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, b, sc, be, out, ws, B, s, st);
  return (int)cudaErrorInvalidValue;
}

int cnn4_block_bwd_params(int dtype, const void* x, const void* w,
                          const void* b, const void* sc, const void* be,
                          const void* g, void* dy, void* dw, void* db,
                          void* dsc, void* dbe, int B, int N, int H, int W,
                          int Ci, int Co, void* stream) {
  const Shape s = make_shape(N, H, W, Ci, Co);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd_params<float>(x, w, b, sc, be, g, dy, dw, db, dsc, dbe,
                                    B, s, st);
  if (dtype == 1)
    return launch_bwd_params<__nv_bfloat16>(x, w, b, sc, be, g, dy, dw, db,
                                            dsc, dbe, B, s, st);
  return (int)cudaErrorInvalidValue;
}

int cnn4_block_bwd_input(int dtype, const void* dy, const void* w, void* dx,
                         int B, int N, int H, int W, int Ci, int Co,
                         void* stream) {
  const Shape s = make_shape(N, H, W, Ci, Co);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_bwd_input<float>(dy, w, dx, B, s, st);
  if (dtype == 1) return launch_bwd_input<__nv_bfloat16>(dy, w, dx, B, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
