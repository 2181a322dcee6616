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
//                             _blk_fwd_pallas_batched :346)
//   cnn4_block_bwd_params <- the dy/dw/db/dscale/dbias half of
//                            _blk_bwd_kernel / _blk_bwd_kernel_batched
//                            (_blk_bwd_call_single :310,
//                             _blk_bwd_pallas_batched :364)
//   cnn4_block_bwd_input  <- the dx half of the same two kernels
//                            (_conv_s2_bwd's transposed-tap scatter)
// The single-task TPU forms are the B = 1 case here.
//
// What bounds them on an H100, and what the design does about it: the
// work is small. A served batch of 64 requests does ~40 GFLOP of f32
// conv in 15 launches, and each launch moves at most a few MB, so the
// kernels sit far below both the bytes and the FLOP roofline and are
// bound by latency: launch overhead, the serial BN reductions and the
// uncoalesced channel-strided stores. The design keeps every
// intermediate of a (task, channel) pair in one CTA's shared memory: the
// conv output y of one channel over all N*Ho*Wo positions (19.6 KB at
// block 1 with N = 25), so the BN statistics need no second kernel and no
// atomics, and no conv output or normalised value ever goes to device
// memory. Means and variances are taken in two passes (mean, then the
// sum of squared deviations), never as E[y^2] - E[y]^2, which drifts in
// f32. Every reduction has a fixed order, so results are deterministic.
// The transposed conv of the backward is a gather (one thread per input
// element), not a scatter, so it needs no atomics either. Tensor cores,
// TMA and tiling are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// Shared memory of the per-(task, channel) kernels, in floats:
//   wcol [9*Ci]   this channel's weight column, tap-major
//   red  [kThreads]
//   y    [M]      conv output (forward) or dy (backward) of this channel
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

// grid (Co, B): out[b, n, i, j, co] = relu(xhat * scale + bias).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cnn4_block_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ b, const T* __restrict__ sc,
                      const T* __restrict__ be, T* __restrict__ out, Shape s) {
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
  out += (size_t)t * s.M * s.Co;
  float mu, inv;
  conv_bn_stats(x, w, b, s, co, wcol, red, y, &mu, &inv);
  const float g = ld(sc + co), h = ld(be + co);
  for (int m = threadIdx.x; m < s.M; m += blockDim.x)
    st(out + (size_t)m * s.Co + co, fmaxf((y[m] - mu) * inv * g + h, 0.f));
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

// One thread per input element (b, n, hi, wi, ci): the transposed
// stride-2 conv as a gather over the taps whose output lands in range,
//   dx = sum_{dy,dx: (hi+1-dy) even, i=(hi+1-dy)/2 in [0,Ho), same for w}
//        sum_co dy[b, n, i, j, co] * w[b, dy, dx, ci, co].
template <typename T>
__global__ void __launch_bounds__(kThreads)
cnn4_block_bwd_input_kernel(const float* __restrict__ dy,
                            const T* __restrict__ w, T* __restrict__ dx,
                            int B, Shape s) {
  const size_t total = (size_t)B * s.N * s.H * s.W * s.Ci;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int ci = e % s.Ci;
    size_t r = e / s.Ci;
    const int wi = r % s.W;
    r /= s.W;
    const int hi = r % s.H;
    r /= s.H;
    const int n = r % s.N;
    const int t = r / s.N;
    const T* wt = w + (size_t)t * 9 * s.Ci * s.Co;
    const float* dyt = dy + (size_t)t * s.M * s.Co;
    float acc = 0.f;
    for (int ty = 0; ty < 3; ++ty) {
      const int ti = hi + 1 - ty;
      if (ti < 0 || (ti & 1)) continue;
      const int i = ti >> 1;
      if (i >= s.Ho) continue;
      for (int tx = 0; tx < 3; ++tx) {
        const int tj = wi + 1 - tx;
        if (tj < 0 || (tj & 1)) continue;
        const int j = tj >> 1;
        if (j >= s.Wo) continue;
        const float* dp = dyt + (((size_t)n * s.Ho + i) * s.Wo + j) * s.Co;
        const T* wp = wt + ((size_t)(ty * 3 + tx) * s.Ci + ci) * s.Co;
        for (int c = 0; c < s.Co; ++c) acc += dp[c] * ld(wp + c);
      }
    }
    st(dx + e, acc);
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

template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, const void* sc,
               const void* be, void* out, int B, const Shape& s,
               cudaStream_t st) {
  const size_t smem = smem_floats(s) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cnn4_block_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cnn4_block_fwd_kernel<T><<<dim3(s.Co, B), kThreads, smem, st>>>(
      (const T*)x, (const T*)w, (const T*)b, (const T*)sc, (const T*)be,
      (T*)out, s);
  return (int)cudaGetLastError();
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
  const size_t total = (size_t)B * s.N * s.H * s.W * s.Ci;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < 1048576 ? blocks : 1048576);
  cnn4_block_bwd_input_kernel<T><<<grid, kThreads, 0, st>>>(
      (const float*)dy, (const T*)w, (T*)dx, B, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype: 0 = float32,
// 1 = bfloat16. Each returns a cudaError_t code; 0 means launched.
extern "C" {

int cnn4_block_fwd(int dtype, const void* x, const void* w, const void* b,
                   const void* sc, const void* be, void* out, int B, int N,
                   int H, int W, int Ci, int Co, void* stream) {
  const Shape s = make_shape(N, H, W, Ci, Co);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_fwd<float>(x, w, b, sc, be, out, B, s, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, b, sc, be, out, B, s, st);
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
