// Reverse GAE and discounted-return sweeps for sm_90a (H100), as a
// segmented affine scan over time.
//
// Replaces the two TPU kernels of exploring_meta_tpu/pallas/gae_pallas.py:
//
//   gae_sweep       <- _gae_kernel      (via _run_lanes, gae_pallas.py:31, :62)
//   discount_sweep  <- _discount_kernel (via _run_lanes, gae_pallas.py:50, :62)
//
// Both are the reverse recurrence x_t = b_t + a_t x_{t+1}, x_T = 0, with
//   GAE       a_t = gamma tau (1 - d_t),  b_t = r_t + gamma (1 - d_t) V_{t+1} - V_t,
//             V_T = 0;
//   discount  a_t = gamma (1 - d_t),      b_t = r_t.
// No a_t or b_t depends on the carry, and affine maps compose
// associatively, (a, b) o (a', b') = (a a', b + a b'), so time is split
// across threads.
//
// Layout. Every tensor is contiguous float32 [G, T, L] with time in the
// middle: [T] is G = 1, L = 1; [T, E] is G = 1, L = E; a task batch
// [B, T, E] is G = B, L = E. A lane is one (g, l). No copy or padding is
// made (the TPU kernel needed time leading and 128 padded lanes,
// gae_pallas.py:62-84).
//
// Decomposition. A warp owns one lane and a CTA kLanes consecutive lanes.
// Time is cut into slabs of kSlab = 32 kSeg steps, walked from the end of
// time; in a slab, thread s of a warp owns steps [s kSeg, (s + 1) kSeg).
// kSeg is 4 while one slab covers T (T <= 128), else 8: half the slabs,
// each with a chain 8 steps longer.
//   1. Staging: the CTA copies a slab of its lanes into shared memory with
//      cp.async, lane-major with time contiguous, so that each thread
//      then reads its steps of an array as one 16-byte load. The copies
//      are coalesced: across lanes at one step when L > 1 (4 bytes each;
//      the row pitch kPitch puts a warp's 8 steps x 4 lanes in 32 banks),
//      along time when L = 1 (16 bytes where aligned, 4 at the edges).
//      The top slab's steps past T are zero, which leaves x = 0 and V = 0
//      there: the zero bootstrap. While a slab is computed the one before
//      it in time is in flight (two buffers).
//   2. Fold: each thread forms its a_t, b_t in registers (GAE takes
//      V_{t+1} of its top step from thread s + 1 by a shuffle) and folds
//      them, from its top step down, into one map (A, B).
//   3. Combine: an inclusive suffix scan of the warp's 32 maps by shuffles
//      (5 steps) gives each thread the map from its first step to the
//      slab's top; applied to the slab's incoming carry it gives the x at
//      the first step of each segment, and thread s takes thread s + 1's
//      as its carry.
//   4. Replay: each thread reruns its steps from its carry into its lane's
//      r row in shared memory; after a barrier the CTA stores the slab's
//      outputs as step 1 copied its inputs, coalesced.
//   Thread 0's output at the slab's first step (and, for GAE, V there)
//   carries to the slab before it, in registers.
// The order of every operation is fixed and there are no atomics, so two
// calls are bitwise equal. cuda/gae_cuda.py:scan_plain is this
// decomposition in PyTorch.
//
// What bounds it. The work is tiny: at the main path's [20, 100, 20] a GAE
// launch reads 3 x 160 KB and writes 160 KB (0.19 us at 3.35 TB/s). The
// time is the launch, one round trip to L2 or HBM for the staged inputs,
// the chain of dependent steps, and each SM's count of memory
// transactions. One thread per lane walking all T steps made the chain T
// long (100 at the main path); here it is kSeg + 5 shuffle steps + kSeg a
// slab (13 at T <= 128), and the 400 lanes of the main path are 400 warps
// in 100 CTAs, not 7 CTAs of 64 threads. A thread storing its own steps
// would write 32 scattered words per warp store where L > 1; step 4 makes
// them runs across lanes. Each further slab costs another barrier-bound
// round of steps 1-4, hence the longer segment past T = 128. PERF.md has
// the times of these choices.
//
// Each entry point returns cudaGetLastError() after the launch; the
// Python wrapper (cuda/gae_cuda.py) raises if it is not 0.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// steps a thread owns in a slab: kSegShort while one slab of 32 kSegShort
// steps covers T, else kSegLong
constexpr int kSegShort = 4;
constexpr int kSegLong = 8;
constexpr int kLanes = 4;             // lanes (warps) a CTA
constexpr int kThreads = 32 * kLanes;
constexpr unsigned kFull = 0xffffffffu;

template <bool kGae, int kSeg>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ r, const float* __restrict__ d,
            const float* __restrict__ v, float* __restrict__ out,
            int G, int T, int L, float gamma, float gamma_tau) {
  constexpr int kSlab = 32 * kSeg;        // steps a slab: 32 segments, a warp
  // floats between two lanes' rows in shared memory: a multiple of 4
  // (16-byte reads), 8 past kSlab so a warp's transposing copies hit 32
  // banks
  constexpr int kPitch = kSlab + 8;
  static_assert(kSeg % 4 == 0, "a thread reads its steps 16 bytes at a time");
  static_assert(kSlab % (kThreads / kLanes) == 0,
                "the L > 1 copy gives each thread one lane and whole rows");
  constexpr int kArrays = kGae ? 3 : 2;   // r, d (, V)
  __shared__ __align__(16) float sm[2][kArrays][kLanes][kPitch];
  const float* const src[3] = {r, d, v};
  const int tid = threadIdx.x, warp = tid / 32, s = tid % 32;
  const long lanes = (long)G * L;
  const long lane0 = (long)blockIdx.x * kLanes;

  // The lane this thread copies: for L = 1 its own warp's, steps s kSeg ..
  // (its own); for L > 1 lane tid % kLanes, steps tid / kLanes + 32 i.
  // c_off is the offset of that lane's step 0.
  const int cj = L == 1 ? warp : tid % kLanes;
  const long c_lane = lane0 + cj;
  const bool c_live = c_lane < lanes;
  const long c_off = c_live ? (c_lane / L) * (long)T * L + c_lane % L : 0;

  auto stage = [&](int slab, int buf) {
    const int t0 = slab * kSlab, n = min(kSlab, T - t0);
#pragma unroll
    for (int a = 0; a < kArrays; ++a) {
      float* dst = sm[buf][a][cj];
      const float* g = src[a] + c_off + (long)t0 * L;
      if (L == 1) {
#pragma unroll
        for (int k = s * kSeg; k < (s + 1) * kSeg; k += 4) {
          if (c_live && k + 4 <= n && (reinterpret_cast<uintptr_t>(g + k) & 15) == 0) {
            __pipeline_memcpy_async(dst + k, g + k, 16);
            continue;
          }
#pragma unroll
          for (int e = k; e < k + 4; ++e) {
            if (c_live && e < n) {
              __pipeline_memcpy_async(dst + e, g + e, sizeof(float));
            } else {
              dst[e] = 0.f;
            }
          }
        }
      } else {
#pragma unroll
        for (int k = tid / kLanes; k < kSlab; k += kThreads / kLanes) {
          if (c_live && k < n) {
            __pipeline_memcpy_async(dst + k, g + (long)k * L, sizeof(float));
          } else {
            dst[k] = 0.f;
          }
        }
      }
    }
    __pipeline_commit();
  };

  // Store the outputs of a slab from the r rows of `buf`, as `stage` copied
  // them in: coalesced across lanes (L > 1) or along time (L = 1).
  auto unstage = [&](int slab, int buf) {
    const int t0 = slab * kSlab, n = min(kSlab, T - t0);
    if (!c_live) return;
    const float* row = sm[buf][0][cj];
    float* g = out + c_off + (long)t0 * L;
    if (L == 1) {
#pragma unroll
      for (int k = s * kSeg; k < (s + 1) * kSeg; k += 4) {
        if (k + 4 <= n && (reinterpret_cast<uintptr_t>(g + k) & 15) == 0) {
          *reinterpret_cast<float4*>(g + k) =
              *reinterpret_cast<const float4*>(row + k);
          continue;
        }
        for (int e = k; e < min(k + 4, n); ++e) g[e] = row[e];
      }
    } else {
      for (int k = tid / kLanes; k < n; k += kThreads / kLanes) {
        g[(long)k * L] = row[k];
      }
    }
  };

  const bool live = lane0 + warp < lanes;   // the same for the whole warp
  const int slabs = (T + kSlab - 1) / kSlab;
  float carry = 0.f;   // x at the first step of the slab after this one
  float v_top = 0.f;   // GAE: V there
  stage(slabs - 1, 0);
  for (int i = slabs - 1, buf = 0; i >= 0; --i, buf ^= 1) {
    if (i > 0) {
      stage(i - 1, buf ^ 1);     // the buffer slab i + 1 used
      __pipeline_wait_prior(1);  // slab i has landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    float* row = sm[buf][0][warp];   // this lane's r; then its outputs
    if (live) {
      float rr[kSeg], dd[kSeg], vv[kSeg];
#pragma unroll
      for (int k = 0; k < kSeg; k += 4) {
        const int at = s * kSeg + k;
        const float4 r4 = *reinterpret_cast<const float4*>(row + at);
        const float4 d4 =
            *reinterpret_cast<const float4*>(&sm[buf][1][warp][at]);
        rr[k] = r4.x, rr[k + 1] = r4.y, rr[k + 2] = r4.z, rr[k + 3] = r4.w;
        dd[k] = d4.x, dd[k + 1] = d4.y, dd[k + 2] = d4.z, dd[k + 3] = d4.w;
        if constexpr (kGae) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(&sm[buf][kArrays - 1][warp][at]);
          vv[k] = v4.x, vv[k + 1] = v4.y, vv[k + 2] = v4.z, vv[k + 3] = v4.w;
        }
      }
      float a[kSeg], b[kSeg];
      float v_up = 0.f;   // GAE: V_{t+1} of this thread's top step
      if constexpr (kGae) {
        v_up = __shfl_down_sync(kFull, vv[0], 1);
        if (s == 31) v_up = v_top;
      }
#pragma unroll
      for (int k = 0; k < kSeg; ++k) {
        const float nd = 1.f - dd[k];
        if constexpr (kGae) {
          const float vn = k + 1 < kSeg ? vv[k + 1] : v_up;
          a[k] = gamma_tau * nd;
          b[k] = rr[k] + gamma * nd * vn - vv[k];
        } else {
          a[k] = gamma * nd;
          b[k] = rr[k];
        }
      }
      // fold: x_first = A x_in + B, x_in the carry into the top step
      float A = a[kSeg - 1], B = b[kSeg - 1];
#pragma unroll
      for (int k = kSeg - 2; k >= 0; --k) {
        B = fmaf(a[k], B, b[k]);
        A = a[k] * A;
      }
      // combine: after step `off`, (A, B) maps the carry into segment
      // min(s + 2 off, 32) - 1's top to x at segment s's first step
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float A2 = __shfl_down_sync(kFull, A, off);
        const float B2 = __shfl_down_sync(kFull, B, off);
        if (s + off < 32) {
          B = fmaf(A, B2, B);
          A = A * A2;
        }
      }
      float x = __shfl_down_sync(kFull, fmaf(A, carry, B), 1);
      if (s == 31) x = carry;
      // replay, into this thread's steps of the r row
      float xs[kSeg];
#pragma unroll
      for (int k = kSeg - 1; k >= 0; --k) {
        x = fmaf(a[k], x, b[k]);
        xs[k] = x;
      }
#pragma unroll
      for (int k = 0; k < kSeg; k += 4) {
        *reinterpret_cast<float4*>(row + s * kSeg + k) =
            make_float4(xs[k], xs[k + 1], xs[k + 2], xs[k + 3]);
      }
      carry = __shfl_sync(kFull, x, 0);
      if constexpr (kGae) v_top = __shfl_sync(kFull, vv[0], 0);
    }
    __syncthreads();
    unstage(i, buf);
    // slab i - 1 is staged into `buf` next: every thread must be done with it
    if (i > 1) __syncthreads();
  }
}

template <bool kGae>
int launch(const float* r, const float* d, const float* v, float* out, int G,
           int T, int L, float gamma, float gamma_tau, void* stream) {
  if ((long)G * L * T == 0) return 0;
  const unsigned blocks = (unsigned)(((long)G * L + kLanes - 1) / kLanes);
  const auto st = (cudaStream_t)stream;
  if (T <= 32 * kSegShort) {
    scan_kernel<kGae, kSegShort><<<blocks, kThreads, 0, st>>>(
        r, d, v, out, G, T, L, gamma, gamma_tau);
  } else {
    scan_kernel<kGae, kSegLong><<<blocks, kThreads, 0, st>>>(
        r, d, v, out, G, T, L, gamma, gamma_tau);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gae_sweep(const float* r, const float* d, const float* v,
                         float* out, int G, int T, int L, float gamma,
                         float gamma_tau, void* stream) {
  return launch<true>(r, d, v, out, G, T, L, gamma, gamma_tau, stream);
}

extern "C" int discount_sweep(const float* r, const float* d, float* out,
                              int G, int T, int L, float gamma,
                              void* stream) {
  return launch<false>(r, d, nullptr, out, G, T, L, gamma, 0.f, stream);
}
