// Reverse GAE and discounted-return sweeps for sm_90a (H100).
//
// Replaces the two TPU kernels of exploring_meta_tpu/pallas/gae_pallas.py:
//
//   gae_sweep       <- _gae_kernel      (via _run_lanes, gae_pallas.py:31, :62)
//       a_t = (r_t + gamma (1 - d_t) V_{t+1} - V_t) + gamma tau (1 - d_t) a_{t+1},
//       V_T = 0, a_T = 0
//   discount_sweep  <- _discount_kernel (via _run_lanes, gae_pallas.py:50, :62)
//       R_t = r_t + gamma (1 - d_t) R_{t+1},  R_T = 0
//
// Layout. Every tensor is contiguous float32 [G, T, L] with time in the
// middle: [T] is G = 1, L = 1; [T, E] is G = 1, L = E; a task batch
// [B, T, E] is G = B, L = E. The TPU kernel needed time leading and the
// lanes padded to 128 (gae_pallas.py:62-84); here no copy or padding is
// made. One thread owns one (g, l) lane and walks t = T-1 .. 0 with its
// carry in a register. Neighbouring threads own neighbouring l, so each
// copy and store of a warp is coalesced.
//
// What bounds it. The work is tiny: at the main path's [20, 100, 20] one
// GAE launch reads 3 x 160 KB and writes 160 KB (about 0.2 us at
// 3.35 TB/s) and does 7 FLOPs per element. The time is set by latency: a
// loop that loads r[t], d[t], V[t] when step t begins pays T dependent
// trips to memory. The loads do not depend on the carry, so the kernel
// stages the lane's inputs through shared memory in chunks of kChunk
// steps with cp.async, double-buffered: chunk j+1 is in flight while
// chunk j's recurrence runs, and no register is held for a load in
// flight. (Loading a chunk into a register array instead does not work:
// ptxas sinks each load next to its use and the loop pays one round trip
// per step.) Each thread reads back only what it copied, so no block
// barrier is needed.
//
// Each entry point returns cudaGetLastError() after the launch; the
// Python wrapper (cuda/gae_cuda.py) raises if it is not 0.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // small blocks spread 400 lanes over 7 SMs
constexpr int kChunk = 16;     // time steps per staged chunk

template <bool kGae>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ r, const float* __restrict__ d,
             const float* __restrict__ v, float* __restrict__ out,
             int G, int T, int L, float gamma, float gamma_tau) {
  __shared__ float sr[2][kChunk][kThreads];
  __shared__ float sd[2][kChunk][kThreads];
  __shared__ float sv[kGae ? 2 : 1][kGae ? kChunk : 1][kThreads];
  const int tid = threadIdx.x;
  const long lane = (long)blockIdx.x * kThreads + tid;
  if (lane >= (long)G * L) return;
  const long g = lane / L;
  const long base = g * (long)T * L + (lane - g * L);
  const int chunks = (T + kChunk - 1) / kChunk;

  // chunk j holds steps t = top - k, k = 0 .. n-1, in buffer j % 2
  auto fetch = [&](int j) {
    const int buf = j & 1, top = T - 1 - j * kChunk;
    const int n = min(kChunk, top + 1);
    for (int k = 0; k < n; ++k) {
      const long i = base + (long)(top - k) * L;
      __pipeline_memcpy_async(&sr[buf][k][tid], r + i, sizeof(float));
      __pipeline_memcpy_async(&sd[buf][k][tid], d + i, sizeof(float));
      if constexpr (kGae) {
        __pipeline_memcpy_async(&sv[buf][k][tid], v + i, sizeof(float));
      }
    }
    __pipeline_commit();
  };

  float carry = 0.f;   // a_{t+1} (GAE) or R_{t+1} (discount)
  float v_next = 0.f;  // V_{t+1} (GAE)
  fetch(0);
  for (int j = 0; j < chunks; ++j) {
    if (j + 1 < chunks) {
      fetch(j + 1);              // overwrites the buffer of chunk j-1
      __pipeline_wait_prior(1);  // chunk j has landed
    } else {
      __pipeline_wait_prior(0);
    }
    const int buf = j & 1, top = T - 1 - j * kChunk;
    const int n = min(kChunk, top + 1);
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float nd = 1.f - sd[buf][k][tid];
      if constexpr (kGae) {
        const float vt = sv[buf][k][tid];
        const float td = sr[buf][k][tid] + gamma * nd * v_next - vt;
        carry = td + gamma_tau * nd * carry;
        v_next = vt;
      } else {
        carry = sr[buf][k][tid] + gamma * carry * nd;
      }
      out[base + (long)(top - k) * L] = carry;
    }
  }
}

unsigned blocks_for(int G, int L) {
  return (unsigned)(((long)G * L + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int gae_sweep(const float* r, const float* d, const float* v,
                         float* out, int G, int T, int L, float gamma,
                         float gamma_tau, void* stream) {
  sweep_kernel<true><<<blocks_for(G, L), kThreads, 0,
                       (cudaStream_t)stream>>>(r, d, v, out, G, T, L, gamma,
                                               gamma_tau);
  return (int)cudaGetLastError();
}

extern "C" int discount_sweep(const float* r, const float* d, float* out,
                              int G, int T, int L, float gamma,
                              void* stream) {
  sweep_kernel<false><<<blocks_for(G, L), kThreads, 0,
                        (cudaStream_t)stream>>>(r, d, nullptr, out, G, T, L,
                                                gamma, 0.f);
  return (int)cudaGetLastError();
}
