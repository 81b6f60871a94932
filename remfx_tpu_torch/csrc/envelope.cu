// Ballistics envelope follower (JUCE peak ballistics) for Hopper, sm_90a.
//
// Replaces the TPU kernel remfx_tpu/ops/pallas_env.py:_env_kernel (driven
// by _envelope_tb and envelope_pallas). Per row b and time step t:
//
//     env[t] = xa[t] + cte * (env[t-1] - xa[t]),   env[-1] = 0
//     cte    = cte_at[b] if xa[t] > env[t-1] else cte_rl[b]
//
// The branch depends on the carry, so there is no scan or FFT shortcut:
// each row is one chain of T dependent steps.
//
// Bound on this card. The bytes are small: at the main path's shape
// (B = 8 rows, T = 262144) the kernel reads and writes 8 * 262144 * 8 B,
// about 16.8 MB, or 5 us at 3.35 TB/s. The true floor is the dependency
// chain: T steps of compare -> select -> FMA. The two candidate FMAs
// (attack and release) do not depend on the compare, so the chain per
// step is one compare, one select and nothing else; about 8-10 cycles a
// step, 1.1-1.4 ms at a 1.98 GHz boost clock for T = 262144.
//
// Design: right and simple, not fast yet. One thread owns one row and
// walks time in registers; no padding of B or T (the TPU version padded B
// to 128 lanes and T to 2048-sample chunks), the ragged tail is a scalar
// loop. No shared memory. Rows that are 16-byte aligned are read as
// float4, 32 samples (one 128-byte line) at a time, and the next 32
// samples are loaded while the current 32 steps run, so that a load's
// latency hides behind the chain; other rows take a scalar path.
// Parallelism is only across rows (8 threads at the main path's shape):
// fusing |x|, the gain and the multiply, or splitting time, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // float4 loads per chunk: 32 samples, 128 bytes

__device__ __forceinline__ float ballistics_step(float xa, float& env,
                                                 float at, float rl) {
  const float d = env - xa;
  const float ya = fmaf(at, d, xa);
  const float yr = fmaf(rl, d, xa);
  env = (xa > env) ? ya : yr;
  return env;
}

__device__ __forceinline__ float4 step4(float4 v, float& env, float at,
                                        float rl) {
  float4 r;
  r.x = ballistics_step(v.x, env, at, rl);
  r.y = ballistics_step(v.y, env, at, rl);
  r.z = ballistics_step(v.z, env, at, rl);
  r.w = ballistics_step(v.w, env, at, rl);
  return r;
}

__global__ void envelope_kernel(const float* __restrict__ x,
                                const float* __restrict__ cte_at,
                                const float* __restrict__ cte_rl,
                                float* __restrict__ out, int rows,
                                long long T) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= rows) return;
  const float* xr = x + (long long)b * T;
  float* orow = out + (long long)b * T;
  const float at = cte_at[b];
  const float rl = cte_rl[b];
  float env = 0.0f;
  long long t = 0;

  const bool aligned =
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(orow)) &
       15u) == 0;
  if (aligned) {
    const long long chunks = T / (4 * kVec);
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* o4 = reinterpret_cast<float4*>(orow);
    float4 next[kVec];
    if (chunks > 0) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) next[k] = __ldg(x4 + k);
    }
    for (long long c = 0; c < chunks; ++c) {
      float4 cur[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) cur[k] = next[k];
      if (c + 1 < chunks) {
        const float4* src = x4 + (c + 1) * kVec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) next[k] = __ldg(src + k);
      }
      float4* dst = o4 + c * kVec;
#pragma unroll
      for (int k = 0; k < kVec; ++k) dst[k] = step4(cur[k], env, at, rl);
    }
    t = chunks * 4 * kVec;
  }
  for (; t < T; ++t) orow[t] = ballistics_step(xr[t], env, at, rl);
}

}  // namespace

// Plain C entry point, bound with ctypes. x and out are (rows, T) fp32,
// contiguous; cte_at and cte_rl are (rows,) fp32; all on the device.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported.
extern "C" int remfx_envelope(const float* x, const float* cte_at,
                              const float* cte_rl, float* out, int rows,
                              long long T, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  envelope_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, cte_at, cte_rl, out, rows, T);
  return static_cast<int>(cudaGetLastError());
}
