// Phaser recurrence (six modulated first-order all-passes with feedback) for
// Hopper, sm_90a.
//
// No TPU kernel: the JAX package renders the phaser with a lax.scan over
// time (remfx_tpu/fx/phaser.py:_render, the scan at :94), and no PyTorch
// call computes this recurrence. Per row (example b, channel c) and sample t,
// with the coefficient a = a[b, t] computed beforehand in PyTorch:
//
//     u        = x[t] + feedback * last
//     y_s      = a * u_s + xs[s] - a * ys[s],   u_0 = u, u_{s+1} = y_s,
//                s = 0..5; then xs[s] = u_s, ys[s] = y_s, last = y_5
//     out[t]   = (1 - mix) * x[t] + mix * y_5
//
// Rounding. Every operation is an intrinsic that rounds to nearest
// (__fmul_rn, __fadd_rn, __fsub_rn), in the order of the plain PyTorch
// version (ops/phaser.py:phaser_plain), so nvcc contracts nothing into an
// FMA: each IEEE product or sum gives the same value here and on the CPU,
// and the kernel equals the plain version bit for bit.
//
// Bound on this card. The bytes are few: at (8, 2, 262144) the kernel reads
// x and a and writes out, (2 * B * C * T + B * T) * 4 B = 41.9 MB, 12.5 us
// at 3.35 TB/s. What bounds it is latency: the feedback closes the loop through
// all six stages, so each sample is a chain of 20 dependent roundings (the
// feedback's multiply and add, then a multiply, an add and a subtract per
// stage), about 80 cycles, and a row is T such samples in a row: about 11 ms
// at T = 262144 and 1.98 GHz, whatever the number of rows.
//
// Design: one thread per row, the 13 state floats in registers, walking T.
// Rows that are 16-byte aligned read x and a as float4, one 128-byte line
// (32 samples) at a time, with the next line loaded while the current one
// runs, so the loads stay off the chain; other rows take a scalar path. A
// time-parallel form (an affine scan over the 13-float state) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 6;
constexpr int kVec = 8;          // float4 loads per line
constexpr int kLine = 4 * kVec;  // 32 samples, 128 bytes
constexpr int kThreads = 32;

struct State {
  float xs[kStages];
  float ys[kStages];
  float last;
};

__device__ __forceinline__ float phaser_step(float xn, float a, float fb,
                                             float dry, float mix, State& s) {
  float u = __fadd_rn(xn, __fmul_rn(fb, s.last));
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    const float y = __fsub_rn(__fadd_rn(__fmul_rn(a, u), s.xs[k]),
                              __fmul_rn(a, s.ys[k]));
    s.xs[k] = u;
    s.ys[k] = y;
    u = y;
  }
  s.last = u;
  return __fadd_rn(__fmul_rn(dry, xn), __fmul_rn(mix, u));
}

__device__ __forceinline__ float4 step4(float4 x, float4 a, float fb,
                                        float dry, float mix, State& s) {
  float4 r;
  r.x = phaser_step(x.x, a.x, fb, dry, mix, s);
  r.y = phaser_step(x.y, a.y, fb, dry, mix, s);
  r.z = phaser_step(x.z, a.z, fb, dry, mix, s);
  r.w = phaser_step(x.w, a.w, fb, dry, mix, s);
  return r;
}

__global__ void phaser_kernel(const float* __restrict__ x,
                              const float* __restrict__ a,
                              const float* __restrict__ feedback,
                              const float* __restrict__ mix,
                              float* __restrict__ out, int rows, int channels,
                              long long T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int b = r / channels;
  const float* xr = x + (long long)r * T;
  const float* ar = a + (long long)b * T;
  float* orow = out + (long long)r * T;
  const float fb = feedback[b];
  const float m = mix[b];
  const float dry = __fsub_rn(1.0f, m);
  State s;
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    s.xs[k] = 0.0f;
    s.ys[k] = 0.0f;
  }
  s.last = 0.0f;
  long long t = 0;

  const bool aligned = ((reinterpret_cast<uintptr_t>(xr) |
                         reinterpret_cast<uintptr_t>(ar) |
                         reinterpret_cast<uintptr_t>(orow)) & 15u) == 0;
  if (aligned) {
    const long long lines = T / kLine;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* a4 = reinterpret_cast<const float4*>(ar);
    float4* o4 = reinterpret_cast<float4*>(orow);
    float4 nx[kVec], na[kVec];
    if (lines > 0) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        nx[i] = x4[i];
        na[i] = a4[i];
      }
    }
    for (long long l = 0; l < lines; ++l) {
      float4 cx[kVec], ca[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        cx[i] = nx[i];
        ca[i] = na[i];
      }
      if (l + 1 < lines) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          nx[i] = x4[(l + 1) * kVec + i];
          na[i] = a4[(l + 1) * kVec + i];
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        o4[l * kVec + i] = step4(cx[i], ca[i], fb, dry, m, s);
      }
    }
    t = lines * kLine;
  }
  for (; t < T; ++t) {
    orow[t] = phaser_step(xr[t], ar[t], fb, dry, m, s);
  }
}

}  // namespace

// x and out are (batch, channels, T), a is (batch, T), feedback and mix are
// (batch,), all fp32 and contiguous. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported.
extern "C" int remfx_phaser(const float* x, const float* a,
                            const float* feedback, const float* mix,
                            float* out, int batch, int channels, long long T,
                            void* stream) {
  if (batch <= 0 || channels <= 0 || T <= 0) return 0;
  const int rows = batch * channels;
  const int blocks = (rows + kThreads - 1) / kThreads;
  phaser_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, a, feedback, mix, out, rows, channels, T);
  return static_cast<int>(cudaGetLastError());
}
