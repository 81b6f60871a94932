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
// about 16.8 MB, or 5 us at 3.35 TB/s. What bounds a kernel that walks
// time is the latency of one step's dependency chain (subtract, FMA, and
// the compare's pick of attack or release), times the steps of its longest
// walk. One thread per row (the serial kernel below) walks T steps with
// the card almost empty: 8 threads, one warp, at the main path's shape.
//
// Design: split time over threads, exactly. Every step e -> f_t(e) is
// monotone non-decreasing in fp32: for e >= xa, d = e - xa rounds
// monotonically and fmaf(rl, d, xa) >= xa; for e < xa the attack FMA
// gives a value <= xa; rounding is monotone. So two trajectories started
// at lo <= env <= hi enclose the true one at every later step, and once
// they are bitwise equal the true one equals them from then on (the map
// is deterministic). Valid bounds anywhere in a row are lo = min(0, row
// minimum) and hi = max(0, row maximum): env is a convex mix of 0 and the
// past xa, and rounding keeps it there while 0 <= cte < 1.
//
//   pass 0  bounds_kernel, one block per row: lo and hi of the row.
//   pass 1  chunks_kernel, one thread per (row, chunk of L = kChunk
//           samples), all in parallel. Each starts lo and hi W samples
//           before its chunk, W = ceil(kWarmTau / (1 - max(cte_at, cte_rl)))
//           rounded up to a line: the bracket's gap shrinks by a factor
//           max(cte_at, cte_rl) or less a step, so W is kWarmTau time
//           constants.
//           A chunk within W of the row's start starts from the exact 0 at
//           position 0 instead. If lo and hi are bitwise equal at the chunk's
//           start, that start is exact and the chunk is resolved; otherwise
//           the chunk holds the hi trajectory and is flagged unresolved.
//   pass 2  repair_kernel, one thread per run of consecutive unresolved
//           chunks, all runs in parallel, each walking its chunks in order:
//           a chunk is rerun from out[start - 1], which is exact by then,
//           until its values meet the stored ones bitwise (checked a line at
//           a time); from there the stored hi trajectory is the true one.
//           This makes every input exact, digital silence after a loud hit
//           too (the bracket never closes there, since lo stays at 0); in
//           that worst case one run spans the silence, and pass 2 is about
//           as slow as the serial kernel.
//
// All passes share ballistics_step, so the result equals the serial
// kernel's bit for bit. A pass-1 thread walks about W + L steps of two
// interleaved chains; the slowest row sets the time. W trades pass 1
// against pass 2: the gap closes by a factor e every time constant, so
// closing it from the full range to one ulp of fp32 takes about 17 of
// them, more where the level is far below the row's maximum; a shorter
// W leaves more chunks, in longer runs, to pass 2 (L = 1024 and 20 time
// constants were chosen on the H100; see PERF.md). The warm-up re-reads
// about (W + L) / L times the input, mostly from the 50 MB L2. Rows that
// are 16-byte aligned are read as float4, 32 samples (one 128-byte line)
// at a time, with the next line loaded while the current 32 steps run;
// other rows take a scalar path. The wrapper allocates the scratch (the
// bounds and the flags); the kernels allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;            // float4 loads per line
constexpr int kLine = 4 * kVec;    // 32 samples, 128 bytes
constexpr int kBoundsThreads = 1024;
// passes 1 and 2: one warp a block, so that the blocks spread over the SMs
constexpr int kThreads = 32;
// samples a pass-1 thread owns (a multiple of kLine), and the warm-up in
// time constants; ops/envelope.py's CHUNK and WARM_TAU mirror them
constexpr long long kChunk = 1024;
constexpr float kWarmTau = 20.0f;

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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// ---- the serial kernel: one thread walks a whole row ----

__global__ void envelope_serial_kernel(const float* __restrict__ x,
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

// ---- the split kernel: passes 0-2 ----

// Runs op over x[from, to) in time order. With `vec` (x + from, and out +
// from where op touches out, 16-byte aligned): float4 lines of 32 samples,
// the next line of x, and of the stored values op reads (op.stored4), loaded
// while the current one runs; otherwise one sample at a time. Stops after
// the line, or the sample, where op.done() turns true.
template <class Op>
__device__ __forceinline__ void walk(const float* __restrict__ x,
                                     long long from, long long to, bool vec,
                                     Op& op) {
  long long t = from;
  if (vec) {
    const long long lines = (to - from) / kLine;
    const float4* x4 = reinterpret_cast<const float4*>(x + from);
    float4 nx[kVec], ny[kVec];
    if (lines > 0) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        nx[k] = __ldg(x4 + k);
        ny[k] = op.stored4(from + 4 * k);
      }
    }
    for (long long c = 0; c < lines; ++c) {
      float4 cx[kVec], cy[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        cx[k] = nx[k];
        cy[k] = ny[k];
      }
      if (c + 1 < lines) {
        const float4* src = x4 + (c + 1) * kVec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          nx[k] = __ldg(src + k);
          ny[k] = op.stored4(t + kLine + 4 * k);
        }
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) op.step4(cx[k], cy[k], t + 4 * k);
      t += kLine;
      if (op.done()) return;
    }
  }
  for (; t < to; ++t) {
    op.step1(__ldg(x + t), op.stored1(t), t);
    if (op.done()) return;
  }
}

// Pass 1's warm-up: the lower and the upper trajectory; touches no out.
struct Bracket {
  float lo, hi, at, rl;
  __device__ float stored1(long long) const { return 0.0f; }
  __device__ float4 stored4(long long) const { return float4{}; }
  __device__ void step1(float xa, float, long long) {
    ballistics_step(xa, lo, at, rl);
    ballistics_step(xa, hi, at, rl);
  }
  __device__ void step4(float4 v, float4, long long) {
    ::step4(v, lo, at, rl);
    ::step4(v, hi, at, rl);
  }
  __device__ bool done() const { return false; }
};

// Pass 1's chunk: one trajectory, written to out.
struct Follow {
  float env, at, rl;
  float* out;
  __device__ float stored1(long long) const { return 0.0f; }
  __device__ float4 stored4(long long) const { return float4{}; }
  __device__ void step1(float xa, float, long long t) {
    out[t] = ballistics_step(xa, env, at, rl);
  }
  __device__ void step4(float4 v, float4, long long t) {
    *reinterpret_cast<float4*>(out + t) = ::step4(v, env, at, rl);
  }
  __device__ bool done() const { return false; }
};

// Pass 2: the exact trajectory over a chunk that holds the hi trajectory,
// until the two meet. Past the meeting point it rewrites equal values.
struct Repair {
  float env, at, rl;
  float* out;
  bool met;
  __device__ float stored1(long long t) const { return out[t]; }
  __device__ float4 stored4(long long t) const {
    return *reinterpret_cast<const float4*>(out + t);
  }
  __device__ void step1(float xa, float hi, long long t) {
    out[t] = ballistics_step(xa, env, at, rl);
    met |= same(env, hi);
  }
  __device__ void step4(float4 v, float4 hi, long long t) {
    const float4 e = ::step4(v, env, at, rl);
    *reinterpret_cast<float4*>(out + t) = e;
    met |= same(e.x, hi.x) | same(e.y, hi.y) | same(e.z, hi.z) |
           same(e.w, hi.w);
  }
  __device__ bool done() const { return met; }
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Pass 0: bounds[2b] = min(0, min_t x[b, t]), bounds[2b + 1] = max(0, ...).
__global__ void bounds_kernel(const float* __restrict__ x,
                              float* __restrict__ bounds, long long T) {
  const float* xr = x + (long long)blockIdx.x * T;
  float lo = 0.0f, hi = 0.0f;
  const long long n4 = aligned16(xr) ? T / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll 4
  for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 v = __ldg(x4 + i);
    lo = fminf(lo, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
    hi = fmaxf(hi, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
  }
  for (long long t = 4 * n4 + threadIdx.x; t < T; t += blockDim.x) {
    const float v = __ldg(xr + t);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  __shared__ float part[2][kBoundsThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    part[0][warp] = lo;
    part[1][warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x / 32;
    lo = lane < warps ? part[0][lane] : 0.0f;
    hi = lane < warps ? part[1][lane] : 0.0f;
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      bounds[2 * blockIdx.x] = lo;
      bounds[2 * blockIdx.x + 1] = hi;
    }
  }
}

// Warm-up length W of a row: kWarmTau time constants of the slower of the
// two coefficients, rounded up to a line; T (start from 0) where the
// coefficients do not contract (outside [0, 1), or NaN).
__device__ __forceinline__ long long warm_steps(float at, float rl,
                                                long long T) {
  const float c = fmaxf(at, rl);
  if (!(at >= 0.0f && rl >= 0.0f && c < 1.0f)) return T;
  const float w = ceilf(kWarmTau / (1.0f - c));
  if (!(w < (float)T)) return T;
  return ((long long)w + kLine - 1) / kLine * kLine;
}

// Pass 1: thread i = b * n_chunks + c owns samples [c * L, (c + 1) * L),
// L = kChunk.
__global__ void chunks_kernel(const float* __restrict__ x,
                              const float* __restrict__ cte_at,
                              const float* __restrict__ cte_rl,
                              const float* __restrict__ bounds,
                              float* __restrict__ out,
                              unsigned char* __restrict__ unresolved,
                              int rows, long long T, long long n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * n_chunks) return;
  const long long b = i / n_chunks;
  const long long s = (i % n_chunks) * kChunk;
  const long long e = s + kChunk < T ? s + kChunk : T;
  const float* xr = x + b * T;
  float* orow = out + b * T;
  const float at = cte_at[b], rl = cte_rl[b];

  long long from = s - warm_steps(at, rl, T);
  Bracket br{bounds[2 * b], bounds[2 * b + 1], at, rl};
  if (from <= 0) {  // the exact start: env[-1] = 0
    from = 0;
    br.lo = br.hi = 0.0f;
  }
  walk(xr, from, s, aligned16(xr + from), br);
  Follow f{br.hi, at, rl, orow};
  walk(xr, s, e, aligned16(xr + s) && aligned16(orow + s), f);
  unresolved[i] = same(br.lo, br.hi) ? 0 : 1;
}

// Pass 2: thread i = b * n_chunks + c repairs the run of unresolved chunks
// that starts at chunk c, if one does: chunk c - 1 is resolved, so its last
// value is exact, and each repaired chunk leaves its last value exact for
// the next. The runs of all rows are repaired in parallel. Chunk 0 always
// starts from the exact 0, so it is never unresolved.
__global__ void repair_kernel(const float* __restrict__ x,
                              const float* __restrict__ cte_at,
                              const float* __restrict__ cte_rl,
                              float* __restrict__ out,
                              const unsigned char* __restrict__ unresolved,
                              int rows, long long T, long long n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * n_chunks) return;
  const long long b = i / n_chunks;
  long long c = i % n_chunks;
  const unsigned char* u = unresolved + b * n_chunks;
  if (c == 0 || !u[c] || u[c - 1]) return;
  const float* xr = x + b * T;
  float* orow = out + b * T;
  const float at = cte_at[b], rl = cte_rl[b];
  for (; c < n_chunks && u[c]; ++c) {
    const long long s = c * kChunk;
    const long long e = s + kChunk < T ? s + kChunk : T;
    Repair r{orow[s - 1], at, rl, orow, false};
    walk(xr, s, e, aligned16(xr + s) && aligned16(orow + s), r);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. x and out are (rows, T) fp32,
// contiguous; cte_at and cte_rl are (rows,) fp32; all on the device. Each
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported.

// The split kernel: passes 0, 1 and 2. bounds is (rows, 2) fp32 scratch;
// unresolved is (rows, ceil(T / kChunk)) uint8 and says, after the call,
// which chunks pass 2 reran.
extern "C" int remfx_envelope(const float* x, const float* cte_at,
                              const float* cte_rl, float* out, float* bounds,
                              unsigned char* unresolved, int rows, long long T,
                              void* stream) {
  static_assert(kChunk > 0 && kChunk % kLine == 0, "chunks of whole lines");
  if (rows <= 0 || T <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_chunks = (T + kChunk - 1) / kChunk;
  const long long blocks = (rows * n_chunks + kThreads - 1) / kThreads;
  cudaError_t err;

  bounds_kernel<<<rows, kBoundsThreads, 0, st>>>(x, bounds, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  chunks_kernel<<<blocks, kThreads, 0, st>>>(x, cte_at, cte_rl, bounds, out,
                                             unresolved, rows, T, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  repair_kernel<<<blocks, kThreads, 0, st>>>(x, cte_at, cte_rl, out,
                                             unresolved, rows, T, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// The serial kernel: one thread per row, 128 threads a block. The split
// kernel is held to it bit for bit; the main path does not launch it.
extern "C" int remfx_envelope_serial(const float* x, const float* cte_at,
                                     const float* cte_rl, float* out, int rows,
                                     long long T, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  envelope_serial_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, cte_at, cte_rl, out, rows, T);
  return static_cast<int>(cudaGetLastError());
}
