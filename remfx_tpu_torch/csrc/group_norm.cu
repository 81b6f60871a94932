// HDemucs's GroupNorm fused with the activation that follows it, for Hopper,
// sm_90a.
//
// No TPU kernel: the JAX package leaves GroupNorm to XLA
// (remfx_tpu/models/demucs.py), and so did the port, through torch's
// nn.GroupNorm. That kernel gives each (row, group) one block: on the time
// branch of HDemucs at 24 rows, GroupNorm(1, .) over up to 96 x 65536
// elements a row is 24 blocks on 132 SMs, and its moments took about 25 ms a
// call of the model where the bytes take 0.4 ms. Its output then went to
// memory and came back for the GELU or the GLU, and for the LayerScale and
// the residual add of HDemucs's DConv.
//
// Per row n of x (N, C, S...), group g of G over C / G channels, and channel c:
//
//     y = (x - mean[n, g]) * rstd[n, g] * gamma[c] + beta[c]
//     rstd = 1 / sqrt(var + eps), var the biased variance of the group
//
// then one epilogue: GELU (exact erf); GLU over the channel halves,
// y[c] * sigmoid(y[c + C/2]) for c < C/2; or GLU, LayerScale and the
// residual add, res[c] + scale[c] * glu[c]. Everything is computed in fp32
// and rounded once to the input's type (bf16 or fp32).
//
// Bound on this card: bytes. Per element a few operations (an erf or an exp
// at most) against 2 to 4 bytes moved; the kernel reads x twice (the
// second read partly from L2) and writes the output once.
//
// Design: two kernels a call, 256 threads a block, 16-byte loads (a "pack"
// of 8 bf16 or 4 fp32) where the rows allow it, one element at a time where
// they do not (S not a multiple of the pack, or an unaligned pointer).
//
//   pass 1  gn_moments: each (row, group) is cut into `chunks` equal runs of
//           packs, one block each; the wrapper (ops/group_norm.py:chunks)
//           chooses their number from the shape alone: enough blocks to
//           fill the card several times over, none so short that a thread
//           reads fewer than kMinPacks packs. The time branch's few large
//           groups are split; the frequency branch's many small ones take
//           one block each. A thread sums its elements' differences from
//           its first element and their squares, the threads' moments
//           merge in a fixed tree (Chan's formulas), and the block writes
//           the chunk's (mean, M2) in fp32 to a scratch tensor.
//   pass 2  gn_apply: a block of a row first merges the chunks' moments of
//           each of the row's groups, in a fixed order (lane j the chunks
//           j, j + 32, ... in turn, then the lanes in a tree), then
//           normalises kTile packs of the output with the epilogue. The
//           first block of each row also writes the row's (mean, rstd) a
//           group, where the caller asks for them: the backward pass under
//           autograd (ops/group_norm.py) reads them instead of a second
//           statistics pass.
//
// No atomics anywhere: the partial moments combine in the same order every
// call, so a result repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // packs a thread loads before it uses them
constexpr int kTile = kThreads * kUnroll;  // output packs a block of pass 2 writes
constexpr int kMinPacks = 4;               // packs a thread of pass 1 reads at least
constexpr float kSqrtHalf = 0.70710678118654752440f;
// kMinPacks is read by the wrapper's chunking (ops/group_norm.py:MIN_PACKS),
// which passes the kernel the number of chunks
static_assert(kMinPacks > 0 && kThreads % 32 == 0, "whole warps, non-empty chunks");

enum Act : int { kGelu = 0, kGlu = 1, kGluRes = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements as stored: one 16-byte access where V * sizeof(T)
// is 16, else V accesses of one element (V = 1). They stay in the input's
// type in registers until used.
template <typename T, int V>
struct alignas(V * sizeof(T) == 16 ? 16 : alignof(T)) Pack {
  T e[V];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(e) = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = p[i];
    }
  }

  __device__ __forceinline__ float at(int i) const { return to_float(e[i]); }

  __device__ __forceinline__ void store(T* p) const {
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = e[i];
    }
  }
};

// Count, mean and sum of squared deviations of a set of elements.
struct Moments {
  float n, mean, m2;
};

// Chan, Golub and LeVeque's merge of two disjoint sets.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float w = b.n / n;
  const float d = b.mean - a.mean;
  return {n, fmaf(d, w, a.mean), a.m2 + b.m2 + d * d * a.n * w};
}

__device__ __forceinline__ Moments shfl_down(Moments m, int off) {
  return {__shfl_down_sync(0xffffffffu, m.n, off),
          __shfl_down_sync(0xffffffffu, m.mean, off),
          __shfl_down_sync(0xffffffffu, m.m2, off)};
}

// The warp's moments, in a fixed tree, at lane 0.
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = merge(m, shfl_down(m, off));
  return m;
}

// Pass 1: the moments of chunk k of group r (r = row * G + g), the packs
// [k * chunk, min((k + 1) * chunk, packs)) of the group's `packs`.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gn_moments(const T* __restrict__ x, float2* __restrict__ part,
               long long packs, long long chunk, int chunks) {
  __shared__ Moments warps[kWarps];
  const long long r = blockIdx.x / chunks;
  const long long k = blockIdx.x - r * chunks;
  const T* g = x + r * packs * V;
  const long long end = min((k + 1) * chunk, packs);
  long long p = k * chunk + threadIdx.x;

  float shift = 0.f, s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (p < end) shift = to_float(g[p * V]);
  long long count = 0;
  for (; p + (kUnroll - 1) * kThreads < end; p += kUnroll * kThreads) {
    Pack<T, V> pk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) pk[u].load(g + (p + u * kThreads) * V);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = pk[u].at(i) - shift;
        s[i] += d;
        q[i] = fmaf(d, d, q[i]);
      }
    }
    count += kUnroll;
  }
  for (; p < end; p += kThreads) {
    Pack<T, V> pk;
    pk.load(g + p * V);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = pk.at(i) - shift;
      s[i] += d;
      q[i] = fmaf(d, d, q[i]);
    }
    ++count;
  }

  Moments m{0.f, 0.f, 0.f};
  if (count > 0) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sum += s[i];
      sq += q[i];
    }
    const float n = static_cast<float>(count * V);
    const float d = sum / n;
    m = {n, shift + d, fmaxf(sq - sum * d, 0.f)};
  }
  m = warp_merge(m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warps[lane] : Moments{0.f, 0.f, 0.f};
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) m = merge(m, shfl_down(m, off));
    if (lane == 0) part[blockIdx.x] = make_float2(m.mean, m.m2);
  }
}

// Pass 2: output packs [tile * kTile, (tile + 1) * kTile) of row `row`,
// out_packs = out_channels * S / V of them a row. `channels` and `groups`
// are the input's; the GLU epilogues read channels c and c + channels / 2.
// stats, where not null, gets (mean, rstd) of each (row, group) from the
// row's first block.
template <typename T, int V, int kAct>
__global__ void __launch_bounds__(kThreads)
    gn_apply(const T* __restrict__ x, const float2* __restrict__ part,
             const T* __restrict__ gamma, const T* __restrict__ beta,
             const T* __restrict__ res, const T* __restrict__ scale,
             T* __restrict__ out, float2* __restrict__ stats_out, int groups,
             int channels, int S,
             long long packs, long long chunk, int chunks, int tiles,
             float eps) {
  constexpr bool kGlus = kAct == kGlu || kAct == kGluRes;
  extern __shared__ float stats[];  // mean[groups], rstd[groups]
  float* mean_s = stats;
  float* rstd_s = stats + groups;
  const long long row = blockIdx.x / tiles;
  const long long tile = blockIdx.x - row * tiles;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < groups; g += kWarps) {
    const float2* pg = part + (row * groups + g) * chunks;
    Moments m{0.f, 0.f, 0.f};
    for (int k = lane; k < chunks; k += 32) {
      const long long first = k * chunk;
      const long long n = max(min(first + chunk, packs) - first, 0LL) * V;
      const float2 v = pg[k];
      m = merge(m, Moments{static_cast<float>(n), v.x, v.y});
    }
    m = warp_merge(m);
    if (lane == 0) {
      const float rstd = rsqrtf(m.m2 / m.n + eps);
      mean_s[g] = m.mean;
      rstd_s[g] = rstd;
      if (stats_out != nullptr && tile == 0)
        stats_out[row * groups + g] = make_float2(m.mean, rstd);
    }
  }
  __syncthreads();

  const int out_channels = kGlus ? channels / 2 : channels;
  const int per_group = channels / groups;
  const int out_packs = out_channels * (S / V);
  const T* xr = x + row * channels * static_cast<long long>(S);
  const T* xb = xr + out_channels * static_cast<long long>(S);  // the GLU's gate half
  const long long out_row = row * out_channels * static_cast<long long>(S);
  const int first = static_cast<int>(tile) * kTile + threadIdx.x;

  Pack<T, V> a[kUnroll], b[kUnroll], r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = first + u * kThreads;
    if (p < out_packs) {
      a[u].load(xr + p * V);
      if constexpr (kGlus) b[u].load(xb + p * V);
      if constexpr (kAct == kGluRes) r[u].load(res + out_row + p * V);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = first + u * kThreads;
    if (p >= out_packs) continue;
    const int c = (p * V) / S;  // a pack lies in one channel: S % V == 0
    const int ga = c / per_group;
    const float ma = mean_s[ga];
    const float sa = rstd_s[ga] * to_float(gamma[c]);
    const float ba = to_float(beta[c]);
    float mb = 0.f, sb = 0.f, bb = 0.f, ls = 0.f;
    if constexpr (kGlus) {
      const int cb = c + out_channels;
      const int gb = cb / per_group;
      mb = mean_s[gb];
      sb = rstd_s[gb] * to_float(gamma[cb]);
      bb = to_float(beta[cb]);
    }
    if constexpr (kAct == kGluRes) ls = to_float(scale[c]);
    Pack<T, V> o;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float y = fmaf(a[u].at(i) - ma, sa, ba);
      if constexpr (kAct == kGelu) y = 0.5f * y * (1.f + erff(y * kSqrtHalf));
      if constexpr (kGlus) {
        const float z = fmaf(b[u].at(i) - mb, sb, bb);
        y = y * (1.f / (1.f + expf(-z)));
      }
      if constexpr (kAct == kGluRes) y = fmaf(ls, y, r[u].at(i));
      o.e[i] = from_float<T>(y);
    }
    o.store(out + out_row + p * V);
  }
}

template <typename T, int V, int kAct>
cudaError_t apply(const void* x, const float2* part, const void* gamma,
                  const void* beta, const void* res, const void* scale,
                  void* out, float2* stats, unsigned blocks, size_t smem,
                  cudaStream_t st, int groups, int channels, int S,
                  long long packs, long long chunk, int chunks, int tiles,
                  float eps) {
  gn_apply<T, V, kAct><<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(x), part, static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<const T*>(res),
      static_cast<const T*>(scale), static_cast<T*>(out), stats, groups,
      channels, S, packs, chunk, chunks, tiles, eps);
  return cudaGetLastError();
}

template <typename T, int V>
int launch(const void* x, const void* gamma, const void* beta, const void* res,
           const void* scale, void* out, float2* part, float2* stats, int act,
           long long rows, int groups, int channels, int S, int chunks,
           float eps, cudaStream_t st) {
  const long long packs = static_cast<long long>(channels / groups) * (S / V);
  const long long chunk = (packs + chunks - 1) / chunks;
  const int out_channels = act >= kGlu ? channels / 2 : channels;
  const long long out_packs = static_cast<long long>(out_channels) * (S / V);
  const long long tiles = (out_packs + kTile - 1) / kTile;
  const long long moment_blocks = rows * groups * chunks;
  const long long apply_blocks = rows * tiles;
  if (moment_blocks > 0x7fffffffLL || apply_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  gn_moments<T, V><<<static_cast<unsigned>(moment_blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), part, packs, chunk, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const unsigned blocks = static_cast<unsigned>(apply_blocks);
  const size_t smem = 2 * groups * sizeof(float);
  const int t = static_cast<int>(tiles);
  switch (act) {
    case kGelu:
      err = apply<T, V, kGelu>(x, part, gamma, beta, res, scale, out, stats,
                               blocks, smem, st, groups, channels, S, packs,
                               chunk, chunks, t, eps);
      break;
    case kGlu:
      err = apply<T, V, kGlu>(x, part, gamma, beta, res, scale, out, stats,
                              blocks, smem, st, groups, channels, S, packs,
                              chunk, chunks, t, eps);
      break;
    case kGluRes:
      err = apply<T, V, kGluRes>(x, part, gamma, beta, res, scale, out, stats,
                                 blocks, smem, st, groups, channels, S, packs,
                                 chunk, chunks, t, eps);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// x (rows, channels, S) of fp32 (bf16 = 0) or bf16 (bf16 = 1), contiguous;
// gamma, beta (channels,); for act 2 (GLU, LayerScale, residual) res
// (rows, channels / 2, S) and scale (channels / 2,), else unused; out
// (rows, channels or channels / 2, S); part rows * groups * chunks float2 of
// scratch; stats null, or rows * groups float2 that get each group's
// (mean, rstd). vec = 1: S is a multiple of the pack (16 bytes) and x, res
// and out are 16-byte aligned. act: 0 GELU, 1 GLU, 2 GLU + LayerScale +
// residual. Returns a CUDA error code, 0 on success.
extern "C" int remfx_group_norm(const void* x, const void* gamma,
                                const void* beta, const void* res,
                                const void* scale, void* out, void* part,
                                void* stats, int bf16, int vec, int act,
                                long long rows, int groups, int channels,
                                int S, int chunks, float eps, void* stream) {
  if (rows <= 0 || S <= 0) return 0;
  if (groups <= 0 || channels % groups != 0 || chunks <= 0 || act < kGelu ||
      act > kGluRes || (act >= kGlu && channels % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* p = static_cast<float2*>(part);
  float2* m = static_cast<float2*>(stats);
  if (bf16) {
    return vec ? launch<__nv_bfloat16, 8>(x, gamma, beta, res, scale, out, p,
                                          m, act, rows, groups, channels, S,
                                          chunks, eps, st)
               : launch<__nv_bfloat16, 1>(x, gamma, beta, res, scale, out, p,
                                          m, act, rows, groups, channels, S,
                                          chunks, eps, st);
  }
  return vec ? launch<float, 4>(x, gamma, beta, res, scale, out, p, m, act,
                                rows, groups, channels, S, chunks, eps, st)
             : launch<float, 1>(x, gamma, beta, res, scale, out, p, m, act,
                                rows, groups, channels, S, chunks, eps, st);
}
