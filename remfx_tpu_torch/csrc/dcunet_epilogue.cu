// The DCUNet's eval epilogue for Hopper, sm_90a: a block's complex norm as a
// per-channel 2 x 2 affine, the leaky ReLU, and the decoder's skip
// concatenation, in one pass over packed channels-last tensors.
//
// No TPU kernel: the JAX package leaves the norm, the activation and the
// concatenation to XLA (remfx_tpu/models/dcunet.py). The port ran them as
// torch ops on NCHW (re, im) pairs: two batch norms and two leaky ReLUs a
// block and two cats a decoder, each a pass over the block's output, while
// cuDNN transposed every convolution's input to NHWC and its output back.
// In eval the masker carries one tensor instead (models/dcunet.py): a pixel
// (row, frequency, frame) holds re_0 .. re_{C-1}, im_0 .. im_{C-1} and the
// zeros below, contiguous (torch.channels_last), which cuDNN convolves as it
// lies.
//
// Per pixel and complex channel c, with the norm's coefficients a (6, C):
//
//     yr = a[0][c] xr + a[1][c] xi + a[4][c]
//     yi = a[2][c] xr + a[3][c] xi + a[5][c]
//     out = y > 0 ? y : slope * y
//
// in fp32, rounded once to the input's type (bf16 or fp32). A batch norm on
// re and on im is the diagonal case; the complex whitening norm's running
// covariance and weight fill the whole 2 x 2 (ops/dcunet_epilogue.py).
// The output pixel holds the block's 2C values, then, in a decoder, the 2S
// values of the skip copied as they are (the concatenation that feeds the
// next transposed convolution), then zeros up to a multiple of 8 values:
// cuDNN's NHWC kernels read 16 bytes of channels at a time and pad any
// other count in a pass of their own. Pixels of x and of the skip may hold
// such zeros too, which are not read as values.
//
// Bound on this card: bytes. A few operations per element against 4 to 8
// bytes moved; the kernel reads the conv output and the skip once and
// writes the output once.
//
// Design: 256 threads a block; a block walks over tiles of `tile` pixels
// (a multiple of 8, so that every tile starts on 16 bytes). Per tile:
//   A  the tile's conv output and skip pixels, each one contiguous run in
//      memory, go to shared memory in 16-byte loads;
//   B  a thread per (pixel, complex channel) computes (yr, yi) from shared
//      memory into the output tile in shared memory, and the skip and the
//      zeros fill the rest in 4-byte words (an even count of 2- or 4-byte
//      values);
//   C  the output tile, one contiguous run, goes out in 16-byte stores.
// Shared memory keeps the 16-byte accesses apart from the channel mapping:
// C is odd (45) in Large-DCUNet-20, so the re and im halves of a pixel do
// not fall on 16-byte boundaries. Offsets into the tensors are 64-bit; where a pointer
// is not 16-byte aligned the runs are copied one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 64;              // pixels a tile holds at most
constexpr int kSmemTarget = 28 * 1024;    // shared memory a block aims for: 8 blocks an SM
constexpr int kSmemLimit = 48 * 1024;     // without the opt-in of larger blocks

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

// n elements from src to dst by the block's threads: 16 bytes at a time
// where kVec (both pointers 16-byte aligned), then the tail one by one.
template <typename T, bool kVec>
__device__ __forceinline__ void copy_run(T* __restrict__ dst,
                                         const T* __restrict__ src, int n) {
  int i = threadIdx.x;
  if constexpr (kVec) {
    constexpr int V = 16 / sizeof(T);
    const int packs = n / V;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int p = threadIdx.x; p < packs; p += kThreads) d[p] = s[p];
    i += packs * V;
  }
  for (; i < n; i += kThreads) dst[i] = src[i];
}

// Bytes of shared memory before the tiles: the coefficients, rounded up to
// 16.
__host__ __device__ __forceinline__ size_t coef_bytes(int C) {
  return (6 * C * sizeof(float) + 15) & ~static_cast<size_t>(15);
}

__device__ __forceinline__ float leaky(float y, float slope) {
  return y > 0.f ? y : y * slope;
}

// Where the values lie: a pixel of x holds xw values (re at [0, C), im at
// [C, 2C), the rest unread), a pixel of the skip sw values (the first s2
// copied), a pixel of the output ow values (2C, then s2, then zeros).
struct Geometry {
  long long pixels;
  int C, xw, s2, sw, ow;
  int tile;  // pixels a tile holds
};

// x (pixels, xw), skip (pixels, sw) or unused where s2 = 0, out (pixels,
// ow), coef (6, C) fp32.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    dcunet_epilogue(const T* __restrict__ x, const T* __restrict__ skip,
                    const float* __restrict__ coef, T* __restrict__ out,
                    Geometry g, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = g.C;
  float* a = reinterpret_cast<float*>(smem);             // 6 C coefficients
  T* xs = reinterpret_cast<T*>(smem + coef_bytes(C));  // tile x xw
  T* ss = xs + g.tile * g.xw;                           // tile x sw
  T* os = ss + g.tile * g.sw;                           // tile x ow
  for (int i = threadIdx.x; i < 6 * C; i += kThreads) a[i] = coef[i];

  // an output pixel's tail after its 2C values, in 4-byte words: tw words,
  // the first s2w from the skip (its pixels sww words apart), then zeros
  constexpr int kPerWord = 4 / sizeof(T);
  const int tw = (g.ow - 2 * C) / kPerWord, s2w = g.s2 / kPerWord;
  const int sww = g.sw / kPerWord, oww = g.ow / kPerWord, cw = 2 * C / kPerWord;
  const long long tiles = (g.pixels + g.tile - 1) / g.tile;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long pix0 = t * g.tile;
    const int np = static_cast<int>(min(static_cast<long long>(g.tile), g.pixels - pix0));
    copy_run<T, kVec>(xs, x + pix0 * g.xw, np * g.xw);
    if (g.s2 > 0) copy_run<T, kVec>(ss, skip + pix0 * g.sw, np * g.sw);
    __syncthreads();

    // item k = p C + c, walked with (p, c) kept up to date instead of divided
    {
      const int dp = kThreads / C, dc = kThreads - dp * C;
      int p = threadIdx.x / C, c = threadIdx.x - p * C;
      for (int k = threadIdx.x; k < np * C; k += kThreads) {
        const T* xp = xs + p * g.xw;
        const float xr = to_float(xp[c]), xi = to_float(xp[C + c]);
        const float yr = fmaf(a[C + c], xi, fmaf(a[c], xr, a[4 * C + c]));
        const float yi = fmaf(a[3 * C + c], xi, fmaf(a[2 * C + c], xr, a[5 * C + c]));
        T* op = os + p * g.ow;
        op[c] = from_float<T>(leaky(yr, slope));
        op[C + c] = from_float<T>(leaky(yi, slope));
        c += dc;
        p += dp;
        if (c >= C) {
          c -= C;
          ++p;
        }
      }
    }
    if (tw > 0) {  // word k = p tw + j of the tails
      const uint32_t* sv = reinterpret_cast<const uint32_t*>(ss);
      uint32_t* ov = reinterpret_cast<uint32_t*>(os);
      const int dp = kThreads / tw, dj = kThreads - dp * tw;
      int p = threadIdx.x / tw, j = threadIdx.x - p * tw;
      for (int k = threadIdx.x; k < np * tw; k += kThreads) {
        ov[p * oww + cw + j] = j < s2w ? sv[p * sww + j] : 0u;
        j += dj;
        p += dp;
        if (j >= tw) {
          j -= tw;
          ++p;
        }
      }
    }
    __syncthreads();

    copy_run<T, kVec>(out + pix0 * g.ow, os, np * g.ow);
    // the next tile's loads write xs and ss only, which no thread reads
    // past the barrier above; its barrier orders them before os is written
  }
}

// Pixels a tile holds: a multiple of 8 near kSmemTarget bytes of shared
// memory, at most kMaxTile; 0 where even 8 would not fit kSmemLimit.
int choose_tile(const Geometry& g, int elem, size_t* smem) {
  const size_t head = coef_bytes(g.C);
  const size_t per_pixel = static_cast<size_t>(g.xw + g.sw + g.ow) * elem;
  size_t tile = (kSmemTarget > head ? (kSmemTarget - head) / per_pixel : 0) / 8 * 8;
  tile = tile < 8 ? 8 : (tile > kMaxTile ? kMaxTile : tile);
  *smem = head + tile * per_pixel;
  return *smem <= kSmemLimit ? static_cast<int>(tile) : 0;
}

template <typename T, bool kVec>
int launch(const void* x, const void* skip, const float* coef, void* out,
           Geometry g, float slope, cudaStream_t st) {
  size_t smem = 0;
  g.tile = choose_tile(g, sizeof(T), &smem);
  if (g.tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (g.pixels + g.tile - 1) / g.tile;
  // enough blocks for every SM of the card several times over; each walks
  // over its tiles
  const long long blocks = tiles < 132 * 16 ? tiles : 132 * 16;
  dcunet_epilogue<T, kVec><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(skip), coef,
      static_cast<T*>(out), g, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (pixels, xw) and, where s2 > 0, skip (pixels, sw) of fp32 (bf16 = 0) or
// bf16 (bf16 = 1), contiguous; coef (6, C) fp32, contiguous; out (pixels,
// ow) of x's type: per pixel the block's 2C values, the skip's first s2,
// then zeros. xw >= 2C, sw >= s2, ow >= 2C + s2, and xw, s2, sw and ow even.
// vec = 1: x, skip and out are 16-byte aligned. Returns a CUDA error code,
// 0 on success.
extern "C" int remfx_dcunet_epilogue(const void* x, const void* skip,
                                     const void* coef, void* out, int bf16,
                                     int vec, long long pixels, int C, int xw,
                                     int s2, int sw, int ow, float slope,
                                     void* stream) {
  if (pixels <= 0) return 0;
  if (C <= 0 || xw < 2 * C || s2 < 0 || sw < s2 || ow < 2 * C + s2 ||
      ((xw | s2 | sw | ow) & 1) || (s2 > 0 && skip == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{pixels, C, xw, s2, sw, ow, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(coef);
  if (bf16) {
    return vec ? launch<__nv_bfloat16, true>(x, skip, a, out, g, slope, st)
               : launch<__nv_bfloat16, false>(x, skip, a, out, g, slope, st);
  }
  return vec ? launch<float, true>(x, skip, a, out, g, slope, st)
             : launch<float, false>(x, skip, a, out, g, slope, st);
}
