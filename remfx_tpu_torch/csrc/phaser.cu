// Phaser recurrence (six modulated first-order all-passes with feedback) for
// Hopper, sm_90a.
//
// No TPU kernel: it replaces the lax.scan over time with which the JAX
// package renders the phaser (remfx_tpu/fx/phaser.py:_render, the scan at
// :94); no PyTorch call computes this recurrence. Per row (example b,
// channel c) and sample t, with the coefficient a = a[b, t] computed
// beforehand in PyTorch (fx/phaser.py:coefficients):
//
//     u        = x[t] + feedback * last
//     y_s      = a * u_s + xs[s] - a * ys[s],   u_0 = u, u_{s+1} = y_s,
//                s = 0..5; then xs[s] = u_s, ys[s] = y_s, last = y_5
//     out[t]   = (1 - mix) * x[t] + mix * y_5
//
// The state. Of the 13 floats, 7 are independent: after a step ys[s] equals
// xs[s + 1] for s < 5 and last equals ys[5]. With v = (u_0, ..., u_6) of the
// previous sample (u_6 = y_5), a step is
//
//     u_0 = x + feedback * v_6,   u_{s+1} = a * u_s + (v_s - a * v_{s+1}),
//
// affine in v. So L samples map the state at a chunk's start, s, to
// Phi * s + p: Phi (7 x 7) is the chunk's response from the unit states with
// no input, p its response to its input from the zero state.
//
// Bound on this card. The bytes are few: at (8, 2, 262144) the kernel reads x
// and a and writes out, (2 * B * C * T + B * T) * 4 B = 41.9 MB, 0.0125 ms at
// 3.35 TB/s. A walk over time is bound by latency instead: the feedback
// closes the loop through all six stages, so a sample is a chain of dependent
// operations. Walked in one thread per row (the serial kernel below, which
// rounds as the plain version does: 20 dependent roundings a sample), a row
// takes T * 20 * 4 cycles, about 10.6 ms at T = 262144 and 1.98 GHz, on an
// almost empty card (16 threads at that shape).
//
// Design: split time into chunks of L = kChunk = 128 samples (below: which
// L and why), in groups of kWarp consecutive chunks of a row, one warp a
// group.
//
//   pass 1  phaser_maps, one thread per (row, chunk), all in parallel: the
//           chunk from the zero state with its input, beside the 7 unit
//           states with none: 8 independent chains that share a[t], which
//           fill the pipeline that one chain leaves empty. Then an
//           inclusive scan of the warp's 32 affine maps over shuffles
//           (Hillis-Steele, 5 rounds of 7 x 7 products), and each chunk's
//           prefix map, from its group's start to its own end, is stored.
//   pass 2  phaser_scan, one warp per row: the scan s_{g+1} = Phi_g s_g +
//           p_g over the row's groups from s_0 = 0, Phi_g, p_g the group's
//           whole map (its last chunk's prefix map), one row of each product
//           a lane; it stores each group's starting state.
//   pass 3  phaser_apply, one thread per (row, chunk): its exact starting
//           state, the group's start through the prefix map of the chunk
//           before it, then the chunk again, writing out.
//
// Each pass stages its warp's tiles of x and a (kTile samples of each of its
// 32 chunks) in shared memory: 16-byte loads where the row is aligned, so
// that a warp reads whole 128-byte lines, and the next tile loaded into
// registers while the current one runs; the output leaves the same way.
//
// What bounds the design. Its chains: with u_{s+1} = fma(a, u_s, w_s) and w_s
// off the chain, a sample is 7 dependent FMAs (28 cycles), about 2 * L * 28
// cycles for passes 1 and 3, plus the scan's T / (32 L) 7 x 7 products in
// pass 2; pass 1 also issues 8 chains' work, 13 FMAs each a sample. And its
// bytes, more than the problem's: x and a twice (passes 1 and 3, a once a
// row), the maps twice, out once, about 99 MB at (8, 2, 262144) with L = 128
// (0.029 ms at 3.35 TB/s) against 41.9 MB. On the H100, pass 3 runs at
// about the time of its bytes and pass 1 at about that of its bytes and its
// issue together (PERF.md §6). Shorter chunks give more warps but more maps
// to move and to scan; longer ones fewer warps a scheduler. A thread for a
// pair of channels, sharing the 7 unit-state chains (the channels share a),
// did half of pass 1's work and ran slower, on half the warps.
//
// Not bit for bit. The chunks' maps and their composition round in another
// order than the serial walk, and the kernel fuses products into FMAs, so
// the split kernel agrees with the serial kernel and with the plain version
// within a tolerance (ops/phaser.py: 1e-5 of the row's peak), not bitwise.
// The phaser has no monotone bracket like the envelope's (csrc/envelope.cu),
// and a warm-up from the zero state would need about 20 time constants a
// chunk, thousands of samples where the all-passes' poles sit near
// z = 0.997. The serial kernel stays as the bit-for-bit oracle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 6;

// ------------------------------------------------------------ the serial kernel

constexpr int kVec = 8;          // float4 loads per line
constexpr int kLine = 4 * kVec;  // 32 samples, 128 bytes
constexpr int kSerialThreads = 32;

struct State {
  float xs[kStages];
  float ys[kStages];
  float last;
};

// Every operation is an intrinsic that rounds to nearest (__fmul_rn,
// __fadd_rn, __fsub_rn), in the order of the plain PyTorch version
// (ops/phaser.py:phaser_plain), so nvcc contracts nothing into an FMA: each
// IEEE product or sum gives the same value here and on the CPU, and the
// serial kernel equals the plain version bit for bit.
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

// One thread per row, the 13 state floats in registers, walking T. Rows that
// are 16-byte aligned read x and a as float4, one 128-byte line at a time,
// with the next line loaded while the current one runs; other rows take a
// scalar path.
__global__ void phaser_serial_kernel(const float* __restrict__ x,
                                     const float* __restrict__ a,
                                     const float* __restrict__ feedback,
                                     const float* __restrict__ mix,
                                     float* __restrict__ out, int rows,
                                     int channels, long long T) {
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

// ------------------------------------------------------------- the split kernel

constexpr int kState = 7;                  // v = u_0..u_6
constexpr int kMap = kState * kState + kState;  // Phi row-major, then p: 56
constexpr int kMapPad = kMap + 1;          // shared-memory stride of a map
constexpr int kStart = 8;                  // floats a stored state (7 + pad)
constexpr int kWarp = 32;                  // chunks a group, lanes a warp
constexpr int kTile = 32;                  // samples a chunk staged at a time
// Samples a thread of passes 1 and 3 walks, chosen on the H100 among 32 to
// 1024 (PERF.md §6): a shorter chunk gives more warps, but pass 1 then spends
// more of its time in the warp's scan of the maps, and the maps' bytes grow
// as 1 / chunk; a longer one leaves each scheduler fewer warps (at
// (8, 1, 262144) and 256, about half a warp). 128 was the fastest at 8 x 1
// and at 8 x 2. Mirrored by ops/phaser.py:CHUNK.
constexpr int kChunk = 128;
constexpr int kPad = kTile + 1;            // shared-memory stride of a chunk
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWarp == kTile, "a lane moves one sample of every chunk");
static_assert(kChunk % kTile == 0, "a chunk is whole tiles");
static_assert(kMap % 4 == 0, "maps move as float4");
static_assert(kWarp * kMapPad <= 2 * kWarp * kPad, "a group's maps fit the tiles");

// One sample on the state v; returns u_6. The w_s are off the chain, so a
// sample is 7 dependent FMAs.
__device__ __forceinline__ float split_step(float (&v)[kState], float a,
                                            float fb, float x) {
  float u = fmaf(fb, v[kState - 1], x);
#pragma unroll
  for (int k = 0; k < kStages; ++k) {
    const float w = fmaf(-a, v[k + 1], v[k]);
    v[k] = u;
    u = fmaf(a, u, w);
  }
  v[kState - 1] = u;
  return u;
}

// A tile: samples [t0, t0 + kTile) of the kWarp chunks of a group of one row,
// in flight in registers (kTile floats a lane), then in shared memory as
// sm[chunk * kPad + sample], so that lane j reading sample i of its chunk
// j meets no bank conflict. `vec` (uniform over the warp: the row is 16-byte
// aligned and the tile lies inside it): lane l moves float4 (l & 7) of chunk
// 4 * i + (l >> 3), i < 8; otherwise sample t0 + l of chunk i, i < 32, zero
// past T. Either way a warp's access is whole 128-byte lines.
struct Tile {
  float v[kTile];

  __device__ __forceinline__ void load(const float* __restrict__ row,
                                       long long T, long long first,
                                       int t0, bool vec, int lane) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < kTile / 4; ++i) {
        const int j = 4 * i + (lane >> 3);
        const float4 q = *reinterpret_cast<const float4*>(
            row + first + (long long)j * kChunk + t0 + 4 * (lane & 7));
        v[4 * i] = q.x;
        v[4 * i + 1] = q.y;
        v[4 * i + 2] = q.z;
        v[4 * i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWarp; ++i) {
        const long long t = first + (long long)i * kChunk + t0 + lane;
        v[i] = t < T ? row[t] : 0.0f;
      }
    }
  }

  __device__ __forceinline__ void to_shared(float* sm, bool vec,
                                            int lane) const {
    if (vec) {
#pragma unroll
      for (int i = 0; i < kTile / 4; ++i) {
        float* d = sm + (4 * i + (lane >> 3)) * kPad + 4 * (lane & 7);
        d[0] = v[4 * i];
        d[1] = v[4 * i + 1];
        d[2] = v[4 * i + 2];
        d[3] = v[4 * i + 3];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWarp; ++i) sm[i * kPad + lane] = v[i];
    }
  }
};

// The output tile, from shared memory (as Tile lays it out) to the row.
__device__ __forceinline__ void store_tile(const float* sm,
                                           float* __restrict__ row, long long T,
                                           long long first, int t0,
                                           bool vec, int lane) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kTile / 4; ++i) {
      const int j = 4 * i + (lane >> 3);
      const float* s = sm + j * kPad + 4 * (lane & 7);
      *reinterpret_cast<float4*>(row + first + (long long)j * kChunk + t0 +
                                 4 * (lane & 7)) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWarp; ++i) {
      const long long t = first + (long long)i * kChunk + t0 + lane;
      if (t < T) row[t] = sm[i * kPad + lane];
    }
  }
}

// A group's 32 maps (kWarp * kMap floats, 16-byte aligned) between device
// memory and shared memory (a map kMapPad floats apart): float4 moves,
// neighbouring lanes on neighbouring addresses, all in flight at once.
__device__ __forceinline__ void maps_to_shared(const float* __restrict__ src,
                                               float* sm, int lane) {
  constexpr int kVecs = kWarp * kMap / 4 / kWarp;  // 14 float4 a lane
  float4 q[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    q[i] = reinterpret_cast<const float4*>(src)[i * kWarp + lane];
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int e = 4 * (i * kWarp + lane);
    float* d = sm + (e / kMap) * kMapPad + e % kMap;  // kMap % 4 == 0
    d[0] = q[i].x;
    d[1] = q[i].y;
    d[2] = q[i].z;
    d[3] = q[i].w;
  }
}

__device__ __forceinline__ void maps_from_shared(const float* sm,
                                                 float* __restrict__ dst,
                                                 int lane) {
  constexpr int kVecs = kWarp * kMap / 4 / kWarp;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int e = 4 * (i * kWarp + lane);
    const float* s = sm + (e / kMap) * kMapPad + e % kMap;
    reinterpret_cast<float4*>(dst)[i * kWarp + lane] =
        make_float4(s[0], s[1], s[2], s[3]);
  }
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Where a block's group lies: row r, group g, its first sample.
struct Group {
  long long r;
  long long g;
  int b;
  long long first;
};

__device__ __forceinline__ Group group_of(long long groups, int channels) {
  Group q;
  q.r = blockIdx.x / groups;
  q.g = blockIdx.x % groups;
  q.b = static_cast<int>(q.r / channels);
  q.first = q.g * kWarp * kChunk;
  return q;
}

// Pass 1. maps: (rows, groups, kWarp, kMap), each chunk's prefix map.
__global__ void __launch_bounds__(kWarp)
phaser_maps(const float* __restrict__ x, const float* __restrict__ a,
            const float* __restrict__ feedback, float* __restrict__ maps,
            int channels, long long T, long long groups) {
  __shared__ float smem[2 * kWarp * kPad];
  float* sx = smem;
  float* sa = smem + kWarp * kPad;
  const int lane = threadIdx.x;
  const Group q = group_of(groups, channels);
  const float* xr = x + q.r * T;
  const float* ar = a + (long long)q.b * T;
  const float fb = feedback[q.b];
  const bool x_al = aligned16(xr + (q.first < T ? q.first : 0));
  const bool a_al = aligned16(ar + (q.first < T ? q.first : 0));

  // chains 0..6 start at the unit states (Phi's columns), chain 7 at zero
  float v[kState + 1][kState];
#pragma unroll
  for (int c = 0; c <= kState; ++c) {
#pragma unroll
    for (int k = 0; k < kState; ++k) v[c][k] = c == k ? 1.0f : 0.0f;
  }

  Tile tx, ta;
  const auto inside = [&](int t0) {
    return q.first + (long long)(kWarp - 1) * kChunk + t0 + kTile <= T;
  };
  tx.load(xr, T, q.first, 0, x_al && inside(0), lane);
  ta.load(ar, T, q.first, 0, a_al && inside(0), lane);
  for (int t0 = 0; t0 < kChunk; t0 += kTile) {
    tx.to_shared(sx, x_al && inside(t0), lane);
    ta.to_shared(sa, a_al && inside(t0), lane);
    __syncthreads();
    const int t1 = t0 + kTile;
    if (t1 < kChunk) {
      tx.load(xr, T, q.first, t1, x_al && inside(t1), lane);
      ta.load(ar, T, q.first, t1, a_al && inside(t1), lane);
    }
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      const float xi = sx[lane * kPad + i];
      const float ai = sa[lane * kPad + i];
#pragma unroll
      for (int c = 0; c < kState; ++c) split_step(v[c], ai, fb, 0.0f);
      split_step(v[kState], ai, fb, xi);
    }
    __syncthreads();
  }

  // this chunk's map: A[i][j] = chain j's u_i, c = chain 7
  float A[kState][kState], c[kState];
#pragma unroll
  for (int i = 0; i < kState; ++i) {
#pragma unroll
    for (int j = 0; j < kState; ++j) A[i][j] = v[j][i];
    c[i] = v[kState][i];
  }
  // inclusive scan over the warp: (A, c) <- (A, c) o (lane - off's)
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    float nA[kState][kState], nc[kState], e[kState];
#pragma unroll
    for (int j = 0; j < kState; ++j) {
#pragma unroll
      for (int k = 0; k < kState; ++k) e[k] = __shfl_up_sync(kFull, A[k][j], off);
#pragma unroll
      for (int i = 0; i < kState; ++i) {
        float s = A[i][0] * e[0];
#pragma unroll
        for (int k = 1; k < kState; ++k) s = fmaf(A[i][k], e[k], s);
        nA[i][j] = s;
      }
    }
#pragma unroll
    for (int k = 0; k < kState; ++k) e[k] = __shfl_up_sync(kFull, c[k], off);
#pragma unroll
    for (int i = 0; i < kState; ++i) {
      float s = c[i];
#pragma unroll
      for (int k = 0; k < kState; ++k) s = fmaf(A[i][k], e[k], s);
      nc[i] = s;
    }
    if (lane >= off) {
#pragma unroll
      for (int i = 0; i < kState; ++i) {
#pragma unroll
        for (int j = 0; j < kState; ++j) A[i][j] = nA[i][j];
        c[i] = nc[i];
      }
    }
  }

  // out through shared memory, so that the warp writes whole lines
  float* sm = smem + lane * kMapPad;
#pragma unroll
  for (int i = 0; i < kState; ++i) {
#pragma unroll
    for (int j = 0; j < kState; ++j) sm[i * kState + j] = A[i][j];
    sm[kState * kState + i] = c[i];
  }
  __syncthreads();
  maps_from_shared(smem, maps + (q.r * groups + q.g) * (kWarp * kMap), lane);
}

// Pass 2. starts: (rows, groups, kStart), each group's starting state. One
// warp a row: the lanes fetch up to 32 groups' whole maps at once; then lane
// k < 7 holds s_k and forms row k of each product, the state passed between
// the lanes by shuffles, so that a group costs one chain of 7 FMAs.
__global__ void __launch_bounds__(kWarp)
phaser_scan(const float* __restrict__ maps, float* __restrict__ starts,
            long long groups) {
  __shared__ float sm[kWarp * kMapPad];
  __shared__ float ss[kWarp * kStart];
  const int lane = threadIdx.x;
  const int k = lane < kState ? lane : kState - 1;  // the row this lane forms
  const long long r = blockIdx.x;
  const float* mr = maps + r * groups * (kWarp * kMap);
  float* sr = starts + r * groups * kStart;
  float s = 0.0f;  // s_k
  for (long long g0 = 0; g0 < groups; g0 += kWarp) {
    const int n = static_cast<int>(groups - g0 < kWarp ? groups - g0 : kWarp);
    if (lane < n) {  // group g0 + lane's whole map: its last chunk's prefix map
      const float4* src = reinterpret_cast<const float4*>(
          mr + ((g0 + lane) * kWarp + kWarp - 1) * kMap);
      float4 q[kMap / 4];
#pragma unroll
      for (int i = 0; i < kMap / 4; ++i) q[i] = src[i];
#pragma unroll
      for (int i = 0; i < kMap / 4; ++i) {
        float* d = sm + lane * kMapPad + 4 * i;
        d[0] = q[i].x;
        d[1] = q[i].y;
        d[2] = q[i].z;
        d[3] = q[i].w;
      }
    }
    __syncwarp();
    for (int i = 0; i < n; ++i) {
      const float* m = sm + i * kMapPad;
      if (lane <= kState) ss[i * kStart + lane] = lane < kState ? s : 0.0f;
      float t = m[kState * kState + k];
#pragma unroll
      for (int j = 0; j < kState; ++j) {
        t = fmaf(m[k * kState + j], __shfl_sync(kFull, s, j), t);
      }
      s = t;
    }
    __syncwarp();
    for (int idx = lane; idx < n * kStart; idx += kWarp) {
      sr[g0 * kStart + idx] = ss[idx];
    }
    __syncwarp();
  }
}

// Pass 3. Each chunk from its exact start: out = (1 - mix) * x + mix * u_6.
__global__ void __launch_bounds__(kWarp)
phaser_apply(const float* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ feedback, const float* __restrict__ mix,
             const float* __restrict__ maps, const float* __restrict__ starts,
             float* __restrict__ out, int channels, long long T,
             long long groups) {
  __shared__ float smem[3 * kWarp * kPad];
  float* sx = smem;
  float* sa = smem + kWarp * kPad;
  float* so = smem + 2 * kWarp * kPad;
  const int lane = threadIdx.x;
  const Group q = group_of(groups, channels);
  const float* xr = x + q.r * T;
  const float* ar = a + (long long)q.b * T;
  float* orow = out + q.r * T;
  const float fb = feedback[q.b];
  const float m = mix[q.b];
  const float dry = 1.0f - m;
  const long long base = q.first < T ? q.first : 0;
  const bool x_al = aligned16(xr + base);
  const bool a_al = aligned16(ar + base);
  const bool o_al = aligned16(orow + base);

  // the start: the group's, through the prefix map of the chunk before
  maps_to_shared(maps + (q.r * groups + q.g) * (kWarp * kMap), smem, lane);
  __syncthreads();
  const float* sg = starts + (q.r * groups + q.g) * kStart;
  float v[kState];
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kState; ++k) v[k] = sg[k];
  } else {
    float s[kState];
#pragma unroll
    for (int k = 0; k < kState; ++k) s[k] = sg[k];
    const float* pm = smem + (lane - 1) * kMapPad;
#pragma unroll
    for (int k = 0; k < kState; ++k) {
      float t = pm[kState * kState + k];
#pragma unroll
      for (int j = 0; j < kState; ++j) t = fmaf(pm[k * kState + j], s[j], t);
      v[k] = t;
    }
  }
  __syncthreads();

  Tile tx, ta;
  const auto inside = [&](int t0) {
    return q.first + (long long)(kWarp - 1) * kChunk + t0 + kTile <= T;
  };
  tx.load(xr, T, q.first, 0, x_al && inside(0), lane);
  ta.load(ar, T, q.first, 0, a_al && inside(0), lane);
  for (int t0 = 0; t0 < kChunk; t0 += kTile) {
    tx.to_shared(sx, x_al && inside(t0), lane);
    ta.to_shared(sa, a_al && inside(t0), lane);
    __syncthreads();
    const int t1 = t0 + kTile;
    if (t1 < kChunk) {
      tx.load(xr, T, q.first, t1, x_al && inside(t1), lane);
      ta.load(ar, T, q.first, t1, a_al && inside(t1), lane);
    }
#pragma unroll 8
    for (int i = 0; i < kTile; ++i) {
      const float xi = sx[lane * kPad + i];
      const float u = split_step(v, sa[lane * kPad + i], fb, xi);
      so[lane * kPad + i] = fmaf(m, u, dry * xi);
    }
    __syncthreads();
    store_tile(so, orow, T, q.first, t0, o_al && inside(t0), lane);
  }
}

}  // namespace

// x and out are (batch, channels, T), a is (batch, T), feedback and mix are
// (batch,), all fp32 and contiguous; maps holds rows * groups * 32 * 56
// floats and starts rows * groups * 8 (rows = batch * channels, groups =
// ceil(ceil(T / 128) / 32)), scratch for the passes, both 16-byte aligned.
// Launches the three passes on `stream`, does not synchronise, and returns the first cudaGetLastError() that is not 0, so
// that a refused launch is reported.
extern "C" int remfx_phaser(const float* x, const float* a,
                            const float* feedback, const float* mix,
                            float* out, float* maps, float* starts, int batch,
                            int channels, long long T, void* stream) {
  if (batch <= 0 || channels <= 0 || T <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)batch * channels;
  const long long chunks = (T + kChunk - 1) / kChunk;
  const long long groups = (chunks + kWarp - 1) / kWarp;
  const long long blocks = rows * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;

  phaser_maps<<<static_cast<unsigned>(blocks), kWarp, 0, st>>>(
      x, a, feedback, maps, channels, T, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  phaser_scan<<<static_cast<unsigned>(rows), kWarp, 0, st>>>(maps, starts,
                                                             groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  phaser_apply<<<static_cast<unsigned>(blocks), kWarp, 0, st>>>(
      x, a, feedback, mix, maps, starts, out, channels, T, groups);
  return static_cast<int>(cudaGetLastError());
}

// The serial kernel: one thread per row, 32 threads a block, bit for bit the
// plain version. The split kernel is held to it within its tolerance; no
// path of the port launches it.
extern "C" int remfx_phaser_serial(const float* x, const float* a,
                                   const float* feedback, const float* mix,
                                   float* out, int batch, int channels,
                                   long long T, void* stream) {
  if (batch <= 0 || channels <= 0 || T <= 0) return 0;
  const int rows = batch * channels;
  const int blocks = (rows + kSerialThreads - 1) / kSerialThreads;
  phaser_serial_kernel<<<blocks, kSerialThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, a, feedback, mix, out, rows, channels, T);
  return static_cast<int>(cudaGetLastError());
}
