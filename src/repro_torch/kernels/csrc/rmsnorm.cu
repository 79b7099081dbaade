// RMSNorm over the trailing axis, forward and backward.  The forward is
// the port's twin of the TPU kernel
// src/repro/kernels/rmsnorm.py:rmsnorm_tpu (_kernel); the backward
// (rmsnorm_bwd_launch, at the end of this file) is the hand-written
// counterpart of the reference model's custom VJP
// src/repro/models/layers.py:_rms_bwd.
//
//   m = 1 / sqrt(mean(f32(x)^2) + eps)
//   y = cast(f32(x) * m * f32(w))                   (round_scale = 0)
//   y = cast(f32(x) * f32(cast(m * f32(w))))         (round_scale = 1)
//
// The first form is the TPU kernel's, one rounding.  The second is the
// reference model's bf16 norm (src/repro/models/layers.py:_rms_fwd),
// which rounds the scale m·w to x's dtype before the product; the product
// of two bf16 values is exact in f32, so one more rounding reproduces it.
// In float32 the two forms are the same function.  The gain w is f32.
//
// Bound on the H100: bytes.  The function reads x once and writes y once
// (w is shared by all rows and stays in L2), with 3 f32 operations per
// element, so the kernel only has to put every byte of x in flight at
// once and read it one time.  The design:
// * 16-byte loads and stores (8 bf16 or 4 f32 values a lane);
// * each row held in registers between the sum of squares and the
//   scaling, so x is read from device memory once;
// * threads per row chosen by the launcher from D and the row count:
//   with many rows one warp per row; with few rows (a decode step's 4)
//   up to 8 warps per row, combined through shared memory, so that each
//   thread issues about one load and the launch is all the time it takes;
// * a scalar two-pass path in the same kernel (NV = 0) for a D that is
//   not a multiple of the vector width, a pointer that is not 16-byte
//   aligned, or a row too long to hold in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps per block
constexpr int WARPS = THREADS / 32;
constexpr int NV_MAX = 16;    // 16-byte vectors a thread holds at most
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// y = x·m·w, or in bf16 x·cast(m·w) (see the header; float32 has one form)
template <typename T>
__device__ __forceinline__ float scaled(float x, float m, float w,
                                        int round_scale) {
  if constexpr (sizeof(T) == 2) {
    if (round_scale) return x * to_f(from_f<T>(m * w));
  }
  return x * m * w;
}

__device__ __forceinline__ uint32_t word(const uint4& u, int j) {
  return j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w;
}

// element e of a 16-byte vector, widened to f32 (exact)
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& u, int e) {
  return __uint_as_float(word(u, e));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int e) {
  const uint32_t w = word(u, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The gains of vector i: VEC f32 values, as float4s.
template <typename T>
struct Gain {
  static constexpr int VEC = 16 / sizeof(T);
  float v[VEC];
  __device__ __forceinline__ void load(const float* __restrict__ w, int i) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 g = __ldg(reinterpret_cast<const float4*>(w) + i * (VEC / 4) + q);
      v[4 * q] = g.x; v[4 * q + 1] = g.y; v[4 * q + 2] = g.z; v[4 * q + 3] = g.w;
    }
  }
};

// One 16-byte vector of y from a vector of x, its gains and m.
template <typename T>
__device__ __forceinline__ uint4 scale_vec(const uint4& u, const Gain<T>& g,
                                           float m, int round_scale) {
  constexpr int VEC = 16 / sizeof(T);
  float f[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    f[e] = scaled<T>(elem<T>(u, e), m, g.v[e], round_scale);
  uint4 r;
  if constexpr (VEC == 4) {
    r.x = bits(f[0]); r.y = bits(f[1]); r.z = bits(f[2]); r.w = bits(f[3]);
  } else {
    r.x = bits2(from_f<T>(f[0]), from_f<T>(f[1]));
    r.y = bits2(from_f<T>(f[2]), from_f<T>(f[3]));
    r.z = bits2(from_f<T>(f[4]), from_f<T>(f[5]));
    r.w = bits2(from_f<T>(f[6]), from_f<T>(f[7]));
  }
  return r;
}

// Rows of x (rows, D); `wpr` warps per row (1, 2, 4 or 8), WARPS / wpr
// rows per block.  NV > 0: each thread holds NV 16-byte vectors of its
// row (vector i of the row goes to thread i % (32·wpr)); NV = 0: the
// scalar two-pass path.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, float* __restrict__ mout, long long rows,
               int D, int wpr, float eps, int round_scale) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float part[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row =
      static_cast<long long>(blockIdx.x) * (WARPS / wpr) + warp / wpr;
  const int t = (warp % wpr) * 32 + lane;  // thread within the row
  const int tpr = 32 * wpr;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * static_cast<long long>(D);
  T* yr = y + (live ? row : 0) * static_cast<long long>(D);

  float ss = 0.f;
  uint4 v[NV > 0 ? NV : 1];
  if constexpr (NV > 0) {
    const int nvec = D / VEC;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = t + k * tpr;
      v[k] = live && i < nvec ? __ldg(xv + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = elem<T>(v[k], e);
        ss = fmaf(f, f, ss);
      }
  } else {
    if (live)
      for (int i = t; i < D; i += tpr) {
        const float f = to_f(xr[i]);
        ss = fmaf(f, f, ss);
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
  if (wpr > 1) {  // block-uniform
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    const int w0 = (warp / wpr) * wpr;
    ss = 0.f;
    for (int j = 0; j < wpr; ++j) ss += part[w0 + j];
  }
  if (!live) return;
  const float m = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
  if (mout != nullptr && t == 0) mout[row] = m;  // for the backward

  if constexpr (NV > 0) {
    const int nvec = D / VEC;
    uint4* yv = reinterpret_cast<uint4*>(yr);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = t + k * tpr;
      if (i < nvec) {
        Gain<T> g;
        g.load(w, i);
        yv[i] = scale_vec<T>(v[k], g, m, round_scale);
      }
    }
  } else {
    for (int i = t; i < D; i += tpr)
      yr[i] = from_f<T>(scaled<T>(to_f(xr[i]), m, w[i], round_scale));
  }
}

template <typename T, int NV>
cudaError_t go(const void* x, const void* w, void* y, float* mout,
               long long rows, int D, int wpr, float eps, int round_scale,
               cudaStream_t s) {
  const long long per = WARPS / wpr;
  const long long blocks = (rows + per - 1) / per;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, NV><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), mout, rows, D, wpr, eps, round_scale);
  return cudaGetLastError();
}

// Choose warps per row and vectors per thread, then launch.
template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, float* mout,
                   long long rows, int D, float eps, int round_scale,
                   cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(y)) & 15) == 0 && D % VEC == 0;
  const int nvec = (D + VEC - 1) / VEC;
  // spread few rows over more warps (about 16 warps per SM of the card's
  // 132 in all: at (2048, 896) bf16 two warps per row, 2 vectors a lane,
  // measured faster than one or four), never giving a warp nothing to load
  const long long target = 132LL * 16;
  int wpr = 1;
  while (wpr < WARPS && rows * wpr < target && 32 * wpr < nvec) wpr *= 2;
  int nv = (nvec + 32 * wpr - 1) / (32 * wpr);
  while (wpr < WARPS && nv > NV_MAX) {
    wpr *= 2;
    nv = (nvec + 32 * wpr - 1) / (32 * wpr);
  }
  if (!aligned || nv > NV_MAX)
    return go<T, 0>(x, w, y, mout, rows, D, wpr, eps, round_scale, s);
  if (nv <= 1) return go<T, 1>(x, w, y, mout, rows, D, wpr, eps, round_scale, s);
  if (nv <= 2) return go<T, 2>(x, w, y, mout, rows, D, wpr, eps, round_scale, s);
  if (nv <= 4) return go<T, 4>(x, w, y, mout, rows, D, wpr, eps, round_scale, s);
  if (nv <= 8) return go<T, 8>(x, w, y, mout, rows, D, wpr, eps, round_scale, s);
  return go<T, 16>(x, w, y, mout, rows, D, wpr, eps, round_scale, s);
}

}  // namespace

// x, y: (rows, D) contiguous, dtype 0 = float32, 1 = bfloat16; w: (D,)
// float32; round_scale: 0 the TPU kernel's form, 1 the reference model's
// (see the header); m: a float32 (rows,) buffer for each row's m (the
// backward's residual, as _rms_fwd saves it), or null.  Returns a
// cudaError_t (0 on success).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, void* m,
                              long long rows, int D, int dtype, float eps,
                              int round_scale, int device, void* stream) {
  if (rows < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, w, y, static_cast<float*>(m),
                                          rows, D, eps, round_scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        x, w, y, static_cast<float*>(m), rows, D, eps, round_scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

// ====================================================================== //
// Backward (the reference model's _rms_bwd, round_scale form)             //
// ====================================================================== //
//
// The hand-written counterpart of the reference model's custom VJP
// src/repro/models/layers.py:_rms_bwd (:58).  With the forward's m (its
// residual, as _rms_fwd saves it) and gs = f32(g)·w:
//   inner = Σ_j f32(cast(gs_j))·f32(x_j)            (f32)
//   coeff = (m·m·m / D)·inner                        (f32)
//   dx    = cast(m·gs) − cast(cast(coeff)·x)         (bf16: each op rounds)
//   dx    = m·gs − coeff·x                           (float32)
//   dw    = Σ_rows f32(cast(f32(g)·m))·f32(x)        (f32)
// with every rounding of _rms_bwd (the products of two bf16 values are
// exact in f32); only the order of the f32 sums (inner, dw) differs from
// the plain version.
//
// Bound on the H100: bytes.  It reads x and g once and writes dx once (w,
// m and dw are small): 5.52 MB at the training shape (1024, 896) bf16,
// 0.0016 ms at 3.35 TB/s.  So each row is read from device memory once,
// and the loads of every row are in flight together:
// * bwd_rows_kernel, the forward's layout: 8 warps a block; as many warps
//   per row as keep about BWD_FILL warps busy on each SM (at the training
//   shape 4 warps per row, one 16-byte vector a lane: measured faster
//   than 1 or 2), more for a row longer than a warp's registers hold;
//   each thread holds NV 16-byte vectors of x and g of its row, and the
//   gains of its columns, in registers; the inner sum by shuffles and,
//   when a row spans warps, shared memory; dx from the registers;
// * dw: each thread keeps f32 sums for the columns it owns over every row
//   its row group visits (rows per group chosen so that at most `cap`
//   blocks run; while a thread holds few elements, a row's loads are
//   issued while the row before it is worked); the block adds its
//   groups' sums in order, through shared memory, into partial[block];
// * a scalar path in the same kernel (VECT = false) for a D that is not a
//   multiple of the vector width or a pointer that is not 16-byte
//   aligned: the same, one element per unit;
// * bwd_cols_kernel: dw[c] = Σ_block partial[block][c], each of 32 warps
//   summing every 32nd block in order (its loads all in flight at once),
//   then the 32 sums in order.  A fold of the partials by the row pass's
//   last blocks, in the same launch, was measured slower than this
//   second launch.
// No atomics: two runs give the same bits.

constexpr int BWD_FILL = 16;        // busy warps per SM the launcher aims for
constexpr int BWD_VEC_CAP = 8;      // 16-byte vectors a thread holds at most
constexpr int BWD_SCALAR_CAP = 48;  // scalar elements a thread holds at most

// x[k][e], unit k's element e, as f32
template <typename T, bool VECT>
struct Units;
template <typename T>
struct Units<T, true> {
  static constexpr int E = 16 / sizeof(T);
  template <int NV>
  struct Held {
    uint4 v[NV];
    __device__ __forceinline__ void load(const T* row, int t, int tpr,
                                         int units, bool live) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = t + k * tpr;
        v[k] = live && i < units ? __ldg(reinterpret_cast<const uint4*>(row) + i)
                                 : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __device__ __forceinline__ float at(int k, int e) const {
      return elem<T>(v[k], e);
    }
  };
};
template <typename T>
struct Units<T, false> {
  static constexpr int E = 1;
  template <int NV>
  struct Held {
    float v[NV];
    __device__ __forceinline__ void load(const T* row, int t, int tpr,
                                         int units, bool live) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = t + k * tpr;
        v[k] = live && i < units ? to_f(row[i]) : 0.f;
      }
    }
    __device__ __forceinline__ float at(int k, int) const { return v[k]; }
  };
};

// dx of one element: x, gs = g·w, the row's m and coeff
template <typename T>
__device__ __forceinline__ float dx_elem(float xv, float gs, float m,
                                         float coeff) {
  if constexpr (sizeof(T) == 2) {
    const float a = to_f(from_f<T>(m * gs));
    const float b = to_f(from_f<T>(to_f(from_f<T>(coeff)) * xv));
    return a - b;
  } else {
    return m * gs - coeff * xv;
  }
}

// Rows of x, g (rows, D); `wpr` warps per row (1, 2, 4 or 8), WARPS / wpr
// row groups a block, each visiting `rpg` rows; each thread holds NV
// units (16-byte vectors if VECT, else elements) of its row: unit i of
// the row goes to thread i % (32·wpr).
template <typename T, int NV, bool VECT>
__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const T* __restrict__ g, const float* __restrict__ mrow,
                T* __restrict__ dx, float* __restrict__ partial,
                long long rows, int D, int wpr, int rpg) {
  using U = Units<T, VECT>;
  using Held = typename U::template Held<NV>;
  constexpr int E = U::E;
  __shared__ float part[2][WARPS];
  extern __shared__ float4 red4[];  // [groups][D]: each group's dw sums
  float* red = reinterpret_cast<float*>(red4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = WARPS / wpr, grp = warp / wpr;
  const int t = (warp % wpr) * 32 + lane, tpr = 32 * wpr;
  const int units = D / E;

  // the dw sums of my columns, and (vector path) their gains; the
  // scalar path reads its gains from L1 instead, to stay within registers
  float acc[NV * E], wv[VECT ? NV * E : 1];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = t + k * tpr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k * E + e] = 0.f;
    if constexpr (VECT) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const float4 v = i < units
            ? __ldg(reinterpret_cast<const float4*>(w) + i * (E / 4) + q)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        wv[k * E + 4 * q] = v.x; wv[k * E + 4 * q + 1] = v.y;
        wv[k * E + 4 * q + 2] = v.z; wv[k * E + 4 * q + 3] = v.w;
      }
    }
  }
  auto gain = [&](int k, int e) -> float {
    if constexpr (VECT) return wv[k * E + e];
    const int i = t + k * tpr;
    return i < units ? __ldg(w + i) : 0.f;
  };

  // round n's row; with PREFETCH its loads are issued one round ahead
  const long long r0 = static_cast<long long>(blockIdx.x) * groups * rpg;
  auto row = [&](int n) { return r0 + static_cast<long long>(n) * groups + grp; };
  auto fetch = [&](int n, Held& xh, Held& gh, float& mh) {
    const long long r = row(n);
    const bool live = r < rows;
    const long long base = (live ? r : 0) * static_cast<long long>(D);
    xh.load(x + base, t, tpr, units, live);
    gh.load(g + base, t, tpr, units, live);
    mh = live ? mrow[r] : 0.f;
  };
  // a second row in flight only while a thread holds at most 32 elements
  // of one (more would spill)
  constexpr bool PREFETCH = NV * E <= 32;
  Held xv, gv, xn, gn;
  float m, mn = 0.f;
  fetch(0, xv, gv, m);
  for (int n = 0; n < rpg; ++n) {
    if (PREFETCH && n + 1 < rpg) fetch(n + 1, xn, gn, mn);
    const long long r = row(n);
    const bool live = r < rows;
    const long long base = (live ? r : 0) * static_cast<long long>(D);

    float inner = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e)
        inner += to_f(from_f<T>(gv.at(k, e) * gain(k, e))) * xv.at(k, e);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) inner += __shfl_xor_sync(FULL, inner, o);
    if (wpr > 1) {  // block-uniform; part alternates between rounds
      if (lane == 0) part[n & 1][warp] = inner;
      __syncthreads();
      inner = 0.f;
      for (int j = 0; j < wpr; ++j) inner += part[n & 1][grp * wpr + j];
    }
    const float coeff = (m * m * m / static_cast<float>(D)) * inner;

#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = t + k * tpr;
      if (live && i < units) {
        float f[E];
#pragma unroll
        for (int e = 0; e < E; ++e)
          f[e] = dx_elem<T>(xv.at(k, e), gv.at(k, e) * gain(k, e), m, coeff);
        if constexpr (!VECT) {
          dx[base + i] = from_f<T>(f[0]);
        } else if constexpr (E == 4) {
          reinterpret_cast<uint4*>(dx + base)[i] =
              make_uint4(bits(f[0]), bits(f[1]), bits(f[2]), bits(f[3]));
        } else {
          reinterpret_cast<uint4*>(dx + base)[i] = make_uint4(
              bits2(from_f<T>(f[0]), from_f<T>(f[1])),
              bits2(from_f<T>(f[2]), from_f<T>(f[3])),
              bits2(from_f<T>(f[4]), from_f<T>(f[5])),
              bits2(from_f<T>(f[6]), from_f<T>(f[7])));
        }
      }
    }
    // dw: a unit past the row or a row past the end holds zeros and adds 0
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[k * E + e] += to_f(from_f<T>(gv.at(k, e) * m)) * xv.at(k, e);
    if (n + 1 == rpg) break;
    if (PREFETCH) {
      xv = xn;
      gv = gn;
      m = mn;
    } else {
      fetch(n + 1, xv, gv, m);
    }
  }

  // the block's dw: its groups' sums added in group order
  float* out = partial + static_cast<long long>(blockIdx.x) * D;
  float* mine = groups > 1 ? red + static_cast<long long>(grp) * D : out;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = t + k * tpr;
    if (i < units) {
      if constexpr (VECT) {
#pragma unroll
        for (int q = 0; q < E / 4; ++q)
          reinterpret_cast<float4*>(mine)[i * (E / 4) + q] =
              make_float4(acc[k * E + 4 * q], acc[k * E + 4 * q + 1],
                          acc[k * E + 4 * q + 2], acc[k * E + 4 * q + 3]);
      } else {
        mine[i] = acc[k];
      }
    }
  }
  if (groups > 1) {
    __syncthreads();
    if constexpr (VECT) {  // D is a multiple of 4
      const float4* r4 = red4;
      for (int c = threadIdx.x; c < D / 4; c += THREADS) {
        float4 s = r4[c];
        for (int j = 1; j < groups; ++j) {
          const float4 v = r4[static_cast<long long>(j) * (D / 4) + c];
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        reinterpret_cast<float4*>(out)[c] = s;
      }
    } else {
      for (int c = threadIdx.x; c < D; c += THREADS) {
        float s = red[c];
        for (int j = 1; j < groups; ++j) s += red[static_cast<long long>(j) * D + c];
        out[c] = s;
      }
    }
  }
}

constexpr int COLS_WARPS = 32;  // warps of the column pass's blocks
constexpr int COLS_BATCH = 9;   // rows a lane loads at once (9·32 >= 264)

// dw[c] = Σ_j partial[j][c] over the nblocks rows of partial in a fixed
// order: 32 columns a block; warp k sums rows k, k + 32, ... in order,
// loading COLS_BATCH of them at once, then the 32 sums in order
__global__ void __launch_bounds__(32 * COLS_WARPS)
bwd_cols_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                int nblocks, int D) {
  __shared__ float sums[COLS_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  for (int j0 = warp; j0 < nblocks; j0 += COLS_WARPS * COLS_BATCH) {
    float v[COLS_BATCH];
#pragma unroll
    for (int u = 0; u < COLS_BATCH; ++u) {
      const int j = j0 + u * COLS_WARPS;
      v[u] = c < D && j < nblocks ? partial[static_cast<long long>(j) * D + c]
                                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < COLS_BATCH; ++u) s += v[u];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < D) {
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < COLS_WARPS; ++k) tot += sums[k][lane];
    dw[c] = tot;
  }
}

template <typename T, int NV, bool VECT>
cudaError_t go_bwd(const void* x, const void* w, const void* g, const void* m,
                   void* dx, void* partial, long long rows, int D, int wpr,
                   int rpg, long long blocks, cudaStream_t s) {
  const int groups = WARPS / wpr;
  const int smem = groups > 1 ? static_cast<int>(sizeof(float)) * groups * D : 0;
  if (smem > 47 * 1024) {  // beside the kernel's static bytes
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_rows_kernel<T, NV, VECT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  bwd_rows_kernel<T, NV, VECT><<<static_cast<unsigned>(blocks), THREADS,
                                 smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const T*>(g), static_cast<const float*>(m),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, D, wpr, rpg);
  return cudaGetLastError();
}

// Choose the path, warps per row and rows per group, then launch both
// passes; `cap` is the number of rows of `partial`.
template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* g,
                       const void* m, void* dx, void* partial, void* dw,
                       long long rows, int D, int cap, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  bool vect =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx)) &
       15) == 0 &&
      D % VEC == 0 && D / VEC <= 32 * WARPS * BWD_VEC_CAP;
  const int units = vect ? D / VEC : D;
  const int ucap = vect ? BWD_VEC_CAP : BWD_SCALAR_CAP;
  if (units > 32 * WARPS * ucap) return cudaErrorInvalidValue;
  // one warp per row while the rows fill the card (about BWD_FILL busy
  // warps per SM of 132); more for few rows, never giving a warp nothing
  // to load, or for a row longer than a warp holds
  int wpr = 1;
  while (wpr < WARPS && ((rows * wpr < 132LL * BWD_FILL && 32 * wpr < units) ||
                         units > 32 * wpr * ucap))
    wpr *= 2;
  const int nv = (units + 32 * wpr - 1) / (32 * wpr);
  const long long groups = WARPS / wpr;
  const long long rpg = (rows + groups * cap - 1) / (groups * cap);
  const long long blocks = (rows + groups * rpg - 1) / (groups * rpg);
  if (rpg > 2147483647LL || blocks > cap) return cudaErrorInvalidValue;
  const int r = static_cast<int>(rpg);
  cudaError_t e;
  if (!vect)
    e = nv <= 8 ? go_bwd<T, 8, false>(x, w, g, m, dx, partial, rows, D, wpr, r, blocks, s)
                : go_bwd<T, 48, false>(x, w, g, m, dx, partial, rows, D, wpr, r, blocks, s);
  else if (nv <= 1)
    e = go_bwd<T, 1, true>(x, w, g, m, dx, partial, rows, D, wpr, r, blocks, s);
  else if (nv <= 2)
    e = go_bwd<T, 2, true>(x, w, g, m, dx, partial, rows, D, wpr, r, blocks, s);
  else if (nv <= 4)
    e = go_bwd<T, 4, true>(x, w, g, m, dx, partial, rows, D, wpr, r, blocks, s);
  else
    e = go_bwd<T, 8, true>(x, w, g, m, dx, partial, rows, D, wpr, r, blocks, s);
  if (e != cudaSuccess) return e;
  bwd_cols_kernel<<<(D + 31) / 32, 32 * COLS_WARPS, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw),
      static_cast<int>(blocks), D);
  return cudaGetLastError();
}

}  // namespace

// Backward of the round_scale form.  x, g, dx: (rows, D) contiguous, dtype
// 0 = float32, 1 = bfloat16; w: (D,) float32; m: (rows,) float32, the
// forward's; partial: cap × D float32 scratch (cap >= 1; the kernel runs
// at most cap blocks); dw: (D,) float32.  Returns a cudaError_t (0 on
// success).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* g,
                                  const void* m, void* dx, void* partial,
                                  void* dw, long long rows, int D, int cap,
                                  int dtype, int device, void* stream) {
  if (rows < 1 || D < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_bwd<float>(x, w, g, m, dx, partial, dw,
                                              rows, D, cap, s));
  if (dtype == 1)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(x, w, g, m, dx, partial,
                                                      dw, rows, D, cap, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
