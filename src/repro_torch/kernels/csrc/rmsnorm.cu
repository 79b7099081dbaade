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
// With the forward's m (its residual, as _rms_fwd saves it) and
// gs = f32(g)·w:
//   inner = Σ_j f32(cast(gs_j))·f32(x_j)            (f32)
//   coeff = (m·m·m / D)·inner                        (f32)
//   dx    = cast(m·gs) − cast(cast(coeff)·x)         (bf16: each op rounds)
//   dx    = m·gs − coeff·x                           (float32)
//   dw    = Σ_rows f32(cast(f32(g)·m))·f32(x)        (f32)
// exactly the roundings of _rms_bwd (the products of two bf16 values are
// exact in f32).
//
// Bound on the H100: bytes.  dx reads x and g once and writes dx once;
// dw is a column sum over all rows of the same inputs.  The design, simple
// and deterministic (no atomics, the same bits every run):
// * bwd_rows_kernel: 4 warps a block, one row at a time per warp, RPB
//   rows a block; a row is read twice (its inner sum, then dx), the
//   second time from L1/L2; each warp adds its rows' t·x into its own f32 row of dw in
//   shared memory (a lane owns columns lane, lane + 32, ...), then the
//   block sums its 4 warp rows in order into partial[block] (f32);
// * bwd_cols_kernel: dw[c] = Σ_block partial[block][c] in block order.

constexpr int BWD_WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(32 * BWD_WARPS)
bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const T* __restrict__ g, const float* __restrict__ mrow,
                T* __restrict__ dx, float* __restrict__ partial,
                long long rows, int D, int rpb) {
  extern __shared__ float acc[];  // [BWD_WARPS][D]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* mine = acc + static_cast<long long>(warp) * D;
  for (int c = lane; c < D; c += 32) mine[c] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * rpb;
  const long long r1 = min(r0 + rpb, rows);
  for (long long r = r0 + warp; r < r1; r += BWD_WARPS) {
    const T* xr = x + r * D;
    const T* gr = g + r * D;
    T* dr = dx + r * D;
    float inner = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float gs = to_f(gr[c]) * w[c];
      inner += to_f(from_f<T>(gs)) * to_f(xr[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) inner += __shfl_xor_sync(FULL, inner, o);
    const float m = mrow[r];
    const float coeff = (m * m * m / static_cast<float>(D)) * inner;
    for (int c = lane; c < D; c += 32) {
      const float xv = to_f(xr[c]);
      const float gv = to_f(gr[c]);
      const float gs = gv * w[c];
      if constexpr (sizeof(T) == 2) {
        const float a = to_f(from_f<T>(m * gs));
        const float b = to_f(from_f<T>(to_f(from_f<T>(coeff)) * xv));
        dr[c] = from_f<T>(a - b);
      } else {
        dr[c] = from_f<T>(m * gs - coeff * xv);
      }
      mine[c] += to_f(from_f<T>(gv * m)) * xv;
    }
  }
  __syncthreads();
  float* out = partial + static_cast<long long>(blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += 32 * BWD_WARPS) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < BWD_WARPS; ++j) s += acc[j * D + c];
    out[c] = s;
  }
}

__global__ void bwd_cols_kernel(const float* __restrict__ partial,
                                float* __restrict__ dw, int nblocks, int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  float s = 0.f;
  for (int j = 0; j < nblocks; ++j)
    s += partial[static_cast<long long>(j) * D + c];
  dw[c] = s;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* g,
                       const void* m, void* dx, void* partial, void* dw,
                       long long rows, int D, int rpb, cudaStream_t s) {
  const long long blocks = (rows + rpb - 1) / rpb;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * BWD_WARPS * static_cast<size_t>(D);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  bwd_rows_kernel<T><<<static_cast<unsigned>(blocks), 32 * BWD_WARPS, smem,
                       s>>>(static_cast<const T*>(x),
                            static_cast<const float*>(w),
                            static_cast<const T*>(g),
                            static_cast<const float*>(m), static_cast<T*>(dx),
                            static_cast<float*>(partial), rows, D, rpb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_cols_kernel<<<(D + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw),
      static_cast<int>(blocks), D);
  return cudaGetLastError();
}

}  // namespace

// Backward of the round_scale form.  x, g, dx: (rows, D) contiguous, dtype
// 0 = float32, 1 = bfloat16; w: (D,) float32; m: (rows,) float32, the
// forward's; partial: ceil(rows / rpb) × D float32 scratch; dw: (D,)
// float32.  rpb: rows per block.  Returns a cudaError_t (0 on success).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* g,
                                  const void* m, void* dx, void* partial,
                                  void* dw, long long rows, int D, int rpb,
                                  int dtype, int device, void* stream) {
  if (rows < 1 || D < 1 || rpb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_bwd<float>(x, w, g, m, dx, partial, dw,
                                              rows, D, rpb, s));
  if (dtype == 1)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(x, w, g, m, dx, partial,
                                                      dw, rows, D, rpb, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
