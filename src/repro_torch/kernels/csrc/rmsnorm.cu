// RMSNorm over the trailing axis, forward: the port's twin of the TPU
// kernel src/repro/kernels/rmsnorm.py:rmsnorm_tpu (_kernel).
//
//   y = cast(f32(x) * (1 / sqrt(mean(f32(x)^2) + eps)) * f32(w))
//
// One warp per row of x (rows, D), eight rows per block, any row count
// and any D (no padding of rows to a block as on the TPU).  Each lane
// sums the squares of its strided share of the row in f32, a butterfly
// of warp shuffles adds the 32 partial sums, and a second pass over the
// row (an L1/L2 hit) scales it and rounds once to x's dtype.  The gain w
// arrives in f32.
//
// Bound on the H100: bytes.  The function reads x and w once and writes
// y once, with 3 f32 operations per element, far below the card's rate,
// so the design only has to keep enough rows in flight to stream x; the
// strided lane loop reads each warp's 32 consecutive elements together.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // rows per block

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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, long long rows, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: the whole warp leaves
  const T* xr = x + row * D;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(D) + eps);
  T* yr = y + row * D;
  for (int i = lane; i < D; i += 32)
    yr[i] = from_f<T>(to_f(xr[i]) * r * w[i]);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, long long rows,
                   int D, float eps, cudaStream_t s) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), WARPS * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), rows, D, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, D) contiguous, dtype 0 = float32, 1 = bfloat16; w: (D,)
// float32.  Returns a cudaError_t (0 on success).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y,
                              long long rows, int D, int dtype, float eps,
                              int device, void* stream) {
  if (rows < 1 || D < 1 || rows > 2147483647LL * WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, w, y, rows, D, eps, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, w, y, rows, D, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
