// RG-LRU scan (Griffin's real-gated linear recurrence), forward.  It
// replaces no Pallas kernel: the reference runs this recurrence by
// jax.lax.associative_scan inside src/repro/models/rglru.py:rglru_apply
// (:109); the port needs a kernel for it because PyTorch has no
// associative scan.  Per channel w, from the gate pre-activations on:
//
//   r = sigmoid(r_pre), i = sigmoid(i_pre)
//   log_a = (-8 * softplus(lambda)) * r,  a = exp(log_a)
//   b = (sqrt(clip(1 - exp(2 * log_a), 0, 1)) * i) * x
//   h_t = a_t * h_{t-1} + b_t,  h_{-1} = h0 (or 0)
//   y_t = cast(h_t), or cast(cast(h_t) * gate_t) with a gate
//
// in float32 with the reference's expressions (expf, not __expf; the
// build passes -fmad=false, so a * h + b rounds twice, as the reference's
// multiply and add do).  x, r_pre, i_pre, gate, y: (B, S, W) contiguous
// in T (float or bf16); lambda (W,), h0 and h_last (B, W) float32.
// h_last is h at position S - 1, the f32 value whose rounding is the
// last y.
//
// Bound on the H100: bytes.  At recurrentgemma-2b's prefill (B 4, S
// 4096, W 2560, bf16, gate fused) the kernel must move 419 MB, 0.125 ms
// at 3.35 TB/s.  Each element also costs ~90 instructions (two sigmoids
// with their IEEE divisions, three expf, a sqrt, the recurrence twice),
// ~0.11 ms of issue on 132 SMs, so the two limits are close and the
// kernel has to overlap them.  A sequential scan per channel would give
// only B * W = 10,240 threads, ~2.4 warps an SM, each with one step's
// loads in flight: latency-bound.  The design:
// * one block per (32 channels, batch row) with NC = 16 warps; warp c
//   owns steps [L c, L c + L) of every NC·L-step span (L = 8: 128 steps),
//   lane l channel 32 * blockIdx.x + l (64 contiguous bytes a warp in
//   bf16); two blocks an SM (at most 64 registers a thread);
// * a thread loads its L steps of x, r_pre, i_pre (and the gate) into
//   registers at once (one batch of independent loads, predicated past
//   S), forms a and b, and composes its L affine maps from h = 0;
// * one warp then carries h across the span's NC partial maps in order
//   (shared memory), handing each chunk the h that enters it, and every
//   thread rescans its L steps from that h, from registers, and writes
//   y; the block moves to the next span with the carry.
// Each input is read once.  Steps past S are the identity (a = 1, b = 0),
// so a thread's h after its loop is h at its last valid step.  Of the
// shapes timed on the card (chip_variants.py), 16 chunks of 8 steps at
// two blocks an SM ran fastest at the prefill: 16 chunks of 16 steps at
// one block an SM (99 registers a thread) took 1.2x as long.  A decode
// step (S <= 16) runs one warp a block, which scans its steps alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;  // channels per block (a warp's lanes)
// the prefill's block: NC chunks per span (warps per block) of L steps
// each, held in registers, and the blocks an SM should hold (MINB, for
// the register cap); a call of at most DECODE_L steps (a decode step)
// takes one warp per block instead
constexpr int PREFILL_NC = 16;
constexpr int PREFILL_L = 8;
constexpr int PREFILL_MINB = 2;
constexpr int DECODE_L = 16;

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// softplus as jax.nn.softplus evaluates it: max(x, 0) + log1p(exp(-|x|))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <typename T, bool GATE, int NC, int L, int MINB>
__global__ void __launch_bounds__(CH* NC, MINB)
    rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ rp,
                      const T* __restrict__ ip, const float* __restrict__ lam,
                      const float* __restrict__ h0, const T* __restrict__ gate,
                      T* __restrict__ y, float* __restrict__ h_last, int S,
                      int W) {
  __shared__ float sA[NC][CH];      // each chunk's composed map h -> A h + H
  __shared__ float sH[NC][CH];
  __shared__ float sIn[NC][CH];     // the h entering each chunk

  const int lane = threadIdx.x, c = threadIdx.y;
  const int w = blockIdx.x * CH + lane, b = blockIdx.y;
  const bool live = w < W;
  const float coef = live ? -8.f * softplus(lam[w]) : 0.f;
  float carry = (live && h0 != nullptr) ? h0[static_cast<long long>(b) * W + w]
                                        : 0.f;  // used by warp 0
  const long long row = static_cast<long long>(b) * S;

  for (int s0 = 0; s0 < S; s0 += NC * L) {
    const int t0 = s0 + c * L;
    T xv[L], rv[L], iv[L], gv[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {  // one batch of independent loads
      const bool in = live && t0 + k < S;
      const long long o = (row + t0 + k) * W + w;
      xv[k] = in ? x[o] : from_f<T>(0.f);
      rv[k] = in ? rp[o] : from_f<T>(0.f);
      iv[k] = in ? ip[o] : from_f<T>(0.f);
      if constexpr (GATE) gv[k] = in ? gate[o] : from_f<T>(0.f);
    }
    float av[L], bv[L];
    float A = 1.f, H = 0.f;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const float r = sigmoid(to_f(rv[k])), i = sigmoid(to_f(iv[k]));
      const float log_a = coef * r;
      const float mult =
          sqrtf(fminf(fmaxf(1.f - expf(2.f * log_a), 0.f), 1.f));
      const bool in = t0 + k < S;
      av[k] = in ? expf(log_a) : 1.f;
      bv[k] = in ? (mult * i) * to_f(xv[k]) : 0.f;
      H = av[k] * H + bv[k];
      A = A * av[k];
    }
    sA[c][lane] = A;
    sH[c][lane] = H;
    __syncthreads();
    if (c == 0) {  // carry h across the span's chunks, in order
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        sIn[j][lane] = carry;
        carry = sA[j][lane] * carry + sH[j][lane];
      }
    }
    __syncthreads();
    float h = sIn[c][lane];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      h = av[k] * h + bv[k];
      if (live && t0 + k < S) {
        const long long o = (row + t0 + k) * W + w;
        if constexpr (GATE)
          y[o] = from_f<T>(to_f(from_f<T>(h)) * to_f(gv[k]));
        else
          y[o] = from_f<T>(h);
      }
    }
    // the thread holding step S - 1 hands its f32 h on as h_last
    if (live && t0 <= S - 1 && S - 1 < t0 + L)
      h_last[static_cast<long long>(b) * W + w] = h;
  }
}

template <typename T, int NC, int L, int MINB>
void launch_shape(const T* x, const T* r, const T* i, const float* lam,
                  const float* h0, const T* gate, T* y, float* h_last, int B,
                  int S, int W, cudaStream_t s) {
  dim3 grid((W + CH - 1) / CH, B), block(CH, NC);
  if (gate != nullptr)
    rglru_scan_kernel<T, true, NC, L, MINB><<<grid, block, 0, s>>>(
        x, r, i, lam, h0, gate, y, h_last, S, W);
  else
    rglru_scan_kernel<T, false, NC, L, MINB><<<grid, block, 0, s>>>(
        x, r, i, lam, h0, nullptr, y, h_last, S, W);
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* i,
                   const float* lam, const float* h0, const void* gate,
                   void* y, float* h_last, int B, int S, int W,
                   cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* it = static_cast<const T*>(i);
  const T* gt = static_cast<const T*>(gate);
  T* yt = static_cast<T*>(y);
  if (S <= DECODE_L)  // one warp a block: no span to carry across
    launch_shape<T, 1, DECODE_L, 1>(xt, rt, it, lam, h0, gt, yt, h_last, B,
                                    S, W, s);
  else
    launch_shape<T, PREFILL_NC, PREFILL_L, PREFILL_MINB>(
        xt, rt, it, lam, h0, gt, yt, h_last, B, S, W, s);
  return cudaGetLastError();
}

}  // namespace

// x, r, i, gate (or null), y: (B, S, W) contiguous in dtype (0 = float32,
// 1 = bfloat16); lam (W,), h0 (B, W) or null, h_last (B, W): float32.
// Returns a cudaError_t (0 on success).
extern "C" int rglru_scan_launch(const void* x, const void* r, const void* i,
                                 const void* lam, const void* h0,
                                 const void* gate, void* y, void* h_last,
                                 int B, int S, int W, int dtype, int device,
                                 void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lam);
  const float* h = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  if (dtype == 0)
    e = launch<float>(x, r, i, l, h, gate, y, hl, B, S, W, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(x, r, i, l, h, gate, y, hl, B, S, W, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
