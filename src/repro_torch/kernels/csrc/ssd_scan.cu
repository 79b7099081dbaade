// Mamba-2 chunked SSD scan, forward: the port's twin of the TPU kernel
// src/repro/kernels/ssd_scan.py:ssd_scan_tpu (_kernel), returning also
// the final state that src/repro/models/ssm.py:ssd_chunked returns.
//
// For one (batch b, head h), with g = h / (nh / ng) its group, each chunk
// of Q steps computes, in f32:
//
//   xdt = x·dt,  cum = prefix sum of dt·A,
//   L[i][j] = exp(cum_i − cum_j)·[i ≥ j]
//   y   = ((C Bᵀ) ⊙ L)·xdt + (C·Hᵀ) ⊙ exp(cum)
//   H   ← H·exp(cum_Q) + (xdt ⊙ exp(cum_Q − cum))ᵀ B
//
// with the state H (hd × N) carried from chunk to chunk and written out
// once at the end.  Layout: x (B, S, nh, hd), dt (B, S, nh) f32, A (nh,)
// f32, B/C (B, S, ng, N), read through their batch, step and head/group
// strides (the trailing dim must be contiguous; no group is repeated);
// y is (B, S, nh, hd) contiguous in x's dtype, rounded once; h_final is
// (B, nh, hd, N) f32 contiguous.  hd is 16 or 64 (a template parameter),
// N a multiple of 4 up to 128, Q up to 128 with S % Q == 0;
// x, B and C float32 or bfloat16.
//
// Design (first, simple): one block of 256 threads per (head, batch)
// walks the chunks in order, as the TPU grid's sequential chunk axis
// does.  Shared memory holds, in f32: the chunk's B rows and x·dt rows,
// the state (transposed, N × hd), the C rows of a 32-row strip and that
// strip's scores (173 KB at Q 128, N 128, hd 64).  Per strip, each warp
// scores 4 rows against the lanes' keys (4 × 4 register tile over N,
// skipping key blocks above the diagonal); the decay exp(cum_i − cum_j)
// is computed only where i ≥ j, so the values above the diagonal, which
// overflow, are never formed.  Then each thread accumulates one float4
// of head dims for its rows over the keys (the intra-chunk term) and over
// N (the carried state's term).  After the chunk's strips each thread
// updates its own float4 of the state for a few state rows.  Products
// are fmaf on the CUDA cores; exp is expf.
//
// Bound on the H100: bytes.  At the serving shape (B 4, S 512, nh 48,
// hd 64, N 128, bf16) one call moves 32.9 MB (x, dt, B, C in; y and the
// f32 state out), 9.8 µs at 3.35 TB/s, against 8.05 GFLOP of products,
// 8.1 µs at the bf16 tensor-core rate.  This design runs its products
// on the CUDA cores with one block per SM (192 blocks on 132 SMs), so it
// is far from either bound; tensor-core tiles (mma/wgmma) over several
// heads per block are the next design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;    // threads per block
constexpr int R = 32;      // chunk rows per score strip (8 warps × 4)
constexpr int QMAX = 128;  // longest chunk
constexpr int NMAX = 128;  // largest state size

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  void* y;
  float* h;
  long long sxb, sxs, sxh;  // element strides of x: batch, step, head
  long long sdb, sds, sdh;  // of dt
  long long sbb, sbs, sbg;  // of B: batch, step, group
  long long scb, scs, scg;  // of C
  int S, nh, ng, N, Q;
};

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

__device__ __forceinline__ void fma4(float s, const float4& v, float4& acc) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

// Shared floats for a chunk of Q steps: B (Q × (N+4)), x·dt (Q × (HD+4)),
// the state (N × (HD+4)), a C strip (R × (N+4)), a score strip
// (R × (Q+4)), then cum, exp(cum), exp(cum_Q − cum) and dt (QMAX each).
// Rows are padded by 4 floats: float4 rows stay aligned, and a warp's
// float4 reads of eight consecutive rows fall in distinct banks.
__host__ __device__ constexpr size_t smem_floats(int HD, int N, int Q) {
  return static_cast<size_t>(Q) * (N + 4) + static_cast<size_t>(Q) * (HD + 4) +
         static_cast<size_t>(N) * (HD + 4) + static_cast<size_t>(R) * (N + 4) +
         static_cast<size_t>(R) * (Q + 4) + 4 * QMAX;
}

template <int HD, typename T>
__global__ void __launch_bounds__(NT) ssd_kernel(Args a) {
  constexpr int HP = HD + 4;
  constexpr int D4 = HD / 4;                  // float4 columns of a head row
  constexpr int RG = NT / D4;                 // rows side by side
  constexpr int RPT = (R + RG - 1) / RG;      // strip rows per thread
  constexpr int KPT = (NMAX + RG - 1) / RG;   // state rows per thread
  extern __shared__ float4 smem4[];
  const int N = a.N, Q = a.Q, NP = N + 4, SP = Q + 4;
  float* Bs = reinterpret_cast<float*>(smem4);
  float* Xs = Bs + Q * NP;
  float* Hs = Xs + Q * HP;
  float* Cs = Hs + N * HP;
  float* Ss = Cs + R * NP;
  float* cum = Ss + R * SP;
  float* ec = cum + QMAX;
  float* dec = ec + QMAX;
  float* dts = dec + QMAX;

  const int h = blockIdx.x, bb = blockIdx.y;
  const int g = h / (a.nh / a.ng);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = tid % D4, rg = tid / D4;  // this thread's float4 column, row
  const T* xp = static_cast<const T*>(a.x) + bb * a.sxb + h * a.sxh;
  const float* dtp = a.dt + bb * a.sdb + h * a.sdh;
  const T* bp = static_cast<const T*>(a.b) + bb * a.sbb + g * a.sbg;
  const T* cp = static_cast<const T*>(a.c) + bb * a.scb + g * a.scg;
  T* yp = static_cast<T*>(a.y) +
          (static_cast<long long>(bb) * a.S * a.nh + h) * HD;
  const long long ys = static_cast<long long>(a.nh) * HD;  // y's step stride
  const float A = a.A[h];

  for (int i = tid; i < N * HD; i += NT) Hs[(i / HD) * HP + i % HD] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += Q) {
    __syncthreads();  // the last chunk's tiles are no longer read
    for (int j = tid; j < Q; j += NT) dts[j] = dtp[(t0 + j) * a.sds];
    __syncthreads();
    if (tid == 0) {  // cum = prefix sum of the rounded products dt·A
      float s = 0.f;
      for (int j = 0; j < Q; ++j) {
        s += dts[j] * A;
        cum[j] = s;
      }
    }
    for (int i = tid; i < Q * N; i += NT) {
      const int j = i / N, n = i % N;
      Bs[j * NP + n] = to_f(bp[(t0 + j) * a.sbs + n]);
    }
    for (int i = tid; i < Q * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      Xs[j * HP + d] = to_f(xp[(t0 + j) * a.sxs + d]) * dts[j];
    }
    __syncthreads();
    const float seg = cum[Q - 1];
    for (int j = tid; j < Q; j += NT) {
      ec[j] = expf(cum[j]);
      dec[j] = expf(seg - cum[j]);
    }

    for (int r0 = 0; r0 < Q; r0 += R) {
      for (int i = tid; i < R * N; i += NT) {
        const int r = i / N, n = i % N;
        Cs[r * NP + n] =
            r0 + r < Q ? to_f(cp[(t0 + r0 + r) * a.scs + n]) : 0.f;
      }
      __syncthreads();

      // scores of strip rows rl..rl+3 (this warp) against keys lane + 32k
      {
        const int rl = 4 * warp;
        const int imax = min(r0 + rl + 3, Q - 1);
        const int nk = imax / 32 + 1;  // key blocks reaching the diagonal
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(&Cs[(rl + r) * NP + n]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k >= nk) break;  // warp-uniform
            const int j = min(lane + 32 * k, Q - 1);
            const float4 bv = *reinterpret_cast<const float4*>(&Bs[j * NP + n]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][k] = fmaf(cv[r].x, bv.x, acc[r][k]);
              acc[r][k] = fmaf(cv[r].y, bv.y, acc[r][k]);
              acc[r][k] = fmaf(cv[r].z, bv.z, acc[r][k]);
              acc[r][k] = fmaf(cv[r].w, bv.w, acc[r][k]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r0 + rl + r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = lane + 32 * k;
            if (j >= Q) continue;
            // selected, never multiplied: the exp overflows at j > i
            float s = 0.f;
            if (k < nk && j <= i && i < Q)
              s = acc[r][k] * expf(cum[i] - cum[j]);
            Ss[(rl + r) * SP + j] = s;
          }
        }
      }
      __syncthreads();

      // y of this thread's strip rows rg + RG·k, head dims 4·d4 .. 4·d4+3
      {
        int rows[RPT];
        int jend = -1;
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const int r = rg + RG * k;
          rows[k] = min(r, R - 1);
          if (r < R && r0 + r < Q) jend = r0 + r;
        }
        if (jend >= 0) {
          float4 yi[RPT], yh[RPT];
#pragma unroll
          for (int k = 0; k < RPT; ++k)
            yi[k] = yh[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int j = 0; j <= jend; ++j) {  // zero scores past each row's i
            const float4 xv =
                *reinterpret_cast<const float4*>(&Xs[j * HP + 4 * d4]);
#pragma unroll
            for (int k = 0; k < RPT; ++k) fma4(Ss[rows[k] * SP + j], xv, yi[k]);
          }
          for (int n = 0; n < N; ++n) {
            const float4 hv =
                *reinterpret_cast<const float4*>(&Hs[n * HP + 4 * d4]);
#pragma unroll
            for (int k = 0; k < RPT; ++k) fma4(Cs[rows[k] * NP + n], hv, yh[k]);
          }
#pragma unroll
          for (int k = 0; k < RPT; ++k) {
            const int r = rg + RG * k, i = r0 + r;
            if (r >= R || i >= Q) continue;
            const float e = ec[i];
            T* out = yp + (t0 + i) * ys + 4 * d4;
            out[0] = from_f<T>(yi[k].x + yh[k].x * e);
            out[1] = from_f<T>(yi[k].y + yh[k].y * e);
            out[2] = from_f<T>(yi[k].z + yh[k].z * e);
            out[3] = from_f<T>(yi[k].w + yh[k].w * e);
          }
        }
      }
      __syncthreads();  // the strip's C rows and scores are no longer read
    }

    // state update: this thread's rows n = rg + RG·k, head dims 4·d4 ..
    {
      const float es = expf(seg);
      float4 acc[KPT];
#pragma unroll
      for (int k = 0; k < KPT; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < Q; ++j) {
        float4 xv = *reinterpret_cast<const float4*>(&Xs[j * HP + 4 * d4]);
        const float w = dec[j];
        xv.x *= w;
        xv.y *= w;
        xv.z *= w;
        xv.w *= w;
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
          const int n = rg + RG * k;
          if (n < N) fma4(Bs[j * NP + n], xv, acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < KPT; ++k) {
        const int n = rg + RG * k;
        if (n >= N) continue;
        float4* hv = reinterpret_cast<float4*>(&Hs[n * HP + 4 * d4]);
        float4 v = *hv;
        v.x = v.x * es + acc[k].x;
        v.y = v.y * es + acc[k].y;
        v.z = v.z * es + acc[k].z;
        v.w = v.w * es + acc[k].w;
        *hv = v;
      }
    }
  }
  __syncthreads();
  float* hp = a.h + (static_cast<long long>(bb) * a.nh + h) * HD * N;
  for (int i = tid; i < HD * N; i += NT) hp[i] = Hs[(i % N) * HP + i / N];
}

template <int HD, typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(HD, a.N, a.Q);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(a.nh, B);
  ssd_kernel<HD, T><<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// strides: the element strides (batch, step, head) of x and dt, then
// (batch, step, group) of B and C, in that order.  ints: B, S, nh, ng,
// hd, N, Q, dtype of x/B/C (0 = float32, 1 = bfloat16), device.  Returns
// a cudaError_t (0 on success).
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* b, const void* c, void* y, float* h,
                               const long long* strides, const int* ints,
                               void* stream) {
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.b = b; a.c = c; a.y = y; a.h = h;
  a.sxb = strides[0]; a.sxs = strides[1]; a.sxh = strides[2];
  a.sdb = strides[3]; a.sds = strides[4]; a.sdh = strides[5];
  a.sbb = strides[6]; a.sbs = strides[7]; a.sbg = strides[8];
  a.scb = strides[9]; a.scs = strides[10]; a.scg = strides[11];
  const int B = ints[0], hd = ints[4], dtype = ints[7];
  a.S = ints[1]; a.nh = ints[2]; a.ng = ints[3]; a.N = ints[5]; a.Q = ints[6];
  if (B < 1 || B > 65535 || a.S < 1 || a.nh < 1 || a.ng < 1 ||
      a.nh % a.ng != 0 || a.N < 4 || a.N > NMAX || a.N % 4 != 0 ||
      a.Q < 1 || a.Q > QMAX || a.S % a.Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(ints[8]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 16 && dtype == 0) e = launch<16, float>(a, B, s);
  else if (hd == 16 && dtype == 1) e = launch<16, __nv_bfloat16>(a, B, s);
  else if (hd == 64 && dtype == 0) e = launch<64, float>(a, B, s);
  else if (hd == 64 && dtype == 1) e = launch<64, __nv_bfloat16>(a, B, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
