// Flash attention, forward: the port's twin of the TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_tpu (_kernel).
//
// o[b, i, h] = sum_j softmax_j(mask(cap·tanh(s/cap) or s)) v[b, j, kvh]
// with s = (scale·q[b, i, h]) · k[b, j, kvh], kvh = h / (H / KV): grouped
// query attention read natively, no repeated K/V.  Masks: causal
// (i >= j), sliding window (i - j < window); masked scores are -1e30 as
// on the TPU, keys past the end of the sequence contribute nothing.
//
// Layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), read through their batch,
// sequence and head strides (the head dim must be contiguous); o is
// (B, Sq, H, hd) contiguous in q's dtype.  hd is 64 or 128 (a template
// parameter); float32 or bfloat16.
//
// Design (first, simple): one block of 256 threads per (64-query tile,
// head, batch).  The block keeps its query tile, pre-scaled, in shared
// memory in f32 and walks the 64-key tiles of the causal / window band
// only (the TPU kernel's tile skipping), each staged in shared memory in
// f32.  Four threads own one query row: each scores 16 of the tile's
// keys, the four meet through warp shuffles for the row max and sum
// (online softmax, m and l in f32, expf), park the probabilities in
// shared memory, and accumulate hd/4 output dims each.  Products run on
// the CUDA cores in f32 (fmaf), the TPU kernel's arithmetic; the
// output is acc / max(l, 1e-30), rounded once.
//
// Bound on the H100: operations.  A causal prefill does 2·B·H·S²·hd
// multiply-adds' worth of FLOPs on S·(H + 2·KV)·hd inputs, far above the
// card's ~295 FLOP/byte balance for S in the hundreds, so the limit is
// the tensor cores' rate; this design runs on the CUDA cores instead and
// is fed from shared memory at about four fmaf per 16-byte load, so it
// reaches only a fraction of even their rate.  Tensor cores (mma/wgmma)
// and TMA-fed tile rings are the next designs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 4 per query row
constexpr float NEG = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sqb, sqs, sqh;  // element strides of q: batch, seq, head
  long long skb, sks, skh;
  long long svb, svs, svh;
  int Sq, Sk, H, KV;
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  float scale;
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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (HD + 4) + static_cast<size_t>(BK) * (HD + 4) +
          static_cast<size_t>(BK) * HD + static_cast<size_t>(BQ) * (BK + 1));
}

template <int HD, typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Args a) {
  constexpr int QS = HD + 4;   // padded row strides: conflict-free float4
  constexpr int KS = HD + 4;
  constexpr int PS = BK + 1;
  constexpr int NS = BK / 4;   // keys scored per thread
  constexpr int DPT = HD / 4;  // output dims per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * HD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;  // query row in the tile; key group
  const int qi = q0 + r;

  const T* qp = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* kp = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* vp = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int rr = idx / HD, d = idx % HD, qq = q0 + rr;
    Qs[rr * QS + d] = qq < a.Sq ? to_f(qp[qq * a.sqs + d]) * a.scale : 0.f;
  }

  // the band of keys this tile can see, in whole key tiles
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin =
      a.window > 0 ? (max(0, q0 - a.window + 1) / BK) * BK : 0;

  float m = NEG, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's K/V are no longer read
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD, kk = k0 + j;
      const bool in = kk < a.Sk;
      Ks[j * KS + d] = in ? to_f(kp[kk * a.sks + d]) : 0.f;
      Vs[j * HD + d] = in ? to_f(vp[kk * a.svs + d]) : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) s[jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * QS + d]);
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&Ks[(c + 4 * jj) * KS + d]);
        s[jj] = fmaf(qv.x, kv.x, s[jj]);
        s[jj] = fmaf(qv.y, kv.y, s[jj]);
        s[jj] = fmaf(qv.z, kv.z, s[jj]);
        s[jj] = fmaf(qv.w, kv.w, s[jj]);
      }
    }

    float mt = NEG;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const int kk = k0 + c + 4 * jj;
      float x = s[jj];
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      const bool vis = (!a.causal || qi >= kk) &&
                       (a.window <= 0 || qi - kk < a.window);
      x = vis ? x : NEG;
      s[jj] = kk < a.Sk ? x : -INFINITY;  // past the end: weight 0
      mt = fmaxf(mt, s[jj]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const float p = expf(s[jj] - m_new);
      ls += p;
      Ps[r * PS + c + 4 * jj] = p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * corr + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    __syncwarp();  // a row's probabilities are written and read by its warp

    const int jn = min(BK, a.Sk - k0);
    for (int j = 0; j < jn; ++j) {
      const float p = Ps[r * PS + j];
#pragma unroll
      for (int qd = 0; qd < HD / 16; ++qd) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j * HD + 16 * qd + 4 * c]);
        acc[4 * qd + 0] = fmaf(p, vv.x, acc[4 * qd + 0]);
        acc[4 * qd + 1] = fmaf(p, vv.y, acc[4 * qd + 1]);
        acc[4 * qd + 2] = fmaf(p, vv.z, acc[4 * qd + 2]);
        acc[4 * qd + 3] = fmaf(p, vv.w, acc[4 * qd + 3]);
      }
    }
  }

  if (qi < a.Sq) {
    const float den = fmaxf(l, 1e-30f);
    T* op = static_cast<T*>(a.o) +
            ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * HD;
#pragma unroll
    for (int qd = 0; qd < HD / 16; ++qd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[16 * qd + 4 * c + e] = from_f<T>(acc[4 * qd + e] / den);
  }
}

template <int HD, typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<HD, T><<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// strides: the element strides (batch, seq, head) of q, k and v, in that
// order.  ints: B, Sq, Sk, H, KV, hd, dtype (0 = float32, 1 = bfloat16),
// causal, window (<= 0: none), device.  softcap <= 0: none.  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides,
                                      const int* ints, float softcap,
                                      float scale, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.sqb = strides[0]; a.sqs = strides[1]; a.sqh = strides[2];
  a.skb = strides[3]; a.sks = strides[4]; a.skh = strides[5];
  a.svb = strides[6]; a.svs = strides[7]; a.svh = strides[8];
  const int B = ints[0], hd = ints[5], dtype = ints[6];
  a.Sq = ints[1]; a.Sk = ints[2]; a.H = ints[3]; a.KV = ints[4];
  a.causal = ints[7]; a.window = ints[8];
  a.softcap = softcap; a.scale = scale;
  if (B < 1 || a.Sq < 1 || a.Sk < 1 || a.KV < 1 || a.H % a.KV != 0 ||
      B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(ints[9]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64 && dtype == 0) e = launch<64, float>(a, B, s);
  else if (hd == 64 && dtype == 1) e = launch<64, __nv_bfloat16>(a, B, s);
  else if (hd == 128 && dtype == 0) e = launch<128, float>(a, B, s);
  else if (hd == 128 && dtype == 1) e = launch<128, __nv_bfloat16>(a, B, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
