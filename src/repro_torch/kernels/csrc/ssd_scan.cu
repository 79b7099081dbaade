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
// with the state H (hd × N) carried from chunk to chunk; the final state
// is written out.  Layout: x (B, S, nh, hd), dt (B, S, nh) f32, A (nh,)
// f32, B/C (B, S, ng, N), read through their batch, step and head/group
// strides (the trailing dim must be contiguous; no group is repeated);
// y is (B, S, nh, hd) contiguous in x's dtype, rounded once; h_final is
// (B, nh, hd, N) f32 contiguous.  hd is 16 or 64 (a template parameter),
// N a multiple of 4 up to 128, Q up to 128 with S % Q == 0.
//
// Bound on the H100: bytes.  At the serving shape (B 4, S 512, nh 48,
// hd 64, N 128, one group, bf16) one call moves 32.9 MB (x, dt, B, C in;
// y and the f32 state out), 9.8 µs at 3.35 TB/s, against 4.9 GFLOP of
// products (C·Bᵀ once per group and chunk), 5.0 µs at the bf16
// tensor-core rate.
//
// bfloat16: two launches on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulated):
//
//   scan_kernel  one block per (32 or 64 state rows, or 16 at hd 16; head;
//                batch) walks the chunks in order with the rows of H
//                (× N) in its MMA accumulators, so the chunk states never
//                reach memory: per chunk
//                H ← H·exp(seg) + (x ⊙ dt·exp(seg − cum))ᵀ·B, and H, now
//                H_in[c+1], goes to scratch as bf16 hi and lo in the
//                accumulators' fragment order.  One warp forms the next
//                chunk's cum by a warp scan (written to scratch, the one
//                copy out_kernel reads) while the next chunk's B, x and
//                dt are copied in.  The last H is h_final.
//   out_kernel   one block per (batch, chunk, tile of OUT_HEADS heads of
//                one group), two to an SM: G = C·Bᵀ once for the tile (lower
//                triangle, 16-row blocks, kept in shared memory in
//                fragment order); per head y = exp(cum) ⊙ (C·H_inᵀ) + P·x
//                with P = G ⊙ exp(cum_i − cum_j)[i ≥ j] ⊙ dt_j formed in
//                registers, y rounded to bf16 once and stored as 16-byte
//                rows.
//
// A first design had three launches (chunk states to f32 scratch, a pass
// of the state recurrence over them, then the output): it moved the f32
// chunk states through memory three times and measured slower at both
// timed shapes in the same calls on the H100 (PERF.md §6, the SSD
// redesign's findings).
//
// Precision: x, B and C are exact bf16 operands.  The three products with
// an f32 operand (x·dt·decay against B, P against x, C against H_in) split
// that operand into hi = bf16(a) and lo = bf16(a − hi) and run two MMAs
// into one f32 accumulator: single bf16 rounding of the state operand
// misses the final state's 1e-5 tolerance by two orders of magnitude
// (tests/test_torch_ssd.py).  exp(cum_i − cum_j) is selected only where
// i ≥ j (above the diagonal it overflows).
//
// The backward (ssd_bwd_launch, after the forward below): the VJP of
// the chunked form, replacing the reference's XLA autodiff of
// src/repro/models/ssm.py:ssd_chunked, on the forward's cum and entering
// states (the bfloat16 route's hi + lo, or the float32 route's plain
// copy).  Three launches a route, no atomics.  Bound on the H100 at
// mamba2-780m's training shape (B 2, S 512, nh 48, hd 64, N 128, bf16):
// 33.10 MB, 9.9 µs at 3.35 TB/s, against 5.67 GFLOP over the causal
// pairs (5.7 µs on the bf16 tensor cores, 85 µs on the f32 cores).
//
// bfloat16, on the tensor cores (mma.sync m16n8k16):
//   bwd_gscan_kernel  one block per (head, batch) scans the state gradient G over the chunks
//                     in reverse in its MMA accumulators, as scan_kernel
//                     carries the forward's state, writing each chunk's
//                     G as bf16 hi + lo in the states' fragment order and
//                     its inner product with the entering state;
//   bwd_chunk_kernel  one block per (tile of three heads of one group,
//                     chunk, batch), one to an SM: C·Bᵀ once for the
//                     tile, then per head every 16 × 16 tile of the
//                     chunk's Q × Q duals formed once (dy·xᵀ exact, the
//                     decay selected on the causal half) and used for
//                     its columns (dB, dx, by the warp of its column
//                     block) and, handed over through shared memory by
//                     movmatrix, its rows (dC, by the warp of its row
//                     block); the state terms on the same block; dcum,
//                     its reverse scan, ddt and the chunk's share of dA;
//                     dB and dC summed over the tile's heads in the
//                     warps' accumulators;
//   bwd_sum_kernel    dA over the (batch, chunk) shares and dB, dC over a
//                     group's head tiles, in order.
// Float32 scratch is G (4 bytes an element, hi + lo), the chunk shares
// of dA and one dB and dC partial per head tile: 29.4 MB at the training
// shape, where the float32 route's layout takes 63.5 MB (G in f32, dB and
// dC per head).  Precision: x, B, C, dy are exact
// operands; dy·exp(cum), G, the entering state and S = (C·Bᵀ) ⊙ L are
// split into hi + lo; D = dt_j·(dy·xᵀ) ⊙ L is rounded once (it reaches
// only the bf16 dB and dC; one rounding of any of the four split
// operands puts ddt outside phase 5's tolerance: tests/test_torch_ssd.py).
//
// float32, on the CUDA cores (the first design): bwd_state_kernel scans
// the state gradient; bwd_strip_kernel forms each chunk's duals
// S = (C·Bᵀ) ⊙ L and dy·xdtᵀ tile by tile for a strip of 32 steps, as
// rows (→ dC) or columns (→ dB, dx), so each is formed twice;
// bwd_finish_kernel scans dcum within each chunk (→ ddt, dA) and sums dB
// and dC over each group's heads in order.
//
// float32: the first design, products in f32 on the CUDA cores: one block
// of 256 threads per (head, batch) walks the chunks in order, as the TPU
// grid's sequential chunk axis does.  Shared memory holds, in f32: the
// chunk's B rows and x·dt rows, the state (transposed, N × hd), the C rows
// of a 32-row strip and that strip's scores (173 KB at Q 128, N 128,
// hd 64).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;    // threads per block
constexpr int R = 32;      // chunk rows per score strip (8 warps × 4)
constexpr int QMAX = 128;  // longest chunk
constexpr int NMAX = 128;  // largest state size
// heads per out_kernel block (a group's last tile may hold fewer): the
// fastest of 1..8 at mamba2-780m's serving prefill on the H100 (PERF.md
// §6, the SSD redesign's findings)
constexpr int OUT_HEADS = 3;

typedef __nv_bfloat16 bf16;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  void* y;
  float* h;
  float* cum;  // (B, nc, nh, Q) prefix sums: bfloat16 scratch; float32's
               // optional residual for the backward (null: not written)
  float* st;   // each chunk's entering state: bfloat16 (B, nc, nh, hd, N
               // rounded to 8) as hi + lo in fragment order; float32
               // (B, nc, nh, hd, N) plain, optional like cum
  long long sxb, sxs, sxh;  // element strides of x: batch, step, head
  long long sdb, sds, sdh;  // of dt
  long long sbb, sbs, sbg;  // of B: batch, step, group
  long long scb, scs, scg;  // of C
  int S, nh, ng, N, Q;
  int nc, tpg;     // chunks; out_kernel head tiles per group
  int QP;          // Q rounded up to 16
};

// ---------------------------------------------------------------------------
// float32: the first design
// ---------------------------------------------------------------------------

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

template <int HD>
__global__ void __launch_bounds__(NT) ssd_f32_kernel(Args a) {
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
  const float* xp = static_cast<const float*>(a.x) + bb * a.sxb + h * a.sxh;
  const float* dtp = a.dt + bb * a.sdb + h * a.sdh;
  const float* bp = static_cast<const float*>(a.b) + bb * a.sbb + g * a.sbg;
  const float* cp = static_cast<const float*>(a.c) + bb * a.scb + g * a.scg;
  float* yp = static_cast<float*>(a.y) +
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
      Bs[j * NP + n] = bp[(t0 + j) * a.sbs + n];
    }
    for (int i = tid; i < Q * HD; i += NT) {
      const int j = i / HD, d = i % HD;
      Xs[j * HP + d] = xp[(t0 + j) * a.sxs + d] * dts[j];
    }
    __syncthreads();
    if (a.st) {  // the backward's residuals: this chunk's entering state
                 // (hd × N, plain f32) and cum
      const long long slot =
          (static_cast<long long>(bb) * a.nc + t0 / Q) * a.nh + h;
      float* sp = a.st + slot * HD * N;
      for (int i = tid; i < HD * N; i += NT) sp[i] = Hs[(i % N) * HP + i / N];
      for (int j = tid; j < Q; j += NT) a.cum[slot * Q + j] = cum[j];
    }
    const float seg = cum[Q - 1];
    for (int j = tid; j < Q; j += NT) {
      ec[j] = expf(cum[j]);
      dec[j] = expf(seg - cum[j]);
    }

    for (int r0 = 0; r0 < Q; r0 += R) {
      for (int i = tid; i < R * N; i += NT) {
        const int r = i / N, n = i % N;
        Cs[r * NP + n] = r0 + r < Q ? cp[(t0 + r0 + r) * a.scs + n] : 0.f;
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
            float* out = yp + (t0 + i) * ys + 4 * d4;
            out[0] = yi[k].x + yh[k].x * e;
            out[1] = yi[k].y + yh[k].y * e;
            out[2] = yi[k].z + yh[k].z * e;
            out[3] = yi[k].w + yh[k].w * e;
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

// ---------------------------------------------------------------------------
// PTX helpers: ldmatrix, mma.sync, cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8×8 bf16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8, and receives (row l / 4, columns 2(l % 4), +1) of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, transposed: lane l receives (rows 2(l % 4), +1, column l / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a·b on a 16×8 tile, depth 16, bf16 in, f32 accumulated
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The transpose of an 8×8 bf16 matrix held as in ldmatrix's result (lane
// l: row l / 4, columns 2(l % 4), +1): lane l receives the same entries
// of the transposed matrix.
__device__ __forceinline__ uint32_t movm(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(r)
               : "r"(v));
  return r;
}

// ---------------------------------------------------------------------------
// end of PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (a0, a1) = hi + lo, each a bf16 pair (a0 in the low half): hi is the
// rounded value, lo the rounded remainder, so hi + lo carries 16 bits
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a0 - hf.x, a1 - hf.y));
}

// The tile of heads an out_kernel block serves: group g, first head h0,
// nT heads.
struct Tile {
  int g, h0, nT;
};

__device__ __forceinline__ Tile head_tile(const Args& a) {
  const int rep = a.nh / a.ng;
  Tile t;
  t.g = blockIdx.x / a.tpg;
  t.h0 = t.g * rep + (blockIdx.x % a.tpg) * OUT_HEADS;
  t.nT = min(OUT_HEADS, (t.g + 1) * rep - t.h0);
  return t;
}

// Copy `rows` global rows of n bf16 (n a multiple of 4; row stride ss
// elements) into shared rows of stride sp, 16 bytes a copy (8 when n is
// not a multiple of 8).  The published state size takes constant shifts.
__device__ __forceinline__ void stage_rows(bf16* dst, int sp, const bf16* src,
                                           long long ss, int rows, int n) {
  if (n == NMAX) {
    for (int i = threadIdx.x; i < rows * (NMAX / 8); i += NT) {
      const int j = i / (NMAX / 8), k = i % (NMAX / 8);
      cp_async16(dst + j * sp + 8 * k, src + j * ss + 8 * k);
    }
  } else if (n % 8 == 0) {
    const int k8 = n / 8;
    for (int i = threadIdx.x; i < rows * k8; i += NT) {
      const int j = i / k8, k = i % k8;
      cp_async16(dst + j * sp + 8 * k, src + j * ss + 8 * k);
    }
  } else {
    const int k4 = n / 4;
    for (int i = threadIdx.x; i < rows * k4; i += NT) {
      const int j = i / k4, k = i % k4;
      cp_async8(dst + j * sp + 4 * k, src + j * ss + 4 * k);
    }
  }
}

// Zero rows [q, qp) of a staged bf16 tile and, in rows [0, q), its
// columns [n, w).
__device__ __forceinline__ void zero_pad(bf16* tile, int sp, int q, int qp,
                                         int n, int w) {
  uint16_t* t = reinterpret_cast<uint16_t*>(tile);
  for (int i = threadIdx.x; i < (qp - q) * w; i += NT)
    t[(q + i / w) * sp + i % w] = 0;
  const int e = w - n;
  if (e > 0)
    for (int i = threadIdx.x; i < q * e; i += NT) t[(i / e) * sp + n + i % e] = 0;
}

constexpr int BW = NMAX + 8;  // row stride (bf16) of staged B tiles

// Bytes of scan_kernel's shared memory, for R state rows: B (two buffers,
// QMAX × BW bf16), the R columns of x (two buffers, QMAX × (R+8) bf16),
// dt and w (two buffers each, QMAX f32) and exp(seg) (two).  Rows are
// padded by 16 bytes, so ldmatrix's eight rows fall in distinct banks.
__host__ __device__ constexpr size_t scan_smem(int rows) {
  return 4 * static_cast<size_t>(QMAX) * BW +
         4 * static_cast<size_t>(QMAX) * (rows + 8) + 16 * QMAX + 16;
}

// cum of one chunk by one warp: lane l sums steps 4l .. 4l+3 of dt·A in
// order, a warp scan adds the lanes before it.  Writes w = dt·exp(seg −
// cum) (0 past Q) and exp(seg), and cum to global when `cg` is set.
__device__ __forceinline__ void chunk_cum(const float* ds, float A, int Q,
                                          float* ws, float* es, float* cg) {
  const int lane = threadIdx.x & 31;
  float dtv[4], cs[4];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dtv[k] = ds[4 * lane + k];  // 0 past Q
    sum += dtv[k] * A;
    cs[k] = sum;
  }
  float incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float excl = incl - sum;
  const int last = Q - 1;
  const float c3 = (last & 3) == 0   ? cs[0]
                   : (last & 3) == 1 ? cs[1]
                   : (last & 3) == 2 ? cs[2]
                                     : cs[3];
  const float seg = __shfl_sync(0xffffffffu, excl + c3, last >> 2);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * lane + k;
    const float cj = excl + cs[k];
    if (j < Q && cg) cg[j] = cj;
    ws[j] = j < Q ? dtv[k] * expf(seg - cj) : 0.f;
  }
  if (lane == 0) *es = expf(seg);
}

// One block per (R state rows, head, batch) walks the chunks in order,
// the state rows H (R × N, f32) in the MMA accumulators: per chunk
// H ← H·exp(seg) + (x ⊙ dt·exp(seg − cum))ᵀ·B on the tensor cores, then
// H_in[c+1] = H goes to scratch in the accumulators' fragment order, the
// one out_kernel reads its B operand in: the (b, c+1, h) slot holds, per
// 16-row tile and n-tile of 8, 16 bytes a lane (bf16 hi of its rows g
// and g+8, then lo), a 512-byte store a warp; the last H is h_final.
// A software pipeline keeps the chain to one barrier a chunk: B and x
// are copied in one chunk ahead and dt two (cp.async), one warp forms
// the next chunk's cum and w while the others start this chunk's
// products, each warp forms its x·w fragments in registers, and the MMA
// loop runs unrolled over a chunk of QMAX steps (zero past Q) with
// separate accumulators for the hi and lo products.  cum goes to scratch
// from the block of rows 0: the one copy out_kernel reads.
template <int HD, int R>
__global__ void __launch_bounds__(NT) scan_kernel(Args a) {
  constexpr int XP = R + 8;        // x and x·w row stride (bf16)
  constexpr int MT = R / 16;       // 16-row tiles of H
  constexpr int NTW = 2 * MT;      // n-tiles (of 8) per warp
  extern __shared__ float4 smem4[];
  const int N = a.N, Q = a.Q, nc = a.nc;
  bf16* Bs = reinterpret_cast<bf16*>(smem4);
  bf16* Xs = Bs + 2 * QMAX * BW;
  float* Ds = reinterpret_cast<float*>(Xs + 2 * QMAX * XP);
  float* Ws = Ds + 2 * QMAX;
  float* Es = Ws + 2 * QMAX;

  const int h = blockIdx.y, bb = blockIdx.z, d0 = blockIdx.x * R;
  const int g = h / (a.nh / a.ng);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, tq = lane & 3;
  const bf16* bsrc = static_cast<const bf16*>(a.b) + bb * a.sbb + g * a.sbg;
  const bf16* xsrc =
      static_cast<const bf16*>(a.x) + bb * a.sxb + h * a.sxh + d0;
  const float* dsrc = a.dt + bb * a.sdb + h * a.sdh;
  const float A = a.A[h];
  const int n8 = (N + 7) / 8;  // n-tiles of the state
  const long long slot = static_cast<long long>(HD) * 8 * n8;
  float* cum0 = a.cum + (static_cast<long long>(bb) * nc * a.nh + h) * Q;
  const long long cums = static_cast<long long>(a.nh) * Q;  // per chunk

  for (int buf = 0; buf < 2; ++buf) {  // pads: cp.async never writes them
    zero_pad(Bs + buf * QMAX * BW, BW, Q, QMAX, N, NMAX);
    zero_pad(Xs + buf * QMAX * XP, XP, Q, QMAX, R, R);
  }
  for (int j = Q + tid; j < QMAX; j += NT) Ds[j] = Ds[QMAX + j] = 0.f;

  auto load_bx = [&](int c) {  // B and x of chunk c
    const long long t0 = static_cast<long long>(c) * Q;
    const int buf = c & 1;
    stage_rows(Bs + buf * QMAX * BW, BW, bsrc + t0 * a.sbs, a.sbs, Q, N);
    bf16* xs = Xs + buf * QMAX * XP;
    for (int i = tid; i < Q * (R / 8); i += NT) {
      const int j = i / (R / 8), k = i % (R / 8);
      cp_async16(xs + j * XP + 8 * k, xsrc + (t0 + j) * a.sxs + 8 * k);
    }
  };
  auto load_dt = [&](int c) {
    const long long t0 = static_cast<long long>(c) * Q;
    for (int j = tid; j < Q; j += NT)
      cp_async4(Ds + (c & 1) * QMAX + j, dsrc + (t0 + j) * a.sds);
  };

  load_dt(0);
  cp_async_commit();
  load_bx(0);
  if (nc > 1) load_dt(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (warp == 0) chunk_cum(Ds, A, Q, Ws, Es, d0 == 0 ? cum0 : nullptr);

  const int mt = warp % MT, nt0 = (warp / MT) * NTW, r0 = 16 * mt + g4;
  float ah[NTW][4], al[NTW][4];  // H = ah + al: the hi and lo products
#pragma unroll
  for (int s = 0; s < NTW; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) ah[s][e] = al[s][e] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    cp_async_wait<0>();
    __syncthreads();  // B, x of chunk c, dt of c+1, w of c are in; the
                      // buffers of chunk c − 1 are free
    if (c + 1 < nc) load_bx(c + 1);
    if (c + 2 < nc) load_dt(c + 2);
    cp_async_commit();
    if (warp == NT / 32 - 1 && c + 1 < nc)  // the next chunk's cum and w
      chunk_cum(Ds + (buf ^ 1) * QMAX, A, Q, Ws + (buf ^ 1) * QMAX,
                Es + (buf ^ 1), d0 == 0 ? cum0 + (c + 1) * cums : nullptr);
    const float es = Es[buf];
#pragma unroll
    for (int s = 0; s < NTW; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[s][e] *= es;
        al[s][e] *= es;
      }
    const bf16* bs = Bs + buf * QMAX * BW;
    const bf16* xs = Xs + buf * QMAX * XP;
    const float* ws = Ws + buf * QMAX;
#pragma unroll
    for (int k0 = 0; k0 < QMAX; k0 += 16) {
      // A = (x ⊙ w)ᵀ: x fragments by ldmatrix.trans, times w, split
      uint32_t xa[4], fh[4], fl[4], bq[NTW / 2][4];
      ldsm_x4_t(xa, xs + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * XP +
                        16 * mt + ((lane >> 3) & 1) * 8);
      const float2 w0 = *reinterpret_cast<const float2*>(ws + k0 + 2 * tq);
      const float2 w8 = *reinterpret_cast<const float2*>(ws + k0 + 8 + 2 * tq);
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // fragments 0, 1: steps 2tq, +1; 2, 3: +8
        const float2 xv = unpack(xa[r]);
        const float2 wv = r < 2 ? w0 : w8;
        split2(xv.x * wv.x, xv.y * wv.y, fh[r], fl[r]);
      }
#pragma unroll
      for (int q = 0; q < NTW / 2; ++q)
        ldsm_x4_t(bq[q], bs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * BW +
                             8 * (nt0 + 2 * q) + (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < NTW / 2; ++q) {
        mma_bf16(ah[2 * q], fh, bq[q][0], bq[q][1]);
        mma_bf16(ah[2 * q + 1], fh, bq[q][2], bq[q][3]);
        mma_bf16(al[2 * q], fl, bq[q][0], bq[q][1]);
        mma_bf16(al[2 * q + 1], fl, bq[q][2], bq[q][3]);
      }
    }
    if (c + 1 < nc) {  // H_in[c+1], this warp's tiles in fragment order
      uint4* hg = reinterpret_cast<uint4*>(
                      a.st + ((static_cast<long long>(bb) * nc + c + 1) * a.nh +
                              h) * slot) + (d0 / 16 + mt) * n8 * 32 + lane;
#pragma unroll
      for (int s = 0; s < NTW; ++s) {
        if (nt0 + s >= n8) break;  // warp-uniform
        uint32_t h01, l01, h23, l23;
        split2(ah[s][0] + al[s][0], ah[s][1] + al[s][1], h01, l01);
        split2(ah[s][2] + al[s][2], ah[s][3] + al[s][3], h23, l23);
        hg[(nt0 + s) * 32] = make_uint4(h01, h23, l01, l23);
      }
    }
  }
  float* hp = a.h + ((static_cast<long long>(bb) * a.nh + h) * HD + d0) * N;
#pragma unroll
  for (int s = 0; s < NTW; ++s) {
    const int n = 8 * (nt0 + s) + 2 * tq;
    if (n >= N) continue;
    *reinterpret_cast<float2*>(hp + r0 * N + n) =
        make_float2(ah[s][0] + al[s][0], ah[s][1] + al[s][1]);
    *reinterpret_cast<float2*>(hp + (r0 + 8) * N + n) =
        make_float2(ah[s][2] + al[s][2], ah[s][3] + al[s][3]);
  }
}

// Bytes of out_kernel's shared memory, two blocks to an SM:
//   one region that holds B (QP × BW bf16) until C·Bᵀ is formed, then a
//   head's H_in (in scan_kernel's fragment order, HD/16 × NMAX/8 tiles of
//   512 bytes);
//   G (RB(RB+1) 16×8 tiles in fragment order, RB = QP/16: a float4 per
//   lane and tile);
//   x, two buffers (QP × (HD+8) bf16; a head's y is staged in its x
//   buffer once P·x has read it);
//   of OUT_HEADS heads: cum, dt·exp(cum_b − cum) with b the last step of the
//   16-step block, and dt (QP f32 each).
__host__ __device__ constexpr size_t bh_bytes(int HD, int QP) {
  return 2 * static_cast<size_t>(QP) * BW > 4 * static_cast<size_t>(HD) * NMAX
             ? 2 * static_cast<size_t>(QP) * BW
             : 4 * static_cast<size_t>(HD) * NMAX;
}

__host__ __device__ constexpr size_t out_smem(int HD, int QP) {
  return bh_bytes(HD, QP) +
         16 * 32 * static_cast<size_t>(QP / 16) * (QP / 16 + 1) +
         4 * static_cast<size_t>(QP) * (HD + 8) +
         3 * 4 * static_cast<size_t>(OUT_HEADS) * QP;
}

// P·x over this warp's column blocks: P = G ⊙ exp(cum_i − cum_j) ⊙ dt_j,
// split into hi + lo, two MMAs per n-tile of y.
template <int DT>
__device__ __forceinline__ void p_mma(float (&acc)[DT][4], const float4& ga,
                                      const float4& gb, float pa0, float pa1,
                                      float pa2, float pa3, float pb0,
                                      float pb1, float pb2, float pb3,
                                      const uint32_t (&xb)[DT / 2][4]) {
  uint32_t ahi[4], alo[4];
  split2(ga.x * pa0, ga.y * pa1, ahi[0], alo[0]);
  split2(ga.z * pa2, ga.w * pa3, ahi[1], alo[1]);
  split2(gb.x * pb0, gb.y * pb1, ahi[2], alo[2]);
  split2(gb.z * pb2, gb.w * pb3, ahi[3], alo[3]);
#pragma unroll
  for (int q = 0; q < DT / 2; ++q) {
    mma_bf16(acc[2 * q], ahi, xb[q][0], xb[q][1]);
    mma_bf16(acc[2 * q + 1], ahi, xb[q][2], xb[q][3]);
  }
#pragma unroll
  for (int q = 0; q < DT / 2; ++q) {
    mma_bf16(acc[2 * q], alo, xb[q][0], xb[q][1]);
    mma_bf16(acc[2 * q + 1], alo, xb[q][2], xb[q][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 2) out_kernel(Args a) {
  constexpr int XP = HD + 8;   // x and y staging row stride (bf16)
  constexpr int DT = HD / 8;   // n-tiles of y's head dims
  constexpr int KMAX = NMAX / 16;
  extern __shared__ float4 smem4[];
  const int N = a.N, Q = a.Q, QP = a.QP;
  const int RB = QP / 16;
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  bf16* Bs = reinterpret_cast<bf16*>(base);       // then H_in
  uint4* Hf = reinterpret_cast<uint4*>(base);     // H_in's fragments
  float4* Gs = reinterpret_cast<float4*>(base + bh_bytes(HD, QP));
  bf16* Xs = reinterpret_cast<bf16*>(Gs + 32 * RB * (RB + 1));  // two
  float* Cm = reinterpret_cast<float*>(Xs + 2 * QP * XP);
  float* Dm = Cm + OUT_HEADS * QP;
  float* Tm = Dm + OUT_HEADS * QP;

  const Tile tl = head_tile(a);
  const int c = blockIdx.y, bb = blockIdx.z, t0 = c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, tq = lane & 3;
  const int n8 = (N + 7) / 8;  // n-tiles of the state
  const long long slot = static_cast<long long>(HD) * 8 * n8;

  auto load_x = [&](int t) {  // head t's x, into buffer t & 1
    const bf16* xg = static_cast<const bf16*>(a.x) + bb * a.sxb + t0 * a.sxs +
                     (tl.h0 + t) * a.sxh;
    bf16* xs = Xs + (t & 1) * QP * XP;
    for (int i = tid; i < Q * (HD / 8); i += NT) {
      const int j = i / (HD / 8), k = i % (HD / 8);
      cp_async16(xs + j * XP + 8 * k, xg + j * a.sxs + 8 * k);
    }
  };
  auto load_h = [&](int t) {  // head t's H_in, into the B region (c > 0);
    if (c == 0) return;       // its n-tiles past N (N < NMAX) are zero
    const uint4* hg = reinterpret_cast<const uint4*>(
        a.st + ((static_cast<long long>(bb) * a.nc + c) * a.nh + tl.h0 + t) *
                   slot);
    if (n8 == NMAX / 8) {
      for (int i = tid; i < HD / 16 * (NMAX / 8) * 32; i += NT)
        cp_async16(Hf + i, hg + i);
    } else {
      for (int i = tid; i < HD / 16 * (NMAX / 8) * 32; i += NT) {
        const int mt = i / ((NMAX / 8) * 32), nt = (i / 32) % (NMAX / 8);
        if (nt < n8)
          cp_async16(Hf + i, hg + (mt * n8 + nt) * 32 + i % 32);
        else
          Hf[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  zero_pad(Bs, BW, Q, QP, N, NMAX);
  zero_pad(Xs, XP, Q, QP, HD, HD);
  zero_pad(Xs + QP * XP, XP, Q, QP, HD, HD);
  stage_rows(Bs, BW,
             static_cast<const bf16*>(a.b) + bb * a.sbb + t0 * a.sbs +
                 tl.g * a.sbg,
             a.sbs, Q, N);
  load_x(0);
  cp_async_commit();
  for (int i = tid; i < tl.nT * QP; i += NT) {
    const int t = i / QP, j = i % QP, h = tl.h0 + t;
    float cv = 0.f, dv = 0.f, tv = 0.f;
    if (j < Q) {
      const float* cg =
          a.cum + ((static_cast<long long>(bb) * a.nc + c) * a.nh + h) * Q;
      cv = cg[j];
      tv = a.dt[bb * a.sdb + (t0 + j) * a.sds + h * a.sdh];
      dv = tv * expf(cg[min(j | 15, Q - 1)] - cv);
    }
    Cm[t * QP + j] = cv;
    Dm[t * QP + j] = dv;
    Tm[t * QP + j] = tv;
  }

  // this warp's 16 rows of C as A fragments, over all of N
  const int i0 = 16 * warp + g4;
  uint32_t cr[KMAX][4];
  {
    const bf16* cg = static_cast<const bf16*>(a.c) + bb * a.scb +
                     t0 * a.scs + tl.g * a.scg;
#pragma unroll
    for (int ks = 0; ks < KMAX; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + (r & 1) * 8, n = 16 * ks + 2 * tq + (r >> 1) * 8;
        cr[ks][r] = (warp < RB && i < Q && n < N)
                        ? *reinterpret_cast<const uint32_t*>(cg + i * a.scs + n)
                        : 0u;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // G = C·Bᵀ: row block `warp`, column blocks p ≤ warp (two n-tiles
  // each), two column blocks at a time
  float4* gw = Gs + 32 * warp * (warp + 1) + lane;
  if (warp < RB) {
    const int bo = ((lane & 7) + ((lane >> 4) & 1) * 8) * BW +
                   ((lane >> 3) & 1) * 8;
    int p = 0;
    for (; p + 1 <= warp; p += 2) {
      float g[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < KMAX; ++ks) {
        uint32_t b0[4], b1[4];
        ldsm_x4(b0, Bs + 16 * p * BW + bo + 16 * ks);
        ldsm_x4(b1, Bs + 16 * (p + 1) * BW + bo + 16 * ks);
        mma_bf16(g[0], cr[ks], b0[0], b0[1]);
        mma_bf16(g[1], cr[ks], b0[2], b0[3]);
        mma_bf16(g[2], cr[ks], b1[0], b1[1]);
        mma_bf16(g[3], cr[ks], b1[2], b1[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        gw[32 * (2 * p + k)] = make_float4(g[k][0], g[k][1], g[k][2], g[k][3]);
    }
    if (p <= warp) {
      float g[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KMAX; ++ks) {
        uint32_t b0[4];
        ldsm_x4(b0, Bs + 16 * p * BW + bo + 16 * ks);
        mma_bf16(g[0], cr[ks], b0[0], b0[1]);
        mma_bf16(g[1], cr[ks], b0[2], b0[3]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k)
        gw[32 * (2 * p + k)] = make_float4(g[k][0], g[k][1], g[k][2], g[k][3]);
    }
  }

  __syncthreads();  // B is no longer read: the first head's H_in may land
  load_h(0);
  cp_async_commit();

  for (int t = 0; t < tl.nT; ++t) {
    const int h = tl.h0 + t;
    const bf16* xs = Xs + (t & 1) * QP * XP;
    cp_async_wait<0>();
    __syncthreads();  // this head's x and H_in have landed; the last
                      // head's y staging is read
    float acc[DT][4];
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    if (warp < RB && c > 0) {  // exp(cum) ⊙ (C·H_inᵀ); H_in is 0 before chunk 1
      {
        // rows d of H_in are this product's columns: the fragment of
        // 16-row tile q and n-tiles 2ks, 2ks+1 is the B operand of y's
        // n-tiles 2q (rows g) and 2q + 1 (rows g + 8) at depth step ks
#pragma unroll
        for (int ks = 0; ks < KMAX; ++ks) {
          uint4 f0[DT / 2], f1[DT / 2];
#pragma unroll
          for (int q = 0; q < DT / 2; ++q) {
            f0[q] = Hf[(q * (NMAX / 8) + 2 * ks) * 32 + lane];
            f1[q] = Hf[(q * (NMAX / 8) + 2 * ks + 1) * 32 + lane];
          }
#pragma unroll
          for (int q = 0; q < DT / 2; ++q) {  // hi
            mma_bf16(acc[2 * q], cr[ks], f0[q].x, f1[q].x);
            mma_bf16(acc[2 * q + 1], cr[ks], f0[q].y, f1[q].y);
          }
#pragma unroll
          for (int q = 0; q < DT / 2; ++q) {  // lo
            mma_bf16(acc[2 * q], cr[ks], f0[q].z, f1[q].z);
            mma_bf16(acc[2 * q + 1], cr[ks], f0[q].w, f1[q].w);
          }
        }
        const float e0 = expf(Cm[t * QP + i0]), e8 = expf(Cm[t * QP + i0 + 8]);
#pragma unroll
        for (int nt = 0; nt < DT; ++nt) {
          acc[nt][0] *= e0;
          acc[nt][1] *= e0;
          acc[nt][2] *= e8;
          acc[nt][3] *= e8;
        }
      }
    }
    __syncthreads();  // H_in is read: the next head's x and H_in may land
    if (t + 1 < tl.nT) {  // the next head's x and H_in land during P·x
      load_x(t + 1);
      load_h(t + 1);
    }
    cp_async_commit();
    if (warp < RB) {
      const float* cm = Cm + t * QP;
      const float* dm = Dm + t * QP;
      const float* tm = Tm + t * QP;
      const float ci0 = cm[i0], ci8 = cm[i0 + 8];

      // + P·x.  Below the diagonal block, exp(cum_i − cum_j) =
      // exp(cum_i − cum_b)·exp(cum_b − cum_j) with b the last step of
      // column block p: two factors ≤ 1, the second (times dt_j) staged
      // per head, the first two exps a lane per block (__expf: its error,
      // ≈ 1e-6 relative at a chunk's decays, is far below y's bf16
      // rounding).
      const int xo = ((lane & 7) + ((lane >> 3) & 1) * 8) * XP + (lane >> 4) * 8;
      for (int p = 0; p <= warp; ++p) {
        uint32_t xb[DT / 2][4];
#pragma unroll
        for (int q = 0; q < DT / 2; ++q)
          ldsm_x4_t(xb[q], xs + 16 * p * XP + xo + 16 * q);
        const float4 ga = gw[32 * (2 * p)], gb = gw[32 * (2 * p + 1)];
        const int j0 = 16 * p + 2 * tq;
        if (p < warp) {
          const float cb = cm[min(16 * p + 15, Q - 1)];
          const float r0 = __expf(ci0 - cb), r8 = __expf(ci8 - cb);
          const float2 d0 = *reinterpret_cast<const float2*>(dm + j0);
          const float2 d8 = *reinterpret_cast<const float2*>(dm + j0 + 8);
          p_mma<DT>(acc, ga, gb, r0 * d0.x, r0 * d0.y, r8 * d0.x, r8 * d0.y,
                    r0 * d8.x, r0 * d8.y, r8 * d8.x, r8 * d8.y, xb);
        } else {  // the diagonal block: exp formed at i ≥ j only
          const float2 c0 = *reinterpret_cast<const float2*>(cm + j0);
          const float2 c8 = *reinterpret_cast<const float2*>(cm + j0 + 8);
          const float2 t0v = *reinterpret_cast<const float2*>(tm + j0);
          const float2 t8v = *reinterpret_cast<const float2*>(tm + j0 + 8);
          // selected, never multiplied: above the diagonal the argument
          // is clamped to 0 and the product replaced by 0
          auto l = [](bool on, float ci, float cj, float dtj) {
            const float v = __expf(fminf(ci - cj, 0.f)) * dtj;
            return on ? v : 0.f;
          };
          p_mma<DT>(acc, ga, gb, l(j0 <= i0, ci0, c0.x, t0v.x),
                    l(j0 + 1 <= i0, ci0, c0.y, t0v.y),
                    l(j0 <= i0 + 8, ci8, c0.x, t0v.x),
                    l(j0 + 1 <= i0 + 8, ci8, c0.y, t0v.y),
                    l(j0 + 8 <= i0, ci0, c8.x, t8v.x),
                    l(j0 + 9 <= i0, ci0, c8.y, t8v.y),
                    l(j0 + 8 <= i0 + 8, ci8, c8.x, t8v.x),
                    l(j0 + 9 <= i0 + 8, ci8, c8.y, t8v.y), xb);
        }
      }
    }
    __syncthreads();  // x is read: y is staged in its buffer
    if (warp < RB) {  // y: rounded once, staged, stored as 16-byte rows
      bf16* ys = Xs + (t & 1) * QP * XP + warp * 16 * XP;
#pragma unroll
      for (int nt = 0; nt < DT; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(ys + g4 * XP + 8 * nt + 2 * tq) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(ys + (g4 + 8) * XP + 8 * nt +
                                           2 * tq) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      }
      __syncwarp();
      bf16* yg = static_cast<bf16*>(a.y) +
                 ((static_cast<long long>(bb) * a.S + t0) * a.nh + h) * HD;
      const long long ysz = static_cast<long long>(a.nh) * HD;
#pragma unroll
      for (int k = 0; k < (16 * DT + 31) / 32; ++k) {
        const int v = lane + 32 * k, r = v / DT, ch = v % DT;
        const int i = 16 * warp + r;
        if (v < 16 * DT && i < Q)
          *reinterpret_cast<uint4*>(yg + i * ysz + 8 * ch) =
              *reinterpret_cast<const uint4*>(ys + r * XP + 8 * ch);
      }
    }
  }
}

template <int HD, int R>
cudaError_t launch_bf16(Args a, int B, cudaStream_t s) {
  const size_t s1 = scan_smem(R);
  const size_t s3 = out_smem(HD, a.QP);
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<HD, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(out_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s3));
  if (e != cudaSuccess) return e;
  scan_kernel<HD, R><<<dim3(HD / R, a.nh, B), NT, s1, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  out_kernel<HD><<<dim3(a.ng * a.tpg, a.nc, B), NT, s3, s>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats(HD, a.N, a.Q);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(a.nh, B);
  ssd_f32_kernel<HD><<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward: the VJP of the chunked SSD (ssd_chunked's, which the
// reference gets from XLA's autodiff).  First the float32 route, on the
// CUDA cores; then the bfloat16 route, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TS = 32;  // rows of a strip and of a tile of the Q × Q duals

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  const void* dy;
  const float* cum;  // the forward's (B, nc, nh, Q) prefix sums
  const float* st;   // its entering states (Args::st's layout, by `split`)
  const float* dh;   // (B, nh, hd, N) cotangent of h_final, or null (zeros)
  void* dx;          // (B, S, nh, hd) in x's dtype
  float* ddt;        // (B, S, nh); first Σ_d dxdt·x, then the whole ddt
  float* dA;         // (nh,)
  void* db;          // (B, S, ng, N) in B's dtype
  void* dc;
  // float32 scratch.  Both routes:
  float* gst;   // dL/dH of the state each chunk leaves: float32 (B, nc,
                // nh, hd, N) plain; bfloat16 hi + lo in st's fragment order
  // the float32 route's:
  float* hdot;  // (B, nc, nh, hd/16): <H_in, gst> per 16 state rows
  float* dbh;   // (B, S, nh, N): dB and dC of each head, before the sum
  float* dch;   //   over a group's heads
  float* dcr;   // (B, nc, nh, Q): dcum from the rows of L and from y_inter
  float* dcc;   //   from the columns of L and from the state a chunk leaves
  float* sgp;   //   that last term again, for dseg
  // the bfloat16 route's:
  float* dap;   // (B, nc, nh): Σ ddA·dt over each chunk
  float* dbp;   // (B, S, ng, tpg, N): dB and dC summed over each tile of
  float* dcp;   //   BWD_HEADS heads, before the sum over a group's tiles
  long long sxb, sxs, sxh;  // element strides of x: batch, step, head
  long long sdb, sds, sdh;  // of dt
  long long sbb, sbs, sbg;  // of B: batch, step, group
  long long scb, scs, scg;  // of C
  long long syb, sys, syh;  // of dy
  int B, S, nh, ng, N, Q, nc, split;
  int tpg;   // bfloat16: bwd_chunk_kernel head tiles per group
};

// acc + a·b, four fused multiply-adds in order
__device__ __forceinline__ float dot4(float acc, const float4& a,
                                      const float4& b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// (row, column) of a flat index over rows of n columns, advanced by NT
__device__ __forceinline__ void step_index(int& row, int& col, int n) {
  col += NT % n;
  row += NT / n;
  if (col >= n) {
    col -= n;
    ++row;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Sum over the 8 lanes of an aligned group (lanes 8k .. 8k+7), a fixed
// butterfly: every lane of the group gets the same bits.
__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

__device__ __forceinline__ float sum32(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element (d, n) of the state entering the chunk of `slot` ((b·nc + c)·nh
// + h), float32 (B, nc, nh, hd, N).
template <int HD>
__device__ __forceinline__ float state_at(const BwdArgs& a, long long slot,
                                          int d, int n) {
  return a.st[(slot * HD + d) * a.N + n];
}

// Bytes of bwd_state_kernel's shared memory: a chunk's C rows (Q × (N+4))
// and its dy·exp(cum) for the block's 16 state rows (Q × 16), f32.
__host__ __device__ constexpr size_t state_smem(int N, int Q) {
  return 4 * (static_cast<size_t>(Q) * (N + 4) + static_cast<size_t>(Q) * 16);
}

// The state gradient, chunks in reverse: one block per (16 state rows,
// head, batch) holds its rows of G = dL/dH (16 × N) in registers, thread
// (warp w, lane q) rows w and w + 8, columns 4q .. 4q+3.  G starts at
// dh (or 0) for the state the last chunk leaves; per chunk c it is
// written to gst, its inner product with the state entering c goes to
// hdot, and then G ← exp(seg_c)·G + Σ_i exp(cum_i) dy_i ⊗ C_i.
template <int HD>
__global__ void __launch_bounds__(NT) bwd_state_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ float red[NT / 32];
  const int N = a.N, Q = a.Q, NP = N + 4;
  float* Cs = reinterpret_cast<float*>(smem4);
  float* Ys = Cs + Q * NP;
  const int rb = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int d0 = 16 * rb, g = h / (a.nh / a.ng);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = d0 + warp, r1 = r0 + 8, n = 4 * lane;
  const bool on = n < N;
  const float* cp = static_cast<const float*>(a.c) + bb * a.scb + g * a.scg;
  const float* yp =
      static_cast<const float*>(a.dy) + bb * a.syb + h * a.syh + d0;
  float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0;
  if (a.dh && on) {
    const float* dp = a.dh + (static_cast<long long>(bb) * a.nh + h) * HD * N;
    g0 = ld4(dp + r0 * N + n);
    g1 = ld4(dp + r1 * N + n);
  }
  for (int c = a.nc - 1; c >= 0; --c) {
    const long long slot = (static_cast<long long>(bb) * a.nc + c) * a.nh + h;
    if (on) {
      float* gp = a.gst + slot * HD * N;
      *reinterpret_cast<float4*>(gp + r0 * N + n) = g0;
      *reinterpret_cast<float4*>(gp + r1 * N + n) = g1;
    }
    float part = 0.f;  // <H_in, G> over this thread's 8 elements
    if (c > 0 && on) {
      const float e0[4] = {g0.x, g0.y, g0.z, g0.w};
      const float e1[4] = {g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        part += state_at<HD>(a, slot, r0, n + k) * e0[k] +
                state_at<HD>(a, slot, r1, n + k) * e1[k];
    }
    part = sum32(part);
    __syncthreads();  // red and the last chunk's tiles are no longer read
    if (lane == 0) red[warp] = part;
    const float* cg = a.cum + slot * Q;
    if (c > 0) {
      const long long t0 = static_cast<long long>(c) * Q;
      for (int i = tid, j = tid / N, k = tid % N; i < Q * N; i += NT) {
        Cs[j * NP + k] = cp[(t0 + j) * a.scs + k];
        step_index(j, k, N);
      }
      for (int i = tid; i < Q * 16; i += NT) {
        const int j = i / 16, r = i % 16;
        Ys[i] = yp[(t0 + j) * a.sys + r] * expf(cg[j]);
      }
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < NT / 32; ++w) s += red[w];
      a.hdot[slot * (HD / 16) + rb] = s;
    }
    if (c == 0) break;
    if (on) {
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
      for (int j = 0; j < Q; ++j) {
        const float4 cv = ld4(Cs + j * NP + n);
        const float y0 = Ys[j * 16 + warp], y1 = Ys[j * 16 + warp + 8];
        fma4(y0, cv, a0);
        fma4(y1, cv, a1);
      }
      const float es = expf(cg[Q - 1]);
      g0 = make_float4(g0.x * es + a0.x, g0.y * es + a0.y, g0.z * es + a0.z,
                       g0.w * es + a0.w);
      g1 = make_float4(g1.x * es + a1.x, g1.y * es + a1.y, g1.z * es + a1.z,
                       g1.w * es + a1.w);
    }
  }
}

// Floats of bwd_strip_kernel's shared memory: the own strip's N-wide and
// hd-wide rows (TS × (N+4), TS × (HD+4)); a region holding first the
// state matrix (HD × (N+4)), then the other side's tile (TS × (N+4),
// TS × (HD+4)) and the S and D tiles (TS × (TS+1) each); cum and dt.
__host__ __device__ constexpr size_t strip_region(int HD, int N) {
  return static_cast<size_t>(HD) * (N + 4) >
                 static_cast<size_t>(TS) * (N + 4 + HD + 4 + 2 * (TS + 1))
             ? static_cast<size_t>(HD) * (N + 4)
             : static_cast<size_t>(TS) * (N + 4 + HD + 4 + 2 * (TS + 1));
}

__host__ __device__ constexpr size_t strip_smem(int HD, int N) {
  return 4 * (static_cast<size_t>(TS) * (N + 4 + HD + 4) +
              strip_region(HD, N) + 2 * QMAX);
}

// One strip of TS rows of one (chunk, head, batch).  COLS false: the
// strip holds steps i (C, dy: "own"), the tiles walk steps j ≤ i (B and
// x·dt: "other"), and the strip's dC (per head) and its dcum terms come
// out.  COLS true: the strip holds steps j (B, x·dt), the tiles walk
// i ≥ j (C, dy), and dB (per head), dxdt (→ dx and Σ_d dxdt·x) and the
// dcum terms come out.  Per tile, in f32:
//   S = (own_N · other_Nᵀ) ⊙ L,  dsc = own_hd · other_hdᵀ   (= dy_i·xdt_j)
//   D = dsc ⊙ L,  M = dsc ⊙ S,   L = exp(cum_i − cum_j)·[i ≥ j] (selected)
//   own dN += D · other_N;  COLS: dxdt += S · dy
// first seeded by the state terms, with Hm the state entering the chunk
// (rows) or the gradient of the one it leaves (cols):
//   dN = e ⊙ (own_hd · Hm),  COLS: dxdt = e ⊙ (B · Hmᵀ),
//   e = exp(cum_i) (rows) or exp(seg − cum_j) (cols).
// Thread (r, l) = (tid / 8, tid % 8) owns strip row r: columns 4(l + 8k)
// .. +3 of dN, head dims l + 8k of dxdt, tile entries (r, l + 8k); every
// sum runs in a fixed order (no atomics).
template <int HD, bool COLS>
__device__ __forceinline__ void strip_body(const BwdArgs& a, int c,
                                           int strip) {
  constexpr int HP = HD + 4, TP = TS + 1;
  constexpr int NQ = NMAX / 32;  // float4 columns of dN per thread
  constexpr int DK = HD / 8;     // head dims of dxdt per thread
  extern __shared__ float4 smem4[];
  const int N = a.N, Q = a.Q, NP = N + 4;
  float* Po = reinterpret_cast<float*>(smem4);
  float* Qo = Po + TS * NP;
  float* Hm = Qo + TS * HP;
  float* Pt = Hm;
  float* Qt = Pt + TS * NP;
  float* St = Qt + TS * HP;
  float* Dt = St + TS * TP;
  float* cm = Hm + strip_region(HD, N);
  float* dtm = cm + QMAX;

  const int h = blockIdx.y, bb = blockIdx.z, g = h / (a.nh / a.ng);
  const int tid = threadIdx.x, r = tid >> 3, l8 = tid & 7;
  const long long t0 = static_cast<long long>(c) * Q;
  const int o0 = strip * TS, no = min(TS, Q - o0);
  const long long slot = (static_cast<long long>(bb) * a.nc + c) * a.nh + h;
  const float* xp = static_cast<const float*>(a.x) + bb * a.sxb + h * a.sxh;
  const float* yp = static_cast<const float*>(a.dy) + bb * a.syb + h * a.syh;
  const float* bp = static_cast<const float*>(a.b) + bb * a.sbb + g * a.sbg;
  const float* cp = static_cast<const float*>(a.c) + bb * a.scb + g * a.scg;
  const float* pn = COLS ? bp : cp;  // the own side's N-wide rows
  const float* qn = COLS ? cp : bp;  // the other side's
  const long long spn = COLS ? a.sbs : a.scs, sqn = COLS ? a.scs : a.sbs;

  for (int j = tid; j < Q; j += NT) {
    cm[j] = a.cum[slot * Q + j];
    dtm[j] = a.dt[bb * a.sdb + (t0 + j) * a.sds + h * a.sdh];
  }
  __syncthreads();
  // rows [p0, p0 + np) of x·dt (hd) or dy into dst, zero up to TS rows
  auto stage_hd = [&](float* dst, bool xdt, int p0, int np) {
    for (int i = tid; i < TS * HD; i += NT) {
      const int q = i / HD, d = i % HD;
      float v = 0.f;
      if (q < np)
        v = xdt ? xp[(t0 + p0 + q) * a.sxs + d] * dtm[p0 + q]
                : yp[(t0 + p0 + q) * a.sys + d];
      dst[q * HP + d] = v;
    }
  };
  auto stage_n = [&](float* dst, const float* src, long long ss, int p0,
                     int np) {
    for (int i = tid, q = tid / N, k = tid % N; i < TS * N; i += NT) {
      dst[q * NP + k] = q < np ? src[(t0 + p0 + q) * ss + k] : 0.f;
      step_index(q, k, N);
    }
  };
  stage_n(Po, pn, spn, o0, no);
  stage_hd(Qo, COLS, o0, no);
  for (int i = tid; i < HD * N; i += NT) {
    const int d = i / N, k = i % N;
    Hm[d * NP + k] = COLS ? a.gst[slot * HD * N + i]
                          : (c > 0 ? state_at<HD>(a, slot, d, k) : 0.f);
  }
  __syncthreads();

  // the state terms
  const bool mine = r < no;
  const float e = mine ? expf(COLS ? cm[Q - 1] - cm[o0 + r] : cm[o0 + r])
                       : 0.f;
  float4 an[NQ];
  float ah[DK];
#pragma unroll
  for (int k = 0; k < NQ; ++k) an[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < DK; ++k) ah[k] = 0.f;
  for (int d = 0; d < HD; ++d) {
    const float cf = Qo[r * HP + d];
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int n = 4 * (l8 + 8 * k);
      if (n < N) {
        fma4(cf, ld4(Hm + d * NP + n), an[k]);
      }
    }
  }
  float stt = 0.f;  // own_N · (state part of dN)
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const int n = 4 * (l8 + 8 * k);
    an[k].x *= e; an[k].y *= e; an[k].z *= e; an[k].w *= e;
    if (n < N) stt = dot4(stt, ld4(Po + r * NP + n), an[k]);
  }
  stt = sum8(stt);
  if (COLS) {
    for (int n = 0; n < N; n += 4) {
      const float4 pv = ld4(Po + r * NP + n);
#pragma unroll
      for (int k = 0; k < DK; ++k)
        ah[k] = dot4(ah[k], pv, ld4(Hm + (l8 + 8 * k) * NP + n));
    }
#pragma unroll
    for (int k = 0; k < DK; ++k) ah[k] *= e;
  }
  __syncthreads();  // Hm is no longer read: the tiles may overwrite it

  float msum = 0.f;
  const int p_end = COLS ? Q : o0 + 1;
  for (int p0 = COLS ? o0 : 0; p0 < p_end; p0 += TS) {
    const int np = min(TS, Q - p0);
    stage_n(Pt, qn, sqn, p0, np);
    stage_hd(Qt, !COLS, p0, np);
    __syncthreads();
    float sv[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int n = 0; n < N; n += 4) {
      const float4 pv = ld4(Po + r * NP + n);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sv[k] = dot4(sv[k], pv, ld4(Pt + (l8 + 8 * k) * NP + n));
    }
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = ld4(Qo + r * HP + d);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dv[k] = dot4(dv[k], qv, ld4(Qt + (l8 + 8 * k) * HP + d));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ok = l8 + 8 * k, o = p0 + ok, w = o0 + r;
      const int i = COLS ? o : w, j = COLS ? w : o;
      const bool on = mine && ok < np && i >= j;
      // selected, never multiplied: above the diagonal the exp overflows
      const float L = on ? expf(cm[i] - cm[j]) : 0.f;
      const float s = on ? sv[k] * L : 0.f;
      const float m = on ? dv[k] * s : 0.f;
      msum += m;
      St[r * TP + ok] = s;
      Dt[r * TP + ok] = on ? dv[k] * L : 0.f;
    }
    __syncthreads();
    for (int o = 0; o < np; ++o) {
      const float dd = Dt[r * TP + o];
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        const int n = 4 * (l8 + 8 * k);
        if (n < N) fma4(dd, ld4(Pt + o * NP + n), an[k]);
      }
      if (COLS) {
        const float ss = St[r * TP + o];
#pragma unroll
        for (int k = 0; k < DK; ++k)
          ah[k] = fmaf(ss, Qt[o * HP + l8 + 8 * k], ah[k]);
      }
    }
    __syncthreads();  // the tiles are read: the next may land
  }
  msum = sum8(msum);

  const int w = o0 + r;
  const long long t = t0 + w;
  if (mine) {
    float* dn = (COLS ? a.dbh : a.dch) +
                ((static_cast<long long>(bb) * a.S + t) * a.nh + h) * N;
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int n = 4 * (l8 + 8 * k);
      if (n < N) *reinterpret_cast<float4*>(dn + n) = an[k];
    }
  }
  if (COLS) {
    float xd = 0.f;
    if (mine) {
      float* dxp = static_cast<float*>(a.dx) +
               ((static_cast<long long>(bb) * a.S + t) * a.nh + h) * HD;
      const float dtw = dtm[w];
#pragma unroll
      for (int k = 0; k < DK; ++k) {
        const int d = l8 + 8 * k;
        dxp[d] = ah[k] * dtw;
        xd += ah[k] * xp[t * a.sxs + d];
      }
    }
    xd = sum8(xd);
    if (mine && l8 == 0) {
      a.ddt[(static_cast<long long>(bb) * a.S + t) * a.nh + h] = xd;
      a.dcc[slot * Q + w] = -msum - stt;
      a.sgp[slot * Q + w] = stt;
    }
  } else if (mine && l8 == 0) {
    a.dcr[slot * Q + w] = msum + stt;
  }
}

// blockIdx.x = (chunk · 2 + side) · strips + strip: each chunk's row and
// column strips.
template <int HD>
__global__ void __launch_bounds__(NT) bwd_strip_kernel(BwdArgs a) {
  const int ns = (a.Q + TS - 1) / TS;
  const int c = blockIdx.x / (2 * ns), side = (blockIdx.x / ns) % 2;
  if (side) strip_body<HD, true>(a, c, blockIdx.x % ns);
  else strip_body<HD, false>(a, c, blockIdx.x % ns);
}

// Blocks [0, nh): one per head.  Each warp takes chunks w, w + 8, ... of
// the (batch, chunk) pairs in order: dcum = rows + columns, plus dseg =
// Σ sgp + exp(seg)·Σ hdot at the chunk's last step; ddA = its reverse
// cumulative sum (each lane 4 steps, then a warp scan); ddt += ddA·A and
// the chunk's Σ ddA·dt, added per warp in chunk order, then over the
// warps in order into dA.  Blocks [nh, ...): dB and dC, each element the
// sum of its group's heads in head order, rounded once.
__global__ void __launch_bounds__(NT) bwd_finish_kernel(BwdArgs a, int hd) {
  __shared__ float wsum[NT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, N = a.N;
  if (blockIdx.x < a.nh) {
    const int h = blockIdx.x;
    const float A = a.A[h];
    float acc = 0.f;
    for (int k = warp; k < a.B * a.nc; k += NT / 32) {
      const int bb = k / a.nc, c = k % a.nc;
      const long long slot = static_cast<long long>(k) * a.nh + h;
      const long long base = slot * Q;
      float v[4], sg = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        v[e] = j < Q ? a.dcr[base + j] + a.dcc[base + j] : 0.f;
        sg += j < Q ? a.sgp[base + j] : 0.f;
      }
      sg = sum32(sg);
      float hs = 0.f;
      for (int rb = 0; rb < hd / 16; ++rb) hs += a.hdot[slot * (hd / 16) + rb];
      const float dseg = sg + expf(a.cum[base + Q - 1]) * hs;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * lane + e == Q - 1) v[e] += dseg;
      float s[4];
      s[3] = v[3];
      s[2] = v[2] + s[3];
      s[1] = v[1] + s[2];
      s[0] = v[0] + s[1];
      float incl = s[0];
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += u;
      }
      const float after = incl - s[0];  // the lanes above this one
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        if (j < Q) {
          const float dd = s[e] + after;
          const long long t = static_cast<long long>(c) * Q + j;
          float* p = a.ddt + (static_cast<long long>(bb) * a.S + t) * a.nh + h;
          *p = dd * A + *p;
          part += dd * a.dt[bb * a.sdb + t * a.sds + h * a.sdh];
        }
      }
      acc += sum32(part);
    }
    if (lane == 0) wsum[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < NT / 32; ++w) s += wsum[w];
      a.dA[h] = s;
    }
    return;
  }
  const int rep = a.nh / a.ng;
  const long long per = static_cast<long long>(a.B) * a.S * a.ng * N;
  for (long long i = (blockIdx.x - a.nh) * static_cast<long long>(NT) + tid;
       i < 2 * per; i += static_cast<long long>(gridDim.x - a.nh) * NT) {
    const bool isc = i >= per;
    const long long e = isc ? i - per : i;
    const long long bs = e / (a.ng * N);
    const int gg = static_cast<int>((e / N) % a.ng);
    const int n = static_cast<int>(e % N);
    const float* src = (isc ? a.dch : a.dbh) + (bs * a.nh + gg * rep) * N + n;
    float s = 0.f;
    for (int k = 0; k < rep; ++k) s += src[static_cast<long long>(k) * N];
    static_cast<float*>(isc ? a.dc : a.db)[e] = s;
  }
}

// ---------------------------------------------------------------------------
// The backward in bfloat16: on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// heads per bwd_chunk_kernel block (a group's last tile may hold fewer) and
// state rows per bwd_gscan_kernel block (hd when it is smaller): the
// fastest of 2, 3, 4 heads and 16, 32, 64 rows at mamba2-780m's training
// shape on the H100 (PERF.md §6, the SSD backward redesign's findings)
constexpr int BWD_HEADS = 3;
constexpr int BWD_ROWS = 64;

// Bytes of bwd_gscan_kernel's shared memory for R state rows: C (two
// buffers, QMAX × BW bf16), the R columns of dy (two, QMAX × (R+8) bf16)
// and cum (two, QMAX f32).
__host__ __device__ constexpr size_t gscan_smem(int rows) {
  return 4 * static_cast<size_t>(QMAX) * BW +
         4 * static_cast<size_t>(QMAX) * (rows + 8) + 8 * QMAX;
}

// The state gradient, chunks in reverse: one block per (R state rows,
// head, batch) holds its rows of G = dL/dH (R × N, f32) in its MMA
// accumulators, as scan_kernel holds the forward's state.  G starts at
// dh (or 0) for the state the last chunk leaves; per chunk c it goes to
// gst as bf16 hi + lo in st's fragment order (16 bytes a lane and
// tile), and then G ← exp(seg_c)·G + (dy ⊙ exp(cum))ᵀ·C on the tensor
// cores: C an exact operand, dy·exp(cum) split into hi + lo, the hi and
// lo products in separate accumulators.  The chunk before's C, dy and
// cum are copied in (cp.async) while this chunk's products run.
template <int HD, int R>
__global__ void __launch_bounds__(NT) bwd_gscan_kernel(BwdArgs a) {
  constexpr int YP = R + 8;   // dy row stride (bf16)
  constexpr int MT = R / 16;  // 16-row tiles of G
  constexpr int NTW = 2 * MT; // n-tiles (of 8) per warp
  extern __shared__ float4 smem4[];
  const int N = a.N, Q = a.Q, nc = a.nc;
  bf16* Cs = reinterpret_cast<bf16*>(smem4);
  bf16* Ys = Cs + 2 * QMAX * BW;
  float* Ms = reinterpret_cast<float*>(Ys + 2 * QMAX * YP);

  const int h = blockIdx.y, bb = blockIdx.z, d0 = blockIdx.x * R;
  const int g = h / (a.nh / a.ng);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, tq = lane & 3;
  const bf16* csrc = static_cast<const bf16*>(a.c) + bb * a.scb + g * a.scg;
  const bf16* ysrc =
      static_cast<const bf16*>(a.dy) + bb * a.syb + h * a.syh + d0;
  const float* cum0 = a.cum + (static_cast<long long>(bb) * nc * a.nh + h) * Q;
  const long long cums = static_cast<long long>(a.nh) * Q;  // per chunk
  const int n8 = (N + 7) / 8;  // n-tiles of the state
  const long long slot4 = static_cast<long long>(HD) * 2 * n8;  // uint4s

  for (int buf = 0; buf < 2; ++buf) {  // pads: cp.async never writes them
    zero_pad(Cs + buf * QMAX * BW, BW, Q, QMAX, N, NMAX);
    zero_pad(Ys + buf * QMAX * YP, YP, Q, QMAX, R, R);
  }
  for (int j = Q + tid; j < QMAX; j += NT) Ms[j] = Ms[QMAX + j] = 0.f;

  auto load = [&](int c) {  // C, dy and cum of chunk c
    const long long t0 = static_cast<long long>(c) * Q;
    const int buf = c & 1;
    stage_rows(Cs + buf * QMAX * BW, BW, csrc + t0 * a.scs, a.scs, Q, N);
    bf16* ys = Ys + buf * QMAX * YP;
    for (int i = tid; i < Q * (R / 8); i += NT) {
      const int j = i / (R / 8), k = i % (R / 8);
      cp_async16(ys + j * YP + 8 * k, ysrc + (t0 + j) * a.sys + 8 * k);
    }
    for (int j = tid; j < Q; j += NT)
      cp_async4(Ms + buf * QMAX + j, cum0 + c * cums + j);
  };

  const int mt = warp % MT, nt0 = (warp / MT) * NTW, r0 = 16 * mt + g4;
  float gh[NTW][4], gl[NTW][4];  // G = gh + gl: the hi and lo products
#pragma unroll
  for (int s = 0; s < NTW; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) gh[s][e] = gl[s][e] = 0.f;
  if (a.dh) {
    const float* dp =
        a.dh + ((static_cast<long long>(bb) * a.nh + h) * HD + d0) * N;
#pragma unroll
    for (int s = 0; s < NTW; ++s) {
      const int n = 8 * (nt0 + s) + 2 * tq;
      if (n >= N) continue;
      gh[s][0] = dp[r0 * N + n];
      gh[s][1] = dp[r0 * N + n + 1];
      gh[s][2] = dp[(r0 + 8) * N + n];
      gh[s][3] = dp[(r0 + 8) * N + n + 1];
    }
  }

  load(nc - 1);
  cp_async_commit();
  uint4* gg = reinterpret_cast<uint4*>(a.gst);
  for (int c = nc - 1; c >= 0; --c) {
    const int buf = c & 1;
    cp_async_wait<0>();
    __syncthreads();  // C, dy, cum of chunk c are in; those of c + 1 are
                      // no longer read
    if (c > 0) load(c - 1);
    cp_async_commit();
    // G_c: this warp's tiles in fragment order
    const long long slot = (static_cast<long long>(bb) * nc + c) * a.nh + h;
    const long long fo = slot * slot4 + (d0 / 16 + mt) * n8 * 32 + lane;
#pragma unroll
    for (int s = 0; s < NTW; ++s) {
      if (nt0 + s >= n8) break;  // warp-uniform
      uint32_t h01, l01, h23, l23;
      split2(gh[s][0] + gl[s][0], gh[s][1] + gl[s][1], h01, l01);
      split2(gh[s][2] + gl[s][2], gh[s][3] + gl[s][3], h23, l23);
      gg[fo + (nt0 + s) * 32] = make_uint4(h01, h23, l01, l23);
    }
    if (c == 0) break;

    const float* cm = Ms + buf * QMAX;
    const float es = expf(cm[Q - 1]);
#pragma unroll
    for (int s = 0; s < NTW; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gh[s][e] *= es;
        gl[s][e] *= es;
      }
    const bf16* cs = Cs + buf * QMAX * BW;
    const bf16* ys = Ys + buf * QMAX * YP;
#pragma unroll
    for (int k0 = 0; k0 < QMAX; k0 += 16) {
      // A = (dy ⊙ exp(cum))ᵀ: dy fragments by ldmatrix.trans, times
      // exp(cum) (__expf: its ≈ 1e-6 relative error is far below the
      // split's; dy's pad rows are 0), split
      uint32_t ya[4], fh[4], fl[4], bq[NTW / 2][4];
      ldsm_x4_t(ya, ys + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * YP +
                        16 * mt + ((lane >> 3) & 1) * 8);
      const float2 c0 = *reinterpret_cast<const float2*>(cm + k0 + 2 * tq);
      const float2 c8 = *reinterpret_cast<const float2*>(cm + k0 + 8 + 2 * tq);
      const float w0 = __expf(c0.x), w1 = __expf(c0.y);
      const float w8 = __expf(c8.x), w9 = __expf(c8.y);
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // fragments 0, 1: steps 2tq, +1; 2, 3: +8
        const float2 yv = unpack(ya[r]);
        split2(yv.x * (r < 2 ? w0 : w8), yv.y * (r < 2 ? w1 : w9), fh[r],
               fl[r]);
      }
#pragma unroll
      for (int q = 0; q < NTW / 2; ++q)
        ldsm_x4_t(bq[q], cs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * BW +
                             8 * (nt0 + 2 * q) + (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < NTW / 2; ++q) {
        mma_bf16(gh[2 * q], fh, bq[q][0], bq[q][1]);
        mma_bf16(gh[2 * q + 1], fh, bq[q][2], bq[q][3]);
        mma_bf16(gl[2 * q], fl, bq[q][0], bq[q][1]);
        mma_bf16(gl[2 * q + 1], fl, bq[q][2], bq[q][3]);
      }
    }
  }
}

// Index of the 16×16 tile (J, I), J ≤ I < 8, in a triangle stored row by
// row: rows J of 8 − J tiles.
__device__ __forceinline__ int tri(int J, int I) {
  return J * 8 - J * (J - 1) / 2 + (I - J);
}
constexpr int TRI = 36;  // tiles of the triangle

// Bytes of bwd_chunk_kernel's shared memory, one block to an SM:
//   C and B (QMAX × BW bf16 each; rows past Q and columns past N zero);
//   x and dy of one head (QMAX × (HD+8) bf16 each);
//   CBᵀ = B·Cᵀ over the tiles (J, I ≥ J), f32 in fragment order (two
//   float4 a lane and tile);
//   G_c and H_c of one head in st's fragment order (HD/16 × NMAX/8 tiles
//   of 512 bytes each);
//   D over the tiles (J, I ≥ J), bf16 A fragments of rows i (a uint4 a
//   lane and tile);
//   the sums of M over each tile's rows (16 f32 a tile); cum, dt,
//   Σ_d dxdt·x and dcum of one head (QMAX f32 each); B·dB_state and
//   <H_c, G_c> per warp (8 f32 each).  At hd 64: 231,744 bytes.
__host__ __device__ constexpr size_t chunk_smem(int HD) {
  return 4 * static_cast<size_t>(QMAX) * BW +
         4 * static_cast<size_t>(QMAX) * (HD + 8) + 1024 * TRI +
         8 * static_cast<size_t>(HD) * NMAX + 512 * TRI + 64 * TRI +
         16 * QMAX + 64;
}

// Four n-tiles of a state product with the transposed state fragments
// hf: th + tl = A·H over depth KD·16, n-tiles 4u .. 4u + 3, the hi and lo
// products in separate accumulators.
template <int KD>
__device__ __forceinline__ void state_group(float (&th)[4][4],
                                            float (&tl)[4][4],
                                            const uint32_t (&af)[KD][4],
                                            const uint4* hf, int u,
                                            int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) th[k][e] = tl[k][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) {
    uint4 f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = hf[(ks * (NMAX / 8) + 4 * u + k) * 32 + lane];
#pragma unroll
    for (int k = 0; k < 4; ++k) mma_bf16(th[k], af[ks], f[k].x, f[k].y);
#pragma unroll
    for (int k = 0; k < 4; ++k) mma_bf16(tl[k], af[ks], f[k].z, f[k].w);
  }
}

// Transpose the state fragments of hf in place, warp by warp over its
// tiles: st's order (rows d, column pairs n: the B operand of a product
// over n) becomes that of the B operand of a product over d.
template <int HD>
__device__ __forceinline__ void transpose_state(uint4* hf, int warp,
                                                int lane) {
  for (int t = warp; t < HD / 16 * (NMAX / 8); t += NT / 32) {
    const uint4 v = hf[t * 32 + lane];
    hf[t * 32 + lane] = make_uint4(movm(v.x), movm(v.y), movm(v.z), movm(v.w));
  }
}

// One block per (tile of BWD_HEADS heads of one group, chunk, batch), one
// to an SM: C·Bᵀ is formed once for the tile (as CBᵀ, the tiles (J, I ≥ J)
// of 16 steps, in shared memory), then per head, with x, dy, dt, cum, the
// state gradient G_c and the entering state H_c of that head staged:
//   phase 1, the warp of column block J (j ∈ J):
//     dxdt_j = exp(seg − cum_j)·B_j·G_cᵀ and dB_j += exp(seg − cum_j) dt_j
//     x_j·G_c (G_c split, x and B exact; B·dB_state for dcum);
//     then over the tiles (J, I ≥ J) of the chunk's duals, each formed
//     once: dscᵀ = x_J·dy_Iᵀ (exact), L = exp(cum_i − cum_j)·[i ≥ j]
//     (selected, never multiplied), Dᵀ = dt_j dscᵀ ⊙ L, Sᵀ = CBᵀ ⊙ L,
//     M = Dᵀ ⊙ CBᵀ (its row and column sums), dB_J += Dᵀ·C_I (D rounded
//     once), dxdt_J += Sᵀ·dy_I (S split), and D itself (movmatrix) into
//     shared memory for phase 2;
//     dx = dxdt·dt, Σ_d dxdt·x;
//   phase 2, the warp of row block I (i ∈ I, the same block):
//     dC_i += exp(cum_i)·dy_i·H_c (H_c split, dy exact; C·dC_state for
//     dcum) + Σ_{J ≤ I} D_IJ·B_J;
//   then dcum (M's rows and columns, the state terms, dseg = Σ B·dB_state
//   + exp(seg)·<H_c, G_c> at the last step), its reverse scan into ddt
//   and the chunk's Σ ddA·dt, by warp 0.
// Warps w and w + 4 share a scheduler: they take blocks w and 7 − w, so
// that each pair has 9 tiles in either phase.  The next head's x and G_c
// land during phase 2, its dy, H_c, cum and dt during phase 1's first
// product.  dB and dC are summed over the tile's heads in the warps'
// accumulators, in head order, and written once per tile; bwd_sum_kernel
// adds the tiles in order.  The state products over d take the state
// fragments transposed in place (transpose_state).
template <int HD>
__global__ void __launch_bounds__(NT, 1) bwd_chunk_kernel(BwdArgs a) {
  constexpr int XP = HD + 8;      // x and dy row stride (bf16)
  constexpr int KD = HD / 16;     // depth steps over d
  constexpr int DT = HD / 8;      // n-tiles over d
  constexpr int NT8 = NMAX / 8;   // n-tiles over n
  constexpr int KN = NMAX / 16;   // depth steps over n
  constexpr int SF = HD / 16 * NT8 * 32;  // uint4s of a staged state
  extern __shared__ float4 smem4[];
  const int N = a.N, Q = a.Q, nc = a.nc;
  const int RB = (Q + 15) / 16;
  bf16* Cs = reinterpret_cast<bf16*>(smem4);
  bf16* Bs = Cs + QMAX * BW;
  bf16* Xs = Bs + QMAX * BW;
  bf16* Ys = Xs + QMAX * XP;
  float4* CBt = reinterpret_cast<float4*>(Ys + QMAX * XP);
  uint4* Gf = reinterpret_cast<uint4*>(CBt + 64 * TRI);
  uint4* Hf = Gf + SF;
  uint4* Dm = Hf + SF;
  float* Rs = reinterpret_cast<float*>(Dm + 32 * TRI);
  float* Cv = Rs + 16 * TRI;
  float* Tv = Cv + QMAX;
  float* Xd = Tv + QMAX;
  float* Dc = Xd + QMAX;
  float* Sp = Dc + QMAX;
  float* Hd = Sp + NT / 32;

  const int rep = a.nh / a.ng;
  const int g = blockIdx.x / a.tpg, kt = blockIdx.x % a.tpg;
  const int h0 = g * rep + kt * BWD_HEADS;
  const int nT = min(BWD_HEADS, (g + 1) * rep - h0);
  const int c = blockIdx.y, bb = blockIdx.z;
  const long long t0 = static_cast<long long>(c) * Q;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // uniform
  const int blk = warp < 4 ? warp : 11 - warp;  // this warp's 16-row block
  const int g4 = lane >> 2, tq = lane & 3;
  const int n8 = (N + 7) / 8;
  const long long slot4 = static_cast<long long>(HD) * 2 * n8;  // uint4s
  const int r0 = 16 * blk + g4, r1 = r0 + 8;  // this lane's rows

  auto load_state = [&](uint4* dst, const float* src, long long slot) {
    const uint4* fg = reinterpret_cast<const uint4*>(src) + slot * slot4;
    for (int i = tid; i < SF; i += NT) {
      const int mt = i / (NT8 * 32), nt = (i / 32) % NT8;
      if (nt < n8)
        cp_async16(dst + i, fg + (mt * n8 + nt) * 32 + i % 32);
      else
        dst[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto slot_of = [&](int t) {
    return (static_cast<long long>(bb) * nc + c) * a.nh + h0 + t;
  };
  auto load_xg = [&](int t) {  // x and G_c of head t
    const bf16* xg = static_cast<const bf16*>(a.x) + bb * a.sxb +
                     t0 * a.sxs + (h0 + t) * a.sxh;
    for (int i = tid; i < Q * (HD / 8); i += NT) {
      const int j = i / (HD / 8), k = i % (HD / 8);
      cp_async16(Xs + j * XP + 8 * k, xg + j * a.sxs + 8 * k);
    }
    load_state(Gf, a.gst, slot_of(t));
  };
  auto load_rest = [&](int t) {  // dy, cum, dt and H_c of head t
    const int h = h0 + t;
    const bf16* yg = static_cast<const bf16*>(a.dy) + bb * a.syb +
                     t0 * a.sys + h * a.syh;
    for (int i = tid; i < Q * (HD / 8); i += NT) {
      const int j = i / (HD / 8), k = i % (HD / 8);
      cp_async16(Ys + j * XP + 8 * k, yg + j * a.sys + 8 * k);
    }
    for (int j = tid; j < Q; j += NT) {
      cp_async4(Cv + j, a.cum + slot_of(t) * Q + j);
      cp_async4(Tv + j, a.dt + bb * a.sdb + (t0 + j) * a.sds + h * a.sdh);
    }
    if (c > 0) load_state(Hf, a.st, slot_of(t));  // H_c is 0 in chunk 0
  };

  zero_pad(Cs, BW, Q, QMAX, N, NMAX);
  zero_pad(Bs, BW, Q, QMAX, N, NMAX);
  zero_pad(Xs, XP, Q, QMAX, HD, HD);
  zero_pad(Ys, XP, Q, QMAX, HD, HD);
  for (int j = Q + tid; j < QMAX; j += NT) Cv[j] = Tv[j] = 0.f;
  stage_rows(Cs, BW,
             static_cast<const bf16*>(a.c) + bb * a.scb + t0 * a.scs +
                 g * a.scg,
             a.scs, Q, N);
  stage_rows(Bs, BW,
             static_cast<const bf16*>(a.b) + bb * a.sbb + t0 * a.sbs +
                 g * a.sbg,
             a.sbs, Q, N);
  cp_async_commit();
  load_xg(0);
  cp_async_commit();
  load_rest(0);
  cp_async_commit();
  float Ah[BWD_HEADS];  // the tile's decay rates, read ahead
#pragma unroll
  for (int t = 0; t < BWD_HEADS; ++t) Ah[t] = t < nT ? a.A[h0 + t] : 0.f;
  cp_async_wait<2>();
  __syncthreads();  // C and B are in: C·Bᵀ is formed while head 0's data
                    // lands

  // ldmatrix row offsets: A fragments (rows of a 16-row block, 16
  // columns), B fragments of a product over the row's columns (two
  // n-tiles of 8 rows), and B fragments of a product over the rows
  // (ldmatrix.trans: two n-tiles of 8 columns)
  const int ra = lane & 15, ca = (lane >> 4) * 8;
  const int rb = (lane & 7) + ((lane >> 4) & 1) * 8, cb = ((lane >> 3) & 1) * 8;
  const int rt = (lane & 7) + ((lane >> 3) & 1) * 8, ct = (lane >> 4) * 8;

  // CBᵀ = B·Cᵀ: the warp of block J forms the tiles (J, I ≥ J) it alone
  // reads
  if (blk < RB) {
    for (int I = blk; I < RB; ++I) {
      float cbt[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        uint32_t af[4], bq[4];
        ldsm_x4(af, Bs + (16 * blk + ra) * BW + 16 * ks + ca);
        ldsm_x4(bq, Cs + (16 * I + rb) * BW + 16 * ks + cb);
        mma_bf16(cbt[0], af, bq[0], bq[1]);
        mma_bf16(cbt[1], af, bq[2], bq[3]);
      }
      float4* out = CBt + 64 * tri(blk, I) + lane;
      out[0] = make_float4(cbt[0][0], cbt[0][1], cbt[0][2], cbt[0][3]);
      out[32] = make_float4(cbt[1][0], cbt[1][1], cbt[1][2], cbt[1][3]);
    }
  }

  float accB[NT8][4], accC[NT8][4];  // dB_J, dC_I summed over the heads
#pragma unroll
  for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) accB[nt][e] = accC[nt][e] = 0.f;

  for (int t = 0; t < nT; ++t) {
    const int h = h0 + t;
    const long long slot = slot_of(t);
    cp_async_wait<1>();
    __syncthreads();  // head t's x and G_c have landed
    float dxa[DT][4];  // dxdt of rows j
#pragma unroll
    for (int nt = 0; nt < DT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dxa[nt][e] = 0.f;

    // ---- phase 1, the warp of block J: B_J·G_cᵀ over G_c in st's order
    // (the fragment of 16-row tile q and n-tiles 2ks, 2ks+1 is the B
    // operand of dxdt's n-tiles 2q (rows g) and 2q + 1 (rows g + 8) at
    // depth step ks), while head t's dy, H_c, cum and dt land
    if (blk < RB) {
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, Bs + (16 * blk + ra) * BW + 16 * ks + ca);
        uint4 f0[KD], f1[KD];
#pragma unroll
        for (int q = 0; q < KD; ++q) {
          f0[q] = Gf[(q * NT8 + 2 * ks) * 32 + lane];
          f1[q] = Gf[(q * NT8 + 2 * ks + 1) * 32 + lane];
        }
#pragma unroll
        for (int q = 0; q < KD; ++q) {
          mma_bf16(dxa[2 * q], af, f0[q].x, f1[q].x);
          mma_bf16(dxa[2 * q + 1], af, f0[q].y, f1[q].y);
        }
#pragma unroll
        for (int q = 0; q < KD; ++q) {
          mma_bf16(dxa[2 * q], af, f0[q].z, f1[q].z);
          mma_bf16(dxa[2 * q + 1], af, f0[q].w, f1[q].w);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // dy, H_c, cum, dt are in; G_c in st's order is read
    transpose_state<HD>(Gf, warp, lane);
    if (c > 0) transpose_state<HD>(Hf, warp, lane);
    __syncthreads();
    {  // <H_c, G_c>, both as hi + lo, this thread's share, by warp
      float part = 0.f;
      if (c > 0)
        for (int i = tid; i < SF; i += NT) {
          const uint4 u = Gf[i], v = Hf[i];
          const uint32_t gu[4] = {u.x, u.y, u.z, u.w};
          const uint32_t hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float2 gh = unpack(gu[k]), gl = unpack(gu[k + 2]);
            const float2 hh = unpack(hv[k]), hl = unpack(hv[k + 2]);
            part += (gh.x + gl.x) * (hh.x + hl.x) + (gh.y + gl.y) * (hh.y + hl.y);
          }
        }
      part = sum32(part);
      if (lane == 0) Hd[warp] = part;
    }
    const float seg = Cv[Q - 1];
    const float cj0 = Cv[r0], cj1 = Cv[r1], tj0 = Tv[r0], tj1 = Tv[r1];
    float colp0 = 0.f, colp1 = 0.f;  // −Σ_i M_ij − B_j·dB_state_j
    if (blk < RB) {
      const int J = blk;
      const float eo0 = expf(seg - cj0), eo1 = expf(seg - cj1);
#pragma unroll
      for (int nt = 0; nt < DT; ++nt) {
        dxa[nt][0] *= eo0;
        dxa[nt][1] *= eo0;
        dxa[nt][2] *= eo1;
        dxa[nt][3] *= eo1;
      }
      // dB_state = exp(seg − cum_j) dt_j·x_j·G_c into dB, and B·dB_state
      uint32_t xf[KD][4];
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        ldsm_x4(xf[ks], Xs + (16 * J + ra) * XP + 16 * ks + ca);
      const float s0 = eo0 * tj0, s1 = eo1 * tj1;
      float st0 = 0.f, st1 = 0.f;
#pragma unroll
      for (int u = 0; u < NT8 / 4; ++u) {
        float th[4][4], tl[4][4];
        state_group<KD>(th, tl, xf, Gf, u, lane);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int nt = 4 * u + k, n = 8 * nt + 2 * tq;
          const float v0 = (th[k][0] + tl[k][0]) * s0;
          const float v1 = (th[k][1] + tl[k][1]) * s0;
          const float v2 = (th[k][2] + tl[k][2]) * s1;
          const float v3 = (th[k][3] + tl[k][3]) * s1;
          const float2 b0 =
              unpack(*reinterpret_cast<const uint32_t*>(Bs + r0 * BW + n));
          const float2 b1 =
              unpack(*reinterpret_cast<const uint32_t*>(Bs + r1 * BW + n));
          st0 += v0 * b0.x + v1 * b0.y;
          st1 += v2 * b1.x + v3 * b1.y;
          accB[nt][0] += v0;
          accB[nt][1] += v1;
          accB[nt][2] += v2;
          accB[nt][3] += v3;
        }
      }

      // the tiles (J, I ≥ J) of the chunk's duals, rows j, columns i
      float cs0 = 0.f, cs1 = 0.f;  // Σ_i M_ij of rows r0, r1
      for (int I = J; I < RB; ++I) {
        float sc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) {
          uint32_t bq[4];
          ldsm_x4(bq, Ys + (16 * I + rb) * XP + 16 * ks + cb);
          mma_bf16(sc[0], xf[ks], bq[0], bq[1]);
          mma_bf16(sc[1], xf[ks], bq[2], bq[3]);
        }
        const float4* cbp = CBt + 64 * tri(J, I) + lane;
        const float4 ga = cbp[0], gb = cbp[32];
        const float cbv[2][4] = {{ga.x, ga.y, ga.z, ga.w},
                                 {gb.x, gb.y, gb.z, gb.w}};
        float dv[2][4], sv[2][4], rs[2][2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int i = 16 * I + 8 * k + 2 * tq;
          const float2 ci = *reinterpret_cast<const float2*>(Cv + i);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ii = i + (e & 1), jj = e < 2 ? r0 : r1;
            const float cii = (e & 1) ? ci.y : ci.x;
            const float cjj = e < 2 ? cj0 : cj1, tjj = e < 2 ? tj0 : tj1;
            const bool on = ii >= jj && ii < Q;
            // selected, never multiplied: above the diagonal the exp
            // overflows (__expf: its ≈ 1e-6 relative error is far below
            // the split of S)
            const float L = on ? __expf(fminf(cii - cjj, 0.f)) : 0.f;
            const float d = on ? tjj * sc[k][e] * L : 0.f;
            dv[k][e] = d;
            sv[k][e] = on ? cbv[k][e] * L : 0.f;
            const float m = d * cbv[k][e];
            if (e < 2) cs0 += m; else cs1 += m;
            if (e < 2) rs[k][e] = m; else rs[k][e - 2] += m;
          }
        }
        // Dᵀ (rounded once) and Sᵀ (hi + lo) as A fragments of rows j
        uint32_t da[4], sh[4], sl[4];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          da[2 * k] = bits(__floats2bfloat162_rn(dv[k][0], dv[k][1]));
          da[2 * k + 1] = bits(__floats2bfloat162_rn(dv[k][2], dv[k][3]));
          split2(sv[k][0], sv[k][1], sh[2 * k], sl[2 * k]);
          split2(sv[k][2], sv[k][3], sh[2 * k + 1], sl[2 * k + 1]);
        }
        // dB_J += Dᵀ·C_I
#pragma unroll
        for (int q = 0; q < NT8 / 2; ++q) {
          uint32_t bq[4];
          ldsm_x4_t(bq, Cs + (16 * I + rt) * BW + 16 * q + ct);
          mma_bf16(accB[2 * q], da, bq[0], bq[1]);
          mma_bf16(accB[2 * q + 1], da, bq[2], bq[3]);
        }
        // dxdt_J += Sᵀ·dy_I
#pragma unroll
        for (int q = 0; q < DT / 2; ++q) {
          uint32_t bq[4];
          ldsm_x4_t(bq, Ys + (16 * I + rt) * XP + 16 * q + ct);
          mma_bf16(dxa[2 * q], sh, bq[0], bq[1]);
          mma_bf16(dxa[2 * q + 1], sh, bq[2], bq[3]);
          mma_bf16(dxa[2 * q], sl, bq[0], bq[1]);
          mma_bf16(dxa[2 * q + 1], sl, bq[2], bq[3]);
        }
        // D_IJ, rows i, for phase 2: the tile transposed
        Dm[32 * tri(J, I) + lane] =
            make_uint4(movm(da[0]), movm(da[2]), movm(da[1]), movm(da[3]));
        // Σ_j M_ij of this tile: over the lane's two rows, then its 8
        // row groups; lanes 0..3 hold columns 2tq, +1, +8, +9
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            float v = rs[k][p];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (g4 == 0) Rs[16 * tri(J, I) + 8 * k + 2 * tq + p] = v;
          }
      }
      // row totals over the lane's quad
      cs0 += __shfl_xor_sync(0xffffffffu, cs0, 1);
      cs0 += __shfl_xor_sync(0xffffffffu, cs0, 2);
      cs1 += __shfl_xor_sync(0xffffffffu, cs1, 1);
      cs1 += __shfl_xor_sync(0xffffffffu, cs1, 2);
      st0 += __shfl_xor_sync(0xffffffffu, st0, 1);
      st0 += __shfl_xor_sync(0xffffffffu, st0, 2);
      st1 += __shfl_xor_sync(0xffffffffu, st1, 1);
      st1 += __shfl_xor_sync(0xffffffffu, st1, 2);
      colp0 = -cs0 - st0;
      colp1 = -cs1 - st1;
      float sts = tq == 0 ? st0 + st1 : 0.f;  // Σ_j B_j·dB_state_j
      sts += __shfl_xor_sync(0xffffffffu, sts, 4);
      sts += __shfl_xor_sync(0xffffffffu, sts, 8);
      sts += __shfl_xor_sync(0xffffffffu, sts, 16);
      if (lane == 0) Sp[J] = sts;

      // dx = dxdt·dt (rounded once) and Σ_d dxdt·x
      bf16* dxp = static_cast<bf16*>(a.dx) +
                  ((static_cast<long long>(bb) * a.S + t0) * a.nh + h) * HD;
      const long long dxs = static_cast<long long>(a.nh) * HD;
      float xd0 = 0.f, xd1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < DT; ++nt) {
        const int d = 8 * nt + 2 * tq;
        const float2 x0 =
            unpack(*reinterpret_cast<const uint32_t*>(Xs + r0 * XP + d));
        const float2 x1 =
            unpack(*reinterpret_cast<const uint32_t*>(Xs + r1 * XP + d));
        xd0 += dxa[nt][0] * x0.x + dxa[nt][1] * x0.y;
        xd1 += dxa[nt][2] * x1.x + dxa[nt][3] * x1.y;
        if (r0 < Q)
          *reinterpret_cast<__nv_bfloat162*>(dxp + r0 * dxs + d) =
              __floats2bfloat162_rn(dxa[nt][0] * tj0, dxa[nt][1] * tj0);
        if (r1 < Q)
          *reinterpret_cast<__nv_bfloat162*>(dxp + r1 * dxs + d) =
              __floats2bfloat162_rn(dxa[nt][2] * tj1, dxa[nt][3] * tj1);
      }
      xd0 += __shfl_xor_sync(0xffffffffu, xd0, 1);
      xd0 += __shfl_xor_sync(0xffffffffu, xd0, 2);
      xd1 += __shfl_xor_sync(0xffffffffu, xd1, 1);
      xd1 += __shfl_xor_sync(0xffffffffu, xd1, 2);
      if (tq == 0) {
        Xd[r0] = xd0;
        Xd[r1] = xd1;
      }
    }
    __syncthreads();  // phase 1 is done: x and G_c are read
    if (t + 1 < nT) load_xg(t + 1);
    cp_async_commit();

    // ---- phase 2, the warp of block I
    if (blk < RB) {
      const int I = blk;
      float cd0 = 0.f, cd1 = 0.f;  // C_i·dC_state_i
      if (c > 0) {  // dC_state = exp(cum_i)·dy_i·H_c; H_c is 0 in chunk 0
        uint32_t yf[KD][4];
#pragma unroll
        for (int ks = 0; ks < KD; ++ks)
          ldsm_x4(yf[ks], Ys + (16 * I + ra) * XP + 16 * ks + ca);
        const float ei0 = expf(cj0), ei1 = expf(cj1);
#pragma unroll
        for (int u = 0; u < NT8 / 4; ++u) {
          float th[4][4], tl[4][4];
          state_group<KD>(th, tl, yf, Hf, u, lane);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int nt = 4 * u + k, n = 8 * nt + 2 * tq;
            const float v0 = (th[k][0] + tl[k][0]) * ei0;
            const float v1 = (th[k][1] + tl[k][1]) * ei0;
            const float v2 = (th[k][2] + tl[k][2]) * ei1;
            const float v3 = (th[k][3] + tl[k][3]) * ei1;
            const float2 c0 =
                unpack(*reinterpret_cast<const uint32_t*>(Cs + r0 * BW + n));
            const float2 c1 =
                unpack(*reinterpret_cast<const uint32_t*>(Cs + r1 * BW + n));
            cd0 += v0 * c0.x + v1 * c0.y;
            cd1 += v2 * c1.x + v3 * c1.y;
            accC[nt][0] += v0;
            accC[nt][1] += v1;
            accC[nt][2] += v2;
            accC[nt][3] += v3;
          }
        }
      }
      // dC_I += Σ_{J ≤ I} D_IJ·B_J
      for (int J = 0; J <= I; ++J) {
        const uint4 f = Dm[32 * tri(J, I) + lane];
        const uint32_t da[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int q = 0; q < NT8 / 2; ++q) {
          uint32_t bq[4];
          ldsm_x4_t(bq, Bs + (16 * J + rt) * BW + 16 * q + ct);
          mma_bf16(accC[2 * q], da, bq[0], bq[1]);
          mma_bf16(accC[2 * q + 1], da, bq[2], bq[3]);
        }
      }
      cd0 += __shfl_xor_sync(0xffffffffu, cd0, 1);
      cd0 += __shfl_xor_sync(0xffffffffu, cd0, 2);
      cd1 += __shfl_xor_sync(0xffffffffu, cd1, 1);
      cd1 += __shfl_xor_sync(0xffffffffu, cd1, 2);
      float rs0 = 0.f, rs1 = 0.f;  // Σ_j M_ij, column blocks in order
      for (int J = 0; J <= I; ++J) {
        rs0 += Rs[16 * tri(J, I) + g4];
        rs1 += Rs[16 * tri(J, I) + g4 + 8];
      }
      if (tq == 0) {
        Dc[r0] = rs0 + cd0 + colp0;
        Dc[r1] = rs1 + cd1 + colp1;
      }
    }
    __syncthreads();  // dcum, Σ_d dxdt·x and the per-warp sums are in; dy
                      // and H_c are read
    if (t + 1 < nT) {  // the next head's dy and H_c land during the scan
      const int hn = h + 1;
      const bf16* yg = static_cast<const bf16*>(a.dy) + bb * a.syb +
                       t0 * a.sys + hn * a.syh;
      for (int i = tid; i < Q * (HD / 8); i += NT) {
        const int j = i / (HD / 8), k = i % (HD / 8);
        cp_async16(Ys + j * XP + 8 * k, yg + j * a.sys + 8 * k);
      }
      if (c > 0) load_state(Hf, a.st, slot_of(t + 1));
    }

    // ---- dcum's reverse scan within the chunk, by warp 0: ddA, ddt and
    // the chunk's Σ ddA·dt
    if (warp == 0) {
      float hs = 0.f, sts = 0.f;
      for (int w = 0; w < NT / 32; ++w) hs += Hd[w];
      for (int J = 0; J < RB; ++J) sts += Sp[J];
      const float dseg = sts + expf(seg) * hs;
      float A = Ah[0];
#pragma unroll
      for (int k = 1; k < BWD_HEADS; ++k)
        if (t == k) A = Ah[k];
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        v[e] = j < Q ? Dc[j] : 0.f;
        if (j == Q - 1) v[e] += dseg;
      }
      float s[4];
      s[3] = v[3];
      s[2] = v[2] + s[3];
      s[1] = v[1] + s[2];
      s[0] = v[0] + s[1];
      float incl = s[0];
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += u;
      }
      const float after = incl - s[0];  // the lanes above this one
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * lane + e;
        if (j < Q) {
          const float dd = s[e] + after;
          a.ddt[(static_cast<long long>(bb) * a.S + t0 + j) * a.nh + h] =
              dd * A + Xd[j];
          part += dd * Tv[j];
        }
      }
      part = sum32(part);
      if (lane == 0) a.dap[slot] = part;
    }
    __syncthreads();  // cum, dt and the per-head sums are read
    if (t + 1 < nT)
      for (int j = tid; j < Q; j += NT) {
        cp_async4(Cv + j, a.cum + slot_of(t + 1) * Q + j);
        cp_async4(Tv + j,
                  a.dt + bb * a.sdb + (t0 + j) * a.sds + (h + 1) * a.sdh);
      }
    cp_async_commit();
  }

  // the tile's dB and dC, rows r0 and r1 of this warp's block
  if (blk < RB) {
    const long long per = static_cast<long long>(a.ng) * a.tpg;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = k ? r1 : r0;
      if (r >= Q) continue;
      const long long row =
          ((static_cast<long long>(bb) * a.S + t0 + r) * per + g * a.tpg +
           kt) * N;
#pragma unroll
      for (int nt = 0; nt < NT8; ++nt) {
        const int n = 8 * nt + 2 * tq;
        if (n >= N) continue;
        *reinterpret_cast<float2*>(a.dbp + row + n) =
            make_float2(accB[nt][2 * k], accB[nt][2 * k + 1]);
        *reinterpret_cast<float2*>(a.dcp + row + n) =
            make_float2(accC[nt][2 * k], accC[nt][2 * k + 1]);
      }
    }
  }
}

// Blocks [0, nh): dA of one head, its (batch, chunk) sums in order.
// Blocks [nh, ...): dB and dC, each element the sum of its group's head
// tiles in tile order, rounded once.
__global__ void __launch_bounds__(NT) bwd_sum_kernel(BwdArgs a) {
  if (blockIdx.x < a.nh) {
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int k = 0; k < a.B * a.nc; ++k)
        s += a.dap[static_cast<long long>(k) * a.nh + blockIdx.x];
      a.dA[blockIdx.x] = s;
    }
    return;
  }
  const int N = a.N;
  const long long per = static_cast<long long>(a.B) * a.S * a.ng * N;
  for (long long i = (blockIdx.x - a.nh) * static_cast<long long>(NT) +
                     threadIdx.x;
       i < 2 * per; i += static_cast<long long>(gridDim.x - a.nh) * NT) {
    const bool isc = i >= per;
    const long long e = isc ? i - per : i;
    const long long bsg = e / N;  // (batch, step, group)
    const int n = static_cast<int>(e % N);
    const float* src = (isc ? a.dcp : a.dbp) + bsg * a.tpg * N + n;
    float s = 0.f;
    for (int k = 0; k < a.tpg; ++k) s += src[static_cast<long long>(k) * N];
    (isc ? static_cast<bf16*>(a.dc) : static_cast<bf16*>(a.db))[e] =
        __float2bfloat16_rn(s);
  }
}

// Floats of the backward's scratch, each piece rounded up to 4 floats.
__host__ __device__ constexpr long long up4(long long n) {
  return (n + 3) / 4 * 4;
}

// bfloat16 head tiles per group
int bwd_tiles(int nh, int ng) {
  return (nh / ng + BWD_HEADS - 1) / BWD_HEADS;
}

long long bwd_scratch_floats(int B, int S, int nh, int ng, int hd, int N,
                             int Q, bool bf) {
  const long long nc = S / Q, bcn = static_cast<long long>(B) * nc * nh;
  const long long bsh = static_cast<long long>(B) * S * nh;
  if (bf)
    return up4(bcn * hd * 8 * ((N + 7) / 8)) + up4(bcn) +
           2 * up4(static_cast<long long>(B) * S * ng * bwd_tiles(nh, ng) * N);
  return up4(bcn * hd * N) + up4(bcn * (hd / 16)) + 2 * up4(bsh * N) +
         3 * up4(bsh);
}

template <int HD>
cudaError_t launch_bwd_f32(BwdArgs a, cudaStream_t s) {
  const size_t s1 = state_smem(a.N, a.Q), s2 = strip_smem(HD, a.N);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_state_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_strip_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s2));
  if (e != cudaSuccess) return e;
  bwd_state_kernel<HD><<<dim3(HD / 16, a.nh, a.B), NT, s1, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int ns = (a.Q + TS - 1) / TS;
  bwd_strip_kernel<HD><<<dim3(a.nc * 2 * ns, a.nh, a.B), NT, s2, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long per = 2LL * a.B * a.S * a.ng * a.N;
  const int nred = static_cast<int>(
      per / NT + 1 < 4096 ? per / NT + 1 : 4096);
  bwd_finish_kernel<<<a.nh + nred, NT, 0, s>>>(a, HD);
  return cudaGetLastError();
}

template <int HD, int R>
cudaError_t launch_bwd_bf16(BwdArgs a, cudaStream_t s) {
  const size_t s1 = gscan_smem(R), s2 = chunk_smem(HD);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_gscan_kernel<HD, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_chunk_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(s2));
  if (e != cudaSuccess) return e;
  bwd_gscan_kernel<HD, R><<<dim3(HD / R, a.nh, a.B), NT, s1, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_chunk_kernel<HD><<<dim3(a.ng * a.tpg, a.nc, a.B), NT, s2, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long per = 2LL * a.B * a.S * a.ng * a.N;
  const int nred = static_cast<int>(
      per / NT + 1 < 4096 ? per / NT + 1 : 4096);
  bwd_sum_kernel<<<a.nh + nred, NT, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// strides: the element strides (batch, step, head) of x and dt, then
// (batch, step, group) of B and C, in that order.  ints: B, S, nh, ng,
// hd, N, Q, dtype of x/B/C (0 = float32, 1 = bfloat16), device, and for
// bfloat16 the state rows per scan_kernel block: 16 at hd 16, 32 or 64
// at hd 64.  cum (B, S/Q, nh, Q) and st (B, S/Q, nh, hd, N rounded up
// to 8) are float32 scratch for bfloat16 (unused for float32); bfloat16
// rows of x, B and C must start on 16-byte boundaries.  Returns a
// cudaError_t (0 on success).
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* A,
                               const void* b, const void* c, void* y, float* h,
                               float* cum, float* st,
                               const long long* strides, const int* ints,
                               void* stream) {
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.b = b; a.c = c; a.y = y; a.h = h;
  a.cum = cum; a.st = st;
  a.sxb = strides[0]; a.sxs = strides[1]; a.sxh = strides[2];
  a.sdb = strides[3]; a.sds = strides[4]; a.sdh = strides[5];
  a.sbb = strides[6]; a.sbs = strides[7]; a.sbg = strides[8];
  a.scb = strides[9]; a.scs = strides[10]; a.scg = strides[11];
  const int B = ints[0], hd = ints[4], dtype = ints[7];
  a.S = ints[1]; a.nh = ints[2]; a.ng = ints[3]; a.N = ints[5]; a.Q = ints[6];
  const int rows = ints[9];
  if (B < 1 || B > 65535 || a.S < 1 || a.nh < 1 || a.ng < 1 ||
      a.nh % a.ng != 0 || a.N < 4 || a.N > NMAX || a.N % 4 != 0 ||
      a.Q < 1 || a.Q > QMAX || a.S % a.Q != 0 || a.S / a.Q > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.nc = a.S / a.Q;
  a.tpg = (a.nh / a.ng + OUT_HEADS - 1) / OUT_HEADS;
  a.QP = (a.Q + 15) / 16 * 16;
  cudaError_t e = cudaSetDevice(ints[8]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 16) e = launch_f32<16>(a, B, s);
  else if (dtype == 0 && hd == 64) e = launch_f32<64>(a, B, s);
  else if (dtype == 1 && cum && st && hd == 16 && rows == 16)
    e = launch_bf16<16, 16>(a, B, s);
  else if (dtype == 1 && cum && st && hd == 64 && rows == 32)
    e = launch_bf16<64, 32>(a, B, s);
  else if (dtype == 1 && cum && st && hd == 64 && rows == 64)
    e = launch_bf16<64, 64>(a, B, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The backward.  strides: the element strides (batch, step, head) of x,
// dt, then (batch, step, group) of B and C, then (batch, step, head) of
// dy; the trailing dims are contiguous.  ints: B, S, nh, ng, hd, N, Q,
// dtype of x/B/C/dy (0 = float32, 1 = bfloat16), device, and whether st
// holds the bfloat16 route's split states (1, which bfloat16 takes) or
// plain float32 ones (0, which float32 takes).  cum and st are the
// forward's (ssd_scan_launch); dh may be null (zeros).
// dx (B, S, nh, hd) and dB, dC (B, S, ng, N) are written contiguous in
// the inputs' dtype, ddt (B, S, nh) and dA (nh,) in float32; scratch holds
// ssd_bwd_scratch_floats(ints) floats.  Three launches, no atomics: two
// calls give the same bits.  Returns a cudaError_t (0 on success).
extern "C" long long ssd_bwd_scratch_floats(const int* ints) {
  return bwd_scratch_floats(ints[0], ints[1], ints[2], ints[3], ints[4],
                            ints[5], ints[6], ints[7] == 1);
}

extern "C" int ssd_bwd_launch(const void* x, const float* dt, const float* A,
                              const void* b, const void* c, const void* dy,
                              const float* cum, const float* st,
                              const float* dh, void* dx, float* ddt,
                              float* dA, void* db, void* dc, float* scratch,
                              const long long* strides, const int* ints,
                              void* stream) {
  BwdArgs a;
  a.x = x; a.dt = dt; a.A = A; a.b = b; a.c = c; a.dy = dy;
  a.cum = cum; a.st = st; a.dh = dh;
  a.dx = dx; a.ddt = ddt; a.dA = dA; a.db = db; a.dc = dc;
  a.sxb = strides[0]; a.sxs = strides[1]; a.sxh = strides[2];
  a.sdb = strides[3]; a.sds = strides[4]; a.sdh = strides[5];
  a.sbb = strides[6]; a.sbs = strides[7]; a.sbg = strides[8];
  a.scb = strides[9]; a.scs = strides[10]; a.scg = strides[11];
  a.syb = strides[12]; a.sys = strides[13]; a.syh = strides[14];
  a.B = ints[0]; a.S = ints[1]; a.nh = ints[2]; a.ng = ints[3];
  const int hd = ints[4], dtype = ints[7];
  a.N = ints[5]; a.Q = ints[6]; a.split = ints[9];
  if (a.B < 1 || a.B > 65535 || a.S < 1 || a.nh < 1 || a.ng < 1 ||
      a.nh % a.ng != 0 || a.N < 4 || a.N > NMAX || a.N % 4 != 0 ||
      a.Q < 1 || a.Q > QMAX || a.S % a.Q != 0 || !cum || !st)
    return static_cast<int>(cudaErrorInvalidValue);
  a.nc = a.S / a.Q;
  const long long nc = a.nc, bcn = static_cast<long long>(a.B) * nc * a.nh;
  const long long bsh = static_cast<long long>(a.B) * a.S * a.nh;
  a.tpg = bwd_tiles(a.nh, a.ng);
  a.gst = scratch;
  if (dtype == 1) {
    a.dap = a.gst + up4(bcn * hd * 8 * ((a.N + 7) / 8));
    a.dbp = a.dap + up4(bcn);
    a.dcp = a.dbp + up4(static_cast<long long>(a.B) * a.S * a.ng * a.tpg *
                        a.N);
  } else {
    a.hdot = a.gst + up4(bcn * hd * a.N);
    a.dbh = a.hdot + up4(bcn * (hd / 16));
    a.dch = a.dbh + up4(bsh * a.N);
    a.dcr = a.dch + up4(bsh * a.N);
    a.dcc = a.dcr + up4(bsh);
    a.sgp = a.dcc + up4(bsh);
  }
  cudaError_t e = cudaSetDevice(ints[8]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !a.split && hd == 16) e = launch_bwd_f32<16>(a, s);
  else if (dtype == 0 && !a.split && hd == 64) e = launch_bwd_f32<64>(a, s);
  else if (dtype == 1 && a.split && hd == 16)
    e = launch_bwd_bf16<16, 16>(a, s);
  else if (dtype == 1 && a.split && hd == 64)
    e = launch_bwd_bf16<64, BWD_ROWS>(a, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
