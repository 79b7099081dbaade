// The fused PSP sweep tick for Hopper (sm_90a), in three launches.
//
// Replaces the Pallas TPU kernel `psp_tick_tpu` / `_tick_kernel` of
// src/repro/kernels/psp_tick.py: one whole grid tick of the sweep engine
// for B scenario rows of P node slots -- churn, finishes, the full-view
// barrier, the rank-form beta-sample barrier, start / re-poll anchoring,
// the adaptive-policy updates, the masked SGD push of every finisher and
// the pull of the new server model into the starters' views.  The plain
// PyTorch version is `psp_tick_ref` in src/repro_torch/kernels/psp_tick.py;
// the wrapper `psp_tick_cuda` there checks the operands, allocates the
// outputs and calls `psp_tick_launch` below through ctypes.
//
// What bounds it on this card: memory.  At the paper shape (B = 32 rows,
// P = 1000, d = 1000, m = 8) a tick reads the node views `pulled`
// (B*P*d f32 = 128 MB) and the minibatch blob X (P*m*d f32 = 32 MB), and
// writes the new views (another 128 MB, the output being a fresh tensor);
// its f32 arithmetic (< 1 GFLOP) is far below the card's rate.  The control
// plane touches only (B, P) arrays and the 4 MB shared score matrix.
//
// What the design does about it:
//   1. control_kernel -- one 1024-thread block per scenario row.  Row
//      reductions (alive count, first-argmax churn victim and joiner,
//      freshest step, row_last, min/max alive step, EMA max, ctrl) are
//      block reductions; each node is owned by one thread.  The
//      beta-sample runs one thread per deciding node and streams the peer
//      axis twice: first the lowest (score, index) lagging peer, then the
//      count of eligible peers before it -- the peer is inside the sample
//      iff that count is below beta.  No P x P tile is kept; the row's
//      steps/alive sit in shared memory, and the peer loops are branch-free
//      and unrolled so their score loads overlap.  The beta = 1 path reads
//      the peer's step with an exact integer gather.
//   2. resid_kernel -- one warp per (row, node), over the whole card: the
//      residual resid[b,p,:] = fin * (X[p,:,:] . (pulled[b,p,:] -
//      w_true[b,:]) - sigma_b * mb[p,:]) of every finisher, and the copy of
//      every non-starter's view into the output, in one read of the view
//      (16-byte accesses when d is a multiple of 4).
//   3. update_kernel -- one 1024-thread block per (32 model columns,
//      8 rows): the gradient sum over (p, m) split over 32 warps, w -= lr * sum / m, then the
//      starters' views are written with the new server model.
// No atomics: every reduction runs in a fixed order, so each row's bits
// depend on that row alone.  Built with -fmad=false and without fast math,
// so event_time, ready, the EMA and elastic_slack's division round like
// the plain version and the control plane matches it bit for bit.  The
// data plane sums in another order than the plain version's einsum.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTC = 1024;      // threads per control_kernel block
constexpr int NWC = NTC / 32;  // its warps
constexpr int NT = 256;        // threads per resid_kernel block
constexpr int NW = NT / 32;    // its warps
constexpr int NTU = 1024;      // threads per update_kernel block
constexpr int NWU = NTU / 32;  // its warps
constexpr int MAX_M = 16;      // minibatch rows held in registers
constexpr int RG = 8;          // rows per update_kernel block
constexpr unsigned FULL = 0xffffffffu;

// operand slots of `psp_tick_launch`; the wrapper builds the array in
// this order (psp_tick.py `_IN_KEYS` then `_OUT_KEYS`)
enum Slot {
  STEPS, ALIVE, COMP, EVENT, READY, BLOCKED, PEND_L, PEND_J, W, PULLED,
  POL_THR, POL_BETA, POL_EMA, LEAVE_N, JOIN_N,
  DUR, SAMP, U_LEAVE, U_JOIN, X, MB,
  CT, VALID, STAL, BETA, IS_ASP, FULL_VIEW, SAMPLED, DIST_HOPS,
  IS_DSSP, IS_EBSP, IS_ANN, POL_LO, BETA_LO, EBSP_RANGE, EBSP_ALPHA,
  W_TRUE, LR, NOISE_STD, HORIZON,
  O_STEPS, O_ALIVE, O_COMP, O_EVENT, O_READY, O_BLOCKED, O_PEND_L, O_PEND_J,
  O_W, O_PULLED, O_FIN, O_START, O_NFIN, O_CTRL, O_THR, O_EMA, O_BETA,
  RESID, N_SLOTS
};

struct Slots {
  void* p[N_SLOTS];
};

struct Dims {
  int B, P, d, m, k_max, has_churn, masked, adaptive;
  float t, eps, poll;
};

#define I32(s) (static_cast<int*>(a.p[s]))
#define F32(s) (static_cast<float*>(a.p[s]))

struct Sum {
  __device__ int operator()(int x, int y) const { return x + y; }
};
struct MaxI {
  __device__ int operator()(int x, int y) const { return x > y ? x : y; }
};
struct MinI {
  __device__ int operator()(int x, int y) const { return x < y ? x : y; }
};
struct MaxF {
  __device__ float operator()(float x, float y) const { return fmaxf(x, y); }
};

// Reduce one value per thread over the block; every thread gets the result.
// Warps reduce by butterfly, then every thread folds the warp partials in
// warp order -- a fixed order, so float results are reproducible.
template <class T, class Op>
__device__ T block_reduce(T v, Op op, T* buf) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();                       // buf may hold the previous result
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = buf[0];
  for (int i = 1; i < NWC; ++i) r = op(r, buf[i]);
  return r;
}

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Lowest index of the maximum of where(mask, u, -1) over the row: the
// reference's jnp.argmax of the masked uniforms.  `mask(i)` is per node.
template <class Mask>
__device__ int first_argmax(const float* u, int P, Mask mask, int* bi,
                            float* bf) {
  float best = -INFINITY;
  for (int i = threadIdx.x; i < P; i += NTC)
    best = fmaxf(best, mask(i) ? u[i] : -1.0f);
  const float mx = block_reduce(best, MaxF(), bf);
  int idx = P;
  for (int i = threadIdx.x; i < P; i += NTC)
    if ((mask(i) ? u[i] : -1.0f) == mx && i < idx) idx = i;
  return block_reduce(idx, MinI(), bi);
}

// Control plane: one block per scenario row, one thread per node slot
// (strided).  Every per-node value is read and written by its owning
// thread only, through the output arrays; rows talk through reductions.
__global__ void __launch_bounds__(NTC) control_kernel(Slots a, Dims D) {
  extern __shared__ int smem[];            // steps, alive of the row
  __shared__ int bi[NWC];
  __shared__ float bf[NWC];
  const int P = D.P, b = blockIdx.x, tid = threadIdx.x;
  int* steps_s = smem;
  int* alive_s = smem + P;
  const size_t row = static_cast<size_t>(b) * P;
  const float t = D.t, te = D.t + D.eps;
  const bool active = t <= F32(HORIZON)[b] + D.eps;

  int* o_steps = I32(O_STEPS) + row;
  int* o_alive = I32(O_ALIVE) + row;
  int* o_comp = I32(O_COMP) + row;
  float* o_event = F32(O_EVENT) + row;
  float* o_ready = F32(O_READY) + row;
  int* o_blocked = I32(O_BLOCKED) + row;
  for (int i = tid; i < P; i += NTC) {
    o_steps[i] = I32(STEPS)[row + i];
    o_alive[i] = I32(ALIVE)[row + i] != 0;
    o_comp[i] = I32(COMP)[row + i] != 0;
    o_event[i] = F32(EVENT)[row + i];
    o_ready[i] = F32(READY)[row + i];
    o_blocked[i] = I32(BLOCKED)[row + i] != 0;
  }

  // 0. churn: at most one pre-sampled leave and one join per row per tick
  if (D.has_churn) {
    const int* valid = I32(VALID) + row;
    const int pend_l = I32(PEND_L)[b] + I32(LEAVE_N)[b];
    const int pend_j = I32(PEND_J)[b] + I32(JOIN_N)[b];
    int na = 0;
    for (int i = tid; i < P; i += NTC) na += o_alive[i];
    const int n_alive = block_reduce(na, Sum(), bi);
    const bool do_l = active && pend_l > 0 && n_alive > 2;
    const int vid = first_argmax(
        F32(U_LEAVE) + row, P, [&](int i) { return o_alive[i] != 0; },
        bi, bf);
    if (do_l)
      for (int i = tid; i < P; i += NTC)
        if (i == vid) o_alive[i] = 0;
    auto pool = [&](int i) { return !o_alive[i] && valid[i]; };
    int np = 0;
    for (int i = tid; i < P; i += NTC) np += pool(i);
    const bool do_j = active && pend_j > 0 && block_reduce(np, Sum(), bi) > 0;
    const int jid = first_argmax(F32(U_JOIN) + row, P, pool, bi, bf);
    if (do_j)
      for (int i = tid; i < P; i += NTC)
        if (i == jid) o_alive[i] = 1;
    int fr = INT32_MIN;
    for (int i = tid; i < P; i += NTC)
      if (o_alive[i]) fr = max(fr, o_steps[i]);
    const int fresh = block_reduce(fr, MaxI(), bi);
    if (do_j)
      for (int i = tid; i < P; i += NTC)
        if (i == jid) {
          o_steps[i] = fresh;
          o_comp[i] = 0;
          o_event[i] = t;
          o_ready[i] = t;
          o_blocked[i] = 0;
        }
    if (tid == 0) {
      I32(O_PEND_L)[b] = active ? pend_l - (pend_l > 0) : I32(PEND_L)[b];
      I32(O_PEND_J)[b] = active ? pend_j - (pend_j > 0) : I32(PEND_J)[b];
    }
  } else if (tid == 0) {
    I32(O_PEND_L)[b] = I32(PEND_L)[b];
    I32(O_PEND_J)[b] = I32(PEND_J)[b];
  }

  // 1. finishes: advance steps, become "deciding"
  int nf = 0;
  float last = -INFINITY;
  for (int i = tid; i < P; i += NTC) {
    const float ev = o_event[i];
    const int fin = o_comp[i] && o_alive[i] && ev <= te && active;
    I32(O_FIN)[row + i] = fin;
    if (fin) {
      o_steps[i] += 1;
      o_comp[i] = 0;
      o_ready[i] = ev;
      o_blocked[i] = 0;
      nf += 1;
      last = fmaxf(last, ev);
    }
  }
  const int n_fin = block_reduce(nf, Sum(), bi);
  const float row_last = block_reduce(last, MaxF(), bf);
  const float row_unblock = n_fin > 0 ? fminf(row_last, t) : t;
  if (tid == 0) I32(O_NFIN)[b] = n_fin;

  // 2. stage the row for the beta-sample; alive-step extremes, EMA max
  const float* ema = D.adaptive ? F32(POL_EMA) + row : nullptr;
  int mn = INT32_MAX, mx = INT32_MIN, na2 = 0;
  float emx = -INFINITY;
  for (int i = tid; i < P; i += NTC) {
    const int s = o_steps[i], al = o_alive[i];
    steps_s[i] = s;
    alive_s[i] = al;
    if (al) {
      mn = min(mn, s);
      mx = max(mx, s);
      na2 += 1;
    }
    if (D.adaptive) emx = fmaxf(emx, al ? ema[i] : 0.0f);
  }
  const int min_alive = block_reduce(mn, MinI(), bi);
  const int max_alive = block_reduce(mx, MaxI(), bi);
  const int n_alive = block_reduce(na2, Sum(), bi);
  const float ema_max = D.adaptive ? block_reduce(emx, MaxF(), bf) : 0.0f;

  const int stal_row = I32(STAL)[b];
  const bool is_asp = I32(IS_ASP)[b], fv = I32(FULL_VIEW)[b];
  const bool smp = I32(SAMPLED)[b];
  const bool dssp = D.adaptive && I32(IS_DSSP)[b];
  const bool ebsp = D.adaptive && I32(IS_EBSP)[b];
  const bool ann = D.adaptive && I32(IS_ANN)[b];
  const int beta_row = ann ? I32(POL_BETA)[b] : I32(BETA)[b];
  // sample slots the plain version consults: min(beta, k), k = min(k_max, P)
  const int kb = max(0, min(beta_row, min(D.k_max, P)));
  const bool use_u1 = D.k_max == 1 && !D.masked;
  const float* samp = static_cast<const float*>(a.p[SAMP]);
  const float* ct = F32(CT) + row;
  const float* udur = F32(DUR) + row;
  const int hops = I32(DIST_HOPS)[b];
  const float alpha = D.adaptive ? F32(EBSP_ALPHA)[b] : 0.0f;

  // 2-3. decide, then start or re-poll, node by node
  int ctrl = 0;
  for (int i = tid; i < P; i += NTC) {
    const int al = alive_s[i], si = steps_s[i];
    float ev = o_event[i];
    const bool cand = !o_comp[i] && al && ev <= te && active;
    int st = stal_row;
    if (dssp) {
      st = I32(POL_THR)[b];
    } else if (ebsp) {
      const float frac = 1.0f - ema[i] / fmaxf(ema_max, 1e-9f);
      st = static_cast<int>(floorf(F32(EBSP_RANGE)[b] * frac));
    }
    int nsamp = 0;
    if (D.k_max > 0) {
      const int pop = D.masked ? n_alive - (al ? 1 : 0) : P - 1;
      nsamp = max(0, min(kb, pop));
    }
    if (cand) ctrl += nsamp * hops;
    bool passed = true;
    if (!cand || is_asp) {
      passed = true;
    } else if (fv) {
      passed = si - min_alive <= st;
    } else if (D.k_max > 0 && kb > 0) {
      if (use_u1) {
        const int draw = static_cast<int>(
            floorf(samp[i] * static_cast<float>(max(P - 1, 1))));
        const int take = min(draw + (draw >= i ? 1 : 0), P - 1);
        passed = !(P > 1 && si - steps_s[take] > st);
      } else {
        const float* __restrict__ sc =
            samp + (D.masked ? (row + i) : i) * static_cast<size_t>(P);
        // pass 1: the lowest (score, index) lagging eligible peer.  Loads
        // are unconditional and the loop branch-free, so unrolled loads
        // overlap instead of waiting one by one.
        float bs = 3.0f;
        int bj = P;
#pragma unroll 8
        for (int j = 0; j < P; ++j) {
          const float v = sc[j];
          const bool lag = j != i && (!D.masked || alive_s[j]) &&
                           si - steps_s[j] > st && v < bs;
          bs = lag ? v : bs;
          bj = lag ? j : bj;
        }
        // pass 2: it is sampled iff fewer than kb eligible peers precede it
        if (bj < P) {
          int before = 0;
#pragma unroll 8
          for (int j = 0; j < P; ++j) {
            const float v = sc[j];
            before += (j != i && (!D.masked || alive_s[j]) &&
                       (v < bs || (v == bs && j < bj))) ? 1 : 0;
          }
          passed = before >= kb;
        }
      }
    }
    const bool start = cand && passed;
    const bool fail = cand && !passed;
    float rd = o_ready[i];
    int bl = o_blocked[i];
    const float t0 = (bl && fv) ? fmaxf(row_unblock, rd) : rd;
    const float dur = ct[i] * (1.0f + (udur[i] - 0.5f));
    if (start) {
      ev = t0 + dur;
      o_comp[i] = 1;
    }
    bl = (bl || fail) && !start;
    if (fail && smp) {
      rd = rd + D.poll;
      ev = rd;
    }
    o_event[i] = ev;
    o_ready[i] = rd;
    o_blocked[i] = bl;
    I32(O_START)[row + i] = start;
    if (D.adaptive)
      F32(O_EMA)[row + i] = (ebsp && start)
                                ? (1.0f - alpha) * ema[i] + alpha * dur
                                : ema[i];
  }
  const int ctrl_row = block_reduce(ctrl, Sum(), bi);
  if (tid == 0) {
    I32(O_CTRL)[b] = ctrl_row;
    if (D.adaptive) {
      // 3b. policy state from this tick's post-finish step spread
      const int gap = n_alive > 0 ? max_alive - min_alive : 0;
      const int stal = I32(STAL)[b], lo = I32(POL_LO)[b];
      const int blo = I32(BETA_LO)[b], bhi = I32(BETA)[b];
      I32(O_THR)[b] = (dssp && active) ? min(max(gap, lo), stal)
                                       : I32(POL_THR)[b];
      I32(O_BETA)[b] = (ann && active) ? min(max(blo + gap - stal, blo), bhi)
                                       : I32(POL_BETA)[b];
    }
  }
}

// Residual of every finisher and the copy of every non-starter's view:
// one warp per (row, node).  A node that neither finished nor keeps its
// view (a starter without a push) reads nothing.
__global__ void __launch_bounds__(NT) resid_kernel(Slots a, Dims D) {
  const long long wi = (static_cast<long long>(blockIdx.x) * NT +
                        threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wi >= static_cast<long long>(D.B) * D.P) return;   // whole warp
  const int m = D.m, d = D.d;
  const int b = static_cast<int>(wi / D.P), p = static_cast<int>(wi % D.P);
  const bool fin = I32(O_FIN)[wi] != 0, keep = I32(O_START)[wi] == 0;
  float* __restrict__ r = F32(RESID) + wi * m;
  if (!fin && lane < m) r[lane] = 0.0f;
  if (!fin && !keep) return;
  const float* __restrict__ view = F32(PULLED) + wi * d;
  float* __restrict__ out = F32(O_PULLED) + wi * d;
  const float* __restrict__ wt = F32(W_TRUE) + static_cast<size_t>(b) * d;
  const float* __restrict__ xp = F32(X) + static_cast<size_t>(p) * m * d;
  float acc[MAX_M];
#pragma unroll
  for (int k = 0; k < MAX_M; ++k) acc[k] = 0.0f;
  const bool vec = (d & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(view) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(wt) | reinterpret_cast<uintptr_t>(xp)) &
       15) == 0;
  if (vec) {                           // 16-byte loads and stores
    const int d4 = d >> 2;
    const float4* __restrict__ v4 = reinterpret_cast<const float4*>(view);
    const float4* __restrict__ w4 = reinterpret_cast<const float4*>(wt);
    const float4* __restrict__ x4 = reinterpret_cast<const float4*>(xp);
    float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
#pragma unroll 2
    for (int c = lane; c < d4; c += 32) {
      const float4 v = v4[c];
      if (keep) o4[c] = v;
      if (fin) {
        const float4 w = w4[c];
        const float dx = v.x - w.x, dy = v.y - w.y;
        const float dz = v.z - w.z, dw = v.w - w.w;
#pragma unroll
        for (int k = 0; k < MAX_M; ++k) {
          if (k < m) {
            const float4 x = x4[static_cast<size_t>(k) * d4 + c];
            acc[k] += x.x * dx;
            acc[k] += x.y * dy;
            acc[k] += x.z * dz;
            acc[k] += x.w * dw;
          }
        }
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float v = view[c];
      if (keep) out[c] = v;
      if (fin) {
        const float df = v - wt[c];
#pragma unroll
        for (int k = 0; k < MAX_M; ++k)
          if (k < m) acc[k] += xp[static_cast<size_t>(k) * d + c] * df;
      }
    }
  }
  if (!fin) return;
  const float ns = F32(NOISE_STD)[b];
#pragma unroll
  for (int k = 0; k < MAX_M; ++k) {
    if (k < m) {
      const float s = warp_sum(acc[k]);
      if (lane == 0) r[k] = s - ns * F32(MB)[static_cast<size_t>(p) * m + k];
    }
  }
}

// Gradient sum, server update and the starters' pull: one block per
// (32 columns, RG rows).  The (node, minibatch row) axis is split over the
// block's warps, each summing its share in a fixed order; the warps'
// partial sums are then added in warp order.
__global__ void __launch_bounds__(NTU) update_kernel(Slots a, Dims D) {
  __shared__ float part[NWU][RG][32];
  __shared__ float w_new[RG][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int B = D.B, P = D.P, d = D.d, m = D.m;
  const int col = blockIdx.x * 32 + lane;
  const int b0 = blockIdx.y * RG;
  const bool col_ok = col < d;
  const float* __restrict__ X_ = F32(X);
  const float* __restrict__ resid = F32(RESID);
  const long long Q = static_cast<long long>(P) * m;   // (p, k) pairs
  float acc[RG];
#pragma unroll
  for (int r = 0; r < RG; ++r) acc[r] = 0.0f;
#pragma unroll 2
  for (long long q = wid; q < Q; q += NWU) {
    const float x = col_ok ? X_[q * d + col] : 0.0f;
#pragma unroll
    for (int r = 0; r < RG; ++r)
      if (b0 + r < B) acc[r] += resid[(b0 + r) * Q + q] * x;
  }
#pragma unroll
  for (int r = 0; r < RG; ++r) part[wid][r][lane] = acc[r];
  __syncthreads();
  if (wid < RG) {
    const int r = wid, b = b0 + wid;      // thread (r, lane): one output
    float g = 0.0f;
    for (int w = 0; w < NWU; ++w) g += part[w][r][lane];
    if (b < B && col_ok) {
      const size_t o = static_cast<size_t>(b) * d + col;
      const float v = F32(W)[o] - F32(LR)[b] * (g / static_cast<float>(m));
      F32(O_W)[o] = v;
      w_new[r][lane] = v;
    }
  }
  __syncthreads();
  const int* __restrict__ start = I32(O_START);
  float* __restrict__ out = F32(O_PULLED);
#pragma unroll 4
  for (int rp = wid; rp < RG * P; rp += NWU) {
    const int r = rp / P, p = rp - r * P, b = b0 + r;
    const size_t node = static_cast<size_t>(b) * P + p;
    if (b < B && col_ok && start[node])
      out[node * d + col] = w_new[r][lane];
  }
}

}  // namespace

// ints: B, P, d, m, k_max, has_churn, masked, adaptive, device.
// floats: t, eps, poll.  Returns a cudaError_t (0 on success).
extern "C" int psp_tick_launch(void** ptrs, const int* ints,
                               const float* floats, void* stream) {
  Slots a;
  for (int i = 0; i < N_SLOTS; ++i) a.p[i] = ptrs[i];
  Dims D{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6],
         ints[7], floats[0], floats[1], floats[2]};
  if (D.m > MAX_M || D.B < 1 || D.P < 1 || D.d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(ints[8]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * static_cast<size_t>(D.P) * sizeof(int);
  e = cudaFuncSetAttribute(control_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  control_kernel<<<D.B, NTC, smem, s>>>(a, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long long warps = static_cast<long long>(D.B) * D.P;
  const unsigned nb = static_cast<unsigned>((warps + NW - 1) / NW);
  resid_kernel<<<nb, NT, 0, s>>>(a, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  dim3 grid((D.d + 31) / 32, (D.B + RG - 1) / RG);
  update_kernel<<<grid, NTU, 0, s>>>(a, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
