// The fused PSP sweep tick for Hopper (sm_90a), in five launches.
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
// What bounds it on this card.  Memory, and most of what a tick must move
// depends on its data: a node's view is read only if the node finished
// (its residual) and written only if it started (the pull), and X[p] only
// if some row's node p finished.  At the paper shape (B = 32, P = 1000,
// d = 1000, m = 8), with a fifth of the 32,000 node slots finishing and a
// fifth starting, that is about 90 MB (views of 4 KB, X 32 MB, the 4 MB
// shared scores): 0.027 ms at 3.35 TB/s (`tick_bytes` in the wrapper's
// module counts it).  The arithmetic is small.  What the card punishes is
// latency: a row's control plane is a chain (churn and the alive-step
// minimum precede every decision), and a loop whose loads wait one by one
// runs at a fraction of the memory's rate, so every launch below puts its
// loads in flight together (register batches) and keeps enough blocks
// resident to overlap them.
//
// The launches, and what each does about that:
//   1. prologue_kernel -- one 512-thread block per row: churn (first-
//      argmax victim and joiner), finishes, and the row scalars (n_fin,
//      row_unblock, the alive-step minimum, maximum and count and the EMA
//      max in one reduction), and the adaptive policy scalars.  Only what
//      needs the whole row.
//   2. decide_kernel -- one 256-thread block per (row, 64 nodes): 512
//      blocks at the paper shape, over the whole card.  The row's steps
//      and alive flags are staged in shared memory (read from L2 instead
//      when 5 P bytes exceed a block's share, P > ~46,000); two warps own the
//      nodes, and the beta-sample runs one warp per deciding node over
//      all eight warps, compacted with __ballot_sync.  The lanes stride
//      the peer axis, 16 coalesced score loads each in flight at once
//      (the shared P x P scores stay in L2 for all rows).  Pass 1 finds
//      the lowest lagging (score, index) by warp shuffles; pass 2 counts
//      the eligible peers before it with __popc(__ballot_sync(..)) and
//      stops once beta of them are found: exact compare and integer work.
//      The control-message count is the only cross-block sum: an integer
//      atomicAdd, exact and order-free.
//   3. resid_kernel -- one block per node p: X[p] is staged in shared
//      memory once and serves every row that pushed p, one warp per row,
//      with 16-byte loads of the view and w_true; so X is read from device
//      memory once, not once per finisher (a fifth of B x P x 32 KB).
//   4. grad_kernel -- one block per (128 columns, 32 nodes, 32 rows): the
//      product of the block's residuals and X tile in stages of 8 nodes,
//      4 x 4 (row, column) outputs per thread with fmaf, a stage that no
//      row pushed skipped; X is read from device memory once more.  Each
//      block writes one partial sum per (row, column).
//   5. finish_kernel -- one block per (row, 128 columns): adds the partial
//      sums in node-block order, w -= lr * sum / m in place, and writes the
//      new model into the starters' views in place, 16 bytes a store (the
//      starters listed in shared memory, in tiles when the row is long).
// Launches 3 and 4 are compiled for minibatches of at most 8 and 16
// rows, so the accumulators of the common m = 8 are 8 registers, not 16.
// A view longer than a resid_kernel block stages (1024 columns at m <= 8,
// 512 above) is taken in column chunks.
// Padded rows (negative horizon) never tick: the prologue copies their
// state and every other launch skips them.
//
// The in-place contract.  `w` and `pulled` are updated in place: the
// reference donates its whole carry to each chunk scan, and a view that
// does not change moves no byte.  The hazard is a node that finishes and
// starts in the same tick: its residual must read the old view before
// the pull overwrites it.  The residual (3) precedes the pull (5) in
// stream order, so it does.  Every other input is only read.
//
// No float atomics: every float sum runs in a fixed order (lanes, then
// warps, then node stages and node blocks by index), so each row's bits
// depend on that row alone and two runs on the same inputs agree bit for
// bit.  Built with -fmad=false and without fast math, so event_time,
// ready, the EMA and elastic_slack's division round like the plain
// version and the control plane matches it bit for bit; the data plane
// sums in another order than the plain version's einsum, and the
// gradient's fmaf rounds once where the einsum may round twice.  A row
// that did not push a node adds exact zeros.  Booleans are 1-byte
// torch.bool.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned char u8;

constexpr int NTP = 512;       // threads per prologue_kernel block
constexpr int NWP = NTP / 32;
constexpr int TN = 64;         // nodes per decide_kernel block
constexpr int NWN = TN / 32;   // its warps that own nodes
constexpr int NTD = 256;       // threads per decide_kernel block
constexpr int NWD = NTD / 32;
constexpr int NTR = 256;       // threads per resid_kernel block
constexpr int NWR = NTR / 32;
constexpr int XS = 8192;       // floats of X[p] a resid_kernel block stages
constexpr int CT = 128;        // model columns per grad / finish block
constexpr int PC = 32;         // nodes per grad_kernel block
constexpr int SN = 8;          // nodes per grad_kernel stage
constexpr int RGS = 32;        // rows per grad_kernel block
constexpr int NTG = 256;       // threads per grad_kernel block: 4 x 4 each
constexpr int NTF = 256;       // threads per finish_kernel block
constexpr int NWF = NTF / 32;
constexpr int MAX_M = 16;      // minibatch rows held in registers (m <= it)
// loads a thread puts in flight together: partial sums, view and w_true
// vectors, X[p] vectors
constexpr int LB = 8, LV = 4, LX = 4;
constexpr unsigned FULL = 0xffffffffu;

// operand slots of `psp_tick_launch`; the wrapper builds the array in
// this order (psp_tick.py: `psp_tick_cuda`, `_PARAM_SPEC`, `_OUT_KEYS`)
enum Slot {
  STEPS, ALIVE, COMP, EVENT, READY, BLOCKED, PEND_L, PEND_J, W, PULLED,
  POL_THR, POL_BETA, POL_EMA, LEAVE_N, JOIN_N,
  DUR, SAMP, U_LEAVE, U_JOIN, X, MB,
  CT_, VALID, STAL, BETA, IS_ASP, FULL_VIEW, SAMPLED, DIST_HOPS,
  IS_DSSP, IS_EBSP, IS_ANN, POL_LO, BETA_LO, EBSP_RANGE, EBSP_ALPHA,
  W_TRUE, LR, NOISE_STD, HORIZON,
  O_STEPS, O_ALIVE, O_COMP, O_EVENT, O_READY, O_BLOCKED, O_PEND_L, O_PEND_J,
  O_FIN, O_START, O_NFIN, O_CTRL, O_THR, O_EMA, O_BETA, SCRATCH, N_SLOTS
};

struct Slots {
  void* p[N_SLOTS];
};

// Byte offsets into the scratch buffer (see `layout`).
struct Scratch {
  size_t rowi, rowf, resid, part, total;
};

struct Dims {
  int B, P, d, m, k_max, has_churn, masked, adaptive, nch;
  float t, eps, poll;
  Scratch s;
  int ftile;                   // nodes per finish_kernel starter tile
};

Scratch layout(int B, int P, int d, int m) {
  auto up = [](size_t x) { return (x + 255) & ~static_cast<size_t>(255); };
  const size_t nch = (static_cast<size_t>(P) + PC - 1) / PC;
  Scratch s;
  s.rowi = 0;                                            // int[B][2]
  s.rowf = up(s.rowi + 8 * static_cast<size_t>(B));      // float[B][2]
  s.resid = up(s.rowf + 8 * static_cast<size_t>(B));     // float[B][P][m]
  s.part = up(s.resid + 4 * static_cast<size_t>(B) * P * m);  // [nch][B][d]
  s.total = up(s.part + 4 * nch * B * d);
  return s;
}

#define I32(s) (static_cast<int*>(a.p[s]))
#define F32(s) (static_cast<float*>(a.p[s]))
#define U8(s) (static_cast<u8*>(a.p[s]))
#define SCR(T, off) (reinterpret_cast<T*>(U8(SCRATCH) + D.s.off))

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

// Alive-step extremes and count and the EMA max of a row, reduced at once.
struct Stats {
  int mn, mx, n;
  float emx;
};
struct StatsOp {
  __device__ Stats operator()(Stats x, Stats y) const {
    return {min(x.mn, y.mn), max(x.mx, y.mx), x.n + y.n, fmaxf(x.emx, y.emx)};
  }
};
__device__ Stats shfl_xor(Stats v, int o) {
  return {__shfl_xor_sync(FULL, v.mn, o), __shfl_xor_sync(FULL, v.mx, o),
          __shfl_xor_sync(FULL, v.n, o), __shfl_xor_sync(FULL, v.emx, o)};
}
__device__ int shfl_xor(int v, int o) { return __shfl_xor_sync(FULL, v, o); }
__device__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(FULL, v, o);
}

// Reduce one value per thread over an NTP-thread block; every thread gets
// the result.  Warps reduce by butterfly, then every thread folds the warp
// partials in warp order: a fixed order, so float results reproduce.
template <class T, class Op>
__device__ T block_reduce(T v, Op op, T* buf) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, shfl_xor(v, o));
  __syncthreads();                       // buf may hold the previous result
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = buf[0];
  for (int i = 1; i < NWP; ++i) r = op(r, buf[i]);
  return r;
}

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Columns of X[p] a resid_kernel block stages at once: up to XS / MM
// floats per minibatch row, a multiple of 4.
template <int MM>
__device__ int resid_chunk(int d) {
  return d < (XS / MM & ~3) ? d : (XS / MM & ~3);
}

__device__ bool row_active(const Slots& a, const Dims& D, int b) {
  return D.t <= F32(HORIZON)[b] + D.eps;
}

// Lowest index of the maximum of where(mask, u, -1) over the row: the
// reference's jnp.argmax of the masked uniforms.  `mask(i)` is per node.
template <class Mask>
__device__ int first_argmax(const float* u, int P, Mask mask, int* bi,
                            float* bf) {
  float best = -INFINITY;
  for (int i = threadIdx.x; i < P; i += NTP)
    best = fmaxf(best, mask(i) ? u[i] : -1.0f);
  const float mx = block_reduce(best, MaxF(), bf);
  int idx = P;
  for (int i = threadIdx.x; i < P; i += NTP)
    if ((mask(i) ? u[i] : -1.0f) == mx && i < idx) idx = i;
  return block_reduce(idx, MinI(), bi);
}

// 1. Per-row prologue: one block per scenario row.  Writes the row's
// post-churn, post-finish state into the outputs and its scalars into
// the scratch.
__global__ void __launch_bounds__(NTP) prologue_kernel(Slots a, Dims D) {
  __shared__ int bi[NWP];
  __shared__ float bf[NWP];
  __shared__ Stats bst[NWP];
  const int P = D.P, b = blockIdx.x, tid = threadIdx.x;
  const size_t row = static_cast<size_t>(b) * P;
  const float t = D.t, te = D.t + D.eps;
  const bool active = row_active(a, D, b);
  const float* ema = D.adaptive ? F32(POL_EMA) + row : nullptr;

  int* o_steps = I32(O_STEPS) + row;
  u8* o_alive = U8(O_ALIVE) + row;
  u8* o_comp = U8(O_COMP) + row;
  float* o_event = F32(O_EVENT) + row;
  float* o_ready = F32(O_READY) + row;
  u8* o_blocked = U8(O_BLOCKED) + row;
  u8* o_fin = U8(O_FIN) + row;
  for (int i = tid; i < P; i += NTP) {
    o_steps[i] = I32(STEPS)[row + i];
    o_alive[i] = U8(ALIVE)[row + i] != 0;
    o_comp[i] = U8(COMP)[row + i] != 0;
    o_event[i] = F32(EVENT)[row + i];
    o_ready[i] = F32(READY)[row + i];
    o_blocked[i] = U8(BLOCKED)[row + i] != 0;
  }
  if (!active) {               // frozen row: state unchanged, no traffic
    for (int i = tid; i < P; i += NTP) {
      o_fin[i] = 0;
      U8(O_START)[row + i] = 0;
      if (D.adaptive) F32(O_EMA)[row + i] = ema[i];
    }
    if (tid == 0) {
      I32(O_PEND_L)[b] = I32(PEND_L)[b];
      I32(O_PEND_J)[b] = I32(PEND_J)[b];
      I32(O_NFIN)[b] = 0;
      I32(O_CTRL)[b] = 0;
      if (D.adaptive) {
        I32(O_THR)[b] = I32(POL_THR)[b];
        I32(O_BETA)[b] = I32(POL_BETA)[b];
      }
    }
    return;
  }

  // 0. churn: at most one pre-sampled leave and one join per row per tick
  if (D.has_churn) {
    const u8* valid = U8(VALID) + row;
    const int pend_l = I32(PEND_L)[b] + I32(LEAVE_N)[b];
    const int pend_j = I32(PEND_J)[b] + I32(JOIN_N)[b];
    int na = 0;
    for (int i = tid; i < P; i += NTP) na += o_alive[i];
    const int n_alive = block_reduce(na, Sum(), bi);
    const bool do_l = pend_l > 0 && n_alive > 2;
    const int vid = first_argmax(
        F32(U_LEAVE) + row, P, [&](int i) { return o_alive[i] != 0; },
        bi, bf);
    if (do_l)
      for (int i = tid; i < P; i += NTP)
        if (i == vid) o_alive[i] = 0;
    auto pool = [&](int i) { return !o_alive[i] && valid[i]; };
    int np = 0;
    for (int i = tid; i < P; i += NTP) np += pool(i);
    const bool do_j = pend_j > 0 && block_reduce(np, Sum(), bi) > 0;
    const int jid = first_argmax(F32(U_JOIN) + row, P, pool, bi, bf);
    if (do_j)
      for (int i = tid; i < P; i += NTP)
        if (i == jid) o_alive[i] = 1;
    int fr = INT32_MIN;
    for (int i = tid; i < P; i += NTP)
      if (o_alive[i]) fr = max(fr, o_steps[i]);
    const int fresh = block_reduce(fr, MaxI(), bi);
    if (do_j)
      for (int i = tid; i < P; i += NTP)
        if (i == jid) {
          o_steps[i] = fresh;
          o_comp[i] = 0;
          o_event[i] = t;
          o_ready[i] = t;
          o_blocked[i] = 0;
        }
    if (tid == 0) {
      I32(O_PEND_L)[b] = pend_l - (pend_l > 0);
      I32(O_PEND_J)[b] = pend_j - (pend_j > 0);
    }
  } else if (tid == 0) {
    I32(O_PEND_L)[b] = I32(PEND_L)[b];
    I32(O_PEND_J)[b] = I32(PEND_J)[b];
  }

  // 1. finishes: advance steps, become "deciding"
  int nf = 0;
  float last = -INFINITY;
  for (int i = tid; i < P; i += NTP) {
    const float ev = o_event[i];
    const bool fin = o_comp[i] && o_alive[i] && ev <= te;
    o_fin[i] = fin;
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

  // 2. alive-step extremes and the EMA max, for the decisions
  Stats st{INT32_MAX, INT32_MIN, 0, -INFINITY};
  for (int i = tid; i < P; i += NTP) {
    const int s = o_steps[i], al = o_alive[i];
    if (al) {
      st.mn = min(st.mn, s);
      st.mx = max(st.mx, s);
      st.n += 1;
    }
    if (D.adaptive) st.emx = fmaxf(st.emx, al ? ema[i] : 0.0f);
  }
  st = block_reduce(st, StatsOp(), bst);
  const int min_alive = st.mn, max_alive = st.mx, n_alive = st.n;
  const float ema_max = D.adaptive ? st.emx : 0.0f;

  if (tid == 0) {
    int* ri = SCR(int, rowi) + 2 * static_cast<size_t>(b);
    float* rf = SCR(float, rowf) + 2 * static_cast<size_t>(b);
    ri[0] = min_alive;
    ri[1] = n_alive;
    rf[0] = row_unblock;
    rf[1] = ema_max;
    I32(O_NFIN)[b] = n_fin;
    I32(O_CTRL)[b] = 0;                  // decide_kernel adds to it
    if (D.adaptive) {
      // 3b. policy state from this tick's post-finish step spread
      const bool dssp = U8(IS_DSSP)[b];
      const bool ann = U8(IS_ANN)[b];
      const int gap = n_alive > 0 ? max_alive - min_alive : 0;
      const int stal = I32(STAL)[b], lo = I32(POL_LO)[b];
      const int blo = I32(BETA_LO)[b], bhi = I32(BETA)[b];
      I32(O_THR)[b] = dssp ? min(max(gap, lo), stal) : I32(POL_THR)[b];
      I32(O_BETA)[b] = ann ? min(max(blo + gap - stal, blo), bhi)
                           : I32(POL_BETA)[b];
    }
  }
}

// 2. Barrier decisions, start / re-poll: one block per (row, TN nodes).
// Warps 0 and 1 own the block's nodes, one thread each; the beta-sample's
// two passes over the peer axis run one warp per deciding node, over all
// NWD warps of the block.  STAGE: the row's steps and alive flags (5 P
// bytes) are copied into shared memory first; a row too long for a
// block's shared memory is read from global memory instead (the prologue
// wrote it; it stays in L2), the same loops on another pointer.
template <bool STAGE>
__global__ void __launch_bounds__(NTD, 4) decide_kernel(Slots a, Dims D) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ int cand_idx[TN];
  __shared__ int cand_st[TN];
  __shared__ u8 cand_pass[TN];
  __shared__ int wcnt[NWN];
  const int P = D.P, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  if (!row_active(a, D, b)) return;      // the prologue wrote the row
  const size_t row = static_cast<size_t>(b) * P;
  const float te = D.t + D.eps;
  const int* steps_s = I32(O_STEPS) + row;
  const u8* alive_s = U8(O_ALIVE) + row;
  if (STAGE) {
    int* st_s = reinterpret_cast<int*>(dsm);
    u8* al_s = dsm + 4 * static_cast<size_t>(P);
    for (int j = tid; j < P; j += NTD) {
      st_s[j] = steps_s[j];
      al_s[j] = alive_s[j];
    }
    steps_s = st_s;
    alive_s = al_s;
    __syncthreads();
  }

  const int* ri = SCR(int, rowi) + 2 * static_cast<size_t>(b);
  const float* rf = SCR(float, rowf) + 2 * static_cast<size_t>(b);
  const int min_alive = ri[0], n_alive = ri[1];
  const float row_unblock = rf[0], ema_max = rf[1];
  const bool is_asp = U8(IS_ASP)[b], fv = U8(FULL_VIEW)[b];
  const bool smp = U8(SAMPLED)[b];
  const bool dssp = D.adaptive && U8(IS_DSSP)[b];
  const bool ebsp = D.adaptive && U8(IS_EBSP)[b];
  const bool ann = D.adaptive && U8(IS_ANN)[b];
  const int beta_row = ann ? I32(POL_BETA)[b] : I32(BETA)[b];
  // sample slots the plain version consults: min(beta, k), k = min(k_max, P)
  const int kb = max(0, min(beta_row, min(D.k_max, P)));
  const float* samp = static_cast<const float*>(a.p[SAMP]);
  const float* ema = D.adaptive ? F32(POL_EMA) + row : nullptr;

  const int i = blockIdx.x * TN + tid;
  const bool valid = wid < NWN && i < P;
  bool cand = false, passed = true, rank = false;
  unsigned bal = 0;
  int st = I32(STAL)[b];
  if (wid < NWN) {
    int nsamp = 0;
    if (valid) {
      const int al = alive_s[i], si = steps_s[i];
      cand = !U8(O_COMP)[row + i] && al && F32(O_EVENT)[row + i] <= te;
      if (dssp) {
        st = I32(POL_THR)[b];
      } else if (ebsp) {
        const float frac = 1.0f - ema[i] / fmaxf(ema_max, 1e-9f);
        st = static_cast<int>(floorf(F32(EBSP_RANGE)[b] * frac));
      }
      if (D.k_max > 0) {
        const int pop = D.masked ? n_alive - (al ? 1 : 0) : P - 1;
        nsamp = max(0, min(kb, pop));
      }
      if (cand && !is_asp) {
        if (fv) {
          passed = si - min_alive <= st;
        } else if (D.k_max > 0 && kb > 0) {
          if (D.k_max == 1 && !D.masked) {   // beta = 1: exact gather
            const int draw = static_cast<int>(
                floorf(samp[i] * static_cast<float>(max(P - 1, 1))));
            const int take = min(draw + (draw >= i ? 1 : 0), P - 1);
            passed = !(P > 1 && si - steps_s[take] > st);
          } else {
            rank = true;
          }
        }
      }
    }
    // control messages: an exact integer row count
    int ctrl = cand ? nsamp * I32(DIST_HOPS)[b] : 0;
    for (int o = 16; o > 0; o >>= 1) ctrl += __shfl_xor_sync(FULL, ctrl, o);
    if (lane == 0 && ctrl != 0) atomicAdd(I32(O_CTRL) + b, ctrl);
    // the nodes that need the beta-sample, compacted in node order
    bal = __ballot_sync(FULL, rank);
    if (lane == 0) wcnt[wid] = __popc(bal);
  }
  __syncthreads();
  int slot = 0, n_rank = 0;
  for (int w = 0; w < NWN; ++w) {
    slot += w < wid ? wcnt[w] : 0;
    n_rank += wcnt[w];
  }
  slot += __popc(bal & lanes_below());
  if (rank) {
    cand_idx[slot] = i;
    cand_st[slot] = st;
  }
  __syncthreads();

  // beta-sample, one warp per node: is any lagging eligible peer among
  // the kb lowest (score, index) eligible peers?  Each lane loads U
  // scores before it compares, so a pass waits on few round trips.
  constexpr int U = 16;
  for (int c = wid; c < n_rank; c += NWD) {
    const int ci = cand_idx[c], cst = cand_st[c], si = steps_s[ci];
    const float* __restrict__ sc =
        samp + (D.masked ? (row + ci) : static_cast<size_t>(ci)) *
                   static_cast<size_t>(P);
    // pass 1: the lowest (score, index) lagging eligible peer
    float bs = 3.0f;
    int bj = P;
    for (int j0 = lane; j0 < P; j0 += 32 * U) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u;
        v[u] = j < P ? sc[j] : 3.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u;
        const bool lag = j < P && j != ci && (!D.masked || alive_s[j]) &&
                         si - steps_s[j] > cst && v[u] < bs;
        bs = lag ? v[u] : bs;
        bj = lag ? j : bj;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bs, o);
      const int oj = __shfl_xor_sync(FULL, bj, o);
      if (ov < bs || (ov == bs && oj < bj)) {
        bs = ov;
        bj = oj;
      }
    }
    // pass 2: it is sampled iff fewer than kb eligible peers precede it
    bool ok = true;
    if (bj < P) {
      int before = 0;
      for (int j0 = 0; j0 < P && before < kb; j0 += 32 * U) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + 32 * u + lane;
          v[u] = j < P ? sc[j] : 3.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + 32 * u + lane;
          const bool pre = j < P && j != ci && (!D.masked || alive_s[j]) &&
                           (v[u] < bs || (v[u] == bs && j < bj));
          before += __popc(__ballot_sync(FULL, pre));
        }
      }
      ok = before >= kb;
    }
    if (lane == 0) cand_pass[c] = ok;
  }
  __syncthreads();
  if (!valid) return;

  // 3. start or re-poll, node by node
  if (rank) passed = cand_pass[slot];
  const size_t n = row + i;
  const bool start = cand && passed;
  const float dur = F32(CT_)[n] * (1.0f + (F32(DUR)[n] - 0.5f));
  if (cand) {
    const bool fail = !passed;
    float rd = F32(O_READY)[n];
    float ev = F32(O_EVENT)[n];
    bool bl = U8(O_BLOCKED)[n];
    const float t0 = (bl && fv) ? fmaxf(row_unblock, rd) : rd;
    if (start) {
      ev = t0 + dur;
      U8(O_COMP)[n] = 1;
    }
    bl = (bl || fail) && !start;
    if (fail && smp) {
      rd = rd + D.poll;
      ev = rd;
    }
    F32(O_EVENT)[n] = ev;
    F32(O_READY)[n] = rd;
    U8(O_BLOCKED)[n] = bl;
  }
  U8(O_START)[n] = start;
  if (D.adaptive) {
    const float alpha = F32(EBSP_ALPHA)[b];
    F32(O_EMA)[n] = (ebsp && start) ? (1.0f - alpha) * ema[i] + alpha * dur
                                    : ema[i];
  }
}

// 3. Residual of every finisher: one block per node p (MM >= m: the
// minibatch rows' accumulators are compile-time registers).  X[p] is
// staged in shared memory (in column chunks of dc) and used by every row
// that pushed p, one warp per row: X is read from device memory once.
// Each warp reads its finisher's old view.  Every thread puts LX (X) or
// 2 LV (view, w_true) 16-byte loads in flight before it waits on one.
template <int MM>
__global__ void __launch_bounds__(NTR, 3) resid_kernel(Slots a, Dims D) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ int wc[NWR];
  float* xs = reinterpret_cast<float*>(dsm);            // [m][dc]
  int* rows = reinterpret_cast<int*>(dsm + 4 * XS);     // rows that pushed p
  const int p = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int B = D.B, P = D.P, d = D.d, m = D.m;
  const u8* fin = U8(O_FIN);
  int nr = 0;
  for (int base = 0; base < B; base += NTR) {
    const int b = base + tid;
    const bool f = b < B && fin[static_cast<size_t>(b) * P + p];
    const unsigned bal = __ballot_sync(FULL, f);
    __syncthreads();                     // wc may hold the previous round
    if (lane == 0) wc[wid] = __popc(bal);
    __syncthreads();
    int off = nr;
    for (int w = 0; w < NWR; ++w) {
      off += w < wid ? wc[w] : 0;
      nr += wc[w];
    }
    if (f) rows[off + __popc(bal & lanes_below())] = b;
  }
  if (nr == 0) return;                   // no row pushed p
  __syncthreads();                       // rows is complete
  const float* __restrict__ xp = F32(X) + static_cast<size_t>(p) * m * d;
  const bool vec = (d & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(xp) |
        reinterpret_cast<uintptr_t>(F32(PULLED)) |
        reinterpret_cast<uintptr_t>(F32(W_TRUE))) & 15) == 0;
  const int dc = resid_chunk<MM>(d);
  float* resid = SCR(float, resid);
  int loaded = -1;                       // X column chunk in xs
  for (int r0 = 0; r0 < nr; r0 += NWR) {
    const bool mine = r0 + wid < nr;
    const int b = mine ? rows[r0 + wid] : 0;
    const size_t node = static_cast<size_t>(b) * P + p;
    float acc[MM];
#pragma unroll
    for (int k = 0; k < MM; ++k) acc[k] = 0.0f;
    for (int c0 = 0; c0 < d; c0 += dc) {
      const int w = min(dc, d - c0);
      if (c0 != loaded) {
      loaded = c0;
      __syncthreads();                   // the previous chunk is consumed
      if (vec) {                         // 16-byte loads of X[p]'s chunk,
        const int w4 = w >> 2, dc4 = dc >> 2, d4 = d >> 2;   // LX at once
        const float4* __restrict__ x4 = reinterpret_cast<const float4*>(xp);
        float4* xs4 = reinterpret_cast<float4*>(xs);
        for (int q0 = tid; q0 < m * w4; q0 += NTR * LX) {
          float4 xv[LX];
#pragma unroll
          for (int j = 0; j < LX; ++j) {
            const int q = q0 + j * NTR, k = q / w4;
            if (q < m * w4)
              xv[j] = x4[static_cast<size_t>(k) * d4 + c0 / 4 + q - k * w4];
          }
#pragma unroll
          for (int j = 0; j < LX; ++j) {
            const int q = q0 + j * NTR, k = q / w4;
            if (q < m * w4) xs4[k * dc4 + q - k * w4] = xv[j];
          }
        }
      } else {
#pragma unroll 4
        for (int q = tid; q < m * w; q += NTR) {
          const int k = q / w, c = q - k * w;
          xs[k * dc + c] = xp[static_cast<size_t>(k) * d + c0 + c];
        }
      }
      __syncthreads();
      }
      if (!mine) continue;
      const float* __restrict__ view = F32(PULLED) + node * d + c0;
      const float* __restrict__ wt =
          F32(W_TRUE) + static_cast<size_t>(b) * d + c0;
      if (vec) {
        const int w4 = w >> 2, dc4 = dc >> 2;
        const float4* __restrict__ v4 = reinterpret_cast<const float4*>(view);
        const float4* __restrict__ t4 = reinterpret_cast<const float4*>(wt);
        const float4* xs4 = reinterpret_cast<const float4*>(xs);
        for (int c0v = lane; c0v < w4; c0v += 32 * LV) {
          float4 v[LV], t[LV];             // LV vectors of view and w_true
#pragma unroll
          for (int j = 0; j < LV; ++j) {
            const int c = c0v + 32 * j;
            if (c < w4) {
              v[j] = v4[c];
              t[j] = t4[c];
            }
          }
#pragma unroll
          for (int j = 0; j < LV; ++j) {
            const int c = c0v + 32 * j;
            if (c >= w4) break;
            const float dx = v[j].x - t[j].x, dy = v[j].y - t[j].y;
            const float dz = v[j].z - t[j].z, dw = v[j].w - t[j].w;
#pragma unroll
            for (int k = 0; k < MM; ++k) {
              if (k < m) {
                const float4 x = xs4[k * dc4 + c];
                acc[k] += x.x * dx;
                acc[k] += x.y * dy;
                acc[k] += x.z * dz;
                acc[k] += x.w * dw;
              }
            }
          }
        }
      } else {
        for (int c = lane; c < w; c += 32) {
          const float df = view[c] - wt[c];
#pragma unroll
          for (int k = 0; k < MM; ++k)
            if (k < m) acc[k] += xs[k * dc + c] * df;
        }
      }
    }
    if (!mine) continue;
    const float ns = F32(NOISE_STD)[b];
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (k < m) {
        const float s = warp_sum(acc[k]);
        if (lane == 0)
          resid[node * m + k] =
              s - ns * F32(MB)[static_cast<size_t>(p) * m + k];
      }
    }
  }
}

// 4. Gradient partial sums: one block per (CT columns, PC nodes, RGS
// rows), a product of the block's residuals (RGS x PC*m) and X tile
// (PC*m x CT) in stages of SN nodes, each thread a 4 x 4 tile of (row,
// column).  A stage whose nodes no row pushed is skipped; a row that did
// not push a node multiplies its X rows by zero.  Each stage's loads go
// into registers together before any is stored, so a stage waits on about
// one round trip; the X tile in shared memory serves all RGS rows, so X
// is read from device memory once.
template <int MM>
__global__ void __launch_bounds__(NTG, 2) grad_kernel(Slots a, Dims D) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ u8 fs[RGS * SN];                         // fin of (row, node)
  float* xs = reinterpret_cast<float*>(dsm);          // [SN * m][CT]
  float* rs = xs + SN * MM * CT;                   // [RGS][SN * MM]
  constexpr int QS = SN * MM, CT4 = CT / 4;
  const int m = D.m, d = D.d, P = D.P, B = D.B, tid = threadIdx.x;
  const int tx = tid % CT4, ty = tid / CT4;           // 4 columns, 4 rows
  const int col0 = blockIdx.x * CT;
  const int b0 = blockIdx.z * RGS, nb = min(RGS, B - b0);
  const u8* fin = U8(O_FIN);
  const float* __restrict__ resid = SCR(float, resid);
  const float* __restrict__ X_ = F32(X);
  const bool vec = (d & 3) == 0 && (reinterpret_cast<uintptr_t>(X_) & 15) == 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int st = 0; st < PC / SN; ++st) {
    const int ps = blockIdx.y * PC + st * SN, nps = min(SN, P - ps);
    if (nps <= 0) break;
    const int qn = nps * m;                           // (node, k) pairs
    bool f = false;
    if (tid < RGS * SN) {
      const int r = tid / SN, pl = tid % SN;
      f = r < nb && pl < nps && fin[static_cast<size_t>(b0 + r) * P + ps + pl];
      fs[tid] = f;
    }
    if (!__syncthreads_or(f)) continue;   // also: the last stage is consumed
    // residuals of the stage: zero where the row did not push the node
    constexpr int RPT = RGS * QS / NTG;
    float rv[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int idx = tid + j * NTG, r = idx / QS, q = idx % QS;
      rv[j] = (q < qn && fs[r * SN + q / m])
                  ? resid[(static_cast<size_t>(b0 + r) * P + ps) * m + q]
                  : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) rs[tid + j * NTG] = rv[j];
    if (vec) {                         // 16-byte loads of the X tile
      constexpr int XPT = QS * CT4 / NTG;
      const int d4 = d >> 2;
      const float4* __restrict__ X4 = reinterpret_cast<const float4*>(X_);
      float4 xv[XPT];
#pragma unroll
      for (int j = 0; j < XPT; ++j) {
        const int idx = tid + j * NTG, q = idx / CT4, c4 = idx % CT4;
        xv[j] = (q < qn && col0 + 4 * c4 < d)
                    ? X4[(static_cast<size_t>(ps) * m + q) * d4 + col0 / 4 + c4]
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < XPT; ++j)
        reinterpret_cast<float4*>(xs)[tid + j * NTG] = xv[j];
    } else {
      for (int idx = tid; idx < QS * CT; idx += NTG) {
        const int q = idx / CT, c = idx % CT;
        xs[idx] = (q < qn && col0 + c < d)
                      ? X_[(static_cast<size_t>(ps) * m + q) * d + col0 + c]
                      : 0.0f;
      }
    }
    __syncthreads();
    for (int q = 0; q < qn; ++q) {
      const float4 x = reinterpret_cast<const float4*>(xs + q * CT)[tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float r = rs[(4 * ty + i) * QS + q];
        acc[i][0] = fmaf(r, x.x, acc[i][0]);
        acc[i][1] = fmaf(r, x.y, acc[i][1]);
        acc[i][2] = fmaf(r, x.z, acc[i][2]);
        acc[i][3] = fmaf(r, x.w, acc[i][3]);
      }
    }
  }
  float* part = SCR(float, part);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, b = b0 + r;
    if (r >= nb || I32(O_NFIN)[b] == 0) continue;
    float* o = part + (static_cast<size_t>(blockIdx.y) * B + b) * d + col0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col0 + 4 * tx + j < d) o[4 * tx + j] = acc[i][j];
  }
}

// 5. Server update and pull: one block per (CT columns, row).  Adds the
// partial sums in node-block order, updates w in place and writes the new
// model into the starters' views in place.  The row's starters are
// listed in shared memory a tile of `D.ftile` nodes at a time: one tile
// when the whole row fits, several for a row too long for the block's
// shared memory.
__global__ void __launch_bounds__(NTF) finish_kernel(Slots a, Dims D) {
  extern __shared__ int slist[];                      // a tile's starters
  __shared__ __align__(16) float ws[CT];
  __shared__ int wc[NWF];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  if (!row_active(a, D, b)) return;
  const int P = D.P, d = D.d, B = D.B;
  const int col0 = blockIdx.x * CT;
  const size_t row = static_cast<size_t>(b) * P;
  if (tid < CT) {
    const int col = col0 + tid;
    float v = 0.0f;
    if (col < d) {
      const size_t o = static_cast<size_t>(b) * d + col;
      v = F32(W)[o];
      if (I32(O_NFIN)[b] > 0) {
        const float* part = SCR(float, part);
        float g = 0.0f;
        for (int ch0 = 0; ch0 < D.nch; ch0 += LB) {  // LB loads, then adds
          float pv[LB];
#pragma unroll
          for (int j = 0; j < LB; ++j)
            pv[j] = ch0 + j < D.nch
                        ? part[(static_cast<size_t>(ch0 + j) * B + b) * d + col]
                        : 0.0f;
#pragma unroll
          for (int j = 0; j < LB; ++j)
            if (ch0 + j < D.nch) g += pv[j];
        }
        v = v - F32(LR)[b] * (g / static_cast<float>(D.m));
        F32(W)[o] = v;
      }
    }
    ws[tid] = v;
  }
  const u8* start = U8(O_START) + row;
  float* pulled = F32(PULLED);
  const bool vec = (d & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(pulled) & 15) == 0;
  for (int t0 = 0; t0 < P; t0 += D.ftile) {
    const int tend = min(P, t0 + D.ftile);
    int n_start = 0;
    for (int base = t0; base < tend; base += NTF) {
      const int j = base + tid;
      const bool s = j < tend && start[j];
      const unsigned bal = __ballot_sync(FULL, s);
      __syncthreads();                   // wc may hold the previous round
      if (lane == 0) wc[wid] = __popc(bal);
      __syncthreads();
      int off = n_start;
      for (int w = 0; w < NWF; ++w) {
        off += w < wid ? wc[w] : 0;
        n_start += wc[w];
      }
      if (s) slist[off + __popc(bal & lanes_below())] = j;
    }
    __syncthreads();
    for (int q = wid; q < n_start; q += NWF) {
      float* v = pulled + (row + slist[q]) * d + col0;
      if (vec) {
        if (col0 + 4 * lane < d)
          reinterpret_cast<float4*>(v)[lane] =
              reinterpret_cast<const float4*>(ws)[lane];
      } else {
        for (int cc = lane; cc < CT && col0 + cc < d; cc += 32) v[cc] = ws[cc];
      }
    }
    __syncthreads();                     // slist is read before the next tile
  }
}

cudaError_t smem_attr(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Dynamic shared memory a block of `fn` may opt into on `dev`: the
// card's opt-in maximum less the kernel's static shared memory.  Read
// once per (device, kernel) and kept.
constexpr int MAX_DEV = 64;
cudaError_t smem_room(const void* fn, int slot, int dev, size_t* room) {
  static long long cache[2][MAX_DEV];    // 0 = not read yet
  long long* c = dev < MAX_DEV ? &cache[slot][dev] : nullptr;
  if (c && *c > 0) {
    *room = static_cast<size_t>(*c - 1);
    return cudaSuccess;
  }
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, fn)) != cudaSuccess) return e;
  const long long r =
      max(0LL, static_cast<long long>(optin) -
                   static_cast<long long>(fa.sharedSizeBytes));
  if (c) *c = r + 1;
  *room = static_cast<size_t>(r);
  return cudaSuccess;
}

// Launches 3 and 4 for minibatches of at most MM rows.
template <int MM>
cudaError_t data_plane(const Slots& a, const Dims& D, cudaStream_t s) {
  const size_t smem_r = 4 * (static_cast<size_t>(XS) + D.B);
  cudaError_t e =
      smem_attr(reinterpret_cast<const void*>(resid_kernel<MM>), smem_r);
  if (e != cudaSuccess) return e;
  resid_kernel<MM><<<D.P, NTR, smem_r, s>>>(a, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smem_g = 4 * static_cast<size_t>(SN) * MM * (CT + RGS);
  if ((e = smem_attr(reinterpret_cast<const void*>(grad_kernel<MM>), smem_g)))
    return e;
  const dim3 grid((D.d + CT - 1) / CT, D.nch, (D.B + RGS - 1) / RGS);
  grad_kernel<MM><<<grid, NTG, smem_g, s>>>(a, D);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch buffer `psp_tick_launch` needs at these dims.
extern "C" long long psp_tick_scratch_bytes(int B, int P, int d, int m) {
  return static_cast<long long>(layout(B, P, d, m).total);
}

// ints: B, P, d, m, k_max, has_churn, masked, adaptive, device.
// floats: t, eps, poll.  Returns a cudaError_t (0 on success).
extern "C" int psp_tick_launch(void** ptrs, const int* ints,
                               const float* floats, void* stream) {
  Slots a;
  for (int i = 0; i < N_SLOTS; ++i) a.p[i] = ptrs[i];
  Dims D{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5], ints[6],
         ints[7], (ints[1] + PC - 1) / PC, floats[0], floats[1], floats[2],
         layout(ints[0], ints[1], ints[2], ints[3]), ints[1]};
  if (D.m > MAX_M || D.m < 1 || D.B < 1 || D.P < 1 || D.d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(ints[8]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned B = D.B, ncol = (D.d + CT - 1) / CT;

  prologue_kernel<<<B, NTP, 0, s>>>(a, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  // the decisions stage the row (5 P bytes) when a block can hold it
  const void* dk = reinterpret_cast<const void*>(decide_kernel<true>);
  size_t room = 0;
  if ((e = smem_room(dk, 0, ints[8], &room))) return static_cast<int>(e);
  const size_t smem_d = 5 * static_cast<size_t>(D.P);
  const dim3 grid_d((D.P + TN - 1) / TN, B);
  if (smem_d <= room) {
    if ((e = smem_attr(dk, smem_d))) return static_cast<int>(e);
    decide_kernel<true><<<grid_d, NTD, smem_d, s>>>(a, D);
  } else {
    decide_kernel<false><<<grid_d, NTD, 0, s>>>(a, D);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  if (D.m <= 8)
    e = data_plane<8>(a, D, s);
  else
    e = data_plane<MAX_M>(a, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);

  // the pull lists a row's starters in tiles of as many nodes as fit
  const void* fk = reinterpret_cast<const void*>(finish_kernel);
  if ((e = smem_room(fk, 1, ints[8], &room))) return static_cast<int>(e);
  D.ftile = static_cast<int>(min(static_cast<size_t>(D.P),
                                  max(room / 4, static_cast<size_t>(NTF))));
  const size_t smem_f = 4 * static_cast<size_t>(D.ftile);
  if ((e = smem_attr(fk, smem_f))) return static_cast<int>(e);
  finish_kernel<<<dim3(ncol, B), NTF, smem_f, s>>>(a, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
