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
// in float32 with the reference's expressions (expf, not __expf; IEEE
// division in the sigmoid; the build passes -fmad=false, so a * h + b
// rounds twice, as the reference's multiply and add do).  x, r_pre,
// i_pre, gate, y: (B, S, W) contiguous in T (float or bf16); lambda (W,),
// h0 and h_last (B, W) float32.  h_last is h at position S - 1, the f32
// value whose rounding is the last y.
//
// Bound on the H100: bytes.  At recurrentgemma-2b's prefill (B 4, S
// 4096, W 2560, bf16, gate fused) the kernel must move 419 MB, 0.125 ms
// at 3.35 TB/s.  Each element also costs ~90 instructions (two sigmoids
// with their IEEE divisions, three expf, a sqrt, the recurrence twice),
// ~0.11 ms of issue on 132 SMs, so the two limits are close and the
// kernel has to keep its loads in flight while it computes.  Parallelism
// over B * W alone (one serial walk of S per channel group) cannot fill
// 132 SMs evenly, so the sequence is split as well.  The design:
// * a tile is SEG steps (a segment) of CT channels (one 128-byte row a
//   step: 64 in bf16, 32 in float) of one batch row; tiles are numbered
//   segment by segment, every (batch row, channel tile) column of a
//   segment before the next segment;
// * persistent blocks (as many as fit, PREFILL_MINB an SM) take tiles
//   in that order from an atomic ticket, and bring each into a ring of
//   PREFILL_SLOTS shared-memory slots by TMA, one box of a 3-D tensor map
//   (W, S, B) per input, completing on the slot's mbarrier (rows past S
//   and channels past W read as zeros).  The copies of the next tiles
//   are in flight while a block forms, scans and carries the current
//   one;
// * a thread owns one 16-byte vector of channels (8 in bf16, 4 in
//   float) over PREFILL_L consecutive steps (a chunk), read from shared
//   memory 16 bytes at a time: it forms a and b in registers and
//   composes its chunk's affine map h -> A h + H;
// * the four chunks of a warp that share channels (lanes 8 apart)
//   compose their maps by a warp-shuffle scan; the first CT threads, one
//   channel each, then carry h across the block's warps in order, from
//   the h that enters the tile;
// * that h comes from the tile of the segment before (the same column),
//   which publishes the h leaving it, with the call's tag in the upper
//   half of one 64-bit word per channel, as soon as it has its own
//   entering h (before its rescan); the first segment starts from h0.
//   A tile waits only on a smaller ticket, whose block is resident and
//   waits only on smaller ones, so the chain cannot deadlock; the h's
//   are composed in one fixed order, so two calls agree bit for bit.
//   A thread-block cluster carrying h over distributed shared memory
//   was not built: it would hold a cluster's blocks in step, a segment
//   each, where the ticket lets each block take a tile when it is free,
//   and a tile's whole wait for its h is a small share of its time
//   (PERF.md, the RG-LRU scan's findings);
// * each thread rescans its chunk from the h entering it (a from
//   registers, b from the slot, where it was written over the x and r
//   the thread had read: registers are what limits the blocks an SM),
//   and writes y in 16-byte vectors (the gate read from the slot); the
//   slot is then refilled with the block's next ticket.
// The ticket, a count of finished blocks and the tag live in a scratch
// buffer the wrapper keeps per device and stream (zeroed when it is
// made); the last block to finish resets both counts and advances the
// tag, so no call needs a launch to clear it.  Each input is read once.
// A W whose rows are not 16-byte multiples (or an unaligned tensor:
// TMA's limits) takes the same path, each thread gathering its own bytes
// of the tile into the slot by predicated scalar loads, and storing y
// element by element.  A decode step (S <= DECODE_L) runs one warp a
// block, each thread one channel, which scans its steps alone.  Of the
// block shapes timed on the card (chip_variants.py), 256 threads of 2
// steps at three blocks an SM ran fastest; it fits ptxas's 80 registers
// a thread without a spill only because b waits in the slot and nothing
// else is held through the forming.  Two blocks an SM (two or three
// slots), 128-step tiles at one block an SM, 32-step tiles and blocks of
// 128 threads were slower.
// CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

// Per-phase block times: no-ops here; chip_variants.py builds a copy of
// this source that defines them to stamp each phase of each block.
#ifndef STAMP_BEGIN
#define STAMP_BEGIN()
#define STAMP(k)
#define STAMP_END(tiles)
#endif

namespace {

// the prefill's block: PREFILL_THREADS threads, each holding PREFILL_L
// steps of a tile, a ring of PREFILL_SLOTS tiles, PREFILL_MINB blocks an
// SM (the register cap); a call of at most DECODE_L steps (a decode
// step) runs rglru_decode_kernel instead
constexpr int PREFILL_THREADS = 256;
constexpr int PREFILL_L = 2;
constexpr int PREFILL_SLOTS = 2;
constexpr int PREFILL_MINB = 3;
constexpr int DECODE_L = 16;
// steps a tile of the backward, which reads the h entering each of the
// forward's tiles: the forward writes them (h_enter) only when its tiles
// are as long (a design variant with other tiles still runs serving)
constexpr int BWD_SEG = 64;
// the masked path (no TMA; its speed matters little) at most two blocks
// an SM, so that its gathers and element stores do not spill
constexpr int MASKED_MINB = PREFILL_MINB < 2 ? PREFILL_MINB : 2;

constexpr int ROW_BYTES = 128;          // a tile's row: a step of CT channels
constexpr int GROUPS = ROW_BYTES / 16;  // 16-byte vectors a row
constexpr int CTL_BYTES = 128;          // the scratch's counters, then h's

template <typename T>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);  // channels a thread
  static constexpr int CT = GROUPS * VEC;     // channels a tile
  static constexpr int NT = PREFILL_THREADS;
  static constexpr int NWARP = NT / 32;
  static constexpr int CPW = 32 / GROUPS;     // chunks a warp
  static constexpr int NCH = NT / GROUPS;     // chunks a tile
  static constexpr int L = PREFILL_L;
  static constexpr int SEG = NCH * L;         // steps a tile
  static constexpr int NS = PREFILL_SLOTS;
  static constexpr int ARR = SEG * ROW_BYTES;  // one input's tile, bytes
  static_assert(NT % 32 == 0 && NS >= 2 && CT <= NT && SEG <= 256,
                "tile shape");
  // dynamic shared memory: alignment slack, the slots, the warps' maps
  // and entering h, the slots' coefficients, their mbarriers and
  // tickets, the call's tag
  static constexpr int smem(int narr) {
    return 128 + NS * narr * ARR + 4 * (3 * NWARP + NS) * CT + 8 * NS +
           4 * NS + 4;
  }
};

template <typename T>
struct Args {
  const T* x;
  const T* r;
  const T* i;
  const T* gate;
  const float* lam;
  const float* h0;
  T* y;
  float* h_last;
  float* h_enter;            // (B, nseg, W) h entering each tile, or null
  unsigned* ctl;             // ticket, finished blocks, the last call's tag
  unsigned long long* carry;  // (column, segment, CT) h leaving each tile
  int B, S, W;
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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// softplus as jax.nn.softplus evaluates it: max(x, 0) + log1p(exp(-|x|))
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// a, b of one element from its x, r_pre, i_pre and its channel's coef
__device__ __forceinline__ void form(float x, float rp, float ip, float coef,
                                     float& a, float& b) {
  const float r = sigmoid(rp), i = sigmoid(ip);
  const float log_a = coef * r;
  const float mult = sqrtf(fminf(fmaxf(1.f - expf(2.f * log_a), 0.f), 1.f));
  a = expf(log_a);
  b = (mult * i) * x;
}

// 16 bytes of T as VEC floats, and back (bf16: channel order low half
// first, as in memory)
__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
// channels 4q .. 4q + 3 of the 16 bytes at p
template <typename T>
__device__ __forceinline__ void unpack4(const unsigned char* p, int q,
                                        float (&f)[4]);
template <>
__device__ __forceinline__ void unpack4<float>(const unsigned char* p, int,
                                               float (&f)[4]) {
  unpack(*reinterpret_cast<const uint4*>(p), f);
}
template <>
__device__ __forceinline__ void unpack4<__nv_bfloat16>(const unsigned char* p,
                                                       int q, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p + 8 * q);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
// two floats as bf16, the first in the low half
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// ---- PTX helpers -------------------------------------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive, and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait of more than ~2^34 cycles (seconds) is a fault and traps instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// order this thread's writes to shared memory before later TMA writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// device-coherent (L2) accesses of the chain's words and counters
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

// ---- end of PTX helpers ------------------------------------------------- //

// the inputs' tensor maps (TMA path; unused on the masked path)
struct Maps {
  CUtensorMap m[4];  // x, r_pre, i_pre, gate
};

// Warp 0 readies slot s for ticket tk: its channels' coefficients, and
// (TMA path) one box per input, counted on its mbarrier.
template <typename T, bool GATE, bool TMA>
__device__ __forceinline__ void fill(const Args<T>& a, const Maps& maps,
                                     unsigned char* raw, float* sCoef,
                                     uint64_t* mbar, int s, int tk,
                                     int ntiles, int ncols, int nct,
                                     int lane) {
  using C = Tile<T>;
  constexpr int NARR = GATE ? 4 : 3;
  if (tk >= ntiles) return;
  const int seg = tk / ncols, col = tk - seg * ncols;
  const int b = col / nct, c0 = (col - b * nct) * C::CT;
  if constexpr (TMA) {
    if (lane == 0) {
      mbar_expect_tx(&mbar[s], NARR * C::ARR);
#pragma unroll
      for (int k = 0; k < NARR; ++k)
        tma_load_3d(raw + (s * NARR + k) * C::ARR, &maps.m[k], &mbar[s], c0,
                    seg * C::SEG, b);
    }
  }
  for (int ch = lane; ch < C::CT; ch += 32)
    sCoef[s * C::CT + ch] =
        c0 + ch < a.W ? -8.f * softplus(a.lam[c0 + ch]) : 0.f;
}

template <typename T, bool GATE, bool TMA>
__global__ void __launch_bounds__(PREFILL_THREADS,
                                  TMA ? PREFILL_MINB : MASKED_MINB)
    rglru_prefill_kernel(const __grid_constant__ Maps maps, const Args<T> a) {
  using C = Tile<T>;
  constexpr int NARR = GATE ? 4 : 3, VEC = C::VEC, L = C::L;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* sWA = reinterpret_cast<float*>(raw + C::NS * NARR * C::ARR);
  float* sWH = sWA + C::NWARP * C::CT;  // each warp's composed map
  float* sHw = sWH + C::NWARP * C::CT;  // the h entering each warp
  float* sCoef = sHw + C::NWARP * C::CT;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(sCoef + C::NS * C::CT);
  int* sTk = reinterpret_cast<int*>(mbar + C::NS);
  unsigned& sTag = *reinterpret_cast<unsigned*>(sTk + C::NS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane % GROUPS, cw = lane / GROUPS, chunk = tid / GROUPS;
  const int S = a.S, W = a.W;
  const int nct = (W + C::CT - 1) / C::CT, ncols = a.B * nct;
  const int nseg = (S + C::SEG - 1) / C::SEG, ntiles = ncols * nseg;

  STAMP_BEGIN();
  if (tid == 0) {
    for (int s = 0; s < C::NS; ++s) mbar_init(&mbar[s], 1);
    mbar_fence_init();
    sTag = ld_relaxed(&a.ctl[2]) + 1;
    for (int s = 0; s < C::NS; ++s)
      sTk[s] = static_cast<int>(atomicAdd(&a.ctl[0], 1u));
  }
  __syncthreads();
  const unsigned tag = sTag;
  if (warp == 0)
    for (int s = 0; s < C::NS; ++s)
      fill<T, GATE, TMA>(a, maps, raw, sCoef, mbar, s, sTk[s], ntiles, ncols,
                         nct, lane);
  __syncthreads();

  int tiles = 0;
  for (int n = 0;; ++n) {
    const int s = n % C::NS, tk = sTk[s];
    if (tk >= ntiles) break;  // the block's later tickets are larger
    ++tiles;
    const int seg = tk / ncols, col = tk - seg * ncols;
    const int b = col / nct, c0 = (col - b * nct) * C::CT;
    const int t0 = seg * C::SEG, tc = t0 + chunk * L;  // tile's, chunk's
    const int cv = c0 + g * VEC;  // this thread's first channel
    // this thread's 16 bytes of its first step of x in the slot (step k
    // of input q: + k rows, + q inputs)
    unsigned char* const mine =
        raw + (s * NARR) * C::ARR + chunk * L * ROW_BYTES + 16 * g;
    if constexpr (TMA) {
      mbar_wait(&mbar[s], (n / C::NS) & 1);
    } else {  // the masked path: each thread gathers its own bytes
#pragma unroll 1
      for (int kq = 0; kq < L * NARR; ++kq) {  // step k of input q
        const int k = kq / NARR, q = kq - k * NARR;
        const T* src = q == 0 ? a.x : q == 1 ? a.r : q == 2 ? a.i : a.gate;
        const long long o = (static_cast<long long>(b) * S + tc + k) * W + cv;
        T* dst = reinterpret_cast<T*>(mine + q * C::ARR + k * ROW_BYTES);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          dst[v] = tc + k < S && cv + v < W ? src[o + v] : from_f<T>(0.f);
      }
    }
    STAMP(0);

    // a and b of this thread's L steps, composed as they are formed into
    // its chunk's map h -> A h + H; b is written over the x (and r) just
    // read, for the rescan (registers are what limits the blocks an SM)
    float av[L][VEC], A[VEC], H[VEC];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      unsigned char* p = mine + k * ROW_BYTES;
      float xs[VEC];  // all of x: b overwrites it
      unpack(*reinterpret_cast<const uint4*>(p), xs);
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {  // four channels at a time
        float rq[4], iq[4];
        unpack4<T>(p + C::ARR, q, rq);
        unpack4<T>(p + 2 * C::ARR, q, iq);
        const float4 cq = *reinterpret_cast<const float4*>(
            &sCoef[s * C::CT + g * VEC + 4 * q]);
        const float coef[4] = {cq.x, cq.y, cq.z, cq.w};
        float bq[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = 4 * q + u;
          form(xs[v], rq[u], iq[u], coef[u], av[k][v], bq[u]);
          if (k == 0) {
            A[v] = av[0][v];
            H[v] = bq[u];
          } else {
            H[v] = av[k][v] * H[v] + bq[u];
            A[v] = A[v] * av[k][v];
          }
        }
        *reinterpret_cast<float4*>(p + q * C::ARR) =
            make_float4(bq[0], bq[1], bq[2], bq[3]);
      }
    }
    // the ticket that refills this slot, and (the first CT threads, one
    // channel each) the h leaving the tile before, asked for now: their
    // latency runs under the warp scan and the barrier (not earlier, so
    // that no register holds them through the forming)
    unsigned next = 0;
    if (tid == 0) next = atomicAdd(&a.ctl[0], 1u);
    const unsigned long long* prev =  // the tile before's, by channel
        a.carry +
        (static_cast<long long>(col) * nseg + (seg > 0 ? seg - 1 : 0)) * C::CT;
    unsigned long long word = 0;
    if (tid < C::CT && seg > 0) word = ld_relaxed(prev + tid);
    // the warp's chunks of these channels (lanes GROUPS apart) compose
    // their maps, earlier ones first: an inclusive shuffle scan
#pragma unroll
    for (int off = GROUPS; off < 32; off *= 2) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float Ap = __shfl_up_sync(0xffffffffu, A[v], off);
        const float Hp = __shfl_up_sync(0xffffffffu, H[v], off);
        if (lane >= off) {
          H[v] = A[v] * Hp + H[v];
          A[v] = A[v] * Ap;
        }
      }
    }
    if (cw == C::CPW - 1)
#pragma unroll
      for (int v = 0; v < VEC; v += 4) {
        *reinterpret_cast<float4*>(&sWA[warp * C::CT + g * VEC + v]) =
            make_float4(A[v], A[v + 1], A[v + 2], A[v + 3]);
        *reinterpret_cast<float4*>(&sWH[warp * C::CT + g * VEC + v]) =
            make_float4(H[v], H[v + 1], H[v + 2], H[v + 3]);
      }
    __syncthreads();  // (1) the warps' maps are in
    STAMP(1);

    // the carriers take the h entering the tile: h0 in the first
    // segment, else the h leaving the tile before once its word carries
    // this call's tag; they carry it across the warps in order and
    // publish the h leaving the tile for the next segment's tile
    if (tid < C::CT) {
      float h;
      if (seg == 0) {
        h = a.h0 != nullptr && c0 + tid < W
                ? a.h0[static_cast<long long>(b) * W + c0 + tid]
                : 0.f;
      } else {
        const long long t_wait = clock64();
        while (static_cast<unsigned>(word >> 32) != tag) {
          if (clock64() - t_wait > (1LL << 34)) __trap();
          word = ld_relaxed(prev + tid);
        }
        h = __uint_as_float(static_cast<unsigned>(word));
      }
      if (a.h_enter != nullptr && c0 + tid < W)  // the training forward's
        a.h_enter[(static_cast<long long>(b) * nseg + seg) * W + c0 + tid] = h;
      STAMP(2);
#pragma unroll
      for (int w = 0; w < C::NWARP; ++w) {
        sHw[w * C::CT + tid] = h;
        h = sWA[w * C::CT + tid] * h + sWH[w * C::CT + tid];
      }
      if (seg + 1 < nseg)
        st_relaxed(a.carry + (static_cast<long long>(col) * nseg + seg) *
                                 C::CT + tid,
                   static_cast<unsigned long long>(tag) << 32 |
                       __float_as_uint(h));
    }
    __syncthreads();  // (2) the h entering each warp is in
    STAMP(3);

    // the h entering the chunk: the warp's, through the maps of the
    // warp's chunks before this one (the chunk before hands it on); then
    // rescan the chunk from it, y in 16-byte vectors
    float h[VEC];
#pragma unroll
    for (int v = 0; v < VEC; v += 4) {
      const float4 hw =
          *reinterpret_cast<const float4*>(&sHw[warp * C::CT + g * VEC + v]);
      h[v] = hw.x, h[v + 1] = hw.y, h[v + 2] = hw.z, h[v + 3] = hw.w;
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float out = __shfl_up_sync(0xffffffffu, A[v] * h[v] + H[v],
                                       GROUPS);
      if (cw > 0) h[v] = out;
    }
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int t = tc + k;
      const unsigned char* p = mine + k * ROW_BYTES;
      float out[VEC];
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(p + q * C::ARR);
        out[4 * q] = f.x, out[4 * q + 1] = f.y, out[4 * q + 2] = f.z,
        out[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        h[v] = av[k][v] * h[v] + out[v];
        out[v] = h[v];
      }
      if (t >= S) continue;
      if constexpr (GATE) {
        float gs[VEC];
        unpack(*reinterpret_cast<const uint4*>(p + 3 * C::ARR), gs);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          out[v] = to_f(from_f<T>(out[v])) * gs[v];
      }
      const long long o = (static_cast<long long>(b) * S + t) * W + cv;
      if constexpr (TMA) {
        if (cv < W) *reinterpret_cast<uint4*>(a.y + o) = pack(out);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (cv + v < W) a.y[o + v] = from_f<T>(out[v]);
      }
      if (t == S - 1)
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (cv + v < W)
            a.h_last[static_cast<long long>(b) * W + cv + v] = h[v];
    }
    fence_proxy_async();  // the slot's writes before a TMA refill
    __syncthreads();      // (3) the slot and the warps' h are read
    if (warp == 0) {
      const int nt = static_cast<int>(__shfl_sync(0xffffffffu, next, 0));
      if (lane == 0) sTk[s] = nt;
      fill<T, GATE, TMA>(a, maps, raw, sCoef, mbar, s, nt, ntiles, ncols, nct,
                         lane);
    }
    STAMP(4);
  }
  STAMP_END(tiles);
  // the last block to finish clears the counts and publishes this call's
  // tag for the next call on the stream
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(&a.ctl[1], 1u) == gridDim.x - 1) {
      atomicExch(&a.ctl[0], 0u);
      atomicExch(&a.ctl[1], 0u);
      atomicExch(&a.ctl[2], tag);
    }
  }
}

// A decode step: one warp a block, a thread one channel, its S <=
// DECODE_L steps loaded in one batch and scanned from h0 in order.
template <typename T, bool GATE>
__global__ void __launch_bounds__(32) rglru_decode_kernel(const Args<T> a) {
  const int w = blockIdx.x * 32 + threadIdx.x, b = blockIdx.y;
  if (w >= a.W) return;
  const int S = a.S, W = a.W;
  const long long row = static_cast<long long>(b) * S;
  const float coef = -8.f * softplus(a.lam[w]);
  float h = a.h0 != nullptr ? a.h0[static_cast<long long>(b) * W + w] : 0.f;
  if (a.h_enter != nullptr)  // one tile: the h entering it is h0
    a.h_enter[static_cast<long long>(b) * W + w] = h;
  T xv[DECODE_L], rv[DECODE_L], iv[DECODE_L], gv[DECODE_L];
#pragma unroll
  for (int k = 0; k < DECODE_L; ++k) {  // one batch of independent loads
    const bool in = k < S;
    const long long o = (row + k) * W + w;
    xv[k] = in ? a.x[o] : from_f<T>(0.f);
    rv[k] = in ? a.r[o] : from_f<T>(0.f);
    iv[k] = in ? a.i[o] : from_f<T>(0.f);
    if constexpr (GATE) gv[k] = in ? a.gate[o] : from_f<T>(0.f);
  }
#pragma unroll
  for (int k = 0; k < DECODE_L; ++k) {
    if (k >= S) break;
    float av, bv;
    form(to_f(xv[k]), to_f(rv[k]), to_f(iv[k]), coef, av, bv);
    h = av * h + bv;
    const long long o = (row + k) * W + w;
    if constexpr (GATE)
      a.y[o] = from_f<T>(to_f(from_f<T>(h)) * to_f(gv[k]));
    else
      a.y[o] = from_f<T>(h);
  }
  a.h_last[static_cast<long long>(b) * W + w] = h;
}

// ---- backward ------------------------------------------------------------ //
//
// The VJP of the scan above (XLA's autodiff of the reference's
// associative_scan; the port's plain version is rglru_scan_bwd_ref), in
// the plain forward's roundings: given the cotangent dy of y (and dh_last
// of h_last, or none), with g_t = f32(cast(dy_t * gate_t)) under a gate
// (else f32(dy_t)) and dgate_t = cast(dy_t * cast(h_t)),
//
//   dh_t = g_t + a_{t+1} * dh_{t+1},  dh_{S-1} = g_{S-1} + dh_last
//   da_t = dh_t * h_{t-1},  db_t = dh_t        (h_{-1} = h0, or 0)
//   dx = cast(db * (mult * i)),  dmi = db * x
//   di_pre = cast(((dmi * mult) * (1 - i)) * i)
//   du = clip'(u) * (dmi * i) / (2 * mult),  u = 1 - exp(2 log_a)
//   dlog_a = da * a + 2 * (-du * exp(2 log_a))
//   dr_pre = cast(((dlog_a * coef) * (1 - r)) * r)
//   dlambda = ((sum over b, t of dlog_a * r) * -8) * exp(lambda - softplus)
//   dh0 = a_0 * dh_0
//
// (where exp(2 log_a) rounds to 1, mult is 0 and du is +-inf or NaN, as
// autograd's sqrt gives).  The carry c_t = a_{t+1} * dh_{t+1} entering
// step t (dh_last at S - 1) leaves it as c_{t-1} = a_t * (g_t + c_t): an
// affine map, so the forward's design runs here in reverse:
// * a tile is BWD_SEG steps (the forward's tiles, whose entering h the
//   training forward writes: h_enter) of CT = 4 * BWD_GROUPS channels of
//   one batch row; tiles are numbered segment by segment, the LAST
//   segment first, and persistent blocks (BWD_MINB an SM in bf16, one in
//   float32) take them in that order from an atomic ticket, bringing x,
//   r_pre, i_pre, dy and the gate into a ring of BWD_SLOTS slots by TMA
//   (one box each, completing on the slot's mbarrier; steps past S and
//   channels past W read as zeros).  Each input is read from device
//   memory once;
// * a thread owns 4 channels over L consecutive steps (a chunk): it
//   forms r, i, a, e2 = exp(2 log_a), mult and b once, keeps a and e2 in
//   registers and r, mult and i in the block's stash in shared memory
//   until the gradients, and composes its chunk's map of h forward (h ->
//   A h + H) and of the carry backward (c -> A_c c + P_c; steps past S
//   the identity, which the zero fill would not be);
// * the warp's chunks of the same channels compose both by shuffle
//   scans (h: earlier chunks first; the carry: later chunks first); CT
//   threads, one channel each, carry h across the warps in order from
//   h_enter, and beside them CT others the carry across them in reverse
//   from the carry that enters the tile: dh_last (or 0) in the last
//   segment, else the word that the next segment's tile published; they
//   publish the carry leaving the tile (dh0 in the first segment) in one
//   tagged 64-bit word a channel before any gradient is formed.  A tile
//   waits only on a smaller ticket, whose block is resident, so the
//   chain cannot deadlock (as the forward's);
// * each thread then rescans h over its chunk from the h entering it,
//   walks its steps from last to first from the carry entering its last
//   step, and writes dx, dr_pre, di_pre and dgate, 4 channels a store;
//   the tile's sums of dlog_a * r go, by shuffles and the warps in order,
//   to one partial a channel and tile, which rglru_bwd_lam_kernel sums
//   over the batch rows and tiles in order.  No atomics touch a value:
//   two calls agree bit for bit.
// The ticket, finished-block count, tag, the tiles' carry words and the
// partials live in a scratch buffer of the backward's own (the forward's
// counters are in another), kept per device and stream and zeroed when
// made; the last block resets the counts and advances the tag.  Rows not
// of 16-byte multiples and unaligned tensors take the same kernel, each
// thread gathering its bytes into the slot by predicated loads.
// Bound on the H100: bytes, 18 an element in bf16 (x, r_pre, i_pre, gate,
// dy read, dx, dr_pre, di_pre, dgate written), 0.113 ms at the training
// shape (B 2, S 4096, W 2560) at 3.35 TB/s; the forming of each element
// (two sigmoids and a division, two expf, a sqrt) costs about as much
// issue, so the loads of the next tiles stay in flight while a block
// forms and walks this one.  Of the shapes timed on the card
// (chip_variants.py), two blocks of 256 threads an SM ran fastest; a
// thread's 16 elements of the forward's 128-byte rows needed ~200
// registers and spilled at two blocks, three blocks an SM spilled at 80,
// and 512 threads at one block an SM, three slots, or 16-channel tiles
// at four blocks an SM were slower.
constexpr int BWD_THREADS = 256;
constexpr int BWD_GROUPS = 8;  // threads across a tile's row, 4 channels each
constexpr int BWD_SLOTS = 2;
// blocks an SM in bf16 (the register cap: 128 a thread); float32, whose
// 16-byte vectors need more, one
constexpr int BWD_MINB = 2;
// the dΛ sum's block: LAM_ROWS groups of tiles by 32 channels
constexpr int LAM_ROWS = 8;

template <typename T>
struct BwdTile {
  static constexpr int VEC = 4;                   // channels a thread
  static constexpr int TB = VEC * sizeof(T);      // its bytes of a row
  static constexpr int CT = BWD_GROUPS * VEC;     // channels a tile
  static constexpr int ROW = CT * sizeof(T);      // a row's bytes
  static constexpr int NT = BWD_THREADS;
  static constexpr int NWARP = NT / 32;
  static constexpr int CPW = 32 / BWD_GROUPS;     // chunks a warp
  static constexpr int NCH = NT / BWD_GROUPS;     // chunks a tile
  static constexpr int L = BWD_SEG / NCH;         // steps a chunk
  static constexpr int NS = BWD_SLOTS;
  static constexpr int ARR = BWD_SEG * ROW;       // one input's tile
  static constexpr int KEEP = BWD_SEG * CT;       // one kept value's floats
  static constexpr int MINB = sizeof(T) == 2 ? BWD_MINB : 1;
  static_assert(NT % 32 == 0 && NCH * L == BWD_SEG && NS >= 2 &&
                    2 * CT <= NT && 32 % BWD_GROUPS == 0,
                "backward tile shape");
  // dynamic shared memory: alignment slack, the slots, the tile's kept r,
  // mult and i, seven per-warp rows (the maps of h and of the carry, the
  // h and the carry entering each warp, the warps' dΛ sums), the slots'
  // coefficients, their mbarriers and tickets, the call's tag
  static constexpr int smem(int narr) {
    return 128 + NS * narr * ARR + 4 * 3 * KEEP +
           4 * (7 * NWARP + NS) * CT + 8 * NS + 4 * NS + 4;
  }
};

template <typename T>
struct BwdArgs {
  const T* x;
  const T* r;
  const T* i;
  const T* gate;        // or null
  const T* dy;
  const float* lam;
  const float* dh_last;  // (B, W) or null
  const float* h_enter;  // (B, nseg, W)
  T* dx;
  T* dr;
  T* di;
  T* dgate;              // or null (no gate)
  float* dlam;
  float* dh0;            // (B, W) or null (no h0)
  unsigned* ctl;         // ticket, finished blocks, the last call's tag
  unsigned long long* carry;  // (column, segment, CT) carry leaving a tile
  float* part;           // (B, nseg, W) dΛ's partial of each tile
  int B, S, W;
};

// the inputs' tensor maps (TMA path): x, r_pre, i_pre, dy, gate
struct BwdMaps {
  CUtensorMap m[5];
};

// Warp 0 readies slot s for ticket tk (the backward's fill).
template <typename T, bool GATE, bool TMA>
__device__ __forceinline__ void bwd_fill(const BwdArgs<T>& a,
                                         const BwdMaps& maps,
                                         unsigned char* raw, float* sCoef,
                                         uint64_t* mbar, int s, int tk,
                                         int ntiles, int ncols, int nct,
                                         int nseg, int lane) {
  using C = BwdTile<T>;
  constexpr int NARR = GATE ? 5 : 4;
  if (tk >= ntiles) return;
  const int q = tk / ncols, seg = nseg - 1 - q, col = tk - q * ncols;
  const int b = col / nct, c0 = (col - b * nct) * C::CT;
  if constexpr (TMA) {
    if (lane == 0) {
      mbar_expect_tx(&mbar[s], NARR * C::ARR);
#pragma unroll
      for (int k = 0; k < NARR; ++k)
        tma_load_3d(raw + (s * NARR + k) * C::ARR, &maps.m[k], &mbar[s], c0,
                    seg * BWD_SEG, b);
    }
  }
  for (int ch = lane; ch < C::CT; ch += 32)
    sCoef[s * C::CT + ch] =
        c0 + ch < a.W ? -8.f * softplus(a.lam[c0 + ch]) : 0.f;
}

// 4 floats from or to shared memory (16-byte aligned)
__device__ __forceinline__ void load_f(const float* p, float (&f)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
}
__device__ __forceinline__ void store_f(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// 4 channels of T at p (8 bytes of bf16, 16 of float) as floats, and
// 4 floats stored at p as T
template <typename T>
__device__ __forceinline__ void ld4(const void* p, float (&f)[4]);
template <>
__device__ __forceinline__ void ld4<float>(const void* p, float (&f)[4]) {
  unpack(*reinterpret_cast<const uint4*>(p), f);
}
template <>
__device__ __forceinline__ void ld4<__nv_bfloat16>(const void* p,
                                                   float (&f)[4]) {
  unpack4<__nv_bfloat16>(static_cast<const unsigned char*>(p), 0, f);
}
template <typename T>
__device__ __forceinline__ void st4(T* p, const float (&f)[4]);
template <>
__device__ __forceinline__ void st4<float>(float* p, const float (&f)[4]) {
  *reinterpret_cast<uint4*>(p) = pack(f);
}
template <>
__device__ __forceinline__ void st4<__nv_bfloat16>(__nv_bfloat16* p,
                                                   const float (&f)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack2(f[0], f[1]), pack2(f[2], f[3]));
}

// g = f32(cast(dy * gate)) under a gate, else dy
template <typename T, bool GATE>
__device__ __forceinline__ float cotangent(float dy, float gate) {
  return GATE ? to_f(from_f<T>(dy * gate)) : dy;
}

template <typename T, bool GATE, bool TMA>
__global__ void __launch_bounds__(BWD_THREADS,
                                  TMA ? BwdTile<T>::MINB : 1)
    rglru_bwd_kernel(const __grid_constant__ BwdMaps maps,
                     const BwdArgs<T> a) {
  using C = BwdTile<T>;
  constexpr int NARR = GATE ? 5 : 4, L = C::L, CT = C::CT, ROW = C::ROW;
  constexpr int NWARP = C::NWARP, CPW = C::CPW, ARR = C::ARR;
  constexpr int G = BWD_GROUPS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* sKeep = reinterpret_cast<float*>(raw + C::NS * NARR * ARR);
  float* sWA = sKeep + 3 * C::KEEP;  // each warp's map of h
  float* sWH = sWA + NWARP * CT;
  float* sCA = sWH + NWARP * CT;   // each warp's map of the carry
  float* sCP = sCA + NWARP * CT;
  float* sHw = sCP + NWARP * CT;   // the h entering each warp
  float* sCw = sHw + NWARP * CT;   // the carry entering its last step
  float* sLam = sCw + NWARP * CT;  // each warp's sums of dlog_a * r
  float* sCoef = sLam + NWARP * CT;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(sCoef + C::NS * CT);
  int* sTk = reinterpret_cast<int*>(mbar + C::NS);
  unsigned& sTag = *reinterpret_cast<unsigned*>(sTk + C::NS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane % G, cw = lane / G, chunk = tid / G;
  const int S = a.S, W = a.W;
  const int nct = (W + CT - 1) / CT, ncols = a.B * nct;
  const int nseg = (S + BWD_SEG - 1) / BWD_SEG, ntiles = ncols * nseg;
  // this thread's kept r, mult and i of its first step (+ CT a step)
  float* const keep_r = sKeep + chunk * L * CT + 4 * g;
  float* const keep_m = keep_r + C::KEEP;
  float* const keep_i = keep_m + C::KEEP;

  STAMP_BEGIN();
  if (tid == 0) {
    for (int s = 0; s < C::NS; ++s) mbar_init(&mbar[s], 1);
    mbar_fence_init();
    sTag = ld_relaxed(&a.ctl[2]) + 1;
    for (int s = 0; s < C::NS; ++s)
      sTk[s] = static_cast<int>(atomicAdd(&a.ctl[0], 1u));
  }
  __syncthreads();
  const unsigned tag = sTag;
  if (warp == 0)
    for (int s = 0; s < C::NS; ++s)
      bwd_fill<T, GATE, TMA>(a, maps, raw, sCoef, mbar, s, sTk[s], ntiles,
                             ncols, nct, nseg, lane);
  __syncthreads();

  int tiles = 0;
  for (int n = 0;; ++n) {
    const int s = n % C::NS, tk = sTk[s];
    if (tk >= ntiles) break;  // the block's later tickets are larger
    ++tiles;
    const int q = tk / ncols, seg = nseg - 1 - q, col = tk - q * ncols;
    const int b = col / nct, c0 = (col - b * nct) * CT;
    const int tc = seg * BWD_SEG + chunk * L;  // the chunk's first step
    const int cv = c0 + 4 * g;                 // this thread's first channel
    // this thread's bytes of its first step of x in the slot (step k of
    // input j: + k rows, + j inputs)
    unsigned char* const mine =
        raw + (s * NARR) * ARR + chunk * L * ROW + C::TB * g;
    float coef[4];
    load_f(sCoef + s * CT + 4 * g, coef);
    if constexpr (TMA) {
      mbar_wait(&mbar[s], (n / C::NS) & 1);
    } else {  // each thread gathers its own bytes
#pragma unroll 1
      for (int kj = 0; kj < L * NARR; ++kj) {  // step k of input j
        const int k = kj / NARR, j = kj - k * NARR;
        const T* src = j == 0   ? a.x
                       : j == 1 ? a.r
                       : j == 2 ? a.i
                       : j == 3 ? a.dy
                                : a.gate;
        const long long o = (static_cast<long long>(b) * S + tc + k) * W + cv;
        T* dst = reinterpret_cast<T*>(mine + j * ARR + k * ROW);
#pragma unroll
        for (int v = 0; v < 4; ++v)
          dst[v] = tc + k < S && cv + v < W ? src[o + v] : from_f<T>(0.f);
      }
    }
    STAMP(0);

    // form each element once: a and e2 kept in registers, r, mult and i
    // in the block's stash; the chunk's map of h, forward
    float av[L][4], ev[L][4], A[4], H[4];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const unsigned char* p = mine + k * ROW;
      float xs[4], rs[4], is[4], ms[4];
      ld4<T>(p, xs);
      ld4<T>(p + ARR, rs);
      ld4<T>(p + 2 * ARR, is);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float r = sigmoid(rs[v]), i = sigmoid(is[v]);
        const float log_a = coef[v] * r;
        const float at = expf(log_a);
        const float e2 = expf(2.f * log_a);
        const float mult = sqrtf(fminf(fmaxf(1.f - e2, 0.f), 1.f));
        const float bt = (mult * i) * xs[v];
        av[k][v] = at, ev[k][v] = e2;
        rs[v] = r, ms[v] = mult, is[v] = i;
        if (k == 0) {
          A[v] = at;
          H[v] = bt;
        } else {
          H[v] = at * H[v] + bt;
          A[v] = A[v] * at;
        }
      }
      store_f(keep_r + k * CT, rs);
      store_f(keep_m + k * CT, ms);
      store_f(keep_i + k * CT, is);
    }
    // the chunk's map of the carry, from its last step to its first
    // (steps past S: the identity)
    float Ac[4], Pc[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) Ac[v] = 1.f, Pc[v] = 0.f;
#pragma unroll
    for (int k = L - 1; k >= 0; --k) {
      const unsigned char* p = mine + k * ROW;
      float dys[4], gts[4] = {};
      ld4<T>(p + 3 * ARR, dys);
      if constexpr (GATE) ld4<T>(p + 4 * ARR, gts);
      const bool in = tc + k < S;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float gv = cotangent<T, GATE>(dys[v], gts[v]);
        const float P = av[k][v] * (gv + Pc[v]);
        const float Am = av[k][v] * Ac[v];
        Pc[v] = in ? P : Pc[v];
        Ac[v] = in ? Am : Ac[v];
      }
    }
    // the ticket that refills this slot; the carriers' (one channel a
    // thread: the carry's the first CT threads, h's the next CT) carry
    // and h entering the tile, asked for now: their latency runs under
    // the scans
    unsigned next = 0;
    if (tid == 0) next = atomicAdd(&a.ctl[0], 1u);
    const bool last = seg + 1 == nseg;
    const unsigned long long* later =  // the next segment's tile's words
        a.carry +
        (static_cast<long long>(col) * nseg + (last ? seg : seg + 1)) * CT;
    const int ch = tid < CT ? tid : tid - CT;  // a carrier's channel
    unsigned long long word = 0;
    float h_in = 0.f, c_in = 0.f;
    if (tid < CT) {
      if (!last) word = ld_relaxed(later + tid);
      if (last && a.dh_last != nullptr && c0 + tid < W)
        c_in = a.dh_last[static_cast<long long>(b) * W + c0 + tid];
    } else if (tid < 2 * CT && c0 + ch < W) {
      h_in = a.h_enter[(static_cast<long long>(b) * nseg + seg) * W + c0 + ch];
    }
    // the warp's chunks of these channels (lanes G apart) compose their
    // maps: h's earlier ones first, the carry's later ones first
#pragma unroll
    for (int off = G; off < 32; off *= 2) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float Ap = __shfl_up_sync(0xffffffffu, A[v], off);
        const float Hp = __shfl_up_sync(0xffffffffu, H[v], off);
        const float An = __shfl_down_sync(0xffffffffu, Ac[v], off);
        const float Pn = __shfl_down_sync(0xffffffffu, Pc[v], off);
        if (lane >= off) {
          H[v] = A[v] * Hp + H[v];
          A[v] = A[v] * Ap;
        }
        if (lane + off < 32) {
          Pc[v] = Ac[v] * Pn + Pc[v];
          Ac[v] = Ac[v] * An;
        }
      }
    }
    const int wo = warp * CT + 4 * g;
    if (cw == CPW - 1) {
      store_f(sWA + wo, A);
      store_f(sWH + wo, H);
    }
    if (cw == 0) {
      store_f(sCA + wo, Ac);
      store_f(sCP + wo, Pc);
    }
    __syncthreads();  // (1) the warps' maps are in
    STAMP(1);

    // the carriers: h across the warps in order; beside it, the carry
    // entering the tile (dh_last or 0 in the last segment, else the next
    // segment's word once it carries this call's tag) across them in
    // reverse, and the carry leaving the tile published before any
    // gradient is formed
    if (tid >= CT && tid < 2 * CT) {
      float h = h_in;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) {
        sHw[w * CT + ch] = h;
        h = sWA[w * CT + ch] * h + sWH[w * CT + ch];
      }
    } else if (tid < CT) {
      float c = c_in;
      if (!last) {
        const long long t_wait = clock64();
        while (static_cast<unsigned>(word >> 32) != tag) {
          if (clock64() - t_wait > (1LL << 34)) __trap();
          word = ld_relaxed(later + tid);
        }
        c = __uint_as_float(static_cast<unsigned>(word));
      }
      STAMP(2);
#pragma unroll
      for (int w = NWARP - 1; w >= 0; --w) {
        sCw[w * CT + tid] = c;
        c = sCA[w * CT + tid] * c + sCP[w * CT + tid];
      }
      if (seg > 0)
        st_relaxed(a.carry + (static_cast<long long>(col) * nseg + seg) * CT +
                       tid,
                   static_cast<unsigned long long>(tag) << 32 |
                       __float_as_uint(c));
      else if (a.dh0 != nullptr && c0 + tid < W)
        a.dh0[static_cast<long long>(b) * W + c0 + tid] = c;
    }
    __syncthreads();  // (2) the h and carry entering each warp are in
    STAMP(3);

    // the h entering the chunk (through the warp's chunks before it) and
    // the carry entering its last step (through the chunks after it)
    float hp[L][4], c[4];
    {
      float hw[4], cwv[4];
      load_f(sHw + wo, hw);
      load_f(sCw + wo, cwv);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float ho = __shfl_up_sync(0xffffffffu, A[v] * hw[v] + H[v], G);
        const float co =
            __shfl_down_sync(0xffffffffu, Ac[v] * cwv[v] + Pc[v], G);
        hp[0][v] = cw > 0 ? ho : hw[v];
        c[v] = cw < CPW - 1 ? co : cwv[v];
      }
    }
    // h entering each of the chunk's later steps (b formed again from the
    // kept mult and i: two products)
#pragma unroll
    for (int k = 1; k < L; ++k) {
      float xs[4], ms[4], is[4];
      ld4<T>(mine + (k - 1) * ROW, xs);
      load_f(keep_m + (k - 1) * CT, ms);
      load_f(keep_i + (k - 1) * CT, is);
#pragma unroll
      for (int v = 0; v < 4; ++v)
        hp[k][v] = av[k - 1][v] * hp[k - 1][v] + (ms[v] * is[v]) * xs[v];
    }
    // the chunk's steps from last to first
    float lam[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) lam[v] = 0.f;
#pragma unroll
    for (int k = L - 1; k >= 0; --k) {
      const int t = tc + k;
      const bool in = t < S;
      const unsigned char* p = mine + k * ROW;
      float xs[4], dys[4], gts[4] = {}, rs[4], ms[4], is[4];
      ld4<T>(p, xs);
      ld4<T>(p + 3 * ARR, dys);
      if constexpr (GATE) ld4<T>(p + 4 * ARR, gts);
      load_f(keep_r + k * CT, rs);
      load_f(keep_m + k * CT, ms);
      load_f(keep_i + k * CT, is);
      float fx[4], fr[4], fi[4], fg[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float r = rs[v], i = is[v], mult = ms[v];
        const float at = av[k][v], e2 = ev[k][v];
        const float u = 1.f - e2;
        const float mi = mult * i;
        const float h_prev = hp[k][v];
        const float gv = cotangent<T, GATE>(dys[v], gts[v]);
        if constexpr (GATE)  // h_t as the rescan formed it
          fg[v] = dys[v] * to_f(from_f<T>(at * h_prev + mi * xs[v]));
        const float dh = gv + c[v];
        const float dmi = dh * xs[v];
        fx[v] = dh * mi;
        fi[v] = ((dmi * mult) * (1.f - i)) * i;
        const float dsq = (dmi * i) / (2.f * mult);
        const float du = u >= 0.f && u <= 1.f ? dsq : 0.f;
        const float dlog_a = (dh * h_prev) * at + 2.f * (-du * e2);
        fr[v] = ((dlog_a * coef[v]) * (1.f - r)) * r;
        const float dl = lam[v] + dlog_a * r;
        lam[v] = in ? dl : lam[v];
        c[v] = in ? at * dh : c[v];
      }
      if (!in) continue;
      const long long o = (static_cast<long long>(b) * S + t) * W + cv;
      if constexpr (TMA) {
        if (cv < W) {
          st4<T>(a.dx + o, fx);
          st4<T>(a.dr + o, fr);
          st4<T>(a.di + o, fi);
          if constexpr (GATE) st4<T>(a.dgate + o, fg);
        }
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (cv + v < W) {
            a.dx[o + v] = from_f<T>(fx[v]);
            a.dr[o + v] = from_f<T>(fr[v]);
            a.di[o + v] = from_f<T>(fi[v]);
            if constexpr (GATE) a.dgate[o + v] = from_f<T>(fg[v]);
          }
      }
    }
    // the tile's sums of dlog_a * r: the warp's chunks by shuffles (every
    // lane gets the same bits), then the warps in order by the carriers
#pragma unroll
    for (int off = G; off < 32; off *= 2)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        lam[v] += __shfl_xor_sync(0xffffffffu, lam[v], off);
    if (cw == 0) store_f(sLam + wo, lam);
    STAMP(4);
    fence_proxy_async();  // the slot's writes before a TMA refill
    __syncthreads();      // (3) the slot and the warps' rows are read
    if (warp == 0) {
      const int nt = static_cast<int>(__shfl_sync(0xffffffffu, next, 0));
      if (lane == 0) sTk[s] = nt;
      bwd_fill<T, GATE, TMA>(a, maps, raw, sCoef, mbar, s, nt, ntiles, ncols,
                             nct, nseg, lane);
    }
    if (tid >= CT && tid < 2 * CT && c0 + ch < W) {
      float sum = sLam[ch];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) sum += sLam[w * CT + ch];
      a.part[(static_cast<long long>(b) * nseg + seg) * W + c0 + ch] = sum;
    }
    STAMP(5);
  }
  STAMP_END(tiles);
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(&a.ctl[1], 1u) == gridDim.x - 1) {
      atomicExch(&a.ctl[0], 0u);
      atomicExch(&a.ctl[1], 0u);
      atomicExch(&a.ctl[2], tag);
    }
  }
}

// dlambda from the tiles' partials: a block is 32 channels × LAM_ROWS
// threads; thread row j sums partials j, j + LAM_ROWS, ... in order, then
// row 0 sums the rows in order (a fixed order: two calls, same bits).
template <typename T>
__global__ void __launch_bounds__(32 * LAM_ROWS)
    rglru_bwd_lam_kernel(const BwdArgs<T> a) {
  __shared__ float rows[LAM_ROWS][32];
  const int ch = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int w = blockIdx.x * 32 + ch;
  const long long n =
      static_cast<long long>(a.B) * ((a.S + BWD_SEG - 1) / BWD_SEG);
  float s = 0.f;
  if (w < a.W) {
#pragma unroll 4
    for (long long k = j; k < n; k += LAM_ROWS) s += a.part[k * a.W + w];
  }
  rows[j][ch] = s;
  __syncthreads();
  if (j == 0 && w < a.W) {
#pragma unroll
    for (int q = 1; q < LAM_ROWS; ++q) s += rows[q][ch];
    const float lam = a.lam[w];
    a.dlam[w] = (s * -8.f) * expf(lam - softplus(lam));
  }
}

// ---- tensor maps ------------------------------------------------------- //

// cuTensorMapEncodeTiled, fetched from the driver at run time (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A contiguous (B, S, W) tensor of T as a 3-D map (W, S, B) whose boxes
// are one tile: `cols` channels × `steps` steps of one batch row,
// unswizzled; positions past S and channels past W read as zeros.
template <typename T>
bool tensor_map(CUtensorMap* map, const T* ptr, int B, int S, int W,
                int cols, int steps) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {sizeof(T) * static_cast<cuuint64_t>(W),
                                 sizeof(T) * static_cast<cuuint64_t>(S) * W};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(steps), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<T*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- end of tensor maps ------------------------------------------------ //

constexpr int MAXDEV = 64;

// Blocks of `kern` (`threads` threads, `smem` bytes of dynamic shared
// memory) resident on the whole card, found once per device into
// `slots[device]` (each kernel keeps its own table).
template <typename K>
cudaError_t resident(K kern, int threads, int smem, int device,
                     int (&slots)[MAXDEV]) {
  if (device < 0 || device >= MAXDEV) return cudaErrorInvalidDevice;
  if (slots[device] != 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  slots[device] = per_sm * sms;
  return cudaSuccess;
}

template <typename T, bool GATE, bool TMA>
cudaError_t launch_prefill(const Args<T>& a, int device, cudaStream_t s) {
  using C = Tile<T>;
  static int slots[MAXDEV] = {};  // blocks resident on the card, per device
  const auto kern = rglru_prefill_kernel<T, GATE, TMA>;
  const int smem = C::smem(GATE ? 4 : 3);
  cudaError_t e = resident(kern, C::NT, smem, device, slots);
  if (e != cudaSuccess) return e;
  const long long ntiles = static_cast<long long>(a.B) *
                           ((a.W + C::CT - 1) / C::CT) *
                           ((a.S + C::SEG - 1) / C::SEG);
  if (ntiles > (1LL << 30)) return cudaErrorInvalidValue;
  Maps maps = {};
  const auto map = [&](int k, const T* ptr) {
    return tensor_map(&maps.m[k], ptr, a.B, a.S, a.W, C::CT, C::SEG);
  };
  if (TMA && !(map(0, a.x) && map(1, a.r) && map(2, a.i) &&
               (!GATE || map(3, a.gate))))
    return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      ntiles < slots[device] ? ntiles : static_cast<long long>(slots[device]));
  kern<<<grid, C::NT, smem, s>>>(maps, a);
  return cudaGetLastError();
}

// The backward: its persistent kernel, then the dΛ sum.
template <typename T, bool GATE, bool TMA>
cudaError_t launch_bwd(const BwdArgs<T>& a, int device, cudaStream_t s) {
  using C = BwdTile<T>;
  static int slots[MAXDEV] = {};
  const auto kern = rglru_bwd_kernel<T, GATE, TMA>;
  const int smem = C::smem(GATE ? 5 : 4);
  cudaError_t e = resident(kern, C::NT, smem, device, slots);
  if (e != cudaSuccess) return e;
  const long long ntiles = static_cast<long long>(a.B) *
                           ((a.W + C::CT - 1) / C::CT) *
                           ((a.S + BWD_SEG - 1) / BWD_SEG);
  if (ntiles > (1LL << 30)) return cudaErrorInvalidValue;
  BwdMaps maps = {};
  const auto map = [&](int k, const T* ptr) {
    return tensor_map(&maps.m[k], ptr, a.B, a.S, a.W, C::CT, BWD_SEG);
  };
  if (TMA && !(map(0, a.x) && map(1, a.r) && map(2, a.i) && map(3, a.dy) &&
               (!GATE || map(4, a.gate))))
    return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      ntiles < slots[device] ? ntiles : static_cast<long long>(slots[device]));
  kern<<<grid, C::NT, smem, s>>>(maps, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  rglru_bwd_lam_kernel<T><<<(a.W + 31) / 32, 32 * LAM_ROWS, 0, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(Args<T> a, void* scratch, int device, cudaStream_t s) {
  if (a.h_enter != nullptr && Tile<T>::SEG != BWD_SEG)
    return cudaErrorInvalidValue;
  if (a.S <= DECODE_L) {  // one warp a block: no segment to carry across
    dim3 grid((a.W + 31) / 32, a.B);
    if (a.gate != nullptr)
      rglru_decode_kernel<T, true><<<grid, 32, 0, s>>>(a);
    else
      rglru_decode_kernel<T, false><<<grid, 32, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  a.ctl = static_cast<unsigned*>(scratch);
  a.carry = reinterpret_cast<unsigned long long*>(
      static_cast<unsigned char*>(scratch) + CTL_BYTES);
  // TMA: 16-byte aligned tensors whose rows are 16-byte multiples
  const bool tma = a.W * sizeof(T) % 16 == 0 && aligned16(a.x) &&
                   aligned16(a.r) && aligned16(a.i) && aligned16(a.y) &&
                   (a.gate == nullptr || aligned16(a.gate));
  if (a.gate != nullptr)
    return tma ? launch_prefill<T, true, true>(a, device, s)
               : launch_prefill<T, true, false>(a, device, s);
  return tma ? launch_prefill<T, false, true>(a, device, s)
             : launch_prefill<T, false, false>(a, device, s);
}

template <typename T>
long long scratch_bytes(int B, int S, int W) {
  using C = Tile<T>;
  if (S <= DECODE_L) return 0;
  return CTL_BYTES + 8LL * B * ((W + C::CT - 1) / C::CT) *
                         ((S + C::SEG - 1) / C::SEG) * C::CT;
}

// the backward's: counters, a word per channel of each tile, then the
// tiles' dΛ partials (B, nseg, W)
template <typename T>
long long bwd_scratch_bytes(int B, int S, int W) {
  using C = BwdTile<T>;
  const long long nseg = (S + BWD_SEG - 1) / BWD_SEG;
  return CTL_BYTES + 8LL * B * ((W + C::CT - 1) / C::CT) * nseg * C::CT +
         4LL * B * nseg * W;
}

bool aligned_all(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (p != nullptr && !aligned16(p)) return false;
  return true;
}

}  // namespace

// Bytes of the scratch buffer a call of this shape needs (0: none): the
// ticket, finished-block count and tag, then one 64-bit word per channel
// of each tile.  The buffer must be zeroed when it is made and used by
// one stream only.
extern "C" long long rglru_scan_scratch_bytes(int B, int S, int W,
                                              int dtype) {
  if (B < 1 || S < 1 || W < 1) return -1;
  if (dtype == 0) return scratch_bytes<float>(B, S, W);
  if (dtype == 1) return scratch_bytes<__nv_bfloat16>(B, S, W);
  return -1;
}

// x, r, i, gate (or null), y: (B, S, W) contiguous in dtype (0 = float32,
// 1 = bfloat16); lam (W,), h0 (B, W) or null, h_last (B, W): float32;
// h_enter: null, or (B, ceil(S / 64), W) float32 for the h entering each
// 64-step tile (the training forward's, which rglru_scan_bwd_launch
// reads); scratch: rglru_scan_scratch_bytes(B, S, W, dtype) bytes kept
// for this stream (null when that is 0).  Returns a cudaError_t (0 on
// success).
extern "C" int rglru_scan_launch(const void* x, const void* r, const void* i,
                                 const void* lam, const void* h0,
                                 const void* gate, void* y, void* h_last,
                                 void* h_enter, void* scratch, int B, int S,
                                 int W,
                                 int dtype, int device, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args<float> a{static_cast<const float*>(x), static_cast<const float*>(r),
                  static_cast<const float*>(i), static_cast<const float*>(gate),
                  static_cast<const float*>(lam), static_cast<const float*>(h0),
                  static_cast<float*>(y), static_cast<float*>(h_last),
                  static_cast<float*>(h_enter), nullptr, nullptr, B, S, W};
    e = launch(a, scratch, device, s);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    Args<bf> a{static_cast<const bf*>(x), static_cast<const bf*>(r),
               static_cast<const bf*>(i), static_cast<const bf*>(gate),
               static_cast<const float*>(lam), static_cast<const float*>(h0),
               static_cast<bf*>(y), static_cast<float*>(h_last),
               static_cast<float*>(h_enter), nullptr, nullptr, B, S, W};
    e = launch(a, scratch, device, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Bytes of the backward's scratch buffer for a call of this shape: the
// ticket, finished-block count and tag, a 64-bit word per channel of
// each tile, the tiles' dΛ partials.  Zeroed when made and used by one
// stream only (not the forward's buffer).
extern "C" long long rglru_scan_bwd_scratch_bytes(int B, int S, int W,
                                                  int dtype) {
  if (B < 1 || S < 1 || W < 1) return -1;
  if (dtype == 0) return bwd_scratch_bytes<float>(B, S, W);
  if (dtype == 1) return bwd_scratch_bytes<__nv_bfloat16>(B, S, W);
  return -1;
}

// The backward (see above).  x, r, i, gate (or null), dy and the outputs
// dx, dr, di, dgate (null without a gate): (B, S, W) contiguous in dtype
// (0 = float32, 1 = bfloat16); lam, dlam (W,), dh_last (B, W) or null,
// dh0 (B, W) or null (no h0), h_enter (B, nseg, W) as rglru_scan_launch
// wrote it (nseg = ceil(S / 64)): float32; scratch:
// rglru_scan_bwd_scratch_bytes(B, S, W, dtype) bytes kept for this
// stream.  Returns a cudaError_t (0 on success).
extern "C" int rglru_scan_bwd_launch(const void* x, const void* r,
                                     const void* i, const void* gate,
                                     const void* dy, const void* lam,
                                     const void* dh_last, const void* h_enter,
                                     void* dx, void* dr, void* di,
                                     void* dgate, void* dlam, void* dh0,
                                     void* scratch, int B, int S, int W,
                                     int dtype, int device, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) -> cudaError_t {
    using T = decltype(zero);
    using C = BwdTile<T>;
    const long long nseg = (S + BWD_SEG - 1) / BWD_SEG;
    unsigned char* sc = static_cast<unsigned char*>(scratch);
    const long long words = 8LL * B * ((W + C::CT - 1) / C::CT) * nseg * C::CT;
    BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(r),
                 static_cast<const T*>(i), static_cast<const T*>(gate),
                 static_cast<const T*>(dy), static_cast<const float*>(lam),
                 static_cast<const float*>(dh_last),
                 static_cast<const float*>(h_enter), static_cast<T*>(dx),
                 static_cast<T*>(dr), static_cast<T*>(di),
                 static_cast<T*>(dgate), static_cast<float*>(dlam),
                 static_cast<float*>(dh0), reinterpret_cast<unsigned*>(sc),
                 reinterpret_cast<unsigned long long*>(sc + CTL_BYTES),
                 reinterpret_cast<float*>(sc + CTL_BYTES + words), B, S, W};
    // TMA: 16-byte aligned tensors whose rows are 16-byte multiples
    const bool tma = W * sizeof(T) % 16 == 0 &&
                     aligned_all({x, r, i, gate, dy, dx, dr, di, dgate});
    if (gate != nullptr)
      return tma ? launch_bwd<T, true, true>(a, device, s)
                 : launch_bwd<T, true, false>(a, device, s);
    return tma ? launch_bwd<T, false, true>(a, device, s)
               : launch_bwd<T, false, false>(a, device, s);
  };
  if (dtype == 0) e = run(0.f);
  else if (dtype == 1) e = run(__nv_bfloat16());
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
