// Flash attention, forward: the port's twin of the TPU kernel
// src/repro/kernels/flash_attention.py:flash_attention_tpu (_kernel);
// and backward (the second half of this file): the hand-written
// counterpart of the reference's custom VJP
// src/repro/models/flash.py:_bwd / _bwd_triangular.
//
// o[b, i, h] = sum_j softmax_j(mask(cap·tanh(s/cap) or s)) v[b, j, kvh]
// with s = scale · (q[b, i, h] · k[b, j, kvh]), kvh = h / (H / KV):
// grouped-query attention read natively, no repeated K/V.  Masks: causal
// (i >= j), sliding window (i - j < window); masked scores are -1e30 as
// on the TPU, keys past the end of the sequence weigh exactly 0, and key
// tiles outside the causal / window band are skipped.  Layout: q
// (B, Sq, H, hd), k/v (B, Sk, KV, hd), the model's; o is (B, Sq, H, hd)
// contiguous in q's dtype.  hd is 64, 80, 128 or 256 (256:
// recurrentgemma-2b's, 10 query heads on one KV head), forward and
// backward.
//
// Bound on the H100: operations.  A causal prefill does 2·B·H·S²·hd
// FLOPs on S·(H + 2·KV)·hd inputs, far above the card's ~295 FLOP/byte
// balance for S in the hundreds, so the limit is the tensor cores' rate.
//
// bfloat16 (flash_tc_kernel; both serving prefills run it): Hopper's
// tensor cores, fed by TMA.
// * One block per (64-row query tile, head, batch): one consumer
//   warpgroup and one producer warp (64-row tiles measured faster than
//   128-row tiles of two consumer warpgroups at both timed shapes).  The
//   grid walks the query tiles last, from the last tile down, so the
//   causal tiles with the most keys start first.
// * The producer loads the block's Q once and the K/V tiles of the band
//   (64 keys each) by TMA into a ring of stages, one mbarrier pair
//   (full / empty) per stage, so the next tiles are in flight while the
//   consumer warpgroup computes.  Tiles land 128-byte swizzled: one hd-64 bf16 row
//   is one 128-byte swizzle row; hd 128 takes two 64-column atoms.  Rows
//   past the end of q, k or v arrive as zeros.
// * hd 80 takes two atoms too: the tensor maps keep hd at 80, so the
//   second box's columns 80..127 lie past the tensor's edge and TMA
//   fills them with zeros (the box's bytes count in full on the
//   barrier, as for rows past the end).  Q·Kᵀ runs its 5 k-steps of 16;
//   P·V forms 128 output columns, of which the zero ones are never
//   stored (1.6× the tensor-core work of an exact hd-80 tiling).
// * hd 256 takes four atoms (Q, K and V tiles of 32 KB, three stages:
//   225 KB, one block an SM) and two consumer warpgroups.  One warpgroup
//   holding O (64 × 256 f32) would carry 128 accumulators a thread beside
//   S's 32 and two P buffers' 32: ptxas then serializes the wgmmas for
//   lack of registers (C7511, as hd 80 drew at half that).  So each
//   warpgroup owns 128 of O's columns (64 accumulators) and forms S and
//   the softmax itself from the shared Q and K tiles: S costs twice
//   (Q·Kᵀ and P·V are equal halves of a tile's products, so 1.5× the
//   tile's tensor-core work), but no warpgroup waits on another, no P
//   crosses shared memory, and both keep the hd-128 kernel's register
//   budget and its overlap of S(j + 1) with P·V(j).  The two softmaxes
//   see the same scores in the same order, so their P, row maxima and
//   sums are bit for bit alike.  The block has no producer warp: a
//   ninth warp would put three warps on one of the SM's four register
//   files and cap every thread at 168 registers, which spilled (148
//   bytes a thread, measured); with eight, each thread may take 255.
//   Thread 0 issues the copies instead: Q and the first three tiles up
//   front, then tile j + 3 once all eight warps have released tile j.
//   Grouped-query heads map as everywhere: query head h reads KV head
//   h / (H / KV) (10 : 1 in MQA).
// * S = Q·Kᵀ with wgmma m64n64k16 (bf16 in, f32 accumulated), A and B
//   from shared memory; then the scale hd^-0.5 in f32 (the TPU kernel
//   scales f32(q); q is never rounded after scaling).
// * The online softmax runs on the accumulator fragment in registers: a
//   thread holds rows r = 16·warp + lane/4 (+8) and columns
//   8·i + 2·(lane%4) (+1); row max and sum go over the 4 lanes of a row
//   by shuffles.  2^x (ex2.approx, MUFU.EX2, within 2 ulp) of scores
//   pre-multiplied by log2(e) replaces expf.  A tile that the whole
//   warpgroup sees unmasked (no softcap) skips the masks and folds the
//   scale into one fmaf per score; the softmax is the kernel's largest
//   cost in instructions, ahead of the products.
// * O += P·V with wgmma, P from registers as the A operand (the S
//   fragment re-read as A fragments after rounding P to bf16: the one
//   rounding the TPU kernel does not make) and V from shared memory
//   through a transposed (MN-major) B descriptor, 64 output columns per
//   instruction.  O stays in registers in f32; the epilogue divides by
//   max(l, 1e-30) and stores bf16, rows past Sq masked.
// * Within a warpgroup, S of tile j + 1 and P·V of tile j are issued
//   together, and the softmax of tile j + 1 runs on the CUDA cores while
//   P·V of tile j runs on the tensor cores.  Each consumer warp releases
//   a stage with one arrival once its products have read it.  A barrier
//   wait that lasts seconds traps rather than hang the card.
//
// Both forward kernels write the row log-sum-exp lse (f32, (B, H, Sq),
// natural log) when the caller passes a buffer, as the training forward
// does for its backward: the bf16 kernel is instantiated twice (LSE = 0
// for serving, which runs the kernel it always ran; LSE = 1 adds the
// store after the last wgmma), the f32 kernel tests the pointer.
//
// float32 (flash_fwd_kernel): the first design, kept for the f32 checks
// that need f32 products.  One block of 256 threads per (64-query tile,
// head, batch) walks the band's 64-key tiles staged in shared memory;
// four threads own a query row; products on the CUDA cores in f32
// (fmaf), expf, one rounding at the end.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) or nullptr
  long long sqb, sqs, sqh;  // element strides of q: batch, seq, head
  long long skb, sks, skh;
  long long svb, svs, svh;
  int Sq, Sk, H, KV;
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  float scale;
};

// ====================================================================== //
// float32: CUDA cores                                                     //
// ====================================================================== //

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block: 4 per query row

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (HD + 4) + static_cast<size_t>(BK) * (HD + 4) +
          static_cast<size_t>(BK) * HD + static_cast<size_t>(BQ) * (BK + 1));
}

template <int HD>
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

  const float* qp = static_cast<const float*>(a.q) + b * a.sqb + h * a.sqh;
  const float* kp = static_cast<const float*>(a.k) + b * a.skb + kvh * a.skh;
  const float* vp = static_cast<const float*>(a.v) + b * a.svb + kvh * a.svh;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int rr = idx / HD, d = idx % HD, qq = q0 + rr;
    Qs[rr * QS + d] = qq < a.Sq ? qp[qq * a.sqs + d] * a.scale : 0.f;
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
      Ks[j * KS + d] = in ? kp[kk * a.sks + d] : 0.f;
      Vs[j * HD + d] = in ? vp[kk * a.svs + d] : 0.f;
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
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const float p = expf(s[jj] - m_new);
      ls += p;
      Ps[r * PS + c + 4 * jj] = p;
    }
    ls += __shfl_xor_sync(FULL, ls, 1);
    ls += __shfl_xor_sync(FULL, ls, 2);
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

  if (qi < a.Sq && c == 0 && a.lse != nullptr)
    a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qi] =
        m + logf(fmaxf(l, 1e-30f));
  if (qi < a.Sq) {
    const float den = fmaxf(l, 1e-30f);
    float* op = static_cast<float*>(a.o) +
                ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * HD;
#pragma unroll
    for (int qd = 0; qd < HD / 16; ++qd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        op[16 * qd + 4 * c + e] = acc[4 * qd + e] / den;
  }
}

template <int HD>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<HD><<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

// ====================================================================== //
// bfloat16: tensor cores (wgmma) fed by TMA                               //
// ====================================================================== //

constexpr int TC_BK = 64;             // keys per tile
constexpr int ATOM_BYTES = 64 * 128;  // 64 rows of one 128-byte swizzle atom

// a consumer warpgroup and a producer warp (the backward's dq kernel;
// the forward's count is Tc<HD>::THREADS)
constexpr int TC_THREADS = 128 + 32;

template <int HD>
struct Tc {
  static_assert(HD % 16 == 0 && HD <= 256, "hd: a multiple of 16, <= 256");
  static constexpr int ATOMS = (HD + 63) / 64;  // 64-column atoms across hd
  // consumer warpgroups, each owning AW of O's atoms (see the header)
  static constexpr int NWG = HD > 128 ? 2 : 1;
  static constexpr int AW = ATOMS / NWG;
  // a producer warp beside the consumers, or (two consumer warpgroups)
  // none: thread 0 issues the copies (see the header)
  static constexpr bool PRODUCER = NWG == 1;
  static constexpr int THREADS = 128 * NWG + (PRODUCER ? 32 : 0);
  // K/V stages in the ring: the consumer holds two tiles at a time; hd 64
  // keeps a third in flight (3 measured faster than 2 at S 4096), hd 80
  // and 128 stay at 2 so that two blocks fit an SM; hd 256 (one block an
  // SM) takes 3, as its copies are issued by a consumer thread
  static constexpr int STAGES = HD == 80 || HD == 128 ? 2 : 3;
  static constexpr int TILE_BYTES = ATOMS * ATOM_BYTES;  // Q, K or V tile
  static constexpr int SMEM =
      1024 + (1 + 2 * STAGES) * TILE_BYTES + 8 * (2 * STAGES + 1);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// arrive, and expect `bytes` of TMA transactions in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`; a
// wait of more than ~2^34 cycles (seconds) is a pipeline fault and traps
// instead of hanging the card
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

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile whose rows
// are 128 bytes: start address, leading offset 16 B (unused by this
// layout), stride 1024 B between groups of 8 rows, swizzle mode 1
// (128 B).  The same descriptor serves K-major operands (Q, K: hd along
// the row) and the transposed V (N = hd along the row, K = keys down).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// and the A fragments that an asynchronous wgmma reads from registers
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i >> 2][i & 3])::"memory");
}

// 2^x (MUFU.EX2; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#define WG_D32                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WG_R32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d (64×64 f32 fragment) = A·B (+ d if accumulate): A 64×16 and B 64×16
// bf16, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B: A 64×16 bf16 from registers (4 × bf16x2 a thread, the layout
// of a 64×16 slice of the f32 accumulator), B 16×64 bf16 in shared
// memory with N contiguous (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(Tc<HD>::THREADS)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = Tc<HD>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte alignment
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + C::TILE_BYTES;
  uint8_t* sV = sK + C::STAGES * C::TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + C::STAGES * C::TILE_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 64;  // most keys first
  const int kvh = h / (a.H / a.KV);
  // the band of keys this tile can see, in whole key tiles
  const int q_last = min(q0 + 64, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin =
      a.window > 0 ? (max(0, q0 - a.window + 1) / TC_BK) * TC_BK : 0;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + TC_BK - 1) / TC_BK : 0;
  // the warp index through a shuffle, so the compiler knows it is the
  // same across the warp (the branches on it hold no wgmma divergence)
  const int warp = __shfl_sync(FULL, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::NWG);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one thread's copies: Q, and key tile j's K and V into its stage
  auto load_q = [&]() {
    mbar_expect_tx(qbar, C::TILE_BYTES);
    for (int at = 0; at < C::ATOMS; ++at)
      tma_load_4d(sQ + at * ATOM_BYTES, &tq, qbar, 64 * at, h, q0, b);
  };
  auto load_tile = [&](int j) {
    const int s = j % C::STAGES;
    mbar_expect_tx(&full[s], 2 * C::TILE_BYTES);
    const int k0 = k_begin + j * TC_BK;
    for (int at = 0; at < C::ATOMS; ++at) {
      tma_load_4d(sK + s * C::TILE_BYTES + at * ATOM_BYTES, &tk, &full[s],
                  64 * at, kvh, k0, b);
      tma_load_4d(sV + s * C::TILE_BYTES + at * ATOM_BYTES, &tv, &full[s],
                  64 * at, kvh, k0, b);
    }
  };
  if constexpr (C::PRODUCER) {
    if (warp == 4) {  // the producer warp: one thread issues every copy
      if (lane == 0) {
        load_q();
        for (int j = 0; j < n_tiles; ++j) {
          if (j >= C::STAGES)  // the consumers released this stage's last use
            mbar_wait(&empty[j % C::STAGES], ((j / C::STAGES) - 1) & 1);
          load_tile(j);
        }
      }
      return;
    }
  } else {
    if (threadIdx.x == 0) {  // Q and the first tiles; the rest in release
      load_q();
      for (int j = 0; j < min(n_tiles, C::STAGES); ++j) load_tile(j);
    }
    __syncwarp();
  }

  // the consumer warpgroup wg (of O's atoms wg·AW ..): this thread holds
  // rows r0 and r0 + 8 of every fragment
  const int wg = warp >> 2;
  const int r0 = q0 + 16 * (warp & 3) + (lane >> 2);
  const int cl = 2 * (lane & 3);  // first column in each group of 8
  const float sc_log2 = a.scale * LOG2E;
  const uint32_t qa = smem_u32(sQ);

  float o[C::AW][32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = 0.f;
#pragma unroll
    for (int at = 0; at < C::AW; ++at) o[at][i] = 0.f;
  }
  uint32_t p0[4][4], p1[4][4];  // P of alternate tiles, as A fragments
  float m0 = NEG, m1 = NEG;     // row maxima, in log2 units
  float l0 = 0.f, l1 = 0.f;     // row sums over this thread's columns
  float c0 = 1.f, c1 = 1.f;     // O's rescaling for the next tile

  // S = Q·Kᵀ for key tile j, 16 of hd per instruction (issue only)
  auto issue_qk = [&](int j) {
    const uint32_t ka = smem_u32(sK + (j % C::STAGES) * C::TILE_BYTES);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sc, sw128_desc(qa + (kk >> 2) * ATOM_BYTES + (kk & 3) * 32),
               sw128_desc(ka + (kk >> 2) * ATOM_BYTES + (kk & 3) * 32),
               kk > 0);
  };
  // O += P·V for key tile j, this warpgroup's 64-column atoms, 16 keys
  // per instruction (issue only)
  auto issue_pv = [&](int j, const uint32_t (&pa)[4][4]) {
    const uint32_t va = smem_u32(sV + (j % C::STAGES) * C::TILE_BYTES) +
                        wg * C::AW * ATOM_BYTES;
#pragma unroll
    for (int at = 0; at < C::AW; ++at)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[at], pa[kk], sw128_desc(va + at * ATOM_BYTES + kk * 2048));
  };
  // The online softmax of key tile j on S: the new row maxima, O's
  // rescaling (c0, c1), the row sums, and P in bf16 as the A fragments
  // of P·V (the accumulator's columns 16kk .. 16kk + 15 are its registers
  // 8kk .. 8kk + 7, in the order the A operand takes them).  A tile that
  // every row of the block sees whole, with no softcap, skips the
  // masks and folds the scale into exp2's argument.
  auto softmax = [&](int j, uint32_t (&pn)[4][4]) {
    const int k0 = k_begin + j * TC_BK;
    const bool whole = a.softcap <= 0.f && k0 + TC_BK <= a.Sk &&
                       (!a.causal || q0 >= k0 + TC_BK - 1) &&
                       (a.window <= 0 || q0 + 63 - k0 < a.window);
    float mx0 = NEG, mx1 = NEG;
    if (whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, sc[i]); else mx0 = fmaxf(mx0, sc[i]);
      }
    } else {
      // element i sits at row r0 + 8·((i >> 1) & 1), column
      // k0 + cl + 8·(i >> 2) + (i & 1): its row minus its column is
      // dq plus a constant, and it is past the end when that constant
      // reaches end
      const int dq = r0 - k0 - cl, end = a.Sk - k0 - cl;
      const int win = a.window > 0 ? a.window : 0x7fffffff;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int off = 8 * (i >> 2) + (i & 1);
        const int d = dq + ((i & 2) ? 8 : 0) - off;
        float x;
        if (a.softcap > 0.f)
          x = a.softcap * tanhf(sc[i] * a.scale / a.softcap) * LOG2E;
        else
          x = sc[i] * sc_log2;
        x = (!a.causal || d >= 0) && d < win ? x : NEG;
        x = off < end ? x : -INFINITY;  // past the end: weight 0
        sc[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    if (whole) {  // the order of the raw scores is the scaled scores'
      mx0 *= sc_log2;
      mx1 *= sc_log2;
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    c0 = ex2(m0 - mn0);
    c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float mm = (i & 2) ? mn1 : mn0;
      const float e0 = whole ? ex2(fmaf(sc[i], sc_log2, -mm)) : ex2(sc[i] - mm);
      const float e1 =
          whole ? ex2(fmaf(sc[i + 1], sc_log2, -mm)) : ex2(sc[i + 1] - mm);
      if (i & 2) ls1 += e0 + e1; else ls0 += e0 + e1;
      pn[i >> 3][(i & 7) >> 1] = pack_bf16(e0, e1);
    }
    l0 = l0 * c0 + ls0;
    l1 = l1 * c1 + ls1;
  };

  // Tile j: S of tile j + 1 and P·V of tile j go to the tensor cores
  // together; the softmax of tile j + 1 runs while P·V of tile j does.
  // The loop takes two tiles a turn, so P alternates between two
  // buffers with no copy between the products (a copy there makes the
  // compiler serialize the wgmmas).
  auto wait_full = [&](int j) {
    mbar_wait(&full[j % C::STAGES], (j / C::STAGES) & 1);
    __syncwarp();
  };
  auto fence_o = [&]() {
#pragma unroll
    for (int at = 0; at < C::AW; ++at) fence_regs(o[at]);
  };
  auto release = [&](int j, uint32_t (&pa)[4][4]) {
    fence_regs(pa);  // this warp's products no longer read tile j
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % C::STAGES]);
    if constexpr (!C::PRODUCER) {  // thread 0 refills the stage
      if (threadIdx.x == 0 && j + C::STAGES < n_tiles) {
        mbar_wait(&empty[j % C::STAGES], (j / C::STAGES) & 1);
        load_tile(j + C::STAGES);
      }
      __syncwarp();
    }
  };
  // tile j whose P is in pa, while the next tile's P goes to pn
  auto step = [&](int j, uint32_t (&pa)[4][4], uint32_t (&pn)[4][4]) {
    wait_full(j + 1);
    fence_regs(sc);
    fence_o();
    fence_regs(pa);
    wg_fence();
    issue_qk(j + 1);
    wg_commit();
    issue_pv(j, pa);
    wg_commit();
    wg_wait<1>();  // S of tile j + 1 is in; P·V of tile j may run on
    fence_regs(sc);
    softmax(j + 1, pn);
    wg_wait<0>();
    fence_o();
    release(j, pa);
#pragma unroll
    for (int at = 0; at < C::AW; ++at)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[at][i] *= (i & 2) ? c1 : c0;
  };
  auto last = [&](int j, uint32_t (&pa)[4][4]) {
    fence_o();
    fence_regs(pa);
    wg_fence();
    issue_pv(j, pa);
    wg_commit();
    wg_wait<0>();
    fence_o();
    release(j, pa);
  };

  mbar_wait(qbar, 0);
  if (n_tiles > 0) {
    wait_full(0);
    fence_regs(sc);
    wg_fence();
    issue_qk(0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    softmax(0, p0);
    int j = 0;
    for (; j + 2 < n_tiles; j += 2) {  // P alternates between p0 and p1
      step(j, p0, p1);
      step(j + 1, p1, p0);
    }
    if (j + 1 < n_tiles) {
      step(j, p0, p1);
      last(j + 1, p1);
    } else {
      last(j, p0);
    }
  }

  // the row sums over the 4 lanes of a row; o / max(l, 1e-30) in bf16
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if constexpr (LSE) {  // m is in log2 units: lse = m·ln 2 + ln l
    if (wg == 0 && (lane & 3) == 0) {
      float* lr = a.lse + (static_cast<long long>(b) * a.H + h) * a.Sq;
      if (r0 < a.Sq) lr[r0] = m0 * LN2 + logf(d0);
      if (r0 + 8 < a.Sq) lr[r0 + 8] = m1 * LN2 + logf(d1);
    }
  }
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o);
  const long long row0 = (static_cast<long long>(b) * a.Sq + r0) * a.H + h;
  const long long row1 = row0 + 8LL * a.H;
#pragma unroll
  for (int at = 0; at < C::AW; ++at)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col0 = 64 * (wg * C::AW + at) + 8 * jj;
      if (col0 >= HD) continue;  // a zero column past hd
      const int col = col0 + cl;
      if (r0 < a.Sq)
        *reinterpret_cast<uint32_t*>(op + row0 * HD + col) =
            pack_bf16(o[at][4 * jj] / d0, o[at][4 * jj + 1] / d0);
      if (r0 + 8 < a.Sq)
        *reinterpret_cast<uint32_t*>(op + row1 * HD + col) =
            pack_bf16(o[at][4 * jj + 2] / d1, o[at][4 * jj + 3] / d1);
    }
}

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

// A bf16 tensor (batch, seq, heads, hd) with element strides (sb, ss, sh)
// and a contiguous hd, as a 4-D map (hd, heads, seq, batch) whose boxes
// are 64 columns of hd × `rows` positions of one head, 128-byte swizzled.
// Positions past `seq`, and columns past hd (hd 80's second box), read as
// zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                int heads, int hd, long long sb, long long ss, long long sh,
                int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool LSE>
cudaError_t launch_tc(const Args& a, int B, cudaStream_t s) {
  using C = Tc<HD>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, a.q, B, a.Sq, a.H, HD, a.sqb, a.sqs, a.sqh, 64) ||
      !tensor_map(&tk, a.k, B, a.Sk, a.KV, HD, a.skb, a.sks, a.skh, TC_BK) ||
      !tensor_map(&tv, a.v, B, a.Sk, a.KV, HD, a.svb, a.svs, a.svh, TC_BK))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<HD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return e;
  const long long tiles = (a.Sq + 63) / 64;
  if (tiles > 65535) return cudaErrorInvalidValue;
  dim3 grid(a.H, B, static_cast<unsigned>(tiles));
  flash_tc_kernel<HD, LSE><<<grid, C::THREADS, C::SMEM, s>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

// strides: the element strides (batch, seq, head) of q, k and v, in that
// order.  ints: B, Sq, Sk, H, KV, hd, dtype (0 = float32, 1 = bfloat16),
// causal, window (<= 0: none), device.  softcap <= 0: none.  lse: a
// float32 (B, H, Sq) buffer for the row log-sum-exp, or null.  The bf16
// path needs 16-byte aligned q, k, v and strides that are multiples of 8
// elements (TMA).  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const long long* strides,
                                      const int* ints, float softcap,
                                      float scale, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lse = static_cast<float*>(lse);
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
  if (dtype == 0 && hd == 64) e = launch_f32<64>(a, B, s);
  else if (dtype == 0 && hd == 80) e = launch_f32<80>(a, B, s);
  else if (dtype == 0 && hd == 128) e = launch_f32<128>(a, B, s);
  else if (dtype == 0 && hd == 256) e = launch_f32<256>(a, B, s);
  else if (dtype == 1 && hd == 64)
    e = a.lse ? launch_tc<64, true>(a, B, s) : launch_tc<64, false>(a, B, s);
  else if (dtype == 1 && hd == 80)
    e = a.lse ? launch_tc<80, true>(a, B, s) : launch_tc<80, false>(a, B, s);
  else if (dtype == 1 && hd == 128)
    e = a.lse ? launch_tc<128, true>(a, B, s)
              : launch_tc<128, false>(a, B, s);
  else if (dtype == 1 && hd == 256)
    e = a.lse ? launch_tc<256, true>(a, B, s)
              : launch_tc<256, false>(a, B, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// ====================================================================== //
// Backward                                                                //
// ====================================================================== //
//
// The hand-written counterpart of the reference's custom VJP
// src/repro/models/flash.py:_bwd (:240) and _bwd_triangular (:127).
// Given q, k, v, the forward's output o and row log-sum-exp lse, and the
// cotangent do (layout as the forward's), with s_raw = scale·(q·k):
//   Δ_i  = Σ_d do_i·o_i                          (f32)
//   s    = cap·tanh(s_raw/cap) (softcap) or s_raw; masked: −1e30
//   p    = exp(s − lse_i)
//   dp   = do_i·v_j
//   ds   = p·(dp − Δ_i) [·(1 − tanh²)] ; masked: 0
//   dq_i = scale·Σ_j ds·k_j ;  dk_j = scale·Σ_i ds·q_i ;  dv_j = Σ_i p·do_i
// summed over the G = H/KV query heads of a group for dk and dv (the
// gradient of the reference's K/V repeat); dq, dk, dv in the input dtype.
//
// Bound on the H100: operations.  Five S×S×hd products (S, dP, dV, dK,
// dQ: 5·B·H·S²·hd FLOPs causal, 2.349 GFLOP at the training shape B 2,
// S 512, 14 heads, hd 64) against ≈ 8.5 MB of inputs and outputs, about
// the card's balance; as executed (dq recomputes S and dP: 7 products,
// 3.29 GFLOP) the tensor cores' rate is the limit.  The design puts every
// product on the tensor cores and keeps S, P, dP and dS out of memory.
//
// Three launches in bfloat16, four in float32; no atomics (two runs give
// the same bits):
// * bwd_delta_kernel: Δ from 16-byte loads (one row per hd/8 or hd/4
//   lanes), written with lse in log2 units into (B, H, Sqp) rows padded
//   to whole 64-row tiles; a pad row gets Δ = 0 and lse = +inf, so its
//   p is 0;
// * dk/dv: one block per (64-key tile, head, batch) walks the query tiles
//   of its causal / window band and writes per-head f32 partials
//   (B, Sk, H, hd), so the grid has H blocks per key tile instead of KV
//   (224 blocks at the training shape instead of 32);
// * dq: one block per (64-query tile, head, batch) walks the key tiles of
//   its band, recomputing S and dP (the price of a dq with no atomics);
// * the group sum (group_sum): dk, dv = the partials summed over each
//   group's G heads in order, cast to the input dtype (float4 loads); in
//   bfloat16 the dq launch's later half of blocks (the query tiles with
//   the fewest keys under causal) runs it after their dq, in float32 a
//   fourth launch (bwd_reduce_kernel).
//
// bfloat16 (bwd_dkdv_tc_kernel, bwd_dq_tc_kernel): the forward's pieces.
// * A producer warp loads the block's resident tiles once by TMA (K and V
//   for dk/dv; Q and dO for dq) and streams the band's other two tiles
//   (Q and dO, with their 64 lse and Δ values by a bulk copy; or K and V)
//   through a ring of two stages, a full / empty mbarrier pair each.
//   Rows past Sq or Sk arrive as zeros.
// * dk/dv, per query tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by wgmma with both
//   operands K-major in shared memory, as the forward forms S; Pᵀ and dSᵀ
//   in registers (2^x of the score in log2 units less lse; lse and Δ are
//   per column here), the masks only on tiles the band's edge cuts (keys
//   past Sk need none: their rows are never stored); then dV += Pᵀ·dO and
//   dK += dSᵀ·Q by wgmma, Pᵀ and dSᵀ as register A fragments (the
//   accumulator fragment rounded to bf16) and dO, Q through the transposed
//   (MN-major) descriptor, as the forward's P·V.  dK and dV stay in f32
//   registers over the band; dK is scaled in the epilogue.  Key tile 0,
//   the one with the most queries under causal, starts first.
// * The 32 scores a thread holds are formed in one branch-free stretch:
//   the softcap and the masks are chosen once a tile (`dispatch`), not
//   per score, so the compiler interleaves the scores' dependent chains
//   (ex2, products) instead of running them one after another.
// * dq, per key tile: S = Q·Kᵀ and dP = dO·Vᵀ, dS in registers, dQ +=
//   dS·K with K through the transposed descriptor.  The query tiles with
//   the most keys start first.
// * hd 128: the dk/dv kernel runs two consumer warpgroups, each owning 64
//   columns of dK and dV (one warpgroup's registers cannot hold all 128)
//   and each forming the whole Sᵀ and dPᵀ over both 64-column swizzle
//   atoms of hd; the dq kernel keeps one warpgroup.
// * hd 256 (recurrentgemma-2b's training): four atoms, and each key or
//   query tile's columns split over two blocks (grid z doubled), each
//   owning 128 of dK and dV (two warpgroups of 64) or of dQ (one
//   warpgroup, two atoms) and forming the whole Sᵀ, dPᵀ (S, dP) over all
//   four atoms itself.  One warpgroup cannot hold 128 f32 accumulator
//   columns of both dK and dV beside Sᵀ and dPᵀ, and four dk/dv
//   warpgroups in one block (544 threads) would cap each thread at 120
//   registers: the split keeps hd 128's register budget in every
//   warpgroup at 2.5× the tile's minimum tensor-core work (each
//   warpgroup's S and dP cost four times its dV and dK products), with
//   no P or dS crossing shared memory.  Shared memory: two resident and
//   four streamed 32 KB tiles, 194 KB, one block an SM.
// * hd 80 is laid out as hd 128 (two atoms, two dk/dv warpgroups): the
//   second atom's columns 80..127 arrive as zeros from TMA (see the
//   forward), the score products run hd's 5 k-steps, and the columns
//   past 80 of dK, dV and dQ, zero, are not stored.
// * Roundings the plain version does not make: Pᵀ and dSᵀ (dS in dq)
//   rounded to bf16 as wgmma operands, and exp taken as 2^x (ex2.approx).
//   The products accumulate in f32; dq, dk, dv are stored in bf16.
//
// float32 (bwd_dkdv_kernel, bwd_dq_kernel): the first design, kept for
// the f32 checks that need f32 products.  Tiles staged in shared memory
// as f32 (rows padded to hd + 4 floats: conflict-free float4 reads); a
// thread owns one row of the 64 × 64 score tile and every fourth column
// (S, dP), or one row and hd / 4 columns of a 64 × hd accumulator (dq,
// dk, dv); products as fmaf on the CUDA cores.  hd 256 stages 32-row
// tiles, eight threads a row (F32Bwd).

namespace {

constexpr int BT = 64;    // queries or keys per tile
constexpr int BNT = 256;  // threads per block (CUDA-core kernels, Δ, sum)

struct BwdArgs {
  const void* q;     // (B, Sq, H, hd) contiguous
  const void* k;     // (B, Sk, KV, hd) contiguous
  const void* v;
  const void* o;     // (B, Sq, H, hd)
  const void* dout;  // (B, Sq, H, hd)
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sqp)
  float* lse2;       // (B, H, Sqp): lse·log2(e)
  void* dq;          // (B, Sq, H, hd)
  float* dkp;        // (B, Sk, H, hd) f32 partials
  float* dvp;
  void* dk;          // (B, Sk, KV, hd)
  void* dv;
  int B, Sq, Sk, H, KV;
  int Sqp;             // Sq rounded up to whole 64-row tiles
  int causal, window;  // window <= 0: none
  float softcap;       // <= 0: none
  float scale;
};

__device__ __forceinline__ bool visible(const BwdArgs& a, int qi, int kj) {
  return (!a.causal || qi >= kj) && (a.window <= 0 || qi - kj < a.window);
}

// element e of a 16-byte vector of T, widened to f32 (exact)
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& u, int e) {
  return __uint_as_float(e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int e) {
  const int j = e >> 1;
  const uint32_t w = j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Δ and lse·log2(e) into (B, H, Sqp), row (b·H + h)·Sqp + i; pads (i >=
// Sq): Δ = 0, lse = +inf.  One row per LP lanes (the power of two at or
// above HD / VEC, at most 32), lane l of them the 16-byte vectors l,
// l + LP, ... of o and of do (two each at hd 256 in float32).
template <typename T, int HD>
__host__ __device__ constexpr int delta_lanes() {
  constexpr int L = HD / (16 / sizeof(T));
  static_assert(HD % (16 / sizeof(T)) == 0 && (L <= 32 || L % 32 == 0),
                "hd");
  return L <= 8 ? 8 : L <= 16 ? 16 : 32;
}

template <typename T, int HD>
__global__ void __launch_bounds__(BNT) bwd_delta_kernel(BwdArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int L = HD / VEC;                // vectors a row
  constexpr int LP = delta_lanes<T, HD>();  // lanes per row: 8, 16 or 32
  const int lane = threadIdx.x & 31;
  const long long row =
      (static_cast<long long>(blockIdx.x) * BNT + threadIdx.x) / LP;
  const long long n = static_cast<long long>(a.B) * a.H * a.Sqp;
  const long long i = row % a.Sqp, bh = row / a.Sqp;
  float acc = 0.f;
  if (row < n && i < a.Sq) {
    const long long b = bh / a.H, h = bh % a.H;
    const long long base = ((b * a.Sq + i) * a.H + h) * HD;
#pragma unroll
    for (int v = lane % LP; v < L; v += LP) {
      const long long off = base + v * VEC;
      const uint4 u = __ldg(
          reinterpret_cast<const uint4*>(static_cast<const T*>(a.o) + off));
      const uint4 w = __ldg(
          reinterpret_cast<const uint4*>(static_cast<const T*>(a.dout) + off));
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc += elem<T>(w, e) * elem<T>(u, e);
    }
  }
#pragma unroll
  for (int off = LP / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (row < n && lane % LP == 0) {
    a.delta[row] = acc;
    a.lse2[row] = i < a.Sq ? a.lse[bh * a.Sq + i] * LOG2E : INFINITY;
  }
}

// ---------------------------------------------------------------------- //
// float32: CUDA cores                                                     //
// ---------------------------------------------------------------------- //

// the CUDA-core kernels' tiles: BT rows of queries and of keys, a row
// per TPR threads; hd 256 takes 32-row tiles (four 64-row tiles of 256
// f32 columns and their score tiles would need 300,032 bytes of shared
// memory, above the 232,448 a block may have)
template <int HD>
struct F32Bwd {
  static constexpr int T = HD > 128 ? 32 : BT;  // rows a tile
  static constexpr int TPR = BNT / T;           // threads a row
  static constexpr int RS = HD + 4;             // padded row stride
  static constexpr int PS = T + 1;              // score tile's row stride
  static constexpr size_t SMEM =
      sizeof(float) * (4 * static_cast<size_t>(T) * RS +
                       2 * static_cast<size_t>(T) * PS + 2 * T);
  static_assert(HD % (4 * TPR) == 0 && T % TPR == 0 && BT % T == 0,
                "f32 backward tiling");
};

// rows [r0, r0 + T) of a (batch, seq, heads, HD) tensor's head `hh`
// into `dst` (row stride HD + 4); rows past `seq` are zeros
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src, int b,
                                      int r0, int seq, int heads, int hh) {
  constexpr int T = F32Bwd<HD>::T;
  for (int idx = threadIdx.x; idx < T * HD; idx += BNT) {
    const int rr = idx / HD, d = idx % HD, row = r0 + rr;
    dst[rr * (HD + 4) + d] =
        row < seq ? src[((static_cast<long long>(b) * seq + row) * heads +
                         hh) * HD + d]
                  : 0.f;
  }
}

// S and dP of query row `r` of the Q / dO tile against keys c + TPR·jj
// of the K / V tile; then p and ds, written to P[r][·] and dS[r][·].
// q_i, k_j: the positions of the tile's first query and key.
template <int HD>
__device__ __forceinline__ void scores(const BwdArgs& a, const float* Qs,
                                       const float* dOs, const float* Ks,
                                       const float* Vs, float lse_r,
                                       float del_r, int q_i, int k_j, int r,
                                       int c, float* Ps, float* dSs) {
  using F = F32Bwd<HD>;
  constexpr int RS = F::RS, NJ = F::T / F::TPR;
  float s[NJ], dp[NJ];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) s[jj] = dp[jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * RS + d]);
    const float4 gv = *reinterpret_cast<const float4*>(&dOs[r * RS + d]);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = c + F::TPR * jj;
      const float4 kv = *reinterpret_cast<const float4*>(&Ks[j * RS + d]);
      const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * RS + d]);
      s[jj] = fmaf(qv.x, kv.x, s[jj]);
      s[jj] = fmaf(qv.y, kv.y, s[jj]);
      s[jj] = fmaf(qv.z, kv.z, s[jj]);
      s[jj] = fmaf(qv.w, kv.w, s[jj]);
      dp[jj] = fmaf(gv.x, vv.x, dp[jj]);
      dp[jj] = fmaf(gv.y, vv.y, dp[jj]);
      dp[jj] = fmaf(gv.z, vv.z, dp[jj]);
      dp[jj] = fmaf(gv.w, vv.w, dp[jj]);
    }
  }
  const int qi = q_i + r;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = c + F::TPR * jj, kj = k_j + j;
    const bool vis = qi < a.Sq && kj < a.Sk && visible(a, qi, kj);
    float x = s[jj] * a.scale, t = 0.f;
    if (a.softcap > 0.f) {
      t = tanhf(x / a.softcap);
      x = a.softcap * t;
    }
    const float p = vis ? expf(x - lse_r) : 0.f;
    float ds = p * (dp[jj] - del_r);
    if (a.softcap > 0.f) ds = ds * (1.f - t * t);
    Ps[r * F::PS + j] = p;
    dSs[r * F::PS + j] = vis ? ds : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(BNT) bwd_dkdv_kernel(BwdArgs a) {
  using F = F32Bwd<HD>;
  constexpr int T = F::T, TPR = F::TPR, RS = F::RS, PS = F::PS;
  constexpr int DPT = HD / TPR;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T * RS;
  float* Qs = Vs + T * RS;
  float* dOs = Qs + T * RS;
  float* Ps = dOs + T * RS;
  float* dSs = Ps + T * PS;
  float* lse_s = dSs + T * PS;
  float* del_s = lse_s + T;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int k0 = blockIdx.x * T;
  const int tid = threadIdx.x, r = tid / TPR, c = tid % TPR;
  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  stage<HD>(Ks, static_cast<const float*>(a.k), b, k0, a.Sk, a.KV, kvh);
  stage<HD>(Vs, static_cast<const float*>(a.v), b, k0, a.Sk, a.KV, kvh);

  float dk[DPT], dv[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk[i] = dv[i] = 0.f;

  // the queries that see some key of this tile
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.Sq, k0 + T - 1 + a.window) : a.Sq;
  const long long lrow = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const long long drow = (static_cast<long long>(b) * a.H + h) * a.Sqp;
  for (int q0 = (q_lo / T) * T; q0 < q_hi; q0 += T) {
    __syncthreads();  // the last tile's Q, dO, P, dS are no longer read
    stage<HD>(Qs, q, b, q0, a.Sq, a.H, h);
    stage<HD>(dOs, dout, b, q0, a.Sq, a.H, h);
    if (tid < T) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < a.Sq ? a.lse[lrow + qi] : 0.f;
      del_s[tid] = qi < a.Sq ? a.delta[drow + qi] : 0.f;
    }
    __syncthreads();
    scores<HD>(a, Qs, dOs, Ks, Vs, lse_s[r], del_s[r], q0, k0, r, c, Ps, dSs);
    __syncthreads();
    // this thread's key row r: dv += Σ_i p[i][r]·do[i], dk += Σ_i ds[i][r]·q[i]
    for (int i = 0; i < T; ++i) {
      const float p = Ps[i * PS + r], ds = dSs[i * PS + r];
#pragma unroll
      for (int qd = 0; qd < DPT / 4; ++qd) {
        const int d = 4 * TPR * qd + 4 * c;
        const float4 gv = *reinterpret_cast<const float4*>(&dOs[i * RS + d]);
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[i * RS + d]);
        dv[4 * qd + 0] = fmaf(p, gv.x, dv[4 * qd + 0]);
        dv[4 * qd + 1] = fmaf(p, gv.y, dv[4 * qd + 1]);
        dv[4 * qd + 2] = fmaf(p, gv.z, dv[4 * qd + 2]);
        dv[4 * qd + 3] = fmaf(p, gv.w, dv[4 * qd + 3]);
        dk[4 * qd + 0] = fmaf(ds, qv.x, dk[4 * qd + 0]);
        dk[4 * qd + 1] = fmaf(ds, qv.y, dk[4 * qd + 1]);
        dk[4 * qd + 2] = fmaf(ds, qv.z, dk[4 * qd + 2]);
        dk[4 * qd + 3] = fmaf(ds, qv.w, dk[4 * qd + 3]);
      }
    }
  }
  const int kj = k0 + r;
  if (kj < a.Sk) {
    const long long base =
        ((static_cast<long long>(b) * a.Sk + kj) * a.H + h) * HD;
#pragma unroll
    for (int qd = 0; qd < DPT / 4; ++qd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * TPR * qd + 4 * c + e;
        a.dkp[base + d] = dk[4 * qd + e] * a.scale;
        a.dvp[base + d] = dv[4 * qd + e];
      }
  }
}

template <int HD>
__global__ void __launch_bounds__(BNT) bwd_dq_kernel(BwdArgs a) {
  using F = F32Bwd<HD>;
  constexpr int T = F::T, TPR = F::TPR, RS = F::RS, PS = F::PS;
  constexpr int DPT = HD / TPR;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T * RS;
  float* Qs = Vs + T * RS;
  float* dOs = Qs + T * RS;
  float* Ps = dOs + T * RS;
  float* dSs = Ps + T * PS;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int q0 = blockIdx.x * T;
  const int tid = threadIdx.x, r = tid / TPR, c = tid % TPR;
  stage<HD>(Qs, static_cast<const float*>(a.q), b, q0, a.Sq, a.H, h);
  stage<HD>(dOs, static_cast<const float*>(a.dout), b, q0, a.Sq, a.H, h);
  const int qi = q0 + r;
  const float lse_r =
      qi < a.Sq ? a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qi] : 0.f;
  const float del_r = a.delta[(static_cast<long long>(b) * a.H + h) * a.Sqp + qi];

  float dq[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dq[i] = 0.f;

  // the band of keys this tile can see, in whole key tiles
  const int q_last = min(q0 + T, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? (max(0, q0 - a.window + 1) / T) * T : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += T) {
    __syncthreads();  // the last tile's K, V are no longer read
    stage<HD>(Ks, static_cast<const float*>(a.k), b, k0, a.Sk, a.KV, kvh);
    stage<HD>(Vs, static_cast<const float*>(a.v), b, k0, a.Sk, a.KV, kvh);
    __syncthreads();
    scores<HD>(a, Qs, dOs, Ks, Vs, lse_r, del_r, q0, k0, r, c, Ps, dSs);
    __syncwarp();  // row r's dS is written and read by its own warp
    for (int j = 0; j < T; ++j) {
      const float ds = dSs[r * PS + j];
#pragma unroll
      for (int qd = 0; qd < DPT / 4; ++qd) {
        const float4 kv = *reinterpret_cast<const float4*>(
            &Ks[j * RS + 4 * TPR * qd + 4 * c]);
        dq[4 * qd + 0] = fmaf(ds, kv.x, dq[4 * qd + 0]);
        dq[4 * qd + 1] = fmaf(ds, kv.y, dq[4 * qd + 1]);
        dq[4 * qd + 2] = fmaf(ds, kv.z, dq[4 * qd + 2]);
        dq[4 * qd + 3] = fmaf(ds, kv.w, dq[4 * qd + 3]);
      }
    }
  }
  if (qi < a.Sq) {
    float* out = static_cast<float*>(a.dq);
    const long long base =
        ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * HD;
#pragma unroll
    for (int qd = 0; qd < DPT / 4; ++qd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[base + 4 * TPR * qd + 4 * c + e] = dq[4 * qd + e] * a.scale;
  }
}

// ---------------------------------------------------------------------- //
// bfloat16: tensor cores (wgmma) fed by TMA                               //
// ---------------------------------------------------------------------- //

constexpr int BWD_STAGES = 2;  // streamed tile pairs in the ring

template <int HD>
struct TcBwd {
  static constexpr int ATOMS = (HD + 63) / 64;  // 64-column atoms of hd
  // blocks a tile's dK, dV (and dQ) columns are split over: hd 256 in two
  // halves of 128 columns, so that each warpgroup keeps hd 128's register
  // budget
  static constexpr int PARTS = HD > 128 ? 2 : 1;
  static constexpr int NWG = ATOMS / PARTS;  // dk/dv consumer warpgroups
  static constexpr int TILE = ATOMS * ATOM_BYTES;  // a 64-row tile
  static constexpr int ROW = 64 * 4;  // the lse or Δ values of a query tile
  static constexpr int BARS = 8 * (2 * BWD_STAGES + 1);
  static constexpr int DKDV_THREADS = 128 * NWG + 32;
  // 1024 for alignment, two resident tiles, two streamed tiles a stage
  static constexpr int DKDV_SMEM =
      1024 + (2 + 2 * BWD_STAGES) * TILE + 2 * BWD_STAGES * ROW + BARS;
  static constexpr int DQ_SMEM = 1024 + (2 + 2 * BWD_STAGES) * TILE + BARS;
};

// four values at float4 index i4 of p, as float32 or rounded to bf16
__device__ __forceinline__ void store4(float* p, long long i4, float4 v) {
  reinterpret_cast<float4*>(p)[i4] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long i4,
                                       float4 v) {
  reinterpret_cast<uint2*>(p)[i4] =
      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// dk, dv (B, Sk, KV, HD) = the per-head partials summed over each
// group's G heads in order, four columns a thread: float4 columns first,
// first + stride, ...
template <typename T, int HD>
__device__ __forceinline__ void group_sum(const BwdArgs& a, long long first,
                                          long long stride) {
  constexpr int Q4 = HD / 4;
  const int G = a.H / a.KV;
  const float4* kp = reinterpret_cast<const float4*>(a.dkp);
  const float4* vp = reinterpret_cast<const float4*>(a.dvp);
  const long long n = static_cast<long long>(a.B) * a.Sk * a.KV * Q4;
  for (long long idx = first; idx < n; idx += stride) {
    const long long d4 = idx % Q4, rest = idx / Q4;
    const long long kvh = rest % a.KV, bs = rest / a.KV;
    const long long src = (bs * a.H + kvh * G) * Q4 + d4;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int g = 0; g < G; ++g) {
      const float4 x = kp[src + static_cast<long long>(g) * Q4];
      const float4 y = vp[src + static_cast<long long>(g) * Q4];
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    store4(static_cast<T*>(a.dk), idx, sk);
    store4(static_cast<T*>(a.dv), idx, sv);
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// p and ds of one score from its accumulator (q·k, unscaled), dp, the
// row's lse in log2 units and its Δ; CAP: under a softcap
template <bool CAP>
__device__ __forceinline__ void grad(const BwdArgs& a, float sc2, float s,
                                     float dp, float l2, float del, float& p,
                                     float& ds) {
  if constexpr (CAP) {
    const float t = tanhf(s * a.scale / a.softcap);
    p = ex2(a.softcap * t * LOG2E - l2);
    ds = p * (dp - del) * (1.f - t * t);
  } else {
    p = ex2(fmaf(s, sc2, -l2));
    ds = p * (dp - del);
  }
}

// f(cap, masked) with both flags as compile-time constants
template <bool B>
using Flag = std::integral_constant<bool, B>;
template <typename F>
__device__ __forceinline__ void dispatch(bool cap, bool masked, F&& f) {
  if (cap) {
    if (masked) f(Flag<true>{}, Flag<true>{});
    else f(Flag<true>{}, Flag<false>{});
  } else {
    if (masked) f(Flag<false>{}, Flag<true>{});
    else f(Flag<false>{}, Flag<false>{});
  }
}

// the K-major descriptor of k-step kk (16 of hd) of a 64-row tile
__device__ __forceinline__ uint64_t kstep(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * ATOM_BYTES + (kk & 3) * 32);
}

// dk/dv of key tile blockIdx.z (key tile 0 first) for head blockIdx.x,
// batch blockIdx.y
template <int HD>
__global__ void __launch_bounds__(TcBwd<HD>::DKDV_THREADS)
    bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const BwdArgs a) {
  using C = TcBwd<HD>;
  const int kt = blockIdx.z / C::PARTS, part = blockIdx.z % C::PARTS;
  constexpr int NS = BWD_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sV = sK + C::TILE;
  uint8_t* sQ = sV + C::TILE;          // NS stages of Q
  uint8_t* sG = sQ + NS * C::TILE;     // NS stages of dO
  float* sL = reinterpret_cast<float*>(sG + NS * C::TILE);  // lse·log2 e
  float* sD = sL + NS * 64;                                 // Δ
  uint64_t* full = reinterpret_cast<uint64_t*>(sD + NS * 64);
  uint64_t* empty = full + NS;
  uint64_t* kvbar = empty + NS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = kt * 64;
  const int kvh = h / (a.H / a.KV);
  // the query tiles that see some key of this tile
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.Sq, k0 + 63 + a.window) : a.Sq;
  const int n_tiles = q_hi > q_lo ? (q_hi - q_lo + 63) / 64 : 0;
  const long long srow = (static_cast<long long>(b) * a.H + h) * a.Sqp;
  // the warp index through a shuffle (see flash_tc_kernel)
  const int warp = __shfl_sync(FULL, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::NWG);  // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::NWG) {  // the producer warp
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(kvbar, 2 * C::TILE);
      for (int at = 0; at < C::ATOMS; ++at) {
        tma_load_4d(sK + at * ATOM_BYTES, &tk, kvbar, 64 * at, kvh, k0, b);
        tma_load_4d(sV + at * ATOM_BYTES, &tv, kvbar, 64 * at, kvh, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS;
        if (j >= NS) mbar_wait(&empty[s], ((j / NS) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::TILE + 2 * C::ROW);
        const int q0 = q_lo + 64 * j;
        for (int at = 0; at < C::ATOMS; ++at) {
          tma_load_4d(sQ + s * C::TILE + at * ATOM_BYTES, &tq, &full[s],
                      64 * at, h, q0, b);
          tma_load_4d(sG + s * C::TILE + at * ATOM_BYTES, &tdo, &full[s],
                      64 * at, h, q0, b);
        }
        bulk_load(sL + 64 * s, a.lse2 + srow + q0, C::ROW, &full[s]);
        bulk_load(sD + 64 * s, a.delta + srow + q0, C::ROW, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg owns dK and dV columns [64·ca, 64·ca + 64) (ca:
  // the atom part·NWG + wg); this thread holds key rows kr and kr + 8 of
  // every fragment, and query columns cl + 8·i (+1)
  const int wg = warp >> 2, ca = part * C::NWG + wg;
  const int kr = 16 * (warp & 3) + (lane >> 2);
  const int cl = 2 * (lane & 3);
  const float sc2 = a.scale * LOG2E;
  const uint32_t ka = smem_u32(sK), va = smem_u32(sV);
  float dk[32], dv[32], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = st[i] = dpt[i] = 0.f;
  uint32_t pa[4][4], da[4][4];  // Pᵀ and dSᵀ as A fragments

  if (n_tiles > 0) mbar_wait(kvbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS;
    mbar_wait(&full[s], (j / NS) & 1);
    __syncwarp();
    const int q0 = q_lo + 64 * j;
    const uint32_t qa = smem_u32(sQ + s * C::TILE);
    const uint32_t ga = smem_u32(sG + s * C::TILE);
    fence_regs(st);
    fence_regs(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(st, kstep(ka, kk), kstep(qa, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dpt, kstep(va, kk), kstep(ga, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // element i: key row kr + 8·((i >> 1) & 1), query column
    // cl + 8·(i >> 2) + (i & 1)
    const bool edge = (a.causal && q0 < k0 + 63) ||
                      (a.window > 0 && q0 + 63 - k0 >= a.window);
    const float* ls = sL + 64 * s;
    const float* dl = sD + 64 * s;
    // the 32 scores in one branch-free stretch (the softcap and the masks
    // chosen once a tile), so the compiler interleaves their chains
    auto scores = [&](auto cap, auto masked) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = cl + 8 * (i >> 2);
        const float2 l = *reinterpret_cast<const float2*>(ls + c);
        const float2 d = *reinterpret_cast<const float2*>(dl + c);
        float p0, p1, g0, g1;
        grad<decltype(cap)::value>(a, sc2, st[i], dpt[i], l.x, d.x, p0, g0);
        grad<decltype(cap)::value>(a, sc2, st[i + 1], dpt[i + 1], l.y, d.y,
                                   p1, g1);
        if constexpr (decltype(masked)::value) {
          const int kj = k0 + kr + ((i & 2) ? 8 : 0), qi = q0 + c;
          if (!visible(a, qi, kj)) p0 = g0 = 0.f;
          if (!visible(a, qi + 1, kj)) p1 = g1 = 0.f;
        }
        pa[i >> 3][(i & 7) >> 1] = pack_bf16(p0, p1);
        da[i >> 3][(i & 7) >> 1] = pack_bf16(g0, g1);
      }
    };
    dispatch(a.softcap > 0.f, edge, scores);

    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);
    fence_regs(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dv, pa[kk], sw128_desc(ga + ca * ATOM_BYTES + kk * 2048));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dk, da[kk], sw128_desc(qa + ca * ATOM_BYTES + kk * 2048));
    wg_commit();
    wg_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(pa);  // this warp's products no longer read stage s
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int kj = k0 + kr;
  const long long base0 =
      ((static_cast<long long>(b) * a.Sk + kj) * a.H + h) * HD;
  const long long base1 = base0 + 8LL * a.H * HD;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 64 * ca + 8 * jj + cl;
    if (64 * ca + 8 * jj >= HD) break;  // zero columns past hd
    if (kj < a.Sk) {
      *reinterpret_cast<float2*>(a.dkp + base0 + col) =
          make_float2(dk[4 * jj] * a.scale, dk[4 * jj + 1] * a.scale);
      *reinterpret_cast<float2*>(a.dvp + base0 + col) =
          make_float2(dv[4 * jj], dv[4 * jj + 1]);
    }
    if (kj + 8 < a.Sk) {
      *reinterpret_cast<float2*>(a.dkp + base1 + col) =
          make_float2(dk[4 * jj + 2] * a.scale, dk[4 * jj + 3] * a.scale);
      *reinterpret_cast<float2*>(a.dvp + base1 + col) =
          make_float2(dv[4 * jj + 2], dv[4 * jj + 3]);
    }
  }
}

// dq of query tile gridDim.z − 1 − blockIdx.z (the last, with the most
// keys under causal, first) for head blockIdx.x, batch blockIdx.y
template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
    bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const BwdArgs a) {
  using C = TcBwd<HD>;
  // dQ's atoms this block owns: DQA of them from the atom part·DQA
  constexpr int NS = BWD_STAGES, ATOMS = C::ATOMS, DQA = ATOMS / C::PARTS;
  const int qt = gridDim.z / C::PARTS - 1 - blockIdx.z / C::PARTS;
  const int a0 = blockIdx.z % C::PARTS * DQA;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sG = sQ + C::TILE;
  uint8_t* sK = sG + C::TILE;       // NS stages of K
  uint8_t* sV = sK + NS * C::TILE;  // NS stages of V
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + NS * C::TILE);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = qt * 64;
  const int kvh = h / (a.H / a.KV);
  // the band of keys this tile can see, in whole key tiles
  const int q_last = min(q0 + 64, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? (max(0, q0 - a.window + 1) / 64) * 64 : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + 63) / 64 : 0;
  const int warp = __shfl_sync(FULL, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(qbar, 2 * C::TILE);
      for (int at = 0; at < ATOMS; ++at) {
        tma_load_4d(sQ + at * ATOM_BYTES, &tq, qbar, 64 * at, h, q0, b);
        tma_load_4d(sG + at * ATOM_BYTES, &tdo, qbar, 64 * at, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS;
        if (j >= NS) mbar_wait(&empty[s], ((j / NS) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::TILE);
        const int k0 = k_begin + 64 * j;
        for (int at = 0; at < ATOMS; ++at) {
          tma_load_4d(sK + s * C::TILE + at * ATOM_BYTES, &tk, &full[s],
                      64 * at, kvh, k0, b);
          tma_load_4d(sV + s * C::TILE + at * ATOM_BYTES, &tv, &full[s],
                      64 * at, kvh, k0, b);
        }
      }
    }
    return;
  }

  // this thread holds query rows r0 and r0 + 8, key columns cl + 8·i (+1)
  const int r0 = q0 + 16 * warp + (lane >> 2);
  const int cl = 2 * (lane & 3);
  const float sc2 = a.scale * LOG2E;
  const long long srow = (static_cast<long long>(b) * a.H + h) * a.Sqp;
  const float l0 = a.lse2[srow + r0], l1 = a.lse2[srow + r0 + 8];
  const float d0 = a.delta[srow + r0], d1 = a.delta[srow + r0 + 8];
  const uint32_t qa = smem_u32(sQ), ga = smem_u32(sG);
  float dq[DQA][32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = dp[i] = 0.f;
#pragma unroll
    for (int at = 0; at < DQA; ++at) dq[at][i] = 0.f;
  }
  uint32_t da[4][4];  // dS as A fragments

  if (n_tiles > 0) mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS;
    mbar_wait(&full[s], (j / NS) & 1);
    __syncwarp();
    const int k0 = k_begin + 64 * j;
    const uint32_t ka = smem_u32(sK + s * C::TILE);
    const uint32_t va = smem_u32(sV + s * C::TILE);
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sc, kstep(qa, kk), kstep(ka, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(dp, kstep(ga, kk), kstep(va, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // element i: query row r0 + 8·((i >> 1) & 1), key column
    // k0 + cl + 8·(i >> 2) + (i & 1)
    const bool edge = k0 + 64 > a.Sk || (a.causal && q0 < k0 + 63) ||
                      (a.window > 0 && q0 + 63 - k0 >= a.window);
    // branch-free, as in the dk/dv kernel
    auto scores = [&](auto cap, auto masked) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const bool hi = i & 2;
        float p0, p1, g0, g1;
        grad<decltype(cap)::value>(a, sc2, sc[i], dp[i], hi ? l1 : l0,
                                   hi ? d1 : d0, p0, g0);
        grad<decltype(cap)::value>(a, sc2, sc[i + 1], dp[i + 1],
                                   hi ? l1 : l0, hi ? d1 : d0, p1, g1);
        if constexpr (decltype(masked)::value) {
          const int qi = r0 + (hi ? 8 : 0), kj = k0 + cl + 8 * (i >> 2);
          if (!(kj < a.Sk && visible(a, qi, kj))) g0 = 0.f;
          if (!(kj + 1 < a.Sk && visible(a, qi, kj + 1))) g1 = 0.f;
        }
        da[i >> 3][(i & 7) >> 1] = pack_bf16(g0, g1);
      }
    };
    dispatch(a.softcap > 0.f, edge, scores);

#pragma unroll
    for (int at = 0; at < DQA; ++at) fence_regs(dq[at]);
    fence_regs(da);
    wg_fence();
#pragma unroll
    for (int at = 0; at < DQA; ++at)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dq[at], da[kk],
                 sw128_desc(ka + (a0 + at) * ATOM_BYTES + kk * 2048));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int at = 0; at < DQA; ++at) fence_regs(dq[at]);
    fence_regs(da);  // this warp's products no longer read stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq);
  const long long row0 = (static_cast<long long>(b) * a.Sq + r0) * a.H + h;
  const long long row1 = row0 + 8LL * a.H;
#pragma unroll
  for (int at = 0; at < DQA; ++at)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (64 * (a0 + at) + 8 * jj >= HD) continue;  // a zero column past hd
      const int col = 64 * (a0 + at) + 8 * jj + cl;
      if (r0 < a.Sq)
        *reinterpret_cast<uint32_t*>(out + row0 * HD + col) = pack_bf16(
            dq[at][4 * jj] * a.scale, dq[at][4 * jj + 1] * a.scale);
      if (r0 + 8 < a.Sq)
        *reinterpret_cast<uint32_t*>(out + row1 * HD + col) = pack_bf16(
            dq[at][4 * jj + 2] * a.scale, dq[at][4 * jj + 3] * a.scale);
    }

  // The group sum of dk and dv (the dk/dv launch left its partials
  // complete), by the consumer threads of the later half of the grid:
  // the query tiles with the fewest keys under causal, which finish
  // first, so that the blocks with the most keys end no later.
  const unsigned half = gridDim.z / 2;
  if (blockIdx.z >= half) {
    const long long helpers =
        static_cast<long long>(gridDim.z - half) * gridDim.y * gridDim.x;
    const long long me =
        (static_cast<long long>(blockIdx.z - half) * gridDim.y + blockIdx.y) *
            gridDim.x + blockIdx.x;
    group_sum<__nv_bfloat16, HD>(a, me * 128 + threadIdx.x, helpers * 128);
  }
}

// ---------------------------------------------------------------------- //
// the group sum and the launchers                                         //
// ---------------------------------------------------------------------- //

// the group sum as its own launch (float32)
template <typename T, int HD>
__global__ void __launch_bounds__(BNT) bwd_reduce_kernel(BwdArgs a) {
  group_sum<T, HD>(a, static_cast<long long>(blockIdx.x) * BNT + threadIdx.x,
                   static_cast<long long>(gridDim.x) * BNT);
}

template <typename T, int HD>
cudaError_t launch_delta(const BwdArgs& a, cudaStream_t s) {
  constexpr int LP = delta_lanes<T, HD>();
  const long long threads = static_cast<long long>(a.B) * a.H * a.Sqp * LP;
  const long long blocks = (threads + BNT - 1) / BNT;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  bwd_delta_kernel<T, HD><<<static_cast<unsigned>(blocks), BNT, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_reduce(const BwdArgs& a, cudaStream_t s) {
  bwd_reduce_kernel<T, HD><<<264, BNT, 0, s>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_f32(const BwdArgs& a, cudaStream_t s) {
  constexpr int T = F32Bwd<HD>::T;
  constexpr size_t smem = F32Bwd<HD>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dq_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if ((e = launch_delta<float, HD>(a, s)) != cudaSuccess) return e;
  bwd_dkdv_kernel<HD><<<dim3((a.Sk + T - 1) / T, a.H, a.B), BNT, smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_kernel<HD><<<dim3((a.Sq + T - 1) / T, a.H, a.B), BNT, smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_reduce<float, HD>(a, s);
}

template <int HD>
cudaError_t launch_bwd_tc(const BwdArgs& a, cudaStream_t s) {
  using C = TcBwd<HD>;
  const long long hq = static_cast<long long>(a.H) * HD;
  const long long hk = static_cast<long long>(a.KV) * HD;
  CUtensorMap tq, tdo, tk, tv;
  if (!tensor_map(&tq, a.q, a.B, a.Sq, a.H, HD, a.Sq * hq, hq, HD, 64) ||
      !tensor_map(&tdo, a.dout, a.B, a.Sq, a.H, HD, a.Sq * hq, hq, HD, 64) ||
      !tensor_map(&tk, a.k, a.B, a.Sk, a.KV, HD, a.Sk * hk, hk, HD, 64) ||
      !tensor_map(&tv, a.v, a.B, a.Sk, a.KV, HD, a.Sk * hk, hk, HD, 64))
    return cudaErrorInvalidValue;
  const long long kt = (a.Sk + 63) / 64 * C::PARTS;
  const long long qt = (a.Sq + 63) / 64 * C::PARTS;
  if (kt > 65535 || qt > 65535) return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = launch_delta<__nv_bfloat16, HD>(a, s)) != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dkdv_tc_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::DKDV_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dq_tc_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::DQ_SMEM);
  if (e != cudaSuccess) return e;
  bwd_dkdv_tc_kernel<HD>
      <<<dim3(a.H, a.B, static_cast<unsigned>(kt)), C::DKDV_THREADS,
         C::DKDV_SMEM, s>>>(tq, tdo, tk, tv, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bwd_dq_tc_kernel<HD><<<dim3(a.H, a.B, static_cast<unsigned>(qt)),
                         TC_THREADS, C::DQ_SMEM, s>>>(tq, tdo, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

// ptrs: q, k, v, o, do, lse, delta, lse2 (scratch), dq, dk_partial,
// dv_partial (scratch), dk, dv.  q, o, do, dq: (B, Sq, H, hd) contiguous;
// k, v, dk, dv: (B, Sk, KV, hd) contiguous; all of them 16-byte aligned;
// lse: (B, H, Sq) float32; delta, lse2: (B, H, Sqp) float32 with Sqp = Sq
// rounded up to a multiple of 64; the partials (B, Sk, H, hd) float32.
// ints: B, Sq, Sk, H, KV, hd, dtype (0 = float32, 1 = bfloat16), causal,
// window (<= 0: none), device.  softcap <= 0: none.  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(void* const* ptrs, const int* ints,
                                          float softcap, float scale,
                                          void* stream) {
  BwdArgs a;
  a.q = ptrs[0]; a.k = ptrs[1]; a.v = ptrs[2]; a.o = ptrs[3];
  a.dout = ptrs[4];
  a.lse = static_cast<const float*>(ptrs[5]);
  a.delta = static_cast<float*>(ptrs[6]);
  a.lse2 = static_cast<float*>(ptrs[7]);
  a.dq = ptrs[8];
  a.dkp = static_cast<float*>(ptrs[9]);
  a.dvp = static_cast<float*>(ptrs[10]);
  a.dk = ptrs[11]; a.dv = ptrs[12];
  a.B = ints[0]; a.Sq = ints[1]; a.Sk = ints[2]; a.H = ints[3];
  a.KV = ints[4];
  const int hd = ints[5], dtype = ints[6];
  a.causal = ints[7]; a.window = ints[8];
  a.softcap = softcap; a.scale = scale;
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.KV < 1 || a.H % a.KV != 0 ||
      a.B > 65535 || a.H > 65535 || a.Sq > 2147483647 - 63)
    return static_cast<int>(cudaErrorInvalidValue);
  a.Sqp = (a.Sq + 63) / 64 * 64;
  cudaError_t e = cudaSetDevice(ints[9]);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) e = launch_bwd_f32<64>(a, s);
  else if (dtype == 0 && hd == 80) e = launch_bwd_f32<80>(a, s);
  else if (dtype == 0 && hd == 128) e = launch_bwd_f32<128>(a, s);
  else if (dtype == 0 && hd == 256) e = launch_bwd_f32<256>(a, s);
  else if (dtype == 1 && hd == 64) e = launch_bwd_tc<64>(a, s);
  else if (dtype == 1 && hd == 80) e = launch_bwd_tc<80>(a, s);
  else if (dtype == 1 && hd == 128) e = launch_bwd_tc<128>(a, s);
  else if (dtype == 1 && hd == 256) e = launch_bwd_tc<256>(a, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
