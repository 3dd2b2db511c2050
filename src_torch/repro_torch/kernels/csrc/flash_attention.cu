// flash_attention: causal / GQA / sliding-window attention forward with an
// online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:94
// (flash_attention, pallas_call at :128, body _kernel :51).  Same function:
//   - q (B, S, H, hd), already scaled by 1/sqrt(hd); k, v (B, S, KV, hd);
//     the kv head of q head h is h / (H / KV);
//   - key kp is visible from query qp when kp < S, when kp <= qp if causal,
//     and when kp > qp - window if window != 0;
//   - softmax in fp32 whatever the input dtype, the output cast back to it;
//   - a row whose every key is masked gives 0 (the reference's l >= 1e-30
//     guard), and padded or out-of-band keys contribute nothing.
// The reference pads S to its block size and visits every (q, kv) block;
// both kernels here read q, k and v in place through their strides (no
// moveaxis, no pad), mask the ragged edge themselves and visit only the keys
// some row of their query block can see (the causal and window band): the
// same result for about half the work at the serving shape.  Both launch the
// heaviest q blocks (last in the sequence) first.
//
// Two routes, chosen by dtype alone (kernels/flash_attention.py):
//   - bf16, the serving path: flash_tc_kernel, on the bf16 tensor cores;
//   - fp32: f32::flash_f32_kernel, on the fp32 CUDA cores.  No bf16 or
//     single-TF32 product holds the fp32 tolerance (2e-5), so fp32 stays
//     there, in fp32 FMAs.
//
// What bounds it: operations.  At the serving shape (B 4, S 4500, H 32,
// KV 8, hd 80, window 4096) the band is 1.29e9 (q, k) pairs, 4*hd = 320
// flops each: 411 GFLOP, 0.42 ms on the bf16 tensor cores (989 TFLOP/s),
// against 230 MB of q, k, v and o (0.07 ms at 3.35 TB/s).  At
// recurrentgemma's local attention (B 4, S 4096, H 10, KV 1, hd 256, window
// 2048) the band is 6,292,480 pairs per (b, h), 1024 flops each: 257.7
// GFLOP, 0.26 ms on the tensor cores.  Beside the two products (4 hd flops
// a score), every score costs one exp2 on the SM's 16 special-function
// lanes a cycle, against ~4270 tensor flops a cycle: at hd 64 the exp2s
// alone take as long as the products, so the two have to overlap.
//
// bf16 design (flash_tc_kernel, FlashAttention-3's shape), at every head
// dim (16, 32, 64, 80, 128, 256):
//   - a persistent grid of one CTA per SM (its warpgroups hold all of the
//     SM's registers), walking the (query block, head, batch) items
//     heaviest first, the rounds in alternating directions (item_of);
//   - a producer warpgroup, whose one elected thread issues TMA loads: the
//     item's Q block, then each K and V tile of the band into a ring of two
//     shared-memory stages.  Each stage has a full and an empty mbarrier for
//     K and for V apiece, so a K tile is refilled as soon as its Q K^T is
//     done while its V tile is still being read, and the producer runs into
//     the next item (its Q block once the consumers' last Q K^T is done)
//     while the consumers finish this one.  It drops to 24 or 32 registers
//     (setmaxnreg);
//   - consumer warpgroups of 64 query rows: three (192-row blocks, 160
//     registers) up to hd 80, where the exp2s weigh most against the
//     products, two (128 rows, 240 registers) above.  S = Q K^T is wgmma
//     m64n{keys}k16 with both operands in shared memory (K-major); O += P V
//     is wgmma m64n{hd}k16 with P from registers (the accumulator layout of
//     two adjacent 8-key columns of S is the A-fragment layout of a 16-key
//     step) and V from shared memory as an MN-major operand (no transpose);
//   - tiles arrive by TMA through 4-d tensor maps (head dim, sequence, head,
//     batch; encoded on the host from the strides the wrapper computes and
//     checks) in 64-column slabs under the 128-byte swizzle, the layout
//     wgmma's descriptors read without bank conflicts (hd 16 and 32: one
//     slab of their own width, 32- or 64-byte swizzle).  hd 80's 160-byte
//     row is two slabs, the second zero-filled past column 80.  Rows past S
//     arrive as zeros, and the kp < S mask discards them;
//   - overlap: a consumer issues tile t's Q K^T with tile t-1's P V and runs
//     tile t's softmax while P V runs, where its registers hold O, S and P
//     at once (overlap_for: not at hd 80 under 160 registers, where it
//     spilled); the consumers taking turns on named barriers (ping-pong)
//     and a third ring stage measured no faster on this card;
//   - tiles: 128 keys, 64 at hd 256 (its O alone is 128 registers a
//     thread); the products' k-steps cover the head dim's 16-column steps
//     only, so hd 80 multiplies no padding;
//   - the softmax works in fp32 on the accumulators in registers (row max
//     and sum by quad shuffles, exp2 on ex2.approx with the log2 e scale
//     folded into one FMA), masks only on tiles that straddle an edge of the
//     band (causal diagonal, window edge, end of the sequence; edge_tile,
//     mirrored in tests/test_torch_flash_tma.py) by two compares a score against the
//     row's first and last visible key, and rounds P to bf16 only as the A
//     operand of P V, after the previous P V has finished reading its
//     registers;
//   - the epilogue multiplies by 1 / max(l, 1e-30) (a row with no visible
//     key gives exactly 0) and writes bf16 rows below S only.
// A wait on an mbarrier that has not completed after ~10 s of clock traps
// (a launch error that loses the process's CUDA context) instead of
// hanging the card (mbar_wait).
//
// fp32 design (f32::flash_f32_kernel, a SIMT GEMM's shape), at every head
// dim.  Its bound is the same flops on the fp32 CUDA cores (67 TFLOP/s):
// 6.1 ms at danube's shape, 3.8 ms at recurrentgemma's.  One CTA a (query
// block, head, batch) item, heaviest blocks first; 256 threads, or 128 at
// hd 64 and 80 with two CTAs an SM:
//   - tiles in dynamic shared memory: a Q block of 128 rows (64 at hd 256)
//     pre-multiplied by log2 e once, and a ring of two stages of K and V
//     tiles (64 keys; 48 at hd 128, 32 for a 128-thread CTA: the most that
//     fits), taking K_0, V_0, K_1, ... in turn; at hd 256 each tile comes
//     as two 128-column slices, so that 64-key tiles fit beside the Q
//     block.  Each slice is copied by 16-byte cp.async spread over the CTA,
//     rows past S zero-filled (the wrapper copies a view whose rows are not
//     16-byte aligned first), and waited for by its cp.async group and one
//     CTA barrier, after which the slot of the slice before it takes the
//     copies of the slice three ahead: tile t + 1's copies fly while tile
//     t computes;
//   - both products register-tiled: thread (rg, cg) owns 2-8 query rows
//     (rg + kRG i), shared with the 4, 8 or 16 threads of its row group
//     (one warp).  For S = Q K^T it holds its rows' scores against keys cg
//     + kCG j of the tile (2-8 x 3-16 scores), the head dim walked in
//     float4 steps, so that each LDS.128 of Q feeds 12-64 FMAs and each of K
//     8-32; no shuffle inside a dot product.  P goes through shared memory
//     transposed (a key's row holds the block's rows in row-group order),
//     and for O += P V the thread holds its rows' output at float4 columns
//     cg + kCG c of each slice: a key's LDS.128 of V feeds 8-32 FMAs, its
//     load of P 8-80.  The rows' strides are padded (q_stride,
//     kv_stride, p_stride) so that every read and write of the micro-tiles
//     takes the fewest shared-memory wavefronts its bytes allow;
//   - one softmax a score: a thread takes the max of its own scores of a
//     row, the row's threads combine it by 2-4 shuffles once a tile, then
//     one exp2 a score, O rescaled once a tile; the row sums stay partial
//     per thread until the epilogue's shuffles.  Only tiles that straddle
//     the causal diagonal, the window's lower edge or S (tc::edge_tile)
//     compare keys against each row's visible range [kmin, kmax].
// Against the earlier kernel (4 or 8 lanes a row, each score kLanes partial
// dot products summed by shuffles, each lane running the same softmax and
// rescale, K and V staged a float a step through registers, 32- or 16-key
// tiles in 48 KB of static shared memory): a shared-memory load feeds 8-80
// FMAs, not 4, the softmax and the staging's divisions are done once, no
// copy waits on registers, and hd 256's tiles feed 64 rows, not 32.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// the reference's NEG_INF, -0.7 * float32 max: the running max before any key
constexpr float kNegInf = -0.7f * 3.402823466e38f;

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, s, h;
};

// ---------------------------------------------------------------------------
// bf16 route: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

// consumer warpgroups of 64 query rows: three up to hd 80 (more products
// in flight beside each one's softmax, where the exp2s weigh most), two
// above (the accumulators need 240 registers a thread)
__host__ __device__ constexpr int consumers_for(int hd) {
  return hd <= 80 ? 3 : 2;
}
__host__ __device__ constexpr int rows_for(int hd) {  // query rows a CTA
  return 64 * consumers_for(hd);
}
__host__ __device__ constexpr int threads_for(int hd) {  // + the producer
  return 128 * (consumers_for(hd) + 1);
}
// registers a thread after setmaxnreg: the warpgroups' 64K between them
__host__ __device__ constexpr int producer_regs(int hd) {
  return consumers_for(hd) == 2 ? 24 : 32;
}
__host__ __device__ constexpr int consumer_regs(int hd) {
  return consumers_for(hd) == 2 ? 240 : 160;
}
constexpr int kAlign = 1024;       // a tile's alignment (the swizzle atom)
constexpr int kBarBytes = 128;     // the mbarriers, after the tiles
// cycles an mbarrier wait may spin before it traps (~10 s; see mbar_wait)
constexpr long long kWaitCycles = 20000000000LL;

// stages of the K / V ring (a third measured no faster)
constexpr int kStages = 2;
// keys per K / V tile at head dim hd
__host__ __device__ constexpr int keys_for(int hd) {
  return hd > 128 ? 64 : 128;
}
// A consumer issues tile t's Q K^T with tile t-1's P V and runs tile t's
// softmax while P V runs, where its registers hold O, S and P at once with
// 32 to spare (not at hd 80 under 160 registers: it spilled); else Q K^T,
// softmax and P V one after another
__host__ __device__ constexpr bool overlap_for(int hd) {
  return consumer_regs(hd) - (hd / 2 + 3 * keys_for(hd) / 4) >= 32;
}
// columns of a swizzled head-dim slab (64 under the 128-byte swizzle; a
// narrower head dim is one slab of its own width, under the 32- or 64-byte
// swizzle), and the head dim padded to whole slabs: hd 80 is two 64-column
// slabs, the second zero-filled by TMA past column 80
__host__ __device__ constexpr int slab_for(int hd) { return hd < 64 ? hd : 64; }
__host__ __device__ constexpr int padded_for(int hd) {
  return (hd + slab_for(hd) - 1) / slab_for(hd) * slab_for(hd);
}
// the wgmma descriptor's layout code of that swizzle
__host__ __device__ constexpr int swizzle_code(int slab) {
  return slab == 64 ? 1 : (slab == 32 ? 2 : 3);
}
// dynamic shared memory: alignment slack, the Q block, kStages K and V
// tiles, the barriers
__host__ __device__ constexpr int smem_bytes(int hd) {
  return kAlign +
         (rows_for(hd) + 2 * kStages * keys_for(hd)) * padded_for(hd) *
             2 +
         kBarBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of parity `parity` has completed.  A wait that is still
// open after kWaitCycles (~10 s; a wait of a correct launch lasts
// microseconds, and a context that time-slices the card with others is
// switched in every few milliseconds) traps.  It ships on purpose: a
// parity fault in the ring would otherwise spin the card forever, where no
// tool can stop it short of losing the machine, while a trap ends the
// launch with an error.  The trap leaves the calling process's CUDA
// context unusable: its next synchronise raises, and the process has to
// be restarted, as after any device-side fault.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// one TMA load of a 4-d box at coordinates c0..c3 into shared memory at
// dst, completing on barrier bar
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, int c3,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// rows [row, row + rows) of head `head` of batch `b` into a tile of
// shared memory, slab by slab (one TMA load each), on barrier bar
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, uint32_t slab_bytes,
                                         const CUtensorMap* map, int row,
                                         int head, int b, uint32_t bar) {
#pragma unroll
  for (int j = 0; j < padded_for(HD) / slab_for(HD); ++j)
    tma_load4(dst + j * slab_bytes, map, j * slab_for(HD), row, head, b, bar);
}

// two floats as a bf16x2 register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Keys [t0, t0 + keys) need a mask for query rows [a, a + rows) when the
// tile straddles the causal diagonal, the window's lower edge or the end
// of the sequence (mirrored in tests/test_torch_flash_tma.py)
__device__ __forceinline__ bool edge_tile(int t0, int keys, int a, int rows,
                                          int S, int causal, int window) {
  return (causal && t0 + keys - 1 > a) ||
         (window != 0 && t0 <= a + rows - 1 - window) || t0 + keys > S;
}

template <int HD>
struct Plan {
  static constexpr int kConsumers = consumers_for(HD);
  static constexpr int kRows = rows_for(HD);
  static constexpr int kKeys = keys_for(HD);
  static constexpr bool kOverlap = overlap_for(HD);
  static constexpr int kSlab = slab_for(HD);
  static constexpr int kPadded = padded_for(HD);  // whole slabs
  static constexpr int kSwz = swizzle_code(kSlab);
  static constexpr uint32_t kRowBytes = kSlab * 2;      // a slab's row
  static constexpr uint32_t kGroup = 8 * kRowBytes;     // 8 rows of it
  static constexpr uint32_t kQBytes = kRows * kPadded * 2;
  static constexpr uint32_t kTileBytes = kKeys * kPadded * 2;
  static constexpr uint32_t kQSlab = kRows * kRowBytes;   // one Q slab
  static constexpr uint32_t kKSlab = kKeys * kRowBytes;   // one K / V slab
  static_assert(HD % 16 == 0, "head dim into k-steps");
  static_assert(kKeys % 16 == 0 && kKeys <= 256, "key tile into k-steps");
  static_assert(kQBytes % kAlign == 0 && kTileBytes % kAlign == 0,
                "tiles keep the swizzle atom's alignment");
};

// 2^x on the special-function unit (ex2.approx, subnormal results
// flushed to 0): P only feeds a bf16 product and an fp32 sum
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a descriptor's value as the compiler cannot see it: the per-step
// descriptors are then formed at their use, not hoisted out of the key
// loop into registers the accumulators need
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// S = Q K^T for this warpgroup's 64 rows: hd / 16 k-steps, one group.
// q, k: descriptors of the first step; a step moves the start address
// (the descriptor's low bits, in 16-byte units) by a constant
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[keys_for(HD) / 2],
                                         uint64_t q, uint64_t k) {
  using P = Plan<HD>;
  q = opaque(q);
  k = opaque(k);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int slab = kk * 16 / P::kSlab;
    const uint32_t col = (kk * 16 % P::kSlab) * 2;
    wg::Wgmma<P::kKeys>::ss(s, q + ((slab * P::kQSlab + col) >> 4),
                            k + ((slab * P::kKSlab + col) >> 4), kk > 0);
  }
  wg::wgmma_commit();
}

// O += P V: keys / 16 k-steps over V's rows, one group; v: the descriptor
// of the first step (V is MN-major, its head dim contiguous: slabs kKSlab
// apart, 8-row groups kGroup apart)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[keys_for(HD) /
                                                             16][4],
                                         uint64_t v) {
  using P = Plan<HD>;
  v = opaque(v);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < P::kKeys / 16; ++kk)
    wg::Wgmma<HD>::rs(o, p[kk], v + ((kk * 16 * P::kRowBytes) >> 4));
  wg::wgmma_commit();
}

// The shared-memory layout of flash_tc_kernel (addresses in the shared
// window): the Q block, kStages K and V tiles, then the mbarriers: Q full
// and Q empty, and per stage K full, V full, K empty, V empty
template <int HD>
struct Smem {
  uint32_t q, k, v, qfull, qempty, kfull, vfull, kempty, vempty;
  __device__ __forceinline__ explicit Smem(uint32_t base) {
    using P = Plan<HD>;
    q = base;
    k = q + P::kQBytes;
    v = k + kStages * P::kTileBytes;
    qfull = v + kStages * P::kTileBytes;
    qempty = qfull + 8;
    kfull = qempty + 8;
    vfull = kfull + 8 * kStages;
    kempty = vfull + 8 * kStages;
    vempty = kempty + 8 * kStages;
  }
};

// The item a CTA takes in round k of the persistent grid: the rounds
// alternate direction (CTA c takes item c of even rounds and item
// gridDim.x - 1 - c of odd ones), so that the heaviest-first items even
// out across CTAs
__device__ __forceinline__ int item_of(int k) {
  const int c = k & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return k * gridDim.x + c;
}

// One work item: a query block (q0) of head h of batch b, and the key
// tiles [lo + t keys, ...) it visits.  Items run heaviest first: every
// (head, batch)'s last query block, then the ones before
struct Item {
  int q0, h, b, lo, ntiles;
  __device__ __forceinline__ Item(int w, int nqb, int H, int B, int S,
                                  int rows, int keys, int causal,
                                  int window) {
    const int qb = nqb - 1 - w / (H * B);
    const int r = w % (H * B);
    h = r % H;
    b = r / H;
    q0 = qb * rows;
    // the keys some row of this block can see: [lo, hi)
    lo = window != 0 ? max(0, q0 - window + 1) : 0;
    const int hi = causal ? min(q0 + rows, S) : S;
    ntiles = hi > lo ? (hi - lo + keys - 1) / keys : 0;
  }
};

// The consumer warpgroups' part of one item: warpgroup wgi's 64 rows of
// the query block against its key tiles, which are this CTA's tiles
// it0, it0 + 1, ... of the ring; nq counts the CTA's earlier Q blocks
template <int HD>
__device__ __forceinline__ void consume(const Smem<HD>& sm, const Item& w,
                                        int wgi, int it0, int nq,
                                        bf16* __restrict__ o, int S,
                                        Strides os, int causal, int window) {
  using P = Plan<HD>;
  constexpr int kKeys = P::kKeys;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;  // the accumulator row (and row + 8) of a lane
  const int tig = lane & 3;   // its column pair in each 8-column block
  const int a = w.q0 + 64 * wgi;          // this warpgroup's first row
  const int r0 = a + 16 * warp + gid;     // this thread's rows r0, r0 + 8
  const int lo = w.lo, ntiles = w.ntiles;
  // descriptors of the first k-step: this warpgroup's 64 rows of the Q
  // block, and each stage's K and V tiles
  const uint64_t dq = wg::make_desc(sm.q + 64 * wgi * P::kRowBytes, 16,
                                    P::kGroup, P::kSwz);
  const uint64_t dk = wg::make_desc(sm.k, 16, P::kGroup, P::kSwz);
  const uint64_t dv = wg::make_desc(sm.v, P::kKSlab, P::kGroup, P::kSwz);
  constexpr uint32_t kStageStep = P::kTileBytes >> 4;  // in 16-byte units

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  // running max (raw score units; -inf before any visible key) and this
  // lane's share of the row sums, for rows r0 and r0 + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  if (ntiles > 0) {
    float s[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
    uint32_t p[kKeys / 16][4];
    constexpr bool kOverlap = P::kOverlap;
    // the keys rows r0 and r0 + 8 can see: [kmin, kmax]
    int kmin[2], kmax[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = r0 + 8 * r;
      kmin[r] = window != 0 ? qp - window + 1 : -(1 << 30);
      kmax[r] = causal ? min(qp, S - 1) : S - 1;
    }
    // ring stage and phase parity of the item's tile t
    auto stage = [&](int t) { return (it0 + t) % kStages; };
    auto phase = [&](int t) {
      return static_cast<uint32_t>(((it0 + t) / kStages) & 1);
    };
    auto kfull = [&](int t) { return sm.kfull + 8 * stage(t); };
    auto vfull = [&](int t) { return sm.vfull + 8 * stage(t); };
    auto kempty = [&](int t) { return sm.kempty + 8 * stage(t); };
    auto vempty = [&](int t) { return sm.vempty + 8 * stage(t); };
    auto fence_s = [&]() {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) wg::fence_operand(s[i]);
    };
    auto fence_acc = [&]() {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) wg::fence_operand(acc[i]);
    };

    // scores of tile t0 (in s) to probabilities in place: mask an edge
    // tile, update m and l, return the rescale of the earlier rows' sums
    auto softmax = [&](int t0, float (&alpha)[2]) {
      if (edge_tile(t0, kKeys, a, 64, S, causal, window)) {
        // score i is key t0 + 2 tig + c, c = 8 (i / 4) + i % 2: visible
        // when c lies in [kmin - t0 - 2 tig, kmax - t0 - 2 tig]
        const int off = t0 + 2 * tig;
        const int cmin[2] = {kmin[0] - off, kmin[1] - off};
        const int cmax[2] = {kmax[0] - off, kmax[1] - off};
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const int r = (i >> 1) & 1;
          const int c = 8 * (i >> 2) + (i & 1);
          if (c < cmin[r] || c > cmax[r]) s[i] = -CUDART_INF_F;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with no visible key yet keeps -inf: scale against 0, so
        // that its masked scores give exp2(-inf) = 0 and alpha = 0
        ms[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r] * kLog2e;
        alpha[r] = exp2_fast(fmaf(m[r], kLog2e, -ms[r]));
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2_fast(fmaf(s[i], kLog2e, -ms[r]));
        l[r] += s[i];
      }
    };
    // O *= alpha per row
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };
    // P = s rounded to bf16, as the A fragments of P V (8-key columns 2kk
    // and 2kk + 1 make the 16-key step kk)
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    mbar_wait(sm.qfull, nq & 1);
    float alpha[2];
    if constexpr (kOverlap) {
      // tile 0: its scores alone
      mbar_wait(kfull(0), phase(0));
      issue_qk<HD>(s, dq, dk + stage(0) * kStageStep);
      wg::wgmma_wait<0>();
      fence_s();
      mbar_arrive(kempty(0));
      softmax(lo, alpha);  // acc is still 0: no rescale
      pack();

      // tile t's scores and tile t-1's values together; tile t's softmax
      // while P V runs; P is packed only once P V has read the last one
#pragma unroll 1
      for (int t = 1; t < ntiles; ++t) {
        mbar_wait(kfull(t), phase(t));
        mbar_wait(vfull(t - 1), phase(t - 1));
        issue_qk<HD>(s, dq, dk + stage(t) * kStageStep);
        issue_pv<HD>(acc, p, dv + stage(t - 1) * kStageStep);
        wg::wgmma_wait<1>();  // Q K^T is done
        fence_s();
        mbar_arrive(kempty(t));
        softmax(lo + t * kKeys, alpha);
        wg::wgmma_wait<0>();  // P V is done
        fence_acc();
        fence_s();
        mbar_arrive(vempty(t - 1));
        rescale(alpha);
        pack();
      }
      mbar_arrive(sm.qempty);  // every Q K^T of the item is done

      // the last tile's values
      mbar_wait(vfull(ntiles - 1), phase(ntiles - 1));
      issue_pv<HD>(acc, p, dv + stage(ntiles - 1) * kStageStep);
      wg::wgmma_wait<0>();
      fence_acc();
      mbar_arrive(vempty(ntiles - 1));
    } else {
#pragma unroll 1
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(kfull(t), phase(t));
        issue_qk<HD>(s, dq, dk + stage(t) * kStageStep);
        wg::wgmma_wait<0>();
        fence_s();
        mbar_arrive(kempty(t));
        softmax(lo + t * kKeys, alpha);
        rescale(alpha);
        pack();
        mbar_wait(vfull(t), phase(t));
        issue_pv<HD>(acc, p, dv + stage(t) * kStageStep);
        wg::wgmma_wait<0>();
        fence_acc();
        mbar_arrive(vempty(t));
      }
      mbar_arrive(sm.qempty);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qp = r0 + 8 * r;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    bf16* orow = o + w.b * os.b + static_cast<long long>(qp) * os.s +
                 w.h * os.h + 2 * tig;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
  }
}

// A persistent grid: CTA c runs item_of(0), item_of(1), ... of the
// nqb * H * B items, its producer running ahead into the
// next item's Q block and key tiles while the consumers finish one
template <int HD>
__global__ void __launch_bounds__(threads_for(HD), 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                int S, int H, int B, int g, Strides os, int causal,
                int window) {
  using P = Plan<HD>;
  constexpr int kKeys = P::kKeys;
  extern __shared__ unsigned char smem_raw[];
  const Smem<HD> sm((smem_u32(smem_raw) + kAlign - 1) &
                    ~uint32_t(kAlign - 1));
  constexpr int kConsumers = P::kConsumers;
  const int nqb = (S + P::kRows - 1) / P::kRows;
  const int items = nqb * H * B;

  if (threadIdx.x == 0) {
    mbar_init(sm.qfull, 1);
    mbar_init(sm.qempty, 128 * kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.kfull + 8 * s, 1);
      mbar_init(sm.vfull + 8 * s, 1);
      mbar_init(sm.kempty + 8 * s, 128 * kConsumers);
      mbar_init(sm.vempty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, warp-uniform for the compiler (a shuffle of
  // lane 0's value): one branch each, never rejoined, so that ptxas
  // allocates each at its own setmaxnreg count
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  int it = 0;  // key tiles this CTA has taken through its ring
  int nq = 0;  // Q blocks it has loaded
  if (wgi == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        producer_regs(HD)));
    if (threadIdx.x % 128 == 0) {
#pragma unroll 1
      for (int k = 0, wi = item_of(0); wi < items; wi = item_of(++k)) {
        const Item w(wi, nqb, H, B, S, P::kRows, kKeys, causal, window);
        if (w.ntiles == 0) continue;
        const int kvh = w.h / g;
        mbar_wait(sm.qempty, (nq & 1) ^ 1);
        mbar_expect_tx(sm.qfull, P::kQBytes);
        tma_tile<HD>(sm.q, P::kQSlab, &tq, w.q0, w.h, w.b, sm.qfull);
        ++nq;
#pragma unroll 1
        for (int t = 0; t < w.ntiles; ++t, ++it) {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          const int t0 = w.lo + t * kKeys;
          mbar_wait(sm.kempty + 8 * st, ph ^ 1);
          mbar_expect_tx(sm.kfull + 8 * st, P::kTileBytes);
          tma_tile<HD>(sm.k + st * P::kTileBytes, P::kKSlab, &tk, t0, kvh,
                       w.b, sm.kfull + 8 * st);
          mbar_wait(sm.vempty + 8 * st, ph ^ 1);
          mbar_expect_tx(sm.vfull + 8 * st, P::kTileBytes);
          tma_tile<HD>(sm.v + st * P::kTileBytes, P::kKSlab, &tv, t0, kvh,
                       w.b, sm.vfull + 8 * st);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        consumer_regs(HD)));
#pragma unroll 1
    for (int k = 0, wi = item_of(0); wi < items; wi = item_of(++k)) {
      const Item w(wi, nqb, H, B, S, P::kRows, kKeys, causal, window);
      consume<HD>(sm, w, wgi, it, nq, o, S, os, causal, window);
      it += w.ntiles;
      nq += w.ntiles > 0;
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
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
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of the 4-d tensor (head dim, S, head, batch): dims and
// box innermost first, strides in bytes of dims 1..3; the box is one
// slab's rows, and the swizzle spans one slab's row.  Columns past the
// head dim (hd 80's second slab) are zero-filled.  Returns 0 or the
// CUresult (negated).
int encode(CUtensorMap* map, const void* base, const unsigned long long* dims,
           const unsigned long long* strides, const unsigned int* box,
           int slab) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], es[4];
  for (int i = 0; i < 4; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    es[i] = 1;
  }
  for (int i = 0; i < 3; ++i) st[i] = strides[i];
  const CUtensorMapSwizzle swz =
      slab == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (slab == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), d, st, bx, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return -static_cast<int>(r);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 route: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace f32 {

// K / V tile pairs in the cp.async ring: 2 * kStages slots taking K_0, V_0,
// K_1, V_1, ... in turn (at hd 256 each as two column slices)
constexpr int kStages = 2;
constexpr int kSlots = 2 * kStages;

// threads a CTA: 256, or 128 at hd 64 and 80, where two CTAs share an SM
__host__ __device__ constexpr int threads_for(int hd) {
  return hd == 64 || hd == 80 ? 128 : 256;
}
// threads that share a query row (its column groups): 8; 4 where an eighth
// of the head dim is not whole float4s (hd 16, 80); 16 above hd 80
__host__ __device__ constexpr int colgroups_for(int hd) {
  return hd == 16 || hd == 80 ? 4 : (hd > 80 ? 16 : 8);
}
// column slices a K / V tile is copied and consumed in: 2 at hd 256, so
// that its ring holds 64-key tiles beside the Q block
__host__ __device__ constexpr int slices_for(int hd) {
  return hd > 128 ? 2 : 1;
}
// query rows a CTA and keys a K / V tile: the largest tiles of which the
// Q block, the ring and the P tile fit the shared memory of a block (of
// half an SM for a 128-thread CTA)
__host__ __device__ constexpr int rows_for(int hd) {
  return hd > 128 ? 64 : 128;
}
__host__ __device__ constexpr int keys_for(int hd) {
  return slices_for(hd) > 1 ? 64
                            : (threads_for(hd) == 128 ? 32 : (hd > 80 ? 48
                                                                      : 64));
}
// floats between two rows of the Q block and of a K / V slice (the
// columns padded by one float4), and between two keys of the P tile (the
// rows padded by 4 or 8 floats): the paddings that leave the micro-tiles'
// reads and writes free of bank conflicts (tests/test_torch_flash_f32.py)
__host__ __device__ constexpr int q_stride(int hd) { return hd + 4; }
__host__ __device__ constexpr int kv_stride(int hd) {
  return hd / slices_for(hd) + 4;
}
__host__ __device__ constexpr int p_stride(int hd) {
  return rows_for(hd) + (colgroups_for(hd) == 4 ? 8 : 4);
}
// dynamic shared memory: the Q block, kSlots K / V slices, the P tile
__host__ __device__ constexpr int smem_bytes(int hd) {
  return 4 * (rows_for(hd) * q_stride(hd) +
              kSlots * keys_for(hd) * kv_stride(hd) +
              keys_for(hd) * p_stride(hd));
}

template <int HD>
struct Plan {
  static constexpr int kThreads = threads_for(HD);
  static constexpr int kCG = colgroups_for(HD);
  static constexpr int kRG = kThreads / kCG;  // row groups
  static constexpr int kDS = slices_for(HD);
  static constexpr int kCols = HD / kDS;      // columns of a slice
  static constexpr int kRows = rows_for(HD);
  static constexpr int kKeys = keys_for(HD);
  static constexpr int kTR = kRows / kRG;     // rows a thread owns
  static constexpr int kTK = kKeys / kCG;     // keys of a tile it scores
  static constexpr int kTC = kCols / 4 / kCG; // float4s of O a slice it owns
  static constexpr int kQS = q_stride(HD);
  static constexpr int kKS = kv_stride(HD);
  static constexpr int kPS = p_stride(HD);
  static constexpr int kSlot = kKeys * kKS;   // floats of a K / V slot
  // the products' loops unrolled: float4 steps of Q K^T, keys of P V
  // (further above hd 80, where each step feeds fewer FMAs)
  static constexpr int kUnrollQK = HD > 80 ? 16 : 4;
  static constexpr int kUnrollPV = HD > 80 ? 32 : 8;
  static_assert(32 % kCG == 0, "a row's threads lie in one warp");
  static_assert(kRows % kRG == 0 && (kTR == 2 || kTR % 4 == 0),
                "rows a thread: a float2 or float4s of P");
  static_assert(kKeys % kCG == 0 && kCols % (4 * kCG) == 0,
                "keys and float4 columns split over the column groups");
  static_assert(smem_bytes(HD) <= 232448, "shared memory of a block");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  // 16 bytes, or 16 zeros where `in` is false (src is not read)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tc::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of COLS columns of rows [r0, r0 + ROWS) of one head
// (row r at base + r * stride floats) into shared memory at dst, DS floats
// a row, spread over the CTA's THREADS; rows at or past S are zero-filled
template <int COLS, int ROWS, int DS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          long long stride, int r0, int S) {
  constexpr int kChunks = COLS / 4;
  static_assert(ROWS * kChunks % THREADS == 0, "whole copies a thread");
  // where the CTA covers whole rows at a time, a thread copies the same
  // column at each step, rows THREADS / kChunks apart
  constexpr bool kSameColumn = THREADS % kChunks == 0;
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int e = i * THREADS + threadIdx.x;
    const int row = kSameColumn
                        ? i * (THREADS / kChunks) + threadIdx.x / kChunks
                        : e / kChunks;
    const int c = kSameColumn ? threadIdx.x % kChunks : e - row * kChunks;
    const bool in = r0 + row < S;
    cp_async16(dst + row * DS + 4 * c,
               base + (in ? (r0 + row) * stride : 0) + 4 * c, in);
  }
}

// One CTA a (query block, head, batch) item, heaviest blocks first.
// Thread (rg, cg) = (tid / kCG, tid % kCG) owns rows rg + kRG * i (i <
// kTR) of the block: their scores against keys cg + kCG * j (j < kTK) of
// each tile, and their output columns at float4s cg + kCG * c (c < kTC) of
// each column slice.  Per key tile t: K_t's slices land, S = Q K^T into
// registers, the online softmax (the row max across the kCG threads of a
// row by shuffles, one exp2 a score), O rescaled once, P to shared memory;
// then V_t's slices land and O += P V.  Each slice waits on its cp.async
// group and one CTA barrier, which also frees the slot of the slice before
// it for the copies of the slice kSlots - 1 ahead.
template <int HD>
__global__ void __launch_bounds__(threads_for(HD), 256 / threads_for(HD))
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int B, int g, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int window) {
  using P = Plan<HD>;
  constexpr int kThreads = P::kThreads;
  constexpr int kCG = P::kCG, kRG = P::kRG, kTR = P::kTR, kTK = P::kTK;
  constexpr int kDS = P::kDS, kCols = P::kCols, kTC = P::kTC;
  constexpr int kQS = P::kQS, kKS = P::kKS, kPS = P::kPS;
  constexpr int kRows = P::kRows, kKeys = P::kKeys;
  extern __shared__ float4 smem_f4[];
  float* const sq = reinterpret_cast<float*>(smem_f4);
  float* const skv = sq + kRows * kQS;
  float* const sp = skv + kSlots * P::kSlot;

  const int nqb = (S + kRows - 1) / kRows;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / (H * B);
  const int hb = static_cast<int>(blockIdx.x) % (H * B);
  const int h = hb % H;
  const int b = hb / H;
  const int q0 = qb * kRows;
  const int rg = threadIdx.x / kCG;
  const int cg = threadIdx.x % kCG;
  // the keys some row of this block can see: the tiles of [lo, hi)
  const int lo = window != 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(q0 + kRows, S) : S;
  const int ntiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;
  const float* qh = q + b * qs.b + h * qs.h;
  const float* kh = k + b * ks.b + (h / g) * ks.h;
  const float* vh = v + b * vs.b + (h / g) * vs.h;

  // key t0 + cg + kCG j is visible from row i when cmin[i] <= t0 + kCG j
  // <= cmax[i]
  int cmin[kTR], cmax[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int qp = q0 + rg + kRG * i;
    cmin[i] = (window != 0 ? qp - window + 1 : -(1 << 30)) - cg;
    cmax[i] = (causal ? min(qp, S - 1) : S - 1) - cg;
  }
  float4 acc[kTR][kDS * kTC];
  float m[kTR], l[kTR];  // running max (log2 units), this thread's sum
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDS * kTC; ++c)
      acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // slice u of the ring: u = (2 t + part) kDS + ds, columns [ds kCols, +
  // kCols) of K_t (part 0) or V_t (part 1), into slot u % kSlots
  constexpr int kPerTile = 2 * kDS;
  auto issue = [&](int u) {
    const int part = u / kDS & 1;
    const int col = u % kDS * kCols;
    load_rows<kCols, kKeys, kKS, kThreads>(
        skv + u % kSlots * P::kSlot, (part ? vh : kh) + col,
        part ? vs.s : ks.s, lo + u / kPerTile * kKeys, S);
  };
  // slice u has landed and every thread is done with slice u - 1, whose
  // slot takes slice u + kSlots - 1
  auto arrive = [&](int u) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();
    if (u + kSlots - 1 < kPerTile * ntiles) issue(u + kSlots - 1);
    cp_async_commit();
  };

  if (ntiles > 0) {
    // the Q block travels with the first slice in the first group
    load_rows<HD, kRows, kQS, kThreads>(sq, qh, qs.s, q0, S);
#pragma unroll
    for (int u = 0; u < kSlots - 1; ++u) {
      if (u < kPerTile * ntiles) issue(u);
      cp_async_commit();
    }
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t) {
      const int t0 = lo + t * kKeys;
      // S = Q K^T, slice by slice: each LDS.128 of Q feeds kTK float4
      // products, each of K kTR
      float s[kTR][kTK];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTK; ++j) s[i][j] = 0.f;
#pragma unroll
      for (int ds = 0; ds < kDS; ++ds) {
        const int u = kPerTile * t + ds;
        arrive(u);
        if (u == 0) {  // the Q block, once: times log2 e, for exp2
          for (int e = threadIdx.x; e < kRows * HD / 4; e += kThreads) {
            float4* p4 = reinterpret_cast<float4*>(
                sq + e / (HD / 4) * kQS + 4 * (e % (HD / 4)));
            float4 x = *p4;
            x.x *= kLog2e;
            x.y *= kLog2e;
            x.z *= kLog2e;
            x.w *= kLog2e;
            *p4 = x;
          }
          __syncthreads();
        }
        const float* kt = skv + u % kSlots * P::kSlot;
        const float* qt = sq + ds * kCols;
#pragma unroll(P::kUnrollQK)
        for (int d = 0; d < kCols / 4; ++d) {
          float4 qv[kTR], kv[kTK];
#pragma unroll
          for (int i = 0; i < kTR; ++i)
            qv[i] = *reinterpret_cast<const float4*>(
                qt + (rg + kRG * i) * kQS + 4 * d);
#pragma unroll
          for (int j = 0; j < kTK; ++j)
            kv[j] = *reinterpret_cast<const float4*>(
                kt + (cg + kCG * j) * kKS + 4 * d);
#pragma unroll
          for (int i = 0; i < kTR; ++i)
#pragma unroll
            for (int j = 0; j < kTK; ++j) {
              s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
              s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
              s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
              s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
            }
        }
      }

      // the masks, on a tile that straddles an edge of the band only
      if (tc::edge_tile(t0, kKeys, q0, kRows, S, causal, window)) {
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTK; ++j) {
            const int c = t0 + kCG * j;
            if (c < cmin[i] || c > cmax[i]) s[i][j] = -CUDART_INF_F;
          }
      }
      // the online softmax: m and mx are finite (>= kNegInf), so a masked
      // score's exp2(-inf) is 0, and a row with no key yet keeps alpha = 1,
      // l = 0 and acc = 0
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < kTK; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
        for (int off = 1; off < kCG; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float alpha = exp2f(m[i] - mx);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kTK; ++j) {
          s[i][j] = exp2f(s[i][j] - mx);
          sum += s[i][j];
        }
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int c = 0; c < kDS * kTC; ++c) {
          acc[i][c].x *= alpha;
          acc[i][c].y *= alpha;
          acc[i][c].z *= alpha;
          acc[i][c].w *= alpha;
        }
      }
      // P^T to shared memory: key cg + kCG j's row holds this thread's kTR
      // probabilities at rg * kTR
#pragma unroll
      for (int j = 0; j < kTK; ++j) {
        float* dst = sp + (cg + kCG * j) * kPS + rg * kTR;
        if constexpr (kTR == 2) {
          *reinterpret_cast<float2*>(dst) = make_float2(s[0][j], s[1][j]);
        } else {
#pragma unroll
          for (int i = 0; i < kTR; i += 4)
            *reinterpret_cast<float4*>(dst + i) =
                make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
        }
      }

      // O += P V, slice by slice: each key's LDS of P feeds kTC float4
      // products, each LDS.128 of V kTR
#pragma unroll
      for (int ds = 0; ds < kDS; ++ds) {
        const int u = kPerTile * t + kDS + ds;
        arrive(u);
        const float* vt = skv + u % kSlots * P::kSlot;
#pragma unroll(P::kUnrollPV)
        for (int n = 0; n < kKeys; ++n) {
          float p[kTR];
          if constexpr (kTR == 2) {
            const float2 x = *reinterpret_cast<const float2*>(
                sp + n * kPS + rg * 2);
            p[0] = x.x;
            p[1] = x.y;
          } else {
#pragma unroll
            for (int i = 0; i < kTR; i += 4) {
              const float4 x = *reinterpret_cast<const float4*>(
                  sp + n * kPS + rg * kTR + i);
              p[i] = x.x;
              p[i + 1] = x.y;
              p[i + 2] = x.z;
              p[i + 3] = x.w;
            }
          }
#pragma unroll
          for (int c = 0; c < kTC; ++c) {
            const float4 vv = *reinterpret_cast<const float4*>(
                vt + n * kKS + 4 * (cg + kCG * c));
#pragma unroll
            for (int i = 0; i < kTR; ++i) {
              float4& a = acc[i][ds * kTC + c];
              a.x = fmaf(p[i], vv.x, a.x);
              a.y = fmaf(p[i], vv.y, a.y);
              a.z = fmaf(p[i], vv.z, a.z);
              a.w = fmaf(p[i], vv.w, a.w);
            }
          }
        }
      }
    }
  }

  // the row sums across the row's threads; a row with no visible key
  // divides 0 by 1e-30: exactly 0
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < kCG; off <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int qp = q0 + rg + kRG * i;
    if (qp >= S) continue;
    const float den = fmaxf(sum, 1e-30f);
    float* orow = o + b * os.b + static_cast<long long>(qp) * os.s + h * os.h;
#pragma unroll
    for (int ds = 0; ds < kDS; ++ds)
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const float4 a = acc[i][ds * kTC + c];
        *reinterpret_cast<float4*>(orow + ds * kCols + 4 * (cg + kCG * c)) =
            make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
      }
  }
}

}  // namespace f32

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int g, Strides qs, Strides ks,
                       Strides vs, Strides os, int causal, int window,
                       cudaStream_t stream) {
  constexpr int smem = f32::smem_bytes(HD);
  const cudaError_t err = cudaFuncSetAttribute(
      f32::flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long items =
      static_cast<long long>((S + f32::rows_for(HD) - 1) / f32::rows_for(HD)) *
      H * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  f32::flash_f32_kernel<HD>
      <<<static_cast<unsigned>(items), f32::threads_for(HD), smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), S, H, B, g,
          qs, ks, vs, os, causal, window);
  return cudaGetLastError();
}

// the CTAs of the persistent grid: one per SM (the kernel's shared memory
// and registers hold one), or one per item where there are fewer
int persistent_ctas(int items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return items < sms ? items : sms;
}

template <int HD>
cudaError_t launch_tc(const CUtensorMap* maps, void* o, int B, int S, int H,
                      int g, Strides os, int causal, int window,
                      cudaStream_t stream) {
  constexpr int smem = tc::smem_bytes(HD);
  const cudaError_t err = cudaFuncSetAttribute(
      tc::flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int nqb = (S + tc::rows_for(HD) - 1) / tc::rows_for(HD);
  tc::flash_tc_kernel<HD>
      <<<persistent_ctas(nqb * H * B), tc::threads_for(HD), smem, stream>>>(
          maps[0], maps[1], maps[2], static_cast<tc::bf16*>(o), S, H, B, g,
          os, causal, window);
  return cudaGetLastError();
}

using LaunchF32 = cudaError_t (*)(const void*, const void*, const void*,
                                  void*, int, int, int, int, Strides, Strides,
                                  Strides, Strides, int, int, cudaStream_t);
using LaunchTC = cudaError_t (*)(const CUtensorMap*, void*, int, int, int,
                                 int, Strides, int, int, cudaStream_t);

#define REPRO_FLASH_HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(128) X(256)

LaunchF32 launcher_f32(int hd) {
  switch (hd) {
#define CASE(D) \
  case D:       \
    return launch_f32<D>;
    REPRO_FLASH_HEAD_DIMS(CASE)
#undef CASE
    default:
      return nullptr;
  }
}

LaunchTC launcher_tc(int hd) {
  switch (hd) {
#define CASE(D) \
  case D:       \
    return launch_tc<D>;
    REPRO_FLASH_HEAD_DIMS(CASE)
#undef CASE
    default:
      return nullptr;
  }
}

bool shapes_ok(int B, int S, int H, int KV) {
  return B > 0 && S > 0 && H > 0 && KV > 0 && H % KV == 0 && H <= 65535 &&
         B <= 65535;
}

// cp.async's rule for the fp32 kernel: a 16-byte aligned base, and rows 16
// bytes apart on every axis it steps (one of a single entry is never stepped)
bool rows_aligned(const void* p, const Strides& s, int B, int S, int heads) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (B == 1 || s.b % 4 == 0) && (S == 1 || s.s % 4 == 0) &&
         (heads == 1 || s.h % 4 == 0);
}

}  // namespace

// Dynamic shared memory of the bf16 kernel at head dim hd, in bytes (0 for
// a head dim it is not instantiated for).
extern "C" int repro_flash_tc_smem_bytes(int hd) {
  switch (hd) {
#define CASE(D) \
  case D:       \
    return tc::smem_bytes(D);
    REPRO_FLASH_HEAD_DIMS(CASE)
#undef CASE
    default:
      return 0;
  }
}

// The bf16 kernel's tiles at head dim hd: out[0..3] = query rows, keys per
// tile, ring stages, head-dim slab.  Returns 0, or -1 for a head dim it is
// not instantiated for.
extern "C" int repro_flash_tc_plan(int hd, int* out) {
  if (repro_flash_tc_smem_bytes(hd) == 0) return -1;
  out[0] = tc::rows_for(hd);
  out[1] = tc::keys_for(hd);
  out[2] = tc::kStages;
  out[3] = tc::slab_for(hd);
  return 0;
}

// Dynamic shared memory of the fp32 kernel at head dim hd, in bytes (0 for
// a head dim it is not instantiated for).
extern "C" int repro_flash_f32_smem_bytes(int hd) {
  switch (hd) {
#define CASE(D) \
  case D:       \
    return f32::smem_bytes(D);
    REPRO_FLASH_HEAD_DIMS(CASE)
#undef CASE
    default:
      return 0;
  }
}

// The fp32 kernel's tiles at head dim hd: out[0..5] = query rows, keys per
// tile, ring stages (K / V tile pairs), threads a CTA, threads a query row,
// column slices a K / V tile.
// Returns 0, or -1 for a head dim it is not instantiated for.
extern "C" int repro_flash_f32_plan(int hd, int* out) {
  if (repro_flash_f32_smem_bytes(hd) == 0) return -1;
  out[0] = f32::rows_for(hd);
  out[1] = f32::keys_for(hd);
  out[2] = f32::kStages;
  out[3] = f32::threads_for(hd);
  out[4] = f32::colgroups_for(hd);
  out[5] = f32::slices_for(hd);
  return 0;
}

// fp32: q, o (B, S, H, hd); k, v (B, S, KV, hd); the last axis contiguous,
// the others at the given element strides (batch, sequence, head), every
// base 16-byte aligned and every stride of an axis longer than 1 a
// multiple of 4 (the wrapper copies a view that is not).  Launches the
// CUDA-core kernel on `stream`, does not synchronise; returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_flash_attention_f32(
    int hd, const void* q, const void* k, const void* v, void* o, int B,
    int S, int H, int KV, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int causal,
    int window, void* stream) {
  const LaunchF32 fn = launcher_f32(hd);
  if (!shapes_ok(B, S, H, KV) || fn == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  if (!rows_aligned(q, qs, B, S, H) || !rows_aligned(k, ks, B, S, KV) ||
      !rows_aligned(v, vs, B, S, KV) || !rows_aligned(o, os, B, S, H))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(q, k, v, o, B, S, H, H / KV, qs, ks, vs, os,
                             causal, window,
                             static_cast<cudaStream_t>(stream)));
}

// bf16: q, k, v as TMA tensor maps (head dim, S, head, batch), as the
// wrapper computes them (kernels/flash_attention.py tma_params): dims[3][4]
// and box[3][4] innermost first, strides[3][3] in bytes of dims 1..3, for
// q, k, v in turn.  The box must be the kernel's plan (slab, rows or keys,
// 1, 1).  o (B, S, H, hd) at element strides osb, oss, osh.  Launches the
// tensor-core kernel on `stream`, does not synchronise; returns the
// launch's cudaError_t (0 on success), or a failed encode's CUresult
// negated.
extern "C" int repro_flash_attention_tc(
    int hd, const void* q, const void* k, const void* v, void* o, int B,
    int S, int H, int KV, const unsigned long long* dims,
    const unsigned long long* strides, const unsigned int* box, long long osb,
    long long oss, long long osh, int causal, int window, void* stream) {
  const LaunchTC fn = launcher_tc(hd);
  if (!shapes_ok(B, S, H, KV) || fn == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slab = tc::slab_for(hd);
  const void* base[3] = {q, k, v};
  const int heads[3] = {H, KV, KV};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const unsigned long long* d = dims + 4 * i;
    const unsigned int* bx = box + 4 * i;
    const int rows = i == 0 ? tc::rows_for(hd) : tc::keys_for(hd);
    if (d[0] != static_cast<unsigned long long>(hd) ||
        d[1] != static_cast<unsigned long long>(S) ||
        d[2] != static_cast<unsigned long long>(heads[i]) ||
        d[3] != static_cast<unsigned long long>(B) ||
        bx[0] != static_cast<unsigned>(slab) ||
        bx[1] != static_cast<unsigned>(rows) || bx[2] != 1 || bx[3] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = tc::encode(&maps[i], base[i], d, strides + 3 * i, bx,
                               slab);
    if (err != 0) return err;
  }
  const Strides os{osb, oss, osh};
  return static_cast<int>(fn(maps, o, B, S, H, H / KV, os, causal, window,
                             static_cast<cudaStream_t>(stream)));
}
