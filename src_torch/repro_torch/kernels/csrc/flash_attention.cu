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
//   - fp32: flash_fwd_kernel, on the fp32 CUDA cores.  No bf16 or TF32
//     product holds the fp32 tolerance (2e-5), so fp32 stays there.
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
// fp32 design (flash_fwd_kernel, unchanged since it was the only route):
// one CTA of 256 threads per (q block, q head, batch).  kLanes threads own a
// query row (4 up to head dim 128, so a q block is 64 rows; 8 at head dim
// 256, 32 rows): each keeps its share of q (pre-multiplied by log2 e, so the
// softmax uses exp2) and of the fp32 output accumulator in registers, in
// float4 chunks interleaved across the lanes (lane l owns chunks l,
// l + kLanes, ...), so a row's lanes read consecutive 16-byte chunks of
// shared memory and no bank conflicts arise at any head dim.  K and V tiles
// (32 keys; 16 at head dim 256, so the two tiles stay within the 48 KB of
// static shared memory) are staged through shared memory as fp32.  A score
// is kLanes partial dot products summed by xor shuffles (two, or three at
// 8 lanes), identical in the row's lanes, which then each run the same
// online-softmax update (running max m, sum l) on 8 keys at a time and fold
// p * v into their share of the accumulator.  Every thread of a CTA runs
// the same trip counts, so the shuffles never diverge.  It cannot beat the
// fp32 cores' 67 TFLOP/s (6.1 ms at danube's shape).
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
// fp32 route: the CUDA-core kernel
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;             // threads per CTA
constexpr int kSub = 8;                   // keys scored at once

// threads per query row, and keys per shared-memory tile, at head dim HD
__host__ __device__ constexpr int lanes_for(int hd) { return hd > 128 ? 8 : 4; }
__host__ __device__ constexpr int keys_for(int hd) { return hd > 128 ? 16 : 32; }
// query rows per CTA
__host__ __device__ constexpr int rows_for(int hd) {
  return kThreads / lanes_for(hd);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int g, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window) {
  constexpr int kLanes = lanes_for(HD);
  constexpr int kKeys = keys_for(HD);
  constexpr int kRows = rows_for(HD);
  static_assert(HD % (4 * kLanes) == 0, "head dim must split into float4s");
  static_assert(kKeys % kSub == 0, "tile must split into sub-chunks");
  constexpr int kChunks = HD / 4;          // float4 chunks in a row
  constexpr int kMine = kChunks / kLanes;  // chunks a thread owns
  __shared__ float4 k_tile[kKeys][kChunks];
  __shared__ float4 v_tile[kKeys][kChunks];

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / g;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = qb * kRows;
  const int qpos = q0 + row;

  const float* qrow = q + b * qs.b
                      + static_cast<long long>(min(qpos, S - 1)) * qs.s
                      + h * qs.h;
  float4 qr[kMine];
  float4 acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int d = 4 * (i * kLanes + lane);
    qr[i] = make_float4(qrow[d] * kLog2e, qrow[d + 1] * kLog2e,
                        qrow[d + 2] * kLog2e, qrow[d + 3] * kLog2e);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;  // running max, in log2 units
  float l = 0.f;      // running sum of exp2(s - m)

  // the keys some row of this block can see: [lo, hi)
  const int q1 = min(q0 + kRows, S);
  const int lo = window != 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? q1 : S;

  const float* kbase = k + b * ks.b + kvh * ks.h;
  const float* vbase = v + b * vs.b + kvh * vs.h;
  float* k_flat = reinterpret_cast<float*>(&k_tile[0][0]);
  float* v_flat = reinterpret_cast<float*>(&v_tile[0][0]);

  for (int t0 = lo; t0 < hi; t0 += kKeys) {
    const int nk = min(kKeys, hi - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kKeys * HD; e += kThreads) {
      const int j = e / HD;
      const int d = e - j * HD;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const long long kp = t0 + j;
        kv = kbase[kp * ks.s + d];
        vv = vbase[kp * vs.s + d];
      }
      k_flat[e] = kv;
      v_flat[e] = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += kSub) {
      float s[kSub];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = j0 + jj;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const float4 kk = k_tile[j][i * kLanes + lane];
          part = fmaf(qr[i].x, kk.x, part);
          part = fmaf(qr[i].y, kk.y, part);
          part = fmaf(qr[i].z, kk.z, part);
          part = fmaf(qr[i].w, kk.w, part);
        }
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const int kp = t0 + j;
        const bool ok = j < nk && (!causal || kp <= qpos) &&
                        (window == 0 || kp > qpos - window);
        s[jj] = ok ? part : -CUDART_INF_F;
        mx = fmaxf(mx, s[jj]);
      }
      // mx and m are finite (>= kNegInf): a masked key's exp2(-inf) is 0,
      // and a row with no key yet keeps alpha = 1, l = 0 and acc = 0
      const float alpha = exp2f(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float p = exp2f(s[jj] - mx);
        l += p;
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const float4 vv = v_tile[j0 + jj][i * kLanes + lane];
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
      m = mx;
    }
  }

  if (qpos >= S) return;
  const float den = fmaxf(l, 1e-30f);
  float* orow = o + b * os.b + static_cast<long long>(qpos) * os.s + h * os.h;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int d = 4 * (i * kLanes + lane);
    orow[d] = acc[i].x / den;
    orow[d + 1] = acc[i].y / den;
    orow[d + 2] = acc[i].z / den;
    orow[d + 3] = acc[i].w / den;
  }
}

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

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int g, Strides qs, Strides ks,
                       Strides vs, Strides os, int causal, int window,
                       cudaStream_t stream) {
  constexpr int kRows = rows_for(HD);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, g, qs, ks, vs,
      os, causal, window);
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

// fp32: q, o (B, S, H, hd); k, v (B, S, KV, hd); the last axis contiguous,
// the others at the given element strides (batch, sequence, head).
// Launches the CUDA-core kernel on `stream`, does not synchronise; returns
// the launch's cudaError_t (0 on success).
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
