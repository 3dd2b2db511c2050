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
// GFLOP, 0.26 ms on the tensor cores.
//
// bf16 design (flash_tc_kernel, FlashAttention-2's shape on mma.sync): one
// CTA of 4 warps per (q block, q head, batch), each warp owning two m16
// tiles of query rows up to head dim 80 (a q block of 128 rows) and one
// above (64 rows, as registers run out): the K and V fragments one ldmatrix
// brings feed both tiles, which halves the shared-memory reads per product
// (13% faster at danube's shape on the H100; no change at head dim 64).
// S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products with fp32
// accumulation.  Q and double-buffered K and V tiles (64 keys; 32 at head
// dim 256, so that two CTAs fit an SM) are staged in bf16 by
// cp.async into dynamic shared memory, rows padded by 16 bytes so that the 8
// row addresses of every ldmatrix phase fall in distinct banks at every head
// dim (a row of hd 80 is 160 bytes: unpadded, rows 4 apart would collide).
// The next tile's copies are in flight while the current one is multiplied;
// one __syncthreads per tile.  Q fragments are loaded once by ldmatrix and
// stay in registers (up to head dim 128; at 256 they would leave no room for
// the 128 accumulator registers, so they are re-read from shared memory for
// each tile).  K fragments come from ldmatrix, V fragments from
// ldmatrix.trans.  The online softmax runs on the S fragments in registers:
// scores scaled once by log2 e, row max and sum by quad shuffles, each
// score's exp2 computed once by the one thread that holds it.  P is rounded
// to bf16 in registers and used directly as the A operand of P V (the m16n8
// accumulator layout of two adjacent n-tiles is the m16n8k16 A layout), the
// only rounding the twin does not have.  The row sum l is kept per thread
// and summed across the quad once, at the end.  Masks are evaluated only on
// the tiles that straddle an edge of the band (causal diagonal, window edge,
// end of the sequence).  Head dims 16, 32, 64, 80, 128 and 256 are
// instantiated.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// the reference's NEG_INF, -0.7 * float32 max: the running max before any key
constexpr float kNegInf = -0.7f * 3.402823466e38f;

enum DType { kF32 = 0, kBF16 = 1 };

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

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// m16 tiles of query rows per warp (2 up to head dim 80, else 1), and the
// query rows of a CTA
__host__ __device__ constexpr int mtiles_for(int hd) {
  return hd <= 80 ? 2 : 1;
}
__host__ __device__ constexpr int rows_for(int hd) {
  return 16 * kWarps * mtiles_for(hd);
}

// keys per K / V tile, and the shared-memory row stride in elements (16
// bytes of padding: ldmatrix's 8 rows land in distinct banks)
__host__ __device__ constexpr int keys_for(int hd) {
  return hd > 128 ? 32 : 64;
}
__host__ __device__ constexpr int ld_for(int hd) { return hd + 8; }
// Q fragments kept in registers for the whole key loop
__host__ __device__ constexpr bool q_in_regs(int hd) { return hd <= 128; }
// dynamic shared memory: the Q block and two stages of K and V tiles
__host__ __device__ constexpr int smem_bytes(int hd) {
  return (rows_for(hd) + 2 * 2 * keys_for(hd)) * ld_for(hd) *
         static_cast<int>(sizeof(bf16));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16x2 register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + NROWS) of one head of a (S, ...) tensor at `base` (row
// stride `stride` elements) into shared rows of ld_for(HD) elements, by
// 16-byte cp.async; rows at or past S are zero-filled
template <int HD, int NROWS>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* base,
                                          long long stride, int r0, int S,
                                          int tid) {
  constexpr int kChunks = HD / 8;
  constexpr int kLd = ld_for(HD);
#pragma unroll 4
  for (int e = tid; e < NROWS * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    const int row = r0 + r;
    const bool ok = row < S;
    cp_async16(smem_u32(sm + r * kLd + c * 8),
               base + static_cast<long long>(ok ? row : 0) * stride + c * 8,
               ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                int g, Strides qs, Strides ks, Strides vs, Strides os,
                int causal, int window) {
  constexpr int kKeys = keys_for(HD);
  constexpr int kLd = ld_for(HD);
  constexpr int kMT = mtiles_for(HD);
  constexpr int kRows = rows_for(HD);
  constexpr int kQc = HD / 16;     // k-chunks of Q K^T
  constexpr int kSn = kKeys / 8;   // n-tiles of S
  constexpr int kOn = HD / 8;      // n-tiles of O
  constexpr int kPc = kKeys / 16;  // k-chunks of P V
  constexpr bool kQRegs = q_in_regs(HD);
  static_assert(HD % 16 == 0 && kOn % 2 == 0 && kSn % 2 == 0,
                "head dim and tile must split into mma tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kLd]
  bf16* sk = sq + kRows * kLd;                   // [2][kKeys][kLd]
  bf16* sv = sk + 2 * kKeys * kLd;               // [2][kKeys][kLd]

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / g;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // the fragment row (and row + 8) of this lane
  const int tig = lane & 3;   // its column pair in a fragment
  const int q0 = qb * kRows;
  const int qr0 = q0 + 16 * kMT * warp + gid;  // + 16 * mt + 8 * r

  // the keys some row of this block can see: [lo, hi)
  const int lo = window != 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(q0 + kRows, S) : S;
  const int ntiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;

  const bf16* qbase = q + b * qs.b + h * qs.h;
  const bf16* kbase = k + b * ks.b + kvh * ks.h;
  const bf16* vbase = v + b * vs.b + kvh * vs.h;

  // each lane's ldmatrix row address: Q as the A operand (rows 0-7 / 8-15
  // of an m16 tile, columns 0-7 / 8-15 of a k-chunk); K as the B operand
  // of two adjacent n-tiles (keys 0-7 / 8-15, dims 0-7 / 8-15); V, through
  // .trans, as the B operand of two adjacent n-tiles (keys 0-7 / 8-15 of a
  // k-chunk, dims 0-7 / 8-15)
  const int r8 = lane & 7;
  const uint32_t sq_lane = smem_u32(
      sq + (16 * kMT * warp + r8 + 8 * ((lane >> 3) & 1)) * kLd +
      8 * (lane >> 4));
  const uint32_t sk_lane =
      smem_u32(sk + (r8 + 8 * (lane >> 4)) * kLd + 8 * ((lane >> 3) & 1));
  const uint32_t sv_lane =
      smem_u32(sv + (r8 + 8 * ((lane >> 3) & 1)) * kLd + 8 * (lane >> 4));
  constexpr uint32_t kStage = kKeys * kLd * sizeof(bf16);  // bytes
  constexpr uint32_t kMStep = 16 * kLd * sizeof(bf16);  // one m-tile of Q

  float acc[kMT][kOn][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int n = 0; n < kOn; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  // per m-tile: running max of rows gid, gid + 8, and this lane's share of
  // their row sums
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }
  uint32_t qf[kMT][kQRegs ? kQc : 1][4];

  if (ntiles > 0) {
    load_rows<HD, kRows>(sq, qbase, qs.s, q0, S, tid);
    load_rows<HD, kKeys>(sk, kbase, ks.s, lo, S, tid);
    load_rows<HD, kKeys>(sv, vbase, vs.s, lo, S, tid);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    const int t0 = lo + t * kKeys;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with t - 1
    if (t + 1 < ntiles) {
      load_rows<HD, kKeys>(sk + (st ^ 1) * kKeys * kLd, kbase, ks.s,
                           t0 + kKeys, S, tid);
      load_rows<HD, kKeys>(sv + (st ^ 1) * kKeys * kLd, vbase, vs.s,
                           t0 + kKeys, S, tid);
      cp_async_commit();
    }
    if constexpr (kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int kc = 0; kc < kQc; ++kc)
            ldsm_x4(qf[mt][kc], sq_lane + mt * kMStep + kc * 32);
      }
    }

    // S = Q K^T (each m-tile's 16 rows x kKeys keys); one ldmatrix of K
    // feeds every m-tile
    float s[kMT][kSn][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kSn; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kQc; ++kc) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if constexpr (kQRegs) {
          a[mt][0] = qf[mt][kc][0];
          a[mt][1] = qf[mt][kc][1];
          a[mt][2] = qf[mt][kc][2];
          a[mt][3] = qf[mt][kc][3];
        } else {
          ldsm_x4(a[mt], sq_lane + mt * kMStep + kc * 32);
        }
      }
#pragma unroll
      for (int j = 0; j < kSn; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, sk_lane + st * kStage + (8 * j * kLd + 16 * kc) * 2);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][j], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][j + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // scale to log2 units; mask only a tile that straddles an edge of the
    // band: the causal diagonal, the window's lower edge, the sequence end
    const bool edge = (causal && t0 + kKeys - 1 > q0) ||
                      (window != 0 && t0 <= q0 + kRows - 1 - window) ||
                      t0 + kKeys > S;
    uint32_t pa[kMT][kPc][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int j = 0; j < kSn; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e] * kLog2e;
          if (edge) {
            const int qp = qr0 + 16 * mt + 8 * (e >> 1);
            const int kp = t0 + 8 * j + 2 * tig + (e & 1);
            const bool ok = kp < S && (!causal || kp <= qp) &&
                            (window == 0 || kp > qp - window);
            x = ok ? x : -CUDART_INF_F;
          }
          s[mt][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // finite (>= kNegInf): masked scores give exp2(-inf) = 0, and a row
        // with no key yet keeps alpha = 1, l = 0 and acc = 0
        alpha[r] = exp2f(m[mt][r] - mx[r]);
        m[mt][r] = mx[r];
        l[mt][r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kOn; ++n) {
        acc[mt][n][0] *= alpha[0];
        acc[mt][n][1] *= alpha[0];
        acc[mt][n][2] *= alpha[1];
        acc[mt][n][3] *= alpha[1];
      }
      // P = exp2(S - m): summed in fp32 into l, rounded to bf16 as the A
      // fragments of P V (n-tiles 2kk and 2kk + 1 make k-chunk kk)
#pragma unroll
      for (int j = 0; j < kSn; ++j) {
        const float p0 = exp2f(s[mt][j][0] - mx[0]);
        const float p1 = exp2f(s[mt][j][1] - mx[0]);
        const float p2 = exp2f(s[mt][j][2] - mx[1]);
        const float p3 = exp2f(s[mt][j][3] - mx[1]);
        l[mt][0] += p0 + p1;
        l[mt][1] += p2 + p3;
        pa[mt][j >> 1][2 * (j & 1)] = pack_bf16(p0, p1);
        pa[mt][j >> 1][2 * (j & 1) + 1] = pack_bf16(p2, p3);
      }
    }
    // O += P V; one ldmatrix.trans of V feeds every m-tile
#pragma unroll
    for (int kk = 0; kk < kPc; ++kk) {
#pragma unroll
      for (int n = 0; n < kOn; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, sv_lane + st * kStage + (16 * kk * kLd + 8 * n) * 2);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][n], pa[mt][kk], bv[0], bv[1]);
          mma_bf16(acc[mt][n + 1], pa[mt][kk], bv[2], bv[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int qp = qr0 + 16 * mt + 8 * r;
      if (qp >= S) continue;
      const float den = fmaxf(lr, 1e-30f);
      bf16* orow = o + b * os.b + static_cast<long long>(qp) * os.s +
                   h * os.h + 2 * tig;
#pragma unroll
      for (int n = 0; n < kOn; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(acc[mt][n][2 * r] / den,
                                  acc[mt][n][2 * r + 1] / den);
    }
  }
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

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int g, Strides qs, Strides ks,
                      Strides vs, Strides os, int causal, int window,
                      cudaStream_t stream) {
  constexpr int smem = tc::smem_bytes(HD);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc::flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int rows = tc::rows_for(HD);
  const dim3 grid((S + rows - 1) / rows, H, B);
  tc::flash_tc_kernel<HD><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), S, g, qs,
      ks, vs, os, causal, window);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                               int, int, int, int, Strides, Strides, Strides,
                               Strides, int, int, cudaStream_t);

template <int HD>
Launch pick(int dtype) {
  return dtype == kBF16 ? static_cast<Launch>(launch_tc<HD>)
                        : static_cast<Launch>(launch_f32<HD>);
}

// the launcher of (dtype, head dim), or null
Launch launcher(int dtype, int hd) {
  switch (hd) {
    case 16:
      return pick<16>(dtype);
    case 32:
      return pick<32>(dtype);
    case 64:
      return pick<64>(dtype);
    case 80:
      return pick<80>(dtype);
    case 128:
      return pick<128>(dtype);
    case 256:
      return pick<256>(dtype);
    default:
      return nullptr;
  }
}

}  // namespace

// Dynamic shared memory of the bf16 kernel at head dim hd, in bytes (0 for
// a head dim it is not instantiated for).
extern "C" int repro_flash_tc_smem_bytes(int hd) {
  switch (hd) {
    case 16:
      return tc::smem_bytes(16);
    case 32:
      return tc::smem_bytes(32);
    case 64:
      return tc::smem_bytes(64);
    case 80:
      return tc::smem_bytes(80);
    case 128:
      return tc::smem_bytes(128);
    case 256:
      return tc::smem_bytes(256);
    default:
      return 0;
  }
}

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); the last axis contiguous, the
// others at the given element strides (batch, sequence, head).  dtype: 0
// fp32 (the CUDA-core kernel), 1 bf16 (the tensor-core kernel, which also
// needs 16-byte aligned rows: pointers at 16 bytes, strides multiples of 8).
// Launches on `stream`, does not synchronise; returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_flash_attention(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    int B, int S, int H, int KV, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int causal,
    int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H > 65535 ||
      B > 65535 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch fn = launcher(dtype, hd);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  return static_cast<int>(fn(q, k, v, o, B, S, H, H / KV, qs, ks, vs, os,
                             causal, window,
                             static_cast<cudaStream_t>(stream)));
}
