// gram: the (C, C) fp64 Gram matrix of the decoded (C, N) client stack,
// centred on row 0 -- Krum's distance kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/agg_reduce.py:339 (gram,
// pallas_call at :358, body _gram_kernel :319): per column block,
// t = decode(x) (+ base) - decode(x[0]) (+ base), G += t @ t.T.  The host
// expands ||a-b||^2 = G_aa + G_bb - 2 G_ab and clamps at 0, as the reference
// does.  Centring is elementwise per column (__dsub_rn of row 0's decoded
// value), so it is the same whatever the blocking.
//
// Contract: a tolerance, not bitwise -- the reference's own product is a
// hardware-ordered MXU/dgemm reduction.  The products run on the fp64
// tensor cores (mma.sync m8n8k4 f64, "DMMA"; the library's -fmad=false does
// not touch it).  It IS deterministic: the same input gives the same bits
// on every run and on any H100, because the split of the columns over warps
// and CTAs is a function of (C, N) alone, every sum has a fixed order and
// no atomics are used.  Krum's selection, and native == FLARE, depend on
// that.
//
// What bounds it: at the benchmark's geometry (C = 16, fp32), HBM bytes:
// the stack is read once, C*N*itemsize (+ scales, base), and the
// C(C+1)/2 products per column are 2 flops each, 272 flops against 64
// bytes = 4.25 flops per byte, under the fp64 tensor cores' ridge (67
// TFLOP/s / 3.35 TB/s = 20 flops per byte).  The kernel before this one
// ran at a sixth of that bound: 136 of its 256 threads did one CUDA-core
// FMA per column each, reading both operands from shared memory (139 KB of
// shared-memory reads per 4 KB tile from HBM), its scalar loads decoded
// row 0 again for every row, and a single buffer made the loads and the
// products take turns.
//
// Design, C <= 64 (gram_dmma_kernel, one template per RB = 8-row blocks,
// 1, 2, 4 or 8): a fixed grid of min(stages, 528 / 264 / 132 by RB) CTAs,
// stage s of W columns going to CTA s mod grid; each CTA streams its
// stages of raw payload (C rows x W columns, W*C*itemsize near 16 KB, 32
// KB past 16 clients) through a ring of three shared-memory stages filled
// by 16-byte cp.async (stage.cuh: ragged row starts handled by per-row
// offsets), so two stages' copies run while one is multiplied.  The CTA's
// 8 warps split a stage's columns, W/8 each, and step through them 4 at a
// time.  For m8n8k4 the row-major A fragment of rows [8i, 8i+8) and the
// col-major B fragment of the same rows are the same register: lane l
// holds t[8i + l/4][k0 + l%4].  So each lane decodes its column's row-0
// value once (base added), decodes and centres its RB rows (rows >= C and
// columns >= N are 0) straight from shared memory into the RB fragments,
// and the warp issues one DMMA per tile (i <= j) of the upper triangle of
// 8 x 8 tiles: RB(RB+1)/2 of them, 3 at C = 16, 36 at C = 64 (72 fp64
// accumulators a lane; at RB = 8 ptxas spills some, and that instance
// still beats splitting the tiles over groups of warps, which decodes
// each column once per group).  The int8 scales of a lane's rows are
// reloaded only when its column crosses a qchunk boundary; the base is
// read through L1.  At the end the warps' accumulators are summed in warp
// order in shared memory and the CTA writes its partial (C(C+1)/2 pairs).
//
// Design, C > 64 (gram_pair_kernel): the (C, C) output is tiled into
// blocks of 64 x 64 clients, and only the block pairs (ia, ib) with ia <=
// ib are computed (npb of them).  A CTA per (block pair, column block)
// (ncb column blocks, a function of C and N alone, capped so that the
// partial scratch stays within 256 MB) decodes and centres its pair's two
// row blocks of a 64-column tile into fp64 shared memory (one block on the
// diagonal), then warp w multiplies its 8 rows of block ia by the 8 row
// tiles of block ib on the same DMMA (8 tiles, 16 k-steps a tile).  It
// still rereads each client block once per block pair.
//
// Pass 2, gram_reduce_kernel (both paths), sums the CTAs' partials over
// column blocks 0, 1, 2, ... in that order, one thread per client pair, and
// writes G[a][b] and G[b][a].
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "decode.cuh"
#include "stage.cuh"

namespace {

using repro::decode;
using repro::decode_at;
using repro::kBF16;
using repro::kF16;
using repro::kF32;
using repro::kF64;
using repro::kInt8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // columns per shared-memory tile (C > 64)
constexpr int kLd = kTile + 4;   // its row stride in doubles: a DMMA
                                 // fragment's 8 rows x 4 columns hit 32
                                 // distinct banks per half-warp
constexpr int kBlk = 64;         // clients per row block
constexpr int kPairs = kBlk * kBlk;  // partial slots per block pair
constexpr int64_t kMaxColBlocks = 1024;
constexpr int64_t kScratchMax = int64_t(256) << 20;  // partial bytes
// C <= 64: the CTAs, a function of C alone (so the split of the columns
// does not depend on the card): as many as an H100 SXM's 132 SMs hold at
// once at each RB's registers -- 4, 2 and 1 per SM at RB <= 2, 4 and 8
int64_t dmma_grid(int64_t C) { return C <= 16 ? 528 : C <= 32 ? 264 : 132; }
// the payload bytes a stage aims at: 16 KB where four CTAs share an SM,
// 32 KB where fewer do
int stage_target(int64_t C) { return C <= 16 ? 16384 : 32768; }

// D += A * B on the fp64 tensor cores: an 8 x 8 tile, 4 columns deep; a
// and b are this lane's fragments, d its two accumulators
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// pair p of the row-major upper triangle (a <= b) of an n x n matrix
__host__ __device__ __forceinline__ void pair_of(int64_t p, int64_t n,
                                                 int64_t* a, int64_t* b) {
  int64_t r = 0;
  while (p >= n - r) {
    p -= n - r;
    ++r;
  }
  *a = r;
  *b = r + p;
}

// the inverse: the index of (a, b), a <= b, in that triangle
__device__ __forceinline__ int tri_index(int a, int b, int n) {
  return a * n - a * (a - 1) / 2 + (b - a);
}

// the row blocks (ia, ib) of block pair `pb`, their client counts and the
// number of client pairs they hold
struct BlockPair {
  int ia, ib, na, nb, npairs;
  bool diag;
};

__host__ __device__ __forceinline__ BlockPair block_pair(int64_t pb, int C) {
  const int64_t nblk = (C + kBlk - 1) / kBlk;
  int64_t ia, ib;
  pair_of(pb, nblk, &ia, &ib);
  BlockPair bp;
  bp.ia = static_cast<int>(ia);
  bp.ib = static_cast<int>(ib);
  bp.na = C - bp.ia * kBlk < kBlk ? C - bp.ia * kBlk : kBlk;
  bp.nb = C - bp.ib * kBlk < kBlk ? C - bp.ib * kBlk : kBlk;
  bp.diag = ia == ib;
  bp.npairs = bp.diag ? bp.na * (bp.na + 1) / 2 : bp.na * bp.nb;
  return bp;
}

// client pair p of a block pair, as row indices within its two blocks
__device__ __forceinline__ void pair_in(int p, const BlockPair& bp, int* a,
                                        int* b) {
  if (bp.diag) {
    int64_t x, y;
    pair_of(p, bp.na, &x, &y);
    *a = static_cast<int>(x);
    *b = static_cast<int>(y);
  } else {
    *a = p / bp.nb;
    *b = p - *a * bp.nb;
  }
}

// pass 1's geometry, a function of (C, N, itemsize) alone
struct Plan {
  int64_t npb;  // block pairs
  int64_t ncb;  // column blocks (CTAs per block pair)
  int W;        // C <= 64: columns per stage
};

int dmma_width(int64_t C, int isz) {
  int W = 64;
  while (W < 1024 && 2 * W * C * isz <= stage_target(C)) W *= 2;
  return W;
}

Plan plan(int64_t C, int64_t N, int isz) {
  Plan p;
  if (C <= kBlk) {
    p.npb = 1;
    p.W = dmma_width(C, isz);
    p.ncb = std::min<int64_t>((N + p.W - 1) / p.W, dmma_grid(C));
    return p;
  }
  const int64_t nblk = (C + kBlk - 1) / kBlk;
  const int64_t tiles = (N + kTile - 1) / kTile;
  p.npb = nblk * (nblk + 1) / 2;
  p.W = kTile;
  p.ncb = std::max<int64_t>(
      1, std::min({tiles, kMaxColBlocks,
                   kScratchMax / (p.npb * kPairs * int64_t(sizeof(double)))}));
  return p;
}

int item_size(int kind) {
  return kind == kInt8 ? 1 : kind == kF16 || kind == kBF16 ? 2
                         : kind == kF32                  ? 4
                                                         : 8;
}

template <int KIND, int RB>
__global__ void __launch_bounds__(kThreads)
    gram_dmma_kernel(const char* __restrict__ data, const char* end,
                     const float* __restrict__ scales, int64_t qchunk,
                     int64_t nscales, const double* __restrict__ base,
                     double* __restrict__ partial, int C, int64_t N, int W) {
  constexpr int isz = repro::kItemSize<KIND>;
  constexpr int T = RB * (RB + 1) / 2;  // tiles of the upper triangle
  extern __shared__ __align__(16) char ring[];
  const int S = repro::stage_stride(W, isz);
  const int stage_bytes = C * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  // this lane's rows 8i + g and row 0, as offsets within a stage
  int roff[RB];
  bool rok[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int r = 8 * i + g;
    rok[i] = r < C;
    roff[i] = rok[i] ? r * S + repro::row_off(data, r, N, isz) : 0;
  }
  const int roff0 = repro::row_off(data, 0, N, isz);
  double acc[T][2];
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t][0] = acc[t][1] = 0.0;
  // int8: the scales of this lane's rows at scale column sjc
  float sc0 = 0.0f, sc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) sc[i] = 0.0f;
  int64_t sjc = -1;

  const int cols = W / kWarps;  // a warp's columns of a stage
  const int64_t nst = (N + W - 1) / W;
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int64_t mine = nst > first ? (nst - 1 - first) / step + 1 : 0;
#pragma unroll 1
  for (int p = 0; p < repro::kStages - 1; ++p) {
    if (p < mine)
      repro::load_stage(ring + p * stage_bytes, data, end, C, N, isz,
                        (first + p * step) * W, S);
    repro::cp_async_commit();
  }
#pragma unroll 1
  for (int64_t it = 0; it < mine; ++it) {
    repro::cp_async_wait_ring();
    __syncthreads();  // stage `it` landed; every warp is done with it - 1
    const int64_t nxt = it + repro::kStages - 1;
    if (nxt < mine)
      repro::load_stage(ring + (nxt % repro::kStages) * stage_bytes, data,
                        end, C, N, isz, (first + nxt * step) * W, S);
    repro::cp_async_commit();
    const char* sb = ring + (it % repro::kStages) * stage_bytes;
    const int jw = warp * cols + q;  // this lane's first column in the stage
    const int64_t jg = (first + it * step) * W + jw;
    // int8: the scale column of this lane's column, carried as it moves
    int64_t sj = 0, rem = 0;
    if constexpr (KIND == kInt8) {
      if (jg < N) {
        sj = jg / qchunk;
        rem = jg - sj * qchunk;
      }
    }
    // two k-steps in flight where the accumulators leave room (RB <= 2)
#pragma unroll(RB <= 2 ? 2 : 1)
    for (int k = 0; k < cols; k += 4) {
      const int64_t j = jg + k;
      double f[RB];
      if (j < N) {
        const char* col = sb + (jw + k) * isz;
        if constexpr (KIND == kInt8) {
          if (sj != sjc) {
            sjc = sj;
            sc0 = __ldg(scales + sj);
#pragma unroll
            for (int i = 0; i < RB; ++i)
              if (rok[i]) sc[i] = __ldg(scales + (8 * i + g) * nscales + sj);
          }
        }
        const double b = base != nullptr ? __ldg(base + j) : 0.0;
        double v0 = decode_at<KIND>(col + roff0, sc0);
        if (base != nullptr) v0 = __dadd_rn(v0, b);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          f[i] = 0.0;
          if (rok[i]) {
            double v = decode_at<KIND>(col + roff[i], sc[i]);
            if (base != nullptr) v = __dadd_rn(v, b);
            f[i] = __dsub_rn(v, v0);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < RB; ++i) f[i] = 0.0;
      }
      if constexpr (KIND == kInt8) {
        rem += 4;
        while (rem >= qchunk) {
          rem -= qchunk;
          ++sj;
        }
      }
      int t = 0;
#pragma unroll
      for (int a = 0; a < RB; ++a)
#pragma unroll
        for (int bb = a; bb < RB; ++bb) dmma(acc[t++], f[a], f[bb]);
    }
  }
  repro::cp_async_wait_all();
  // the warps' accumulators, summed in warp order
  double* red = reinterpret_cast<double*>(ring);  // T * 64 doubles
  __syncthreads();  // the ring is free
#pragma unroll 1
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double* r = red + t * 64 + lane * 2 + h;
          *r = w == 0 ? acc[t][h] : __dadd_rn(*r, acc[t][h]);
        }
    }
    __syncthreads();
  }
  // the CTA's partial: pair (a, b), a <= b < C, at its triangle index
  double* mine_out = partial + static_cast<int64_t>(blockIdx.x) * kPairs;
  for (int e = threadIdx.x; e < T * 64; e += kThreads) {
    int t = e >> 6, ta = 0;
    while (t >= RB - ta) {  // tile t of the row-major upper triangle
      t -= RB - ta;
      ++ta;
    }
    const int tb = ta + t, l = (e & 63) >> 1, h = e & 1;
    const int a = 8 * ta + (l >> 2), b = 8 * tb + 2 * (l & 3) + h;
    if (a <= b && b < C) mine_out[tri_index(a, b, C)] = red[e];
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    gram_pair_kernel(const void* __restrict__ data,
                     const float* __restrict__ scales, int64_t qchunk,
                     int64_t nscales, const double* __restrict__ base,
                     double* __restrict__ partial, int C, int64_t N) {
  extern __shared__ double tile[];  // [na (+ nb off the diagonal)][kLd]
  const BlockPair bp = block_pair(blockIdx.x, C);
  const int rows = bp.diag ? bp.na : bp.na + bp.nb;
  const double* tb = bp.diag ? tile : tile + bp.na * kLd;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  // warp w: rows 8w + g of block ia against rows 8j + g of block ib
  const bool aok = 8 * w + g < bp.na;
  const double* ra = tile + (8 * w + g) * kLd + q;
  double acc[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = 0.0;
  const int64_t ntiles = (N + kTile - 1) / kTile;
  for (int64_t t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int64_t j0 = t * kTile;
    for (int e = threadIdx.x; e < rows * kTile; e += kThreads) {
      const int r = e / kTile, jj = e - r * kTile;
      const int c = r < bp.na ? bp.ia * kBlk + r : bp.ib * kBlk + r - bp.na;
      const int64_t j = j0 + jj;
      double x = 0.0;  // columns past N contribute nothing
      if (j < N) {
        const int64_t sj = KIND == kInt8 ? j / qchunk : 0;
        double v = decode<KIND>(data, static_cast<int64_t>(c) * N + j, scales,
                                static_cast<int64_t>(c) * nscales + sj);
        double v0 = decode<KIND>(data, j, scales, sj);  // row 0 (L1-cached)
        if (base != nullptr) {
          const double bj = base[j];
          v = __dadd_rn(v, bj);
          v0 = __dadd_rn(v0, bj);
        }
        x = __dsub_rn(v, v0);
      }
      tile[r * kLd + jj] = x;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTile; k += 4) {
      const double fa = aok ? ra[k] : 0.0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const double fb =
            8 * j + g < bp.nb ? tb[(8 * j + g) * kLd + q + k] : 0.0;
        dmma(acc[j], fa, fb);
      }
    }
    __syncthreads();
  }
  double* mine = partial + (static_cast<int64_t>(blockIdx.y) * gridDim.x +
                            blockIdx.x) * kPairs;
  const int a = 8 * w + g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = 8 * j + 2 * q + h;
      if (a < bp.na && b < bp.nb && (!bp.diag || a <= b))
        mine[bp.diag ? tri_index(a, b, bp.na) : a * bp.nb + b] = acc[j][h];
    }
}

__global__ void gram_reduce_kernel(const double* __restrict__ partial,
                                   int64_t npb, int64_t ncb, int C,
                                   double* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= npb * kPairs) return;
  const int64_t pbi = idx / kPairs;
  const int p = static_cast<int>(idx - pbi * kPairs);
  const BlockPair bp = block_pair(pbi, C);
  if (p >= bp.npairs) return;
  double s = partial[idx];
  for (int64_t g = 1; g < ncb; ++g)
    s = __dadd_rn(s, partial[g * npb * kPairs + idx]);
  int a, b;
  pair_in(p, bp, &a, &b);
  const int64_t ga = bp.ia * kBlk + a, gb = bp.ib * kBlk + b;
  out[ga * C + gb] = s;
  out[gb * C + ga] = s;
}

template <int KIND, int RB>
cudaError_t launch_dmma(const void* data, const float* scales, int64_t qchunk,
                        int64_t nscales, const double* base, double* partial,
                        int C, int64_t N, const Plan& p, cudaStream_t s) {
  constexpr int isz = repro::kItemSize<KIND>;
  const auto kernel = gram_dmma_kernel<KIND, RB>;
  // the ring, which the warps' sums reuse at the end
  const int smem = std::max(
      repro::kStages * C * repro::stage_stride(p.W, isz),
      static_cast<int>(RB * (RB + 1) / 2 * 64 * sizeof(double)));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const char* d = static_cast<const char*>(data);
  kernel<<<static_cast<unsigned int>(p.ncb), kThreads, smem, s>>>(
      d, d + static_cast<int64_t>(C) * N * isz, scales, qchunk, nscales, base,
      partial, C, N, p.W);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_partial(const void* data, const float* scales,
                           int64_t qchunk, int64_t nscales,
                           const double* base, double* partial, int C,
                           int64_t N, const Plan& p, cudaStream_t stream) {
  if (C <= 8)
    return launch_dmma<KIND, 1>(data, scales, qchunk, nscales, base, partial,
                                C, N, p, stream);
  if (C <= 16)
    return launch_dmma<KIND, 2>(data, scales, qchunk, nscales, base, partial,
                                C, N, p, stream);
  if (C <= 32)
    return launch_dmma<KIND, 4>(data, scales, qchunk, nscales, base, partial,
                                C, N, p, stream);
  if (C <= kBlk)
    return launch_dmma<KIND, 8>(data, scales, qchunk, nscales, base, partial,
                                C, N, p, stream);
  // two row blocks (the pair's) in shared memory: above the 48 KB default
  const size_t smem = static_cast<size_t>(2 * kBlk) * kLd * sizeof(double);
  const cudaError_t err = cudaFuncSetAttribute(
      gram_pair_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(p.npb),
                  static_cast<unsigned int>(p.ncb));
  gram_pair_kernel<KIND><<<grid, kThreads, smem, stream>>>(
      data, scales, qchunk, nscales, base, partial, C, N);
  return cudaGetLastError();
}

}  // namespace

// fp64 elements of the partial scratch for (C, N): ncb * npb * 4096, where
// ncb, the number of column blocks, is a function of (C, N) and the
// payload's item size alone, so the summation order does not depend on the
// card (at C <= 64 the most any item size needs: stages are >= 64 columns).
extern "C" long long repro_gram_scratch(long long C, long long N) {
  if (C <= 0 || N <= 0) return 0;
  if (C <= kBlk)
    return std::min<int64_t>((N + 63) / 64, dmma_grid(C)) * kPairs;
  const Plan p = plan(C, N, 8);
  return p.ncb * p.npb * kPairs;
}

// Plain C entry point, bound with ctypes.  data: (C, N) contiguous payload of
// `kind`; scales: (C, nscales) fp32 (int8 only, else null); base: (N,) fp64
// or null; partial: repro_gram_scratch(C, N) fp64 scratch; out: (C, C)
// fp64.  All pointers are device pointers; both launches go on
// `stream` and do not synchronise.  Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_gram(int kind, const void* data, const float* scales,
                          long long qchunk, long long nscales,
                          const double* base, double* partial, double* out,
                          long long C, long long N, void* stream) {
  if (N <= 0 || C <= 0 || C > 65535LL * kBlk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kInt8 && (scales == nullptr || qchunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind < kInt8 || kind > kF64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(C);
  const Plan p = plan(C, N, item_size(kind));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kInt8:
      err = launch_partial<kInt8>(data, scales, qchunk, nscales, base,
                                  partial, c, N, p, s);
      break;
    case kF16:
      err = launch_partial<kF16>(data, scales, qchunk, nscales, base, partial,
                                 c, N, p, s);
      break;
    case kBF16:
      err = launch_partial<kBF16>(data, scales, qchunk, nscales, base,
                                  partial, c, N, p, s);
      break;
    case kF32:
      err = launch_partial<kF32>(data, scales, qchunk, nscales, base, partial,
                                 c, N, p, s);
      break;
    default:
      err = launch_partial<kF64>(data, scales, qchunk, nscales, base, partial,
                                 c, N, p, s);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t threads = p.npb * kPairs;
  gram_reduce_kernel<<<static_cast<unsigned int>((threads + kThreads - 1) /
                                                 kThreads),
                       kThreads, 0, s>>>(partial, p.npb, p.ncb, c, out);
  return static_cast<int>(cudaGetLastError());
}
