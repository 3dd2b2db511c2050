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
// hardware-ordered MXU/dgemm reduction.  The products are explicit fma()
// (the library is built with -fmad=false, which leaves the intrinsic
// alone).  It IS deterministic: the same input gives the same bits on every
// run, because every sum has a fixed order and no atomics are used.  Krum's
// selection, and native == FLARE, depend on that.
//
// What bounds it: the card, at the benchmark's geometry (C = 16, fp32), by
// HBM bytes: the stack is read once, C*N*itemsize (+ scales, base), and the
// C(C+1)/2 products per column are 2 flops each, 272 flops against 64 bytes
// = 4.25 flops per byte, under the fp64 ridge (67 TFLOP/s tensor-core peak /
// 3.35 TB/s = 20 flops per byte; 10 for the 34 TFLOP/s CUDA-core FMAs this
// kernel uses).  The flops grow as C^2 and take over near C = 40 on CUDA
// cores.  This first kernel is bound in practice by its shared-memory reads
// (two per FMA), not by either.
//
// Design: the (C, C) output is tiled into blocks of 64 x 64 clients, and
// only the block pairs (ia, ib) with ia <= ib are computed (npb of them).
// Pass 1, gram_partial_kernel, runs a CTA per (block pair, column block):
// the column blocks (ncb, a function of C and N alone, so the summation
// order does not depend on the card) split the 64-column tiles, tile t going
// to column block t mod ncb, and ncb is capped so that the partial scratch,
// ncb * npb * 4096 fp64, stays within 256 MB (one column block at least).
// The CTA decodes and centres its pair's two row blocks of a (64-row, 64)
// tile into shared memory (one block on the diagonal; row stride 65
// doubles, against bank conflicts), and each thread owns some of the pair's
// client pairs -- the upper triangle (a <= b) on the diagonal, all 64 x 64
// off it -- accumulating fma(t[a][j], t[b][j], acc) over the tile's columns
// in order, in registers across all its tiles.  A thread holds up to 16
// pairs, or 9 at C <= 64, which is a template case of its own with
// compile-time block indices: it keeps the registers, and so the
// occupancy, of the kernel before the blocking.
// Each CTA writes its partial sums to scratch that the wrapper allocates
// (repro_gram_scratch).
// Pass 2, gram_reduce_kernel, sums the partials over column blocks 0, 1,
// 2, ... in that order, one thread per client pair, and writes G[a][b] and
// G[b][a].  At C <= 64 there is one block pair, and the sums are those of
// the kernel before the blocking, in the same order.  Fast fp64 tensor-core
// (DMMA) tiles, register tiling of pairs and a single-pass reduction are
// left to later work.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

using repro::decode;
using repro::kBF16;
using repro::kF16;
using repro::kF32;
using repro::kF64;
using repro::kInt8;

constexpr int kThreads = 256;
constexpr int kTile = 64;        // columns per shared-memory tile
constexpr int kLd = kTile + 1;   // row stride of the tile, in doubles
constexpr int kBlk = 64;         // clients per row block
constexpr int kPairs = kBlk * kBlk;  // partial slots per block pair
// client pairs a thread owns: all 64 x 64 of an off-diagonal block pair
// over the CTA, or (at C <= 64, one diagonal pair) the 64 * 65 / 2 of the
// triangle, which keeps that case's registers, and so its occupancy
constexpr int kPairsPerThread = kPairs / kThreads;
constexpr int kDiagPairsPerThread = (kBlk * (kBlk + 1) / 2 + kThreads - 1) /
                                    kThreads;
constexpr int64_t kMaxColBlocks = 1024;
constexpr int64_t kScratchMax = int64_t(256) << 20;  // partial bytes

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
  if (bp.diag) {  // (the one block pair at C <= 64 is diagonal)
    int64_t x, y;
    pair_of(p, bp.na, &x, &y);
    *a = static_cast<int>(x);
    *b = static_cast<int>(y);
  } else {
    *a = p / bp.nb;
    *b = p - *a * bp.nb;
  }
}

// pass 1's geometry, a function of (C, N) alone
struct Plan {
  int64_t npb;  // block pairs
  int64_t ncb;  // column blocks
};

Plan plan(int64_t C, int64_t N) {
  const int64_t nblk = (C + kBlk - 1) / kBlk;
  const int64_t tiles = (N + kTile - 1) / kTile;
  Plan p;
  p.npb = nblk * (nblk + 1) / 2;
  p.ncb = std::max<int64_t>(
      1, std::min({tiles, kMaxColBlocks,
                   kScratchMax / (p.npb * kPairs * int64_t(sizeof(double)))}));
  return p;
}

// kOneBlock: C <= 64, one diagonal block pair, whose indices are then
// compile-time trivial (the code, registers and sums of the kernel before
// the blocking)
template <int KIND, bool kOneBlock>
__global__ void __launch_bounds__(kThreads)
    gram_partial_kernel(const void* __restrict__ data,
                        const float* __restrict__ scales, int64_t qchunk,
                        int64_t nscales, const double* __restrict__ base,
                        double* __restrict__ partial, int C, int64_t N) {
  constexpr int PPT = kOneBlock ? kDiagPairsPerThread : kPairsPerThread;
  extern __shared__ double tile[];  // [na (+ nb off the diagonal)][kLd]
  const BlockPair bp = kOneBlock
                           ? BlockPair{0, 0, C, C, C * (C + 1) / 2, true}
                           : block_pair(blockIdx.x, C);
  const int rows = kOneBlock ? C : (bp.diag ? bp.na : bp.na + bp.nb);
  const double* tb = kOneBlock || bp.diag ? tile : tile + bp.na * kLd;
  int pa[PPT], pb[PPT];
  double acc[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    pa[i] = pb[i] = 0;
    if (p < bp.npairs) pair_in(p, bp, &pa[i], &pb[i]);
    acc[i] = 0.0;
  }
  const int64_t ntiles = (N + kTile - 1) / kTile;
  for (int64_t t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int64_t j0 = t * kTile;
    for (int e = threadIdx.x; e < rows * kTile; e += kThreads) {
      const int r = e / kTile, jj = e - r * kTile;
      const int c = kOneBlock ? r
                    : r < bp.na ? bp.ia * kBlk + r
                                : bp.ib * kBlk + r - bp.na;
      const int64_t j = j0 + jj;
      double x = 0.0;  // columns past N contribute fma(0, 0, acc) = acc
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
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (threadIdx.x + i * kThreads < bp.npairs) {
        const double* ra = tile + pa[i] * kLd;
        const double* rb = tb + pb[i] * kLd;
        double s = acc[i];
#pragma unroll 8
        for (int jj = 0; jj < kTile; ++jj) s = fma(ra[jj], rb[jj], s);
        acc[i] = s;
      }
    }
    __syncthreads();
  }
  double* mine = partial + (static_cast<int64_t>(blockIdx.y) * gridDim.x +
                            blockIdx.x) * kPairs;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < bp.npairs) mine[p] = acc[i];
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

template <int KIND>
cudaError_t launch_partial(const void* data, const float* scales,
                           int64_t qchunk, int64_t nscales,
                           const double* base, double* partial, int C,
                           int64_t N, const Plan& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(p.npb),
                  static_cast<unsigned int>(p.ncb));
  if (C <= kBlk) {  // one diagonal block pair: one row block
    const size_t smem = static_cast<size_t>(C) * kLd * sizeof(double);
    gram_partial_kernel<KIND, true><<<grid, kThreads, smem, stream>>>(
        data, scales, qchunk, nscales, base, partial, C, N);
    return cudaGetLastError();
  }
  // two row blocks (the pair's) in shared memory: above the 48 KB default
  const size_t smem = static_cast<size_t>(2 * kBlk) * kLd * sizeof(double);
  const cudaError_t err = cudaFuncSetAttribute(
      gram_partial_kernel<KIND, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gram_partial_kernel<KIND, false><<<grid, kThreads, smem, stream>>>(
      data, scales, qchunk, nscales, base, partial, C, N);
  return cudaGetLastError();
}

}  // namespace

// fp64 elements of the partial scratch for (C, N): ncb * npb * 4096, where
// ncb, the number of column blocks, is a function of (C, N) alone, so the
// summation order does not depend on the card.
extern "C" long long repro_gram_scratch(long long C, long long N) {
  if (C <= 0 || N <= 0) return 0;
  const Plan p = plan(C, N);
  return p.ncb * p.npb * kPairs;
}

// Plain C entry point, bound with ctypes.  data: (C, N) contiguous payload of
// `kind`; scales: (C, nscales) fp32 (int8 only, else null); base: (N,) fp64
// or null; partial: repro_gram_scratch(C, N) fp64 scratch; out: (C, C)
// fp64.  All pointers are device pointers; both launches go on `stream` and
// do not synchronise.  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int repro_gram(int kind, const void* data, const float* scales,
                          long long qchunk, long long nscales,
                          const double* base, double* partial, double* out,
                          long long C, long long N, void* stream) {
  if (N <= 0 || C <= 0 || C > 65535LL * kBlk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kInt8 && (scales == nullptr || qchunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(C);
  const Plan p = plan(C, N);
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
    case kF64:
      err = launch_partial<kF64>(data, scales, qchunk, nscales, base, partial,
                                 c, N, p, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t threads = p.npb * kPairs;
  gram_reduce_kernel<<<static_cast<unsigned int>((threads + kThreads - 1) /
                                                 kThreads),
                       kThreads, 0, s>>>(partial, p.npb, p.ncb, c, out);
  return static_cast<int>(cudaGetLastError());
}
