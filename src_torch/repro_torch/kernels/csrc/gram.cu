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
// Design: pass 1, gram_partial_kernel, gives each block a fixed set of
// 64-column tiles (tile t goes to block t mod gridDim.x, which is a function
// of N alone).  The block decodes and centres a (C, 64) tile into shared
// memory (row stride 65 doubles, against bank conflicts), and each thread
// owns up to 9 of the C(C+1)/2 distinct pairs (a <= b), accumulating
// fma(t[a][j], t[b][j], acc) over the tile's columns in order, in registers
// across all its tiles.  Each block writes its partial Gram (P values) to
// scratch that the wrapper allocates.  Pass 2, gram_reduce_kernel, sums the
// partials over blocks 0, 1, 2, ... in that order, one thread per pair, and
// writes G[a][b] and G[b][a].  Fast fp64 tensor-core (DMMA) tiles, register
// tiling of pairs and a single-pass reduction are left to later work.
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
constexpr int kMaxClients = 64;
constexpr int kMaxPairs = kMaxClients * (kMaxClients + 1) / 2;
constexpr int kPairsPerThread = (kMaxPairs + kThreads - 1) / kThreads;
constexpr int kMaxBlocks = 1024;

// pair p of the row-major upper triangle (a <= b) of a C x C matrix
__device__ __forceinline__ void pair_of(int p, int C, int* a, int* b) {
  int r = 0;
  while (p >= C - r) {
    p -= C - r;
    ++r;
  }
  *a = r;
  *b = r + p;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    gram_partial_kernel(const void* __restrict__ data,
                        const float* __restrict__ scales, int64_t qchunk,
                        int64_t nscales, const double* __restrict__ base,
                        double* __restrict__ partial, int C, int64_t N) {
  extern __shared__ double tile[];  // [C][kLd]
  const int P = C * (C + 1) / 2;
  int pa[kPairsPerThread], pb[kPairsPerThread];
  double acc[kPairsPerThread];
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    pa[i] = pb[i] = 0;
    if (p < P) pair_of(p, C, &pa[i], &pb[i]);
    acc[i] = 0.0;
  }
  const int64_t ntiles = (N + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t j0 = t * kTile;
    for (int e = threadIdx.x; e < C * kTile; e += kThreads) {
      const int c = e / kTile, jj = e - c * kTile;
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
      tile[c * kLd + jj] = x;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairsPerThread; ++i) {
      if (threadIdx.x + i * kThreads < P) {
        const double* ra = tile + pa[i] * kLd;
        const double* rb = tile + pb[i] * kLd;
        double s = acc[i];
#pragma unroll 8
        for (int jj = 0; jj < kTile; ++jj) s = fma(ra[jj], rb[jj], s);
        acc[i] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPairsPerThread; ++i) {
    const int p = threadIdx.x + i * kThreads;
    if (p < P) partial[static_cast<int64_t>(blockIdx.x) * P + p] = acc[i];
  }
}

__global__ void gram_reduce_kernel(const double* __restrict__ partial,
                                   int nblocks, int C,
                                   double* __restrict__ out) {
  const int P = C * (C + 1) / 2;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  double s = partial[p];
  for (int g = 1; g < nblocks; ++g)
    s = __dadd_rn(s, partial[static_cast<int64_t>(g) * P + p]);
  int a, b;
  pair_of(p, C, &a, &b);
  out[a * C + b] = s;
  out[b * C + a] = s;
}

template <int KIND>
void launch_partial(const void* data, const float* scales, int64_t qchunk,
                    int64_t nscales, const double* base, double* partial,
                    int C, int64_t N, int nblocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(C) * kLd * sizeof(double);
  gram_partial_kernel<KIND><<<nblocks, kThreads, smem, stream>>>(
      data, scales, qchunk, nscales, base, partial, C, N);
}

}  // namespace

// The number of pass-1 blocks (and partial Grams) for N columns: a function
// of N alone, so the summation order does not depend on the card.
extern "C" long long repro_gram_blocks(long long N) {
  const long long tiles = (N + kTile - 1) / kTile;
  return tiles < kMaxBlocks ? tiles : kMaxBlocks;
}

// Plain C entry point, bound with ctypes.  data: (C, N) contiguous payload of
// `kind`; scales: (C, nscales) fp32 (int8 only, else null); base: (N,) fp64
// or null; partial: (repro_gram_blocks(N), C(C+1)/2) fp64 scratch; out:
// (C, C) fp64.  All pointers are device pointers; both launches go on
// `stream` and do not synchronise.  Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int repro_gram(int kind, const void* data, const float* scales,
                          long long qchunk, long long nscales,
                          const double* base, double* partial, double* out,
                          long long C, long long N, void* stream) {
  if (N <= 0 || C <= 0 || C > kMaxClients)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kInt8 && (scales == nullptr || qchunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(C);
  const int nblocks = static_cast<int>(repro_gram_blocks(N));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kInt8:
      launch_partial<kInt8>(data, scales, qchunk, nscales, base, partial, c,
                            N, nblocks, s);
      break;
    case kF16:
      launch_partial<kF16>(data, scales, qchunk, nscales, base, partial, c, N,
                           nblocks, s);
      break;
    case kBF16:
      launch_partial<kBF16>(data, scales, qchunk, nscales, base, partial, c,
                            N, nblocks, s);
      break;
    case kF32:
      launch_partial<kF32>(data, scales, qchunk, nscales, base, partial, c, N,
                           nblocks, s);
      break;
    case kF64:
      launch_partial<kF64>(data, scales, qchunk, nscales, base, partial, c, N,
                           nblocks, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = c * (c + 1) / 2;
  gram_reduce_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, nblocks, c, out);
  return static_cast<int>(cudaGetLastError());
}
