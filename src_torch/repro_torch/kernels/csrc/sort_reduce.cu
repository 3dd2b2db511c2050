// sort_reduce: coordinate-wise median or trimmed sum of the decoded (C, N)
// client stack, in fp64 for Hopper (sm_90a) -- FedMedian's and
// FedTrimmedMean's server reduction.
//
// Replaces the Pallas TPU kernel repro/kernels/agg_reduce.py:283
// (sort_reduce, pallas_call at :307, body _sort_kernel :261).  For each
// column j it decodes the C client values (decode.cuh, plus the fp64 delta
// base), sorts them and writes
//   - kind 0, median: numpy's np.median(tile, axis=0, overwrite_input=True)
//     bitwise -- NaN if the column holds a NaN, else the mean of the middle
//     element (C odd) or the middle two (C even);
//   - kind 1, trimmed sum: the sum of sorted rows [trim_k, C - trim_k), in
//     sorted order; the caller divides by the row count, which is numpy's
//     np.mean (sum, then one correctly rounded divide).
// numpy's sums over axis 0 start from the identity +0.0 and add the rows in
// order (checked against numpy for C up to 64): a = 0.0, then a += row.  So
// a sum of zeros is +0 whatever their signs, and the order in which a sort
// leaves -0 and +0 can never show in the result; the kernel does the same,
// one __dadd_rn per row, never a tree.
//
// Sort order: values are mapped to 64-bit keys that order like the numbers
// (a total order with -0 < +0), every NaN to one key above +inf -- numpy
// sorts NaNs last -- and the rows above C to a pad key above that.  A NaN
// result is written as the canonical quiet NaN (0x7ff8000000000000, as the
// twin writes it), so NaN payload bits are not kept.
//
// What bounds it: HBM bytes.  Each column reads its C payload elements (plus
// the int8 scales, 1/qchunk per element, and the fp64 base) once and writes
// one fp64: C*N*itemsize + N*8 (+ N*8 base) + scales.  The sort is
// O(C log^2 C) integer compare-exchanges per column, all in registers.
//
// Design: one thread per column (64-bit indices: C*N passes 2^31 at
// 50M x 16); loads of each client row are coalesced across the warp.  The C
// keys sit in a register array of CMAX = the next power of two >= C (a
// template bucket, 1 to 64), sorted by a fully unrolled bitonic network, so
// every index is a compile-time constant and nothing goes to local memory
// unless ptxas spills.  The reduction walks the sorted keys with compile-time
// indices too, predicated on the runtime C and trim_k.
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

constexpr int kThreads = 128;
constexpr int kMaxClients = 64;
constexpr uint64_t kSign = 0x8000000000000000ull;
// key of the canonical quiet NaN (0x7ff8000000000000): above +inf's key
constexpr uint64_t kNaNKey = 0xFFF8000000000000ull;
// rows C..CMAX-1: above every value and NaN
constexpr uint64_t kPadKey = 0xFFFFFFFFFFFFFFFFull;

__device__ __forceinline__ uint64_t to_key(double v) {
  if (v != v) return kNaNKey;
  const uint64_t u = static_cast<uint64_t>(__double_as_longlong(v));
  return (u & kSign) ? ~u : (u | kSign);
}

__device__ __forceinline__ double from_key(uint64_t k) {
  const uint64_t u = (k & kSign) ? (k & ~kSign) : ~k;
  return __longlong_as_double(static_cast<long long>(u));
}

// ascending bitonic sort of N (a power of two) keys held in registers
template <int N>
__device__ __forceinline__ void bitonic_sort(uint64_t (&v)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const uint64_t a = v[i], b = v[l];
          const bool swap = ((i & k) == 0) ? (a > b) : (a < b);
          v[i] = swap ? b : a;
          v[l] = swap ? a : b;
        }
      }
    }
  }
}

template <int KIND, int CMAX>
__global__ void __launch_bounds__(kThreads)
    sort_reduce_kernel(const void* __restrict__ data,
                       const float* __restrict__ scales, int64_t qchunk,
                       int64_t nscales, const double* __restrict__ base,
                       double* __restrict__ out, int C, int median,
                       int trim_k, int64_t N) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const double b = base != nullptr ? base[j] : 0.0;
  const int64_t sj = KIND == kInt8 ? j / qchunk : 0;
  uint64_t v[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      double x = decode<KIND>(data, static_cast<int64_t>(c) * N + j, scales,
                              static_cast<int64_t>(c) * nscales + sj);
      if (base != nullptr) x = __dadd_rn(x, b);
      v[c] = to_key(x);
    } else {
      v[c] = kPadKey;
    }
  }
  bitonic_sort<CMAX>(v);
  double a = 0.0;  // numpy's +0.0 identity
  if (median) {
    const int lo = (C - 1) / 2, hi = C / 2;  // equal when C is odd
    bool nan = false;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c == C - 1) nan = v[c] == kNaNKey;  // NaNs sort last
      if (c == lo) a = __dadd_rn(a, from_key(v[c]));
      if (c == hi && hi != lo) a = __dadd_rn(a, from_key(v[c]));
    }
    if (hi != lo) a = __ddiv_rn(a, 2.0);
    if (nan) a = from_key(kNaNKey);
  } else {
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c >= trim_k && c < C - trim_k) a = __dadd_rn(a, from_key(v[c]));
  }
  // a NaN sum (a NaN row kept, or inf - inf) as the canonical quiet NaN
  out[j] = a != a ? from_key(kNaNKey) : a;
}

template <int KIND, int CMAX>
void launch(const void* data, const float* scales, int64_t qchunk,
            int64_t nscales, const double* base, double* out, int C,
            int median, int trim_k, int64_t N, cudaStream_t stream) {
  const int64_t blocks = (N + kThreads - 1) / kThreads;
  sort_reduce_kernel<KIND, CMAX>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          data, scales, qchunk, nscales, base, out, C, median, trim_k, N);
}

template <int KIND>
void launch_kind(const void* data, const float* scales, int64_t qchunk,
                 int64_t nscales, const double* base, double* out, int C,
                 int median, int trim_k, int64_t N, cudaStream_t s) {
  if (C <= 1)
    launch<KIND, 1>(data, scales, qchunk, nscales, base, out, C, median,
                    trim_k, N, s);
  else if (C <= 2)
    launch<KIND, 2>(data, scales, qchunk, nscales, base, out, C, median,
                    trim_k, N, s);
  else if (C <= 4)
    launch<KIND, 4>(data, scales, qchunk, nscales, base, out, C, median,
                    trim_k, N, s);
  else if (C <= 8)
    launch<KIND, 8>(data, scales, qchunk, nscales, base, out, C, median,
                    trim_k, N, s);
  else if (C <= 16)
    launch<KIND, 16>(data, scales, qchunk, nscales, base, out, C, median,
                     trim_k, N, s);
  else if (C <= 32)
    launch<KIND, 32>(data, scales, qchunk, nscales, base, out, C, median,
                     trim_k, N, s);
  else
    launch<KIND, 64>(data, scales, qchunk, nscales, base, out, C, median,
                     trim_k, N, s);
}

}  // namespace

// Plain C entry point, bound with ctypes.  data: (C, N) contiguous payload of
// `kind`; scales: (C, nscales) fp32 (int8 only, else null); base: (N,) fp64
// or null; out: (N,) fp64.  median != 0 writes the median, else the sum of
// sorted rows [trim_k, C - trim_k).  All pointers are device pointers; the
// launch goes on `stream` and does not synchronise.  Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int repro_sort_reduce(int kind, const void* data,
                                 const float* scales, long long qchunk,
                                 long long nscales, const double* base,
                                 double* out, long long C, long long N,
                                 int median, long long trim_k,
                                 void* stream) {
  if (N <= 0 || C <= 0 || C > kMaxClients)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kInt8 && (scales == nullptr || qchunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!median && (trim_k < 0 || C - 2 * trim_k < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(C), k = static_cast<int>(trim_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kInt8:
      launch_kind<kInt8>(data, scales, qchunk, nscales, base, out, c, median,
                         k, N, s);
      break;
    case kF16:
      launch_kind<kF16>(data, scales, qchunk, nscales, base, out, c, median,
                        k, N, s);
      break;
    case kBF16:
      launch_kind<kBF16>(data, scales, qchunk, nscales, base, out, c, median,
                         k, N, s);
      break;
    case kF32:
      launch_kind<kF32>(data, scales, qchunk, nscales, base, out, c, median,
                        k, N, s);
      break;
    case kF64:
      launch_kind<kF64>(data, scales, qchunk, nscales, base, out, c, median,
                        k, N, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
