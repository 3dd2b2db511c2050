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
// Design, C <= 64: one thread per column (64-bit indices: C*N passes 2^31
// at 50M x 16); loads of each client row are coalesced across the warp.  The
// C keys sit in a register array of CMAX = the next power of two >= C (a
// template bucket, 1 to 64), sorted by a fully unrolled bitonic network, so
// every index is a compile-time constant and nothing goes to local memory
// unless ptxas spills.  The reduction walks the sorted keys with
// compile-time indices too, predicated on the runtime C and trim_k.
//
// Design, C > 64 (sort_reduce_big_kernel): a CTA of 256 threads sorts a
// batch of columns at once, each column's keys padded to P = the next power
// of two >= C, by one bitonic network over the batch (every stage a
// compare-exchange per key pair, then __syncthreads).  A batch holds
// max(1, 8192 / P) columns, loaded with the column index fastest so that a
// warp's reads of one client row are coalesced; each column's P keys are
// followed by one pad key, against bank conflicts between columns.  The keys
// live in dynamic shared memory up to P = 16384 (128 KB); above it one
// column at a time is sorted in a per-CTA slice of global scratch that the
// wrapper allocates (repro_sort_reduce_scratch), with a persistent grid
// sized so that the scratch stays within 256 MB (one slice at least).  Then
// one thread per column walks its sorted keys in order, exactly as the
// register path does: the median's middle pair, or the trimmed sum as one
// __dadd_rn per row from +0.0.  So any C is bitwise numpy's.
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

constexpr int kThreads = 128;
constexpr int kMaxRegClients = 64;      // the register path's largest C
constexpr int kBigThreads = 256;        // the C > 64 path's CTA
constexpr int kBatchKeys = 8192;        // keys a C > 64 CTA sorts at once
constexpr int64_t kSmemMax = 232448;    // shared memory a block may use
constexpr int64_t kScratchMax = int64_t(256) << 20;  // global scratch bytes
constexpr int64_t kMaxGrid = 132 * 8;   // CTAs of the C > 64 path
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

// the C > 64 path's launch geometry, a function of (C, N) alone
struct BigPlan {
  int logp;         // P = 2^logp >= C keys per column
  int cols;         // columns per batch
  int64_t per_cta;  // keys a CTA holds: cols * (P + 1)
  int64_t grid;     // CTAs
  int64_t smem;     // dynamic shared memory bytes (0: global scratch)
  int64_t scratch;  // global scratch keys (0: shared memory)
};

BigPlan big_plan(int64_t C, int64_t N) {
  BigPlan p{};
  while ((int64_t(1) << p.logp) < C) ++p.logp;
  const int64_t P = int64_t(1) << p.logp;
  int64_t cols = P >= kBatchKeys ? 1 : kBatchKeys / P;
  p.per_cta = cols * (P + 1);
  if (p.per_cta * 8 <= kSmemMax) {
    p.smem = p.per_cta * 8;
    p.grid = std::min((N + cols - 1) / cols, kMaxGrid);
  } else {
    cols = 1;
    p.per_cta = P + 1;
    p.grid = std::min({N, kMaxGrid,
                       std::max<int64_t>(1, kScratchMax / (p.per_cta * 8))});
    p.scratch = p.grid * p.per_cta;
  }
  p.cols = static_cast<int>(cols);
  return p;
}

// key i (column i / P, row i % P) of a batch: each column's P keys are
// followed by one pad key
__device__ __forceinline__ int slot(int i, int logp) { return i + (i >> logp); }

template <int KIND>
__global__ void __launch_bounds__(kBigThreads)
    sort_reduce_big_kernel(const void* __restrict__ data,
                           const float* __restrict__ scales, int64_t qchunk,
                           int64_t nscales, const double* __restrict__ base,
                           double* __restrict__ out,
                           uint64_t* __restrict__ scratch, int C, int logp,
                           int cols, int median, int trim_k, int64_t N) {
  extern __shared__ uint64_t smem_keys[];
  const int P = 1 << logp;  // P <= 2^30, cols * P <= max(P, kBatchKeys)
  const int E = cols * P;
  uint64_t* keys = scratch != nullptr
                       ? scratch + static_cast<int64_t>(blockIdx.x) *
                                       (E + cols)
                       : smem_keys;
  const int tid = threadIdx.x;
  const int64_t nbatch = (N + cols - 1) / cols;
  for (int64_t bt = blockIdx.x; bt < nbatch; bt += gridDim.x) {
    const int64_t j0 = bt * cols;
    // load with the column fastest: a warp reads runs of one client row
    for (int e = tid; e < E; e += kBigThreads) {
      const int c = e / cols;
      const int col = e - c * cols;
      const int64_t j = j0 + col;
      uint64_t key = kPadKey;
      if (c < C && j < N) {
        const int64_t sidx = static_cast<int64_t>(c) * nscales +
                             (KIND == kInt8 ? j / qchunk : 0);
        double x = decode<KIND>(data, static_cast<int64_t>(c) * N + j,
                                scales, sidx);
        if (base != nullptr) x = __dadd_rn(x, base[j]);
        key = to_key(x);
      }
      keys[slot(col * P + c, logp)] = key;
    }
    __syncthreads();
    // one bitonic network sorts every column of the batch ascending: the
    // direction of a pair comes from its row within the column
    for (int k = 2; k <= P; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        for (int pr = tid; pr < E / 2; pr += kBigThreads) {
          // the pr-th index with bit jj clear, and its partner
          const int i = ((pr & ~(jj - 1)) << 1) | (pr & (jj - 1));
          const int si = slot(i, logp), sl = slot(i + jj, logp);
          const uint64_t a = keys[si], b = keys[sl];
          const bool up = (i & k & (P - 1)) == 0;
          if ((a > b) == up) {
            keys[si] = b;
            keys[sl] = a;
          }
        }
        __syncthreads();
      }
    }
    // one thread per column walks its sorted keys in order
    if (tid < cols && j0 + tid < N) {
      const uint64_t* v = keys + slot(tid * P, logp);
      double a = 0.0;  // numpy's +0.0 identity
      if (median) {
        const int lo = (C - 1) / 2, hi = C / 2;  // equal when C is odd
        a = __dadd_rn(a, from_key(v[lo]));
        if (hi != lo) a = __ddiv_rn(__dadd_rn(a, from_key(v[hi])), 2.0);
        if (v[C - 1] == kNaNKey) a = from_key(kNaNKey);  // NaNs sort last
      } else {
        for (int c = trim_k; c < C - trim_k; ++c)
          a = __dadd_rn(a, from_key(v[c]));
      }
      out[j0 + tid] = a != a ? from_key(kNaNKey) : a;
    }
    __syncthreads();  // the batch's keys are consumed
  }
}

template <int KIND>
cudaError_t launch_big(const void* data, const float* scales, int64_t qchunk,
                       int64_t nscales, const double* base, double* out,
                       uint64_t* scratch, int C, int median, int trim_k,
                       int64_t N, cudaStream_t s) {
  const BigPlan p = big_plan(C, N);
  if (p.scratch > 0 && scratch == nullptr) return cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_reduce_big_kernel<KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
  }
  sort_reduce_big_kernel<KIND>
      <<<static_cast<unsigned int>(p.grid), kBigThreads, p.smem, s>>>(
          data, scales, qchunk, nscales, base, out,
          p.scratch > 0 ? scratch : nullptr, C, p.logp, p.cols, median,
          trim_k, N);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_any(const void* data, const float* scales, int64_t qchunk,
                       int64_t nscales, const double* base, double* out,
                       uint64_t* scratch, int C, int median, int trim_k,
                       int64_t N, cudaStream_t s) {
  if (C > kMaxRegClients)
    return launch_big<KIND>(data, scales, qchunk, nscales, base, out, scratch,
                            C, median, trim_k, N, s);
  launch_kind<KIND>(data, scales, qchunk, nscales, base, out, C, median,
                    trim_k, N, s);
  return cudaGetLastError();
}

}  // namespace

// Keys of global scratch (uint64) the wrapper allocates for (C, N): 0 unless
// C padded to a power of two does not fit a block's shared memory.
extern "C" long long repro_sort_reduce_scratch(long long C, long long N) {
  if (C <= kMaxRegClients || N <= 0) return 0;
  return big_plan(C, N).scratch;
}

// Plain C entry point, bound with ctypes.  data: (C, N) contiguous payload of
// `kind`; scales: (C, nscales) fp32 (int8 only, else null); base: (N,) fp64
// or null; out: (N,) fp64; scratch: repro_sort_reduce_scratch(C, N) uint64
// keys, or null when that is 0.  median != 0 writes the median, else the sum
// of sorted rows [trim_k, C - trim_k).  All pointers are device pointers;
// the launch goes on `stream` and does not synchronise.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int repro_sort_reduce(int kind, const void* data,
                                 const float* scales, long long qchunk,
                                 long long nscales, const double* base,
                                 double* out, void* scratch, long long C,
                                 long long N, int median, long long trim_k,
                                 void* stream) {
  if (N <= 0 || C <= 0 || C > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kInt8 && (scales == nullptr || qchunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!median && (trim_k < 0 || C - 2 * trim_k < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(C), k = static_cast<int>(trim_k);
  uint64_t* sc = static_cast<uint64_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kInt8:
      err = launch_any<kInt8>(data, scales, qchunk, nscales, base, out, sc, c,
                              median, k, N, s);
      break;
    case kF16:
      err = launch_any<kF16>(data, scales, qchunk, nscales, base, out, sc, c,
                             median, k, N, s);
      break;
    case kBF16:
      err = launch_any<kBF16>(data, scales, qchunk, nscales, base, out, sc, c,
                              median, k, N, s);
      break;
    case kF32:
      err = launch_any<kF32>(data, scales, qchunk, nscales, base, out, sc, c,
                             median, k, N, s);
      break;
    case kF64:
      err = launch_any<kF64>(data, scales, qchunk, nscales, base, out, sc, c,
                             median, k, N, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
