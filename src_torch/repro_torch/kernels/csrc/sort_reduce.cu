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
// one __dadd_rn per row, never a tree.  The median's halving is
// __dmul_rn(a, 0.5), bitwise __ddiv_rn(a, 2.0): the exact product and the
// exact quotient are the same real number, so they round alike.
//
// Sort order: values are mapped to unsigned keys that order like the
// numbers (a total order with -0 < +0), every NaN to one key above +inf --
// numpy sorts NaNs last -- and the rows above C to a pad key above that.  A
// NaN result is written as the canonical quiet NaN (0x7ff8000000000000, as
// the twin writes it), so NaN payload bits are not kept.
//
// Key width.  Where the decoded value is exactly an fp32 -- fp32, fp16 and
// bf16 payloads, and int8 (f32(q * scale)) -- the keys are 32 bits: the
// same map on the fp32's bits.  Widening an fp32 to fp64 is exact and
// strictly increasing, and keeps the sign of zero and NaN-ness, so the
// 32-bit keys sort the column in the same order as the 64-bit keys of the
// widened values, and the walk below picks the same elements, widened
// before any add.  A delta payload's base b is the same for every row of a
// column, and for a finite b, x -> fl(x + b) is non-decreasing (the exact
// sum is, and rounding to nearest is) and keeps a NaN a NaN (+-inf stay
// +-inf).  So the 32-bit order of the decoded values is also an order of
// the based values: the walk adds b (__dadd_rn) to the selected elements
// only, and the rows it picks hold the same values as a sort of the based
// values would give.  Two based values can tie as reals where the decoded
// ones do not; tied reals differ at most in the sign of a zero, and a
// reduction from +0.0 never shows it.  A column whose base is +-inf or NaN
// needs no sort: each based value is that infinity or NaN, so the result
// is b or NaN by a count of NaNs.  fp64 payloads take 64-bit keys of the
// based values.  A 32-bit compare-exchange is one min and one max; a
// 64-bit one is about six instructions.
//
// What bounds it: HBM bytes.  Each column reads its C payload elements
// (plus the int8 scales, 1/qchunk per element, and the fp64 base) once and
// writes one fp64: C*N*itemsize + N*8 (+ N*8 base) + scales.  The kernel
// before this one loaded each column's C values with scalar loads from the
// thread that sorts them, and sorted 64-bit keys with a bitonic network
// (80 exchanges at 16 inputs): its loads and its sort took turns, and it
// ran at a third of the bound.
//
// Design, C <= 64 (sort_reduce_kernel): a persistent grid (as many CTAs as
// the card holds at once; each column's result does not depend on how the
// columns are split) walks stages of W columns x C rows of raw payload,
// brought into a ring of three shared-memory stages by 16-byte cp.async
// (stage.cuh: ragged row starts handled by per-row offsets), so the next
// two stages' copies run while this one is sorted.  A thread takes a
// column of the stage (consecutive threads, consecutive columns: reads
// free of bank conflicts), decodes its C values from shared memory (the
// base from global memory; the int8 scales too, kept in registers while
// the thread's columns stay in one qchunk window), and sorts the keys in a
// register array of CMAX = the next power of two >= C (a template bucket,
// 1 to 64) with the bucket's sorting network
// (sort_net.cuh: 60 exchanges at 16, Batcher's odd-even merge sort at 32
// and 64), fully unrolled, so every index is a compile-time constant.  The
// reduction walks the sorted keys with compile-time indices too,
// predicated on the runtime C and trim_k.
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
#include <type_traits>

#include "decode.cuh"
#include "sort_net.cuh"
#include "stage.cuh"

namespace {

using repro::decode;
using repro::decode32_at;
using repro::decode_at;
using repro::kBF16;
using repro::kF16;
using repro::kF32;
using repro::kF64;
using repro::kInt8;

constexpr int kThreads = 128;           // the register path's CTA
constexpr int kMaxRegClients = 64;      // the register path's largest C
constexpr int kStageTarget = 8192;      // payload bytes a stage aims at
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
// the same on 32 bits: the key of fp32's quiet NaN 0x7fc00000, and the pad
constexpr uint32_t kSign32 = 0x80000000u;
constexpr uint32_t kNaNKey32 = 0xFFC00000u;
constexpr uint32_t kPadKey32 = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t to_key(double v) {
  if (v != v) return kNaNKey;
  const uint64_t u = static_cast<uint64_t>(__double_as_longlong(v));
  return (u & kSign) ? ~u : (u | kSign);
}

__device__ __forceinline__ double from_key(uint64_t k) {
  const uint64_t u = (k & kSign) ? (k & ~kSign) : ~k;
  return __longlong_as_double(static_cast<long long>(u));
}

__device__ __forceinline__ uint32_t to_key32(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & ~kSign32) > 0x7F800000u) return kNaNKey32;  // any NaN
  return (u & kSign32) ? ~u : (u | kSign32);
}

// the fp64 value of a key: 64-bit keys, or 32-bit keys widened exactly
__device__ __forceinline__ double key_value(uint64_t k) { return from_key(k); }
__device__ __forceinline__ double key_value(uint32_t k) {
  const uint32_t u = (k & kSign32) ? (k & ~kSign32) : ~k;
  return static_cast<double>(__uint_as_float(u));
}

template <class Key>
__device__ __forceinline__ void cx(Key& a, Key& b) {
  const Key lo = a < b ? a : b, hi = a < b ? b : a;
  a = lo;
  b = hi;
}

// SortNet<n>::run sorts n keys held in registers ascending, by the n-input
// network of sort_net.cuh
template <int N>
struct SortNet;
template <>
struct SortNet<1> {
  template <class Key>
  __device__ static __forceinline__ void run(Key (&)[1]) {}
};
#define REPRO_CX(i, j) cx(v[i], v[j]);
#define REPRO_DEFINE_NET(n)                                   \
  template <>                                                 \
  struct SortNet<n> {                                         \
    template <class Key>                                      \
    __device__ static __forceinline__ void run(Key (&v)[n]) { \
      REPRO_SORT_NET_##n(REPRO_CX)                            \
    }                                                         \
  };
REPRO_DEFINE_NET(2)
REPRO_DEFINE_NET(4)
REPRO_DEFINE_NET(8)
REPRO_DEFINE_NET(16)
REPRO_DEFINE_NET(32)
REPRO_DEFINE_NET(64)
#undef REPRO_DEFINE_NET
#undef REPRO_CX

// j / q for the int8 scale index: 32-bit while both fit
__device__ __forceinline__ int64_t div_idx(int64_t j, int64_t q) {
  if (((j | q) >> 31) == 0)
    return static_cast<uint32_t>(j) / static_cast<uint32_t>(q);
  return j / q;
}

// Columns of a stage: W = kThreads * (1, 2, 4 or 8), the most that keeps
// a stage near kStageTarget bytes.
int reg_width(int C, int isz) {
  int per = 1;
  while (per < 8 && 2 * per * kThreads * C * isz <= kStageTarget) per *= 2;
  return per * kThreads;
}

// the register path's key modes
enum Mode {
  kNarrow = 0,      // 32-bit keys of the decoded fp32 values
  kNarrowBase = 1,  // the same, the fp64 base added after the sort
  kWide = 2,        // 64-bit keys (fp64 payloads, base added first)
};

// The C keys of a column from its stage slice `col` (pad keys above C):
// 32-bit keys of the decoded values, or 64-bit keys of the decoded values
// plus the base b when add_base.
template <int KIND, int CMAX, class Key>
__device__ __forceinline__ void load_keys(Key (&v)[CMAX], const char* col,
                                          int S, int a0, int d, int C,
                                          const float (&scache)[CMAX],
                                          bool add_base, double b) {
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < C) {
      const char* p = col + c * S + ((a0 + c * d) & 15);
      const float sc = KIND == kInt8 ? scache[c] : 0.0f;
      if constexpr (sizeof(Key) == 8) {
        double x = decode_at<KIND>(p, sc);
        if (add_base) x = __dadd_rn(x, b);
        v[c] = to_key(x);
      } else {
        v[c] = to_key32(decode32_at<KIND>(p, sc));
      }
    } else {
      v[c] = sizeof(Key) == 8 ? Key(kPadKey) : Key(kPadKey32);
    }
  }
}

// The reduction of a column's sorted keys: the median (ranks lo and hi, NaN
// if the column holds a NaN) or the sum of ranks [trim_k, C - trim_k) from
// +0.0, in order.  A key's value is widened to fp64, plus b when add_b.
template <int CMAX, class Key>
__device__ __forceinline__ double walk(const Key (&v)[CMAX], int C,
                                       int median, int trim_k, bool add_b,
                                       double b) {
  constexpr Key nan_key = sizeof(Key) == 8 ? Key(kNaNKey) : Key(kNaNKey32);
  const auto value = [&](Key k) {
    const double x = key_value(k);
    return add_b ? __dadd_rn(x, b) : x;
  };
  double a = 0.0;  // numpy's +0.0 identity
  if (median) {
    // pick the keys of ranks lo, hi and C - 1 with integer selects, then
    // widen only the two that are added
    const int lo = (C - 1) / 2, hi = C / 2;  // equal when C is odd
    Key klo = v[0], khi = v[0], klast = v[0];
#pragma unroll
    for (int c = 1; c < CMAX; ++c) {
      if (c == lo) klo = v[c];
      if (c == hi) khi = v[c];
      if (c == C - 1) klast = v[c];
    }
    a = __dadd_rn(a, value(klo));
    if (hi != lo) a = __dmul_rn(__dadd_rn(a, value(khi)), 0.5);
    if (klast == nan_key) a = from_key(kNaNKey);  // NaNs sort last
  } else {
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c >= trim_k && c < C - trim_k) a = __dadd_rn(a, value(v[c]));
  }
  return a;
}

template <int KIND, int CMAX, int MODE>
__global__ void __launch_bounds__(kThreads)
    sort_reduce_kernel(const char* __restrict__ data, const char* end,
                       const float* __restrict__ scales, int64_t qchunk,
                       int64_t nscales, const double* __restrict__ base,
                       double* __restrict__ out, int C, int median,
                       int trim_k, int64_t N, int W) {
  constexpr int isz = repro::kItemSize<KIND>;
  extern __shared__ __align__(16) char ring[];
  const int S = repro::stage_stride(W, isz);
  const int stage_bytes = C * S;
  // row c's stage offset is c*S + ((a0 + c*d) & 15) (stage.cuh row_off)
  const int a0 = static_cast<int>(reinterpret_cast<uintptr_t>(data) & 15);
  const int d = static_cast<int>((static_cast<uint64_t>(N) * isz) & 15);
  const int64_t nst = (N + W - 1) / W;
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int64_t mine = nst > first ? (nst - 1 - first) / step + 1 : 0;
  float scache[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) scache[c] = 0.0f;
  int64_t sjc = -1;
#pragma unroll 1
  for (int p = 0; p < repro::kStages - 1; ++p) {
    if (p < mine)
      repro::load_stage(ring + p * stage_bytes, data, end, C, N, isz,
                        (first + p * step) * W, S);
    repro::cp_async_commit();
  }
#pragma unroll 1
  for (int64_t i = 0; i < mine; ++i) {
    repro::cp_async_wait_ring();
    __syncthreads();  // stage i landed; every thread is done with i - 1
    const int64_t nxt = i + repro::kStages - 1;
    if (nxt < mine)
      repro::load_stage(ring + (nxt % repro::kStages) * stage_bytes, data,
                        end, C, N, isz, (first + nxt * step) * W, S);
    repro::cp_async_commit();
    const char* sb = ring + (i % repro::kStages) * stage_bytes;
    const int64_t j0 = (first + i * step) * W;
#pragma unroll 1
    for (int jj = threadIdx.x; jj < W; jj += kThreads) {
      const int64_t j = j0 + jj;
      if (j >= N) break;
      const char* col = sb + jj * isz;
      if constexpr (KIND == kInt8) {
        const int64_t sj = div_idx(j, qchunk);
        if (sj != sjc) {
          sjc = sj;
#pragma unroll
          for (int c = 0; c < CMAX; ++c)
            if (c < C) scache[c] = __ldg(scales + c * nscales + sj);
        }
      }
      double a;
      if constexpr (MODE == kNarrow) {
        uint32_t v[CMAX];
        load_keys<KIND>(v, col, S, a0, d, C, scache, false, 0.0);
        SortNet<CMAX>::run(v);
        a = walk(v, C, median, trim_k, false, 0.0);
      } else if constexpr (MODE == kNarrowBase) {
        const double b = base[j];
        uint32_t v[CMAX];
        load_keys<KIND>(v, col, S, a0, d, C, scache, false, 0.0);
        if (isfinite(b)) {
          // x -> fl(x + b) is non-decreasing for a finite b, and keeps a
          // NaN a NaN: the order of the decoded values is an order of the
          // based values, and equal reals (+-0 at most) reduce alike
          SortNet<CMAX>::run(v);
          a = walk(v, C, median, trim_k, true, b);
        } else {
          // every based value is b (+-inf) or NaN (x NaN, x = -b, or b
          // NaN); NaNs sort last, so a NaN is reduced iff the median's
          // column holds one, or more than the trim_k trimmed at the top
          int nans = 0;
#pragma unroll
          for (int c = 0; c < CMAX; ++c)
            if (c < C)
              nans += v[c] == kNaNKey32 || b != b || key_value(v[c]) == -b;
          a = nans > (median ? 0 : trim_k) ? from_key(kNaNKey) : b;
        }
      } else {  // fp64 payloads: 64-bit keys of the based values
        const double b = base != nullptr ? base[j] : 0.0;
        uint64_t v[CMAX];
        load_keys<KIND>(v, col, S, a0, d, C, scache, base != nullptr, b);
        SortNet<CMAX>::run(v);
        a = walk(v, C, median, trim_k, false, 0.0);
      }
      // a NaN result (a NaN row kept, or inf - inf) as the canonical quiet
      // NaN
      out[j] = a != a ? from_key(kNaNKey) : a;
    }
  }
  repro::cp_async_wait_all();
}

template <int KIND, int CMAX, int MODE>
cudaError_t launch_reg(const void* data, const float* scales, int64_t qchunk,
                       int64_t nscales, const double* base, double* out,
                       int C, int median, int trim_k, int64_t N,
                       cudaStream_t s) {
  constexpr int isz = repro::kItemSize<KIND>;
  const auto kernel = sort_reduce_kernel<KIND, CMAX, MODE>;
  const int W = reg_width(C, isz);
  const int smem = repro::kStages * C * repro::stage_stride(W, isz);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  // a persistent grid: as many CTAs as the card holds at once
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  const int64_t nst = (N + W - 1) / W;
  const int64_t grid =
      std::max<int64_t>(1, std::min<int64_t>(nst, int64_t(sms) * per_sm));
  const char* d = static_cast<const char*>(data);
  kernel<<<static_cast<unsigned int>(grid), kThreads, smem, s>>>(
      d, d + static_cast<int64_t>(C) * N * isz, scales, qchunk, nscales, base,
      out, C, median, trim_k, N, W);
  return cudaGetLastError();
}

template <int KIND, int MODE>
cudaError_t launch_bucket(const void* data, const float* scales,
                          int64_t qchunk, int64_t nscales,
                          const double* base, double* out, int C, int median,
                          int trim_k, int64_t N, cudaStream_t s) {
#define REPRO_LAUNCH(cmax)                                                  \
  return launch_reg<KIND, cmax, MODE>(data, scales, qchunk, nscales, base, \
                                      out, C, median, trim_k, N, s)
  if (C <= 1) REPRO_LAUNCH(1);
  if (C <= 2) REPRO_LAUNCH(2);
  if (C <= 4) REPRO_LAUNCH(4);
  if (C <= 8) REPRO_LAUNCH(8);
  if (C <= 16) REPRO_LAUNCH(16);
  if (C <= 32) REPRO_LAUNCH(32);
  REPRO_LAUNCH(64);
#undef REPRO_LAUNCH
}

// the register path: 32-bit keys unless the payload is fp64
template <int KIND>
cudaError_t launch_kind(const void* data, const float* scales, int64_t qchunk,
                        int64_t nscales, const double* base, double* out,
                        int C, int median, int trim_k, int64_t N,
                        cudaStream_t s) {
  if constexpr (KIND == kF64) {
    return launch_bucket<KIND, kWide>(data, scales, qchunk, nscales, base,
                                      out, C, median, trim_k, N, s);
  } else {
    if (base != nullptr)
      return launch_bucket<KIND, kNarrowBase>(data, scales, qchunk, nscales,
                                              base, out, C, median, trim_k,
                                              N, s);
    return launch_bucket<KIND, kNarrow>(data, scales, qchunk, nscales, base,
                                        out, C, median, trim_k, N, s);
  }
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
  return launch_kind<KIND>(data, scales, qchunk, nscales, base, out, C,
                           median, trim_k, N, s);
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
