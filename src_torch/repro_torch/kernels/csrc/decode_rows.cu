// decode_rows: the wire decode of a (R, N) client payload stack into rows
// [row0, row0 + R) of a (C, N) fp64 stack, for Hopper (sm_90a).
//
// The robust reductions (sort_reduce, gram) take one payload stack of one
// codec.  A round whose clients differ in codec, dtype, int8 scale window or
// delta base is decoded run by run into one fp64 stack with this kernel, and
// the reduction then runs once on that stack as float64.  It is the decode
// half of the reference's per-client read, the numpy engine's f64_chunk
// (repro/fl/flat.py:466 and :595, called by _rowstack in
// repro/fl/agg_kernels.py:819),
// which the reference's Pallas path leaves to the host for such a round;
// the element arithmetic is decode.cuh's, the one the reductions use:
//   out[row0 + r][j] = decode(data[r][j]) (+ base[j], one __dadd_rn)
// with no other operation, so signed zeros and NaNs come through as the
// reductions would have seen them.
//
// What bounds it: HBM bytes.  Each element is read once (plus the int8
// scales, 1/qchunk per element, and the fp64 base, once for all rows) and
// written once as fp64.
//
// Design: division-free rows of 16-byte chunks, staged per warp so that the
// fp64 side is coalesced, and the base read once for all the rows.
// - A row's chunks start at its first 16-byte aligned element, `head` (row
//   r starts r*N*itemsize into the stack); the elements before it and past
//   its last whole chunk are a scalar head and tail (fewer than 16 /
//   itemsize each), written by 32 threads of the group's first CTA.
// - Phase 1: each lane loads one chunk with one 16-byte load (evict-first:
//   it is read once), decodes it and stages the values (fp32, or fp64 for
//   fp64) in its warp's shared memory.  An int8 chunk's scale index is
//   divided out once (j / qchunk) and then stepped by a counter at each
//   qchunk boundary in the chunk (qchunk may be 3).
// - Phase 2: the warp reads its staged elements back in order, widens
//   them (adds the base) and writes the fp64 row lane after lane (256
//   bytes a warp store, evict-first; the output's alignment plays no
//   part).
// - Without a base, a warp's tile is 32 chunks of one row; one row per
//   grid row, the tiles split over one wave of CTAs.
// - With a base, a warp's tile is 31 chunks wide (31 V elements; V = 16 /
//   itemsize: 16 int8, 8 fp16 / bf16, 4 fp32, 2 fp64), so that 32 chunks
//   of any row cover it, and the warp walks it through all the rows of its
//   group with the tile's base in registers: the base is read from HBM
//   once, not once per row.  The next row's chunk is loaded before phase
//   2.  CTAs go along the columns, one wave; the rows split into groups
//   only where the columns give less than a wave.
// Measured slower on the card (PERF.md): a thread writing its own chunk's
// fp64 values as double2 (half-sector stores scattered across the warp);
// double2 pairs in phase 2; the base walk without a base (54 registers
// against 40: fewer CTAs resident).
#include <cstdint>
#include <type_traits>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

using repro::decode;
using repro::kBF16;
using repro::kF16;
using repro::kF32;
using repro::kF64;
using repro::kInt8;
using repro::kItemSize;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// what a warp stages a decoded element as: the fp32 every kind but fp64
// decodes to (it widens to fp64 exactly), fp64 itself
template <int KIND>
using Staged = std::conditional_t<KIND == kF64, double, float>;

// element i of a 16-byte chunk (four little-endian words), decoded as
// decode.cuh's decode<KIND> does before its widening; `scale` is an int8
// element's
template <int KIND>
__device__ __forceinline__ Staged<KIND> chunk_elem(const unsigned int (&u)[4],
                                                   int i, float scale) {
  if constexpr (KIND == kInt8) {
    const auto q = static_cast<signed char>(u[i / 4] >> (8 * (i % 4)));
    return __fmul_rn(static_cast<float>(q), scale);
  } else if constexpr (KIND == kF16) {
    const auto bits =
        static_cast<unsigned short>(u[i / 2] >> (16 * (i % 2)));
    return __half2float(__ushort_as_half(bits));
  } else if constexpr (KIND == kBF16) {
    const unsigned int bits = (u[i / 2] >> (16 * (i % 2))) & 0xFFFFu;
    return __uint_as_float(bits << 16);
  } else if constexpr (KIND == kF32) {
    return __uint_as_float(u[i]);
  } else {
    return __hiloint2double(static_cast<int>(u[2 * i + 1]),
                            static_cast<int>(u[2 * i]));
  }
}

// where element e of a warp's stage lies: one pad word per 32, so the
// lanes' writes of their chunks and their reads of elements lane + 32 q
// fall in distinct banks
__device__ __forceinline__ int staged_at(int e) { return e + (e >> 5); }

// One row's split: its chunks start at its first 16-byte aligned element,
// `head` (fewer than 16 / itemsize: row r starts r*N*itemsize into the
// stack); `nch` whole chunks follow, then the tail up to N.
template <int KIND>
struct Row {
  const char* p;
  int64_t head, nch;

  __device__ __forceinline__ Row(const char* data, int64_t r, int64_t N) {
    constexpr int kIsz = kItemSize<KIND>;
    p = data + r * N * kIsz;
    const int64_t lead = static_cast<int64_t>(
        ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / kIsz);
    head = lead < N ? lead : N;
    nch = (N - head) / (16 / kIsz);
  }
  // the first of the 32 chunks that cover elements [J, J + 31 V)
  __device__ __forceinline__ int64_t first(int64_t J) const {
    return J >= head ? (J - head) / (16 / kItemSize<KIND>) : -1;
  }
  __device__ __forceinline__ uint4 chunk(int64_t k) const {
    return k >= 0 && k < nch
               ? __ldcs(reinterpret_cast<const uint4*>(
                           p + head * kItemSize<KIND>) + k)
               : make_uint4(0, 0, 0, 0);
  }
};

// Phase 1: lane `lane` decodes chunk k of row r (its elements j, j + 1,
// ... from `u`) into stage slots lane * V + i.
template <int KIND>
__device__ __forceinline__ void stage_chunk(Staged<KIND>* st, int lane,
                                            const uint4 v, int64_t j,
                                            const float* __restrict__ srow,
                                            int64_t qchunk, bool idx32) {
  constexpr int V = 16 / kItemSize<KIND>;
  const unsigned int u[4] = {v.x, v.y, v.z, v.w};
  if constexpr (KIND == kInt8) {
    // the scale window of element j, then a counter over its boundaries
    int64_t s = idx32 ? static_cast<int64_t>(static_cast<uint32_t>(j) /
                                             static_cast<uint32_t>(qchunk))
                      : j / qchunk;
    int64_t next = (s + 1) * qchunk;
    float sc = __ldg(srow + s);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (j + i == next) {
        ++s;
        next += qchunk;
        sc = __ldg(srow + s);
      }
      st[staged_at(lane * V + i)] = chunk_elem<KIND>(u, i, sc);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      st[staged_at(lane * V + i)] = chunk_elem<KIND>(u, i, 0.f);
  }
}

template <int KIND, bool BASE>
__global__ void __launch_bounds__(kThreads)
    decode_rows_kernel(const char* __restrict__ data,
                       const float* __restrict__ scales, int64_t qchunk,
                       int64_t nscales, const double* __restrict__ base,
                       double* __restrict__ out, int64_t R, int64_t N,
                       int64_t rows_per_group, bool idx32) {
  constexpr int V = 16 / kItemSize<KIND>;  // elements per chunk
  __shared__ Staged<KIND> stage[kWarps][32 * V + V];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Staged<KIND>* st = stage[warp];
  // the rows of this CTA's group, and the CTA's place along the columns
  const int64_t g = BASE ? blockIdx.y : blockIdx.x;
  const unsigned int cta = BASE ? blockIdx.x : blockIdx.y;
  const unsigned int ctas = BASE ? gridDim.x : gridDim.y;
  const int64_t r0 = g * rows_per_group;
  const int64_t r1 = r0 + rows_per_group < R ? r0 + rows_per_group : R;
  if (cta == 0 && threadIdx.x < 32) {  // the rows' heads and tails
    for (int64_t r = r0; r < r1; ++r) {
      const Row<KIND> row(data, r, N);
      const int64_t body_end = row.head + row.nch * V;
      const int64_t j = lane < 16 ? lane : body_end + (lane - 16);
      if (lane < 16 ? j < row.head : j < N) {
        double x = decode<KIND>(row.p, j, scales + r * nscales,
                                KIND == kInt8 ? j / qchunk : 0);
        if (BASE) x = __dadd_rn(x, base[j]);
        out[r * N + j] = x;
      }
    }
  }
  if constexpr (!BASE) {
    // a warp takes 32 chunks of one row at a time; phase 2 writes their
    // elements lane after lane
    for (int64_t r = r0; r < r1; ++r) {
      const Row<KIND> row(data, r, N);
      double* op = out + r * N + row.head;
      for (int64_t c0 = (static_cast<int64_t>(cta) * kWarps + warp) * 32;
           c0 < row.nch; c0 += static_cast<int64_t>(ctas) * kWarps * 32) {
        __syncwarp();  // the last tile's reads of the stage are done
        const int64_t k = c0 + lane;
        if (k < row.nch)
          stage_chunk<KIND>(st, lane, row.chunk(k), row.head + k * V,
                            scales + r * nscales, qchunk, idx32);
        __syncwarp();
        const int nvalid =
            static_cast<int>(row.nch - c0 < 32 ? row.nch - c0 : 32) * V;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int e = lane + 32 * q;
          if (e < nvalid)
            __stcs(op + c0 * V + e, static_cast<double>(st[staged_at(e)]));
        }
      }
    }
  } else {
    // a warp takes the elements [J, J + 31 V) of every row of its group,
    // the tile's base in registers, read once for all the rows
    constexpr int kSpan = 31 * V;
    for (int64_t J = (static_cast<int64_t>(cta) * kWarps + warp) * kSpan;
         J < N; J += static_cast<int64_t>(ctas) * kWarps * kSpan) {
      double bv[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int64_t j = J + lane + 32 * q;
        bv[q] = lane + 32 * q < kSpan && j < N ? __ldg(base + j) : 0.0;
      }
      Row<KIND> nxt(data, r0, N);
      uint4 v = nxt.chunk(nxt.first(J) + lane);
      for (int64_t r = r0; r < r1; ++r) {
        const Row<KIND> row = nxt;
        const int64_t k0 = row.first(J);
        __syncwarp();  // the last row's reads of the stage are done
        if (k0 + lane >= 0 && k0 + lane < row.nch)
          stage_chunk<KIND>(st, lane, v, row.head + (k0 + lane) * V,
                            scales + r * nscales, qchunk, idx32);
        __syncwarp();
        if (r + 1 < r1) {  // the next row's chunk in flight during phase 2
          nxt = Row<KIND>(data, r + 1, N);
          v = nxt.chunk(nxt.first(J) + lane);
        }
        // phase 2: the tile's elements of row r in order, lane after lane
        const int d = static_cast<int>(J - (row.head + k0 * V));
        const int64_t body_end = row.head + row.nch * V;
        double* orow = out + r * N;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int e = lane + 32 * q;
          const int64_t j = J + e;
          if (e < kSpan && j >= row.head && j < body_end)
            __stcs(orow + j, __dadd_rn(static_cast<double>(
                                           st[staged_at(e + d)]),
                                       bv[q]));
        }
      }
    }
  }
}

template <int KIND, bool BASE>
void launch_kernel(const void* data, const float* scales, int64_t qchunk,
                   int64_t nscales, const double* base, double* out,
                   int64_t R, int64_t N, cudaStream_t s) {
  constexpr int kSpan = 31 * (16 / kItemSize<KIND>);
  // one wave: as many CTAs as the card holds at once
  static const int64_t resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decode_rows_kernel<KIND, BASE>, kThreads, 0);
    return static_cast<int64_t>(sms > 0 && per_sm > 0 ? sms * per_sm : 1);
  }();
  // With a base: CTAs along the columns (grid x), one wave, and the rows
  // split into groups (grid y) only where the columns give less than a
  // wave.  Without one: a group is a row (grid x, so a tile's rows are
  // adjacent in launch order) and the wave is split over the rows (grid
  // y; a warp's tile is 32 chunks).
  const auto clamp = [](int64_t x, int64_t hi) {
    return x < 1 ? int64_t{1} : x > hi ? hi : x;
  };
  const int64_t span = BASE ? kSpan : 32 * (16 / kItemSize<KIND>);
  const int64_t col_ctas = (N + span * kWarps - 1) / (span * kWarps);
  const int64_t groups = clamp(
      BASE ? resident / (col_ctas < resident ? col_ctas : resident) : R,
      R < (BASE ? 65535 : 0x7FFFFFFF) ? R : (BASE ? 65535 : 0x7FFFFFFF));
  const int64_t rows_per_group = (R + groups - 1) / groups;
  const int64_t ng = (R + rows_per_group - 1) / rows_per_group;
  const int64_t nc = clamp(BASE ? resident : resident / ng,
                           BASE || col_ctas < 65535 ? col_ctas : 65535);
  const bool idx32 = N <= 0xFFFFFFFFLL && qchunk <= 0xFFFFFFFFLL;
  decode_rows_kernel<KIND, BASE>
      <<<BASE ? dim3(static_cast<unsigned int>(nc),
                     static_cast<unsigned int>(ng))
              : dim3(static_cast<unsigned int>(ng),
                     static_cast<unsigned int>(nc)),
         kThreads, 0, s>>>(static_cast<const char*>(data), scales, qchunk,
                           nscales, base, out, R, N, rows_per_group, idx32);
}

template <int KIND>
void launch(const void* data, const float* scales, int64_t qchunk,
            int64_t nscales, const double* base, double* out, int64_t R,
            int64_t N, cudaStream_t s) {
  if (base != nullptr)
    launch_kernel<KIND, true>(data, scales, qchunk, nscales, base, out, R, N,
                              s);
  else
    launch_kernel<KIND, false>(data, scales, qchunk, nscales, base, out, R,
                               N, s);
}

}  // namespace

// Plain C entry point, bound with ctypes.  data: (R, N) contiguous payload
// of `kind`; scales: (R, nscales) fp32 (int8 only, else null); base: (N,)
// fp64 or null; out: the first of R contiguous rows of N fp64 (row row0 of
// the caller's stack).  All pointers are device pointers; the launch goes on
// `stream` and does not synchronise.  Returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int repro_decode_rows(int kind, const void* data,
                                 const float* scales, long long qchunk,
                                 long long nscales, const double* base,
                                 double* out, long long R, long long N,
                                 void* stream) {
  if (N <= 0 || R <= 0 || R > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kInt8 && (scales == nullptr || qchunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kInt8:
      launch<kInt8>(data, scales, qchunk, nscales, base, out, R, N, s);
      break;
    case kF16:
      launch<kF16>(data, scales, qchunk, nscales, base, out, R, N, s);
      break;
    case kBF16:
      launch<kBF16>(data, scales, qchunk, nscales, base, out, R, N, s);
      break;
    case kF32:
      launch<kF32>(data, scales, qchunk, nscales, base, out, R, N, s);
      break;
    case kF64:
      launch<kF64>(data, scales, qchunk, nscales, base, out, R, N, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
