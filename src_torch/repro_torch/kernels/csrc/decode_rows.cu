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
// scales, 1/qchunk per element, and the fp64 base) and written once as
// fp64.  Design: a grid-stride loop over the R*N elements, one thread per
// element, consecutive threads on consecutive columns.
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
constexpr int64_t kMaxBlocks = 132 * 16;

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    decode_rows_kernel(const void* __restrict__ data,
                       const float* __restrict__ scales, int64_t qchunk,
                       int64_t nscales, const double* __restrict__ base,
                       double* __restrict__ out, int64_t R, int64_t N) {
  const int64_t total = R * N;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = e / N;
    const int64_t j = e - r * N;
    double x = decode<KIND>(data, e, scales,
                            r * nscales + (KIND == kInt8 ? j / qchunk : 0));
    if (base != nullptr) x = __dadd_rn(x, base[j]);
    out[e] = x;
  }
}

template <int KIND>
void launch(const void* data, const float* scales, int64_t qchunk,
            int64_t nscales, const double* base, double* out, int64_t R,
            int64_t N, cudaStream_t s) {
  const int64_t blocks = (R * N + kThreads - 1) / kThreads;
  decode_rows_kernel<KIND>
      <<<static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks),
         kThreads, 0, s>>>(data, scales, qchunk, nscales, base, out, R, N);
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
  if (N <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
