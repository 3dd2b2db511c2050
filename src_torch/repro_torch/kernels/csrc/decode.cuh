// decode.cuh: the wire decode shared by the aggregation kernels.
//
// One payload element of a (C, N) client stack to fp64, exactly as the
// numpy engine's f64_chunk reads it (repro_torch/fl/flat.py):
//   - int8: (double) fp32(q * scale[c][j / qchunk])  (__fmul_rn: one fp32
//     rounding, no flush to zero of subnormal products);
//   - fp16, bf16, fp32 widen exactly (bf16 is the high half of an fp32);
//   - fp64 as it is.
// A delta payload's fp64 base is added by the caller (__dadd_rn).
#pragma once

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro {

enum Kind { kInt8 = 0, kF16 = 1, kBF16 = 2, kF32 = 3, kF64 = 4 };

template <int KIND>
__device__ __forceinline__ double decode(const void* __restrict__ data,
                                         int64_t idx,
                                         const float* __restrict__ scales,
                                         int64_t sidx) {
  if constexpr (KIND == kInt8) {
    const float q = static_cast<float>(static_cast<const int8_t*>(data)[idx]);
    return static_cast<double>(__fmul_rn(q, scales[sidx]));
  } else if constexpr (KIND == kF16) {
    return static_cast<double>(
        __half2float(static_cast<const __half*>(data)[idx]));
  } else if constexpr (KIND == kBF16) {
    const unsigned int u = static_cast<const unsigned short*>(data)[idx];
    return static_cast<double>(__uint_as_float(u << 16));
  } else if constexpr (KIND == kF32) {
    return static_cast<double>(static_cast<const float*>(data)[idx]);
  } else {
    return static_cast<const double*>(data)[idx];
  }
}

}  // namespace repro
