// scatter_wsum: the 0xF5 sparse-delta fold, acc[dest[i]] += w * dequant(v[i])
// in fp64, in place, for Hopper (sm_90a).
//
// Replaces repro/kernels/agg_reduce.py:396 (scatter_wsum, with its jitted
// _sparse_contrib at :371), which is not a pallas_call: the reference runs
// the dequantize-and-weight chain as an XLA graph and the scatter-add on the
// host.  Here both run in one kernel on the device accumulator.  It must be
// BITWISE equal to the numpy engine's sparse fold
// (repro_torch/fl/agg_kernels.py, backend="numpy", _scatter_spans):
//   - int8 values: r = (double) fp32(q * scale[(pos0 + i) / qchunk]), one
//     fp32 rounding of the exact product (__fmul_rn), as _dequant_q8 does in
//     fp64 and then rounds through fp32; fp32 values widen exactly;
//   - acc[d] = __dadd_rn(acc[d], __dmul_rn(r, w)), as numpy multiplies into
//     a scratch and then adds.
// Built with -fmad=false and without --use_fast_math (subnormals kept).
//
// The destinations of one launch are unique (a sparse delta's coordinates
// are sorted and unique, and a slice is a run), so each is read and written
// by one thread and no atomics are needed; the result does not depend on
// how the threads are scheduled.  The wrapper checks that every destination
// lies inside acc before it launches.
//
// What bounds it: bytes, and at the main path's sizes the launch itself.
// Per traveled coordinate it reads the value (1 or 4 B), its index (8 B;
// none for a slice) and acc (8 B) and writes acc (8 B), plus the scales
// (4 B per qchunk values): about 25 B for int8 values at indices, 17 B in a
// slice.  The reads of acc at sorted but scattered indices touch one 32-byte
// sector per coordinate when the coordinates are sparse.
//
// Design: one thread per traveled coordinate i; neighbouring threads read
// neighbouring values and indices (coalesced).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool Q8, bool SLICE>
__global__ void __launch_bounds__(kThreads)
scatter_wsum_kernel(double* __restrict__ acc,
                    const int64_t* __restrict__ dest, int64_t d0,
                    const void* __restrict__ vals,
                    const float* __restrict__ scales, int64_t qchunk,
                    int64_t pos0, double w, int64_t nnz) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nnz) return;
  double r;
  if constexpr (Q8) {
    const float q = static_cast<float>(static_cast<const int8_t*>(vals)[i]);
    r = static_cast<double>(__fmul_rn(q, scales[(pos0 + i) / qchunk]));
  } else {
    r = static_cast<double>(static_cast<const float*>(vals)[i]);
  }
  const int64_t d = SLICE ? d0 + i : dest[i];
  acc[d] = __dadd_rn(acc[d], __dmul_rn(r, w));
}

template <bool Q8, bool SLICE>
void launch(double* acc, const int64_t* dest, int64_t d0, const void* vals,
            const float* scales, int64_t qchunk, int64_t pos0, double w,
            int64_t nnz, cudaStream_t stream) {
  const int64_t blocks = (nnz + kThreads - 1) / kThreads;
  scatter_wsum_kernel<Q8, SLICE>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          acc, dest, d0, vals, scales, qchunk, pos0, w, nnz);
}

}  // namespace

// acc: fp64, updated in place; dest: (nnz,) int64 indices into acc, or null
// for the slice acc[d0 : d0 + nnz]; vals: (nnz,) int8 (q8 = 1, with scales:
// the fp32 scales of the whole packed stream, value i using scale
// (pos0 + i) / qchunk) or fp32 (q8 = 0, scales null).  Device pointers;
// launches on `stream` and does not synchronise; returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_scatter_wsum(void* acc, const void* dest, long long d0,
                                  const void* vals, int q8,
                                  const void* scales, long long qchunk,
                                  long long pos0, double w, long long nnz,
                                  void* stream) {
  if (nnz <= 0 || (q8 && (scales == nullptr || qchunk <= 0 || pos0 < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* a = static_cast<double*>(acc);
  auto* d = static_cast<const int64_t*>(dest);
  auto* s = static_cast<const float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q8) {
    if (d == nullptr)
      launch<true, true>(a, d, d0, vals, s, qchunk, pos0, w, nnz, st);
    else
      launch<true, false>(a, d, d0, vals, s, qchunk, pos0, w, nnz, st);
  } else {
    if (d == nullptr)
      launch<false, true>(a, d, d0, vals, s, qchunk, pos0, w, nnz, st);
    else
      launch<false, false>(a, d, d0, vals, s, qchunk, pos0, w, nnz, st);
  }
  return static_cast<int>(cudaGetLastError());
}
