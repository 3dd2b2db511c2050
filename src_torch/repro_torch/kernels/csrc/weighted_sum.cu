// weighted_sum: the server's FedAvg fold, (acc +) sum_c w[c] * decode(data[c]),
// fused in fp64 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/agg_reduce.py:200
// (weighted_sum, pallas_call at :247, body _wsum_kernel :174 and
// _decode_tile :92).  It must be BITWISE equal to the numpy engine
// (repro_torch/fl/agg_kernels.py, backend="numpy"):
//   - decode(int8)  = (double) fp32(q * scale[c][j / qchunk])  (__fmul_rn),
//     fp16/bf16/fp32/fp64 widen exactly;
//   - a delta payload adds its fp64 base: v = __dadd_rn(v, base[j]);
//   - the weight multiplies: v = __dmul_rn(v, w[c]);
//   - clients fold in order: a = __dadd_rn(a, v), starting from acc[j] when
//     an accumulator is given, else from client 0's term (as numpy's
//     np.multiply(x0, w0, out=a) does).
// Built with -fmad=false and without --use_fast_math (so -ftz=false: int8 x
// fp32 products can be subnormal), and the _rn intrinsics pin the rounding
// on top of the flag.
//
// fp32 tiles (tile32 = 1; the reference's tile_dtype="float32",
// _decode_tile :92-118 and _wsum_kernel :174-197, which its sharded fold
// selects): the element is decoded to fp32 (int8: fp32(q * scale); fp16,
// bf16, fp32 exactly; fp64 rounded to fp32), multiplied by fp32(w[c]) in
// fp32 (__fmul_rn), widened, and added to the fp64 carry (__dadd_rn), which
// starts from acc[j] or from client 0's term.  A base is refused (the
// reference's check at :230-232: the sharded fold defers it to finalize).
// The fp32 mode moves the same bytes as the fp64 one, so on this card it
// is bound the same way; on the TPU it saved emulated fp64 arithmetic.
//
// What bounds it: HBM bytes.  Each column reads C payload elements, one fp64
// weight broadcast per client, the int8 scales (1/qchunk per element), the
// fp64 base and accumulator when given, and writes one fp64 out:
// C*N*itemsize + N*8 (+ N*8 acc + N*8 base) + scales.  The fp64 arithmetic
// is 2-3 flops per element per client, far below the card's fp64 rate.
//
// Design: one thread per column j (64-bit indices: C*N passes 2^31 at
// 50M x 16), clients folded sequentially in a loop inside the thread, so
// the order is fixed and no cross-thread reduction exists.  Neighbouring
// threads read neighbouring elements of each client row, so every load of
// the stack is coalesced.  The stack is one contiguous (C, N) device tensor
// rather than an array of C row pointers: the wrapper copies each arrival's
// host payload straight into its row (no host-side stack), the kernel takes
// one base pointer and a row stride, and no device-side pointer table has to
// be built and uploaded per launch.  Vectorised loads, cp.async/TMA staging
// and overlapping the host-to-device copy with the fold are left to later
// work: the round's fold is bound by the host-to-device copy, not by this
// kernel.
#include <cstdint>
#include <cuda_runtime.h>

#include "decode.cuh"

namespace {

using repro::decode;
using repro::decode32;
using repro::kBF16;
using repro::kF16;
using repro::kF32;
using repro::kF64;
using repro::kInt8;

template <int KIND, bool HAS_BASE, bool HAS_ACC, bool TILE32>
__global__ void weighted_sum_kernel(const void* __restrict__ data,
                                    const float* __restrict__ scales,
                                    int64_t qchunk, int64_t nscales,
                                    const double* __restrict__ base,
                                    const double* __restrict__ acc,
                                    const double* __restrict__ w,
                                    double* __restrict__ out, int64_t C,
                                    int64_t N) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const double b = HAS_BASE ? base[j] : 0.0;
  const int64_t sj = KIND == kInt8 ? j / qchunk : 0;
  double a = HAS_ACC ? acc[j] : 0.0;
  for (int64_t c = 0; c < C; ++c) {
    double v;
    if constexpr (TILE32) {
      const float t = decode32<KIND>(data, c * N + j, scales, c * nscales + sj);
      v = static_cast<double>(__fmul_rn(t, __double2float_rn(w[c])));
    } else {
      v = decode<KIND>(data, c * N + j, scales, c * nscales + sj);
      if (HAS_BASE) v = __dadd_rn(v, b);
      v = __dmul_rn(v, w[c]);
    }
    a = (!HAS_ACC && c == 0) ? v : __dadd_rn(a, v);
  }
  out[j] = a;
}

template <int KIND, bool HAS_BASE, bool HAS_ACC, bool TILE32 = false>
void launch(const void* data, const float* scales, int64_t qchunk,
            int64_t nscales, const double* base, const double* acc,
            const double* w, double* out, int64_t C, int64_t N,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (N + kThreads - 1) / kThreads;
  weighted_sum_kernel<KIND, HAS_BASE, HAS_ACC, TILE32>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          data, scales, qchunk, nscales, base, acc, w, out, C, N);
}

template <int KIND>
void launch_kind(const void* data, const float* scales, int64_t qchunk,
                 int64_t nscales, const double* base, const double* acc,
                 const double* w, double* out, int64_t C, int64_t N,
                 bool tile32, cudaStream_t stream) {
  if (tile32) {  // base is null: the entry point refuses it
    if (acc != nullptr)
      launch<KIND, false, true, true>(data, scales, qchunk, nscales, base,
                                      acc, w, out, C, N, stream);
    else
      launch<KIND, false, false, true>(data, scales, qchunk, nscales, base,
                                       acc, w, out, C, N, stream);
  } else if (base != nullptr) {
    if (acc != nullptr)
      launch<KIND, true, true>(data, scales, qchunk, nscales, base, acc, w,
                               out, C, N, stream);
    else
      launch<KIND, true, false>(data, scales, qchunk, nscales, base, acc, w,
                                out, C, N, stream);
  } else {
    if (acc != nullptr)
      launch<KIND, false, true>(data, scales, qchunk, nscales, base, acc, w,
                                out, C, N, stream);
    else
      launch<KIND, false, false>(data, scales, qchunk, nscales, base, acc, w,
                                 out, C, N, stream);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  data: (C, N) contiguous payload of
// `kind`; scales: (C, nscales) fp32 (int8 only, else null); base/acc: (N,)
// fp64 or null; w: (C,) fp64; out: (N,) fp64; tile32: 1 for fp32 tiles
// (base must be null), 0 for fp64.  All pointers are device
// pointers; the launch goes on `stream` and does not synchronise.  Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int repro_weighted_sum(int kind, const void* data,
                                  const float* scales, long long qchunk,
                                  long long nscales, const double* base,
                                  const double* acc, const double* w,
                                  double* out, long long C, long long N,
                                  int tile32, void* stream) {
  if (N <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (tile32 && base != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kInt8 && (scales == nullptr || qchunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kInt8:
      launch_kind<kInt8>(data, scales, qchunk, nscales, base, acc, w, out, C,
                         N, tile32 != 0, s);
      break;
    case kF16:
      launch_kind<kF16>(data, scales, qchunk, nscales, base, acc, w, out, C,
                        N, tile32 != 0, s);
      break;
    case kBF16:
      launch_kind<kBF16>(data, scales, qchunk, nscales, base, acc, w, out, C,
                         N, tile32 != 0, s);
      break;
    case kF32:
      launch_kind<kF32>(data, scales, qchunk, nscales, base, acc, w, out, C,
                        N, tile32 != 0, s);
      break;
    case kF64:
      launch_kind<kF64>(data, scales, qchunk, nscales, base, acc, w, out, C,
                        N, tile32 != 0, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
