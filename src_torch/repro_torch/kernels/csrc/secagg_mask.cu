// secagg_mask: the SecAgg upload's fused quantize + pairwise mask,
//   out[j] = int32(sat(round_half_even(f32(x[j]) * w * 2^bits)))
//            + sum_p masks[p][j]          (mod 2^32)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/secagg_mask.py:36
// (secagg_mask, pallas_call at :50, body _kernel :25-33).  Same function,
// exactly:
//   - the product is rounded in fp32 left to right, (x * w) * 2^bits, with
//     __fmul_rn (the source is also built with -fmad=false);
//   - rintf rounds half to even, as jnp.round does;
//   - the reference clips to [-2^31, 2^31 - 1] in fp32, where 2^31 - 1
//     rounds to 2^31, and then converts with saturation: an overflow gives
//     2147483647, -inf gives -2147483648 and NaN gives 0.  __float2int_rn
//     (cvt.rni.s32.f32) saturates and maps NaN to 0 in the same way;
//   - the masks are added as uint32, so the sum wraps mod 2^32 with no
//     signed overflow, as the TPU's int32 adds wrap.
// P = 0 passes no masks (the reference pads it to one row of zeros).
//
// What bounds it: bytes.  Each element reads x (4 B) and P masks (4 B each)
// and writes 4 B: (8 + 4P) * N bytes, against a few fp32 and integer ops.
//
// Design: one thread per element j, looping over the P masks; neighbouring
// threads read neighbouring elements of x and of each mask row, so every
// load is coalesced, and the P loads of a thread are independent.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
secagg_mask_kernel(const float* __restrict__ x, const int* __restrict__ masks,
                   int* __restrict__ out, float w, float scale, int64_t P,
                   int64_t N) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const float v = __fmul_rn(__fmul_rn(x[j], w), scale);
  unsigned int s = static_cast<unsigned int>(__float2int_rn(rintf(v)));
#pragma unroll 4
  for (int64_t p = 0; p < P; ++p)
    s += static_cast<unsigned int>(masks[p * N + j]);
  out[j] = static_cast<int>(s);
}

}  // namespace

// x: (N,) fp32; masks: (P, N) int32, contiguous (null when P = 0); out: (N,)
// int32; w: the weight as fp32; scale: 2^bits as fp32.  Device pointers;
// launches on `stream` and does not synchronise; returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_secagg_mask(const void* x, const void* masks, void* out,
                                 float w, float scale, long long P,
                                 long long N, void* stream) {
  if (N <= 0 || P < 0 || (P > 0 && masks == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (N + kThreads - 1) / kThreads;
  secagg_mask_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(masks),
      static_cast<int*>(out), w, scale, P, N);
  return static_cast<int>(cudaGetLastError());
}
