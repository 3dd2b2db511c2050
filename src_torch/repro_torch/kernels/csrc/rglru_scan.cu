// rglru_scan: the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over
// (B, S, W) fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py:51 (rglru_scan,
// pallas_call at :62, body _kernel :27).  Same function: from h0 (B, W),
// every h_t is written to ys (B, S, W) and the last one to h_final (B, W);
// with S = 0 there is nothing to launch (the wrapper returns h0).  The TPU
// kernel walks S in VMEM blocks with the carry in scratch; here the carry is
// one register per column and the walk over S is a loop in the thread.
//
// Rounding: every step is one rounded multiply and one rounded add
// (__fmul_rn, __fadd_rn, and the source is built with -fmad=false), so the
// result is bitwise equal to the plain twin h = a[:, t] * h + b[:, t], two
// separate PyTorch ops, on the card.  The chain stays sequential in S: a
// scan split into chunks of S would compose the a's of a chunk into one
// product first, which rounds differently from the twin.
//
// What bounds it: bytes.  At the serving shape (B 4, S 4096, W 2560) it
// reads a and b and writes ys once, 3 x 167.8 MB = 503 MB: 0.150 ms at
// 3.35 TB/s; its 2 flops per element are nothing beside that, and the
// chain itself (about 8 cycles a step, 4096 steps) is about 18 us.  With
// one thread per (b, w) column there are only 10,240 threads, so what the
// card needs is enough loads in flight from few threads (Little's law:
// 3.35 TB/s x ~0.7 us is ~2.3 MB across the card).
//
// Design: a CTA of kCols threads takes kCols adjacent columns of one batch
// row (one grid row per batch element), one thread per column.  Each thread
// streams its own column of a and b through a ring of kStages shared-memory
// stages of kSteps steps, filled by 4-byte cp.async.ca (a warp copies 128
// contiguous bytes a step, for any W and any batch or sequence stride) and
// kept kStages - 1 stages ahead of the chain: 2 x kSteps x (kStages - 1)
// loads in flight per thread, 13 MB across the card at the serving shape.
// A thread reads only the stage slots it filled itself, so cp.async's
// per-thread wait_group orders the ring and no CTA barrier is needed (a
// thread past W returns at once).  The chain reads a whole stage from
// shared memory into registers before its dependent multiply-adds, and
// each step's h is stored straight to ys (128 bytes per warp, coalesced).
// The last stage may be ragged: it copies and runs only the steps < S.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;    // columns per CTA, one thread each
constexpr int kSteps = 32;   // steps per stage
constexpr int kStages = 6;   // stages in the ring
// one stage of one CTA: kSteps rows of a, then kSteps rows of b, each row
// kCols floats (thread x at column x: conflict-free)
constexpr int kStageFloats = 2 * kSteps * kCols;
constexpr int kSmemBytes = kStages * kStageFloats * 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the kStages - 1 youngest has landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Start (not wait for) the copies of this thread's column of a and b for
// steps [t0, min(t0 + kSteps, S)) into its slots of one stage.
__device__ __forceinline__ void fill_stage(float* slot, const float* ap,
                                            const float* bp, long long ass,
                                            long long bss, int t0, int S) {
  const int n = S - t0;
  ap += t0 * ass;
  bp += t0 * bss;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    if (j < n) {
      cp_async4(slot + j * kCols, ap);
      cp_async4(slot + (kSteps + j) * kCols, bp);
    }
    ap += ass;
    bp += bss;
  }
}

__global__ void __launch_bounds__(kCols)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ ys,
                  float* __restrict__ h_final, int S, int W, long long asb,
                  long long ass, long long bsb, long long bss,
                  long long hsb) {
  extern __shared__ float ring[];
  const int w = blockIdx.x * kCols + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const float* ap = a + bi * asb + w;
  const float* bp = b + bi * bsb + w;
  float* mine = ring + threadIdx.x;
  const int nst = (S + kSteps - 1) / kSteps;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst)
      fill_stage(mine + st * kStageFloats, ap, bp, ass, bss, st * kSteps, S);
    cp_async_commit();  // empty groups keep the count
  }
  float h = h0[bi * hsb + w];
  float* yp = ys + static_cast<long long>(bi) * S * W + w;
  for (int st = 0; st < nst; ++st) {
    // refill the slot the previous stage was read from: every value read
    // there has been used by the chain, so its loads are done
    const int ahead = st + kStages - 1;
    if (ahead < nst)
      fill_stage(mine + (ahead % kStages) * kStageFloats, ap, bp, ass, bss,
                  ahead * kSteps, S);
    cp_async_commit();
    cp_async_wait_ring();  // stage st has landed
    const float* cur = mine + (st % kStages) * kStageFloats;
    const int t0 = st * kSteps;
    float* y = yp + static_cast<long long>(t0) * W;
    if (t0 + kSteps <= S) {
      float ra[kSteps], rb[kSteps];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        ra[j] = cur[j * kCols];
        rb[j] = cur[(kSteps + j) * kCols];
      }
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        h = __fadd_rn(__fmul_rn(ra[j], h), rb[j]);
        *y = h;
        y += W;
      }
    } else {  // the ragged last stage
      for (int j = 0; j < S - t0; ++j) {
        h = __fadd_rn(__fmul_rn(cur[j * kCols], h),
                      cur[(kSteps + j) * kCols]);
        *y = h;
        y += W;
      }
    }
  }
  h_final[static_cast<long long>(bi) * W + w] = h;
}

}  // namespace

// a, b: (B, S, W) fp32 at element strides (asb, ass) / (bsb, bss) for the
// batch and sequence axes, W contiguous; h0: (B, W) fp32 at batch stride
// hsb, W contiguous; ys: (B, S, W) and h_final: (B, W), contiguous.
// Launches on `stream`, does not synchronise; returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* ys, void* h_final, int B, int S, int W,
                                long long asb, long long ass, long long bsb,
                                long long bss, long long hsb, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the ring is dynamic shared memory past the 48 KB default
  const cudaError_t attr = cudaFuncSetAttribute(
      rglru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((W + kCols - 1) / kCols, B);
  rglru_scan_kernel<<<grid, kCols, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(ys),
      static_cast<float*>(h_final), S, W, asb, ass, bsb, bss, hsb);
  return static_cast<int>(cudaGetLastError());
}
