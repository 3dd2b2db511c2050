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
// separate PyTorch ops, on the card.
//
// What bounds it: bytes.  At the serving shape (B 4, S 4096, W 2560) it
// reads a and b and writes ys once, 3 x 167.8 MB = 503 MB: 0.150 ms at
// 3.35 TB/s; its 2 flops per element are nothing beside that.  This first
// kernel does not reach that bound: the recurrence is sequential in S, and
// one thread per (b, w) column gives 10,240 threads, less than one wave of
// 132 SMs, so it is bound by how many loads each thread keeps in flight.
// Each thread loads the next kUnroll steps of a and b into registers before
// it runs the dependent chain of the current kUnroll steps, so a column
// has 2 x kUnroll loads in flight while it computes.  A chunked scan across
// S (per-chunk partial products, then a pass over the chunk carries) would
// fill the card and is later work.
//
// Design: blocks of 64 threads along W (adjacent threads take adjacent
// columns, so every load and store of a step is coalesced), one grid row
// per batch element.  a and b are read through their batch and sequence
// strides (W contiguous); ys is written contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // columns per block
constexpr int kUnroll = 16;   // steps loaded ahead of the chain

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ ys,
                  float* __restrict__ h_final, int S, int W, long long asb,
                  long long ass, long long bsb, long long bss,
                  long long hsb) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const float* ap = a + bi * asb + w;
  const float* bp = b + bi * bsb + w;
  float* yp = ys + static_cast<long long>(bi) * S * W + w;
  float h = h0[bi * hsb + w];

  float ca[kUnroll], cb[kUnroll];  // the steps being computed
  float na[kUnroll], nb[kUnroll];  // the next steps, in flight
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    ca[j] = j < S ? ap[j * ass] : 0.f;
    cb[j] = j < S ? bp[j * bss] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    const int t1 = t0 + kUnroll;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const bool in = t1 + j < S;
      na[j] = in ? ap[static_cast<long long>(t1 + j) * ass] : 0.f;
      nb[j] = in ? bp[static_cast<long long>(t1 + j) * bss] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (t0 + j < S) {
        h = __fadd_rn(__fmul_rn(ca[j], h), cb[j]);
        yp[static_cast<long long>(t0 + j) * W] = h;
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      ca[j] = na[j];
      cb[j] = nb[j];
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
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(ys),
      static_cast<float*>(h_final), S, W, asb, ass, bsb, bss, hsb);
  return static_cast<int>(cudaGetLastError());
}
