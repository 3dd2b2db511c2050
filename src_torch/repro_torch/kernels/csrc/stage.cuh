// stage.cuh: a ring of shared-memory stages of a (C, N) payload stack,
// filled by 16-byte cp.async -- the loads of the robust folds' register
// paths (sort_reduce.cu, gram.cu).
//
// A stage holds columns [j0, j0 + W) of rows [0, C), W * itemsize a
// multiple of 16 and j0 a multiple of W.  Row c of the stack starts at
// data + c*N*itemsize, which is 16-byte aligned only when the tensor and
// N*itemsize are (not for N = 6922 fp32, nor for an odd N of int8).  So
// each row's slice of a stage is the run of aligned 16-byte chunks that
// covers its W elements, W*itemsize/16 + 1 of them, copied to
// stage + c*S with S = (W*itemsize/16 + 1) * 16; column j0 + jj of row c
// then lies at stage + c*S + row_off(c) + jj*itemsize, where row_off(c) =
// (data + c*N*itemsize) mod 16 does not depend on j0.  A chunk is copied
// only if it starts before the end of the stack: every chunk copied holds
// a byte of the stack, so it lies in memory the stack's allocation owns.
// Bytes of a stage outside rows [0, C) x columns [j0, min(j0 + W, N)) are
// never used as values: the kernels mask the columns past N.
//
// The ring: kStages stages; a CTA issues the loads of stage i + kStages - 1
// while it computes on stage i, so two stages are in flight behind the one
// being read (cp.async.wait_group kStages - 2, then __syncthreads).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kStages = 3;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// the stage about to be read has landed (two younger groups may still fly)
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// bytes between two rows of a stage of W columns
__host__ __device__ __forceinline__ int stage_stride(int W, int isz) {
  return (W * isz / 16 + 1) * 16;
}

// where column j0 of row c lies in its stage row, for every j0
__device__ __forceinline__ int row_off(const void* data, int c, int64_t N,
                                       int isz) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(data) +
                           static_cast<uint64_t>(c) * N * isz) & 15);
}

// Issue (not wait for) the copies of columns [j0, j0 + W) of rows [0, C)
// into `dst` (row stride S = stage_stride(W, isz)), spread over the CTA.
__device__ __forceinline__ void load_stage(char* dst, const char* data,
                                           const char* end, int C,
                                           int64_t N, int isz, int64_t j0,
                                           int S) {
  const int nch = S / 16;
  // e / nch as umulhi(e, ceil(2^32 / nch)): exact while e * nch < 2^32
  // (a stage holds at most a few thousand chunks, nch <= 513)
  const unsigned int inv = 0xFFFFFFFFu / nch + 1u;
  for (int e = threadIdx.x; e < C * nch; e += blockDim.x) {
    const int c =
        static_cast<int>(__umulhi(static_cast<unsigned int>(e), inv));
    const int k = e - c * nch;
    const uintptr_t row = reinterpret_cast<uintptr_t>(data) +
                          (static_cast<uint64_t>(c) * N + j0) * isz;
    const char* src = reinterpret_cast<const char*>(row & ~uintptr_t(15)) +
                      16 * k;
    if (src < end) cp_async16(dst + c * S + 16 * k, src);
  }
}

}  // namespace repro
