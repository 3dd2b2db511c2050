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
// What bounds it: the accumulator's sectors.  The inputs need, per traveled
// coordinate, the value (1 B int8 or 4 B fp32), its index (8 B; none for a
// slice) and acc read and written (16 B), plus 4 B of scale per qchunk
// values: 25 B for int8 values at indices.  But at a TopK delta's density
// (5% in the federated LLM: neighbouring coordinates ~20 elements, 160 B,
// apart) each 8-byte read-modify-write of acc moves at least a 32-byte
// sector each way, and the sectors of one warp's access are spread over
// many DRAM pages.  The floor for real indices is measured, not computed:
// repro_scatter_floor below does the same read-modify-write of acc[dest[i]]
// with a constant addend and no values, scales or scale window, through the
// same chunks and loads (PERF.md records it beside this kernel).
//
// Design: a warp stages a chunk of 32 * kPer consecutive positions
// (a slice: 64), then each lane read-modify-writes its positions of it.
// - Staging: the chunk's index (int64) and values (int8 or fp32) are copied
//   into the warp's shared memory by 16-byte cp.async (bypassing L1: they
//   are read once); the elements before a stream's first 16-byte boundary
//   and after its last are a scalar head and tail, so vals[p0:p1] and an
//   index slice may start at any byte (each stream lands at its own offset
//   mod 16 in the stage, so its 16-byte body is aligned there too).
// - Lane L takes positions L, L + 32, ..., L + 32*(kPer - 1) of the chunk,
//   so each warp load of acc covers 32 consecutive coordinates, whose
//   sectors lie close together, and loads all its kPer accumulator values
//   (__ldcg: L2 only) before its first store.  kPer is 1: on an H100 (700 W)
//   at the federated LLM's span (22.1M coordinates of 442M at TopK 5%),
//   more loads in flight a lane were slower (1.32 ms at 2, 1.35 at 4, 1.41
//   at 16, against 1.28 at 1, 128-thread CTAs), a lane taking 16
//   consecutive positions loaded as 16-byte vectors slower still (1.88 ms),
//   and the floor kernel at 1 a lane took 1.27 ms: acc's sectors and DRAM
//   pages bound it, not the loads in flight.
// - A slice (adapter ranges) has no index: lane L takes the pairs 2L + 64c
//   and moves acc as double2 (a first element before acc's 16-byte
//   boundary is a scalar head).
// - No division per element: a chunk's scale window is divided out once per
//   warp ((pos0 + p) / qchunk, by lane 0) and each lane steps it at the
//   qchunk edges up to its positions (at most one edge in a chunk for
//   qchunk >= 64; the next window's scale is loaded up front).
#include <cstdint>
#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait_all;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 1;              // positions a lane takes in a chunk
static_assert(kPer == 1 || kPer % 2 == 0, "a slice's lane takes pairs");
// positions a lane takes (a slice's: whole pairs), and a warp's chunk
template <bool SLICE>
constexpr int kLane = SLICE && kPer == 1 ? 2 : kPer;
template <bool SLICE>
constexpr int kChunk = 32 * kLane<SLICE>;

enum Mode { kQ8 = 0, kF32 = 1, kFloor = 2 };

// bytes of one value of a mode (the floor reads none)
template <int MODE>
constexpr int kValSize = MODE == kQ8 ? 1 : MODE == kF32 ? 4 : 0;

struct Args {
  double* acc;
  const int64_t* dest;    // null for a slice
  int64_t d0;             // the slice's start
  const void* vals;       // null for the floor
  const float* scales;    // int8 only
  int64_t qchunk, pos0;
  double w;               // the weight; the floor's addend
  int64_t nnz;
  int64_t head;           // a slice's first element before acc's boundary
  int64_t nchunks;        // chunks of [head, nnz)
};

template <int ESZ>
__device__ __forceinline__ void copy_elem(char* dst, const char* src) {
  if constexpr (ESZ == 8)
    *reinterpret_cast<long long*>(dst) =
        __ldcs(reinterpret_cast<const long long*>(src));
  else if constexpr (ESZ == 4)
    *reinterpret_cast<float*>(dst) =
        __ldcs(reinterpret_cast<const float*>(src));
  else
    *reinterpret_cast<signed char*>(dst) =
        __ldcs(reinterpret_cast<const signed char*>(src));
}

// Stage elements [p, p + n) of a stream of ESZ-byte elements at src into
// st, element i at st + off + i*ESZ with off = (src + p*ESZ) mod 16, so the
// stream's aligned 16-byte body lands on aligned shared addresses (st is
// 16-byte aligned): the body by cp.async, the head and tail around it one
// element a lane.  Returns off; the caller waits and syncs the warp.
template <int ESZ>
__device__ __forceinline__ int stage(char* st, const void* src, int64_t p,
                                     int n, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) + p * ESZ;
  const uintptr_t b = a + static_cast<uintptr_t>(n) * ESZ;
  const uintptr_t A = (a + 15) & ~uintptr_t(15), B = b & ~uintptr_t(15);
  const int off = static_cast<int>(a & 15);
  char* d = st + off;
  int nh = n, nt = 0;
  if (A < B) {
    const int nblk = static_cast<int>((B - A) >> 4);
    for (int k = lane; k < nblk; k += 32)
      cp_async16(d + (A - a) + 16 * k,
                 reinterpret_cast<const char*>(A) + 16 * k);
    nh = static_cast<int>((A - a) / ESZ);
    nt = static_cast<int>((b - B) / ESZ);
  }
  // a head of fewer than 16 bytes, or a range holding no whole block
  // (fewer than 32 bytes): at most 31 elements
  if (lane < nh)
    copy_elem<ESZ>(d + lane * ESZ,
                   reinterpret_cast<const char*>(a) + lane * ESZ);
  if (lane < nt)
    copy_elem<ESZ>(d + (B - a) + lane * ESZ,
                   reinterpret_cast<const char*>(B) + lane * ESZ);
  return off;
}

// A lane's scale window over its increasing chunk offsets (rel < span, the
// chunk's positions in the launch): the chunk's first window win0 and the
// offset e0 of its next edge come from one division per warp; the lane steps
// the window at each edge up to its offsets, with the scale of the first
// edge's window loaded up front when that edge is in the chunk.  Only
// windows of positions in the launch are read, so the scales the wrapper
// checked cover them.
struct Walk {
  const float* scales;
  int64_t qchunk, win, win1, e, held;
  float s, s1;
  __device__ __forceinline__ Walk(const Args& a, int64_t win0, int64_t e0,
                                  int span)
      : scales(a.scales), qchunk(a.qchunk), win(win0), win1(win0 + 1),
        e(e0), held(win0) {
    s = __ldg(scales + win0);
    s1 = e0 < span ? __ldg(scales + win1) : s;
  }
  __device__ __forceinline__ float at(int64_t rel) {
    while (rel >= e) {
      ++win;
      e += qchunk;
    }
    if (win != held) {
      held = win;
      s = win == win1 ? s1 : __ldg(scales + win);
    }
    return s;
  }
};

// the chunk's first scale window and the offset of its next edge: one
// division, by lane 0, for the warp
__device__ __forceinline__ void chunk_window(const Args& a, int64_t p,
                                             int lane, int64_t& win0,
                                             int64_t& e0) {
  const int64_t P = a.pos0 + p;
  int64_t w = 0;
  if (lane == 0) w = P / a.qchunk;
  win0 = __shfl_sync(0xffffffffu, w, 0);
  e0 = (win0 + 1) * a.qchunk - P;
}

// w * the value at stage element i (a slice's head: stream element 0), or
// the floor's addend
template <int MODE>
__device__ __forceinline__ double contrib(const Args& a, const char* v, int i,
                                          float scale) {
  if constexpr (MODE == kFloor) {
    return a.w;
  } else if constexpr (MODE == kQ8) {
    const float q =
        static_cast<float>(reinterpret_cast<const signed char*>(v)[i]);
    return __dmul_rn(static_cast<double>(__fmul_rn(q, scale)), a.w);
  } else {
    return __dmul_rn(static_cast<double>(reinterpret_cast<const float*>(v)[i]),
                     a.w);
  }
}

// position 0 of a slice whose acc run starts off its 16-byte boundary
template <int MODE>
__device__ void head_elem(const Args& a) {
  float scale = 0.f;
  if constexpr (MODE == kQ8) scale = __ldg(a.scales + a.pos0 / a.qchunk);
  double* t = a.acc + a.d0;
  *t = __dadd_rn(*t, contrib<MODE>(a, static_cast<const char*>(a.vals), 0,
                                   scale));
}

template <int MODE, bool SLICE>
__global__ void __launch_bounds__(kThreads) scatter_wsum_kernel(const Args a) {
  constexpr int kVal = kValSize<MODE>;
  constexpr int kL = kLane<SLICE>, kC = kChunk<SLICE>;
  constexpr int kIdxBytes = SLICE ? 0 : kC * 8 + 16;
  constexpr int kValBytes = kVal ? kC * kVal + 16 : 0;
  __shared__ alignas(16) char smem[kWarps][kIdxBytes + kValBytes + 16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if constexpr (SLICE)
    if (a.head && g == 0 && lane == 0) head_elem<MODE>(a);
  if (g >= a.nchunks) return;        // the same for the whole warp
  const int64_t p = a.head + g * kC;
  const int n = static_cast<int>(a.nnz - p < kC ? a.nnz - p : kC);
  // the chunk's index and values, staged
  const int64_t* idx = nullptr;
  const char* val = nullptr;
  if constexpr (!SLICE)
    idx = reinterpret_cast<const int64_t*>(
        smem[warp] + stage<8>(smem[warp], a.dest, p, n, lane));
  if constexpr (kVal != 0)
    val = smem[warp] + kIdxBytes +
          stage<kVal>(smem[warp] + kIdxBytes, a.vals, p, n, lane);
  cp_async_commit();
  cp_async_wait_all();
  __syncwarp();
  int64_t win0 = 0, e0 = 0;
  if constexpr (MODE == kQ8) chunk_window(a, p, lane, win0, e0);
  // the lane's offsets in the chunk: L + 32 k, or a slice's pairs
  // 2L + 64 (k / 2) + k % 2
  auto at = [&](int k) {
    return SLICE ? 2 * lane + 64 * (k / 2) + k % 2 : lane + 32 * k;
  };
  double old[kL];
  int64_t d[SLICE ? 1 : kL];
  double* run = a.acc + a.d0 + p;    // a slice's: 16-byte aligned (head)
  if constexpr (!SLICE) {
#pragma unroll
    for (int k = 0; k < kL; ++k)
      if (at(k) < n) d[k] = idx[at(k)];
#pragma unroll
    for (int k = 0; k < kL; ++k)
      if (at(k) < n) old[k] = __ldcg(a.acc + d[k]);
  } else {
#pragma unroll
    for (int c = 0; c < kL / 2; ++c) {
      const int i = at(2 * c);
      if (i + 1 < n) {
        const double2 v = __ldcg(reinterpret_cast<const double2*>(run + i));
        old[2 * c] = v.x;
        old[2 * c + 1] = v.y;
      } else if (i < n) {
        old[2 * c] = __ldcg(run + i);
      }
    }
  }
  if constexpr (MODE == kQ8) {
    if (at(0) < n) {
      Walk walk(a, win0, e0, n);
#pragma unroll
      for (int k = 0; k < kL; ++k)
        if (at(k) < n)
          old[k] = __dadd_rn(old[k],
                             contrib<MODE>(a, val, at(k), walk.at(at(k))));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kL; ++k)
      if (at(k) < n)
        old[k] = __dadd_rn(old[k], contrib<MODE>(a, val, at(k), 0.f));
  }
  if constexpr (!SLICE) {
#pragma unroll
    for (int k = 0; k < kL; ++k)
      if (at(k) < n) a.acc[d[k]] = old[k];
  } else {
#pragma unroll
    for (int c = 0; c < kL / 2; ++c) {
      const int i = at(2 * c);
      if (i + 1 < n)
        *reinterpret_cast<double2*>(run + i) =
            make_double2(old[2 * c], old[2 * c + 1]);
      else if (i < n)
        run[i] = old[2 * c];
    }
  }
}

template <int MODE, bool SLICE>
int launch(Args a, cudaStream_t stream) {
  constexpr uintptr_t kValAlign = kValSize<MODE> > 0 ? kValSize<MODE> : 1;
  if (reinterpret_cast<uintptr_t>(a.acc) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a.dest) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a.vals) % kValAlign != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  a.head =
      SLICE && reinterpret_cast<uintptr_t>(a.acc + a.d0) % 16 != 0 ? 1 : 0;
  a.nchunks = (a.nnz - a.head + kChunk<SLICE> - 1) / kChunk<SLICE>;
  const int64_t blocks =
      a.nchunks > 0 ? (a.nchunks + kWarps - 1) / kWarps : 1;
  scatter_wsum_kernel<MODE, SLICE>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc: fp64, updated in place; dest: (nnz,) int64 indices into acc, or null
// for the slice acc[d0 : d0 + nnz]; vals: (nnz,) int8 (q8 = 1, with scales:
// the fp32 scales of the whole packed stream, value i using scale
// (pos0 + i) / qchunk) or fp32 (q8 = 0, scales null).  Device pointers, each
// aligned to its element; launches on `stream` and does not synchronise;
// returns the launch's cudaError_t (0 on success).
extern "C" int repro_scatter_wsum(void* acc, const void* dest, long long d0,
                                  const void* vals, int q8,
                                  const void* scales, long long qchunk,
                                  long long pos0, double w, long long nnz,
                                  void* stream) {
  if (nnz <= 0 || (q8 && (scales == nullptr || qchunk <= 0 || pos0 < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<double*>(acc), static_cast<const int64_t*>(dest), d0,
         vals, static_cast<const float*>(scales), qchunk, pos0, w, nnz, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q8)
    return dest == nullptr ? launch<kQ8, true>(a, st)
                           : launch<kQ8, false>(a, st);
  return dest == nullptr ? launch<kF32, true>(a, st)
                         : launch<kF32, false>(a, st);
}

// The measurement floor of repro_scatter_wsum at indices dest:
// acc[dest[i]] += add for i < nnz, through the same chunks and loads, with
// no values, scales or scale window.  Not on any fold's path.
extern "C" int repro_scatter_floor(void* acc, const void* dest, double add,
                                   long long nnz, void* stream) {
  if (nnz <= 0 || dest == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<double*>(acc), static_cast<const int64_t*>(dest), 0,
         nullptr, nullptr, 1, 0, add, nnz, 0, 0};
  return launch<kFloor, false>(a, static_cast<cudaStream_t>(stream));
}
