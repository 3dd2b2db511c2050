// flash_attention: causal / GQA / sliding-window attention forward with an
// online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:94
// (flash_attention, pallas_call at :128, body _kernel :51).  Same function:
//   - q (B, S, H, hd), already scaled by 1/sqrt(hd); k, v (B, S, KV, hd);
//     the kv head of q head h is h / (H / KV);
//   - key kp is visible from query qp when kp < S, when kp <= qp if causal,
//     and when kp > qp - window if window != 0;
//   - softmax in fp32 whatever the input dtype, the output cast back to it;
//   - a row whose every key is masked gives 0 (the reference's l >= 1e-30
//     guard), and padded or out-of-band keys contribute nothing.
// The reference pads S to its block size and visits every (q, kv) block;
// this kernel reads q, k and v in place through their strides (no moveaxis,
// no pad), masks the ragged edge itself and visits only the keys some row of
// its query block can see (the causal and window band): the same result for
// about half the work at the serving shape.
//
// What bounds it: operations.  At the serving shape (B 4, S 4500, H 32,
// KV 8, hd 80, window 4096) the band is 1.29e9 (q, k) pairs, 4*hd = 320
// flops each: 411 GFLOP, 0.42 ms on the bf16 tensor cores (989 TFLOP/s),
// against 230 MB of q, k, v and o (0.07 ms at 3.35 TB/s).  This first
// kernel runs on the fp32 CUDA cores, so it cannot beat 411 GFLOP / 67
// TFLOP/s = 6.1 ms.  At recurrentgemma's local attention (B 4, S 4096,
// H 10, KV 1, hd 256, window 2048) the band is 6,292,480 pairs per (b, h),
// 1024 flops each: 257.7 GFLOP, 0.26 ms on the tensor cores and 3.85 ms on
// the fp32 cores.  The shared-memory loads, shuffles and exp2 beside
// each pair's FMAs keep it well above that.  Tensor cores (mma.sync or
// wgmma on bf16 with fp32 accumulate), TMA staging and warp specialisation
// are the work that makes it fast.
//
// Design: one CTA of 256 threads per (q block, q head, batch); the heaviest
// q blocks (last in the sequence) are launched first.  kLanes threads own a
// query row (4 up to head dim 128, so a q block is 64 rows; 8 at head dim
// 256, 32 rows): each keeps its share of q (pre-multiplied by log2 e, so the
// softmax uses exp2) and of the fp32 output accumulator in registers, in
// float4 chunks interleaved across the lanes (lane l owns chunks l,
// l + kLanes, ...), so a row's lanes read consecutive 16-byte chunks of
// shared memory and no bank conflicts arise at any head dim.  K and V tiles
// (32 keys; 16 at head dim 256, so the two tiles stay within the 48 KB of
// static shared memory) are staged through shared memory as fp32.  A score
// is kLanes partial dot products summed by xor shuffles (two, or three at
// 8 lanes), identical in the row's lanes, which then each run the same
// online-softmax update (running max m, sum l) on 8 keys at a time and fold
// p * v into their share of the accumulator.  Every thread of a CTA runs
// the same trip counts, so the shuffles never diverge.  Head dims 32, 64,
// 80, 128 and 256 are instantiated (80 is danube's: 20 float4 chunks, not a
// power of two; 256 is recurrentgemma's local attention, where 8 lanes keep
// q and the accumulator at 32 registers each, as at 128); others are
// refused.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;             // threads per CTA
constexpr int kSub = 8;                   // keys scored at once

// threads per query row, and keys per shared-memory tile, at head dim HD
__host__ __device__ constexpr int lanes_for(int hd) { return hd > 128 ? 8 : 4; }
__host__ __device__ constexpr int keys_for(int hd) { return hd > 128 ? 16 : 32; }
// query rows per CTA
__host__ __device__ constexpr int rows_for(int hd) {
  return kThreads / lanes_for(hd);
}
constexpr float kLog2e = 1.4426950408889634f;
// the reference's NEG_INF, -0.7 * float32 max: the running max before any key
constexpr float kNegInf = -0.7f * 3.402823466e38f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {  // element strides of the batch, sequence and head axes
  long long b, s, h;
};

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int g,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 int window) {
  constexpr int kLanes = lanes_for(HD);
  constexpr int kKeys = keys_for(HD);
  constexpr int kRows = rows_for(HD);
  static_assert(HD % (4 * kLanes) == 0, "head dim must split into float4s");
  static_assert(kKeys % kSub == 0, "tile must split into sub-chunks");
  constexpr int kChunks = HD / 4;          // float4 chunks in a row
  constexpr int kMine = kChunks / kLanes;  // chunks a thread owns
  __shared__ float4 k_tile[kKeys][kChunks];
  __shared__ float4 v_tile[kKeys][kChunks];

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / g;
  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = qb * kRows;
  const int qpos = q0 + row;

  const T* qrow = q + b * qs.b + static_cast<long long>(min(qpos, S - 1)) * qs.s
                  + h * qs.h;
  float4 qr[kMine];
  float4 acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int d = 4 * (i * kLanes + lane);
    qr[i] = make_float4(to_f32(qrow[d]) * kLog2e, to_f32(qrow[d + 1]) * kLog2e,
                        to_f32(qrow[d + 2]) * kLog2e,
                        to_f32(qrow[d + 3]) * kLog2e);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;  // running max, in log2 units
  float l = 0.f;      // running sum of exp2(s - m)

  // the keys some row of this block can see: [lo, hi)
  const int q1 = min(q0 + kRows, S);
  const int lo = window != 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? q1 : S;

  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;
  float* k_flat = reinterpret_cast<float*>(&k_tile[0][0]);
  float* v_flat = reinterpret_cast<float*>(&v_tile[0][0]);

  for (int t0 = lo; t0 < hi; t0 += kKeys) {
    const int nk = min(kKeys, hi - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kKeys * HD; e += kThreads) {
      const int j = e / HD;
      const int d = e - j * HD;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const long long kp = t0 + j;
        kv = to_f32(kbase[kp * ks.s + d]);
        vv = to_f32(vbase[kp * vs.s + d]);
      }
      k_flat[e] = kv;
      v_flat[e] = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += kSub) {
      float s[kSub];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int j = j0 + jj;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const float4 kk = k_tile[j][i * kLanes + lane];
          part = fmaf(qr[i].x, kk.x, part);
          part = fmaf(qr[i].y, kk.y, part);
          part = fmaf(qr[i].z, kk.z, part);
          part = fmaf(qr[i].w, kk.w, part);
        }
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const int kp = t0 + j;
        const bool ok = j < nk && (!causal || kp <= qpos) &&
                        (window == 0 || kp > qpos - window);
        s[jj] = ok ? part : -CUDART_INF_F;
        mx = fmaxf(mx, s[jj]);
      }
      // mx and m are finite (>= kNegInf): a masked key's exp2(-inf) is 0,
      // and a row with no key yet keeps alpha = 1, l = 0 and acc = 0
      const float alpha = exp2f(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float p = exp2f(s[jj] - mx);
        l += p;
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const float4 vv = v_tile[j0 + jj][i * kLanes + lane];
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
      m = mx;
    }
  }

  if (qpos >= S) return;
  const float den = fmaxf(l, 1e-30f);
  T* orow = o + b * os.b + static_cast<long long>(qpos) * os.s + h * os.h;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int d = 4 * (i * kLanes + lane);
    store(orow + d, acc[i].x / den);
    store(orow + d + 1, acc[i].y / den);
    store(orow + d + 2, acc[i].z / den);
    store(orow + d + 3, acc[i].w / den);
  }
}

template <int HD, typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int g, Strides qs, Strides ks,
                      Strides vs, Strides os, int causal, int window,
                      cudaStream_t stream) {
  constexpr int kRows = rows_for(HD);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<HD, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, g, qs, ks, vs, os,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int hd, const void* q, const void* k, const void* v,
                         void* o, int B, int S, int H, int g, Strides qs,
                         Strides ks, Strides vs, Strides os, int causal,
                         int window, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_hd<32, T>(q, k, v, o, B, S, H, g, qs, ks, vs, os, causal,
                              window, stream);
    case 64:
      return launch_hd<64, T>(q, k, v, o, B, S, H, g, qs, ks, vs, os, causal,
                              window, stream);
    case 80:
      return launch_hd<80, T>(q, k, v, o, B, S, H, g, qs, ks, vs, os, causal,
                              window, stream);
    case 128:
      return launch_hd<128, T>(q, k, v, o, B, S, H, g, qs, ks, vs, os, causal,
                               window, stream);
    case 256:
      return launch_hd<256, T>(q, k, v, o, B, S, H, g, qs, ks, vs, os, causal,
                               window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd); the last axis contiguous, the
// others at the given element strides (batch, sequence, head).  dtype: 0
// fp32, 1 bf16.  Launches on `stream`, does not synchronise; returns the
// launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention(
    int dtype, int hd, const void* q, const void* k, const void* v, void* o,
    int B, int S, int H, int KV, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int causal,
    int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = H / KV;
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = launch_dtype<float>(hd, q, k, v, o, B, S, H, g, qs, ks, vs, os,
                                causal, window, s);
      break;
    case kBF16:
      err = launch_dtype<__nv_bfloat16>(hd, q, k, v, o, B, S, H, g, qs, ks,
                                        vs, os, causal, window, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
