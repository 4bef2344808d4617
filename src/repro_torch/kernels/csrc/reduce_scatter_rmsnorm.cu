// ReduceScatter's final accumulation fused with RMSNorm, for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `reduce_scatter_rmsnorm` of
// repro/kernels/fused_collectives.py (kernel body `_rs_rmsnorm_kernel`,
// pl.pallas_call at fused_collectives.py:69).  After a ReduceScatter's
// retrieve phase a rank holds its n_src peers' partials of its own rows;
// the kernel sums them and applies the norm before anything is written:
//
//   acc[t, :] = sum_{s < n_src} x[s, t, :]          (f32, in s order)
//   y[t, :]   = acc[t, :] / sqrt(mean(acc[t, :]^2) + eps) * scale
//
// What bounds it on the H100: memory.  It must read n_src * T * D elements
// and the scale once and write T * D, (n_src + 1) * T * D * itemsize +
// 4 * D bytes over 3.35 TB/s; a few flops per element are nothing against
// the fp32 peak.  The unfused composition (sum, then rmsnorm) also writes
// the sum and reads it back: 2 * T * D * itemsize more.
//
// What the design does about it: one block of 256 threads per row (the
// TPU kernel's 128-row tiles and padded grid have no counterpart: blocks
// run in no order and T needs no padding).  Each thread owns up to VPT
// 16-byte strips of the row (4 f32 or 8 bf16; neighbouring threads on
// neighbouring addresses), adds the n_src sources into f32 registers in
// index order, and adds the squares of its sums to its partial sum of
// squares.  The block reduces those in a fixed order (warp shuffles, then
// the 8 warp sums through shared memory), so a run is bitwise repeatable.
// The sums never leave registers: the second phase scales them and writes
// y once.  Rows that are not 16-byte aligned take a scalar path.  The norm
// is IEEE: sqrtf and a division (no --use_fast_math, no rsqrtf).  Launches
// run on the caller's stream, allocate nothing and return
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVpt = 16;   // strips a thread holds in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

// N consecutive elements; one 16-byte access when N * sizeof(T) == 16.
template <typename T, int N>
__device__ __forceinline__ void add_n(const T* p, float (&acc)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += to_f32(p[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float (&in)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f32<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f32<T>(in[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One block per row t.  N: elements per strip (16 bytes of T, or 1 when
// the rows are not 16-byte aligned); VPT: strips per thread, the smallest
// power of two with kThreads * N * VPT >= D.  Source s of row t starts at
// x + (s * T + t) * D.
template <typename T, int N, int VPT>
__global__ void __launch_bounds__(kThreads)
    rs_rmsnorm_kernel(const T* __restrict__ x,
                      const float* __restrict__ scale, T* __restrict__ y,
                      int n_src, long long src_stride, int D, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * D;
  float acc[VPT][N];
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int i = (v * kThreads + threadIdx.x) * N;
#pragma unroll
    for (int j = 0; j < N; ++j) acc[v][j] = 0.f;
    if (i < D) {
      for (int s = 0; s < n_src; ++s)
        add_n<T, N>(x + s * src_stride + row + i, acc[v]);
#pragma unroll
      for (int j = 0; j < N; ++j) ss = fmaf(acc[v][j], acc[v][j], ss);
    }
  }

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
    s = warp_sum(s);
    if (threadIdx.x == 0)
      inv_rms = 1.0f / sqrtf(s / static_cast<float>(D) + eps);
  }
  __syncthreads();
  const float r = inv_rms;

#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int i = (v * kThreads + threadIdx.x) * N;
    if (i < D) {
      float out[N];
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = (acc[v][j] * r) * scale[i + j];
      store_n<T, N>(y + row + i, out);
    }
  }
}

template <typename T, int N>
cudaError_t launch_n(const T* x, const float* scale, T* y, int n_src,
                     int rows, int D, float eps, cudaStream_t stream) {
  const long long src_stride = static_cast<long long>(rows) * D;
  const int strips = (D + N - 1) / N;
  const int vpt = (strips + kThreads - 1) / kThreads;
#define REPRO_RS_RMSNORM(V)                                                \
  rs_rmsnorm_kernel<T, N, V><<<rows, kThreads, 0, stream>>>(               \
      x, scale, y, n_src, src_stride, D, eps)
  if (vpt <= 1) REPRO_RS_RMSNORM(1);
  else if (vpt <= 2) REPRO_RS_RMSNORM(2);
  else if (vpt <= 4) REPRO_RS_RMSNORM(4);
  else if (vpt <= 8) REPRO_RS_RMSNORM(8);
  else if (vpt <= kMaxVpt) REPRO_RS_RMSNORM(kMaxVpt);
  else return cudaErrorInvalidValue;
#undef REPRO_RS_RMSNORM
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y, int n_src,
                   int rows, int D, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const bool aligned = D % N == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (aligned) return launch_n<T, N>(xt, scale, yt, n_src, rows, D, eps,
                                     stream);
  return launch_n<T, 1>(xt, scale, yt, n_src, rows, D, eps, stream);
}

}  // namespace

extern "C" {

// x: (n_src, rows, D) contiguous, scale: (D,) float32, y: (rows, D);
// dtype: 0 = float32, 1 = bfloat16 (x and y).  D is at most kThreads *
// kMaxVpt strips: 16384 (f32) / 32768 (bf16) on 16-byte aligned rows,
// 4096 otherwise; larger D returns cudaErrorInvalidValue.
int reduce_scatter_rmsnorm_launch(const void* x, const void* scale, void* y,
                                  int n_src, int rows, int D, float eps,
                                  int dtype, void* stream) {
  if (rows <= 0 || D <= 0) return cudaSuccess;
  if (n_src <= 0) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, s, y, n_src, rows, D, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, s, y, n_src, rows, D, eps, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
