// Fused RMSNorm for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `rms_norm` of repro/kernels/rmsnorm.py
// (kernel body `_kernel`, pl.pallas_call at rmsnorm.py:36), which the JAX
// model reaches through its jnp twin `layers.rms_norm`.
//
//   y[t, :] = x[t, :] * rsqrt(mean(x[t, :]^2) + eps) * scale      (f32 math)
//
// What bounds it on the H100: memory.  The function must read x once and
// write y once, 2*T*D*itemsize + 4*D bytes over 3.35 TB/s; its arithmetic
// (three flops per element) is far below the fp32 peak.  At decode the
// serving path normalises T = 4 rows: four blocks cannot fill 132 SMs and
// the launch latency, not the bytes, sets the time.
//
// What the design does about it: one block of 256 threads per row keeps
// the whole row (8 KiB at D = 2048 in f32) on one SM, every thread loads
// 16 bytes at a time (4 f32 or 8 bf16, neighbouring threads on
// neighbouring addresses), and the f32 sum of squares is reduced by warp
// shuffles and then across the 8 warps through shared memory.  The second
// pass reads the row again from L1/L2, which still hold it, so device
// memory sees one read and one write per element.  Launches run on the
// caller's stream, allocate nothing and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
__device__ __forceinline__ void load_n(const T* p, float (&out)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
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

// One block per row.  N is the vector width (16 bytes of T), or 1 when
// the row is not 16-byte aligned.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, int D, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * D;
  T* yr = y + static_cast<size_t>(blockIdx.x) * D;

  float ss = 0.f;
  for (int i = threadIdx.x * N; i < D; i += kThreads * N) {
    float v[N];
    load_n<T, N>(xr + i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) ss = fmaf(v[j], v[j], ss);
  }

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
    s = warp_sum(s);
    if (threadIdx.x == 0) inv_rms = rsqrtf(s / static_cast<float>(D) + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  for (int i = threadIdx.x * N; i < D; i += kThreads * N) {
    float v[N];
    load_n<T, N>(xr + i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = (v[j] * r) * scale[i + j];
    store_n<T, N>(yr + i, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y, int rows,
                   int D, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const bool aligned = D % N == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (aligned)
    rmsnorm_kernel<T, N><<<rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), D, eps);
  else
    rmsnorm_kernel<T, 1><<<rows, kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), D, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y); scale is always float32.
int rmsnorm_launch(const void* x, const void* scale, void* y, int rows,
                   int D, float eps, int dtype, void* stream) {
  if (rows <= 0 || D <= 0) return cudaSuccess;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, s, y, rows, D, eps, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, s, y, rows, D, eps, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
