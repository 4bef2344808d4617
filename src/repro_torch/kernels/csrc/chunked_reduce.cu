// Chunked multi-source reduction for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `chunked_reduce` of
// repro/kernels/chunked_reduce.py (kernel body `_kernel`, pl.pallas_call at
// chunked_reduce.py:40): the consumer-side N-way reduction of the paper's
// AllReduce / Reduce / ReduceScatter.  After the retrieve phase a rank holds
// its N peers' partials of one segment in an (n_src, L) buffer and sums them.
//
//   y[i] = sum_{s < n_src} x[s, i]          (f32 accumulation, y in x's type)
//
// What bounds it on the H100: memory.  It must read n_src * L elements and
// write L, (n_src + 1) * L * itemsize bytes over 3.35 TB/s; one add per
// element read is nothing against the fp32 peak.
//
// What the design does about it: one pass over the data.  Each thread owns
// a 16-byte strip of L (4 f32 or 8 bf16), loops over the sources with one
// 16-byte load each (neighbouring threads on neighbouring addresses, so
// every warp load is 512 contiguous bytes), accumulates in f32 registers
// and writes its strip once.  The grid strides over L, so any L runs with a
// grid sized to the card.  No tile padding: the Pallas kernel pads L to its
// tile, this kernel bounds-checks instead; when a row is not 16-byte aligned
// (L * itemsize not a multiple of 16) it takes the scalar path.  Launches
// run on the caller's stream, allocate nothing and return cudaGetLastError().
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

// N elements per strip: 16 bytes of T on the vector path, 1 otherwise.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    chunked_reduce_kernel(const T* __restrict__ x, T* __restrict__ y,
                          int n_src, long long L) {
  const long long strips = (L + N - 1) / N;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long s = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       s < strips; s += stride) {
    const long long i = s * N;
    float acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = 0.f;
    if constexpr (N * sizeof(T) == 16) {
      // the vector path is only taken when L % N == 0: no tail
#pragma unroll 4
      for (int src = 0; src < n_src; ++src) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<long long>(src) * L + i));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] += to_f32(e[j]);
      }
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) o[j] = from_f32<T>(acc[j]);
      *reinterpret_cast<uint4*>(y + i) = out;
    } else {
#pragma unroll 4
      for (int src = 0; src < n_src; ++src)
        acc[0] += to_f32(x[static_cast<long long>(src) * L + i]);
      y[i] = from_f32<T>(acc[0]);
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <typename T>
cudaError_t launch(const void* x, void* y, int n_src, long long L,
                   cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const bool vec = L % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long strips = vec ? L / N : L;
  long long blocks = (strips + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 8;
  if (blocks > cap) blocks = cap;
  if (vec)
    chunked_reduce_kernel<T, N><<<static_cast<int>(blocks), kThreads, 0,
                                  stream>>>(static_cast<const T*>(x),
                                            static_cast<T*>(y), n_src, L);
  else
    chunked_reduce_kernel<T, 1><<<static_cast<int>(blocks), kThreads, 0,
                                  stream>>>(static_cast<const T*>(x),
                                            static_cast<T*>(y), n_src, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n_src, L) contiguous, y: (L,); dtype: 0 = float32, 1 = bfloat16.
int chunked_reduce_launch(const void* x, void* y, int n_src, long long L,
                          int dtype, void* stream) {
  if (n_src <= 0 || L <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n_src, L, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n_src, L, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
