// RMSNorm for Hopper (sm_90a), forward and backward, hand-written CUDA C++.
//
// The forward replaces the Pallas TPU kernel `rms_norm` of
// repro/kernels/rmsnorm.py (kernel body `_kernel`, pl.pallas_call at
// rmsnorm.py:36), which the JAX model reaches through its jnp twin
// `layers.rms_norm`.  The JAX package has no backward kernel: it
// differentiates `layers.rms_norm`; the backward here computes that VJP.
//
//   y  = x * r * s,                r = rsqrt(mean(x^2) + eps)     (f32 math)
//   dx = r * (g*s - x * r^2 * mean(g*s*x)),   ds = sum_t g * x * r
//
// What bounds it on the H100: memory.  The forward must read x and write y
// (2*T*D*itemsize + 4*D bytes), the backward read x and dy and write dx
// (3*T*D*itemsize + 8*D bytes); three to eight flops an element are far
// below the f32 peak.  At prefill and in training (T = 1024 rows of
// D = 2048 or 4096) the whole problem fits on the card at once, so what
// counts is that every row is resident, with all of its loads in flight,
// and waits once.  At decode (T = 4) four rows cannot fill 132 SMs: the
// launch, one DRAM round trip and the reduction's latency set the time.
//
// What the design does about it:
// * One read of x.  A thread holds its slice of the row in registers: V
//   vectors of 16 bytes (4 f32 or 8 bf16), V a template parameter, thread
//   t of a row owning vectors t, t + tpr, t + 2 tpr, ... (neighbouring
//   threads on neighbouring addresses).  All of its loads, x and scale
//   alike, are issued before the reduction; the result is scaled and
//   stored from registers.  Columns past D are predicated off, so one
//   instantiation serves every D it covers (the smoke widths, D = 384,
//   D = 100); rows not 16-byte aligned take N = 1.
// * Few elements a thread, many rows resident.  The wrapper's
//   `rms_geometry` gives a forward thread 16 elements (V = 4 in f32, 2 in
//   bf16 at D = 2048 and 4096): 128 or 256 threads a row, 2 or 1 rows a
//   block of 256, and about 50 registers, so every row of T = 1024 is on
//   the card in one wave.  (Wider slices, 32 or 64 elements a thread, ran
//   slower at prefill: the registers cut the resident rows.)  At decode it
//   spreads a row over up to 512 threads, one or two vectors each.
// * One block barrier a row.  Each warp reduces by shuffles and writes
//   one partial; after the barrier every warp sums the row's partials by a
//   fixed butterfly.  The backward double-buffers the partials by row
//   parity, so it too takes one barrier a row.
// * `scale` in 16-byte vectors, loaded once per thread.  A backward block
//   is one row of threads that walks rows blockIdx.x, + gridDim.x, ...
//   (about 4 at T = 1024, two blocks an SM) with its scale slice and its
//   dscale sums in registers, and issues the next row's loads before it
//   reduces the current one.
// * Deterministic: fixed-order sums everywhere, no atomics.  The backward
//   writes one dscale partial row per block into the wrapper's (grid, D)
//   f32 scratch; a second launch sums each column's partials in a fixed
//   order (32 contiguous ranges, then a fixed butterfly).
// Launches run on the caller's stream, allocate nothing and return
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

// The most threads a block of an instantiation holding E = V * N elements
// a thread may have: its register budget (65536 / threads) must hold x
// and the scale slice (in the backward also dy, the next row's x and dy
// and the dscale sums).  `rms_geometry` in the wrapper keeps to it.
constexpr int max_threads(int elems) { return elems <= 16 ? 512 : 256; }

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
  } else if constexpr (sizeof(T) == 4 && N % 4 == 0) {  // f32 scale
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      float4 q = *reinterpret_cast<const float4*>(p + i);
      out[i] = q.x, out[i + 1] = q.y, out[i + 2] = q.z, out[i + 3] = q.w;
    }
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

// The V vectors of N elements that thread `t` of a `tpr`-thread row owns:
// vector k starts at column (k * tpr + t) * N; columns past D read 0.
template <typename T, int N, int V>
__device__ __forceinline__ void load_slice(const T* row, int t, int tpr,
                                           int D, bool live,
                                           float (&v)[V][N]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int col = (k * tpr + t) * N;
    if (live && col < D) {
      load_n<T, N>(row + col, v[k]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) v[k][j] = 0.f;
    }
  }
}

// Forward.  Block = rows_per_block rows of tpr threads (tpr a multiple of
// 32); row `blockIdx.x * rows_per_block + slot`.
template <typename T, int N, int V>
__global__ void __launch_bounds__(max_threads(V * N))
    rmsnorm_fwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale, T* __restrict__ y,
                       int rows, int D, int tpr, float eps) {
  __shared__ float part[kMaxThreads / 32];
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  const bool live = row < rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * D;

  float v[V][N], s[V][N];
  load_slice<T, N, V>(x + base, t, tpr, D, live, v);
  load_slice<float, N, V>(scale, t, tpr, D, live, s);
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) ss = fmaf(v[k][j], v[k][j], ss);
  ss = warp_sum(ss);
  const int wpr = tpr >> 5;                // warps in a row
  if (wpr > 1) {                           // uniform over the block
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    ss = warp_sum(lane < wpr ? part[slot * wpr + lane] : 0.f);
  }
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int col = (k * tpr + t) * N;
    if (col < D) {
      float o[N];
#pragma unroll
      for (int j = 0; j < N; ++j) o[j] = (v[k][j] * r) * s[k][j];
      store_n<T, N>(y + base + col, o);
    }
  }
}

// Backward.  Block = one row of blockDim.x threads, walking rows
// blockIdx.x, blockIdx.x + gridDim.x, ...; dx (if given) per row, the
// block's dscale partial (if `part` is given) into part[blockIdx.x, :].
template <typename T, int N, int V>
__global__ void __launch_bounds__(max_threads(V * N))
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ scale, T* __restrict__ dx,
                       float* __restrict__ part, int rows, int D,
                       float eps) {
  __shared__ float red[2][2][kMaxThreads / 32];  // [row parity][sum][warp]
  const int t = threadIdx.x, tpr = blockDim.x, wpr = tpr >> 5;
  const int lane = t & 31;
  const float inv_d = 1.f / static_cast<float>(D);

  float s[V][N], acc[V][N], xc[V][N], gc[V][N];
  load_slice<float, N, V>(scale, t, tpr, D, true, s);
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[k][j] = 0.f;
  int row = blockIdx.x;
  const bool first = row < rows;
  load_slice<T, N, V>(x + static_cast<size_t>(first ? row : 0) * D, t, tpr,
                      D, first, xc);
  load_slice<T, N, V>(dy + static_cast<size_t>(first ? row : 0) * D, t, tpr,
                      D, first, gc);
  for (int it = 0; row < rows; row += gridDim.x, ++it) {
    // the next row's loads go out before this row's reduction
    const int next = row + gridDim.x;
    const bool more = next < rows;
    float xn[V][N], gn[V][N];
    load_slice<T, N, V>(x + static_cast<size_t>(more ? next : 0) * D, t,
                        tpr, D, more, xn);
    load_slice<T, N, V>(dy + static_cast<size_t>(more ? next : 0) * D, t,
                        tpr, D, more, gn);

    float a = 0.f, b = 0.f;              // sum x^2, sum g*s*x
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a = fmaf(xc[k][j], xc[k][j], a);
        b = fmaf(gc[k][j] * s[k][j], xc[k][j], b);
      }
    a = warp_sum(a);
    b = warp_sum(b);
    if (wpr > 1) {
      float (*buf)[kMaxThreads / 32] = red[it & 1];
      if (lane == 0) buf[0][t >> 5] = a, buf[1][t >> 5] = b;
      __syncthreads();
      a = warp_sum(lane < wpr ? buf[0][lane] : 0.f);
      b = warp_sum(lane < wpr ? buf[1][lane] : 0.f);
    }
    const float r = rsqrtf(a * inv_d + eps);
    const float c = (r * r) * (b * inv_d);   // r^2 * mean(g*s*x)
    const size_t base = static_cast<size_t>(row) * D;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int col = (k * tpr + t) * N;
      float o[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        o[j] = r * (gc[k][j] * s[k][j] - xc[k][j] * c);
        acc[k][j] += (gc[k][j] * xc[k][j]) * r;
      }
      if (dx != nullptr && col < D) store_n<T, N>(dx + base + col, o);
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int j = 0; j < N; ++j) xc[k][j] = xn[k][j], gc[k][j] = gn[k][j];
  }
  if (part == nullptr) return;
  float* pr = part + static_cast<size_t>(blockIdx.x) * D;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int col = (k * tpr + t) * N;
    if (col < D) store_n<float, N>(pr + col, acc[k]);
  }
}

// dscale[c] = sum over p of part[p, c], in a fixed order: a block of 32
// warps owns 32 columns; warp w sums the contiguous range w of `parts`
// (one column a lane), then warp w sums column w over the 32 warps by a
// fixed butterfly.
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_colsum_kernel(const float* __restrict__ part,
                          float* __restrict__ out, int parts, int D) {
  __shared__ float tile[32][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int per = (parts + 31) / 32;
  const int p1 = min(parts, (w + 1) * per);
  float acc = 0.f;
  if (col < D)
    for (int p = w * per; p < p1; ++p)
      acc += part[static_cast<size_t>(p) * D + col];
  tile[w][lane] = acc;
  __syncthreads();
  const float v = warp_sum(tile[lane][w]);
  const int c = blockIdx.x * 32 + w;
  if (lane == 0 && c < D) out[c] = v;
}

template <typename T, int N>
cudaError_t fwd_v(const void* x, const float* s, void* y, int rows, int D,
                  int v, int tpr, int rpb, int grid, float eps,
                  cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int threads = tpr * rpb;
#define RMS_FWD(VV)                                                         \
  case VV:                                                                  \
    if (threads > max_threads(VV * N)) return cudaErrorInvalidValue;        \
    rmsnorm_fwd_kernel<T, N, VV><<<grid, threads, 0, st>>>(xt, s, yt, rows, \
                                                           D, tpr, eps);    \
    break;
  switch (v) {
    RMS_FWD(1) RMS_FWD(2) RMS_FWD(4) RMS_FWD(8) RMS_FWD(16)
    default: return cudaErrorInvalidValue;
  }
#undef RMS_FWD
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t bwd_v(const void* x, const void* dy, const float* s, void* dx,
                  float* part, int rows, int D, int v, int tpr, int grid,
                  float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
#define RMS_BWD(VV)                                                       \
  case VV:                                                                \
    if (tpr > max_threads(VV * N)) return cudaErrorInvalidValue;          \
    rmsnorm_bwd_kernel<T, N, VV><<<grid, tpr, 0, st>>>(xt, gt, s, dxt,    \
                                                       part, rows, D,     \
                                                       eps);              \
    break;
  switch (v) {
    RMS_BWD(1) RMS_BWD(2) RMS_BWD(4) RMS_BWD(8) RMS_BWD(16)
    default: return cudaErrorInvalidValue;
  }
#undef RMS_BWD
  return cudaGetLastError();
}

bool bad_geometry(int tpr, int rpb, int grid) {
  return tpr < 32 || tpr % 32 != 0 || rpb < 1 || tpr * rpb > kMaxThreads ||
         grid < 1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y); scale is always float32.
// vec: 1 = 16-byte vectors (4 f32 / 8 bf16), 0 = one element at a time.
// v, tpr, rows_per_block, grid: `rms_geometry` of the wrapper.
int rmsnorm_launch(const void* x, const void* scale, void* y, int rows,
                   int D, float eps, int dtype, int vec, int v, int tpr,
                   int rows_per_block, int grid, void* stream) {
  if (rows <= 0 || D <= 0) return cudaSuccess;
  if (bad_geometry(tpr, rows_per_block, grid)) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rpb = rows_per_block;
  if (dtype == 0)
    return vec ? fwd_v<float, 4>(x, s, y, rows, D, v, tpr, rpb, grid, eps, st)
               : fwd_v<float, 1>(x, s, y, rows, D, v, tpr, rpb, grid, eps, st);
  if (dtype == 1)
    return vec ? fwd_v<__nv_bfloat16, 8>(x, s, y, rows, D, v, tpr, rpb, grid,
                                         eps, st)
               : fwd_v<__nv_bfloat16, 1>(x, s, y, rows, D, v, tpr, rpb, grid,
                                         eps, st);
  return cudaErrorInvalidValue;
}

// dx (x's dtype) and dscale (float32) of the forward above for the
// upstream gradient dy (x's dtype, contiguous).  dx may be null (not
// needed); dscale and part may be null together (not needed), else part
// is a (grid, D) float32 scratch.  One row per block of tpr threads.
int rmsnorm_backward_launch(const void* x, const void* dy, const void* scale,
                            void* dx, void* part, void* dscale, int rows,
                            int D, float eps, int dtype, int vec, int v,
                            int tpr, int grid, void* stream) {
  if (rows <= 0 || D <= 0) return cudaSuccess;
  if (bad_geometry(tpr, 1, grid) || (part == nullptr) != (dscale == nullptr))
    return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec ? bwd_v<float, 4>(x, dy, s, dx, p, rows, D, v, tpr, grid, eps,
                                st)
              : bwd_v<float, 1>(x, dy, s, dx, p, rows, D, v, tpr, grid, eps,
                                st);
  else if (dtype == 1)
    err = vec ? bwd_v<__nv_bfloat16, 8>(x, dy, s, dx, p, rows, D, v, tpr,
                                        grid, eps, st)
              : bwd_v<__nv_bfloat16, 1>(x, dy, s, dx, p, rows, D, v, tpr,
                                        grid, eps, st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || p == nullptr) return err;
  rmsnorm_colsum_kernel<<<(D + 31) / 32, kMaxThreads, 0, st>>>(
      p, static_cast<float*>(dscale), grid, D);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
