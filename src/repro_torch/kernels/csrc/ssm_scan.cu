// Selective state-space scan (the Mamba-1 core) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `ssm_scan` of repro/kernels/ssm_scan.py
// (kernel body `_kernel`, pl.pallas_call at ssm_scan.py:72).  For each
// batch b, channel d and time t, with an f32 state h[d, :] of N lanes:
//
//   h[d, :]   = exp(dt[b,t,d] * A[d, :]) * h[d, :] + (dt[b,t,d] * x[b,t,d]) * B[b,t,:]
//   y[b,t,d]  = sum_n h[d, n] * C[b,t,n] + D[d] * x[b,t,d]
//
// Beyond the Pallas kernel it takes an optional starting state h0
// (B, D, N) f32 (the Pallas kernel starts from zero) and writes an
// optional final state h_last (B, D, N) f32: a prefill hands h_last to
// the decode cache, and a decode step is L = 1 from the cached state.
// With neither, it computes what `ops.ssm_scan` computes.  Loads are f32,
// or bf16 upcast to f32; y has x's dtype.
//
// What bounds it on the H100.  At the prefill shape (1, 1024, 8192, 16)
// the function reads x and dt and writes y (3 x 33.55 MB) plus A and the
// state (0.52 MB each): about 0.030 ms at 3.35 TB/s.  It evaluates one
// exp per (b, t, d, n), 134 M of them, which the SFU issues at 16 per
// clock per SM: 0.032 ms at 132 SMs x 1.98 GHz.  So the exps bound it,
// just above the bytes.  A decode step (L = 1, B = 4) moves about 4 MB
// and is bound by its launch.
//
// What the design does about it.  On the TPU the sequence is the
// sequential (innermost) grid axis and the state lives in VMEM scratch
// between grid steps.  Hopper's blocks run in no order, so the L loop
// runs inside the block: one thread per (b, d, n) keeps h[d, n] in a
// register for the whole sequence.  The N lanes of a channel sit in one
// warp (two channels per warp at N = 16), and y is reduced over them
// with __shfl_xor_sync in a fixed butterfly order: no atomics, so a run
// is bitwise deterministic (the serving path's eviction check restores
// a cache image and needs the same bits again).  A block owns 256 / N
// channels (at most 64); each chunk of kChunk time steps of x and dt
// (read coalesced over d) and of B and C is staged in shared memory,
// and the chunk's y is written back coalesced.  At the prefill shape
// that is 512 blocks of 256 threads, about 31 warps per SM on 132 SMs,
// so every block is resident at once.  `expf`, not `__expf`: no fast
// math.  Launches run on the caller's stream, allocate nothing and
// return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;   // time steps staged in shared memory at once

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

// Channels per block for a state of N lanes: 256 threads, at most 64
// channels (so N = 1 and 2 run 64 and 128 threads).
template <int N>
struct Tile {
  static constexpr int kChannels = (256 / N) < 64 ? (256 / N) : 64;
  static constexpr int kThreads = kChannels * N;
};

// grid (ceil(D / channels), batch); block Tile<N>::kThreads.  Thread
// tid holds lane n = tid % N of channel d0 + tid / N.
template <typename T, int N>
__global__ void __launch_bounds__(Tile<N>::kThreads)
    ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dres,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ h_last, int L, int D) {
  constexpr int BD = Tile<N>::kChannels;
  constexpr int kThreads = Tile<N>::kThreads;
  __shared__ float xs[kChunk][BD];
  __shared__ float dts[kChunk][BD];
  __shared__ float ys[kChunk][BD];
  __shared__ float bs[kChunk][N];
  __shared__ float cs[kChunk][N];

  const int tid = threadIdx.x;
  const int dl = tid / N;
  const int n = tid % N;
  const int d0 = blockIdx.x * BD;
  const int d = d0 + dl;
  const bool live = d < D;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * L;  // row (b, 0)
  const size_t state = (static_cast<size_t>(blockIdx.y) * D + d) * N + n;

  float a = 0.f, dres = 0.f, h = 0.f;
  if (live) {
    a = A[static_cast<size_t>(d) * N + n];
    dres = Dres[d];
    if (h0 != nullptr) h = h0[state];
  }

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int steps = min(kChunk, L - t0);
    for (int i = tid; i < kChunk * BD; i += kThreads) {
      const int tt = i / BD, dd = i % BD;
      float xv = 0.f, dv = 0.f;
      if (tt < steps && d0 + dd < D) {
        const size_t off = (row0 + t0 + tt) * D + d0 + dd;
        xv = to_f32(x[off]);
        dv = to_f32(dt[off]);
      }
      xs[tt][dd] = xv;
      dts[tt][dd] = dv;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int tt = i / N, nn = i % N;
      float bv = 0.f, cv = 0.f;
      if (tt < steps) {
        const size_t off = (row0 + t0 + tt) * N + nn;
        bv = to_f32(Bm[off]);
        cv = to_f32(Cm[off]);
      }
      bs[tt][nn] = bv;
      cs[tt][nn] = cv;
    }
    __syncthreads();

    for (int tt = 0; tt < steps; ++tt) {
      const float xv = xs[tt][dl];
      const float dv = dts[tt][dl];
      h = expf(dv * a) * h + (dv * xv) * bs[tt][n];
      float p = h * cs[tt][n];
      // every lane of the warp takes part (dead channels carry zeros)
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[tt][dl] = p + dres * xv;
    }
    __syncthreads();

    for (int i = tid; i < steps * BD; i += kThreads) {
      const int tt = i / BD, dd = i % BD;
      if (d0 + dd < D)
        y[(row0 + t0 + tt) * D + d0 + dd] = from_f32<T>(ys[tt][dd]);
    }
    // The next chunk's staging writes xs/dts/bs/cs only, and ys is
    // written again only after the __syncthreads that follows it.
  }
  if (live && h_last != nullptr) h_last[state] = h;
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* Dres,
                   const float* h0, void* y, float* h_last, int batch, int L,
                   int D, cudaStream_t stream) {
  constexpr int BD = Tile<N>::kChannels;
  const dim3 grid((D + BD - 1) / BD, batch);
  ssm_scan_kernel<T, N><<<grid, Tile<N>::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), Dres, h0,
      static_cast<T*>(y), h_last, L, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, const float* Dres,
                     const float* h0, void* y, float* h_last, int batch,
                     int L, int D, int N, cudaStream_t st) {
  switch (N) {
    case 1: return launch<T, 1>(x, dt, A, Bm, Cm, Dres, h0, y, h_last, batch, L, D, st);
    case 2: return launch<T, 2>(x, dt, A, Bm, Cm, Dres, h0, y, h_last, batch, L, D, st);
    case 4: return launch<T, 4>(x, dt, A, Bm, Cm, Dres, h0, y, h_last, batch, L, D, st);
    case 8: return launch<T, 8>(x, dt, A, Bm, Cm, Dres, h0, y, h_last, batch, L, D, st);
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, Dres, h0, y, h_last, batch, L, D, st);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, Dres, h0, y, h_last, batch, L, D, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, dt (batch, L, D) and B, C (batch, L, N) in `dtype` (0 = float32,
// 1 = bfloat16), A (D, N), Dres (D,) float32; h0 and h_last (batch, D, N)
// float32 or null; y (batch, L, D) in `dtype`.  N is a power of two <= 32.
int ssm_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* Dres,
                    const void* h0, void* y, void* h_last, int batch, int L,
                    int D, int N, int dtype, void* stream) {
  if (batch <= 0 || L <= 0 || D <= 0) return cudaSuccess;
  const float* a = static_cast<const float*>(A);
  const float* dr = static_cast<const float*>(Dres);
  const float* s0 = static_cast<const float*>(h0);
  float* s1 = static_cast<float*>(h_last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, a, Bm, Cm, dr, s0, y, s1, batch, L, D, N,
                           st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, a, Bm, Cm, dr, s0, y, s1, batch,
                                   L, D, N, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
