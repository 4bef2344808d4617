// All-gather-consuming matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `all_gather_matmul` of
// repro/kernels/fused_collectives.py (kernel body `_ag_matmul_kernel`,
// pl.pallas_call at fused_collectives.py:192), which the JAX train step
// reaches through `fused_dense` behind --fuse-kernels: the FSDP gather hands
// the matmul a rank-major stack of weight shards, and the matmul consumes
// the stack in place instead of a concatenated weight.
//
//   y (T, N) = x (T, n*Ks) @ concat_k(w_shards (n, Ks, N))      (f32 FMA)
//
// The stack is read where the gather left it: shard s starts
// `shard_stride` elements after shard s-1 (the stride of the gathered
// bucket, not Ks * N), rows of a shard are N apart and contiguous.  The
// K loop walks shard 0..n-1 and, inside each, its Ks rows, so the
// concatenated weight never exists in memory.
//
// What bounds it on the H100: operations.  2*T*N*K flops against reading
// x and w once and writing y once; at the training path's shapes (T = 1024,
// K >= 2048) that is far above the card's fp32 ridge.  The model trains in
// f32 with TF32 off, so this first version runs on the CUDA cores in f32
// FMA (67 TFLOP/s peak); wgmma/TMA staging are later work.
//
// What the design does about it: the classic shared-memory tiled SGEMM.
// One block of 256 threads per 128 x 128 output tile; per 8-deep K slab
// the block stages a 128 x 8 tile of x (transposed, so a thread's 8 rows
// are one float4 pair) and an 8 x 128 tile of w, and each thread
// accumulates an 8 x 8 patch in registers (rows ty*4+i and 64+ty*4+i,
// columns tx*4+j and 64+tx*4+j), so each shared-memory float feeds 8 FMAs.
// Ragged T, N and K edges are masked with zero fill, so any shape runs.
// Launches run on the caller's stream, allocate nothing and return
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 8;          // K slab
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each

__global__ void __launch_bounds__(kThreads)
    ag_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int T, int K, int N, int Ks,
                     long long shard_stride) {
  __shared__ __align__(16) float As[BK][BM];  // x tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];  // w tile

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // staging assignments: x tile row a_row, k columns a_k..a_k+3;
  // w tile row b_row, columns b_col..b_col+3
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int b_row = tid >> 5;
  const int b_col = (tid & 31) * 4;
  const int gm = m0 + a_row;
  const float* xrow = x + static_cast<long long>(gm) * K;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gk = k0 + a_k + j;
      As[a_k + j][a_row] = (gm < T && gk < K) ? __ldg(xrow + gk) : 0.f;
    }
    const int gk = k0 + b_row;
    const float* wrow = nullptr;
    if (gk < K) {
      const int s = gk / Ks;  // shard, then its row: the stack in place
      wrow = w + s * shard_stride + static_cast<long long>(gk - s * Ks) * N;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + b_col + j;
      Bs[b_row][b_col + j] = (wrow != nullptr && gn < N) ? __ldg(wrow + gn)
                                                          : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= T) continue;
    float* yrow = y + static_cast<long long>(r) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < N) yrow[c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x: (T, K) contiguous f32 with K = n * Ks; w: n shards of (Ks, N) f32,
// shard s at w + s * shard_stride, rows N apart, contiguous; y: (T, N).
int all_gather_matmul_launch(const void* x, const void* w, void* y, int T,
                             int n, int Ks, int N, long long shard_stride,
                             void* stream) {
  if (T <= 0 || N <= 0) return cudaSuccess;
  if (n <= 0 || Ks <= 0) return cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (T + BM - 1) / BM);
  ag_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), T, n * Ks, N, Ks, shard_stride);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
