// All-gather-consuming matmul for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `all_gather_matmul` of
// repro/kernels/fused_collectives.py (kernel body `_ag_matmul_kernel`,
// fused_collectives.py:154-171, pl.pallas_call at fused_collectives.py:192),
// which the JAX train step reaches through `fused_dense` behind
// --fuse-kernels: the FSDP gather hands the matmul a rank-major stack of
// weight shards, and the matmul consumes the stack in place instead of a
// concatenated weight.
//
//   y (T, N) = x (T, n*Ks) @ concat_k(w_shards (n, Ks, N))      (f32)
//
// The stack is read where the gather left it: shard s starts
// `shard_stride` elements after shard s-1 (the stride of the gathered
// bucket, not Ks * N), rows of a shard are N apart and contiguous.  The
// K loop walks shard 0..n-1 and, inside each, its Ks rows (each staged w
// row finds its shard and row on its own), so the concatenated weight
// never exists in memory.
//
// What bounds it on the H100: operations.  2*T*N*K flops against reading
// x and w once and writing y once; at the training path's shapes (T =
// 1024, K >= 2048) that is far above the ridge.  The model trains in f32
// with TF32 off, so the product must stay f32-accurate: this kernel runs
// it on the tensor cores in 3xTF32 (wgmma tf32), whose ceiling is
// 495 / 3 = 165 TFLOP/s against the 67 TFLOP/s of f32 FMA on the CUDA
// cores, which also caps cuBLAS's f32 GEMM.
//
// What the design does about it:
// * 3xTF32: each operand a is split into big = tf32_rn(a) and small =
//   tf32_rn(a - big), rounding to nearest with ties away from zero on the
//   bit pattern (what cvt.rna.tf32.f32 does, in two integer ops instead of
//   the slower conversion), and each product accumulates small_a*big_b +
//   big_a*small_b + big_a*big_b in f32 on the tensor cores: about 22 bits
//   of each operand; the small*small term (2^-22 relative) is dropped.
// * Promoted sums: the tensor cores' f32 accumulation does not round to
//   nearest (left to run over all of K it drifted past the f32
//   tolerance on the card), so each 32-deep K slab accumulates from zero
//   (the first wgmma of a slab does not read its accumulator) and is
//   added to the running sum with an ordinary f32 add.
// * wgmma m64nNk8 tf32, A from registers, B from shared memory.  A block
//   of 1 or 2 warpgroups owns a 64- or 128-row output tile; each
//   warpgroup its 64 rows.  The w slab is split once per block into
//   K-major big and small tiles of 8 x 16-byte core matrices (the layout
//   wgmma reads for tf32; w is N-major in memory, so the split pass is
//   also the transpose); each thread splits its own x fragments.
// * A ring of 4 shared-memory stages of raw slabs filled by cp.async
//   (16-byte copies where K, N, the shard stride and both bases allow it,
//   4-byte copies otherwise: the VEC template parameter), and two split
//   buffers: while the tensor cores take slab k, the warps split slab
//   k+1's w tile and the loads for slab k+3 are in flight.
// * Launch geometry per shape (the wrapper's pure `agm_geometry`): the
//   128 x 128 tile wherever its grid reaches 90% of the SMs (N = 2048 at
//   T = 1024 gives 128 blocks, measured faster than every tile that gives
//   all 132 SMs a block), else 64 x 32 (N = 512: 256 blocks).  Blocks
//   walk M fastest, so the blocks resident together share one w column
//   panel in L2.
// * No atomics and a fixed order of every sum: two calls on the same
//   inputs are bitwise equal.
//
// Measured (chip_smoke.py, H100 80GB HBM3, 700 W; PERF.md §6 has the
// table): 0.60371 ms at (1024, 2048) @ (4, 512, 8192), 34% of its 3xTF32
// bound, against cuBLAS's f32 GEMM at 0.67967 in the same run and the
// earlier CUDA-core SGEMM at 1.26279; 0.17320 at N = 2048 (cuBLAS 0.18836) and
// 0.07116 at N = 512 (cuBLAS 0.05824).  What still holds it back: the
// warps load, split and wait in lockstep (two barriers a slab, one block
// per SM at 128 x 128), so the tensor cores idle about two thirds of the
// time.  A producer warpgroup feeding two consumer warpgroups through
// mbarriers was tried and ran slower: 128 threads could not load and
// split a 128 x 128 tile's slabs as fast as wgmma consumed them.
//
// Launches run on the caller's stream, allocate nothing and return
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;       // K slab
constexpr int STAGES = 4;    // raw-slab ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: nothing is read where `ok` is false.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 3xTF32 split of one f32 value: tf32 round to nearest, ties away from
// zero, on the bit pattern (the low 13 bits, which tf32 drops, cleared).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const float rest = x - __uint_as_float(big);
  small = (__float_as_uint(rest) + 0x1000u) & 0xFFFFE000u;
}

// d (64 x N f32, the warpgroup's accumulator fragments) = a (64 x 8 tf32,
// this warp's 16 rows in registers) * B (8 x N tf32, shared memory, by
// descriptor) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// Shared-memory matrix descriptor, no swizzle: 8-row x 16-byte core
// matrices; lbo is the byte step between cores adjacent in K, sbo in N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  return (static_cast<uint64_t>(smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

template <int BN_, int WGS>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int BM = 64 * WGS;          // 64 rows per warpgroup
  static constexpr int kThreads = 128 * WGS;
  static constexpr int AP = BK + 4;  // raw x tile row stride: 4 mod 32
  static constexpr int BP = BN + 8;  // raw w tile row stride: 8 mod 32
  static constexpr int A_FLOATS = BM * AP, B_FLOATS = BK * BP;
  static constexpr int RAW = A_FLOATS + B_FLOATS;
  static constexpr int SPLIT = BK * BN;        // one split w tile
  static constexpr int LBO = (BN / 8) * 128;   // bytes, cores along K
  static constexpr int SBO = 128;              // bytes, cores along N
  static constexpr size_t SMEM =
      (static_cast<size_t>(STAGES) * RAW + 4 * SPLIT) * sizeof(float);
  static_assert(BN % 32 == 0, "row strides");
};

// The compiled block tiles, in the order agm_geometry tries them.
using Tile0 = Tile<128, 2>;  // 128 x 128, two warpgroups
using Tile1 = Tile<32, 1>;   // 64 x 32, one warpgroup

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  if constexpr (BN == 128)
    wgmma_n128(d, a, desc, accumulate);
  else
    wgmma_n32(d, a, desc, accumulate);
}

// Stage K slab at k0: the x tile (BM x BK) and the w tile (BK x BN), raw.
template <class C, bool VEC>
__device__ __forceinline__ void load_slab(
    float* As, float* Bs, const float* __restrict__ x,
    const float* __restrict__ w, int m0, int n0, int k0, int T, int K, int N,
    int Ks, long long shard_stride) {
  const int tid = threadIdx.x;
  // chunks of 4 floats (VEC) or single floats, a fixed number per thread
  constexpr int E = VEC ? 4 : 1;
  constexpr int A_PER = C::BM * BK / E / C::kThreads;
  constexpr int B_PER = BK * C::BN / E / C::kThreads;
  static_assert(A_PER * E * C::kThreads == C::BM * BK &&
                B_PER * E * C::kThreads == BK * C::BN, "staging split");
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int c = tid + i * C::kThreads;
    const int r = c / (BK / E), col = (c % (BK / E)) * E;
    const bool ok = m0 + r < T && k0 + col < K;
    const float* src =
        ok ? x + static_cast<long long>(m0 + r) * K + k0 + col : x;
    if (VEC)
      cp_async16(As + r * C::AP + col, src, ok);
    else
      cp_async4(As + r * C::AP + col, src, ok);
  }
#pragma unroll
  for (int i = 0; i < B_PER; ++i) {
    const int c = tid + i * C::kThreads;
    const int r = c / (C::BN / E), col = (c % (C::BN / E)) * E;
    const int gk = k0 + r;
    const bool ok = gk < K && n0 + col < N;
    const float* src = w;
    if (ok) {
      const int s = gk / Ks;  // shard, then its row: the stack in place
      src = w + s * shard_stride + static_cast<long long>(gk - s * Ks) * N +
            n0 + col;
    }
    if (VEC)
      cp_async16(Bs + r * C::BP + col, src, ok);
    else
      cp_async4(Bs + r * C::BP + col, src, ok);
  }
}

template <class C, bool VEC>
__global__ void __launch_bounds__(C::kThreads)
    agm_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, int T, int K, int N, int Ks,
                      long long shard_stride) {
  constexpr int BN = C::BN;
  extern __shared__ __align__(128) float smem[];
  float* split = smem;                  // [2][big, small][BK/4][BN/8] cores
  float* raw = smem + 4 * C::SPLIT;     // [STAGES][x tile, w tile]

  const int m0 = blockIdx.x * C::BM;  // M fastest: resident blocks share w
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in it

  float acc[BN / 2], part[BN / 2];  // the running sum, this slab's sum
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t ab[BK / 8][4], as[BK / 8][4];  // this warp's x fragments

  // Split slab kt's w tile into split buffer kt & 1: core (kg, ng) holds
  // rows n = 8 ng .. 8 ng + 7 of k = 4 kg .. 4 kg + 3, 16 bytes a row.
  auto split_w = [&](int kt) {
    const float* bs = raw + (kt % STAGES) * C::RAW + C::A_FLOATS;
    float* big = split + (kt & 1) * 2 * C::SPLIT;
    float* small = big + C::SPLIT;
#pragma unroll
    for (int i = 0; i < BN * (BK / 4) / C::kThreads; ++i) {
      const int c = threadIdx.x + i * C::kThreads;
      const int n = c % BN, kg = c / BN;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(bs[(kg * 4 + j) * C::BP + n], hi[j], lo[j]);
      const int off = ((kg * (BN / 8) + n / 8) * 8 + n % 8) * 4;
      *reinterpret_cast<uint4*>(big + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(small + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    // the tensor cores read through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  // Split this warp's x fragments of slab kt: (row g, k t), (g+8, t),
  // (g, t+4), (g+8, t+4) of each 8-deep step, rows 16 * warp on.
  auto split_x = [&](int kt) {
    const float* xs = raw + (kt % STAGES) * C::RAW;
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const float* p = xs + (warp * 16 + g) * C::AP + s * 8 + t;
      split_tf32(p[0], ab[s][0], as[s][0]);
      split_tf32(p[8 * C::AP], ab[s][1], as[s][1]);
      split_tf32(p[4], ab[s][2], as[s][2]);
      split_tf32(p[8 * C::AP + 4], ab[s][3], as[s][3]);
    }
  };

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_slab<C, VEC>(raw + s * C::RAW, raw + s * C::RAW + C::A_FLOATS, x,
                        w, m0, n0, s * BK, T, K, N, Ks, shard_stride);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // slab 0 has landed
  __syncthreads();
  split_w(0);
  split_x(0);
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    // the tensor cores take slab kt ...
    const char* big = reinterpret_cast<const char*>(split +
                                                    (kt & 1) * 2 * C::SPLIT);
    const char* small = big + C::SPLIT * sizeof(float);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {  // two K cores a step
      const uint64_t db = smem_desc(big + s * 2 * C::LBO, C::LBO, C::SBO);
      const uint64_t ds = smem_desc(small + s * 2 * C::LBO, C::LBO, C::SBO);
      wgmma_tf32<BN>(part, as[s], db, s > 0);  // a slab starts from zero
      wgmma_tf32<BN>(part, ab[s], ds, 1);
      wgmma_tf32<BN>(part, ab[s], db, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // ... while the warps split slab kt + 1's w tile into the other buffer
    if (kt + 1 < KT) {
      cp_async_wait<STAGES - 3>();  // slab kt + 1 has landed
      __syncthreads();              // for every thread; kt - 1's raw is free
      const int nk = kt + STAGES - 1;
      if (nk < KT) {
        float* st = raw + (nk % STAGES) * C::RAW;
        load_slab<C, VEC>(st, st + C::A_FLOATS, x, w, m0, n0, nk * BK, T, K,
                          N, Ks, shard_stride);
      }
      cp_async_commit();
      split_w(kt + 1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    if (kt + 1 < KT) split_x(kt + 1);  // the wgmma is done with the old
    __syncthreads();                   // slab kt + 1's split is complete
  }
  cp_async_wait<0>();

  // acc[4j + 0..1]: (row g, cols 8j + 2t, +1); acc[4j + 2..3]: row g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + warp * 16 + g + 8 * h;
    if (r >= T) continue;
    float* yrow = y + static_cast<long long>(r) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + j * 8 + 2 * t;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (VEC) {  // N even: c < N means c + 1 < N, and 8-byte aligned
        if (c < N) *reinterpret_cast<float2*>(yrow + c) = make_float2(v0, v1);
      } else {
        if (c < N) yrow[c] = v0;
        if (c + 1 < N) yrow[c + 1] = v1;
      }
    }
  }
}

template <class C, bool VEC>
cudaError_t launch(const float* x, const float* w, float* y, int T, int K,
                   int N, int Ks, long long shard_stride, cudaStream_t st) {
  // a function attribute belongs to the current device's context: set it
  // on every launch, so a launch on another card is configured too
  cudaError_t err = cudaFuncSetAttribute(
      agm_tf32x3_kernel<C, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN);
  agm_tf32x3_kernel<C, VEC><<<grid, C::kThreads, C::SMEM, st>>>(
      x, w, y, T, K, N, Ks, shard_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (T, K) contiguous f32 with K = n * Ks; w: n shards of (Ks, N) f32,
// shard s at w + s * shard_stride, rows N apart, contiguous; y: (T, N).
// tile: 0 = 128 x 128, 1 = 64 x 32 output block.  vec: 1
// for 16-byte copies, which need K, N and shard_stride multiples of 4 and
// x, w 16-byte aligned; 0 for 4-byte copies (any shape).
int all_gather_matmul_launch(const void* x, const void* w, void* y, int T,
                             int n, int Ks, int N, long long shard_stride,
                             int tile, int vec, void* stream) {
  if (T <= 0 || N <= 0) return cudaSuccess;
  if (n <= 0 || Ks <= 0) return cudaErrorInvalidValue;
  const int K = n * Ks;
  if (vec && (K % 4 || N % 4 || shard_stride % 4 ||
              reinterpret_cast<uintptr_t>(x) % 16 ||
              reinterpret_cast<uintptr_t>(w) % 16))
    return cudaErrorMisalignedAddress;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_AGM(C)                                                      \
  return vec ? launch<C, true>(xf, wf, yf, T, K, N, Ks, shard_stride, st) \
             : launch<C, false>(xf, wf, yf, T, K, N, Ks, shard_stride, st)
  if (tile == 0) REPRO_AGM(Tile0);
  if (tile == 1) REPRO_AGM(Tile1);
#undef REPRO_AGM
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
