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
// f32 the function reads x and dt and writes y (3 x 33.55 MB), reads A,
// D, B and C (0.66 MB) and writes h_last (0.52 MB): 0.0304 ms at
// 3.35 TB/s.  It evaluates one exp per (b, t, d, n), 134 M of them,
// which the SFU issues at 16 per clock per SM: 0.0321 ms at 132 SMs x
// 1.98 GHz.  So the exps bound it, just above the bytes.  A decode step
// (4, 1, 8192, 16) from h0 reads the state and writes it again (2 x
// 2.10 MB) beside x, dt, y, A and D: 0.00154 ms of bytes, against 0.5 M
// exps (0.00016 ms); the bytes bound it.  Past the SFU, an accurate
// `expf` is 8 instructions of the FMA pipe, and the step around it
// (dt*A, the drive, the state update, the y product) 4 more: about 12
// issue slots per (t, d, n), 0.048 ms at one warp instruction per clock
// on each of the 528 schedulers.
//
// What the design does about it.  On the TPU the sequence is the
// sequential (innermost) grid axis and the state lives in VMEM scratch
// between grid steps.  Hopper's blocks run in no order, so the L loop
// runs inside the block, and the state stays in registers:
// * A thread holds K = 4 consecutive state lanes of one channel (N when
//   N < 4), with their A.  Per time step it reads x and dt (one scalar
//   each) and its 4 values of B and of C (16-byte broadcasts from shared
//   memory), and forms dt*x once.  y's sum over its lanes is 4 in-thread
//   FMAs.  The G = N / K threads of a channel are adjacent lanes of one
//   warp; they combine their sums for G steps at once by a
//   reduce-scatter, G - 1 shuffles after which lane g holds step g's
//   total; that lane adds D*x and stores y, so a warp's store covers G
//   rows of 32 / G adjacent channels.  A block owns 32 channels.
// * A thread takes 16 time steps with no branch among them, so the
//   compiler interleaves their 64 independent exps.  A short stage goes
//   G steps at a time; the rows it reads past L are zero-filled, and a
//   step with dt = x = 0 leaves the state exactly as it was (exp(0) =
//   1), so no step needs a test.
// * x, dt, B and C arrive through a 2-stage ring of 64 time steps (32 at
//   N = 32) in shared memory, filled by 16-byte cp.async copies: the next
//   stage is in flight while one is scanned, one barrier per stage.
//   Shapes whose rows are not 16-byte aligned (a ragged D or a small N)
//   fill the same ring with plain loads.
// * One pass: L is never split.  At B = 1 the grid holds D * N / K
//   threads, 7.75 warps per SM at Falcon-Mamba's D = 8192 (a trial that
//   split L into chunks rescanned from a carried state gave more warps
//   but formed each decay twice, and ran slower at that width).
// * exp: `expf`, accurate, no fast math.  `exp2f` on A * log2(e) was not
//   measured against the tolerance, so `expf` stays.
// * No atomics and a fixed order of every sum: a repeat is bitwise equal
//   (the serving path's eviction check restores a cache image and needs
//   the same bits again).
//
// Launches run on the caller's stream, allocate nothing and return
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChannels = 32;  // channels per block

__device__ __forceinline__ float decay(float dv, float a) {
  return expf(dv * a);
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async with zero fill: nothing is read where `ok` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int P>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(P));
}

// K consecutive values at p (in shared memory, aligned to K elements up
// to 16 bytes) as f32: 16-byte vector loads where K allows.
template <int K>
__device__ __forceinline__ void load_k(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = p[j];
  }
}
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& lo,
                                              float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
template <int K>
__device__ __forceinline__ void load_k(const __nv_bfloat16* p,
                                       float (&v)[K]) {
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + j);
      unpack_bf16x2(q.x, v[j], v[j + 1]);
      unpack_bf16x2(q.y, v[j + 2], v[j + 3]);
      unpack_bf16x2(q.z, v[j + 4], v[j + 5]);
      unpack_bf16x2(q.w, v[j + 6], v[j + 7]);
    }
  } else if constexpr (K == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(q.x, v[0], v[1]);
    unpack_bf16x2(q.y, v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = __bfloat162float(p[j]);
  }
}
// K consecutive f32 values of global memory (16-byte aligned for K >= 4).
template <int K>
__device__ __forceinline__ void ld_state(const float* p, float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = p[j];
  }
}
template <int K>
__device__ __forceinline__ void st_state(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = v[j];
  }
}

template <typename T, int N, int K>
struct Cfg {
  static constexpr int kGroup = N / K;                 // threads a channel
  static constexpr int kThreads = kChannels * kGroup;
  // a 2-stage ring of 64 time steps (32 at N = 32): 48 KiB of f32 at most
  static constexpr int kSteps = N == 32 ? 32 : 64;
  static constexpr int kStages = 2;
  // time steps a thread takes at once in a full stage (a multiple of G)
  static constexpr int kUnroll = 16;
  // one ring stage: x and dt (kSteps x kChannels), B and C (kSteps x N)
  static constexpr int kXElems = kSteps * kChannels;
  static constexpr int kBElems = kSteps * N;
  static constexpr int kStageElems = 2 * kXElems + 2 * kBElems;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr size_t kRingBytes =
      static_cast<size_t>(kStages) * kStageElems * sizeof(T);
};

// Arguments of one scan launch.
template <typename T>
struct Args {
  const T* x; const T* dt; const float* A; const T* Bm; const T* Cm;
  const float* Dres; const float* h0; T* y; float* h_last;
  int L, D, vec;
};

// grid (ceil(D / 32), batch); block Cfg::kThreads.  Thread tid holds
// lanes [g*K, g*K + K) of channel d0 + tid / G, g = tid % G, and scans
// all of L.
template <typename T, int N, int K>
__global__ void __launch_bounds__(Cfg<T, N, K>::kThreads)
    ssm_scan_kernel(const Args<T> p) {
  using C = Cfg<T, N, K>;
  constexpr int G = C::kGroup;
  constexpr int S = C::kStages;
  constexpr int kSteps = C::kSteps;
  __shared__ __align__(16) unsigned char ring_raw[C::kRingBytes];
  T* ring = reinterpret_cast<T*>(ring_raw);

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int dl = tid / G;
  const int n0 = g * K;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + dl;
  const bool live = d < p.D;
  const int b = blockIdx.y;
  const int nsub = (p.L + kSteps - 1) / kSteps;
  const size_t row0 = static_cast<size_t>(b) * p.L;  // row (b, 0)
  const size_t state = (static_cast<size_t>(b) * p.D + d) * N + n0;
  // y of this thread's channel at step 0
  T* const y_col = p.y + (live ? row0 * p.D + d : 0);

  // ---- fill stage s with time steps [t0, t0 + kSteps) ----------------
  // Rows past L are zero-filled as far as the scan reads them (a short
  // stage is scanned G steps at a time).
  auto stage = [&](int s, int t0) {
    T* xs = ring + s * C::kStageElems;
    T* dts = xs + C::kXElems;
    T* bs = dts + C::kXElems;
    T* cs = bs + C::kBElems;
    const int rows = min(kSteps, p.L - t0);
    const int fill = min(kSteps, (rows + G - 1) / G * G);
    if (p.vec) {
      constexpr int per_row = kChannels / C::kVec;
      for (int i = tid; i < fill * per_row; i += C::kThreads) {
        const int tt = i / per_row, col = (i % per_row) * C::kVec;
        const bool ok = tt < rows && d0 + col < p.D;
        const size_t off = ok ? (row0 + t0 + tt) * p.D + d0 + col : 0;
        cp_async16(xs + tt * kChannels + col, p.x + off, ok);
        cp_async16(dts + tt * kChannels + col, p.dt + off, ok);
      }
      // B and C rows of the stage are one contiguous run of rows * N
      for (int i = tid * C::kVec; i < fill * N; i += C::kThreads * C::kVec) {
        const bool ok = i < rows * N;
        const size_t off = ok ? (row0 + t0) * N + i : 0;
        cp_async16(bs + i, p.Bm + off, ok);
        cp_async16(cs + i, p.Cm + off, ok);
      }
    } else {
      const T zero = from_f32<T>(0.f);
      for (int i = tid; i < fill * kChannels; i += C::kThreads) {
        const int tt = i / kChannels, dd = i % kChannels;
        const bool ok = tt < rows && d0 + dd < p.D;
        const size_t off = (row0 + t0 + tt) * p.D + d0 + dd;
        xs[i] = ok ? p.x[off] : zero;
        dts[i] = ok ? p.dt[off] : zero;
      }
      for (int i = tid; i < fill * N; i += C::kThreads) {
        const bool ok = i < rows * N;
        const size_t off = (row0 + t0) * N + i;
        bs[i] = ok ? p.Bm[off] : zero;
        cs[i] = ok ? p.Cm[off] : zero;
      }
    }
  };

  // start the ring before the state loads, so the copies overlap them
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nsub) stage(s, s * kSteps);
    cp_async_commit();
  }

  float a[K], h[K];
  float dres = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) a[j] = h[j] = 0.f;
  if (live) {
    ld_state<K>(p.A + static_cast<size_t>(d) * N + n0, a);
    dres = p.Dres[d];
    if (p.h0 != nullptr) ld_state<K>(p.h0 + state, h);
  }

  for (int i = 0; i < nsub; ++i) {
    cp_async_wait<S - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();         // ... everyone's; stage i - 1 is free
    if (i + S - 1 < nsub)
      stage((i + S - 1) % S, (i + S - 1) * kSteps);
    cp_async_commit();

    const T* xs = ring + (i % S) * C::kStageElems;
    const T* dts = xs + C::kXElems;
    const T* bs = dts + C::kXElems;
    const T* cs = bs + C::kBElems;
    const int rows = min(kSteps, p.L - i * kSteps);
    // U steps with no branch among them: the stage's rows past `rows`
    // are zero-filled, and a step with dt = x = 0 leaves h exactly as it
    // was (exp(0) = 1)
    auto steps = [&](auto width, int t0) {
      constexpr int U = decltype(width)::value;
      float part[U];  // this thread's share of y per step
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tt = t0 + u;
        const float dv = to_f32(dts[tt * kChannels + dl]);
        const float dx = dv * to_f32(xs[tt * kChannels + dl]);
        float bv[K], cv[K];
        load_k<K>(bs + tt * N + n0, bv);
        load_k<K>(cs + tt * N + n0, cv);
        part[u] = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          h[j] = decay(dv, a[j]) * h[j] + dx * bv[j];
          part[u] += h[j] * cv[j];
        }
      }
      // The channel's G threads are adjacent lanes.  Each group of G
      // steps is reduce-scattered over them: at each stage a lane keeps
      // half of its sums, adds its partner's half, and after log2(G)
      // stages lane g holds step g's total (G - 1 shuffles for G
      // steps).  Every lane of the warp takes part (dead channels carry
      // zeros), and the order of the adds is fixed.
#pragma unroll
      for (int s0 = 0; s0 < U; s0 += G) {
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
          const bool upper = g & off;
#pragma unroll
          for (int q = s0; q < s0 + off; ++q) {
            const float send = upper ? part[q] : part[q + off];
            const float keep = upper ? part[q + off] : part[q];
            part[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
        }
        // lane g writes step t0 + s0 + g: a warp stores G rows of 32 / G
        // adjacent channels (full 32-byte sectors in f32)
        const int tt = t0 + s0 + g;
        if (live && tt < rows)
          y_col[static_cast<size_t>(i * kSteps + tt) * p.D] = from_f32<T>(
              part[s0] + dres * to_f32(xs[tt * kChannels + dl]));
      }
    };
    int t0 = 0;
    for (; t0 + C::kUnroll <= rows; t0 += C::kUnroll)
      steps(std::integral_constant<int, C::kUnroll>{}, t0);
    for (; t0 < rows; t0 += G)  // a short stage: G steps at a time
      steps(std::integral_constant<int, G>{}, t0);
  }
  cp_async_wait<0>();
  if (live && p.h_last != nullptr) st_state<K>(p.h_last + state, h);
}

template <typename T, int N, int K>
cudaError_t launch(const Args<T>& a, int batch, cudaStream_t st) {
  using C = Cfg<T, N, K>;
  const int dblocks = (a.D + kChannels - 1) / kChannels;
  ssm_scan_kernel<T, N, K>
      <<<dim3(dblocks, batch), C::kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args<T>& a, int batch, int N, int k,
                     cudaStream_t st) {
#define REPRO_SSM(NN, KK) \
  if (N == NN && k == KK) return launch<T, NN, KK>(a, batch, st)
  REPRO_SSM(1, 1);
  REPRO_SSM(2, 2);
  REPRO_SSM(4, 4);
  REPRO_SSM(8, 4);
  REPRO_SSM(16, 4);
  REPRO_SSM(32, 4);
#undef REPRO_SSM
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, dt (batch, L, D) and B, C (batch, L, N) in `dtype` (0 = float32,
// 1 = bfloat16), A (D, N), Dres (D,) float32; h0 and h_last (batch, D, N)
// float32 or null; y (batch, L, D) in `dtype`.  N is a power of two <= 32.
// k (the wrapper's ssm_geometry): lanes a thread, N for N < 4, else 4.
// vec: 1 for 16-byte copies, which need D and L * N whole 16-byte rows
// and 16-byte aligned x, dt, B and C; 0 for plain loads (any shape).
int ssm_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* Dres,
                    const void* h0, void* y, void* h_last, int batch, int L,
                    int D, int N, int dtype, int k, int vec, void* stream) {
  if (batch <= 0 || L <= 0 || D <= 0) return cudaSuccess;
  const int item = dtype == 0 ? 4 : 2;
  if (vec && ((static_cast<long long>(D) * item) % 16 ||
              (static_cast<long long>(L) * N * item) % 16 ||
              reinterpret_cast<uintptr_t>(x) % 16 ||
              reinterpret_cast<uintptr_t>(dt) % 16 ||
              reinterpret_cast<uintptr_t>(Bm) % 16 ||
              reinterpret_cast<uintptr_t>(Cm) % 16))
    return cudaErrorMisalignedAddress;
  // k >= 4 moves A and the states 16 bytes at a time
  if (k % 4 == 0 && (reinterpret_cast<uintptr_t>(A) % 16 ||
                     reinterpret_cast<uintptr_t>(h0) % 16 ||
                     reinterpret_cast<uintptr_t>(h_last) % 16))
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* dr = static_cast<const float*>(Dres);
  const float* s0 = static_cast<const float*>(h0);
  float* s1 = static_cast<float*>(h_last);
  if (dtype == 0) {
    const Args<float> args{static_cast<const float*>(x),
                           static_cast<const float*>(dt), a,
                           static_cast<const float*>(Bm),
                           static_cast<const float*>(Cm), dr, s0,
                           static_cast<float*>(y), s1, L, D, vec};
    return dispatch<float>(args, batch, N, k, st);
  }
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    const Args<B16> args{static_cast<const B16*>(x),
                         static_cast<const B16*>(dt), a,
                         static_cast<const B16*>(Bm),
                         static_cast<const B16*>(Cm), dr, s0,
                         static_cast<B16*>(y), s1, L, D, vec};
    return dispatch<B16>(args, batch, N, k, st);
  }
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
