// Selective state-space scan (the Mamba-1 core, and Mamba-2's with one
// B/C group) and its backward, for Hopper (sm_90a), hand-written CUDA
// C++.
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
// At Zamba2's shapes (a Mamba-2 row: D = nh x headdim = 4096 channels,
// N = 64).  Prefill and training (1, 1024, 4096, 64): x, dt, y 3 x 16.78
// MB, B, C, A, D and h_last 2.64 MB, 52.97 MB in all, 0.0158 ms of
// bytes; 268 M exps, 0.0642 ms: the exps bound it.  Under grad the
// forward also writes its 64 checkpoints (67.1 MB): 0.0358 ms of bytes,
// still under the exps.  A decode step (4, 1, 4096, 64) from h0 reads
// and writes the state (2 x 4.19 MB) beside A, D, x, dt and y: 9.65 MB,
// 0.00288 ms; its 1 M exps take 0.00025: the bytes bound it.  The
// Mamba-2 function itself needs one exp a head a step (64, not 262,144):
// its bound at the prefill shape is the bytes and its 5 flops an
// element, about 0.024 ms; the redundant exps are ROADMAP queue 2's.
// The backward (below) takes dt, A and D per head on Mamba-2 calls and
// forms one exp a (t, head): its bound there is its flops, 0.048 ms.
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
//   N >= 32: 48 KiB of static shared memory at N = 64) in shared memory,
//   filled by 16-byte cp.async copies: the next stage is in flight while
//   one is scanned, one barrier per stage.
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

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kChannels = 32;  // channels per block

__device__ __forceinline__ float decay(float dv, float a) {
  return expf(__fmul_rn(dv, a));
}
// One step of one state lane: h = exp(dt*A) * h + (dt*x) * B, each
// product rounded where it is written (no contraction the compiler may
// choose otherwise in another kernel), so the backward's recompute from a
// checkpoint gives the forward's states bitwise.
__device__ __forceinline__ float step_h(float h, float dv, float a,
                                        float dx, float b) {
  return __fmaf_rn(decay(dv, a), h, __fmul_rn(dx, b));
}

constexpr int kCkpt = 16;  // steps between the forward's state checkpoints

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
  // a 2-stage ring of 64 time steps (32 at N >= 32): 48 KiB of f32 at
  // most (N = 64: 32 x (2 x 32 + 2 x 64) x 4 B x 2 stages = 48 KiB, the
  // static limit)
  static constexpr int kSteps = N >= 32 ? 32 : 64;
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
  float* hc;  // (batch, ceil(L / kCkpt), D, N) states before every
              // kCkpt-th step, or null
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
      // under grad: the state before every kCkpt-th step (kSteps and the
      // full groups are multiples of kCkpt, a short stage starts at one)
      if (p.hc != nullptr && live && t0 % kCkpt == 0)
        st_state<K>(p.hc + ((static_cast<size_t>(b) * ((p.L + kCkpt - 1) /
                                                        kCkpt) +
                             (i * kSteps + t0) / kCkpt) * p.D + d) * N + n0,
                    h);
      float part[U];  // this thread's share of y per step
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tt = t0 + u;
        const float dv = to_f32(dts[tt * kChannels + dl]);
        const float dx = __fmul_rn(dv, to_f32(xs[tt * kChannels + dl]));
        float bv[K], cv[K];
        load_k<K>(bs + tt * N + n0, bv);
        load_k<K>(cs + tt * N + n0, cv);
        part[u] = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          h[j] = step_h(h[j], dv, a[j], dx, bv[j]);
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
  REPRO_SSM(64, 4);
#undef REPRO_SSM
  return cudaErrorInvalidValue;
}


// ---- backward ----------------------------------------------------------
//
// The VJP of the scan for the upstream dy (and dh_last), in f32.  Walking
// L backwards with g = dL/dh_t (the state cotangent) and e = exp(dt A):
//
//   g        += C_t dy_t                     (then g = dL/dh_t)
//   dB_t[n]   = sum_d g[d, n] dt x           dC_t[n] = sum_d dy_t[d] h_t[d, n]
//   dx        = dt sum_n g B + D dy          ddt = x sum_n g B + sum_n g h_{t-1} e A
//   dA[d, n] += g h_{t-1} e dt               dD[d] += dy x
//   g        *= e                            (then g = dL/dh_{t-1} but C dy)
//
// ending with dh0 = g.  Two modes share one kernel.  Per channel (Mamba-1:
// dt (B, L, D), A (D, N), D (D,)) it is the formula above.  Per head
// (Mamba-2: dt (B, L, nh), A and D (nh,), P = D / nh channels a head) the
// decay is one number a (t, head), e = exp(dt_h A_h), and with S = sum over
// the head's (d, n) of g h_{t-1}:
//
//   ddt_h = sum_{d in h} x_d (sum_n g B) + A_h e S      dA_h = sum_{b,t} dt e S
//   dx_d  = dt_h sum_n g B + D_h dy_d                   dD_h = sum_{b,t,d in h} dy x
//
// so an element costs 8 flops and no exp: the recompute (dt x B, the fma
// with e), and in the walk the fma with C dy, the dB and dC products, the
// sums of g B and g h_{t-1}, and g *= e.
//
// What bounds it on the H100.  At Zamba2's training shape (1, 1024, 4096,
// 64) per head the function moves x, dy, dx (50.3 MB), dt and ddt per head
// (0.5 MB), B, C, dB, dC (1.0 MB) and the forward's 64 checkpoints (67.1
// MB): 119 MB, 0.0355 ms at 3.35 TB/s; its 8 flops an element (12 with the
// sums) are 3.2 G, 0.048 ms at 67 TFLOP/s: the flops bound it.  Per channel
// at Falcon's (1, 1024, 8192, 16) it also forms one exp an element (134 M,
// 0.032 ms of SFU) beside about 12 flops: 0.024 ms of flops, 0.060 ms of
// bytes (the checkpoints and ddt per channel).
//
// What the design does about it.
// * A thread holds K = 2 lanes (N itself at N = 1) of M channels: M = 4
//   per head, 2 per channel.  The G = N / K threads of a channel group are
//   adjacent lanes of a warp.  A block owns Cb channels (32; 16 per channel
//   at N >= 32; more at small N, so a block is whole warps).
// * Chunks of 16 steps, the forward's checkpoint spacing, from the last:
//   the chunk's x, dy and dt (16-byte cp.async where the shapes allow),
//   and B, C and its checkpoint (one bulk copy each, on an mbarrier)
//   arrive into one of two stages: the copies of chunk c - 1 are in
//   flight while chunk c is walked.  When a stage lands, dt x
//   is formed once a (t, channel) and, per head, e once a (t, head) (the
//   forward's `decay` on the same two f32 numbers, so the recompute gives
//   the forward's states bitwise); per channel the recompute forms each
//   decay once and keeps it in registers for the walk.  The chunk's 16
//   states stay in registers (16 x M x K).
// * Sums over a channel's lanes (g B and g h_{t-1}, or g h e A) are
//   reduce-scattered over the G threads by shuffles, R steps at once,
//   so that every lane ends with whole sums; sums over channels (dB, dC)
//   are in-thread over the M channels, then over the block's channel
//   groups through shared memory once a chunk: two barriers a chunk.
// * The blocks of a thread-block cluster (`ssm_bwd_geometry`: 2) add their
//   dB / dC partials over distributed shared memory in rank order, once
//   every 4 chunks (split cluster barrier, double-buffered: a cluster
//   barrier's arrive is a device-wide memory fence, about 1000 cycles),
//   so the partials that reach device memory shrink by the cluster size.
//   (At one block an SM the card holds only 30 clusters of 4, 120
//   blocks: a grid of 128 would take two waves.)  After a chunk, a warp a
//   step writes dx and, per head, the block's share of each head's sums;
//   a second launch adds the clusters' partials and the blocks' shares in
//   block order, a third the dA / dD terms over (b, t).
// * No atomics and a fixed order of every sum: a repeat is bitwise equal.
struct BwdArgs {
  const float* x; const float* dt; const float* A; const float* Bm;
  const float* Cm; const float* Dres; const float* hc; const float* dy;
  const float* dh_last;  // or null
  float* dx;
  float* ddt;      // per channel (batch, L, D); unused per head
  float* part_bc;  // (batch, clusters, L, 2N): a cluster's dB_t, dC_t
  float* part_h;   // per head (batch, L, blocks, hs, 3): a block's share
                   // of a head's sum_d x (g B), S and sum_d dy x
  float* part_ad;  // per channel (batch, D N + D): dA, dD of a batch row
  float* dh0;      // or null
  int L, D, P, hs, cl;  // P channels a head, hs head slots a block,
                        // cl blocks a cluster
  int vec;  // 1: x, dy, B, C and the checkpoints move 16 bytes a copy
};

template <int N, bool HEAD>
struct BwdCfg {
  static constexpr int kK = N < 2 ? N : 2;       // lanes a thread
  static constexpr int kG = N / kK;              // threads a channel group
  static constexpr int kM = HEAD ? 4 : 2;        // channels a thread
  static constexpr int kCb0 = HEAD || N < 32 ? 32 : 16;
  // channels a block: whole warps at small N
  static constexpr int kCb =
      kCb0 > 32 * kM / kG ? kCb0 : 32 * kM / kG;
  static constexpr int kCT = kCb / kM;           // channel groups
  static constexpr int kThreads = kCT * kG;
  static constexpr int kU = kCkpt;               // steps a chunk
  static constexpr int kX = 4;  // chunks whose dB / dC a cluster exchange
                                // carries
  // steps whose lane sums are reduce-scattered together: 2 M R = G values
  static constexpr int kR = kG / (2 * kM) < 1 ? 1 : kG / (2 * kM);
  static constexpr int kV = 2 * kM * kR;
  static constexpr int kVL = kV / kG;            // sums a lane ends with
  static_assert(kU % kR == 0 && kV % kG == 0 && kThreads % 32 == 0,
                "whole batches, whole sums, whole warps");
};

// Shared floats of the backward: two stages of [x, dy (U x Cb), dt (U x
// Cb, or U x hs per head), B, C (U x N), the checkpoint (Cb x N)], the
// chunk's dt x (U x Cb) and per head e (U x Cb), the channel-group
// partials of dB / dC (U x CT x 2N), two buffers of the block's dB / dC
// of X chunks (X U x 2N), the lane sums (2 x U x Cb), each channel's skip D (Cb) and
// head slot (Cb ints), per head each slot's A (hs), then the two stages'
// mbarriers (8-byte aligned).
template <int N, bool HEAD>
__host__ __device__ constexpr int bwd_stage_floats(int hs) {
  using C = BwdCfg<N, HEAD>;
  return 2 * C::kU * C::kCb + C::kU * (HEAD ? hs : C::kCb) + 2 * C::kU * N +
         C::kCb * N;
}
template <int N, bool HEAD>
__host__ __device__ constexpr int bwd_smem_floats(int hs) {
  using C = BwdCfg<N, HEAD>;
  return 2 * bwd_stage_floats<N, HEAD>(hs) + (HEAD ? 2 : 1) * C::kU * C::kCb +
         C::kU * C::kCT * 2 * N + 2 * C::kX * C::kU * 2 * N +
         2 * C::kU * C::kCb +
         2 * C::kCb + (HEAD ? hs : 0) + 6;
}

// n consecutive floats of shared memory (aligned to n up to 16 bytes).
template <int n>
__device__ __forceinline__ void ld_vec(const float* q, float (&v)[n]) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int j = 0; j < n; j += 4) {
      const float4 w = *reinterpret_cast<const float4*>(q + j);
      v[j] = w.x; v[j + 1] = w.y; v[j + 2] = w.z; v[j + 3] = w.w;
    }
  } else if constexpr (n == 2) {
    const float2 w = *reinterpret_cast<const float2*>(q);
    v[0] = w.x; v[1] = w.y;
  } else {
    v[0] = q[0];
  }
}
template <int n>
__device__ __forceinline__ void st_vec(float* q, const float (&v)[n]) {
  if constexpr (n == 2) {
    *reinterpret_cast<float2*>(q) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < n; ++j) q[j] = v[j];
  }
}
// Reduce-scatter of V values over the G adjacent lanes of a channel group
// (G a power of two): at the stage of offset OFF a lane keeps the half of
// its values that its bit OFF selects and adds its partner's copy of that
// half.  Lane lg ends with the totals of values lg V / G .. lg V / G + V /
// G - 1 in v[0 .. V / G), each summed in a fixed order.
template <int OFF, int G, int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lg) {
  if constexpr (OFF > 0) {
    constexpr int kHalf = V * OFF / G;
    const bool upper = lg & OFF;
#pragma unroll
    for (int q = 0; q < kHalf; ++q) {
      const float send = upper ? v[q] : v[q + kHalf];
      const float keep = upper ? v[q + kHalf] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    reduce_scatter<OFF / 2, G, V>(v, lg);
  }
}
// One float by cp.async with zero fill.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
// mbarriers and bulk (TMA) copies for the backward's staging.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// One arrival that also expects `bytes` of bulk copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16, 16-byte aligned ends) from global to shared
// memory by the bulk copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_g2s(float* dst, const float* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Orders this thread's generic accesses to shared memory before later
// bulk copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The float4 at `local`'s offset in the shared memory of cluster block
// `rank` (16-byte aligned).
__device__ __forceinline__ float4 ld_cluster4(const float* local,
                                              unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// The backward's staging: copy chunk c of the block at channel d0 of
// batch row b into `stage`, rows past L and channels past D zero-filled.
// Where the rows are 16-byte aligned (p.vec) x, dy (dt per channel) move
// by 16-byte cp.async and the bulk copy engine moves B, C and the
// checkpoint (16 of the chunk's 20 KB at N = 64) in one copy each,
// completing on `bar`; otherwise everything moves by 4-byte cp.async.
// dt per head moves by 4-byte cp.async in either case.
template <int N, bool HEAD>
__device__ __forceinline__ void bwd_issue(const BwdArgs& p, float* stage,
                                          int c, int b, int d0,
                                          uint64_t* bar) {
  using C = BwdCfg<N, HEAD>;
  constexpr int U = C::kU, Cb = C::kCb, T = C::kThreads;
  const int tid = threadIdx.x;
  const int DT = HEAD ? p.hs : Cb;
  const int nck = (p.L + U - 1) / U;
  const size_t row0 = static_cast<size_t>(b) * p.L;
  float* xs = stage;
  float* dys = xs + U * Cb;
  float* dts = dys + U * Cb;
  float* bs = dts + U * DT;
  float* cs = bs + U * N;
  float* cks = cs + U * N;
  const int t0 = c * U;
  const int rows = min(U, p.L - t0);
  if (p.vec) {
    const int live = max(0, min(Cb, p.D - d0));  // channels inside D
    // x, dy (dt per channel): 16-byte cp.async, zero-filled past L and D,
    // from the last warps (the first ones issue the bulk copies and dt)
    for (int i = (T - 1 - tid) * 4; i < U * Cb; i += T * 4) {
      const int u = i / Cb, cc = i % Cb;
      const bool ok = u < rows && cc < live;
      const size_t off = ok ? (row0 + t0 + u) * p.D + d0 + cc : 0;
      cp_async16(xs + i, p.x + off, ok);
      cp_async16(dys + i, p.dy + off, ok);
      if (!HEAD) cp_async16(dts + i, p.dt + off, ok);
    }
    // B, C and the checkpoint: one bulk copy each, completing on `bar`
    if (rows < U || live < Cb) {
      for (int i = rows * N + tid; i < U * N; i += T) bs[i] = cs[i] = 0.f;
      for (int i = live * N + tid; i < Cb * N; i += T) cks[i] = 0.f;
      fence_proxy_async();
    }
    constexpr int W = T / 32;  // the three copies on three warps
    if (tid == 0)
      mbar_expect_tx(bar, 2 * rows * N * 4 + live * N * 4);
    if (tid == 0 || tid == (W > 1 ? 32 : 1))
      bulk_g2s(tid == 0 ? bs : cs, (tid == 0 ? p.Bm : p.Cm) + (row0 + t0) * N,
               rows * N * 4, bar);
    if (tid == (W > 2 ? 64 : 2) && live > 0)
      bulk_g2s(cks, p.hc + ((static_cast<size_t>(b) * nck + c) * p.D + d0) *
                               N, live * N * 4, bar);
  } else {
#pragma unroll 1
    for (int i = tid; i < U * Cb; i += T) {
      const int u = i / Cb, cc = i % Cb;
      const bool ok = u < rows && d0 + cc < p.D;
      const size_t off = ok ? (row0 + t0 + u) * p.D + d0 + cc : 0;
      cp_async4(xs + i, p.x + off, ok);
      cp_async4(dys + i, p.dy + off, ok);
      if (!HEAD) cp_async4(dts + i, p.dt + off, ok);
    }
#pragma unroll 1
    for (int i = tid; i < U * N; i += T) {
      const bool ok = i < rows * N;
      const size_t off = ok ? (row0 + t0) * N + i : 0;
      cp_async4(bs + i, p.Bm + off, ok);
      cp_async4(cs + i, p.Cm + off, ok);
    }
#pragma unroll 1
    for (int i = tid; i < Cb * N; i += T) {
      const bool ok = d0 + i / N < p.D;
      const size_t off =
          ok ? ((static_cast<size_t>(b) * nck + c) * p.D + d0) * N + i : 0;
      cp_async4(cks + i, p.hc + off, ok);
    }
  }
  if (HEAD) {
    const int nh = p.D / p.P, h_first = d0 / p.P;
#pragma unroll 1
    for (int i = tid; i < U * DT; i += T) {
      const int u = i / DT, h = h_first + i % DT;
      const bool ok = u < rows && h < nh;
      const size_t off = ok ? (row0 + t0 + u) * nh + h : 0;
      cp_async4(dts + i, p.dt + off, ok);
    }
  }
}

// Once chunk `stage` has landed, step u of it (one warp): dt x a (t,
// channel) into dtx_s, and per head e a (t, head) into ech_s for the
// head's channels: the first lane of each head slot in the warp forms e,
// the slot's lanes take it by a shuffle; a dead channel keeps (e = 1).
template <int N, bool HEAD>
__device__ __forceinline__ void bwd_form(const BwdArgs& p, const float* stage,
                                         float* dtx_s, float* ech_s,
                                         const int* slot_s, const float* a_s,
                                         int d0, int u) {
  using C = BwdCfg<N, HEAD>;
  constexpr int U = C::kU, Cb = C::kCb;
  const int lane = threadIdx.x % 32;
  const int DT = HEAD ? p.hs : Cb;
  const int h_first = HEAD ? d0 / p.P : 0;
  const float* xs = stage;
  const float* dts = xs + 2 * U * Cb;
#pragma unroll
  for (int j = 0; j < (Cb + 31) / 32; ++j) {
    const int cc = lane + 32 * j, i = u * Cb + cc;
    const bool act = Cb >= 32 || cc < Cb;  // every lane shuffles
    float dv = 0.f;
    if constexpr (HEAD) {
      const int sl = act ? slot_s[cc] : -1;
      if (sl >= 0) dv = dts[u * DT + sl];
      const int first =
          sl >= 0 ? max((h_first + sl) * p.P - d0 - 32 * j, 0) : lane;
      float e = 1.f;
      if (sl >= 0 && lane == first) e = decay(dv, a_s[sl]);
      e = __shfl_sync(0xffffffffu, e, first);
      if (act) ech_s[i] = sl >= 0 ? e : 1.f;
    } else if (act) {
      dv = dts[i];
    }
    if (act) dtx_s[i] = __fmul_rn(dv, xs[i]);
  }
}

// grid (cluster-padded ceil(D / Cb), batch), clusters of cl blocks along
// x; block BwdCfg::kThreads; dynamic shared memory bwd_smem_floats.
template <int N, bool HEAD>
__global__ void __launch_bounds__(BwdCfg<N, HEAD>::kThreads)
    ssm_scan_bwd_kernel(const __grid_constant__ BwdArgs p) {
  using C = BwdCfg<N, HEAD>;
  constexpr int K = C::kK, G = C::kG, M = C::kM, Cb = C::kCb, CT = C::kCT,
                T = C::kThreads, U = C::kU, R = C::kR, V = C::kV,
                VL = C::kVL;
  constexpr int N2 = 2 * N;
  extern __shared__ __align__(16) float sm[];
  const int DT = HEAD ? p.hs : Cb;  // dt columns of a stage
  const int stage_f = bwd_stage_floats<N, HEAD>(p.hs);
  float* const dtx_s = sm + 2 * stage_f;       // [U][Cb]
  float* const ech_s = dtx_s + U * Cb;         // [U][Cb], per head
  float* const red = ech_s + (HEAD ? U * Cb : 0);  // [U][CT][2N]
  constexpr int XC = C::kX;
  float* const xbuf = red + U * CT * N2;       // [2][XC U][2N]
  float* const sx = xbuf + 2 * XC * U * N2;    // [U][Cb]: sum_n g B
  float* const st = sx + U * Cb;               // [U][Cb]: the other sum
  float* const dres_s = st + U * Cb;           // [Cb]: a channel's D
  int* const slot_s = reinterpret_cast<int*>(dres_s + Cb);  // [Cb]
  float* const a_s = dres_s + 2 * Cb;          // [hs]: a head slot's A
  uint64_t* const bars = reinterpret_cast<uint64_t*>(
      sm + ((a_s - sm) + (HEAD ? p.hs : 0) + 1) / 2 * 2);  // [2]

  const int tid = threadIdx.x;
  const int lg = tid % G, cg = tid / G;
  const int n0 = lg * K, c0 = cg * M;
  const int blk = blockIdx.x, b = blockIdx.y;
  const int nblk = (p.D + Cb - 1) / Cb;        // blocks past it are padding
  const int d0 = blk * Cb;
  const int nck = (p.L + U - 1) / U;
  const int nh = HEAD ? p.D / p.P : 0;
  const int h_first = HEAD ? d0 / p.P : 0;
  const size_t row0 = static_cast<size_t>(b) * p.L;
  const unsigned rank = cluster_rank();
  const int cl_id = blk / p.cl, ncl = gridDim.x / p.cl;
  const int lane = tid % 32, warp = tid / 32;
  constexpr int W = T / 32;

  auto stage_of = [&](int c) { return sm + (c & 1) * stage_f; };
  auto issue = [&](int c) {
    bwd_issue<N, HEAD>(p, stage_of(c), c, b, d0, bars + (c & 1));
  };
  auto form_step = [&](int c, int u) {
    bwd_form<N, HEAD>(p, stage_of(c), dtx_s, ech_s, slot_s, a_s, d0, u);
  };
  auto form = [&](int c) {  // a warp a step
#pragma unroll 1
    for (int u = warp; u < U; u += W) form_step(c, u);
  };
  // ---- the dB / dC of chunk group g (chunks g XC .. g XC + XC - 1): this
  // block's share (XC U x 2N / cl values) of the cluster's blocks' sums in
  // rank order, from distributed shared memory to device memory, 16
  // values a thread in flight at once ---------------------------------
  const int ngroup = (nck + XC - 1) / XC;
  auto exchange = [&](int g) {
    const int share = XC * U * N2 / p.cl;  // a multiple of 4 floats
    const float* xb = xbuf + (g & 1) * XC * U * N2 + rank * share;
#pragma unroll 1
    for (int o0 = 4 * tid; o0 < share; o0 += 16 * T) {
      // this block's values from its own shared memory, the other's
      // (cl = 2) over the cluster, 16 bytes a load; a + b = b + a, so the
      // sum is the rank-order sum
      float4 mine[4], other[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        other[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p.cl == 2 && o0 + 4 * q * T < share)
          other[q] = ld_cluster4(xb + o0 + 4 * q * T, rank ^ 1u);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (o0 + 4 * q * T < share)
          mine[q] = *reinterpret_cast<const float4*>(xb + o0 + 4 * q * T);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = o0 + 4 * q * T;
        if (o >= share) continue;
        const float v[4] = {mine[q].x + other[q].x, mine[q].y + other[q].y,
                            mine[q].z + other[q].z, mine[q].w + other[q].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = rank * share + o + k;
          const int t = g * XC * U + j / N2;
          if (t < p.L)
            p.part_bc[((static_cast<size_t>(b) * ncl + cl_id) * p.L + t) *
                          N2 + j % N2] = v[k];
        }
      }
    }
  };

  float g[M][K], a_pc[M][K], da[M][K];
  bool live[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int d = d0 + c0 + m;
    live[m] = d < p.D;
#pragma unroll
    for (int k = 0; k < K; ++k) g[m][k] = a_pc[m][k] = da[m][k] = 0.f;
    if (live[m]) {
      const size_t s = (static_cast<size_t>(b) * p.D + d) * N + n0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (p.dh_last != nullptr) g[m][k] = p.dh_last[s + k];
        if (!HEAD) a_pc[m][k] = p.A[static_cast<size_t>(d) * N + n0 + k];
      }
    }
  }
  for (int cc = tid; cc < Cb; cc += T) {
    const int d = d0 + cc;
    dres_s[cc] = d < p.D ? p.Dres[HEAD ? d / p.P : d] : 0.f;
    slot_s[cc] = d < p.D && HEAD ? d / p.P - h_first : -1;
  }
  if (HEAD)
    for (int sl = tid; sl < p.hs; sl += T)
      a_s[sl] = h_first + sl < nh ? p.A[h_first + sl] : 0.f;
  // per channel: dD of channels d0 + tid + j T
  constexpr int kDD = (Cb + T - 1) / T;
  float dd[kDD];
#pragma unroll
  for (int j = 0; j < kDD; ++j) dd[j] = 0.f;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the k-th use of a stage (chunks nck - 1, nck - 3, ... or nck - 2, ...)
  // completes phase k of its mbarrier
  auto landed = [&](int c) {
    if (p.vec) mbar_wait(bars + (c & 1), ((nck - 1 - c) / 2) & 1);
  };
  issue(nck - 1);
  cp_async_commit();
  if (nck > 1) issue(nck - 2);
  cp_async_commit();
  cp_async_wait<1>();
  landed(nck - 1);
  __syncthreads();
  form(nck - 1);

  for (int c = nck - 1; c >= 0; --c) {
    // chunk c's stage and forms are visible; chunk c + 1's stage is free
    fence_proxy_async();  // this thread's reads of it before bulk writes
    __syncthreads();
    // the next chunk's copies, in flight while this chunk is walked (the
    // walk stays one straight run of code)
    if (c > 0 && c < nck - 1) issue(c - 1);
    const float* __restrict__ xs = stage_of(c);
    const float* __restrict__ dys = xs + U * Cb;
    const float* __restrict__ dts = dys + U * Cb;
    const float* __restrict__ bs = dts + U * DT;
    const float* __restrict__ cs = bs + U * N;
    const float* __restrict__ cks = cs + U * N;
    const float* __restrict__ dtx_r = dtx_s;
    const float* __restrict__ ech_r = ech_s;
    float* __restrict__ red_r = red;
    const int t0 = c * U;

    // the chunk's states, recomputed with the forward's step
    float hck[M][K];
    float hist[U][M][K];
    float dec[HEAD ? 1 : U][M][K];  // per channel: the decays, formed once
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int k = 0; k < K; ++k) hck[m][k] = cks[(c0 + m) * N + n0 + k];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int o = u * Cb + c0;
      float bv[K], dxm[M], em[M];
      ld_vec<K>(bs + u * N + n0, bv);
      ld_vec<M>(dtx_r + o, dxm);
      ld_vec<M>(HEAD ? ech_r + o : dts + o, em);  // per channel: dt
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float e = em[m];
          if constexpr (!HEAD) {
            e = decay(em[m], a_pc[m][k]);
            dec[u][m][k] = e;
          }
          hist[u][m][k] = __fmaf_rn(e, u == 0 ? hck[m][k] : hist[u - 1][m][k],
                                    __fmul_rn(dxm[m], bv[k]));
        }
    }

    // walk the chunk back
    float batch[V];
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int u = U - 1 - s;
      const int r = s % R;
      const int o = u * Cb + c0;
      float bv[K], cv[K], pb[K], pc[K], dym[M], dxm[M], em[M];
      ld_vec<K>(bs + u * N + n0, bv);
      ld_vec<K>(cs + u * N + n0, cv);
      ld_vec<M>(dys + o, dym);
      ld_vec<M>(dtx_r + o, dxm);
      ld_vec<M>(HEAD ? ech_r + o : dts + o, em);  // per channel: dt
#pragma unroll
      for (int k = 0; k < K; ++k) pb[k] = pc[k] = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float gg = __fmaf_rn(cv[k], dym[m], g[m][k]);  // dL/dh_t
          pb[k] = __fmaf_rn(gg, dxm[m], pb[k]);
          pc[k] = __fmaf_rn(hist[u][m][k], dym[m], pc[k]);
          s1 = __fmaf_rn(gg, bv[k], s1);
          const float hp = u == 0 ? hck[m][k] : hist[u - 1][m][k];
          if constexpr (HEAD) {
            s2 = __fmaf_rn(gg, hp, s2);
            g[m][k] = __fmul_rn(gg, em[m]);
          } else {
            const float e = dec[u][m][k];
            const float w = __fmul_rn(__fmul_rn(gg, hp), e);
            s2 = __fmaf_rn(w, a_pc[m][k], s2);
            da[m][k] = __fmaf_rn(w, em[m], da[m][k]);
            g[m][k] = __fmul_rn(gg, e);
          }
        }
        batch[(r * M + m) * 2] = s1;
        batch[(r * M + m) * 2 + 1] = s2;
      }
      float* rd = red_r + (u * CT + cg) * N2 + n0;
      st_vec<K>(rd, pb);
      st_vec<K>(rd + N, pc);
      if (r == R - 1) {
        // the batch's lane sums over the channel group's G threads
        reduce_scatter<G / 2, G, V>(batch, lg);
#pragma unroll
        for (int q = 0; q < VL; ++q) {
          const int i = lg * VL + q;
          const int m = (i >> 1) % M, rr = i / (2 * M);
          const int uu = U - 1 - (s - (R - 1) + rr);
          ((i & 1) ? st : sx)[uu * Cb + c0 + m] = batch[q];
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();  // chunk c - 1 has landed (this thread's copies)
    if (c > 0) landed(c - 1);  // ... and the bulk copies
    __syncthreads();     // ... everyone's; the chunk's partials are whole
    const int grp = c / XC;
    if (c == min(grp * XC + XC - 1, nck - 1) && grp + 1 < ngroup) {
      // the group after this one is complete in every block of the
      // cluster: carry it out before this group reuses its buffer
      cluster_wait();
      exchange(grp + 1);
    }

    // the block's dB / dC of the chunk: channel groups in order
    {
      constexpr int VW = N2 < 4 ? N2 : 4;
      float* xb = xbuf + (grp & 1) * XC * U * N2 + (c % XC) * U * N2;
#pragma unroll 1
      for (int o = tid * VW; o < U * N2; o += T * VW) {
        const float* src = red + (o / N2) * CT * N2 + o % N2;
        float acc[VW], v[VW];
        ld_vec<VW>(src, acc);
#pragma unroll
        for (int q = 1; q < CT; ++q) {
          ld_vec<VW>(src + q * N2, v);
#pragma unroll
          for (int k = 0; k < VW; ++k) acc[k] += v[k];
        }
        if constexpr (VW == 4)
          *reinterpret_cast<float4*>(xb + o) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        else
          st_vec<VW>(xb + o, acc);
      }
    }
    if (c % XC == 0) cluster_arrive();  // the group's partials are out
    if constexpr (HEAD) {
      // a warp a step, a lane a channel (and every 32nd after it): dx,
      // then each head's share in this block of sum_d x (g B), S and
      // sum_d dy x, a lane's channels in order, then the lanes' tree
      // two of the warp's steps at a time, their lane trees interleaved
      constexpr int US = U / W < 2 ? U / W : 2;
      constexpr int JC = (Cb + 31) / 32;  // channels a lane
      for (int u0 = warp; u0 < U; u0 += US * W) {
        int sl[US][JC];
        float X[US][JC], S[US][JC], Q[US][JC];
#pragma unroll
        for (int k = 0; k < US; ++k) {
          const int u = u0 + k * W, t = t0 + u;
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            const int cc = lane + 32 * j, d = d0 + cc, o = u * Cb + cc;
            const bool ok = t < p.L && d < p.D && (Cb >= 32 || cc < Cb);
            sl[k][j] = ok ? slot_s[cc] : -1;
            X[k][j] = ok ? __fmul_rn(xs[o], sx[o]) : 0.f;
            S[k][j] = ok ? st[o] : 0.f;
            Q[k][j] = ok ? __fmul_rn(dys[o], xs[o]) : 0.f;
            if (ok)
              p.dx[(row0 + t) * p.D + d] = __fmaf_rn(
                  sx[o], dts[u * DT + sl[k][j]],
                  __fmul_rn(dres_s[cc], dys[o]));
          }
        }
        // the next chunk's forms for the same steps, beside this chunk's
        // sums (independent work while the shuffles wait)
        if (c > 0) {
#pragma unroll
          for (int k = 0; k < US; ++k) form_step(c - 1, u0 + k * W);
        }
        for (int h = 0; h < p.hs; ++h) {
          float x3[US][3];
#pragma unroll
          for (int k = 0; k < US; ++k) {
            x3[k][0] = x3[k][1] = x3[k][2] = 0.f;
#pragma unroll
            for (int j = 0; j < JC; ++j)
              if (sl[k][j] == h) {
                x3[k][0] += X[k][j];
                x3[k][1] += S[k][j];
                x3[k][2] += Q[k][j];
              }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int k = 0; k < US; ++k)
#pragma unroll
              for (int q = 0; q < 3; ++q)
                x3[k][q] += __shfl_xor_sync(0xffffffffu, x3[k][q], off);
          const int hh = h_first + h;
#pragma unroll
          for (int k = 0; k < US; ++k) {
            const int t = t0 + u0 + k * W;
            if (lane == 0 && t < p.L && hh < nh && hh * p.P < d0 + Cb) {
              float* dst =
                  p.part_h + (((row0 + t) * nblk + blk) * p.hs + h) * 3;
              dst[0] = x3[k][0];
              dst[1] = x3[k][1];
              dst[2] = x3[k][2];
            }
          }
        }
      }
    } else {
      for (int o = tid; o < U * Cb; o += T) {
        const int t = t0 + o / Cb, d = d0 + o % Cb;
        if (t >= p.L || d >= p.D) continue;
        const size_t off = (row0 + t) * p.D + d;
        p.dx[off] = __fmaf_rn(sx[o], dts[o], __fmul_rn(dres_s[o % Cb], dys[o]));
        p.ddt[off] = __fmaf_rn(sx[o], xs[o], st[o]);
      }
#pragma unroll
      for (int j = 0; j < kDD; ++j) {
        const int cc = tid + j * T;
        if (cc >= Cb) continue;
#pragma unroll
        for (int u = U - 1; u >= 0; --u)
          dd[j] = __fmaf_rn(dys[u * Cb + cc], xs[u * Cb + cc], dd[j]);
      }
    }
    if (!HEAD && c > 0) form(c - 1);
  }
  cluster_wait();
  exchange(0);
  cluster_arrive();  // no block leaves while another reads its partials
  cluster_wait();

#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (!live[m]) continue;
    const int d = d0 + c0 + m;
    const size_t s = (static_cast<size_t>(b) * p.D + d) * N + n0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (p.dh0 != nullptr) p.dh0[s + k] = g[m][k];
      if (!HEAD)
        p.part_ad[static_cast<size_t>(b) * (p.D * N + p.D) +
                  static_cast<size_t>(d) * N + n0 + k] = da[m][k];
    }
  }
#pragma unroll
  for (int j = 0; j < kDD; ++j) {
    const int cc = tid + j * T;
    if (!HEAD && cc < Cb && d0 + cc < p.D)
      p.part_ad[static_cast<size_t>(b) * (p.D * N + p.D) +
                static_cast<size_t>(p.D) * N + d0 + cc] = dd[j];
  }
}

// Per head, one block a row (b, t): dB / dC summed over the clusters, and
// each head's ddt from its blocks' shares in block order, with the row's
// dA and dD terms (dt e S, sum_d dy x) for the column sums.
__global__ void bwd_rows_kernel(const float* part_bc, const float* part_h,
                                const float* dt, const float* A, float* dbc,
                                float* ddt, float* terms, int L, int n2,
                                int ncl, int nh, int P, int cb, int nblk,
                                int hs) {
  const int t = blockIdx.x, b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * L + t;
  for (int j = threadIdx.x; j < n2; j += blockDim.x) {
    const float* src = part_bc + (static_cast<size_t>(b) * ncl * L + t) * n2 + j;
    float acc = src[0];
    for (int q = 1; q < ncl; ++q) acc += src[static_cast<size_t>(q) * L * n2];
    dbc[row * n2 + j] = acc;
  }
  for (int h = threadIdx.x; h < nh; h += blockDim.x) {
    float X = 0.f, S = 0.f, Q = 0.f;
    for (int k = h * P / cb; k <= ((h + 1) * P - 1) / cb; ++k) {
      const float* src = part_h + ((row * nblk + k) * hs + h - k * cb / P) * 3;
      X += src[0];
      S += src[1];
      Q += src[2];
    }
    const float dv = dt[row * nh + h], a = A[h];
    const float e = decay(dv, a);
    ddt[row * nh + h] = __fmaf_rn(__fmul_rn(a, e), S, X);
    terms[row * 2 * nh + h] = __fmul_rn(__fmul_rn(dv, e), S);
    terms[row * 2 * nh + nh + h] = Q;
  }
}

// out[col] = sum over rows of in[row][col]: a block a column, strided
// partials, then a fixed tree.
__global__ void col_sum_kernel(const float* in, float* out, int rows,
                               int cols) {
  constexpr int kT = 256;
  __shared__ float part[kT];
  const int col = blockIdx.x, tid = threadIdx.x;
  float acc = 0.f;
  for (int r = tid; r < rows; r += kT)
    acc += in[static_cast<size_t>(r) * cols + col];
  part[tid] = acc;
  __syncthreads();
  for (int s = kT / 2; s > 0; s >>= 1) {
    if (tid < s) part[tid] += part[tid + s];
    __syncthreads();
  }
  if (tid == 0) out[col] = part[0];
}

// out[o][i] = sum over q < P of in[o][q][i], q in order.
__global__ void sum_partials_kernel(const float* in, float* out, int P,
                                    long long inner) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= inner) return;
  const float* src = in + static_cast<size_t>(blockIdx.y) * P * inner + i;
  float acc = 0.f;
  for (int q = 0; q < P; ++q) acc += src[static_cast<size_t>(q) * inner];
  out[static_cast<size_t>(blockIdx.y) * inner + i] = acc;
}

cudaError_t sum_partials(const float* in, float* out, int outer, int P,
                         long long inner, cudaStream_t st) {
  if (outer <= 0 || inner <= 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (inner + threads - 1) / threads;
  sum_partials_kernel<<<dim3(static_cast<unsigned>(blocks), outer), threads,
                        0, st>>>(in, out, P, inner);
  return cudaGetLastError();
}

template <int N, bool HEAD>
cudaError_t launch_bwd(const BwdArgs& a, int batch, int cb,
                       cudaStream_t st) {
  using C = BwdCfg<N, HEAD>;
  if (cb != C::kCb) return cudaErrorInvalidValue;
  const int nblk = (a.D + C::kCb - 1) / C::kCb;
  const int grid = (nblk + a.cl - 1) / a.cl * a.cl;
  const size_t smem = static_cast<size_t>(bwd_smem_floats<N, HEAD>(a.hs)) *
                      sizeof(float);
  // above 48 KiB only with the attribute, set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N, HEAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, batch);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssm_scan_bwd_kernel<N, HEAD>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool HEAD>
cudaError_t dispatch_bwd(const BwdArgs& a, int batch, int N, int cb,
                         cudaStream_t st) {
#define REPRO_SSM(NN) \
  if (N == NN) return launch_bwd<NN, HEAD>(a, batch, cb, st)
  REPRO_SSM(1);
  REPRO_SSM(2);
  REPRO_SSM(4);
  REPRO_SSM(8);
  REPRO_SSM(16);
  REPRO_SSM(32);
  REPRO_SSM(64);
#undef REPRO_SSM
  return cudaErrorInvalidValue;
}

template <int N, bool HEAD>
cudaError_t bwd_clusters(int cl, int hs, int* out) {
  using C = BwdCfg<N, HEAD>;
  const size_t smem = static_cast<size_t>(bwd_smem_floats<N, HEAD>(hs)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N, HEAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * 64, 1);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, ssm_scan_bwd_kernel<N, HEAD>,
                                        &cfg);
}

}  // namespace

extern "C" {

// x, dt (batch, L, D) and B, C (batch, L, N) in `dtype` (0 = float32,
// 1 = bfloat16), A (D, N), Dres (D,) float32; h0 and h_last (batch, D, N)
// float32 or null; y (batch, L, D) in `dtype`; hc (batch, ceil(L / 16), D,
// N) float32 or null: the state before every 16th step, for the backward.
// N is a power of two <= 64.
// k (the wrapper's ssm_geometry): lanes a thread, N for N < 4, else 4.
// vec: 1 for 16-byte copies, which need D and L * N whole 16-byte rows
// and 16-byte aligned x, dt, B and C; 0 for plain loads (any shape).
int ssm_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* Dres,
                    const void* h0, void* y, void* h_last, void* hc,
                    int batch, int L,
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
                     reinterpret_cast<uintptr_t>(h_last) % 16 ||
                     reinterpret_cast<uintptr_t>(hc) % 16))
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
                           static_cast<float*>(y), s1,
                           static_cast<float*>(hc), L, D, vec};
    return dispatch<float>(args, batch, N, k, st);
  }
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    const Args<B16> args{static_cast<const B16*>(x),
                         static_cast<const B16*>(dt), a,
                         static_cast<const B16*>(Bm),
                         static_cast<const B16*>(Cm), dr, s0,
                         static_cast<B16*>(y), s1, static_cast<float*>(hc),
                         L, D, vec};
    return dispatch<B16>(args, batch, N, k, st);
  }
  return cudaErrorInvalidValue;
}

// The backward, float32 throughout: x, dy, dx (batch, L, D); B, C (batch,
// L, N); hc the forward's checkpoints; dh_last and dh0 (batch, D, N) or
// null; dB, dC (batch, L, N) as one (batch, L, 2N) buffer dbc.  Per
// channel (P = 0): dt, ddt (batch, L, D), A (D, N), Dres (D,), dad (D N +
// D) = dA then dD.  Per head (P channels a head, D = nh P): dt, ddt
// (batch, L, nh), A and Dres (nh,), dad (2 nh) = dA then dD.  cb: the
// channels a block (the wrapper's ssm_bwd_geometry, checked here); cl: the
// blocks a cluster (1 or 2); hs: the head slots a block (per head).
// Scratch: part_bc (batch, ceil(ceil(D / cb) / cl), L, 2N); per channel
// part_ad (batch, D N + D); per head part_h (batch, L, ceil(D / cb), hs,
// 3) and terms (batch L, 2 nh).  The scan kernel, then two fixed-order
// sums: per channel dbc over the clusters and dad over the batch; per head
// dbc and ddt a row, then dad over the rows.
int ssm_scan_backward_launch(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm,
                             const void* Dres, const void* hc,
                             const void* dy, const void* dh_last, void* dx,
                             void* ddt, void* part_bc, void* part_h,
                             void* part_ad, void* terms, void* dh0,
                             void* dbc, void* dad, int batch, int L, int D,
                             int N, int P, int cb, int cl, int hs,
                             void* stream) {
  if (batch <= 0 || L <= 0 || D <= 0) return cudaSuccess;
  if ((cl != 1 && cl != 2) || P < 0 ||
      (P > 0 && (D % P != 0 || hs < 1)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool head = P > 0;
  int vec = N % 4 == 0 && D % 4 == 0;
  for (const void* q : {x, dy, Bm, Cm, hc, dt})
    if (reinterpret_cast<uintptr_t>(q) % 16) vec = 0;
  const BwdArgs args{
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(Dres),
      static_cast<const float*>(hc), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(part_bc),
      static_cast<float*>(part_h), static_cast<float*>(part_ad),
      static_cast<float*>(dh0), L, D, head ? P : 1, head ? hs : 1, cl, vec};
  cudaError_t err = head ? dispatch_bwd<true>(args, batch, N, cb, st)
                         : dispatch_bwd<false>(args, batch, N, cb, st);
  if (err != cudaSuccess) return err;
  const int nblk = (D + cb - 1) / cb;
  const int ncl = (nblk + cl - 1) / cl;
  if (!head) {
    err = sum_partials(static_cast<const float*>(part_bc),
                       static_cast<float*>(dbc), batch, ncl,
                       static_cast<long long>(L) * 2 * N, st);
    if (err != cudaSuccess) return err;
    return sum_partials(static_cast<const float*>(part_ad),
                        static_cast<float*>(dad), 1, batch,
                        static_cast<long long>(D) * N + D, st);
  }
  const int nh = D / P;
  bwd_rows_kernel<<<dim3(L, batch), 128, 0, st>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_h),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<float*>(dbc), static_cast<float*>(ddt),
      static_cast<float*>(terms), L, 2 * N, ncl, nh, P, cb, nblk, hs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  col_sum_kernel<<<2 * nh, 256, 0, st>>>(static_cast<const float*>(terms),
                                         static_cast<float*>(dad),
                                         batch * L, 2 * nh);
  return cudaGetLastError();
}

// How many clusters of cl blocks of the backward (state size N, per head
// if head != 0, hs head slots) the card holds at once, into *out.
int ssm_scan_backward_clusters(int N, int head, int cl, int hs, int* out) {
#define REPRO_SSM(NN)                                                   \
  if (N == NN)                                                          \
    return head ? bwd_clusters<NN, true>(cl, hs, out)                   \
                : bwd_clusters<NN, false>(cl, hs, out)
  REPRO_SSM(1);
  REPRO_SSM(2);
  REPRO_SSM(4);
  REPRO_SSM(8);
  REPRO_SSM(16);
  REPRO_SSM(32);
  REPRO_SSM(64);
#undef REPRO_SSM
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
