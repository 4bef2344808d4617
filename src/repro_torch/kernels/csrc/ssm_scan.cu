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
// The backward at (1, 1024, 4096, 64) moves 154.2 MB (x, dt, dy, dx,
// ddt, B, C, dB, dC, A, D, dA, dD and the checkpoints), 0.046 ms, and
// needs one exp an element, 0.0642 ms; the kernel forms two (the
// recompute and the cotangent's step), 0.128 ms of exps.
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
// L backwards with g = dL/dh_t (the state cotangent):
//
//   g        += C_t dy_t                     (then g = dL/dh_t)
//   dB_t[n]   = sum_d g[d, n] dt x           dC_t[n] = sum_d dy_t[d] h_t[d, n]
//   dx        = dt sum_n g B + D dy          ddt = x sum_n g B + sum_n g h_{t-1} e A
//   dA[d, n] += g h_{t-1} e dt               dD[d] += dy x
//   g        *= e = exp(dt A)                (then g = dL/dh_{t-1} but C dy)
//
// ending with dh0 = g.  A block owns 32 channels and a thread the K lanes
// of one, as in the forward.  The forward wrote the state before every
// kCkpt-th step (hc); the backward takes the chunks in reverse, stages a
// chunk's x, dt, dy, B and C in shared memory, recomputes its kCkpt
// states from the checkpoint with the forward's own step (step_h: the
// states equal the forward's bitwise) into registers, and walks them
// back.  The sums over channels (dB, dC: over the block's 32 here, over
// the blocks in a second launch) and over a channel's lanes (dx, ddt) go
// through shared memory, R steps to a barrier, in a fixed order; dA and
// dD are summed over the batch in a last pass.  No atomics: a repeat is
// bitwise equal.
struct BwdArgs {
  const float* x; const float* dt; const float* A; const float* Bm;
  const float* Cm; const float* Dres; const float* hc; const float* dy;
  const float* dh_last;  // or null
  float* dx; float* ddt;
  float* part_bc;  // (batch, D blocks, L, 2N): the block's dB_t, dC_t
  float* part_a;   // (batch, D, N): dA of one batch row
  float* part_d;   // (batch, D): dD of one batch row
  float* dh0;      // or null
  int L, D;
};

template <int N, int K>
struct BwdCfg {
  static constexpr int kGroup = N / K;
  static constexpr int kThreads = kChannels * kGroup;
  static constexpr int kU = kCkpt;  // states recomputed into registers
  // steps whose channel sums share a barrier: R x 2 x 32 x N f32 = 32 KiB
  static constexpr int kR = 128 / N < kU ? 128 / N : kU;
  static constexpr int kGP = kGroup + 1;  // a channel's lane sums, padded
  // shared floats: x, dt, dy (kU x 32 each), B and C (kU x N each), then
  // two buffers of [kR][2][32][N] and two of [kR][2][32][kGP]
  static constexpr int kStage = 3 * kU * kChannels + 2 * kU * N;
  static constexpr int kRedBC = kR * 2 * kChannels * N;
  static constexpr int kRedCh = kR * 2 * kChannels * kGP;
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kStage + 2 * kRedBC + 2 * kRedCh) * sizeof(float);
  static_assert(kU % kR == 0, "a chunk holds whole barrier groups");
};

// grid (ceil(D / 32), batch); block BwdCfg::kThreads; dynamic shared
// memory BwdCfg::kSmemBytes.
template <int N, int K>
__global__ void __launch_bounds__(BwdCfg<N, K>::kThreads)
    ssm_scan_bwd_kernel(const BwdArgs p) {
  using C = BwdCfg<N, K>;
  constexpr int G = C::kGroup, U = C::kU, R = C::kR, GP = C::kGP;
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;  // [U][32]
  float* dts = xs + U * kChannels;
  float* dys = dts + U * kChannels;
  float* bs = dys + U * kChannels;  // [U][N]
  float* cs = bs + U * N;
  float* red_bc = cs + U * N;                // [2][R][2][32][N]
  float* red_ch = red_bc + 2 * C::kRedBC;    // [2][R][2][32][GP]

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int dl = tid / G;
  const int n0 = g * K;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + dl;
  const bool live = d < p.D;
  const int b = blockIdx.y;
  const int nck = (p.L + U - 1) / U;
  const size_t row0 = static_cast<size_t>(b) * p.L;
  const size_t state = (static_cast<size_t>(b) * p.D + d) * N + n0;

  float a[K], gr[K], da[K];
  float dd = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) a[j] = gr[j] = da[j] = 0.f;
  if (live) {
    ld_state<K>(p.A + static_cast<size_t>(d) * N + n0, a);
    if (p.dh_last != nullptr) ld_state<K>(p.dh_last + state, gr);
  }

  int buf = 0;
  for (int c = nck - 1; c >= 0; --c) {
    const int t0 = c * U;
    const int rows = min(U, p.L - t0);
    __syncthreads();  // the last chunk's readers of the staging are done
    // rows past L are zeros: dt = x = 0 keeps the state (exp(0) = 1) and
    // dy = C = 0 adds no cotangent
    for (int i = tid; i < U * kChannels; i += C::kThreads) {
      const int tt = i / kChannels, cl = i % kChannels;
      const bool ok = tt < rows && d0 + cl < p.D;
      const size_t off = ok ? (row0 + t0 + tt) * p.D + d0 + cl : 0;
      xs[i] = ok ? p.x[off] : 0.f;
      dts[i] = ok ? p.dt[off] : 0.f;
      dys[i] = ok ? p.dy[off] : 0.f;
    }
    for (int i = tid; i < U * N; i += C::kThreads) {
      const bool ok = i < rows * N;
      const size_t off = ok ? (row0 + t0) * N + i : 0;
      bs[i] = ok ? p.Bm[off] : 0.f;
      cs[i] = ok ? p.Cm[off] : 0.f;
    }
    float hs[K];  // the state before step t0, as the forward wrote it
#pragma unroll
    for (int j = 0; j < K; ++j) hs[j] = 0.f;
    if (live)
      ld_state<K>(p.hc + ((static_cast<size_t>(b) * nck + c) * p.D + d) * N +
                      n0,
                  hs);
    __syncthreads();

    // the chunk's states, recomputed with the forward's step
    float hist[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float dv = dts[u * kChannels + dl];
      const float dxv = __fmul_rn(dv, xs[u * kChannels + dl]);
      float bv[K];
      load_k<K>(bs + u * N + n0, bv);
#pragma unroll
      for (int j = 0; j < K; ++j)
        hist[u][j] = step_h(u == 0 ? hs[j] : hist[u - 1][j], dv, a[j], dxv,
                            bv[j]);
    }

    // walk the chunk back
#pragma unroll
    for (int s = 0; s < U; ++s) {
      const int u = U - 1 - s;
      const int r = s % R;
      const float dv = dts[u * kChannels + dl];
      const float xv = xs[u * kChannels + dl];
      const float dyv = dys[u * kChannels + dl];
      const float dxv = __fmul_rn(dv, xv);
      float bv[K], cv[K], pb[K], pc[K];
      load_k<K>(bs + u * N + n0, bv);
      load_k<K>(cs + u * N + n0, cv);
      float sdx = 0.f, sdt = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float hprev = u == 0 ? hs[j] : hist[u - 1][j];
        gr[j] = __fmaf_rn(cv[j], dyv, gr[j]);  // dL/dh_t
        pb[j] = __fmul_rn(gr[j], dxv);
        pc[j] = __fmul_rn(hist[u][j], dyv);
        sdx = __fmaf_rn(gr[j], bv[j], sdx);
        const float e = decay(dv, a[j]);
        const float w = __fmul_rn(__fmul_rn(gr[j], hprev), e);
        sdt = __fmaf_rn(w, a[j], sdt);
        da[j] = __fmaf_rn(w, dv, da[j]);
        gr[j] = __fmul_rn(gr[j], e);
      }
      dd = __fmaf_rn(dyv, xv, dd);
      float* rb = red_bc + (buf * R + r) * 2 * kChannels * N;
      st_state<K>(rb + dl * N + n0, pb);                    // dB
      st_state<K>(rb + (kChannels + dl) * N + n0, pc);      // dC
      float* rc = red_ch + (buf * R + r) * 2 * kChannels * GP;
      rc[dl * GP + g] = sdx;
      rc[(kChannels + dl) * GP + g] = sdt;
      if (r == R - 1) {
        __syncthreads();
        // the group's steps: rr = 0 .. R - 1 is u = U - 1 - (s - R + 1 + rr)
        const float* rbb = red_bc + buf * R * 2 * kChannels * N;
        for (int o = tid; o < R * 2 * N; o += C::kThreads) {
          const int rr = o / (2 * N), qn = o % (2 * N);
          const int q = qn / N, n = qn % N;
          const int t = t0 + U - 1 - (s - R + 1 + rr);
          const float* src = rbb + (rr * 2 + q) * kChannels * N + n;
          float acc = 0.f;
#pragma unroll 8
          for (int k = 0; k < kChannels; ++k) acc += src[k * N];
          if (t < p.L)
            p.part_bc[((static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                           p.L + t) * 2 * N + qn] = acc;
        }
        const float* rcc = red_ch + buf * R * 2 * kChannels * GP;
        for (int o = tid; o < R * kChannels; o += C::kThreads) {
          const int rr = o / kChannels, cl = o % kChannels;
          const int uu = U - 1 - (s - R + 1 + rr);
          const int t = t0 + uu;
          const float* s0 = rcc + (rr * 2 * kChannels + cl) * GP;
          const float* s1 = s0 + kChannels * GP;
          float gx = 0.f, gt = 0.f;
#pragma unroll
          for (int k = 0; k < G; ++k) {
            gx += s0[k];
            gt += s1[k];
          }
          if (t < p.L && d0 + cl < p.D) {
            const size_t off = (row0 + t) * p.D + d0 + cl;
            p.dx[off] = __fmaf_rn(gx, dts[uu * kChannels + cl],
                                  __fmul_rn(p.Dres[d0 + cl],
                                            dys[uu * kChannels + cl]));
            p.ddt[off] = __fmaf_rn(gx, xs[uu * kChannels + cl], gt);
          }
        }
        buf ^= 1;
      }
    }
  }
  if (live) {
    st_state<K>(p.part_a + state, da);
    if (g == 0) p.part_d[static_cast<size_t>(b) * p.D + d] = dd;
    if (p.dh0 != nullptr) st_state<K>(p.dh0 + state, gr);
  }
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

template <int N, int K>
cudaError_t launch_bwd(const BwdArgs& a, int batch, cudaStream_t st) {
  using C = BwdCfg<N, K>;
  const int dblocks = (a.D + kChannels - 1) / kChannels;
  // above 48 KiB only with the attribute, set on every launch
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmemBytes));
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<N, K>
      <<<dim3(dblocks, batch), C::kThreads, C::kSmemBytes, st>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_bwd(const BwdArgs& a, int batch, int N, int k,
                         cudaStream_t st) {
#define REPRO_SSM(NN, KK) \
  if (N == NN && k == KK) return launch_bwd<NN, KK>(a, batch, st)
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

// The backward, float32 throughout: x, dt, dy, dx, ddt (batch, L, D); B, C
// (batch, L, N); A (D, N); Dres (D,); hc the forward's checkpoints;
// dh_last and dh0 (batch, D, N) or null; dB, dC (batch, L, N) as one
// (batch, L, 2N) buffer dbc; dA (D, N); dD (D,).  Scratch: part_bc
// (batch, ceil(D / 32), L, 2N), part_a (batch, D, N), part_d (batch, D).
// One scan launch, then three fixed-order sums (dbc over the blocks, dA
// and dD over the batch).
int ssm_scan_backward_launch(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm,
                             const void* Dres, const void* hc,
                             const void* dy, const void* dh_last, void* dx,
                             void* ddt, void* part_bc, void* part_a,
                             void* part_d, void* dh0, void* dbc, void* dA,
                             void* dD, int batch, int L, int D, int N, int k,
                             void* stream) {
  if (batch <= 0 || L <= 0 || D <= 0) return cudaSuccess;
  if (k % 4 == 0)
    for (const void* q : {A, hc, dh_last, static_cast<const void*>(dh0),
                          static_cast<const void*>(part_a)})
      if (reinterpret_cast<uintptr_t>(q) % 16) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdArgs args{
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(Dres),
      static_cast<const float*>(hc), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<float*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(part_bc),
      static_cast<float*>(part_a), static_cast<float*>(part_d),
      static_cast<float*>(dh0), L, D};
  cudaError_t err = dispatch_bwd(args, batch, N, k, st);
  if (err != cudaSuccess) return err;
  const int dblocks = (D + kChannels - 1) / kChannels;
  err = sum_partials(static_cast<const float*>(part_bc),
                     static_cast<float*>(dbc), batch, dblocks,
                     static_cast<long long>(L) * 2 * N, st);
  if (err != cudaSuccess) return err;
  err = sum_partials(static_cast<const float*>(part_a),
                     static_cast<float*>(dA), 1, batch,
                     static_cast<long long>(D) * N, st);
  if (err != cudaSuccess) return err;
  return sum_partials(static_cast<const float*>(part_d),
                      static_cast<float*>(dD), 1, batch, D, st);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
