// FlashAttention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// repro/kernels/flash_attention.py (kernel body `_kernel`, pl.pallas_call
// at flash_attention.py:91).  The JAX model reaches the same function
// through its jnp twin repro/models/flash.py, whose interface this kernel
// takes: the model's layout q (B, Lq, H, D) and k/v (B, Lk, H, D), already
// GQA-expanded, with `causal`, a sliding `window`, `q_offset` (absolute
// position of query row 0) and a ragged kv length.  No padding pass: the
// kernel masks the ragged q and kv edges itself.
//
// Semantics follow models/flash.py exactly: scores are (q . k) * 1/sqrt(D)
// in f32, masked scores are NEG_INF = -1e30 (not -inf), the running max,
// normaliser and accumulator are f32 and rescaled per kv tile, and the
// output is acc / max(l, 1e-20).  For the training path's recompute
// backward the kernel can also write each row's running max m and
// normaliser l (f32, (B, Lq, H)); the serving call passes null pointers and
// skips that write.
//
// What bounds it on the H100: operations.  It does 4*D flops per unmasked
// (query, key) pair, about 2*B*H*Lq*Lk*D for a causal mask, against reading
// q, k, v and writing o once.  This first version runs on the CUDA cores
// in f32 FMA (67 TFLOP/s peak), not on the tensor cores; wgmma and TMA
// staging are later work.
//
// What the design does about it: one block of 256 threads per
// (64-row q tile, head, batch); the q tile stays in shared memory while the
// block walks 64-row kv tiles staged through shared memory, so k and v are
// read from device memory once per q tile and the (L, L) score matrix is
// never materialised.  Each thread owns a 4 x 4 patch of the 64 x 64 score
// tile and 4 rows x D/16 columns of the output accumulator in registers;
// row max and row sum reduce across the 16 threads of a row by warp
// shuffles.  Kv tiles wholly above the causal diagonal or wholly below the
// window are skipped.  Row strides of the padded q/k tiles (D + 1 floats)
// keep the 16 key rows a warp reads in one step on distinct banks.
// Launches run on the caller's stream, allocate nothing and return
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 scores each
constexpr int PP = BK + 1;    // row stride of the probability tile
constexpr float NEG_INF = -1e30f;

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
  return __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(BQ) * (D + 1)   // q tile
         + static_cast<size_t>(BK) * (D + 1) // k tile
         + static_cast<size_t>(BK) * D       // v tile
         + static_cast<size_t>(BQ) * PP;     // probabilities
}

// Stage rows [row0, row0 + 64) of one head into shared memory as f32,
// `stride` floats per staged row; rows at or past `nrows` are zero.
// 16-byte loads: the wrapper guarantees the base is 16-byte aligned, and
// D * sizeof(T) is a multiple of 16, so every row start is too.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base,
                                           int row0, int nrows,
                                           size_t row_stride,
                                           float* __restrict__ dst,
                                           int stride) {
  constexpr int N = 16 / sizeof(T);
  constexpr int kChunks = 64 * D / N;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (D / N);
    const int col = (c % (D / N)) * N;
    float* out = dst + r * stride + col;
    if (row0 + r < nrows) {
      uint4 raw = *reinterpret_cast<const uint4*>(
          base + static_cast<size_t>(row0 + r) * row_stride + col);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = 0.f;
    }
  }
}

// Reduce across the 16 lanes that share a query row (lanes differ in the
// low four bits of the lane id).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Lq, int Lk, int H, int causal, int window,
                     int q_offset, int kv_len, float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;           // [BQ][DP]
  float* Ks = Qs + BQ * DP;   // [BK][DP]
  float* Vs = Ks + BK * DP;   // [BK][D]
  float* Ps = Vs + BK * D;    // [BQ][PP]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int ty = threadIdx.x >> 4;  // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x & 15;  // columns tx + 16*j
  const size_t row_stride = static_cast<size_t>(H) * D;
  const T* qb = q + (b * Lq * H + h) * D;
  const T* kb = k + (b * Lk * H + h) * D;
  const T* vb = v + (b * Lk * H + h) * D;
  T* ob = o + (b * Lq * H + h) * D;

  stage_tile<T, D>(qb, q0, Lq, row_stride, Qs, DP);

  // Kv tiles that hold at least one key some row of this q tile may see.
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Lq) - 1;
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_hi + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_lo - window + 1);
  const int t_begin = kv_begin / BK;
  const int t_end = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;

  float m_run[4], l_run[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K/V/P reads are done
    stage_tile<T, D>(kb, k0, Lk, row_stride, Ks, DP);
    stage_tile<T, D>(vb, k0, Lk, row_stride, Vs, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < kv_len;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float corr = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * corr + row_sum(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Lq) continue;
    const float l = fmaxf(l_run[i], 1e-20f);
    T* orow = ob + static_cast<size_t>(qi) * row_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
    if (m_out != nullptr && tx == 0) {  // the 16 lanes of a row agree
      const size_t row = (b * Lq + qi) * H + h;
      m_out[row] = m_run[i];
      l_out[row] = l_run[i];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* m_out, float* l_out, int B, int Lq, int Lk, int H,
                   int causal, int window, int q_offset, int kv_len,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m_out, l_out, Lq, Lk, H,
      causal, window, q_offset, kv_len, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/o: (B, Lq, H, D), k/v: (B, Lk, H, D), contiguous, 16-byte aligned.
// D in {32, 64, 128}; dtype: 0 = float32, 1 = bfloat16.  window <= 0
// means no window.
// Keys at positions >= kv_len (<= Lk) are masked.  m_out / l_out: null, or
// (B, Lq, H) f32 for each row's running max and normaliser.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* m_out, void* l_out, int B, int Lq,
                           int Lk, int H, int D,
                           int causal, int window, int q_offset, int kv_len,
                           int dtype, void* stream) {
  if (B <= 0 || Lq <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH(T, DD)                                                 \
  return launch<T, DD>(q, k, v, o, static_cast<float*>(m_out),            \
                       static_cast<float*>(l_out), B, Lq, Lk, H, causal,   \
                       window, q_offset, kv_len, st)
  if (dtype == 0 && D == 32) REPRO_FLASH(float, 32);
  if (dtype == 0 && D == 64) REPRO_FLASH(float, 64);
  if (dtype == 0 && D == 128) REPRO_FLASH(float, 128);
  if (dtype == 1 && D == 32) REPRO_FLASH(__nv_bfloat16, 32);
  if (dtype == 1 && D == 64) REPRO_FLASH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) REPRO_FLASH(__nv_bfloat16, 128);
#undef REPRO_FLASH
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
