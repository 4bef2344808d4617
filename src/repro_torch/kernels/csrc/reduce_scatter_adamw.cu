// ReduceScatter's final accumulation fused with the AdamW update, for
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `reduce_scatter_adamw` of
// repro/kernels/fused_collectives.py (kernel body `_rs_adamw_kernel`,
// pl.pallas_call at fused_collectives.py:130).  A rank holds its n_src
// peers' gradient partials of its parameter segment; the kernel sums them
// and applies the AdamW step of `optim.adamw_update` without ever writing
// the summed gradient:
//
//   g  = sum_{s < n_src} shards[s, i]                      (f32, in s order)
//   m' = b1 m + (1 - b1) g            v' = b2 v + (1 - b2) g^2
//   d  = (m' / bc1) / (sqrt(v' / bc2) + eps)  [+ weight_decay * p]
//   p' = p - lr d
//
// p' is written in p's dtype, m' and v' in f32, out of place (the reference
// returns new arrays).  lr, bc1 and bc2 come from a schedule: each is a
// float argument or, when its pointer is not null, one f32 word read on the
// device, so a schedule kept on the card costs no host sync.
//
// What bounds it on the H100: memory.  It must read n_src * L gradient
// elements, p, m and v once and write p', m' and v' once: (n_src * gs + 2 *
// ps + 16) * L bytes (gs, ps the gradient and param itemsizes) over
// 3.35 TB/s, 40 L bytes for f32 at n_src = 4.  About 15 flops and one
// square root per element are far below the fp32 peak.
//
// What the design does about it: one elementwise pass.  Each thread owns a
// strip of 4 consecutive elements (16-byte loads of f32 arrays, 8-byte of
// bf16; neighbouring threads on neighbouring addresses), sums the sources
// in f32 registers in index order, updates the strip and writes it once;
// the grid strides over L, so any L runs with a grid sized to the card.
// No tile padding (the TPU kernel pads L to 2048): the tail is masked, so
// nothing past L is read or written.  Every arithmetic step is one
// IEEE-rounded operation (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no
// contraction into fused multiply-adds), as the unfused PyTorch and JAX
// versions round them.  Launches run on the caller's stream, allocate
// nothing and return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 4;     // elements per thread per iteration

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

// N consecutive elements of T as f32: one 16- or 8-byte access when
// N * sizeof(T) is 16 or 8 (the caller guarantees the alignment).
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float (&out)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else if constexpr (N * sizeof(T) == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
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
  } else if constexpr (N * sizeof(T) == 8) {
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f32<T>(in[i]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f32<T>(in[i]);
  }
}

struct Hypers {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay;
  float lr, bc1, bc2;                 // used where the pointer is null
  const float* lr_p;
  const float* bc1_p;
  const float* bc2_p;
};

// N: elements per strip (kStrip on the aligned path, 1 otherwise).
// G: gradient dtype, P: param dtype; moments are f32.
template <typename G, typename P, int N>
__global__ void __launch_bounds__(kThreads)
    rs_adamw_kernel(const G* __restrict__ g, const P* __restrict__ p,
                    const float* __restrict__ m, const float* __restrict__ v,
                    P* __restrict__ p_out, float* __restrict__ m_out,
                    float* __restrict__ v_out, int n_src, long long L,
                    Hypers h) {
  const float lr = h.lr_p ? *h.lr_p : h.lr;
  const float bc1 = h.bc1_p ? *h.bc1_p : h.bc1;
  const float bc2 = h.bc2_p ? *h.bc2_p : h.bc2;
  const long long strips = (L + N - 1) / N;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long s = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       s < strips; s += stride) {
    const long long i = s * N;        // the aligned path has L % N == 0
    float gs[N], part[N], p32[N], m32[N], v32[N];
#pragma unroll
    for (int j = 0; j < N; ++j) gs[j] = 0.f;
    for (int src = 0; src < n_src; ++src) {
      load_n<G, N>(g + static_cast<long long>(src) * L + i, part);
#pragma unroll
      for (int j = 0; j < N; ++j) gs[j] = __fadd_rn(gs[j], part[j]);
    }
    load_n<P, N>(p + i, p32);
    load_n<float, N>(m + i, m32);
    load_n<float, N>(v + i, v32);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float gj = gs[j];
      const float mj = __fadd_rn(__fmul_rn(h.b1, m32[j]),
                                 __fmul_rn(h.one_minus_b1, gj));
      const float vj = __fadd_rn(__fmul_rn(h.b2, v32[j]),
                                 __fmul_rn(h.one_minus_b2,
                                           __fmul_rn(gj, gj)));
      float d = __fdiv_rn(__fdiv_rn(mj, bc1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(vj, bc2)), h.eps));
      if (h.weight_decay != 0.f)
        d = __fadd_rn(d, __fmul_rn(h.weight_decay, p32[j]));
      p32[j] = __fsub_rn(p32[j], __fmul_rn(lr, d));
      m32[j] = mj;
      v32[j] = vj;
    }
    store_n<P, N>(p_out + i, p32);
    store_n<float, N>(m_out + i, m32);
    store_n<float, N>(v_out + i, v32);
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

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename G, typename P>
cudaError_t launch(const void* g, const void* p, const float* m,
                   const float* v, void* p_out, float* m_out, float* v_out,
                   int n_src, long long L, const Hypers& h,
                   cudaStream_t stream) {
  constexpr int N = kStrip;
  const bool vec = L % N == 0 && aligned(g, N * sizeof(G)) &&
                   aligned(p, N * sizeof(P)) &&
                   aligned(p_out, N * sizeof(P)) && aligned(m, 16) &&
                   aligned(v, 16) && aligned(m_out, 16) &&
                   aligned(v_out, 16);
  const long long strips = vec ? L / N : L;
  long long blocks = (strips + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 8;
  if (blocks > cap) blocks = cap;
  const G* gt = static_cast<const G*>(g);
  const P* pt = static_cast<const P*>(p);
  P* po = static_cast<P*>(p_out);
  if (vec)
    rs_adamw_kernel<G, P, N><<<static_cast<int>(blocks), kThreads, 0,
                               stream>>>(gt, pt, m, v, po, m_out, v_out,
                                         n_src, L, h);
  else
    rs_adamw_kernel<G, P, 1><<<static_cast<int>(blocks), kThreads, 0,
                               stream>>>(gt, pt, m, v, po, m_out, v_out,
                                         n_src, L, h);
  return cudaGetLastError();
}

template <typename G>
cudaError_t launch_p(int p_dtype, const void* g, const void* p,
                     const float* m, const float* v, void* p_out,
                     float* m_out, float* v_out, int n_src, long long L,
                     const Hypers& h, cudaStream_t st) {
  if (p_dtype == 0)
    return launch<G, float>(g, p, m, v, p_out, m_out, v_out, n_src, L, h,
                            st);
  if (p_dtype == 1)
    return launch<G, __nv_bfloat16>(g, p, m, v, p_out, m_out, v_out, n_src,
                                    L, h, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// g: (n_src, L) contiguous; p, p_out: (L,) of p_dtype; m, v, m_out, v_out:
// (L,) float32.  g_dtype / p_dtype: 0 = float32, 1 = bfloat16.  lr_p,
// bc1_p, bc2_p: device pointers to one float32 each, or null to use the
// float argument beside it.
int reduce_scatter_adamw_launch(
    const void* g, const void* p, const void* m, const void* v, void* p_out,
    void* m_out, void* v_out, int n_src, long long L, int g_dtype,
    int p_dtype, float b1, float one_minus_b1, float b2, float one_minus_b2,
    float eps, float weight_decay, float lr, float bc1, float bc2,
    const void* lr_p, const void* bc1_p, const void* bc2_p, void* stream) {
  if (L <= 0) return cudaSuccess;
  if (n_src <= 0) return cudaErrorInvalidValue;
  Hypers h{b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, lr, bc1,
           bc2, static_cast<const float*>(lr_p),
           static_cast<const float*>(bc1_p),
           static_cast<const float*>(bc2_p)};
  const float* mf = static_cast<const float*>(m);
  const float* vf = static_cast<const float*>(v);
  float* mo = static_cast<float*>(m_out);
  float* vo = static_cast<float*>(v_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0)
    return launch_p<float>(p_dtype, g, p, mf, vf, p_out, mo, vo, n_src, L,
                           h, st);
  if (g_dtype == 1)
    return launch_p<__nv_bfloat16>(p_dtype, g, p, mf, vf, p_out, mo, vo,
                                   n_src, L, h, st);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
