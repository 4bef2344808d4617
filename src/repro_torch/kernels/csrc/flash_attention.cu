// FlashAttention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// repro/kernels/flash_attention.py (kernel body `_kernel`,
// flash_attention.py:27-75, pl.pallas_call at flash_attention.py:91).  The
// JAX model reaches the same function through its jnp twin
// repro/models/flash.py, whose interface this kernel takes: the model's
// layout q (B, Lq, H, D) and k/v (B, Lk, H, D), already GQA-expanded, with
// `causal`, a sliding `window`, `q_offset` (absolute position of query row
// 0) and a ragged kv length.  No padding pass: the kernel masks the ragged
// q and kv edges itself.
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
// (query, key) pair against reading q, k, v and writing o once.  In f32
// the products run on the tensor cores in 3xTF32 (mma.sync m16n8k8 tf32:
// 495 / 3 = 165 TFLOP/s at most, against 67 TFLOP/s of f32 FMA); in bf16
// one mma.sync m16n8k16 bf16 per product (exact products, f32 sums).
//
// What the design does about it (FlashAttention-2's shape):
// * One block of 4 warps per (64-row q tile, head, batch); each warp owns
//   16 query rows.  In f32 at D <= 64 the warp's q fragments are split
//   once (big = tf32_rn(q), small = tf32_rn(q - big), rounding to
//   nearest on the bit pattern) and kept in registers; at D = 96 and 128
//   they are re-read from shared memory each kv tile; bf16 fragments
//   always stay in registers.
// * S = Q K^T on the tensor cores (3 mma per product in f32:
//   small*big + big*small + big*big), the softmax in registers: each
//   thread holds two rows' scores, the row max and sum are taken across
//   the 4 lanes of a quad by shuffles.
// * P stays in registers.  In f32 the P.V product numbers its contraction
//   so that k index t is key 2t and k index t+4 is key 2t+1, the keys a
//   thread's score fragment already holds: P needs no shuffle, and V's
//   fragment reads the same two keys.  In bf16 the score fragments of two
//   key groups are the m16n8k16 A operand as they stand.
// * K and V tiles go through a 2-stage cp.async ring: the next tile's
//   16-byte copies are in flight while this tile multiplies, one barrier
//   per tile.  Row strides padded by 4 floats (8 bf16) keep every
//   fragment read free of bank conflicts: an f32 row is 4 mod 32 words
//   at every D (68, 100, 132), a bf16 row 4 mod 32 at D = 64 and 128 and
//   20 mod 32 at D = 96 (52 words: the 8 rows a fragment read spans
//   still start 4 banks apart or more).
// * Kv tiles wholly above the causal diagonal or below the window are
//   skipped, masks are evaluated only on tiles that cut a boundary (the
//   ragged last kv tile of any length, cross attention's Lk != Lq
//   included), and the grid runs the heaviest causal q tiles (the last
//   ones) first.
// * No atomics: a repeat is bitwise equal.
//
// Measured (chip_smoke.py, H100 80GB HBM3, 700 W; PERF.md §6 has the
// table): 0.12176 ms at (1, 1024, 32, 64) causal f32, 21% of its 3xTF32
// bound, against scaled_dot_product_attention's 0.22511 in the same run
// and the earlier CUDA-core kernel at 0.26360.
//
// Launches run on the caller's stream, allocate nothing and return
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;         // query rows per block (16 per warp)
constexpr int BKV = 64;        // kv rows per tile
constexpr int kThreads = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// 3xTF32 split of one f32 value: tf32 round to nearest, ties away from
// zero (as cvt.rna.tf32.f32 rounds), on the bit pattern in two integer ops.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  const float rest = x - __uint_as_float(big);
  small = (__float_as_uint(rest) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += small_a*big_b + big_a*small_b + big_a*big_b
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int D>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // row stride in elements: f32 D + 4 (= 4 mod 32 words), bf16 D + 8
  static constexpr int P = D + (kF32 ? 4 : 8);
  static constexpr int TILE = 64 * P;          // elements of one tile
  static constexpr int KQ = kF32 ? D / 8 : D / 16;  // k steps of Q K^T
  static constexpr bool kQRegs = !kF32 || D <= 64;  // q fragments cached
  static constexpr int NO = D / 8;             // output n tiles per warp
  static constexpr size_t SMEM = static_cast<size_t>(5) * TILE * sizeof(T);
};

// Copy rows [row0, row0 + 64) of one head into a tile (stride P), 16 bytes
// at a time; rows at or past `nrows` are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ base,
                                          int row0, int nrows,
                                          size_t row_stride) {
  constexpr int E = 16 / sizeof(T);
  constexpr int PER_ROW = D / E;
  constexpr int PER = 64 * PER_ROW / kThreads;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / PER_ROW, col = (c % PER_ROW) * E;
    const bool ok = row0 + r < nrows;
    const T* src = ok ? base + static_cast<size_t>(row0 + r) * row_stride + col
                      : base;
    cp_async16(dst + r * Cfg<T, D>::P + col, src, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Lq, int Lk, int H, int causal, int window,
                     int q_offset, int kv_len, float scale) {
  using C = Cfg<T, D>;
  constexpr int P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + C::TILE;          // [2][64][P]
  T* Vs = Ks + 2 * C::TILE;      // [2][64][P]

  // blocks start x fastest: every head's last (heaviest causal) q tile
  // first, then the tile before it
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the q tile
  const size_t row_stride = static_cast<size_t>(H) * D;
  const T* qb = q + (b * Lq * H + h) * D;
  const T* kb = k + (b * Lk * H + h) * D;
  const T* vb = v + (b * Lk * H + h) * D;
  T* ob = o + (b * Lq * H + h) * D;

  // Kv tiles that hold at least one key some row of this q tile may see.
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, Lq) - 1;
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_hi + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q_lo - window + 1);
  const int t_begin = kv_begin / BKV;
  const int t_end = kv_end > 0 ? (kv_end + BKV - 1) / BKV : 0;
  // the warp's rows, for deciding which tiles need a mask
  const int w_lo = q_lo + wr, w_hi = q_lo + wr + 15;

  load_tile<T, D>(Qs, qb, q0, Lq, row_stride);
  if (t_begin < t_end) {
    load_tile<T, D>(Ks, kb, t_begin * BKV, Lk, row_stride);
    load_tile<T, D>(Vs, vb, t_begin * BKV, Lk, row_stride);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // q fragments: f32 as (big, small) tf32 pairs, bf16 as packed pairs
  uint32_t qf[C::kQRegs ? C::KQ : 1][4];
  uint32_t qs[C::kF32 && C::kQRegs ? C::KQ : 1][4];
  auto q_frag = [&](int kk, uint32_t (&fb)[4], uint32_t (&fs)[4]) {
    if constexpr (C::kF32) {
      const float* p = reinterpret_cast<const float*>(Qs) + (wr + g) * P +
                       kk * 8 + t;
      split_tf32(p[0], fb[0], fs[0]);            // (row g, k t)
      split_tf32(p[8 * P], fb[1], fs[1]);        // (row g+8, k t)
      split_tf32(p[4], fb[2], fs[2]);            // (row g, k t+4)
      split_tf32(p[8 * P + 4], fb[3], fs[3]);    // (row g+8, k t+4)
    } else {
      const T* p = Qs + (wr + g) * P + kk * 16 + 2 * t;
      fb[0] = *reinterpret_cast<const uint32_t*>(p);
      fb[1] = *reinterpret_cast<const uint32_t*>(p + 8 * P);
      fb[2] = *reinterpret_cast<const uint32_t*>(p + 8);
      fb[3] = *reinterpret_cast<const uint32_t*>(p + 8 * P + 8);
    }
  };
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < C::KQ; ++kk) {
      uint32_t unused[4];
      if constexpr (C::kF32)
        q_frag(kk, qf[kk], qs[kk]);
      else
        q_frag(kk, qf[kk], unused);
    }
  }

  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  float acc[C::NO][4];
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  for (int it = t_begin; it < t_end; ++it) {
    const int st = (it - t_begin) & 1;
    cp_async_wait_all();  // tile it has landed
    __syncthreads();      // ... for every thread; tile it-1 is read
    if (it + 1 < t_end) {
      load_tile<T, D>(Ks + (st ^ 1) * C::TILE, kb, (it + 1) * BKV, Lk,
                      row_stride);
      load_tile<T, D>(Vs + (st ^ 1) * C::TILE, vb, (it + 1) * BKV, Lk,
                      row_stride);
    }
    cp_async_commit();
    const T* kt = Ks + st * C::TILE;
    const T* vt = Vs + st * C::TILE;
    const int k0 = it * BKV;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KQ; ++kk) {
      if constexpr (C::kF32) {
        uint32_t ab[4], as[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ab[r] = qf[kk][r];
            as[r] = qs[kk][r];
          }
        } else {
          q_frag(kk, ab, as);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* p = reinterpret_cast<const float*>(kt) +
                           (j * 8 + g) * P + kk * 8 + t;
          uint32_t bb[2], bs[2];
          split_tf32(p[0], bb[0], bs[0]);  // (k t, key g)
          split_tf32(p[4], bb[1], bs[1]);  // (k t+4, key g)
          mma_3xtf32(s[j], ab, as, bb, bs);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const T* p = kt + (j * 8 + g) * P + kk * 16 + 2 * t;
          mma_bf16(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(p),
                   *reinterpret_cast<const uint32_t*>(p + 8));
        }
      }
    }

    // online softmax; this thread holds rows g (r = 0) and g + 8 (r = 1),
    // keys j*8 + 2t and j*8 + 2t + 1 of each n tile
    const bool edge = k0 + BKV > kv_len || (causal && k0 + BKV - 1 > w_lo) ||
                      (window > 0 && k0 <= w_hi - window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q_lo + wr + g + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[j][2 * r + c] * scale;
          if (edge) {
            const int kpos = k0 + j * 8 + 2 * t + c;
            bool ok = kpos < kv_len;
            if (causal) ok = ok && kpos <= qpos;
            if (window > 0) ok = ok && kpos > qpos - window;
            x = ok ? x : NEG_INF;
          }
          s[j][2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      }
      const float m_new = fmaxf(m_run[r], quad_max(mx));
      const float corr = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[j][2 * r + c] - m_new);
          s[j][2 * r + c] = p;
          sum += p;
        }
      }
      l_run[r] = l_run[r] * corr + quad_sum(sum);
      m_run[r] = m_new;
#pragma unroll
      for (int n = 0; n < C::NO; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // O += P V
    if constexpr (C::kF32) {
      const float* vf = reinterpret_cast<const float*>(vt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // k index t <-> key 2t, t+4 <-> key 2t+1: a0 = (row g, key 2t),
        // a1 = (row g+8, key 2t), a2 = (row g, key 2t+1), a3 = row g+8
        uint32_t pb[4], ps[4];
        split_tf32(s[j][0], pb[0], ps[0]);
        split_tf32(s[j][2], pb[1], ps[1]);
        split_tf32(s[j][1], pb[2], ps[2]);
        split_tf32(s[j][3], pb[3], ps[3]);
        const float* p = vf + (j * 8 + 2 * t) * P + g;
#pragma unroll
        for (int n = 0; n < C::NO; ++n) {
          uint32_t bb[2], bs[2];
          split_tf32(p[n * 8], bb[0], bs[0]);      // (key 2t, d g)
          split_tf32(p[P + n * 8], bb[1], bs[1]);  // (key 2t+1, d g)
          mma_3xtf32(acc[n], pb, ps, bb, bs);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const T* p = vt + (kk * 16 + 2 * t) * P + g;
#pragma unroll
        for (int n = 0; n < C::NO; ++n) {
          const T* pn = p + n * 8;
          mma_bf16(acc[n], pa, pack_bf16(pn[0], pn[P]),
                   pack_bf16(pn[8 * P], pn[9 * P]));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    if (qi >= Lq) continue;
    const float l = fmaxf(l_run[r], 1e-20f);
    T* orow = ob + static_cast<size_t>(qi) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < C::NO; ++n) {
      const float a0 = acc[n][2 * r] / l, a1 = acc[n][2 * r + 1] / l;
      if constexpr (C::kF32) {
        *reinterpret_cast<float2*>(orow + n * 8) = make_float2(a0, a1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(a0, a1);
      }
    }
    if (m_out != nullptr && t == 0) {  // the 4 lanes of a quad agree
      const size_t row = (b * Lq + qi) * H + h;
      m_out[row] = m_run[r];
      l_out[row] = l_run[r];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* m_out, float* l_out, int B, int Lq, int Lk, int H,
                   int causal, int window, int q_offset, int kv_len,
                   cudaStream_t stream) {
  const size_t smem = Cfg<T, D>::SMEM;
  // a function attribute belongs to the current device's context: set it
  // on every launch, so a launch on another card is configured too
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (Lq + BQ - 1) / BQ, B);
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
// D in {32, 64, 96, 128}; dtype: 0 = float32, 1 = bfloat16.  window <= 0
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
  if (dtype == 0 && D == 96) REPRO_FLASH(float, 96);
  if (dtype == 0 && D == 128) REPRO_FLASH(float, 128);
  if (dtype == 1 && D == 32) REPRO_FLASH(__nv_bfloat16, 32);
  if (dtype == 1 && D == 64) REPRO_FLASH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 96) REPRO_FLASH(__nv_bfloat16, 96);
  if (dtype == 1 && D == 128) REPRO_FLASH(__nv_bfloat16, 128);
#undef REPRO_FLASH
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
