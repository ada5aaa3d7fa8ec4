// Flash attention for Hopper (sm_90a): softmax(q k^T / sqrt(D)) v with the
// online softmax of the TPU kernel, for bf16 and f32 inputs.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_tpu (:97), body _kernel (:36)  -> flash_kernel
//
// Layouts (all contiguous): q and out (B*H, Sq, D); k and v (B*H, Sk, D).
// GQA heads are expanded by the caller, as for the TPU kernel.
//
// The TPU kernel runs a sequential grid (B*H, nq, nk) and carries the
// online-softmax state (m, l, acc) in scratch across the nk steps.  Here the
// grid is (B*H, ceil(Sq / bq)): a block owns bq query rows, takes them 64 at
// a time, and walks the keys in blocks of bk inside the block, 64 keys per
// step; the state of each row stays in the registers of the threads that
// own it.  Neither bq nor bk needs to divide the sequence: rows past Sq are
// not written and keys past Sk take no part (weight exactly 0).
//
// Numerics follow the TPU kernel: f32 throughout (q scaled in f32, FFMA
// products, no TF32), masked scores at the finite NEG_INF = -1e30, no guard
// for fully masked rows, and the denominator clamped at 1e-30.  With a
// finite NEG_INF a fully masked block still adds exp(0) = 1 terms to a row
// that has seen no live key yet, which a later live block's correction
// wipes out exactly.  So a block of keys is skipped only where it is fully
// masked for all of the 64 rows at hand AND each of those rows has a live
// key somewhere: then the skip is exact.  Rows without any live key (a
// window that outruns the keys) walk every block and average v, as the TPU
// kernel does.
//
// What bounds it on an H100: operations at the main-path shape (4 x 12 heads
// x 512 x 512 x 128 is ~4 x 10^9 multiply-adds against ~50 MB of q, k, v and
// out).  This first version keeps f32 FFMA on a 4 x 8 register micro-tile
// with the tiles in shared memory (rows padded against bank conflicts); it
// skips the causal half of the work but uses neither tensor cores (wgmma)
// nor TMA, so it runs far below the bf16 tensor-core bound.
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry point is at the end of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQT = 64;   // query rows per sub-tile
constexpr int kKT = 64;   // keys per step
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory: Q (64, D+1), K (64, D+1), V (64, D), P (64, 65), all f32.
template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kQT * (D + 1) + kKT * (D + 1) + kKT * D + kQT * (kKT + 1)) * 4;
}

// Thread t owns query rows 4 * (t / 8) .. +3 of the sub-tile; for scores it
// owns key columns (t % 8) + 8 j, j < 8, and for the output head-dim columns
// (t % 8) + 8 j, j < D / 8.  The 8 threads that share rows are neighbouring
// lanes, so row maxima and sums reduce with three shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
                 int bq, int bk, int causal, int window) {
  constexpr int DP = D + 1, KP = kKT + 1, DJ = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kQT * DP;
  float* vs = ks + kKT * DP;
  float* ps = vs + kKT * D;

  const size_t bh = blockIdx.x;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;
  T* ob = out + bh * sq * D;
  const int tid = threadIdx.x, tx = tid & 7, r0 = (tid >> 3) * 4;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int q_begin = blockIdx.y * bq;
  const int q_end = min(q_begin + bq, sq);

  for (int qa = q_begin; qa < q_end; qa += kQT) {
    const int qe = min(qa + kQT, q_end);
    for (int i = tid; i < kQT * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      qs[r * DP + c] = qa + r < qe ? to_float(qb[(size_t)(qa + r) * D + c]) * scale
                                   : 0.0f;
    }
    float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_i[i] = kNegInf;
      l_i[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
    }
    // every row of the sub-tile has a live key (the last row is the hardest)
    const bool rows_live = window <= 0 || qe - 1 <= sk + window - 2;

    for (int kb0 = 0; kb0 < sk; kb0 += bk) {
      const int kbe = min(kb0 + bk, sk);
      if (rows_live && ((causal && kb0 > qe - 1) ||
                        (window > 0 && qa - (kbe - 1) >= window)))
        continue;  // fully masked for every row: an exact 0 (see above)
      for (int kt = kb0; kt < kbe; kt += kKT) {
        const int kte = min(kt + kKT, kbe);
        __syncthreads();  // the previous step's readers are done
        for (int i = tid; i < kKT * D; i += kThreads) {
          const int r = i / D, c = i - r * D;
          const bool in = kt + r < kte;
          const size_t src = (size_t)(kt + r) * D + c;
          ks[r * DP + c] = in ? to_float(kb[src]) : 0.0f;
          vs[r * D + c] = in ? to_float(vb[src]) : 0.0f;
        }
        __syncthreads();

        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int e = 0; e < D; ++e) {
          float qv[4], kv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = qs[(r0 + i) * DP + e];
#pragma unroll
          for (int j = 0; j < 8; ++j) kv[j] = ks[(tx + 8 * j) * DP + e];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = qa + r0 + i;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int kj = kt + tx + 8 * j;
            if (kj >= kte) {
              s[i][j] = -INFINITY;  // no such key: weight exactly 0
            } else {
              bool ok = true;
              if (causal) ok = ok && kj <= qi;
              if (window > 0) ok = ok && qi - kj < window;
              if (!ok) s[i][j] = kNegInf;
            }
            mx = fmaxf(mx, s[i][j]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          const float m_new = fmaxf(m_i[i], mx);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float p = expf(s[i][j] - m_new);
            ps[(r0 + i) * KP + tx + 8 * j] = p;
            sum += p;
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          const float corr = expf(m_i[i] - m_new);
          l_i[i] = l_i[i] * corr + sum;
          m_i[i] = m_new;
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < kKT; ++c) {
          float pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = ps[(r0 + i) * KP + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            const float vv = vs[c * D + tx + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qa + r0 + i;
      if (qi < qe) {
        const float inv = 1.0f / fmaxf(l_i[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          ob[(size_t)qi * D + tx + 8 * j] = from_float<T>(acc[i][j] * inv);
      }
    }
    __syncthreads();  // Q of the next sub-tile overwrites shared memory
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int sk, int bq, int bk, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  flash_kernel<T, D><<<dim3(bh, (sq + bq - 1) / bq), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, bq, bk, causal,
      window);
  return cudaGetLastError();
}

}  // namespace

// The head dims compiled for each dtype; HEAD_DIMS in
// repro_torch/kernels/flash_attention.py is the same list.
#define FLASH_HEAD_DIMS(X) X(32) X(64) X(128)

extern "C" {

// dtype: 0 = bf16, 1 = f32 (q, k, v and the output share it).  bh = B * H.
// Returns the CUDA error of the launch (0 on success), or -1 for a head dim
// that is not compiled.
int flash_attention_launch(int dtype, int d, const void* q, const void* k,
                           const void* v, void* out, int bh, int sq, int sk,
                           int bq, int bk, int causal, int window,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || bq < 1 || bk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_DISPATCH(D)                                                     \
  if (d == D)                                                                 \
    return static_cast<int>(                                                  \
        dtype == 0 ? launch<__nv_bfloat16, D>(q, k, v, out, bh, sq, sk, bq,  \
                                              bk, causal, window, s)          \
                   : launch<float, D>(q, k, v, out, bh, sq, sk, bq, bk,      \
                                      causal, window, s));
  FLASH_HEAD_DIMS(FLASH_DISPATCH)
#undef FLASH_DISPATCH
  return -1;
}

}  // extern "C"
