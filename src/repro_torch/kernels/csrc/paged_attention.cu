// Paged-attention decode for Hopper (sm_90a): one query token per slot
// attends its first kv_len logical rows, which live in a page pool behind
// the slot's block table.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention.py:
//   paged_attention_tpu (:195), body _kernel (:96)  -> paged_decode_kernel
// in both of its forms: float pools, and int8 pools (`quantized=True`)
// with their per-row scale pools.
//
// Layouts (all contiguous): q and out (B, 1, H, D); the k and v pools
// (P, page, KV, D); for int8 pools the k and v scale pools (P, page, KV)
// f32; block tables (B, n_bt) int32 with -1 for a hole; kv_len (B,) int32.
// Head h of the query belongs to KV head h / G (G = H / KV).
//
// The TPU kernel walks a sequential grid (B, KV, n_bt) with the block table
// scalar-prefetched and the online-softmax state (m, l, acc) carried in
// scratch from one page to the next.  Here one block owns one (slot, KV
// head) and covers its G query heads; the page walk is a loop inside the
// block, and the state lives in shared memory for the whole walk:
//   1. stage the next whole pages of K and V rows (up to 64 rows) into
//      shared memory, each page read once, 16 bytes a thread where the
//      head dim allows (K rows padded by 16 bytes against bank conflicts);
//      int8 pools stage the rows' k and v scales beside them;
//   2. G x rows scores in f32, a thread per (head, row) pair; int8 pools
//      multiply each score by its row's k scale before the mask;
//   3. the online-softmax update of (m, l) a warp per query head, with the
//      m == NEG_INF guard, so a slot with nothing live writes exact zeros;
//      l sums the unscaled weights p, and only then does an int8 pool
//      multiply p by its row's v scale (the TPU kernel's order: the
//      denominator is the plain softmax's);
//   4. acc = acc * corr + p @ V, a thread per (head, d) pair.
// The walk stops after ceil(kv_len / page) pages (at most n_bt): a page
// wholly past kv_len adds an exact 0 in the TPU kernel, so skipping it is
// exact.  Holes clamp to page 0 and table entries past the pool to its last
// page, on the row pools and the scale pools alike, so no read leaves a
// pool; their rows mask to 0 when they lie past kv_len.  Queries are scaled
// as the plain version scales them: q / sqrt(D) rounded to the input type,
// then f32.
//
// What bounds it on an H100: bytes.  Each live K and V row is read once
// (for int8 pools D bytes and one f32 scale a row: about half the bf16
// bytes) and the work is 4 * G * D operations per row, far below the ~295
// FLOP per byte where the card turns compute-bound.  The design reads each
// row once with vector loads and keeps every intermediate on chip; with
// one block per (slot, KV head) a decode batch of 8 slots fills only 16 of
// the 132 SMs, so the walk is latency-bound (a split over pages is for
// later).
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry point is at the end of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_float<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>  // only ever given 0 (the staging of rows past the walk)
__device__ __forceinline__ int8_t from_float<int8_t>(float v) {
  return static_cast<int8_t>(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory: q (G, D) f32 | acc (G, D) f32 | scores (G, R) f32 |
// m, l, corr (G,) f32 | int8 pools: k scales, v scales (R,) f32 | pad to
// 16 bytes | K rows (R, D + kpad) P | pad to 16 bytes | V rows (R, D) P.
// paged_attention.smem_bytes mirrors this.
__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}
__host__ __device__ inline size_t float_region(int g, int d, int rows,
                                               bool quant) {
  return align16((2 * (size_t)g * d + (size_t)g * rows + 3 * g +
                  (quant ? 2 * (size_t)rows : 0)) * 4);
}
// K rows are padded by one vector (16 bytes), or by one element for scalar
// loads, so the rows that neighbouring threads read fall in other banks.
__host__ __device__ inline int k_pad(int vec) { return vec > 1 ? vec : 1; }

// T: q and out (bf16 or f32); P: the pools (T, or int8_t under QUANT);
// VEC elements of P per load: 16 bytes where the head dim allows, else 1.
template <typename T, typename P, int VEC, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                        const P* __restrict__ vp,
                        const float* __restrict__ ksp,
                        const float* __restrict__ vsp,
                        const int* __restrict__ bt,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        int kv, int g, int d, int n_pool, int page, int n_bt,
                        int ppc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int rows = ppc * page;
  float* qs = reinterpret_cast<float*>(smem);
  float* acc = qs + g * d;
  float* sc = acc + g * d;
  float* m = sc + g * rows;
  float* l = m + g;
  float* corr = l + g;
  float* kscale = corr + g;  // (rows,) each, used under QUANT only
  float* vscale = kscale + rows;
  const int ks_stride = d + k_pad(VEC);
  const size_t fr = float_region(g, d, rows, QUANT);
  P* ks = reinterpret_cast<P*>(smem + fr);
  P* vs = reinterpret_cast<P*>(smem + fr +
                               align16((size_t)rows * ks_stride * sizeof(P)));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int heads = kv * g;
  const float inv_sqrt_d = 1.0f / sqrtf(static_cast<float>(d));
  const T* qb = q + ((size_t)b * heads + (size_t)h * g) * d;
  for (int i = tid; i < g * d; i += kThreads) {
    qs[i] = to_float(from_float<T>(to_float(qb[i]) * inv_sqrt_d));
    acc[i] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  const int len = kv_len[b];
  int n_live = len > 0 ? (len + page - 1) / page : 0;
  if (n_live > n_bt) n_live = n_bt;
  const int* table = bt + (size_t)b * n_bt;
  const size_t row_stride = (size_t)kv * d;  // elements between pool rows
  __syncthreads();

  for (int p0 = 0; p0 < n_live; p0 += ppc) {
    // 1. stage K and V rows of pages p0 .. p0 + ppc - 1 (zeros past n_live)
    const int vecs = d / VEC;
    for (int i = tid; i < rows * vecs; i += kThreads) {
      const int r = i / vecs, c = (i - r * vecs) * VEC;
      const int j = p0 + r / page;
      P* kd = ks + (size_t)r * ks_stride + c;
      P* vd = vs + (size_t)r * d + c;
      if (j < n_live) {
        int phys = table[j];
        phys = phys < 0 ? 0 : (phys >= n_pool ? n_pool - 1 : phys);
        const size_t src =
            ((size_t)phys * page + (r % page)) * row_stride + (size_t)h * d + c;
        if (VEC > 1) {
          *reinterpret_cast<uint4*>(kd) =
              *reinterpret_cast<const uint4*>(kp + src);
          *reinterpret_cast<uint4*>(vd) =
              *reinterpret_cast<const uint4*>(vp + src);
        } else {
          *kd = kp[src];
          *vd = vp[src];
        }
      } else {
        for (int e = 0; e < VEC; ++e) {
          kd[e] = from_float<P>(0.0f);
          vd[e] = from_float<P>(0.0f);
        }
      }
    }
    if (QUANT) {
      // the rows' scales, clamped through the table as the rows are
      for (int r = tid; r < rows; r += kThreads) {
        const int j = p0 + r / page;
        float ksv = 0.0f, vsv = 0.0f;
        if (j < n_live) {
          int phys = table[j];
          phys = phys < 0 ? 0 : (phys >= n_pool ? n_pool - 1 : phys);
          const size_t at = ((size_t)phys * page + (r % page)) * kv + h;
          ksv = ksp[at];
          vsv = vsp[at];
        }
        kscale[r] = ksv;
        vscale[r] = vsv;
      }
    }
    __syncthreads();

    // 2. scores (times the row's k scale for int8 pools), masked past
    //    kv_len (and past the table): a thread per (head, row);
    //    neighbouring threads take neighbouring rows
    for (int i = tid; i < g * rows; i += kThreads) {
      const int gi = i / rows, r = i - gi * rows;
      const int pos = p0 * page + r;
      float s = kNegInf;
      if ((p0 + r / page) < n_live && pos < len) {
        const P* krow = ks + (size_t)r * ks_stride;
        const float* qrow = qs + (size_t)gi * d;
        s = 0.0f;
        for (int e = 0; e < d; e += VEC) {
          alignas(16) P kvals[VEC];
          if (VEC > 1)
            *reinterpret_cast<uint4*>(kvals) =
                *reinterpret_cast<const uint4*>(krow + e);
          else
            kvals[0] = krow[e];
#pragma unroll
          for (int x = 0; x < VEC; ++x) s += qrow[e + x] * to_float(kvals[x]);
        }
        if (QUANT) s *= kscale[r];
      }
      sc[i] = s;
    }
    __syncthreads();

    // 3. online softmax over this chunk, a warp per query head: l takes
    //    the unscaled p, acc the p that an int8 pool's v scale multiplies
    for (int gi = warp; gi < g; gi += kWarps) {
      float* srow = sc + (size_t)gi * rows;
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, srow[r]);
      mx = warp_max(mx);
      const float m_prev = m[gi];
      const float m_new = fmaxf(m_prev, mx);
      const bool dead = m_new == kNegInf;
      float sum = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float p = dead ? 0.0f : expf(srow[r] - m_new);
        sum += p;
        srow[r] = QUANT ? p * vscale[r] : p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = dead ? 0.0f : expf(m_prev - m_new);
        l[gi] = l[gi] * c + sum;
        m[gi] = m_new;
        corr[gi] = c;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + p @ V
    for (int i = tid; i < g * d; i += kThreads) {
      const int gi = i / d, e = i - gi * d;
      const float* prow = sc + (size_t)gi * rows;
      float a = acc[i] * corr[gi];
      for (int r = 0; r < rows; ++r) a += prow[r] * to_float(vs[(size_t)r * d + e]);
      acc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * heads + (size_t)h * g) * d;
  for (int i = tid; i < g * d; i += kThreads)
    ob[i] = from_float<T>(acc[i] / fmaxf(l[i / d], 1e-30f));
}

struct Args {
  const void *q, *kp, *vp;
  const float *ksp, *vsp;
  const int *bt, *kv_len;
  void* out;
  int batch, kv, g, d, n_pool, page, n_bt, ppc;
};

template <typename T, typename P, int VEC, bool QUANT>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  const int rows = a.ppc * a.page;
  const size_t smem = float_region(a.g, a.d, rows, QUANT) +
                      align16((size_t)rows * (a.d + k_pad(VEC)) * sizeof(P)) +
                      (size_t)rows * a.d * sizeof(P);
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<T, P, VEC, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return attr;
  paged_decode_kernel<T, P, VEC, QUANT>
      <<<dim3(a.batch, a.kv), kThreads, smem, stream>>>(
          static_cast<const T*>(a.q), static_cast<const P*>(a.kp),
          static_cast<const P*>(a.vp), a.ksp, a.vsp, a.bt, a.kv_len,
          static_cast<T*>(a.out), a.kv, a.g, a.d, a.n_pool, a.page, a.n_bt,
          a.ppc);
  return cudaGetLastError();
}

// 16-byte vector loads of the pools where the head dim allows.
template <typename T, typename P, bool QUANT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(P);
  if (a.d % kVec == 0) return launch_t<T, P, kVec, QUANT>(a, stream);
  return launch_t<T, P, 1, QUANT>(a, stream);
}

template <typename T>
cudaError_t launch_pools(const Args& a, bool quantized, cudaStream_t stream) {
  if (quantized) return launch<T, int8_t, true>(a, stream);
  return launch<T, T, false>(a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32 (q and the output; the pools too unless
// quantized).  quantized: 1 = int8 pools with f32 scale pools k_scales and
// v_scales (P, page, KV); 0 = float pools (the scale pointers are unused).
// ppc is the number of whole pages a block stages per step.  Returns the
// CUDA error of the launch (0 on success).
int paged_attention_launch(int dtype, int quantized, const void* q,
                           const void* k_pages, const void* v_pages,
                           const void* k_scales, const void* v_scales,
                           const void* block_tables, const void* kv_len,
                           void* out, int batch, int kv, int g, int d,
                           int n_pool, int page, int n_bt, int ppc,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || kv < 1 || g < 1 || d < 1 || page < 1 || ppc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (quantized && (k_scales == nullptr || v_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k_pages,
               v_pages,
               static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(kv_len),
               out,
               batch, kv, g, d, n_pool, page, n_bt, ppc};
  if (dtype == 0)
    return static_cast<int>(launch_pools<__nv_bfloat16>(a, quantized != 0, s));
  if (dtype == 1)
    return static_cast<int>(launch_pools<float>(a, quantized != 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
