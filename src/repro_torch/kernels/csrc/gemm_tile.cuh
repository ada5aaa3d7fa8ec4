// The OS tile code that the ReDas GEMM (redas_gemm.cu) and the grouped GEMM
// (grouped_gemm.cu) share: a 128-thread block computes one (BM, BN) output
// tile of a row-major (M, K) @ (K, N) product, sweeping K in chunks of BK
// through shared memory with an f32 accumulator, and writes each output
// element once, in its own output type (bf16 or f32, whatever the operands'
// type).  bf16 runs on the tensor cores (WMMA 16x16x16, f32 accumulate), f32
// on FFMA (no TF32).  Ragged M, K and N are masked here: out-of-range
// operands read as zero, out-of-range outputs are not written.  The ReDas
// GEMM's main OS route at bf16 is its wgmma kernel (redas_gemm.cu); this
// tile serves f32 and the shapes TMA cannot describe.
// The streaming dataflows of redas_gemm.cu reuse TileMath through `mma_ld`,
// which takes the operands' leading dimensions (a sub-chunk of a slab).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;  // shared-memory row padding, in elements

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared-memory layout of one block: the (BM, BK) input tile, the (BK, BN)
// weight tile (rows padded by kPad), and one 16x16 f32 staging tile per warp
// for the tensor-core epilogue.  redas_gemm.smem_bytes mirrors this.
template <typename T, int BM, int BN, int BK>
struct Smem {
  static constexpr size_t a = size_t(BM) * (BK + kPad) * sizeof(T);
  static constexpr size_t b = size_t(BK) * (BN + kPad) * sizeof(T);
  static constexpr size_t bytes = a + b + size_t(kWarps) * 256 * sizeof(float);
};

// Copy the (ROWS, COLS) tile at (r0, c0) of a row-major (n_rows, n_cols)
// matrix into shared memory (row stride COLS + kPad).  Elements outside the
// matrix read as zero, so a ragged edge adds nothing to the sums.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int n_rows, int n_cols, int r0,
                                          int c0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = COLS + kPad;
  constexpr int VPR = COLS / VEC;
  static_assert(COLS % VEC == 0, "tile width must hold whole 16-byte vectors");
  const bool vec_ok = (n_cols % VEC == 0) &&
                      ((reinterpret_cast<uintptr_t>(src) & 15) == 0);
  const T zero = from_float<T>(0.f);
  for (int v = threadIdx.x; v < ROWS * VPR; v += kThreads) {
    const int r = v / VPR, c = (v % VPR) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * LD + c;
    const T* s = src + size_t(gr) * n_cols + gc;
    if (vec_ok && gr < n_rows && gc + VEC <= n_cols) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        d[e] = (gr < n_rows && gc + e < n_cols) ? s[e] : zero;
    }
  }
}

// The block's share of one (BM, BK) @ (BK, BN) product, accumulated in f32.
// `epilogue` hands every accumulated element to `emit(row, col, value)`; the
// element-to-thread map is fixed, so a streaming dataflow's partial sum of an
// element is always read and written by the same thread.
template <typename T, int BM, int BN, int BK>
struct TileMath;

// bf16: WMMA on the tensor cores; 4 warps laid out WM x WN.
template <int BM, int BN, int BK>
struct TileMath<__nv_bfloat16, BM, BN, BK> {
  static constexpr int WM = BM >= 32 ? 2 : 1;
  static constexpr int WN = kWarps / WM;
  static constexpr int FM = BM / WM / 16;
  static constexpr int FN = BN / WN / 16;
  static_assert(FM >= 1 && FN >= 1 && BM % (16 * WM) == 0 &&
                    BN % (16 * WN) == 0 && BK % 16 == 0,
                "tile does not fit the 4-warp WMMA layout");
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[FM][FN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ __forceinline__ void mma(const __nv_bfloat16* As,
                                      const __nv_bfloat16* Bs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wr = (warp / WN) * FM * 16, wc = (warp % WN) * FN * 16;
#pragma unroll
    for (int k = 0; k < BK; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wr + i * 16) * (BK + kPad) + k,
                               BK + kPad);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + k * (BN + kPad) + wc + j * 16,
                               BN + kPad);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // `mma` on operands of leading dimensions LDA and LDB (in elements): a
  // K sub-chunk of a deeper shared-memory slab (the streaming dataflows).
  template <int LDA, int LDB>
  __device__ __forceinline__ void mma_ld(const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wr = (warp / WN) * FM * 16, wc = (warp % WN) * FN * 16;
#pragma unroll
    for (int k = 0; k < BK; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wr + i * 16) * LDA + k, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + k * LDB + wc + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  template <typename F>
  __device__ __forceinline__ void epilogue(float* scratch, F&& emit) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wr = (warp / WN) * FM * 16, wc = (warp % WN) * FN * 16;
    float* mine = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        nvcuda::wmma::store_matrix_sync(mine, acc[i][j], 16,
                                        nvcuda::wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          emit(wr + i * 16 + e / 16, wc + j * 16 + e % 16, mine[e]);
        __syncwarp();
      }
  }
};

// f32: FFMA on an 8 x 16 thread grid, each thread an (BM/8) x (BN/16)
// strided micro-tile in registers.
template <int BM, int BN, int BK>
struct TileMath<float, BM, BN, BK> {
  static constexpr int TM = 8, TN = 16;
  static constexpr int RM = BM / TM, RN = BN / TN;
  static_assert(TM * TN == kThreads && BM % TM == 0 && BN % TN == 0,
                "tile does not fit the 8 x 16 FFMA layout");
  float acc[RM][RN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* As, const float* Bs) {
    const int ty = threadIdx.x / TN, tx = threadIdx.x % TN;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[(ty + i * TM) * (BK + kPad) + k];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = Bs[k * (BN + kPad) + tx + j * TN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // `mma` on operands of leading dimensions LDA and LDB (in elements).
  template <int LDA, int LDB>
  __device__ __forceinline__ void mma_ld(const float* As, const float* Bs) {
    const int ty = threadIdx.x / TN, tx = threadIdx.x % TN;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[(ty + i * TM) * LDA + k];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = Bs[k * LDB + tx + j * TN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  template <typename F>
  __device__ __forceinline__ void epilogue(float*, F&& emit) {
    const int ty = threadIdx.x / TN, tx = threadIdx.x % TN;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) emit(ty + i * TM, tx + j * TN, acc[i][j]);
  }
};

template <typename T, int BM, int BN, int BK>
struct Views {
  T* As;
  T* Bs;
  float* scratch;
  __device__ __forceinline__ explicit Views(unsigned char* smem)
      : As(reinterpret_cast<T*>(smem)),
        Bs(reinterpret_cast<T*>(smem + Smem<T, BM, BN, BK>::a)),
        scratch(reinterpret_cast<float*>(smem + Smem<T, BM, BN, BK>::a +
                                         Smem<T, BM, BN, BK>::b)) {}
};

// One OS output tile: rows [m0, m0 + BM) and columns [n0, n0 + BN) of
// O = A @ B, with the K loop inside the block and the f32 accumulator in
// registers, written as OT; `smem` holds Smem<T, BM, BN, BK>::bytes.
template <typename T, typename OT, int BM, int BN, int BK>
__device__ __forceinline__ void os_block(const T* __restrict__ A,
                                         const T* __restrict__ B,
                                         OT* __restrict__ O, int M, int N,
                                         int K, int m0, int n0,
                                         unsigned char* smem) {
  Views<T, BM, BN, BK> s(smem);
  TileMath<T, BM, BN, BK> tm;
  tm.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK>(s.As, A, M, K, m0, k0);
    load_tile<T, BK, BN>(s.Bs, B, K, N, k0, n0);
    __syncthreads();
    tm.mma(s.As, s.Bs);
    __syncthreads();
  }
  tm.epilogue(s.scratch, [&](int r, int c, float v) {
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) O[size_t(gr) * N + gc] = from_float<OT>(v);
  });
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
