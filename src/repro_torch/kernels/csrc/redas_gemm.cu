// ReDas GEMM for Hopper (sm_90a): out = A @ B with f32 accumulation, in the
// three dataflows of the ReDas paper, for bf16 and f32 operands.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/redas_gemm.py:
//   _os_kernel        (:108)  -> os_kernel
//   _streaming_kernel (:126)  -> ws_kernel / is_kernel
//
// The dataflow is which operand stays resident in shared memory:
//   OS  grid (n-tiles, m-tiles).  The K loop runs inside the block with the
//       f32 accumulator in registers; each output tile is written once.
//   WS  grid (n-tiles, groups of m-tiles).  Per K chunk the block loads its
//       (BK, BN) weight tile once and keeps it resident while it sweeps its
//       m-tiles.  Partial sums stream through an f32 buffer that only this
//       block touches, and the K chunks run in order, so the result is
//       deterministic without atomics (the counterpart of the TPU kernel's
//       input/output-aliased accumulator).
//   IS  the mirror of WS: the (BM, BK) input tile is resident while the
//       block sweeps its n-tiles.
// Ragged M, K and N are masked inside the kernel (out-of-range operands read
// as zero, out-of-range outputs are not written), so no padded copies exist.
//
// What bounds it on an H100: at prefill widths (M = 2048) the products are
// bound by operations (arithmetic intensity far above the card's ~295 FLOP
// per byte in bf16); at decode widths (M = 4) by the bytes of the weight
// stream.  The design answers the first with tensor cores for bf16 (WMMA
// 16x16x16, f32 accumulate) and a CTA tile that reuses each loaded operand
// across BM x BN outputs, and the second with 16-byte vector loads and a
// 16-row tile so that the weights are read once per call.  f32 stays true
// f32 (FFMA, no TF32).  There is no cp.async/TMA pipelining, wgmma or warp
// specialisation yet: loads and math do not overlap, which is what keeps
// the kernel well short of both bounds.
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry points are at the end of this file.

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

// One step of a streaming dataflow for one element: add this K chunk's
// contribution to the element's running f32 sum, and write the output at the
// last chunk.
template <typename T>
__device__ __forceinline__ void stream_out(T* O, float* P, size_t idx, float v,
                                           bool first, bool last) {
  const float p = first ? v : P[idx] + v;
  if (last)
    O[idx] = from_float<T>(p);
  else
    P[idx] = p;
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    os_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ O, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  Views<T, BM, BN, BK> s(smem);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
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
    if (gr < M && gc < N) O[size_t(gr) * N + gc] = from_float<T>(v);
  });
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    ws_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ O, float* __restrict__ P, int M, int N, int K,
              int tiles_per_group) {
  extern __shared__ __align__(128) unsigned char smem[];
  Views<T, BM, BN, BK> s(smem);
  const int n0 = blockIdx.x * BN;
  const int gm = (M + BM - 1) / BM;
  const int i0 = blockIdx.y * tiles_per_group;
  const int i1 = min(gm, i0 + tiles_per_group);
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool first = k0 == 0, last = k0 + BK >= K;
    load_tile<T, BK, BN>(s.Bs, B, K, N, k0, n0);  // resident for the sweep
    for (int i = i0; i < i1; ++i) {
      const int m0 = i * BM;
      load_tile<T, BM, BK>(s.As, A, M, K, m0, k0);
      __syncthreads();
      TileMath<T, BM, BN, BK> tm;
      tm.zero();
      tm.mma(s.As, s.Bs);
      __syncthreads();
      tm.epilogue(s.scratch, [&](int r, int c, float v) {
        const int gr = m0 + r, gc = n0 + c;
        if (gr < M && gc < N)
          stream_out(O, P, size_t(gr) * N + gc, v, first, last);
      });
    }
  }
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    is_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ O, float* __restrict__ P, int M, int N, int K,
              int tiles_per_group) {
  extern __shared__ __align__(128) unsigned char smem[];
  Views<T, BM, BN, BK> s(smem);
  const int m0 = blockIdx.x * BM;
  const int gn = (N + BN - 1) / BN;
  const int j0 = blockIdx.y * tiles_per_group;
  const int j1 = min(gn, j0 + tiles_per_group);
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool first = k0 == 0, last = k0 + BK >= K;
    load_tile<T, BM, BK>(s.As, A, M, K, m0, k0);  // resident for the sweep
    for (int j = j0; j < j1; ++j) {
      const int n0 = j * BN;
      load_tile<T, BK, BN>(s.Bs, B, K, N, k0, n0);
      __syncthreads();
      TileMath<T, BM, BN, BK> tm;
      tm.zero();
      tm.mma(s.As, s.Bs);
      __syncthreads();
      tm.epilogue(s.scratch, [&](int r, int c, float v) {
        const int gr = m0 + r, gc = n0 + c;
        if (gr < M && gc < N)
          stream_out(O, P, size_t(gr) * N + gc, v, first, last);
      });
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int BM, int BK, int BN>
cudaError_t launch(int dataflow, const void* a, const void* b, void* o,
                   void* p, int M, int N, int K, int groups,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<T, BM, BN, BK>::bytes;
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* O = static_cast<T*>(o);
  float* P = static_cast<float*>(p);
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  if (groups < 1) groups = 1;
  if (dataflow == 0) {
    static const cudaError_t attr = allow_smem(os_kernel<T, BM, BN, BK>, smem);
    if (attr != cudaSuccess) return attr;
    os_kernel<T, BM, BN, BK>
        <<<dim3(gn, gm), kThreads, smem, stream>>>(A, B, O, M, N, K);
  } else if (dataflow == 1) {
    static const cudaError_t attr = allow_smem(ws_kernel<T, BM, BN, BK>, smem);
    if (attr != cudaSuccess) return attr;
    const int per = (gm + groups - 1) / groups;
    ws_kernel<T, BM, BN, BK><<<dim3(gn, (gm + per - 1) / per), kThreads, smem,
                               stream>>>(A, B, O, P, M, N, K, per);
  } else if (dataflow == 2) {
    static const cudaError_t attr = allow_smem(is_kernel<T, BM, BN, BK>, smem);
    if (attr != cudaSuccess) return attr;
    const int per = (gn + groups - 1) / groups;
    is_kernel<T, BM, BN, BK><<<dim3(gm, (gn + per - 1) / per), kThreads, smem,
                               stream>>>(A, B, O, P, M, N, K, per);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The tile menu (BM, BK, BN), compiled for every dataflow and both dtypes.
// TILES in repro_torch/kernels/redas_gemm.py is the same list (a test reads
// this macro to hold the two together).
#define REDAS_TILES(X) \
  X(16, 64, 64)        \
  X(32, 64, 64)        \
  X(64, 32, 64)        \
  X(64, 64, 128)       \
  X(128, 32, 128)      \
  X(64, 256, 64)

extern "C" {

// dataflow: 0 = OS, 1 = WS, 2 = IS.  dtype: 0 = bf16, 1 = f32 (A, B and the
// output share it).  `p` is an (M, N) f32 scratch for the streaming
// dataflows' partial sums, unused by OS and when K fits one chunk.  `groups`
// splits the WS m-tiles (IS n-tiles) among that many blocks per column (row).
// Returns the CUDA error of the launch (0 on success), or -1 for a tile that
// is not on the menu.
int redas_gemm_launch(int dataflow, int dtype, int bm, int bk, int bn,
                      const void* a, const void* b, void* o, void* p, int M,
                      int N, int K, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REDAS_DISPATCH(BM, BK, BN)                                          \
  if (bm == BM && bk == BK && bn == BN)                                     \
    return static_cast<int>(                                                \
        dtype == 0 ? launch<__nv_bfloat16, BM, BK, BN>(dataflow, a, b, o, p, \
                                                       M, N, K, groups, s)  \
                   : launch<float, BM, BK, BN>(dataflow, a, b, o, p, M, N,  \
                                               K, groups, s));
  REDAS_TILES(REDAS_DISPATCH)
#undef REDAS_DISPATCH
  return -1;
}

}  // extern "C"
