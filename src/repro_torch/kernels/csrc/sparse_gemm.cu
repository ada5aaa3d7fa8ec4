// N:M structured-sparse GEMM for Hopper (sm_90a): O = A @ W for A (M, K)
// row-major and W held compressed: `values` (Kc, N) the kept values of each
// group of m_group consecutive K rows of a column, `indices` (Kc, N) int8
// their in-group offsets, Kc = ceil(K / m_group) * n_keep.  f32 accumulation;
// bf16 operands on the tensor cores (WMMA 16x16x16), f32 on FFMA (no TF32).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/sparse_gemm.py:
//   gemm_sparse (:135, pallas_call :163), body _sparse_os_kernel (:116),
//   scatter _scatter_dense (:97)  -> sparse_os_kernel
//
// The TPU kernel walks the grid (M/bm, N/bn, K/bk) in order on one core,
// scatters each compressed block back to a dense (bk, bn) VMEM tile and
// runs a dense dot on it into a VMEM accumulator (OS).  Here blocks run in
// parallel and in no order, so the K sweep is a loop inside the block: one
// block per (BM, BN) output tile, the f32 accumulator in registers for the
// whole sweep, each output element written once.  Per K chunk the block
//   1. stages the (BM, BK) activation tile and the chunk's compressed
//      values and int8 indices in shared memory;
//   2. scatters the kept values into a dense (BK, BN) shared tile;
//   3. multiplies densely (the OS tile code of gemm_tile.cuh).
//
// The scatter is the reference's one-hot sum,
//   w[g*m + off, c] = sum_j values[g*n + j, c] * [indices[g*n + j, c] == off],
// for ANY int8 index array: an offset outside 0..m-1 adds nothing, and two
// kept values at one offset add.  All kept values of one (group, column) are
// owned by one thread, which zeroes the group's m dense slots of that column
// and adds each value in order of j, so the scatter needs no atomics, is
// deterministic, and never writes outside the group's own rows.
//
// n_keep and m_group are runtime arguments: every spec 1 <= n < m <= 128
// runs.  A chunk is G = BK / m whole groups (G * m <= BK dense rows; every
// tile has BK = 128, so a chunk holds at least one group of the widest
// spec).  Where G * m < BK (m not a divisor of BK), the dense tile's last
// BK - G * m rows are zeroed once and the activation tile's matching
// columns read as zero, so the fixed 16-deep MMA steps add nothing there.
// Ragged M, K and N are masked here (out-of-range operands read as zero, an
// out-of-range index as "no value"; out-of-range outputs are not written):
// the zero padding of the reference's entry point without the copies.
//
// What bounds it on an H100: at decode (M = 4 or 8) the bytes of the
// compressed weights (values at their itemsize plus one index byte per kept
// value); at prefill (M = 2048) the operations, 2 M K N x density on the
// tensor cores.  This first design is simple: loads, scatter and MMA of one
// chunk do not overlap, the dense tile is rebuilt per block (each of the
// M / BM blocks of a column rebuilds it), and the MMA runs the dense K, not
// the kept K.  Hopper's 2:4 sparse tensor cores are a later fast path.
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry point is at the end of this file.

#include "gemm_tile.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rows of the compressed tiles staged per chunk: at most G * n < BK.
template <typename T, int BM, int BN, int BK>
struct SparseSmem {
  static constexpr size_t tiles = Smem<T, BM, BN, BK>::bytes;  // A, W, scratch
  static constexpr size_t values = size_t(BK) * (BN + kPad) * sizeof(T);
  static constexpr size_t indices = size_t(BK) * BN;
  static constexpr size_t bytes = tiles + values + indices;
};

// Copy rows [r0, r0 + rows) x columns [c0, c0 + COLS) of a row-major matrix
// with leading dimension `ld` into shared memory (row stride LDD).  Elements
// at or past (row_limit, col_limit) read as `fill`.  16-byte vector loads
// where the whole vector is in range and aligned, scalar loads elsewhere.
template <typename E, int COLS, int LDD>
__device__ __forceinline__ void load_rows(E* __restrict__ dst,
                                          const E* __restrict__ src, int ld,
                                          int r0, int rows, int row_limit,
                                          int c0, int col_limit, E fill) {
  constexpr int VEC = 16 / sizeof(E);
  constexpr int VPR = COLS / VEC;
  static_assert(COLS % VEC == 0, "tile width must hold whole 16-byte vectors");
  for (int v = threadIdx.x; v < rows * VPR; v += kThreads) {
    const int r = v / VPR, c = (v % VPR) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    E* d = dst + r * LDD + c;
    const E* s = src + size_t(gr) * ld + gc;
    if (gr < row_limit && gc + VEC <= col_limit &&
        (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        d[e] = (gr < row_limit && gc + e < col_limit) ? s[e] : fill;
    }
  }
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    sparse_os_kernel(const T* __restrict__ A, const T* __restrict__ V,
                     const signed char* __restrict__ I, void* __restrict__ O,
                     int out_f32, int M, int N, int K, int Kc, int n_keep,
                     int m_group) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDA = BK + kPad, LDW = BN + kPad, LDV = BN + kPad;
  Views<T, BM, BN, BK> s(smem);
  T* Vs = reinterpret_cast<T*>(smem + SparseSmem<T, BM, BN, BK>::tiles);
  signed char* Is = reinterpret_cast<signed char*>(
      smem + SparseSmem<T, BM, BN, BK>::tiles +
      SparseSmem<T, BM, BN, BK>::values);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int G = BK / m_group;          // whole groups per chunk
  const int chunk = G * m_group;       // dense rows per chunk (<= BK)
  const int rows_c = G * n_keep;       // compressed rows per chunk
  const int groups = Kc / n_keep;
  const T zero = from_float<T>(0.f);

  // the dense tile's rows past the chunk stay zero for the whole sweep
  for (int e = chunk * BN + threadIdx.x; e < BK * BN; e += kThreads)
    s.Bs[(e / BN) * LDW + e % BN] = zero;

  TileMath<T, BM, BN, BK> tm;
  tm.zero();
  for (int g0 = 0; g0 < groups; g0 += G) {
    const int k0 = g0 * m_group;
    load_rows<T, BK, LDA>(s.As, A, K, m0, BM, M, k0, min(K, k0 + chunk),
                          zero);
    load_rows<T, BN, LDV>(Vs, V, N, g0 * n_keep, rows_c, Kc, n0, N, zero);
    load_rows<signed char, BN, BN>(Is, I, N, g0 * n_keep, rows_c, Kc, n0, N,
                                   static_cast<signed char>(-1));
    __syncthreads();
    // scatter: one thread per (group, column) of the chunk
    for (int p = threadIdx.x; p < G * BN; p += kThreads) {
      const int g = p / BN, c = p % BN;
      T* col = s.Bs + g * m_group * LDW + c;
      for (int off = 0; off < m_group; ++off) col[off * LDW] = zero;
      for (int j = 0; j < n_keep; ++j) {
        const int r = g * n_keep + j;
        const int off = Is[r * BN + c];
        if (off >= 0 && off < m_group) {
          T* d = col + off * LDW;
          *d = from_float<T>(to_float(*d) + to_float(Vs[r * LDV + c]));
        }
      }
    }
    __syncthreads();
    tm.mma(s.As, s.Bs);
    __syncthreads();
  }
  tm.epilogue(s.scratch, [&](int r, int c, float v) {
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      const size_t idx = size_t(gr) * N + gc;
      if (out_f32)
        static_cast<float*>(O)[idx] = v;
      else
        static_cast<T*>(O)[idx] = from_float<T>(v);
    }
  });
}

template <typename T, int BM, int BK, int BN>
cudaError_t launch(const void* a, const void* v, const void* idx, void* o,
                   int out_f32, int M, int N, int K, int Kc, int n_keep,
                   int m_group, cudaStream_t stream) {
  constexpr size_t smem = SparseSmem<T, BM, BN, BK>::bytes;
  static const cudaError_t attr =
      allow_smem(sparse_os_kernel<T, BM, BN, BK>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  sparse_os_kernel<T, BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(v),
      static_cast<const signed char*>(idx), o, out_f32, M, N, K, Kc, n_keep,
      m_group);
  return cudaGetLastError();
}

}  // namespace

// The tile menu (BM, BK, BN), compiled for both dtypes.  TILES in
// repro_torch/kernels/sparse_gemm.py is the same list (a test reads this
// macro to hold the two together).
#define SPARSE_TILES(X) \
  X(16, 128, 64)        \
  X(32, 128, 128)       \
  X(64, 128, 128)       \
  X(128, 128, 128)

extern "C" {

// dtype: 0 = bf16, 1 = f32 (A and the values share it).  out_f32: 1 writes
// the f32 accumulator, 0 writes it rounded to the operand dtype.  Kc is the
// compressed row count, ceil(K / m_group) * n_keep.  Returns the CUDA error
// of the launch (0 on success), -1 for a tile that is not on the menu, or
// cudaErrorInvalidValue for an N:M spec or Kc the kernel cannot take.
int sparse_gemm_launch(int dtype, int bm, int bk, int bn, const void* a,
                       const void* values, const void* indices, void* o,
                       int out_f32, int M, int N, int K, int Kc, int n_keep,
                       int m_group, void* stream) {
  if (n_keep < 1 || m_group <= n_keep || m_group > bk || Kc % n_keep != 0 ||
      (long long)(Kc / n_keep) * m_group < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPARSE_DISPATCH(BM, BK, BN)                                         \
  if (bm == BM && bk == BK && bn == BN)                                     \
    return static_cast<int>(                                                \
        dtype == 0                                                          \
            ? launch<__nv_bfloat16, BM, BK, BN>(a, values, indices, o,      \
                                                out_f32, M, N, K, Kc,       \
                                                n_keep, m_group, s)         \
            : launch<float, BM, BK, BN>(a, values, indices, o, out_f32, M,  \
                                        N, K, Kc, n_keep, m_group, s));
  SPARSE_TILES(SPARSE_DISPATCH)
#undef SPARSE_DISPATCH
  return -1;
}

}  // extern "C"
