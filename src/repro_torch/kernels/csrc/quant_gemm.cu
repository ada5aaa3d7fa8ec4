// Int8 GEMM for Hopper (sm_90a): C = A @ B for A (M, K) int8 and B (K, N)
// int8, both row-major, C (M, N) int32.  Exact integer arithmetic.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/quant_gemm.py:
//   gemm_int8 (:124, pallas_call :148), kernel body _int8_os_kernel (:110)
//   -> quant_os_kernel
//
// The TPU kernel runs the grid (M/bm, N/bn, K/bk) in order on one core and
// carries an int32 accumulator in VMEM across the K steps (OS: a streaming
// dataflow would push int32 partial sums, four times the int8 operand
// bytes, through HBM).  Here blocks run in parallel and in no order, so the
// K sweep is a loop inside the block: one block per (BM, BN) output tile,
// the int32 accumulator in WMMA fragments (registers) for the whole sweep,
// each output element written once.  Nothing carries between blocks.
//
// Tensor cores: nvcuda::wmma at m16n16k16 with signed char operands and an
// int accumulator; 4 warps laid out WM x WN as in the ReDas GEMM's OS tile
// (gemm_tile.cuh).  Both operands stay row-major as the reference stores
// them (w_q is (K, N)), so there is no transpose.  Shared memory holds each
// tile as 16-byte slabs: A as [BK/16][BM][16] (the 16 k of one row), B as
// [BN/16][BK][16] (the 16 n of one k row).  A 16 x 16 fragment is then 256
// contiguous bytes at a 256-byte-aligned address with ldm = 16 bytes,
// whatever the tile.
//
// Ragged M, K and N are masked here: out-of-range operands read as zero
// (exact for integer sums), out-of-range outputs are not written.  A
// 16-byte vector load is used where a whole slab row lies inside the matrix
// and the row is 16-byte aligned (K % 16 == 0 for A, N % 16 == 0 for B),
// byte loads elsewhere.
//
// What bounds it on an H100: at decode (M = 4 or 8) the bytes, the int8
// weight read once (1536 x 8960 is 13.8 MB, about 4.1 us at 3.35 TB/s);
// the tile menu leaves M = 8 one 16-row tile, so each weight byte is read
// once, but a serial K loop per block and N / BN blocks (12 to 140) leave
// most SMs idle.  At prefill (M = 2048) the operations: 2048 x 1536 x 8960
// is 56 GOP, 28 us at the 1979 TOP/s dense int8 peak.  There is no
// pipelining of the K loop, no wgmma (s8 wgmma wants a K-major B) and no
// TMA yet.  The result is int32; the rescale to float stays in the wrapper.
//
// Built by repro_torch/kernels/_build.py with plain nvcc (no fast math) and
// loaded through ctypes; the C entry point is at the end of this file.

#include "gemm_tile.cuh"

namespace {

constexpr int kSlab = 16;  // bytes of one slab row: 16 int8

template <int BM, int BN, int BK>
struct QSmem {
  static constexpr size_t a = size_t(BM) * BK;
  static constexpr size_t b = size_t(BK) * BN;
  static constexpr size_t bytes = a + b + size_t(kWarps) * 256 * sizeof(int);
};

// Copy the (ROWS, COLS) int8 tile at (r0, c0) of a row-major (n_rows,
// n_cols) matrix into shared memory as [COLS/16][ROWS][16] slabs.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_slabs(signed char* __restrict__ dst,
                                           const signed char* __restrict__ src,
                                           int n_rows, int n_cols, int r0,
                                           int c0) {
  constexpr int SPR = COLS / kSlab;  // slabs a row
  static_assert(COLS % kSlab == 0, "tile width must hold whole slabs");
  const bool vec_ok = (n_cols % kSlab == 0) &&
                      ((reinterpret_cast<uintptr_t>(src) & 15) == 0);
  for (int v = threadIdx.x; v < ROWS * SPR; v += kThreads) {
    const int r = v / SPR, s = v % SPR;
    const int gr = r0 + r, gc = c0 + s * kSlab;
    signed char* d = dst + (size_t(s) * ROWS + r) * kSlab;
    const signed char* p = src + size_t(gr) * n_cols + gc;
    if (vec_ok && gr < n_rows && gc + kSlab <= n_cols) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int e = 0; e < kSlab; ++e)
        d[e] = (gr < n_rows && gc + e < n_cols) ? p[e] : 0;
    }
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    quant_os_kernel(const signed char* __restrict__ A,
                    const signed char* __restrict__ B, int* __restrict__ C,
                    int M, int N, int K) {
  using namespace nvcuda;
  constexpr int WM = BM >= 32 ? 2 : 1;
  constexpr int WN = kWarps / WM;
  constexpr int FM = BM / WM / 16;
  constexpr int FN = BN / WN / 16;
  static_assert(FM >= 1 && FN >= 1 && BM % (16 * WM) == 0 &&
                    BN % (16 * WN) == 0 && BK % 16 == 0,
                "tile does not fit the 4-warp WMMA layout");
  extern __shared__ __align__(256) unsigned char smem[];
  signed char* As = reinterpret_cast<signed char*>(smem);
  signed char* Bs = reinterpret_cast<signed char*>(smem + QSmem<BM, BN, BK>::a);
  int* scratch =
      reinterpret_cast<int*>(smem + QSmem<BM, BN, BK>::a + QSmem<BM, BN, BK>::b);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / WN) * FM * 16, wc = (warp % WN) * FN * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_slabs<BM, BK>(As, A, M, K, m0, k0);
    load_slabs<BK, BN>(Bs, B, K, N, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>
          b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            a[i], As + (size_t(kk) * BM + wr + i * 16) * kSlab, kSlab);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            b[j], Bs + (size_t((wc + j * 16) / 16) * BK + kk * 16) * kSlab,
            kSlab);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: each warp stages one 16 x 16 int32 fragment at a time and
  // writes its in-range elements (each output element once).
  int* mine = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(mine, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = m0 + wr + i * 16 + e / 16;
        const int gc = n0 + wc + j * 16 + e % 16;
        if (gr < M && gc < N) C[size_t(gr) * N + gc] = mine[e];
      }
      __syncwarp();
    }
}

template <int BM, int BK, int BN>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t stream) {
  constexpr size_t smem = QSmem<BM, BN, BK>::bytes;
  static const cudaError_t attr =
      allow_smem(quant_os_kernel<BM, BN, BK>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_os_kernel<BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const signed char*>(a), static_cast<const signed char*>(b),
      static_cast<int*>(c), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// The tile menu (BM, BK, BN).  TILES in repro_torch/kernels/quant_gemm.py is
// the same list (a test reads this macro to hold the two together).
#define QUANT_TILES(X) \
  X(16, 128, 64)       \
  X(16, 256, 64)       \
  X(32, 128, 128)      \
  X(64, 128, 128)      \
  X(128, 64, 128)      \
  X(128, 128, 128)

extern "C" {

// a (M, K) int8, b (K, N) int8 and c (M, N) int32 are contiguous
// row-major.  Returns the CUDA error of the launch (0 on success), or -1
// for a tile that is not on the menu.
int quant_gemm_launch(int bm, int bk, int bn, const void* a, const void* b,
                      void* c, int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QUANT_DISPATCH(BM, BK, BN)    \
  if (bm == BM && bk == BK && bn == BN) \
    return static_cast<int>(launch<BM, BK, BN>(a, b, c, M, N, K, s));
  QUANT_TILES(QUANT_DISPATCH)
#undef QUANT_DISPATCH
  return -1;
}

}  // extern "C"
