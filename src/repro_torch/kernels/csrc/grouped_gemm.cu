// Grouped (per-expert) GEMM for Hopper (sm_90a): y[e] = x[e] @ w[e] for
// x (E, C, D), w (E, D, F) -> y (E, C, F), f32 accumulation, bf16 and f32
// operands, y written in bf16 or f32 from the f32 accumulator.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/grouped_gemm.py:
//   grouped_matmul (:73), kernel body _kernel (:35)  -> grouped_os_kernel
//
// The TPU kernel runs the grid (E, C/bc, F/bf, D/bd) in order on one core
// and carries an f32 accumulator in VMEM across the D steps.  Here the
// blocks run in parallel and in no order, so the D sweep is a loop inside
// the block: one block per (expert, C tile, F tile), the expert on
// blockIdx.z, the f32 accumulator in registers for the whole sweep, each
// output element written once (OS).  Nothing carries between blocks.  The
// tile code is the ReDas GEMM's OS tile (gemm_tile.cuh), applied to each
// expert's (C, D) @ (D, F) problem.
//
// Ragged C, D and F are masked inside the kernel: nothing is padded in the
// wrapper (C is often no multiple of a tile, e.g. 8 x 20 = 160 rows per
// expert at a 64-token bucket).  The capacity padding's zero rows are
// multiplied like any other row, as the TPU kernel does.
//
// What bounds it on an H100: at decode (8 slots, C = 32 rows per expert) the
// bytes.  Every call reads all 32 experts' weights although each token picks
// 8: (32, 32, 1024) @ (32, 1024, 512) in bf16 moves 33.6 MB of weight, about
// 0.010 ms at 3.35 TB/s, and a decode tick makes 72 such calls (3 per layer).
// A C tile that covers all 32 rows reads each weight tile once.  At prefill
// (C = 1920 rows at a 768-token bucket) the operations bound it, and the
// tensor cores and a 64 x 128 tile answer that.  There is no pipelining,
// wgmma or TMA yet, and no skipping of the zero rows.
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry point is at the end of this file.

#include "gemm_tile.cuh"

namespace {

template <typename T, typename OT, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    grouped_os_kernel(const T* __restrict__ X, const T* __restrict__ W,
                      OT* __restrict__ Y, int C, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t e = blockIdx.z;
  os_block<T, OT, BM, BN, BK>(X + e * C * D, W + e * D * F, Y + e * C * F, C,
                              F, D, blockIdx.y * BM, blockIdx.x * BN, smem);
}

template <typename T, typename OT, int BM, int BK, int BN>
cudaError_t launch(const void* x, const void* w, void* y, int E, int C, int D,
                   int F, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, BM, BN, BK>::bytes;
  static const cudaError_t attr =
      allow_smem(grouped_os_kernel<T, OT, BM, BN, BK>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  grouped_os_kernel<T, OT, BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<OT*>(y),
      C, D, F);
  return cudaGetLastError();
}

template <int BM, int BK, int BN>
cudaError_t launch_typed(int dtype, int out_dtype, const void* x,
                         const void* w, void* y, int E, int C, int D, int F,
                         cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return out_dtype == 0
               ? launch<bf16, bf16, BM, BK, BN>(x, w, y, E, C, D, F, s)
               : launch<bf16, float, BM, BK, BN>(x, w, y, E, C, D, F, s);
  return out_dtype == 0
             ? launch<float, bf16, BM, BK, BN>(x, w, y, E, C, D, F, s)
             : launch<float, float, BM, BK, BN>(x, w, y, E, C, D, F, s);
}

}  // namespace

// The tile menu (BM, BK, BN) = (C rows, D chunk, F columns), compiled for
// both dtypes.  TILES in repro_torch/kernels/grouped_gemm.py is the same list
// (a test reads this macro to hold the two together).
#define GROUPED_TILES(X) \
  X(16, 64, 64)          \
  X(32, 64, 64)          \
  X(64, 32, 64)          \
  X(64, 64, 128)         \
  X(128, 32, 128)        \
  X(64, 256, 64)

extern "C" {

// dtype (x and w) and out_dtype (y): 0 = bf16, 1 = f32.  x (E, C, D),
// w (E, D, F) and y (E, C, F) are contiguous.  Returns the CUDA error of the
// launch (0 on success), or -1 for a tile that is not on the menu.
int grouped_gemm_launch(int dtype, int out_dtype, int bm, int bk, int bn,
                        const void* x, const void* w, void* y, int E, int C,
                        int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GROUPED_DISPATCH(BM, BK, BN)                                   \
  if (bm == BM && bk == BK && bn == BN)                                \
    return static_cast<int>(launch_typed<BM, BK, BN>(dtype, out_dtype, \
                                                     x, w, y, E, C, D, \
                                                     F, s));
  GROUPED_TILES(GROUPED_DISPATCH)
#undef GROUPED_DISPATCH
  return -1;
}

}  // extern "C"
