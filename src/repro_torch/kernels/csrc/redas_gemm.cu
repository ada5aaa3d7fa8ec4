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

#include "gemm_tile.cuh"

namespace {

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
  os_block<T, BM, BN, BK>(A, B, O, M, N, K, blockIdx.y * BM, blockIdx.x * BN,
                          smem);
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
