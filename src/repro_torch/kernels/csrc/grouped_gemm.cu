// Grouped (per-expert) GEMM for Hopper (sm_90a): y[e] = x[e] @ w[e] for
// x (E, C, D), w (E, D, F) -> y (E, C, F), f32 accumulation, bf16 and f32
// operands, y written in bf16 or f32 from the f32 accumulator.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/grouped_gemm.py:
//   grouped_matmul (:73), kernel body _kernel (:35)  -> grouped_wgmma_kernel
//                              (bf16 whose operands TMA can describe),
//                              grouped_os_kernel (everything else)
//
// The TPU kernel runs the grid (E, C/bc, F/bf, D/bd) in order on one core
// and carries an f32 accumulator in VMEM across the D steps.  Here the
// blocks run in parallel and in no order, so the D sweep is a loop inside
// the block: one block per (expert, C tile, F tile), the expert on
// blockIdx.z, the f32 accumulator in registers for the whole sweep, each
// output element written once (OS).  Nothing carries between blocks.
//
// Two routes, chosen by the wrapper before the launch from the operands
// alone (kernels/grouped_gemm.py grouped_route):
//   wgmma  bf16 with D % 8 == 0, F % 8 == 0 and 16-byte-aligned bases: the
//          ReDas GEMM's warp-specialised TMA/wgmma ring (wgmma_os_tile in
//          hopper.cuh) over one expert's (C, D) @ (D, F).  x is read through
//          a rank-3 (E, C, D) tensor map in (1, BM, 64) boxes (K-major), w
//          through a rank-3 (E, D, F) map in (1, 64, 64) boxes (read
//          MN-major), both at the block's expert.  TMA zero-fills each
//          dimension on its own, so a box past C, D or F arrives as zeros
//          and never reads the next expert's rows (a rank-2 map over
//          (E x C, D) would, at a ragged C or D, and would turn another
//          expert's Inf into NaN here).  The weight's map is encoded once
//          per (base, shape) and kept; x's is encoded each call.
//   sync   f32, and bf16 that TMA cannot describe: the ReDas GEMM's sync OS
//          tile (gemm_tile.cuh), each (BM, BK) and (BK, BN) chunk loaded
//          synchronously into padded shared memory, WMMA 16x16x16 (bf16) or
//          FFMA (f32) on it.
// Ragged C, D and F are masked inside the kernels (on the wgmma route by
// TMA's zero fill and the masked epilogue): nothing is padded in the
// wrapper.  The capacity padding's zero rows are multiplied like any other
// row, as the TPU kernel does.
//
// What bounds it on an H100, by regime:
//   decode (8 slots, C = 32 rows per expert): the bytes.  Every call reads
//     all 32 experts' weights although each token picks 8: (32, 32, 1024)
//     @ (32, 1024, 512) in bf16 moves 33.6 MB of weight, about 0.010 ms at
//     3.35 TB/s, and a decode tick makes 72 such calls (3 per layer).  A
//     64-row tile covers the 32 rows (TMA zero-fills rows 32-63 without
//     fetching them), so each weight byte is read once; the grid E x
//     ceil(F / BN) puts 128-512 blocks on the 132 SMs, and each keeps its
//     expert's (D, BN) weight panel streaming through all ring stages, so
//     the loads in flight, not one synchronous chunk at a time, set the
//     rate.  (Taking F as the wgmma's M and the 32 rows as its N is not
//     done: the weight bytes bound both.)
//   prefill (C = 160-1920): the operations, 2 E C D F at 989 TFLOP/s; the
//     ring's 128-row tiles with two consumer warpgroups keep the tensor
//     cores fed from swizzled shared memory while TMA loads the next
//     stages.  What it leaves is what row 1 leaves: one block per output
//     tile, so the ring's fill and each tile's epilogue are not hidden.
// Empty experts are not skipped (the signature carries no fill counts).
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry points are at the end of this file.

#include <string.h>

#include <mutex>
#include <unordered_map>

#include "gemm_tile.cuh"
#include "hopper.cuh"

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

// One (BM, BN) tile of expert blockIdx.z's y = x @ w on the ring: BM / 64
// consumer warpgroups, then one producer warp.
template <int BM, int BN, typename OT>
__global__ void __launch_bounds__(2 * BM + 32, 1)
    grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tmX,
                         const __grid_constant__ CUtensorMap tmW,
                         OT* __restrict__ Y, int C, int D, int F) {
  const int e = blockIdx.z;
  wgmma_os_tile<BM, BN, 3>(&tmX, &tmW, e, Y + size_t(e) * C * F, C, F, D,
                           blockIdx.y * BM, blockIdx.x * BN);
}

// The weight's tensor map, kept per (base, E, D, F) once encoded: a map
// depends on nothing else, so a kept one is always right, and a decode
// tick's calls, which reuse the same weights, encode only x's map.  The
// table is emptied when it reaches kMapsKept entries.
struct MapKey {
  uintptr_t ptr;
  int e, d, f;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && e == o.e && d == o.d && f == o.f;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<uintptr_t>()(k.ptr);
    for (const int v : {k.e, k.d, k.f}) h = h * 1000003u ^ size_t(v);
    return h;
  }
};
struct KeptMap {
  uint64_t words[16];
};
static_assert(sizeof(CUtensorMap) == sizeof(KeptMap), "a tensor map is 128 B");
constexpr size_t kMapsKept = 4096;

bool weight_map(CUtensorMap* map, const void* w, int E, int D, int F) {
  static std::mutex lock;
  static std::unordered_map<MapKey, KeptMap, MapKeyHash> kept;
  const MapKey key{reinterpret_cast<uintptr_t>(w), E, D, F};
  std::lock_guard<std::mutex> guard(lock);
  const auto it = kept.find(key);
  if (it != kept.end()) {
    memcpy(map, &it->second, sizeof(KeptMap));
    return true;
  }
  if (!encode_bf16_map_3d(map, w, E, D, F, 64)) return false;
  if (kept.size() >= kMapsKept) kept.clear();
  KeptMap copy;
  memcpy(&copy, map, sizeof(KeptMap));
  kept.emplace(key, copy);
  return true;
}

// A launch the operands' strides or bases do not allow is refused with
// cudaErrorInvalidValue.
template <int BM, int BN, typename OT>
cudaError_t launch_wgmma(const void* x, const void* w, void* y, int E, int C,
                         int D, int F, cudaStream_t stream) {
  if (D % 8 || F % 8 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15))
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!encode_bf16_map_3d(&tx, x, E, C, D, BM) ||
      !weight_map(&tw, w, E, D, F))
    return cudaErrorInvalidValue;
  constexpr size_t smem = WgSmem<BM, BN>::bytes;
  auto kernel = grouped_wgmma_kernel<BM, BN, OT>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  kernel<<<grid, 2 * BM + 32, smem, stream>>>(tx, tw, static_cast<OT*>(y), C,
                                               D, F);
  return cudaGetLastError();
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

// The sync route's tile menu (BM, BK, BN) = (C rows, D chunk, F columns),
// compiled for both dtypes.  TILES in repro_torch/kernels/grouped_gemm.py is
// the same list (a test reads this macro to hold the two together).
#define GROUPED_TILES(X) \
  X(16, 64, 64)          \
  X(32, 64, 64)          \
  X(64, 32, 64)          \
  X(64, 64, 128)         \
  X(128, 32, 128)        \
  X(64, 256, 64)

// The wgmma route's tile menu (BM, BK, BN): BM one or two consumer
// warpgroups, BK the ring stage's depth, BN one wgmma's width (the ReDas
// GEMM's wgmma menu); compiled for both output dtypes.  WGMMA_TILES in
// repro_torch/kernels/grouped_gemm.py is the same list.
#define GROUPED_WGMMA_TILES(X) \
  X(64, 64, 64)                \
  X(64, 64, 128)               \
  X(128, 64, 64)               \
  X(128, 64, 128)              \
  X(128, 64, 256)

extern "C" {

// The sync route: dtype (x and w) and out_dtype (y): 0 = bf16, 1 = f32.
// x (E, C, D), w (E, D, F) and y (E, C, F) are contiguous.  Returns the
// CUDA error of the launch (0 on success), or -1 for a tile that is not on
// the sync menu.
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

// The wgmma route: bf16 x (E, C, D) and w (E, D, F), contiguous, with
// D % 8 == 0, F % 8 == 0 and 16-byte-aligned bases; out_dtype 0 = bf16,
// 1 = f32.  Returns the CUDA error of the launch, cudaErrorInvalidValue for
// operands TMA cannot describe, or -1 for a tile that is not on the wgmma
// menu.
int grouped_wgmma_launch(int out_dtype, int bm, int bk, int bn, const void* x,
                         const void* w, void* y, int E, int C, int D, int F,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WGMMA_DISPATCH(BM, BK, BN)                                           \
  if (bm == BM && bk == BK && bn == BN)                                      \
    return static_cast<int>(                                                 \
        out_dtype == 0                                                       \
            ? launch_wgmma<BM, BN, __nv_bfloat16>(x, w, y, E, C, D, F, s)    \
            : launch_wgmma<BM, BN, float>(x, w, y, E, C, D, F, s));
  GROUPED_WGMMA_TILES(WGMMA_DISPATCH)
#undef WGMMA_DISPATCH
  return -1;
}

}  // extern "C"
