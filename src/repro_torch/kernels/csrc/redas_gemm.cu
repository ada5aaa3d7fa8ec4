// ReDas GEMM for Hopper (sm_90a): out = A @ B with f32 accumulation, in the
// three dataflows of the ReDas paper, for bf16 and f32 operands, the output
// written in bf16 or f32 from the f32 accumulator (the reference's
// `out_dtype`).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/redas_gemm.py:
//   _os_kernel        (:108)  -> os_wgmma_kernel (bf16 whose operands TMA can
//                                describe), os_kernel (everything else)
//   _streaming_kernel (:126)  -> stream_kernel<..., WS = true / false>
//                                (+ stream_reduce_kernel)
//
// The dataflow is which operand stays resident on chip:
//   OS  grid (n-tiles, m-tiles).  The K loop runs inside the block with the
//       f32 accumulator in registers; each output tile is written once.
//   WS  grid (n-tiles, K slabs, groups of m-tiles).  A block holds the
//       (BK, BN) weight slab of its n-tile and K slab in shared memory for
//       its whole sweep over its group's m-tiles; the input streams past it.
//   IS  the mirror of WS: grid (m-tiles, K slabs, groups of n-tiles), the
//       (BM, BK) input slab resident while the weight streams past it.
//
// OS has two routes, chosen by the wrapper before the launch from the
// operands alone (kernels/redas_gemm.py os_route):
//   wgmma  bf16 with K % 8 == 0, N % 8 == 0 and 16-byte-aligned bases (TMA's
//          stride and address rules; every prefill GEMM of the served
//          models).  A block of BM = 64 or 128 rows is warp-specialised
//          (wgmma_os_tile in hopper.cuh, shared with the grouped GEMM): one
//          producer warp keeps a ring of kWgStages stages in flight, each a
//          (BM, 64) box of A (K-major) and BN / 64 (64, 64) boxes of B
//          (N-major), all loaded by TMA with 128-byte swizzle and completed
//          on the stage's `full` mbarrier; one consumer warpgroup per 64 rows
//          issues wgmma m64nBNk16 on each stage from shared memory (B read
//          MN-major), keeps one wgmma group in flight, and frees the stage
//          on its `empty` mbarrier when the group behind it has finished.
//          TMA's zero fill covers a ragged M, N or K edge; B boxes wholly
//          past N are not loaded (their columns are never stored).  The
//          epilogue stores each accumulator pair straight from registers,
//          masked at the edge.
//   sync   f32, and bf16 shapes TMA cannot describe: a 128-thread block
//          loads each (BM, BK) and (BK, BN) chunk synchronously into padded
//          shared memory and runs WMMA 16x16x16 (bf16) or FFMA (f32) on it
//          (csrc/gemm_tile.cuh, shared with the grouped GEMM).
// What bounds OS on an H100: at prefill (M = 512-6144) the operations, 2MKN
// at 989 TFLOP/s in bf16.  The wgmma ring overlaps every load with the math
// of the stages before it, and a warpgroup's MMA runs at the tensor cores'
// own rate; what it leaves is one block per output tile (no persistent
// grid), so the ring's fill and the epilogue of each tile are not hidden
// behind another tile's math, and the grid's last wave runs part-empty.
//
// On the TPU the streaming grid runs in order on one core and carries the
// partial sums from one K chunk to the next through an aliased f32
// accumulator.  Here blocks run in parallel and in no order, so the K slabs
// are the parallel axis: each slab writes the f32 partials of its K range to
// its own (slab, M, N) slice of a workspace, and stream_reduce_kernel,
// launched by the same C entry right after, sums the slices in slab order
// from zero.  No atomics anywhere: two launches on the same inputs give the
// same bits.  When K fits one slab the block writes the output itself and
// neither workspace nor reduction exists.
//
// What bounds WS/IS on an H100:
//   - at decode (M = 4-16) the weight bytes (27.5 MB at 8960 x 1536 bf16,
//     8.2 us at 3.35 TB/s).  Only bytes in flight on every SM reach that
//     rate, and a grid of a few dozen blocks that each walk K in order
//     leaves most SMs idle.  The parallel slabs multiply the blocks by
//     ceil(K / BK), and each block puts its whole slab in flight at once,
//     with stages - 1 ring pieces.  A block's pipeline steps still run one
//     after another (about 0.9 us each on an H100), so at decode shallow
//     slabs over many blocks beat one deep slab a block; the engine's cost
//     model weighs that against the workspace and the reduction
//     (engine/cost.py gemm_cost).
//   - at prefill (N = 256) the operations; the accumulator of the current
//     output tile stays in registers over the slab's K sub-chunks, so a
//     partial leaves the chip once per slab, and a slab as deep as K writes
//     none.
//
// The pipeline of one streaming block: step u is one kSub-deep sub-chunk of
// one swept tile; its moving-operand piece lands in ring stage u % stages by
// cp.async, and the loads of step u + stages - 1 are issued before step u's
// math.  The first stages - 1 steps' cp.async groups carry their slab
// sub-chunks and one group right behind them the rest of the slab, so the
// whole slab is in flight from the start and its load overlaps the first
// sub-chunks' math.  bf16 runs on the tensor cores (WMMA 16x16x16, f32
// accumulate), f32 on FFMA (no TF32); ragged M, K and N are masked inside
// the kernels (out-of-range operands read as zero, out-of-range outputs are
// not written), so no padded copies exist.
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry points are at the end of this file.

#include "gemm_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int kSub = 64;           // K depth of one pipeline step
constexpr int kMaxStages = 4;      // ring stages a streaming block may use
constexpr int kSmemLimit = 232448; // shared memory a block may use (227 KB)

// cp.async (sm_80+): 16-byte copies from device to shared memory that do not
// hold a register while in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most `pending` (0 .. kMaxStages - 1) of this thread's newest
// cp.async groups are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else if (pending == 2)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else
    asm volatile("cp.async.wait_group 3;\n" ::);
}

// Copy rows [r0, r0 + rows) x columns [c0, c0 + COLS) of a row-major matrix
// with leading dimension `ld` into shared memory (row stride LDD): whole
// in-range 16-byte-aligned vectors by cp.async, the rest element by element,
// elements at or past (row_limit, col_limit) as zero.  The caller commits.
template <typename T, int COLS, int LDD>
__device__ __forceinline__ void stage_tile(T* __restrict__ dst,
                                           const T* __restrict__ src, int ld,
                                           int r0, int rows, int row_limit,
                                           int c0, int col_limit) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = COLS / VEC;
  static_assert(COLS % VEC == 0, "tile width must hold whole 16-byte vectors");
  const T zero = from_float<T>(0.f);
  for (int v = threadIdx.x; v < rows * VPR; v += kThreads) {
    const int r = v / VPR, c = (v % VPR) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * LDD + c;
    const T* s = src + size_t(gr) * ld + gc;
    if (gr < row_limit && gc + VEC <= col_limit &&
        (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        d[e] = (gr < row_limit && gc + e < col_limit) ? s[e] : zero;
    }
  }
}

template <typename T, typename OT, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    os_kernel(const T* __restrict__ A, const T* __restrict__ B,
              OT* __restrict__ O, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  os_block<T, OT, BM, BN, BK>(A, B, O, M, N, K, blockIdx.y * BM,
                              blockIdx.x * BN, smem);
}

// One (BM, BN) output tile of O = A @ B (bf16 operands, OT output) on the
// warp-specialised ring of hopper.cuh (wgmma_os_tile): BM / 64 consumer
// warpgroups, then one producer warp.
template <int BM, int BN, typename OT>
__global__ void __launch_bounds__(2 * BM + 32, 1)
    os_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB,
                    OT* __restrict__ O, int M, int N, int K) {
  wgmma_os_tile<BM, BN, 2>(&tmA, &tmB, 0, O, M, N, K, blockIdx.y * BM,
                           blockIdx.x * BN);
}

// Shared memory of one streaming block: the stationary slab, `stages` ring
// stages of the moving operand (rows padded by kPad), then one 16x16 f32
// staging tile per warp for the tensor-core epilogue.  Every region starts
// on 32 bytes.  redas_gemm.stream_smem_bytes mirrors this.
//   WS: slab (BK, BN) of B, a stage (BM, kSub) of A;
//   IS: slab (BM, BK) of A, a stage (kSub, BN) of B.
template <typename T, int BM, int BN, int BK, bool WS>
struct StreamSmem {
  static constexpr int LDS = WS ? BN + kPad : BK + kPad;  // slab row stride
  static constexpr int LDR = WS ? kSub + kPad : BN + kPad;  // ring row stride
  static constexpr size_t slab = size_t(WS ? BK : BM) * LDS * sizeof(T);
  static constexpr size_t stage = size_t(WS ? BM : kSub) * LDR * sizeof(T);
  static constexpr size_t scratch = size_t(kWarps) * 256 * sizeof(float);
  static constexpr size_t bytes(int stages) {
    return slab + size_t(stages) * stage + scratch;
  }
};

// One streaming block.  blockIdx.x is the stationary tile (the n-tile for
// WS, the m-tile for IS), blockIdx.y the K slab [y BK, min(K, (y + 1) BK)),
// blockIdx.z the group of swept tiles [z per, min(swept, (z + 1) per)).
// With P null (one slab) the block writes O, in f32 when out_f32 (a flag
// uniform over the grid) else in bf16; else the f32 partials of its slab to
// P[y] of the (slabs, M, N) workspace.
template <typename T, int BM, int BN, int BK, bool WS>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  void* __restrict__ O, float* __restrict__ P, int M, int N,
                  int K, int per, int stages, int out_f32) {
  using L = StreamSmem<T, BM, BN, BK, WS>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* slab = reinterpret_cast<T*>(smem);
  unsigned char* ring0 = smem + L::slab;
  float* scratch = reinterpret_cast<float*>(ring0 + stages * L::stage);
  const int k_lo = blockIdx.y * BK, k_hi = min(K, k_lo + BK);
  const int nsub = (k_hi - k_lo + kSub - 1) / kSub;
  const int fixed0 = blockIdx.x * (WS ? BN : BM);
  const int swept = WS ? (M + BM - 1) / BM : (N + BN - 1) / BN;
  const int t0 = blockIdx.z * per, t1 = min(swept, t0 + per);
  const int steps = (t1 - t0) * nsub;
  auto ring = [&](int u) {
    return reinterpret_cast<T*>(ring0 + (u % stages) * L::stage);
  };
  auto load_slab = [&](int c) {  // the slab's sub-chunk c
    const int kc = k_lo + c * kSub;
    if constexpr (WS)
      stage_tile<T, BN, L::LDS>(slab + c * kSub * L::LDS, B, N, kc, kSub,
                                k_hi, fixed0, N);
    else
      stage_tile<T, kSub, L::LDS>(slab + c * kSub, A, K, fixed0, BM, M, kc,
                                  k_hi);
  };
  auto load_ring = [&](int u) {  // step u's moving piece, none past the end
    if (u >= steps) return;
    const int t = t0 + u / nsub, kc = k_lo + (u % nsub) * kSub;
    if constexpr (WS)
      stage_tile<T, kSub, L::LDR>(ring(u), A, K, t * BM, BM, M, kc, k_hi);
    else
      stage_tile<T, BN, L::LDR>(ring(u), B, N, kc, kSub, k_hi, t * BN, N);
  };

  TileMath<T, BM, BN, kSub> tm;
  tm.zero();
  // cp.async groups, in the order the steps need them: steps 0 .. stages-2,
  // each with its slab sub-chunk; then the rest of the slab, so that the
  // whole slab is in flight from the start; then one group a step (step
  // u + stages - 1's piece), empty past the last step.
  for (int u = 0; u < stages - 1; ++u) {
    if (u < nsub) load_slab(u);
    load_ring(u);
    cp_async_commit();
  }
  for (int c = stages - 1; c < nsub; ++c) load_slab(c);
  cp_async_commit();
  for (int u = 0; u < steps; ++u) {
    // step u's group has landed: the first steps' groups have the rest of
    // the slab and u step groups behind them, the later ones stages - 2
    cp_async_wait_pending(u < stages - 1 ? stages - 1 : stages - 2);
    __syncthreads();  // ... for every thread; step u - 1's stage is free
    load_ring(u + stages - 1);
    cp_async_commit();
    const int c = u % nsub;
    if constexpr (WS)
      tm.template mma_ld<L::LDR, L::LDS>(ring(u), slab + c * kSub * L::LDS);
    else
      tm.template mma_ld<L::LDS, L::LDR>(slab + c * kSub, ring(u));
    if (c == nsub - 1) {  // the tile's last sub-chunk of this slab
      const int t = t0 + u / nsub;
      const int m0 = WS ? t * BM : fixed0, n0 = WS ? fixed0 : t * BN;
      float* part = P ? P + size_t(blockIdx.y) * M * N : nullptr;
      tm.epilogue(scratch, [&](int r, int col, float v) {
        const int gr = m0 + r, gc = n0 + col;
        if (gr < M && gc < N) {
          const size_t at = size_t(gr) * N + gc;
          if (part)
            part[at] = v;
          else if (out_f32)
            static_cast<float*>(O)[at] = v;
          else
            static_cast<__nv_bfloat16*>(O)[at] = __float2bfloat16(v);
        }
      });
      tm.zero();
    }
  }
  cp_async_wait_pending(0);  // nothing in flight when the block exits
}

// out[e] = the sum over s = 0, 1, ... of P[s, e], in that order, from 0,
// cast to T; a thread sums VEC consecutive elements with up to kReduceBatch
// slabs' loads in flight at once (at decode the reduction is a few such
// rounds of latency, not bytes).
constexpr int kReduceThreads = 256;
constexpr int kReduceBatch = 16;

template <typename T, int VEC>
__global__ void __launch_bounds__(kReduceThreads)
    stream_reduce_kernel(const float* __restrict__ P, T* __restrict__ O,
                         int MN, int slabs) {
  constexpr int B = kReduceBatch;
  const size_t e = (size_t(blockIdx.x) * kReduceThreads + threadIdx.x) * VEC;
  if (e >= size_t(MN)) return;
  float sum[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) sum[v] = 0.f;
  for (int s0 = 0; s0 < slabs; s0 += B) {
    float part[B][VEC];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (s0 + j < slabs) {
        const float* src = P + size_t(s0 + j) * MN + e;
        if constexpr (VEC == 4) {
          const float4 q = __ldcs(reinterpret_cast<const float4*>(src));
          part[j][0] = q.x;
          part[j][1] = q.y;
          part[j][2] = q.z;
          part[j][3] = q.w;
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) part[j][v] = __ldcs(src + v);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (s0 + j < slabs)
#pragma unroll
        for (int v = 0; v < VEC; ++v) sum[v] += part[j][v];
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) O[e + v] = from_float<T>(sum[v]);
}

template <typename T, typename OT, int BM, int BK, int BN>
cudaError_t launch_os(const void* a, const void* b, void* o, int M, int N,
                      int K, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, BM, BN, BK>::bytes;
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  static const cudaError_t attr =
      allow_smem(os_kernel<T, OT, BM, BN, BK>, smem);
  if (attr != cudaSuccess) return attr;
  os_kernel<T, OT, BM, BN, BK><<<dim3(gn, gm), kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<OT*>(o),
      M, N, K);
  return cudaGetLastError();
}

template <int BM, int BK, int BN>
cudaError_t launch_os_typed(int dtype, int out_dtype, const void* a,
                            const void* b, void* o, int M, int N, int K,
                            cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return out_dtype == 0
               ? launch_os<bf16, bf16, BM, BK, BN>(a, b, o, M, N, K, s)
               : launch_os<bf16, float, BM, BK, BN>(a, b, o, M, N, K, s);
  return out_dtype == 0
             ? launch_os<float, bf16, BM, BK, BN>(a, b, o, M, N, K, s)
             : launch_os<float, float, BM, BK, BN>(a, b, o, M, N, K, s);
}

// The tensor maps are encoded on the host at every call (the operands'
// addresses change); a launch the operands' strides or bases do not allow
// is refused with cudaErrorInvalidValue.
template <int BM, int BN, typename OT>
cudaError_t launch_os_wgmma(const void* a, const void* b, void* o, int M,
                            int N, int K, cudaStream_t stream) {
  if (K % 8 || N % 8 || (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(b) & 15))
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!encode_bf16_map(&ta, a, M, K, BM) || !encode_bf16_map(&tb, b, K, N, 64))
    return cudaErrorInvalidValue;
  constexpr size_t smem = WgSmem<BM, BN>::bytes;
  auto kernel = os_wgmma_kernel<BM, BN, OT>;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, 2 * BM + 32, smem, stream>>>(ta, tb, static_cast<OT*>(o), M,
                                               N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce(const void* p, void* o, int mn, int slabs,
                          cudaStream_t stream) {
  const float* P = static_cast<const float*>(p);
  T* O = static_cast<T*>(o);
  if (mn % 4 == 0) {
    const int blocks = (mn / 4 + kReduceThreads - 1) / kReduceThreads;
    stream_reduce_kernel<T, 4><<<blocks, kReduceThreads, 0, stream>>>(
        P, O, mn, slabs);
  } else {
    const int blocks = (mn + kReduceThreads - 1) / kReduceThreads;
    stream_reduce_kernel<T, 1><<<blocks, kReduceThreads, 0, stream>>>(
        P, O, mn, slabs);
  }
  return cudaGetLastError();
}

template <typename T, int BM, int BK, int BN, bool WS>
cudaError_t launch_stream(const void* a, const void* b, void* o, void* p,
                          int M, int N, int K, int slabs, int groups,
                          int stages, int out_dtype, cudaStream_t stream) {
  using L = StreamSmem<T, BM, BN, BK, WS>;
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  const int fixed = WS ? gn : gm, swept = WS ? gm : gn;
  if (stages < 2 || stages > kMaxStages || slabs != (K + BK - 1) / BK ||
      slabs > 65535 || (slabs > 1) != (p != nullptr) || groups < 1 ||
      groups > swept)
    return cudaErrorInvalidValue;
  const size_t smem = L::bytes(stages);
  if (smem > size_t(kSmemLimit)) return cudaErrorInvalidValue;
  const int per = (swept + groups - 1) / groups;
  const int n_groups = (swept + per - 1) / per;
  if (n_groups > 65535) return cudaErrorInvalidValue;
  auto kernel = stream_kernel<T, BM, BN, BK, WS>;
  static const cudaError_t attr = allow_smem(
      kernel, L::bytes(kMaxStages) < size_t(kSmemLimit) ? L::bytes(kMaxStages)
                                                        : size_t(kSmemLimit));
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(fixed, slabs, n_groups), kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), o,
      static_cast<float*>(p), M, N, K, per, stages, out_dtype);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p == nullptr) return err;
  return out_dtype == 0
             ? launch_reduce<__nv_bfloat16>(p, o, M * N, slabs, stream)
             : launch_reduce<float>(p, o, M * N, slabs, stream);
}

}  // namespace

// The sync route's OS tile menu (BM, BK, BN), compiled for both operand
// and both output dtypes.  TILES in repro_torch/kernels/redas_gemm.py is the
// same list (a test reads this macro to hold the two together); the grouped
// GEMM shares its layout.
#define REDAS_TILES(X) \
  X(16, 64, 64)        \
  X(32, 64, 64)        \
  X(64, 32, 64)        \
  X(64, 64, 128)       \
  X(128, 32, 128)      \
  X(64, 256, 64)

// The wgmma route's OS tile menu (BM, BK, BN): BM one or two consumer
// warpgroups, BK the ring stage's depth, BN one wgmma's width; compiled for
// both output dtypes.  Each tile is the fastest OS tile at some shape of
// the calibration sweep (tests/data/gemm_sweep_h100.jsonl).  WGMMA_TILES in
// repro_torch/kernels/redas_gemm.py is the same list.
#define REDAS_WGMMA_TILES(X) \
  X(64, 64, 64)              \
  X(64, 64, 128)             \
  X(128, 64, 64)             \
  X(128, 64, 128)            \
  X(128, 64, 256)

// The streaming menu (BM, BK, BN): BK is the slab's depth (a multiple of
// kSub), compiled for WS and IS and both dtypes.  (16, 1536, 64) holds
// K = 1536 in one slab; each other tile is the fastest of its dataflow at
// some shape of the calibration sweep (tests/data/gemm_sweep_h100.jsonl).
// STREAM_TILES in repro_torch/kernels/redas_gemm.py is the same list; a
// (dataflow, dtype, tile) whose slab and two ring stages do not fit
// kSmemLimit is refused at launch.
#define REDAS_STREAM_TILES(X) \
  X(16, 64, 64)               \
  X(16, 256, 64)              \
  X(16, 1536, 64)             \
  X(64, 256, 64)              \
  X(64, 512, 64)              \
  X(128, 128, 128)            \
  X(128, 256, 128)

extern "C" {

// OS on the sync route: dtype (A and B) and out_dtype (the output): 0 =
// bf16, 1 = f32.  Returns the CUDA error of the launch (0 on success), or -1
// for a tile that is not on the sync menu.
int redas_gemm_launch(int dtype, int out_dtype, int bm, int bk, int bn,
                      const void* a, const void* b, void* o, int M, int N,
                      int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REDAS_DISPATCH(BM, BK, BN)                                        \
  if (bm == BM && bk == BK && bn == BN)                                   \
    return static_cast<int>(launch_os_typed<BM, BK, BN>(dtype, out_dtype, \
                                                        a, b, o, M, N, K, \
                                                        s));
  REDAS_TILES(REDAS_DISPATCH)
#undef REDAS_DISPATCH
  return -1;
}

// OS on the wgmma route: bf16 A (M, K) and B (K, N), row-major, with
// K % 8 == 0, N % 8 == 0 and 16-byte-aligned bases; out_dtype 0 = bf16, 1 =
// f32.  Returns the CUDA error of the launch, cudaErrorInvalidValue for
// operands TMA cannot describe, or -1 for a tile that is not on the wgmma
// menu.
int redas_wgmma_launch(int out_dtype, int bm, int bk, int bn, const void* a,
                       const void* b, void* o, int M, int N, int K,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WGMMA_DISPATCH(BM, BK, BN)                                          \
  if (bm == BM && bk == BK && bn == BN)                                     \
    return static_cast<int>(                                                \
        out_dtype == 0                                                      \
            ? launch_os_wgmma<BM, BN, __nv_bfloat16>(a, b, o, M, N, K, s)   \
            : launch_os_wgmma<BM, BN, float>(a, b, o, M, N, K, s));
  REDAS_WGMMA_TILES(WGMMA_DISPATCH)
#undef WGMMA_DISPATCH
  return -1;
}

// WS (dataflow 1) or IS (dataflow 2) at a streaming tile, writing `o` in
// out_dtype (0 = bf16, 1 = f32; dtype is the operands').  `slabs` must be
// ceil(K / bk); with slabs > 1 `p` is the (slabs, M, N) f32 workspace that
// receives each slab's partials, and the reduction is launched after the
// GEMM on the same stream (two launches, one call); with slabs == 1 `p` is
// null and the GEMM writes `o` itself.  `groups` (1 .. swept tiles) splits
// each stationary tile's sweep among that many blocks; `stages` (2 ..
// kMaxStages) is the ring's depth.  Returns the CUDA error of the launch,
// cudaErrorInvalidValue for arguments the kernel does not take, or -1 for a
// tile that is not on the streaming menu.
int redas_stream_launch(int dataflow, int dtype, int out_dtype, int bm,
                        int bk, int bn, const void* a, const void* b, void* o,
                        void* p, int M, int N, int K, int slabs, int groups,
                        int stages, void* stream) {
  if ((dataflow != 1 && dataflow != 2) || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STREAM_DISPATCH(BM, BK, BN)                                       \
  if (bm == BM && bk == BK && bn == BN) {                                 \
    if (dtype == 0)                                                       \
      return static_cast<int>(                                            \
          dataflow == 1                                                   \
              ? launch_stream<__nv_bfloat16, BM, BK, BN, true>(           \
                    a, b, o, p, M, N, K, slabs, groups, stages,           \
                    out_dtype, s)                                         \
              : launch_stream<__nv_bfloat16, BM, BK, BN, false>(          \
                    a, b, o, p, M, N, K, slabs, groups, stages,           \
                    out_dtype, s));                                       \
    return static_cast<int>(                                              \
        dataflow == 1                                                     \
            ? launch_stream<float, BM, BK, BN, true>(                     \
                  a, b, o, p, M, N, K, slabs, groups, stages, out_dtype,  \
                  s)                                                      \
            : launch_stream<float, BM, BK, BN, false>(                    \
                  a, b, o, p, M, N, K, slabs, groups, stages, out_dtype,  \
                  s));                                                    \
  }
  REDAS_STREAM_TILES(STREAM_DISPATCH)
#undef STREAM_DISPATCH
  return -1;
}

// The streaming dataflows' second kernel: o (mn elements, dtype 0 = bf16,
// 1 = f32) = the sum of the workspace's `slabs` partials in slab order.
int redas_reduce_launch(int dtype, const void* p, void* o, int mn, int slabs,
                        void* stream) {
  if (mn < 1 || slabs < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? launch_reduce<__nv_bfloat16>(p, o, mn, slabs, s)
                 : launch_reduce<float>(p, o, mn, slabs, s));
}

}  // extern "C"
