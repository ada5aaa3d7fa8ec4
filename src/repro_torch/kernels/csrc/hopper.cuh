// Hopper (sm_90a) primitives of the wgmma kernels: mbarriers, TMA tile loads
// (rank 2 and rank 3), and warpgroup MMA (wgmma) on 128-byte-swizzled shared
// memory, written as inline PTX (A from shared memory or, in the RS form,
// from registers; B N- or K-major); and the warp-specialised OS ring built on
// them, which the ReDas GEMM's os_wgmma_kernel (redas_gemm.cu) and the
// grouped GEMM's grouped_wgmma_kernel (grouped_gemm.cu) share.  The tensor
// maps are encoded on the host through the driver entry point
// (cuTensorMapEncodeTiled), so the libraries link nothing beyond the CUDA
// runtime.

#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types (no driver link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also adds `bytes` to the phase's expected transactions
// (the TMA loads of a ring stage complete them).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Clock cycles a barrier wait may last (some 10 s on an H100) before it is
// taken for a fault: the kernel traps, and the launch reports an error,
// instead of hanging the card.
constexpr long long kWaitLimit = 20000000000LL;

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > kWaitLimit)
      __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Load the box at element coordinates (x = column, y = row) of the tensor
// map into shared memory at `dst`; the copy completes its bytes on `bar`.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// The same for a rank-3 map at (x = column, y = row, z = batch index).  TMA
// zero-fills each dimension on its own, so a box past the last row of batch
// z arrives as zeros and never reads batch z + 1.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

using TensorMapEncoder = decltype(&cuTensorMapEncodeTiled);

// The driver's cuTensorMapEncodeTiled, fetched once (null if the driver
// does not have it).
inline TensorMapEncoder tensor_map_encoder() {
  static const TensorMapEncoder fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncoder>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major (rows, cols) bf16 matrix at `ptr`, read in
// boxes of `box_rows` rows x 64 columns (128 bytes: the swizzle's row) with
// 128-byte swizzle.  TMA needs a 16-byte-aligned base and a row stride that
// is a multiple of 16 bytes (cols % 8 == 0); false if the encoder refuses.
inline bool encode_bf16_map(CUtensorMap* map, const void* ptr, int rows,
                            int cols, int box_rows) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a contiguous (batch, rows, cols) bf16 tensor at `ptr`,
// read in boxes of 1 x `box_rows` x 64 columns with 128-byte swizzle.  Its
// strides, cols x 2 and rows x cols x 2 bytes, are multiples of 16 when
// cols % 8 == 0; the base must be 16-byte aligned.  False if the encoder
// refuses.
inline bool encode_bf16_map_3d(CUtensorMap* map, const void* ptr, int batch,
                               int rows, int cols, int box_rows) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2,
                                 cuuint64_t(rows) * cuuint64_t(cols) * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The matrix descriptor of a 128-byte-swizzled operand at `p` (its swizzle
// atoms 1024-byte aligned): start address, leading and stride byte offsets
// in 16-byte units, and the 128B swizzle mode (bits 62-63 = 1).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most PENDING of this warpgroup's wgmma groups are in flight.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// Keep the compiler from moving accesses of the accumulator registers across
// the asynchronous MMAs that read and write them.
template <int R>
__device__ __forceinline__ void fence_accumulator(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D16(i) WG_D4(i), WG_D4(i + 4), WG_D4(i + 8), WG_D4(i + 12)
#define WG_D32(i) WG_D16(i), WG_D16(i + 16)

// d (64 x N, f32, the warpgroup's accumulator fragment: N / 2 values a
// thread) += A (64 x 16, bf16, K-major) @ B (16 x N, bf16), both read from
// shared memory through their descriptors.  TRANS_B = 1 (the default) reads
// B N-major (the transpose flag that 16-bit types allow: a row-major (K, N)
// operand); TRANS_B = 0 reads it K-major (an (N, K) operand stored row by
// row, as A is).
template <int N, int TRANS_B = 1>
struct Wgmma;

template <int TRANS_B>
struct Wgmma<64, TRANS_B> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : WG_D32(0)
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
  }
};

template <int TRANS_B>
struct Wgmma<128, TRANS_B> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n"
        "}\n"
        : WG_D32(0), WG_D32(32)
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
  }
};

template <int TRANS_B>
struct Wgmma<256, TRANS_B> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, %131;\n"
        "}\n"
        : WG_D32(0), WG_D32(32), WG_D32(64), WG_D32(96)
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
  }
};

// The same with A from registers (the RS form): a[0 .. 3] hold the bf16
// pairs of A's fragment in the accumulator's own layout (for the k16 step
// of columns 16 s .. 16 s + 15 of a 64 x W f32 fragment e: e[8 s + 0, 1],
// e[8 s + 2, 3], e[8 s + 4, 5], e[8 s + 6, 7]), so a product's f32 result
// feeds the next product without a trip through shared memory; B is read
// N-major.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : WG_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : WG_D32(0), WG_D32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<256> {
  __device__ __forceinline__ static void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
        "}\n"
        : WG_D32(0), WG_D32(32), WG_D32(64), WG_D32(96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef WG_D32
#undef WG_D16
#undef WG_D4

// ---------------------------------------------------------------------------
// The warp-specialised OS ring
// ---------------------------------------------------------------------------

constexpr int kWgStages = 4;  // ring stages

// Shared memory of one ring block: kWgStages stages, each the (BM, 64) box
// of A then BN / 64 (64, 64) boxes of B (bf16, 128-byte rows, every box
// 1024-byte aligned for the swizzle), then a `full` and an `empty` mbarrier
// per stage; 1 KB more to align the ring.  redas_gemm.wgmma_smem_bytes
// mirrors this.
template <int BM, int BN>
struct WgSmem {
  static constexpr int box_b = 64 * 64 * 2;
  static constexpr int stage_a = BM * 64 * 2;
  static constexpr int stage = stage_a + (BN / 64) * box_b;
  static constexpr size_t bytes = 1024 + size_t(kWgStages) * stage +
                                  2 * kWgStages * sizeof(uint64_t);
  static_assert(bytes <= 232448, "the ring exceeds a block's 227 KB");
};

template <typename OT>
__device__ __forceinline__ void store_pair(OT* O, size_t at, float x,
                                           float y);
template <>
__device__ __forceinline__ void store_pair<float>(float* O, size_t at,
                                                  float x, float y) {
  *reinterpret_cast<float2*>(O + at) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* O,
                                                          size_t at, float x,
                                                          float y) {
  *reinterpret_cast<__nv_bfloat162*>(O + at) = __floats2bfloat162_rn(x, y);
}

// The box at (x, y) of a rank-2 map, or at (x, y, z) of a rank-3 map.
template <int RANK>
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, int z, uint64_t* bar) {
  if constexpr (RANK == 2)
    tma_load_2d(dst, map, x, y, bar);
  else
    tma_load_3d(dst, map, x, y, z, bar);
}

// One block's (BM, BN) output tile at (m0, n0) of O = A @ B: A (M, K) and
// B (K, N) bf16, read through their tensor maps (rank 3: at batch index z of
// both), O (M, N) row-major in OT.  BM / 64 consumer warpgroups (threads
// 0 .. 2 BM - 1), then one producer warp.  The producer keeps kWgStages
// stages in flight, each a (BM, 64) box of A (K-major) and the B boxes with
// a column in range (N-major; a box wholly past N is not loaded), completed
// on the stage's `full` mbarrier, whose expected bytes count every box
// whole (TMA writes a ragged box's zero fill too).  Each consumer
// warpgroup issues wgmma m64nBNk16 from shared memory (B read MN-major),
// keeps one wgmma group in flight and frees a stage on its `empty`
// mbarrier when the group behind it has finished; the epilogue stores each
// accumulator pair straight from registers, masked at the edge.  Every
// mbarrier wait traps after about 10 s (mbar_wait).
template <int BM, int BN, int RANK, typename OT>
__device__ __forceinline__ void wgmma_os_tile(const CUtensorMap* tmA,
                                              const CUtensorMap* tmB, int z,
                                              OT* __restrict__ O, int M,
                                              int N, int K, int m0, int n0) {
  constexpr int WG = BM / 64;
  using L = WgSmem<BM, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kWgStages * L::stage);
  uint64_t* empty = full + kWgStages;
  const int steps = (K + 63) / 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);    // the producer's arrival, plus the bytes
      mbar_init(&empty[s], WG);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * WG) {  // the producer warp: one thread issues
    if (threadIdx.x == 128 * WG) {
      // B boxes with a column in range; a box wholly past N is not loaded
      const int boxes = min(BN / 64, (N - n0 + 63) / 64);
      const uint32_t bytes = L::stage_a + boxes * L::box_b;
      for (int k = 0; k < steps; ++k) {
        const int s = k % kWgStages;
        if (k >= kWgStages)  // the consumers freed this stage's last round
          mbar_wait(&empty[s], ((k / kWgStages) - 1) & 1);
        unsigned char* st = ring + s * L::stage;
        mbar_expect_tx(&full[s], bytes);
        tma_load<RANK>(st, tmA, k * 64, m0, z, &full[s]);
        for (int j = 0; j < boxes; ++j)
          tma_load<RANK>(st + L::stage_a + j * L::box_b, tmB, n0 + 64 * j,
                         k * 64, z, &full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [m0 + 64 wg, m0 + 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  for (int k = 0; k < steps; ++k) {
    const int s = k % kWgStages;
    mbar_wait(&full[s], (k / kWgStages) & 1);
    const unsigned char* a = ring + s * L::stage + wg * 64 * 128;
    const unsigned char* b = ring + s * L::stage + L::stage_a;
    fence_accumulator(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // four k16 steps of the 64-deep stage
      // A K-major: 128-byte rows, 8-row groups 1024 bytes apart, the k16
      // step 32 bytes along the row; B N-major: 16 rows (2048 bytes) a
      // k16 step, 8-row groups 1024 bytes apart, 64-column boxes L::box_b
      // apart
      Wgmma<BN>::mma(d, wgmma_desc(a + kk * 32, 16, 1024),
                     wgmma_desc(b + kk * 2048, L::box_b, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the group of step k - 1 has finished
    fence_accumulator(d);
    if (k > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(k - 1) % kWgStages]);
  }
  wgmma_wait<0>();
  fence_accumulator(d);

  // the accumulator fragment: warp w of the warpgroup holds rows 16 w ..
  // 16 w + 15, lane l rows l / 4 and l / 4 + 8, columns 8 j + 2 (l % 4)
  // and the next for j = 0 .. BN / 8 - 1
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = c0 + 8 * j;
    if (c < N) {  // N is even, so c + 1 < N too
      if (r0 < M)
        store_pair(O, size_t(r0) * N + c, d[4 * j], d[4 * j + 1]);
      if (r0 + 8 < M)
        store_pair(O, size_t(r0 + 8) * N + c, d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

}  // namespace
