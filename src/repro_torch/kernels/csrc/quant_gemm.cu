// Int8 GEMM for Hopper (sm_90a): C = A @ B for A (M, K) int8 and B (K, N)
// int8, both row-major, C (M, N) int32.  Exact integer arithmetic: every
// path and split gives the same bits.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/quant_gemm.py:
//   gemm_int8 (:124, pallas_call :148), kernel body _int8_os_kernel (:110)
//   -> decode_kernel (M <= 16) and tiled_kernel (any M)
//
// The TPU kernel runs the grid (M/bm, N/bn, K/bk) in order on one core and
// carries an int32 accumulator in VMEM across the K steps.  Here blocks run
// in parallel and in no order, so the wrapper names one of two paths
// (planned by engine/cost.py::decide_int8):
//
// decode (M <= 16, the serving decode step).  Bound: the int8 weight's
// bytes, read once (1536 x 8960 is 13.8 MB, 4.1 us at 3.35 TB/s); the
// operations are 2 M K N, a few microseconds of tensor-core time at most.
// So the design keeps those bytes in flight on many SMs:
//   - grid (split, N / 64), one 64-column tile of B a block, its K split
//     over `split` blocks that form one thread-block cluster (1-8, the
//     portable cluster size), each taking whole 32-row slices of K
//     (split s: slices [s base + min(s, extra), + base + (s < extra)));
//   - the block stages its activation rows of that K range once in shared
//     memory (16-byte cp.async), and each of its 4 warps walks every 4th
//     slice of the range through a 6-stage cp.async ring of its own
//     (2 KB a stage, 16-byte reads along N straight from the row-major
//     w_q: no transposed copy of the weights);
//   - the math is mma.sync m16n8k32 s8 -> s32 on C^T = B^T A^T: the
//     activations are the n8 operand (M <= 8 rows, or two n8 halves for
//     M <= 16), whose fragment is 4 consecutive k of one row, as A is
//     stored; the weight is the m16 operand, whose fragment wants 4
//     consecutive k of one column, so each lane reads 8 columns of 4 rows
//     (8-byte shared loads) and transposes 4 x 4 bytes with __byte_perm.
//     The lane's 8 columns are spread over 4 mma tiles (tile i, row g <->
//     column 8g + 2i, row g + 8 <-> column 8g + 2i + 1), so the order of
//     the output columns is permuted inside the tiles and undone at the
//     store, where a lane holds 8 contiguous columns.  dp4a would spend
//     M x 8 times the instructions on the same words; the tensor core takes
//     a 16 x 8 x 32 product in one;
//   - the splits combine in the same launch: each block sums its 4 warps'
//     partials in shared memory (warp order), a cluster barrier, then rank
//     r sums its share of the 64-column tile over the ranks' shared memory
//     in rank order (distributed shared memory) and writes it once.  No
//     workspace, no second kernel, no atomics: a fixed order, bit for bit.
//
// tiled (any M; the engine takes it above 16).  Bound: the operations
// (2048 x 1536 x 8960 is 56 GOP, 28 us at the 1979 TOP/s int8 peak).  One
// block per (BM, BN) output tile from the menu QUANT_TILES, 4 warps
// (2 x 2), a 4-stage cp.async ring of 64-deep K chunks (the next three
// chunks' copies in flight while the tensor cores run), mma.sync
// m16n8k32 s8 with A fragments by ldmatrix and B fragments built by the
// same byte permutes (a lane's columns spread over the n8 tiles, so it
// writes 2 x CPL contiguous int32 of each row at the end).  s8 wgmma
// would need B K-major in shared memory (it has no transpose for 8-bit
// types); the permutes do that transpose in registers instead.
//
// Shared memory is XOR-swizzled by 16-byte chunk so that the lanes of one
// load phase hit distinct banks: A rows (64 bytes) at chunk c ^ ((r >> 1)
// & 3), B rows (BN bytes) at c ^ ((r >> 1) & 6) within the row's chunks.
//
// Edges: M, K and N of any size; out-of-range operands read as zero
// (exact for integer sums) and out-of-range outputs are not written.
// 16-byte cp.async is used for an operand whose rows are 16-byte multiples
// (K % 16 == 0 for A, N % 16 == 0 for B) at a 16-byte-aligned base; other
// operands go through byte loads into the same layout (a uniform branch
// decided per launch from the operands, not a second kernel).
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry points are at the end of this file.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // a block's shared memory on sm_90

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; `valid` false writes 16 zeros and
// reads nothing (src is then any mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D = A (16 x 32, row) x B (32 x 8, col) + D, int8 in, int32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Words w0..w3 hold 4 columns of 4 consecutive k rows (row j in w_j); c[q]
// gets column q's 4 k values, the lowest k in the lowest byte (the mma
// fragment's packing).
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// Byte offsets of chunk c (16 bytes) of row r in a swizzled stage.
__device__ __forceinline__ int a_off(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}
template <int BN>
__device__ __forceinline__ int b_off(int r, int c) {
  return r * BN + ((c ^ ((r >> 1) & 6 & (BN / 16 - 1))) << 4);
}

// One 16-byte chunk of a row-major (n_rows, n_cols) int8 matrix at (gr, gc)
// into shared memory: by cp.async where `vec` (n_cols % 16 == 0 and a
// 16-byte-aligned base, so a chunk lies wholly in or out), else by masked
// byte loads.  Out-of-range bytes are zeros.
__device__ __forceinline__ void load_chunk(signed char* dst,
                                           const signed char* src,
                                           int n_rows, int n_cols, int gr,
                                           int gc, bool vec) {
  const bool in_rows = gr < n_rows;
  if (vec) {
    const bool ok = in_rows && gc < n_cols;
    cp_async16(dst, ok ? src + size_t(gr) * n_cols + gc : src, ok);
    return;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (in_rows) {
    const signed char* p = src + size_t(gr) * n_cols + gc;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (gc + e < n_cols)
        w[e >> 2] |= uint32_t(static_cast<uint8_t>(p[e])) << (8 * (e & 3));
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// tiled path
// ---------------------------------------------------------------------------

constexpr int kBK = 64;      // K bytes a ring stage
constexpr int kStages = 4;   // ring depth

template <int BM, int BN>
struct Tiled {
  static constexpr int WM = 2, WN = 2;       // warps over M and N
  static constexpr int TM = BM / WM, TN = BN / WN;
  static constexpr int FM = TM / 16;         // m16 tiles a warp
  static constexpr int CPL = TN / 8;         // columns a lane (= n8 tiles)
  static constexpr int A_BYTES = BM * kBK, B_BYTES = kBK * BN;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr size_t smem = size_t(kStages) * STAGE;
  static_assert(FM >= 1 && TM % 16 == 0, "BM must be a multiple of 32");
  static_assert(CPL == 4 || CPL == 8 || CPL == 16, "BN must be 64..256");
};

// CPL bytes of a B row (4, 8 or 16) as words
template <int CPL>
__device__ __forceinline__ void load_cols(const signed char* p,
                                          uint32_t (&w)[CPL / 4]) {
  if constexpr (CPL == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (CPL == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    tiled_kernel(const signed char* __restrict__ A,
                 const signed char* __restrict__ B, int* __restrict__ C,
                 int M, int N, int K, int a_vec, int b_vec) {
  using T = Tiled<BM, BN>;
  constexpr int FM = T::FM, CPL = T::CPL;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (warp / T::WN) * T::TM, wn0 = (warp % T::WN) * T::TN;
  const int chunks = (K + kBK - 1) / kBK;

  auto stage_a = [&](int s) {
    return reinterpret_cast<signed char*>(smem + size_t(s) * T::STAGE);
  };
  auto stage_b = [&](int s) { return stage_a(s) + T::A_BYTES; };
  auto load = [&](int kc) {
    signed char* as = stage_a(kc % kStages);
    signed char* bs = stage_b(kc % kStages);
    constexpr int AC = BM * (kBK / 16), BC = kBK * (BN / 16);
#pragma unroll
    for (int i = 0; i < (AC + kThreads - 1) / kThreads; ++i) {
      const int v = tid + i * kThreads;
      if (AC % kThreads == 0 || v < AC) {
        const int r = v / (kBK / 16), c = v % (kBK / 16);
        load_chunk(as + a_off(r, c), A, M, K, m0 + r, kc * kBK + 16 * c,
                   a_vec);
      }
    }
#pragma unroll
    for (int i = 0; i < (BC + kThreads - 1) / kThreads; ++i) {
      const int v = tid + i * kThreads;
      if (BC % kThreads == 0 || v < BC) {
        const int r = v / (BN / 16), c = v % (BN / 16);
        load_chunk(bs + b_off<BN>(r, c), B, K, N, kc * kBK + r,
                   n0 + 16 * c, b_vec);
      }
    }
  };

  int acc[FM][CPL][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int n = 0; n < CPL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kc landed; chunk kc - 1's slot is free
    if (kc + kStages - 1 < chunks) load(kc + kStages - 1);
    cp_async_commit();
    const signed char* as = stage_a(kc % kStages);
    const signed char* bs = stage_b(kc % kStages);
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t af[FM][4];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int r = wm0 + 16 * i + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(af[i], smem_u32(as + a_off(r, 2 * kk + (lane >> 4))));
      }
      uint32_t bf[CPL][2];
      const int col = wn0 + CPL * g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[4][CPL / 4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 32 * kk + 16 * h + 4 * t + j;
          load_cols<CPL>(bs + b_off<BN>(r, col >> 4) + (col & 15), w[j]);
        }
#pragma unroll
        for (int q = 0; q < CPL / 4; ++q) {
          uint32_t c[4];
          transpose4(w[0][q], w[1][q], w[2][q], w[3][q], c);
#pragma unroll
          for (int e = 0; e < 4; ++e) bf[4 * q + e][h] = c[e];
        }
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int n = 0; n < CPL; ++n) mma_s8(acc[i][n], af[i], bf[n][0], bf[n][1]);
    }
  }
  cp_async_wait<0>();

  // n8 tile n, fragment column 2t + b holds output column wn0 + CPL (2t +
  // b) + n: the lane's 2 x CPL columns of a row are contiguous
  const bool vec_out = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm0 + 16 * i + g + 8 * half;
      if (row >= M) continue;
      const int col0 = n0 + wn0 + 2 * CPL * t;
      int run[2 * CPL];
#pragma unroll
      for (int o = 0; o < 2 * CPL; ++o)
        run[o] = acc[i][o % CPL][2 * half + o / CPL];
      int* dst = C + size_t(row) * N + col0;
      if (vec_out && col0 + 2 * CPL <= N) {
#pragma unroll
        for (int v = 0; v < 2 * CPL / 4; ++v)
          reinterpret_cast<int4*>(dst)[v] = make_int4(
              run[4 * v], run[4 * v + 1], run[4 * v + 2], run[4 * v + 3]);
      } else {
#pragma unroll
        for (int o = 0; o < 2 * CPL; ++o)
          if (col0 + o < N) dst[o] = run[o];
      }
    }
}

template <int BM, int BN>
cudaError_t launch_tiled(const void* a, const void* b, void* c, int M, int N,
                         int K, bool a_vec, bool b_vec, cudaStream_t stream) {
  constexpr size_t smem = Tiled<BM, BN>::smem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tiled_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tiled_kernel<BM, BN><<<grid, kThreads, smem, stream>>>(
      static_cast<const signed char*>(a), static_cast<const signed char*>(b),
      static_cast<int*>(c), M, N, K, a_vec, b_vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode path
// ---------------------------------------------------------------------------

constexpr int kDecBN = 64;         // B columns a block
constexpr int kSlice = 32;         // K rows a slice (one mma k step)
constexpr int kDecStages = 6;      // a warp's ring depth
constexpr int kSliceBytes = kSlice * kDecBN;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr size_t kRingBytes = size_t(kWarps) * kDecStages * kSliceBytes;

// Shared memory of a decode block: the warps' rings (the warps' partial
// tiles reuse them at the end), then `rows` activation rows of the
// block's slices, each padded by 16 bytes (conflict-free fragment loads).
__host__ __device__ inline int dec_a_ld(int slices_max) {
  return slices_max * kSlice + 16;
}
__host__ __device__ inline size_t dec_smem(int rows, int slices_max) {
  return kRingBytes + size_t(rows) * dec_a_ld(slices_max);
}

// MH: activation rows in n8 halves (1: M <= 8, 2: M <= 16)
template <int MH>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const signed char* __restrict__ A,
                  const signed char* __restrict__ B, int* __restrict__ C,
                  int M, int N, int K, int base, int extra, int a_vec,
                  int b_vec) {
  constexpr int ROWS = 8 * MH;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(gridDim.x);
  const int s = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * kDecBN;
  const int s0 = s * base + min(s, extra);      // first slice
  const int cnt = base + (s < extra ? 1 : 0);   // slices of this split
  const int a_ld = dec_a_ld(base + (extra > 0 ? 1 : 0));
  signed char* ring = reinterpret_cast<signed char*>(smem);
  signed char* as = ring + kRingBytes;

  // 1. the activation rows of the split's K range, once (group 0)
  {
    const int per_row = cnt * (kSlice / 16);
    for (int v = tid; v < ROWS * per_row; v += kThreads) {
      const int r = v / per_row, c = v % per_row;
      load_chunk(as + r * a_ld + 16 * c, A, M, K, r, s0 * kSlice + 16 * c,
                 a_vec);
    }
    cp_async_commit();
  }

  // 2. warp w walks slices w, w + 4, ... of the split through its ring
  const int mine = cnt > warp ? (cnt - warp + kWarps - 1) / kWarps : 0;
  signed char* wring = ring + size_t(warp) * kDecStages * kSliceBytes;
  auto load_slice = [&](int i) {
    signed char* dst = wring + (i % kDecStages) * kSliceBytes;
    const int k0 = (s0 + warp + kWarps * i) * kSlice;
#pragma unroll
    for (int u = 0; u < kSliceBytes / 16 / 32; ++u) {
      const int v = lane + 32 * u, r = v >> 2, c = v & 3;
      load_chunk(dst + b_off<kDecBN>(r, c), B, K, N, k0 + r, n0 + 16 * c,
                 b_vec);
    }
  };
#pragma unroll
  for (int p = 0; p < kDecStages - 1; ++p) {
    if (p < mine) load_slice(p);
    cp_async_commit();
  }
  cp_async_wait<kDecStages - 2>();
  __syncthreads();  // every thread's activation copies have landed

  int acc[MH][4][4];
#pragma unroll
  for (int h = 0; h < MH; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][i][e] = 0;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kDecStages - 2>();
    __syncwarp();  // slice i landed; slice i - 1's slot is free
    if (i + kDecStages - 1 < mine) load_slice(i + kDecStages - 1);
    cp_async_commit();
    const signed char* bs = wring + (i % kDecStages) * kSliceBytes;
    // 8 columns (8g ..) of rows 16h + 4t + j, transposed to 4-k words
    uint32_t col[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * h + 4 * t + j;
        const uint2 v = *reinterpret_cast<const uint2*>(
            bs + b_off<kDecBN>(r, g >> 1) + 8 * (g & 1));
        w[j][0] = v.x;
        w[j][1] = v.y;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t c[4];
        transpose4(w[0][q], w[1][q], w[2][q], w[3][q], c);
#pragma unroll
        for (int e = 0; e < 4; ++e) col[h][4 * q + e] = c[e];
      }
    }
    const int ka = (warp + kWarps * i) * kSlice + 4 * t;
#pragma unroll
    for (int mh = 0; mh < MH; ++mh) {
      const signed char* ar = as + (8 * mh + g) * a_ld + ka;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(ar);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(ar + 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint32_t a[4] = {col[0][2 * mi], col[0][2 * mi + 1],
                               col[1][2 * mi], col[1][2 * mi + 1]};
        mma_s8(acc[mh][mi], a, b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // 3. the warps' partial tiles (ROWS x 64 int32 each, over the rings),
  //    summed in warp order into warp 0's
  int* part = reinterpret_cast<int*>(smem);
  {
    int* mine_p = part + warp * ROWS * kDecBN;
#pragma unroll
    for (int mh = 0; mh < MH; ++mh)
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = 8 * mh + 2 * t, c = 8 * g + 2 * mi;
        *reinterpret_cast<int2*>(mine_p + r * kDecBN + c) =
            make_int2(acc[mh][mi][0], acc[mh][mi][2]);
        *reinterpret_cast<int2*>(mine_p + (r + 1) * kDecBN + c) =
            make_int2(acc[mh][mi][1], acc[mh][mi][3]);
      }
  }
  __syncthreads();
  for (int e = tid; e < ROWS * kDecBN; e += kThreads) {
    int sum = part[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += part[w * ROWS * kDecBN + e];
    part[e] = sum;
  }
  cluster.sync();  // every rank's block partial is written

  // 4. rank s sums its share of the tile over the ranks, in rank order
  constexpr int kVecs = ROWS * kDecBN / 4;
  const int share = (kVecs + split - 1) / split;
  const int v_end = min((s + 1) * share, kVecs);
  const bool vec_out = (N & 3) == 0;
  for (int v = s * share + tid; v < v_end; v += kThreads) {
    int4 sum = make_int4(0, 0, 0, 0);
    for (int q = 0; q < split; ++q) {
      const int4 x = cluster.map_shared_rank(reinterpret_cast<int4*>(part),
                                             q)[v];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int row = v / (kDecBN / 4), col = n0 + 4 * (v % (kDecBN / 4));
    if (row >= M) continue;
    int* dst = C + size_t(row) * N + col;
    if (vec_out && col + 4 <= N) {
      *reinterpret_cast<int4*>(dst) = sum;
    } else {
      const int e[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i < N) dst[i] = e[i];
    }
  }
  // no block leaves while a peer may read its partial (the reads are done:
  // their values are used, so the arrival orders nothing)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int MH>
cudaError_t launch_decode(const void* a, const void* b, void* c, int M,
                          int N, int K, int split, int base, int extra,
                          bool a_vec, bool b_vec, cudaStream_t stream) {
  auto kernel = decode_kernel<MH>;
  const size_t smem = dec_smem(8 * MH, base + (extra > 0 ? 1 : 0));
  if (smem > size_t(kSmemLimit)) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + kDecBN - 1) / kDecBN);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const signed char*>(a),
      static_cast<const signed char*>(b), static_cast<int*>(c), M, N, K, base,
      extra, static_cast<int>(a_vec), static_cast<int>(b_vec));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The tiled path's menu (BM, BK, BN); BK is the ring's chunk depth.
// TILES in repro_torch/kernels/quant_gemm.py is the same list (a test reads
// these macros to hold the two together).
#define QUANT_TILES(X) \
  X(32, 64, 64)        \
  X(64, 64, 64)        \
  X(64, 64, 128)       \
  X(128, 64, 64)       \
  X(128, 64, 128)

// The decode path: its row buckets (DECODE_ROWS), the columns of a block
// (DECODE_BN) and the most splits of K (DECODE_MAX_SPLIT, a cluster).
#define QUANT_DECODE_ROWS(X) X(8) X(16)
#define QUANT_DECODE_BN 64
#define QUANT_DECODE_MAX_SPLIT 8

extern "C" {

// Tiled path.  a (M, K) int8, b (K, N) int8 and c (M, N) int32 are
// contiguous row-major.  Returns the CUDA error of the launch (0 on
// success), or -1 for a tile that is not on the menu.
int quant_gemm_launch(int bm, int bk, int bn, const void* a, const void* b,
                      void* c, int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a_vec = K % 16 == 0 && aligned16(a);
  const bool b_vec = N % 16 == 0 && aligned16(b);
#define QUANT_DISPATCH(BM, BK, BN)                                        \
  if (bm == BM && bk == BK && bn == BN)                                   \
    return static_cast<int>(                                              \
        launch_tiled<BM, BN>(a, b, c, M, N, K, a_vec, b_vec, s));
  QUANT_TILES(QUANT_DISPATCH)
#undef QUANT_DISPATCH
  return -1;
}

// Decode path (M <= 16): `split` blocks (1..QUANT_DECODE_MAX_SPLIT, one
// cluster) over K's 32-row slices, split s taking base + (s < extra)
// slices from s base + min(s, extra).  Returns the CUDA error of the
// launch, or -1 for a row bucket, split or shape the kernel does not take.
int quant_decode_launch(int rows, const void* a, const void* b, void* c,
                        int M, int N, int K, int split, int base, int extra,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > rows || split < 1 || split > QUANT_DECODE_MAX_SPLIT ||
      base < 0 || extra < 0 || extra >= split)
    return -1;
  const bool a_vec = K % 16 == 0 && aligned16(a);
  const bool b_vec = N % 16 == 0 && aligned16(b);
  if (rows == 8)
    return static_cast<int>(launch_decode<1>(a, b, c, M, N, K, split, base,
                                             extra, a_vec, b_vec, s));
  if (rows == 16)
    return static_cast<int>(launch_decode<2>(a, b, c, M, N, K, split, base,
                                             extra, a_vec, b_vec, s));
  return -1;
}

}  // extern "C"
