// N:M structured-sparse GEMM for Hopper (sm_90a): O = A @ W for A (M, K)
// row-major and W held compressed: `values` (Kc, N) the kept values of each
// group of m_group consecutive K rows of a column, `indices` (Kc, N) int8
// their in-group offsets, Kc = ceil(K / m_group) * n_keep.  f32 accumulation;
// bf16 or f32 activations, and values of the same type or int8 (sparse x int8
// storage), whose optional per-column f32 `scale` multiplies the f32 sum of
// each output column once, after the whole K sum (in the epilogue, or with
// more than one split in sparse_reduce_kernel), as the reference's entry
// point multiplies its accumulator (sparse_gemm.py:225-226).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/sparse_gemm.py:
//   gemm_sparse (:135, pallas_call :163), body _sparse_os_kernel (:116),
//   scatter _scatter_dense (:97), scale sparse_gemm (:225-226)
//   -> sparse_decode_kernel (+ sparse_reduce_kernel) for M up to 16,
//   sparse_os_kernel above; each for float values (VT = T) and int8 values
//   (VT = signed char)
//
// The TPU kernel walks the grid (M/bm, N/bn, K/bk) in order on one core,
// scatters each compressed block back to a dense (bk, bn) VMEM tile and runs
// a dense dot on it into a VMEM accumulator (OS).  Here blocks run in
// parallel and in no order, and the caller picks one of two paths
// (engine/cost.py decide_sparse):
//
// 1. Decode (M <= 16): bound by the compressed weight's bytes (values at
//    their itemsize plus one index byte per kept value; 20.6 MB, 6.2 us at
//    8 x 8960 x 1536 bf16 2:4), so the design keeps those bytes in flight on
//    every SM and builds no dense tile.  A thread owns C consecutive output
//    columns (DecRow: one 16-byte vector of float values, C = 16 / itemsize,
//    or 8 int8 values as one 8-byte vector, C = 8, so that int8 keeps the
//    bf16 variant's MR x 8 accumulators; and C index bytes a compressed row),
//    neighbouring lanes neighbouring columns, so every load is coalesced; a
//    block's 4 warps share its K range.  The
//    activation rows of the range are staged once in shared memory, in f32
//    and transposed (MR / 4 vector loads give a column's MR rows), and
//    each kept value (an int8 one converted to f32, exactly) adds
//    A[r, g * m + off] * v into MR x C f32 registers:
//    an offset outside 0..m-1 adds nothing and two values at one offset
//    both add (the reference's one-hot sum without the dense tile).  The
//    loads of a thread's next U rows are in flight while it uses the last
//    U (two register stages), and its first rows' loads while the
//    activations are staged.  The groups are split over blocks (`split_k`,
//    gridDim.y, chosen by the planner's wave term) so that the grid fills
//    the card (a split past the groups takes none and adds a zero partial):
//    each block's warps reduce in shared memory in warp order, each split
//    writes an f32 partial to a (split_k, M, N) workspace, sparse_reduce_kernel
//    sums the partials in split order (with split_k == 1 the first kernel
//    writes the output).  No atomics: two launches give the same bits.
// 2. Tiled (prefill, M > 16): bound by the operations, 2 M K N x density.
//    One block per (BM, BN) output tile keeps an f32 accumulator over the
//    whole K sweep (the OS tile code of gemm_tile.cuh, WMMA for bf16, FFMA
//    for f32); each chunk of G = BK / m whole groups is scattered to a dense
//    shared tile of A's type and multiplied (int8 values scatter into it
//    exactly: |v| <= 127 fits bf16's 8-bit significand).  The next chunk's activation tile, values
//    and indices load by cp.async into a second stage while this chunk
//    scatters and multiplies; the compressed stages hold G * n_keep rows (int8
//    value rows at 1 byte, unpadded), so the 128 x 128 x 128 bf16 tile keeps
//    two stages in 227 KB at every spec.
//    Where two stages do not fit (f32 at the wide tiles) the kernel runs one.
//    The scatter is owned per (group, column) by one thread, which zeroes the
//    group's m dense slots and adds each kept value in order of j: no
//    atomics, no write outside the group's rows.
//
// n_keep and m_group are runtime arguments: every spec 1 <= n < m <= 128
// runs on both paths.  Ragged M, K and N are masked in the kernels
// (activation columns past K and compressed rows past Kc read as zero, an
// out-of-range index as "no value"; out-of-range outputs are not written):
// the zero padding of the reference's entry point without the copies.
// wgmma, TMA and the sparse tensor cores (`mma.sp`, whose metadata cannot
// express a repeated or out-of-range offset) are not used.
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry points are at the end of this file.

#include "gemm_tile.cuh"

namespace {

constexpr size_t kSmemLimit = 232448;  // shared memory a block may use

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_float<signed char>(signed char v) {
  return static_cast<float>(v);
}

// A zero of a value type (the fill of a masked value).
template <typename V>
__device__ __forceinline__ V value_zero() {
  return from_float<V>(0.f);
}
template <>
__device__ __forceinline__ signed char value_zero<signed char>() {
  return 0;
}

// The output element's scale: 1 without a scale (a multiply by 1 is exact).
__device__ __forceinline__ float col_scale(const float* __restrict__ scale,
                                          int col) {
  return scale ? scale[col] : 1.f;
}

// --------------------------------------------------------------------------
// cp.async (sm_80+): 16-byte copies from device to shared memory that do not
// hold a register while in flight.
// --------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// --------------------------------------------------------------------------
// The tiled path
// --------------------------------------------------------------------------

// Shared memory of one tiled block: the dense (BK, BN) tile the chunk is
// scattered to, the per-warp f32 epilogue tiles, then `stages` stages of
// (the (BM, BK) activation tile, `rows` compressed rows of values and of
// int8 indices).  Float value rows are padded as the activation tile is,
// int8 value rows are not.  Every region starts on 16 bytes.
// rows = G * n_keep.  sparse_gemm.smem_bytes in the wrapper mirrors this.
template <typename T, typename VT, int BM, int BN, int BK>
struct SparseSmem {
  static constexpr int ldv = BN + (sizeof(VT) > 1 ? kPad : 0);
  static constexpr size_t dense = size_t(BK) * (BN + kPad) * sizeof(T);
  static constexpr size_t scratch = size_t(kWarps) * 256 * sizeof(float);
  static constexpr size_t a = size_t(BM) * (BK + kPad) * sizeof(T);
  __host__ __device__ static size_t values(int rows) {
    return size_t(rows) * ldv * sizeof(VT);
  }
  __host__ __device__ static size_t indices(int rows) {
    return size_t(rows) * BN;
  }
  __host__ __device__ static size_t stage(int rows) {
    return a + values(rows) + indices(rows);
  }
  __host__ __device__ static size_t bytes(int rows, int stages) {
    return dense + scratch + size_t(stages) * stage(rows);
  }
};

// Copy rows [r0, r0 + rows) x columns [c0, c0 + COLS) of a row-major matrix
// with leading dimension `ld` into shared memory (row stride LDD): whole
// in-range 16-byte-aligned vectors by cp.async, the rest element by element,
// elements at or past (row_limit, col_limit) as `fill`.  The caller commits.
template <typename E, int COLS, int LDD>
__device__ __forceinline__ void stage_rows(E* __restrict__ dst,
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
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        d[e] = (gr < row_limit && gc + e < col_limit) ? s[e] : fill;
    }
  }
}

template <typename T, typename VT, int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    sparse_os_kernel(const T* __restrict__ A, const VT* __restrict__ V,
                     const signed char* __restrict__ I,
                     const float* __restrict__ scale, void* __restrict__ O,
                     int out_f32, int M, int N, int K, int Kc, int n_keep,
                     int m_group, int stages) {
  using L = SparseSmem<T, VT, BM, BN, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDA = BK + kPad, LDW = BN + kPad, LDV = L::ldv;
  const int G = BK / m_group;          // whole groups per chunk
  const int chunk = G * m_group;       // dense rows per chunk (<= BK)
  const int rows_c = G * n_keep;       // compressed rows per chunk
  const int groups = Kc / n_keep;
  const int n_chunks = (groups + G - 1) / G;
  T* Bs = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + L::dense);
  unsigned char* stage0 = smem + L::dense + L::scratch;
  const size_t stage_bytes = L::stage(rows_c);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T zero = from_float<T>(0.f);
  auto As = [&](int s) {
    return reinterpret_cast<T*>(stage0 + s * stage_bytes);
  };
  auto Vs = [&](int s) {
    return reinterpret_cast<VT*>(stage0 + s * stage_bytes + L::a);
  };
  auto Is = [&](int s) {
    return reinterpret_cast<signed char*>(stage0 + s * stage_bytes + L::a +
                                          L::values(rows_c));
  };
  auto load_chunk = [&](int c, int s) {
    const int g0 = c * G, k0 = g0 * m_group;
    stage_rows<T, BK, LDA>(As(s), A, K, m0, BM, M, k0, min(K, k0 + chunk),
                           zero);
    stage_rows<VT, BN, LDV>(Vs(s), V, N, g0 * n_keep, rows_c, Kc, n0, N,
                            value_zero<VT>());
    stage_rows<signed char, BN, BN>(Is(s), I, N, g0 * n_keep, rows_c, Kc, n0,
                                    N, static_cast<signed char>(-1));
    cp_async_commit();
  };

  // the dense tile's rows past the chunk stay zero for the whole sweep
  for (int e = chunk * BN + threadIdx.x; e < BK * BN; e += kThreads)
    Bs[(e / BN) * LDW + e % BN] = zero;

  TileMath<T, BM, BN, BK> tm;
  tm.zero();
  if (n_chunks > 0) load_chunk(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int s = stages == 2 ? (c & 1) : 0;
    if (stages == 2 && c + 1 < n_chunks) {
      load_chunk(c + 1, s ^ 1);  // that stage's last readers passed the barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // scatter: one thread per (group, column) of the chunk
    const VT* vs = Vs(s);
    const signed char* is = Is(s);
    for (int p = threadIdx.x; p < G * BN; p += kThreads) {
      const int g = p / BN, col = p % BN;
      T* dst = Bs + g * m_group * LDW + col;
      for (int off = 0; off < m_group; ++off) dst[off * LDW] = zero;
      for (int j = 0; j < n_keep; ++j) {
        const int r = g * n_keep + j;
        const int off = is[r * BN + col];
        if (off >= 0 && off < m_group) {
          T* d = dst + off * LDW;
          *d = from_float<T>(to_float(*d) + to_float(vs[r * LDV + col]));
        }
      }
    }
    __syncthreads();
    tm.mma(As(s), Bs);
    __syncthreads();
    if (stages == 1 && c + 1 < n_chunks) load_chunk(c + 1, 0);
  }
  tm.epilogue(scratch, [&](int r, int c, float v) {
    const int gr = m0 + r, gc = n0 + c;
    if (gr < M && gc < N) {
      const size_t idx = size_t(gr) * N + gc;
      const float y = v * col_scale(scale, gc);
      if (out_f32)
        static_cast<float*>(O)[idx] = y;
      else
        static_cast<T*>(O)[idx] = from_float<T>(y);
    }
  });
}

template <typename T, typename VT, int BM, int BK, int BN>
cudaError_t launch_tiled(const void* a, const void* v, const void* idx,
                         const float* scale, void* o, int out_f32, int M,
                         int N, int K, int Kc, int n_keep, int m_group,
                         int stages, cudaStream_t stream) {
  using L = SparseSmem<T, VT, BM, BN, BK>;
  const size_t smem = L::bytes((BK / m_group) * n_keep, stages);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  // the attribute is the most any spec takes: rows < BK at 2 stages
  static const cudaError_t attr = allow_smem(
      sparse_os_kernel<T, VT, BM, BN, BK>,
      L::bytes(BK, 2) < kSmemLimit ? L::bytes(BK, 2) : kSmemLimit);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  sparse_os_kernel<T, VT, BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const VT*>(v),
      static_cast<const signed char*>(idx), scale, o, out_f32, M, N, K, Kc,
      n_keep, m_group, stages);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// The decode path
// --------------------------------------------------------------------------

constexpr int kDecWarps = 4;                  // warps sharing a K range
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecSmemA = 48 * 1024;          // staged activation window

// 16 bytes of T -> 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void unpack16(uint4 u, float* f);
template <>
__device__ __forceinline__ void unpack16<float>(uint4 u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack_bf16x2(unsigned w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 u, float* f) {
  unpack_bf16x2(u.x, f);
  unpack_bf16x2(u.y, f + 2);
  unpack_bf16x2(u.z, f + 4);
  unpack_bf16x2(u.w, f + 6);
}

// One compressed row's share of a thread: C values as one vector `Vec`
// (16 bytes of float values; 8 int8 values), C index bytes `Idx`.
// sparse_gemm.decode_columns in the wrapper is 32 C.
template <typename VT>
struct DecRow;
template <>
struct DecRow<__nv_bfloat16> {
  static constexpr int C = 8;
  using Vec = uint4;
  using Idx = uint2;
  static __device__ __forceinline__ Idx none() { return make_uint2(~0u, ~0u); }
  static __device__ __forceinline__ void unpack(Vec u, float* f) {
    unpack16<__nv_bfloat16>(u, f);
  }
};
template <>
struct DecRow<float> {
  static constexpr int C = 4;
  using Vec = uint4;
  using Idx = unsigned;
  static __device__ __forceinline__ Idx none() { return ~0u; }
  static __device__ __forceinline__ void unpack(Vec u, float* f) {
    unpack16<float>(u, f);
  }
};
template <>
struct DecRow<signed char> {
  static constexpr int C = 8;
  using Vec = uint2;
  using Idx = uint2;
  static __device__ __forceinline__ Idx none() { return make_uint2(~0u, ~0u); }
  // each byte sign-extended and converted: exact
  static __device__ __forceinline__ void unpack(Vec u, float* f) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      f[c] = static_cast<float>(
          static_cast<signed char>((c < 4 ? u.x : u.y) >> (8 * (c & 3))));
  }
};

__device__ __forceinline__ int idx_byte(uint2 w, int c) {
  const unsigned x = c < 4 ? w.x : w.y;
  return static_cast<signed char>(x >> (8 * (c & 3)));
}
__device__ __forceinline__ int idx_byte(unsigned w, int c) {
  return static_cast<signed char>(w >> (8 * c));
}

// The MR staged f32 activation rows of one dense column (contiguous in the
// transposed window), by 16-byte vector loads.
template <int MR>
__device__ __forceinline__ void load_col(const float* p, float* a) {
  static_assert(MR % 4 == 0, "a staged column is whole 16-byte vectors");
#pragma unroll
  for (int q = 0; q < MR / 4; ++q)
    unpack16<float>(reinterpret_cast<const uint4*>(p)[q], a + 4 * q);
}

// U compressed rows of one thread: values and indices, in registers.
template <typename VT, int U>
struct DecBatch {
  typename DecRow<VT>::Vec v[U];
  typename DecRow<VT>::Idx ix[U];
};

// One thread's C values and indices of compressed row `r` at column `col`:
// one vector each where the whole vector is in range and aligned, element
// by element (values past N as 0, indices as "no value") elsewhere.
template <typename VT>
__device__ __forceinline__ void load_row(const VT* __restrict__ V,
                                         const signed char* __restrict__ I,
                                         int N, int r, int col, bool vec,
                                         typename DecRow<VT>::Vec& v,
                                         typename DecRow<VT>::Idx& i) {
  constexpr int C = DecRow<VT>::C;
  const size_t at = size_t(r) * N + col;
  if (vec) {
    v = __ldcs(reinterpret_cast<const typename DecRow<VT>::Vec*>(V + at));
    i = __ldcs(reinterpret_cast<const typename DecRow<VT>::Idx*>(I + at));
  } else {
    VT* vt = reinterpret_cast<VT*>(&v);
    signed char* it = reinterpret_cast<signed char*>(&i);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      vt[c] = col + c < N ? V[at + c] : value_zero<VT>();
      it[c] = col + c < N ? I[at + c] : static_cast<signed char>(-1);
    }
  }
}

// Rows [r, r + U) of the thread's share (rows at or past `hi` as "no
// value"): every load sent before any is used.
template <typename VT, int U>
__device__ __forceinline__ void load_batch(const VT* __restrict__ V,
                                           const signed char* __restrict__ I,
                                           int N, int r, int hi, int col,
                                           bool vec, DecBatch<VT, U>& b) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (r + u < hi)
      load_row<VT>(V, I, N, r + u, col, vec, b.v[u], b.ix[u]);
    else
      b.ix[u] = DecRow<VT>::none();
  }
}

// acc[q][c] += A[q, g * m + off_c] * v_c for each row of the batch, where
// the row's group g starts at staged column (g - w0) * m; an offset outside
// 0..m-1 adds nothing.
template <typename VT, int MR, int U>
__device__ __forceinline__ void use_batch(const DecBatch<VT, U>& b,
                                          const float* __restrict__ At, int r,
                                          int hi, int n_keep, int m_group,
                                          int w0,
                                          float (&acc)[MR][DecRow<VT>::C]) {
  constexpr int C = DecRow<VT>::C;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (r + u < hi) {
      const float* at = At + ((r + u) / n_keep - w0) * m_group * MR;
      float vf[C];
      DecRow<VT>::unpack(b.v[u], vf);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        // branch-free, so the shared loads of all C columns go out
        // together: an offset outside 0..m-1 multiplies column 0 by 0
        const int off = idx_byte(b.ix[u], c);
        const bool in =
            static_cast<unsigned>(off) < static_cast<unsigned>(m_group);
        const float w = in ? vf[c] : 0.f;
        float a[MR];
        load_col<MR>(at + (in ? off : 0) * MR, a);
#pragma unroll
        for (int q = 0; q < MR; ++q) acc[q][c] = fmaf(a[q], w, acc[q][c]);
      }
    }
  }
}

// Grid (ceil(N / (32 C)), split_k): block (x, s) owns columns
// [32 C x, 32 C (x + 1)) and groups [s base + min(s, extra), + base +
// (s < extra)) (sparse_gemm.split_groups in the wrapper; none for a split
// past the groups, which writes zeros), swept in windows
// of `win` groups whose activation columns are staged transposed, in f32,
// in shared memory; warp w takes rows [rows w / 4, rows (w + 1) / 4) of
// each window, U rows at a time, the next U rows' loads in flight while
// these are used.  O is the output (split_k == 1; each column times its
// scale, if any) or the (split_k, M, N) f32 workspace (unscaled partials).
template <typename T, typename VT, int MR, int U>
__global__ void __launch_bounds__(kDecThreads)
    sparse_decode_kernel(const T* __restrict__ A, const VT* __restrict__ V,
                         const signed char* __restrict__ I,
                         const float* __restrict__ scale,
                         void* __restrict__ O, int out_f32, int M, int N,
                         int K, int n_keep, int m_group, int split_k,
                         int base, int extra, int win) {
  using Row = DecRow<VT>;
  constexpr int C = Row::C;
  constexpr int BN = 32 * C;
  extern __shared__ __align__(16) unsigned char smem[];
  float* At = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * BN + lane * C;
  const int s = blockIdx.y;
  const int g_begin = s * base + min(s, extra);
  const int g_end = g_begin + base + (s < extra ? 1 : 0);
  const bool live = col < N;
  const bool vec =
      col + C <= N && N % C == 0 &&
      (reinterpret_cast<uintptr_t>(V) & (sizeof(typename Row::Vec) - 1)) == 0 &&
      (reinterpret_cast<uintptr_t>(I) & (C - 1)) == 0;

  float acc[MR][C];
#pragma unroll
  for (int q = 0; q < MR; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[q][c] = 0.f;

  DecBatch<VT, U> b0, b1;
  for (int w0 = g_begin; w0 < g_end; w0 += win) {
    const int w1 = min(g_end, w0 + win);
    const int k0 = w0 * m_group, kw = (w1 - w0) * m_group;
    const int rows = (w1 - w0) * n_keep, r0 = w0 * n_keep;
    const int lo = r0 + rows * warp / kDecWarps;
    const int hi = live ? r0 + rows * (warp + 1) / kDecWarps : lo;
    load_batch<VT, U>(V, I, N, lo, hi, col, vec, b0);  // in flight meanwhile
    __syncthreads();                  // the last window's readers are done
    for (int kk = threadIdx.x; kk < kw; kk += kDecThreads) {
      const int gk = k0 + kk;
#pragma unroll
      for (int q = 0; q < MR; ++q)
        At[kk * MR + q] =
            (q < M && gk < K) ? to_float(A[size_t(q) * K + gk]) : 0.f;
    }
    __syncthreads();
    for (int r = lo; r < hi; r += 2 * U) {
      load_batch<VT, U>(V, I, N, r + U, hi, col, vec, b1);
      use_batch<VT, MR, U>(b0, At, r, hi, n_keep, m_group, w0, acc);
      load_batch<VT, U>(V, I, N, r + 2 * U, hi, col, vec, b0);
      use_batch<VT, MR, U>(b1, At, r + U, hi, n_keep, m_group, w0, acc);
    }
  }

  // the warps' partial sums, reduced in warp order through shared memory
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (warp > 0) {
#pragma unroll
    for (int q = 0; q < MR; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        red[((warp - 1) * MR + q) * BN + lane * C + c] = acc[q][c];
  }
  __syncthreads();
  if (warp > 0 || !live) return;
#pragma unroll
  for (int w = 1; w < kDecWarps; ++w)
#pragma unroll
    for (int q = 0; q < MR; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[q][c] += red[((w - 1) * MR + q) * BN + lane * C + c];
#pragma unroll
  for (int q = 0; q < MR; ++q) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (q >= M || col + c >= N) continue;
      if (split_k > 1) {
        static_cast<float*>(O)[(size_t(s) * M + q) * N + col + c] = acc[q][c];
      } else {
        const size_t at = size_t(q) * N + col + c;
        const float y = acc[q][c] * col_scale(scale, col + c);
        if (out_f32)
          static_cast<float*>(O)[at] = y;
        else
          static_cast<T*>(O)[at] = from_float<T>(y);
      }
    }
  }
}

// out[e] = sum over s = 0, 1, ... of ws[s, e], in that order, from 0, then
// times the scale of e's column (e % N) where SCALED, cast to OT.  A thread
// sums VEC consecutive elements (one 16-byte load a partial where the
// workspace allows it) with kReduceBatch partials' loads issued before the
// first add: at decode the reduction is a few such rounds of latency, not
// bytes, and a round whose adds interleave with its loads keeps one load in
// flight.  The scale is a template argument, so the unscaled kernel carries
// no scale code, and the scaled one loads its VEC scales before the
// partials.
constexpr int kReduceThreads = 256;
constexpr int kReduceBatch = 16;

template <typename OT, int VEC, bool SCALED>
__global__ void __launch_bounds__(kReduceThreads)
    sparse_reduce_kernel(const float* __restrict__ ws,
                         const float* __restrict__ scale, OT* __restrict__ O,
                         int MN, int N, int split_k) {
  constexpr int B = kReduceBatch;
  const int e = (blockIdx.x * kReduceThreads + threadIdx.x) * VEC;
  if (e >= MN) return;
  float sum[VEC];
  [[maybe_unused]] float col[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) sum[v] = 0.f;
  if constexpr (SCALED) {
    int c = e % N;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      col[v] = __ldg(scale + c);
      c = c + 1 == N ? 0 : c + 1;
    }
  }
  for (int s0 = 0; s0 < split_k; s0 += B) {
    float part[B][VEC];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (s0 + j < split_k) {
        const float* src = ws + size_t(s0 + j) * MN + e;
        if constexpr (VEC == 4) {
          const float4 q = __ldcs(reinterpret_cast<const float4*>(src));
          part[j][0] = q.x;
          part[j][1] = q.y;
          part[j][2] = q.z;
          part[j][3] = q.w;
        } else {
          part[j][0] = __ldcs(src);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (s0 + j < split_k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) sum[v] += part[j][v];
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    float y = sum[v];
    if constexpr (SCALED) y *= col[v];
    O[e + v] = from_float<OT>(y);
  }
}

template <typename OT>
cudaError_t launch_reduce(const float* ws, const float* scale, void* o,
                          int mn, int n, int split_k, cudaStream_t stream) {
  OT* O = static_cast<OT*>(o);
  const bool vec = mn % 4 == 0 && (reinterpret_cast<uintptr_t>(ws) & 15) == 0;
  const int per = vec ? 4 : 1;
  const int blocks = (mn / per + kReduceThreads - 1) / kReduceThreads;
#define SPARSE_REDUCE(VEC, SCALED)                                      \
  sparse_reduce_kernel<OT, VEC, SCALED>                                \
      <<<blocks, kReduceThreads, 0, stream>>>(ws, scale, O, mn, n, split_k)
  if (vec && scale)
    SPARSE_REDUCE(4, true);
  else if (vec)
    SPARSE_REDUCE(4, false);
  else if (scale)
    SPARSE_REDUCE(1, true);
  else
    SPARSE_REDUCE(1, false);
#undef SPARSE_REDUCE
  return cudaGetLastError();
}

template <typename T, typename VT, int MR>
cudaError_t launch_decode(const void* a, const void* v, const void* idx,
                          const float* scale, void* o, int out_f32, int M,
                          int N, int K, int n_keep, int m_group, int split_k,
                          int base, int extra, cudaStream_t stream) {
  constexpr int C = DecRow<VT>::C, BN = 32 * C;
  constexpr int U = MR >= 16 ? 2 : 4;
  const int block_groups = base + (extra > 0 ? 1 : 0);
  const int per_group = MR * m_group * static_cast<int>(sizeof(float));
  const int win = max(1, min(block_groups, kDecSmemA / per_group));
  const size_t window = size_t(win) * per_group;
  const size_t reduce = size_t(kDecWarps - 1) * MR * BN * sizeof(float);
  // at most 48 KB (a staged group is at most 16 x 128 x 4 bytes, the
  // reduction 3 x 16 x 256 x 4), so no opt-in attribute is needed
  const size_t smem = window > reduce ? window : reduce;
  const dim3 grid((N + BN - 1) / BN, split_k);
  sparse_decode_kernel<T, VT, MR, U><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const VT*>(v),
      static_cast<const signed char*>(idx), scale, o, out_f32, M, N, K,
      n_keep, m_group, split_k, base, extra, win);
  return cudaGetLastError();
}

bool spec_ok(int K, int Kc, int n_keep, int m_group) {
  return n_keep >= 1 && m_group > n_keep && m_group <= 128 &&
         Kc % n_keep == 0 && (long long)(Kc / n_keep) * m_group >= K &&
         (long long)(Kc / n_keep - 1) * m_group < K;
}

}  // namespace

// The tiled path's menu (BM, BK, BN), compiled for both dtypes of A, each
// with values of A's type and int8 values.  TILES in
// repro_torch/kernels/sparse_gemm.py is the same list (a test reads this
// macro to hold the two together).
#define SPARSE_TILES(X) \
  X(16, 128, 64)        \
  X(32, 128, 128)       \
  X(64, 128, 128)       \
  X(128, 128, 128)

// The decode path's row buckets MR (M <= MR), compiled as the menu is;
// DECODE_ROWS in the wrapper is the same list.
#define SPARSE_DECODE_ROWS(X) \
  X(4)                        \
  X(8)                        \
  X(16)

extern "C" {

// dtype: 0 = bf16, 1 = f32, A's type (and the output's); int8_values: 1 for
// int8 values, 0 for values of A's type.  scale: N f32 column scales or null
// (applied where the output is written).  out_f32: 1 writes the f32
// accumulator, 0 writes it rounded to A's type.  Kc is the compressed row
// count, ceil(K / m_group) * n_keep.  Each entry returns the
// CUDA error of its launch (0 on success), -1 for a tile or row bucket that
// is not on the menu, or cudaErrorInvalidValue for arguments the kernel
// cannot take.

// The tiled path at tile (bm, bk, bn) with `stages` (1 or 2) shared-memory
// stages.
int sparse_gemm_launch(int dtype, int int8_values, int bm, int bk, int bn,
                       const void* a, const void* values, const void* indices,
                       const float* scale, void* o, int out_f32, int M, int N,
                       int K, int Kc, int n_keep, int m_group, int stages,
                       void* stream) {
  if (!spec_ok(K, Kc, n_keep, m_group) || m_group > bk ||
      (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPARSE_TILED(T, VT, BM, BK, BN)                                    \
  launch_tiled<T, VT, BM, BK, BN>(a, values, indices, scale, o, out_f32, M, \
                                  N, K, Kc, n_keep, m_group, stages, s)
#define SPARSE_DISPATCH(BM, BK, BN)                                        \
  if (bm == BM && bk == BK && bn == BN)                                    \
    return static_cast<int>(                                               \
        dtype == 0                                                         \
            ? (int8_values                                                 \
                   ? SPARSE_TILED(__nv_bfloat16, signed char, BM, BK, BN)  \
                   : SPARSE_TILED(__nv_bfloat16, __nv_bfloat16, BM, BK,    \
                                  BN))                                     \
            : (int8_values ? SPARSE_TILED(float, signed char, BM, BK, BN)  \
                           : SPARSE_TILED(float, float, BM, BK, BN)));
  SPARSE_TILES(SPARSE_DISPATCH)
#undef SPARSE_DISPATCH
#undef SPARSE_TILED
  return -1;
}

// The decode path's first kernel at row bucket `rows` (M <= rows): with
// split_k == 1 it writes `o` (the output), else the f32 partials of the
// (split_k, M, N) workspace `o`.  Split s takes base + (s < extra) groups
// from s * base + min(s, extra) (base * split_k + extra == the groups).
// With split_k > 1 the scale belongs to the reduction: it must be null here.
int sparse_decode_launch(int dtype, int int8_values, int rows, const void* a,
                         const void* values, const void* indices,
                         const float* scale, void* o, int out_f32, int M,
                         int N, int K, int Kc, int n_keep, int m_group,
                         int split_k, int base, int extra, void* stream) {
  if (!spec_ok(K, Kc, n_keep, m_group) || M < 1 || M > rows ||
      split_k < 1 || split_k > 65535 || extra < 0 || extra >= split_k ||
      base < 0 || (long long)base * split_k + extra != Kc / n_keep ||
      (base == 0 && extra == 0) || (split_k > 1 && scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPARSE_DECODE(T, VT, MR)                                           \
  launch_decode<T, VT, MR>(a, values, indices, scale, o, out_f32, M, N, K,  \
                           n_keep, m_group, split_k, base, extra, s)
#define DECODE_DISPATCH(MR)                                                \
  if (rows == MR)                                                          \
    return static_cast<int>(                                               \
        dtype == 0                                                         \
            ? (int8_values ? SPARSE_DECODE(__nv_bfloat16, signed char, MR) \
                           : SPARSE_DECODE(__nv_bfloat16, __nv_bfloat16,   \
                                           MR))                            \
            : (int8_values ? SPARSE_DECODE(float, signed char, MR)         \
                           : SPARSE_DECODE(float, float, MR)));
  SPARSE_DECODE_ROWS(DECODE_DISPATCH)
#undef DECODE_DISPATCH
#undef SPARSE_DECODE
  return -1;
}

// The decode path's second kernel: o (mn elements, rows of n) = the sum of
// the workspace's split_k partials in split order, times the column's scale
// if `scale` is not null, in f32 or the operand dtype.
int sparse_reduce_launch(int dtype, const void* ws, const float* scale,
                         void* o, int out_f32, int mn, int n, int split_k,
                         void* stream) {
  if (mn < 1 || n < 1 || mn % n || split_k < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  return static_cast<int>(
      dtype == 0 && !out_f32
          ? launch_reduce<__nv_bfloat16>(w, scale, o, mn, n, split_k, s)
          : launch_reduce<float>(w, scale, o, mn, n, split_k, s));
}

}  // extern "C"
