// Flash attention for Hopper (sm_90a): softmax(q k^T / sqrt(D)) v with the
// online softmax of the TPU kernel, for bf16 and f32 inputs at any head dim.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_tpu (:97), body _kernel (:36)  -> flash_wgmma_kernel
//                                                     (bf16 that TMA can
//                                                     describe, D <= 256),
//                                                     flash_sync_kernel (the
//                                                     rest)
//
// Layouts (all contiguous): q and out (B*H, Sq, D); k and v (B*H, Sk, D).
// GQA heads are expanded by the caller, as for the TPU kernel.
//
// The TPU kernel runs a sequential grid (B*H, nq, nk) and carries the
// online-softmax state (m, l, acc) in scratch across the nk steps.  Here a
// block owns a range of query rows of one (batch, head) and walks the keys
// inside the block; the state of each row stays in registers.  Rows past Sq
// are not written and keys past Sk take no part (weight exactly 0).
//
// Numerics follow the TPU kernel: masked scores at the finite NEG_INF =
// -1e30, no guard for fully masked rows, and the denominator clamped at
// 1e-30.  With a finite NEG_INF a fully masked block still adds exp(0) = 1
// terms to a row that has seen no live key yet, which a later live block's
// correction wipes out exactly.  So a block of keys is skipped only where it
// is fully masked for all of the rows at hand AND each of those rows has a
// live key somewhere: then the skip is exact.  Rows without any live key (a
// window that outruns the keys) walk every block and average v, as the TPU
// kernel does.
//
// Two routes, chosen by the wrapper before the launch from dtype, D and the
// base addresses (kernels/flash_attention.py flash_route):
//
//   wgmma  bf16 with D % 8 == 0 (TMA's 16-byte row stride), D <= 256 and
//          16-byte-aligned q, k, v.  A CTA covers 128 query rows of one
//          (batch, head): two consumer warpgroups of 64 rows and a producer
//          warpgroup, whose registers setmaxnreg hands to the consumers (an
//          m64n256 f32 O fragment is 128 registers a thread).  One producer
//          thread loads Q once and K, V through a ring of kKvStages stages
//          of bk keys (`full` and `empty` mbarriers for K and for V apart,
//          so that K frees as soon as S is done), all by TMA with 128-byte
//          swizzle in boxes of 64 head-dim columns.  The head dim is padded
//          in shared memory to DP = 64, 128 or 256 by TMA's zero fill; boxes
//          wholly past D are not loaded.  S = Q K^T is wgmma with both
//          operands K-major from shared memory over ceil(D / 16) k16 steps
//          (the padding is never read); the online softmax runs on the f32
//          accumulator fragment (row max and sum over a quad of lanes; the
//          1/sqrt(D) scale and log2(e) folded into one FFMA before ex2 on
//          tiles without a mask); P goes to bf16 in registers and O += P V
//          is wgmma in the RS form, V read N-major from the stage.  Only
//          tiles that straddle the diagonal, the window's edge or Sk are
//          masked.  The two warpgroups take turns to issue their products
//          (named barriers), so that one's softmax runs under the other's
//          products.  The epilogue stores O / max(l, 1e-30) in bf16 straight
//          from registers, rows < Sq and columns < D.  P in bf16 is the one
//          departure from the TPU kernel's f32 p @ v.
//   sync   f32, and bf16 that the wgmma route does not take: the first
//          version of this kernel, generalised to any D.  A 128-thread block
//          owns bq query rows, takes them 64 at a time and walks the keys in
//          blocks of bk, 64 keys a step, in f32 FFMA on a 4 x 8 register
//          micro-tile from padded shared memory (q scaled in f32, no TF32).
//          Q K^T is summed over the head dim in chunks of kKC columns (q
//          stays resident when D <= kKC), and the grid's third dimension
//          covers V's columns in passes of DV <= 128, each pass recomputing
//          S and its (m, l): the same arithmetic.
//
// What bounds it on an H100: operations at the main-path shape (4 x 12 heads
// x 512 x 512 x 128 causal is 1.6 x 10^9 multiply-adds in its two products
// against 25 MB of q, k, v and out).  The wgmma route runs the products on the
// tensor cores with every K/V load in flight behind the math of the stage
// before it.  What it leaves: within a warpgroup S, its softmax and P V run
// in sequence (the turns overlap one warpgroup's softmax with the other's
// products only), every CTA reads its (b, h)'s K and V again from L2 (128
// query rows a CTA), the causal grid's short CTAs leave a part-empty last
// wave (the longest row ranges are launched first), and the output is
// stored from registers, not by TMA.

// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry points are at the end of this file.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

// The wgmma route's tiles: (padded head dim DP, keys a ring stage).
// WGMMA_TILES in repro_torch/kernels/flash_attention.py is the same map.
#define FLASH_WGMMA_TILES(X) X(64, 128) X(128, 128) X(256, 64)

// The sync route's output widths DV (columns of V a pass); SYNC_WIDTHS in
// repro_torch/kernels/flash_attention.py is the same list.
#define FLASH_SYNC_WIDTHS(X) X(32) X(64) X(128)

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// The wgmma route
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;          // query rows a CTA (WGMMA_ROWS)
constexpr int kKvStages = 2;          // K/V ring stages (KV_STAGES)
constexpr int kWgThreads = 3 * 128;   // two consumer warpgroups, a producer
constexpr int kProducerRegs = 24;     // setmaxnreg budgets (a thread)
constexpr int kConsumerRegs = 240;

template <int DP>
struct WgTile;
#define FLASH_WG_TILE(DP, BK)     \
  template <>                     \
  struct WgTile<DP> {             \
    static constexpr int bk = BK; \
  };
FLASH_WGMMA_TILES(FLASH_WG_TILE)
#undef FLASH_WG_TILE

// Shared memory of one CTA: 1 KB to align, Q (DP / 64 boxes of 128 rows x
// 128 bytes), kKvStages stages each of K then V (DP / 64 boxes of bk rows x
// 128 bytes each), then the mbarriers: q_full, and k_full, v_full, k_empty
// and v_empty a stage.  Every box is 1024-byte aligned (the swizzle's
// atom).  flash_attention.wgmma_smem_bytes mirrors this.
template <int DP>
struct FlashSmem {
  static constexpr int bk = WgTile<DP>::bk;
  static constexpr int q_box = kWgRows * 128;
  static constexpr int kv_box = bk * 128;
  static constexpr int q_bytes = DP / 64 * q_box;
  static constexpr int kv_bytes = DP / 64 * kv_box;  // K or V of a stage
  static constexpr int stage = 2 * kv_bytes;
  static constexpr size_t bytes = 1024 + q_bytes + size_t(kKvStages) * stage +
                                  (1 + 4 * kKvStages) * sizeof(uint64_t);
  static_assert(bytes <= 232448, "the CTA exceeds a block's 227 KB");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x on the special-function unit (ex2.approx.ftz: -inf gives 0, and
// some 2 ulp, far inside the bf16 rounding of P).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving the writes of an RS wgmma's A fragment past
// the wgmma.fence that must follow them, and from reusing its registers
// before the wgmma that reads them has finished.
template <int R>
__device__ __forceinline__ void fence_fragment(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The two consumer warpgroups take turns to issue their products, so that
// one's softmax runs under the other's products: named barrier 1 + w is
// warpgroup w's turn.  `turn` waits for it, `pass` hands the turn over.
__device__ __forceinline__ void turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// Issue S = Q K^T for one warpgroup into e (zeroed first), both operands
// K-major: 128-byte rows, 8-row groups 1024 bytes apart, the k16 step 32
// bytes along the row, 64 columns a box.  Commits the group; no wait.
template <int BK, int QBOX, int KVBOX>
__device__ __forceinline__ void issue_scores(float (&e)[BK / 2],
                                             const unsigned char* qa,
                                             const unsigned char* ks,
                                             int ksteps) {
#pragma unroll
  for (int x = 0; x < BK / 2; ++x) e[x] = 0.f;
  fence_accumulator(e);
  wgmma_fence();
  for (int kk = 0; kk < ksteps; ++kk)
    Wgmma<BK, 0>::mma(
        e, wgmma_desc(qa + (kk >> 2) * QBOX + (kk & 3) * 32, 16, 1024),
        wgmma_desc(ks + (kk >> 2) * KVBOX + (kk & 3) * 32, 16, 1024));
  wgmma_commit();
}

// Issue O += P V from the bf16 fragment pa, V N-major: 16 rows (2048 bytes)
// a k16 step, 8-row groups 1024 bytes apart, 64-column boxes KVBOX apart.
// Commits the group; no wait.
template <int DP, int BK, int KVBOX>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         uint32_t (&pa)[BK / 16][4],
                                         const unsigned char* vs) {
  fence_fragment(pa);
  fence_accumulator(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    WgmmaRS<DP>::mma(o, pa[kk], wgmma_desc(vs + kk * 2048, KVBOX, 1024));
  wgmma_commit();
}

// The online softmax of one tile's scores e (f32, the accumulator fragment)
// in the exp2 domain (m holds row maxima of s / sqrt(D) x log2(e)): masks
// where `edge` (a tile at the diagonal, the window's edge or past Sk), the
// rows' new maxima over a quad of lanes, corr = 2^(m_old - m_new), l scaled
// by corr plus the tile's p; e becomes p, packed into the bf16 fragment pa.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&e)[BK / 2],
                                             uint32_t (&pa)[BK / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c,
                                             bool edge, int k0, int tq,
                                             int row0, int sk, int causal,
                                             int window) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (!edge) {  // no masks: the maxima of the raw scores, scaled once
#pragma unroll
    for (int x = 0; x < BK / 2; ++x)
      mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], e[x]);
    mx[0] *= c;
    mx[1] *= c;
  } else {  // scaled scores, masked
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = k0 + 8 * j + 2 * tq + (x & 1);
        const int row = row0 + 8 * (x >> 1);
        float y = e[4 * j + x] * c;
        if (col >= sk)
          y = -INFINITY;  // no such key: weight exactly 0
        else if ((causal && col > row) || (window > 0 && row - col >= window))
          y = kNegInf;
        e[4 * j + x] = y;
        mx[x >> 1] = fmaxf(mx[x >> 1], y);
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = fast_exp2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];  // this lane's share; the quad sums it at the end
  }
  if (!edge) {  // p = 2^(s c - m), the scale folded into one FFMA
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      const float p = fast_exp2(fmaf(e[x], c, -m[(x >> 1) & 1]));
      e[x] = p;
      l[(x >> 1) & 1] += p;
    }
  } else {
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      const float p = fast_exp2(e[x] - m[(x >> 1) & 1]);
      e[x] = p;
      l[(x >> 1) & 1] += p;
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = pack_bf16(e[8 * kk + 2 * x], e[8 * kk + 2 * x + 1]);
}

// One CTA: query rows [q0, q0 + 128) of (batch, head) z, the longest causal
// row ranges first (block b takes row tile nq - 1 - b / bh).  Threads 0-255
// are the consumer warpgroups (warpgroup w rows q0 + 64 w ..), threads
// 256-383 the producer warpgroup, of which one thread issues every TMA
// load; setmaxnreg moves the producer's registers to the consumers.  Every
// mbarrier wait traps after about 10 s (mbar_wait).
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ,
                       const __grid_constant__ CUtensorMap tmK,
                       const __grid_constant__ CUtensorMap tmV,
                       __nv_bfloat16* __restrict__ out, int d, int bh, int sq,
                       int sk, int causal, int window) {
  using L = FlashSmem<DP>;
  constexpr int BK = L::bk, NS = kKvStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = qs + L::q_bytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + NS * L::stage);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NS;
  uint64_t* k_empty = v_full + NS;
  uint64_t* v_empty = k_empty + NS;

  const int nq = (sq + kWgRows - 1) / kWgRows;
  const int z = blockIdx.x % bh;
  const int q0 = (nq - 1 - int(blockIdx.x / bh)) * kWgRows;
  const int qe = min(q0 + kWgRows, sq);
  const int n_tiles = (sk + BK - 1) / BK;
  // The CTA's KV tiles: where every row in range has a live key (the last
  // row is the hardest), the tiles fully masked for all of them are
  // skipped, an exact 0 (see above); they lie before t_begin (the window)
  // and from t_end on (causal).
  const bool rows_live = window <= 0 || qe - 1 <= sk + window - 2;
  int t_begin = 0, t_end = n_tiles;
  if (rows_live) {
    if (causal) t_end = min(n_tiles, (qe + BK - 1) / BK);
    if (window > 0 && q0 - window + 1 > 0) t_begin = (q0 - window + 1) / BK;
  }
  const int boxes = (d + 63) / 64;  // boxes that hold a column of the head

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&k_full[s], 1);  // the producer's arrival, plus the bytes
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, boxes * L::q_box);
      for (int j = 0; j < boxes; ++j)
        tma_load_3d(qs + j * L::q_box, &tmQ, 64 * j, q0, z, q_full);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % NS;
        const uint32_t parity = ((i / NS) - 1) & 1;
        unsigned char* ks = ring + s * L::stage;
        if (i >= NS) mbar_wait(&k_empty[s], parity);  // both warpgroups
        mbar_expect_tx(&k_full[s], boxes * L::kv_box);  // are done with it
        for (int j = 0; j < boxes; ++j)
          tma_load_3d(ks + j * L::kv_box, &tmK, 64 * j, t * BK, z,
                      &k_full[s]);
        if (i >= NS) mbar_wait(&v_empty[s], parity);
        mbar_expect_tx(&v_full[s], boxes * L::kv_box);
        for (int j = 0; j < boxes; ++j)
          tma_load_3d(ks + L::kv_bytes + j * L::kv_box, &tmV, 64 * j, t * BK,
                      z, &v_full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // A consumer warpgroup.  The accumulator fragments: warp w of the
  // warpgroup holds rows 16 w .. 16 w + 15, lane l rows l / 4 and l / 4 + 8,
  // columns 8 j + 2 (l % 4) and the next (values 4 j .. 4 j + 3: the pair of
  // the first row, then the pair of the second).
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int w0 = q0 + wg * 64;             // the warpgroup's first row
  const int wlast = min(w0 + 63, sq - 1);  // its last row in range
  const int row0 = w0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const float c = 1.4426950408889634f / sqrtf(static_cast<float>(d));
  const int ksteps = (d + 15) / 16;  // k16 steps of S that hold the head
  const unsigned char* qa = qs + wg * 64 * 128;
  const bool lead = lane == 0;  // each consumer warp arrives on its own
  // The warpgroup's live tiles [a, b): where each of its rows has a live
  // key, the tiles fully masked for all of them are an exact 0 (no math);
  // a warpgroup without rows in range has none.
  int a = t_begin, b = t_end;
  if (wlast < w0) {
    b = a;
  } else if (rows_live) {
    if (window > 0 && w0 - window + 1 > 0)
      a = max(a, (w0 - window + 1) / BK);
    if (causal) b = min(b, wlast / BK + 1);
  }

  float o[DP / 2];
#pragma unroll
  for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float e[BK / 2];
  uint32_t pa[BK / 16][4];
  mbar_wait(q_full, 0);
  if (wg == 1) pass(wg);  // warpgroup 0 takes the first turn

  // A tile without math: wait for its K and V so that every barrier's
  // phase is followed, free it, keep the turns in step.
  auto skip_tile = [&](int i) {
    const int s = i % NS;
    const uint32_t parity = (i / NS) & 1;
    mbar_wait(&k_full[s], parity);
    mbar_wait(&v_full[s], parity);
    if (lead) {
      mbar_arrive(&k_empty[s]);
      mbar_arrive(&v_empty[s]);
    }
    for (int x = 0; x < 2; ++x) {  // a live tile's two turns: S, P V
      turn(wg);
      pass(wg);
    }
  };

  int i = 0;
  for (int t = t_begin; t < a; ++t, ++i) skip_tile(i);
  for (int t = a; t < b; ++t, ++i) {
    const int s = i % NS;
    const uint32_t parity = (i / NS) & 1;
    const unsigned char* ks = ring + s * L::stage;
    mbar_wait(&k_full[s], parity);
    turn(wg);
    issue_scores<BK, L::q_box, L::kv_box>(e, qa, ks, ksteps);
    pass(wg);
    wgmma_wait<0>();
    fence_accumulator(e);
    if (lead) mbar_arrive(&k_empty[s]);
    // masks only on a tile at the diagonal, the window's edge or Sk
    const int k0 = t * BK;
    const bool edge = (causal && k0 + BK - 1 > w0) ||
                      (window > 0 && w0 + 63 - k0 >= window) || k0 + BK > sk;
    softmax_tile<BK>(e, pa, m, l, corr, c, edge, k0, tq, row0, sk, causal,
                     window);
#pragma unroll
    for (int x = 0; x < DP / 2; ++x) o[x] *= corr[(x >> 1) & 1];
    mbar_wait(&v_full[s], parity);
    turn(wg);
    issue_pv<DP, BK, L::kv_box>(o, pa, ks + L::kv_bytes);
    pass(wg);
    wgmma_wait<0>();
    fence_accumulator(o);
    fence_fragment(pa);
    if (lead) mbar_arrive(&v_empty[s]);
  }
  for (int t = b; t < t_end; ++t, ++i) skip_tile(i);
  if (wg == 0) turn(wg);  // warpgroup 1's last pass
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.0f / fmaxf(l[h], 1e-30f);
  }
  __nv_bfloat16* ob = out + size_t(z) * sq * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (col < d) {  // d is a multiple of 8, so col + 1 < d too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < sq)
          store_pair(ob, size_t(row) * d + col, o[4 * j + 2 * h] * inv[h],
                     o[4 * j + 2 * h + 1] * inv[h]);
      }
    }
  }
}

// The tensor maps are encoded on the host at every call (the operands'
// addresses change); operands TMA cannot describe are refused with
// cudaErrorInvalidValue.
template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int d, int bh, int sq, int sk, int causal,
                         int window, cudaStream_t stream) {
  using L = FlashSmem<DP>;
  if (d % 8 || d > DP ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) &
       15))
    return cudaErrorInvalidValue;
  const long long blocks = (long long)((sq + kWgRows - 1) / kWgRows) * bh;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_bf16_map_3d(&tq, q, bh, sq, d, kWgRows) ||
      !encode_bf16_map_3d(&tk, k, bh, sk, d, L::bk) ||
      !encode_bf16_map_3d(&tv, v, bh, sk, d, L::bk))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes);
  if (attr != cudaSuccess) return attr;
  flash_wgmma_kernel<DP><<<(unsigned)blocks, kWgThreads, L::bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), d, bh, sq, sk, causal,
      window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The sync route
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kQT = 64;   // query rows per sub-tile (SYNC_ROWS)
constexpr int kKT = 64;   // keys per step (SYNC_KEYS)
constexpr int kKC = 128;  // head-dim columns of q and k staged at once
#define FLASH_SYNC_WIDTH(DV) DV,
constexpr int kSyncWidths[] = {FLASH_SYNC_WIDTHS(FLASH_SYNC_WIDTH)};
#undef FLASH_SYNC_WIDTH
// heads wider than this take passes of it
constexpr int kWidest = kSyncWidths[sizeof(kSyncWidths) / sizeof(int) - 1];

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stage 64 rows x `cols` columns of src (row stride d; rows from r0,
// columns from c0) into dst (row stride ld) as f32 times `mul`, a warp a
// row and its lanes along the columns; rows from n on and columns from d
// on are zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src, int d,
                                           int r0, int n, int c0, int cols,
                                           float mul) {
  for (int r = threadIdx.x / 32; r < 64; r += kThreads / 32)
    for (int c = threadIdx.x % 32; c < cols; c += 32)
      dst[r * ld + c] = r0 + r < n && c0 + c < d
                            ? to_float(src[(size_t)(r0 + r) * d + c0 + c]) * mul
                            : 0.0f;
}

// Shared memory: Q (64, kKC+1), K (64, kKC+1), V (64, DV), P (64, 65), all
// f32.  flash_attention.sync_smem_bytes mirrors this.
template <int DV>
constexpr size_t sync_smem_bytes() {
  return (size_t)(kQT * (kKC + 1) + kKT * (kKC + 1) + kKT * DV +
                  kQT * (kKT + 1)) *
         4;
}

// Grid (B*H, ceil(Sq / bq), ceil(D / DV)).  Thread t owns query rows
// 4 * (t / 8) .. +3 of the sub-tile; for scores it owns key columns
// (t % 8) + 8 j, j < 8, and for the output the pass's columns (t % 8) + 8 j,
// j < DV / 8.  The 8 threads that share rows are neighbouring lanes, so row
// maxima and sums reduce with three shuffles.
template <typename T, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_sync_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out, int d,
                      int sq, int sk, int bq, int bk, int causal,
                      int window) {
  constexpr int CP = kKC + 1, KP = kKT + 1, DJ = DV / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kQT * CP;
  float* vs = ks + kKT * CP;
  float* ps = vs + kKT * DV;

  const size_t bh = blockIdx.x;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * sk * d;
  const T* vb = v + bh * sk * d;
  T* ob = out + bh * sq * d;
  const int tid = threadIdx.x, tx = tid & 7, r0 = (tid >> 3) * 4;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const int q_begin = blockIdx.y * bq;
  const int q_end = min(q_begin + bq, sq);
  const int c0 = blockIdx.z * DV;  // this pass's output columns
  const bool q_resident = d <= kKC;

  for (int qa = q_begin; qa < q_end; qa += kQT) {
    const int qe = min(qa + kQT, q_end);
    if (q_resident)
      stage_rows(qs, CP, qb, d, qa, qe, 0, d, scale);
    float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m_i[i] = kNegInf;
      l_i[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
    }
    // every row of the sub-tile has a live key (the last row is the hardest)
    const bool rows_live = window <= 0 || qe - 1 <= sk + window - 2;

    for (int kb0 = 0; kb0 < sk; kb0 += bk) {
      const int kbe = min(kb0 + bk, sk);
      if (rows_live && ((causal && kb0 > qe - 1) ||
                        (window > 0 && qa - (kbe - 1) >= window)))
        continue;  // fully masked for every row: an exact 0 (see above)
      for (int kt = kb0; kt < kbe; kt += kKT) {
        const int kte = min(kt + kKT, kbe);
        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
        for (int d0 = 0; d0 < d; d0 += kKC) {
          const int dc = min(kKC, d - d0);
          __syncthreads();  // the previous readers are done
          if (!q_resident) stage_rows(qs, CP, qb, d, qa, qe, d0, dc, scale);
          stage_rows(ks, CP, kb, d, kt, kte, d0, dc, 1.0f);
          if (d0 == 0) stage_rows(vs, DV, vb, d, kt, kte, c0, DV, 1.0f);
          __syncthreads();
#pragma unroll 4
          for (int e = 0; e < dc; ++e) {
            float qv[4], kv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = qs[(r0 + i) * CP + e];
#pragma unroll
            for (int j = 0; j < 8; ++j) kv[j] = ks[(tx + 8 * j) * CP + e];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
          }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = qa + r0 + i;
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int kj = kt + tx + 8 * j;
            if (kj >= kte) {
              s[i][j] = -INFINITY;  // no such key: weight exactly 0
            } else {
              bool ok = true;
              if (causal) ok = ok && kj <= qi;
              if (window > 0) ok = ok && qi - kj < window;
              if (!ok) s[i][j] = kNegInf;
            }
            mx = fmaxf(mx, s[i][j]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          const float m_new = fmaxf(m_i[i], mx);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float p = expf(s[i][j] - m_new);
            ps[(r0 + i) * KP + tx + 8 * j] = p;
            sum += p;
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          const float corr = expf(m_i[i] - m_new);
          l_i[i] = l_i[i] * corr + sum;
          m_i[i] = m_new;
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < kKT; ++c) {
          float pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = ps[(r0 + i) * KP + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            const float vv = vs[c * DV + tx + 8 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qa + r0 + i;
      if (qi < qe) {
        const float inv = 1.0f / fmaxf(l_i[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const int col = c0 + tx + 8 * j;
          if (col < d) ob[(size_t)qi * d + col] = from_float<T>(acc[i][j] * inv);
        }
      }
    }
    __syncthreads();  // Q of the next sub-tile overwrites shared memory
  }
}

template <typename T, int DV>
cudaError_t launch_sync(const void* q, const void* k, const void* v,
                        void* out, int d, int bh, int sq, int sk, int bq,
                        int bk, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = sync_smem_bytes<DV>();
  const int q_tiles = (sq + bq - 1) / bq, passes = (d + DV - 1) / DV;
  if (q_tiles > 65535 || passes > 65535) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_sync_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  flash_sync_kernel<T, DV><<<dim3(bh, q_tiles, passes), kThreads, smem,
                             stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), d, sq, sk, bq, bk,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The wgmma route: bf16 q, k, v (16-byte-aligned bases) and out, D % 8 == 0,
// D <= 256 (padded to the least DP of FLASH_WGMMA_TILES that holds it);
// bh = B * H.  Returns the CUDA error of the launch (0 on success),
// cudaErrorInvalidValue for operands TMA cannot describe, or -1 for a head
// dim past the widest tile.
int flash_wgmma_launch(int d, const void* q, const void* k, const void* v,
                       void* out, int bh, int sq, int sk, int causal,
                       int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_WGMMA_DISPATCH(DP, BK)                                     \
  if (d <= DP)                                                           \
    return static_cast<int>(launch_wgmma<DP>(q, k, v, out, d, bh, sq, sk, \
                                             causal, window, s));
  FLASH_WGMMA_TILES(FLASH_WGMMA_DISPATCH)
#undef FLASH_WGMMA_DISPATCH
  return -1;
}

// The sync route: dtype 0 = bf16, 1 = f32 (q, k, v and the output share
// it), any D >= 1 (passes of the least DV of FLASH_SYNC_WIDTHS that holds
// it, or of the widest); each block owns bq query rows and walks the keys
// in blocks of bk.  Returns the CUDA error of the launch (0 on success).
int flash_sync_launch(int dtype, int d, const void* q, const void* k,
                      const void* v, void* out, int bh, int sq, int sk,
                      int bq, int bk, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh < 1 || sq < 1 || sk < 1 || bq < 1 || bk < 1 || d < 1 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_SYNC_DISPATCH(DV)                                               \
  if (d <= DV || DV == kWidest)                                              \
    return static_cast<int>(                                                 \
        dtype == 0 ? launch_sync<__nv_bfloat16, DV>(q, k, v, out, d, bh, sq, \
                                                    sk, bq, bk, causal,      \
                                                    window, s)               \
                   : launch_sync<float, DV>(q, k, v, out, d, bh, sq, sk, bq, \
                                            bk, causal, window, s));
  FLASH_SYNC_WIDTHS(FLASH_SYNC_DISPATCH)
#undef FLASH_SYNC_DISPATCH
  return -1;
}

}  // extern "C"
