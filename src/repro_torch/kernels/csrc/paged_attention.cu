// Paged-attention decode for Hopper (sm_90a): one query token per slot
// attends its first kv_len logical rows, which live in a page pool behind
// the slot's block table.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention.py:
//   paged_attention_tpu (:195), body _kernel (:96)  -> paged_decode_kernel
// in both of its forms: float pools, and int8 pools (`quantized=True`)
// with their per-row scale pools.
//
// Layouts (all contiguous): q and out (B, 1, H, D); the k and v pools
// (P, page, KV, D); for int8 pools the k and v scale pools (P, page, KV)
// f32; block tables (B, n_bt) int32 with -1 for a hole; kv_len (B,) int32.
// Head h of the query belongs to KV head h / G (G = H / KV).
//
// The TPU kernel walks a sequential grid (B, KV, n_bt), carrying the
// online-softmax state (m, l, acc) in scratch from one page to the next.
// Here each (slot, KV head) is a thread-block cluster of C blocks (grid
// (C, B, KV), cluster (C, 1, 1), C from the shapes alone:
// paged_attention.splits_for), and the slot's pages are split across it:
//   1. each block stages the slot's block-table row in shared memory while
//      it reads kv_len and q; n_live = min(ceil(kv_len / page), n_bt), and
//      rank r takes its own contiguous, in-order range of at most
//      ceil(n_live / C) live pages (page_range below); a rank with no page
//      still crosses both cluster barriers;
//   2. its pages stream through a ring of kStages stages (fewer, at least
//      two, where they would not fit; `ppc` whole pages a stage, up to
//      paged_attention.STAGE_BYTES of K and V rows) by 16-byte cp.async,
//      the next stages' K and V rows (and an int8 pool's k and v scales)
//      loading while the current stage is scored (a head dim that takes no
//      16-byte vector, or a pool at a misaligned base, copies by plain
//      loads);
//   3. the math runs from registers on the FFMA units: a row group of
//      lanes_per_row(d) lanes owns one row at a time, each lane 8 elements
//      of the head dim, with q (scaled by 1/sqrt(D) and rounded to the
//      input type, then f32, as the plain version scales it) and the
//      accumulators of HN query heads (heads_per_group: the G heads in
//      chunks, each chunk its own warps) in registers; scores come from a
//      shuffle reduction over the group, K and V from vector shared loads
//      (a group reads one row's contiguous bytes, so no bank conflicts).
//      Every group keeps its own online softmax (m, l, acc) over its rows,
//      kRows rows a step, with the m == NEG_INF guard; l sums the unscaled
//      p, and only then does an int8 pool multiply p by its row's v scale
//      (the TPU kernel's order); a row past kv_len adds an exact 0, as
//      in the TPU kernel, and pages past ceil(kv_len / page) are not read;
//   4. a warp's groups combine by shuffles, the warps' partials go to
//      shared memory, and the block combines them per head in a fixed
//      order into its partial (m, l, acc) for the G heads, kept in its own
//      shared memory;
//   5. after a cluster barrier, rank r combines its slice of the G x D
//      outputs from all C partials, read through distributed shared
//      memory in rank order: M = max m_r, w_r = 0 for a dead rank else
//      exp(m_r - M), o = sum w_r acc_r / max(sum w_r l_r, 1e-30) (every
//      rank dead gives exact zeros), written in q's dtype; a second cluster
//      barrier keeps every block's shared memory alive until its peers
//      have read it.
// One launch a call, no workspace, no atomics: every sum has a fixed
// order, so two launches on the same inputs give the same bits.  Holes
// clamp to page 0 and table entries past the pool to its last page, on the
// row pools and the scale pools alike, so no read leaves a pool.
//
// What bounds it on an H100: latency, then bytes.  The work is 4 x G x D
// operations per row against 2 x D pool bytes (about 6 a byte in bf16),
// far below the FFMA line (~20), so no tensor core is used (the f32
// variants' 1e-4 tolerance also rules out TF32).  A decode batch has few
// (slot, KV head) pairs, so a block per pair leaves most of the 132 SMs
// idle and walks a long slot's pages one after another; the split puts
// about 132 blocks on the card, two of them fit an SM (so all 16 clusters
// of 8 of qwen2-1.5b's decode tick are resident at once), the ring keeps
// up to kStages x 16 KB of each block's pages in flight, and the combine
// costs two cluster barriers.
//
// Built by repro_torch/kernels/_build.py with plain nvcc and loaded through
// ctypes; the C entry points are at the end of this file.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;          // ring stages, fewer (>= 2) for big pages
constexpr int kLaneElems = 8;       // head-dim elements a lane owns
constexpr int kMaxHeadDim = 32 * kLaneElems;
constexpr int kMaxSplits = 8;       // the portable cluster size
constexpr int kSmemLimit = 232448;  // shared memory a block may use (227 KB)
constexpr int kRows = 2;            // rows a group scores per step
constexpr float kNegInf = -1e30f;

// The softmax's exponential.
__device__ __forceinline__ float ex(float x) {
  float y;  // 2^(x log2 e) on the SFU; results below 2^-126 flush to 0
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_float<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Eight consecutive elements as f32, by vector loads (the first element
// 8-element aligned).
__device__ __forceinline__ void unpack8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void unpack8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * i)));
    x[4 + i] = static_cast<float>(static_cast<int8_t>(u.y >> (8 * i)));
  }
}

// A lane's elements e0 .. e0 + 7 of `row` (zeros where `live` is false or
// past d); VEC: vector loads (d % 8 == 0), else scalar loads.
template <typename P, bool VEC>
__device__ __forceinline__ void load8(const P* row, int e0, int d, bool live,
                                      float (&x)[8]) {
  if (VEC && live && e0 < d) {
    unpack8(row + e0, x);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    x[e] = (!VEC && live && e0 + e < d) ? to_float(row[e0 + e]) : 0.0f;
}

// cp.async (sm_80+): copies from device to shared memory that hold no
// register while in flight; a group per ring stage.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` (0 .. kStages - 2) of this thread's newest
// groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Lanes that share one row: ceil(d / 8) rounded up to a power of two
// (d <= kMaxHeadDim, so at most a warp).
__host__ __device__ inline int lanes_per_row(int d) {
  const int need = (d + kLaneElems - 1) / kLaneElems;
  int lpr = 1;
  while (lpr < need) lpr <<= 1;
  return lpr;
}

// Query heads a row group holds in registers, HN in 2..4: the KV head's
// G heads split into ceil(G / HN) chunks, with the fewest padded heads and
// then the fewest chunks (paged_attention.heads_per_group mirrors it).
__host__ __device__ inline int heads_per_group(int g) {
  int best = 2, waste = 1 << 30, chunks = 1 << 30;
  for (int hn = 2; hn <= 4; ++hn) {
    const int c = (g + hn - 1) / hn, w = c * hn - g;
    if (w < waste || (w == waste && c < chunks)) {
      best = hn;
      waste = w;
      chunks = c;
    }
  }
  return best;
}

// Shared memory (paged_attention.smem_bytes mirrors it), every piece
// 16-byte aligned: the block's partial, m (G,) | l (G,) | acc (G, d), f32
// | the slot's block-table row, clamped, (n_bt,) int32 | the work region:
// the ring of `stages` stages, each K rows (R, d) P | V rows (R, d) P |
// int8 pools: k scales, v scales (R,) f32; after the walk the same bytes
// hold the warps' partials, kWarps x (m (HN,) | l (HN,) | acc (HN, d))
// f32.
struct Layout {
  size_t tab, work, v, ks, vs, stage, total;
};
__host__ __device__ inline Layout layout(int g, int hn, int d, int rows,
                                         int pool_bytes, bool quant,
                                         int stages, int n_bt) {
  Layout s;
  s.tab = align16((size_t)g * (d + 2) * 4);
  s.work = s.tab + align16((size_t)n_bt * 4);
  const size_t rows_bytes = align16((size_t)rows * d * pool_bytes);
  const size_t scales = quant ? align16((size_t)rows * 4) : 0;
  s.v = rows_bytes;
  s.ks = 2 * rows_bytes;
  s.vs = s.ks + scales;
  s.stage = s.vs + scales;
  const size_t ring = stages * s.stage;
  const size_t red = (size_t)kWarps * hn * (d + 2) * 4;
  s.total = s.work + (ring > red ? ring : red);
  return s;
}

// The live pages [begin, end) of rank `rank` of `splits`: contiguous, in
// order, at most ceil(n_live / splits) each (tests/test_torch_attention.py
// mirrors it).
__device__ __forceinline__ void page_range(int n_live, int splits, int rank,
                                           int* begin, int* end) {
  const int per = (n_live + splits - 1) / splits;
  *begin = min(rank * per, n_live);
  *end = min(*begin + per, n_live);
}

// T: q and out (bf16 or f32); P: the pools (T, or int8_t under QUANT).
// VEC: the rows copy by 16-byte cp.async and a lane's 8 elements (of q,
// and of a K or V row in shared memory) are vector loads (d % 8 == 0,
// d x sizeof(P) % 16 == 0, q and the pools 16-byte aligned), else plain
// loads and scalar loads.  HN: the query heads of a row group
// (heads_per_group); a head past G is padding, with q = 0, never written.
template <typename T, typename P, bool QUANT, bool VEC, int HN>
__global__ void __launch_bounds__(kThreads, 2)
    paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                        const P* __restrict__ vp,
                        const float* __restrict__ ksp,
                        const float* __restrict__ vsp,
                        const int* __restrict__ bt,
                        const int* __restrict__ kv_len, T* __restrict__ out,
                        int kv, int g, int d, int n_pool, int page, int n_bt,
                        int ppc, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y, kvh = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = lanes_per_row(d);
  const int e0 = (lane % lpr) * kLaneElems;
  // a warp's row groups hold the heads chunk * HN .. + HN - 1 of one chunk
  // and walk row slots `slot` of it; warps past wpc x chunks idle
  const int chunks = (g + HN - 1) / HN;
  const int wpc = kWarps / chunks;  // warps a chunk
  const int chunk = warp % chunks;
  const int slot = (warp / chunks) * (32 / lpr) + lane / lpr;
  const int slots = wpc * (32 / lpr);
  const bool walks = warp < wpc * chunks;
  const size_t head0 = ((size_t)b * kv + kvh) * g;  // (slot, head) of head 0
  const Layout lay =
      layout(g, HN, d, ppc * page, sizeof(P), QUANT, stages, n_bt);
  float* part = reinterpret_cast<float*>(smem);
  int* tab = reinterpret_cast<int*>(smem + lay.tab);
  unsigned char* work = smem + lay.work;

  // 1. the table row (clamped: holes to page 0, entries past the pool to
  //    its last page), q (scaled, rounded to T, then f32) and kv_len, all
  //    loads in flight at once
  const int* table = bt + (size_t)b * n_bt;
  auto clamp = [&](int p) {
    return p < 0 ? 0 : (p >= n_pool ? n_pool - 1 : p);
  };
  const int len = kv_len[b];
  const int first = tid < n_bt ? table[tid] : 0;
  float qr[HN][kLaneElems], acc[HN][kLaneElems], m[HN], l[HN];
#pragma unroll
  for (int gi = 0; gi < HN; ++gi) {  // the raw loads first
    const int h = chunk * HN + gi;
    load8<T, VEC>(q + (head0 + h) * d, e0, d, h < g, qr[gi]);
  }
  if (tid < n_bt) tab[tid] = clamp(first);
  for (int i = tid + kThreads; i < n_bt; i += kThreads)
    tab[i] = clamp(table[i]);
  const float inv_sqrt_d = 1.0f / sqrtf(static_cast<float>(d));
#pragma unroll
  for (int gi = 0; gi < HN; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.0f;
#pragma unroll
    for (int e = 0; e < kLaneElems; ++e) {
      acc[gi][e] = 0.0f;
      qr[gi][e] = to_float(from_float<T>(qr[gi][e] * inv_sqrt_d));
    }
  }
  int n_live = len > 0 ? (len + page - 1) / page : 0;
  if (n_live > n_bt) n_live = n_bt;
  int p_begin, p_end;
  page_range(n_live, splits, rank, &p_begin, &p_end);
  const int n_stages = (p_end - p_begin + ppc - 1) / ppc;
  const size_t row_stride = (size_t)kv * d;  // elements between pool rows
  __syncthreads();                           // the table is in

  // 2. stage s of the ring: its pages' K and V rows (and scales)
  // a thread copies the vector at element x of rows r0, r0 + rpp, ... of
  // each stage (rpp rows a pass; a thread past rpp x vecs copies none) and
  // the scales of rows tid, tid + kThreads, ...; the pages and rows in the
  // page of its first rows are found once
  constexpr int kVec = VEC ? 16 / sizeof(P) : 1;
  const int vecs = d / kVec;
  const int rpp = kThreads / vecs;
  const int r0 = tid / vecs, x = (tid - r0 * vecs) * kVec;
  const int pg0 = r0 / page, ro0 = r0 - pg0 * page;
  const int spg0 = tid / page, sro0 = tid - spg0 * page;
  const P* k_src = kp + (size_t)kvh * d + x;
  const P* v_src = vp + (size_t)kvh * d + x;
  auto load_stage = [&](int s) {
    if (s < n_stages) {
      const int p0 = p_begin + s * ppc;
      const int n_rows = min(ppc, p_end - p0) * page;
      unsigned char* st = work + (size_t)(s % stages) * lay.stage;
      P* kd = reinterpret_cast<P*>(st) + x;
      P* vd = reinterpret_cast<P*>(st + lay.v) + x;
      int pg = pg0, ro = ro0;
      for (int r = r0; r < n_rows && r0 < rpp; r += rpp) {
        const size_t src = ((size_t)tab[p0 + pg] * page + ro) * row_stride;
        if (VEC) {
          cp_async16(kd + (size_t)r * d, k_src + src);
          cp_async16(vd + (size_t)r * d, v_src + src);
        } else {
          kd[(size_t)r * d] = k_src[src];
          vd[(size_t)r * d] = v_src[src];
        }
        for (ro += rpp; ro >= page; ro -= page) ++pg;
      }
      if (QUANT) {
        float* ksd = reinterpret_cast<float*>(st + lay.ks);
        float* vsd = reinterpret_cast<float*>(st + lay.vs);
        for (int r = tid; r < n_rows; r += kThreads) {
          const int spg = r == tid ? spg0 : r / page;
          const int sro = r == tid ? sro0 : r - spg * page;
          const size_t at = ((size_t)tab[p0 + spg] * page + sro) * kv + kvh;
          if (VEC) {
            cp_async4(ksd + r, ksp + at);
            cp_async4(vsd + r, vsp + at);
          } else {
            ksd[r] = ksp[at];
            vsd[r] = vsp[at];
          }
        }
      }
    }
    cp_async_commit();  // an empty group past the range keeps the count
  };

  for (int s = 0; s < stages - 1; ++s) load_stage(s);
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait(stages - 2);  // stage s has landed (this thread's part)
    __syncthreads();            // ... everyone's; stage s - 1 is consumed
    load_stage(s + stages - 1);
    const int p0 = p_begin + s * ppc;
    const int n_rows = min(ppc, p_end - p0) * page;
    const int pos0 = p0 * page;
    const unsigned char* st = work + (size_t)(s % stages) * lay.stage;
    const P* ks = reinterpret_cast<const P*>(st);
    const P* vs = reinterpret_cast<const P*>(st + lay.v);
    const float* kss = reinterpret_cast<const float*>(st + lay.ks);
    const float* vss = reinterpret_cast<const float*>(st + lay.vs);
    // 3. kRows rows a group a step; the loop is uniform over the block
    for (int base = 0; base < n_rows; base += kRows * slots) {
      int row[kRows];
      bool live[kRows];  // live[t] implies live[t - 1]
      float kf[kRows][kLaneElems], vf[kRows][kLaneElems], sc[kRows][HN];
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        row[t] = base + t * slots + slot;
        live[t] = walks && row[t] < n_rows && pos0 + row[t] < len;
        load8<P, VEC>(ks + (size_t)row[t] * d, e0, d, live[t], kf[t]);
      }
#pragma unroll
      for (int gi = 0; gi < HN; ++gi) {
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          float s = 0.0f;
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e) s += qr[gi][e] * kf[t][e];
          sc[t][gi] = s;
        }
      }
#pragma unroll
      for (int t = 0; t < kRows; ++t)
        load8<P, VEC>(vs + (size_t)row[t] * d, e0, d, live[t], vf[t]);
      for (int off = lpr >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int gi = 0; gi < HN; ++gi) {
#pragma unroll
          for (int t = 0; t < kRows; ++t)
            sc[t][gi] += __shfl_xor_sync(0xffffffffu, sc[t][gi], off);
        }
      }
      // the update, uniform over the warp: a row that is not live adds an
      // exact 0 and leaves m (and so acc and l) as they were
      float kscale[kRows], vscale[kRows], corr[HN], w[HN][kRows];
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        kscale[t] = (QUANT && live[t]) ? kss[row[t]] : 1.0f;
        vscale[t] = (QUANT && live[t]) ? vss[row[t]] : 1.0f;
      }
      bool rescale = false;
#pragma unroll
      for (int gi = 0; gi < HN; ++gi) {
        float s[kRows];
        float m_new = m[gi];
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          s[t] = live[t] ? (QUANT ? sc[t][gi] * kscale[t] : sc[t][gi])
                         : kNegInf;
          m_new = fmaxf(m_new, s[t]);
        }
        const bool dead = m_new == kNegInf;
        corr[gi] = dead ? 0.0f : ex(m[gi] - m_new);
        float lsum = l[gi] * corr[gi];
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const float p = (dead || !live[t]) ? 0.0f : ex(s[t] - m_new);
          lsum += p;
          w[gi][t] = QUANT ? p * vscale[t] : p;
        }
        l[gi] = lsum;
        m[gi] = m_new;
        rescale |= corr[gi] != 1.0f;
      }
      if (__any_sync(0xffffffffu, rescale)) {  // a running max moved
#pragma unroll
        for (int gi = 0; gi < HN; ++gi)
#pragma unroll
          for (int e = 0; e < kLaneElems; ++e) acc[gi][e] *= corr[gi];
      }
#pragma unroll
      for (int gi = 0; gi < HN; ++gi)
#pragma unroll
        for (int e = 0; e < kLaneElems; ++e)
#pragma unroll
          for (int t = 0; t < kRows; ++t) acc[gi][e] += w[gi][t] * vf[t][e];
    }
  }
  cp_async_wait(0);
  __syncthreads();  // the ring is free: it takes the warps' partials

  // 4. a warp's groups combine (partners xor lpr, 2 lpr, ...), its first
  //    group writes the warp's partial, then the block's partial per head
  //    over its chunk's warps, in warp order
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < HN; ++gi) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[gi], off);
      const float mx = fmaxf(m[gi], mo);
      const float w = m[gi] == kNegInf ? 0.0f : ex(m[gi] - mx);
      const float wo = mo == kNegInf ? 0.0f : ex(mo - mx);
      l[gi] = w * l[gi] + wo * lo;
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e)
        acc[gi][e] = w * acc[gi][e] +
                     wo * __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
      m[gi] = mx;
    }
  }
  const int wstride = HN * (d + 2);
  float* red = reinterpret_cast<float*>(work);
  if (lane < lpr) {
    float* mine = red + (size_t)warp * wstride;
#pragma unroll
    for (int gi = 0; gi < HN; ++gi) {
      if (lane == 0) {
        mine[gi] = m[gi];
        mine[HN + gi] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < kLaneElems; ++e)
        if (e0 + e < d) mine[2 * HN + gi * d + e0 + e] = acc[gi][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * d; i += kThreads) {
    const int h = i / d, c = h / HN, gi = h - c * HN;
    const int at = 2 * HN + gi * d + (i - h * d);
    float mw[kWarps];
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      if (k < wpc) {
        mw[k] = red[(size_t)(k * chunks + c) * wstride + gi];
        mx = fmaxf(mx, mw[k]);
      }
    }
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      if (k < wpc) {
        const float* pw = red + (size_t)(k * chunks + c) * wstride;
        const float wk = mw[k] == kNegInf ? 0.0f : ex(mw[k] - mx);
        lsum += wk * pw[HN + gi];
        a += wk * pw[at];
      }
    }
    part[2 * g + i] = a;
    if (i == h * d) {
      part[h] = mx;
      part[g + h] = lsum;
    }
  }
  cluster.sync();  // every partial of the cluster is written

  // 5. rank r's slice of the outputs, from the C partials in rank order
  const int n_out = g * d;
  const int share = (n_out + splits - 1) / splits;
  const int o_end = min((rank + 1) * share, n_out);
  for (int i = rank * share + tid; i < o_end; i += kThreads) {
    const int h = i / d;
    float mc[kMaxSplits], lc[kMaxSplits], ac[kMaxSplits];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) {
      if (c < splits) {
        const float* pc = cluster.map_shared_rank(part, c);
        mc[c] = pc[h];
        lc[c] = pc[g + h];
        ac[c] = pc[2 * g + i];
        mx = fmaxf(mx, mc[c]);
      }
    }
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxSplits; ++c) {
      if (c < splits) {
        const float w = mc[c] == kNegInf ? 0.0f : ex(mc[c] - mx);
        lsum += w * lc[c];
        asum += w * ac[c];
      }
    }
    out[(head0 + h) * d + (i - h * d)] =
        from_float<T>(asum / fmaxf(lsum, 1e-30f));
  }
  // no block leaves while a peer may read its partial; the reads are done
  // (their values are used), so the arrival orders nothing (relaxed) and
  // does not wait for the output stores
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

struct Args {
  const void *q, *kp, *vp;
  const float *ksp, *vsp;
  const int *bt, *kv_len;
  void* out;
  int batch, kv, g, d, n_pool, page, n_bt, ppc, splits;
};

// Launches the kernel, or, with `clusters`, asks how many of its clusters
// the card holds at once (cudaOccupancyMaxActiveClusters) instead.
template <typename T, typename P, bool QUANT, bool VEC, int HN>
cudaError_t launch_t(const Args& a, cudaStream_t stream, int* clusters) {
  auto kernel = paged_decode_kernel<T, P, QUANT, VEC, HN>;
  auto smem = [&](int stages) {
    return layout(a.g, HN, a.d, a.ppc * a.page, sizeof(P), QUANT, stages,
                  a.n_bt)
        .total;
  };
  int stages = kStages;  // fewer stages where a stage's pages are big
  while (stages > 2 && smem(stages) > kSmemLimit) --stages;
  if (smem(stages) > kSmemLimit) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.batch, a.kv);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem(stages);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const P*>(a.kp),
      static_cast<const P*>(a.vp), a.ksp, a.vsp, a.bt, a.kv_len,
      static_cast<T*>(a.out), a.kv, a.g, a.d, a.n_pool, a.page, a.n_bt,
      a.ppc, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The copy route and the vector loads by what the head dim and the pools'
// base addresses allow; the heads a group holds by G.
template <typename T, typename P, bool QUANT, bool VEC>
cudaError_t by_heads(const Args& a, cudaStream_t stream, int* clusters) {
  switch (heads_per_group(a.g)) {
    case 2: return launch_t<T, P, QUANT, VEC, 2>(a, stream, clusters);
    case 3: return launch_t<T, P, QUANT, VEC, 3>(a, stream, clusters);
    default: return launch_t<T, P, QUANT, VEC, 4>(a, stream, clusters);
  }
}
template <typename T, typename P, bool QUANT>
cudaError_t dispatch(const Args& a, cudaStream_t stream, int* clusters) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.kp) |
        reinterpret_cast<uintptr_t>(a.vp)) % 16) == 0;
  if (aligned && a.d % kLaneElems == 0 && (a.d * sizeof(P)) % 16 == 0)
    return by_heads<T, P, QUANT, true>(a, stream, clusters);
  return by_heads<T, P, QUANT, false>(a, stream, clusters);
}

int run(int dtype, int quantized, const void* q, const void* k_pages,
        const void* v_pages, const void* k_scales, const void* v_scales,
        const void* block_tables, const void* kv_len, void* out, int batch,
        int kv, int g, int d, int n_pool, int page, int n_bt, int ppc,
        int splits, void* stream, int* clusters) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || kv < 1 || g < 1 || d < 1 || d > kMaxHeadDim ||
      page < 1 || ppc < 1 || n_bt < 0 || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  // every chunk of heads needs a warp
  if ((g + heads_per_group(g) - 1) / heads_per_group(g) > kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (quantized && (k_scales == nullptr || v_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k_pages,
               v_pages,
               static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales),
               static_cast<const int*>(block_tables),
               static_cast<const int*>(kv_len),
               out,
               batch, kv, g, d, n_pool, page, n_bt, ppc, splits};
  if (dtype == 0)
    return static_cast<int>(
        quantized ? dispatch<__nv_bfloat16, int8_t, true>(a, s, clusters)
                  : dispatch<__nv_bfloat16, __nv_bfloat16, false>(a, s,
                                                                   clusters));
  if (dtype == 1)
    return static_cast<int>(
        quantized ? dispatch<float, int8_t, true>(a, s, clusters)
                  : dispatch<float, float, false>(a, s, clusters));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32 (q and the output; the pools too unless
// quantized).  quantized: 1 = int8 pools with f32 scale pools k_scales and
// v_scales (P, page, KV); 0 = float pools (the scale pointers are unused).
// ppc: whole pages a ring stage holds; splits: the cluster size C (1-8).
// Returns the CUDA error of the launch (0 on success).
int paged_attention_launch(int dtype, int quantized, const void* q,
                           const void* k_pages, const void* v_pages,
                           const void* k_scales, const void* v_scales,
                           const void* block_tables, const void* kv_len,
                           void* out, int batch, int kv, int g, int d,
                           int n_pool, int page, int n_bt, int ppc,
                           int splits, void* stream) {
  return run(dtype, quantized, q, k_pages, v_pages, k_scales, v_scales,
             block_tables, kv_len, out, batch, kv, g, d, n_pool, page, n_bt,
             ppc, splits, stream, nullptr);
}

// The same arguments, but nothing is launched: *clusters takes how many of
// the launch's clusters the card holds at once.  Returns the CUDA error.
int paged_attention_max_active_clusters(
    int dtype, int quantized, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scales, const void* v_scales,
    const void* block_tables, const void* kv_len, void* out, int batch,
    int kv, int g, int d, int n_pool, int page, int n_bt, int ppc, int splits,
    void* stream, int* clusters) {
  if (clusters == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(dtype, quantized, q, k_pages, v_pages, k_scales, v_scales,
             block_tables, kv_len, out, batch, kv, g, d, n_pool, page, n_bt,
             ppc, splits, stream, clusters);
}

}  // extern "C"
