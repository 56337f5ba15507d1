// Paged single-token decode attention for Hopper, bf16 in / bf16 out.
//
// Replaces: src/repro/kernels/paged_attention.py:_paged_decode_kernel (the
// Pallas TPU page walk behind paged_flash_decode / paged_decode_attention).
// Same function: for each (slot, KV head) score the GQA group's query rows
// against the slot's visible positions through its block-table row, mask
// positions past the slot's frontier cache_len (and at or behind
// cache_len - window when a window is set), never touch pages wholly past
// the frontier or behind the window, softmax in f32 and write (B, Hq, 1, D).
//
// A range call (the pooled decode of sharded serving): an optional per-slot
// start position hides every position before it as the window hides the
// positions behind it (the visible range is [max(start, window bound),
// frontier]; splits wholly before it exit at once), and an optional f32
// lse (B, Hq) receives each query row's natural log-sum-exp over the range,
// -inf where the range is empty (o is then 0). A call with neither runs the
// same arithmetic as before they existed.
//
// Bound on an H100: decode reads every visible K/V byte once and does only
// ~4*group FLOPs per K/V element pair, far below the ~295 FLOP/byte ridge,
// so the bound is the visible pages' bytes at 3.35 TB/s. At the serving
// path's shapes (4 slots, a few hundred tokens, 2 KV heads) those bytes are
// ~1.7 MB, under a microsecond: what binds there is launch and load latency
// and how many SMs take part. What the design does about it:
//   - the page walk is split (flash-decoding): grid (split, KV head, slot),
//     a split being SPLIT_TOKENS consecutive logical positions (a whole
//     number of pages), so a slot of L tokens spreads over ~L / 64 CTAs
//     instead of walking its pages in series on one SM;
//   - a CTA issues every K and V copy of its split (cp.async, 16 bytes a
//     thread, a page slab being pt * D contiguous bf16) before it waits on
//     any, and keeps K and V in bf16; each page is loaded once per (slot,
//     KV head) and used by all `group` query heads;
//   - Q.K^T and P.V run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 sums): 16 positions by the GQA group's 8 query rows a tile for the
//     scores, 16 D columns by 8 rows for P.V (P rounded to bf16, as flash
//     prefill does), the tiles read with ldmatrix from rows padded to 272
//     bytes so no two rows share a bank; softmax is one warp per row, f32;
//   - splits with no visible position exit at once; a slot with a single
//     live split writes o itself. Otherwise each live split writes f32
//     partials (m, l, acc[group][D]) and the last CTA of the (slot, KV head)
//     to arrive (a __threadfence + atomicAdd on a counter, which it resets
//     to 0) merges them in split order with the log-sum-exp rescale and
//     writes o. Where the live splits span more than one node of NODE = 16
//     splits (over 1024 positions), the last split of each node merges the
//     node and the last node merges the nodes, so no one CTA reads every
//     partial of a long context. One launch per call, no atomics in any sum.
// Split boundaries depend only on positions, never on the batch, on the
// block table's width past the frontier or on other slots, and the merge
// runs in split order, so a slot's output is bit-identical whether it is
// decoded alone or in a batch, whatever the width of its block-table row.
//
// Layout: q (B,Hq,1,D) with arbitrary batch/head strides and unit stride on
// D; k_pages/v_pages contiguous (n_pages,Hkv,page_tokens,D); block_tables
// contiguous (B,P) int32 (page 0 = null page); cache_len (B,) int32; o
// contiguous (B,Hq,1,D). ws: f32 partials of the splits and the nodes,
// (B, Hkv, n_splits + n_nodes, group, D + 2) from the caller; start (B,)
// int32 or null; lse (B, Hq) f32 or null; counters:
// B * Hkv * (n_nodes + 1) int32, zero before the first launch (each launch
// leaves them zero), used by one stream at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 128;              // head dim
constexpr int NT = 128;             // 4 warps
constexpr int MAX_GROUP = 16;       // query heads per KV head
constexpr int MAX_PAGE_TOKENS = 64;
constexpr int SPLIT_TOKENS = 64;    // positions per split (>= one page)
constexpr int MAX_SPLIT = SPLIT_TOKENS > MAX_PAGE_TOKENS ? SPLIT_TOKENS
                                                         : MAX_PAGE_TOKENS;
constexpr int KROW = D + 8;         // bf16 row of K, V, q tiles: 272 bytes
constexpr int PROW = MAX_SPLIT + 8; // bf16 row of P
constexpr int MERGE_CHUNK = 64;     // partials per merge pass (m, l in smem)
constexpr int NODE = 16;            // splits a first-level merge takes
constexpr int MAX_GRID_YZ = 65535;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k_pages;
  const __nv_bfloat16* v_pages;
  const int* block_tables;
  const int* cache_len;
  const int* start;  // per-slot first visible position, or null
  __nv_bfloat16* o;
  float* lse;        // (B, Hq) natural log-sum-exp, or null
  float* ws;
  int* counters;
  int hq, hkv, pt, p_max, pps, n_splits;
  long long q_sb, q_sh;
  float scale_log2;  // softmax scale * log2(e): scores in the exp2 domain
  int has_window, window;
};

// Positions per split: a whole number of pages, SPLIT_TOKENS when the page
// size divides it.
__host__ __device__ inline int pages_per_split(int pt) {
  return pt >= SPLIT_TOKENS ? 1 : SPLIT_TOKENS / pt;
}

// Tensor-core helpers: bf16 m16n8k16 products with f32 sums (mma.sync)
// and 8x8 b16 tile loads from shared memory (ldmatrix, .trans transposed).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(p)));
}
__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// After this CTA's partial is written: count its arrival on `counter` and
// return true in the CTA that arrives last of `expected`, which resets the
// counter to 0 for the next launch and may then read every partial.
__device__ __forceinline__ bool arrive(int* counter, int expected,
                                       int& is_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counter, 1) == expected - 1;
    if (is_last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  return true;
}

// Merge `count` partials from `first` on (acc [.][group][D], (m, l) per
// row), in order: M = max m, w = 2^(m - M), sum w acc and L = sum w l. Each
// pass stages MERGE_CHUNK partials' (m, l) in shared memory (mw, lw: the
// scores and q are done with), and each thread sums 16-byte pieces of the
// partials, 16 pieces in flight at once. Writes o = acc / L (bf16), or with
// dst_acc the merged partial itself (acc, M, L).
template <int PIECES>
__device__ __forceinline__ void merge_run(const float* acc, const float* ml,
                                          int count, int group, float* mw,
                                          float* lw, float* ms, float* ls,
                                          float* dst_acc, float* dst_ml,
                                          __nv_bfloat16* o, float* lse) {
  constexpr int LOADS = 16 / PIECES;  // partials whose pieces load at once
  const int tid = threadIdx.x, n4 = group * D / 4;
  const bool one_pass = count <= MERGE_CHUNK;  // m, l stay in mw, lw
  float4 pa[LOADS][PIECES];
  auto load = [&](int sb) {  // pieces of partials [sb, sb + LOADS)
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const float4* src =
          reinterpret_cast<const float4*>(acc + size_t(sb + u) * group * D);
#pragma unroll
      for (int i = 0; i < PIECES; ++i)
        pa[u][i] = (sb + u < count && tid + i * NT < n4)
                       ? __ldcg(src + tid + i * NT)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  load(0);  // the first partials are in flight while (m, l) are read
  float mx = -INFINITY;
  for (int s0 = 0; s0 < count; s0 += MERGE_CHUNK) {
    const int n = min(MERGE_CHUNK, count - s0);
    __syncthreads();
    for (int i = tid; i < n * group; i += NT) {
      mw[i] = __ldcg(ml + (size_t(s0) * group + i) * 2);
      lw[i] = __ldcg(ml + (size_t(s0) * group + i) * 2 + 1);
    }
    __syncthreads();
    if (tid < group)
      for (int s = 0; s < n; ++s) mx = fmaxf(mx, mw[s * group + tid]);
  }
  if (tid < group) ms[tid] = mx;
  float4 out[PIECES];
#pragma unroll
  for (int i = 0; i < PIECES; ++i) out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float lsum = 0.f;
  for (int s0 = 0; s0 < count; s0 += MERGE_CHUNK) {
    const int n = min(MERGE_CHUNK, count - s0);
    __syncthreads();  // ms is set; the previous pass is done with mw, lw
    for (int i = tid; i < n * group; i += NT) {  // each thread its own i
      const float* mli = ml + (size_t(s0) * group + i) * 2;
      const float w = exp2f((one_pass ? mw[i] : __ldcg(mli)) - ms[i % group]);
      lw[i] = (one_pass ? lw[i] : __ldcg(mli + 1)) * w;
      mw[i] = w;
    }
    __syncthreads();
    for (int sb = 0; sb < n; sb += LOADS) {
      if (s0 + sb > 0) load(s0 + sb);
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        if (sb + u >= n) break;
#pragma unroll
        for (int i = 0; i < PIECES; ++i) {
          const int f4 = tid + i * NT;
          if (f4 >= n4) break;
          const float w = mw[(sb + u) * group + f4 * 4 / D];
          out[i].x = fmaf(pa[u][i].x, w, out[i].x);
          out[i].y = fmaf(pa[u][i].y, w, out[i].y);
          out[i].z = fmaf(pa[u][i].z, w, out[i].z);
          out[i].w = fmaf(pa[u][i].w, w, out[i].w);
        }
      }
    }
    if (tid < group)
      for (int s = 0; s < n; ++s) lsum += lw[s * group + tid];
  }
  if (tid < group) ls[tid] = lsum;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int f4 = tid + i * NT;
    if (f4 >= n4) break;
    if (dst_acc != nullptr) {
      reinterpret_cast<float4*>(dst_acc)[f4] = out[i];
      continue;
    }
    const float inv_l = 1.f / ls[f4 * 4 / D];
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o + f4 * 4);
    dst[0] = __floats2bfloat162_rn(out[i].x * inv_l, out[i].y * inv_l);
    dst[1] = __floats2bfloat162_rn(out[i].z * inv_l, out[i].w * inv_l);
  }
  if (dst_ml != nullptr && tid < group) {
    dst_ml[2 * tid] = ms[tid];
    dst_ml[2 * tid + 1] = ls[tid];
  }
  if (lse != nullptr && tid < group)
    lse[tid] = (ms[tid] + log2f(ls[tid])) * LN2;
}

// merge_run with as many pieces a thread as the group needs; a final merge
// (o given) also writes each row's log-sum-exp where lse is given.
__device__ __forceinline__ void merge(const float* acc, const float* ml,
                                      int first, int count, int group,
                                      float* mw, float* lw, float* ms,
                                      float* ls, float* dst_acc,
                                      float* dst_ml, __nv_bfloat16* o,
                                      float* lse) {
  acc += size_t(first) * group * D;
  ml += size_t(first) * group * 2;
  if (group * D / 4 <= 2 * NT)
    merge_run<2>(acc, ml, count, group, mw, lw, ms, ls, dst_acc, dst_ml, o,
                 lse);
  else
    merge_run<4>(acc, ml, count, group, mw, lw, ms, ls, dst_acc, dst_ml, o,
                 lse);
}

__global__ void __launch_bounds__(NT, 4) paged_decode_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 ks[MAX_SPLIT * KROW];
  __shared__ __align__(16) __nv_bfloat16 vs[MAX_SPLIT * KROW];
  __shared__ __align__(16) __nv_bfloat16 qb[MAX_GROUP * KROW];  // merge: lw
  __shared__ __align__(16) __nv_bfloat16 pb[MAX_GROUP * PROW];
  __shared__ __align__(16) float ps[MAX_SPLIT * MAX_GROUP];  // [j][g]; mw
  __shared__ float ms[MAX_GROUP], ls[MAX_GROUP];
  __shared__ int is_last;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = p.hq / p.hkv, pt = p.pt, T = p.pps * pt;
  const int n_tiles = (group + 7) / 8;  // query rows in 8-row mma tiles
  const int frontier = p.cache_len[b];
  // the slot's visible positions [lo, hi) and its live splits
  const int hi = min(frontier + 1, p.p_max * pt);
  int lo = p.has_window ? max(0, frontier - p.window + 1) : 0;
  if (p.start != nullptr) lo = max(lo, p.start[b]);
  const int n_live = hi > lo ? (hi - 1) / T - lo / T + 1 : 0;
  const int s_first = lo / T;
  __nv_bfloat16* o = p.o + (size_t(b) * p.hq + size_t(h) * group) * D;
  float* lse =
      p.lse != nullptr ? p.lse + size_t(b) * p.hq + size_t(h) * group : nullptr;

  if (n_live == 0) {  // nothing visible: zeros, as the serial walk gave
    if (split == 0) {
      for (int g = 0; g < group; ++g) o[g * D + tid] = __float2bfloat16(0.f);
      if (lse != nullptr && tid < group) lse[tid] = -INFINITY;
    }
    return;
  }
  if (split < s_first || split >= s_first + n_live) return;

  const int t0 = split * T;
  const int j0 = max(lo, t0) - t0, j1 = min(hi, t0 + T) - t0;
  const int pg0 = j0 / pt, pg1 = (j1 - 1) / pt;
  const int kt = (T + 15) & ~15;  // positions the 16-row tiles cover
  const int* bt = p.block_tables + size_t(b) * p.p_max + size_t(split) * p.pps;

  // every K and V copy of the split in flight before any wait
  const int per_page = pt * D * 2 / 16;  // 16-byte pieces of one page slab
  const int n_copy = (pg1 - pg0 + 1) * per_page;
  for (int i = tid; i < n_copy; i += NT) {
    const int pg = pg0 + i / per_page, c = i % per_page;
    const size_t slab = (size_t(bt[pg]) * p.hkv + h) * pt * D + c * 8;
    const int at = (pg * pt + c / (D / 8)) * KROW + (c % (D / 8)) * 8;
    hopper::cp_async16(ks + at, p.k_pages + slab);
    hopper::cp_async16(vs + at, p.v_pages + slab);
  }
  hopper::cp_async_commit();
  // V rows no page filled are zeroed (P is 0 there, but 0 * NaN is not);
  // q rows as bf16, zero rows up to the last 8-row tile
  const int r_lo = pg0 * pt, r_hi = (pg1 + 1) * pt;
  for (int i = tid; i < kt * (D / 8); i += NT) {
    const int r = i / (D / 8), c = i % (D / 8);
    if (r < r_lo || r >= r_hi)
      *reinterpret_cast<uint4*>(vs + r * KROW + c * 8) = make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < n_tiles * 8 * D; i += NT) {
    const int g = i / D, c = i % D;
    qb[g * KROW + c] =
        g < group ? p.q[b * p.q_sb + (size_t(h) * group + g) * p.q_sh + c]
                  : __float2bfloat16(0.f);
  }
  hopper::cp_async_wait_all();
  __syncthreads();

  // scores S = K Q^T on the tensor cores: warp w takes positions
  // [16w, 16w + 16) as the 16 rows, the query rows as 8-wide columns
  const int tok0 = 16 * warp;
  if (tok0 < kt) {
    float sacc[MAX_GROUP / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ks + (tok0 + lane % 16) * KROW + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int nt = 0; nt < MAX_GROUP / 8; ++nt) {
        if (nt >= n_tiles) break;
        const __nv_bfloat16* qp =
            qb + (nt * 8 + lane / 4) * KROW + kk * 16 + (lane % 4) * 2;
        mma_bf16(sacc[nt], a, lds32(qp), lds32(qp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < MAX_GROUP / 8; ++nt) {
      if (nt >= n_tiles) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = tok0 + lane / 4 + (e / 2) * 8;
        const int g = nt * 8 + (lane % 4) * 2 + e % 2;
        if (j >= j0 && j < j1 && g < group)
          ps[j * MAX_GROUP + g] = sacc[nt][e] * p.scale_log2;
      }
    }
  }
  __syncthreads();

  // softmax of each query row over the split, one warp a row: P in bf16
  // for the tensor cores (zeros outside [j0, j1) and in padding rows), the
  // row's max and sum in f32
  for (int g = warp; g < n_tiles * 8; g += NT / 32) {
    __nv_bfloat16* prow = pb + g * PROW;
    if (g >= group) {
      for (int j = lane; j < kt; j += 32) prow[j] = __float2bfloat16(0.f);
      continue;
    }
    const float* row = ps + g;  // row[j * MAX_GROUP]
    float mx = -INFINITY;
    for (int j = j0 + lane; j < j1; j += 32)
      mx = fmaxf(mx, row[j * MAX_GROUP]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < kt; j += 32) {
      float e = 0.f;
      if (j >= j0 && j < j1) {
        e = exp2f(row[j * MAX_GROUP] - mx);
        sum += e;
      }
      prow[j] = __float2bfloat16(e);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ms[g] = mx;
      ls[g] = sum;
    }
  }
  __syncthreads();

  // O^T = V^T P^T on the tensor cores: warp w takes D columns
  // [32w, 32w + 32) as two 16-row tiles, the positions as the depth
  float oacc[2][MAX_GROUP / 8][4] = {};
  for (int kk = 0; kk < kt / 16; ++kk) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int d0 = warp * 32 + mt * 16, mat = lane / 8;
      uint32_t a[4];
      ldsm_x4_t(a, vs + (kk * 16 + lane % 8 + (mat / 2) * 8) * KROW + d0 +
                       (mat % 2) * 8);
#pragma unroll
      for (int nt = 0; nt < MAX_GROUP / 8; ++nt) {
        if (nt >= n_tiles) break;
        const __nv_bfloat16* pp =
            pb + (nt * 8 + lane / 4) * PROW + kk * 16 + (lane % 4) * 2;
        mma_bf16(oacc[mt][nt], a, lds32(pp), lds32(pp + 8));
      }
    }
  }

  // each thread holds O[g][d] for g = 8nt + 2(lane % 4) + (e % 2) and
  // d = 32w + 16mt + lane / 4 + 8(e / 2)
  if (n_live == 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < MAX_GROUP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = nt * 8 + (lane % 4) * 2 + e % 2;
          const int d = warp * 32 + mt * 16 + lane / 4 + (e / 2) * 8;
          if (nt < n_tiles && g < group)
            o[g * D + d] = __float2bfloat16(oacc[mt][nt][e] / ls[g]);
        }
    if (lse != nullptr && tid < group)
      lse[tid] = (ms[tid] + log2f(ls[tid])) * LN2;
    return;
  }

  // the split's partial (f32 acc [group][D], (m, l) per row); then the
  // merge: by the last split to arrive when the live splits lie in one node
  // of NODE splits, else in two levels (each node's last split merges the
  // node, the last node merges the nodes), each in order
  const size_t bh = size_t(b) * p.hkv + h;
  const int n_nodes = (p.n_splits + NODE - 1) / NODE;
  const size_t rows_s = size_t(gridDim.z) * p.hkv * p.n_splits * group;
  const size_t rows_n = size_t(gridDim.z) * p.hkv * n_nodes * group;
  float* s_acc = p.ws + bh * p.n_splits * group * D;
  float* s_ml = p.ws + rows_s * D + bh * p.n_splits * group * 2;
  float* n_acc = p.ws + rows_s * (D + 2) + bh * n_nodes * group * D;
  float* n_ml = p.ws + rows_s * (D + 2) + rows_n * D + bh * n_nodes * group * 2;
  int* counters = p.counters + bh * (n_nodes + 1);  // each node, then all
  float* part = s_acc + size_t(split) * group * D;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_GROUP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = nt * 8 + (lane % 4) * 2 + e % 2;
        const int d = warp * 32 + mt * 16 + lane / 4 + (e / 2) * 8;
        if (nt < n_tiles && g < group) part[g * D + d] = oacc[mt][nt][e];
      }
  if (tid < group) {
    s_ml[(size_t(split) * group + tid) * 2] = ms[tid];
    s_ml[(size_t(split) * group + tid) * 2 + 1] = ls[tid];
  }
  float* mw = ps;                            // merge: m, then the weights
  float* lw = reinterpret_cast<float*>(qb);  // merge: l, then l * weight
  const int s_last = s_first + n_live - 1;
  const int nd_first = s_first / NODE, nd_last = s_last / NODE;
  if (nd_first == nd_last) {
    if (!arrive(counters + n_nodes, n_live, is_last)) return;
    merge(s_acc, s_ml, s_first, n_live, group, mw, lw, ms, ls, nullptr,
          nullptr, o, lse);
    return;
  }
  const int nd = split / NODE;
  const int first = max(s_first, nd * NODE);
  const int count = min(s_last, nd * NODE + NODE - 1) - first + 1;
  if (!arrive(counters + nd, count, is_last)) return;
  merge(s_acc, s_ml, first, count, group, mw, lw, ms, ls,
        n_acc + size_t(nd) * group * D, n_ml + size_t(nd) * group * 2,
        nullptr, nullptr);
  if (!arrive(counters + n_nodes, nd_last - nd_first + 1, is_last)) return;
  merge(n_acc, n_ml, nd_first, nd_last - nd_first + 1, group, mw, lw, ms, ls,
        nullptr, nullptr, o, lse);
}

}  // namespace

extern "C" {

int paged_attention_head_dim() { return D; }
int paged_attention_max_group() { return MAX_GROUP; }
int paged_attention_max_page_tokens() { return MAX_PAGE_TOKENS; }
int paged_attention_split_tokens() { return SPLIT_TOKENS; }

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` (start and lse may be null); returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue (launching nothing) when the shapes are out of the
// kernel's limits or ws / counters are smaller than the grid needs.
int paged_decode_bf16(const void* q, const void* k_pages, const void* v_pages,
                      const void* block_tables, const void* cache_len,
                      const void* start, void* o, void* lse, void* ws,
                      void* counters, int batch, int hq, int hkv,
                      int page_tokens, int p_max, long long q_sb,
                      long long q_sh, long long ws_floats, int n_counters,
                      float scale, int has_window, int window, void* stream) {
  if (batch < 1 || batch > MAX_GRID_YZ || hkv < 1 || hkv > MAX_GRID_YZ ||
      hq % hkv || hq / hkv > MAX_GROUP || page_tokens < 1 ||
      page_tokens > MAX_PAGE_TOKENS || p_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = hq / hkv;
  const int pps = pages_per_split(page_tokens);
  const int n_splits = (p_max + pps - 1) / pps;
  const int n_nodes = (n_splits + NODE - 1) / NODE;
  if (ws_floats <
          (long long)batch * hkv * (n_splits + n_nodes) * group * (D + 2) ||
      n_counters < batch * hkv * (n_nodes + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const __nv_bfloat16*>(k_pages),
           static_cast<const __nv_bfloat16*>(v_pages),
           static_cast<const int*>(block_tables),
           static_cast<const int*>(cache_len),
           static_cast<const int*>(start),
           static_cast<__nv_bfloat16*>(o),
           static_cast<float*>(lse),
           static_cast<float*>(ws),
           static_cast<int*>(counters),
           hq, hkv, page_tokens, p_max, pps, n_splits, q_sb, q_sh,
           scale * LOG2E, has_window, window};
  const dim3 grid(n_splits, hkv, batch);
  paged_decode_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
