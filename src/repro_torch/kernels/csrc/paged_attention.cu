// Paged single-token decode attention for Hopper, bf16 in / bf16 out.
//
// Replaces: src/repro/kernels/paged_attention.py:_paged_decode_kernel (the
// Pallas TPU page walk behind paged_flash_decode / paged_decode_attention).
// Same function: for each (slot, KV head) walk the slot's block-table row
// page by page, score the GQA group's query rows against each visible page,
// mask positions past the slot's frontier cache_len (and at or behind
// cache_len - window when a window is set), skip pages wholly past the
// frontier or behind the window, merge pages with an f32 online softmax and
// write (B, Hq, 1, D).
//
// Bound on an H100: decode reads every visible K/V byte once and does only
// ~4*group FLOPs per K/V element pair, far below the ~295 FLOP/byte ridge:
// the bound is device-memory bandwidth over the visible pages' bytes. What
// the design does about it: each page is loaded once per (slot, KV head) and
// used for all `group` query heads that share it (no repeated K/V), pages
// past the frontier are never touched, and the TPU's scalar prefetch becomes
// the CTA reading its own block-table row and frontier, so no host read of
// cache_len is needed to size the walk. This first version runs one CTA per
// (slot, KV head) and walks pages serially; splitting the page axis across
// CTAs (flash-decoding) is later work.
//
// Layout: q (B,Hq,1,D) with arbitrary batch/head strides and unit stride on
// D; k_pages/v_pages contiguous (n_pages,Hkv,page_tokens,D); block_tables
// contiguous (B,P) int32 (page 0 = null page); cache_len (B,) int32; o is
// contiguous (B,Hq,1,D). Grid: (B, Hkv); 128 threads (one per D column).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 128;        // head dim; one thread per column
constexpr int NT = D;
constexpr int DP = D + 1;     // padded row stride: conflict-free column reads
constexpr int MAX_GROUP = 16; // query heads per KV head
constexpr int MAX_PAGE_TOKENS = 64;
constexpr int kMaxSmemBytes =
    sizeof(float) * (MAX_GROUP * DP + MAX_PAGE_TOKENS * DP +
                     MAX_PAGE_TOKENS * D + MAX_GROUP * MAX_PAGE_TOKENS +
                     3 * MAX_GROUP);

__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ cache_len,
                    __nv_bfloat16* __restrict__ o,
                    int hq, int hkv, int page_tokens, int p_max,
                    long long q_sb, long long q_sh,
                    float scale, int has_window, int window) {
  extern __shared__ float smem[];
  const int group = hq / hkv;
  const int pt = page_tokens;
  float* qs = smem;                  // [group][DP]
  float* ks = qs + group * DP;       // [pt][DP]
  float* vs = ks + pt * DP;          // [pt][D]
  float* ss = vs + pt * D;           // [group][pt] scores, then probabilities
  float* m_s = ss + group * pt;      // [group] running max
  float* l_s = m_s + group;          // [group] running sum
  float* a_s = l_s + group;          // [group] this page's rescale factor

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int frontier = cache_len[b];
  const int* bt_row = block_tables + size_t(b) * p_max;

  for (int i = tid; i < group * D; i += NT) {
    const int g = i / D, c = i % D;
    qs[g * DP + c] = __bfloat162float(q[b * q_sb + (h * group + g) * q_sh + c]);
  }
  for (int g = tid; g < group; g += NT) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  float acc[MAX_GROUP];
#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) acc[g] = 0.f;

  // pages whose first position is past the frontier are never visible
  const int p_last = frontier < 0 ? -1 : min(p_max - 1, frontier / pt);
  for (int p = 0; p <= p_last; ++p) {
    const int lo = p * pt;
    if (has_window && !(lo + pt - 1 > frontier - window)) continue;
    const size_t page = size_t(bt_row[p]) * hkv + h;
    const __nv_bfloat16* kp = k_pages + page * pt * D;
    const __nv_bfloat16* vp = v_pages + page * pt * D;
    __syncthreads();  // the previous page is done with ks / vs / ss
    for (int i = tid; i < pt * D; i += NT) {
      const int r = i / D, c = i % D;
      ks[r * DP + c] = __bfloat162float(kp[i]);
      vs[r * D + c] = __bfloat162float(vp[i]);
    }
    __syncthreads();

    for (int i = tid; i < group * pt; i += NT) {
      const int g = i / pt, j = i % pt;
      const float* qr = qs + g * DP;
      const float* kr = ks + j * DP;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int pos = lo + j;
      bool ok = pos <= frontier;
      if (has_window) ok = ok && pos > frontier - window;
      ss[g * pt + j] = ok ? s * scale : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < group; g += NT / 32) {  // one warp per query row
      float* row = ss + g * pt;
      float mx = -INFINITY;
      for (int j = lane; j < pt; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < pt; j += 32) {
        const float sv = row[j];
        const float pj = sv > -INFINITY ? expf(sv - m_new) : 0.f;
        row[j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = m_prev > -INFINITY ? expf(m_prev - m_new) : 0.f;
        a_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + sum;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g) {
      if (g >= group) break;
      float a = acc[g] * a_s[g];
      const float* pr = ss + g * pt;
      for (int j = 0; j < pt; ++j) a = fmaf(pr[j], vs[j * D + tid], a);
      acc[g] = a;
    }
  }
  __syncthreads();

#pragma unroll
  for (int g = 0; g < MAX_GROUP; ++g) {
    if (g >= group) break;
    const float l = fmaxf(l_s[g], 1e-30f);
    o[(size_t(b) * hq + h * group + g) * D + tid] = __float2bfloat16(acc[g] / l);
  }
}

}  // namespace

extern "C" {

int paged_attention_head_dim() { return D; }
int paged_attention_max_group() { return MAX_GROUP; }
int paged_attention_max_page_tokens() { return MAX_PAGE_TOKENS; }

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
int paged_decode_bf16(const void* q, const void* k_pages, const void* v_pages,
                      const void* block_tables, const void* cache_len, void* o,
                      int batch, int hq, int hkv, int page_tokens, int p_max,
                      long long q_sb, long long q_sh, float scale,
                      int has_window, int window, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int group = hq / hkv;
  const size_t smem =
      sizeof(float) * (size_t(group) * DP + size_t(page_tokens) * DP +
                       size_t(page_tokens) * D + size_t(group) * page_tokens +
                       3 * size_t(group));
  dim3 grid(batch, hkv);
  paged_decode_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(cache_len),
      static_cast<__nv_bfloat16*>(o), hq, hkv, page_tokens, p_max, q_sb, q_sh,
      scale, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
