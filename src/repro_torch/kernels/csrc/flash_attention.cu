// Blockwise (flash) attention forward for Hopper, bf16 in / bf16 out.
//
// Replaces: src/repro/kernels/flash_attention.py:_attn_kernel (the Pallas
// TPU kernel behind flash_attention / ops.attention). Same function: online
// softmax over KV tiles with f32 running max, sum and accumulator; causal
// and/or sliding-window masks shifted by q_offset; GQA by mapping query head
// h to KV head h / group (no repeated K/V in memory); KV tiles wholly past
// the causal diagonal or behind the window are never loaded; fully masked
// rows come out as 0.
//
// Bound on an H100: at the prefill shapes of the main path (Sq = prompt,
// Skv = page-aligned cache depth, D = 128, causal) the work is ~4*Sq*Skv*D/2
// FLOPs per head against ~(Sq + 2*Skv)*D*2 bytes per head, far above the
// card's ~295 FLOP/byte ridge: the bound is the bf16 tensor-core rate.
// This first version does its dot products with scalar f32 FMAs on CUDA
// cores, so it runs well below that bound; wgmma tiles are later work.
// What the design does about the bound: each CTA stages one K tile and one
// V tile in shared memory and reuses them for all BQ = 64 query rows of its
// tile, so device memory traffic is (Sq/BQ) passes over K/V at most, and
// causal/window skipping cuts the FLOPs to the visible band.
//
// Layout: q (B,Hq,Sq,D), k (B,Hkv,Skv,D), v (B,Hkv,Skv,D) with arbitrary
// batch/head/seq strides and unit stride on D; o is contiguous (B,Hq,Sq,D).
// Sq and Skv need not be multiples of the tiles: ragged edges are masked.
// Grid: (ceil(Sq/BQ), Hq, B); 256 threads; ~114 KB of dynamic shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 128;        // head dim (q/k and v)
constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 256;       // threads per CTA
constexpr int DP = D + 1;     // padded row stride: conflict-free column reads
constexpr int SP = BK + 1;    // padded score row stride

constexpr size_t kSmemBytes =
    sizeof(float) * (size_t(BQ) * DP + size_t(BK) * DP + size_t(BK) * D +
                     size_t(BQ) * SP + 3 * BQ);

__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int hq, int hkv, int sq, int skv,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 float scale, int causal, int has_window, int window,
                 int q_offset) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][DP]
  float* ks = qs + BQ * DP;          // [BK][DP]
  float* vs = ks + BK * DP;          // [BK][D]
  float* ss = vs + BK * D;           // [BQ][SP] scores, then probabilities
  float* m_s = ss + BQ * SP;         // [BQ] running max
  float* l_s = m_s + BQ;             // [BQ] running sum
  float* a_s = l_s + BQ;             // [BQ] this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int nq = min(BQ, sq - q0);

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    qs[r * DP + c] = r < nq ? __bfloat162float(qb[(q0 + r) * q_ss + c]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // Visible key range of this query tile: [k_begin, k_end).
  const int q_lo = q0 + q_offset;
  const int q_hi = q0 + nq - 1 + q_offset;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(k_end, q_hi + 1);
  if (has_window) k_begin = max(0, q_lo - window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  // Output accumulator: rows (tid/32) + 8*i, columns (tid%32) + 32*j.
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    const int nk = min(BK, skv - k0);
    __syncthreads();  // the previous tile is done with ks / vs / ss
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool ok = r < nk;
      ks[r * DP + c] = ok ? __bfloat162float(kb[(k0 + r) * k_ss + c]) : 0.f;
      vs[r * D + c] = ok ? __bfloat162float(vb[(k0 + r) * v_ss + c]) : 0.f;
    }
    __syncthreads();

    {  // scores: rows tr + 16*i, columns tc + 16*j
      const int tr = tid / 16, tc = tid % 16;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(tr + 16 * i) * DP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tc + 16 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tr + 16 * i, c = tc + 16 * j;
          const int qpos = q_lo + r, kpos = k0 + c;
          bool ok = c < nk;
          if (causal) ok = ok && kpos <= qpos;
          if (has_window) ok = ok && kpos > qpos - window;
          ss[r * SP + c] = ok ? s[i][j] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    {  // online softmax: four threads per row, 16 columns each
      const int r = tid / 4, part = tid % 4;
      float* row = ss + r * SP + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float sv = row[c];
        const float p = sv > -INFINITY ? expf(sv - m_new) : 0.f;
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = m_prev > -INFINITY ? expf(m_prev - m_new) : 0.f;
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();

    {  // acc = acc * alpha + P @ V
      const int tr = tid / 32, tc = tid % 32;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float al = a_s[tr + 8 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= al;
      }
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float pv[8], vv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) pv[i] = ss[(tr + 8 * i) * SP + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = vs[c * D + tc + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();

  const int tr = tid / 32, tc = tid % 32;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tr + 8 * i;
    if (r >= nq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    __nv_bfloat16* orow = o + ((size_t(b) * hq + h) * sq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tc + 32 * j] = __float2bfloat16(acc[i][j] / l);
  }
}

}  // namespace

extern "C" {

int flash_attention_head_dim() { return D; }

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int batch, int hq, int hkv, int sq, int skv,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         float scale, int causal, int has_window, int window,
                         int q_offset, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((sq + BQ - 1) / BQ, hq, batch);
  flash_fwd_kernel<<<grid, NT, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      hq, hkv, sq, skv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      scale, causal, has_window, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
