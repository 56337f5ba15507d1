// Blockwise (flash) attention forward for Hopper tensor cores, bf16 in /
// bf16 out.
//
// Replaces: src/repro/kernels/flash_attention.py:_attn_kernel (the Pallas
// TPU kernel behind flash_attention / ops.attention). Same function: online
// softmax over KV tiles with f32 running max, sum and accumulator; causal
// and/or sliding-window masks shifted by q_offset; GQA by mapping query head
// h to KV head h / group (no repeated K/V in memory); KV tiles wholly past
// the causal diagonal or behind the window are never loaded; ragged Sq and
// Skv; fully masked rows come out as 0.
//
// Bound on an H100: at the main path's prefill shape (Sq 512 over Skv 576,
// 16 query heads over 2 KV heads, D = 128, causal) the bytes (Q and O
// dominate: 4.6 MB, 0.0014 ms at 3.35 TB/s) bound it just above the
// operations (1.07 GFLOP over the causal band, 0.0011 ms at 989 TFLOP/s);
// longer prompts cross the ~295 FLOP/byte ridge to the tensor-core rate.
// The kernel is far from both, held by the latency of each CTA's serial
// walk over its KV tiles (load, Q K^T, softmax, P V, one after another).
//
// Design: one CTA per (batch, query head, 64-row query tile): 1 x 16 heads x
// Sq 512 gives 128 CTAs on 132 SMs (128-row tiles would give 64). A CTA is
// one consumer warpgroup (64 query rows: wgmma's M) and one producer warp.
// The producer brings the Q tile in once and streams 64-key K and V tiles
// through a 2-stage ring, all by TMA (cp.async.bulk.tensor.4d over the
// (D, S, H, B) view with the tensor's own strides, so the model's
// transpose(1, 2) views are read in place), each stage paced by a full and
// an empty mbarrier; reads past Sq or Skv fill zeros. Tiles sit in shared
// memory as 128-byte-swizzled chunks of 64 columns (hopper.cuh). S = Q K^T
// is wgmma m64n64k16 with Q and K K-major from shared memory; the softmax
// runs on the accumulator registers (each row's max and sum reduced over
// the four threads that share it; masks applied only on tiles that cross
// the causal, window or Skv edge); P is rounded to bf16 in registers and is
// wgmma's A operand for O += P V (m64n128k16, V MN-major from shared
// memory); O stays in registers and is scaled by 1/l on the store. The
// tiles are fixed constants: sizing them from the h100 planner is later
// work. Shared memory: Q 16 KB + 2 x (K 16 KB + V 16 KB) = 80 KB.
//
// Layout: q (B,Hq,Sq,D), k (B,Hkv,Skv,D), v (B,Hkv,Skv,DV) with batch/head/
// seq strides that are multiples of 8 elements (16 bytes, as TMA needs),
// unit stride on the last axis and 16-byte aligned bases (the wrapper
// copies anything else); o is contiguous (B,Hq,Sq,DV). Grid: (ceil(Sq/64),
// Hq, B).
//
// Head dims: the kernel is a template on (D, DV), built at (128, 128) (the
// GQA families) and (192, 128) (multi-head latent attention's prefill:
// nope 128 + rope 64 for Q and K, 128 for V). A Q or K tile of D = 192 is
// three 128-byte-swizzled chunks of 64 columns, the Q K^T wgmma takes 12
// k16 steps instead of 8, and V and P V stay n128. Shared memory at
// (192, 128): Q 24 KB + 2 x (K 24 KB + V 16 KB) = 104 KB. At deepseek-v2's
// one-shot admission (4 x 256 over 256 positions, 128 heads, causal) the
// bytes (Q, K, V and O: 168 MB, 0.050 ms at 3.35 TB/s) bound it above the
// operations (11 GFLOP over the causal band, 0.011 ms).
//
// (64, 64) is seamless-m4t-medium's (enc-dec, 16 heads over 16): a row of
// Q, K or V is 128 bytes, exactly one 128-byte swizzle atom, so each tile is
// a single chunk (the tensor map's 64 x 64 box covers the whole row), the
// Q K^T wgmma takes 4 k16 steps and P V is m64n64k16 (Wgmma<64>::rs, V
// MN-major in one chunk, so the chunk stride LBO is never stepped). Shared
// memory: Q 8 KB + 2 x (K 8 KB + V 8 KB) = 40 KB. Its calls: the encoder's
// non-causal self-attention, the decoder's causal prefill and non-causal
// cross-attention with Sq != Skv, down to Sq = 1 at each decode step (one
// valid row in the 64-row Q tile; TMA fills the rest with zeros and the
// store skips them).
//
// (32, 32) and (16, 16) (the training examples' head dims: quickstart's 32,
// the smoke configs' 16) run on the (64, 64) tile, as instances with a
// third template argument W, the true width of q, k, v and o. The tensor
// maps are made at width W with the same 64-column box, so TMA fills the
// columns past W with zeros (the transaction still counts the whole box):
// zero columns of Q and K add nothing to Q K^T, zero columns of V give zero
// columns of O, and the store writes only the first W columns of each row
// into a (B, Hq, Sq, W) output. The scale is the caller's, 1/sqrt(W). A
// 64- or 32-byte row would need its own swizzle mode and wgmma
// descriptors (64B / 32B layouts, P V at n32 / n16); the (64, 64) tile
// reuses the 128-byte path that is already held bit for bit, at up to 4x
// the tile's useful work (speed is later work).

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per CTA (one warpgroup)
constexpr int BK = 64;        // keys per KV tile
constexpr int CW = 64;        // columns per 128B-swizzled chunk
constexpr int STAGES = 2;     // K/V ring depth
constexpr int WG = 128;       // threads per warpgroup
constexpr int NT = WG + 32;   // consumer warpgroup + producer warp
constexpr int CHUNK_BYTES = 64 * CW * 2;

// Tile sizes of one (D, DV) instance: a 64-row tile of Q or K is D wide,
// one of V is DV wide; every tile is a whole number of 1024-byte chunks.
template <int D, int DV>
struct Tiles {
  static_assert(D % CW == 0 && (DV == 64 || DV == 128),
                "D a multiple of 64, DV = 64 or 128");
  static constexpr int QK_BYTES = 64 * D * 2;
  static constexpr int V_BYTES = 64 * DV * 2;
  static constexpr size_t SMEM = size_t(QK_BYTES) * (1 + STAGES)
                                 + size_t(V_BYTES) * STAGES
                                 + 8 * (1 + 2 * STAGES);
};

template <int D, int DV, int W>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 __nv_bfloat16* __restrict__ o, int hq, int hkv, int sq,
                 int skv, float scale_log2, int causal, int has_window,
                 int window, int q_offset) {
  constexpr int QK_BYTES = Tiles<D, DV>::QK_BYTES;
  constexpr int V_BYTES = Tiles<D, DV>::V_BYTES;
  constexpr int OW = W ? W : DV;   // columns of o stored a row
  static_assert(W == 0 || (D == 64 && DV == 64 && W % 8 == 0 && W < 64),
                "a narrow instance runs on the (64, 64) tile");
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + QK_BYTES;               // [STAGES] tiles
  unsigned char* v_s = k_s + STAGES * QK_BYTES;      // [STAGES] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + STAGES * V_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int nq = min(BQ, sq - q0);

  // Visible key range of this query tile: [k_begin, k_end).
  const int q_lo = q0 + q_offset;
  const int q_hi = q0 + nq - 1 + q_offset;
  int k_begin = 0, k_end = skv;
  if (causal) k_end = min(k_end, q_hi + 1);
  if (has_window) k_begin = max(0, q_lo - window + 1);
  const int t_begin = k_begin / BK;
  const int n_tiles =
      k_end > k_begin ? (k_end + BK - 1) / BK - t_begin : 0;

  if (tid == 0) {
    if (hopper::smem_addr(smem) & 1023) __trap();  // swizzle needs 1024 B
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= WG) {  // the producer warp: one lane issues every load
    if (tid == WG) {
      hopper::mbar_expect_tx(q_full, QK_BYTES);
      for (int ch = 0; ch < D / CW; ++ch)
        hopper::tma_load_4d(q_s + ch * CHUNK_BYTES, &map_q, q_full, ch * CW,
                            q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, k0 = (t_begin + i) * BK;
        if (i >= STAGES) hopper::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        hopper::mbar_expect_tx(&full[s], QK_BYTES + V_BYTES);
        for (int ch = 0; ch < D / CW; ++ch)
          hopper::tma_load_4d(k_s + s * QK_BYTES + ch * CHUNK_BYTES, &map_k,
                              &full[s], ch * CW, k0, hk, b);
        for (int ch = 0; ch < DV / CW; ++ch)
          hopper::tma_load_4d(v_s + s * V_BYTES + ch * CHUNK_BYTES, &map_v,
                              &full[s], ch * CW, k0, hk, b);
      }
    }
    return;
  }

  // The consumer warpgroup. wgmma's accumulator layout: register 4 j + 2 r
  // + e holds row 16 warp + lane / 4 + 8 r, column 8 j + 2 (lane % 4) + e.
  const int warp = tid / 32, lane = tid % 32;
  const int row_in = 16 * warp + lane / 4, col_in = 2 * (lane % 4);
  float acc_o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc_o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of each row's sum

  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, k0 = (t_begin + i) * BK;
    const unsigned char* ks = k_s + s * QK_BYTES;
    const unsigned char* vs = v_s + s * V_BYTES;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);

    float sc[BK / 2];  // S = Q K^T, 64 x 64
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    hopper::reg_fence<BK / 2>(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk * 16 / CW) * CHUNK_BYTES + (kk * 16 % CW) * 2;
      hopper::Wgmma<BK>::ss<0>(sc, hopper::desc(q_s + off, CW, 16),
                               hopper::desc(ks + off, CW, 16), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::reg_fence<BK / 2>(sc);

    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q_lo) ||
                      (has_window && k0 <= q0 + BQ - 1 + q_offset - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int r = (j / 2) % 2;
      float x = sc[j] * scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * (j / 4) + col_in + j % 2;
        const int qpos = q_lo + row_in + 8 * r;
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= qpos;
        if (has_window) ok = ok && kpos > qpos - window;
        x = ok ? x : -INFINITY;
      }
      sc[j] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row masked so far
      alpha[r] = exp2f(m_run[r] - base[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    uint32_t pa[BK / 16][4];  // P as wgmma's A fragments, bf16 pairs
#pragma unroll
    for (int j = 0; j < BK / 2; j += 2) {
      const int r = (j / 2) % 2;
      const float p0 = exp2f(sc[j] - base[r]);
      const float p1 = exp2f(sc[j + 1] - base[r]);
      l_run[r] += p0 + p1;
      const __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
      // column group j / 4 of 8 keys: k-step (j / 4) / 2, registers
      // 0 / 1 (rows r) for its first half, 2 / 3 for its second
      pa[j / 8][((j / 4) % 2) * 2 + r] =
          *reinterpret_cast<const uint32_t*>(&pk);
    }
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) acc_o[j] *= alpha[(j / 2) % 2];

    hopper::reg_fence<DV / 2>(acc_o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::Wgmma<DV>::rs(acc_o, pa[kk],
                            hopper::desc(vs + kk * 16 * CW * 2, CW,
                                         CHUNK_BYTES), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::reg_fence<DV / 2>(acc_o);
    hopper::mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_in + 8 * r;
    if (row >= nq) continue;
    __nv_bfloat16* orow = o + ((size_t(b) * hq + h) * sq + q0 + row) * OW;
#pragma unroll
    for (int j = 0; j < OW / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col_in) =
          __floats2bfloat162_rn(acc_o[4 * j + 2 * r] * inv[r],
                                acc_o[4 * j + 2 * r + 1] * inv[r]);
  }
}

// The (W, S, H, B) map of a (B, H, S, W) tensor read in 64-row boxes of one
// 128-byte chunk; strides in elements.
cudaError_t make_map(CUtensorMap* map, const void* base, int width, int batch,
                     int heads, int seq, long long sb, long long sh,
                     long long ss) {
  const cuuint64_t dims[4] = {cuuint64_t(width), cuuint64_t(seq),
                              cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(ss) * 2, cuuint64_t(sh) * 2,
                                 cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {CW, 64, 1, 1};
  return hopper::make_map(map, base, 4, dims, strides, box, CW);
}

bool tma_ok(const void* p, long long sb, long long sh, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb > 0 && sh > 0 &&
         ss > 0 && sb % 8 == 0 && sh % 8 == 0 && ss % 8 == 0;
}

template <int D, int DV, int W = 0>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int sq, int skv, long long q_sb, long long q_sh,
           long long q_ss, long long k_sb, long long k_sh, long long k_ss,
           long long v_sb, long long v_sh, long long v_ss, float scale,
           int causal, int has_window, int window, int q_offset,
           void* stream) {
  constexpr size_t smem = Tiles<D, DV>::SMEM;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, DV, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap map_q, map_k, map_v;
  // a narrow instance's maps are W wide: TMA zero-fills the box past W
  constexpr int QK_W = W ? W : D, V_W = W ? W : DV;
  cudaError_t err =
      make_map(&map_q, q, QK_W, batch, hq, sq, q_sb, q_sh, q_ss);
  if (err == cudaSuccess)
    err = make_map(&map_k, k, QK_W, batch, hkv, skv, k_sb, k_sh, k_ss);
  if (err == cudaSuccess)
    err = make_map(&map_v, v, V_W, batch, hkv, skv, v_sb, v_sh, v_ss);
  if (err != cudaSuccess) return int(err);
  dim3 grid((sq + BQ - 1) / BQ, hq, batch);
  flash_fwd_kernel<D, DV, W>
      <<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
          map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), hq, hkv, sq,
          skv, scale * 1.4426950408889634f, causal, has_window, window,
          q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a (d, dv) pair that is not built or strides or
// bases TMA cannot read.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int batch, int hq, int hkv, int sq, int skv, int d,
                         int dv, long long q_sb, long long q_sh,
                         long long q_ss, long long k_sb, long long k_sh,
                         long long k_ss, long long v_sb, long long v_sh,
                         long long v_ss, float scale, int causal,
                         int has_window, int window, int q_offset,
                         void* stream) {
  if (!tma_ok(q, q_sb, q_sh, q_ss) || !tma_ok(k, k_sb, k_sh, k_ss) ||
      !tma_ok(v, v_sb, v_sh, v_ss) || hkv <= 0 || hq % hkv || skv <= 0)
    return int(cudaErrorInvalidValue);
  if (d == 128 && dv == 128)
    return launch<128, 128>(q, k, v, o, batch, hq, hkv, sq, skv, q_sb, q_sh,
                            q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
                            causal, has_window, window, q_offset, stream);
  if (d == 192 && dv == 128)
    return launch<192, 128>(q, k, v, o, batch, hq, hkv, sq, skv, q_sb, q_sh,
                            q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
                            causal, has_window, window, q_offset, stream);
  if (d == 64 && dv == 64)
    return launch<64, 64>(q, k, v, o, batch, hq, hkv, sq, skv, q_sb, q_sh,
                          q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
                          causal, has_window, window, q_offset, stream);
  if (d == 32 && dv == 32)
    return launch<64, 64, 32>(q, k, v, o, batch, hq, hkv, sq, skv, q_sb,
                              q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                              scale, causal, has_window, window, q_offset,
                              stream);
  if (d == 16 && dv == 16)
    return launch<64, 64, 16>(q, k, v, o, batch, hq, hkv, sq, skv, q_sb,
                              q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                              scale, causal, has_window, window, q_offset,
                              stream);
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
