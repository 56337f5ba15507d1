// Grouped expert GEMM for Hopper tensor cores: bf16 operands, f32 sums,
// f32 out.
//
// Replaces: jax.lax.ragged_dot(..., preferred_element_type=jnp.float32) in
// src/repro/models/moe.py:_moe_ep_inner (the reference leaves it to XLA;
// there is no Pallas kernel). Same function: out[i] = xs[i] @ w[g] for every
// row i of expert g, the rows [offs[g-1], offs[g]) of the hits sorted by
// expert (offs[-1] = 0), with every product exact in f32 and the sums kept
// in f32; the result is written in f32, never rounded to bf16 (torch's
// grouped GEMM writes its operands' dtype on the card, which is what made
// the port's MoE round each expert product).
//
// Bound on an H100: the hit experts' weights bind it. At a decode step
// (qwen3-moe's gate projection, T = 4 tokens, top-8 of 128 experts) up to
// 32 x 2048 x 768 bf16 = 101 MB are read (0.030 ms at 3.35 TB/s) for a few
// MFLOP; at a 1024-token admission every expert is hit: 403 MB of weights
// (0.120 ms) against 2 x 8192 x 2048 x 768 = 25.8 GFLOP (0.026 ms at 989
// TFLOP/s).
//
// Design (a simple kernel that is right first; speed is later work): one
// CTA per (64-row tile of one expert, 128-column tile of N), 4 warps in a
// 2 x 2 layout, each warp 32 x 64 of the tile on mma.sync m16n8k16 (bf16 in,
// f32 sums), operands staged through a 3-stage cp.async ring of 32-deep K
// slices (rows padded by 16 bytes so ldmatrix never has two rows on one
// bank), A read with ldmatrix, the row-major B tile with ldmatrix.trans.
// Tiles are scheduled on the device: expert g owns tile slots
// [T_g, T_{g+1}) with T_g = floor(offs[g-1] / 64) + g, which is at least
// as many as its ceil(rows / 64) tiles; a CTA finds its expert by a binary
// search over offs (staged in shared memory) and a slot past its expert's
// rows exits at once. The grid is (floor(m / 64) + E) x ceil(N / 128) from
// the shapes alone, so no count is read to the host: the MoE runs inside
// the serving engine's sync-guarded decode chunks. An expert with no hit
// owns one slot, which exits; its weights are never read.
//
// Layout: xs (m, K) bf16 row-major; w (E, K, N) bf16 row-major (N
// contiguous: the serving copy of the reference's (E, d_in, d_out)
// weights); offs (E,) int32, non-decreasing, offs[E-1] <= m; out (m, N)
// f32 row-major. Rows at or past offs[E-1] are not written. K and N are
// multiples of 8 (16-byte rows for cp.async); edges are zero-filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;            // rows per tile
constexpr int BN = 128;           // columns per tile
constexpr int BK = 32;            // K per ring stage
constexpr int STAGES = 3;
constexpr int NT = 128;           // 4 warps
constexpr int AROW = BK + 8;      // bf16 row of an A stage: 80 bytes
constexpr int BROW = BN + 8;      // bf16 row of a B stage: 272 bytes
constexpr int MAX_EXPERTS = 1024;
constexpr int MAX_GRID_Y = 65535;

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
// (cp.async's src-size 0 reads nothing and fills the destination).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src),
                  "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(p)));
}

__global__ void __launch_bounds__(NT)
grouped_gemm_kernel(const __nv_bfloat16* __restrict__ xs,
                    const __nv_bfloat16* __restrict__ w,
                    const int* __restrict__ offs, float* __restrict__ out,
                    int m, int k, int n, int n_experts) {
  __shared__ __align__(16) __nv_bfloat16 as[STAGES][BM * AROW];
  __shared__ __align__(16) __nv_bfloat16 bs[STAGES][BK * BROW];
  __shared__ int ends[MAX_EXPERTS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = blockIdx.x, col0 = blockIdx.y * BN;
  for (int i = tid; i < n_experts; i += NT)
    ends[i] = min(max(offs[i], 0), m);
  __syncthreads();

  // the expert owning this slot: the last g with T_g <= slot
  int lo = 0, hi = n_experts - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (ends[mid - 1] / BM + mid <= slot) lo = mid;
    else hi = mid - 1;
  }
  const int g = lo;
  const int start = g ? ends[g - 1] : 0;
  const int end = max(ends[g], start);
  const int row0 = start + (slot - (start / BM + g)) * BM;
  if (row0 >= end) return;  // a slot past its expert's rows
  const int rows = min(BM, end - row0);
  const __nv_bfloat16* wg = w + size_t(g) * k * n;
  const int n_k = (k + BK - 1) / BK;

  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
    for (int i = tid; i < BM * BK / 8; i += NT) {  // A: 64 rows x 4 pieces
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + c < k;
      cp_async16_zfill(&as[s][r * AROW + c],
                       ok ? xs + size_t(row0 + r) * k + k0 + c : xs, ok);
    }
    for (int i = tid; i < BK * BN / 8; i += NT) {  // B: 32 rows x 16 pieces
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < k && col0 + c < n;
      cp_async16_zfill(&bs[s][r * BROW + c],
                       ok ? wg + size_t(k0 + r) * n + col0 + c : wg, ok);
    }
  };

  // warp (wm, wn) owns rows [32 wm, 32 wm + 32) and columns
  // [64 wn, 64 wn + 64) of the tile: 2 x 8 m16n8 accumulators
  const int wm = warp / 2, wn = warp % 2;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait_stages();  // stage kt has landed (this thread's copies)
    __syncthreads();         // ... everyone's; stage kt - 1 is free
    if (kt + STAGES - 1 < n_k) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    hopper::cp_async_commit();
    const __nv_bfloat16* a_s = as[kt % STAGES];
    const __nv_bfloat16* b_s = bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a[mt], a_s + (wm * 32 + mt * 16 + lane % 16) * AROW +
                           kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // b0, b1 of n-tiles 2 np and 2 np + 1
        ldsm_x4_t(b, b_s + (kk * 16 + lane % 16) * BROW + wn * 64 + np * 16 +
                         (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // accumulator e of (mt, nt): row 32 wm + 16 mt + lane / 4 + 8 (e / 2),
  // column 64 wn + 8 nt + 2 (lane % 4) + e % 2
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + mt * 16 + lane / 4 + 8 * h;
      if (r >= rows) continue;
      float* orow = out + size_t(row0 + r) * n + col0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = wn * 64 + nt * 8 + 2 * (lane % 4);
        if (col0 + c < n)
          *reinterpret_cast<float2*>(orow + c) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

}  // namespace

extern "C" {

int grouped_gemm_max_experts() { return MAX_EXPERTS; }

const char* grouped_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue (launching nothing) for shapes out of the kernel's
// limits: 1 <= n_experts <= MAX_EXPERTS, K and N multiples of 8.
int grouped_gemm_bf16_f32(const void* xs, const void* w, const void* offs,
                          void* out, int m, int k, int n, int n_experts,
                          void* stream) {
  if (m < 0 || k < 8 || n < 8 || k % 8 || n % 8 || n_experts < 1 ||
      n_experts > MAX_EXPERTS || (n + BN - 1) / BN > MAX_GRID_Y)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(m / BM + n_experts, (n + BN - 1) / BN);
  grouped_gemm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xs),
      static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(offs),
      static_cast<float*>(out), m, k, n, n_experts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
