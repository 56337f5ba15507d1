// Capacity-planned tiled matmul for Hopper: the paper's kernel.
//
// Replaces: src/repro/kernels/matmul3d.py:_matmul_kernel (the Pallas TPU
// kernel behind matmul3d / ops.matmul). Same function: (M,K) @ (K,N) with
// (bm, bk, bn) blocks from the capacity planner, an f32 accumulator held
// across the whole K loop, and one cast to the output dtype on the store.
// Both kernels below claim the plan's shared memory and nothing more: two
// buffers of the A (bm, bk) and B (bk, bn) tiles in the input dtype (the
// planner's n_buffers * streamed bytes), plus the f32 C tile where it does
// not fit registers (bm or bn above 128), as MemPool keeps all three tiles
// in its scratchpad. One CTA per (bm, bn) output tile; grid (N/bn, M/bm).
//
// bf16 inputs: tensor cores (matmul3d_tc_kernel). Warp-specialised: one
// producer warp keeps TMA loads (cp.async.bulk.tensor.2d) of the next A and
// B tiles in flight into a ring of N_BUFFERS = 2 stages, each with a full
// and an empty mbarrier; bm / 64 consumer warpgroups (at most 2) issue
// wgmma.mma_async m64n{bn}k16 over each stage, A K-major and B MN-major
// ((K, N) row-major, read as it lies: no transposed copy). Tiles sit in
// shared memory as 64- or 128-byte-swizzled chunks of 32 or 64 columns
// (128B whenever bk, resp. bn, is a multiple of 64: every sweep plan's B,
// and the default plan's A); see hopper.cuh. C lives in the consumers'
// registers (64 rows x bn per warpgroup) when bm, bn <= 128 (every plan of
// the paper sweep); beyond that it lives in shared memory after the ring,
// and each stage adds 64 x 64 (or 64 x 32) register sub-tiles into it. The
// kernel takes bm % 64 == 0 (wgmma's M per warpgroup), bn % 32 == 0 and
// bk % 32 == 0: matmul3d.py rounds a plan clamped to a small problem up to
// that grain and pads (every h100 plan of a problem at least its size is
// already on it). Bound: at the sweep's M = 8192 the operations bound is
// 1.11 ms (989 TFLOP/s bf16); the plan's own HBM traffic (A read N/bn
// times, B M/bm times: 16.25 GiB at the default (128, 64, 128)) would be
// 5.2 ms at 3.35 TB/s, but L2 catches much of the reuse. What holds this
// kernel first is the 2-stage ring: a stage's loads go out only when the
// stage before it is released, so time follows the number of stages (K /
// bk per tile) and the tile size, both set by the plan: the paper's
// capacity law, through latency more than bytes (PERF.md).
//
// f32 inputs: CUDA cores (matmul3d_f32_kernel). No tensor-core instruction
// multiplies full f32: TF32 keeps ~3 decimal digits and misses the sweep's
// 1e-4 relative tolerance at K = 8192. 256 threads as a 16 x 16 grid; each
// K step loads the next A/B tiles (per-thread loads) before this step's
// scalar FMAs (one barrier per step); thread (ty, tx) owns rows ty + 16 i
// and columns tx + 16 j of a sub-tile: TM x TN f32 accumulators with TM,
// TN in {2, 4, 8}. C in registers when bm, bn <= 128, else in shared memory
// (each K step adds each 128 x 128 sub-tile into it). Held by the FP32
// pipes (67 TFLOP/s) and shared-memory reads, not by HBM. Rows and columns
// past a ragged bm or bn read clamped indices and are never stored.
//
// Layout: a (M, K) and b (K, N) row-major and contiguous, with M % bm ==
// K % bk == N % bn == 0 (the wrapper checks; ops.matmul pads); c (M, N)
// row-major, f32 or bf16.

#include "hopper.cuh"

namespace {

constexpr int N_BUFFERS = 2;             // A/B buffers: double buffering
constexpr int MAX_SMEM = 232448;         // H100: dynamic shared memory / block
constexpr int MAX_GRID_Y = 65535;
constexpr int MAX_REG_BLOCK = 128;       // C in registers up to 128 x 128

// ------------------------------------------------ f32: CUDA-core kernel

constexpr int NT = 256;                  // threads per CTA
constexpr int TDIM = 16;                 // 16 x 16 thread grid
constexpr int MAX_T = 8;                 // accumulators per thread and axis
static_assert(TDIM * MAX_T == MAX_REG_BLOCK, "one sub-tile covers 128 x 128");

// Copy a (rows, cols) tile with leading dimension ld into dst (row-major,
// packed). Consecutive threads read consecutive columns: coalesced.
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int rows, int cols, long long ld) {
  const int count = rows * cols;
  for (int i = threadIdx.x; i < count; i += NT) {
    const int r = i / cols;
    dst[i] = src[r * ld + (i - r * cols)];
  }
}

// Shared-memory bytes of one f32 launch: the buffered A/B tiles, then (for
// tiles past MAX_REG_BLOCK) the f32 C tile at a 16-byte boundary.
size_t f32_smem_bytes(int bm, int bn, int bk) {
  const size_t streamed =
      size_t(N_BUFFERS) * (size_t(bm) * bk + size_t(bk) * bn) * sizeof(float);
  if (bm <= MAX_REG_BLOCK && bn <= MAX_REG_BLOCK) return streamed;
  return (streamed + 15) / 16 * 16 + sizeof(float) * size_t(bm) * bn;
}

template <int TM, int TN, bool C_SMEM>
__global__ void __launch_bounds__(NT)
matmul3d_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    void* __restrict__ c, int n, int k, int bm, int bn,
                    int bk, int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int buf_elems = bm * bk + bk * bn;  // one buffer: A tile, then B tile
  const size_t streamed = size_t(N_BUFFERS) * buf_elems * sizeof(float);
  float* cs = reinterpret_cast<float*>(smem_raw + (streamed + 15) / 16 * 16);
  const int tx = threadIdx.x % TDIM, ty = threadIdx.x / TDIM;
  const long long row0 = (long long)blockIdx.y * bm;
  const long long col0 = (long long)blockIdx.x * bn;
  const float* a_blk = a + row0 * k;
  const float* b_blk = b + col0;
  constexpr int SUB_M = TDIM * TM, SUB_N = TDIM * TN;
  const int n_sub_m = C_SMEM ? (bm + SUB_M - 1) / SUB_M : 1;
  const int n_sub_n = C_SMEM ? (bn + SUB_N - 1) / SUB_N : 1;

  if (C_SMEM) {  // each thread zeroes the C elements it owns
    for (int r = ty; r < bm; r += TDIM)
      for (int cc = tx; cc < bn; cc += TDIM) cs[r * bn + cc] = 0.f;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto load = [&](int kt, float* buf) {
    load_tile(buf, a_blk + (long long)kt * bk, bm, bk, k);
    load_tile(buf + bm * bk, b_blk + (long long)kt * bk * n, bk, bn, n);
  };

  const int nk = k / bk;
  load(0, smem);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    float* buf = smem + (kt & 1) * buf_elems;
    if (kt + 1 < nk) {
      // the other buffer was last read in step kt - 1, before its barrier
      load(kt + 1, smem + ((kt + 1) & 1) * buf_elems);
    }
    const float* as = buf;
    const float* bs = buf + bm * bk;
    for (int sm = 0; sm < n_sub_m; ++sm) {
      for (int sn = 0; sn < n_sub_n; ++sn) {
        int a_off[TM], b_off[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a_off[i] = min(sm * SUB_M + ty + TDIM * i, bm - 1) * bk;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          b_off[j] = min(sn * SUB_N + tx + TDIM * j, bn - 1);
        if (C_SMEM) {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
        }
#pragma unroll 4
        for (int kk = 0; kk < bk; ++kk) {
          float av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = as[a_off[i] + kk];
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = bs[kk * bn + b_off[j]];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        if (C_SMEM) {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int r = sm * SUB_M + ty + TDIM * i;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int cc = sn * SUB_N + tx + TDIM * j;
              if (r < bm && cc < bn) cs[r * bn + cc] += acc[i][j];
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before step
                      // kt + 1 refills it
  }

  for (int sm = 0; sm < n_sub_m; ++sm) {
    for (int sn = 0; sn < n_sub_n; ++sn) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = sm * SUB_M + ty + TDIM * i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int cc = sn * SUB_N + tx + TDIM * j;
          if (r >= bm || cc >= bn) continue;
          const float v = C_SMEM ? cs[r * bn + cc] : acc[i][j];
          const long long idx = (row0 + r) * n + col0 + cc;
          if (out_bf16)
            reinterpret_cast<__nv_bfloat16*>(c)[idx] = __float2bfloat16(v);
          else
            reinterpret_cast<float*>(c)[idx] = v;
        }
      }
    }
  }
}

int per_thread(int block) { return block <= 32 ? 2 : (block <= 64 ? 4 : 8); }

template <int TM, int TN, bool C_SMEM = false>
cudaError_t launch_f32(const void* a, const void* b, void* c, int m, int n,
                       int k, int bm, int bn, int bk, int out_bf16,
                       cudaStream_t stream) {
  auto kernel = matmul3d_f32_kernel<TM, TN, C_SMEM>;
  const size_t smem = f32_smem_bytes(bm, bn, bk);
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n / bn, m / bm);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const float*>(a),
                                     static_cast<const float*>(b), c, n, k,
                                     bm, bn, bk, out_bf16);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_f32_tn(const void* a, const void* b, void* c, int m,
                          int n, int k, int bm, int bn, int bk, int out_bf16,
                          cudaStream_t stream) {
  switch (per_thread(bn)) {
    case 2:
      return launch_f32<TM, 2>(a, b, c, m, n, k, bm, bn, bk, out_bf16,
                               stream);
    case 4:
      return launch_f32<TM, 4>(a, b, c, m, n, k, bm, bn, bk, out_bf16,
                               stream);
    default:
      return launch_f32<TM, 8>(a, b, c, m, n, k, bm, bn, bk, out_bf16,
                               stream);
  }
}

int run_f32(const void* a, const void* b, void* c, int m, int n, int k,
            int bm, int bn, int bk, int n_buffers, int out_bf16,
            void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm < 1 || bn < 1 || bk < 1 ||
      n_buffers != N_BUFFERS || m % bm || n % bn || k % bk ||
      m / bm > MAX_GRID_Y || f32_smem_bytes(bm, bn, bk) > size_t(MAX_SMEM))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm > MAX_REG_BLOCK || bn > MAX_REG_BLOCK)
    return int(launch_f32<MAX_T, MAX_T, true>(a, b, c, m, n, k, bm, bn, bk,
                                              out_bf16, s));
  switch (per_thread(bm)) {
    case 2:
      return int(launch_f32_tn<2>(a, b, c, m, n, k, bm, bn, bk, out_bf16, s));
    case 4:
      return int(launch_f32_tn<4>(a, b, c, m, n, k, bm, bn, bk, out_bf16, s));
    default:
      return int(launch_f32_tn<8>(a, b, c, m, n, k, bm, bn, bk, out_bf16, s));
  }
}

// -------------------------------------------- bf16: tensor-core kernel

constexpr int WG = 128;                  // threads per warpgroup
constexpr int TC_M = 64;                 // rows per consumer warpgroup
constexpr int TC_N = 32;                 // bn grain (wgmma N: 32..128)
constexpr int TC_K = 32;                 // bk grain (one 64B-swizzled chunk)
constexpr int A_BOX_ROWS = 64;           // rows of one TMA box of A
constexpr int B_BOX_ROWS = 32;           // K-rows of one TMA box of B
constexpr int BARRIER_BYTES = 2 * N_BUFFERS * 8;  // full + empty mbarriers

// Columns of one swizzled chunk along a tile's contiguous axis.
__host__ __device__ __forceinline__ int chunk_cols(int cols) {
  return cols % 64 == 0 ? 64 : 32;
}

// Shared-memory bytes of one bf16 launch: the ring of A/B tiles (1024-byte
// aligned chunks, as the swizzle needs), the f32 C tile when it does not
// fit registers, then the mbarriers.
size_t tc_smem_bytes(int bm, int bn, int bk) {
  size_t bytes = size_t(N_BUFFERS) * (size_t(bm) * bk + size_t(bk) * bn) * 2;
  if (bm > MAX_REG_BLOCK || bn > MAX_REG_BLOCK)
    bytes += sizeof(float) * size_t(bm) * bn;
  return bytes + BARRIER_BYTES;
}

// N: the wgmma width (bn when C stays in registers; the chunk width, 32 or
// 64, when C lives in shared memory). NWG: consumer warpgroups.
template <int N, int NWG, bool C_SMEM>
__global__ void __launch_bounds__(NWG * WG + 32)
matmul3d_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   void* __restrict__ c, int n, int k, int bm, int bn,
                   int bk, int out_bf16) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int cw_a = chunk_cols(bk), cw_b = chunk_cols(bn);
  const int a_bytes = bm * bk * 2;
  const int stage_bytes = a_bytes + bk * bn * 2;
  size_t off = size_t(N_BUFFERS) * stage_bytes;
  float* cs = reinterpret_cast<float*>(smem + off);
  if (C_SMEM) off += sizeof(float) * size_t(bm) * bn;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + off);
  uint64_t* empty = full + N_BUFFERS;
  constexpr int CONSUMERS = NWG * WG;
  const int tid = threadIdx.x;
  if (tid == 0) {
    if (hopper::smem_addr(smem) & 1023) __trap();  // swizzle needs 1024 B
    for (int s = 0; s < N_BUFFERS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int nk = k / bk;

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues every load
    if (tid == CONSUMERS) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % N_BUFFERS;
        if (kt >= N_BUFFERS)
          hopper::mbar_wait(&empty[s], ((kt / N_BUFFERS) - 1) & 1);
        unsigned char* a_s = smem + size_t(s) * stage_bytes;
        unsigned char* b_s = a_s + a_bytes;
        hopper::mbar_expect_tx(&full[s], stage_bytes);
        for (int ch = 0; ch < bk / cw_a; ++ch)
          for (int r = 0; r < bm; r += A_BOX_ROWS)
            hopper::tma_load_2d(a_s + (ch * bm + r) * cw_a * 2, &map_a,
                                &full[s], kt * bk + ch * cw_a, m0 + r);
        for (int ch = 0; ch < bn / cw_b; ++ch)
          for (int r = 0; r < bk; r += B_BOX_ROWS)
            hopper::tma_load_2d(b_s + (ch * bk + r) * cw_b * 2, &map_b,
                                &full[s], n0 + ch * cw_b, kt * bk + r);
      }
    }
    return;
  }

  // Consumers. wgmma's accumulator layout: register 4 j + 2 h + e of a
  // thread holds row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  // of its warpgroup's 64 x N block.
  const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
  const int row_in = 16 * warp + lane / 4, col_in = 2 * (lane % 4);
  const uint32_t lbo_b = uint32_t(bk) * cw_b * 2;  // B: chunk to chunk
  constexpr int NR = N / 2;
  float acc[NR];

  auto a_desc = [&](const unsigned char* a_s, int slab, int kk) {
    const int ka = kk * 16;
    return hopper::desc(
        a_s + ((ka / cw_a) * bm + slab * TC_M) * cw_a * 2 + (ka % cw_a) * 2,
        cw_a, 16);
  };
  auto b_desc = [&](const unsigned char* b_s, int col, int kk) {
    return hopper::desc(b_s + ((col / cw_b) * bk + kk * 16) * cw_b * 2, cw_b,
                        lbo_b);
  };
  auto store = [&](int r, int cc, float v0, float v1) {
    const long long idx = (long long)(m0 + r) * n + n0 + cc;
    if (out_bf16)
      *reinterpret_cast<__nv_bfloat162*>(
          reinterpret_cast<__nv_bfloat16*>(c) + idx) =
          __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(c) + idx) =
          make_float2(v0, v1);
  };

  if (!C_SMEM) {  // C in registers: warpgroup wg owns rows 64 wg .. + 63
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % N_BUFFERS;
      hopper::mbar_wait(&full[s], (kt / N_BUFFERS) & 1);
      const unsigned char* a_s = smem + size_t(s) * stage_bytes;
      const unsigned char* b_s = a_s + a_bytes;
      hopper::reg_fence<NR>(acc);
      hopper::wgmma_fence();
      for (int kk = 0; kk < bk / 16; ++kk)
        hopper::Wgmma<N>::template ss<1>(acc, a_desc(a_s, wg, kk),
                                         b_desc(b_s, 0, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::reg_fence<NR>(acc);
      hopper::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(wg * TC_M + row_in + 8 * h, 8 * j + col_in, acc[4 * j + 2 * h],
              acc[4 * j + 2 * h + 1]);
    return;
  }

  // C in shared memory: warpgroup wg owns the 64-row slabs wg, wg + NWG, ...
  // and, in them, the elements its threads hold in the accumulator layout;
  // no thread touches another's C elements, so C needs no barrier.
  const int slabs = bm / TC_M, subs = bn / N;
  for (int slab = wg; slab < slabs; slab += NWG)
    for (int sub = 0; sub < subs; ++sub)
#pragma unroll
      for (int i = 0; i < NR; ++i)
        cs[(slab * TC_M + row_in + 8 * ((i / 2) % 2)) * bn + sub * N +
           8 * (i / 4) + col_in + i % 2] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % N_BUFFERS;
    hopper::mbar_wait(&full[s], (kt / N_BUFFERS) & 1);
    const unsigned char* a_s = smem + size_t(s) * stage_bytes;
    const unsigned char* b_s = a_s + a_bytes;
    for (int slab = wg; slab < slabs; slab += NWG) {
      for (int sub = 0; sub < subs; ++sub) {
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i] = 0.f;
        hopper::reg_fence<NR>(acc);
        hopper::wgmma_fence();
        for (int kk = 0; kk < bk / 16; ++kk)
          hopper::Wgmma<N>::template ss<1>(acc, a_desc(a_s, slab, kk),
                                           b_desc(b_s, sub * N, kk), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::reg_fence<NR>(acc);
#pragma unroll
        for (int i = 0; i < NR; ++i)
          cs[(slab * TC_M + row_in + 8 * ((i / 2) % 2)) * bn + sub * N +
             8 * (i / 4) + col_in + i % 2] += acc[i];
      }
    }
    hopper::mbar_arrive(&empty[s]);
  }
  for (int slab = wg; slab < slabs; slab += NWG)
    for (int sub = 0; sub < subs; ++sub)
#pragma unroll
      for (int i = 0; i < NR; i += 2) {
        const int r = slab * TC_M + row_in + 8 * ((i / 2) % 2);
        const int cc = sub * N + 8 * (i / 4) + col_in;
        store(r, cc, cs[r * bn + cc], cs[r * bn + cc + 1]);
      }
}

template <int N, int NWG, bool C_SMEM>
cudaError_t launch_tc(const CUtensorMap& map_a, const CUtensorMap& map_b,
                      void* c, int m, int n, int k, int bm, int bn, int bk,
                      int out_bf16, cudaStream_t stream) {
  auto kernel = matmul3d_tc_kernel<N, NWG, C_SMEM>;
  const size_t smem = tc_smem_bytes(bm, bn, bk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n / bn, m / bm);
  kernel<<<grid, NWG * WG + 32, smem, stream>>>(map_a, map_b, c, n, k, bm,
                                                bn, bk, out_bf16);
  return cudaGetLastError();
}

int run_bf16(const void* a, const void* b, void* c, int m, int n, int k,
             int bm, int bn, int bk, int n_buffers, int out_bf16,
             void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n_buffers != N_BUFFERS || bm < TC_M ||
      bn < TC_N || bk < TC_K || bm % TC_M || bn % TC_N || bk % TC_K ||
      m % bm || n % bn || k % bk || m / bm > MAX_GRID_Y ||
      tc_smem_bytes(bm, bn, bk) > size_t(MAX_SMEM) ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return int(cudaErrorInvalidValue);
  const int cw_a = chunk_cols(bk), cw_b = chunk_cols(bn);
  CUtensorMap map_a, map_b;
  const cuuint64_t a_dims[2] = {cuuint64_t(k), cuuint64_t(m)};
  const cuuint64_t a_strides[1] = {cuuint64_t(k) * 2};
  const cuuint32_t a_box[2] = {cuuint32_t(cw_a), A_BOX_ROWS};
  const cuuint64_t b_dims[2] = {cuuint64_t(n), cuuint64_t(k)};
  const cuuint64_t b_strides[1] = {cuuint64_t(n) * 2};
  const cuuint32_t b_box[2] = {cuuint32_t(cw_b), B_BOX_ROWS};
  cudaError_t err = hopper::make_map(&map_a, a, 2, a_dims, a_strides, a_box,
                                     cw_a);
  if (err == cudaSuccess)
    err = hopper::make_map(&map_b, b, 2, b_dims, b_strides, b_box, cw_b);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm > MAX_REG_BLOCK || bn > MAX_REG_BLOCK) {
    err = cw_b == 64
              ? launch_tc<64, 2, true>(map_a, map_b, c, m, n, k, bm, bn, bk,
                                       out_bf16, s)
              : launch_tc<32, 2, true>(map_a, map_b, c, m, n, k, bm, bn, bk,
                                       out_bf16, s);
    return int(err);
  }
#define MATMUL3D_TC(N)                                                        \
  (bm == TC_M ? launch_tc<N, 1, false>(map_a, map_b, c, m, n, k, bm, bn, bk, \
                                       out_bf16, s)                           \
              : launch_tc<N, 2, false>(map_a, map_b, c, m, n, k, bm, bn, bk, \
                                       out_bf16, s))
  switch (bn) {
    case 32: err = MATMUL3D_TC(32); break;
    case 64: err = MATMUL3D_TC(64); break;
    case 96: err = MATMUL3D_TC(96); break;
    default: err = MATMUL3D_TC(128); break;
  }
#undef MATMUL3D_TC
  return int(err);
}

}  // namespace

extern "C" {

int matmul3d_f32(const void* a, const void* b, void* c, int m, int n, int k,
                 int bm, int bn, int bk, int n_buffers, int out_bf16,
                 void* stream) {
  return run_f32(a, b, c, m, n, k, bm, bn, bk, n_buffers, out_bf16, stream);
}

int matmul3d_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                  int bm, int bn, int bk, int n_buffers, int out_bf16,
                  void* stream) {
  return run_bf16(a, b, c, m, n, k, bm, bn, bk, n_buffers, out_bf16, stream);
}

const char* matmul3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
