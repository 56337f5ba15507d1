// Capacity-planned tiled matmul for Hopper: the paper's kernel.
//
// Replaces: src/repro/kernels/matmul3d.py:_matmul_kernel (the Pallas TPU
// kernel behind matmul3d / ops.matmul). Same function: (M,K) @ (K,N) with
// (bm, bk, bn) blocks from the capacity planner, an f32 accumulator held
// across the whole K loop, and one cast to the output dtype on the store.
//
// Design: one CTA per (bm, bn) output tile, 256 threads as a 16 x 16 grid.
// The K loop stages the A (bm, bk) and B (bk, bn) tiles in dynamic shared
// memory sized from the plan: two copies of each (the plan's n_buffers, which
// must be 2), kept in the input dtype, so the streamed bytes the planner
// counts are the bytes the kernel claims. The next K step's tiles are loaded
// before this step's products (one barrier per K step), the counterpart of
// the double-buffered DMA that Pallas derives from the TPU kernel's
// BlockSpecs. Thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j of a sub-tile: TM x TN
// f32 accumulators with TM, TN in {2, 4, 8}. Where the plan's resident C
// tile lives: in registers when bm, bn <= 128 (one sub-tile covers it; every
// plan of the paper sweep), else in shared memory after the A/B buffers, as
// MemPool keeps all three tiles in its scratchpad. There each K step sums
// each 128 x 128 sub-tile in registers and adds it into the C tile; a
// thread only ever touches its own C elements, so C needs no barrier. Rows
// and columns past a ragged bm or bn (a plan clamped to a small problem)
// read clamped indices and are never stored.
//
// Bound on an H100: 2 M N K operations over the peak rate of the input type
// (989 TFLOP/s bf16 on the tensor cores; 67 TFLOP/s f32 outside them)
// against reading A and B once and writing C once at 3.35 TB/s; at the
// paper sweep's M = 8192 that is the operations (1.11 ms in bf16). This
// first version multiplies with scalar f32 FMAs, so it is held by the FP32
// pipes and by shared-memory reads (TM + TN loads per TM x TN FMAs), far
// from the tensor-core bound; wgmma tiles fed by TMA are later work.
//
// Layout: a (M, K) and b (K, N) row-major and contiguous, with M % bm ==
// K % bk == N % bn == 0 (the wrapper checks; ops.matmul pads); c (M, N)
// row-major, f32 or bf16. Grid: (N / bn, M / bm).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                  // threads per CTA
constexpr int TDIM = 16;                 // 16 x 16 thread grid
constexpr int MAX_T = 8;                 // accumulators per thread and axis
constexpr int MAX_REG_BLOCK = TDIM * MAX_T;  // 128: C in registers up to here
constexpr int N_BUFFERS = 2;            // A/B buffers: double buffering
constexpr int MAX_SMEM = 232448;         // H100: dynamic shared memory / block
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Copy a (rows, cols) tile with leading dimension ld into dst (row-major,
// packed). Consecutive threads read consecutive columns: coalesced.
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int rows, int cols, long long ld) {
  const int count = rows * cols;
  for (int i = threadIdx.x; i < count; i += NT) {
    const int r = i / cols;
    dst[i] = src[r * ld + (i - r * cols)];
  }
}

// Shared-memory bytes of one launch: the buffered A/B tiles, then (for
// tiles past MAX_REG_BLOCK) the f32 C tile at a 16-byte boundary.
size_t smem_bytes(int bm, int bn, int bk, size_t in_bytes) {
  const size_t streamed =
      size_t(N_BUFFERS) * (size_t(bm) * bk + size_t(bk) * bn) * in_bytes;
  if (bm <= MAX_REG_BLOCK && bn <= MAX_REG_BLOCK) return streamed;
  return (streamed + 15) / 16 * 16 + sizeof(float) * size_t(bm) * bn;
}

template <typename T, int TM, int TN, bool C_SMEM>
__global__ void __launch_bounds__(NT)
matmul3d_kernel(const T* __restrict__ a, const T* __restrict__ b,
                void* __restrict__ c, int n, int k, int bm, int bn, int bk,
                int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int buf_elems = bm * bk + bk * bn;  // one buffer: A tile, then B tile
  const size_t streamed = size_t(N_BUFFERS) * buf_elems * sizeof(T);
  float* cs = reinterpret_cast<float*>(smem_raw + (streamed + 15) / 16 * 16);
  const int tx = threadIdx.x % TDIM, ty = threadIdx.x / TDIM;
  const long long row0 = (long long)blockIdx.y * bm;
  const long long col0 = (long long)blockIdx.x * bn;
  const T* a_blk = a + row0 * k;
  const T* b_blk = b + col0;
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

  auto load = [&](int kt, T* buf) {
    load_tile(buf, a_blk + (long long)kt * bk, bm, bk, k);
    load_tile(buf + bm * bk, b_blk + (long long)kt * bk * n, bk, bn, n);
  };

  const int nk = k / bk;
  load(0, smem);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    T* buf = smem + (kt & 1) * buf_elems;
    if (kt + 1 < nk) {
      // the other buffer was last read in step kt - 1, before its barrier
      load(kt + 1, smem + ((kt + 1) & 1) * buf_elems);
    }
    const T* as = buf;
    const T* bs = buf + bm * bk;
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
          for (int i = 0; i < TM; ++i) av[i] = to_f32(as[a_off[i] + kk]);
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = to_f32(bs[kk * bn + b_off[j]]);
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

template <typename T, int TM, int TN, bool C_SMEM = false>
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k,
                   int bm, int bn, int bk, int out_bf16,
                   cudaStream_t stream) {
  auto kernel = matmul3d_kernel<T, TM, TN, C_SMEM>;
  const size_t smem = smem_bytes(bm, bn, bk, sizeof(T));
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n / bn, m / bm);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(a),
                                     static_cast<const T*>(b), c, n, k, bm,
                                     bn, bk, out_bf16);
  return cudaGetLastError();
}

template <typename T, int TM>
cudaError_t launch_tn(const void* a, const void* b, void* c, int m, int n,
                      int k, int bm, int bn, int bk, int out_bf16,
                      cudaStream_t stream) {
  switch (per_thread(bn)) {
    case 2:
      return launch<T, TM, 2>(a, b, c, m, n, k, bm, bn, bk, out_bf16, stream);
    case 4:
      return launch<T, TM, 4>(a, b, c, m, n, k, bm, bn, bk, out_bf16, stream);
    default:
      return launch<T, TM, 8>(a, b, c, m, n, k, bm, bn, bk, out_bf16, stream);
  }
}

template <typename T>
int run(const void* a, const void* b, void* c, int m, int n, int k, int bm,
        int bn, int bk, int n_buffers, int out_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm < 1 || bn < 1 || bk < 1 ||
      n_buffers != N_BUFFERS || m % bm || n % bn || k % bk ||
      m / bm > MAX_GRID_Y ||
      smem_bytes(bm, bn, bk, sizeof(T)) > size_t(MAX_SMEM))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm > MAX_REG_BLOCK || bn > MAX_REG_BLOCK)
    return int(launch<T, MAX_T, MAX_T, true>(a, b, c, m, n, k, bm, bn, bk,
                                             out_bf16, s));
  switch (per_thread(bm)) {
    case 2:
      return int(launch_tn<T, 2>(a, b, c, m, n, k, bm, bn, bk, out_bf16, s));
    case 4:
      return int(launch_tn<T, 4>(a, b, c, m, n, k, bm, bn, bk, out_bf16, s));
    default:
      return int(launch_tn<T, 8>(a, b, c, m, n, k, bm, bn, bk, out_bf16, s));
  }
}

}  // namespace

extern "C" {

int matmul3d_f32(const void* a, const void* b, void* c, int m, int n, int k,
                 int bm, int bn, int bk, int n_buffers, int out_bf16,
                 void* stream) {
  return run<float>(a, b, c, m, n, k, bm, bn, bk, n_buffers, out_bf16,
                    stream);
}

int matmul3d_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                  int bm, int bn, int bk, int n_buffers, int out_bf16,
                  void* stream) {
  return run<__nv_bfloat16>(a, b, c, m, n, k, bm, bn, bk, n_buffers,
                            out_bf16, stream);
}

const char* matmul3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
