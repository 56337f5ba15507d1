// Mamba-1 selective scan for Hopper, with an optional carried state.
//
// Replaces: src/repro/kernels/mamba_scan.py:_scan_kernel (the Pallas TPU
// kernel behind mamba_scan / ops.selective_scan). Same function:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) outer B_t
//   y_t = h_t . C_t + D * x_t
// with x, dt (B, L, Di), A (Di, Ds), B_t, C_t (B, L, Ds), D (Di,), y (B, L, Di)
// and an f32 state. x, B, C and y share one dtype, f32 or bf16 (the model
// gives bf16); dt, A and D are f32 (the model's dt is softplus of a bf16
// projection plus an f32 bias). Beyond the TPU kernel (whose state starts at
// zero), the state may start from h0 (B, Di, Ds) f32 and the final state may
// be written to hT (B, Di, Ds) f32: the function the reference's carried-state
// calls compute through its oracle (prefill and decode of a recurrent cache).
//
// The TPU kernel walks a sequential (batch, Di / bd, L / chunk) grid and
// carries a (bd, Ds) state in VMEM scratch from one chunk step to the next.
// Here blocks run in parallel and in no order, so nothing may carry between
// them: one CTA owns a block of BD channels of one batch row for the whole
// sequence, and a loop over chunks inside it takes the place of the grid's
// time axis. The state lives in registers: SPLIT = 4 neighbouring threads
// share a channel, each keeping DS_PER = 4 of its <= MAX_DS = 16 f32 states,
// and y_t's sum over the state is two butterfly shuffles inside the 4 lanes.
// Each phase stages `chunk` time steps of the block's x and dt columns and of
// B_t, C_t in shared memory (as f32), one barrier on each side, then every
// thread runs the chunk's steps on its states. The arithmetic of a step does
// not depend on the chunk, so every plan gives the same output bit for bit.
//
// Bound on an H100: B * L * Di * Ds exponentials on the special function
// units (16 a clock on each of 132 SMs) against reading x, dt, B, C, A, D
// (and h0) once and writing y (and hT) once at 3.35 TB/s. At the serving
// path's prefill (L = 512, Di = 8192, Ds = 16) and the loss forward
// (L = 2048) the exponentials bind; a decode step (L = 1) is bound by the
// state's bytes. This first version computes each exponential with the
// accurate expf (the plain version's), keeps one CTA of 128 threads per 32
// channels, and leaves the chunked matrix form and the warp-specialised
// pipeline to later work.
//
// Layout: every tensor contiguous and row-major. Grid: (ceil(Di / BD), B).
// Channels past Di in the last block compute zeros and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_DS = 16;               // states per channel, in registers
constexpr int SPLIT = 4;                 // threads per channel
constexpr int DS_PER = MAX_DS / SPLIT;   // states per thread
constexpr int BD = 32;                   // channels per CTA
constexpr int NT = BD * SPLIT;           // 128 threads
constexpr int MAX_SMEM = 232448;         // H100: dynamic shared memory / block
constexpr int MAX_GRID_Y = 65535;

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* d;
  const float* h0;  // may be null: the state starts at zero
  void* y;
  float* ht;        // may be null: the final state is not written
  int length, di, ds, chunk;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared-memory bytes of one launch: `chunk` steps of the block's x and dt
// columns and of B_t, C_t, all as f32.
size_t smem_bytes(int chunk, int ds) {
  return sizeof(float) * size_t(chunk) * (2 * BD + 2 * ds);
}

// T is the dtype of x, B, C and y (f32 or bf16); dt is f32.
template <typename T>
__global__ void __launch_bounds__(NT) mamba_scan_kernel(Args p) {
  extern __shared__ float smem[];
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const float* __restrict__ dt = p.dt;
  const T* __restrict__ bm = static_cast<const T*>(p.b);
  const T* __restrict__ cm = static_cast<const T*>(p.c);
  T* __restrict__ y = static_cast<T*>(p.y);
  const int chunk = p.chunk, di = p.di, ds = p.ds;
  float* xs = smem;                 // [chunk][BD]
  float* dts = xs + chunk * BD;     // [chunk][BD]
  float* bs = dts + chunk * BD;     // [chunk][ds]
  float* cs = bs + chunk * ds;      // [chunk][ds]

  const int tid = threadIdx.x;
  const int cl = tid / SPLIT;                 // channel within the block
  const int part = tid % SPLIT;               // which DS_PER states
  const int c0 = blockIdx.x * BD;
  const int ch = c0 + cl;
  const int n_ch = min(BD, di - c0);          // live channels of the block
  const bool live = cl < n_ch;
  const size_t row0 = size_t(blockIdx.y) * p.length;  // (b, t = 0)

  float av[DS_PER], h[DS_PER];
#pragma unroll
  for (int j = 0; j < DS_PER; ++j) {
    const int s = part * DS_PER + j;
    const bool on = live && s < ds;
    const size_t hs = (size_t(blockIdx.y) * di + ch) * ds + s;
    av[j] = on ? p.a[size_t(ch) * ds + s] : 0.f;
    h[j] = (on && p.h0 != nullptr) ? p.h0[hs] : 0.f;
  }
  const float dv = live ? p.d[ch] : 0.f;

  for (int t0 = 0; t0 < p.length; t0 += chunk) {
    for (int i = tid; i < chunk * BD; i += NT) {
      const int t = i / BD, k = i - t * BD;
      const size_t g = (row0 + t0 + t) * di + c0 + k;
      xs[i] = k < n_ch ? to_f32(x[g]) : 0.f;
      dts[i] = k < n_ch ? dt[g] : 0.f;
    }
    for (int i = tid; i < chunk * ds; i += NT) {
      const size_t g = (row0 + t0) * ds + i;
      bs[i] = to_f32(bm[g]);
      cs[i] = to_f32(cm[g]);
    }
    __syncthreads();
    for (int t = 0; t < chunk; ++t) {
      const float xt = xs[t * BD + cl];
      const float dtt = dts[t * BD + cl];
      const float dx = dtt * xt;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < DS_PER; ++j) {
        const int s = part * DS_PER + j;
        if (s < ds) {
          h[j] = expf(dtt * av[j]) * h[j] + dx * bs[t * ds + s];
          acc += h[j] * cs[t * ds + s];
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (live && part == 0) store(&y[(row0 + t0 + t) * di + ch], acc + dv * xt);
    }
    __syncthreads();  // every thread is done with the stage before the next
  }

  if (p.ht != nullptr && live) {
#pragma unroll
    for (int j = 0; j < DS_PER; ++j) {
      const int s = part * DS_PER + j;
      if (s < ds) p.ht[(size_t(blockIdx.y) * di + ch) * ds + s] = h[j];
    }
  }
}

template <typename T>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream) {
  auto kernel = mamba_scan_kernel<T>;
  const size_t smem = smem_bytes(p.chunk, p.ds);
  if (smem > 48 * 1024) {
    // above 48 KB a launch is refused unless the kernel opts in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.di + BD - 1) / BD, batch);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int mamba_scan(const void* x, const void* dt, const void* a, const void* b,
               const void* c, const void* d, const void* h0, void* y,
               void* ht, int batch, int length, int di, int ds, int chunk,
               int bf16, void* stream) {
  if (batch < 1 || batch > MAX_GRID_Y || length < 1 || di < 1 || ds < 1 ||
      ds > MAX_DS || chunk < 1 || length % chunk ||
      smem_bytes(chunk, ds) > size_t(MAX_SMEM))
    return int(cudaErrorInvalidValue);
  const Args p{x, static_cast<const float*>(dt),
               static_cast<const float*>(a), b, c,
               static_cast<const float*>(d), static_cast<const float*>(h0),
               y, static_cast<float*>(ht), length, di, ds, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(bf16 ? launch<__nv_bfloat16>(p, batch, s)
                  : launch<float>(p, batch, s));
}

const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
