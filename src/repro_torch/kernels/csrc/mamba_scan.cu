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
// hT may be h0 itself: each thread reads its own states before it writes the
// same addresses, so the caller's cache is updated in place.
//
// The TPU kernel walks a sequential (batch, Di / bd, L / chunk) grid and
// carries a (bd, Ds) state in VMEM scratch from one chunk step to the next.
// Here blocks run in parallel and in no order, so nothing may carry between
// them: one CTA owns BD = 16 channels of one batch row for the whole
// sequence, and a loop over stages inside it takes the place of the grid's
// time axis.
//
// Bound on an H100: B * L * Di * Ds exponentials on the special function
// units (16 a clock on each of 132 SMs) against reading x, dt, B, C, A, D
// (and h0) once and writing y (and hT) once at 3.35 TB/s. At the serving
// path's prefill (L = 512, Di = 8192, Ds = 16) and the loss forward
// (L = 2048) the exponentials bind; a decode step (L = 1) is bound by the
// state's bytes. Each step of one channel depends on the step before (exp,
// then an FMA), so what the design does is keep many independent chains in
// flight and the loads off the chain:
//   - one thread per (channel, state): 16 lanes a channel, so B = 1,
//     Di = 8192 runs 131072 threads (~31 warps an SM) and each thread's
//     serial exp2 -> FMA chain is hidden by the others';
//   - y_t's sum over the 16 states is taken for 8 steps at once by a
//     transposed butterfly (4 + 2 + 1 + 1 shuffles for 8 sums, where one
//     sum alone takes 4): the step's value is the butterfly xor 8, 4, 2, 1
//     of its 16 products whatever the grouping, so it does not depend on
//     the chunk;
//   - a ring of NSTAGE = 2 shared-memory stages, each a whole number of
//     the plan's chunks and at least MIN_STAGE_STEPS steps of the block's
//     x and dt columns and of B_t, C_t, in their input dtypes: the next
//     stage is in flight (cp.async, 16 bytes a thread, element copies for
//     an unaligned or ragged edge) while one is stepped. A chunk of 8 (the
//     h100 plan) alone would leave one 8-step stage to hide a load's
//     latency and two barriers per 8 steps;
//   - a landed stage is transposed, SUB steps at a time, into f32 rows by
//     channel (x, dt) and by state (B, C), so that a thread reads 8 steps
//     of each with two 16-byte loads instead of 32 scalar loads and 24
//     conversions: instruction issue and shared-memory loads, not the
//     exponentials, bound the step loop;
//   - y is staged in shared memory and written a row (the block's 16
//     channels) at a time;
//   - exp(dt * A) as exp2(dt * A * log2 e) on the special function unit,
//     A pre-scaled once per thread; the per-thread constants load while
//     the first stages are in flight.
// Each channel walks the sequence in order with the same arithmetic per
// step whatever the chunk, so every plan gives the same output bit for bit,
// and a batch row's output does not depend on the other rows.
//
// Layout: every tensor contiguous and row-major. Grid: (ceil(Di / BD), B).
// Channels past Di in the last block compute junk and store nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_DS = 16;               // states per channel, one a thread
constexpr int LANES = MAX_DS;            // threads per channel
constexpr int BD = 16;                   // channels per CTA
constexpr int NT = BD * LANES;           // 256 threads
constexpr int GROUP = 8;                 // steps per transposed y reduction
constexpr int SUB = 64;                  // steps per transposed sub-block
constexpr int MIN_STAGE_STEPS = SUB;     // a stage: whole chunks, >= this
constexpr int NSTAGE = 2;                // ring: one stepped, one landing
constexpr int MAX_SMEM = 232448;         // H100: dynamic shared memory / block
constexpr int MAX_GRID_Y = 65535;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* d;
  const float* h0;  // may be null: the state starts at zero
  void* y;
  float* ht;        // may be null (final state not written), or h0
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

// 2^x on the special function unit (relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Steps of one stage: whole chunks of the plan, at least MIN_STAGE_STEPS.
__host__ __device__ inline int stage_steps(int chunk) {
  return chunk * ((MIN_STAGE_STEPS + chunk - 1) / chunk);
}

// Bytes of one stage row (a time step): the block's x (es bytes an
// element) and dt (f32) columns and B_t, C_t padded to MAX_DS (es bytes).
// Each region of a stage is 16-byte aligned.
__host__ __device__ inline size_t stage_bytes(int steps, int es) {
  return round16(size_t(steps) * BD * es) + round16(size_t(steps) * BD * 4) +
         2 * round16(size_t(steps) * MAX_DS * es);
}

// A row of a transposed sub-block: SUB steps (f32) of one channel's x or
// dt, or of one state's B or C, plus 16 bytes so that rows fall on
// different banks.
constexpr int ROW = SUB + 4;

// Bytes of the transposed sub-block: x and dt by channel, B and C by state.
constexpr size_t SUB_BYTES = size_t(BD + BD + 2 * MAX_DS) * ROW * 4;

// Shared-memory bytes of one launch: the whole ring, the transposed
// sub-block and two sub-blocks of y rows (one being stepped, one being
// written out).
size_t smem_bytes(int chunk, int es) {
  return NSTAGE * stage_bytes(stage_steps(chunk), es) +
         SUB_BYTES + 2 * round16(size_t(SUB) * BD * es);
}

// `rows` rows of `row_bytes` from src (rows src_stride bytes apart) to dst
// (dst_stride apart, a multiple of 16): 16-byte cp.async pieces when src and
// its stride are 16-byte aligned, then element copies (ES bytes) for what is
// left of each row. The element copies land before the call returns.
template <int ES>
__device__ __forceinline__ void stage_copy(unsigned char* dst, int dst_stride,
                                           const unsigned char* src,
                                           size_t src_stride, int rows,
                                           int row_bytes, int tid) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | src_stride) & 15) == 0;
  const int n16 = vec ? row_bytes / 16 : 0;
  for (int i = tid; i < rows * n16; i += NT) {
    const int r = i / n16, k = i - r * n16;
    hopper::cp_async16(dst + size_t(r) * dst_stride + k * 16,
                       src + r * src_stride + k * 16);
  }
  const int done = n16 * 16, tail = (row_bytes - done) / ES;
  for (int i = tid; i < rows * tail; i += NT) {
    const int r = i / tail, k = i - r * tail;
    unsigned char* to = dst + size_t(r) * dst_stride + done + k * ES;
    const unsigned char* from = src + r * src_stride + done + k * ES;
    if (ES == 4)
      *reinterpret_cast<uint32_t*>(to) = *reinterpret_cast<const uint32_t*>(from);
    else
      *reinterpret_cast<uint16_t*>(to) = *reinterpret_cast<const uint16_t*>(from);
  }
}

// Eight consecutive steps' values of one transposed row.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// GROUP (or, at the end of the sequence, n < GROUP) steps of one thread's
// state from its channel's transposed x and dt rows (xr, dr) and its
// state's B and C rows (br, cr), then y for those steps into ys (this
// channel's column of the sub-block's y rows): the same arithmetic, written
// out with intrinsics so that no contraction differs between the full and
// the short group, for every step whatever the chunk.
template <typename T, bool FULL>
__device__ __forceinline__ void group_steps(const float* xr, const float* dr,
                                            const float* br, const float* cr,
                                            float a2, float dv, float& h,
                                            int s, int n, T* ys) {
  float xv[GROUP], dtv[GROUP], bv[GROUP], cv[GROUP], v[GROUP];
  if (FULL) {
    load8(xr, xv);
    load8(dr, dtv);
    load8(br, bv);
    load8(cr, cv);
  }
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    v[j] = 0.f;
    if (FULL || j < n) {
      if (!FULL) {
        xv[j] = xr[j];
        dtv[j] = dr[j];
        bv[j] = br[j];
        cv[j] = cr[j];
      }
      const float dx = __fmul_rn(dtv[j], xv[j]);
      h = __fmaf_rn(ex2(__fmul_rn(dtv[j], a2)), h, __fmul_rn(dx, bv[j]));
      v[j] = __fmul_rn(h, cv[j]);
    }
  }
  // transposed butterfly over the channel's 16 lanes: afterwards lanes 2j
  // and 2j + 1 hold step j's sum over the states, the butterfly xor 8, 4,
  // 2, 1 of its 16 products
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = s & 8;
    const float send = up ? v[i] : v[i + 4];
    const float keep = up ? v[i + 4] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool up = s & 4;
    const float send = up ? v[i] : v[i + 2];
    const float keep = up ? v[i + 2] : v[i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
  {
    const bool up = s & 2;
    const float send = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 2));
  }
  v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], 1));
  const int j = s >> 1;
  if ((s & 1) == 0 && (FULL || j < n))
    store(ys + j * BD, __fmaf_rn(dv, xr[j], v[0]));
}

// Rows [r0, r0 + n) of a landed stage (time-major: x and dt [t][BD], B and
// C [t][MAX_DS], in their dtypes) into the sub-block as f32 rows by channel
// (x at sub, dt at sub + BD rows) and by state (B, then C), 16-byte pieces
// read, elements written: each value is converted once here, not once a
// lane and step.
template <typename T>
__device__ __forceinline__ void transpose_sub(const unsigned char* st,
                                              size_t sx, size_t sdt,
                                              size_t sbc, int r0, int n,
                                              float* sub, int tid) {
  constexpr int ES = sizeof(T), EP = 16 / ES;   // elements a piece
  constexpr int PX = BD / EP, PD = BD / 4, PB = MAX_DS / EP;
  for (int i = tid; i < n * PX; i += NT) {
    const int t = i / PX, q = i % PX;
    const uint4 u =
        *reinterpret_cast<const uint4*>(st + (size_t(r0 + t) * BD + q * EP) * ES);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < EP; ++k) sub[(q * EP + k) * ROW + t] = to_f32(e[k]);
  }
  float* dtt = sub + BD * ROW;
  for (int i = tid; i < n * PD; i += NT) {
    const int t = i / PD, q = i % PD;
    const float4 f = *reinterpret_cast<const float4*>(
        st + sx + (size_t(r0 + t) * BD + q * 4) * 4);
    dtt[(q * 4) * ROW + t] = f.x;
    dtt[(q * 4 + 1) * ROW + t] = f.y;
    dtt[(q * 4 + 2) * ROW + t] = f.z;
    dtt[(q * 4 + 3) * ROW + t] = f.w;
  }
  float* bt = dtt + BD * ROW;
  for (int i = tid; i < 2 * n * PB; i += NT) {
    const bool is_c = i >= n * PB;
    const int j = is_c ? i - n * PB : i, t = j / PB, q = j % PB;
    const uint4 u = *reinterpret_cast<const uint4*>(
        st + sx + sdt + (is_c ? sbc : 0) +
        (size_t(r0 + t) * MAX_DS + q * EP) * ES);
    const T* e = reinterpret_cast<const T*>(&u);
    float* dst = bt + (is_c ? MAX_DS * ROW : 0);
#pragma unroll
    for (int k = 0; k < EP; ++k) dst[(q * EP + k) * ROW + t] = to_f32(e[k]);
  }
}

// The y rows of stage k (staged in ys) to global memory, row by row: each
// row is the block's BD channels, contiguous.
template <typename T>
__device__ __forceinline__ void write_y(T* y, const T* ys, size_t row,
                                        int rows, int di, int c0, int n_ch,
                                        int tid) {
  for (int i = tid; i < rows * BD; i += NT) {
    const int r = i / BD, c = i % BD;
    if (c < n_ch) y[(row + r) * di + c0 + c] = ys[i];
  }
}

// T is the dtype of x, B, C and y (f32 or bf16); dt is f32.
template <typename T>
__global__ void __launch_bounds__(NT, 4) mamba_scan_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ES = sizeof(T);
  const unsigned char* x = static_cast<const unsigned char*>(p.x);
  const unsigned char* dt = reinterpret_cast<const unsigned char*>(p.dt);
  const unsigned char* bm = static_cast<const unsigned char*>(p.b);
  const unsigned char* cm = static_cast<const unsigned char*>(p.c);
  T* y = static_cast<T*>(p.y);
  const int di = p.di, ds = p.ds, length = p.length;
  const int steps = stage_steps(p.chunk);
  const size_t sx = round16(size_t(steps) * BD * ES);
  const size_t sdt = round16(size_t(steps) * BD * 4);
  const size_t sbc = round16(size_t(steps) * MAX_DS * ES);
  const size_t stage = sx + sdt + 2 * sbc;
  float* sub = reinterpret_cast<float*>(smem + NSTAGE * stage);
  T* ys_ring = reinterpret_cast<T*>(smem + NSTAGE * stage + SUB_BYTES);

  const int tid = threadIdx.x;
  const int cl = tid / LANES;                 // channel within the block
  const int s = tid % LANES;                  // its state
  const int c0 = blockIdx.x * BD;
  const int ch = c0 + cl;
  const int n_ch = min(BD, di - c0);          // live channels of the block
  const bool live = cl < n_ch;
  const bool on = live && s < ds;
  const size_t row0 = size_t(blockIdx.y) * length;  // (b, t = 0)
  const size_t hs = (size_t(blockIdx.y) * di + ch) * ds + s;

  // zeros where no copy writes (channels past Di, states past Ds), so
  // those lanes step zeros
  if (n_ch < BD || ds < MAX_DS) {
    for (size_t i = tid * 16; i < NSTAGE * stage; i += NT * 16)
      *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  const int n_stages = (length + steps - 1) / steps;
  // full blocks of Ds = MAX_DS with 16-byte aligned rows (falcon's shapes)
  // copy 16-byte pieces whose places follow from constant divisors; the
  // rest take stage_copy, with element copies for the unaligned parts
  const bool fast =
      n_ch == BD && ds == MAX_DS && (size_t(di) * ES) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
        reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm)) &
       15) == 0;
  auto issue = [&](int k) {
    unsigned char* st = smem + (k % NSTAGE) * stage;
    const size_t t0 = row0 + size_t(k) * steps;
    const int rows = min(steps, length - k * steps);
    if (fast) {
      constexpr int PX = BD * ES / 16, PD = BD * 4 / 16;  // pieces a row
      const unsigned char* xr = x + (t0 * di + c0) * ES;
      const unsigned char* dr = dt + (t0 * di + c0) * 4;
      for (int i = tid; i < rows * PX; i += NT)
        hopper::cp_async16(st + i * 16,
                           xr + size_t(i / PX) * di * ES + (i % PX) * 16);
      for (int i = tid; i < rows * PD; i += NT)
        hopper::cp_async16(st + sx + i * 16,
                           dr + size_t(i / PD) * di * 4 + (i % PD) * 16);
      // B_t and C_t rows are contiguous: one block each
      const int pb = rows * MAX_DS * ES / 16;
      for (int i = tid; i < 2 * pb; i += NT) {
        const bool is_c = i >= pb;
        const int j = is_c ? i - pb : i;
        hopper::cp_async16(st + sx + sdt + (is_c ? sbc : 0) + j * 16,
                           (is_c ? cm : bm) + t0 * MAX_DS * ES + j * 16);
      }
      return;
    }
    stage_copy<ES>(st, BD * ES, x + (t0 * di + c0) * ES, size_t(di) * ES,
                   rows, n_ch * ES, tid);
    stage_copy<4>(st + sx, BD * 4, dt + (t0 * di + c0) * 4, size_t(di) * 4,
                  rows, n_ch * 4, tid);
    stage_copy<ES>(st + sx + sdt, MAX_DS * ES, bm + t0 * ds * ES,
                   size_t(ds) * ES, rows, ds * ES, tid);
    stage_copy<ES>(st + sx + sdt + sbc, MAX_DS * ES, cm + t0 * ds * ES,
                   size_t(ds) * ES, rows, ds * ES, tid);
  };
  issue(0);
  hopper::cp_async_commit();

  // the per-thread constants load while the first stage is in flight
  const float a2 = on ? p.a[size_t(ch) * ds + s] * LOG2E : 0.f;
  float h = (on && p.h0 != nullptr) ? p.h0[hs] : 0.f;
  const float dv = live ? p.d[ch] : 0.f;

  // a landed stage is transposed SUB steps at a time into the sub-block
  // that the threads then step (reading eight steps of a row in two
  // loads), after the previous sub-block's y rows go out
  int n_sub = 0;                 // sub-blocks stepped so far
  size_t prev_row = 0;           // global row and length of the last one
  int prev_n = 0;
  for (int k = 0; k < n_stages; ++k) {
    hopper::cp_async_wait_all();  // stage k has landed
    __syncthreads();  // stage k visible; every thread done with stage k - 1
    if (k + 1 < n_stages) {       // into stage k - 1's slot, in flight
      issue(k + 1);               // while stage k is stepped
      hopper::cp_async_commit();
    }
    const unsigned char* st = smem + (k % NSTAGE) * stage;
    const int rows = min(steps, length - k * steps);
    for (int r0 = 0; r0 < rows; r0 += SUB, ++n_sub) {
      const int n = min(SUB, rows - r0);
      if (r0 > 0) __syncthreads();  // every thread is done stepping it
      transpose_sub<T>(st, sx, sdt, sbc, r0, n, sub, tid);
      __syncthreads();  // the sub-block is in; the previous one is stepped
      if (n_sub > 0)    // so its y rows are complete
        write_y(y, ys_ring + ((n_sub - 1) % 2) * SUB * BD, prev_row, prev_n,
                di, c0, n_ch, tid);
      const float* xr = sub + cl * ROW;
      const float* dr = sub + (BD + cl) * ROW;
      const float* br = sub + (2 * BD + s) * ROW;
      const float* cr = sub + (2 * BD + MAX_DS + s) * ROW;
      T* ys = ys_ring + (n_sub % 2) * SUB * BD + cl;
      int j0 = 0;
#pragma unroll 4
      for (; j0 + GROUP <= n; j0 += GROUP)
        group_steps<T, true>(xr + j0, dr + j0, br + j0, cr + j0, a2, dv, h,
                             s, GROUP, ys + j0 * BD);
      if (j0 < n)
        group_steps<T, false>(xr + j0, dr + j0, br + j0, cr + j0, a2, dv, h,
                              s, n - j0, ys + j0 * BD);
      prev_row = row0 + size_t(k) * steps + r0;
      prev_n = n;
    }
  }
  __syncthreads();
  write_y(y, ys_ring + ((n_sub - 1) % 2) * SUB * BD, prev_row, prev_n, di, c0,
          n_ch, tid);

  if (p.ht != nullptr && on) p.ht[hs] = h;
}

// One time step (a decode step, L = 1): the same thread layout and the same
// arithmetic as mamba_scan_kernel (the butterfly xor 8, 4, 2, 1 over the
// channel's 16 products is the transposed one's sum), so its y and state
// equal the general kernel's bit for bit, without the staging ring: each
// thread reads its inputs straight from global memory. It holds few
// registers, so twice as many CTAs fit an SM and B = 4, Di = 8192 runs in
// two waves instead of four.
template <typename T>
__global__ void __launch_bounds__(NT, 8) mamba_scan_step_kernel(Args p) {
  const T* x = static_cast<const T*>(p.x);
  const T* bm = static_cast<const T*>(p.b);
  const T* cm = static_cast<const T*>(p.c);
  const int di = p.di, ds = p.ds;
  const int tid = threadIdx.x, cl = tid / LANES, s = tid % LANES;
  const int ch = blockIdx.x * BD + cl;
  const bool live = ch < di, on = live && s < ds;
  const size_t row = blockIdx.y;
  const size_t hs = (row * di + ch) * ds + s;
  const float xt = live ? to_f32(x[row * di + ch]) : 0.f;
  const float dtt = live ? p.dt[row * di + ch] : 0.f;
  const float bt = on ? to_f32(bm[row * ds + s]) : 0.f;
  const float ct = on ? to_f32(cm[row * ds + s]) : 0.f;
  const float a2 = on ? p.a[size_t(ch) * ds + s] * LOG2E : 0.f;
  float h = (on && p.h0 != nullptr) ? p.h0[hs] : 0.f;
  const float dv = live ? p.d[ch] : 0.f;
  const float dx = __fmul_rn(dtt, xt);
  h = __fmaf_rn(ex2(__fmul_rn(dtt, a2)), h, __fmul_rn(dx, bt));
  float v = __fmul_rn(h, ct);
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  if (live && s == 0)
    store(static_cast<T*>(p.y) + row * di + ch, __fmaf_rn(dv, xt, v));
  if (p.ht != nullptr && on) p.ht[hs] = h;
}

template <typename T>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream) {
  if (p.length == 1) {
    mamba_scan_step_kernel<T>
        <<<dim3((p.di + BD - 1) / BD, batch), NT, 0, stream>>>(p);
    return cudaGetLastError();
  }
  auto kernel = mamba_scan_kernel<T>;
  const size_t smem = smem_bytes(p.chunk, sizeof(T));
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
      smem_bytes(chunk, bf16 ? 2 : 4) > size_t(MAX_SMEM))
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
