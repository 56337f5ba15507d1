// Grouped expert GEMM for Hopper: bf16 operands, f32 sums, f32 out, on
// wgmma fed by TMA.
//
// Replaces: jax.lax.ragged_dot(..., preferred_element_type=jnp.float32) in
// src/repro/models/moe.py:_moe_ep_inner (the reference leaves it to XLA;
// there is no Pallas kernel). Same function: out[i] = xs[i] @ w[g] for every
// row i of expert g, the rows [offs[g-1], offs[g]) of the hits sorted by
// expert (offs[-1] = 0), with every product exact in f32 and the sums kept
// in f32; the result is written in f32, never rounded to bf16.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the hit experts' weights.
// qwen3-moe (K 2048, N 768 gate; 128 experts top-8): a 1024-token admission
// hits every expert, 403 MB of weights (0.120 ms) against 25.8 GFLOP
// (0.026 ms); a 4-token decode step hits ~30 experts, 94 MB (0.028 ms) for
// 0.1 GFLOP. deepseek-v2 (K 5120, N 1536; 160 experts top-6): an admission
// reads 2.5 GB (0.75 ms) against 97 GFLOP (0.098 ms). jamba-1.5-large (K
// 8192, N 24576; 16 experts top-2): 6.4 GB an admission (1.9 ms). Every
// case is bound by bytes, so the design keeps the weights streaming.
//
// Design. The first version (mma.sync, 64 x 128 tiles, a 3-stage cp.async
// ring of 32-deep K slices, one CTA per (64-row slot, column tile)) lost to
// torch's grouped GEMM on three counts, and this one answers each:
//   1. Copy issue and bytes in flight. Here one producer warp issues TMA
//      loads (cp.async.bulk.tensor; no thread copies a byte) into a ring of
//      6 to 12 stages of 64-deep K slices (192 KB a CTA, 96 to 128 KB of
//      weights in flight an SM), each stage an mbarrier pair; consumer
//      warpgroups run wgmma.mma_async m64nNk16 on the stages that landed
//      (A K-major, B MN-major: w's (K, N) slices read as they lie). The
//      weights go through a rank-3 tensor map over w (E, K, N), so a K tile
//      at an expert's edge fills zeros and never reads the next expert; xs
//      through a 2-D map at the tile's first row, in one box of the tile's
//      rows (m rounded up to 8 at a decode step; rows past the expert's
//      end are loaded, never stored; past m, zeros). Both are 128-byte
//      swizzled. Loading only the 64-row boxes that hold a valid row (the
//      idle warpgroup skipping its products) and tagging the weights to
//      leave L2 first were tried on the card and dropped: in one call, in
//      turns, neither made an admission faster.
//   2. Weights read again at an admission. The tile height follows the
//      rows an expert averages (the wrapper's launch_config, from shapes
//      alone): 128 rows (two consumer warpgroups) where m >= 48 E, so an
//      expert of qwen3-moe's 64 average rows (and jamba's 128) streams each
//      weight slice once; 64 rows below that (deepseek-v2's 38 average),
//      where 128-row tiles read 0.6-2 % slower on an H100; 128 columns a
//      tile.
//   3. Too many bytes on too few CTAs at a decode step, and CTAs that exit
//      at once. The grid is persistent: min(SMs, the work items the shapes
//      allow) CTAs walk the work items in a fixed stride, and only items
//      that hold rows exist. Every CTA scans the offsets once: expert g
//      owns tiles [first[g], first[g+1]), ceil(rows / BM) of them (none
//      when empty), so item t * n_tiles + j is column tile j of the
//      expert's tile t - first[g] (a binary search over first). At m <= 64
//      (the decode regime) the tiles are 64 x 64 and the rows' TMA box
//      shrinks to m rounded up to 8, so each hit expert's K x N slice is
//      cut into N / 64 items spread evenly over the SMs, with nothing read
//      or computed for experts without a hit. The ring runs on across
//      items, so one item's epilogue overlaps the next item's loads.
// No count is read to the host and no float atomic is used: every output
// element is summed by one thread over K in a fixed order, so a call's
// bits repeat, and within one regime (one tile shape) a row's result does
// not depend on the other rows of the call.
//
// Layout: xs (m, K) bf16 row-major; w (E, K, N) bf16 row-major (N
// contiguous: the serving copy of the reference's (E, d_in, d_out)
// weights); offs (E,) int32, non-decreasing, offs[E-1] <= m; out (m, N)
// f32 row-major. Rows at or past offs[E-1] are not written. K and N are
// multiples of 8 (16-byte rows for TMA); xs and w 16-byte aligned.

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int WG = 128;                 // threads per warpgroup
constexpr int BK = 64;                  // K per stage: one 128-byte chunk
constexpr int CW = 64;                  // bf16 columns of a 128-byte chunk
constexpr int RING_BYTES = 192 * 1024;  // shared memory of the stages
constexpr int MAX_EXPERTS = 1024;
constexpr int MAX_SMEM = 232448;        // H100: dynamic shared memory / block

// One tile shape: NWG consumer warpgroups of 64 rows each, BN columns.
template <int NWG, int BN>
struct Tile {
  static constexpr int BM = 64 * NWG;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int CONSUMERS = NWG * WG;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static_assert(STAGES >= 4, "a ring of at least 4 stages");
};

// Shared memory of one launch: the ring, its full and empty mbarriers, then
// the clamped offsets and each expert's first tile (E + 1 ints).
template <int NWG, int BN>
constexpr size_t smem_bytes(int n_experts) {
  return size_t(Tile<NWG, BN>::STAGES) * Tile<NWG, BN>::STAGE +
         2 * 8 * Tile<NWG, BN>::STAGES +
         sizeof(int) * (2 * size_t(n_experts) + 1);
}
static_assert(smem_bytes<1, 64>(MAX_EXPERTS) <= MAX_SMEM &&
                  smem_bytes<1, 128>(MAX_EXPERTS) <= MAX_SMEM &&
                  smem_bytes<2, 128>(MAX_EXPERTS) <= MAX_SMEM,
              "the ring and the tables fit one block's shared memory");

template <int NWG, int BN>
__global__ void __launch_bounds__(Tile<NWG, BN>::THREADS, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const int* __restrict__ offs, float* __restrict__ out,
                    int m, int k, int n, int n_experts, int a_rows) {
  using T = Tile<NWG, BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  int* ends = reinterpret_cast<int*>(empty + T::STAGES);
  int* first = ends + n_experts;  // first[E]: the call's tile count
  const int tid = threadIdx.x, lane = tid % 32;
  if (tid == 0) {
    if (hopper::smem_addr(smem) & 1023) __trap();  // swizzle needs 1024 B
    for (int s = 0; s < T::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], T::CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  for (int i = tid; i < n_experts; i += T::THREADS)
    ends[i] = min(max(offs[i], 0), m);
  __syncthreads();
  if (tid < 32) {  // warp 0: first[g] = sum of the tiles of experts < g
    auto tiles = [&](int g) {
      const int start = g ? ends[g - 1] : 0;
      return (max(ends[g] - start, 0) + T::BM - 1) / T::BM;
    };
    const int per = (n_experts + 31) / 32;
    const int lo = min(lane * per, n_experts);
    const int hi = min(lo + per, n_experts);
    int sum = 0;
    for (int g = lo; g < hi; ++g) sum += tiles(g);
    int incl = sum;  // inclusive scan over the lanes
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - sum;
    for (int g = lo; g < hi; ++g) {
      first[g] = run;
      run += tiles(g);
    }
    if (lane == 31) first[n_experts] = incl;
  }
  __syncthreads();

  const int n_tiles = (n + BN - 1) / BN;
  const int items = first[n_experts] * n_tiles;
  const int nk = (k + BK - 1) / BK;
  // Work item -> expert g, its first row, valid rows and first column.
  auto locate = [&](int item, int& g, int& row0, int& rows, int& col0) {
    const int t = item / n_tiles;
    col0 = (item - t * n_tiles) * BN;
    int lo = 0, hi = n_experts - 1;  // the last g with first[g] <= t
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (first[mid] <= t) lo = mid;
      else hi = mid - 1;
    }
    g = lo;
    row0 = (g ? ends[g - 1] : 0) + (t - first[g]) * T::BM;
    rows = min(T::BM, ends[g] - row0);
  };

  if (tid >= T::CONSUMERS) {  // the producer warp: one lane issues loads
    if (tid == T::CONSUMERS) {
      int it = 0;  // stages filled so far, across items
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int g, row0, rows, col0;
        locate(item, g, row0, rows, col0);
        // weight chunks with a column below N (the rest stay stale: their
        // output columns are never stored)
        const int chunks = min(BN / CW, (n - col0 + CW - 1) / CW);
        const uint32_t bytes = a_rows * BK * 2 + chunks * BK * CW * 2;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % T::STAGES;
          if (it >= T::STAGES)
            hopper::mbar_wait(&empty[s], ((it / T::STAGES) - 1) & 1);
          unsigned char* a_s = smem + size_t(s) * T::STAGE;
          unsigned char* b_s = a_s + T::A_BYTES;
          hopper::mbar_expect_tx(&full[s], bytes);
          hopper::tma_load_2d(a_s, &map_x, &full[s], kt * BK, row0);
          for (int c = 0; c < chunks; ++c)
            hopper::tma_load_3d(b_s + c * BK * CW * 2, &map_w, &full[s],
                                col0 + c * CW, kt * BK, g);
        }
      }
    }
    return;
  }

  // Consumers. wgmma's accumulator layout: register 4 j + 2 h + e of a
  // thread holds row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  // of its warpgroup's 64 x BN block; warpgroup wg owns rows 64 wg .. + 63.
  const int wg = tid / WG, warp = (tid % WG) / 32;
  const int row_in = 64 * wg + 16 * warp + lane / 4, col_in = 2 * (lane % 4);
  constexpr int NR = BN / 2;
  float acc[NR];
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int g, row0, rows, col0;
    locate(item, g, row0, rows, col0);
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % T::STAGES;
      hopper::mbar_wait(&full[s], (it / T::STAGES) & 1);
      const unsigned char* a_s = smem + size_t(s) * T::STAGE;
      const unsigned char* b_s = a_s + T::A_BYTES;
      hopper::reg_fence<NR>(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::Wgmma<BN>::template ss<1>(
            acc, hopper::desc(a_s + wg * 64 * BK * 2 + kk * 32, CW, 16),
            hopper::desc(b_s + kk * 16 * CW * 2, CW, BK * CW * 2), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::reg_fence<NR>(acc);
      hopper::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row_in + 8 * h, c = col0 + 8 * j + col_in;
        if (r < rows && c < n)
          *reinterpret_cast<float2*>(out + size_t(row0 + r) * n + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
}

// ---------------------------------------------------- tensor-map cache

// A tensor map is a pure function of (base, dims, box) for the contiguous
// tensors here (the strides follow from the dims), so maps are kept by that
// key and a call re-encodes only what it has not met: the weights' map
// once per expert tensor, the rows' once per allocation of xs.
struct MapEntry {
  const void* base;
  int rank;
  cuuint64_t dims[3];
  cuuint32_t box[3];
  CUtensorMap map;
};
constexpr int MAP_CACHE = 64;
std::mutex map_mutex;
MapEntry map_cache[MAP_CACHE];
int map_count = 0, map_next = 0;

cudaError_t cached_map(CUtensorMap* map, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint32_t* box) {
  std::lock_guard<std::mutex> lock(map_mutex);
  for (int i = 0; i < map_count; ++i) {
    const MapEntry& e = map_cache[i];
    bool same = e.base == base && e.rank == rank;
    for (int d = 0; same && d < rank; ++d)
      same = e.dims[d] == dims[d] && e.box[d] == box[d];
    if (same) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  const cudaError_t err =
      hopper::make_map(map, base, rank, dims, strides, box, CW);
  if (err != cudaSuccess) return err;
  MapEntry& e = map_cache[map_next];
  e.base = base;
  e.rank = rank;
  for (int d = 0; d < rank; ++d) {
    e.dims[d] = dims[d];
    e.box[d] = box[d];
  }
  e.map = *map;
  map_next = (map_next + 1) % MAP_CACHE;
  map_count = map_count < MAP_CACHE ? map_count + 1 : MAP_CACHE;
  return cudaSuccess;
}

template <int NWG, int BN>
cudaError_t launch(const CUtensorMap& map_x, const CUtensorMap& map_w,
                   const int* offs, float* out, int m, int k, int n,
                   int n_experts, int a_rows, int grid, cudaStream_t stream) {
  auto kernel = grouped_gemm_kernel<NWG, BN>;
  // the attribute once per device, at the most any launch claims
  static std::once_flag flags[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  std::call_once(flags[dev], [&] {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_bytes<NWG, BN>(MAX_EXPERTS)));
  });
  if (err != cudaSuccess) return err;
  kernel<<<grid, Tile<NWG, BN>::THREADS, smem_bytes<NWG, BN>(n_experts),
           stream>>>(map_x, map_w, offs, out, m, k, n, n_experts, a_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int grouped_gemm_max_experts() { return MAX_EXPERTS; }

const char* grouped_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches on `stream` the tile shape `config` names (0: 64 x 64, the
// decode regime; 1: 64 x 128; 2: 128 x 128), reading rows in TMA boxes of
// `a_rows` (a multiple of 8, at least min(m, the tile's rows), at most
// them) over a persistent grid of `grid` CTAs; the wrapper chooses all
// three from the shapes (kernels/grouped_gemm.py:launch_config). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue (launching
// nothing) for arguments out of the kernel's limits.
int grouped_gemm_bf16_f32(const void* xs, const void* w, const void* offs,
                          void* out, int m, int k, int n, int n_experts,
                          int config, int a_rows, int grid, void* stream) {
  const int bm = config == 2 ? 128 : 64;
  if (m < 0 || k < 8 || n < 8 || k % 8 || n % 8 || n_experts < 1 ||
      n_experts > MAX_EXPERTS || config < 0 || config > 2 || a_rows % 8 ||
      a_rows < 8 || a_rows > bm || a_rows < (m < bm ? m : bm) || grid < 1 ||
      reinterpret_cast<uintptr_t>(xs) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  const cuuint64_t x_dims[2] = {cuuint64_t(k), cuuint64_t(m)};
  const cuuint32_t x_box[2] = {BK, cuuint32_t(a_rows)};
  const cuuint64_t w_dims[3] = {cuuint64_t(n), cuuint64_t(k),
                                cuuint64_t(n_experts)};
  const cuuint32_t w_box[3] = {CW, BK, 1};
  CUtensorMap map_x, map_w;
  cudaError_t err = cached_map(&map_x, xs, 2, x_dims, x_box);
  if (err == cudaSuccess) err = cached_map(&map_w, w, 3, w_dims, w_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* o = static_cast<const int*>(offs);
  float* c = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (config) {
    case 0:
      err = launch<1, 64>(map_x, map_w, o, c, m, k, n, n_experts, a_rows,
                          grid, s);
      break;
    case 1:
      err = launch<1, 128>(map_x, map_w, o, c, m, k, n, n_experts, a_rows,
                           grid, s);
      break;
    default:
      err = launch<2, 128>(map_x, map_w, o, c, m, k, n, n_experts, a_rows,
                           grid, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
