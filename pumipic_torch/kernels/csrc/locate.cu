// Kernel L: locate = cell-row peel + guess-walk BCC search with
// remove-on-exit + the DPS rewrite, one thread per particle with the walk
// loop inside the kernel; and the plain walk (no peel), redesigned for the
// sparse walks the step runs.
//
// Replaces (JAX reference): LocatorGrid2D.cell_of
// (pumipic_tpu/mesh/locator.py:85-101), the "rows" peel of
// search_mesh_2d_accel (pumipic_tpu/ops/search.py:1199-1253), the walk step
// _make_step/_row_core_2d (:595-707, :206-244) with remove_on_exit
// (:110-121), the pyramid loop _run_walk (:710-950) and the DPS rewrite
// (pumipic_tpu/models/pseudo_xgcm.py:658-667).  With cells != nullptr
// ("given cells" mode) the peel reads each particle's cell id from that
// array instead of computing the cartesian one: the flux-band grid's ids,
// which kernel B computes (BandGrid2D.cell_of,
// pumipic_tpu/mesh/locator.py:747-755); the band table is the same (K·T, 14)
// row layout, 27.5 MB on the 120k mesh.  Its dense walk and, on
// walk_plain.cuh's sparse schedule, its sparse walk are the plain walk
// search_mesh_2d (:967-1000): the setup's gyro ring points and the
// locator-less step (dense), the parent repair of check_initial_parents
// (:1527-1595, in place behind kernel J) and the picparts step's
// lost-particle check (sparse).
// The TPU Pallas probes of the walk step (perf/archive/walk_opt.py:219,
// walk_opt2.py:92, walk_opt4.py:101) compute the same step.
//
// What bounds the peel form on an H100: device-memory traffic of the random
// row loads.  Per particle: 13 bytes streamed in (dest x, y, previous elem,
// active), one 56-byte cell row at a data-dependent address (the 27.5 MB
// table of the 120k mesh fits the 50 MB L2), 5 bytes out; walkers the peel
// misses (a few percent) add one 48-byte walk_geom row per step.
//
// Design of the peel form: the TPU ran the walk as full-width vectorized
// steps with a compaction pyramid (sorts, packed extraction, merge
// scatters) to shed finished walkers.  On Hopper a thread simply keeps
// walking: finished threads idle inside their warp, and there is no
// compaction at all.  The reference's iteration budget is kept exactly: the
// peel counts as iteration it0 = 1, and each walker takes at most
// max_iters - it0 steps; walkers unfinished at the limit are deleted.
// iters = it0 + the most steps any walker took, reduced per block and then
// with one atomicMax per block; all_found counts unfinished walkers with
// one atomicAdd per block.
//
// The plain walk has two kernels.  Where every slot is written (the
// setup's ring points, search_mesh_2d, the locator-less step), the dense
// walk (walk_dense_kernel; the first version's plain walk was the peel
// kernel with no cell rows).  Where few slots walk and the caller wants no
// output for the rest (the parent repair over kernel J's bad parents, in
// place into J's output; the picparts step's lost check, its counts
// alone), the sparse schedule of walk_plain.cuh with this file's step
// (PlainStep2D).  What held the first version there was the sweep, not the
// walk: every slot read its destination and wrote 5 bytes, the wrapper
// copied the destination's columns first, and a warp waited for its
// longest walk.  The budget, the deletion at the limit, iters and
// all_found are the first version's in both.  Measured (PERF.md §6): on the dense
// inputs the sparse schedule loses to lockstep tiles (the ring points
// 0.097 against 0.086 ms, the locator-less step's walk at 10M 0.150-0.166
// against 0.104-0.107): 32 neighbouring slots walk the same rows in step,
// and a refilled warp's lanes read 32 different rows a step.
// Built with -fmad=false so the containment tests round exactly as the
// plain PyTorch version's separate ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "walk_plain.cuh"

#define BCC_REL_TOL 4.76837158203125e-07f  // 8 * 2^-24
#define BCC_ABS_TOL 1e-7f
#define WALK_THREADS 256
// the dense plain walk's block size (512 beat 256 and 1024 at the
// locator-less step, PERF.md §6)
#define WD_THREADS 512

struct Bary {
  float l1, l2, w0;
  bool inside;
};

// barycentric weights of (dx, dy) in the affine row a[0..5] and the
// tolerance-relative containment test (search.py _row_core_2d)
__device__ __forceinline__ Bary bary(float a0, float a1, float a2, float a3,
                                     float a4, float a5, float dx, float dy) {
  Bary r;
  r.l1 = a0 * dx + a1 * dy + a2;
  r.l2 = a3 * dx + a4 * dy + a5;
  r.w0 = 1.0f - r.l1 - r.l2;
  const float m1 = fabsf(a0 * dx) + fabsf(a1 * dy) + fabsf(a2);
  const float m2 = fabsf(a3 * dx) + fabsf(a4 * dy) + fabsf(a5);
  const float t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL;
  const float t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL;
  r.inside = (r.w0 >= -(t1 + t2)) && (r.l1 >= -t1) && (r.l2 >= -t2);
  return r;
}

__global__ void __launch_bounds__(WALK_THREADS) walk_locate_kernel(
    const float* __restrict__ dest_x, const float* __restrict__ dest_y,
    const int* __restrict__ elem_start, const uint8_t* __restrict__ active,
    const float* __restrict__ geom, int n_elems,
    const float* __restrict__ rows, const int* __restrict__ cells, float ox,
    float oy, float ihx, float ihy, int nx, int ny, int max_iters, int it0,
    int* __restrict__ elem_out, uint8_t* __restrict__ active_out,
    int* __restrict__ stats, long long n) {
  int my_max = 0;
  int my_unfinished = 0;
  const int budget = max(max_iters - it0, 0);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float dx = dest_x[i], dy = dest_y[i];
    int elem = -1;
    int fbg = -2;  // >= 0: on a guess trajectory, value = element to retry from
    bool done = true;
    if (active[i]) {
      const int start = min(max(elem_start[i], 0), n_elems - 1);
      int c;
      if (cells != nullptr) {
        c = cells[i];            // given cells (kernel B's band ids)
      } else {
        // cell id in f32 index arithmetic (LocatorGrid2D.cell_of)
        const float rx = (dx - ox) * ihx;
        const float ry = (dy - oy) * ihy;
        const float fx = fminf(fmaxf(floorf(rx), 0.0f), (float)(nx - 1));
        const float fy = fminf(fmaxf(floorf(ry), 0.0f), (float)(ny - 1));
        c = min(max((int)(fx * (float)ny + fy), 0), nx * ny - 1);
      }
      // 56-byte row, 8-byte aligned: seven float2 loads
      const float2* r2 = reinterpret_cast<const float2*>(rows + (size_t)c * 14);
      float r[14];
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const float2 v = __ldg(r2 + j);
        r[2 * j] = v.x;
        r[2 * j + 1] = v.y;
      }
      const bool in_a = bary(r[0], r[1], r[2], r[3], r[4], r[5], dx, dy).inside;
      const bool in_b = bary(r[7], r[8], r[9], r[10], r[11], r[12], dx, dy).inside;
      if (in_a || in_b) {
        elem = in_a ? (int)r[6] : (int)r[13];
      } else {
        elem = (int)r[6];
        fbg = start;
        done = false;
      }
    }
    int steps = 0;
    while (!done && steps < budget) {
      ++steps;
      // 48-byte walk_geom row, 16-byte aligned: three float4 loads
      const float4* g4 = reinterpret_cast<const float4*>(geom + (size_t)elem * 12);
      const float4 ga = __ldg(g4), gb = __ldg(g4 + 1), gc = __ldg(g4 + 2);
      const Bary w = bary(ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, dx, dy);
      if (w.inside) {
        done = true;
        break;
      }
      // most negative weight -> exit across the pre-permuted column 6+k
      int kmin = (w.w0 <= w.l1) ? 0 : 1;
      const float wmin = (isnan(w.w0) || isnan(w.l1)) ? NAN : fminf(w.w0, w.l1);
      if (w.l2 < wmin) kmin = 2;
      const float nf = kmin == 0 ? gb.z : (kmin == 1 ? gb.w : gc.x);
      const int next = (int)nf;
      if (next == -1) {          // exposed side
        if (fbg >= 0) {          // guess trajectory: retry from the true start
          elem = fbg;
          fbg = -2;
        } else {                 // real boundary exit: remove
          elem = -1;
          done = true;
        }
      } else {
        elem = next;
      }
    }
    if (!done) {                 // loop limit: delete the walker
      elem = -1;
      ++my_unfinished;
    }
    elem_out[i] = elem;
    active_out[i] = elem >= 0 ? 1 : 0;
    my_max = max(my_max, steps);
  }
  // block reduction, then one atomic per block
  my_max = __reduce_max_sync(0xffffffffu, my_max);
  my_unfinished = __reduce_add_sync(0xffffffffu, my_unfinished);
  __shared__ int s_max[WALK_THREADS / 32];
  __shared__ int s_unf[WALK_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_max[warp] = my_max;
    s_unf[warp] = my_unfinished;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bm = 0, bu = 0;
    for (int w = 0; w < WALK_THREADS / 32; ++w) {
      bm = max(bm, s_max[w]);
      bu += s_unf[w];
    }
    if (bm > 0) atomicMax(&stats[0], bm);
    if (bu > 0) atomicAdd(&stats[1], bu);
  }
}

// The dense plain walk: every slot written, each active slot a walker
// from its clamped start (the setup's ring points, search_mesh_2d, the
// locator-less step).  A warp walks tiles of 32 consecutive slots, a lane
// a slot, in lockstep (neighbouring slots walk the same rows at first); a
// resident grid of WD_THREADS-thread blocks strides over the tiles.  The
// slots' destination, start and mask are read, and their outputs written,
// with streaming cache hints (each is touched once), so they do not evict
// the rows from L1; a step reads its row's first 32 bytes (the affine
// part and the first two exits) and the third exit only where the walker
// leaves across it.  Measured against the first version (PERF.md §6):
// two or four walkers a lane with their loads in flight together, loading
// the next tile during the walk, the containment's tolerances computed
// only where a weight is negative, a block walking a contiguous range of
// tiles, and walk_plain.cuh's refilling pool each lost at both inputs.
__global__ void __launch_bounds__(WD_THREADS) walk_dense_kernel(
    const float* __restrict__ dest_x, const float* __restrict__ dest_y,
    const int* __restrict__ elem_start, const uint8_t* __restrict__ active,
    const float* __restrict__ geom, int n_elems, int budget,
    int* __restrict__ elem_out, uint8_t* __restrict__ active_out,
    int* __restrict__ stats, long long n) {
  const int lane = threadIdx.x & 31;
  const long long n_tiles = (n + 31) / 32;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  int my_max = 0, my_unfinished = 0;
  for (long long t = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; t < n_tiles;
       t += n_warps) {
    const long long i = t * 32 + lane;
    float x = 0.0f, y = 0.0f;
    int elem = -1;
    bool done = true;
    if (i < n) {
      x = __ldcs(dest_x + i);
      y = __ldcs(dest_y + i);
      const int start = __ldcs(elem_start + i);
      if (__ldcs(reinterpret_cast<const signed char*>(active) + i) != 0) {
        elem = min(max(start, 0), n_elems - 1);
        done = false;
      }
    }
    int steps = 0;
    while (!done && steps < budget) {
      ++steps;
      const float* row = geom + (size_t)elem * 12;
      const float4 ga = __ldg(reinterpret_cast<const float4*>(row));
      const float4 gb = __ldg(reinterpret_cast<const float4*>(row) + 1);
      const Bary w = bary(ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, x, y);
      if (w.inside) {
        done = true;
        break;
      }
      // most negative weight -> exit across the pre-permuted column 6+k
      int kmin = (w.w0 <= w.l1) ? 0 : 1;
      const float wmin = (isnan(w.w0) || isnan(w.l1)) ? NAN : fminf(w.w0, w.l1);
      if (w.l2 < wmin) kmin = 2;
      elem = (int)(kmin == 0 ? gb.z : (kmin == 1 ? gb.w : __ldg(row + 8)));
      if (elem == -1) done = true;     // an exposed side: removed
    }
    if (i < n) {
      if (!done) {                     // loop limit: delete the walker
        elem = -1;
        ++my_unfinished;
      }
      __stcs(elem_out + i, elem);
      __stcs(reinterpret_cast<signed char*>(active_out) + i, (signed char)(elem >= 0));
      my_max = max(my_max, steps);
    }
  }
  // block reduction, then one atomic per block
  my_max = __reduce_max_sync(0xffffffffu, my_max);
  my_unfinished = __reduce_add_sync(0xffffffffu, my_unfinished);
  __shared__ int s_max[WD_THREADS / 32];
  __shared__ int s_unf[WD_THREADS / 32];
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_max[warp] = my_max;
    s_unf[warp] = my_unfinished;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bm = 0, bu = 0;
    for (int w = 0; w < WD_THREADS / 32; ++w) {
      bm = max(bm, s_max[w]);
      bu += s_unf[w];
    }
    if (bm > 0) atomicMax(&stats[0], bm);
    if (bu > 0) atomicAdd(&stats[1], bu);
  }
}

// one step of the plain walk from w_elem toward (x, y): true when the
// walker stops (inside: w_elem kept; an exposed side: w_elem = -1)
__device__ __forceinline__ bool plain_step(const float* __restrict__ geom, int& w_elem,
                                           float x, float y) {
  const float4* g4 = reinterpret_cast<const float4*>(geom + (size_t)w_elem * 12);
  const float4 ga = __ldg(g4), gb = __ldg(g4 + 1), gc = __ldg(g4 + 2);
  const Bary w = bary(ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, x, y);
  if (w.inside) return true;
  int kmin = (w.w0 <= w.l1) ? 0 : 1;
  const float wmin = (isnan(w.w0) || isnan(w.l1)) ? NAN : fminf(w.w0, w.l1);
  if (w.l2 < wmin) kmin = 2;
  const float nf = kmin == 0 ? gb.z : (kmin == 1 ? gb.w : gc.x);
  w_elem = (int)nf;
  return w_elem == -1;
}

// the 2D step of walk_plain.cuh's schedule
struct PlainStep2D {
  static __device__ __forceinline__ bool run(const float* __restrict__ geom, int& elem,
                                             const float* x) {
    return plain_step(geom, elem, x[0], x[1]);
  }
};

static int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// The peel + walk.  stats[0] <- max steps over walkers (atomicMax),
// stats[1] <- unfinished walkers (atomicAdd); the caller zeroes both
// before the launch.  rows: the grid's cell rows (required; the plain walk
// is pp_walk_dense).  cells: per-particle cell ids in [0, rows' row
// count), or nullptr for the cartesian cell of (ox, oy, ihx, ihy, nx, ny).
extern "C" int pp_walk_locate(
    const float* dest_x, const float* dest_y, const int* elem_start,
    const uint8_t* active, const float* geom, int n_elems,
    const float* rows, const int* cells, float ox, float oy, float ihx,
    float ihy, int nx, int ny, int max_iters, int it0, int* elem_out,
    uint8_t* active_out, int* stats, long long n, cudaStream_t stream) {
  if (rows == nullptr) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  long long blocks = (n + WALK_THREADS - 1) / WALK_THREADS;
  const long long cap = (long long)num_sms() * 8;
  if (blocks > cap) blocks = cap;
  walk_locate_kernel<<<(unsigned)blocks, WALK_THREADS, 0, stream>>>(
      dest_x, dest_y, elem_start, active, geom, n_elems, rows, cells, ox, oy,
      ihx, ihy, nx, ny, max_iters, it0, elem_out, active_out, stats, n);
  return (int)cudaGetLastError();
}

// The dense plain walk (walk_dense_kernel) on a resident grid: elem_out
// and active_out for every slot; stats[0] <- max steps (atomicMax),
// stats[1] <- walkers deleted at the limit (atomicAdd), zeroed by the
// caller.
extern "C" int pp_walk_dense(
    const float* dest_x, const float* dest_y, const int* elem_start,
    const uint8_t* active, const float* geom, int n_elems, int max_iters,
    int* elem_out, uint8_t* active_out, int* stats, long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  static int resident = 0;
  if (resident == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_dense_kernel, WD_THREADS, 0);
    resident = num_sms() * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = (n + 31) / 32;
  long long blocks = (tiles + WD_THREADS / 32 - 1) / (WD_THREADS / 32);
  if (blocks > resident) blocks = resident;
  walk_dense_kernel<<<(unsigned)blocks, WD_THREADS, 0, stream>>>(
      dest_x, dest_y, elem_start, active, geom, n_elems, max(max_iters, 0), elem_out,
      active_out, stats, n);
  return (int)cudaGetLastError();
}

// The sparse plain walk (walk_plain.cuh).  Destination component c of
// particle i at d{x,y}[i * s{x,y}].  elem_out gets the walkers' results in
// place, or nothing where it is nullptr.  stats[0] <- max steps
// (atomicMax), stats[1] <- walkers deleted at the limit, stats[2] <- walkers
// found (atomicAdd); zeroed here first when zero_stats (kernel J zeroes
// them for the repair walk).
extern "C" int pp_walk_plain(
    const float* dx, long long sx, const float* dy, long long sy,
    const int* elem_start, const uint8_t* walkers, const float* geom,
    int n_elems, int max_iters, int* elem_out, int* stats, int zero_stats,
    long long n, cudaStream_t stream) {
  if (zero_stats) {
    const cudaError_t err = cudaMemsetAsync(stats, 0, 3 * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  return walk_plain_launch<2, PlainStep2D>({{dx, dy}, {sx, sy}}, elem_start, walkers, geom,
                                           n_elems, max_iters, elem_out, stats, n, stream);
}
