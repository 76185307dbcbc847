// Kernel L3: the tet version of kernel L.  Locate = 26-column cell-row peel
// + guess-walk BCC search with remove-on-exit + the DPS rewrite, one thread
// per particle with the whole walk inside the kernel.
//
// Replaces (JAX reference): LocatorGrid3D.cell_of (pumipic_tpu/mesh/
// locator.py:145-157), the 26-column "rows" peel of search_mesh_3d_accel
// (pumipic_tpu/ops/search.py:1451-1500), the walk step _make_step with the
// BCC core _core_3d_bcc (:595-707, :257-310) and remove_on_exit (:110-121),
// and the pyramid loop _run_walk (:710-950) (queue item K10, its BCC core
// and peel).  With rows == nullptr it is the plain walk search_mesh_3d
// (:1006-1044).  The TPU Pallas probes of the 2D walk step
// (perf/archive/walk_opt.py:219, walk_opt2.py:92, walk_opt4.py:101) are the
// design's ancestors through kernel L.
//
// What bounds it on an H100: device-memory traffic of the random row loads.
// Per particle: 17 bytes streamed in (dest x, y, z, previous elem, active),
// one 104-byte cell row at a data-dependent address (the 40 MB table of the
// 16^3 Kuhn box at 16 cells per tet fits the 50 MB L2), 5 bytes out; the
// walkers the peel misses (about one in seven on tets) add one 64-byte
// walk_geom row per step (1.6 MB table, in L2).
//
// Design: as kernel L.  A thread keeps walking; finished threads idle in
// their warp and nothing is compacted.  The iteration budget is the
// reference's: the peel counts as iteration it0 = 1, each walker takes at
// most max_iters - it0 steps, and walkers unfinished at the limit are
// deleted.  iters = it0 + the most steps any walker took (a block max, then
// one atomicMax per block); stats[1] counts the walkers deleted at the
// limit (one atomicAdd per block).  A walk_geom row is four 16-byte loads; a
// cell row, 8-byte aligned, thirteen 8-byte loads.  Built with -fmad=false
// and summed left to right as _core_3d_bcc does, so every containment test
// and every exit choice rounds as the plain PyTorch version's separate ops
// do (a reassociated sum moves which tet wins at a shared face).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BCC_REL_TOL 4.76837158203125e-07f  // 8 * 2^-24
#define BCC_ABS_TOL 1e-7f
#define WALK_THREADS 256

struct Bary3 {
  float l1, l2, l3, w0;
  bool inside;
};

// barycentric weights of (dx, dy, dz) in the affine rows a[0..11] and the
// tolerance-relative containment test (search.py _core_3d_bcc)
__device__ __forceinline__ Bary3 bary3(const float* a, float dx, float dy,
                                       float dz) {
  Bary3 r;
  r.l1 = a[0] * dx + a[1] * dy + a[2] * dz + a[3];
  r.l2 = a[4] * dx + a[5] * dy + a[6] * dz + a[7];
  r.l3 = a[8] * dx + a[9] * dy + a[10] * dz + a[11];
  r.w0 = 1.0f - r.l1 - r.l2 - r.l3;
  const float m1 = fabsf(a[0] * dx) + fabsf(a[1] * dy) + fabsf(a[2] * dz) + fabsf(a[3]);
  const float m2 = fabsf(a[4] * dx) + fabsf(a[5] * dy) + fabsf(a[6] * dz) + fabsf(a[7]);
  const float m3 = fabsf(a[8] * dx) + fabsf(a[9] * dy) + fabsf(a[10] * dz) + fabsf(a[11]);
  const float t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL;
  const float t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL;
  const float t3 = BCC_REL_TOL * m3 + BCC_ABS_TOL;
  r.inside = (r.w0 >= -(t1 + t2 + t3)) && (r.l1 >= -t1) && (r.l2 >= -t2) &&
             (r.l3 >= -t3);
  return r;
}

struct Grid3 {
  float origin[3], inv_h[3];
  int n[3];
};

__global__ void __launch_bounds__(WALK_THREADS) walk_locate_3d_kernel(
    const float* __restrict__ dest, const int* __restrict__ elem_start,
    const uint8_t* __restrict__ active, const float* __restrict__ geom,
    int n_elems, const float* __restrict__ rows, Grid3 grid, int max_iters,
    int it0, int* __restrict__ elem_out, uint8_t* __restrict__ active_out,
    int* __restrict__ stats, long long n) {
  int my_max = 0;
  int my_unfinished = 0;
  const int budget = max(max_iters - it0, 0);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float dx = dest[3 * i], dy = dest[3 * i + 1], dz = dest[3 * i + 2];
    int elem = -1;
    int fbg = -2;  // >= 0: on a guess trajectory, value = element to retry from
    bool done = true;
    if (active[i]) {
      const int start = min(max(elem_start[i], 0), n_elems - 1);
      if (rows != nullptr) {
        // cell id in f32 index arithmetic (LocatorGrid3D.cell_of)
        const float p[3] = {dx, dy, dz};
        float c[3];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          c[j] = fminf(fmaxf(floorf((p[j] - grid.origin[j]) * grid.inv_h[j]), 0.0f),
                       (float)(grid.n[j] - 1));
        const int n_cells = grid.n[0] * grid.n[1] * grid.n[2];
        const int cell = min(max((int)((c[0] * (float)grid.n[1] + c[1]) *
                                       (float)grid.n[2] + c[2]), 0), n_cells - 1);
        // 104-byte row, 8-byte aligned: thirteen float2 loads
        const float2* r2 = reinterpret_cast<const float2*>(rows + (size_t)cell * 26);
        float r[26];
#pragma unroll
        for (int j = 0; j < 13; ++j) {
          const float2 v = __ldg(r2 + j);
          r[2 * j] = v.x;
          r[2 * j + 1] = v.y;
        }
        const bool in_a = bary3(r, dx, dy, dz).inside;
        const bool in_b = bary3(r + 13, dx, dy, dz).inside;
        if (in_a || in_b) {
          elem = in_a ? (int)r[12] : (int)r[25];
        } else {
          elem = (int)r[12];
          fbg = start;
          done = false;
        }
      } else {
        elem = start;
        done = false;
      }
    }
    int steps = 0;
    while (!done && steps < budget) {
      ++steps;
      // 64-byte walk_geom row, 16-byte aligned: four float4 loads
      const float4* g4 = reinterpret_cast<const float4*>(geom + (size_t)elem * 16);
      float g[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = __ldg(g4 + j);
        g[4 * j] = v.x;
        g[4 * j + 1] = v.y;
        g[4 * j + 2] = v.z;
        g[4 * j + 3] = v.w;
      }
      const Bary3 w = bary3(g, dx, dy, dz);
      if (w.inside) {
        done = true;
        break;
      }
      // most negative weight, first in the order w0, l1, l2, l3, strictly
      // smaller to move (NaN never moves) -> cross the face opposite it
      float wmin = w.w0;
      int kmin = 0;
      if (w.l1 < wmin) { wmin = w.l1; kmin = 1; }
      if (w.l2 < wmin) { wmin = w.l2; kmin = 2; }
      if (w.l3 < wmin) { wmin = w.l3; kmin = 3; }
      const int next = (int)g[12 + kmin];
      if (next == -1) {          // exposed face
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

// dest: (n, 3) f32; geom: (n_elems, 16) f32, 16-byte aligned; rows:
// (nx*ny*nz, 26) f32, 8-byte aligned, or nullptr for the plain walk; oh:
// the grid's origin[3] and inv_h[3].  stats[0] <- max steps over walkers,
// stats[1] <- walkers deleted at the limit; the caller zeroes both.
extern "C" int pp_walk_locate_3d(
    const float* dest, const int* elem_start, const uint8_t* active,
    const float* geom, int n_elems, const float* rows, const float* oh,
    int nx, int ny, int nz, int max_iters, int it0, int* elem_out,
    uint8_t* active_out, int* stats, long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  Grid3 grid;
  for (int j = 0; j < 3; ++j) {
    grid.origin[j] = oh[j];
    grid.inv_h[j] = oh[3 + j];
  }
  grid.n[0] = nx;
  grid.n[1] = ny;
  grid.n[2] = nz;
  long long blocks = (n + WALK_THREADS - 1) / WALK_THREADS;
  const long long cap = (long long)num_sms() * 8;
  if (blocks > cap) blocks = cap;
  walk_locate_3d_kernel<<<(unsigned)blocks, WALK_THREADS, 0, stream>>>(
      dest, elem_start, active, geom, n_elems, rows, grid, max_iters, it0,
      elem_out, active_out, stats, n);
  return (int)cudaGetLastError();
}
