// Kernel L3: the tet version of kernel L.  Locate = cell-candidate peel +
// guess-walk BCC search with remove-on-exit + the DPS rewrite, with the
// whole walk inside the kernel.
//
// Replaces (JAX reference): LocatorGrid3D.cell_of (pumipic_tpu/mesh/
// locator.py:145-157), the 26-column "rows" peel of search_mesh_3d_accel
// (pumipic_tpu/ops/search.py:1451-1500), the walk step _make_step with the
// BCC core _core_3d_bcc (:595-707, :257-310) and remove_on_exit (:110-121),
// and the pyramid loop _run_walk (:710-950) (queue item K10, its BCC core
// and peel).  With cell_ids == nullptr it is the plain walk search_mesh_3d
// (:1006-1044); on walk_plain.cuh's sparse schedule (PlainStep3D) it is
// that walk over a sparse mask in place, the parent repair of check_initial_parents (:1527-1595) behind
// kernel J.  The TPU Pallas probes of the 2D walk step
// (perf/archive/walk_opt.py:219, walk_opt2.py:92, walk_opt4.py:101) are the
// design's ancestors through kernel L.
//
// What bounds it on an H100: device-memory traffic and the latency of
// dependent loads.  Per particle: 17 bytes streamed in (dest x, y, z,
// previous elem, active) and 5 out; the peel reads the cell's candidate
// pair (8 bytes from a 3.1 MB table at 389,017 cells) and candidate A's
// 64-byte walk_geom row (1.6 MB, in L2), B's affine columns only where A
// does not contain the point.  About one particle in seven misses both and
// walks, each step a dependent 64-byte row load.  Measured
// (scripts/ab_locate3d.py), the peel holds it: its chain of dependent
// loads (destination, pair, A, B) and its unfused f32 arithmetic take 86%
// of the kernel's time with the walkers counted and not walked.
//
// Design (scripts/ab_locate3d.py's probes of the first L3, one thread a
// particle over a grid-stride loop, found its peel alone at 78% of its time,
// the walkers in the peel's warps at 22%, and a second, partly empty wave
// and the 104-byte rows at 4-16% each after that; a pool shared by the
// whole block, walked between barriers, waited at each barrier for its
// longest chain of dependent loads):
// - A grid of one full wave: as many blocks as are resident at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), whose warps take
//   tiles of 32 particles in turn.
// - Walkers are compacted inside each warp, with no barrier between warps.
//   A warp peels a tile and pushes the particles that still walk onto its
//   pool in shared memory (index, element, retry element, steps and the
//   destination), a stack of L3_POOL; whenever the pool holds 32 walkers
//   (or the warp has no tile left) the top 32 take at most L3_ROUND steps
//   each and those still walking are pushed back.  A warp thus walks with
//   every lane a walker, whatever a tile's walker share, and a long walker
//   (one wrapped across the periodic box) holds only its own lane.  A warp
//   peels only while its pool has room for a whole tile, so the pool never
//   overflows.  A particle's result does not depend on when it is walked,
//   so the outputs are deterministic.
// - The peel reads the pair and candidate A's row, B's affine columns only
//   where A does not contain the point, and runs the first walk step on A's
//   row where neither does: the plain version's first step recomputes the
//   same weights (the pair's rows equal cell_rows' affine columns bit for
//   bit, checked on the host).  The plain walk's first step is taken the
//   same way, on the start tet's row.
// - The iteration budget is the reference's: the peel counts as iteration
//   it0 = 1, each walker takes at most max_iters - it0 steps, and walkers
//   unfinished at the limit are deleted.  iters = it0 + the most steps any
//   walker took (a block max, then one atomicMax per block); stats[1]
//   counts the walkers deleted at the limit (one atomicAdd per block).
// Built with -fmad=false and summed left to right as _core_3d_bcc does, so
// every containment test and every exit choice rounds as the plain PyTorch
// version's separate ops do (a reassociated sum moves which tet wins at a
// shared face).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "walk_plain.cuh"

#define BCC_REL_TOL 4.76837158203125e-07f  // 8 * 2^-24
#define BCC_ABS_TOL 1e-7f
#define L3_THREADS 256                // a block
#define L3_WARPS (L3_THREADS / 32)
#define L3_POOL 64                    // walkers a warp holds between rounds
#define L3_ROUND 4                    // steps a walker takes per round

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

// the first n4 float4s of element e's 64-byte walk_geom row (16-byte aligned)
template <int n4>
__device__ __forceinline__ void load_row(const float* geom, int e, float* g) {
  const float4* g4 = reinterpret_cast<const float4*>(geom + (size_t)e * 16);
#pragma unroll
  for (int j = 0; j < n4; ++j) {
    const float4 v = __ldg(g4 + j);
    g[4 * j] = v.x;
    g[4 * j + 1] = v.y;
    g[4 * j + 2] = v.z;
    g[4 * j + 3] = v.w;
  }
}

struct Walker {
  int i, elem, fbg, steps;   // fbg >= 0: on a guess trajectory, the retry element
  float x, y, z;
};

// leave a tet that does not contain the point (weights w, neighbour ids
// g[12..15]) across the face opposite the most negative weight, first in
// the order w0, l1, l2, l3, strictly smaller to move (NaN never moves);
// true when the walker is finished (a real boundary exit: removed)
__device__ __forceinline__ bool exit_face(const Bary3& w, const float* g, Walker& k) {
  float wmin = w.w0, nxt = g[12];
  if (w.l1 < wmin) { wmin = w.l1; nxt = g[13]; }
  if (w.l2 < wmin) { wmin = w.l2; nxt = g[14]; }
  if (w.l3 < wmin) { wmin = w.l3; nxt = g[15]; }
  const int next = (int)nxt;
  if (next != -1) {
    k.elem = next;
    return false;
  }
  if (k.fbg >= 0) {          // guess trajectory: retry from the true start
    k.elem = k.fbg;
    k.fbg = -2;
    return false;
  }
  k.elem = -1;               // exposed face: remove
  return true;
}

// walk k until it is found, removed or has taken `limit` steps; true when
// it is finished
__device__ __forceinline__ bool walk(const float* __restrict__ geom, Walker& k,
                                     int limit) {
  while (k.steps < limit) {
    ++k.steps;
    float g[16];
    load_row<4>(geom, k.elem, g);
    const Bary3 w = bary3(g, k.x, k.y, k.z);
    if (w.inside) return true;
    if (exit_face(w, g, k)) return true;
  }
  return false;
}

struct Grid3 {
  float origin[3], inv_h[3];
  int n[3];
};

// the cell of (x, y, z) in f32 index arithmetic (LocatorGrid3D.cell_of): a
// NaN coordinate gives cell 0, as the plain version's NaN -> int cast and
// clamp do
__device__ __forceinline__ int cell_of(const Grid3& grid, float x, float y, float z) {
  const float p[3] = {x, y, z};
  float c[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    c[j] = fminf(fmaxf(floorf((p[j] - grid.origin[j]) * grid.inv_h[j]), 0.0f),
                 (float)(grid.n[j] - 1));
  if (x != x || y != y || z != z) return 0;
  const int n_cells = grid.n[0] * grid.n[1] * grid.n[2];
  return min(max((int)((c[0] * (float)grid.n[1] + c[1]) * (float)grid.n[2] + c[2]), 0),
             n_cells - 1);
}

// a warp's walkers between its rounds, kept as a stack
struct WarpPool {
  int i[L3_POOL], elem[L3_POOL], fbg[L3_POOL], steps[L3_POOL];
  float x[L3_POOL], y[L3_POOL], z[L3_POOL];
};

// the lanes with `keep` push their walker onto the warp's pool of n
// walkers (all lanes of the warp call it, n is the same in each)
__device__ __forceinline__ void pool_push(WarpPool& p, int& n, bool keep,
                                          const Walker& k) {
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (keep) {
    const int j = n + __popc(m & ((1u << (threadIdx.x & 31)) - 1u));
    p.i[j] = k.i;
    p.elem[j] = k.elem;
    p.fbg[j] = k.fbg;
    p.steps[j] = k.steps;
    p.x[j] = k.x;
    p.y[j] = k.y;
    p.z[j] = k.z;
  }
  n += __popc(m);
  __syncwarp();
}

__global__ void __launch_bounds__(L3_THREADS) walk_locate_3d_kernel(
    const float* __restrict__ dest, const int* __restrict__ elem_start,
    const uint8_t* __restrict__ active, const float* __restrict__ geom,
    int n_elems, const int2* __restrict__ cell_ids, Grid3 grid, int budget,
    int* __restrict__ elem_out, uint8_t* __restrict__ active_out,
    int* __restrict__ stats, int n) {
  __shared__ WarpPool pools[L3_WARPS];
  __shared__ int s_max[L3_WARPS];
  __shared__ int s_unf[L3_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpPool& pool = pools[warp];
  int pool_n = 0;                           // the same in every lane
  int my_max = 0;
  int my_unfinished = 0;
  // a finished particle: write its outputs (at_limit: deleted at the limit)
  auto finish = [&](const Walker& k, bool at_limit) {
    const int e = at_limit ? -1 : k.elem;
    elem_out[k.i] = e;
    active_out[k.i] = e >= 0 ? 1 : 0;
    my_max = max(my_max, k.steps);
    if (at_limit) ++my_unfinished;
  };
  // a walker that stopped without finishing: deleted at the limit, or
  // pushed back (all lanes call)
  auto keep_or_delete = [&](bool walking, const Walker& k) {
    if (walking && k.steps >= budget) {
      finish(k, true);
      walking = false;
    }
    pool_push(pool, pool_n, walking, k);
  };
  // the grid's warps take tiles of 32 particles in turn (int indices: the
  // launcher takes n < 2^30)
  const int n_tiles = (n + 31) / 32, stride = gridDim.x * L3_WARPS;
  int tile = blockIdx.x * L3_WARPS + warp;
  while (tile < n_tiles || pool_n > 0) {
    if (tile < n_tiles && pool_n <= L3_POOL - 32) {
      // peel this tile: candidate A (the start tet in the plain walk), then
      // B; a particle neither contains takes its first step on A's row here
      const int i = tile * 32 + lane;
      Walker k{i, -1, -2, 0, 0.0f, 0.0f, 0.0f};
      if (i < n) {
        const float* d = dest + 3 * (size_t)i;
        k.x = d[0];
        k.y = d[1];
        k.z = d[2];
      }
      bool walking = false;
      if (i < n && active[i]) {
        const bool plain = cell_ids == nullptr;
        const int start = min(max(elem_start[i], 0), n_elems - 1);
        const int2 ab = plain ? make_int2(start, start)
                              : __ldg(cell_ids + cell_of(grid, k.x, k.y, k.z));
        k.elem = ab.x;
        walking = true;
        if (!plain || budget > 0) {           // the plain walk's test is its step 1
          float g[16];
          load_row<4>(geom, k.elem, g);
          const Bary3 wa = bary3(g, k.x, k.y, k.z);
          if (plain) k.steps = 1;
          walking = !wa.inside;
          if (walking && !plain) {
            float gb[12];
            load_row<3>(geom, ab.y, gb);
            if (bary3(gb, k.x, k.y, k.z).inside) {
              k.elem = ab.y;
              walking = false;
            }
          }
          if (walking && budget > 0) {
            if (!plain) {                     // a guess walk from A: step 1 here
              k.fbg = start;
              k.steps = 1;
            }
            if (exit_face(wa, g, k)) walking = false;   // removed at the boundary
          }
        }
      }
      if (i < n && !walking) finish(k, false);
      keep_or_delete(walking, k);
      tile += stride;
    }
    if (pool_n >= 32 || (tile >= n_tiles && pool_n > 0)) {
      // a round: the top (up to) 32 walkers take at most L3_ROUND steps each
      const int take = min(pool_n, 32);
      pool_n -= take;
      const bool walking = lane < take;
      Walker k{};
      if (walking) {
        const int j = pool_n + lane;
        k = Walker{pool.i[j], pool.elem[j], pool.fbg[j], pool.steps[j], pool.x[j],
                   pool.y[j], pool.z[j]};
      }
      __syncwarp();
      bool still = walking;
      if (walking && walk(geom, k, min(k.steps + L3_ROUND, budget))) {
        finish(k, false);
        still = false;
      }
      keep_or_delete(still, k);
    }
  }
  // block reduction, then one atomic per block
  my_max = __reduce_max_sync(0xffffffffu, my_max);
  my_unfinished = __reduce_add_sync(0xffffffffu, my_unfinished);
  if (lane == 0) {
    s_max[warp] = my_max;
    s_unf[warp] = my_unfinished;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bm = 0, bu = 0;
    for (int w = 0; w < L3_WARPS; ++w) {
      bm = max(bm, s_max[w]);
      bu += s_unf[w];
    }
    if (bm > 0) atomicMax(&stats[0], bm);
    if (bu > 0) atomicAdd(&stats[1], bu);
  }
}

// one step of the plain walk from elem toward (x, y, z), walk()'s step with
// no guess trajectory: true when the walker stops (inside: elem kept; an
// exposed face: elem = -1)
__device__ __forceinline__ bool plain_step_3d(const float* __restrict__ geom, int& elem,
                                              float x, float y, float z) {
  float g[16];
  load_row<4>(geom, elem, g);
  const Bary3 w = bary3(g, x, y, z);
  if (w.inside) return true;
  Walker k{0, elem, -2, 0, x, y, z};
  const bool removed = exit_face(w, g, k);
  elem = k.elem;
  return removed;
}

// the 3D step of walk_plain.cuh's schedule: this file's plain-walk step,
// so the sparse walk's results equal walk_locate_3d_kernel's with no cell
// ids bit for bit
struct PlainStep3D {
  static __device__ __forceinline__ bool run(const float* __restrict__ geom, int& elem,
                                             const float* x) {
    return plain_step_3d(geom, elem, x[0], x[1], x[2]);
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

// blocks of the kernel resident on one SM at once (its registers and
// shared memory allow)
extern "C" int pp_walk_locate_3d_blocks_per_sm(void) {
  static int blocks = 0;
  if (blocks == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, walk_locate_3d_kernel,
                                                  L3_THREADS, 0);
    if (blocks <= 0) blocks = 1;
  }
  return blocks;
}

// dest: (n, 3) f32; geom: (n_elems, 16) f32, 16-byte aligned; cell_ids:
// (nx*ny*nz, 2) i32, each cell's candidates A and B (8-byte aligned), or
// nullptr for the plain walk; oh: the grid's origin[3] and inv_h[3].
// stats[0] <- max steps over walkers, stats[1] <- walkers deleted at the
// limit; the caller zeroes both.  n < 2^30.
extern "C" int pp_walk_locate_3d(
    const float* dest, const int* elem_start, const uint8_t* active,
    const float* geom, int n_elems, const int* cell_ids, const float* oh,
    int nx, int ny, int nz, int max_iters, int it0, int* elem_out,
    uint8_t* active_out, int* stats, long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  Grid3 grid;
  for (int j = 0; j < 3; ++j) {
    grid.origin[j] = oh[j];
    grid.inv_h[j] = oh[3 + j];
  }
  grid.n[0] = nx;
  grid.n[1] = ny;
  grid.n[2] = nz;
  long long blocks = (n + L3_THREADS - 1) / L3_THREADS;
  const long long wave = (long long)num_sms() * pp_walk_locate_3d_blocks_per_sm();
  if (blocks > wave) blocks = wave;
  const int budget = max_iters > it0 ? max_iters - it0 : 0;
  walk_locate_3d_kernel<<<(unsigned)blocks, L3_THREADS, 0, stream>>>(
      dest, elem_start, active, geom, n_elems,
      reinterpret_cast<const int2*>(cell_ids), grid, budget, elem_out, active_out,
      stats, (int)n);
  return (int)cudaGetLastError();
}

// The sparse plain walk in place (walk_plain.cuh): the walkers' results
// into elem_out, the other slots untouched.  Destination component c of
// particle i at d{x,y,z}[i * s{x,y,z}].  stats[0] <- max steps
// (atomicMax), stats[1] <- walkers deleted at the limit, stats[2] <- walkers
// found (atomicAdd), added to what the caller holds there (kernel J zeroes
// them for the parent repair).  n < 2^31.
extern "C" int pp_walk_plain_3d(
    const float* dx, long long sx, const float* dy, long long sy, const float* dz,
    long long sz, const int* elem_start, const uint8_t* walkers, const float* geom,
    int n_elems, int max_iters, int* elem_out, int* stats, long long n,
    cudaStream_t stream) {
  return walk_plain_launch<3, PlainStep3D>({{dx, dy, dz}, {sx, sy, sz}}, elem_start,
                                           walkers, geom, n_elems, max_iters, elem_out,
                                           stats, n, stream);
}
