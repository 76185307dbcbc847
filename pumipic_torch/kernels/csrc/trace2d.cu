// Kernel M2: the 2D walk with its boundary handlers, exit records and
// stranded-walker recovery.
//
// Replaces (JAX reference): search_mesh_2d and search_mesh_2d_accel
// (pumipic_tpu/ops/search.py:967-1000, :1049-1262) in every case but kernel
// L's fast one: the walk step _make_step (:595-707) over _row_core_2d
// (:206-244), the handlers remove_on_exit (:110-121) and reflect_on_exit_2d
// (:124-145), the exit record of find_exit_face (record_exit: side, hit
// count, crossing point), the projection recovery _make_recover (:472-552)
// in 2D and the pyramid loop _run_walk (:710-950).  The TPU ran them as XLA
// while loops; its Pallas probes of the walk step (perf/archive/walk_opt.py:219,
// walk_opt2.py:92, walk_opt4.py:101) compute the step kernel L and this
// kernel share.
//
// What bounds it on an H100: the bytes of the streamed particle arrays, 8 of
// destination, 8 of origin (where the crossing point is needed), 5 of start
// triangle and mask in, 5 of triangle and mask out, 8 of destination out
// where the walk moves it (reflect, recover) and 16 of exit record with
// record_exit: ~50 bytes a particle with reflect and the record, 0.15 ms at
// 10M.  Above that, the rows the walk reads from L2 (48 bytes of walk_geom
// a step, 5.9 MB at 120k triangles; the peel's 56-byte cell rows): on the
// 2D path's first walk (10M particles pushed 3 triangle sizes, 5.5% beyond
// the wall and back) 23.5 rows a particle, 11.3 GB, 2.35 ms at the 4.8 TB/s
// kernel M's walk reached from L2; through the peel 18.6 rows, 1.86 ms
// (counted by scripts/count_walk_steps.py and scripts/ab_trace2d_vdeposit.py
// with the plain version).  Far targets read 171 rows a particle, faster
// than that rate allows: L1 serves a share of them, so the floor is soft.
//
// Design (scripts/ab_trace2d_vdeposit.py timed probes of the first M2, one
// thread walking a particle's whole segment over a grid-stride loop, and
// candidates against it; PERF.md §6): the first M2's lanes walked 7.9% of
// its warp steps, each warp waiting on its longest walker (every walker
// stopped after one step: 0.19 ms of its 13.3), so this M2 is kernel L3's
// warp pool (locate3d.cu) for triangles.
// - A grid of one resident wave whose warps take tiles of 32 particles in
//   turn.  A tile's lanes load their streams coalesced, peel and walk at
//   most M2_R0 steps, which ends most walks; the outputs of those walks
//   are written by the warp together.  A walker still walking goes with its
//   whole state (index, triangle, retry triangle, steps, destination,
//   origin, exit record: 48 bytes) onto the warp's pool in shared memory, a
//   stack of M2_POOL; a warp peels only while its pool has room for a tile,
//   and otherwise (or with no tile left) the top 32 walkers take at most
//   M2_R steps each, write their own outputs where they stop, and those
//   still walking go back.  So the 5% of walkers that cross the wall and
//   back walk 32 to a warp.  The budget max_iters - it0 counts each
//   walker's steps across rounds; a particle's result does not depend on
//   when it is walked, so the outputs are deterministic.  The statistics
//   take one atomic per warp.
// - Measured and left out: lanes refilled from the warp's tiles as their
//   walkers stop (no pool: no faster on the path's first walk, slower
//   through the peel and on far targets); registers capped for 10-16 blocks per SM
//   (slower: spills, or more instructions); the pool's counters kept in
//   shared memory (fewer registers, slower).  The pool costs registers (46
//   against 40 in the reflect + record template, 45 against 32 in reflect
//   alone: 10 blocks per SM against 12 and 16): where nearly every walk is
//   long (far targets) or none is (a budget of 2) the first M2 stays
//   faster (PERF.md §6).
// - The crossing parameter t is computed only where a walker meets the
//   boundary (the first M2 computed it, and its division, every step).
// - No dynamically indexed array on the hot path: the neighbour and the
//   edge across the exit side are selects over the row's columns, so the
//   row stays in registers and the kernel has no stack frame.
// - Rare paths out of the walk: the reflect handler reads the edge's unit
//   tangent and first vertex from a per-edge table built once per mesh with
//   reflect_on_exit_2d's f32 operations (one 16-byte load in place of
//   edge2verts, coords, a sqrt and a division); a walker left at the loop
//   limit with recover is written out marked (triangle -2 - e) and
//   recover_2d_kernel recovers the marked particles after the walk.
// - Templated over the handler and record_exit; the peel (cell_rows !=
//   nullptr: the cartesian cell computed here, or kernel B's band cells
//   given) and recovery are run-time branches.  The peel is kernel L's: the
//   cell's two candidate rows tested A then B; a particle neither contains
//   walks from A on a guess trajectory whose boundary hit retries once from
//   the true start and is never a real hit.
// - A reflected walker's segment restarts at the crossing point, t clamped
//   to [0, 1] first, t = w_o / (w_o - w_min) guarded where the denominator
//   is 0 (a walker whose destination equals its origin still walks: its
//   crossing point is the origin).
// Every expression follows the plain PyTorch version's order (sums left to
// right) and the build's -fmad=false keeps each product and sum rounded on
// its own, so the kernel equals trace_2d_plain bit for bit.  min/max/clamp
// propagate NaN as torch's do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BCC_REL_TOL 4.76837158203125e-07f  // 8 * 2^-24
#define BCC_ABS_TOL 1e-7f
#define RECOVER_TOL2 ((float)(1e-3 * 1e-3))
#define RECOVER_NUDGE 1e-5f
#define M2_THREADS 128                // a block
#define M2_WARPS (M2_THREADS / 32)
#ifndef M2_R0
#define M2_R0 8                       // steps a walker takes in its tile's round
#endif
#ifndef M2_R
#define M2_R 64                       // steps a pool walker takes in a round
#endif
#ifndef M2_POOL
#define M2_POOL 64                    // walkers a warp holds (at least a round's and a tile's)
#endif
#define FULL_MASK 0xffffffffu

// internal linkage: kernel M (trace3d.cu) has helpers and kernels of the
// same names in its own translation unit
namespace {

__device__ __forceinline__ float clamp01(float t) {   // torch.clamp(t, 0, 1)
  return t != t ? t : fminf(fmaxf(t, 0.0f), 1.0f);
}
__device__ __forceinline__ float nan_min(float a, float b) {   // torch.minimum
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {   // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct Bary {
  float l1, l2, w0;
  bool inside;
};

// barycentric weights of (dx, dy) in the affine row a[0..5] and the
// tolerance-relative containment test (search.py bary_inside)
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

struct CoreOut {
  Bary w;
  int k;      // local exit side (across from the most negative weight)
};

// _row_core_2d on a walk_geom row [a11 a12 c1 a21 | a22 c2 nbr0 nbr1 |
// nbr2 edge0 edge1 edge2]: the weights and the exit side
__device__ __forceinline__ CoreOut core_2d(const float4* r, const float* d) {
  const Bary w = bary(r[0].x, r[0].y, r[0].z, r[0].w, r[1].x, r[1].y, d[0], d[1]);
  CoreOut c{w, w.w0 <= w.l1 ? 0 : 1};
  if (w.l2 < nan_min(w.w0, w.l1)) c.k = 2;
  return c;
}

// _row_core_2d's segment parameter of the crossing of side c.k from the
// origin o, taken only where a walker meets the boundary
__device__ __forceinline__ float crossing_t(const float4* r, const CoreOut& c, const float* o) {
  const float wmin = nan_min(nan_min(c.w.w0, c.w.l1), c.w.l2);
  const float l1o = r[0].x * o[0] + r[0].y * o[1] + r[0].z;
  const float l2o = r[0].w * o[0] + r[1].x * o[1] + r[1].y;
  const float w0o = 1.0f - l1o - l2o;
  const float wo = c.k == 0 ? w0o : c.k == 1 ? l1o : l2o;
  const float den = wo - wmin;
  return wo / (den == 0.0f ? 1.0f : den);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float safe(float den) { return den == 0.0f ? 1.0f : den; }

// closest point on triangle (a, b, c) to p (geometry.closest_point_on_triangle)
__device__ __forceinline__ void closest_point(const float* p, const float* a,
                                              const float* b, const float* c,
                                              float* res) {
  float ab[3], ac[3], ap[3], bp[3], cp[3], cb[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ab[j] = b[j] - a[j];
    ac[j] = c[j] - a[j];
    ap[j] = p[j] - a[j];
    bp[j] = p[j] - b[j];
    cp[j] = p[j] - c[j];
    cb[j] = c[j] - b[j];
  }
  const float d1 = dot3(ab, ap), d2 = dot3(ac, ap), d3 = dot3(ab, bp);
  const float d4 = dot3(ac, bp), d5 = dot3(ab, cp), d6 = dot3(ac, cp);
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float t_ab = clamp01(d1 / safe(d1 - d3));
  const float denom = safe(va + vb + vc);
  const float v = vb / denom, w = vc / denom;
#pragma unroll
  for (int j = 0; j < 3; ++j) res[j] = a[j] + v * ab[j] + w * ac[j];
  const float t_bc = clamp01((d4 - d3) / safe((d4 - d3) + (d5 - d6)));
  if (va <= 0.0f && d4 - d3 >= 0.0f && d5 - d6 >= 0.0f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) res[j] = b[j] + t_bc * cb[j];
  }
  const float t_ac = clamp01(d2 / safe(d2 - d6));
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) res[j] = a[j] + t_ac * ac[j];
  }
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) res[j] = a[j] + t_ab * ab[j];
  }
  if (d6 >= 0.0f && d5 <= d6) {
#pragma unroll
    for (int j = 0; j < 3; ++j) res[j] = c[j];
  }
  if (d3 >= 0.0f && d4 <= d3) {
#pragma unroll
    for (int j = 0; j < 3; ++j) res[j] = b[j];
  }
  if (d1 <= 0.0f && d2 <= 0.0f) {
#pragma unroll
    for (int j = 0; j < 3; ++j) res[j] = a[j];
  }
}

// recover_project_2d: true when dest (moved to the nudged projection) is
// accepted on triangle e; the projection is the 3D one at z = 0
__device__ __forceinline__ bool recover(int e, float* dest,
                                        const int* __restrict__ elem2verts,
                                        const float* __restrict__ coords) {
  float vs[3][3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int vid = elem2verts[3 * (size_t)e + m];
    vs[m][0] = coords[2 * (size_t)vid];
    vs[m][1] = coords[2 * (size_t)vid + 1];
    vs[m][2] = 0.0f;
  }
  const float p[3] = {dest[0], dest[1], 0.0f};
  float q[3];
  closest_point(p, vs[0], vs[1], vs[2], q);
  const float qx = q[0] - p[0], qy = q[1] - p[1], qz = q[2] - p[2];
  const float d2 = qx * qx + qy * qy + qz * qz;
  float scale2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i + 1; j < 3; ++j) {
      const float ex = vs[i][0] - vs[j][0], ey = vs[i][1] - vs[j][1];
      scale2 = nan_max(scale2, ex * ex + ey * ey);
    }
  if (!(d2 <= RECOVER_TOL2 * scale2)) return false;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float cent = ((vs[0][j] + vs[1][j]) + vs[2][j]) / 3.0f;
    dest[j] = q[j] + (cent - q[j]) * RECOVER_NUDGE;
  }
  return true;
}

struct Trace2Args {
  const float* orig;         // (n, 2)
  const float* dest;         // (n, 2)
  const int* elem_start;
  const uint8_t* active;
  const float* geom;         // walk_geom (n_elems, 12)
  int n_elems;
  const float4* tangents;    // per edge: [t_x t_y a_x a_y]
  const float* coords;
  const int* elem2verts;
  const float* rows;         // (n_cells, 14) cell rows; nullptr: the plain start
  const int* cells;          // given cells (band grid) or nullptr: cartesian
  float ox, oy, ihx, ihy;
  int nx, ny;
  int budget;                // steps a walker may take (max_iters - it0)
  int recover;
  int* elem_out;
  uint8_t* active_out;
  float* dest_out;           // nullptr: the destination is never moved
  int* exit_side;
  int* num_hits;
  float* hit_out;
  int* stats;                // max steps, unfinished, recovered
  int n;
};

// a thread's particle while it walks
struct Walker2 {
  int elem, fbg, steps;      // fbg >= 0: on a guess trajectory, the retry triangle
  float d[2], o[2];          // destination, segment origin
  int side, nhits;           // exit record: last edge hit, real hits
  float hit[2];              // exit record: last crossing point
  bool walking;
  int out;                   // the triangle written out (-1: none) once it stops
};

__device__ __forceinline__ void stop(Walker2& w, int out) {
  w.walking = false;
  w.out = out;
}

// a walker whose budget is spent: deleted, or (recover) written out marked
// -2 - triangle for recover_2d_kernel
__device__ __forceinline__ void at_limit(const Trace2Args& a, Walker2& w, int& my_unf) {
  if (a.recover) {
    stop(w, -2 - w.elem);
  } else {
    ++my_unf;
    stop(w, -1);
  }
}

// the cartesian cell of (x, y) in f32 index arithmetic (LocatorGrid2D.cell_of,
// as kernel L computes it)
__device__ __forceinline__ int cell_of(const Trace2Args& a, float x, float y) {
  const float fx = fminf(fmaxf(floorf((x - a.ox) * a.ihx), 0.0f), (float)(a.nx - 1));
  const float fy = fminf(fmaxf(floorf((y - a.oy) * a.ihy), 0.0f), (float)(a.ny - 1));
  return min(max((int)(fx * (float)a.ny + fy), 0), a.nx * a.ny - 1);
}

// particle i's streams, and the peel (a particle the peel finds, or an
// inactive one, stops here)
template <bool NEED_ORIG>
__device__ __forceinline__ void start(const Trace2Args& a, Walker2& w, int i, int& my_unf) {
  const float2 dd = reinterpret_cast<const float2*>(a.dest)[i];
  w.d[0] = dd.x;
  w.d[1] = dd.y;
  if (NEED_ORIG) {
    const float2 oo = reinterpret_cast<const float2*>(a.orig)[i];
    w.o[0] = oo.x;
    w.o[1] = oo.y;
  } else {
    w.o[0] = dd.x;
    w.o[1] = dd.y;
  }
  w.hit[0] = dd.x;
  w.hit[1] = dd.y;
  w.fbg = -2;
  w.steps = 0;
  w.side = -1;
  w.nhits = 0;
  w.walking = true;
  if (!a.active[i]) {
    stop(w, -1);
    return;
  }
  const int s = min(max(a.elem_start[i], 0), a.n_elems - 1);
  w.elem = s;
  if (a.rows != nullptr) {          // the peel: candidate A, then B
    const int c = a.cells != nullptr ? a.cells[i] : cell_of(a, w.d[0], w.d[1]);
    // 56-byte row, 8-byte aligned: seven float2 loads
    const float2* r2 = reinterpret_cast<const float2*>(a.rows + (size_t)c * 14);
    float r[14];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const float2 v = __ldg(r2 + j);
      r[2 * j] = v.x;
      r[2 * j + 1] = v.y;
    }
    if (bary(r[0], r[1], r[2], r[3], r[4], r[5], w.d[0], w.d[1]).inside) {
      stop(w, (int)r[6]);
      return;
    }
    if (bary(r[7], r[8], r[9], r[10], r[11], r[12], w.d[0], w.d[1]).inside) {
      stop(w, (int)r[13]);
      return;
    }
    w.elem = (int)r[6];
    w.fbg = s;                      // a guess walk from A
  }
  if (a.budget <= 0) at_limit(a, w, my_unf);
}

// particle i's outputs, written once its walk has stopped (the warp's
// threads together, so the stores coalesce)
template <bool RECORD>
__device__ __forceinline__ void write_out(const Trace2Args& a, const Walker2& w, int i) {
  a.elem_out[i] = w.out;
  a.active_out[i] = w.out >= 0 ? 1 : 0;
  if (a.dest_out != nullptr)
    reinterpret_cast<float2*>(a.dest_out)[i] = make_float2(w.d[0], w.d[1]);
  if (RECORD) {
    a.exit_side[i] = w.side;
    a.num_hits[i] = w.nhits;
    reinterpret_cast<float2*>(a.hit_out)[i] = make_float2(w.hit[0], w.hit[1]);
  }
}

// one walk step of the thread's walker on its triangle's row r
template <bool REFLECT, bool RECORD>
__device__ __forceinline__ void step(const Trace2Args& a, Walker2& w, const float4* r,
                                     int& my_unf) {
  constexpr bool NEED_HIT = REFLECT || RECORD;
  ++w.steps;
  const CoreOut c = core_2d(r, w.d);
  if (c.w.inside) {
    stop(w, w.elem);
    return;
  }
  // the neighbour across side k: a select over the row's id columns
  const int nxt = (int)(c.k == 0 ? r[1].z : c.k == 1 ? r[1].w : r[2].x);
  if (nxt != -1) {                  // an interior side: cross it
    w.elem = nxt;
  } else if (w.fbg >= 0) {          // a guess walk's boundary: retry
    w.elem = w.fbg;
    w.fbg = -2;
  } else {                          // a real boundary hit
    float hit[2];
    int side = 0;
    if (NEED_HIT) {
      const float tc = clamp01(crossing_t(r, c, w.o));
      hit[0] = w.o[0] + tc * (w.d[0] - w.o[0]);
      hit[1] = w.o[1] + tc * (w.d[1] - w.o[1]);
      side = (int)(c.k == 0 ? r[2].y : c.k == 1 ? r[2].z : r[2].w);
    }
    if (RECORD) {
      w.side = side;
      ++w.nhits;
      w.hit[0] = hit[0];
      w.hit[1] = hit[1];
    }
    if (!REFLECT) {                 // remove
      stop(w, -1);
      return;
    }
    // mirror dest across the edge's line; the segment restarts at the wall
    const float4 tg = __ldg(a.tangents + max(side, 0));
    const float adx = w.d[0] - tg.z, ady = w.d[1] - tg.w;
    const float along = adx * tg.x + ady * tg.y;
    w.d[0] = tg.z + 2.0f * along * tg.x - adx;
    w.d[1] = tg.w + 2.0f * along * tg.y - ady;
    w.o[0] = hit[0];
    w.o[1] = hit[1];
  }
  if (w.steps >= a.budget) at_limit(a, w, my_unf);
}

// walk w until it stops or has taken `limit` steps
template <bool REFLECT, bool RECORD>
__device__ __forceinline__ void walk(const Trace2Args& a, Walker2& w, int limit,
                                     int& my_unf) {
  const float4* g4 = reinterpret_cast<const float4*>(a.geom);
  while (w.walking && w.steps < limit) {
    // 48-byte walk_geom row, 16-byte aligned: three float4 loads
    const float4 r[3] = {__ldg(g4 + (size_t)w.elem * 3), __ldg(g4 + (size_t)w.elem * 3 + 1),
                         __ldg(g4 + (size_t)w.elem * 3 + 2)};
    step<REFLECT, RECORD>(a, w, r, my_unf);
  }
}

// a warp's walkers between its rounds, kept as a stack: the particle index
// and the whole walk state (48 bytes)
struct Pool2 {
  int i[M2_POOL], elem[M2_POOL], fbg[M2_POOL], steps[M2_POOL];
  float dx[M2_POOL], dy[M2_POOL], ox[M2_POOL], oy[M2_POOL];
  int side[M2_POOL], nhits[M2_POOL];
  float hx[M2_POOL], hy[M2_POOL];
};

// the lanes with `keep` push their walker onto the warp's pool of n walkers
// (every lane calls it; n is the same in each).  Without the crossing point
// (remove, no record) the origin and the exit record are not kept.
template <bool NEED_ORIG>
__device__ __forceinline__ void pool_push(Pool2& p, int& n, bool keep, const Walker2& w,
                                          int i) {
  const unsigned m = __ballot_sync(FULL_MASK, keep);
  if (keep) {
    const int j = n + __popc(m & ((1u << (threadIdx.x & 31)) - 1u));
    p.i[j] = i;
    p.elem[j] = w.elem;
    p.fbg[j] = w.fbg;
    p.steps[j] = w.steps;
    p.dx[j] = w.d[0];
    p.dy[j] = w.d[1];
    if (NEED_ORIG) {
      p.ox[j] = w.o[0];
      p.oy[j] = w.o[1];
      p.side[j] = w.side;
      p.nhits[j] = w.nhits;
      p.hx[j] = w.hit[0];
      p.hy[j] = w.hit[1];
    }
  }
  n += __popc(m);
  __syncwarp();
}

template <bool NEED_ORIG>
__device__ __forceinline__ void pool_pop(const Pool2& p, int j, Walker2& w, int& i) {
  i = p.i[j];
  w.elem = p.elem[j];
  w.fbg = p.fbg[j];
  w.steps = p.steps[j];
  w.d[0] = p.dx[j];
  w.d[1] = p.dy[j];
  if (NEED_ORIG) {
    w.o[0] = p.ox[j];
    w.o[1] = p.oy[j];
    w.side = p.side[j];
    w.nhits = p.nhits[j];
    w.hit[0] = p.hx[j];
    w.hit[1] = p.hy[j];
  } else {
    w.o[0] = w.d[0];
    w.o[1] = w.d[1];
    w.side = -1;
    w.nhits = 0;
    w.hit[0] = w.d[0];
    w.hit[1] = w.d[1];
  }
  w.walking = true;
}

// The grid's warps take tiles of 32 particles in turn.  A tile's lanes load
// their streams, peel and walk at most M2_R0 steps; walkers still walking
// go onto the warp's pool.  A warp peels only while its pool has room for a
// tile (so it fills the pool exactly, never past it); otherwise, or when it
// has no tile left, the top 32 take at most M2_R steps each and those still
// walking go back.  Both kinds of round share one walk loop.
template <bool REFLECT, bool RECORD>
__global__ void __launch_bounds__(M2_THREADS) trace_2d_kernel(Trace2Args a) {
  constexpr bool NEED_ORIG = REFLECT || RECORD;
  __shared__ Pool2 pools[M2_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Pool2& pool = pools[warp];
  int pool_n = 0;                           // the same in every lane
  int my_steps = 0, my_unf = 0;
  const int n_tiles = (a.n + 31) / 32, stride = gridDim.x * M2_WARPS;
  int tile = blockIdx.x * M2_WARPS + warp;
  while (tile < n_tiles || pool_n > 0) {
    Walker2 w;
    w.walking = false;
    w.steps = 0;
    int i = 0, limit;
    bool mine;
    if (pool_n > M2_POOL - 32 || tile >= n_tiles) {   // a pool round
      const int take = min(pool_n, 32);
      pool_n -= take;
      mine = lane < take;
      if (mine) pool_pop<NEED_ORIG>(pool, pool_n + lane, w, i);
      __syncwarp();
      limit = w.steps + M2_R;
    } else {                                // a tile: the lanes write together
      i = tile * 32 + lane;
      mine = i < a.n;
      if (mine) start<NEED_ORIG>(a, w, i, my_unf);
      tile += stride;
      limit = M2_R0;
    }
    walk<REFLECT, RECORD>(a, w, limit, my_unf);
    if (mine && !w.walking) {
      write_out<RECORD>(a, w, i);
      my_steps = max(my_steps, w.steps);
    }
    pool_push<NEED_ORIG>(pool, pool_n, w.walking, w, i);
  }
  // one atomic per warp and statistic
  my_steps = __reduce_max_sync(FULL_MASK, my_steps);
  my_unf = __reduce_add_sync(FULL_MASK, my_unf);
  if (lane == 0) {
    if (my_steps > 0) atomicMax(&a.stats[0], my_steps);
    if (my_unf > 0) atomicAdd(&a.stats[1], my_unf);
  }
}

// the walkers the walk left marked at its limit (elem_out = -2 - triangle):
// accepted on their triangle at the nudged projection, else deleted
__global__ void __launch_bounds__(M2_THREADS) recover_2d_kernel(Trace2Args a) {
  int my_unf = 0, my_rec = 0;
  for (int i = blockIdx.x * M2_THREADS + threadIdx.x; i < a.n; i += gridDim.x * M2_THREADS) {
    const int m = a.elem_out[i];
    if (m > -2) continue;
    const int e = -2 - m;
    float d[2] = {a.dest_out[2 * (size_t)i], a.dest_out[2 * (size_t)i + 1]};
    if (recover(e, d, a.elem2verts, a.coords)) {
      a.elem_out[i] = e;
      a.active_out[i] = 1;
      a.dest_out[2 * (size_t)i] = d[0];
      a.dest_out[2 * (size_t)i + 1] = d[1];
      ++my_rec;
    } else {
      a.elem_out[i] = -1;
      ++my_unf;
    }
  }
  my_unf = __reduce_add_sync(FULL_MASK, my_unf);
  my_rec = __reduce_add_sync(FULL_MASK, my_rec);
  if ((threadIdx.x & 31) == 0) {
    if (my_unf > 0) atomicAdd(&a.stats[1], my_unf);
    if (my_rec > 0) atomicAdd(&a.stats[2], my_rec);
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

// blocks of one template resident on an SM at once
template <bool REFLECT, bool RECORD>
static int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, trace_2d_kernel<REFLECT, RECORD>, M2_THREADS, 0);
    if (blocks <= 0) blocks = 1;
  }
  return blocks;
}

template <bool REFLECT, bool RECORD>
static int launch(const Trace2Args& a, bool query, cudaStream_t stream) {
  const int per_sm = resident_blocks<REFLECT, RECORD>();
  if (query) return per_sm;
  long long blocks = ((long long)a.n + M2_THREADS - 1) / M2_THREADS;   // a tile a warp
  const long long wave = (long long)num_sms() * per_sm;
  if (blocks > wave) blocks = wave;
  trace_2d_kernel<REFLECT, RECORD><<<(unsigned)blocks, M2_THREADS, 0, stream>>>(a);
  return 0;
}

static int dispatch(const Trace2Args& a, int reflect, int record, bool query,
                    cudaStream_t stream) {
  if (reflect && record) return launch<true, true>(a, query, stream);
  if (reflect) return launch<true, false>(a, query, stream);
  if (record) return launch<false, true>(a, query, stream);
  return launch<false, false>(a, query, stream);
}

}  // namespace

// resident blocks per SM of the template (reflect, record)
extern "C" int pp_trace_2d_blocks_per_sm(int reflect, int record) {
  return dispatch(Trace2Args{}, reflect, record, true, nullptr);
}

// orig, dest: (n, 2) f32, 8-byte aligned (orig read where a crossing point
// is needed); geom: walk_geom (n_elems, 12), 16-byte aligned; tangents:
// (n_edges, 4) f32, 16-byte aligned, each edge's unit tangent and first
// vertex (read with reflect); coords (V, 2) and elem2verts (E, 3) (read by
// recovery); rows: (n_cells, 14) f32 cell rows, 8-byte aligned, or nullptr
// for the plain start; cells: per-particle cell ids or nullptr for the
// cartesian cell of (ox, oy, ihx, ihy, nx, ny).  dest_out (nullable; not
// with recover), exit_side, num_hits, hit_out (with record) are written for
// every particle.  stats[0..2] <- max steps, walkers deleted at the limit,
// walkers recovered; the caller zeroes them.  n < 2^30.
extern "C" int pp_trace_2d(
    const float* orig, const float* dest, const int* elem_start, const uint8_t* active,
    const float* geom, int n_elems, const float* tangents, const float* coords,
    const int* elem2verts, const float* rows, const int* cells, float ox, float oy,
    float ihx, float ihy, int nx, int ny, int max_iters, int it0, int reflect,
    int record, int recover, int* elem_out, uint8_t* active_out, float* dest_out,
    int* exit_side, int* num_hits, float* hit_out, int* stats, long long n,
    cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n >= (1LL << 30) || (recover && dest_out == nullptr) ||
      (reflect && tangents == nullptr))
    return (int)cudaErrorInvalidValue;
  Trace2Args a{orig, dest, elem_start, active, geom, n_elems,
              reinterpret_cast<const float4*>(tangents), coords, elem2verts, rows,
              cells, ox, oy, ihx, ihy, nx, ny, max_iters > it0 ? max_iters - it0 : 0,
              recover, elem_out, active_out, dest_out, exit_side, num_hits, hit_out,
              stats, (int)n};
  dispatch(a, reflect, record, false, stream);
  if (recover) {
    long long blocks = (n + M2_THREADS - 1) / M2_THREADS;
    if (blocks > (long long)num_sms() * 16) blocks = (long long)num_sms() * 16;
    recover_2d_kernel<<<(unsigned)blocks, M2_THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
