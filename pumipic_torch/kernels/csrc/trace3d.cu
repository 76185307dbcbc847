// Kernel M: the 3D walk with its cores, boundary handlers, exit records and
// stranded-walker recovery.
//
// Replaces (JAX reference): search_mesh_3d and search_mesh_3d_accel
// (pumipic_tpu/ops/search.py:1006-1044, :1268-1508) in every case but kernel
// L3's fast one: the walk step _make_step (:595-707) over the cores
// _core_3d_bcc (:257-310), _core_3d_hybrid (:313-402) and _core_3d_mt
// (:405-465), the handlers remove_on_exit (:110-121) and reflect_on_exit_3d
// (:148-169), the exit record of find_exit_face (record_exit: side, hit
// count, crossing point), the projection recovery _make_recover (:472-552)
// and the pyramid loop _run_walk (:710-950) (queue items K10's other cores
// and the GITR-style app's walk).  The TPU ran them as XLA while loops; no
// Pallas kernel.
//
// What bounds it on an H100: the rows the walk reads from L2, one 64- or
// 80-byte row per step from a table that stays there (12.6 MB walk_geom or
// 15.7 MB walk_planes at 196,608 tets): 4.7 steps a particle at the GITR
// step, 78 on far targets, each row three 32-byte sectors.  The bytes it
// must move from device memory are the streamed particle arrays: 12 bytes of
// destination, 12 of origin (the hybrid and intersection cores and every
// walk that needs the crossing point), 5 of start tet and mask in, 5 of tet
// and mask out, 12 of destination out where the walk moves it (reflect,
// recover) and 20 of exit record with record_exit.
//
// Design (scripts/ab_boris_trace3d.py timed probes of the first M, one
// thread walking a particle's whole segment, and candidate designs against
// it; PERF.md §6-7):
// - One thread walks one particle, as before, over a grid of one resident
//   wave (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs) whose threads
//   stride over the particles; the statistics take one atomic per warp of
//   that wave, not per warp of an n/128 grid (312,500 atomics on one
//   address at 10M).
// - No dynamically indexed array on the hot path: the neighbour across the
//   exit face is a select over the row's id columns (an index by the exit
//   face kept the row in local memory, a 64- or 80-byte stack frame written
//   on every step).
// - Rare paths out of the walk: the reflect handler reads the face's unit
//   normal and first vertex from a per-face table built once per mesh with
//   reflect_on_exit_3d's f32 operations (two 16-byte loads in place of
//   face2verts, coords, a sqrt and a division); a walker left at the loop
//   limit with recover is written out marked (tet -2 - e) and
//   recover_kernel recovers the marked particles after the walk.
// - A particle's outputs are written once its walk has stopped, the warp's
//   threads together, so the stores coalesce (writing each where its walk
//   stopped cost 0.3 ms at the gitr step).
// - Measured and left out: warps that refill finished lanes from a batch
//   of indices, with the rows loaded by the warp together through shared
//   memory (27% faster on far targets, slower at the gitr step and on the
//   peel form, whose walks are short: each particle's own streams, start
//   and scattered output writes outweigh the lanes a short walk leaves
//   idle); capped registers (__launch_bounds__ minimum blocks 6-10: equal
//   or slower).
// - Templated over the core, the handler and record_exit; the peel
//   (cell_ids != nullptr) and recovery are run-time branches.  The peel is
//   kernel L3's: the cell's candidate pair, the BCC test of A's then B's
//   walk_geom row; a particle neither contains walks from A on a guess
//   trajectory whose boundary hit retries once from the true start and is
//   never a real hit.  Recovery: the four faces' closest points, the
//   containment determinants, the nudge toward the centroid.
// Every expression follows the plain PyTorch version's order (sums left to
// right) and the build's -fmad=false keeps each product and sum rounded on
// its own, so the kernel equals trace_3d_plain bit for bit; a contracted
// a*b+c moves which tet wins at a shared face and, in the hybrid core, turns
// a stationary walker's zero rate into sign noise.  min/max/clamp propagate
// NaN as torch's do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BCC_REL_TOL 4.76837158203125e-07f  // 8 * 2^-24
#define BCC_ABS_TOL 1e-7f
#define MT_TOL 1e-6f
#define RECOVER_TOL2 ((float)(1e-3 * 1e-3))
#define RECOVER_NUDGE 1e-5f
#define M_THREADS 128                 // a block
#define FULL_MASK 0xffffffffu

enum { CORE_BCC = 0, CORE_HYBRID = 1, CORE_MT = 2 };

__device__ __forceinline__ float clamp01(float t) {   // torch.clamp(t, 0, 1)
  return t != t ? t : fminf(fmaxf(t, 0.0f), 1.0f);
}
__device__ __forceinline__ float nan_min(float a, float b) {   // torch.minimum
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {   // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct Bary3 {
  float l1, l2, l3, w0;
  bool inside;
};

// l(x) = A·x + c of the affine row at a[c..c+3], left to right
__device__ __forceinline__ float affine(const float* a, float x, float y, float z) {
  return a[0] * x + a[1] * y + a[2] * z + a[3];
}

// barycentric weights of (dx, dy, dz) and the tolerance-relative containment
// test (search.py bary_inside_3d)
__device__ __forceinline__ Bary3 bary3(const float* a, float dx, float dy, float dz) {
  Bary3 r;
  r.l1 = affine(a, dx, dy, dz);
  r.l2 = affine(a + 4, dx, dy, dz);
  r.l3 = affine(a + 8, dx, dy, dz);
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

// the most negative of w0, l1, l2, l3 (first on ties, strictly smaller
// moves, NaN never does)
__device__ __forceinline__ int most_negative(const Bary3& w, float* wmin) {
  float m = w.w0;
  int k = 0;
  if (w.l1 < m) { m = w.l1; k = 1; }
  if (w.l2 < m) { m = w.l2; k = 2; }
  if (w.l3 < m) { m = w.l3; k = 3; }
  *wmin = m;
  return k;
}

struct CoreOut {
  bool inside;
  int k;      // local exit face
  float t;    // segment parameter of the crossing (NEED_T)
};

// the affine columns a[0..11] of a walk_geom row
__device__ __forceinline__ void affine_cols(const float4* r, float* a) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float4 v = r[j];
    a[4 * j] = v.x;
    a[4 * j + 1] = v.y;
    a[4 * j + 2] = v.z;
    a[4 * j + 3] = v.w;
  }
}

// the affine columns of walk_geom's 64-byte row e (16-byte aligned)
__device__ __forceinline__ void load_affine(const float* geom, int e, float* g) {
  const float4* g4 = reinterpret_cast<const float4*>(geom + (size_t)e * 16);
  const float4 r[3] = {__ldg(g4), __ldg(g4 + 1), __ldg(g4 + 2)};
  affine_cols(r, g);
}

// _core_3d_bcc on a walk_geom row
template <bool NEED_T>
__device__ __forceinline__ CoreOut core_bcc(const float4* r, const float* d, const float* o) {
  float g[12];
  affine_cols(r, g);
  const Bary3 w = bary3(g, d[0], d[1], d[2]);
  float wmin;
  CoreOut c{w.inside, most_negative(w, &wmin), 0.0f};
  if (NEED_T) {
    const float l1o = affine(g, o[0], o[1], o[2]);
    const float l2o = affine(g + 4, o[0], o[1], o[2]);
    const float l3o = affine(g + 8, o[0], o[1], o[2]);
    const float w0o = 1.0f - l1o - l2o - l3o;
    const float wo = c.k == 0 ? w0o : c.k == 1 ? l1o : c.k == 2 ? l2o : l3o;
    const float den = wo - wmin;
    c.t = wo / (den == 0.0f ? 1.0f : den);
  }
  return c;
}

// _core_3d_hybrid on a walk_geom row: the earliest crossing among the
// faces whose weight falls (rate = the directional derivative -A_k·v),
// else the BCC choice
__device__ __forceinline__ CoreOut core_hybrid(const float4* r, const float* d,
                                               const float* o) {
  float g[12];
  affine_cols(r, g);
  const Bary3 w = bary3(g, d[0], d[1], d[2]);
  float wmin;
  const int k_bcc = most_negative(w, &wmin);
  float lo[4], lv[4];
  lo[1] = affine(g, o[0], o[1], o[2]);
  lo[2] = affine(g + 4, o[0], o[1], o[2]);
  lo[3] = affine(g + 8, o[0], o[1], o[2]);
  lo[0] = 1.0f - lo[1] - lo[2] - lo[3];
  const float vx = d[0] - o[0], vy = d[1] - o[1], vz = d[2] - o[2];
#pragma unroll
  for (int j = 0; j < 3; ++j) lv[j + 1] = g[4 * j] * vx + g[4 * j + 1] * vy + g[4 * j + 2] * vz;
  lv[0] = -lv[1] - lv[2] - lv[3];
  float t_exit = INFINITY;
  int k_seg = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float den = -lv[j];
    const float tj = lo[j] / (den == 0.0f ? 1.0f : den);
    if (den > 0.0f && tj < t_exit) {
      t_exit = tj;
      k_seg = j;
    }
  }
  const bool seg_ok = isfinite(t_exit);
  return CoreOut{w.inside, seg_ok ? k_seg : k_bcc, seg_ok ? t_exit : 1.0f};
}

// _core_3d_mt on a walk_planes row [n_x n_y n_z off] x 4 | nbr x 4, one
// plane at a time
__device__ __forceinline__ CoreOut core_mt(const float4* r, const float* d, const float* o) {
  const float vx = d[0] - o[0], vy = d[1] - o[1], vz = d[2] - o[2];
  bool inside = true;
  float t_exit = INFINITY, viol_best = -INFINITY;
  int k_exit = 0, k_viol = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 pl = r[i];
    const float nx = pl.x, ny = pl.y, nz = pl.z, off = pl.w;
    const float s_dest = nx * d[0] + ny * d[1] + nz * d[2];
    inside = inside && (s_dest <= off + MT_TOL * (1.0f + fabsf(off)));
    const float viol = s_dest - off;
    if (viol > viol_best) {
      viol_best = viol;
      k_viol = i;
    }
    const float ndd = nx * vx + ny * vy + nz * vz;
    const float s_orig = nx * o[0] + ny * o[1] + nz * o[2];
    const float ti = (off - s_orig) / (ndd == 0.0f ? 1.0f : ndd);
    if (ndd > 0.0f && ti < t_exit) {
      t_exit = ti;
      k_exit = i;
    }
  }
  const bool moving = vx != 0.0f || vy != 0.0f || vz != 0.0f;
  const bool fin = isfinite(t_exit);
  return CoreOut{inside || (moving && !fin), fin ? k_exit : k_viol, fin ? t_exit : 1.0f};
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

__device__ __forceinline__ float sq3(const float* a, const float* b) {
  const float x = a[0] - b[0], y = a[1] - b[1], z = a[2] - b[2];
  return x * x + y * y + z * z;
}

// det [a b c] of the rows p[m] - p0 (search.py _det3)
__device__ __forceinline__ float det_rows(const float* p0, const float* p1,
                                         const float* p2, const float* p3) {
  float a[3], b[3], c[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a[j] = p1[j] - p0[j];
    b[j] = p2[j] - p0[j];
    c[j] = p3[j] - p0[j];
  }
  return a[0] * (b[1] * c[2] - b[2] * c[1]) - a[1] * (b[0] * c[2] - b[2] * c[0]) +
         a[2] * (b[0] * c[1] - b[1] * c[0]);
}

// recover_project: true when dest (moved to the nudged projection) is
// accepted on tet e (every loop unrolled: no index into a local array is
// left to run time)
__device__ __forceinline__ bool recover(int e, float* dest,
                                        const int* __restrict__ elem2verts,
                                        const float* __restrict__ coords) {
  float vs[4][3];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int vid = elem2verts[4 * (size_t)e + m];
#pragma unroll
    for (int j = 0; j < 3; ++j) vs[m][j] = coords[3 * (size_t)vid + j];
  }
  constexpr int faces[4][3] = {{1, 2, 3}, {0, 2, 3}, {0, 1, 3}, {0, 1, 2}};
  float best[3], d2 = 0.0f;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    float q[3];
    closest_point(dest, vs[faces[f][0]], vs[faces[f][1]], vs[faces[f][2]], q);
    const float qd = sq3(q, dest);
    if (f == 0 || qd < d2) {
#pragma unroll
      for (int j = 0; j < 3; ++j) best[j] = q[j];
    }
    d2 = f == 0 ? qd : nan_min(qd, d2);
  }
  const float vol = det_rows(vs[0], vs[1], vs[2], vs[3]);
  const float vv = vol == 0.0f ? 1.0f : vol;
  const float sgn = (float)((0.0f < vv) - (vv < 0.0f));
  const float tolv = 1e-6f * fabsf(vol);
  const bool contained = (det_rows(dest, vs[1], vs[2], vs[3]) * sgn >= -tolv) &&
                         (det_rows(vs[0], dest, vs[2], vs[3]) * sgn >= -tolv) &&
                         (det_rows(vs[0], vs[1], dest, vs[3]) * sgn >= -tolv) &&
                         (det_rows(vs[0], vs[1], vs[2], dest) * sgn >= -tolv);
  if (contained) {
    d2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) best[j] = dest[j];
  }
  float scale2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i + 1; j < 4; ++j) scale2 = nan_max(scale2, sq3(vs[i], vs[j]));
  if (!(d2 <= RECOVER_TOL2 * scale2)) return false;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float cent = (((vs[0][j] + vs[1][j]) + vs[2][j]) + vs[3][j]) / 4.0f;
    dest[j] = best[j] + (cent - best[j]) * RECOVER_NUDGE;
  }
  return true;
}

struct Grid3 {
  float origin[3], inv_h[3];
  int n[3];
};

// the cell of (x, y, z) in f32 index arithmetic (LocatorGrid3D.cell_of)
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

struct TraceArgs {
  const float* orig;
  const float* dest;
  const int* elem_start;
  const uint8_t* active;
  const float* table;        // walk_geom (bcc, hybrid) or walk_planes (mt)
  const float* geom;         // walk_geom (the peel's rows)
  const int* elem2faces;
  const float4* normals;     // per face: [n_x n_y n_z 0], [first vertex, 0]
  const float* coords;
  const int* elem2verts;
  int n_elems;
  const int2* cell_ids;      // nullptr: the plain start
  Grid3 grid;
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
struct Walker {
  int elem, fbg, steps;      // fbg >= 0: on a guess trajectory, the retry tet
  float d[3], o[3];          // destination, segment origin
  int side, nhits;           // exit record: last face hit, real hits
  float hit[3];              // exit record: last crossing point
  bool walking;
  int out;                   // the tet written out (-1: none) once it stops
};

__device__ __forceinline__ void stop(Walker& w, int out) {
  w.walking = false;
  w.out = out;
}

// a walker whose budget is spent: deleted, or (recover) written out marked
// -2 - tet for recover_kernel
__device__ __forceinline__ void at_limit(const TraceArgs& a, Walker& w, int& my_unf) {
  if (a.recover) {
    stop(w, -2 - w.elem);
  } else {
    ++my_unf;
    stop(w, -1);
  }
}

// particle i's streams, and the peel (a particle the peel finds, or an
// inactive one, stops here)
template <bool NEED_ORIG>
__device__ __forceinline__ void start(const TraceArgs& a, Walker& w, int i, int& my_unf) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w.d[c] = a.dest[3 * (size_t)i + c];
    w.o[c] = NEED_ORIG ? a.orig[3 * (size_t)i + c] : w.d[c];
    w.hit[c] = w.d[c];
  }
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
  if (a.cell_ids != nullptr) {      // the peel: candidate A, then B
    const int2 ab = __ldg(a.cell_ids + cell_of(a.grid, w.d[0], w.d[1], w.d[2]));
    float g[12];
    load_affine(a.geom, ab.x, g);
    w.elem = ab.x;
    if (bary3(g, w.d[0], w.d[1], w.d[2]).inside) {
      stop(w, ab.x);
      return;
    }
    load_affine(a.geom, ab.y, g);
    if (bary3(g, w.d[0], w.d[1], w.d[2]).inside) {
      stop(w, ab.y);
      return;
    }
    w.fbg = s;                      // a guess walk from A
  }
  if (a.budget <= 0) at_limit(a, w, my_unf);
}

// particle i's outputs, written once its walk has stopped (the warp's
// threads together, so the stores coalesce)
template <bool RECORD>
__device__ __forceinline__ void write_out(const TraceArgs& a, const Walker& w, int i) {
  a.elem_out[i] = w.out;
  a.active_out[i] = w.out >= 0 ? 1 : 0;
  if (a.dest_out != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.dest_out[3 * (size_t)i + c] = w.d[c];
  }
  if (RECORD) {
    a.exit_side[i] = w.side;
    a.num_hits[i] = w.nhits;
#pragma unroll
    for (int c = 0; c < 3; ++c) a.hit_out[3 * (size_t)i + c] = w.hit[c];
  }
}

// one walk step of the thread's walker on its tet's row r
template <int CORE, bool REFLECT, bool RECORD>
__device__ __forceinline__ void step(const TraceArgs& a, Walker& w, const float4* r,
                                     int& my_unf) {
  constexpr bool NEED_HIT = REFLECT || RECORD;
  constexpr int NB = CORE == CORE_MT ? 16 : 12;      // neighbour column
  ++w.steps;
  CoreOut c;
  if constexpr (CORE == CORE_BCC)
    c = core_bcc<NEED_HIT>(r, w.d, w.o);
  else if constexpr (CORE == CORE_HYBRID)
    c = core_hybrid(r, w.d, w.o);
  else
    c = core_mt(r, w.d, w.o);
  if (c.inside) {
    stop(w, w.elem);
    return;
  }
  // the neighbour across face k: a select over the row's id columns (an
  // index by k into a row held in registers would copy it to local memory)
  const float4 ids = r[NB / 4];
  const int nxt = (int)(c.k == 0 ? ids.x : c.k == 1 ? ids.y : c.k == 2 ? ids.z : ids.w);
  if (nxt != -1) {                  // an interior face: cross it
    w.elem = nxt;
  } else if (w.fbg >= 0) {          // a guess walk's boundary: retry
    w.elem = w.fbg;
    w.fbg = -2;
  } else {                          // a real boundary hit
    float hit[3];
    int side = 0;
    if (NEED_HIT) {
      const float tc = clamp01(c.t);
#pragma unroll
      for (int j = 0; j < 3; ++j) hit[j] = w.o[j] + tc * (w.d[j] - w.o[j]);
      side = a.elem2faces[4 * (size_t)w.elem + c.k];
    }
    if (RECORD) {
      w.side = side;
      ++w.nhits;
#pragma unroll
      for (int j = 0; j < 3; ++j) w.hit[j] = hit[j];
    }
    if (!REFLECT) {                 // remove
      stop(w, -1);
      return;
    }
    // mirror dest across the face's plane; the segment restarts at the wall
    const float4* f = a.normals + 2 * (size_t)max(side, 0);
    const float4 nrm = __ldg(f), p0 = __ldg(f + 1);
    const float s = (w.d[0] - p0.x) * nrm.x + (w.d[1] - p0.y) * nrm.y +
                    (w.d[2] - p0.z) * nrm.z;
    w.d[0] = w.d[0] - 2.0f * s * nrm.x;
    w.d[1] = w.d[1] - 2.0f * s * nrm.y;
    w.d[2] = w.d[2] - 2.0f * s * nrm.z;
#pragma unroll
    for (int j = 0; j < 3; ++j) w.o[j] = hit[j];
  }
  if (w.steps >= a.budget) at_limit(a, w, my_unf);
}

template <int CORE, bool REFLECT, bool RECORD>
__global__ void __launch_bounds__(M_THREADS) trace_3d_kernel(TraceArgs a) {
  constexpr bool NEED_ORIG = REFLECT || RECORD || CORE != CORE_BCC;
  constexpr int N4 = CORE == CORE_MT ? 5 : 4;        // float4s a row
  const float4* t4 = reinterpret_cast<const float4*>(a.table);
  int my_steps = 0, my_unf = 0;
  for (int i = blockIdx.x * M_THREADS + threadIdx.x; i < a.n; i += gridDim.x * M_THREADS) {
    Walker w;
    start<NEED_ORIG>(a, w, i, my_unf);
    while (w.walking) {
      float4 r[N4];
#pragma unroll
      for (int j = 0; j < N4; ++j) r[j] = __ldg(t4 + (size_t)w.elem * N4 + j);
      step<CORE, REFLECT, RECORD>(a, w, r, my_unf);
    }
    write_out<RECORD>(a, w, i);
    my_steps = max(my_steps, w.steps);
  }
  // one atomic per warp and statistic
  my_steps = __reduce_max_sync(FULL_MASK, my_steps);
  my_unf = __reduce_add_sync(FULL_MASK, my_unf);
  if ((threadIdx.x & 31) == 0) {
    if (my_steps > 0) atomicMax(&a.stats[0], my_steps);
    if (my_unf > 0) atomicAdd(&a.stats[1], my_unf);
  }
}

// the walkers the walk left marked at its limit (elem_out = -2 - tet):
// accepted on their tet at the nudged projection, else deleted
__global__ void __launch_bounds__(M_THREADS) recover_kernel(TraceArgs a) {
  int my_unf = 0, my_rec = 0;
  for (int i = blockIdx.x * M_THREADS + threadIdx.x; i < a.n; i += gridDim.x * M_THREADS) {
    const int m = a.elem_out[i];
    if (m > -2) continue;
    const int e = -2 - m;
    float d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = a.dest_out[3 * (size_t)i + c];
    if (recover(e, d, a.elem2verts, a.coords)) {
      a.elem_out[i] = e;
      a.active_out[i] = 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) a.dest_out[3 * (size_t)i + c] = d[c];
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
template <int CORE, bool REFLECT, bool RECORD>
static int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, trace_3d_kernel<CORE, REFLECT, RECORD>, M_THREADS, 0);
    if (blocks <= 0) blocks = 1;
  }
  return blocks;
}

template <int CORE, bool REFLECT, bool RECORD>
static int launch(const TraceArgs& a, bool query, cudaStream_t stream) {
  const int per_sm = resident_blocks<CORE, REFLECT, RECORD>();
  if (query) return per_sm;
  long long blocks = ((long long)a.n + M_THREADS - 1) / M_THREADS;
  const long long wave = (long long)num_sms() * per_sm;
  if (blocks > wave) blocks = wave;
  trace_3d_kernel<CORE, REFLECT, RECORD><<<(unsigned)blocks, M_THREADS, 0, stream>>>(a);
  return 0;
}

template <int CORE>
static int launch_core(const TraceArgs& a, int reflect, int record, bool query,
                       cudaStream_t stream) {
  if (reflect && record) return launch<CORE, true, true>(a, query, stream);
  if (reflect) return launch<CORE, true, false>(a, query, stream);
  if (record) return launch<CORE, false, true>(a, query, stream);
  return launch<CORE, false, false>(a, query, stream);
}

static int dispatch(const TraceArgs& a, int core, int reflect, int record, bool query,
                    cudaStream_t stream) {
  if (core == CORE_BCC) return launch_core<CORE_BCC>(a, reflect, record, query, stream);
  if (core == CORE_HYBRID)
    return launch_core<CORE_HYBRID>(a, reflect, record, query, stream);
  return launch_core<CORE_MT>(a, reflect, record, query, stream);
}

// resident blocks per SM of the template (core, reflect, record)
extern "C" int pp_trace_3d_blocks_per_sm(int core, int reflect, int record) {
  if (core < CORE_BCC || core > CORE_MT) return 0;
  return dispatch(TraceArgs{}, core, reflect, record, true, nullptr);
}

// orig, dest: (n, 3) f32 (orig read by the hybrid and intersection cores and
// where a crossing point is needed); table: walk_geom (n_elems, 16) for the
// bcc and hybrid cores, walk_planes (n_elems, 20) for mt, 16-byte aligned;
// geom: walk_geom (the peel's rows); normals: (n_faces, 8) f32, 16-byte
// aligned, each face's unit normal and first vertex (read with reflect);
// cell_ids: (nx*ny*nz, 2) i32 candidate pairs or nullptr; oh: the grid's
// origin[3] and inv_h[3].  dest_out (nullable; not with recover),
// exit_side, num_hits, hit_out (with record) are written for every
// particle.  stats[0..2] <- max steps, walkers deleted at the limit,
// walkers recovered; the caller zeroes them.  n < 2^30.
extern "C" int pp_trace_3d(
    const float* orig, const float* dest, const int* elem_start, const uint8_t* active,
    const float* table, const float* geom, const int* elem2faces, const float* normals,
    const float* coords, const int* elem2verts, int n_elems, const int* cell_ids,
    const float* oh, int nx, int ny, int nz, int max_iters, int it0, int core,
    int reflect, int record, int recover, int* elem_out, uint8_t* active_out,
    float* dest_out, int* exit_side, int* num_hits, float* hit_out, int* stats,
    long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n >= (1LL << 30) || core < CORE_BCC || core > CORE_MT ||
      (recover && dest_out == nullptr))
    return (int)cudaErrorInvalidValue;
  TraceArgs a{orig, dest, elem_start, active, table, geom, elem2faces,
              reinterpret_cast<const float4*>(normals), coords, elem2verts, n_elems,
              reinterpret_cast<const int2*>(cell_ids), Grid3{},
              max_iters > it0 ? max_iters - it0 : 0, recover, elem_out, active_out,
              dest_out, exit_side, num_hits, hit_out, stats, (int)n};
  for (int j = 0; j < 3; ++j) {
    a.grid.origin[j] = oh[j];
    a.grid.inv_h[j] = oh[3 + j];
  }
  a.grid.n[0] = nx;
  a.grid.n[1] = ny;
  a.grid.n[2] = nz;
  dispatch(a, core, reflect, record, false, stream);
  if (recover) {
    long long blocks = (n + M_THREADS - 1) / M_THREADS;
    if (blocks > (long long)num_sms() * 16) blocks = (long long)num_sms() * 16;
    recover_kernel<<<(unsigned)blocks, M_THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
