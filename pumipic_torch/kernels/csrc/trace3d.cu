// Kernel M: the 3D walk with its cores, boundary handlers, exit records and
// stranded-walker recovery, one thread per particle, the whole walk inside.
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
// What bounds it on an H100: the latency of each walker's chain of dependent
// row loads (one 64- or 80-byte row per step from a table that stays in L2,
// 12.6 MB walk_geom or 15.7 MB walk_planes at 196,608 tets), and the
// imbalance of walks of different lengths inside a warp.  The bytes it must
// move are the streamed particle arrays: 12 bytes of destination, 12 of
// origin (the hybrid and intersection cores and every walk that needs the
// crossing point), 5 of start tet and mask in, 5 of tet and mask out, 12 of
// destination out where the walk moves it (reflect, recover) and 20 of exit
// record with record_exit.
//
// Design: a simple kernel that is right first.  One thread per particle
// walks until its tet contains the destination, it leaves the domain
// (remove), or its budget is spent; a walker that crosses an exposed face
// with reflect takes the mirrored destination, restarts its segment at the
// crossing point and goes on in its tet.  Templated over the core, the
// handler and record_exit; the peel (cell_ids != nullptr) and recovery are
// run-time branches.  The peel is kernel L3's: the cell's candidate pair,
// the BCC test of A's then B's walk_geom row; a particle neither contains
// walks from A on a guess trajectory whose boundary hit retries once from
// the true start and is never a real hit.  Recovery runs at the loop limit
// on the walker's own tet: the four faces' closest points, the containment
// determinants, the nudge toward the centroid.  Every expression follows
// the plain PyTorch version's order (sums left to right) and the build's
// -fmad=false keeps each product and sum rounded on its own, so the kernel
// equals trace_3d_plain bit for bit; a contracted a*b+c moves which tet
// wins at a shared face and, in the hybrid core, turns a stationary
// walker's zero rate into sign noise.  min/max/clamp propagate NaN as
// torch's do.  A later PR makes it fast (walker compaction as in L3).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BCC_REL_TOL 4.76837158203125e-07f  // 8 * 2^-24
#define BCC_ABS_TOL 1e-7f
#define MT_TOL 1e-6f
#define RECOVER_TOL2 ((float)(1e-3 * 1e-3))
#define RECOVER_NUDGE 1e-5f
#define M_THREADS 128

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

// the first n4 float4s of row e of a table of `width` floats a row
// (16-byte aligned rows: width 16 or 20)
template <int n4, int width>
__device__ __forceinline__ void load_row(const float* table, int e, float* g) {
  const float4* g4 = reinterpret_cast<const float4*>(table + (size_t)e * width);
#pragma unroll
  for (int j = 0; j < n4; ++j) {
    const float4 v = __ldg(g4 + j);
    g[4 * j] = v.x;
    g[4 * j + 1] = v.y;
    g[4 * j + 2] = v.z;
    g[4 * j + 3] = v.w;
  }
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

// _core_3d_bcc on a walk_geom row
template <bool NEED_T>
__device__ __forceinline__ CoreOut core_bcc(const float* g, const float* d, const float* o) {
  const Bary3 w = bary3(g, d[0], d[1], d[2]);
  float wmin;
  CoreOut r{w.inside, most_negative(w, &wmin), 0.0f};
  if (NEED_T) {
    const float l1o = affine(g, o[0], o[1], o[2]);
    const float l2o = affine(g + 4, o[0], o[1], o[2]);
    const float l3o = affine(g + 8, o[0], o[1], o[2]);
    const float w0o = 1.0f - l1o - l2o - l3o;
    const float wo = r.k == 0 ? w0o : r.k == 1 ? l1o : r.k == 2 ? l2o : l3o;
    const float den = wo - wmin;
    r.t = wo / (den == 0.0f ? 1.0f : den);
  }
  return r;
}

// _core_3d_hybrid on a walk_geom row: the earliest crossing among the
// faces whose weight falls (rate = the directional derivative -A_k·v),
// else the BCC choice
__device__ __forceinline__ CoreOut core_hybrid(const float* g, const float* d,
                                               const float* o) {
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

// _core_3d_mt on a walk_planes row [n_x n_y n_z off] x 4 | nbr x 4
__device__ __forceinline__ CoreOut core_mt(const float* g, const float* d, const float* o) {
  const float vx = d[0] - o[0], vy = d[1] - o[1], vz = d[2] - o[2];
  bool inside = true;
  float t_exit = INFINITY, viol_best = -INFINITY;
  int k_exit = 0, k_viol = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float nx = g[4 * i], ny = g[4 * i + 1], nz = g[4 * i + 2], off = g[4 * i + 3];
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
__device__ void closest_point(const float* p, const float* a, const float* b,
                              const float* c, float* res) {
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
    for (int j = 0; j < 3; ++j) res[j] = b[j] + t_bc * cb[j];
  }
  const float t_ac = clamp01(d2 / safe(d2 - d6));
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
    for (int j = 0; j < 3; ++j) res[j] = a[j] + t_ac * ac[j];
  }
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
    for (int j = 0; j < 3; ++j) res[j] = a[j] + t_ab * ab[j];
  }
  if (d6 >= 0.0f && d5 <= d6) {
    for (int j = 0; j < 3; ++j) res[j] = c[j];
  }
  if (d3 >= 0.0f && d4 <= d3) {
    for (int j = 0; j < 3; ++j) res[j] = b[j];
  }
  if (d1 <= 0.0f && d2 <= 0.0f) {
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
// accepted on tet e
__device__ bool recover(int e, float* dest, const int* __restrict__ elem2verts,
                        const float* __restrict__ coords) {
  float vs[4][3];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int vid = elem2verts[4 * (size_t)e + m];
#pragma unroll
    for (int j = 0; j < 3; ++j) vs[m][j] = coords[3 * (size_t)vid + j];
  }
  const int faces[4][3] = {{1, 2, 3}, {0, 2, 3}, {0, 1, 3}, {0, 1, 2}};
  float best[3], d2 = 0.0f;
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
  bool contained = true;
  for (int k = 0; k < 4; ++k) {
    const float* r[4];
    for (int m = 0; m < 4; ++m) r[m] = m == k ? dest : vs[m];
    contained = contained && (det_rows(r[0], r[1], r[2], r[3]) * sgn >= -tolv);
  }
  if (contained) {
    d2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) best[j] = dest[j];
  }
  float scale2 = 0.0f;
  for (int i = 0; i < 4; ++i)
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
  const int* face2verts;
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
  long long n;
};

template <int CORE, bool REFLECT, bool RECORD>
__global__ void __launch_bounds__(M_THREADS) trace_3d_kernel(TraceArgs a) {
  constexpr bool NEED_HIT = REFLECT || RECORD;
  constexpr bool NEED_ORIG = NEED_HIT || CORE != CORE_BCC;
  constexpr int WIDTH = CORE == CORE_MT ? 20 : 16;   // row floats
  constexpr int NB = CORE == CORE_MT ? 16 : 12;      // neighbour column
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int my_steps = 0, my_unf = 0, my_rec = 0;
  if (i < a.n) {
    float d[3], o[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d[c] = a.dest[3 * i + c];
      o[c] = NEED_ORIG ? a.orig[3 * i + c] : d[c];
    }
    int elem = -1, fbg = -2, side_rec = -1, nhits = 0;
    float hit_rec[3] = {d[0], d[1], d[2]};
    if (a.active[i]) {
      const int start = min(max(a.elem_start[i], 0), a.n_elems - 1);
      elem = start;
      bool done = false;
      if (a.cell_ids != nullptr) {      // the peel: candidate A, then B
        const int2 ab = __ldg(a.cell_ids + cell_of(a.grid, d[0], d[1], d[2]));
        float g[12];
        load_row<3, 16>(a.geom, ab.x, g);
        elem = ab.x;
        done = bary3(g, d[0], d[1], d[2]).inside;
        if (!done) {
          load_row<3, 16>(a.geom, ab.y, g);
          if (bary3(g, d[0], d[1], d[2]).inside) {
            elem = ab.y;
            done = true;
          } else {
            fbg = start;                // a guess walk from A
          }
        }
      }
      int steps = 0;
      while (!done && steps < a.budget) {
        ++steps;
        float g[WIDTH];
        load_row<WIDTH / 4, WIDTH>(a.table, elem, g);
        CoreOut c;
        if constexpr (CORE == CORE_BCC)
          c = core_bcc<NEED_HIT>(g, d, o);
        else if constexpr (CORE == CORE_HYBRID)
          c = core_hybrid(g, d, o);
        else
          c = core_mt(g, d, o);
        if (c.inside) {
          done = true;
          break;
        }
        const int nxt = (int)g[NB + c.k];
        if (nxt != -1) {                // an interior face: cross it
          elem = nxt;
          continue;
        }
        if (fbg >= 0) {                 // a guess walk's boundary: retry
          elem = fbg;
          fbg = -2;
          continue;
        }
        // a real boundary hit
        float hit[3];
        if (NEED_HIT) {
          const float tc = clamp01(c.t);
#pragma unroll
          for (int j = 0; j < 3; ++j) hit[j] = o[j] + tc * (d[j] - o[j]);
        }
        if (RECORD) {
          side_rec = a.elem2faces[4 * (size_t)elem + c.k];
          ++nhits;
#pragma unroll
          for (int j = 0; j < 3; ++j) hit_rec[j] = hit[j];
        }
        if (REFLECT) {                  // mirror dest; the segment restarts at the wall
          const int side = max(a.elem2faces[4 * (size_t)elem + c.k], 0);
          float p[3][3];
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            const int vid = a.face2verts[3 * (size_t)side + m];
#pragma unroll
            for (int j = 0; j < 3; ++j) p[m][j] = a.coords[3 * (size_t)vid + j];
          }
          const float ux = p[1][0] - p[0][0], uy = p[1][1] - p[0][1], uz = p[1][2] - p[0][2];
          const float vx = p[2][0] - p[0][0], vy = p[2][1] - p[0][1], vz = p[2][2] - p[0][2];
          float nx = uy * vz - uz * vy;
          float ny = uz * vx - ux * vz;
          float nz = ux * vy - uy * vx;
          const float len = sqrtf(nx * nx + ny * ny + nz * nz);
          const float inv = 1.0f / (len != len ? len : fmaxf(len, 1e-30f));
          nx = nx * inv;
          ny = ny * inv;
          nz = nz * inv;
          const float s = (d[0] - p[0][0]) * nx + (d[1] - p[0][1]) * ny + (d[2] - p[0][2]) * nz;
          d[0] = d[0] - 2.0f * s * nx;
          d[1] = d[1] - 2.0f * s * ny;
          d[2] = d[2] - 2.0f * s * nz;
#pragma unroll
          for (int j = 0; j < 3; ++j) o[j] = hit[j];
        } else {                        // remove
          elem = -1;
          done = true;
        }
      }
      my_steps = steps;
      if (!done && a.recover && elem >= 0 && recover(elem, d, a.elem2verts, a.coords)) {
        done = true;
        my_rec = 1;
      }
      if (!done) {
        elem = -1;
        my_unf = 1;
      }
    }
    a.elem_out[i] = elem;
    a.active_out[i] = elem >= 0 ? 1 : 0;
    if (a.dest_out != nullptr) {
      for (int c = 0; c < 3; ++c) a.dest_out[3 * i + c] = d[c];
    }
    if (RECORD) {
      a.exit_side[i] = side_rec;
      a.num_hits[i] = nhits;
#pragma unroll
      for (int c = 0; c < 3; ++c) a.hit_out[3 * i + c] = hit_rec[c];
    }
  }
  // one atomic per warp and statistic
  my_steps = __reduce_max_sync(0xffffffffu, my_steps);
  my_unf = __reduce_add_sync(0xffffffffu, my_unf);
  my_rec = __reduce_add_sync(0xffffffffu, my_rec);
  if ((threadIdx.x & 31) == 0) {
    if (my_steps > 0) atomicMax(&a.stats[0], my_steps);
    if (my_unf > 0) atomicAdd(&a.stats[1], my_unf);
    if (my_rec > 0) atomicAdd(&a.stats[2], my_rec);
  }
}

template <int CORE>
static void launch_core(const TraceArgs& a, int reflect, int record, unsigned blocks,
                        cudaStream_t stream) {
  if (reflect && record)
    trace_3d_kernel<CORE, true, true><<<blocks, M_THREADS, 0, stream>>>(a);
  else if (reflect)
    trace_3d_kernel<CORE, true, false><<<blocks, M_THREADS, 0, stream>>>(a);
  else if (record)
    trace_3d_kernel<CORE, false, true><<<blocks, M_THREADS, 0, stream>>>(a);
  else
    trace_3d_kernel<CORE, false, false><<<blocks, M_THREADS, 0, stream>>>(a);
}

// orig, dest: (n, 3) f32 (orig read by the hybrid and intersection cores and
// where a crossing point is needed); table: walk_geom (n_elems, 16) for the
// bcc and hybrid cores, walk_planes (n_elems, 20) for mt, 16-byte aligned;
// geom: walk_geom (the peel's rows); cell_ids: (nx*ny*nz, 2) i32 candidate
// pairs or nullptr; oh: the grid's origin[3] and inv_h[3].  dest_out
// (nullable), exit_side, num_hits, hit_out (with record) are written for
// every particle.  stats[0..2] <- max steps, walkers deleted at the limit,
// walkers recovered; the caller zeroes them.  n < 2^31.
extern "C" int pp_trace_3d(
    const float* orig, const float* dest, const int* elem_start, const uint8_t* active,
    const float* table, const float* geom, const int* elem2faces, const int* face2verts,
    const float* coords, const int* elem2verts, int n_elems, const int* cell_ids,
    const float* oh, int nx, int ny, int nz, int max_iters, int it0, int core,
    int reflect, int record, int recover, int* elem_out, uint8_t* active_out,
    float* dest_out, int* exit_side, int* num_hits, float* hit_out, int* stats,
    long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n >= (1LL << 31) || core < CORE_BCC || core > CORE_MT) return (int)cudaErrorInvalidValue;
  TraceArgs a{orig, dest, elem_start, active, table, geom, elem2faces, face2verts, coords,
              elem2verts, n_elems, reinterpret_cast<const int2*>(cell_ids), Grid3{},
              max_iters > it0 ? max_iters - it0 : 0, recover, elem_out, active_out,
              dest_out, exit_side, num_hits, hit_out, stats, n};
  for (int j = 0; j < 3; ++j) {
    a.grid.origin[j] = oh[j];
    a.grid.inv_h[j] = oh[3 + j];
  }
  a.grid.n[0] = nx;
  a.grid.n[1] = ny;
  a.grid.n[2] = nz;
  const unsigned blocks = (unsigned)((n + M_THREADS - 1) / M_THREADS);
  if (core == CORE_BCC)
    launch_core<CORE_BCC>(a, reflect, record, blocks, stream);
  else if (core == CORE_HYBRID)
    launch_core<CORE_HYBRID>(a, reflect, record, blocks, stream);
  else
    launch_core<CORE_MT>(a, reflect, record, blocks, stream);
  return (int)cudaGetLastError();
}
