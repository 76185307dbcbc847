// Kernel R: trilinear E from a uniform 3D grid, fused with the Boris push.
//
// Replaces (JAX reference): the GITR-style app's field and push,
// interpolate_3d_grid (pumipic_tpu/ops/interpolate.py:65-101) followed by
// boris_push (pumipic_tpu/ops/push.py:213-241), as GitrLike's step runs them
// (pumipic_tpu/models/gitr_like.py:103-110) with a uniform B (queue item
// K15).  The TPU ran both as XLA-fused elementwise code; no Pallas kernel.
//
// What bounds it on an H100: device-memory traffic.  Per particle 24 bytes
// in (x, v) and 24 out (x', v'), 480 MB at 10M, 0.143 ms at 3.35 TB/s; the
// field stays in L2.  About 120 f32 operations a particle, far below the
// card's f32 rate.
//
// Design (scripts/ab_boris_trace3d.py's probes of the first R, one thread a
// particle reading the (nx, ny, nz, 3) grid's 8 corners as 24 scalar loads
// and x, v one component an instruction: the corner rows alone took it from
// 0.49 to 0.30 ms, x and v staged through shared memory alone gained
// nothing; PERF.md):
// - The corners as whole rows: a cell-major table (grid_corner_rows), one
//   128-byte row a cell holding its 8 corners x 3 components in the order
//   the sum takes them (di, dj, dk; x, y, z), 24 floats and 8 of padding
//   (4.2 MB at 32^3 cells, in L2), in place of 24 scalar gathers at
//   unrelated cells.
// - The warp loads its 32 rows together: each lane reads 16-byte parts of
//   its neighbours' rows, so a load instruction touches about 6 rows' lines
//   in place of 32 (the gather is bound by the lines each load touches,
//   not by the bytes), and the parts meet in shared memory.
// - Per-launch constants from the host: the coefficient 2q'/(1 + (q'|B|)²)
//   in numpy f32 scalars, each operation rounded once as the plain
//   version's tensors round it.
// The arithmetic is the plain version's, in its order: rel = (x - origin)
// / spacing as an IEEE division, the floored index clamped to [0, n - 2],
// the fraction clamped to [0, 1] (NaN stays NaN, as torch.clamp), the eight
// corners summed from 0.0 in the order di, dj, dk with each weight a
// left-to-right product; then the Boris steps with jnp.cross's component
// formula.  q' and dt come rounded to f32 from the host (the JAX package's
// weak-typed Python floats round them so).  Built with -fmad=false, so each
// product and sum rounds as the plain version's separate ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define R_THREADS 256
#define R_ROW4 7                      // float4s between two rows in shared memory
#define FULL_MASK 0xffffffffu

struct BorisParams {
  float origin[3], spacing[3], b[3];
  float qp, coeff, dt;
};

__device__ __forceinline__ float clamp01(float t) {
  return t != t ? t : fminf(fmaxf(t, 0.0f), 1.0f);
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__global__ void __launch_bounds__(R_THREADS) boris_grid_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float4* __restrict__ corners, int nx, int ny, int nz, BorisParams p,
    float* __restrict__ x_out, float* __restrict__ v_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xi[3] = {0.0f, 0.0f, 0.0f}, vi[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xi[c] = x[3 * i + c];
      vi[c] = v[3 * i + c];
    }
  }
  // the cell and fractions on each axis
  const int nn[3] = {nx, ny, nz};
  int idx[3];
  float f[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rel = (xi[c] - p.origin[c]) / p.spacing[c];
    idx[c] = min(max((int)floorf(rel), 0), nn[c] - 2);
    f[c] = clamp01(rel - (float)idx[c]);
  }
  // the cell's row: corner m = 4 di + 2 dj + dk at floats 3m .. 3m + 2
  const int cell = live ? (idx[0] * (ny - 1) + idx[1]) * (nz - 1) + idx[2] : -1;
  float g[24];
  // the warp's 32 rows: load j's lane reads 16-byte part (32 j + lane) of
  // the rows laid end to end (about 6 rows' lines a load, in place of 32),
  // and the parts meet in the warp's shared rows (an odd stride of R_ROW4
  // float4s: no bank conflict)
  __shared__ float4 rows[R_THREADS / 32][32 * R_ROW4];
  float4* wr = rows[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int c = 32 * j + lane, r = c / 6, part = c - 6 * r;
    const int cr = __shfl_sync(FULL_MASK, cell, r);
    if (cr >= 0) wr[R_ROW4 * r + part] = __ldg(corners + 8 * (size_t)cr + part);
  }
  __syncwarp();
  if (!live) return;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float4 q = wr[R_ROW4 * lane + j];
    g[4 * j] = q.x;
    g[4 * j + 1] = q.y;
    g[4 * j + 2] = q.z;
    g[4 * j + 3] = q.w;
  }
  float e[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int di = m >> 2, dj = (m >> 1) & 1, dk = m & 1;
    const float w = (di ? f[0] : 1.0f - f[0]) * (dj ? f[1] : 1.0f - f[1]) *
                    (dk ? f[2] : 1.0f - f[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) e[c] = e[c] + g[3 * m + c] * w;
  }
  // Boris: v- = v - q'E; v' = v- + q'(v- x B); v+ = v- + coeff(v' x B) + q'E
  float qe[3], vm[3], vp[3], cr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    qe[c] = p.qp * e[c];
    vm[c] = vi[c] - qe[c];
  }
  cross3(vm, p.b, cr);
#pragma unroll
  for (int c = 0; c < 3; ++c) vp[c] = vm[c] + p.qp * cr[c];
  cross3(vp, p.b, cr);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float vn = vm[c] + p.coeff * cr[c] + qe[c];
    v_out[3 * i + c] = vn;
    x_out[3 * i + c] = xi[c] + vn * p.dt;
  }
}

// x, v, x_out, v_out: (n, 3) f32; corners: the grid's cell-major corner rows,
// ((nx-1)(ny-1)(nz-1), 32) f32, 16-byte aligned, every n >= 2; params
// (host): origin[3], spacing[3], b[3], q', 2q', dt, coeff = 2q'/(1 + (q'|B|)²)
// as f32
extern "C" int pp_boris_grid(const float* x, const float* v, const float* corners,
                             int nx, int ny, int nz, const float* params,
                             float* x_out, float* v_out, long long n,
                             cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (nx < 2 || ny < 2 || nz < 2 || (reinterpret_cast<uintptr_t>(corners) & 15))
    return (int)cudaErrorInvalidValue;
  BorisParams p;
  for (int c = 0; c < 3; ++c) {
    p.origin[c] = params[c];
    p.spacing[c] = params[3 + c];
    p.b[c] = params[6 + c];
  }
  p.qp = params[9];
  p.dt = params[11];
  p.coeff = params[12];
  const long long blocks = (n + R_THREADS - 1) / R_THREADS;
  boris_grid_kernel<<<(unsigned)blocks, R_THREADS, 0, stream>>>(
      x, v, reinterpret_cast<const float4*>(corners), nx, ny, nz, p, x_out, v_out, n);
  return (int)cudaGetLastError();
}
