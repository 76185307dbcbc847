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
// (33, 33, 33, 3) f32 grid (431 KB) stays in L1/L2, and its 8 corner loads
// of 12 bytes are L2 hits.  About 120 f32 operations a particle, far below
// the card's f32 rate.
//
// Design: one thread per particle, no shared memory.  The arithmetic is the
// plain version's, in its order: rel = (x - origin) / spacing as an IEEE
// division, the floored index clamped to [0, n - 2], the fraction clamped to
// [0, 1] (NaN stays NaN, as torch.clamp), the eight corners summed from 0.0
// in the order di, dj, dk with each weight a left-to-right product; then
// |B| = sqrt(b0² + b1² + b2²), coeff = 2q' / (1 + (q'|B|)²) and the Boris
// steps with jnp.cross's component formula.  q', 2q' and dt come rounded to
// f32 from the host (the JAX package's weak-typed Python floats round them
// so).  Built with -fmad=false, so each product and sum rounds as the plain
// version's separate ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define R_THREADS 256

struct BorisParams {
  float origin[3], spacing[3], b[3];
  float qp, two_qp, dt;
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
    const float* __restrict__ grid, int nx, int ny, int nz, BorisParams p,
    float* __restrict__ x_out, float* __restrict__ v_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float xi[3], vi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xi[c] = x[3 * i + c];
    vi[c] = v[3 * i + c];
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
  float e[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int di = 0; di < 2; ++di)
#pragma unroll
    for (int dj = 0; dj < 2; ++dj)
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const float w = (di ? f[0] : 1.0f - f[0]) * (dj ? f[1] : 1.0f - f[1]) *
                        (dk ? f[2] : 1.0f - f[2]);
        const float* g = grid + 3 * ((size_t)((idx[0] + di) * ny + idx[1] + dj) * nz +
                                     idx[2] + dk);
#pragma unroll
        for (int c = 0; c < 3; ++c) e[c] = e[c] + __ldg(g + c) * w;
      }
  // Boris: v- = v - q'E; v' = v- + q'(v- x B); v+ = v- + coeff(v' x B) + q'E
  const float b_mag = sqrtf(p.b[0] * p.b[0] + p.b[1] * p.b[1] + p.b[2] * p.b[2]);
  const float s = p.qp * b_mag;
  const float coeff = p.two_qp / (1.0f + s * s);
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
    const float vn = vm[c] + coeff * cr[c] + qe[c];
    v_out[3 * i + c] = vn;
    x_out[3 * i + c] = xi[c] + vn * p.dt;
  }
}

// x, v, x_out, v_out: (n, 3) f32; grid: (nx, ny, nz, 3) f32, every n >= 2;
// params (host): origin[3], spacing[3], b[3], q', 2q', dt as f32
extern "C" int pp_boris_grid(const float* x, const float* v, const float* grid,
                             int nx, int ny, int nz, const float* params,
                             float* x_out, float* v_out, long long n,
                             cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (nx < 2 || ny < 2 || nz < 2) return (int)cudaErrorInvalidValue;
  BorisParams p;
  for (int c = 0; c < 3; ++c) {
    p.origin[c] = params[c];
    p.spacing[c] = params[3 + c];
    p.b[c] = params[6 + c];
  }
  p.qp = params[9];
  p.two_qp = params[10];
  p.dt = params[11];
  const long long blocks = (n + R_THREADS - 1) / R_THREADS;
  boris_grid_kernel<<<(unsigned)blocks, R_THREADS, 0, stream>>>(x, v, grid, nx, ny, nz,
                                                                 p, x_out, v_out, n);
  return (int)cudaGetLastError();
}
