// Kernel A: structured-annulus analytic locate + the DPS rewrite, one
// thread per particle.
//
// Replaces (JAX reference): AnnulusLocator2D.locate_parts
// (pumipic_tpu/mesh/locator.py:379-429) and the FULL-mode step's masking
// of its result (pumipic_tpu/models/pseudo_xgcm.py:641-646, 658): elem =
// active ? locate(dest) : INVALID, active' = elem >= 0.  On a proven
// annulus this is the whole search: no table, no walk, iters = 0.
//
// What bounds it on an H100: the seven f32 transcendentals per particle
// (atan2f, and cosf/sinf of the bisector and of the two diagonal rays),
// a few dozen other operations; memory is 9 bytes in and 5 out per
// particle (140 MB at 10M).  The optional perm gather reads one int from a
// 96 KB table that stays in L1/L2.
//
// Design: the per-mesh f32 scalars (2π, the sector angle dth, cos(dth/2),
// the inside bounds) are computed once on the host with f32 torch ops in
// the JAX package's order and passed in, and the plain version reads the
// same values, so only per-particle math runs here.  The per-particle
// atan2f/cosf/sinf are CUDA's libm, which torch's CUDA ops also call, and
// the build uses -fmad=false, so the result equals the plain PyTorch
// version's on the card.  Inactive particles skip the math (their output
// is INVALID either way).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void annulus_locate_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const uint8_t* __restrict__ active, long long n, float cx, float cy,
    float theta0, float two_pi, float dth, float m, float r_in, float dr,
    float lo, float hi, int n_rings, int n_sectors,
    const int* __restrict__ perm, int* __restrict__ elem_out,
    uint8_t* __restrict__ active_out) {
  const float s_f = (float)n_sectors;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int elem = -1;
    if (active[i]) {
      const float x = px[i] - cx;
      const float y = py[i] - cy;
      float th = atan2f(y, x) - theta0;
      if (th < 0.0f) th = th + two_pi;
      if (th < 0.0f) th = th + two_pi;
      const float kf = clampf(floorf(th / dth), 0.0f, s_f - 1.0f);
      // wedge-bisector projection: exact ring floor, chord-exact bounds
      const float phi = theta0 + (kf + 0.5f) * dth;
      const float r_eff = (x * cosf(phi) + y * sinf(phi)) / m;
      const bool inside = (r_eff >= lo) && (r_eff <= hi);
      const float rf = clampf(floorf((r_eff - r_in) / dr), 0.0f,
                              (float)n_rings - 1.0f);
      // quad diagonal a -> d: cross >= 0 is triangle [a, b, d] (+0)
      const float ra = r_in + rf * dr;
      const float rd = ra + dr;
      const float tha = theta0 + kf * dth;
      const float thd = tha + dth;
      const float ax = ra * cosf(tha);
      const float ay = ra * sinf(tha);
      const float ddx = rd * cosf(thd) - ax;
      const float ddy = rd * sinf(thd) - ay;
      const float cross = ddx * (y - ay) - ddy * (x - ax);
      const float trif = cross >= 0.0f ? 0.0f : 1.0f;
      if (inside) {
        elem = (int)((rf * s_f + kf) * 2.0f + trif);
        if (perm != nullptr) elem = perm[elem];
      }
    }
    elem_out[i] = elem;
    active_out[i] = elem >= 0 ? 1 : 0;
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

// perm: (2·n_rings·n_sectors,) canonical -> actual element id, or nullptr
extern "C" int pp_annulus_locate(
    const float* px, const float* py, const uint8_t* active, long long n,
    float cx, float cy, float theta0, float two_pi, float dth, float m,
    float r_in, float dr, float lo, float hi, int n_rings, int n_sectors,
    const int* perm, int* elem_out, uint8_t* active_out,
    cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  annulus_locate_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      px, py, active, n, cx, cy, theta0, two_pi, dth, m, r_in, dr, lo, hi,
      n_rings, n_sectors, perm, elem_out, active_out);
  return (int)cudaGetLastError();
}
