// Kernel F: the GITR-style step's specular velocity and state update.
//
// Replaces (JAX reference): GitrLike's step between the walk and the wall
// tally, pumipic_tpu/models/gitr_like.py:119-141 (queue item K15's glue):
// the specular velocity |v'|·(dest - hit)/|dest - hit| of each particle
// that bounced, the lost mask, and the new position, velocity and
// activity.  The TPU ran it as XLA-fused elementwise code; no Pallas
// kernel.  The port ran it as a dozen strided (N, 3) torch passes.
//
// What bounds it on an H100: device-memory traffic.  Per particle 69 bytes
// in (x, v, v', dest, hit as 3 f32 each, the element and hit count as
// i32, the active flag) and 26 out (x and v, active and lost), 0.95 GB at
// 10M, 0.28 ms at 3.35 TB/s; about 25 f32 operations a particle.
//
// Design: one thread a particle, each (N, 3) row read as three scalar loads
// (a warp's three loads cover the same 384 contiguous bytes, so L1 serves
// two of them) and written as three stores.  absorb mode reads neither hit
// nor num_hits.
//
// The arithmetic is the plain version's (gitr_update_plain), in its order:
// leg = dest - hit; |leg| the squares summed left to right and an IEEE
// sqrtf (equal to the f64-then-rounded sqrt of ops/geometry.sqrt_rn);
// bounced = active & elem >= 0 & num_hits > 0 & |leg| > tiny, where tiny
// is the f32 rounding of 1e-30 (torch and JAX compare an f32 tensor with a
// Python scalar in f32); then (|v'|·leg_c) / max(|leg|, tiny), which is
// (|v'|·leg_c) / |leg| wherever it is used.  Built with -fmad=false, so
// each product and sum rounds as the plain version's separate ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define F_THREADS 256

namespace {

__device__ __forceinline__ float norm3(float a, float b, float c) {
  return sqrtf(a * a + b * b + c * c);
}

__global__ void __launch_bounds__(F_THREADS) gitr_update_kernel(
    const float* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ v_new, const float* __restrict__ dest,
    const float* __restrict__ hit, const int* __restrict__ elem,
    const int* __restrict__ num_hits, const uint8_t* __restrict__ active,
    int reflect, float tiny, float* __restrict__ x_out,
    float* __restrict__ v_out, uint8_t* __restrict__ active_out,
    uint8_t* __restrict__ lost_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool act = active[i] != 0;
  const int e = elem[i];
  const bool lost = act && e < 0;
  float d[3], vn[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] = dest[3 * i + c];
    vn[c] = v_new[3 * i + c];
  }
  if (reflect && act && e >= 0 && num_hits[i] > 0) {
    float leg[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) leg[c] = d[c] - hit[3 * i + c];
    const float ln = norm3(leg[0], leg[1], leg[2]);
    if (ln > tiny) {                      // bounced
      const float vm = norm3(vn[0], vn[1], vn[2]);
#pragma unroll
      for (int c = 0; c < 3; ++c) vn[c] = (vm * leg[c]) / ln;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x_out[3 * i + c] = lost ? x[3 * i + c] : d[c];
    v_out[3 * i + c] = act ? vn[c] : v[3 * i + c];
  }
  active_out[i] = act && e >= 0;
  lost_out[i] = lost;
}

}  // namespace

extern "C" int pp_gitr_update(const float* x, const float* v, const float* v_new,
                              const float* dest, const float* hit, const int* elem,
                              const int* num_hits, const uint8_t* active, int reflect,
                              float tiny, float* x_out, float* v_out,
                              uint8_t* active_out, uint8_t* lost_out, long long n,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + F_THREADS - 1) / F_THREADS;
  gitr_update_kernel<<<(unsigned)blocks, F_THREADS, 0, stream>>>(
      x, v, v_new, dest, hit, elem, num_hits, active, reflect, tiny, x_out, v_out,
      active_out, lost_out, n);
  return (int)cudaGetLastError();
}
