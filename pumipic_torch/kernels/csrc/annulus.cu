// Kernel A: structured-annulus analytic locate + the DPS rewrite, four
// particles a thread, the sector's trigonometry from a table.
//
// Replaces (JAX reference): AnnulusLocator2D.locate_parts
// (pumipic_tpu/mesh/locator.py:379-429) and the FULL-mode step's masking
// of its result (pumipic_tpu/models/pseudo_xgcm.py:641-646, 658): elem =
// active ? locate(dest) : INVALID, active' = elem >= 0.  On a proven
// annulus this is the whole search: no walk, iters = 0.
//
// What bounds it on an H100: device-memory bytes.  Per particle 9 bytes in
// and 5 out (140 MB at 10M, 0.042 ms at 3.35 TB/s) against one atan2f,
// three IEEE divisions and a few dozen other operations.  The optional
// perm gather reads one int from a 96 KB table that stays in L1/L2.  The
// kernel's own stream, ~186 SASS instructions a particle (the bit-exact
// atan2f and divisions with their special-case branches), takes 0.056 ms
// at 10M at the card's issue rate, above the byte bound.
//
// Design: six of the seven f32 libm calls per particle of the plain
// version (cos and sin of the bisector phi and of the two diagonal rays
// tha, thd) depend only on the clamped sector index kf, one of n_sectors
// values.  AnnulusLocator2D.sector_table computes them once per locator
// and device with torch's f32 ops in the plain version's order; torch's
// CUDA cos/sin are CUDA's libm, so a row equals the per-particle values
// bit for bit.  Each block stages the (n_sectors, 6) table in shared
// memory (24 bytes a sector) and walks the particles grid-stride on a grid
// of one wave, four consecutive particles a thread: 16-byte loads of px
// and py, a 4-byte load of the flags, 16- and 4-byte stores (misaligned
// views and the last n % 4 particles go one at a time).  A table above
// the card's opt-in shared memory per block is read through the read-only
// cache instead.  Not __constant__: a warp's particles hit different
// sectors, and divergent constant-cache reads serialize.  The per-mesh f32
// scalars (2π, the sector angle dth, cos(dth/2), the inside bounds) are
// computed once on the host with f32 torch ops in the JAX package's order
// and passed in, and the plain version reads the same values.  atan2f is
// CUDA's libm, as torch's CUDA atan2, and the build uses -fmad=false, so
// the result equals the plain PyTorch version's on the card.  Inactive
// particles skip the math (their output is INVALID either way).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ANNULUS_THREADS 256

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// The element of the point (px - cx, py - cy) = (x, y), INVALID outside
// the annulus.  tab: (n_sectors, 6) f32 rows (cos phi, sin phi, cos tha,
// sin tha, cos thd, sin thd), read as three float2 pairs.
template <bool kShared>
__device__ __forceinline__ int locate_one(
    float x, float y, float theta0, float two_pi, float dth, float m,
    float r_in, float dr, float lo, float hi, float r_f, float s_f,
    const float2* __restrict__ tab, const int* __restrict__ perm) {
  float th = atan2f(y, x) - theta0;
  if (th < 0.0f) th = th + two_pi;
  if (th < 0.0f) th = th + two_pi;
  const float kf = clampf(floorf(th / dth), 0.0f, s_f - 1.0f);
  // kf is NaN only where x or y is: r_eff is NaN then and the point is
  // outside whichever row it reads
  const int k = isnan(kf) ? 0 : (int)kf;
  const float2 phi = kShared ? tab[3 * k] : __ldg(tab + 3 * k);
  const float2 tha = kShared ? tab[3 * k + 1] : __ldg(tab + 3 * k + 1);
  const float2 thd = kShared ? tab[3 * k + 2] : __ldg(tab + 3 * k + 2);
  // wedge-bisector projection: exact ring floor, chord-exact bounds
  const float r_eff = (x * phi.x + y * phi.y) / m;
  if (!((r_eff >= lo) && (r_eff <= hi))) return -1;
  const float rf = clampf(floorf((r_eff - r_in) / dr), 0.0f, r_f - 1.0f);
  // quad diagonal a -> d: cross >= 0 is triangle [a, b, d] (+0)
  const float ra = r_in + rf * dr;
  const float rd = ra + dr;
  const float ax = ra * tha.x;
  const float ay = ra * tha.y;
  const float ddx = rd * thd.x - ax;
  const float ddy = rd * thd.y - ay;
  const float cross = ddx * (y - ay) - ddy * (x - ax);
  const float trif = cross >= 0.0f ? 0.0f : 1.0f;
  const int elem = (int)((rf * s_f + kf) * 2.0f + trif);
  return perm != nullptr ? perm[elem] : elem;
}

// kVec: px, py and elem_out 16-byte aligned, active and active_out 4-byte
template <bool kShared, bool kVec>
__global__ void __launch_bounds__(ANNULUS_THREADS) annulus_locate_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const uint8_t* __restrict__ active, long long n, float cx, float cy,
    float theta0, float two_pi, float dth, float m, float r_in, float dr,
    float lo, float hi, int n_rings, int n_sectors,
    const float2* __restrict__ table, const int* __restrict__ perm,
    int* __restrict__ elem_out, uint8_t* __restrict__ active_out) {
  extern __shared__ float2 s_table[];
  const float2* tab = table;
  if (kShared) {
    for (int k = threadIdx.x; k < 3 * n_sectors; k += ANNULUS_THREADS)
      s_table[k] = table[k];
    __syncthreads();
    tab = s_table;
  }
  const float r_f = (float)n_rings, s_f = (float)n_sectors;
  const long long stride = (long long)gridDim.x * ANNULUS_THREADS;
  const long long t = (long long)blockIdx.x * ANNULUS_THREADS + threadIdx.x;
#define LOCATE(a, x, y) ((a) ? locate_one<kShared>((x) - cx, (y) - cy, theta0, two_pi, dth, \
                                                   m, r_in, dr, lo, hi, r_f, s_f, tab, perm) \
                             : -1)
  long long head = 0;
  if (kVec) {
    head = n & ~3LL;
    for (long long q = t; 4 * q < head; q += stride) {
      const float4 x4 = reinterpret_cast<const float4*>(px)[q];
      const float4 y4 = reinterpret_cast<const float4*>(py)[q];
      const uchar4 a4 = reinterpret_cast<const uchar4*>(active)[q];
      const int e0 = LOCATE(a4.x, x4.x, y4.x), e1 = LOCATE(a4.y, x4.y, y4.y);
      const int e2 = LOCATE(a4.z, x4.z, y4.z), e3 = LOCATE(a4.w, x4.w, y4.w);
      reinterpret_cast<int4*>(elem_out)[q] = make_int4(e0, e1, e2, e3);
      reinterpret_cast<uchar4*>(active_out)[q] =
          make_uchar4(e0 >= 0, e1 >= 0, e2 >= 0, e3 >= 0);
    }
  }
  for (long long i = head + t; i < n; i += stride) {
    const int elem = LOCATE(active[i], px[i], py[i]);
    elem_out[i] = elem;
    active_out[i] = elem >= 0 ? 1 : 0;
  }
#undef LOCATE
}

// perm: (2·n_rings·n_sectors,) canonical -> actual element id, or nullptr;
// table: AnnulusLocator2D.sector_table, (n_sectors, 6) f32, 8-byte aligned
extern "C" int pp_annulus_locate(
    const float* px, const float* py, const uint8_t* active, long long n,
    float cx, float cy, float theta0, float two_pi, float dth, float m,
    float r_in, float dr, float lo, float hi, int n_rings, int n_sectors,
    const float* table, const int* perm, int* elem_out, uint8_t* active_out,
    cudaStream_t stream) {
  if (n_sectors < 1 || ((uintptr_t)table & 7)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  static int sms = 0, smem_optin = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const size_t smem = (size_t)n_sectors * 6 * sizeof(float);
  const bool shared = smem <= (size_t)smem_optin;
  const bool vec = !((((uintptr_t)px | (uintptr_t)py | (uintptr_t)elem_out) & 15) ||
                     (((uintptr_t)active | (uintptr_t)active_out) & 3));
  void (*kernel)(const float*, const float*, const uint8_t*, long long, float, float,
                 float, float, float, float, float, float, float, float, int, int,
                 const float2*, const int*, int*, uint8_t*) =
      shared ? (vec ? annulus_locate_kernel<true, true> : annulus_locate_kernel<true, false>)
             : (vec ? annulus_locate_kernel<false, true> : annulus_locate_kernel<false, false>);
  // one wave of blocks, sized to occupancy (the table's shared memory
  // bounds it), each staging the table once
  static size_t sized_for = (size_t)-1;
  static int per_sm = 0;
  if (shared && sized_for != smem) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(annulus_locate_kernel<true, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      cudaFuncSetAttribute(annulus_locate_kernel<true, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, annulus_locate_kernel<true, true>,
                                                  ANNULUS_THREADS, smem);
    sized_for = smem;
  }
  const long long threads_needed = vec ? n / 4 + n % 4 : n;
  long long blocks = (threads_needed + ANNULUS_THREADS - 1) / ANNULUS_THREADS;
  const long long cap = (long long)sms * (shared ? (per_sm > 0 ? per_sm : 1)
                                                 : 2048 / ANNULUS_THREADS);
  if (blocks > cap) blocks = cap;
  kernel<<<(unsigned)blocks, ANNULUS_THREADS, shared ? smem : 0, stream>>>(
      px, py, active, n, cx, cy, theta0, two_pi, dth, m, r_in, dr, lo, hi,
      n_rings, n_sectors, reinterpret_cast<const float2*>(table), perm, elem_out,
      active_out);
  return (int)cudaGetLastError();
}
