// Kernel B: flux-band locator cell id, one thread per point.
//
// Replaces (JAX reference): BandGrid2D._band_continuous + cell_of
// (pumipic_tpu/mesh/locator.py:692-755), the cell eval the TPU probe
// pallas_eval wrote in Pallas (perf/pallas_smoke.py:92, pallas_call at :98).
// Per point: θ-harmonics by recurrence from (x/r, y/r) projected onto the
// rank SVD modes, per-point Chebyshev coefficients, a Horner seed and
// newton_iters Newton/Clenshaw steps for the band coordinate b*, the
// diamond angle τ, and cell = clip(floor(b*))·T + clip(floor(τ·T/4)).
//
// What bounds it on an H100: arithmetic.  A point reads 8 bytes and writes
// 4 (120 MB at 10M points) but costs ~1,450 f32 operations (J·rank·4 for
// the projections, (P+1)·rank·2 for the coefficients, ~8P per Clenshaw
// pass, five IEEE divisions and a square root), none contracted into FMAs:
// ~1.45e10 operations at 10M, at least 0.44 ms at the card's f32 rate.
//
// Design: the coefficients (rank×(2J+1) + (P+1)×rank + the seed terms,
// about 2 KB on the 120k mesh) are staged once per block in shared
// memory, where every thread of a warp reads the same word (a broadcast).
// The rank accumulators and the Chebyshev coefficients live in registers.
// The kernel is compiled twice: for (J, P, rank) = (24, 12, 8), the JAX
// package's defaults and what every large flux-band mesh gets (the 120k
// one included), with constant trip counts and no predicates; and for
// runtime values up to the bounds MAX_*, with the loops over rank and P
// run to the bounds and the unused iterations predicated off.  The
// launcher picks by the grid's values; the first measured 2.0× faster
// at 10M points (PERF.md).
// Every expression keeps the plain version's order (t + v·c, then + v·s;
// the left fold from 0 for q; Clenshaw's (2b + 2u·d) − d2), and the build
// uses -fmad=false and IEEE division and square root, so the cell ids equal
// the plain PyTorch version's bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BAND_THREADS 256
#define MAX_HARM 24
#define MAX_CHEB 12
#define MAX_RANK 8
#define MAX_INV 11

// min(max(v, lo), hi) that keeps NaN, as torch.clamp does
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// max(v, lo) that keeps NaN
__device__ __forceinline__ float maxf_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// CJ, CP, CR > 0: J, P and rank fixed at compile time; 0: the runtime ones
template <int CJ, int CP, int CR>
__global__ void __launch_bounds__(BAND_THREADS) band_cell_kernel(
    const float* __restrict__ px, const float* __restrict__ py, long long n,
    float cx, float cy, const float* __restrict__ coefs, int K, int T, int J_,
    int P_, int rank_, int n_inv, int newton_iters, int* __restrict__ cells) {
  const int J = CJ > 0 ? CJ : J_;
  const int P = CP > 0 ? CP : P_;
  const int rank = CR > 0 ? CR : rank_;
  // coefs = [coef_v (rank x (2J+1)) | coef_u ((P+1) x rank) | inv_coef]
  __shared__ float s_coef[MAX_RANK * (2 * MAX_HARM + 1) +
                          (MAX_CHEB + 1) * MAX_RANK + MAX_INV];
  const int n_v = rank * (2 * J + 1);
  const int n_all = n_v + (P + 1) * rank + n_inv;
  for (int j = threadIdx.x; j < n_all; j += blockDim.x) s_coef[j] = coefs[j];
  __syncthreads();
  const float* cv = s_coef;
  const float* cu = s_coef + n_v;
  const float* ic = cu + (P + 1) * rank;
  const int nh = 2 * J + 1;
  const float half_k = 0.5f * (float)K;
  const float t_scale = (float)T / 4.0f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = px[i] - cx;
    const float y = py[i] - cy;
    const float r = sqrtf(x * x + y * y);
    const float inv_r = 1.0f / maxf_nan(r, 1e-30f);
    const float c1 = x * inv_r;
    const float s1 = y * inv_r;

    float t[MAX_RANK];
#pragma unroll
    for (int k = 0; k < MAX_RANK; ++k) t[k] = k < rank ? cv[k * nh] : 0.0f;
    float cj = c1, sj = s1;
#pragma unroll 4
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k) {
        if (k < rank) {
          t[k] = t[k] + cv[k * nh + 1 + j] * cj;
          t[k] = t[k] + cv[k * nh + 1 + J + j] * sj;
        }
      }
      if (j + 1 < J) {
        const float cn = cj * c1 - sj * s1;
        const float sn = sj * c1 + cj * s1;
        cj = cn;
        sj = sn;
      }
    }
    float q[MAX_CHEB + 1];
#pragma unroll
    for (int p = 0; p <= MAX_CHEB; ++p) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k)
        if (p <= P && k < rank) acc = acc + cu[p * rank + k] * t[k];
      q[p] = acc;
    }

    float u = ic[n_inv - 1];
    for (int p = n_inv - 2; p >= 0; --p) u = u * r + ic[p];
    u = clampf(u, -1.05f, 1.05f);
    for (int it = 0; it < newton_iters; ++it) {
      // Clenshaw for the value and the du-derivative in one recurrence
      float bk1 = 0.0f, bk2 = 0.0f, dk1 = 0.0f, dk2 = 0.0f;
      const float tu = 2.0f * u;
#pragma unroll
      for (int p = MAX_CHEB; p >= 1; --p) {
        if (p <= P) {
          const float dn = 2.0f * bk1 + tu * dk1 - dk2;
          dk2 = dk1;
          dk1 = dn;
          const float bn = q[p] + tu * bk1 - bk2;
          bk2 = bk1;
          bk1 = bn;
        }
      }
      const float val = q[0] + u * bk1 - bk2;
      const float dv = bk1 + u * dk1 - dk2;
      u = u - (val - r) / maxf_nan(dv, 1e-6f);
      u = clampf(u, -1.05f, 1.05f);
    }
    // diamond angle τ ∈ [0, 4): monotone in θ
    const float d = y / maxf_nan(fabsf(x) + fabsf(y), 1e-30f);
    const float tau = x >= 0.0f ? (y >= 0.0f ? d : 4.0f + d) : 2.0f - d;
    const float bstar = (u + 1.0f) * half_k;
    const float bf = clampf(floorf(bstar), 0.0f, (float)(K - 1));
    const float tf = clampf(floorf(tau * t_scale), 0.0f, (float)(T - 1));
    cells[i] = min(max((int)(bf * (float)T + tf), 0), K * T - 1);
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

// The wrapper checks J <= MAX_HARM, P <= MAX_CHEB, rank <= MAX_RANK and
// n_inv <= MAX_INV before the launch.
extern "C" int pp_band_cell(const float* px, const float* py, long long n,
                            float cx, float cy, const float* coefs, int K,
                            int T, int J, int P, int rank, int n_inv,
                            int newton_iters, int* cells,
                            cudaStream_t stream) {
  if (J > MAX_HARM || P > MAX_CHEB || rank > MAX_RANK || n_inv > MAX_INV ||
      n_inv < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  long long blocks = (n + BAND_THREADS - 1) / BAND_THREADS;
  const long long cap = (long long)num_sms() * 8;
  if (blocks > cap) blocks = cap;
  if (J == 24 && P == 12 && rank == 8)
    band_cell_kernel<24, 12, 8><<<(unsigned)blocks, BAND_THREADS, 0, stream>>>(
        px, py, n, cx, cy, coefs, K, T, J, P, rank, n_inv, newton_iters, cells);
  else
    band_cell_kernel<0, 0, 0><<<(unsigned)blocks, BAND_THREADS, 0, stream>>>(
        px, py, n, cx, cy, coefs, K, T, J, P, rank, n_inv, newton_iters, cells);
  return (int)cudaGetLastError();
}
