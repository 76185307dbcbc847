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
// What bounds it on an H100: the issue of instructions.  A point reads 8
// bytes and writes 4 but costs ~1,450 f32 operations (J·rank·4 for the
// projections, (P+1)·rank·2 for the coefficients, ~7P per Clenshaw pass,
// five IEEE divisions and a square root).  The build's -fmad=false keeps
// every a*b+c an FMUL and an FADD, as the plain version rounds it, so at
// one warp instruction per clock per scheduler 10M points take at least
// ~0.43 ms (1.45e10 instructions over 132 SMs x 128 lanes x 1.98 GHz);
// with the coefficient fetches and the rest, ~1,790 instructions a point.
//
// Design:
// - The coefficients (rank×(2J+1) + (P+1)×rank + the seed terms, 2,028
//   bytes on the 120k mesh) travel by value in the launch's parameter block
//   (BandParams), which the card keeps in its constant bank.  No shared
//   memory, no loads through the LSU: ptxas fetches them into uniform
//   registers (ULDC), the harmonic columns' (cos, sin) pairs side by side
//   so that one 64-bit ULDC fetches both.
// - The kernel is compiled for (J, P, rank, seed terms, Newton steps) =
//   (24, 12, 8, 11, 3), the JAX package's defaults and what every large
//   flux-band mesh gets (the 120k one included), with every loop unrolled:
//   every coefficient offset is a constant, and the rank accumulators, the
//   Chebyshev coefficients and the Clenshaw state are the only registers
//   (32), so 64 warps fit on an SM to cover the serial Clenshaw chains.
// - A second instantiation takes runtime values up to the bounds MAX_*:
//   the same loops, run to the bounds with the unused iterations
//   predicated off, the coefficients read with runtime offsets
//   (``__grid_constant__`` lets it index the parameter block in place).
// - One thread per point (a grid-stride loop over an occupancy-sized grid
//   measured slower, PERF.md).
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
#define MAX_COEF (MAX_RANK * (2 * MAX_HARM + 1) + (MAX_CHEB + 1) * MAX_RANK + MAX_INV)

// The launch's parameters, copied from the host at each launch (2,064
// bytes; the wrapper packs them in this order, ops/locate.py).
struct BandParams {
  // [coef_v's harmonic pairs (rank x J x (cos, sin)) | coef_v's constant
  //  terms (rank) | coef_u ((P+1) x rank) | inv_coef]
  float coef[MAX_COEF];
  float cx, cy;
  int K, T, J, P, rank, n_inv, newton_iters;
};

// min(max(v, lo), hi) that keeps NaN, as torch.clamp does
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// max(v, lo) that keeps NaN
__device__ __forceinline__ float maxf_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// CJ, CP, CR, CI > 0 and CN >= 0: J, P, rank, seed terms and Newton steps
// fixed at compile time; 0 (CN -1): the runtime ones
template <int CJ, int CP, int CR, int CI, int CN>
__global__ void __launch_bounds__(BAND_THREADS) band_cell_kernel(
    const float* __restrict__ px, const float* __restrict__ py, long long n,
    const __grid_constant__ BandParams prm, int* __restrict__ cells) {
  const int J = CJ > 0 ? CJ : prm.J;
  const int P = CP > 0 ? CP : prm.P;
  const int rank = CR > 0 ? CR : prm.rank;
  const int n_inv = CI > 0 ? CI : prm.n_inv;
  const int iters = CN >= 0 ? CN : prm.newton_iters;
  const int oc = rank * J * 2;          // the constant terms' offset in prm.coef
  const int ou = oc + rank;             // coef_u's
  const int oi = ou + (P + 1) * rank;   // inv_coef's
  const float half_k = 0.5f * (float)prm.K;
  const float t_scale = (float)prm.T / 4.0f;

  const long long i = (long long)blockIdx.x * BAND_THREADS + threadIdx.x;
  if (i < n) {
    const float x = px[i] - prm.cx;
    const float y = py[i] - prm.cy;
    const float r = sqrtf(x * x + y * y);
    const float inv_r = 1.0f / maxf_nan(r, 1e-30f);
    const float c1 = x * inv_r;
    const float s1 = y * inv_r;

    float t[MAX_RANK];
#pragma unroll
    for (int k = 0; k < MAX_RANK; ++k) t[k] = k < rank ? prm.coef[oc + k] : 0.0f;
    float cj = c1, sj = s1;
#pragma unroll
    for (int j = 0; j < MAX_HARM; ++j) {
      if (j < J) {
#pragma unroll
        for (int k = 0; k < MAX_RANK; ++k) {
          if (k < rank) {
            t[k] = t[k] + prm.coef[(k * J + j) * 2] * cj;
            t[k] = t[k] + prm.coef[(k * J + j) * 2 + 1] * sj;
          }
        }
        if (j + 1 < J) {
          const float cn = cj * c1 - sj * s1;
          const float sn = sj * c1 + cj * s1;
          cj = cn;
          sj = sn;
        }
      }
    }
    float q[MAX_CHEB + 1];
#pragma unroll
    for (int p = 0; p <= MAX_CHEB; ++p) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_RANK; ++k)
        if (p <= P && k < rank) acc = acc + prm.coef[ou + p * rank + k] * t[k];
      q[p] = acc;
    }

    float u = prm.coef[oi + n_inv - 1];
#pragma unroll
    for (int p = MAX_INV - 2; p >= 0; --p)
      if (p <= n_inv - 2) u = u * r + prm.coef[oi + p];
    u = clampf(u, -1.05f, 1.05f);
#pragma unroll
    for (int it = 0; it < iters; ++it) {
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
    const float bf = clampf(floorf(bstar), 0.0f, (float)(prm.K - 1));
    const float tf = clampf(floorf(tau * t_scale), 0.0f, (float)(prm.T - 1));
    cells[i] = min(max((int)(bf * (float)prm.T + tf), 0), prm.K * prm.T - 1);
  }
}

template <int CJ, int CP, int CR, int CI, int CN>
static int launch(const float* px, const float* py, long long n,
                  const BandParams& prm, int* cells, cudaStream_t stream) {
  const long long blocks = (n + BAND_THREADS - 1) / BAND_THREADS;
  band_cell_kernel<CJ, CP, CR, CI, CN><<<(unsigned)blocks, BAND_THREADS, 0, stream>>>(
      px, py, n, prm, cells);
  return (int)cudaGetLastError();
}

// prm: a host pointer (the wrapper's packed BandParams); the launch copies
// it.  The wrapper checks the bounds MAX_* before the launch too.
extern "C" int pp_band_cell(const float* px, const float* py, long long n,
                            const BandParams* prm, int* cells,
                            cudaStream_t stream) {
  const BandParams& p = *prm;
  if (p.J > MAX_HARM || p.P > MAX_CHEB || p.rank > MAX_RANK || p.n_inv > MAX_INV ||
      p.n_inv < 1)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  if (p.J == 24 && p.P == 12 && p.rank == 8 && p.n_inv == 11 && p.newton_iters == 3)
    return launch<24, 12, 8, 11, 3>(px, py, n, p, cells, stream);
  return launch<0, 0, 0, 0, -1>(px, py, n, p, cells, stream);
}
