// Kernel P: banded trig-free elliptical push, one thread per particle.
//
// Replaces (JAX reference): pumipic_tpu/ops/push.py class_from_bands (:124),
// rot_vals_from_class (:82) and elliptical_push_rot_vals (:137), as the
// FULL-mode step composes them at pumipic_tpu/models/pseudo_xgcm.py:614-622.
//
// What bounds it on an H100: device-memory bytes.  Per particle it reads
// 25 bytes (x0 x1 cphi sphi b f32, elem i32, active u8) and writes 16
// (tx ty cphi' sphi'); at 10M particles that is ~410 MB, ~0.12 ms at
// 3.35 TB/s.  The arithmetic (a binary search over <= 120 band starts and
// a dozen flops) is far below the memory time.
//
// Design: the band starts and the per-class (cos d, sin d) table live in
// shared memory, so the class lookup costs no device-memory traffic.  The
// table is computed once on the host side by the plain rot_vals_from_class
// over the class ids v0..v0+K-1, and the plain version reads the same
// table, so kernel and plain version use identical libm values.  Built with
// -fmad=false so every a*b+c rounds twice, as PyTorch's separate ops do:
// the outputs equal the plain version bit for bit.
//
// "phi" mode (push_phi_kernel): the angle form of the push that the
// single-device PseudoXGCm app runs.  Replaces elliptical_push_components
// (pumipic_tpu/ops/push.py:44-62) and the where(active) masks around it
// (pumipic_tpu/models/pseudo_xgcm.py:365-377).  The class id comes from the
// same band starts (v0 + #{starts <= max(elem, 0)}) or, where the
// classification is not band-ordered, from a class id per particle.  In
// the JAX order: cid = f32(max(c, 1)), factor 0.01 for class 1 else 1,
// rad = phi + (deg * (factor / cid)) * pi / 180, x = (b * d) * cos(rad) + h,
// y = b * sin(rad) + k; inactive particles keep x and phi.  Divisions are
// IEEE, as the plain version's (it divides by 0-d tensors: torch's CUDA
// division by a Python scalar multiplies by the reciprocal).  cos and sin
// are taken in f64 and rounded to f32, in the kernel and in the plain
// version alike: the CUDA and CPU math libraries agree within an ulp or two
// in f64, so the rounded f32 values agree on the card and on the CPU
// (f32 cosf/sinf differ between the two libraries in the last bit).  Per
// particle it reads 21 bytes and writes 20 (tx, ty, the (x, y) pair and
// phi): ~410 MB at 10M, >= 0.12 ms at 3.35 TB/s; two libm calls and a few
// divisions per particle stay below that.
//
// Table mode (push_table_kernel): the push of a classification that is not
// band-ordered.  Replaces elliptical_push_rot (pumipic_tpu/ops/push.py:166-
// 192) over the per-element table of elliptical_rot_table (:65-79), as the
// FULL-mode step runs it (pumipic_tpu/models/pseudo_xgcm.py:629-633).  Each
// particle gathers the 8-byte (cos d, sin d) row of element max(elem, 0)
// from the (E, 2) f32 table (one float2 load; the 122,603-row table of the
// 120k mesh is 1 MB and stays in L2), then rotates, renormalizes and forms
// the target as the banded mode does.  Per particle: 25 bytes streamed in,
// 8 gathered, 16 out: ~41 bytes, ~0.12 ms at 10M particles and 3.35 TB/s.
// The table is built once on the host (cos and sin in f64, rounded), so the
// kernel and the plain version read the same values.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void push_banded_kernel(
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ cphi, const float* __restrict__ sphi,
    const float* __restrict__ b, const int* __restrict__ elem,
    const uint8_t* __restrict__ active,
    const int* __restrict__ starts, int n_starts,
    const float* __restrict__ cd_tab, const float* __restrict__ sd_tab,
    float h, float k, float d,
    float* __restrict__ tx, float* __restrict__ ty,
    float* __restrict__ cphi_out, float* __restrict__ sphi_out,
    long long n) {
  extern __shared__ unsigned char smem[];
  int* s_starts = reinterpret_cast<int*>(smem);
  float* s_cd = reinterpret_cast<float*>(s_starts + n_starts);
  float* s_sd = s_cd + (n_starts + 1);
  for (int j = threadIdx.x; j < n_starts; j += blockDim.x) s_starts[j] = starts[j];
  for (int j = threadIdx.x; j <= n_starts; j += blockDim.x) {
    s_cd[j] = cd_tab[j];
    s_sd[j] = sd_tab[j];
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int e = max(elem[i], 0);
    // class index = #{band starts <= e} (upper bound over sorted starts)
    int lo = 0, hi = n_starts;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_starts[mid] <= e) lo = mid + 1; else hi = mid;
    }
    const float cd = s_cd[lo], sd = s_sd[lo];
    const float c = cphi[i], s = sphi[i];
    float c2 = c * cd - s * sd;
    float s2 = s * cd + c * sd;
    const float f = 1.5f - 0.5f * (c2 * c2 + s2 * s2);
    c2 = c2 * f;
    s2 = s2 * f;
    const float bb = b[i];
    if (active[i]) {
      tx[i] = bb * d * c2 + h;
      ty[i] = bb * s2 + k;
      cphi_out[i] = c2;
      sphi_out[i] = s2;
    } else {
      tx[i] = x0[i];
      ty[i] = x1[i];
      cphi_out[i] = c;
      sphi_out[i] = s;
    }
  }
}

__global__ void push_table_kernel(
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ cphi, const float* __restrict__ sphi,
    const float* __restrict__ b, const int* __restrict__ elem,
    const uint8_t* __restrict__ active, const float2* __restrict__ table,
    int n_rows, float h, float k, float d, float* __restrict__ tx,
    float* __restrict__ ty, float* __restrict__ cphi_out,
    float* __restrict__ sphi_out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float c = cphi[i], s = sphi[i];
    if (active[i]) {
      const int e = min(max(elem[i], 0), n_rows - 1);
      const float2 r = __ldg(table + e);
      float c2 = c * r.x - s * r.y;
      float s2 = s * r.x + c * r.y;
      const float f = 1.5f - 0.5f * (c2 * c2 + s2 * s2);
      c2 = c2 * f;
      s2 = s2 * f;
      const float bb = b[i];
      tx[i] = bb * d * c2 + h;
      ty[i] = bb * s2 + k;
      cphi_out[i] = c2;
      sphi_out[i] = s2;
    } else {
      tx[i] = x0[i];
      ty[i] = x1[i];
      cphi_out[i] = c;
      sphi_out[i] = s;
    }
  }
}

__global__ void push_phi_kernel(
    const float* __restrict__ xy, const float* __restrict__ phi,
    const float* __restrict__ b, const uint8_t* __restrict__ active,
    const int* __restrict__ cls, const int* __restrict__ starts, int n_starts,
    int v0, int band_form, float deg, float h, float k, float d,
    float* __restrict__ tx, float* __restrict__ ty, float* __restrict__ xy_out,
    float* __restrict__ phi_out, long long n) {
  extern __shared__ unsigned char smem[];
  int* s_starts = reinterpret_cast<int*>(smem);
  if (band_form) {
    for (int j = threadIdx.x; j < n_starts; j += blockDim.x) s_starts[j] = starts[j];
    __syncthreads();
  }
  const float pi_f = 3.14159265358979323846f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int c;
    if (band_form) {
      const int e = max(cls[i], 0);
      int lo = 0, hi = n_starts;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_starts[mid] <= e) lo = mid + 1; else hi = mid;
      }
      c = v0 + lo;
    } else {
      c = cls[i];
    }
    const float p = phi[i];
    const float x0 = xy[2 * i], x1 = xy[2 * i + 1];
    float ox = x0, oy = x1, op = p;
    if (active[i]) {
      const float cid = (float)max(c, 1);
      const float factor = c == 1 ? 0.01f : 1.0f;
      const float deg_p = deg * (factor / cid);
      const float rad = p + deg_p * pi_f / 180.0f;
      const float a = b[i] * d;
      const double rd = (double)rad;
      ox = a * (float)cos(rd) + h;
      oy = b[i] * (float)sin(rd) + k;
      op = rad;
    }
    tx[i] = ox;
    ty[i] = oy;
    xy_out[2 * i] = ox;
    xy_out[2 * i + 1] = oy;
    phi_out[i] = op;
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

extern "C" int pp_push_banded(
    const float* x0, const float* x1, const float* cphi, const float* sphi,
    const float* b, const int* elem, const uint8_t* active,
    const int* starts, int n_starts, const float* cd_tab,
    const float* sd_tab, float h, float k, float d,
    float* tx, float* ty, float* cphi_out, float* sphi_out,
    long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  const size_t shmem = sizeof(int) * n_starts + 2 * sizeof(float) * (n_starts + 1);
  push_banded_kernel<<<(unsigned)blocks, threads, shmem, stream>>>(
      x0, x1, cphi, sphi, b, elem, active, starts, n_starts, cd_tab, sd_tab,
      h, k, d, tx, ty, cphi_out, sphi_out, n);
  return (int)cudaGetLastError();
}

// table: the (n_rows, 2) f32 rotation table, 8-byte aligned
extern "C" int pp_push_table(
    const float* x0, const float* x1, const float* cphi, const float* sphi,
    const float* b, const int* elem, const uint8_t* active,
    const float* table, int n_rows, float h, float k, float d, float* tx,
    float* ty, float* cphi_out, float* sphi_out, long long n,
    cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  push_table_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      x0, x1, cphi, sphi, b, elem, active,
      reinterpret_cast<const float2*>(table), n_rows, h, k, d, tx, ty,
      cphi_out, sphi_out, n);
  return (int)cudaGetLastError();
}

// band_form 1: cls is elem, classes v0 + #{starts <= max(elem, 0)} over
// n_starts sorted band starts; band_form 0: cls is the class id per particle.
extern "C" int pp_push_phi(
    const float* xy, const float* phi, const float* b, const uint8_t* active,
    const int* cls, const int* starts, int n_starts, int v0, int band_form,
    float deg, float h, float k, float d, float* tx, float* ty, float* xy_out,
    float* phi_out, long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  const size_t shmem = band_form ? sizeof(int) * n_starts : 0;
  push_phi_kernel<<<(unsigned)blocks, threads, shmem, stream>>>(
      xy, phi, b, active, cls, starts, n_starts, v0, band_form, deg, h, k, d,
      tx, ty, xy_out, phi_out, n);
  return (int)cudaGetLastError();
}
