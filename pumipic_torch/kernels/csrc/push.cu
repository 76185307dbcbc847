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
