// Kernel K: straight-line push + periodic wrap + structured Kuhn-box locate
// + the active mask, one thread per particle: the whole push and search of
// pseudoPushAndSearch's Kuhn arm in one launch.  Its push-only form
// (pp_push_wrap, counted as "push_wrap") is the push of the walk arm.
//
// Replaces (JAX reference): straight_line_push (pumipic_tpu/ops/push.py:244-
// 249), the periodic wrap (pumipic_tpu/models/pseudo_push_and_search.py:
// 195-198), KuhnLocator3D.locate (pumipic_tpu/mesh/locator.py:190-228) and
// the mask where(active, e, INVALID) (pseudo_push_and_search.py:205-207),
// which XLA compiles as fused elementwise passes (queue item K11b).
//
// What bounds it on an H100: device-memory bytes.  Per particle it reads 13
// bytes (x, y, z f32 and active u8) and writes 16 (x', y', z' and the
// element id): ~290 MB at 10M particles, ~0.09 ms at 3.35 TB/s.  The
// arithmetic (three fmods, floors and a dozen f32 operations) is far below
// that; a canonical-to-actual permutation (an imported box) adds one 4-byte
// gather from a table of E ids that stays in L2.
//
// Exactness: the displacement s = f32(distance) * d comes from the host,
// rounded as the JAX package rounds it; the wrap is fmodf plus the sign fix
// (torch.remainder's and JAX's %, never a - b*floor(a/b)); the element id is
// computed in f32 as the JAX package does (exact while 6*nx*ny*nz < 2^24),
// then cast.  Built with -fmad=false: every sum rounds as the plain
// version's separate ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct KuhnParams {
  float s[3];      // push displacement
  float lo[3];     // wrap: box corner
  float ext[3];    // wrap: box extent
  float origin[3];
  float inv_h[3];
  float lo_tol;    // f32(-eps)
  float hi_tol[3]; // f32(n + eps) per axis
  int n[3];
  int push, wrap;
};

__device__ __forceinline__ float wrap_axis(float v, float lo, float ext) {
  float m = fmodf(v - lo, ext);
  if (m != 0.0f && ((ext < 0.0f) != (m < 0.0f))) m += ext;
  return m + lo;
}

__global__ void kuhn_push_locate_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ active,
    long long n, KuhnParams p, const int* __restrict__ perm,
    float* __restrict__ x_out, int* __restrict__ elem_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      v[j] = x[3 * i + j];
      if (p.push) v[j] = v[j] + p.s[j];
      if (p.wrap) v[j] = wrap_axis(v[j], p.lo[j], p.ext[j]);
      x_out[3 * i + j] = v[j];
    }
    int e = -1;
    if (active[i]) {
      bool inside = true;
      float c[3], f[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float r = (v[j] - p.origin[j]) * p.inv_h[j];
        inside = inside && (r >= p.lo_tol) && (r <= p.hi_tol[j]);
        c[j] = fminf(fmaxf(floorf(r), 0.0f), (float)(p.n[j] - 1));
        f[j] = r - c[j];
      }
      if (inside) {
        const bool b1 = f[0] >= f[1], b2 = f[1] >= f[2], b3 = f[0] >= f[2];
        const float idx = b1 ? (b2 ? 0.0f : (b3 ? 1.0f : 4.0f))
                             : (b2 ? (b3 ? 2.0f : 3.0f) : 5.0f);
        e = (int)(((c[0] * (float)p.n[1] + c[1]) * (float)p.n[2] + c[2]) * 6.0f + idx);
        if (perm != nullptr) e = perm[e];
      }
    }
    elem_out[i] = e;
  }
}

// K's push-only form: x' = wrap(x + s) of every slot, no locate (the push
// of pseudoPushAndSearch's walk arm, whose locate is kernel L3).  Threads
// take coordinates of the flat (3n,) array, so the loads and stores of a
// warp are 128 consecutive bytes; each thread issues the loads of four
// coordinates a grid stride apart before it computes.  The block size and
// so the grid stride are multiples of 3: a thread's axis is threadIdx.x % 3
// throughout.  Bound by bytes: 12 read and 12 written per particle.
constexpr int kPushWrapThreads = 384;
constexpr int kPushWrapUnroll = 4;

__device__ __forceinline__ float push_wrap_one(float v, const KuhnParams& p,
                                               float s, float lo, float ext) {
  if (p.push) v = v + s;
  if (p.wrap) v = wrap_axis(v, lo, ext);
  return v;
}

__global__ void push_wrap_kernel(const float* __restrict__ x, long long n3,
                                 KuhnParams p, float* __restrict__ x_out) {
  const int j = threadIdx.x % 3;
  const float s = p.s[j], lo = p.lo[j], ext = p.ext[j];
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kPushWrapUnroll - 1) * stride < n3; i += kPushWrapUnroll * stride) {
    float v[kPushWrapUnroll];
#pragma unroll
    for (int u = 0; u < kPushWrapUnroll; ++u) v[u] = x[i + u * stride];
#pragma unroll
    for (int u = 0; u < kPushWrapUnroll; ++u)
      x_out[i + u * stride] = push_wrap_one(v[u], p, s, lo, ext);
  }
  for (; i < n3; i += stride) x_out[i] = push_wrap_one(x[i], p, s, lo, ext);
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

// x, x_out: (n, 3) f32; swl: s[3] lo[3] ext[3]; oh: origin[3] inv_h[3];
// tol: f32(-eps), f32(nx + eps), f32(ny + eps), f32(nz + eps); perm: E ids
// or nullptr.
extern "C" int pp_kuhn_push_locate(
    const float* x, const uint8_t* active, long long n, int push, int wrap,
    const float* swl, const float* oh, int nx, int ny, int nz,
    const float* tol, const int* perm, float* x_out, int* elem_out,
    cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  KuhnParams p;
  for (int j = 0; j < 3; ++j) {
    p.s[j] = swl[j];
    p.lo[j] = swl[3 + j];
    p.ext[j] = swl[6 + j];
    p.origin[j] = oh[j];
    p.inv_h[j] = oh[3 + j];
    p.hi_tol[j] = tol[1 + j];
  }
  p.lo_tol = tol[0];
  p.n[0] = nx;
  p.n[1] = ny;
  p.n[2] = nz;
  p.push = push;
  p.wrap = wrap;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  kuhn_push_locate_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      x, active, n, p, perm, x_out, elem_out);
  return (int)cudaGetLastError();
}

// x, x_out: (n, 3) f32; swl: s[3] lo[3] ext[3].
extern "C" int pp_push_wrap(const float* x, long long n, int push, int wrap,
                            const float* swl, float* x_out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  KuhnParams p = {};
  for (int j = 0; j < 3; ++j) {
    p.s[j] = swl[j];
    p.lo[j] = swl[3 + j];
    p.ext[j] = swl[6 + j];
  }
  p.push = push;
  p.wrap = wrap;
  const long long n3 = 3 * n;
  long long blocks = (n3 + kPushWrapThreads - 1) / kPushWrapThreads;
  // the blocks an SM holds at once (2,048 threads each)
  const long long cap = (long long)num_sms() * (2048 / kPushWrapThreads);
  if (blocks > cap) blocks = cap;
  push_wrap_kernel<<<(unsigned)blocks, kPushWrapThreads, 0, stream>>>(x, n3, p, x_out);
  return (int)cudaGetLastError();
}
