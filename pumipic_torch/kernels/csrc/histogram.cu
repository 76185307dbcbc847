// Kernel H: per-element particle histogram, one thread per particle.
//
// Replaces (JAX reference): count_per_key_matmul
// (pumipic_tpu/ops/scatter.py:65-129), as accumulate_to_rings calls it
// (:171-192): key = active ? elem : E, keys outside [0, E) dropped.  The TPU
// built it as a bf16 one-hot matmul on the MXU; here it is an int32
// atomicAdd into the (E,) count array, exact in any order.
//
// (element, ring) key mode, for a per-particle gyro radius (:193-222): each
// active particle computes its lower ring rd = clip(floor(rg / ring_width)
// - 1, 0, R - 2) in f32 and adds one to keys elem·R + rd and elem·R + rd + 1
// of the (E·R,) counts.  The JAX package builds the keys in f32 below 2^24
// and in int32 above; both give these integers, which the wrapper keeps
// below 2^31.  A radius whose ring index is NaN deposits nothing (the JAX
// one-hot drops its NaN key).
//
// What bounds it on an H100: the 5 bytes streamed in per particle (~50 MB
// at 10M; 9 bytes and two atomics in key mode) and the L2 atomic
// throughput; the 122,603 counters (490 KB; 1.5 MB in key mode) stay in
// L2, and keys spread over them, so same-address contention is low.
//
// Design: global atomics, no privatization.  A per-block shared-memory
// copy of the histogram would need 490 KB, more than the 227 KB a block
// can hold; tiling the key range over blocks is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__global__ void histogram_kernel(const int* __restrict__ elem,
                                 const uint8_t* __restrict__ active,
                                 int n_keys, int* __restrict__ counts,
                                 long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (active[i]) {
      const int e = elem[i];
      if (e >= 0 && e < n_keys) atomicAdd(&counts[e], 1);
    }
  }
}

__global__ void histogram_rings_kernel(const int* __restrict__ elem,
                                       const uint8_t* __restrict__ active,
                                       const float* __restrict__ radius,
                                       float ring_width, int n_elems,
                                       int n_rings, int* __restrict__ counts,
                                       long long n) {
  const float rd_max = (float)(n_rings - 2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!active[i]) continue;
    const int e = elem[i];
    if (e < 0 || e >= n_elems) continue;
    const float rdf = floorf(radius[i] / ring_width) - 1.0f;
    if (isnan(rdf)) continue;
    const int rd = (int)fminf(fmaxf(rdf, 0.0f), rd_max);
    const int key = e * n_rings + rd;
    atomicAdd(&counts[key], 1);
    atomicAdd(&counts[key + 1], 1);
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

// counts must be zeroed by the caller
extern "C" int pp_histogram(const int* elem, const uint8_t* active, int n_keys,
                            int* counts, long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  histogram_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      elem, active, n_keys, counts, n);
  return (int)cudaGetLastError();
}

// (element, ring) key mode: counts (n_elems·n_rings,) zeroed by the caller;
// n_rings >= 2 and n_elems·n_rings < 2^31 (checked by the wrapper)
extern "C" int pp_histogram_rings(const int* elem, const uint8_t* active,
                                  const float* radius, float ring_width,
                                  int n_elems, int n_rings, int* counts,
                                  long long n, cudaStream_t stream) {
  if (n_rings < 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  histogram_rings_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      elem, active, radius, ring_width, n_elems, n_rings, counts, n);
  return (int)cudaGetLastError();
}
