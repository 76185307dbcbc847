// Kernel H: per-element particle histogram, one thread per particle.
//
// Replaces (JAX reference): count_per_key_matmul
// (pumipic_tpu/ops/scatter.py:65-129), as accumulate_to_rings calls it
// (:171-187): key = active ? elem : E, keys outside [0, E) dropped.  The TPU
// built it as a bf16 one-hot matmul on the MXU; here it is an int32
// atomicAdd into the (E,) count array, exact in any order.
//
// What bounds it on an H100: the 5 bytes streamed in per particle (~50 MB
// at 10M) and the L2 atomic throughput; the 122,603 counters (490 KB) stay
// in L2, and keys spread over them, so same-address contention is low.
//
// Design: global atomics, no privatization.  A per-block shared-memory
// copy of the histogram would need 490 KB, more than the 227 KB a block
// can hold; tiling the key range over blocks is later work.
#include <cuda_runtime.h>
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
