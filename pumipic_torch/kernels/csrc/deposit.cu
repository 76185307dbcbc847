// Kernel D: gyro-ring deposit, two gather passes over static CSR maps.
//
// Replaces (JAX reference): accumulate_to_rings stage 2
// (pumipic_tpu/ops/scatter.py:224-232, the (E,R) ring counts expanded to
// element vertices by segment_sum) and scatter_to_mapped_verts (:235-255,
// the gyro-average map applied by segment_sum).
//
// What bounds it on an H100: latency, not bytes.  At V = 61,720, R = 3,
// P = 8 the passes touch a few MB (the vertex->element incidence, ~1.5M
// gyro-map entries, the (V,R) ring sums), all of which fit in L2; the cost
// is the launches and the dependent index loads.
//
// Design: both index maps are static, so their transposes are built once at
// setup as CSR lists (vertex -> incident elements; output vertex -> the
// (v, r) ring slots whose ring points land on it).  Each output is then a
// sum owned by one thread, taken in a fixed order: no float atomics, and a
// deterministic result that equals the plain version's.  Pass 1: one
// thread per vertex, ring_accum[v, r] = sum of counts[e] over the incident
// elements, for the two rings rd and ru that the uniform radius brackets;
// with a per-particle radius the counts are (E, R), and each ring's sum
// runs over its own column (deposit_rings_er_kernel).  Pass 2: one thread
// per output vertex, out[u] = sum of ring_accum[v, r] / P.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void deposit_rings_kernel(const int* __restrict__ counts,
                                     const int* __restrict__ v2e_off,
                                     const int* __restrict__ v2e_vals,
                                     int n_verts, int n_rings, int rd, int ru,
                                     float* __restrict__ ring_accum) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_verts) return;
  float s = 0.0f;
  for (int j = v2e_off[v]; j < v2e_off[v + 1]; ++j) s += (float)counts[v2e_vals[j]];
  for (int r = 0; r < n_rings; ++r)
    ring_accum[(size_t)v * n_rings + r] = (r == rd || r == ru) ? s : 0.0f;
}

__global__ void deposit_rings_er_kernel(const int* __restrict__ counts,
                                        const int* __restrict__ v2e_off,
                                        const int* __restrict__ v2e_vals,
                                        int n_verts, int n_rings,
                                        float* __restrict__ ring_accum) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_verts) return;
  const int j0 = v2e_off[v], j1 = v2e_off[v + 1];
  for (int r = 0; r < n_rings; ++r) {
    float s = 0.0f;
    for (int j = j0; j < j1; ++j)
      s += (float)counts[(size_t)v2e_vals[j] * n_rings + r];
    ring_accum[(size_t)v * n_rings + r] = s;
  }
}

__global__ void deposit_mapped_kernel(const float* __restrict__ ring_accum,
                                      const int* __restrict__ off,
                                      const int* __restrict__ src, int n_verts,
                                      int points_per_ring,
                                      float* __restrict__ out) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n_verts) return;
  const float p = (float)points_per_ring;
  float s = 0.0f;
  for (int j = off[u]; j < off[u + 1]; ++j) s += ring_accum[src[j]] / p;
  out[u] = s;
}

extern "C" int pp_deposit_rings(const int* counts, const int* v2e_off,
                                const int* v2e_vals, int n_verts, int n_rings,
                                int rd, int ru, float* ring_accum,
                                cudaStream_t stream) {
  if (n_verts <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  deposit_rings_kernel<<<(n_verts + threads - 1) / threads, threads, 0, stream>>>(
      counts, v2e_off, v2e_vals, n_verts, n_rings, rd, ru, ring_accum);
  return (int)cudaGetLastError();
}

// counts: (E, R) per-(element, ring) counts
extern "C" int pp_deposit_rings_er(const int* counts, const int* v2e_off,
                                   const int* v2e_vals, int n_verts,
                                   int n_rings, float* ring_accum,
                                   cudaStream_t stream) {
  if (n_verts <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  deposit_rings_er_kernel<<<(n_verts + threads - 1) / threads, threads, 0,
                            stream>>>(counts, v2e_off, v2e_vals, n_verts,
                                      n_rings, ring_accum);
  return (int)cudaGetLastError();
}

extern "C" int pp_deposit_mapped(const float* ring_accum, const int* off,
                                 const int* src, int n_verts,
                                 int points_per_ring, float* out,
                                 cudaStream_t stream) {
  if (n_verts <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  deposit_mapped_kernel<<<(n_verts + threads - 1) / threads, threads, 0, stream>>>(
      ring_accum, off, src, n_verts, points_per_ring, out);
  return (int)cudaGetLastError();
}
