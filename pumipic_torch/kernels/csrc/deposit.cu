// Kernel D: gyro-ring deposit, two gather passes over static CSR maps.
//
// Replaces (JAX reference): accumulate_to_rings stage 2
// (pumipic_tpu/ops/scatter.py:224-232, the (E,R) ring counts expanded to
// element vertices by segment_sum) and scatter_to_mapped_verts (:235-255,
// the gyro-average map applied by segment_sum).
//
// What bounds it on an H100: latency, not bytes.  At V = 61,720, R = 3,
// P = 8 the passes read ~19 MB (the vertex->element incidence, 4.4M
// gyro-map entries, the (V,R) ring sums, 740 KB, which stay in L2): 6 µs
// at the memory rate.  Each output is a chain of dependent loads (its
// offsets, its entries, the values they name), so the time is the latency
// of those chains over the loads the SMs keep in flight, and at this size
// a launch's own few microseconds.
//
// Design: both index maps are static, so their transposes are built once at
// setup as CSR lists (vertex -> incident elements; output vertex -> the
// (v, r) ring slots whose ring points land on it).  Each output is a sum
// owned by one thread or one group of lanes, taken in a fixed order: no
// float atomics, and the same result on every run.
// - Pass 1: one thread per vertex with (E,) per-element counts (the
//   uniform radius: the sum goes to the rings rd and ru, 0 to the others);
//   one thread per (vertex, ring) with (E, R) counts, neighbouring lanes on
//   neighbouring rings of a vertex, so a warp reads each incidence list
//   once and its (E, R) counts and (V, R) outputs contiguously.  A thread
//   issues the loads of up to DEP_ROUND1 incident elements, then of their
//   counts, before it adds them.
// - Pass 2: DEPOSIT_GROUP lanes per output vertex.  Lane l adds the
//   entries l, l + G, l + 2G, ... of the vertex's list in that order (the
//   loads of DEP_ROUND2 entries, then of the values they name, issued
//   before the adds), each divided by P (IEEE), and a fixed shuffle tree
//   adds the lanes: lane l += lane l + d for d = G/2, ..., 1.
//   Where the owner reduction's send rows are given (the picparts step's
//   SUM), the lane that writes a vertex's sum also writes it to the
//   vertex's send row: a store of the value already computed, no
//   arithmetic, so the field's bits are those without it.
// Group and round sizes are those that measured fastest at the 120k mesh's
// maps (PERF.md).  The plain versions (index_add_) add in another order.
// On the main path the sums are integer counts (pass 1) and multiples of
// 1/P with P = 8 (pass 2), exact in f32 far beyond these sizes, so any
// fixed order gives the plain version's bits; where a term c/P rounds (P
// not a power of 2), the result is that of the fixed order above
// (tests/deposit_order.py is its numpy model).
#include <cuda_runtime.h>
#include <stdint.h>

#define DEPOSIT_GROUP 8  // lanes per output vertex in pass 2
#define DEP_THREADS 256
// entries whose loads a thread issues before it adds them: pass 1 (a vertex
// has ~6 incident elements), pass 2 (per lane)
#define DEP_ROUND1 8
#define DEP_ROUND2 2

// sum of counts[e·stride + col] over v's incident elements e, in list
// order
__device__ __forceinline__ float incident_sum(const int* __restrict__ counts,
                                              const int* __restrict__ v2e_off,
                                              const int* __restrict__ v2e_vals,
                                              int v, int stride, int col) {
  float s = 0.0f;
  const int j1 = v2e_off[v + 1];
  for (int j = v2e_off[v]; j < j1; j += DEP_ROUND1) {
    int c[DEP_ROUND1];
#pragma unroll
    for (int k = 0; k < DEP_ROUND1; ++k) c[k] = j + k < j1 ? v2e_vals[j + k] : 0;
#pragma unroll
    for (int k = 0; k < DEP_ROUND1; ++k)
      c[k] = j + k < j1 ? counts[(size_t)c[k] * stride + col] : 0;
#pragma unroll
    for (int k = 0; k < DEP_ROUND1; ++k)
      if (j + k < j1) s += (float)c[k];
  }
  return s;
}

// (E,) counts: thread v sums its elements' counts once and writes the sum
// to the rings rd and ru of ring_accum[v, :], 0 to the others
__global__ void __launch_bounds__(DEP_THREADS) deposit_rings_kernel(
    const int* __restrict__ counts, const int* __restrict__ v2e_off,
    const int* __restrict__ v2e_vals, int n_verts, int n_rings, int rd, int ru,
    float* __restrict__ ring_accum) {
  const int v = blockIdx.x * DEP_THREADS + threadIdx.x;
  if (v >= n_verts) return;
  const float s = incident_sum(counts, v2e_off, v2e_vals, v, 1, 0);
  for (int r = 0; r < n_rings; ++r)
    ring_accum[(size_t)v * n_rings + r] = (r == rd || r == ru) ? s : 0.0f;
}

// (E, R) counts: thread v·R + r sums counts[e, r] over v's elements
__global__ void __launch_bounds__(DEP_THREADS) deposit_rings_er_kernel(
    const int* __restrict__ counts, const int* __restrict__ v2e_off,
    const int* __restrict__ v2e_vals, int n_verts, int n_rings,
    float* __restrict__ ring_accum) {
  const long long t = (long long)blockIdx.x * DEP_THREADS + threadIdx.x;
  if (t >= (long long)n_verts * n_rings) return;
  const int v = (int)(t / n_rings);
  ring_accum[t] = incident_sum(counts, v2e_off, v2e_vals, v, n_rings,
                               (int)(t - (long long)v * n_rings));
}

// send_row_of (optional, with send): the owner reduction's send row of
// each vertex (-1 for none); the lane that writes out[u] writes the same
// value to send[send_row_of[u]] (kernel O's gather, fused: owner.cu)
template <int G>
__global__ void __launch_bounds__(DEP_THREADS) deposit_mapped_kernel(
    const float* __restrict__ ring_accum, const int* __restrict__ off,
    const int* __restrict__ src, int n_verts, int points_per_ring,
    float* __restrict__ out, const int* __restrict__ send_row_of,
    float* __restrict__ send) {
  const long long gid = (long long)blockIdx.x * DEP_THREADS + threadIdx.x;
  const int u = (int)(gid / G);
  const int lane = threadIdx.x % G;
  // groups past the last vertex still run: the shuffles take whole warps
  const int j1 = u < n_verts ? off[u + 1] : 0;
  const float p = (float)points_per_ring;
  float s = 0.0f;
  for (int j = (u < n_verts ? off[u] : 0) + lane; j < j1; j += G * DEP_ROUND2) {
    int a[DEP_ROUND2];
    float x[DEP_ROUND2];
#pragma unroll
    for (int k = 0; k < DEP_ROUND2; ++k)
      a[k] = j + k * G < j1 ? src[j + k * G] : 0;
#pragma unroll
    for (int k = 0; k < DEP_ROUND2; ++k)
      x[k] = j + k * G < j1 ? ring_accum[a[k]] : 0.0f;
#pragma unroll
    for (int k = 0; k < DEP_ROUND2; ++k)
      if (j + k * G < j1) s += x[k] / p;
  }
#pragma unroll
  for (int d = G / 2; d >= 1; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d, G);
  if (lane == 0 && u < n_verts) {
    out[u] = s;
    if (send_row_of != nullptr) {
      const int row = send_row_of[u];
      if (row >= 0) send[row] = s;
    }
  }
}

extern "C" int pp_deposit_rings(const int* counts, const int* v2e_off,
                                const int* v2e_vals, int n_verts, int n_rings,
                                int rd, int ru, float* ring_accum,
                                cudaStream_t stream) {
  if (n_verts <= 0) return (int)cudaGetLastError();
  deposit_rings_kernel<<<(n_verts + DEP_THREADS - 1) / DEP_THREADS, DEP_THREADS, 0,
                         stream>>>(counts, v2e_off, v2e_vals, n_verts, n_rings, rd, ru,
                                   ring_accum);
  return (int)cudaGetLastError();
}

// counts: (E, R) per-(element, ring) counts
extern "C" int pp_deposit_rings_er(const int* counts, const int* v2e_off,
                                   const int* v2e_vals, int n_verts,
                                   int n_rings, float* ring_accum,
                                   cudaStream_t stream) {
  if (n_verts <= 0 || n_rings <= 0) return (int)cudaGetLastError();
  const long long blocks =
      ((long long)n_verts * n_rings + DEP_THREADS - 1) / DEP_THREADS;
  deposit_rings_er_kernel<<<(unsigned)blocks, DEP_THREADS, 0, stream>>>(
      counts, v2e_off, v2e_vals, n_verts, n_rings, ring_accum);
  return (int)cudaGetLastError();
}

// send_row_of, send: null, or the (V,) send rows and the buffer they index
extern "C" int pp_deposit_mapped(const float* ring_accum, const int* off,
                                 const int* src, int n_verts,
                                 int points_per_ring, float* out,
                                 const int* send_row_of, float* send,
                                 cudaStream_t stream) {
  if (n_verts <= 0) return (int)cudaGetLastError();
  const long long blocks =
      ((long long)n_verts * DEPOSIT_GROUP + DEP_THREADS - 1) / DEP_THREADS;
  deposit_mapped_kernel<DEPOSIT_GROUP><<<(unsigned)blocks, DEP_THREADS, 0, stream>>>(
      ring_accum, off, src, n_verts, points_per_ring, out, send_row_of, send);
  return (int)cudaGetLastError();
}
