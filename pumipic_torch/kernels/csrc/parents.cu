// Kernel J: check_parents, the parent check of the unified 2D/3D driver in
// one pass over the particles.
//
// Replaces (JAX reference): the device part of check_initial_parents
// (pumipic_tpu/ops/search.py:1527-1595): the containment test of each
// particle's origin in its claimed parent with the walk's BCC core
// (_core_2d / _core_3d_bcc, :247-257, on walk_geom rows), the in_table /
// e_safe / bad / num_bad lines and the "delete" mode's where.  The TPU ran
// them as one jitted computation; the port's first version ran them as ~40
// torch launches (kernel G's (N, 12) row gather, the test on strided
// columns of the gathered rows, elementwise ops, two column copies).  No
// Pallas kernel of the TPU build corresponds: XLA compiled this code.
//
// Per particle, in one thread:
//   in_table = 0 <= e < E,  e_safe = clamp(e, 0, E-1),
//   inside   = the tolerance-relative BCC test of the origin in e_safe's
//              affine rows (2D: the 6 floats of its 32-byte parent row,
//              3D: the first 12 of its 64-byte walk_geom row),
//              in bary_inside's / bary_inside_3d's order of f32 operations
//              (3D sums left to right),
//   bad      = active && (!inside || !in_table),
//   elem     = active && !bad ? e_safe : -1,
// and bad_out[i] = bad where the caller asks for the mask (the repair walk's
// walkers: kernel L's or L3's plain walk in place).  num_bad is summed per block and
// added with one atomic per block into stats[3] (the repair walk adds its
// own counts into stats[0..2]); the launcher zeroes all four first.
//
// What bounds it on an H100: device-memory bytes.  Per particle 13 bytes in
// (the claimed parent, the active byte, the 2D origin; 17 in 3D) and 5 out
// (4 without the mask); the rows are read from L2.  Inactive particles read
// neither origin nor row.  The origin is read where it lies: (N, dim) rows
// or per-component columns of any stride, so no copy precedes the launch.
// In 2D the rows are search.parent_rows: walk_geom's 6 affine floats and 2
// pads, 32 bytes a row (3.9 MB on the 120k mesh), so a particle's test
// reads one L2 sector; in walk_geom's 48-byte rows every odd row's 24
// affine bytes span two.  Measured (PERF.md §6): no change at the
// seeding's order or after one 2D path call, 23% less time at the order
// five path calls leave (parents scattered against slots) and in the
// path; why the sectors bind at that order only is open.  3D reads 48
// bytes of its aligned 64-byte walk_geom rows (two sectors).
//
// Design: a grid of as many blocks as the SMs hold at once, each thread
// taking J_ITEMS particles a sweep (their loads issued before the dependent
// row loads), so that the count costs one atomic a block.  Built with
// -fmad=false so every containment test rounds as the plain PyTorch
// version's separate ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define J_REL_TOL 4.76837158203125e-07f  // 8 * 2^-24
#define J_ABS_TOL 1e-7f
#define J_THREADS 256
#define J_ITEMS 4

namespace {

// the origin's components: pointer and stride (in floats) of each
struct Origin {
  const float* p[3];
  long long s[3];
};

__device__ __forceinline__ bool inside_2d(const float* __restrict__ row, float x,
                                          float y) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float2 b = __ldg(reinterpret_cast<const float2*>(row + 4));
  const float l1 = a.x * x + a.y * y + a.z;
  const float l2 = a.w * x + b.x * y + b.y;
  const float w0 = 1.0f - l1 - l2;
  const float m1 = fabsf(a.x * x) + fabsf(a.y * y) + fabsf(a.z);
  const float m2 = fabsf(a.w * x) + fabsf(b.x * y) + fabsf(b.y);
  const float t1 = J_REL_TOL * m1 + J_ABS_TOL;
  const float t2 = J_REL_TOL * m2 + J_ABS_TOL;
  return (w0 >= -(t1 + t2)) && (l1 >= -t1) && (l2 >= -t2);
}

__device__ __forceinline__ float affine3(const float4 a, float x, float y, float z) {
  return a.x * x + a.y * y + a.z * z + a.w;
}

__device__ __forceinline__ float mag3(const float4 a, float x, float y, float z) {
  return fabsf(a.x * x) + fabsf(a.y * y) + fabsf(a.z * z) + fabsf(a.w);
}

__device__ __forceinline__ bool inside_3d(const float* __restrict__ row, float x,
                                          float y, float z) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 a = __ldg(r4), b = __ldg(r4 + 1), c = __ldg(r4 + 2);
  const float l1 = affine3(a, x, y, z);
  const float l2 = affine3(b, x, y, z);
  const float l3 = affine3(c, x, y, z);
  const float w0 = 1.0f - l1 - l2 - l3;
  const float t1 = J_REL_TOL * mag3(a, x, y, z) + J_ABS_TOL;
  const float t2 = J_REL_TOL * mag3(b, x, y, z) + J_ABS_TOL;
  const float t3 = J_REL_TOL * mag3(c, x, y, z) + J_ABS_TOL;
  return (w0 >= -(t1 + t2 + t3)) && (l1 >= -t1) && (l2 >= -t2) && (l3 >= -t3);
}

template <int DIM>
__global__ void __launch_bounds__(J_THREADS) check_parents_kernel(
    const int* __restrict__ elem_init, const uint8_t* __restrict__ active,
    Origin o, const float* __restrict__ geom, int row_w, int n_elems,
    int* __restrict__ elem_out, uint8_t* __restrict__ bad_out,
    int* __restrict__ stats, long long n) {
  int my_bad = 0;
  const long long sweep = (long long)gridDim.x * J_THREADS * J_ITEMS;
  for (long long base = (long long)blockIdx.x * J_THREADS * J_ITEMS + threadIdx.x;
       base < n; base += sweep) {
    int e[J_ITEMS];
    bool a[J_ITEMS];
    float x[J_ITEMS][DIM];
#pragma unroll
    for (int k = 0; k < J_ITEMS; ++k) {
      const long long i = base + (long long)k * J_THREADS;
      a[k] = i < n && active[i] != 0;
      e[k] = i < n ? elem_init[i] : 0;
#pragma unroll
      for (int d = 0; d < DIM; ++d) x[k][d] = a[k] ? o.p[d][i * o.s[d]] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < J_ITEMS; ++k) {
      const long long i = base + (long long)k * J_THREADS;
      if (i >= n) break;
      const bool in_table = e[k] >= 0 && e[k] < n_elems;
      const int e_safe = min(max(e[k], 0), n_elems - 1);
      bool bad = false;
      if (a[k]) {
        const float* row = geom + (size_t)e_safe * row_w;
        bool inside;
        if (DIM == 2) {
          inside = inside_2d(row, x[k][0], x[k][1]);
        } else {
          inside = inside_3d(row, x[k][0], x[k][1], x[k][DIM - 1]);
        }
        bad = !inside || !in_table;
      }
      elem_out[i] = (a[k] && !bad) ? e_safe : -1;
      if (bad_out != nullptr) bad_out[i] = bad ? 1 : 0;
      my_bad += bad ? 1 : 0;
    }
  }
  // block sum, then one atomic per block
  my_bad = __reduce_add_sync(0xffffffffu, my_bad);
  __shared__ int s_bad[J_THREADS / 32];
  if ((threadIdx.x & 31) == 0) s_bad[threadIdx.x >> 5] = my_bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = 0;
    for (int w = 0; w < J_THREADS / 32; ++w) b += s_bad[w];
    if (b > 0) atomicAdd(&stats[3], b);
  }
}

int resident_blocks(const void* fn) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, J_THREADS, 0);
  if (sms <= 0) sms = 132;
  if (per_sm <= 0) per_sm = 1;
  return sms * per_sm;
}

}  // namespace

// dim 2 or 3; origin: dim component pointers and strides (in floats);
// geom: (E, row_w) rows whose affine part comes first, 16-byte aligned (2D:
// parent_rows, row_w 8, 32-byte rows; 3D: walk_geom, row_w 16); bad_out may
// be nullptr ("delete" mode).  stats: four ints, zeroed here; stats[3] <-
// num_bad.
extern "C" int pp_check_parents(
    int dim, const int* elem_init, const uint8_t* active, const float* const* origin,
    const long long* strides, const float* geom, int row_w, int n_elems,
    int* elem_out, uint8_t* bad_out, int* stats, long long n, cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(stats, 0, 4 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  Origin o;
  for (int d = 0; d < 3; ++d) {
    o.p[d] = d < dim ? origin[d] : nullptr;
    o.s[d] = d < dim ? strides[d] : 0;
  }
  const void* fn = dim == 2 ? (const void*)check_parents_kernel<2>
                            : (const void*)check_parents_kernel<3>;
  static int cap[2] = {0, 0};
  int& c = cap[dim == 2 ? 0 : 1];
  if (c == 0) c = resident_blocks(fn);
  long long blocks = (n + (long long)J_THREADS * J_ITEMS - 1) / ((long long)J_THREADS * J_ITEMS);
  if (blocks > c) blocks = c;
  if (dim == 2) {
    check_parents_kernel<2><<<(unsigned)blocks, J_THREADS, 0, stream>>>(
        elem_init, active, o, geom, row_w, n_elems, elem_out, bad_out, stats, n);
  } else {
    check_parents_kernel<3><<<(unsigned)blocks, J_THREADS, 0, stream>>>(
        elem_init, active, o, geom, row_w, n_elems, elem_out, bad_out, stats, n);
  }
  return (int)cudaGetLastError();
}
