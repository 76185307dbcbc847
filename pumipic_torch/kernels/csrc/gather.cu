// Kernel G: row gather, out[i, :] = table[idx[i], :] over 4-byte lanes.
//
// Replaces (TPU kernel T2): perf/pallas_gather_ab.py row_dma_gather (:43,
// pallas_call at :72), one async row copy per index with 16 in flight, and
// the packed-row gather it was written for, _gather_fields
// (pumipic_tpu/particles/structure.py:363-415), which rebuild uses to move
// every particle field to its new slot.
//
// Two entry forms share one kernel.  (a) rows: one (M, W) table, as T2 has
// it.  (b) columns: up to 16 arrays (M, w_j) that share the index.  The JAX
// package concatenates every 4-byte field into one (M, W) pack only to cut
// the TPU's fixed cost per gather; on this card the concat and the split
// would move about twice the field bytes again, so the rebuild hands its
// fields over in place, the key lane as one more array.  Lanes are moved as
// 32-bit words: f32 and i32 payloads keep their bits.
//
// What bounds it on an H100: device-memory sectors, not bytes.  Outputs and
// indices stream (each output lane written once, each index read once), but
// a source row read at a scattered position costs a whole 32-byte sector of
// each array, however few of its bytes the row uses: the rebuild's arrays
// (x and xtgt 2 lanes each, pid, b, phi, key, ...) cost a sector each,
// 32 bytes per 4 or 8 useful.  The app's own orders scatter its 12M slots
// over the chunks; at a random order the six arrays' 2.7 GB of sectors
// take 0.82 ms at 3.35 TB/s against a byte bound of 0.24 ms.  At T2's
// shape (24,576 x 14 f32, 1.4 MB) the table stays in the 50 MB L2 and the
// 560 MB output bounds it.
//
// Schedule: array-major, on a persistent grid of as many blocks as the SMs
// hold at once.  Each array is moved in units of 8 bytes (two lanes) where
// its width and alignment allow, else of 4.  A warp takes 32·4 consecutive
// units of the flattened output, each lane the units lane, lane + 32, ...,
// so that every store instruction of the warp writes 128 or 256 contiguous
// bytes, and the lanes of one wide source row are read by neighbouring
// lanes.  A lane issues its four index loads, then its four source loads
// (read-only path, ld.global.nc), then its four streaming stores
// (st.global.cs, evicted first, so that the outputs leave the L2 to the
// sources).  A pass sweeps one whole array, so that only its source
// (48-96 MB at 12M slots) competes for the L2 while its sectors are
// reused; the index is read once per array.  Measured against other
// orders (PERF.md): all arrays of a row at once, passes over 1M-row chunks,
// and a persisting-L2 window on each pass's source were slower at the
// app's orders.  Indices must lie in [0, M); the kernel does not check
// them.
#include <cuda_runtime.h>
#include <stdint.h>

#define G_MAX_ARRAYS 16
#define G_UNITS 4      // units per lane per warp tile
#define G_THREADS 256

struct GatherArrays {
  const uint32_t* src[G_MAX_ARRAYS];
  uint32_t* dst[G_MAX_ARRAYS];
  int units_per_row[G_MAX_ARRAYS];
  int pairs[G_MAX_ARRAYS];   // 1: units of two lanes (8 bytes), 0: of one
  int n;
};

// one array: output unit p = row·upr + l takes source unit idx[row]·upr + l
template <typename T>
__device__ __forceinline__ void sweep(const T* __restrict__ src, T* __restrict__ dst,
                                      const int* __restrict__ idx, long long n_units,
                                      int upr, long long warp, long long n_warps, int lane) {
  for (long long base = warp * (32 * G_UNITS); base < n_units;
       base += n_warps * (32 * G_UNITS)) {
    int s[G_UNITS], l[G_UNITS];
#pragma unroll
    for (int k = 0; k < G_UNITS; ++k) {
      const long long p = base + lane + 32 * k;
      const long long row = upr > 1 ? p / upr : p;
      l[k] = (int)(p - row * upr);
      if (p < n_units) s[k] = __ldg(idx + row);
    }
    T v[G_UNITS];
#pragma unroll
    for (int k = 0; k < G_UNITS; ++k)
      if (base + lane + 32 * k < n_units)
        v[k] = __ldg(src + (long long)s[k] * upr + l[k]);
#pragma unroll
    for (int k = 0; k < G_UNITS; ++k) {
      const long long p = base + lane + 32 * k;
      if (p < n_units) __stcs(dst + p, v[k]);
    }
  }
}

__global__ void __launch_bounds__(G_THREADS)
    row_gather_kernel(const int* __restrict__ idx, long long n_rows, GatherArrays a) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (int j = 0; j < a.n; ++j) {
    const long long n_units = n_rows * a.units_per_row[j];
    if (a.pairs[j])
      sweep(reinterpret_cast<const uint2*>(a.src[j]), reinterpret_cast<uint2*>(a.dst[j]),
            idx, n_units, a.units_per_row[j], warp, n_warps, lane);
    else
      sweep(a.src[j], a.dst[j], idx, n_units, a.units_per_row[j], warp, n_warps, lane);
  }
}

// blocks of the persistent grid: as many as the SMs hold at once
static long long grid_blocks() {
  static long long blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_gather_kernel, G_THREADS, 0);
    blocks = (long long)(sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

// srcs/dsts: n_arrays pointers each (host arrays), widths: lanes per row
extern "C" int pp_row_gather(const int* idx, long long n_rows, int n_arrays,
                             const void* const* srcs, void* const* dsts,
                             const int* widths, cudaStream_t stream) {
  if (n_arrays < 1 || n_arrays > G_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  GatherArrays a = {};
  a.n = n_arrays;
  for (int j = 0; j < n_arrays; ++j) {
    const uintptr_t sp = reinterpret_cast<uintptr_t>(srcs[j]);
    const uintptr_t dp = reinterpret_cast<uintptr_t>(dsts[j]);
    const int w = widths[j];
    if (w < 1 || sp % 4 || dp % 4) return (int)cudaErrorInvalidValue;
    a.src[j] = static_cast<const uint32_t*>(srcs[j]);
    a.dst[j] = static_cast<uint32_t*>(dsts[j]);
    a.pairs[j] = w % 2 == 0 && sp % 8 == 0 && dp % 8 == 0;
    a.units_per_row[j] = a.pairs[j] ? w / 2 : w;
  }
  long long blocks = (n_rows + G_THREADS - 1) / G_THREADS;
  if (blocks > grid_blocks()) blocks = grid_blocks();
  row_gather_kernel<<<(unsigned)blocks, G_THREADS, 0, stream>>>(idx, n_rows, a);
  return (int)cudaGetLastError();
}
