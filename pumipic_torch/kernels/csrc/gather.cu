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
// What bounds it on an H100: device-memory bytes.  Each output lane is
// written once (4 bytes) and each index read once (4 bytes); the source
// lanes are read at random rows (at T2's shape, 24,576 x 14 f32 = 1.4 MB,
// the table stays in the 50 MB L2).  At T2's probe shape, 10M indices:
// 40 MB in and 560 MB out, >= 0.18 ms at 3.35 TB/s.
//
// Design: a block takes a tile of 256 rows, loads their indices once into
// shared memory (one coalesced load per row), then for each array walks the
// tile's rows x lanes in flat order, so neighbouring threads write
// neighbouring addresses of the output and read the contiguous lanes of one
// source row.  Indices must lie in [0, M); the kernel does not check them.
#include <cuda_runtime.h>
#include <stdint.h>

#define G_MAX_ARRAYS 16
#define G_TILE_ROWS 256

struct GatherArrays {
  const uint32_t* src[G_MAX_ARRAYS];
  uint32_t* dst[G_MAX_ARRAYS];
  int width[G_MAX_ARRAYS];
  int n;
};

__global__ void row_gather_kernel(const int* __restrict__ idx, long long n_rows,
                                  GatherArrays a) {
  __shared__ int s_idx[G_TILE_ROWS];
  const long long n_tiles = (n_rows + G_TILE_ROWS - 1) / G_TILE_ROWS;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long r0 = t * G_TILE_ROWS;
    const long long left = n_rows - r0;
    const int rows = left < G_TILE_ROWS ? (int)left : G_TILE_ROWS;
    __syncthreads();  // the previous tile's readers of s_idx are done
    for (int r = threadIdx.x; r < rows; r += blockDim.x) s_idx[r] = idx[r0 + r];
    __syncthreads();
    for (int j = 0; j < a.n; ++j) {
      const int w = a.width[j];
      const uint32_t* __restrict__ src = a.src[j];
      uint32_t* __restrict__ dst = a.dst[j] + r0 * w;
      if (w == 1) {
        for (int r = threadIdx.x; r < rows; r += blockDim.x)
          dst[r] = src[s_idx[r]];
      } else {
        const int lanes = rows * w;
        for (int p = threadIdx.x; p < lanes; p += blockDim.x) {
          const int r = p / w;
          const int l = p - r * w;
          dst[p] = src[(long long)s_idx[r] * w + l];
        }
      }
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

// srcs/dsts: n_arrays pointers each (host arrays), widths: lanes per row.
extern "C" int pp_row_gather(const int* idx, long long n_rows, int n_arrays,
                             const void* const* srcs, void* const* dsts,
                             const int* widths, cudaStream_t stream) {
  if (n_arrays < 1 || n_arrays > G_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return (int)cudaGetLastError();
  GatherArrays a;
  a.n = n_arrays;
  for (int j = 0; j < n_arrays; ++j) {
    if (widths[j] < 1) return (int)cudaErrorInvalidValue;
    a.src[j] = static_cast<const uint32_t*>(srcs[j]);
    a.dst[j] = static_cast<uint32_t*>(dsts[j]);
    a.width[j] = widths[j];
  }
  const int threads = 256;
  long long blocks = (n_rows + G_TILE_ROWS - 1) / G_TILE_ROWS;
  const long long cap = (long long)num_sms() * 8;
  if (blocks > cap) blocks = cap;
  row_gather_kernel<<<(unsigned)blocks, threads, 0, stream>>>(idx, n_rows, a);
  return (int)cudaGetLastError();
}
