// Kernel S: the sorted rebuild's slot map, one thread per slot.
//
// Replaces (JAX reference): the per-slot arithmetic of _rebuild_sorted
// (pumipic_tpu/particles/structure.py:555-654): segment_offsets_of_slot
// (:563-577, two scatter-adds and two cumsums), the CabM cumulative-padding
// source (:579-602) and the SCS chunk, rank, local row and row_to_elem
// lookup (:603-638), up to src = order[min(src_pos0, M - 1)].
//
// For every slot j < C it writes src[j] (the sorted particle the slot
// takes), elem_c[j] (its clamped element) and pre_valid[j] = guard &
// (src_pos0 <= M - 1); the rebuild then gathers the particle's key (kernel
// G) and keeps the slot iff key == elem_c.
//
// The scatter-add + cumsum pair gives, at slot j, the number s of offsets
// offsets[1..S-1] at or below j and the segment start offsets[s] (empty
// segments repeat an offset and are skipped).  An upper bound over
// offsets[1..S-1] gives the same s exactly, so the kernel binary-searches
// the offsets in place of the two slot-rate passes.  CabM's cumulative pad
// at slot j is offsets[s] - start[s], so its source is start[s] + (j -
// offsets[s]), the same form as SCS's start[elem] + rank.
//
// What bounds it on an H100: device-memory bytes.  Per slot it reads one
// row_to_elem entry (SCS), one start entry and one order entry (random,
// 12 bytes) and writes 9 bytes; the offsets (<= 490 KB) stay in L2.  At
// about 12M slots: ~250 MB, >= 0.08 ms at 3.35 TB/s.  The ~17-step binary
// search per slot runs on cached offsets; neighbouring slots take the same
// path, so a warp's loads are broadcasts.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void slot_map_kernel(int cabm, const int* __restrict__ order,
                                const int* __restrict__ start,
                                const int* __restrict__ offsets, int n_seg,
                                const int* __restrict__ row_to_elem, int n_rows,
                                int chunk, int n_elems, long long C, int M,
                                int* __restrict__ src, int* __restrict__ elem_c,
                                uint8_t* __restrict__ pre_valid) {
  const long long needed = offsets[n_seg];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < C;
       j += stride) {
    // s = #{k in [1, n_seg - 1] : offsets[k] <= j}
    int lo = 1, hi = n_seg;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((long long)offsets[mid] <= j) lo = mid + 1; else hi = mid;
    }
    const int s = n_seg > 0 ? lo - 1 : 0;
    const int o = (int)(j - (n_seg > 0 ? offsets[s] : 0));
    int elem_j, rank;
    if (cabm) {
      elem_j = s;
      rank = o;
    } else {
      rank = o / chunk;
      const int local_row = o - rank * chunk;
      int row = s * chunk + local_row;
      if (row > n_rows - 1) row = n_rows - 1;
      elem_j = row_to_elem[row];
    }
    int ec = elem_j < 0 ? 0 : elem_j;
    if (ec > n_elems - 1) ec = n_elems - 1;
    const int src_pos0 = start[ec] + rank;
    const int src_pos = src_pos0 < M - 1 ? src_pos0 : M - 1;
    const bool guard = elem_j >= 0 && elem_j < n_elems && rank >= 0 && j < needed;
    src[j] = order[src_pos];
    elem_c[j] = ec;
    pre_valid[j] = (guard && src_pos0 <= M - 1) ? 1 : 0;
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

// cabm: 1 for the CabM layout (offsets are the (E+1,) element offsets,
// row_to_elem unused), 0 for SCS (offsets are the (nchunks+1,) chunk
// offsets, row_to_elem the (R,) row order).  n_seg = len(offsets) - 1 >= 1.
extern "C" int pp_slot_map(int cabm, const int* order, const int* start,
                           const int* offsets, int n_seg,
                           const int* row_to_elem, int n_rows, int chunk,
                           int n_elems, long long C, int M, int* src,
                           int* elem_c, uint8_t* pre_valid,
                           cudaStream_t stream) {
  if (n_seg < 1 || n_elems < 1 || M < 1 || (!cabm && (chunk < 1 || n_rows < 1)))
    return (int)cudaErrorInvalidValue;
  if (C <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (C + threads - 1) / threads;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  slot_map_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      cabm, order, start, offsets, n_seg, row_to_elem, n_rows, chunk, n_elems,
      C, M, src, elem_c, pre_valid);
  return (int)cudaGetLastError();
}
