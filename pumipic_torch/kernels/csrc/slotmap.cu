// Kernel S: the sorted rebuild's slot map, one block per tile of slots.
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
// offsets[1..S-1] gives the same s exactly.  CabM's cumulative pad at slot
// j is offsets[s] - start[s], so its source is start[s] + (j - offsets[s]),
// the same form as SCS's start[elem] + rank.  Slots past needed =
// offsets[S] search to segment S - 1 like any other, with ranks running
// on: the tail needs no pass of its own and no size from the host.
//
// What bounds it on an H100: device-memory bytes.  Per slot it writes 9
// bytes and reads one order entry (each about once: ranks of one element
// are consecutive); start, row_to_elem and offsets (<= 490 KB) stay in
// L1/L2.  At 12M slots ~150 MB, 0.047 ms at 3.35 TB/s.
//
// Design.  A binary search of the whole offsets array per slot (14-17
// dependent loads) holds a kernel to that chain's latency, and one slot a
// thread to 1-byte stores and, for SCS, warps that gather order from 8
// rows' runs (measured: 27-29% of the byte bound, 43-55% without the
// search; PERF.md).  So a block takes SLOT_TILE consecutive slots (256
// threads of 4 slots; 8 slots a thread, or 128 or 512 threads, measured
// slower):
//  1. warps 0 and 1 find the segments s0 and s1 of the tile's first and
//     last slot, each with 32 probes a round (at most 5 rounds below 2^25
//     segments), so one search serves SLOT_TILE slots;
//  2. the block stages offsets[s0..s1] in shared memory (a few entries:
//     a tile spans ~2 SCS chunks or ~11 CabM elements at 12M slots); a
//     window of more than WINDOW_CAP entries (many empty segments) is read
//     in place from device memory through the same code;
//  3. each thread takes SLOTS_PER_THREAD consecutive slots: a search of
//     the window for the first, and for a later slot only where it enters
//     a later segment (a search of the rest of the window, so a run of
//     empty segments costs a few steps), then the row_to_elem, start and
//     order loads of all its slots in flight together, and its outputs as
//     16-byte stores (pre_valid as 32-bit words).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SLOT_THREADS 256
#define SLOTS_PER_THREAD 4
#define WINDOW_CAP 1024
#define SLOT_TILE (SLOT_THREADS * SLOTS_PER_THREAD)

static_assert(SLOT_THREADS % 32 == 0 && SLOT_THREADS >= 64, "two searching warps");
static_assert(SLOTS_PER_THREAD % 4 == 0, "slots are stored four at a time");

// The first k in [lo, hi) with off[k] > j, or hi: the whole warp searches,
// lane l probing lo + l·step each round (off is non-decreasing, so the
// probes at or below j are the first c lanes).
__device__ int warp_upper_bound(const int* __restrict__ off, int lo, int hi,
                                long long j) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const bool le = p < hi && (long long)__ldg(off + p) <= j;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    if (c == 0) return lo;
    const int above = lo + c * step;       // probe c: off > j, where < hi
    lo += (c - 1) * step + 1;
    if (above < hi) hi = above;
  }
  return lo;
}

// The first k in [lo, hi) with w[k - base] > j, or hi (one thread).
__device__ __forceinline__ int upper_bound(const int* w, int base, int lo, int hi,
                                           long long j) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)w[mid - base] <= j) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(SLOT_THREADS) slot_map_kernel(
    int cabm, const int* __restrict__ order, const int* __restrict__ start,
    const int* __restrict__ offsets, int n_seg,
    const int* __restrict__ row_to_elem, int n_rows, int chunk, int n_elems,
    long long C, int M, int* __restrict__ src, int* __restrict__ elem_c,
    uint8_t* __restrict__ pre_valid) {
  __shared__ int s_bounds[2];
  __shared__ int s_window[WINDOW_CAP];
  const long long t0 = (long long)blockIdx.x * SLOT_TILE;
  const long long t_last = (t0 + SLOT_TILE < C ? t0 + SLOT_TILE : C) - 1;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    // s = #{k in [1, n_seg - 1] : offsets[k] <= j}
    const int s = warp_upper_bound(offsets, 1, n_seg, warp == 0 ? t0 : t_last) - 1;
    if ((threadIdx.x & 31) == 0) s_bounds[warp] = s;
  }
  __syncthreads();
  const int s0 = s_bounds[0], s1 = s_bounds[1];
  const int n_win = s1 - s0 + 1;
  const int* win = offsets + s0;           // win[k - s0] = offsets[k]
  if (n_win <= WINDOW_CAP) {               // the same for the whole block
    for (int k = threadIdx.x; k < n_win; k += SLOT_THREADS)
      s_window[k] = offsets[s0 + k];
    __syncthreads();
    win = s_window;
  }
  const long long j0 = t0 + (long long)threadIdx.x * SLOTS_PER_THREAD;
  if (j0 >= C) return;
  const long long needed = offsets[n_seg];

  // the segment of j0: the last k in [s0, s1] with offsets[k] <= j0
  int s = upper_bound(win, s0, s0 + 1, s1 + 1, j0) - 1;

  // each slot's element and rank (slots past C are computed, not stored:
  // every index below is clamped)
  int elem_j[SLOTS_PER_THREAD], rank[SLOTS_PER_THREAD];
#pragma unroll
  for (int u = 0; u < SLOTS_PER_THREAD; ++u) {
    const long long j = j0 + u;
    if (s < s1 && (long long)win[s + 1 - s0] <= j)   // a later segment
      s = upper_bound(win, s0, s + 2, s1 + 1, j) - 1;
    const int o = (int)(j - win[s - s0]);
    if (cabm) {
      elem_j[u] = s;
      rank[u] = o;
    } else {
      rank[u] = o / chunk;
      int row = s * chunk + (o - rank[u] * chunk);
      if (row > n_rows - 1) row = n_rows - 1;
      elem_j[u] = __ldg(row_to_elem + row);
    }
  }
  int ec[SLOTS_PER_THREAD], pos0[SLOTS_PER_THREAD];
#pragma unroll
  for (int u = 0; u < SLOTS_PER_THREAD; ++u) {
    int e = elem_j[u] < 0 ? 0 : elem_j[u];
    ec[u] = e > n_elems - 1 ? n_elems - 1 : e;
    pos0[u] = __ldg(start + ec[u]) + rank[u];
  }
  int sv[SLOTS_PER_THREAD];
  uint32_t pv[SLOTS_PER_THREAD];
#pragma unroll
  for (int u = 0; u < SLOTS_PER_THREAD; ++u) {
    sv[u] = __ldg(order + (pos0[u] < M - 1 ? pos0[u] : M - 1));
    const bool guard = elem_j[u] >= 0 && elem_j[u] < n_elems && rank[u] >= 0 &&
                       j0 + u < needed;
    pv[u] = (guard && pos0[u] <= M - 1) ? 1u : 0u;
  }

  if (j0 + SLOTS_PER_THREAD <= C) {
#pragma unroll
    for (int q = 0; q < SLOTS_PER_THREAD; q += 4) {
      *reinterpret_cast<int4*>(src + j0 + q) = make_int4(sv[q], sv[q + 1], sv[q + 2], sv[q + 3]);
      *reinterpret_cast<int4*>(elem_c + j0 + q) =
          make_int4(ec[q], ec[q + 1], ec[q + 2], ec[q + 3]);
      *reinterpret_cast<uint32_t*>(pre_valid + j0 + q) =
          pv[q] | (pv[q + 1] << 8) | (pv[q + 2] << 16) | (pv[q + 3] << 24);
    }
  } else {
#pragma unroll
    for (int u = 0; u < SLOTS_PER_THREAD; ++u) {
      if (j0 + u < C) {
        src[j0 + u] = sv[u];
        elem_c[j0 + u] = ec[u];
        pre_valid[j0 + u] = (uint8_t)pv[u];
      }
    }
  }
}

// cabm: 1 for the CabM layout (offsets are the (E+1,) element offsets,
// row_to_elem unused), 0 for SCS (offsets are the (nchunks+1,) chunk
// offsets, row_to_elem the (R,) row order).  n_seg = len(offsets) - 1 >= 1.
// src and elem_c must be 16-byte aligned and pre_valid 4-byte aligned (as
// fresh allocations are).
extern "C" int pp_slot_map(int cabm, const int* order, const int* start,
                           const int* offsets, int n_seg,
                           const int* row_to_elem, int n_rows, int chunk,
                           int n_elems, long long C, int M, int* src,
                           int* elem_c, uint8_t* pre_valid,
                           cudaStream_t stream) {
  if (n_seg < 1 || n_elems < 1 || M < 1 || (!cabm && (chunk < 1 || n_rows < 1)))
    return (int)cudaErrorInvalidValue;
  if (C <= 0) return (int)cudaGetLastError();
  if ((((uintptr_t)src | (uintptr_t)elem_c) & 15) || ((uintptr_t)pre_valid & 3))
    return (int)cudaErrorMisalignedAddress;
  const long long blocks = (C + SLOT_TILE - 1) / SLOT_TILE;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  slot_map_kernel<<<(unsigned)blocks, SLOT_THREADS, 0, stream>>>(
      cabm, order, start, offsets, n_seg, row_to_elem, n_rows, chunk, n_elems,
      C, M, src, elem_c, pre_valid);
  return (int)cudaGetLastError();
}
