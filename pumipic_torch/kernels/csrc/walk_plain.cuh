// The sparse plain walk's schedule, shared by kernel L (2D, locate.cu) and
// kernel L3 (3D, locate3d.cu): walk_plain_kernel<DIM, Step> walks the
// slots of a walker mask to the element holding each one's destination,
// Step::run taking one step of the file's own walk.
//
// Where few slots walk and the caller wants no output for the rest (the
// parent repair over kernel J's bad parents, in place into J's output; the
// picparts step's lost check, its counts alone), what bounds the walk is
// the mask's byte a slot, and a walker's destination, start, result and
// rows (from L2).  So:
// - A resident grid of warps scans the walker mask in chunks: 16 bytes a
//   lane (one load) where every warp gets a chunk, else one 32-slot row;
//   a slot that does not walk costs its mask byte.
// - A chunk's walkers go onto the warp's queue in shared memory in slot
//   order (each lane's popc and a warp scan); the warp scans on while
//   fewer than 32 wait.
// - Each lane walks its walker up to WP_ROUND steps with no warp-wide
//   operation between them; after each round the finished walkers store
//   their results together and idle lanes take the next walkers from the
//   queue, so neither a sparse warp nor one long walk holds idle lanes
//   while walkers wait.
// - Destinations are read only for walkers, from wherever they lie (an
//   (N, DIM) tensor's rows or columns of any stride, no copy).
// A walker's result does not depend on when or by which lane it is
// walked, so the outputs are deterministic.  Each walker takes at most
// `budget` steps and is deleted (elem -1) at the limit.  Counts: stats[0]
// <- the most steps a walker took (atomicMax), stats[1] <- walkers deleted
// at the limit, stats[2] <- walkers found (atomicAdd), one atomic per count
// and block, added to what stats holds.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WP_THREADS 256
#define WP_WARPS (WP_THREADS / 32)
#define WP_QUEUE (31 + 32 * 16)   // a warp's queue: < 32 waiting + a 512-slot chunk
#define WP_ROUND 16               // steps a walker takes between the warp's refills

// destination component c of particle i at p[c][i * s[c]]
template <int DIM>
struct WalkDest {
  const float* p[DIM];
  long long s[DIM];
};

namespace {

// Step::run(geom, elem, x): one step from elem toward the DIM coordinates
// x; true when the walker stops (inside: elem kept; an exposed side or
// face: elem = -1).  elem_out gets the walkers' results in place, or
// nothing where it is nullptr (the counts alone).  slots: mask bytes a lane
// scans per chunk, 16 (one 16-byte load) or 1.  n < 2^31.
template <int DIM, class Step>
__global__ void __launch_bounds__(WP_THREADS) walk_plain_kernel(
    WalkDest<DIM> dest, const int* __restrict__ elem_start,
    const uint8_t* __restrict__ walkers, const float* __restrict__ geom, int n_elems,
    int budget, int* __restrict__ elem_out, int slots, int* __restrict__ stats, int n) {
  __shared__ int s_queue[WP_WARPS][WP_QUEUE];
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int* q = s_queue[warp];
  const int chunk_len = 32 * slots;
  const int n_chunks = (int)(((long long)n + chunk_len - 1) / chunk_len);
  const int n_warps = gridDim.x * WP_WARPS;
  int chunk = blockIdx.x * WP_WARPS + warp;
  const bool vec = (reinterpret_cast<uintptr_t>(walkers) & 15) == 0;
  int head = 0, tail = 0;          // the warp's queue, the same in every lane
  int c_idx = -1, c_elem = 0, c_steps = 0;   // the lane's walker
  float c_x[DIM];
#pragma unroll
  for (int c = 0; c < DIM; ++c) c_x[c] = 0.0f;
  int my_max = 0, my_unf = 0, my_found = 0;
  for (;;) {
    // scan chunks while fewer than 32 walkers wait
    while (tail - head < 32 && chunk < n_chunks) {
      if (head != 0) {             // move the waiting walkers to the front
        const int avail = tail - head;
        const int v = lane < avail ? q[head + lane] : 0;
        __syncwarp();
        if (lane < avail) q[lane] = v;
        tail = avail;
        head = 0;
      }
      const int first = chunk * chunk_len + lane * slots;
      unsigned bits = 0;
      if (slots == 16 && vec && first + 16 <= n) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(walkers + first));
        const unsigned w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if ((w4[j] >> (8 * b)) & 0xffu) bits |= 1u << (4 * j + b);
          }
        }
      } else {
        for (int k = 0; k < slots && first + k < n; ++k) {
          if (walkers[first + k]) bits |= 1u << k;
        }
      }
      // the walkers onto the queue in slot order: a scan of the lanes' counts
      const int cnt = __popc(bits);
      int pre = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(FULL, pre, d);
        if (lane >= d) pre += t;
      }
      int pos = tail + pre - cnt;
      while (bits) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        q[pos++] = first + k;
      }
      tail += __shfl_sync(FULL, pre, 31);
      chunk += n_warps;
      __syncwarp();
    }
    // idle lanes take the next walkers in slot order
    const unsigned idle = __ballot_sync(FULL, c_idx < 0);
    const int avail = tail - head;
    const int rank = __popc(idle & below);
    if (c_idx < 0 && rank < avail) {
      c_idx = q[head + rank];
#pragma unroll
      for (int c = 0; c < DIM; ++c) c_x[c] = __ldg(dest.p[c] + (long long)c_idx * dest.s[c]);
      c_elem = min(max(elem_start[c_idx], 0), n_elems - 1);
      c_steps = 0;
    }
    head += min(__popc(idle), avail);
    const unsigned walking = __ballot_sync(FULL, c_idx >= 0);
    if (walking == 0) break;       // no walker, none waiting, no chunk left
    if (c_idx >= 0) {
      // up to WP_ROUND steps with no warp-wide operation between them
      bool done = false;
      for (int r = 0; r < WP_ROUND && c_steps < budget; ++r) {
        ++c_steps;
        if (Step::run(geom, c_elem, c_x)) {
          done = true;
          break;
        }
      }
      if (!done && c_steps >= budget) {   // loop limit: delete the walker
        c_elem = -1;
        ++my_unf;
        done = true;
      }
      if (done) {                  // the round's finished walkers store together
        if (elem_out != nullptr) elem_out[c_idx] = c_elem;
        my_found += c_elem >= 0 ? 1 : 0;
        my_max = max(my_max, c_steps);
        c_idx = -1;
      }
    }
  }
  // block reduction, then one atomic per count and block
  my_max = __reduce_max_sync(FULL, my_max);
  my_unf = __reduce_add_sync(FULL, my_unf);
  my_found = __reduce_add_sync(FULL, my_found);
  __shared__ int s_red[3][WP_WARPS];
  if (lane == 0) {
    s_red[0][warp] = my_max;
    s_red[1][warp] = my_unf;
    s_red[2][warp] = my_found;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bm = 0, bu = 0, bf = 0;
    for (int w = 0; w < WP_WARPS; ++w) {
      bm = max(bm, s_red[0][w]);
      bu += s_red[1][w];
      bf += s_red[2][w];
    }
    if (bm > 0) atomicMax(&stats[0], bm);
    if (bu > 0) atomicAdd(&stats[1], bu);
    if (bf > 0) atomicAdd(&stats[2], bf);
  }
}

// Launch walk_plain_kernel<DIM, Step> on a resident grid (at most one
// wave); the walkers' results into elem_out (or nothing where it is
// nullptr), the counts added into stats[0..2].
template <int DIM, class Step>
int walk_plain_launch(WalkDest<DIM> dest, const int* elem_start, const uint8_t* walkers,
                      const float* geom, int n_elems, int max_iters, int* elem_out,
                      int* stats, long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_plain_kernel<DIM, Step>,
                                                  WP_THREADS, 0);
    resident = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  long long blocks = (n + WP_THREADS - 1) / WP_THREADS;
  if (blocks > resident) blocks = resident;
  // 16 bytes a lane where every warp gets a chunk (a sparse mask read in
  // wide loads), else one 32-slot row a chunk
  const int slots = (n + 511) / 512 >= blocks * WP_WARPS ? 16 : 1;
  walk_plain_kernel<DIM, Step><<<(unsigned)blocks, WP_THREADS, 0, stream>>>(
      dest, elem_start, walkers, geom, n_elems, max(max_iters, 0), elem_out, slots, stats,
      (int)n);
  return (int)cudaGetLastError();
}

}  // namespace
