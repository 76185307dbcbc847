// Kernels X1, X2, X3: the particle exchange of the distributed step.
//
// Replace the JAX package's jitted migration bookkeeping
// (pumipic_tpu/parallel/migrate.py), which XLA fuses into one program and
// the port ran as dozens of torch ops with scatters through a sort order:
//
//  X1 rank_in_key   _bucket_ranks (:302-316), the balancer's
//                   rank_within_key (balancer.py:267) and the counts of a
//                   key (the port's key_counts): each item's stable rank
//                   among the items of its key, in index order (what a
//                   stable argsort gives), and the count of every key.
//  X2 pack_send     _slots_from_ranks, _pack_payload and _fill_send
//                   (:319-383): each admitted leaver writes its row (gid,
//                   then every member field as int32 lanes, floats as
//                   their bits) straight into its send-buffer row
//                   offsets[bucket] + rank; non-leavers write nothing.
//  X3 place_arrivals gid_to_lid (:153-160) and _place_arrivals (:386-438):
//                   arrivals resolve their global element ids by binary
//                   search and fill the free slots in ascending slot order,
//                   in arrival order; one pass writes every output field.
//
// What bounds them on an H100: bytes.  Each reads its (N,) inputs once and
// writes its outputs once (X1's rank pass reads its keys a second time);
// the arithmetic is a few integer operations an item.  Every output is an
// integer or a moved bit pattern, so each equals its plain version bit for
// bit.
//
// X1's design: a tile of X1_TILE items per block of X1_WARPS warps, warp w
// holding items [w·128, (w+1)·128) of the tile in four chunks of 32 lanes.
// Launch 1 ranks the items inside the tile: the warps take turns in index
// order (a __syncthreads between turns), and in its turn a warp ranks each
// chunk by __match_any_sync (lanes of one key) and the popcount of the
// lower lanes of its key, on top of a per-key counter in shared memory that
// the highest lane of each key then advances; it writes the in-tile ranks
// and the tile's count of each key, key-major (key·n_tiles + tile).
// Launch 2 scans each key's row of tile counts (one block a key): the
// exclusive prefix is the rank base of that key in each tile, the total the
// key's count.  Launch 3 adds the base to each item's in-tile rank.  Keys
// outside [0, n_keys) are counted in one more row (the wrapper refuses
// them) and get rank -1.  The counts-only form skips the ordered turns and
// launch 3.
#include <cuda_runtime.h>
#include <stdint.h>

#define X1_WARPS 8
#define X1_CHUNKS 4
#define X1_THREADS (32 * X1_WARPS)
#define X1_TILE (X1_THREADS * X1_CHUNKS)
#define X1_SCAN_THREADS 1024
#define X1_MAX_KEYS (48 * 1024 / 4 - 1)   // keys a tile's shared table holds
#define X_THREADS 256
#define X_MAX_FIELDS 16
#define X3_THREADS 1024

// ---------------------------------------------------------------------------
// X1: rank within key
// ---------------------------------------------------------------------------

// inclusive scan of v over the block (blockDim.x a multiple of 32); the
// block's total in *total; smem holds 32 ints
__device__ int block_inclusive_scan(int v, int* smem, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? smem[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    smem[lane] = s;
  }
  __syncthreads();
  const int out = x + (warp > 0 ? smem[warp - 1] : 0);
  *total = smem[n_warps - 1];
  __syncthreads();
  return out;
}

// launch 1: in-tile ranks and the tile's count of each key (row n_keys:
// keys out of range)
__global__ void __launch_bounds__(X1_THREADS)
    x1_tile(const int* __restrict__ key, long long n, int n_keys, int want_rank,
            int* __restrict__ rank, int* __restrict__ tile_counts, int n_tiles) {
  extern __shared__ int cnt[];   // n_keys + 1
  for (int k = threadIdx.x; k <= n_keys; k += blockDim.x) cnt[k] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long first = (long long)blockIdx.x * X1_TILE + (long long)warp * 32 * X1_CHUNKS;
  int k[X1_CHUNKS];
#pragma unroll
  for (int c = 0; c < X1_CHUNKS; ++c) {
    const long long i = first + c * 32 + lane;
    k[c] = -1;                                    // past the end: no key
    if (i < n) {
      const int v = key[i];
      k[c] = (v < 0 || v >= n_keys) ? n_keys : v;
    }
  }
  if (!want_rank) {
    // counts only: every warp at once, one shared atomic per key a chunk
#pragma unroll
    for (int c = 0; c < X1_CHUNKS; ++c) {
      const unsigned m = __match_any_sync(0xffffffffu, k[c]);
      if (k[c] >= 0 && lane == 31 - __clz(m)) atomicAdd(&cnt[k[c]], __popc(m));
    }
  } else {
    for (int w = 0; w < X1_WARPS; ++w) {
      if (warp == w) {
#pragma unroll
        for (int c = 0; c < X1_CHUNKS; ++c) {
          const unsigned m = __match_any_sync(0xffffffffu, k[c]);
          const long long i = first + c * 32 + lane;
          int base = 0;
          if (k[c] >= 0) base = cnt[k[c]];
          __syncwarp();
          if (k[c] >= 0) {
            rank[i] = k[c] < n_keys ? base + __popc(m & lower) : -1;
            if (lane == 31 - __clz(m)) cnt[k[c]] = base + __popc(m);
          }
          __syncwarp();
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int kk = threadIdx.x; kk <= n_keys; kk += blockDim.x)
    tile_counts[(long long)kk * n_tiles + blockIdx.x] = cnt[kk];
}

// launch 2: one block per key row: exclusive prefix over the tiles (in
// place, where ranks are wanted) and the row's total
__global__ void __launch_bounds__(X1_SCAN_THREADS)
    x1_scan(int* __restrict__ tile_counts, int n_tiles, int want_rank,
            int* __restrict__ counts) {
  __shared__ int smem[32];
  int* row = tile_counts + (long long)blockIdx.x * n_tiles;
  const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, n_tiles);
  int s = 0;
  for (int t = lo; t < hi; ++t) s += row[t];
  int total;
  const int incl = block_inclusive_scan(s, smem, &total);
  if (want_rank) {
    int run = incl - s;
    for (int t = lo; t < hi; ++t) {
      const int c = row[t];
      row[t] = run;
      run += c;
    }
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// launch 3: rank += the key's base in the item's tile
__global__ void __launch_bounds__(X_THREADS)
    x1_add(const int* __restrict__ key, long long n, int n_keys,
           const int* __restrict__ base, int n_tiles, int* __restrict__ rank) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = key[i];
  if (k < 0 || k >= n_keys) return;
  rank[i] += base[(long long)k * n_tiles + i / X1_TILE];
}

extern "C" int pp_rank_in_key_tiles(long long n) {
  return (int)((n + X1_TILE - 1) / X1_TILE);
}

// counts: n_keys + 1 ints (the last: keys out of range); scratch:
// (n_keys + 1) · tiles ints; rank: n ints, or null for the counts only
extern "C" int pp_rank_in_key(const int* key, long long n, int n_keys, int* rank,
                              int* counts, int* scratch, cudaStream_t stream) {
  if (n_keys < 1 || n_keys > X1_MAX_KEYS) return (int)cudaErrorInvalidValue;
  const int tiles = pp_rank_in_key_tiles(n);
  const int want = rank != nullptr;
  const size_t smem = (size_t)(n_keys + 1) * sizeof(int);
  if (tiles > 0)
    x1_tile<<<tiles, X1_THREADS, smem, stream>>>(key, n, n_keys, want, rank, scratch, tiles);
  if (tiles == 0) {
    cudaMemsetAsync(counts, 0, (size_t)(n_keys + 1) * sizeof(int), stream);
    return (int)cudaGetLastError();
  }
  x1_scan<<<n_keys + 1, X1_SCAN_THREADS, 0, stream>>>(scratch, tiles, want, counts);
  if (want)
    x1_add<<<(unsigned)((n + X_THREADS - 1) / X_THREADS), X_THREADS, 0, stream>>>(
        key, n, n_keys, scratch, tiles, rank);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// member fields of a particle state, as int32 lanes of the payload
// ---------------------------------------------------------------------------

struct XFields {
  const void* src[X_MAX_FIELDS];   // (N, lanes) 4-byte words, or bytes (bool)
  void* dst[X_MAX_FIELDS];         // X3's outputs (null for X2)
  int lanes[X_MAX_FIELDS];
  int is_bool[X_MAX_FIELDS];
  int off[X_MAX_FIELDS];           // X3: the field's first lane in a payload row
  int n;
};

__device__ __forceinline__ int lane_of(const XFields& f, int j, long long i, int l) {
  const long long p = i * f.lanes[j] + l;
  if (f.is_bool[j]) return static_cast<const uint8_t*>(f.src[j])[p] != 0;
  return static_cast<const int*>(f.src[j])[p];
}

static int fill_fields(XFields* f, int n_fields, const void* const* srcs, void* const* dsts,
                       const int* lanes, const int* is_bool, const int* offs) {
  if (n_fields < 0 || n_fields > X_MAX_FIELDS) return 0;
  *f = XFields{};
  f->n = n_fields;
  for (int j = 0; j < n_fields; ++j) {
    f->src[j] = srcs[j];
    f->dst[j] = dsts ? dsts[j] : nullptr;
    f->lanes[j] = lanes[j];
    f->is_bool[j] = is_bool[j];
    f->off[j] = offs ? offs[j] : 0;
  }
  return 1;
}

// ---------------------------------------------------------------------------
// X2: the admitted leavers' rows of the send buffer
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(X_THREADS)
    x2_pack(const int* __restrict__ key, const int* __restrict__ rank, long long n, int n_buckets,
            const int* __restrict__ quota, int cap, const long long* __restrict__ offsets,
            const int* __restrict__ new_elem, const int* __restrict__ elem_gid, XFields f,
            int width, int* __restrict__ send, uint8_t* __restrict__ kept,
            uint8_t* __restrict__ leaving, const int* __restrict__ counts,
            uint8_t* __restrict__ overflow) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    // a destination's volume above the bucket size
    int over = 0;
    for (int b = 0; b < n_buckets; ++b) over |= counts[b] > cap;
    *overflow = (uint8_t)over;
  }
  if (i >= n) return;
  const int k = key[i];
  int go = 0, stay = 0;
  if (k < n_buckets) {
    const int lim = min(quota[k], cap);
    const int r = rank[i];
    go = r < lim;
    stay = !go;
    if (go) {
      int* row = send + (offsets[k] + r) * (long long)width;
      row[0] = elem_gid[max(new_elem[i], 0)];
      int col = 1;
      for (int j = 0; j < f.n; ++j)
        for (int l = 0; l < f.lanes[j]; ++l) row[col++] = lane_of(f, j, i, l);
    }
  }
  kept[i] = (uint8_t)stay;
  leaving[i] = (uint8_t)go;
}

extern "C" int pp_pack_send(const int* key, const int* rank, long long n, int n_buckets,
                            const int* quota, int cap, const long long* offsets,
                            const int* new_elem, const int* elem_gid, int n_fields,
                            const void* const* srcs, const int* lanes, const int* is_bool,
                            int width, int* send, uint8_t* kept, uint8_t* leaving,
                            const int* counts, uint8_t* overflow, cudaStream_t stream) {
  XFields f;
  if (!fill_fields(&f, n_fields, srcs, nullptr, lanes, is_bool, nullptr)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + X_THREADS - 1) / X_THREADS;
  x2_pack<<<(unsigned)(blocks > 0 ? blocks : 1), X_THREADS, 0, stream>>>(
      key, rank, n, n_buckets, quota, cap, offsets, new_elem, elem_gid, f, width, send, kept,
      leaving, counts, overflow);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// X3: arrivals into the free slots
// ---------------------------------------------------------------------------

// lower bound of g in the sorted (E,) gids, -1 where absent (gid_to_lid)
__device__ __forceinline__ int gid_to_lid(const int* __restrict__ sorted,
                                          const int* __restrict__ perm, int E, int g) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (sorted[mid] < g) lo = mid + 1; else hi = mid;
  }
  const int p = min(lo, E - 1);
  return (g >= 0 && sorted[p] == g) ? perm[p] : -1;
}

// one block: each arrival's local id, the valid arrivals' rows in arrival
// order, num_recv, num_unresolved and the recv overflow
__global__ void __launch_bounds__(X3_THREADS)
    x3_arrivals(const int* __restrict__ recv, long long m, int width,
                const int* __restrict__ gid_sorted, const int* __restrict__ gid_perm, int E,
                int* __restrict__ arr_lid, int* __restrict__ row_of_valid,
                const int* __restrict__ free_counts, int* __restrict__ stats,
                uint8_t* __restrict__ overflow) {
  __shared__ int smem[32];
  const long long per = (m + blockDim.x - 1) / blockDim.x;
  const long long lo = threadIdx.x * per;
  const long long hi = min(lo + per, m);
  int valid = 0, unres = 0;
  for (long long j = lo; j < hi; ++j) {
    const int g = recv[j * width];
    const int lid = gid_to_lid(gid_sorted, gid_perm, E, g);
    arr_lid[j] = lid;
    valid += (g >= 0) & (lid >= 0);
    unres += (g >= 0) & (lid < 0);
  }
  int n_valid, n_unres;
  int pos = block_inclusive_scan(valid, smem, &n_valid) - valid;
  block_inclusive_scan(unres, smem, &n_unres);
  for (long long j = lo; j < hi; ++j)
    if (recv[j * width] >= 0 && arr_lid[j] >= 0) row_of_valid[pos++] = (int)j;
  if (threadIdx.x == 0) {
    stats[0] = n_valid;
    stats[1] = n_unres;
    *overflow = (uint8_t)(n_valid > free_counts[0]);
  }
}

// one thread a slot: a staying slot keeps its values, the free slot of
// rank r < num_recv takes the r-th valid arrival, another free slot is
// cleared (elem -1, active 0, fields 0)
__global__ void __launch_bounds__(X_THREADS)
    x3_place(const uint8_t* __restrict__ staying, const int* __restrict__ new_elem,
             const int* __restrict__ free_rank, long long n, const int* __restrict__ recv,
             int width, const int* __restrict__ arr_lid, const int* __restrict__ row_of_valid,
             const int* __restrict__ stats, XFields f, int* __restrict__ elem_out, uint8_t* __restrict__ active_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long row = -1;                        // the arrival this slot takes
  const int stay = staying[i] != 0;
  if (!stay) {
    const int r = free_rank[i];
    if (r < stats[0]) row = row_of_valid[r];
  }
  elem_out[i] = stay ? new_elem[i] : (row >= 0 ? arr_lid[row] : -1);
  active_out[i] = (uint8_t)(stay || row >= 0);
  for (int j = 0; j < f.n; ++j) {
    const int w = f.lanes[j];
    for (int l = 0; l < w; ++l) {
      int v = 0;
      if (stay) v = lane_of(f, j, i, l);
      else if (row >= 0) v = recv[row * width + f.off[j] + l];
      if (f.is_bool[j])
        static_cast<uint8_t*>(f.dst[j])[i * w + l] = (uint8_t)(v != 0);
      else
        static_cast<int*>(f.dst[j])[i * w + l] = v;
    }
  }
}

// scratch: 2·m ints (m = arrivals); offs: each field's first lane in a
// payload row (host ints)
extern "C" int pp_place_arrivals(const uint8_t* staying, const int* new_elem,
                                 const int* free_rank, const int* free_counts, long long n,
                                 const int* recv, long long m, int width,
                                 const int* gid_sorted, const int* gid_perm, int E,
                                 int n_fields, const void* const* srcs, void* const* dsts,
                                 const int* lanes, const int* is_bool, const int* offs,
                                 int* scratch, int* stats, uint8_t* overflow,
                                 int* elem_out, uint8_t* active_out, cudaStream_t stream) {
  XFields f;
  if (!fill_fields(&f, n_fields, srcs, dsts, lanes, is_bool, offs) || E < 1)
    return (int)cudaErrorInvalidValue;
  x3_arrivals<<<1, X3_THREADS, 0, stream>>>(recv, m, width, gid_sorted, gid_perm, E, scratch,
                                            scratch + m, free_counts, stats, overflow);
  if (n > 0)
    x3_place<<<(unsigned)((n + X_THREADS - 1) / X_THREADS), X_THREADS, 0, stream>>>(
        staying, new_elem, free_rank, n, recv, width, scratch, scratch + m, stats, f, elem_out,
        active_out);
  return (int)cudaGetLastError();
}
