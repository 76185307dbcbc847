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
//                   in arrival order; stayers keep their slots, the other
//                   free slots are cleared.
//
// What bounds them on an H100: bytes.  Each reads its (N,) inputs once and
// writes its outputs once (X1's rank pass reads its keys a second time);
// the arithmetic is a few integer operations an item.  Every output is an
// integer or a moved bit pattern, so each equals its plain version bit for
// bit.
//
// X3's design (three launches, no host read): the first takes a tile a
// block, X_THREADS arrivals (one a thread: a binary search in the sorted
// gids, L2-resident, and the block's scan, which compacts the tile's valid
// arrivals' rows and elements in arrival order) and X3_TILE slots (the
// count of the free ones); a one-block launch scans the tiles' counts into
// prefixes and writes the counts and the overflow; the placement takes a
// tile of X3_TILE slots a block: a ballot of the free slots a warp and
// chunk and the block's scan of the 64 counts, on top of the tile's prefix,
// give each free slot its rank (no separate ranking kernel, no chain of
// tiles waiting on each other), and a free slot of rank r < num_recv takes
// the r-th valid arrival, another is cleared.  It writes the member fields
// in place, into the state's own tensors, and only at the free slots: the
// staying slots' fields are neither read nor written (the caller gives the
// old state up); elem and active are new arrays, written at every slot.
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
// X3's placement tile: X3_CHUNKS slots a thread, a chunk of X_THREADS
// consecutive slots at a time
#define X3_CHUNKS 8
#define X3_TILE (X3_CHUNKS * X_THREADS)
#define X3_SCAN_THREADS 1024

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

// the sum of v over the block (X_THREADS threads); smem holds 32 ints
__device__ __forceinline__ int x3_block_sum(int v, int* smem) {
  int total;
  block_inclusive_scan(v, smem, &total);
  return total;
}

// launch 1, a block a tile: block b counts the free slots of placement
// tile b (X3_TILE slots), and, for b < tiles_a, takes arrivals [b·X_THREADS,
// (b+1)·X_THREADS), one a thread: its local element by binary search in
// the sorted gids (L2-resident), the tile's valid arrivals' rows and
// elements compacted in arrival order at the tile's X_THREADS entries, the
// tile's valid and unresolved counts
__global__ void __launch_bounds__(X_THREADS)
    x3_tiles(const int* __restrict__ recv, long long m, int width,
             const int* __restrict__ gid_sorted, const int* __restrict__ gid_perm, int E,
             int tiles_a, const uint8_t* __restrict__ staying, long long n, int tiles_p,
             int* __restrict__ arr_row, int* __restrict__ arr_lid,
             int* __restrict__ tile_valid, int* __restrict__ tile_unres,
             int* __restrict__ tile_free) {
  __shared__ int smem[32];
  const int b = blockIdx.x;
  if (b < tiles_p) {                              // block-uniform
    int free = 0;
    const long long base = (long long)b * X3_TILE;
#pragma unroll
    for (int c = 0; c < X3_CHUNKS; ++c) {
      const long long i = base + c * X_THREADS + threadIdx.x;
      free += i < n && staying[i] == 0;
    }
    free = x3_block_sum(free, smem);
    if (threadIdx.x == 0) tile_free[b] = free;
  }
  if (b < tiles_a) {
    const long long j = (long long)b * X_THREADS + threadIdx.x;
    const int g = j < m ? recv[j * width] : -1;
    const int lid = g >= 0 ? gid_to_lid(gid_sorted, gid_perm, E, g) : -1;
    const int valid = g >= 0 && lid >= 0, unres = g >= 0 && lid < 0;
    int n_valid;
    const int pos = block_inclusive_scan(valid, smem, &n_valid) - valid;
    const int n_unres = x3_block_sum(unres, smem);
    if (valid) {
      arr_row[(long long)b * X_THREADS + pos] = (int)j;
      arr_lid[(long long)b * X_THREADS + pos] = lid;
    }
    if (threadIdx.x == 0) {
      tile_valid[b] = n_valid;
      tile_unres[b] = n_unres;
    }
  }
}

// launch 2, one block: the tiles' counts turned into exclusive prefixes in
// place (valid arrivals, free slots); num_recv, num_unresolved and the
// recv overflow (num_recv > free slots)
__global__ void __launch_bounds__(X3_SCAN_THREADS)
    x3_scan(int* __restrict__ tile_valid, const int* __restrict__ tile_unres, int tiles_a,
            int* __restrict__ tile_free, int tiles_p, int* __restrict__ stats,
            uint8_t* __restrict__ overflow) {
  __shared__ int smem[32];
  long long totals[2];
  int* rows[2] = {tile_valid, tile_free};
  const int lens[2] = {tiles_a, tiles_p};
  for (int k = 0; k < 2; ++k) {
    long long carry = 0;
    for (int base = 0; base < lens[k]; base += blockDim.x) {
      const int t = base + threadIdx.x;
      const int v = t < lens[k] ? rows[k][t] : 0;
      int total;
      const int incl = block_inclusive_scan(v, smem, &total);
      if (t < lens[k]) rows[k][t] = (int)(carry + incl - v);
      carry += total;
    }
    totals[k] = carry;
  }
  long long unres = 0;
  for (int base = 0; base < tiles_a; base += blockDim.x) {
    const int t = base + threadIdx.x;
    unres += x3_block_sum(t < tiles_a ? tile_unres[t] : 0, smem);
  }
  if (threadIdx.x == 0) {
    stats[0] = (int)totals[0];
    stats[1] = (int)unres;
    *overflow = (uint8_t)(totals[0] > totals[1]);
  }
}

// launch 3, X3_TILE slots a block: each free slot's rank (the tile's
// prefix from launch 2, a ballot a warp and chunk, the block's scan of the
// 64 counts); a staying slot keeps its member fields (not read or
// written) and takes its new element, the free slot of rank r < num_recv
// takes the r-th valid arrival (its arrival tile by a binary search over
// the tiles' prefixes), another free slot is cleared (elem -1, active 0,
// member fields 0), the fields written in place
__global__ void __launch_bounds__(X_THREADS)
    x3_place(const uint8_t* __restrict__ staying, const int* __restrict__ new_elem,
             long long n, const int* __restrict__ recv, int width,
             const int* __restrict__ arr_row, const int* __restrict__ arr_lid,
             const int* __restrict__ valid_pre, int tiles_a,
             const int* __restrict__ free_pre, const int* __restrict__ stats, XFields f,
             int* __restrict__ elem_out, uint8_t* __restrict__ active_out) {
  __shared__ int s_pre[X3_CHUNKS * X_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * X3_TILE;
  unsigned mask[X3_CHUNKS];
  bool stay[X3_CHUNKS];
#pragma unroll
  for (int c = 0; c < X3_CHUNKS; ++c) {
    const long long i = base + c * X_THREADS + threadIdx.x;
    stay[c] = i >= n || staying[i] != 0;
    mask[c] = __ballot_sync(0xffffffffu, !stay[c]);
    if (lane == 0) s_pre[c * (X_THREADS / 32) + warp] = __popc(mask[c]);
  }
  __syncthreads();
  if (warp == 0) {   // the exclusive scan of the 64 (chunk, warp) counts
    const int a = s_pre[2 * lane], b = s_pre[2 * lane + 1];
    int x = a + b;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    s_pre[2 * lane] = x - a - b;
    s_pre[2 * lane + 1] = x - b;
  }
  __syncthreads();
  const long long first = free_pre[blockIdx.x];
  const long long num_recv = stats[0];
#pragma unroll
  for (int c = 0; c < X3_CHUNKS; ++c) {
    const long long i = base + c * X_THREADS + threadIdx.x;
    if (i >= n) continue;
    if (stay[c]) {
      elem_out[i] = new_elem[i];
      active_out[i] = 1;
      continue;
    }
    const long long r = first + s_pre[c * (X_THREADS / 32) + warp] + __popc(mask[c] & lower);
    long long row = -1;
    int lid = -1;
    if (r < num_recv) {      // the last arrival tile whose prefix is <= r
      int lo = 0, hi = tiles_a - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (valid_pre[mid] <= r) lo = mid; else hi = mid - 1;
      }
      const long long at = (long long)lo * X_THREADS + (r - valid_pre[lo]);
      row = arr_row[at];
      lid = arr_lid[at];
    }
    elem_out[i] = lid;
    active_out[i] = (uint8_t)(row >= 0);
    for (int jf = 0; jf < f.n; ++jf) {
      const int w = f.lanes[jf];
      for (int l = 0; l < w; ++l) {
        const int v = row >= 0 ? recv[row * width + f.off[jf] + l] : 0;
        if (f.is_bool[jf])
          static_cast<uint8_t*>(f.dst[jf])[i * w + l] = (uint8_t)(v != 0);
        else
          static_cast<int*>(f.dst[jf])[i * w + l] = v;
      }
    }
  }
}

// ints of X3's scratch: the arrivals' rows and elements compacted per tile
// (X_THREADS each a tile) and the tiles' counts
extern "C" int pp_place_arrivals_scratch(long long n, long long m) {
  const long long tiles_a = (m + X_THREADS - 1) / X_THREADS + (m == 0);
  const long long tiles_p = (n + X3_TILE - 1) / X3_TILE + (n == 0);
  return (int)(2 * tiles_a * X_THREADS + 2 * tiles_a + tiles_p);
}

// n slots (staying, new_elem; member fields written in place, dsts), m
// arrivals (recv rows of width int32 lanes; offs: each field's first lane
// in a row, host ints); scratch: pp_place_arrivals_scratch(n, m) ints
extern "C" int pp_place_arrivals(const uint8_t* staying, const int* new_elem, long long n,
                                 const int* recv, long long m, int width,
                                 const int* gid_sorted, const int* gid_perm, int E,
                                 int n_fields, void* const* dsts, const int* lanes,
                                 const int* is_bool, const int* offs, int* scratch,
                                 int* stats, uint8_t* overflow, int* elem_out,
                                 uint8_t* active_out, cudaStream_t stream) {
  XFields f;
  if (!fill_fields(&f, n_fields, dsts, dsts, lanes, is_bool, offs) || E < 1 || n < 0 ||
      m < 0 || n >= (1LL << 31) || m >= (1LL << 31) / X_THREADS * X_THREADS)
    return (int)cudaErrorInvalidValue;
  const int tiles_a = (int)((m + X_THREADS - 1) / X_THREADS) + (m == 0);
  const int tiles_p = (int)((n + X3_TILE - 1) / X3_TILE) + (n == 0);
  int* arr_row = scratch;
  int* arr_lid = arr_row + (long long)tiles_a * X_THREADS;
  int* tile_valid = arr_lid + (long long)tiles_a * X_THREADS;
  int* tile_unres = tile_valid + tiles_a;
  int* tile_free = tile_unres + tiles_a;
  x3_tiles<<<tiles_a > tiles_p ? tiles_a : tiles_p, X_THREADS, 0, stream>>>(
      recv, m, width, gid_sorted, gid_perm, E, tiles_a, staying, n, tiles_p, arr_row,
      arr_lid, tile_valid, tile_unres, tile_free);
  x3_scan<<<1, X3_SCAN_THREADS, 0, stream>>>(tile_valid, tile_unres, tiles_a, tile_free,
                                             tiles_p, stats, overflow);
  x3_place<<<tiles_p, X_THREADS, 0, stream>>>(staying, new_elem, n, recv, width, arr_row,
                                              arr_lid, tile_valid, tiles_a, tile_free, stats,
                                              f, elem_out, active_out);
  return (int)cudaGetLastError();
}
