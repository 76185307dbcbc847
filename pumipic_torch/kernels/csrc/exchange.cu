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
// writes its outputs once; the arithmetic is a few integer operations an
// item.  Every output is an integer or a moved bit pattern, so each equals
// its plain version bit for bit.
//
// X1's design (a memset of its scratch and one launch, in either mode):
//  - The private mode (n_keys + 1 <= X1_PRIVATE_ROWS: every caller of the
//    step, 2 to 34 keys), ranked: resident blocks take chunks of tiles by
//    tickets in index order; a chunk's keys are staged in shared memory at
//    once (cp.async); each thread counts its own X1_ITEMS consecutive keys
//    in a column of counters of its own (no atomics, no warp match); the
//    chunk publishes its counts at once, the last chunk of a group of
//    X1_GROUP to publish the group's; then each tile is ranked (a warp a
//    key scans the key's counters over the threads), and a chunk's base of
//    each key is the sum of the earlier groups' counts and of the earlier
//    chunks' of its group, each word waited for until published: depth
//    two (a look-back through inclusive prefixes serialised the ~500
//    chunks that run at once on the card).  The ranks are written once;
//    the last chunk writes the counts.  Counts only: a grid stride into
//    the same counters; a block adds its counts into one of X1_SPREAD
//    copies of the counts, 128 bytes apart (the L2 slices take the atomics
//    side by side), and the last block to finish sums the copies.
//  - The wide mode (more keys, up to X1_MAX_KEYS), ranked: tiles by
//    tickets in order; each warp ranks its chunks with __match_any_sync
//    into its own table in shared memory (fewer warps a tile where eight
//    tables do not fit: four at X1_MAX_KEYS); threads over keys publish
//    the tile's counts in a status word a key (flag in the top two bits,
//    value below: N < 2^30) and look back over the earlier tiles (the
//    pattern of kernel C's passes, rebuild.cu).  Counts only: a block's
//    table flushed with one global atomic a non-zero key.
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
#define X1_THREADS (32 * X1_WARPS)
#define X1_MAX_KEYS (48 * 1024 / 4 - 1)   // keys a block's count table holds
// the private mode (rows = keys + 1 <= X1_PRIVATE_ROWS): X1_ITEMS
// consecutive keys a thread (int4 loads), a counter a thread and key
#define X1_ITEMS 8
#define X1_PRIVATE_ROWS 64
// tiles a chunk of the private mode stages in shared memory at most, and
// chunks a group (a warp's lanes)
#define X1_STAGE_TILES 8
#define X1_GROUP 32
// the private mode's counts only: copies of each key's count (a warp's
// lanes), X1_PAD words (128 bytes) apart
#define X1_SPREAD 32
#define X1_PAD 32
// the wide mode: X1_CHUNKS chunks of 32 keys a warp, a table a warp in the
// shared memory X1_SMEM holds, X1_LOOKBACK status words a thread reads at once
#define X1_CHUNKS 8
#define X1_SMEM (224 * 1024)
#define X1_LOOKBACK 8
// a tile's status word for one key: its count (flag 1) or the key's items
// up to and with the tile (flag 2), below a flag in the top two bits
#define X1_AGGREGATE (1u << 30)
#define X1_INCLUSIVE (2u << 30)
#define X1_VALUE (X1_AGGREGATE - 1u)
// the private mode's count words: the value below a flag once published
#define X1_PUBLISHED X1_AGGREGATE
// X1's scratch: the ticket, padded to 128 bytes, then the chunks' counts,
// the copies of the counts or the status words
#define X1_HEADER 32
// the counts-only pass: keys a warp loads at once, blocks an SM
#define X1_COUNT_UNROLL 4
#define X1_COUNT_BLOCKS_PER_SM 8
#define X_THREADS 256
#define X_MAX_FIELDS 16
// X3's placement tile: X3_CHUNKS slots a thread, a chunk of X_THREADS
// consecutive slots at a time
#define X3_CHUNKS 8
#define X3_TILE (X3_CHUNKS * X_THREADS)
#define X3_SCAN_THREADS 1024

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

// ---------------------------------------------------------------------------
// X1: rank within key
// ---------------------------------------------------------------------------

// a key's items in the tiles before ``tile``: the earlier tiles' status
// words read X1_LOOKBACK at a time and summed back to the nearest inclusive
// prefix (a word not yet published is read again)
__device__ __forceinline__ unsigned x1_look_back(volatile unsigned* vstatus, int tile,
                                                 int rows, int k) {
  unsigned excl = 0u;
  for (long long j = tile - 1; j >= 0;) {
    unsigned s[X1_LOOKBACK];
#pragma unroll
    for (int q = 0; q < X1_LOOKBACK; ++q)
      s[q] = j - q >= 0 ? vstatus[(j - q) * rows + k] : X1_INCLUSIVE;
    int used = 0;
    bool done = false;
#pragma unroll
    for (int q = 0; q < X1_LOOKBACK; ++q) {
      if (used == q && !done && s[q] >= X1_AGGREGATE) {   // the words before q summed
        excl += s[q] & X1_VALUE;
        used = q + 1;
        done = s[q] >= X1_INCLUSIVE;
      }
    }
    if (done) break;
    j -= used;
  }
  return excl;
}

// the sum of v over the warp, in every lane
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// X1_ITEMS consecutive keys from ``first`` (int4 loads where ``vec``: the
// keys 16-byte aligned and the group whole), -1 past the end; a key out of
// range becomes n_keys
__device__ __forceinline__ void x1_load(const int* __restrict__ key, long long first,
                                        long long n, int n_keys, bool vec,
                                        int (&k)[X1_ITEMS]) {
  if (vec && first + X1_ITEMS <= n) {
#pragma unroll
    for (int q = 0; q < X1_ITEMS; q += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(key + first + q));
      k[q] = v.x; k[q + 1] = v.y; k[q + 2] = v.z; k[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < X1_ITEMS; ++q) k[q] = first + q < n ? key[first + q] : -1;
  }
#pragma unroll
  for (int q = 0; q < X1_ITEMS; ++q)
    k[q] = first + q >= n ? -1 : (unsigned)k[q] >= (unsigned)n_keys ? n_keys : k[q];
}

// 16 bytes from global to shared memory without a register (cp.async), or
// a plain copy where the code is not compiled for the card
__device__ __forceinline__ void x1_copy16(int* smem, const int* gmem) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
#else
  for (int j = 0; j < 4; ++j) smem[j] = gmem[j];
#endif
}

__device__ __forceinline__ void x1_copies_done() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
#endif
}

// a thread's X1_ITEMS words of the stage, 16 bytes at a time (a word at a
// time, lanes 32 bytes apart, would meet in 4 banks)
__device__ __forceinline__ void x1_unstage(const int* at, int (&v)[X1_ITEMS]) {
#pragma unroll
  for (int q = 0; q < X1_ITEMS; q += 4) {
    const int4 w = *reinterpret_cast<const int4*>(at + q);
    v[q] = w.x; v[q + 1] = w.y; v[q + 2] = w.z; v[q + 3] = w.w;
  }
}

__device__ __forceinline__ void x1_restage(int* at, const int (&v)[X1_ITEMS]) {
#pragma unroll
  for (int q = 0; q < X1_ITEMS; q += 4)
    *reinterpret_cast<int4*>(at + q) = make_int4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

// a published word: its value with X1_PUBLISHED set; read again until set
__device__ __forceinline__ unsigned x1_published(const volatile unsigned* p) {
  unsigned w = *p;
  while (w < X1_PUBLISHED) w = *p;
  return w & X1_VALUE;
}

// the private mode's ranks (rows <= X1_PRIVATE_ROWS): a block a chunk of
// ``per`` (<= X1_STAGE_TILES) tiles of X1_THREADS · X1_ITEMS keys, by
// tickets in index order.
//  - The chunk's keys are staged in shared memory at once (cp.async), so a
//    chunk waits for device memory once.
//  - Each thread counts its own X1_ITEMS consecutive keys of each tile in
//    its column of ``cnt`` (rows x X1_THREADS: no atomics, no conflicts);
//    the chunk publishes its count of each key (``agg``, key-major) at
//    once, and the last chunk of a group of X1_GROUP to publish (a ticket
//    a group) sums the group's and publishes the group's count (``gtot``).
//  - Then a tile at a time: the thread's counts again, a warp a key
//    scanning the key's row over the threads on top of the key's items in
//    the chunk's earlier tiles, and each key's rank in the chunk replacing
//    it in the stage (rank << 6 | key).
//  - A chunk's keys before it are the counts of the earlier groups and of
//    the earlier chunks of its group: at most n_chunks / X1_GROUP +
//    X1_GROUP words a key, read at once, each waited for until published
//    (every one by a chunk of an earlier ticket, which waits for nothing
//    before it publishes).  The ranks are written out; the last chunk
//    writes the counts.
// Dynamic shared memory: cnt, then the stage.
__global__ void __launch_bounds__(X1_THREADS)
    x1_ranks(const int* __restrict__ key, long long n, int n_keys, int n_chunks, int per,
             int vec, int* __restrict__ rank, int* __restrict__ counts,
             unsigned* __restrict__ hdr, unsigned* agg, unsigned* gtot, unsigned* gdone) {
  extern __shared__ int cnt[];
  __shared__ unsigned s_base[X1_PRIVATE_ROWS], s_total[X1_PRIVATE_ROWS], s_excl[X1_PRIVATE_ROWS];
  __shared__ int s_ticket, s_group_last;
  const int rows = n_keys + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_groups = (n_chunks + X1_GROUP - 1) / X1_GROUP;
  int* const mine = cnt + tid;                    // this thread's column
  int* const stage = cnt + rows * X1_THREADS;     // [tile][thread][item]
  for (;;) {
    if (tid == 0) s_ticket = (int)atomicAdd(hdr, 1u);
    if (tid < rows) s_base[tid] = 0u;
    __syncthreads();
    const int c = s_ticket;
    if (c >= n_chunks) return;                    // block-uniform
    const long long first_tile = (long long)c * per;
    for (int t = 0; t < per; ++t) {               // the chunk's keys staged
      const long long first = ((first_tile + t) * X1_THREADS + tid) * X1_ITEMS;
      int* const to = stage + (t * X1_THREADS + tid) * X1_ITEMS;
      if (vec && first + X1_ITEMS <= n) {
#pragma unroll
        for (int q = 0; q < X1_ITEMS; q += 4) x1_copy16(to + q, key + first + q);
      } else {
        int v[X1_ITEMS];
#pragma unroll
        for (int q = 0; q < X1_ITEMS; ++q) v[q] = first + q < n ? key[first + q] : -1;
        x1_restage(to, v);
      }
    }
    x1_copies_done();                             // a thread reads its own items only
    // the chunk's count of each key, published before the chunk is ranked
    // (the ranking overlaps the wait for the earlier chunks' counts); the
    // last chunk of its group to publish publishes the group's
    for (int j = 0; j < rows; ++j) mine[j * X1_THREADS] = 0;
    for (int t = 0; t < per; ++t) {
      const long long first = ((first_tile + t) * X1_THREADS + tid) * X1_ITEMS;
      int v[X1_ITEMS];
      x1_unstage(stage + (t * X1_THREADS + tid) * X1_ITEMS, v);
#pragma unroll
      for (int q = 0; q < X1_ITEMS; ++q)
        if (first + q < n) ++mine[((unsigned)v[q] >= (unsigned)n_keys ? n_keys : v[q]) * X1_THREADS];
    }
    __syncthreads();
    const int g = c / X1_GROUP;
    for (int kk = warp; kk < rows; kk += X1_WARPS) {
      const int4* col = reinterpret_cast<const int4*>(cnt + kk * X1_THREADS + lane * 8);
      const int4 a = col[0], b = col[1];
      const unsigned sum = warp_sum((unsigned)(a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w));
      if (lane == 0) {
        s_total[kk] = sum;
        agg[(long long)kk * n_chunks + c] = X1_PUBLISHED | sum;
        __threadfence();
      }
    }
    __syncthreads();
    if (tid == 0) {
      const int in_group = min(X1_GROUP, n_chunks - g * X1_GROUP);
      s_group_last = atomicAdd(gdone + g, 1u) == (unsigned)in_group - 1;
      if (s_group_last) __threadfence();
    }
    __syncthreads();
    if (s_group_last) {                           // block-uniform
      const int in_group = min(X1_GROUP, n_chunks - g * X1_GROUP);
      for (int kk = warp; kk < rows; kk += X1_WARPS) {
        const unsigned v = lane < in_group
            ? __ldcg(agg + (long long)kk * n_chunks + g * X1_GROUP + lane) & X1_VALUE : 0u;
        const unsigned sum = warp_sum(v);
        if (lane == 0) atomicExch(gtot + (long long)kk * n_groups + g, X1_PUBLISHED | sum);
      }
    }
    for (int t = 0; t < per; ++t) {               // ranked, a tile at a time
      const long long first = ((first_tile + t) * X1_THREADS + tid) * X1_ITEMS;
      int* const at = stage + (t * X1_THREADS + tid) * X1_ITEMS;
      int k[X1_ITEMS], r[X1_ITEMS];
      x1_unstage(at, k);
      for (int j = 0; j < rows; ++j) mine[j * X1_THREADS] = 0;
#pragma unroll
      for (int q = 0; q < X1_ITEMS; ++q) {
        k[q] = first + q >= n ? -1 : (unsigned)k[q] >= (unsigned)n_keys ? n_keys : k[q];
        r[q] = k[q] >= 0 ? mine[k[q] * X1_THREADS]++ : 0;
      }
      __syncthreads();
      // a warp a key: the key's counts over the threads into prefixes on
      // top of the key's items in the chunk before the tile (lane l:
      // threads 8l .. 8l + 7)
      for (int kk = warp; kk < rows; kk += X1_WARPS) {
        int4* col = reinterpret_cast<int4*>(cnt + kk * X1_THREADS + lane * 8);
        int4 a = col[0], b = col[1];
        const int sum = a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        const int base = (int)s_base[kk];
        int to = base + incl - sum;
        const int4 a0 = a, b0 = b;
        a.x = to; to += a0.x; a.y = to; to += a0.y; a.z = to; to += a0.z; a.w = to; to += a0.w;
        b.x = to; to += b0.x; b.y = to; to += b0.y; b.z = to; to += b0.z; b.w = to;
        col[0] = a;
        col[1] = b;
        __syncwarp();                           // every lane has read the base
        if (lane == 31) s_base[kk] = (unsigned)(base + incl);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < X1_ITEMS; ++q)
        r[q] = k[q] >= 0 ? (r[q] + mine[k[q] * X1_THREADS]) << 6 | k[q] : -1;
      x1_restage(at, r);
    }
    // the keys before the chunk: the earlier groups' counts and the
    // earlier chunks' of its group
    const int words = g + (c - g * X1_GROUP);
    for (int kk = warp; kk < rows; kk += X1_WARPS) {
      unsigned v = 0u;
      for (int j = lane; j < words; j += 32)
        v += j < g ? x1_published(gtot + (long long)kk * n_groups + j)
                   : x1_published(agg + (long long)kk * n_chunks + g * X1_GROUP + (j - g));
      v = warp_sum(v);
      if (lane == 0) s_excl[kk] = v;
    }
    __syncthreads();
    if (c == n_chunks - 1 && tid < rows) counts[tid] = (int)(s_excl[tid] + s_total[tid]);
    for (int t = 0; t < per; ++t) {               // the ranks out
      const long long first = ((first_tile + t) * X1_THREADS + tid) * X1_ITEMS;
      int out[X1_ITEMS];
      x1_unstage(stage + (t * X1_THREADS + tid) * X1_ITEMS, out);
#pragma unroll
      for (int q = 0; q < X1_ITEMS; ++q)
        out[q] = out[q] >= 0 && (out[q] & 63) < n_keys ? (out[q] >> 6) + (int)s_excl[out[q] & 63] : -1;
      if (vec && first + X1_ITEMS <= n) {
#pragma unroll
        for (int q = 0; q < X1_ITEMS; q += 4)
          *reinterpret_cast<int4*>(rank + first + q) =
              make_int4(out[q], out[q + 1], out[q + 2], out[q + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < X1_ITEMS; ++q)
          if (first + q < n) rank[first + q] = out[q];
      }
    }
  }
}

// the private mode's counts only: a grid stride of X1_ITEMS consecutive
// keys a thread, counted in its column of ``cnt``; a block adds its count
// of each key into copy blockIdx % X1_SPREAD of the key's (``spread``,
// X1_PAD words apart, so the atomics of many blocks go to many L2 slices
// at once), and the last block to finish (a ticket) sums the copies
__global__ void __launch_bounds__(X1_THREADS)
    x1_counts(const int* __restrict__ key, long long n, int n_keys, int vec,
              int* __restrict__ counts, unsigned* __restrict__ hdr, unsigned* spread) {
  extern __shared__ int cnt[];                    // rows x X1_THREADS
  __shared__ int s_last;
  const int rows = n_keys + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* const mine = cnt + tid;
  for (int j = 0; j < rows; ++j) mine[j * X1_THREADS] = 0;
  const long long step = (long long)gridDim.x * X1_THREADS * X1_ITEMS;
#pragma unroll 2
  for (long long first = ((long long)blockIdx.x * X1_THREADS + tid) * X1_ITEMS; first < n;
       first += step) {
    int k[X1_ITEMS];
    x1_load(key, first, n, n_keys, vec, k);
#pragma unroll
    for (int q = 0; q < X1_ITEMS; ++q)
      if (k[q] >= 0) ++mine[k[q] * X1_THREADS];
  }
  __syncthreads();
  for (int kk = warp; kk < rows; kk += X1_WARPS) {
    const int4* col = reinterpret_cast<const int4*>(cnt + kk * X1_THREADS + lane * 8);
    const int4 a = col[0], b = col[1];
    const unsigned sum = warp_sum((unsigned)(a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w));
    if (lane == 0 && sum != 0u) {
      atomicAdd(spread + ((long long)kk * X1_SPREAD + blockIdx.x % X1_SPREAD) * X1_PAD, sum);
      __threadfence();
    }
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(hdr, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;                            // block-uniform
  unsigned v[X1_PRIVATE_ROWS / X1_WARPS];         // the warp's keys' copies, read at once
#pragma unroll
  for (int m = 0; m < X1_PRIVATE_ROWS / X1_WARPS; ++m) {
    const int kk = warp + m * X1_WARPS;
    v[m] = kk < rows ? __ldcg(spread + ((long long)kk * X1_SPREAD + lane) * X1_PAD) : 0u;
  }
#pragma unroll
  for (int m = 0; m < X1_PRIVATE_ROWS / X1_WARPS; ++m) {
    const int kk = warp + m * X1_WARPS;
    const unsigned sum = warp_sum(v[m]);
    if (kk < rows && lane == 0) counts[kk] = (int)sum;
  }
}

// the wide mode (rows > X1_PRIVATE_ROWS): tiles of blockDim.x ·
// X1_CHUNKS keys by tickets in order; each warp ranks its chunks at once
// (__match_any_sync: the group's highest lane adds the group to the warp's
// table and broadcasts the count before it); threads over keys turn the
// tables into the warps' bases, publish the tile's counts and look back;
// rows = n_keys + 1 (the last: keys out of range, rank -1); dynamic shared
// memory: a table of rows ints a warp
__global__ void __launch_bounds__(X1_THREADS)
    x1_ranks_wide(const int* __restrict__ key, long long n, int n_keys, int n_tiles,
             int* __restrict__ rank, int* __restrict__ counts, unsigned* __restrict__ hdr,
             unsigned* status) {
  extern __shared__ int tab[];
  __shared__ int s_tile;
  const int rows = n_keys + 1;
  const int n_warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  int* const mine = tab + warp * rows;
  volatile unsigned* vstatus = status;
  for (;;) {
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(hdr, 1u);
    for (int j = threadIdx.x; j < n_warps * rows; j += blockDim.x) tab[j] = 0;
    __syncthreads();
    const int tile = s_tile;
    if (tile >= n_tiles) return;
    const long long first = ((long long)tile * n_warps + warp) * 32 * X1_CHUNKS + lane;
    int k[X1_CHUNKS], r[X1_CHUNKS];
#pragma unroll
    for (int c = 0; c < X1_CHUNKS; ++c) {
      const long long i = first + c * 32;
      k[c] = -1;                                  // past the end: no key
      if (i < n) {
        const int v = key[i];
        k[c] = (unsigned)v >= (unsigned)n_keys ? n_keys : v;
      }
    }
    // every warp at once, chunk after chunk (a warp's shared atomics on one
    // address are done in order)
#pragma unroll
    for (int c = 0; c < X1_CHUNKS; ++c) {
      const unsigned grp = __match_any_sync(0xffffffffu, k[c]);
      const int leader = 31 - __clz(grp);
      int before = 0;
      if (k[c] >= 0 && lane == leader) before = atomicAdd(&mine[k[c]], __popc(grp));
      r[c] = __shfl_sync(0xffffffffu, before, leader) + __popc(grp & lower);
    }
    __syncthreads();
    // threads over keys: each warp's base in the tile, the tile's count
    // published (an inclusive prefix at once in tile 0)
    for (int kk = threadIdx.x; kk < rows; kk += blockDim.x) {
      int s = 0;
      for (int w = 0; w < n_warps; ++w) {
        const int t = tab[w * rows + kk];
        tab[w * rows + kk] = s;
        s += t;
      }
      vstatus[(long long)tile * rows + kk] =
          (tile == 0 ? X1_INCLUSIVE : X1_AGGREGATE) | (unsigned)s;
    }
    // then each key's items before the tile, by look-back; the warps'
    // bases moved by it; the last tile's inclusive prefixes are the counts
    for (int kk = threadIdx.x; kk < rows; kk += blockDim.x) {
      const unsigned s = vstatus[(long long)tile * rows + kk] & X1_VALUE;   // its own word
      unsigned excl = 0u;
      if (tile > 0) {
        excl = x1_look_back(vstatus, tile, rows, kk);
        vstatus[(long long)tile * rows + kk] = X1_INCLUSIVE | (excl + s);
      }
      for (int w = 0; w < n_warps; ++w) tab[w * rows + kk] += (int)excl;
      if (tile == n_tiles - 1) counts[kk] = (int)(excl + s);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < X1_CHUNKS; ++c) {
      const long long i = first + c * 32;
      if (i < n) rank[i] = k[c] < n_keys ? r[c] + mine[k[c]] : -1;
    }
    __syncthreads();                              // the tables are dead
  }
}

// counts only, wide mode: a block's count table (the same warp groups),
// one global atomic a non-zero key into the zeroed counts
__global__ void __launch_bounds__(X1_THREADS)
    x1_counts_wide(const int* __restrict__ key, long long n, int n_keys,
                   int* __restrict__ counts) {
  extern __shared__ int cnt[];                    // n_keys + 1
  for (int j = threadIdx.x; j <= n_keys; j += blockDim.x) cnt[j] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long step = (long long)gridDim.x * X1_THREADS * X1_COUNT_UNROLL;
  for (long long base = ((long long)blockIdx.x * X1_WARPS + warp) * 32 * X1_COUNT_UNROLL;
       base < n; base += step) {                  // warp-uniform
    int k[X1_COUNT_UNROLL];
#pragma unroll
    for (int u = 0; u < X1_COUNT_UNROLL; ++u) {
      const long long i = base + u * 32 + lane;
      k[u] = -1;
      if (i < n) {
        const int v = key[i];
        k[u] = (unsigned)v >= (unsigned)n_keys ? n_keys : v;
      }
    }
#pragma unroll
    for (int u = 0; u < X1_COUNT_UNROLL; ++u) {
      const unsigned m = __match_any_sync(0xffffffffu, k[u]);
      if (k[u] >= 0 && lane == 31 - __clz(m)) atomicAdd(&cnt[k[u]], __popc(m));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j <= n_keys; j += blockDim.x)
    if (cnt[j] != 0) atomicAdd(&counts[j], cnt[j]);
}

// warps a tile of the wide mode: eight, or as many tables of rows ints as
// X1_SMEM holds
static int x1_warps(int rows) {
  const int fit = X1_SMEM / (rows * (int)sizeof(int));
  return fit < X1_WARPS ? fit : X1_WARPS;
}

// keys a tile of the ranked mode
static long long x1_tile(int rows) {
  return rows <= X1_PRIVATE_ROWS ? (long long)X1_THREADS * X1_ITEMS
                                 : (long long)x1_warps(rows) * 32 * X1_CHUNKS;
}

// the attribute a kernel needs for more than 48 KB of dynamic shared memory
template <class K>
static cudaError_t x1_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// resident blocks of ``kernel`` at ``threads`` and ``smem`` bytes
template <class K>
static int x1_resident(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// X1's launch over n > 0 keys: blocks (chunks of ``per`` tiles in the
// private ranked mode), dynamic shared memory, scratch words (the header,
// then the status words or the blocks' counts)
struct X1Plan {
  bool narrow, ranked;
  int rows, blocks, per, n_tiles, n_groups;
  size_t smem;
  long long words, zeroed;
  cudaError_t err;
};

static X1Plan x1_plan(long long n, int n_keys, bool ranked) {
  X1Plan p{};
  p.rows = n_keys + 1;
  p.narrow = p.rows <= X1_PRIVATE_ROWS;
  p.ranked = ranked;
  const long long tile = x1_tile(p.rows);
  p.n_tiles = (int)((n + tile - 1) / tile);
  if (p.narrow && !ranked) {
    p.smem = (size_t)p.rows * X1_THREADS * sizeof(int);
    p.err = x1_smem(x1_counts, p.smem);
    const int resident = x1_resident(x1_counts, X1_THREADS, p.smem);
    p.blocks = p.n_tiles < resident ? p.n_tiles : resident;
    // the ticket, then the copies of the counts
    p.words = p.zeroed = X1_HEADER + (long long)p.rows * X1_SPREAD * X1_PAD;
  } else if (p.narrow) {
    // chunks of ``per`` tiles: the fewest that let every chunk's block be
    // resident at once, X1_STAGE_TILES at most
    const size_t cols = (size_t)p.rows * X1_THREADS * sizeof(int);
    const size_t stage = (size_t)X1_THREADS * X1_ITEMS * sizeof(int);
    p.err = x1_smem(x1_ranks, cols + X1_STAGE_TILES * stage);
    for (p.per = 1; p.per < X1_STAGE_TILES; ++p.per)
      if (p.n_tiles <= (long long)p.per * x1_resident(x1_ranks, X1_THREADS, cols + p.per * stage))
        break;
    p.blocks = (p.n_tiles + p.per - 1) / p.per;
    p.n_groups = (p.blocks + X1_GROUP - 1) / X1_GROUP;
    p.smem = cols + p.per * stage;
    // the header, the chunks' and groups' counts, the groups' tickets
    p.words = X1_HEADER + (long long)p.rows * (p.blocks + p.n_groups) + p.n_groups;
    p.zeroed = p.words;
  } else if (ranked) {
    const int warps = x1_warps(p.rows);
    p.smem = (size_t)warps * p.rows * sizeof(int);
    p.err = x1_smem(x1_ranks_wide, p.smem);
    const int resident = x1_resident(x1_ranks_wide, warps * 32, p.smem);
    p.blocks = p.n_tiles < resident ? p.n_tiles : resident;
    p.words = p.zeroed = X1_HEADER + (long long)p.n_tiles * p.rows;
  } else {
    p.smem = (size_t)p.rows * sizeof(int);
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long blocks = (n + X1_THREADS * X1_COUNT_UNROLL - 1) / (X1_THREADS * X1_COUNT_UNROLL);
    if (blocks > (long long)sms * X1_COUNT_BLOCKS_PER_SM)
      blocks = (long long)sms * X1_COUNT_BLOCKS_PER_SM;
    p.blocks = (int)blocks;
    p.words = p.zeroed = 0;
  }
  return p;
}

// words of X1's scratch over n keys (n_keys as for pp_rank_in_key); -1
// where they exceed an int
extern "C" int pp_rank_in_key_scratch(long long n, int n_keys, int ranked) {
  if (n_keys < 1 || n_keys > X1_MAX_KEYS || n < 0 || n >= (1LL << 30)) return -1;
  if (n == 0) return 0;
  const X1Plan p = x1_plan(n, n_keys, ranked != 0);
  return p.words > 0x7fffffffLL ? -1 : (int)p.words;
}

// n (< 2^30) keys, n_keys the keys in range (the rest counted in row
// n_keys); counts: n_keys + 1 ints; rank: n ints, or null for the counts
// only; scratch: pp_rank_in_key_scratch(n, n_keys, rank != null) ints.
// One memset and one kernel in either mode.
extern "C" int pp_rank_in_key(const int* key, long long n, int n_keys, int* rank,
                              int* counts, int* scratch, cudaStream_t stream) {
  if (n_keys < 1 || n_keys > X1_MAX_KEYS || n < 0 || n >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int rows = n_keys + 1;
  if (n == 0) return (int)cudaMemsetAsync(counts, 0, (size_t)rows * sizeof(int), stream);
  const X1Plan p = x1_plan(n, n_keys, rank != nullptr);
  if (p.err != cudaSuccess) return (int)p.err;
  const int vec = (reinterpret_cast<uintptr_t>(key) | reinterpret_cast<uintptr_t>(rank)) % 16 == 0;
  unsigned* hdr = reinterpret_cast<unsigned*>(scratch);
  // the memset: the tickets and the count or status words, or the counts
  cudaError_t err = p.zeroed > 0
      ? cudaMemsetAsync(hdr, 0, (size_t)p.zeroed * sizeof(unsigned), stream)
      : cudaMemsetAsync(counts, 0, (size_t)rows * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (p.narrow && !p.ranked) {
    x1_counts<<<p.blocks, X1_THREADS, p.smem, stream>>>(key, n, n_keys, vec, counts, hdr,
                                                        hdr + X1_HEADER);
  } else if (p.narrow) {
    unsigned* agg = hdr + X1_HEADER;
    unsigned* gtot = agg + (long long)rows * p.blocks;
    x1_ranks<<<p.blocks, X1_THREADS, p.smem, stream>>>(
        key, n, n_keys, p.blocks, p.per, vec, rank, counts, hdr, agg, gtot,
        gtot + (long long)rows * p.n_groups);
  } else if (p.ranked) {
    x1_ranks_wide<<<p.blocks, X1_THREADS / X1_WARPS * x1_warps(rows), p.smem, stream>>>(
        key, n, n_keys, p.n_tiles, rank, counts, hdr, hdr + X1_HEADER);
  } else {
    x1_counts_wide<<<p.blocks, X1_THREADS, p.smem, stream>>>(key, n, n_keys, counts);
  }
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
