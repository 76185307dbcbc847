// Kernels Q and C: the particle structures' rebuild outside the slot map
// and the field gather.
//
//  Q rebuild_mask  Replaces (JAX reference) the mask rewrite and count of
//                  pumipic_tpu/particles/structure.py: the DPS rebuild
//                  (_rebuild, :436-449: elem = active & 0 <= ne < E ? ne :
//                  -1, active = elem >= 0, num_ptcls), the sorted rebuild's
//                  epilogue (_rebuild_sorted, :664-681: valid = pre_valid &
//                  key_src == elem_c, elem = valid ? elem_c : -1, num_ptcls)
//                  and the CSR / DPS-add form (:473-490: valid = j <
//                  needed, elem = valid ? key[take[j]] : -1, num_ptcls).
//                  Three modes of one pass; the count is a block sum and
//                  one integer atomic a block (integer sums are exact in
//                  any order).
//  C key_sort      Replaces the rebuilds' stable element sort
//                  (jnp.argsort(key, stable=True): _rebuild_sorted :557,
//                  the CSR branch :473, the DPS add path's 0/1 partition
//                  :483, get_pids :181) and the key before it
//                  (jnp.where(active, elem, E)): the int32 order of int32
//                  keys, equal to a stable argsort for every key.  That
//                  permutation is unique, so the kernel and torch.sort
//                  agree bit for bit.  With a payload (values), the last
//                  pass writes values[i] in place of index i: the
//                  reshuffle's mover slots in destination order.
//
// The TPU ran both as XLA code (a sort, fused elementwise ops, a
// reduction); no Pallas kernel.
//
// What bounds them on an H100: device-memory traffic.  Q reads 5–9 bytes a
// slot and writes 5.  C must at least read the keys and write the order, 8
// bytes a key; an LSD radix sort moves more (below).
//
// C's design: an LSD radix over the key's order-preserving unsigned image
// (the sign bit flipped), digits of at most 9 bits (512).  With bits the
// bit length of the caller's largest key K, the low passes take bits
// [0, bits) in ceil(bits / 9) passes of equal width (the app's 122,604
// keys: 9 + 8 bits, a 0/1 partition: 1 bit); the high passes take bits
// [bits, 32) and run only for keys outside [0, 2^bits).
//  - The histogram (ks_histogram, one launch after a memset of the header)
//    reads the keys once, or forms them from (elem, active, fill), writes
//    them out where the caller keeps them, and counts every pass's digits
//    at once (a warp's chunk of one digit adds once, another chunk a lane
//    at a time, into the block's shared counters; one global atomic a
//    block and nonzero digit).  It counts a key outside [0, 2^bits) in
//    the high passes' digits and raises the flag; the block that finishes
//    last (a ticket) adds the in-range keys to the high passes' digit of
//    0 and scans every pass's counts into its digits' first positions.
//  - Every pass runs in one launch (ks_passes) of resident blocks that
//    take (pass, tile) tickets in order: each pass's tiles of KS_TILE keys
//    in index order, then the next pass's.  A block whose ticket is the
//    first it holds of a pass waits until every tile of the pass before is
//    written (a count a pass), and reads what that pass wrote through L2
//    (ld.global.cg).  Every ticket before it is held by a running block, so
//    the wait ends.  Warp w ranks keys
//    [w·KS_WARP_KEYS, (w+1)·KS_WARP_KEYS) of its tile chunk by chunk on its
//    own shared counters (the rank among the lower lanes of its digit plus
//    the count the group's highest lane finds in the counter as it adds the
//    group: a warp's shared atomics on one address are done in order, so
//    the chunks need not wait for each other); the block publishes the
//    tile's count of each digit at
//    once, stages the tile in shared memory in digit order (the digit's
//    offset in the tile + the lower warps' counts + the rank), then takes
//    each digit's position before the tile by decoupled look-back over the
//    earlier tiles' status words (count or inclusive prefix, flag in the
//    top two bits) and publishes its inclusive prefix.  The staged tile is
//    written out in shared-memory order, so a digit's run goes to
//    consecutive addresses from consecutive threads.  Tiles are taken in
//    index order and a tile publishes its count before it waits, so the
//    look-back always ends.
//  - Ranks follow index order inside a chunk, a warp and a tile, tiles
//    follow index order through the look-back, so every pass is stable and
//    the result is the stable argsort.  The first pass reads the keys (or
//    forms them), the low passes write keys and indices, the last writes
//    the order alone.  The top low pass writes the order unless the flag
//    is raised; then it writes indices only, and each high pass reads its
//    keys through them (a gather: a key outside the range is rare).  With
//    the flag clear the high passes' tickets end the launch.  No host read.
//  - A pass zeroes the next pass's status words of its tiles; the
//    histogram the first pass's.
// What holds a pass back (scripts/ab_sort_place.py): each tile is a chain
// of dependent steps (the loads, the ranks, the look-back's L2 round
// trips, the write-out), ~20,000 cycles a tile at two blocks of 512
// threads an SM, so a pass is bound by that latency over the tiles a block
// takes, not by its bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#define Q_THREADS 256
#define Q_BLOCKS_PER_SM 8
#define KS_WARPS 16
#define KS_THREADS (32 * KS_WARPS)
#define KS_CHUNKS 8
// resident blocks a pass asks of the compiler (registers)
#define KS_MIN_BLOCKS 2
#define KS_WARP_KEYS (32 * KS_CHUNKS)
#define KS_TILE (KS_WARPS * KS_WARP_KEYS)
#define KS_MAX_BITS 9
#define KS_MAX_DIGITS (1 << KS_MAX_BITS)
// digits a pass's thread takes in its per-digit steps
#define KS_DPT (KS_MAX_DIGITS > KS_THREADS ? KS_MAX_DIGITS / KS_THREADS : 1)
#define KS_HIST_WARPS 8
#define KS_HIST_THREADS (32 * KS_HIST_WARPS)
// passes of a sort at most: ceil(bits / 9) + ceil((32 - bits) / 9)
#define KS_MAX_PASSES 5
// keys a histogram thread loads at once, and its blocks an SM
#define KS_HIST_UNROLL 4
// earlier tiles' status words a look-back reads at once
#define KS_LOOKBACK 8
#define KS_HIST_BLOCKS_PER_SM 8
// a tile's status word for one digit: its count (flag 1) or the digit's
// keys up to and with the tile (flag 2) below a flag in the top two bits
#define KS_AGGREGATE (1u << 30)
#define KS_INCLUSIVE (2u << 30)
#define KS_VALUE (KS_AGGREGATE - 1u)
// the header of C's scratch (u32 words, zeroed before each sort): each
// pass's digit counts and first positions, the keys outside the range, the
// histogram's ticket, the flag, the passes' (pass, tile) ticket and each
// pass's tiles written
#define KS_H_COUNTS 0
#define KS_H_STARTS (KS_MAX_PASSES * KS_MAX_DIGITS)
#define KS_H_OUT (2 * KS_MAX_PASSES * KS_MAX_DIGITS)
#define KS_H_TICKET (KS_H_OUT + 1)
#define KS_H_FLAG (KS_H_OUT + 2)
#define KS_H_TILE (KS_H_OUT + 3)
#define KS_H_DONE (KS_H_OUT + 4)
#define KS_HEADER (KS_H_DONE + KS_MAX_PASSES)

namespace {

// ---------------------------------------------------------------------------
// Q: rebuild_mask
// ---------------------------------------------------------------------------

enum { Q_DPS = 0, Q_EPILOGUE = 1, Q_PREFIX = 2 };

// mode Q_DPS: a = new_elem, m = active; Q_EPILOGUE: a = elem_c, m =
// pre_valid, b = key_src; Q_PREFIX: a = the gathered keys, needed = the
// count of leading slots that hold a particle
__global__ void __launch_bounds__(Q_THREADS) rebuild_mask_kernel(
    int mode, const int* __restrict__ a, const uint8_t* __restrict__ m,
    const int* __restrict__ b, int n_elems, const int* __restrict__ needed,
    int* __restrict__ elem_out, uint8_t* __restrict__ active_out,
    int* __restrict__ num, long long n) {
  __shared__ int warp_sum[Q_THREADS / 32];
  const long long lim = mode == Q_PREFIX ? (long long)*needed : 0;
  int count = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int ai = a[i];
    bool keep;
    if (mode == Q_DPS) {
      keep = m[i] != 0 && ai >= 0 && ai < n_elems;
    } else if (mode == Q_EPILOGUE) {
      keep = m[i] != 0 && b[i] == ai;
    } else {
      keep = i < lim;
    }
    elem_out[i] = keep ? ai : -1;
    active_out[i] = keep;
    count += keep;
  }
  // the block's count, one atomic
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = count;
  __syncthreads();
  if (warp == 0) {
    int s = lane < Q_THREADS / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0 && s) atomicAdd(num, s);
  }
}

// ---------------------------------------------------------------------------
// C: key_sort
// ---------------------------------------------------------------------------

// inclusive scan of v over the block (blockDim.x a multiple of 32); the
// block's total in *total; smem holds 32 ints
__device__ int ks_block_scan(int v, int* smem, int* total) {
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

enum { KS_LOW = 0, KS_TOP = 1, KS_HI = 2, KS_HI_LAST = 3 };

// the keys: key[i], or formed as active[i] ? (elem ? elem[i] : 0) : fill
struct KsSrc {
  const int* key;
  const int* elem;
  const uint8_t* active;
  int fill;
};

// the sort's passes as the launcher plans them: each pass's bits, mode,
// inputs (the last low pass's keys or the source; the last pass's indices
// or i), outputs (keys and indices, or indices; the last pass writes the
// order) and status words
struct KsPlan {
  int n_pass, n_low, bits;
  int shift[KS_MAX_PASSES], width[KS_MAX_PASSES], mode[KS_MAX_PASSES];
  const int* key_in[KS_MAX_PASSES];
  const int* idx_in[KS_MAX_PASSES];
  int* key_out[KS_MAX_PASSES];
  int* idx_out[KS_MAX_PASSES];
  unsigned* status[KS_MAX_PASSES];
  // where not null, the last pass writes values[i] in place of index i
  const int* values;
};

__device__ __forceinline__ int ks_load(const KsSrc& s, long long i) {
  if (s.active == nullptr) return s.key[i];
  const int e = s.elem != nullptr ? s.elem[i] : 0;   // both loads at once
  return s.active[i] ? e : s.fill;
}

// bits [shift, shift + width) of the key's order-preserving unsigned image
__device__ __forceinline__ int ks_digit(int key, int shift, int width) {
  return (int)((((unsigned)key ^ 0x80000000u) >> shift) & ((1u << width) - 1u));
}

// a digit's keys in the tiles before ``tile``: the earlier tiles' status
// words read KS_LOOKBACK at a time and summed back to the nearest
// inclusive prefix (a word not yet published is read again)
__device__ __forceinline__ unsigned ks_look_back(volatile unsigned* vstatus, int tile, int D,
                                                 int d) {
  unsigned excl = 0u;
  for (long long j = tile - 1; j >= 0;) {
    unsigned s[KS_LOOKBACK];
#pragma unroll
    for (int k = 0; k < KS_LOOKBACK; ++k)
      s[k] = j - k >= 0 ? vstatus[(j - k) * D + d] : KS_INCLUSIVE;
    int used = 0;
    bool done = false;
#pragma unroll
    for (int k = 0; k < KS_LOOKBACK; ++k) {
      if (used == k && !done && s[k] >= KS_AGGREGATE) {   // the words before k summed
        excl += s[k] & KS_VALUE;
        used = k + 1;
        done = s[k] >= KS_INCLUSIVE;
      }
    }
    if (done) break;
    j -= used;
  }
  return excl;
}

// every pass's digit counts, the keys outside [0, 2^bits), the keys
// written out (key_out not null) and the first pass's status words zeroed;
// the last block to finish scans the counts into the digits' first
// positions and sets the flag
__global__ void __launch_bounds__(KS_HIST_THREADS) ks_histogram(
    KsSrc src, long long n, KsPlan pl, int* __restrict__ key_out,
    unsigned* __restrict__ hdr, unsigned* __restrict__ status0, long long status0_words) {
  __shared__ int cnt[KS_MAX_PASSES * KS_MAX_DIGITS];
  __shared__ int smem[32];
  __shared__ int s_last;
  for (int j = threadIdx.x; j < KS_MAX_PASSES * KS_MAX_DIGITS; j += KS_HIST_THREADS) cnt[j] = 0;
  for (long long j = (long long)blockIdx.x * KS_HIST_THREADS + threadIdx.x; j < status0_words;
       j += (long long)gridDim.x * KS_HIST_THREADS)
    status0[j] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned range = 1u << pl.bits;
  int n_out = 0;
  const long long step = (long long)gridDim.x * KS_HIST_WARPS * 32 * KS_HIST_UNROLL;
  for (long long base = ((long long)blockIdx.x * KS_HIST_WARPS + warp) * 32 * KS_HIST_UNROLL;
       base < n; base += step) {                  // warp-uniform
    int k[KS_HIST_UNROLL];
#pragma unroll
    for (int u = 0; u < KS_HIST_UNROLL; ++u) {
      const long long i = base + u * 32 + lane;
      k[u] = i < n ? ks_load(src, i) : 0;
      if (key_out != nullptr && i < n) key_out[i] = k[u];
    }
#pragma unroll
    for (int u = 0; u < KS_HIST_UNROLL; ++u) {
      const bool valid = base + u * 32 + lane < n;
      const bool out = valid && (unsigned)k[u] >= range;
      n_out += out;
      const int passes = __any_sync(0xffffffffu, out) ? pl.n_pass : pl.n_low;
#pragma unroll
      for (int p = 0; p < KS_MAX_PASSES; ++p) {
        if (p < passes) {                         // warp-uniform
          const bool counted = p < pl.n_low ? valid : out;
          const int d = ks_digit(k[u], pl.shift[p], pl.width[p]);
          // a chunk of one digit adds once; another, a lane at a time
          // (every lane takes part in each intrinsic: none in an && operand)
          const int d0 = __shfl_sync(0xffffffffu, d, 0);
          const unsigned same = __ballot_sync(0xffffffffu, counted && d == d0);
          if (same == 0xffffffffu) {
            if (lane == 0) atomicAdd(&cnt[p * KS_MAX_DIGITS + d], 32);
          } else if (counted) {
            atomicAdd(&cnt[p * KS_MAX_DIGITS + d], 1);
          }
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) n_out += __shfl_down_sync(0xffffffffu, n_out, o);
  if (lane == 0) smem[warp] = n_out;
  __syncthreads();
  for (int j = threadIdx.x; j < pl.n_pass * KS_MAX_DIGITS; j += KS_HIST_THREADS)
    if (cnt[j] != 0) atomicAdd(hdr + KS_H_COUNTS + j, (unsigned)cnt[j]);
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < KS_HIST_WARPS; ++w) t += smem[w];
    if (t != 0) atomicAdd(hdr + KS_H_OUT, (unsigned)t);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(hdr + KS_H_TICKET, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const volatile unsigned* vh = hdr;
  const unsigned total_out = vh[KS_H_OUT];
#pragma unroll
  for (int p = 0; p < KS_MAX_PASSES; ++p) {
    if (p < pl.n_pass) {
      const int D = 1 << pl.width[p];
      // a high pass's digit of the keys in [0, 2^bits): that of key 0
      const int dz = p < pl.n_low ? -1 : ks_digit(0, pl.shift[p], pl.width[p]);
      const unsigned in_range = (unsigned)n - total_out;
      const int d0 = 2 * threadIdx.x;
      int c0 = 0, c1 = 0;
      if (d0 < D) c0 = (int)(vh[KS_H_COUNTS + p * KS_MAX_DIGITS + d0] + (d0 == dz ? in_range : 0u));
      if (d0 + 1 < D)
        c1 = (int)(vh[KS_H_COUNTS + p * KS_MAX_DIGITS + d0 + 1] + (d0 + 1 == dz ? in_range : 0u));
      int total;
      const int incl = ks_block_scan(c0 + c1, smem, &total);
      if (d0 < D) hdr[KS_H_STARTS + p * KS_MAX_DIGITS + d0] = (unsigned)(incl - c0 - c1);
      if (d0 + 1 < D) hdr[KS_H_STARTS + p * KS_MAX_DIGITS + d0 + 1] = (unsigned)(incl - c1);
    }
  }
  if (threadIdx.x == 0) hdr[KS_H_FLAG] = total_out != 0u;
}

// every pass of the sort: (pass, tile) tickets in order; a pass's keys
// from key_in (or formed from src; in the high passes gathered from src
// through idx_in), their source indices from idx_in (i where null); out:
// keys and indices (KS_LOW), the order (the last pass) or indices alone
// (the top low pass when the flag is set, the high passes)
__global__ void __launch_bounds__(KS_THREADS, KS_MIN_BLOCKS) ks_passes(
    KsSrc src, KsPlan pl, long long n, int n_tiles, unsigned* hdr, int* order) {
  __shared__ union {
    int wcnt[KS_WARPS][KS_MAX_DIGITS];
    struct {
      int key[KS_TILE];
      int idx[KS_TILE];
    } t;
  } sm;
  __shared__ int loc[KS_MAX_DIGITS], gofs[KS_MAX_DIGITS], smem[32];
  __shared__ int s_ticket;
  const bool flag = hdr[KS_H_FLAG] != 0u;         // the histogram's, a launch before
  const int passes = flag ? pl.n_pass : pl.n_low;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  int ready = 0;                                  // the passes before it are written
  for (;;) {
    if (threadIdx.x == 0) {
      const int t = (int)atomicAdd(hdr + KS_H_TILE, 1u);
      const int p = t / n_tiles;
      if (p > ready && p < passes) {              // every tile of pass p - 1 written
        const volatile unsigned* done = hdr + KS_H_DONE;
        while (done[p - 1] < (unsigned)n_tiles) __nanosleep(100);
        __threadfence();
      }
      s_ticket = t;
    }
    __syncthreads();
    const int p = s_ticket / n_tiles, tile = s_ticket % n_tiles;
    if (p >= passes) return;
    ready = p;
    const int shift = pl.shift[p], width = pl.width[p], mode = pl.mode[p];
    const bool last = p == passes - 1, gather = mode >= KS_HI;
    const int D = 1 << width;
    volatile unsigned* vstatus = pl.status[p];
    for (int d = threadIdx.x; d < D; d += KS_THREADS) {
#pragma unroll
      for (int w = 0; w < KS_WARPS; ++w) sm.wcnt[w][d] = 0;
    }
    __syncthreads();
    const long long t0 = (long long)tile * KS_TILE;
    const int tile_n = (int)min((long long)KS_TILE, n - t0);
    // the tile's slices (an earlier pass of this launch wrote them: read
    // through L2); key li of the tile is chunk (li - first) / 32's
    const int* kin = pl.key_in[p] != nullptr ? pl.key_in[p] + t0 : nullptr;
    const int* iin = pl.idx_in[p] != nullptr ? pl.idx_in[p] + t0 : nullptr;
    const int first = warp * KS_WARP_KEYS + lane;
    // the keys and their source indices (loaded together)
    int k[KS_CHUNKS], ix[KS_CHUNKS], r[KS_CHUNKS];
#pragma unroll
    for (int c = 0; c < KS_CHUNKS; ++c) {
      const int li = first + c * 32;
      k[c] = 0;
      ix[c] = (int)t0 + li;
      if (li < tile_n) {
        if (iin != nullptr) ix[c] = __ldcg(iin + li);
        k[c] = gather ? ks_load(src, ix[c]) : (kin != nullptr ? __ldcg(kin + li) : ks_load(src, t0 + li));
      }
    }
    // ranks inside the warp, chunk after chunk: the group's highest lane
    // adds the group to the warp's counter of its digit and broadcasts the
    // count before it (a warp's shared atomics on one address are done in
    // order, so no chunk waits for the one before)
#pragma unroll
    for (int c = 0; c < KS_CHUNKS; ++c) {
      const bool valid = first + c * 32 < tile_n;
      const int d = ks_digit(k[c], shift, width);
      const unsigned grp = __match_any_sync(0xffffffffu, valid ? d : -1);
      const int leader = 31 - __clz(grp);
      int before = 0;
      if (valid && lane == leader) before = atomicAdd(&sm.wcnt[warp][d], __popc(grp));
      r[c] = __shfl_sync(0xffffffffu, before, leader) + __popc(grp & lower);
    }
    __syncthreads();
    // the tile's count of each digit (published at once) and the lower
    // warps' counts
    for (int d = threadIdx.x; d < D; d += KS_THREADS) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < KS_WARPS; ++w) {
        const int t = sm.wcnt[w][d];
        sm.wcnt[w][d] = s;
        s += t;
      }
      loc[d] = s;
      vstatus[(long long)tile * D + d] = (tile == 0 ? KS_INCLUSIVE : KS_AGGREGATE) | (unsigned)s;
    }
    __syncthreads();
    {  // each digit's first place in the tile: the exclusive scan of the counts
      const int d0 = KS_DPT * threadIdx.x;
      int c[KS_DPT], sum = 0;
#pragma unroll
      for (int j = 0; j < KS_DPT; ++j) {
        c[j] = d0 + j < D ? loc[d0 + j] : 0;
        sum += c[j];
      }
      int total;
      int at = ks_block_scan(sum, smem, &total) - sum;
#pragma unroll
      for (int j = 0; j < KS_DPT; ++j) {
        if (d0 + j < D) loc[d0 + j] = at;
        at += c[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KS_CHUNKS; ++c) {
      if (first + c * 32 < tile_n) {
        const int d = ks_digit(k[c], shift, width);
        r[c] += loc[d] + sm.wcnt[warp][d];
      }
    }
    __syncthreads();                              // the counters are dead
    // the tile staged in digit order
#pragma unroll
    for (int c = 0; c < KS_CHUNKS; ++c) {
      if (first + c * 32 < tile_n) {
        sm.t.key[r[c]] = k[c];
        sm.t.idx[r[c]] = ix[c];
      }
    }
    // each digit's keys before this tile: look back over the earlier tiles
    const unsigned* starts = hdr + KS_H_STARTS + p * KS_MAX_DIGITS;
    for (int d = threadIdx.x; d < D; d += KS_THREADS) {
      const int count = (d + 1 < D ? loc[d + 1] : tile_n) - loc[d];
      const unsigned excl = ks_look_back(vstatus, tile, D, d);
      if (tile > 0) vstatus[(long long)tile * D + d] = KS_INCLUSIVE | (excl + (unsigned)count);
      gofs[d] = (int)(starts[d] + excl) - loc[d];
    }
    if (!last) {                                  // the next pass's status words
      const int next_digits = 1 << pl.width[p + 1];
      unsigned* next_status = pl.status[p + 1];
      for (int d = threadIdx.x; d < next_digits; d += KS_THREADS)
        next_status[(long long)tile * next_digits + d] = 0u;
    }
    __syncthreads();
    // out in staged order: a digit's run to consecutive positions
    int* const iout = last ? order : pl.idx_out[p];
    int* const kout = mode == KS_LOW ? pl.key_out[p] : nullptr;
    const int* const vals = last ? pl.values : nullptr;
    for (int s = threadIdx.x; s < tile_n; s += KS_THREADS) {
      const int key = sm.t.key[s];
      const int pos = gofs[ks_digit(key, shift, width)] + s;
      const int i = sm.t.idx[s];
      iout[pos] = vals != nullptr ? __ldg(vals + i) : i;
      if (kout != nullptr) kout[pos] = key;
    }
    __syncthreads();
    // the tile written, for the next pass (a warp that does not take the
    // ticket, so the fence waits beside it)
    if (!last && threadIdx.x == 32) {
      __threadfence();
      atomicAdd(hdr + KS_H_DONE + p, 1u);
    }
  }
}

}  // namespace

extern "C" int pp_rebuild_mask(int mode, const int* a, const uint8_t* m, const int* b,
                               int n_elems, const int* needed, int* elem_out,
                               uint8_t* active_out, int* num, long long n,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  const cudaError_t err = cudaMemsetAsync(num, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + Q_THREADS - 1) / Q_THREADS;
  const long long cap = (long long)sms * Q_BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  rebuild_mask_kernel<<<(unsigned)blocks, Q_THREADS, 0, stream>>>(
      mode, a, m, b, n_elems, needed, elem_out, active_out, num, n);
  return (int)cudaGetLastError();
}

// words of a key_sort's int32 scratch over n (< 2^30) keys: the header,
// then two status buffers of KS_MAX_DIGITS words a tile
extern "C" int pp_key_sort_scratch(long long n) {
  return (int)(KS_HEADER + 2LL * ((n + KS_TILE - 1) / KS_TILE) * KS_MAX_DIGITS);
}

// the stable order of n (< 2^30) int32 keys into ``order`` (or, where
// ``values`` is not null, values[] in that order), bits the bit length of
// the caller's largest key (1..31).  The keys are key[i], or,
// where active is not null, active[i] ? (elem ? elem[i] : 0) : fill, then
// written to key_out where it is not null.  Scratch: ``scratch``
// (pp_key_sort_scratch words), a key and an index buffer of n (ka, ia)
// from two low passes on, another pair (kb, ib) from three, and one index
// buffer of n (spare) for the high passes.
extern "C" int pp_key_sort(const int* key, const int* elem, const uint8_t* active, int fill,
                           long long n, int bits, int* key_out, int* order,
                           unsigned* scratch, int* ka, int* ia, int* kb, int* ib,
                           int* spare, const int* values, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n >= (1LL << 30) || bits < 1 || bits > 31) return (int)cudaErrorInvalidValue;
  KsPlan pl{};
  pl.bits = bits;
  pl.values = values;
  pl.n_low = (bits + KS_MAX_BITS - 1) / KS_MAX_BITS;
  const int w_low = (bits + pl.n_low - 1) / pl.n_low;
  const int n_hi = (32 - bits + KS_MAX_BITS - 1) / KS_MAX_BITS;
  const int w_hi = (32 - bits + n_hi - 1) / n_hi;
  pl.n_pass = pl.n_low + n_hi;
  if (pl.n_pass > KS_MAX_PASSES) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < pl.n_pass; ++p) {
    const int s = p < pl.n_low ? p * w_low : bits + (p - pl.n_low) * w_hi;
    const int end = p < pl.n_low ? bits : 32;
    const int w = p < pl.n_low ? w_low : w_hi;
    pl.shift[p] = s;
    pl.width[p] = end - s < w ? end - s : w;
  }
  const int n_tiles = (int)((n + KS_TILE - 1) / KS_TILE);
  unsigned* hdr = scratch;
  unsigned* stat[2] = {scratch + KS_HEADER,
                       scratch + KS_HEADER + (long long)n_tiles * KS_MAX_DIGITS};
  int* kbuf[2] = {ka, kb};
  int* ibuf[2] = {ia, ib};
  for (int p = 0; p < pl.n_pass; ++p) {
    pl.mode[p] = p < pl.n_low - 1 ? KS_LOW
                 : p == pl.n_low - 1 ? KS_TOP
                 : p == pl.n_pass - 1 ? KS_HI_LAST : KS_HI;
    // inputs: the source (pass 0, and the high passes' gathers), the last
    // low pass's keys and indices, or the last high pass's indices
    pl.key_in[p] = p == 0 || p >= pl.n_low ? nullptr : kbuf[(p - 1) % 2];
    pl.idx_in[p] = p == 0 ? nullptr
                   : p <= pl.n_low - 1 ? ibuf[(p - 1) % 2]
                   : ((pl.n_pass - p) % 2 == 0 ? order : spare);
    // outputs: a low pass's pair, or the indices of the top and high
    // passes in turns that end in ``order``
    pl.key_out[p] = pl.mode[p] == KS_LOW ? kbuf[p % 2] : nullptr;
    pl.idx_out[p] = pl.mode[p] == KS_LOW ? ibuf[p % 2]
                    : ((pl.n_pass - 1 - p) % 2 == 0 ? order : spare);
    pl.status[p] = stat[p % 2];
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ks_passes, KS_THREADS, 0);
  if (per_sm < 1) per_sm = 1;
  cudaError_t err = cudaMemsetAsync(hdr, 0, KS_HEADER * sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const KsSrc src{key, elem, active, fill};
  long long hist_blocks =
      (n + KS_HIST_THREADS * KS_HIST_UNROLL - 1) / (KS_HIST_THREADS * KS_HIST_UNROLL);
  if (hist_blocks > (long long)sms * KS_HIST_BLOCKS_PER_SM)
    hist_blocks = (long long)sms * KS_HIST_BLOCKS_PER_SM;
  ks_histogram<<<(unsigned)hist_blocks, KS_HIST_THREADS, 0, stream>>>(
      src, n, pl, key_out, hdr, stat[0], (long long)n_tiles << pl.width[0]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // every pass in one launch: the resident blocks take the tickets
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  ks_passes<<<grid, KS_THREADS, 0, stream>>>(src, pl, n, n_tiles, hdr, order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return 0;
}
