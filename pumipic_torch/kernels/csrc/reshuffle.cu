// Kernels U1, U2, U3 and Z: the particle structures' reshuffle-or-rebuild
// and the Sell-C-σ row order.
//
//  U1 reshuffle_count  Replaces (JAX reference) _rebuild_auto
//                      (pumipic_tpu/particles/structure.py:702-730): stay =
//                      elem >= 0 & elem == ps.elem, mover = elem >= 0 &
//                      ~stay, the stayers' and movers' counts per element
//                      (one 2E-key histogram there), n_mov and the fits
//                      check all(mov_cnt <= seg_cap - stay_cnt) & n_mov <=
//                      MB; and _reshuffle's first steps (:790-797): the
//                      movers' slots in slot order (the stable sort's input
//                      order) with their destinations, and the movers'
//                      first places in the destination-sorted list
//                      (cumsum(mov_cnt)).
//  U2 reshuffle_place  Replaces the rest of _reshuffle (:799-848): the r-th
//                      mover of element e (in the stable destination order)
//                      takes the r-th hole (a slot of e's segment without a
//                      stayer) in the segment's q order, with every field,
//                      its element and the mask; a slot whose particle left
//                      and that no mover fills ends empty (-1, inactive);
//                      num_ptcls is the count of the output mask.
//  U3 reshuffle_order Replaces _reshuffle's stable sort of the movers by
//                      destination (:765, argsort(dest, stable=True)): given
//                      U1's movers in slot order (mkey, msrc) and the
//                      destinations' first places mov_start, mover i goes to
//                      mov_start[k_i] + r_i, r_i the movers before it with the
//                      same destination: take = msrc in destination order.
//  Z  scs_row_order    Replaces _scs_row_order (:312-345) after the pad: the
//                      descending stable sort of the padded counts within σ
//                      windows (the padding rows, count -1, last in theirs),
//                      the element -> row map and each chunk's width (the
//                      largest count of its rows, 0 for padding).
//
// The TPU ran all of it as XLA code (a one-hot matmul histogram, a slot-
// rate argsort, cumsums, a searchsorted and scatters); no Pallas kernel.
//
// What bounds them on an H100: device-memory bytes.  U1 reads two int32
// ids a slot (8 bytes) and writes the movers' slots and keys; U2 reads the
// same two ids over the segments, writes each slot's id and mask (5 bytes)
// and reads and writes the movers' rows; U3 reads each mover's key and slot
// and writes its slot once (12 bytes a mover); Z reads the counts and
// writes the three maps (mesh-rate).  U3 and Z are small (~10^5 items):
// what holds them back is launches and the waits between their steps, so
// each is one launch whose steps wait at barriers instead of launches: U3
// a cooperative launch over the whole card (every block resident at once,
// ~1.1 us a grid barrier at 132 blocks), Z one thread block cluster (~0.7
// us a cluster barrier).
//
// U1's counters.  2E int32 counters (stay keys e, mover keys E + e) are
// 196 KB at the 16^3 box's 24,576 tets and 981 KB at a 122,603-element
// mesh: shared memory holds them at one block an SM at best, and a
// private copy a block (kernel X1's private mode) would multiply the
// zeroing and the final sum by the block count.  So, as kernel H does,
// they live in global memory (the L2) and the adds are merged before they
// reach it: slot j of a warp's 32 threads lie U_J apart, in one row of a
// Sell-C-σ chunk (U_J a multiple of the chunk) or mostly in one CabM
// segment, so the stayers of one element among them add once
// (__match_any_sync); movers add alone, or merged the same way where a
// warp holds more than U_MERGE_AT of them (from ~4% of its slots: the
// fallback's long pushes).  Movers are counted only while the movers
// before and in the tile fit the budget MB: past it the reshuffle cannot
// run (fits is false) and the sort rebuild counts afresh.  A tile whose
// movers pass MB raises a flag; a tile that starts after it (its place is
// past MB too) counts its stayers and movers alone: no stayers' adds, no
// look-back, no list.  So stay_cnt, mov_cnt and
// mov_start are exact only where n_mov <= MB.  The block that finishes
// last (a ticket, as kernel X1's counts-only mode) checks fits over the E
// elements and scans the movers' counts into their first places, each
// warp reading 32 consecutive elements a round; past MB it only writes
// fits = 0.
//
// U1's schedule: tiles of U_TILE consecutive slots taken by tickets in
// order (a block a tile); a thread takes U_J consecutive slots (16-byte
// loads), so the tile's slot order is the threads' order: a block scan of
// the threads' movers and a decoupled look-back over the earlier tiles'
// status words (count or inclusive prefix, saturated at MB + 1, flag in
// the top two bits) place them in the mover list in slot order, and the
// stable sort that follows keeps slot order within a destination, as the
// JAX argsort does.  Measured against (PERF.md): the first U1 (every mover
// added alone, the last block reading elements 16 apart: 0.040 ms of its
// 0.114), 256- and 512-thread tiles (more look-backs: slower), warp tiles
// of 512 slots each with its own look-back (1.5x slower), tiles in launch
// order without tickets with the stayers' adds beside warp 0's look-back
// (1.2x slower), the movers' ids read again after the look-back to free
// registers for more resident blocks (1.2x slower), lanes taking slots
// U_THREADS apart with per-lane runs of a row (CabM's runs broke every
// other slot: 2.4x slower there), U_J = 32.
//
// U2's schedule: a warp a unit, a Sell-C-σ chunk or a CabM segment, in
// rounds of 32 consecutive slots (128 bytes of each id array): a chunk of
// c <= 32 rows takes 32 / c q's of its c rows a round (c = 8: 4 q's of 8
// rows; wider chunks 32 rows of one q), so lane l serves row l mod c in
// every round, and a row's holes are ranked in q order by a ballot masked
// to the lanes of that row; each lane keeps its row's running hole count,
// element, mov_cnt and mov_start in registers.  U2_UNROLL rounds' loads are
// in flight at once.  The hole of rank r < mov_cnt[e] takes staged row
// mov_start[e] + r.  Every slot's element and mask are written once: a
// stayer, a filled hole, an empty hole or a padding row's slot (-1,
// inactive); the first blocks write the slots past the layout's end.  The
// fields are written in place (the structure's own tensors): the staged
// rows (kernel G's gather of the movers, in C's order) make a mover's
// source slot that is another mover's destination harmless, and the
// kernel never reads a field.  A segment with fewer holes below the
// capacity C than movers sets the sticky overflow flag and counts only the
// placed particles.
//
// U3's design: one cooperative launch over the whole card (a block or two
// an SM, all resident, three grid barriers), no memset and no histogram:
// U1 counted the movers of each destination and scanned them into
// mov_start, so a bucket of 2^bs consecutive destinations (at most 256
// buckets: 192 of 128 tets at 24,576) starts at mov_start of its first.
// (1) Each block takes a tile of consecutive movers (a warp a contiguous
// part of it) and counts them by bucket in its warps' tables (shared
// atomic adds, no __match_any_sync; aggregating the lanes of lane 0's
// bucket, as Z does, was 5% slower here); it writes its count of each
// bucket to a bucket-major scratch.  (2) Each bucket's column of tile
// counts is scanned by one block into each tile's first place in the
// bucket.  (3) Each warp places its part, in order, into a scratch copy
// grouped by bucket (equal buckets ranked by __match_any_sync), keys and
// slots.  (4) Each bucket is then one block's: its movers, in list order,
// ranked by key in the warps' tables from mov_start of each key, written
// to take.
// A warp's table holds U3_TABLE_KEYS keys; a bucket of more keys (E >
// 2^(U3_BUCKET_BITS + 11) = 524,288) takes them in turns (the turns form),
// each turn reading the bucket again.  (A first design on one thread block
// cluster, counters a destination in each block's shared memory and the
// blocks' order from their fields, took 0.074 ms at 273,644 movers: the
// cluster's 16 SMs, __match_any_sync's cost of ~36 cycles a distinct value,
// and moving E counters a block.)
//
// Z's design: a radix sort of the rows in one launch of one thread block
// cluster (16 blocks where the card schedules them, else 8) with no key
// array and no memset: each block reads a contiguous slice of the rows (a
// warp a contiguous part of it, Z_UNROLL rounds' loads at once) and the
// counts; the cluster's min and max count (padding rows -1; distributed
// shared memory) give the key max - count (ascending = descending count,
// padding last) and its range.  One window takes one pass of at most
// Z_DMAX bits: a key more than 2^Z_DMAX - 2 below the largest (a count far
// above the rest: the app's few dense elements) goes to bin 0, which
// comes first, and a second stage in the same launch ranks those rows (at
// most Z_BIG) by descending count; more of them, or σ windows, take LSD
// passes of equal digits over the key, then over the row's window, every
// pass stable.  A pass: each warp counts its part's digits in a table of
// its own in shared memory (the lanes equal to lane 0's digit added at
// once, the others alone); each block scans them over its warps and writes
// its counts to an L2 scratch row; after the cluster's barrier every block
// reads all the rows (coalesced: one barrier a pass, where exchanging them
// through distributed shared memory took three) and scans them into its
// first place of each digit; then each warp places its part in order, a
// digit's equal rows ranked by __match_any_sync, from its table.  A pass
// before the last writes the rows to a scratch array in global memory (L2;
// the next pass reads it past L1); the last writes row_to_elem and
// elem_to_row.  A chunk's width is the count of its first row and of each
// window's first row in it (the rows of a window descend).  The rows are
// never held in shared memory, so any R sorts in the one launch; above
// ~10^6 rows one cluster's 16 SMs take longer than a device-wide sort
// would.  (The same design as one cooperative launch over the card took
// 0.0298 ms at 122,608 rows and 0.0185 at 24,576: its grid barriers and
// the tiles' digit columns cost more than the cluster's 16 SMs lose.)
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define U_THREADS 1024
// blocks of U1 resident on an SM (the register cap)
#define U_MIN_BLOCKS 1
// a warp's movers above which their adds are merged by key (else one a mover)
#define U_MERGE_AT 20
// U1's stripped builds (scripts/ab_reshuffle.py --variants, timed, never
// compared): 1 the loads alone, 2 + the stayers' adds, 3 + the scan and
// the look-back, 4 + the movers' writes and adds, 5 (the kernel) + the
// last block
#define U1_STAGE 5
#define U_J 16
#define U_TILE (U_THREADS * U_J)
// elements a lane of the last block takes at once, 32 apart
#define U_LAST 8
#define U2_THREADS 128
// blocks that write the slots past the layout's end
#define U2_TAIL_BLOCKS 128
// q rounds of 32 slots a U2 warp loads at once
#define U2_UNROLL 8
// a U2 warp's filled holes held before their rows are copied together
#define U2_FILLS 256
// U2's stripped build (timed, never compared): 1 the walk, its loads and
// the element and mask writes, no fills; 2 the kernel
#define U2_STAGE 2
#define U_MAX_FIELDS 16
// U3: a block's threads; the key buckets (at most 2^U3_BUCKET_BITS, of
// 2^bs keys each); the keys a warp's table holds in the bucket pass (more
// in turns); the blocks an SM takes at most; the rounds of 32 whose loads
// a warp issues at once
#define U3_THREADS 512
#define U3_WARPS (U3_THREADS / 32)
#define U3_BUCKET_BITS 8
#define U3_TABLE_KEYS 2048
#define U3_BLOCKS_PER_SM 2
#define U3_UNROLL 4
// Z: a block's warps (each with a digit table), the widest digit, the
// rows of the clamped pass's big bin its second stage ranks at most, and
// the rounds of 32 whose loads a warp issues at once
#define Z_THREADS 512
#define Z_WARPS (Z_THREADS / 32)
#define Z_DMAX 11
#define Z_BINS (1 << Z_DMAX)
#define Z_BIG 1024
#define Z_UNROLL 8
// Z's shared words: the warps' tables, the block's digit counts, then 32
// for the block scan and 96 for reductions
#define Z_MISC 128
#define Z_SMEM (((Z_WARPS + 1) * Z_BINS + Z_MISC) * 4)
// the largest cluster tried (blocks of one cluster, on neighbouring SMs)
#define ORDER_CLUSTER_MAX 16
// stripped builds of U3 and Z (scripts/ab_reshuffle.py --variants, timed,
// never compared): U3 1 the tiles' bucket counts, 2 + the columns' scans,
// 3 + the tiles' placement by bucket, 4 (the kernel) + the buckets'
// placement by key; Z 1 the min and max, 2 + each pass's zeroing and
// count, 3 + the warps' prefix and the block's row, 4 + the rows' exchange
// and the first places, 5 + the walks, 6 (the kernel) + the big rows'
// stage and the widths
#define U3_STAGE 4
#define Z_STAGE 6
// a tile's status word: its movers (flag 1) or the movers up to and with
// it (flag 2), saturated at MB + 1, below a flag in the top two bits
#define U_AGGREGATE (1u << 30)
#define U_INCLUSIVE (2u << 30)
#define U_VALUE (U_AGGREGATE - 1u)
// the header words of U1's scratch (after the 2E counters)
#define U_H_TICKET 0
#define U_H_DONE 1
#define U_H_NMOV 2
#define U_H_NSTAY 3
#define U_H_PAST 4        // set once the movers up to a tile pass MB
#define U_HEADER 8

namespace {

__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// inclusive scan of v over the block (blockDim.x a multiple of 32, at most
// 1024); the block's total in *total; smem holds 32 ints
__device__ int block_scan(int v, int* smem, int* total) {
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

// the movers before ``tile``, saturated at ``cap``: the earlier tiles'
// status words, 32 at a time, summed back to the nearest inclusive prefix
// or until the sum reaches ``cap`` (warp-wide; a word not yet published is
// read again: every earlier tile is held by a running block, which
// publishes its count before it looks back)
__device__ unsigned look_back(volatile unsigned* status, long long tile, int lane,
                              unsigned cap) {
  unsigned excl = 0u;
  for (long long j = tile - 1; j >= 0; j -= 32) {
    const long long jj = j - lane;
    unsigned s = U_INCLUSIVE;
    if (jj >= 0) {
      s = status[jj];
      while (s < U_AGGREGATE) s = status[jj];
    }
    const unsigned incl = __ballot_sync(0xffffffffu, s >= U_INCLUSIVE);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned v = lane <= stop ? min(s & U_VALUE, cap) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = min(v + __shfl_down_sync(0xffffffffu, v, o), cap);
    excl = min(excl + __shfl_sync(0xffffffffu, v, 0), cap);
    if (incl != 0u || excl >= cap) break;         // warp-uniform
  }
  return excl;
}

// ---------------------------------------------------------------------------
// U1: reshuffle_count
// ---------------------------------------------------------------------------

// cnt: the 2E counters (stay_cnt, then mov_cnt), zeroed, followed by the
// header and the tiles' status words (zeroed); info: fits, n_mov; num:
// the stayers and movers (the reshuffle's num_ptcls); vec: elem and
// old_elem 16-byte aligned (vector loads)
__global__ void __launch_bounds__(U_THREADS, U_MIN_BLOCKS) reshuffle_count_kernel(
    const int* __restrict__ elem, const int* __restrict__ old_elem,
    const int* __restrict__ seg_cap, int E, long long C, int MB, int n_tiles, bool vec,
    int* __restrict__ cnt, int* __restrict__ mov_start, int* __restrict__ msrc,
    int* __restrict__ mkey, int* __restrict__ info, int* __restrict__ num) {
  __shared__ int smem[32];
  __shared__ int s_tile, s_base, s_stay, s_mov, s_last, s_past;
  unsigned* hdr = reinterpret_cast<unsigned*>(cnt + 2LL * E);
  volatile unsigned* status = hdr + U_HEADER;
  const unsigned cap = (unsigned)MB + 1u;        // the prefixes saturate here
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = (int)atomicAdd(hdr + U_H_TICKET, 1u);
    // an earlier tile's movers already passed MB: so do this tile's
    s_past = ((volatile unsigned*)hdr)[U_H_PAST] != 0u;
    s_stay = 0;
    s_mov = 0;
  }
  __syncthreads();
  const long long tile = s_tile;
  const bool past = s_past;                       // block-uniform
  // the thread's U_J consecutive slots
  const long long s0 = tile * U_TILE + (long long)threadIdx.x * U_J;
  int ev[U_J], ov[U_J];
  if (vec && s0 + U_J <= C) {                     // 16-byte loads
#pragma unroll
    for (int q = 0; q < U_J / 4; ++q) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(elem + s0) + q);
      const int4 b = __ldg(reinterpret_cast<const int4*>(old_elem + s0) + q);
      ev[4 * q] = a.x, ev[4 * q + 1] = a.y, ev[4 * q + 2] = a.z, ev[4 * q + 3] = a.w;
      ov[4 * q] = b.x, ov[4 * q + 1] = b.y, ov[4 * q + 2] = b.z, ov[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < U_J; ++j) {
      ev[j] = s0 + j < C ? __ldg(elem + s0 + j) : -1;
      ov[j] = s0 + j < C ? __ldg(old_elem + s0 + j) : -1;
    }
  }
  unsigned mbits = 0u, sbits = 0u;
#pragma unroll
  for (int j = 0; j < U_J; ++j) {
    const bool st = ev[j] >= 0 && ev[j] == ov[j];
    sbits |= (unsigned)st << j;
    mbits |= (unsigned)(ev[j] >= 0 && !st) << j;
  }
  const int n_stay = __popc(sbits), mine = __popc(mbits);
#if U1_STAGE >= 2
  // the stayers: slot j of the warp's lanes lie U_J apart, one row of a
  // Sell-C-σ chunk (U_J a multiple of the chunk) or one CabM segment
  // mostly, so a group of one key adds once
  if (!past) {
#pragma unroll
    for (int j = 0; j < U_J; ++j) {
      const bool st = (sbits >> j) & 1u;
      const unsigned grp = __match_any_sync(0xffffffffu, st ? ev[j] : -1);
      if (st && lane == __ffs(grp) - 1) red_add(cnt + ev[j], __popc(grp));
    }
  }
#endif
#if U1_STAGE < 3
  if (((int)mbits ^ n_stay) == MB + 12345) info[0] = n_stay;   // keeps the loads
  return;
#endif
  {
    const int w_stay = __reduce_add_sync(0xffffffffu, n_stay);
    if (lane == 0 && w_stay) atomicAdd(&s_stay, w_stay);
  }
  if (past) {
    // only the counts (n_mov, num): no look-back, no list, no adds
    const int w_mov = __reduce_add_sync(0xffffffffu, mine);
    if (lane == 0 && w_mov) atomicAdd(&s_mov, w_mov);
    __syncthreads();
    if (threadIdx.x == 0) {
      status[tile] = U_INCLUSIVE | cap;
      if (s_mov) atomicAdd(hdr + U_H_NMOV, (unsigned)s_mov);
      if (s_stay) atomicAdd(hdr + U_H_NSTAY, (unsigned)s_stay);
    }
  } else {
    // the tile's movers before each thread's; the tile's place by look-back
    int total;
    const int excl_t = block_scan(mine, smem, &total) - mine;
    if (warp == 0) {
      const unsigned t = min((unsigned)total, cap);
      if (lane == 0) status[tile] = (tile == 0 ? U_INCLUSIVE : U_AGGREGATE) | t;
      const unsigned excl = look_back(status, tile, lane, cap);
      if (lane == 0) {
        if (tile > 0) status[tile] = U_INCLUSIVE | min(excl + t, cap);
        if ((long long)excl + total > MB) hdr[U_H_PAST] = 1u;
        s_base = (int)excl;
        if (total) atomicAdd(hdr + U_H_NMOV, (unsigned)total);
        if (s_stay) atomicAdd(hdr + U_H_NSTAY, (unsigned)s_stay);
      }
    }
    __syncthreads();
    const long long base = s_base;
#if U1_STAGE < 4
    if (base == -7 && excl_t == -7) info[0] = 0;
    return;
#endif
    if (base < MB) {                               // block-uniform
      long long pos = base + excl_t;
#pragma unroll
      for (int j = 0; j < U_J; ++j) {
        if ((mbits >> j) & 1u) {
          if (pos < MB) {
            msrc[pos] = (int)(s0 + j);
            mkey[pos] = ev[j];
          }
          ++pos;
        }
      }
    }
    if (base + total <= MB) {                      // the movers counted
      if (__reduce_add_sync(0xffffffffu, mine) > U_MERGE_AT) {
#pragma unroll
        for (int j = 0; j < U_J; ++j) {            // a group of one key adds once
          const bool mv = (mbits >> j) & 1u;
          const unsigned grp = __match_any_sync(0xffffffffu, mv ? ev[j] : -1);
          if (mv && lane == __ffs(grp) - 1) red_add(cnt + E + ev[j], __popc(grp));
        }
      } else {
#pragma unroll
        for (int j = 0; j < U_J; ++j)
          if ((mbits >> j) & 1u) red_add(cnt + E + ev[j], 1);
      }
    }
  }
  // the last block to finish: fits and the movers' first places
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(hdr + U_H_DONE, 1u) == (unsigned)n_tiles - 1u;
  __syncthreads();
  if (!s_last || U1_STAGE < 5) return;
  __threadfence();
  const int n_mov = (int)((volatile unsigned*)hdr)[U_H_NMOV];
  const int n_stay_all = (int)((volatile unsigned*)hdr)[U_H_NSTAY];
  int ok = 1;
  unsigned running = 0u;
  // past MB fits is false and the counts are not read: nothing to scan
  for (long long c0 = 0; n_mov <= MB && c0 < E; c0 += (long long)U_THREADS * U_LAST) {
    // warp w's U_LAST rounds of 32 consecutive elements (coalesced)
    const long long w0 = c0 + (long long)warp * 32 * U_LAST + lane;
    int mc[U_LAST], sc[U_LAST], cp[U_LAST];
#pragma unroll
    for (int r = 0; r < U_LAST; ++r) {             // every load first
      const long long i = w0 + 32 * r;
      const bool in = i < E;
      mc[r] = in ? __ldcg(cnt + E + i) : 0;
      sc[r] = in ? __ldcg(cnt + i) : 0;
      cp[r] = in ? __ldg(seg_cap + i) : 0;
    }
    int wsum = 0;
#pragma unroll
    for (int r = 0; r < U_LAST; ++r) {
      ok &= mc[r] <= cp[r] - sc[r];
      int x = mc[r];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      cp[r] = wsum + x - mc[r];                    // the exclusive prefix in the warp's run
      wsum += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) smem[warp] = wsum;
    __syncthreads();
    int woff = 0, tot = 0;
    for (int w = 0; w < U_THREADS / 32; ++w) {
      const int v = smem[w];
      woff += w < warp ? v : 0;
      tot += v;
    }
#pragma unroll
    for (int r = 0; r < U_LAST; ++r) {
      const long long i = w0 + 32 * r;
      if (i < E) mov_start[i] = (int)running + woff + cp[r];
    }
    running += (unsigned)tot;
    __syncthreads();                               // smem read before the next round's writes
  }
  const int fits = __syncthreads_and(ok) && n_mov <= MB;
  if (threadIdx.x == 0) {
    info[0] = fits;
    info[1] = n_mov;
    *num = n_stay_all + n_mov;
  }
}

// ---------------------------------------------------------------------------
// U2: reshuffle_place
// ---------------------------------------------------------------------------

struct PlaceFields {
  const uint8_t* staged[U_MAX_FIELDS];   // (n_mov, row) rows in C's order
  uint8_t* out[U_MAX_FIELDS];            // (C, row) the structure's fields, in place
  int row_bytes[U_MAX_FIELDS];
  int words[U_MAX_FIELDS];               // 1: rows move as 4-byte words
  int n;
};

// staged row m into slot s of every field (a lane's whole row; words
// loaded four at a time before they are stored)
__device__ __forceinline__ void copy_row(const PlaceFields& f, long long m, long long s) {
  for (int k = 0; k < f.n; ++k) {
    const int rb = f.row_bytes[k];
    if (f.words[k]) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(f.staged[k] + m * rb);
      uint32_t* dst = reinterpret_cast<uint32_t*>(f.out[k] + s * rb);
      const int nw = rb / 4;
      for (int w0 = 0; w0 < nw; w0 += 4) {
        uint32_t v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = w0 + t < nw ? __ldg(src + w0 + t) : 0u;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (w0 + t < nw) dst[w0 + t] = v[t];
      }
    } else {
      const uint8_t* src = f.staged[k] + m * rb;
      uint8_t* dst = f.out[k] + s * rb;
      for (int b = 0; b < rb; ++b) dst[b] = src[b];
    }
  }
}

// the warp's held fills (slot, staged row), n of them, copied by its lanes
// together, so their loads are in flight at once
__device__ __forceinline__ void copy_fills(const PlaceFields& f, const long long* fill_s,
                                           const int* fill_m, int n, int lane) {
  __syncwarp();
  for (int i = lane; i < n; i += 32) copy_row(f, fill_m[i], fill_s[i]);
  __syncwarp();
}

// the slots of unit u (warp-wide): its first slot (the chunk's, row 0) and
// width, from the first real row among its first 32 (Sell-C-σ: every row
// of a chunk has the chunk's width and its offset plus the row; the
// padding rows are the last R - E < chunk rows, so every chunk has a real
// row 0); false where none is real
__device__ __forceinline__ bool unit_slots(const int* __restrict__ row_to_elem,
                                           const int* __restrict__ elem_offsets,
                                           const int* __restrict__ seg_cap, long long u,
                                           int chunk, int E, int lane, long long* base,
                                           int* width) {
  int e = -1;
  if (lane < chunk && lane < 32)
    e = row_to_elem != nullptr ? __ldg(row_to_elem + u * chunk + lane) : (int)u;
  const bool real = e >= 0 && e < E;
  const unsigned b = __ballot_sync(0xffffffffu, real);
  if (b == 0u) return false;
  const int src = __ffs(b) - 1;
  long long bl = 0;
  int wl = 0;
  if (lane == src) {
    bl = (long long)__ldg(elem_offsets + e) - lane;
    wl = __ldg(seg_cap + e);
  }
  *base = __shfl_sync(0xffffffffu, bl, src);
  *width = __shfl_sync(0xffffffffu, wl, src);
  return true;
}

// a warp a unit: a Sell-C-σ chunk (rows u·chunk .. u·chunk + chunk - 1 of
// the row order) or a CabM segment (chunk 1, row_to_elem null: element
// u).  The first tail_blocks blocks write the slots past the layout's end
// (from the last unit's end to C) instead.  num_ovf: the count and the
// flag word, zeroed by the launcher.
__global__ void __launch_bounds__(U2_THREADS) reshuffle_place_kernel(
    const int* __restrict__ elem, const int* __restrict__ old_elem,
    const int* __restrict__ elem_offsets, const int* __restrict__ seg_cap,
    const int* __restrict__ mov_cnt, const int* __restrict__ mov_start,
    const int* __restrict__ row_to_elem, long long n_units, int E, long long C, int chunk,
    int tail_blocks, const uint8_t* __restrict__ ovf_in, PlaceFields f,
    int* __restrict__ elem_out, uint8_t* __restrict__ active_out, int* __restrict__ num_ovf) {
  __shared__ int warp_sum[U2_THREADS / 32];
  __shared__ long long s_end;
  __shared__ long long fill_slot[U2_THREADS / 32][U2_FILLS];
  __shared__ int fill_row[U2_THREADS / 32][U2_FILLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < tail_blocks) {
    if (warp == 0) {
      long long b;
      int w;
      const bool ok = unit_slots(row_to_elem, elem_offsets, seg_cap, n_units - 1, chunk, E,
                                 lane, &b, &w);
      if (lane == 0) s_end = ok ? b + (long long)chunk * w : C;
    }
    __syncthreads();
    for (long long s = s_end + (long long)blockIdx.x * U2_THREADS + threadIdx.x; s < C;
         s += (long long)tail_blocks * U2_THREADS) {
      elem_out[s] = -1;
      active_out[s] = 0;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0 && *ovf_in) num_ovf[1] = 1;   // sticky
    return;
  }
  // a round: QR q's of RG rows, RG·QR consecutive slots of the chunk; the
  // lanes of one row (lane ≡ row mod RG) rank its holes in q order
  const int RG = chunk < 32 ? chunk : 32, QR = 32 / RG;
  const int row_l = lane % RG, qoff = lane / RG;
  const bool used = lane < RG * QR;
  unsigned same = 0u;
  if (used)
    for (int i = row_l; i < RG * QR; i += RG) same |= 1u << i;
  const unsigned lower = (1u << lane) - 1u, mine = same & lower;
  int n_fill = 0;                                  // warp-uniform
  const long long u = (long long)(blockIdx.x - tail_blocks) * (U2_THREADS / 32) + warp;
  int held = 0;
  long long cbase = 0;
  int w = 0;
  bool laid = false;
  if (u < n_units)                                 // warp-uniform
    laid = unit_slots(row_to_elem, elem_offsets, seg_cap, u, chunk, E, lane, &cbase, &w);
  if (laid) {
    for (int g0 = 0; g0 < chunk; g0 += 32) {       // rows in groups of 32 (one group if chunk <= 32)
      const int row = g0 + row_l;
      const bool ok_row = used && row < chunk;
      int e = -1;
      if (ok_row) e = row_to_elem != nullptr ? __ldg(row_to_elem + u * chunk + row) : (int)u;
      const bool real = e >= 0 && e < E;           // a padding row places nothing
      const int k = real ? __ldg(mov_cnt + e) : 0, ms = real ? __ldg(mov_start + e) : 0;
      int holes = 0;                               // the row's, in each of its lanes
      for (int q0 = 0; q0 < w; q0 += QR * U2_UNROLL) {   // U2_UNROLL rounds' loads at once
        long long s[U2_UNROLL];
        int en[U2_UNROLL], eo[U2_UNROLL];
        bool in[U2_UNROLL];
#pragma unroll
        for (int v = 0; v < U2_UNROLL; ++v) {
          const int q = q0 + v * QR + qoff;
          s[v] = cbase + (long long)q * chunk + row;
          in[v] = ok_row && q < w && s[v] < C;
          const bool rd = in[v] && real;
          en[v] = rd ? __ldg(elem + s[v]) : -1;
          eo[v] = rd ? __ldg(old_elem + s[v]) : -1;
        }
#pragma unroll
        for (int v = 0; v < U2_UNROLL; ++v) {
          const bool st = en[v] >= 0 && en[v] == eo[v];
          const bool hole = in[v] && real && !st;
          const unsigned hb = __ballot_sync(0xffffffffu, hole);
          const int r = holes + __popc(hb & mine);
          const bool fill = hole && r < k && U2_STAGE >= 2;
          if (in[v]) {                             // every slot written once
            elem_out[s[v]] = st ? en[v] : fill ? e : -1;
            active_out[s[v]] = st || fill;
          }
          const unsigned fb = __ballot_sync(0xffffffffu, fill);
          if (fill) {                              // held, copied with the warp's next 32
            const int at = n_fill + __popc(fb & lower);
            fill_slot[warp][at] = s[v];
            fill_row[warp][at] = ms + r;
          }
          n_fill += __popc(fb);
          if (n_fill > U2_FILLS - 32) {            // warp-uniform
            copy_fills(f, fill_slot[warp], fill_row[warp], n_fill, lane);
            n_fill = 0;
          }
          held += st;
          holes += __popc(hb & same);
        }
      }
      if (ok_row && real && qoff == 0) {
        held += min(holes, k);
        if (holes < k) num_ovf[1] = 1;             // a mover found no hole
      }
    }
    copy_fills(f, fill_slot[warp], fill_row[warp], n_fill, lane);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) held += __shfl_down_sync(0xffffffffu, held, o);
  if (lane == 0) warp_sum[warp] = held;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int i = 0; i < U2_THREADS / 32; ++i) t += warp_sum[i];
    if (t) atomicAdd(num_ovf, t);
  }
}

// ---------------------------------------------------------------------------
// U3 (one cooperative launch) and Z (one cluster launch)
// ---------------------------------------------------------------------------

// U3: a warp's part of a range [lo, hi) split over U3_WARPS warps, in
// rounds of 32 (U3_UNROLL rounds' loads at once); f(u, in, key, slot) is
// called for each round u (every lane) with whether the lane's position
// lies in its part and, where it does, its key and slot
template <bool SLOTS, typename F>
__device__ __forceinline__ void u3_rounds(const int* __restrict__ mkey,
                                          const int* __restrict__ msrc, int lo, int hi,
                                          F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = ((hi - lo + U3_WARPS - 1) / U3_WARPS + 31) & ~31;
  const int lo_w = min(lo + warp * per, hi), hi_w = min(lo_w + per, hi);
  for (int j0 = lo_w; j0 < hi_w; j0 += 32 * U3_UNROLL) {
    int k[U3_UNROLL], v[U3_UNROLL];
#pragma unroll
    for (int u = 0; u < U3_UNROLL; ++u) {
      const int j = j0 + 32 * u + lane;
      k[u] = j < hi_w ? __ldcg(mkey + j) : -1;
      v[u] = SLOTS && j < hi_w ? __ldcg(msrc + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < U3_UNROLL; ++u) f(u, j0 + 32 * u + lane < hi_w, k[u], v[u]);
  }
}

// U3: reshuffle_order.  bs: a bucket's key bits; nbk buckets; kt: the keys
// a warp's table holds; tcount: nbk rows of gridDim.x words (bucket-major);
// tkey, tslot: n words each (the movers grouped by bucket)
__global__ void __launch_bounds__(U3_THREADS) reshuffle_order_kernel(
    const int* __restrict__ mkey, const int* __restrict__ msrc,
    const int* __restrict__ mov_start, int E, int n, int bs, int nbk, int kt,
    int* __restrict__ take, int* tcount, int* tkey, int* tslot) {
  extern __shared__ __align__(16) int u3_tab[];   // [U3_WARPS][nbk], then [U3_WARPS][kt]
  cg::grid_group grid = cg::this_grid();
  const int G = (int)gridDim.x, t = (int)blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int T = (n + G - 1) / G;
  const int lo = min(t * T, n), hi = min(lo + T, n);
  int* wtab = u3_tab + warp * nbk;

  // (1) the tile's movers by bucket, each warp in its table
  for (int i = threadIdx.x; i < U3_WARPS * nbk; i += U3_THREADS) u3_tab[i] = 0;
  __syncthreads();
  u3_rounds<false>(mkey, msrc, lo, hi, [&](int, bool in, int k, int) {
    if (in) atomicAdd(&wtab[k >> bs], 1);
  });
  __syncthreads();
  for (int bk = threadIdx.x; bk < nbk; bk += U3_THREADS) {
    int s = 0;
    for (int w = 0; w < U3_WARPS; ++w) {
      const int c = u3_tab[w * nbk + bk];
      u3_tab[w * nbk + bk] = s;
      s += c;
    }
    tcount[(long long)bk * G + t] = s;
  }
  __threadfence();
  grid.sync();
  // (2) each bucket's column scanned: every tile's first place in it
  if (U3_STAGE >= 2)
    for (int bk = t; bk < nbk; bk += G) {
      int* col = tcount + (long long)bk * G;
      const int c = (int)threadIdx.x < G ? __ldcg(col + threadIdx.x) : 0;
      int total;
      const int incl = block_scan(c, u3_tab + U3_WARPS * nbk, &total);
      if ((int)threadIdx.x < G) col[threadIdx.x] = __ldg(mov_start + (bk << bs)) + incl - c;
    }
  __threadfence();
  grid.sync();
  // (3) the tile's movers placed, in order, grouped by bucket
  if (U3_STAGE >= 3) {
    for (int bk = threadIdx.x; bk < nbk; bk += U3_THREADS) {
      const int base = __ldcg(tcount + (long long)bk * G + t);
      for (int w = 0; w < U3_WARPS; ++w) u3_tab[w * nbk + bk] += base;
    }
    __syncthreads();
    u3_rounds<true>(mkey, msrc, lo, hi, [&](int, bool in, int k, int v) {
      const int bk = in ? k >> bs : -1;
      const unsigned m = __match_any_sync(0xffffffffu, bk);
      const int lead = __ffs(m) - 1;
      const bool leader = in && lane == lead;
      int at = leader ? wtab[bk] : 0;
      at = __shfl_sync(0xffffffffu, at, lead) + __popc(m & below);
      if (leader) wtab[bk] = at + __popc(m);
      if (in) {
        tkey[at] = k;
        tslot[at] = v;
      }
    });
  }
  __threadfence();
  grid.sync();
  // (4) each bucket's movers, in order, ranked by key from mov_start
  if (U3_STAGE < 4) return;
  int* ktab = u3_tab + warp * kt;
  for (int bk = t; bk < nbk; bk += G) {
    const int kb = bk << bs, ke = min(kb + (1 << bs), E);
    const int s0 = __ldg(mov_start + kb), s1 = ke < E ? __ldg(mov_start + ke) : n;
    for (int k0 = kb; k0 < ke; k0 += kt) {
      const int nk = min(kt, ke - k0);
      __syncthreads();
      for (int i = threadIdx.x; i < U3_WARPS * kt; i += U3_THREADS) u3_tab[i] = 0;
      __syncthreads();
      u3_rounds<false>(tkey, tslot, s0, s1, [&](int, bool in, int k, int) {
        if (in && (unsigned)(k - k0) < (unsigned)nk) atomicAdd(&ktab[k - k0], 1);
      });
      __syncthreads();
      for (int i = threadIdx.x; i < nk; i += U3_THREADS) {
        int s = __ldg(mov_start + k0 + i);
        for (int w = 0; w < U3_WARPS; ++w) {
          const int c = u3_tab[w * kt + i];
          u3_tab[w * kt + i] = s;
          s += c;
        }
      }
      __syncthreads();
      u3_rounds<true>(tkey, tslot, s0, s1, [&](int, bool in, int k, int v) {
        const int kk = in && (unsigned)(k - k0) < (unsigned)nk ? k - k0 : -1;
        const unsigned m = __match_any_sync(0xffffffffu, kk);
        const int lead = __ffs(m) - 1;
        const bool leader = kk >= 0 && lane == lead;
        int at = leader ? ktab[kk] : 0;
        at = __shfl_sync(0xffffffffu, at, lead) + __popc(m & below);
        if (leader) ktab[kk] = at + __popc(m);
        if (kk >= 0) take[at] = v;
      });
    }
  }
}

// Z: a row's count (-1 for a padding row)
__device__ __forceinline__ int z_count(const int* __restrict__ counts, int E, int row) {
  return row < E ? __ldg(counts + row) : -1;
}

// Z: a pass's digit: the clamped pass's (mode 0: key < k0 to bin 0, the
// rest key - k0 + 1), a digit of the key max - count (1) or of the row's
// window (2)
struct ZPass {
  int mode, shift, width;
  unsigned k0;
};

__device__ __forceinline__ int z_digit(const ZPass& q, int row, int c, int maxc, int sigma) {
  const unsigned key = (unsigned)maxc - (unsigned)c;
  if (q.mode == 0) return key < q.k0 ? 0 : (int)(key - q.k0 + 1u);
  const unsigned v = q.mode == 1 ? key : (unsigned)(row / sigma);
  return (int)((v >> q.shift) & ((1u << q.width) - 1u));
}

// Z: Z_UNROLL rounds of a warp's part from position j0 (-1 past hi): each
// lane's row (the position itself in the first pass, else src's) and count
__device__ __forceinline__ void z_load(const int* src, const int* __restrict__ counts, int E,
                                       int j0, int hi, int lane, int (&row)[Z_UNROLL],
                                       int (&c)[Z_UNROLL]) {
#pragma unroll
  for (int u = 0; u < Z_UNROLL; ++u) {
    const int j = j0 + 32 * u + lane;
    row[u] = j < hi ? (src ? __ldcg(src + j) : j) : -1;
  }
#pragma unroll
  for (int u = 0; u < Z_UNROLL; ++u) c[u] = row[u] >= 0 ? z_count(counts, E, row[u]) : -1;
}

// a warp's add of 1 to table[v] for each lane whose ``in``: the lanes equal
// to the first such lane's v in one add, the others each alone (skewed
// values meet few conflicts, distinct ones no __match_any_sync)
__device__ __forceinline__ void warp_count(int* table, bool in, int v) {
  const unsigned act = __ballot_sync(0xffffffffu, in);
  if (act == 0u) return;                          // warp-uniform
  const int lead = __ffs(act) - 1;
  const int v0 = __shfl_sync(0xffffffffu, v, lead);
  const unsigned same = __ballot_sync(0xffffffffu, in && v == v0);
  const int lane = threadIdx.x & 31;
  if (lane == lead) atomicAdd(&table[v0], __popc(same));
  else if (in && v != v0) atomicAdd(&table[v], 1);
}

// Z: a pass's count: each warp's digits in its table, the block's counts
// exchanged through gbins (a row of Z_BINS words a block), and each warp's
// first place of each digit in its table; returns the cluster's count of
// digit 0
__device__ int z_count_pass(cg::cluster_group& cluster, const ZPass& q, const int* src,
                            const int* __restrict__ counts, int E, int maxc, int sigma,
                            int lo_w, int hi_w, int* tab, int* blk, int* misc, int* gbins) {
  const int nb = (int)cluster.num_blocks(), b = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bins = 1 << q.width;
  for (int i = threadIdx.x; i < Z_WARPS * bins; i += Z_THREADS)
    tab[(i >> q.width) * Z_BINS + (i & (bins - 1))] = 0;
  __syncthreads();
  for (int j0 = lo_w; j0 < hi_w && Z_STAGE >= 2; j0 += 32 * Z_UNROLL) {
    int row[Z_UNROLL], c[Z_UNROLL];
    z_load(src, counts, E, j0, hi_w, lane, row, c);
#pragma unroll
    for (int u = 0; u < Z_UNROLL; ++u)
      warp_count(tab + warp * Z_BINS, row[u] >= 0,
                 row[u] >= 0 ? z_digit(q, row[u], c[u], maxc, sigma) : 0);
  }
  __syncthreads();
  // the warps' exclusive prefix in the block; the block's counts to its row
  for (int d = threadIdx.x; d < bins && Z_STAGE >= 3; d += Z_THREADS) {
    int s = 0;
    for (int w = 0; w < Z_WARPS; ++w) {
      const int t = tab[w * Z_BINS + d];
      tab[w * Z_BINS + d] = s;
      s += t;
    }
    gbins[b * Z_BINS + d] = s;
  }
  __threadfence();
  cluster.sync();
  // every block's rows: each digit's total, the blocks' before this one,
  // the totals scanned over the digits (a thread's 4 consecutive digits)
  const int d0 = 4 * threadIdx.x;
  int tot[4] = {0, 0, 0, 0}, pre[4] = {0, 0, 0, 0}, sum = 0;
  if (d0 < bins && Z_STAGE >= 4) {
#pragma unroll
    for (int r = 0; r < ORDER_CLUSTER_MAX; ++r)
      if (r < nb) {
        const int4 v = __ldcg(reinterpret_cast<const int4*>(gbins + r * Z_BINS + d0));
        const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tot[i] += vs[i];
          pre[i] += r < b ? vs[i] : 0;
        }
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (d0 + i >= bins) tot[i] = pre[i] = 0;   // past the pass's bins (fewer than 4)
      sum += tot[i];
    }
  }
  int total;
  int start = block_scan(sum, misc, &total) - sum;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (d0 + i < bins) {
      blk[d0 + i] = start + pre[i];
      start += tot[i];
    }
  if (threadIdx.x == 0) misc[70] = tot[0];
  __syncthreads();
  for (int d = threadIdx.x; d < bins && Z_STAGE >= 4; d += Z_THREADS) {
    const int base = blk[d];
    for (int w = 0; w < Z_WARPS; ++w) tab[w * Z_BINS + d] += base;
  }
  __syncthreads();
  return misc[70];
}

// Z: a pass's walk: each warp's rows in order, from its table, to dst (a
// pass before the last) or to the maps (the last)
__device__ void z_walk(const ZPass& q, const int* src, const int* __restrict__ counts, int E,
                       int maxc, int sigma, int lo_w, int hi_w, int* tab, bool last,
                       int* __restrict__ dst, int* __restrict__ row_to_elem,
                       int* __restrict__ elem_to_row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = lo_w; j0 < hi_w; j0 += 32 * Z_UNROLL) {
    int row[Z_UNROLL], c[Z_UNROLL];
    z_load(src, counts, E, j0, hi_w, lane, row, c);
#pragma unroll
    for (int u = 0; u < Z_UNROLL; ++u) {
      const int d = row[u] >= 0 ? z_digit(q, row[u], c[u], maxc, sigma) : -1;
      const unsigned m = __match_any_sync(0xffffffffu, d);
      const int lead = __ffs(m) - 1;
      const bool leader = d >= 0 && lane == lead;
      int at = leader ? tab[warp * Z_BINS + d] : 0;
      at = __shfl_sync(0xffffffffu, at, lead) + __popc(m & ((1u << lane) - 1u));
      if (leader) tab[warp * Z_BINS + d] = at + __popc(m);
      if (d >= 0) {
        if (last) {
          row_to_elem[at] = row[u];
          if (row[u] < E) elem_to_row[row[u]] = at;
        } else {
          dst[at] = row[u];
        }
      }
    }
  }
}

// Z: scs_row_order.  bw: the bits of the last window's index (0: one
// window); buf0, buf1: R words each (the passes' rows); gbins:
// ORDER_CLUSTER_MAX rows of Z_BINS words (16-byte aligned)
__global__ void __launch_bounds__(Z_THREADS, 1) scs_row_order_kernel(
    const int* __restrict__ counts, int E, int R, int sigma, int bw, int chunk,
    int* __restrict__ row_to_elem, int* __restrict__ elem_to_row,
    int* __restrict__ chunk_width, int* buf0, int* buf1, int* gbins) {
  extern __shared__ __align__(16) int z_dyn[];
  int* tab = z_dyn;                               // [Z_WARPS][Z_BINS]
  int* blk = tab + Z_WARPS * Z_BINS;              // [Z_BINS]
  int* misc = blk + Z_BINS;                       // [Z_MISC]
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks(), b = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = ((R + nb - 1) / nb + 31) & ~31;
  const int lo_b = min(b * S, R), hi_b = min(lo_b + S, R);
  const int Sw = ((S + Z_WARPS - 1) / Z_WARPS + 31) & ~31;
  const int lo_w = min(lo_b + warp * Sw, hi_b), hi_w = min(lo_w + Sw, hi_b);

  // the cluster's min and max count (misc: 32..47 the warps', 64..67 the
  // block's and the cluster's)
  int mn = 0x7fffffff, mx = -0x7fffffff - 1;
  for (int r = lo_b + (int)threadIdx.x; r < hi_b; r += Z_THREADS) {
    const int c = z_count(counts, E, r);
    mn = min(mn, c);
    mx = max(mx, c);
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    misc[32 + warp] = mn;
    misc[48 + warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = __reduce_min_sync(0xffffffffu, lane < Z_WARPS ? misc[32 + lane] : 0x7fffffff);
    mx = __reduce_max_sync(0xffffffffu, lane < Z_WARPS ? misc[48 + lane] : -0x7fffffff - 1);
    if (lane == 0) {
      misc[64] = mn;
      misc[65] = mx;
    }
  }
  cluster.sync();
  if (warp == 0) {
    mn = __reduce_min_sync(0xffffffffu,
                           lane < nb ? *cluster.map_shared_rank(misc + 64, lane) : 0x7fffffff);
    mx = __reduce_max_sync(0xffffffffu, lane < nb ? *cluster.map_shared_rank(misc + 65, lane)
                                                  : -0x7fffffff - 1);
    if (lane == 0) {
      misc[66] = mn;
      misc[67] = mx;
    }
  }
  cluster.sync();                       // no block leaves while another reads it
  if (Z_STAGE < 2) return;
  const int maxc = misc[67];
  const unsigned range = (unsigned)maxc - (unsigned)misc[66];
  bool done = false;
  if (bw == 0) {
    // one window: the clamped pass, and the big rows' stage
    const int width = range + 1u == 0u ? Z_DMAX : min(Z_DMAX, 32 - __clz(range + 1u));
    const unsigned top = (1u << width) - 2u;
    const ZPass q = {0, 0, width, range > top ? range - top : 0u};
    int n_big = z_count_pass(cluster, q, nullptr, counts, E, maxc, sigma, lo_w, hi_w, tab, blk,
                             misc, gbins);
    if (Z_STAGE < 4) n_big = 0;
    if (n_big <= Z_BIG) {
      if (Z_STAGE >= 5)
        z_walk(q, nullptr, counts, E, maxc, sigma, lo_w, hi_w, tab, true, nullptr, row_to_elem,
               elem_to_row);
      if (n_big > 1) {
        __threadfence();
        cluster.sync();
        if (b == 0 && Z_STAGE >= 6) {
          // the big rows, at places [0, n_big) in row order: ranked by
          // descending count, equal counts in row order
          int* brow = tab;
          int* bcnt = tab + Z_BIG;
          for (int i = threadIdx.x; i < n_big; i += Z_THREADS) {
            brow[i] = __ldcg(row_to_elem + i);
            bcnt[i] = z_count(counts, E, brow[i]);
          }
          __syncthreads();
          for (int i = threadIdx.x; i < n_big; i += Z_THREADS) {
            const int ci = bcnt[i];
            int r = 0;
            for (int j = 0; j < n_big; ++j) {
              const int cj = bcnt[j];
              r += (cj > ci) | (cj == ci & j < i);
            }
            row_to_elem[r] = brow[i];
            if (brow[i] < E) elem_to_row[brow[i]] = r;
          }
        }
      }
      done = true;
    } else {
      cluster.sync();                   // every block has read the rows of gbins
    }
  }
  if (!done) {
    // LSD passes over the key's bits, then over the window's
    const int bk = range ? 32 - __clz(range) : 0;
    const int pk = (bk + Z_DMAX - 1) / Z_DMAX, pw = (bw + Z_DMAX - 1) / Z_DMAX;
    const int wk = pk ? (bk + pk - 1) / pk : 0, ww = pw ? (bw + pw - 1) / pw : 0;
    const int passes = max(pk + pw, 1);
    for (int p = 0; p < passes; ++p) {
      const bool win = p >= pk && pw > 0;
      const int shift = win ? (p - pk) * ww : p * wk;
      const ZPass q = {win ? 2 : 1, shift,
                       win ? min(ww, bw - shift) : pk ? min(wk, bk - shift) : 0, 0u};
      const int* src = p == 0 ? nullptr : ((p - 1) & 1 ? buf1 : buf0);
      z_count_pass(cluster, q, src, counts, E, maxc, sigma, lo_w, hi_w, tab, blk, misc, gbins);
      if (Z_STAGE >= 5)
        z_walk(q, src, counts, E, maxc, sigma, lo_w, hi_w, tab, p == passes - 1,
               p & 1 ? buf1 : buf0, row_to_elem, elem_to_row);
      if (p < passes - 1) {
        __threadfence();
        cluster.sync();
      }
    }
  }
  __threadfence();
  cluster.sync();
  // each chunk's width: the largest count of its rows, which is the count
  // of its first row or of a window's first row in it
  const int nch = R / chunk, cpb = (nch + nb - 1) / nb;
  const int c0 = min(b * cpb, nch), c1 = min(c0 + cpb, nch);
  for (int k = c0 + (int)threadIdx.x; k < c1 && Z_STAGE >= 6; k += Z_THREADS) {
    int w = 0;
    for (int r = k * chunk; r < (k + 1) * chunk; r = (r / sigma + 1) * sigma) {
      const int row = __ldcg(row_to_elem + r);
      w = max(w, row < E ? __ldg(counts + row) : 0);
    }
    chunk_width[k] = w;
  }
}

// the blocks of one cluster of ``kernel`` (16 where the card schedules a
// cluster of 16 blocks of ``threads`` threads and ``smem`` bytes of shared
// memory, else 8), queried once (``cache``), its attributes set then
template <typename K>
cudaError_t order_cluster(K kernel, int threads, int smem, int* cache) {
  if (*cache > 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  for (int nb = ORDER_CLUSTER_MAX; nb >= 8; nb /= 2) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nb;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(nb);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err == cudaSuccess && clusters >= 1) {
      *cache = nb;
      return cudaSuccess;
    }
    (void)cudaGetLastError();
  }
  return cudaErrorInvalidConfiguration;
}

// one cooperative launch of ``kernel`` over G blocks (all resident at once)
template <typename K, typename... A>
cudaError_t launch_cooperative(K kernel, int G, int threads, int smem, cudaStream_t stream,
                               A... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// the SMs of the current device
int order_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// the blocks of a cooperative grid of ``kernel`` with smem bytes each:
// up to ``per_sm`` an SM where they are resident at once; its shared memory
// attribute set to ``smem_max`` once (``ready``)
template <typename K>
cudaError_t order_grid(K kernel, int threads, int smem, int smem_max, int per_sm, bool* ready,
                       int* grid) {
  cudaError_t err;
  if (!*ready) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err != cudaSuccess) return err;
    *ready = true;
  }
  int per = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per < 1) return cudaErrorInvalidConfiguration;
  *grid = order_sms() * (per < per_sm ? per : per_sm);
  return cudaSuccess;
}

bool u3_ready = false;
int z_cluster = 0;

}  // namespace

// int32 words of U1's buffer over C slots and E elements: the 2E counters,
// the header and a status word a tile
extern "C" int pp_reshuffle_count_words(long long C, int E) {
  return (int)(2LL * E + U_HEADER + (C + U_TILE - 1) / U_TILE);
}

// U1 over the C slots of (elem, old_elem); cnt: pp_reshuffle_count_words
// words (zeroed here); msrc and mkey: MB words each; info: 2 words
extern "C" int pp_reshuffle_count(const int* elem, const int* old_elem, const int* seg_cap,
                                  int E, long long C, int MB, int* cnt, int* mov_start,
                                  int* msrc, int* mkey, int* info, int* num,
                                  cudaStream_t stream) {
  if (E <= 0 || C <= 0 || C >= (1LL << 30) || MB < 0) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (C + U_TILE - 1) / U_TILE;
  cudaError_t err = cudaMemsetAsync(cnt, 0, (size_t)pp_reshuffle_count_words(C, E) * sizeof(int),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  const bool vec = reinterpret_cast<uintptr_t>(elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(old_elem) % 16 == 0;
  reshuffle_count_kernel<<<(unsigned)n_tiles, U_THREADS, 0, stream>>>(
      elem, old_elem, seg_cap, E, C, MB, (int)n_tiles, vec, cnt, mov_start, msrc, mkey, info,
      num);
  return (int)cudaGetLastError();
}

// U2: fields: n_fields (<= 16) staged rows and the structure's field
// tensors (host arrays of pointers, written in place) with their row
// bytes; row_to_elem: the Sell-C-σ row order (n_rows a multiple of chunk),
// or null for CabM (chunk 1, elem_offsets (E + 1,)); elem_out and
// active_out are written whole; num_ovf: two words, the count and the
// overflow flag (its first byte a bool), zeroed here (the one memset)
extern "C" int pp_reshuffle_place(const int* elem, const int* old_elem,
                                  const int* elem_offsets, const int* seg_cap,
                                  const int* mov_cnt, const int* mov_start,
                                  const int* row_to_elem, int n_rows, int E,
                                  long long C, int chunk, const uint8_t* ovf_in,
                                  int n_fields, const void* const* staged,
                                  void* const* fields, const int* row_bytes, int* elem_out,
                                  uint8_t* active_out, int* num_ovf, cudaStream_t stream) {
  if (E <= 0 || C <= 0 || chunk < 1 || n_fields < 0 || n_fields > U_MAX_FIELDS ||
      (row_to_elem != nullptr ? n_rows < E || n_rows % chunk : chunk != 1))
    return (int)cudaErrorInvalidValue;
  const long long n_units = row_to_elem != nullptr ? n_rows / chunk : E;
  PlaceFields f = {};
  f.n = n_fields;
  for (int k = 0; k < n_fields; ++k) {
    const uintptr_t sp = reinterpret_cast<uintptr_t>(staged[k]);
    const uintptr_t dp = reinterpret_cast<uintptr_t>(fields[k]);
    if (row_bytes[k] < 1) return (int)cudaErrorInvalidValue;
    f.staged[k] = static_cast<const uint8_t*>(staged[k]);
    f.out[k] = static_cast<uint8_t*>(fields[k]);
    f.row_bytes[k] = row_bytes[k];
    f.words[k] = row_bytes[k] % 4 == 0 && sp % 4 == 0 && dp % 4 == 0;
  }
  cudaError_t err = cudaMemsetAsync(num_ovf, 0, 2 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const long long tail = (C + U2_THREADS - 1) / U2_THREADS;
  const int tail_blocks = (int)(tail < U2_TAIL_BLOCKS ? tail : U2_TAIL_BLOCKS);
  const long long blocks =
      tail_blocks + (n_units + U2_THREADS / 32 - 1) / (U2_THREADS / 32);
  reshuffle_place_kernel<<<(unsigned)blocks, U2_THREADS, 0, stream>>>(
      elem, old_elem, elem_offsets, seg_cap, mov_cnt, mov_start, row_to_elem, n_units, E, C,
      chunk, tail_blocks, ovf_in, f, elem_out, active_out, num_ovf);
  return (int)cudaGetLastError();
}

namespace {

// U3's bucket bits over E destinations: at most 2^U3_BUCKET_BITS buckets
int u3_bucket_bits(int E) {
  int bits = 0;
  while ((1LL << bits) < E) ++bits;              // the bits of E - 1
  return bits > U3_BUCKET_BITS ? bits - U3_BUCKET_BITS : 0;
}

// U3's grid: U3_BLOCKS_PER_SM blocks an SM (fewer where not resident at
// once with smem bytes each), at most U3_THREADS (a column is one block's
// scan)
cudaError_t u3_grid(int smem, int* grid) {
  const cudaError_t err = order_grid(reshuffle_order_kernel, U3_THREADS, smem,
                                     U3_WARPS * U3_TABLE_KEYS * 4 + 32 * 4, U3_BLOCKS_PER_SM,
                                     &u3_ready, grid);
  if (*grid > U3_THREADS) *grid = U3_THREADS;
  return err;
}

}  // namespace

// U3's key turns a bucket takes over E destinations (1 where E <= 524,288)
extern "C" int pp_reshuffle_order_turns(int E) {
  if (E <= 0) return 0;
  const int keys = 1 << u3_bucket_bits(E);
  return (keys + U3_TABLE_KEYS - 1) / U3_TABLE_KEYS;
}

// the blocks of U3's cooperative grid over E destinations
extern "C" int pp_reshuffle_order_grid(int E) {
  if (E <= 0) return 0;
  const int bs = u3_bucket_bits(E), nbk = ((E - 1) >> bs) + 1;
  const int kt = (1 << bs) < U3_TABLE_KEYS ? (1 << bs) : U3_TABLE_KEYS;
  int G = 0;
  if (u3_grid(U3_WARPS * (nbk > kt ? nbk : kt) * 4 + 32 * 4, &G) != cudaSuccess) return -1;
  return G;
}

// int32 words of U3's scratch over E destinations and n (< 2^28) movers
extern "C" int pp_reshuffle_order_scratch(int E, int n) {
  const int nbk = E <= 0 ? 0 : ((E - 1) >> u3_bucket_bits(E)) + 1;
  return nbk * U3_THREADS + 2 * n;
}

// U3: take[mov_start[mkey[i]] + (movers before i with mkey[i])] = msrc[i]
// for the n (< 2^28) movers; mkey in [0, E); scratch:
// pp_reshuffle_order_scratch(E, n) words
extern "C" int pp_reshuffle_order(const int* mkey, const int* msrc, const int* mov_start, int E,
                                  int n, int* take, int* scratch, cudaStream_t stream) {
  if (E <= 0 || n < 0 || n >= (1 << 28)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int bs = u3_bucket_bits(E), nbk = ((E - 1) >> bs) + 1;
  const int kt = (1 << bs) < U3_TABLE_KEYS ? (1 << bs) : U3_TABLE_KEYS;
  const int smem = U3_WARPS * (nbk > kt ? nbk : kt) * 4 + 32 * 4;   // + the block scan's
  int G = 0;
  cudaError_t err = u3_grid(smem, &G);
  if (err != cudaSuccess) return (int)err;
  int* tcount = scratch;
  int* tkey = scratch + (long long)nbk * G;
  int* tslot = tkey + n;
  err = launch_cooperative(reshuffle_order_kernel, G, U3_THREADS, smem, stream, mkey, msrc,
                           mov_start, E, n, bs, nbk, kt, take, tcount, tkey, tslot);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the blocks of Z's cluster (0 until its first launch)
extern "C" int pp_scs_row_order_cluster_blocks() {
  return z_cluster;
}

// int32 words of Z's scratch besides its 2R words of rows: the blocks'
// rows of digit counts
extern "C" int pp_scs_row_order_scratch_words() {
  return ORDER_CLUSTER_MAX * Z_BINS;
}

// Z over R rows (E <= R of them elements, R a multiple of chunk < 2^30):
// row_to_elem (R), elem_to_row (E), chunk_width (R / chunk); scratch:
// pp_scs_row_order_scratch_words() + 2R words
extern "C" int pp_scs_row_order(const int* counts, int E, int R, int sigma, int chunk,
                                int* row_to_elem, int* elem_to_row, int* chunk_width,
                                int* scratch, cudaStream_t stream) {
  if (E < 0 || R <= 0 || E > R || R >= (1 << 30) || sigma < 1 || chunk < 1 || R % chunk)
    return (int)cudaErrorInvalidValue;
  sigma = sigma < R ? sigma : R;
  const long long nwin = ((long long)R + sigma - 1) / sigma;
  int bw = 0;
  while ((1LL << bw) < nwin) ++bw;                 // the bits of nwin - 1
  cudaError_t err = order_cluster(scs_row_order_kernel, Z_THREADS, Z_SMEM, &z_cluster);
  if (err != cudaSuccess) return (int)err;
  int* gbins = scratch;
  int* buf0 = scratch + ORDER_CLUSTER_MAX * Z_BINS;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = z_cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(z_cluster);
  cfg.blockDim = dim3(Z_THREADS);
  cfg.dynamicSmemBytes = Z_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, scs_row_order_kernel, counts, E, R, sigma, bw, chunk,
                           row_to_elem, elem_to_row, chunk_width, buf0, buf0 + R, gbins);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
