// Kernels U1, U2 and Z: the particle structures' reshuffle-or-rebuild and
// the Sell-C-σ row order.
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
//  Z  scs_row_keys,    Replace _scs_row_order (:312-345) after the pad: the
//     scs_row_maps     descending stable sort of the padded counts within σ
//                      windows becomes kernel C's ascending stable sort of
//                      one int32 key a row, window·2^(b+1) + (2^b - 1 -
//                      count), the padding rows' count -1 (2^b: after every
//                      real count) with 2^b above every count; then the
//                      row -> element map is C's order, and scs_row_maps
//                      writes the element -> row map and each chunk's width
//                      (the largest count of its rows, 0 for padding).
//
// The TPU ran all of it as XLA code (a one-hot matmul histogram, a slot-
// rate argsort, cumsums, a searchsorted and scatters); no Pallas kernel.
//
// What bounds them on an H100: device-memory bytes.  U1 reads two int32
// ids a slot (8 bytes) and writes the movers' slots and keys; U2 reads the
// same two ids over the segments, writes each slot's id and mask (5 bytes)
// and reads and writes the movers' rows; Z is mesh-rate.
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
#include <cuda_runtime.h>
#include <stdint.h>

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
#define Z_THREADS 256
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
// Z: scs_row_keys, scs_row_maps
// ---------------------------------------------------------------------------

// key of row i < R: (i / sigma)·2^(b+1) + (2^b - 1 - count), count = counts[i]
// for i < E, -1 for the padding rows
__global__ void __launch_bounds__(Z_THREADS) scs_row_keys_kernel(
    const int* __restrict__ counts, int E, int R, int sigma, int b, int* __restrict__ key) {
  const int i = blockIdx.x * Z_THREADS + threadIdx.x;
  if (i >= R) return;
  const int c = i < E ? __ldg(counts + i) : -1;
  key[i] = (int)((unsigned)(i / sigma) * (2u << b) + ((1u << b) - 1u - (unsigned)c));
}

// row i's element is order[i]: elem_to_row[order[i]] = i for real rows;
// chunk k's width is the largest count of its rows (padding rows 0)
__global__ void __launch_bounds__(Z_THREADS) scs_row_maps_kernel(
    const int* __restrict__ order, const int* __restrict__ counts, int E, int R, int chunk,
    int* __restrict__ elem_to_row, int* __restrict__ chunk_width) {
  const int i = blockIdx.x * Z_THREADS + threadIdx.x;
  if (i < R) {
    const int e = __ldg(order + i);
    if (e < E) elem_to_row[e] = i;
  }
  if (i < R / chunk) {
    int w = 0;
    for (int r = i * chunk; r < (i + 1) * chunk; ++r) {
      const int e = __ldg(order + r);
      const int c = e < E ? __ldg(counts + e) : 0;
      w = c > w ? c : w;
    }
    chunk_width[i] = w;
  }
}

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

extern "C" int pp_scs_row_keys(const int* counts, int E, int R, int sigma, int b, int* key,
                               cudaStream_t stream) {
  if (R <= 0 || sigma < 1 || b < 1 || b > 30) return (int)cudaErrorInvalidValue;
  scs_row_keys_kernel<<<(R + Z_THREADS - 1) / Z_THREADS, Z_THREADS, 0, stream>>>(
      counts, E, R, sigma, b, key);
  return (int)cudaGetLastError();
}

extern "C" int pp_scs_row_maps(const int* order, const int* counts, int E, int R, int chunk,
                               int* elem_to_row, int* chunk_width, cudaStream_t stream) {
  if (R <= 0 || chunk < 1 || R % chunk) return (int)cudaErrorInvalidValue;
  scs_row_maps_kernel<<<(R + Z_THREADS - 1) / Z_THREADS, Z_THREADS, 0, stream>>>(
      order, counts, E, R, chunk, elem_to_row, chunk_width);
  return (int)cudaGetLastError();
}
