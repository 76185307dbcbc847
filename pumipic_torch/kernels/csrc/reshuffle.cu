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
// same two ids over the segments, writes each slot's id and mask (5
// bytes, the memsets included) and the movers' rows; Z is mesh-rate.
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
// (__match_any_sync); a mover adds alone (5% of the slots at the auto
// arms' push).  Movers are counted only while the movers before and in
// the tile fit the budget MB: past it the reshuffle cannot run (fits is
// false) and the sort rebuild counts afresh, so the fallback's movers
// (nearly every particle at a long push) cost no atomics.  The block that
// finishes last (a ticket, as kernel X1's counts-only mode) checks fits
// over the E elements and scans the movers' counts into their first
// places.
//
// U1's schedule: tiles of U_TILE consecutive slots taken by tickets in
// order; a thread takes U_J consecutive slots (16-byte loads), so the
// tile's slot order is the threads' order: a block scan of the threads'
// movers and a decoupled look-back over the earlier tiles' status words
// (count or inclusive prefix, flag in the top two bits) place them in the
// mover list in slot order, and the stable sort that follows keeps slot
// order within a destination, as the JAX argsort does.  Measured against
// (PERF.md): lanes taking slots U_THREADS apart with per-lane runs of a
// row (CabM's runs broke every other slot: 2.4x slower there), U_J = 32,
// 256 threads.
//
// U2's schedule: a warp a row of the row order (Sell-C-σ: a block's warps
// take neighbouring rows, which share their chunk's sectors; CabM: the
// elements in order); the warp walks the row's element's segment, slots
// elem_offsets[e] + q·stride for q < seg_cap[e] (stride: the SCS chunk,
// its transposed rows; 1 for CabM), U2_UNROLL rounds of 32 q's loaded at
// once; a ballot of the holes ranks them in q order and the hole of rank
// r < mov_cnt[e] takes staged row mov_start[e] + r.  The outputs are
// fresh (memsets to -1 and 0 first), so the inputs are never written: the
// staged rows (kernel G's gather of the movers, in C's order) make a
// mover's source slot that is another mover's destination harmless.  A
// segment with fewer holes below the capacity C than movers sets the
// sticky overflow flag and counts only the placed particles.
#include <cuda_runtime.h>
#include <stdint.h>

#define U_THREADS 512
#define U_J 16
#define U_TILE (U_THREADS * U_J)
// elements a thread of the last block takes at once
#define U_LAST 16
#define U2_THREADS 256
// q rounds of 32 slots a U2 warp loads at once
#define U2_UNROLL 4
#define U_MAX_FIELDS 16
#define Z_THREADS 256
// a tile's status word: its movers (flag 1) or the movers up to and with
// it (flag 2) below a flag in the top two bits
#define U_AGGREGATE (1u << 30)
#define U_INCLUSIVE (2u << 30)
#define U_VALUE (U_AGGREGATE - 1u)
// the header words of U1's scratch (after the 2E counters)
#define U_H_TICKET 0
#define U_H_DONE 1
#define U_H_NMOV 2
#define U_H_NSTAY 3
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

// the movers before ``tile``: the earlier tiles' status words, 32 at a
// time, summed back to the nearest inclusive prefix (warp-wide; a word not
// yet published is read again: every earlier tile is held by a running
// block, which publishes its count before it looks back)
__device__ unsigned look_back(volatile unsigned* status, long long tile, int lane) {
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
    unsigned v = lane <= stop ? (s & U_VALUE) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    excl += __shfl_sync(0xffffffffu, v, 0);
    if (incl) break;
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
__global__ void __launch_bounds__(U_THREADS) reshuffle_count_kernel(
    const int* __restrict__ elem, const int* __restrict__ old_elem,
    const int* __restrict__ seg_cap, int E, long long C, int MB, int n_tiles, bool vec,
    int* __restrict__ cnt, int* __restrict__ mov_start, int* __restrict__ msrc,
    int* __restrict__ mkey, int* __restrict__ info, int* __restrict__ num) {
  __shared__ int smem[32];
  __shared__ int s_tile, s_base, s_stay, s_last;
  unsigned* hdr = reinterpret_cast<unsigned*>(cnt + 2LL * E);
  volatile unsigned* status = hdr + U_HEADER;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = (int)atomicAdd(hdr + U_H_TICKET, 1u);
    s_stay = 0;
  }
  __syncthreads();
  const long long tile = s_tile;
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
  // the stayers: slot j of the warp's lanes lie U_J apart, one row of a
  // Sell-C-σ chunk (U_J a multiple of the chunk) or one CabM segment
  // mostly, so a group of one key adds once; the movers, a bit a slot
  unsigned mbits = 0u;
  int n_stay = 0;
#pragma unroll
  for (int j = 0; j < U_J; ++j) {
    const int e = ev[j];
    const bool st = e >= 0 && e == ov[j];
    mbits |= (unsigned)(e >= 0 && !st) << j;
    n_stay += st;
    const unsigned grp = __match_any_sync(0xffffffffu, st ? e : -1);
    if (st && lane == __ffs(grp) - 1) red_add(cnt + e, __popc(grp));
  }
  {
    const int w_stay = __reduce_add_sync(0xffffffffu, n_stay);
    if (lane == 0 && w_stay) atomicAdd(&s_stay, w_stay);
  }
  // the tile's movers before each thread's; the tile's place by look-back
  int total;
  const int mine = __popc(mbits);
  const int excl_t = block_scan(mine, smem, &total) - mine;
  if (warp == 0) {
    if (lane == 0)
      status[tile] = (tile == 0 ? U_INCLUSIVE : U_AGGREGATE) | (unsigned)total;
    const unsigned excl = look_back(status, tile, lane);
    if (lane == 0) {
      if (tile > 0) status[tile] = U_INCLUSIVE | (excl + (unsigned)total);
      s_base = (int)excl;
      if (total) atomicAdd(hdr + U_H_NMOV, (unsigned)total);
      if (s_stay) atomicAdd(hdr + U_H_NSTAY, (unsigned)s_stay);
    }
  }
  __syncthreads();
  const long long base = s_base;
  const bool count_movers = base + total <= MB;   // block-uniform
  long long pos = base + excl_t;
#pragma unroll
  for (int j = 0; j < U_J; ++j) {
    if ((mbits >> j) & 1u) {
      if (pos < MB) {
        msrc[pos] = (int)(s0 + j);
        mkey[pos] = ev[j];
      }
      if (count_movers) red_add(cnt + E + ev[j], 1);
      ++pos;
    }
  }
  // the last block to finish: fits and the movers' first places
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(hdr + U_H_DONE, 1u) == (unsigned)n_tiles - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int n_mov = (int)((volatile unsigned*)hdr)[U_H_NMOV];
  const int n_stay_all = (int)((volatile unsigned*)hdr)[U_H_NSTAY];
  int ok = 1, running = 0;
  for (long long c0 = 0; c0 < E; c0 += (long long)U_THREADS * U_LAST) {
    const long long i0 = c0 + (long long)threadIdx.x * U_LAST;
    int mc[U_LAST], sc[U_LAST], cap[U_LAST], sum = 0;
#pragma unroll
    for (int k = 0; k < U_LAST; ++k) {          // every load first
      const bool in = i0 + k < E;
      mc[k] = in ? __ldcg(cnt + E + i0 + k) : 0;
      sc[k] = in ? __ldcg(cnt + i0 + k) : 0;
      cap[k] = in ? __ldg(seg_cap + i0 + k) : 0;
    }
#pragma unroll
    for (int k = 0; k < U_LAST; ++k) {
      ok &= mc[k] <= cap[k] - sc[k];
      sum += mc[k];
    }
    int tot;
    int at = block_scan(sum, smem, &tot) - sum + running;
#pragma unroll
    for (int k = 0; k < U_LAST; ++k) {
      if (i0 + k < E) mov_start[i0 + k] = at;
      at += mc[k];
    }
    running += tot;
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
  uint8_t* out[U_MAX_FIELDS];            // (C, row) the cloned fields
  int row_bytes[U_MAX_FIELDS];
  int words[U_MAX_FIELDS];               // 1: rows move as 4-byte words
  int n;
};

__device__ __forceinline__ void copy_row(const PlaceFields& f, long long m, long long s) {
  for (int k = 0; k < f.n; ++k) {
    const int rb = f.row_bytes[k];
    if (f.words[k]) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(f.staged[k] + m * rb);
      uint32_t* dst = reinterpret_cast<uint32_t*>(f.out[k] + s * rb);
      for (int w = 0; w < rb / 4; ++w) dst[w] = src[w];
    } else {
      const uint8_t* src = f.staged[k] + m * rb;
      uint8_t* dst = f.out[k] + s * rb;
      for (int b = 0; b < rb; ++b) dst[b] = src[b];
    }
  }
}

// a warp a row: row r's element row_to_elem[r] (Sell-C-σ: a block's warps
// take neighbouring rows, which share their chunk's sectors; a padding row
// has nothing to place) or r (CabM, row_to_elem null); elem_out,
// active_out, num and ovf zeroed (elem_out to -1) by the launcher
__global__ void __launch_bounds__(U2_THREADS) reshuffle_place_kernel(
    const int* __restrict__ elem, const int* __restrict__ old_elem,
    const int* __restrict__ elem_offsets, const int* __restrict__ seg_cap,
    const int* __restrict__ mov_cnt, const int* __restrict__ mov_start,
    const int* __restrict__ row_to_elem, int n_rows, int E, long long C, int stride,
    const uint8_t* __restrict__ ovf_in, PlaceFields f, int* __restrict__ elem_out,
    uint8_t* __restrict__ active_out, int* __restrict__ num, uint8_t* __restrict__ ovf) {
  __shared__ int warp_sum[U2_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long r = (long long)blockIdx.x * (U2_THREADS / 32) + warp;
  const long long e = r >= n_rows ? E : row_to_elem != nullptr ? __ldg(row_to_elem + r) : r;
  int held = 0;
  if (e < E) {                                    // warp-uniform
    const long long base = __ldg(elem_offsets + e);
    const int cap = __ldg(seg_cap + e);
    const int k = __ldg(mov_cnt + e), ms = __ldg(mov_start + e);
    int holes = 0;
    for (int q0 = 0; q0 < cap; q0 += 32 * U2_UNROLL) {   // U2_UNROLL rounds' loads at once
      long long s[U2_UNROLL];
      int en[U2_UNROLL], eo[U2_UNROLL];
#pragma unroll
      for (int u = 0; u < U2_UNROLL; ++u) {
        const int q = q0 + 32 * u + lane;
        s[u] = base + (long long)q * stride;
        const bool in = q < cap && s[u] < C;
        en[u] = in ? __ldg(elem + s[u]) : -1;
        eo[u] = in ? __ldg(old_elem + s[u]) : -2;
      }
#pragma unroll
      for (int u = 0; u < U2_UNROLL; ++u) {
        const bool in = eo[u] != -2;
        const bool st = in && en[u] >= 0 && en[u] == eo[u];
        const bool hole = in && !st;
        const unsigned hb = __ballot_sync(0xffffffffu, hole);
        const int r = holes + __popc(hb & lower);
        if (st) {
          elem_out[s[u]] = en[u];
          active_out[s[u]] = 1;
        } else if (hole && r < k) {
          elem_out[s[u]] = (int)e;
          active_out[s[u]] = 1;
          copy_row(f, (long long)ms + r, s[u]);
        }
        held += st;
        holes += __popc(hb);
      }
    }
    held += lane == 0 ? min(holes, k) : 0;
    if (lane == 0 && holes < k) *ovf = 1;         // a mover found no hole
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) held += __shfl_down_sync(0xffffffffu, held, o);
  if (lane == 0) warp_sum[warp] = held;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < U2_THREADS / 32; ++w) t += warp_sum[w];
    if (t) atomicAdd(num, t);
    if (blockIdx.x == 0 && *ovf_in) *ovf = 1;     // sticky
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

// U2: fields: n_fields (<= 16) staged and output pointers (host arrays) with
// their row bytes; elem_out, active_out, num and ovf are written whole
extern "C" int pp_reshuffle_place(const int* elem, const int* old_elem,
                                  const int* elem_offsets, const int* seg_cap,
                                  const int* mov_cnt, const int* mov_start,
                                  const int* row_to_elem, int n_rows, int E,
                                  long long C, int stride, const uint8_t* ovf_in,
                                  int n_fields, const void* const* staged,
                                  void* const* outs, const int* row_bytes, int* elem_out,
                                  uint8_t* active_out, int* num, uint8_t* ovf,
                                  cudaStream_t stream) {
  if (E <= 0 || C <= 0 || stride < 1 || n_fields < 0 || n_fields > U_MAX_FIELDS ||
      n_rows < (row_to_elem != nullptr ? E : 0))
    return (int)cudaErrorInvalidValue;
  if (row_to_elem == nullptr) n_rows = E;
  PlaceFields f = {};
  f.n = n_fields;
  for (int k = 0; k < n_fields; ++k) {
    const uintptr_t sp = reinterpret_cast<uintptr_t>(staged[k]);
    const uintptr_t dp = reinterpret_cast<uintptr_t>(outs[k]);
    if (row_bytes[k] < 1) return (int)cudaErrorInvalidValue;
    f.staged[k] = static_cast<const uint8_t*>(staged[k]);
    f.out[k] = static_cast<uint8_t*>(outs[k]);
    f.row_bytes[k] = row_bytes[k];
    f.words[k] = row_bytes[k] % 4 == 0 && sp % 4 == 0 && dp % 4 == 0;
  }
  cudaError_t err = cudaMemsetAsync(elem_out, 0xff, C * sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(active_out, 0, C, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(num, 0, sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(ovf, 0, 1, stream);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)n_rows + U2_THREADS / 32 - 1) / (U2_THREADS / 32);
  reshuffle_place_kernel<<<(unsigned)blocks, U2_THREADS, 0, stream>>>(
      elem, old_elem, elem_offsets, seg_cap, mov_cnt, mov_start, row_to_elem, n_rows, E, C,
      stride, ovf_in, f, elem_out, active_out, num, ovf);
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
