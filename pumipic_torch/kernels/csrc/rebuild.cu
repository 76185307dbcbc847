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
//                  :483, get_pids :181): the int32 order of int32 keys in
//                  [0, K], equal to a stable argsort.  That permutation is
//                  unique, so the kernel and torch.sort agree bit for bit.
//
// The TPU ran both as XLA code (a sort, fused elementwise ops, a
// reduction); no Pallas kernel.
//
// What bounds them on an H100: device-memory traffic.  Q reads 5–9 bytes a
// slot and writes 5.  C must at least read the keys and write the order, 8
// bytes a key; an LSD radix sort moves more (below).
//
// C's design: LSD radix over the key's bits (bits = bit length of K), in
// ceil(bits / 9) passes of at most 9 bits (512 digits): the app's 122,604
// keys take two passes of 9 and 8 bits, a 0/1 partition one pass of 1 bit.
// Each pass is four launches over tiles of KS_TILE keys (KS_WARPS warps,
// warp w holding keys [w·KS_WARP_KEYS, (w+1)·KS_WARP_KEYS) of the tile in
// KS_CHUNKS chunks of 32):
//  1. ks_count: the tile's count of each digit (__match_any_sync groups the
//     lanes of one digit; its highest lane adds the group to a shared
//     counter), written digit-major (digit·n_tiles + tile);
//  2. ks_scan_rows: one block a digit scans its row of tile counts in
//     place (exclusive) and writes the row's total;
//  3. ks_scan_digits: one block turns the totals into each digit's first
//     position (exclusive);
//  4. ks_scatter: each warp ranks its chunks in order on its own shared
//     counters (the rank among the lower lanes of its digit plus the
//     counter), the block turns the warps' counters into per-warp bases
//     (digit position + tile prefix + the lower warps' counts), and each
//     key goes to base + rank with its source index.
// Ranks follow index order inside a chunk, a warp and a tile, and tiles
// follow index order through the row prefix, so every pass is stable and
// the result is the stable argsort.  The first pass reads the keys alone
// (the index is the key's own), the last writes the order alone.  A digit
// outside the top pass's range (a key outside [0, K]) is clamped to its
// last digit, so such keys still get distinct positions.
#include <cuda_runtime.h>
#include <stdint.h>

#define Q_THREADS 256
#define Q_BLOCKS_PER_SM 8
#define KS_WARPS 8
#define KS_THREADS (32 * KS_WARPS)
#define KS_CHUNKS 16
#define KS_WARP_KEYS (32 * KS_CHUNKS)
#define KS_TILE (KS_WARPS * KS_WARP_KEYS)
#define KS_MAX_BITS 9
#define KS_MAX_DIGITS (1 << KS_MAX_BITS)
#define KS_SCAN_THREADS 1024

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

// the digit of a key in a pass: bits [shift, shift + width); the top pass
// clamps the rest of the key into its last digit
__device__ __forceinline__ int ks_digit(int key, int shift, int width, int top) {
  const unsigned d = (unsigned)key >> shift;
  const unsigned last = (1u << width) - 1u;
  return (int)(top ? (d > last ? last : d) : (d & last));
}

// launch 1: the tile's count of each digit
__global__ void __launch_bounds__(KS_THREADS) ks_count(
    const int* __restrict__ key, long long n, int shift, int width, int top,
    int* __restrict__ tile_counts, int n_tiles) {
  __shared__ int cnt[KS_MAX_DIGITS];
  const int n_digits = 1 << width;
  for (int d = threadIdx.x; d < n_digits; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * KS_TILE + (long long)warp * KS_WARP_KEYS;
  for (int c = 0; c < KS_CHUNKS; ++c) {
    const long long i = first + c * 32 + lane;
    const int d = i < n ? ks_digit(key[i], shift, width, top) : -1;
    const unsigned grp = __match_any_sync(0xffffffffu, d);
    if (d >= 0 && lane == 31 - __clz(grp)) atomicAdd(&cnt[d], __popc(grp));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_digits; d += blockDim.x)
    tile_counts[(long long)d * n_tiles + blockIdx.x] = cnt[d];
}

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

// launch 2: one block a digit: the exclusive prefix of its row of tile
// counts, in place, and the row's total
__global__ void __launch_bounds__(KS_SCAN_THREADS) ks_scan_rows(
    int* __restrict__ tile_counts, int n_tiles, int* __restrict__ totals) {
  __shared__ int smem[32];
  int* row = tile_counts + (long long)blockIdx.x * n_tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int v = t < n_tiles ? row[t] : 0;
    int total;
    const int incl = ks_block_scan(v, smem, &total);
    if (t < n_tiles) row[t] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// launch 3: one block: each digit's first position (exclusive prefix of
// the totals, in place)
__global__ void __launch_bounds__(KS_MAX_DIGITS) ks_scan_digits(
    int* __restrict__ totals, int n_digits) {
  __shared__ int smem[32];
  const int d = threadIdx.x;
  const int v = d < n_digits ? totals[d] : 0;
  int total;
  const int incl = ks_block_scan(v, smem, &total);
  if (d < n_digits) totals[d] = incl - v;
}

// launch 4: each key to its position, with its source index (the key's
// own where idx_in is null); keys_out null: the order alone
__global__ void __launch_bounds__(KS_THREADS) ks_scatter(
    const int* __restrict__ key, const int* __restrict__ idx_in, long long n,
    int shift, int width, int top, const int* __restrict__ tile_prefix, int n_tiles,
    const int* __restrict__ digit_start, int* __restrict__ key_out,
    int* __restrict__ idx_out) {
  __shared__ int wcnt[KS_WARPS][KS_MAX_DIGITS];
  const int n_digits = 1 << width;
  for (int d = threadIdx.x; d < n_digits; d += blockDim.x) {
#pragma unroll
    for (int w = 0; w < KS_WARPS; ++w) wcnt[w][d] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long first = (long long)blockIdx.x * KS_TILE + (long long)warp * KS_WARP_KEYS;
  int k[KS_CHUNKS], r[KS_CHUNKS];
  // ranks inside the warp, chunk after chunk
#pragma unroll
  for (int c = 0; c < KS_CHUNKS; ++c) {
    const long long i = first + c * 32 + lane;
    k[c] = i < n ? key[i] : 0;
    const int d = i < n ? ks_digit(k[c], shift, width, top) : -1;
    const unsigned grp = __match_any_sync(0xffffffffu, d);
    r[c] = 0;
    if (d >= 0) r[c] = wcnt[warp][d] + __popc(grp & lower);
    __syncwarp();
    if (d >= 0 && lane == 31 - __clz(grp)) wcnt[warp][d] += __popc(grp);
    __syncwarp();
  }
  __syncthreads();
  // per-warp bases: the digit's first position, the lower tiles' and the
  // lower warps' counts
  for (int d = threadIdx.x; d < n_digits; d += blockDim.x) {
    int s = digit_start[d] + tile_prefix[(long long)d * n_tiles + blockIdx.x];
#pragma unroll
    for (int w = 0; w < KS_WARPS; ++w) {
      const int t = wcnt[w][d];
      wcnt[w][d] = s;
      s += t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < KS_CHUNKS; ++c) {
    const long long i = first + c * 32 + lane;
    if (i < n) {
      const int pos = wcnt[warp][ks_digit(k[c], shift, width, top)] + r[c];
      idx_out[pos] = idx_in ? idx_in[i] : (int)i;
      if (key_out) key_out[pos] = k[c];
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

// tiles of a key_sort over n keys (the wrapper sizes the tile counts:
// KS_MAX_DIGITS rows of n_tiles)
extern "C" int pp_key_sort_tiles(long long n) { return (int)((n + KS_TILE - 1) / KS_TILE); }

// the order of n keys in [0, K] with bit length ``bits`` (>= 1) into
// ``order``; scratch: tile_counts (KS_MAX_DIGITS · tiles), totals
// (KS_MAX_DIGITS), and two key and index buffers of n (ka, ia, kb, ib:
// used from 2 passes on, kb and ib from 3)
extern "C" int pp_key_sort(const int* key, long long n, int bits, int* order,
                           int* tile_counts, int* totals, int* ka, int* ia, int* kb,
                           int* ib, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int n_tiles = pp_key_sort_tiles(n);
  const int passes = (bits + KS_MAX_BITS - 1) / KS_MAX_BITS;
  const int width0 = (bits + passes - 1) / passes;
  const int* kin = key;
  const int* iin = nullptr;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * width0;
    const int width = bits - shift < width0 ? bits - shift : width0;
    const int top = p == passes - 1;
    int* kout = top ? nullptr : (p % 2 == 0 ? ka : kb);
    int* iout = top ? order : (p % 2 == 0 ? ia : ib);
    ks_count<<<n_tiles, KS_THREADS, 0, stream>>>(kin, n, shift, width, top, tile_counts,
                                                  n_tiles);
    ks_scan_rows<<<(1 << width), KS_SCAN_THREADS, 0, stream>>>(tile_counts, n_tiles, totals);
    ks_scan_digits<<<1, KS_MAX_DIGITS, 0, stream>>>(totals, 1 << width);
    ks_scatter<<<n_tiles, KS_THREADS, 0, stream>>>(kin, iin, n, shift, width, top,
                                                    tile_counts, n_tiles, totals, kout,
                                                    iout);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kin = kout;
    iin = iout;
  }
  return 0;
}
