// Kernel N: the picparts step's counts over its slots, several at once.
//
// Replaces (JAX reference): the step's end-of-step sums, nloc = sum(active)
// and the exits and lost counts (pumipic_tpu/models/pseudo_xgcm.py:1202,
// pseudo_push_and_search.py:462), migrate's free-slot count and its sent,
// illegal and kept-home sums (pumipic_tpu/parallel/migrate.py:497-505,
// :605, :618-628), and, in its second launcher, step_stats' sums over the
// ranks (the psum/pmax of the stats and ptcl_imbalance,
// pumipic_tpu/parallel/balancer.py:449-457).
//
// A count is the number of slots where a conjunction of up to N_TERMS
// terms holds: a bool mask set or clear, an int32 array >= 0 or < 0.  Each
// of up to N_MAX counts has its own slot count and output; an optional
// int32 on the device is subtracted from it (the exits less the lost).
// One launch: a resident grid strides over chunks of 16 slots; a thread
// turns each term of a chunk into a 16-bit mask from 16-byte loads (the
// mask's 16 bytes, or four int4 of ids), ANDs a count's terms and adds the
// popcount; warp sums, a block sum in shared memory, one atomic a count
// and block into the caller's accumulator, then the last block (by a
// ticket) writes the outputs and sets the accumulator and the ticket back
// to 0, so the next launch on the stream needs no memset.  A chunk at a
// count's end, or terms not 16-byte aligned, take the slots one by one.
// Exact in int32 for any order of the blocks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define N_MAX 4
#define N_TERMS 3
#define N_THREADS 256

// term kinds
#define N_NONE 0
#define N_SET 1       // bool mask, true
#define N_CLEAR 2     // bool mask, false
#define N_NONNEG 3    // int32 >= 0
#define N_NEG 4       // int32 < 0

struct CountSpec {
  const void* term[N_TERMS];
  int kind[N_TERMS];
  long long n;        // slots of this count
  int* out;           // the count, less *sub where sub is given
  const int* sub;
};

struct CountParams {
  CountSpec c[N_MAX];
  int n_counts;
};

__device__ __forceinline__ bool term_holds(const void* p, int kind, long long i) {
  switch (kind) {
    case N_SET: return __ldg(static_cast<const uint8_t*>(p) + i) != 0;
    case N_CLEAR: return __ldg(static_cast<const uint8_t*>(p) + i) == 0;
    case N_NONNEG: return __ldg(static_cast<const int*>(p) + i) >= 0;
    case N_NEG: return __ldg(static_cast<const int*>(p) + i) < 0;
    default: return true;
  }
}

// bit b of the result: byte b of w (b < 4) is not 0
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// the term's 16-bit mask over the 16 slots from `base` (16-byte aligned)
__device__ __forceinline__ unsigned term_mask16(const void* p, int kind, long long base) {
  if (kind == N_SET || kind == N_CLEAR) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(p) + base));
    const unsigned m = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 | nonzero_bytes(v.z) << 8
                     | nonzero_bytes(v.w) << 12;
    return kind == N_SET ? m : ~m & 0xffffu;
  }
  unsigned neg = 0;
  const int4* q = reinterpret_cast<const int4*>(static_cast<const int*>(p) + base);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int4 v = __ldg(q + j);
    neg |= ((unsigned)v.x >> 31 | ((unsigned)v.y >> 31) << 1 | ((unsigned)v.z >> 31) << 2
            | ((unsigned)v.w >> 31) << 3) << (4 * j);
  }
  return kind == N_NEG ? neg : ~neg & 0xffffu;
}

// acc: N_MAX accumulators and the ticket, all 0 between launches
__global__ void __launch_bounds__(N_THREADS) slot_counts_kernel(CountParams prm, long long n,
                                                               int vec, int* __restrict__ acc) {
  int cnt[N_MAX];
#pragma unroll
  for (int c = 0; c < N_MAX; ++c) cnt[c] = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n_chunks = (n + 15) / 16;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n_chunks;
       j += stride) {
    const long long base = j * 16;
#pragma unroll
    for (int c = 0; c < N_MAX; ++c) {
      if (c >= prm.n_counts || base >= prm.c[c].n) continue;
      if (vec && base + 16 <= prm.c[c].n) {
        unsigned m = 0xffffu;
#pragma unroll
        for (int k = 0; k < N_TERMS; ++k) {
          if (prm.c[c].kind[k] != N_NONE) m &= term_mask16(prm.c[c].term[k], prm.c[c].kind[k], base);
        }
        cnt[c] += __popc(m);
      } else {
        for (long long i = base; i < base + 16 && i < prm.c[c].n; ++i) {
          bool hold = true;
#pragma unroll
          for (int k = 0; k < N_TERMS; ++k) {
            if (prm.c[c].kind[k] != N_NONE)
              hold = hold && term_holds(prm.c[c].term[k], prm.c[c].kind[k], i);
          }
          cnt[c] += hold ? 1 : 0;
        }
      }
    }
  }
  __shared__ int s_cnt[N_MAX][N_THREADS / 32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < N_MAX; ++c) {
    const int v = __reduce_add_sync(0xffffffffu, cnt[c]);
    if (lane == 0) s_cnt[c][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < N_MAX && threadIdx.x < prm.n_counts) {
    int b = 0;
    for (int w = 0; w < N_THREADS / 32; ++w) b += s_cnt[threadIdx.x][w];
    if (b != 0) atomicAdd(&acc[threadIdx.x], b);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&acc[N_MAX], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (s_last && threadIdx.x < prm.n_counts) {
    const int c = threadIdx.x;
    const int total = atomicExch(&acc[c], 0);
    const int* sub = prm.c[c].sub;
    *prm.c[c].out = total - (sub != nullptr ? *sub : 0);
  }
  if (s_last && threadIdx.x == 0) acc[N_MAX] = 0;
}

static int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slot_counts_kernel, N_THREADS, 0);
    blocks = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

// The counts of `n_counts` predicates (terms[c * N_TERMS + k], kinds[...],
// n_slots[c], outs[c], subs[c]; a null term is no term, a null sub none),
// in one launch.  acc: the caller's N_MAX + 1 int32, 0 before the first
// launch (each launch leaves them 0).
extern "C" int pp_slot_counts(const void* const* terms, const int* kinds,
                              const long long* n_slots, int* const* outs,
                              const int* const* subs, int n_counts, int* acc,
                              cudaStream_t stream) {
  if (n_counts < 1 || n_counts > N_MAX) return (int)cudaErrorInvalidValue;
  CountParams prm = {};
  prm.n_counts = n_counts;
  long long n = 0;
  int vec = 1;        // every term 16-byte aligned: chunks by 16-byte loads
  for (int c = 0; c < n_counts; ++c) {
    for (int k = 0; k < N_TERMS; ++k) {
      prm.c[c].term[k] = terms[c * N_TERMS + k];
      prm.c[c].kind[k] = terms[c * N_TERMS + k] != nullptr ? kinds[c * N_TERMS + k] : N_NONE;
      if (prm.c[c].kind[k] < N_NONE || prm.c[c].kind[k] > N_NEG)
        return (int)cudaErrorInvalidValue;
      if (reinterpret_cast<uintptr_t>(prm.c[c].term[k]) % 16) vec = 0;
    }
    prm.c[c].n = n_slots[c];
    prm.c[c].out = outs[c];
    prm.c[c].sub = subs[c];
    if (n_slots[c] > n) n = n_slots[c];
  }
  long long blocks = ((n + 15) / 16 + N_THREADS - 1) / N_THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > resident_blocks()) blocks = resident_blocks();
  slot_counts_kernel<<<(unsigned)blocks, N_THREADS, 0, stream>>>(prm, n, vec, acc);
  return (int)cudaGetLastError();
}

// step_stats' reduction over the ranks: g is the (R, W) int32 gather of
// every rank's W counts (W <= 32); out[w] <- the sum of column w over the
// ranks (int32, wrapping as torch's int32 sum), the maximum where w ==
// max_col; out[W] <- the bits of the f32 imbalance max/avg of column 0
// (1 where avg is 0): the column's f32 maximum over its f32 sum divided
// by R, the sum exact in int64 and rounded to f32 once.  One warp.
__global__ void rank_stats_kernel(const int* __restrict__ g, int R, int W, int max_col,
                                  int* __restrict__ out) {
  const int w = threadIdx.x;
  if (w >= W) return;
  int acc = (w == max_col && R > 0) ? g[w] : 0;
  for (int r = 0; r < R; ++r) {
    const int v = g[(long long)r * W + w];
    acc = w == max_col ? max(acc, v) : (int)((unsigned)acc + (unsigned)v);
  }
  out[w] = acc;
  if (w == 0) {
    long long total = 0;
    float mx = -INFINITY;
    for (int r = 0; r < R; ++r) {
      const int v = g[(long long)r * W];
      total += v;
      mx = fmaxf(mx, (float)v);
    }
    const float avg = (float)total / (float)R;
    const float imb = avg > 0.0f ? mx / avg : 1.0f;
    out[W] = __float_as_int(imb);
  }
}

extern "C" int pp_rank_stats(const int* g, int R, int W, int max_col, int* out,
                             cudaStream_t stream) {
  if (R < 1 || W < 1 || W > 32) return (int)cudaErrorInvalidValue;
  rank_stats_kernel<<<1, 32, 0, stream>>>(g, R, W, max_col, out);
  return (int)cudaGetLastError();
}
