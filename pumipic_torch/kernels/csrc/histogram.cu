// Kernel H: per-element particle histogram.
//
// Replaces (JAX reference): count_per_key_matmul
// (pumipic_tpu/ops/scatter.py:65-129), as accumulate_to_rings calls it
// (:171-192): key = active ? elem : E, keys outside [0, E) dropped.  The TPU
// built it as a bf16 one-hot matmul on the MXU; here it is int32 adds into
// the (E,) count array, exact in any order.
//
// (element, ring) key mode, for a per-particle gyro radius (:193-222): each
// active particle computes its lower ring rd = clip(floor(rg / ring_width)
// - 1, 0, R - 2) in f32 and adds one to keys elem·R + rd and elem·R + rd + 1
// of the (E·R,) counts.  The JAX package builds the keys in f32 below 2^24
// and in int32 above; both give these integers, which the wrapper keeps
// below 2^31.  A radius whose ring index is NaN deposits nothing (the JAX
// one-hot drops its NaN key).
//
// What bounds it on an H100: the 5 bytes read per particle (9 in key mode),
// ~50 MB at 10M, 0.015 ms at 3.35 TB/s, if the adds keep up.  They do not
// when each particle adds on its own: the main path's keys are ordered
// (particles are seeded element by element, and every sorted rebuild
// orders them again), so the 32 lanes of a warp hit one or two counters
// and the L2 serialises their atomics: one add per particle took 0.21 ms at
// 10M (0.28 ms in key mode).  With the adds merged below it takes 0.05 to
// 0.06 ms on ordered keys (0.11 in key mode); keys in random order still
// need 10M adds to distinct counters, 0.24 ms, bound by the L2's atomic
// rate and not by bytes.
//
// Design: few adds for ordered keys.  A thread takes 8 consecutive
// particles (two 16-byte loads of elem, one 8-byte load of the active
// bytes, two of the radius in key mode, on the read-only path; a scalar
// head aligns them, and the head, the tail and misaligned views go element
// by element), merges its equal consecutive keys into (key, count) runs,
// and hands each run to a warp-wide round.  Where two neighbouring lanes
// hold the same key (keys in order), lanes with equal keys combine
// (__match_any_sync, __reduce_add_sync) and one lane adds the sum
// (red.global.add, result unused); otherwise (keys in random order) each
// lane adds its own run, as one add per particle did before.  In key mode
// a run is one lower key, and its count goes to both keys.  Measured and
// not kept (PERF.md): the two keys' counts packed per element, and a
// per-block shared-memory table of the leaders' sums.
//
// Weighted mode, kernel W (launched as wall_tally): the GITR-style app's wall
// flux tally, pumipic_tpu/models/gitr_like.py:147-164 (a segment_sum of f32
// weights there).  Keys are the exit faces of the particles with the mask,
// each adds its int32 weight (absorb: 1 per lost particle; reflect: its
// num_hits), a weight <= 0 adds nothing.  Runs sum their weights in place of
// their lengths.  Integer adds: exact in any order.  Bound on an H100: 9
// bytes read per particle (side, mask, weight), ~90 MB at 10M, 0.027 ms;
// the keys are the few hit particles' faces in random order, so nearly every
// particle is dropped at its mask and the adds are few.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define H_PER_THREAD 8
#define H_THREADS 256

__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// add c to key k of the counts (and to k + 1 in key mode)
template <bool RINGS>
__device__ __forceinline__ void add_run(int* __restrict__ counts, int k, int c) {
  red_add(counts + k, c);
  if (RINGS) red_add(counts + k + 1, c);
}

// one warp-wide round: each lane with `have` adds its run (k, c);
// warp-synchronous, every lane calls it
template <bool RINGS>
__device__ __forceinline__ void warp_add(int* __restrict__ counts, bool have,
                                         int k, int c) {
  const unsigned full = 0xffffffffu;
  const unsigned off = __ballot_sync(full, have);
  if (off == 0) return;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(full, k, 1);
  const bool dup = have && lane > 0 && ((off >> (lane - 1)) & 1u) && prev == k;
  if (__any_sync(full, dup)) {
    if (have) {
      const unsigned grp = __match_any_sync(off, k);
      c = __reduce_add_sync(grp, c);
      have = lane == __ffs(grp) - 1;
    }
  }
  if (have) add_run<RINGS>(counts, k, c);
}

// run key of particle (e, a, rg, w), false if it deposits nothing: elem
// mode key = e, key mode key = e·R + rd, the lower of its two keys; a
// weight w <= 0 deposits nothing
template <bool RINGS>
__device__ __forceinline__ bool key_of(int e, bool a, float rg, int w,
                                       float ring_width, int n_elems, int n_rings,
                                       float rd_max, int* key) {
  if (!a || e < 0 || e >= n_elems || w <= 0) return false;
  if (!RINGS) {
    *key = e;
    return true;
  }
  const float rdf = floorf(rg / ring_width) - 1.0f;
  if (isnan(rdf)) return false;
  *key = e * n_rings + (int)fminf(fmaxf(rdf, 0.0f), rd_max);
  return true;
}

// groups of 8 particles: group 0 is [0, head) when head > 0; the others
// start at head + 8·k, where (with `vec`) the loads are aligned
template <bool RINGS, bool WEIGHTED>
__global__ void __launch_bounds__(H_THREADS)
    histogram_kernel(const int* __restrict__ elem,
                     const uint8_t* __restrict__ active,
                     const float* __restrict__ radius,
                     const int* __restrict__ weight, float ring_width,
                     int n_elems, int n_rings, int* __restrict__ counts,
                     long long n, int head, int vec) {
  const float rd_max = (float)(n_rings - 2);
  const int lane = threadIdx.x & 31;
  const long long skip = head > 0 ? 1 : 0;
  const long long n_groups = skip + (n - head + H_PER_THREAD - 1) / H_PER_THREAD;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // warp-uniform loop: every lane runs every round
  for (long long gw = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       gw < n_groups; gw += stride) {
    const long long g = gw + lane;
    long long p0 = 0;
    int len = 0;
    if (g < skip) {
      len = head;
    } else if (g < n_groups) {
      p0 = head + (g - skip) * H_PER_THREAD;
      len = n - p0 < H_PER_THREAD ? (int)(n - p0) : H_PER_THREAD;
    }
    int key[H_PER_THREAD];
    bool ok[H_PER_THREAD];
    int wt[H_PER_THREAD];
    if (vec && len == H_PER_THREAD && g >= skip) {
      const int4 e0 = __ldg(reinterpret_cast<const int4*>(elem + p0));
      const int4 e1 = __ldg(reinterpret_cast<const int4*>(elem + p0) + 1);
      const uint2 ab = __ldg(reinterpret_cast<const uint2*>(active + p0));
      const int e[H_PER_THREAD] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
      float r[H_PER_THREAD] = {};
      if (RINGS) {
        const float4 r0 = __ldg(reinterpret_cast<const float4*>(radius + p0));
        const float4 r1 = __ldg(reinterpret_cast<const float4*>(radius + p0) + 1);
        r[0] = r0.x; r[1] = r0.y; r[2] = r0.z; r[3] = r0.w;
        r[4] = r1.x; r[5] = r1.y; r[6] = r1.z; r[7] = r1.w;
      }
#pragma unroll
      for (int i = 0; i < H_PER_THREAD; ++i) wt[i] = 1;
      if (WEIGHTED) {
        const int4 w0 = __ldg(reinterpret_cast<const int4*>(weight + p0));
        const int4 w1 = __ldg(reinterpret_cast<const int4*>(weight + p0) + 1);
        wt[0] = w0.x; wt[1] = w0.y; wt[2] = w0.z; wt[3] = w0.w;
        wt[4] = w1.x; wt[5] = w1.y; wt[6] = w1.z; wt[7] = w1.w;
      }
#pragma unroll
      for (int i = 0; i < H_PER_THREAD; ++i) {
        const uint32_t word = i < 4 ? ab.x : ab.y;
        const bool a = ((word >> (8 * (i & 3))) & 0xffu) != 0;
        ok[i] = key_of<RINGS>(e[i], a, r[i], wt[i], ring_width, n_elems, n_rings,
                              rd_max, &key[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < H_PER_THREAD; ++i) {
        ok[i] = false;
        wt[i] = 1;
        if (i < len) {
          if (WEIGHTED) wt[i] = weight[p0 + i];
          ok[i] = key_of<RINGS>(elem[p0 + i], active[p0 + i] != 0,
                                RINGS ? radius[p0 + i] : 0.0f, wt[i], ring_width,
                                n_elems, n_rings, rd_max, &key[i]);
        }
      }
    }
    // runs of equal keys (a run's count is the sum of its weights); round i
    // adds the run that ends before particle i
    int ck = 0, cc = 0;
#pragma unroll
    for (int i = 0; i < H_PER_THREAD; ++i) {
      const bool fresh = ok[i] && (cc == 0 || key[i] != ck);
      warp_add<RINGS>(counts, fresh && cc > 0, ck, cc);
      if (fresh) {
        ck = key[i];
        cc = wt[i];
      } else if (ok[i]) {
        cc += wt[i];
      }
    }
    warp_add<RINGS>(counts, cc > 0, ck, cc);
  }
}

static int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// the launcher's alignment check: the first particle h < 8 from which the
// 8-particle loads of elem, active (and radius or weight) are all aligned,
// if any
static int launch(const int* elem, const uint8_t* active, const float* radius,
                  const int* weight, float ring_width, int n_elems, int n_rings,
                  int* counts, long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int head = 0, vec = 0;
  for (int h = 0; h < H_PER_THREAD && h <= n && !vec; ++h) {
    const uintptr_t pe = reinterpret_cast<uintptr_t>(elem) + 4ull * h;
    const uintptr_t pa = reinterpret_cast<uintptr_t>(active) + h;
    const uintptr_t pr = reinterpret_cast<uintptr_t>(radius) + 4ull * h;
    const uintptr_t pw = reinterpret_cast<uintptr_t>(weight) + 4ull * h;
    if (pe % 16 == 0 && pa % 8 == 0 && (radius == nullptr || pr % 16 == 0) &&
        (weight == nullptr || pw % 16 == 0)) {
      head = h;
      vec = 1;
    }
  }
  const long long groups = (head > 0) + (n - head + H_PER_THREAD - 1) / H_PER_THREAD;
  long long blocks = (groups + H_THREADS - 1) / H_THREADS;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  if (weight != nullptr)
    histogram_kernel<false, true><<<(unsigned)blocks, H_THREADS, 0, stream>>>(
        elem, active, radius, weight, ring_width, n_elems, n_rings, counts, n, head,
        vec);
  else if (radius == nullptr)
    histogram_kernel<false, false><<<(unsigned)blocks, H_THREADS, 0, stream>>>(
        elem, active, radius, weight, ring_width, n_elems, n_rings, counts, n, head,
        vec);
  else
    histogram_kernel<true, false><<<(unsigned)blocks, H_THREADS, 0, stream>>>(
        elem, active, radius, weight, ring_width, n_elems, n_rings, counts, n, head,
        vec);
  return (int)cudaGetLastError();
}

// counts must be zeroed by the caller
extern "C" int pp_histogram(const int* elem, const uint8_t* active, int n_keys,
                            int* counts, long long n, cudaStream_t stream) {
  return launch(elem, active, nullptr, nullptr, 1.0f, n_keys, 1, counts, n, stream);
}

// kernel W: counts[side] += weight (1 where weight is nullptr) over the
// particles with mask; counts (n_faces,) zeroed by the caller
extern "C" int pp_wall_tally(const int* side, const uint8_t* mask, const int* weight,
                             int n_faces, int* counts, long long n,
                             cudaStream_t stream) {
  return launch(side, mask, nullptr, weight, 1.0f, n_faces, 1, counts, n, stream);
}

// (element, ring) key mode: counts (n_elems·n_rings,) zeroed by the caller;
// n_rings >= 2 and n_elems·n_rings < 2^31 (checked by the wrapper)
extern "C" int pp_histogram_rings(const int* elem, const uint8_t* active,
                                  const float* radius, float ring_width,
                                  int n_elems, int n_rings, int* counts,
                                  long long n, cudaStream_t stream) {
  if (n_rings < 2) return (int)cudaErrorInvalidValue;
  return launch(elem, active, radius, nullptr, ring_width, n_elems, n_rings, counts, n,
                stream);
}
