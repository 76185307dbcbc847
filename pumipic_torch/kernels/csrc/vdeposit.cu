// Kernel V: the deterministic weighted deposit, a sum of f32 terms per
// output with no float atomics.
//
// Replaces (JAX reference): the segment_sums of particles_per_element with
// weights (pumipic_tpu/ops/scatter.py:132-143; one term a particle, its
// weight, keyed by its element) and of scatter_to_verts_bcc (:278-295; k
// terms a particle, bcc_j · q, keyed by its parent's vertices).  The TPU
// ran them as XLA scatter-adds; no Pallas kernel.
//
// What bounds it on an H100: the particle streams, read once: 4 bytes of
// element and 1 of mask, 4 of weight, or 12 of barycentric coordinates and
// 4 of charge (21 bytes a particle for the bcc deposit), and the (E, 3)
// vertex table and the f32 output once (a few MB): 0.063 ms for the charge
// deposit at 10M.  The 16-byte integer accumulator of each output (1 MB at
// 60k vertices) stays in L2.  Above that, the adds into L2: the first V
// made every term two 64-bit atomics (60M for the charge deposit at 10M);
// its probes (scripts/ab_trace2d_vdeposit.py) found each term's own L2
// transaction, more than same-address serialisation, to be its cost (the
// atomics as plain stores: 0.70 of its 1.10 ms; on distinct addresses:
// 0.81).  After one walk of the 2D path (the particles seeded element by
// element, then pushed 3 triangle sizes) a warp's 32 particles hold 23
// distinct vertices per term column, but a block tile's 1,024 particles
// only 145 among their 3,072 terms (166 elements among 1,024 for the
// weighted count), so summing a tile's terms in shared memory first leaves
// 1.4M pairs of L2 atomics in place of 30M.  What remains: the max pass
// (0.19 ms: it reads every stream and key) and the sum's reads and
// shared-memory adds.  Keys in random order (2,875 distinct in a tile) keep
// a pair of atomics a term, and the particles drift apart over the path's
// calls (its profile: the sum pass 1.35 -> 0.93 ms a call, both deposits).
//
// Design: a sum in fixed point, so that the result does not depend on the
// order of the adds (integer addition is associative) and equals its plain
// version bit for bit.
// - Scale (vmax_kernel): the largest |term| as an unsigned atomicMax on its
//   f32 bits (one per warp), which also zeroes the accumulators.  From its
//   exponent e (|term| < 2^e) and L = ceil(log2(terms)), each kernel picks
//   K = 94 - L - e on the device: no host sync.
// - Sum (vsum_kernel): each term, converted exactly to f64 and scaled by
//   2^K, is rounded to the nearest integer (ties to even), X, |X| <= 2^(94-L),
//   split exactly into X = H·2^32 + Lo with 0 <= Lo < 2^32, and added into
//   the output's (H, Lo) pair of 64-bit integers.  A block takes tiles of
//   V_TILE·V_THREADS consecutive particles and adds each term into a slot of
//   a shared-memory table keyed by output (open addressing from key mod
//   V_TABLE, at most V_PROBES slots, 64-bit shared atomics), then flushes
//   the table with two L2 atomics a key; a term that finds no slot, or a
//   table already holding V_FULL keys (keys in random order fill it at
//   once), adds its pair into L2 itself.  Every partial sum is a sub-sum of
//   an output's exact sums, so none can overflow: |ΣH| <= 2^62 and ΣLo <
//   2^63 for fewer than 2^31 terms.  Measured and left out: equal keys
//   summed inside each warp (__match_any_sync and a shuffle tree) before its
//   atomics, 7% faster in the path's order and 8% slower in a random order.
// - Convert (vconvert_kernel): the exact 96-bit sum ΣH·2^32 + ΣLo is
//   rounded once to f32 (a double-double from TwoSum, rounded to odd in
//   f64, then to nearest in f32) and scaled by 2^-K in two exact steps
//   (only a result in the subnormal range rounds again).
// Each output is then the f32 rounding of the exact sum of its terms, each
// term rounded to a multiple of 2^-K = 2^(L+e-94): every term whose binade
// lies within 70 - L binades of the largest's (45 at 30M terms) is exact,
// and a smaller one is off by at most 2^-(K+1).
// - Non-finite terms, as the reference's f32 segment_sum sums them: they
//   have no fixed-point image, so the scale pass skips them and the sum
//   pass sets a bit of their output's flag word (+inf, -inf, NaN; one
//   atomicOr each, no shared table) in place of adding them.  The
//   conversion makes an output NaN where it has a NaN term or both
//   infinities, +inf or -inf where it has only that one, and otherwise the
//   finite sum above, bit for bit what it is with no non-finite term.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define V_THREADS 256
#ifndef V_TABLE
#define V_TABLE 1024   // slots of the block's table of keys (a power of 2)
#endif
#ifndef V_FULL
#define V_FULL (V_TABLE * 3 / 4)   // keys at which the table takes no more
#endif
#ifndef V_PROBES
#define V_PROBES 4     // slots a term tries
#endif
#ifndef V_TILE
#define V_TILE 4       // particles a thread takes between flushes
#endif
#define FULL_MASK 0xffffffffu
#define NONFINITE_BITS 0x7f800000u
// bits of an output's flag word: the non-finite terms it sums
#define V_POS_INF 1u
#define V_NEG_INF 2u
#define V_NAN 4u

struct DepArgs {
  const float* w;            // (n, k) terms, or (n,) weights (k = 1)
  const float* q;            // (n,) charge multiplying each term, or nullptr
  const int* elem;           // (n,) parent element
  const uint8_t* active;     // (n,)
  const int* elem2verts;     // (n_elems, k) output keys, or nullptr: key = elem
  int k;
  int n_elems;
  int n_out;
  int log2_terms;            // L = ceil(log2(n·k))
  unsigned long long* acc;   // (n_out, 2) ΣH, ΣLo
  unsigned int* flags;       // (n_out,) the non-finite terms summed (V_* bits)
  unsigned int* max_bits;    // max finite |term| as f32 bits
  float* out;                // (n_out,)
  long long n;
};

// term j of particle i and its output key; false where the term is dropped
// (an inactive particle, a key outside [0, n_out))
__device__ __forceinline__ bool term_of(const DepArgs& a, long long i, int j, float* t,
                                        int* key) {
  if (!a.active[i]) return false;
  float v = a.w[i * a.k + j];
  if (a.q != nullptr) v = v * a.q[i];
  int kk;
  if (a.elem2verts != nullptr) {
    const int e = min(max(a.elem[i], 0), a.n_elems - 1);
    kk = a.elem2verts[(size_t)e * a.k + j];
  } else {
    kk = a.elem[i];
  }
  if (kk < 0 || kk >= a.n_out) return false;
  *t = v;
  *key = kk;
  return true;
}

// K = 94 - L - e with e the exponent bound of the largest |term| (bits mb):
// |term| < 2^e, e = max(biased exponent, 1) - 126
__device__ __forceinline__ int scale_of(unsigned mb, int log2_terms) {
  const int f = (int)(mb >> 23);
  return 94 - log2_terms - ((f > 1 ? f : 1) - 126);
}

__device__ __forceinline__ float pow2f(int e) {   // 2^e, -126 <= e <= 127
  return __int_as_float((e + 127) << 23);
}

__global__ void __launch_bounds__(V_THREADS) vmax_kernel(DepArgs a) {
  const long long stride = (long long)gridDim.x * V_THREADS;
  const long long first = (long long)blockIdx.x * V_THREADS + threadIdx.x;
  for (long long o = first; o < 2LL * a.n_out; o += stride) a.acc[o] = 0ull;
  for (long long o = first; o < a.n_out; o += stride) a.flags[o] = 0u;
  unsigned my = 0u;
  for (long long i = first; i < a.n; i += stride) {
    for (int j = 0; j < a.k; ++j) {
      float t;
      int key;
      if (term_of(a, i, j, &t, &key)) {
        const unsigned b = __float_as_uint(fabsf(t));
        if (b < NONFINITE_BITS) my = max(my, b);
      }
    }
  }
  my = __reduce_max_sync(FULL_MASK, my);
  if ((threadIdx.x & 31) == 0 && my != 0u) atomicMax(a.max_bits, my);
}

// term j of particle i as its fixed-point pair (H, Lo) at scale s, and its
// key; key = -1 where the term is dropped (or i >= n) or is not finite (its
// bit then set in its output's flag word)
__device__ __forceinline__ int fixed_term(const DepArgs& a, long long i, int j, double s,
                                          long long* h, long long* lo) {
  float t;
  int key;
  if (i >= a.n || !term_of(a, i, j, &t, &key)) return -1;
  if (__float_as_uint(fabsf(t)) >= NONFINITE_BITS) {
    atomicOr(a.flags + key, t != t ? V_NAN : (t > 0.0f ? V_POS_INF : V_NEG_INF));
    return -1;
  }
  const double y = rint((double)t * s);              // X, exact in f64
  const double hd = floor(y * 0x1p-32);           // H = floor(X / 2^32)
  *h = (long long)hd;
  *lo = (long long)(y - hd * 0x1p32);               // X - H·2^32
  return key;
}

__device__ __forceinline__ void add_pair(const DepArgs& a, int key, long long h,
                                         long long lo) {
  atomicAdd(a.acc + 2 * (size_t)key, (unsigned long long)h);
  atomicAdd(a.acc + 2 * (size_t)key + 1, (unsigned long long)lo);
}

// Equal keys summed inside the block: the block takes V_TILE·V_THREADS
// consecutive particles a round and adds each term into a shared-memory
// table keyed by output (open addressing from slot key mod V_TABLE, at most
// V_PROBES slots), then flushes the table with one pair of atomics a key.
// A term that finds no slot, or meets a table holding V_FULL keys (keys in
// random order fill it at once), adds its pair into L2 itself.
__global__ void __launch_bounds__(V_THREADS) vsum_kernel(DepArgs a) {
  __shared__ int tkey[V_TABLE];
  __shared__ unsigned long long th[V_TABLE], tl[V_TABLE];
  __shared__ int t_used;
  const unsigned mb = *a.max_bits;
  const double s = __longlong_as_double((long long)(scale_of(mb, a.log2_terms) + 1023)
                                        << 52);   // 2^K, exact
  for (int t = threadIdx.x; t < V_TABLE; t += V_THREADS) {
    tkey[t] = -1;
    th[t] = 0ull;
    tl[t] = 0ull;
  }
  if (threadIdx.x == 0) t_used = 0;
  __syncthreads();
  const long long tile = (long long)V_TILE * V_THREADS;
  for (long long base = (long long)blockIdx.x * tile; base < a.n;
       base += (long long)gridDim.x * tile) {      // block-uniform loop
    for (int u = 0; u < V_TILE; ++u) {
      const long long i = base + u * V_THREADS + threadIdx.x;
      for (int j = 0; j < a.k; ++j) {
        long long h = 0, lo = 0;
        const int key = fixed_term(a, i, j, s, &h, &lo);
        if (key < 0) continue;
        bool placed = false;
        if (*(volatile int*)&t_used < V_FULL) {
          int slot = key & (V_TABLE - 1);
          for (int p = 0; p < V_PROBES; ++p) {
            const int old = atomicCAS(&tkey[slot], -1, key);
            if (old == -1) atomicAdd(&t_used, 1);
            if (old == -1 || old == key) {
              atomicAdd(&th[slot], (unsigned long long)h);
              atomicAdd(&tl[slot], (unsigned long long)lo);
              placed = true;
              break;
            }
            slot = (slot + 1) & (V_TABLE - 1);
          }
        }
        if (!placed) add_pair(a, key, h, lo);
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < V_TABLE; t += V_THREADS) {
      const int key = tkey[t];
      if (key >= 0) {
        add_pair(a, key, (long long)th[t], (long long)tl[t]);
        tkey[t] = -1;
        th[t] = 0ull;
        tl[t] = 0ull;
      }
    }
    if (threadIdx.x == 0) t_used = 0;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(V_THREADS) vconvert_kernel(DepArgs a) {
  const unsigned mb = *a.max_bits;
  const int K = scale_of(mb, a.log2_terms);
  const int e1 = (-K) >> 1, e2 = -K - e1;    // 2^-K in two exact steps
  const long long stride = (long long)gridDim.x * V_THREADS;
  for (long long o = (long long)blockIdx.x * V_THREADS + threadIdx.x; o < a.n_out;
       o += stride) {
    const unsigned fl = a.flags[o];
    if (fl != 0u) {                           // the f32 sum of its infinities
      a.out[o] = (fl & V_NAN) || fl == (V_POS_INF | V_NEG_INF)
                     ? __int_as_float(0x7fc00000)
                     : __int_as_float(fl == V_POS_INF ? 0x7f800000 : 0xff800000);
      continue;
    }
    long long H = (long long)a.acc[2 * o];
    long long Ls = (long long)a.acc[2 * o + 1];
    H += Ls >> 32;                            // the sum is H·2^32 + Ls exactly
    Ls &= 0xffffffffLL;
    const double a1 = (double)H;              // rounded to nearest
    const long long t1 = H - (long long)a1;   // |t1| <= 2^9
    const double A = a1 * 0x1p32;             // exact
    const double C = (double)(t1 * 4294967296LL + Ls);   // exact, < 2^42
    double s = A + C;                         // TwoSum: s + err == A + C
    const double bb = s - A;
    const double err = (A - (s - bb)) + (C - bb);
    const long long bits = __double_as_longlong(s);
    if (err != 0.0 && (bits & 1LL) == 0)      // round to odd: one ulp toward err
      s = __longlong_as_double(bits + ((err > 0.0) == (s > 0.0) ? 1 : -1));
    float f = (float)s;                       // one rounding to nearest
    f = f * pow2f(e1);
    a.out[o] = f * pow2f(e2);
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

// w: (n, k) f32 terms (k = 1: weights); q: (n,) f32 or nullptr; elem (n,)
// i32; active (n,) bool; elem2verts: (n_elems, k) i32 keys or nullptr (key =
// elem); log2_terms = ceil(log2(n·k)), n·k < 2^31; acc: (n_out, 2) int64
// scratch; flags: (n_out,) u32 scratch; max_bits: one u32 the caller
// zeroes; out: (n_out,) f32.
extern "C" int pp_vdeposit(const float* w, const float* q, const int* elem,
                           const uint8_t* active, const int* elem2verts, int k,
                           int n_elems, int n_out, int log2_terms,
                           unsigned long long* acc, unsigned int* flags,
                           unsigned int* max_bits, float* out, long long n,
                           cudaStream_t stream) {
  if (k < 1 || n < 0 || n * k >= (1LL << 31) || n_out < 0 || log2_terms < 0 ||
      log2_terms > 31)
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaGetLastError();
  DepArgs a{w, q, elem, active, elem2verts, k, n_elems, n_out, log2_terms,
            acc, flags, max_bits, out, n};
  const long long cap = (long long)num_sms() * 8;
  long long bp = (n + V_THREADS - 1) / V_THREADS, bo = (2LL * n_out + V_THREADS - 1) / V_THREADS;
  long long b1 = bp > bo ? bp : bo;
  if (b1 > cap) b1 = cap;
  if (b1 < 1) b1 = 1;
  vmax_kernel<<<(unsigned)b1, V_THREADS, 0, stream>>>(a);
  if (bp > cap) bp = cap;
  if (bp > 0) vsum_kernel<<<(unsigned)bp, V_THREADS, 0, stream>>>(a);
  if (bo > cap) bo = cap;
  vconvert_kernel<<<(unsigned)bo, V_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
