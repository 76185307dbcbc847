// Kernels Y1, Y2 and Y3: the picparts step's routing and the balancer's
// selection.
//
//  Y1 route_*        Replaces (JAX reference) set_unsafe_procs,
//                    route_particles and route_decode
//                    (pumipic_tpu/parallel/migrate.py:74-151) and
//                    banded_decode (parallel/banded_route.py:73-125), with
//                    the step's glue around them (models/pseudo_xgcm.py:
//                    1099-1161, models/pseudo_push_and_search.py:430-449):
//                    one pass over the slots that writes each particle's
//                    destination rank, sbar (-1: none), non-core flag and
//                    the step's live mask active & (element >= 0), in one
//                    of three input forms:
//                      packed  route[max(elem, 0)] of pack_route's (E,) f32
//                              table (the walk arms, the one-rank arm);
//                      g2l     the (E_g, 2) i32 [local id | route] row at
//                              max(e_gl, 0) (the unbanded analytic 2D arm,
//                              the 3D Kuhn arm); also writes the local
//                              element and the global one where the local
//                              one is found;
//                      banded  the global element split into ring, sector
//                              and triangle, then banded_decode's formulas
//                              with the rank's six window scalars and the
//                              sbar runs (a later run overwrites an
//                              earlier one, as the reference's loop does);
//                              also writes the local and global elements.
//  Y2 balance_keys   Replaces repartition's weight keys (parallel/
//                    balancer.py:334-403): the staying weights' key, the
//                    forced migrations' key, the candidates' key of
//                    select_particles (sbar·2 + !noncore, or sbar without
//                    the non-core flag) and the immovable count (a block
//                    reduction, one atomic a block).  Kernel X1 counts and
//                    ranks the keys as before.
//  Y3 balance_select Replaces select_particles after the ranks
//                    (balancer.py:283-331): the core candidates' offset
//                    past their sbar's non-core ones, the plan's bound, the
//                    edge by an upper-bound search (searchsorted(...,
//                    right=True)) over the rank's flow prefix held in
//                    shared memory, clamped to the last edge, and the new
//                    destination.
//
// The TPU ran all of it as XLA elementwise code fused into the step's one
// program; the port ran each as 10-20 torch launches over every slot.
//
// Arithmetic.  The decodes stay in f32 as the reference computes them:
// floor(v / R), v - t·R, floor(t / 2), floor(sec·R / Ns), with IEEE
// division (-prec-div=true; never __fdividef or a reciprocal) and no
// contraction (-fmad=false), so each equals its plain version bit for bit
// on every input the plain version takes.  Integer division would give the
// same answers below pack_route's 2^24 bound, but not above it.
//
// What bounds them on an H100: device-memory bytes (each is a few
// comparisons a slot).  Y1 reads the element (4 B), the mask (1 B) and,
// for a live particle, its route word (4 B, a gather of a table that the
// L2 holds) or g2l row (8 B); writes dest and sbar (8 B), noncore and
// live (2 B) and, in the g2l and banded forms, the two elements (8 B).
// Y2 reads 10 B a slot and writes 12; Y3 reads the key and dest (8 B),
// a candidate's rank (4 B), and writes dest (4 B).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define Y_THREADS 256
// sbar runs the banded form takes (RouteParams stays under the 4 KB of a
// kernel's parameters)
#define Y1_MAX_RUNS 128
// edges of a rank Y3's shared memory holds (the flow prefix and the
// destinations: 48 KB)
#define Y3_MAX_EDGES 6144

enum { Y1_PACKED = 0, Y1_G2L = 1, Y1_BANDED = 2 };

// Y1's parameters, passed by value (the card keeps them in its constant
// bank); the banded form's scalars are f32 exact small integers
struct RouteParams {
  int me, num_ranks, n_sectors, n_runs;
  float a, w, w0, nsa, sa, sl;
  float run_lo[Y1_MAX_RUNS], run_hi[Y1_MAX_RUNS];
  int run_val[Y1_MAX_RUNS];
};

// route_decode's f32 arithmetic (pumipic_tpu/parallel/migrate.py:132)
__device__ __forceinline__ void y1_decode(float v, bool ok, int me, int R, int* dest,
                                          int* sbar, bool* noncore) {
  const float Rf = (float)R;
  const float t = floorf(__fdiv_rn(v, Rf));
  const float owner_f = __fsub_rn(v, __fmul_rn(t, Rf));
  const float half = floorf(__fdiv_rn(t, 2.0f));
  const bool safe = __fsub_rn(t, __fmul_rn(half, 2.0f)) > 0.5f;
  const float me_f = (float)me;
  *dest = (int)((ok && !safe) ? owner_f : me_f);
  *sbar = ok ? (int)half - 2 : -1;
  *noncore = ok && owner_f != me_f;
}

__global__ void __launch_bounds__(Y_THREADS)
    y1_packed(const float* __restrict__ route, const int* __restrict__ elem,
              const bool* __restrict__ active, long long n, int me, int R,
              int* __restrict__ dest, int* __restrict__ sbar, bool* __restrict__ noncore,
              bool* __restrict__ live) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int e = elem[i];
  const bool ok = active[i] && e >= 0;
  // a particle that is not live decodes to (me, -1, false) whatever its
  // route: its word is not read
  const float v = ok ? __ldg(route + e) : 0.0f;
  int d, s;
  bool nc;
  y1_decode(v, ok, me, R, &d, &s, &nc);
  dest[i] = d;
  sbar[i] = s;
  noncore[i] = nc;
  live[i] = ok;
}

__global__ void __launch_bounds__(Y_THREADS)
    y1_g2l(const int2* __restrict__ g2l, const int* __restrict__ e_gl,
           const bool* __restrict__ active, long long n, int me, int R,
           int* __restrict__ dest, int* __restrict__ sbar, bool* __restrict__ noncore,
           bool* __restrict__ live, int* __restrict__ elem, int* __restrict__ gelem) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int eg = e_gl[i];
  const int2 row = eg >= 0 ? __ldg(g2l + eg) : make_int2(-1, 0);
  const int lid = row.x;
  const bool ok = active[i] && lid >= 0;
  int d, s;
  bool nc;
  y1_decode((float)row.y, ok, me, R, &d, &s, &nc);
  dest[i] = d;
  sbar[i] = s;
  noncore[i] = nc;
  live[i] = ok;
  elem[i] = lid;
  if (gelem != nullptr) gelem[i] = lid >= 0 ? eg : -1;
}

__global__ void __launch_bounds__(Y_THREADS)
    y1_banded(const __grid_constant__ RouteParams p, const int* __restrict__ e_gl,
              const bool* __restrict__ active, long long n,
              int* __restrict__ dest, int* __restrict__ sbar, bool* __restrict__ noncore,
              bool* __restrict__ live, int* __restrict__ elem, int* __restrict__ gelem) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int eg = e_gl[i];
  const int e = eg > 0 ? eg : 0;
  const int Ns = p.n_sectors;
  const float Nsf = (float)Ns;
  const float ring_f = (float)(e / (2 * Ns));
  const float sec_f = (float)((e / 2) % Ns);
  const float tri_f = (float)(e & 1);
  // banded_decode (pumipic_tpu/parallel/banded_route.py:73), op for op
  float pos = __fsub_rn(sec_f, p.a);
  pos = pos < 0.0f ? __fadd_rn(pos, Nsf) : pos;
  const bool in_win = pos < p.w;
  const float gidx = pos >= p.nsa ? __fsub_rn(__fadd_rn(pos, p.a), Nsf) : __fadd_rn(pos, p.w0);
  const float lid_f = __fadd_rn(__fadd_rn(__fmul_rn(ring_f, __fmul_rn(2.0f, p.w)),
                                          __fmul_rn(gidx, 2.0f)), tri_f);
  const bool ok = active[i] && eg >= 0 && in_win;
  const int lid = ok ? (int)lid_f : -1;
  const float owner_f = floorf(__fdiv_rn(__fmul_rn(sec_f, (float)p.num_ranks), Nsf));
  float dd = __fsub_rn(sec_f, p.sa);
  dd = dd < 0.0f ? __fadd_rn(dd, Nsf) : dd;
  const bool safe = dd < p.sl;
  const float me_f = (float)p.me;
  int s = -1;
  for (int r = 0; r < p.n_runs; ++r)
    if (sec_f >= p.run_lo[r] && sec_f < p.run_hi[r]) s = p.run_val[r];
  dest[i] = (int)((ok && !safe) ? owner_f : me_f);
  sbar[i] = ok ? s : -1;
  noncore[i] = ok && owner_f != me_f;
  live[i] = lid >= 0;
  elem[i] = lid;
  if (gelem != nullptr) gelem[i] = lid >= 0 ? eg : -1;
}

static int y_blocks(long long n) { return (int)((n + Y_THREADS - 1) / Y_THREADS); }

// form: Y1_PACKED (table: route (E,) f32, elem_in: the local elements) or
// Y1_G2L (table: (E_g, 2) i32 rows, elem_in: the global elements) or
// Y1_BANDED (params: a host RouteParams, elem_in: the global elements);
// elem_out and gelem (may be null) only in the g2l and banded forms
extern "C" int pp_route_decode(int form, const void* table, const void* params,
                               const int* elem_in, const bool* active, long long n,
                               int me, int num_ranks, int* dest, int* sbar, bool* noncore,
                               bool* live, int* elem_out, int* gelem, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (form == Y1_PACKED) {
    y1_packed<<<y_blocks(n), Y_THREADS, 0, stream>>>(
        static_cast<const float*>(table), elem_in, active, n, me, num_ranks, dest, sbar,
        noncore, live);
  } else if (form == Y1_G2L) {
    if (elem_out == nullptr) return (int)cudaErrorInvalidValue;
    y1_g2l<<<y_blocks(n), Y_THREADS, 0, stream>>>(
        static_cast<const int2*>(table), elem_in, active, n, me, num_ranks, dest, sbar,
        noncore, live, elem_out, gelem);
  } else if (form == Y1_BANDED) {
    RouteParams p;
    memcpy(&p, params, sizeof(RouteParams));
    if (elem_out == nullptr || p.n_sectors < 1 || p.n_runs < 0 || p.n_runs > Y1_MAX_RUNS)
      return (int)cudaErrorInvalidValue;
    y1_banded<<<y_blocks(n), Y_THREADS, 0, stream>>>(p, elem_in, active, n, dest, sbar,
                                                     noncore, live, elem_out, gelem);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int pp_route_params_bytes() { return (int)sizeof(RouteParams); }

// ---------------------------------------------------------------------------
// Y2: the balancer's keys
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(Y_THREADS)
    y2_keys(const int* __restrict__ dest, const int* __restrict__ sbar,
            const bool* __restrict__ live, const bool* __restrict__ noncore, long long n,
            int me, int S, int R, int* __restrict__ w_key, int* __restrict__ f_key,
            int* __restrict__ c_key, int* __restrict__ immovable) {
  __shared__ int s_count;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  int count = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int d = dest[i];
    const int s = sbar[i];
    const bool a = live[i];
    const bool staying = a && d == me;
    const bool cand = staying && s >= 0;
    w_key[i] = cand ? s : S;
    f_key[i] = (a && d != me) ? d : R;
    if (noncore != nullptr)
      c_key[i] = cand ? s * 2 + (noncore[i] ? 0 : 1) : 2 * S;
    else
      c_key[i] = cand ? s : S;
    count += (staying && s < 0) ? 1 : 0;
  }
  // every thread of the block reaches the reduction
  count = __reduce_add_sync(0xffffffffu, count);
  if ((threadIdx.x & 31) == 0 && count != 0) atomicAdd(&s_count, count);
  __syncthreads();
  if (threadIdx.x == 0 && s_count != 0) atomicAdd(immovable, s_count);
}

static int y_resident_blocks(long long n, int per_sm) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  const long long want = (n + Y_THREADS - 1) / Y_THREADS;
  const long long cap = (long long)sms * per_sm;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

// noncore may be null (c_key then equals w_key); immovable: one int32,
// zeroed here
extern "C" int pp_balance_keys(const int* dest, const int* sbar, const bool* live,
                               const bool* noncore, long long n, int me, int S, int R,
                               int* w_key, int* f_key, int* c_key, int* immovable,
                               cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(immovable, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    y2_keys<<<y_resident_blocks(n, 8), Y_THREADS, 0, stream>>>(
        dest, sbar, live, noncore, n, me, S, R, w_key, f_key, c_key, immovable);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Y3: the selection
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(Y_THREADS)
    y3_select(const int* __restrict__ key, const int* __restrict__ rank,
              const int* __restrict__ counts, const int* __restrict__ dest, long long n,
              int S, int noncore_form, int n_edges, const int* __restrict__ e_dst,
              const int* __restrict__ cumsum, const int* __restrict__ sbar_base,
              const int* __restrict__ sbar_total, int* __restrict__ out) {
  extern __shared__ int y3_smem[];
  int* s_cum = y3_smem;
  int* s_dst = y3_smem + n_edges;
  for (int j = threadIdx.x; j < n_edges; j += blockDim.x) {
    s_cum[j] = cumsum[j];
    s_dst[j] = e_dst[j];
  }
  __syncthreads();
  const int n_keys = noncore_form ? 2 * S : S;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int k = key[i];
    int d = dest[i];
    if (k < n_keys) {
      const int sb = noncore_form ? k >> 1 : k;
      int r = rank[i];
      // a core candidate (key 2s + 1) comes after its sbar's non-core ones
      if (noncore_form && (k & 1)) r = (int)((unsigned)r + (unsigned)__ldg(counts + 2 * sb));
      if (r < __ldg(sbar_total + sb)) {
        const int gpos = (int)((unsigned)__ldg(sbar_base + sb) + (unsigned)r);
        // the first edge whose prefix exceeds gpos (searchsorted, right)
        int lo = 0, hi = n_edges;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_cum[mid] <= gpos) lo = mid + 1;
          else hi = mid;
        }
        const int edge = lo < n_edges - 1 ? lo : n_edges - 1;
        const int c = s_dst[edge];
        if (c >= 0) d = c;
      }
    }
    out[i] = d;
  }
}

extern "C" int pp_balance_select(const int* key, const int* rank, const int* counts,
                                 const int* dest, long long n, int S, int noncore_form,
                                 int n_edges, const int* e_dst, const int* cumsum,
                                 const int* sbar_base, const int* sbar_total, int* out,
                                 cudaStream_t stream) {
  if (n_edges < 1 || n_edges > Y3_MAX_EDGES || S < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const size_t smem = 2 * (size_t)n_edges * sizeof(int);
    y3_select<<<y_resident_blocks(n, 8), Y_THREADS, smem, stream>>>(
        key, rank, counts, dest, n, S, noncore_form, n_edges, e_dst, cumsum, sbar_base,
        sbar_total, out);
  }
  return (int)cudaGetLastError();
}
