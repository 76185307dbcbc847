// Kernel O: the owner reduction of a per-entity field over the picparts'
// copies (reduceCommArray).
//
// Replaces the JAX package's jitted reduce_comm_array
// (pumipic_tpu/parallel/reduce.py:52-107: the row gathers, segment_sum /
// segment_max / segment_min over the R·K received rows, the fan-out's
// .at[].set), which the port ran as torch gathers, one index_add_ per
// source rank and an index_put.  Three functions, with a collective
// between each two:
//
//  gather   out[j] = field[ids[j]], or fill where ids[j] is -1 (the send
//           side's copies before the fan-in, the owner's rows before the
//           fan-out of BCAST).  The picparts step's SUM takes no gather:
//           kernel D writes those rows as it writes the field
//           (deposit.cu's send rows), so the step launches O twice;
//  fan_in   one thread per owned entity and lane: it folds the copies the
//           other ranks sent in source-rank order (a CSR built once per
//           picpart from recv_ids: entity -> received rows), starting from
//           the neutral value, combines the result with its own value
//           (SUM: field + sum; MAX/MIN: the NaN-propagating max/min), and
//           writes the reduced value both to the output field and to every
//           row that the fan-out sends back (the fan-out's gather, fused);
//  fan_out  in place, one thread per (row, lane) of the R·K rows: a row
//           that names a copy owned elsewhere (send_ids) writes the value
//           its owner sent back over the copy; the other entities keep
//           theirs.  The caller gives it a field it owns (the fan-in's
//           output), never one it was handed.
//
// Values are f32 or i32 moved as 32-bit words; only fan_in does
// arithmetic, in the plain version's order (0 + c_0 + c_1 + ..., then
// field + that, each rounded: -fmad=false keeps the adds apart), so the
// results equal the plain version bit for bit.  MAX and MIN follow
// torch.maximum / scatter_reduce(amax)'s rule that a NaN wins (fmaxf would
// drop it).  What bounds them: bytes (each row read once, each output
// written once; a few hundred kB at the picparts' sizes), so at these sizes
// the launch itself: the step's gain is the launch it no longer makes.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define O_THREADS 256

enum { O_SUM = 0, O_MAX = 1, O_MIN = 2 };

__global__ void __launch_bounds__(O_THREADS)
    o_gather(const uint32_t* __restrict__ field, int width, const int* __restrict__ ids,
             long long n_ids, uint32_t fill, uint32_t* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_ids * width) return;
  const long long j = p / width;
  const int l = (int)(p - j * width);
  const int e = ids[j];
  out[p] = e >= 0 ? field[(long long)e * width + l] : fill;
}

template <typename T>
__device__ __forceinline__ T o_combine(int op, T a, T b);

template <>
__device__ __forceinline__ float o_combine<float>(int op, float a, float b) {
  if (op == O_SUM) return __fadd_rn(a, b);
  if (a != a) return a;
  if (b != b) return b;
  if (op == O_MAX) return a < b ? b : a;       // a tie keeps a, as torch.maximum
  return b < a ? b : a;
}

template <>
__device__ __forceinline__ int o_combine<int>(int op, int a, int b) {
  if (op == O_SUM) return (int)((unsigned)a + (unsigned)b);   // wraps, as torch's
  if (op == O_MAX) return a > b ? a : b;
  return a < b ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(O_THREADS)
    o_fan_in(const T* __restrict__ field, const T* __restrict__ recv, int width, int n_ent,
             const int* __restrict__ offsets, const int* __restrict__ rows, int op, T neutral,
             T* __restrict__ out, T* __restrict__ back) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)n_ent * width) return;
  const int v = (int)(p / width);
  const int l = (int)(p - (long long)v * width);
  T acc = neutral;
  const int lo = offsets[v], hi = offsets[v + 1];
  for (int q = lo; q < hi; ++q) acc = o_combine<T>(op, acc, recv[(long long)rows[q] * width + l]);
  const T r = o_combine<T>(op, field[p], acc);
  out[p] = r;
  for (int q = lo; q < hi; ++q) back[(long long)rows[q] * width + l] = r;
}

__global__ void __launch_bounds__(O_THREADS)
    o_fan_out(const uint32_t* __restrict__ back, int width, const int* __restrict__ send_ids,
              long long n_rows, uint32_t* __restrict__ field) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_rows * width) return;
  const long long j = p / width;
  const int e = send_ids[j];
  if (e >= 0) field[(long long)e * width + (p - j * width)] = back[p];
}

static unsigned o_blocks(long long n) {
  return (unsigned)((n + O_THREADS - 1) / O_THREADS);
}

extern "C" int pp_owner_gather(const void* field, int width, const int* ids, long long n_ids,
                               unsigned fill_bits, void* out, cudaStream_t stream) {
  if (width < 1) return (int)cudaErrorInvalidValue;
  if (n_ids > 0)
    o_gather<<<o_blocks(n_ids * width), O_THREADS, 0, stream>>>(
        static_cast<const uint32_t*>(field), width, ids, n_ids, fill_bits,
        static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// is_int: i32 values, else f32; neutral_bits: the op's neutral value's bits;
// back: the (rows, width) fan-out rows, zero where no entity is named
extern "C" int pp_owner_fan_in(const void* field, const void* recv, int width, int n_ent,
                               const int* offsets, const int* rows, int op, int is_int,
                               unsigned neutral_bits, void* out, void* back,
                               cudaStream_t stream) {
  if (width < 1 || op < O_SUM || op > O_MIN) return (int)cudaErrorInvalidValue;
  if (n_ent > 0) {
    if (is_int) {
      o_fan_in<int><<<o_blocks((long long)n_ent * width), O_THREADS, 0, stream>>>(
          static_cast<const int*>(field), static_cast<const int*>(recv), width, n_ent, offsets,
          rows, op, (int)neutral_bits, static_cast<int*>(out), static_cast<int*>(back));
    } else {
      float neutral;
      memcpy(&neutral, &neutral_bits, sizeof(float));
      o_fan_in<float><<<o_blocks((long long)n_ent * width), O_THREADS, 0, stream>>>(
          static_cast<const float*>(field), static_cast<const float*>(recv), width, n_ent,
          offsets, rows, op, neutral, static_cast<float*>(out), static_cast<float*>(back));
    }
  }
  return (int)cudaGetLastError();
}

// in place: field's copies named in send_ids (n_rows) take their rows of
// back; each entity is named at most once
extern "C" int pp_owner_fan_out(const void* back, int width, const int* send_ids,
                                long long n_rows, void* field, cudaStream_t stream) {
  if (width < 1) return (int)cudaErrorInvalidValue;
  if (n_rows > 0)
    o_fan_out<<<o_blocks(n_rows * width), O_THREADS, 0, stream>>>(
        static_cast<const uint32_t*>(back), width, send_ids, n_rows,
        static_cast<uint32_t*>(field));
  return (int)cudaGetLastError();
}
