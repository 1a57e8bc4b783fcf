// Bucket gather-multiply-reduce over the slot-major weight buffer.
//
// Replaces the Pallas TPU kernel feynmandiagram_tpu/ops/kernels.py:82
// (bucket_gather_reduce, body _bucket_kernel), generalised from one operand
// per term to n_op <= 4, so that it also computes the FusedBucket of
// sum_mode='fused' (feynmandiagram_tpu/ops/evaluator.py:88-106):
//
//     w[start + c, b] = sum_a fac[a, c] * prod_{k < n_op} w[idx[k, a, c], b]
//
// w is [num_slots, batch], row-major, in a storage type T; idx is int32
// [n_op, arity, count]; fac is [arity, count] in an accumulation type A.
// Gathered elements are widened from T to A, products and sums are taken in
// A, and the sum is rounded once to T on store.  The (T, A) pairs are those
// the JAX evaluator runs: (f32, f32), (f64, f64), (f32, f64) and
// (bf16, f32), the last its half-width-buffer mode
// (feynmandiagram_tpu/ops/evaluator.py:224-239).  The result is written straight into
// rows start .. start+count of w (the TPU kernel returned a block that the
// caller copied in with dynamic_update_slice).  The caller guarantees that
// no idx entry lies in [start, start + count): w is read and written by the
// same launch, so it carries no __restrict__.
//
// What bounds it on an H100: gathered-row bytes.  Each output row reads
// n_op * arity rows of `batch` elements and does ~2 flops per element read,
// far below the card's ridge point, so the kernel is a memory gather.  The
// simple design keeps every gathered row read coalesced: one thread per
// (c, b), threads of a block along the batch, so a warp reads 32 neighbouring
// elements of one row.  idx and fac are the same for every thread of a
// block (one c per blockIdx.y), so their loads are warp-uniform broadcasts
// served from cache.  Nothing is staged in shared memory: each gathered
// element is used once.  Products use __fmul_rn / __dmul_rn in A so that the
// compiler cannot contract them into an FMA with the sum, which keeps the
// term order and rounding of the plain PyTorch version, and of the Kahan
// recurrence of feynmandiagram_tpu/ops/evaluator.py:36-51.  Widening
// (bf16 -> f32, f32 -> f64) is exact; narrowing rounds to nearest even
// (__float2bfloat16_rn, __double2float_rn), as PyTorch's .to() does.
//
// Built with nvcc into a shared library with a plain C interface (see
// feynmandiagram_tpu_torch/ops/kernels.py), loaded through ctypes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename A> __device__ __forceinline__ A widen(float x) { return static_cast<A>(x); }
template <typename A> __device__ __forceinline__ A widen(double x) { return static_cast<A>(x); }
template <typename A> __device__ __forceinline__ A widen(__nv_bfloat16 x) {
  return static_cast<A>(__bfloat162float(x));
}

__device__ __forceinline__ void narrow_to(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow_to(double* p, double v) { *p = v; }
__device__ __forceinline__ void narrow_to(float* p, double v) { *p = __double2float_rn(v); }
__device__ __forceinline__ void narrow_to(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// type codes of the C entry point
enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2 };

constexpr int kThreads = 256;

template <typename T, typename A, int N_OP, bool KAHAN>
__global__ void bucket_gather_reduce_kernel(T* w, const int32_t* idx, const A* fac,
                                            int arity, int count, int64_t batch,
                                            int64_t start) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int64_t plane = static_cast<int64_t>(arity) * count;  // idx stride of k
  for (int c = blockIdx.y; c < count; c += gridDim.y) {
    A sum = A(0);
    A comp = A(0);
    for (int a = 0; a < arity; ++a) {
      const int64_t e = static_cast<int64_t>(a) * count + c;
      A term = mul_rn(widen<A>(w[static_cast<int64_t>(idx[e]) * batch + b]), fac[e]);
#pragma unroll
      for (int k = 1; k < N_OP; ++k) {
        term = mul_rn(term, widen<A>(w[static_cast<int64_t>(idx[k * plane + e]) * batch + b]));
      }
      if (a == 0) {
        sum = term;
      } else if (KAHAN) {
        const A y = term - comp;
        const A t = sum + y;
        comp = (t - sum) - y;
        sum = t;
      } else {
        sum = sum + term;
      }
    }
    narrow_to(&w[(start + c) * batch + b], sum);
  }
}

template <typename T, typename A, bool KAHAN>
cudaError_t launch_t(void* w, const void* idx, const void* fac, int n_op, int arity,
                     int count, int64_t batch, int64_t start, cudaStream_t stream) {
  const dim3 block(kThreads);
  const dim3 grid(static_cast<unsigned>((batch + kThreads - 1) / kThreads),
                  static_cast<unsigned>(count < 65535 ? count : 65535));
  T* wp = static_cast<T*>(w);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const A* fp = static_cast<const A*>(fac);
  switch (n_op) {
    case 1:
      bucket_gather_reduce_kernel<T, A, 1, KAHAN><<<grid, block, 0, stream>>>(
          wp, ip, fp, arity, count, batch, start);
      break;
    case 2:
      bucket_gather_reduce_kernel<T, A, 2, KAHAN><<<grid, block, 0, stream>>>(
          wp, ip, fp, arity, count, batch, start);
      break;
    case 3:
      bucket_gather_reduce_kernel<T, A, 3, KAHAN><<<grid, block, 0, stream>>>(
          wp, ip, fp, arity, count, batch, start);
      break;
    case 4:
      bucket_gather_reduce_kernel<T, A, 4, KAHAN><<<grid, block, 0, stream>>>(
          wp, ip, fp, arity, count, batch, start);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename A>
cudaError_t launch_ta(void* w, const void* idx, const void* fac, int n_op, int arity,
                      int count, int64_t batch, int64_t start, int compensated,
                      cudaStream_t stream) {
  return compensated
             ? launch_t<T, A, true>(w, idx, fac, n_op, arity, count, batch, start, stream)
             : launch_t<T, A, false>(w, idx, fac, n_op, arity, count, batch, start, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  storage and acc are
// TypeCodes of w's and fac's types, one of the four pairs above;
// compensated selects the Kahan recurrence.
extern "C" int fd_bucket_gather_reduce(void* w, const void* idx, const void* fac,
                                       int n_op, int arity, int count,
                                       long long batch, long long start,
                                       int storage, int acc, int compensated,
                                       void* stream) {
  if (arity < 1 || count < 1 || batch < 1 || start < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (storage == kF32 && acc == kF32) {
    err = launch_ta<float, float>(w, idx, fac, n_op, arity, count, batch, start, compensated, s);
  } else if (storage == kF64 && acc == kF64) {
    err = launch_ta<double, double>(w, idx, fac, n_op, arity, count, batch, start, compensated, s);
  } else if (storage == kF32 && acc == kF64) {
    err = launch_ta<float, double>(w, idx, fac, n_op, arity, count, batch, start, compensated, s);
  } else if (storage == kBF16 && acc == kF32) {
    err = launch_ta<__nv_bfloat16, float>(w, idx, fac, n_op, arity, count, batch, start,
                                          compensated, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
