// Bucket gather-multiply-reduce over the slot-major weight buffer.
//
// Replaces the Pallas TPU kernel feynmandiagram_tpu/ops/kernels.py:82
// (bucket_gather_reduce, body _bucket_kernel), generalised from one operand
// per term to n_op <= 4, so that it also computes the FusedBucket of
// sum_mode='fused' (feynmandiagram_tpu/ops/evaluator.py:88-106):
//
//     w[start + c, b] = sum_a fac[a, c] * prod_{k < n_op} w[idx[k, a, c], b]
//
// w is [num_slots, batch], row-major; idx is int32 [n_op, arity, count];
// fac is [arity, count] in w's type.  The result is written straight into
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
// element is used once.  Products use __fmul_rn / __dmul_rn so that the
// compiler cannot contract them into an FMA with the sum, which keeps the
// term order and rounding of the plain PyTorch version, and of the Kahan
// recurrence of feynmandiagram_tpu/ops/evaluator.py:36-51.
//
// Built with nvcc into a shared library with a plain C interface (see
// feynmandiagram_tpu_torch/ops/kernels.py), loaded through ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

constexpr int kThreads = 256;

template <typename T, int N_OP, bool KAHAN>
__global__ void bucket_gather_reduce_kernel(T* w, const int32_t* idx, const T* fac,
                                            int arity, int count, int64_t batch,
                                            int64_t start) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int64_t plane = static_cast<int64_t>(arity) * count;  // idx stride of k
  for (int c = blockIdx.y; c < count; c += gridDim.y) {
    T sum = T(0);
    T comp = T(0);
    for (int a = 0; a < arity; ++a) {
      const int64_t e = static_cast<int64_t>(a) * count + c;
      T term = mul_rn(w[static_cast<int64_t>(idx[e]) * batch + b], fac[e]);
#pragma unroll
      for (int k = 1; k < N_OP; ++k) {
        term = mul_rn(term, w[static_cast<int64_t>(idx[k * plane + e]) * batch + b]);
      }
      if (a == 0) {
        sum = term;
      } else if (KAHAN) {
        const T y = term - comp;
        const T t = sum + y;
        comp = (t - sum) - y;
        sum = t;
      } else {
        sum = sum + term;
      }
    }
    w[(start + c) * batch + b] = sum;
  }
}

template <typename T, bool KAHAN>
cudaError_t launch_t(void* w, const void* idx, const void* fac, int n_op, int arity,
                     int count, int64_t batch, int64_t start, cudaStream_t stream) {
  const dim3 block(kThreads);
  const dim3 grid(static_cast<unsigned>((batch + kThreads - 1) / kThreads),
                  static_cast<unsigned>(count < 65535 ? count : 65535));
  T* wp = static_cast<T*>(w);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const T* fp = static_cast<const T*>(fac);
  switch (n_op) {
    case 1:
      bucket_gather_reduce_kernel<T, 1, KAHAN><<<grid, block, 0, stream>>>(
          wp, ip, fp, arity, count, batch, start);
      break;
    case 2:
      bucket_gather_reduce_kernel<T, 2, KAHAN><<<grid, block, 0, stream>>>(
          wp, ip, fp, arity, count, batch, start);
      break;
    case 3:
      bucket_gather_reduce_kernel<T, 3, KAHAN><<<grid, block, 0, stream>>>(
          wp, ip, fp, arity, count, batch, start);
      break;
    case 4:
      bucket_gather_reduce_kernel<T, 4, KAHAN><<<grid, block, 0, stream>>>(
          wp, ip, fp, arity, count, batch, start);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  is_double selects
// float64 over float32; compensated selects the Kahan recurrence.
extern "C" int fd_bucket_gather_reduce(void* w, const void* idx, const void* fac,
                                       int n_op, int arity, int count,
                                       long long batch, long long start,
                                       int is_double, int compensated,
                                       void* stream) {
  if (arity < 1 || count < 1 || batch < 1 || start < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_double) {
    err = compensated ? launch_t<double, true>(w, idx, fac, n_op, arity, count, batch, start, s)
                      : launch_t<double, false>(w, idx, fac, n_op, arity, count, batch, start, s);
  } else {
    err = compensated ? launch_t<float, true>(w, idx, fac, n_op, arity, count, batch, start, s)
                      : launch_t<float, false>(w, idx, fac, n_op, arity, count, batch, start, s);
  }
  return static_cast<int>(err);
}
