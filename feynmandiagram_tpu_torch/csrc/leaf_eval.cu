// The leaf phase of a Monte-Carlo pass: sampled loop momenta and times ->
// the value of every leaf of the lowered graph, in two launches.
//
// Replaces no Pallas kernel: it replaces the loop fusion that XLA makes of
// the jnp chain of feynmandiagram_tpu/ops/leaf_eval.py:119-155 under
// jax.jit (the LoopPool product, |q|^2, and one physics call per
// (leaf type, derivative order) group, scattered into the leaf buffer).
// Run op by op in PyTorch, that chain materialised a [rows, batch]
// temporary per op, in float64, and cost more device time than the graph
// phase's kernel.
//
// 1. leaf_prep, a thread per (row, column) over n_basis + n_pairs rows,
//    reading varK and varT in their own type (float32 or float64) and
//    widening or rounding each element to C as it is loaded:
//    - a basis row n: loops[d] = sum_l basis[n, l] * varK[d, l, b] (l in
//      order), q2 = sum_d loops[d]^2 (d in order), eps = q2 - kF^2 and
//      sp = softplus(-beta * eps), softplus(x) = max(x, 0) +
//      log1p(exp(-|x|)) (jax.nn.softplus, not torch's thresholded one);
//    - a pair p of times: tau = varT[out_p, b] - varT[in_p, b], cut to
//      -TAU_CUTOFF where |tau| < TAU_CUTOFF, sign = +-1 and tau1 = tau or
//      tau + beta (models/free_fermion.py::green_tau_parts).
//    It writes the scratch table [3 * n_basis + 3 * n_pairs, batch]: q2,
//    eps, sp by basis row, then sign, tau1, tau by pair.
// 2. leaf_values, a warp per leaf row (so the branch on the row's kind and
//    order is uniform across the warp), V columns a thread:
//    - kind 0, a row of no group: 1;
//    - kind 1, a bare propagator: sign * exp(-(eps * tau1 + sp));
//    - kind 2, a G counterterm of order 1..5: (-1)^n / n! d^n G / d eps^n,
//      the Bell recursion of models/free_fermion.py::green_derive_tower on
//      (tau, eps), with the softplus derivatives' polynomials in s, sbar
//      handed over by the host (`Polys`);
//    - kind 3 / 4, an interaction counterterm of order n in the
//      'lambda_power' / 'taylor' convention (models/yukawa.py):
//      8 pi inv (lam inv)^n / (-1)^n 8 pi inv^(n+1), inv = 1 / (q2 + lam).
//    Values are computed in the compute type C and rounded once to the
//    storage type T, then stored 16 bytes a thread into row r of `out`
//    (the leaf rows of the weight buffer) where out's base and row pitch
//    are 16-byte aligned; else one element a thread.
//
// Rounding is that of the plain PyTorch version (ops/leaf_eval.py), which
// repeats these operations in this order: every product, sum and quotient
// is an explicit __fmul_rn / __dadd_rn / ... so that nvcc contracts none
// into an FMA; exp and log1p are CUDA's, which PyTorch's elementwise ops
// call too.  Narrowing rounds to nearest even as PyTorch's .to() does
// (double -> bfloat16 through float, as c10::BFloat16 converts).
//
// What bounds it on an H100: bytes.  A leaf element costs a handful of
// operations (a G counterterm of order 5 about a hundred), far below the
// ridge point; the phase must read varK and varT and write the leaf rows.
// The scratch table (order-4 Gamma4 at batch 4096 in float64: 35 MB) lies
// in the 50 MB L2 between the two launches, and each leaf row reads its
// basis row and its pair from there.
//
// Built with nvcc into a shared library with a plain C interface (see
// feynmandiagram_tpu_torch/ops/leaf_eval.py), loaded through ctypes.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2 };
enum Kind { kOne = 0, kG0 = 1, kGTower = 2, kVLambda = 3, kVTaylor = 4 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOrder = 5;       // models/free_fermion.py::MAX_DERIV_ORDER
constexpr int kMaxTerms = 4;       // terms of softplus^(k), k <= 5
constexpr int kMaxGrid = 65535;    // blocks along y

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg1p(float x) { return log1pf(x); }
__device__ __forceinline__ double lg1p(double x) { return log1p(x); }

__device__ __forceinline__ void narrow_to(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow_to(double* p, double v) { *p = v; }
__device__ __forceinline__ void narrow_to(float* p, double v) { *p = __double2float_rn(v); }
__device__ __forceinline__ void narrow_to(double* p, float v) { *p = static_cast<double>(v); }
__device__ __forceinline__ void narrow_to(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void narrow_to(__nv_bfloat16* p, double v) {
  *p = __float2bfloat16_rn(__double2float_rn(v));
}

// softplus(x) = clamp_min(x, 0) + log1p(exp(-|x|))
template <typename C> __device__ __forceinline__ C softplus(C x) {
  const C m = x > C(0) ? x : C(0);
  return add(m, lg1p(ex(-fabs(x))));
}

// ---------------------------------------------------------------------------
// leaf_prep

struct PrepArgs {
  const void* basis;        // [n_basis, n_loop], C
  const void* varK;         // [dim, n_loop, batch], I
  const void* varT;         // [n_tau, batch], I
  const int32_t* pair_in;   // [n_pairs], 0-based rows of varT
  const int32_t* pair_out;
  void* scratch;            // [3 n_basis + 3 n_pairs, batch], C
  int n_basis, n_pairs, n_loop, dim;
  int64_t batch;
  double kF2, beta, tau_cutoff;
};

template <typename C, typename I>
__global__ void __launch_bounds__(kThreads) leaf_prep_kernel(PrepArgs a) {
  const C* basis = static_cast<const C*>(a.basis);
  const I* varK = static_cast<const I*>(a.varK);
  const I* varT = static_cast<const I*>(a.varT);
  C* scratch = static_cast<C*>(a.scratch);
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= a.batch) return;
  const int64_t nb = a.n_basis, B = a.batch;
  const int64_t rows = nb + a.n_pairs;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    if (row < nb) {
      const C* bn = basis + row * a.n_loop;
      C q2 = C(0);
      for (int d = 0; d < a.dim; ++d) {
        const I* vk = varK + static_cast<int64_t>(d) * a.n_loop * B + col;
        C acc = mul(bn[0], C(vk[0]));
        for (int l = 1; l < a.n_loop; ++l) acc = add(acc, mul(bn[l], C(vk[l * B])));
        q2 = d == 0 ? mul(acc, acc) : add(q2, mul(acc, acc));
      }
      scratch[row * B + col] = q2;
      if (a.n_pairs > 0) {   // propagators present: their momentum parts
        const C eps = sub(q2, C(a.kF2));
        scratch[(nb + row) * B + col] = eps;
        scratch[(2 * nb + row) * B + col] = softplus(mul(C(-a.beta), eps));
      }
    } else {
      const int64_t p = row - nb;
      C tau = sub(C(varT[a.pair_out[p] * B + col]), C(varT[a.pair_in[p] * B + col]));
      if (fabs(tau) < C(a.tau_cutoff)) tau = C(-a.tau_cutoff);
      const bool pos = tau > C(0);
      const int64_t base = 3 * nb + p;
      scratch[base * B + col] = pos ? C(1) : C(-1);
      scratch[(base + a.n_pairs) * B + col] = pos ? tau : add(tau, C(a.beta));
      scratch[(base + 2 * static_cast<int64_t>(a.n_pairs)) * B + col] = tau;
    }
  }
}

// ---------------------------------------------------------------------------
// leaf_values

// One leaf row: its kind, derivative order, basis row and pair of times.
struct alignas(16) LeafRow {
  int32_t kind, order, basis, pair;
};

// softplus^(k)(u) for k = 2..kMaxOrder as sum_t coef[k][t] s^i sbar^j, the
// terms in the host's order (models/free_fermion.py::_softplus_derivs).
struct Polys {
  int8_t n[kMaxOrder + 1];
  int8_t i[kMaxOrder + 1][kMaxTerms], j[kMaxOrder + 1][kMaxTerms];
  int16_t coef[kMaxOrder + 1][kMaxTerms];
};

struct ValuesArgs {
  const void* scratch;
  const LeafRow* rows;      // [n_leaves]
  void* out;                // [n_leaves, batch], T
  int64_t n_leaves, n_basis, n_pairs, batch;
  double beta, lam;
  Polys polys;
};

__constant__ const int kBinom[kMaxOrder][kMaxOrder] = {
    {1, 0, 0, 0, 0}, {1, 1, 0, 0, 0}, {1, 2, 1, 0, 0}, {1, 3, 3, 1, 0}, {1, 4, 6, 4, 1}};
__constant__ const double kFactorial[kMaxOrder + 1] = {1, 1, 2, 6, 24, 120};

constexpr double kEightPi = 8.0 * 3.14159265358979323846;

// (-1)^n / n! d^n G / d eps^n at (tau, eps): G = sign exp(phi), phi = -eps tau
// - softplus(c eps), c = -beta for tau > 0 else beta; the derivatives are
// G B_n(phi', ..., phi^(n)) with the complete Bell polynomials B.
template <typename C>
__device__ __forceinline__ C green_tower(C tau, C eps, int n, C beta, const Polys& P) {
  const bool pos = tau > C(0);
  const C c = pos ? -beta : beta;
  const C sgn = pos ? C(1) : C(-1);
  const C u = mul(c, eps);
  const C g = mul(sgn, ex(sub(mul(-eps, tau), softplus(u))));
  const C s = quo(C(1), add(C(1), ex(-u)));
  const C sbar = quo(C(1), add(C(1), ex(u)));
  C dphi[kMaxOrder];
  dphi[0] = sub(-tau, mul(c, s));
  C ck = c;
#pragma unroll
  for (int k = 2; k <= kMaxOrder; ++k) {
    if (k > n) break;
    ck = mul(ck, c);
    C sp = C(0);
    for (int t = 0; t < P.n[k]; ++t) {
      C p = s;
      for (int e = 1; e < P.i[k][t]; ++e) p = mul(p, s);
      for (int e = 0; e < P.j[k][t]; ++e) p = mul(p, sbar);
      const C term = mul(p, C(P.coef[k][t]));
      sp = t == 0 ? term : add(sp, term);
    }
    dphi[k - 1] = mul(-ck, sp);
  }
  C bell[kMaxOrder + 1];
  bell[0] = C(1);
#pragma unroll
  for (int m = 0; m < kMaxOrder; ++m) {
    if (m >= n) break;
    C acc = mul(mul(C(kBinom[m][0]), bell[m]), dphi[0]);
#pragma unroll
    for (int k = 1; k <= m; ++k) acc = add(acc, mul(mul(C(kBinom[m][k]), bell[m - k]), dphi[k]));
    bell[m + 1] = acc;
  }
  const C coef = C(((n & 1) ? -1.0 : 1.0) / kFactorial[n]);
  return mul(mul(g, bell[n]), coef);
}

template <typename C>
__device__ __forceinline__ C leaf_value(const ValuesArgs& a, const C* scratch, const LeafRow& r,
                                        int64_t col) {
  const int64_t B = a.batch, nb = a.n_basis, np = a.n_pairs;
  switch (r.kind) {
    case kG0: {
      const C eps = scratch[(nb + r.basis) * B + col];
      const C sp = scratch[(2 * nb + r.basis) * B + col];
      const C sign = scratch[(3 * nb + r.pair) * B + col];
      const C tau1 = scratch[(3 * nb + np + r.pair) * B + col];
      return mul(ex(-add(mul(eps, tau1), sp)), sign);
    }
    case kGTower: {
      const C eps = scratch[(nb + r.basis) * B + col];
      const C tau = scratch[(3 * nb + 2 * np + r.pair) * B + col];
      return green_tower(tau, eps, r.order, C(a.beta), a.polys);
    }
    case kVLambda:
    case kVTaylor: {
      const C q2 = scratch[static_cast<int64_t>(r.basis) * B + col];
      const C inv = quo(C(1), add(q2, C(a.lam)));
      if (r.kind == kVLambda) {
        const C ratio = mul(C(a.lam), inv);
        C v = mul(C(kEightPi), inv);
        for (int k = 0; k < r.order; ++k) v = mul(v, ratio);
        return v;
      }
      C v = mul(C((r.order & 1) ? -kEightPi : kEightPi), inv);
      for (int k = 0; k < r.order; ++k) v = mul(v, inv);
      return v;
    }
    default:
      return C(1);
  }
}

template <typename T, int V> struct Pack { T x[V]; };

template <typename T, typename C, int V>
__global__ void __launch_bounds__(kThreads) leaf_values_kernel(ValuesArgs a) {
  const C* scratch = static_cast<const C*>(a.scratch);
  T* out = static_cast<T*>(a.out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) * 32 + lane) * V;
  if (col0 >= a.batch) return;   // V > 1 only where V divides the batch
  for (int64_t row = static_cast<int64_t>(blockIdx.y) * kWarps + warp; row < a.n_leaves;
       row += static_cast<int64_t>(gridDim.y) * kWarps) {
    const LeafRow r = a.rows[row];
    Pack<T, V> pk;
#pragma unroll
    for (int j = 0; j < V; ++j) narrow_to(&pk.x[j], leaf_value<C>(a, scratch, r, col0 + j));
    T* dst = out + row * a.batch + col0;
    if constexpr (V == 1) {
      *dst = pk.x[0];
    } else {
      static_assert(sizeof(T) * V == 16, "a vector store moves 16 bytes");
      uint4 raw;
      memcpy(&raw, &pk, 16);
      *reinterpret_cast<uint4*>(dst) = raw;
    }
  }
}

unsigned grid_y(int64_t units) {
  return static_cast<unsigned>(units < kMaxGrid ? (units > 0 ? units : 1) : kMaxGrid);
}

template <typename T, typename C> cudaError_t launch_values(const ValuesArgs& a,
                                                            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(a.out) % 16 == 0 &&
                       (a.batch * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  const unsigned gy = grid_y((a.n_leaves + kWarps - 1) / kWarps);
  if (aligned) {
    const dim3 grid(static_cast<unsigned>((a.batch + 32 * kVec - 1) / (32 * kVec)), gy);
    leaf_values_kernel<T, C, kVec><<<grid, kThreads, 0, stream>>>(a);
  } else {
    const dim3 grid(static_cast<unsigned>((a.batch + 31) / 32), gy);
    leaf_values_kernel<T, C, 1><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).  compute,
// input and storage are TypeCodes: compute and input (varK, varT) float32
// or float64, storage any of the three; every pointer lies on the card
// except `polys`.

extern "C" int fd_leaf_prep(const void* basis, const void* varK, const void* varT,
                            const void* pair_in, const void* pair_out, void* scratch,
                            int n_basis, int n_pairs, int n_loop, int dim, long long batch,
                            double kF2, double beta, double tau_cutoff, int compute,
                            int input, void* stream) {
  if (n_basis < 0 || n_pairs < 0 || n_loop < 1 || dim < 1 || batch < 1 ||
      n_basis + n_pairs < 1) {
    return cudaErrorInvalidValue;
  }
  const PrepArgs a{basis, varK, varT, static_cast<const int32_t*>(pair_in),
                   static_cast<const int32_t*>(pair_out), scratch, n_basis, n_pairs, n_loop,
                   dim, batch, kF2, beta, tau_cutoff};
  const dim3 grid(static_cast<unsigned>((batch + kThreads - 1) / kThreads),
                  grid_y(static_cast<int64_t>(n_basis) + n_pairs));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute == kF64 && input == kF64) {
    leaf_prep_kernel<double, double><<<grid, kThreads, 0, s>>>(a);
  } else if (compute == kF64 && input == kF32) {
    leaf_prep_kernel<double, float><<<grid, kThreads, 0, s>>>(a);
  } else if (compute == kF32 && input == kF32) {
    leaf_prep_kernel<float, float><<<grid, kThreads, 0, s>>>(a);
  } else if (compute == kF32 && input == kF64) {
    leaf_prep_kernel<float, double><<<grid, kThreads, 0, s>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// polys: int32 [kMaxOrder + 1][1 + 3 kMaxTerms] on the host, per order k the
// number of terms, then (i, j, coef) per term.
extern "C" int fd_leaf_values(const void* scratch, const void* rows, void* out,
                              long long n_leaves, long long n_basis, long long n_pairs,
                              long long batch, double beta, double lam, const int* polys,
                              int storage, int compute, void* stream) {
  if (n_leaves < 1 || n_basis < 0 || n_pairs < 0 || batch < 1 || polys == nullptr) {
    return cudaErrorInvalidValue;
  }
  ValuesArgs a{scratch, static_cast<const LeafRow*>(rows), out, n_leaves, n_basis, n_pairs,
               batch, beta, lam, Polys{}};
  for (int k = 0; k <= kMaxOrder; ++k) {
    const int* row = polys + k * (1 + 3 * kMaxTerms);
    if (row[0] < 0 || row[0] > kMaxTerms) return cudaErrorInvalidValue;
    a.polys.n[k] = static_cast<int8_t>(row[0]);
    for (int t = 0; t < kMaxTerms; ++t) {
      a.polys.i[k][t] = static_cast<int8_t>(row[1 + 3 * t]);
      a.polys.j[k][t] = static_cast<int8_t>(row[2 + 3 * t]);
      a.polys.coef[k][t] = static_cast<int16_t>(row[3 + 3 * t]);
    }
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (compute == kF64) {
    if (storage == kF32) err = launch_values<float, double>(a, s);
    if (storage == kF64) err = launch_values<double, double>(a, s);
    if (storage == kBF16) err = launch_values<__nv_bfloat16, double>(a, s);
  } else if (compute == kF32) {
    if (storage == kF32) err = launch_values<float, float>(a, s);
    if (storage == kF64) err = launch_values<double, float>(a, s);
    if (storage == kBF16) err = launch_values<__nv_bfloat16, float>(a, s);
  }
  return static_cast<int>(err);
}
