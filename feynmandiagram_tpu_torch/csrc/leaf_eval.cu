// The leaf phase of a Monte-Carlo pass: sampled loop momenta and times ->
// the value of every leaf of the lowered graph, in one launch.
//
// Replaces no Pallas kernel: it replaces the loop fusion that XLA makes of
// the jnp chain of feynmandiagram_tpu/ops/leaf_eval.py:119-155 under
// jax.jit (the LoopPool product, |q|^2, and one physics call per
// (leaf type, derivative order) group, scattered into the leaf buffer).
//
// leaf_eval_kernel walks a work list that the host builds once
// (ops/leaf_eval.py::leaf_plan): the leaf rows grouped by basis row (a
// segment: one basis row and its leaf rows, in leaf order; a basis row
// with more leaves than an item holds is split, each part recomputing its
// basis row's values), the segments packed into items of about equal leaf
// counts, and the rows of no group in segments of their own.
//
// - A block takes a tile of kThreads columns, a thread one column (a warp's
//   store of a leaf row is 32 adjacent elements).  It reads its column of
//   varK [dim, n_loop, B] and varT [n_tau, B] once, in their own type
//   (float32 or float64), widens (or rounds) each element once to the
//   compute type C and keeps it in the block's shared memory, in slots that
//   only this thread reads: element k at sm[k * kThreads + t], so that a
//   warp's reads of one element are conflict-free.  (2 or 4 columns a
//   thread, with vector stores, and 256 threads a block were slower at
//   every shape measured: PERF.md.)
// - The block then runs through the items blockIdx.y, blockIdx.y +
//   gridDim.y, ...  It stages each item's records (segments, leaf records,
//   the basis rows' nonzero entries) in shared memory, so that the walk
//   reads broadcasts there and not dependent loads from L2.  Per segment
//   it computes its basis row's values in registers: loops[d] = sum_l
//   basis[n, l] * varK[d, l] over the row's nonzero entries, l in order,
//   from 0 (an entry that is exactly 0 adds a +-0 to a sum that is
//   squared: skipping it changes no bit of a finite sample's q2), q2 =
//   sum_d loops[d]^2 (d in order); with a G leaf eps = q2 - kF^2; with a
//   bare propagator sp = softplus(-beta * eps), softplus(x) = max(x, 0) +
//   log1p(exp(-|x|)) (jax.nn.softplus).  A row of V leaves alone computes
//   q2 only.
// - Per leaf of the segment (the kind and order uniform over the block):
//   tau = varT[out] - varT[in], cut to -TAU_CUTOFF where |tau| <
//   TAU_CUTOFF, sign = +-1, tau1 = tau or tau + beta
//   (models/free_fermion.py::green_tau_parts), and the value:
//   - kind 0, a row of no group: 1;
//   - kind 1, a bare propagator: sign * exp(-(eps * tau1 + sp));
//   - kind 2, a G counterterm of order 1..5: (-1)^n / n! d^n G / d eps^n,
//     the Bell recursion of models/free_fermion.py::green_derive_tower on
//     (tau, eps), with the softplus derivatives' polynomials in s, sbar
//     handed over by the host (`Polys`);
//   - kind 3 / 4, an interaction counterterm of order n in the
//     'lambda_power' / 'taylor' convention (models/yukawa.py):
//     8 pi inv (lam inv)^n / (-1)^n 8 pi inv^(n+1), inv = 1 / (q2 + lam).
//   It is computed in C, rounded once to the storage type T and stored
//   into the leaf's row of `out` (the leaf rows of the weight buffer).
//   Nothing else is written: no scratch table, no temporary.
//
// Rounding is that of the plain PyTorch version (ops/leaf_eval.py:
// leaf_prep_plain, then leaf_values_plain), which repeats these operations
// in this order: every product, sum and quotient is an explicit
// __fmul_rn / __dadd_rn / ... so that nvcc contracts none into an FMA; exp
// and log1p are CUDA's, which PyTorch's elementwise ops call too.
// Narrowing rounds to nearest even as PyTorch's .to() does (double ->
// bfloat16 through float, as c10::BFloat16 converts).
//
// What bounds it on an H100: float64 operations, and the latency of their
// chains.  The phase reads the samples and writes the leaves (Gamma4 order
// 4 at batch 4096: 4.6 us of bytes), but a basis row with a propagator pays
// an exp and a log1p, a bare propagator an exp, a G counterterm four exps,
// a log1p and two divisions, all in float64, which the card has no
// special-function unit for: each is tens of FP64 instructions, at 64 a
// clock and SM.  The design keeps the samples widened once per block and a
// basis row's values in registers, so nothing is widened or computed twice
// for a basis row; a G counterterm still computes what its formula could
// share (exp(u) and exp(-u) are reciprocals, and softplus has exp(-|u|)
// already: two exps and a division fewer), as the plain version does.
// fd_leaf_op_rate times those operations, from which chip_smoke.py takes
// the phase's operation floor.  A thread's work is one
// chain (a leaf after the other), and the samples' shared memory holds an
// SM to about a thousand threads: the kernel stays short of that floor
// (PERF.md).  The grid along the items is the launch's choice: the items
// shared evenly over the blocks, so many a block that the waves of blocks
// times a block's items is least.
//
// Built with nvcc into a shared library with a plain C interface (see
// feynmandiagram_tpu_torch/ops/leaf_eval.py), loaded through ctypes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum TypeCode { kF32 = 0, kF64 = 1, kBF16 = 2 };
enum Kind { kOne = 0, kG0 = 1, kGTower = 2, kVLambda = 3, kVTaylor = 4 };
// a segment's meta word: nonzero basis entries in the low 16 bits, then
// whether it has a basis row, needs eps (a G leaf) and sp (a bare G)
constexpr int kNzMask = 0xffff;
constexpr int kHasBasis = 1 << 16;
constexpr int kNeedEps = 1 << 17;
constexpr int kNeedSp = 1 << 18;

constexpr int kMaxOrder = 5;       // models/free_fermion.py::MAX_DERIV_ORDER
constexpr int kMaxTerms = 4;       // terms of softplus^(k), k <= 5
constexpr int kMaxGridY = 65535;
constexpr int kMaxDevices = 64;
constexpr int kMaxDim = 3;         // loop momenta of at most 3 components
constexpr int kThreads = 128;      // a block's threads, one column each

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

// one sample element in the compute type: float64 -> float32 rounds to
// nearest, as .to() does; float32 -> float64 is exact
template <typename C> __device__ __forceinline__ C widen(const void* src, int64_t i, int input) {
  return input == kF64 ? C(static_cast<const double*>(src)[i])
                       : C(static_cast<const float*>(src)[i]);
}

// softplus(x) = clamp_min(x, 0) + log1p(exp(-|x|))
template <typename C> __device__ __forceinline__ C softplus(C x) {
  const C m = x > C(0) ? x : C(0);
  return add(m, lg1p(ex(-fabs(x))));
}

// softplus^(k)(u) for k = 2..kMaxOrder as sum_t coef[k][t] s^i sbar^j, the
// terms in the host's order (models/free_fermion.py::_softplus_derivs).
struct Polys {
  int8_t n[kMaxOrder + 1];
  int8_t i[kMaxOrder + 1][kMaxTerms], j[kMaxOrder + 1][kMaxTerms];
  int16_t coef[kMaxOrder + 1][kMaxTerms];
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

// the pair of times of a G leaf: (tau, sign, tau1) of varT[out] - varT[in]
template <typename C> struct Times { C tau, sign, tau1; };

template <typename C>
__device__ __forceinline__ Times<C> times(C t_out, C t_in, C beta, C cutoff) {
  C tau = sub(t_out, t_in);
  if (fabs(tau) < cutoff) tau = -cutoff;
  const bool pos = tau > C(0);
  return {tau, pos ? C(1) : C(-1), pos ? tau : add(tau, beta)};
}

struct Args {
  const void* varK;          // [dim, n_loop, batch], input type
  const void* varT;          // [n_tau, batch], input type
  const int32_t* nz_l;       // [nnz] the basis rows' nonzero entries: loop index
  const void* nz_coef;       // [nnz] and coefficient, C
  const int4* segs;          // [n_seg] (nz begin, meta, leaf begin, leaf end)
  const int4* leaves;        // [n_leaves] (out row, kind | order << 8, tau in, tau out)
  const int4* items;         // [n_items][2] (segment begin, end, nz begin, end), (leaf begin, end, -, -)
  void* out;                 // [rows >= max out row + 1, batch], storage type
  int n_items, dim, n_loop, n_tau, input, storage;
  int max_segs, max_leaves, max_nz;   // the largest item's
  int64_t batch;
  double kF2, beta, lam, tau_cutoff;
  Polys polys;
};

// The dynamic shared memory of a block: the samples (rows x kThreads of C,
// a thread's own slots), then one item of the work list at a time (its
// coefficients, segments, leaf records and loop indices), which every
// thread reads: the walk's records are broadcasts from shared memory, not
// dependent loads from L2.
template <typename C> __host__ __device__ inline size_t samples_bytes(int rows) {
  return static_cast<size_t>(rows) * kThreads * sizeof(C);
}

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~size_t{15}; }

template <typename C>
__host__ __device__ inline size_t item_bytes(int max_segs, int max_leaves, int max_nz) {
  return round16(static_cast<size_t>(max_nz) * sizeof(C)) +
         static_cast<size_t>(max_segs + max_leaves) * sizeof(int4) +
         round16(static_cast<size_t>(max_nz) * sizeof(int32_t));
}

template <typename T, typename C>
__device__ __forceinline__ void store(void* out, int64_t off, C val) {
  narrow_to(static_cast<T*>(out) + off, val);
}

template <typename C> __global__ void __launch_bounds__(kThreads) leaf_eval_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const int t = threadIdx.x;
  const int64_t B = a.batch;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  const bool active = col < B;
  const int nk = a.dim * a.n_loop, rows = nk + a.n_tau;
  // the samples, widened once: element k at sm[k kThreads + t]
  if (active) {
#pragma unroll 8
    for (int k = 0; k < rows; ++k) {
      const void* src = k < nk ? a.varK : a.varT;
      const int64_t row = (k < nk ? k : k - nk) * B + col;
      sm[k * kThreads + t] = widen<C>(src, row, a.input);
    }
  }
  // one item's records, after the samples (16-byte aligned)
  unsigned char* item_raw = smem_raw + round16(samples_bytes<C>(rows));
  C* s_coef = reinterpret_cast<C*>(item_raw);
  int4* s_segs = reinterpret_cast<int4*>(item_raw + round16(a.max_nz * sizeof(C)));
  int4* s_leaves = s_segs + a.max_segs;
  int32_t* s_nzl = reinterpret_cast<int32_t*>(s_leaves + a.max_leaves);

  const C* tk = sm + t;
  const C* tt = sm + static_cast<int64_t>(nk) * kThreads + t;
  const C* coef = static_cast<const C*>(a.nz_coef);
  const C kF2 = C(a.kF2), beta = C(a.beta), nbeta = C(-a.beta), lam = C(a.lam);
  const C cutoff = C(a.tau_cutoff);

  for (int item = blockIdx.y; item < a.n_items; item += gridDim.y) {
    const int4 it = a.items[2 * item];
    const int leaf0 = a.items[2 * item + 1].x, n_leaves = a.items[2 * item + 1].y - leaf0;
    __syncthreads();   // the previous item's records are read by all
    for (int i = t; i < it.y - it.x; i += kThreads) s_segs[i] = a.segs[it.x + i];
    for (int i = t; i < n_leaves; i += kThreads) s_leaves[i] = a.leaves[leaf0 + i];
    for (int i = t; i < it.w - it.z; i += kThreads) {
      s_coef[i] = coef[it.z + i];
      s_nzl[i] = a.nz_l[it.z + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < it.y - it.x; ++s) {
      const int4 sg = s_segs[s];
      C q2, eps, sp;
      if (sg.y & kHasBasis) {
        // loops[d] for d < dim, the entries in order, each read once
        C acc[kMaxDim];
#pragma unroll
        for (int d = 0; d < kMaxDim; ++d) acc[d] = C(0);
        const int e0 = sg.x - it.z, e1 = e0 + (sg.y & kNzMask);
        for (int e = e0; e < e1; ++e) {
          const C b = s_coef[e];
          const C* x = tk + s_nzl[e] * kThreads;
#pragma unroll
          for (int d = 0; d < kMaxDim; ++d) {
            if (d < a.dim) acc[d] = add(acc[d], mul(b, x[d * a.n_loop * kThreads]));
          }
        }
        q2 = mul(acc[0], acc[0]);
#pragma unroll
        for (int d = 1; d < kMaxDim; ++d) {
          if (d < a.dim) q2 = add(q2, mul(acc[d], acc[d]));
        }
        if (sg.y & kNeedEps) {
          eps = sub(q2, kF2);
          if (sg.y & kNeedSp) sp = softplus(mul(nbeta, eps));
        }
      }
      for (int j = sg.z - leaf0; j < sg.w - leaf0; ++j) {
        const int4 lf = s_leaves[j];
        const int kind = lf.y & 0xff, order = lf.y >> 8;
        C val;
        switch (kind) {
          case kG0: {
            const Times<C> p = times(tt[lf.w * kThreads], tt[lf.z * kThreads], beta, cutoff);
            val = mul(ex(-add(mul(eps, p.tau1), sp)), p.sign);
            break;
          }
          case kGTower: {
            const Times<C> p = times(tt[lf.w * kThreads], tt[lf.z * kThreads], beta, cutoff);
            val = green_tower(p.tau, eps, order, beta, a.polys);
            break;
          }
          case kVLambda: {
            const C inv = quo(C(1), add(q2, lam));
            const C ratio = mul(lam, inv);
            val = mul(C(kEightPi), inv);
            for (int k = 0; k < order; ++k) val = mul(val, ratio);
            break;
          }
          case kVTaylor: {
            const C inv = quo(C(1), add(q2, lam));
            val = mul(C((order & 1) ? -kEightPi : kEightPi), inv);
            for (int k = 0; k < order; ++k) val = mul(val, inv);
            break;
          }
          default:
            val = C(1);
        }
        const int64_t off = static_cast<int64_t>(lf.x) * B + col;
        if (a.storage == kF32) {
          store<float>(a.out, off, val);
        } else if (a.storage == kF64) {
          store<double>(a.out, off, val);
        } else {
          store<__nv_bfloat16>(a.out, off, val);
        }
      }
    }
  }
}

template <typename C> cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto* kernel = leaf_eval_kernel<C>;
  const size_t smem = round16(samples_bytes<C>(a.dim * a.n_loop + a.n_tau)) +
                      item_bytes<C>(a.max_segs, a.max_leaves, a.max_nz);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  // above 48 KB a block's dynamic shared memory must be allowed first: once
  // per device and size, not on every launch
  static int allowed[kMaxDevices] = {};
  if (smem > 48 * 1024 && static_cast<int>(smem) > allowed[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed[device] = static_cast<int>(smem);
  }
  const int64_t blocks_x = (a.batch + kThreads - 1) / kThreads;
  // the items shared evenly over the blocks along y (every block runs n or
  // n + 1 of them), n chosen for the shortest run: the waves of blocks that
  // the card holds at once times the items a block runs, a block's read of
  // its samples counted as one item more
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  int64_t best = -1, grid_y = 1;
  for (int64_t per = 1; per <= a.n_items; ++per) {
    const int64_t gy = (a.n_items + per - 1) / per;
    if (gy > kMaxGridY) continue;
    const int64_t cost = (blocks_x * gy + resident - 1) / resident * (per + 1);
    if (best < 0 || cost < best) {
      best = cost;
      grid_y = gy;
    }
  }
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(grid_y));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the issue rate of the leaf phase's float64 (and float32) operations: each
// thread runs four independent chains of `iters` steps of one operation

enum RateOp { kAdd = 0, kMul = 1, kExp = 2, kLog1p = 3, kDiv = 4, kCvt = 5 };

template <typename C, int OP> __device__ __forceinline__ C rate_step(C x, float& f) {
  if constexpr (OP == kAdd) return add(x, C(1e-7));
  if constexpr (OP == kMul) return mul(x, C(0.9999999));
  if constexpr (OP == kExp) return -ex(x);                 // stays in [-1, -0.37]
  if constexpr (OP == kLog1p) return add(lg1p(x), C(0.3));  // and one add: stays near 1
  if constexpr (OP == kDiv) return quo(C(1.5), x);        // 0.5 <-> 3
  // a float32 -> C conversion and the add of kAdd; f steps on the float32 pipe
  const C y = add(x, static_cast<C>(f));
  f = __fadd_rn(f, 1e-3f);
  return y;
}

template <typename C, int OP> __global__ void op_rate_kernel(C* out, int iters) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  C x0 = C(0.5) + C(threadIdx.x) * C(1e-6), x1 = add(x0, C(0.1)), x2 = add(x0, C(0.2)),
    x3 = add(x0, C(0.3));
  float f0 = 0.25f, f1 = 0.5f, f2 = 0.75f, f3 = 1.0f;
  for (int i = 0; i < iters; ++i) {
    x0 = rate_step<C, OP>(x0, f0);
    x1 = rate_step<C, OP>(x1, f1);
    x2 = rate_step<C, OP>(x2, f2);
    x3 = rate_step<C, OP>(x3, f3);
  }
  out[tid] = add(add(x0, x1), add(x2, x3));
}

template <typename C>
cudaError_t launch_rate(int op, C* out, int blocks, int threads, int iters, cudaStream_t s) {
  switch (op) {
    case kAdd: op_rate_kernel<C, kAdd><<<blocks, threads, 0, s>>>(out, iters); break;
    case kMul: op_rate_kernel<C, kMul><<<blocks, threads, 0, s>>>(out, iters); break;
    case kExp: op_rate_kernel<C, kExp><<<blocks, threads, 0, s>>>(out, iters); break;
    case kLog1p: op_rate_kernel<C, kLog1p><<<blocks, threads, 0, s>>>(out, iters); break;
    case kDiv: op_rate_kernel<C, kDiv><<<blocks, threads, 0, s>>>(out, iters); break;
    case kCvt: op_rate_kernel<C, kCvt><<<blocks, threads, 0, s>>>(out, iters); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The leaf phase on the card: returns the cudaError_t of the launch (0 on
// success).  compute, input and storage are TypeCodes: compute and input
// (varK, varT) float32 or float64, storage any of the three; dim at most
// kMaxDim; max_segs, max_leaves and max_nz the largest item's.  polys:
// int32 [kMaxOrder + 1][1 + 3 kMaxTerms] on the host, per order k the
// number of terms, then (i, j, coef) per term; every other pointer lies on
// the card.
extern "C" int fd_leaf_eval(const void* varK, const void* varT, const void* nz_l,
                            const void* nz_coef, const void* segs, const void* leaves,
                            const void* items, void* out, int n_items, int max_segs,
                            int max_leaves, int max_nz, int dim, int n_loop, int n_tau,
                            long long batch, double kF2, double beta, double lam,
                            double tau_cutoff, const int* polys, int compute, int input,
                            int storage, void* stream) {
  if (n_items < 1 || max_segs < 1 || max_leaves < 1 || max_nz < 0 || dim < 1 ||
      dim > kMaxDim || n_loop < 1 || n_tau < 0 || batch < 1 || polys == nullptr ||
      (input != kF32 && input != kF64) ||
      (storage != kF32 && storage != kF64 && storage != kBF16)) {
    return cudaErrorInvalidValue;
  }
  Args a{varK, varT, static_cast<const int32_t*>(nz_l), nz_coef,
         static_cast<const int4*>(segs), static_cast<const int4*>(leaves),
         static_cast<const int4*>(items), out, n_items, dim, n_loop, n_tau, input, storage,
         max_segs, max_leaves, max_nz, batch, kF2, beta, lam, tau_cutoff, Polys{}};
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
  if (compute == kF64) err = launch<double>(a, s);
  if (compute == kF32) err = launch<float>(a, s);
  return static_cast<int>(err);
}

// blocks x threads threads, each four chains of `iters` steps of op (RateOp)
// in compute (TypeCode float32 or float64); out: blocks x threads elements
// of that type on the card
extern "C" int fd_leaf_op_rate(int op, int compute, void* out, int blocks, int threads,
                               int iters, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024 || iters < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute == kF64) return launch_rate<double>(op, static_cast<double*>(out), blocks,
                                                  threads, iters, s);
  if (compute == kF32) return launch_rate<float>(op, static_cast<float*>(out), blocks,
                                                 threads, iters, s);
  return cudaErrorInvalidValue;
}
