// The nine row-access probe kernels, CUDA C++ for sm_90a.
//
// Each replaces one Pallas kernel of benchmarks/probe_mosaic_caps.py, a
// probe of one way to read or write rows whose index is known only at run
// time.  The TPU kernels took the row indices `rows` as scalar prefetch; on
// the GPU they are kernel arguments passed by value (the wrapper reads them
// on the host, where it also checks the bounds of the copies).  All data is
// float32, w is [S, B] row-major, and B * 4 is a multiple of 16 bytes.
//
//   probe         TPU kernel (call site)                       here
//   dma8          k_dma8, probe_mosaic_caps.py:39         k_dma8: copy_rows from row r, 8 rows
//   dmagrp        k_dmagrp, :61                            k_dmagrp: copy_rows from row 8*(r div 8)
//   vmemrow       k_vmemrow, :82                           k_vmem, size 1: copy_rows, row r of w[:K]
//   vmem8         k_vmem8, :100                            k_vmem, size 8: rows r..r+8 of it
//   acc           k_acc, :122                              k_acc: 0 + w[s0] + .. + w[s3], 4 loads
//   onehot        k_onehot, :143                           k_onehot: rows r..r+8 of w[:K] read
//                                                          (k_onehot_mma: sel @ those rows, TF32)
//   dynwrite      k_dynwrite, :162                         k_dynwrite: copy_rows' shape over 8 x B,
//                                                          a block row each, w[0] in row r mod 8
//   dmadyn_dst    k_dmadyn_dst, :185                       k_dmadyn_dst: copy_rows from row 8r
//                                                          where rows[1] mod 4 == 0, else zeros
//   take          k_take, :205                             k_take: copy_rows' shape, rows
//                                                          {3,1,4,1,5,9,2,6} as an immediate
//
// What bounds them: at the probe's shapes (S = 4096, B = 512) each moves 2
// to 64 KB in one launch, so the launch and the first access's
// latency bound every one of them, not bandwidth.  So a design counts the
// dependent memory latencies and the host calls of a launch, not bytes per
// second; a gridded version that reads many rows per launch at the copy
// roofline is later work.  k_empty, a kernel that does nothing, is there to
// measure that floor.
//
// - dma8, dmagrp, vmemrow, vmem8: four copies of `size` whole rows from a
//   start known at run time.  On the TPU the memory spaces shaped them: dma8
//   and dmagrp were an async copy HBM -> VMEM scratch on a DMA semaphore and
//   a copy out of the scratch; vmemrow and vmem8 kept the whole [K = 256, B]
//   block in VMEM and read `size` rows of it.  Here source and destination
//   are both global memory and the start is a kernel argument, known before
//   a byte moves, so nothing need be staged or resident: the source is
//   size * B * 4 contiguous, 16-byte-aligned bytes of w, and so is the
//   destination.  Bound by bytes (2 or 16 rows of traffic, nanoseconds), met
//   by a launch's floor: one copy body, copy_rows, a grid over the 16-byte
//   pieces of the range, one ld.global.nc.v4 and one st.global.v4 a thread,
//   one dependent memory latency deep; no shared memory and no barrier, so
//   a launch is one host call.  The kernels differ in where the range
//   starts, which each computes on the device as the TPU kernel did from
//   rows[0]: dma8 at row r, dmagrp at row 8 * (r div 8) (floor division),
//   both unclamped (the wrapper raises on a source outside w) and 64-bit
//   (r * B passes 2^31 on large buffers); vmemrow and vmem8 at the clamped
//   slice start below.
// - k_bulk moves the same ranges, from any of the three starts, through
//   shared memory with the TMA on both sides (bulk_load on an mbarrier, then
//   bulk_store), a chunk a block.  It is the design the TPU kernels
//   translate to word for word, kept to be timed beside copy_rows: two
//   dependent asynchronous copies with a barrier wait between them.  In one
//   chunk of 8 rows it is the one-block copy dma8 and dmagrp had before.
// - dmadyn_dst: the TPU kernel copies rows 8r .. 8r + 8 of w, r = rows[0],
//   by an async copy on a DMA semaphore into rows 8j .. 8j + 8 of a [32, B]
//   VMEM scratch, j = rows[1] mod 4, and outputs scratch rows 0 .. 8.
//   Carried over block by block, as it first was here, that is one block of
//   256 threads zero-filling the 32-row scratch (64 KB at B = 512), a TMA
//   bulk copy landing on an mbarrier, and the block copying rows 0 .. 8 out:
//   three dependent latencies on one SM, behind a host call for the device's
//   index and an attribute call for the scratch's > 48 KB, which also capped
//   B at 1812.  Of the 32 scratch rows only rows 0 .. 8 reach the output, so
//   all that j decides is whether they hold the copy (j == 0) or not; the
//   TPU kernel leaves them uninitialised then, and the port defines them as
//   zeros.  So no scratch is needed: the kernel is copy_rows from row 8r
//   where floor_mod(rows[1], 4) == 0 (computed on the device), else a store
//   of zeros with no load.  One memory latency deep, any B that is a
//   multiple of 4, plain launch.  The test is written as a branch, uniform
//   over the grid, with copy_rows inlined on each side: so nvcc reads the
//   parameters through the uniform datapath as for dma8.  As one copy_rows
//   with a select it read them by a chain of per-thread constant loads
//   ahead of the predicated load, and stood ~0.06 us behind dma8.  The copy
//   has no clamp: the wrapper raises on a source outside w, whatever j is,
//   as the reference copies whatever j is.
// - acc: out[0] = 0 + w[s0] + w[s1] + w[s2] + w[s3] over the [K = 256, B]
//   block, s_i the clamped slice start of rows[i].  The TPU kernel kept the
//   whole block resident in VMEM and added four rows of it; carried over
//   as it was, that made 8 blocks stage 512 KB through shared memory for a
//   2 KB row, and the 72 KB tiles needed an attribute call (and a host call
//   for the device's index) before each launch.  Bound by bytes: 5 rows of
//   traffic, nanoseconds, so met by a launch's floor.  The design reads
//   only the four rows: a thread per
//   16-byte piece of the row (for B = 512 one block of 128 working
//   threads), the four starts computed on the device, all four
//   ld.global.nc.v4 issued before the first add, so the kernel is one memory
//   latency deep like copy_rows, and one st.global.v4.  The adds run in the
//   reference's order from 0 (0 + -0.0 gives +0.0, as there), so the result
//   is the plain version's bit for bit.
// - onehot: out[i] = sum_k [k == r + i] * w[k] for i < 8, k < K: row r + i of
//   the block, or zeros where r + i lies outside [0, K).  The start is not
//   clamped: rows outside the block select nothing (the wrapper clamps r into
//   [-8, K], which selects the same rows and keeps r + i in int32).  The TPU
//   kernel ran the whole [8, K] x [K, B] product on the MXU over the resident
//   block; carried over as it was, that is 32 mma.sync k-steps over staged
//   tiles, at most two of which can hold a 1.  Bound by bytes (16 rows of traffic; the
//   product's 2 * 8 * K * B operations are 4 ns at the TF32 rate), met by a
//   launch's floor.  Two designs read only rows r .. r + 8:
//   k_onehot (the kernel of record) takes the select as a read: copy_rows'
//     shape over the 8 x B output, a 16-byte piece a thread, with a per-row
//     predicate and no load for a row outside the block.  No tensor cores;
//     exact (on finite data the product has one nonzero term: equal as
//     values, though a -0.0 reads +0.0 in the product).
//   k_onehot_mma keeps the select on tensor cores, over only the k8-blocks
//     8 * (r div 8) and the next, where they hold a row of r .. r + 8 inside
//     [0, K): one or two mma.sync m16n8k8 TF32 steps (M padded from 8 to 16
//     with zero rows of the selector), a warp per 8 output columns, the B
//     fragments loaded straight from global memory.  The selector's 0 and 1
//     are exact in TF32; w is rounded to TF32, so a result is exact for
//     |integers| < 2^11 and within 2^-11 relative of w otherwise.
//   Neither lets a non-finite value in an unselected row reach the output, as
//   the full product would (0 * inf): neither reads such a row (k_onehot_mma
//   zeroes its fragments outside rows r .. r + 8).  In k_onehot_mma, as in
//   the product, a non-finite selected row still makes NaN of the other
//   output rows in its columns; k_onehot copies it to its own row alone.
// - Row starts of vmemrow, vmem8 and acc are taken as lax.dynamic_slice takes
//   them in the reference: a negative start counts once from the end, then
//   the start is clamped into [0, K - size] (rows 256 and 1031 of the probe
//   lie outside the block).
// - dynwrite: out [8, B] is zeros but for row floor_mod(r, 8), which holds
//   w[0].  The first design here ran one thread per column over eight scalar
//   4-byte zero stores, then a 4-byte load of w[b] and a store into row
//   r mod 8, which was so written twice; w and out not __restrict__, so the
//   load could not move above the eight stores.  Bound by bytes (9 rows of
//   traffic, nanoseconds), met by a launch's floor.  The design is
//   copy_rows' shape over the 8 x B output: a thread per 16-byte piece, one
//   st.global.v4 each, and one ld.global.nc.v4 of the matching piece of w[0]
//   only in row floor_mod(r, 8), zeros with no load elsewhere, through
//   __restrict__ pointers (the wrapper allocates out, so it never aliases w).
//   The grid is 2-D, blockIdx.y the output row, so the row test is a branch
//   uniform over the block and needs no division (a 1-D grid that takes the
//   row by a 32-bit division by B/4, as k_take does, was timed beside it and
//   was slower).
// - take: out[i] = w[t_i] for the static list t = {3, 1, 4, 1, 5, 9, 2, 6}
//   of the [K = 256, B] block.  The first design here ran one thread per
//   column over 8 scalar 4-byte loads and stores, the rows in an array in
//   constant memory, w and out not __restrict__: its SASS issues each load
//   only after the previous row's store, which waits for that load's data,
//   so 8 dependent memory latencies, the rows read from the constant bank
//   between them.  Bound by bytes (16 rows of traffic, nanoseconds), met by
//   a launch's floor.  The design is copy_rows' shape over the 8 x B
//   output: a thread per 16-byte piece, its output row i = piece / (B/4),
//   the source row t_i a nibble of the immediate kTakeRowsPacked (no load
//   for the index), one ld.global.nc.v4 and one st.global.v4 through
//   __restrict__ pointers: one memory latency deep.
//
// Built with nvcc into a shared library with a plain C interface (see
// feynmandiagram_tpu_torch/ops/build.py), loaded through ctypes.  Every
// entry returns the cudaError_t of its launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

extern __shared__ __align__(16) float dyn_smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kCopyThreads = 256;            // copy_rows: a block moves 4 KB
constexpr int kBulkThreads = 32;             // k_bulk: one thread works, a warp waits
// take's rows {3, 1, 4, 1, 5, 9, 2, 6}, a nibble each from the lowest:
// output row i is row (kTakeRowsPacked >> 4i) & 0xF of w
constexpr uint32_t kTakeRowsPacked = 0x62951413u;

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// The start of a `size`-row slice of a K-row block, as lax.dynamic_slice
// takes it: a negative start counts once from the end, then the start is
// clamped into [0, K - size].
__device__ __forceinline__ int slice_start(int r, int K, int size) {
  if (r < 0) r += K;
  const int hi = K - size;
  return r < 0 ? 0 : (r > hi ? hi : r);
}

// How a copy kernel takes the first row of its range from the row index r.
enum Start : int {
  kStartSlice = 0,   // slice_start(r, K, size)
  kStartRow = 1,     // r
  kStartGroup = 2,   // 8 * (r div 8), floor division
};

// 8 * (r div 8), floor division: in two's complement, r less its low 3 bits.
__device__ __forceinline__ int64_t group_start(int64_t r) { return r & ~int64_t{7}; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One TMA bulk copy of `bytes` contiguous bytes from global `src` to shared
// `dst`; every thread of the block returns once the bytes have landed.  The
// block's earlier shared-memory writes are fenced against the copy's
// (async-proxy) writes first.
__device__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
  }
}

// One TMA bulk copy of `bytes` contiguous bytes from shared `src` to global
// `dst` (both 16-byte aligned, bytes a multiple of 16), called by the whole
// block.  The block's shared-memory writes are fenced against the copy's
// (async-proxy) reads first.  Thread 0 returns once the copy has read
// `src`; the block must meet at a barrier before it writes there again.
// The bytes are in `dst` when the kernel ends.
__device__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// out [size, B] = w[first : first + size], one contiguous range: a grid over
// its float4s, a load and a store each; with copy false, zeros and no load.
__device__ __forceinline__ void copy_rows(const float* w, float* out, int64_t first, int size,
                                          int B, bool copy = true) {
  const int64_t n4 = static_cast<int64_t>(size) * (B / 4);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* src = reinterpret_cast<const float4*>(w + first * B);
  reinterpret_cast<float4*>(out)[i] =
      copy ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);   // ld.global.nc.v4.f32
}

__global__ void k_dma8(const float* w, float* out, int64_t r, int B) {
  copy_rows(w, out, r, 8, B);
}

__global__ void k_dmagrp(const float* w, float* out, int64_t r, int B) {
  copy_rows(w, out, group_start(r), 8, B);
}

// out [8, B] = w[8r : 8r + 8] where rows[1] mod 4 == 0 (the copy lands on
// the scratch rows that are output), else zeros.  A branch, not a select:
// see the header.
__global__ void k_dmadyn_dst(const float* w, float* out, int64_t r, int r1, int B) {
  if (floor_mod(r1, 4) == 0) {
    copy_rows(w, out, 8 * r, 8, B);
  } else {
    copy_rows(w, out, 8 * r, 8, B, false);
  }
}

// out [size, B] = w[:K][s : s + size], s = slice_start(r, K, size).
__global__ void k_vmem(const float* w, float* out, int r, int K, int size, int B) {
  copy_rows(w, out, slice_start(r, K, size), size, B);
}

// The range of any of the three kernels above (`start` says which),
// `chunk` bytes (a multiple of 16) a block: a bulk load into shared memory,
// then a bulk store from it.
__global__ void k_bulk(const float* w, float* out, int64_t r, int K, int size, int B,
                       int start, uint32_t chunk) {
  __shared__ uint64_t bar;
  const int64_t first = start == kStartSlice ? slice_start(static_cast<int>(r), K, size)
                        : start == kStartGroup ? group_start(r) : r;
  const int64_t total = static_cast<int64_t>(size) * B * sizeof(float);
  const int64_t off = static_cast<int64_t>(blockIdx.x) * chunk;
  const uint32_t bytes = static_cast<uint32_t>(total - off < chunk ? total - off : chunk);
  const char* src = reinterpret_cast<const char*>(w + first * B);
  bulk_load(dyn_smem, src + off, bytes, &bar);
  bulk_store(reinterpret_cast<char*>(out) + off, dyn_smem, bytes);
}

// The sum of four floats in the reference's order, from 0: no reassociation,
// and 0 + -0.0 is +0.0.
__device__ __forceinline__ float sum4_from_zero(float a, float b, float c, float d) {
  float s = 0.f;
  s = __fadd_rn(s, a);
  s = __fadd_rn(s, b);
  s = __fadd_rn(s, c);
  return __fadd_rn(s, d);
}

// out [1, B] = 0 + w[s0] + w[s1] + w[s2] + w[s3], s_i = slice_start(r_i, K, 1):
// a thread per 16-byte piece, the four loads in flight together.
__global__ void k_acc(const float* w, float* out, int r0, int r1, int r2, int r3, int K,
                      int B) {
  const int64_t q = B / 4;   // 16-byte pieces of a row
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const float4* src = reinterpret_cast<const float4*>(w) + i;
  const float4 a = __ldg(src + slice_start(r0, K, 1) * q);
  const float4 b = __ldg(src + slice_start(r1, K, 1) * q);
  const float4 c = __ldg(src + slice_start(r2, K, 1) * q);
  const float4 d = __ldg(src + slice_start(r3, K, 1) * q);
  reinterpret_cast<float4*>(out)[i] =
      make_float4(sum4_from_zero(a.x, b.x, c.x, d.x), sum4_from_zero(a.y, b.y, c.y, d.y),
                  sum4_from_zero(a.z, b.z, c.z, d.z), sum4_from_zero(a.w, b.w, c.w, d.w));
}

// out [8, B]: row i = w[r + i] where 0 <= r + i < K, else zeros; a grid over
// the output's 16-byte pieces, a load (if the row is inside) and a store
// each.  Piece i of the output is piece r * B/4 + i of w.
__global__ void k_onehot(const float* w, float* out, int r, int K, int B) {
  const int64_t q = B / 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 8 * q) return;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i >= -static_cast<int64_t>(r) * q && i < static_cast<int64_t>(K - r) * q) {
    v = __ldg(reinterpret_cast<const float4*>(w) + static_cast<int64_t>(r) * q + i);
  }
  reinterpret_cast<float4*>(out)[i] = v;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// The same select on tensor cores: sel @ w[:K], sel[i, k] = (k == r + i),
// i < 8, over only the k8-blocks kb = 8 * (r div 8) and kb + 8 that hold a
// row of r .. r + 8 inside [0, K).  A warp owns output columns n0 .. n0 + 8;
// lane = 4 * g + t.  Fragments of m16n8k8 (PTX ISA, tf32): A a0 (g, t),
// a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g);
// D d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1).  Rows 8..15 of
// sel are zero (a1 = a3 = 0).  Every B fragment is loaded before the first
// mma; rows outside r .. r + 8 or [0, K) and columns past B read as 0.
__global__ void k_onehot_mma(const float* w, float* out, int r, int K, int B) {
  const int n0 = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * 8;
  if (n0 >= B) return;   // the whole warp
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, col = n0 + g;
  const int kb = r & ~7;   // 8 * (r div 8), floor division
  const uint32_t one = __float_as_uint(1.0f), zero = 0u;   // exact in tf32
  uint32_t a[2][2], b[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = kb + 8 * s + 4 * h + t;
      const bool row = k >= r && k < r + 8 && k >= 0 && k < K;
      b[s][h] = row && col < B ? to_tf32(__ldg(w + static_cast<int64_t>(k) * B + col)) : zero;
      a[s][h] = k == r + g ? one : zero;
    }
  }
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int k0 = kb + 8 * s;
    if (k0 + 8 <= r || k0 >= r + 8 || k0 < 0 || k0 >= K) continue;   // the same in every lane
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[s][0]), "r"(zero), "r"(a[s][1]), "r"(zero), "r"(b[s][0]), "r"(b[s][1]));
  }
  const int c = n0 + 2 * t;   // even, and B is a multiple of 4: c < B means c + 1 < B
  if (c < B) {
    *reinterpret_cast<float2*>(out + static_cast<int64_t>(g) * B + c) = make_float2(d[0], d[1]);
  }
}

// out [8, B]: row floor_mod(r, 8) = w[0], the others zeros; block row
// blockIdx.y writes output row blockIdx.y, a 16-byte piece a thread.  The
// test is a branch uniform over the block, with the store on each side.
// 8 * B/4 < 2^32, so the piece index is 32-bit.
__global__ void k_dynwrite(const float* __restrict__ w, float* __restrict__ out, int r, int B) {
  const uint32_t q = B / 4;
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  float4* dst = reinterpret_cast<float4*>(out) + blockIdx.y * q + i;
  if (blockIdx.y == static_cast<uint32_t>(floor_mod(r, 8))) {
    *dst = __ldg(reinterpret_cast<const float4*>(w) + i);
  } else {
    *dst = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// out [8, B]: row i = w[(kTakeRowsPacked >> 4i) & 0xF]; a grid over the
// output's 16-byte pieces, a load and a store each.  8 * B/4 < 2^32, so the
// piece index and its row are 32-bit (no 64-bit division).
__global__ void k_take(const float* __restrict__ w, float* __restrict__ out, int B) {
  const uint32_t q = B / 4;
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 8 * q) return;
  const uint32_t row = i / q;
  const uint32_t src = (kTakeRowsPacked >> (4 * row)) & 0xFu;
  reinterpret_cast<float4*>(out)[i] =
      __ldg(reinterpret_cast<const float4*>(w) + static_cast<int64_t>(src) * q + (i - row * q));
}

// The least a launch can do: what every probe's time is held against.
__global__ void k_empty() {}

unsigned blocks_of(int64_t n, int64_t per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, unsigned threads, size_t smem,
           void* stream, Args... args) {
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// copy_rows' grid for `size` rows of B floats (B a multiple of 4).
unsigned copy_grid(int size, int B, int threads) {
  return blocks_of(static_cast<int64_t>(size) * (B / 4), threads);
}

// K >= size rows of w -> out [size, B].
int vmem(const float* w, float* out, int r, int K, int size, int B, void* stream) {
  return launch(k_vmem, copy_grid(size, B, kCopyThreads), kCopyThreads, 0, stream, w, out, r, K,
                size, B);
}

// 8 rows from row r, or from the start of r's group of 8 -> out [8, B].
int copy8(bool group, const float* w, float* out, int64_t r, int threads, int B, void* stream) {
  return launch(group ? k_dmagrp : k_dma8, copy_grid(8, B, threads), threads, 0, stream, w, out,
                r, B);
}

}  // namespace

extern "C" {

// w + r*B .. w + (r+8)*B -> out [8, B]; the caller checks 0 <= r <= S - 8.
int fd_probe_dma8(const float* w, float* out, long long r, int B, void* stream) {
  return copy8(false, w, out, r, kCopyThreads, B, stream);
}

// rows 8*(r div 8) .. +8 -> out [8, B]; the caller checks the group.
int fd_probe_dmagrp(const float* w, float* out, long long r, int B, void* stream) {
  return copy8(true, w, out, r, kCopyThreads, B, stream);
}

// Either of the two at `threads` a block (a multiple of 32 up to 1024), for
// the sweep that chose kCopyThreads.
int fd_probe_copy8_threads(const float* w, float* out, long long r, int group, int threads,
                           int B, void* stream) {
  return copy8(group != 0, w, out, r, threads, B, stream);
}

// The empty kernel on a grid of `grid` blocks of `threads`.
int fd_probe_empty(int grid, int threads, void* stream) {
  return launch(k_empty, grid, threads, 0, stream);
}

// rows 8r .. 8r+8 -> out [8, B] where r1 mod 4 == 0, else zeros.  The caller
// checks 0 <= 8r <= S - 8.
int fd_probe_dmadyn_dst(const float* w, float* out, long long r, int r1, int B,
                        void* stream) {
  return launch(k_dmadyn_dst, copy_grid(8, B, kCopyThreads), kCopyThreads, 0, stream, w, out, r,
                r1, B);
}

int fd_probe_vmemrow(const float* w, float* out, int r, int K, int B, void* stream) {
  return vmem(w, out, r, K, 1, B, stream);
}

int fd_probe_vmem8(const float* w, float* out, int r, int K, int B, void* stream) {
  return vmem(w, out, r, K, 8, B, stream);
}

// The function of vmemrow or vmem8 (start 0: r clamped into the K-row block),
// of dma8 (start 1, size 8) or of dmagrp (start 2, size 8) by TMA, `chunk`
// bytes a block: a multiple of 16, at most 32 KB (with the barrier it stays
// under the 48 KB default).  The caller checks an unclamped source.
int fd_probe_bulk(const float* w, float* out, long long r, int K, int size, int start,
                  int chunk, int B, void* stream) {
  const unsigned grid = blocks_of(static_cast<int64_t>(size) * B * sizeof(float), chunk);
  return launch(k_bulk, grid, kBulkThreads, chunk, stream, w, out, r, K, size, B, start,
                static_cast<uint32_t>(chunk));
}

int fd_probe_acc(const float* w, float* out, int r0, int r1, int r2, int r3, int K, int B,
                 void* stream) {
  return launch(k_acc, copy_grid(1, B, kCopyThreads), kCopyThreads, 0, stream, w, out, r0, r1,
                r2, r3, K, B);
}

// The caller keeps r in [-8, K]: outside it no row is selected either way.
int fd_probe_onehot(const float* w, float* out, int r, int K, int B, void* stream) {
  return launch(k_onehot, copy_grid(8, B, kCopyThreads), kCopyThreads, 0, stream, w, out, r, K,
                B);
}

// The same function on tensor cores (k_onehot_mma), kThreads / 4 columns a block.
int fd_probe_onehot_mma(const float* w, float* out, int r, int K, int B, void* stream) {
  return launch(k_onehot_mma, blocks_of(B, kThreads / 4), kThreads, 0, stream, w, out, r, K, B);
}

// w needs at least 1 row.
int fd_probe_dynwrite(const float* w, float* out, int r, int B, void* stream) {
  return launch(k_dynwrite, dim3(copy_grid(1, B, kCopyThreads), 8), kCopyThreads, 0, stream, w,
                out, r, B);
}

// w needs at least 10 rows.
int fd_probe_take(const float* w, float* out, int B, void* stream) {
  return launch(k_take, copy_grid(8, B, kCopyThreads), kCopyThreads, 0, stream, w, out, B);
}

}  // extern "C"
