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
//   dma8          k_dma8, probe_mosaic_caps.py:39         k_dma8: one bulk copy of w[r:r+8]
//   dmagrp        k_dmagrp, :61                            k_dmagrp: the same from row 8*(r div 8)
//   vmemrow       k_vmemrow, :82                           k_vmemrow: row r of a staged w[:K]
//   vmem8         k_vmem8, :100                            k_vmem8: rows r..r+8 of it
//   acc           k_acc, :122                              k_acc: sum of 4 of its rows
//   onehot        k_onehot, :143                           k_onehot: sel @ w[:K] on tensor cores
//   dynwrite      k_dynwrite, :162                         k_dynwrite: zeros, row (r mod 8) <- w[0]
//   dmadyn_dst    k_dmadyn_dst, :185                       k_dmadyn_dst: bulk copy to a dynamic
//                                                          offset of a zeroed scratch
//   take          k_take, :205                             k_take: rows {3,1,4,1,5,9,2,6}
//
// What bounds them: at the probe's shapes (S = 4096, B = 512) each moves a
// few KB to 512 KB in one launch, so the launch and the first access's
// latency bound every one of them, not bandwidth.  The designs are the
// simple, right ones; a gridded version that reads many rows per launch at
// the copy roofline is later work.
//
// - dma8, dmagrp, dmadyn_dst: the TPU's HBM->VMEM async copy with a DMA
//   semaphore becomes a TMA bulk copy (cp.async.bulk global -> shared) whose
//   completion is counted in bytes on an mbarrier.  One block, one copy of
//   nrows * B * 4 contiguous bytes; addresses and size are 16-byte aligned.
//   The copy has no clamp: the wrapper raises on an out-of-range source.
//   The TPU's dmadyn_dst leaves the other scratch rows uninitialised (its
//   output is undefined unless rows[1] mod 4 == 0); here the scratch is
//   zero-filled first, so those output rows are 0.
// - vmemrow, vmem8, acc, onehot: the TPU kept the whole [K = 256, B] block
//   in VMEM (512 KB at B = 512), more than a block's 227 KB of shared
//   memory.  So each block stages a [K, 64]-column tile (72 KB with the row
//   stride padded to 72 floats, dynamic shared memory above 48 KB) over a
//   grid on B, and reads the dynamic rows from shared memory.  Row starts
//   are taken as lax.dynamic_slice takes them in the reference: a negative
//   start counts once from the end, then the start is clamped into
//   [0, K - size] (rows 256 and 1031 of the probe lie outside the block).
// - onehot: the MXU select becomes mma.sync m16n8k8 TF32 (M padded from 8
//   to 16 with zero rows of the selector).  The selector's 0 and 1 are exact
//   in TF32; w is rounded to TF32, so a result is exact for |integers| <
//   2^11 and within 2^-11 relative of w otherwise (one nonzero term).
// - dynwrite, take: one thread per column writes 8 rows; take's static row
//   list lives in __constant__ memory (a warp-uniform broadcast).
//
// Built with nvcc into a shared library with a plain C interface (see
// feynmandiagram_tpu_torch/ops/build.py), loaded through ctypes.  Every
// entry returns the cudaError_t of its launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

extern __shared__ __align__(16) float dyn_smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kTileCols = 64;                // columns of a staged tile
constexpr int kTileStride = kTileCols + 8;   // padded row stride, in floats

__constant__ int kTakeRows[8] = {3, 1, 4, 1, 5, 9, 2, 6};

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

// Copy n4 float4s from shared memory to out, the whole block.
__device__ __forceinline__ void store_out(float* out, const float* src, int64_t n4) {
  for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
    reinterpret_cast<float4*>(out)[i] = reinterpret_cast<const float4*>(src)[i];
  }
}

// Stage columns col0 .. col0 + kTileCols of w's first K rows into tile
// (row stride kTileStride); columns past B are zero.
__device__ void stage_tile(float* tile, const float* w, int K, int B, int col0) {
  constexpr int kVecs = kTileCols / 4;
  for (int i = threadIdx.x; i < K * kVecs; i += blockDim.x) {
    const int row = i / kVecs, c = (i % kVecs) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col0 + c < B) {
      v = *reinterpret_cast<const float4*>(w + static_cast<int64_t>(row) * B + col0 + c);
    }
    *reinterpret_cast<float4*>(tile + row * kTileStride + c) = v;
  }
  __syncthreads();
}

__global__ void k_dma8(const float* w, float* out, int64_t r, int B) {
  __shared__ uint64_t bar;
  bulk_load(dyn_smem, w + r * B, 8u * B * sizeof(float), &bar);
  store_out(out, dyn_smem, 2LL * B);
}

__global__ void k_dmagrp(const float* w, float* out, int64_t r, int B) {
  __shared__ uint64_t bar;
  const int64_t g = r >= 0 ? r / 8 : -((-r + 7) / 8);   // floor division
  bulk_load(dyn_smem, w + g * 8 * B, 8u * B * sizeof(float), &bar);
  store_out(out, dyn_smem, 2LL * B);
}

__global__ void k_dmadyn_dst(const float* w, float* out, int64_t r, int r1, int B) {
  __shared__ uint64_t bar;
  const int j = floor_mod(r1, 4);
  for (int i = threadIdx.x; i < 8 * B; i += blockDim.x) {   // 32 rows, as float4s
    reinterpret_cast<float4*>(dyn_smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  bulk_load(dyn_smem + static_cast<int64_t>(j) * 8 * B, w + r * 8 * B,
            8u * B * sizeof(float), &bar);
  store_out(out, dyn_smem, 2LL * B);
}

__global__ void k_vmemrow(const float* w, float* out, int r, int K, int B) {
  const int col0 = blockIdx.x * kTileCols;
  stage_tile(dyn_smem, w, K, B, col0);
  const int row = slice_start(r, K, 1);
  const int c = threadIdx.x;
  if (c < kTileCols && col0 + c < B) out[col0 + c] = dyn_smem[row * kTileStride + c];
}

__global__ void k_vmem8(const float* w, float* out, int r, int K, int B) {
  const int col0 = blockIdx.x * kTileCols;
  stage_tile(dyn_smem, w, K, B, col0);
  const int row0 = slice_start(r, K, 8);
  for (int i = threadIdx.x; i < 8 * kTileCols; i += blockDim.x) {
    const int row = i / kTileCols, c = i % kTileCols;
    if (col0 + c < B) {
      out[static_cast<int64_t>(row) * B + col0 + c] = dyn_smem[(row0 + row) * kTileStride + c];
    }
  }
}

__global__ void k_acc(const float* w, float* out, int r0, int r1, int r2, int r3, int K,
                      int B) {
  const int col0 = blockIdx.x * kTileCols;
  stage_tile(dyn_smem, w, K, B, col0);
  const int c = threadIdx.x;
  if (c < kTileCols && col0 + c < B) {
    // the reference's order: out = 0, then out += w[r_i] for i = 0..3
    float acc = 0.f;
    acc += dyn_smem[slice_start(r0, K, 1) * kTileStride + c];
    acc += dyn_smem[slice_start(r1, K, 1) * kTileStride + c];
    acc += dyn_smem[slice_start(r2, K, 1) * kTileStride + c];
    acc += dyn_smem[slice_start(r3, K, 1) * kTileStride + c];
    out[col0 + c] = acc;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// out[i, :] = sum_k sel[i, k] * w[k, :], sel[i, k] = (k == r + i), i < 8.
// Warp q of the block owns tile columns 8q .. 8q + 8; lane = 4 * g + t.
// Fragments of m16n8k8 (PTX ISA, tf32): A a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g);
// D d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1).
__global__ void k_onehot(const float* w, float* out, int r, int K, int B) {
  const int col0 = blockIdx.x * kTileCols;
  stage_tile(dyn_smem, w, K, B, col0);
  const int lane = threadIdx.x % 32, n0 = (threadIdx.x / 32) * 8;
  const int g = lane / 4, t = lane % 4;
  const uint32_t one = __float_as_uint(1.0f), zero = 0u;   // exact in tf32
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 8) {
    const uint32_t a0 = (k0 + t == r + g) ? one : zero;
    const uint32_t a2 = (k0 + t + 4 == r + g) ? one : zero;
    const uint32_t b0 = to_tf32(dyn_smem[(k0 + t) * kTileStride + n0 + g]);
    const uint32_t b1 = to_tf32(dyn_smem[(k0 + t + 4) * kTileStride + n0 + g]);
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(zero), "r"(a2), "r"(zero), "r"(b0), "r"(b1));
  }
  const int c = col0 + n0 + 2 * t;   // rows 8..15 (d[2], d[3]) are padding
  if (c < B) out[static_cast<int64_t>(g) * B + c] = d[0];
  if (c + 1 < B) out[static_cast<int64_t>(g) * B + c + 1] = d[1];
}

__global__ void k_dynwrite(const float* w, float* out, int r, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  for (int i = 0; i < 8; ++i) out[static_cast<int64_t>(i) * B + b] = 0.f;
  out[static_cast<int64_t>(floor_mod(r, 8)) * B + b] = w[b];
}

__global__ void k_take(const float* w, float* out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[static_cast<int64_t>(i) * B + b] = w[static_cast<int64_t>(kTakeRows[i]) * B + b];
  }
}

// Dynamic shared memory of a launch; the attribute is raised past the
// 48 KB default where it is needed.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

size_t tile_bytes(int K) { return static_cast<size_t>(K) * kTileStride * sizeof(float); }

unsigned col_blocks(int B, int per_block) { return (B + per_block - 1) / per_block; }

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), unsigned grid, size_t smem, void* stream,
           Args... args) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// w + r*B .. w + (r+8)*B -> out [8, B]; the caller checks 0 <= r <= S - 8.
int fd_probe_dma8(const float* w, float* out, long long r, int B, void* stream) {
  return launch(k_dma8, 1, 8 * B * sizeof(float), stream, w, out, r, B);
}

// rows 8*(r div 8) .. +8 -> out [8, B]; the caller checks the group.
int fd_probe_dmagrp(const float* w, float* out, long long r, int B, void* stream) {
  return launch(k_dmagrp, 1, 8 * B * sizeof(float), stream, w, out, r, B);
}

// rows 8r .. 8r+8 -> scratch rows 8j .. 8j+8 (j = r1 mod 4) of a zeroed
// [32, B] scratch; out = scratch[0:8].  The caller checks 0 <= 8r <= S - 8.
int fd_probe_dmadyn_dst(const float* w, float* out, long long r, int r1, int B,
                        void* stream) {
  return launch(k_dmadyn_dst, 1, 32 * B * sizeof(float), stream, w, out, r, r1, B);
}

int fd_probe_vmemrow(const float* w, float* out, int r, int K, int B, void* stream) {
  return launch(k_vmemrow, col_blocks(B, kTileCols), tile_bytes(K), stream, w, out, r, K, B);
}

int fd_probe_vmem8(const float* w, float* out, int r, int K, int B, void* stream) {
  return launch(k_vmem8, col_blocks(B, kTileCols), tile_bytes(K), stream, w, out, r, K, B);
}

int fd_probe_acc(const float* w, float* out, int r0, int r1, int r2, int r3, int K, int B,
                 void* stream) {
  return launch(k_acc, col_blocks(B, kTileCols), tile_bytes(K), stream, w, out, r0, r1, r2,
                r3, K, B);
}

// K must be a multiple of 8.
int fd_probe_onehot(const float* w, float* out, int r, int K, int B, void* stream) {
  return launch(k_onehot, col_blocks(B, kTileCols), tile_bytes(K), stream, w, out, r, K, B);
}

int fd_probe_dynwrite(const float* w, float* out, int r, int B, void* stream) {
  return launch(k_dynwrite, col_blocks(B, kThreads), 0, stream, w, out, r, B);
}

// w needs at least 10 rows.
int fd_probe_take(const float* w, float* out, int B, void* stream) {
  return launch(k_take, col_blocks(B, kThreads), 0, stream, w, out, B);
}

}  // extern "C"
