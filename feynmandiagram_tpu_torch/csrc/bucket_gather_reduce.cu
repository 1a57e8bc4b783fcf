// Gather-multiply-reduce over the slot-major weight buffer, one launch for
// all the buckets of a level.
//
// Replaces the Pallas TPU kernel feynmandiagram_tpu/ops/kernels.py:82
// (bucket_gather_reduce, body _bucket_kernel), generalised from one operand
// per term to n_op <= 4, so that it also computes the FusedBucket of
// sum_mode='fused' (feynmandiagram_tpu/ops/evaluator.py:88-106).  For every
// bucket (start, count, arity, n_op, idx, fac) of a level:
//
//     w[start + c, b] = sum_a fac[a, c] * prod_{k < n_op} w[idx[k, a, c], b]
//
// w is [num_slots, batch], row-major, in a storage type T; idx is int32
// [n_op, arity, count]; fac is [arity, count] in an accumulation type A.
// Gathered elements are widened from T to A, products and sums are taken in
// A, and the sum is rounded once to T on store.  The (T, A) pairs are those
// the JAX evaluator runs: (f32, f32), (f64, f64), (f32, f64) and
// (bf16, f32), the last its half-width-buffer mode
// (feynmandiagram_tpu/ops/evaluator.py:224-239).  Results go straight into
// rows start .. start+count of w (the TPU kernel returned a block that the
// caller copied in with dynamic_update_slice).  A level launch may read its
// rows from a second buffer `src` of w's type and batch (the halo of a
// graph-sharded level, feynmandiagram_tpu/parallel/graph_shard.py:442-472):
// idx then indexes rows of src, and the outputs still go to w.  Without one,
// src is w, and the caller guarantees that no idx entry of any bucket of the
// launch lies in the destination rows of any bucket of the launch
// (ops/evaluator.py::check_lowered): the launch reads and writes w, never the
// same row, and its items may run in any order.
//
// What bounds it on an H100: bytes.  A term costs n_op gathered rows of
// `batch` elements and ~2 flops per element read, far below the card's ridge
// point.  Counting each distinct input row of a level once and each output
// row once, an order-4 fused pass at batch 4096 in float32 moves 0.42 GB,
// 0.125 ms at 3.35 TB/s (chip_smoke.py computes the figure from the lowering
// it runs).  The buckets are small (a third have 8 output rows), a row is
// gathered several times within a level, and a block that gathers two rows
// and stores one waits for three dependent loads (its descriptor, its
// indices, the rows) with nothing in flight.  So the design is about filling
// the card from one launch, about the work a block does per wait, and about
// making the re-reads meet in L2:
//
// - One launch per level (a stretch of thin levels is one launch of the
//   column run, further down).  The level's buckets are packed into one index
//   pool, one factor pool and a table of records (ops/kernels.py::
//   pack_level).  A row tile is 8 output rows of one bucket, an item a row
//   tile by 8 pieces of 32 * V batch columns, V the elements of a 16-byte
//   load; a record is a row tile and the pieces of the item that one block
//   takes.  One block of 8 warps per record and item, one warp per output
//   row; blocks stride over the level's items.
// - A record is one 32-byte load, and its indices and factors are staged in
//   shared memory once per block, for all the pieces of the record.  A row
//   tile of many terms has a record per piece, so that its long chains of
//   gathers spread over many blocks; one of few terms, whose block would
//   wait for its record and its indices longer than it gathers, has records
//   of up to 4 pieces.  The wrapper picks the widest records that still
//   leave enough blocks to fill the card (ops/kernels.py::_record_width,
//   LevelTables.records_for).
// - The term loop is unrolled by 4: all 4 * n_op gathers of a group are
//   issued before the first multiply.
// - Items are ordered column-group-major: all records of the level for one
//   group of `group_cols` columns, then the next group; within a group the
//   items of one record side by side.  The wrapper sizes the group so that
//   the level's rows times the group's width sit inside the 50 MB L2, and a
//   row gathered by several buckets is fetched from memory once.  Row tiles
//   are sorted longest first (n_op * arity) by pack_level, so that a bucket
//   of 64 terms starts early and is not the tail of its group.
// - 16 bytes per thread per load (float4, double2, 8 x bf16) where w's base
//   and row pitch are 16-byte aligned; else the same body with V = 1.
// - Rows are read through a const __restrict__ pointer, `win` (src, or w):
//   no row read by a launch is written by it, so loads may pass the stores
//   of the pieces before.  With a separate src the two are two buffers.
// - n_op differs between items: a block-uniform switch into the body
//   templated on it.
//
// Rounding is that of the plain PyTorch version: __fmul_rn / __dmul_rn in A
// keep the compiler from contracting a product into an FMA with the sum;
// (w[idx0] * fac) * w[idx1] * ..., terms summed in order a = 0, 1, ..., the
// Kahan recurrence of feynmandiagram_tpu/ops/evaluator.py:36-51.  Padding
// terms (fac = 0, the constant-one row) are computed like any other.
// Widening (bf16 -> f32, f32 -> f64) is exact; narrowing rounds to nearest
// even (__float2bfloat16_rn, __double2float_rn), as PyTorch's .to() does.
//
// Built with nvcc into a shared library with a plain C interface (see
// feynmandiagram_tpu_torch/ops/kernels.py), loaded through ctypes.

#include <cstdint>
#include <cstring>
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

constexpr int kRows = 8;                  // output rows of an item, one warp each
constexpr int kThreads = 32 * kRows;
constexpr int kMaxOp = 4;
constexpr int kChunk = 64;                // terms staged in shared memory at a time
constexpr int kUnroll = 4;                // terms whose gathers are in flight together
constexpr int kItemPieces = 8;            // pieces of 32 lanes x 16 bytes across an item

// One record of the int32 tile table of ops/kernels.py::pack_level: a row
// tile and the pieces of an item that the record covers.  Rows dst ..
// dst+rows of w take the bucket's outputs c0 .. c0+rows; idx and fac point at
// the bucket's entries of output c0, whose tables have `count` outputs to a
// term; span is the first piece, in its low 16 bits, and above them the
// number of pieces.
struct alignas(16) Tile {
  int32_t dst, rows, arity, n_op, idx, fac, count, span;
};

// V elements of T moved as one load or store: 16 bytes where V > 1.
template <typename T, int V> struct Pack { T x[V]; };

template <typename T, int V> __device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  Pack<T, V> r;
  if constexpr (V == 1) {
    r.x[0] = *p;
  } else {
    static_assert(sizeof(T) * V == 16, "a vector load moves 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    memcpy(&r, &raw, 16);
  }
  return r;
}

template <typename T, int V> __device__ __forceinline__ void store_pack(T* p, const Pack<T, V>& r) {
  if constexpr (V == 1) {
    *p = r.x[0];
  } else {
    uint4 raw;
    memcpy(&raw, &r, 16);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// U terms, a .. a+U of the staged chunk, for this warp's row and this
// thread's V columns: all U * N_OP gathers first, then the products and the
// sum in term order.  s_idx is [k][a][row], s_fac [a][row], already offset
// to the row; `first` says that term a is the bucket's term 0.
template <typename T, typename A, int V, int N_OP, bool KAHAN, int U>
__device__ __forceinline__ void add_terms(const T* __restrict__ wcol, int64_t batch,
                                          const int32_t* s_idx, const A* s_fac, int a,
                                          bool first, A (&sum)[V], A (&comp)[V]) {
  Pack<T, V> v[U][N_OP];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < N_OP; ++k) {
      v[u][k] = load_pack<T, V>(
          wcol + static_cast<int64_t>(s_idx[(k * kChunk + a + u) * kRows]) * batch);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const A f = s_fac[(a + u) * kRows];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      A term = mul_rn(widen<A>(v[u][0].x[j]), f);
#pragma unroll
      for (int k = 1; k < N_OP; ++k) term = mul_rn(term, widen<A>(v[u][k].x[j]));
      if (first && u == 0) {
        sum[j] = term;
      } else if (KAHAN) {
        const A y = term - comp[j];
        const A t = sum[j] + y;
        comp[j] = (t - sum[j]) - y;
        sum[j] = t;
      } else {
        sum[j] = sum[j] + term;
      }
    }
  }
}

// One block's work: the row tile t, its `pieces` pieces of 32 * V columns
// from col0 on, one after the other.  Every thread of the block takes part
// in the staging, which is done once where the tile's terms fit one chunk.
template <typename T, typename A, int V, int N_OP, bool KAHAN>
__device__ __forceinline__ void run_tile(T* __restrict__ wout, const T* __restrict__ win,
                                         const int32_t* __restrict__ idx_pool,
                                         const A* __restrict__ fac_pool, const Tile& t,
                                         int64_t col0, int pieces, int64_t batch,
                                         int32_t* s_idx, A* s_fac) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t* idx = idx_pool + t.idx;
  const A* fac = fac_pool + t.fac;
  const bool one_chunk = t.arity <= kChunk;
  for (int p = 0; p < pieces; ++p) {
    const int64_t col = col0 + (static_cast<int64_t>(p) * 32 + lane) * V;
    const bool active = warp < t.rows && col < batch;
    A sum[V], comp[V];
#pragma unroll
    for (int j = 0; j < V; ++j) sum[j] = comp[j] = A(0);
    for (int a0 = 0; a0 < t.arity; a0 += kChunk) {
      const int na = t.arity - a0 < kChunk ? t.arity - a0 : kChunk;
      if (!one_chunk || p == 0) {   // block-uniform
        __syncthreads();            // the chunk staged before has been consumed
        for (int e = threadIdx.x; e < N_OP * na * kRows; e += kThreads) {
          const int r = e % kRows, ka = e / kRows;
          const int k = ka / na, a = ka - k * na;
          s_idx[(k * kChunk + a) * kRows + r] =
              r < t.rows ? idx[(static_cast<int64_t>(k) * t.arity + a0 + a) * t.count + r] : 0;
        }
        for (int e = threadIdx.x; e < na * kRows; e += kThreads) {
          const int r = e % kRows, a = e / kRows;
          s_fac[a * kRows + r] =
              r < t.rows ? fac[static_cast<int64_t>(a0 + a) * t.count + r] : A(0);
        }
        __syncthreads();
      }
      if (active) {
        const T* wcol = win + col;
        int a = 0;
        for (; a + kUnroll <= na; a += kUnroll) {
          add_terms<T, A, V, N_OP, KAHAN, kUnroll>(wcol, batch, s_idx + warp, s_fac + warp, a,
                                                   a0 + a == 0, sum, comp);
        }
        for (; a < na; ++a) {
          add_terms<T, A, V, N_OP, KAHAN, 1>(wcol, batch, s_idx + warp, s_fac + warp, a,
                                             a0 + a == 0, sum, comp);
        }
      }
    }
    if (active) {
      Pack<T, V> out;
#pragma unroll
      for (int j = 0; j < V; ++j) narrow_to(&out.x[j], sum[j]);
      store_pack<T, V>(wout + (static_cast<int64_t>(t.dst) + warp) * batch + col, out);
    }
  }
}

// The geometry of a launch.  An item is kItemPieces pieces of 32 * V columns
// wide; a record of the tile table covers some of them.  A column group is
// items_per_group items side by side.
struct Geometry {
  int n_records;
  int items_per_group;
  int64_t n_items;
};

// Items in order: column group, record, item of the group.  tiles ==
// nullptr: the launch has the one bucket `single`, cut here into row tiles
// and each row tile into records of the pieces that single.span names.  No
// entry launches that mode (fd_levels_gather_reduce refuses a null tile
// table).  The branch stays: without it nvcc allocated the kernel otherwise
// (more registers in one instantiation, new spills in two) and some levels'
// times moved by more than 1% either way (PERF.md §6).
template <typename T, typename A, int V, bool KAHAN>
__global__ void __launch_bounds__(kThreads)
gather_reduce_kernel(T* __restrict__ wout, const T* __restrict__ win,
                     const int32_t* __restrict__ idx_pool, const A* __restrict__ fac_pool,
                     const Tile* __restrict__ tiles, Tile single, Geometry g, int64_t batch) {
  __shared__ int32_t s_idx[kMaxOp * kChunk * kRows];
  __shared__ A s_fac[kChunk * kRows];
  const int64_t per_group = static_cast<int64_t>(g.n_records) * g.items_per_group;
  constexpr int64_t kItemCols = static_cast<int64_t>(kItemPieces) * (32 * V);
  for (int64_t item = blockIdx.x; item < g.n_items; item += gridDim.x) {
    const int64_t group = item / per_group;
    const int64_t rest = item - group * per_group;
    const int rec = static_cast<int>(rest / g.items_per_group);
    int64_t col0 =
        (group * g.items_per_group + (rest - static_cast<int64_t>(rec) * g.items_per_group)) *
        kItemCols;
    Tile t;
    if (tiles != nullptr) {
      t = tiles[rec];
    } else {
      const int pieces = single.span >> 16, parts = kItemPieces / pieces;
      const int c0 = rec / parts * kRows;
      t = single;
      t.dst += c0;
      t.rows = single.count - c0 < kRows ? single.count - c0 : kRows;
      t.idx = t.fac = c0;
      t.span = (rec % parts * pieces) | (pieces << 16);
    }
    col0 += static_cast<int64_t>(t.span & 0xffff) * (32 * V);
    if (col0 >= batch) continue;  // past the ragged end; block-uniform
    const int pieces = t.span >> 16;
    switch (t.n_op) {
      case 1:
        run_tile<T, A, V, 1, KAHAN>(wout, win, idx_pool, fac_pool, t, col0, pieces, batch,
                                    s_idx, s_fac);
        break;
      case 2:
        run_tile<T, A, V, 2, KAHAN>(wout, win, idx_pool, fac_pool, t, col0, pieces, batch,
                                    s_idx, s_fac);
        break;
      case 3:
        run_tile<T, A, V, 3, KAHAN>(wout, win, idx_pool, fac_pool, t, col0, pieces, batch,
                                    s_idx, s_fac);
        break;
      case 4:
        run_tile<T, A, V, 4, KAHAN>(wout, win, idx_pool, fac_pool, t, col0, pieces, batch,
                                    s_idx, s_fac);
        break;
      default:
        break;  // pack_level admits n_op 1..4 only
    }
  }
}

struct Launch {
  void* w;
  const void* src;          // rows the indices read: w itself, or another buffer
  const void* idx_pool;
  const void* fac_pool;
  const void* tiles;
  int n_records;
  int64_t batch;
  int64_t group_cols;       // width of a column group in elements, rounded down to
  cudaStream_t stream;      // whole items, at least one
};

template <typename T, typename A, int V, bool KAHAN> cudaError_t launch_v(const Launch& p) {
  const int64_t item_cols = static_cast<int64_t>(kItemPieces) * (32 * V);
  const int64_t items = (p.batch + item_cols - 1) / item_cols;   // across the batch
  int64_t per_group = p.group_cols / item_cols;
  if (per_group < 1) per_group = 1;
  if (per_group > items) per_group = items;
  const int64_t groups = (items + per_group - 1) / per_group;
  Geometry g;
  g.n_records = p.n_records;
  g.items_per_group = static_cast<int>(per_group);
  g.n_items = groups * per_group * p.n_records;
  const int64_t grid = g.n_items < INT32_MAX ? g.n_items : INT32_MAX;
  gather_reduce_kernel<T, A, V, KAHAN><<<static_cast<unsigned>(grid), kThreads, 0, p.stream>>>(
      static_cast<T*>(p.w), static_cast<const T*>(p.src),
      static_cast<const int32_t*>(p.idx_pool), static_cast<const A*>(p.fac_pool),
      static_cast<const Tile*>(p.tiles), Tile{}, g, p.batch);
  return cudaGetLastError();
}

template <typename T, typename A> cudaError_t launch_ta(const Launch& p, int compensated) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(p.w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.src) % 16 == 0 &&
                       (p.batch * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  if (aligned) {
    return compensated ? launch_v<T, A, kVec, true>(p) : launch_v<T, A, kVec, false>(p);
  }
  return compensated ? launch_v<T, A, 1, true>(p) : launch_v<T, A, 1, false>(p);
}

cudaError_t launch(const Launch& p, int storage, int acc, int compensated) {
  if (p.tiles == nullptr || p.n_records < 1 || p.batch < 1 || p.group_cols < 1) {
    return cudaErrorInvalidValue;
  }
  if (storage == kF32 && acc == kF32) return launch_ta<float, float>(p, compensated);
  if (storage == kF64 && acc == kF64) return launch_ta<double, double>(p, compensated);
  if (storage == kF32 && acc == kF64) return launch_ta<float, double>(p, compensated);
  if (storage == kBF16 && acc == kF32) return launch_ta<__nv_bfloat16, float>(p, compensated);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// A column run: a stretch of thin levels in one launch.
//
// A thin level moves a few MB, less than a launch's fixed cost: its kernel
// waits for its record, its indices and its rows, one after the other, then
// drains, and the next launch starts cold.  Every sample column is
// independent of the others, so a stretch of such levels runs as one
// launch in which each block owns a slice of `lanes` * V columns and walks
// the stretch's levels in order, a __syncthreads() between two levels.  A
// row that a level reads was written before the launch or by the same
// block, at the same columns, in an earlier level: no block waits for
// another, nothing needs co-residency, and across the card the blocks form
// a pipeline rather than a lockstep.
//
// Within a level a thread group of `lanes` threads takes a row, the groups
// stride over the level's rows.  A row is its list of gathers: term a's
// operands k = 0 .. n_op - 1 in turn, the first flagged in bit 31 of its
// index and carrying the term's factor.  The first kRunGathers of them sit
// in the row's record (RunRow) with their factors beside it, the others in
// the extra pools; a thread loads the record of its next row while the
// gathers of the current one are in flight, so that a level costs one
// dependent wait, the rows.  A row's value is that of run_tile, bit for bit:
// (w[i0] * fac) * w[i1] * ..., terms added in order, plain or Kahan, in A,
// rounded once to T.  Rows are read with ld.global.cg, through L2: a row
// written inside the launch must never come through the non-coherent
// read-only path.

constexpr int kRunGathers = 4;            // gathers held in a row's record
constexpr int kRunMaxThreads = 512;

// A row of a column run: its row of w, its gathers, where those past the
// first kRunGathers begin in the extra pools, and the first gathers' row
// indices, bit 31 set where a gather starts a term (unused ones 0).
struct alignas(16) RunRow {
  int32_t dst, n_gathers, rest, pad;
  int32_t idx[kRunGathers];
};

template <typename T, int V> __device__ __forceinline__ Pack<T, V> load_cg(const T* p) {
  Pack<T, V> r;
  if constexpr (V > 1) {
    uint4 x;
    asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w) : "l"(p) : "memory");
    memcpy(&r, &x, 16);
  } else if constexpr (sizeof(T) == 8) {
    uint64_t x;
    asm volatile("ld.global.cg.u64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
    memcpy(&r, &x, 8);
  } else if constexpr (sizeof(T) == 4) {
    uint32_t x;
    asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(x) : "l"(p) : "memory");
    memcpy(&r, &x, 4);
  } else {
    unsigned short x;
    asm volatile("ld.global.cg.u16 %0, [%1];" : "=h"(x) : "l"(p) : "memory");
    memcpy(&r, &x, 2);
  }
  return r;
}

template <typename A> __device__ __forceinline__ void load_facs(const A* p, A (&f)[kRunGathers]) {
  if constexpr (sizeof(A) == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
  } else {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p));
    const double2 y = __ldg(reinterpret_cast<const double2*>(p) + 1);
    f[0] = x.x, f[1] = x.y, f[2] = y.x, f[3] = y.y;
  }
}

// A row's running sum: the term being multiplied and the terms added.
template <typename A, int V, bool KAHAN> struct RowSum {
  A term[V] = {}, sum[V] = {}, comp[V] = {};
  bool open = false, added = false;

  __device__ __forceinline__ void close() {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (!added) {
        sum[j] = term[j];
        comp[j] = A(0);
      } else if (KAHAN) {
        const A y = term[j] - comp[j];
        const A t = sum[j] + y;
        comp[j] = (t - sum[j]) - y;
        sum[j] = t;
      } else {
        sum[j] = sum[j] + term[j];
      }
    }
    added = true;
  }

  // n (<= kRunGathers) gathers in order: their values, flagged indices and
  // factors
  template <typename T>
  __device__ __forceinline__ void take(const Pack<T, V> (&v)[kRunGathers],
                                       const int32_t (&ix)[kRunGathers],
                                       const A (&f)[kRunGathers], int n) {
#pragma unroll
    for (int g = 0; g < kRunGathers; ++g) {
      if (g < n) {
        const bool starts = ix[g] < 0;
        if (starts && open) close();
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const A x = widen<A>(v[g].x[j]);
          term[j] = starts ? mul_rn(x, f[g]) : mul_rn(term[j], x);
        }
        open = true;
      }
    }
  }
};

// up to kRunGathers of a row's extra gathers, from `at` on, where m > 0
template <typename A>
__device__ __forceinline__ void load_extra(const int32_t* __restrict__ extra_idx,
                                           const A* __restrict__ extra_fac, int at, int m,
                                           int32_t (&ix)[kRunGathers], A (&f)[kRunGathers]) {
#pragma unroll
  for (int g = 0; g < kRunGathers; ++g) {
    ix[g] = g < m ? __ldg(extra_idx + at + g) : 0;
    f[g] = g < m ? __ldg(extra_fac + at + g) : A(0);
  }
}

template <typename T, int V>
__device__ __forceinline__ void gather(const T* wcol, int64_t batch,
                                       const int32_t (&ix)[kRunGathers], int n,
                                       Pack<T, V> (&v)[kRunGathers]) {
#pragma unroll
  for (int g = 0; g < kRunGathers; ++g) {
    if (g < n) v[g] = load_cg<T, V>(wcol + static_cast<int64_t>(ix[g] & 0x7fffffff) * batch);
  }
}

// level_rows[l] .. level_rows[l + 1] are level l's rows of `rows`; a block
// of `blockDim.x` threads owns the columns blockIdx.x * lanes * V ..
// + lanes * V, lanes = 1 << lanes_log2 threads a row.
template <typename T, typename A, int V, bool KAHAN>
__global__ void __launch_bounds__(kRunMaxThreads)
column_run_gather_reduce_kernel(T* w, const int32_t* __restrict__ level_rows,
                                const RunRow* __restrict__ rows, const A* __restrict__ row_fac,
                                const int32_t* __restrict__ extra_idx,
                                const A* __restrict__ extra_fac, int n_levels, int lanes_log2,
                                int64_t batch) {
  const int groups = blockDim.x >> lanes_log2;
  const int group = threadIdx.x >> lanes_log2;
  const int64_t col =
      ((static_cast<int64_t>(blockIdx.x) << lanes_log2) + (threadIdx.x & ((1 << lanes_log2) - 1))) *
      V;
  const bool active = col < batch;   // V > 1 only where batch is a multiple of V
  T* const wcol = w + col;
  const int4* const rec = reinterpret_cast<const int4*>(rows);

  // the record of the thread's next row, loaded ahead
  int4 head = make_int4(0, 0, 0, 0), ids = head;
  A fac[kRunGathers];
  bool ready = false;
  auto fetch = [&](int r) {
    head = __ldg(rec + 2 * r);
    ids = __ldg(rec + 2 * r + 1);
    load_facs<A>(row_fac + static_cast<int64_t>(kRunGathers) * r, fac);
    ready = true;
  };

  int r_begin = __ldg(level_rows);
  for (int l = 0; l < n_levels; ++l) {
    const int r_end = __ldg(level_rows + l + 1);
    const int r_after = l + 1 < n_levels ? __ldg(level_rows + l + 2) : r_end;
    if (active) {
      for (int r = r_begin + group; r < r_end; r += groups) {
        if (!ready) fetch(r);
        const int dst = head.x, n = head.y, rest = head.z;
        const int32_t ix[kRunGathers] = {ids.x, ids.y, ids.z, ids.w};
        A f[kRunGathers];
#pragma unroll
        for (int g = 0; g < kRunGathers; ++g) f[g] = fac[g];
        Pack<T, V> v[kRunGathers];
        gather<T, V>(wcol, batch, ix, n, v);
        // the next row's record: this level's next, else the next level's first
        ready = false;
        if (r + groups < r_end) {
          fetch(r + groups);
        } else if (r_end + group < r_after) {
          fetch(r_end + group);
        }
        // the indices of the first extra gathers, while the first are in flight
        int32_t jx[kRunGathers];
        A jf[kRunGathers];
        load_extra<A>(extra_idx, extra_fac, rest, n - kRunGathers, jx, jf);
        RowSum<A, V, KAHAN> s;
        s.template take<T>(v, ix, f, n);
        for (int g0 = kRunGathers; g0 < n; g0 += kRunGathers) {
          const int m = n - g0 < kRunGathers ? n - g0 : kRunGathers;
          gather<T, V>(wcol, batch, jx, m, v);
          int32_t kx[kRunGathers];
          A kf[kRunGathers];
#pragma unroll
          for (int g = 0; g < kRunGathers; ++g) kx[g] = jx[g], kf[g] = jf[g];
          load_extra<A>(extra_idx, extra_fac, rest + g0, n - g0 - kRunGathers, jx, jf);
          s.template take<T>(v, kx, kf, m);
        }
        s.close();
        Pack<T, V> out;
#pragma unroll
        for (int j = 0; j < V; ++j) narrow_to(&out.x[j], s.sum[j]);
        store_pack<T, V>(wcol + static_cast<int64_t>(dst) * batch, out);
      }
      if (!ready && r_end + group < r_after) fetch(r_end + group);
    }
    r_begin = r_end;
    __syncthreads();   // the level's rows are written before the next one reads them
  }
}

struct RunLaunch {
  void* w;
  const void* level_rows;
  const void* rows;
  const void* row_fac;
  const void* extra_idx;
  const void* extra_fac;
  int n_levels;
  int lanes_log2;
  int threads;
  int64_t batch;
  cudaStream_t stream;
};

template <typename T, typename A, int V, bool KAHAN> cudaError_t launch_run_v(const RunLaunch& p) {
  const int64_t slice = (static_cast<int64_t>(1) << p.lanes_log2) * V;
  const int64_t blocks = (p.batch + slice - 1) / slice;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  column_run_gather_reduce_kernel<T, A, V, KAHAN>
      <<<static_cast<unsigned>(blocks), p.threads, 0, p.stream>>>(
          static_cast<T*>(p.w), static_cast<const int32_t*>(p.level_rows),
          static_cast<const RunRow*>(p.rows), static_cast<const A*>(p.row_fac),
          static_cast<const int32_t*>(p.extra_idx), static_cast<const A*>(p.extra_fac),
          p.n_levels, p.lanes_log2, p.batch);
  return cudaGetLastError();
}

template <typename T, typename A> cudaError_t launch_run_ta(const RunLaunch& p, int compensated) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(p.w) % 16 == 0 &&
                       (p.batch * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  if (aligned) {
    return compensated ? launch_run_v<T, A, kVec, true>(p) : launch_run_v<T, A, kVec, false>(p);
  }
  return compensated ? launch_run_v<T, A, 1, true>(p) : launch_run_v<T, A, 1, false>(p);
}

cudaError_t launch_run(const RunLaunch& p, int storage, int acc, int compensated) {
  if (p.n_levels < 1 || p.batch < 1 || p.lanes_log2 < 0 || p.lanes_log2 > 5 ||
      p.threads < 32 || p.threads > kRunMaxThreads || p.threads % 32 != 0 ||
      p.threads >> p.lanes_log2 < 1 || p.level_rows == nullptr || p.rows == nullptr ||
      p.row_fac == nullptr || p.extra_idx == nullptr || p.extra_fac == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (storage == kF32 && acc == kF32) return launch_run_ta<float, float>(p, compensated);
  if (storage == kF64 && acc == kF64) return launch_run_ta<double, double>(p, compensated);
  if (storage == kF32 && acc == kF64) return launch_run_ta<float, double>(p, compensated);
  if (storage == kBF16 && acc == kF32) return launch_run_ta<__nv_bfloat16, float>(p, compensated);
  return cudaErrorInvalidValue;
}

}  // namespace

// A run of levels, in order, on one stream: row i of the host table,
// [n_launches, 8] int64, is one launch.  A row whose field 5 is 0 launches
// one level, all its buckets, from (idx_pool, fac_pool, tiles, n_records,
// group_cols, 0, 0, 0): tiles is the level's [n_records, 8] int32 tile
// table, group_cols the width of a column group in elements, and the
// indices read rows of src, which is w or a buffer of w's type and batch.
// A row whose field 5 is n >= 1 launches a column run of n levels from
// (rows, row_fac, level_rows, n_rows, lanes_log2 | threads << 8, n,
// extra_idx, extra_fac); it reads w itself, and src must be w.  storage and
// acc are TypeCodes of w's and the factors' types, one of the four pairs
// above; compensated selects the Kahan recurrence.  Returns the
// cudaError_t of the first failed launch (0 on success), which stops the
// run, and writes its row to *failed.
extern "C" int fd_levels_gather_reduce(void* w, const void* src, const long long* table,
                                       int n_launches, long long batch, int storage, int acc,
                                       int compensated, void* stream, int* failed) {
  for (int i = 0; i < n_launches; ++i) {
    const long long* row = table + 8 * static_cast<int64_t>(i);
    cudaError_t err;
    if (row[5] == 0) {
      const Launch p{w, src, reinterpret_cast<const void*>(row[0]),
                     reinterpret_cast<const void*>(row[1]), reinterpret_cast<const void*>(row[2]),
                     static_cast<int>(row[3]), batch, row[4], static_cast<cudaStream_t>(stream)};
      err = src == nullptr ? cudaErrorInvalidValue : launch(p, storage, acc, compensated);
    } else {
      const RunLaunch p{w, reinterpret_cast<const void*>(row[2]),
                        reinterpret_cast<const void*>(row[0]),
                        reinterpret_cast<const void*>(row[1]),
                        reinterpret_cast<const void*>(row[6]),
                        reinterpret_cast<const void*>(row[7]), static_cast<int>(row[5]),
                        static_cast<int>(row[4] & 0xff), static_cast<int>(row[4] >> 8), batch,
                        static_cast<cudaStream_t>(stream)};
      err = src != w ? cudaErrorInvalidValue : launch_run(p, storage, acc, compensated);
    }
    if (err != cudaSuccess) {
      *failed = i;
      return static_cast<int>(err);
    }
  }
  return 0;
}
