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
// - One launch per level.  The level's buckets are packed into one index
//   pool, one factor pool and a table of records (ops/kernels.py::
//   pack_level).  A row tile is 8 output rows of one bucket, an item a row
//   tile by 8 pieces of 32 * V batch columns, V the elements of a 16-byte
//   load; a record is a row tile and the pieces of the item that one block
//   takes.  One block of 8 warps per record and item, one warp per output
//   row; blocks stride over the level's items.  A single bucket
//   (fd_bucket_gather_reduce) is the same kernel with its one descriptor
//   passed by value.
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

// type codes of the C entry points
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
// and each row tile into records of the pieces that single.span names.
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
        break;  // the entry points and pack_level admit n_op 1..4 only
    }
  }
}

struct Launch {
  void* w;
  const void* src;          // rows the indices read: w itself, or another buffer
  const void* idx_pool;
  const void* fac_pool;
  const void* tiles;        // nullptr: one bucket, `single`
  Tile single;
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
      static_cast<const Tile*>(p.tiles), p.single, g, p.batch);
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
  if (p.n_records < 1 || p.batch < 1 || p.group_cols < 1) return cudaErrorInvalidValue;
  if (storage == kF32 && acc == kF32) return launch_ta<float, float>(p, compensated);
  if (storage == kF64 && acc == kF64) return launch_ta<double, double>(p, compensated);
  if (storage == kF32 && acc == kF64) return launch_ta<float, double>(p, compensated);
  if (storage == kBF16 && acc == kF32) return launch_ta<__nv_bfloat16, float>(p, compensated);
  return cudaErrorInvalidValue;
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).  storage and acc
// are TypeCodes of w's and the factors' types, one of the four pairs above;
// compensated selects the Kahan recurrence; group_cols is the width of a
// column group in elements.

// All buckets of a level: tiles is the [n_records, 8] int32 tile table; the
// indices read rows of src, which is w or a buffer of w's type and batch.
extern "C" int fd_level_gather_reduce(void* w, const void* src, const void* idx_pool,
                                      const void* fac_pool, const void* tiles, int n_records,
                                      long long batch, int storage, int acc, int compensated,
                                      long long group_cols, void* stream) {
  if (tiles == nullptr || src == nullptr) return cudaErrorInvalidValue;
  const Launch p{w, src, idx_pool, fac_pool, tiles, Tile{}, n_records,
                 batch, group_cols, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch(p, storage, acc, compensated));
}

// One bucket: idx [n_op, arity, count], fac [arity, count], rows from start;
// a block takes `pieces` (1, 2, 4 or 8) pieces of an item of one row tile.
extern "C" int fd_bucket_gather_reduce(void* w, const void* idx, const void* fac, int n_op,
                                       int arity, int count, long long batch, long long start,
                                       int storage, int acc, int compensated, int pieces,
                                       long long group_cols, void* stream) {
  if (n_op < 1 || n_op > kMaxOp || arity < 1 || count < 1 || start < 0 ||
      start + count > INT32_MAX || pieces < 1 || pieces > kItemPieces ||
      kItemPieces % pieces != 0) {
    return cudaErrorInvalidValue;
  }
  const Tile single{static_cast<int32_t>(start), 0, arity, n_op, 0, 0, count, pieces << 16};
  const Launch p{w, w, idx, fac, nullptr, single,
                 (count + kRows - 1) / kRows * (kItemPieces / pieces),
                 batch, group_cols, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch(p, storage, acc, compensated));
}
