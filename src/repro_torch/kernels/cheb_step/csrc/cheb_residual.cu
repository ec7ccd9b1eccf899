// The adaptive CPAA loop's chunk residual for Hopper (sm_90a). After each
// chunk of rounds the loop normalizes the accumulator's columns, takes the
// L1 distance of each column from the previous chunk's snapshot, and keeps
// the normalized accumulator as the next snapshot:
//
//   s = colsum(acc)                          (reduced over ranks outside)
//   norm = acc / (|s| < tiny ? tiny : s)     per column
//   resid[j] = sum_i |norm[i, j] - snap[i, j]| ;  snap <- norm (in place)
//
// Replaces no Pallas kernel: the reference's `colnorm` and residual
// (src/repro/core/pagerank.py:195-197, :233-234) are XLA reductions inside
// its while loop. Eager PyTorch took a sum, a quotient, a difference, an
// abs and a second sum: five passes and three [n, B] temporaries a chunk.
//
// Bound: acc, snap read once and snap written once (3 n B elements); this
// design reads acc twice, since the column sums must be all-reduced across
// ranks (sharded engines) before any element can be normalized. So two
// entry points, each two launches:
//   cheb_colsum:   s = colsum(acc)
//   cheb_residual: the quotient, the L1 sums and the new snapshot
// Each is a partial pass over a grid fixed by the shape (never by the SM
// count) and a join by one block in a fixed order, with no atomics: the
// same bits on every call. A partial-pass block is (lx, ly) threads: lx
// column units of 16-byte vectors (4 f32 or 2 f64 columns; single columns
// where B is not a multiple of the width or a pointer is unaligned) by ly
// rows, so a warp reads whole rows of [n, B] at B = 128. Each thread keeps
// its columns over its rows and adds in float64 (exact for an f32 input);
// the block then adds its ly row lanes in order. The join adds the blocks'
// partials in float64 and rounds once to the element type.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;            // partial-pass block
constexpr int kJoinThreads = 1024;       // the join's one block
constexpr int64_t kRowsPerBlock = 256;   // rows a block takes at least
constexpr int64_t kMaxBlocks = 1024;     // partial-pass blocks at most

// Partial-pass blocks (grid x) for `rows` rows: a function of rows alone.
inline int64_t blocks_for(int64_t rows) {
  const int64_t b = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T x[V];
};

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float narrow(double x, float*) {
  return __double2float_rn(x);
}
__device__ __forceinline__ double narrow(double x, double*) { return x; }

// s[k] += column k of one vector of acc
template <typename T, int V>
struct ColSum {
  const Pack<T, V>* __restrict__ acc;
  struct Item {
    Pack<T, V> a;
  };
  __device__ void init(int64_t) {}
  __device__ Item load(int64_t i) const { return Item{acc[i]}; }
  __device__ void consume(const Item& it, int64_t, double* s) const {
#pragma unroll
    for (int k = 0; k < V; ++k)
      s[k] = __dadd_rn(s[k], static_cast<double>(it.a.x[k]));
  }
};

// s[k] += |acc / guard(colsum) - snap| of column k; snap <- the quotient
template <typename T, int V>
struct Resid {
  const Pack<T, V>* __restrict__ acc;
  Pack<T, V>* __restrict__ snap;
  const T* __restrict__ colsum;   // [cols], already reduced over ranks
  T tiny;
  T guard[V];                     // this thread's columns' guarded sums
  struct Item {
    Pack<T, V> a, p;
  };
  __device__ void init(int64_t unit) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T s = colsum[unit * V + k];
      guard[k] = (s < T(0) ? -s : s) < tiny ? tiny : s;
    }
  }
  __device__ Item load(int64_t i) const { return Item{acc[i], snap[i]}; }
  __device__ void consume(const Item& it, int64_t i, double* s) const {
    Pack<T, V> norm;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      norm.x[k] = div_rn(it.a.x[k], guard[k]);
      const T d = sub_rn(norm.x[k], it.p.x[k]);
      s[k] = __dadd_rn(s[k], static_cast<double>(d < T(0) ? -d : d));
    }
    snap[i] = norm;
  }
};

// One block's float64 partial sums of its columns over its rows, written
// to partials[blockIdx.x, col]. Block (lx, ly): threadIdx.x is the column
// unit within the block's chunk blockIdx.y, threadIdx.y the row lane.
template <int V, class Op>
__global__ void __launch_bounds__(kThreads)
    cheb_residual_partial(Op op, int64_t rows, int64_t units,
                          int64_t cols, double* __restrict__ partials) {
  __shared__ double lanes[kThreads * 4];
  double s[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = 0.0;
  const int64_t unit = int64_t(blockIdx.y) * blockDim.x + threadIdx.x;
  if (unit < units) {
    op.init(unit);
    const int64_t step = int64_t(gridDim.x) * blockDim.y;
    int64_t r = int64_t(blockIdx.x) * blockDim.y + threadIdx.y;
    // four rows' loads in flight, consumed in row order
    for (; r + 3 * step < rows; r += 4 * step) {
      typename Op::Item it[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        it[q] = op.load((r + q * step) * units + unit);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        op.consume(it[q], (r + q * step) * units + unit, s);
    }
    for (; r < rows; r += step) {
      const int64_t i = r * units + unit;
      op.consume(op.load(i), i, s);
    }
  }
  const int width = blockDim.x * V;       // columns of this block's chunk
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < V; ++k) lanes[t * V + k] = s[k];
  __syncthreads();
  if (t < width) {
    double total = 0.0;
    for (int y = 0; y < static_cast<int>(blockDim.y); ++y)
      total = __dadd_rn(total, lanes[y * width + t]);
    const int64_t col = int64_t(blockIdx.y) * width + t;
    if (col < cols) partials[int64_t(blockIdx.x) * cols + col] = total;
  }
}

// out[c] = the sum over blocks of partials[b, c], in a fixed order: lane q
// of column c adds blocks q, q + lanes, ...; then lanes 0, 1, ... in turn.
template <typename T>
__global__ void __launch_bounds__(kJoinThreads)
    cheb_residual_join(const double* __restrict__ partials, int64_t blocks,
                       int64_t cols, T* __restrict__ out) {
  __shared__ double lanes[kJoinThreads];
  const int64_t cb = cols < kJoinThreads ? cols : kJoinThreads;
  const int64_t n_lanes = kJoinThreads / cb;
  const int64_t c = threadIdx.x % cb, q = threadIdx.x / cb;
  for (int64_t c0 = 0; c0 < cols; c0 += cb) {
    double total = 0.0;
    if (q < n_lanes && c0 + c < cols) {
#pragma unroll 8
      for (int64_t b = q; b < blocks; b += n_lanes)
        total = __dadd_rn(total, partials[b * cols + c0 + c]);
    }
    lanes[threadIdx.x] = total;
    __syncthreads();
    if (threadIdx.x < cb && c0 + threadIdx.x < cols) {
      double sum = 0.0;
      for (int64_t l = 0; l < n_lanes; ++l)
        sum = __dadd_rn(sum, lanes[l * cb + threadIdx.x]);
      out[c0 + threadIdx.x] = narrow(sum, static_cast<T*>(nullptr));
    }
    __syncthreads();
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int V, class Op, typename T>
int run(Op op, int64_t rows, int64_t cols, double* partials, T* out,
        cudaStream_t st) {
  const int64_t units = cols / V;
  const int lx = static_cast<int>(units < 32 ? units : 32);
  const int ly = kThreads / lx;
  const int64_t gy = (units + lx - 1) / lx;
  const int64_t gx = blocks_for(rows);
  cheb_residual_partial<V, Op><<<dim3(static_cast<unsigned>(gx),
                             static_cast<unsigned>(gy)),
                        dim3(lx, ly), 0, st>>>(op, rows, units, cols,
                                               partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cheb_residual_join<T><<<1, kJoinThreads, 0, st>>>(partials, gx, cols, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int colsum(const void* acc, int64_t rows, int64_t cols, void* partials,
           void* out, cudaStream_t st) {
  if (rows <= 0 || cols <= 0) return -1;
  constexpr int V = 16 / sizeof(T);
  auto* part = static_cast<double*>(partials);
  auto* o = static_cast<T*>(out);
  if (aligned16(acc) && cols % V == 0) {
    ColSum<T, V> op{static_cast<const Pack<T, V>*>(acc)};
    return run<V>(op, rows, cols, part, o, st);
  }
  ColSum<T, 1> op{static_cast<const Pack<T, 1>*>(acc)};
  return run<1>(op, rows, cols, part, o, st);
}

template <typename T>
int residual(const void* acc, void* snap, const void* s, double tiny,
             int64_t rows, int64_t cols, void* partials, void* out,
             cudaStream_t st) {
  if (rows <= 0 || cols <= 0) return -1;
  constexpr int V = 16 / sizeof(T);
  auto* part = static_cast<double*>(partials);
  auto* o = static_cast<T*>(out);
  const auto* sp = static_cast<const T*>(s);
  if (aligned16(acc) && aligned16(snap) && cols % V == 0) {
    Resid<T, V> op{static_cast<const Pack<T, V>*>(acc),
                   static_cast<Pack<T, V>*>(snap), sp, static_cast<T>(tiny),
                   {}};
    return run<V>(op, rows, cols, part, o, st);
  }
  Resid<T, 1> op{static_cast<const Pack<T, 1>*>(acc),
                 static_cast<Pack<T, 1>*>(snap), sp, static_cast<T>(tiny),
                 {}};
  return run<1>(op, rows, cols, part, o, st);
}

}  // namespace

// f64 elements of scratch `partials` that either entry point needs for a
// [rows, cols] array (host only).
extern "C" int64_t cheb_residual_partials(int64_t rows, int64_t cols) {
  return blocks_for(rows) * cols;
}

// acc: [rows, cols] contiguous f32 on the current device (cols = 1 for a
// vector); out: cols f32, the column sums (added in f64, rounded once).
// Launches on `stream`; returns cudaGetLastError() (0 = cudaSuccess).
extern "C" int cheb_colsum_f32(const void* acc, int64_t rows, int64_t cols,
                               void* partials, void* out, void* stream) {
  return colsum<float>(acc, rows, cols, partials, out,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int cheb_colsum_f64(const void* acc, int64_t rows, int64_t cols,
                               void* partials, void* out, void* stream) {
  return colsum<double>(acc, rows, cols, partials, out,
                        static_cast<cudaStream_t>(stream));
}

// acc, snap: [rows, cols] contiguous f32; s: the cols column sums of acc
// over every rank; out: cols f32, sum_i |acc / guard(s) - snap| (added in
// f64, rounded once); snap is overwritten with acc / guard(s).
extern "C" int cheb_residual_f32(const void* acc, void* snap, const void* s,
                                 double tiny, int64_t rows, int64_t cols,
                                 void* partials, void* out, void* stream) {
  return residual<float>(acc, snap, s, tiny, rows, cols, partials, out,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int cheb_residual_f64(const void* acc, void* snap, const void* s,
                                 double tiny, int64_t rows, int64_t cols,
                                 void* partials, void* out, void* stream) {
  return residual<double>(acc, snap, s, tiny, rows, cols, partials, out,
                          static_cast<cudaStream_t>(stream));
}
