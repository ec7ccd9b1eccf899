// Block-ELL SpMM for Hopper (sm_90a): y = P @ X with P in 128x128
// block-sparse ELL format (repro_torch.graph.structure.BlockEll).
//
// Replaces the TPU kernel src/repro/kernels/bsr_spmm/bsr_spmm.py
// (bsr_spmm_pallas + _kernel): there the grid is (row block, slot), the
// slot axis runs in order and the output tile stays resident in VMEM while
// the column-block id of every slot is scalar-prefetched.
//
//   y[i*128:(i+1)*128, :] = sum_s values[i, s] @ x[block_cols[i, s]*128 : +128, :]
//
// Design on Hopper. One CTA per (row block i, tile of BTC columns); the
// sequential slot axis becomes a loop inside the CTA, which loads
// block_cols[i, s] itself in place of the scalar prefetch. For each slot the
// 128x128 values tile and the matching 128xBTC x tile are staged through
// shared memory in depth-32 chunks, and every thread accumulates a TM x TN
// micro-tile of y in registers. y is written once at the end, so no
// zero-init pass is needed. Empty slots point at the diagonal with zero
// values (the format's invariant), so no mask is needed either.
//
// Bound. At the paper's NACA0015 size (8,125 row blocks, S = 8, BT = 128)
// one call reads 4.26 GB of tile values (1.27 ms at 3.35 TB/s) and does
// 2.7e11 flop of dense-tile FFMA (4.1 ms at 67 TFLOP/s FP32): this first
// version is bound by the FP32 FFMA rate. It stays in IEEE f32 (fmaf, no
// TF32) because parity with the reference needs 1e-5. Moving the product
// to the tensor cores (3xTF32 split, wgmma, TMA pipelining) is later work.
//
// Micro-tile layouts: rows ty + m*TY and columns tx + n*TX, so a warp reads
// consecutive shared-memory words of the x tile and broadcast words of the
// values tile (row stride 33 keeps the values-tile stores conflict-free).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kB = 128;   // tile edge (BlockEll.block); the wrapper checks it
constexpr int kKC = 32;   // depth of one shared-memory stage

template <int TM, int TN, int TX>
__global__ void __launch_bounds__(TX * (kB / TM))
bsr_spmm_kernel(const int32_t* __restrict__ block_cols,
                const float* __restrict__ values,
                const float* __restrict__ x,
                float* __restrict__ y,
                int slots, int bt) {
  constexpr int TY = kB / TM;
  constexpr int NT = TX * TY;
  constexpr int BTC = TX * TN;
  __shared__ float sA[kB][kKC + 1];
  __shared__ float sB[kKC][BTC];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t i = blockIdx.x;
  const int col0 = blockIdx.y * BTC;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  for (int s = 0; s < slots; ++s) {
    const int64_t cb = block_cols[i * slots + s];
    const float* tile = values + (i * slots + s) * int64_t(kB * kB);
    const float* xb = x + cb * kB * int64_t(bt);
    for (int kc = 0; kc < kB; kc += kKC) {
      for (int e = tid; e < kB * kKC; e += NT) {
        const int r = e / kKC, k = e % kKC;
        sA[r][k] = tile[r * kB + kc + k];
      }
      for (int e = tid; e < kKC * BTC; e += NT) {
        const int k = e / BTC, c = e % BTC;
        const int col = col0 + c;
        sB[k][c] = col < bt ? xb[int64_t(kc + k) * bt + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) a[m] = sA[ty + m * TY][k];
#pragma unroll
        for (int n = 0; n < TN; ++n) b[n] = sB[k][tx + n * TX];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
      }
      __syncthreads();
    }
  }

  float* yb = y + i * kB * int64_t(bt);
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = ty + m * TY;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int col = col0 + tx + n * TX;
      if (col < bt) yb[int64_t(r) * bt + col] = acc[m][n];
    }
  }
}

template <int TM, int TN, int TX>
cudaError_t launch(const int32_t* block_cols, const float* values,
                   const float* x, float* y, int n_rb, int slots, int bt,
                   cudaStream_t stream) {
  constexpr int NT = TX * (kB / TM);
  constexpr int BTC = TX * TN;
  const dim3 grid(n_rb, (bt + BTC - 1) / BTC);
  bsr_spmm_kernel<TM, TN, TX><<<grid, NT, 0, stream>>>(
      block_cols, values, x, y, slots, bt);
  return cudaGetLastError();
}

}  // namespace

// block_cols [n_rb, slots] int32, values [n_rb, slots, 128, 128] f32,
// x [n_rb*128, bt] f32, y [n_rb*128, bt] f32 (written, not read); all
// contiguous, on the current device. Launches on `stream` and returns
// cudaGetLastError() of the launch (0 = cudaSuccess).
extern "C" int bsr_spmm_f32(const void* block_cols, const void* values,
                            const void* x, void* y, int n_rb, int slots,
                            int bt, void* stream) {
  if (n_rb <= 0 || bt <= 0) return 0;
  const auto* bc = static_cast<const int32_t*>(block_cols);
  const auto* v = static_cast<const float*>(values);
  const auto* xp = static_cast<const float*>(x);
  auto* yp = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bt == 1) {
    err = launch<1, 1, 1>(bc, v, xp, yp, n_rb, slots, bt, st);   // SpMV
  } else if (bt <= 8) {
    err = launch<4, 1, 8>(bc, v, xp, yp, n_rb, slots, bt, st);
  } else if (bt <= 32) {
    err = launch<8, 2, 16>(bc, v, xp, yp, n_rb, slots, bt, st);
  } else {
    err = launch<8, 8, 16>(bc, v, xp, yp, n_rb, slots, bt, st);
  }
  return static_cast<int>(err);
}
