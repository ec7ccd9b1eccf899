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
// Two variants; the wrapper picks one by the width BT of x (a dispatch by
// shape, `variant()` in ../ops.py, cut where the two cross on the H100):
//
// * BT >= 2: tensor cores, 3xTF32 `wgmma`, fed by a TMA ring.
// * BT = 1 (SpMV): IEEE-f32 FFMA from shared-memory tiles, one thread per
//   row. A tile carries half a flop per byte read; both variants are bound
//   by the bytes of the tiles, and this one streams them with less
//   overhead. It takes any BT, one column of x per grid.y, for comparisons.
//
// Bound. At the paper's NACA0015 size (8,125 row blocks, S = 8, BT = 128)
// one call must read 4.26 GB of tile values plus x and y once each: 5.33 GB,
// 1.59 ms at 3.35 TB/s. The dense-tile product is 2.73e11 flop; in 3xTF32
// that is 8.2e11 tensor flop, 1.65 ms at the 495 TFLOP/s TF32 peak -- about
// the same time, so the design has to keep both the HBM stream and the
// tensor cores busy at once. (99.4% of those flops multiply zero fill; only
// a sparser in-tile format or fewer bits per value would move fewer bytes.)
//
// Precision. Parity with the reference is rtol/atol 1e-5, which one TF32
// pass misses (it keeps 11 significant bits). Each operand v is split into
// hi = tf32(v) and lo = tf32(v - hi) (v - hi is exact in f32), and three
// products are summed, lo*hi, hi*lo, hi*hi, as in CUTLASS's 3xTF32
// (mma_tensor_op_fast_f32.h), though into two accumulators (see below). For x
// both parts round to nearest, ties away from zero (cvt.rna.tf32.f32's
// rule, done with integer instructions), which halves |lo| against
// truncation at no extra cost in registers. For the values, hi is the
// truncation: the tensor cores read a raw f32 operand as tf32 by dropping
// its low 13 bits (on the H100 this gives the same error as an explicit
// split), so the TMA'd chunk serves as hi unchanged and only lo =
// tf32(v - trunc(v)) is written. The dropped lo*lo term is below 2^-22 of
// |a*b|.
//
// Tensor-core design, with the product written transposed,
// y^T = X^T V^T (M = columns of x, N = 128 rows of the tile, K = 128):
//
// * wgmma takes 32-bit operands from shared memory only K-major. A values
//   tile [128 rows][128 k] is K-major as stored, so it is operand B straight
//   from TMA, in [128 rows x 32 k] chunks of 128-byte rows with the 128-byte
//   swizzle the descriptor names. An x tile [128 k][BT] is not K-major; it
//   becomes operand A from registers, where the transpose and the hi/lo
//   split cost nothing extra. Only the values chunk needs a pass through
//   shared memory: the consumers write its lo part beside it.
//   (The other formulation, y = V X, would need a transposed, split copy of
//   every x tile in shared memory.) M is 64 per warpgroup, so below BT = 64
//   tensor rows are wasted; there the kernel is bound by the bytes anyway.
// * A ring of 3 stages (on the H100 deeper rings of 4 to 7 ran slower and
//   2 starved the loads), each a values chunk and the matching [32 k x BTC]
//   x chunk, both brought by TMA in the 128-byte swizzle (x in [32 x 32]
//   boxes, only those that hold columns < BT; TMA zero-fills past BT); the
//   lo copies of the values take 3 more buffers. TMA needs x's rows
//   16-byte aligned: the wrapper hands this variant an x of BT % 4 == 0 at
//   a 16-byte aligned base (ops.py pads any other x). One producer warp
//   reads block_cols[i, s] itself (in place of the TPU's scalar prefetch),
//   one slot per lane, broadcast by shuffle; its first lane waits for a
//   free stage and issues the TMAs against the stage's "full" mbarrier
//   (the rest of the producer warpgroup only gives up its registers).
//   One or two consumer warpgroups (64 columns of x each) split, multiply,
//   and release the stage on its "empty" mbarrier once their wgmmas of it
//   have completed. A chunk's values are split while the wgmmas of the
//   previous chunk run; the x fragments are split one k-step ahead of the
//   wgmmas that read them (A registers double-buffered by k-step). With two
//   consumer warpgroups, setmaxnreg moves registers from the producer (24)
//   to the consumers (240): they hold three accumulators.
// * The tensor cores truncate as they accumulate, and the loss grows with
//   the number of wgmmas that add into a large accumulator. On the H100 one
//   accumulator over all of a row block's 8 x 48 wgmmas lost several times
//   more than IEEE f32 summation; one per slot for all three products still
//   missed 1e-5 against IEEE f32 where row sums cancel. So the hi*hi terms
//   of each slot (16 wgmmas) go into `part`, which is added into `acc` with
//   IEEE f32 adds, and the lo*hi and hi*lo terms, 2^-10 as large, go into
//   a second accumulator `cross` for the whole work item, added in at the
//   end. (Holding `acc` in shared memory instead, to spare registers, ran
//   slower on the H100 at every width.)
// * Persistent CTAs, one per SM, each walking work items (row block, tile
//   of 64 or 128 columns) b, b + gridDim.x, ... in row-block order: the
//   graph is BFS-ordered, so block_cols lie near the diagonal and the CTAs
//   in flight share their x tiles in the 50 MB L2 (x at paper size is
//   532 MB and each x tile is read S = 8 times). The ring runs on from one
//   item to the next, so an item's epilogue overlaps the next one's loads;
//   the producer reads a row block's block_cols once.
// * Epilogue: every thread stores its accumulators once, masked at column
//   BT; each store instruction of a warp writes whole 32-byte sectors (8
//   consecutive columns of 4 rows). No zero-init pass: y is written, not
//   read. Empty slots point at the diagonal with zero values (the format's
//   invariant), so no slot mask is needed.
//
// The tensor maps come from cuTensorMapEncodeTiled, looked up through
// cudaGetDriverEntryPointByVersion, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kB = 128;   // tile edge (BlockEll.block); the wrapper checks it
constexpr int kKC = 32;   // depth of one shared-memory stage (both variants)

// ------------------------------------------------------------ FFMA, BT = 1 --
// One thread per row of the row block, one column of x per grid.y: the
// tile chunk and the x chunk go through shared memory (row stride 33 keeps
// the tile stores conflict-free), each thread sums its row in k order.
__global__ void __launch_bounds__(kB)
bsr_spmv_kernel(const int32_t* __restrict__ block_cols,
                const float* __restrict__ values,
                const float* __restrict__ x, float* __restrict__ y,
                int slots, int bt) {
  __shared__ float sA[kB][kKC + 1];
  __shared__ float sx[kKC];
  const int r = threadIdx.x;
  const int64_t i = blockIdx.x;
  const int col = blockIdx.y;
  float acc = 0.f;
  for (int s = 0; s < slots; ++s) {
    const int64_t cb = block_cols[i * slots + s];
    const float* tile = values + (i * slots + s) * int64_t(kB * kB);
    const float* xb = x + cb * kB * int64_t(bt) + col;
    for (int kc = 0; kc < kB; kc += kKC) {
      for (int e = r; e < kB * kKC; e += kB)
        sA[e / kKC][e % kKC] = tile[(e / kKC) * kB + kc + e % kKC];
      if (r < kKC) sx[r] = xb[int64_t(kc + r) * bt];
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) acc = fmaf(sA[r][k], sx[k], acc);
      __syncthreads();
    }
  }
  y[(i * kB + r) * int64_t(bt) + col] = acc;
}

cudaError_t launch_spmv(const int32_t* block_cols, const float* values,
                        const float* x, float* y, int n_rb, int slots,
                        int bt, cudaStream_t stream) {
  bsr_spmv_kernel<<<dim3(n_rb, bt), kB, 0, stream>>>(block_cols, values, x,
                                                       y, slots, bt);
  return cudaGetLastError();
}

// ------------------------------------------------------ PTX for the TC path --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// wait of more than ~1e10 cycles (seconds; a stage takes microseconds) can
// only be a broken pipeline: trap, so that the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 10000000000LL) __trap();
  }
}

// TMA: the box at (c0 = column, c1 = row) of `map` into shared memory,
// completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// f32 -> tf32, to nearest with ties away from zero: the rounding of
// cvt.rna.tf32.f32 in two integer instructions (add half an ulp to the
// magnitude, clear the low 13 bits), which run at full rate where the
// conversion would queue on the slower conversion unit.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// lo part of a value whose hi part is its truncation to tf32.
__device__ __forceinline__ float lo_of_truncated(float v) {
  return __uint_as_float(
      tf32_rna(v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u)));
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: 8-row groups 1024 bytes apart (SBO), leading offset unused (1).
// The chunk base is 1024-byte aligned, so the base offset is 0; a k-step of
// 8 tf32 (32 bytes) adds 2 to the start address (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// d[64x128] = a[64x8] (registers, tf32) * b[8x128] (shared memory, tf32,
// K-major) + (keep_d ? d : 0). Fragment of a: a[v] holds (row 16*warp +
// lane/4 + 8*(v%2), k = lane%4 + 4*(v/2)); of d: d[v] holds (row 16*warp +
// lane/4 + 8*((v/2)%2), column 8*(v/4) + 2*(lane%4) + v%2).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b,
                                                     int keep_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(keep_d));
}

// ------------------------------------------- tensor cores, 3xTF32, BT >= 2 --
constexpr int kLoBufs = 3;                             // see tc_prepare
constexpr int kChunk = kB * kKC;                       // floats per chunk
constexpr uint32_t kChunkBytes = kChunk * sizeof(float);  // 16 KB
constexpr int kXBox = kKC * 32;                        // [32 k x 32 columns]
constexpr uint32_t kXBoxBytes = kXBox * sizeof(float);    // 4 KB

template <int NWG>
struct TcSmem {
  static constexpr int BTC = 64 * NWG;     // columns of x per work item
  static constexpr int XBOXES = BTC / 32;
  static constexpr int STAGES = 3;   // deeper rings measured slower
  alignas(1024) float vhi[STAGES][kChunk];   // TMA target: raw values = hi
  alignas(1024) float vlo[kLoBufs][kChunk];
  alignas(1024) float xs[STAGES][XBOXES * kXBox];   // 128B-swizzled boxes
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

template <int NWG>
constexpr size_t tc_smem_bytes() {
  return sizeof(TcSmem<NWG>) + 1024;       // + room to align the base
}

// Float offset of x chunk element (row k, column c) in a stage: 32-column
// boxes of 128-byte rows whose 16-byte groups are XORed with k % 8, the
// layout TMA's 128-byte swizzle writes.
// A warp's fragment loads then meet at most 2 to a bank.
__device__ __forceinline__ int xs_offset(int k, int c) {
  const int cc = c & 31;
  return (c >> 5) * kXBox + k * 32 + ((((cc >> 2) ^ (k & 7)) << 2) | (cc & 3));
}

// Wait for ring chunk g and write the lo parts of its values into
// vlo[g % 3]. That buffer was last read by chunk g - 3, whose wgmmas every
// warpgroup had waited for before it passed the barrier of chunk g - 1
// (a warpgroup leaves chunk g - 2 having waited for chunk g - 3).
// The hi parts need no pass: the tensor cores read a raw f32 operand as
// tf32 by dropping its low 13 bits, so hi is the truncation of v and
// lo = tf32(v - hi) is formed from the same rule.
template <int NWG>
__device__ __forceinline__ void tc_prepare(TcSmem<NWG>& sm, uint32_t g,
                                           int ctid) {
  constexpr int NCONS = 128 * NWG;
  constexpr int S = TcSmem<NWG>::STAGES;
  const int st = g % S;
  mbar_wait(&sm.full[st], (g / S) & 1);
  const float4* vh = reinterpret_cast<const float4*>(sm.vhi[st]);
  float4* vl = reinterpret_cast<float4*>(sm.vlo[g % kLoBufs]);
#pragma unroll
  for (int q = 0; q < kChunk / 4 / NCONS; ++q) {
    const int e = ctid + q * NCONS;
    const float4 v = vh[e];
    vl[e] = make_float4(lo_of_truncated(v.x), lo_of_truncated(v.y),
                        lo_of_truncated(v.z), lo_of_truncated(v.w));
  }
  fence_proxy_async();          // generic-proxy writes -> wgmma's reads
  bar_sync(1, NCONS);
}

// One k-step (8 deep) of chunk g: this thread's x fragments, split into
// a, then the two small products into `cross` and hi*hi into `part` (a
// wgmma overwrites its accumulator when its `keep` is 0), committed as one
// group and not waited for here. xoff holds xs_offset of the fragment's
// (row t or t + 4, column m or m + 8) at k = 0.
template <int NWG>
__device__ __forceinline__ void tc_kstep(TcSmem<NWG>& sm, uint32_t g, int kk,
                                         const int (&xoff)[4], int keep,
                                         int keep_cross, float (&part)[64],
                                         float (&cross)[64],
                                         uint32_t (&a)[2][4]) {
  const int st = g % TcSmem<NWG>::STAGES;
  const float* xk = sm.xs[st] + 8 * kk * 32;      // rows 8kk .. 8kk + 7
#pragma unroll
  for (int f = 0; f < 4; ++f) split_tf32(xk[xoff[f]], a[0][f], a[1][f]);
  wgmma_fence();
  const uint64_t dh = sw128_desc(sm.vhi[st]) + 2 * kk;
  const uint64_t dl = sw128_desc(sm.vlo[g % kLoBufs]) + 2 * kk;
  wgmma_m64n128k8_tf32(cross, a[1], dh, keep_cross);
  wgmma_m64n128k8_tf32(cross, a[0], dl, 1);
  wgmma_m64n128k8_tf32(part, a[0], dh, keep);
  wgmma_commit();
}

// Keeps the compiler from moving reads of accumulators above a wait.
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int v = 0; v < 64; ++v) asm volatile("" : "+f"(r[v]) :: "memory");
}

// Persistent: CTA b takes the work items b, b + gridDim.x, ... in order; an
// item is (row block, tile of BTC columns), the column tiles of one row
// block adjacent. The ring runs on across items (chunk counter g), so one
// item's epilogue overlaps the next item's loads. Only the x boxes that
// hold columns < BT are loaded (columns past BT reach only rows of the
// product that the epilogue masks).
template <int NWG>
__global__ void __launch_bounds__(128 * NWG + 128, 1)
bsr_spmm_tc_kernel(const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap xmap,
                   const int32_t* __restrict__ block_cols,
                   float* __restrict__ y, int n_rb, int slots, int bt) {
  using Smem = TcSmem<NWG>;
  constexpr int BTC = Smem::BTC;
  constexpr int S = Smem::STAGES;
  constexpr int NCONS = 128 * NWG;
  constexpr int CPS = kB / kKC;            // chunks per slot
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int tid = threadIdx.x;
  const int n_ct = (bt + BTC - 1) / BTC;
  const int64_t n_work = int64_t(n_rb) * n_ct;
  const int n_it = slots * CPS;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&sm.full[s], 1);         // the expect_tx arrive
      mbar_init(&sm.empty[s], NWG);      // one arrive per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // producer warpgroup: its first warp works
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    const int lane = tid - NCONS;
    if (lane >= 32) return;
    uint32_t g = 0;
    for (int64_t w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int64_t i = w / n_ct;
      const int col0 = int(w % n_ct) * BTC;
      const int ncols = min(BTC, bt - col0);       // real columns here
      const int nbox = (ncols + 31) / 32;
      int cb_lane = 0;                   // block_cols[i, s0 + lane]
      for (int it = 0; it < n_it; ++it, ++g) {
        const int s = it / CPS;
        if (it % CPS == 0 && s % 32 == 0 && s + lane < slots)
          cb_lane = block_cols[i * slots + s + lane];   // before the wait
        const int st = g % S;
        mbar_wait(&sm.empty[st], ((g / S) & 1) ^ 1);
        const int kc = (it % CPS) * kKC;
        const int cb = __shfl_sync(0xffffffffu, cb_lane, s % 32);
        if (lane == 0) {
          mbar_arrive_expect_tx(&sm.full[st],
                                kChunkBytes + nbox * kXBoxBytes);
          tma_load_2d(sm.vhi[st], &vmap, kc, int((i * slots + s) * kB),
                      &sm.full[st]);
          for (int bx = 0; bx < nbox; ++bx)
            tma_load_2d(sm.xs[st] + bx * kXBox, &xmap, col0 + 32 * bx,
                        cb * kB + kc, &sm.full[st]);
        }
      }
    }
  } else {
    // consumer warpgroups: warpgroup w owns columns col0 + 64w .. + 64.
    // The tensor cores truncate as they accumulate, so the large hi*hi
    // terms of each slot go into `part` (16 k-steps), which is added into
    // `acc` with IEEE f32 adds; the small lo*hi and hi*lo terms (2^-10 of
    // them) run on in `cross` over the work item.
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int t = lane % 4;
    const int m = 64 * wg + 16 * warp + lane / 4;
    const int xoff[4] = {xs_offset(t, m), xs_offset(t, m + 8),
                         xs_offset(t + 4, m), xs_offset(t + 4, m + 8)};
    const bool leader = tid % 128 == 0;
    float acc[64], part[64], cross[64];
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] = part[v] = cross[v] = 0.f;
    uint32_t a0[2][4], a1[2][4];     // [hi, lo][fragment], by k-step parity
    uint32_t g = 0;
    for (int64_t w = blockIdx.x; w < n_work; w += gridDim.x) {
      for (int it = 0; it < n_it; ++it, ++g) {
        tc_prepare<NWG>(sm, g, tid);       // overlaps the wgmmas of g - 1
        const bool slot_start = it % CPS == 0;
#pragma unroll
        for (int kk = 0; kk < kKC / 8; ++kk) {
          if (kk == 0 && slot_start && it > 0) {
            wgmma_wait<0>();               // slot done: fold it into acc
            if (leader) mbar_arrive(&sm.empty[(g - 1) % S]);
            fence_regs(part);
#pragma unroll
            for (int v = 0; v < 64; ++v) acc[v] += part[v];
          } else if (it > 0 || kk >= 2) {
            wgmma_wait<1>();               // k-step kk - 2 done: a free
            if (kk == 1 && !slot_start && leader)   // chunk g - 1 done
              mbar_arrive(&sm.empty[(g - 1) % S]);
          }
          const int keep = kk == 0 && slot_start ? 0 : 1;
          const int keep_cross = kk == 0 && it == 0 ? 0 : 1;
          if (kk % 2 == 0)
            tc_kstep<NWG>(sm, g, kk, xoff, keep, keep_cross, part, cross, a0);
          else
            tc_kstep<NWG>(sm, g, kk, xoff, keep, keep_cross, part, cross, a1);
        }
      }
      wgmma_wait<0>();
      fence_regs(part);
      fence_regs(cross);
      if (n_it > 0) {
        if (leader) mbar_arrive(&sm.empty[(g - 1) % S]);
#pragma unroll
        for (int v = 0; v < 64; ++v) acc[v] += part[v];
      }
      const int64_t i = w / n_ct;
      const int col = int(w % n_ct) * BTC + m;
      float* yb = y + i * kB * int64_t(bt);
#pragma unroll
      for (int v = 0; v < 64; ++v) {
        const int c = col + 8 * ((v / 2) % 2);
        const int r = 8 * (v / 4) + 2 * t + v % 2;
        if (c < bt) yb[int64_t(r) * bt + c] = acc[v] + cross[v];
        acc[v] = 0.f;
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn(cudaError_t* err) {
  static EncodeTiledFn encode = nullptr;
  *err = cudaSuccess;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    *err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                            12000, cudaEnableDefault, &q);
    if (*err == cudaSuccess && (q != cudaDriverEntryPointSuccess || !fn))
      *err = cudaErrorSymbolNotFound;
    if (*err != cudaSuccess) return nullptr;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  return encode;
}

// A row-major [rows, cols] f32 matrix, boxes of [box_rows, box_cols] in the
// 128-byte swizzle (box_cols * 4 bytes must be 128).
cudaError_t encode_map(CUtensorMap* map, const float* base, int64_t rows,
                       int64_t cols, int box_rows, int box_cols) {
  cudaError_t err;
  const EncodeTiledFn encode = encode_fn(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * sizeof(float)};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);     // out of bounds reads as 0
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The SM count of the current device, with the kernel's shared-memory
// attribute set there: both asked of the runtime once per device.
template <int NWG>
cudaError_t tc_device_setup(int* sms) {
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};      // 0 until set up on that device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && sms_of[dev] > 0) {
    *sms = sms_of[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(bsr_spmm_tc_kernel<NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(tc_smem_bytes<NWG>()));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) sms_of[dev] = *sms;
  return err;
}

template <int NWG>
cudaError_t launch_tc(const int32_t* block_cols, const float* values,
                      const float* x, float* y, int n_rb, int slots, int bt,
                      cudaStream_t stream) {
  // TMA needs 16-byte aligned bases and row strides
  if (reinterpret_cast<uintptr_t>(values) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (bt % 4 != 0) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = tc_device_setup<NWG>(&sms);
  if (err != cudaSuccess) return err;
  // values as [n_rb * slots * 128, 128]: one box = one [128 x 32] chunk
  CUtensorMap vmap, xmap;
  err = encode_map(&vmap, values, int64_t(n_rb) * slots * kB, kB, kB, kKC);
  if (err == cudaSuccess)
    err = encode_map(&xmap, x, int64_t(n_rb) * kB, bt, kKC, 32);
  if (err != cudaSuccess) return err;
  constexpr int BTC = TcSmem<NWG>::BTC;
  const int64_t n_work = int64_t(n_rb) * ((bt + BTC - 1) / BTC);
  const int grid = int(n_work < sms ? n_work : sms);   // one CTA per SM
  bsr_spmm_tc_kernel<NWG>
      <<<grid, 128 * NWG + 128, int(tc_smem_bytes<NWG>()), stream>>>(
          vmap, xmap, block_cols, y, n_rb, slots, bt);
  return cudaGetLastError();
}

}  // namespace

// block_cols [n_rb, slots] int32, values [n_rb, slots, 128, 128] f32,
// x [n_rb*128, bt] f32, y [n_rb*128, bt] f32 (written, not read); all
// contiguous, on the current device. Launches the tensor-core variant
// when `tensor_cores` is non-zero (then bt % 4 == 0 and x 16-byte
// aligned: TMA's rules), else the FFMA variant, on `stream`, and returns
// cudaGetLastError() of the launch (0 = cudaSuccess).
extern "C" int bsr_spmm_f32(const void* block_cols, const void* values,
                            const void* x, void* y, int n_rb, int slots,
                            int bt, int tensor_cores, void* stream) {
  if (n_rb <= 0 || bt <= 0) return 0;
  const auto* bc = static_cast<const int32_t*>(block_cols);
  const auto* v = static_cast<const float*>(values);
  const auto* xp = static_cast<const float*>(x);
  auto* yp = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!tensor_cores) {
    err = launch_spmv(bc, v, xp, yp, n_rb, slots, bt, st);
  } else if (bt <= 64) {
    err = launch_tc<1>(bc, v, xp, yp, n_rb, slots, bt, st);
  } else {
    err = launch_tc<2>(bc, v, xp, yp, n_rb, slots, bt, st);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one tensor-core CTA at width bt.
extern "C" int bsr_spmm_tc_smem_bytes(int bt) {
  return int(bt <= 64 ? tc_smem_bytes<1>() : tc_smem_bytes<2>());
}
