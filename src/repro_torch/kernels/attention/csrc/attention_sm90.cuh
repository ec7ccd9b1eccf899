// Hopper pieces of the bf16 attention kernels (attention_fwd.cu,
// attention_bwd.cu): mbarriers, TMA loads of q, k, v and dO tiles, the
// shared-memory layout those tiles take, and the warpgroup products
// (wgmma) that read it.
//
// Tile layout. A tile of R rows of q, k, v or dO lands in shared memory
// as column chunks, each R rows deep: DP / 64 chunks of 64 columns whose
// 128-byte rows carry the 128-byte swizzle, then, where DP % 64 is 16
// (DP 16 and danube's DP 80), one chunk of 16 columns whose 32-byte rows
// carry the 32-byte swizzle. 160-byte rows (Dh 80) are no swizzle width,
// so a row is cut into a 128-byte piece and a 32-byte piece; each piece is
// one TMA box in the swizzle that wgmma's descriptors name (64 rows a
// box). TMA fills the columns [Dh, DP) and the rows past the sequence with
// zeros, so they add exactly nothing to any product.
//
// Two views of one tile. K-major (the tile's rows are the product's M or
// N, its columns the summed dimension): q and k in S = q k^T, k and v in
// S^T = k q^T and dP^T = v dO^T, dO and v in dP = dO v^T. A 16-column
// k-step is 32 bytes into a 128-byte chunk row (8-row groups 1,024 bytes
// apart), or the whole narrow chunk (8-row groups 256 bytes apart).
// MN-major (the tile's rows are the summed dimension, its columns the
// output's N): v in O += P v, dO in dV += P^T dO, q in dK += dS^T q, k in
// dQ += dS k. A 16-row k-step is 16 rows further down; the wide chunks
// repeat R x 128 bytes apart (the descriptor's leading offset), 8-row
// groups 1,024 bytes apart (its stride offset); the narrow chunk is its
// own product of width 16. The first operand of those second products is
// the f32 accumulator of the first, rounded to bf16 in registers: the
// fragment a thread holds of an m64nN accumulator (rows g and g + 8 of its
// warp's 16, columns 8j + 2t, 8j + 2t + 1) is the fragment wgmma takes for
// A from registers, as with mma.sync.
#pragma once

#include <cuda.h>

#include <cstring>

#include "attention_common.cuh"

namespace attn {
namespace sm90 {

constexpr int kBoxRows = 64;   // rows of one TMA box (a tile is R / 64)
constexpr int kSw128 = 1, kSw32 = 3;   // descriptor layout types

// ------------------------------------------------------------ mbarrier --

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait of ~1e10
// cycles (seconds; a tile takes microseconds) can only be a broken ring:
// trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
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

// ----------------------------------------------------------------- TMA --

// The box at (column c0, row c1, head c2, batch c3) of `map` into shared
// memory, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// One tensor's maps: the wide chunks' boxes [64 rows][64 columns] in the
// 128-byte swizzle, the narrow chunk's [64 rows][16 columns] in the 32-byte
// swizzle (each encoded only where the width has such a chunk).
struct TileMaps {
  CUtensorMap wide, narrow;
};

// The columns of a width DP: `kWide` chunks of 64, `kNarrow` (0 or 1) of 16.
template <int DP>
struct Cols {
  static_assert(DP % 64 == 0 || DP % 64 == 16, "DP: 16, 64, 80 or 128");
  static constexpr int kWide = DP / 64;
  static constexpr int kNarrow = (DP % 64) / 16;
};

// Rows [row0, row0 + R) of (head, batch) into a tile at dst (R x DP bf16,
// 1,024-byte aligned): R / 64 boxes a chunk.
template <int DP, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const TileMaps& m, int row0,
                                          int head, int batch,
                                          uint64_t* bar) {
  using C = Cols<DP>;
#pragma unroll
  for (int r = 0; r < R; r += kBoxRows) {
#pragma unroll
    for (int c = 0; c < C::kWide; ++c)
      tma_load_4d(dst + c * R * 64 + r * 64, &m.wide, 64 * c, row0 + r, head,
                  batch, bar);
    if (C::kNarrow)
      tma_load_4d(dst + C::kWide * R * 64 + r * 16, &m.narrow, 64 * C::kWide,
                  row0 + r, head, batch, bar);
  }
}

template <int DP, int R>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (uint32_t)(R * DP * 2);
}

// ---------------------------------------------------------- descriptors --

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// K-major view of a tile (R rows at `tile`): rows from r0 (a multiple of
// 8), the 16 columns of k-step kk.
template <int DP, int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int r0, int kk) {
  using C = Cols<DP>;
  if (kk < 4 * C::kWide)
    return desc(tile + (kk / 4) * R * 128 + r0 * 128 + (kk % 4) * 32, 16,
                1024, kSw128);
  return desc(tile + C::kWide * R * 128 + r0 * 32, 16, 256, kSw32);
}

// MN-major view: rows 16 kk .. 16 kk + 15 (the summed dimension) of the
// wide chunks (all of them, one product) or of the narrow chunk.
template <int DP, int R>
__device__ __forceinline__ uint64_t mn_wide(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, R * 128, 1024, kSw128);
}

template <int DP, int R>
__device__ __forceinline__ uint64_t mn_narrow(uint32_t tile, int kk) {
  return desc(tile + Cols<DP>::kWide * R * 128 + kk * 16 * 32, R * 32, 256,
              kSw32);
}

// ---------------------------------------------------------------- wgmma --

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

// Keeps the compiler from reading accumulators above a wgmma wait.
template <int NT>
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+f"(d[j][x]) :: "memory");
}

// d[64 x N] (+)= A B, A and B K-major in shared memory (descriptors da,
// db); keep 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db, int keep);

// d[64 x N] (+)= A B, A [64 x 16] bf16 from registers (the fragment of an
// accumulator, packed), B MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int keep);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t da,
                                           uint64_t db, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[16][4], uint64_t da,
                                           uint64_t db, int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[2][4],
                                           const uint32_t (&a)[4], uint64_t db,
                                           int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4],
                                           const uint32_t (&a)[4], uint64_t db,
                                           int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4],
                                           const uint32_t (&a)[4], uint64_t db,
                                           int keep) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(keep));
}


// d[64 x N] = A B^T over the DP columns: A the rows [ra, ra + 64) of a
// tile of RA rows, B the rows [rb, rb + N) of a tile of RB rows, both
// K-major. Issued, not committed.
template <int N, int DP, int RA, int RB>
__device__ __forceinline__ void mma_rows(float (&d)[N / 8][4], uint32_t ta,
                                         int ra, uint32_t tb, int rb) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<N>(d, kmajor<DP, RA>(ta, ra, kk), kmajor<DP, RB>(tb, rb, kk),
                kk > 0);
}

// d[64 x DP] += A B with A the packed fragments a[KS][4] (KS 16-column
// steps) and B the first 16 KS rows of a tile of R rows, MN-major.
// Issued, not committed.
template <int KS, int DP, int R>
__device__ __forceinline__ void mma_cols(float (&d)[DP / 8][4],
                                         const uint32_t (&a)[KS][4],
                                         uint32_t tb) {
  using C = Cols<DP>;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (C::kWide > 0)
      wgmma_rs<64 * C::kWide>(
          *reinterpret_cast<float(*)[8 * C::kWide][4]>(&d[0][0]), a[kk],
          mn_wide<DP, R>(tb, kk), 1);
    if constexpr (C::kNarrow > 0)
      wgmma_rs<16>(*reinterpret_cast<float(*)[2][4]>(&d[8 * C::kWide][0]),
                   a[kk], mn_narrow<DP, R>(tb, kk), 1);
  }
}

// The bf16 A fragments of the f32 accumulator c [64 x 16 KS]: k-step kk
// holds columns 16 kk .. 16 kk + 15 (c's 8-column tiles 2 kk, 2 kk + 1).
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4],
                                       const float (&c)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// ------------------------------------------------------------ host side --

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through cudaGetDriverEntryPointByVersion (no
// -lcuda), looked up once.
inline EncodeTiledFn encode_fn(cudaError_t* err) {
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

// Make the primary context of the device that holds `p` current on this
// thread. The encoder is a libcuda call and needs one: the first CUDA work
// on a thread (autograd's engine thread, when the attention backward is
// the first node it runs) finds none, and the runtime's own calls bind it
// only lazily.
inline cudaError_t bind_device(const void* p) {
  cudaPointerAttributes a;
  cudaError_t err = cudaPointerGetAttributes(&a, p);
  if (err != cudaSuccess) return err;
  return cudaSetDevice(a.device);
}

// The maps of a bf16 tensor [B, S, H, Dh] read from its (batch, sequence,
// head) strides `st` (elements; the wrapper hands over 16-byte multiples
// and a 16-byte aligned base, copying what is not). Out of bounds reads
// as zeros.
template <int DP>
cudaError_t make_maps(TileMaps* m, const void* base, int dh, int seq,
                      int heads, int batch, const int64_t (&st)[3]) {
  cudaError_t err;
  const EncodeTiledFn encode = encode_fn(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  // the encoder wants its map 64-byte aligned, which a struct of maps on
  // the host stack is not reliably: encode into aligned scratch, then copy
  unsigned char raw[sizeof(CUtensorMap) + 64];
  CUtensorMap* tmp = reinterpret_cast<CUtensorMap*>(
      (reinterpret_cast<uintptr_t>(raw) + 63) & ~(uintptr_t)63);
  for (int narrow = 0; narrow < 2; ++narrow) {
    if (narrow ? !Cols<DP>::kNarrow : !Cols<DP>::kWide) continue;
    const cuuint32_t box[4] = {narrow ? 16u : 64u, (cuuint32_t)kBoxRows, 1,
                               1};
    const CUresult r = encode(
        tmp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
        dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
        narrow ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    memcpy(narrow ? &m->narrow : &m->wide, tmp, sizeof(CUtensorMap));
  }
  return cudaSuccess;
}

// Dynamic shared memory of a struct that wants 1,024-byte alignment: the
// kernel rounds its base up.
template <typename S>
__host__ __device__ constexpr int smem_of() {
  return (int)sizeof(S) + 1024;
}

template <typename S>
__device__ __forceinline__ S& smem_as(unsigned char* raw) {
  const uint32_t pad = (1024u - (smem_addr(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<S*>(raw + pad);
}

// Register split of a block of one producer warpgroup and two consumer
// warpgroups (384 threads, 168 registers each at launch): the producer
// keeps kProducerRegs, the consumers take kConsumerRegs (128 x 24 + 256 x
// 240 = 384 x 168).
constexpr int kProducerRegs = 24, kConsumerRegs = 240;   // setmaxnreg

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
               :: "n"(kProducerRegs) : "memory");
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs) : "memory");
}

}  // namespace sm90
}  // namespace attn
