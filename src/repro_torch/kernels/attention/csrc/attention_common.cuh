// Shared pieces of the attention kernels (attention_fwd.cu, attention_bwd.cu):
// the call's shape, the reference's masking rule, and the f32 path's tile
// loads and products. The bf16 path's Hopper pieces (TMA, mbarriers,
// wgmma) are in attention_sm90.cuh.
//
// Layout. q [B, Sq, H, Dh], k and v [B, Sk, Hkv, Dh], read in place from
// their (batch, sequence, head) strides; the last dimension is contiguous.
// An f32 tile of rows lands in shared memory as [rows][LD] with LD = DP +
// 16 bytes of padding, DP the head dimension rounded up to the kernel's
// width (16, 64, 80 or 128), by cp.async. The columns [Dh, DP) are zero,
// so they add exactly nothing to any product.
//
// Masking, as the reference's `chunked_attention` (src/repro/models/
// layers.py:132-163): query row i sits at position qp = q_offset + i and
// sees the keys [lo, hi) with lo = max(0, qp - window + 1) under a window
// (else 0) and hi = min(Sk, qp + 1) when causal (else Sk). A row with no
// such key ("dead": q_offset < 0, or a window that has passed the keys)
// gets the reference's average of its masked tiles: every key below Sk
// weighs 1 / (n_k k_chunk), the padded keys of its tiles included in the
// count, so the kernels give it the scores 0 over [0, Sk), the normalizer
// n_k k_chunk (`dead_norm`) and no dQ or dK.
//
// Products. bf16 runs on wgmma (attention_sm90.cuh). f32 runs as FFMA
// (the float32 gates' 1e-5 is past TF32's reach) in the fragment layout
// of a 16-row warp tile: thread (g, t) of a warp (g = lane / 4, t = lane %
// 4) holds rows g and g + 8 and columns 8j + 2t, 8j + 2t + 1 of each
// 8-column tile, summing k in order; the second product of a pair (P V,
// P^T dO, dS^T Q, dS K) takes its operand through a per-warp scratch tile
// in shared memory. No atomics anywhere: every output element is summed by
// one thread in a fixed order, so every call gives the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 64;   // f32: query rows of a forward or dQ block, 16 a warp
constexpr int kBN = 64;   // f32: keys of a KV tile (of a dK/dV block, 16 a warp)

// The call, from the wrapper's int64 array (see `make_shape`).
struct Shape {
  int b, h, hkv, sq, sk, dh;
  int causal, has_window, window, q_offset;
  int vec;                       // cp.async bytes a piece: 16, 8 or 4
  int64_t q[3], k[3], v[3], o[3], g[3];   // (batch, seq, head) strides
  float scale;                   // 1 / sqrt(Dh)
  float scale_log2;              // scale * log2(e): scores in base 2
  float dead_norm;               // n_k * k_chunk of a row with no key
};

inline Shape make_shape(const int64_t* a, double scale, double dead_norm) {
  Shape s;
  s.b = (int)a[0]; s.h = (int)a[1]; s.hkv = (int)a[2];
  s.sq = (int)a[3]; s.sk = (int)a[4]; s.dh = (int)a[5];
  s.causal = (int)a[6]; s.has_window = (int)a[7]; s.window = (int)a[8];
  s.q_offset = (int)a[9]; s.vec = (int)a[10];
  for (int i = 0; i < 3; ++i) {
    s.q[i] = a[11 + i]; s.k[i] = a[14 + i]; s.v[i] = a[17 + i];
    s.o[i] = a[20 + i]; s.g[i] = a[23 + i];
  }
  s.scale = (float)scale;
  s.scale_log2 = (float)(scale * 1.4426950408889634);
  s.dead_norm = (float)dead_norm;
  return s;
}

// The shared-memory row length of a tile, in elements: DP + 16 bytes.
template <typename T, int DP>
__host__ __device__ constexpr int ld() { return DP + 16 / (int)sizeof(T); }

// ------------------------------------------------------------- masking --

struct Row {
  int lo, hi;     // the keys [lo, hi) the row sees
  bool dead;      // no valid key: scores 0 over [0, Sk), no dQ / dK
};

__device__ __forceinline__ Row row_keys(const Shape& s, int i) {
  Row r;
  if (i >= s.sq) {              // a padding row of the last tile
    r.lo = 0; r.hi = 0; r.dead = false;
    return r;
  }
  const int qp = s.q_offset + i;
  r.lo = s.has_window ? max(0, qp - s.window + 1) : 0;
  r.hi = s.causal ? min(s.sk, qp + 1) : s.sk;
  r.dead = r.lo >= r.hi;
  if (r.dead) { r.lo = 0; r.hi = s.sk; }
  return r;
}

// The keys [k0, k1) that the rows [i0, i1] (i1 < Sq) see together. The
// bounds grow with the row, and dead rows lie only at the two ends (before
// key 0, or past the window of the last key), so the two end rows decide:
// a tile of keys outside [k0, k1) is masked for every row (the reference's
// `_tile_masked`) and is skipped.
__device__ __forceinline__ void key_range(const Shape& s, int i0, int i1,
                                          int& k0, int& k1) {
  const Row a = row_keys(s, i0), b = row_keys(s, i1);
  if (a.dead || b.dead) { k0 = 0; k1 = s.sk; }
  else { k0 = a.lo; k1 = b.hi; }
}

// Every row of [i0, i1] (i1 the last row below Sq) sees every key of
// [c0, c0 + n), so the tile needs no mask (most tiles of a long causal
// sequence). Rows past Sq in the tile are zeros from the loads, with a
// log-sum-exp and D of 0: unmasked they add exactly 0 to every sum whose
// result is kept.
__device__ __forceinline__ bool tile_full(const Shape& s, int i0, int i1,
                                          int c0, int n = kBN) {
  const Row a = row_keys(s, i0), b = row_keys(s, i1);
  return !a.dead && !b.dead && c0 >= b.lo && c0 + n <= a.hi;
}

// ---------------------------------------------------------------- loads --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (16, 8 or 4) bytes; zero fill when !ok.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  const uint32_t d = smem_addr(dst);
  const int n = ok ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows [row0, row0 + rows) of a matrix whose row r starts at base + r rs
// (Dh elements) into dst [rows][ld]; rows at or past `limit` are zeros.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* base,
                                          int64_t rs, int row0, int rows,
                                          int limit, const Shape& s) {
  const int step = s.vec / (int)sizeof(T);
  const int per = s.dh / step;               // pieces a row
  for (int idx = threadIdx.x; idx < rows * per; idx += kThreads) {
    const int r = idx / per, c = idx - r * per;
    const int gr = row0 + r;
    const bool ok = gr < limit;
    const T* src = ok ? base + (int64_t)gr * rs + c * step : base;
    cp_async(dst + r * ld + c * step, src, s.vec, ok);
  }
}

// n f32 values from src[i0..] into dst, zeros past `limit`.
__device__ __forceinline__ void load_floats(float* dst, const float* src,
                                            int i0, int n, int limit) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool ok = i0 + i < limit;
    cp_async(dst + i, ok ? src + i0 + i : src, 4, ok);
  }
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

// Zero the columns [Dh, DP) of `rows` rows: written once, never loaded over.
template <typename T, int DP>
__device__ __forceinline__ void zero_pad(T* t, int rows, const Shape& s) {
  constexpr int LD = ld<T, DP>();
  const int w = DP - s.dh;
  if (w <= 0) return;
  for (int idx = threadIdx.x; idx < rows * w; idx += kThreads) {
    const int r = idx / w;
    t[r * LD + s.dh + idx - r * w] = zero<T>();
  }
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error ~2^-22, results
// below 2^-126 flushed to 0, 2^-inf = 0): the softmax weights.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Store a warp's [16 x 8 NT] f32 fragments (rows row0 + g, row0 + g + 8)
// into rows of `out` (row r at out + r rs, columns below Dh, rows below
// limit), converted to T.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* out, int64_t rs, int row0,
                                           int limit, int dh,
                                           const float (&acc)[NT][4],
                                           const float (&div)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
    T* p = out + (int64_t)row * rs;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        if (c < dh) p[c] = from_f32<T>(acc[j][2 * r + e] / div[r]);
      }
    }
  }
}

// ------------------------------------------------------------ products --

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The f32 forms: FFMA in the same fragment layout, k summed in order.
template <int NT, int KS, bool BKN>
__device__ __forceinline__ void mma_ss(float (&acc)[NT][4], const float* sA,
                                       int lda, const float* sB, int ldb,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < 16 * KS; ++k) {
    const float a0 = sA[g * lda + k], a1 = sA[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float b0, b1;
      if (BKN) {
        const float2 bb =
            *reinterpret_cast<const float2*>(sB + k * ldb + 8 * j + 2 * t);
        b0 = bb.x; b1 = bb.y;
      } else {
        b0 = sB[(8 * j + 2 * t) * ldb + k];
        b1 = sB[(8 * j + 2 * t + 1) * ldb + k];
      }
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// The scratch row of an f32 second product: 16 KS columns and 16 bytes.
template <int KS>
__host__ __device__ constexpr int scratch_ld() { return 16 * KS + 4; }

template <int NT, int KS, bool BKN>
__device__ __forceinline__ void mma_rs(float (&acc)[NT][4],
                                       const float (&c)[2 * KS][4],
                                       const float* sB, int ldb,
                                       float* scratch, int lane) {
  constexpr int LS = scratch_ld<KS>();
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    *reinterpret_cast<float2*>(scratch + g * LS + 8 * j + 2 * t) =
        make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(scratch + (g + 8) * LS + 8 * j + 2 * t) =
        make_float2(c[j][2], c[j][3]);
  }
  __syncwarp();
  mma_ss<NT, KS, BKN>(acc, scratch, LS, sB, ldb, lane);
}

template <typename T, int KS>
__host__ __device__ constexpr int scratch_bytes() {
  return std::is_same<T, float>::value ? kWarps * 16 * scratch_ld<KS>() * 4
                                       : 0;
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// Launch through the width DP that holds Dh (the widths the kernels are
// built for; Dh past 128 is refused by the wrapper).
template <template <typename, int> class L, typename T, typename... A>
int by_width(int dh, A... args) {
  if (dh <= 16) return L<T, 16>::run(args...);
  if (dh <= 64) return L<T, 64>::run(args...);
  if (dh <= 80) return L<T, 80>::run(args...);
  if (dh <= 128) return L<T, 128>::run(args...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn
