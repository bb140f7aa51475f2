// Shared tile machinery of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu).
//
// fp32 kernels: every tile is kTile = 64 rows of a (T, HD) matrix,
// staged in shared memory as fp32, row-major with kPad floats of padding
// per row.  A CTA has 256 threads arranged 16 x 16 (ty, tx).  In a
// 64 x 64 score tile the thread owns rows ty + 16 i and columns tx + 16 j
// (i, j < 4): strided, so that the 8 threads of a
// quarter warp read 8 different K rows whose float4 words fall in 8
// disjoint bank groups (row stride HD + 4 floats), and the 16 threads that
// share a row form one half warp (row max and row sum are 4 xor-shuffles).
// In an output tile (64 x HD) the thread owns rows ty + 16 i and the float4
// columns tx * 4 + 64 h, h < ceil(HD / 64), those below HD (at HD 80 the
// second group's columns 64-79 belong to tx < 4).
//
// bf16 tensor-core kernels (forward, dq, dk/dv): CTAs of 4 warps
// (kTcThreads = 128 threads); tiles stay bf16 in shared memory, rows
// padded by 16 bytes (kTcPad) so that every ldmatrix is conflict-free
// (tensor_core.cuh), filled by 16-byte cp.async copies (issue_rows).  The
// forward and dq give each warp mtiles(HD) m-tiles of 16 query rows.
// Head dims: any multiple of 16 up to 256 (the dispatch instantiates 64,
// 80, 128 and 256); a row of HD 80 is 10 16-byte chunks, 5 k-steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tensor_core.cuh"

namespace flash {

constexpr int kTile = 64;        // query rows and key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPad = 4;          // floats of padding per shared row
constexpr int kLdp = kTile + kPad;
constexpr float kNegInf = -1e30f;  // finite, as the reference's NEG_INF
constexpr int kTcThreads = 128;  // bf16 kernels: 4 warps
constexpr int kTcPad = 8;        // bf16 elements of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

// forward, dq (bf16): 16-row m-tiles per warp.  Two, so that each K and V
// fragment read feeds two mma.sync; one at HD 256, where two would keep
// 2 x HD / 8 x 4 = 256 fp32 accumulators per thread (spills)
__host__ __device__ constexpr int mtiles(int hd) { return hd > 128 ? 1 : 2; }

// fp32 kernels: the accumulator columns a thread owns in an output tile
// (4 per float4 column group of 64)
__host__ __device__ constexpr int acc_cols(int hd) {
  return 4 * ((hd + 63) / 64);
}
// whether float4 column group h of thread tx lies inside the head dim
template <int HD>
__device__ __forceinline__ bool col_in(int tx, int h) {
  return HD % 64 == 0 || tx * 4 + 64 * h < HD;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  // round to nearest even, as jnp.astype
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// rows [row0, row0 + kTile) of a (T, HD) matrix -> fp32 shared tile; rows
// at or beyond T are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int T_len) {
  constexpr int kVec = HD / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T_len)
      x = load4(src + static_cast<size_t>(row0 + r) * HD + c);
    store4(dst + r * (HD + kPad) + c, x);
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d]  (A, B shared tiles)
template <int HD>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = HD + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = load4(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][c] += sum_r P(ty + 16 i, r) * X[r][col(c)] over the kTile rows r
// of the shared tile X, where P(a, r) = P[a * SA + r * SR] reads a shared
// 64 x 64 tile either as it is (SA = kLdp, SR = 1) or transposed
// (SA = 1, SR = kLdp).
template <int HD, int SA, int SR>
__device__ __forceinline__ void tile_acc(float (&acc)[4][acc_cols(HD)],
                                         const float* P, const float* X,
                                         int ty, int tx) {
  constexpr int LD = HD + kPad;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * SA + r * SR];
#pragma unroll
    for (int h = 0; h < acc_cols(HD) / 4; ++h) {
      if (!col_in<HD>(tx, h)) continue;
      const float4 x = load4(X + r * LD + tx * 4 + 64 * h);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * h + 0] = fmaf(p[i], x.x, acc[i][4 * h + 0]);
        acc[i][4 * h + 1] = fmaf(p[i], x.y, acc[i][4 * h + 1]);
        acc[i][4 * h + 2] = fmaf(p[i], x.z, acc[i][4 * h + 2]);
        acc[i][4 * h + 3] = fmaf(p[i], x.w, acc[i][4 * h + 3]);
      }
    }
  }
}

// write rows ty + 16 i of a (T, HD) output tile starting at row0, times mul
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst,
                                           const float (&acc)[4][acc_cols(HD)],
                                           const float (&mul)[4], int row0,
                                           int T_len, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= T_len) continue;
#pragma unroll
    for (int h = 0; h < acc_cols(HD) / 4; ++h)
      if (col_in<HD>(tx, h))
        store4(dst + static_cast<size_t>(row) * HD + tx * 4 + 64 * h,
               make_float4(acc[i][4 * h + 0] * mul[i],
                           acc[i][4 * h + 1] * mul[i],
                           acc[i][4 * h + 2] * mul[i],
                           acc[i][4 * h + 3] * mul[i]));
  }
}

// the reference's mask: causal, (q - k) < window when window > 0, and
// k < valid (valid = T without valid_len); rows/keys past T never count
__device__ __forceinline__ bool visible(int qpos, int kpos, int valid,
                                        int window, int T_len) {
  return kpos <= qpos && qpos < T_len && kpos < valid &&
         (window <= 0 || qpos - kpos < window);
}

// max / sum over the 16 lanes of a half warp (the threads of one row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// key tiles [lo, hi] (of `keys` keys each) that hold a key visible to
// some query row in [q0, q0 + rows): from the window's lower bound to the
// causal diagonal (and below valid); hi < lo when there is none
__device__ __forceinline__ void kv_range(int q0, int valid, int window,
                                         int T_len, int* lo, int* hi,
                                         int rows = kTile,
                                         int keys = kTile) {
  const int last_key = min(min(q0 + rows, T_len), valid) - 1;
  const int first_key = window > 0 ? max(0, q0 - window + 1) : 0;
  *lo = first_key / keys;
  *hi = last_key < 0 ? -1 : last_key / keys;
}

// every (query, key) pair of query rows [q0, q0 + rows) and the key tile
// [k0, k0 + keys) is visible: below the causal diagonal, inside the
// window, below valid (<= T) and T
__device__ __forceinline__ bool tile_full(int q0, int k0, int valid,
                                          int window, int T_len,
                                          int rows = kTile,
                                          int keys = kTile) {
  return k0 + keys - 1 <= q0 && k0 + keys <= valid &&
         q0 + rows <= T_len &&
         (window <= 0 || q0 + rows - 1 - k0 < window);
}

// some pair of query rows [q0, q0 + rows) and the key tile [k0, k0 +
// keys) (below valid) passes the causal and window rules
__device__ __forceinline__ bool tile_any(int q0, int k0, int window,
                                         int T_len, int rows,
                                         int keys = kTile) {
  return q0 < T_len && k0 <= q0 + rows - 1 &&
         (window <= 0 || q0 - (k0 + keys - 1) < window);
}

// p = exp(s scale - m) / max(l, 1e-30) = exp2(s scale log2 e - p_bias(m,
// l)), for the forward's statistics m, l (natural-log units)
__device__ __forceinline__ float p_bias(float m, float l) {
  return fmaf(m, kLog2e, log2f(fmaxf(l, 1e-30f)));
}

// cp.async rows [row0, row0 + rows) of a bf16 (T, HD) matrix into a
// shared tile of row stride HD + kTcPad, by the kTcThreads threads of a
// CTA; rows at or beyond T are zeros (uncommitted: the caller groups
// copies)
template <int HD>
__device__ __forceinline__ void issue_rows(tc::bf16* dst,
                                           const tc::bf16* __restrict__ src,
                                           int row0, int T_len,
                                           int rows = kTile) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool ok = row0 + r < T_len;
    tc::cp_async16_zfill(
        dst + r * (HD + kTcPad) + c,
        src + (ok ? static_cast<size_t>(row0 + r) * HD + c : 0), ok);
  }
}

template <typename Kern>
inline int prepare(Kern kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace flash
