// Hopper (sm_90a) building blocks of the bf16 tensor-core kernels
// (attn_decode.cu, flash_fwd.cu, flash_bwd.cu, gdn_prefill.cu):
// asynchronous global -> shared copies (cp.async), ldmatrix loads of mma
// fragments, and the mma.sync m16n8k16 bf16 product with fp32
// accumulators.
//
// Fragment layout of m16n8k16 (lane = 4 gid + tig): A (16 x 16, row) a0 =
// A[gid][2tig..], a1 = A[gid+8][2tig..], a2 = A[gid][2tig+8..], a3 =
// A[gid+8][2tig+8..]; B (16 x 8, col) b0 = B[2tig..][gid], b1 =
// B[2tig+8..][gid]; C/D (16 x 8) d0, d1 = C[gid][2tig, 2tig+1], d2, d3 =
// C[gid+8][2tig, 2tig+1].  With a matrix X kept row-major in shared memory:
//   ldmatrix_x4 at row (lane & 15), column 8 (lane >> 4) of a 16 x 16
//     block -> the A fragment of that block;
//   ldmatrix_x4 at row (lane & 7) + 8 ((lane >> 4) & 1), column
//     8 ((lane >> 3) & 1) of a 16-row block -> the B fragments of X^T for
//     rows 0-7 ({r0, r1}) and rows 8-15 ({r2, r3}) of the block;
//   ldmatrix_x4_trans at row (lane & 7) + 8 ((lane >> 3) & 1), column
//     8 (lane >> 4) of a 16 x 16 block -> the B fragments of X itself for
//     columns 0-7 ({r0, r1}) and 8-15 ({r2, r3}).
// With .trans at the X^T pattern's offsets, ldmatrix_x4_trans gives the A
// fragment of X^T itself (gdn_prefill.cu's K^T).
// Rows padded by 16 bytes make each of these reads conflict-free.
// mma_abt and mma_ab16 below are a warp's two product shapes built on
// them: C += A B^T with both operands in shared memory, and C += A B with
// A in registers (accumulators rounded to bf16 by acc_to_a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
// 16 bytes, or 16 zero bytes when !ok (gmem is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}
// 4 bytes, or zero when !ok
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
// round to nearest even, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// d += a b: m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the element offsets, in a row-major shared matrix of row stride LD, at
// which a lane reads with the three ldmatrix patterns above: the A
// fragment of a 16 x 16 block (a_off), the B fragments of X^T (bt_off),
// and with .trans the B fragments of X itself (b_off)
template <int LD>
__device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * LD + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int bt_off(int lane) {
  return ((lane & 7) + ((lane >> 4) & 1) * 8) * LD + ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
}

// the A fragment of a 16 x 16 block held as two accumulator tiles
// (columns 0-7 in lo, 8-15 in hi), rounded to bf16
__device__ __forceinline__ void acc_to_a(unsigned (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// c[t][j] += A_t X^T over depth D, for the MT m-tiles A_t (16 rows each,
// at a + 16 t LD) and the 8 NJ rows of X at x; a and x are already offset
// by a_off and bt_off.  Each x4 load of X feeds MT pairs of mma.
template <int MT, int NJ, int D, int LD>
__device__ __forceinline__ void mma_abt(float (*c)[NJ][4], const bf16* a,
                                        const bf16* x) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    unsigned af[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) ldmatrix_x4(af[t], a + 16 * t * LD + 16 * ks);
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j) {
      unsigned b[4];
      ldmatrix_x4(b, x + 16 * j * LD + 16 * ks);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        mma_bf16(c[t][2 * j], af[t], b[0], b[1]);
        mma_bf16(c[t][2 * j + 1], af[t], b[2], b[3]);
      }
    }
  }
}

// c[t][n] += A_t X over 16 rows of X, for the MT A fragments a[t]
// (acc_to_a) and the 8 NN columns of X; x is already offset by b_off.
template <int MT, int NN, int LD>
__device__ __forceinline__ void mma_ab16(float (*c)[NN][4],
                                         const unsigned (*a)[4],
                                         const bf16* x) {
#pragma unroll
  for (int n = 0; n < NN; n += 2) {
    unsigned b[4];
    ldmatrix_x4_trans(b, x + 8 * n);
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      mma_bf16(c[t][n], a[t], b[0], b[1]);
      mma_bf16(c[t][n + 1], a[t], b[2], b[3]);
    }
  }
}

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22;
// subnormal results flush to 0, -inf and very negative x give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the 4 lanes of a quad (the threads that share a row of
// an accumulator fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tc
