// Hopper (sm_90a) building blocks of the bf16 tensor-core kernels
// (attn_decode.cu, flash_fwd.cu, flash_bwd.cu): asynchronous global ->
// shared copies (cp.async), ldmatrix loads of mma fragments, and the
// mma.sync m16n8k16 bf16 product with fp32 accumulators.
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
// Rows padded by 16 bytes make each of these reads conflict-free.
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
