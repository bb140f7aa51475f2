// Fused persistent-state GDN decode step (paper Alg. 2) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/gdn_decode.py, gdn_decode_pallas (its _kernel
// at line 35, pallas_call at line 104).
//
// Per value head:  r = S^T k,  sq = S^T q  (one read pass over S)
//                  dv = beta (v - r)              (delta_rule; SSD: dv = v)
//                  o  = scale (g sq + (q . k) dv)
//                  S <- g S + k dv^T              (one write pass, in place)
//
// What bounds it on an H100: bytes.  The state is read once and written
// once, B*Hv*dk*dv*4 bytes each way (4 MiB per layer call at batch 1 of
// qwen3-next-gdn), against ~4*dk*dv FLOP per head: about 1 FLOP per byte,
// far below the ~20 FLOP/byte where fp32 CUDA-core math would bind.
//
// Design: the columns of S are independent in this step, so d_v is split
// across CTAs: grid (B, Hv, ceil(dv / 32)), one CTA per 32-column tile of
// one head, no reduction between CTAs.  The TPU kernel's head_block loop is
// not carried over (eight 64 KiB heads would not fit one SM).  Lane j of
// every warp owns column j of the tile, so each warp reads 128 contiguous
// bytes of a state row; warp w walks rows w, w+8, ....  The tile is kept in
// shared memory between the read and the write pass, so HBM sees S exactly
// once each way.  The dk-long q.k dot is recomputed by every CTA (cheap).
// GVA: value head hv reads the shared q/k head hv / (Hv / Hk) directly.
// Inputs q/k/v are fp32 or bf16, S/g/beta fp32; all arithmetic is fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileV = 32;  // state columns per CTA
constexpr int kWarps = 8;   // 256 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp.astype
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    gdn_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ S,
                      const float* __restrict__ g,
                      const float* __restrict__ beta, T* __restrict__ o,
                      int Hk, int Hv, int dk, int dv, float scale,
                      int delta_rule) {
  extern __shared__ float smem[];
  float* s_tile = smem;                    // dk * kTileV
  float* s_k = s_tile + dk * kTileV;       // dk
  float* s_q = s_k + dk;                   // dk
  float* s_part = s_q + dk;                // 2 * kWarps * kTileV
  __shared__ float s_qk;

  const int b = blockIdx.x, hv = blockIdx.y;
  const int hk = hv / (Hv / Hk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.z * kTileV + lane;
  const bool col_ok = col < dv;

  const size_t qk_row = (static_cast<size_t>(b) * Hk + hk) * dk;
  for (int i = threadIdx.x; i < dk; i += blockDim.x) {
    s_k[i] = to_f(k[qk_row + i]);
    s_q[i] = to_f(q[qk_row + i]);
  }
  __syncthreads();

  const size_t head = static_cast<size_t>(b) * Hv + hv;
  float* Sh = S + head * dk * dv;
  // read pass: r = S^T k and sq = S^T q for this thread's rows
  float pr = 0.f, ps = 0.f;
  for (int r = warp; r < dk; r += kWarps) {
    const float s = col_ok ? Sh[static_cast<size_t>(r) * dv + col] : 0.f;
    s_tile[r * kTileV + lane] = s;
    pr += s * s_k[r];
    ps += s * s_q[r];
  }
  s_part[warp * kTileV + lane] = pr;
  s_part[(kWarps + warp) * kTileV + lane] = ps;
  if (warp == 0) {
    float a = 0.f;
    for (int i = lane; i < dk; i += 32) a += s_q[i] * s_k[i];
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) s_qk = a;
  }
  __syncthreads();

  float r_col = 0.f, sq_col = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    r_col += s_part[w * kTileV + lane];
    sq_col += s_part[(kWarps + w) * kTileV + lane];
  }
  const float gg = g[head];
  const float vv = col_ok ? to_f(v[head * dv + col]) : 0.f;
  const float dvc = delta_rule ? beta[head] * (vv - r_col) : vv;
  if (warp == 0 && col_ok)
    o[head * dv + col] = from_f<T>(scale * (gg * sq_col + s_qk * dvc));
  // write pass, from the tile held in shared memory
  if (col_ok) {
    for (int r = warp; r < dk; r += kWarps)
      Sh[static_cast<size_t>(r) * dv + col] =
          gg * s_tile[r * kTileV + lane] + s_k[r] * dvc;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* S,
           const void* g, const void* beta, void* o, int B, int Hk, int Hv,
           int dk, int dv, float scale, int delta_rule, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(dk * kTileV + 2 * dk + 2 * kWarps * kTileV) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gdn_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Hv, (dv + kTileV - 1) / kTileV);
  gdn_decode_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(S),
      static_cast<const float*>(g), static_cast<const float*>(beta),
      static_cast<T*>(o), Hk, Hv, dk, dv, scale, delta_rule);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).  Returns a cudaError_t.
extern "C" int gdn_decode_launch(const void* q, const void* k, const void* v,
                                 void* S, const void* g, const void* beta,
                                 void* o, int B, int Hk, int Hv, int dk,
                                 int dv, float scale, int delta_rule,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, S, g, beta, o, B, Hk, Hv, dk, dv, scale,
                         delta_rule, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, S, g, beta, o, B, Hk, Hv, dk, dv,
                                 scale, delta_rule, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
