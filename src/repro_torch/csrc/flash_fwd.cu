// Causal (optionally windowed, optionally ragged) GQA flash-attention
// forward for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attn.py, flash_fwd (line 105; its
// _fwd_kernel at line 50, pallas_call at line 130).
//
// q: (BH, G, T, HD); k, v: (BH, T, HD), fp32 or bf16 (one dtype); the G
// query heads of row bh share its kv head.  Writes o (q's shape and dtype)
// and the two fp32 softmax statistics m (row max) and l (row sum of
// exp(s - m)), (BH, G, T) each, which the backward kernels read.  Masked
// scores take the finite -1e30; o = acc / max(l, 1e-30).
//
// What bounds it on an H100: operations.  At the trained shape (B=2,
// T=2048, Hq=16, Hkv=2, HD=128) it moves ~38 MB but does two causal
// products of B*Hq*T^2*HD/2 multiply-adds each.
//
// Design: one CTA per (q tile of 64 rows, bh, g), the longest causal rows
// scheduled first.  The CTA keeps its Q tile in shared memory and loops
// over the key tiles from the window's lower bound to the causal diagonal
// only (fully masked tiles are skipped; see flash::kv_range), with an
// fp32 online softmax: m, l and the 64 x HD accumulator stay in registers,
// the 64 x 64 probability tile passes through shared memory into P V.  All
// arithmetic is fp32 on the CUDA cores (bf16 inputs are widened on load);
// nothing of size T x T reaches device memory.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     const int* __restrict__ valid_len, int G, int T_len,
                     float scale, int window) {
  extern __shared__ float smem[];
  constexpr int LD = HD + kPad;
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;

  const int nq = (T_len + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int bhg = blockIdx.y;             // bh * G + g
  const int bh = bhg / G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int valid = valid_len ? min(valid_len[bh], T_len) : T_len;
  const size_t head = static_cast<size_t>(T_len) * HD;

  load_tile<T, HD>(sQ, q + bhg * head, q0, T_len);
  float m_r[4], l_r[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  kv_range(q0, valid, window, T_len, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                      // the last tile's readers are done
    load_tile<T, HD>(sK, k + bh * head, k0, T_len);
    load_tile<T, HD>(sV, v + bh * head, k0, T_len);
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = visible(qpos, kpos, valid, window, T_len) ? scale * s[i][j]
                                                            : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_r[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
        sP[(ty + 16 * i) * kLdp + tx + 16 * j] = s[i][j];
      }
      const float corr = expf(m_r[i] - m_new);
      l_r[i] = corr * l_r[i] + row_sum(rs);
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    tile_acc<HD, kLdp, 1>(acc, sP, sV, ty, tx);   // acc += P V
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / fmaxf(l_r[i], 1e-30f);
  store_rows<T, HD>(o + bhg * head, acc, inv, q0, T_len, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < T_len) {
        m_out[static_cast<size_t>(bhg) * T_len + row] = m_r[i];
        l_out[static_cast<size_t>(bhg) * T_len + row] = l_r[i];
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* m,
           void* l, const void* valid_len, int BH, int G, int T_len,
           float scale, int window, cudaStream_t stream) {
  const size_t smem =
      (3 * static_cast<size_t>(kTile) * (HD + kPad) + kTile * kLdp) *
      sizeof(float);
  int err = prepare(flash_fwd_kernel<T, HD>, smem);
  if (err) return err;
  const dim3 grid((T_len + kTile - 1) / kTile, BH * G);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<const int*>(valid_len), G, T_len,
      scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, void* m,
              void* l, const void* valid_len, int BH, int G, int T_len,
              int hd, float scale, int window, cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, o, m, l, valid_len, BH, G, T_len, scale,
                         window, stream);
  if (hd == 128)
    return launch<T, 128>(q, k, v, o, m, l, valid_len, BH, G, T_len, scale,
                          window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o); hd 64 or 128;
// window <= 0 means none; valid_len is null or (BH,) int32.  Returns a
// cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* m, void* l,
                                const void* valid_len, int BH, int G,
                                int T_len, int hd, float scale, int window,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, m, l, valid_len, BH, G, T_len, hd,
                            scale, window, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, m, l, valid_len, BH, G,
                                    T_len, hd, scale, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
