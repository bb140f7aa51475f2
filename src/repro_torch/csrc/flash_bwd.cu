// Causal (optionally windowed, optionally ragged) GQA flash-attention
// backward for Hopper, sm_90a: two kernels, dq and dk/dv.
//
// Replaces: src/repro/kernels/flash_attn.py, flash_bwd (line 236): its
// _dq_kernel (line 166, pallas_call at line 258) and its _dkv_kernel
// (line 192, pallas_call at line 286).
//
// Inputs as the forward's (q, do: (BH, G, T, HD); k, v: (BH, T, HD); fp32
// or bf16), plus the forward's fp32 statistics m, l and
// delta = rowsum(do * o), (BH, G, T) each.  Both kernels rebuild the
// probabilities tile by tile as p = exp(s - m) / max(l, 1e-30) (masked
// scores -1e30) and ds = p * (do v^T - delta); nothing of size T x T
// reaches device memory.
//
// What bounds them on an H100: operations.  dq does three causal products
// (q k^T, do v^T, ds k), dk/dv four (q k^T, do v^T, p^T do, ds^T q).
//
// dq: one CTA per (q tile of 64 rows, bh, g), the longest rows first.  Q
// and dO stay in shared memory; the CTA loops over the key tiles from the
// window's lower bound to the causal diagonal and accumulates
// dq = scale * sum ds k in fp32 registers.
// dk/dv: one CTA per (key tile of 64 rows, bh).  K and V stay in shared
// memory; the CTA loops over the G query heads of its kv head and, for
// each, over the q tiles from the causal diagonal to the window's upper
// bound, accumulating dv = sum p^T do and dk = scale * sum ds^T q in fp32
// registers.  Each CTA owns its rows of dk and dv outright: no atomics and
// no second pass.  A key tile wholly at or past valid_len gets zeros (its
// p is 0 in every row that has a visible key).

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ valid_len, int G, int T_len,
                    float scale, int window) {
  extern __shared__ float smem[];
  constexpr int LD = HD + kPad;
  float* sQ = smem;
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sS = sV + kTile * LD;

  const int nq = (T_len + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int bhg = blockIdx.y;
  const int bh = bhg / G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int valid = valid_len ? min(valid_len[bh], T_len) : T_len;
  const size_t head = static_cast<size_t>(T_len) * HD;
  const size_t stat = static_cast<size_t>(bhg) * T_len;

  load_tile<T, HD>(sQ, q + bhg * head, q0, T_len);
  load_tile<T, HD>(sDO, dout + bhg * head, q0, T_len);
  float m_r[4], inv_l[4], d_r[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool ok = row < T_len;
    m_r[i] = ok ? m[stat + row] : 0.f;
    inv_l[i] = ok ? 1.f / fmaxf(l[stat + row], 1e-30f) : 0.f;
    d_r[i] = ok ? delta[stat + row] : 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  kv_range(q0, valid, window, T_len, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, HD>(sK, k + bh * head, k0, T_len);
    load_tile<T, HD>(sV, v + bh * head, k0, T_len);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(s, sQ, sK, ty, tx);
    tile_dot<HD>(dp, sDO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float sv = visible(qpos, kpos, valid, window, T_len)
                             ? scale * s[i][j]
                             : kNegInf;
        const float p = expf(sv - m_r[i]) * inv_l[i];
        sS[(ty + 16 * i) * kLdp + tx + 16 * j] = p * (dp[i][j] - d_r[i]);
      }
    }
    __syncthreads();
    tile_acc<HD, kLdp, 1>(acc, sS, sK, ty, tx);   // acc += dS K
  }
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, HD>(dq + bhg * head, acc, mul, q0, T_len, ty, tx);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const int* __restrict__ valid_len,
                     int G, int T_len, float scale, int window) {
  extern __shared__ float smem[];
  constexpr int LD = HD + kPad;
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sP = sDO + kTile * LD;
  float* sS = sP + kTile * kLdp;
  float* sM = sS + kTile * kLdp;      // per q row of the tile: m, 1/l, delta
  float* sIL = sM + kTile;
  float* sD = sIL + kTile;

  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int valid = valid_len ? min(valid_len[bh], T_len) : T_len;
  const size_t head = static_cast<size_t>(T_len) * HD;
  const int nq = (T_len + kTile - 1) / kTile;

  float acc_k[4][HD / 16], acc_v[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  if (k0 < valid) {
    load_tile<T, HD>(sK, k + bh * head, k0, T_len);
    load_tile<T, HD>(sV, v + bh * head, k0, T_len);
    const int k_last = min(k0 + kTile, T_len) - 1;
    const int q_lo = k0 / kTile;                       // causal diagonal
    const int q_hi = window > 0 ? min(nq - 1, (k_last + window - 1) / kTile)
                                : nq - 1;
    for (int g = 0; g < G; ++g) {
      const int bhg = bh * G + g;
      const size_t stat = static_cast<size_t>(bhg) * T_len;
      for (int qt = q_lo; qt <= q_hi; ++qt) {
        const int q0 = qt * kTile;
        __syncthreads();
        load_tile<T, HD>(sQ, q + bhg * head, q0, T_len);
        load_tile<T, HD>(sDO, dout + bhg * head, q0, T_len);
        if (threadIdx.x < kTile) {
          const int row = q0 + threadIdx.x;
          const bool ok = row < T_len;
          sM[threadIdx.x] = ok ? m[stat + row] : 0.f;
          sIL[threadIdx.x] = ok ? 1.f / fmaxf(l[stat + row], 1e-30f) : 0.f;
          sD[threadIdx.x] = ok ? delta[stat + row] : 0.f;
        }
        __syncthreads();
        // score tile: rows are queries (ty + 16 i), columns keys (tx + 16 j)
        float s[4][4], dp[4][4];
        tile_dot<HD>(s, sQ, sK, ty, tx);
        tile_dot<HD>(dp, sDO, sV, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qr = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kc = tx + 16 * j;
            const float sv = visible(q0 + qr, k0 + kc, valid, window, T_len)
                                 ? scale * s[i][j]
                                 : kNegInf;
            const float p = expf(sv - sM[qr]) * sIL[qr];
            sP[qr * kLdp + kc] = p;
            sS[qr * kLdp + kc] = p * (dp[i][j] - sD[qr]);
          }
        }
        __syncthreads();
        // this thread's key rows ty + 16 i: dv += P^T dO, dk += dS^T Q
        tile_acc<HD, 1, kLdp>(acc_v, sP, sDO, ty, tx);
        tile_acc<HD, 1, kLdp>(acc_k, sS, sQ, ty, tx);
      }
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float mul[4] = {scale, scale, scale, scale};
  store_rows<T, HD>(dk + bh * head, acc_k, mul, k0, T_len, ty, tx);
  store_rows<T, HD>(dv + bh * head, acc_v, one, k0, T_len, ty, tx);
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* m, const void* l, const void* delta, void* dq,
              const void* valid_len, int BH, int G, int T_len, float scale,
              int window, cudaStream_t stream) {
  const size_t smem =
      (4 * static_cast<size_t>(kTile) * (HD + kPad) + kTile * kLdp) *
      sizeof(float);
  int err = prepare(flash_dq_kernel<T, HD>, smem);
  if (err) return err;
  const dim3 grid((T_len + kTile - 1) / kTile, BH * G);
  flash_dq_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<const int*>(valid_len), G, T_len, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* m, const void* l, const void* delta, void* dk,
               void* dv, const void* valid_len, int BH, int G, int T_len,
               float scale, int window, cudaStream_t stream) {
  const size_t smem = (4 * static_cast<size_t>(kTile) * (HD + kPad) +
                       2 * kTile * kLdp + 3 * kTile) *
                      sizeof(float);
  int err = prepare(flash_dkv_kernel<T, HD>, smem);
  if (err) return err;
  const dim3 grid((T_len + kTile - 1) / kTile, BH);
  flash_dkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<const int*>(valid_len), G, T_len,
      scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the gradients); hd 64
// or 128; window <= 0 means none; valid_len is null or (BH,) int32.  Each
// returns a cudaError_t.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* m,
                               const void* l, const void* delta, void* dq,
                               const void* valid_len, int BH, int G,
                               int T_len, int hd, float scale, int window,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_DQ(T, HD)                                                     \
  return launch_dq<T, HD>(q, k, v, dout, m, l, delta, dq, valid_len, BH, G, \
                          T_len, scale, window, st)
  if (dtype == 0 && hd == 64) FLASH_DQ(float, 64);
  if (dtype == 0 && hd == 128) FLASH_DQ(float, 128);
  if (dtype == 1 && hd == 64) FLASH_DQ(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) FLASH_DQ(__nv_bfloat16, 128);
#undef FLASH_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* m,
                                const void* l, const void* delta, void* dk,
                                void* dv, const void* valid_len, int BH,
                                int G, int T_len, int hd, float scale,
                                int window, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_DKV(T, HD)                                                      \
  return launch_dkv<T, HD>(q, k, v, dout, m, l, delta, dk, dv, valid_len, BH, \
                           G, T_len, scale, window, st)
  if (dtype == 0 && hd == 64) FLASH_DKV(float, 64);
  if (dtype == 0 && hd == 128) FLASH_DKV(float, 128);
  if (dtype == 1 && hd == 64) FLASH_DKV(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) FLASH_DKV(__nv_bfloat16, 128);
#undef FLASH_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
