// Chunkwise gated delta-rule prefill (UT/WY transform) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/gdn_prefill.py, gdn_prefill_pallas (its
// _kernel at line 43, _kernel_ragged at line 107, _nilpotent_inv_apply at
// line 32; pallas_call at line 163).
//
// Per chunk of C tokens with L = cumsum(log g), L_prev = L - log g:
//   A[t,s] = beta_t exp(L_prev[t] - L[s]) (k_t . k_s),  s < t
//   (I + A) U = beta (V - exp(L_prev) (K S))            (delta rule; SSD: U = V)
//   O  = scale (exp(L) (Q S) + M U),  M[t,s] = exp(L[t] - L[s]) (q_t . k_s), s <= t
//   S <- exp(L[C-1]) S + (exp(L[C-1] - L) K)^T U
// (I + A)^{-1} is applied by forward substitution over the C rows, which
// is exact in exact arithmetic like the TPU kernel's nilpotent doubling and
// is the same sequential solve the XLA path's solve_triangular does.
//
// What bounds it on an H100: operations, at serving sizes.  One row of one
// chunk does about 2C^2 dk (A, M) + 4 C dk dv (K S, Q S, the state update)
// + C^2 dv (the solve and M U) FLOP: 10.5 MFLOP at C=64, dk=dv=128, against
// ~C (2 dk + 2 dv) * 2 + 2 dk dv * 4 bytes of traffic (~0.2 MB): ~50 FLOP
// per byte, above the fp32 CUDA-core ridge of the card (~20 FLOP/byte).
//
// Design: the TPU's sequential chunk grid axis becomes a loop over chunks
// inside the CTA, with the state tile in shared memory: S is loaded once and
// stored once per sequence.  U, O and S' are column-independent, so each CTA
// owns one (row, 32-column tile of d_v): grid (B*Hv, ceil(dv / 32)); A, M
// and the decays are recomputed per tile.  GVA: value row b*Hv + hv reads
// the shared q/k row b*Hk + hv / R, which is row / R for Hv = R*Hk, directly
// (no repeat is materialized).
// valid_len (optional, per row) zeroes k, v, beta and log g at positions >=
// valid_len inside the kernel, so padding is an exact no-op on S (gate 1,
// rank-1 update 0).  K and Q rows sit in shared memory with a stride of
// dk + 1 floats so the C x C dot products are free of bank conflicts.
// Shared memory above 48 KB is enabled with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileV = 32;
constexpr int kThreads = 256;

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
  return __float2bfloat16(x);
}

__host__ __device__ inline size_t smem_floats(int C, int dk) {
  return static_cast<size_t>(2 * C * (dk + 1) + dk * kTileV + 2 * C * kTileV +
                             2 * C * C + 4 * C);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gdn_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ log_g,
                       const float* __restrict__ beta, float* __restrict__ S,
                       const int* __restrict__ valid_len, T* __restrict__ O,
                       int n_rep, int T_len, int C, int dk, int dv,
                       float scale, int delta_rule) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;
  float* Ks = smem;                  // C x ldk
  float* Qs = Ks + C * ldk;          // C x ldk
  float* St = Qs + C * ldk;          // dk x kTileV   (state tile)
  float* Ut = St + dk * kTileV;      // C x kTileV    (V -> rhs -> U)
  float* QSt = Ut + C * kTileV;      // C x kTileV    (Q S0)
  float* A = QSt + C * kTileV;       // C x C
  float* M = A + C * C;              // C x C
  float* L = M + C * C;              // C
  float* Lp = L + C;                 // C (log g, then L_prev)
  float* Bt = Lp + C;                // C (beta)
  float* W = Bt + C;                 // C (exp(L[C-1] - L))

  const int row = blockIdx.x;
  const size_t qk_row = static_cast<size_t>(row / n_rep);
  const int c0 = blockIdx.y * kTileV;
  const int tid = threadIdx.x;
  const int vl = valid_len ? valid_len[row] : T_len;

  float* Srow = S + static_cast<size_t>(row) * dk * dv;
  for (int idx = tid; idx < dk * kTileV; idx += kThreads) {
    const int i = idx / kTileV, j = idx % kTileV;
    St[idx] = (c0 + j < dv) ? Srow[static_cast<size_t>(i) * dv + c0 + j] : 0.f;
  }

  for (int t0 = 0; t0 < T_len; t0 += C) {
    __syncthreads();  // previous chunk done with Ks/Qs/Ut
    for (int idx = tid; idx < C * dk; idx += kThreads) {
      const int t = idx / dk, i = idx % dk;
      const size_t off = (qk_row * T_len + t0 + t) * dk + i;
      const bool ok = t0 + t < vl;
      Ks[t * ldk + i] = ok ? to_f(k[off]) : 0.f;
      Qs[t * ldk + i] = to_f(q[off]);
    }
    for (int idx = tid; idx < C * kTileV; idx += kThreads) {
      const int t = idx / kTileV, j = idx % kTileV;
      const bool ok = (t0 + t < vl) && (c0 + j < dv);
      Ut[idx] = ok ? to_f(v[(static_cast<size_t>(row) * T_len + t0 + t) * dv +
                            c0 + j])
                   : 0.f;
    }
    for (int t = tid; t < C; t += kThreads) {
      const bool ok = t0 + t < vl;
      const size_t off = static_cast<size_t>(row) * T_len + t0 + t;
      Lp[t] = ok ? log_g[off] : 0.f;
      Bt[t] = ok ? beta[off] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lg = Lp[t];
        acc += lg;
        L[t] = acc;
        Lp[t] = acc - lg;
      }
      for (int t = 0; t < C; ++t) W[t] = expf(acc - L[t]);
    }
    __syncthreads();

    // A (strictly lower) and M (inclusive lower)
    for (int idx = tid; idx < C * C; idx += kThreads) {
      const int t = idx / C, s = idx % C;
      float m = 0.f, a = 0.f;
      if (s <= t) {
        const float* qt = Qs + t * ldk;
        const float* kt = Ks + t * ldk;
        const float* ks = Ks + s * ldk;
        float dqk = 0.f, dkk = 0.f;
        for (int i = 0; i < dk; ++i) {
          dqk += qt[i] * ks[i];
          dkk += kt[i] * ks[i];
        }
        m = expf(L[t] - L[s]) * dqk;
        if (delta_rule && s < t) a = Bt[t] * expf(Lp[t] - L[s]) * dkk;
      }
      M[idx] = m;
      A[idx] = a;
    }
    // Q S0 and the right-hand side beta (V - exp(L_prev) K S0)
    for (int idx = tid; idx < C * kTileV; idx += kThreads) {
      const int t = idx / kTileV, j = idx % kTileV;
      const float* qt = Qs + t * ldk;
      const float* kt = Ks + t * ldk;
      float qs = 0.f, ks = 0.f;
      for (int i = 0; i < dk; ++i) {
        const float s = St[i * kTileV + j];
        qs += qt[i] * s;
        ks += kt[i] * s;
      }
      QSt[idx] = qs;
      if (delta_rule) Ut[idx] = Bt[t] * (Ut[idx] - expf(Lp[t]) * ks);
    }
    __syncthreads();

    // U = (I + A)^{-1} rhs: forward substitution, one thread per column
    if (delta_rule && tid < kTileV) {
      for (int t = 1; t < C; ++t) {
        float u = Ut[t * kTileV + tid];
        for (int s = 0; s < t; ++s) u -= A[t * C + s] * Ut[s * kTileV + tid];
        Ut[t * kTileV + tid] = u;
      }
    }
    __syncthreads();

    // O = scale (exp(L) Q S0 + M U)
    for (int idx = tid; idx < C * kTileV; idx += kThreads) {
      const int t = idx / kTileV, j = idx % kTileV;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += M[t * C + s] * Ut[s * kTileV + j];
      if (c0 + j < dv)
        O[(static_cast<size_t>(row) * T_len + t0 + t) * dv + c0 + j] =
            from_f<T>(scale * (expf(L[t]) * QSt[idx] + acc));
    }
    // S' = exp(L[C-1]) S0 + (W K)^T U   (each element owned by one thread)
    const float gC = expf(L[C - 1]);
    for (int idx = tid; idx < dk * kTileV; idx += kThreads) {
      const int i = idx / kTileV, j = idx % kTileV;
      float acc = 0.f;
      for (int t = 0; t < C; ++t)
        acc += W[t] * Ks[t * ldk + i] * Ut[t * kTileV + j];
      St[idx] = gC * St[idx] + acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < dk * kTileV; idx += kThreads) {
    const int i = idx / kTileV, j = idx % kTileV;
    if (c0 + j < dv) Srow[static_cast<size_t>(i) * dv + c0 + j] = St[idx];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* log_g,
           const void* beta, void* S, const void* valid_len, void* O,
           int BHv, int n_rep, int T_len, int C, int dk, int dv,
           float scale, int delta_rule, cudaStream_t stream) {
  const size_t smem = smem_floats(C, dk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gdn_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BHv, (dv + kTileV - 1) / kTileV);
  gdn_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_g),
      static_cast<const float*>(beta), static_cast<float*>(S),
      static_cast<const int*>(valid_len), static_cast<T*>(O), n_rep, T_len, C,
      dk, dv, scale, delta_rule);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory bytes one CTA needs for chunk C and key width dk.
extern "C" long long gdn_prefill_smem_bytes(int C, int dk) {
  return static_cast<long long>(smem_floats(C, dk) * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and O).  valid_len may be null.
// Returns a cudaError_t.
extern "C" int gdn_prefill_launch(const void* q, const void* k, const void* v,
                                  const void* log_g, const void* beta,
                                  void* S, const void* valid_len, void* O,
                                  int BHv, int n_rep, int T_len, int C,
                                  int dk, int dv, float scale, int delta_rule,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, log_g, beta, S, valid_len, O, BHv, n_rep,
                         T_len, C, dk, dv, scale, delta_rule, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, log_g, beta, S, valid_len, O, BHv,
                                 n_rep, T_len, C, dk, dv, scale, delta_rule,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
