// Chunkwise gated delta-rule prefill (UT/WY transform) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/gdn_prefill.py, gdn_prefill_pallas (its
// _kernel at line 43, _kernel_ragged at line 107, _nilpotent_inv_apply at
// line 32; pallas_call at line 163).
//
// Per chunk of C tokens with L = cumsum(log g), L_prev = L - log g:
//   A[t,s] = beta_t exp(L_prev[t] - L[s]) (k_t . k_s),  s < t
//   U = (I + A)^{-1} beta (V - exp(L_prev) (K S))   (delta rule; SSD: U = V)
//   O  = scale (exp(L) (Q S) + M U),
//   M[t,s] = exp(L[t] - L[s]) (q_t . k_s),  s <= t
//   S <- exp(L[C-1]) S + K^T (exp(L[C-1] - L) U)
//
// What bounds it on an H100: operations, at serving sizes.  One row of one
// chunk does 2 C^2 dk FLOP in Q K^T and K K^T (bf16 inputs: exact on the
// tensor cores), 6 C dk dv in K S, Q S and the state update and 2 C^2 dv
// in applying the inverse and M U, with an fp32 operand: ~7.9 MFLOP at
// C = 64, dk = dv = 128, against ~0.2 MB of traffic.
//
// Design: the TPU's sequential chunk grid axis becomes a loop over chunks
// inside the CTA, the state tile resident in shared memory: S is read once
// and written once per sequence.  U, O and S' are column-independent, so
// each CTA owns one (row, 32-column tile of d_v): grid (B*Hv, dv / 32),
// 128 CTAs of 256 threads at the serving shape (32 rows), one wave on the
// card's 132 SMs, so the kernel's time is one CTA's latency.  The C x C
// work (Q K^T, K K^T, the inverse) is repeated by the 4 column CTAs of a
// row: on the tensor cores it costs less than sharing it through a
// cluster's distributed shared memory would in synchronization.
// Chunks of C <= 64 tokens are padded to 64 rows (a padded row is a no-op).
//
// Two kernels share the chunk's gates, inverse and outputs:
// * gdn_prefill_tc_kernel, bf16 q/k/v at dk = 128 and dv a multiple of 8
//   (the served shape): every product with k or q on the tensor cores
//   (mma.sync m16n8k16, fp32 accumulators, operands by ldmatrix, K^T's by
//   ldmatrix.trans).  Q K^T and K K^T are exact; K S, Q S and K^T (W U)
//   multiply the bf16 k, q by the three bf16 parts of the fp32 state or
//   W U (x = p0 + p1 + p2 up to ~2^-24 |x|: three products that keep fp32
//   accuracy, where a plain bf16 or TF32 product could not hold S within
//   1e-4 of the fp32 scan).  The parts of the state are rebuilt from the
//   fp32 master tile as it is updated.  Per chunk:
//     1. k, q and the v tile into shared memory by cp.async (the first
//        chunk's copies overlapping the state's loads); warp 0 takes the
//        log-gate prefix sum by warp shuffles while warps 0-3 compute
//        their 16-row strip of Q K^T and Q S, warps 4-7 that of K K^T and
//        K S.
//     2. M and A from the accumulator fragments with their decays; the
//        right-hand side beta (V - exp(L_prev) K S) in place of V.
//     3.-4. the shared steps below, then S' = exp(L_C) S + K^T (W U).
// * gdn_prefill_kernel, every other shape (fp32 inputs, as the reduced
//   configurations serve, any dk that fits shared memory, any dv): k, q
//   as fp32 rows and every product with them as plain CUDA-core loops,
//   one output element per thread.
// Shared steps:
//   3. (I + A)^{-1} as a matrix, the blocked inverse of FLA's solve_tril
//      (prior art): warps 0-3 invert the four 16 x 16 unit lower
//      triangular diagonal blocks by forward substitution (one column per
//      lane, in registers), then blocks of doubling size n = 16, 32 give
//      the lower-left block of each 2n x 2n diagonal block, X_hl = -X_hh
//      (A_hl X_ll), as register-tiled products over all 256 threads.  It
//      is exact in exact arithmetic, as the TPU kernel's nilpotent
//      doubling.
//   4. U = X rhs and O = scale (exp(L) Q S + M U) on the CUDA cores in
//      fp32, register-tiled: thread (ty, tx) owns rows ty and ty + 32 and
//      columns 4 tx .. 4 tx + 3.
// GVA: value row b*Hv + hv reads the shared q/k row b*Hk + hv / R, which
// is row / R for Hv = R*Hk, directly (no repeat is materialized).
// valid_len (optional, per row) zeroes k, v, beta and log g at positions
// >= valid_len inside the kernel, so padding is an exact no-op on S (gate
// 1, rank-1 update 0), and a row with valid_len 0 keeps its state bitwise.
// Shared memory above 48 KB is enabled with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "tensor_core.cuh"

namespace {

using tc::bf16;

constexpr int kC = 64;          // chunk rows (C <= kC; the rest padding)
constexpr int kTV = 32;         // columns of d_v per CTA
constexpr int kThreads = 256;
constexpr int kLdc = kC + 4;    // row stride of the C x C fp32 matrices
constexpr int kLdp = kTV + 8;   // row stride of the bf16 split tiles
constexpr int kTcDk = 128;      // the tensor-core kernel's d_k

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ float at(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}
// acc[c] += a * x[c]
__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 x) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}

// x = p0 + p1 + p2 with each part a bf16 value (exact but for the last
// part's rounding, ~2^-24 |x|): products of bf16 operands with the three
// parts, summed in fp32, keep fp32 accuracy on the tensor cores
__device__ __forceinline__ void split3(float x, float (&p)[3]) {
  p[0] = __bfloat162float(__float2bfloat16(x));
  const float r = x - p[0];
  p[1] = __bfloat162float(__float2bfloat16(r));
  p[2] = r - p[1];
}
// the split parts of x[0..W) into the tiles dst + part * stride (bf16)
template <int W>
__device__ __forceinline__ void store_split(bf16* dst, int stride,
                                            const float (&x)[W]) {
  float p[W][3];
#pragma unroll
  for (int c = 0; c < W; ++c) split3(x[c], p[c]);
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    unsigned u[W / 2];
#pragma unroll
    for (int c = 0; c < W; c += 2)
      u[c / 2] = tc::pack_bf16(p[c][part], p[c + 1][part]);
    unsigned* d = reinterpret_cast<unsigned*>(dst + part * stride);
#pragma unroll
    for (int c = 0; c < W / 2; ++c) d[c] = u[c];
  }
}

// The chunk's tiles, which do not depend on d_k, at the start of both
// kernels' shared memory (byte offsets); each kernel's own tiles follow.
struct Chunk {
  static constexpr int V = 0;                   // kC x kTV fp32: v, rhs
  static constexpr int U = V + kC * kTV * 4;    // kC x kTV fp32
  static constexpr int QS = U + kC * kTV * 4;   // kC x kTV fp32: Q S
  static constexpr int M = QS + kC * kTV * 4;   // kC x kLdc fp32
  static constexpr int A = M + kC * kLdc * 4;
  static constexpr int X = A + kC * kLdc * 4;   // (I + A)^{-1}
  static constexpr int Tb = X + kC * kLdc * 4;  // kC x kC / 4 fp32 scratch
  static constexpr int G = Tb + kC * kC;        // 6 x kC fp32 gates
  static constexpr int kBytes = G + 6 * kC * 4;

  float *Vt, *Ut, *QSt, *Mm, *Am, *Xm, *Tb_;
  float *Lg, *Lp, *Bt, *Wt, *EL, *ELp;  // L, L_prev, beta, exp(L_C - L),
                                        // exp(L), exp(L_prev)
  __device__ explicit Chunk(unsigned char* s)
      : Vt(reinterpret_cast<float*>(s + V)),
        Ut(reinterpret_cast<float*>(s + U)),
        QSt(reinterpret_cast<float*>(s + QS)),
        Mm(reinterpret_cast<float*>(s + M)),
        Am(reinterpret_cast<float*>(s + A)),
        Xm(reinterpret_cast<float*>(s + X)),
        Tb_(reinterpret_cast<float*>(s + Tb)),
        Lg(reinterpret_cast<float*>(s + G)),
        Lp(Lg + kC), Bt(Lp + kC), Wt(Bt + kC), EL(Wt + kC), ELp(EL + kC) {}
};

// zeros above the diagonal blocks of X, which no chunk writes
__device__ __forceinline__ void clear_inverse(const Chunk& c, int tid) {
  for (int idx = tid; idx < kC * kC; idx += kThreads) {
    const int r = idx / kC, s = idx % kC;
    if (s / 16 > r / 16) c.Xm[r * kLdc + s] = 0.f;
  }
}

// warp 0: log g and beta at positions 2 lane and 2 lane + 1 of the chunk
// at t0 (0 past C and at padded positions)
__device__ __forceinline__ void read_gates(float (&lg)[2], float (&bt)[2],
                                           const float* log_g,
                                           const float* beta, int row,
                                           int T_len, int t0, int C, int vl,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = 2 * lane + h;
    const bool ok = t < C && t0 + t < vl;
    const size_t off = static_cast<size_t>(row) * T_len + t0 + t;
    lg[h] = ok ? log_g[off] : 0.f;
    bt[h] = ok ? beta[off] : 0.f;
  }
}

// warp 0: L = cumsum(log g) by warp shuffles, and the gates' decays
__device__ __forceinline__ void prefix_gates(const Chunk& c,
                                             const float (&lg)[2],
                                             const float (&bt)[2], int lane) {
  float x = lg[0] + lg[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  float ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = 0.f;
  const float l0 = ex + lg[0], l1 = l0 + lg[1];
  const float total = __shfl_sync(0xffffffffu, l1, 31);
  const float ls[2] = {l0, l1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = 2 * lane + h;
    const float lp = ls[h] - lg[h];
    c.Lg[t] = ls[h];
    c.Lp[t] = lp;
    c.Bt[t] = bt[h];
    c.Wt[t] = expf(total - ls[h]);
    c.EL[t] = expf(ls[h]);
    c.ELp[t] = expf(lp);
  }
}

// One level of the blocked inverse: for each of the kC / (2N) diagonal
// blocks of size 2N, whose two N x N diagonal blocks X_ll, X_hh are done,
// X_hl = -X_hh (A_hl X_ll), through the scratch T.  Thread tiles of R rows
// x 1 column (kC N / 2 elements over the CTA): per 4 steps of the inner
// dimension, R 16-byte row reads and 4 column reads for 4 R multiply-adds.
// Ends with a barrier.
template <int N>
__device__ __forceinline__ void inverse_level(float* X, const float* A,
                                              float* T, int tid) {
  constexpr int R = kC * N / 2 / kThreads;      // rows per thread
  const int c = tid % N, r0 = (tid / N) % (N / R) * R;
  const int blk = tid / (N * N / R);
  const int lo = 2 * N * blk, hi = lo + N;
  float* tb = T + blk * N * N;
  // out[i] = sum_u L[(r0 + i) * ldl + u] Rt[u * ldr]
  auto product = [&](float (&out)[R], const float* L, int ldl,
                     const float* Rt, int ldr) {
#pragma unroll
    for (int i = 0; i < R; ++i) out[i] = 0.f;
#pragma unroll 2
    for (int u = 0; u < N; u += 4) {
      float x[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) x[w] = Rt[(u + w) * ldr];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = ld4(L + (r0 + i) * ldl + u);
        out[i] = fmaf(a.x, x[0], out[i]);
        out[i] = fmaf(a.y, x[1], out[i]);
        out[i] = fmaf(a.z, x[2], out[i]);
        out[i] = fmaf(a.w, x[3], out[i]);
      }
    }
  };
  float acc[R];
  product(acc, A + hi * kLdc + lo, kLdc, X + lo * kLdc + lo + c, kLdc);
#pragma unroll
  for (int i = 0; i < R; ++i) tb[(r0 + i) * N + c] = acc[i];
  __syncthreads();
  product(acc, X + hi * kLdc + hi, kLdc, tb + c, N);
#pragma unroll
  for (int i = 0; i < R; ++i) X[(hi + r0 + i) * kLdc + lo + c] = -acc[i];
  __syncthreads();
}

// step 3: X = (I + A)^{-1}, blocked.  Ends with a barrier.
__device__ __forceinline__ void invert(const Chunk& c, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  if (warp < 4) {
    // diagonal block b = warp: lane j < 16 solves for column j by forward
    // substitution, each solved row updating the rows below
    const int b = 16 * warp, j = lane & 15;
    float x[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) x[r] = r == j ? 1.f : 0.f;
#pragma unroll
    for (int s = 0; s < 15; ++s)
#pragma unroll
      for (int r = s + 1; r < 16; ++r)
        x[r] = fmaf(-c.Am[(b + r) * kLdc + b + s], x[s], x[r]);
    if (lane < 16) {
#pragma unroll
      for (int r = 0; r < 16; ++r) c.Xm[(b + r) * kLdc + b + j] = x[r];
    }
  }
  __syncthreads();
  // then blocks of doubling size n: the lower-left n x n block of each
  // 2n x 2n diagonal block, X_hl = -X_hh (A_hl X_ll) (n = 16: blocks
  // (1, 0) and (3, 2); n = 32: rows 32-63, columns 0-31)
  inverse_level<16>(c.Xm, c.Am, c.Tb_, tid);
  inverse_level<32>(c.Xm, c.Am, c.Tb_, tid);
}

// out[r][c] = sum_{s <= ty + 32} L[t_r][s] R[s][4 tx + c] for the rows
// t_r = ty + 32 r of a lower triangular kC x kC L (row stride kLdc) and
// the kC x kTV tile R
__device__ __forceinline__ void rows_product(float (&out)[2][4],
                                             const float* L, const float* R,
                                             int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = 0.f;
#pragma unroll 2
  for (int s = 0; s <= ty + 32; s += 4) {
    const float4 l0 = ld4(L + ty * kLdc + s);
    const float4 l1 = ld4(L + (ty + 32) * kLdc + s);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float4 x = ld4(R + (s + w) * kTV + 4 * tx);
      fma4(out[0], at(l0, w), x);
      fma4(out[1], at(l1, w), x);
    }
  }
}

// step 4, first half: U = X rhs (SSD: U = V) at rows ty, ty + 32, stored
// to U and returned.  Both rows of a thread run one loop to the later
// row's diagonal (X is zero above it), so each rhs read feeds both.
__device__ __forceinline__ void solve(const Chunk& c, float (&u)[2][4],
                                      int delta_rule, int ty, int tx) {
  if (delta_rule) {
    rows_product(u, c.Xm, c.Vt, ty, tx);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float4 x = ld4(c.Vt + (ty + 32 * r) * kTV + 4 * tx);
      u[r][0] = x.x, u[r][1] = x.y, u[r][2] = x.z, u[r][3] = x.w;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st4(c.Ut + (ty + 32 * r) * kTV + 4 * tx, u[r]);
}

// step 4, second half (after a barrier): O = scale (exp(L) Q S + M U) at
// the chunk's rows t < C
template <typename T>
__device__ __forceinline__ void output(const Chunk& c, T* O, int row,
                                       int T_len, int t0, int C, int c0,
                                       int dv, float scale, int ty, int tx) {
  float o[2][4];
  rows_product(o, c.Mm, c.Ut, ty, tx);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = ty + 32 * r;
    if (t >= C) continue;
    const float4 qs = ld4(c.QSt + t * kTV + 4 * tx);
    const float e = c.EL[t];
    T* out = O + (static_cast<size_t>(row) * T_len + t0 + t) * dv + c0 + 4 * tx;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + 4 * tx + j < dv)
        out[j] = from_f<T>(scale * fmaf(e, at(qs, j), o[r][j]));
  }
}

// ---------------------------------------- bf16, dk = 128: tensor cores
//
// Shared memory after the chunk's tiles: the fp32 state tile, k, q and the
// v tile as bf16 rows, the three bf16 parts of the state tile and of W U.
struct TcSmem {
  static constexpr int LDK = kTcDk + 8;         // k, q row stride
  static constexpr int S = Chunk::kBytes;       // kTcDk x kTV fp32
  static constexpr int K = S + kTcDk * kTV * 4; // kC x LDK bf16
  static constexpr int Q = K + kC * LDK * 2;
  static constexpr int Vb = Q + kC * LDK * 2;   // kC x kLdp bf16
  static constexpr int Sp = Vb + kC * kLdp * 2; // 3 x kTcDk x kLdp bf16
  static constexpr int WUp = Sp + 3 * kTcDk * kLdp * 2;  // 3 x kC x kLdp
  static constexpr int kBytes = WUp + 3 * kC * kLdp * 2;
};

__global__ void __launch_bounds__(kThreads, 1)
    gdn_prefill_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ log_g,
                          const float* __restrict__ beta,
                          float* __restrict__ S,
                          const int* __restrict__ valid_len,
                          bf16* __restrict__ O, int n_rep, int T_len, int C,
                          int dv, float scale, int delta_rule) {
  constexpr int DK = kTcDk, LDK = TcSmem::LDK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Chunk c(smem_raw);
  float* St = reinterpret_cast<float*>(smem_raw + TcSmem::S);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + TcSmem::K);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + TcSmem::Q);
  bf16* Vb = reinterpret_cast<bf16*>(smem_raw + TcSmem::Vb);
  bf16* Sp = reinterpret_cast<bf16*>(smem_raw + TcSmem::Sp);
  bf16* WUp = reinterpret_cast<bf16*>(smem_raw + TcSmem::WUp);

  const int row = blockIdx.x;
  const size_t qk_row = static_cast<size_t>(row / n_rep);
  const int c0 = blockIdx.y * kTV;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int tx = tid & 7, ty = tid >> 3;        // 4 columns, rows ty, +32
  const int vl = valid_len ? valid_len[row] : T_len;
  // warps 0-3 own the 16-row strips mi of Q K^T (and Q S), warps 4-7 those
  // of K K^T (and K S)
  const int prod = warp >> 2, mi = warp & 3;
  const bool strip = prod == 0 || delta_rule;

  // cp.async of k, q and the v tile of the chunk at t0, zero past C and at
  // padded positions (q keeps its padded rows, as the reference)
  auto issue = [&](int t0) {
    for (int idx = tid; idx < kC * DK / 8; idx += kThreads) {
      const int t = idx / (DK / 8), i = (idx % (DK / 8)) * 8;
      const size_t off = (qk_row * T_len + t0 + t) * DK + i;
      const bool okq = t < C, okk = okq && t0 + t < vl;
      tc::cp_async16_zfill(Ks + t * LDK + i, k + (okk ? off : 0), okk);
      tc::cp_async16_zfill(Qs + t * LDK + i, q + (okq ? off : 0), okq);
    }
    for (int idx = tid; idx < kC * kTV / 8; idx += kThreads) {
      const int t = idx / (kTV / 8), j = (idx % (kTV / 8)) * 8;
      const bool ok = t < C && t0 + t < vl && c0 + j < dv;
      tc::cp_async16_zfill(
          Vb + t * kLdp + j,
          v + (ok ? (static_cast<size_t>(row) * T_len + t0 + t) * dv + c0 + j
                  : 0),
          ok);
    }
    tc::cp_async_commit();
  };
  issue(0);   // overlaps the state's loads below

  clear_inverse(c, tid);
  // the state tile and its three parts
  constexpr int kSL = DK * kTV / 4 / kThreads;   // float4s per thread
  float* Srow = S + static_cast<size_t>(row) * DK * dv;
  {
    float4 x[kSL];
#pragma unroll
    for (int n = 0; n < kSL; ++n) {
      const int idx = tid + n * kThreads, i = idx / (kTV / 4);
      const int j = (idx % (kTV / 4)) * 4;
      x[n] = c0 + j < dv ? ld4(Srow + static_cast<size_t>(i) * dv + c0 + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int n = 0; n < kSL; ++n) {
      const int idx = tid + n * kThreads;
      const float y[4] = {x[n].x, x[n].y, x[n].z, x[n].w};
      st4(St + 4 * idx, y);
      store_split<4>(Sp + idx / (kTV / 4) * kLdp + (idx % (kTV / 4)) * 4,
                     DK * kLdp, y);
    }
  }

  for (int t0 = 0; t0 < T_len; t0 += C) {
    if (t0 > 0) {
      __syncthreads();  // the previous chunk is done with every tile
      issue(t0);
    }
    // ---- 1. the chunk's k, q, v and, in warp 0, log g and beta
    float lg[2], bt[2];
    if (warp == 0)
      read_gates(lg, bt, log_g, beta, row, T_len, t0, C, vl, lane);
    tc::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) prefix_gates(c, lg, bt, lane);
    // Q K^T or K K^T on this warp's strip: rows 16 mi + gid (+8), columns
    // 8 j + 2 tig (+1); and Q S or K S, columns 8 n + 2 tig (+1)
    float cc[8][4], ps[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cc[j][e] = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ps[n][e] = 0.f;
    if (strip) {
      const bf16* ar = (prod ? Ks : Qs) + 16 * mi * LDK + tc::a_off<LDK>(lane);
      tc::mma_abt<1, 8, DK, LDK>(&cc, ar, Ks + tc::bt_off<LDK>(lane));
      // the exact products with the state's three parts
#pragma unroll 2
      for (int ks = 0; ks < DK / 16; ++ks) {
        unsigned af[1][4];
        tc::ldmatrix_x4(af[0], ar + 16 * ks);
#pragma unroll
        for (int part = 0; part < 3; ++part)
          tc::mma_ab16<1, 4, kLdp>(
              &ps, af,
              Sp + part * DK * kLdp + 16 * ks * kLdp + tc::b_off<kLdp>(lane));
      }
    }
    __syncthreads();  // the gates

    // ---- 2. M (inclusive lower) and A (strictly lower) with their decays;
    // Q S; the right-hand side beta (V - exp(L_prev) K S) in place of V
    if (strip) {
      float* D = prod ? c.Am : c.Mm;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * mi + gid + 8 * (e >> 1);
          const int s = 8 * j + 2 * tig + (e & 1);
          float x = 0.f;
          if (prod == 0 && s <= t) x = expf(c.Lg[t] - c.Lg[s]) * cc[j][e];
          if (prod == 1 && s < t)
            x = c.Bt[t] * expf(c.Lp[t] - c.Lg[s]) * cc[j][e];
          D[t * kLdc + s] = x;
        }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * mi + gid + 8 * (e >> 1);
        const int j = 8 * n + 2 * tig + (e & 1);
        if (prod == 0) {
          c.QSt[t * kTV + j] = ps[n][e];
        } else {
          const float x = to_f(Vb[t * kLdp + j]);
          c.Vt[t * kTV + j] =
              delta_rule ? c.Bt[t] * (x - c.ELp[t] * ps[n][e]) : x;
        }
      }
    __syncthreads();

    // ---- 3. X = (I + A)^{-1}; 4. U, then O and S'
    if (delta_rule) invert(c, tid);
    float u[2][4];
    solve(c, u, delta_rule, ty, tx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = ty + 32 * r;
      const float w = c.Wt[t];
      const float wu[4] = {w * u[r][0], w * u[r][1], w * u[r][2],
                           w * u[r][3]};
      store_split<4>(WUp + t * kLdp + 4 * tx, kC * kLdp, wu);
    }
    __syncthreads();
    output(c, O, row, T_len, t0, C, c0, dv, scale, ty, tx);
    // S' = exp(L_C) S + K^T (W o U), each element owned by one thread:
    // Kt's A fragments by ldmatrix.trans of the k rows, W o U's three parts
    // as B.  Warp w: rows 16 w of the state tile, all 32 columns.
    const float gC = expf(c.Lg[kC - 1]);
    const int m0 = 16 * warp;
    float sa[1][4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[0][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kC / 16; ++ks) {
      unsigned af[1][4];
      tc::ldmatrix_x4_trans(af[0],
                            Ks + 16 * ks * LDK + m0 + tc::bt_off<LDK>(lane));
#pragma unroll
      for (int part = 0; part < 3; ++part)
        tc::mma_ab16<1, 4, kLdp>(
            sa, af,
            WUp + part * kC * kLdp + 16 * ks * kLdp + tc::b_off<kLdp>(lane));
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m0 + gid + 8 * h, j = 8 * n + 2 * tig;
        float2* sp = reinterpret_cast<float2*>(St + i * kTV + j);
        const float2 x = *sp;
        const float y[2] = {fmaf(gC, x.x, sa[0][n][2 * h]),
                            fmaf(gC, x.y, sa[0][n][2 * h + 1])};
        *sp = make_float2(y[0], y[1]);
        store_split<2>(Sp + i * kLdp + j, DK * kLdp, y);
      }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < kSL; ++n) {
    const int idx = tid + n * kThreads, i = idx / (kTV / 4);
    const int j = (idx % (kTV / 4)) * 4;
    const float4 x = ld4(St + 4 * idx);
    const float y[4] = {x.x, x.y, x.z, x.w};
    if (c0 + j < dv) st4(Srow + static_cast<size_t>(i) * dv + c0 + j, y);
  }
}

// ------------------------------------------------ any shape: CUDA cores
//
// Shared memory after the chunk's tiles: the fp32 state tile (dk x kTV),
// then k and q as fp32 rows of stride dk + 1 (the C x C dot products are
// then free of bank conflicts).
__host__ __device__ inline size_t cuda_core_smem_bytes(int dk) {
  return Chunk::kBytes + static_cast<size_t>(dk) * kTV * 4 +
         2 * static_cast<size_t>(kC) * (dk + 1) * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    gdn_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ log_g,
                       const float* __restrict__ beta, float* __restrict__ S,
                       const int* __restrict__ valid_len, T* __restrict__ O,
                       int n_rep, int T_len, int C, int dk, int dv,
                       float scale, int delta_rule) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Chunk c(smem_raw);
  const int ldk = dk + 1;
  float* St = reinterpret_cast<float*>(smem_raw + Chunk::kBytes);
  float* Ks = St + dk * kTV;                    // kC x ldk
  float* Qs = Ks + kC * ldk;                    // kC x ldk

  const int row = blockIdx.x;
  const size_t qk_row = static_cast<size_t>(row / n_rep);
  const int c0 = blockIdx.y * kTV;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 7, ty = tid >> 3;
  const int vl = valid_len ? valid_len[row] : T_len;

  clear_inverse(c, tid);
  float* Srow = S + static_cast<size_t>(row) * dk * dv;
  for (int idx = tid; idx < dk * kTV; idx += kThreads) {
    const int i = idx / kTV, j = idx % kTV;
    St[idx] = c0 + j < dv ? Srow[static_cast<size_t>(i) * dv + c0 + j] : 0.f;
  }

  for (int t0 = 0; t0 < T_len; t0 += C) {
    __syncthreads();  // the previous chunk is done with every tile
    // ---- 1. the chunk's k, q, v (zero past C and at padded positions; q
    // keeps its padded rows, as the reference), log g and beta
    for (int idx = tid; idx < kC * dk; idx += kThreads) {
      const int t = idx / dk, i = idx % dk;
      const size_t off = (qk_row * T_len + t0 + t) * dk + i;
      Ks[t * ldk + i] = t < C && t0 + t < vl ? to_f(k[off]) : 0.f;
      Qs[t * ldk + i] = t < C ? to_f(q[off]) : 0.f;
    }
    for (int idx = tid; idx < kC * kTV; idx += kThreads) {
      const int t = idx / kTV, j = idx % kTV;
      const bool ok = t < C && t0 + t < vl && c0 + j < dv;
      c.Vt[idx] = ok ? to_f(v[(static_cast<size_t>(row) * T_len + t0 + t) *
                                  dv + c0 + j])
                     : 0.f;
    }
    if (warp == 0) {
      float lg[2], bt[2];
      read_gates(lg, bt, log_g, beta, row, T_len, t0, C, vl, lane);
      prefix_gates(c, lg, bt, lane);
    }
    __syncthreads();

    // ---- 2. M (inclusive lower) and A (strictly lower) with their decays
    for (int idx = tid; idx < kC * kC; idx += kThreads) {
      const int t = idx / kC, s = idx % kC;
      float m = 0.f, a = 0.f;
      if (s <= t) {
        const float* qt = Qs + t * ldk;
        const float* kt = Ks + t * ldk;
        const float* ks = Ks + s * ldk;
        float dqk = 0.f, dkk = 0.f;
        for (int i = 0; i < dk; ++i) {
          dqk = fmaf(qt[i], ks[i], dqk);
          dkk = fmaf(kt[i], ks[i], dkk);
        }
        m = expf(c.Lg[t] - c.Lg[s]) * dqk;
        if (delta_rule && s < t) a = c.Bt[t] * expf(c.Lp[t] - c.Lg[s]) * dkk;
      }
      c.Mm[t * kLdc + s] = m;
      c.Am[t * kLdc + s] = a;
    }
    // Q S and the right-hand side beta (V - exp(L_prev) K S)
    for (int idx = tid; idx < kC * kTV; idx += kThreads) {
      const int t = idx / kTV, j = idx % kTV;
      const float* qt = Qs + t * ldk;
      const float* kt = Ks + t * ldk;
      float qs = 0.f, ks = 0.f;
      for (int i = 0; i < dk; ++i) {
        const float s = St[i * kTV + j];
        qs = fmaf(qt[i], s, qs);
        ks = fmaf(kt[i], s, ks);
      }
      c.QSt[idx] = qs;
      if (delta_rule) c.Vt[idx] = c.Bt[t] * (c.Vt[idx] - c.ELp[t] * ks);
    }
    __syncthreads();

    // ---- 3. X = (I + A)^{-1}; 4. U, then O and S'
    if (delta_rule) invert(c, tid);
    float u[2][4];
    solve(c, u, delta_rule, ty, tx);
    __syncthreads();
    output(c, O, row, T_len, t0, C, c0, dv, scale, ty, tx);
    // S' = exp(L_C) S + K^T (W o U), each element owned by one thread
    const float gC = expf(c.Lg[kC - 1]);
    for (int idx = tid; idx < dk * kTV; idx += kThreads) {
      const int i = idx / kTV, j = idx % kTV;
      float acc = 0.f;
      for (int t = 0; t < kC; ++t)
        acc = fmaf(c.Wt[t] * Ks[t * ldk + i], c.Ut[t * kTV + j], acc);
      St[idx] = fmaf(gC, St[idx], acc);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < dk * kTV; idx += kThreads) {
    const int i = idx / kTV, j = idx % kTV;
    if (c0 + j < dv) Srow[static_cast<size_t>(i) * dv + c0 + j] = St[idx];
  }
}

// the tensor-core kernel takes bf16 (dtype 1) at its d_k and d_v a
// multiple of 8 (its 16-byte copies); the CUDA-core kernel the rest
bool tensor_core_route(int dk, int dv, int dtype) {
  return dtype == 1 && dk == kTcDk && dv % 8 == 0;
}

template <typename K, typename... Args>
int launch_kernel(K kernel, size_t smem, int BHv, int dv, cudaStream_t stream,
                  Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BHv, (dv + kTV - 1) / kTV);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory bytes one CTA needs for chunk C, key width dk, value width
// dv and dtype (0 = float32, 1 = bfloat16), or -1 where the kernel does not
// take them (C must be 1..64).
extern "C" long long gdn_prefill_smem_bytes(int C, int dk, int dv,
                                            int dtype) {
  if (C < 1 || C > kC || dk < 1 || dv < 1 || dtype < 0 || dtype > 1)
    return -1;
  if (tensor_core_route(dk, dv, dtype)) return TcSmem::kBytes;
  return static_cast<long long>(cuda_core_smem_bytes(dk));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and O).  bf16 at dk = 128 and
// dv a multiple of 8 runs the tensor-core kernel, which needs q/k/v and S
// 16-byte aligned.  valid_len may be null.  Returns a cudaError_t.
extern "C" int gdn_prefill_launch(const void* q, const void* k, const void* v,
                                  const void* log_g, const void* beta,
                                  void* S, const void* valid_len, void* O,
                                  int BHv, int n_rep, int T_len, int C,
                                  int dk, int dv, float scale, int delta_rule,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long smem = gdn_prefill_smem_bytes(C, dk, dv, dtype);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* lg = static_cast<const float*>(log_g);
  const auto* bt = static_cast<const float*>(beta);
  auto* s = static_cast<float*>(S);
  const auto* vl = static_cast<const int*>(valid_len);
  if (tensor_core_route(dk, dv, dtype))
    return launch_kernel(gdn_prefill_tc_kernel, smem, BHv, dv, st,
                         static_cast<const bf16*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), lg, bt, s, vl,
                         static_cast<bf16*>(O), n_rep, T_len, C, dv, scale,
                         delta_rule);
  if (dtype == 1)
    return launch_kernel(gdn_prefill_kernel<bf16>, smem, BHv, dv, st,
                         static_cast<const bf16*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), lg, bt, s, vl,
                         static_cast<bf16*>(O), n_rep, T_len, C, dk, dv,
                         scale, delta_rule);
  return launch_kernel(gdn_prefill_kernel<float>, smem, BHv, dv, st,
                       static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v), lg, bt, s, vl,
                       static_cast<float*>(O), n_rep, T_len, C, dk, dv,
                       scale, delta_rule);
}
