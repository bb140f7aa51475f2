// Causal (optionally windowed, optionally ragged) GQA flash-attention
// backward for Hopper, sm_90a: the dq kernel and the dk/dv kernels.
//
// Replaces: src/repro/kernels/flash_attn.py, flash_bwd (line 236): its
// _dq_kernel (line 166, pallas_call at line 258) and its _dkv_kernel
// (line 192, pallas_call at line 286).
//
// Inputs as the forward's (q, do: (BH, G, T, HD); k, v: (BH, T, HD); fp32
// or bf16), plus the forward's fp32 statistics m, l and
// delta = rowsum(do * o), (BH, G, T) each.  Every kernel rebuilds the
// probabilities tile by tile as p = exp(s - m) / max(l, 1e-30) (masked
// scores -1e30) and ds = p * (do v^T - delta); nothing of size T x T
// reaches device memory.  dq comes out in q's dtype; dk and dv, summed
// over the G query heads of each kv head, in k's dtype.
//
// What bounds them on an H100: operations.  dq does three causal products
// (q k^T, do v^T, ds k), dk/dv four (q k^T, do v^T, p^T do, ds^T q).
//
// dq, bf16 (tensor cores), modelled on the forward: a CTA of 4 warps owns
// 128 query rows of one (bh, g), each warp two m-tiles of 16 rows, the
// longest rows first (grid (BH * G, q tiles)).  Q and dO stay in shared
// memory; K and V flow through a two-stage cp.async ring of 32-key tiles
// (so that two CTAs fit an SM: 104,448 bytes each), from the window's
// lower bound to the causal diagonal.  Per key tile and warp: S = Q K^T
// (mma.sync m16n8k16, bf16 -> fp32), P = exp2(s scale log2 e - (m log2 e
// + log2 l)) in the forward's units (masked only on m-tiles whose tile
// crosses the diagonal, the window edge, valid_len or T; masked p exactly
// 0), dP = dO V^T, dS = P o (dP - delta) in place of P, rounded to bf16
// straight into the A operand of dq += dS K (K's B fragments from
// ldmatrix.trans).  At most two m-tiles x 32 keys of S and dP (64 fp32
// registers) are live beside the 128 dq accumulators; each K and V
// fragment read feeds both m-tiles (at HD 256 one m-tile per warp, 64
// rows per CTA, so that the accumulators stay at 128 per thread).  scale
// is applied at the store.  Each
// CTA owns its dq rows outright (no atomics), so dq is bitwise
// reproducible from run to run.
// dq, fp32 (kept on the card for its exactness): one CTA per (q tile of
// 64 rows, bh, g), the longest rows first, every product on the CUDA cores
// in fp32; Q and dO stay in shared memory and dq accumulates in registers;
// each key tile's V, then its K, pass through one shared tile (four fp32
// tiles would not fit at HD 256).
//
// dk/dv, bf16 (tensor cores): one CTA per (key tile of 64 rows, bh,
// query head), key tile 0 first (grid (BH * C, key tiles)), so no CTA
// walks more than T / 64 query tiles and the causal triangle spreads over
// the card.  K and V of the tile stay in shared memory; the Q and dO
// tiles of the query head, with their m, l and delta, stream through a
// two-stage cp.async ring from the causal diagonal to the window's upper
// bound.  4 warps, each owning 16 key rows: S^T = K Q^T and dP^T = V dO^T
// run on mma.sync m16n8k16 (bf16 -> fp32), so that P^T and dS^T = P^T o
// (dP^T - delta), packed to bf16 from the accumulator fragments, are
// already the A operands of dV += P^T dO and dK += dS^T Q (Q's and dO's B
// fragments from ldmatrix.trans).  dK and dV accumulate in fp32 registers.
// The sum over the G query heads of a kv head is one fixed order, so dk
// and dv are bitwise reproducible: the CTAs of one (bh, key tile) form a
// thread block cluster of C ranks (C divides G and is at most 8; the host
// picks it, ``flash_attn.cluster_size``: at the trained shape, G = 8,
// clusters of 4 CTAs of two heads each beat clusters of 8, measured by
// ``launch/profile_train.py --dkv-clusters``; rank r owns heads
// r G/C .. (r+1) G/C - 1 and sums them in registers, in order).  After the query loop a cluster barrier
// frees every rank's shared memory; each CTA then pushes its fp32
// partial (dK scale, dV) from its registers into the rank that owns each
// row — rank r owns rows [64 r / C, 64 (r+1) / C) and keeps one slot per
// sender where its ring and K/V tiles were — with distributed
// shared-memory stores, which do not wait for a reply (pulling the
// partials with remote loads instead was slower).  After a second
// barrier each rank sums its slots in rank order 0..C-1 from local
// shared memory and stores bf16 (round to nearest even: the reference's
// fp32 sum, then one cast).  No CTA touches a peer's memory after the
// second barrier, so none waits to exit.  One launch: no atomics, no fp32
// buffers, no zeroing, no cast.  Masked probabilities are exactly 0.  A
// key tile wholly at or past valid_len (the same for every CTA of the
// cluster, which shares bh and the tile) writes its zeros and returns
// before either barrier.
// HD 256: two dK and dV accumulators would be 256 fp32 registers per
// thread, so the CTAs split by role (blockIdx.z: dK, or dV, which skips
// dP): 1.25x the products of the fused kernel, the same sums in the same
// order (the cluster spans one role).  One launch still.
// dk/dv, fp32 (kept on the card for its exactness): one CTA per (key tile,
// bh, role: dK or dV) looping over the G query heads and their q tiles,
// every product on the CUDA cores; each CTA owns its rows of dk or dv
// outright.  Three fp32 tiles and one score tile of shared memory (HD
// 256: 217,856 bytes): K stays, Q and dO stream; the dK CTA reads the key
// tile's V into Q's tile first, for dP.

#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace tc;

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
  float* sKV = sDO + kTile * LD;     // V, then K, of each key tile
  float* sS = sKV + kTile * LD;

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
  float m_r[4], inv_l[4], d_r[4], acc[4][acc_cols(HD)];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool ok = row < T_len;
    m_r[i] = ok ? m[stat + row] : 0.f;
    inv_l[i] = ok ? 1.f / fmaxf(l[stat + row], 1e-30f) : 0.f;
    d_r[i] = ok ? delta[stat + row] : 0.f;
#pragma unroll
    for (int c = 0; c < acc_cols(HD); ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  kv_range(q0, valid, window, T_len, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * kTile;
    float s[4][4], dp[4][4];
    __syncthreads();                      // the last tile's readers are done
    load_tile<T, HD>(sKV, v + bh * head, k0, T_len);
    __syncthreads();
    tile_dot<HD>(dp, sDO, sKV, ty, tx);
    __syncthreads();
    load_tile<T, HD>(sKV, k + bh * head, k0, T_len);
    __syncthreads();
    tile_dot<HD>(s, sQ, sKV, ty, tx);
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
    tile_acc<HD, kLdp, 1>(acc, sS, sKV, ty, tx);  // acc += dS K
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
  float* sA = sK + kTile * LD;        // Q; for dK first the key tile's V
  float* sDO = sA + kTile * LD;
  float* sX = sDO + kTile * LD;       // P (dV) or dS (dK)
  float* sM = sX + kTile * kLdp;      // per q row of the tile: m, 1/l, delta
  float* sIL = sM + kTile;
  float* sD = sIL + kTile;

  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const bool want_k = blockIdx.z == 0;   // this CTA's sum: dK, else dV
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int valid = valid_len ? min(valid_len[bh], T_len) : T_len;
  const size_t head = static_cast<size_t>(T_len) * HD;
  const int nq = (T_len + kTile - 1) / kTile;

  float acc[4][acc_cols(HD)];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < acc_cols(HD); ++c) acc[i][c] = 0.f;

  if (k0 < valid) {
    load_tile<T, HD>(sK, k + bh * head, k0, T_len);
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
        load_tile<T, HD>(sDO, dout + bhg * head, q0, T_len);
        if (threadIdx.x < kTile) {
          const int row = q0 + threadIdx.x;
          const bool ok = row < T_len;
          sM[threadIdx.x] = ok ? m[stat + row] : 0.f;
          sIL[threadIdx.x] = ok ? 1.f / fmaxf(l[stat + row], 1e-30f) : 0.f;
          sD[threadIdx.x] = ok ? delta[stat + row] : 0.f;
        }
        // score tiles: rows are queries (ty + 16 i), columns keys
        // (tx + 16 j)
        float s[4][4], dp[4][4] = {};
        if (want_k) {
          load_tile<T, HD>(sA, v + bh * head, k0, T_len);
          __syncthreads();
          tile_dot<HD>(dp, sDO, sA, ty, tx);
          __syncthreads();
        }
        load_tile<T, HD>(sA, q + bhg * head, q0, T_len);
        __syncthreads();
        tile_dot<HD>(s, sA, sK, ty, tx);
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
            sX[qr * kLdp + kc] = want_k ? p * (dp[i][j] - sD[qr]) : p;
          }
        }
        __syncthreads();
        // this thread's key rows ty + 16 i: dk += dS^T Q, dv += P^T dO
        tile_acc<HD, 1, kLdp>(acc, sX, want_k ? sA : sDO, ty, tx);
      }
    }
  }
  const float f = want_k ? scale : 1.f;
  const float mul[4] = {f, f, f, f};
  store_rows<T, HD>((want_k ? dk : dv) + bh * head, acc, mul, k0, T_len, ty,
                    tx);
}

// ------------------------------------------------------------- dk/dv bf16

constexpr int kMaxCluster = 8;     // the portable cluster size

// accumulator arrays a dk/dv CTA keeps: dK and dV, or (kSplit) its one sum
__host__ __device__ constexpr int nw_max(bool split) {
  return split ? 1 : 2;
}

template <int HD, bool kSplit>
__global__ void __launch_bounds__(kTcThreads)
    flash_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          const int* __restrict__ valid_len, int G, int C,
                          int T_len, float scale, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = HD + kTcPad;
  constexpr int kElems = kTile * LD;             // one shared tile
  // a ring stage: Q, dO (bf16 tiles), then m, l, delta of its 64 rows
  constexpr int kStage = 2 * kElems + 3 * kTile * 2;   // in bf16 units
  constexpr int kVec = HD / 4;                   // float4 columns of a row
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kElems;
  bf16* ring = sV + kElems;

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / C;
  const int heads = G / C;                       // this CTA's, in order
  const int kt = blockIdx.y, k0 = kt * kTile;
  const size_t head = static_cast<size_t>(T_len) * HD;
  // the rows of the cluster's sum that this CTA reduces and stores
  const int row_lo = kTile * rank / C, row_hi = kTile * (rank + 1) / C;
  const int valid = valid_len ? min(valid_len[bh], T_len) : T_len;
  // kSplit: this CTA sums dK (blockIdx.z 0) or dV (1) alone; its cluster
  // shares blockIdx.z.  Otherwise both: `which` runs over [w0, w0 + nw)
  const int w0 = kSplit ? static_cast<int>(blockIdx.z) : 0;
  const int nw = kSplit ? 1 : 2;
  const bool want_k = w0 == 0, want_v = !kSplit || w0 == 1;
  if (k0 >= valid) {         // uniform over the cluster: no barrier follows
    const int n = (row_hi - row_lo) * kVec;
    for (int i = threadIdx.x; i < nw * n; i += kTcThreads) {
      const int which = w0 + i / n, e = i - (which - w0) * n;
      const int row = k0 + row_lo + e / kVec;
      if (row < T_len)
        store4((which ? dv : dk) + bh * head + static_cast<size_t>(row) * HD +
                   (e % kVec) * 4,
               make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const float sl2 = scale * kLog2e;
  const int nq = (T_len + kTile - 1) / kTile;
  const int k_last = min(k0 + kTile, T_len) - 1;
  const int q_lo = kt;                           // causal diagonal
  const int q_hi =
      window > 0 ? min(nq - 1, (k_last + window - 1) / kTile) : nq - 1;
  const int n_qt = q_hi - q_lo + 1;              // >= 1
  const int n_it = heads * n_qt;                 // (head, q tile) steps

  // Q, dO and the statistics of step `it` (head rank * heads + it / n_qt,
  // q tile q_lo + it % n_qt) into ring stage st
  auto issue_q = [&](int st, int it) {
    bf16* dst = ring + st * kStage;
    const int bhg = bh * G + rank * heads + it / n_qt;
    const int row0 = (q_lo + it % n_qt) * kTile;
    const size_t stat = static_cast<size_t>(bhg) * T_len;
    issue_rows<HD>(dst, q + bhg * head, row0, T_len);
    issue_rows<HD>(dst + kElems, dout + bhg * head, row0, T_len);
    float* sst = reinterpret_cast<float*>(dst + 2 * kElems);
    for (int i = threadIdx.x; i < 3 * kTile; i += kTcThreads) {
      const int which = i / kTile, row = row0 + i % kTile;
      const float* src = which == 0 ? m : which == 1 ? l : delta;
      const bool ok = row < T_len;
      cp_async4_zfill(sst + i, src + stat + (ok ? row : 0), ok);
    }
    cp_async_commit();
  };

  issue_rows<HD>(sK, k + bh * head, k0, T_len);
  if (want_k) issue_rows<HD>(sV, v + bh * head, k0, T_len);
  cp_async_commit();
  issue_q(0, 0);

  const int r0 = warp * 16;                      // this warp's key rows
  const int key_a = k0 + r0 + gid;               // elements 0, 1; + 8: 2, 3
  // dK's and dV's accumulators (kSplit: one array, the CTA's sum)
  float acc[nw_max(kSplit)][HD / 8][4];
  float(&acc_k)[HD / 8][4] = acc[0];
  float(&acc_v)[HD / 8][4] = acc[nw_max(kSplit) - 1];
#pragma unroll
  for (int a = 0; a < nw_max(kSplit); ++a)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      issue_q((it + 1) & 1, it + 1);  // its stage was freed last iteration
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQ = ring + (it & 1) * kStage;
    const bf16* sDO = sQ + kElems;
    const float* sM = reinterpret_cast<const float*>(sDO + kElems);
    const float* sL = sM + kTile;
    const float* sD = sL + kTile;
    const int q0 = (q_lo + it % n_qt) * kTile;

    // S^T = K Q^T: st[j] holds queries q0 + 8 j + 2 tig (+1)
    float st[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
    mma_abt<1, 8, HD, LD>(&st, sK + r0 * LD + a_off<LD>(lane),
                          sQ + bt_off<LD>(lane));
    // P^T = exp2(s scale log2 e - (m log2 e + log2 l)); masked: 0
    const bool full = tile_full(q0, k0, valid, window, T_len);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tig;
      const float nb[2] = {p_bias(sM[c], sL[c]),
                           p_bias(sM[c + 1], sL[c + 1])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = full || visible(q0 + c + (e & 1), key_a + (e >> 1) * 8,
                                        valid, window, T_len);
        st[j][e] =
            ok ? exp2_approx(fmaf(st[j][e], sl2, -nb[e & 1])) : 0.f;
      }
    }
    // dV += P^T dO, 16 queries per step
    if (want_v) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned pa[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        mma_ab16<1, HD / 8, LD>(&acc_v, &pa,
                                sDO + 16 * kk * LD + b_off<LD>(lane));
      }
    }
    if (want_k) {
      // dP^T = V dO^T
      float dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
      mma_abt<1, 8, HD, LD>(&dp, sV + r0 * LD + a_off<LD>(lane),
                            sDO + bt_off<LD>(lane));
      // dS^T = P^T o (dP^T - delta), in place of P^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= dp[j][e] - sD[c + (e & 1)];
      }
      // dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned da[4];
        acc_to_a(da, st[2 * kk], st[2 * kk + 1]);
        mma_ab16<1, HD / 8, LD>(&acc_k, &da,
                                sQ + 16 * kk * LD + b_off<LD>(lane));
      }
    }
    __syncthreads();                             // this stage is free again
  }

  // the cluster's sum of the fp32 partials: rank r owns key rows
  // [row_lo, row_hi) = [64 r / C, 64 (r+1) / C) and receives every rank's
  // partial of them in its shared memory, where its ring and K/V tiles
  // were, in slots [sender][row - row_lo][LDP] (rows padded by 8 floats:
  // a half warp's 8-byte stores fall in distinct banks)
  constexpr int LDP = HD + 8;
  const int slot_rows = (kTile + C - 1) / C;
  float* recv = reinterpret_cast<float*>(smem_raw);   // dK slots, then dV
  const int dv_at = C * slot_rows * LDP;
  cluster.sync();              // every rank is done with its tiles
  // push this CTA's partial from its registers (remote stores do not
  // wait for a reply)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + gid + 8 * h;
    const int owner = ((row + 1) * C - 1) / kTile;
    float* dst = cluster.map_shared_rank(recv, owner) +
                 (rank * slot_rows + row - kTile * owner / C) * LDP +
                 2 * tig;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (want_k)
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(
            scale * acc_k[n][2 * h], scale * acc_k[n][2 * h + 1]);
      if (want_v)
        *reinterpret_cast<float2*>(dst + dv_at + 8 * n) =
            make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
  cluster.sync();              // every partial has landed where it is owned
  // rows [row_lo, row_hi) of dK and dV: the C partials summed in rank
  // order from local shared memory, then one bf16 rounding
  const int n = (row_hi - row_lo) * kVec;
  for (int i = threadIdx.x; i < nw * n; i += kTcThreads) {
    const int which = w0 + i / n, e = i - (which - w0) * n;
    const int j = e / kVec, col = (e % kVec) * 4;
    const float* part = recv + which * dv_at + j * LDP + col;
    float4 sum = *reinterpret_cast<const float4*>(part);
    for (int p = 1; p < C; ++p) {
      const float4 x =
          *reinterpret_cast<const float4*>(part + p * slot_rows * LDP);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int row = k0 + row_lo + j;
    if (row < T_len)
      store4((which ? dv : dk) + bh * head + static_cast<size_t>(row) * HD +
                 col,
             sum);
  }
}

// ---------------------------------------------------------------- dq bf16

constexpr int kDqKeys = 32;            // keys per ring stage of the dq kernel

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq,
                         const int* __restrict__ valid_len, int G,
                         int T_len, float scale, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kMT = mtiles(HD);
  constexpr int kWarpRows = 16 * kMT;
  constexpr int kRows = kWarpRows * kTcThreads / 32;   // 128 (64) query rows
  constexpr int LD = HD + kTcPad;
  constexpr int kElems = kDqKeys * LD;           // one K or V stage tile
  constexpr int kNJ = kDqKeys / 8;               // n8 key tiles per stage
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);   // [stage][K, V][row][LD]
  bf16* sQ = sKV + 4 * kElems;                     // kRows rows
  bf16* sDO = sQ + kRows * LD;                     // kRows rows

  const int nq = (T_len + kRows - 1) / kRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kRows;
  const int bhg = blockIdx.x;                    // bh * G + g
  const int bh = bhg / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int valid = valid_len ? min(valid_len[bh], T_len) : T_len;
  const size_t head = static_cast<size_t>(T_len) * HD;
  const size_t stat = static_cast<size_t>(bhg) * T_len;
  const bf16* kh = k + bh * head;
  const bf16* vh = v + bh * head;
  const float sl2 = scale * kLog2e;

  int lo, hi;
  kv_range(q0, valid, window, T_len, &lo, &hi, kRows, kDqKeys);
  issue_rows<HD>(sQ, q + bhg * head, q0, T_len, kRows);
  issue_rows<HD>(sDO, dout + bhg * head, q0, T_len, kRows);
  cp_async_commit();
  if (lo <= hi) {
    issue_rows<HD>(sKV, kh, lo * kDqKeys, T_len, kDqKeys);
    issue_rows<HD>(sKV + kElems, vh, lo * kDqKeys, T_len, kDqKeys);
  }
  cp_async_commit();

  const int r0 = warp * kWarpRows;               // this warp's query rows
  const int w0 = q0 + r0;
  // m-tile t: rows w0 + 16 t + gid (fragment elements 0, 1) and + 8 (2, 3)
  float nb[kMT][2], dl[kMT][2];
#pragma unroll
  for (int t = 0; t < kMT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + 16 * t + gid + 8 * h;
      const bool ok = row < T_len;
      nb[t][h] = ok ? p_bias(m[stat + row], l[stat + row]) : 0.f;
      dl[t][h] = ok ? delta[stat + row] : 0.f;
    }
  float acc[kMT][HD / 8][4];
#pragma unroll
  for (int t = 0; t < kMT; ++t)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;
  // Q's and dO's A fragments are read from shared memory per use
  const bf16* qa = sQ + r0 * LD + a_off<LD>(lane);
  const bf16* da = sDO + r0 * LD + a_off<LD>(lane);

  for (int kt = lo; kt <= hi; ++kt) {
    const int it = kt - lo;
    if (kt < hi) {
      // its stage was freed by the sync that ended iteration it - 1
      bf16* nxt = sKV + ((it + 1) & 1) * 2 * kElems;
      issue_rows<HD>(nxt, kh, (kt + 1) * kDqKeys, T_len, kDqKeys);
      issue_rows<HD>(nxt + kElems, vh, (kt + 1) * kDqKeys, T_len, kDqKeys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sKV + (it & 1) * 2 * kElems;
    const bf16* sV = sK + kElems;
    const int k0 = kt * kDqKeys;
    // a warp none of whose pairs is visible skips the tile (its ds would
    // all be 0)
    if (tile_any(w0, k0, window, T_len, kWarpRows, kDqKeys)) {
      // S = Q K^T: s[t][j] holds keys k0 + 8 j + 2 tig (+1)
      float s[kMT][kNJ][4];
#pragma unroll
      for (int t = 0; t < kMT; ++t)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][j][e] = 0.f;
      mma_abt<kMT, kNJ, HD, LD>(s, qa, sK + bt_off<LD>(lane));
      // P = exp2(s scale log2 e - p_bias); masked: exactly 0
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        const int wt = w0 + 16 * t;
        const bool full = tile_full(wt, k0, valid, window, T_len, 16,
                                    kDqKeys);
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok =
                full || visible(wt + gid + (e >> 1) * 8,
                                k0 + 8 * j + 2 * tig + (e & 1), valid,
                                window, T_len);
            s[t][j][e] =
                ok ? exp2_approx(fmaf(s[t][j][e], sl2, -nb[t][e >> 1]))
                   : 0.f;
          }
      }
      // dP = dO V^T, then dS = P o (dP - delta) in place of P, rounded to
      // bf16 into the A fragments of dq += dS K (16 keys each)
      float dp[kMT][kNJ][4];
#pragma unroll
      for (int t = 0; t < kMT; ++t)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[t][j][e] = 0.f;
      mma_abt<kMT, kNJ, HD, LD>(dp, da, sV + bt_off<LD>(lane));
      unsigned dsa[kNJ / 2][kMT][4];
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[t][j][e] *= dp[t][j][e] - dl[t][e >> 1];
#pragma unroll
        for (int kk = 0; kk < kNJ / 2; ++kk)
          acc_to_a(dsa[kk][t], s[t][2 * kk], s[t][2 * kk + 1]);
      }
#pragma unroll
      for (int kk = 0; kk < kNJ / 2; ++kk)
        mma_ab16<kMT, HD / 8, LD>(acc, dsa[kk],
                                  sK + 16 * kk * LD + b_off<LD>(lane));
    }
    __syncthreads();                             // this stage is free again
  }
  cp_async_wait<0>();                            // Q and dO, when no tile ran

  bf16* dqh = dq + bhg * head;
#pragma unroll
  for (int t = 0; t < kMT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + 16 * t + gid + 8 * h;
      if (row >= T_len) continue;
      unsigned* orow = reinterpret_cast<unsigned*>(
          dqh + static_cast<size_t>(row) * HD + 2 * tig);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        orow[4 * n] = pack_bf16(scale * acc[t][n][2 * h],
                                scale * acc[t][n][2 * h + 1]);
    }
}

template <int HD>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* dout, const void* m, const void* l,
                   const void* delta, void* dq, const void* valid_len, int BH,
                   int G, int T_len, float scale, int window,
                   cudaStream_t stream) {
  constexpr int rows = 16 * mtiles(HD) * kTcThreads / 32;
  // two K/V stages of kDqKeys rows, the Q and dO tiles (HD 256: 135,168
  // bytes)
  const size_t smem = (4 * kDqKeys + 2 * rows) *
                      static_cast<size_t>(HD + kTcPad) * sizeof(bf16);
  auto kernel = flash_dq_bf16_kernel<HD>;
  int err = prepare(kernel, smem);
  if (err) return err;
  const dim3 grid(BH * G, (T_len + rows - 1) / rows);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<const int*>(valid_len), G, T_len, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* m, const void* l, const void* delta, void* dq,
              const void* valid_len, int BH, int G, int T_len, float scale,
              int window, cudaStream_t stream) {
  // Q, dO, one K/V tile and dS (HD 256: 217,088 bytes)
  const size_t smem =
      (3 * static_cast<size_t>(kTile) * (HD + kPad) + kTile * kLdp) *
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
  // K, Q (or V), dO, P (or dS) and the statistics (HD 256: 217,856
  // bytes); a CTA per (key tile, bh) for each of dK and dV
  const size_t smem = (3 * static_cast<size_t>(kTile) * (HD + kPad) +
                       kTile * kLdp + 3 * kTile) *
                      sizeof(float);
  int err = prepare(flash_dkv_kernel<T, HD>, smem);
  if (err) return err;
  const dim3 grid((T_len + kTile - 1) / kTile, BH, 2);
  flash_dkv_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<const int*>(valid_len), G, T_len,
      scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool kSplit = (HD > 128)>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* dout, const void* m, const void* l,
                    const void* delta, void* dk, void* dv,
                    const void* valid_len, int BH, int G, int C, int T_len,
                    float scale, int window, cudaStream_t stream) {
  if (C < 1 || C > kMaxCluster || G % C)
    return static_cast<int>(cudaErrorInvalidValue);
  // K, V and two ring stages of Q, dO and 3 x 64 fp32 statistics; the
  // received fp32 partials of dK and dV reuse it
  const size_t smem =
      2 * static_cast<size_t>(kTile) * (HD + kTcPad) * sizeof(bf16) +
      2 * (2 * static_cast<size_t>(kTile) * (HD + kTcPad) * sizeof(bf16) +
           3 * kTile * sizeof(float));
  // C slots of ceil(64 / C) rows of dK and dV, at most 70 rows (C = 7)
  static_assert(2 * 70 * (HD + 8) * sizeof(float) <=
                    6 * kTile * (HD + kTcPad) * sizeof(bf16),
                "the partials must fit where the tiles were");
  auto kernel = flash_dkv_bf16_kernel<HD, kSplit>;
  int err = prepare(kernel, smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH * C, (T_len + kTile - 1) / kTile, kSplit ? 2 : 1);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster of C such CTAs must fit the card at all (checked once per
  // cluster size): refuse rather than launch something else
  static int fits[kMaxCluster + 1] = {};
  if (!fits[C]) {
    int clusters = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(kernel), &cfg));
    if (err) return err;
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    fits[C] = 1;
  }
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<const int*>(valid_len), G, C,
      T_len, scale, window));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do, dq, dk and dv); hd 64,
// 80, 128 or 256; window <= 0 means none; valid_len is null or (BH,)
// int32.  dk and dv are (BH, T, hd) in k's dtype.  cluster (dk/dv, bf16
// only): the CTAs that sum a kv head's G query heads, a divisor of G up to
// 8.  Each returns a cudaError_t.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* m,
                               const void* l, const void* delta, void* dq,
                               const void* valid_len, int BH, int G,
                               int T_len, int hd, float scale, int window,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_DQ(HD)                                                        \
  if (hd == HD)                                                             \
    return dtype == 0   ? launch_dq<float, HD>(q, k, v, dout, m, l, delta, \
                                               dq, valid_len, BH, G, T_len, \
                                               scale, window, st)           \
           : dtype == 1 ? launch_dq_bf16<HD>(q, k, v, dout, m, l, delta,   \
                                             dq, valid_len, BH, G, T_len,   \
                                             scale, window, st)             \
                        : static_cast<int>(cudaErrorInvalidValue);
  FLASH_DQ(64)
  FLASH_DQ(80)
  FLASH_DQ(128)
  FLASH_DQ(256)
#undef FLASH_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* m,
                                const void* l, const void* delta, void* dk,
                                void* dv, const void* valid_len, int BH,
                                int G, int T_len, int hd, float scale,
                                int window, int dtype, void* stream,
                                int cluster) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_DKV(HD)                                                        \
  if (hd == HD)                                                              \
    return dtype == 0 ? launch_dkv<float, HD>(q, k, v, dout, m, l, delta,   \
                                              dk, dv, valid_len, BH, G,      \
                                              T_len, scale, window, st)      \
           : dtype == 1                                                      \
               ? launch_dkv_bf16<HD>(q, k, v, dout, m, l, delta, dk, dv,     \
                                     valid_len, BH, G, cluster, T_len,       \
                                     scale, window, st)                      \
               : static_cast<int>(cudaErrorInvalidValue);
  FLASH_DKV(64)
  FLASH_DKV(80)
  FLASH_DKV(128)
  FLASH_DKV(256)
#undef FLASH_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
