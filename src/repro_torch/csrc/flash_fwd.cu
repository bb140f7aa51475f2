// Causal (optionally windowed, optionally ragged) GQA flash-attention
// forward for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attn.py, flash_fwd (line 105; its
// _fwd_kernel at line 50, pallas_call at line 130).
//
// q: (BH, G, T, HD); k, v: (BH, T, HD), fp32 or bf16 (one dtype); the G
// query heads of row bh share its kv head.  Writes o (q's shape and dtype)
// and the two fp32 softmax statistics m (row max of the scaled masked
// scores) and l (row sum of exp(s - m)), (BH, G, T) each, in natural-log
// units, which the backward kernels read.  o = acc / max(l, 1e-30).
//
// What bounds it on an H100: operations.  At the trained shape (B=2,
// T=2048, Hq=16, Hkv=2, HD=128) it moves ~38 MB but does two causal
// products of B*Hq*T^2*HD/2 multiply-adds each.
//
// Both kernels: one CTA per (q tile, bh, g), the longest causal rows
// scheduled first; the CTA loops over the key tiles of 64 keys from the
// window's lower bound to the causal diagonal only (fully masked tiles are
// skipped; see flash::kv_range), with an online softmax whose m, l and
// accumulator stay in registers; nothing of size T x T reaches device
// memory.
//
// bf16 (the trained dtype): tensor cores.  A CTA of 4 warps owns 128 query
// rows, each warp two m-tiles of 16 rows (32 rows: each K and V fragment
// read from shared memory feeds two mma.sync, which measured faster on
// the H100 than one m-tile of 16 rows per warp with Q's fragments held in
// registers); at HD 256 one m-tile per warp, 64 rows per CTA (two would
// keep 256 fp32 accumulators per thread).  Q stays in shared memory; K
// and V tiles flow through a two-stage cp.async ring (16-byte copies,
// rows padded by 16 bytes so every ldmatrix is conflict-free), the next
// tile's copy overlapping this tile's math.  S = Q K^T is mma.sync
// m16n8k16 bf16 -> fp32; the mask is applied only on m-tiles whose tile
// crosses the diagonal, the window edge, valid_len or T (masked
// probabilities are exactly 0), and a warp none of whose pairs is visible
// skips the tile.  The online softmax runs
// on the accumulator fragments (quad shuffles, exp2 with scale * log2 e
// folded in, the row max kept in raw score units and written back as
// scale * max).  P is rounded to bf16 straight from the S fragments into
// the A operand of O += P V (as SDPA does; l sums the fp32 p), V's B
// fragments from ldmatrix.trans: nothing of P passes through shared
// memory.  Grid (BH * G, q tiles): the blocks of the longest rows launch
// first.
// fp32 (kept on the card for its exactness): 64-row q tiles, the products
// on the CUDA cores in fp32 with the tile layout of flash_common.cuh; the
// probability tile passes through shared memory into P V.

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace tc;

// ------------------------------------------------------------------ fp32

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
  float m_r[4], l_r[4], acc[4][acc_cols(HD)];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < acc_cols(HD); ++c) acc[i][c] = 0.f;
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
      for (int c = 0; c < acc_cols(HD); ++c) acc[i][c] *= corr;
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

// ------------------------------------------------------------------ bf16

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ m_out,
                          float* __restrict__ l_out,
                          const int* __restrict__ valid_len, int G,
                          int T_len, float scale, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kMT = mtiles(HD);
  constexpr int kWarpRows = 16 * kMT;
  constexpr int kRows = kWarpRows * kTcThreads / 32;   // 128 (64) query rows
  constexpr int LD = HD + kTcPad;
  constexpr int kElems = kTile * LD;             // one 64-row shared tile
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);   // [stage][K, V][row][LD]
  bf16* sQ = sKV + 4 * kElems;                     // kRows rows

  const int nq = (T_len + kRows - 1) / kRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kRows;
  const int bhg = blockIdx.x;                    // bh * G + g
  const int bh = bhg / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int valid = valid_len ? min(valid_len[bh], T_len) : T_len;
  const size_t head = static_cast<size_t>(T_len) * HD;
  const bf16* kh = k + bh * head;
  const bf16* vh = v + bh * head;
  const float sl2 = scale * kLog2e;

  int lo, hi;
  kv_range(q0, valid, window, T_len, &lo, &hi, kRows);
  issue_rows<HD>(sQ, q + bhg * head, q0, T_len, kRows);
  cp_async_commit();
  if (lo <= hi) {
    issue_rows<HD>(sKV, kh, lo * kTile, T_len);
    issue_rows<HD>(sKV + kElems, vh, lo * kTile, T_len);
  }
  cp_async_commit();

  const int r0 = warp * kWarpRows;               // this warp's query rows
  // Q's A fragments are read from shared memory per use (registers hold
  // two m-tiles' S and O)
  const bf16* qrow = sQ + r0 * LD + a_off<LD>(lane);
  // m-tile t: rows w0 + 16 t + gid (fragment elements 0, 1) and + 8 (2, 3)
  const int w0 = q0 + r0;
  float acc[kMT][HD / 8][4];
  float m_r[kMT][2], l_r[kMT][2];                // raw row max; part of l
#pragma unroll
  for (int t = 0; t < kMT; ++t) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;
    m_r[t][0] = m_r[t][1] = kNegInf;
    l_r[t][0] = l_r[t][1] = 0.f;
  }

  for (int kt = lo; kt <= hi; ++kt) {
    const int it = kt - lo;
    if (kt < hi) {
      // its stage was freed by the sync that ended iteration it - 1
      bf16* nxt = sKV + ((it + 1) & 1) * 2 * kElems;
      issue_rows<HD>(nxt, kh, (kt + 1) * kTile, T_len);
      issue_rows<HD>(nxt + kElems, vh, (kt + 1) * kTile, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sKV + (it & 1) * 2 * kElems;
    const bf16* sV = sK + kElems;
    const int k0 = kt * kTile;
    // a warp none of whose pairs is visible skips the tile (its p would
    // all be 0)
    if (tile_any(w0, k0, window, T_len, kWarpRows)) {
      // S = Q K^T: s[t][j] holds keys k0 + 8 j + 2 tig (+1)
      float s[kMT][8][4];
#pragma unroll
      for (int t = 0; t < kMT; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][j][e] = 0.f;
      mma_abt<kMT, 8, HD, LD>(s, qrow, sK + bt_off<LD>(lane));
#pragma unroll
      for (int t = 0; t < kMT; ++t) {
        const int wt = w0 + 16 * t;
        if (!tile_full(wt, k0, valid, window, T_len, 16)) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!visible(wt + gid + (e >> 1) * 8,
                           k0 + 8 * j + 2 * tig + (e & 1), valid, window,
                           T_len))
                s[t][j][e] = kNegInf;
        }
        float mx[2] = {m_r[t][0], m_r[t][1]};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(s[t][j][0], s[t][j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[t][j][2], s[t][j][3]));
        }
        float c[2], b[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = quad_max(mx[h]);
          c[h] = exp2_approx((m_r[t][h] - mx[h]) * sl2);
          m_r[t][h] = mx[h];
          b[h] = mx[h] * sl2;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                s[t][j][e] > 0.5f * kNegInf
                    ? exp2_approx(fmaf(s[t][j][e], sl2, -b[e >> 1]))
                    : 0.f;
            s[t][j][e] = p;
            rs[e >> 1] += p;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) l_r[t][h] = l_r[t][h] * c[h] + rs[h];
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          acc[t][n][0] *= c[0];
          acc[t][n][1] *= c[0];
          acc[t][n][2] *= c[1];
          acc[t][n][3] *= c[1];
        }
      }
      // O += P V, 16 keys per step; P's A fragments are S's own registers
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned pa[kMT][4];
#pragma unroll
        for (int t = 0; t < kMT; ++t)
          acc_to_a(pa[t], s[t][2 * kk], s[t][2 * kk + 1]);
        mma_ab16<kMT, HD / 8, LD>(acc, pa,
                                  sV + 16 * kk * LD + b_off<LD>(lane));
      }
    }
    __syncthreads();                             // this stage is free again
  }
  cp_async_wait<0>();                            // Q, when no tile ran

  bf16* oh = o + bhg * head;
#pragma unroll
  for (int t = 0; t < kMT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + 16 * t + gid + 8 * h;
      const float l_row = quad_sum(l_r[t][h]);   // the whole quad calls it
      if (row >= T_len) continue;
      const float inv = 1.f / fmaxf(l_row, 1e-30f);
      unsigned* orow = reinterpret_cast<unsigned*>(
          oh + static_cast<size_t>(row) * HD + 2 * tig);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        orow[4 * n] =
            pack_bf16(acc[t][n][2 * h] * inv, acc[t][n][2 * h + 1] * inv);
      if (tig == 0) {
        const size_t at = static_cast<size_t>(bhg) * T_len + row;
        m_out[at] = m_r[t][h] > 0.5f * kNegInf ? scale * m_r[t][h] : kNegInf;
        l_out[at] = l_row;
      }
    }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* m, void* l, const void* valid_len, int BH, int G,
                int T_len, float scale, int window, cudaStream_t stream) {
  constexpr int rows = 16 * mtiles(HD) * kTcThreads / 32;
  // two K/V stages and the Q tile (HD 256: 168,960 bytes)
  const size_t smem = (4 * kTile + rows) * static_cast<size_t>(HD + kTcPad) *
                      sizeof(bf16);
  auto kernel = flash_fwd_bf16_kernel<HD>;
  int err = prepare(kernel, smem);
  if (err) return err;
  const dim3 grid(BH * G, (T_len + rows - 1) / rows);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<const int*>(valid_len), G, T_len, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o); hd 64, 80, 128 or
// 256; window <= 0 means none; valid_len is null or (BH,) int32.  Returns
// a cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* m, void* l,
                                const void* valid_len, int BH, int G,
                                int T_len, int hd, float scale, int window,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_FWD(HD)                                                        \
  if (hd == HD)                                                              \
    return dtype == 0 ? launch<float, HD>(q, k, v, o, m, l, valid_len, BH,  \
                                          G, T_len, scale, window, st)       \
           : dtype == 1 ? launch_bf16<HD>(q, k, v, o, m, l, valid_len, BH,  \
                                          G, T_len, scale, window, st)       \
                        : static_cast<int>(cudaErrorInvalidValue);
  FLASH_FWD(64)
  FLASH_FWD(80)
  FLASH_FWD(128)
  FLASH_FWD(256)
#undef FLASH_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}
