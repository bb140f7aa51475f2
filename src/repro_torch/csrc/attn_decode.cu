// One-token GQA flash-decode against a (rolling) KV cache for Hopper,
// sm_90a.
//
// Replaces: src/repro/kernels/attn_decode.py, attn_decode_pallas (line 78;
// its _kernel at line 28, pallas_call at line 108).
//
// q: (B, Hq, D); k, v: (B, Hkv, T, D), bf16 or fp32 (one dtype); the G =
// Hq / Hkv query heads hkv*G .. hkv*G+G-1 share kv head hkv.  length: (B,)
// int32, the raw token count, which may exceed T on a rolling cache: the
// kernel clamps occupancy itself.  Slot t is occupied iff t < min(length,
// T); with a window it holds absolute position (length-1) -
// ((length-1-t) mod T) and is visible iff that position >= length -
// window.  o: (B, Hq, D) in q's dtype; masked slots weigh exactly 0,
// o = acc / max(l, 1e-30).
//
// What bounds it on an H100: bytes.  Each occupied K and V row is read
// once, 2*D elements per (row, kv head), against 4*G*D FLOP: at bf16,
// G = 8, D = 128 that is 8 FLOP per byte.
//
// Design (flash-decoding).  The TPU kernel walks the cache as a sequential
// grid axis, one program per (b, kv head); on the card that would be 8
// CTAs at qwen3-next-gdn's serving shape and 4 at yi-9b's batch-1 shape,
// for 132 SMs.  So T is split across CTAs: grid (splits, Hkv, B), one CTA
// per split of `split` slots of one (b, kv head), holding the G query
// heads of that kv head together so every K/V row is read once for the
// group (the GQA form of the paper's paired-head datapath).  The CTA walks
// its split in tiles of kTile rows, two tiles in flight: while it computes
// on one, cp.async copies the next K and V tiles into the other half of a
// double buffer in shared memory (16-byte copies; rows padded by 16 bytes
// so that 8 threads reading 16 bytes at consecutive rows, or a quad of
// threads reading 4 bytes at 8 rows, fall in distinct banks).  A split
// writes its unnormalized (m, l, acc) per head; the merge kernel combines
// the splits of a (b, q head) by log-sum-exp.  Splits that start at or
// past min(length, T) return at once, and the merge reads only the splits
// below that bound, so they contribute nothing.  Masked probabilities are
// set to 0, never computed as exp(-1e30 - -1e30): a split whose occupied
// slots all lie outside the window ends with m = -1e30, l = 0, acc = 0,
// and its merge weight exp(-1e30 - M) is 0.
//
// bf16 (the served dtype): tensor cores, mma.sync m16n8k16 with fp32
// accumulators.  The G <= 16 query heads are the 16 rows of the A operand
// (rows >= G are zero), each warp takes 16 keys of the tile: S = Q K^T in
// two 16x8 tiles, a per-warp online softmax on the fragments (rows gid and
// gid + 8 of each quad), P rounded to bf16 (as attn_decode_xla and SDPA
// do) straight from the S fragments into the A operand of O += P V, V's
// B fragments from ldmatrix.trans.  At the end of the split the four
// warps' (m, l, O) are merged in shared memory.
// fp32 (the CPU tests' dtype, kept on the card for its exactness): CUDA
// cores, each thread scores one key row against half of the heads, one
// warp per head updates the online softmax, each thread accumulates
// (head, 4-column) pairs of P V in registers.
// Both take D a multiple of 16, at most 128, and 16-byte aligned caches.

#include <cstddef>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                      // key rows per tile
constexpr int kMaxG = 16;                      // query heads per kv head
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
// fp32 kernel
constexpr int kGroups = kThreads / kTile;      // head groups in the scores
constexpr int kGPerThread = kMaxG / kGroups;
constexpr int kMaxPairs = kMaxG * (kMaxD / 4) / kThreads;
constexpr int kPS = kTile + 1;                 // score row stride (floats)

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp.astype
}

// copy rows [t0, t0 + rows) of one (b, kv head)'s K and V into a stage
// (K at dst, V at dst + tile), 16 bytes per cp.async
template <typename T>
__device__ __forceinline__ void issue_tile(T* dst, const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           size_t row0, int rows, int D,
                                           int LD, int tile) {
  constexpr int E = 16 / sizeof(T);
  const int nc = D / E;
  const int n = rows * nc;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / nc, c = (i - r * nc) * E;
    const size_t g = (row0 + r) * D + c;
    cp_async16(dst + r * LD + c, k + g);
    cp_async16(dst + tile + r * LD + c, v + g);
  }
  cp_async_commit();
}

__device__ __forceinline__ bool visible(int len, int t, int T_len,
                                        int window) {
  return window <= 0 || (len - 1) - ((len - 1 - t) % T_len) >= len - window;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ------------------------------------------------------------------ bf16

__global__ void __launch_bounds__(kThreads)
    attn_decode_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int* __restrict__ length,
                            float* __restrict__ m_part,
                            float* __restrict__ l_part,
                            float* __restrict__ acc_part, int Hkv, int G,
                            int T_len, int D, int split, float scale,
                            int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = D + 8;                        // row + 16 bytes
  const int tile = kTile * LD;
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);   // [stage][K, V][row][LD]
  bf16* sQ = sKV + 4 * tile;                       // 16 x LD

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = length[b];
  const int occ = max(0, min(len, T_len));
  const int t_begin = s * split;
  if (t_begin >= occ) return;  // uniform over the block: nothing to read
  const int t_end = min(t_begin + split, occ);
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t kv0 = (static_cast<size_t>(b) * Hkv + h) * T_len;
  const size_t qrow0 = static_cast<size_t>(b) * Hkv * G + h * G;

  // zero the stages and Q: smem never written must not reach the mma
  // (0 * NaN), and Q's rows >= G stay zero
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n = (4 * tile + 16 * LD) * static_cast<int>(sizeof(bf16)) / 16;
    for (int i = tid; i < n; i += kThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  issue_tile(sKV, k, v, kv0 + t_begin, min(kTile, t_end - t_begin), D, LD,
             tile);
  for (int i = tid; i < G * D; i += kThreads)
    sQ[(i / D) * LD + i % D] = q[qrow0 * D + i];
  __syncthreads();

  const int nks = D / 16, nd = D / 8;
  unsigned qa[kMaxD / 16][4];                  // Q's A fragments
#pragma unroll
  for (int ks = 0; ks < kMaxD / 16; ++ks) {
    if (ks < nks) {
      const bf16* r = sQ + gid * LD + ks * 16 + tig * 2;
      qa[ks][0] = ld32(r);
      qa[ks][1] = ld32(r + 8 * LD);
      qa[ks][2] = ld32(r + 8);
      qa[ks][3] = ld32(r + 8 * LD + 8);
    }
  }
  float acc[kMaxD / 8][4];                     // O, rows gid and gid + 8
#pragma unroll
  for (int n = 0; n < kMaxD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kTile;
    const int rows = min(kTile, t_end - t0);
    if (it + 1 < n_tiles) {
      // its stage was freed by the sync that ended iteration it - 1
      issue_tile(sKV + ((it + 1) & 1) * 2 * tile, k, v, kv0 + t0 + kTile,
                 min(kTile, t_end - t0 - kTile), D, LD, tile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sK = sKV + (it & 1) * 2 * tile;
    const bf16* sV = sK + tile;
    const int r0 = warp * 16;                  // this warp's 16 keys
    if (r0 < rows) {
      float sc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kMaxD / 16; ++ks) {
        if (ks < nks) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const bf16* kr = sK + (r0 + 8 * j + gid) * LD + ks * 16 + tig * 2;
            mma_bf16(sc[j], qa[ks], ld32(kr), ld32(kr + 8));
          }
        }
      }
      // sc[j][e]: head gid (e < 2) or gid + 8, key r0 + 8j + 2 tig + e % 2
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = r0 + 8 * j + 2 * tig + (e & 1);
          const bool ok =
              key < rows && visible(len, t0 + key, T_len, window);
          sc[j][e] = ok ? scale * sc[j][e] : kNegInf;
          if (e < 2)
            mx0 = fmaxf(mx0, sc[j][e]);
          else
            mx1 = fmaxf(mx1, sc[j][e]);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = sc[j][e] > 0.5f * kNegInf
                        ? expf(sc[j][e] - (e < 2 ? mn0 : mn1))
                        : 0.f;
      l0 = l0 * c0 + p[0][0] + p[0][1] + p[1][0] + p[1][1];
      l1 = l1 * c1 + p[0][2] + p[0][3] + p[1][2] + p[1][3];
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
      const bf16* vr = sV + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < kMaxD / 8; n += 2) {
        if (n < nd) {
          acc[n][0] *= c0;
          acc[n][1] *= c0;
          acc[n][2] *= c1;
          acc[n][3] *= c1;
          acc[n + 1][0] *= c0;
          acc[n + 1][1] *= c0;
          acc[n + 1][2] *= c1;
          acc[n + 1][3] *= c1;
          unsigned vb[4];
          ldmatrix_x4_trans(vb, vr + n * 8);
          mma_bf16(acc[n], pa, vb[0], vb[1]);
          mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is free again
  }

  // merge the four warps' (m, l, O) in shared memory (the stages are free)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* wO = reinterpret_cast<float*>(smem_raw);  // [warp][16][D]
  float* wM = wO + kWarps * 16 * D;                // [warp][16]
  float* wL = wM + kWarps * 16;
  float* o0 = wO + (warp * 16 + gid) * D + 2 * tig;
#pragma unroll
  for (int n = 0; n < kMaxD / 8; ++n) {
    if (n < nd) {
      o0[8 * n] = acc[n][0];
      o0[8 * n + 1] = acc[n][1];
      o0[8 * D + 8 * n] = acc[n][2];
      o0[8 * D + 8 * n + 1] = acc[n][3];
    }
  }
  if (tig == 0) {
    wM[warp * 16 + gid] = m0;
    wM[warp * 16 + gid + 8] = m1;
    wL[warp * 16 + gid] = l0;
    wL[warp * 16 + gid + 8] = l1;
  }
  __syncthreads();
  const int n_split = gridDim.x;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, e = i % D;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wM[w * 16 + g]);
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w)
      a += expf(wM[w * 16 + g] - M) * wO[(w * 16 + g) * D + e];
    acc_part[((qrow0 + g) * n_split + s) * D + e] = a;
  }
  if (tid < G) {
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wM[w * 16 + tid]);
    float L = 0.f;
    for (int w = 0; w < kWarps; ++w)
      L += expf(wM[w * 16 + tid] - M) * wL[w * 16 + tid];
    m_part[(qrow0 + tid) * n_split + s] = M;
    l_part[(qrow0 + tid) * n_split + s] = L;
  }
}

// ------------------------------------------------------------------ fp32

__global__ void __launch_bounds__(kThreads)
    attn_decode_fp32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ length,
                            float* __restrict__ m_part,
                            float* __restrict__ l_part,
                            float* __restrict__ acc_part, int Hkv, int G,
                            int T_len, int D, int split, float scale,
                            int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = D + 4;                        // row + 16 bytes
  const int tile = kTile * LD;
  float* sKV = reinterpret_cast<float*>(smem_raw);  // [stage][K, V][row][LD]
  float* sQ = sKV + 4 * tile;                       // G x D
  float* sP = sQ + G * D;                           // G x kPS
  float* sM = sP + G * kPS;                         // kMaxG each
  float* sL = sM + kMaxG;
  float* sC = sL + kMaxG;

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = length[b];
  const int occ = max(0, min(len, T_len));
  const int t_begin = s * split;
  if (t_begin >= occ) return;  // uniform over the block: nothing to read
  const int t_end = min(t_begin + split, occ);
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t kv0 = (static_cast<size_t>(b) * Hkv + h) * T_len;
  const size_t qrow0 = static_cast<size_t>(b) * Hkv * G + h * G;

  issue_tile(sKV, k, v, kv0 + t_begin, min(kTile, t_end - t_begin), D, LD,
             tile);
  for (int i = tid; i < G * D; i += kThreads) sQ[i] = q[qrow0 * D + i];
  if (tid < G) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  const int nc = D / 4, npairs = G * nc;
  const int srow = tid % kTile, g0 = tid / kTile;
  float4 acc[kMaxPairs];
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kTile;
    const int rows = min(kTile, t_end - t0);
    if (it + 1 < n_tiles) {
      issue_tile(sKV + ((it + 1) & 1) * 2 * tile, k, v, kv0 + t0 + kTile,
                 min(kTile, t_end - t0 - kTile), D, LD, tile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` (and sQ, sM, sL) visible to all
    const float* sK = sKV + (it & 1) * 2 * tile;
    const float* sV = sK + tile;

    // scores: key row srow against heads g0, g0 + kGroups, ...
    if (srow < rows) {
      float sc[kGPerThread];
#pragma unroll
      for (int i = 0; i < kGPerThread; ++i) sc[i] = 0.f;
      const float* kr = sK + srow * LD;
      for (int c = 0; c < D; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int i = 0; i < kGPerThread; ++i) {
          const int g = g0 + kGroups * i;
          if (g < G) {
            const float4 qq = *reinterpret_cast<const float4*>(sQ + g * D + c);
            sc[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
          }
        }
      }
      const bool ok = visible(len, t0 + srow, T_len, window);
#pragma unroll
      for (int i = 0; i < kGPerThread; ++i) {
        const int g = g0 + kGroups * i;
        if (g < G) sP[g * kPS + srow] = ok ? scale * sc[i] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax of each head over this tile: one warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* row = sP + g * kPS;
      const float x0 = lane < rows ? row[lane] : kNegInf;
      const float x1 = lane + 32 < rows ? row[lane + 32] : kNegInf;
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float p0 = x0 > 0.5f * kNegInf ? expf(x0 - m_new) : 0.f;
      const float p1 = x1 > 0.5f * kNegInf ? expf(x1 - m_new) : 0.f;
      if (lane < rows) row[lane] = p0;
      if (lane + 32 < rows) row[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[g] = corr;
        sL[g] = corr * sL[g] + psum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // acc <- corr * acc + P V for this thread's (head, 4-column) pairs
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int pi = tid + kThreads * j;
      if (pi < npairs) {
        const int g = pi / nc, c = (pi % nc) * 4;
        const float corr = sC[g];
        float4 a = acc[j];
        a.x *= corr;
        a.y *= corr;
        a.z *= corr;
        a.w *= corr;
        const float* prow = sP + g * kPS;
        for (int r = 0; r < rows; ++r) {
          const float p = prow[r];
          const float4 vv = *reinterpret_cast<const float4*>(sV + r * LD + c);
          a.x += p * vv.x;
          a.y += p * vv.y;
          a.z += p * vv.z;
          a.w += p * vv.w;
        }
        acc[j] = a;
      }
    }
    __syncthreads();  // this stage and sP are free again
  }

  const int n_split = gridDim.x;
  if (tid < G) {
    m_part[(qrow0 + tid) * n_split + s] = sM[tid];
    l_part[(qrow0 + tid) * n_split + s] = sL[tid];
  }
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int pi = tid + kThreads * j;
    if (pi < npairs) {
      const int g = pi / nc, c = (pi % nc) * 4;
      *reinterpret_cast<float4*>(
          acc_part + ((qrow0 + g) * n_split + s) * D + c) = acc[j];
    }
  }
}

// ------------------------------------------------------------------ merge

// one CTA per (b, q head): o = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30)
// with w_s = exp(m_s - max_s m_s), over the splits that ran; the weights
// go through shared memory, and the sum over splits is unrolled so that
// several rows of acc are in flight
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_decode_merge_kernel(const float* __restrict__ m_part,
                             const float* __restrict__ l_part,
                             const float* __restrict__ acc_part,
                             const int* __restrict__ length,
                             T* __restrict__ o, int Hq, int T_len, int D,
                             int split, int n_split) {
  extern __shared__ float sw[];                // n_split weights
  __shared__ float red[2][kWarps];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int occ = max(0, min(length[row / Hq], T_len));
  const int live = (occ + split - 1) / split;
  const float* mr = m_part + static_cast<size_t>(row) * n_split;
  const float* lr = l_part + static_cast<size_t>(row) * n_split;
  const float* ar = acc_part + static_cast<size_t>(row) * n_split * D;
  float mx = kNegInf;
  for (int s = tid; s < live; s += kThreads) mx = fmaxf(mx, mr[s]);
  mx = warp_max(mx);
  if (lane == 0) red[0][warp] = mx;
  __syncthreads();
  float M = red[0][0];
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red[0][w]);
  float dn = 0.f;
  for (int s = tid; s < live; s += kThreads) {
    const float w = expf(mr[s] - M);
    sw[s] = w;
    dn += w * lr[s];
  }
  dn = warp_sum(dn);
  if (lane == 0) red[1][warp] = dn;
  __syncthreads();
  float denom = 0.f;
  for (int w = 0; w < kWarps; ++w) denom += red[1][w];
  denom = fmaxf(denom, 1e-30f);
  for (int e = tid; e < D; e += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s)
      a += sw[s] * ar[static_cast<size_t>(s) * D + e];
    o[static_cast<size_t>(row) * D + e] = from_f<T>(a / denom);
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* q, const void* k,
           const void* v, const int* length, void* o, float* m_part,
           float* l_part, float* acc_part, int B, int Hq, int Hkv, int T_len,
           int D, int split, float scale, int window, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_split = (T_len + split - 1) / split;
  kernel<<<dim3(n_split, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, m_part, l_part, acc_part, Hkv,
      Hq / Hkv, T_len, D, split, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_decode_merge_kernel<T>
      <<<B * Hq, kThreads, n_split * sizeof(float), stream>>>(
      m_part, l_part, acc_part, length, static_cast<T*>(o), Hq, T_len, D,
      split, n_split);
  return static_cast<int>(cudaGetLastError());
}

size_t split_smem(int D, int G, int dtype) {
  return dtype == 0 ? (4 * kTile * (D + 4) + G * D + G * kPS + 3 * kMaxG) *
                          sizeof(float)
                    : (4 * kTile + 16) * (D + 8) * sizeof(bf16);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).  window <= 0: none.
// m_part, l_part: (B * Hq * n_split) fp32 and acc_part (B * Hq * n_split *
// D) fp32 scratch, n_split = ceil(T / split).  Returns a cudaError_t.
extern "C" int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* length, void* o, void* m_part,
                                  void* l_part, void* acc_part, int B, int Hq,
                                  int Hkv, int T_len, int D, int split,
                                  float scale, int window, int dtype,
                                  void* stream) {
  const int G = Hkv > 0 ? Hq / Hkv : 0;
  if (Hkv <= 0 || Hq % Hkv || G > kMaxG || D % 16 || D > kMaxD ||
      split < 1 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  if (dtype == 0)
    return launch<float>(attn_decode_fp32_kernel, split_smem(D, G, dtype), q,
                         k, v, len, o, mp, lp, ap, B, Hq, Hkv, T_len, D,
                         split, scale, window, st);
  if (dtype == 1)
    return launch<bf16>(attn_decode_bf16_kernel, split_smem(D, G, dtype), q,
                        k, v, len, o, mp, lp, ap, B, Hq, Hkv, T_len, D, split,
                        scale, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
