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
// Design (flash-decoding, one launch).  The TPU kernel walks the cache as
// a sequential grid axis, one program per (b, kv head); on the card that
// would be 8 CTAs at qwen3-next-gdn's serving shape and 4 at yi-9b's
// batch-1 shape, for 132 SMs.  So T is split across CTAs: grid (splits,
// Hkv, B), one CTA per split of `split` slots of one (b, kv head), holding
// the G query heads of that kv head together so every K/V row is read once
// for the group (the GQA form of the paper's paired-head datapath).  The
// CTA walks its split in tiles of kTile rows through a ring of S stages in
// shared memory: S - 1 tiles of K and V are in flight while it computes
// on one.  The host picks S (2 or 3 for bf16, 2 for fp32) and the split
// so that about 64 KiB of K/V are in flight per SM; on the H100 the cache
// streamed no faster with more, and every further split adds a partial to
// the merge (``kernels/attn_decode.py``).  16-byte cp.async copies, each
// thread's rows and columns of a tile fixed once (no division per copy);
// rows padded by 16 bytes so that the ldmatrix reads of 8 rows fall in
// distinct banks; rows past the split are zero-filled, so no stale or
// unwritten word reaches a product.
// Splits that start at or past occ = min(length, T) return at once; the
// live splits of a (b, kv head) number ceil(occ / split), computed on the
// device.  A group with one live split writes o itself.  Otherwise each
// live split writes its unnormalized (m, l, acc) per head, fences, and
// adds one to the group's arrival counter; the CTA that arrives last
// merges the group's G rows by log-sum-exp over the live splits in split
// order 0..n-1 (a fixed order, whichever CTA is last, so o is bitwise
// reproducible), writes o and resets the counter to 0 for the next call.
// A group with no live split (occ = 0) gets o = 0 from its split 0.  The
// counters (B * Hkv int32, zero between calls) are owned by the caller,
// who must not run two calls at once on one counter buffer: the port
// launches every kernel on the current stream, so its calls serialise.
// Masked probabilities are set to 0, never computed as exp(-1e30 -
// -1e30): a split whose occupied slots all lie outside the window ends
// with m = -1e30, l = 0, acc = 0, and its merge weight exp(-1e30 - M) is 0.
//
// bf16 (the served dtype): tensor cores, mma.sync m16n8k16 with fp32
// accumulators, one instantiation per head dim (a multiple of 16 up to
// 128), so that only D's accumulators take registers.  The G <= 16 query
// heads are the 16 rows of the A operand (rows >= G are zero), each warp
// takes 16 keys of the tile: S = Q K^T in two 16x8 tiles (K's B fragments
// by ldmatrix), a per-warp online softmax on the fragments (rows gid and
// gid + 8 of each quad) in log2 units (exp2), P rounded to bf16 (as
// attn_decode_xla and SDPA do) straight from the S fragments into the A
// operand of O += P V, V's B fragments from ldmatrix.trans.  At the end of
// the split the four warps' (m, l, O) are merged in shared memory.
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
constexpr float kLog2e = 1.4426950408889634f;
// fp32 kernel
constexpr int kFp32Stages = 2;
constexpr int kGroups = kThreads / kTile;      // head groups in the scores
constexpr int kGPerThread = kMaxG / kGroups;
constexpr int kMaxPairs = kMaxG * (kMaxD / 4) / kThreads;
constexpr int kPS = kTile + 1;                 // score row stride (floats)

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  // round to nearest even, as jnp.astype
  uint2 u;
  u.x = pack_bf16(x.x, x.y);
  u.y = pack_bf16(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// A thread's share of copying a tile: each warp copies rpp = 32 / nc rows
// per pass (nc 16-byte chunks per row), lane -> (row lane / nc, chunk
// lane % nc); the CTA covers kWarps * rpp rows per pass.  Computed once,
// so a tile's copies cost the thread only pointer increments.
template <typename T>
struct TileCopy {
  int row, col, step;
  bool active;
  __device__ __forceinline__ explicit TileCopy(int D) {
    constexpr int E = 16 / sizeof(T);
    const int nc = D / E, rpp = 32 / nc, lane = threadIdx.x & 31;
    row = (threadIdx.x >> 5) * rpp + lane / nc;
    col = (lane % nc) * E;
    step = kWarps * rpp;
    active = lane / nc < rpp;
  }
};

// cp.async rows [t0, t0 + kTile) of one (b, kv head)'s K and V (its rows
// start at kv0) into a ring stage (K at dst, V at dst + tile), 16 bytes
// per copy; rows at or past t_end are zero-filled and not read
// (uncommitted: the caller commits one group per stage)
template <typename T>
__device__ __forceinline__ void issue_tile(T* dst, const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           size_t kv0, int t0, int t_end,
                                           int D, int LD, int tile,
                                           const TileCopy<T>& cp) {
  if (!cp.active) return;
  const size_t base = (kv0 + t0) * D + cp.col;
  const T* ks = k + base;
  const T* vs = v + base;
  T* d = dst + cp.row * LD + cp.col;
  const int rows = t_end - t0;
  for (int r = cp.row; r < kTile; r += cp.step, d += cp.step * LD) {
    const bool ok = r < rows;
    const size_t off = ok ? static_cast<size_t>(r) * D : 0;
    cp_async16_zfill(d, ks + off, ok);
    cp_async16_zfill(d + tile, vs + off, ok);
  }
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

// The split's arrival: after its partial (m, l, acc of the G rows from
// qrow0; m in log2 units) is in device memory, count it on the group's
// counter (one fence, by the thread that counts, after a CTA barrier: the
// pattern of a grid barrier).  The CTA that arrives last merges the
// `live` partials of every row by log-sum-exp in split order 0..live-1,
// writes o (rows qrow0 .. qrow0 + G - 1) and resets the counter: the
// rows' m and l into shared memory (`scratch`, 2 G live + G floats) in
// one round of loads, the weights exp2(m_s - M) and denominators there,
// then the weighted sum of acc: each thread owns float4 columns tid, tid +
// kThreads, ... of the G rows and keeps the loads of all of them, for 8
// splits, in flight together.  Every thread of the CTA calls it.
template <typename T>
__device__ void arrive_and_merge(const float* m_part, const float* l_part,
                                 const float* acc_part, int* counter,
                                 T* __restrict__ o, size_t qrow0, int G,
                                 int D, int n_split, int live,
                                 float* scratch) {
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();                    // every thread's partial is stored
  if (tid == 0) {
    __threadfence();                  // ... and visible before the count
    last = atomicAdd(counter, 1) == live - 1;
    if (last) __threadfence();        // the others' partials after it
  }
  __syncthreads();
  if (!last) return;
  float* sW = scratch;                // [g][s]: m_s, then exp2(m_s - M)
  float* sL = sW + G * live;          // [g][s]: l_s
  float* sDen = sL + G * live;        // [g]: max(sum_s w_s l_s, 1e-30)
  for (int i = tid; i < G * live; i += kThreads) {
    const size_t at = (qrow0 + i / live) * n_split + i % live;
    sW[i] = __ldcg(m_part + at);
    sL[i] = __ldcg(l_part + at);
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    float* w = sW + g * live;
    float mx = kNegInf;
    for (int s = lane; s < live; s += 32) mx = fmaxf(mx, w[s]);
    mx = warp_max(mx);
    float dn = 0.f;
    for (int s = lane; s < live; s += 32) {
      w[s] = exp2f(w[s] - mx);
      dn += w[s] * sL[g * live + s];
    }
    dn = warp_sum(dn);
    if (lane == 0) sDen[g] = fmaxf(dn, 1e-30f);
  }
  __syncthreads();
  constexpr int kMaxItems = kMaxG * kMaxD / 4 / kThreads;
  const int nv = D / 4, items = G * nv;
  const int mine = tid < items ? (items - 1 - tid) / kThreads + 1 : 0;
  const float* ar[kMaxItems];
  const float* wr[kMaxItems];
  float4 a[kMaxItems];
#pragma unroll
  for (int j = 0; j < kMaxItems; ++j) {
    const int i = min(tid + j * kThreads, items - 1);
    const int g = i / nv;
    ar[j] = acc_part + (qrow0 + g) * n_split * D + (i - g * nv) * 4;
    wr[j] = sW + g * live;
    a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 8
  for (int s = 0; s < live; ++s) {
#pragma unroll
    for (int j = 0; j < kMaxItems; ++j) {
      if (j < mine) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            ar[j] + static_cast<size_t>(s) * D));
        const float w = wr[j][s];
        a[j].x += w * x.x;
        a[j].y += w * x.y;
        a[j].z += w * x.z;
        a[j].w += w * x.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxItems; ++j) {
    if (j < mine) {
      const int i = tid + j * kThreads, g = i / nv;
      const float r = 1.f / sDen[g];
      store4(o + (qrow0 + g) * D + (i - g * nv) * 4,
             make_float4(a[j].x * r, a[j].y * r, a[j].z * r, a[j].w * r));
    }
  }
  if (tid == 0) *counter = 0;         // ready for the next call
}

// the G rows of a group with no occupied slot: o = 0
template <typename T>
__device__ __forceinline__ void write_zero_rows(T* __restrict__ o,
                                                size_t qrow0, int G, int D) {
  for (int i = threadIdx.x * 4; i < G * D; i += kThreads * 4)
    store4(o + qrow0 * D + i, make_float4(0.f, 0.f, 0.f, 0.f));
}

// ------------------------------------------------------------------ bf16

template <int D, int S>
__global__ void __launch_bounds__(kThreads)
    attn_decode_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int* __restrict__ length,
                            bf16* __restrict__ o, float* __restrict__ m_part,
                            float* __restrict__ l_part,
                            float* __restrict__ acc_part,
                            int* __restrict__ counters, int Hkv, int G,
                            int T_len, int split, float scale, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = D + 8;                    // row + 16 bytes
  constexpr int tile = kTile * LD;
  constexpr int nks = D / 16, nd = D / 8;
  bf16* sKV = reinterpret_cast<bf16*>(smem_raw);   // [stage][K, V][row][LD]
  bf16* sQ = sKV + S * 2 * tile;                   // 16 x LD

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = length[b];
  const int occ = max(0, min(len, T_len));
  const int t_begin = s * split;
  const size_t qrow0 = static_cast<size_t>(b) * Hkv * G + h * G;
  if (t_begin >= occ) {        // uniform over the block: nothing to read
    if (s == 0) write_zero_rows(o, qrow0, G, D);   // occ = 0: no live split
    return;
  }
  const int t_end = min(t_begin + split, occ);
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  const int live = (occ + split - 1) / split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t kv0 = (static_cast<size_t>(b) * Hkv + h) * T_len;
  const TileCopy<bf16> cp(D);

  // the first S - 1 tiles in flight (one commit group each, empty past the
  // split), then Q; its rows >= G stay zero
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < n_tiles)
      issue_tile(sKV + p * 2 * tile, k, v, kv0, t_begin + p * kTile, t_end,
                 D, LD, tile, cp);
    cp_async_commit();
  }
  for (int i = tid; i < 16 * D; i += kThreads) {
    const int g = i / D, e = i - g * D;
    sQ[g * LD + e] = g < G ? q[qrow0 * D + i] : __float2bfloat16(0.f);
  }
  __syncthreads();

  unsigned qa[nks][4];                         // Q's A fragments
#pragma unroll
  for (int ks = 0; ks < nks; ++ks) {
    const bf16* r = sQ + gid * LD + ks * 16 + tig * 2;
    qa[ks][0] = ld32(r);
    qa[ks][1] = ld32(r + 8 * LD);
    qa[ks][2] = ld32(r + 8);
    qa[ks][3] = ld32(r + 8 * LD + 8);
  }
  float acc[nd][4];                            // O, rows gid and gid + 8
#pragma unroll
  for (int n = 0; n < nd; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // scores, m and l in log2 units: p = exp2(s scale log2 e - m)
  const float sl2 = scale * kLog2e;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int r0 = warp * 16;                    // this warp's 16 keys
  // ldmatrix offsets in a tile: K's B fragments (keys r0 .. r0 + 15) and
  // V's, transposed
  const int k_off = (r0 + (lane & 7) + ((lane >> 4) & 1) * 8) * LD +
                    ((lane >> 3) & 1) * 8;
  const int v_off = (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<S - 2>();                    // tile `it` has landed
    __syncthreads();           // ... for every thread; stage it - 1 is free
    {
      const int nx = it + S - 1;               // into the stage it - 1 used
      if (nx < n_tiles)
        issue_tile(sKV + (nx % S) * 2 * tile, k, v, kv0,
                   t_begin + nx * kTile, t_end, D, LD, tile, cp);
      cp_async_commit();
    }
    const int t0 = t_begin + it * kTile;
    const int rows = min(kTile, t_end - t0);
    const bf16* sK = sKV + (it % S) * 2 * tile;
    const bf16* sV = sK + tile;
    if (r0 < rows) {
      // sc[j][e]: head gid (e < 2) or gid + 8, key r0 + 8j + 2 tig + e % 2
      float sc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < nks; ++ks) {
        unsigned kb[4];
        ldmatrix_x4(kb, sK + k_off + ks * 16);
        mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
        mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
      }
      const bool full = r0 + 16 <= rows && window <= 0;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = r0 + 8 * j + 2 * tig + (e & 1);
          const bool ok = full || (key < rows &&
                                   visible(len, t0 + key, T_len, window));
          sc[j][e] = ok ? sl2 * sc[j][e] : kNegInf;
          if (e < 2)
            mx0 = fmaxf(mx0, sc[j][e]);
          else
            mx1 = fmaxf(mx1, sc[j][e]);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float c0 = exp2_approx(m0 - mn0), c1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = sc[j][e] > 0.5f * kNegInf
                        ? exp2_approx(sc[j][e] - (e < 2 ? mn0 : mn1))
                        : 0.f;
      l0 = l0 * c0 + p[0][0] + p[0][1] + p[1][0] + p[1][1];
      l1 = l1 * c1 + p[0][2] + p[0][3] + p[1][2] + p[1][3];
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int n = 0; n < nd; n += 2) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
        acc[n + 1][0] *= c0;
        acc[n + 1][1] *= c0;
        acc[n + 1][2] *= c1;
        acc[n + 1][3] *= c1;
        unsigned vb[4];
        ldmatrix_x4_trans(vb, sV + v_off + n * 8);
        mma_bf16(acc[n], pa, vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();          // only empty groups can still be pending
  __syncthreads();             // every warp is done with the ring

  // merge the four warps' (m, l, O) in shared memory (the ring is free)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* wO = reinterpret_cast<float*>(smem_raw);  // [warp][16][D]
  float* wM = wO + kWarps * 16 * D;                // [warp][16]
  float* wL = wM + kWarps * 16;
  float* wW = wL + kWarps * 16;                    // [warp][16] weights
  float* sML = wW + kWarps * 16;                   // [M, L][16]
  float* o0 = wO + (warp * 16 + gid) * D + 2 * tig;
#pragma unroll
  for (int n = 0; n < nd; ++n) {
    o0[8 * n] = acc[n][0];
    o0[8 * n + 1] = acc[n][1];
    o0[8 * D + 8 * n] = acc[n][2];
    o0[8 * D + 8 * n + 1] = acc[n][3];
  }
  if (tig == 0) {
    wM[warp * 16 + gid] = m0;
    wM[warp * 16 + gid + 8] = m1;
    wL[warp * 16 + gid] = l0;
    wL[warp * 16 + gid + 8] = l1;
  }
  __syncthreads();
  if (tid < G) {
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wM[w * 16 + tid]);
    float L = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float x = exp2_approx(wM[w * 16 + tid] - M);
      wW[w * 16 + tid] = x;
      L += x * wL[w * 16 + tid];
    }
    sML[tid] = M;
    sML[16 + tid] = L;
  }
  __syncthreads();
  const int n_split = gridDim.x;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, e = i - g * D;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w)
      a += wW[w * 16 + g] * wO[(w * 16 + g) * D + e];
    if (live == 1)
      o[(qrow0 + g) * D + e] =
          __float2bfloat16(a / fmaxf(sML[16 + g], 1e-30f));
    else
      acc_part[((qrow0 + g) * n_split + s) * D + e] = a;
  }
  if (live == 1) return;
  if (tid < G) {
    m_part[(qrow0 + tid) * n_split + s] = sML[tid];
    l_part[(qrow0 + tid) * n_split + s] = sML[16 + tid];
  }
  arrive_and_merge(m_part, l_part, acc_part, counters + b * Hkv + h, o,
                   qrow0, G, D, n_split, live,
                   reinterpret_cast<float*>(smem_raw));
}

// ------------------------------------------------------------------ fp32

__global__ void __launch_bounds__(kThreads)
    attn_decode_fp32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ length,
                            float* __restrict__ o, float* __restrict__ m_part,
                            float* __restrict__ l_part,
                            float* __restrict__ acc_part,
                            int* __restrict__ counters, int Hkv, int G,
                            int T_len, int D, int split, float scale,
                            int window) {
  constexpr int S = kFp32Stages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = D + 4;                        // row + 16 bytes
  const int tile = kTile * LD;
  float* sKV = reinterpret_cast<float*>(smem_raw);  // [stage][K, V][row][LD]
  float* sQ = sKV + S * 2 * tile;                   // G x D
  float* sP = sQ + G * D;                           // G x kPS
  float* sM = sP + G * kPS;                         // kMaxG each
  float* sL = sM + kMaxG;
  float* sC = sL + kMaxG;

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = length[b];
  const int occ = max(0, min(len, T_len));
  const int t_begin = s * split;
  const size_t qrow0 = static_cast<size_t>(b) * Hkv * G + h * G;
  if (t_begin >= occ) {        // uniform over the block: nothing to read
    if (s == 0) write_zero_rows(o, qrow0, G, D);   // occ = 0: no live split
    return;
  }
  const int t_end = min(t_begin + split, occ);
  const int n_tiles = (t_end - t_begin + kTile - 1) / kTile;
  const int live = (occ + split - 1) / split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t kv0 = (static_cast<size_t>(b) * Hkv + h) * T_len;
  const TileCopy<float> cp(D);
  // scores, m and l in log2 units (as the bf16 kernel's, for one merge)
  const float sl2 = scale * kLog2e;

#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < n_tiles)
      issue_tile(sKV + p * 2 * tile, k, v, kv0, t_begin + p * kTile, t_end,
                 D, LD, tile, cp);
    cp_async_commit();
  }
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
    cp_async_wait<S - 2>();
    __syncthreads();  // tile `it` (and sQ, sM, sL) visible to all
    {
      const int nx = it + S - 1;   // its stage was freed by the last barrier
      if (nx < n_tiles)
        issue_tile(sKV + (nx % S) * 2 * tile, k, v, kv0,
                   t_begin + nx * kTile, t_end, D, LD, tile, cp);
      cp_async_commit();
    }
    const int t0 = t_begin + it * kTile;
    const int rows = min(kTile, t_end - t0);
    const float* sK = sKV + (it % S) * 2 * tile;
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
        if (g < G) sP[g * kPS + srow] = ok ? sl2 * sc[i] : kNegInf;
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
      const float p0 = x0 > 0.5f * kNegInf ? exp2f(x0 - m_new) : 0.f;
      const float p1 = x1 > 0.5f * kNegInf ? exp2f(x1 - m_new) : 0.f;
      if (lane < rows) row[lane] = p0;
      if (lane + 32 < rows) row[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = exp2f(m_old - m_new);
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
    __syncthreads();  // sP is free again
  }
  cp_async_wait<0>();          // only empty groups can still be pending

  const int n_split = gridDim.x;
#pragma unroll
  for (int j = 0; j < kMaxPairs; ++j) {
    const int pi = tid + kThreads * j;
    if (pi < npairs) {
      const int g = pi / nc, c = (pi % nc) * 4;
      if (live == 1) {
        const float r = 1.f / fmaxf(sL[g], 1e-30f);
        const float4 a = acc[j];
        store4(o + (qrow0 + g) * D + c,
               make_float4(a.x * r, a.y * r, a.z * r, a.w * r));
      } else {
        store4(acc_part + ((qrow0 + g) * n_split + s) * D + c, acc[j]);
      }
    }
  }
  if (live == 1) return;
  if (tid < G) {
    m_part[(qrow0 + tid) * n_split + s] = sM[tid];
    l_part[(qrow0 + tid) * n_split + s] = sL[tid];
  }
  arrive_and_merge(m_part, l_part, acc_part, counters + b * Hkv + h, o,
                   qrow0, G, D, n_split, live,
                   reinterpret_cast<float*>(smem_raw));
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// shared memory of a CTA: the ring (and Q, scores, statistics), and at
// least what the end of a split reuses it for — the warps' merge (bf16)
// and the last CTA's merge, 2 G n_split + G floats
size_t smem_bytes(int D, int G, int n_split, int dtype, int stages) {
  size_t ring;
  if (dtype == 0) {
    ring = (kFp32Stages * 2 * kTile * (D + 4) + G * D + G * kPS +
            3 * kMaxG) * sizeof(float);
  } else {
    ring = (stages * 2 * kTile + 16) * static_cast<size_t>(D + 8) *
           sizeof(bf16);
    const size_t warps = (kWarps * 16 * (D + 3) + 32) * sizeof(float);
    ring = ring > warps ? ring : warps;
  }
  const size_t merge = (2 * static_cast<size_t>(n_split) + 1) * G *
                       sizeof(float);
  return ring > merge ? ring : merge;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).  window <= 0: none.
// m_part, l_part: (B * Hq * n_split) fp32 and acc_part (B * Hq * n_split *
// D) fp32 scratch, n_split = ceil(T / split); counters: B * Hkv int32,
// zero, and zero again when the kernel ends.  stages: the bf16 ring's
// depth, 2 or 3 (fp32 takes 2).  One launch.  Returns a cudaError_t.
extern "C" int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* length, void* o, void* m_part,
                                  void* l_part, void* acc_part,
                                  void* counters, int B, int Hq, int Hkv,
                                  int T_len, int D, int split, float scale,
                                  int window, int dtype, int stages,
                                  void* stream) {
  const int G = Hkv > 0 ? Hq / Hkv : 0;
  if (Hkv <= 0 || Hq % Hkv || G > kMaxG || D % 16 || D > kMaxD ||
      split < 1 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16 ||
      (dtype == 0 && stages != kFp32Stages) || stages < 2 || stages > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  int* cnt = static_cast<int*>(counters);
  const int n_split = (T_len + split - 1) / split;
  const size_t smem = smem_bytes(D, G, n_split, dtype, stages);
  const dim3 grid(n_split, Hkv, B);
  if (dtype == 0) {
    const int err = prepare(attn_decode_fp32_kernel, smem);
    if (err) return err;
    attn_decode_fp32_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), len, static_cast<float*>(o), mp, lp,
        ap, cnt, Hkv, G, T_len, D, split, scale, window);
    return static_cast<int>(cudaGetLastError());
  }
#define ATTN_DECODE_BF16(DD, SS)                                           \
  if (D == DD && stages == SS) {                                          \
    auto kernel = attn_decode_bf16_kernel<DD, SS>;                        \
    const int err = prepare(kernel, smem);                                \
    if (err) return err;                                                  \
    kernel<<<grid, kThreads, smem, st>>>(                                 \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),         \
        static_cast<const bf16*>(v), len, static_cast<bf16*>(o), mp, lp,  \
        ap, cnt, Hkv, G, T_len, split, scale, window);                    \
    return static_cast<int>(cudaGetLastError());                          \
  }
#define ATTN_DECODE_BF16_D(DD) ATTN_DECODE_BF16(DD, 2) ATTN_DECODE_BF16(DD, 3)
  if (dtype == 1) {
    ATTN_DECODE_BF16_D(16) ATTN_DECODE_BF16_D(32) ATTN_DECODE_BF16_D(48)
    ATTN_DECODE_BF16_D(64) ATTN_DECODE_BF16_D(80) ATTN_DECODE_BF16_D(96)
    ATTN_DECODE_BF16_D(112) ATTN_DECODE_BF16_D(128)
  }
#undef ATTN_DECODE_BF16_D
#undef ATTN_DECODE_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}
