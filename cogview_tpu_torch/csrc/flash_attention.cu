// Causal + bidirectional-prefix flash attention, forward and backward, with
// optional attention-probability dropout, for NVIDIA Hopper (sm_90a).
//
// Replaces: cogview_tpu/ops/flash_attention.py::_fwd_kernel (:163), launched
// by _flash_fwd_impl's pallas_call (:371); the backward kernels below
// replace _bwd_dq_kernel (:212) and _bwd_dkv_kernel (:249).
//
// Semantics (the JAX kernel's): s = (q . k) * scale with float32 sums; a key
// is visible iff (kpos <= qpos || kpos < sep) and both positions are < S,
// else its logit is -10000.  Online softmax in float32; l sums the mass
// before dropout; a kept probability is p / keep (keep = 1 - rate), cast to
// v's dtype, then multiplied with V.  o = acc / l in q's dtype and
// lse = m + log(l) in float32.  The dropout keep bit is
// hash_u32(seed, qpos, kpos, b * N + n) >= threshold in wrapping uint32
// arithmetic, bit for bit the JAX package's ops/hash_prng.py.
//
// Layout: q, k, v [B, S, N, D] with D = 64, read through batch and sequence
// strides (the slices of a fused QKV projection are not contiguous; the
// wrapper passes their strides, so nothing is copied); o [B, S, N, D]
// contiguous; lse [B, N, S].
//
// Design: the TPU runs its grid (B, N, Sq/bq) in order with whole-S K/V
// blocks in VMEM.  Here one block of 128 threads owns one (b, n, 64-row
// query tile), and the blocks run in parallel.  The query tile stays in
// shared memory; 64-key K and V tiles are staged through shared memory one
// after the other (64 KB in all).  Thread (ty, tx) owns rows 4ty..4ty+3 and
// columns {4tx..4tx+3, 32+4tx..32+4tx+3} of each 64 x 64 score tile, and the
// same rows and head dims of the output, so the online-softmax state
// (m, l and a 4 x 8 accumulator) stays in registers.  Row maxima and sums
// are reduced over the 8 threads of a row with warp shuffles.  Key tiles
// wholly above the diagonal and past sep are skipped (the TPU's `last`);
// the ragged edge (positions >= S) is zero-filled and masked.  Query tiles
// are issued longest first to even out the causal triangle.
//
// What bounds it on an H100: arithmetic.  Both products run as float32 FMA
// on the CUDA cores (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s
// bf16).  At post-selection's S = 1058, B = 4, N = 40 the causal half is
// about 23 GFLOP per layer, while q, k, v and o are 87 MB in bf16: about
// 260 operations per byte.  Each thread does 32 FMA for every 3 16-byte
// shared-memory loads.  Left for later: mma.sync / wgmma tensor-core dots
// for bf16 (float32 inputs need float32 products), cp.async or TMA double
// buffering of the K/V tiles, and a separate unmasked path for tiles below
// the diagonal.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr float MASK_VALUE = -10000.0f;
static_assert(BQ == BK, "load_transposed writes [D][BQ] tiles for both Q and K");
constexpr size_t SMEM_BYTES = sizeof(float) * (D * BQ + D * BK + BK * D + BK * BQ);

struct Params {
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;  // batch / sequence strides, elements
  int S, N, sep;
  float scale, keep;
  uint32_t seed, threshold;
};

// ops/hash_prng.py: murmur3-style finalizer over a mix of three coordinates
__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t c0, uint32_t c1,
                                             uint32_t c2) {
  uint32_t x = c0 * 0x9E3779B1u + c1 * 0x85EBCA77u + c2 * 0xC2B2AE3Du;
  x ^= seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// four consecutive elements <-> float4, and the rounding of a probability
// to v's dtype
template <typename T> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <> struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    *reinterpret_cast<uint32_t*>(&lo) = raw.x;
    *reinterpret_cast<uint32_t*>(&hi) = raw.y;
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// column (or head dim) j of thread tx: 4tx..4tx+3, then 32+4tx..32+4tx+3
__device__ __forceinline__ int col_of(int tx, int j) { return (j < 4 ? 0 : 28) + 4 * tx + j; }

// rows [0, BQ) of a [S, ...] operand starting at row r0, as a transposed
// [D][BQ] float tile (zero past S)
template <typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, long long row_stride,
                                                int r0, int S) {
  for (int i = threadIdx.x; i < BQ * D / 4; i += THREADS) {
    const int r = i % BQ, d4 = i / BQ;  // consecutive threads, consecutive rows
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = Io<T>::load4(src + (long long)(r0 + r) * row_stride + 4 * d4);
    dst[(4 * d4 + 0) * BQ + r] = x.x;
    dst[(4 * d4 + 1) * BQ + r] = x.y;
    dst[(4 * d4 + 2) * BQ + r] = x.z;
    dst[(4 * d4 + 3) * BQ + r] = x.w;
  }
}

template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [D][BQ]  query tile, transposed
  float* Ks = Qs + D * BQ;     // [D][BK]  key tile, transposed
  float* Vs = Ks + D * BK;     // [BK][D]  value tile
  float* Ps = Vs + BK * D;     // [BK][BQ] probabilities, transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int n = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int S = p.S;
  const uint32_t bn = (uint32_t)(b * p.N + n);

  const T* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const T* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const T* vb = v + (long long)b * p.v_sb + (long long)n * D;

  load_transposed<T>(Qs, qb, p.q_ss, q0, S);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  // keys any row of this tile can see: [0, max(last row + 1, sep)) within S
  const int qlast = min(q0 + BQ, S) - 1;
  const int kend = min(S, max(qlast + 1, p.sep));
  const int nkt = (kend + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    load_transposed<T>(Ks, kb, p.k_ss, k0, S);
    for (int i = tid; i < BK * D / 4; i += THREADS) {
      const int r = i / (D / 4), d4 = i % (D / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < S) x = Io<T>::load4(vb + (long long)(k0 + r) * p.v_ss + 4 * d4);
      *reinterpret_cast<float4*>(&Vs[r * D + 4 * d4]) = x;
    }
    __syncthreads();

    // s = q . k over D, float32 sums
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[d * BQ + 4 * ty]);
      const float4 ka = *reinterpret_cast<const float4*>(&Ks[d * BK + 4 * tx]);
      const float4 kc = *reinterpret_cast<const float4*>(&Ks[d * BK + 32 + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, mask, online softmax (a row's 8 threads are adjacent lanes)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + col_of(tx, j);
        const bool vis = (kpos <= qpos || kpos < p.sep) && kpos < S && qpos < S;
        s[i][j] = vis ? s[i][j] * p.scale : MASK_VALUE;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] *= alpha;
        float pj = s[i][j];
        if (DROPOUT) {
          const uint32_t h = hash_u32(p.seed, (uint32_t)qpos, (uint32_t)(k0 + col_of(tx, j)), bn);
          pj = h >= p.threshold ? pj / p.keep : 0.0f;
        }
        s[i][j] = Io<T>::round(pj);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(&Ps[col_of(tx, j) * BQ + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p . v
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[c * BQ + 4 * ty]);
      const float4 va = *reinterpret_cast<const float4*>(&Vs[c * D + 4 * tx]);
      const float4 vc = *reinterpret_cast<const float4*>(&Vs[c * D + 32 + 4 * tx]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float vv[8] = {va.x, va.y, va.z, va.w, vc.x, vc.y, vc.z, vc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= S) continue;
    T* orow = o + (((long long)b * S + r) * p.N + n) * D;
    Io<T>::store4(orow + 4 * tx, make_float4(acc[i][0] / l[i], acc[i][1] / l[i],
                                             acc[i][2] / l[i], acc[i][3] / l[i]));
    Io<T>::store4(orow + 32 + 4 * tx, make_float4(acc[i][4] / l[i], acc[i][5] / l[i],
                                                  acc[i][6] / l[i], acc[i][7] / l[i]));
    if (tx == 0) lse[((long long)b * p.N + n) * S + r] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------------------
// Backward.
//
// Semantics (the JAX kernels'): with delta = rowsum(dO * O) computed by the
// caller in float32, for every visible (query, key) pair
//   p  = exp(s * scale - lse)            (masked logits -10000, as forward)
//   pd = keep ? p / keep_rate : 0        (the forward's dropout bits)
//   dp = dO . v                          (float32 sums)
//   ds = (pd * dp - p * delta) * scale
// then dq = sum_k ds.k, dk = sum_q ds.q, dv = sum_q pd.dO, with ds rounded to
// q's dtype and pd to dO's dtype before their products, float32 sums, and
// outputs in the input dtype.  Query rows at or past S contribute nothing
// (zero dO, zero delta, masked); keys at or past S are masked.
//
// Design: the TPU runs the two passes as two pallas_calls over grids
// (B, N, Sq/bq) and (B, N, Sk/bk), so every output element has one owner
// and no sum crosses grid cells.  The CUDA kernels keep that split: no
// atomics, so two launches on the same inputs give the same bits.
//  - dq: one 128-thread block per (b, n, 64-row query tile), the layout of
//    the forward (thread (ty, tx) owns rows 4ty..4ty+3 and columns
//    col_of(tx, j)).  Q and dO stay in shared memory, transposed; each
//    64-key tile of K (transposed and by rows) and V (transposed) is staged
//    in turn, s and dp are formed together, ds goes through shared memory,
//    and the dq accumulator stays in registers.  Key tiles stop at the
//    forward's bound (the diagonal, or sep).  96 KB of shared memory.
//  - dk/dv: one 128-thread block per (b, n, 64-key tile).  K and V stay in
//    shared memory, transposed; the block walks the query tiles from the
//    first that can see one of its keys (0 if the tile holds prefix keys
//    < sep, else the diagonal's tile) to the end, forming the transposed
//    score tile (rows are keys), and keeps both accumulators (2 x 4 x 8 per
//    thread) in registers.  lse and delta of the query tile are staged in
//    shared memory.  130 KB of shared memory: one block per SM.
//
// What bounds them on an H100: arithmetic, as the forward.  The dq pass
// does three 64-deep products per tile pair and the dk/dv pass four, all as
// float32 FMA on the CUDA cores (67 TFLOP/s peak) rather than the tensor
// cores.  Left for later: mma.sync / wgmma dots for bf16, cp.async or TMA
// staging of the next tile while the current one is multiplied, more warps
// per block (one 128-thread block per SM leaves the dk/dv pass latency
// bound), and an unmasked path below the diagonal.
// ------------------------------------------------------------------------

struct BwdParams {
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;  // o: dO
  int S, N, sep;
  float scale, keep;
  uint32_t seed, threshold;
};

constexpr size_t DQ_SMEM_BYTES = sizeof(float) * (6 * D * BQ);
constexpr size_t DKV_SMEM_BYTES = sizeof(float) * (8 * D * BQ + 2 * BQ);
static_assert(D == BQ, "the backward tiles are square");

// rows [0, BK) of a [S, ...] operand starting at row r0, as a [BK][D] float
// tile (zero past S)
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long row_stride, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < BK * D / 4; i += THREADS) {
    const int r = i / (D / 4), d4 = i % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = Io<T>::load4(src + (long long)(r0 + r) * row_stride + 4 * d4);
    *reinterpret_cast<float4*>(&dst[r * D + 4 * d4]) = x;
  }
}

// acc[i][j] += sum_c A[c][4ty + i] * B[c][col_of(tx, j)] over c in [0, 64),
// for two 64 x 64 float tiles held with the summed index first
__device__ __forceinline__ void tile_product(float (&acc)[4][8], const float* A, const float* Bm,
                                             int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(&A[c * 64 + 4 * ty]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bm[c * 64 + 4 * tx]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bm[c * 64 + 32 + 4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the thread's 4 x 8 patch of a 64 x 64 tile, stored transposed: dst[col][row]
__device__ __forceinline__ void store_patch_transposed(float* dst, const float (&x)[4][8], int ty,
                                                       int tx) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(&dst[col_of(tx, j) * 64 + 4 * ty]) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

template <typename T>
__device__ __forceinline__ void store_patch(T* base, long long row_stride, int r0, int S,
                                            const float (&x)[4][8], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= S) continue;
    T* row = base + (long long)r * row_stride;
    Io<T>::store4(row + 4 * tx, make_float4(x[i][0], x[i][1], x[i][2], x[i][3]));
    Io<T>::store4(row + 32 + 4 * tx, make_float4(x[i][4], x[i][5], x[i][6], x[i][7]));
  }
}

template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [D][BQ]  query tile, transposed
  float* Os = Qs + D * BQ;     // [D][BQ]  dO tile, transposed
  float* Ks = Os + D * BQ;     // [D][BK]  key tile, transposed
  float* Vs = Ks + D * BK;     // [D][BK]  value tile, transposed
  float* Kr = Vs + D * BK;     // [BK][D]  key tile, by rows
  float* Ds = Kr + BK * D;     // [BK][BQ] ds, transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int n = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int S = p.S;
  const uint32_t bn = (uint32_t)(b * p.N + n);

  const T* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const T* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const T* vb = v + (long long)b * p.v_sb + (long long)n * D;
  const T* ob = dout + (long long)b * p.o_sb + (long long)n * D;
  const float* lse_b = lse + ((long long)b * p.N + n) * S;
  const float* delta_b = delta + ((long long)b * p.N + n) * S;

  load_transposed<T>(Qs, qb, p.q_ss, q0, S);
  load_transposed<T>(Os, ob, p.o_ss, q0, S);

  float lse_r[4], delta_r[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    lse_r[i] = r < S ? lse_b[r] : 0.0f;
    delta_r[i] = r < S ? delta_b[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  // the forward's bound: keys any row of this tile can see
  const int qlast = min(q0 + BQ, S) - 1;
  const int kend = min(S, max(qlast + 1, p.sep));
  const int nkt = (kend + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Ks, Vs, Kr and Ds are done
    load_transposed<T>(Ks, kb, p.k_ss, k0, S);
    load_transposed<T>(Vs, vb, p.v_ss, k0, S);
    load_rows<T>(Kr, kb, p.k_ss, k0, S);
    __syncthreads();

    // s = q . k and dp = dO . v over D, float32 sums
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
    tile_product(s, Qs, Ks, ty, tx);
    tile_product(dp, Os, Vs, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + col_of(tx, j);
        const bool vis = (kpos <= qpos || kpos < p.sep) && kpos < S && qpos < S;
        const float pr = expf((vis ? s[i][j] * p.scale : MASK_VALUE) - lse_r[i]);
        float pd = pr;
        if (DROPOUT) {
          const uint32_t h = hash_u32(p.seed, (uint32_t)qpos, (uint32_t)kpos, bn);
          pd = h >= p.threshold ? pr / p.keep : 0.0f;
        }
        s[i][j] = Io<T>::round((pd * dp[i][j] - pr * delta_r[i]) * p.scale);
      }
    }
    store_patch_transposed(Ds, s, ty, tx);
    __syncthreads();

    tile_product(acc, Ds, Kr, ty, tx);  // dq += ds . k
  }

  store_patch<T>(dq + (long long)b * S * p.N * D + (long long)n * D, (long long)p.N * D, q0, S,
                 acc, ty, tx);
}

template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;            // [D][BK]  key tile, transposed
  float* Vt = Kt + D * BK;     // [D][BK]  value tile, transposed
  float* Qt = Vt + D * BK;     // [D][BQ]  query tile, transposed
  float* Ot = Qt + D * BQ;     // [D][BQ]  dO tile, transposed
  float* Qr = Ot + D * BQ;     // [BQ][D]  query tile, by rows
  float* Or = Qr + BQ * D;     // [BQ][D]  dO tile, by rows
  float* Ps = Or + BQ * D;     // [BQ][BK] dropped probabilities (rows: queries)
  float* Ds = Ps + BQ * BK;    // [BQ][BK] ds (rows: queries)
  float* Ls = Ds + BQ * BK;    // [BQ]     lse of the query tile
  float* Es = Ls + BQ;         // [BQ]     delta of the query tile

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;  // rows 4ty.. are keys, columns queries
  const int kt = blockIdx.x;              // low key tiles see the most queries
  const int n = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int S = p.S;
  const uint32_t bn = (uint32_t)(b * p.N + n);

  const T* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const T* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const T* vb = v + (long long)b * p.v_sb + (long long)n * D;
  const T* ob = dout + (long long)b * p.o_sb + (long long)n * D;
  const float* lse_b = lse + ((long long)b * p.N + n) * S;
  const float* delta_b = delta + ((long long)b * p.N + n) * S;

  load_transposed<T>(Kt, kb, p.k_ss, k0, S);
  load_transposed<T>(Vt, vb, p.v_ss, k0, S);

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  // every query tile sees a prefix key (< sep); otherwise the first query
  // that sees key k0 is k0 itself
  const int first = k0 < p.sep ? 0 : k0 / BQ;
  const int nqt = (S + BQ - 1) / BQ;

  for (int qt = first; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's reads are done
    load_transposed<T>(Qt, qb, p.q_ss, q0, S);
    load_transposed<T>(Ot, ob, p.o_ss, q0, S);
    load_rows<T>(Qr, qb, p.q_ss, q0, S);
    load_rows<T>(Or, ob, p.o_ss, q0, S);
    for (int i = tid; i < BQ; i += THREADS) {
      const int r = q0 + i;
      Ls[i] = r < S ? lse_b[r] : 0.0f;
      Es[i] = r < S ? delta_b[r] : 0.0f;
    }
    __syncthreads();

    // transposed tiles: s[i][j] = k_(4ty+i) . q_col, dp[i][j] = v_(4ty+i) . dO_col
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
    tile_product(s, Kt, Qt, ty, tx);
    tile_product(dp, Vt, Ot, ty, tx);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col_of(tx, j);
      const int qpos = q0 + c;
      const float lse_c = Ls[c], delta_c = Es[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + 4 * ty + i;
        const bool vis = (kpos <= qpos || kpos < p.sep) && kpos < S && qpos < S;
        const float pr = expf((vis ? s[i][j] * p.scale : MASK_VALUE) - lse_c);
        float pd = pr;
        if (DROPOUT) {
          const uint32_t h = hash_u32(p.seed, (uint32_t)qpos, (uint32_t)kpos, bn);
          pd = h >= p.threshold ? pr / p.keep : 0.0f;
        }
        s[i][j] = Io<T>::round((pd * dp[i][j] - pr * delta_c) * p.scale);
        dp[i][j] = Io<T>::round(pd);
      }
    }
    store_patch_transposed(Ds, s, ty, tx);
    store_patch_transposed(Ps, dp, ty, tx);
    __syncthreads();

    tile_product(dv_acc, Ps, Or, ty, tx);  // dv += pd^T . dO
    tile_product(dk_acc, Ds, Qr, ty, tx);  // dk += ds^T . q
  }

  const long long out_b = (long long)b * S * p.N * D + (long long)n * D;
  store_patch<T>(dk + out_b, (long long)p.N * D, k0, S, dk_acc, ty, tx);
  store_patch<T>(dv + out_b, (long long)p.N * D, k0, S, dv_acc, ty, tx);
}

template <typename T, bool DROPOUT>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       const BwdParams& p, cudaStream_t stream) {
  const int tiles = (p.S + BQ - 1) / BQ;
  const dim3 grid(tiles, p.N, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  cudaError_t err;
  if (dq != nullptr) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DROPOUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, DROPOUT><<<grid, THREADS, DQ_SMEM_BYTES, stream>>>(
        qt, kt, vt, ot, lse, delta, static_cast<T*>(dq), p);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DROPOUT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKV_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<T, DROPOUT><<<grid, THREADS, DKV_SMEM_BYTES, stream>>>(
        qt, kt, vt, ot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
  }
  return cudaGetLastError();
}

template <typename T, bool DROPOUT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DROPOUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.N, B);
  flash_fwd_kernel<T, DROPOUT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int is_bf16, int B, int S, int N, int head_dim,
                                   long long q_sb, long long q_ss, long long k_sb,
                                   long long k_ss, long long v_sb, long long v_ss, int sep,
                                   float scale, unsigned int seed, unsigned int threshold,
                                   float keep, int dropout, void* stream) {
  if (head_dim != D || B <= 0 || S <= 0 || N <= 0 || B > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, S, N, sep, scale, keep, seed, threshold};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = dropout ? launch<__nv_bfloat16, true>(q, k, v, o, lse, B, p, s)
                  : launch<__nv_bfloat16, false>(q, k, v, o, lse, B, p, s);
  else
    err = dropout ? launch<float, true>(q, k, v, o, lse, B, p, s)
                  : launch<float, false>(q, k, v, o, lse, B, p, s);
  return (int)err;
}

// dq pass (dq != null) or dk/dv pass (dk, dv != null); outputs contiguous
// [B, S, N, D] in the input dtype
static int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, void* dq, void* dk,
                               void* dv, int is_bf16, int B, int S, int N, int head_dim,
                               long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                               long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                               int sep, float scale, unsigned int seed, unsigned int threshold,
                               float keep, int dropout, void* stream) {
  if (head_dim != D || B <= 0 || S <= 0 || N <= 0 || B > 65535 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const BwdParams p{q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
                    S,    N,    sep,  scale, keep, seed, threshold};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16)
    err = dropout ? launch_bwd<__nv_bfloat16, true>(q, k, v, dout, lse, delta, dq, dk, dv, B, p, s)
                  : launch_bwd<__nv_bfloat16, false>(q, k, v, dout, lse, delta, dq, dk, dv, B, p, s);
  else
    err = dropout ? launch_bwd<float, true>(q, k, v, dout, lse, delta, dq, dk, dv, B, p, s)
                  : launch_bwd<float, false>(q, k, v, dout, lse, delta, dq, dk, dv, B, p, s);
  return (int)err;
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, int is_bf16, int B, int S, int N, int head_dim,
                                      long long q_sb, long long q_ss, long long k_sb,
                                      long long k_ss, long long v_sb, long long v_ss,
                                      long long o_sb, long long o_ss, int sep, float scale,
                                      unsigned int seed, unsigned int threshold, float keep,
                                      int dropout, void* stream) {
  if (dq == nullptr) return (int)cudaErrorInvalidValue;
  return flash_attention_bwd(q, k, v, dout, lse, delta, dq, nullptr, nullptr, is_bf16, B, S, N,
                             head_dim, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, sep,
                             scale, seed, threshold, keep, dropout, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int is_bf16, int B, int S, int N,
                                       int head_dim, long long q_sb, long long q_ss,
                                       long long k_sb, long long k_ss, long long v_sb,
                                       long long v_ss, long long o_sb, long long o_ss, int sep,
                                       float scale, unsigned int seed, unsigned int threshold,
                                       float keep, int dropout, void* stream) {
  if (dk == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return flash_attention_bwd(q, k, v, dout, lse, delta, nullptr, dk, dv, is_bf16, B, S, N,
                             head_dim, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, sep,
                             scale, seed, threshold, keep, dropout, stream);
}
