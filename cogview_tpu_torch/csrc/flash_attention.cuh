// Causal + bidirectional-prefix flash attention, forward and backward, with
// optional attention-probability dropout, for NVIDIA Hopper (sm_90a).
//
// Replaces: cogview_tpu/ops/flash_attention.py::_fwd_kernel (:163), launched
// by _flash_fwd_impl's pallas_call (:371); the backward kernels below
// replace _bwd_dq_kernel (:212) and _bwd_dkv_kernel (:249).  bfloat16
// inputs run all three passes on the tensor cores (the wgmma kernels in the
// second half of this file); float32 inputs run FMA kernels on the CUDA
// cores, since float32 inputs need float32 products.
//
// Semantics (the JAX kernel's): s = (q . k) * scale with float32 sums; a key
// is visible iff (kpos <= qpos || kpos < sep) and both positions are < S,
// else its logit is -10000.  Online softmax in float32; l sums the mass
// before dropout; a kept probability is scaled by 1 / keep (keep = 1 -
// rate), cast to v's dtype, then multiplied with V.  o = acc / l in q's
// dtype and lse = m + log(l) in float32.  The dropout keep bit is
// hash_u32(seed, qpos, kpos, (b0 + b) * Ng + n0 + n) >= threshold in
// wrapping uint32 arithmetic, bit for bit the JAX package's
// ops/hash_prng.py: (b0, n0) is the offset of this launch's batch rows and
// heads in a sharded batch of Ng heads (zeros and N when unsharded), so a
// shard hashes the global coordinates the JAX kernel hashes under GSPMD.
//
// Layout: q, k, v [B, S, N, D], read through batch and sequence strides
// (the slices of a fused QKV projection are not contiguous; the wrapper
// passes their strides, so nothing is copied); o [B, S, N, D] contiguous;
// lse [B, N, S].
//
// Head dims.  Every kernel is a template on a tile width DT and takes the
// real head dim D <= DT at run time: a head's row stride and every output
// offset come from D, the scale 1/sqrt(D) from the wrapper.  Columns
// [D, DT) of a tile load as zeros (cp.async's zero fill, or a zero where a
// plain load is predicated off) and are never stored, so they add nothing
// to any product.  The tile widths are 16, 32, 64, 96, 128, 160, 192, 224
// and 256 (ops/flash_attention.py TILE_WIDTHS; each library's source lists
// its own in with_tile_width): the multiples of 32 up to 256, which the
// float32 kernels' column layout needs (8 threads of 4-wide vectors), and
// 16.  Every kernel also takes EXACT: D == DT with 16-byte copies, D and
// the copy width folded to those constants, so flash_attention.cu's
// kernels at D in {16, 32, 64, 128} are the code those widths always ran;
// the other libraries are built with EXACT false.  Where a head's D
// values, its strides or its
// pointer are not 16-byte multiples (D = 100 in bf16: 200 bytes), the
// wrapper passes the widest copy (vec: 16, 8 or 4 bytes, or 2 for plain
// bf16 loads) that all of them allow, and the kernels copy with it.
// Past 128 columns a tile's accumulators no longer fit in registers: the
// bfloat16 kernels and the float32 backward split the output columns over
// two blocks (Split below), each forming the whole score tile.
//
// The TPU runs its grid (B, N, Sq/bq) in order with whole-S K/V blocks in
// VMEM.  Here one block of 128 threads owns one (b, n, 64-row query tile),
// and the blocks run in parallel, longest query tiles first to even out the
// causal triangle.  Key tiles wholly above the diagonal and past sep are
// skipped (the TPU's `last`); the ragged edge (positions >= S) is
// zero-filled and masked.  The bfloat16 forward is described with the
// tensor-core kernels below.
//
// float32 forward (FMA on the CUDA cores, 67 TFLOP/s peak): the query tile
// stays in shared memory; 64-key K and V tiles are staged through shared
// memory one after the other (64 KB in all at D = 64).  Thread (ty, tx)
// owns rows 4ty..4ty+3 and columns Cols<64>::of(tx, j) = {4tx..4tx+3,
// 32+4tx..32+4tx+3} of each 64 x 64 score tile, and rows 4ty..4ty+3 and
// head dims Cols<D>::of(tx, j) (4 x D/8 of them) of the output, so the
// online-softmax state (m, l and a 4 x D/8 accumulator) stays in registers.
// Row maxima and sums are reduced over the 8 threads of a row with warp
// shuffles.  It divides a kept probability by keep, as the float32 backward
// kernels do.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups; one warpgroup
constexpr float MASK_VALUE = -10000.0f;
static_assert(BQ == BK, "load_transposed writes [D][BQ] tiles for both Q and K");

template <int DT>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (DT * BQ + DT * BK + BK * DT + BK * BQ);
}

struct Params {
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;  // batch / sequence strides, elements
  int S, N, D, vec, sep;  // D <= DT: the head dim; vec: bytes of one global copy
  float scale, keep;
  uint32_t seed, threshold;
  uint32_t b0, n0, Ng;  // the dropout hash's batch and head offsets, global heads
};

// the dropout hash's third coordinate of (batch row b, head n) of a launch
template <class P>
__device__ __forceinline__ uint32_t hash_bn(const P& p, int b, int n) {
  return ((uint32_t)b + p.b0) * p.Ng + (uint32_t)n + p.n0;
}

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

// two or four consecutive elements <-> floats, and the rounding of a
// probability to v's dtype
template <typename T> struct Io;

template <> struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

// The columns thread tx (of the 8 in a row) owns in a tile W wide: N of
// them, in groups of VW consecutive ones 8 VW apart.  W = 64 (a score tile,
// or D = 64): {4tx..4tx+3, 32+4tx..32+4tx+3}.  W = 80 or 112 (half a
// float32 backward tile of 160 or 224 columns) takes pairs.
template <int W> struct Cols {
  static_assert(W % 16 == 0, "a tile width is a multiple of 16");
  static constexpr int N = W / 8;
  static constexpr int VW = N % 4 == 0 ? 4 : 2;
  static __device__ __forceinline__ int of(int tx, int j) {
    return (j / VW) * (8 * VW) + VW * tx + j % VW;
  }
};

// VW consecutive floats of shared memory
template <int VW>
__device__ __forceinline__ void lds(float* out, const float* p) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  }
}

// a thread's columns of one row, Cols<W> over a row of W values, those
// below D only (D % 4 == 0 keeps every vector store aligned)
template <typename T, int W>
__device__ __forceinline__ void store_row(T* row, const float (&x)[Cols<W>::N], int tx, int D) {
  using C = Cols<W>;
#pragma unroll
  for (int g = 0; g < C::N / C::VW; ++g) {
    const int c = C::of(tx, g * C::VW);
    T* dst = row + c;
    if (D >= W || (c + C::VW <= D && (D & 3) == 0)) {
      if constexpr (C::VW == 4)
        Io<T>::store4(dst, make_float4(x[4 * g], x[4 * g + 1], x[4 * g + 2], x[4 * g + 3]));
      else
        Io<T>::store2(dst, x[2 * g], x[2 * g + 1]);
    } else {
#pragma unroll
      for (int e = 0; e < C::VW; ++e)
        if (c + e < D) dst[e] = x[g * C::VW + e];
    }
  }
}

// four values of a row from column c, zero at and past column D: one
// 16-byte load where the copy width allows it (vec == 16: the row starts
// 16-byte aligned and D % 4 == 0), else four predicated ones
__device__ __forceinline__ float4 load4_cols(const float* row, int c, int D, int vec) {
  if (vec == 16) return c < D ? Io<float>::load4(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = c + e < D ? row[c + e] : 0.0f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// rows [0, BQ) of a [S, ...] operand starting at row r0, as a transposed
// [DT][BQ] float tile (zero past S and at columns >= D).  D == DT with
// 16-byte rows (the tile widths' own head dims) takes the loop with no
// column test; any other D the predicated one, not unrolled.
template <typename T, int DT>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, long long row_stride,
                                                int r0, int S, int D, int vec) {
  if (vec == 16 && D == DT) {
    for (int i = threadIdx.x; i < BQ * DT / 4; i += THREADS) {
      const int r = i % BQ, d4 = i / BQ;  // consecutive threads, consecutive rows
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < S) x = Io<T>::load4(src + (long long)(r0 + r) * row_stride + 4 * d4);
      dst[(4 * d4 + 0) * BQ + r] = x.x;
      dst[(4 * d4 + 1) * BQ + r] = x.y;
      dst[(4 * d4 + 2) * BQ + r] = x.z;
      dst[(4 * d4 + 3) * BQ + r] = x.w;
    }
    return;
  }
#pragma unroll 1
  for (int i = threadIdx.x; i < BQ * DT / 4; i += THREADS) {
    const int r = i % BQ, d4 = i / BQ;  // consecutive threads, consecutive rows
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = load4_cols(src + (long long)(r0 + r) * row_stride, 4 * d4, D, vec);
    dst[(4 * d4 + 0) * BQ + r] = x.x;
    dst[(4 * d4 + 1) * BQ + r] = x.y;
    dst[(4 * d4 + 2) * BQ + r] = x.z;
    dst[(4 * d4 + 3) * BQ + r] = x.w;
  }
}

// rows [0, BK) of a [S, ...] operand starting at row r0, as a [BK][DT]
// float tile (zero past S and at columns >= D), as load_transposed
template <typename T, int DT>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long row_stride, int r0,
                                          int S, int D, int vec) {
  if (vec == 16 && D == DT) {
    for (int i = threadIdx.x; i < BK * DT / 4; i += THREADS) {
      const int r = i / (DT / 4), d4 = i % (DT / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < S) x = Io<T>::load4(src + (long long)(r0 + r) * row_stride + 4 * d4);
      *reinterpret_cast<float4*>(&dst[r * DT + 4 * d4]) = x;
    }
    return;
  }
#pragma unroll 1
  for (int i = threadIdx.x; i < BK * DT / 4; i += THREADS) {
    const int r = i / (DT / 4), d4 = i % (DT / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = load4_cols(src + (long long)(r0 + r) * row_stride, 4 * d4, D, vec);
    *reinterpret_cast<float4*>(&dst[r * DT + 4 * d4]) = x;
  }
}

template <int DT, bool DROPOUT, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 const Params p) {
  using T = float;      // bfloat16 inputs run the tensor-core kernel below
  using CK = Cols<BK>;  // the score tile's key columns
  using CD = Cols<DT>;  // the output's head dims
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [DT][BQ]  query tile, transposed
  float* Ks = Qs + DT * BQ;    // [DT][BK]  key tile, transposed
  float* Vs = Ks + DT * BK;    // [BK][DT]  value tile
  float* Ps = Vs + BK * DT;    // [BK][BQ]  probabilities, transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int n = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int S = p.S, D = EXACT ? DT : p.D, vec = EXACT ? 16 : p.vec;
  const uint32_t bn = hash_bn(p, b, n);

  const T* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const T* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const T* vb = v + (long long)b * p.v_sb + (long long)n * D;

  load_transposed<T, DT>(Qs, qb, p.q_ss, q0, S, D, vec);

  float m[4], l[4], acc[4][CD::N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CD::N; ++j) acc[i][j] = 0.0f;
  }

  // keys any row of this tile can see: [0, max(last row + 1, sep)) within S
  const int qlast = min(q0 + BQ, S) - 1;
  const int kend = min(S, max(qlast + 1, p.sep));
  const int nkt = (kend + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    load_transposed<T, DT>(Ks, kb, p.k_ss, k0, S, D, vec);
    load_rows<T, DT>(Vs, vb, p.v_ss, k0, S, D, vec);
    __syncthreads();

    // s = q . k over the tile's DT columns (zero past D), float32 sums
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DT; ++d) {
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
        const int kpos = k0 + CK::of(tx, j);
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
      for (int j = 0; j < CD::N; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pj = s[i][j];
        if (DROPOUT) {
          const uint32_t h = hash_u32(p.seed, (uint32_t)qpos, (uint32_t)(k0 + CK::of(tx, j)), bn);
          pj = h >= p.threshold ? pj / p.keep : 0.0f;
        }
        s[i][j] = Io<T>::round(pj);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(&Ps[CK::of(tx, j) * BQ + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p . v
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[c * BQ + 4 * ty]);
      float vv[CD::N];
#pragma unroll
      for (int g = 0; g < CD::N / CD::VW; ++g)
        lds<CD::VW>(&vv[g * CD::VW], &Vs[c * DT + CD::of(tx, g * CD::VW)]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CD::N; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= S) continue;
    float out[CD::N];
#pragma unroll
    for (int j = 0; j < CD::N; ++j) out[j] = acc[i][j] / l[i];
    store_row<T, DT>(o + (((long long)b * S + r) * p.N + n) * D, out, tx, D);
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
// The TPU runs the two passes as two pallas_calls over grids (B, N, Sq/bq)
// and (B, N, Sk/bk), so every output element has one owner and no sum
// crosses grid cells.  The CUDA kernels keep that split: no atomics, so two
// launches on the same inputs give the same bits.  Each pass recomputes s
// and dp.  float32 inputs run the FMA kernels right below (float32 inputs
// need float32 products); bfloat16 inputs run the tensor-core kernels after
// them.
//
// float32 design (FMA on the CUDA cores, 67 TFLOP/s peak):
//  - dq: one 128-thread block per (b, n, 64-row query tile), the layout of
//    the forward (thread (ty, tx) owns rows 4ty..4ty+3 and columns
//    Cols<W>::of(tx, j)).  Q and dO stay in shared memory, transposed; each
//    64-key tile of K (transposed and by rows) and V (transposed) is staged
//    in turn, s and dp are formed together, ds goes through shared memory,
//    and the dq accumulator stays in registers.  Key tiles stop at the
//    forward's bound (the diagonal, or sep).  96 KB of shared memory at
//    D = 64.
//  - dk/dv: one 128-thread block per (b, n, 64-key tile).  K and V stay in
//    shared memory, transposed; the block walks the query tiles from the
//    first that can see one of its keys (0 if the tile holds prefix keys
//    < sep, else the diagonal's tile) to the end, forming the transposed
//    score tile (rows are keys), and keeps both accumulators (2 x 4 x D/8
//    per thread) in registers.  lse and delta of the query tile are staged
//    in shared memory.  130 KB of shared memory at D = 64 (225 KB at
//    D = 128): one block per SM.
//  - Above 128 columns (DT = 160 .. 256) whole-head tiles pass the 227 KB
//    a block may have, and the accumulators the registers: the wide
//    kernels give each block half of the output columns (DO = DT / 2, two
//    blocks per tile, as the bf16 kernels split them) and form s and dp
//    over the head in chunks of DC = 32 columns, staging each chunk of
//    every operand in turn (the resident tiles of the narrow kernels are
//    re-read from L2 once a key or query tile), and stop at D, not DT.
// ------------------------------------------------------------------------

struct BwdParams {
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;  // o: dO
  int S, N, D, vec, sep;  // as Params
  float scale, keep;
  uint32_t seed, threshold;
  uint32_t b0, n0, Ng;  // as Params
};

template <int DT>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (5 * DT * BQ + BK * BQ);
}
template <int DT>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (6 * DT * BQ + 2 * BQ * BK + 2 * BQ);
}

// acc[i][j] += sum_c A[c][4ty + i] * B[c][Cols<W>::of(tx, j)] over c in
// [0, KLEN), A held [KLEN][64] and B [KLEN][W], the summed index first
template <int KLEN, int W>
__device__ __forceinline__ void tile_product(float (&acc)[4][Cols<W>::N], const float* A,
                                             const float* Bm, int ty, int tx) {
  using C = Cols<W>;
#pragma unroll 4
  for (int c = 0; c < KLEN; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(&A[c * 64 + 4 * ty]);
    float bv[C::N];
#pragma unroll
    for (int g = 0; g < C::N / C::VW; ++g)
      lds<C::VW>(&bv[g * C::VW], &Bm[c * W + C::of(tx, g * C::VW)]);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < C::N; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the thread's 4 x 8 patch of a 64 x 64 tile, stored transposed: dst[col][row]
__device__ __forceinline__ void store_patch_transposed(float* dst, const float (&x)[4][8], int ty,
                                                       int tx) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(&dst[Cols<64>::of(tx, j) * 64 + 4 * ty]) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

// the thread's rows of a W-column accumulator, columns below D only
template <typename T, int W>
__device__ __forceinline__ void store_patch(T* base, long long row_stride, int r0, int S,
                                            const float (&x)[4][Cols<W>::N], int ty, int tx,
                                            int D) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= S) continue;
    store_row<T, W>(base + (long long)r * row_stride, x[i], tx, D);
  }
}

// the dq pass's epilogue: s and dp of the thread's 4 x 8 patch (rows are
// queries q0 + 4ty + i, columns keys k0 + Cols<BK>::of(tx, j)) -> ds in s
template <bool DROPOUT>
__device__ __forceinline__ void dq_patch(float (&s)[4][8], const float (&dp)[4][8], int q0,
                                         int k0, int ty, int tx, const float (&lse_r)[4],
                                         const float (&delta_r)[4], const BwdParams& p,
                                         uint32_t bn) {
  using CK = Cols<BK>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kpos = k0 + CK::of(tx, j);
      const bool vis = (kpos <= qpos || kpos < p.sep) && kpos < p.S && qpos < p.S;
      const float pr = expf((vis ? s[i][j] * p.scale : MASK_VALUE) - lse_r[i]);
      float pd = pr;
      if (DROPOUT) {
        const uint32_t h = hash_u32(p.seed, (uint32_t)qpos, (uint32_t)kpos, bn);
        pd = h >= p.threshold ? pr / p.keep : 0.0f;
      }
      s[i][j] = (pd * dp[i][j] - pr * delta_r[i]) * p.scale;
    }
  }
}

// the dk/dv pass's epilogue on the transposed patch (rows are keys
// k0 + 4ty + i, columns queries q0 + Cols<BQ>::of(tx, j), their lse and
// delta in Ls, Es) -> ds in s and the dropped probability pd in dp
template <bool DROPOUT>
__device__ __forceinline__ void dkv_patch(float (&s)[4][8], float (&dp)[4][8], int q0, int k0,
                                          int ty, int tx, const float* Ls, const float* Es,
                                          const BwdParams& p, uint32_t bn) {
  using CQ = Cols<BQ>;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = CQ::of(tx, j);
    const int qpos = q0 + c;
    const float lse_c = Ls[c], delta_c = Es[c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + 4 * ty + i;
      const bool vis = (kpos <= qpos || kpos < p.sep) && kpos < p.S && qpos < p.S;
      const float pr = expf((vis ? s[i][j] * p.scale : MASK_VALUE) - lse_c);
      float pd = pr;
      if (DROPOUT) {
        const uint32_t h = hash_u32(p.seed, (uint32_t)qpos, (uint32_t)kpos, bn);
        pd = h >= p.threshold ? pr / p.keep : 0.0f;
      }
      s[i][j] = (pd * dp[i][j] - pr * delta_c) * p.scale;
      dp[i][j] = pd;
    }
  }
}

template <int DT, bool DROPOUT, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, const BwdParams p) {
  using T = float;  // bfloat16 inputs run the tensor-core kernels below
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [DT][BQ]  query tile, transposed
  float* Os = Qs + DT * BQ;    // [DT][BQ]  dO tile, transposed
  float* Ks = Os + DT * BQ;    // [DT][BK]  key tile, transposed
  float* Vs = Ks + DT * BK;    // [DT][BK]  value tile, transposed
  float* Kr = Vs + DT * BK;    // [BK][DT]  key tile, by rows
  float* Ds = Kr + BK * DT;    // [BK][BQ]  ds, transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int n = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int S = p.S, D = EXACT ? DT : p.D, vec = EXACT ? 16 : p.vec;
  const uint32_t bn = hash_bn(p, b, n);

  const T* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const T* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const T* vb = v + (long long)b * p.v_sb + (long long)n * D;
  const T* ob = dout + (long long)b * p.o_sb + (long long)n * D;
  const float* lse_b = lse + ((long long)b * p.N + n) * S;
  const float* delta_b = delta + ((long long)b * p.N + n) * S;

  load_transposed<T, DT>(Qs, qb, p.q_ss, q0, S, D, vec);
  load_transposed<T, DT>(Os, ob, p.o_ss, q0, S, D, vec);

  float lse_r[4], delta_r[4], acc[4][Cols<DT>::N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    lse_r[i] = r < S ? lse_b[r] : 0.0f;
    delta_r[i] = r < S ? delta_b[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < Cols<DT>::N; ++j) acc[i][j] = 0.0f;
  }

  // the forward's bound: keys any row of this tile can see
  const int qlast = min(q0 + BQ, S) - 1;
  const int kend = min(S, max(qlast + 1, p.sep));
  const int nkt = (kend + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Ks, Vs, Kr and Ds are done
    load_transposed<T, DT>(Ks, kb, p.k_ss, k0, S, D, vec);
    load_transposed<T, DT>(Vs, vb, p.v_ss, k0, S, D, vec);
    load_rows<T, DT>(Kr, kb, p.k_ss, k0, S, D, vec);
    __syncthreads();

    // s = q . k and dp = dO . v over DT (zero past D), float32 sums
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
    tile_product<DT, BK>(s, Qs, Ks, ty, tx);
    tile_product<DT, BK>(dp, Os, Vs, ty, tx);

    dq_patch<DROPOUT>(s, dp, q0, k0, ty, tx, lse_r, delta_r, p, bn);
    store_patch_transposed(Ds, s, ty, tx);
    __syncthreads();

    tile_product<BK, DT>(acc, Ds, Kr, ty, tx);  // dq += ds . k
  }

  store_patch<T, DT>(dq + (long long)b * S * p.N * D + (long long)n * D, (long long)p.N * D, q0,
                     S, acc, ty, tx, D);
}

template <int DT, bool DROPOUT, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, const BwdParams p) {
  using T = float;  // bfloat16 inputs run the tensor-core kernels below
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;            // [DT][BK]  key tile, transposed
  float* Vt = Kt + DT * BK;    // [DT][BK]  value tile, transposed
  float* Qt = Vt + DT * BK;    // [DT][BQ]  query tile, transposed
  float* Ot = Qt + DT * BQ;    // [DT][BQ]  dO tile, transposed
  float* Qr = Ot + DT * BQ;    // [BQ][DT]  query tile, by rows
  float* Or = Qr + BQ * DT;    // [BQ][DT]  dO tile, by rows
  float* Ps = Or + BQ * DT;    // [BQ][BK]  dropped probabilities (rows: queries)
  float* Ds = Ps + BQ * BK;    // [BQ][BK]  ds (rows: queries)
  float* Ls = Ds + BQ * BK;    // [BQ]      lse of the query tile
  float* Es = Ls + BQ;         // [BQ]      delta of the query tile

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;  // rows 4ty.. are keys, columns queries
  const int kt = blockIdx.x;              // low key tiles see the most queries
  const int n = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int S = p.S, D = EXACT ? DT : p.D, vec = EXACT ? 16 : p.vec;
  const uint32_t bn = hash_bn(p, b, n);

  const T* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const T* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const T* vb = v + (long long)b * p.v_sb + (long long)n * D;
  const T* ob = dout + (long long)b * p.o_sb + (long long)n * D;
  const float* lse_b = lse + ((long long)b * p.N + n) * S;
  const float* delta_b = delta + ((long long)b * p.N + n) * S;

  load_transposed<T, DT>(Kt, kb, p.k_ss, k0, S, D, vec);
  load_transposed<T, DT>(Vt, vb, p.v_ss, k0, S, D, vec);

  float dk_acc[4][Cols<DT>::N], dv_acc[4][Cols<DT>::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Cols<DT>::N; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  // every query tile sees a prefix key (< sep); otherwise the first query
  // that sees key k0 is k0 itself
  const int first = k0 < p.sep ? 0 : k0 / BQ;
  const int nqt = (S + BQ - 1) / BQ;

  for (int qt = first; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's reads are done
    load_transposed<T, DT>(Qt, qb, p.q_ss, q0, S, D, vec);
    load_transposed<T, DT>(Ot, ob, p.o_ss, q0, S, D, vec);
    load_rows<T, DT>(Qr, qb, p.q_ss, q0, S, D, vec);
    load_rows<T, DT>(Or, ob, p.o_ss, q0, S, D, vec);
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
    tile_product<DT, BQ>(s, Kt, Qt, ty, tx);
    tile_product<DT, BQ>(dp, Vt, Ot, ty, tx);

    dkv_patch<DROPOUT>(s, dp, q0, k0, ty, tx, Ls, Es, p, bn);
    store_patch_transposed(Ds, s, ty, tx);
    store_patch_transposed(Ps, dp, ty, tx);
    __syncthreads();

    tile_product<BQ, DT>(dv_acc, Ps, Or, ty, tx);  // dv += pd^T . dO
    tile_product<BQ, DT>(dk_acc, Ds, Qr, ty, tx);  // dk += ds^T . q
  }

  const long long out_b = (long long)b * S * p.N * D + (long long)n * D;
  store_patch<T, DT>(dk + out_b, (long long)p.N * D, k0, S, dk_acc, ty, tx, D);
  store_patch<T, DT>(dv + out_b, (long long)p.N * D, k0, S, dv_acc, ty, tx, D);
}

// the wide float32 kernels' chunk of the head dims, and their shared memory
constexpr int DC = 32;

template <int DT>
constexpr size_t dq_wide_smem_bytes() {
  return sizeof(float) * (2 * DC * BQ + 2 * DC * BK + BK * (DT / 2) + BK * BQ);
}
template <int DT>
constexpr size_t dkv_wide_smem_bytes() {
  return sizeof(float) * (2 * DC * BK + 2 * DC * BQ + 2 * BQ * (DT / 2) + 2 * BQ * BK + 2 * BQ);
}

template <int DT, bool DROPOUT, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, const BwdParams p) {
  using T = float;
  constexpr int DO = DT / 2;  // this block's output columns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [DC][BQ]  a chunk of the query tile, transposed
  float* Os = Qs + DC * BQ;    // [DC][BQ]  of the dO tile
  float* Ks = Os + DC * BQ;    // [DC][BK]  of the key tile
  float* Vs = Ks + DC * BK;    // [DC][BK]  of the value tile
  float* Kr = Vs + DC * BK;    // [BK][DO]  the key tile's columns of this block, by rows
  float* Ds = Kr + BK * DO;    // [BK][BQ]  ds, transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int x = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int qt = x / 2, c0 = (x % 2) * DO;  // the query tile and this block's first column
  const int n = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int S = p.S, D = EXACT ? DT : p.D, vec = EXACT ? 16 : p.vec;
  const uint32_t bn = hash_bn(p, b, n);

  const T* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const T* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const T* vb = v + (long long)b * p.v_sb + (long long)n * D;
  const T* ob = dout + (long long)b * p.o_sb + (long long)n * D;
  const float* lse_b = lse + ((long long)b * p.N + n) * S;
  const float* delta_b = delta + ((long long)b * p.N + n) * S;

  float lse_r[4], delta_r[4], acc[4][Cols<DO>::N];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    lse_r[i] = r < S ? lse_b[r] : 0.0f;
    delta_r[i] = r < S ? delta_b[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < Cols<DO>::N; ++j) acc[i][j] = 0.0f;
  }

  const int qlast = min(q0 + BQ, S) - 1;
  const int kend = min(S, max(qlast + 1, p.sep));
  const int nkt = (kend + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
    // s = q . k and dp = dO . v over the head's D columns, a chunk at a time
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      load_transposed<T, DC>(Qs, qb + d0, p.q_ss, q0, S, D - d0, vec);
      load_transposed<T, DC>(Os, ob + d0, p.o_ss, q0, S, D - d0, vec);
      load_transposed<T, DC>(Ks, kb + d0, p.k_ss, k0, S, D - d0, vec);
      load_transposed<T, DC>(Vs, vb + d0, p.v_ss, k0, S, D - d0, vec);
      __syncthreads();
      tile_product<DC, BK>(s, Qs, Ks, ty, tx);
      tile_product<DC, BK>(dp, Os, Vs, ty, tx);
    }
    load_rows<T, DO>(Kr, kb + c0, p.k_ss, k0, S, D - c0, vec);

    dq_patch<DROPOUT>(s, dp, q0, k0, ty, tx, lse_r, delta_r, p, bn);
    store_patch_transposed(Ds, s, ty, tx);
    __syncthreads();

    tile_product<BK, DO>(acc, Ds, Kr, ty, tx);  // dq += ds . k
  }

  store_patch<T, DO>(dq + (long long)b * S * p.N * D + (long long)n * D + c0,
                     (long long)p.N * D, q0, S, acc, ty, tx, D - c0);
}

template <int DT, bool DROPOUT, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, const BwdParams p) {
  using T = float;
  constexpr int DO = DT / 2;  // this block's output columns
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;            // [DC][BK]  a chunk of the key tile, transposed
  float* Vt = Kt + DC * BK;    // [DC][BK]  of the value tile
  float* Qt = Vt + DC * BK;    // [DC][BQ]  of the query tile
  float* Ot = Qt + DC * BQ;    // [DC][BQ]  of the dO tile
  float* Qr = Ot + DC * BQ;    // [BQ][DO]  the query tile's columns of this block, by rows
  float* Or = Qr + BQ * DO;    // [BQ][DO]  the dO tile's
  float* Ps = Or + BQ * DO;    // [BQ][BK]  dropped probabilities (rows: queries)
  float* Ds = Ps + BQ * BK;    // [BQ][BK]  ds (rows: queries)
  float* Ls = Ds + BQ * BK;    // [BQ]      lse of the query tile
  float* Es = Ls + BQ;         // [BQ]      delta of the query tile

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;  // rows 4ty.. are keys, columns queries
  const int kt = blockIdx.x / 2, c0 = (blockIdx.x % 2) * DO;
  const int n = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK;
  const int S = p.S, D = EXACT ? DT : p.D, vec = EXACT ? 16 : p.vec;
  const uint32_t bn = hash_bn(p, b, n);

  const T* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const T* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const T* vb = v + (long long)b * p.v_sb + (long long)n * D;
  const T* ob = dout + (long long)b * p.o_sb + (long long)n * D;
  const float* lse_b = lse + ((long long)b * p.N + n) * S;
  const float* delta_b = delta + ((long long)b * p.N + n) * S;

  float dk_acc[4][Cols<DO>::N], dv_acc[4][Cols<DO>::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < Cols<DO>::N; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  const int first = k0 < p.sep ? 0 : k0 / BQ;
  const int nqt = (S + BQ - 1) / BQ;

  for (int qt = first; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.0f;
    // transposed tiles over the head's D columns, a chunk at a time
    for (int d0 = 0; d0 < D; d0 += DC) {
      __syncthreads();  // the previous chunk's (and tile's) reads are done
      load_transposed<T, DC>(Kt, kb + d0, p.k_ss, k0, S, D - d0, vec);
      load_transposed<T, DC>(Vt, vb + d0, p.v_ss, k0, S, D - d0, vec);
      load_transposed<T, DC>(Qt, qb + d0, p.q_ss, q0, S, D - d0, vec);
      load_transposed<T, DC>(Ot, ob + d0, p.o_ss, q0, S, D - d0, vec);
      __syncthreads();
      tile_product<DC, BQ>(s, Kt, Qt, ty, tx);
      tile_product<DC, BQ>(dp, Vt, Ot, ty, tx);
    }
    load_rows<T, DO>(Qr, qb + c0, p.q_ss, q0, S, D - c0, vec);
    load_rows<T, DO>(Or, ob + c0, p.o_ss, q0, S, D - c0, vec);
    for (int i = tid; i < BQ; i += THREADS) {
      const int r = q0 + i;
      Ls[i] = r < S ? lse_b[r] : 0.0f;
      Es[i] = r < S ? delta_b[r] : 0.0f;
    }
    __syncthreads();

    dkv_patch<DROPOUT>(s, dp, q0, k0, ty, tx, Ls, Es, p, bn);
    store_patch_transposed(Ds, s, ty, tx);
    store_patch_transposed(Ps, dp, ty, tx);
    __syncthreads();

    tile_product<BQ, DO>(dv_acc, Ps, Or, ty, tx);  // dv += pd^T . dO
    tile_product<BQ, DO>(dk_acc, Ds, Qr, ty, tx);  // dk += ds^T . q
  }

  const long long out_b = (long long)b * S * p.N * D + (long long)n * D + c0;
  store_patch<T, DO>(dk + out_b, (long long)p.N * D, k0, S, dk_acc, ty, tx, D - c0);
  store_patch<T, DO>(dv + out_b, (long long)p.N * D, k0, S, dv_acc, ty, tx, D - c0);
}

// ------------------------------------------------------------------------
// On the tensor cores: the bfloat16 forward (K3), dq kernel (K4) and dk/dv
// kernel (K5).
//
// Replaces: cogview_tpu/ops/flash_attention.py::_fwd_kernel (:163),
// ::_bwd_dq_kernel (:212) and ::_bwd_dkv_kernel (:249), launched by
// _flash_fwd_impl's pallas_call (:371) and _flash_bwd_impl's (:433, :451),
// for bfloat16 inputs.  Semantics: the forward's (file header) and the
// backward's, above.
//
// What bounds them on an H100.  The forward does 4 D operations per
// visible (query, key) pair (s and p.v): at post-selection's B = 4, N = 40,
// S = 1058, D = 64 that is 23 GFLOP, 23.2 us at the bf16 tensor-core peak
// (989 TFLOP/s), against 87 MB of q, k, v, o and lse, 26.1 us at 3.35 TB/s:
// bytes-bound at 26.1 us (at the tutorial's B = 16, N = 16, S = 1088: 39
// GFLOP and 144 MB, 42.9 us).  The dq pass does 6 D operations per pair
// (s, dp and dq) and the dk/dv pass 8 D (s, dp, dv and dk): at the
// tutorial's shape 58 and 78 GFLOP, 58.9 and 78.5 us, just above their
// bytes (q, k, v, dO, lse and delta read once, the outputs written once:
// 180 and 216 MB, 54 and 65 us).  Beside the products every pair pays, on
// the CUDA cores, one exp2 on the special-function units (~40 us a pass
// over the tutorial's 151.7 M visible pairs) and, with dropout, the ~12
// integer operations of the counter hash (~100 us a pass), so with dropout
// the epilogue may set the pace of every pass.
//
// Design.  One warpgroup (128 threads) per block owns 64 rows of the
// output: the forward and the dq pass a query tile (Q, and dO for dq,
// resident), the dk/dv pass a key tile (K and V resident); each walks the
// other side's tiles between the same bounds as the float32 kernels (keys
// up to the diagonal or sep; queries from the first that sees the key
// tile), longest query tiles first in the forward and the dq pass.
//  - Products with wgmma.mma_async m64nNk16, bf16 in, float32 accumulators.
//    S = Q.K^T and dP = dO.V^T (dk/dv pass: S^T = K.Q^T, dP^T = V.dO^T)
//    take both operands from shared memory, D/16 k-steps.  The epilogue
//    turns them into p (forward), ds (and pd) in the accumulator registers;
//    these are rounded to bf16 and fed straight back as the A operand of
//    O += P.V (dQ += dS.K, dV += Pd^T.dO, dK += dS^T.Q), with no trip
//    through shared memory, and the streamed tile read MN-major as B (4
//    k-steps of 16).
//  - Forward epilogue: the online softmax in the log2 domain, each thread
//    holding two rows of the 64 x 64 score tile (16 values each); row maxima
//    over the thread's values, then over the row's 4 lanes by shuffles;
//    O's D/2 accumulator registers are rescaled by their row's
//    alpha = exp2(m_old - m_new) between the two products; each thread keeps
//    its own part of l and the 4 lanes sum them once, at the end.  The
//    epilogue, not the products, sets the forward's pace, so it is kept
//    short: full tiles take the maximum of the raw scores and fold the
//    scale into the fma before the exp2, and the exp2 is ex2.approx.ftz
//    (exp2f adds three instructions for results below 2^-126).  Tried on
//    an H100 and slower: 128-row blocks of two warpgroups sharing the K/V
//    tiles (the tiles' L2 traffic does not bound it), the next tile's S
//    issued before this tile's softmax within a warpgroup (more registers,
//    and ptxas fences the register operands), and 5 blocks per SM at D = 64.
//  - Tiles are bf16 in shared memory, in the swizzled layout the wgmma
//    descriptors name (128-byte swizzle in 64-column panels for D >= 64,
//    64-byte for D = 32, 32-byte for D = 16), filled by 16-byte cp.async
//    copies (zero past S) through the batch and sequence strides.  The
//    streamed tiles are double-buffered: the next tile's copies are issued
//    before this tile's products, so they overlap.
//  - Tiles that every row sees wholly (below the diagonal, or inside the
//    prefix, and inside S: the JAX kernels' full blocks) skip the mask (a
//    MASKED template split); dropout still hashes every pair.  exp2 with
//    log2(e) folded into the scale and lse; the forward's lse is
//    (m2 + log2 l) ln 2.
//  - Dropout scaling: the kept probability is multiplied by 1 / keep_rate,
//    as PyTorch divides a CUDA tensor by a scalar, in all three bf16
//    kernels, so the forward's kept probabilities and the backward's pd are
//    the same numbers (the JAX kernel and the float32 kernels divide; the
//    bf16 tolerance covers the one-ulp difference).
//  - Registers: the forward holds S (32 floats), O (D/2) and the 16 p
//    fragment registers; the dq pass S, dP (32 floats each), dQ (D/2) and the
//    16 ds fragment registers.  The dk/dv pass holds dK and dV (D/2 each)
//    beside S^T and dP^T; at D = 128 its query tiles are 32 wide, so S^T
//    and dP^T take 16 floats each and dK, dV 64 each.
//  - Several blocks share an SM, so one block's epilogue overlaps another's
//    products.
//  - ptxas (-Xptxas -v, sm_90a, a CUDA 12 nvcc; chip_smoke.py prints the
//    same from cuobjdump), registers without / with dropout, and dynamic
//    shared memory:
//      fwd:   D = 16: 72 / 79, D = 32: 89 / 93, D = 64: 128 / 128,
//             D = 128: 166 / 168; 11,264 / 21,504 / 41,984 / 82,944 bytes
//      dq:    D = 16: 98 / 103, D = 32: 118 / 128, D = 64: 128 / 162,
//             D = 128: 190 / 234; 13,312 / 25,600 / 50,176 / 99,328 bytes
//      dk/dv: D = 16: 138 / 158, D = 32: 155 / 160, D = 64: 198 / 218,
//             D = 128: 210 / 228; 14,336 / 26,624 / 51,200 / 67,072 bytes
//    no instantiation spills (0-byte stack frames), so at D = 64 four
//    forward blocks, four dq blocks (three with dropout) and two dk/dv
//    blocks share an SM.
//    chip_smoke.py prints every bf16 kernel's registers from cuobjdump and
//    fails on any stack or local memory at D = 64.
// ------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// d[64 x 32] += A[64 x 16] . B[16 x 32], both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 16] += A[64 x 16] . B[16 x 16], A from registers (bf16 pairs), B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += A[64 x 16] . B[16 x 32], A from registers (bf16 pairs), B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs), B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (bf16 pairs), B
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 8 bytes global -> shared, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// n < 8 of 8 consecutive bf16 values from src (zeros for the rest) -> the
// 16 bytes at shared address dst, by plain loads (2-byte aligned operands)
__device__ __forceinline__ void copy8_plain(uint32_t dst, const __nv_bfloat16* src, int n) {
  uint16_t x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = e < n ? reinterpret_cast<const uint16_t*>(src)[e] : 0;
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(x[0] | (uint32_t)x[1] << 16), "r"(x[2] | (uint32_t)x[3] << 16),
               "r"(x[4] | (uint32_t)x[5] << 16), "r"(x[6] | (uint32_t)x[7] << 16)
               : "memory");
}

// How a tile width's bfloat16 blocks share out the output columns: up to
// 128 columns one block holds them all; above, two blocks hold DO = DT / 2
// each (the accumulators of 256 columns would take 128 registers a thread
// in the forward and 256 in the dk/dv pass), and each forms the whole
// score tile.  PW: the panel width of the tiles, the widest of 64, 32 and
// 16 columns that divides DO, so a block's columns are whole panels.
template <int DT> struct Split {
  static constexpr int N = DT > 128 ? 2 : 1;
  static constexpr int DO = DT / N;
  static constexpr int PW = DO % 64 == 0 ? 64 : DO % 32 == 0 ? 32 : 16;
  static_assert(DT % 16 == 0 && DT <= 256, "wgmma takes 16-column steps up to 256");
};

// An R x DT bf16 tile in shared memory, in the canonical layout of wgmma's
// descriptors: panels of PW columns (64, 32 or 16: DT's Split), each R rows
// of 2 PW bytes, with the 16-byte chunks of a row XOR-swizzled by the
// row's address bits (128-, 64- or 32-byte swizzle).  The tile's base is
// 1024-byte aligned.  At DT in {16, 32, 64, 128}, PW = min(DT, 64).
template <int DT, int R, int PW_ = Split<DT>::PW> struct Tile {
  static constexpr int PW = PW_;
  static constexpr int ROWB = 2 * PW;
  static constexpr int PANEL = R * ROWB;
  static constexpr int BYTES = R * DT * 2;
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;  // B128, B64, B32

  // byte offset of the 8 values (r, 8 c8 .. 8 c8 + 7)
  static __device__ __forceinline__ uint32_t chunk(int r, int c8) {
    const uint32_t off = (c8 / (PW / 8)) * PANEL + r * ROWB + (c8 % (PW / 8)) * 16;
    return off ^ (((off >> 7) & (ROWB / 16 - 1)) << 4);
  }
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
           (uint64_t)(sbo >> 4) << 32 | LAYOUT << 62;
  }
  // as a K-major operand (summed over the DT columns): k-step kk, columns
  // 16 kk .. 16 kk + 15
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    return desc(base + (16 * kk / PW) * PANEL + (16 * kk % PW) * 2, 16, 8 * ROWB);
  }
  // as an MN-major B operand (summed over the rows, N the columns from the
  // panel at base): k-step kk, rows 16 kk .. 16 kk + 15; panels PANEL
  // bytes apart
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return desc(base + 16 * kk * ROWB, PANEL, 8 * ROWB);
  }
  // rows [r0, r0 + R) of a [S, ...] operand (row stride in elements), zero
  // past S and at columns >= D, by asynchronous copies of vec bytes (16, 8
  // or 4) from all 128 threads, or by plain loads (vec 2)
  static __device__ __forceinline__ void load(uint32_t base, const __nv_bfloat16* src,
                                              long long row_stride, int r0, int S, int D,
                                              int vec) {
    constexpr int CHUNKS = R * DT / 8;
    if (vec == 16 && D == DT) {  // the tile widths' own head dims: whole 16-byte rows
#pragma unroll
      for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
        const int i = it * THREADS + threadIdx.x;
        if (CHUNKS % THREADS != 0 && i >= CHUNKS) break;
        const int r = i / (DT / 8), c8 = i % (DT / 8);
        const bool in = r0 + r < S;
        cp_async16(base + chunk(r, c8),
                   src + (in ? (long long)(r0 + r) * row_stride + 8 * c8 : 0), in ? 16 : 0);
      }
      return;
    }
#pragma unroll 1
    for (int i = threadIdx.x; i < CHUNKS; i += THREADS) {
      const int r = i / (DT / 8), c8 = i % (DT / 8);
      // values of this chunk to copy: 8, none, or (D % 8 at the head's
      // last chunk, where vec < 16) a part
      const int n = r0 + r < S ? min(max(D - 8 * c8, 0), 8) : 0;
      const __nv_bfloat16* g = src + (n ? (long long)(r0 + r) * row_stride + 8 * c8 : 0);
      const uint32_t dst = base + chunk(r, c8);
      if (vec == 16) {
        cp_async16(dst, g, 2 * n);
      } else if (vec == 8) {
        cp_async8(dst, g, n >= 4 ? 8 : 0);
        cp_async8(dst + 8, n > 4 ? g + 4 : g, n > 4 ? 8 : 0);
      } else if (vec == 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cp_async4(dst + 4 * e, n > 2 * e ? g + 2 * e : g, n > 2 * e ? 4 : 0);
      } else {
        copy8_plain(dst, g, n);
      }
    }
  }
};

// d[64 x NC] += A[64 x 16 KS] (KS k-steps of four registers) . B, where B
// is rows [0, 16 KS) and NC columns of the MN-major tile TT from the panel
// at base: one m64n128 product a k-step at NC = 128 (as D = 128 always
// ran), else one product per panel of TT::PW columns
template <class TT, int NC, int KS>
__device__ __forceinline__ void wgmma_rs_tile(float (&d)[NC / 2], const uint32_t* a,
                                              uint32_t base) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (NC == 128) {
      wgmma_rs(d, a + 4 * kk, TT::mnmajor(base, kk));
    } else {
#pragma unroll
      for (int j = 0; j < NC / TT::PW; ++j)
        wgmma_rs(*reinterpret_cast<float(*)[TT::PW / 2]>(&d[j * TT::PW / 2]), a + 4 * kk,
                 TT::mnmajor(base + j * TT::PANEL, kk));
    }
  }
}

// the accumulator fragment of an m64nN product: element i of a thread
// (warp w, lane l) is row 16 w + l / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (l % 4) + (i & 1); as the A operand of the next product,
// k-step kk's four registers are the pairs (2 j, 2 j + 1) of elements
// 8 kk .. 8 kk + 7, so a[i] = bf16x2(d[2 i], d[2 i + 1])

// Every (row, column) of a tile pair is visible: all keys <= every query
// or < sep, and everything inside S.
__device__ __forceinline__ bool tile_full(int q0, int nq, int k0, int nk, int sep, int S) {
  return k0 + nk <= max(q0 + 1, sep) && q0 + nq <= S && k0 + nk <= S;
}

// ds (and pd) of one element pair from the scores; q/k positions for the
// mask and the hash
template <bool MASKED, bool DROPOUT>
__device__ __forceinline__ float2 bwd_pair(float s0, float s1, float dp0, float dp1, int qpos0,
                                           int qpos1, int kpos0, int kpos1, float lse2_0,
                                           float lse2_1, float delta0, float delta1,
                                           float scale_log2, float inv_keep, const BwdParams& p,
                                           uint32_t bn, float2* pd_out) {
  float arg0 = fmaf(s0, scale_log2, -lse2_0), arg1 = fmaf(s1, scale_log2, -lse2_1);
  if (MASKED) {
    const bool vis0 = (kpos0 <= qpos0 || kpos0 < p.sep) && kpos0 < p.S && qpos0 < p.S;
    const bool vis1 = (kpos1 <= qpos1 || kpos1 < p.sep) && kpos1 < p.S && qpos1 < p.S;
    if (!vis0) arg0 = MASK_VALUE * LOG2E - lse2_0;
    if (!vis1) arg1 = MASK_VALUE * LOG2E - lse2_1;
  }
  const float p0 = exp2f(arg0), p1 = exp2f(arg1);
  float pd0 = p0, pd1 = p1;
  if (DROPOUT) {
    pd0 = hash_u32(p.seed, (uint32_t)qpos0, (uint32_t)kpos0, bn) >= p.threshold ? p0 * inv_keep
                                                                                 : 0.0f;
    pd1 = hash_u32(p.seed, (uint32_t)qpos1, (uint32_t)kpos1, bn) >= p.threshold ? p1 * inv_keep
                                                                                 : 0.0f;
  }
  if (pd_out != nullptr) *pd_out = make_float2(pd0, pd1);
  return make_float2((pd0 * dp0 - p0 * delta0) * p.scale, (pd1 * dp1 - p1 * delta1) * p.scale);
}

// dq pass epilogue: rows are queries (qrow = the thread's first row),
// columns keys (kcol = k0 + 2 (lane % 4)) -> ds as A fragments
template <bool MASKED, bool DROPOUT>
__device__ __forceinline__ void dq_epilogue(const float (&s)[32], const float (&dp)[32],
                                            uint32_t (&a)[16], int qrow, int kcol,
                                            const float (&lse2)[2], const float (&dlt)[2],
                                            float scale_log2, float inv_keep, const BwdParams& p,
                                            uint32_t bn) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int h = i & 1, kpos = kcol + 8 * (i >> 1), qpos = qrow + 8 * h;
    const float2 ds = bwd_pair<MASKED, DROPOUT>(
        s[2 * i], s[2 * i + 1], dp[2 * i], dp[2 * i + 1], qpos, qpos, kpos, kpos + 1, lse2[h],
        lse2[h], dlt[h], dlt[h], scale_log2, inv_keep, p, bn, nullptr);
    a[i] = pack_bf16(ds.x, ds.y);
  }
}

// dk/dv pass epilogue: rows are keys (krow), columns queries (qcol =
// q0 + 2 (lane % 4)); lse2 / delta per column -> pd and ds as A fragments
template <int BN, bool MASKED, bool DROPOUT>
__device__ __forceinline__ void dkv_epilogue(const float (&s)[BN / 2], const float (&dp)[BN / 2],
                                             uint32_t (&ap)[BN / 4], uint32_t (&ad)[BN / 4],
                                             int krow, int qcol, const float2 (&lse2)[BN / 8],
                                             const float2 (&dlt)[BN / 8], float scale_log2,
                                             float inv_keep, const BwdParams& p, uint32_t bn) {
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) {
    const int nb = i >> 1, kpos = krow + 8 * (i & 1), qpos = qcol + 8 * nb;
    float2 pd;
    const float2 ds = bwd_pair<MASKED, DROPOUT>(
        s[2 * i], s[2 * i + 1], dp[2 * i], dp[2 * i + 1], qpos, qpos + 1, kpos, kpos,
        lse2[nb].x, lse2[nb].y, dlt[nb].x, dlt[nb].y, scale_log2, inv_keep, p, bn, &pd);
    ap[i] = pack_bf16(pd.x, pd.y);
    ad[i] = pack_bf16(ds.x, ds.y);
  }
}

// a thread's accumulator fragment of an m64nNC product -> rows [r0, r0 + 64)
// of a contiguous [S, N, D] bf16 output (row stride N D) from out, rows < S
// and the first ncols of the NC columns only (the rest are the tile's zero
// columns past D).  Pairs go out as one 4-byte store where ncols is even (D
// is then, and every pair starts 4-byte aligned), else one value at a time.
template <int NC>
__device__ __forceinline__ void store_fragment(__nv_bfloat16* out, long long row_stride, int r0,
                                               int S, const float (&d)[NC / 2], int ncols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * h;
    if (r >= S) continue;
    __nv_bfloat16* row = out + (long long)r * row_stride + 2 * (lane & 3);
#pragma unroll
    for (int nb = 0; nb < NC / 8; ++nb) {
      const int c = 8 * nb + 2 * (lane & 3);
      if (ncols >= NC) {
        *reinterpret_cast<uint32_t*>(row + 8 * nb) = pack_bf16(d[4 * nb + 2 * h],
                                                               d[4 * nb + 2 * h + 1]);
      } else if (c >= ncols) {
        continue;
      } else if ((ncols & 1) == 0) {
        *reinterpret_cast<uint32_t*>(row + 8 * nb) = pack_bf16(d[4 * nb + 2 * h],
                                                               d[4 * nb + 2 * h + 1]);
      } else {
        row[8 * nb] = __float2bfloat16(d[4 * nb + 2 * h]);
        if (c + 1 < ncols) row[8 * nb + 1] = __float2bfloat16(d[4 * nb + 2 * h + 1]);
      }
    }
  }
}

// 2^x on the special-function unit, results below 2^-126 flushed to zero
// (exp2f adds a rescale around it for them, three more instructions)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// forward epilogue: rows are queries (qrow = the thread's first row),
// columns keys (kcol = k0 + 2 (lane % 4)).  Scores s -> the probabilities
// as A fragments, the rows' new maxima m (log2 domain), the rescale alpha of
// the old state, and this thread's part of l
template <bool MASKED, bool DROPOUT>
__device__ __forceinline__ void fwd_epilogue(float (&s)[32], uint32_t (&a)[16], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], int qrow,
                                             int kcol, float scale_log2, float inv_keep,
                                             const Params& p, uint32_t bn) {
  // A masked tile scales its scores and masks them in place.  A full tile
  // keeps them raw: the row maximum of s * c is round(max(s) * c) for
  // c > 0, and s * c - m goes into one fma.
  const float c = MASKED ? 1.0f : scale_log2;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    if (MASKED) {
      const int qpos = qrow + 8 * h, kpos = kcol + 8 * (i >> 2) + (i & 1);
      s[i] = (kpos <= qpos || kpos < p.sep) && kpos < p.S && qpos < p.S ? s[i] * scale_log2
                                                                        : MASK_VALUE * LOG2E;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * c);
    alpha[h] = exp2_ftz(m[h] - m_new);  // 0 on the first tile (m = -inf)
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int h = i & 1;
    float p0 = exp2_ftz(fmaf(s[2 * i], c, -m[h])), p1 = exp2_ftz(fmaf(s[2 * i + 1], c, -m[h]));
    l[h] += p0 + p1;  // the mass before dropout
    if (DROPOUT) {
      const int qpos = qrow + 8 * h, kpos = kcol + 8 * (i >> 1);
      p0 = hash_u32(p.seed, (uint32_t)qpos, (uint32_t)kpos, bn) >= p.threshold ? p0 * inv_keep
                                                                              : 0.0f;
      p1 = hash_u32(p.seed, (uint32_t)qpos, (uint32_t)(kpos + 1), bn) >= p.threshold
               ? p1 * inv_keep
               : 0.0f;
    }
    a[i] = pack_bf16(p0, p1);
  }
}

template <int DT>
constexpr size_t fwd_tc_smem_bytes() {
  return 5 * Tile<DT, 64>::BYTES + 1024;  // Q, 2 x (K, V); alignment slack
}

template <int DT, bool DROPOUT, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, const Params p) {
  using SP = Split<DT>;
  using TT = Tile<DT, 64>;
  constexpr int DO = SP::DO;
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sQ = (smem_u32(smem_tc) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + TT::BYTES;  // buffer j: K at sKV + 2 j BYTES, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int qt = x / SP::N, part = x % SP::N;  // the query tile, this block's columns
  const int n = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * 64;
  const int S = p.S, D = EXACT ? DT : p.D, vec = EXACT ? 16 : p.vec;
  const uint32_t bn = hash_bn(p, b, n);

  const __nv_bfloat16* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const __nv_bfloat16* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const __nv_bfloat16* vb = v + (long long)b * p.v_sb + (long long)n * D;

  // keys any row of this tile can see: [0, max(last row + 1, sep)) within S
  const int qlast = min(q0 + 64, S) - 1;
  const int nkt = (min(S, max(qlast + 1, p.sep)) + 63) / 64;

  TT::load(sQ, qb, p.q_ss, q0, S, D, vec);
  TT::load(sKV, kb, p.k_ss, 0, S, D, vec);
  TT::load(sKV + TT::BYTES, vb, p.v_ss, 0, S, D, vec);
  cp_async_commit();

  const int qrow = q0 + 16 * warp + (lane >> 2);
  const float scale_log2 = p.scale * LOG2E, inv_keep = 1.0f / p.keep;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * 64;
    const uint32_t sK = sKV + (kt & 1) * 2 * TT::BYTES, sV = sK + TT::BYTES;
    cp_async_wait_all();  // tile kt is in
    fence_async_shared();
    __syncthreads();  // ... for every thread, and tile kt - 1's buffer is free
    if (kt + 1 < nkt) {
      const uint32_t nK = sKV + ((kt + 1) & 1) * 2 * TT::BYTES;
      TT::load(nK, kb, p.k_ss, k0 + 64, S, D, vec);
      TT::load(nK + TT::BYTES, vb, p.v_ss, k0 + 64, S, D, vec);
      cp_async_commit();
    }

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) wgmma_ss(s, TT::kmajor(sQ, kk), TT::kmajor(sK, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    uint32_t a[16];
    float alpha[2];
    const int kcol = k0 + 2 * (lane & 3);
    if (tile_full(q0, 64, k0, 64, p.sep, S))
      fwd_epilogue<false, DROPOUT>(s, a, m, l, alpha, qrow, kcol, scale_log2, inv_keep, p, bn);
    else
      fwd_epilogue<true, DROPOUT>(s, a, m, l, alpha, qrow, kcol, scale_log2, inv_keep, p, bn);

    // the previous product is complete (waited below), so the rescale reads
    // and writes settled registers; the fence keeps it ahead of the next one
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    fence_operands(acc);
    wgmma_fence();
    wgmma_rs_tile<TT, DO, 4>(acc, a, sV + part * (DO / TT::PW) * TT::PANEL);  // o += p.v
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
  }

  // l: the sum of the 4 lanes' parts of each row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) acc[i] = acc[i] / l[(i >> 1) & 1];
  store_fragment<DO>(o + (long long)b * S * p.N * D + (long long)n * D + part * DO,
                     (long long)p.N * D, q0, S, acc, D - part * DO);
  if (part == 0 && (lane & 3) == 0) {
    float* lse_b = lse + ((long long)b * p.N + n) * S;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qrow + 8 * h;
      if (r < S) lse_b[r] = (m[h] + log2f(l[h])) * LN2;
    }
  }
}

template <int DT>
constexpr size_t dq_tc_smem_bytes() {
  return 6 * Tile<DT, 64>::BYTES + 1024;  // Q, dO, 2 x (K, V); alignment slack
}

template <int DT, bool DROPOUT, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                          const BwdParams p) {
  using SP = Split<DT>;
  using TT = Tile<DT, 64>;
  constexpr int DO = SP::DO;
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sQ = (smem_u32(smem_tc) + 1023u) & ~1023u;
  const uint32_t sO = sQ + TT::BYTES;
  const uint32_t sKV = sO + TT::BYTES;  // buffer j: K at sKV + 2 j BYTES, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int qt = x / SP::N, part = x % SP::N;  // the query tile, this block's columns
  const int n = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * 64;
  const int S = p.S, D = EXACT ? DT : p.D, vec = EXACT ? 16 : p.vec;
  const uint32_t bn = hash_bn(p, b, n);

  const __nv_bfloat16* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const __nv_bfloat16* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const __nv_bfloat16* vb = v + (long long)b * p.v_sb + (long long)n * D;
  const __nv_bfloat16* ob = dout + (long long)b * p.o_sb + (long long)n * D;
  const float* lse_b = lse + ((long long)b * p.N + n) * S;
  const float* delta_b = delta + ((long long)b * p.N + n) * S;

  const int qlast = min(q0 + 64, S) - 1;
  const int nkt = (min(S, max(qlast + 1, p.sep)) + 63) / 64;

  TT::load(sQ, qb, p.q_ss, q0, S, D, vec);
  TT::load(sO, ob, p.o_ss, q0, S, D, vec);
  TT::load(sKV, kb, p.k_ss, 0, S, D, vec);
  TT::load(sKV + TT::BYTES, vb, p.v_ss, 0, S, D, vec);
  cp_async_commit();

  const int qrow = q0 + 16 * warp + (lane >> 2);
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qrow + 8 * h;
    lse2[h] = r < S ? lse_b[r] * LOG2E : 0.0f;
    dlt[h] = r < S ? delta_b[r] : 0.0f;
  }
  const float scale_log2 = p.scale * LOG2E, inv_keep = 1.0f / p.keep;

  float acc[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * 64;
    const uint32_t sK = sKV + (kt & 1) * 2 * TT::BYTES, sV = sK + TT::BYTES;
    cp_async_wait_all();  // tile kt is in
    fence_async_shared();
    __syncthreads();  // ... for every thread, and tile kt - 1's buffer is free
    if (kt + 1 < nkt) {
      const uint32_t nK = sKV + ((kt + 1) & 1) * 2 * TT::BYTES;
      TT::load(nK, kb, p.k_ss, k0 + 64, S, D, vec);
      TT::load(nK + TT::BYTES, vb, p.v_ss, k0 + 64, S, D, vec);
      cp_async_commit();
    }

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) wgmma_ss(s, TT::kmajor(sQ, kk), TT::kmajor(sK, kk));
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) wgmma_ss(dp, TT::kmajor(sO, kk), TT::kmajor(sV, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    uint32_t a[16];
    const int kcol = k0 + 2 * (lane & 3);
    if (tile_full(q0, 64, k0, 64, p.sep, S))
      dq_epilogue<false, DROPOUT>(s, dp, a, qrow, kcol, lse2, dlt, scale_log2, inv_keep, p, bn);
    else
      dq_epilogue<true, DROPOUT>(s, dp, a, qrow, kcol, lse2, dlt, scale_log2, inv_keep, p, bn);

    fence_operands(acc);
    wgmma_fence();
    wgmma_rs_tile<TT, DO, 4>(acc, a, sK + part * (DO / TT::PW) * TT::PANEL);  // dq += ds.k
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
  }

  store_fragment<DO>(dq + (long long)b * S * p.N * D + (long long)n * D + part * DO,
                     (long long)p.N * D, q0, S, acc, D - part * DO);
}

// queries per streamed tile of the dk/dv pass: 32 above 64 output columns
// keeps S^T and dP^T at 16 registers each beside the two accumulators (64
// registers each at 128 columns)
template <int DT>
constexpr int DKV_TC_BN = Split<DT>::DO > 64 ? 32 : 64;

template <int DT>
constexpr size_t dkv_tc_smem_bytes() {
  // K, V; 2 x (Q, dO); 2 x (lse, delta); alignment slack
  return 2 * Tile<DT, 64>::BYTES + 4 * Tile<DT, DKV_TC_BN<DT>>::BYTES +
         4 * DKV_TC_BN<DT> * sizeof(float) + 1024;
}

template <int DT, bool DROPOUT, bool EXACT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, const BwdParams p) {
  using SP = Split<DT>;
  constexpr int BN = DKV_TC_BN<DT>;
  constexpr int DO = SP::DO;
  using TK = Tile<DT, 64>;
  using TQ = Tile<DT, BN>;
  extern __shared__ __align__(128) uint8_t smem_tc[];
  const uint32_t sK = (smem_u32(smem_tc) + 1023u) & ~1023u;
  const uint32_t sV = sK + TK::BYTES;
  const uint32_t sQO = sV + TK::BYTES;  // buffer j: Q at sQO + 2 j BYTES, dO after it
  const uint32_t sLE = sQO + 4 * TQ::BYTES;  // buffer j: lse at sLE + 2 j BN 4, delta after
  const float* le = reinterpret_cast<const float*>(smem_tc + (sLE - smem_u32(smem_tc)));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x;
  const int kt = blockIdx.x / SP::N, part = blockIdx.x % SP::N;  // low key tiles see the most
  const int n = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * 64;
  const int S = p.S, D = EXACT ? DT : p.D, vec = EXACT ? 16 : p.vec;
  const uint32_t bn = hash_bn(p, b, n);

  const __nv_bfloat16* qb = q + (long long)b * p.q_sb + (long long)n * D;
  const __nv_bfloat16* kb = k + (long long)b * p.k_sb + (long long)n * D;
  const __nv_bfloat16* vb = v + (long long)b * p.v_sb + (long long)n * D;
  const __nv_bfloat16* ob = dout + (long long)b * p.o_sb + (long long)n * D;
  const float* lse_b = lse + ((long long)b * p.N + n) * S;
  const float* delta_b = delta + ((long long)b * p.N + n) * S;

  // every query tile sees a prefix key (< sep); otherwise the first query
  // that sees key k0 is k0 itself
  const int first = k0 < p.sep ? 0 : k0 / BN;
  const int nqt = (S + BN - 1) / BN;

  // query tile qt (rows q0 ..) into buffer j: Q, dO, lse, delta
  auto load_query_tile = [&](int j, int q0) {
    const uint32_t sQ = sQO + j * 2 * TQ::BYTES;
    TQ::load(sQ, qb, p.q_ss, q0, S, D, vec);
    TQ::load(sQ + TQ::BYTES, ob, p.o_ss, q0, S, D, vec);
    if (tid < 2 * BN) {
      const int c = tid % BN, r = q0 + c;
      const float* src = tid < BN ? lse_b : delta_b;
      cp_async4(sLE + (j * 2 * BN + tid) * 4, src + (r < S ? r : 0), r < S ? 4 : 0);
    }
  };
  TK::load(sK, kb, p.k_ss, k0, S, D, vec);
  TK::load(sV, vb, p.v_ss, k0, S, D, vec);
  load_query_tile(0, first * BN);
  cp_async_commit();

  const float scale_log2 = p.scale * LOG2E, inv_keep = 1.0f / p.keep;
  const int krow = k0 + 16 * warp + (lane >> 2);
  float dk_acc[DO / 2], dv_acc[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int qt = first; qt < nqt; ++qt) {
    const int q0 = qt * BN, j = (qt - first) & 1;
    const uint32_t sQ = sQO + j * 2 * TQ::BYTES, sO = sQ + TQ::BYTES;
    cp_async_wait_all();  // tile qt is in
    fence_async_shared();
    __syncthreads();  // ... for every thread, and tile qt - 1's buffer is free
    if (qt + 1 < nqt) {
      load_query_tile(j ^ 1, q0 + BN);
      cp_async_commit();
    }

    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.0f;
    fence_operands(s);
    fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) wgmma_ss(s, TK::kmajor(sK, kk), TQ::kmajor(sQ, kk));
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) wgmma_ss(dp, TK::kmajor(sV, kk), TQ::kmajor(sO, kk));
    wgmma_commit();

    // lse (times log2 e) and delta of this thread's query columns
    const int c0 = 2 * (lane & 3);
    float2 lse2[BN / 8], dlt[BN / 8];
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const float2 l2 = *reinterpret_cast<const float2*>(le + j * 2 * BN + 8 * nb + c0);
      lse2[nb] = make_float2(l2.x * LOG2E, l2.y * LOG2E);
      dlt[nb] = *reinterpret_cast<const float2*>(le + j * 2 * BN + BN + 8 * nb + c0);
    }
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    uint32_t ap[BN / 4], ad[BN / 4];
    if (tile_full(q0, BN, k0, 64, p.sep, S))
      dkv_epilogue<BN, false, DROPOUT>(s, dp, ap, ad, krow, q0 + c0, lse2, dlt, scale_log2,
                                       inv_keep, p, bn);
    else
      dkv_epilogue<BN, true, DROPOUT>(s, dp, ap, ad, krow, q0 + c0, lse2, dlt, scale_log2,
                                      inv_keep, p, bn);

    fence_operands(dk_acc);
    fence_operands(dv_acc);
    wgmma_fence();
    const uint32_t cols = part * (DO / TQ::PW) * TQ::PANEL;  // this block's first panel
    wgmma_rs_tile<TQ, DO, BN / 16>(dv_acc, ap, sO + cols);  // dv += pd^T . dO
    wgmma_rs_tile<TQ, DO, BN / 16>(dk_acc, ad, sQ + cols);  // dk += ds^T . q
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dk_acc);
    fence_operands(dv_acc);
  }

  const long long out_b = (long long)b * S * p.N * D + (long long)n * D + part * DO;
  store_fragment<DO>(dk + out_b, (long long)p.N * D, k0, S, dk_acc, D - part * DO);
  store_fragment<DO>(dv + out_b, (long long)p.N * D, k0, S, dv_acc, D - part * DO);
}

template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                          Args... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int DT, bool DROPOUT, bool EXACT>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       const BwdParams& p, cudaStream_t stream) {
  const int tiles = (p.S + BQ - 1) / BQ;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid(tiles * Split<DT>::N, p.N, B);
    if (dq != nullptr)
      return launch_kernel(flash_bwd_dq_wgmma_kernel<DT, DROPOUT, EXACT>, grid,
                           dq_tc_smem_bytes<DT>(), stream, qt, kt, vt, ot, lse, delta, dqt, p);
    return launch_kernel(flash_bwd_dkv_wgmma_kernel<DT, DROPOUT, EXACT>, grid,
                         dkv_tc_smem_bytes<DT>(), stream, qt, kt, vt, ot, lse, delta, dkt, dvt, p);
  } else if constexpr (DT > 128) {  // the wide float32 kernels: two blocks a tile
    const dim3 grid(tiles * 2, p.N, B);
    if (dq != nullptr)
      return launch_kernel(flash_bwd_dq_wide_kernel<DT, DROPOUT, EXACT>, grid,
                           dq_wide_smem_bytes<DT>(), stream, qt, kt, vt, ot, lse, delta, dqt, p);
    return launch_kernel(flash_bwd_dkv_wide_kernel<DT, DROPOUT, EXACT>, grid,
                         dkv_wide_smem_bytes<DT>(), stream, qt, kt, vt, ot, lse, delta, dkt, dvt,
                         p);
  } else {
    const dim3 grid(tiles, p.N, B);
    if (dq != nullptr)
      return launch_kernel(flash_bwd_dq_kernel<DT, DROPOUT, EXACT>, grid, dq_smem_bytes<DT>(),
                           stream, qt, kt, vt, ot, lse, delta, dqt, p);
    return launch_kernel(flash_bwd_dkv_kernel<DT, DROPOUT, EXACT>, grid, dkv_smem_bytes<DT>(),
                         stream, qt, kt, vt, ot, lse, delta, dkt, dvt, p);
  }
}

template <typename T, int DT, bool DROPOUT, bool EXACT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   const Params& p, cudaStream_t stream) {
  const int tiles = (p.S + BQ - 1) / BQ;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_kernel(flash_fwd_wgmma_kernel<DT, DROPOUT, EXACT>,
                         dim3(tiles * Split<DT>::N, p.N, B), fwd_tc_smem_bytes<DT>(), stream, qt,
                         kt, vt, static_cast<T*>(o), lse, p);
  else
    return launch_kernel(flash_fwd_kernel<DT, DROPOUT, EXACT>, dim3(tiles, p.N, B),
                         fwd_smem_bytes<DT>(), stream, qt, kt, vt, static_cast<T*>(o), lse, p);
}

// the copy widths the kernels take: 16, 8 or 4 bytes by cp.async (or 16-
// byte loads), 2 by plain bf16 loads
inline bool valid_copy(int vec, int is_bf16) {
  return vec == 16 || vec == 8 || vec == 4 || (vec == 2 && is_bf16);
}

}  // namespace
