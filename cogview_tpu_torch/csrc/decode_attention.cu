// Single-token decode attention over the int8 or packed int4 window-blocked
// KV cache, with the deferred seal of the last SEAL_GROUP tokens, for NVIDIA
// Hopper (sm_90a).
//
// Replaces: cogview_tpu/ops/decode_attention.py::_decode_kernel, launched by
// decode_attention_quant's pallas_call: its int8 branch (Dc == D, K1,
// decode_attention_int8) and its packed int4 branch (Dc == D / 2, K2,
// decode_attention_int4).  One kernel template serves both (PACKED), for
// each tile width of with_tile_width below (ops/decode_attention.py
// TILE_WIDTHS: 8, 16, 32, 64, 128 and 256).  The kernel takes the real head
// dim D <= DT at run time: the row and ring strides, the scale 1/sqrt(D),
// and the window bytes it copies (Dc x W) come from D, and a lane's rows
// at or past Dc multiply zeros of q with whatever the tile holds there
// (bytes become finite floats) and are never stored, so every D from 1 to
// 256 runs (the packed cache needs D even: D / 2 columns hold D values).
// Each tile width is built twice: EXACT for D == DT, D a constant (at D in
// {8, 16, 32, 64, 128} the code those widths always ran), and for any
// other D, read at run time.  A D between tile widths pays in registers and
// in the loop steps of the tile's idle rows, not in bytes: it copies only
// its own Dc rows of each window.
//
// Layout (the JAX package's, kept so cache bytes compare with no converter):
//   kv     [NW, B, 2, N, Dc, W] int8  one layer's view, K at 0 / V at 1,
//                                     W = 128 tokens minor per [Dc, W] block;
//                                     int4: byte (d2, t) = 16 * v[d2] +
//                                     (v[d2 + D/2] + 8), v in [-7, 7]
//   scales [NW, B, 2, N, W]    float  per (head, token), absmax / 127 or / 7
//   ring   [G, B, N, 2*D]      float  exact K|V columns of positions c0 + g
//                                     (copied by 16 bytes, by 8 at odd D)
//   q, ctx [B, N, D]                  bfloat16 or float32
//
// Semantics (the JAX kernel's).  A step at index (rem = index % G, c0 =
// index - rem) attends the sealed columns [0, c0) of the
// swl = max(ceil(c0 / W), 1) windows it streams (columns >= c0 take the
// logit -10000) and the exact ring slots g <= rem, scaled by 1/sqrt(D).
// int8: with bfloat16 q the logits are (q . k) * (ks * scale) and the PV
// operand is bf16(p * vs); with float32 q the query is scaled first.  int4:
// float32 throughout whatever q's dtype, logits (q_hi . k_hi + q_lo . k_lo) *
// ks of the scaled query; hi = floor(b / 16) and lo = (b & 15) - 8 of every
// byte b.  The ring is float32.  On seal steps (rem == G - 1) the G ring
// columns of each (row, head) are quantized (scale = absmax * float32(1/127)
// or float32(1/7), x / scale rounded half to even; int4 clips to [-7, 7]
// and packs) into window c0 / W, lanes [c0 % W, c0 % W + G); the window's
// other lanes keep their bytes.  The division and rintf must be IEEE (no
// --use_fast_math) so the bytes equal the plain PyTorch version's.
//
// What bounds it on an H100: bytes streamed from device memory, 2 x Dc
// bytes and two scales per visible sealed column per (row, head), plus the
// visible ring slots; the arithmetic is a few float32 operations per byte
// (one query per (row, head), no grouped heads: no tensor-core product).
// At cogview-base, batch 4, index 600 one call needs about 13.2 MB with the
// int8 cache and 7.0 MB with the int4 cache, 3.9 and 2.1 us at 3.35 TB/s.
//
// Design.  The grid is (B * N) x splits blocks of 128 threads (4 warps).
// splits is a function of the shapes (B, N, NW) alone, never of index
// (ops/decode_attention.py split_plan): at batch 4 the 160 (row, head) pairs
// alone would leave most of the 132 SMs' warp slots empty, at batch 40 one
// split per pair fills them.  Split s streams windows s, s + splits, ...
// below swl; a split with none writes an empty partial.
// - Window loop: the next window's K and V [Dc, W] blocks and its two scale
//   rows are copied into the other of two shared-memory stages with 16-byte
//   cp.async while this window computes; the one barrier per window is the
//   stage hand-off.  Split 0 also copies its pair's ring slots 0..rem at
//   kernel start, in the first window's copy group.
// - Lanes: warp w owns tokens [32w, 32w + 32) of every window, and lane
//   (quad, grp) the four tokens 32w + 4 quad .. + 3 and a quarter of the
//   block's rows (row_of).  Each 32-bit shared load gives it four tokens of
//   one row, in the QK pass (K) and the PV pass (V) alike, and every byte of
//   a window is read by one lane once.  A row's 16-byte chunk c sits at
//   chunk c ^ (row & 7), which keeps both passes free of bank conflicts.
//   Bytes become floats exactly with integer ops and one add (the byte
//   placed in the mantissa of 2^23), never through the conversion unit.
// - Softmax: each warp keeps its own running max; each lane its share of
//   the sum and its rows' P.V over its four tokens, all in registers; the
//   tile width is a template parameter, so q sits in registers and every
//   loop over a lane's rows unrolls.  In
//   the loop only shuffles meet: two for the logits' four row groups, three
//   for the warp's max.  After it the lanes' sums meet by shuffles and the
//   four warps (in split 0 with the exact ring slots) merge once.
// - Merge: with splits > 1 each block writes its partial (acc[D], m, l) to a
//   float32 scratch [splits, B, N, D + 2], fences, and takes a ticket from
//   its (row, head)'s counter; the last block merges the partials in split
//   order (the same bits whichever block finishes last), writes ctx, resets
//   the counter to 0 and, on seal steps, seals: every split has read its
//   windows by then.  One launch per call.  Calls that share the counters
//   must run in order (one stream).
// - Seal: four warps, one ring column at a time: the column's absmax by a
//   warp reduction, then its D values (int4: D/2 packed bytes) written one
//   lane each.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int W = 128;        // tokens per window
constexpr int G = 8;          // ring slots, columns per seal (SEAL_GROUP)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;     // window buffers in shared memory
constexpr float MASK_VALUE = -10000.0f;
constexpr float EMPTY = -1e30f;  // running max over no column

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the 8 quads of a warp (lane bits 0-2)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte j of u (0..255) as the float 2^23 + u_j
__device__ __forceinline__ float byte_f32(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j));
}

// the four signed bytes of a word, exactly: b ^ 0x80 is b + 128
__device__ __forceinline__ void int8x4_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = byte_f32(u, j) - 8388736.0f;  // 2^23 + 128
}

// hi = floor(b / 16) and lo = (b & 15) - 8 of the four bytes of a word:
// (b ^ 0x80) >> 4 is hi + 8
__device__ __forceinline__ void int4x8_f32(uint32_t w, float (&hi)[4], float (&lo)[4]) {
  const uint32_t h = ((w ^ 0x80808080u) >> 4) & 0x0F0F0F0Fu;
  const uint32_t l = w & 0x0F0F0F0Fu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    hi[j] = byte_f32(h, j) - 8388616.0f;  // 2^23 + 8
    lo[j] = byte_f32(l, j) - 8388616.0f;
  }
}

// one window in shared memory: the K and V [Dc, W] blocks, row r's 16-byte
// chunk c at chunk c ^ (r & 7), and the K and V scale rows
template <int Dc>
struct Stage {
  int8_t k[Dc * W];
  int8_t v[Dc * W];
  float ks[W];
  float vs[W];
};

template <int DT, bool PACKED>
struct Shared {
  static constexpr int DcT = PACKED ? DT / 2 : DT;
  Stage<DcT> stage[STAGES];
  float ring[G][2 * DT];  // split 0: its pair's ring slots 0..rem
  float acc[WARPS][DT];   // each warp's P.V
  float m[WARPS], l[WARPS];  // each warp's max and sum
  float sg[G];           // split 0: the ring logits
  int last;              // this block merges the splits
};

// Row i of lane group grp (i < DcT / 4) of a tile DcT rows high.  For
// DcT >= 8 the four groups read rows whose (r & 7) / 2 differ, so a warp's
// 32 loads of a pass (8 quads x 4 groups, two chunks of each row) land in
// 32 different banks.
template <int DcT>
__device__ __forceinline__ int row_of(int grp, int i) {
  if constexpr (DcT >= 8)
    return 8 * (i >> 1) + 2 * grp + (i & 1);
  else
    return grp;  // DcT == 4 (int4 at tile width 8): one row per group
}

struct Args {
  const void* q;
  const float* ring;
  int8_t* kv;
  float* scales;
  void* ctx;
  float* part;    // [splits, B, N, D + 2] partials (splits > 1)
  int* counters;  // [B * N] tickets, 0 between calls (splits > 1)
  int B, N, D, index, splits;  // D: the head dim, at most the tile width
};

template <typename T, bool BF16, bool PACKED, int DT, bool EXACT>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(const Args a) {
  static_assert(!(BF16 && PACKED), "the packed branch is float32 throughout");
  constexpr int DcT = PACKED ? DT / 2 : DT;  // rows of the tile
  constexpr int RPG = DcT / 4;               // rows per lane group
  static_assert(DcT % 8 == 0 || DcT == 4, "tile widths 8 .. 256");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<DT, PACKED>& sh = *reinterpret_cast<Shared<DT, PACKED>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane & 7, grp = lane >> 3;
  const int bn = blockIdx.x, split = blockIdx.y, splits = a.splits;
  const int B = a.B, N = a.N, D = EXACT ? DT : a.D;  // EXACT: the tile's own D
  const int Dc = PACKED ? D / 2 : D;      // bytes per column
  const size_t BLK = (size_t)Dc * W;      // bytes of one [Dc, W] block
  const int b = bn / N, n = bn - b * N;
  const int rem = a.index % G, c0 = a.index - rem;
  const int swl = max((c0 + W - 1) / W, 1);
  const int nwin = split < swl ? (swl - 1 - split) / splits + 1 : 0;
  const float scale = 1.0f / sqrtf((float)D);
  const float* ring_bn = a.ring + (size_t)bn * 2 * D;
  const size_t gstride = (size_t)B * N * 2 * D;  // between ring slots
  const T* qg = static_cast<const T*>(a.q) + (size_t)bn * D;

  // window split + i * splits into stage i % STAGES, as one copy group
  auto issue = [&](int i) {
    if (i < nwin) {
      const int w = split + i * splits;
      Stage<DcT>& st = sh.stage[i % STAGES];
      const int8_t* kg = a.kv + ((((size_t)w * B + b) * 2) * N + n) * BLK;
      const int8_t* vg = kg + (size_t)N * BLK;
      constexpr int CHUNKS = DcT * W / 16;  // 16-byte chunks of a tile's block
#pragma unroll
      for (int k = 0; k < (CHUNKS + THREADS - 1) / THREADS; ++k) {
        const int c = tid + k * THREADS;
        if ((EXACT && CHUNKS % THREADS == 0) || c < Dc * (W / 16)) {  // the block's rows
          const int r = c >> 3, off = r * W + (((c & 7) ^ (r & 7)) << 4);
          cp_async16(st.k + off, kg + 16 * c);
          cp_async16(st.v + off, vg + 16 * c);
        }
      }
      if (tid < 64) {
        const float* sk = a.scales + (((size_t)w * B + b) * 2 * N + n) * W;
        if (tid < 32)
          cp_async16(st.ks + 4 * tid, sk + 4 * tid);
        else
          cp_async16(st.vs + 4 * (tid - 32), sk + (size_t)N * W + 4 * (tid - 32));
      }
    }
    cp_async_commit();
  };

  // the ring slots 0..rem, 2D floats each, join window 0's group: 16-byte
  // copies where D is even (a slot starts 16-byte aligned), else 8-byte ones
  if (split == 0) {
    if ((D & 1) == 0) {
      for (int c = tid; c < (rem + 1) * (D / 2); c += THREADS) {
        const int g = c / (D / 2), k = c - g * (D / 2);
        cp_async16(&sh.ring[g][4 * k], ring_bn + g * gstride + 4 * k);
      }
    } else {
      for (int c = tid; c < (rem + 1) * D; c += THREADS) {
        const int g = c / D, k = c - g * D;
        cp_async8(&sh.ring[g][2 * k], ring_bn + g * gstride + 2 * k);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  // this lane's rows of q: scaled unless the bf16 path scales the logits;
  // zero at rows >= Dc
  float qr[RPG], qlo[PACKED ? RPG : 1];
#pragma unroll
  for (int i = 0; i < RPG; ++i) {
    const int r = row_of<DcT>(grp, i);
    const bool in = EXACT || r < Dc;
    const float x = in ? to_f32<T>(qg[r]) : 0.0f;
    qr[i] = BF16 ? x : x * scale;
    if constexpr (PACKED) qlo[i] = in ? to_f32<T>(qg[Dc + r]) * scale : 0.0f;
  }

  float m = EMPTY, l = 0.0f;  // the warp's running max, this lane's share of the sum
  float acc[RPG], acc_lo[PACKED ? RPG : 1];
#pragma unroll
  for (int i = 0; i < RPG; ++i) acc[i] = 0.0f;
  if constexpr (PACKED) {
#pragma unroll
    for (int i = 0; i < RPG; ++i) acc_lo[i] = 0.0f;
  }
  const int chunk = 2 * warp + (quad >> 2);  // this lane's chunk of every row
  const int word = 4 * (quad & 3);           // and its word in the chunk
  const int tok = 16 * chunk + word;         // its first token in a window

  for (int i = 0; i < nwin; ++i) {
    cp_async_wait<STAGES - 2>();  // window i has landed, for this thread's copies
    __syncthreads();              // for everyone's; window i - 1's stage is free
    issue(i + STAGES - 1);
    const Stage<DcT>& st = sh.stage[i % STAGES];

    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < RPG; ++k) {
      const int r = row_of<DcT>(grp, k);
      const uint32_t wk =
          *reinterpret_cast<const uint32_t*>(st.k + r * W + ((chunk ^ (r & 7)) << 4) + word);
      if constexpr (PACKED) {
        float hi[4], lo[4];
        int4x8_f32(wk, hi, lo);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] += qr[k] * hi[j] + qlo[k] * lo[j];
      } else {
        float kf[4];
        int8x4_f32(wk, kf);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] += qr[k] * kf[j];
      }
    }
    const float4 ks4 = *reinterpret_cast<const float4*>(st.ks + tok);
    const float4 vs4 = *reinterpret_cast<const float4*>(st.vs + tok);
    const float ksc[4] = {ks4.x, ks4.y, ks4.z, ks4.w};
    const float vsc[4] = {vs4.x, vs4.y, vs4.z, vs4.w};
    const int t0 = (split + i * splits) * W + tok;
    float mx = EMPTY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 8);  // the four row groups
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);
      s[j] = BF16 ? s[j] * (ksc[j] * scale) : s[j] * ksc[j];
      if (t0 + j >= c0) s[j] = MASK_VALUE;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float pv[4], psum = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      pv[j] = p * vsc[j];
      if constexpr (BF16) pv[j] = __bfloat162float(__float2bfloat16(pv[j]));
    }
    l = l * alpha + psum;
    m = m_new;

#pragma unroll
    for (int k = 0; k < RPG; ++k) {
      const int r = row_of<DcT>(grp, k);
      const uint32_t wv =
          *reinterpret_cast<const uint32_t*>(st.v + r * W + ((chunk ^ (r & 7)) << 4) + word);
      if constexpr (PACKED) {
        float hi[4], lo[4];
        int4x8_f32(wv, hi, lo);
        float ah = 0.0f, al = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) ah += pv[j] * hi[j], al += pv[j] * lo[j];
        acc[k] = acc[k] * alpha + ah;
        acc_lo[k] = acc_lo[k] * alpha + al;
      } else {
        float vf[4];
        int8x4_f32(wv, vf);
        float av = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) av += pv[j] * vf[j];
        acc[k] = acc[k] * alpha + av;
      }
    }
  }
  cp_async_wait<0>();

  // the warp's sum and P.V over its 32 tokens (the four groups hold the
  // same tokens, the eight quads different ones)
  l = quad_sum(l);
#pragma unroll
  for (int k = 0; k < RPG; ++k) {
    acc[k] = quad_sum(acc[k]);
    if constexpr (PACKED) acc_lo[k] = quad_sum(acc_lo[k]);
  }
  if (quad == 0) {
#pragma unroll
    for (int k = 0; k < RPG; ++k) {
      const int r = row_of<DcT>(grp, k);
      if (!EXACT && r >= Dc) continue;
      sh.acc[warp][r] = acc[k];
      if constexpr (PACKED) sh.acc[warp][Dc + r] = acc_lo[k];
    }
  }
  if (lane == 0) sh.m[warp] = m, sh.l[warp] = l;
  // split 0: the exact ring logits, float32, of the scaled query; warp w
  // takes slots w and w + 4 (the ring landed with window 0)
  if (split == 0)
    for (int g = warp; g <= rem; g += WARPS) {
      float x = 0.0f;
      for (int d = lane; d < D; d += 32) x += to_f32<T>(qg[d]) * scale * sh.ring[g][d];
      x = warp_sum(x);
      if (lane == 0) sh.sg[g] = x;
    }
  __syncthreads();

  // the block's partial: thread d (and d + 128) merges the warps' (and
  // split 0's ring); a tile of at most 128 columns takes one pass, as the
  // exact kernels always did
  T* ctx = static_cast<T*>(a.ctx) + (size_t)bn * D;
  const auto partial = [&](int d) {
    float M = sh.m[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, sh.m[w]);
    if (split == 0)
      for (int g = 0; g <= rem; ++g) M = fmaxf(M, sh.sg[g]);
    float lb = 0.0f, ab = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(sh.m[w] - M);
      lb += e * sh.l[w];
      ab += e * sh.acc[w][d];
    }
    if (split == 0)
      for (int g = 0; g <= rem; ++g) {
        const float e = expf(sh.sg[g] - M);
        lb += e;
        ab += e * sh.ring[g][D + d];
      }
    if (splits == 1) {
      ctx[d] = from_f32<T>(ab / lb);
    } else {
      float* p = a.part + ((size_t)split * B * N + bn) * (D + 2);
      p[d] = ab;
      if (d == 0) p[D] = M, p[D + 1] = lb;
    }
  };
  if constexpr (DT <= THREADS) {
    if (tid < D) partial(tid);
  } else {
    for (int d = tid; d < D; d += THREADS) partial(d);
  }

  if (splits > 1) {
    __threadfence();  // the partial is visible before the ticket
    __syncthreads();
    if (tid == 0) sh.last = atomicAdd(&a.counters[bn], 1) == splits - 1;
    __syncthreads();
    if (!sh.last) return;
    __threadfence();
    const auto merge = [&](int d) {  // the splits in split order, online: one pass
      const size_t stride = (size_t)B * N * (D + 2);
      const float* p = a.part + (size_t)bn * (D + 2);
      float M = EMPTY, lt = 0.0f, at = 0.0f;
#pragma unroll 4
      for (int s = 0; s < splits; ++s) {
        const float ms = __ldcg(p + s * stride + D), ls = __ldcg(p + s * stride + D + 1);
        const float as = __ldcg(p + s * stride + d);
        const float Mn = fmaxf(M, ms);
        const float r = expf(M - Mn), e = expf(ms - Mn);
        lt = lt * r + ls * e;
        at = at * r + as * e;
        M = Mn;
      }
      ctx[d] = from_f32<T>(at / lt);
    };
    if constexpr (DT <= THREADS) {
      if (tid < D) merge(tid);
    } else {
      for (int d = tid; d < D; d += THREADS) merge(d);
    }
    if (tid == 0) a.counters[bn] = 0;
  }

  // ---- seal: the G ring columns of this (row, head) into window c0 / W,
  // lanes [c0 % W, c0 % W + G); warp w takes columns w, w + 4, ...
  if (rem == G - 1) {
    const int win = c0 / W;
    for (int col = warp; col < 2 * G; col += WARPS) {
      const int g = col >> 1, t = col & 1;
      const float* x = ring_bn + g * gstride + t * D;
      float amax = 0.0f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(x[d]));
      amax = warp_max(amax);
      // times float32(1/127) or float32(1/7), not a division: the JAX seal
      // compiles to this
      const float sc = fmaxf(amax, 1e-8f) * (PACKED ? (1.0f / 7.0f) : (1.0f / 127.0f));
      const size_t blk = (((size_t)win * B + b) * 2 + t) * N + n;
      const int pos = c0 % W + g;
      int8_t* dst = a.kv + blk * BLK + pos;
      if constexpr (PACKED) {
        for (int d = lane; d < Dc; d += 32) {
          const float hi = fminf(fmaxf(rintf(x[d] / sc), -7.0f), 7.0f);
          const float lo = fminf(fmaxf(rintf(x[Dc + d] / sc), -7.0f), 7.0f);
          dst[(size_t)d * W] = (int8_t)(16.0f * hi + (lo + 8.0f));
        }
      } else {
        for (int d = lane; d < D; d += 32) dst[(size_t)d * W] = (int8_t)rintf(x[d] / sc);
      }
      if (lane == 0) a.scales[blk * W + pos] = sc;
    }
  }
}

template <typename T, bool BF16, bool PACKED, int DT, bool EXACT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const auto kernel = decode_attention_kernel<T, BF16, PACKED, DT, EXACT>;
  constexpr size_t smem = sizeof(Shared<DT, PACKED>);
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.B * a.N, a.splits), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// f(std::integral_constant<int, DT>) for the tile widths the kernels are
// built for (ops/decode_attention.py TILE_WIDTHS; a CPU test parses this
// switch)
template <typename F>
cudaError_t with_tile_width(int tile, F&& f) {
  switch (tile) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

template <bool PACKED>
int decode_attention(const void* q, int q_is_bf16, const float* ring, int8_t* kv,
                     float* scales, void* ctx, float* part, int* counters, int B, int N, int D,
                     int tile, int NW, int index, int splits, void* stream) {
  if (B <= 0 || N <= 0 || NW <= 0 || index < 0 || index >= NW * W || splits < 1 ||
      splits > 65535 || (splits > 1 && (part == nullptr || counters == nullptr)) || D < 1 ||
      D > tile || (PACKED && D % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const Args a{q, ring, kv, scales, ctx, part, counters, B, N, D, index, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_tile_width(tile, [&](auto t) {
    constexpr int DT = decltype(t)::value;
    const auto pick = [&](auto exact) {
      constexpr bool X = decltype(exact)::value;
      if constexpr (PACKED)  // float32 arithmetic for both q dtypes
        return q_is_bf16 ? launch<__nv_bfloat16, false, true, DT, X>(a, s)
                         : launch<float, false, true, DT, X>(a, s);
      else
        return q_is_bf16 ? launch<__nv_bfloat16, true, false, DT, X>(a, s)
                         : launch<float, false, false, DT, X>(a, s);
    };
    return D == DT ? pick(std::true_type{}) : pick(std::false_type{});
  });
}

}  // namespace

// K1: int8 cache, Dc == D
extern "C" int decode_attention_int8(const void* q, int q_is_bf16, const float* ring,
                                     int8_t* kv, float* scales, void* ctx, float* part,
                                     int* counters, int B, int N, int D, int tile, int NW,
                                     int index, int splits, void* stream) {
  return decode_attention<false>(q, q_is_bf16, ring, kv, scales, ctx, part, counters, B, N, D,
                                 tile, NW, index, splits, stream);
}

// K2: packed int4 cache, Dc == D / 2
extern "C" int decode_attention_int4(const void* q, int q_is_bf16, const float* ring,
                                     int8_t* kv, float* scales, void* ctx, float* part,
                                     int* counters, int B, int N, int D, int tile, int NW,
                                     int index, int splits, void* stream) {
  return decode_attention<true>(q, q_is_bf16, ring, kv, scales, ctx, part, counters, B, N, D,
                                tile, NW, index, splits, stream);
}
