// Single-token decode attention over the int8 window-blocked KV cache, with
// the deferred seal of the last SEAL_GROUP tokens, for NVIDIA Hopper (sm_90a).
//
// Replaces: cogview_tpu/ops/decode_attention.py::_decode_kernel, int8 branch
// (Dc == D), launched by decode_attention_quant's pallas_call.
//
// Layout (the JAX package's, kept so cache bytes compare with no converter):
//   kv     [NW, B, 2, N, D, W] int8   one layer's view, K at 0 / V at 1,
//                                     W = 128 tokens minor per [D, W] block
//   scales [NW, B, 2, N, W]    float  per (head, token), absmax / 127
//   ring   [G, B, N, 2*D]      float  exact K|V columns of positions c0 + g
//   q, ctx [B, N, D]                  bfloat16 or float32
//
// Design: one block per (row, head) and 128 threads, one per token lane.
// The block loops over the max(ceil(c0 / 128), 1) sealed windows; for each,
// it copies the 8 KB K and V [D, W] blocks (D = 64) into shared memory with
// 16-byte loads, computes the 128 logits (thread t owns token t), and folds
// them into a float32 online softmax.  Then it merges the exact ring slots
// g <= index % G and writes ctx in q's dtype.  On seal steps
// (index % G == G - 1) the same block quantizes its own (row, head) slice of
// the G ring columns (scale = absmax * float32(1/127), values rounded half
// to even) into window c0 / W, lanes [c0 % W, c0 % W + G).  Only this block
// touches that slice, and those lanes are >= c0, so this step's attention
// has them masked.
//
// Rounding follows the JAX kernel: with bfloat16 q the logits are
// (q . k) * (ks * scale) and the PV operand is bf16(p * vs); with float32 q
// the query is scaled first.  The seal's division x / scale and rintf must
// be IEEE (no --use_fast_math) so its bytes equal the plain PyTorch version's.
//
// What bounds it on an H100: bytes streamed from device memory, about
// 2 x 8 KB x windows per (row, head) per layer, plus scales and the ring.
// At cogview-base, batch 4 (160 blocks on 132 SMs) a step reads at most
// 9 windows, about 23 MB per layer.  This simple design leaves for later:
// overlapping the next window's loads with this one's math (cp.async or
// TMA), split-K over windows for small batches, tensor-core dots, and a
// layout with heads inside the window block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int W = 128;          // tokens per window == threads per block
constexpr float MASK_VALUE = -10000.0f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max and sum over 128 threads (4 warps); red holds 4 floats.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = (red[0] + red[1]) + (red[2] + red[3]);
  __syncthreads();
  return r;
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

template <typename T, bool BF16>
__global__ void __launch_bounds__(W)
decode_attention_int8_kernel(const T* __restrict__ q, const float* __restrict__ ring,
                             int8_t* __restrict__ kv, float* __restrict__ scales,
                             T* __restrict__ ctx, int B, int N, int D, int G, int index) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D_ = D;
  int8_t* ks8 = reinterpret_cast<int8_t*>(smem);            // [D, W]
  int8_t* vs8 = ks8 + D_ * W;                                // [D, W]
  float* qsh = reinterpret_cast<float*>(vs8 + D_ * W);       // [D] query (see below)
  float* pvs = qsh + D_;                                     // [W] PV operand
  float* part = pvs + W;                                     // [W] PV partial sums
  float* red = part + W;                                     // [4] reductions
  float* sg = red + 4;                                       // [G] ring logits

  const int tid = threadIdx.x;
  const int bn = blockIdx.x;                                 // row * N + head
  const int b = bn / N, n = bn - b * N;
  const int rem = index % G;
  const int c0 = index - rem;
  const int swl = max((c0 + W - 1) / W, 1);
  const float scale = 1.0f / sqrtf((float)D_);

  // q32 for the bf16 path (scale folds into the K scale), q32 * scale for
  // the float32 path, as the JAX kernel rounds
  for (int d = tid; d < D_; d += W) {
    float x = to_f32<T>(q[(size_t)bn * D_ + d]);
    qsh[d] = BF16 ? x : x * scale;
  }

  // PV partition: thread (dd, pp) sums tokens [pp * span, (pp + 1) * span)
  // for output dim dd
  const int P = W / D_;
  const int span = W / P;
  const int dd = tid % D_, pp = tid / D_;

  float m = -1e30f, l = 0.0f, acc = 0.0f;
  const size_t blk = (size_t)D_ * W;           // bytes of one [D, W] block
  const int nvec = (int)(blk / 16);
  for (int w = 0; w < swl; ++w) {
    const size_t kb = ((((size_t)w * B + b) * 2 + 0) * N + n) * blk;
    const size_t vb = ((((size_t)w * B + b) * 2 + 1) * N + n) * blk;
    const uint4* kg = reinterpret_cast<const uint4*>(kv + kb);
    const uint4* vg = reinterpret_cast<const uint4*>(kv + vb);
    __syncthreads();                           // previous window's smem reads done
    for (int i = tid; i < nvec; i += W) {
      reinterpret_cast<uint4*>(ks8)[i] = kg[i];
      reinterpret_cast<uint4*>(vs8)[i] = vg[i];
    }
    const size_t sb = (((size_t)w * B + b) * 2 * N + n) * W;
    const float ksc = scales[sb + tid];
    const float vsc = scales[sb + (size_t)N * W + tid];
    __syncthreads();

    float s = 0.0f;
    for (int d = 0; d < D_; ++d) s += qsh[d] * (float)ks8[d * W + tid];
    s = BF16 ? s * (ksc * scale) : s * ksc;
    const int kpos = w * W + tid;
    if (kpos >= c0) s = MASK_VALUE;

    const float m_new = fmaxf(m, block_max(s, red));
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + block_sum(p, red);
    float pv = p * vsc;
    if (BF16) pv = __bfloat162float(__float2bfloat16(pv));
    pvs[tid] = pv;
    __syncthreads();

    // rotate the start token by dd so the threads of a warp hit different
    // shared-memory banks
    float a = 0.0f;
    const int t0 = pp * span;
    for (int j = 0; j < span; ++j) {
      const int t = t0 + (j + 4 * dd) % span;
      a += pvs[t] * (float)vs8[dd * W + t];
    }
    acc = acc * alpha + a;
    m = m_new;
  }

  // ---- exact ring epilogue, float32: slots g <= rem hold positions c0 + g
  const float* rbase = ring + ((size_t)b * N + n) * 2 * D_;
  const size_t gstride = (size_t)B * N * 2 * D_;
  if (tid < G) {
    float x = 0.0f;
    const float* rk = rbase + (size_t)tid * gstride;
    for (int d = 0; d < D_; ++d) {
      const float qd = BF16 ? qsh[d] * scale : qsh[d];
      x += qd * rk[d];
    }
    sg[tid] = tid <= rem ? x : -1e30f;
  }
  part[tid] = acc;
  __syncthreads();

  if (tid < D_) {
    float m2 = m;
    for (int g = 0; g < G; ++g) m2 = fmaxf(m2, sg[g]);
    const float a2 = expf(m - m2);
    float l_e = l * a2;
    float tot = 0.0f;
    for (int k = 0; k < P; ++k) tot += part[k * D_ + tid];
    tot *= a2;
    for (int g = 0; g < G; ++g) {
      const float pg = expf(sg[g] - m2);
      l_e += pg;
      tot += pg * rbase[(size_t)g * gstride + D_ + tid];
    }
    ctx[(size_t)bn * D_ + tid] = from_f32<T>(tot / l_e);
  }

  // ---- seal: quantize the G ring columns of this (row, head) into window
  // c0 / W, lanes [c0 % W, c0 % W + G); thread (g, kv) owns one column
  if (rem == G - 1 && tid < 2 * G) {
    const int g = tid >> 1, t = tid & 1;
    const float* col = rbase + (size_t)g * gstride + t * D_;
    float amax = 0.0f;
    for (int d = 0; d < D_; ++d) amax = fmaxf(amax, fabsf(col[d]));
    // times float32(1/127), not / 127: the JAX seal compiles to this
    const float sc = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
    const int win = c0 / W, lane = c0 % W + g;
    int8_t* dst = kv + ((((size_t)win * B + b) * 2 + t) * N + n) * blk;
    for (int d = 0; d < D_; ++d) dst[(size_t)d * W + lane] = (int8_t)rintf(col[d] / sc);
    scales[((((size_t)win * B + b) * 2 + t) * N + n) * W + lane] = sc;
  }
}

template <typename T, bool BF16>
cudaError_t launch(const void* q, const float* ring, int8_t* kv, float* scales, void* ctx,
                   int B, int N, int D, int G, int index, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)D * W + sizeof(float) * (D + 2 * W + 4 + G);
  decode_attention_int8_kernel<T, BF16><<<B * N, W, smem, stream>>>(
      static_cast<const T*>(q), ring, kv, scales, static_cast<T*>(ctx), B, N, D, G, index);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_int8(const void* q, int q_is_bf16, const float* ring,
                                     int8_t* kv, float* scales, void* ctx, int B, int N,
                                     int D, int NW, int G, int index, void* stream) {
  (void)NW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = q_is_bf16
      ? launch<__nv_bfloat16, true>(q, ring, kv, scales, ctx, B, N, D, G, index, s)
      : launch<float, false>(q, ring, kv, scales, ctx, B, N, D, G, index, s);
  return (int)err;
}
