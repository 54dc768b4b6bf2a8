// The decode kernels' measurement probes, for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas kernels of the JAX package's probe scripts:
//   probe_add_one            scripts/pallas_launch_probe.py::tiny_kernel (P1a)
//   probe_decode_convention  scripts/pallas_launch_probe.py::conv_kernel (P1b)
//   probe_seal_scatter       scripts/seal_scatter_probe.py::make.kernel (P2)
// Each is small on purpose: what the scripts measure with them is the cost of
// a launch, of the decode kernel's calling convention, and of the seal's lane
// scatter, not a roofline.
//
// P1a: o = x + 1.0 over n float32 values.  Each thread does one 16-byte load
// and one 16-byte store, no loop, over a grid that covers n: 256 threads in
// one block and one round trip at [8, 128].  A scalar path (one value a
// thread) takes x or o off a 16-byte boundary, and the n % 4 tail.  Its bound
// is nanoseconds (8 KB at [8, 128]); its time is the launch floor.
//
// P1b: the decode kernel's argument list (decode_attention_int8 in
// decode_attention.cu: q, q_is_bf16, ring, one layer's kv and scales views,
// ctx, B, N, D, NW, G, index, stream) with one window's copy in place of the
// attention.  q is bfloat16, as in the probe and the decode step it stands
// for; q_is_bf16 = 0 is refused.  Rows [0, 2) x {K, V} x heads [0, N) of window 0 are the first
// 4 N [D, W] int8 blocks of the layer view [NW, B, 2, N, D, W], and their
// scale rows the first 4 N rows of [NW, B, 2, N, W]: one contiguous range
// each.  Block i of 4 N issues the cp.async copy (LDGSTS, asynchronous copies
// the compiler cannot drop) of [D, W] block i and its scale row into shared
// memory, then, while the copy is in flight, loads its share of q with
// 16-byte loads and reads scales[0]; only then does it wait, and it writes
// its share of ctx = T(q + T(scales[0])) with 16-byte stores, the JAX
// kernel's o = q + bf16(sum(sbuf[0, 0, 0, :1])): one DRAM round trip before
// the stores where the copy and the q loads used to run in series.  Block 0
// takes the scale from its copied sbuf[0].  q or ctx off a 16-byte boundary,
// or B N D not a multiple of 8, takes a scalar path.  At cogview-base width
// and batch 40 the copy is 1.31 MB of int8 and 80 KB of scales, q and ctx
// 410 KB: about 0.54 us at 3.35 TB/s.
//
// P2: out[h, d, l] = int8(sum_g qc[g, h, d] * oh[g, l]) for lanes
// lane0 <= l < lane0 + G and 0 elsewhere ([hb, Dc, W] int8), lane0 read from
// a device int32 so a captured CUDA graph can replay the call.  The float to
// int8 conversion truncates toward zero, as torch's .to(torch.int8) and XLA's
// convert do on in-range values.  The TPU probe compared five Mosaic
// lowerings of this one function (accum, bigsum, batched, fused2d, serial);
// on Hopper there is one.  Its bound is the 414 KB of qc, oh and out
// (0.12 us), far below the card's ~1 us floor for a launch that reads
// memory, so the design aims at that floor: one DRAM round trip.  A thread
// owns 16 output lanes of one row and writes them with one 16-byte store
// (20,480 threads at [40, 64, 128], 32-bit index arithmetic).  No load waits
// on lane0: each block's cp.async copy of oh ([G, W], 4 KB) into shared
// memory, lane0 and the row's G qc values are all in flight together.  A
// chunk that misses [lane0, lane0 + G) stores its zeros as soon as lane0
// arrives; the at most two chunks of a row that meet the group compute
// their lanes 4 at a time, the at most three fours that meet it (G x 4
// FMAs each, oh read from shared memory), and mask them in registers.
// Two versions lost on an H100 (1.72 us of device time): computing every
// chunk, 3.5 us (8 threads of a row read oh words 64 bytes apart, 4-way
// bank conflicts by their addresses); staging oh by plain loads and shared
// stores in place of cp.async, 1.79 us.  G is the seal group, 8.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int W = 128;  // tokens per cache window == threads of a P1b block

constexpr int ADD_ONE_BLOCK = 256;

// VEC: thread i adds one to the float4 i, and the threads past n / 4 to the
// n % 4 values of the tail; otherwise thread i to value i
template <bool VEC>
__global__ void __launch_bounds__(ADD_ONE_BLOCK)
add_one_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * ADD_ONE_BLOCK + threadIdx.x;
  const int n4 = VEC ? n / 4 : 0;
  if (VEC && i < n4) {
    float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    reinterpret_cast<float4*>(o)[i] = v;
    return;
  }
  const int j = 4 * n4 + (i - n4);
  if (j < n) o[j] = __ldg(x + j) + 1.0f;
}

// 8 bf16 values through one 16-byte word: ctx = T(q + add), rounded once
__device__ __forceinline__ uint4 add_bf16x8(uint4 v, float add) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    h[k] = __floats2bfloat162_rn(f.x + add, f.y + add);
  }
  return v;
}

// vec: q and ctx 16-byte aligned and total a multiple of 8, moved 8 values
// (16 bytes) at a time; otherwise one value at a time
__global__ void __launch_bounds__(W)
decode_convention_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kv,
                         const float* __restrict__ scales, __nv_bfloat16* __restrict__ ctx,
                         int total, int D, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* buf = reinterpret_cast<int8_t*>(smem);            // [D, W]
  float* sbuf = reinterpret_cast<float*>(buf + D * W);       // [W]
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;                                // (row * 2 + kv) * N + head

  // 1. issue the window's copy and its scale row
  const int8_t* src = kv + (size_t)blk * D * W;
  for (int i = tid; i < D * W / 16; i += W)
    __pipeline_memcpy_async(buf + 16 * i, src + 16 * i, 16);
  const float* ssrc = scales + (size_t)blk * W;
  if (tid < W / 4) __pipeline_memcpy_async(sbuf + 4 * tid, ssrc + 4 * tid, 16);
  __pipeline_commit();

  // 2. while it is in flight: this block's share of q (units of 8 values on
  // the vector path) and, for every block but 0, scales[0] through L2
  const int units = vec ? total / 8 : total;
  const int chunk = (units + gridDim.x - 1) / gridDim.x;
  const int end = min(units, (blk + 1) * chunk);
  int i = blk * chunk + tid;
  uint4 qv = make_uint4(0, 0, 0, 0);
  float qs = 0.0f;
  if (i < end) {
    if (vec) qv = __ldg(reinterpret_cast<const uint4*>(q) + i);
    else qs = __bfloat162float(q[i]);
  }
  const float s_l2 = blk == 0 ? 0.0f : __ldg(scales);

  // 3. wait for the copy; block 0 reads the scale from it
  __pipeline_wait_prior(0);
  __syncthreads();
  const float add = __bfloat162float(__float2bfloat16(blk == 0 ? sbuf[0] : s_l2));

  // 4. ctx, and any units past the first W of a block's share (none at
  // cogview-base width, where a block's share is 80 units)
  for (bool first = true; i < end; i += W, first = false) {
    if (vec) {
      if (!first) qv = __ldg(reinterpret_cast<const uint4*>(q) + i);
      reinterpret_cast<uint4*>(ctx)[i] = add_bf16x8(qv, add);
    } else {
      if (!first) qs = __bfloat162float(q[i]);
      ctx[i] = __float2bfloat16(qs + add);
    }
  }
}

constexpr int SEAL_G = 8;         // the seal group: columns sealed at once
constexpr int SEAL_BLOCK = 128;   // threads of a P2 block
constexpr int SEAL_LANES = 16;    // output lanes (bytes) a thread owns

// thread i: output row i / (width / 16) (= h * Dc + d), lanes [l16, l16 + 16)
__global__ void __launch_bounds__(SEAL_BLOCK)
seal_scatter_kernel(const float* __restrict__ qc, const float* __restrict__ oh,
                    const int* __restrict__ lane0_ptr, int8_t* __restrict__ out, int rows,
                    int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ohs = reinterpret_cast<float*>(smem);  // [SEAL_G, width]
  const int tid = threadIdx.x;
  const int chunks = width / SEAL_LANES;
  const int i = blockIdx.x * SEAL_BLOCK + tid;
  const bool live = i < rows * chunks;
  const int row = i / chunks;
  const int l16 = (i - row * chunks) * SEAL_LANES;

  // 1. every load at once: oh into shared memory, lane0, the row's qc
  for (int j = tid; j < SEAL_G * width / 4; j += SEAL_BLOCK)
    __pipeline_memcpy_async(ohs + 4 * j, oh + 4 * j, 16);
  __pipeline_commit();
  const int lane0 = __ldg(lane0_ptr);
  float q[SEAL_G];
#pragma unroll
  for (int g = 0; g < SEAL_G; ++g) q[g] = live ? __ldg(qc + g * rows + row) : 0.0f;

  // 2. a chunk that misses the group stores its zeros at once; at most two
  // chunks of a row meet it
  const bool meets = live && l16 < lane0 + SEAL_G && l16 + SEAL_LANES > lane0;
  uint4* dst = reinterpret_cast<uint4*>(out) + i;
  if (live && !meets) *dst = make_uint4(0u, 0u, 0u, 0u);
  __pipeline_wait_prior(0);
  __syncthreads();
  if (!meets) return;

  // 3. the contractions of the chunk's lanes in groups of 4 that meet the
  // group (the chunk's threads of a warp read the same oh words, a
  // broadcast), truncated, masked to the group, packed
  uint32_t packed[SEAL_LANES / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k4 = 0; k4 < SEAL_LANES / 4; ++k4) {
    if (l16 + 4 * k4 + 4 <= lane0 || l16 + 4 * k4 >= lane0 + SEAL_G) continue;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int g = 0; g < SEAL_G; ++g) {
      const float4 o = *reinterpret_cast<const float4*>(ohs + g * width + l16 + 4 * k4);
      acc.x += q[g] * o.x;
      acc.y += q[g] * o.y;
      acc.z += q[g] * o.z;
      acc.w += q[g] * o.w;
    }
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = l16 + 4 * k4 + k;
      const bool in_group = l >= lane0 && l < lane0 + SEAL_G;
      const uint32_t b = in_group ? (uint32_t)(uint8_t)(int8_t)__float2int_rz(a[k]) : 0u;
      packed[k4] |= b << (8 * k);
    }
  }
  *dst = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// P1a: o = x + 1.0 over n float32 values; a thread per 16 bytes when x and o
// are 16-byte aligned, else a thread per value
extern "C" int probe_add_one(const float* x, float* o, int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(x) && aligned16(o);
  const int threads = vec ? n / 4 + n % 4 : n;
  const int grid = threads > 0 ? (threads + ADD_ONE_BLOCK - 1) / ADD_ONE_BLOCK : 1;
  if (vec) add_one_kernel<true><<<grid, ADD_ONE_BLOCK, 0, s>>>(x, o, n);
  else add_one_kernel<false><<<grid, ADD_ONE_BLOCK, 0, s>>>(x, o, n);
  return (int)cudaGetLastError();
}

// P1b: K1's argument list; ring, NW, G and index are taken and not read, and
// a float32 q (q_is_bf16 = 0) is refused
extern "C" int probe_decode_convention(const void* q, int q_is_bf16, const float* ring,
                                       const int8_t* kv, const float* scales, void* ctx, int B,
                                       int N, int D, int NW, int G, int index, void* stream) {
  (void)ring;
  (void)NW;
  (void)G;
  (void)index;
  if (!q_is_bf16) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)D * W + W * sizeof(float);
  const int total = B * N * D;
  const bool vec = aligned16(q) && aligned16(ctx) && total % 8 == 0;
  decode_convention_kernel<<<2 * 2 * N, W, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), kv, scales, static_cast<__nv_bfloat16*>(ctx),
      total, D, vec);
  return (int)cudaGetLastError();
}

// P2: the seal's lane scatter; qc [G, hb, Dc], oh [G, width], out
// [hb, Dc, width]; G must be the seal group (8), width a multiple of 16, oh
// and out 16-byte aligned
extern "C" int probe_seal_scatter(const float* qc, const float* oh, const int* lane0, int8_t* out,
                                  int G, int hb, int Dc, int width, void* stream) {
  if (G != SEAL_G || width % SEAL_LANES || !aligned16(oh) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int threads = hb * Dc * (width / SEAL_LANES);
  const int grid = threads > 0 ? (threads + SEAL_BLOCK - 1) / SEAL_BLOCK : 1;
  const size_t smem = (size_t)SEAL_G * width * sizeof(float);
  seal_scatter_kernel<<<grid, SEAL_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      qc, oh, lane0, out, hb * Dc, width);
  return (int)cudaGetLastError();
}
