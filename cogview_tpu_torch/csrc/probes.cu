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
// on Hopper there is one: a thread per 4 output lanes, the contraction only
// for the G lanes of the group.  Bound: the 414 KB of qc, oh and out.

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

__global__ void seal_scatter_kernel(const float* __restrict__ qc, const float* __restrict__ oh,
                                    const int* __restrict__ lane0_ptr, int8_t* __restrict__ out,
                                    int G, int rows, int width) {
  // thread i: output row i / (width / 4) (= h * Dc + d), lanes [l4, l4 + 4)
  const int quads = width / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * quads) return;
  const int row = (int)(i / quads);
  const int l4 = (int)(i % quads) * 4;
  const int lane0 = *lane0_ptr;
  char4 v = make_char4(0, 0, 0, 0);
  int8_t* vb = reinterpret_cast<int8_t*>(&v);
  for (int k = 0; k < 4; ++k) {
    const int l = l4 + k;
    if (l < lane0 || l >= lane0 + G) continue;
    float acc = 0.0f;
    for (int g = 0; g < G; ++g) acc += qc[(size_t)g * rows + row] * oh[(size_t)g * width + l];
    vb[k] = (int8_t)__float2int_rz(acc);
  }
  reinterpret_cast<char4*>(out + (size_t)row * width)[l4 / 4] = v;
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

// P2: the seal's lane scatter; qc [G, hb, Dc], oh [G, width], out [hb, Dc, width]
extern "C" int probe_seal_scatter(const float* qc, const float* oh, const int* lane0, int8_t* out,
                                  int G, int hb, int Dc, int width, void* stream) {
  const long long threads = (long long)hb * Dc * (width / 4);
  const int block = 128;
  const int grid = (int)((threads + block - 1) / block);
  seal_scatter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      qc, oh, lane0, out, G, hb * Dc, width);
  return (int)cudaGetLastError();
}
