// The C entry points of a flash-attention library: included by each source
// that builds one (flash_attention.cu, flash_attention_*.cu) after its
// with_tile_width switch, which names the tile widths that library holds.
// Every function returns the cudaError_t of its launch as an int.
//
// head_dim: the real D, at most the tile width tile (ops/flash_attention.py
// tile_width); vec: the bytes of one global copy (16, 8 or 4, or 2 for
// bf16 by plain loads) that the operands' pointers, strides and D allow.
// A library built with EXACT_TILES takes only head_dim == tile with
// 16-byte copies, whose kernels fold D and vec to those constants (the
// code those widths always ran); the others take any call.

#pragma once

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int is_bf16, int B, int S, int N, int head_dim,
                                   int tile, int vec, long long q_sb, long long q_ss,
                                   long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                                   int sep, float scale, unsigned int seed, unsigned int threshold,
                                   float keep, int dropout, unsigned int b0, unsigned int n0,
                                   unsigned int Ng, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || B > 65535 || N > 65535 || head_dim < 1 ||
      head_dim > tile || !valid_copy(vec, is_bf16) ||
      (EXACT_TILES && (head_dim != tile || vec != 16)))
    return (int)cudaErrorInvalidValue;
  const Params p{q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, S, N, head_dim, vec, sep, scale, keep,
                 seed, threshold, b0, n0, Ng};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_tile_width(tile, [&](auto t) {
    constexpr int DT = decltype(t)::value;
    if (is_bf16)
      return dropout ? launch<__nv_bfloat16, DT, true, EXACT_TILES>(q, k, v, o, lse, B, p, s)
                     : launch<__nv_bfloat16, DT, false, EXACT_TILES>(q, k, v, o, lse, B, p, s);
    return dropout ? launch<float, DT, true, EXACT_TILES>(q, k, v, o, lse, B, p, s)
                   : launch<float, DT, false, EXACT_TILES>(q, k, v, o, lse, B, p, s);
  });
}

// dq pass (dq != null) or dk/dv pass (dk, dv != null); outputs contiguous
// [B, S, N, D] in the input dtype
static int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, void* dq, void* dk,
                               void* dv, int is_bf16, int B, int S, int N, int head_dim, int tile,
                               int vec, long long q_sb, long long q_ss, long long k_sb,
                               long long k_ss, long long v_sb, long long v_ss, long long o_sb,
                               long long o_ss, int sep, float scale, unsigned int seed,
                               unsigned int threshold, float keep, int dropout, unsigned int b0,
                               unsigned int n0, unsigned int Ng, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || B > 65535 || N > 65535 || head_dim < 1 ||
      head_dim > tile || !valid_copy(vec, is_bf16) ||
      (EXACT_TILES && (head_dim != tile || vec != 16)))
    return (int)cudaErrorInvalidValue;
  const BwdParams p{q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, S, N, head_dim, vec, sep,
                    scale, keep, seed, threshold, b0, n0, Ng};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)with_tile_width(tile, [&](auto t) {
    constexpr int DT = decltype(t)::value;
    using bf16 = __nv_bfloat16;
    constexpr bool X = EXACT_TILES;
    const auto run = [&](auto kernel) {
      return kernel(q, k, v, dout, lse, delta, dq, dk, dv, B, p, s);
    };
    if (is_bf16)
      return dropout ? run(launch_bwd<bf16, DT, true, X>) : run(launch_bwd<bf16, DT, false, X>);
    return dropout ? run(launch_bwd<float, DT, true, X>) : run(launch_bwd<float, DT, false, X>);
  });
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, int is_bf16, int B, int S, int N, int head_dim,
                                      int tile, int vec, long long q_sb, long long q_ss,
                                      long long k_sb, long long k_ss, long long v_sb,
                                      long long v_ss, long long o_sb, long long o_ss, int sep,
                                      float scale, unsigned int seed, unsigned int threshold,
                                      float keep, int dropout, unsigned int b0, unsigned int n0,
                                      unsigned int Ng, void* stream) {
  if (dq == nullptr) return (int)cudaErrorInvalidValue;
  return flash_attention_bwd(q, k, v, dout, lse, delta, dq, nullptr, nullptr, is_bf16, B, S, N,
                             head_dim, tile, vec, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
                             sep, scale, seed, threshold, keep, dropout, b0, n0, Ng, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int is_bf16, int B, int S, int N,
                                       int head_dim, int tile, int vec, long long q_sb,
                                       long long q_ss, long long k_sb, long long k_ss,
                                       long long v_sb, long long v_ss, long long o_sb,
                                       long long o_ss, int sep, float scale, unsigned int seed,
                                       unsigned int threshold, float keep, int dropout,
                                       unsigned int b0, unsigned int n0, unsigned int Ng,
                                       void* stream) {
  if (dk == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return flash_attention_bwd(q, k, v, dout, lse, delta, nullptr, dk, dv, is_bf16, B, S, N,
                             head_dim, tile, vec, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
                             sep, scale, seed, threshold, keep, dropout, b0, n0, Ng, stream);
}
