// Pieces shared by the attention forward and backward kernels.
//
// The replayed dropout mask is the JAX package's hash source
// (audio2photoreal_tpu/ops/pallas/flash.py:hash_mask_mult, reached through
// _kernel_dropout_mult): a uint32 xorshift-multiply mix of (seed, block id,
// row within the q-block, key column).  The TPU kernel numbers its cells
// block_id = (batch*H + head) * nj + q_block with q-blocks of bq rows, so
// element (b, h, i, j) reads hash(seed, (b*H + h)*nj + i / bq, i % bq, j)
// whatever tile size these kernels use.  It is computed per element in both
// passes and never stored.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_BIAS = -1e9f;  // masked key: the JAX package's additive -1e9

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dropout of the attention probabilities: on == 0 leaves them as they are.
// keep iff bits >= threshold (threshold = uint32(rate * 2^32)), and a kept
// probability is multiplied by mult = float32(1) / float32(1 - rate).
struct Dropout {
  int on;
  uint32_t seed;
  uint32_t threshold;
  float mult;
  int bq;  // q-block size of the mask numbering
  int nj;  // q-blocks per (batch, head): ceil(Tq / bq)
};

// The part of the hash that depends on the row only.
__device__ __forceinline__ uint32_t mask_row_term(const Dropout& d, int bh, int gq) {
  const uint32_t block = (uint32_t)bh * (uint32_t)d.nj + (uint32_t)(gq / d.bq);
  return d.seed * 2654435761u + block * 40503u + (uint32_t)(gq % d.bq) * 3266489917u;
}

// The multiplier of element (row term, key column gk): 0 or mult.
__device__ __forceinline__ float mask_mult(const Dropout& d, uint32_t row_term, int gk) {
  uint32_t h = row_term + (uint32_t)gk * 668265263u;
  h = (h ^ (h >> 13)) * 2654435761u;
  h = (h ^ (h >> 17)) * 668265263u;
  h ^= h >> 16;
  return h >= d.threshold ? d.mult : 0.f;
}

}  // namespace attn
