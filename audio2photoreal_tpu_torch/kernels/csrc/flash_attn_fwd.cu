// Attention forward for Hopper (sm_90a), FlashAttention-2 style.
//
// Replaces the Pallas TPU kernel audio2photoreal_tpu/ops/pallas/flash.py
// (_attn_kernel, reached from _flash_fwd and flash_attention): softmax(q k^T
// / sqrt(Dh) + key-validity bias [+ causal]) v, with f32 logits and softmax
// statistics, and the division by the row sum done once on the output.
//
// The TPU kernel keeps one head's whole K/V resident in VMEM.  At Tk 2000
// that is 1 MB of f32 for Dh 128, against 227 KB of shared memory per block
// here, so this kernel streams K/V instead: one block owns one (batch*head,
// 64-row q tile), loops over 64-key K/V tiles staged in shared memory, and
// carries the running row max and row sum in f32 (online softmax) with the
// [64, Dh] accumulator in registers.  HBM sees q, k, v and the output once
// per q tile; the [Tq, Tk] logits never leave the SM.
//
// What bounds it on the card: at the denoiser's shapes (Tq 600, Tk 600 or
// 2000, Dh 64) the work is 4*Tq*Tk*Dh flops per head against 4*(Tq+2*Tk)*Dh
// bytes per q tile, far above the H100's ridge point, so the bound is
// arithmetic.  This first version does the products with f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), which keeps f32 inputs at f32 accuracy; bf16 inputs
// are widened to f32 on load.  The tensor-core version (mma/wgmma, TMA, warp
// specialisation) is later work.  Shared-memory rows of Q and K are padded by
// one float so the 8 lanes that share a row group read 8 distinct banks.
//
// Ragged Tq/Tk edges are masked in the kernel: rows past Tq are computed on
// zeros and not stored, keys past Tk get -inf (they do not exist), masked keys
// get the JAX package's -1e9 (kv_valid adds it, causal replaces the logit with
// it, as flash.py:_softmax_probs does).  There are no padded copies.
//
// Plain C interface for ctypes; the caller owns every buffer and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // q rows per block
constexpr int BK = 64;          // keys per K/V tile
constexpr int THREADS = 128;    // 16 row groups x 8 column lanes
constexpr int LANES = 8;        // threads that share one row group
constexpr int ROWS = 4;         // q rows per thread (16 groups x 4 = BQ)
constexpr int KCOLS = BK / LANES;  // key columns per thread
constexpr float NEG_BIAS = -1e9f;

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

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ kv_valid, T* __restrict__ out,
                int H, int Tq, int Tk, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  constexpr int OCOLS = D / LANES;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][LD], scale folded in
  float* sK = sQ + BQ * LD;    // [BK][LD]
  float* sV = sK + BK * LD;    // [BK][D]
  float* sP = sV + BK * D;     // [BQ][LDP] unnormalised probs of this tile

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;   // column lane: keys lane + 8*j, outputs lane + 8*c
  const int row0 = (tid / LANES) * ROWS;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const float* valid = kv_valid ? kv_valid + (size_t)b * Tk : nullptr;
  const int causal_off = Tk - Tq;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, gq = q0 + r;
    sQ[r * LD + c] = gq < Tq ? to_float(qb[(size_t)gq * D + c]) * scale : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done (and sQ is staged)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, gk = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (gk < Tk) {
        kx = to_float(kb[(size_t)gk * D + c]);
        vx = to_float(vb[(size_t)gk * D + c]);
      }
      sK[r * LD + c] = kx;
      sV[r * D + c] = vx;
    }
    __syncthreads();

    float s[ROWS][KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[KCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = sQ[(row0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = sK[(lane + LANES * j) * LD + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < KCOLS; ++j) {
      const int gk = k0 + lane + LANES * j;
      const bool exists = gk < Tk;
      const float bias = (valid != nullptr && exists && !(valid[gk] > 0.f)) ? NEG_BIAS : 0.f;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float x = s[i][j] + bias;
        if (causal && gk > q0 + row0 + i + causal_off) x = NEG_BIAS;
        s[i][j] = exists ? x : -INFINITY;
      }
    }

    // online softmax: the 8 lanes of a row group are adjacent in the warp
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KCOLS; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: every tile holds a real key
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) sP[(row0 + i) * LDP + lane + LANES * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = sP[(row0 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) {
        const float vv = sV[j * D + lane + LANES * c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gq = q0 + row0 + i;
    if (gq >= Tq) continue;
    const float inv = 1.f / l[i];
    T* o = out + ((size_t)bh * Tq + gq) * D;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) o[lane + LANES * c] = from_float<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, void* out,
           int B, int H, int Tq, int Tk, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  const float scale = (float)(1.0 / sqrt((double)D));
  attn_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(kv_valid), static_cast<T*>(out), H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B,H,Tq,D], k/v [B,H,Tk,D], out [B,H,Tq,D], all contiguous and of one
// dtype (0 = float32, 1 = bfloat16); kv_valid [B,Tk] float32 or null.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* kv_valid, void* out, int B, int H, int Tq,
                              int Tk, int D, int dtype, int causal, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<float, 64>(q, k, v, kv_valid, out, B, H, Tq, Tk, causal, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(q, k, v, kv_valid, out, B, H, Tq, Tk, causal, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, kv_valid, out, B, H, Tq, Tk, causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, kv_valid, out, B, H, Tq, Tk, causal, s);
  return (int)cudaErrorInvalidValue;
}
