// Attention backward for Hopper (sm_90a), with the replayed dropout mask.
//
// Replaces the Pallas TPU kernel audio2photoreal_tpu/ops/pallas/flash.py
// (_attn_bwd_kernel, reached from _flash_bwd and the custom VJP of
// flash_attention): dQ, dK, dV of softmax(q k^T / sqrt(Dh) + bias) o M . v,
// where M is the forward's dropout multiplier (attn_common.cuh), recomputed
// here per element and never stored.
//
// The TPU kernel accumulates dK/dV across q-blocks into output blocks it
// revisits along its sequential grid axis.  Blocks here run in parallel and
// in no order, so that accumulation would be a race, or float atomics whose
// sum changes from run to run.  Instead one C call launches three kernels,
// each of which writes every output element exactly once:
//
//   1. delta: D[i] = sum_d dO[i,d] O[i,d], one warp per row.  This is the
//      TPU kernel's sum_j P o dP (flash.py:200): O is the dropped output, so
//      sum_j P_ij M_ij (dO_i . V_j) = dO_i . O_i.
//   2. dK/dV: one block per (batch*head, 64-key tile).  It loops over every
//      64-row q tile, recomputes P = exp(S - lse) with the forward's scale,
//      kv_valid bias and causal rule, and accumulates on chip
//      dV += (P o M)^T dO and dK += scale dS^T Q, dS = P o (dO V^T o M - D).
//   3. dQ: one block per (batch*head, 64-row q tile); loops over the key
//      tiles and accumulates dQ += scale dS K.
//
// The loops run in a fixed order, so two runs give bit-identical gradients.
// S and dP are recomputed in both kernels 2 and 3: 7 tile products per
// (q tile, key tile) against the forward's 2.  What bounds it on the card:
// 10*B*H*Tq*Tk*Dh flops (flash.py:266) against a few reads of q, k, v, dO,
// so arithmetic; this first version runs f32 FMAs on the CUDA cores (67
// TFLOP/s peak), like the forward, and keeps f32 accuracy.  Tensor cores,
// cp.async and TMA are later work.  Shared memory holds Q, dO, K, V tiles
// (rows padded by one float) and the [64, 64] P o M and dS tiles: 100 KB at
// Dh 64 and 166 KB at Dh 128, above the 48 KB default, so each kernel opts in.
//
// Plain C interface for ctypes; the caller owns every buffer and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"

namespace {

using attn::Dropout;
using attn::from_float;
using attn::NEG_BIAS;
using attn::to_float;

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 128;    // 16 row groups x 8 column lanes
constexpr int LANES = 8;        // threads that share one row group
constexpr int ROWS = 4;         // rows (q rows, or keys in the dK/dV sums) per thread
constexpr int KCOLS = BK / LANES;  // key columns per thread in the S / dP tile
constexpr int LDP = BK + 1;
constexpr int DELTA_THREADS = 256;

template <int D>
constexpr int smem_floats() {
  return 4 * 64 * (D + 1) + 2 * BQ * LDP + 2 * BQ;
}

// Stage rows r0 .. r0+63 of a [T, D] matrix into sX[64][D+1] as f32, times
// mul; rows past T are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* sX, const T* x, int r0, int T_, float mul) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D, g = r0 + r;
    sX[r * LD + c] = g < T_ ? to_float(x[(size_t)g * D + c]) * mul : 0.f;
  }
}

// The S and dP tile of a thread: rows row0 .. row0+3 of the q tile at q0, keys
// lane + 8j of the key tile at k0.  Writes P o M and dS into sP / sdS
// ([BQ][LDP], q-major).  sQ holds q * scale, sL the q rows' log-sum-exp, sD
// their delta; both are 0 for rows past Tq.
template <int D>
__device__ __forceinline__ void probs_and_ds(const float* sQ, const float* sdO, const float* sK,
                                             const float* sV, const float* sL, const float* sD,
                                             float* sP, float* sdS, const float* valid, int bh,
                                             int q0, int k0, int Tq, int Tk, int causal,
                                             const Dropout& drop) {
  constexpr int LD = D + 1;
  const int lane = threadIdx.x % LANES;
  const int row0 = (threadIdx.x / LANES) * ROWS;
  float s[ROWS][KCOLS], dp[ROWS][KCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < KCOLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[ROWS], gv[ROWS], kv[KCOLS], vv[KCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      qv[i] = sQ[(row0 + i) * LD + d];
      gv[i] = sdO[(row0 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < KCOLS; ++j) {
      kv[j] = sK[(lane + LANES * j) * LD + d];
      vv[j] = sV[(lane + LANES * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
  const int causal_off = Tk - Tq;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gq = q0 + row0 + i;
    const bool row_exists = gq < Tq;
    const uint32_t row_term = drop.on ? attn::mask_row_term(drop, bh, gq) : 0u;
    const float lse = sL[row0 + i], delta = sD[row0 + i];
#pragma unroll
    for (int j = 0; j < KCOLS; ++j) {
      const int gk = k0 + lane + LANES * j;
      float p = 0.f;
      if (row_exists && gk < Tk) {
        // the forward's logit, bit for bit: same products, same order
        float x = s[i][j] + ((valid != nullptr && !(valid[gk] > 0.f)) ? NEG_BIAS : 0.f);
        if (causal && gk > gq + causal_off) x = NEG_BIAS;
        p = expf(x - lse);
      }
      const float m = drop.on ? attn::mask_mult(drop, row_term, gk) : 1.f;
      sP[(row0 + i) * LDP + lane + LANES * j] = p * m;
      sdS[(row0 + i) * LDP + lane + LANES * j] = p * (dp[i][j] * m - delta);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DELTA_THREADS)
attn_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                      float* __restrict__ delta, int rows) {
  const int row = (int)((blockIdx.x * (size_t)DELTA_THREADS + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps: every lane of a warp has the same row
  const T* o = out + (size_t)row * D;
  const T* g = dout + (size_t)row * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(o[c]), to_float(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ kv_valid, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk, int causal,
                     float scale, Dropout drop) {
  constexpr int LD = D + 1;
  constexpr int OCOLS = D / LANES;
  extern __shared__ float smem[];
  float* sK = smem;             // [BK][LD]
  float* sV = sK + BK * LD;     // [BK][LD]
  float* sQ = sV + BK * LD;     // [BQ][LD], scale folded in
  float* sdO = sQ + BQ * LD;    // [BQ][LD]
  float* sP = sdO + BQ * LD;    // [BQ][LDP]  P o M
  float* sdS = sP + BQ * LDP;   // [BQ][LDP]  dS
  float* sL = sdS + BQ * LDP;   // [BQ]
  float* sD = sL + BQ;          // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * BK;
  const int lane = threadIdx.x % LANES;
  const int krow0 = (threadIdx.x / LANES) * ROWS;  // this thread's keys in the sums
  const T* qb = q + (size_t)bh * Tq * D;
  const T* ob = dout + (size_t)bh * Tq * D;
  const float* valid = kv_valid ? kv_valid + (size_t)b * Tk : nullptr;

  stage<T, D>(sK, k + (size_t)bh * Tk * D, k0, Tk, 1.f);
  stage<T, D>(sV, v + (size_t)bh * Tk * D, k0, Tk, 1.f);

  float dk_acc[ROWS][OCOLS], dv_acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the previous tile's reads are done (and sK/sV are staged)
    stage<T, D>(sQ, qb, q0, Tq, scale);
    stage<T, D>(sdO, ob, q0, Tq, 1.f);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const int gq = q0 + r;
      sL[r] = gq < Tq ? lse[(size_t)bh * Tq + gq] : 0.f;
      sD[r] = gq < Tq ? delta[(size_t)bh * Tq + gq] : 0.f;
    }
    __syncthreads();
    probs_and_ds<D>(sQ, sdO, sK, sV, sL, sD, sP, sdS, valid, bh, q0, k0, Tq, Tk, causal, drop);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float pv[ROWS], dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        pv[i] = sP[r * LDP + krow0 + i];
        dsv[i] = sdS[r * LDP + krow0 + i];
      }
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) {
        const float g = sdO[r * LD + lane + LANES * c];
        const float x = sQ[r * LD + lane + LANES * c];  // q * scale: dK takes the scale here
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          dv_acc[i][c] = fmaf(pv[i], g, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], x, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gk = k0 + krow0 + i;
    if (gk >= Tk) continue;
    T* dkr = dk + ((size_t)bh * Tk + gk) * D;
    T* dvr = dv + ((size_t)bh * Tk + gk) * D;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) {
      dkr[lane + LANES * c] = from_float<T>(dk_acc[i][c]);
      dvr[lane + LANES * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ kv_valid, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dq, int H, int Tq, int Tk, int causal, float scale,
                   Dropout drop) {
  constexpr int LD = D + 1;
  constexpr int OCOLS = D / LANES;
  extern __shared__ float smem[];
  float* sK = smem;             // [BK][LD]
  float* sV = sK + BK * LD;     // [BK][LD]
  float* sQ = sV + BK * LD;     // [BQ][LD], scale folded in
  float* sdO = sQ + BQ * LD;    // [BQ][LD]
  float* sP = sdO + BQ * LD;    // [BQ][LDP]  P o M (unused here)
  float* sdS = sP + BQ * LDP;   // [BQ][LDP]
  float* sL = sdS + BQ * LDP;   // [BQ]
  float* sD = sL + BQ;          // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x % LANES;
  const int row0 = (threadIdx.x / LANES) * ROWS;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const float* valid = kv_valid ? kv_valid + (size_t)b * Tk : nullptr;

  stage<T, D>(sQ, q + (size_t)bh * Tq * D, q0, Tq, scale);
  stage<T, D>(sdO, dout + (size_t)bh * Tq * D, q0, Tq, 1.f);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int gq = q0 + r;
    sL[r] = gq < Tq ? lse[(size_t)bh * Tq + gq] : 0.f;
    sD[r] = gq < Tq ? delta[(size_t)bh * Tq + gq] : 0.f;
  }

  float acc[ROWS][OCOLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done (and sQ/sdO/sL/sD are staged)
    stage<T, D>(sK, kb, k0, Tk, 1.f);
    stage<T, D>(sV, vb, k0, Tk, 1.f);
    __syncthreads();
    probs_and_ds<D>(sQ, sdO, sK, sV, sL, sD, sP, sdS, valid, bh, q0, k0, Tq, Tk, causal, drop);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = sdS[(row0 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c) {
        const float kx = sK[j * LD + lane + LANES * c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(dsv[i], kx, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gq = q0 + row0 + i;
    if (gq >= Tq) continue;
    T* r = dq + ((size_t)bh * Tq + gq) * D;
#pragma unroll
    for (int c = 0; c < OCOLS; ++c) r[lane + LANES * c] = from_float<T>(acc[i][c] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, const void* out,
           const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
           int H, int Tq, int Tk, int causal, const Dropout& drop, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* valid = static_cast<const float*>(kv_valid);
  const float scale = (float)(1.0 / sqrt((double)D));
  const int rows = B * H * Tq;
  const int delta_blocks = (int)(((size_t)rows * 32 + DELTA_THREADS - 1) / DELTA_THREADS);
  attn_bwd_delta_kernel<T, D><<<delta_blocks, DELTA_THREADS, 0, stream>>>(
      static_cast<const T*>(out), do_, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = sizeof(float) * smem_floats<D>();
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<T, D><<<dim3((Tk + BK - 1) / BK, B * H), THREADS, smem, stream>>>(
      q_, k_, v_, valid, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk,
      causal, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<T, D><<<dim3((Tq + BQ - 1) / BQ, B * H), THREADS, smem, stream>>>(
      q_, k_, v_, valid, do_, lse, delta, static_cast<T*>(dq), H, Tq, Tk, causal, scale, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// q/dq/out/dout [B,H,Tq,D], k/v/dk/dv [B,H,Tk,D], all contiguous and of one
// dtype (0 = float32, 1 = bfloat16); kv_valid [B,Tk] float32 or null; lse
// [B,H,Tq] float32 from the forward; delta [B,H,Tq] float32 scratch.  The
// dropout arguments are the forward's (attn_common.cuh).  Launches the delta,
// dK/dV and dQ kernels on the stream and returns a cudaError_t: 0 when all
// three launches were accepted.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* kv_valid,
                              const void* out, const void* dout, const void* lse, void* delta,
                              void* dq, void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
                              int dtype, int causal, int dropout, unsigned int seed,
                              unsigned int threshold, float mult, int bq, int nj, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (dropout && (bq < 1 || nj != (Tq + bq - 1) / bq)) return (int)cudaErrorInvalidValue;
  const Dropout drop{dropout, seed, threshold, mult, bq, nj};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, kv_valid, out, dout, l, dl, dq, dk, dv, B, H, Tq, Tk, causal,
                             drop, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, kv_valid, out, dout, l, dl, dq, dk, dv, B, H, Tq, Tk,
                              causal, drop, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, kv_valid, out, dout, l, dl, dq, dk, dv, B, H, Tq,
                                     Tk, causal, drop, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, kv_valid, out, dout, l, dl, dq, dk, dv, B, H, Tq,
                                      Tk, causal, drop, s);
  return (int)cudaErrorInvalidValue;
}
