// Attention backward for Hopper (sm_90a) on the tensor cores, with the
// replayed dropout mask.
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
//   2. dK/dV and dQ partials: one block per (batch*head, key block), 16 keys
//      per warp.  It loops over the q tiles and works on the transposed
//      tile: S^T = K Q^T and dP^T = V dO^T, then P^T = exp(S^T - lse) with
//      the forward's scale, kv_valid bias and causal rule, and accumulates in
//      registers dV += (P o M)^T dO and dK += dS^T Q, dS = P o (dP o M - D).
//      A row whose every key is masked has its lse near -1e9, where f32
//      holds only multiples of 64, so exp(x - lse) cannot be formed there;
//      the forward averaged such a row uniformly over the Tk keys, and so P
//      is 1/Tk for each key that exists, as in the bf16 backward.
//      With the keys as rows, each of those products' A operand is a K/V
//      tile or an accumulator already in registers.  The block then writes
//      dS^T to shared memory and forms this key block's share of dQ, dS K,
//      for the q tile (the warps split its rows and columns), into a
//      [key blocks, B, H, Tq, Dh] f32 scratch.
//   3. dQ: scale times the sum of the key blocks' partials, in key-block
//      order, one thread per 4 elements.
//
// S, dP and P are computed once per (q tile, key tile): 5 tile products, the
// minimum, against 7 when a separate dQ kernel recomputed them.  The
// scratch costs a write and a read of 4 * ceil(Tk / block keys) * B*H*Tq*Dh
// bytes (314 MB at the trainer's B64 Tk 2000 Dh 64, 0.19 ms of HBM time).
// The loops and the partials' sum run in a fixed order and nothing is
// accumulated by atomics, so two runs give bit-identical gradients.
//
// This is the f32 kernel; bf16 inputs take flash_attn_bwd_bf16.cu.
//
// What bounds it on the card: 10*B*H*Tq*Tk*Dh flops (flash.py:266) against
// a few reads of q, k, v, dO and the scratch: arithmetic.  Every product
// runs on the tensor cores as mma.sync m16n8k8 TF32 in 3xTF32, for f32
// accuracy (attn_common.cuh; why not wgmma: flash_attn_fwd.cu).  The
// streamed Q and dO tiles come through a two-stage cp.async ring, so the
// next tile's copy overlaps this tile's products; dS^T takes the current
// stage's buffer once its products are done.  At Dh 64 a block is 4 warps,
// 64 keys against 32-row q tiles (70 KB of f32, registers capped at 168:
// three blocks per SM); at Dh 128 it is 8 warps, 128 keys against 16-row q
// tiles (169 KB: one block of 8 warps per SM).  The fastest of the variants
// tools/torch_attn_tune.py measured on the H100.
//
// q, k, v, the forward's output and dO are strided [B, H, T, Dh] views (Dh
// contiguous); the gradients are written through their own strides.
//
// Plain C interface for ctypes; the caller owns every buffer and the stream.

#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"

namespace {

using attn::Dropout;
using attn::FragA;
using attn::FragB;
using attn::Mat;
using attn::NEG_BIAS;

constexpr int DELTA_THREADS = 256;

using T = float;

template <int D>
struct Cfg {
  static constexpr int WARPS = D == 128 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  // occupancy and streamed tile: the best of the variants timed (PERF.md, tools/torch_attn_tune.py)
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 3;  // resident blocks per SM the registers must allow
  static constexpr int RES = 16 * WARPS;               // resident rows: keys (kernel 2), q rows (3)
  static constexpr int STR = D == 128 ? 16 : 32;       // rows of a streamed tile
  static constexpr int LDS = D + 16 / (int)sizeof(T);
  static constexpr size_t RES_BYTES = sizeof(T) * 2 * RES * LDS;  // K and V, or Q and dO
  static constexpr size_t STAGE_BYTES = sizeof(T) * 2 * STR * LDS;
  static constexpr size_t VEC_BYTES = sizeof(float) * 3 * STR;    // lse, delta, row term
  // dS^T [RES keys][LDP] f32, in the current stage's Q/dO buffer once its
  // products are done
  static constexpr int LDP = STR + 4;
  static constexpr size_t DS_BYTES = sizeof(float) * RES * LDP;
  static_assert(DS_BYTES <= STAGE_BYTES, "dS^T fits a stage");
  static constexpr size_t DKDV_SMEM = RES_BYTES + 2 * (STAGE_BYTES + VEC_BYTES);
  // the dQ partial of a q tile: STR / 16 m-tiles x D / 8 n-tiles shared by the warps
  static constexpr int MQ = STR / 16, NDW = (D / 8) * MQ / WARPS;
  static_assert(WARPS % MQ == 0 && NDW * WARPS == (D / 8) * MQ, "dQ partial tiles share out");
};

struct BwdArgs {
  Mat<const T> q, k, v, dout;
  Mat<T> dq, dk, dv;
  const float* kv_valid;  // [B, Tk] or null
  const float* lse;       // [B, H, Tq]
  const float* delta;     // [B, H, Tq]
  float* dq_part;         // [ceil(Tk / block keys), B*H, Tq, Dh]
  int H, Tq, Tk, causal;
  float scale;
  Dropout drop;
};

__device__ __forceinline__ void store2(T* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}

template <int D>
__global__ void __launch_bounds__(DELTA_THREADS)
attn_bwd_delta_kernel(Mat<const T> out, Mat<const T> dout, float* __restrict__ delta, int H,
                      int Tq, int rows) {
  const int row = (int)((blockIdx.x * (size_t)DELTA_THREADS + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps: every lane of a warp has the same row
  const int bh = row / Tq, i = row % Tq, b = bh / H, h = bh % H;
  const T* o = out.head(b, h) + (long long)i * out.st;
  const T* g = dout.head(b, h) + (long long)i * dout.st;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(o[c], g[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
attn_bwd_dkdv_kernel(BwdArgs a) {
  using C = Cfg<D>;
  constexpr int THREADS = C::THREADS, KB = C::RES, QB = C::STR, LDS = C::LDS, LDP = C::LDP;
  constexpr int NQ = QB / 8, ND = D / 8, NDW = C::NDW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);  // [KB][LDS]
  T* sV = sK + KB * LDS;                // [KB][LDS]
  T* sRing = sV + KB * LDS;             // stage s: Q at 2s, dO at 2s + 1, [QB][LDS] each
  float* sVec = reinterpret_cast<float*>(smem + C::RES_BYTES + 2 * C::STAGE_BYTES);  // stage s: [3][QB]

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * KB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp * 16;  // this warp's first key in the tile
  const T* qh = a.q.head(b, h);
  const T* oh = a.dout.head(b, h);
  const float* valid = a.kv_valid ? a.kv_valid + (size_t)b * a.Tk : nullptr;
  const int causal_off = a.Tk - a.Tq;
  const int n_qt = (a.Tq + QB - 1) / QB;
  const float inv_tk = 1.f / a.Tk;

  auto load_q = [&](int qt, int stage) {
    T* sQ = sRing + (2 * stage) * QB * LDS;
    attn::load_tile<T, D, LDS, QB, THREADS>(sQ, qh, a.q.st, qt * QB, a.Tq);
    attn::load_tile<T, D, LDS, QB, THREADS>(sQ + QB * LDS, oh, a.dout.st, qt * QB, a.Tq);
    float* v = sVec + stage * 3 * QB;
    for (int i = threadIdx.x; i < QB; i += THREADS) {
      const int gq = qt * QB + i;
      const bool ok = gq < a.Tq;
      v[i] = ok ? a.lse[(size_t)bh * a.Tq + gq] : 0.f;
      v[QB + i] = ok ? a.delta[(size_t)bh * a.Tq + gq] : 0.f;
      reinterpret_cast<uint32_t*>(v)[2 * QB + i] =
          (ok && a.drop.on) ? attn::mask_row_term(a.drop, bh, gq) : 0u;
    }
  };
  attn::load_tile<T, D, LDS, KB, THREADS>(sK, a.k.head(b, h), a.k.st, k0, a.Tk);
  attn::load_tile<T, D, LDS, KB, THREADS>(sV, a.v.head(b, h), a.v.st, k0, a.Tk);
  load_q(0, 0);
  attn::cp_async_commit();

  // this thread's keys: k0 + wr + g + 8r
  bool key_ok[2];
  float key_bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gk = k0 + wr + g + 8 * r;
    key_ok[r] = gk < a.Tk;
    key_bias[r] = (valid != nullptr && key_ok[r] && !(valid[gk] > 0.f)) ? NEG_BIAS : 0.f;
  }
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  for (int qt = 0; qt < n_qt; ++qt) {
    const int stage = qt & 1;
    if (qt + 1 < n_qt) {
      load_q(qt + 1, stage ^ 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const T* sQ = sRing + (2 * stage) * QB * LDS;
    const T* sdO = sQ + QB * LDS;
    const float* sL = sVec + stage * 3 * QB;
    const float* sD = sL + QB;
    const uint32_t* sRT = reinterpret_cast<const uint32_t*>(sL + 2 * QB);

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and QB q rows
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) {
      FragA fk, fv;
      attn::load_a<LDS>(fk, sK, wr, ks * 8, g, t);
      attn::load_a<LDS>(fv, sV, wr, ks * 8, g, t);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        FragB fq, fo;
        attn::load_b_nk<LDS>(fq, sQ, j * 8, ks * 8, g, t);
        attn::mma(st[j], fk, fq);
        attn::load_b_nk<LDS>(fo, sdO, j * 8, ks * 8, g, t);
        attn::mma(dpt[j], fv, fo);
      }
    }

    // element (r, e) of n-tile j: key k0 + wr + g + 8r, q row qt*QB + 8j + 2t + e
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e, gq = qt * QB + c;
        const bool q_ok = gq < a.Tq;
        const float lse = sL[c], delta = sD[c];
        const uint32_t rt = sRT[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int gk = k0 + wr + g + 8 * r;
          float p = 0.f;
          if (q_ok && key_ok[r]) {
            float x = st[j][2 * r + e] * a.scale + key_bias[r];
            if (a.causal && gk > gq + causal_off) x = NEG_BIAS;
            p = lse < 0.5f * NEG_BIAS ? inv_tk : attn::exp_fast(x - lse);  // a fully masked row
          }
          const float mm = a.drop.on ? attn::mask_mult(a.drop, rt, gk) : 1.f;
          st[j][2 * r + e] = p * mm;                              // (P o M)^T
          dpt[j][2 * r + e] = p * (dpt[j][2 * r + e] * mm - delta);  // dS^T
        }
      }

    // dV += (P o M)^T dO, dK += dS^T Q (the scale once, at the end)
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      FragA fp, fs;
      attn::a_from_c(fp, st[kk]);
      attn::a_from_c(fs, dpt[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        FragB fo, fq;
        attn::load_b_kn<LDS>(fo, sdO, kk * 8, n * 8, g, t);
        attn::mma_sum(dv[n], fp, fo);
        attn::load_b_kn<LDS>(fq, sQ, kk * 8, n * 8, g, t);
        attn::mma_sum(dk[n], fs, fq);
      }
    }
    __syncthreads();  // every warp is done with this stage's Q and dO

    // dS^T into the stage's buffer: key rows, q columns
    float* sdS = reinterpret_cast<float*>(sRing + (2 * stage) * QB * LDS);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(sdS + (wr + g + 8 * r) * LDP + 8 * j + 2 * t) =
            make_float2(dpt[j][2 * r], dpt[j][2 * r + 1]);
    __syncthreads();

    // this key block's dQ partial for the q tile, dS K over the block's KB
    // keys: warp w takes q m-tile w % MQ and n-tiles NDW (w / MQ) .. +NDW
    {
      const int mq = (warp % C::MQ) * 16, n0 = (warp / C::MQ) * NDW;
      float acc[NDW][4];
#pragma unroll
      for (int n = 0; n < NDW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KB / 8; ++ks) {
        // A[q][key] = dS^T[key][q], the keys of the step in a_from_c's order
        const float* p = sdS + (ks * 8 + 2 * t) * LDP + mq + g;
        FragA fs;
        attn::split_a(fs, p[0], p[8], p[LDP], p[LDP + 8]);
#pragma unroll
        for (int n = 0; n < NDW; ++n) {
          FragB fk;
          attn::load_b_kn<LDS>(fk, sK, ks * 8, (n0 + n) * 8, g, t);
          attn::mma_sum(acc[n], fs, fk);
        }
      }
      float* part = a.dq_part + (((size_t)blockIdx.x * gridDim.y + bh) * a.Tq) * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int gq = qt * QB + mq + g + 8 * r;
        if (gq >= a.Tq) continue;
#pragma unroll
        for (int n = 0; n < NDW; ++n)
          *reinterpret_cast<float2*>(part + (size_t)gq * D + (n0 + n) * 8 + 2 * t) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
    __syncthreads();  // this stage is read: the next iteration may refill it
  }

  T* dkh = a.dk.head(b, h);
  T* dvh = a.dv.head(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gk = k0 + wr + g + 8 * r;
    if (!key_ok[r]) continue;
    T* pk = dkh + (long long)gk * a.dk.st + 2 * t;
    T* pv = dvh + (long long)gk * a.dv.st + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      store2(pk + n * 8, dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      store2(pv + n * 8, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// dQ = scale * the sum of the key blocks' partials, in block order: one
// thread per 4 elements of a row.
template <int D>
__global__ void __launch_bounds__(DELTA_THREADS)
attn_bwd_dq_kernel(const float* __restrict__ part, Mat<T> dq, int H, int Tq, int rows, int n_kb,
                   float scale) {
  constexpr int C4 = D / 4;
  const size_t i = blockIdx.x * (size_t)DELTA_THREADS + threadIdx.x;
  if (i >= (size_t)rows * C4) return;
  const int row = (int)(i / C4), c = (int)(i % C4) * 4;  // row = (b*H + h)*Tq + q
  const float* p = part + (size_t)row * D + c;
  float4 sum = *reinterpret_cast<const float4*>(p);
  for (int kb = 1; kb < n_kb; ++kb) {
    const float4 x = *reinterpret_cast<const float4*>(p + (size_t)kb * rows * D);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  const int bh = row / Tq, q = row % Tq;
  T* o = dq.head(bh / H, bh % H) + (long long)q * dq.st + c;
  store2(o, sum.x * scale, sum.y * scale);
  store2(o + 2, sum.z * scale, sum.w * scale);
}

template <int D>
attn::Prepared prepared() {
  using C = Cfg<D>;
  static attn::PreparedCache cache;
  return attn::prepare(cache, attn_bwd_dkdv_kernel<D>, C::THREADS, C::DKDV_SMEM);
}

template <int D>
long long scratch_floats(int B, int H, int Tq, int Tk) {
  return (long long)((Tk + Cfg<D>::RES - 1) / Cfg<D>::RES) * B * H * Tq * D;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, const void* out,
           const void* dout, const float* lse, float* delta, float* dq_part, void* dq, void* dk,
           void* dv, const long long* strides, int B, int H, int Tq, int Tk, int causal,
           const Dropout& drop, cudaStream_t stream) {
  using C = Cfg<D>;
  const attn::Prepared p = prepared<D>();
  if (p.err != cudaSuccess) return (int)p.err;
  const int rows = B * H * Tq;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int delta_blocks = (int)(((size_t)rows * 32 + DELTA_THREADS - 1) / DELTA_THREADS);
  attn_bwd_delta_kernel<D><<<delta_blocks, DELTA_THREADS, 0, stream>>>(
      attn::make_cmat<T>(out, strides + 9), attn::make_cmat<T>(dout, strides + 12), delta, H, Tq,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_kb = (Tk + C::RES - 1) / C::RES;
  BwdArgs a{attn::make_cmat<T>(q, strides),      attn::make_cmat<T>(k, strides + 3),
               attn::make_cmat<T>(v, strides + 6),  attn::make_cmat<T>(dout, strides + 12),
               attn::make_mat<T>(dq, strides + 15), attn::make_mat<T>(dk, strides + 18),
               attn::make_mat<T>(dv, strides + 21), static_cast<const float*>(kv_valid),
               lse,                                 delta,
               dq_part,                             H,
               Tq,                                  Tk,
               causal,                              scale,
               drop};
  attn_bwd_dkdv_kernel<D><<<dim3(n_kb, B * H), C::THREADS, C::DKDV_SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int dq_blocks = (int)(((size_t)rows * (D / 4) + DELTA_THREADS - 1) / DELTA_THREADS);
  attn_bwd_dq_kernel<D><<<dq_blocks, DELTA_THREADS, 0, stream>>>(dq_part, a.dq, H, Tq, rows, n_kb,
                                                                     scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of f32 scratch the backward needs for its dQ partials: one
// [B, H, Tq, D] plane per key block; -1 for a shape it does not take.
extern "C" long long flash_attn_bwd_scratch_floats(int B, int H, int Tq, int Tk, int D) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1) return -1;
  if (D == 64) return scratch_floats<64>(B, H, Tq, Tk);
  if (D == 128) return scratch_floats<128>(B, H, Tq, Tk);
  return -1;
}

// q/dq/out/dout [B,H,Tq,D], k/v/dk/dv [B,H,Tk,D], float32, each a strided view: strides[3*i .. 3*i+2] are the
// batch, head and time strides in elements of q, k, v, out, dout, dq, dk, dv
// (i = 0..7), the D axis contiguous, every row on 16 bytes.  kv_valid [B,Tk]
// float32 or null; lse [B,H,Tq] float32 from the forward; delta [B,H,Tq]
// float32 scratch; dq_part f32 scratch of flash_attn_bwd_scratch_floats
// floats.  The dropout arguments are the forward's (attn_common.cuh).
// Launches the delta, dK/dV and dQ kernels on the stream and returns a
// cudaError_t: 0 when all three launches were accepted.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* kv_valid,
                              const void* out, const void* dout, const void* lse, void* delta,
                              void* dq_part, void* dq, void* dk, void* dv, const long long* strides,
                              int B, int H, int Tq, int Tk, int D, int causal,
                              int dropout, unsigned int seed, unsigned int threshold, float mult,
                              int bq, int nj, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (dropout && (bq < 1 || nj != (Tq + bq - 1) / bq)) return (int)cudaErrorInvalidValue;
  const Dropout drop{dropout, seed, threshold, mult, bq, nj};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* part = static_cast<float*>(dq_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, kv_valid, out, dout, l, dl, part, dq, dk, dv, strides, B, H, Tq, Tk, causal,
                      drop, s);
  if (D == 128)
    return launch<128>(q, k, v, kv_valid, out, dout, l, dl, part, dq, dk, dv, strides, B, H, Tq, Tk, causal,
                       drop, s);
  return (int)cudaErrorInvalidValue;
}
