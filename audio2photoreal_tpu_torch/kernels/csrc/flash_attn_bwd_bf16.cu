// Attention backward in bf16 for Hopper (sm_90a): warp-specialised wgmma
// with TMA, and the forward's dropout mask replayed.
//
// Replaces the Pallas TPU kernel audio2photoreal_tpu/ops/pallas/flash.py
// (_attn_bwd_kernel, reached from _flash_bwd and the custom VJP of
// flash_attention) for bf16 inputs: dQ, dK, dV of softmax(q k^T / sqrt(Dh)
// + bias) o M . v, where M is the forward's dropout multiplier
// (attn_common.cuh), recomputed per element and never stored.  Operands are
// bf16 and every sum is f32; the kernels round to bf16 where the TPU kernel
// does (flash.py:178-201): P o M before dV = (P o M)^T dO, and dS before dQ
// = dS K and dK = dS^T Q.  The gradients are cast once at the end.  The f32
// inputs take flash_attn_bwd.cu.
//
// What bounds it on the card: 10*B*H*Tq*Tk*Dh flops (flash.py:266) against
// one read of q, k, v, dO, O and one write of dq, dk, dv: arithmetic, at the
// bf16 tensor-core rate (989 TFLOP/s on the H100 SXM), which only wgmma
// reaches.  One C call launches three kernels:
//
//   1. rows: D[i] = sum_d dO[i,d] O[i,d] in f32 (the TPU kernel's
//      sum_j P o dP, since O is the dropped output), one warp per row, into
//      three [B*H, Tq_pad] planes beside the row's lse (times log2 e) and
//      the row's part of the dropout hash; Tq_pad rounds Tq up to the q
//      tile, and a padded row gets lse = +inf, so it adds nothing.
//   2. dK, dV: one block per (batch*head, 128 keys), stationary on its keys
//      (FlashAttention-3's backward, Shah et al. 2024), looping over the q
//      tiles.  Each of two consumer warpgroups owns 64 keys (the m64 of
//      wgmma): S^T = K Q^T and dP^T = V dO^T with K and V the A operand and
//      Q and dO the B operand, all K-major in shared memory; P^T = exp(S^T -
//      lse) and dS^T = P^T o (dP^T o M - D) in registers; then dV += (P o
//      M)^T dO and dK += dS^T Q with P o M and dS, rounded to bf16, as the
//      register A operand (an accumulator's layout is the A fragment's) and
//      dO and Q read MN-major.  dK and dV stay in registers for the loop.
//   3. dQ: one block per (batch*head, 128 q rows), stationary on its rows,
//      looping over the key tiles: S = Q K^T and dP = dO V^T, P and dS as
//      above, dQ += dS K in registers (K read MN-major), summed over the key
//      tiles in order and written once.
//
// Why dQ is a second kernel.  The key-stationary kernel holds each key
// block's share of dQ, dS K, for every q tile; summing them across blocks
// needs a per-key-block scratch (the mma.sync kernel before this one wrote
// [key blocks, B, H, Tq, Dh] f32 partials, up to 4.19 GB at the face
// trainer's shapes, and summed them in a third pass), or float atomics,
// whose order changes from run to run (two runs must give bit-identical
// gradients), or FlashAttention-3's deterministic mode: one f32 accumulator
// that the key blocks add into in key-block order, each block waiting on a
// per-(batch*head, q tile) counter for the one before it.  That chain
// serialises every q tile's add across the 5-16 key blocks of a head and
// makes each block's progress wait on another's.  The query-stationary
// kernel recomputes S and dP (4*B*H*Tq*Tk*Dh more flops, 40% on top of the
// bound's 10) but needs no ordering between blocks and no atomics: each dQ
// element is one thread's register, summed over the key tiles in a fixed
// order.  The only scratch is the three row planes, 12*B*H*Tq_pad bytes
// (under 5% of dQ in f32 at Dh 64).
//
// Warp specialisation: a block is three warpgroups.  The first is the
// producer: it gives up registers (setmaxnreg) and one of its threads issues
// every TMA copy, the stationary tiles once and the streamed tiles (with
// their rows' planes) into a ring of shared-memory stages on mbarriers
// ("full" when the bytes have landed, "empty" when every consumer warp is
// done with the stage).  The two consumers take the registers (240 a
// thread) that the accumulators need: at Dh 128 dK and dV are 128 floats a
// thread.  Tiles arrive 128-byte swizzled (hopper.cuh).  Within a consumer
// the products and the elementwise work overlap: S and dP are two commit
// groups, so P is formed while dP is multiplied, and dV is multiplied while
// dS is formed.  A tile's products are drained before the next tile's: one
// left in flight across the loop's back edge made ptxas serialise every
// MMA (its note C7515) and measured slower.  P (and the dropout's keep
// bits) stay in registers between the two elementwise passes, which are
// compiled apart for tiles with and without masked elements (PERF.md:
// 1.3-1.6x at the training shapes).
//
// Ragged edges: TMA zero-fills rows past Tq or Tk.  Keys past Tk (or masked
// by kv_valid) are masked explicitly; q rows past Tq get lse = +inf, never
// the zero fill (a row past Tq would read the next head's lse).  kv_valid
// adds the JAX package's -1e9 and causal replaces the logit with it (j > i +
// Tk - Tq), as the forward does; a row whose keys are all masked, which the
// forward averages uniformly, takes P = 1/Tk (masked_p).  The dropout element (b, h, i, j)
// reads the hash at JAX's coordinates, (seed, (b*H + h)*nj + i / bq, i % bq,
// j), whatever the tiles.  Dropout is a template parameter: at rate 0 the
// kernels hold no hash.
//
// q, k, v, the forward's output and dO are strided [B, H, T, Dh] views (Dh
// contiguous, rows and bases on 16 bytes: TMA's rule); the gradients are
// written through their own strides.
//
// Plain C interface for ctypes; the caller owns every buffer and the stream.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using attn::Dropout;
using attn::Mat;
using bf16 = __nv_bfloat16;

constexpr int AUX_THREADS = 256;  // the rows kernel
constexpr int THREADS = 384;      // the producer warpgroup and two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128*24 + 256*240 <= 65536
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_BIAS2 = attn::NEG_BIAS * LOG2E;  // the masked logit, in the exponent's base 2

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P of a masked element (x the logit in base 2, lse2 its row's): a row whose
// every key is masked has lse2 near NEG_BIAS2, which f32 holds only to 128,
// so exp(x - lse) cannot be formed there; the forward averaged such a row
// uniformly over the Tk keys, and so P is 1/Tk for each key that exists.
__device__ __forceinline__ float masked_p(float x, float lse2, bool exists, float inv_tk) {
  return lse2 < 0.5f * NEG_BIAS2 ? (exists ? inv_tk : 0.f) : ex2(x - lse2);
}

template <int D>
struct Cfg {
  // tile and occupancy (PERF.md, tools/torch_attn_tune.py)
  static constexpr int NC = D / SPAN;  // column chunks of a row
  // dK/dV: KB keys stationary, 64 a consumer warpgroup; QB q rows a streamed tile
  static constexpr int KB = 128;
  static constexpr int QB = 64;
  static constexpr int KV_STAGES = 3;
  static constexpr int KB_BYTES = KB * D * 2;  // the K or the V tile
  static constexpr int QT_BYTES = QB * D * 2;  // a streamed Q or dO tile
  static constexpr int VEC_BYTES = QB * 4;     // its rows of one plane
  static constexpr int KV_SMEM = 2 * KB_BYTES + KV_STAGES * (2 * QT_BYTES + 3 * VEC_BYTES) + 1024;
  // dQ: BQ q rows stationary, 64 a consumer warpgroup; BK keys a streamed tile
  static constexpr int BQ = 128;
  static constexpr int BK = 64;
  static constexpr int Q_STAGES = 3;
  static constexpr int BQ_BYTES = BQ * D * 2;  // the Q or the dO tile
  static constexpr int KT_BYTES = BK * D * 2;  // a streamed K or V tile
  static constexpr int Q_SMEM = 2 * BQ_BYTES + Q_STAGES * 2 * KT_BYTES + 1024;  // the tiles start on 1024 bytes
  static_assert(QB % 16 == 0 && QB <= 256 && BK % 16 == 0 && BK <= 256, "wgmma n and k");
  static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448, "shared memory");
};

// Rows of the three planes: Tq rounded up to the q tile.
template <int D>
int padded_rows(int Tq) {
  return (Tq + Cfg<D>::QB - 1) / Cfg<D>::QB * Cfg<D>::QB;
}

struct KvArgs {
  Mat<bf16> dk, dv;
  const float* kv_valid;  // [B, Tk] or null
  int H, Tq, Tk, causal, Tq_pad, plane;  // plane: B*H*Tq_pad, the floats of one plane
  float scale;
  Dropout drop;
};

struct QArgs {
  Mat<bf16> dq;
  const float* kv_valid;  // [B, Tk] or null
  const float* planes;    // lse * log2 e, D, row terms: [3][B*H][Tq_pad]
  int H, Tq, Tk, causal, Tq_pad, plane;
  float scale;
  Dropout drop;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_a(a[i]);
}

// S (or S^T) of one 64-row warpgroup tile: the Dh axis in k-steps of 16
// within each 64-column chunk; A has `a_rows` rows a chunk, B `b_rows`.
template <int D, typename M, int R>
__device__ __forceinline__ void issue_ss(float (&acc)[R], const bf16* a, int a_rows, const bf16* b, int b_rows) {
#pragma unroll
  for (int c = 0; c < D / SPAN; ++c)
#pragma unroll
    for (int ks = 0; ks < SPAN / 16; ++ks)
      M::ss(acc, desc(a + c * a_rows * SPAN + ks * 16, 16, 1024), desc(b + c * b_rows * SPAN + ks * 16, 16, 1024),
            (c | ks) != 0);
}

// acc += A B over KS k-steps, A from registers, B a [rows][D] tile read MN-major.
template <typename M, int R, int KS>
__device__ __forceinline__ void issue_rs(float (&acc)[R], const uint32_t (&a)[KS][4], const bf16* b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) M::rs(acc, a[kk], desc(b + kk * 16 * SPAN, b_rows * SPAN_BYTES, 1024));
}

// The P pass of one tile: P in place of the logits' accumulator, and the
// dropout's keep bits (element 4j + 2r + e, as the accumulator's).  Compiled
// twice, for a tile that may hold masked elements (MASKED) and one that
// holds none: one body that tests per element measured 1.3-1.6x slower at
// the training shapes (PERF.md).

// dK/dV: acc is S^T, element (r, e) of n-tile j is key key[r] and q row q0 +
// 8j + 2t + e; P o M goes to pa, dV's A fragments.
template <bool MASKED, bool DROP, int R, int KS, int W>
__device__ __forceinline__ void p_pass_kv(float (&acc)[R], uint32_t (&pa)[KS][4], uint32_t (&kept)[W],
                                          const float* sL, const uint32_t* sR, int t, const int (&key)[2],
                                          const float (&key_bias)[2], const uint32_t (&kterm)[2], int q0,
                                          int causal_off, float scale2, float inv_tk, const KvArgs& a) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float2 lse2 = *reinterpret_cast<const float2*>(sL + 8 * j + 2 * t);
    uint2 rt = make_uint2(0u, 0u);
    if (DROP) rt = *reinterpret_cast<const uint2*>(sR + 8 * j + 2 * t);
    float pm[4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float x = acc[i] * scale2, p;
        if (MASKED) {
          x += key_bias[r];
          if (a.causal && key[r] > q0 + 8 * j + 2 * t + e + causal_off) x = NEG_BIAS2;
          p = masked_p(x, e ? lse2.y : lse2.x, key[r] < a.Tk, inv_tk);
        } else {
          p = ex2(x - (e ? lse2.y : lse2.x));
        }
        acc[i] = p;
        pm[2 * r + e] = p;
        if (DROP) {
          const bool keep = attn::mask_bits((e ? rt.y : rt.x) + kterm[r]) >= a.drop.threshold;
          kept[i / 32] |= (uint32_t)keep << (i % 32);
          pm[2 * r + e] = keep ? p * a.drop.mult : 0.f;
        }
      }
    pa[j / 2][2 * (j % 2)] = pack_bf16(pm[0], pm[1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(pm[2], pm[3]);
  }
}

// dQ: acc is S, element (r, e) of n-tile j is q row row[r] and key k0 + 8j + 2t + e.
template <bool MASKED, bool DROP, int R, int W>
__device__ __forceinline__ void p_pass_q(float (&acc)[R], uint32_t (&kept)[W], int t, const int (&row)[2],
                                         const float (&lse2)[2], const uint32_t (&rt)[2], int k0,
                                         const float* valid, int causal_off, float scale2, float inv_tk,
                                         const QArgs& a) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gk = k0 + 8 * j + 2 * t + e;
      float bias = 0.f;
      if (MASKED) bias = gk >= a.Tk ? -INFINITY : (valid != nullptr && !(valid[gk] > 0.f)) ? NEG_BIAS2 : 0.f;
      const uint32_t kterm = DROP ? attn::mask_col_term(gk) : 0u;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float x = acc[i] * scale2;
        if (MASKED) {
          x += bias;
          if (a.causal && gk > row[r] + causal_off) x = NEG_BIAS2;
          acc[i] = masked_p(x, lse2[r], gk < a.Tk, inv_tk);
        } else {
          acc[i] = ex2(x - lse2[r]);
        }
        if (DROP) kept[i / 32] |= (uint32_t)(attn::mask_bits(rt[r] + kterm) >= a.drop.threshold) << (i % 32);
      }
    }
}

template <int D>
__global__ void __launch_bounds__(AUX_THREADS)
attn_bwd_bf16_rows_kernel(Mat<const bf16> out, Mat<const bf16> dout, const float* __restrict__ lse,
                          float* __restrict__ planes, int H, int Tq, int Tq_pad, int rows, Dropout drop) {
  const int row = (int)((blockIdx.x * (size_t)AUX_THREADS + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps: every lane of a warp has the same row
  const int bh = row / Tq_pad, i = row % Tq_pad, b = bh / H, h = bh % H;
  uint32_t* row_term = reinterpret_cast<uint32_t*>(planes + 2 * (size_t)rows);
  if (i >= Tq) {  // padding
    if (lane == 0) {
      planes[row] = INFINITY;
      planes[rows + row] = 0.f;
      row_term[row] = 0u;
    }
    return;
  }
  const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(out.head(b, h) + (long long)i * out.st);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(dout.head(b, h) + (long long)i * dout.st);
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D / 2; c += 32) {
    const float2 x = __bfloat1622float2(o[c]), y = __bfloat1622float2(g[c]);
    acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    planes[row] = lse[(size_t)bh * Tq + i] * LOG2E;
    planes[rows + row] = acc;
    row_term[row] = drop.on ? attn::mask_row_term(drop, bh, i) : 0u;
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_bf16_dkdv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_planes, KvArgs a) {
  using C = Cfg<D>;
  using MS = Wgmma<C::QB>;  // S^T = K Q^T, dP^T = V dO^T: 64 keys x QB q rows a warpgroup
  using MG = Wgmma<D>;      // dV += (P o M)^T dO, dK += dS^T Q: 64 keys x Dh
  constexpr int KB = C::KB, QB = C::QB, NC = C::NC, STAGES = C::KV_STAGES, NT = QB / 8, KS = QB / 16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, full[STAGES], empty[STAGES];
  unsigned char* smem = align_1024(smem_raw);
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [NC][KB][SPAN]
  bf16* sV = sK + KB * D;
  bf16* sRing = sV + KB * D;  // stage s: Q at 2s, dO at 2s + 1, [NC][QB][SPAN] each
  float* sVec = reinterpret_cast<float*>(smem + 2 * C::KB_BYTES + STAGES * 2 * C::QT_BYTES);  // stage s: [3][QB]

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * KB;
  const int n_qt = (a.Tq + QB - 1) / QB;
  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar_kv, 2 * C::KB_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load(sK + c * KB * SPAN, &map_k, &bar_kv, c * SPAN, k0, h, b);
        tma_load(sV + c * KB * SPAN, &map_v, &bar_kv, c * SPAN, k0, h, b);
      }
      for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % STAGES, use = qt / STAGES;
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        bf16* sQ = sRing + 2 * s * QB * D;
        float* vec = sVec + s * 3 * QB;
        mbar_expect_tx(&full[s], 2 * C::QT_BYTES + 3 * C::VEC_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load(sQ + c * QB * SPAN, &map_q, &full[s], c * SPAN, qt * QB, h, b);
          tma_load(sQ + QB * D + c * QB * SPAN, &map_do, &full[s], c * SPAN, qt * QB, h, b);
        }
        const int row = bh * a.Tq_pad + qt * QB;  // a multiple of QB: 16-byte aligned
#pragma unroll
        for (int v = 0; v < 3; ++v) tma_load_1d(vec + v * QB, &map_planes, &full[s], v * a.plane + row);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: keys 64 cw .. 64 cw + 63 of the block
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = 64 * cw + 16 * (threadIdx.x / 32 % 4);  // this warp's first key in the block
  const bf16* sKw = sK + 64 * cw * SPAN;                    // this warpgroup's 64 rows of each chunk
  const bf16* sVw = sV + 64 * cw * SPAN;
  const float* valid = a.kv_valid ? a.kv_valid + (size_t)b * a.Tk : nullptr;
  const int causal_off = a.Tk - a.Tq;
  const float scale2 = a.scale * LOG2E, inv_tk = 1.f / a.Tk;

  // this thread's keys: k0 + wr + g + 8r; -inf (no key), the -1e9 of kv_valid or 0
  int key[2];
  float key_bias[2];
  uint32_t kterm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + wr + g + 8 * r;
    key_bias[r] = key[r] >= a.Tk ? -INFINITY : (valid != nullptr && !(valid[key[r]] > 0.f)) ? NEG_BIAS2 : 0.f;
    kterm[r] = attn::mask_col_term(key[r]);
  }
  // every key of the block exists and none is masked by kv_valid
  const bool keys_plain = valid == nullptr && k0 + KB <= a.Tk;
  float dk[MG::REGS], dv[MG::REGS];
  zero(dk);
  zero(dv);

  mbar_wait(&bar_kv, 0);
  for (int qt = 0; qt < n_qt; ++qt) {
    const int s = qt % STAGES;
    mbar_wait(&full[s], (qt / STAGES) & 1);
    const bf16* sQ = sRing + 2 * s * QB * D;
    const bf16* sdO = sQ + QB * D;
    const float* sL = sVec + s * 3 * QB;
    const float* sD = sL + QB;
    const uint32_t* sR = reinterpret_cast<const uint32_t*>(sL + 2 * QB);

    // S^T = K Q^T and dP^T = V dO^T, two groups (the first k-step's MMA
    // overwrites the accumulators)
    float st[MS::REGS], dpt[MS::REGS];
    wgmma_fence();
    issue_ss<D, MS>(st, sKw, KB, sQ, QB);
    wgmma_commit();
    issue_ss<D, MS>(dpt, sVw, KB, sdO, QB);
    wgmma_commit();
    wgmma_wait<1>();  // S^T
    fence_regs(st);

    // P^T in place of S^T and (P o M)^T as dV's A fragments, while dP^T is multiplied
    const int q0 = qt * QB;
    uint32_t kept[(QB / 2 + 31) / 32] = {};  // the dropout's keep bits
    uint32_t pa[KS][4], da[KS][4];
    if (keys_plain && (!a.causal || k0 + KB - 1 <= q0 + causal_off))
      p_pass_kv<false, DROP>(st, pa, kept, sL, sR, t, key, key_bias, kterm, q0, causal_off, scale2, inv_tk, a);
    else
      p_pass_kv<true, DROP>(st, pa, kept, sL, sR, t, key, key_bias, kterm, q0, causal_off, scale2, inv_tk, a);

    // dV += (P o M)^T dO, multiplied while dS^T is formed
    fence_frags(pa);
    fence_regs(dv);
    wgmma_fence();
    issue_rs<MG>(dv, pa, sdO, QB);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T
    fence_regs(dpt);

    // dS^T = P^T o (dP^T o M - D) as dK's A fragments
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(sD + 8 * j + 2 * t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float dp = dpt[i];
          if (DROP) dp = ((kept[i / 32] >> (i % 32)) & 1u) ? dp * a.drop.mult : 0.f;
          ds[2 * r + e] = st[i] * (dp - (e ? dl.y : dl.x));
        }
      da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
      da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dK += dS^T Q (the scale once, at the end); the tile's products are
    // drained before the next tile's
    fence_frags(da);
    wgmma_fence();
    issue_rs<MG>(dk, da, sQ, QB);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_frags(pa);  // the MMAs read them until here
    fence_frags(da);
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  bf16* dkh = a.dk.head(b, h);
  bf16* dvh = a.dv.head(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.Tk) continue;
    bf16* pk = dkh + (long long)key[r] * a.dk.st + 2 * t;
    bf16* pv = dvh + (long long)key[r] * a.dv.st + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(pk + 8 * n) =
          pack_bf16(dk[4 * n + 2 * r] * a.scale, dk[4 * n + 2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(pv + 8 * n) = pack_bf16(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
    }
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_bf16_dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                        QArgs a) {
  using C = Cfg<D>;
  using MS = Wgmma<C::BK>;  // S = Q K^T, dP = dO V^T: 64 q rows x BK keys a warpgroup
  using MG = Wgmma<D>;      // dQ += dS K: 64 q rows x Dh
  constexpr int BQ = C::BQ, BK = C::BK, NC = C::NC, STAGES = C::Q_STAGES, NT = BK / 8, KS = BK / 16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full[STAGES], empty[STAGES];
  unsigned char* smem = align_1024(smem_raw);
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [NC][BQ][SPAN]
  bf16* sdO = sQ + BQ * D;
  bf16* sRing = sdO + BQ * D;  // stage s: K at 2s, V at 2s + 1, [NC][BK][SPAN] each

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int n_kt = (a.Tk + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar_q, 2 * C::BQ_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load(sQ + c * BQ * SPAN, &map_q, &bar_q, c * SPAN, q0, h, b);
        tma_load(sdO + c * BQ * SPAN, &map_do, &bar_q, c * SPAN, q0, h, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES, use = kt / STAGES;
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        bf16* sKt = sRing + 2 * s * BK * D;
        mbar_expect_tx(&full[s], 2 * C::KT_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load(sKt + c * BK * SPAN, &map_k, &full[s], c * SPAN, kt * BK, h, b);
          tma_load(sKt + BK * D + c * BK * SPAN, &map_v, &full[s], c * SPAN, kt * BK, h, b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: q rows 64 cw .. 64 cw + 63 of the block
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = 64 * cw + 16 * (threadIdx.x / 32 % 4);  // this warp's first q row in the block
  const bf16* sQw = sQ + 64 * cw * SPAN;
  const bf16* sdOw = sdO + 64 * cw * SPAN;
  const float* valid = a.kv_valid ? a.kv_valid + (size_t)b * a.Tk : nullptr;
  const int causal_off = a.Tk - a.Tq;
  const float scale2 = a.scale * LOG2E, inv_tk = 1.f / a.Tk;

  // this thread's q rows: q0 + wr + g + 8r; a row past Tq gets lse = +inf,
  // so every probability of it is 0
  int row[2];
  float lse2[2], dl[2];
  uint32_t rt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + wr + g + 8 * r;
    const bool ok = row[r] < a.Tq;
    const size_t at = (size_t)bh * a.Tq_pad + row[r];
    lse2[r] = ok ? a.planes[at] : INFINITY;
    dl[r] = ok ? a.planes[a.plane + at] : 0.f;
    rt[r] = ok ? reinterpret_cast<const uint32_t*>(a.planes)[2 * (size_t)a.plane + at] : 0u;
  }
  float dq[MG::REGS];
  zero(dq);

  mbar_wait(&bar_q, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const bf16* sKt = sRing + 2 * s * BK * D;
    const bf16* sVt = sKt + BK * D;

    // S = Q K^T and dP = dO V^T, two groups
    float sc[MS::REGS], dp[MS::REGS];
    wgmma_fence();
    issue_ss<D, MS>(sc, sQw, BQ, sKt, BK);
    wgmma_commit();
    issue_ss<D, MS>(dp, sdOw, BQ, sVt, BK);
    wgmma_commit();
    wgmma_wait<1>();  // S
    fence_regs(sc);

    // P in place of S, while dP is multiplied
    const int k0 = kt * BK;
    uint32_t kept[(BK / 2 + 31) / 32] = {};  // the dropout's keep bits
    if (valid == nullptr && k0 + BK <= a.Tk && (!a.causal || k0 + BK - 1 <= q0 + causal_off))
      p_pass_q<false, DROP>(sc, kept, t, row, lse2, rt, k0, valid, causal_off, scale2, inv_tk, a);
    else
      p_pass_q<true, DROP>(sc, kept, t, row, lse2, rt, k0, valid, causal_off, scale2, inv_tk, a);
    wgmma_wait<0>();  // dP
    fence_regs(dp);

    // dS = P o (dP o M - D) as dQ's A fragments
    uint32_t da[KS][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float d = dp[i];
          if (DROP) d = ((kept[i / 32] >> (i % 32)) & 1u) ? d * a.drop.mult : 0.f;
          ds[2 * r + e] = sc[i] * (d - dl[r]);
        }
      da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
      da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K (the scale once, at the end), drained before the next tile
    fence_frags(da);
    wgmma_fence();
    issue_rs<MG>(dq, da, sKt, BK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_frags(da);  // the MMA read them until here
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  bf16* dqh = a.dq.head(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Tq) continue;
    bf16* p = dqh + (long long)row[r] * a.dq.st + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + 8 * n) = pack_bf16(dq[4 * n + 2 * r] * a.scale, dq[4 * n + 2 * r + 1] * a.scale);
  }
}

template <auto KERNEL, int SMEM>
attn::Prepared prepared() {
  static attn::PreparedCache cache;  // one per kernel
  return attn::prepare(cache, KERNEL, THREADS, SMEM);
}

template <int D, bool DROP>
int launch_products(const CUtensorMap (&m)[9], const KvArgs& ka, const QArgs& qa, int B, int H, int Tq, int Tk,
                    cudaStream_t stream) {
  using C = Cfg<D>;
  attn::Prepared p = prepared<attn_bwd_bf16_dkdv_kernel<D, DROP>, C::KV_SMEM>();
  if (p.err == cudaSuccess) p = prepared<attn_bwd_bf16_dq_kernel<D, DROP>, C::Q_SMEM>();
  if (p.err != cudaSuccess) return (int)p.err;
  attn_bwd_bf16_dkdv_kernel<D, DROP><<<dim3((Tk + C::KB - 1) / C::KB, B * H), THREADS, C::KV_SMEM, stream>>>(m[0], m[1], m[2], m[3], m[4], ka);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  attn_bwd_bf16_dq_kernel<D, DROP><<<dim3((Tq + C::BQ - 1) / C::BQ, B * H), THREADS, C::Q_SMEM, stream>>>(
      m[5], m[6], m[7], m[8], qa);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, const void* out, const void* dout,
           const float* lse, float* planes, void* dq, void* dk, void* dv, const long long* strides, int B, int H,
           int Tq, int Tk, int causal, const Dropout& drop, cudaStream_t stream) {
  using C = Cfg<D>;
  const int Tq_pad = padded_rows<D>(Tq), plane = B * H * Tq_pad;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int row_blocks = (int)(((size_t)plane * 32 + AUX_THREADS - 1) / AUX_THREADS);
  attn_bwd_bf16_rows_kernel<D><<<row_blocks, AUX_THREADS, 0, stream>>>(
      attn::make_cmat<bf16>(out, strides + 9), attn::make_cmat<bf16>(dout, strides + 12), lse, planes, H, Tq,
      Tq_pad, plane, drop);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  // the key-stationary kernel's maps (q tiles of QB rows, key blocks of KB,
  // the planes) and the query-stationary kernel's (q blocks of BQ, key tiles of BK)
  CUtensorMap m[9];
  const int made[] = {make_map(&m[0], q, strides, B, H, Tq, D, C::QB),
                      make_map(&m[1], dout, strides + 12, B, H, Tq, D, C::QB),
                      make_map(&m[2], k, strides + 3, B, H, Tk, D, C::KB),
                      make_map(&m[3], v, strides + 6, B, H, Tk, D, C::KB),
                      make_map_1d(&m[4], planes, 3LL * plane, C::QB),
                      make_map(&m[5], q, strides, B, H, Tq, D, C::BQ),
                      make_map(&m[6], dout, strides + 12, B, H, Tq, D, C::BQ),
                      make_map(&m[7], k, strides + 3, B, H, Tk, D, C::BK),
                      make_map(&m[8], v, strides + 6, B, H, Tk, D, C::BK)};
  for (int e : made)
    if (e != 0) return e;
  const float* valid = static_cast<const float*>(kv_valid);
  const KvArgs ka{attn::make_mat<bf16>(dk, strides + 18), attn::make_mat<bf16>(dv, strides + 21), valid, H, Tq, Tk,
                  causal, Tq_pad, plane, scale, drop};
  const QArgs qa{attn::make_mat<bf16>(dq, strides + 15), valid, planes, H, Tq, Tk, causal, Tq_pad, plane, scale,
                 drop};
  return drop.on ? launch_products<D, true>(m, ka, qa, B, H, Tq, Tk, stream)
                 : launch_products<D, false>(m, ka, qa, B, H, Tq, Tk, stream);
}

}  // namespace

// Floats of scratch the backward needs: the three row planes (lse * log2 e,
// D, the dropout row terms) of [B, H, Tq rounded up to the q tile]; -1 for a
// shape it does not take.
extern "C" long long flash_attn_bwd_bf16_scratch_floats(int B, int H, int Tq, int Tk, int D) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1) return -1;
  if (D == 64) return 3LL * B * H * padded_rows<64>(Tq);
  if (D == 128) return 3LL * B * H * padded_rows<128>(Tq);
  return -1;
}

// q/dq/out/dout [B,H,Tq,D], k/v/dk/dv [B,H,Tk,D], bf16, each a strided
// view: strides[3*i .. 3*i+2] are the batch, head and time strides in
// elements of q, k, v, out, dout, dq, dk, dv (i = 0..7), the D axis
// contiguous, every row and the bases of q, k, v and dout on 16 bytes (TMA's
// rule).  kv_valid [B,Tk] float32 or null; lse [B,H,Tq] float32 from the
// forward; delta is not read (D lives in the scratch) and may be null;
// scratch of flash_attn_bwd_bf16_scratch_floats floats on 16 bytes.  The
// dropout arguments are the forward's (attn_common.cuh).  Launches the rows,
// dK/dV and dQ kernels on the stream and returns a cudaError_t (0 when all
// three launches were accepted), or 10000 + the CUresult of a tensor map the
// driver refused.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* kv_valid,
                                   const void* out, const void* dout, const void* lse, void* delta, void* scratch,
                                   void* dq, void* dk, void* dv, const long long* strides, int B, int H, int Tq,
                                   int Tk, int D, int causal, int dropout, unsigned int seed,
                                   unsigned int threshold, float mult, int bq, int nj, void* stream) {
  (void)delta;
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (dropout && (bq < 1 || nj != (Tq + bq - 1) / bq)) return (int)cudaErrorInvalidValue;
  const Dropout drop{dropout, seed, threshold, mult, bq, nj};
  const float* l = static_cast<const float*>(lse);
  float* planes = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, kv_valid, out, dout, l, planes, dq, dk, dv, strides, B, H, Tq, Tk, causal,
                                 drop, s);
  if (D == 128) return launch<128>(q, k, v, kv_valid, out, dout, l, planes, dq, dk, dv, strides, B, H, Tq, Tk,
                                   causal, drop, s);
  return (int)cudaErrorInvalidValue;
}
