// Attention backward in bf16 for Hopper (sm_90a), on the bf16 tensor cores
// with mma.sync m16n8k16 and ldmatrix, with the replayed dropout mask.
//
// Replaces the Pallas TPU kernel audio2photoreal_tpu/ops/pallas/flash.py
// (_attn_bwd_kernel, reached from _flash_bwd and the custom VJP of
// flash_attention) for bf16 inputs: dQ, dK, dV of softmax(q k^T / sqrt(Dh)
// + bias) o M . v, where M is the forward's dropout multiplier
// (attn_common.cuh), recomputed per element and never stored.  Operands are
// bf16 and every sum is f32; the kernel rounds to bf16 where the TPU kernel
// does (flash.py:178-201): P o M before dV = (P o M)^T dO, and dS before dQ
// = dS K and dK = dS^T Q.  dK and dV are cast once at the end, dQ after the
// sum of its partials.  The f32 inputs take flash_attn_bwd.cu.
//
// The structure is flash_attn_bwd.cu's, one pass with no atomics (blocks
// here run in parallel and in no order, where the TPU kernel revisits its
// dK/dV blocks along a sequential grid axis).  One C call launches:
//
//   1. delta: D[i] = sum_d dO[i,d] O[i,d] in f32, one warp per row (the TPU
//      kernel's sum_j P o dP, since O is the dropped output).
//   2. dK/dV and dQ partials: one block per (batch*head, key block), 16
//      keys per warp, looping over the q tiles: S^T = K Q^T and dP^T = V
//      dO^T, then P^T = exp(S^T - lse) with the forward's scale, kv_valid
//      bias and causal rule, dS^T = P^T o (dP^T o M - D); dV += (P o M)^T dO
//      and dK += dS^T Q accumulate in registers (their A operands are the
//      accumulators themselves, rounded to bf16: the m16n8 C fragment is the
//      m16n8k16 A fragment, so no shuffle); dS^T goes to shared memory in
//      bf16, and the block forms its key block's share of dQ, dS K, for the
//      q tile into a [key blocks, B, H, Tq, Dh] f32 scratch.
//   3. dQ: scale times the sum of the key blocks' partials, in key-block
//      order.  Two runs give bit-identical gradients.
//
// What bounds it on the card: 10*B*H*Tq*Tk*Dh flops (flash.py:266) against
// a few reads of q, k, v, dO and the scratch: arithmetic, at the bf16
// tensor-core rate.  The five products are mma.sync m16n8k16 (bf16 in, f32
// accumulate), which reaches the bf16 rate that TF32 halved, with no
// conversions in the inner loops.  Every fragment comes from shared memory
// through ldmatrix: the K and V tiles (A, row-major) and Q and dO (B of S^T
// and dP^T, stored [n][k]) as they are, and the transposed operands with
// ldmatrix.trans: dO and Q as B of dV and dK ([k][n] storage), dS and K in
// the dQ partial (dS^T stored [key][q]).  Rows are padded by 16 bytes, so
// the eight row reads of each 8x8 matrix touch distinct banks.  The streamed
// Q and dO tiles come through a two-stage cp.async ring.  Not wgmma: the
// five products take their operands in four orientations with their
// accumulators on the key rows, which wgmma's 64-row warpgroup tiles and
// shared-memory B operand do not fit without a warp-specialised redesign
// (ROADMAP).
//
// q, k, v, the forward's output and dO are strided [B, H, T, Dh] views (Dh
// contiguous); the gradients are written through their own strides.
//
// Plain C interface for ctypes; the caller owns every buffer and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"

namespace {

using attn::Dropout;
using attn::Mat;
using attn::NEG_BIAS;
using bf16 = __nv_bfloat16;

constexpr int AUX_THREADS = 256;  // the delta and dQ-sum kernels

template <int D>
struct Cfg {
  // tile and occupancy (PERF.md, tools/torch_attn_tune.py)
  static constexpr int WARPS = 8;                      // 16 keys each
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 2;  // resident blocks per SM the registers must allow
  static constexpr int KB = 16 * WARPS;                // keys per block
  static constexpr int QB = D == 128 ? 64 : 32;        // q rows per streamed tile
  static constexpr int LDS = D + 8;                    // row stride, elements: 16 bytes of padding
  static constexpr int LDP = QB + 8;                   // dS^T row stride
  static constexpr size_t RES_BYTES = sizeof(bf16) * 2 * KB * LDS;   // K and V
  static constexpr size_t STAGE_BYTES = sizeof(bf16) * 2 * QB * LDS;  // Q and dO
  static constexpr size_t VEC_BYTES = sizeof(float) * 3 * QB;         // lse, delta, row term
  static constexpr size_t DS_BYTES = sizeof(bf16) * KB * LDP;
  static constexpr size_t SMEM = RES_BYTES + 2 * (STAGE_BYTES + VEC_BYTES) + DS_BYTES;
  // the dQ partial of a q tile: MQ m-tiles x D / 8 n-tiles shared by the warps
  static constexpr int MQ = QB / 16, NDW = (D / 8) * MQ / WARPS;
  static_assert(QB % 16 == 0 && WARPS % MQ == 0 && NDW * WARPS == (D / 8) * MQ && NDW % 2 == 0,
                "dQ partial tiles share out in pairs");
};

struct BwdArgs {
  Mat<const bf16> q, k, v, dout;
  Mat<bf16> dq, dk, dv;
  const float* kv_valid;  // [B, Tk] or null
  const float* lse;       // [B, H, Tq]
  const float* delta;     // [B, H, Tq]
  float* dq_part;         // [ceil(Tk / KB), B*H, Tq, Dh]
  int H, Tq, Tk, causal;
  float scale;
  Dropout drop;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives element (l / 4, 2 (l % 4) .. +1) of each (with .trans:
// element (2 (l % 4) .. +1, l / 4), the transpose).
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b, m16n8k16, bf16 operands, f32 accumulator.  Fragments (g = lane
// / 4, t = lane % 4): A [16 x 16] a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g,
// 2t+8..), a3 (g+8, 2t+8..); B [16 x 8] b0 (k 2t..2t+1, n g), b1 (k 2t+8..,
// n g); C as m16n8k8's (attn_common.cuh).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where lane l points ldmatrix for the fragments of a 16 x 16 block at (r0,
// c0) of a row-major shared tile with row stride ld:
// the A fragment of the block as stored (rows m, columns k);
__device__ __forceinline__ int a_at(int r0, int c0, int ld, int l) {
  return (r0 + (l & 15)) * ld + c0 + (l >> 4) * 8;
}
// the A fragment of its transpose (stored rows k, columns m);
__device__ __forceinline__ int at_at(int r0, int c0, int ld, int l) {
  return (r0 + (l & 7) + ((l >> 4) << 3)) * ld + c0 + ((l >> 3) & 1) * 8;
}
// the B fragments (b0, b1 of n-tiles 0 and 1) of the block stored as [n][k];
__device__ __forceinline__ int b_nk_at(int r0, int c0, int ld, int l) {
  return (r0 + (l & 7) + ((l >> 4) << 3)) * ld + c0 + ((l >> 3) & 1) * 8;
}
// the B fragments of the block stored as [k][n] (with ldsm_t).
__device__ __forceinline__ int b_kn_at(int r0, int c0, int ld, int l) {
  return (r0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + c0 + (l >> 4) * 8;
}

// The A fragment of k-step kk (columns 16kk .. 16kk+15) from m16n8 C
// accumulators c[2kk], c[2kk+1], rounded to bf16.
template <int N>
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int D>
__global__ void __launch_bounds__(AUX_THREADS)
attn_bwd_bf16_delta_kernel(Mat<const bf16> out, Mat<const bf16> dout, float* __restrict__ delta, int H, int Tq,
                           int rows) {
  const int row = (int)((blockIdx.x * (size_t)AUX_THREADS + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps: every lane of a warp has the same row
  const int bh = row / Tq, i = row % Tq, b = bh / H, h = bh % H;
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
  if (lane == 0) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
attn_bwd_bf16_dkdv_kernel(BwdArgs a) {
  using C = Cfg<D>;
  constexpr int THREADS = C::THREADS, KB = C::KB, QB = C::QB, LDS = C::LDS, LDP = C::LDP;
  constexpr int NQ = QB / 8, ND = D / 8, NDW = C::NDW;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [KB][LDS]
  bf16* sV = sK + KB * LDS;                   // [KB][LDS]
  bf16* sRing = sV + KB * LDS;                // stage s: Q at 2s, dO at 2s + 1, [QB][LDS] each
  float* sVec = reinterpret_cast<float*>(smem + C::RES_BYTES + 2 * C::STAGE_BYTES);  // stage s: [3][QB]
  bf16* sdS = reinterpret_cast<bf16*>(smem + C::RES_BYTES + 2 * (C::STAGE_BYTES + C::VEC_BYTES));  // [KB][LDP]

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * KB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp * 16;  // this warp's first key in the block
  const bf16* qh = a.q.head(b, h);
  const bf16* oh = a.dout.head(b, h);
  const float* valid = a.kv_valid ? a.kv_valid + (size_t)b * a.Tk : nullptr;
  const int causal_off = a.Tk - a.Tq;
  const int n_qt = (a.Tq + QB - 1) / QB;

  auto load_q = [&](int qt, int stage) {
    bf16* sQ = sRing + (2 * stage) * QB * LDS;
    attn::load_tile<bf16, D, LDS, QB, THREADS>(sQ, qh, a.q.st, qt * QB, a.Tq);
    attn::load_tile<bf16, D, LDS, QB, THREADS>(sQ + QB * LDS, oh, a.dout.st, qt * QB, a.Tq);
    float* v = sVec + stage * 3 * QB;
    for (int i = threadIdx.x; i < QB; i += THREADS) {
      const int gq = qt * QB + i;
      const bool ok = gq < a.Tq;
      v[i] = ok ? a.lse[(size_t)bh * a.Tq + gq] : 0.f;
      v[QB + i] = ok ? a.delta[(size_t)bh * a.Tq + gq] : 0.f;
      reinterpret_cast<uint32_t*>(v)[2 * QB + i] = (ok && a.drop.on) ? attn::mask_row_term(a.drop, bh, gq) : 0u;
    }
  };
  attn::load_tile<bf16, D, LDS, KB, THREADS>(sK, a.k.head(b, h), a.k.st, k0, a.Tk);
  attn::load_tile<bf16, D, LDS, KB, THREADS>(sV, a.v.head(b, h), a.v.st, k0, a.Tk);
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
    const bf16* sQ = sRing + (2 * stage) * QB * LDS;
    const bf16* sdO = sQ + QB * LDS;
    const float* sL = sVec + stage * 3 * QB;
    const float* sD = sL + QB;
    const uint32_t* sRT = reinterpret_cast<const uint32_t*>(sL + 2 * QB);

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and the QB q rows
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t fk[4], fv[4];
      ldsm(fk, sK + a_at(wr, ks * 16, LDS, lane));
      ldsm(fv, sV + a_at(wr, ks * 16, LDS, lane));
#pragma unroll
      for (int jp = 0; jp < NQ / 2; ++jp) {
        uint32_t fq[4], fo[4];
        ldsm(fq, sQ + b_nk_at(jp * 16, ks * 16, LDS, lane));
        mma(st[2 * jp], fk, fq[0], fq[1]);
        mma(st[2 * jp + 1], fk, fq[2], fq[3]);
        ldsm(fo, sdO + b_nk_at(jp * 16, ks * 16, LDS, lane));
        mma(dpt[2 * jp], fv, fo[0], fo[1]);
        mma(dpt[2 * jp + 1], fv, fo[2], fo[3]);
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
            p = attn::exp_fast(x - lse);
          }
          const float mm = a.drop.on ? attn::mask_mult(a.drop, rt, gk) : 1.f;
          st[j][2 * r + e] = p * mm;                                 // (P o M)^T
          dpt[j][2 * r + e] = p * (dpt[j][2 * r + e] * mm - delta);  // dS^T
        }
      }

    // dV += (P o M)^T dO, dK += dS^T Q (the scale once, at the end)
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
      uint32_t fp[4], fs[4];
      a_from_c(fp, st, kk);
      a_from_c(fs, dpt, kk);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t fo[4], fq[4];
        ldsm_t(fo, sdO + b_kn_at(kk * 16, np * 16, LDS, lane));
        mma(dv[2 * np], fp, fo[0], fo[1]);
        mma(dv[2 * np + 1], fp, fo[2], fo[3]);
        ldsm_t(fq, sQ + b_kn_at(kk * 16, np * 16, LDS, lane));
        mma(dk[2 * np], fs, fq[0], fq[1]);
        mma(dk[2 * np + 1], fs, fq[2], fq[3]);
      }
    }

    // dS^T in bf16: key rows, q columns
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(sdS + (wr + g + 8 * r) * LDP + 8 * j + 2 * t) =
            pack_bf16(dpt[j][2 * r], dpt[j][2 * r + 1]);
    __syncthreads();

    // this key block's dQ partial for the q tile, dS K over the block's KB
    // keys: warp w takes q m-tile w % MQ and n-tiles NDW (w / MQ) .. +NDW
    {
      const int mq = (warp % C::MQ) * 16, n0 = (warp / C::MQ) * NDW;
      float acc[NDW][4];
#pragma unroll
      for (int n = 0; n < NDW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KB / 16; ++ks) {
        uint32_t fs[4];
        ldsm_t(fs, sdS + at_at(ks * 16, mq, LDP, lane));
#pragma unroll
        for (int np = 0; np < NDW / 2; ++np) {
          uint32_t fk[4];
          ldsm_t(fk, sK + b_kn_at(ks * 16, (n0 + 2 * np) * 8, LDS, lane));
          mma(acc[2 * np], fs, fk[0], fk[1]);
          mma(acc[2 * np + 1], fs, fk[2], fk[3]);
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
    __syncthreads();  // this stage and dS^T are read: the next iteration may refill them
  }

  bf16* dkh = a.dk.head(b, h);
  bf16* dvh = a.dv.head(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gk = k0 + wr + g + 8 * r;
    if (!key_ok[r]) continue;
    bf16* pk = dkh + (long long)gk * a.dk.st + 2 * t;
    bf16* pv = dvh + (long long)gk * a.dv.st + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(pk + n * 8) = pack_bf16(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(pv + n * 8) = pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// dQ = scale * the sum of the key blocks' partials, in block order, rounded
// to bf16 once: one thread per 4 elements of a row.
template <int D>
__global__ void __launch_bounds__(AUX_THREADS)
attn_bwd_bf16_dq_kernel(const float* __restrict__ part, Mat<bf16> dq, int H, int Tq, int rows, int n_kb,
                        float scale) {
  constexpr int C4 = D / 4;
  const size_t i = blockIdx.x * (size_t)AUX_THREADS + threadIdx.x;
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
  uint32_t* o = reinterpret_cast<uint32_t*>(dq.head(bh / H, bh % H) + (long long)q * dq.st + c);
  o[0] = pack_bf16(sum.x * scale, sum.y * scale);
  o[1] = pack_bf16(sum.z * scale, sum.w * scale);
}

template <int D>
attn::Prepared prepared() {
  using C = Cfg<D>;
  static attn::PreparedCache cache;
  return attn::prepare(cache, attn_bwd_bf16_dkdv_kernel<D>, C::THREADS, C::SMEM);
}

template <int D>
long long scratch_floats(int B, int H, int Tq, int Tk) {
  return (long long)((Tk + Cfg<D>::KB - 1) / Cfg<D>::KB) * B * H * Tq * D;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, const void* out, const void* dout,
           const float* lse, float* delta, float* dq_part, void* dq, void* dk, void* dv, const long long* strides,
           int B, int H, int Tq, int Tk, int causal, const Dropout& drop, cudaStream_t stream) {
  using C = Cfg<D>;
  const attn::Prepared p = prepared<D>();
  if (p.err != cudaSuccess) return (int)p.err;
  const int rows = B * H * Tq;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int delta_blocks = (int)(((size_t)rows * 32 + AUX_THREADS - 1) / AUX_THREADS);
  attn_bwd_bf16_delta_kernel<D><<<delta_blocks, AUX_THREADS, 0, stream>>>(
      attn::make_cmat<bf16>(out, strides + 9), attn::make_cmat<bf16>(dout, strides + 12), delta, H, Tq, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_kb = (Tk + C::KB - 1) / C::KB;
  const BwdArgs a{attn::make_cmat<bf16>(q, strides),      attn::make_cmat<bf16>(k, strides + 3),
                  attn::make_cmat<bf16>(v, strides + 6),  attn::make_cmat<bf16>(dout, strides + 12),
                  attn::make_mat<bf16>(dq, strides + 15), attn::make_mat<bf16>(dk, strides + 18),
                  attn::make_mat<bf16>(dv, strides + 21), static_cast<const float*>(kv_valid),
                  lse,                                    delta,
                  dq_part,                                H,
                  Tq,                                     Tk,
                  causal,                                 scale,
                  drop};
  attn_bwd_bf16_dkdv_kernel<D><<<dim3(n_kb, B * H), C::THREADS, C::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int dq_blocks = (int)(((size_t)rows * (D / 4) + AUX_THREADS - 1) / AUX_THREADS);
  attn_bwd_bf16_dq_kernel<D><<<dq_blocks, AUX_THREADS, 0, stream>>>(dq_part, a.dq, H, Tq, rows, n_kb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of f32 scratch the backward needs for its dQ partials: one
// [B, H, Tq, D] plane per key block; -1 for a shape it does not take.
extern "C" long long flash_attn_bwd_bf16_scratch_floats(int B, int H, int Tq, int Tk, int D) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1) return -1;
  if (D == 64) return scratch_floats<64>(B, H, Tq, Tk);
  if (D == 128) return scratch_floats<128>(B, H, Tq, Tk);
  return -1;
}

// q/dq/out/dout [B,H,Tq,D], k/v/dk/dv [B,H,Tk,D], bf16, each a strided
// view: strides[3*i .. 3*i+2] are the batch, head and time strides in
// elements of q, k, v, out, dout, dq, dk, dv (i = 0..7), the D axis
// contiguous, every row on 16 bytes.  kv_valid [B,Tk] float32 or null; lse
// [B,H,Tq] float32 from the forward; delta [B,H,Tq] float32 scratch; dq_part
// f32 scratch of flash_attn_bwd_bf16_scratch_floats floats.  The dropout
// arguments are the forward's (attn_common.cuh).  Launches the delta, dK/dV
// and dQ kernels on the stream and returns a cudaError_t: 0 when all three
// launches were accepted.
extern "C" int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* kv_valid,
                                   const void* out, const void* dout, const void* lse, void* delta, void* dq_part,
                                   void* dq, void* dk, void* dv, const long long* strides, int B, int H, int Tq,
                                   int Tk, int D, int causal, int dropout, unsigned int seed,
                                   unsigned int threshold, float mult, int bq, int nj, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (dropout && (bq < 1 || nj != (Tq + bq - 1) / bq)) return (int)cudaErrorInvalidValue;
  const Dropout drop{dropout, seed, threshold, mult, bq, nj};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* part = static_cast<float*>(dq_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, kv_valid, out, dout, l, dl, part, dq, dk, dv, strides, B, H, Tq, Tk, causal, drop,
                      s);
  if (D == 128)
    return launch<128>(q, k, v, kv_valid, out, dout, l, dl, part, dq, dk, dv, strides, B, H, Tq, Tk, causal, drop,
                       s);
  return (int)cudaErrorInvalidValue;
}
