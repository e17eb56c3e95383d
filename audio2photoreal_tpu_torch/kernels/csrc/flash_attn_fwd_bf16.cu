// Attention forward in bf16 for Hopper (sm_90a), on wgmma with TMA.
//
// Replaces the Pallas TPU kernel audio2photoreal_tpu/ops/pallas/flash.py
// (_attn_kernel, reached from _flash_fwd and flash_attention) for bf16
// inputs: softmax(q k^T / sqrt(Dh) + key-validity bias [+ causal]) o M . v,
// with f32 logits, f32 softmax statistics and f32 accumulation, the
// probabilities (after the dropout multiplier M) rounded to bf16 before the
// P.V product as the TPU kernel rounds them (flash.py:149), and the division
// by the row sum done once on the output.  The f32 inputs take
// flash_attn_fwd.cu.
//
// What bounds it on the card: 4*Tq*Tk*Dh flops per head against one read of
// q, k, v and one write of the output: arithmetic, at the bf16 tensor-core
// rate (989 TFLOP/s on the H100 SXM).  Only wgmma reaches that rate, so both
// products are warpgroup MMAs (m64nNk16, bf16 in, f32 accumulate):
//
//   S = Q K^T   A = the Q tile and B = the K tile, both in shared memory,
//               K-major (the Dh axis contiguous);
//   O += P V    A = P, rounded to bf16 in registers straight from S's
//               accumulator (the accumulator's layout is the A fragment's,
//               so no shuffle), B = the V tile in shared memory read
//               MN-major (the transpose bf16 allows and TF32 did not).
//
// One block is two warpgroups (eight warps) that own 128 q rows of one
// (batch, head), 64 each (the m64 of the instructions), and share every
// K/V tile; warp w holds rows 16w..16w+15 of the block's accumulators.  Q and the K/V tiles arrive by TMA
// (cp.async.bulk.tensor, one elected thread issuing every copy) into
// 128-byte-swizzled shared memory: a row of 64 bf16 is one swizzle span, so
// a Dh 128 tile is two column chunks.  The K/V tiles go through a ring of
// STAGES stages on mbarriers: the copy of tile i + STAGES is issued as soon
// as every warp is done with tile i, so it overlaps the next tiles' work.
// The tensor maps are encoded on the host for each call (pointers and
// strides change), through cudaGetDriverEntryPoint so that the library needs
// no -lcuda, and reach the kernel as __grid_constant__ parameters.
//
// Within a warpgroup the products and the softmax take turns; the other
// warpgroups resident on the SM (two blocks of two, 95-124 registers a
// thread) fill each other's gaps.  An FA3-style schedule inside the
// warpgroup (the next tile's S issued before this tile's P V, its softmax
// running under P V) measured slower at every shape timed on the H100
// (tools/torch_attn_tune.py): it holds a second S accumulator and P
// (159-192 registers), so fewer blocks fit.  Two warpgroups a block (half
// the K/V traffic a q row), 64-key tiles at Dh 128 and 128-key tiles at Dh
// 64, and a ring of two stages were the fastest of the variants timed
// (PERF.md).
//
// The online softmax runs on the S accumulator's rows in f32 (the running
// max and the undropped row sum; the row's values sit in the four threads of
// a quad).  Ragged edges need no padded copies: TMA zero-fills rows past Tq
// or Tk, rows past Tq are not stored and keys past Tk get -inf (they do not
// exist); kv_valid adds the JAX package's -1e9 and causal replaces the logit
// with it (j > i + Tk - Tq), as flash.py:_softmax_probs does.  Dropout
// replays the JAX package's hash per element (attn_common.cuh); the row sum
// takes the undropped probabilities.  When the caller passes a buffer the
// kernel writes the per-row log-sum-exp m + log(l) in f32 for the backward.
//
// Too few q tiles to fill the card (the generate shapes: 5 q tiles x 16
// (batch, head) = 80 blocks on 132 SMs) split the key tiles across the 2 or
// 4 blocks of a thread block cluster, which combine their partial (m, l,
// acc) through distributed shared memory in rank order, as
// flash_attn_fwd.cu does.
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
using attn::NEG_BIAS;
using bf16 = __nv_bfloat16;

constexpr int MAX_SPLIT = 4;  // blocks per cluster

template <int D>
struct Cfg {
  // tile and occupancy (PERF.md, tools/torch_attn_tune.py)
  static constexpr int WGS = 2;                   // warpgroups per block, 64 q rows (the m64 of wgmma) each
  static constexpr int BQ = 64 * WGS;             // q rows per block
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BK = D == 128 ? 64 : 128;  // keys per K/V tile: the n of S = Q K^T
  static constexpr int STAGES = 2;                // K/V ring depth
  static constexpr int MIN_BLOCKS = 2;            // resident blocks per SM the registers must allow
  static constexpr int NC = D / SPAN;             // column chunks of a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int TILE_BYTES = BK * D * 2;   // one K or V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * TILE_BYTES;
  static constexpr int SMEM_ALLOC = SMEM + 1024;  // the swizzled tiles start on 1024 bytes
  static constexpr int LDA = D + 4;               // combine buffer row stride, floats
  static_assert(sizeof(float) * BQ * (LDA + 2 + MAX_SPLIT) <= SMEM, "combine buffers fit");
  static_assert(BK % 16 == 0 && BK <= 256, "wgmma n");
};

struct FwdArgs {
  attn::Mat<bf16> o;
  const float* kv_valid;  // [B, Tk] or null
  float* lse;             // [B, H, Tq] or null
  int H, Tq, Tk, causal, split;
  float scale;
  Dropout drop;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, Cfg<D>::MIN_BLOCKS)
attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, FwdArgs a) {
  using C = Cfg<D>;
  using MS = Wgmma<C::BK>;  // S = Q K^T
  using MO = Wgmma<D>;      // O += P V
  constexpr int BK = C::BK, BQ = C::BQ, THREADS = C::THREADS, NC = C::NC, NT = BK / 8, ND = D / 8,
                KS = BK / 16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_kv[C::STAGES];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sQ = reinterpret_cast<bf16*>(smem);               // [NC][BQ][SPAN]
  bf16* sKV = reinterpret_cast<bf16*>(smem + C::Q_BYTES);  // stage s: K at 2s, V at 2s + 1: [NC][BK][SPAN]

  const int split = a.split;
  const unsigned rank = split > 1 ? attn::cluster_rank() : 0u;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = (blockIdx.x / split) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp * 16;  // this warp's first row of the tile (warpgroup wr / 64 holds rows 64 (wr / 64) ..)
  const bf16* sQw = sQ + (wr / 64) * 64 * SPAN;  // this warpgroup's 64 rows of each column chunk
  const int n_kt = (a.Tk + BK - 1) / BK;
  const int kt0 = (int)rank * n_kt / split, n_local = ((int)rank + 1) * n_kt / split - kt0;
  const float* valid = a.kv_valid ? a.kv_valid + (size_t)b * a.Tk : nullptr;
  const int causal_off = a.Tk - a.Tq;

  auto tile_k = [&](int s) { return sKV + (2 * s) * (BK * D); };
  auto tile_v = [&](int s) { return sKV + (2 * s + 1) * (BK * D); };
  auto issue_kv = [&](int kt, int s) {  // one thread: K and V of key tile kt into stage s
    mbar_expect_tx(&bar_kv[s], 2 * C::TILE_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load(tile_k(s) + c * BK * SPAN, &map_k, &bar_kv[s], c * SPAN, kt * BK, h, b);
      tma_load(tile_v(s) + c * BK * SPAN, &map_v, &bar_kv[s], c * SPAN, kt * BK, h, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&bar_kv[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar_q, C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_load(sQ + c * BQ * SPAN, &map_q, &bar_q, c * SPAN, q0, h, b);
    for (int s = 0; s < C::STAGES && s < n_local; ++s) issue_kv(kt0 + s, s);
  }

  // element (r, e) of n-tile j of an accumulator: row wr + g + 8r, column 8j + 2t + e
  float o[MO::REGS], m[2], l[2];
  uint32_t row_term[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    row_term[r] = a.drop.on ? attn::mask_row_term(a.drop, bh, q0 + wr + g + 8 * r) : 0u;
  }
#pragma unroll
  for (int i = 0; i < MO::REGS; ++i) o[i] = 0.f;

  // S = Q K^T of local tile i into s (the Dh axis in k-steps of 16 within
  // each 64-column chunk), issued and committed, not waited for
  auto issue_s = [&](float (&s)[MS::REGS], int i) {
    const int st = i % C::STAGES;
    mbar_wait(&bar_kv[st], (i / C::STAGES) & 1);
    const bf16* sK = tile_k(st);
#pragma unroll
    for (int j = 0; j < MS::REGS; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int ks = 0; ks < SPAN / 16; ++ks)
        MS::ss(s, desc(sQw + c * BQ * SPAN + ks * 16, 16, 1024), desc(sK + c * BK * SPAN + ks * 16, 16, 1024),
               (c | ks) != 0);
    wgmma_commit();
  };

  // The online softmax of local tile i's scores s: scale and masks, the new
  // row max m and the factor alpha that rescales what was summed before,
  // the row sum l (undropped), and P o M rounded to bf16 as the A fragments
  // of P V (k-step kk covers n-tiles 2kk and 2kk + 1 of s).
  auto softmax = [&](float (&s)[MS::REGS], int i, uint32_t (&pa)[KS][4], float (&alpha)[2]) {
    const int k0 = (kt0 + i) * BK;
    // a full tile with no mask needs no per-element test
    const bool plain = valid == nullptr && k0 + BK <= a.Tk && (!a.causal || k0 + BK - 1 <= q0 + causal_off);
    float mx[2] = {-INFINITY, -INFINITY};
    if (plain) {
#pragma unroll
      for (int j = 0; j < MS::REGS; ++j) {
        s[j] *= a.scale;
        mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], s[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gk = k0 + 8 * j + 2 * t + e;
          const bool exists = gk < a.Tk;
          const float bias = (valid != nullptr && exists && !(valid[gk] > 0.f)) ? NEG_BIAS : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = s[4 * j + 2 * r + e] * a.scale + bias;
            if (a.causal && gk > q0 + wr + g + 8 * r + causal_off) x = NEG_BIAS;
            x = exists ? x : -INFINITY;
            s[4 * j + 2 * r + e] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile holds a real key
      alpha[r] = attn::exp_fast(m[r] - m_new);  // 0 on the first tile
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = attn::exp_fast(s[4 * j + 2 * r + e] - m[r]);
          l[r] += x;  // the row sum takes the undropped probabilities
          p[2 * r + e] = a.drop.on ? x * attn::mask_mult(a.drop, row_term[r], k0 + 8 * j + 2 * t + e) : x;
        }
      pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
    }
  };

  mbar_wait(&bar_q, 0);
  float s[MS::REGS], alpha[2];
  uint32_t pa[KS][4];
  issue_s(s, 0);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(s, 0, pa, alpha);
  for (int i = 0; i < n_local; ++i) {
    // O += P_i V_i
    const bf16* sV = tile_v(i % C::STAGES);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) fence_a(pa[kk]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) MO::rs(o, pa[kk], desc(sV + kk * 16 * SPAN, BK * SPAN_BYTES, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) fence_a(pa[kk]);  // the MMAs read pa until here
    if (i + 1 < n_local) {  // S_{i+1}, its softmax, and O rescaled to the new row max
      issue_s(s, i + 1);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, i + 1, pa, alpha);
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[4 * n + 2 * r] *= alpha[r];
          o[4 * n + 2 * r + 1] *= alpha[r];
        }
    }
    __syncthreads();  // every warp is done with tile i's stage
    if (threadIdx.x == 0 && i + C::STAGES < n_local) issue_kv(kt0 + i + C::STAGES, i % C::STAGES);
  }

  // the row sums over the quad's columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* oh = a.o.head(b, h);
  if (split == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gq = q0 + wr + g + 8 * r;
      if (gq >= a.Tq) continue;
      const float inv = 1.f / l[r];
      if (a.lse != nullptr && t == 0) a.lse[(size_t)bh * a.Tq + gq] = m[r] + logf(l[r]);
      bf16* orow = oh + (long long)gq * a.o.st + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
    return;
  }

  // split > 1: this block's partials into its shared memory (every copy has
  // landed and the loop ended on a barrier), then rows combined across the
  // cluster
  constexpr int LDA = C::LDA;
  float* sAcc = reinterpret_cast<float*>(smem);  // [BQ][LDA] unnormalised acc
  float* sM = sAcc + BQ * LDA;                    // [BQ] row max
  float* sL = sM + BQ;                            // [BQ] row sum
  float* sW = sL + BQ;                            // [BQ][MAX_SPLIT] weights of the partials
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      sAcc[row * LDA + n * 8 + 2 * t] = o[4 * n + 2 * r];
      sAcc[row * LDA + n * 8 + 2 * t + 1] = o[4 * n + 2 * r + 1];
    }
    if (t == 0) {
      sM[row] = m[r];
      sL[row] = l[r];
    }
  }
  attn::combine_split<D, BQ, LDA, MAX_SPLIT, THREADS>(sAcc, sM, sL, sW, rank, split, q0, a.Tq,
                                                       a.lse ? a.lse + (size_t)bh * a.Tq : nullptr,
                                                       oh, a.o.st);
}

template <int D>
attn::Prepared prepared() {
  static attn::PreparedCache cache;
  return attn::prepare(cache, attn_fwd_bf16_kernel<D>, Cfg<D>::THREADS, Cfg<D>::SMEM_ALLOC);
}

template <int D>
int auto_split(int B, int H, int Tq, int Tk) {
  const attn::Prepared p = prepared<D>();
  if (p.err != cudaSuccess) return -(int)p.err;
  constexpr int BQ = Cfg<D>::BQ;
  const int tiles = (Tq + BQ - 1) / BQ * B * H, slots = p.blocks_per_sm * p.sms;
  // only a grid that leaves resident slots empty splits: at the training
  // shapes (tens of waves) the combine costs more than the last wave's
  // rounding saves
  if (tiles >= slots) return 1;
  return attn::choose_split(tiles, (Tk + Cfg<D>::BK - 1) / Cfg<D>::BK, slots, MAX_SPLIT);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, void* out, float* lse,
           const long long* strides, int B, int H, int Tq, int Tk, int causal, int split,
           const Dropout& drop, cudaStream_t stream) {
  using C = Cfg<D>;
  const attn::Prepared p = prepared<D>();
  if (p.err != cudaSuccess) return (int)p.err;
  if (split == 0) split = auto_split<D>(B, H, Tq, Tk);
  const int n_kt = (Tk + C::BK - 1) / C::BK;
  if (split < 1 || split > MAX_SPLIT || split > n_kt) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, strides, B, H, Tq, D, C::BQ);
  if (err == 0) err = make_map(&mk, k, strides + 3, B, H, Tk, D, C::BK);
  if (err == 0) err = make_map(&mv, v, strides + 6, B, H, Tk, D, C::BK);
  if (err != 0) return err;
  const FwdArgs a{attn::make_mat<bf16>(out, strides + 9), static_cast<const float*>(kv_valid), lse, H, Tq, Tk,
                  causal, split, (float)(1.0 / sqrt((double)D)), drop};
  const dim3 grid((Tq + C::BQ - 1) / C::BQ * split, B * H);
  if (split == 1) {
    attn_fwd_bf16_kernel<D><<<grid, C::THREADS, C::SMEM_ALLOC, stream>>>(mq, mk, mv, a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM_ALLOC;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, attn_fwd_bf16_kernel<D>, mq, mk, mv, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// The cluster split the forward takes for this shape when called with split
// 0: 1, 2 or 4, or a negated cudaError_t.
extern "C" int flash_attn_fwd_bf16_split(int B, int H, int Tq, int Tk, int D) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1) return -(int)cudaErrorInvalidValue;
  if (D == 64) return auto_split<64>(B, H, Tq, Tk);
  if (D == 128) return auto_split<128>(B, H, Tq, Tk);
  return -(int)cudaErrorInvalidValue;
}

// q [B,H,Tq,D], k/v [B,H,Tk,D], out [B,H,Tq,D], bf16, each a strided view:
// strides[3*i .. 3*i+2] are the batch, head and time strides in elements of
// q, k, v, out (i = 0..3), the D axis contiguous, every row and the base on
// 16 bytes (TMA's rule).  kv_valid [B,Tk] float32 or null; lse [B,H,Tq]
// float32, or null for no log-sum-exp.  split: blocks of a cluster that
// share one q tile's keys, 1..4, or 0 for the automatic choice.  dropout !=
// 0 drops the probabilities with the mask of (seed, threshold, mult, bq, nj)
// described in attn_common.cuh.  Returns a cudaError_t (0 when the launch
// was accepted), or 10000 + the CUresult of a tensor map the driver refused.
extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, const void* kv_valid,
                                   void* out, void* lse, const long long* strides, int B, int H, int Tq,
                                   int Tk, int D, int causal, int split, int dropout, unsigned int seed,
                                   unsigned int threshold, float mult, int bq, int nj, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (dropout && (bq < 1 || nj != (Tq + bq - 1) / bq)) return (int)cudaErrorInvalidValue;
  const Dropout drop{dropout, seed, threshold, mult, bq, nj};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, kv_valid, out, l, strides, B, H, Tq, Tk, causal, split, drop, s);
  if (D == 128) return launch<128>(q, k, v, kv_valid, out, l, strides, B, H, Tq, Tk, causal, split, drop, s);
  return (int)cudaErrorInvalidValue;
}
