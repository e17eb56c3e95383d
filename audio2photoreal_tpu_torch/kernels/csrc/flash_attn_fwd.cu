// Attention forward for Hopper (sm_90a), FlashAttention-2 style on the
// tensor cores.
//
// Replaces the Pallas TPU kernel audio2photoreal_tpu/ops/pallas/flash.py
// (_attn_kernel, reached from _flash_fwd and flash_attention): softmax(q k^T
// / sqrt(Dh) + key-validity bias [+ causal]) v, with f32 logits and softmax
// statistics, and the division by the row sum done once on the output.
//
// The TPU kernel keeps one head's whole K/V resident in VMEM.  At Tk 2000
// that is 1 MB of f32 for Dh 128, against 227 KB of shared memory per block
// here, so this kernel streams K/V: one block owns one (batch*head, 64-row q
// tile), four warps of 16 rows each, and loops over K/V tiles carrying the
// running row max and row sum in f32 (online softmax) with the [16, Dh]
// accumulator of each warp in registers.  The [Tq, Tk] logits never leave
// the SM.
//
// This is the f32 kernel; bf16 inputs take flash_attn_fwd_bf16.cu.
//
// What bounds it on the card: 4*Tq*Tk*Dh flops per head against a few reads
// of q, k, v: arithmetic.  Both products (S = Q K^T, O += P V) run on the
// tensor cores as mma.sync m16n8k8 TF32, with the f32 inputs split into
// three TF32 products (3xTF32, attn_common.cuh) so the result keeps f32's
// accuracy.  Not wgmma:
// tf32 wgmma reads both shared-memory operands K-major only (no transpose
// for 32-bit types), so V would have to be staged transposed and both
// operands pre-split into big/small tiles, doubling their shared memory;
// mma.sync loads the fragments from shared memory and splits them in
// registers, for any operand orientation.
//
// K/V tiles arrive through a two-stage cp.async ring (16 B per thread): the
// next tile's copy is in flight while this tile's products run.  A block
// owns 64 q rows; K/V tiles are 32 keys, so three blocks fit an SM at
// Dh 64 (52 KB, registers capped at 168) and two at Dh 128 (101 KB).  Each
// choice is the fastest of those tools/torch_attn_tune.py measured on the
// H100: two 16-row m-tiles per warp, 64-key tiles at Dh 128 and a split of
// 3 all lost.
//
// Too few q tiles to fill the card (the generate shapes: 10 q tiles x 16
// batch*heads = 160 blocks on 132 SMs) split the key tiles across the 2 or 4
// blocks of a thread block cluster.  Each block runs the loop over its share
// and leaves its unnormalised (m, l, acc) in its own shared memory; after a
// cluster barrier each block combines a half (a quarter) of the rows from
// every block's partials through distributed shared memory, in rank order,
// and writes them.  One launch, no scratch in HBM, no atomics.
// The split is chosen per call from the grid size and the card's resident
// blocks (flash_attn_fwd_split); the training shapes (B 64: 2560 q tiles)
// take none.
//
// Training adds two things.  Dropout of the probabilities, replayed from the
// JAX package's hash (attn_common.cuh): the row sum l takes the undropped
// probabilities and P.V the dropped ones, as _attn_kernel does (flash.py:
// 146-154), so the output is (softmax o M) v.  And, when the caller passes a
// buffer, the per-row log-sum-exp m + log(l) in f32, which the backward
// (flash_attn_bwd.cu) uses to recompute the probabilities.
//
// q, k and v are strided [B, H, T, Dh] views (any batch, head and time
// strides; Dh contiguous), so the model's head split needs no copies; the
// output is written through its own strides (the wrapper passes [B, T, H,
// Dh] storage).  Ragged Tq/Tk edges are masked in the kernel: rows past Tq
// are computed on zeros and not stored, keys past Tk get -inf (they do not
// exist), masked keys get the JAX package's -1e9 (kv_valid adds it, causal
// replaces the logit with it, as flash.py:_softmax_probs does).  There are
// no padded copies.
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

constexpr int BQ = 64;        // q rows per block
constexpr int WARPS = 4;      // 16 q rows each
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SPLIT = 4;  // blocks per cluster

using T = float;

template <int D>
struct Cfg {
  // tile and occupancy: the best of the variants timed (PERF.md, tools/torch_attn_tune.py)
  static constexpr int BK = 32;                        // keys per K/V tile
  static constexpr int MIN_BLOCKS = D == 128 ? 2 : 3;  // resident blocks per SM the registers must allow
  static constexpr int LDS = D + 16 / (int)sizeof(T);  // shared row stride, elements
  static constexpr int LDA = D + 4;                    // combine buffer row stride, floats
  static constexpr size_t Q_BYTES = sizeof(T) * BQ * LDS;
  static constexpr size_t RING_BYTES = sizeof(T) * 2 * 2 * BK * LDS;  // 2 stages of K and V
  static constexpr size_t SMEM = Q_BYTES + RING_BYTES;
  // the combine (split > 1) reuses all of it: acc [BQ][LDA], m, l [BQ], weights [BQ][MAX_SPLIT]
  static_assert(sizeof(float) * BQ * (LDA + 2 + MAX_SPLIT) <= SMEM, "combine buffers fit");
};

struct FwdArgs {
  Mat<const T> q, k, v;
  Mat<T> o;
  const float* kv_valid;  // [B, Tk] or null
  float* lse;             // [B, H, Tq] or null
  int H, Tq, Tk, causal, split;
  float scale;
  Dropout drop;
};

__device__ __forceinline__ void store2(T* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}

template <int D>
__global__ void __launch_bounds__(THREADS, Cfg<D>::MIN_BLOCKS)
attn_fwd_kernel(FwdArgs a) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, LDS = C::LDS, NT = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sRing = reinterpret_cast<T*>(smem + C::Q_BYTES);  // stage s: K at 2s, V at 2s + 1

  const int split = a.split;
  const unsigned rank = split > 1 ? attn::cluster_rank() : 0u;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = (blockIdx.x / split) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = warp * 16;  // this warp's first row in the tile
  const T* qh = a.q.head(b, h);
  const T* kh = a.k.head(b, h);
  const T* vh = a.v.head(b, h);
  const float* valid = a.kv_valid ? a.kv_valid + (size_t)b * a.Tk : nullptr;
  const int causal_off = a.Tk - a.Tq;
  const int n_kt = (a.Tk + BK - 1) / BK;
  const int kt0 = (int)rank * n_kt / split, kt1 = ((int)rank + 1) * n_kt / split;

  auto load_kv = [&](int kt, int stage) {
    T* sK = sRing + (2 * stage) * BK * LDS;
    attn::load_tile<T, D, LDS, BK, THREADS>(sK, kh, a.k.st, kt * BK, a.Tk);
    attn::load_tile<T, D, LDS, BK, THREADS>(sK + BK * LDS, vh, a.v.st, kt * BK, a.Tk);
  };
  attn::load_tile<T, D, LDS, BQ, THREADS>(sQ, qh, a.q.st, q0, a.Tq);
  if (kt0 < kt1) load_kv(kt0, 0);
  attn::cp_async_commit();

  float o[ND][4], m[2], l[2];
  uint32_t row_term[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    row_term[r] = a.drop.on ? attn::mask_row_term(a.drop, bh, q0 + wr + g + 8 * r) : 0u;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int stage = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_kv(kt + 1, stage ^ 1);
      attn::cp_async_commit();
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    const T* sK = sRing + (2 * stage) * BK * LDS;
    const T* sV = sK + BK * LDS;
    const int k0 = kt * BK;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) {
      FragA fa;
      attn::load_a<LDS>(fa, sQ, wr, ks * 8, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragB fb;
        attn::load_b_nk<LDS>(fb, sK, j * 8, ks * 8, g, t);
        attn::mma(s[j], fa, fb);
      }
    }

    // scale, masks, online softmax; element (r, e) of n-tile j is row
    // wr + g + 8r, key k0 + 8j + 2t + e
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gk = k0 + 8 * j + 2 * t + e;
        const bool exists = gk < a.Tk;
        const float bias = (valid != nullptr && exists && !(valid[gk] > 0.f)) ? NEG_BIAS : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = s[j][2 * r + e] * a.scale + bias;
          if (a.causal && gk > q0 + wr + g + 8 * r + causal_off) x = NEG_BIAS;
          x = exists ? x : -INFINITY;
          s[j][2 * r + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every tile holds a real key
      const float alpha = attn::exp_fast(m[r] - m_new);  // 0 on the first tile
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p = attn::exp_fast(s[j][2 * r + e] - m[r]);
          l[r] += p;  // the row sum takes the undropped probabilities
          s[j][2 * r + e] =
              a.drop.on ? p * attn::mask_mult(a.drop, row_term[r], k0 + 8 * j + 2 * t + e) : p;
        }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      FragA fa;
      attn::a_from_c(fa, s[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        FragB fb;
        attn::load_b_kn<LDS>(fb, sV, kk * 8, n * 8, g, t);
        attn::mma_sum(o[n], fa, fb);
      }
    }
    __syncthreads();  // this stage is read: the next iteration may refill it
  }

  // the row sums over the quad's columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* oh = a.o.head(b, h);
  if (split == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gq = q0 + wr + g + 8 * r;
      if (gq >= a.Tq) continue;
      const float inv = 1.f / l[r];
      if (a.lse != nullptr && t == 0) a.lse[(size_t)bh * a.Tq + gq] = m[r] + logf(l[r]);
      T* orow = oh + (long long)gq * a.o.st;
#pragma unroll
      for (int n = 0; n < ND; ++n) store2(orow + n * 8 + 2 * t, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    return;
  }

  // split > 1: leave this block's partials in its shared memory (the loop
  // ended on a barrier, so the q tile and the ring are free), then combine
  // rows across the cluster
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
      sAcc[row * LDA + n * 8 + 2 * t] = o[n][2 * r];
      sAcc[row * LDA + n * 8 + 2 * t + 1] = o[n][2 * r + 1];
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
  return attn::prepare(cache, attn_fwd_kernel<D>, THREADS, Cfg<D>::SMEM);
}

template <int D>
int auto_split(int B, int H, int Tq, int Tk) {
  const attn::Prepared p = prepared<D>();
  if (p.err != cudaSuccess) return -(int)p.err;
  const int tiles = (Tq + BQ - 1) / BQ * B * H;
  return attn::choose_split(tiles, (Tk + Cfg<D>::BK - 1) / Cfg<D>::BK, p.blocks_per_sm * p.sms,
                            MAX_SPLIT);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, void* out,
           float* lse, const long long* strides, int B, int H, int Tq, int Tk, int causal,
           int split, const Dropout& drop, cudaStream_t stream) {
  using C = Cfg<D>;
  const attn::Prepared p = prepared<D>();
  if (p.err != cudaSuccess) return (int)p.err;
  if (split == 0) split = auto_split<D>(B, H, Tq, Tk);
  const int n_kt = (Tk + C::BK - 1) / C::BK;
  if (split < 1 || split > MAX_SPLIT || split > n_kt) return (int)cudaErrorInvalidValue;
  FwdArgs a{attn::make_cmat<T>(q, strides), attn::make_cmat<T>(k, strides + 3),
               attn::make_cmat<T>(v, strides + 6), attn::make_mat<T>(out, strides + 9),
               static_cast<const float*>(kv_valid), lse, H, Tq, Tk, causal, split,
               (float)(1.0 / sqrt((double)D)), drop};
  const dim3 grid((Tq + BQ - 1) / BQ * split, B * H);
  if (split == 1) {
    attn_fwd_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, attn_fwd_kernel<D>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// The cluster split the forward takes for this shape when called with split
// 0: 1, 2 or 4, or a negated cudaError_t.
extern "C" int flash_attn_fwd_split(int B, int H, int Tq, int Tk, int D) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1) return -(int)cudaErrorInvalidValue;
  if (D == 64) return auto_split<64>(B, H, Tq, Tk);
  if (D == 128) return auto_split<128>(B, H, Tq, Tk);
  return -(int)cudaErrorInvalidValue;
}

// q [B,H,Tq,D], k/v [B,H,Tk,D], out [B,H,Tq,D], float32, each a strided view: strides[3*i .. 3*i+2] are the
// batch, head and time strides in elements of q, k, v, out (i = 0..3), the D
// axis contiguous, every row on 16 bytes.  kv_valid [B,Tk] float32 or null;
// lse [B,H,Tq] float32, or null for no log-sum-exp.  split: blocks of a
// cluster that share one q tile's keys, 1..4, or 0 for the automatic choice.
// dropout != 0 drops the probabilities with the mask of (seed, threshold,
// mult, bq, nj) described in attn_common.cuh.  Returns a cudaError_t: 0 when
// the launch was accepted.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* kv_valid,
                              void* out, void* lse, const long long* strides, int B, int H,
                              int Tq, int Tk, int D, int causal, int split,
                              int dropout, unsigned int seed, unsigned int threshold, float mult,
                              int bq, int nj, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (dropout && (bq < 1 || nj != (Tq + bq - 1) / bq)) return (int)cudaErrorInvalidValue;
  const Dropout drop{dropout, seed, threshold, mult, bq, nj};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, kv_valid, out, l, strides, B, H, Tq, Tk, causal, split, drop, s);
  if (D == 128) return launch<128>(q, k, v, kv_valid, out, l, strides, B, H, Tq, Tk, causal, split, drop, s);
  return (int)cudaErrorInvalidValue;
}
