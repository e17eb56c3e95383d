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
// What bounds it on the card: 4*Tq*Tk*Dh flops per head against a few reads
// of q, k, v: arithmetic.  Both products (S = Q K^T, O += P V) run on the
// tensor cores as mma.sync m16n8k8 TF32, with f32 inputs split into three
// TF32 products (3xTF32, attn_common.cuh) so the result keeps f32's
// accuracy; bf16 inputs are exact in TF32 and take one product.  Not wgmma:
// tf32 wgmma reads both shared-memory operands K-major only (no transpose
// for 32-bit types), so V would have to be staged transposed and both
// operands pre-split into big/small tiles, doubling their shared memory;
// mma.sync loads the fragments from shared memory and splits them in
// registers, for any operand orientation.
//
// K/V tiles arrive through a two-stage cp.async ring (16 B per thread): the
// next tile's copy is in flight while this tile's products run.  A block
// owns 64 q rows; K/V tiles are 32 keys (f32), so three blocks fit an SM at
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"

namespace {

using attn::Dropout;
using attn::FragA;
using attn::FragB;
using attn::from_float;
using attn::Mat;
using attn::NEG_BIAS;

constexpr int BQ = 64;        // q rows per block
constexpr int WARPS = 4;      // 16 q rows each
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SPLIT = 4;  // blocks per cluster

template <typename T, int D>
struct Cfg {
  static constexpr bool X3 = sizeof(T) == 4;  // f32: 3xTF32; bf16: one TF32 product
  // tile and occupancy: the best of the variants timed (PERF.md, tools/torch_attn_tune.py)
  static constexpr int BK = X3 ? 32 : 64;              // keys per K/V tile
  static constexpr int MIN_BLOCKS = D == 128 ? 2 : 3;  // resident blocks per SM the registers must allow
  static constexpr int LDS = D + 16 / (int)sizeof(T);  // shared row stride, elements
  static constexpr int LDA = D + 4;                    // combine buffer row stride, floats
  static constexpr size_t Q_BYTES = sizeof(T) * BQ * LDS;
  static constexpr size_t RING_BYTES = sizeof(T) * 2 * 2 * BK * LDS;  // 2 stages of K and V
  static constexpr size_t SMEM = Q_BYTES + RING_BYTES;
  // the combine (split > 1) reuses all of it: acc [BQ][LDA], m, l [BQ], weights [BQ][MAX_SPLIT]
  static_assert(sizeof(float) * BQ * (LDA + 2 + MAX_SPLIT) <= SMEM, "combine buffers fit");
};

template <typename T>
struct FwdArgs {
  Mat<const T> q, k, v;
  Mat<T> o;
  const float* kv_valid;  // [B, Tk] or null
  float* lse;             // [B, H, Tq] or null
  int H, Tq, Tk, causal, split;
  float scale;
  Dropout drop;
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// The shared-memory address of p in the block of cluster rank `rank`.
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  p[0] = from_float<T>(a);
  p[1] = from_float<T>(b);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, Cfg<T, D>::MIN_BLOCKS)
attn_fwd_kernel(FwdArgs<T> a) {
  using C = Cfg<T, D>;
  constexpr bool X3 = C::X3;
  constexpr int BK = C::BK, LDS = C::LDS, NT = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sRing = reinterpret_cast<T*>(smem + C::Q_BYTES);  // stage s: K at 2s, V at 2s + 1

  const int split = a.split;
  const unsigned rank = split > 1 ? cluster_rank() : 0u;
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
      attn::load_a<X3, LDS>(fa, sQ, wr, ks * 8, g, t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragB fb;
        attn::load_b_nk<X3, LDS>(fb, sK, j * 8, ks * 8, g, t);
        attn::mma<X3>(s[j], fa, fb);
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
      attn::a_from_c<X3>(fa, s[kk]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        FragB fb;
        attn::load_b_kn<X3, LDS>(fb, sV, kk * 8, n * 8, g, t);
        attn::mma_sum<X3>(o[n], fa, fb);
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
  cluster_sync();  // every block's partials are written and visible
  const int r0 = (int)rank * BQ / split, r1 = ((int)rank + 1) * BQ / split;
  for (int row = r0 + threadIdx.x; row < r1; row += THREADS) {
    float mi[MAX_SPLIT], mmax = -INFINITY, lsum = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_SPLIT; ++i) {
      mi[i] = i < split ? ld_cluster(map_rank(sM + row, i)) : -INFINITY;
      mmax = fmaxf(mmax, mi[i]);
    }
#pragma unroll
    for (int i = 0; i < MAX_SPLIT; ++i)
      if (i < split) lsum += ld_cluster(map_rank(sL + row, i)) * expf(mi[i] - mmax);
#pragma unroll
    for (int i = 0; i < MAX_SPLIT; ++i) sW[row * MAX_SPLIT + i] = expf(mi[i] - mmax) / lsum;
    const int gq = q0 + row;
    if (a.lse != nullptr && gq < a.Tq) a.lse[(size_t)bh * a.Tq + gq] = mmax + logf(lsum);
  }
  __syncthreads();
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < (r1 - r0) * C4; idx += THREADS) {
    const int row = r0 + idx / C4, c = (idx % C4) * 4, gq = q0 + row;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < MAX_SPLIT; ++i) {
      if (i >= split) break;
      const float w = sW[row * MAX_SPLIT + i];
      const float4 x = ld_cluster4(map_rank(sAcc + row * LDA + c, i));
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    if (gq < a.Tq) {
      T* p = oh + (long long)gq * a.o.st + c;
      store2(p, acc.x, acc.y);
      store2(p + 2, acc.z, acc.w);
    }
  }
  cluster_sync();  // no block leaves while another still reads its shared memory
}

// The cluster split for this grid: the s in {1, 2, 4} (at most the key
// tiles) that minimises the estimated time ceil(tiles*s / slots) / s, in
// whole waves of blocks that each do 1/s of a tile's work; ties go to the
// smaller s (each split adds a combine).  Splits of 3 measured slower than
// 2 and 4 at every generate shape (tools/torch_attn_tune.py).
inline int choose_split(int tiles, int n_kt, int slots) {
  int best = 1;
  double best_cost = (double)((tiles + slots - 1) / slots);
  for (int s = 2; s <= MAX_SPLIT && s <= n_kt; s *= 2) {
    const double cost = (double)((tiles * s + slots - 1) / slots) / s;
    if (cost < best_cost - 1e-9) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, int D>
attn::Prepared prepared() {
  static attn::PreparedCache cache;
  return attn::prepare(cache, attn_fwd_kernel<T, D>, THREADS, Cfg<T, D>::SMEM);
}

template <typename T, int D>
int auto_split(int B, int H, int Tq, int Tk) {
  const attn::Prepared p = prepared<T, D>();
  if (p.err != cudaSuccess) return -(int)p.err;
  const int tiles = (Tq + BQ - 1) / BQ * B * H;
  return choose_split(tiles, (Tk + Cfg<T, D>::BK - 1) / Cfg<T, D>::BK,
                      p.blocks_per_sm * p.sms);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, void* out,
           float* lse, const long long* strides, int B, int H, int Tq, int Tk, int causal,
           int split, const Dropout& drop, cudaStream_t stream) {
  using C = Cfg<T, D>;
  const attn::Prepared p = prepared<T, D>();
  if (p.err != cudaSuccess) return (int)p.err;
  if (split == 0) split = auto_split<T, D>(B, H, Tq, Tk);
  const int n_kt = (Tk + C::BK - 1) / C::BK;
  if (split < 1 || split > MAX_SPLIT || split > n_kt) return (int)cudaErrorInvalidValue;
  FwdArgs<T> a{attn::make_cmat<T>(q, strides), attn::make_cmat<T>(k, strides + 3),
               attn::make_cmat<T>(v, strides + 6), attn::make_mat<T>(out, strides + 9),
               static_cast<const float*>(kv_valid), lse, H, Tq, Tk, causal, split,
               (float)(1.0 / sqrt((double)D)), drop};
  const dim3 grid((Tq + BQ - 1) / BQ * split, B * H);
  if (split == 1) {
    attn_fwd_kernel<T, D><<<grid, THREADS, C::SMEM, stream>>>(a);
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, attn_fwd_kernel<T, D>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// The cluster split the forward takes for this shape when called with split
// 0: 1, 2 or 4, or a negated cudaError_t.
extern "C" int flash_attn_fwd_split(int B, int H, int Tq, int Tk, int D, int dtype) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1) return -(int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return auto_split<float, 64>(B, H, Tq, Tk);
  if (dtype == 0 && D == 128) return auto_split<float, 128>(B, H, Tq, Tk);
  if (dtype == 1 && D == 64) return auto_split<__nv_bfloat16, 64>(B, H, Tq, Tk);
  if (dtype == 1 && D == 128) return auto_split<__nv_bfloat16, 128>(B, H, Tq, Tk);
  return -(int)cudaErrorInvalidValue;
}

// q [B,H,Tq,D], k/v [B,H,Tk,D], out [B,H,Tq,D], all of one dtype (0 =
// float32, 1 = bfloat16), each a strided view: strides[3*i .. 3*i+2] are the
// batch, head and time strides in elements of q, k, v, out (i = 0..3), the D
// axis contiguous, every row on 16 bytes.  kv_valid [B,Tk] float32 or null;
// lse [B,H,Tq] float32, or null for no log-sum-exp.  split: blocks of a
// cluster that share one q tile's keys, 1..4, or 0 for the automatic choice.
// dropout != 0 drops the probabilities with the mask of (seed, threshold,
// mult, bq, nj) described in attn_common.cuh.  Returns a cudaError_t: 0 when
// the launch was accepted.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* kv_valid,
                              void* out, void* lse, const long long* strides, int B, int H,
                              int Tq, int Tk, int D, int dtype, int causal, int split,
                              int dropout, unsigned int seed, unsigned int threshold, float mult,
                              int bq, int nj, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  if (dropout && (bq < 1 || nj != (Tq + bq - 1) / bq)) return (int)cudaErrorInvalidValue;
  const Dropout drop{dropout, seed, threshold, mult, bq, nj};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, kv_valid, out, l, strides, B, H, Tq, Tk, causal, split,
                             drop, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, kv_valid, out, l, strides, B, H, Tq, Tk, causal, split,
                              drop, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, kv_valid, out, l, strides, B, H, Tq, Tk, causal,
                                     split, drop, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, kv_valid, out, l, strides, B, H, Tq, Tk, causal,
                                      split, drop, s);
  return (int)cudaErrorInvalidValue;
}
