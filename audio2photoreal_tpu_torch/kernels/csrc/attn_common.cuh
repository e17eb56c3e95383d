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
//
// The f32 kernels (flash_attn_fwd.cu, flash_attn_bwd.cu) run their products
// on the tensor cores with mma.sync m16n8k8 TF32.  A TF32 operand keeps 10
// of f32's 23 mantissa bits, so an f32 operand x is split as big =
// tf32_rna(x), small = tf32_rna(x - big), and a product is accumulated in
// f32 as small*big + big*small + big*big, the small terms first (3xTF32,
// CUTLASS's OpMultiplyAddFastF32): about f32's accuracy at a third of the
// TF32 rate.  The bf16 kernels (flash_attn_fwd_bf16.cu,
// flash_attn_bwd_bf16.cu) multiply bf16 operands on the bf16 tensor cores
// and share only the mask, the strided views, the cluster combine, the
// cp.async tile copy and the launch facts.
//
// Fragment layout of m16n8k8 (PTX ISA, per lane: g = lane / 4, t = lane % 4):
// A [16 x 8]: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// B [8 x 8]:  b0 (k t, n g), b1 (k t+4, n g);
// C [16 x 8]: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
// A product whose A operand is a C-layout accumulator (P.V, dS.K, P^T.dO,
// dS^T.Q) takes the eight k of a step in the order 0,2,4,6,1,3,5,7: a0 = c0,
// a1 = c2, a2 = c1, a3 = c3, and its B operand reads rows 2t and 2t+1 to
// match.  The sum over k does not depend on that order, and no shuffle is
// needed.  Shared-memory rows are padded by 16 bytes, so with f32 every
// fragment load (rows g and columns t, or rows 2t / 2t+1 and columns g)
// touches 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace attn {

constexpr float NEG_BIAS = -1e9f;  // masked key: the JAX package's additive -1e9


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

// The key column's part of the hash.
__device__ __forceinline__ uint32_t mask_col_term(int gk) { return (uint32_t)gk * 668265263u; }

// The hash's bits from the sum of its row and column terms.
__device__ __forceinline__ uint32_t mask_bits(uint32_t h) {
  h = (h ^ (h >> 13)) * 2654435761u;
  h = (h ^ (h >> 17)) * 668265263u;
  return h ^ (h >> 16);
}

// The multiplier of element (row term, key column gk): 0 or mult.
__device__ __forceinline__ float mask_mult(const Dropout& d, uint32_t row_term, int gk) {
  return mask_bits(row_term + mask_col_term(gk)) >= d.threshold ? d.mult : 0.f;
}

// e^x as 2^(x log2 e) on the special-function unit: one FMUL and one
// MUFU.EX2 against expf's eight instructions (1-4% of the kernels' time on
// the H100, errors unchanged).  ex2.approx's relative error is about 2^-22;
// the product's rounding adds |x| 2^-24, which grows only where e^x is
// already far below the row's largest term.  -inf gives 0.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// A [B, H, T, Dh] operand as a strided view: element strides of the batch,
// head and time axes; the Dh axis is contiguous and every row starts on 16
// bytes (the wrappers check both).
template <typename T>
struct Mat {
  T* p;
  long long sb, sh, st;
  __device__ __forceinline__ T* head(int b, int h) const { return p + b * sb + h * sh; }
};

template <typename T>
inline Mat<T> make_mat(void* p, const long long* s) {
  return Mat<T>{static_cast<T*>(p), s[0], s[1], s[2]};
}
template <typename T>
inline Mat<const T> make_cmat(const void* p, const long long* s) {
  return Mat<const T>{static_cast<const T*>(p), s[0], s[1], s[2]};
}

// ------------------------------------------------- thread block clusters --

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

// The forward's cluster split for a grid of `tiles` q tiles over `slots`
// resident blocks: the s in {1, 2, 4} (at most the key tiles) that
// minimises the estimated time ceil(tiles*s / slots) / s, in whole waves of
// blocks that each do 1/s of a tile's work; ties go to the smaller s (each
// split adds a combine).  Splits of 3 measured slower than 2 and 4 at every
// generate shape (tools/torch_attn_tune.py).
inline int choose_split(int tiles, int n_kt, int slots, int max_split) {
  int best = 1;
  double best_cost = (double)((tiles + slots - 1) / slots);
  for (int s = 2; s <= max_split && s <= n_kt; s *= 2) {
    const double cost = (double)((tiles * s + slots - 1) / slots) / s;
    if (cost < best_cost - 1e-9) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// The end of a split forward: each block of the cluster has left its
// unnormalised partials for the tile's BQ rows in its own shared memory
// (acc [BQ][LDA], row max m and row sum l [BQ]).  Block `rank` combines rows
// rank*BQ/split .. (rank+1)*BQ/split - 1 from every block's partials,
// through distributed shared memory and in rank order, and writes them
// (rows past Tq are not stored) and their log-sum-exp (when lse_row, the
// head's [Tq] row of it, is not null).  w [BQ][MAX_SPLIT] is this block's
// scratch.
template <int D, int BQ, int LDA, int MAX_SPLIT, int THREADS, typename T>
__device__ __forceinline__ void combine_split(const float* acc, const float* m, const float* l, float* w,
                                              unsigned rank, int split, int q0, int Tq, float* lse_row,
                                              T* oh, long long ost) {
  cluster_sync();  // every block's partials are written and visible
  const int r0 = (int)rank * BQ / split, r1 = ((int)rank + 1) * BQ / split;
  for (int row = r0 + threadIdx.x; row < r1; row += THREADS) {
    float mi[MAX_SPLIT], mmax = -INFINITY, lsum = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_SPLIT; ++i) {
      mi[i] = i < split ? ld_cluster(map_rank(m + row, i)) : -INFINITY;
      mmax = fmaxf(mmax, mi[i]);
    }
#pragma unroll
    for (int i = 0; i < MAX_SPLIT; ++i)
      if (i < split) lsum += ld_cluster(map_rank(l + row, i)) * expf(mi[i] - mmax);
#pragma unroll
    for (int i = 0; i < MAX_SPLIT; ++i) w[row * MAX_SPLIT + i] = expf(mi[i] - mmax) / lsum;
    const int gq = q0 + row;
    if (lse_row != nullptr && gq < Tq) lse_row[gq] = mmax + logf(lsum);
  }
  __syncthreads();
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < (r1 - r0) * C4; idx += THREADS) {
    const int row = r0 + idx / C4, c = (idx % C4) * 4, gq = q0 + row;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < MAX_SPLIT; ++i) {
      if (i >= split) break;
      const float wi = w[row * MAX_SPLIT + i];
      const float4 x = ld_cluster4(map_rank(acc + row * LDA + c, i));
      sum.x += wi * x.x;
      sum.y += wi * x.y;
      sum.z += wi * x.z;
      sum.w += wi * x.w;
    }
    if (gq < Tq) {
      T* p = oh + (long long)gq * ost + c;
      p[0] = from_float<T>(sum.x);
      p[1] = from_float<T>(sum.y);
      p[2] = from_float<T>(sum.z);
      p[3] = from_float<T>(sum.w);
    }
  }
  cluster_sync();  // no block leaves while another still reads its shared memory
}

// ------------------------------------------------------------ cp.async --

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows r0 .. r0+ROWS-1 of one head's [T_, D] rows (row stride
// st elements) into s[ROWS][LDS]; rows at or past T_ are zero-filled.
template <typename T, int D, int LDS, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* s, const T* x, long long st, int r0, int T_) {
  constexpr int CHUNK = 16 / (int)sizeof(T);
  constexpr int PER_ROW = D / CHUNK;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * CHUNK, g = r0 + r;
    const bool ok = g < T_;
    cp_async16(s + r * LDS + c, ok ? x + (long long)g * st + c : x, ok);
  }
}

// ------------------------------------------------- 3xTF32 on mma.sync --

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// TF32 rounding on the bits, as CUTLASS does it: adding half a TF32 ulp
// (bit 12) and dropping the 13 low bits rounds to nearest, ties away from
// zero (cvt.rna.tf32.f32's rule) for every finite x, in two integer
// instructions; cvt.rna compiles to four with its checks for inf and NaN,
// and the splits are most of these kernels' instructions.  The operands
// here are finite (inputs, probabilities, dS).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = tf32_rna(x); lo = x - hi is exact in f32, and the
// tensor cores read a TF32 operand's top 19 bits and drop the 13 low ones,
// so adding half an ulp to lo's bits first makes that drop round lo to
// nearest: lo = tf32_rna(x - hi) without the mask.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// c += a b into a running sum over many k-steps (O over the keys, dQ, dK,
// dV).  The tensor cores add into their f32 accumulator with truncation
// (round toward zero), so a chain of mma over thousands of keys drifts by up
// to ~2e-5 of the sum (an f32 dQ at Tk 2000 missed its 2e-5 bar that way).
// So each k-step's three products go into a zeroed accumulator, which is
// added to c with round-to-nearest FADDs; a chain of mma then spans one
// k-step.
__device__ __forceinline__ void mma_sum(float (&c)[4], const FragA& a, const FragB& b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

__device__ __forceinline__ void split_a(FragA& f, float x0, float x1, float x2, float x3) {
  split(x0, f.hi[0], f.lo[0]);
  split(x1, f.hi[1], f.lo[1]);
  split(x2, f.hi[2], f.lo[2]);
  split(x3, f.hi[3], f.lo[3]);
}

// A = rows r0..r0+15, columns c0..c0+7 of a row-major shared tile.
template <int LDS>
__device__ __forceinline__ void load_a(FragA& f, const float* s, int r0, int c0, int g, int t) {
  const float* p = s + (r0 + g) * LDS + c0 + t;
  split_a(f, p[0], p[8 * LDS], p[4], p[8 * LDS + 4]);
}

// A from a C-layout accumulator (its 8 columns are the step's k, permuted).
__device__ __forceinline__ void a_from_c(FragA& f, const float (&c)[4]) {
  split_a(f, c[0], c[2], c[1], c[3]);
}

// B[k][n] = s[n0 + n][c0 + k]: the tile holds n as rows (K in Q K^T).
template <int LDS>
__device__ __forceinline__ void load_b_nk(FragB& f, const float* s, int n0, int c0, int g, int t) {
  const float* p = s + (n0 + g) * LDS + c0 + t;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
}

// B[k][n] = s[k0 + k][n0 + n] with k permuted as a_from_c permutes it: the
// tile holds k as rows (V in P V).
template <int LDS>
__device__ __forceinline__ void load_b_kn(FragB& f, const float* s, int k0, int n0, int g, int t) {
  const float* p = s + (k0 + 2 * t) * LDS + n0 + g;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[LDS], f.hi[1], f.lo[1]);
}

// ---------------------------------------------------------- launching --

// Per-instantiation launch facts, queried once per device: the opt-in above
// the 48 KB of dynamic shared memory (a property of the kernel on the
// current device), and how many blocks fit on an SM.
struct Prepared {
  cudaError_t err;
  int blocks_per_sm;
  int sms;
};

constexpr int MAX_DEVICES = 64;

// One per instantiation, a function-local static of its launch code.
struct PreparedCache {
  std::once_flag once[MAX_DEVICES];
  Prepared on[MAX_DEVICES];
};

template <typename Kernel>
Prepared prepare(PreparedCache& cache, Kernel kernel, int threads, size_t smem) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return Prepared{err, 0, 0};
  if (dev >= MAX_DEVICES) return Prepared{cudaErrorInvalidDevice, 0, 0};
  std::call_once(cache.once[dev], [&] {
    Prepared& r = cache.on[dev];
    r = Prepared{cudaSuccess, 0, 0};
    r.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (r.err == cudaSuccess)
      r.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.blocks_per_sm, kernel, threads, smem);
    if (r.err == cudaSuccess) r.err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, dev);
  });
  return cache.on[dev];
}

}  // namespace attn
