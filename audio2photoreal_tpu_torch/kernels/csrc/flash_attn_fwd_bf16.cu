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

#include <mutex>

#include "attn_common.cuh"

namespace {

using attn::Dropout;
using attn::NEG_BIAS;
using bf16 = __nv_bfloat16;

constexpr int MAX_SPLIT = 4;   // blocks per cluster
constexpr int SPAN = 64;       // bf16 per 128-byte swizzle row: one TMA box column chunk
constexpr int SPAN_BYTES = 128;

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

// ------------------------------------------------------------ helpers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// One arrival that also announces `bytes` of transactions (the TMA copies).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box at (column, row, head, batch) of a [B, H, T, Dh] tensor map
// into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int r, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r), "r"(h), "r"(b)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout
// SWIZZLE_128B.  K-major (Q, K): the stride offset steps 8 rows (1024
// bytes), the leading one is unused.  MN-major (V): the stride offset steps
// 8 keys (1024 bytes), the leading one the next 64-column chunk.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous MMAs (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// wgmma m64nNk16, bf16 operands, f32 accumulator: d[64 x N] is held by the
// warpgroup, REGS = N / 2 floats a thread, element (r, e) of n-tile j at
// d[4j + 2r + e] (row 16 warp + lane/4 + 8r, column 8j + 2(lane%4) + e).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static constexpr int REGS = 32;
  // d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, K-major
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d[64 x 64] += A[64 x 16] (registers) B[16 x 64] (shared memory, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static constexpr int REGS = 64;
  // d[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory, K-major
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // d[64 x 128] += A[64 x 16] (registers) B[16 x 128] (shared memory, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
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

// cuTensorMapEncodeTiled from the driver, found at run time: no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

constexpr int ENCODE_ERROR = 10000;  // + the CUresult of a refused tensor map

// The [B, H, T, D] bf16 view at p (element strides s: batch, head, time; D
// contiguous) as a 4-d tensor map (D, T, H, B) read in boxes of SPAN columns
// x `rows` rows, 128-byte swizzled, zero-filled past the edges.  A stride of
// an axis of extent 1 is never followed; it is given the packed value.
int make_map(CUtensorMap* map, const void* p, const long long* s, int B, int H, int T, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const long long st[3] = {s[2], s[1], s[0]};
  cuuint64_t strides[3];
  cuuint64_t packed = (cuuint64_t)D * sizeof(bf16);
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed : (cuuint64_t)st[i] * sizeof(bf16);
    packed *= dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)SPAN, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + (int)r;
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
