// Attention forward in bf16 for Hopper (sm_90a): warp-specialised wgmma with
// a TMA producer.
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
//               MN-major.
//
// Beside the products, every score element costs an exponent (MUFU.EX2, 16
// a clock on an SM), a max, a sum and, with dropout, JAX's hash: 12
// instructions, 10 of them on the integer pipe, which retires half as many a
// clock as the FP32 one.  At Dh 64 that elementwise work takes about as long
// as the element's products on the tensor cores, and with dropout longer,
// so it has to run while the tensor cores are busy.  The design
// (FlashAttention-3, Shah et al. 2024):
//
// Warp specialisation.  A block is CW + 1 warpgroups.  The first is the
// producer: it gives up registers (setmaxnreg) and one of its threads issues
// every TMA copy, the q tile once per tile of work and the K and V tiles into
// a ring of STAGES stages, each with a "full" mbarrier (the copy's bytes) and
// an "empty" one (every consumer warp done with it), K and V apart so that S
// can start before V has landed.  The CW consumer warpgroups take 64 q rows
// each (the m64 of wgmma) and the registers (240 a thread) that
// their accumulators need.  Nothing in the key loop waits on the whole block.
//
// Softmax under the tensor cores.  Within a consumer, S_{n+1} = Q K_{n+1}^T
// and O += P_n V_n are issued together, and tile n+1's softmax runs while
// P_n V_n is still being multiplied: P_n stays in registers as bf16 until
// that product has been waited for, and O is rescaled to tile n+1's row max
// while S_{n+2} is multiplied.  Between the consumers (ping-pong), named
// barriers hand the tensor cores from one warpgroup to the other: a
// warpgroup issues its products only after the other has issued its own, so
// one's softmax and dropout hash run while the other's products occupy the
// tensor cores.
//
// The softmax is kept in the exponent's base 2: the logit is scaled by
// scale * log2 e and the row max taken off in one FFMA before ex2.approx; the
// log-sum-exp is written back in natural log (m ln 2 + log l).  The online
// softmax holds the running max and the undropped row sum (the row's values
// sit in the four threads of a quad).  It is compiled three times: for key
// tiles with no mask, for the last tile of an unmasked row (its n-tiles past
// Tk skipped, one test of the keys in the n-tile that straddles Tk), and for
// kv_valid and causal masks.  Ragged edges need no padded copies: TMA
// zero-fills rows past Tq or Tk, rows past Tq are not stored and keys past Tk
// get -inf; kv_valid adds the JAX package's -1e9 and causal replaces the
// logit with it (j > i + Tk - Tq), as flash.py:_softmax_probs does.  Dropout
// replays the JAX package's hash per element (attn_common.cuh), with its
// column term stepped from a base per key tile; a kept probability is
// multiplied by 1/(1 - rate) and a dropped one is 0.
//
// The grid: persistent, one block per SM walks the tiles of work (b, h, q
// tile), the q tiles of one (b, h) next to each other so that its K and V
// stay in L2; the producer loads the next tile's first K tile and q tile while
// the consumers finish and store this one.  A grid of at most half as many
// tiles as SMs (one clip of the generate shapes: 5 q tiles x 4 heads) splits
// each tile's key tiles across the 2 or 4 blocks of a thread block cluster,
// one tile a block, which combine their partial (m, l, acc) through
// distributed shared memory in rank order, as flash_attn_fwd.cu does; a rank
// may hold no key tile.
//
// Of the variants timed (tools/torch_attn_tune.py, PERF.md): the persistent
// grid, the ping-pong, the tail tile's own pass and, without dropout, the row
// max in four chains each paid; 64-key tiles, three consumer warpgroups (192
// q rows) at Dh 64, a third ring stage at Dh 128, a second q tile buffer, a
// loop that runs on across tiles of work (one tile's last P V with the next
// one's first S), partial row sums, the hash's shifts as multiplies and a
// 32- or 40-register producer did not.
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
using bf16 = __nv_bfloat16;

constexpr int MAX_SPLIT = 4;  // blocks per cluster
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_BIAS2 = attn::NEG_BIAS * LOG2E;  // the masked logit, in the exponent's base 2
constexpr int SCHED_BAR = 1;                         // named barriers SCHED_BAR .. SCHED_BAR + CW - 1

template <int D>
struct Cfg {
  // tile, ring and schedule (PERF.md, tools/torch_attn_tune.py)
  static constexpr int CW = 2;                       // consumer warpgroups, 64 q rows (the m64 of wgmma) each
  static constexpr int BK = 128;                     // keys per K/V tile: the n of S = Q K^T
  static constexpr int STAGES = D == 128 ? 2 : 4;    // K/V ring depth
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int BQ = 64 * CW;                 // q rows per tile of work
  static constexpr int THREADS = 128 * (CW + 1);
  static constexpr int NC = D / SPAN;                // column chunks of a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int TILE_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * TILE_BYTES;
  static constexpr int SMEM_ALLOC = SMEM + 1024;     // the swizzled tiles start on 1024 bytes
  static constexpr int LDA = D + 4;                  // combine buffer row stride, floats
  static_assert(sizeof(float) * BQ * (LDA + 2 + MAX_SPLIT) <= SMEM, "combine buffers fit");
  static_assert(BK % 16 == 0 && BK <= 256 && BQ <= 256, "wgmma n, TMA box");
  static_assert(SMEM_ALLOC <= 232448 - 256, "shared memory");
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * CW <= 65536, "registers");
};

struct FwdArgs {
  attn::Mat<bf16> o;
  const float* kv_valid;  // [B, Tk] or null
  float* lse;             // [B, H, Tq] or null
  int H, Tq, Tk, causal, split;
  int n_qt, n_tiles;      // q tiles of a (b, h); tiles of work, B * H * n_qt
  float scale2;           // 1 / sqrt(Dh) * log2 e
  Dropout drop;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The key tiles the softmax is compiled for: every key real and unmasked
// (PLAIN), some keys past Tk and no other mask (TAIL: the last tile of an
// unmasked row; its 8-key n-tiles wholly past Tk are skipped), or kv_valid
// and causal masks as well (MASKED).
enum Keys { PLAIN, TAIL, MASKED };

// The online softmax of one key tile's scores s (element (r, e) of n-tile
// j: row row[r], key k0 + 8j + 2t + e), in place: the new row max m (base
// 2), the factor alpha that rescales what was summed before, the row sum l
// (undropped), and P o M in s.  DROP: rb[r] is the row's hash term plus the
// tile's column base, (k0 + 2t) * C_col.
template <Keys KEYS, bool DROP, int R>
__device__ __forceinline__ void softmax_tile(float (&s)[R], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const uint32_t (&rb)[2], int k0, int t, const int (&row)[2],
                                             const float* valid, int causal_off, const FwdArgs& a) {
  // n-tile j holds no key (uniform across the warp)
  auto past = [&](int j) { return KEYS == TAIL && k0 + 8 * j >= a.Tk; };
  // the row max in PARTS chains: four shorten the softmax's critical path
  // without dropout; with it, where the hash's integer work bounds the
  // softmax, one chain measured 1-3% faster
  constexpr int PARTS = DROP ? 1 : 4;
  float mx[2][PARTS];
#pragma unroll
  for (int i = 0; i < PARTS; ++i) mx[0][i] = mx[1][i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    if (past(j)) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gk = k0 + 8 * j + 2 * t + e;
      const bool exists = gk < a.Tk;
      float bias = 0.f;
      if (KEYS == MASKED) bias = !exists ? -INFINITY : (valid != nullptr && !(valid[gk] > 0.f)) ? NEG_BIAS2 : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[4 * j + 2 * r + e];
        if (KEYS == MASKED) {  // the logit, in base 2
          x = fmaf(x, a.scale2, bias);
          if (a.causal && exists && gk > row[r] + causal_off) x = NEG_BIAS2;
        } else if (KEYS == TAIL && !exists) {  // the raw score
          x = -INFINITY;
        }
        mx[r][j % PARTS] = fmaxf(mx[r][j % PARTS], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = mx[r][0];
#pragma unroll
    for (int i = 1; i < PARTS; ++i) x = fmaxf(x, mx[r][i]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    // the scale is positive, so the max of the raw scores scales to the max of the logits
    const float m_new = fmaxf(m[r], KEYS == MASKED ? x : x * a.scale2);  // finite: a tile holds a real key
    alpha[r] = ex2(m[r] - m_new);                                               // 0 on the first tile
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    if (past(j)) {
#pragma unroll
      for (int i = 4 * j; i < 4 * j + 4; ++i) s[i] = 0.f;
      continue;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        const float p = ex2(KEYS == MASKED ? s[i] - m[r] : fmaf(s[i], a.scale2, -m[r]));
        l[r] += p;  // the row sum takes the undropped probabilities
        s[i] = p;
        if (DROP)  // the column term of key k0 + 8j + 2t + e, stepped from the tile's base
          s[i] = attn::mask_bits(rb[r] + (uint32_t)(8 * j + e) * 668265263u) >= a.drop.threshold ? p * a.drop.mult
                                                                                                 : 0.f;
      }
  }
}

// P o M (in s) as the A fragments of P V: k-step kk covers n-tiles 2kk and 2kk + 1.
template <int R>
__device__ __forceinline__ void to_frags(const float (&s)[R], uint32_t (&pa)[R / 8][4]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(s[4 * j], s[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_a(a[i]);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
attn_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, FwdArgs a) {
  using C = Cfg<D>;
  using MS = Wgmma<C::BK>;  // S = Q K^T
  using MO = Wgmma<D>;      // O += P V
  constexpr int BK = C::BK, BQ = C::BQ, NC = C::NC, STAGES = C::STAGES, CW = C::CW, KS = BK / 16;
  constexpr int CONSUMER_WARPS = 4 * CW, SCHED_THREADS = 256;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, q_empty, k_full[STAGES], k_empty[STAGES], v_full[STAGES],
      v_empty[STAGES];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* sQ = reinterpret_cast<bf16*>(smem);               // [NC][BQ][SPAN]
  bf16* sKV = reinterpret_cast<bf16*>(smem + C::Q_BYTES);  // stage s: K at 2s, V at 2s + 1: [NC][BK][SPAN]
  auto tile_k = [&](int s) { return sKV + (2 * s) * (BK * D); };
  auto tile_v = [&](int s) { return sKV + (2 * s + 1) * (BK * D); };

  // the tiles of work this block takes: with a split, tile blockIdx.x / split
  // and this rank's share of its key tiles; else every gridDim.x-th tile
  const int split = a.split;
  const unsigned rank = split > 1 ? attn::cluster_rank() : 0u;
  const int first = (int)blockIdx.x / split, stride = split > 1 ? a.n_tiles : (int)gridDim.x;
  const int n_kt = (a.Tk + BK - 1) / BK;
  const int kt0 = (int)rank * n_kt / split, n_local = ((int)rank + 1) * n_kt / split - kt0;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMER_WARPS);
      mbar_init(&v_empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // K (and V) tiles issued before this tile of work: the ring position
      int ti = 0;
      for (int tile = first; tile < a.n_tiles && n_local > 0; tile += stride, ++ti) {
        const int bh = tile / a.n_qt, q0 = (tile % a.n_qt) * BQ, b = bh / a.H, h = bh % a.H;
        // K or V tile n of this block's keys into its stage, once the consumers are done with the
        // tile STAGES before it
        auto load = [&](const CUtensorMap* map, uint64_t* full, uint64_t* empty, int v, int n) {
          const int i = it + n, s = i % STAGES;
          if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
          mbar_expect_tx(&full[s], C::TILE_BYTES);
          bf16* dst = v ? tile_v(s) : tile_k(s);
#pragma unroll
          for (int c = 0; c < NC; ++c) tma_load(dst + c * BK * SPAN, map, &full[s], c * SPAN, (kt0 + n) * BK, h, b);
        };
        load(&map_k, k_full, k_empty, 0, 0);  // before the q tile, whose buffer frees later
        if (ti > 0) mbar_wait(&q_empty, (ti - 1) & 1);
        mbar_expect_tx(&q_full, C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) tma_load(sQ + c * BQ * SPAN, &map_q, &q_full, c * SPAN, q0, h, b);
        // in the order the consumers take them: K_n with V_{n-1}
        for (int n = 1; n < n_local; ++n) {
          load(&map_k, k_full, k_empty, 0, n);
          load(&map_v, v_full, v_empty, 1, n - 1);
        }
        load(&map_v, v_full, v_empty, 1, n_local - 1);
        it += n_local;
      }
    }
    if (split > 1) {  // the consumers' barriers around the combine
      __syncthreads();
      attn::combine_split_idle();
    }
    return;
  }

  setmaxnreg_inc<C::CONSUMER_REGS>();
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: q rows 64 cw .. 64 cw + 63 of the tile
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = 64 * cw + 16 * (threadIdx.x / 32 % 4);  // this warp's first row of the tile
  const bf16* sQw = sQ + 64 * cw * SPAN;                  // this warpgroup's 64 rows of each column chunk
  const int causal_off = a.Tk - a.Tq;
  // the tensor cores' turn: wait for it before issuing, then hand it on
  auto sched_sync = [&] { named_sync(SCHED_BAR + cw, SCHED_THREADS); };
  auto sched_arrive = [&] { named_arrive(SCHED_BAR + (cw + 1) % CW, SCHED_THREADS); };
  if (cw == CW - 1) named_arrive(SCHED_BAR, SCHED_THREADS);  // consumer 0 goes first

  int it = 0, ti = 0;
  for (int tile = first; tile < a.n_tiles; tile += stride, ++ti) {
    const int bh = tile / a.n_qt, q0 = (tile % a.n_qt) * BQ, b = bh / a.H, h = bh % a.H;
    const float* valid = a.kv_valid ? a.kv_valid + (size_t)b * a.Tk : nullptr;
    // element (r, e) of n-tile j of an accumulator: row wr + g + 8r, column 8j + 2t + e
    int row[2];
    float m[2], l[2], alpha[2];
    uint32_t row_term[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = q0 + wr + g + 8 * r;
      m[r] = -INFINITY;
      l[r] = 0.f;
      row_term[r] = DROP ? attn::mask_row_term(a.drop, bh, row[r]) : 0u;
    }
    float o[MO::REGS], s[MS::REGS];
    uint32_t pa[KS][4];
#pragma unroll
    for (int i = 0; i < MO::REGS; ++i) o[i] = 0.f;

    // S_n = Q K_n^T into s, issued and committed (the first k-step's MMA
    // overwrites the accumulator)
    auto issue_s = [&](int n) {
      const int i = it + n, st = i % STAGES;
      mbar_wait(&k_full[st], (i / STAGES) & 1);
      const bf16* sK = tile_k(st);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int ks = 0; ks < SPAN / 16; ++ks)
          MS::ss(s, desc(sQw + c * BQ * SPAN + ks * 16, 16, 1024), desc(sK + c * BK * SPAN + ks * 16, 16, 1024),
                 (c | ks) != 0);
      wgmma_commit();
    };
    // O *= alpha, then O += P_{n} V_{n}, issued and committed
    auto issue_pv = [&](int n) {
#pragma unroll
      for (int i = 0; i < MO::REGS; ++i) o[i] *= alpha[(i / 2) % 2];
      const int i = it + n, st = i % STAGES;
      mbar_wait(&v_full[st], (i / STAGES) & 1);
      const bf16* sV = tile_v(st);
      fence_frags(pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) MO::rs(o, pa[kk], desc(sV + kk * 16 * SPAN, BK * SPAN_BYTES, 1024));
      wgmma_commit();
    };
    // S_n has landed: its stage's K (and, after the last, the q tile) is free
    auto release_k = [&](int n) {
      if (lane == 0) {
        mbar_arrive(&k_empty[(it + n) % STAGES]);
        if (n == n_local - 1) mbar_arrive(&q_empty);
      }
    };
    // P_{n} V_{n} has landed
    auto release_v = [&](int n) {
      fence_regs(o);
      fence_frags(pa);  // the MMAs read them until here
      if (lane == 0) mbar_arrive(&v_empty[(it + n) % STAGES]);
    };
    auto softmax = [&](int n) {
      const int k0 = (kt0 + n) * BK;
      uint32_t rb[2] = {0u, 0u};
      if (DROP) {
        const uint32_t col = (uint32_t)(k0 + 2 * t) * 668265263u;
        rb[0] = row_term[0] + col;
        rb[1] = row_term[1] + col;
      }
      // kv_valid or a causal mask in the tile; else the end of the keys in it; else no mask
      if (valid != nullptr || (a.causal && k0 + BK - 1 > q0 + causal_off))
        softmax_tile<MASKED, DROP>(s, m, l, alpha, rb, k0, t, row, valid, causal_off, a);
      else if (k0 + BK > a.Tk)
        softmax_tile<TAIL, DROP>(s, m, l, alpha, rb, k0, t, row, valid, causal_off, a);
      else
        softmax_tile<PLAIN, DROP>(s, m, l, alpha, rb, k0, t, row, valid, causal_off, a);
    };

    if (n_local > 0) {  // (a rank of a split finer than the key tiles has none)
      mbar_wait(&q_full, ti & 1);
      sched_sync();
      issue_s(0);
      sched_arrive();
      wgmma_wait<0>();
      fence_regs(s);
      release_k(0);
      softmax(0);
      to_frags(s, pa);
      for (int n = 1; n < n_local; ++n) {
        sched_sync();
        issue_s(n);
        issue_pv(n - 1);  // its softmax runs under this product
        sched_arrive();
        wgmma_wait<1>();  // S_n
        fence_regs(s);
        release_k(n);
        softmax(n);
        wgmma_wait<0>();  // P_{n-1} V_{n-1}
        release_v(n - 1);
        to_frags(s, pa);
      }
      sched_sync();
      issue_pv(n_local - 1);
      sched_arrive();
      wgmma_wait<0>();
      release_v(n_local - 1);
      it += n_local;
    }

    // the row sums over the quad's columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    bf16* oh = a.o.head(b, h);
    if (split == 1) {  // stored from registers while the producer loads the next tile
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= a.Tq) continue;
        const float inv = 1.f / l[r];
        if (a.lse != nullptr && t == 0) a.lse[(size_t)bh * a.Tq + row[r]] = m[r] * LN2 + logf(l[r]);
        bf16* orow = oh + (long long)row[r] * a.o.st + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
      continue;
    }

    // split > 1 (one tile a block): this block's partials into its shared
    // memory once every consumer is done with the tiles there, then rows
    // combined across the cluster
    __syncthreads();
    constexpr int LDA = C::LDA;
    float* sAcc = reinterpret_cast<float*>(smem);  // [BQ][LDA] unnormalised acc
    float* sM = sAcc + BQ * LDA;                    // [BQ] row max, natural log
    float* sL = sM + BQ;                            // [BQ] row sum
    float* sW = sL + BQ;                            // [BQ][MAX_SPLIT] weights of the partials
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = wr + g + 8 * r;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        sAcc[rr * LDA + n * 8 + 2 * t] = o[4 * n + 2 * r];
        sAcc[rr * LDA + n * 8 + 2 * t + 1] = o[4 * n + 2 * r + 1];
      }
      if (t == 0) {
        sM[rr] = m[r] * LN2;
        sL[rr] = l[r];
      }
    }
    attn::combine_split<D, BQ, LDA, MAX_SPLIT, 128 * CW, bf16, 128>(
        sAcc, sM, sL, sW, rank, split, q0, a.Tq, a.lse ? a.lse + (size_t)bh * a.Tq : nullptr, oh, a.o.st);
  }
}

template <int D, bool DROP>
attn::Prepared prepared() {
  static attn::PreparedCache cache;  // one per kernel
  return attn::prepare(cache, attn_fwd_bf16_kernel<D, DROP>, Cfg<D>::THREADS, Cfg<D>::SMEM_ALLOC);
}

template <int D>
int auto_split(int B, int H, int Tq, int Tk) {
  const attn::Prepared p = prepared<D, false>();
  if (p.err != cudaSuccess) return -(int)p.err;
  constexpr int BQ = Cfg<D>::BQ;
  const int tiles = (Tq + BQ - 1) / BQ * B * H, slots = p.blocks_per_sm * p.sms;
  const int n_kt = (Tk + Cfg<D>::BK - 1) / Cfg<D>::BK;
  // the largest split whose blocks all fit in one wave: a second wave of
  // split blocks, each with its own prologue and combine, cost more than the
  // idle SMs of an unsplit grid at every generate shape timed (80 tiles on
  // 132 SMs: split 1 the fastest of 1-4, PERF.md)
  int split = 1;
  while (2 * split <= MAX_SPLIT && 2 * split <= n_kt && 2 * split * tiles <= slots) split *= 2;
  return split;
}

template <int D, bool DROP>
int launch_kernel(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const FwdArgs& a,
                  cudaStream_t stream) {
  using C = Cfg<D>;
  const attn::Prepared p = prepared<D, DROP>();
  if (p.err != cudaSuccess) return (int)p.err;
  const int slots = p.blocks_per_sm * p.sms;
  const int grid = a.split > 1 ? a.n_tiles * a.split : a.n_tiles < slots ? a.n_tiles : slots;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM_ALLOC;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, attn_fwd_bf16_kernel<D, DROP>, mq, mk, mv, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* kv_valid, void* out, float* lse,
           const long long* strides, int B, int H, int Tq, int Tk, int causal, int split,
           const Dropout& drop, cudaStream_t stream) {
  using C = Cfg<D>;
  if (split == 0) split = auto_split<D>(B, H, Tq, Tk);
  if (split < 0) return -split;
  if (split < 1 || split > MAX_SPLIT) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, strides, B, H, Tq, D, C::BQ);
  if (err == 0) err = make_map(&mk, k, strides + 3, B, H, Tk, D, C::BK);
  if (err == 0) err = make_map(&mv, v, strides + 6, B, H, Tk, D, C::BK);
  if (err != 0) return err;
  const int n_qt = (Tq + C::BQ - 1) / C::BQ;
  const FwdArgs a{attn::make_mat<bf16>(out, strides + 9), static_cast<const float*>(kv_valid), lse, H, Tq, Tk,
                  causal, split, n_qt, n_qt * B * H, (float)(LOG2E / sqrt((double)D)), drop};
  return drop.on ? launch_kernel<D, true>(mq, mk, mv, a, stream) : launch_kernel<D, false>(mq, mk, mv, a, stream);
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
